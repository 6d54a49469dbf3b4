"""What the CPU tests of the port's register-tiled fp32 kernels share
(``csrc/tile_f32.cuh``: K1 ``fused_mlp.cu``, K2 ``fused_loglik_gram.cu``,
K3 ``fused_loglik_grad_gram_f32.cu``, the forward of
``fused_gram_mixed.cu`` and the backward of ``fused_gram_mma.cu`` at a
reverse pair): packed fp32 weight slabs read back by the kernels'
layout, and the kernels' arithmetic in plain torch, through the packed
stream, slab by slab, k ascending."""

import torch
from _torch_mma import mma_product

from tpu21cmvae_torch.ops.fold import _log_clamp, _log_clamp_grad
from tpu21cmvae_torch.ops.kernels._common import SLAB_N, padk
from tpu21cmvae_torch.ops.mlp import skinny_dense


def chunks(n: int) -> int:
    return -(-n // SLAB_N)


def unpack_slabs(slabs, shapes):
    """Each (K, N) layer of ``shapes`` as the zero-padded (padk(K),
    128·chunks) weights and (128·chunks,) bias the stream ``slabs``
    holds: chunk c, row k, column q at float offset (c·padk(K) + k)·128
    + q after the earlier layers, so any slab depth that divides padk(K)
    finds its slabs contiguous."""
    out, at, bias_at = [], 0, 0
    for k, n in shapes:
        kp, cols = padk(k), chunks(n) * SLAB_N
        blocks = slabs.w[at: at + kp * cols].reshape(chunks(n), kp, SLAB_N)
        out.append((blocks.transpose(0, 1).reshape(kp, cols),
                    slabs.b[bias_at: bias_at + cols]))
        at += kp * cols
        bias_at += cols
    assert at == slabs.w.numel() and bias_at == slabs.b.numel()
    return out


def slab_layer(a, slabs, at, k, n):
    """``a @ W`` for the layer whose slabs start at float offset ``at``
    of the stream, as ``tile_layer`` sums it: for every chunk one fp32
    sum per (row, column), through the chunk's k rows in stream order (its
    slabs in order, k ascending inside each); ``a`` is read as zero past
    its width. Returns the (B, 128·chunks) sums and the next layer's
    offset."""
    kp = padk(k)
    a = torch.nn.functional.pad(a, (0, kp - a.shape[1]))
    blocks = slabs.w[at: at + chunks(n) * kp * SLAB_N].reshape(chunks(n), kp, SLAB_N)
    acc = a.new_zeros((a.shape[0], chunks(n), SLAB_N))
    for kk in range(kp):
        acc = acc + a[:, kk, None, None] * blocks[None, :, kk]
    return acc.reshape(a.shape[0], -1), at + blocks.numel()


def _stream(h, slabs, shapes):
    """The streamed layers' (sums + padded bias) one after another,
    ReLU between them, each hidden output cut to padk of its width (the
    next tile's k rows); returns the last layer's padded output."""
    at = bias_at = 0
    for i, (k, n) in enumerate(shapes):
        acc, at = slab_layer(h, slabs, at, k, n)
        y = acc + slabs.b[bias_at: bias_at + acc.shape[1]]
        bias_at += acc.shape[1]
        h = torch.relu(y)[:, : padk(n)] if i < len(shapes) - 1 else y
    return h


def emulate_f32_mlp(ops, x):
    """``fused_mlp.cu``: the skinny layer exact, then every other layer
    through the stream; (B, n_out), or (B,) under ``sumsq``."""
    h = _log_clamp(x) if ops.log_clamp else x
    widths = ops.widths
    first = 0
    if ops.skinny:
        h = skinny_dense(h, ops.w[0], ops.b[0])
        first = 1
        if len(widths) > 2:
            h = torch.relu(h)
    if first < len(widths) - 1:
        h = _stream(h, ops.slabs, list(zip(widths[first:-1], widths[first + 1:])))
    y = h[:, : widths[-1]]
    return torch.sum(y * y, dim=-1) if ops.reduce == "sumsq" else y


def _gram_forward(ops, x):
    """``csrc/gram_f32.cuh``'s forward through ``ops.slabs`` (K2's stream,
    or the head of K3's): the skinny layer exact, trunk layers 1 … n−1
    and the gram head through the stream. Returns ``h``, ``h@G``, ``u``
    (read from G's bias slot), each activation's mask as the kernel takes
    it (fp32 pre-activation > 0, false for NaN), and the stream offset
    after ``G``."""
    widths = ops.widths
    y = skinny_dense(_log_clamp(x), ops.w0, ops.b0)
    masks, h = [y > 0.0], torch.relu(y)
    at = bias_at = 0
    for k, n in zip(widths[1:-1], widths[2:]):
        acc, at = slab_layer(h, ops.slabs, at, k, n)
        y = (acc + ops.slabs.b[bias_at: bias_at + acc.shape[1]])[:, :n]
        bias_at += acc.shape[1]
        masks.append(y > 0.0)
        h = torch.relu(y)
    hidden = widths[-1]
    hg, at = slab_layer(h, ops.slabs, at, hidden, hidden)
    return h, hg[:, :hidden], ops.slabs.b[bias_at: bias_at + hidden], masks, at


def _gram_value(ops, h, hg, u):
    return -0.5 * (torch.sum((hg + 2.0 * u) * h, dim=-1) + ops.c) + ops.log_norm


def emulate_f32_gram(ops, x):
    """``fused_loglik_gram.cu``: logL from the skinny layer, the streamed
    trunk layers 1 … n−1 and the gram head, whose bias slot holds u:
    quad = Σ_j (h@G + 2u)_j · h_j."""
    h, hg, u, _, _ = _gram_forward(ops, x)
    return _gram_value(ops, h, hg, u)


def emulate_f32_grad_gram(ops, x):
    """``fused_loglik_grad_gram_f32.cu``: K2's forward, then the backward
    through the rest of the stream: the signal e = h > 0 ? h@G + u : 0,
    then e ← mask_{i−1} ? e @ W_iᵀ : 0 for i = n−1 … 1 from W_iᵀ's slabs,
    the skinny layer's backward j ascending in exact fp32, times the
    log-clamp's derivative. ``(logL, dlogL/dx)``."""
    widths = ops.widths
    h, hg, u, masks, at = _gram_forward(ops, x)
    e = torch.where(h > 0.0, hg + u, 0.0)
    for i in range(len(widths) - 2, 0, -1):
        acc, at = slab_layer(e, ops.slabs, at, widths[i + 1], widths[i])
        e = torch.where(masks[i - 1], acc[:, : widths[i]], 0.0)
    assert at == ops.slabs.w.numel()
    return _gram_value(ops, h, hg, u), _skinny_backward(ops, x, e)


def _skinny_backward(ops, x, e):
    """dlogL/dx from layer 0's backward signal ``e``: Σ_j e_j · w0[:, j],
    j ascending, in fp32, times the log-clamp's derivative."""
    dx = x.new_zeros(x.shape)
    for j in range(ops.widths[1]):
        dx = dx + e[:, j, None] * ops.w0[None, :, j]
    return -(_log_clamp_grad(x) * dx)


def emulate_mixed_grad_gram(ops, x):
    """``fused_gram_mixed.cu``: K2's forward through ``ops.slabs`` (K2's
    stream), then the backward through the packed ``W_iᵀ`` fragments at
    ``ops.grad_tier`` as the tensor cores compute it (``mma_product``:
    the signal split or rounded once per product), e = h > 0 ? h@G + u :
    0 first, then e ← mask_{i−1} ? e @ W_iᵀ : 0 for i = n−1 … 1 with the
    masks from the fp32 pre-activations, the skinny layer's backward in
    fp32. ``(logL, dlogL/dx)``."""
    widths = ops.widths
    h, hg, u, masks, at = _gram_forward(ops, x)
    assert at == ops.slabs.w.numel() and len(ops.packed.wt) == len(widths) - 2
    e = torch.where(h > 0.0, hg + u, 0.0)
    for i in range(len(widths) - 2, 0, -1):
        acc = mma_product(e, ops.packed.wt[i - 1], ops.grad_tier)
        e = torch.where(masks[i - 1], acc[:, : widths[i]], 0.0)
    return _gram_value(ops, h, hg, u), _skinny_backward(ops, x, e)


def _mma_forward(ops, x):
    """``csrc/fused_gram_mma.cu``'s forward through ``ops.packed`` (K2's,
    and K3's at every pair it runs): the skinny layer exact, each
    activation split or rounded once into the next product, padded to 16
    columns with zeros, the quad from the fp32 ``h``. Returns the
    activations (fp32, padded), ``h@G`` and the value."""
    p = ops.packed
    h = torch.relu(skinny_dense(_log_clamp(x), ops.w0, ops.b0))
    h = torch.nn.functional.pad(h, (0, -h.shape[1] % 16))
    acts = [h]
    for w, b in zip(p.w, p.b):
        h = torch.relu(mma_product(h, w, ops.tier) + b)
        acts.append(h)
    hg = mma_product(h, p.g, ops.tier)
    value = -0.5 * (torch.sum((hg + 2.0 * p.u) * h, dim=-1) + ops.c) + ops.log_norm
    return acts, hg, value


def emulate_reverse_grad_gram(ops, x):
    """``fused_gram_mma.cu`` at a reverse pair: the tensor-core forward at
    ``ops.tier`` through the packed fragments (the value is the
    tensor-core K2's), e = h > 0 ? h@G + u : 0 in fp32 from the gram head,
    then e ← mask_{i−1} ? e @ W_iᵀ : 0 for i = n−1 … 1 through the fp32
    slabs of ``ops.slabs`` (k ascending, one sum per output), the masks
    from the fp32 pre-activations, the skinny layer's backward in fp32.
    ``(logL, dlogL/dx)``."""
    widths = ops.widths
    acts, hg, value = _mma_forward(ops, x)
    assert ops.packed.wt == () and ops.slabs.b.numel() == 0
    e = torch.where(acts[-1] > 0.0, hg + ops.packed.u, 0.0)
    at = 0
    for i in range(len(widths) - 2, 0, -1):
        acc, at = slab_layer(e, ops.slabs, at, widths[i + 1], widths[i])
        e = torch.where(acts[i - 1][:, : widths[i]] > 0.0, acc[:, : widths[i]], 0.0)
    assert at == ops.slabs.w.numel()
    return value, _skinny_backward(ops, x, e[:, : widths[1]])
