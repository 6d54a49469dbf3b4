"""What the CPU tests of the port's register-tiled fp32 kernels share
(``csrc/tile_f32.cuh``: K1 ``fused_mlp.cu``, K2 ``fused_loglik_gram.cu``,
K3 ``fused_loglik_grad_gram_f32.cu``, the forward of
``fused_gram_mixed.cu``, the backward of ``fused_gram_mma.cu`` at a
reverse pair, and the wide route ``fused_loglik_grad_gram.cu``): packed
fp32 weight slabs read back by the kernels' layout, and the kernels'
arithmetic in plain torch, through the packed stream, slab by slab, k
ascending."""

import functools

import torch
from _torch_mma import mma_product, unpack

from tpu21cmvae_torch.ops.fold import _log_clamp, _log_clamp_grad
from tpu21cmvae_torch.ops.kernels._common import SLAB_N, padk
from tpu21cmvae_torch.ops.mlp import fused_skinny_dense


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
        h = fused_skinny_dense(h, ops.w[0], ops.b[0])
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
    y = fused_skinny_dense(_log_clamp(x), ops.w0, ops.b0)
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
    h = torch.relu(fused_skinny_dense(_log_clamp(x), ops.w0, ops.b0))
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


def _frag_matrix(flat, word, k, n, parts):
    """The (parts, 16·k-steps, 8·n-tiles) weights of the matrix whose
    fragments start at ``word`` of the fragment buffer ``flat`` (bf16)."""
    from tpu21cmvae_torch.ops.kernels.wide import frag_words, pad16

    size = 2 * frag_words(k, n, parts)
    packed = flat[2 * word: 2 * word + size]
    return unpack(packed.reshape(pad16(n) // 8, pad16(k) // 16, 32, parts, 4))


def emulate_wide(ops, x, plan=None):
    """``fused_loglik_grad_gram.cu``: the program of ``ops.program``
    (``ops/kernels/wide.py``; ``plan``, the one ``ops`` were packed
    under, default ``ops_plan``'s, or K1's ``k1_wide_plan``) run op by op
    on the CPU, as the kernel runs it on a tile (at any height: nothing
    depends on it), every buffer of the tile and of the workspace NaN
    until an op writes it (a read of memory no op wrote turns the result
    NaN). The fp32 products come from the stream ``ops.slabs.w`` in
    program order, one sum per output over k ascending, the accumulators
    carried between chunks; a split layer's upper 64 rows into sums of
    their own, added in the epilogue. The tensor-core products through
    the fragment buffer ``ops.frags`` at each op's own parts, the chunk
    split or rounded once, each 128-column chunk's products
    (``mma_product``'s) added to the carried sums. The workspace ops are
    copies. A skinny activation 0 recomputed from the input at each chunk
    (``fused_skinny_dense``); a dense layer 0's input read a chunk at a
    time, log-clamped, zero past its width. The masks from the fp32
    pre-activations, the quad (K1: Σy²) summed per (row, slice: columns ≡
    slice mod 8) and a skinny layer's dx per (row, slice: groups of four
    columns ≡ slice mod 8), the eight slices in order; a dense layer's dx
    a chunk at a time from its products. ``(logL, dlogL/dx)``, K2's
    ``logL`` where ``ops.grad_tier`` is None, or (``ops``: K1's
    :class:`MLPOperands`) the signal (B, n_out) or each row's Σy². It runs
    on ``x``'s device (``ops`` there too): on a card, at the batches the
    kernel's tests pool."""
    from tpu21cmvae_torch.ops.fold import _split_hi_lo, bf16_round
    from tpu21cmvae_torch.ops.kernels import wide
    from tpu21cmvae_torch.ops.kernels.fused_loglik import ops_plan
    from tpu21cmvae_torch.ops.kernels.fused_mlp import MLPOperands, k1_wide_plan

    k1 = isinstance(ops, MLPOperands)
    if k1:
        plan = plan or k1_wide_plan(ops.widths, ops.tier, ops.reduce)
        n_in, W, n_out = ops.widths[0], ops.widths[1:-1], ops.widths[-1]
        w0, b0 = ops.w[0], ops.b[0]
        xl = _log_clamp(x) if ops.log_clamp else x
        k3 = False
    else:
        plan = plan or ops_plan(ops)
        n_in, W = ops.widths[0], ops.widths[1:]
        w0, b0 = ops.w0, ops.b0
        xl = _log_clamp(x)
        k3 = ops.grad_tier is not None
    slices = 8  # kSlices
    B = x.shape[0]
    nan = float("nan")
    width = {wide.CA: SLAB_N, wide.CB: SLAB_N, **dict(zip(wide.HELD, plan.cols))}
    # each buffer as wide as its whole chunks: a product reads and writes
    # whole 32-column quarters, and those past a layer's width are not read
    buf = {i: x.new_full((B, max(chunks(c), 1) * SLAB_N), nan) for i, c in width.items()}
    ws = x.new_full((B, max(plan.ws_cols, 1)), nan)
    masks = torch.zeros((B, max(1, sum(padk(w) for w in W[:-1]))), dtype=torch.bool,
                        device=x.device)
    mats = {}
    q = x.new_zeros((slices, B))
    dxp = x.new_zeros((slices, B, n_in))
    at = 0  # the stream's float offset
    quad = dx = None

    def skinny(j0, valid):
        return fused_skinny_dense(xl, w0[:, j0: j0 + valid], b0[j0: j0 + valid])

    xin = torch.nn.functional.pad(xl, (0, chunks(n_in) * SLAB_N - n_in))
    signal = x.new_full((B, n_out), nan) if k1 else None
    dx_dense = x.new_full((B, n_in), nan)

    for op in ops.program.tolist():
        code = op[0]
        if code == wide.OP_SKINNY:
            kappa, cols, valid, mask_col = op[1:5]
            v = x.new_zeros((B, cols))
            v[:, :valid] = skinny(SLAB_N * kappa, valid)
            buf[wide.CA][:, :cols] = torch.relu(v)
            if mask_col >= 0:
                masks[:, mask_col: mask_col + cols] = v > 0.0
        elif code == wide.OP_MM:
            src, src_row, k, d0, d1, flags, dst, col0, parts, frag, ksteps, kstep0, n = op[1:14]
            first = flags & wide.MM_FIRST
            a = buf[src][:, src_row: src_row + k]
            out = buf[dst]
            if parts:  # tensor cores: the chunk split or rounded once
                if frag not in mats:  # read back on the CPU, used where x is
                    mats[frag] = _frag_matrix(ops.frags.cpu(), frag, 16 * ksteps, n,
                                              parts).to(x.device)
                wp = mats[frag][:, 16 * kstep0: 16 * kstep0 + k]
                hi, lo = _split_hi_lo(a) if parts == 2 else (bf16_round(a), None)
                for d in range(d0, d1):  # one 128-column product at a time
                    c0, c1 = SLAB_N * d, min(SLAB_N * (d + 1), wide.pad16(n))
                    w = wp[:, :, c0:c1]
                    prod = hi @ w[0] + hi @ w[1] + lo @ w[0] if parts == 2 else hi @ w[0]
                    cols = slice(c0 - col0, c1 - col0)
                    out[:, cols] = prod if first else out[:, cols] + prod
                continue
            split = flags & wide.MM_SPLIT
            for d in range(d0, d1):
                depth = 64 if split else k
                blk = ops.slabs.w[at: at + depth * SLAB_N].reshape(depth, SLAB_N)
                at += blk.numel()
                cols = slice(SLAB_N * d - col0, SLAB_N * (d + 1) - col0)
                acc = x.new_zeros((B, SLAB_N)) if first else out[:, cols].clone()
                if split:
                    for v in range(min(k, 64)):
                        acc[:, :64] = acc[:, :64] + a[:, v, None] * blk[v, :64]
                    for v in range(k - 64):
                        acc[:, 64:] = acc[:, 64:] + a[:, 64 + v, None] * blk[v, 64:]
                else:
                    for kk in range(k):
                        acc = acc + a[:, kk, None] * blk[kk]
                # a column quarter past the layer's width is never written
                live = [qq for qq in range(4)
                        if (32 * (qq & 1) if split else SLAB_N * d + 32 * qq) < n]
                for qq in live:
                    out[:, cols.start + 32 * qq: cols.start + 32 * qq + 32] = acc[:, 32 * qq:
                                                                                 32 * qq + 32]
        elif code == wide.OP_INPUT:
            kappa, dst = op[1:3]
            buf[dst][:, :SLAB_N] = xin[:, SLAB_N * kappa: SLAB_N * (kappa + 1)]
        elif code == wide.OP_FIN:
            dst, cols, valid, bias, split, mask_col, kind = op[1:8]
            out = buf[dst]
            v = x.new_zeros((B, cols))
            v[:, :valid] = out[:, :valid] + (out[:, 64: 64 + valid] if split else 0.0)
            if kind == wide.FIN_MASKED:
                out[:, :cols] = torch.where(masks[:, mask_col: mask_col + cols], v, 0.0)
            else:
                v[:, :valid] = v[:, :valid] + ops.slabs.b[bias: bias + valid]
                out[:, :cols] = v if kind == wide.FIN_LINEAR else torch.relu(v)
                if mask_col >= 0:
                    masks[:, mask_col: mask_col + cols] = v > 0.0
        elif code == wide.OP_OUT:
            src, col0, valid, mode = op[1:5]
            v = buf[src][:, :valid]
            if mode == wide.OUT_SUMSQ:
                for j in range(valid):
                    q[j % slices] = q[j % slices] + v[:, j] * v[:, j]
            elif mode == wide.OUT_SIGNAL:
                signal[:, col0: col0 + valid] = v
            else:
                dx_dense[:, col0: col0 + valid] = v
        elif code == wide.OP_GRAM:
            h_id, h0, e_id, e0, H, j0, cols, u_at = op[1:9]
            e = buf[e_id]
            for j in range(j0, j0 + cols):
                if j < H:
                    hv = torch.relu(skinny(j, 1))[:, 0] if h_id < 0 else buf[h_id][:, j - h0]
                    hg, uj = e[:, j - e0], ops.slabs.b[u_at + j]
                else:
                    hv = hg = uj = x.new_zeros(B)
                q[j % slices] = q[j % slices] + (hg + 2.0 * uj) * hv
                e[:, j - e0] = torch.where(hv > 0.0, hg + uj, 0.0)
        elif code == wide.OP_QUAD_WRITE:
            quad = functools.reduce(lambda s, t: s + t, q)
        elif code == wide.OP_DX:  # slice p takes the groups of four columns ≡ p (mod slices)
            src, src_row, valid, w0_col = op[1:5]
            for j in range(valid):
                p = j // 4 % slices
                dxp[p] = dxp[p] + buf[src][:, src_row + j, None] * w0[None, :, w0_col + j]
        elif code == wide.OP_DX_WRITE:
            dx = functools.reduce(lambda s, t: s + t, dxp)
        elif code == wide.OP_LOAD:
            col, dst = op[1:3]
            buf[dst][:, :SLAB_N] = ws[:, col: col + SLAB_N]
        elif code == wide.OP_STORE:
            src, col = op[1:3]
            ws[:, col: col + SLAB_N] = buf[src][:, :SLAB_N]
        elif code == wide.OP_RING:
            pass
        else:
            raise ValueError(f"unknown op {code}")
    assert at == ops.slabs.w.numel()
    if k1:
        return quad if ops.reduce == "sumsq" else signal
    value = -0.5 * (quad + ops.c) + ops.log_norm
    if not k3:
        return value
    if dx is None:  # a dense layer 0: dx a chunk at a time
        dx = dx_dense
    return value, -(_log_clamp_grad(x) * dx)

