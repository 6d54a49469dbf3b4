"""What the CPU tests of ``csrc/fused_gram_tall.cu`` share: its weight
stream read back by wgmma's K-major core-matrix layout, and K3 emulated
through it in the kernel's k-order."""

import numpy as np
import torch

from tpu21cmvae_torch.ops.fold import _log_clamp, _log_clamp_grad, _split_hi_lo, bf16_round
from tpu21cmvae_torch.ops.kernels.fused_loglik import (
    tall_chunks,
    tall_stages,
)
from tpu21cmvae_torch.ops.kernels.fused_mlp import _pad16
from tpu21cmvae_torch.ops.mlp import fused_skinny_dense


def unpack_tall(stream: torch.Tensor, widths, tier: str, grad_tier: str) -> list:
    """Each stage's weights, ``(parts, K₁₆, N₁₆)`` in fp32, as the stream
    holds them: stage by stage, chunk by chunk, k-step by k-step, the first
    then the second warpgroup's block, each part of a block K-major core
    matrices without swizzle: element (k, n) of a block of width w at
    ((k // 8)·(w // 8) + n // 8)·64 + (n % 8)·8 + k % 8. Every element of
    every stage is read exactly once."""
    flat = stream.float().numpy()
    at = 0
    out = []
    for k, n, parts in tall_stages(widths, tier, grad_tier):
        kp, np_ = _pad16(k), _pad16(n)
        w = np.full((parts, kp, np_), np.nan, np.float32)
        for chunk in tall_chunks(n):
            for k0 in range(0, kp, 16):
                depth = 16
                for c0, width in chunk:
                    if not width:
                        continue
                    p, kk, nn = np.meshgrid(np.arange(parts), np.arange(depth), np.arange(width),
                                            indexing="ij")
                    src = (at + p * depth * width
                           + ((kk // 8) * (width // 8) + nn // 8) * 64 + (nn % 8) * 8 + kk % 8)
                    assert np.isnan(w[p, k0 + kk, c0 + nn]).all()  # read once
                    w[p, k0 + kk, c0 + nn] = flat[src]
                    at += parts * depth * width
        assert not np.isnan(w).any()
        out.append(torch.as_tensor(w))
    assert at == flat.size
    return out


def _tier_product(a: torch.Tensor, w: torch.Tensor, tier: str) -> torch.Tensor:
    """``a @ w`` from a stage's unpacked ``w`` (parts, K₁₆, N₁₆) as a
    warpgroup sums it: ``a`` zero-padded to K₁₆ and split (bf16x3) or
    rounded (bf16) once; per k-step of 16 its products (hi·w_hi + hi·w_lo
    + lo·w_hi at bf16x3) summed alone, then added to the running fp32 sum
    in k order."""
    a = torch.nn.functional.pad(a, (0, w.shape[1] - a.shape[1]))
    if tier == "bf16x3":
        hi, lo = _split_hi_lo(a)
    else:
        hi, lo = bf16_round(a), None
    acc = torch.zeros(a.shape[0], w.shape[2])
    for k0 in range(0, w.shape[1], 16):
        s = slice(k0, k0 + 16)
        t = hi[:, s] @ w[0][s]
        if lo is not None:
            t = t + hi[:, s] @ w[1][s] + lo[:, s] @ w[0][s]
        acc = acc + t
    return acc


def emulate_tall(ops, x: torch.Tensor):
    """K3 as ``fused_gram_tall.cu`` computes it, through the operands'
    stream (``ops.tall``) and padded biases: the skinny layer exact, each
    trunk layer and ``G`` at the value tier and each ``W_iᵀ`` at the
    backward tier by :func:`_tier_product`, ReLU masks from the fp32
    activations, the quad from the fp32 ``h``, layer 0's backward signal
    in fp32 into the exact skinny backward; padded columns carried as
    zeros. ``(logL, dlogL/dx)``."""
    n = len(ops.widths) - 1
    stages = unpack_tall(ops.tall, ops.widths, ops.tier, ops.grad_tier)
    p = ops.packed
    a = torch.relu(fused_skinny_dense(_log_clamp(x), ops.w0, ops.b0))
    acts = [torch.nn.functional.pad(a, (0, _pad16(a.shape[1]) - a.shape[1]))]
    for i in range(1, n):
        acts.append(torch.relu(_tier_product(acts[-1], stages[i - 1], ops.tier) + p.b[i - 1]))
    h = acts[-1]
    hg = _tier_product(h, stages[n - 1], ops.tier)
    quad = torch.sum((hg + 2.0 * p.u) * h, dim=-1)
    e = torch.where(h > 0.0, hg + p.u, 0.0)
    for j, i in enumerate(range(n - 1, 0, -1)):
        e = torch.where(acts[i - 1] > 0.0, _tier_product(e, stages[n + j], ops.grad_tier), 0.0)
    e = e[:, : ops.w0.shape[1]] @ ops.w0.T
    return -0.5 * (quad + ops.c) + ops.log_norm, -(_log_clamp_grad(x) * e)
