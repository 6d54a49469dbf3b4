"""What the CPU tests of the port's tensor-core kernels share: packed
``mma`` B fragments read back by the PTX ISA's layout, and a tier product
through them as the kernels compute it (``csrc/mma.cuh``)."""

import numpy as np
import torch

from tpu21cmvae_torch.ops.fold import _split_hi_lo, bf16_round


def unpack(packed: torch.Tensor) -> torch.Tensor:
    """The (parts, 16·k-steps, 8·n-tiles) weights a packed operand holds,
    read by the PTX ISA's mma.m16n8k16 B-fragment layout (bf16, ``.col``):
    lane 4·groupID + tig holds rows 2·tig, 2·tig + 1 (register b0) and
    2·tig + 8, 2·tig + 9 (b1) of column groupID, the lower row in the
    lower half of each 32-bit register."""
    n_tiles, k_steps, lanes, parts, q = packed.shape
    t, s, lane, p, q = np.meshgrid(*map(np.arange, packed.shape), indexing="ij")
    rows = 16 * s + 2 * (lane % 4) + np.array([0, 1, 8, 9])[q]
    cols = 8 * t + lane // 4
    out = np.full((parts, 16 * k_steps, 8 * n_tiles), np.nan, np.float32)
    out[p, rows, cols] = packed.float().numpy()
    assert not np.isnan(out).any()  # every weight slot is in some fragment
    return torch.as_tensor(out)


def mma_product(a: torch.Tensor, packed: torch.Tensor, tier: str) -> torch.Tensor:
    """``a @ w`` from ``w``'s packed fragments as ``mma_layer`` computes
    it: ``a`` zero-padded to the fragments' depth and split (bf16x3) or
    rounded (bf16) once, the bf16 products summed in fp32; the result is
    as wide as the padded layer."""
    wp = unpack(packed)
    a = torch.nn.functional.pad(a, (0, wp.shape[1] - a.shape[1]))
    if tier == "bf16x3":
        hi, lo = _split_hi_lo(a)
        return hi @ wp[0] + hi @ wp[1] + lo @ wp[0]
    return bf16_round(a) @ wp[0]
