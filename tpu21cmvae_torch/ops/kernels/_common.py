"""What the kernel wrappers share: the launch geometry and limits the
CUDA sources hard-code (``csrc/trunk.cuh``), the check of the input
rows, the operand cache, and the launch itself.

A wrapper runs its kernel's plain PyTorch version for a CPU tensor and
launches the kernel for a CUDA tensor; any other device, and any tensor
the kernel does not take, raises.
"""

from __future__ import annotations

import ctypes

import torch

ROWS_PER_BLOCK = 16  # kRows in csrc/trunk.cuh
MAX_LAYERS = 8  # kMaxLayers in csrc/trunk.cuh
MAX_SHARED_BYTES = 232448  # an H100 block's dynamic shared-memory limit
TIER_CODE = {"f32": 0, "bf16": 1, "bf16x3": 2}


def check_rows(raw, device: torch.device, n_in: int) -> torch.Tensor:
    """``raw`` as (B, n_in) rows after the checks every kernel needs: a
    contiguous float32 tensor on ``device``, shaped (n_in,) or (B, n_in)."""
    if not isinstance(raw, torch.Tensor):
        raise TypeError(f"raw must be a torch.Tensor; got {type(raw).__name__}")
    if raw.device != device:
        raise ValueError(f"raw is on {raw.device}; this wrapper runs on {device}")
    if raw.dtype != torch.float32:
        raise TypeError(f"raw must be float32; got {raw.dtype}")
    if not raw.is_contiguous():
        raise ValueError("raw must be contiguous")
    x = raw.reshape(1, -1) if raw.ndim == 1 else raw
    if x.ndim != 2 or x.shape[1] != n_in:
        raise ValueError(f"raw must be ({n_in},) or (B, {n_in}); got {tuple(raw.shape)}")
    return x


def hi_lo(op: torch.Tensor, tier: str):
    """A kernel's (hi, lo) views of a prepared operand (lo: None unless
    bf16x3, whose operand stacks [hi; lo; hi])."""
    if tier != "bf16x3":
        return op, None
    k = op.shape[0] // 3
    return op[:k], op[k: 2 * k]


class OperandCache:
    """Folded, tier-split operands cached against the identity and the
    version counter of the weight tensors, so an in-place weight update
    refolds and an unchanged model never does."""

    def __init__(self, build):
        self._build = build
        self._hit = None

    def __call__(self, params):
        tensors = tuple(t for layer in params for t in (layer["w"], layer["b"]))
        versions = tuple(t._version for t in tensors)
        hit = self._hit
        if (
            hit is not None
            and len(hit[0]) == len(tensors)
            and all(a is b for a, b in zip(hit[0], tensors))
            and hit[1] == versions
        ):
            return hit[2]
        with torch.no_grad():
            ops = self._build(tuple({k: v.detach() for k, v in layer.items()}
                                    for layer in params))
        self._hit = (tensors, versions, ops)
        return ops


def pointers(tensors) -> ctypes.Array:
    """A C array of device pointers (null for None)."""
    return (ctypes.c_void_p * len(tensors))(
        *(None if t is None else t.data_ptr() for t in tensors)
    )


def launch(name: str, entry: str, x: torch.Tensor, *args):
    """Call the library's C entry point ``entry`` on PyTorch's current
    stream of ``x``'s device; raise if the launch was refused."""
    from tpu21cmvae_torch.ops.kernels._build import load_library

    lib = load_library()
    with torch.cuda.device(x.device):
        rc = getattr(lib, entry)(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed: {lib.t21_error_string(rc).decode()} (cudaError {rc})"
        )
