"""What the kernel wrappers share: the launch geometry and limits the
CUDA sources hard-code (``csrc/trunk.cuh``, ``csrc/tile_f32.cuh``), the
fp32 weight slabs and tile height of the register-tiled kernels, the
check of the input rows, the operand cache, the member axis, and the
launch itself.

A wrapper runs its kernel's plain PyTorch version for a CPU tensor and
launches the kernel for a CUDA tensor; any other device, and any tensor
the kernel does not take, raises.

The member axis (the port of JAX's ``vmap`` over ``pallas_call``): a
wrapper built with ``members=M`` takes an ensemble's stacked weights
(layer dicts of ``(M, in, out)`` / ``(M, out)``), folds and packs each
member as a single model's wrapper does, and stacks the operands member
after member (:func:`stack_members`). Every kernel runs the M members on
its grid's y axis in one launch, member m reading each operand at m
times that operand's byte stride (:func:`member_strides`); a single
model is M = 1 with zero strides. The plain versions read member m back
out of the same stacked buffers at the same strides (:func:`member_of`).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import torch

from tpu21cmvae_torch.utils.profiling import KERNELS, count, span

MAX_LAYERS = 8  # kMaxLayers in csrc/trunk.cuh
MAX_SHARED_BYTES = 232448  # an H100 block's dynamic shared-memory limit
MAX_MEMBERS = 65535  # kMaxMembers in csrc/trunk.cuh: a grid's y limit
TIER_CODE = {"f32": 0, "bf16": 1, "bf16x3": 2}
# csrc/tile_f32.cuh: the tile heights its kernels are built for, the
# chunk width (kSlabN), the fan-in padding (kPadK), the floats of per-row
# partials (kRedFloats), and each height's slab ring (Ring: k rows per
# slab, slots)
F32_TILE_ROWS = (64, 32, 16, 8)
SLAB_N, PAD_K, RED_FLOATS = 128, 32, 256
RING = {64: (32, 3), 32: (16, 2), 16: (8, 3), 8: (8, 3)}
# K3's fp32 kernel: its ring (GradRing) and the mask bytes it keeps per
# padded activation column (MaskBits::kColBytes), by tile height
GRAD_RING = {**RING, 64: (32, 2)}
MASK_COL_BYTES = {64: 8, 32: 4, 16: 2, 8: 2}
# the tallest tile the fp32 wrappers pick when it fits (PERF.md)
F32_PREFERRED_ROWS = 64


def padk(n: int) -> int:
    """``padk`` in ``csrc/tile_f32.cuh``: a fan-in padded to a multiple
    of every slab depth."""
    return -(-n // PAD_K) * PAD_K


def tile_stride(rows: int) -> int:
    """``tile_stride`` in ``csrc/tile_f32.cuh``: the k-major tile's row
    stride, padded at 16 and 8 rows against bank conflicts."""
    return {16: 18, 8: 9}.get(rows, rows)


def f32_tile_bytes(rows: int, in_rows: int, buf_cols: int, mask_cols: int | None = None) -> int:
    """Dynamic shared memory of one register-tiled fp32 CTA of ``rows``
    rows (``tile_smem_bytes`` in ``csrc/tile_f32.cuh``): the input tile
    (``in_rows`` k rows), two activation buffers of ``buf_cols`` k rows,
    the slab ring and the per-row partials. With ``mask_cols`` (K3: the
    padded columns of the activations whose ReLU masks it keeps) the ring
    is K3's and the mask bytes are added (``launch_grad_gram`` in
    ``csrc/fused_loglik_grad_gram_f32.cu``)."""
    depth, slots = (RING if mask_cols is None else GRAD_RING)[rows]
    return (4 * (tile_stride(rows) * (in_rows + 2 * buf_cols) + slots * depth * SLAB_N
                 + RED_FLOATS) + MASK_COL_BYTES[rows] * (mask_cols or 0))


def check_tile_rows(forced: int | None) -> int | None:
    """``forced`` if it is None or one of :data:`F32_TILE_ROWS`; else
    raise."""
    if forced is not None and forced not in F32_TILE_ROWS:
        raise ValueError(f"tile_rows must be one of {F32_TILE_ROWS}; got {forced!r}")
    return forced


def f32_tile_rows(in_rows: int, buf_cols: int, forced: int | None = None) -> int:
    """The tile height the fp32 K1 and K2 wrappers pass: ``forced`` if
    given (one of :data:`F32_TILE_ROWS`), else the tallest of them up to
    :data:`F32_PREFERRED_ROWS` whose shared memory fits, else the
    shortest (whose bytes then refuse the network)."""
    if check_tile_rows(forced) is not None:
        return forced
    fits = [r for r in F32_TILE_ROWS if r <= F32_PREFERRED_ROWS
            and f32_tile_bytes(r, in_rows, buf_cols) <= MAX_SHARED_BYTES]
    return fits[0] if fits else F32_TILE_ROWS[-1]


def pick_grad_rows(heights, n_rows: int | None, sm_count: int | None, members: int = 1) -> int:
    """Of ``heights`` (tallest first), the shortest that still runs a
    batch of ``n_rows`` for each of ``members`` as at most one block per
    SM of ``sm_count`` (M·⌈B/h⌉ blocks): a block alone on its SM finishes
    sooner the shorter its tile. Where even the tallest needs more blocks
    than SMs, or either count is unknown, the tallest: it does the most
    work per weight read (measured on an H100: PERF.md). A row's value
    and gradient do not depend on the height."""
    if n_rows is not None and sm_count is not None:
        for r in reversed(heights):
            if members * -(-n_rows // r) <= sm_count:
                return r
    return heights[0]


class Slabs(NamedTuple):
    """fp32 layers as ``csrc/tile_f32.cuh`` streams them
    (:func:`pack_slabs`): ``w`` every layer's slabs back to back, ``b``
    every layer's bias zero-padded to ``SLAB_N``·chunks."""

    w: torch.Tensor
    b: torch.Tensor


def pack_slabs(layers) -> Slabs:
    """Pack fp32 ``(w (K, N), b (N,))`` layers for the register-tiled
    kernels, once per model: ``w`` zero-padded to (padk(K), 128·chunks),
    chunks = ⌈N/128⌉, and laid out chunk by chunk, each chunk's
    (padk(K), 128) block k-major, so that a slab (d consecutive k rows of
    a chunk, d = 8, 16 or 32: a divisor of padk(K)) is contiguous memory
    and the whole stream's slab g sits at float offset 128·d·g."""
    ws, bs = [], []
    for w, b in layers:
        k, n = w.shape
        nc = -(-n // SLAB_N)
        padded = w.new_zeros((padk(k), nc * SLAB_N))
        padded[:k, :n] = w
        ws.append(padded.reshape(padk(k), nc, SLAB_N).transpose(0, 1).reshape(-1))
        bias = b.new_zeros(nc * SLAB_N)
        bias[:n] = b
        bs.append(bias)
    empty = torch.zeros(0, dtype=torch.float32)
    return Slabs(w=torch.cat(ws).contiguous() if ws else empty,
                 b=torch.cat(bs).contiguous() if bs else empty)


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
    bf16x3, whose operand stacks [hi; lo; hi] along its rows; a stacked
    operand's leading member axis is kept)."""
    if tier != "bf16x3":
        return op, None
    k = op.shape[-2] // 3
    return op[..., :k, :], op[..., k: 2 * k, :]


def check_members(members: int | None) -> int | None:
    """``members`` if it is None (one model) or 1 … :data:`MAX_MEMBERS`;
    else raise."""
    if members is not None and not (isinstance(members, int) and 1 <= members <= MAX_MEMBERS):
        raise ValueError(f"members must be None or 1 … {MAX_MEMBERS} (a grid's y limit); "
                         f"got {members!r}")
    return members


def member_layers(params, members: int) -> list:
    """Member m's layer dicts, as views of a stacked tree, for each m;
    raise unless every leaf has the leading member axis ``members``."""
    for i, layer in enumerate(params):
        w, b = layer["w"], layer["b"]
        if w.ndim != 3 or b.ndim != 2 or w.shape[0] != members or b.shape[0] != members:
            raise ValueError(
                f"a wrapper of {members} members takes stacked layers of (M, in, out) and "
                f"(M, out) with M = {members}; layer {i} has {tuple(w.shape)} and "
                f"{tuple(b.shape)}"
            )
    return [tuple({"w": layer["w"][m], "b": layer["b"][m]} for layer in params)
            for m in range(members)]


def stack_members(items):
    """One operand record from one per member (tensors, None, tuples,
    NamedTuples, dataclasses, and values every member shares): each
    tensor stacked on a new leading member axis."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: stack_members([getattr(i, f.name) for i in items])
            for f in dataclasses.fields(first)})
    if isinstance(first, tuple):
        parts = [stack_members(list(col)) for col in zip(*items)]
        return type(first)(*parts) if hasattr(first, "_fields") else tuple(parts)
    if any(i != first for i in items):
        raise ValueError(f"members differ in a shared operand: {items!r}")
    return first


def member_of(ops, m: int):
    """Member ``m``'s operand record out of stacked ones: each tensor read
    from its own buffer at ``m`` times its member stride, as the kernel
    reads it."""
    if isinstance(ops, torch.Tensor):
        return ops.as_strided(ops.shape[1:], ops.stride()[1:],
                              ops.storage_offset() + m * ops.stride(0))
    if dataclasses.is_dataclass(ops):  # a record of one member: its ``members`` None
        return dataclasses.replace(ops, **{
            f.name: None if f.name == "members" else member_of(getattr(ops, f.name), m)
            for f in dataclasses.fields(ops)})
    if isinstance(ops, tuple):
        parts = [member_of(t, m) for t in ops]
        return type(ops)(*parts) if hasattr(ops, "_fields") else tuple(parts)
    return ops


def per_member(plain, ops, x):
    """A plain version's output for each member of stacked ``ops``
    (:func:`member_of`), stacked: ``(M, …)``, or a tuple of such."""
    outs = [plain(member_of(ops, m), x) for m in range(ops.members)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(col) for col in zip(*outs))
    return torch.stack(outs)


def member_strides(tensors, members: int | None) -> ctypes.Array:
    """A C array of each operand's member stride in bytes, parallel to
    :func:`pointers` (0 for None and for a single model's operands).
    Each member's block of an operand must be contiguous."""
    strides = []
    for t in tensors:
        if t is None or members is None:
            strides.append(0)
            continue
        if not t[0].is_contiguous():
            raise ValueError("a member's operand block must be contiguous")
        strides.append(t.stride(0) * t.element_size())
    return (ctypes.c_longlong * len(strides))(*strides)


class OperandCache:
    """Folded, tier-split operands cached against the identity and the
    version counter of the weight tensors, so an in-place weight update
    refolds and an unchanged model never does. :attr:`folds` counts the
    folds."""

    def __init__(self, build):
        self._build = build
        self._hit = None
        self.folds = 0

    def __call__(self, params):
        # a stacked tree's leaves are its (M, …) tensors
        tensors = tuple(t for layer in params for t in (layer["w"], layer["b"]))
        versions = tuple(t._version for t in tensors)
        hit = self._hit
        if (
            hit is not None
            and len(hit[0]) == len(tensors)
            and all(a is b for a, b in zip(hit[0], tensors))
            and hit[1] == versions
        ):
            count("operand.hit")
            return hit[2]
        count("operand.fold")
        with torch.no_grad():
            ops = self._build(tuple({k: v.detach() for k, v in layer.items()}
                                    for layer in params))
        self.folds += 1
        self._hit = (tensors, versions, ops)
        return ops


def cached_args(ops, key, make):
    """``make()``, once per operand record ``ops`` (a folded, packed
    dataclass) and ``key``: the ctypes arguments a launch passes for the
    operands (widths, pointers, member strides), built once per fold
    rather than once per call. They live on ``ops`` and go with it;
    ``dataclasses.replace`` copies fields only, so a new record builds
    its own."""
    memo = vars(ops).setdefault("_launch_args", {})
    if key not in memo:
        memo[key] = make()
    return memo[key]


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
        stream = torch.cuda.current_stream(x.device).cuda_stream
        with span(entry, KERNELS):
            rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed: {lib.t21_error_string(rc).decode()} (cudaError {rc})"
        )
