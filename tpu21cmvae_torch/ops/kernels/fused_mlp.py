"""K1: the whole MLP as one kernel per row tile, its plain PyTorch
version, and the wrapper that picks between them by the input's device.

The port of ``tpu21cmvae/ops/pallas/fused_mlp.py::make_fused_mlp``:
optional log10/clamp of input columns 0–2, a skinny first layer (fan-in
≤ 8) as exact fp32 FMA at every tier or else a tier matmul, then (matmul
+ bias, ReLU) for every hidden layer, then a linear last layer.
``reduce="sumsq"`` returns each row's Σy² in place of the signal — the
direct likelihood's tail, reduced inside the kernel
(:func:`~tpu21cmvae_torch.ops.kernels.fused_loglik.make_fused_loglik`).
:func:`make_fused_emulate` folds the normalizer into the first and last
layers (``ops/fold.py::fold_emulator_constants``) and predicts.

Three CUDA kernels, picked by :func:`k1_route`: ``csrc/fused_mlp_mma.cu``
runs the bf16 tiers on the tensor cores, from weights that
:func:`pack_mma_operands` packed once into bf16 ``mma`` fragments;
``csrc/fused_mlp.cu`` runs the fp32 tier on the CUDA cores,
register-tiled over ``BM``-row tiles (``csrc/tile_f32.cuh``), from fp32
weight slabs that :func:`~tpu21cmvae_torch.ops.kernels._common.pack_slabs`
packed once, and a network whose only layer is skinny at every tier;
every network those two refuse, by depth (more than eight layers) or by
shared memory, runs at every tier on the wide route,
``csrc/fused_loglik_grad_gram.cu``'s K1 program
(:func:`~tpu21cmvae_torch.ops.kernels.wide.wide_plan` with ``n_out``:
the layers streamed in 128-column chunks, what shared memory cannot hold
in a workspace in device memory, allocated once per wrapper).
:func:`fused_mlp_reference` does the same arithmetic — same folds, same
hi/lo split — in plain tensor operations. With ``members=M`` the wrapper
runs an ensemble's M members in one launch (``_common.py``'s member
axis); :func:`fused_mlp_members_reference` is its plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from tpu21cmvae_torch.ops.fold import (
    _log_clamp,
    fold_emulator_constants,
    prepare_operand,
    resolve_tier,
    tier_matmul,
)
from tpu21cmvae_torch.ops.kernels._common import (
    MAX_LAYERS,
    MAX_SHARED_BYTES,
    TIER_CODE,
    OperandCache,
    Slabs,
    cached_args,
    check_members,
    check_rows,
    f32_tile_bytes,
    f32_tile_rows,
    hi_lo,
    launch,
    member_layers,
    member_strides,
    pack_slabs,
    padk,
    per_member,
    pick_grad_rows,
    pointers,
    stack_members,
)
from tpu21cmvae_torch.ops.kernels.wide import (
    WideLaunch,
    WidePlan,
    pack_wide_frags,
    pack_wide_slabs,
    program_table,
    wide_ints,
    wide_plan,
    wide_tail,
)
from tpu21cmvae_torch.ops.mlp import SKINNY_DENSE_MAX_IN, fused_skinny_dense
from tpu21cmvae_torch.utils.profiling import WRAPPERS, span

WARPS_PER_BLOCK = 8  # kMmaWarps in csrc/mma.cuh
MMA_ROWS_PER_BLOCK = 32  # kTileRows in csrc/fused_mlp_mma.cu
MMA_TIERS = ("bf16", "bf16x3")


@dataclasses.dataclass(frozen=True)
class MLPOperands:
    """Everything K1 and its plain version read besides the input rows:
    per layer ``w`` (prepared at ``tier``, or exact fp32 for a skinny
    first layer) and ``b``."""

    tier: str
    skinny: bool
    log_clamp: bool
    reduce: str
    widths: tuple  # (n_in, *layer widths)
    w: tuple
    b: tuple
    # per layer (w, b) for fused_mlp_mma.cu (pack_mma_operands; a skinny
    # first layer's exact fp32 pair as it is), or None where K1 runs
    # fused_mlp.cu
    packed: tuple | None = None
    # the layers after a skinny first one (all of them without one) as
    # fused_mlp.cu streams them (pack_slabs); on the wide route its fp32
    # stream and biases (pack_wide_slabs); None where K1 runs
    # fused_mlp_mma.cu
    slabs: Slabs | None = None
    # M where every tensor above is M members' stacked on a leading axis
    # (stack_members), else None
    members: int | None = None
    # the wide route's op table (program_table) and fragment buffer
    # (pack_wide_frags; None where no product runs on the tensor cores)
    program: torch.Tensor | None = None
    frags: torch.Tensor | None = None


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def runs_on_tensor_cores(widths, tier: str) -> bool:
    """Whether K1 at ``tier`` runs ``fused_mlp_mma.cu``: a bf16 tier and
    at least one layer that is not the skinny exact-fp32 one."""
    return tier in MMA_TIERS and not (len(widths) == 2 and widths[0] <= SKINNY_DENSE_MAX_IN)


def pack_mma_operands(w_op: torch.Tensor, b: torch.Tensor, tier: str):
    """One layer's prepared operand ``w_op`` (:func:`prepare_operand` at
    a bf16 tier) and bias as ``fused_mlp_mma.cu`` reads them: the
    ``mma.m16n8k16`` B fragments in bf16 (exact: the values are
    bf16-representable), and the bias zero-padded to the fragment grid.

    ``w`` (K, N) is zero-padded to (K₁₆, N₁₆), multiples of 16, and laid
    out as (N₁₆/8 n8 tiles, K₁₆/16 k-steps, 32 lanes, parts, 4): lane
    ``4g + t`` of the fragment for tile ``n`` and step ``s`` holds
    ``w[16s + 2t + {0, 1, 8, 9}, 8n + g]``, for each part — ``w_hi`` then
    ``w_lo`` at bf16x3, ``bf16_rn(w)`` alone at bf16. So a warp reads one
    tile's fragment for one k-step as one contiguous block."""
    parts = [p for p in hi_lo(w_op, tier) if p is not None]
    k, n = parts[0].shape
    kp, np_ = _pad16(k), _pad16(n)
    frags = []
    for part in parts:
        padded = torch.zeros((kp, np_), dtype=torch.float32, device=part.device)
        padded[:k, :n] = part
        # k = 16s + 8h + 2t + e, n = 8·tile + g  →  (tile, s, g, t, h, e)
        f = padded.reshape(kp // 16, 2, 4, 2, np_ // 8, 8).permute(4, 0, 5, 2, 1, 3)
        frags.append(f.reshape(np_ // 8, kp // 16, 32, 4))
    packed = torch.stack(frags, dim=3).to(torch.bfloat16).contiguous()
    bias = torch.zeros(np_, dtype=torch.float32, device=b.device)
    bias[:n] = b
    return packed, bias


def pack_frags(w: torch.Tensor, tier: str) -> torch.Tensor:
    """A prepared operand's ``mma`` B fragments alone
    (:func:`pack_mma_operands`)."""
    return pack_mma_operands(w, w.new_zeros(w.shape[1]), tier)[0]


def mlp_operands(params, tier: str, log_clamp: bool, reduce: str,
                 plan: WidePlan | None = None) -> MLPOperands:
    """Split (already folded) layer dicts for ``tier``; a first layer of
    fan-in ≤ 8 stays exact fp32. Packed for the wide route's ``plan``
    where given, else for the kernel the tier runs."""
    skinny = params[0]["w"].shape[0] <= SKINNY_DENSE_MAX_IN
    widths = (params[0]["w"].shape[0], *(layer["b"].shape[0] for layer in params))
    w = tuple(
        layer["w"].to(torch.float32).contiguous() if i == 0 and skinny
        else prepare_operand(layer["w"], tier)
        for i, layer in enumerate(params)
    )
    b = tuple(layer["b"].to(torch.float32).contiguous() for layer in params)
    packed = slabs = None
    if plan is not None:
        return pack_wide_mlp(MLPOperands(tier=tier, skinny=skinny, log_clamp=log_clamp,
                                         reduce=reduce, widths=widths, w=w, b=b), plan)
    if runs_on_tensor_cores(widths, tier):
        packed = tuple((wi, bi) if i == 0 and skinny else pack_mma_operands(wi, bi, tier)
                       for i, (wi, bi) in enumerate(zip(w, b)))
    else:
        slabs = pack_slabs(list(zip(w, b))[int(skinny):])
    return MLPOperands(tier=tier, skinny=skinny, log_clamp=log_clamp, reduce=reduce,
                       widths=widths, w=w, b=b, packed=packed, slabs=slabs)


def pack_wide_mlp(ops: MLPOperands, plan: WidePlan) -> MLPOperands:
    """``ops`` packed for the wide route's K1 ``plan``
    (:func:`k1_wide_plan`): its program, its fp32 stream with the biases
    (layers 1 …, or 0 … where layer 0 is dense, the output's last) and
    its fragment buffer; layer i's matrix is ``ops.w[i]`` at ``ops.tier``,
    the output layer's the last."""

    def matrix(_, layer):
        return ops.w[layer], ops.tier

    return dataclasses.replace(
        ops, packed=None, slabs=pack_wide_slabs(matrix, ops.b[int(ops.skinny):], plan),
        frags=pack_wide_frags(matrix, plan, pack_frags),
        program=program_table(plan).to(ops.b[0].device))


def fused_mlp_reference(ops: MLPOperands, x: torch.Tensor) -> torch.Tensor:
    """K1 in plain PyTorch: (B, n_out), or (B,) under ``sumsq``, for rows
    ``x`` (B, n_in) float32 on ``ops``' device."""
    h = _log_clamp(x) if ops.log_clamp else x
    last = len(ops.w) - 1
    for i, (w, b) in enumerate(zip(ops.w, ops.b)):
        if i == 0 and ops.skinny:
            h = fused_skinny_dense(h, w, b)
        else:
            h = tier_matmul(h, w, ops.tier) + b
        if i < last:
            h = torch.relu(h)
    return torch.sum(h * h, dim=-1) if ops.reduce == "sumsq" else h


def fused_mlp_members_reference(ops: MLPOperands, x: torch.Tensor) -> torch.Tensor:
    """The member-batched K1 in plain PyTorch: :func:`fused_mlp_reference`
    of each member of stacked ``ops``, read out of the stacked buffers at
    its member stride: (M, B, n_out), or (M, B) under ``sumsq``."""
    return per_member(fused_mlp_reference, ops, x)


def f32_geometry(widths) -> tuple:
    """``fused_mlp.cu``'s (input tile k rows, activation buffer k rows):
    the fan-in (padded to 32 unless the first layer is skinny) and the
    widest hidden layer padded to 32 (0 for a single layer)."""
    n_in = widths[0]
    in_rows = n_in if n_in <= SKINNY_DENSE_MAX_IN else padk(n_in)
    return in_rows, max((padk(w) for w in widths[1:-1]), default=0)


def f32_rows(widths, forced: int | None = None) -> int:
    """The tile height ``fused_mlp.cu`` runs ``widths`` at
    (:func:`~tpu21cmvae_torch.ops.kernels._common.f32_tile_rows`)."""
    return f32_tile_rows(*f32_geometry(widths), forced)


def shared_bytes(widths, tier: str = "f32", rows: int | None = None) -> int:
    """Dynamic shared memory of one K1 block at ``tier``. ``fused_mlp.cu``
    (:func:`~tpu21cmvae_torch.ops.kernels._common.f32_tile_bytes`) keeps
    a ``rows``-row fp32 input tile, two activation buffers as wide as the
    widest hidden layer (they take turns as a layer's input and output;
    the last layer writes from registers), the weight-slab ring and the
    per-row partials of ``sumsq``; ``rows`` defaults to the height
    :func:`f32_rows` picks. ``fused_mlp_mma.cu`` keeps bf16 tiles (hi and
    lo at bf16x3) as wide as the widest tensor-core layer input padded to
    16, plus 8 columns of row padding."""
    if not runs_on_tensor_cores(widths, tier):
        return f32_tile_bytes(rows or f32_rows(widths), *f32_geometry(widths))
    first = 1 if widths[0] <= SKINNY_DENSE_MAX_IN else 0
    stride = max(_pad16(k) for k in widths[first:-1]) + 8
    parts = 2 if tier == "bf16x3" else 1
    return (2 * 2 * parts * MMA_ROWS_PER_BLOCK * stride
            + 4 * MMA_ROWS_PER_BLOCK * (widths[0] + WARPS_PER_BLOCK))


def k1_route(widths, tier: str, tile_rows: int | None = None) -> str:
    """The kernel K1 at ``tier`` runs ``widths`` (``(n_in, *layer
    widths)``) on: ``"mma"`` (``fused_mlp_mma.cu``: a bf16 tier and a
    layer that is not the skinny exact-fp32 one), ``"f32"``
    (``fused_mlp.cu``: the fp32 tier, or a lone skinny layer; a forced
    ``tile_rows`` keeps it, which then refuses a height that does not
    fit), each where it holds the network by depth and shared memory;
    else ``"wide"`` (``fused_loglik_grad_gram.cu``'s K1 program)."""
    if len(widths) - 1 > MAX_LAYERS:
        return "wide"
    mma = runs_on_tensor_cores(widths, tier)
    if not mma and tile_rows is not None:
        return "f32"
    if shared_bytes(widths, tier) > MAX_SHARED_BYTES:
        return "wide"
    return "mma" if mma else "f32"


def k1_wide_plan(widths, tier: str, reduce: str = "none") -> WidePlan:
    """The wide route's K1 program of ``widths`` at ``tier`` (its trunk
    the ReLU activations, its head the linear output layer), reduced to
    each row's Σy² under ``sumsq``."""
    widths = tuple(widths)
    return wide_plan(widths[:-1], TIER_CODE[tier], None, n_out=widths[-1],
                     sumsq=reduce == "sumsq")


def _out(ops: MLPOperands, x: torch.Tensor) -> torch.Tensor:
    """K1's output buffer for rows ``x``: (B, n_out), or (B,) under
    ``sumsq``, after the member axis of stacked ``ops``."""
    n = x.shape[0]
    shape = (n,) if ops.reduce == "sumsq" else (n, ops.widths[-1])
    if ops.members is not None:
        shape = (ops.members, *shape)
    return torch.empty(shape, dtype=torch.float32, device=x.device)


def _fused_mlp_cuda(ops: MLPOperands, x: torch.Tensor, rows: int) -> torch.Tensor:
    """Launch K1 on PyTorch's current stream (no synchronisation), one
    launch for every member of stacked ``ops``; ``rows``:
    ``fused_mlp.cu``'s tile height."""
    out = _out(ops, x)
    if not x.shape[0]:
        return out
    entry, args = cached_args(ops, rows, lambda: _launch_args(ops, rows))
    launch("K1", entry, x, x.data_ptr(), out.data_ptr(), x.shape[0], *args)
    return out


def _fused_mlp_wide_cuda(ops: MLPOperands, x: torch.Tensor, rows: int,
                         workspace: torch.Tensor | None, ctas: int,
                         plan: WidePlan) -> torch.Tensor:
    """Launch K1's wide program (``fused_loglik_grad_gram.cu``,
    ``k1_fused_mlp_wide``) on PyTorch's current stream, one launch for
    every member of stacked ``ops`` packed under ``plan``, at tile height
    ``rows``; ``workspace`` and ``ctas``: the persistent grid's, where the
    plan spills (:class:`~tpu21cmvae_torch.ops.kernels.wide.WideLaunch`)."""
    out = _out(ops, x)
    if not x.shape[0]:
        return out

    def make():
        skinny = [ops.w[0], ops.b[0]] if ops.skinny else [None, None]
        tensors = [*skinny, ops.slabs.b, ops.slabs.w, ops.program, ops.frags]
        widths = (ctypes.c_int * len(ops.widths))(*ops.widths)
        return "k1_fused_mlp_wide", (
            len(ops.w), widths, pointers(tensors), member_strides(tensors, ops.members),
            ops.members or 1, *wide_tail(plan, rows, ops.members, workspace, ctas),
            int(ops.log_clamp), int(ops.reduce == "sumsq"))

    key = ("wide", rows, None if workspace is None else workspace.data_ptr(), ctas,
           plan.a_parts, *wide_ints(plan))
    entry, args = cached_args(ops, key, make)
    launch("K1", entry, x, x.data_ptr(), out.data_ptr(), x.shape[0], *args)
    return out


def _launch_args(ops: MLPOperands, rows: int) -> tuple:
    """The C entry of ``ops``' route and its arguments after the row
    count: the layer count and widths, the operand pointers, their member
    strides, the member count and the entry's ints."""
    flags = (int(ops.log_clamp), int(ops.reduce == "sumsq"))
    if ops.packed is not None:
        tensors = [t for pair in ops.packed for t in pair]
        entry, ints = "k1_fused_mlp_mma", (TIER_CODE[ops.tier], *flags)
    else:  # the fp32 tier, or a lone skinny layer (exact fp32 at every tier)
        skinny = (ops.w[0], ops.b[0]) if ops.skinny else (None, None)
        tensors = [*skinny, *ops.slabs]
        entry, ints = "k1_fused_mlp", (*flags, rows)
    widths = (ctypes.c_int * len(ops.widths))(*ops.widths)
    return entry, (len(ops.w), widths, pointers(tensors), member_strides(tensors, ops.members),
                   ops.members or 1, *ints)


class FusedMLP:
    """K1: ``(params, x) → y``, the MLP of widths ``sizes`` with ReLU
    hidden layers and a linear last layer; a 1-D ``x`` is one row.

    ``x`` must be a contiguous float32 tensor on the wrapper's
    ``device``. On a CUDA device every call with at least one row
    launches K1 and adds one to :attr:`launches`; on the CPU it runs
    :func:`fused_mlp_reference`. ``fold`` (optional) maps ``params`` to
    the layers K1 runs (a normalizer or likelihood fold); the folded,
    tier-split operands are cached against the identity and version of
    the ``params`` tensors. The kernel is :func:`k1_route`'s
    (:attr:`route`): on ``fused_mlp.cu`` ``tile_rows`` (one of
    :data:`~tpu21cmvae_torch.ops.kernels._common.F32_TILE_ROWS`) forces
    the tile height, else :func:`f32_rows` picks it; :attr:`tile_rows` is
    what the fp32 route launches with. On the wide route (:attr:`wide`,
    any width and depth) the height is one of its plan's
    (:attr:`heights`, 32 or 16 rows), forced by ``tile_rows`` or picked
    per batch (:meth:`rows_for`), and :attr:`wide_launch` holds the
    workspace.

    ``members=M`` (default None: one model) takes an ensemble's stacked
    ``params`` (layer dicts of ``(M, in, out)`` / ``(M, out)``), folds
    each member as one model is folded, and returns ``(M, B, n_out)``
    (``(M, B)`` under ``sumsq``) from one launch per call; on the CPU it
    runs :func:`fused_mlp_members_reference`.
    """

    def __init__(self, sizes, *, log_clamp_input=False, precision="highest",
                 reduce="none", fold=None, tile_rows=None, members=None, device):
        self.sizes = tuple(int(s) for s in sizes)
        if reduce not in ("none", "sumsq"):
            raise ValueError(f"reduce must be 'none' or 'sumsq'; got {reduce!r}")
        if len(self.sizes) < 2:
            raise ValueError(f"K1 takes at least one layer; got sizes {self.sizes}")
        self.tier = resolve_tier(precision, "highest")
        self.route = k1_route(self.sizes, self.tier, tile_rows)
        self.wide = self.route == "wide"
        self.plan = None
        if self.wide:
            self.plan = k1_wide_plan(self.sizes, self.tier, reduce)
            self.heights = self.plan.heights
            if tile_rows is not None and tile_rows not in self.heights:
                raise ValueError(f"tile_rows on the wide route must be one of "
                                 f"{self.heights}; got {tile_rows!r}")
            self.tile_rows = tile_rows
        else:
            self.tile_rows = f32_rows(self.sizes, tile_rows)
            need = shared_bytes(self.sizes, self.tier, self.tile_rows)
            if need > MAX_SHARED_BYTES:  # a forced height that does not fit
                raise NotImplementedError(
                    f"widths {self.sizes} need {need} bytes of shared memory per K1 "
                    f"block at the {self.tier} tier; the limit is {MAX_SHARED_BYTES}"
                )
        self.device = torch.empty(0, device=device).device
        self.reduce = reduce
        self.members = check_members(members)
        # the wide route's height rule counts blocks against the card's SMs
        self.sm_count = (torch.cuda.get_device_properties(self.device).multi_processor_count
                         if self.device.type == "cuda" else None)
        self.wide_launch = (WideLaunch(self.plan, _fused_mlp_wide_cuda, self.sm_count,
                                       self.device, self.members) if self.wide else None)
        self.launches = 0
        self._fold = fold or (lambda params: params)
        self._log_clamp = log_clamp_input
        self.operands = OperandCache(self._build)

    def _build(self, params) -> MLPOperands:
        if self.members is not None:
            ops = stack_members([self._build_one(p)
                                 for p in member_layers(params, self.members)])
            return dataclasses.replace(ops, members=self.members)
        return self._build_one(params)

    def _build_one(self, params) -> MLPOperands:
        ops = mlp_operands(self._fold(params), self.tier, self._log_clamp, self.reduce,
                           self.plan)
        if ops.widths != self.sizes:
            raise ValueError(f"params have widths {ops.widths}; this K1 takes {self.sizes}")
        return ops

    @torch.no_grad()
    def __call__(self, params, x):
        with span("K1", WRAPPERS):
            x = check_rows(x, self.device, self.sizes[0])
            ops = self.operands(params)
            if x.device.type == "cpu":
                if ops.members is not None:
                    return fused_mlp_members_reference(ops, x)
                return fused_mlp_reference(ops, x)
            if x.device.type != "cuda":
                raise ValueError(f"K1 runs on CUDA or (plain) on the CPU; got {x.device}")
            if x.shape[0]:  # an empty batch launches nothing
                self.launches += 1
            if self.wide:
                return self.wide_launch(ops, x, self.rows_for(x.shape[0]))
            return _fused_mlp_cuda(ops, x, self.tile_rows)

    def rows_for(self, n_rows: int) -> int | None:
        """The wide route's tile height for a batch of ``n_rows`` rows of
        each member (:func:`~tpu21cmvae_torch.ops.kernels._common.pick_grad_rows`),
        :attr:`tile_rows` if forced; None on the other routes."""
        if not self.wide:
            return None
        return self.tile_rows or pick_grad_rows(self.heights, n_rows, self.sm_count,
                                                self.members or 1)


def make_fused_mlp(sizes, *, log_clamp_input=False, precision="highest",
                   reduce="none", tile_rows=None, members=None, device) -> FusedMLP:
    """The whole MLP as one kernel (the builder of the JAX package's same
    name). ``precision``: ``"highest"``/``"contract"`` exact fp32,
    ``"high"`` bf16x3, ``"default"`` single-pass bf16; a fan-in ≤ 8 first
    layer is exact fp32 at every tier. ``tile_rows`` and ``members``: see
    :class:`FusedMLP`."""
    return FusedMLP(sizes, log_clamp_input=log_clamp_input, precision=precision,
                    reduce=reduce, tile_rows=tile_rows, members=members, device=device)


def make_fused_emulate(config, norm, *, precision="highest", tile_rows=None,
                       device) -> FusedMLP:
    """Fused flagship inference: ``(params, raw) → signals`` in mK on
    unfolded ``params`` (the builder of the JAX package's same name;
    same contract as ``DirectEmulator.predict_fn``)."""
    if config.activation != "relu":
        raise NotImplementedError(
            "K1 hard-codes ReLU hidden layers; got "
            f"activation={config.activation!r}"
        )
    return FusedMLP(config.mlp().sizes, log_clamp_input=True, precision=precision,
                    tile_rows=tile_rows, device=device,
                    fold=functools.partial(fold_emulator_constants, norm=norm))
