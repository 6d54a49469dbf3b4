"""The fused likelihood kernels, their plain PyTorch versions, and the
wrappers that pick between them by the input's device.

* K2 (plain :func:`loglik_gram_reference`) — the port of
  ``tpu21cmvae/ops/pallas/fused_loglik.py::make_fused_loglik_gram``: the
  gram-form value, which the gradient-free samplers call once per
  proposal batch.
* K3 (plain :func:`loglik_grad_gram_reference`) — the port of
  ``make_fused_loglik_grad_gram``: the value and its gradient, the HMC
  inner loop.
* :func:`make_fused_loglik` — the direct-method likelihood, K1 with its
  ``sumsq`` tail (:mod:`tpu21cmvae_torch.ops.kernels.fused_mlp`).

K2 and K3 read the same :class:`GramOperands`: the network folded with
``ops/fold.py::gram_fold`` (normalizer, the observation and the noise
spec's whitening, a per-bin ``1/σ`` or a foreground-marginalized spec's
dense ``R``, all in the weights; the 451-wide output layer collapsed into
``G = WWᵀ``, ``u``, ``c``) and split for the value and backward tiers.
The kernels see the same widths under either noise spec.
Each routes by tier (:func:`gram_on_tensor_cores`, :func:`gram_mixed`,
:func:`gram_reverse`): at the bf16 tiers both run
``csrc/fused_gram_mma.cu`` on the tensor cores (K2 is its forward alone),
from operands :func:`pack_gram_operands` packed once per model into bf16
``mma`` fragments, and K3 at (bf16x3, bf16) on one model at a batch
that fills the card (:func:`k3_batch_route`) ``csrc/fused_gram_tall.cu``: 64-row tiles on
``wgmma``, the weights streamed through a ring of shared memory by bulk
copies from the stream :func:`pack_tall` packs once per model, each
weight byte read from L2 once per 64 rows rather than per 16 (its shared
memory :func:`tall_plan`); at the fp32 tier K2 runs
``csrc/fused_loglik_gram.cu``, register-tiled on the CUDA cores from the
fp32 slabs of :func:`pack_gram_slabs` (``csrc/tile_f32.cuh``), and K3 at
(fp32, fp32) ``csrc/fused_loglik_grad_gram_f32.cu``, the same forward and
the backward as more layers of one slab stream
(:func:`pack_grad_gram_slabs`), at a tile height picked per call
(:func:`grad_f32_rows`). K3 at an fp32 value tier with a bf16 backward
tier runs ``csrc/fused_gram_mixed.cu``: the same forward from K2's slabs,
the backward on the tensor cores from the fragments of
:func:`pack_grad_fragments`, at 32 or 16 rows picked per call
(:meth:`FusedLoglikGradGram.rows_for`). The reverse pairs (a bf16 value
tier with an fp32 backward) run ``csrc/fused_gram_mma.cu`` too: its
tensor-core forward (the value is the tensor-core K2's bit for bit), then
the backward register-tiled on the CUDA cores over the fp32 slabs of
:func:`pack_backward_slabs`. Every network, at every K2 tier and K3
pair, that the kernel its tiers pick cannot hold, by shared memory or by
depth, or whose first layer has a fan-in above 8 (a dense first layer,
a tier matmul as in JAX's kernels), runs
``csrc/fused_loglik_grad_gram.cu`` (the wrappers' ``wide``):
the program of :mod:`~tpu21cmvae_torch.ops.kernels.wide`, which streams a
wide layer in 128-column chunks and keeps what shared memory cannot hold
in a workspace in device memory, allocated once per wrapper. The CUDA
kernels keep a row tile's activations on chip;
the plain versions do the same arithmetic — same folds, same hi/lo split,
same epilogue — in plain tensor operations.

Every wrapper here takes ``members=M`` (``_common.py``'s member axis): an
ensemble's stacked weights, each member folded and packed as one model's
are, all M run by one launch per call (JAX's vmap over ``pallas_call``),
``(M, B)`` values and ``(M, B, n_params)`` gradients; each member's ``c``
enters the epilogue as an ``(M, 1)`` tensor. The ``*_members_reference``
functions are their plain versions.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple, Optional

import torch

from tpu21cmvae_torch.ops.fold import (
    _log_clamp,
    _log_clamp_grad,
    fold_loglik_constants,
    gram_fold,
    noise_log_norm,
    noise_scale,
    obs_tensor,
    prepare_operand,
    resolve_tier,
    tier_matmul,
)
from tpu21cmvae_torch.ops.kernels._common import (
    F32_TILE_ROWS,
    GRAD_RING,
    MASK_COL_BYTES,
    MAX_LAYERS,
    MAX_SHARED_BYTES,
    RED_FLOATS,
    SLAB_N,
    TIER_CODE,
    OperandCache,
    Slabs,
    cached_args,
    check_members,
    check_rows,
    check_tile_rows,
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
    tile_stride,
)
from tpu21cmvae_torch.ops.kernels.fused_mlp import (
    MMA_TIERS,
    WARPS_PER_BLOCK,
    FusedMLP,
    _pad16,
    pack_frags,
    pack_mma_operands,
)
from tpu21cmvae_torch.ops.kernels import wide
from tpu21cmvae_torch.ops.kernels.wide import (
    WidePlan,
    pack_wide_frags,
    pack_wide_slabs,
    plan_bytes,
    program_table,
    wide_ints,
    wide_plan,
    wide_tail,
)
from tpu21cmvae_torch.ops.mlp import SKINNY_DENSE_MAX_IN, fused_skinny_dense
from tpu21cmvae_torch.utils.profiling import WRAPPERS, count, recording_open, span


class GramPacked(NamedTuple):
    """What ``fused_gram_mma.cu`` reads besides the skinny layer's exact
    ``w0``, ``b0`` (:func:`pack_gram_operands`): per trunk layer i ≥ 1
    the packed B fragments ``w`` at the value tier and the bias ``b``
    zero-padded to 16, and (K3) ``wt``, the fragments of ``W_iᵀ`` at the
    backward tier; ``g``, G's fragments at the value tier; ``u`` padded.
    For ``fused_gram_mixed.cu`` only ``wt`` is packed: ``w`` and ``b``
    are empty, ``g`` and ``u`` None. At a reverse pair (an fp32
    backward) ``wt`` is empty."""

    w: tuple
    b: tuple
    wt: tuple
    g: torch.Tensor
    u: torch.Tensor


@dataclasses.dataclass(frozen=True)
class GramOperands:
    """Everything K2, K3 and their plain versions read besides the input
    rows.

    ``w0``/``b0``: the first layer, exact fp32 where it is skinny; where
    it is ``dense`` (fan-in above 8) ``w0`` prepared at ``tier`` and
    ``w0t``, its transpose, at ``grad_tier`` (K3). ``w``/``b``: the
    other trunk layers, ``w`` prepared at ``tier``
    (:func:`~tpu21cmvae_torch.ops.fold.prepare_operand`); ``wt``: the same
    weights transposed, prepared at ``grad_tier`` — empty, and
    ``grad_tier`` None, for the value-only K2. ``g``: ``G`` at ``tier``.
    ``u``, ``c``, ``log_norm``: the rest of the gram form. ``packed``:
    the same operands as ``fused_gram_mma.cu`` reads them where the
    tiers run on the tensor cores (at a reverse pair, the forward's
    alone), and the backward's fragments alone where K3 runs
    ``fused_gram_mixed.cu``; else None. ``slabs``: the operands as a
    register-tiled fp32 pass streams them where it runs: K2's
    (:func:`pack_gram_slabs`, ``fused_loglik_gram.cu``, and
    ``fused_gram_mixed.cu``'s forward), K3's
    (:func:`pack_grad_gram_slabs`, ``fused_loglik_grad_gram_f32.cu``) or
    the reverse pairs' backward (:func:`pack_backward_slabs`'s ``w``;
    ``b`` empty) or the wide route's stream and biases
    (:func:`~tpu21cmvae_torch.ops.kernels.wide.pack_wide_slabs`), else
    None. ``program``: the wide route's op table
    (:func:`~tpu21cmvae_torch.ops.kernels.wide.program_table`), else
    None; ``frags``: its fragment buffer
    (:func:`~tpu21cmvae_torch.ops.kernels.wide.pack_wide_frags`; None
    where no op runs on the tensor cores). ``tall``: the weight stream of
    ``fused_gram_tall.cu`` (:func:`pack_tall`) where a K3 wrapper takes
    that kernel for large batches, else None. ``members``: M where
    every tensor is M members' stacked on a leading axis (``c`` as ``(M,
    1)``), else None.
    """

    tier: str
    grad_tier: Optional[str]
    w0: torch.Tensor
    b0: torch.Tensor
    w: tuple
    b: tuple
    wt: tuple
    g: torch.Tensor
    u: torch.Tensor
    c: torch.Tensor
    log_norm: float
    packed: Optional[GramPacked] = None
    slabs: Optional[Slabs] = None
    program: Optional[torch.Tensor] = None
    frags: Optional[torch.Tensor] = None
    members: Optional[int] = None
    dense: bool = False
    w0t: Optional[torch.Tensor] = None
    tall: Optional[torch.Tensor] = None

    @property
    def widths(self) -> tuple:
        """``(n_in, *trunk widths)``."""
        k, n = self.w0.shape[-2:]
        if self.dense and self.tier == "bf16x3":  # [w_hi; w_lo; w_hi]
            k //= 3
        return (k, n, *(b.shape[-1] for b in self.b))


def gram_operands(params, norm, obs, scale, log_norm, tier,
                  grad_tier=None) -> GramOperands:
    """Fold ``params`` (exact fp32) and split them for the tiers; with
    ``grad_tier`` None the transposed backward operands are not built. A
    first layer of fan-in above 8 is a tier layer like the others (JAX's
    ``layer_mode_plan``)."""
    trunk, G, u, c = gram_fold(params, norm, obs, scale)
    first, *rest = trunk
    dense = first["w"].shape[0] > SKINNY_DENSE_MAX_IN
    return GramOperands(
        tier=tier,
        grad_tier=grad_tier,
        w0=prepare_operand(first["w"], tier) if dense else first["w"].contiguous(),
        b0=first["b"].contiguous(),
        w=tuple(prepare_operand(layer["w"], tier) for layer in rest),
        b=tuple(layer["b"].contiguous() for layer in rest),
        wt=() if grad_tier is None else tuple(
            prepare_operand(layer["w"].T, grad_tier) for layer in rest
        ),
        g=prepare_operand(G, tier),
        u=u.contiguous(),
        c=c,
        log_norm=log_norm,
        dense=dense,
        w0t=prepare_operand(first["w"].T, grad_tier) if dense and grad_tier else None,
    )


def gram_on_tensor_cores(tier: str, grad_tier: Optional[str] = None) -> bool:
    """Whether K3 at (``tier``, ``grad_tier``), or K2 at ``tier``
    (``grad_tier`` None), runs ``fused_gram_mma.cu``: every tier it runs
    is bf16 or bf16x3."""
    return tier in MMA_TIERS and (grad_tier is None or grad_tier in MMA_TIERS)


def gram_mixed(tier: str, grad_tier: Optional[str]) -> bool:
    """Whether K3 at (``tier``, ``grad_tier``) runs
    ``fused_gram_mixed.cu``: an fp32 value tier with a bf16 or bf16x3
    backward."""
    return tier == "f32" and grad_tier in MMA_TIERS


def gram_reverse(tier: str, grad_tier: Optional[str]) -> bool:
    """Whether K3 at (``tier``, ``grad_tier``) is a reverse pair: a bf16
    or bf16x3 value tier with an fp32 backward. Where the network fits
    (:func:`grad_reverse_bytes`) it runs ``fused_gram_mma.cu``'s
    tensor-core forward with an fp32 backward
    (:attr:`FusedLoglikGradGram.reverse`)."""
    return tier in MMA_TIERS and grad_tier == "f32"


def pack_grad_fragments(ops: GramOperands) -> tuple:
    """The backward's ``W_iᵀ`` for i = 1 … n−1 at ``ops.grad_tier`` as
    ``mma`` B fragments
    (:func:`~tpu21cmvae_torch.ops.kernels.fused_mlp.pack_mma_operands`,
    zero-padded to multiples of 16): what ``fused_gram_mma.cu`` and
    ``fused_gram_mixed.cu`` read for the backward."""
    return tuple(pack_mma_operands(op, op.new_zeros(op.shape[1]), ops.grad_tier)[0]
                 for op in ops.wt)


def pack_gram_operands(ops: GramOperands) -> GramPacked:
    """``ops``' tier operands as ``fused_gram_mma.cu`` reads them
    (:func:`~tpu21cmvae_torch.ops.kernels.fused_mlp.pack_mma_operands`):
    the trunk layers and G at ``ops.tier``, the transposed backward
    weights at ``ops.grad_tier`` where it is a bf16 tier
    (:func:`pack_grad_fragments`; none at an fp32 backward), zero-padded
    to multiples of 16."""
    layers = [pack_mma_operands(w, b, ops.tier) for w, b in zip(ops.w, ops.b)]
    h = ops.u.shape[0]
    return GramPacked(
        w=tuple(w for w, _ in layers),
        b=tuple(b for _, b in layers),
        wt=pack_grad_fragments(ops) if ops.grad_tier in MMA_TIERS else (),
        g=pack_mma_operands(ops.g, ops.u.new_zeros(h), ops.tier)[0],
        u=torch.nn.functional.pad(ops.u, (0, _pad16(h) - h)),
    )


def pack_gram_slabs(ops: GramOperands) -> Slabs:
    """K2's fp32 operands as ``fused_loglik_gram.cu`` streams them
    (:func:`~tpu21cmvae_torch.ops.kernels._common.pack_slabs`): trunk
    layers 1 … n−1, then ``G`` with ``u`` in its bias slot (the gram
    head adds no bias; its epilogue reads ``u`` there)."""
    return pack_slabs([*zip(ops.w, ops.b), (ops.g, ops.u)])


def pack_backward_slabs(ops: GramOperands) -> Slabs:
    """The backward's ``W_iᵀ`` (fp32) for i = n−1 … 1 as the
    register-tiled kernels stream them
    (:func:`~tpu21cmvae_torch.ops.kernels._common.pack_slabs`), each with
    a zero bias no kernel reads; empty, on the operands' device, for a
    trunk of the skinny layer alone."""
    if not ops.wt:
        return Slabs(w=ops.w0.new_zeros(0), b=ops.w0.new_zeros(0))
    return pack_slabs([(wt, wt.new_zeros(wt.shape[1])) for wt in reversed(ops.wt)])


def ops_plan(ops: GramOperands, budget: int = MAX_SHARED_BYTES) -> WidePlan:
    """The wide route's plan of ``ops``' widths and tiers (K2 where
    ``ops.grad_tier`` is None) under a shared-memory ``budget``."""
    return wide_route_plan(ops.widths, ops.tier, ops.grad_tier, budget)


def _wide_matrix(ops: GramOperands):
    """``(name, layer) → (w, tier)``: the prepared operands of the wide
    route's plan (:mod:`~tpu21cmvae_torch.ops.kernels.wide`): ``"w"``
    trunk layer i (0: a dense first layer), ``"wt"`` its transpose at
    ``grad_tier``, ``"g"`` G."""

    def matrix(name, layer):
        if name == "g":
            return ops.g, ops.tier
        if name == "w":
            return (ops.w0 if layer == 0 else ops.w[layer - 1]), ops.tier
        return (ops.w0t if layer == 0 else ops.wt[layer - 1]), ops.grad_tier

    return matrix


def pack_wide_operands(ops: GramOperands, budget: int = MAX_SHARED_BYTES) -> GramOperands:
    """``ops`` (K2 at any tier, K3 at any pair) packed for the wide route
    ``fused_loglik_grad_gram.cu`` under a shared-memory ``budget``: its
    program, its fp32 stream with the biases (a dense first layer's
    first) and its fragment buffer
    (:mod:`~tpu21cmvae_torch.ops.kernels.wide`); a launch of them takes
    the same budget's plan (:func:`ops_plan`, :class:`WideLaunch`)."""
    plan = ops_plan(ops, budget)
    matrix = _wide_matrix(ops)
    biases = [*([ops.b0] if ops.dense else []), *ops.b, ops.u]
    return dataclasses.replace(
        ops, slabs=pack_wide_slabs(matrix, biases, plan), packed=None,
        frags=pack_wide_frags(matrix, plan, pack_frags),
        program=program_table(plan).to(ops.b0.device))


def pack_grad_gram_slabs(ops: GramOperands) -> Slabs:
    """K3's fp32 operands as ``fused_loglik_grad_gram_f32.cu`` streams
    them: K2's stream (:func:`pack_gram_slabs`), then the backward's
    (:func:`pack_backward_slabs`)."""
    forward, backward = pack_gram_slabs(ops), pack_backward_slabs(ops)
    return Slabs(w=torch.cat([forward.w, backward.w]), b=torch.cat([forward.b, backward.b]))


def _value(ops: GramOperands, quad):
    """``−½·(quad + c) + log_norm``: the value from the kernels' quad."""
    return -0.5 * (quad + ops.c) + ops.log_norm


def _gram_forward(ops: GramOperands, x: torch.Tensor):
    """The trunk activations, ``h@G`` and ``quad`` per row; a dense first
    layer a tier matmul, as JAX's kernels run it."""
    xl = _log_clamp(x)
    h = torch.relu(tier_matmul(xl, ops.w0, ops.tier) + ops.b0 if ops.dense
                   else fused_skinny_dense(xl, ops.w0, ops.b0))
    acts = [h]
    for w, b in zip(ops.w, ops.b):
        h = torch.relu(tier_matmul(h, w, ops.tier) + b)
        acts.append(h)
    g1 = tier_matmul(h, ops.g, ops.tier)
    return acts, g1, torch.sum((g1 + 2.0 * ops.u) * h, dim=-1)


def loglik_gram_reference(ops: GramOperands, x: torch.Tensor) -> torch.Tensor:
    """K2 in plain PyTorch: ``logL (B,)`` for raw rows ``x`` (B, n_in)
    float32 on ``ops``' device."""
    return _value(ops, _gram_forward(ops, x)[2])


def loglik_grad_gram_reference(ops: GramOperands, x: torch.Tensor):
    """K3 in plain PyTorch: ``(logL (B,), dlogL/dx (B, n_in))`` for raw
    rows ``x`` (B, n_in) float32 on ``ops``' device."""
    acts, g1, quad = _gram_forward(ops, x)
    # ½·dquad/dh = h@G + u: G is symmetric, so the forward's product is reused
    e = g1 + ops.u
    for i in range(len(acts) - 1, 0, -1):
        e = torch.where(acts[i] > 0.0, e, 0.0)
        e = tier_matmul(e, ops.wt[i - 1], ops.grad_tier)
    e = torch.where(acts[0] > 0.0, e, 0.0)
    # a dense first layer at the backward tier (JAX's _dot_refs); the skinny one exact
    e = tier_matmul(e, ops.w0t, ops.grad_tier) if ops.dense else e @ ops.w0.T
    return _value(ops, quad), -(_log_clamp_grad(x) * e)


def loglik_gram_members_reference(ops: GramOperands, x: torch.Tensor) -> torch.Tensor:
    """The member-batched K2 in plain PyTorch: :func:`loglik_gram_reference`
    of each member of stacked ``ops``, read out of the stacked buffers at
    its member stride: ``logL (M, B)``."""
    return per_member(loglik_gram_reference, ops, x)


def loglik_grad_gram_members_reference(ops: GramOperands, x: torch.Tensor):
    """The member-batched K3 in plain PyTorch
    (:func:`loglik_grad_gram_reference` per member, as
    :func:`loglik_gram_members_reference`): ``(logL (M, B), dlogL/dx (M,
    B, n_in))``."""
    return per_member(loglik_grad_gram_reference, ops, x)


def _kernel(ops: GramOperands, k3: bool, rows: Optional[int] = None,
            workspace: Optional[torch.Tensor] = None, ctas: int = 0,
            plan: Optional[WidePlan] = None):
    """The C entry point of the kernel ``ops``' tiers run
    (:func:`gram_on_tensor_cores`, :func:`gram_mixed`,
    :func:`gram_reverse`, and the wide route where ``ops`` carry its
    program), its operand pointers, and the arguments after them: the
    tier codes (at a reverse pair the value tier's alone, where its
    operands were packed), or the register-tiled kernels' tile height
    ``rows`` (K2 at fp32; K3 at (fp32, fp32) where its stream was packed;
    K3 at (fp32, bf16 tier), after the backward's tier code, where its
    operands were packed); the wide route the A-chunk tile's parts, the
    height and the sizes of ``plan``, the one its operands were packed
    under (default: :func:`ops_plan`'s), then the CTAs of its persistent
    grid and the ``workspace``, where the plan spills
    (:func:`~tpu21cmvae_torch.ops.kernels.wide.wide_tail`)."""
    tiers = (ops.tier, ops.grad_tier) if k3 else (ops.tier,)
    tensors = [ops.w0, ops.b0]
    if ops.program is not None:  # the wide route: its program, stream and fragments
        plan = plan or ops_plan(ops)
        skinny = [None, None] if ops.dense else tensors  # a dense layer 0 is in the stream
        return ("k3_fused_loglik_grad_gram" if k3 else "k2_fused_loglik_gram_wide",
                [*skinny, ops.slabs.b, ops.slabs.w, ops.program, ops.frags],
                wide_tail(plan, rows, ops.members, workspace, ctas))
    if gram_on_tensor_cores(*tiers):
        p = ops.packed
        for i, (w, b) in enumerate(zip(p.w, p.b)):
            tensors += [w, b, p.wt[i]] if k3 else [w, b]
        entry = "k3_fused_loglik_grad_gram_mma" if k3 else "k2_fused_loglik_gram_mma"
        return entry, [*tensors, p.g, p.u], [TIER_CODE[t] for t in tiers]
    if not k3:  # fused_loglik_gram.cu runs the fp32 tier alone
        return "k2_fused_loglik_gram", [*tensors, *ops.slabs], [rows]
    if gram_mixed(*tiers) and ops.slabs is not None:  # fp32 forward, tensor-core backward
        return ("k3_fused_loglik_grad_gram_mixed", [*tensors, *ops.slabs, *ops.packed.wt],
                [TIER_CODE[ops.grad_tier], rows])
    if gram_reverse(*tiers) and ops.packed is not None:  # tensor-core forward, fp32 backward
        p = ops.packed
        for w, b in zip(p.w, p.b):
            tensors += [w, b]
        return ("k3_fused_loglik_grad_gram_reverse", [*tensors, p.g, p.u, ops.slabs.w],
                [TIER_CODE[ops.tier]])
    if ops.slabs is not None:  # (fp32, fp32), register-tiled
        return "k3_fused_loglik_grad_gram_f32", [*tensors, *ops.slabs], [rows]
    raise ValueError(f"K3 operands at {tiers} carry no kernel's packing")


def _launch_args(ops: GramOperands, k3: bool, rows: Optional[int],
                 workspace: Optional[torch.Tensor] = None, ctas: int = 0,
                 plan: Optional[WidePlan] = None) -> tuple:
    """The C entry of ``ops``' route (:func:`_kernel`) and its arguments
    after the row count: the trunk's layer count and widths, the operand
    pointers, their member strides, the member count and the entry's
    ints; built once per fold, height, workspace and wide plan
    (:func:`cached_args`)."""

    def make():
        entry, tensors, ints = _kernel(ops, k3=k3, rows=rows, workspace=workspace, ctas=ctas,
                                       plan=plan)
        widths = (ctypes.c_int * len(ops.widths))(*ops.widths)
        return entry, (len(ops.widths) - 1, widths, pointers(tensors),
                       member_strides(tensors, ops.members), ops.members or 1, *ints)

    key = (k3, rows, None if workspace is None else workspace.data_ptr(), ctas,
           None if plan is None else (plan.a_parts, *wide_ints(plan)))
    return cached_args(ops, key, make)


def _batch(ops: GramOperands, *shape) -> tuple:
    """``shape``, after the member axis of stacked ``ops``."""
    return shape if ops.members is None else (ops.members, *shape)


def _loglik_gram_cuda(ops: GramOperands, x: torch.Tensor, rows: int,
                      workspace: Optional[torch.Tensor] = None, ctas: int = 0,
                      plan: Optional[WidePlan] = None) -> torch.Tensor:
    """Launch K2 on PyTorch's current stream (no synchronisation), one
    launch for every member of stacked ``ops``; ``rows``:
    ``fused_loglik_gram.cu``'s or the wide route's tile height;
    ``workspace``, ``ctas`` and ``plan``: the wide route's
    (:class:`WideLaunch`)."""
    quad = torch.empty(_batch(ops, x.shape[0]), dtype=torch.float32, device=x.device)
    if x.shape[0]:
        entry, args = _launch_args(ops, False, rows, workspace, ctas, plan)
        launch("K2", entry, x, x.data_ptr(), quad.data_ptr(), x.shape[0], *args)
    return _value(ops, quad)


def _loglik_grad_gram_cuda(ops: GramOperands, x: torch.Tensor, rows: Optional[int] = None,
                           workspace: Optional[torch.Tensor] = None, ctas: int = 0,
                           plan: Optional[WidePlan] = None):
    """Launch K3 on PyTorch's current stream (no synchronisation), one
    launch for every member of stacked ``ops``; ``rows``: the tile height
    of ``fused_loglik_grad_gram_f32.cu``, ``fused_gram_mixed.cu`` or
    ``fused_loglik_grad_gram.cu`` (None on the other routes);
    ``workspace``, ``ctas`` and ``plan``: the wide route's
    (:class:`WideLaunch`)."""
    quad = torch.empty(_batch(ops, x.shape[0]), dtype=torch.float32, device=x.device)
    dx = torch.empty(_batch(ops, *x.shape), dtype=torch.float32, device=x.device)
    if x.shape[0]:
        entry, args = _launch_args(ops, True, rows, workspace, ctas, plan)
        launch("K3", entry, x, x.data_ptr(), quad.data_ptr(), dx.data_ptr(), x.shape[0], *args)
    return _value(ops, quad), -dx


def _tall_args(ops: GramOperands, plan: TallPlan, ctas: int) -> tuple:
    """The arguments of ``k3_fused_loglik_grad_gram_tall`` after the row
    count: the trunk's layer count and widths, the pointers of ``w0``,
    ``b0``, each padded bias, ``u`` and the stream (:func:`pack_tall`),
    their member strides (zero: one model), one member, the tier codes,
    ``plan`` as ints (the arena's bytes, the ring's slots, each stage's
    input then output offsets) and the persistent grid's ``ctas``; built
    once per fold and grid (:func:`cached_args`)."""

    def make():
        p = ops.packed
        tensors = [ops.w0, ops.b0, *p.b, p.u, ops.tall]
        ints = (plan.arena, plan.ring, *plan.in_off, *plan.out_off)
        widths = (ctypes.c_int * len(ops.widths))(*ops.widths)
        return (len(ops.widths) - 1, widths, pointers(tensors), member_strides(tensors, None), 1,
                TIER_CODE[ops.tier], TIER_CODE[ops.grad_tier], (ctypes.c_int * len(ints))(*ints),
                ctas)

    return cached_args(ops, ("tall", ctas), make)


def _loglik_grad_gram_tall_cuda(ops: GramOperands, x: torch.Tensor, plan: TallPlan, ctas: int):
    """Launch K3 on ``fused_gram_tall.cu`` on PyTorch's current stream (no
    synchronisation): one model's operands with their :func:`pack_tall`
    stream, a non-empty batch, ``plan`` the operands' :func:`tall_plan`,
    a persistent grid of at most ``ctas`` CTAs."""
    quad = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    dx = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    launch("K3", "k3_fused_loglik_grad_gram_tall", x, x.data_ptr(), quad.data_ptr(),
           dx.data_ptr(), x.shape[0], *_tall_args(ops, plan, ctas))
    return _value(ops, quad), -dx


class WideLaunch(wide.WideLaunch):
    """:class:`~tpu21cmvae_torch.ops.kernels.wide.WideLaunch` of K3's
    operands where ``k3``, else K2's."""

    def __init__(self, plan: WidePlan, k3: bool, sm_count: int, device, members=None):
        super().__init__(plan, _loglik_grad_gram_cuda if k3 else _loglik_gram_cuda, sm_count,
                         device, members)
        self.k3 = k3


def _gram_mma_bytes(widths, tier: str, grad_tier: Optional[str]) -> int:
    """Dynamic shared memory of one ``fused_gram_mma.cu`` block: two bf16
    A buffers (hi and lo where either tier is bf16x3) with rows padded to
    the widest padded trunk width + 8, the fp32 tile of ``h`` (K3: and of
    layer 0's backward signal), K3's mask words (one per padded column of
    activations 0 … n−2), the fp32 input tile and the per-warp quad
    partials."""
    rows = 16  # kGramRows in csrc/fused_gram_mma.cu
    parts = 2 if "bf16x3" in (tier, grad_tier) else 1
    stride = max(_pad16(w) for w in widths[1:]) + 8
    f32_cols = _pad16(max(widths[-1], widths[1] if grad_tier else 0)) + 8
    mask_words = sum(_pad16(w) for w in widths[1:-1]) if grad_tier else 0
    return (2 * 2 * parts * rows * stride + 4 * rows * f32_cols + 4 * mask_words
            + 4 * rows * (widths[0] + WARPS_PER_BLOCK))


def grad_f32_bytes(widths, rows: int) -> int:
    """Dynamic shared memory of one ``fused_loglik_grad_gram_f32.cu``
    block of ``rows`` rows
    (:func:`~tpu21cmvae_torch.ops.kernels._common.f32_tile_bytes`): K2's
    tiles and partials, K3's slab ring, and the mask bits of activations
    0 … n−2, padded columns included."""
    return f32_tile_bytes(rows, widths[0], max(padk(w) for w in widths[1:]),
                          mask_cols=sum(padk(w) for w in widths[1:-1]))


def grad_f32_heights(widths) -> tuple:
    """The tile heights, tallest first, at which trunk ``widths`` fit
    ``fused_loglik_grad_gram_f32.cu``'s shared memory."""
    return tuple(r for r in F32_TILE_ROWS if grad_f32_bytes(widths, r) <= MAX_SHARED_BYTES)


# csrc/fused_gram_mixed.cu: the tile heights it is built for, and
# sizeof(MixedNet), the static shared memory its CTA adds to the dynamic
MIXED_TILE_ROWS = (32, 16)
MIXED_NET_BYTES = 256


def grad_mixed_bytes(widths, rows: int, grad_tier: str) -> int:
    """Shared memory of one ``fused_gram_mixed.cu`` block of ``rows``
    rows at backward tier ``grad_tier`` (``launch_mixed`` there): the
    mask bits of activations 0 … n−2 and the per-row partials, as the
    fp32 K3 keeps them; a region that holds the fp32 ``e`` (a k-major
    tile as wide as the widest trunk width padded to 32) and later a
    bf16 A tile (hi and lo at bf16x3, rows padded to the widest trunk
    width padded to 16, + 8); a region that holds the forward's other
    tile, its slab ring (``GRAD_RING``) and the input tile, and later the
    other A tile; and the static copy of the operand struct."""
    s = tile_stride(rows)
    tile = 4 * s * max(padk(w) for w in widths[1:])
    parts = 2 if grad_tier == "bf16x3" else 1
    a = 2 * parts * rows * (max(_pad16(w) for w in widths[1:]) + 8)
    depth, slots = GRAD_RING[rows]
    forward = tile + 4 * (slots * depth * SLAB_N + s * widths[0])
    masks = MASK_COL_BYTES[rows] * sum(padk(w) for w in widths[1:-1])
    return masks + 4 * RED_FLOATS + max(tile, a) + max(forward, a) + MIXED_NET_BYTES


def grad_mixed_heights(widths, grad_tier: str) -> tuple:
    """The tile heights, tallest first, at which trunk ``widths`` fit
    ``fused_gram_mixed.cu``'s shared memory at ``grad_tier``."""
    return tuple(r for r in MIXED_TILE_ROWS
                 if grad_mixed_bytes(widths, r, grad_tier) <= MAX_SHARED_BYTES)


# sizeof(GramReverseNet) in csrc/fused_gram_mma.cu: the static shared
# memory a reverse-mode CTA adds to the dynamic
REVERSE_NET_BYTES = 552


def grad_reverse_bytes(widths, tier: str) -> int:
    """Shared memory of one ``fused_gram_mma.cu`` block at a reverse pair
    (value tier ``tier``, an fp32 backward; ``launch_gram_mma`` there):
    the mask words of activations 0 … n−2 (one per column padded to 32)
    and the fp32 ``e`` (a k-major 16-row tile as wide as the widest trunk
    width padded to 32), apart; then the larger of the forward's tiles
    (:func:`_gram_mma_bytes` of K2 at ``tier``: bf16 A tiles, the fp32
    ``h``, the input tile and the quad partials) and the backward's other
    fp32 tile with its slab ring (``GRAD_RING[16]``); and the static copy
    of the operand struct."""
    rows = 16  # kGramRows
    tile = 4 * tile_stride(rows) * max(padk(w) for w in widths[1:])
    masks = 4 * sum(padk(w) for w in widths[1:-1])
    depth, slots = GRAD_RING[rows]
    backward = tile + 4 * slots * depth * SLAB_N
    return (masks + tile + max(_gram_mma_bytes(widths, tier, None), backward)
            + REVERSE_NET_BYTES)


def grad_f32_rows(widths, n_rows: Optional[int] = None, sm_count: Optional[int] = None,
                  forced: Optional[int] = None) -> Optional[int]:
    """The tile height ``fused_loglik_grad_gram_f32.cu`` runs a batch of
    ``n_rows`` rows of trunk ``widths`` at on a card of ``sm_count`` SMs:
    ``forced`` if given, else :func:`pick_grad_rows` over the heights
    that fit (:func:`grad_f32_heights`); None where none fits."""
    if check_tile_rows(forced) is not None:
        return forced
    heights = grad_f32_heights(widths)
    return pick_grad_rows(heights, n_rows, sm_count) if heights else None


def k3_route(widths, tier: str, grad_tier: str, tile_rows: Optional[int] = None) -> str:
    """The kernel K3 at (``tier``, ``grad_tier``) runs trunk ``widths``
    on: ``"mma"`` (``fused_gram_mma.cu``, every tier bf16 or bf16x3),
    ``"reverse"`` (its reverse mode: a bf16 value tier, an fp32
    backward), ``"mixed"`` (``fused_gram_mixed.cu``: an fp32 value tier, a
    bf16 backward), ``"f32"`` (``fused_loglik_grad_gram_f32.cu``: fp32,
    fp32), each where it holds the network at some height and depth (a
    forced ``tile_rows`` keeps the register-tiled and mixed kernels,
    which then refuse a height that does not fit); else ``"wide"``
    (``fused_loglik_grad_gram.cu``), which alone takes a dense first
    layer (fan-in above 8)."""
    if len(widths) - 1 > MAX_LAYERS or widths[0] > SKINNY_DENSE_MAX_IN:
        return "wide"
    if gram_on_tensor_cores(tier, grad_tier):
        return "mma" if _gram_mma_bytes(widths, tier, grad_tier) <= MAX_SHARED_BYTES else "wide"
    if gram_reverse(tier, grad_tier):
        return "reverse" if grad_reverse_bytes(widths, tier) <= MAX_SHARED_BYTES else "wide"
    if gram_mixed(tier, grad_tier):
        return "mixed" if tile_rows is not None or grad_mixed_heights(widths, grad_tier) else "wide"
    return "f32" if tile_rows is not None or grad_f32_heights(widths) else "wide"


def k2_route(widths, tier: str, tile_rows: Optional[int] = None) -> str:
    """The kernel K2 at ``tier`` runs trunk ``widths`` on: ``"mma"``
    (``fused_gram_mma.cu``, bf16 and bf16x3), ``"f32"``
    (``fused_loglik_gram.cu``; a forced ``tile_rows`` keeps it, which then
    refuses a height that does not fit), each where it holds the network;
    else ``"wide"`` (``fused_loglik_grad_gram.cu``'s value-only
    program), which alone takes a dense first layer (fan-in above 8)."""
    if len(widths) - 1 > MAX_LAYERS or widths[0] > SKINNY_DENSE_MAX_IN:
        return "wide"
    if gram_on_tensor_cores(tier):
        return "mma" if _gram_mma_bytes(widths, tier, None) <= MAX_SHARED_BYTES else "wide"
    fits = f32_tile_bytes(gram_f32_rows(widths), widths[0],
                          max(padk(w) for w in widths[1:])) <= MAX_SHARED_BYTES
    return "f32" if tile_rows is not None or fits else "wide"


def wide_route_plan(widths, tier: str, grad_tier: Optional[str],
                    budget: int = MAX_SHARED_BYTES) -> WidePlan:
    """The wide route's plan of trunk ``widths`` for K3 at (``tier``,
    ``grad_tier``), or K2 at ``tier`` (``grad_tier`` None), under a
    shared-memory ``budget``."""
    grad = None if grad_tier is None else TIER_CODE[grad_tier]  # a tier's code is its parts
    return wide_plan(tuple(widths), TIER_CODE[tier], grad, budget)


def shared_bytes(widths, tier: str = "f32", grad_tier: str = "f32",
                 rows: Optional[int] = None) -> int:
    """Dynamic shared memory of one K3 block at (``tier``, ``grad_tier``)
    on the kernel :func:`k3_route` picks. ``fused_gram_mma.cu`` keeps
    bf16 tiles (:func:`_gram_mma_bytes`), and at a reverse pair (a bf16
    value tier, an fp32 backward) also the fp32 tiles of
    :func:`grad_reverse_bytes`; ``fused_loglik_grad_gram_f32.cu`` (fp32,
    fp32) k-major fp32 tiles of ``rows`` rows (:func:`grad_f32_bytes`;
    default: the tallest height that fits); ``fused_gram_mixed.cu`` (an
    fp32 value tier, a bf16 backward tier) the fp32 tiles and bf16 A tiles
    of :func:`grad_mixed_bytes` at ``rows`` (default: the tallest height
    that fits, else the shortest, which then refuses the network);
    ``fused_loglik_grad_gram.cu`` (every network those cannot hold) the
    tiles of its plan (:func:`~tpu21cmvae_torch.ops.kernels.wide.plan_bytes`)
    at ``rows`` (default: the tallest height that fits)."""
    route = k3_route(widths, tier, grad_tier, rows)
    if route == "mma":
        return _gram_mma_bytes(widths, tier, grad_tier)
    if route == "reverse":
        return grad_reverse_bytes(widths, tier)
    if route == "mixed":
        if rows is None:
            rows = (grad_mixed_heights(widths, grad_tier) or MIXED_TILE_ROWS[-1:])[0]
        return grad_mixed_bytes(widths, rows, grad_tier)
    if route == "f32":
        return grad_f32_bytes(widths, grad_f32_rows(widths, forced=rows))
    plan = wide_route_plan(widths, tier, grad_tier)
    return plan_bytes(plan, rows or plan.heights[0])


def gram_f32_rows(widths, forced: Optional[int] = None) -> int:
    """The tile height ``fused_loglik_gram.cu`` runs trunk ``widths`` at
    (:func:`~tpu21cmvae_torch.ops.kernels._common.f32_tile_rows`)."""
    return f32_tile_rows(widths[0], max(padk(w) for w in widths[1:]), forced)


def gram_shared_bytes(widths, tier: str = "f32", rows: Optional[int] = None) -> int:
    """Dynamic shared memory of one K2 block at ``tier`` on the kernel
    :func:`k2_route` picks. ``fused_loglik_gram.cu``
    (:func:`~tpu21cmvae_torch.ops.kernels._common.f32_tile_bytes`) keeps
    a ``rows``-row input tile, two fp32 activation buffers as wide as the
    widest trunk layer padded to 32 (they take turns as a layer's input
    and output; ``h@G`` stays in registers), the weight-slab ring and the
    per-row partials; ``rows`` defaults to the height
    :func:`gram_f32_rows` picks. ``fused_gram_mma.cu`` keeps bf16 tiles
    (:func:`_gram_mma_bytes`); ``fused_loglik_grad_gram.cu`` the tiles of
    its value-only plan at ``rows`` (default: the tallest that fits)."""
    route = k2_route(widths, tier, rows)
    if route == "mma":
        return _gram_mma_bytes(widths, tier, None)
    if route == "f32":
        return f32_tile_bytes(rows or gram_f32_rows(widths), widths[0],
                              max(padk(w) for w in widths[1:]))
    plan = wide_route_plan(widths, tier, None)
    return plan_bytes(plan, rows or plan.heights[0])


# csrc/fused_gram_tall.cu: K3 at the bf16 pairs on 64-row wgmma tiles
# (kRows), a layer's columns cut into chunks of at most 11 16-column units
# (kMaxUnits), one warpgroup's chunk and k-step a ring slot, 2 to 12 slots
# (kMinRing, kMaxRing). A K3 wrapper takes it for a batch of at least
# TALL_WAVES waves of 64-row tiles over the card's SMs
# (:func:`tall_crossover`): half a wave, the batch that fills one wave of
# fused_gram_mma.cu's 16-row CTAs at two an SM. On an H100 the two run
# 4096 rows in the same time and the tall kernel 6144 and more in half of
# it (PERF.md §6).
TALL_ROWS = 64
TALL_MAX_UNITS = 11
TALL_RING = (2, 12)
TALL_WAVES = 0.5
# the tier pairs it is built for: HMC's default; every other pair would
# add ~18 s of nvcc to the build's critical path (PERF.md §6)
TALL_PAIRS = (("bf16x3", "bf16"),)


class TallPlan(NamedTuple):
    """``fused_gram_tall.cu``'s shared memory for one network and tier
    pair (:func:`tall_plan`): the arena's bytes, the ring's slots and the
    bytes of one slot, each stage's input and output tile as byte offsets
    into the arena (stages: trunk layers 1 … n−1, the gram head, the
    backward's layers n−1 … 1), and the CTA's dynamic shared memory in
    all."""

    arena: int
    ring: int
    slot_bytes: int
    in_off: tuple
    out_off: tuple
    smem: int


def tall_split(n: int) -> tuple:
    """``split_of`` in ``csrc/fused_gram_tall.cu``: a layer of ``n``
    columns as ``(u0, u1, nch)``: 16-column units for the first and the
    second warpgroup (the first takes the odd one), each cut into ``nch``
    chunks of at most :data:`TALL_MAX_UNITS` units."""
    u = _pad16(n) // 16
    u0 = (u + 1) // 2
    return u0, u - u0, -(-u0 // TALL_MAX_UNITS)


def tall_part(u: int, nch: int, c: int) -> int:
    """``part``: the units of chunk ``c`` of ``u`` units cut into ``nch``;
    chunks 0 … c−1 hold ``c·u // nch`` of them."""
    return (c + 1) * u // nch - c * u // nch


def tall_chunks(n: int) -> list:
    """For each chunk of a layer of ``n`` columns, the ``(first column,
    width)`` of the first and of the second warpgroup's block, in the
    order the stream holds them."""
    u0, u1, nch = tall_split(n)
    return [((16 * (c * u0 // nch), 16 * tall_part(u0, nch, c)),
             (16 * (u0 + c * u1 // nch), 16 * tall_part(u1, nch, c))) for c in range(nch)]


def tall_stages(widths, tier: str, grad_tier: str) -> list:
    """``stage_of`` for every stage: ``(k, n, parts)`` of trunk layers 1
    … n−1 and the gram head at ``tier``, then the backward's layers n−1 …
    1 at ``grad_tier``."""
    pf, pb = TIER_CODE[tier], TIER_CODE[grad_tier]  # a bf16 tier's code is its parts
    n = len(widths) - 1
    return ([(widths[i], widths[i + 1], pf) for i in range(1, n)] + [(widths[n], widths[n], pf)]
            + [(widths[i + 1], widths[i], pb) for i in range(n - 1, 0, -1)])


def tall_block_bytes(parts: int, units: int) -> int:
    """``block_bytes``: one warpgroup's block of one k-step, ``parts``
    planes of 16 k rows by 16·``units`` columns of bf16."""
    return parts * units * 512


def _tall_arena(widths, pf: int, pb: int):
    """The arena's bytes and each stage's (input, output) byte offsets.
    Activation i (the skinny layer's is 1) lives at the low end for odd
    i, the high end for even; a layer's output at the other end from its
    input. The last trunk layer writes ``h`` in fp32; its A tile for the
    gram head goes where that layer's input was, and the gram head's
    output ``e`` beside it, ``h`` still live at the other end; each
    backward layer's output at the other end from its input, layer 1's
    ``e`` in fp32 (``fused_gram_tall.cu``, steps 3–6)."""
    n = len(widths) - 1
    hidden = widths[n]

    def a(w, parts):  # a 64-row bf16 tile, `parts` planes
        return 2 * TALL_ROWS * _pad16(w) * parts

    def f(w):  # a 64-row fp32 tile, rows padded by 8 floats
        return 4 * TALL_ROWS * (_pad16(w) + 8)

    def end(i):
        return i % 2  # 1: the low end

    # each stage's live buffers as (bytes, low end?, bytes before it from its end)
    stages = [[(a(widths[i], pf), end(i), 0),
               (f(hidden) if i == n - 1 else a(widths[i + 1], pf), end(i + 1), 0)]
              for i in range(1, n)]
    side = end(n - 1)
    gram_in = (a(hidden, pf), side, 0)
    e = (a(hidden, pb), side, gram_in[0])
    stages.append([gram_in, e, (f(hidden), end(n), 0)])
    for i in range(n - 1, 0, -1):
        out = (a(widths[i], pb) if i > 1 else f(widths[1]), 1 - e[1], 0)
        stages.append([e, out])
        e = out
    arena = max(sum(max((size + before for size, low, before in live if low == lo), default=0)
                    for lo in (0, 1)) for live in stages)

    def offset(buf):
        size, low, before = buf
        return before if low else arena - before - size

    return arena, [offset(live[0]) for live in stages], [offset(live[1]) for live in stages]


def tall_plan(widths, tier: str, grad_tier: str) -> Optional[TallPlan]:
    """``fused_gram_tall.cu``'s plan for trunk ``widths`` at (``tier``,
    ``grad_tier``), one of :data:`TALL_PAIRS`, mirrored by ``launch_tall``
    there:
    the ring's slots, then the arena, the mask words (8 bytes per padded
    column of activations 0 … n−2), the input tile, the two warpgroups'
    quad partials and the ring's barriers; as many slots as fit, up to
    twelve. None at another pair, where the network is not one the kernel
    takes (a skinny first layer, 2 to 8 trunk layers, each wider than 16,
    so that each warpgroup has a block in every chunk) or where fewer than
    two slots fit."""
    n = len(widths) - 1
    if not (2 <= n <= MAX_LAYERS and widths[0] <= SKINNY_DENSE_MAX_IN and min(widths[1:]) > 16
            and (tier, grad_tier) in TALL_PAIRS):
        return None
    pf, pb = TIER_CODE[tier], TIER_CODE[grad_tier]
    slot = max(tall_block_bytes(parts, width // 16)
               for _, n_out, parts in tall_stages(widths, tier, grad_tier)
               for chunk in tall_chunks(n_out) for _, width in chunk)
    arena, in_off, out_off = _tall_arena(widths, pf, pb)
    fixed = (arena + 8 * sum(_pad16(w) for w in widths[1:-1])
             + -(-4 * TALL_ROWS * widths[0] // 16) * 16 + 4 * 2 * TALL_ROWS)
    ring = min(TALL_RING[1], (MAX_SHARED_BYTES - fixed) // (slot + 16))
    if ring < TALL_RING[0]:
        return None
    return TallPlan(arena=arena, ring=ring, slot_bytes=slot, in_off=tuple(in_off),
                    out_off=tuple(out_off), smem=fixed + ring * (slot + 16))


def tall_crossover(sm_count: int) -> int:
    """The least batch a K3 wrapper runs on ``fused_gram_tall.cu``:
    :data:`TALL_WAVES` waves of 64-row tiles over the card's
    ``sm_count`` SMs."""
    return int(sm_count * TALL_ROWS * TALL_WAVES)


def k3_batch_route(route: str, plan: Optional[TallPlan], n_rows: int,
                   sm_count: Optional[int]) -> str:
    """The kernel a K3 wrapper of :func:`k3_route` ``route`` launches for
    a batch of ``n_rows`` rows on a card of ``sm_count`` SMs: ``"tall"``
    (``fused_gram_tall.cu``) where the wrapper has its ``plan`` and the
    batch reaches :func:`tall_crossover`, else ``route``."""
    if plan is not None and sm_count and n_rows >= tall_crossover(sm_count):
        return "tall"
    return route


def _core_matrices(block: torch.Tensor) -> torch.Tensor:
    """A (parts, K, N) block, K and N multiples of 8, as wgmma's K-major
    core matrices without swizzle, flat: per part, core matrix (k8, n8)
    at (k8·N/8 + n8)·64 elements, its 8 n rows of 8 consecutive k."""
    p, k, n = block.shape
    return block.reshape(p, k // 8, 8, n // 8, 8).permute(0, 1, 3, 4, 2).reshape(-1)


def pack_tall(ops: GramOperands) -> torch.Tensor:
    """``ops``' weights as ``fused_gram_tall.cu``'s producer streams them,
    once per model: for each stage (:func:`tall_stages`: trunk layers 1 …
    n−1 and ``G`` at ``ops.tier``, ``W_iᵀ`` for i = n−1 … 1 at
    ``ops.grad_tier``), zero-padded to multiples of 16, for each chunk
    (:func:`tall_chunks`), for each k-step of 16 rows: the
    first, then the second warpgroup's block, each its
    parts (``w_hi`` then ``w_lo`` at bf16x3) in core-matrix layout
    (:func:`_core_matrices`). bf16, exact: the values are
    bf16-representable."""
    mats = ([(w, ops.tier) for w in ops.w] + [(ops.g, ops.tier)]
            + [(wt, ops.grad_tier) for wt in reversed(ops.wt)])
    blocks = []
    for op, tier in mats:
        parts = [p for p in hi_lo(op, tier) if p is not None]
        k, n = parts[0].shape
        kp = _pad16(k)
        w = op.new_zeros((len(parts), kp, _pad16(n)))
        w[:, :k, :n] = torch.stack(parts)
        for chunk in tall_chunks(n):
            for k0 in range(0, kp, 16):
                blocks += [_core_matrices(w[:, k0: k0 + 16, c: c + width])
                           for c, width in chunk if width]
    return torch.cat(blocks).to(torch.bfloat16)


class _GramWrapper:
    """What K2's and K3's wrappers share: the routing and the refusals,
    the folded observation and noise, the operand cache, the wide
    route's workspace and the launch count."""

    name: str

    def __init__(self, config, norm, obs, noise_var, *, precision, grad_precision,
                 device, tile_rows=None, members=None):
        if config.activation != "relu":
            raise NotImplementedError(
                f"{self.name} hard-codes ReLU hidden layers; got "
                f"activation={config.activation!r}"
            )
        widths = (config.n_params, *config.hidden_dims)
        if not config.hidden_dims:
            raise NotImplementedError(f"{self.name} takes at least one hidden layer")
        self.tier = resolve_tier(precision, "high")
        self.grad_tier = grad_precision
        # the kernel this wrapper's CUDA calls launch (k2_route, k3_route):
        # fused_gram_mma.cu, with (K3 at a reverse pair) an fp32 backward;
        # K3's fused_gram_mixed.cu (fp32 forward, tensor-core backward); on
        # the CUDA cores K2's fused_loglik_gram.cu or K3's register-tiled
        # fused_loglik_grad_gram_f32.cu; or, for every network those cannot
        # hold, by shared memory or depth, fused_loglik_grad_gram.cu (the
        # wide route). Chosen here, by tiers and shape.
        if self.grad_tier is None:
            route = k2_route(widths, self.tier, tile_rows)
        else:
            route = k3_route(widths, self.tier, self.grad_tier, tile_rows)
        self.tensor_cores = route == "mma"
        self.mixed = route == "mixed"
        self.reverse = route == "reverse"
        self.register_tiled = route == "f32" and self.grad_tier is not None
        self.wide = route == "wide"
        self.plan = None
        if self.wide:
            # the wide route's plan and tile heights; the height is picked
            # per call among them unless forced
            self.plan = wide_route_plan(widths, self.tier, self.grad_tier)
            self.heights = self.plan.heights
            if tile_rows is not None and tile_rows not in self.heights:
                raise ValueError(f"tile_rows on the wide route must be one of "
                                 f"{self.heights}; got {tile_rows!r}")
            self.tile_rows = tile_rows
            need = plan_bytes(self.plan, tile_rows or self.heights[0])
        elif self.grad_tier is None:
            # fused_loglik_gram.cu's tile height (K2 at the fp32 tier)
            self.tile_rows = gram_f32_rows(widths, tile_rows)
            need = gram_shared_bytes(widths, self.tier, self.tile_rows)
        else:
            # the forced tile height of fused_loglik_grad_gram_f32.cu or
            # fused_gram_mixed.cu, or None: picked per call among the
            # heights that fit
            self.tile_rows = check_tile_rows(tile_rows)
            if self.mixed and tile_rows not in (None, *MIXED_TILE_ROWS):
                raise ValueError(f"tile_rows at a mixed tier pair must be one of "
                                 f"{MIXED_TILE_ROWS}; got {tile_rows!r}")
            self.heights = (grad_mixed_heights(widths, self.grad_tier) if self.mixed
                            else grad_f32_heights(widths))
            need = shared_bytes(widths, self.tier, self.grad_tier, tile_rows)
        if need > MAX_SHARED_BYTES:
            raise NotImplementedError(
                f"hidden widths {config.hidden_dims} need {need} bytes of shared "
                f"memory per {self.name} block at the {self.tier} tier; the limit "
                f"is {MAX_SHARED_BYTES}"
            )
        self.device = torch.empty(0, device=device).device
        # K3's height rule counts blocks against the card's SMs, read once
        self.sm_count = (torch.cuda.get_device_properties(self.device).multi_processor_count
                         if self.device.type == "cuda" else None)
        self.n_params = config.n_params
        self.members = check_members(members)
        # K3 at a bf16 pair on one model: batches of tall_crossover rows or
        # more run fused_gram_tall.cu where its plan fits, the rest
        # fused_gram_mma.cu (k3_batch_route)
        self.route = route
        plan = (tall_plan(widths, self.tier, self.grad_tier)
                if route == "mma" and self.grad_tier is not None else None)
        self.tall_plan = plan if members is None else None
        # the plan a one-model wrapper would take, which the member axis
        # declines (tall_declined)
        self.declined_plan = plan if members is not None else None
        self.tall_launches = 0
        # the wide route's launches and workspace
        self.wide_launch = (WideLaunch(self.plan, self.grad_tier is not None, self.sm_count,
                                       self.device, self.members) if self.wide else None)
        self.launches = 0
        obs = obs_tensor(obs, config.n_bins, device=self.device)
        scale = noise_scale(noise_var, config.n_bins, device=self.device)
        fold = functools.partial(
            gram_operands, norm=norm, obs=obs, scale=scale,
            log_norm=noise_log_norm(noise_var), tier=self.tier,
            grad_tier=self.grad_tier,
        )

        def build_one(params) -> GramOperands:
            ops = fold(params)
            if ops.widths != widths:
                raise ValueError(
                    f"params have trunk widths {ops.widths}; this {self.name} takes {widths}"
                )
            if self.wide:
                return pack_wide_operands(ops)
            if self.tensor_cores:
                ops = dataclasses.replace(ops, packed=pack_gram_operands(ops))
                return ops if self.tall_plan is None else dataclasses.replace(
                    ops, tall=pack_tall(ops))
            if self.grad_tier is None:
                return dataclasses.replace(ops, slabs=pack_gram_slabs(ops))
            if self.mixed:  # K2's forward stream and the backward's fragments
                return dataclasses.replace(ops, slabs=pack_gram_slabs(ops), packed=GramPacked(
                    w=(), b=(), wt=pack_grad_fragments(ops), g=None, u=None))
            if self.reverse:  # the forward's fragments and the backward's fp32 slabs
                backward = pack_backward_slabs(ops).w
                return dataclasses.replace(ops, packed=pack_gram_operands(ops),
                                           slabs=Slabs(w=backward, b=backward.new_zeros(0)))
            return dataclasses.replace(ops, slabs=pack_grad_gram_slabs(ops))

        def build(params) -> GramOperands:
            if self.members is None:
                return build_one(params)
            ops = stack_members([build_one(p) for p in member_layers(params, self.members)])
            return dataclasses.replace(ops, c=ops.c.reshape(self.members, 1),
                                       members=self.members)

        self.operands = OperandCache(build)

    def rows_for(self, n_rows: int) -> Optional[int]:
        """The tile height of ``fused_loglik_grad_gram_f32.cu``,
        ``fused_gram_mixed.cu`` or ``fused_loglik_grad_gram.cu`` for a
        batch of ``n_rows`` rows of each member (:func:`pick_grad_rows`),
        :attr:`tile_rows` if forced; None on the other routes (K2's fp32
        kernel keeps its :attr:`tile_rows`)."""
        if not (self.register_tiled or self.mixed or self.wide):
            return None
        return self.tile_rows or pick_grad_rows(self.heights, n_rows, self.sm_count,
                                                self.members or 1)

    def batch_route(self, n_rows: int) -> str:
        """The kernel a CUDA call of ``n_rows`` rows launches
        (:func:`k3_batch_route`): ``"tall"`` or the route this wrapper was
        built on (:func:`k3_route`, :func:`k2_route`)."""
        return k3_batch_route(self.route, self.tall_plan, n_rows, self.sm_count)

    def tall_declined(self, n_rows: int) -> bool:
        """Whether a call of ``n_rows`` rows misses ``fused_gram_tall.cu``
        only because it carries a member axis: the wrapper's pair and
        network are ones the tall kernel takes on one model and the batch
        reaches :func:`tall_crossover` on the wrapper's card."""
        return self.declined_plan is not None and k3_batch_route(
            self.route, self.declined_plan, n_rows, self.sm_count) == "tall"

    def _launch_kernel(self, launch_fn, ops, x):
        """``launch_fn(ops, x, rows)`` at the height this batch takes
        (:meth:`rows_for`; K2's fp32 kernel its own); the wide route's
        through :attr:`wide_launch`; K3's large batches at a bf16 pair on
        ``fused_gram_tall.cu`` (:meth:`batch_route`), each K3 call counted
        by its route (``k3.route.<route>``) and, with a member axis, by
        whether the tall kernel declined it (``k3.tall_declined``, 0 or
        1: :meth:`tall_declined`)."""
        if self.grad_tier is not None:
            route = self.batch_route(x.shape[0])
            count(f"k3.route.{route}")
            if self.members is not None and recording_open():
                count("k3.tall_declined", int(self.tall_declined(x.shape[0])))
            if route == "tall":
                self.tall_launches += 1
                return _loglik_grad_gram_tall_cuda(ops, x, self.tall_plan, self.sm_count)
        rows = self.rows_for(x.shape[0]) if self.grad_tier is not None or self.wide else (
            self.tile_rows)
        if self.wide:
            return self.wide_launch(ops, x, rows)
        return launch_fn(ops, x, rows)

    def _run(self, params, raw, plain, members_plain, kernel):
        with span(self.name, WRAPPERS):
            x = check_rows(raw, self.device, self.n_params)
            ops = self.operands(params)
            if x.device.type == "cpu":
                return plain(ops, x) if ops.members is None else members_plain(ops, x)
            if x.device.type != "cuda":
                raise ValueError(f"{self.name} runs on CUDA or (plain) on the CPU; got {x.device}")
            if x.shape[0]:  # an empty batch launches nothing
                self.launches += 1
            return self._launch_kernel(kernel, ops, x)


class FusedLoglikGram(_GramWrapper):
    """K2: ``(params, raw) → logL (B,)``; a 1-D ``raw`` is scored as one
    row.

    ``raw`` must be a contiguous float32 tensor on the wrapper's
    ``device``. On a CUDA device every call with at least one row
    launches K2 and adds one to :attr:`launches`; on the CPU it runs
    :func:`loglik_gram_reference`. Nothing here is differentiable (see
    ``make_loglik(backend="kernel")`` for the autograd rule). At the fp32
    tier ``tile_rows`` (one of
    :data:`~tpu21cmvae_torch.ops.kernels._common.F32_TILE_ROWS`) forces
    ``fused_loglik_gram.cu``'s tile height, else :func:`gram_f32_rows`
    picks it (:attr:`tile_rows`). A network neither
    ``fused_loglik_gram.cu`` nor ``fused_gram_mma.cu`` holds runs the wide
    route's value-only program (``fused_loglik_grad_gram.cu``,
    :attr:`wide`, 32- or 16-row tiles by batch). ``members=M`` takes an
    ensemble's stacked ``params`` and returns ``logL (M, B)`` from one
    launch per call (:func:`loglik_gram_members_reference` on the CPU).
    """

    name = "K2"

    def __init__(self, config, norm, obs, noise_var=1.0, *, precision="high",
                 tile_rows=None, members=None, device):
        super().__init__(config, norm, obs, noise_var, precision=precision,
                         grad_precision=None, device=device, tile_rows=tile_rows,
                         members=members)

    @torch.no_grad()
    def __call__(self, params, raw):
        return self._run(params, raw, loglik_gram_reference, loglik_gram_members_reference,
                         _loglik_gram_cuda)


class FusedLoglikGradGram(_GramWrapper):
    """K3: ``(params, raw) → (logL (B,), dlogL/draw (B, n_params))``; a
    1-D ``raw`` is scored as one row.

    The input rules, the device rule and :attr:`launches` are K2's
    (:class:`FusedLoglikGram`); on the CPU it runs
    :func:`loglik_grad_gram_reference`. The folded operands are cached
    against the identity and version of the ``params`` tensors, so an
    in-place weight update refolds. At (fp32, fp32) the register-tiled
    ``fused_loglik_grad_gram_f32.cu`` runs (:attr:`register_tiled`), at
    an fp32 value tier with a bf16 backward tier ``fused_gram_mixed.cu``
    (:attr:`mixed`), each at the tile height :meth:`rows_for` gives each
    batch; at a reverse pair (a bf16 value tier, an fp32 backward)
    ``fused_gram_mma.cu`` with its fp32 backward, 16-row tiles
    (:attr:`reverse`); every bf16 or bf16x3 pair ``fused_gram_mma.cu``
    with a tensor-core backward (:attr:`tensor_cores`), and at (bf16x3,
    bf16) on one model a batch of :func:`tall_crossover` rows or more
    ``fused_gram_tall.cu`` where its plan fits (:attr:`tall_plan`; :meth:`batch_route` names the
    kernel a batch runs, :attr:`tall_launches` counts its launches, which
    :attr:`launches` includes); any pair on a
    network its kernel cannot hold (too wide, or deeper than eight
    layers) ``fused_loglik_grad_gram.cu`` (:attr:`wide`, 32- or 16-row
    tiles by batch); ``tile_rows`` (one of
    :data:`~tpu21cmvae_torch.ops.kernels._common.F32_TILE_ROWS`, and of
    :data:`MIXED_TILE_ROWS` at a mixed pair) forces one height for every
    batch. ``members=M`` takes an ensemble's stacked ``params`` and
    returns ``(logL (M, B), dlogL/draw (M, B, n_params))`` from one launch
    per call (:func:`loglik_grad_gram_members_reference` on the CPU).
    """

    name = "K3"

    def __init__(self, config, norm, obs, noise_var=1.0, *, precision="high",
                 grad_precision=None, tile_rows=None, members=None, device):
        tier = resolve_tier(precision, "high")
        grad_tier = tier if grad_precision is None else resolve_tier(grad_precision)
        super().__init__(config, norm, obs, noise_var, precision=precision,
                         grad_precision=grad_tier, device=device, tile_rows=tile_rows,
                         members=members)

    @torch.no_grad()
    def __call__(self, params, raw):
        return self._run(params, raw, loglik_grad_gram_reference,
                         loglik_grad_gram_members_reference, _loglik_grad_gram_cuda)


def make_fused_loglik_gram(config, norm, obs, noise_var=1.0, *, precision="high",
                           tile_rows=None, members=None, device) -> FusedLoglikGram:
    """Fused gram-form value (the builder of the JAX package's same
    name): ``precision`` tiers the trunk and ``G`` products;
    ``tile_rows`` and ``members``: see :class:`FusedLoglikGram`."""
    return FusedLoglikGram(config, norm, obs, noise_var, precision=precision,
                           tile_rows=tile_rows, members=members, device=device)


def make_fused_loglik_grad_gram(config, norm, obs, noise_var=1.0, *,
                                precision="high", grad_precision=None,
                                tile_rows=None, members=None,
                                device) -> FusedLoglikGradGram:
    """Fused gram value-and-gradient (the builder of the JAX package's
    same name): ``precision`` tiers the value's matmuls,
    ``grad_precision`` (default: the same tier) the backward's. A
    cheaper backward tier only costs HMC acceptance rate: leapfrog with
    any deterministic force field stays reversible and volume-preserving,
    and the accept step uses the value. ``tile_rows`` and ``members``:
    see :class:`FusedLoglikGradGram`."""
    return FusedLoglikGradGram(
        config, norm, obs, noise_var, precision=precision,
        grad_precision=grad_precision, tile_rows=tile_rows, members=members, device=device,
    )


class FusedLoglik:
    """The direct-method likelihood on K1: ``(params, raw) → logL (B,)``
    = ``−½·Σ_bins r² + log_norm`` with ``r`` the folded network's output
    (obs and noise folded into its last layer), reduced inside the
    kernel, so the (B, n_bins) signal never reaches device memory.
    Input and device rules, :attr:`launches`, ``tile_rows`` and
    ``members`` (``logL (M, B)`` from one launch) are K1's
    (:class:`~tpu21cmvae_torch.ops.kernels.fused_mlp.FusedMLP`)."""

    def __init__(self, config, norm, obs, noise_var=1.0, *, precision="high",
                 tile_rows=None, members=None, device):
        if config.activation != "relu":
            raise NotImplementedError(
                "K1 hard-codes ReLU hidden layers; got "
                f"activation={config.activation!r}"
            )
        device = torch.empty(0, device=device).device
        obs = obs_tensor(obs, config.n_bins, device=device)
        scale = noise_scale(noise_var, config.n_bins, device=device)
        self.log_norm = noise_log_norm(noise_var)
        self.mlp = FusedMLP(
            config.mlp().sizes, log_clamp_input=True,
            precision="high" if precision is None else precision,
            reduce="sumsq", tile_rows=tile_rows, members=members, device=device,
            fold=functools.partial(fold_loglik_constants, norm=norm, obs=obs, scale=scale),
        )

    @property
    def members(self):
        return self.mlp.members

    @property
    def launches(self) -> int:
        return self.mlp.launches

    @launches.setter
    def launches(self, n: int):
        self.mlp.launches = n

    @torch.no_grad()
    def __call__(self, params, raw):
        return -0.5 * self.mlp(params, raw) + self.log_norm


def make_fused_loglik(config, norm, obs, noise_var=1.0, *, precision="high",
                      tile_rows=None, members=None, device) -> FusedLoglik:
    """Fused direct-method Gaussian log-likelihood (the builder of the
    JAX package's same name): K1 over the network with the normalizer,
    the observation and the noise folded in, reduced by ``sumsq``;
    ``tile_rows`` and ``members``: see
    :class:`~tpu21cmvae_torch.ops.kernels.fused_mlp.FusedMLP`."""
    return FusedLoglik(config, norm, obs, noise_var, precision=precision,
                       tile_rows=tile_rows, members=members, device=device)
