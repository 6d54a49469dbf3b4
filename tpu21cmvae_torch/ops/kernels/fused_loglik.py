"""K3: the fused gram-form value-and-gradient kernel, its plain PyTorch
version, and the wrapper that picks between them by the input's device.

The port of ``tpu21cmvae/ops/pallas/fused_loglik.py::make_fused_loglik_grad_gram``
— the HMC inner loop. Both versions read the same :class:`GramOperands`:
the network folded with ``ops/fold.py::gram_fold`` (normalizer, the
observation and the diagonal noise all in the weights; the 451-wide output
layer collapsed into ``G = WWᵀ``, ``u``, ``c``) and split for the value and
backward tiers. The CUDA kernel (``csrc/fused_loglik_grad_gram.cu``) keeps
every activation of a row tile on chip; :func:`loglik_grad_gram_reference`
does the same arithmetic — same folds, same hi/lo split, same epilogue —
in plain tensor operations.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from tpu21cmvae_torch.ops.fold import (
    _log_clamp,
    _log_clamp_grad,
    gram_fold,
    noise_log_norm,
    noise_scale,
    obs_tensor,
    prepare_operand,
    resolve_tier,
    tier_matmul,
)
from tpu21cmvae_torch.ops.mlp import SKINNY_DENSE_MAX_IN, skinny_dense

ROWS_PER_BLOCK = 16  # kRows in the CUDA source
MAX_LAYERS = 8  # kMaxLayers in the CUDA source
MAX_SHARED_BYTES = 232448  # an H100 block's dynamic shared-memory limit
_TIER_CODE = {"f32": 0, "bf16": 1, "bf16x3": 2}


@dataclasses.dataclass(frozen=True)
class GramOperands:
    """Everything K3 and its plain version read besides the input rows.

    ``w0``/``b0``: the skinny first layer, exact fp32. ``w``/``b``: the
    other trunk layers, ``w`` prepared at ``tier``
    (:func:`~tpu21cmvae_torch.ops.fold.prepare_operand`); ``wt``: the same
    weights transposed, prepared at ``grad_tier``. ``g``: ``G`` at
    ``tier``. ``u``, ``c``, ``log_norm``: the rest of the gram form.
    """

    tier: str
    grad_tier: str
    w0: torch.Tensor
    b0: torch.Tensor
    w: tuple
    b: tuple
    wt: tuple
    g: torch.Tensor
    u: torch.Tensor
    c: torch.Tensor
    log_norm: float

    @property
    def widths(self) -> tuple:
        """``(n_in, *trunk widths)``."""
        return (*self.w0.shape, *(b.shape[0] for b in self.b))


def gram_operands(params, norm, obs, scale, log_norm, tier, grad_tier) -> GramOperands:
    """Fold ``params`` (exact fp32) and split them for the tiers. The
    operands are detached: nothing differentiates through K3."""
    params = tuple({k: v.detach() for k, v in layer.items()} for layer in params)
    trunk, G, u, c = gram_fold(params, norm, obs, scale)
    first, *rest = trunk
    if first["w"].shape[0] > SKINNY_DENSE_MAX_IN:
        raise NotImplementedError(
            f"K3 needs a skinny first layer (fan-in ≤ {SKINNY_DENSE_MAX_IN}); "
            f"got fan-in {first['w'].shape[0]}"
        )
    return GramOperands(
        tier=tier,
        grad_tier=grad_tier,
        w0=first["w"].contiguous(),
        b0=first["b"].contiguous(),
        w=tuple(prepare_operand(layer["w"], tier) for layer in rest),
        b=tuple(layer["b"].contiguous() for layer in rest),
        wt=tuple(prepare_operand(layer["w"].T, grad_tier) for layer in rest),
        g=prepare_operand(G, tier),
        u=u.contiguous(),
        c=c,
        log_norm=log_norm,
    )


def _epilogue(ops: GramOperands, quad, half_dquad):
    """``(−½·(quad + c) + log_norm, −½·dquad/dx)``: the value and its
    gradient from the kernel's two outputs."""
    return -0.5 * (quad + ops.c) + ops.log_norm, -half_dquad


def loglik_grad_gram_reference(ops: GramOperands, x: torch.Tensor):
    """K3 in plain PyTorch: ``(logL (B,), dlogL/dx (B, n_in))`` for raw
    rows ``x`` (B, n_in) float32 on ``ops``' device."""
    h = torch.relu(skinny_dense(_log_clamp(x), ops.w0, ops.b0))
    acts = [h]
    for w, b in zip(ops.w, ops.b):
        h = torch.relu(tier_matmul(h, w, ops.tier) + b)
        acts.append(h)
    g1 = tier_matmul(h, ops.g, ops.tier)
    quad = torch.sum((g1 + 2.0 * ops.u) * h, dim=-1)
    # ½·dquad/dh = h@G + u: G is symmetric, so the forward's product is reused
    e = g1 + ops.u
    for i in range(len(acts) - 1, 0, -1):
        e = torch.where(acts[i] > 0.0, e, 0.0)
        e = tier_matmul(e, ops.wt[i - 1], ops.grad_tier)
    e = torch.where(acts[0] > 0.0, e, 0.0) @ ops.w0.T  # skinny layer: exact fp32
    return _epilogue(ops, quad, _log_clamp_grad(x) * e)


def _hi_lo(op: torch.Tensor, tier: str):
    """The kernel's (hi, lo) views of a prepared operand (lo: None
    unless bf16x3, whose operand stacks [hi; lo; hi])."""
    if tier != "bf16x3":
        return op, None
    k = op.shape[0] // 3
    return op[:k], op[k: 2 * k]


def _loglik_grad_gram_cuda(ops: GramOperands, x: torch.Tensor):
    """Launch K3 on PyTorch's current stream (no synchronisation)."""
    from tpu21cmvae_torch.ops.kernels._build import load_library

    lib = load_library()
    n, n_in = x.shape
    quad = torch.empty((n,), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    if n == 0:
        return _epilogue(ops, quad, dx)
    tensors = [ops.w0, ops.b0]
    for w, b, wt in zip(ops.w, ops.b, ops.wt):
        tensors += [*_hi_lo(w, ops.tier), b, *_hi_lo(wt, ops.grad_tier)]
    tensors += [*_hi_lo(ops.g, ops.tier), ops.u]
    ptrs = (ctypes.c_void_p * len(tensors))(
        *(None if t is None else t.data_ptr() for t in tensors)
    )
    widths = (ctypes.c_int * len(ops.widths))(*ops.widths)
    with torch.cuda.device(x.device):
        rc = lib.k3_fused_loglik_grad_gram(
            x.data_ptr(), quad.data_ptr(), dx.data_ptr(), n,
            len(ops.widths) - 1, widths, ptrs,
            _TIER_CODE[ops.tier], _TIER_CODE[ops.grad_tier],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"K3 launch failed: {lib.k3_error_string(rc).decode()} (cudaError {rc})"
        )
    return _epilogue(ops, quad, dx)


def shared_bytes(widths) -> int:
    """Dynamic shared memory of one K3 block: the input tile, every
    trunk activation and ``h@G``, ``ROWS_PER_BLOCK`` rows each."""
    return 4 * ROWS_PER_BLOCK * (sum(widths) + widths[-1])


class FusedLoglikGradGram:
    """``(params, raw) → (logL (B,), dlogL/draw (B, n_params))``; a 1-D
    ``raw`` is scored as one row.

    ``raw`` must be a contiguous float32 tensor on the wrapper's
    ``device``. On a CUDA device every call with at least one row
    launches K3 and adds one to :attr:`launches`; on the CPU it runs
    :func:`loglik_grad_gram_reference`.
    The folded operands are cached against the identity and version of
    the ``params`` tensors, so an in-place weight update refolds.
    """

    def __init__(self, config, norm, obs, noise_var=1.0, *, precision="high",
                 grad_precision=None, device):
        if config.activation != "relu":
            raise NotImplementedError(
                "K3 hard-codes ReLU hidden layers; got "
                f"activation={config.activation!r}"
            )
        widths = (config.n_params, *config.hidden_dims)
        if not 1 <= len(config.hidden_dims) <= MAX_LAYERS:
            raise NotImplementedError(
                f"K3 takes 1 to {MAX_LAYERS} hidden layers; got "
                f"{len(config.hidden_dims)}"
            )
        if config.n_params > SKINNY_DENSE_MAX_IN:
            raise NotImplementedError(
                f"K3 takes at most {SKINNY_DENSE_MAX_IN} input parameters; "
                f"got {config.n_params}"
            )
        if shared_bytes(widths) > MAX_SHARED_BYTES:
            raise NotImplementedError(
                f"hidden widths {config.hidden_dims} need "
                f"{shared_bytes(widths)} bytes of shared memory per K3 "
                f"block; the limit is {MAX_SHARED_BYTES}"
            )
        self.device = torch.empty(0, device=device).device
        self.n_params = config.n_params
        self.tier = resolve_tier(precision, "high")
        self.grad_tier = (
            self.tier if grad_precision is None else resolve_tier(grad_precision)
        )
        self.norm = norm
        self.obs = obs_tensor(obs, config.n_bins, device=self.device)
        self.scale = noise_scale(noise_var, config.n_bins, device=self.device)
        self.log_norm = noise_log_norm(noise_var)
        self.launches = 0
        self._cached = None

    def operands(self, params) -> GramOperands:
        """The folded, tier-split operands for ``params`` (cached)."""
        tensors = tuple(t for layer in params for t in (layer["w"], layer["b"]))
        versions = tuple(t._version for t in tensors)
        hit = self._cached
        if (
            hit is not None
            and len(hit[0]) == len(tensors)
            and all(a is b for a, b in zip(hit[0], tensors))
            and hit[1] == versions
        ):
            return hit[2]
        with torch.no_grad():
            ops = gram_operands(params, self.norm, self.obs, self.scale,
                                self.log_norm, self.tier, self.grad_tier)
        self._cached = (tensors, versions, ops)
        return ops

    def _rows(self, raw) -> torch.Tensor:
        if not isinstance(raw, torch.Tensor):
            raise TypeError(f"raw must be a torch.Tensor; got {type(raw).__name__}")
        if raw.device != self.device:
            raise ValueError(f"raw is on {raw.device}; this wrapper runs on {self.device}")
        if raw.dtype != torch.float32:
            raise TypeError(f"raw must be float32; got {raw.dtype}")
        if not raw.is_contiguous():
            raise ValueError("raw must be contiguous")
        x = raw.reshape(1, -1) if raw.ndim == 1 else raw
        if x.ndim != 2 or x.shape[1] != self.n_params:
            raise ValueError(
                f"raw must be ({self.n_params},) or (B, {self.n_params}); got "
                f"{tuple(raw.shape)}"
            )
        return x

    @torch.no_grad()
    def __call__(self, params, raw):
        x = self._rows(raw)
        ops = self.operands(params)
        if x.device.type == "cpu":
            return loglik_grad_gram_reference(ops, x)
        if x.device.type != "cuda":
            raise ValueError(f"K3 runs on CUDA or (plain) on the CPU; got {x.device}")
        if x.shape[0]:  # an empty batch launches nothing
            self.launches += 1
        return _loglik_grad_gram_cuda(ops, x)


def make_fused_loglik_grad_gram(config, norm, obs, noise_var=1.0, *,
                                precision="high", grad_precision=None,
                                device) -> FusedLoglikGradGram:
    """Fused gram value-and-gradient (the builder of the JAX package's
    same name): ``precision`` tiers the value's matmuls,
    ``grad_precision`` (default: the same tier) the backward's. A
    cheaper backward tier only costs HMC acceptance rate: leapfrog with
    any deterministic force field stays reversible and volume-preserving,
    and the accept step uses the value."""
    return FusedLoglikGradGram(
        config, norm, obs, noise_var, precision=precision,
        grad_precision=grad_precision, device=device,
    )
