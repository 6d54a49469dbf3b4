"""Constant folds, the input log-clamp, and the matmul precision tiers.

The JAX package keeps these helpers inside its Pallas kernel files
(``tpu21cmvae/ops/pallas/fused_mlp.py:86-169``,
``fused_loglik.py:72-167``) although its XLA paths import them too; here
they are one module that every path — plain PyTorch and the CUDA kernel
wrappers — shares, and that imports nothing but torch and numpy.

**Folds.** ``par_transform``'s affine stage folds into the first layer,
``unpreproc`` into the (linear) last layer, and a Gaussian likelihood's
observation and diagonal noise into the last layer again, so the folded
network's output IS the whitened residual; :func:`gram_fold` then
collapses that linear last layer into ``‖h@W + b‖² = h·G·hᵀ + 2h·u + c``.

**Tiers.** One resolver (:func:`resolve_tier`) maps the JAX package's
tier names onto the port's three kinds of matmul arithmetic:

* ``"highest"`` / ``"contract"`` → ``"f32"``: IEEE fp32 products and
  fp32 sums (the port assumes ``torch.backends.cuda.matmul.allow_tf32``
  is False, PyTorch's default);
* ``"high"`` → ``"bf16x3"``: ``hi·hi + hi·lo + lo·hi`` where ``hi`` is
  ``x`` with its low 16 bits masked off (``bits & 0xFFFF0000``) and
  ``lo = bf16_rn(x − hi)`` — the reference's integer-mask split
  (``fused_mlp.py::_split_hi_lo``);
* ``"default"`` → ``"bf16"``: both operands rounded to bf16
  (round-to-nearest-even), fp32 sums — single-pass bf16.

Every product of two bf16-representable values is exact in fp32, so the
plain version of a tier (fp32 matmuls on pre-rounded operands) and a
CUDA kernel of the same tier differ only in summation order.
"""

from __future__ import annotations

import numpy as np
import torch

_FX_CLAMP = 1e-6  # reference preprocess.py:76 — avoids log10(0) for fx == 0
_N_LOG_COLS = 3  # log10 applied to columns 0-2 (fstar, Vc, fx)
_LN10 = 2.302585092994046
_HI_MASK = -65536  # 0xFFFF0000 as a signed 32-bit integer

_TIERS = {
    "highest": "f32",
    "contract": "f32",
    "high": "bf16x3",
    "default": "bf16",
}


def resolve_tier(precision, default: str = "high") -> str:
    """Map a tier name (``"highest"``, ``"contract"``, ``"high"``,
    ``"default"``; ``None`` → ``default``) to its arithmetic kind:
    ``"f32"``, ``"bf16x3"`` or ``"bf16"``."""
    name = default if precision is None else precision
    try:
        return _TIERS[str(name).lower()]
    except KeyError:
        raise ValueError(
            f"precision must be one of {sorted(_TIERS)} or None; got "
            f"{precision!r}"
        ) from None


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to the nearest bf16 (ties to even), kept as
    float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _split_hi_lo(x: torch.Tensor):
    """``x ≈ hi + lo`` with both halves bf16-representable (float32
    tensors): ``hi`` masks off the low 16 bits — exact, no rounding —
    and ``lo`` is the remainder rounded once to bf16. The cast round-trip
    form of the split is deliberately not used (see the JAX package's
    ``_split_hi_lo`` for why it collapsed the tier on the TPU)."""
    x = x.to(torch.float32).contiguous()
    hi = (x.view(torch.int32) & _HI_MASK).view(torch.float32)
    return hi, bf16_round(x - hi)


def prepare_operand(w: torch.Tensor, tier: str) -> torch.Tensor:
    """The right-hand matmul operand ``w`` (K, N) in the form
    :func:`tier_matmul` consumes: ``w`` at ``"f32"``, ``bf16_rn(w)`` at
    ``"bf16"``, and the stacked ``[w_hi; w_lo; w_hi]`` (3K, N) at
    ``"bf16x3"`` (so ``[a_hi, a_hi, a_lo] @ it`` is the three products
    in one matmul; rows ``[:K]`` and ``[K:2K]`` are ``w_hi`` and
    ``w_lo``)."""
    w = w.to(torch.float32)
    if tier == "f32":
        return w.contiguous()
    if tier == "bf16":
        return bf16_round(w).contiguous()
    if tier == "bf16x3":
        hi, lo = _split_hi_lo(w)
        return torch.cat([hi, lo, hi], dim=0)
    raise ValueError(f"unknown tier {tier!r}")


def tier_matmul(a: torch.Tensor, w_op: torch.Tensor, tier: str) -> torch.Tensor:
    """``a @ w`` at ``tier`` with fp32 accumulation, ``w_op`` from
    :func:`prepare_operand`."""
    if tier == "f32":
        return a @ w_op
    if tier == "bf16":
        return bf16_round(a) @ w_op
    a_hi, a_lo = _split_hi_lo(a)
    return torch.cat([a_hi, a_hi, a_lo], dim=-1) @ w_op


def _log_clamp(x: torch.Tensor) -> torch.Tensor:
    """log10 on columns 0..2 with the ``fx == 0 → 1e-6`` clamp
    (reference ``preprocess.py:74-76``); other columns pass through."""
    col = torch.arange(x.shape[-1], device=x.device)
    is_log = col < _N_LOG_COLS
    is_fx = col == _N_LOG_COLS - 1
    clamped = torch.where(is_fx & (x == 0.0), _FX_CLAMP, x)
    return torch.where(is_log, torch.log10(torch.where(is_log, clamped, 1.0)), x)


def _log_clamp_grad(x: torch.Tensor) -> torch.Tensor:
    """Elementwise derivative of :func:`_log_clamp` — ``1/(x·ln10)`` on
    the log columns, exactly 0 where the ``fx == 0`` clamp fired
    (matching autodiff through the ``where``), 1 elsewhere."""
    col = torch.arange(x.shape[-1], device=x.device)
    is_log = col < _N_LOG_COLS
    clamp_fired = (col == _N_LOG_COLS - 1) & (x == 0.0)
    safe = torch.where(is_log & ~clamp_fired, x, 1.0)
    d = torch.where(is_log, 1.0 / (safe * _LN10), 1.0)
    return torch.where(clamp_fired, 0.0, d)


def fold_emulator_constants(params, norm):
    """Fold the normalization constants into the first/last layer weights
    (``fused_mlp.py::fold_emulator_constants``): ``par_transform``'s
    affine stage ``x ↦ a·x_log + c`` into the first layer and
    ``unpreproc`` (``y ↦ y·std + mean``) into the linear last layer."""
    a = 2.0 / (norm.par_max - norm.par_min)
    c = -(norm.par_max + norm.par_min) / (norm.par_max - norm.par_min)
    if len(params) == 1:  # no hidden layers: both folds land on one layer
        (only,) = params
        w = a[:, None] * only["w"]
        b = c @ only["w"] + only["b"]
        return (
            {"w": w * norm.signal_std, "b": b * norm.signal_std + norm.signal_mean},
        )
    first, *mid, last = params
    first = {"w": a[:, None] * first["w"], "b": c @ first["w"] + first["b"]}
    last = {
        "w": last["w"] * norm.signal_std,
        "b": last["b"] * norm.signal_std + norm.signal_mean,
    }
    return (first, *mid, last)


def _diagonal_noise(noise_var) -> np.ndarray:
    """A diagonal noise spec as an array; anything else is refused."""
    nv = np.asarray(noise_var)
    if nv.dtype.kind not in "fiu":
        raise NotImplementedError(
            f"noise_var of type {type(noise_var).__name__} is not supported "
            "by the port yet: only a scalar or per-bin variance "
            "(MarginalizedNoise / ScaleMarginalNoise folds wait for "
            "ROADMAP queue 8)"
        )
    return nv


def noise_scale(noise_var, n_bins: int, *, device) -> torch.Tensor:
    """Per-bin residual whitening ``1/σ`` (n_bins,) from a scalar or
    per-bin variance σ² (``fused_loglik.py::noise_scale``, diagonal
    noise only)."""
    nv = _diagonal_noise(noise_var)
    if nv.ndim > 1 or (nv.ndim == 1 and nv.shape[0] != n_bins):
        raise ValueError(
            f"noise_var must be a scalar or a ({n_bins},) vector; got "
            f"shape {nv.shape}"
        )
    nv = torch.as_tensor(nv, dtype=torch.float32, device=device)
    return torch.rsqrt(nv).expand(n_bins).contiguous()


def noise_log_norm(noise_var) -> float:
    """θ-independent additive log-likelihood constant of a noise spec:
    0 for diagonal noise."""
    _diagonal_noise(noise_var)
    return 0.0


def obs_tensor(obs, n_bins: int, *, device) -> torch.Tensor:
    """An observed signal (array or tensor, (n_bins,) mK) as float32 on
    ``device``."""
    if isinstance(obs, torch.Tensor):
        obs = obs.detach().cpu().numpy()
    obs = np.asarray(obs, np.float32)
    if obs.shape != (n_bins,):
        raise ValueError(f"obs must be ({n_bins},); got {obs.shape}")
    return torch.as_tensor(obs, device=device)


def fold_loglik_constants(params, norm, obs: torch.Tensor, scale: torch.Tensor):
    """:func:`fold_emulator_constants`, then shift the last bias by
    ``-obs`` and whiten the last layer by the per-bin ``scale``, so the
    folded network's output is ``(pred − obs)/σ``."""
    *rest, last = fold_emulator_constants(params, norm)
    return (*rest, {"w": last["w"] * scale, "b": (last["b"] - obs) * scale})


def gram_fold(params, norm, obs: torch.Tensor, scale: torch.Tensor):
    """Collapse the folded linear output layer into a Gram form,
    ``‖h@W + b‖² = h·G·hᵀ + 2h·u + c`` with ``G = WWᵀ``, ``u = Wb``,
    ``c = b·b``, computed in fp32 on the small weight arrays
    (``fused_loglik.py::gram_fold``). Loses ~log₁₀(‖pred − mean‖/‖r‖)
    digits to cancellation near the posterior mode.

    Returns ``(trunk_layers, G, u, c)``.
    """
    *trunk, last = fold_loglik_constants(params, norm, obs, scale)
    w, b = last["w"], last["b"]
    return tuple(trunk), w @ w.T, w @ b, b @ b
