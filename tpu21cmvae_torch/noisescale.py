"""Analytic noise-level marginalization (the port of
``tpu21cmvae/noisescale.py``): inference with an unknown noise scale at
known-noise cost.

Real radiometers know the SHAPE of their noise (radiometer-equation
scaling across the band, integration-time weights) far better than its
absolute LEVEL: calibration drifts, RFI excision changes the effective
integration time, and published global-signal analyses routinely fit a
noise amplitude alongside the signal (e.g. EDGES' σ as a free parameter,
Bowman et al. 2018 Nature 555 methods).

Here the scale dimension is removed exactly. For ``d = m(θ) + n`` with
``n ~ N(0, σ²·N₀)``, noise SHAPE ``N₀`` known (diagonal, or a
foreground-marginalized
:class:`~tpu21cmvae_torch.foregrounds.MarginalizedNoise`), LEVEL ``σ²``
unknown with a conjugate inverse-gamma prior ``σ² ~ InvGamma(α, β)`` (or
the improper Jeffreys prior ``p(σ²) ∝ 1/σ²``), the marginal over ``σ²``
is a Student-t-form density in the SAME quadratic form
``q(θ) = rᵀN₀⁻¹r`` every likelihood path here already computes:

    log L(θ) = const − (α + n_eff/2) · log(β + q(θ)/2)

Every backend returns ``−½·q + log_norm``, so the marginalization is an
exact scalar post-transform of the EXISTING likelihood value: ``q`` is
recovered as ``2·(log_norm − logL)`` and re-scored. No new kernel: the
plain gram path, the analytic gram backward, the CUDA kernels K1, K2 and
K3, the stacked-observation form and the generic ``from_predict`` path
all inherit it (the gradient transform is the exact chain rule
``∇logL_t = (α + n_eff/2)/(β + q/2) · ∇logL``, a per-row rescale).
Everything here is NumPy on the host but :meth:`ScaleMarginalNoise.wrap_value`
and :meth:`~ScaleMarginalNoise.wrap_valgrad`, which transform tensors on
the device the wrapped likelihood returns them on.

Composition with foreground marginalization is exact: wrap a
:class:`~tpu21cmvae_torch.foregrounds.MarginalizedNoise` and BOTH the
linear foreground coefficients and the noise level integrate out
analytically: a 7-parameter chain explores what would otherwise be a
13-parameter joint space (7 + K foreground terms + σ). With a flat
coefficient prior the effective dof is ``n_eff = n_bins − K`` (the K
projected directions carry no information about σ); with a proper
coefficient prior the prior is interpreted in the conjugate convention
(coefficient variance ``σ²·prior_var``, i.e. relative to the unknown
noise level) and ``n_eff = n_bins``.

Conventions: this package's plain likelihood drops the θ-independent
``−½·log|2πN₀|`` (see :mod:`tpu21cmvae_torch.foregrounds`). The
scale-marginalized likelihood drops the SAME constant. Jeffreys
(``alpha=None``) is improper: its likelihood values are defined only up
to the prior's arbitrary constant (fixed by dropping the prior
normalization: ``const = lgamma(n_eff/2)``); posterior inference on θ is
exact regardless.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from tpu21cmvae_torch.foregrounds import MarginalizedNoise

__all__ = [
    "ScaleMarginalNoise",
    "ScaleWrapped",
    "marginalize_noise_scale",
]

#: Relative floor on the Student-t argument: ``t = max(β + q/2,
#: a·_FLOOR_REL)`` with ``a = α + n_eff/2``. Only reachable under the
#: improper Jeffreys prior (β = 0) with a numerically-zero residual —
#: there the exact marginal diverges (σ² → 0 fits perfectly) and f32
#: must not: ``log(0) = -inf`` makes ``logL = +inf`` (poisons MH ratios,
#: inf − inf = NaN) and the chain-rule rescale ``a/t`` overflows.
#: Floored at ``a·1e-30`` the rescale is ≤ 1e30 for ANY α, and the
#: floor scales WITH ``a`` so the marginal's exact invariance under a
#: rescaling of the base noise shape (a θ-independent logL shift) is
#: preserved down to q ~ 1e-30·a — ~20 orders below any physical
#: residual. NB: an absolute floor must be a NORMAL f32: a device that
#: flushes subnormals to zero turns a subnormal floor into ``log(0)``.
_FLOOR_REL = 1e-30

#: Backstop bound on the rescaled gradient: at the floored point the
#: base gradient is pure rounding noise (exact value 0, observed O(100)
#: through bf16 on a trained model), and ``1e30 × noise`` can still
#: overflow f32. Clipping preserves sign; any sampler treats a 1e30
#: gradient and a 3e38 one identically (the proposal is rejected).
_GMAX = 1e30


@dataclasses.dataclass(frozen=True)
class ScaleMarginalNoise:
    """Noise-scale-marginalized likelihood spec — pass it anywhere a
    ``noise_var`` is accepted (``loglik_fn``, ``loglik_and_grad_fn``,
    ``sample_posterior``, ``fisher_forecast`` …) to infer θ with
    the absolute noise level integrated out exactly. Build with
    :func:`marginalize_noise_scale`.

    ``base`` is the noise SHAPE at the reference level σ² = 1: a scalar
    / per-bin variance (so ``base=25.0`` means "radiometer shape 25 mK²
    per bin, absolute level unknown"), or a
    :class:`~tpu21cmvae_torch.foregrounds.MarginalizedNoise` to compose with
    analytic foreground marginalization. ``alpha``/``beta`` are the
    ``InvGamma(α, β)`` prior on the LEVEL σ² (both ``None`` = Jeffreys
    ``p(σ²) ∝ 1/σ²``). The prior is on the multiplier of ``base``:
    ``base=25.0, alpha=3, beta=2`` puts prior mean ``β/(α−1) = 1`` on
    the multiplier, i.e. ~25 mK² expected.
    """

    base: object                     # scalar / (n_bins,) σ² shape, or
    #                                  MarginalizedNoise — level σ²=1
    alpha: Optional[float] = None    # None = Jeffreys p(σ²) ∝ 1/σ²
    beta: Optional[float] = None

    def __post_init__(self):
        # mirror the factory's prior checks: a directly-constructed
        # half-specified prior would otherwise crash late (beta=None
        # inside log_norm_const) or silently score a hybrid density
        # (alpha=None treated as the Jeffreys exponent with a proper
        # beta in the Student-t argument)
        if (self.alpha is None) != (self.beta is None):
            raise ValueError(
                "alpha and beta must be given together (proper "
                "InvGamma prior) or both omitted (Jeffreys)"
            )
        if self.alpha is not None and not (
            self.alpha > 0 and self.beta > 0
        ):
            raise ValueError(
                f"InvGamma prior needs alpha > 0 and beta > 0; got "
                f"alpha={self.alpha}, beta={self.beta}"
            )

    def _is_flat_marginalized(self) -> bool:
        return (
            isinstance(self.base, MarginalizedNoise)
            and self.base.prior_var is None
        )

    def n_eff(self, n_bins: int) -> int:
        """Effective degrees of freedom carrying information about σ:
        ``n_bins``, minus the flat-prior-projected foreground directions
        when the base is a flat-prior MarginalizedNoise (a proper
        coefficient prior is σ²-scaled — conjugate convention — and
        keeps all ``n_bins``, like the plain diagonal bases)."""
        if self._is_flat_marginalized():
            return n_bins - self.base.n_terms
        return n_bins

    def base_log_norm(self) -> float:
        """The σ=1 base spec's ``log_norm`` in this package's
        dropped-constant convention (0 for diagonal noise)."""
        if isinstance(self.base, MarginalizedNoise):
            return float(self.base.log_norm)
        return 0.0

    def shape_coef(self, n_bins: int) -> float:
        """The Student-t exponent ``a = α + n_eff/2`` (Jeffreys: α=0)."""
        a = 0.0 if self.alpha is None else float(self.alpha)
        return a + 0.5 * self.n_eff(n_bins)

    def log_norm_const(self, n_bins: int) -> float:
        """θ-independent constant of the marginal log-density, in the
        package's dropped-constant convention: ``base_log_norm`` plus the
        σ²-integral's normalization ``α·logβ − lgamma(α) +
        lgamma(α + n_eff/2)`` (Jeffreys drops the improper prior's own
        normalization, keeping ``lgamma(n_eff/2)``)."""
        a = self.shape_coef(n_bins)
        const = self.base_log_norm() + math.lgamma(a)
        if self.alpha is not None:
            const += float(self.alpha) * math.log(float(self.beta))
            const -= math.lgamma(float(self.alpha))
        return const

    def memo_key(self) -> tuple:
        """Value-identity key for the model-level program memos
        (:mod:`tpu21cmvae_torch.models._memo`)."""
        from tpu21cmvae_torch.models._memo import noise_key

        bk = noise_key(self.base)
        if isinstance(bk, np.ndarray):
            bk = (bk.tobytes(), bk.shape)
        return ("scalemarg", bk, self.alpha, self.beta)

    # -- the exact post-transforms every likelihood path applies --

    def wrap_value(self, fn, n_bins: int) -> "ScaleWrapped":
        """Wrap a base ``(params, raw) → (B,) logL`` built with
        ``self.base`` into the scale-marginalized likelihood. Exact:
        the base value IS ``−q/2 + log_norm``, so ``q`` is recovered
        and re-scored through the Student-t form, on the tensor the
        base returns: both backends and every kernel are reused
        unchanged, and the result stays differentiable by
        ``torch.autograd`` wherever the base is."""
        return ScaleWrapped(fn, self, n_bins, with_grad=False)

    def wrap_valgrad(self, fn, n_bins: int) -> "ScaleWrapped":
        """Value+gradient companion of :meth:`wrap_value` for a base
        ``(params, raw) → (logL (B,), ∇ (B, P))``: the chain rule is a
        per-row rescale ``∇logL_t = a/(β + q/2)·∇logL`` (d q = −2·d logL),
        so the analytic and fused gradient backends carry over exactly."""
        return ScaleWrapped(fn, self, n_bins, with_grad=True)

    def sample_noise(self, rng, n: int, *,
                     flat_coeff_scale: float = 100.0) -> np.ndarray:
        """Draw ``n`` realizations of this spec's own generative model —
        level draws ``σ²ᵢ ~ InvGamma(α, β)``, then ``σᵢ·ε`` with
        ``ε ~ N(0, base)`` (plus the base's foreground injection when it
        is a :class:`~tpu21cmvae_torch.foregrounds.MarginalizedNoise`: a
        proper coefficient prior is σ²-scaled per the conjugate
        convention, the flat prior's injection is level-free and the
        posterior is invariant to it). The data-generating counterpart
        a simulation-based calibration needs.
        Requires a PROPER prior: the improper Jeffreys prior cannot be
        sampled — pass ``alpha=``/``beta=``. Returns ``(n, n_bins)``
        float64."""
        if self.alpha is None:
            raise ValueError(
                "cannot generate from the improper Jeffreys level "
                "prior: build the spec with a proper prior "
                "(marginalize_noise_scale(..., alpha=, beta=))"
            )
        sig2 = float(self.beta) / rng.gamma(float(self.alpha), size=n)
        sig = np.sqrt(sig2)[:, None]
        if isinstance(self.base, MarginalizedNoise):
            nb = self.base.noise_var.shape[0]
            out = sig * rng.normal(
                0.0, np.sqrt(self.base.noise_var), (n, nb)
            )
            if self.base.prior_var is not None:
                a = sig * rng.normal(
                    size=(n, self.base.n_terms)
                ) * np.sqrt(self.base.prior_var)
            else:
                a = rng.normal(
                    0.0, flat_coeff_scale, (n, self.base.n_terms)
                )
            return out + a @ self.base.basis.T
        base = np.asarray(self.base, np.float64)
        nb = base.shape[0] if base.ndim else None
        if nb is None:
            raise ValueError(
                "sample_noise needs a per-bin base shape (scalar bases "
                "carry no bin count); broadcast it first: "
                "marginalize_noise_scale(np.full(n_bins, v), ...)"
            )
        return sig * rng.normal(0.0, np.sqrt(base), (n, nb))

    # -- post-inference diagnostics --

    def sigma2_posterior(self, residual):
        """Conditional posterior of the noise-level multiplier σ² given
        residual(s) ``r = d − m(θ)``: ``InvGamma(α + n_eff/2, β + q/2)``
        with ``q = rᵀN₀⁻¹r`` (foreground directions projected out for a
        MarginalizedNoise base). Returns ``(alpha_post, beta_post)``
        arrays (β rows for a ``(B, n)`` input) — mean ``β/(α−1)``, mode
        ``β/(α+1)``. Host-side float64; the "what noise level did the
        data prefer" readout after a fit."""
        r = np.atleast_2d(np.asarray(residual, np.float64))
        n_bins = r.shape[-1]
        if isinstance(self.base, MarginalizedNoise):
            if self.base.whiten.shape != (n_bins, n_bins):
                raise ValueError(
                    f"MarginalizedNoise built for "
                    f"{self.base.whiten.shape[0]} bins; residual has "
                    f"{n_bins}"
                )
            z = r @ self.base.whiten.astype(np.float64)
            q = np.sum(z * z, axis=-1)
        else:
            nv = np.broadcast_to(
                np.asarray(self.base, np.float64), (n_bins,)
            )
            q = np.sum(r * r / nv, axis=-1)
        a0 = 0.0 if self.alpha is None else float(self.alpha)
        b0 = 0.0 if self.beta is None else float(self.beta)
        alpha_post = a0 + 0.5 * self.n_eff(n_bins)
        beta_post = b0 + 0.5 * q
        if np.ndim(residual) == 1:
            beta_post = beta_post[0]
        return alpha_post, beta_post


class ScaleWrapped:
    """A base likelihood re-scored through a :class:`ScaleMarginalNoise`'s
    Student-t form (:meth:`ScaleMarginalNoise.wrap_value`,
    :meth:`~ScaleMarginalNoise.wrap_valgrad`): ``(params, raw) → logL``,
    or ``→ (logL, ∇logL)``. :attr:`base` is the wrapped callable, built
    with the spec's σ = 1 base noise; :attr:`launches` reads and sets the
    launch count of the kernel wrapper under it, so a CUDA run counts
    launches through this object as through the bare wrapper."""

    def __init__(self, base, spec: ScaleMarginalNoise, n_bins: int, *, with_grad: bool):
        self.base = base
        self.with_grad = with_grad
        self._ln0 = spec.base_log_norm()
        self._a = spec.shape_coef(n_bins)
        self._b = 0.0 if spec.beta is None else float(spec.beta)
        self._const = spec.log_norm_const(n_bins)

    @property
    def launches(self) -> int:
        return self.base.launches

    @launches.setter
    def launches(self, n: int):
        self.base.launches = n

    def _student_t(self, ll: torch.Tensor) -> torch.Tensor:
        """``t = max(β + q/2, a·_FLOOR_REL)`` from the base value: the
        floor keeps the Jeffreys zero-residual degeneracy finite without
        breaking base-scale invariance (see :data:`_FLOOR_REL`)."""
        q = 2.0 * (self._ln0 - ll)
        return torch.clamp_min(self._b + 0.5 * q, self._a * _FLOOR_REL)

    def __call__(self, params, raw):
        if not self.with_grad:
            t = self._student_t(self.base(params, raw))
            return self._const - self._a * torch.log(t)
        ll, g = self.base(params, raw)
        # the same floor as the value's, so value and gradient stay
        # consistent; a/t ≤ 1/_FLOOR_REL for any α, and the product is
        # clipped because the base gradient at a floored point is
        # rounding noise that 1e30× can push past the fp32 maximum
        t = self._student_t(ll)
        grad = torch.clamp((self._a / t)[..., None] * g, -_GMAX, _GMAX)
        return self._const - self._a * torch.log(t), grad


def marginalize_noise_scale(
    noise_var=1.0, *, alpha: Optional[float] = None,
    beta: Optional[float] = None,
) -> ScaleMarginalNoise:
    """Integrate the absolute noise level out of the Gaussian
    likelihood (module docstring has the math and conventions).

    ``noise_var``: the noise SHAPE at reference level σ²=1 — scalar,
    per-bin σ² vector, or a
    :class:`~tpu21cmvae_torch.foregrounds.MarginalizedNoise` (composes with
    foreground marginalization; a proper coefficient ``prior_var`` is
    then interpreted relative to σ² — conjugate convention).
    ``alpha``/``beta``: ``InvGamma(α, β)`` prior on the level
    multiplier; both ``None`` (default) = improper Jeffreys
    ``p(σ²) ∝ 1/σ²`` (posterior exact; absolute evidence arbitrary up
    to the improper prior's constant).

    Pass the result anywhere ``noise_var`` is accepted; both backends
    (plain PyTorch and the CUDA kernels), the analytic gradient, the
    stacked-observation form and the samplers inherit the
    marginalization as an exact scalar post-transform.
    """
    if (alpha is None) != (beta is None):
        raise ValueError(
            "alpha and beta must be given together (proper InvGamma "
            "prior) or both omitted (Jeffreys)"
        )
    if alpha is not None and not (alpha > 0 and beta > 0):
        raise ValueError(
            f"InvGamma prior needs alpha > 0 and beta > 0; got "
            f"alpha={alpha}, beta={beta}"
        )
    if isinstance(noise_var, ScaleMarginalNoise):
        raise ValueError("noise scale is already marginalized")
    if not isinstance(noise_var, MarginalizedNoise):
        nv = np.asarray(noise_var, np.float64)
        if nv.ndim > 1:
            raise ValueError(
                f"noise_var shape must be a scalar or per-bin vector; "
                f"got shape {nv.shape}"
            )
        if not (nv > 0).all():
            raise ValueError("noise_var must be positive")
        noise_var = float(nv) if nv.ndim == 0 else nv
    return ScaleMarginalNoise(
        base=noise_var,
        alpha=None if alpha is None else float(alpha),
        beta=None if beta is None else float(beta),
    )
