"""Analytic foreground marginalization (a NumPy copy of
``tpu21cmvae/foregrounds.py``): joint signal+foreground inference at the
cost of signal-only inference.

Every real global-21-cm measurement fits the cosmological signal UNDER
a bright astrophysical foreground (10²-10⁴ K of galactic synchrotron
against a ~0.1 K trough): EDGES' linearized power law (Bowman et al.
2018, Nature 555, eq. 2), the "linlog" damped-log-polynomial family
(Hills et al. 2018, Nature 564; Bevins et al. 2021, MNRAS 502), or
plain polynomials. The standard pipeline SAMPLES the foreground
coefficients jointly with the 7 astrophysical parameters: k extra
dimensions in every chain.

This module removes the foreground dimensions exactly. For a LINEAR
foreground model ``d = m(θ) + F a + n`` with ``n ~ N(0, N)`` and a
Gaussian (or improper-flat) prior on the coefficients ``a``, the
marginal likelihood over ``a`` is itself Gaussian in the residual
``r = d − m(θ)``:

    log L(θ) = −½ · rᵀ P r + const,
    P = N⁻¹ − N⁻¹ F (FᵀN⁻¹F + S⁻¹)⁻¹ FᵀN⁻¹   (Woodbury; S⁻¹ = 0 flat)

i.e. still a quadratic form, now with a rank-deficient precision ``P``
that projects out the foreground directions. ``P = R Rᵀ`` is factored
ONCE on the host (eigendecomposition, float64) and ``R`` folds into the
emulator's linear output layer exactly like the diagonal noise whitening
(:func:`tpu21cmvae_torch.ops.fold.fold_loglik_constants`): ``W̃ = W @ R``.
In gram form ``G = W̃W̃ᵀ`` keeps its shape, so the plain gram path, the
analytic gradient, the CUDA kernels K1, K2 and K3 and the
stacked-observation form all accept a :class:`MarginalizedNoise`
wherever they accept ``noise_var``, at the same widths.

Conventions: this package's plain likelihood is the unnormalized
``−½ rᵀN⁻¹r`` (the θ-independent ``−½ log|2πN|`` dropped). The
marginalized likelihood drops the SAME constant: with a proper
coefficient prior, ``log_norm = −½ log|I + S·FᵀN⁻¹F|``; with a flat
prior, ``log_norm = (k/2)·log 2π − ½ log|FᵀN⁻¹F|`` (flat-prior evidences
depend on the coefficient parameterization; use ``prior_var`` for
publishable Bayes factors).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = [
    "MarginalizedNoise",
    "foreground_basis",
    "linlog_basis",
    "marginalize_foreground",
    "polynomial_basis",
    "powerlaw_basis",
]


def foreground_basis(freqs_mhz, n_terms: int, kind: str = "linlog", *,
                     nu_ref: Optional[float] = None) -> np.ndarray:
    """Named-family dispatcher: ``"linlog"`` (:func:`linlog_basis`),
    ``"powerlaw"`` (:func:`powerlaw_basis`), or ``"polynomial"``
    (:func:`polynomial_basis`; ``nu_ref`` not applicable)."""
    if kind == "linlog":
        return linlog_basis(freqs_mhz, n_terms, nu_ref=nu_ref)
    if kind == "powerlaw":
        return powerlaw_basis(freqs_mhz, n_terms, nu_ref=nu_ref)
    if kind == "polynomial":
        if nu_ref is not None:
            raise ValueError("nu_ref does not apply to the polynomial basis")
        return polynomial_basis(freqs_mhz, n_terms)
    raise ValueError(
        f"kind must be 'linlog', 'powerlaw' or 'polynomial'; got {kind!r}"
    )


def polynomial_basis(freqs_mhz, n_terms: int) -> np.ndarray:
    """Legendre-polynomial columns ``P_i(x)``, ``x`` the frequency axis
    affinely mapped to [−1, 1] — the generic well-conditioned smooth
    baseline (monomials above degree ~6 lose float64 digits in
    ``FᵀN⁻¹F``). Shape ``(n_bins, n_terms)``, float64."""
    nu = np.asarray(freqs_mhz, np.float64)
    if n_terms < 1:
        raise ValueError(f"n_terms must be >= 1; got {n_terms}")
    x = 2.0 * (nu - nu.min()) / (nu.max() - nu.min()) - 1.0
    cols = [np.polynomial.legendre.Legendre.basis(i)(x)
            for i in range(n_terms)]
    return np.stack(cols, axis=1)


def powerlaw_basis(freqs_mhz, n_terms: int, *, beta: float = -2.505,
                   nu_ref: Optional[float] = None) -> np.ndarray:
    """EDGES-style linearized power-law foreground (Bowman et al. 2018,
    Nature 555, eq. 2): columns ``(ν/ν_ref)^(β+i)``, i = 0..k−1 — a
    Taylor expansion of the synchrotron spectral index around ``β``.
    ``nu_ref`` defaults to the band center. Shape ``(n_bins, n_terms)``,
    float64."""
    nu = np.asarray(freqs_mhz, np.float64)
    if n_terms < 1:
        raise ValueError(f"n_terms must be >= 1; got {n_terms}")
    ref = float(nu_ref) if nu_ref is not None else float(
        0.5 * (nu.min() + nu.max())
    )
    x = nu / ref
    return np.stack([x ** (beta + i) for i in range(n_terms)], axis=1)


def linlog_basis(freqs_mhz, n_terms: int, *,
                 nu_ref: Optional[float] = None) -> np.ndarray:
    """"Linlog" foreground (Hills et al. 2018, Nature 564; Bevins et
    al. 2021, MNRAS 502): columns ``(ν/ν_ref)^{-2.5} · log(ν/ν_ref)^i``
    — a power-law envelope times a polynomial in log-frequency, the
    damped family designed so adding terms does not absorb the 21-cm
    trough the way plain polynomials do. Shape ``(n_bins, n_terms)``,
    float64."""
    nu = np.asarray(freqs_mhz, np.float64)
    if n_terms < 1:
        raise ValueError(f"n_terms must be >= 1; got {n_terms}")
    ref = float(nu_ref) if nu_ref is not None else float(
        0.5 * (nu.min() + nu.max())
    )
    x = nu / ref
    env = x ** (-2.5)
    lx = np.log(x)
    return np.stack([env * lx**i for i in range(n_terms)], axis=1)


@dataclasses.dataclass(frozen=True)
class MarginalizedNoise:
    """Foreground-marginalized Gaussian noise model — pass it anywhere
    a ``noise_var`` is accepted (``loglik_fn``, ``loglik_and_grad_fn``,
    ``sample_posterior``, ``fisher_forecast`` …) to score parameters under
    ``d = m(θ) + F a + n`` with the coefficients ``a`` integrated out
    exactly. Build with :func:`marginalize_foreground`.

    ``whiten`` is the host-precomputed factor ``R`` with ``P = R Rᵀ``
    (square ``(n_bins, n_bins)``, rank ``n_bins − k`` for a flat
    coefficient prior — the zero eigenvalues ARE the marginalization);
    the likelihood paths fold it into the emulator's linear output
    layer, so the per-sample work keeps its shape. ``log_norm``
    is the θ-independent normalization in this package's dropped-constant
    convention (see module docstring) — it cancels in posterior
    sampling and shifts evidences exactly as the marginal density
    requires.
    """

    whiten: np.ndarray        # (n_bins, n_bins) float32, P = R·Rᵀ
    log_norm: float
    basis: np.ndarray         # (n_bins, k) float64
    noise_var: np.ndarray     # per-bin σ² (n_bins,) float64
    prior_var: Optional[np.ndarray]  # (k,) float64, or None = flat

    @property
    def n_terms(self) -> int:
        return int(self.basis.shape[1])

    def memo_key(self) -> tuple:
        """Value-identity key for the model-level program memos
        (:mod:`tpu21cmvae_torch.models._memo`)."""
        return (
            "fgmarg",
            self.basis.tobytes(),
            self.noise_var.tobytes(),
            None if self.prior_var is None else self.prior_var.tobytes(),
        )

    def coeff_posterior(self, residual):
        """Posterior of the foreground coefficients given residual(s)
        ``r = d − m(θ)``: mean ``A⁻¹FᵀN⁻¹r`` (rows for a ``(B, n)``
        input) and covariance ``A⁻¹`` (shared). Flat prior → this is
        the GLS fit. Use ``basis @ mean`` to reconstruct / subtract
        the inferred foreground."""
        r = np.atleast_2d(np.asarray(residual, np.float64))
        fn = self.basis / self.noise_var[:, None]   # N⁻¹F, (n, k)
        a = self.basis.T @ fn
        if self.prior_var is not None:
            a = a + np.diag(1.0 / self.prior_var)
        cov = np.linalg.inv(a)
        mean = r @ fn @ cov.T
        if np.ndim(residual) == 1:
            mean = mean[0]
        return mean, cov

    def reconstruct(self, coeffs) -> np.ndarray:
        """Foreground spectrum ``F @ a`` for coefficient row(s)."""
        return np.asarray(coeffs, np.float64) @ self.basis.T

    def sample_noise(self, rng, n: int, *,
                     flat_coeff_scale: float = 100.0) -> np.ndarray:
        """Draw ``n`` realizations of this spec's own generative model,
        ``F·a + ε`` with ``ε ~ N(0, noise_var)`` — the data-generating
        counterpart a simulation-based calibration needs. Coefficients come from
        the proper Gaussian prior when one was given; under the flat
        prior they are drawn ``N(0, flat_coeff_scale²)`` — the
        marginal posterior is EXACTLY invariant to the injected
        foreground (``P·F = 0``), so the choice cannot move the ranks,
        and a large injection makes the certificate exercise the
        invariance for real. Returns ``(n, n_bins)`` float64."""
        eps = rng.normal(
            0.0, np.sqrt(self.noise_var), (n, self.noise_var.shape[0])
        )
        if self.prior_var is not None:
            a = rng.normal(size=(n, self.n_terms)) * np.sqrt(
                self.prior_var
            )
        else:
            a = rng.normal(0.0, flat_coeff_scale, (n, self.n_terms))
        return eps + a @ self.basis.T


def marginalize_foreground(
    basis,
    noise_var=1.0,
    *,
    n_bins: Optional[int] = None,
    prior_var=None,
) -> MarginalizedNoise:
    """Integrate a linear foreground out of the Gaussian likelihood.

    ``basis``: ``(n_bins, k)`` design matrix ``F`` (columns =
    foreground modes — :func:`linlog_basis` / :func:`powerlaw_basis` /
    :func:`polynomial_basis`, or any user matrix, e.g. measured beam
    chromaticity modes). ``noise_var``: scalar or per-bin σ² in mK².
    ``prior_var``: per-coefficient Gaussian prior variances (scalar or
    ``(k,)``); ``None`` (default) = improper flat prior, under which
    the marginalized likelihood is EXACTLY invariant to adding any
    ``F·a`` to the observation (``P·F = 0``).

    All linear algebra runs here, once, in float64 on the host (an
    eigendecomposition of the 451×451 ``P`` — microseconds); the
    returned :class:`MarginalizedNoise` carries the float32 factor the
    device paths fold into the output layer: a one-time fold.
    """
    f = np.asarray(basis, np.float64)
    if f.ndim != 2:
        raise ValueError(f"basis must be (n_bins, k); got shape {f.shape}")
    n, k = f.shape
    if n_bins is not None and n != n_bins:
        raise ValueError(
            f"basis has {n} rows but n_bins={n_bins}"
        )
    if k >= n:
        raise ValueError(
            f"need fewer foreground terms than bins; got k={k}, n={n}"
        )
    nv = np.broadcast_to(np.asarray(noise_var, np.float64), (n,)).copy()
    if not (nv > 0).all():
        raise ValueError("noise_var must be positive")
    fn = f / nv[:, None]                       # N⁻¹F
    ftnf = f.T @ fn                            # FᵀN⁻¹F, (k, k)
    if prior_var is not None:
        pv = np.broadcast_to(
            np.asarray(prior_var, np.float64), (k,)
        ).copy()
        if not (pv > 0).all():
            raise ValueError("prior_var must be positive")
        a = ftnf + np.diag(1.0 / pv)
        # log|I + S·FᵀN⁻¹F| = log|S·A| = Σ log pv + log|A|
        sign, logdet_a = np.linalg.slogdet(a)
        log_norm = -0.5 * (np.sum(np.log(pv)) + logdet_a)
    else:
        pv = None
        a = ftnf
        sign, logdet_a = np.linalg.slogdet(a)
        if sign <= 0:
            raise ValueError(
                "FᵀN⁻¹F is singular — foreground columns are linearly "
                "dependent; drop terms or add a prior_var"
            )
        log_norm = 0.5 * k * np.log(2.0 * np.pi) - 0.5 * logdet_a
    # P = N⁻¹ − (N⁻¹F) A⁻¹ (N⁻¹F)ᵀ, assembled via a solve (no inverse)
    p = np.diag(1.0 / nv) - fn @ np.linalg.solve(a, fn.T)
    p = 0.5 * (p + p.T)
    lam, vec = np.linalg.eigh(p)
    # clip the k exactly-marginalized (or prior-shrunk) directions'
    # roundoff negatives; scale-relative threshold
    lam = np.where(lam > 1e-12 * lam.max(), lam, 0.0)
    whiten = (vec * np.sqrt(lam)).astype(np.float32)
    return MarginalizedNoise(
        whiten=whiten,
        log_norm=float(log_norm),
        basis=f,
        noise_var=nv,
        prior_var=pv,
    )
