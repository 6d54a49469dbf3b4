"""Fisher-information forecasting for the emulated 21-cm signal (the
port of ``tpu21cmvae/ops/fisher.py``).

The standard companion to MCMC for global-signal experiments: for a
Gaussian likelihood with per-bin noise variance σ², the Fisher matrix at
parameters θ is

    F_ij = Σ_bins  (∂T/∂θ_i)(∂T/∂θ_j) / σ²_bin,

whose inverse lower-bounds the parameter covariance (Cramér–Rao). The
Jacobian ∂T/∂θ is forward-mode (``torch.func.jacfwd``: seven JVPs through
the predict chain, whatever the 451 output bins), exact, and batched over
fiducials by ``torch.func.vmap``.

Numerical note: the first three parameters enter through log10 and the
Jacobian is taken with respect to the RAW parameters (the physical
ones), so F can be badly scaled; :func:`forecast_errors` solves in
float64 on the host with a noise-floored eigendecomposition to stay
robust (and honest) near degeneracies.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu21cmvae_torch.noisescale import ScaleMarginalNoise
from tpu21cmvae_torch.ops.fold import noise_scale
from tpu21cmvae_torch.ops.mlp import mlp_apply
from tpu21cmvae_torch.ops.transforms import par_transform, unpreproc


def make_signal_jacobian(config, norm, precision="highest"):
    """Build ``fn(params, theta) → (n_bins, n_params)``: ∂T/∂θ at one
    raw parameter vector, a float32 tensor on ``norm``'s device (vmap it
    for batches). Forward mode over the input parameters."""
    activation = config.activation

    def predict_one(params, theta):
        x = par_transform(theta[None, :], norm)
        return unpreproc(mlp_apply(params, x, activation, precision), norm)[0]

    def jacobian(params, theta):
        return torch.func.jacfwd(lambda t: predict_one(params, t))(theta.to(torch.float32))

    return jacobian


def make_fisher(config, norm, noise_var=1.0, precision="highest"):
    """Build ``fn(params, theta) → (n_params, n_params)`` Fisher matrix
    at a raw parameter vector.

    ``noise_var`` accepts everything the likelihoods do:

    * scalar / per-bin σ² in mK²: the Gaussian ``Jᵀ N⁻¹ J``;
    * a :class:`~tpu21cmvae_torch.foregrounds.MarginalizedNoise`, exact:
      the foreground-marginalized likelihood is still Gaussian with
      precision ``P = R·Rᵀ``, so ``F = (RᵀJ)ᵀ(RᵀJ)`` (the K projected
      foreground directions carry zero signal information, P's null
      space, which is the honest forecast under a foreground fit);
    * a :class:`~tpu21cmvae_torch.noisescale.ScaleMarginalNoise` with a
      PROPER InvGamma(α, β) prior: the marginal is multivariate
      Student-t (dof ν = 2α, scale ``(β/α)·N₀``), whose location
      Fisher is the classical heavy-tail correction of the Gaussian
      one: ``F_t = (α/β)·(ν + n_eff)/(ν + n_eff + 2)·Jᵀ N₀⁻¹ J``
      (Lange, Little & Taylor 1989 eq. 2.5 form). ``α/β`` is the
      prior-mean precision multiplier; the ``<1`` t-factor is the
      information lost to the unknown level. Under the improper
      Jeffreys prior the marginal is scale-free, so a data-free Fisher
      is undefined: raises ``ValueError`` (forecast at an assumed
      level by passing the base spec instead).
    """
    jac = make_signal_jacobian(config, norm, precision=precision)

    scale = 1.0
    nv = noise_var
    if isinstance(nv, ScaleMarginalNoise):
        if nv.alpha is None:
            raise ValueError(
                "Fisher forecast under the improper Jeffreys level "
                "prior is undefined (the Student-t marginal's scale is "
                "fixed only by data): pass a proper prior "
                "(marginalize_noise_scale(..., alpha=, beta=)) or "
                "forecast at an assumed level with the base noise spec"
            )
        n_eff = float(nv.n_eff(config.n_bins))
        nu = 2.0 * float(nv.alpha)
        scale = float(nv.alpha) / float(nv.beta) * (nu + n_eff) / (nu + n_eff + 2.0)
        nv = nv.base
    whiten = noise_scale(nv, config.n_bins, device=norm.device)
    if whiten.ndim == 2:  # a MarginalizedNoise: P = R·Rᵀ

        def fisher(params, theta):
            JR = whiten.T @ jac(params, theta)  # (n_bins, n_params)
            return scale * (JR.T @ JR)

        return fisher

    invvar = scale * whiten * whiten

    def fisher(params, theta):
        J = jac(params, theta)  # (n_bins, n_params)
        return (J * invvar[:, None]).T @ J

    return fisher


def forecast_errors(F, rcond: float = 1e-6):
    """1-σ marginalized parameter uncertainties from a Fisher matrix:
    ``sqrt(diag(F⁻¹))`` via a float64 symmetric eigendecomposition on
    the host (F is tiny: (p, p) or batched (..., p, p)).

    F's entries come out of float32 accumulation, so eigenvalues below
    ``rcond·λ_max`` are numerical noise, not information. They are
    CLAMPED at that floor rather than zeroed: a pseudo-inverse treats
    an unconstrained direction as zero-variance (silently
    over-confident, and it lets float32 noise eigenvalues through,
    producing σ that SHRINKS when information is marginalized away),
    while clamping quotes the largest uncertainty the matrix actually
    resolves and keeps forecasts monotone under information loss
    (marginalizing a foreground or the noise level can only grow σ).
    Host-side NumPy: call it on results."""
    F = np.asarray(F, np.float64)
    w, v = np.linalg.eigh(F)
    wmax = np.max(np.abs(w), axis=-1, keepdims=True)
    w = np.maximum(w, rcond * wmax)
    cov_diag = np.einsum("...ij,...j,...ij->...i", v, 1.0 / w, v)
    return np.sqrt(cov_diag)
