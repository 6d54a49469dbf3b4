"""Automatic-differentiation variational inference (ADVI): a full-rank
Gaussian posterior approximation fitted by stochastic ascent on the ELBO
(Kucukelbir et al. 2017) over the same value+gradient function as HMC
and the fits — the port of ``tpu21cmvae/vi.py``.

The Gaussian lives in the sigmoid-whitened space ``y = logit((x −
lo)/span)``, so draws never leave the prior box, and the map's Jacobian
``Σ log(span·s·(1−s))`` is part of the target (Stan's ADVI transform for
box constraints). Gradients are reparameterized (``y = μ + Lε``): the
y-gradient needs only the first-order ``valgrad``. ``L = tril(A, −1) +
diag(exp(d))``, so the entropy is ``Σ d`` plus a constant.

Each step is one ``valgrad`` call on ``n_mc`` draws (on a CUDA model, one
K3 launch) followed by Adam, written out as in the JAX package: ascent,
bias correction by the step number ``t``, and the cosine rate
``lr·(0.05 + 0.95·½(1 + cos(π(t−1)/n_steps)))``. A fit of ``n_steps``
steps makes exactly ``n_steps`` likelihood calls. The JAX package runs
the fit as one ``lax.scan``; here it is a Python loop whose tensors stay
on the device. One step (:func:`advi_step`) takes its normal draws as an
argument; :func:`fit_advi` draws them from a ``torch.Generator`` seeded
with ``seed`` through :func:`_normal`.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from tpu21cmvae_torch.sampling._common import _resolve_bounds
from tpu21cmvae_torch.sampling.fit import Adam, cosine_rate
from tpu21cmvae_torch.sampling.gradient import _whitened_center, _whitened_vi_target

__all__ = ["ADVIResult", "fit_advi", "fit_advi_batch"]

@dataclasses.dataclass
class ADVIResult:
    """Fitted full-rank Gaussian posterior approximation (whitened space)
    from :func:`fit_advi`.

    ``mu`` / ``chol``: the variational mean and Cholesky factor in the
    whitened space; ``elbo``: the per-step ELBO estimates (a flat tail
    means converged). In raw parameter units: :meth:`sample` (iid draws),
    :meth:`mean` / :meth:`std` (moments of the drawn cloud)."""

    mu: np.ndarray
    chol: np.ndarray
    elbo: np.ndarray
    _lo: np.ndarray
    _hi: np.ndarray

    def sample(self, n: int, seed: int = 0) -> np.ndarray:
        """``n`` iid raw-parameter draws from the fitted posterior."""
        rng = np.random.default_rng(seed)
        eps = rng.standard_normal((n, self.mu.shape[0]))
        y = self.mu + eps @ self.chol.T
        s = 1.0 / (1.0 + np.exp(-y))
        return (self._lo + (self._hi - self._lo) * s).astype(np.float32)

    def mean(self, n: int = 65536, seed: int = 0) -> np.ndarray:
        return self.sample(n, seed).mean(0)

    def std(self, n: int = 65536, seed: int = 0) -> np.ndarray:
        return self.sample(n, seed).std(0)


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard normal float32 draws of ``shape`` from ``gen`` (on its
    device): every random of the variational fits and the flow evidence
    (:mod:`tpu21cmvae_torch.flows` draws through this too)."""
    return torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)


def _chol(a, d, tril):
    """``tril(a, −1) + diag(exp(d))``, over an optional leading axis."""
    return a * tril + torch.diag_embed(torch.exp(d))


def advi_step(integrand, params, state, t: int, eps, *, n_steps: int, learning_rate: float):
    """One ADVI step from the normal draws ``eps`` ((n_mc, P), or (O,
    n_mc, P) for ``O`` stacked fits whose ``state`` carries a leading
    observation axis): the reparameterized ELBO gradients (entropy terms
    analytic), non-finite gradients counted as zero, then Adam over
    ``(mu, a, d)``. ``state`` is ``(mu, a, d, adam)``, ``adam`` a
    :class:`~tpu21cmvae_torch.sampling.fit.Adam` over the first three; it is updated in place. Returns
    the step's ELBO estimate (up to a constant), () or (O,)."""
    mu, a, d, adam = state
    p = mu.shape[-1]
    n_mc = eps.shape[-2]
    tril = torch.tril(torch.ones((p, p), dtype=mu.dtype, device=mu.device), -1)
    y = mu.unsqueeze(-2) + eps @ _chol(a, d, tril).transpose(-1, -2)
    f, g = integrand(params, y.reshape(-1, p))
    f, g = f.reshape(eps.shape[:-1]), g.reshape(eps.shape)
    g = torch.where(torch.isfinite(g), g, 0.0)
    g_mu = g.mean(dim=-2)
    g_full = g.transpose(-1, -2) @ eps / n_mc
    g_a = g_full * tril
    g_d = torch.diagonal(g_full, dim1=-2, dim2=-1) * torch.exp(d) + 1.0  # +1: entropy Σd
    elbo = f.mean(dim=-1) + torch.sum(d, dim=-1)
    adam.step([g_mu, g_a, g_d], t, cosine_rate(learning_rate, t, n_steps))
    return elbo


@torch.no_grad()
def run_advi(integrand, params, mu, a, d, *, n_steps: int, learning_rate: float, draw):
    """``n_steps`` ADVI steps from ``(mu, a, d)``; ``draw(t)`` gives step
    ``t``'s normal draws. Returns the final ``(mu, L, elbo)`` as tensors,
    ``elbo`` (n_steps,) or (n_steps, O)."""
    mu, a, d = mu.clone(), a.clone(), d.clone()
    state = (mu, a, d, Adam([mu, a, d]))
    elbo = torch.empty((n_steps, *mu.shape[:-1]), dtype=mu.dtype, device=mu.device)
    for t in range(1, n_steps + 1):
        elbo[t - 1] = advi_step(integrand, params, state, t, draw(t),
                                n_steps=n_steps, learning_rate=learning_rate)
    p = mu.shape[-1]
    tril = torch.tril(torch.ones((p, p), dtype=mu.dtype, device=mu.device), -1)
    return mu, _chol(a, d, tril), elbo


def _start(lo, batch: tuple, device):
    """The wide diagonal start: ``d = log 1.5`` (sigmoid(±1.5) spans ~60 %
    of the box), ``a = 0``."""
    p = int(lo.shape[0])
    d0 = torch.full((*batch, p), math.log(1.5), dtype=torch.float32, device=device)
    a0 = torch.zeros((*batch, p, p), dtype=torch.float32, device=device)
    return a0, d0


def fit_advi(
    valgrad,
    params,
    *,
    n_steps: int = 600,
    n_mc: int = 512,
    bounds=None,
    learning_rate: float = 0.05,
    seed: int = 0,
    x0=None,
    log_prior=None,
    device,
) -> ADVIResult:
    """Fit a full-rank Gaussian posterior approximation by ADVI.

    ``valgrad(params, raw) → (logL, ∇logL)``: the value+gradient function
    (``model.loglik_and_grad_fn``; K3 on a CUDA model). ``x0``: an
    optional raw-space center for the variational mean (e.g.
    ``fit_map(...).best``), default the box center. ``log_prior`` adds a
    smooth prior to the target. The normal draws come from a
    ``torch.Generator`` on ``device`` seeded with ``seed``. Returns an
    :class:`ADVIResult`."""
    device = torch.empty(0, device=device).device
    lo, hi = _resolve_bounds(bounds, device)
    p = int(lo.shape[0])
    lo_np, hi_np = lo.cpu().numpy(), hi.cpu().numpy()
    mu0 = (torch.zeros((p,), dtype=torch.float32, device=device) if x0 is None
           else _whitened_center(x0, lo_np, hi_np, device))
    a0, d0 = _start(lo, (), device)
    integrand = _whitened_vi_target(valgrad, lo, hi - lo, log_prior, span_jac=True)
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(t):
        return _normal(gen, (n_mc, p))

    mu, L, elbo = run_advi(integrand, params, mu0, a0, d0, n_steps=n_steps,
                           learning_rate=learning_rate, draw=draw)
    return ADVIResult(mu=mu.cpu().numpy(), chol=L.cpu().numpy(), elbo=elbo.cpu().numpy(),
                      _lo=lo_np.astype(np.float64), _hi=hi_np.astype(np.float64))


def _row_centers(x0, n_obs: int, lo, hi):
    """``(n_obs, P)`` raw-space centers → whitened float32 rows, the logit
    on the host in float64, clipped 1e-4 of the span inside the box."""
    x0 = np.atleast_2d(np.asarray(x0, np.float64))
    if x0.shape != (n_obs, lo.shape[0]):
        raise ValueError(f"x0 must be ({n_obs}, {lo.shape[0]}) row centers; got {x0.shape}")
    lo64 = np.asarray(lo, np.float64)
    span64 = np.asarray(hi, np.float64) - lo64
    frac = np.clip((x0 - lo64) / span64, 1e-4, 1.0 - 1e-4)
    return np.log(frac / (1.0 - frac))


def fit_advi_batch(
    valgrad_multi,
    params,
    n_obs: int,
    *,
    n_steps: int = 600,
    n_mc: int = 512,
    bounds=None,
    learning_rate: float = 0.05,
    seed: int = 0,
    x0=None,
    log_prior=None,
    device,
) -> list:
    """Batched :func:`fit_advi`: ``n_obs`` independent full-rank Gaussians,
    one per observation of a stacked likelihood ``valgrad_multi(params,
    raw (O·W, P)) → ((O·W,), (O·W, P))``, every step ONE
    observation-major ``(n_obs·n_mc)``-row call. ``x0``: optional ``(n_obs,
    P)`` raw-space centers. Returns ``n_obs`` :class:`ADVIResult`. Rows do
    not reproduce sequential :func:`fit_advi` calls draw for draw (the
    draws differ), but converge to the same optimum."""
    device = torch.empty(0, device=device).device
    lo, hi = _resolve_bounds(bounds, device)
    p = int(lo.shape[0])
    lo_np, hi_np = lo.cpu().numpy(), hi.cpu().numpy()
    if x0 is not None:
        mu0 = torch.as_tensor(_row_centers(x0, n_obs, lo_np, hi_np).astype(np.float32),
                              device=device)
    else:
        mu0 = torch.zeros((n_obs, p), dtype=torch.float32, device=device)
    a0, d0 = _start(lo, (n_obs,), device)
    integrand = _whitened_vi_target(valgrad_multi, lo, hi - lo, log_prior, span_jac=True)
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(t):
        return _normal(gen, (n_obs, n_mc, p))

    mu, L, elbo = run_advi(integrand, params, mu0, a0, d0, n_steps=n_steps,
                           learning_rate=learning_rate, draw=draw)
    mu, L, elbo = mu.cpu().numpy(), L.cpu().numpy(), elbo.cpu().numpy()
    lo64, hi64 = lo_np.astype(np.float64), hi_np.astype(np.float64)
    return [ADVIResult(mu=mu[o], chol=L[o], elbo=elbo[:, o], _lo=lo64, _hi=hi64)
            for o in range(n_obs)]
