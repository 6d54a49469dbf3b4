"""Point estimates on the posterior: multi-start MAP fits (:func:`fit_map`)
and profile likelihoods (:func:`profile_likelihood`) over one shared
whitened Adam ascent (the port of ``tpu21cmvae/sampling/fit.py``).

The ascent calls ``valgrad`` once per step and once more at the end, so
a fit of ``n_steps`` steps makes ``n_steps + 1`` likelihood calls (on a
CUDA model, K3 launches) whatever the number of starts. It is
deterministic once the starts are given. The JAX package runs it as one
``lax.scan``; here it is a Python loop whose tensors stay on the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpu21cmvae_torch.sampling._common import (
    _init_walkers,
    _log_prior_val_grad,
    _refuse_mesh,
    _resolve_bounds,
)


_B1, _B2, _EPS_ADAM = 0.9, 0.999, 1e-8


def cosine_rate(learning_rate: float, t: int, n_steps: int) -> float:
    """The fits' learning rate at 1-based step ``t``: cosine decay from
    ``learning_rate`` to 5 % of it."""
    return learning_rate * (0.05 + 0.95 * 0.5 * (1.0 + math.cos(math.pi * (t - 1.0) / n_steps)))


class Adam:
    """Adam ascent written out (β 0.9, 0.999; ε 1e-8 outside the square
    root; bias correction by the 1-based step ``t``), as in the JAX
    package's fits, over a list of tensors updated in place: the ascent
    here, ADVI and the flows. The moments are kept flat, so a step is a
    dozen tensor operations whatever the number of tensors (a flow has
    27)."""

    def __init__(self, params):
        self.params = list(params)
        self.sizes = [p.numel() for p in self.params]
        n = sum(self.sizes)
        self.m = self.params[0].new_zeros(n)
        self.v = self.params[0].new_zeros(n)

    def step(self, grads, t: int, lr: float):
        g = torch.cat([x.reshape(-1) for x in grads])
        self.m.mul_(_B1).add_((1 - _B1) * g)
        self.v.mul_(_B2).add_((1 - _B2) * g * g)
        upd = lr * (self.m / (1 - _B1**t)) / (torch.sqrt(self.v / (1 - _B2**t)) + _EPS_ADAM)
        torch._foreach_add_(self.params, [u.view_as(p) for u, p in
                                          zip(upd.split(self.sizes), self.params)])


def _whitened_adam_ascent(
    valgrad, params, lo, hi, x,
    *, n_steps, learning_rate, log_prior, free=None, jacobian=False,
):
    """Cosine-decayed Adam ascent (β 0.9, 0.999; the rate decays to 5 %
    of ``learning_rate``) on ``logL (+ log π)`` in the sigmoid-whitened
    box space, from the raw rows ``x`` on ``lo``'s device: the shared
    core of :func:`fit_map` and :func:`profile_likelihood` (and, once
    ported, Laplace evidence). ``free``: an optional (n_params,) 0/1
    mask; a 0 coordinate is pinned (no gradient, no movement) and starts
    from a tighter logit clip (1e-7 of the span, against 1e-4 for free
    ones), since nothing pulls it back. ``jacobian=True`` adds the
    sigmoid map's log-Jacobian, so the target is the density in ``y``
    rather than the raw-space likelihood. Non-finite gradients count as
    zero (a dead start is not a NaN for the others). Returns the device
    tensors ``(x_final, logp)``."""
    span = hi - lo
    frac = torch.clamp((x - lo) / span, 1e-4, 1.0 - 1e-4)
    if free is not None:
        pinned = torch.clamp((x - lo) / span, 1e-7, 1.0 - 1e-7)
        frac = torch.where(free.to(torch.bool), frac, pinned)
    y = torch.log(frac / (1.0 - frac))

    def ll_and_grad_y(y):
        s = torch.sigmoid(y)
        xr = lo + span * s
        ll, g_raw = valgrad(params, xr)
        if log_prior is not None:
            lpr, g_pr = _log_prior_val_grad(log_prior, xr)
            ll = ll + lpr
            g_raw = g_raw + g_pr
        g_y = g_raw * (span * s * (1.0 - s))
        if jacobian:
            ll = ll + torch.sum(F.logsigmoid(y) + F.logsigmoid(-y), dim=-1)
            g_y = g_y + (1.0 - 2.0 * s)
        if free is not None:
            g_y = g_y * free
        return ll, g_y

    adam = Adam([y])
    for t in range(1, n_steps + 1):
        _, g = ll_and_grad_y(y)
        # large early steps to cross the rugged landscape, small late ones
        # to polish the optimum below Adam's jitter
        adam.step([torch.where(torch.isfinite(g), g, 0.0)], t,
                  cosine_rate(learning_rate, t, n_steps))
    ll, _ = ll_and_grad_y(y)
    return lo + span * torch.sigmoid(y), ll


@dataclasses.dataclass
class FitResult:
    """Multi-start maximum-likelihood fit (:func:`fit_map`): ``params``,
    the final position of every start ``(n_starts, n_params)`` in raw
    units; ``logp``, its log-likelihood; ``best`` / ``best_logp``, the
    best start. Several modes show up as clusters in ``params`` with
    distinct ``logp`` plateaus."""

    params: np.ndarray
    logp: np.ndarray
    best: np.ndarray
    best_logp: float

    def top(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """The ``k`` best (params, logp) rows, best first."""
        order = np.argsort(-self.logp)[:k]
        return self.params[order], self.logp[order]

    def summary(self, labels=None) -> str:
        labels = labels or [f"p{i}" for i in range(self.params.shape[-1])]
        lines = [f"  {l:>8}: {v:12.6g}" for l, v in zip(labels, self.best)]
        return f"best logL {self.best_logp:.6g}\n" + "\n".join(lines)


def fit_map(
    valgrad,
    params,
    *,
    n_starts: int = 1024,
    n_steps: int = 300,
    bounds=None,
    learning_rate: float = 0.05,
    seed: int = 0,
    x0=None,
    log_prior=None,
    mesh=None,
    device,
) -> FitResult:
    """Multi-start maximum-likelihood fit: Adam ascent on
    ``valgrad(params, raw) → (logL, grad)`` from ``n_starts`` uniform
    draws in ``bounds`` (from a ``torch.Generator`` on ``device`` seeded
    with ``seed``), or from the rows ``x0``, all starts in each call.

    The ascent runs in the sigmoid-whitened space of :func:`sample_hmc`
    (iterates never leave the box) WITHOUT the prior's Jacobian: the
    optimum of the raw-space likelihood is wanted. ``learning_rate`` is in
    whitened units. ``log_prior``: a smooth log-density over the raw
    parameters; the ascent then maximizes ``logL + log π``. ``mesh`` takes one
    device (more wait for the port of ``parallel/``). Seed a sampler with
    ``x0=result.params``.
    """
    _refuse_mesh(mesh)
    device = torch.empty(0, device=device).device
    lo, hi = _resolve_bounds(bounds, device)
    x = (_init_walkers(torch.Generator(device=device).manual_seed(seed), n_starts, lo, hi)
         if x0 is None else torch.as_tensor(np.asarray(x0, np.float32), device=device))
    x_fin, ll = _whitened_adam_ascent(
        valgrad, params, lo, hi, x,
        n_steps=n_steps, learning_rate=learning_rate, log_prior=log_prior,
    )
    x_np, ll_np = x_fin.cpu().numpy(), ll.cpu().numpy()
    best = int(np.nanargmax(ll_np))
    return FitResult(params=x_np, logp=ll_np, best=x_np[best], best_logp=float(ll_np[best]))


@dataclasses.dataclass
class ProfileResult:
    """Profile-likelihood curve from :func:`profile_likelihood`:
    ``grid``, the scanned values of parameter ``index``; ``logl``, the
    profile ``max_{others} logL(grid_i, others)``; ``params``, the
    maximizing parameter vector at each grid point ``(G, n_params)``.
    :meth:`interval` gives the Wilks interval; an endpoint equal to
    ``grid[0]`` or ``grid[-1]`` is censored by the scanned range."""

    index: int
    grid: np.ndarray
    logl: np.ndarray
    params: np.ndarray

    def interval(self, level: float = 0.68) -> Tuple[float, float]:
        """The grid range where ``logl ≥ max(logl) − χ²₁(level)/2``, the
        crossings located by linear interpolation."""
        from scipy.stats import chi2

        if not 0.0 < level < 1.0:
            raise ValueError(f"level must be in (0, 1); got {level}")
        thresh = self.logl.max() - 0.5 * chi2.ppf(level, df=1)
        above = self.logl >= thresh
        if not above.any():  # pragma: no cover - thresh <= max always
            raise RuntimeError("no grid point above the Wilks threshold")
        i0, i1 = np.flatnonzero(above)[[0, -1]]
        lo = self.grid[0] if i0 == 0 else float(np.interp(
            thresh, self.logl[i0 - 1:i0 + 1], self.grid[i0 - 1:i0 + 1]))
        hi = self.grid[-1] if i1 == len(self.grid) - 1 else float(np.interp(
            -thresh, -self.logl[i1:i1 + 2], self.grid[i1:i1 + 2]))
        return float(lo), float(hi)


def profile_likelihood(
    valgrad,
    params,
    index: int,
    grid,
    *,
    n_starts: int = 256,
    n_steps: int = 300,
    bounds=None,
    learning_rate: float = 0.05,
    seed: int = 0,
    log_prior=None,
    mesh=None,
    device,
) -> ProfileResult:
    """Profile likelihood of parameter ``index``: for every value ``g`` in
    ``grid``, maximize ``logL(θ | θ_index = g)`` over the others. All
    ``len(grid) · n_starts`` constrained ascents run as one batch (the
    profiled coordinate pinned by masking its whitened gradient), so the
    scan makes ``n_steps + 1`` likelihood calls. ``log_prior`` profiles
    ``logL + log π``; ``mesh`` is refused. A start whose final value is
    not finite counts as ``-inf``, and the pinned value is restored
    exactly in ``params``."""
    _refuse_mesh(mesh)
    device = torch.empty(0, device=device).device
    lo, hi = _resolve_bounds(bounds, device)
    n_params = int(lo.shape[0])
    if not 0 <= index < n_params:
        raise ValueError(f"index must be in [0, {n_params}); got {index}")
    grid = np.asarray(grid, np.float32)
    if grid.ndim != 1 or grid.shape[0] < 2:
        raise ValueError("grid must be 1-D with >= 2 points")
    if (grid < lo[index].item()).any() or (grid > hi[index].item()).any():
        raise ValueError("grid values must lie inside the prior box")
    g_count = grid.shape[0]
    x = _init_walkers(torch.Generator(device=device).manual_seed(seed), g_count * n_starts,
                      lo, hi).reshape(g_count, n_starts, n_params)
    x[:, :, index] = torch.as_tensor(grid, device=device)[:, None]
    free = torch.ones((n_params,), dtype=torch.float32, device=device)
    free[index] = 0.0
    xr, ll = _whitened_adam_ascent(
        valgrad, params, lo, hi, x.reshape(-1, n_params),
        n_steps=n_steps, learning_rate=learning_rate, log_prior=log_prior, free=free,
    )
    xr = xr.cpu().numpy().reshape(g_count, n_starts, n_params)
    ll = ll.cpu().numpy().reshape(g_count, n_starts)
    ll = np.where(np.isfinite(ll), ll, -np.inf)
    best = ll.argmax(axis=1)
    rows = np.arange(g_count)
    out_params = xr[rows, best]
    out_params[:, index] = grid  # the sigmoid cannot land exactly on it
    return ProfileResult(index=index, grid=grid, logl=ll[rows, best], params=out_params)
