"""HMC over a value+gradient likelihood (the port of
``tpu21cmvae/sampling/gradient.py::sample_hmc`` and its helpers).

Sampling happens in the sigmoid-whitened ``y``-space of the prior box
(the flat box prior is exact through the Jacobian term). Warmup adapts a
per-block leapfrog step by dual averaging (Hoffman & Gelman 2014, Alg. 5;
γ = 0.05, t₀ = 10, κ = 0.75), in two phases when preconditioning: halfway
through, the leapfrog rescales by the cross-walker spread of ``y`` (the
ensemble metric) and dual averaging restarts. Each iteration draws its
leapfrog count uniformly from ⌈L/2⌉…L. The JAX package runs each phase as
one ``lax.scan``; here they are Python loops whose tensors stay on the
device, so nothing waits for the device until the results are copied out.
One step (:func:`hmc_step`) takes its randoms as arguments, so a test can
feed both packages the same draws.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from tpu21cmvae_torch.sampling._common import (
    _dual_averaging_consts,
    _init_walkers,
    _log_prior_val_grad,
    _resolve_bounds,
    _thin_state,
    _thin_write,
)
from tpu21cmvae_torch.sampling.results import SampleResult

_, _GAMMA, _T0, _KAPPA = _dual_averaging_consts(1.0)  # Hoffman & Gelman 2014


def _whiten_init(x, lo, span):
    """Raw box coordinates → unbounded sigmoid-whitened ``y`` (clipped
    1e-4 inside the box so boundary starts stay finite)."""
    frac = torch.clamp((x - lo) / span, 1e-4, 1.0 - 1e-4)
    return torch.log(frac / (1.0 - frac))


def _whitened_target(valgrad, log_prior, lo, span):
    """``(to_params, logp_and_grad)`` over the whitened ``y``: ``lp`` is
    the log-posterior including the log-Jacobian of the sigmoid map,
    ``glp`` its gradient by the chain rule: the one place where the
    raw-space ``valgrad`` and an optional smooth ``log_prior`` (value and
    gradient, :func:`_log_prior_val_grad`) meet the whitening."""

    def to_params(y):
        return lo + span * torch.sigmoid(y)

    def logp_and_grad(params, y):
        xr = to_params(y)
        ll, g_raw = valgrad(params, xr)
        if log_prior is not None:
            lpr, g_pr = _log_prior_val_grad(log_prior, xr)
            ll = ll + lpr
            g_raw = g_raw + g_pr
        s = torch.sigmoid(y)
        lp = ll + torch.sum(F.logsigmoid(y) + F.logsigmoid(-y), dim=-1)
        glp = g_raw * (span * s * (1.0 - s)) + (1.0 - 2.0 * s)
        return lp, glp

    return to_params, logp_and_grad


def _ens_metric(y, dense: bool):
    """Ensemble metric from the cross-walker spread of ``y``: per-dimension
    std normalized to unit geometric mean and clipped to [0.1, 10]
    (diagonal), or the symmetric square root of the covariance with its
    eigenvalues normalized the same way and clipped to [0.01, 100]
    (dense)."""
    if not dense:
        raw_sd = torch.std(y, dim=0, correction=0)
        sd = raw_sd / torch.clamp(
            torch.exp(torch.mean(torch.log(torch.clamp(raw_sd, min=1e-6)))), min=1e-6
        )
        return torch.clamp(sd, 0.1, 10.0)
    d = y.shape[1]
    yc = y - torch.mean(y, dim=0)
    cov = yc.T @ yc / y.shape[0] + 1e-10 * torch.eye(d, dtype=y.dtype, device=y.device)
    w, v = torch.linalg.eigh(cov)
    w = torch.clamp(w, min=1e-12)
    w = torch.clamp(w / torch.exp(torch.mean(torch.log(w))), 1e-2, 1e2)
    return (v * torch.sqrt(w)) @ v.T


def _met_scale(met, v):
    """Metric-space momentum → y-space displacement (``L v``): ``met`` is
    a diagonal ((D,) or (B, D)) or a (1|B, D, D) square root."""
    if met.ndim <= 2:
        return v * met
    return torch.matmul(met, v[..., None]).squeeze(-1)


def _met_pull(met, g):
    """y-space gradient → metric-space force (``Lᵀ g``)."""
    if met.ndim <= 2:
        return g * met
    return torch.matmul(met.transpose(-1, -2), g[..., None]).squeeze(-1)


def _ens_metric_blocks(y, dense: bool, n_blk: int):
    """The ensemble metric over one block of walkers; a dense metric is
    lifted to (1, D, D) so rank tells it from a per-walker diagonal.
    Per-observation blocks (``n_blk > 1``) wait for the batched samplers
    (ROADMAP queue 1 item 4)."""
    if n_blk != 1:
        raise NotImplementedError(
            "per-block ensemble metrics are not ported yet (ROADMAP queue 1 item 4)"
        )
    met = _ens_metric(y, dense)
    return met[None] if dense else met


def _resolve_metric(metric, precondition, n_warmup, n_walkers, auto_dense):
    """``(use_metric, dense)``: the metric needs ≥ 16 walkers and ≥ 20
    warmup steps; ``"auto"`` resolves to ``auto_dense`` (diagonal for
    HMC)."""
    if metric not in ("auto", "dense", "diag"):
        raise ValueError(f'metric must be "auto", "dense" or "diag"; got {metric!r}')
    use_metric = precondition and n_warmup >= 20 and n_walkers >= 16
    dense = metric == "dense" or (metric == "auto" and auto_dense)
    return use_metric, use_metric and dense


def hmc_step(logp_and_grad, params, y, lp, glp, met, eps_blk, n_leap: int, p0, log_u):
    """One HMC transition of every walker with ``n_leap`` leapfrog steps,
    given the momenta ``p0`` (B, D) and the log-uniforms ``log_u`` (B,).
    ``eps_blk``: (n_blk,) per-block steps over contiguous walker blocks.
    Returns ``(y, lp, glp, per-block mean acceptance probability)``."""
    n_blk = eps_blk.shape[0]
    eps = torch.repeat_interleave(eps_blk, y.shape[0] // n_blk)[:, None]
    p = p0 + 0.5 * eps * _met_pull(met, glp)
    q, g = y, glp
    for _ in range(n_leap - 1):
        q = q + eps * _met_scale(met, p)
        _, g = logp_and_grad(params, q)
        p = p + eps * _met_pull(met, g)
    q = q + eps * _met_scale(met, p)
    lp_new, g_new = logp_and_grad(params, q)
    p = p + 0.5 * eps * _met_pull(met, g_new)
    dh = (lp_new - lp) - 0.5 * (torch.sum(p**2, -1) - torch.sum(p0**2, -1))
    acc = log_u < dh
    # recover walkers whose current lp is not finite
    acc = acc | (~torch.isfinite(lp) & torch.isfinite(lp_new))
    y = torch.where(acc[:, None], q, y)
    lp = torch.where(acc, lp_new, lp)
    glp = torch.where(acc[:, None], g_new, glp)
    # Metropolis probability capped at 1; a diverged (non-finite) dh counts 0
    a = torch.where(torch.isfinite(dh), torch.clamp(torch.exp(dh), max=1.0), 0.0)
    return y, lp, glp, a.reshape(n_blk, -1).mean(dim=1)


def _dual_averaging(step, y, lp, glp, met, eps0, n_iter: int, target_accept: float):
    """``n_iter`` adapting steps from ``eps0`` (per block); returns the
    state and the averaged step ``exp(log_eps_bar)``."""
    mu = torch.log(10.0 * eps0)
    log_eps = torch.log(eps0)
    log_eps_bar = torch.log(eps0)
    h_bar = torch.zeros_like(eps0)
    for i in range(n_iter):
        y, lp, glp, a_mean = step(y, lp, glp, met, torch.exp(log_eps))
        t = i + 1.0
        h_bar = (1.0 - 1.0 / (t + _T0)) * h_bar + (target_accept - a_mean) / (t + _T0)
        log_eps = mu - math.sqrt(t) / _GAMMA * h_bar
        w = t ** (-_KAPPA)
        log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
    return y, lp, glp, torch.exp(log_eps_bar)


def sample_hmc(
    valgrad,
    params,
    *,
    n_walkers: int = 4096,
    n_steps: int = 200,
    n_warmup: int = 100,
    n_leapfrog: int = 8,
    bounds=None,
    target_accept: float = 0.8,
    init_step: float = 0.01,
    adapt_blocks: int = 1,
    thin: int = 5,
    seed: int = 0,
    x0=None,
    jitter: bool = True,
    precondition: bool = True,
    metric: str = "auto",
    log_prior=None,
    device,
) -> SampleResult:
    """HMC ensemble over ``valgrad(params, raw) → (logL, dlogL/draw)``.

    ``n_walkers`` walkers start uniformly in ``bounds`` (or at ``x0``);
    momenta, accept draws and walker starts come from a
    ``torch.Generator`` on ``device`` seeded with ``seed``, the jittered
    leapfrog counts from a host generator with the same seed.
    ``adapt_blocks=G`` keeps G independent dual-averaged steps over
    contiguous walker blocks. ``precondition``/``metric``: the
    ensemble-statistics metric (diagonal under ``"auto"``); ``jitter``:
    draw each iteration's leapfrog count from ⌈L/2⌉…L. ``log_prior``: a
    smooth log-density over the raw parameters on top of the flat box
    (:class:`~tpu21cmvae_torch.priors.GaussianBoxPrior`); its gradient,
    by ``torch.autograd``, joins the leapfrog force. Returns a
    :class:`SampleResult` with the chain thinned by ``thin``.
    """
    device = torch.empty(0, device=device).device
    lo, hi = _resolve_bounds(bounds, device)
    span = hi - lo
    if n_walkers % adapt_blocks:
        raise ValueError(
            f"n_walkers ({n_walkers}) must divide into adapt_blocks "
            f"({adapt_blocks}) equal contiguous blocks"
        )
    gen = torch.Generator(device=device).manual_seed(seed)
    host = torch.Generator().manual_seed(seed)
    x = (
        _init_walkers(gen, n_walkers, lo, hi)
        if x0 is None
        else torch.as_tensor(np.asarray(x0, np.float32), device=device)
    )
    y = _whiten_init(x, lo, span)
    use_metric, dense = _resolve_metric(
        metric, precondition, n_warmup, y.shape[0], auto_dense=False
    )
    n_warm1 = n_warmup // 2 if use_metric else n_warmup
    to_params, logp_and_grad = _whitened_target(valgrad, log_prior, lo, span)
    l_min = max(1, (n_leapfrog + 1) // 2)

    def step(y, lp, glp, met, eps):
        n_leap = n_leapfrog
        if jitter and l_min != n_leapfrog:
            n_leap = int(torch.randint(l_min, n_leapfrog + 1, (), generator=host))
        p0 = torch.randn(y.shape, generator=gen, device=device, dtype=y.dtype)
        log_u = torch.log(
            torch.rand((y.shape[0],), generator=gen, device=device, dtype=y.dtype)
        )
        return hmc_step(logp_and_grad, params, y, lp, glp, met, eps, n_leap, p0, log_u)

    lp, glp = logp_and_grad(params, y)
    met = torch.ones((y.shape[1],), dtype=y.dtype, device=device)
    eps = torch.full((adapt_blocks,), init_step, dtype=torch.float32, device=device)
    if n_warm1 > 0:
        y, lp, glp, eps = _dual_averaging(step, y, lp, glp, met, eps, n_warm1,
                                          target_accept)
    if use_metric:
        met = _ens_metric_blocks(y, dense, 1)
        y, lp, glp, eps = _dual_averaging(step, y, lp, glp, met, eps,
                                          n_warmup - n_warm1, target_accept)
    _, buf = _thin_state(n_steps, thin, y)
    rates = torch.empty((n_steps,), dtype=torch.float32, device=device)
    for t in range(n_steps):
        y, lp, glp, a_mean = step(y, lp, glp, met, eps)
        _thin_write(buf, t, to_params(y), thin)
        rates[t] = a_mean.mean()
    return SampleResult(
        chain=buf.cpu().numpy(),
        final=to_params(y).cpu().numpy(),
        logp=lp.cpu().numpy(),
        accept_rate=rates.cpu().numpy(),
        step_size=float(eps.mean()),
        block_step_sizes=eps.cpu().numpy(),
    )
