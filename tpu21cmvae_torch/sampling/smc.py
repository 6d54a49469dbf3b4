"""Adaptive-temperature sequential Monte Carlo (:func:`sample_smc`) with
systematic resampling and an evidence estimate — the port of
``tpu21cmvae/sampling/smc.py``.

The population runs as two independent sub-populations (shared β
schedule, disjoint resampling and mutation), so the evidence's error is
a replication error. Each mutation sweep scores the two half-ensembles'
stretch proposals and the independence proposals in three likelihood
calls (on a CUDA model, K2 through
``DirectEmulator.loglik_fn(backend="kernel")``). The step functions
(:func:`smc_half_move`, :func:`indep_move`, :func:`mutate`,
:func:`resample`, :func:`pick_delta`) take their randoms as arguments,
so a test can feed both packages the same draws; :func:`sample_smc`
draws them from a ``torch.Generator`` on the device seeded with
``seed``. The JAX package runs the anneal as one ``lax.while_loop``;
here it is a Python loop that reads β once per stage and the share of
refreshed particles once per mutation sweep past the ``n_mh``-th.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from tpu21cmvae_torch.sampling._common import (
    _init_walkers,
    _refuse_mesh,
    _resolve_bounds,
    _resolve_log_prior,
)
from tpu21cmvae_torch.sampling.mh import stretch_proposal
from tpu21cmvae_torch.sampling.pt import box_eval


def smc_eval(loglik, log_prior, lo, hi):
    """``eval_ll(params, flat) → (logL, log π, inside)`` with ``logL =
    -inf`` outside the box or where not finite (:func:`box_eval`)."""
    base = box_eval(loglik, log_prior, lo, hi)

    def eval_ll(params, flat):
        ll, lpr, inside = base(params, flat)
        return torch.where(torch.isfinite(ll) & inside, ll, -torch.inf), lpr, inside

    return eval_ll


def smc_half_move(eval_ll, params, xa, lla, lpra, xb, beta, a: float, u, j, log_u):
    """Red-black stretch move of half-ensemble ``xa`` (2, H, P) of each
    sub-population against partners from its other half ``xb``, target
    ``β·logL + log π`` (``tpu21cmvae/sampling/smc.py:59-81``); randoms
    ``u``, ``j``, ``log_u`` each (2, H). Returns ``(xa, lla, lpra,
    acceptance share)``."""
    prop, log_z = stretch_proposal(xa, xb, a, u, j)
    ll_p, lpr_p, inside = (v.reshape(u.shape)
                           for v in eval_ll(params, prop.reshape(-1, xa.shape[-1])))
    logr = log_z + beta * (ll_p - lla) + (lpr_p - lpra)
    acc = log_u < torch.where(inside, logr, -torch.inf)
    return (torch.where(acc[..., None], prop, xa), torch.where(acc, ll_p, lla),
            torch.where(acc, lpr_p, lpra), acc.to(torch.float32).mean())


def prop_from(x):
    """Each sub-population's moment-matched Gaussian proposal in
    standardized coordinates (``smc.py:123-138``): ``(mean, sd, chol,
    inverse chol)`` of the correlation matrix, ridged by 1e-4."""
    m, n_params = x.shape[1], x.shape[2]
    mean = x.mean(dim=1)
    sd = x.std(dim=1, correction=0) + 1e-12
    z = (x - mean[:, None]) / sd[:, None]
    eye = torch.eye(n_params, dtype=x.dtype, device=x.device)
    cr = torch.linalg.cholesky(torch.einsum("rij,rik->rjk", z, z) / m + 1e-4 * eye)
    return mean, sd, cr, torch.linalg.solve_triangular(cr, eye.expand_as(cr), upper=False)


def indep_move(eval_ll, params, x, ll, lpr, prop_stats, beta, eps, log_u):
    """Independence Metropolis from the frozen moment-matched Gaussian
    ``prop_stats`` (:func:`prop_from`), target ``β·logL + log π``
    (``smc.py:83-121``); randoms ``eps`` (2, M, P) and ``log_u`` (2, M).
    Returns ``(x, ll, lpr, accepted (2, M))``."""
    mean, sd, cr, icr = prop_stats
    prop = mean[:, None] + torch.einsum("rij,rkj->rik", eps, cr) * sd[:, None]
    ll_p, lpr_p, inside = (v.reshape(log_u.shape)
                           for v in eval_ll(params, prop.reshape(-1, x.shape[-1])))

    def logq(v):
        w = torch.einsum("rik,rjk->rij", (v - mean[:, None]) / sd[:, None], icr)
        return -0.5 * torch.sum(w * w, dim=-1)

    logr = beta * (ll_p - ll) + (lpr_p - lpr) + logq(x) - logq(prop)
    acc = log_u < torch.where(inside, logr, -torch.inf)
    return (torch.where(acc[..., None], prop, x), torch.where(acc, ll_p, ll),
            torch.where(acc, lpr_p, lpr), acc)


def mutate(eval_ll, params, x, ll, lpr, beta, a: float, n_mh: int, draws):
    """Decorrelate the resampled population (``smc.py:140-186``): sweeps
    of two stretch half-moves and one independence move, at least
    ``n_mh`` and then until 95 % of the particles have accepted an
    independence proposal, at most ``4·n_mh``. ``draws(i)`` gives sweep
    i's randoms: ``((u, j, log_u), (u, j, log_u), (eps, log_u))``.
    Returns ``(x, ll, lpr, mean stretch acceptance)``."""
    prop_stats = prop_from(x)
    half = x.shape[1] // 2
    fresh = torch.zeros(ll.shape, dtype=torch.bool, device=x.device)
    rate, i = torch.zeros((), device=x.device), 0
    while i < 4 * n_mh and (i < n_mh or fresh.to(torch.float32).mean().item() < 0.95):
        da, db, di = draws(i)
        xa, lla, lpra, ra = smc_half_move(eval_ll, params, x[:, :half], ll[:, :half],
                                          lpr[:, :half], x[:, half:], beta, a, *da)
        xb, llb, lprb, rb = smc_half_move(eval_ll, params, x[:, half:], ll[:, half:],
                                          lpr[:, half:], xa, beta, a, *db)
        x, ll, lpr = (torch.cat(v, dim=1) for v in ((xa, xb), (lla, llb), (lpra, lprb)))
        x, ll, lpr, acc = indep_move(eval_ll, params, x, ll, lpr, prop_stats, beta, *di)
        rate = rate + 0.5 * (ra + rb)
        fresh = fresh | acc
        i += 1
    return x, ll, lpr, rate / max(i, 1)


def resample(x, ll, lpr, logw, u):
    """Systematic resampling within each sub-population
    (``smc.py:188-204``) at the offsets ``u`` (2, 1): the two never
    exchange particles."""
    m = logw.shape[1]
    cdf = torch.cumsum(torch.exp(logw - torch.logsumexp(logw, dim=1, keepdim=True)), dim=1)
    pos = (torch.arange(m, dtype=torch.float32, device=x.device)[None] + u) / m
    idx = torch.searchsorted(cdf, pos).clamp(0, m - 1)  # left side, as jnp's
    return (torch.take_along_dim(x, idx[:, :, None], dim=1),
            torch.take_along_dim(ll, idx, dim=1), torch.take_along_dim(lpr, idx, dim=1))


def ess_frac(g, d):
    """Normalized ESS of the incremental weights ``exp(d·g)``, pooled over
    both sub-populations (the schedule is shared)."""
    lw = (d * g).reshape(-1)
    return torch.exp(2.0 * torch.logsumexp(lw, 0) - torch.logsumexp(2.0 * lw, 0)) / lw.shape[0]


def pick_delta(g, beta, target_ess_frac: float):
    """The largest ``δβ ≤ 1 − β`` whose incremental weights keep the
    pooled ESS fraction at ``target_ess_frac``: the whole step if it
    does, else 32 bisection steps (``smc.py:214-230``), on the device.
    ``beta``: a 0-d float32 tensor."""
    cap = 1.0 - beta
    full = ess_frac(g, cap) >= target_ess_frac
    lo_d, hi_d = torch.zeros_like(cap), cap
    for _ in range(32):
        mid = 0.5 * (lo_d + hi_d)
        ok = ess_frac(g, mid) >= target_ess_frac
        lo_d, hi_d = torch.where(ok, mid, lo_d), torch.where(ok, hi_d, mid)
    return torch.where(full, cap, lo_d)


@dataclasses.dataclass
class SMCResult:
    """Output of :func:`sample_smc`: an equally weighted posterior
    population plus the evidence of the anneal.

    ``final``: ``(n_particles, n_params)`` draws at β=1 after the last
    resample (duplicated ancestors: treat like one well-mixed MCMC
    batch); ``flat`` aliases it. ``logp``: per-particle ``logL + log π``.
    ``logz``: the sum over stages of the log-mean incremental weight
    (normalized-prior convention, as :func:`~tpu21cmvae_torch.sampling.
    evidence.log_evidence` and nested sampling); ``logz_err``: half the
    |difference| of the two independent sub-populations' estimates.
    ``n_stages``, ``betas`` (the adaptive schedule), ``stage_ess`` (each
    stage's incremental-weight ESS fraction), ``accept_rate`` (per-stage
    stretch acceptance).
    """

    final: np.ndarray
    logp: np.ndarray
    logz: float
    logz_err: float
    n_stages: int
    betas: np.ndarray
    stage_ess: np.ndarray
    accept_rate: np.ndarray

    @property
    def flat(self) -> np.ndarray:
        return self.final

    def summary(self, labels=None) -> str:
        mean, std = self.final.mean(0), self.final.std(0)
        labels = labels or [f"p{i}" for i in range(self.final.shape[-1])]
        lines = [
            f"  {l:>8}: {m:12.5g} ± {s:10.4g}"
            for l, m, s in zip(labels, mean, std)
        ]
        return (
            f"log Z = {self.logz:.4f} ± {self.logz_err:.4f} "
            f"({self.n_stages} stages, mutation accept "
            f"{float(np.mean(self.accept_rate)):.2f})\n"
            + "\n".join(lines)
        )


def _mutation_draws(gen, m: int, n_params: int):
    """``draws(i)`` for :func:`mutate` from ``gen``."""
    dev, half = gen.device, m // 2

    def stretch():
        return (torch.rand((2, half), generator=gen, device=dev),
                torch.randint(0, half, (2, half), generator=gen, device=dev),
                torch.log(torch.rand((2, half), generator=gen, device=dev)))

    def draws(i):
        return stretch(), stretch(), (
            torch.randn((2, m, n_params), generator=gen, device=dev),
            torch.log(torch.rand((2, m), generator=gen, device=dev)))

    return draws


@torch.no_grad()
def sample_smc(
    loglik,
    params,
    *,
    n_particles: int = 4096,
    n_mh: int = 8,
    bounds=None,
    a: float = 2.0,
    target_ess_frac: float = 0.5,
    max_stages: int = 64,
    seed: int = 0,
    log_prior=None,
    mesh=None,
    device,
) -> SMCResult:
    """Adaptive tempered SMC (Del Moral, Doucet & Jasra 2006): anneal a
    population from the prior to the posterior along a self-chosen β
    schedule, collecting the evidence on the way. Each stage picks the
    largest ``δβ`` that keeps the incremental weights' ESS fraction at
    ``target_ess_frac`` (:func:`pick_delta`), credits ``log mean w`` to
    ``log Z``, resamples systematically and mutates
    (:func:`mutate`). With a ``log_prior`` the box population is first
    converted to the prior (one uncredited reweight, resample and mutate
    at β=0). ``n_particles`` must be divisible by 4 with each quarter ≥
    ``n_params + 1``; an anneal that does not reach β=1 in
    ``max_stages`` raises. ``mesh`` takes one device (more wait for the port of
    ``parallel/``).
    """
    _refuse_mesh(mesh)
    device = torch.empty(0, device=device).device
    lo, hi = _resolve_bounds(bounds, device)
    n_params = int(lo.shape[0])
    if n_particles % 4:
        raise ValueError(f"n_particles must be divisible by 4; got {n_particles}")
    m = n_particles // 2  # per sub-population
    if m // 2 < n_params + 1:
        raise ValueError(
            f"n_particles must be >= 4*(n_params+1) = {4 * (n_params + 1)} for the "
            f"stretch move to span parameter space; got {n_particles}"
        )
    if a <= 1.0:
        raise ValueError(f"stretch scale a must be > 1; got {a}")
    if not 0.0 < target_ess_frac < 1.0:
        raise ValueError(f"target_ess_frac must be in (0, 1); got {target_ess_frac}")
    if max_stages < 2:
        raise ValueError(f"max_stages must be >= 2; got {max_stages}")
    gen = torch.Generator(device=device).manual_seed(seed)
    draws = _mutation_draws(gen, m, n_params)
    eval_ll = smc_eval(loglik, _resolve_log_prior(log_prior), lo, hi)
    x = _init_walkers(gen, 2 * m, lo, hi).reshape(2, m, n_params)
    ll, lpr, _ = (v.reshape(2, m) for v in eval_ll(params, x.reshape(-1, n_params)))

    def offsets():
        return torch.rand((2, 1), generator=gen, device=device)

    zero = torch.zeros((), dtype=torch.float32, device=device)
    if log_prior is not None:
        # uncredited importance conversion box → prior
        x, ll, lpr = resample(x, ll, lpr, lpr, offsets())
        x, ll, lpr, _ = mutate(eval_ll, params, x, ll, lpr, zero, a, n_mh, draws)
    beta, lz, betas, stage_ess, accs = zero, zero.new_zeros(2), [0.0], [], []
    while len(stage_ess) < max_stages and betas[-1] < 1.0:
        d = pick_delta(ll, beta, target_ess_frac)
        lw = d * ll
        lz = lz + torch.logsumexp(lw, dim=1) - math.log(m)
        stage_ess.append(ess_frac(ll, d))
        x, ll, lpr = resample(x, ll, lpr, lw, offsets())
        beta = torch.clamp(beta + d, max=1.0)
        x, ll, lpr, acc = mutate(eval_ll, params, x, ll, lpr, beta, a, n_mh, draws)
        accs.append(acc)
        betas.append(beta.item())
    n_stages = len(stage_ess)
    if betas[-1] < 1.0:
        raise RuntimeError(
            f"SMC anneal truncated at beta={betas[-1]:.4g} after {n_stages} stages; "
            f"raise max_stages (= {max_stages}) or target a lower target_ess_frac"
        )
    lza, lzb = lz.tolist()
    return SMCResult(
        final=x.reshape(-1, n_params).cpu().numpy(),
        logp=(ll + lpr).reshape(-1).cpu().numpy(),
        logz=0.5 * (lza + lzb),
        logz_err=0.5 * abs(lza - lzb),
        n_stages=n_stages,
        betas=np.asarray(betas, np.float32),
        stage_ess=torch.stack(stage_ess).cpu().numpy(),
        accept_rate=torch.stack(accs).cpu().numpy(),
    )
