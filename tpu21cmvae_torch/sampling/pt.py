"""Parallel tempering (:func:`sample_pt`): a geometric inverse-temperature
ladder of stretch-move ensembles with replica exchange — the port of
``tpu21cmvae/sampling/pt.py``.

The tempered kernel (:func:`pt_half_move`, :func:`pt_sweep`,
:func:`pt_swaps`, :func:`pt_swap_phase`) is shared with the
stepping-stone evidence (:func:`tpu21cmvae_torch.sampling.evidence.log_evidence`).
Every half-sweep scores all rungs' half-ensembles in one likelihood call
of ``n_rungs · n_walkers / 2`` rows (on a CUDA model, K2 through
``DirectEmulator.loglik_fn(backend="kernel")``); replica exchange is
likelihood-free. Each step function takes its random numbers as
arguments, so a test can feed both packages the same draws; the
samplers draw them from a ``torch.Generator`` on the device seeded with
``seed``. The JAX package runs the ladder as ``lax.scan`` programs; here
the loops are Python loops whose tensors stay on the device, under
``torch.no_grad()``. ``mesh`` takes one device (more wait for the
port of ``parallel/``).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu21cmvae_torch.sampling._common import (
    _init_walkers,
    _refuse_mesh,
    _resolve_bounds,
    _resolve_log_prior,
    _thin_state,
    _thin_write,
)
from tpu21cmvae_torch.sampling.mh import stretch_proposal
from tpu21cmvae_torch.sampling.results import PTSampleResult


def box_eval(loglik, log_prior, lo, hi):
    """``eval_ll(params, flat (B, P)) → (logL, log π, inside)``: rows
    outside the box are scored on the box's midpoint (so the emulator's
    log-transform never meets a negative parameter) and flagged by
    ``inside``; the callers reject them."""
    mid = (lo + hi) / 2.0

    def eval_ll(params, flat):
        inside = ((flat >= lo) & (flat <= hi)).all(dim=1)
        safe = torch.where(inside[:, None], flat, mid)
        return loglik(params, safe), log_prior(safe), inside

    return eval_ll


def pt_half_move(eval_ll, params, xa, lla, lpra, xb, betas, a: float, lo, hi,
                 u, j, prior_u, log_u):
    """Tempered red-black stretch move of half-ensemble ``xa`` (R, H, P)
    of every rung against partners from the other half ``xb`` of the
    same rung (``tpu21cmvae/sampling/pt.py:58-90``); rung r targets
    ``β_r·logL + log π``. Rung 0 (β = 0) instead takes an independence
    proposal uniform in the box, ``lo + (hi − lo)·prior_u`` (H, P),
    whose ratio has no stretch term. Randoms: ``u``, ``j`` (partner
    indices) and ``log_u``, each (R, H). Returns ``(xa, lla, lpra,
    per-rung acceptance share (R,))``."""
    n_rungs, half, n_params = xa.shape
    prop, log_z = stretch_proposal(xa, xb, a, u, j)
    prop = torch.cat([(lo + (hi - lo) * prior_u)[None], prop[1:]])
    ll_p, lpr_p, inside = (v.reshape(n_rungs, half)
                           for v in eval_ll(params, prop.reshape(-1, n_params)))
    stretch = torch.cat([torch.zeros_like(log_z[:1]), log_z[1:]])
    logr = stretch + betas[:, None] * (ll_p - lla) + (lpr_p - lpra)
    logr = torch.where(inside, logr, -torch.inf)
    acc = log_u < logr
    xa = torch.where(acc[:, :, None], prop, xa)
    lla = torch.where(acc, ll_p, lla)
    lpra = torch.where(acc, lpr_p, lpra)
    return xa, lla, lpra, acc.to(torch.float32).mean(dim=1)


def pt_sweep(eval_ll, params, x, ll, lpr, betas, a: float, lo, hi, draws):
    """One sweep: the first half-ensemble of every rung moves, then the
    second against the UPDATED first (detailed balance, emcee §3).
    ``draws``: two ``(u, j, prior_u, log_u)`` tuples of
    :func:`pt_half_move`. Returns ``(x, ll, lpr, per-rung acceptance)``."""
    half = x.shape[1] // 2
    xa, lla, lpra, ra = pt_half_move(eval_ll, params, x[:, :half], ll[:, :half],
                                     lpr[:, :half], x[:, half:], betas, a, lo, hi, *draws[0])
    xb, llb, lprb, rb = pt_half_move(eval_ll, params, x[:, half:], ll[:, half:],
                                     lpr[:, half:], xa, betas, a, lo, hi, *draws[1])
    return (torch.cat([xa, xb], dim=1), torch.cat([lla, llb], dim=1),
            torch.cat([lpra, lprb], dim=1), 0.5 * (ra + rb))


def pt_swaps(carry, dbeta, edge, log_u):
    """One replica-exchange sweep (``tpu21cmvae/sampling/pt.py:111-133``)
    on the edges ``(k, k+1)`` where ``edge`` (R−1,) is set: walker w of
    rung k trades places with walker w of rung k+1 with probability
    ``min(1, exp(dbeta_k (logL_k − logL_{k+1})))``, given the
    log-uniforms ``log_u`` (R−1, W). ``carry`` (C, R, W) holds what
    travels with a walker, its logL in channel 0. Returns ``(carry,
    per-edge acceptance (R−1,))``, 0 on the inactive edges."""
    ll = carry[0]
    acc = edge[:, None] & (log_u < dbeta[:, None] * (ll[:-1] - ll[1:]))
    pad = torch.zeros_like(acc[:1])
    # a rung takes the next rung's walker where its upper edge swapped, the
    # previous rung's where its lower edge did (active edges never touch)
    take_next, take_prev = torch.cat([acc, pad]), torch.cat([pad, acc])
    carry = torch.where(take_next, torch.cat([carry[:, 1:], carry[:, -1:]], dim=1),
                        torch.where(take_prev, torch.cat([carry[:, :1], carry[:, :-1]], dim=1),
                                    carry))
    return carry, acc.to(torch.float32).mean(dim=1)


def pt_swap_phase(x, ll, lpr, betas, i0: int, log_us):
    """``len(log_us)`` (even) exchange sweeps (:func:`pt_swaps`) on
    alternating edges, starting at parity ``i0 % 2``. The sweeps move
    ``(logL, log π, source rung)`` of each walker, and ``x`` follows its
    source rung once at the end. Each edge is active on half of the
    sweeps, so twice the mean raw rate is the per-attempt acceptance.
    Returns ``(x, ll, lpr, per-edge acceptance (R−1,))``."""
    n_rungs = x.shape[0]
    dbeta = betas[1:] - betas[:-1]
    k = torch.arange(n_rungs - 1, device=x.device) % 2
    edges = (k == 0, k == 1)
    rung = torch.arange(n_rungs, dtype=ll.dtype, device=x.device)[:, None].expand_as(ll)
    carry = torch.stack([ll, lpr, rung])
    rates = []
    for s, log_u in enumerate(log_us):
        carry, r = pt_swaps(carry, dbeta, edges[(i0 + s) % 2], log_u)
        rates.append(r)
    x = torch.take_along_dim(x, carry[2].long()[..., None], dim=0)
    return x, carry[0], carry[1], 2.0 * torch.stack(rates).mean(dim=0)


def sweep_draws(gen, n_rungs, n_walkers, n_params):
    """The randoms of one :func:`pt_sweep`, from ``gen``."""
    dev, half = gen.device, n_walkers // 2

    def one():
        return (torch.rand((n_rungs, half), generator=gen, device=dev),
                torch.randint(0, half, (n_rungs, half), generator=gen, device=dev),
                torch.rand((half, n_params), generator=gen, device=dev),
                torch.log(torch.rand((n_rungs, half), generator=gen, device=dev)))

    return one(), one()


def swap_draws(gen, n_sw, n_rungs, n_walkers):
    """The log-uniforms of one :func:`pt_swap_phase`, from ``gen``."""
    return torch.log(torch.rand((n_sw, n_rungs - 1, n_walkers), generator=gen,
                                device=gen.device))


def _pt_sizes_check(n_rungs, n_walkers, n_params, a):
    if n_rungs < 2:
        raise ValueError(f"n_rungs must be >= 2; got {n_rungs}")
    if n_walkers % 2:
        raise ValueError(f"n_walkers must be even; got {n_walkers}")
    if n_walkers < 2 * n_params + 2:
        raise ValueError(
            f"n_walkers must be >= 2*n_params+2 = {2 * n_params + 2} "
            f"for the stretch move to span parameter space; got {n_walkers}"
        )
    if a <= 1.0:
        raise ValueError(f"stretch scale a must be > 1; got {a}")


def _pt_swap_sweeps(swap_sweeps, n_rungs):
    """Exchange sweeps per likelihood sweep: even (both parities each
    step); the default scales with the ladder."""
    if swap_sweeps is None:
        swap_sweeps = min(max(n_rungs, 2), 64)
    n_sw = int(swap_sweeps) + (int(swap_sweeps) % 2)
    if n_sw < 2:
        raise ValueError(f"swap_sweeps must be >= 1; got {swap_sweeps}")
    return n_sw


def _geometric_ladder(n_rungs, beta_min):
    """β=0 prior rung + geometric ``beta_min → 1`` (float64): equal β
    ratios give ~constant per-edge swap acceptance for Gaussian-ish
    targets."""
    if not 0.0 < beta_min < 1.0:
        raise ValueError(f"beta_min must be in (0, 1); got {beta_min}")
    if n_rungs == 2:
        # geomspace(beta_min, 1, num=1) is [beta_min]: no tempering is
        # [prior, posterior]
        return np.array([0.0, 1.0])
    return np.concatenate([[0.0], np.geomspace(beta_min, 1.0, n_rungs - 1)])


def ladder_walkers(x0, gen, n_rungs, n_walkers, lo, hi):
    """Every rung's walkers: ``x0`` (W, P) pulled into the box and copied
    to every rung, else uniform draws in the box (R, W, P)."""
    n_params = lo.shape[0]
    if x0 is None:
        return _init_walkers(gen, n_rungs * n_walkers, lo, hi).reshape(
            n_rungs, n_walkers, n_params)
    rows = torch.as_tensor(np.asarray(x0, np.float32), device=lo.device)
    rows = torch.minimum(torch.maximum(rows, lo), hi)
    if rows.shape != (n_walkers, n_params):
        raise ValueError(f"x0 must have shape ({n_walkers}, {n_params}); "
                         f"got {tuple(rows.shape)}")
    return rows[None].expand(n_rungs, n_walkers, n_params).contiguous()


def _ladder(log_gaps):
    """β from the gaps' logs: ``[0, cumsum(g) / cumsum(g)[-1]]``, so β[-1]
    is exactly 1."""
    c = torch.cumsum(torch.exp(log_gaps), dim=0)
    return torch.cat([torch.zeros_like(c[:1]), c / c[-1]])


@torch.no_grad()
def sample_pt(
    loglik,
    params,
    *,
    n_rungs: int = 32,
    n_walkers: int = 256,
    n_steps: int = 400,
    n_warmup: int = 200,
    bounds=None,
    a: float = 2.0,
    beta_min: float = 1e-6,
    adapt_ladder: bool = False,
    swap_sweeps: int = None,
    thin: int = 10,
    seed: int = 0,
    x0=None,
    log_prior=None,
    mesh=None,
    device,
) -> PTSampleResult:
    """Parallel-tempering posterior sampler for multimodal posteriors
    (ptemcee's design, Vousden, Farr & Mandel 2016): ``n_rungs``
    tempered replicas (β=0 samples the prior by exact independence
    draws from the box, β=1 the posterior; a geometric ladder from
    ``beta_min`` between) of ``n_walkers`` stretch-move walkers each,
    with ``swap_sweeps`` (default ≈ ``n_rungs``) likelihood-free
    exchange sweeps on alternating edges per likelihood sweep.
    ``adapt_ladder=True`` moves the interior gaps during warmup to
    equalize the per-edge swap rates (gated past the first third of
    warmup, gain decaying like ``t0/(t+t0)``). Returns a
    :class:`PTSampleResult` for the β=1 rung; ``x0`` (W, P) seeds every
    rung; ``log_prior`` is a log-density over raw parameters on top of
    the flat box; ``mesh`` takes one device (more wait for the port of
    ``parallel/``).
    """
    _refuse_mesh(mesh)
    log_prior = _resolve_log_prior(log_prior)
    device = torch.empty(0, device=device).device
    lo, hi = _resolve_bounds(bounds, device)
    n_params = int(lo.shape[0])
    _pt_sizes_check(n_rungs, n_walkers, n_params, a)
    betas0 = _geometric_ladder(n_rungs, beta_min)
    n_sw = _pt_swap_sweeps(swap_sweeps, n_rungs)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = ladder_walkers(x0, gen, n_rungs, n_walkers, lo, hi)
    eval_ll = box_eval(loglik, log_prior, lo, hi)
    log_gaps = torch.log(torch.as_tensor(np.diff(betas0), dtype=torch.float32, device=device))
    # the gain decays like t0/(t+t0) so the ladder freezes well before
    # the kept phase; adaptation waits for the rungs to anneal from the
    # prior draws (their cold edges report spuriously high acceptance)
    t0_ladder = max(float(n_warmup) / 10.0, 10.0)
    t_adapt_start = float(n_warmup) / 3.0

    def step(x, ll, lpr, betas, i):
        x, ll, lpr, acc = pt_sweep(eval_ll, params, x, ll, lpr, betas, a, lo, hi,
                                   sweep_draws(gen, n_rungs, n_walkers, n_params))
        return (*pt_swap_phase(x, ll, lpr, betas, i, swap_draws(gen, n_sw, n_rungs, n_walkers)),
                acc)

    ll, lpr, _ = eval_ll(params, x.reshape(-1, n_params))
    ll, lpr = ll.reshape(n_rungs, n_walkers), lpr.reshape(n_rungs, n_walkers)
    a_ema = torch.full((n_rungs - 1,), 0.25, dtype=torch.float32, device=device)
    for i in range(n_warmup):
        x, ll, lpr, s, _ = step(x, ll, lpr, _ladder(log_gaps), i)
        if adapt_ladder and n_rungs > 2:
            # Vousden-style: widen the gaps whose edges swap more than
            # the ladder's average
            t = i + 1.0
            a_ema = 0.8 * a_ema + 0.2 * s
            gain = (t > t_adapt_start) * 0.3 * t0_ladder / (max(t - t_adapt_start, 0.0)
                                                             + t0_ladder)
            log_gaps = log_gaps + gain * (a_ema - a_ema.mean())
            log_gaps = log_gaps - log_gaps.mean()
    betas = _ladder(log_gaps)
    _, buf = _thin_state(n_steps, thin, x[-1])
    rates = torch.empty((n_steps,), dtype=torch.float32, device=device)
    srates = torch.empty((n_steps, n_rungs - 1), dtype=torch.float32, device=device)
    for t in range(n_steps):
        x, ll, lpr, srates[t], acc = step(x, ll, lpr, betas, t)
        rates[t] = acc.mean()
        _thin_write(buf, t, x[-1], thin)
    return PTSampleResult(
        chain=buf.cpu().numpy(),
        final=x[-1].cpu().numpy(),
        logp=(ll[-1] + lpr[-1]).cpu().numpy(),
        accept_rate=rates.cpu().numpy(),
        step_size=float(a),  # the stretch scale, as sample_ensemble reports it
        swap_rate=srates.cpu().numpy().mean(axis=0),
        betas=betas.cpu().numpy(),
    )
