"""Gradient-free samplers: random-walk Metropolis (:func:`sample_mh`) and
the red-black affine-invariant stretch ensemble (:func:`sample_ensemble`)
— the port of ``tpu21cmvae/sampling/mh.py``.

Both score every proposal batch with one call of a value likelihood
``loglik(params, raw) → (B,)`` (on a CUDA model, K2 through
``DirectEmulator.loglik_fn(backend="kernel")``). The flat prior box is a
hard indicator: a proposal outside it scores ``-inf`` and is rejected,
and the likelihood sees the box's midpoint in its place, so the
emulator's log-transform never meets a negative parameter. A walker
whose current log-density is not finite moves onto any finite proposal.

The JAX package runs each chain as ``lax.scan`` programs; here they are
Python loops whose tensors stay on the device, and the random numbers
come from a ``torch.Generator`` on the device seeded with ``seed``. One
MH step (:func:`mh_step`) and one stretch half-move
(:func:`stretch_half_move`) take their random numbers as arguments, so a
test can feed both packages the same draws. Both samplers run under
``torch.no_grad()``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpu21cmvae_torch.sampling._common import (
    _dual_averaging_consts,
    _init_walkers,
    _refuse_mesh,
    _resolve_bounds,
    _resolve_log_prior,
    _thin_state,
    _thin_write,
)
from tpu21cmvae_torch.sampling.results import SampleResult


def _box_score(loglik, log_prior, lo, hi):
    """``score(params, xs) → (B,)``: the log-density inside the box,
    ``-inf`` outside it (scored on the box's midpoint row)."""
    mid = (lo + hi) / 2.0

    def score(params, xs):
        inside = ((xs >= lo) & (xs <= hi)).all(dim=1)
        safe = torch.where(inside[:, None], xs, mid)
        lp = loglik(params, safe) + log_prior(safe)
        return torch.where(inside, lp, -torch.inf)

    return score


def _start(x0, generator, n_walkers, lo, hi):
    """Walkers drawn uniformly in the box, or ``x0`` pulled into it
    (initialization, not part of the chain)."""
    if x0 is None:
        return _init_walkers(generator, n_walkers, lo, hi)
    x = torch.as_tensor(np.asarray(x0, np.float32), device=lo.device)
    return torch.minimum(torch.maximum(x, lo), hi)


def mh_step(score, params, x, lp, mult, base_scale, noise, log_u):
    """One Metropolis step of every walker (``tpu21cmvae/sampling/mh.py:55-75``)
    given the standard normals ``noise`` (B, P) and the log-uniforms
    ``log_u`` (B,). ``mult``: (G,) proposal-scale multipliers of G
    contiguous walker blocks; ``base_scale``: (P,). Returns ``(x, lp,
    per-block acceptance share (G,))``."""
    n_blk = mult.shape[0]
    m_row = torch.repeat_interleave(mult, x.shape[0] // n_blk)[:, None]
    prop = x + m_row * base_scale * noise
    lp_prop = score(params, prop)
    acc = log_u < lp_prop - lp
    acc = acc | (~torch.isfinite(lp) & torch.isfinite(lp_prop))
    x = torch.where(acc[:, None], prop, x)
    lp = torch.where(acc, lp_prop, lp)
    return x, lp, acc.to(torch.float32).reshape(n_blk, -1).mean(dim=1)


@torch.no_grad()
def sample_mh(
    loglik,
    params,
    *,
    n_walkers: int = 8192,
    n_steps: int = 500,
    n_warmup: int = 200,
    bounds=None,
    step_frac: float = 0.01,
    target_accept: float = 0.3,
    adapt: bool = True,
    adapt_blocks: int = 1,
    thin: int = 10,
    seed: int = 0,
    x0=None,
    log_prior=None,
    mesh=None,
    device,
) -> SampleResult:
    """Metropolis-Hastings ensemble over ``loglik(params, raw) → (B,)``.

    Proposals are isotropic Gaussians scaled per parameter by
    ``step_frac`` of the prior span; proposals outside the box are
    rejected (exact Metropolis with a symmetric proposal). During
    ``n_warmup`` steps the scale multiplier adapts by dual averaging
    toward ``target_accept``; ``adapt=False`` pins ``step_frac``.
    ``adapt_blocks=G`` keeps G independent multipliers, one per
    contiguous walker block. ``thin > 0`` keeps every ``thin``-th
    post-warmup step. ``log_prior``: a log-density over the raw
    parameters on top of the flat box
    (:class:`~tpu21cmvae_torch.priors.GaussianBoxPrior`). ``mesh`` takes one
    device (more wait for the port of ``parallel/``). Returns a :class:`SampleResult` whose
    ``step_size`` is the mean multiplier times the mean base scale.
    """
    _refuse_mesh(mesh)
    log_prior = _resolve_log_prior(log_prior)
    device = torch.empty(0, device=device).device
    lo, hi = _resolve_bounds(bounds, device)
    base_scale = step_frac * (hi - lo)
    if n_walkers % adapt_blocks:
        raise ValueError(
            f"n_walkers ({n_walkers}) must divide into adapt_blocks "
            f"({adapt_blocks}) equal contiguous blocks"
        )
    gen = torch.Generator(device=device).manual_seed(seed)
    x = _start(x0, gen, n_walkers, lo, hi)
    score = _box_score(loglik, log_prior, lo, hi)

    def step(x, lp, mult):
        noise = torch.randn(x.shape, generator=gen, device=device)
        log_u = torch.log(torch.rand((x.shape[0],), generator=gen, device=device))
        return mh_step(score, params, x, lp, mult, base_scale, noise, log_u)

    lp = loglik(params, x) + log_prior(x)
    mult = torch.ones((adapt_blocks,), dtype=torch.float32, device=device)
    if n_warmup > 0:
        mu, gamma, t0, kappa = _dual_averaging_consts(1.0)
        log_m = torch.zeros_like(mult)
        log_m_bar = torch.zeros_like(mult)
        h_bar = torch.zeros_like(mult)
        for i in range(n_warmup):
            x, lp, a = step(x, lp, torch.exp(log_m))
            t = i + 1.0
            h_bar = (1.0 - 1.0 / (t + t0)) * h_bar + (target_accept - a) / (t + t0)
            if adapt:
                log_m = mu - math.sqrt(t) / gamma * h_bar
                w = t ** (-kappa)
                log_m_bar = w * log_m + (1.0 - w) * log_m_bar
        mult = torch.exp(log_m_bar)
    _, buf = _thin_state(n_steps, thin, x)
    rates = torch.empty((n_steps,), dtype=torch.float32, device=device)
    for t in range(n_steps):
        x, lp, a = step(x, lp, mult)
        _thin_write(buf, t, x, thin)
        rates[t] = a.mean()
    scale = float(base_scale.mean())
    mult = mult.cpu().numpy()
    return SampleResult(
        chain=buf.cpu().numpy(),
        final=x.cpu().numpy(),
        logp=lp.cpu().numpy(),
        accept_rate=rates.cpu().numpy(),
        step_size=float(np.mean(mult)) * scale,
        block_step_sizes=mult * scale,
    )


def stretch_proposal(xa, xb, a: float, u, j):
    """The stretch move's proposal for the walkers ``xa`` (…, n, P)
    against partners ``xb[…, j]`` (``j``: indices into ``xb``'s
    walker axis, shaped like ``u``): ``x_j + z (x_a − x_j)`` with ``z ~
    g(z) ∝ 1/√z`` on [1/a, a] by inverse CDF of the uniforms ``u``, and
    the move's log-Jacobian ``(P − 1)·log z``. Leading axes batch
    independent ensembles (the rungs of a tempered ladder, the
    sub-populations of SMC)."""
    z = ((a - 1.0) * u + 1.0) ** 2 / a
    xj = torch.gather(xb, -2, j[..., None].expand(*j.shape, xb.shape[-1]))
    prop = xj + z[..., None] * (xa - xj)
    return prop, (xa.shape[-1] - 1.0) * torch.log(z)


def stretch_half_move(score, params, xa, lpa, xb, a: float, u, j, log_u):
    """Half A's stretch move against half B (``tpu21cmvae/sampling/mh.py:263-278``)
    given the uniforms ``u`` (for ``z``, :func:`stretch_proposal`), the
    partner indices ``j`` into ``xb`` and the log-uniforms ``log_u``,
    each (len(xa),). Returns ``(xa, lpa, acceptance share)``."""
    prop, log_z = stretch_proposal(xa, xb, a, u, j)
    lp_prop = score(params, prop)
    log_ratio = log_z + lp_prop - lpa
    acc = log_u < log_ratio
    acc = acc | (~torch.isfinite(lpa) & torch.isfinite(lp_prop))
    xa = torch.where(acc[:, None], prop, xa)
    lpa = torch.where(acc, lp_prop, lpa)
    return xa, lpa, acc.to(torch.float32).mean()


@torch.no_grad()
def sample_ensemble(
    loglik,
    params,
    *,
    n_walkers: int = 8192,
    n_steps: int = 500,
    n_warmup: int = 100,
    bounds=None,
    a: float = 2.0,
    thin: int = 10,
    seed: int = 0,
    x0=None,
    log_prior=None,
    mesh=None,
    device,
) -> SampleResult:
    """Affine-invariant ensemble sampler (Goodman & Weare 2010 stretch
    move, emcee's algorithm) with the red-black split: half A proposes
    ``x_j + z (x_i − x_j)`` against partners from half B, accepted with
    probability ``min(1, z^(d−1) · L'/L)``; then half B moves against
    the UPDATED half A. Warmup moves are ordinary moves whose samples are
    discarded; nothing adapts. ``n_walkers`` must be even and at least
    ``2 · n_params + 2``. ``log_prior``: a log-density over the raw
    parameters on top of the flat box; ``mesh`` takes one device (more wait
    for the port of ``parallel/``). Returns a :class:`SampleResult` whose
    ``step_size`` reports the stretch scale ``a``.
    """
    _refuse_mesh(mesh)
    log_prior = _resolve_log_prior(log_prior)
    device = torch.empty(0, device=device).device
    lo, hi = _resolve_bounds(bounds, device)
    n_params = int(lo.shape[0])
    if n_walkers % 2:
        raise ValueError(f"n_walkers must be even; got {n_walkers}")
    if n_walkers < 2 * n_params + 2:
        raise ValueError(
            f"n_walkers must be >= 2*n_params+2 = {2 * n_params + 2} "
            f"for the stretch move to span parameter space; got {n_walkers}"
        )
    if a <= 1.0:
        raise ValueError(f"stretch scale a must be > 1; got {a}")
    gen = torch.Generator(device=device).manual_seed(seed)
    x = _start(x0, gen, n_walkers, lo, hi)
    score = _box_score(loglik, log_prior, lo, hi)
    half = n_walkers // 2

    def half_move(xa, lpa, xb):
        n = xa.shape[0]
        u = torch.rand((n,), generator=gen, device=device)
        j = torch.randint(0, xb.shape[0], (n,), generator=gen, device=device)
        log_u = torch.log(torch.rand((n,), generator=gen, device=device))
        return stretch_half_move(score, params, xa, lpa, xb, a, u, j, log_u)

    def move(x, lp):
        xa, lpa, ra = half_move(x[:half], lp[:half], x[half:])
        xb, lpb, rb = half_move(x[half:], lp[half:], xa)
        return torch.cat([xa, xb]), torch.cat([lpa, lpb]), 0.5 * (ra + rb)

    lp = score(params, x)
    for _ in range(n_warmup):
        x, lp, _ = move(x, lp)
    _, buf = _thin_state(n_steps, thin, x)
    rates = torch.empty((n_steps,), dtype=torch.float32, device=device)
    for t in range(n_steps):
        x, lp, rates[t] = move(x, lp)
        _thin_write(buf, t, x, thin)
    return SampleResult(
        chain=buf.cpu().numpy(),
        final=x.cpu().numpy(),
        logp=lp.cpu().numpy(),
        accept_rate=rates.cpu().numpy(),
        step_size=float(a),
    )
