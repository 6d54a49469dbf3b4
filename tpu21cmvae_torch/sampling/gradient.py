"""Gradient-based samplers over a value+gradient likelihood: HMC
(:func:`sample_hmc`), ChEES-adapted HMC (:func:`sample_chees`) and
iterative NUTS (:func:`sample_nuts`), with the whitening map and the
ensemble metric they share (the port of
``tpu21cmvae/sampling/gradient.py``).

Sampling happens in the sigmoid-whitened ``y``-space of the prior box
(the flat box prior is exact through the Jacobian term). Warmup adapts
the leapfrog step by dual averaging (Hoffman & Gelman 2014, Alg. 5;
γ = 0.05, t₀ = 10, κ = 0.75), in two phases when preconditioning:
halfway through, the leapfrog rescales by the cross-walker spread of
``y`` (the ensemble metric) and dual averaging restarts. The JAX package
runs each phase as one ``lax.scan``; here they are Python loops whose
tensors stay on the device. Two loops read the device on every
iteration, where the JAX package keeps a traced value: ChEES's leapfrog
count (``ceil(u·τ/ε)``, one read per iteration) and NUTS's lockstep
termination (``all(done)``, one read per tree depth). One step of each
sampler (:func:`hmc_step`, :func:`chees_step`, :func:`nuts_step`) takes
its randoms as arguments, so a test can feed both packages the same
draws.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from tpu21cmvae_torch.sampling._common import (
    _dual_averaging_consts,
    _init_walkers,
    _log_prior_val_grad,
    _shard_rows,
    _resolve_bounds,
    _thin_state,
    _thin_write,
)
from tpu21cmvae_torch.sampling.results import SampleResult
from tpu21cmvae_torch.utils import profiling

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


def _whitened_center(x0, lo, hi, device):
    """Raw-space center → whitened ``mu0`` (float32, on ``device``): the
    ``x0=`` of :func:`tpu21cmvae_torch.vi.fit_advi` and
    :func:`tpu21cmvae_torch.flows.fit_flow`. The logit runs on the host in
    float64 (a float32 logit loses digits near the box edge), clipped 1e-4
    of the span inside the box. Raises unless ``x0`` is one ``(P,)``
    center."""
    lo = np.asarray(lo, np.float64)
    span = np.asarray(hi, np.float64) - lo
    frac = np.clip((np.asarray(x0, np.float64) - lo) / span, 1e-4, 1.0 - 1e-4)
    mu0 = np.log(frac / (1.0 - frac)).astype(np.float32)
    if mu0.shape != lo.shape:
        raise ValueError(f"x0 must be a single ({lo.shape[0]},) center; got {np.shape(x0)}")
    return torch.as_tensor(mu0, device=device)


def _whitened_vi_target(valgrad, lo, span, log_prior, *, span_jac: bool):
    """The variational fits' ELBO integrand ``(params, y) → (target value,
    y-gradient)`` over the sigmoid-whitened space, from the first-order
    ``valgrad`` alone (reparameterization). The sigmoid is clamped to
    [1e-7, 1 − 1e-7]: float32 saturates it to 0 or 1 at |y| ≳ 17, which
    would put log(0) in the Jacobian. ``span_jac=True``: the log-Jacobian
    ``Σ log(span·s·(1−s))`` (ADVI's convention); False: ``Σ [log σ(y) +
    log σ(−y)]``, the samplers' convention, which the flow shares so that
    its ELBO and its importance weights cancel the box volume exactly.
    The two differ by the constant ``Σ log span``."""

    def val_grad(params, y):
        s = torch.clamp(torch.sigmoid(y), 1e-7, 1.0 - 1e-7)
        xr = lo + span * s
        ll, g_raw = valgrad(params, xr)
        if log_prior is not None:
            lpr, g_pr = _log_prior_val_grad(log_prior, xr)
            ll = ll + lpr
            g_raw = g_raw + g_pr
        if span_jac:
            jac = torch.sum(torch.log(span * s * (1.0 - s)), dim=-1)
        else:
            jac = torch.sum(F.logsigmoid(y) + F.logsigmoid(-y), dim=-1)
        g_y = g_raw * (span * s * (1.0 - s)) + (1.0 - 2.0 * s)
        return ll + jac, g_y

    return val_grad


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
    """Per-block ensemble metric: each of ``n_blk`` contiguous walker
    slabs (one observation's posterior in a batched run) gets its own
    :func:`_ens_metric`, repeated to per-walker rows ((B, D) diagonals or
    (B, D, D) square roots). At ``n_blk == 1`` a dense metric is lifted
    to (1, D, D) so rank tells it from a per-walker diagonal."""
    if n_blk == 1:
        met = _ens_metric(y, dense)
        return met[None] if dense else met
    w = y.shape[0] // n_blk
    mets = torch.stack([_ens_metric(yb, dense) for yb in y.reshape(n_blk, w, y.shape[1])])
    return torch.repeat_interleave(mets, w, dim=0)


def _resolve_metric(metric, precondition, n_warmup, n_walkers, auto_dense):
    """``(use_metric, dense)``: the metric needs ≥ 16 walkers and ≥ 20
    warmup steps; ``"auto"`` resolves to ``auto_dense`` (diagonal for
    HMC)."""
    if metric not in ("auto", "dense", "diag"):
        raise ValueError(f'metric must be "auto", "dense" or "diag"; got {metric!r}')
    use_metric = precondition and n_warmup >= 20 and n_walkers >= 16
    dense = metric == "dense" or (metric == "auto" and auto_dense)
    return use_metric, use_metric and dense


def _draw(gen: torch.Generator, y):
    """An HMC-type step's randoms: momenta (B, D), then log-uniforms (B,)."""
    p0 = torch.randn(y.shape, generator=gen, device=y.device, dtype=y.dtype)
    log_u = torch.log(torch.rand((y.shape[0],), generator=gen, device=y.device, dtype=y.dtype))
    return p0, log_u


def _leapfrog(logp_and_grad, params, y, glp, met, eps, n_leap: int, p0):
    """``n_leap`` leapfrog steps of step ``eps`` (a scalar or per-row
    column) from ``(y, p0)``: the end point, its momentum, its lp and
    gradient."""
    p = p0 + 0.5 * eps * _met_pull(met, glp)
    q = y
    for _ in range(n_leap - 1):
        q = q + eps * _met_scale(met, p)
        _, g = logp_and_grad(params, q)
        p = p + eps * _met_pull(met, g)
    q = q + eps * _met_scale(met, p)
    lp_new, g_new = logp_and_grad(params, q)
    return q, p + 0.5 * eps * _met_pull(met, g_new), lp_new, g_new


def _accept(y, lp, glp, q, lp_new, g_new, dh, log_u):
    """Metropolis on ``dh``; a walker whose current lp is not finite
    moves onto any finite proposal."""
    acc = log_u < dh
    acc = acc | (~torch.isfinite(lp) & torch.isfinite(lp_new))
    return (torch.where(acc[:, None], q, y), torch.where(acc, lp_new, lp),
            torch.where(acc[:, None], g_new, glp))


def hmc_step(logp_and_grad, params, y, lp, glp, met, eps_blk, n_leap: int, p0, log_u):
    """One HMC transition of every walker with ``n_leap`` leapfrog steps,
    given the momenta ``p0`` (B, D) and the log-uniforms ``log_u`` (B,).
    ``eps_blk``: (n_blk,) per-block steps over contiguous walker blocks.
    Returns ``(y, lp, glp, per-block mean acceptance probability)``."""
    n_blk = eps_blk.shape[0]
    eps = torch.repeat_interleave(eps_blk, y.shape[0] // n_blk)[:, None]
    q, p, lp_new, g_new = _leapfrog(logp_and_grad, params, y, glp, met, eps, n_leap, p0)
    dh = (lp_new - lp) - 0.5 * (torch.sum(p**2, -1) - torch.sum(p0**2, -1))
    y, lp, glp = _accept(y, lp, glp, q, lp_new, g_new, dh, log_u)
    # Metropolis probability capped at 1; a diverged (non-finite) dh counts 0
    a = torch.where(torch.isfinite(dh), torch.clamp(torch.exp(dh), max=1.0), 0.0)
    return y, lp, glp, a.reshape(n_blk, -1).mean(dim=1)


def _dual_average(t: float, a_mean, target_accept: float, mu, h_bar, log_eps_bar):
    """One dual-averaging update at iteration ``t`` (1-based) from the
    mean acceptance ``a_mean``: ``(h_bar, log_eps, log_eps_bar, w)``, ``w``
    the iterate-averaging weight ``t^-κ``."""
    h_bar = (1.0 - 1.0 / (t + _T0)) * h_bar + (target_accept - a_mean) / (t + _T0)
    log_eps = mu - math.sqrt(t) / _GAMMA * h_bar
    w = t ** (-_KAPPA)
    return h_bar, log_eps, w * log_eps + (1.0 - w) * log_eps_bar, w


def _dual_averaging(step, y, lp, glp, met, eps0, n_iter: int, target_accept: float):
    """``n_iter`` adapting steps from ``eps0`` (per block); returns the
    state and the averaged step ``exp(log_eps_bar)``."""
    mu = torch.log(10.0 * eps0)
    log_eps = log_eps_bar = torch.log(eps0)
    h_bar = torch.zeros_like(eps0)
    for i in range(n_iter):
        y, lp, glp, a_mean = step(y, lp, glp, met, torch.exp(log_eps))
        h_bar, log_eps, log_eps_bar, _ = _dual_average(i + 1.0, a_mean, target_accept, mu,
                                                       h_bar, log_eps_bar)
    return y, lp, glp, torch.exp(log_eps_bar)


def _start_walkers(x0, gen, n_walkers: int, lo, hi):
    """The whitened start: ``n_walkers`` uniform draws in the box from
    ``gen``, or ``x0``."""
    x = (_init_walkers(gen, n_walkers, lo, hi) if x0 is None
         else torch.as_tensor(np.asarray(x0, np.float32), device=lo.device))
    return _whiten_init(x, lo, hi - lo)


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
    mesh=None,
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
    by ``torch.autograd``, joins the leapfrog force. The metric stays
    pooled over the blocks: it is normalized to unit geometric mean, and
    the per-block step absorbs each block's scale. ``mesh``: a
    :class:`~tpu21cmvae_torch.parallel.mesh.Mesh` whose devices split the
    gradient's walker rows (:func:`~tpu21cmvae_torch.sampling._common._shard_rows`;
    the chain is the unsharded one). Returns a :class:`SampleResult` with the
    chain thinned by ``thin``.
    """
    device = torch.empty(0, device=device).device
    lo, hi = _resolve_bounds(bounds, device)
    span = hi - lo
    if n_walkers % adapt_blocks:
        raise ValueError(
            f"n_walkers ({n_walkers}) must divide into adapt_blocks "
            f"({adapt_blocks}) equal contiguous blocks"
        )
    with profiling.span("start", profiling.SAMPLER):
        gen = torch.Generator(device=device).manual_seed(seed)
        host = torch.Generator().manual_seed(seed)
        y = _start_walkers(x0, gen, n_walkers, lo, hi)
        use_metric, dense = _resolve_metric(
            metric, precondition, n_warmup, y.shape[0], auto_dense=False
        )
        n_warm1 = n_warmup // 2 if use_metric else n_warmup
        to_params, logp_and_grad = _whitened_target(_shard_rows(valgrad, mesh, y.shape[0]),
                                                     log_prior, lo, span)
        l_min = max(1, (n_leapfrog + 1) // 2)

        def step(y, lp, glp, met, eps):
            n_leap = n_leapfrog
            if jitter and l_min != n_leapfrog:
                n_leap = int(torch.randint(l_min, n_leapfrog + 1, (), generator=host))
            p0, log_u = _draw(gen, y)
            return hmc_step(logp_and_grad, params, y, lp, glp, met, eps, n_leap, p0, log_u)

        lp, glp = logp_and_grad(params, y)
        met = torch.ones((y.shape[1],), dtype=y.dtype, device=device)
        eps = torch.full((adapt_blocks,), init_step, dtype=torch.float32, device=device)
    with profiling.span("warmup", profiling.SAMPLER):
        if n_warm1 > 0:
            y, lp, glp, eps = _dual_averaging(step, y, lp, glp, met, eps, n_warm1,
                                              target_accept)
        if use_metric:
            met = _ens_metric_blocks(y, dense, 1)
            y, lp, glp, eps = _dual_averaging(step, y, lp, glp, met, eps,
                                              n_warmup - n_warm1, target_accept)
    with profiling.span("draws", profiling.SAMPLER):
        _, buf = _thin_state(n_steps, thin, y)
        rates = torch.empty((n_steps,), dtype=torch.float32, device=device)
        for t in range(n_steps):
            y, lp, glp, a_mean = step(y, lp, glp, met, eps)
            _thin_write(buf, t, to_params(y), thin)
            rates[t] = a_mean.mean()
    with profiling.span("collect", profiling.SAMPLER):
        return SampleResult(
            chain=buf.cpu().numpy(),
            final=to_params(y).cpu().numpy(),
            logp=lp.cpu().numpy(),
            accept_rate=rates.cpu().numpy(),
            step_size=float(eps.mean()),
            block_step_sizes=eps.cpu().numpy(),
        )


def _vdc(i: int) -> float:
    """Van der Corput base-2 fraction of the step index ``i``: the 32-bit
    reversal of ``i + 1`` read as a binary fraction in (0, 1), ChEES's
    quasi-random trajectory jitter (Hoffman, Radul & Sountsov 2021 §4).
    ``i`` is a host int; the reversal runs on Python ints masked to 32
    bits and rounds to float32 as the JAX package's uint32 → float32
    conversion does, so every fraction equals its bit for bit."""
    b = (i + 1) & 0xFFFFFFFF
    b = ((b & 0x55555555) << 1) | ((b & 0xAAAAAAAA) >> 1)
    b = ((b & 0x33333333) << 2) | ((b & 0xCCCCCCCC) >> 2)
    b = ((b & 0x0F0F0F0F) << 4) | ((b & 0xF0F0F0F0) >> 4)
    b = ((b & 0x00FF00FF) << 8) | ((b & 0xFF00FF00) >> 8)
    b = ((b << 16) & 0xFFFFFFFF) | (b >> 16)
    return float(np.float32(np.uint32(b)) * np.float32(2.0**-32))


@dataclasses.dataclass
class ChEESSampleResult(SampleResult):
    """:class:`SampleResult` from :func:`sample_chees`, plus the adapted
    total trajectory time ``trajectory_length`` (whitened ``y`` units):
    iteration ``i`` integrates for ``u_i·τ``, so the mean leapfrog count
    is ≈ ``τ/(2·step_size)``; a ``trajectory_length`` pinned at
    ``step_size·max_leapfrog`` means the cap bound the adaptation."""

    trajectory_length: float = 0.0


def _chees_leapfrogs(u: float, h, eps, max_leapfrog: int) -> int:
    """``clip(ceil(u·h/ε), 1, max_leapfrog)`` in float32 from the device
    scalars ``h`` and ``ε`` (one device→host read); a NaN count is 0
    before the clip, as the JAX package's int32 conversion makes it."""
    n = float(torch.ceil(u * h / eps))
    return int(min(max(0.0 if math.isnan(n) else n, 1.0), max_leapfrog))


def chees_step(logp_and_grad, params, y, lp, glp, met, eps, h, u: float, p0, log_u,
               max_leapfrog: int, want_grad: bool):
    """One ChEES-HMC transition of every walker: ``ceil(u·h/ε)`` leapfrog
    steps (clipped to ``[1, max_leapfrog]``) of the scalar step ``eps``,
    given the jitter fraction ``u``, the momenta ``p0`` and the
    log-uniforms ``log_u``. With ``want_grad`` also the ChEES criterion's
    gradient with respect to log τ (Hoffman et al. 2021 eq. 8): per walker
    ``α·u·Δ·⟨q' − m, L p'⟩``, α-weighted over the finite walkers. Returns
    ``(y, lp, glp, mean acceptance probability, g_logh)``; the mean has no
    finiteness guard, as in the JAX package."""
    n_leap = _chees_leapfrogs(u, h, eps, max_leapfrog)
    q, p_end, lp_new, g_new = _leapfrog(logp_and_grad, params, y, glp, met, eps, n_leap, p0)
    dh = (lp_new - lp) - 0.5 * (torch.sum(p_end**2, -1) - torch.sum(p0**2, -1))
    if want_grad:
        alpha = torch.exp(torch.clamp(dh, max=0.0))
        m = torch.mean(y, dim=0)
        dqp = q - m
        delta = torch.sum(dqp**2, -1) - torch.sum((y - m) ** 2, -1)
        per = alpha * u * delta * torch.sum(dqp * _met_scale(met, p_end), -1)
        ok = torch.isfinite(per)
        g_logh = torch.sum(torch.where(ok, per, 0.0)) / torch.clamp(
            torch.sum(torch.where(ok, alpha, 0.0)), min=1e-6)
    else:
        g_logh = torch.zeros((), dtype=y.dtype, device=y.device)
    y, lp, glp = _accept(y, lp, glp, q, lp_new, g_new, dh, log_u)
    return y, lp, glp, torch.mean(torch.clamp(torch.exp(dh), max=1.0)), g_logh


def _chees_adaptation(step, y, lp, glp, met, eps0, h0, start: int, n_iter: int,
                      target_accept: float, traj_lr: float, log_cap: float):
    """``n_iter`` warmup iterations from global step ``start``: dual
    averaging on log ε (as :func:`_dual_averaging`) and Adam (β 0.9,
    0.99) ascent on log τ, clamped to ``[log ε, log ε + log_cap]`` and
    averaged with the same ``t^-κ`` weights. Returns the state and the
    averaged ``(ε, τ)``."""
    b1, b2, adam_eps = 0.9, 0.99, 1e-8
    mu = torch.log(10.0 * eps0)
    log_eps = log_eps_bar = torch.log(eps0)
    log_h = log_h_bar = torch.log(h0)
    h_bar = m_a = v_a = torch.zeros_like(eps0)
    for k in range(n_iter):
        t = k + 1.0
        y, lp, glp, a_mean, g = step(y, lp, glp, met, torch.exp(log_eps), torch.exp(log_h),
                                     start + k, True)
        h_bar, log_eps, log_eps_bar, w = _dual_average(t, a_mean, target_accept, mu, h_bar,
                                                       log_eps_bar)
        m_a = b1 * m_a + (1.0 - b1) * g
        v_a = b2 * v_a + (1.0 - b2) * g * g
        log_h = log_h + traj_lr * (m_a / (1.0 - b1**t)) / (
            torch.sqrt(v_a / (1.0 - b2**t)) + adam_eps)
        log_h = torch.minimum(torch.maximum(log_h, log_eps), log_eps + log_cap)
        log_h_bar = w * log_h + (1.0 - w) * log_h_bar
    return y, lp, glp, torch.exp(log_eps_bar), torch.exp(log_h_bar)


def sample_chees(
    valgrad,
    params,
    *,
    n_walkers: int = 4096,
    n_steps: int = 200,
    n_warmup: int = 300,
    bounds=None,
    target_accept: float = 0.651,
    init_step: float = 0.01,
    init_traj=None,
    max_leapfrog: int = 128,
    traj_lr: float = 0.05,
    thin: int = 5,
    seed: int = 0,
    x0=None,
    precondition: bool = True,
    metric: str = "auto",
    log_prior=None,
    mesh=None,
    device,
) -> ChEESSampleResult:
    """ChEES-HMC (Hoffman, Radul & Sountsov 2021): HMC whose trajectory
    length adapts from ensemble statistics. All walkers share one jittered
    trajectory per iteration: iteration ``i`` integrates for ``u_i·τ``
    (``u_i`` the van der Corput fraction of the global step index,
    :func:`_vdc`) in ``ceil(u_i·τ/ε)`` leapfrog steps. Warmup adapts ε
    by dual averaging toward ``target_accept`` and log τ by Adam ascent
    (rate ``traj_lr``) on the ChEES gradient, τ clamped to
    ``[ε, ε·max_leapfrog]``; ``init_traj`` defaults to ``8·init_step``.
    ``precondition``/``metric`` as in :func:`sample_hmc` (the metric is
    estimated once, halfway through warmup, and not refreshed after it).
    Each iteration reads its leapfrog count from the device once.
    ``valgrad``, ``bounds``, ``log_prior``, ``thin``, ``x0`` and the
    randoms and ``mesh`` as in :func:`sample_hmc`. Returns a
    :class:`ChEESSampleResult`.
    """
    device = torch.empty(0, device=device).device
    lo, hi = _resolve_bounds(bounds, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    y = _start_walkers(x0, gen, n_walkers, lo, hi)
    h0 = float(init_traj) if init_traj is not None else 8.0 * init_step
    use_metric, dense = _resolve_metric(metric, precondition, n_warmup, y.shape[0],
                                        auto_dense=False)
    n_warm1 = n_warmup // 2 if use_metric else n_warmup
    to_params, logp_and_grad = _whitened_target(_shard_rows(valgrad, mesh, y.shape[0]),
                                                 log_prior, lo, hi - lo)
    log_cap = math.log(max_leapfrog)

    def step(y, lp, glp, met, eps, h, i, want_grad):
        p0, log_u = _draw(gen, y)
        return chees_step(logp_and_grad, params, y, lp, glp, met, eps, h, _vdc(i), p0, log_u,
                          max_leapfrog, want_grad)

    def adapt(y, lp, glp, met, eps, h, start, n_iter):
        return _chees_adaptation(step, y, lp, glp, met, eps, h, start, n_iter,
                                 target_accept, traj_lr, log_cap)

    lp, glp = logp_and_grad(params, y)
    met = torch.ones((y.shape[1],), dtype=y.dtype, device=device)
    eps = torch.tensor(init_step, dtype=torch.float32, device=device)
    h = torch.tensor(h0, dtype=torch.float32, device=device)
    if n_warm1 > 0:
        y, lp, glp, eps, h = adapt(y, lp, glp, met, eps, h, 0, n_warm1)
    if use_metric:
        met = _ens_metric_blocks(y, dense, 1)
        y, lp, glp, eps, h = adapt(y, lp, glp, met, eps, h, n_warm1, n_warmup - n_warm1)
    _, buf = _thin_state(n_steps, thin, y)
    rates = torch.empty((n_steps,), dtype=torch.float32, device=device)
    for t in range(n_steps):
        y, lp, glp, rates[t], _ = step(y, lp, glp, met, eps, h, n_warmup + t, False)
        _thin_write(buf, t, to_params(y), thin)
    return ChEESSampleResult(
        chain=buf.cpu().numpy(),
        final=to_params(y).cpu().numpy(),
        logp=lp.cpu().numpy(),
        accept_rate=rates.cpu().numpy(),
        step_size=float(eps),
        trajectory_length=float(h),
    )


def _popcount32(n: int) -> int:
    """Set bits of ``n`` as a 32-bit word: NUTS's checkpoint slot."""
    return bin(n & 0xFFFFFFFF).count("1")


@dataclasses.dataclass
class NUTSSampleResult(SampleResult):
    """:class:`SampleResult` from :func:`sample_nuts`, plus
    ``divergence_rate`` (the mean over draws of the share of walkers
    whose trajectory hit ΔH > 1000) and ``mean_leapfrog`` (the mean over
    draws of the mean leapfrog steps per walker; compare with
    ``2**max_depth − 1`` to see whether the U-turn criterion or the depth
    cap ends the trajectories)."""

    divergence_rate: float = 0.0
    mean_leapfrog: float = 0.0


def nuts_step(logp_and_grad, params, y, lp, glp, met, eps_blk, max_depth: int, p0, draw):
    """One multinomial NUTS transition of every walker (Betancourt 2017),
    the tree built iteratively in lockstep: depth ``d`` runs a subtree of
    ``2**d`` leapfrog steps in each walker's own direction, with the
    sub-U-turn checks of the checkpoint stack (a leaf ``i`` of even index
    stores its momentum and the running momentum sum at slot
    ``popcount(i)``; an odd leaf checks the slots
    ``[popcount(i) − tz(i+1), popcount(i) − 1]``, the complete subtrees
    ending at it). ``i`` is a host int, so only those slots are read.

    Randoms: the momenta ``p0`` (B, D), and ``draw(d) → (right (B,)
    bool, log_u_leaf (2**d, B), log_u_take (B,))`` for each depth that
    runs. Once every walker is done the remaining depths are skipped:
    one device→host read per depth. ``eps_blk``: (n_blk,) per-block
    steps. Returns ``(y, lp, glp, per-block mean accept statistic,
    whether each walker's trajectory diverged (B,), its leapfrog steps
    (B,))``."""
    B = y.shape[0]
    eps_w = torch.repeat_interleave(eps_blk, B // eps_blk.shape[0])
    h0 = lp - 0.5 * torch.sum(p0**2, -1)  # leaf log-weight base
    zl = zr = zp = y
    pl = pr = rho = p0
    gl = gr = gp = glp
    lpp = lp
    logw = torch.zeros_like(lp)
    done = torch.zeros((B,), dtype=torch.bool, device=y.device)
    ndiv = a_sum = a_cnt = nleap = torch.zeros((B,), dtype=torch.float32, device=y.device)
    for d in range(max_depth):
        if bool(done.all()):
            break
        right, log_u_leaf, log_u_take = draw(d)
        rc = right[:, None]
        eps_d = torch.where(right, eps_w, -eps_w)[:, None]
        z, p, g = torch.where(rc, zr, zl), torch.where(rc, pr, pl), torch.where(rc, gr, gl)
        cum = torch.zeros_like(y)
        lw = ls = torch.full_like(lp, -torch.inf)
        zs, gs = z, g
        turn = div = torch.zeros_like(done)
        p_ck, rho_ck = {}, {}
        for i in range(2**d):
            ph = p + 0.5 * eps_d * _met_pull(met, g)
            z = z + eps_d * _met_scale(met, ph)
            lp2, g = logp_and_grad(params, z)
            p = ph + 0.5 * eps_d * _met_pull(met, g)
            w = lp2 - 0.5 * torch.sum(p**2, -1) - h0
            w = torch.where(torch.isfinite(w), w, -torch.inf)
            div = div | (w < -1000.0)
            lw_new = torch.logaddexp(lw, w)
            # streaming multinomial: leaf i wins with prob w_i / Σ_{j≤i} w_j
            take = log_u_leaf[i] < (w - lw_new)
            lw = lw_new
            zs = torch.where(take[:, None], z, zs)
            ls = torch.where(take, lp2, ls)
            gs = torch.where(take[:, None], g, gs)
            cum = cum + p
            pc = _popcount32(i)
            if i % 2 == 0:
                p_ck[pc], rho_ck[pc] = p, cum
            else:
                for s in range(pc - _popcount32(~(i + 1) & i), pc):
                    seg = cum - rho_ck[s] + p_ck[s]
                    turn = turn | (torch.sum(seg * p_ck[s], -1) <= 0.0) | (
                        torch.sum(seg * p, -1) <= 0.0)
            a_sum = a_sum + torch.where(~done, torch.clamp(torch.exp(w), max=1.0), 0.0)
        ok = ~done & ~turn & ~div
        # biased-progressive acceptance of the new subtree's proposal
        take = ok & (log_u_take < (lw - logw))
        zp = torch.where(take[:, None], zs, zp)
        lpp = torch.where(take, ls, lpp)
        gp = torch.where(take[:, None], gs, gp)
        logw = torch.where(ok, torch.logaddexp(logw, lw), logw)
        rho = torch.where(ok[:, None], rho + cum, rho)
        upd_r, upd_l = (ok & right)[:, None], (ok & ~right)[:, None]
        zr, pr, gr = (torch.where(upd_r, z, zr), torch.where(upd_r, p, pr),
                      torch.where(upd_r, g, gr))
        zl, pl, gl = (torch.where(upd_l, z, zl), torch.where(upd_l, p, pl),
                      torch.where(upd_l, g, gl))
        full_turn = (torch.sum(rho * pl, -1) <= 0.0) | (torch.sum(rho * pr, -1) <= 0.0)
        ndiv = ndiv + torch.where(~done & div, 1.0, 0.0)
        nleap = nleap + torch.where(~done, float(2**d), 0.0)
        a_cnt = a_cnt + torch.where(~done, float(2**d), 0.0)
        done = done | turn | div | (ok & full_turn)
    a_blk = (a_sum / torch.clamp(a_cnt, min=1.0)).reshape(eps_blk.shape[0], -1).mean(dim=1)
    return zp, lpp, gp, a_blk, ndiv > 0, nleap


def sample_nuts(
    valgrad,
    params,
    *,
    n_walkers: int = 4096,
    n_steps: int = 200,
    n_warmup: int = 300,
    max_depth: int = 6,
    bounds=None,
    target_accept: float = 0.8,
    init_step: float = 0.01,
    thin: int = 5,
    seed: int = 0,
    x0=None,
    precondition: bool = True,
    metric: str = "auto",
    log_prior=None,
    mesh=None,
    adapt_blocks: int = 1,
    _dense_readapt: bool = False,
    device,
) -> NUTSSampleResult:
    """No-U-Turn Sampler (multinomial NUTS) over ``valgrad``, its tree
    built iteratively and in lockstep across walkers (:func:`nuts_step`):
    at most ``2**max_depth − 1`` likelihood calls per draw, divergences
    (ΔH > 1000) ending a walker's trajectory with the offending subtree
    discarded. Warmup adapts the step by dual averaging toward
    ``target_accept`` (the trajectory-mean ``min(1, e^-ΔH)``), with the
    ensemble-metric restart of :func:`sample_hmc` under ``precondition``
    (``"auto"`` is diagonal); a dense metric is refreshed after warmup,
    and ``_dense_readapt`` re-adapts ε under the refreshed one.

    ``adapt_blocks=G`` keeps G dual-averaged steps AND G ensemble
    metrics, one per contiguous walker block: the batched-observation
    path, where a pooled metric would measure the spread between the
    observations' posteriors. ``valgrad``, ``bounds``, ``log_prior``,
    ``thin``, ``x0``, the randoms and ``mesh`` as in :func:`sample_hmc`.
    Returns a :class:`NUTSSampleResult`.
    """
    device = torch.empty(0, device=device).device
    lo, hi = _resolve_bounds(bounds, device)
    if n_walkers % adapt_blocks:
        raise ValueError(
            f"n_walkers ({n_walkers}) must divide into adapt_blocks "
            f"({adapt_blocks}) equal contiguous blocks"
        )
    if max_depth < 1:
        raise ValueError(f"max_depth must be >= 1; got {max_depth}")
    gen = torch.Generator(device=device).manual_seed(seed)
    y = _start_walkers(x0, gen, n_walkers, lo, hi)
    n_walk = y.shape[0]
    use_metric, dense = _resolve_metric(metric, precondition, n_warmup,
                                        n_walk // adapt_blocks, auto_dense=False)
    n_warm1 = n_warmup // 2 if use_metric else n_warmup
    n_rest = n_warmup - n_warm1
    n_warm3 = n_rest // 2 if (use_metric and dense and _dense_readapt) else 0
    to_params, logp_and_grad = _whitened_target(_shard_rows(valgrad, mesh, y.shape[0]),
                                                 log_prior, lo, hi - lo)

    def draw(d):
        right = torch.rand((n_walk,), generator=gen, device=device) < 0.5
        log_u_leaf = torch.log(torch.rand((2**d, n_walk), generator=gen, device=device))
        return right, log_u_leaf, torch.log(torch.rand((n_walk,), generator=gen, device=device))

    def full_step(y, lp, glp, met, eps):
        p0 = torch.randn(y.shape, generator=gen, device=device, dtype=y.dtype)
        return nuts_step(logp_and_grad, params, y, lp, glp, met, eps, max_depth, p0, draw)

    def step(y, lp, glp, met, eps):
        return full_step(y, lp, glp, met, eps)[:4]

    lp, glp = logp_and_grad(params, y)
    met = torch.ones((y.shape[1],), dtype=y.dtype, device=device)
    eps = torch.full((adapt_blocks,), init_step, dtype=torch.float32, device=device)
    if n_warm1 > 0:
        y, lp, glp, eps = _dual_averaging(step, y, lp, glp, met, eps, n_warm1, target_accept)
    if use_metric:
        met = _ens_metric_blocks(y, dense, adapt_blocks)
        y, lp, glp, eps = _dual_averaging(step, y, lp, glp, met, eps, n_rest - n_warm3,
                                          target_accept)
        if dense:
            # refresh from the mixed ensemble; optionally re-adapt ε under it
            met = _ens_metric_blocks(y, dense, adapt_blocks)
            if n_warm3 > 0:
                y, lp, glp, eps = _dual_averaging(step, y, lp, glp, met, eps, n_warm3,
                                                  target_accept)
    _, buf = _thin_state(n_steps, thin, y)
    rates, divs, leaps = (torch.empty((n_steps,), dtype=torch.float32, device=device)
                          for _ in range(3))
    for t in range(n_steps):
        y, lp, glp, a_blk, diverged, n_leap = full_step(y, lp, glp, met, eps)
        rates[t], divs[t], leaps[t] = a_blk.mean(), diverged.to(torch.float32).mean(), n_leap.mean()
        _thin_write(buf, t, to_params(y), thin)
    return NUTSSampleResult(
        chain=buf.cpu().numpy(),
        final=to_params(y).cpu().numpy(),
        logp=lp.cpu().numpy(),
        accept_rate=rates.cpu().numpy(),
        step_size=float(eps.mean()),
        block_step_sizes=eps.cpu().numpy(),
        divergence_rate=float(divs.mean()),
        mean_leapfrog=float(leaps.mean()),
    )
