"""Bayesian evidence: stepping-stone integration over a parallel-tempering
ladder (:func:`log_evidence`), Laplace + adaptive importance sampling
with PSIS diagnostics (:func:`laplace_evidence`), and model comparison
(:func:`compare_evidence`) — the port of ``tpu21cmvae/sampling/evidence.py``.

The ladder shares :mod:`tpu21cmvae_torch.sampling.pt`'s tempered kernel:
every half-sweep is one likelihood call of ``n_rungs · n_walkers / 2``
rows (K2 at bf16x3 through ``DirectEmulator.loglik_fn(backend="kernel")``
on a CUDA model). Laplace runs its multi-start ascent through the
likelihood's ``valgrad`` route where it carries one
(:class:`~tpu21cmvae_torch.sampling._common.RoutedLoglik`: K3 at fp32
from ``DirectEmulator.log_evidence``), its 7×7 Hessian by double
autograd through the ``plain`` route, and its importance-sampling rounds
through the value (K2 at fp32). The NumPy stages (the generalized-Pareto
fit, PSIS, the AMIS refits, the weights' reduction) are copies of the
JAX package's, float64 throughout. The batched forms
(:func:`laplace_evidence_multi` over a stacked-observation likelihood, in
plain PyTorch on both devices as the JAX package's stacked forms are
plain XLA) and :func:`laplace_evidence_multi_auto` escalate the rows
whose khat fails through a normalizing flow (:mod:`tpu21cmvae_torch.flows`)
and then, optionally, nested sampling or SMC.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from tpu21cmvae_torch.sampling._common import (
    _init_walkers,
    _shard_rows,
    _resolve_bounds,
    _resolve_log_prior,
    valgrad_from_loglik,
)
from tpu21cmvae_torch.sampling.fit import _whitened_adam_ascent
from tpu21cmvae_torch.sampling.pt import (
    _geometric_ladder,
    _pt_sizes_check,
    _pt_swap_sweeps,
    box_eval,
    ladder_walkers,
    pt_swap_phase,
    pt_sweep,
    swap_draws,
    sweep_draws,
)

# Student-t proposal of the IS stages: df=4 keeps polynomial tails (the
# whitened target's tails are exponential), 1.3× widens the Hessian-based
# first round, 1.15× over-disperses the moment-matched later rounds.
_IS_DF = 4.0
_IS_SCALE0 = 1.3
_IS_SCALE_ADAPT = 1.15


@dataclasses.dataclass
class EvidenceResult:
    """Bayesian evidence estimate from :func:`log_evidence`.

    ``logz``: stepping-stone estimate of ``log Z = log ∫ L(θ) π(θ) dθ``
    with ``π`` the (normalized) flat box prior. ``logz_err``: split-half
    Monte-Carlo error (the two step-halves estimated independently; half
    their |difference| per rung, in quadrature), a convergence alarm more
    than a confidence interval. ``ladder_drift``: the full-ladder
    estimate minus that of the half-density sub-ladder (every other rung,
    same chains): the discretization alarm the split-half error cannot
    sound. Treat both as an optimistic error scale and double
    ``n_rungs``/``n_steps`` until they are ≪ 1, or use nested sampling.
    ``rung_logz`` / ``rung_logz_err``: the K−1 per-rung contributions.
    ``betas``: the ladder. ``accept_rate`` / ``swap_rate``: per-rung
    stretch acceptance and per-edge exchange acceptance over the
    sampling phase. ``posterior`` / ``logp``: the β=1 rung's final
    walkers and their log-likelihoods.
    """

    logz: float
    logz_err: float
    ladder_drift: float
    rung_logz: np.ndarray
    rung_logz_err: np.ndarray
    betas: np.ndarray
    accept_rate: np.ndarray
    swap_rate: np.ndarray
    posterior: np.ndarray
    logp: np.ndarray

    def summary(self) -> str:
        drift_bad = abs(self.ladder_drift) > max(1.0, 3.0 * self.logz_err)
        if drift_bad:
            note = (
                f"  ** ladder_drift = {self.ladder_drift:+.1f}: NOT "
                "converged in rung count — the estimate would move by "
                "~this much under refinement; use nested_sampling "
                "(the robust path) or double n_rungs until the drift "
                "is small **"
            )
        elif self.logz_err > 1.0:
            note = (
                "  ** logz_err > 1: NOT converged — raise "
                "n_steps/n_warmup, seed x0 from fit_map, or add rungs **"
            )
        else:
            note = ""
        return (
            f"log Z = {self.logz:.4f} ± {self.logz_err:.3f}  "
            f"({len(self.betas)} rungs, drift {self.ladder_drift:+.2f}, "
            f"MH accept {float(self.accept_rate.mean()):.2f}, "
            f"swap accept {float(self.swap_rate.mean()):.2f}){note}"
        )


def stepping_stone(ss, ss_c, n_walkers: int):
    """The ladder's estimate from the per-step logsumexps ``ss`` (T, K−1)
    over walkers of ``dβ_k · logL`` at rung k (``ss_c``: the same over
    the half-density sub-ladder): ``(rung_logz, logz_err, coarse log Z,
    rung_err)``, every (step, walker) pooled
    (``tpu21cmvae/sampling/evidence.py:306-324``), float64."""
    ss = np.asarray(ss, np.float64)
    ss_c = np.asarray(ss_c, np.float64)
    n_steps = ss.shape[0]
    rung_logz = np.logaddexp.reduce(ss, axis=0) - np.log(n_steps * n_walkers)
    coarse_logz = float(
        (np.logaddexp.reduce(ss_c, axis=0) - np.log(n_steps * n_walkers)).sum())
    half = n_steps // 2
    a = np.logaddexp.reduce(ss[:half], axis=0) - np.log(half * n_walkers)
    b = np.logaddexp.reduce(ss[half: 2 * half], axis=0) - np.log(half * n_walkers)
    rung_err = 0.5 * np.abs(a - b)
    return rung_logz, float(np.sqrt((rung_err**2).sum())), coarse_logz, rung_err


@torch.no_grad()
def log_evidence(
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
    swap_sweeps: int = None,
    seed: int = 0,
    x0=None,
    log_prior=None,
    mesh=None,
    device,
) -> EvidenceResult:
    """Bayesian evidence ``log Z`` by stepping-stone integration over a
    parallel-tempering ladder (Xie et al. 2011): ``n_rungs`` tempered
    targets ``π_k ∝ L^{β_k}·π`` (β=0 the prior, sampled exactly by
    independence refresh, then a geometric ``beta_min → 1`` ladder) under
    :mod:`~tpu21cmvae_torch.sampling.pt`'s kernel; the sampling phase
    pools every (step, walker) sample into ``log Z = Σ_k log
    E_{π_k}[L^{β_{k+1}−β_k}]``. The JAX package documents a bias at the
    default budget on sharp emulator posteriors (−9.5 nats against nested
    at K=32, 400 steps): check ``logz_err`` and ``ladder_drift``.
    ``x0`` (W, P) seeds every rung (``fit_map(...).params``);
    ``log_prior`` makes the ladder ``L^β·π`` and ``logz`` the evidence
    under the box-normalized prior; ``mesh`` shards the rung axis as
    JAX's does (``n_rungs`` divides over it) by splitting the likelihood's
    rows over its devices (:func:`~tpu21cmvae_torch.sampling._common._shard_rows`).
    """
    log_prior = _resolve_log_prior(log_prior)
    device = torch.empty(0, device=device).device
    lo, hi = _resolve_bounds(bounds, device)
    n_params = int(lo.shape[0])
    _pt_sizes_check(n_rungs, n_walkers, n_params, a)
    n_sw = _pt_swap_sweeps(swap_sweeps, n_rungs)
    betas_np = _geometric_ladder(n_rungs, beta_min)
    betas = torch.as_tensor(betas_np, dtype=torch.float32, device=device)
    dbeta = betas[1:] - betas[:-1]
    # half-density sub-ladder (every other rung, keeping β=1) for the
    # drift alarm: its stepping-stone estimate reuses the same chains
    coarse_idx = np.append(np.arange(0, n_rungs - 1, 2), n_rungs - 1)
    coarse_src = torch.as_tensor(coarse_idx[:-1], device=device)
    coarse_dbeta = torch.diff(betas[torch.as_tensor(coarse_idx, device=device)])
    gen = torch.Generator(device=device).manual_seed(seed)
    x = ladder_walkers(x0, gen, n_rungs, n_walkers, lo, hi)
    eval_ll = box_eval(_shard_rows(loglik, mesh, n_rungs), log_prior, lo, hi)

    def step(x, ll, lpr, i):
        x, ll, lpr, acc = pt_sweep(eval_ll, params, x, ll, lpr, betas, a, lo, hi,
                                   sweep_draws(gen, n_rungs, n_walkers, n_params))
        return (*pt_swap_phase(x, ll, lpr, betas, i, swap_draws(gen, n_sw, n_rungs, n_walkers)),
                acc)

    ll, lpr, _ = eval_ll(params, x.reshape(-1, n_params))
    ll, lpr = ll.reshape(n_rungs, n_walkers), lpr.reshape(n_rungs, n_walkers)
    for i in range(n_warmup):
        x, ll, lpr, _, _ = step(x, ll, lpr, i)
    rates = torch.empty((n_steps, n_rungs), dtype=torch.float32, device=device)
    srates = torch.empty((n_steps, n_rungs - 1), dtype=torch.float32, device=device)
    ss = torch.empty((n_steps, n_rungs - 1), dtype=torch.float32, device=device)
    ss_c = torch.empty((n_steps, coarse_src.shape[0]), dtype=torch.float32, device=device)
    for t in range(n_steps):
        x, ll, lpr, srates[t], rates[t] = step(x, ll, lpr, t)
        # per-step stepping-stone terms: logsumexp over walkers of
        # dβ_k · logL at rung k (pooled across steps on the host)
        ss[t] = torch.logsumexp(dbeta[:, None] * ll[:-1], dim=1)
        ss_c[t] = torch.logsumexp(coarse_dbeta[:, None] * ll[coarse_src], dim=1)
    rung_logz, logz_err, coarse_logz, rung_err = stepping_stone(
        ss.cpu().numpy(), ss_c.cpu().numpy(), n_walkers)
    return EvidenceResult(
        logz=float(rung_logz.sum()),
        logz_err=logz_err,
        ladder_drift=float(rung_logz.sum()) - coarse_logz,
        rung_logz=rung_logz,
        rung_logz_err=rung_err,
        betas=betas.cpu().numpy(),
        accept_rate=rates.cpu().numpy().mean(axis=0),
        swap_rate=srates.cpu().numpy().mean(axis=0),
        posterior=x[-1].cpu().numpy(),
        logp=ll[-1].cpu().numpy(),
    )


# -- Laplace + adaptive importance sampling -----------------------------------


@dataclasses.dataclass
class LaplaceResult:
    """Gaussian (Laplace) approximation of the posterior and evidence
    from :func:`laplace_evidence`, sharpened by importance sampling.

    ``logz``: with ``n_is > 0``, the importance-sampling estimate over
    the adaptive rounds, ``logz_err`` its MC error; ``logz_laplace`` the
    raw saddle point (with ``n_is=0`` it is ``logz``, and ``logz_err`` is
    nan). ``is_ess``: Kish effective sample size of the Pareto-smoothed
    weights over all rounds. ``khat``: the PSIS tail index (below 0.7 the
    estimate has finite variance; above, distrust it and run nested).
    ``map_params``: the mode of the whitened density in raw units;
    ``map_logp`` its whitened log-density; ``cov``: raw-space covariance
    by the delta method; ``pd`` is False when the Hessian was not
    negative-definite at the mode. ``posterior(n)`` draws inside the box,
    importance-resampled when IS ran, from the Gaussian otherwise.
    ``method_used``: the estimator behind ``logz`` — ``"laplace"``, or,
    after :func:`laplace_evidence_multi_auto` escalated the row,
    ``"flow"`` (``escalation`` then holds the
    :class:`~tpu21cmvae_torch.flows.FlowEvidenceResult`; it holds every
    attempt, adopted or not), ``"nested"`` or ``"smc"`` (the definitive
    result in ``final_result``)."""

    logz: float
    map_params: np.ndarray
    map_logp: float
    cov: np.ndarray
    pd: bool
    logz_err: float = float("nan")
    logz_laplace: float = float("nan")
    is_ess: float = float("nan")
    khat: float = float("nan")
    method_used: str = "laplace"
    escalation: object = dataclasses.field(default=None, repr=False)
    final_result: object = dataclasses.field(default=None, repr=False)
    _y_map: np.ndarray = dataclasses.field(default=None, repr=False)
    _y_chol: np.ndarray = dataclasses.field(default=None, repr=False)
    _lo: np.ndarray = dataclasses.field(default=None, repr=False)
    _hi: np.ndarray = dataclasses.field(default=None, repr=False)
    _is_x: np.ndarray = dataclasses.field(default=None, repr=False)
    _is_logw: np.ndarray = dataclasses.field(default=None, repr=False)

    def posterior(self, n: int, seed: int = 0) -> np.ndarray:
        """``(n, P)`` posterior draws inside the box: importance-resampled
        from the IS cloud when it exists, else from the Laplace
        Gaussian."""
        rng = np.random.default_rng(seed)
        if self._is_x is not None:
            lw = self._is_logw - self._is_logw.max()
            p = np.exp(lw)
            p /= p.sum()
            idx = rng.choice(p.shape[0], size=n, p=p)
            return self._is_x[idx]
        z = rng.standard_normal((n, self._y_map.shape[0]))
        y = self._y_map + z @ self._y_chol.T
        s = 1.0 / (1.0 + np.exp(-y))
        return (self._lo + (self._hi - self._lo) * s).astype(np.float32)

    def summary(self, labels=None) -> str:
        sd = np.sqrt(np.maximum(np.diag(self.cov), 0.0))
        labels = labels or [f"p{i}" for i in range(sd.shape[0])]
        if self.method_used != "laplace":
            # an escalation stage replaced the headline fields: name it
            est = {"flow": "flow-IS escalation",
                   "nested": "nested sampling (definitive)",
                   "smc": "tempered SMC (definitive)"}.get(self.method_used, self.method_used)
            khat_s = f", khat {self.khat:.2f}" if np.isfinite(self.khat) else ""
            head = (
                f"log Z = {self.logz:.4f} ± {self.logz_err:.4f}  "
                f"({est}{khat_s}; Laplace saddle point "
                f"{self.logz_laplace:.4f}, negative-definite Hessian: "
                f"{self.pd})"
            )
        elif np.isfinite(self.logz_err):
            head = (
                f"log Z = {self.logz:.4f} ± {self.logz_err:.4f}  "
                f"(Laplace+IS; saddle point {self.logz_laplace:.4f}, "
                f"weight ESS {self.is_ess:.0f}, khat {self.khat:.2f}; "
                f"negative-definite Hessian: {self.pd})"
            )
        else:
            head = (
                f"log Z = {self.logz:.4f}  (Laplace — systematic "
                f"error, no MC term; negative-definite Hessian: "
                f"{self.pd})"
            )
        lines = [head, f"MAP log-density {self.map_logp:.4f}"] + [
            f"  {l:>8}: {m:12.5g} ± {s:10.4g}"
            for l, m, s in zip(labels, self.map_params, sd)
        ]
        if self.method_used not in ("nested", "smc") and self._is_logw is not None and (
            (np.isfinite(self.khat) and self.khat > 0.7)
            or self.is_ess < 0.02 * self._is_logw.shape[0]
        ):
            lines.append(
                f"  WARNING: khat {self.khat:.2f} / weight ESS "
                f"{self.is_ess:.0f} of {self._is_logw.shape[0]} draws "
                f"— the adapted proposal is still a poor match here "
                f"(curved ridge or missed mass); the error bar is "
                f"optimistic. Confirm with method='nested'."
            )
        return "\n".join(lines)


def _gpd_fit(x):
    """Zhang & Stephens (2009) empirical-Bayes generalized-Pareto fit to
    sorted-ascending exceedances ``x > 0``. Returns ``(k, sigma)`` with
    the weak prior shrinking ``k`` toward 0.5 (Vehtari et al. 2021 §3)."""
    n = x.shape[0]
    m = 30 + int(math.sqrt(n))
    b = 1.0 - np.sqrt(m / (np.arange(1, m + 1) - 0.5))
    b /= 3.0 * x[int(n / 4 + 0.5) - 1]
    b += 1.0 / x[-1]
    k = np.mean(np.log1p(-b[:, None] * x), axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        logl = n * (np.log(-b / k) - k - 1.0)
    logl = np.where(np.isfinite(logl), logl, -np.inf)
    if not np.isfinite(logl.max()):
        return float("nan"), float("nan")
    # the profile-likelihood weights are softmax(logl), max-subtracted
    e = np.exp(logl - logl.max())
    w = e / e.sum()
    b_post = float(np.sum(b * w))
    k_post = float(np.mean(np.log1p(-b_post * x)))
    sigma = -k_post / b_post
    k_post = (n * k_post + 5.0) / (n + 10.0)
    return k_post, sigma


def _psis(logw):
    """Pareto-smoothed importance sampling (Vehtari, Simpson, Gelman &
    Yao 2021): fit a generalized Pareto to the largest ~min(20 %, 3·√M)
    weights and replace them by the fit's expected order statistics
    (capped at the raw maximum). Returns ``(smoothed logw, k_hat)``."""
    m0 = logw.max()
    if not np.isfinite(m0):
        return logw, float("inf")
    lw = logw - m0
    n = lw.shape[0]
    s = int(min(0.2 * n, 3.0 * math.sqrt(n)))
    if s < 5:
        return logw, float("nan")
    order = np.argsort(lw)
    tail = order[-s:]
    cut = np.exp(lw[order[-s - 1]])
    exc = np.exp(lw[tail]) - cut  # ascending, ≥ 0
    if exc[-1] <= 0:
        return logw, float("nan")
    k, sigma = _gpd_fit(np.maximum(exc, 1e-300))
    if not (np.isfinite(k) and np.isfinite(sigma) and sigma > 0):
        return logw, float("nan")
    q = (np.arange(1, s + 1) - 0.5) / s
    if abs(k) < 1e-6:
        quant = -np.log1p(-q) * sigma
    else:
        quant = sigma * np.expm1(-k * np.log1p(-q)) / k
    smoothed = np.minimum(cut + quant, np.exp(lw[order[-1]]))
    out = lw.copy()
    out[tail] = np.log(smoothed)
    return out + m0, float(k)


def _amis_sharpen(run_is, y_map, chol0, *, n_is, n_rounds, seed):
    """Adaptive multiple importance sampling (AMIS, Cornuet et al. 2012)
    in the whitened space, over ``O`` observations
    (``tpu21cmvae/sampling/evidence.py:681-774``).

    ``run_is(y_centers (O, P) f32, scale_mats (O, P, P) f32, seed) → (g
    (O, n_is), y (O, n_is, P))`` draws and scores one round. Round 1
    proposes from the Hessian-based Student-t (df=4, 1.3× scale); each
    later round refits the t to the self-normalized weighted moments of
    all draws so far (shrunk toward the current proposal when the weight
    ESS is small). All rounds combine with deterministic-mixture weights
    ``w_i = π(y_i) / mean_r q_r(y_i)``. Returns ``(logw (O, n_rounds·n_is)
    f64, Y (O, n_rounds·n_is, P) f64)``."""
    df = _IS_DF
    mu = np.asarray(y_map, np.float64)
    n_obs, p = mu.shape
    props = [(mu, np.asarray(chol0, np.float64) * _IS_SCALE0)]
    gs, ys = [], []

    def logq_mix(Y):
        # (O, M) log of the equal-weight mixture of all proposals
        const = (
            math.lgamma((df + p) / 2.0) - math.lgamma(df / 2.0)
            - 0.5 * p * np.log(df * np.pi)
        )
        terms = []
        for mu_r, L_r in props:
            sld = np.linalg.slogdet(L_r)[1]  # (O,)
            d = (Y - mu_r[:, None, :]).transpose(0, 2, 1)  # (O,P,M)
            t = np.linalg.solve(L_r, d)  # (O,P,M)
            q2 = np.sum(t * t, axis=1)  # (O,M)
            terms.append(const - sld[:, None] - 0.5 * (df + p) * np.log1p(q2 / df))
        return np.logaddexp.reduce(np.stack(terms), 0) - np.log(len(props))

    for rnd in range(n_rounds):
        mu_r, L_r = props[-1]
        g, y = run_is(mu_r.astype(np.float32), L_r.astype(np.float32),
                      seed + 7919 + rnd * 104729)
        gs.append(np.asarray(g, np.float64))
        ys.append(np.asarray(y, np.float64))
        if rnd == n_rounds - 1:
            break
        Y = np.concatenate(ys, axis=1)
        logw = np.concatenate(gs, axis=1) - logq_mix(Y)
        logw = np.where(np.isfinite(logw), logw, -np.inf)
        mu_next = mu_r.copy()
        L_next = L_r.copy()
        for o in range(n_obs):
            lw = _psis(logw[o])[0]  # smoothed weights for the refit
            m = lw.max()
            if not np.isfinite(m):
                continue  # keep the current proposal
            wn = np.exp(lw - m)
            wn /= wn.sum()
            ess = 1.0 / float((wn * wn).sum())
            muw = wn @ Y[o]
            d = Y[o] - muw
            covw = (wn[:, None] * d).T @ d
            # shrink toward the current proposal's moments when the
            # weight ESS is too small to trust the refit
            a = ess / (ess + 10.0)
            cov_prop = (L_r[o] @ L_r[o].T) * df / (df - 2.0)
            cov_next = a * covw + (1.0 - a) * cov_prop
            mu_next[o] = a * muw + (1.0 - a) * mu_r[o]
            ev, evec = np.linalg.eigh(0.5 * (cov_next + cov_next.T))
            ev = np.maximum(ev, max(1e-10 * ev.max(), 1e-14))
            L_next[o] = ((evec * np.sqrt(ev * (df - 2.0) / df)) @ evec.T) * _IS_SCALE_ADAPT
        props.append((mu_next, L_next))
    Y = np.concatenate(ys, axis=1)
    logw = np.concatenate(gs, axis=1) - logq_mix(Y)
    return np.where(np.isfinite(logw), logw, -np.inf), Y


def _prior_log_box_mean(log_prior, lo, hi, *, n_mc: int = 1 << 18,
                        seed: int = 1086) -> float:
    """``log E_flat[exp(log_prior)]`` over the box ``[lo, hi]`` (tensors
    on one device): the constant that reports the Laplace/IS evidence
    under the box-normalized prior, as the ladder, SMC and nested do.
    ``None`` → 0. A :class:`~tpu21cmvae_torch.priors.GaussianBoxPrior`
    bound method resolves analytically through ``log_box_mean``; any
    other callable by one prior-only Monte-Carlo sweep of ``n_mc``
    uniform draws from a generator on the box's device seeded ``seed``."""
    if log_prior is None:
        return 0.0
    owner = getattr(log_prior, "__self__", None)
    analytic = getattr(owner, "log_box_mean", None)
    if analytic is not None:
        return float(analytic(lo.cpu().numpy(), hi.cpu().numpy()))
    gen = torch.Generator(device=lo.device).manual_seed(seed)
    u = torch.rand((n_mc, int(lo.shape[0])), generator=gen, device=lo.device)
    lp = _resolve_log_prior(log_prior)(lo + (hi - lo) * u)
    return float(torch.logsumexp(lp, dim=0) - math.log(float(n_mc)))


def _finish_laplace(res, logw, y, lo, hi):
    """Fill a LaplaceResult's IS fields from one observation's combined
    AMIS cloud (``logw (M,)``, ``y (M, P)`` whitened, float64),
    Pareto-smoothing the weights (:func:`_psis`) and recording ``khat``;
    ``lo``/``hi`` float64 arrays."""
    logw, khat = _psis(logw)
    res.khat = float(khat)
    m = logw.max()
    w = np.exp(logw - m)
    mean_w = float(w.mean())
    res.logz = float(m + np.log(mean_w))
    res.logz_err = float(w.std(ddof=1) / (np.sqrt(float(w.size)) * mean_w))
    res.is_ess = float(w.sum() ** 2 / (w * w).sum())
    span = np.asarray(hi, np.float64) - np.asarray(lo, np.float64)
    s = np.exp(-np.logaddexp(0.0, -y))  # overflow-safe sigmoid
    res._is_x = (np.asarray(lo, np.float64) + span * s).astype(np.float32)
    res._is_logw = logw
    return res


def _whitened_density(loglik, log_prior, lo, span):
    """``g(params, y (B, P)) → (B,)``: the whitened log-density ``logL(x(y))
    (+ log π) + Σ log σ'(y)`` whose integral over ``y`` is ``Z``."""

    def g(params, y):
        xr = lo + span * torch.sigmoid(y)
        ll = loglik(params, xr)
        if log_prior is not None:
            ll = ll + log_prior(xr)
        return ll + torch.sum(F.logsigmoid(y) + F.logsigmoid(-y), dim=-1)

    return g


def student_t_rows(gen, n: int, p: int, df: float = _IS_DF):
    """``n`` standard multivariate Student-t rows (df degrees of freedom)
    from ``gen``: ``z·√(df/u)`` with ``u ~ χ²_df`` drawn as the sum of df
    squared standard normals, exact for an integer df (the JAX package
    draws ``2·Gamma(df/2)``; torch has no generator-taking gamma)."""
    z = torch.randn((n, p), generator=gen, device=gen.device)
    u = (torch.randn((n, int(df)), generator=gen, device=gen.device) ** 2).sum(dim=1)
    return z * torch.sqrt(df / u)[:, None]


def laplace_hessian(loglik, log_prior, lo, hi, params, y_map):
    """The 7×7 Hessians of the whitened log-density at ``y_map`` (float32,
    on ``lo``'s device): one row (P,), or one row per observation (O, P)
    of a stacked likelihood. Double autograd through the plain likelihood
    (``loglik.plain`` where the likelihood carries one; a kernel's value
    has no second derivative): the gradient field of the summed density,
    then P backward passes of its k-th column summed over the rows. The
    cross-observation blocks are zero, so pass k reads every
    observation's own k-th row at once, as the JAX package's P JVP
    columns do. Returns float64 NumPy, (P, P) or (O, P, P)."""
    plain = getattr(loglik, "plain", None)
    g = _whitened_density(loglik if plain is None else plain, log_prior, lo, hi - lo)
    p = y_map.shape[-1]
    with torch.enable_grad():
        y = y_map.detach().reshape(-1, p).clone().requires_grad_(True)
        (grad,) = torch.autograd.grad(g(params, y).sum(), y, create_graph=True)
        rows = [torch.autograd.grad(grad[:, k].sum(), y, retain_graph=True)[0]
                for k in range(p)]
    h = torch.stack(rows, dim=1).detach().cpu().numpy().astype(np.float64)
    return h.reshape(*y_map.shape, p)


def _logit_in_box(x, lo, hi):
    """Raw rows → whitened ``y`` (float32), clipped 1e-7 of the span
    inside the box."""
    frac = np.clip((x - lo) / (hi - lo), 1e-7, 1.0 - 1e-7)
    return np.log(frac / (1.0 - frac)).astype(np.float32)


def laplace_saddle(x_map, y_map, g_map, h, lo, hi, prior_lbm):
    """The saddle-point stage from the mode ``x_map`` (raw) and
    ``y_map`` (whitened), both float32, its whitened log-density
    ``g_map`` and Hessian ``h`` (float64): the
    :class:`LaplaceResult` with ``logz = g + (P/2)·log 2π − ½·log det(−H)
    − prior_lbm`` and the whitened Cholesky factor for the IS rounds
    (``tpu21cmvae/sampling/evidence.py:915-955``)."""
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    h = 0.5 * (h + h.T)
    evals, evecs = np.linalg.eigh(-h)  # want −H ≻ 0 at a maximum
    pd = bool(evals.min() > 0)
    floor = max(1e-10 * max(evals.max(), 1.0), 1e-12)
    evals = np.maximum(evals, floor)
    p = y_map.shape[0]
    logdet = float(np.sum(np.log(evals)))
    logz = float(g_map) + 0.5 * p * np.log(2 * np.pi) - 0.5 * logdet - prior_lbm
    cov_y = evecs @ np.diag(1.0 / evals) @ evecs.T
    chol_y = evecs @ np.diag(1.0 / np.sqrt(evals)) @ evecs.T
    s = 1.0 / (1.0 + np.exp(-np.asarray(y_map, np.float64)))
    jac = np.asarray(hi - lo, np.float64) * s * (1.0 - s)
    return LaplaceResult(
        logz=float(logz), map_params=x_map, map_logp=float(g_map),
        cov=cov_y * jac[:, None] * jac[None, :], pd=pd, logz_laplace=float(logz),
        _y_map=np.asarray(y_map, np.float64), _y_chol=chol_y,
        _lo=lo.astype(np.float64), _hi=hi.astype(np.float64),
    )


@torch.no_grad()
def laplace_evidence(
    loglik,
    params,
    *,
    bounds=None,
    n_starts: int = 4096,
    n_steps: int = 2000,
    learning_rate: float = 0.05,
    n_is: int = 16384,
    n_rounds: int = 3,
    seed: int = 0,
    log_prior=None,
    mesh=None,
    device,
) -> LaplaceResult:
    """Laplace (saddle-point) approximation of the Bayesian evidence,
    sharpened by adaptive importance sampling: one multi-start MAP fit
    (:func:`~tpu21cmvae_torch.sampling.fit._whitened_adam_ascent` with the
    sigmoid map's Jacobian), one 7×7 Hessian, and ``n_rounds`` rounds of
    ``n_is`` Student-t draws scored in one likelihood call each
    (``n_is=0`` for the raw saddle point).

    The approximation lives in the sigmoid-whitened ``y``-space, where
    ``g(y) = logL(x(y)) + Σ log σ'(y)`` integrates to ``Z = ∫ L·π dx``
    under the normalized flat box prior: ``log Z ≈ g(ŷ) + (P/2)·log 2π −
    ½·log det(−H)``. With a ``log_prior`` the result is shifted by
    :func:`_prior_log_box_mean` so ``logz`` is the evidence under the
    box-normalized prior, as the other estimators report it. The ascent
    runs the likelihood's ``valgrad`` route where it has one (K3 at fp32
    from ``DirectEmulator.log_evidence``), autograd otherwise; the Hessian
    its ``plain`` route by double autograd; the IS rounds its value.
    Unimodal by construction: on a multimodal posterior it reports the
    dominant mode's evidence. ``mesh`` as in :func:`laplace_evidence_multi`.
    It is :func:`laplace_evidence_multi` over one
    observation, with the single-observation defaults.
    """
    return laplace_evidence_multi(
        loglik, params, 1, bounds=bounds, n_starts=n_starts, n_steps=n_steps, n_is=n_is,
        n_rounds=n_rounds, learning_rate=learning_rate, seed=seed, log_prior=log_prior,
        mesh=mesh, device=device)[0]


@torch.no_grad()
def laplace_evidence_multi(
    loglik_multi,
    params,
    n_obs: int,
    *,
    bounds=None,
    n_starts: int = 4096,
    n_steps: int = 2000,
    n_is: int = 4096,
    n_rounds: int = 3,
    learning_rate: float = 0.05,
    seed: int = 0,
    log_prior=None,
    mesh=None,
    device,
) -> list:
    """Laplace + adaptive importance sampling evidence for ``O``
    observations at once, every stage batched over them:
    ``loglik_multi(params, (O·W, P)) → (O·W,)`` is a stacked-observation
    likelihood (observation-major rows,
    :func:`tpu21cmvae_torch.ops.loglik.make_loglik_multi`).

    1. One whitened MAP ascent over ``O·n_starts`` rows
       (:func:`~tpu21cmvae_torch.sampling.fit._whitened_adam_ascent` over
       ``valgrad_from_loglik(loglik_multi)``), each row against its own
       observation;
    2. every observation's Hessian (:func:`laplace_hessian`, P
       double-autograd passes whatever O);
    3. ``n_rounds`` Student-t rounds of ``O·n_is`` rows, one stacked call
       each, with per-observation adaptive proposals (:func:`_amis_sharpen`):
       Student-t, not Gaussian, because the whitened target's tails are
       exponential; ``n_is=0`` stops at the saddle points.

    The defaults are per-observation budgets (the JAX package's measured
    reliability floor). ``mesh``: the ``O·n_starts`` starts divide over it,
    as in JAX, and every stacked call splits each observation's rows over
    its devices (:func:`~tpu21cmvae_torch.sampling._common._shard_rows`;
    the Hessians run whole on ``device``). Returns ``O``
    :class:`LaplaceResult`."""
    device = torch.empty(0, device=device).device
    lo, hi = _resolve_bounds(bounds, device)
    span = hi - lo
    p = int(lo.shape[0])
    prior_lbm = _prior_log_box_mean(log_prior, lo, hi)
    loglik_multi = _shard_rows(loglik_multi, mesh, n_obs * n_starts, groups=n_obs)
    gen = torch.Generator(device=device).manual_seed(seed)
    x0 = _init_walkers(gen, n_obs * n_starts, lo, hi)
    x_fin, g_fin = _whitened_adam_ascent(
        valgrad_from_loglik(loglik_multi), params, lo, hi, x0,
        n_steps=n_steps, learning_rate=learning_rate, log_prior=log_prior, jacobian=True,
    )
    x_np = x_fin.cpu().numpy().reshape(n_obs, n_starts, p)
    g_np = g_fin.cpu().numpy().reshape(n_obs, n_starts)
    best = np.nanargmax(g_np, axis=1)
    obs_rows = np.arange(n_obs)
    x_map, g_best = x_np[obs_rows, best], g_np[obs_rows, best]
    lo_np, hi_np = lo.cpu().numpy(), hi.cpu().numpy()
    y_map = _logit_in_box(x_map, lo_np, hi_np)
    h = laplace_hessian(loglik_multi, log_prior, lo, hi, params,
                        torch.as_tensor(y_map, device=device))
    out = [laplace_saddle(x_map[o], y_map[o], g_best[o], h[o], lo_np, hi_np, prior_lbm)
           for o in range(n_obs)]
    if n_is <= 0:
        return out
    g = _whitened_density(loglik_multi, log_prior, lo, span)

    def run_is(mu, chol, rnd_seed):
        gen = torch.Generator(device=device).manual_seed(rnd_seed)
        t = student_t_rows(gen, n_obs * n_is, p).reshape(n_obs, n_is, p)
        y = (torch.as_tensor(mu, device=device)[:, None, :]
             + t @ torch.as_tensor(chol, device=device).transpose(-1, -2))
        return g(params, y.reshape(-1, p)).reshape(n_obs, n_is).cpu().numpy(), y.cpu().numpy()

    logw, y_all = _amis_sharpen(run_is, np.stack([r._y_map for r in out]),
                                np.stack([r._y_chol for r in out]),
                                n_is=n_is, n_rounds=n_rounds, seed=seed)
    for o, res in enumerate(out):
        _finish_laplace(res, logw[o], y_all[o], lo_np, hi_np)
        res.logz -= prior_lbm
    return out


def laplace_evidence_multi_auto(
    loglik_multi,
    params,
    n_obs: int,
    *,
    row_loglik,
    row_valgrad,
    rows_loglik=None,
    rows_valgrad=None,
    method: str = "auto",
    khat_threshold: float = 0.7,
    flow_kwargs=None,
    final=None,
    final_kwargs=None,
    bounds=None,
    seed: int = 0,
    log_prior=None,
    device,
    **kwargs,
):
    """:func:`laplace_evidence_multi` with the khat escalation closed: after
    the batched Laplace + AMIS sweep, every row whose PSIS ``khat`` is not
    below ``khat_threshold`` (NaN counts as not below) is re-estimated
    through a normalizing-flow proposal
    (:func:`tpu21cmvae_torch.flows.evidence_with_flow`, warm-started at the
    row's MAP unless ``flow_kwargs`` give a ``flow`` or an ``x0``).

    ``method``: ``"laplace"`` (no escalation), ``"auto"`` (the flagged
    rows) or ``"flow"`` (every row). ``row_loglik(i)`` /
    ``row_valgrad(i)``: row ``i``'s value and value+gradient functions.
    ``rows_loglik(indices)`` / ``rows_valgrad(indices)``: optional
    functions that return the stacked likelihood over an observation
    subset; with both (and more than one
    flagged row, and no ``flow``/``x0`` in ``flow_kwargs``) the flagged
    rows' flows fit and sweep together
    (:func:`~tpu21cmvae_torch.flows.evidence_with_flow_batch`), and with
    ``rows_loglik`` the ``final="nested"`` rows run as one
    :func:`~tpu21cmvae_torch.nested.nested_sampling_batch`. A flow
    estimate is adopted only when its khat is strictly better than the
    row's, or finite where the row's is not; every attempt lands in
    ``escalation``.

    ``final``: ``"nested"`` or ``"smc"`` settles the rows still failing
    the bound by an estimator without importance weights (khat → NaN,
    the stage's draws behind ``posterior()``, the result in
    ``final_result``); a truncated nested run is recorded, never adopted.
    ``final_kwargs`` go to that stage. Returns ``n_obs``
    :class:`LaplaceResult`, each naming its estimator in
    ``method_used``."""
    if method not in ("laplace", "auto", "flow"):
        raise ValueError(f"method must be 'laplace', 'auto' or 'flow'; got {method!r}")
    if final not in (None, "nested", "smc"):
        raise ValueError(f"final must be None, 'nested' or 'smc'; got {final!r}")
    results = laplace_evidence_multi(loglik_multi, params, n_obs, bounds=bounds, seed=seed,
                                     log_prior=log_prior, device=device, **kwargs)
    if method != "laplace":
        flagged = list(range(n_obs) if method == "flow"
                       else [i for i, r in enumerate(results) if not (r.khat < khat_threshold)])

        def consider(i, fe):
            r = results[i]
            r.escalation = fe  # the attempt is on the record either way
            # adopt only a strictly better tail: a diverged flow fit must
            # never overwrite a finite Laplace estimate
            if fe.khat < r.khat or (np.isfinite(fe.khat) and not np.isfinite(r.khat)):
                r.method_used = "flow"
                r.logz, r.logz_err = fe.logz, fe.logz_err
                r.khat, r.is_ess = fe.khat, fe.is_ess
                r._is_x, r._is_logw = fe._x, fe._logw

        fk0 = dict(flow_kwargs or {})
        if (rows_valgrad is not None and rows_loglik is not None and len(flagged) > 1
                and "flow" not in fk0 and "x0" not in fk0):
            from tpu21cmvae_torch.flows import evidence_with_flow_batch

            fk0["x0"] = np.stack([results[i].map_params for i in flagged])
            fes = evidence_with_flow_batch(
                rows_loglik(flagged), rows_valgrad(flagged), params, len(flagged),
                bounds=bounds, seed=seed + 104_729, log_prior=log_prior, device=device, **fk0)
            for i, fe in zip(flagged, fes):
                consider(i, fe)
            flagged = []
        if flagged:
            from tpu21cmvae_torch.flows import evidence_with_flow

        for i in flagged:
            fk = dict(flow_kwargs or {})
            # sharp posteriors need a warm start at the mode, which the
            # Laplace stage has found
            if "flow" not in fk:
                fk.setdefault("x0", results[i].map_params)
            consider(i, evidence_with_flow(
                row_loglik(i), row_valgrad(i), params, bounds=bounds,
                seed=seed + 104_729 * (i + 1), log_prior=log_prior, device=device, **fk))
    if final is not None:
        _settle(results, final, final_kwargs, khat_threshold, row_loglik, rows_loglik,
                params, bounds, seed, log_prior, device)
    return results


def _settle(results, final, final_kwargs, khat_threshold, row_loglik, rows_loglik, params,
            bounds, seed, log_prior, device):
    """The definitive last stage of :func:`laplace_evidence_multi_auto` on
    the rows still failing the khat bound, in place."""
    still = [i for i, r in enumerate(results) if not (r.khat < khat_threshold)]

    def adopt(i, fr, draws):
        r = results[i]
        r.final_result = fr
        r.method_used = final
        r.logz, r.logz_err = fr.logz, fr.logz_err
        # no importance weights behind the definitive estimate: khat does
        # not apply; equal-weight draws back posterior()
        r.khat = float("nan")
        r.is_ess = float(getattr(fr, "ess", draws.shape[0]))
        r._is_x = np.asarray(draws)
        r._is_logw = np.zeros(r._is_x.shape[0])

    if final == "nested" and log_prior is not None and \
            "prior_transform" not in dict(final_kwargs or {}):
        raise ValueError(
            "final='nested' under a log_prior needs the matching prior_transform in "
            "final_kwargs (nested sampling does exact volume bookkeeping through the "
            "transform, not a density — see tpu21cmvae_torch.priors)")
    if final == "nested" and rows_loglik is not None and len(still) > 1:
        from tpu21cmvae_torch.nested import nested_sampling_batch

        fkw = dict(final_kwargs or {})
        base_seed = fkw.pop("seed", seed + 15_485_863)
        frs = nested_sampling_batch(rows_loglik(list(still)), params, len(still),
                                    bounds=bounds, seed=base_seed, device=device, **fkw)
        for i, fr in zip(still, frs):
            if fr.truncated:
                # a truncated run's logz is only a lower bound: record it,
                # never adopt it
                results[i].final_result = fr
                continue
            adopt(i, fr, fr.posterior(4096, seed=base_seed + 31 * (i + 1)))
        return
    for i in still:
        fkw = dict(final_kwargs or {})
        fkw.setdefault("seed", seed + 15_485_863 * (i + 1))
        if final == "nested":
            from tpu21cmvae_torch.nested import nested_sampling

            fr = nested_sampling(row_loglik(i), params, bounds=bounds, device=device, **fkw)
            if fr.truncated:
                results[i].final_result = fr
                continue
            draws = fr.posterior(4096, seed=fkw["seed"] + 1)
        else:
            from tpu21cmvae_torch.sampling.smc import sample_smc

            fr = sample_smc(row_loglik(i), params, bounds=bounds, log_prior=log_prior,
                            device=device, **fkw)
            draws = fr.final
        adopt(i, fr, draws)


# -- model comparison -----------------------------------------------------------


@dataclasses.dataclass
class EvidenceComparison:
    """Cross-model Bayesian comparison from :func:`compare_evidence`.

    ``names`` order matches ``logz``/``logz_err``; ``log_bayes``:
    ``logz − max(logz)`` (0 for the winner; |ΔlogZ| > 2.3 is ~10:1
    odds). ``results``: the underlying per-model result objects."""

    names: list
    logz: np.ndarray
    logz_err: np.ndarray
    log_bayes: np.ndarray
    results: dict

    def summary(self) -> str:
        order = np.argsort(-self.logz)
        lines = ["model comparison (log Z, natural logs):"]
        for i in order:
            tag = "  <- preferred" if self.log_bayes[i] == 0.0 else ""
            lines.append(
                f"  {self.names[i]:>12}: logZ = {self.logz[i]:10.3f} "
                f"± {self.logz_err[i]:.3f}   ΔlogZ = "
                f"{self.log_bayes[i]:+.3f}{tag}"
            )
        i0, i1 = order[0], order[1] if len(order) > 1 else order[0]
        gap = self.logz[i0] - self.logz[i1]
        err = float(np.hypot(self.logz_err[i0], self.logz_err[i1]))
        if len(order) > 1 and gap < 3.0 * err:
            lines.append(
                f"  (top-two gap {gap:.3f} is within 3× the combined "
                f"MC error {err:.3f} — NOT a significant preference)"
            )
        return "\n".join(lines)


def compare_evidence(models: dict, obs, noise_var=1.0, **kwargs) -> EvidenceComparison:
    """Bayesian model comparison on one observation: ``models`` maps names
    to objects with ``log_evidence(obs, noise_var, **kwargs)`` (the same
    kwargs, bounds and budget for all). Returns an
    :class:`EvidenceComparison`; its ``summary()`` flags a top-two gap
    within 3× the combined MC error as not significant."""
    if len(models) < 2:
        raise ValueError("compare_evidence needs >= 2 models")
    names, logzs, errs, results = [], [], [], {}
    for name, model in models.items():
        res = model.log_evidence(obs, noise_var, **kwargs)
        names.append(name)
        logzs.append(float(res.logz))
        errs.append(float(getattr(res, "logz_err", np.nan)))
        results[name] = res
    logz = np.asarray(logzs)
    return EvidenceComparison(
        names=names,
        logz=logz,
        logz_err=np.asarray(errs),
        log_bayes=logz - logz.max(),
        results=results,
    )
