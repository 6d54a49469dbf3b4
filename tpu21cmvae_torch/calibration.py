"""Simulation-based calibration and posterior predictive checks (the port
of ``tpu21cmvae/calibration.py``).

SBC (Talts et al. 2018, arXiv:1804.06788) draws parameters from the
prior, simulates observations through the model's own forward model,
samples every posterior in one stacked-observation chain
(:meth:`DirectEmulator.sample_posterior_batch`) and ranks the truth
among the draws: the ranks are uniform for every parameter iff the
sampler targets the right posterior. Ranks use each simulation's final
kept step across walkers (the MH and HMC ensembles move walkers
independently). The goodness-of-fit checks score posterior draws by the
exact χ² tail of the whitened residual quadratic form, one batched
predict per call.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["BatchGOFResult", "GOFResult", "SBCResult",
           "goodness_of_fit", "goodness_of_fit_batch", "sbc"]


@dataclasses.dataclass
class SBCResult:
    """Rank statistics from one SBC study: ``ranks`` ``(n_sims,
    n_params)``, the rank of the true parameter among ``n_posterior``
    draws (uniform on ``{0, …, n_posterior}`` iff calibrated);
    ``pvalues``, per-parameter KS tests of the normalized ranks against
    U(0, 1) (themselves uniform when calibrated: act on systematic
    smallness); ``thetas``, the truths."""

    ranks: np.ndarray
    n_posterior: int
    pvalues: np.ndarray
    thetas: np.ndarray

    @property
    def normalized(self) -> np.ndarray:
        """Ranks mapped to (0, 1) with mid-tie placement, (rank + 0.5) /
        (n + 1): the KS test's input."""
        return (self.ranks + 0.5) / (self.n_posterior + 1.0)

    def summary(self, labels=None) -> str:
        labels = labels or [f"p{i}" for i in range(self.ranks.shape[1])]
        lines = [f"  {lab:>8}: KS p = {p:.3f}" for lab, p in zip(labels, self.pvalues)]
        verdict = (
            "calibrated (no parameter rejects uniformity at 0.01)"
            if (self.pvalues > 0.01).all()
            else "NOT calibrated — investigate the flagged parameters"
        )
        return (
            f"SBC over {self.ranks.shape[0]} simulations, "
            f"{self.n_posterior} posterior draws each: {verdict}\n"
            + "\n".join(lines)
        )


def _ks_uniform_pvalue(u: np.ndarray) -> float:
    """One-sample KS test p-value against U(0, 1), by the asymptotic
    Kolmogorov distribution."""
    u = np.sort(np.asarray(u, np.float64))
    n = len(u)
    grid = np.arange(1, n + 1) / n
    d = float(np.max(np.maximum(grid - u, u - (grid - 1.0 / n))))
    t = (np.sqrt(n) + 0.12 + 0.11 / np.sqrt(n)) * d
    j = np.arange(1, 101)
    p = 2.0 * np.sum((-1.0) ** (j - 1) * np.exp(-2.0 * (j * t) ** 2))
    return float(min(max(p, 0.0), 1.0))


def sbc(
    model,
    *,
    n_sims: int = 128,
    n_walkers: int = 64,
    n_steps: int = 300,
    n_warmup: int = 300,
    thin: int = 10,
    noise_var=25.0,
    bounds=None,
    sampler: str = "mh",
    seed: int = 0,
    prior=None,
    **kwargs,
) -> SBCResult:
    """An SBC study against ``model``'s own forward model (anything with
    ``predict`` and ``sample_posterior_batch``). Truths are uniform over
    ``bounds`` (default: the 21cmGEM-shaped ranges), or drawn from
    ``prior`` (a :class:`~tpu21cmvae_torch.priors.GaussianBoxPrior`,
    through its unit-cube transform; the chains then get its
    ``log_prior`` and, without ``bounds``, its box). Observations are
    ``predict(θ) + N(0, noise_var)``, or a marginalized spec's own
    ``sample_noise`` draws. ``n_walkers`` is per simulation and sets the
    rank resolution; kwargs forward to ``sample_posterior_batch``."""
    from tpu21cmvae_torch.sampling._common import _resolve_bounds

    if bounds is None and prior is not None and hasattr(prior, "lo"):
        # the chains must walk the box the truths are drawn in
        bounds = np.stack([np.asarray(prior.lo), np.asarray(prior.hi)], axis=1)
    lo, hi = (t.numpy().astype(np.float64) for t in _resolve_bounds(bounds, "cpu"))
    if bounds is None:
        bounds = np.stack([lo, hi], axis=1)
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=(n_sims, lo.shape[0]))
    if prior is not None and hasattr(prior, "lo"):
        if not (np.allclose(np.asarray(prior.lo), lo) and np.allclose(np.asarray(prior.hi), hi)):
            raise ValueError(
                "prior box != sampler box: pass bounds= matching the "
                "prior's (prior.lo/prior.hi) so truths and chains "
                "share one support"
            )
    if prior is not None:
        thetas = prior.prior_transform(torch.as_tensor(u, dtype=torch.float32)).numpy()
        kwargs.setdefault("log_prior", prior.log_prior)
    else:
        thetas = (lo + (hi - lo) * u).astype(np.float32)
    clean = np.atleast_2d(np.asarray(model.predict(thetas)))
    if callable(getattr(noise_var, "sample_noise", None)):
        obs = clean + noise_var.sample_noise(rng, clean.shape[0])
    else:
        obs = clean + rng.normal(0.0, np.sqrt(noise_var), clean.shape)

    res = model.sample_posterior_batch(
        obs, noise_var, sampler=sampler, n_walkers=n_walkers,
        bounds=bounds, n_steps=n_steps, n_warmup=n_warmup, thin=thin,
        seed=seed + 1, **kwargs,
    )
    # the inner result's chain: the reshaping view cannot size an empty one
    if res.result.chain.shape[0] == 0:
        raise ValueError("sbc needs a stored chain; run with thin > 0")
    draws = res.chain[-1]  # (n_sims, n_walkers, n_params), the final kept step
    ranks = (draws < thetas[:, None, :]).sum(axis=1)
    u = (ranks + 0.5) / (n_walkers + 1.0)
    pvalues = np.array([_ks_uniform_pvalue(u[:, j]) for j in range(u.shape[1])])
    return SBCResult(ranks=ranks, n_posterior=n_walkers, pvalues=pvalues, thetas=thetas)


@dataclasses.dataclass
class GOFResult:
    """Posterior predictive goodness of fit for one observed spectrum
    (Gelman, Meng & Stern 1996). ``p_value``: ``E_θ[SF_χ²(T(d, θ))]``
    over the posterior draws, with ``T = (d − m(θ))ᵀ P (d − m(θ))``, whose
    replicate distribution given θ is exactly χ²_dof under the Gaussian
    noise model. ``p → 0``: the model cannot reach the data; ``p → 1``:
    residuals implausibly small (overestimated noise). ``q``: the per-draw
    quadratic form; ``dof``: ``n_bins``, less the flat-prior foreground
    terms of a :class:`~tpu21cmvae_torch.foregrounds.MarginalizedNoise`;
    ``bin_z``: per-bin z-scores of the mean residual (foreground-cleaned
    by the GLS fit under a marginalized spec)."""

    p_value: float
    dof: float
    q: np.ndarray
    bin_z: np.ndarray

    def summary(self) -> str:
        verdict = (
            "no evidence of misfit"
            if 0.01 < self.p_value < 0.99
            else ("MISFIT: the model cannot reach the data "
                  "(unmodeled structure or underestimated noise)"
                  if self.p_value <= 0.01 else
                  "residuals implausibly small (overestimated noise)")
        )
        return (
            f"posterior predictive p = {self.p_value:.3f} "
            f"(q/dof = {float(np.mean(self.q)) / self.dof:.3f} over "
            f"{self.q.shape[0]} draws, dof = {self.dof:.0f}; "
            f"max |bin z| = {float(np.abs(self.bin_z).max()):.2f}): "
            f"{verdict}"
        )


def _refuse_level_marginal(noise_var, advice: str):
    from tpu21cmvae_torch.noisescale import ScaleMarginalNoise

    if isinstance(noise_var, ScaleMarginalNoise):
        raise ValueError(
            "goodness_of_fit is powerless under a marginalized noise "
            "LEVEL (sigma^2 rescales to absorb any overall misfit): " + advice
        )


def goodness_of_fit(
    model,
    obs,
    noise_var=25.0,
    draws=None,
    *,
    max_draws: int = 512,
    seed: int = 0,
) -> GOFResult:
    """Posterior predictive check of ``model`` against one observed
    spectrum. ``draws``: posterior draws in raw units, a
    :class:`~tpu21cmvae_torch.sampling.results.SampleResult` (its stored
    chain, or its final walkers when ``thin=0``) or a ``(B, n_params)``
    array, subsampled to ``max_draws`` rows. ``noise_var`` takes every
    spec the likelihoods do except a ``ScaleMarginalNoise``, under which
    the statistic has no power. An unconverged chain inflates ``q`` and
    reads as misfit: check ``result.rhat()`` first."""
    _refuse_level_marginal(noise_var, "check the level with spec.sigma2_posterior(residual) "
                                      "and pass the base spec here for the shape test")
    if draws is None:
        raise ValueError(
            "pass posterior draws (a SampleResult or a (B, n_params) "
            "array), e.g. model.sample_posterior(obs, noise_var)"
        )
    if hasattr(draws, "per_obs"):  # BatchSampleResult (.flat is a METHOD)
        raise ValueError(
            "got a BatchSampleResult: score the whole survey with "
            "goodness_of_fit_batch(model, obs_batch, noise_var, draws) "
            "or one observation with draws.per_obs(i)"
        )
    if hasattr(draws, "chain"):
        draws = draws.flat if draws.chain.shape[0] else draws.final
    draws = np.atleast_2d(np.asarray(draws, np.float32))
    obs = np.asarray(obs, np.float64).reshape(-1)
    sf, q, dof, bin_z = _gof_core(model, obs[None, :], noise_var, draws[None], max_draws, seed)
    return GOFResult(p_value=float(sf[0].mean()), dof=dof, q=q[0], bin_z=bin_z[0])


def _gof_core(model, obs_batch, noise_var, draws, max_draws, seed):
    """The scoring core of both checks: ``obs_batch (O, n)`` float64 and
    ``draws (O, B, P)`` → per-draw χ² tails ``sf (O, B)`` (float32, by
    ``torch.special.gammaincc``), quadratic forms ``q (O, B)``, ``dof``
    and per-bin ``bin_z (O, n)``."""
    from tpu21cmvae_torch.foregrounds import MarginalizedNoise

    n_obs, n = obs_batch.shape
    if draws.shape[1] > max_draws:
        rng = np.random.default_rng(seed)
        draws = draws[
            np.arange(n_obs)[:, None],
            rng.choice(draws.shape[1], max_draws, replace=False)[None, :],
        ]
    b = draws.shape[1]
    m = np.asarray(model.predict(draws.reshape(n_obs * b, -1)), np.float64).reshape(n_obs, b, n)
    r = obs_batch[:, None, :] - m

    if isinstance(noise_var, MarginalizedNoise):
        z = r @ noise_var.whiten.astype(np.float64)
        q = np.einsum("obi,obi->ob", z, z)
        dof = float(n - noise_var.n_terms if noise_var.prior_var is None else n)
        # foreground-cleaned per-bin diagnostic: the GLS fit to the mean
        # residual subtracted, then z against the base noise
        coeff, _ = noise_var.coeff_posterior(r.mean(axis=1))
        cleaned = r - noise_var.reconstruct(coeff)[:, None, :]
        bin_z = cleaned.mean(axis=1) / np.sqrt(noise_var.noise_var + cleaned.var(axis=1))
    else:
        nv = np.broadcast_to(np.asarray(noise_var, np.float64), (n,))
        q = np.einsum("obi,obi->ob", r / nv, r)
        dof = float(n)
        bin_z = r.mean(axis=1) / np.sqrt(nv + r.var(axis=1))

    # SF_χ²(q; dof) = Q(dof/2, q/2), the upper regularized gamma, in float32
    sf = torch.special.gammaincc(
        torch.tensor(dof / 2.0, dtype=torch.float32),
        torch.as_tensor(q / 2.0, dtype=torch.float32),
    ).numpy()
    return sf, q, dof, bin_z


@dataclasses.dataclass
class BatchGOFResult:
    """Per-observation posterior predictive checks of a survey
    (:func:`goodness_of_fit_batch`): ``p_values`` ``(O,)``, the shared
    ``dof``, the mean quadratic form ``q_mean`` ``(O,)`` and per-bin
    z-scores ``bin_z`` ``(O, n_bins)``; ``flagged`` lists the
    observations whose p leaves (0.01, 0.99)."""

    p_values: np.ndarray
    dof: float
    q_mean: np.ndarray
    bin_z: np.ndarray

    @property
    def flagged(self) -> np.ndarray:
        return np.where((self.p_values <= 0.01) | (self.p_values >= 0.99))[0]

    def summary(self) -> str:
        o = self.p_values.shape[0]
        bad = self.flagged
        head = f"posterior predictive check over {o} observations (dof = {self.dof:.0f}): "
        if bad.size == 0:
            return head + "no observation shows evidence of misfit"
        lines = [
            f"  obs {i}: p = {self.p_values[i]:.4f} "
            f"(q/dof = {self.q_mean[i] / self.dof:.2f}, "
            f"max |bin z| = {float(np.abs(self.bin_z[i]).max()):.1f})"
            for i in bad
        ]
        return head + f"{bad.size} flagged\n" + "\n".join(lines)


def goodness_of_fit_batch(
    model,
    obs_batch,
    noise_var=25.0,
    draws=None,
    *,
    max_draws: int = 256,
    seed: int = 0,
) -> BatchGOFResult:
    """:func:`goodness_of_fit` for ``O`` observations in one batched
    predict. ``draws``: a
    :class:`~tpu21cmvae_torch.sampling.results.BatchSampleResult` from
    ``sample_posterior_batch(obs_batch, …)`` or an ``(O, B, n_params)``
    array; each observation's draws are subsampled to ``max_draws``.
    ``noise_var`` as in :func:`goodness_of_fit`, shared across the
    observations."""
    _refuse_level_marginal(noise_var, "check levels with spec.sigma2_posterior per "
                                      "observation and pass the base spec here for the "
                                      "shape test")
    obs_batch = np.atleast_2d(np.asarray(obs_batch, np.float64))
    n_obs, _ = obs_batch.shape
    if draws is None:
        raise ValueError(
            "pass per-observation posterior draws (a BatchSampleResult "
            "or a (O, B, n_params) array), e.g. "
            "model.sample_posterior_batch(obs_batch, noise_var)"
        )
    if hasattr(draws, "per_obs"):  # BatchSampleResult
        if draws.n_obs != n_obs:
            raise ValueError(f"draws carry {draws.n_obs} observations, obs_batch has {n_obs}")
        r = draws.result
        if r.chain.shape[0]:
            k, _, p = r.chain.shape
            stacked = r.chain.reshape(k, n_obs, -1, p)
            draws = np.moveaxis(stacked, 1, 0).reshape(n_obs, -1, p)
        else:
            draws = r.final.reshape(n_obs, -1, r.final.shape[-1])
    draws = np.asarray(draws, np.float32)
    if draws.ndim != 3 or draws.shape[0] != n_obs:
        raise ValueError(
            f"draws must be (O, B, n_params) with O = {n_obs}; got {draws.shape}"
        )
    sf, q, dof, bin_z = _gof_core(model, obs_batch, noise_var, draws, max_draws, seed)
    return BatchGOFResult(p_values=sf.mean(axis=1), dof=dof, q_mean=q.mean(axis=1), bin_z=bin_z)
