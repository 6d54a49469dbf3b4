"""Cross-sampler drivers: the batched-observation dispatcher
(:func:`run_batched_chain`) and the run-until-converged loop
(:func:`sample_to_ess`) — the port of ``tpu21cmvae/sampling/driver.py``.
"""

from __future__ import annotations

import numpy as np

from tpu21cmvae_torch.sampling._common import _resolve_bounds, _shard_rows
from tpu21cmvae_torch.sampling.gradient import sample_hmc, sample_nuts
from tpu21cmvae_torch.sampling.mh import sample_mh
from tpu21cmvae_torch.sampling.results import BatchSampleResult, SampleResult


def run_batched_chain(
    sampler: str,
    params,
    n_obs: int,
    n_walkers: int,
    *,
    loglik_builder=None,
    valgrad_builder=None,
    bounds=None,
    **kwargs,
) -> BatchSampleResult:
    """Run ``n_obs`` posteriors' walkers (``n_walkers`` each,
    observation-major) through ONE :func:`sample_mh` / :func:`sample_hmc`
    / :func:`sample_nuts` chain over a stacked-observation likelihood,
    built lazily by ``loglik_builder()`` (MH) or ``valgrad_builder()``
    (HMC, NUTS). The samplers get ``adapt_blocks=n_obs`` unless kwargs
    say otherwise: each observation's slab adapts its own proposal scale
    or leapfrog step, and under NUTS its own ensemble metric. The stretch
    move is refused (its pairing would propose across observations), and
    so is ChEES (one trajectory length for the whole ensemble). kwargs
    forward to the sampler (``device=`` among them), but for ``mesh=``:
    the stacked walker axis (``n_obs · n_walkers``) divides over it, as in
    JAX, and each observation's rows of every likelihood call split over
    its devices (:func:`~tpu21cmvae_torch.sampling._common._shard_rows`
    with ``groups=n_obs``: a stacked likelihood reads its rows
    observation-major)."""
    total = n_obs * n_walkers
    kwargs.setdefault("adapt_blocks", n_obs)
    mesh = kwargs.pop("mesh", None)

    def split(fn):
        return _shard_rows(fn, mesh, total, groups=n_obs)

    if sampler == "mh":
        return BatchSampleResult(n_obs=n_obs, result=sample_mh(
            split(loglik_builder()), params, n_walkers=total, bounds=bounds, **kwargs))
    if sampler in ("hmc", "nuts"):
        run = sample_hmc if sampler == "hmc" else sample_nuts
        return BatchSampleResult(n_obs=n_obs, result=run(
            split(valgrad_builder()), params, n_walkers=total, bounds=bounds, **kwargs))
    raise ValueError(
        "sampler must be 'mh', 'hmc' or 'nuts' for batched "
        "observations (the stretch move pairs across observations; "
        f"ChEES adapts one shared trajectory); got {sampler!r}"
    )


def sample_to_ess(
    loglik,
    params,
    *,
    target_ess: float = 10_000.0,
    chunk_steps: int = 200,
    n_steps: int = None,
    max_chunks: int = 25,
    n_walkers: int = 1024,
    n_warmup: int = 200,
    thin: int = 10,
    bounds=None,
    seed: int = 0,
    **kwargs,
) -> SampleResult:
    """Run :func:`sample_mh` in chunks of ``chunk_steps`` until the
    smallest per-parameter effective sample size of the accumulated
    chain, the minimum over bulk and tail ESS (Vehtari et al. 2021 §4.3)
    with every tail ESS finite, reaches ``target_ess``, or
    ``max_chunks`` chunks ran. Chunk 1 warms up from the user's
    ``step_frac`` (default 0.05) and ``x0``; each later chunk continues
    from the last one's walkers without warmup, at the adapted scale
    (``step_frac = step_size / mean span``) and with seed
    ``seed + 7919·i``. ``n_steps`` is an alias of ``chunk_steps``, so
    ``sample_posterior(sampler="mh", target_ess=N, n_steps=…)`` composes.
    kwargs forward to :func:`sample_mh` (``device=``, ``log_prior=``, …).
    The JAX package reuses one compiled program per chunk shape; the
    port has none to keep, so each chunk is a new Python loop: the
    draws are the same, only the cost differs.
    """
    if n_steps is not None:
        chunk_steps = n_steps
    if thin <= 0:
        raise ValueError("sample_to_ess needs a stored chain; thin > 0")
    if chunk_steps // thin < 4:
        raise ValueError(
            f"chunk_steps must keep >= 4 thinned steps; got "
            f"{chunk_steps} with thin={thin}"
        )
    lo, hi = _resolve_bounds(bounds, "cpu")
    span_mean = float((hi - lo).mean())
    # step_frac and x0 apply to the first chunk only: continuations pass
    # their own (the adapted scale, the final state)
    first_step_frac = kwargs.pop("step_frac", 0.05)
    first_x0 = kwargs.pop("x0", None)
    res = sample_mh(
        loglik, params, n_walkers=n_walkers, n_steps=chunk_steps,
        n_warmup=n_warmup, thin=thin, bounds=bounds, seed=seed,
        step_frac=first_step_frac, x0=first_x0, **kwargs,
    )
    chains, rates = [res.chain], [res.accept_rate]
    step_size = res.step_size
    step_frac_cont = step_size / span_mean
    for i in range(1, max_chunks):
        full = np.concatenate(chains)
        probe = SampleResult(
            chain=full, final=res.final, logp=res.logp,
            accept_rate=np.concatenate(rates), step_size=step_size,
        )
        if full.shape[0] >= 4:
            # a NaN tail ESS (a parameter whose chains never toggled the
            # indicator) counts as not converged
            tail = probe.ess_tail()
            if (np.isfinite(tail).all()
                    and min(probe.ess().min(), tail.min()) >= target_ess):
                break
        res = sample_mh(
            loglik, params, n_walkers=n_walkers, n_steps=chunk_steps,
            n_warmup=0, thin=thin, bounds=bounds, seed=seed + 7919 * i,
            x0=res.final, step_frac=step_frac_cont, **kwargs,
        )
        chains.append(res.chain)
        rates.append(res.accept_rate)
    return SampleResult(
        chain=np.concatenate(chains),
        final=res.final,
        logp=res.logp,
        accept_rate=np.concatenate(rates),
        step_size=step_size,
    )
