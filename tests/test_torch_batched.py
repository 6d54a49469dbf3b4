"""The port's batched posteriors and chunked sampling against the JAX
package: ``BatchSampleResult`` (``tpu21cmvae/sampling/results.py``),
``run_batched_chain`` and ``sample_to_ess``
(``tpu21cmvae/sampling/driver.py``), and the ``DirectEmulator`` entry
points that reach them and the adaptive samplers.

Tolerances: the result views bit for bit on the same arrays (NumPy on
both sides); batched against per-observation runs, and the port's batch
against the JAX package's, in moments at the tolerance of
``tests/test_calibration.py::test_batched_sampling_matches_per_obs``
(means within 4·max(std)/√50 + 2 % of the span: the chains differ, the
posteriors do not); ``sample_to_ess`` at the JAX suite's own assertions.
"""

import numpy as np
import pytest
import torch
from _torch_pair import make_pair, one_torch_thread, train_box  # noqa: F401

from tpu21cmvae.sampling.results import BatchSampleResult as JaxBatch
from tpu21cmvae.sampling.results import SampleResult as JaxResult
from tpu21cmvae_torch.sampling.driver import run_batched_chain, sample_to_ess
from tpu21cmvae_torch.sampling.gradient import ChEESSampleResult, NUTSSampleResult
from tpu21cmvae_torch.sampling.results import BatchSampleResult, SampleResult


@pytest.mark.parametrize("steps", ["per_block", "pooled", "none"])
def test_batch_result_views_match_jax(steps):
    """``chain``, ``flat``, ``per_obs`` and ``walkers_per_obs`` equal the
    JAX views on the same arrays; ``per_obs`` takes its block's own step
    where there is one per observation, else the pooled one."""
    rng = np.random.default_rng(5)
    chain = rng.normal(size=(6, 3 * 4, 2)).astype(np.float32)
    bss = {"per_block": np.array([0.1, 0.2, 0.3], np.float32),
           "pooled": np.array([0.2], np.float32), "none": None}[steps]
    fields = dict(chain=chain, final=chain[-1], logp=rng.normal(size=12).astype(np.float32),
                  accept_rate=rng.uniform(size=6).astype(np.float32), step_size=0.2,
                  block_step_sizes=bss)
    mine = BatchSampleResult(n_obs=3, result=SampleResult(**fields))
    theirs = JaxBatch(n_obs=3, result=JaxResult(**fields))
    assert mine.walkers_per_obs == theirs.walkers_per_obs == 4
    np.testing.assert_array_equal(mine.chain, theirs.chain)
    for i in range(3):
        np.testing.assert_array_equal(mine.flat(i), theirs.flat(i))
        a, b = mine.per_obs(i), theirs.per_obs(i)
        for name in ("chain", "final", "logp", "accept_rate"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        assert a.step_size == b.step_size
        np.testing.assert_allclose(a.ess(), b.ess(), rtol=1e-12)


@pytest.fixture(scope="module")
def pair(splits):
    return make_pair(splits, (32,))


@pytest.fixture(scope="module")
def bounds(splits):
    par = np.asarray(splits.par_train, np.float64)
    lo, hi = par.min(0), par.max(0)
    lo[:3] = np.maximum(lo[:3], 1e-6)
    return np.stack([lo, hi], axis=1)


def _moments_agree(got, want, span):
    tol = 4.0 * np.maximum(got.std(0), want.std(0)) / np.sqrt(50)
    return (np.abs(got.mean(0) - want.mean(0)) < tol + 0.02 * span).all()


def test_batched_sampling_matches_per_obs(pair, splits, bounds):
    """``tests/test_calibration.py::test_batched_sampling_matches_per_obs``
    in the port, plus the JAX package's batch on the same model and
    observations: two stacked observations sample the posteriors their
    solo runs sample, in moments, and the views unstack consistently; the
    stretch move and ChEES are refused."""
    jm, tm = pair
    rng = np.random.default_rng(2)
    truths = np.asarray(splits.par_test[:2], np.float32)
    obs_batch = tm.predict(truths) + rng.normal(0, 5.0, (2, 451))
    common = dict(n_steps=200, n_warmup=200, thin=5, bounds=bounds)
    batch = tm.sample_posterior_batch(obs_batch, 25.0, sampler="mh", n_walkers=128, seed=0,
                                      **common)
    theirs = jm.sample_posterior_batch(obs_batch, 25.0, sampler="mh", n_walkers=128, seed=0,
                                       **common)
    assert batch.chain.shape == theirs.chain.shape and batch.chain.shape[1:] == (2, 128, 7)
    assert batch.walkers_per_obs == 128
    assert batch.result.block_step_sizes.shape == (2,)
    span = bounds[:, 1] - bounds[:, 0]
    for o in range(2):
        solo = tm.sample_posterior(obs_batch[o], 25.0, sampler="mh", n_walkers=128, seed=7,
                                   **common)
        got = batch.flat(o)
        assert _moments_agree(got, solo.flat, span)
        assert _moments_agree(got, theirs.flat(o), span)
        np.testing.assert_array_equal(batch.per_obs(o).flat, got)
    for refused in ("ensemble", "chees"):
        with pytest.raises(ValueError, match="stretch"):
            tm.sample_posterior_batch(obs_batch, 25.0, sampler=refused)


@pytest.mark.parametrize("sampler", ["hmc", "nuts"])
def test_batched_gradient_samplers(pair, splits, bounds, sampler):
    """``test_batched_hmc_smoke`` and ``test_batched_nuts_smoke``: HMC and
    NUTS over the stacked-observation value+gradient, one step per
    observation block (NUTS also one metric per block), finite walkers
    that stay near their own truths' posteriors."""
    _, tm = pair
    rng = np.random.default_rng(3)
    truths = np.asarray(splits.par_test[:2], np.float32)
    obs_batch = tm.predict(truths) + rng.normal(0, 5.0, (2, 451))
    extra = {"hmc": dict(n_leapfrog=4), "nuts": dict(max_depth=4)}[sampler]
    batch = tm.sample_posterior_batch(obs_batch, 25.0, sampler=sampler, n_walkers=32,
                                      n_steps=30, n_warmup=40, thin=5, bounds=bounds, seed=0,
                                      **extra)
    assert batch.chain.shape[1:] == (2, 32, 7)
    assert np.isfinite(batch.result.logp).all()
    assert batch.result.block_step_sizes.shape == (2,)
    if sampler == "nuts":
        assert isinstance(batch.result, NUTSSampleResult)


def test_run_batched_chain_forwards_and_refuses():
    """The dispatcher builds only the function its sampler needs, gives
    the samplers ``adapt_blocks=n_obs`` unless told otherwise, and
    refuses the ensemble and ChEES with the JAX message."""
    built = []

    def loglik(params, x):
        return -0.5 * torch.sum(x**2, dim=-1)

    def lazy(fn):
        def build():
            built.append(fn)
            return fn
        return build

    bounds = np.array([[-3.0, 3.0]] * 2)
    res = run_batched_chain("mh", None, 2, 16, loglik_builder=lazy(loglik),
                            valgrad_builder=lazy(None), bounds=bounds, n_steps=4, n_warmup=4,
                            thin=1, device="cpu")
    assert built == [loglik] and res.result.block_step_sizes.shape == (2,)
    res = run_batched_chain("mh", None, 2, 16, loglik_builder=lazy(loglik), bounds=bounds,
                            n_steps=4, n_warmup=4, thin=1, adapt_blocks=1, device="cpu")
    assert res.result.block_step_sizes.shape == (1,)
    for sampler in ("ensemble", "chees", "pt"):
        with pytest.raises(ValueError, match="'mh', 'hmc' or 'nuts'"):
            run_batched_chain(sampler, None, 2, 16, bounds=bounds, device="cpu")


def test_sample_to_ess_reaches_target():
    """``tests/test_sampling.py::test_sample_to_ess_reaches_target``: the
    chunked chain reaches bulk ESS 3000 on a standard normal and is exact
    on the way; a chain that is not stored, or chunks too short to
    thin, are refused."""
    bounds = np.array([[-5.0, 5.0]] * 2)

    def loglik(params, x):
        return -0.5 * torch.sum(x * x, dim=-1)

    res = sample_to_ess(loglik, None, target_ess=3000, chunk_steps=100, n_walkers=128,
                        n_warmup=150, thin=10, bounds=bounds, seed=0, max_chunks=30,
                        device="cpu")
    assert res.ess().min() >= 3000
    tail = res.ess_tail()
    assert np.isfinite(tail).all() and tail.min() >= 3000
    assert np.allclose(res.flat.mean(0), 0.0, atol=0.1)
    assert np.allclose(res.flat.std(0), 1.0, rtol=0.1)
    assert res.chain.shape[0] % 10 == 0 and res.chain.shape[0] < 30 * 10
    with pytest.raises(ValueError, match="thin"):
        sample_to_ess(loglik, None, thin=0, bounds=bounds, device="cpu")
    with pytest.raises(ValueError, match="chunk_steps"):
        sample_to_ess(loglik, None, chunk_steps=30, thin=10, bounds=bounds, device="cpu")


def test_sample_to_ess_continues_each_chunk(monkeypatch):
    """Chunk 1 warms up from the caller's ``x0``; each continuation
    starts at the last chunk's walkers with no warmup, at the adapted
    scale, with seed ``seed + 7919·i``; ``max_chunks`` bounds the run."""
    import tpu21cmvae_torch.sampling.driver as drv

    calls, real = [], drv.sample_mh

    def spy(loglik, params, **kw):
        calls.append(kw)
        return real(loglik, params, **kw)

    def loglik(params, x):
        return -0.5 * torch.sum(x * x, dim=-1)

    x0 = np.full((32, 2), 0.5, np.float32)
    bounds = np.array([[-5.0, 5.0]] * 2)
    monkeypatch.setattr(drv, "sample_mh", spy)
    res = sample_to_ess(loglik, None, target_ess=1e9, n_steps=40, n_walkers=32, n_warmup=20,
                        thin=10, bounds=bounds, seed=3, max_chunks=3, x0=x0, step_frac=0.1,
                        device="cpu")
    assert len(calls) == 3 and res.chain.shape == (12, 32, 2)
    assert calls[0]["x0"] is x0 and calls[0]["step_frac"] == 0.1 and calls[0]["n_warmup"] == 20
    for i, kw in enumerate(calls[1:], start=1):
        assert kw["n_warmup"] == 0 and kw["seed"] == 3 + 7919 * i
        assert kw["step_frac"] == pytest.approx(res.step_size / 10.0)
    assert res.accept_rate.shape == (120,)


def test_model_level_target_ess(pair, splits, bounds):
    """``tests/test_sampling.py::test_model_level_target_ess``: MH with
    ``target_ess=`` dispatches to ``sample_to_ess`` from
    ``sample_posterior``, ``n_steps`` taken as the chunk size; the run
    either reaches the target or spends its chunks."""
    _, tm = pair
    obs = tm.predict(splits.par_test[0])
    res = tm.sample_posterior(obs, 25.0, sampler="mh", bounds=bounds, target_ess=50.0,
                              n_walkers=64, n_steps=40, n_warmup=60, thin=10, seed=0,
                              max_chunks=12)
    tail = res.ess_tail()
    tail_min = np.nanmin(tail) if np.isfinite(tail).any() else 0.0
    converged = min(res.ess().min(), tail_min) >= 50.0
    exhausted = res.chain.shape[0] == 12 * (40 // 10)
    assert converged or exhausted
    assert res.chain.shape[1:] == (64, 7)


@pytest.mark.parametrize("sampler", ["chees", "nuts"])
def test_sample_posterior_adaptive_samplers(pair, splits, bounds, sampler):
    """``sample_posterior(sampler="chees"|"nuts")`` runs on a CPU model
    through the memoized value+gradient function HMC uses, and returns
    the sampler's own result type with finite walkers."""
    _, tm = pair
    obs = tm.predict(splits.par_test[0]) + np.random.default_rng(4).normal(0, 3.0, 451)
    vg = tm._hmc_valgrad(obs, 9.0)
    extra = {"chees": dict(max_leapfrog=16), "nuts": dict(max_depth=4)}[sampler]
    res = tm.sample_posterior(obs, 9.0, sampler=sampler, bounds=bounds, n_walkers=32,
                              n_steps=20, n_warmup=30, thin=5, seed=0, **extra)
    assert isinstance(res, {"chees": ChEESSampleResult, "nuts": NUTSSampleResult}[sampler])
    assert res.chain.shape == (4, 32, 7) and np.isfinite(res.logp).all()
    assert tm.loglik_and_grad_fn(obs, 9.0, backend="torch", grad_precision="default") is vg


def test_sample_posterior_refusals(pair, splits, bounds):
    """Every sampler, the tempered and sequential ones included, and the
    fits refuse a ``mesh=`` that is not a ``Mesh``, naming it, not a
    ROADMAP item number; the flow evidence takes no mesh, as JAX's; it
    runs and returns its result."""
    from tpu21cmvae_torch.flows import FlowEvidenceResult

    _, tm = pair
    obs = tm.predict(splits.par_test[0])
    with pytest.raises(ValueError, match="sampler must be"):
        tm.sample_posterior(obs, 25.0, sampler="gibbs")
    for sampler in ("hmc", "chees", "nuts", "mh", "ensemble", "pt", "smc"):
        with pytest.raises(TypeError, match="Mesh"):
            tm.sample_posterior(obs, 25.0, sampler=sampler, bounds=bounds, mesh=object())
    with pytest.raises(TypeError, match="Mesh") as err:
        tm.fit_params(obs, 25.0, bounds=bounds, mesh=object())
    assert "item" not in str(err.value)
    res = tm.log_evidence(obs, 25.0, bounds=bounds, method="flow", n_steps=20, warm_steps=10,
                          n_mc=32, n_is=256)
    assert isinstance(res, FlowEvidenceResult) and np.isfinite(res.logz)
    with pytest.raises(TypeError, match="mesh"):  # the flow evidence takes none, as JAX's
        tm.log_evidence(obs, 25.0, bounds=bounds, method="flow", mesh=object())


_SIGNATURES = {
    "DirectEmulator.sample_posterior_batch": ("models.direct",
                                              "DirectEmulator.sample_posterior_batch"),
    "DirectEmulator.fit_params": ("models.direct", "DirectEmulator.fit_params"),
    "DirectEmulator.profile_likelihood": ("models.direct", "DirectEmulator.profile_likelihood"),
    "DirectEmulator.goodness_of_fit": ("models.direct", "DirectEmulator.goodness_of_fit"),
    "DirectEmulator.goodness_of_fit_batch": ("models.direct",
                                             "DirectEmulator.goodness_of_fit_batch"),
    "calibration.sbc": ("calibration", "sbc"),
    "sampling.gradient.sample_chees": ("sampling.gradient", "sample_chees"),
    "sampling.gradient.sample_nuts": ("sampling.gradient", "sample_nuts"),
    "sampling.fit.fit_map": ("sampling.fit", "fit_map"),
    "sampling.fit.profile_likelihood": ("sampling.fit", "profile_likelihood"),
    "sampling.driver.sample_to_ess": ("sampling.driver", "sample_to_ess"),
    "sampling.driver.run_batched_chain": ("sampling.driver", "run_batched_chain"),
}


@pytest.mark.parametrize("name", sorted(_SIGNATURES))
def test_entry_point_signatures_match_jax(name):
    """Each new entry point takes the JAX package's parameters, with their
    defaults, in the same order; the sampling functions add only the
    required keyword ``device``."""
    import importlib
    import inspect

    module, attr = _SIGNATURES[name]

    def params(pkg):
        obj = importlib.import_module(f"{pkg}.{module}")
        for part in attr.split("."):
            obj = getattr(obj, part)
        return [(p.name, p.kind, p.default) for p in inspect.signature(obj).parameters.values()]

    mine, theirs = params("tpu21cmvae_torch"), params("tpu21cmvae")
    if mine != theirs:
        device = ("device", inspect.Parameter.KEYWORD_ONLY, inspect.Parameter.empty)
        assert module.startswith("sampling") and device in mine
        mine.remove(device)
    assert mine == theirs
