"""The port's simulation-based calibration and posterior predictive checks
(``tpu21cmvae_torch/calibration.py``) against the JAX package's
(``tpu21cmvae/calibration.py``) on the same small model.

Tolerances: the KS p-value bit for bit (NumPy on both sides); the χ²
tails of ``_gof_core`` on the same draws, their means (the p-values) at
rtol 1e-4 and each draw's at rtol 2e-4 (each library's float32
``gammaincc`` is ~1e-4 off the exact tail, differently), the quadratic
forms and z-scores at rtol 1e-5 (predictions that agree to float32
rounding); the SBC truths
at 1e-6 of the box (the same NumPy draws through each package's prior
transform); the refusals with the same error and message; the SBC
uniformity at the JAX suite's own threshold.
"""

import numpy as np
import pytest
import torch
from _torch_pair import make_pair, one_torch_thread  # noqa: F401

from tpu21cmvae import calibration as jcal
from tpu21cmvae import noisescale as jns
from tpu21cmvae import priors as jpriors
from tpu21cmvae.sampling.results import BatchSampleResult as JaxBatch
from tpu21cmvae.sampling.results import SampleResult as JaxResult
from tpu21cmvae_torch import calibration as tcal
from tpu21cmvae_torch import noisescale as tns
from tpu21cmvae_torch import priors as tpriors
from tpu21cmvae_torch.sampling.results import BatchSampleResult, SampleResult


@pytest.fixture(scope="module")
def pair(splits):
    return make_pair(splits, (32,))


@pytest.fixture(scope="module")
def bounds(splits):
    par = np.asarray(splits.par_train, np.float64)
    lo, hi = par.min(0), par.max(0)
    lo[:3] = np.maximum(lo[:3], 1e-6)
    return np.stack([lo, hi], axis=1)


@pytest.fixture(scope="module")
def survey(pair, splits, bounds):
    """Three observations and 200 draws per observation scattered around
    each truth (inside the box): stand-ins for posterior draws."""
    _, tm = pair
    rng = np.random.default_rng(11)
    truths = np.asarray(splits.par_test[:3], np.float32)
    obs = tm.predict(truths) + rng.normal(0.0, 5.0, (3, 451))
    span = bounds[:, 1] - bounds[:, 0]
    draws = truths[:, None, :] + 0.003 * span * rng.normal(size=(3, 200, 7))
    draws = np.clip(draws, bounds[:, 0], bounds[:, 1]).astype(np.float32)
    return obs.astype(np.float64), draws


def test_ks_uniform_pvalue_matches_jax():
    rng = np.random.default_rng(4)
    for u in (rng.uniform(size=500), rng.uniform(size=500) ** 3, rng.uniform(size=7),
              np.full(40, 0.5)):
        assert tcal._ks_uniform_pvalue(u) == jcal._ks_uniform_pvalue(u)
    assert tcal._ks_uniform_pvalue(rng.uniform(size=500)) > 0.01
    assert tcal._ks_uniform_pvalue(rng.uniform(size=500) ** 3) < 1e-6


def _spec(name, model, pkg):
    nv = np.linspace(20.0, 30.0, 451)
    if name == "scalar":
        return 25.0
    if name == "perbin":
        return nv
    if name == "fg":
        return model.marginalize_foreground(nv, n_terms=4)
    return model.marginalize_foreground(25.0, n_terms=5, prior_var=np.full(5, 100.0))


@pytest.mark.parametrize("spec", ["scalar", "perbin", "fg", "fg_proper"])
def test_gof_core_matches_jax(pair, survey, spec):
    """Per-draw χ² tails, quadratic forms, dof and per-bin z-scores of the
    scoring core equal JAX's on the same observations and draws, under
    each noise spec (the foreground-marginalized ones, flat and proper,
    take the GLS-cleaned z-scores and their own dof); the subsampling to
    ``max_draws`` picks the same draws."""
    jm, tm = pair
    obs, draws = survey
    got = tcal._gof_core(tm, obs, _spec(spec, tm, "torch"), draws, 128, 0)
    want = jcal._gof_core(jm, obs, _spec(spec, jm, "jax"), draws, 128, 0)
    sf, q, dof, bin_z = got
    assert dof == want[2] and sf.shape == (3, 128) and sf.dtype == np.float32
    assert 0.05 < float(np.median(sf)) < 0.95  # tails away from 0 and 1
    np.testing.assert_allclose(q, want[1], rtol=1e-5)
    np.testing.assert_allclose(bin_z, want[3], rtol=1e-5, atol=1e-5)
    # the p-values (each observation's mean tail) at rtol 1e-4; one draw's
    # tail at rtol 2e-4 (see the next test)
    np.testing.assert_allclose(sf.mean(axis=1), np.asarray(want[0]).mean(axis=1), rtol=1e-4)
    np.testing.assert_allclose(sf, np.asarray(want[0]), rtol=2e-4)


def test_chi2_tail_matches_jax_on_the_same_forms():
    """``torch.special.gammaincc`` in float32 against JAX's on the same
    quadratic forms, where the tails exceed 1e-30: each library's float32
    tail is within ~1.2e-4 relative of SciPy's float64 one at 451 bins
    (measured), so the two agree to rtol 2e-4 and not closer."""
    from jax.scipy.special import gammaincc
    from scipy.special import gammaincc as exact

    for dof, q in ((451.0, np.linspace(300.0, 650.0, 701)), (447.0, np.linspace(300.0, 650.0, 71)),
                   (7.0, np.linspace(0.0, 40.0, 81))):
        a, x = np.float32(dof / 2.0), (q / 2.0).astype(np.float32)
        got = torch.special.gammaincc(torch.tensor(a), torch.as_tensor(x)).numpy()
        want = np.asarray(gammaincc(a, x))
        ref = exact(np.float64(a), x.astype(np.float64))
        big = ref > 1e-30
        np.testing.assert_allclose(got[big], want[big], rtol=2e-4)
        np.testing.assert_allclose(got[big], ref[big], rtol=2e-4)
        assert (got[~big] < 1e-29).all()


def test_goodness_of_fit_matches_jax(pair, survey):
    """``goodness_of_fit`` over a ``SampleResult`` (its stored chain, or
    its final walkers when none is stored) and over an array, and
    ``goodness_of_fit_batch`` over a ``BatchSampleResult`` and an
    ``(O, B, P)`` array, give JAX's p-values (rtol 1e-4) and flags."""
    jm, tm = pair
    obs, draws = survey
    chain = draws.reshape(3, 4, 50, 7).transpose(1, 0, 2, 3).reshape(4, 150, 7)
    fields = dict(chain=chain, final=chain[-1], logp=np.zeros(150, np.float32),
                  accept_rate=np.ones(4, np.float32), step_size=0.1)
    mine, theirs = SampleResult(**fields), JaxResult(**fields)
    bare = dict(fields, chain=np.zeros((0, 150, 7), np.float32))
    for a, b in ((mine, theirs), (draws[0], draws[0]), (SampleResult(**bare), JaxResult(**bare))):
        g = tm.goodness_of_fit(obs[0], 25.0, a, max_draws=64, seed=2)
        w = jm.goodness_of_fit(obs[0], 25.0, b, max_draws=64, seed=2)
        assert g.dof == w.dof and g.q.shape == w.q.shape
        np.testing.assert_allclose(g.p_value, w.p_value, rtol=1e-4)
        np.testing.assert_allclose(g.q, w.q, rtol=1e-5)
        assert g.summary().split(":")[-1] == w.summary().split(":")[-1]
    g = tm.goodness_of_fit_batch(obs, 25.0, BatchSampleResult(n_obs=3, result=mine))
    w = jm.goodness_of_fit_batch(obs, 25.0, JaxBatch(n_obs=3, result=theirs))
    np.testing.assert_allclose(g.p_values, w.p_values, rtol=1e-4)
    np.testing.assert_allclose(g.q_mean, w.q_mean, rtol=1e-5)
    np.testing.assert_array_equal(g.flagged, w.flagged)
    g = tm.goodness_of_fit_batch(obs, 25.0, draws, max_draws=32)
    w = jm.goodness_of_fit_batch(obs, 25.0, draws, max_draws=32)
    np.testing.assert_allclose(g.p_values, w.p_values, rtol=1e-4)
    assert g.summary() == w.summary()


def _error(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_gof_refusals_match_jax(pair, survey):
    """The GOF checks refuse what JAX refuses, with its messages: a
    marginalized noise level, missing draws, a batch result into the
    single check, draws of the wrong rank or observation count."""
    jm, tm = pair
    obs, draws = survey
    fields = dict(chain=draws.reshape(1, 600, 7), final=draws.reshape(600, 7),
                  logp=np.zeros(600, np.float32), accept_rate=np.ones(1, np.float32),
                  step_size=0.1)
    cases = [
        (lambda m, ns, B, R: m.goodness_of_fit(obs[0], ns.marginalize_noise_scale(25.0),
                                               draws[0])),
        (lambda m, ns, B, R: m.goodness_of_fit(obs[0], 25.0)),
        (lambda m, ns, B, R: m.goodness_of_fit(obs[0], 25.0, B(n_obs=3, result=R(**fields)))),
        (lambda m, ns, B, R: m.goodness_of_fit_batch(obs, ns.marginalize_noise_scale(25.0),
                                                     draws)),
        (lambda m, ns, B, R: m.goodness_of_fit_batch(obs, 25.0)),
        (lambda m, ns, B, R: m.goodness_of_fit_batch(obs, 25.0, draws[0])),
        (lambda m, ns, B, R: m.goodness_of_fit_batch(obs[:2], 25.0,
                                                     B(n_obs=3, result=R(**fields)))),
    ]
    for case in cases:
        assert (_error(lambda: case(tm, tns, BatchSampleResult, SampleResult))
                == _error(lambda: case(jm, jns, JaxBatch, JaxResult)))


def test_sbc_truths_match_jax_and_refusals(pair, bounds):
    """The same seed gives the JAX package's truths (uniform in the box,
    or through a Gaussian prior's unit-cube transform) and the same
    observations' noise; the refusals (no stored chain, a prior box that
    is not the sampler's) raise JAX's errors; a prior's box becomes the
    chains' box when ``bounds`` is omitted."""
    jm, tm = pair
    lo, hi = bounds[:, 0], bounds[:, 1]
    mid = 0.5 * (lo + hi)
    custom = np.stack([lo + 0.2 * (mid - lo), hi - 0.2 * (hi - mid)], axis=1)
    mean, sigma = [None] * 7, [None] * 7
    mean[3], sigma[3] = mid[3], 0.2 * (hi[3] - lo[3])
    tprior = tpriors.GaussianBoxPrior.build(mean, sigma, bounds=custom)
    jprior = jpriors.GaussianBoxPrior.build(mean, sigma, bounds=custom)
    kw = dict(noise_var=25.0, n_sims=3, n_walkers=8, n_steps=4, n_warmup=4, thin=2, seed=5)
    for tp, jp, b in ((None, None, bounds), (tprior, jprior, None)):
        got = tcal.sbc(tm, prior=tp, bounds=b, **kw)
        want = jcal.sbc(jm, prior=jp, bounds=b, **kw)
        box = custom if tp is not None else bounds
        np.testing.assert_allclose(got.thetas, want.thetas,
                                   atol=1e-6 * (box[:, 1] - box[:, 0]).max())
        assert got.ranks.shape == (3, 7) and got.n_posterior == 8
        assert ((got.ranks >= 0) & (got.ranks <= 8)).all()
        assert (got.thetas >= box[:, 0] - 1e-6).all() and (got.thetas <= box[:, 1] + 1e-6).all()
    assert (_error(lambda: tcal.sbc(tm, **dict(kw, thin=0), bounds=bounds))
            == _error(lambda: jcal.sbc(jm, **dict(kw, thin=0), bounds=bounds)))
    assert (_error(lambda: tcal.sbc(tm, prior=tprior, bounds=bounds, **kw))
            == _error(lambda: jcal.sbc(jm, prior=jprior, bounds=bounds, **kw)))


def test_sbc_calibrated_on_own_forward_model(pair, bounds):
    """``tests/test_calibration.py::test_sbc_calibrated_on_own_forward_model``
    in the port (64 simulations where the JAX suite takes 96): uniform
    truths, the model's own forward model plus noise, batched MH
    posteriors; no parameter's ranks reject uniformity at 0.005."""
    _, tm = pair
    res = tcal.sbc(tm, n_sims=64, n_walkers=64, n_steps=250, n_warmup=400, thin=10,
                   noise_var=25.0, bounds=bounds, seed=0)
    assert res.ranks.shape == (64, 7)
    assert (res.ranks >= 0).all() and (res.ranks <= 64).all()
    assert (res.pvalues > 0.005).all(), res.summary()
    assert "calibrated" in res.summary()
    np.testing.assert_array_equal(res.normalized, (res.ranks + 0.5) / 65.0)


def test_gof_on_sampled_posteriors(pair, splits, bounds):
    """``tests/test_calibration.py::test_gof_calibrated_and_misfit_teeth``
    in part: the port's own MH draws of a self-generated observation
    pass the check with q/dof near 1, and an un-modeled foreground drives
    p to 0."""
    _, tm = pair
    rng = np.random.default_rng(7)
    truth = np.asarray(splits.par_test[0], np.float32)
    clean = np.asarray(tm.predict(truth))
    obs = clean + rng.normal(0.0, 5.0, clean.shape)
    common = dict(sampler="mh", n_walkers=256, n_steps=150, n_warmup=300, thin=10,
                  bounds=bounds, seed=0)
    gof = tm.goodness_of_fit(obs, 25.0, tm.sample_posterior(obs, 25.0, **common))
    assert 0.01 < gof.p_value < 0.99, gof.summary()
    assert gof.dof == 451 and abs(float(np.mean(gof.q)) / gof.dof - 1.0) < 0.15
    nu = np.asarray(tm.frequencies, np.float64)
    obs_bad = obs + 40.0 * (nu / nu.mean()) ** -2.5
    bad = tm.goodness_of_fit(obs_bad, 25.0, tm.sample_posterior(obs_bad, 25.0, **common))
    assert bad.p_value < 0.01 and "MISFIT" in bad.summary()
    assert np.abs(bad.bin_z).max() > 3.0
    with torch.no_grad():
        assert torch.isfinite(torch.as_tensor(gof.bin_z)).all()
