"""Fisher forecasting and posterior-predictive bands in the PyTorch port
(``tpu21cmvae_torch/ops/fisher.py``, ``sampling/predictive.py`` and their
``DirectEmulator`` entry points), held to the JAX package on the same
weights and inputs: Jacobians and Fisher matrices within 1e-4 of their
largest entry, ``forecast_errors`` and ``posterior_predictive`` bit-equal
on the same inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_pair import make_pair, one_torch_thread  # noqa: F401

from tpu21cmvae import noisescale as jns
from tpu21cmvae.ops import fisher as jfisher
from tpu21cmvae.sampling import posterior_predictive as jax_posterior_predictive
from tpu21cmvae_torch.noisescale import marginalize_noise_scale
from tpu21cmvae_torch.ops.fisher import forecast_errors, make_fisher, make_signal_jacobian
from tpu21cmvae_torch.sampling.predictive import PredictiveBand, posterior_predictive

THETA = np.asarray([0.05, 16.5, 1.0, 0.06, 1.3, 2.0, 30.0], np.float32)


@pytest.fixture(scope="module")
def pair(splits):
    return make_pair(splits, (24, 24))


@pytest.fixture(scope="module")
def noise_shape():
    return np.random.default_rng(3).uniform(5.0, 50.0, 451)


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * np.abs(want).max())


def test_jacobian_matches_jax_and_finite_difference(pair, splits):
    """Forward-mode ∂T/∂θ == the JAX jacfwd (an fx == 0 fiducial too, whose
    clamped column is exactly 0) == central differences of predict."""
    jm, tm = pair
    jac = make_signal_jacobian(tm.config, tm.normalizer)
    jjac = jfisher.make_signal_jacobian(jm.config, jm.normalizer)
    theta = np.asarray(splits.par_test[3], np.float32)
    with torch.no_grad():
        J = jac(tm.params, torch.as_tensor(theta)).numpy()
    assert J.shape == (451, 7)
    _close(J, jjac(jm.params, jnp.asarray(theta)))
    zero_fx = theta.copy()
    zero_fx[2] = 0.0
    with torch.no_grad():
        J0 = jac(tm.params, torch.as_tensor(zero_fx)).numpy()
    assert (J0[:, 2] == 0.0).all()
    _close(J0, jjac(jm.params, jnp.asarray(zero_fx)))
    eps = 1e-3 * np.maximum(np.abs(theta), 1e-3)
    J_fd = np.empty_like(J)
    for k in range(7):
        tp, tn = theta.copy(), theta.copy()
        tp[k] += eps[k]
        tn[k] -= eps[k]
        J_fd[:, k] = (tm.predict(tp) - tm.predict(tn)) / (2 * eps[k])
    scale = np.abs(J).max(axis=0, keepdims=True)
    np.testing.assert_allclose(J / scale, J_fd / scale, atol=2e-2)


@pytest.mark.parametrize("spec", ["scalar", "perbin", "fg_flat", "fg_proper", "scale", "scale_fg"])
def test_fisher_matches_jax(pair, splits, noise_shape, spec):
    """``make_fisher`` and ``fisher_forecast`` under every noise spec, one
    fiducial and a batch, against the JAX package: matrices within 1e-4
    of max|F|, the quoted sigmas within 1e-3."""
    jm, tm = pair

    def build(m, scale_fn):
        return {
            "scalar": lambda: 25.0,
            "perbin": lambda: noise_shape,
            "fg_flat": lambda: m.marginalize_foreground(noise_shape, n_terms=4),
            "fg_proper": lambda: m.marginalize_foreground(noise_shape, n_terms=4, prior_var=1e4),
            "scale": lambda: scale_fn(noise_shape, alpha=3.0, beta=2.0),
            "scale_fg": lambda: scale_fn(m.marginalize_foreground(noise_shape, n_terms=4),
                                         alpha=3.0, beta=2.0),
        }[spec]()

    nv_t, nv_j = build(tm, marginalize_noise_scale), build(jm, jns.marginalize_noise_scale)
    with torch.no_grad():
        F1 = make_fisher(tm.config, tm.normalizer, nv_t)(tm.params, torch.as_tensor(THETA))
    want1 = jfisher.make_fisher(jm.config, jm.normalizer, nv_j)(jm.params, jnp.asarray(THETA))
    assert F1.shape == (7, 7)
    _close(F1.numpy(), want1)
    np.testing.assert_allclose(F1.numpy(), F1.numpy().T, rtol=1e-5, atol=1e-7 * float(F1.max()))
    thetas = np.concatenate([THETA[None], np.asarray(splits.par_test[:3], np.float32)])
    F, sig = tm.fisher_forecast(thetas, nv_t)
    Fj, sigj = jm.fisher_forecast(thetas, nv_j)
    assert F.shape == (4, 7, 7) and sig.shape == (4, 7) and isinstance(F, np.ndarray)
    for got, want in zip(F, Fj):
        _close(got, want)
    np.testing.assert_allclose(sig, sigj, rtol=1e-3)
    Fs, sigs = tm.fisher_forecast(THETA, nv_t)
    assert Fs.shape == (7, 7) and sigs.shape == (7,)
    np.testing.assert_allclose(Fs, F[0], rtol=1e-6, atol=1e-7 * np.abs(F[0]).max())
    fn = tm.fisher_fn(nv_t)
    out = fn(tm.params, torch.as_tensor(thetas))
    assert not out.requires_grad
    np.testing.assert_array_equal(out.numpy(), F)


def test_fisher_student_t_correction(pair, noise_shape):
    """Fisher under a proper-prior ScaleMarginalNoise equals the plain
    Gaussian Fisher times the closed-form multivariate-t factor
    (alpha/beta)*(2a+n_eff)/(2a+n_eff+2), with n_eff = n − K when the base
    is a flat-prior MarginalizedNoise; Jeffreys raises."""
    _, tm = pair
    F0, sig0 = tm.fisher_forecast(THETA, noise_shape)
    sm = marginalize_noise_scale(noise_shape, alpha=3.0, beta=2.0)
    Ft, _ = tm.fisher_forecast(THETA, sm)
    n = tm.config.n_bins
    np.testing.assert_allclose(Ft, (3.0 / 2.0) * (6.0 + n) / (6.0 + n + 2.0) * F0, rtol=1e-5)
    mn = tm.marginalize_foreground(noise_shape, n_terms=4)
    Fm, sigm = tm.fisher_forecast(THETA, mn)
    Ftm, _ = tm.fisher_forecast(THETA, marginalize_noise_scale(mn, alpha=3.0, beta=2.0))
    want2 = (3.0 / 2.0) * (6.0 + (n - 4)) / (6.0 + (n - 4) + 2.0)
    np.testing.assert_allclose(Ftm, want2 * Fm, rtol=1e-5)
    # foreground marginalization can only LOSE information, in the matrix
    # AND in the quoted sigmas
    assert (np.diag(Fm) <= np.diag(F0) * (1 + 1e-6)).all()
    assert (sigm >= sig0 * (1 - 1e-9)).all()
    with pytest.raises(ValueError, match="Jeffreys"):
        tm.fisher_forecast(THETA, marginalize_noise_scale(noise_shape))


def test_forecast_errors_bit_equal():
    """The host eigensolve is a NumPy copy: bit-equal to the JAX module's
    on a well-conditioned matrix, a batch, and a rank-deficient one whose
    noise eigenvalues are clamped, not zeroed."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(5, 9, 7))
    F = np.einsum("bki,bkj->bij", a, a)
    np.testing.assert_array_equal(forecast_errors(F), jfisher.forecast_errors(F))
    np.testing.assert_array_equal(forecast_errors(F[0]), jfisher.forecast_errors(F[0]))
    low = a[0, :3].T @ a[0, :3]  # rank 3 of 7
    got = forecast_errors(low.astype(np.float32))
    np.testing.assert_array_equal(got, jfisher.forecast_errors(low.astype(np.float32)))
    assert np.isfinite(got).all() and (got > 0).all()
    np.testing.assert_array_equal(forecast_errors(F[1], rcond=1e-3),
                                  jfisher.forecast_errors(F[1], rcond=1e-3))


def test_fisher_forecast_cache_is_bounded(splits):
    """Distinct per-bin noise specs must not pin unbounded Fisher
    functions (LRU, cap 8), keyed by value through ``noise_key``; a spec
    object keys by its ``memo_key``."""
    _, tm = make_pair(splits, (8,))
    theta = splits.par_test[0]
    for i in range(10):
        noise = np.full(451, 1.0 + 0.1 * i, np.float32)
        _, sig = tm.fisher_forecast(theta, noise)
        assert np.isfinite(sig).all()
    assert len(tm._fisher_cache) <= 8
    nk = np.asarray(noise, np.float64)
    assert (nk.shape, nk.tobytes()) in tm._fisher_cache
    fn = tm._fisher_cache[(nk.shape, nk.tobytes())]
    tm.fisher_forecast(theta, noise.astype(np.float64))
    assert tm._fisher_cache[(nk.shape, nk.tobytes())] is fn  # value-identical: reused
    mn = tm.marginalize_foreground(25.0)
    tm.fisher_forecast(theta, mn)
    assert tm.marginalize_foreground(25.0).memo_key() in tm._fisher_cache


def test_posterior_predictive_bands():
    """``tests/test_sampling.py::test_posterior_predictive_bands`` on the
    port's copy, and every field bit-equal to the JAX function's on the
    same callable and samples."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 11))
    mu = np.array([1.0, -2.0, 0.5])
    sig = np.array([0.3, 0.1, 0.2])
    samples = mu + sig * rng.normal(size=(50_000, 3))

    def predict(x):
        return np.asarray(x) @ w

    band = posterior_predictive(predict, samples)
    assert isinstance(band, PredictiveBand)
    np.testing.assert_allclose(band.mean, mu @ w, atol=0.02)
    np.testing.assert_allclose(band.std, np.sqrt(((sig[:, None] * w) ** 2).sum(0)), rtol=0.03)
    assert (np.diff(band.bands, axis=0) > 0).all()
    np.testing.assert_allclose(band.bands[1], band.mean, atol=0.03)
    np.testing.assert_allclose((band.bands[2] - band.bands[0]) / 2.0, band.std, rtol=0.05)
    band2 = posterior_predictive(predict, samples, max_batch=1777)
    np.testing.assert_allclose(band2.bands, band.bands)
    bandn = posterior_predictive(predict, samples, noise_var=4.0, seed=1)
    assert (bandn.std > band.std).all()
    assert posterior_predictive(predict, mu).mean.shape == (11,)
    for kw in ({}, {"max_batch": 1777}, {"noise_var": 4.0, "seed": 1},
               {"quantiles": (0.025, 0.975)}):
        got = posterior_predictive(predict, samples, **kw)
        want = jax_posterior_predictive(predict, samples, **kw)
        for name in ("levels", "bands", "mean", "std"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


def test_model_posterior_predictive_contains_the_truth(pair, splits):
    """``DirectEmulator.posterior_predictive`` over a short HMC chain's
    draws: the 95 % band contains the truth signal in at least 80 % of the
    bins (the noise realization shifts the posterior: three seeds gave
    0.87-0.89) and its median lies within one noise sd of it everywhere;
    it equals the JAX model's band on the same draws to fp32 predict
    accuracy."""
    jm, tm = pair
    truth = np.asarray(splits.par_test[5], np.float32)
    sig = tm.predict(truth)
    obs = sig + np.random.default_rng(2).normal(0, 5.0, 451)
    res = tm.sample_posterior(obs, 25.0, n_walkers=128, n_warmup=100, n_steps=100, thin=10,
                              seed=1,
                              bounds=np.stack([splits.par_train.min(0), splits.par_train.max(0)],
                                              axis=1))
    band = tm.posterior_predictive(res.flat, quantiles=(0.025, 0.5, 0.975))
    assert band.bands.shape == (3, 451)
    inside = (sig >= band.bands[0]) & (sig <= band.bands[2])
    assert inside.mean() >= 0.8
    assert np.abs(band.bands[1] - sig).max() < 5.0
    jband = jm.posterior_predictive(res.flat, quantiles=(0.025, 0.5, 0.975))
    amp = np.abs(jband.mean).max()
    np.testing.assert_allclose(band.bands, jband.bands, rtol=0, atol=1e-5 * amp)
    np.testing.assert_allclose(band.std, jband.std, rtol=0, atol=1e-5 * amp)
