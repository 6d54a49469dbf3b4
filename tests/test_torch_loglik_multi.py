"""The stacked-observation likelihoods and the generic ``*_from_predict``
factories of the PyTorch port (``tpu21cmvae_torch/ops/loglik.py``), held
to the JAX package on the same weights and inputs and to the port's own
single-observation likelihoods: rows of ``make_loglik_multi`` against
``loglik_fn`` at ``rtol=1e-4, atol=2e-2``
(``tests/test_foregrounds.py:166``), values against JAX within
``2e-3·max|logL|`` (1e-5 of it at the exact tier without a foreground in
the observations), gradients within ``2e-3·max|g|``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_pair import make_pair, one_torch_thread  # noqa: F401

from tpu21cmvae import noisescale as jns
from tpu21cmvae.ops.loglik import make_loglik_and_grad_multi as jax_grad_multi
from tpu21cmvae.ops.loglik import make_loglik_multi as jax_multi
from tpu21cmvae_torch.foregrounds import linlog_basis
from tpu21cmvae_torch.noisescale import marginalize_noise_scale
from tpu21cmvae_torch.ops.loglik import (
    _check_multi_noise,
    _resid_quad,
    make_loglik_and_grad_multi,
    make_loglik_from_predict,
    make_loglik_multi,
    per_row_grad,
)

HIDDEN = (32, 24)


@pytest.fixture(scope="module")
def pair(splits):
    return make_pair(splits, HIDDEN)


@pytest.fixture(scope="module")
def survey(pair, splits):
    """Three observations (signal + noise) and 12 observation-major rows,
    one with fx == 0."""
    _, tm = pair
    obs = tm.predict(splits.par_test[:3]) + np.random.default_rng(0).normal(0, 3.0, (3, 451))
    raw = np.asarray(splits.par_test[:12], np.float32).copy()
    raw[5, 2] = 0.0
    return obs.astype(np.float32), raw


def _specs(m, scale_fn, which):
    nv = np.linspace(4.0, 60.0, 451)
    return {
        "scalar": lambda: 25.0,
        "perbin": lambda: nv,
        "fg": lambda: m.marginalize_foreground(25.0, n_terms=5),
        "scale": lambda: scale_fn(nv),
        "scale_fg": lambda: scale_fn(m.marginalize_foreground(25.0, n_terms=5), alpha=3.0,
                                     beta=2.0),
    }[which]()


def _values(fn, params, raw):
    with torch.no_grad():
        return fn(params, torch.as_tensor(raw)).numpy()


@pytest.mark.parametrize("method", ["direct", "gram"])
@pytest.mark.parametrize("spec", ["scalar", "perbin", "fg", "scale", "scale_fg"])
def test_loglik_multi_matches_single_and_jax(pair, survey, spec, method):
    """Row o·W + w of the stacked likelihood == observation o's
    single-observation likelihood on row w, and the whole batch == the JAX
    stacked likelihood, under every noise spec and both methods."""
    jm, tm = pair
    obs, raw = survey
    nv_t = _specs(tm, marginalize_noise_scale, spec)
    nv_j = _specs(jm, jns.marginalize_noise_scale, spec)
    got = _values(tm.loglik_multi_fn(obs, nv_t, method=method, precision="highest"),
                  tm.params, raw)
    assert got.shape == (12,)
    for o in range(3):
        single = _values(tm.loglik_fn(obs[o], nv_t, method=method, precision="highest"),
                         tm.params, raw[o * 4:(o + 1) * 4])
        np.testing.assert_allclose(got[o * 4:(o + 1) * 4], single, rtol=1e-4, atol=2e-2)
    want = np.asarray(jax_multi(jm.config, jm.normalizer, obs, nv_j, method=method,
                                precision="highest")(jm.params, jnp.asarray(raw)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    high = _values(make_loglik_multi(tm.config, tm.normalizer, obs, nv_t, method=method),
                   tm.params, raw)
    np.testing.assert_allclose(high, want, rtol=0, atol=2e-3 * np.abs(want).max())


def test_multi_observation_marginalized(pair, splits):
    """``tests/test_foregrounds.py::test_multi_observation_marginalized``:
    two observations carrying different foregrounds under one shared
    MarginalizedNoise; each row matches its single-observation likelihood
    and the JAX stacked value. Both at the JAX suite's bound for values,
    2e-3·max|logL|, not at the ``rtol=1e-4, atol=2e-2`` that
    ``test_loglik_multi_matches_single_and_jax`` holds without a
    foreground in the observations: the stacked form whitens ``b₀`` and
    each 10³ mK observation apart (``b₀@R − obs@R``) where the single form
    whitens their difference, and the two float32 cancellations differ by
    up to 0.05 nats here (2.3e-4 of |logL|), depending on the matmul's
    summation order (one thread or several)."""
    jm, tm = pair
    F = linlog_basis(tm.frequencies, 5)
    sig = tm.predict(splits.par_test[0])
    obs = (sig + F @ np.array([1500.0, -120.0, 40.0, -8.0, 2.0])
           + np.random.default_rng(1).normal(0, 5, sig.shape)).astype(np.float32)
    obs_b = np.stack([obs, (sig + F @ np.random.default_rng(3).normal(0, 50, 5) + 3.0).astype(
        np.float32)])
    mn = tm.marginalize_foreground(25.0, basis=F)
    theta = np.asarray(splits.par_test[:4], np.float32)
    raw = np.concatenate([theta, theta])  # obs-major, W=4 each
    for method in ("direct", "gram"):
        ll = _values(tm.loglik_multi_fn(obs_b, mn, method=method, precision="highest"),
                     tm.params, raw).reshape(2, 4)
        for o in range(2):
            single = _values(tm.loglik_fn(obs_b[o], mn, method=method, precision="highest"),
                             tm.params, theta)
            np.testing.assert_allclose(ll[o], single, rtol=0, atol=2e-3 * np.abs(single).max())
        want = np.asarray(jm.loglik_multi_fn(obs_b, jm.marginalize_foreground(25.0, basis=F),
                                             method=method, precision="highest")(
            jm.params, raw)).reshape(2, 4)
        np.testing.assert_allclose(ll, want, rtol=0, atol=2e-3 * np.abs(want).max())


def test_multi_observation_scale_marginal(pair, splits):
    """``tests/test_noisescale.py::test_multi_observation``: the stacked
    path marginalizes the level PER observation."""
    _, tm = pair
    rows = np.asarray(splits.par_test[:6], np.float32)
    noise_shape = np.random.default_rng(3).uniform(5.0, 50.0, 451)
    sigs = tm.predict(splits.par_test[:2])
    obs2 = (sigs + np.random.default_rng(7).normal(0, 4.0, sigs.shape)).astype(np.float32)
    sm = marginalize_noise_scale(noise_shape)
    got = _values(tm.loglik_multi_fn(obs2, sm, precision="highest", memo=False), tm.params,
                  np.tile(rows, (2, 1)))
    for o in range(2):
        want = _values(tm.loglik_fn(obs2[o], sm, precision="highest", memo=False), tm.params,
                       rows)
        np.testing.assert_allclose(got[o * 6:(o + 1) * 6], want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("spec", ["scalar", "scale_fg"])
def test_loglik_and_grad_multi(pair, survey, spec):
    """Value and per-row gradient of the stacked likelihood: equal to the
    JAX factory's, and each observation's block equal to the analytic
    single-observation gradient."""
    jm, tm = pair
    obs, raw = survey
    nv_t = _specs(tm, marginalize_noise_scale, spec)
    nv_j = _specs(jm, jns.marginalize_noise_scale, spec)
    val, grad = make_loglik_and_grad_multi(tm.config, tm.normalizer, obs, nv_t,
                                           precision="highest")(tm.params, raw)
    assert val.shape == (12,) and grad.shape == (12, 7)
    assert not val.requires_grad and not grad.requires_grad
    assert grad[5, 2] == 0.0  # the fx == 0 clamp
    jv, jg = jax_grad_multi(jm.config, jm.normalizer, obs, nv_j, precision="highest")(
        jm.params, jnp.asarray(raw))
    np.testing.assert_allclose(val.numpy(), np.asarray(jv), rtol=0,
                               atol=2e-3 * np.abs(np.asarray(jv)).max())
    np.testing.assert_allclose(grad.numpy(), np.asarray(jg), rtol=0,
                               atol=2e-3 * np.abs(np.asarray(jg)).max())
    for o in range(3):
        _, g1 = tm.loglik_and_grad_fn(obs[o], nv_t, precision="highest")(
            tm.params, torch.as_tensor(raw[o * 4:(o + 1) * 4]))
        np.testing.assert_allclose(grad[o * 4:(o + 1) * 4].numpy(), g1.numpy(), rtol=0,
                                   atol=2e-3 * float(g1.abs().max()))


def test_multi_validation_and_memo(pair, survey):
    _, tm = pair
    obs, raw = survey
    tm.loglik_multi_fn(obs, np.full(451, 25.0))  # per-bin shared noise accepted
    with pytest.raises(ValueError, match="shared"):
        tm.loglik_multi_fn(obs, np.full((3, 451), 25.0))
    with pytest.raises(ValueError, match="divide"):
        tm.loglik_multi_fn(obs, 25.0)(tm.params, torch.as_tensor(raw[:10]))
    with pytest.raises(ValueError, match="obs_batch"):
        make_loglik_multi(tm.config, tm.normalizer, obs[:, :100], 25.0)
    with pytest.raises(ValueError, match="method"):
        make_loglik_multi(tm.config, tm.normalizer, obs, 25.0, method="cholesky")
    bad = tm.marginalize_foreground(25.0)
    bad = type(bad)(whiten=np.eye(100, dtype=np.float32), log_norm=0.0, basis=np.ones((100, 1)),
                    noise_var=np.ones(100), prior_var=None)
    with pytest.raises(ValueError, match="bins"):
        _check_multi_noise(bad, 451)
    f1 = tm.loglik_multi_fn(obs, 25.0)
    assert f1 is tm.loglik_multi_fn(obs.copy(), 25.0)
    assert f1 is not tm.loglik_multi_fn(obs, 16.0)
    assert f1 is not tm.loglik_multi_fn(obs, 25.0, method="direct")
    assert f1 is not tm.loglik_multi_fn(obs, 25.0, memo=False)
    one = _values(tm.loglik_multi_fn(obs[0], 25.0, precision="highest"), tm.params, raw[:4])
    np.testing.assert_allclose(
        one, _values(tm.loglik_fn(obs[0], 25.0, precision="highest"), tm.params, raw[:4]),
        rtol=1e-5, atol=1e-3)


def test_resid_quad_and_per_row_grad(pair, survey):
    """``_resid_quad`` reduces a residual under a diagonal and a dense
    whitening (against float64 NumPy); ``per_row_grad`` gives each row's
    own gradient of a generic batched likelihood."""
    _, tm = pair
    obs, raw = survey
    r = np.random.default_rng(4).normal(0, 5, (6, 451)).astype(np.float32)
    nv = np.linspace(4.0, 60.0, 451)
    quad, log_norm = _resid_quad(nv, 451, device="cpu")
    assert log_norm == 0.0
    np.testing.assert_allclose(quad(torch.as_tensor(r)).numpy(),
                               np.sum(r.astype(np.float64) ** 2 / nv, -1), rtol=1e-5)
    mn = tm.marginalize_foreground(nv, n_terms=5)
    quad, log_norm = _resid_quad(mn, 451, device="cpu")
    z = r.astype(np.float64) @ mn.whiten.astype(np.float64)
    assert log_norm == mn.log_norm
    np.testing.assert_allclose(quad(torch.as_tensor(r)).numpy(), np.sum(z * z, -1), rtol=1e-5)
    with pytest.raises(ValueError, match="bins"):
        _resid_quad(mn, 450, device="cpu")

    def predict(weights, x):  # a non-MLP "emulator": rows independent
        return torch.sin(x @ weights) * 20.0

    w = torch.tensor(np.random.default_rng(5).normal(size=(7, 451)) * 0.01, dtype=torch.float32)
    fn = make_loglik_from_predict(predict, obs[0], mn, device="cpu")
    val, grad = per_row_grad(fn)(w, raw)
    assert val.shape == (12,) and grad.shape == (12, 7) and not grad.requires_grad
    for i in (0, 7):
        x = torch.tensor(raw[i], requires_grad=True)
        (g,) = torch.autograd.grad(fn(w, x)[0], x)
        np.testing.assert_allclose(grad[i].numpy(), g.numpy(), rtol=1e-4,
                                   atol=1e-6 * float(g.abs().max()))
