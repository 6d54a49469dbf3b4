"""The port's point estimates, ``fit_map`` and ``profile_likelihood``, and
the shared whitened Adam ascent, against the JAX package
(``tpu21cmvae/sampling/fit.py``); and the mesh refusal that every
gradient sampler and fit shares.

Tolerances: the ascent from identical starts after 300 steps, x to
1e-4 of the box span and logL to 1e-4 of max(1, max|logL|) (the two
packages round float32 sigmoids differently, and nothing else differs);
``ProfileResult.interval`` bit for bit on the same arrays (NumPy and
SciPy on both sides); the small model's best fit from the same starts to
1e-3 of the span (its backward runs at single-pass bf16 in both, so one
rounding can move a late Adam step); the JAX suite's own assertions on
the analytic targets.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_pair import make_pair, one_torch_thread, train_box  # noqa: F401

from tpu21cmvae.sampling import fit as jfit
from tpu21cmvae_torch.sampling import fit as tfit
from tpu21cmvae_torch.sampling.fit import ProfileResult, fit_map, profile_likelihood
from tpu21cmvae_torch.sampling.gradient import sample_chees, sample_hmc, sample_nuts

MU = np.array([0.5, -1.0, 2.0, 0.1], np.float32)
SIG = np.array([0.3, 0.7, 0.05, 2.0], np.float32)


def _jax_valgrad(params, x):
    z = (x - MU) / SIG
    return -0.5 * jnp.sum(z * z, axis=-1), -z / SIG


def _torch_valgrad(params, x):
    mu, sig = torch.as_tensor(MU), torch.as_tensor(SIG)
    z = (x - mu) / sig
    return -0.5 * torch.sum(z * z, dim=-1), -z / sig


@pytest.mark.parametrize("jacobian", [False, True])
@pytest.mark.parametrize("pinned", [False, True])
def test_whitened_adam_ascent_matches_jax(pinned, jacobian):
    """300 cosine-decayed Adam steps from the same 64 starts on an
    anisotropic Gaussian (a 40× width split), with and without a pinned
    coordinate and the sigmoid Jacobian: x to 1e-4·span, logL to
    1e-4·max(1, max|logL|); the pinned coordinate stays within 1e-6 of
    the span of its start."""
    lo, hi = MU - 5 * SIG, MU + 5 * SIG
    x = (lo + (hi - lo) * np.random.default_rng(0).uniform(size=(64, 4))).astype(np.float32)
    free = np.array([1, 0, 1, 1], np.float32) if pinned else None
    kw = dict(n_steps=300, learning_rate=0.05, log_prior=None, jacobian=jacobian)
    jx, jl = jfit._whitened_adam_ascent(
        _jax_valgrad, None, jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(x),
        free=None if free is None else jnp.asarray(free), **kw)
    tx, tl = tfit._whitened_adam_ascent(
        _torch_valgrad, None, torch.as_tensor(lo), torch.as_tensor(hi), torch.as_tensor(x),
        free=None if free is None else torch.as_tensor(free), **kw)
    jx, jl, tx, tl = np.asarray(jx), np.asarray(jl), tx.numpy(), tl.numpy()
    span = hi - lo
    assert (np.abs(tx - jx) / span).max() < 1e-4
    assert np.abs(tl - jl).max() < 1e-4 * max(1.0, np.abs(jl).max())
    if pinned:
        assert (np.abs(tx[:, 1] - x[:, 1]) / span[1]).max() < 1e-6
    elif not jacobian:  # the raw-space optimum
        assert np.allclose(tx, MU, atol=0.02 * SIG)


def test_profile_interval_matches_jax():
    """``interval`` equals JAX's on the same curves: interior crossings,
    a curve censored on both sides, an asymmetric one, two levels."""
    grid = np.linspace(-1.0, 2.0, 31).astype(np.float32)
    rng = np.random.default_rng(4)
    curves = [-0.5 * ((grid - 0.5) / 0.4) ** 2,
              -0.5 * ((grid - 0.5) / 40.0) ** 2,
              np.where(grid < 0.2, -3.0 * (grid - 0.2) ** 2, -0.2 * (grid - 0.2) ** 2),
              -0.5 * ((grid - 0.5) / 0.4) ** 2 + 0.01 * rng.normal(size=31)]
    for logl in curves:
        logl = logl.astype(np.float32)
        params = np.zeros((31, 2), np.float32)
        mine = ProfileResult(index=0, grid=grid, logl=logl, params=params)
        theirs = jfit.ProfileResult(index=0, grid=grid, logl=logl, params=params)
        for level in (0.68, 0.95):
            assert mine.interval(level) == theirs.interval(level)
    with pytest.raises(ValueError, match="level"):
        mine.interval(1.0)


def test_fit_map_analytic_gaussian():
    """``tests/test_sampling.py::test_fit_map_analytic_gaussian``: every
    start lands on the analytic optimum, and ``top`` sorts best first."""
    mu = np.array([0.5, -1.0, 2.0], np.float32)
    sig = np.array([0.3, 0.7, 0.2], np.float32)

    def valgrad(params, x):
        z = (x - torch.as_tensor(mu)) / torch.as_tensor(sig)
        return -0.5 * torch.sum(z**2, dim=-1), -z / torch.as_tensor(sig)

    bounds = np.stack([mu - 5 * sig, mu + 5 * sig], axis=1)
    res = fit_map(valgrad, None, n_starts=64, n_steps=400, bounds=bounds, seed=0, device="cpu")
    assert res.params.shape == (64, 3)
    assert np.allclose(res.best, mu, atol=0.02 * sig)
    assert res.best_logp > -1e-3
    top_p, top_l = res.top(5)
    assert top_p.shape == (5, 3)
    assert (np.diff(top_l) <= 1e-6).all()
    assert (top_l > -0.01).all()
    assert "best logL" in res.summary()
    # x0 rows replace the uniform starts
    x0 = np.tile(mu + sig, (3, 1))
    again = fit_map(valgrad, None, n_steps=50, bounds=bounds, x0=x0, device="cpu")
    assert again.params.shape == (3, 3) and np.allclose(again.params, again.params[0])


def test_profile_likelihood_analytic_gaussian():
    """``tests/test_sampling.py::test_profile_likelihood_analytic_gaussian``:
    the profile is the marginal quadratic, the free coordinate sits at its
    conditional optimum, the pinned one is restored exactly, the Wilks
    intervals are μ ± 0.994σ and μ ± 1.96σ, and a short grid is
    censored at its ends."""
    mu = np.array([0.5, -1.0], np.float32)
    sig = np.array([0.4, 0.7], np.float32)
    bounds = np.array([[-3.0, 3.0], [-4.0, 4.0]])

    def valgrad(params, x):
        z = (x - torch.as_tensor(mu)) / torch.as_tensor(sig)
        return -0.5 * torch.sum(z * z, dim=-1), -z / torch.as_tensor(sig)

    grid = np.linspace(-1.0, 2.0, 61)
    res = profile_likelihood(valgrad, None, 0, grid, n_starts=32, n_steps=200, bounds=bounds,
                             seed=0, device="cpu")
    assert res.logl.shape == (61,) and res.params.shape == (61, 2)
    np.testing.assert_allclose(res.logl, -0.5 * ((grid - mu[0]) / sig[0]) ** 2, atol=5e-3)
    np.testing.assert_allclose(res.params[:, 1], mu[1], atol=0.01)
    np.testing.assert_array_equal(res.params[:, 0], grid.astype(np.float32))
    lo68, hi68 = res.interval(0.68)
    assert abs(lo68 - (mu[0] - 0.994 * sig[0])) < 0.03
    assert abs(hi68 - (mu[0] + 0.994 * sig[0])) < 0.03
    lo95, hi95 = res.interval(0.95)
    assert abs(lo95 - (mu[0] - 1.96 * sig[0])) < 0.04
    assert abs(hi95 - (mu[0] + 1.96 * sig[0])) < 0.04
    short = profile_likelihood(valgrad, None, 0, np.linspace(0.3, 0.7, 11), n_starts=16,
                               n_steps=150, bounds=bounds, seed=0, device="cpu")
    i95 = short.interval(0.95)
    assert i95[0] == pytest.approx(0.3) and i95[1] == pytest.approx(0.7)
    with pytest.raises(ValueError, match="grid"):
        profile_likelihood(valgrad, None, 0, [5.0, 6.0], bounds=bounds, device="cpu")
    with pytest.raises(ValueError, match="grid"):
        profile_likelihood(valgrad, None, 0, [0.5], bounds=bounds, device="cpu")
    with pytest.raises(ValueError, match="index"):
        profile_likelihood(valgrad, None, 9, grid, bounds=bounds, device="cpu")


def test_profile_dead_start_counts_as_minus_inf():
    """A start whose final value is not finite never wins its grid point:
    the profile keeps the best finite start, as the JAX package does."""
    def valgrad(params, x):
        ll = -0.5 * torch.sum(x**2, dim=-1)
        dead = x[:, 1] > 0.5  # a region whose value is NaN
        return torch.where(dead, torch.nan, ll), torch.where(dead[:, None], torch.nan, -x)

    bounds = np.array([[-1.0, 1.0], [-1.0, 1.0]])
    res = profile_likelihood(valgrad, None, 0, [-0.5, 0.0, 0.5], n_starts=16, n_steps=60,
                             bounds=bounds, seed=1, device="cpu")
    assert np.isfinite(res.logl).all()
    np.testing.assert_allclose(res.logl, -0.5 * np.array([0.25, 0.0, 0.25]), atol=1e-3)


@pytest.fixture(scope="module")
def pair(splits):
    return make_pair(splits, (32, 24))


def test_fit_params_matches_jax_on_the_small_model(pair, splits):
    """``DirectEmulator.fit_params`` from the same 32 starts in both
    packages: the best start agrees to 1e-3·span and its logL to 1e-3
    nats, both through each package's value+gradient function at
    ``grad_precision="default"``; the port's fit goes through the
    memoized function HMC uses."""
    jm, tm = pair
    bounds = train_box(splits.par_train)
    truth = np.asarray(splits.par_test[0], np.float32)
    obs = (tm.predict(truth) + np.random.default_rng(0).normal(0, 3.0, 451)).astype(np.float32)
    x0 = (bounds[:, 0] + (bounds[:, 1] - bounds[:, 0])
          * np.random.default_rng(1).uniform(size=(32, 7))).astype(np.float32)
    want = jm.fit_params(obs, 9.0, bounds=bounds, x0=x0, n_steps=300)
    got = tm.fit_params(obs, 9.0, bounds=bounds, x0=x0, n_steps=300)
    span = bounds[:, 1] - bounds[:, 0]
    assert got.params.shape == (32, 7)
    assert (np.abs(got.best - want.best) / span).max() < 1e-3
    assert abs(got.best_logp - want.best_logp) < 1e-3 * max(1.0, abs(want.best_logp))
    assert tm._hmc_valgrad(obs, 9.0) is tm.loglik_and_grad_fn(
        obs, 9.0, backend="torch", grad_precision="default")


def test_model_level_profile_likelihood(pair, splits):
    """``DirectEmulator.profile_likelihood`` over a noise-free observation
    in both packages (64 starts × 200 steps per grid point; the starts
    differ, their generators do): a finite profile that never beats the
    truth's logL (the residual there is zero) by more than 1e-2 and comes
    within 1 nat of it, its pinned values exactly the grid, and the two
    packages' profile maxima within 0.5 nats. The small model is
    untrained, so τ barely moves the signal and the curve is nearly flat:
    the JAX suite's peak-location check does not apply to it."""
    jm, tm = pair
    truth = np.asarray(splits.par_test[0], np.float32)
    obs = tm.predict(truth)
    bounds = train_box(splits.par_train)
    lo, hi = bounds[:, 0], bounds[:, 1]
    grid = np.linspace(lo[3] + 0.1 * (hi[3] - lo[3]), hi[3] - 0.1 * (hi[3] - lo[3]), 9)
    kw = dict(bounds=bounds, n_starts=64, n_steps=200, seed=0)
    res = tm.profile_likelihood(obs, 25.0, 3, grid, **kw)
    want = jm.profile_likelihood(obs, 25.0, 3, grid, **kw)
    with torch.no_grad():
        ll_truth = float(tm.loglik_fn(obs, 25.0)(tm.params, torch.as_tensor(truth[None]))[0])
    assert res.logl.shape == (9,) and np.isfinite(res.logl).all()
    np.testing.assert_array_equal(res.params[:, 3], grid.astype(np.float32))
    assert res.logl.max() <= ll_truth + 1e-2
    assert res.logl.max() > ll_truth - 1.0
    assert abs(res.logl.max() - want.logl.max()) < 0.5


_MESH_REFUSERS = {
    "sample_hmc": lambda vg, b: sample_hmc(vg, None, bounds=b, mesh=object(), device="cpu"),
    "sample_chees": lambda vg, b: sample_chees(vg, None, bounds=b, mesh=object(), device="cpu"),
    "sample_nuts": lambda vg, b: sample_nuts(vg, None, bounds=b, mesh=object(), device="cpu"),
    "fit_map": lambda vg, b: fit_map(vg, None, bounds=b, mesh=object(), device="cpu"),
    "profile_likelihood": lambda vg, b: profile_likelihood(
        vg, None, 0, [0.0, 0.5], bounds=b, mesh=object(), device="cpu"),
}


@pytest.mark.parametrize("name", sorted(_MESH_REFUSERS))
def test_mesh_is_refused(name):
    """Every gradient sampler and fit takes ``mesh=`` and refuses an
    object that is not a ``Mesh`` before it calls the likelihood (a Mesh
    of several devices runs: ``test_torch_parallel_sampling.py``)."""
    calls = []

    def valgrad(params, x):
        calls.append(1)
        return _torch_valgrad(params, x)

    with pytest.raises(TypeError, match="Mesh"):
        _MESH_REFUSERS[name](valgrad, np.stack([MU - 1, MU + 1], axis=1))
    assert not calls
