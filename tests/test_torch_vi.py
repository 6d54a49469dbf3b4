"""The port's ADVI (``tpu21cmvae_torch/vi.py``) against the JAX package's
(``tpu21cmvae/vi.py``).

Tolerances: a few steps of :func:`fit_advi` and :func:`fit_advi_batch` on
the normal draws JAX itself draws from its key (fed through the port's
draw seam, ``vi._normal``) give the same variational parameters and ELBO
to 1e-4 (float32 matmuls and reductions round differently in the two
libraries; Adam's first steps are close to ``lr·sign(g)``, so the targets
keep every gradient well away from 0); the JAX suite's analytic targets
(``tests/test_vi.py``) at its own assertions and sizes.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_pair import make_pair, one_torch_thread, train_box  # noqa: F401
from tpu21cmvae import vi as jvi
from tpu21cmvae_torch import vi as tvi
from tpu21cmvae_torch.vi import ADVIResult, fit_advi, fit_advi_batch

MU = np.array([0.5, -1.0, 2.0], np.float32)
SIG = np.array([0.4, 0.7, 0.2], np.float32)
BOUNDS = np.array([[-4.0, 4.0], [-5.0, 5.0], [0.0, 4.0]])


def _gauss_valgrad(mu, sig):
    mu_t, sig_t = torch.as_tensor(mu), torch.as_tensor(sig)

    def valgrad(params, x):
        z = (x - mu_t) / sig_t
        return -0.5 * torch.sum(z * z, dim=-1), -z / sig_t

    return valgrad


def _jax_gauss_valgrad(mu, sig):
    def valgrad(params, x):
        z = (x - mu) / sig
        return -0.5 * jnp.sum(z * z, axis=-1), -z / sig

    return valgrad


def feed(monkeypatch, draws):
    """Route the port's normal draws to ``draws`` (JAX arrays), in order."""
    queue = [np.array(d, np.float32) for d in draws]

    def fake(gen, shape):
        d = queue.pop(0)
        assert d.shape == tuple(shape), (d.shape, shape)
        return torch.as_tensor(d, device=gen.device)

    monkeypatch.setattr(tvi, "_normal", fake)
    return queue


def advi_draws(seed, n_steps, shape):
    """The normals JAX's ADVI draws: ``normal(k, shape)`` for each ``k`` of
    ``split(key(seed), n_steps)`` (``tpu21cmvae/vi.py:121,136,178``)."""
    return [jax.random.normal(k, shape, jnp.float32)
            for k in jax.random.split(jax.random.key(seed), n_steps)]


@pytest.mark.parametrize("x0", [None, [1.0, -2.0, 1.0]])
def test_fit_advi_matches_jax_on_its_draws(monkeypatch, x0):
    """Five steps from the box centre or a raw-space ``x0``: mean,
    Cholesky factor and every step's ELBO equal JAX's to 1e-4."""
    n_steps, n_mc, seed = 5, 64, 3
    mu, sig = np.array([1.5, -2.5, 3.1], np.float32), np.array([0.3, 0.5, 0.2], np.float32)
    theirs = jvi.fit_advi(_jax_gauss_valgrad(mu, sig), None, bounds=BOUNDS, n_steps=n_steps,
                          n_mc=n_mc, seed=seed, x0=x0)
    queue = feed(monkeypatch, advi_draws(seed, n_steps, (n_mc, 3)))
    mine = fit_advi(_gauss_valgrad(mu, sig), None, bounds=BOUNDS, n_steps=n_steps, n_mc=n_mc,
                    seed=seed, x0=x0, device="cpu")
    assert not queue
    assert isinstance(mine, ADVIResult)
    np.testing.assert_allclose(mine.mu, theirs.mu, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(mine.chol, theirs.chol, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(mine.elbo, theirs.elbo, rtol=1e-4, atol=1e-4)
    assert np.abs(mine.mu - np.zeros(3)).min() > 1e-3  # every coordinate moved
    np.testing.assert_array_equal(mine._lo, theirs._lo)
    np.testing.assert_allclose(mine.sample(64, seed=1), theirs.sample(64, seed=1), rtol=1e-4,
                               atol=1e-4)


def test_fit_advi_batch_matches_jax_on_its_draws(monkeypatch):
    """Five batched steps over two stacked observations with row centres:
    every row's mean, factor and ELBO trace equal JAX's to 1e-4."""
    n_steps, n_mc, seed = 5, 32, 1
    mus = np.array([[1.5, -2.5, 3.1], [-1.0, 2.0, 0.8]], np.float32)
    sig = np.array([0.3, 0.5, 0.2], np.float32)

    def jax_vg(params, x):
        xr = x.reshape(2, -1, 3)
        z = (xr - mus[:, None, :]) / sig
        return (-0.5 * jnp.sum(z * z, -1)).reshape(-1), (-z / sig).reshape(-1, 3)

    def torch_vg(params, x):
        xr = x.reshape(2, -1, 3)
        z = (xr - torch.as_tensor(mus)[:, None, :]) / torch.as_tensor(sig)
        return (-0.5 * torch.sum(z * z, -1)).reshape(-1), (-z / torch.as_tensor(sig)).reshape(-1, 3)

    x0 = np.array([[0.5, -1.0, 2.5], [0.0, 1.0, 1.0]])
    theirs = jvi.fit_advi_batch(jax_vg, None, 2, bounds=BOUNDS, n_steps=n_steps, n_mc=n_mc,
                                seed=seed, x0=x0)
    feed(monkeypatch, advi_draws(seed, n_steps, (2, n_mc, 3)))
    mine = fit_advi_batch(torch_vg, None, 2, bounds=BOUNDS, n_steps=n_steps, n_mc=n_mc,
                          seed=seed, x0=x0, device="cpu")
    for m, t in zip(mine, theirs):
        np.testing.assert_allclose(m.mu, t.mu, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(m.chol, t.chol, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(m.elbo, t.elbo, rtol=1e-4, atol=1e-4)


def test_whitened_helpers_match_jax():
    """``_whitened_center`` (the float64 host logit, clipped 1e-4 inside the
    box) and ``_whitened_vi_target`` under both log-Jacobian conventions,
    with the sigmoid clamp reached at |y| = 30, equal JAX's to 1e-6."""
    from tpu21cmvae.sampling import gradient as jgrad
    from tpu21cmvae_torch.sampling import gradient as tgrad

    lo, hi = BOUNDS[:, 0].astype(np.float32), BOUNDS[:, 1].astype(np.float32)
    for x0 in ([0.3, -4.9999, 3.2], [4.0, 0.0, 0.0]):
        np.testing.assert_allclose(tgrad._whitened_center(x0, lo, hi, "cpu").numpy(),
                                   np.asarray(jgrad._whitened_center(x0, lo, hi)), rtol=1e-6)
    with pytest.raises(ValueError, match="single"):
        tgrad._whitened_center(np.zeros((2, 3)), lo, hi, "cpu")
    y = np.random.default_rng(0).normal(0, 3, (16, 3)).astype(np.float32)
    y[0] = [30.0, -30.0, 0.5]
    for span_jac in (True, False):
        jf, jg = jgrad._whitened_vi_target(_jax_gauss_valgrad(MU, SIG), jnp.asarray(lo),
                                           jnp.asarray(hi - lo), None,
                                           span_jac=span_jac)(None, jnp.asarray(y))
        tf, tg = tgrad._whitened_vi_target(_gauss_valgrad(MU, SIG), torch.as_tensor(lo),
                                           torch.as_tensor(hi - lo), None,
                                           span_jac=span_jac)(None, torch.as_tensor(y))
        assert np.isfinite(tf.numpy()).all()
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-6)


# -- the JAX suite's targets (tests/test_vi.py) ---------------------------------------


def test_advi_recovers_diagonal_gaussian():
    """``tests/test_vi.py::test_advi_recovers_diagonal_gaussian``."""
    res = fit_advi(_gauss_valgrad(MU, SIG), None, bounds=BOUNDS, n_steps=600, n_mc=256, seed=0,
                   device="cpu")
    np.testing.assert_allclose(res.mean(), MU, atol=0.03)
    np.testing.assert_allclose(res.std(), SIG, rtol=0.08)
    assert res.elbo[-50:].std() < 0.1 * res.elbo[:50].std()
    draws = res.sample(10000, seed=1)
    assert (draws >= BOUNDS[:, 0]).all() and (draws <= BOUNDS[:, 1]).all()


def test_advi_full_rank_recovers_correlation():
    """``tests/test_vi.py::test_advi_full_rank_recovers_correlation``: a
    mean-field fit would report ~0 correlation."""
    rho = 0.8
    prec = torch.as_tensor(np.linalg.inv(np.array([[1.0, rho], [rho, 1.0]])).astype(np.float32))

    def valgrad(params, x):
        return -0.5 * torch.sum((x @ prec) * x, dim=-1), -(x @ prec)

    res = fit_advi(valgrad, None, bounds=np.array([[-6.0, 6.0]] * 2), n_steps=800, n_mc=512,
                   seed=0, device="cpu")
    draws = res.sample(40000, seed=2)
    assert abs(np.corrcoef(draws.T)[0, 1] - rho) < 0.05
    np.testing.assert_allclose(draws.std(0), 1.0, rtol=0.1)


def test_advi_with_prior_matches_conjugate():
    """``tests/test_vi.py::test_advi_with_prior_matches_conjugate``: a flat
    likelihood under a Gaussian prior fits the prior."""
    from tpu21cmvae_torch.priors import GaussianBoxPrior

    bounds = np.array([[-5.0, 5.0]] * 2)
    prior = GaussianBoxPrior.for_params({0: (1.0, 0.5), 1: (-0.5, 0.3)}, n_params=2,
                                        bounds=bounds)

    def valgrad(params, x):
        return torch.zeros(x.shape[:-1]), torch.zeros_like(x)

    res = fit_advi(valgrad, None, bounds=bounds, n_steps=600, n_mc=256, seed=0,
                   log_prior=prior.log_prior, device="cpu")
    np.testing.assert_allclose(res.mean(), [1.0, -0.5], atol=0.03)
    np.testing.assert_allclose(res.std(), [0.5, 0.3], rtol=0.1)


def test_advi_batch_recovers_independent_rows():
    """``tests/test_vi.py::test_advi_batch_recovers_independent_rows``:
    two stacked observations' Gaussians fitted together, each recovering
    its own, row 0 beside a sequential fit; a wrong ``x0`` refused."""
    mus = np.stack([[0.5, -1.0, 2.0], [-0.5, 0.3, 1.0]]).astype(np.float32)
    sig = np.array([0.3, 0.7, 0.2], np.float32)
    bounds = np.stack([mus.min(0) - 5 * sig, mus.max(0) + 5 * sig], 1)
    mus_t, sig_t = torch.as_tensor(mus), torch.as_tensor(sig)

    def vg_multi(params, x):
        xr = x.reshape(2, x.shape[0] // 2, 3)
        z = (xr - mus_t[:, None, :]) / sig_t
        return (-0.5 * torch.sum(z * z, -1)).reshape(-1), (-z / sig_t).reshape(-1, 3)

    res = fit_advi_batch(vg_multi, None, 2, bounds=bounds, n_steps=400, n_mc=256, seed=0,
                         x0=mus, device="cpu")
    assert len(res) == 2
    for o in range(2):
        assert np.allclose(res[o].mean(), mus[o], atol=0.1)
        assert np.allclose(res[o].std(), sig, atol=0.2)
    seq = fit_advi(_gauss_valgrad(mus[0], sig), None, bounds=bounds, n_steps=400, n_mc=256,
                   seed=0, device="cpu")
    assert np.allclose(res[0].mean(), seq.mean(), atol=0.1)
    with pytest.raises(ValueError, match="x0"):
        fit_advi_batch(vg_multi, None, 2, bounds=bounds, n_steps=10, n_mc=16, x0=mus[0],
                       device="cpu")


@pytest.fixture(scope="module")
def pair(splits):
    return make_pair(splits, (16,))


def test_model_level_advi_concentrates(pair, splits):
    """``tests/test_vi.py::test_model_level_advi_concentrates`` on the small
    model carried across: ``DirectEmulator.fit_advi`` concentrates at the
    observation's likelihood level inside the box; its mean lies within
    0.1 of the span of JAX's on the same model and observation; a
    multi-row ``x0`` is refused."""
    jm, tm = pair
    truth = np.asarray(splits.par_test[0], np.float32)
    obs = np.asarray(jm.predict(truth), np.float32)
    bounds = train_box(splits.par_train)
    kw = dict(bounds=bounds, n_steps=400, n_mc=256, seed=0, x0=truth)
    advi = tm.fit_advi(obs, 25.0, **kw)
    loglik = tm.loglik_fn(obs, 25.0)
    with torch.no_grad():
        lp_truth = float(loglik(tm.params, torch.as_tensor(truth[None]))[0])
        draws = advi.sample(256, seed=3)
        lp_draws = loglik(tm.params, torch.as_tensor(draws)).numpy()
    assert np.median(lp_draws) > lp_truth - 60.0
    assert (draws >= bounds[:, 0]).all() and (draws <= bounds[:, 1]).all()
    theirs = jm.fit_advi(obs, 25.0, **kw)
    span = bounds[:, 1] - bounds[:, 0]
    assert (np.abs(advi.mean() - theirs.mean()) < 0.1 * span).all(), (advi.mean(), theirs.mean())
    with pytest.raises(ValueError, match="x0"):
        tm.fit_advi(obs, 25.0, bounds=bounds, n_steps=4, x0=np.zeros((3, 7)))


def test_adam_matches_the_written_out_update():
    """The flat-moment :class:`~tpu21cmvae_torch.sampling.fit.Adam` equals
    the JAX package's per-tensor expression (``tpu21cmvae/vi.py:147-165``)
    over three steps, tensors of several shapes, in float32."""
    from tpu21cmvae_torch.sampling.fit import Adam, cosine_rate

    rng = np.random.default_rng(4)
    shapes = [(3,), (3, 3), (2, 5)]
    params = [torch.as_tensor(rng.normal(size=s).astype(np.float32)) for s in shapes]
    ref = [p.numpy().copy() for p in params]
    m_ref = [np.zeros(s, np.float32) for s in shapes]
    v_ref = [np.zeros(s, np.float32) for s in shapes]
    adam = Adam(params)
    b1, b2 = np.float32(0.9), np.float32(0.999)
    for t in range(1, 4):
        grads = [rng.normal(size=s).astype(np.float32) for s in shapes]
        lr = cosine_rate(0.05, t, 3)
        adam.step([torch.as_tensor(g) for g in grads], t, lr)
        for i, g in enumerate(grads):
            m_ref[i] = b1 * m_ref[i] + (1 - b1) * g
            v_ref[i] = b2 * v_ref[i] + (1 - b2) * g * g
            ref[i] = ref[i] + np.float32(lr) * (m_ref[i] / (1 - b1**t)) / (
                np.sqrt(v_ref[i] / (1 - b2**t)) + np.float32(1e-8))
    for p, r in zip(params, ref):
        np.testing.assert_allclose(p.numpy(), r, rtol=1e-6, atol=1e-7)
    assert cosine_rate(0.05, 1, 3) == pytest.approx(0.05)
    assert cosine_rate(0.05, 601, 600) == pytest.approx(0.05 * 0.05)
    assert math.isclose(cosine_rate(1.0, 301, 600), 0.05 + 0.95 * 0.5)
