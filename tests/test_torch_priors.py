"""Informative priors in the PyTorch port (``tpu21cmvae_torch/priors.py``
and ``log_prior=`` in HMC, MH and the ensemble), case for case with the
sampler half of ``tests/test_priors.py``: every check is against an
analytic conjugate-Gaussian result, the JAX function on the same inputs
(``log_prior`` 1e-6, ``prior_transform`` 1e-5, HMC's whitened value and
gradient 1e-5), or a NumPy transcription of the same step on injected
randoms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_pair import make_pair, one_torch_thread  # noqa: F401

from tpu21cmvae.priors import GaussianBoxPrior as JaxPrior
from tpu21cmvae.sampling import gradient as jgrad
from tpu21cmvae_torch.priors import GaussianBoxPrior, ndtri
from tpu21cmvae_torch.sampling import gradient as tgrad
from tpu21cmvae_torch.sampling import mh
from tpu21cmvae_torch.sampling._common import _log_prior_val_grad, _resolve_log_prior
from tpu21cmvae_torch.sampling.gradient import sample_hmc
from tpu21cmvae_torch.sampling.mh import sample_ensemble, sample_mh
from tpu21cmvae_torch.sampling.reweight import reweight

# a 3-parameter box wide enough that truncation is negligible
MU_L = np.array([0.5, -1.0, 2.0])
SIG_L = np.array([0.4, 0.3, 0.5])
MU_P = np.array([0.0, -0.5, 2.5])
SIG_P = np.array([0.5, 0.4, 0.3])
BOUNDS = np.stack([MU_P - 12 * SIG_P, MU_P + 12 * SIG_P], axis=1)

# conjugate product: N(x|mu_l,s_l^2)·N(x|mu_p,s_p^2) ∝ N(x|mu_c,s_c^2)
VAR_C = 1.0 / (1.0 / SIG_L**2 + 1.0 / SIG_P**2)
MU_C = VAR_C * (MU_L / SIG_L**2 + MU_P / SIG_P**2)
SIG_C = np.sqrt(VAR_C)

_MU_L32, _SIG_L32 = MU_L.astype(np.float32), SIG_L.astype(np.float32)


def normalized_loglik(params, x):
    """A NORMALIZED Gaussian 'likelihood' density in the parameters."""
    z = (x - torch.as_tensor(_MU_L32)) / torch.as_tensor(_SIG_L32)
    return -0.5 * torch.sum(z**2, dim=-1) - float(0.5 * np.log(2 * np.pi * SIG_L**2).sum())


def valgrad(params, x):
    mu, sig = torch.as_tensor(_MU_L32), torch.as_tensor(_SIG_L32)
    z = (x - mu) / sig
    return -0.5 * torch.sum(z**2, dim=-1), -(z / sig)


def jax_valgrad(params, x):
    z = (x - _MU_L32) / _SIG_L32
    return -0.5 * jnp.sum(z**2, axis=-1), -(z / _SIG_L32)


@pytest.fixture(scope="module")
def prior():
    return GaussianBoxPrior.build(MU_P, SIG_P, bounds=BOUNDS)


@pytest.fixture(scope="module")
def jax_prior():
    return JaxPrior.build(MU_P, SIG_P, bounds=BOUNDS)


def test_log_prior_density_and_flat_dims(prior, jax_prior):
    x = np.random.default_rng(0).normal(0.0, 1.0, (16, 3)).astype(np.float32)
    got = prior.log_prior(torch.as_tensor(x))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    want = (-0.5 * ((x - MU_P) / SIG_P) ** 2).sum(-1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_prior.log_prior(x)), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(prior.log_prior(x).numpy(), got.numpy())  # arrays too
    # sigma=None dims contribute nothing
    mixed = GaussianBoxPrior.build([MU_P[0], None, None], [SIG_P[0], None, None], bounds=BOUNDS)
    want = -0.5 * ((x[:, 0] - MU_P[0]) / SIG_P[0]) ** 2
    np.testing.assert_allclose(mixed.log_prior(x).numpy(), want, rtol=1e-5, atol=1e-5)
    # all-flat prior is exactly zero
    flat = GaussianBoxPrior.build([None] * 3, [None] * 3, bounds=BOUNDS)
    assert np.all(flat.log_prior(x).numpy() == 0.0)
    assert prior.log_box_mean() == jax_prior.log_box_mean()
    assert prior.log_box_mean(BOUNDS[:, 0] / 2, BOUNDS[:, 1]) == jax_prior.log_box_mean(
        BOUNDS[:, 0] / 2, BOUNDS[:, 1])


def test_for_params_and_validation():
    p = GaussianBoxPrior.for_params({1: (0.054, 0.006)}, n_params=7)
    j = JaxPrior.for_params({1: (0.054, 0.006)}, n_params=7)
    assert np.isfinite(p.sigma[1]) and not np.isfinite(p.sigma[0])
    for name in ("mean", "sigma", "lo", "hi"):  # the default box is the JAX package's
        np.testing.assert_array_equal(getattr(p, name), getattr(j, name))
    with pytest.raises(ValueError, match="length"):
        GaussianBoxPrior.build([0.0], [1.0], bounds=BOUNDS)
    with pytest.raises(ValueError, match="positive"):
        GaussianBoxPrior.build(MU_P, [-1.0, 1.0, 1.0], bounds=BOUNDS)
    with pytest.raises(ValueError, match="finite mean"):
        GaussianBoxPrior.build([None, -0.5, 2.5], SIG_P, bounds=BOUNDS)


def test_prior_transform_gives_prior_samples(prior, jax_prior):
    """Uniform u through the transform reproduces the (truncated)
    Gaussian prior's moments; flat dims map affinely to the box; equal to
    the JAX transform on the same u (1e-5 of each parameter's sigma away
    from the clamped tails)."""
    u = np.random.default_rng(1).uniform(size=(200_000, 3)).astype(np.float32)
    x = prior.prior_transform(torch.as_tensor(u)).numpy()
    np.testing.assert_allclose((x.mean(0) - MU_P) / SIG_P, np.zeros(3), atol=4 / np.sqrt(200_000))
    np.testing.assert_allclose(x.std(0), SIG_P, rtol=0.02)
    assert (x >= BOUNDS[:, 0]).all() and (x <= BOUNDS[:, 1]).all()
    head = u[:4096]
    body = ((head > 1e-3) & (head < 1 - 1e-3)).all(axis=1)
    np.testing.assert_allclose(prior.prior_transform(head).numpy()[body],
                               np.asarray(jax_prior.prior_transform(head))[body],
                               rtol=0, atol=1e-5 * 10 * SIG_P.max())
    mixed = GaussianBoxPrior.build([None, -0.5, None], [None, 0.4, None], bounds=BOUNDS)
    xm = mixed.prior_transform(u).numpy()
    lo, hi = BOUNDS[0, 0], BOUNDS[0, 1]
    np.testing.assert_allclose(xm[:, 0], lo + (hi - lo) * u[:, 0], rtol=1e-5, atol=1e-4)
    q = torch.tensor([0.025, 0.5, 0.975])
    np.testing.assert_allclose(ndtri(q).numpy(), [-1.959964, 0.0, 1.959964], atol=1e-5)


def test_log_prior_val_grad(prior):
    """Value and per-row gradient of a prior, detached; a flat prior and a
    prior that ignores its input give a zero gradient."""
    x = torch.tensor(np.random.default_rng(2).normal(size=(9, 3)), dtype=torch.float32)
    v, g = _log_prior_val_grad(prior.log_prior, x)
    assert not v.requires_grad and not g.requires_grad and not x.requires_grad
    np.testing.assert_allclose(v.numpy(), prior.log_prior(x).numpy())
    want = -(x.numpy() - MU_P) / SIG_P**2
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-5, atol=1e-5)
    for flat in (_resolve_log_prior(None), lambda q: torch.zeros(q.shape[0])):
        v, g = _log_prior_val_grad(flat, x)
        assert v.shape == (9,) and (g == 0).all() and g.shape == x.shape
    with torch.no_grad():  # HMC may run under no_grad: the gradient is still taken
        _, g = _log_prior_val_grad(prior.log_prior, x)
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-5, atol=1e-5)


def test_whitened_target_includes_the_priors_gradient(prior, jax_prior):
    """HMC's target over the whitened y: with a ``log_prior`` both the
    value and the GRADIENT carry the prior (the port once added the value
    alone), equal to the JAX package's ``_whitened_target`` on the same y
    at 1e-5, and the gradient equals autograd through the value."""
    y = np.random.default_rng(3).normal(0.0, 1.5, (33, 3)).astype(np.float32)
    lo, span = BOUNDS[:, 0].astype(np.float32), (BOUNDS[:, 1] - BOUNDS[:, 0]).astype(np.float32)
    _, jtarget = jgrad._whitened_target(jax_valgrad, jax_prior.log_prior, jnp.asarray(lo),
                                        jnp.asarray(span))
    jlp, jglp = jtarget(None, jnp.asarray(y))
    _, ttarget = tgrad._whitened_target(valgrad, prior.log_prior, torch.as_tensor(lo),
                                        torch.as_tensor(span))
    lp, glp = ttarget(None, torch.as_tensor(y))
    assert not lp.requires_grad and not glp.requires_grad
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-5,
                               atol=1e-5 * np.abs(jlp).max())
    np.testing.assert_allclose(glp.numpy(), np.asarray(jglp), rtol=1e-5,
                               atol=1e-5 * np.abs(jglp).max())
    _, bare = tgrad._whitened_target(valgrad, None, torch.as_tensor(lo), torch.as_tensor(span))
    lp0, glp0 = bare(None, torch.as_tensor(y))
    assert (lp0 - lp).abs().max() > 1.0 and (glp0 - glp).abs().max() > 1.0  # the prior bites

    leaf = torch.tensor(y, requires_grad=True)
    x = torch.as_tensor(lo) + torch.as_tensor(span) * torch.sigmoid(leaf)
    total = (valgrad(None, x)[0] + prior.log_prior(x)
             + torch.sum(torch.nn.functional.logsigmoid(leaf)
                         + torch.nn.functional.logsigmoid(-leaf), dim=-1))
    (auto,) = torch.autograd.grad(total.sum(), leaf)
    np.testing.assert_allclose(glp.numpy(), auto.numpy(), rtol=1e-4,
                               atol=1e-5 * float(auto.abs().max()))


def _np_logp_and_grad(y, lo, span):
    """The whitened log-posterior of the conjugate target and its gradient
    in float64 NumPy: likelihood, prior, and the sigmoid map's Jacobian."""
    s = 1.0 / (1.0 + np.exp(-y))
    x = lo + span * s
    lp = (-0.5 * np.sum(((x - MU_L) / SIG_L) ** 2, -1)
          - 0.5 * np.sum(((x - MU_P) / SIG_P) ** 2, -1)
          + np.sum(np.log(s) + np.log1p(-s), -1))
    g_raw = -(x - MU_L) / SIG_L**2 - (x - MU_P) / SIG_P**2
    return lp, g_raw * (span * s * (1.0 - s)) + (1.0 - 2.0 * s)


def test_hmc_step_with_prior_matches_numpy_transcription(prior):
    """One HMC transition of 32 walkers on injected momenta and
    log-uniforms under a prior, against the same leapfrog in float64
    NumPy whose force includes the prior's gradient."""
    rng = np.random.default_rng(4)
    n, d, n_leap, eps = 32, 3, 4, 0.05
    lo, span = BOUNDS[:, 0], BOUNDS[:, 1] - BOUNDS[:, 0]
    y = rng.normal(0.0, 0.3, (n, d))
    p0 = rng.normal(size=(n, d))
    log_u = np.log(rng.uniform(size=n))
    log_u[1::5] = 5.0  # some walkers must reject

    lp, glp = _np_logp_and_grad(y, lo, span)
    p = p0 + 0.5 * eps * glp
    q = y
    for _ in range(n_leap - 1):
        q = q + eps * p
        p = p + eps * _np_logp_and_grad(q, lo, span)[1]
    q = q + eps * p
    lp_new, g_new = _np_logp_and_grad(q, lo, span)
    p = p + 0.5 * eps * g_new
    dh = (lp_new - lp) - 0.5 * (np.sum(p**2, -1) - np.sum(p0**2, -1))
    acc = log_u < dh

    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    _, target = tgrad._whitened_target(valgrad, prior.log_prior, f32(lo), f32(span))
    tlp, tglp = target(None, f32(y))
    got = tgrad.hmc_step(target, None, f32(y), tlp, tglp, torch.ones(d), f32([eps]), n_leap,
                         f32(p0), f32(log_u))
    moved = (got[0] != f32(y)).any(dim=1).numpy()
    np.testing.assert_array_equal(moved, acc)
    np.testing.assert_allclose(got[0].numpy(), np.where(acc[:, None], q, y), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.where(acc, lp_new, lp), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got[2].numpy(), np.where(acc[:, None], g_new, glp), rtol=1e-3,
                               atol=1e-3)
    assert float(got[3][0]) == pytest.approx(np.minimum(1.0, np.exp(dh)).mean(), rel=1e-4)
    assert 0 < acc.sum() < n


def _np_score(x, lo, hi):
    """The box score of likelihood × prior in float32 NumPy."""
    inside = ((x >= lo) & (x <= hi)).all(axis=1)
    safe = np.where(inside[:, None], x, (lo + hi) / np.float32(2.0))
    ll = (-0.5 * np.sum(((safe - _MU_L32) / _SIG_L32) ** 2, -1, dtype=np.float32)
          - np.float32(0.5 * np.log(2 * np.pi * SIG_L**2).sum()))
    lpr = -0.5 * np.sum(((safe - MU_P.astype(np.float32)) / SIG_P.astype(np.float32)) ** 2, -1,
                        dtype=np.float32)
    return np.where(inside, ll + lpr, -np.inf).astype(np.float32)


def test_mh_step_and_stretch_half_move_with_prior_match_numpy(prior):
    """One Metropolis step and one stretch half-move on injected randoms
    with a prior in the score (``_box_score`` adds it on the safe rows),
    against NumPy transcriptions; accept decisions agree bit for bit, and
    a prior that returns a tensor with a graph leaks none into the state."""
    rng = np.random.default_rng(5)
    n = 48
    lo = (MU_C - 3 * SIG_C).astype(np.float32)
    hi = (MU_C + 3 * SIG_C).astype(np.float32)
    x = np.clip((MU_C + 1.5 * SIG_C * rng.normal(size=(n, 3))).astype(np.float32), lo, hi)
    lp = _np_score(x, lo, hi)
    scale = torch.ones(3, requires_grad=True)  # a prior that carries a graph
    score = mh._box_score(normalized_loglik, lambda q: prior.log_prior(q * scale),
                          torch.as_tensor(lo), torch.as_tensor(hi))

    base = np.float32(0.4) * (hi - lo)
    noise = rng.normal(size=(n, 3)).astype(np.float32)
    log_u = np.log(rng.uniform(size=n)).astype(np.float32)
    prop = x + base * noise
    lp_prop = _np_score(prop, lo, hi)
    acc = log_u < lp_prop - lp
    with torch.no_grad():  # as sample_mh runs it
        got = mh.mh_step(score, None, torch.as_tensor(x), torch.as_tensor(lp), torch.ones(1),
                         torch.as_tensor(base), torch.as_tensor(noise), torch.as_tensor(log_u))
    assert not got[0].requires_grad and not got[1].requires_grad
    np.testing.assert_array_equal((got[0].numpy() != x).any(axis=1), acc)
    np.testing.assert_allclose(got[1].numpy(), np.where(acc, lp_prop, lp), rtol=1e-5, atol=1e-5)
    assert (~np.isfinite(lp_prop)).any() and 0 < acc.mean() < 1

    xb = np.clip((MU_C + 1.5 * SIG_C * rng.normal(size=(n, 3))).astype(np.float32), lo, hi)
    u = rng.uniform(size=n).astype(np.float32)
    j = rng.integers(0, n, size=n)
    z = ((np.float32(1.0) * u + np.float32(1.0)) ** 2 / np.float32(2.0)).astype(np.float32)
    prop = xb[j] + z[:, None] * (x - xb[j])
    lp_prop = _np_score(prop, lo, hi)
    with np.errstate(invalid="ignore"):
        acc = log_u < np.float32(2.0) * np.log(z) + lp_prop - lp
    with torch.no_grad():
        got = mh.stretch_half_move(score, None, torch.as_tensor(x), torch.as_tensor(lp),
                                   torch.as_tensor(xb), 2.0, torch.as_tensor(u),
                                   torch.as_tensor(j), torch.as_tensor(log_u))
    np.testing.assert_array_equal((got[0].numpy() != x).any(axis=1), acc)
    np.testing.assert_allclose(got[1].numpy(), np.where(acc, lp_prop, lp), rtol=1e-5, atol=1e-5)
    assert 0 < acc.mean() < 1


def test_mh_targets_likelihood_times_prior(prior):
    res = sample_mh(normalized_loglik, None, n_walkers=256, n_steps=500, n_warmup=300,
                    thin=5, bounds=BOUNDS, seed=0, log_prior=prior.log_prior, device="cpu")
    flat = res.flat
    assert np.allclose(flat.mean(0), MU_C, atol=5 * SIG_C / np.sqrt(500))
    assert np.allclose(flat.std(0), SIG_C, rtol=0.12)


def test_stretch_targets_likelihood_times_prior(prior):
    res = sample_ensemble(normalized_loglik, None, n_walkers=256, n_steps=600, n_warmup=300,
                          thin=5, bounds=BOUNDS, seed=1, log_prior=prior.log_prior,
                          device="cpu")
    flat = res.flat
    assert np.allclose(flat.mean(0), MU_C, atol=5 * SIG_C / np.sqrt(500))
    assert np.allclose(flat.std(0), SIG_C, rtol=0.12)


def test_hmc_targets_likelihood_times_prior(prior):
    res = sample_hmc(valgrad, None, n_walkers=256, n_steps=300, n_warmup=150, n_leapfrog=6,
                     thin=5, bounds=BOUNDS, seed=2, log_prior=prior.log_prior, device="cpu")
    flat = res.flat
    assert np.allclose(flat.mean(0), MU_C, atol=5 * SIG_C / np.sqrt(300))
    assert np.allclose(flat.std(0), SIG_C, rtol=0.12)
    assert 0.5 < float(res.accept_rate[-20:].mean()) <= 1.0  # the force matches the target


@pytest.mark.parametrize("sampler", ["mh", "ensemble", "hmc"])
def test_model_level_prior_passthrough(splits, sampler):
    """log_prior flows through sample_posterior's kwargs to every sampler
    on a real emulator: a prior of 2 % of the box on parameter 3 pulls its
    draws to the prior's centre, and under MH an essentially-delta prior
    pins it (the JAX suite's assertion, at its settings)."""
    _, tm = make_pair(splits, (32,))
    obs = tm.predict(splits.par_test[0])
    par = np.asarray(splits.par_train, np.float64)
    lo, hi = par.min(0), par.max(0)
    lo[:3] = np.maximum(lo[:3], 1e-6)
    bounds = np.stack([lo, hi], axis=1)
    mid, span = 0.5 * (lo + hi), hi - lo
    kw = dict(sampler=sampler, bounds=bounds, n_walkers=64, n_steps=40, n_warmup=40, thin=5,
              seed=0)
    if sampler == "mh":
        tight = GaussianBoxPrior.for_params({3: (mid[3], 1e-4 * span[3])}, bounds=bounds)
        res = tm.sample_posterior(obs, 25.0, log_prior=tight.log_prior, **kw)
        assert abs(res.flat[:, 3].mean() - mid[3]) < 0.02 * span[3]
    prior = GaussianBoxPrior.for_params({3: (mid[3], 0.02 * span[3])}, bounds=bounds)
    res = tm.sample_posterior(obs, 25.0, log_prior=prior.log_prior, **kw)
    free = tm.sample_posterior(obs, 25.0, **kw)
    assert np.isfinite(res.logp).all()
    off_centre = np.abs(res.final[:, 3] - mid[3]).mean()
    assert off_centre < 0.5 * np.abs(free.final[:, 3] - mid[3]).mean()


def test_reweight_matches_analytic_conjugate():
    """Importance reweighting a flat-prior chain to a Gaussian prior
    reproduces the analytic conjugate posterior, the Kish ESS collapses
    when the new prior excludes the cloud, and on the same chain the
    weights and summaries equal the JAX package's."""
    from tpu21cmvae.sampling import reweight as jax_reweight

    bounds = np.array([[-6.0, 6.0]] * 2)
    sig_l = 0.8

    def loglik(params, x):
        return -0.5 * torch.sum((x / sig_l) ** 2, dim=-1)

    res = sample_mh(loglik, None, n_walkers=512, n_steps=400, n_warmup=200, thin=5,
                    bounds=bounds, seed=0, device="cpu")
    prior = GaussianBoxPrior.for_params({0: (1.0, 0.5)}, n_params=2, bounds=bounds)
    wp = reweight(res, prior.log_prior, device="cpu")
    s2 = 1.0 / (1.0 / sig_l**2 + 1.0 / 0.25)
    mu = s2 * (1.0 / 0.25)
    assert wp.ess() > 1000
    assert abs(wp.mean()[0] - mu) < 0.05
    assert abs(wp.std()[0] - np.sqrt(s2)) < 0.05
    assert abs(wp.mean()[1]) < 0.05
    assert abs(wp.quantile(0.5)[0] - wp.mean()[0]) < 0.05
    draws = wp.resample(4000, seed=1)
    assert abs(draws[:, 0].mean() - mu) < 0.08
    far = GaussianBoxPrior.for_params({0: (5.5, 0.01)}, n_params=2, bounds=bounds)
    assert reweight(res, far.log_prior, device="cpu").ess() < 50

    jprior = JaxPrior.for_params({0: (1.0, 0.5)}, n_params=2, bounds=bounds)
    jwp = jax_reweight(res.flat, jprior.log_prior)
    assert wp.logw.dtype == np.float64
    np.testing.assert_array_equal(wp.samples, jwp.samples)
    np.testing.assert_allclose(wp.logw, jwp.logw, rtol=0, atol=1e-5)
    np.testing.assert_allclose(wp.ess(), jwp.ess(), rtol=1e-5)
    np.testing.assert_array_equal(wp.resample(64, seed=2).shape, (64, 2))
    same = reweight(res.flat, prior.log_prior, prior.log_prior, device="cpu")
    assert np.all(same.logw == 0.0)  # new and old cancel
    thinned = reweight(res.flat, prior.log_prior, max_samples=1000, device="cpu")
    assert thinned.samples.shape[0] <= 1000
    with pytest.raises(ValueError, match="n_params"):
        reweight(np.zeros(5), None, device="cpu")
    with pytest.raises(ValueError, match="no support"):
        reweight(res.flat[:8], lambda x: torch.full((x.shape[0],), -torch.inf), device="cpu")
