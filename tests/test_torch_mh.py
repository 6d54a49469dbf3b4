"""The port's gradient-free samplers (``tpu21cmvae_torch/sampling/mh.py``):
one MH step and one stretch half-move with injected randoms against NumPy
transcriptions of the JAX package's (``tpu21cmvae/sampling/mh.py:55-75``
and ``:263-278``), statistical exactness on an analytic Gaussian in both
packages, MH's scale adaptation, the refusals, and ``sample_posterior``
end to end on a small model."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu21cmvae.sampling import sample_ensemble as jax_sample_ensemble
from tpu21cmvae.sampling import sample_mh as jax_sample_mh
from tpu21cmvae_torch.models.direct import DirectEmulator
from tpu21cmvae_torch.sampling import mh
from tpu21cmvae_torch.sampling.mh import sample_ensemble, sample_mh
from tpu21cmvae_torch.utils.config import DirectEmulatorConfig

MU = np.array([0.5, -1.0, 2.0], np.float32)
SIG = np.array([0.3, 0.7, 0.2], np.float32)
BOUNDS = np.stack([MU - 8 * SIG, MU + 8 * SIG], axis=1)


def _np_loglik(x):
    return -0.5 * np.sum(((x - MU) / SIG) ** 2, axis=-1, dtype=np.float32)


def _torch_loglik(params, x):
    return -0.5 * torch.sum(((x - torch.as_tensor(MU)) / torch.as_tensor(SIG)) ** 2, dim=-1)


def _jax_loglik(params, x):
    return -0.5 * jnp.sum(((x - MU) / SIG) ** 2, axis=-1)


def _np_score(x, lo, hi):
    inside = ((x >= lo) & (x <= hi)).all(axis=1)
    safe = np.where(inside[:, None], x, (lo + hi) / np.float32(2.0))
    return np.where(inside, _np_loglik(safe), -np.inf).astype(np.float32)


def _torch_score(lo, hi):
    return mh._box_score(_torch_loglik, lambda x: torch.zeros(x.shape[0]),
                         torch.as_tensor(lo), torch.as_tensor(hi))


def _walkers(rng, n, lo, hi):
    x = (MU + 2.0 * SIG * rng.normal(size=(n, 3))).astype(np.float32)
    return np.clip(x, lo, hi)


def test_mh_step_matches_numpy_transcription():
    """mh.py:55-75 in NumPy with the normals and log-uniforms passed in:
    64 walkers in two adaptation blocks, a box tight enough that some
    proposals leave it, and one walker whose current lp is -inf (it must
    move onto a finite proposal). Accept decisions agree bit for bit."""
    rng = np.random.default_rng(0)
    n = 64
    lo, hi = (MU - 2 * SIG).astype(np.float32), (MU + 2 * SIG).astype(np.float32)
    x = _walkers(rng, n, lo, hi)
    lp = _np_score(x, lo, hi)
    lp[0] = -np.inf
    mult = np.array([0.7, 1.9], np.float32)
    base = np.float32(0.5) * (hi - lo)
    noise = rng.normal(size=(n, 3)).astype(np.float32)
    log_u = np.log(rng.uniform(size=n)).astype(np.float32)

    # the JAX package's step, transcribed
    m_row = np.repeat(mult, n // 2)[:, None]
    prop = x + m_row * base * noise
    lp_prop = _np_score(prop, lo, hi)
    with np.errstate(invalid="ignore"):
        acc = log_u < lp_prop - lp
    acc = acc | (~np.isfinite(lp) & np.isfinite(lp_prop))
    want_x = np.where(acc[:, None], prop, x)
    want_lp = np.where(acc, lp_prop, lp)
    want_rate = acc.reshape(2, -1).mean(axis=1)

    got = mh.mh_step(_torch_score(lo, hi), None, torch.as_tensor(x), torch.as_tensor(lp),
                     torch.as_tensor(mult), torch.as_tensor(base), torch.as_tensor(noise),
                     torch.as_tensor(log_u))
    moved = (got[0].numpy() != x).any(axis=1)
    np.testing.assert_array_equal(moved, acc)
    np.testing.assert_allclose(got[0].numpy(), want_x, rtol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), want_lp, rtol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), want_rate.astype(np.float32))
    assert acc[0] and np.isfinite(got[1].numpy()[0])  # the -inf walker recovered
    assert (~np.isfinite(lp_prop)).any() and 0 < acc.mean() < 1  # outside proposals rejected


def test_stretch_half_move_matches_numpy_transcription():
    """mh.py:263-278 in NumPy with the uniforms, partner indices and
    log-uniforms passed in; one walker of half A starts at -inf."""
    rng = np.random.default_rng(1)
    n, a = 24, 2.0
    lo, hi = (MU - 3 * SIG).astype(np.float32), (MU + 3 * SIG).astype(np.float32)
    xa, xb = _walkers(rng, n, lo, hi), _walkers(rng, n, lo, hi)
    lpa = _np_score(xa, lo, hi)
    lpa[3] = -np.inf
    u = rng.uniform(size=n).astype(np.float32)
    j = rng.integers(0, n, size=n)
    log_u = np.log(rng.uniform(size=n)).astype(np.float32)

    z = ((np.float32(a - 1.0) * u + np.float32(1.0)) ** 2 / np.float32(a)).astype(np.float32)
    xj = xb[j]
    prop = xj + z[:, None] * (xa - xj)
    lp_prop = _np_score(prop, lo, hi)
    with np.errstate(invalid="ignore"):
        log_ratio = np.float32(2.0) * np.log(z) + lp_prop - lpa
        acc = log_u < log_ratio
    acc = acc | (~np.isfinite(lpa) & np.isfinite(lp_prop))

    got = mh.stretch_half_move(_torch_score(lo, hi), None, torch.as_tensor(xa),
                               torch.as_tensor(lpa), torch.as_tensor(xb), a,
                               torch.as_tensor(u), torch.as_tensor(j), torch.as_tensor(log_u))
    moved = (got[0].numpy() != xa).any(axis=1)
    np.testing.assert_array_equal(moved, acc)
    np.testing.assert_allclose(got[0].numpy(), np.where(acc[:, None], prop, xa), rtol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.where(acc, lp_prop, lpa), rtol=1e-5)
    assert float(got[2]) == pytest.approx(acc.mean())
    assert acc[3] and 0 < acc.mean() < 1


@pytest.mark.parametrize("sampler", ["mh", "ensemble"])
def test_exact_on_analytic_gaussian_in_both_packages(sampler):
    """``tests/test_sampling.py::test_ensemble_exact_on_analytic_gaussian``'s
    target and assertions (mean within 4 sd/√200, sd within 10 %), met by
    the JAX sampler and the port's at the same settings."""
    kw = dict(n_walkers=128, n_steps=600, n_warmup=300, thin=5, bounds=BOUNDS, seed=3)
    if sampler == "mh":
        kw.update(step_frac=0.05)
        port = sample_mh(_torch_loglik, None, device="cpu", **kw)
        ref = jax_sample_mh(_jax_loglik, None, **kw)
    else:
        port = sample_ensemble(_torch_loglik, None, device="cpu", **kw)
        ref = jax_sample_ensemble(_jax_loglik, None, **kw)
    for res in (port, ref):
        flat = res.flat
        assert res.chain.shape == (120, 128, 3)
        assert np.allclose(flat.mean(0), MU, atol=4 * SIG / np.sqrt(200))
        assert np.allclose(flat.std(0), SIG, rtol=0.10)
    assert port.step_size == pytest.approx(ref.step_size, rel=0.5)


def test_mh_adaptation_reaches_target_accept():
    """``tests/test_sampling.py::test_mh_adaptation_converges_to_target``
    on the analytic target: from a step_frac far too large, dual averaging
    lands near 0.3, and ``adapt=False`` keeps the starting scale."""
    kw = dict(n_walkers=128, n_steps=40, n_warmup=150, thin=0, bounds=BOUNDS, seed=8,
              step_frac=0.5, device="cpu")
    fixed = sample_mh(_torch_loglik, None, adapt=False, **kw)
    adapted = sample_mh(_torch_loglik, None, **kw)
    assert abs(float(adapted.accept_rate.mean()) - 0.3) < 0.1
    assert float(fixed.accept_rate.mean()) < 0.1
    assert fixed.step_size == pytest.approx(0.5 * float(np.mean(BOUNDS[:, 1] - BOUNDS[:, 0])))
    assert adapted.step_size < fixed.step_size
    assert fixed.chain.shape == (0, 128, 3)
    blocks = sample_mh(_torch_loglik, None, adapt_blocks=4, **kw)
    assert blocks.block_step_sizes.shape == (4,)


def test_sampler_refusals():
    dummy = lambda p, x: x.sum(-1)  # noqa: E731
    box = np.array([[0.0, 1.0]] * 3)
    with pytest.raises(ValueError, match="even"):
        sample_ensemble(dummy, None, n_walkers=17, bounds=box, device="cpu")
    with pytest.raises(ValueError, match="2\\*n_params"):
        sample_ensemble(dummy, None, n_walkers=6, bounds=box, device="cpu")
    with pytest.raises(ValueError, match="stretch scale"):
        sample_ensemble(dummy, None, n_walkers=16, a=1.0, bounds=box, device="cpu")
    with pytest.raises(ValueError, match="adapt_blocks"):
        sample_mh(dummy, None, n_walkers=10, adapt_blocks=3, bounds=box, device="cpu")
    for run in (sample_mh, sample_ensemble):
        # a log_prior is taken (it was refused before the priors were ported)
        res = run(dummy, None, n_walkers=16, n_steps=2, n_warmup=1, thin=0, bounds=box,
                  device="cpu", log_prior=lambda x: x.sum(-1))
        assert np.isfinite(res.logp).all()
        with pytest.raises(TypeError, match="Mesh"):
            run(dummy, None, n_walkers=16, bounds=box, device="cpu", mesh=object())
        with pytest.raises(TypeError):
            run(dummy, None, n_walkers=16, bounds=box)  # no device


def test_x0_continues_a_chain():
    """``x0`` continues a chain (pulled into the box first), and with
    ``n_warmup=0`` MH keeps the unit multiplier."""
    a = sample_mh(_torch_loglik, None, n_walkers=64, n_steps=20, n_warmup=10, thin=0,
                  bounds=BOUNDS, seed=6, device="cpu")
    x0 = a.final.copy()
    x0[0] = BOUNDS[:, 1] + 1.0  # outside: clipped onto the box
    b = sample_mh(_torch_loglik, None, n_walkers=64, n_steps=20, n_warmup=0, thin=0,
                  bounds=BOUNDS, seed=7, x0=x0, device="cpu")
    assert b.final.shape == a.final.shape and not np.allclose(a.final, b.final)
    assert b.step_size == pytest.approx(0.01 * float(np.mean(BOUNDS[:, 1] - BOUNDS[:, 0])))
    assert (b.final <= BOUNDS[:, 1]).all() and (b.final >= BOUNDS[:, 0]).all()


@pytest.fixture(scope="module")
def small(splits):
    m = DirectEmulator(splits, config=DirectEmulatorConfig(hidden_dims=(32, 48, 32, 24)),
                       seed=5, device="cpu")
    obs = m.predict(splits.par_test[0]) + np.random.default_rng(2).normal(0, 3.0, 451)
    bounds = np.stack([splits.par_train.min(0), splits.par_train.max(0)], axis=1)
    return m, obs, bounds


@pytest.mark.parametrize("sampler", ["mh", "ensemble"])
def test_sample_posterior_end_to_end(small, sampler):
    """``sample_posterior`` scores through the memoised ``loglik_fn``
    (the plain gram form on the CPU) and returns a finite chain inside the
    box; the K2 wrapper behind ``backend="kernel"`` is not used on the
    CPU model."""
    m, obs, bounds = small
    res = m.sample_posterior(obs, 9.0, sampler=sampler, bounds=bounds, n_walkers=64,
                             n_warmup=20, n_steps=30, thin=5, seed=4)
    assert res.chain.shape == (6, 64, 7) and res.final.shape == (64, 7)
    assert np.isfinite(res.chain).all() and np.isfinite(res.logp).all()
    assert (res.flat >= bounds[:, 0]).all() and (res.flat <= bounds[:, 1]).all()
    assert 0.0 < float(res.accept_rate.mean()) < 1.0
    assert res.accept_rate.shape == (30,)
    with torch.no_grad():
        lp = m.loglik_fn(obs, 9.0)(m.params, torch.as_tensor(res.final)).numpy()
    np.testing.assert_allclose(res.logp, lp, rtol=1e-5, atol=1e-3)


def test_sample_posterior_refusals(small):
    m, obs, bounds = small
    # target_ess= (sample_to_ess), ChEES and NUTS are ported: they run
    res = m.sample_posterior(obs, 9.0, sampler="mh", target_ess=1e9, bounds=bounds,
                             n_walkers=16, n_steps=40, n_warmup=10, thin=10, max_chunks=2)
    assert res.chain.shape == (8, 16, 7)
    for name, cap in (("chees", dict(max_leapfrog=2)), ("nuts", dict(max_depth=2))):
        res = m.sample_posterior(obs, 9.0, sampler=name, bounds=bounds, n_walkers=16,
                                 n_steps=2, n_warmup=0, thin=1, **cap)
        assert np.isfinite(res.logp).all()
    # the tempered and sequential samplers are ported too: they run
    res = m.sample_posterior(obs, 9.0, sampler="pt", bounds=bounds, n_rungs=3, n_walkers=16,
                             n_steps=4, n_warmup=0, thin=2)
    assert res.chain.shape == (2, 16, 7) and np.isfinite(res.logp).all()
    res = m.sample_posterior(obs, 9.0, sampler="smc", bounds=bounds, n_particles=64,
                             n_mh=1, target_ess_frac=0.2)
    assert res.final.shape == (64, 7) and np.isfinite(res.logz)
    with pytest.raises(TypeError, match="Mesh"):
        m.sample_posterior(obs, 9.0, sampler="pt", mesh=object())
    with pytest.raises(ValueError, match="sampler"):
        m.sample_posterior(obs, 9.0, sampler="slice")
