"""The port's nested sampling (``tpu21cmvae_torch/nested.py``) against the
JAX package's (``tpu21cmvae/nested.py``).

Tolerances: the NumPy bookkeeping (``_log1mexp``, ``_logz_dead``) bit for
bit in float64; one iteration's states to rtol 1e-5 from the same inputs
and the randoms JAX's ``one_iter`` draws from its key (the JAX function
itself, reached through the closure of its program builder), with the
same dead points, the same survivors seeding the chains and every
``logL > L*`` decision equal; the closed-form targets at the JAX suite's
own assertions and sizes (``tests/test_nested.py``).
"""

import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_pair import one_torch_thread  # noqa: F401  (autouse fixture)
from tpu21cmvae import nested as jnested
from tpu21cmvae_torch import nested as tnested
from tpu21cmvae_torch.nested import NestedResult, nested_sampling, nested_sampling_batch

MU = np.array([0.5, -1.0, 2.0], np.float32)
SIG = np.array([0.3, 0.7, 0.2], np.float32)
LO, HI = MU - 4 * SIG, MU + 4 * SIG
BOUNDS = np.stack([LO, HI], axis=1)
LOG_V = float(np.log((HI - LO).astype(np.float64)).sum())


def _gauss_logz(sig, trunc=4.0):
    """log ∫ exp(-q/2) dx / V for an axis-aligned Gaussian ±trunc·σ."""
    logz = -LOG_V
    for s in np.atleast_1d(sig):
        logz += math.log(s * math.sqrt(2 * math.pi)) + math.log(math.erf(trunc / math.sqrt(2)))
    return logz


def _gauss(mu, sig):
    mu_t, sig_t = torch.as_tensor(mu), torch.as_tensor(sig)

    def loglik(params, x):
        return -0.5 * torch.sum(((x - mu_t) / sig_t) ** 2, dim=-1)

    return loglik


# -- the NumPy bookkeeping -------------------------------------------------------


def test_log1mexp_and_logz_dead_are_bit_exact():
    """``_log1mexp`` on both sides of log 2 and at 0⁻, and the dead
    points' evidence sum of a ragged last batch, equal JAX's in float64."""
    d = -np.concatenate([np.logspace(-320, 3, 400), [0.0, np.log(2.0)]])
    assert tnested._log1mexp(d).tobytes() == jnested._log1mexp(d).tobytes()
    per_death = 1.0 / (64 - np.arange(8, dtype=np.float64))
    rng = np.random.default_rng(0)
    dead = np.sort(rng.normal(-20.0, 5.0, size=8 * 13 + 5))
    dead[:3] = -np.inf
    for n in (0, 1, 8, len(dead)):
        got = tnested._logz_dead(dead[:n], per_death.sum(), np.cumsum(per_death))
        want = jnested._logz_dead(dead[:n], per_death.sum(), np.cumsum(per_death))
        assert np.float64(got).tobytes() == np.float64(want).tobytes()


# -- one iteration ------------------------------------------------------------------


MUS = np.stack([MU, MU + 0.5 * SIG]).astype(np.float32)


def _jax_multi(params, x):
    xr = x.reshape(2, x.shape[0] // 2, 3)
    z = (xr - MUS[:, None, :]) / SIG
    return (-0.5 * jnp.sum(z * z, axis=-1)).reshape(-1)


def _torch_multi(params, x):
    xr = x.reshape(2, x.shape[0] // 2, 3)
    z = (xr - torch.as_tensor(MUS)[:, None, :]) / torch.as_tensor(SIG)
    return (-0.5 * torch.sum(z * z, dim=-1)).reshape(-1)


@pytest.mark.parametrize("seed", [0, 1])
def test_one_iter_with_injected_randoms_matches_jax(seed):
    """One iteration of two observations' live sets, one holding four
    ``-inf`` points (they tie, and the stable sort kills them in index
    order): the same dead points and threshold, the same chains and
    acceptances, the adapted scales, to rtol 1e-5."""
    n_live, n_batch, n_mh = 32, 6, 4
    cfg = jnested._NestedProgram(n_obs=2, n_live=n_live, n_batch=n_batch, n_mh=n_mh,
                                 target_accept=0.3, iters_per_chunk=1)
    _, run_chunk = jnested._build_nested_programs(_jax_multi, lambda u: u, jnp.asarray(LO),
                                                  jnp.asarray(HI), lambda a: a, cfg)
    one_iter = jax.jit(inspect.getclosurevars(run_chunk.__wrapped__).nonlocals["one_iter"])
    rng = np.random.default_rng(seed)
    x = (MUS[:, None, :] + 1.5 * SIG * rng.normal(size=(2, n_live, 3))).astype(np.float32)
    x = np.clip(x, LO, HI)
    ll = np.array(_jax_multi(None, jnp.asarray(x.reshape(-1, 3)))).reshape(2, n_live)
    ll[0, [3, 9, 10, 20]] = -np.inf
    log_scale = np.array([0.0, -0.7], np.float32)
    k = jax.random.key(40 + seed)
    (jx, jll, jscale), (jdead_ll, jdead_x, jacc) = one_iter(
        None, (jnp.asarray(x), jnp.asarray(ll), jnp.asarray(log_scale)), k)
    k_start, k_mh = jax.random.split(k)
    ri = torch.as_tensor(np.array(jax.random.randint(k_start, (2, n_batch), 0,
                                                     n_live - n_batch)), dtype=torch.long)
    noise = torch.stack([torch.as_tensor(np.array(jax.random.normal(
        jax.random.split(kk)[0], (2, n_batch, 3), jnp.float32)))
        for kk in jax.random.split(k_mh, n_mh)])
    lo, hi = torch.as_tensor(LO), torch.as_tensor(HI)
    safe_ll = tnested.box_loglik(_torch_multi, lambda u: u, lo, hi)
    tx, tll, tscale, tdead_ll, tdead_x, tacc = tnested.one_iter(
        safe_ll, None, torch.as_tensor(x), torch.as_tensor(ll), torch.as_tensor(log_scale),
        n_batch, 0.3, lo, hi, ri, noise)
    np.testing.assert_array_equal(tdead_x.numpy(), np.asarray(jdead_x))
    np.testing.assert_array_equal(tdead_ll.numpy(), np.asarray(jdead_ll))
    assert np.isneginf(tdead_ll[0, :4].numpy()).all()
    assert 0.0 < float(np.asarray(jacc).min()) and float(np.asarray(jacc).max()) < 1.0
    # the acceptance is a count of logL > L* decisions over n_batch·n_mh
    # (steps of 1/24 here): equal to float32 rounding means equal counts
    np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc), rtol=1e-6)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tll.numpy(), np.asarray(jll), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tscale.numpy(), np.asarray(jscale), rtol=1e-6)


# -- the closed-form targets ---------------------------------------------------------


def test_matches_analytic_gaussian():
    res = nested_sampling(_gauss(MU, SIG), None, bounds=BOUNDS, n_live=512, n_batch=64,
                          n_mh=20, seed=0, device="cpu")
    assert isinstance(res, NestedResult)
    assert not res.truncated
    assert abs(res.logz - _gauss_logz(SIG)) < max(0.25, 3 * res.logz_err)
    assert np.isclose(np.logaddexp.reduce(res.log_w), 0.0, atol=1e-6)
    p = np.exp(res.log_w)
    mean = (p[:, None] * res.samples).sum(0)
    assert np.allclose(mean, MU, atol=0.2 * SIG)
    draws = res.posterior(512, seed=1)
    assert draws.shape == (512, 3)
    assert (draws >= LO - 1e-5).all() and (draws <= HI + 1e-5).all()
    assert res.ess > 100
    assert "log Z" in res.summary()


def test_sharp_high_dynamic_range():
    """σ = 1e-4 of the box: ~23 nats of compression."""
    sig = (1e-4 * (HI - LO)).astype(np.float32)
    logz_true = float(np.log(sig.astype(np.float64) * math.sqrt(2 * math.pi)).sum() - LOG_V)
    res = nested_sampling(_gauss(MU, sig), None, bounds=BOUNDS, n_live=512, n_batch=64,
                          n_mh=20, seed=0, device="cpu")
    assert not res.truncated
    assert abs(res.logz - logz_true) < max(0.7, 3 * res.logz_err)
    assert res.h > 15


def test_bimodal_unequal_mass():
    """Two sharp modes with 80/20 mass: log Z counts both and the weights
    split the mass."""
    mu2 = (MU + 3.2 * SIG).astype(np.float32)
    sig = (0.1 * SIG).astype(np.float32)
    a_ll, b_ll = _gauss(MU, sig), _gauss(mu2, sig)

    def loglik(params, x):
        return torch.logaddexp(a_ll(params, x) + math.log(0.8), b_ll(params, x) + math.log(0.2))

    logz_true = float(np.log(sig.astype(np.float64) * math.sqrt(2 * math.pi)).sum() - LOG_V)
    res = nested_sampling(loglik, None, bounds=BOUNDS, n_live=1024, n_batch=128, n_mh=24,
                          seed=0, device="cpu")
    assert not res.truncated
    assert abs(res.logz - logz_true) < max(0.4, 3 * res.logz_err)
    d1 = ((res.samples - MU) ** 2).sum(1)
    d2 = ((res.samples - mu2) ** 2).sum(1)
    assert abs(np.exp(res.log_w)[d2 < d1].sum() - 0.2) < 0.08


def test_truncation_flag_and_guards():
    res = nested_sampling(_gauss(MU, SIG), None, bounds=BOUNDS, n_live=256, n_batch=32,
                          n_mh=8, max_iters=8, iters_per_chunk=4, seed=0, device="cpu")
    assert res.truncated
    assert "LOWER bound" in res.summary()
    assert res.n_iters == 8 * 32
    assert res.n_like == 256 + 8 * 32 * 8
    with pytest.raises(ValueError, match="n_batch"):
        nested_sampling(_gauss(MU, SIG), None, bounds=BOUNDS, n_live=64, n_batch=64,
                        device="cpu")
    with pytest.raises(ValueError, match="n_obs"):
        nested_sampling_batch(_gauss(MU, SIG), None, 0, bounds=BOUNDS, device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        nested_sampling(_gauss(MU, SIG), None, bounds=BOUNDS, mesh=object(), device="cpu")


def test_batch_matches_sequential():
    """Per-row log Z of ``nested_sampling_batch`` agrees with the
    sequential path and the closed form (every row runs until the
    slowest stops)."""
    mus = np.stack([MU, [-0.2, 0.4, 1.2], [0.0, 0.0, 1.6]]).astype(np.float32)
    sigs = np.stack([SIG, [0.5, 0.2, 0.4], [0.2, 0.3, 0.5]]).astype(np.float32)
    lo, hi = mus.min(0) - 3.0, mus.max(0) + 3.0
    bounds = np.stack([lo, hi], 1)
    log_v = float(np.log((hi - lo).astype(np.float64)).sum())

    def loglik_multi(params, x):
        xr = x.reshape(3, x.shape[0] // 3, 3)
        z = (xr - torch.as_tensor(mus)[:, None, :]) / torch.as_tensor(sigs)[:, None, :]
        return (-0.5 * torch.sum(z * z, dim=-1)).reshape(-1)

    kw = dict(bounds=bounds, n_live=512, n_batch=64, n_mh=16, seed=0, device="cpu")
    batch = nested_sampling_batch(loglik_multi, None, 3, **kw)
    assert len(batch) == 3
    assert len({r.n_iters for r in batch}) == 1
    for o in range(3):
        seq = nested_sampling(_gauss(mus[o], sigs[o]), None, **{**kw, "seed": 17})
        true = -log_v
        for j in range(3):
            t = (hi[j] - mus[o][j]) / sigs[o][j]
            b = (lo[j] - mus[o][j]) / sigs[o][j]
            true += math.log(sigs[o][j] * math.sqrt(2 * math.pi)) + math.log(
                0.5 * (math.erf(t / math.sqrt(2)) - math.erf(b / math.sqrt(2))))
        assert not batch[o].truncated
        tol = max(0.4, 3 * math.hypot(batch[o].logz_err, seq.logz_err))
        assert abs(batch[o].logz - seq.logz) < tol
        assert abs(batch[o].logz - true) < max(0.4, 4 * batch[o].logz_err)


def test_prior_transform_gives_the_prior_evidence():
    """With ``prior_transform`` (``GaussianBoxPrior.prior_transform``) the
    sampler explores the unit cube and ``logz`` is the evidence under the
    (box-normalized) Gaussian prior: N(μ, σ) on the Gaussian likelihood
    gives Σ log ∫ N(x; μ+δ, s) exp(−(x−μ)²/2σ²) dx; samples come back in
    raw units inside the box."""
    from tpu21cmvae_torch.priors import GaussianBoxPrior

    shift, s = 0.3 * SIG.astype(np.float64), SIG.astype(np.float64)
    prior = GaussianBoxPrior.for_params({i: (float(MU[i] + shift[i]), float(s[i]))
                                         for i in range(3)}, n_params=3, bounds=BOUNDS)
    res = nested_sampling(_gauss(MU, SIG), None, bounds=BOUNDS, n_live=512, n_batch=64,
                          n_mh=20, seed=0, prior_transform=prior.prior_transform,
                          device="cpu")
    # ∫ N(x; m, s²) exp(−(x−μ)²/2σ²) dx = σ/√(σ²+s²) · exp(−(m−μ)²/2(σ²+s²)),
    # the ±4σ box cutting a negligible tail
    var = s**2 + SIG.astype(np.float64) ** 2
    true = float(np.sum(np.log(SIG / np.sqrt(var)) - shift**2 / (2 * var)))
    assert not res.truncated
    assert abs(res.logz - true) < max(0.25, 3 * res.logz_err), (res.logz, true)
    assert (res.samples >= LO - 1e-5).all() and (res.samples <= HI + 1e-5).all()
    p = np.exp(res.log_w)
    want_mean = MU + shift * SIG**2 / var  # the product of two Gaussians
    assert np.allclose((p[:, None] * res.samples).sum(0), want_mean, atol=0.1 * SIG)
