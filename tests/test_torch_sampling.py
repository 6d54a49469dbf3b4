"""The port's HMC: statistical exactness on an analytic target, and one
transition with injected randoms against a JAX transcription of the JAX
package's step (``tpu21cmvae/sampling/gradient.py:276-310``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu21cmvae.sampling import gradient as jgrad
from tpu21cmvae.sampling._common import _thin_state as jthin_state
from tpu21cmvae.sampling._common import _thin_write as jthin_write
from tpu21cmvae_torch.sampling import gradient as tgrad
from tpu21cmvae_torch.sampling._common import _thin_state, _thin_write
from tpu21cmvae_torch.sampling.gradient import sample_hmc

MU = np.array([1.0, -0.5, 2.0], np.float32)
SIG = np.array([2.0, 0.05, 0.4], np.float32)


def _torch_valgrad(params, x):
    mu, sig = torch.as_tensor(MU), torch.as_tensor(SIG)
    z = (x - mu) / sig
    return -0.5 * torch.sum(z**2, dim=-1), -z / sig


def _jax_valgrad(params, x):
    z = (x - MU) / SIG
    return -0.5 * jnp.sum(z**2, axis=-1), -z / SIG


def test_hmc_exact_on_analytic_anisotropic_gaussian():
    """``tests/test_sampling.py::test_hmc_exact_on_analytic_anisotropic_gaussian``
    with the same assertions: a 40× scale split between dimensions, the
    ensemble metric and jittered trajectories recover both axes' moments."""
    bounds = np.stack([MU - 8 * SIG, MU + 8 * SIG], axis=1)
    res = sample_hmc(
        _torch_valgrad, None, n_walkers=256, n_steps=300, n_warmup=150,
        n_leapfrog=8, thin=5, bounds=bounds, seed=2, device="cpu",
    )
    flat = res.flat
    assert res.chain.shape == (60, 256, 3)
    assert np.allclose(flat.mean(0), MU, atol=4 * SIG / np.sqrt(300))
    assert np.allclose(flat.std(0), SIG, rtol=0.12)
    assert 0.5 < float(res.accept_rate[-20:].mean()) <= 1.0
    assert res.block_step_sizes.shape == (1,) and res.step_size > 0


def _jax_hmc_step(logp_and_grad, params, y, lp, glp, met, eps_blk, n_leap, p0, log_u):
    """gradient.py:276-310 with the randoms passed in (``p0`` for
    ``jax.random.normal(kp, …)``, ``log_u`` for ``jnp.log(uniform(ku))``)."""
    n_blk = eps_blk.shape[0]
    eps = jnp.repeat(eps_blk, y.shape[0] // n_blk)[:, None]
    p = p0 + 0.5 * eps * jgrad._met_pull(met, glp)
    q, g = y, glp
    for _ in range(n_leap - 1):
        q = q + eps * jgrad._met_scale(met, p)
        _, g = logp_and_grad(params, q)
        p = p + eps * jgrad._met_pull(met, g)
    q = q + eps * jgrad._met_scale(met, p)
    lp_new, g_new = logp_and_grad(params, q)
    p = p + 0.5 * eps * jgrad._met_pull(met, g_new)
    dh = (lp_new - lp) - 0.5 * (jnp.sum(p**2, -1) - jnp.sum(p0**2, -1))
    acc = log_u < dh
    acc = acc | (~jnp.isfinite(lp) & jnp.isfinite(lp_new))
    y = jnp.where(acc[:, None], q, y)
    lp = jnp.where(acc, lp_new, lp)
    glp = jnp.where(acc[:, None], g_new, glp)
    a = jnp.where(jnp.isfinite(dh), jnp.minimum(1.0, jnp.exp(dh)), 0.0)
    return y, lp, glp, a.reshape(n_blk, -1).mean(axis=1)


@pytest.mark.parametrize("dense", [False, True])
def test_one_step_with_injected_randoms_matches_jax(dense):
    """One transition of 64 walkers in two adaptation blocks, from the
    same start, momenta and log-uniforms, with one walker whose current
    lp is non-finite (the recovery rule): rtol 1e-5 (float32 sigmoid and
    log-sigmoid round differently in the two libraries)."""
    rng = np.random.default_rng(0)
    n, d = 64, 3
    bounds = np.stack([MU - 8 * SIG, MU + 8 * SIG], axis=1)
    lo, hi = bounds[:, 0], bounds[:, 1]
    x0 = (MU + SIG * rng.normal(size=(n, d))).astype(np.float32)
    p0 = rng.normal(size=(n, d)).astype(np.float32)
    log_u = np.log(rng.uniform(size=n)).astype(np.float32)
    log_u[1::7] = 5.0  # some walkers must reject
    eps_blk = np.array([0.05, 0.08], np.float32)  # stable: y-space sd ≈ 0.25
    if dense:
        a = rng.normal(size=(d, d))
        met = np.linalg.cholesky(a @ a.T + d * np.eye(d)).astype(np.float32)[None] / 3
    else:
        met = rng.uniform(0.5, 2.0, size=d).astype(np.float32)

    _, jtarget = jgrad._whitened_target(_jax_valgrad, None, jnp.asarray(lo),
                                        jnp.asarray(hi - lo))
    y = jgrad._whiten_init(jnp.asarray(x0), jnp.asarray(lo), jnp.asarray(hi - lo))
    lp, glp = jtarget(None, y)
    lp = lp.at[0].set(-jnp.inf)
    want = _jax_hmc_step(jtarget, None, y, lp, glp, jnp.asarray(met), jnp.asarray(eps_blk),
                         5, jnp.asarray(p0), jnp.asarray(log_u))

    tlo, thi = torch.as_tensor(lo), torch.as_tensor(hi)
    _, ttarget = tgrad._whitened_target(_torch_valgrad, None, tlo, thi - tlo)
    ty = tgrad._whiten_init(torch.as_tensor(x0), tlo, thi - tlo)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), rtol=1e-6, atol=1e-6)
    tlp, tglp = ttarget(None, ty)
    np.testing.assert_allclose(tlp[1:].numpy(), np.asarray(lp[1:]), rtol=1e-6)
    np.testing.assert_allclose(tglp.numpy(), np.asarray(glp), rtol=1e-5, atol=1e-6)
    tlp[0] = -torch.inf
    got = tgrad.hmc_step(ttarget, None, ty, tlp, tglp, torch.as_tensor(met),
                         torch.as_tensor(eps_blk), 5, torch.as_tensor(p0),
                         torch.as_tensor(log_u))
    for mine, theirs in zip(got, want):
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(mine.numpy(), theirs, rtol=1e-5,
                                   atol=1e-5 * np.abs(theirs).max())
    assert np.isfinite(got[1].numpy()[0])  # the non-finite walker recovered
    moved = (got[0] != ty).any(dim=1).numpy()
    assert moved[0] and not moved[1::7].any() and moved.sum() > n // 2


def test_ensemble_metric_and_thinning_match_jax():
    rng = np.random.default_rng(1)
    y = (rng.normal(size=(500, 4)) * [1.0, 0.1, 5.0, 2.0]).astype(np.float32)
    y[:, 3] += 0.5 * y[:, 0]
    for dense in (False, True):
        np.testing.assert_allclose(
            tgrad._ens_metric_blocks(torch.as_tensor(y), dense, 1).numpy(),
            np.asarray(jgrad._ens_metric_blocks(jnp.asarray(y), dense, 1)),
            rtol=1e-4, atol=1e-5,
        )
    assert tgrad._resolve_metric("auto", True, 100, 4096, False) == (True, False)
    assert tgrad._resolve_metric("dense", True, 10, 4096, False) == (False, False)
    with pytest.raises(ValueError, match="metric"):
        tgrad._resolve_metric("full", True, 100, 64, False)
    x = torch.zeros((5, 2))
    n_keep, buf = _thin_state(13, 3, x)
    jn, jbuf = jthin_state(13, 3, jnp.zeros((5, 2)))
    for t in range(13):
        _thin_write(buf, t, x + t, 3)
        jbuf = jthin_write(jbuf, jnp.int32(t), jnp.zeros((5, 2)) + t, 3, jn)
    assert n_keep == jn == 4
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf)[:jn])
    assert _thin_state(13, 0, x)[1].shape == (0, 5, 2)


def test_sampler_refusals():
    # a log_prior is taken (it was refused before the priors were ported)
    res = sample_hmc(_torch_valgrad, None, n_walkers=16, n_warmup=0, n_steps=1,
                     bounds=np.stack([MU - 1, MU + 1], 1), device="cpu",
                     log_prior=lambda x: x.sum(-1))
    assert np.isfinite(res.logp).all()
    # the per-block metric is ported: two blocks' own metrics, as JAX's
    y = (np.random.default_rng(2).normal(size=(64, 3)) * [1.0, 3.0, 0.2]).astype(np.float32)
    for dense in (False, True):
        np.testing.assert_allclose(
            tgrad._ens_metric_blocks(torch.as_tensor(y), dense, 2).numpy(),
            np.asarray(jgrad._ens_metric_blocks(jnp.asarray(y), dense, 2)),
            rtol=1e-4, atol=1e-5,
        )
    with pytest.raises(ValueError, match="adapt_blocks"):
        sample_hmc(_torch_valgrad, None, n_walkers=10, adapt_blocks=3, device="cpu")
    with pytest.raises(TypeError):
        sample_hmc(_torch_valgrad, None, n_walkers=16)  # no device
