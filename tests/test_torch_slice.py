"""The ported slices end to end on the CPU, on the shipped flagship
checkpoint: load, predict, likelihood, the K3 value-and-gradient wrapper
(its plain version here) against the JAX package's analytic XLA twin of
K3 (``tests/test_loglik.py:445-473``), the value kernels K1 and K2
behind ``loglik_fn(backend="kernel")``, and short HMC, MH and ensemble
runs through ``sample_posterior``.

Tolerance: test_loglik tolerance (``tests/test_loglik.py:468-472``:
values rtol 2e-4, atol 2e-3·max|v|; gradients rtol 2e-3, atol 2e-3·max|g|).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu21cmvae.models import load_model
from tpu21cmvae_torch.data.synthetic import PAR_RANGES, synthetic_params
from tpu21cmvae_torch.models.direct import DirectEmulator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIRECT = os.path.join(REPO, "pretrained", "direct_synthetic.npz")


@pytest.fixture(scope="module")
def slice_setup():
    jm = load_model(DIRECT)
    tm = DirectEmulator.from_checkpoint(DIRECT, device="cpu")
    rng = np.random.default_rng(0)
    truth = synthetic_params(1, rng)[0]
    obs = (tm.predict(truth) + rng.normal(0.0, 5.0, 451)).astype(np.float32)
    raw = synthetic_params(96, rng).astype(np.float32)
    raw[4, 2] = 0.0
    return jm, tm, obs, raw


@pytest.mark.parametrize("tiers", [("highest", "highest"), ("high", "high")])
def test_flagship_slice_matches_jax(slice_setup, tiers):
    jm, tm, obs, raw = slice_setup
    prec, gprec = tiers
    np.testing.assert_allclose(
        tm.predict(raw), np.asarray(jm.predict_fn()(jm.params, jnp.asarray(raw))),
        rtol=0, atol=1e-5 * np.abs(tm.predict(raw)).max(),
    )
    v_want = np.asarray(jm.loglik_fn(obs, 25.0, precision=prec)(jm.params, jnp.asarray(raw)))
    with torch.no_grad():  # loglik_fn is differentiable; only values here
        v_got = tm.loglik_fn(obs, 25.0, precision=prec)(tm.params, torch.as_tensor(raw)).numpy()
    np.testing.assert_allclose(v_got, v_want, rtol=2e-4, atol=2e-3 * np.abs(v_want).max())
    vj, gj = jm.loglik_and_grad_fn(obs, 25.0, backend="xla", precision=prec,
                                   grad_precision=gprec)(jm.params, jnp.asarray(raw))
    k3 = tm.loglik_and_grad_fn(obs, 25.0, backend="kernel", precision=prec,
                               grad_precision=gprec)
    vt, gt = k3(tm.params, torch.as_tensor(raw))
    vj, gj, vt, gt = np.asarray(vj), np.asarray(gj), vt.numpy(), gt.numpy()
    np.testing.assert_allclose(vt, vj, rtol=2e-4, atol=2e-3 * np.abs(vj).max())
    np.testing.assert_allclose(gt, gj, rtol=2e-3, atol=2e-3 * np.abs(gj).max())
    assert gt[4, 2] == 0.0
    assert k3.launches == 0  # CPU tensors: the plain version ran
    assert tm.loglik_and_grad_fn(obs, 25.0, backend="kernel", precision=prec,
                                 grad_precision=gprec) is k3


def test_short_hmc_through_sample_posterior(slice_setup):
    _, tm, obs, _ = slice_setup
    res = tm.sample_posterior(obs, 25.0, sampler="hmc", n_walkers=64, n_warmup=20,
                              n_steps=20, seed=3)
    assert res.chain.shape == (4, 64, 7) and res.final.shape == (64, 7)
    assert np.isfinite(res.chain).all() and np.isfinite(res.logp).all()
    assert res.accept_rate.shape == (20,) and res.step_size > 0
    lo, hi = PAR_RANGES.T  # the default prior box
    assert (res.flat >= lo * (1 - 1e-6)).all() and (res.flat <= hi * (1 + 1e-6)).all()
    # NUTS is ported: a short run through the same memoized K3 wrapper
    # (its plain version here); so is the tempered sampler, on K2's
    nuts = tm.sample_posterior(obs, 25.0, sampler="nuts", n_walkers=16, n_warmup=0,
                               n_steps=2, max_depth=2, thin=1, seed=3)
    assert np.isfinite(nuts.logp).all() and 1.0 <= nuts.mean_leapfrog <= 3.0
    pt = tm.sample_posterior(obs, 25.0, sampler="pt", n_rungs=3, n_walkers=16, n_warmup=0,
                             n_steps=4, thin=2, seed=3)
    assert pt.chain.shape == (2, 16, 7) and np.isfinite(pt.logp).all()


@pytest.mark.parametrize("method", ["gram", "direct"])
def test_flagship_value_kernels_match_jax(slice_setup, method):
    """The value-only path of the slice: ``loglik_fn(backend="kernel")``
    (K2 for gram, K1 with its sumsq tail for direct; their plain
    versions on the CPU) against the JAX package's ``loglik_fn`` at the
    default bf16x3 tier, and its gradient against JAX autodiff."""
    from tpu21cmvae.sampling._common import valgrad_from_loglik as jax_valgrad
    from tpu21cmvae_torch.sampling._common import valgrad_from_loglik

    jm, tm, obs, raw = slice_setup
    vj, gj = jax_valgrad(jm.loglik_fn(obs, 25.0, method=method))(jm.params, jnp.asarray(raw))
    kern = tm.loglik_fn(obs, 25.0, backend="kernel", method=method)
    vt, gt = valgrad_from_loglik(kern)(tm.params, torch.as_tensor(raw))
    vj, gj, vt, gt = np.asarray(vj), np.asarray(gj), vt.numpy(), gt.numpy()
    np.testing.assert_allclose(vt, vj, rtol=2e-4, atol=2e-3 * np.abs(vj).max())
    np.testing.assert_allclose(gt, gj, rtol=2e-3, atol=2e-3 * np.abs(gj).max())
    assert gt[4, 2] == 0.0 and kern.launches == 0


@pytest.mark.parametrize("sampler", ["mh", "ensemble"])
def test_short_gradient_free_run_through_sample_posterior(slice_setup, sampler):
    _, tm, obs, _ = slice_setup
    res = tm.sample_posterior(obs, 25.0, sampler=sampler, n_walkers=64, n_warmup=10,
                              n_steps=20, seed=3)
    assert res.chain.shape == (2, 64, 7) and np.isfinite(res.chain).all()
    lo, hi = PAR_RANGES.T
    assert (res.flat >= lo).all() and (res.flat <= hi).all()
    assert np.isfinite(res.logp).all() and 0.0 < float(res.accept_rate.mean()) < 1.0
