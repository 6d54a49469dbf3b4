"""The ported slice end to end on the CPU, on the shipped flagship
checkpoint: load, predict, likelihood, the K3 value-and-gradient wrapper
(its plain version here) against the JAX package's analytic XLA twin of
K3 (``tests/test_loglik.py:445-473``), and a short HMC run through
``sample_posterior``.

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
    with pytest.raises(NotImplementedError, match="queue 6"):
        tm.sample_posterior(obs, 25.0, sampler="mh")
