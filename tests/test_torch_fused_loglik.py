"""K3, the fused gram value-and-gradient kernel: its plain PyTorch version
against the JAX package's Pallas kernel (interpret mode on the CPU), and
the wrapper's contract. The kernel itself is held to its plain version in
``tests/test_torch_cuda.py``, on a CUDA card.

Tolerances: test_loglik tolerance (``tests/test_loglik.py:468-472``:
values rtol 2e-4, atol 2e-3·max|v|; gradients rtol 2e-3, atol
2e-3·max|g|) between two implementations of one tier; the gradient gate
(``bench_mcmc.py::_grad_gate_violation`` ≤ 0) where the tiers differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu21cmvae.models.direct import DirectEmulator as JaxEmulator
from tpu21cmvae.ops.loglik import make_loglik_and_grad as jax_make_loglik_and_grad
from tpu21cmvae.utils.config import DirectEmulatorConfig as JaxConfig
from tpu21cmvae_torch.models.direct import DirectEmulator
from tpu21cmvae_torch.ops.kernels.fused_loglik import (
    make_fused_loglik_grad_gram,
    shared_bytes,
)
from tpu21cmvae_torch.utils.config import DirectEmulatorConfig
from tpu21cmvae_torch.utils.metrics import grad_gate_violation

SMALL = (32, 48, 32, 24)


@pytest.fixture(scope="module")
def pair(splits):
    jm = JaxEmulator(splits, config=JaxConfig(hidden_dims=SMALL), seed=2)
    tm = DirectEmulator.from_numpy(
        jax.tree_util.tree_map(np.asarray, jm.params),
        jax.tree_util.tree_map(np.asarray, jm.normalizer),
        config=DirectEmulatorConfig(hidden_dims=SMALL), device="cpu",
    )
    sig = jm.predict(splits.par_test[0])
    obs = (sig + np.random.default_rng(5).normal(0, 5.0, sig.shape)).astype(np.float32)
    raw = np.asarray(splits.par_test[:37], np.float32).copy()  # not a tile multiple
    raw[5, 2] = 0.0
    return jm, tm, obs, raw


def _pallas(pair, tiers):
    """JAX's K3 in interpret mode: one grid step (block_rows=40, which
    the default 4-way interleave divides)."""
    jm, _, obs, raw = pair
    fn = jax_make_loglik_and_grad(
        jm.config, jm.normalizer, obs, 25.0, backend="pallas", precision=tiers[0],
        grad_precision=tiers[1], block_rows=40, interpret=True,
    )
    v, g = fn(jm.params, jnp.asarray(raw))
    return np.asarray(v), np.asarray(g)


def _port(pair, tiers):
    _, tm, obs, raw = pair
    fn = make_fused_loglik_grad_gram(tm.config, tm.normalizer, obs, 25.0,
                                     precision=tiers[0], grad_precision=tiers[1],
                                     device="cpu")
    v, g = fn(tm.params, torch.as_tensor(raw))
    return v.numpy(), g.numpy()


@pytest.mark.parametrize("tiers", [("highest", "highest"), ("high", "high")])
def test_plain_k3_matches_pallas_k3(pair, tiers):
    """Same folds, same hi/lo split, same epilogue: the plain version and
    the Pallas kernel agree at test_loglik tolerance, on 37 rows with an
    fx == 0 row whose slot-2 gradient is exactly 0 in both."""
    vj, gj = _pallas(pair, tiers)
    vt, gt = _port(pair, tiers)
    assert vt.shape == (37,) and gt.shape == (37, 7)
    np.testing.assert_allclose(vt, vj, rtol=2e-4, atol=2e-3 * np.abs(vj).max())
    np.testing.assert_allclose(gt, gj, rtol=2e-3, atol=2e-3 * np.abs(gj).max())
    assert gt[5, 2] == 0.0 and gj[5, 2] == 0.0


def test_bf16_backward_passes_the_gradient_gate(pair):
    """At ("high", "default") the Pallas kernel's DEFAULT backward runs in
    full fp32 under XLA on the CPU (checked: a DEFAULT and a HIGH f32 dot
    equal the HIGHEST one bit for bit), while the port's rounds both
    operands to bf16 as a single-pass bf16 tier does. So the port's
    backward is held to that fp32 gradient under the gradient gate, and
    its value to the same value tier at test_loglik tolerance."""
    a = jax.random.normal(jax.random.key(0), (64, 96))
    b = jax.random.normal(jax.random.key(1), (96, 48))
    exact = jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST)
    for p in (jax.lax.Precision.DEFAULT, jax.lax.Precision.HIGH):
        np.testing.assert_array_equal(np.asarray(jnp.dot(a, b, precision=p)), np.asarray(exact))
    vj, gj = _pallas(pair, ("high", "default"))
    vt, gt = _port(pair, ("high", "default"))
    np.testing.assert_allclose(vt, vj, rtol=2e-4, atol=2e-3 * np.abs(vj).max())
    assert grad_gate_violation(gt, gj) <= 0.0
    assert not np.array_equal(gt, gj)  # the bf16 tier really rounds
    assert gt[5, 2] == 0.0


def test_single_row_and_shapes(pair):
    _, tm, obs, raw = pair
    fn = make_fused_loglik_grad_gram(tm.config, tm.normalizer, obs, 25.0, device="cpu")
    v1, g1 = fn(tm.params, torch.as_tensor(raw[1]))
    assert v1.shape == (1,) and g1.shape == (1, 7)
    vb, gb = fn(tm.params, torch.as_tensor(raw[:4]))
    np.testing.assert_allclose(v1.numpy(), vb.numpy()[1:2], rtol=1e-6)
    np.testing.assert_allclose(g1.numpy(), gb.numpy()[1:2], rtol=1e-5, atol=1e-6)
    assert np.isfinite(v1.numpy()).all() and np.isfinite(g1.numpy()).all()
    assert fn.launches == 0  # CPU tensors run the plain version


def test_wrapper_rejects_bad_inputs(pair):
    _, tm, obs, raw = pair
    fn = make_fused_loglik_grad_gram(tm.config, tm.normalizer, obs, 25.0, device="cpu")
    x = torch.as_tensor(raw)
    with pytest.raises(TypeError, match="float32"):
        fn(tm.params, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        fn(tm.params, torch.as_tensor(np.asfortranarray(raw)))
    with pytest.raises(ValueError, match="contiguous"):
        fn(tm.params, torch.cat([x, x], dim=1)[:, ::2])
    with pytest.raises(ValueError):
        fn(tm.params, x[:, :6].contiguous())
    with pytest.raises(ValueError, match="runs on"):
        fn(tm.params, torch.empty((3, 7), device="meta"))
    with pytest.raises(TypeError):
        fn(tm.params, raw)  # a NumPy array, not a tensor
    with pytest.raises(NotImplementedError, match="ReLU"):
        make_fused_loglik_grad_gram(DirectEmulatorConfig(hidden_dims=SMALL, activation="tanh"),
                                    tm.normalizer, obs, device="cpu")
    with pytest.raises(NotImplementedError, match="shared memory"):
        make_fused_loglik_grad_gram(DirectEmulatorConfig(hidden_dims=(1024,) * 3),
                                    tm.normalizer, obs, device="cpu")


def test_operands_cached_until_weights_change(pair):
    _, tm, obs, raw = pair
    fn = make_fused_loglik_grad_gram(tm.config, tm.normalizer, obs, 25.0, device="cpu")
    ops = fn.operands(tm.params)
    assert fn.operands(tm.params) is ops
    assert shared_bytes(ops.widths) == 4 * 16 * (7 + sum(SMALL) + SMALL[-1])
    v0 = fn(tm.params, torch.as_tensor(raw))[0]
    w = tm.params[1]["w"]
    with torch.no_grad():
        w.mul_(1.5)
    try:
        assert fn.operands(tm.params) is not ops
        assert not torch.equal(fn(tm.params, torch.as_tensor(raw))[0], v0)
    finally:
        with torch.no_grad():
            w.div_(1.5)
