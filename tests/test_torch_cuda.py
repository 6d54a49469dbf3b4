"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips where no CUDA device is
present. The module imports neither jax nor the JAX package, so on a
machine with a card and no JAX it runs without ``tests/conftest.py``:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider

Tolerances (the reasons are in ``chip_smoke.py``): the kernel and its
plain version compute the same products and differ only in summation
order, so values agree within 1e-4·(|logL| + c/2) + 1e-2 nats — the gram
form's cancellation scale, at the bf16 tiers' rounding amplification —
and gradients pass the gradient gate of ``bench_mcmc.py``.
"""

import numpy as np
import pytest
import torch

from tpu21cmvae_torch.data.synthetic import synthetic_dataset
from tpu21cmvae_torch.models.direct import DirectEmulator
from tpu21cmvae_torch.ops.kernels.fused_loglik import (
    loglik_grad_gram_reference,
    make_fused_loglik_grad_gram,
)
from tpu21cmvae_torch.utils.config import DirectEmulatorConfig
from tpu21cmvae_torch.utils.metrics import grad_gate_violation

TIER_PAIRS = [("highest", "highest"), ("high", "high"), ("high", "default")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3 has no CPU mode (its plain version runs here)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(hidden, dev):
    data = synthetic_dataset(512, 64, 128, seed=7)
    m = DirectEmulator(data, config=DirectEmulatorConfig(hidden_dims=hidden), seed=4,
                       device=dev)
    obs = m.predict(data.par_test[0]) + np.random.default_rng(5).normal(0, 5.0, 451)
    return m, obs, data


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [(32, 48, 32, 24), (288, 352, 288, 224), (40,)])
@pytest.mark.parametrize("tiers", TIER_PAIRS)
def test_k3_matches_plain(cuda, hidden, tiers):
    m, obs, data = _model(hidden, cuda)
    raw = np.asarray(data.par_test[:100], np.float32).copy()  # 100: a ragged last tile
    raw[7, 2] = 0.0
    x = torch.as_tensor(raw, device=cuda)
    fn = make_fused_loglik_grad_gram(m.config, m.normalizer, obs, 25.0, precision=tiers[0],
                                     grad_precision=tiers[1], device=cuda)
    vk, gk = fn(m.params, x)
    ops = fn.operands(m.params)
    vp, gp = loglik_grad_gram_reference(ops, x)
    torch.cuda.synchronize()
    assert fn.launches == 1
    vk, gk, vp, gp = (t.cpu().numpy() for t in (vk, gk, vp, gp))
    assert vk.shape == (100,) and gk.shape == (100, 7)
    scale = np.abs(vp) + 0.5 * abs(float(ops.c))
    assert (np.abs(vk - vp) <= 1e-4 * scale + 1e-2).all()
    assert grad_gate_violation(gk, gp) <= 0.0
    assert gk[7, 2] == 0.0


@pytest.mark.cuda
def test_k3_single_row_empty_batch_and_refusals(cuda):
    m, obs, data = _model((32, 48, 32, 24), cuda)
    fn = make_fused_loglik_grad_gram(m.config, m.normalizer, obs, 25.0, device=cuda)
    x = torch.as_tensor(np.asarray(data.par_test[:3], np.float32), device=cuda)
    v1, g1 = fn(m.params, x[1])
    vb, gb = fn(m.params, x)
    torch.cuda.synchronize()
    assert v1.shape == (1,) and g1.shape == (1, 7)
    np.testing.assert_allclose(v1.cpu().numpy(), vb.cpu().numpy()[1:2], rtol=1e-6)
    v0, g0 = fn(m.params, x[:0])
    assert v0.shape == (0,) and g0.shape == (0, 7)
    assert fn.launches == 2  # the empty batch launched nothing
    with pytest.raises(TypeError, match="float32"):
        fn(m.params, x.double())
    with pytest.raises(ValueError, match="runs on"):
        fn(m.params, x.cpu())
    assert fn.launches == 2


@pytest.mark.cuda
def test_sample_posterior_runs_k3(cuda):
    m, obs, _ = _model((32, 48, 32, 24), cuda)
    k3 = m.loglik_and_grad_fn(obs, 25.0, backend="kernel", grad_precision="default")
    res = m.sample_posterior(obs, 25.0, n_walkers=256, n_warmup=20, n_steps=20, seed=1)
    assert k3.launches >= 40
    assert np.isfinite(res.chain).all() and res.chain.shape == (4, 256, 7)
