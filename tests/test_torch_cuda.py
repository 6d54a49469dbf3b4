"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips where no CUDA device is
present. The module imports neither jax nor the JAX package, so on a
machine with a card and no JAX it runs without ``tests/conftest.py``:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider

Tolerances (the reasons are in ``chip_smoke.py``): a kernel and its
plain version compute the same products and differ only in summation
order, so values agree within rtol·(|logL| + c/2) + 1e-2 nats — the
folded output layer's cancellation scale — with rtol 1e-5 at the fp32
tier, 1e-4 at bf16x3 and 5e-3 at single-pass bf16 (K3's value tier is
never bf16 here, so its checks keep 1e-4); K1's predictions agree within
1e-5, 1e-4 and 5e-3 of their amplitude; gradients pass the gradient gate
of ``bench_mcmc.py``.
"""

import numpy as np
import pytest
import torch

from tpu21cmvae_torch.data.synthetic import synthetic_dataset, synthetic_params
from tpu21cmvae_torch.foregrounds import linlog_basis
from tpu21cmvae_torch.models.direct import DirectEmulator
from tpu21cmvae_torch.noisescale import marginalize_noise_scale
from tpu21cmvae_torch.ops.kernels import fused_loglik
from tpu21cmvae_torch.ops.kernels._common import F32_TILE_ROWS
from tpu21cmvae_torch.ops.kernels.fused_loglik import (
    loglik_grad_gram_reference,
    loglik_gram_reference,
    make_fused_loglik,
    make_fused_loglik_grad_gram,
    make_fused_loglik_gram,
)
from tpu21cmvae_torch.ops.kernels import fused_mlp
from tpu21cmvae_torch.ops.kernels.fused_mlp import (
    fused_mlp_reference,
    make_fused_emulate,
    make_fused_mlp,
)
from tpu21cmvae_torch.priors import GaussianBoxPrior
from tpu21cmvae_torch.sampling._common import valgrad_from_loglik
from tpu21cmvae_torch.utils.config import DirectEmulatorConfig, TrainConfig
from tpu21cmvae_torch.sampling.gradient import sample_hmc
from tpu21cmvae_torch.utils.metrics import grad_gate_violation, grad_rel_error

TIER_PAIRS = [("highest", "highest"), ("high", "high"), ("high", "default")]
TIERS = ["highest", "high", "default"]
WIDTHS = [(32, 48, 32, 24), (288, 352, 288, 224), (40,)]
VALUE_RTOL = {"highest": 1e-5, "high": 1e-4, "default": 5e-3}
AMPLITUDE_RTOL = {"highest": 1e-5, "high": 1e-4, "default": 5e-3}


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
@pytest.mark.parametrize("hidden", WIDTHS)
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
    # the bf16 pairs run fused_gram_mma.cu, (fp32, fp32) fused_loglik_grad_gram_f32.cu
    on_mma = tiers != ("highest", "highest")
    assert fn.tensor_cores == on_mma and (ops.packed is not None) == on_mma
    assert fn.register_tiled != on_mma and (ops.slabs is not None) != on_mma
    vk, gk, vp, gp = (t.cpu().numpy() for t in (vk, gk, vp, gp))
    assert vk.shape == (100,) and gk.shape == (100, 7)
    scale = np.abs(vp) + 0.5 * abs(float(ops.c))
    assert (np.abs(vk - vp) <= 1e-4 * scale + 1e-2).all()
    assert grad_gate_violation(gk, gp) <= 0.0
    assert gk[7, 2] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("tiers", [("high", "highest"), ("highest", "default")])
def test_k3_mixed_tiers_run_the_cuda_cores(cuda, tiers):
    """A tier pair with one fp32 tier runs ``fused_loglik_grad_gram.cu``,
    its bf16 tier split per product on the CUDA cores."""
    m, obs, data = _model((32, 48, 32, 24), cuda)
    x = _rows(data, 100, cuda)
    fn = make_fused_loglik_grad_gram(m.config, m.normalizer, obs, 25.0, precision=tiers[0],
                                     grad_precision=tiers[1], device=cuda)
    vk, gk = fn(m.params, x)
    ops = fn.operands(m.params)
    vp, gp = loglik_grad_gram_reference(ops, x)
    torch.cuda.synchronize()
    assert fn.launches == 1 and not fn.tensor_cores and ops.packed is None
    assert not fn.register_tiled and ops.slabs is None
    _close_values(vk.cpu().numpy(), vp.cpu().numpy(), float(ops.c), "high")
    assert grad_gate_violation(gk.cpu().numpy(), gp.cpu().numpy()) <= 0.0


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


def _rows(data, n, dev):
    raw = np.asarray(data.par_test[:n], np.float32).copy()  # 100: a ragged last tile
    raw[7 % n, 2] = 0.0
    return torch.as_tensor(raw, device=dev)


def _close_values(got, want, c, tier):
    scale = np.abs(want) + 0.5 * abs(c)
    assert (np.abs(got - want) <= VALUE_RTOL[tier] * scale + 1e-2).all()


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", WIDTHS)
@pytest.mark.parametrize("tier", TIERS)
def test_k2_matches_plain(cuda, hidden, tier):
    m, obs, data = _model(hidden, cuda)
    x = _rows(data, 100, cuda)
    fn = make_fused_loglik_gram(m.config, m.normalizer, obs, 25.0, precision=tier, device=cuda)
    vk = fn(m.params, x)
    ops = fn.operands(m.params)
    vp = loglik_gram_reference(ops, x)
    torch.cuda.synchronize()
    assert fn.launches == 1 and vk.shape == (100,)
    # the bf16 tiers run fused_gram_mma.cu, the fp32 tier fused_loglik_gram.cu
    on_mma = tier != "highest"
    assert fn.tensor_cores == on_mma and (ops.packed is not None) == on_mma
    _close_values(vk.cpu().numpy(), vp.cpu().numpy(), float(ops.c), tier)


def _gram_kernels(m, obs, dev):
    """K3 at (high, high) and (high, default) and K2 at high and default:
    every pair of tiers that runs ``fused_gram_mma.cu``."""
    k3 = [make_fused_loglik_grad_gram(m.config, m.normalizer, obs, 25.0, precision="high",
                                      grad_precision=g, device=dev) for g in ("high", "default")]
    k2 = [make_fused_loglik_gram(m.config, m.normalizer, obs, 25.0, precision=t, device=dev)
          for t in ("high", "default")]
    assert all(fn.tensor_cores for fn in k3 + k2)
    return k3, k2


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", WIDTHS)
@pytest.mark.parametrize("n", [1, 15, 16, 17, 31, 32, 33, 100])
def test_k3_k2_tensor_cores_pad_and_mask(cuda, hidden, n):
    """The tensor-core K3 and K2 (``fused_gram_mma.cu``) at hidden widths
    that need padding (24, 40, 48), a trunk of the skinny layer alone and
    the flagship's, for batches around its 16-row tile, with an fx == 0
    row: values within the tier's tolerance, gradients under the gate."""
    m, obs, data = _model(hidden, cuda)
    x = _rows(data, n, cuda)
    k3, k2 = _gram_kernels(m, obs, cuda)
    for fn in k3:
        vk, gk = fn(m.params, x)
        vp, gp = loglik_grad_gram_reference(fn.operands(m.params), x)
        torch.cuda.synchronize()
        assert fn.launches == 1 and vk.shape == (n,) and gk.shape == (n, 7)
        vk, gk = vk.cpu().numpy(), gk.cpu().numpy()
        assert np.isfinite(vk).all() and np.isfinite(gk).all()
        _close_values(vk, vp.cpu().numpy(), float(fn.operands(m.params).c), "high")
        assert grad_gate_violation(gk, gp.cpu().numpy()) <= 0.0
        assert gk[7 % n, 2] == 0.0
    for fn, tier in zip(k2, ("high", "default")):
        vk = fn(m.params, x)
        vp = loglik_gram_reference(fn.operands(m.params), x)
        torch.cuda.synchronize()
        assert fn.launches == 1 and vk.shape == (n,)
        assert np.isfinite(vk.cpu().numpy()).all()
        _close_values(vk.cpu().numpy(), vp.cpu().numpy(), float(fn.operands(m.params).c), tier)


@pytest.mark.cuda
def test_k3_k2_tensor_cores_single_row_equals_batch_row(cuda):
    """A row's value and gradient do not depend on its place in the tile:
    one row alone equals the same row inside a batch of 100, bit for
    bit, at the flagship widths."""
    m, obs, data = _model((288, 352, 288, 224), cuda)
    x = _rows(data, 100, cuda)
    k3, k2 = _gram_kernels(m, obs, cuda)
    for fn in k3 + k2:
        batch = fn(m.params, x)
        for i in (0, 7, 45, 99):
            one = fn(m.params, x[i])
            for a, b in zip(one if fn in k3 else (one,), batch if fn in k3 else (batch,)):
                np.testing.assert_array_equal(a.cpu().numpy()[0], b.cpu().numpy()[i])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K3", "K2"])
def test_k3_k2_tensor_cores_refused_launch_raises(cuda, monkeypatch, kernel):
    """A launch the C entry point refuses raises with its CUDA error
    string; nothing falls back to the CUDA-core kernel or the plain
    version."""
    m, obs, data = _model((32, 48, 32, 24), cuda)
    k3, k2 = _gram_kernels(m, obs, cuda)
    fn = k3[0] if kernel == "K3" else k2[0]
    x = _rows(data, 5, cuda)
    monkeypatch.setitem(fused_loglik.TIER_CODE, "bf16x3", 0)  # fp32 is not a tensor-core tier
    with pytest.raises(RuntimeError, match=f"{kernel} launch failed: invalid argument"):
        fn(m.params, x)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", WIDTHS)
@pytest.mark.parametrize("tier", TIERS)
def test_k1_matches_plain(cuda, hidden, tier):
    """K1 as predict (reduce none) and as the direct likelihood (sumsq)."""
    m, obs, data = _model(hidden, cuda)
    x = _rows(data, 100, cuda)
    em = make_fused_emulate(m.config, m.normalizer, precision=tier, device=cuda)
    ll = make_fused_loglik(m.config, m.normalizer, obs, 25.0, precision=tier, device=cuda)
    yk, vk = em(m.params, x), ll(m.params, x)
    yp = fused_mlp_reference(em.operands(m.params), x)
    vp = -0.5 * fused_mlp_reference(ll.mlp.operands(m.params), x)
    c = float(make_fused_loglik_gram(m.config, m.normalizer, obs, 25.0,
                                     device=cuda).operands(m.params).c)
    torch.cuda.synchronize()
    assert em.launches == 1 and ll.launches == 1
    yk, yp = yk.cpu().numpy(), yp.cpu().numpy()
    assert yk.shape == (100, 451) and np.isfinite(yk).all()
    assert np.abs(yk - yp).max() <= AMPLITUDE_RTOL[tier] * np.abs(yp).max()
    _close_values(vk.cpu().numpy(), vp.cpu().numpy(), c, tier)


@pytest.mark.cuda
@pytest.mark.parametrize("sizes", [(7, 33), (12, 40, 20), (7, 64, 96, 33)])
@pytest.mark.parametrize("tier", TIERS)
def test_k1_generic_networks_match_plain(cuda, sizes, tier):
    """A single skinny layer that is the output layer, a fan-in 12 first
    layer run as a tier matmul, and two hidden layers; with and without
    sumsq, on 37 rows."""
    gen = torch.Generator().manual_seed(sum(sizes))
    params = tuple({"w": (torch.randn(a, b, generator=gen) / a ** 0.5).to(cuda),
                    "b": (0.1 * torch.randn(b, generator=gen)).to(cuda)}
                   for a, b in zip(sizes[:-1], sizes[1:]))
    x = (torch.rand(37, sizes[0], generator=gen) + 0.05).to(cuda)
    for reduce in ("none", "sumsq"):
        fn = make_fused_mlp(sizes, log_clamp_input=True, precision=tier, reduce=reduce,
                            device=cuda)
        yk = fn(params, x)
        yp = fused_mlp_reference(fn.operands(params), x)
        torch.cuda.synchronize()
        assert fn.launches == 1
        yk, yp = yk.cpu().numpy(), yp.cpu().numpy()
        assert yk.shape == ((37,) if reduce == "sumsq" else (37, sizes[-1]))
        rtol = AMPLITUDE_RTOL[tier] * (2 if reduce == "sumsq" else 1)
        assert np.abs(yk - yp).max() <= rtol * np.abs(yp).max() + 1e-6


def _random_params(sizes, dev):
    gen = torch.Generator().manual_seed(sum(sizes))
    return tuple({"w": (torch.randn(a, b, generator=gen) / a ** 0.5).to(dev),
                  "b": (0.1 * torch.randn(b, generator=gen)).to(dev)}
                 for a, b in zip(sizes[:-1], sizes[1:]))


@pytest.mark.cuda
@pytest.mark.parametrize("sizes", [(7, 33, 40, 20), (12, 40, 33, 451)])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 100])
@pytest.mark.parametrize("tier", ["high", "default"])
def test_k1_tensor_cores_pad_and_mask(cuda, sizes, n, tier):
    """The tensor-core K1 (``fused_mlp_mma.cu``) at widths that need
    padding (hidden 33 and 40, fan-in 12, outputs 20 and 451) and batches
    around its 32-row tile; predict and sumsq."""
    params = _random_params(sizes, cuda)
    gen = torch.Generator().manual_seed(n)
    x = (torch.rand(n, sizes[0], generator=gen) + 0.05)
    x[0, 2] = 0.0  # the fx == 0 clamp
    x = x.to(cuda)
    for reduce in ("none", "sumsq"):
        fn = make_fused_mlp(sizes, log_clamp_input=True, precision=tier, reduce=reduce,
                            device=cuda)
        yk = fn(params, x)
        ops = fn.operands(params)
        yp = fused_mlp_reference(ops, x)
        torch.cuda.synchronize()
        assert ops.packed is not None and fn.launches == 1
        yk, yp = yk.cpu().numpy(), yp.cpu().numpy()
        assert yk.shape == ((n,) if reduce == "sumsq" else (n, sizes[-1]))
        assert np.isfinite(yk).all()
        rtol = AMPLITUDE_RTOL[tier] * (2 if reduce == "sumsq" else 1)
        assert np.abs(yk - yp).max() <= rtol * np.abs(yp).max() + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["high", "default"])
def test_k1_tensor_cores_single_row_equals_batch_row(cuda, tier):
    """A row's result does not depend on its place in the tile: one row
    alone equals the same row inside a batch of 100, bit for bit."""
    m, obs, data = _model((288, 352, 288, 224), cuda)
    x = _rows(data, 100, cuda)
    for fn in (make_fused_emulate(m.config, m.normalizer, precision=tier, device=cuda),
               make_fused_loglik(m.config, m.normalizer, obs, 25.0, precision=tier,
                                 device=cuda)):
        for i in (0, 7, 45, 99):
            one, batch = fn(m.params, x[i]), fn(m.params, x)
            np.testing.assert_array_equal(one.cpu().numpy()[0], batch.cpu().numpy()[i])


@pytest.mark.cuda
def test_k1_tensor_cores_refused_launch_raises(cuda, monkeypatch):
    """A launch the C entry point refuses raises with its CUDA error
    string; nothing falls back to the plain version."""
    sizes = (7, 33, 20)
    fn = make_fused_mlp(sizes, precision="high", device=cuda)
    x = torch.rand(5, 7, device=cuda) + 0.05
    monkeypatch.setitem(fused_mlp.TIER_CODE, "bf16x3", 0)  # fp32 is not a tensor-core tier
    with pytest.raises(RuntimeError, match="K1 launch failed: invalid argument"):
        fn(_random_params(sizes, cuda), x)


@pytest.mark.cuda
def test_k1_k2_single_row_empty_batch_and_refusals(cuda):
    m, obs, data = _model((32, 48, 32, 24), cuda)
    x = _rows(data, 3, cuda)
    for fn in (make_fused_loglik_gram(m.config, m.normalizer, obs, 25.0, device=cuda),
               make_fused_loglik(m.config, m.normalizer, obs, 25.0, device=cuda),
               make_fused_emulate(m.config, m.normalizer, device=cuda)):
        v1, vb = fn(m.params, x[1]), fn(m.params, x)
        torch.cuda.synchronize()
        assert v1.shape[0] == 1
        np.testing.assert_allclose(v1.cpu().numpy(), vb.cpu().numpy()[1:2], rtol=1e-6,
                                   atol=1e-6 * float(vb.abs().max()))
        assert fn(m.params, x[:0]).shape[0] == 0
        assert fn.launches == 2  # the empty batch launched nothing
        with pytest.raises(TypeError, match="float32"):
            fn(m.params, x.double())
        with pytest.raises(ValueError, match="runs on"):
            fn(m.params, x.cpu())
        with pytest.raises(ValueError, match="contiguous"):
            fn(m.params, torch.cat([x, x], dim=1)[:, ::2])
        assert fn.launches == 2


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["gram", "direct"])
def test_kernel_loglik_gradient_equals_plain(cuda, method):
    """``torch.autograd`` through ``loglik_fn(backend="kernel")`` (K2 or
    K1 forward, the plain twin's backward) equals the plain backend's
    gradient, with respect to the rows and the weights."""
    m, obs, data = _model((32, 48, 32, 24), cuda)
    x = _rows(data, 100, cuda)
    kern = m.loglik_fn(obs, 25.0, backend="kernel", method=method)
    plain = m.loglik_fn(obs, 25.0, backend="torch", method=method)
    vk, gk = valgrad_from_loglik(kern)(m.params, x)
    vp, gp = valgrad_from_loglik(plain)(m.params, x)
    assert kern.launches == 1
    assert grad_gate_violation(gk.cpu().numpy(), gp.cpu().numpy()) <= 0.0
    np.testing.assert_allclose(gk.cpu().numpy(), gp.cpu().numpy(), rtol=1e-4,
                               atol=1e-4 * float(gp.abs().max()))
    (wk,) = torch.autograd.grad(kern(m.params, x).sum(), m.params[2]["w"])
    (wp,) = torch.autograd.grad(plain(m.params, x).sum(), m.params[2]["w"])
    np.testing.assert_allclose(wk.cpu().numpy(), wp.cpu().numpy(), rtol=1e-4,
                               atol=1e-4 * float(wp.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["mh", "ensemble"])
def test_sample_posterior_runs_k2(cuda, sampler):
    m, obs, _ = _model((32, 48, 32, 24), cuda)
    k2 = m.loglik_fn(obs, 25.0, backend="kernel")
    k2.launches = 0
    n_warmup, n_steps = 20, 30
    res = m.sample_posterior(obs, 25.0, sampler=sampler, n_walkers=256, n_warmup=n_warmup,
                             n_steps=n_steps, thin=5, seed=1)
    per_step = 1 if sampler == "mh" else 2
    assert k2.launches >= 1 + per_step * (n_warmup + n_steps)
    assert np.isfinite(res.chain).all() and res.chain.shape == (6, 256, 7)


def _f32_kernels(m, obs, dev, rows=None):
    """The register-tiled fp32 kernels at tile height ``rows`` (None: the
    wrapper's choice): K1 as predict and as the direct likelihood
    (``fused_mlp.cu``), K2 (``fused_loglik_gram.cu``), each with its
    plain version."""
    em = make_fused_emulate(m.config, m.normalizer, precision="highest", tile_rows=rows,
                            device=dev)
    ll = make_fused_loglik(m.config, m.normalizer, obs, 25.0, precision="highest",
                           tile_rows=rows, device=dev)
    k2 = make_fused_loglik_gram(m.config, m.normalizer, obs, 25.0, precision="highest",
                                tile_rows=rows, device=dev)
    assert not k2.tensor_cores and ll.mlp.operands(m.params).packed is None
    return {
        "predict": (em, lambda x: fused_mlp_reference(em.operands(m.params), x)),
        "sumsq": (ll, lambda x: -0.5 * fused_mlp_reference(ll.mlp.operands(m.params), x)),
        "k2": (k2, lambda x: loglik_gram_reference(k2.operands(m.params), x)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [(288, 352, 288, 224), (32, 48, 32, 24)])
@pytest.mark.parametrize("rows", F32_TILE_ROWS)
def test_f32_tiles_pad_and_mask(cuda, hidden, rows):
    """K1 (predict, sumsq) and K2 on the register-tiled fp32 kernels at
    every tile height, forced, for batches 1, BM−1, BM, BM+1, 2·BM+1 and
    100 with an fx == 0 row, at the flagship widths and narrow ones:
    within the fp32 tolerances of their plain versions."""
    m, obs, data = _model(hidden, cuda)
    c = float(make_fused_loglik_gram(m.config, m.normalizer, obs, 25.0,
                                     device=cuda).operands(m.params).c)
    kernels = _f32_kernels(m, obs, cuda, rows)
    for n in sorted({1, rows - 1, rows, rows + 1, 2 * rows + 1, 100}):
        x = synthetic_params(n, np.random.default_rng(n)).astype(np.float32)
        x[0, 2] = 0.0  # the fx == 0 clamp
        x = torch.as_tensor(x, device=cuda)
        for key, (fn, plain) in kernels.items():
            fn.launches = 0
            got, want = fn(m.params, x), plain(x)
            torch.cuda.synchronize()
            assert fn.launches == 1
            assert (fn.mlp if key == "sumsq" else fn).tile_rows == rows
            got, want = got.cpu().numpy(), want.cpu().numpy()
            assert got.shape == ((n, 451) if key == "predict" else (n,))
            assert np.isfinite(got).all()
            if key == "predict":
                assert np.abs(got - want).max() <= AMPLITUDE_RTOL["highest"] * np.abs(want).max()
            else:
                _close_values(got, want, c, "highest")


@pytest.mark.cuda
@pytest.mark.parametrize("sizes", [(7, 33), (12, 40, 20), (7, 64, 96, 33), (12, 40, 33, 451),
                                   (12, 300)])
@pytest.mark.parametrize("rows", F32_TILE_ROWS)
def test_f32_generic_networks_match_plain(cuda, sizes, rows):
    """``fused_mlp.cu`` at every tile height on a lone skinny layer, a
    fan-in-12 first layer that is not skinny (alone and before hidden
    layers), and two hidden layers; with and without sumsq, on 2·BM+3
    rows with an fx == 0 row."""
    params = _random_params(sizes, cuda)
    gen = torch.Generator().manual_seed(rows)
    x = torch.rand(2 * rows + 3, sizes[0], generator=gen) + 0.05
    x[1, 2] = 0.0
    x = x.to(cuda)
    for reduce in ("none", "sumsq"):
        fn = make_fused_mlp(sizes, log_clamp_input=True, precision="highest", reduce=reduce,
                            tile_rows=rows, device=cuda)
        yk = fn(params, x)
        yp = fused_mlp_reference(fn.operands(params), x)
        torch.cuda.synchronize()
        assert fn.launches == 1 and fn.tile_rows == rows
        yk, yp = yk.cpu().numpy(), yp.cpu().numpy()
        assert yk.shape == yp.shape and np.isfinite(yk).all()
        rtol = AMPLITUDE_RTOL["highest"] * (2 if reduce == "sumsq" else 1)
        assert np.abs(yk - yp).max() <= rtol * np.abs(yp).max() + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("rows", F32_TILE_ROWS)
def test_f32_single_row_equals_batch_row(cuda, rows):
    """A row's result does not depend on the other rows of its tile:
    one row alone equals the same row inside a batch of 100, bit for
    bit, for K1 (predict, sumsq) and K2 at the flagship widths."""
    m, obs, data = _model((288, 352, 288, 224), cuda)
    x = _rows(data, 100, cuda)
    for fn, _ in _f32_kernels(m, obs, cuda, rows).values():
        batch = fn(m.params, x).cpu().numpy()
        for i in (0, 7, 45, 99):
            np.testing.assert_array_equal(fn(m.params, x[i]).cpu().numpy()[0], batch[i])


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["predict", "sumsq", "k2"])
def test_f32_refused_launch_raises(cuda, key):
    """A tile height the C entry point was not built for is refused
    there and raises with its CUDA error string; nothing falls back to
    the plain version."""
    m, obs, data = _model((32, 48, 32, 24), cuda)
    fn, _ = _f32_kernels(m, obs, cuda)[key]
    (fn.mlp if key == "sumsq" else fn).tile_rows = 48
    name = "K2" if key == "k2" else "K1"
    with pytest.raises(RuntimeError, match=f"{name} launch failed: invalid argument"):
        fn(m.params, _rows(data, 5, cuda))


# the register-tiled fp32 K3: narrow widths, a lone skinny layer, the
# flagship's shape at a quarter of its width, and the flagship
F32_GRAM_WIDTHS = [(32, 48, 32, 24), (40,), (72, 88, 72, 56), (288, 352, 288, 224)]


def _k3_f32(m, obs, dev, rows=None):
    """K3 at (fp32, fp32) on ``fused_loglik_grad_gram_f32.cu`` at tile
    height ``rows`` (None: picked per batch)."""
    fn = make_fused_loglik_grad_gram(m.config, m.normalizer, obs, 25.0, precision="highest",
                                     grad_precision="highest", tile_rows=rows, device=dev)
    assert fn.register_tiled and not fn.tensor_cores
    return fn


def _prior_rows(n, dev):
    x = synthetic_params(n, np.random.default_rng(n)).astype(np.float32)
    x[0, 2] = 0.0  # the fx == 0 clamp
    return torch.as_tensor(x, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", F32_GRAM_WIDTHS)
@pytest.mark.parametrize("rows", F32_TILE_ROWS)
def test_k3_f32_matches_plain(cuda, hidden, rows):
    """The register-tiled K3 at every tile height, forced, for batches 1,
    37, 4096 and 65,537 with an fx == 0 row: values within the fp32
    tolerance of the plain version, q99.9 of the per-row gradient error ≤
    1e-4 and the gradient gate, the fx == 0 slot exactly 0; and its value
    equals the fp32 K2's at the same height bit for bit."""
    m, obs, _ = _model(hidden, cuda)
    fn = _k3_f32(m, obs, cuda, rows)
    k2 = make_fused_loglik_gram(m.config, m.normalizer, obs, 25.0, precision="highest",
                                tile_rows=rows, device=cuda)
    ops = fn.operands(m.params)
    for n in (1, 37, 4096, 65537):
        x = _prior_rows(n, cuda)
        fn.launches = 0
        vk, gk = fn(m.params, x)
        vp, gp = loglik_grad_gram_reference(ops, x)
        v2 = k2(m.params, x)
        torch.cuda.synchronize()
        assert fn.launches == 1 and fn.rows_for(n) == rows
        assert torch.equal(vk, v2)
        vk, gk, vp, gp = (t.cpu().numpy() for t in (vk, gk, vp, gp))
        assert vk.shape == (n,) and gk.shape == (n, 7)
        assert np.isfinite(vk).all() and np.isfinite(gk).all()
        _close_values(vk, vp, float(ops.c), "highest")
        assert np.quantile(grad_rel_error(gk, gp), 0.999) <= 1e-4
        assert grad_gate_violation(gk, gp) <= 0.0
        assert gk[0, 2] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("rows", F32_TILE_ROWS)
def test_k3_f32_single_row_equals_batch_row(cuda, rows):
    """A row's value and gradient do not depend on the other rows of its
    tile: one row alone equals the same row inside a batch of 100, bit
    for bit, at the flagship widths."""
    m, obs, data = _model((288, 352, 288, 224), cuda)
    x = _rows(data, 100, cuda)
    fn = _k3_f32(m, obs, cuda, rows)
    vb, gb = fn(m.params, x)
    for i in (0, 7, 45, 99):
        v1, g1 = fn(m.params, x[i])
        assert torch.equal(v1[0], vb[i]) and torch.equal(g1[0], gb[i])


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", F32_GRAM_WIDTHS)
def test_k3_f32_tile_heights_agree(cuda, hidden):
    """Every tile height gives every other's value and gradient bit for
    bit (one accumulator per output, k ascending, whatever the slab depth
    and ring), and so does the height the wrapper picks per batch; a NaN
    row leaves the other rows of its tile as they were."""
    m, obs, _ = _model(hidden, cuda)
    x = _prior_rows(1000, cuda)
    want = _k3_f32(m, obs, cuda, 64)(m.params, x)
    for rows in (32, 16, 8, None):
        got = _k3_f32(m, obs, cuda, rows)(m.params, x)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    bad = x.clone()
    bad[11, 4] = float("nan")
    keep = torch.arange(1000, device=cuda) != 11
    for rows in F32_TILE_ROWS:
        v, g = _k3_f32(m, obs, cuda, rows)(m.params, bad)
        assert torch.isnan(v[11])
        assert torch.equal(v[keep], want[0][keep]) and torch.equal(g[keep], want[1][keep])


@pytest.mark.cuda
def test_k3_f32_picks_its_height_by_batch(cuda):
    """Without a forced height the wrapper runs the shortest tile that
    still runs the batch as one block per SM of this card, else the
    tallest."""
    m, obs, _ = _model((288, 352, 288, 224), cuda)
    fn = _k3_f32(m, obs, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert fn.sm_count == sms and fn.tile_rows is None
    assert fn.rows_for(64 * sms) == fn.rows_for(64 * sms + 1) == 64
    assert fn.rows_for(32 * sms) == 32 and fn.rows_for(32 * sms + 1) == 64
    assert fn.rows_for(16 * sms) == 16 and fn.rows_for(5) == 8
    for n in (5, 16 * sms, 64 * sms):
        x = _prior_rows(n, cuda)
        vk, gk = fn(m.params, x)
        vp, gp = loglik_grad_gram_reference(fn.operands(m.params), x)
        _close_values(vk.cpu().numpy(), vp.cpu().numpy(), float(fn.operands(m.params).c),
                      "highest")
        assert grad_gate_violation(gk.cpu().numpy(), gp.cpu().numpy()) <= 0.0


@pytest.mark.cuda
def test_k3_f32_refused_launch_raises(cuda):
    """A tile height the C entry point was not built for is refused
    there and raises with its CUDA error string; nothing falls back to
    the 16-row kernel or the plain version."""
    m, obs, data = _model((32, 48, 32, 24), cuda)
    fn = _k3_f32(m, obs, cuda)
    fn.tile_rows = 48
    with pytest.raises(RuntimeError, match="K3 launch failed: invalid argument"):
        fn(m.params, _rows(data, 5, cuda))


@pytest.mark.cuda
def test_k3_f32_wide_layer_runs_the_16_row_kernel(cuda):
    """A network whose widest layer does not fit two full-width 8-row
    buffers, but whose activations fit ``fused_loglik_grad_gram.cu`` at
    their own widths, still runs at (fp32, fp32), on that kernel."""
    m, obs, data = _model((3200, 64, 64), cuda)
    fn = make_fused_loglik_grad_gram(m.config, m.normalizer, obs, 25.0, precision="highest",
                                     grad_precision="highest", device=cuda)
    assert not fn.register_tiled and not fn.tensor_cores
    x = _rows(data, 100, cuda)
    vk, gk = fn(m.params, x)
    ops = fn.operands(m.params)
    vp, gp = loglik_grad_gram_reference(ops, x)
    torch.cuda.synchronize()
    assert fn.launches == 1 and ops.slabs is None
    _close_values(vk.cpu().numpy(), vp.cpu().numpy(), float(ops.c), "highest")
    assert grad_gate_violation(gk.cpu().numpy(), gp.cpu().numpy()) <= 0.0


@pytest.mark.cuda
def test_hmc_at_the_exact_tier_runs_the_f32_k3(cuda):
    """``loglik_and_grad_fn(precision="contract", backend="kernel")`` is
    the register-tiled K3, and ``sample_hmc`` launches it on every
    leapfrog step."""
    m, obs, _ = _model((32, 48, 32, 24), cuda)
    k3 = m.loglik_and_grad_fn(obs, 25.0, backend="kernel", precision="contract")
    assert k3.register_tiled and not k3.tensor_cores
    k3.launches = 0
    res = sample_hmc(k3, m.params, n_walkers=256, n_warmup=20, n_steps=20, seed=1, device=cuda)
    assert k3.launches >= 40
    assert np.isfinite(res.chain).all() and res.chain.shape == (4, 256, 7)


# -- noise models and priors: the same kernels under new operands -------------


def _fg_model(dev):
    """The flagship-width model, its linlog basis and an observation
    carrying a 1.5·10³ mK foreground."""
    m, _, data = _model((288, 352, 288, 224), dev)
    F = linlog_basis(m.frequencies, 5)
    sig = m.predict(data.par_test[0])
    obs = (sig + F @ np.array([1500.0, -120.0, 40.0, -8.0, 2.0])
           + np.random.default_rng(5).normal(0, 5.0, 451)).astype(np.float32)
    return m, F, obs, data


@pytest.mark.cuda
@pytest.mark.parametrize("prior_var", [None, 1e6])
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("n", [1, 37, 4096])
def test_kernels_match_plain_under_marginalized_noise(cuda, prior_var, tier, n):
    """K1 (sumsq), K2 and K3 against their plain versions with a
    foreground-marginalized spec's dense whitening folded into their
    operands: the existing tolerances, the same routes as under diagonal
    noise, one launch each."""
    m, F, obs, _ = _fg_model(cuda)
    mn = m.marginalize_foreground(25.0, basis=F, prior_var=prior_var)
    x = _prior_rows(n, cuda)
    k1 = make_fused_loglik(m.config, m.normalizer, obs, mn, precision=tier, device=cuda)
    k2 = make_fused_loglik_gram(m.config, m.normalizer, obs, mn, precision=tier, device=cuda)
    grad_tier = "highest" if tier == "highest" else "default"
    k3 = make_fused_loglik_grad_gram(m.config, m.normalizer, obs, mn, precision=tier,
                                     grad_precision=grad_tier, device=cuda)
    ops = k2.operands(m.params)
    ops3 = k3.operands(m.params)
    c = float(ops.c)
    with torch.no_grad():
        d = k1(m.params, x)
        dp = -0.5 * fused_mlp_reference(k1.mlp.operands(m.params), x) + mn.log_norm
        v2 = k2(m.params, x)
        v3, g3 = k3(m.params, x)
        p3, gp = loglik_grad_gram_reference(ops3, x)
    torch.cuda.synchronize()
    assert (k1.launches, k2.launches, k3.launches) == (1, 1, 1)
    assert k2.tensor_cores == k3.tensor_cores == (tier != "highest")
    assert k3.register_tiled == (tier == "highest")
    _close_values(d.cpu().numpy(), dp.cpu().numpy(), c, tier)
    _close_values(v2.cpu().numpy(), loglik_gram_reference(ops, x).cpu().numpy(), c, tier)
    _close_values(v3.cpu().numpy(), p3.cpu().numpy(), c, tier)
    assert grad_gate_violation(g3.cpu().numpy(), gp.cpu().numpy()) <= 0.0
    assert np.isfinite(g3.cpu().numpy()).all() and g3[0, 2] == 0.0  # the fx == 0 slot
    # the direct and the gram form agree under the new operands too
    _close_values(v2.cpu().numpy(), d.cpu().numpy(), c, tier)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["proper_over_fg", "jeffreys"])
def test_scale_marginal_wrap_over_the_kernels(cuda, spec):
    """The ScaleMarginalNoise wrap of K2's value and of K3's value and
    gradient equals the same wrap of the plain versions; ``launches``
    reads and sets the kernel wrapper's count through the wrapped object;
    the value stays differentiable through K2 (backward by the plain
    twin)."""
    m, F, obs, data = _fg_model(cuda)
    mn = m.marginalize_foreground(25.0, basis=F)
    sm = (marginalize_noise_scale(mn, alpha=3.0, beta=2.0) if spec == "proper_over_fg"
          else marginalize_noise_scale(25.0))
    x = _rows(data, 100, cuda)
    k2 = m.loglik_fn(obs, sm, backend="kernel", precision="contract")
    k3 = m.loglik_and_grad_fn(obs, sm, backend="kernel", precision="contract")
    assert k2.base.fused.name == "K2" and k3.base.name == "K3"
    k2.launches = k3.launches = 0
    with torch.no_grad():
        v2 = k2(m.params, x)
        p2 = m.loglik_fn(obs, sm, precision="contract")(m.params, x)
    v3, g3 = k3(m.params, x)
    p3, gp = m.loglik_and_grad_fn(obs, sm, precision="contract")(m.params, x)
    torch.cuda.synchronize()
    assert k2.launches == k2.base.fused.launches == 1 and k3.launches == k3.base.launches == 1
    np.testing.assert_allclose(v2.cpu().numpy(), p2.cpu().numpy(), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(v3.cpu().numpy(), p3.cpu().numpy(), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(v2.cpu().numpy(), v3.cpu().numpy(), rtol=1e-5, atol=1e-3)
    assert grad_gate_violation(g3.cpu().numpy(), gp.cpu().numpy()) <= 0.0
    va, ga = valgrad_from_loglik(k2)(m.params, x)
    assert k2.launches == 2
    np.testing.assert_allclose(va.cpu().numpy(), v2.cpu().numpy(), rtol=1e-6)
    assert grad_gate_violation(ga.cpu().numpy(), gp.cpu().numpy()) <= 0.0


@pytest.mark.cuda
def test_scale_marginal_zero_residual_is_finite_on_the_card(cuda):
    """Jeffreys over a noiseless observation scored at its own
    parameters: the floor keeps K2's wrapped value and K3's wrapped value
    and gradient finite."""
    m, _, data = _model((32, 48, 32, 24), cuda)
    obs0 = m.predict(data.par_test[0]).astype(np.float32)
    sm = marginalize_noise_scale(np.full(451, 25.0, np.float32))
    x = torch.as_tensor(np.asarray(data.par_test[:7], np.float32), device=cuda)
    with torch.no_grad():
        ll = m.loglik_fn(obs0, sm, backend="kernel")(m.params, x).cpu().numpy()
    v, g = m.loglik_and_grad_fn(obs0, sm, backend="kernel")(m.params, x)
    assert np.isfinite(ll).all() and ll[0] >= ll[1:].max()
    assert np.isfinite(v.cpu().numpy()).all() and np.isfinite(g.cpu().numpy()).all()


@pytest.mark.cuda
def test_two_noise_specs_give_two_wrappers(cuda):
    """The memo keys a kernel wrapper by the noise spec's value: two specs
    fold two operand sets and count their launches apart; a spec on the
    CPU model's device cannot reach a CUDA wrapper's rows."""
    m, F, obs, data = _fg_model(cuda)
    mn = m.marginalize_foreground(25.0, basis=F)
    mn_p = m.marginalize_foreground(25.0, basis=F, prior_var=1e6)
    x = _rows(data, 64, cuda)
    fns = [m.loglik_fn(obs, nv, backend="kernel") for nv in (25.0, mn, mn_p)]
    assert len({id(fn) for fn in fns}) == 3
    assert m.loglik_fn(obs, m.marginalize_foreground(25.0, basis=F), backend="kernel") is fns[1]
    with torch.no_grad():
        fns[1](m.params, x)
    assert [fn.launches for fn in fns] == [0, 1, 0]
    cs = [float(fn.fused.operands(m.params).c) for fn in fns]
    assert cs[1] < cs[2] < cs[0]  # the projection takes the foreground out of b̃
    with pytest.raises(ValueError, match="runs on"):
        fns[1](m.params, x.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["hmc", "mh", "ensemble"])
def test_samplers_with_prior_and_marginalized_spec_launch_the_kernels(cuda, sampler):
    """A short chain under the foreground- and noise-level-marginalized
    spec with a Gaussian prior on tau launches K3 (HMC) or K2 (MH, the
    ensemble) exactly as often as under the diagonal spec at the same
    seed, and the prior narrows tau."""
    m, F, obs, data = _fg_model(cuda)
    truth = np.asarray(data.par_test[0], np.float64)
    spec = marginalize_noise_scale(m.marginalize_foreground(25.0, basis=F), alpha=3.0, beta=2.0)
    prior = GaussianBoxPrior.for_params({3: (float(truth[3]), 0.002)})
    kw = dict(sampler=sampler, n_walkers=256, n_warmup=20, n_steps=20, seed=1)

    def wrapper(nv):
        if sampler == "hmc":
            return m.loglik_and_grad_fn(obs, nv, backend="kernel", grad_precision="default")
        return m.loglik_fn(obs, nv, backend="kernel")

    counts = {}
    for name, nv, extra in (("diag", 25.0, {}), ("marg", spec, {}),
                            ("prior", spec, dict(log_prior=prior.log_prior))):
        fn = wrapper(nv)
        fn.launches = 0
        res = m.sample_posterior(obs, nv, **kw, **extra)
        counts[name] = fn.launches
        assert np.isfinite(res.chain).all() and np.isfinite(res.logp).all()
        if name == "prior":
            tau_sd = res.final[:, 3].std()
        if name == "marg":
            free_sd = res.final[:, 3].std()
    per_step = {"hmc": 4, "mh": 1, "ensemble": 2}[sampler]  # HMC: at least ⌈8/2⌉ leapfrogs
    assert counts["diag"] >= 1 + 40 * per_step
    assert counts["marg"] == counts["prior"] == counts["diag"]
    assert tau_sd < free_sd


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["chees", "nuts"])
def test_adaptive_samplers_launch_the_memoized_k3(cuda, sampler):
    """ChEES and NUTS through ``sample_posterior`` on a CUDA model run the
    memoized K3 wrapper HMC uses (tensor cores at (high, default)): at
    least one launch per iteration and the initial one, at most the cap
    of leapfrogs per iteration, finite walkers."""
    m, obs, data = _model((288, 352, 288, 224), cuda)
    k3 = m.loglik_and_grad_fn(obs, 25.0, backend="kernel", grad_precision="default")
    cap = {"chees": dict(max_leapfrog=16), "nuts": dict(max_depth=4)}[sampler]
    per_iter = 16 if sampler == "chees" else 2**4 - 1
    k3.launches = 0
    res = m.sample_posterior(obs, 25.0, sampler=sampler, n_walkers=512, n_warmup=30,
                             n_steps=20, thin=5, seed=2, **cap)
    assert m.loglik_and_grad_fn(obs, 25.0, backend="kernel", grad_precision="default") is k3
    assert k3.tensor_cores
    assert 1 + 50 <= k3.launches <= 1 + 50 * per_iter
    assert np.isfinite(res.chain).all() and np.isfinite(res.logp).all()


@pytest.mark.cuda
def test_fits_launch_k3_once_per_step(cuda):
    """``fit_params`` and ``profile_likelihood`` make ``n_steps + 1`` K3
    launches through the memoized wrapper, whatever the number of starts,
    and return finite results."""
    m, obs, data = _model((288, 352, 288, 224), cuda)
    k3 = m.loglik_and_grad_fn(obs, 25.0, backend="kernel", grad_precision="default")
    k3.launches = 0
    fit = m.fit_params(obs, 25.0, n_starts=256, n_steps=40, seed=1)
    assert k3.launches == 41 and np.isfinite(fit.best_logp)
    k3.launches = 0
    prof = m.profile_likelihood(obs, 25.0, 3, np.linspace(0.045, 0.085, 4), n_starts=32,
                                n_steps=40)
    assert k3.launches == 41 and np.isfinite(prof.logl).all()


@pytest.mark.cuda
def test_target_ess_launches_k2_per_chunk(cuda):
    """``sample_posterior(sampler="mh", target_ess=…)`` runs MH chunks
    through the memoized K2 wrapper: 1 + warmup + steps launches for the
    first chunk and 1 + steps for each continuation."""
    m, obs, data = _model((288, 352, 288, 224), cuda)
    k2 = m.loglik_fn(obs, 25.0, backend="kernel")
    k2.launches = 0
    res = m.sample_posterior(obs, 25.0, sampler="mh", target_ess=1e9, n_walkers=256,
                             n_warmup=20, n_steps=40, thin=10, max_chunks=3, seed=0)
    assert m.loglik_fn(obs, 25.0, backend="kernel") is k2 and k2.fused.tensor_cores
    assert res.chain.shape == (12, 256, 7) and np.isfinite(res.chain).all()
    assert k2.launches == (1 + 20 + 40) + 2 * (1 + 40)


def _evidence_model(dev):
    """A small CUDA model (the tiers' routes as at the flagship widths)
    and an observation with its kernel wrappers' launch counts zeroed:
    K2 at bf16x3 (nested, SMC, PT, the ladder), K2 and K3 at fp32
    (Laplace's IS rounds and ascent), K3 at (high, default) (the ladder's
    warm-start fit)."""
    m, obs, data = _model((32, 48, 32, 24), dev)
    wrappers = {
        "k2": m.loglik_fn(obs, 25.0, backend="kernel"),
        "k2_f32": m.loglik_fn(obs, 25.0, backend="kernel", precision="contract"),
        "k3_f32": m.loglik_and_grad_fn(obs, 25.0, backend="kernel", precision="contract"),
        "k3": m.loglik_and_grad_fn(obs, 25.0, backend="kernel", grad_precision="default"),
    }
    assert wrappers["k2"].fused.tensor_cores and not wrappers["k2_f32"].fused.tensor_cores
    assert wrappers["k3_f32"].register_tiled and wrappers["k3"].tensor_cores
    for w in wrappers.values():
        w.launches = 0
    return m, obs, data, wrappers


@pytest.mark.cuda
def test_nested_launches_k2_and_holds_to_plain(cuda):
    """``log_evidence(method="nested")`` runs K2 at bf16x3 once for the
    live set and once per constrained step, and nothing else; the final
    live points' logL (the kernel's) hold to the plain bf16x3 likelihood."""
    m, obs, data, w = _evidence_model(cuda)
    res = m.log_evidence(obs, 25.0, n_live=256, n_mh=8, seed=0)
    n_iters = res.n_iters // (256 // 8)
    assert w["k2"].launches == 1 + 8 * n_iters
    assert w["k2_f32"].launches == w["k3_f32"].launches == w["k3"].launches == 0
    assert np.isfinite(res.logz) and not res.truncated
    live = torch.as_tensor(res.samples[-256:], device=cuda)
    with torch.no_grad():
        want = m.loglik_fn(obs, 25.0)(m.params, live).cpu().numpy()
    _close_values(res.logl[-256:], want, float(w["k2"].fused.operands(m.params).c), "high")


@pytest.mark.cuda
def test_laplace_launches_the_fp32_kernels(cuda):
    """``log_evidence(method="laplace")``: ``n_steps + 1`` launches of the
    fp32 K3 (the ascent), one fp32 K2 launch per IS round, no bf16 kernel;
    both kernels' values at the mode hold to the plain exact tier."""
    m, obs, data, w = _evidence_model(cuda)
    res = m.log_evidence(obs, 25.0, method="laplace", n_starts=512, n_steps=150, n_is=2048,
                         n_rounds=3, seed=0)
    assert w["k3_f32"].launches == 151 and w["k2_f32"].launches == 3
    assert w["k2"].launches == w["k3"].launches == 0
    assert res.pd and np.isfinite(res.logz) and np.isfinite(res.logz_err)
    x = torch.as_tensor(res.map_params[None], device=cuda)
    with torch.no_grad():
        want = m.loglik_fn(obs, 25.0, precision="contract")(m.params, x).cpu().numpy()
        k2 = w["k2_f32"](m.params, x).cpu().numpy()
    k3, _ = w["k3_f32"](m.params, x)
    c = float(w["k2_f32"].fused.operands(m.params).c)
    _close_values(k2, want, c, "highest")
    _close_values(k3.cpu().numpy(), want, c, "highest")


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["smc", "ladder", "pt"])
def test_tempered_paths_launch_k2(cuda, path):
    """SMC and the ladder through ``log_evidence``, PT through
    ``sample_posterior``, score every batch on the memoized K2 wrapper
    (the ladder and PT one launch for the start and two per step; the
    ladder's warm start 501 K3 launches at (high, default))."""
    m, obs, data, w = _evidence_model(cuda)
    if path == "smc":
        res = m.log_evidence(obs, 25.0, method="smc", n_particles=512, seed=0)
        assert w["k2"].launches >= 1 + 3 * 8 * res.n_stages
        assert np.isfinite(res.logz) and np.isfinite(res.final).all()
    elif path == "ladder":
        res = m.log_evidence(obs, 25.0, method="ladder", n_rungs=8, n_walkers=64,
                             n_steps=30, n_warmup=20, seed=0)
        assert w["k3"].launches == 501
        assert w["k2"].launches == 1 + 2 * 50
        assert np.isfinite(res.logz) and np.isfinite(res.posterior).all()
    else:
        res = m.sample_posterior(obs, 25.0, sampler="pt", n_rungs=8, n_walkers=64,
                                 n_steps=30, n_warmup=20, thin=10, seed=0)
        assert w["k2"].launches == 1 + 2 * 50
        assert np.isfinite(res.chain).all() and np.isfinite(res.swap_rate).all()
    assert w["k2_f32"].launches == w["k3_f32"].launches == 0


@pytest.mark.cuda
def test_flow_step_on_k3_matches_plain(cuda):
    """One ``fit_flow`` step at the flagship widths on the same flow and
    draws through K3 at (high, default) and through the plain route at
    the same tiers: the draws' y-gradients pass the gradient gate, the
    ELBO agrees within the bf16x3 value tolerance (per draw, summed), and
    so do the ELBO's parameter gradients (Adam's first moments, one
    row) under the gate; K3 launches once."""
    from tpu21cmvae_torch.flows import RealNVP, flow_step, init_flow
    from tpu21cmvae_torch.sampling._common import _resolve_bounds
    from tpu21cmvae_torch.sampling.fit import Adam
    from tpu21cmvae_torch.sampling.gradient import _whitened_vi_target

    m, obs, data = _model((288, 352, 288, 224), cuda)
    k3 = m.loglik_and_grad_fn(obs, 25.0, backend="kernel", grad_precision="default")
    plain = m.loglik_and_grad_fn(obs, 25.0, grad_precision="default")
    assert k3.tensor_cores
    lo, hi = _resolve_bounds(None, cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    theta = init_flow(gen, 7)
    z = torch.randn((256, 7), generator=gen, device=cuda)
    out = {}
    for name, fn in (("kernel", k3), ("plain", plain)):
        flow = RealNVP(theta, device=cuda)
        integrand = _whitened_vi_target(fn, lo, hi - lo, None, span_jac=False)
        with torch.no_grad():
            y, _ = flow(z)
            f, g = integrand(m.params, y)
        adam = Adam(flow.parameters())
        k3.launches = 0
        elbo = flow_step(flow, integrand, m.params, adam, 1, z, n_steps=1500,
                         learning_rate=3e-3)
        out[name] = (f.cpu().numpy(), g.cpu().numpy(), float(elbo), adam.m.cpu().numpy(),
                     k3.launches)
    fk, gk, ek, mk, nk = out["kernel"]
    fp, gp, ep, mp, npl = out["plain"]
    assert nk == 1 and npl == 0
    assert grad_gate_violation(gk, gp) <= 0.0
    c = float(k3.operands(m.params).c)
    _close_values(fk, fp, c, "high")
    assert abs(ek - ep) <= VALUE_RTOL["high"] * (np.abs(fp).mean() + 0.5 * abs(c)) + 1e-2
    assert grad_gate_violation(mk[None], mp[None]) <= 0.0


@pytest.mark.cuda
def test_variational_fits_launch_k3_once_per_step(cuda):
    """``fit_advi`` makes ``n_steps`` launches of the memoized K3 at (high,
    default), ``fit_flow`` ``warm_steps + n_steps``, and
    ``log_evidence(method="flow")`` those and one fp32 K2 launch (the
    importance sweep), nothing else; results finite and in the box."""
    m, obs, data, w = _evidence_model(cuda)
    advi = m.fit_advi(obs, 25.0, n_steps=60, n_mc=128, seed=0)
    assert w["k3"].launches == 60
    assert np.isfinite(advi.mu).all() and np.isfinite(advi.elbo).all()
    w["k3"].launches = 0
    flow = m.fit_flow(obs, 25.0, n_steps=40, warm_steps=30, n_mc=64, seed=0)
    assert w["k3"].launches == 70 and np.isfinite(flow.elbo).all()
    w["k3"].launches = 0
    ev = m.log_evidence(obs, 25.0, method="flow", n_steps=40, warm_steps=30, n_mc=64,
                        n_is=2048, seed=0)
    assert w["k3"].launches == 70 and w["k2_f32"].launches == 1
    assert w["k2"].launches == w["k3_f32"].launches == 0
    assert np.isfinite(ev.logz) and np.isfinite(ev.khat) and ev._x.shape == (2048, 7)
    from tpu21cmvae_torch.data.synthetic import PAR_RANGES

    box = np.asarray(PAR_RANGES, np.float32)
    assert (ev._x >= box[:, 0]).all() and (ev._x <= box[:, 1]).all()


@pytest.mark.cuda
def test_log_evidence_batch_runs_every_stage_on_the_card(cuda):
    """``log_evidence_batch`` on two observations with every row forced
    through the flow and the nested final: the stacked paths stay plain
    PyTorch on the card (no wrapper of the model's launches), and every
    row ends finite with its estimator named."""
    m, obs, data, w = _evidence_model(cuda)
    obs2 = np.stack([obs, m.predict(data.par_test[1])])
    res = m.log_evidence_batch(obs2, 25.0, method="flow", khat_threshold=-np.inf,
                               final="nested", n_starts=64, n_steps=50, n_is=1024,
                               flow_kwargs=dict(n_steps=30, warm_steps=20, n_mc=64,
                                                n_is=1024),
                               final_kwargs=dict(n_live=128, n_mh=8))
    assert len(res) == 2
    for r in res:
        assert r.escalation is not None and r.final_result is not None
        assert r.method_used == "nested" and np.isfinite(r.logz)
    assert all(x.launches == 0 for x in w.values())


@pytest.mark.cuda
def test_one_training_epoch_on_the_card_equals_the_cpu(cuda):
    """One epoch of the published recipe (8 batches of 64) from the same
    initial weights and the same shuffle, on the card and on the CPU: the
    losses within 2e-6 and the weights within 1e-5 relative (1e-6
    absolute), the CPU parity tests' bounds against JAX (cuBLAS and the
    CPU's BLAS sum in other orders)."""
    splits = synthetic_dataset(512, 128, 128, seed=7)
    runs = []
    for dev in ("cpu", cuda):
        m = DirectEmulator(splits, config=DirectEmulatorConfig(hidden_dims=WIDTHS[0]), seed=0,
                           device=dev)
        loss, val = m.train(train_config=TrainConfig(epochs=1, batch_size=64))
        runs.append((loss + val, [t.detach().cpu().numpy() for layer in m.params
                                  for t in layer.values()]))
    (cpu_losses, cpu_w), (card_losses, card_w) = runs
    np.testing.assert_allclose(card_losses, cpu_losses, rtol=2e-6)
    for a, b in zip(card_w, cpu_w):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


# -- the deep ensemble's mixture: one kernel wrapper per member -------------


def _shipped_ensemble(dev):
    import os

    from tpu21cmvae_torch.models.ensemble import DeepEnsemble

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ens = DeepEnsemble.load(os.path.join(root, "pretrained", "ensemble_direct"), device=dev)
    obs = ens.predict(synthetic_params(1, np.random.default_rng(9))[0])
    return ens, obs + np.random.default_rng(10).normal(0, 5.0, 451)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["k1", "k2", "k3"])
def test_ensemble_mixture_kernels_match_plain(cuda, kernel):
    """The shipped three-member ensemble's mixture with ``backend="kernel"``
    (K1 at the contract tier, K2 at bf16x3, K3 at (high, default), one
    wrapper per member) against the same mixture over the plain versions,
    at 4096 and 8192 rows: values within the member bound (the mixture's
    logsumexp is 1-Lipschitz in the max norm), K3's gradient under the
    gate. Ten calls launch 3 × 10 kernels and fold each member's operands
    once."""
    from tpu21cmvae_torch.ops.fold import gram_fold, noise_scale, obs_tensor

    ens, obs = _shipped_ensemble(cuda)
    kw = {"k1": dict(method="direct", precision="contract"), "k2": {},
          "k3": dict(grad_precision="default")}[kernel]
    build = ens.loglik_and_grad_fn if kernel == "k3" else ens.loglik_fn
    fn, plain = build(obs, 25.0, backend="kernel", **kw), build(obs, 25.0, **kw)
    tier = "highest" if kernel == "k1" else "high"
    scale = noise_scale(25.0, 451, device=cuda)
    half_c = max(0.5 * abs(float(gram_fold(p, ens.normalizer, obs_tensor(obs, 451, device=cuda),
                                           scale)[3]))
                 for p in ens.member_params(ens.params))
    fn.launches = 0
    for n in (4096, 8192):
        x = _rows_prior(n, cuda)
        for _ in range(5):
            with torch.no_grad():
                got = fn(ens.params, x)
        with torch.no_grad():
            want = plain(ens.params, x)
        got, want = ((t,) if kernel != "k3" else t for t in (got, want))
        g, w = got[0].cpu().numpy(), want[0].cpu().numpy()
        assert np.isfinite(g).all()
        assert (np.abs(g - w) <= VALUE_RTOL[tier] * (np.abs(w) + half_c) + 1e-2).all()
        if kernel == "k3":
            assert grad_gate_violation(got[1].cpu().numpy(), want[1].cpu().numpy()) <= 0.0
    assert fn.launches == 3 * 10 and fn.folds == [1, 1, 1]


def _rows_prior(n, dev):
    x = synthetic_params(n, np.random.default_rng(n)).astype(np.float32)
    x[0, 2] = 0.0
    return torch.as_tensor(x, device=dev)


@pytest.mark.cuda
def test_vae_stage_a_on_the_card_equals_the_cpu(cuda):
    """One epoch of the VAE's stochastic stage A (8 batches of 64) from the
    same weights, shuffles and seam normals on the card and on the CPU:
    the losses within 2e-6 relative, the weights within 1e-5 relative
    (1e-6 absolute), the bounds of the direct net's check above."""
    from tpu21cmvae_torch.models.vae import VAEEmulator
    from tpu21cmvae_torch.utils.config import VAEConfig

    splits = synthetic_dataset(512, 128, 128, seed=7)
    cfg = VAEConfig(latent_dim=4, enc_hidden_dims=(24,), dec_hidden_dims=(16, 24),
                    em_hidden_dims=(16,), beta=1e-3, kl_anneal_epochs=2)
    tc = TrainConfig(epochs=1, batch_size=64)
    runs = []
    for dev in ("cpu", cuda):
        m = VAEEmulator(splits, config=cfg, seed=0, device=dev)
        losses = m.train(vae_train_config=tc, em_train_config=tc)
        runs.append((sum(losses, []), [t.detach().cpu().numpy() for t in
                                       torch.utils._pytree.tree_leaves(m.params)]))
    (cpu_losses, cpu_w), (card_losses, card_w) = runs
    np.testing.assert_allclose(card_losses, cpu_losses, rtol=2e-6)
    for a, b in zip(card_w, cpu_w):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


# -- the HTTP service on the card: the kernels behind every endpoint --------


def _flagship_service(dev):
    from tpu21cmvae_torch.serve import EmulatorService

    data = synthetic_dataset(512, 64, 128, seed=7)
    m = DirectEmulator(data, config=DirectEmulatorConfig(hidden_dims=WIDTHS[1]), seed=4,
                       device=dev)
    obs = m.predict(data.par_test[0]) + np.random.default_rng(5).normal(0, 5.0, 451)
    return EmulatorService(m), m, obs, data


@pytest.mark.cuda
def test_service_predict_runs_the_fp32_k1(cuda):
    """``/predict`` on a CUDA model launches the fp32 K1 once per request
    (one bucket, one device), held to plain within 1e-5 of amplitude."""
    svc, m, _, data = _flagship_service(cuda)
    (k1,) = svc._sharded.fns
    assert k1.tier == "f32" and svc.backend == "kernel"
    rows = np.tile(np.asarray(data.par_test, np.float32), (8, 1))
    for n in (1, 37, 1000):
        k1.launches = 0
        got = svc.predict(rows[:n])
        assert k1.launches == 1
        with torch.no_grad():
            want = m.predict_fn()(m.params, torch.as_tensor(rows[:n], device=cuda)).cpu().numpy()
        assert np.abs(got - want).max() <= AMPLITUDE_RTOL["highest"] * np.abs(want).max()


@pytest.mark.cuda
def test_service_loglik_and_fit_run_k2_and_k3(cuda):
    """``/loglik`` launches K2 at bf16x3 and ``/fit`` K3 at the same value
    tier (its ``valgrad`` route), each held to plain; a repeated request
    on the same observation reuses the wrapper, whose launches keep
    counting and whose operands fold once."""
    svc, m, obs, data = _flagship_service(cuda)
    rows = np.asarray(data.par_test[:100], np.float32)
    got = svc.loglik(rows, obs, 25.0)
    (sharded, fn), = svc._loglik.values()
    k2, k3 = fn.value.fused, fn.valgrad
    assert k2.launches == 1 and k2.tensor_cores and k2.tier == "bf16x3"
    assert k3.tensor_cores and (k3.tier, k3.grad_tier) == ("bf16x3", "bf16x3")
    with torch.no_grad():
        want = m.loglik_fn(obs, 25.0)(m.params, torch.as_tensor(rows, device=cuda)).cpu().numpy()
    half_c = 0.5 * float(k2.operands(m.params).c)
    assert (np.abs(got - want) <= VALUE_RTOL["high"] * (np.abs(want) + half_c) + 1e-2).all()
    svc.loglik(rows, obs, 25.0)
    assert k2.launches == 2 and k2.operands.folds == 1
    fit = svc.fit(obs, 25.0, n_starts=256, n_steps=50, seed=0)
    assert k3.launches == 51 and k3.operands.folds == 1
    assert np.isfinite(fit["best_logp"])
    best = torch.as_tensor(np.asarray([fit["best"]], np.float32), device=cuda)
    with torch.no_grad():
        v, _ = k3(m.params, best)
        ref = m.loglik_fn(obs, 25.0)(m.params, best)
    assert abs(float(v) - float(ref)) <= VALUE_RTOL["high"] * (abs(float(ref)) + half_c) + 1e-2
    svc.sample(obs, 25.0, n_walkers=256, n_steps=10, n_warmup=10, thin=5)
    assert k2.launches == 2 + 21 and k2.operands.folds == 1


@pytest.mark.cuda
def test_service_buckets_leave_the_real_rows_unchanged(cuda):
    """A ragged request pads to its bucket, which can change the batch
    (and tile) height the kernel sees; its real rows come out as the
    same rows sent to the wrapper unpadded."""
    svc, m, obs, data = _flagship_service(cuda)
    rows = np.tile(np.asarray(data.par_test, np.float32), (8, 1))
    svc.loglik(rows[:1], obs, 25.0)
    ((_, fn),) = svc._loglik.values()
    (k1,) = svc._sharded.fns
    for n in (1, 37, 1000):
        x = torch.as_tensor(rows[:n], device=cuda)
        with torch.no_grad():
            want_ll = fn(m.params, x).cpu().numpy()
            want_sig = k1(m.params, x).cpu().numpy()
        np.testing.assert_allclose(svc.loglik(rows[:n], obs, 25.0), want_ll, rtol=1e-6,
                                   atol=1e-3)
        np.testing.assert_allclose(svc.predict(rows[:n]), want_sig, rtol=1e-6, atol=1e-5)
