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
bf16 only at the reverse pair (default, highest); elsewhere its checks
keep 1e-4); K1's predictions agree within
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
from tpu21cmvae_torch.ops.kernels._common import member_of
from tpu21cmvae_torch.utils.metrics import (
    grad_gate_beside,
    grad_gate_violation,
    grad_rel_error,
)

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
@pytest.mark.parametrize("tiers", [("high", "highest"), ("default", "highest")])
def test_k3_mixed_tiers_run_the_cuda_cores(cuda, tiers):
    """A reverse tier pair (a bf16 value tier, an fp32 backward) runs
    ``fused_gram_mma.cu``'s tensor-core forward and its fp32 backward on
    the CUDA cores (``.reverse``), held to the plain version."""
    m, obs, data = _model((32, 48, 32, 24), cuda)
    x = _rows(data, 100, cuda)
    fn = make_fused_loglik_grad_gram(m.config, m.normalizer, obs, 25.0, precision=tiers[0],
                                     grad_precision=tiers[1], device=cuda)
    vk, gk = fn(m.params, x)
    ops = fn.operands(m.params)
    vp, gp = loglik_grad_gram_reference(ops, x)
    torch.cuda.synchronize()
    assert fn.launches == 1 and fn.reverse and not fn.tensor_cores
    assert ops.packed is not None and ops.packed.wt == () and ops.slabs is not None
    assert not fn.register_tiled and not fn.mixed
    assert fn.rows_for(100) is None
    _close_values(vk.cpu().numpy(), vp.cpu().numpy(), float(ops.c), tiers[0])
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
    another kernel or the plain version."""
    m, obs, data = _model((32, 48, 32, 24), cuda)
    fn = _k3_f32(m, obs, cuda)
    fn.tile_rows = 48
    with pytest.raises(RuntimeError, match="K3 launch failed: invalid argument"):
        fn(m.params, _rows(data, 5, cuda))


# K3 on a network too wide for the kernels above: fused_loglik_grad_gram.cu,
# at (fp32, fp32) and at both reverse pairs
WIDE_PAIRS = [("highest", "highest"), ("high", "highest"), ("default", "highest")]
WIDE_HIDDEN = (3200, 64, 64)


def _k3_wide(m, obs, tiers, dev, members=None):
    """K3 at ``tiers`` on the wide route, its height picked per batch."""
    fn = make_fused_loglik_grad_gram(m.config, m.normalizer, obs, 25.0, precision=tiers[0],
                                     grad_precision=tiers[1], members=members, device=dev)
    assert fn.wide and not (fn.reverse or fn.register_tiled or fn.tensor_cores or fn.mixed)
    return fn


@pytest.mark.cuda
@pytest.mark.parametrize("tiers", WIDE_PAIRS)
def test_k3_wide_matches_plain(cuda, tiers):
    """The wide route on hidden (3200, 64, 64) at batches 1, 37, 100, 4096
    and 65,537 with an fx == 0 row, at every height it is built for (the
    wrapper's own pick through the wrapper, the others launched
    directly): values within the value tier's tolerance of the plain
    version, gradients under the gate, the fx == 0 slot exactly 0, one
    launch per wrapper call, and every height bit for bit the others (no
    sum depends on the tile height)."""
    m, obs, _ = _model(WIDE_HIDDEN, cuda)
    fn = _k3_wide(m, obs, tiers, cuda)
    ops = fn.operands(m.params)
    assert ops.program is not None and (ops.frags is not None) == (tiers[0] != "highest")
    for n in (1, 37, 100, 4096, 65537):
        x = _prior_rows(n, cuda)
        vp, gp = loglik_grad_gram_reference(ops, x)
        vp, gp = vp.cpu().numpy(), gp.cpu().numpy()
        first = None
        for rows in fn.heights:
            fn.launches = 0
            if rows == fn.rows_for(n):
                vk, gk = fn(m.params, x)
                assert fn.launches == 1
            else:
                vk, gk = fused_loglik._loglik_grad_gram_cuda(ops, x, rows)
            torch.cuda.synchronize()
            first = first or (vk, gk)
            assert torch.equal(vk, first[0]) and torch.equal(gk, first[1]), (n, rows)
            vk, gk = vk.cpu().numpy(), gk.cpu().numpy()
            assert vk.shape == (n,) and gk.shape == (n, 7)
            assert np.isfinite(vk).all() and np.isfinite(gk).all()
            _close_values(vk, vp, float(ops.c), tiers[0])
            assert grad_gate_violation(gk, gp) <= 0.0, (n, rows)
            assert gk[0, 2] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [(3623, 1), (100, 3300, 64), (1700, 1700, 8), (1500,)])
@pytest.mark.parametrize("tiers", WIDE_PAIRS)
def test_k3_wide_networks_match_plain(cuda, hidden, tiers):
    """Every shape of the wide plan: a 3623-wide skinny layer into one
    column, a streamed middle layer (100, 3300, 64), two adjacent wide
    layers (1700, 1700, 8: the second streamed, e_1 held) and a lone
    skinny layer whose gram head streams e_0 into dx (1500,), at each
    pair that routes there (a network the register-tiled fp32 K3 holds
    stays there), at 37 and 4096 rows."""
    m, obs, _ = _model(hidden, cuda)
    fn = make_fused_loglik_grad_gram(m.config, m.normalizer, obs, 25.0, precision=tiers[0],
                                     grad_precision=tiers[1], device=cuda)
    if not fn.wide:
        assert fn.register_tiled and tiers == ("highest", "highest")
        return
    ops = fn.operands(m.params)
    for n in (37, 4096):
        x = _prior_rows(n, cuda)
        vk, gk = fn(m.params, x)
        vp, gp = loglik_grad_gram_reference(ops, x)
        vk, gk, vp, gp = (t.cpu().numpy() for t in (vk, gk, vp, gp))
        assert np.isfinite(vk).all() and np.isfinite(gk).all()
        _close_values(vk, vp, float(ops.c), tiers[0])
        assert grad_gate_violation(gk, gp) <= 0.0, n
        assert gk[0, 2] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("tiers", WIDE_PAIRS)
def test_k3_wide_members_equal_single_launches(cuda, tiers):
    """M = 3 on the wide route: one member-batched launch equals the three
    members' single launches bit for bit at 37 and 4096 rows, and holds
    to the member-batched plain version."""
    ens, obs = _members(WIDE_HIDDEN, cuda)
    batched = _k3_wide(ens, obs, tiers, cuda, members=3)
    singles = [_k3_wide(ens, obs, tiers, cuda) for _ in range(3)]
    views = ens.member_params(ens.params)
    ops = batched.operands(ens.params)
    for n in (37, 4096):
        x = _prior_rows(n, cuda)
        v3, g3 = batched(ens.params, x)
        vp, gp = fused_loglik.loglik_grad_gram_members_reference(ops, x)
        for k, (f, p) in enumerate(zip(singles, views)):
            v1, g1 = f(p, x)
            assert torch.equal(v3[k], v1) and torch.equal(g3[k], g1), (n, k)
            _close_values(v3[k].cpu().numpy(), vp[k].cpu().numpy(), float(ops.c[k]), tiers[0])
            assert grad_gate_violation(g3[k].cpu().numpy(), gp[k].cpu().numpy()) <= 0.0
    assert batched.launches == 2


# Every network no dedicated kernel holds, at every K2 tier and K3 pair:
# the wide route. (1536,)×3 is too wide for the tensor-core kernels,
# (4096, 4096) spills to the workspace at every pair, (256,)×12 is deeper
# than the dedicated kernels' eight layers.
ALL_PAIRS = [(a, b) for a in TIERS for b in TIERS]
WIDE_NETS = [(1536, 1536, 1536), (4096, 4096), (256,) * 12]


def _wide_route(m, obs, tiers, dev, members=None):
    """K2 (``tiers[1]`` None) or K3 at ``tiers`` on the wide route."""
    if tiers[1] is None:
        fn = make_fused_loglik_gram(m.config, m.normalizer, obs, 25.0, precision=tiers[0],
                                    members=members, device=dev)
    else:
        fn = make_fused_loglik_grad_gram(m.config, m.normalizer, obs, 25.0, precision=tiers[0],
                                         grad_precision=tiers[1], members=members, device=dev)
    assert fn.wide and not (fn.reverse or fn.register_tiled or fn.tensor_cores or fn.mixed)
    return fn


def _to_cpu(ops):
    """An operand record (dataclasses, tuples, tensors) with every tensor
    on the CPU."""
    import dataclasses

    if isinstance(ops, torch.Tensor):
        return ops.cpu()
    if dataclasses.is_dataclass(ops):
        return dataclasses.replace(ops, **{f.name: _to_cpu(getattr(ops, f.name))
                                           for f in dataclasses.fields(ops)})
    if isinstance(ops, tuple):
        parts = [_to_cpu(t) for t in ops]
        return type(ops)(*parts) if hasattr(ops, "_fields") else tuple(parts)
    return ops


def _exact_gradient(m, obs, params, x):
    """The plain K3 at (fp32, fp32) on ``params`` (``m``'s network): the
    exact gradient against which a tensor-core tier's kernel and plain
    version are each held."""
    fn = make_fused_loglik_grad_gram(m.config, m.normalizer, obs, 25.0, precision="highest",
                                     grad_precision="highest", device=x.device)
    return loglik_grad_gram_reference(fn.operands(params), x)[1]


# the rows over which a gradient at a tensor-core value tier is held beside
# its reference against the exact gradient (grad_gate_beside): its q99.9
# over 4096 rows is the fifth-largest row's error, which two roundings of
# one tier move by more than the gate's margin on (256,)×12; over 65,536
# rows by ≤ 0.0021 (scripts/grad_gate_spread_cpu.py)
POOLED_ROWS = 65_536


def _held_to_plain(got, want, ops, tiers, exact=None, pool=None):
    """Values within the value tier's tolerance of plain (``ops``: one
    model's operands), per batch; gradients (K3) under the gate at an
    fp32 value tier, per batch; at a tensor-core one, where on networks
    this wide or deep both flip ReLU masks on more rows than the gate's
    0.1 %, the batch's kernel, plain and ``exact`` gradients
    (:func:`_exact_gradient`) go into ``pool``, held together by
    :func:`_pooled_gate`; the fx == 0 slot exactly 0."""
    if tiers[1] is None:
        got, want = (got,), (want,)
    got = [t.cpu().numpy() for t in got]
    want = [t.cpu().numpy() for t in want]
    assert all(np.isfinite(t).all() for t in got)
    _close_values(got[0], want[0], float(ops.c), tiers[0])
    if tiers[1] is not None:
        if tiers[0] == "highest":
            assert grad_gate_violation(got[1], want[1]) <= 0.0
        else:
            pool.append((got[1], want[1], exact.cpu().numpy()))
        assert got[1][0, 2] == 0.0


def _pooled_gate(pool):
    """The gradients ``pool`` collected (:func:`_held_to_plain`), at least
    :data:`POOLED_ROWS` rows: every row no less accurate than its
    reference against the exact gradient by the gate's margins, q99.9
    and max over the rows together (``grad_gate_beside``), as smoke
    phase 22 pools its rows. Nothing to hold where the pool is empty (an
    fp32 value tier, or K2)."""
    if not pool:
        return
    got, want, exact = (np.concatenate(g) for g in zip(*pool))
    assert got.shape[0] >= POOLED_ROWS
    assert grad_gate_beside(got, want, exact) <= 0.0


def _wide_anyway(fn, ops, k3):
    """The wide route's call on ``fn``'s network where a dedicated kernel
    holds it: its operands packed for the wide route, launched directly
    at the tallest height (:class:`fused_loglik.WideLaunch`)."""
    import dataclasses

    ops = fused_loglik.pack_wide_operands(dataclasses.replace(
        ops, slabs=None, packed=None, program=None, frags=None))
    route = fused_loglik.WideLaunch(fused_loglik.ops_plan(ops), k3, fn.sm_count, fn.device)
    return ops, lambda x: route(ops, x, route.plan.heights[0])


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", WIDE_NETS, ids=["1536x3", "4096x2", "256x12"])
@pytest.mark.parametrize("tiers", [(t, None) for t in TIERS] + ALL_PAIRS,
                         ids=[f"k2-{t}" for t in TIERS] + [f"k3-{a}-{b}" for a, b in ALL_PAIRS])
def test_wide_routes_match_plain(cuda, hidden, tiers):
    """K2 at every tier and K3 at every pair on the wide route: one launch
    per wrapper call where the dedicated kernels refuse the network (at a
    tier or pair whose dedicated kernel holds (1536,)×3 the wrapper keeps
    it, and the wide route's operands are launched directly), within the
    value tier's tolerance of the plain version at 37, 4096 and 65,536
    rows, gradients under the gate per batch at an fp32 value tier, at a
    tensor-core one beside plain against the exact gradient over the
    69,669 rows pooled (``_held_to_plain``, ``_pooled_gate``), the fx ==
    0 slot exactly 0; where the plan spills, the wrapper's workspace is
    allocated once and reused."""
    m, obs, _ = _model(hidden, cuda)
    k3 = tiers[1] is not None
    if k3:
        fn = make_fused_loglik_grad_gram(m.config, m.normalizer, obs, 25.0, precision=tiers[0],
                                         grad_precision=tiers[1], device=cuda)
    else:
        fn = make_fused_loglik_gram(m.config, m.normalizer, obs, 25.0, precision=tiers[0],
                                    device=cuda)
    ops = fn.operands(m.params)
    if fn.wide:
        def call(x):
            return fn(m.params, x)
    else:
        assert hidden == (1536, 1536, 1536) and tiers in [
            ("highest", None), ("default", None), ("highest", "highest"), ("default", "default")]
        ops, call = _wide_anyway(fn, ops, k3)
    plain = loglik_grad_gram_reference if k3 else loglik_gram_reference
    pool = []
    for n in (37, 4096, POOLED_ROWS):
        x = _prior_rows(n, cuda)
        fn.launches = 0
        got = call(x)
        assert fn.launches == int(fn.wide)
        exact = _exact_gradient(m, obs, m.params, x) if k3 else None
        _held_to_plain(got, plain(ops, x), ops, tiers, exact, pool)
    _pooled_gate(pool)
    if fn.wide:
        assert (fn.wide_launch.workspace is not None) == bool(fn.plan.spilled
                                                              or fn.plan.masks_in_ws)
    if hidden == (4096, 4096):
        assert fn.plan.spilled
        workspace = fn.wide_launch.workspace
        fn(m.params, _prior_rows(100, cuda))
        assert fn.wide_launch.workspace is workspace


@pytest.mark.cuda
@pytest.mark.parametrize("tiers", [(t, None) for t in TIERS] + ALL_PAIRS,
                         ids=[f"k2-{t}" for t in TIERS] + [f"k3-{a}-{b}" for a, b in ALL_PAIRS])
def test_wide_workspace_plan_equals_the_shared_plan(cuda, tiers):
    """A network's plan under a small shared-memory budget (its vectors in
    the workspace, at K3 also with the mask bits there; a persistent grid
    of a few CTAs) gives the all-shared plan's results bit for bit on the
    card, at each height, and both hold to the CPU emulation of the
    program and to plain: on 1000 rows (37 emulated), the gradients at a
    tensor-core value tier pooled with 65,536 more, against plain and
    against the program's emulation run on the card."""
    import dataclasses
    import sys

    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    from _torch_f32 import emulate_wide

    from tpu21cmvae_torch.ops.kernels import wide
    from tpu21cmvae_torch.ops.kernels._common import MAX_SHARED_BYTES

    m, obs, _ = _model((1200, 1300), cuda)
    k3 = tiers[1] is not None
    fn = (make_fused_loglik_grad_gram(m.config, m.normalizer, obs, 25.0, precision=tiers[0],
                                      grad_precision=tiers[1], device=cuda) if k3 else
          make_fused_loglik_gram(m.config, m.normalizer, obs, 25.0, precision=tiers[0],
                                 device=cuda))
    base = dataclasses.replace(fn.operands(m.params), slabs=None, packed=None, program=None,
                               frags=None)

    def route(budget):  # the operands packed under ``budget`` and their launches
        plan = fused_loglik.ops_plan(base, budget)
        return (fused_loglik.pack_wide_operands(base, budget),
                fused_loglik.WideLaunch(plan, k3, fn.sm_count, cuda))

    shared, spilled = route(MAX_SHARED_BYTES), route(120_000)
    plan = spilled[1].plan
    assert plan.spilled and not shared[1].plan.spilled
    x = _prior_rows(1000, cuda)
    want = shared[1](shared[0], x, 16)
    emulated = emulate_wide(_to_cpu(spilled[0]), x[:37].cpu(), plan)
    pooled = k3 and tiers[0] != "highest"
    runs = [spilled]
    if k3:  # a budget a byte short of the masks as well: they go to the workspace
        runs.append(route(wide.plan_bytes(plan, 32) - 1))
        assert runs[-1][1].plan.masks_in_ws
    for ops, launch in runs:
        for rows in launch.plan.heights:
            # fewer CTAs than row tiles: each loops over several
            got = launch(ops, x, rows, ctas=5)
            torch.cuda.synchronize()
            pairs = zip(got, want) if k3 else [(got, want)]
            assert all(torch.equal(a, b) for a, b in pairs), rows
    plain = loglik_grad_gram_reference if k3 else loglik_gram_reference
    exact = _exact_gradient(m, obs, m.params, x) if k3 else None
    pool, to_emulation = [], []
    _held_to_plain(want, plain(shared[0], x), shared[0], tiers, exact, pool)
    first = [t[:37] for t in want] if k3 else want[:37]
    _held_to_plain(first, emulated, shared[0], tiers, None if exact is None else exact[:37],
                   to_emulation)
    if pooled:  # 65,536 more rows, against plain and against the program's emulation
        more = _prior_rows(POOLED_ROWS, cuda)
        got = shared[1](shared[0], more, 16)
        exact = _exact_gradient(m, obs, m.params, more)
        _held_to_plain(got, plain(shared[0], more), shared[0], tiers, exact, pool)
        _held_to_plain(got, emulate_wide(spilled[0], more, plan), shared[0], tiers, exact,
                       to_emulation)
    _pooled_gate(pool)
    _pooled_gate(to_emulation)


@pytest.mark.cuda
@pytest.mark.parametrize("tiers", [("high", None), ("high", "default"), ("highest", "default"),
                                   ("default", "high")])
def test_wide_new_routes_members_equal_single_launches(cuda, tiers):
    """M = 3 on the wide route at the new tiers and pairs, on a network
    that spills: one member-batched launch equals the three members'
    single launches bit for bit at 37, 4096 and 65,536 rows, and holds to
    the member-batched plain version (each member's gradients at a
    tensor-core value tier pooled over the three batches)."""
    hidden = (4096, 4096)
    ens, obs = _members(hidden, cuda)
    batched = _wide_route(ens, obs, tiers, cuda, members=3)
    singles = [_wide_route(ens, obs, tiers, cuda) for _ in range(3)]
    assert batched.plan.spilled
    views = ens.member_params(ens.params)
    ops = batched.operands(ens.params)
    k3 = tiers[1] is not None
    plain = (fused_loglik.loglik_grad_gram_members_reference if k3
             else fused_loglik.loglik_gram_members_reference)
    pools = [[] for _ in singles]
    for n in (37, 4096, POOLED_ROWS):
        x = _prior_rows(n, cuda)
        got = batched(ens.params, x)
        want = plain(ops, x)
        for k, (f, p) in enumerate(zip(singles, views)):
            one = f(p, x)
            own = member_of(ops, k)
            if k3:
                assert torch.equal(got[0][k], one[0]) and torch.equal(got[1][k], one[1]), (n, k)
                _held_to_plain((got[0][k], got[1][k]), (want[0][k], want[1][k]), own, tiers,
                               _exact_gradient(ens, obs, p, x), pools[k])
            else:
                assert torch.equal(got[k], one), (n, k)
                _held_to_plain(got[k], want[k], own, tiers)
    for pool in pools:
        _pooled_gate(pool)
    assert batched.launches == 3


def _k1_wide(m, obs, tier, reduce, dev, members=None):
    """K1 at ``tier`` on ``m``'s network: predict (``make_fused_emulate``)
    or the direct likelihood's Σy² (``make_fused_loglik``'s K1), its
    operands and its call: the wrapper's where it routes the network to
    the wide route, else the wide route's operands packed all the same
    and launched directly at the tallest height."""
    from tpu21cmvae_torch.ops.kernels import wide

    if reduce == "sumsq":
        fn = make_fused_loglik(m.config, m.normalizer, obs, 25.0, precision=tier,
                               members=members, device=dev).mlp
    else:
        fn = make_fused_emulate(m.config, m.normalizer, precision=tier, device=dev)
    ops = fn.operands(m.params)
    if fn.wide:
        return fn, ops, lambda x: fn(m.params, x)
    plan = fused_mlp.k1_wide_plan(fn.sizes, fn.tier, reduce)
    ops = fused_mlp.pack_wide_mlp(ops, plan)
    route = wide.WideLaunch(plan, fused_mlp._fused_mlp_wide_cuda, fn.sm_count, dev)
    return fn, ops, lambda x: route(ops, x, plan.heights[0])


@pytest.mark.cuda
@pytest.mark.parametrize("reduce", ["none", "sumsq"])
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("hidden", WIDE_NETS, ids=["1536x3", "4096x2", "256x12"])
def test_k1_wide_route_matches_plain(cuda, hidden, tier, reduce):
    """K1's wide program (``k1_fused_mlp_wide``) at every tier, predict and
    Σy²: one launch per wrapper call where the dedicated kernels refuse the
    network (where one holds (1536,)×3 the wrapper keeps it and the wide
    operands are launched directly), within AMPLITUDE_RTOL of plain's
    amplitude (predict) or VALUE_RTOL of the folded likelihood's scale
    (Σy², as ½Σy²) at 37, 4096 and 65,537 rows; where the plan spills,
    the workspace is allocated once and reused."""
    m, obs, _ = _model(hidden, cuda)
    fn, ops, call = _k1_wide(m, obs, tier, reduce, cuda)
    assert fn.wide or hidden == (1536, 1536, 1536)
    c = float(ops.b[-1] @ ops.b[-1])
    for n in (37, 4096, 65_537):
        x = _prior_rows(n, cuda)
        fn.launches = 0
        got = call(x)
        assert fn.launches == int(fn.wide)
        want = fused_mlp_reference(ops, x)
        got, want = got.cpu().numpy(), want.cpu().numpy()
        assert got.shape == ((n,) if reduce == "sumsq" else (n, 451)) and np.isfinite(got).all()
        if reduce == "none":
            assert np.abs(got - want).max() <= AMPLITUDE_RTOL[tier] * np.abs(want).max()
        else:
            _close_values(-0.5 * got, -0.5 * want, c, tier)
    if fn.wide and hidden == (4096, 4096):
        assert fn.plan.spilled
        workspace = fn.wide_launch.workspace
        assert workspace is not None
        fn(m.params, _prior_rows(100, cuda))
        assert fn.wide_launch.workspace is workspace


@pytest.mark.cuda
@pytest.mark.parametrize("reduce", ["none", "sumsq"])
@pytest.mark.parametrize("tier", TIERS)
def test_k1_wide_members_equal_single_launches(cuda, tier, reduce):
    """M = 3 on K1's wide route ((256,)×12, deeper than the dedicated
    kernels): one member-batched launch equals the three members' single
    launches bit for bit at 37 and 4096 rows, one launch per call."""
    ens, obs = _members((256,) * 12, cuda)
    route = ("k1" if reduce == "sumsq" else "k1_predict", tier, None)
    batched = _route_wrapper(ens, obs, route, cuda, members=3)
    singles = [_route_wrapper(ens, obs, route, cuda) for _ in range(3)]
    k1 = batched.mlp if reduce == "sumsq" else batched
    assert k1.wide and k1.wide_launch.members == 3
    views = ens.member_params(ens.params)
    for n in (37, 4096):
        x = _prior_rows(n, cuda)
        got = batched(ens.params, x)
        for k, (f, p) in enumerate(zip(singles, views)):
            assert torch.equal(got[k], f(p, x)), (n, k)
    assert batched.launches == 2


def _fan_in_model(dev, n_params=12, hidden=(288, 352, 288, 224), seed=12):
    """A seeded direct model with ``n_params`` inputs (a dense first
    layer), its own seeded normalizer, an observation and a row sampler
    over its box (columns 0–2 positive, row 0 at fx == 0)."""
    from tpu21cmvae_torch.ops.fold import _log_clamp
    from tpu21cmvae_torch.ops.transforms import Normalizer

    rng = np.random.default_rng(seed)
    lo = rng.uniform(0.1, 1.0, n_params).astype(np.float32)
    hi = lo + rng.uniform(0.5, 2.0, n_params).astype(np.float32)
    bounds = _log_clamp(torch.as_tensor(np.stack([lo, hi])))
    cfg = DirectEmulatorConfig(n_params=n_params, hidden_dims=hidden)
    norm = Normalizer(signal_mean=torch.as_tensor(rng.normal(0, 20.0, cfg.n_bins),
                                                  dtype=torch.float32, device=dev),
                      signal_std=torch.tensor(30.0, device=dev),
                      par_min=bounds[0].to(dev), par_max=bounds[1].to(dev))
    m = DirectEmulator(config=cfg, normalizer=norm, seed=seed, device=dev)

    def rows(n):
        x = np.random.default_rng(n).uniform(lo, hi, (n, n_params)).astype(np.float32)
        x[0, 2] = 0.0
        return torch.as_tensor(x, device=dev)

    obs = m.predict(rows(2)[1].cpu().numpy()) + rng.normal(0, 5.0, cfg.n_bins)
    return m, obs, rows


@pytest.mark.cuda
@pytest.mark.parametrize("tiers", [(t, None) for t in TIERS] + ALL_PAIRS,
                         ids=[f"k2-{t}" for t in TIERS] + [f"k3-{a}-{b}" for a, b in ALL_PAIRS])
def test_fan_in_12_routes_match_plain(cuda, tiers):
    """K2 at every tier and K3 at every pair on a fan-in-12 model of the
    flagship's hidden widths: the wide route with a dense first layer, one
    launch per call, within the value tier's tolerance of plain at 37,
    4096 and 65,537 rows, gradients under the gate per batch at an fp32
    value tier, at a tensor-core one beside plain against the exact
    gradient over the 69,670 rows pooled; the fx == 0 slot exactly 0."""
    m, obs, rows = _fan_in_model(cuda)
    fn = _wide_route(m, obs, tiers, cuda)
    assert fn.plan.dense
    ops = fn.operands(m.params)
    k3 = tiers[1] is not None
    plain = loglik_grad_gram_reference if k3 else loglik_gram_reference
    pool = []
    for n in (37, 4096, 65_537):
        x = rows(n)
        fn.launches = 0
        got = fn(m.params, x)
        assert fn.launches == 1
        exact = _exact_gradient(m, obs, m.params, x) if k3 else None
        _held_to_plain(got, plain(ops, x), ops, tiers, exact, pool)
    _pooled_gate(pool)


@pytest.mark.cuda
@pytest.mark.parametrize("log_clamp", [False, True])
def test_k1_lone_skinny_layer_equals_plain_bit_for_bit(cuda, log_clamp):
    """K1 at fp32 on a network whose only layer is skinny (7 → 40): kernel
    and plain version compute the layer in one order (the Pallas
    kernel's: products from column 0, each product and each sum rounded,
    then the bias), so predict equals plain bit for bit, on raw rows and
    on log-clamped ones."""
    params = _random_params((7, 40), cuda)
    x = _prior_rows(4096, cuda)
    fn = make_fused_mlp((7, 40), precision="highest", log_clamp_input=log_clamp, device=cuda)
    ops = fn.operands(params)
    assert ops.skinny
    assert torch.equal(fn(params, x), fused_mlp_reference(ops, x))


# K3 at a bf16 value tier with an fp32 backward: fused_gram_mma.cu's
# reverse mode
REVERSE_PAIRS = [("high", "highest"), ("default", "highest")]


def _k3_reverse(m, obs, tiers, dev, members=None):
    fn = make_fused_loglik_grad_gram(m.config, m.normalizer, obs, 25.0, precision=tiers[0],
                                     grad_precision=tiers[1], members=members, device=dev)
    assert fn.reverse and not (fn.tensor_cores or fn.mixed or fn.register_tiled)
    return fn


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", F32_GRAM_WIDTHS)
@pytest.mark.parametrize("tiers", REVERSE_PAIRS)
def test_k3_reverse_matches_plain(cuda, hidden, tiers):
    """The reverse mode at batches 1, 37, 100, 4096 and 65,537 with an
    fx == 0 row: values within the value tier's tolerance of the plain
    version, gradients under the gate against it, the fx == 0 slot
    exactly 0, one launch per call; its value equals the tensor-core
    K2's at the value tier bit for bit (the same forward)."""
    m, obs, _ = _model(hidden, cuda)
    fn = _k3_reverse(m, obs, tiers, cuda)
    k2 = make_fused_loglik_gram(m.config, m.normalizer, obs, 25.0, precision=tiers[0],
                                device=cuda)
    assert k2.tensor_cores
    ops = fn.operands(m.params)
    for n in (1, 37, 100, 4096, 65537):
        x = _prior_rows(n, cuda)
        fn.launches = 0
        vk, gk = fn(m.params, x)
        vp, gp = loglik_grad_gram_reference(ops, x)
        v2 = k2(m.params, x)
        torch.cuda.synchronize()
        assert fn.launches == 1 and torch.equal(vk, v2)
        vk, gk, vp, gp = (t.cpu().numpy() for t in (vk, gk, vp, gp))
        assert vk.shape == (n,) and gk.shape == (n, 7)
        assert np.isfinite(vk).all() and np.isfinite(gk).all()
        _close_values(vk, vp, float(ops.c), tiers[0])
        assert grad_gate_violation(gk, gp) <= 0.0
        assert gk[0, 2] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("tiers", REVERSE_PAIRS)
def test_k3_reverse_shipped_checkpoint_passes_the_gate(cuda, tiers):
    """On the shipped flagship checkpoint, at both reverse pairs and
    batches 1, 37, 4096 and 65,537: gradients under the gate against
    plain, the value bit for bit the tensor-core K2's at the value tier
    and, on every row, within the tier's tolerance of plain: kernel and
    plain compute the skinny layer in one order, so the single-pass bf16
    rounding of the next layer has nothing to amplify."""
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    m = DirectEmulator.from_checkpoint(os.path.join(root, "pretrained", "direct_synthetic.npz"),
                                       device=cuda)
    obs = m.predict(synthetic_params(1, np.random.default_rng(0))[0]) + (
        np.random.default_rng(1).normal(0.0, 5.0, 451))
    fn = _k3_reverse(m, obs, tiers, cuda)
    k2 = make_fused_loglik_gram(m.config, m.normalizer, obs, 25.0, precision=tiers[0],
                                device=cuda)
    ops = fn.operands(m.params)
    for n in (1, 37, 4096, 65537):
        x = _prior_rows(n, cuda)
        vk, gk = fn(m.params, x)
        vp, gp = loglik_grad_gram_reference(ops, x)
        assert torch.equal(vk, k2(m.params, x))
        _close_values(vk.cpu().numpy(), vp.cpu().numpy(), float(ops.c), tiers[0])
        gk, gp = gk.cpu().numpy(), gp.cpu().numpy()
        assert grad_gate_violation(gk, gp) <= 0.0
        assert gk[0, 2] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("tiers", REVERSE_PAIRS)
def test_k3_reverse_members_equal_single_launches(cuda, tiers):
    """M = 3: one member-batched launch equals the three members' single
    launches bit for bit at 1, 37, 100, 4096 and 65,537 rows, and holds
    to its member-batched plain version (the gradient gate)."""
    ens, obs = _members((288, 352, 288, 224), cuda)
    batched = _k3_reverse(ens, obs, tiers, cuda, members=3)
    singles = [_k3_reverse(ens, obs, tiers, cuda) for _ in range(3)]
    views = ens.member_params(ens.params)
    ops = batched.operands(ens.params)
    for n in (1, 37, 100, 4096, 65537):
        x = _prior_rows(n, cuda)
        v3, g3 = batched(ens.params, x)
        vp, gp = fused_loglik.loglik_grad_gram_members_reference(ops, x)
        for m, (f, p) in enumerate(zip(singles, views)):
            v1, g1 = f(p, x)
            assert torch.equal(v3[m], v1) and torch.equal(g3[m], g1), (n, m)
            _close_values(v3[m].cpu().numpy(), vp[m].cpu().numpy(), float(ops.c[m]), tiers[0])
            assert grad_gate_violation(g3[m].cpu().numpy(), gp[m].cpu().numpy()) <= 0.0
    assert batched.launches == 5


@pytest.mark.cuda
def test_k3_reverse_rows_are_independent(cuda):
    """One row alone equals the same row inside a batch of 100 bit for
    bit, and a NaN row leaves the others as they were."""
    m, obs, data = _model((288, 352, 288, 224), cuda)
    x = _rows(data, 100, cuda)
    fn = _k3_reverse(m, obs, REVERSE_PAIRS[0], cuda)
    vb, gb = fn(m.params, x)
    for i in (0, 7, 45, 99):
        v1, g1 = fn(m.params, x[i])
        assert torch.equal(v1[0], vb[i]) and torch.equal(g1[0], gb[i])
    bad = x.clone()
    bad[11, 4] = float("nan")
    v, g = fn(m.params, bad)
    keep = torch.arange(100, device=cuda) != 11
    assert torch.isnan(v[11])
    assert torch.equal(v[keep], vb[keep]) and torch.equal(g[keep], gb[keep])


@pytest.mark.cuda
def test_hmc_with_a_bf16x3_value_and_an_exact_force_runs_the_reverse_k3(cuda):
    """``loglik_and_grad_fn(precision="high", grad_precision="highest",
    backend="kernel")`` is the reverse mode, and ``sample_hmc`` launches
    it once per gradient."""
    m, obs, _ = _model((32, 48, 32, 24), cuda)
    k3 = m.loglik_and_grad_fn(obs, 25.0, backend="kernel", precision="high",
                              grad_precision="highest")
    assert k3.reverse and not k3.tensor_cores
    k3.launches = 0
    res = sample_hmc(k3, m.params, n_walkers=256, n_warmup=20, n_steps=20, seed=1, device=cuda)
    assert k3.launches >= 41
    assert np.isfinite(res.chain).all() and res.chain.shape == (4, 256, 7)


# K3 at an fp32 value tier with a bf16 backward: fused_gram_mixed.cu
MIXED_PAIRS = [("highest", "high"), ("highest", "default")]
MIXED_HEIGHTS = (32, 16)


def _k3_mixed(m, obs, tiers, dev, rows=None, members=None):
    """K3 at ``tiers`` on ``fused_gram_mixed.cu`` at tile height ``rows``
    (None: picked per batch)."""
    fn = make_fused_loglik_grad_gram(m.config, m.normalizer, obs, 25.0, precision=tiers[0],
                                     grad_precision=tiers[1], tile_rows=rows, members=members,
                                     device=dev)
    assert fn.mixed and not fn.tensor_cores and not fn.register_tiled
    return fn


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", F32_GRAM_WIDTHS)
@pytest.mark.parametrize("rows", [*MIXED_HEIGHTS, None])
@pytest.mark.parametrize("tiers", MIXED_PAIRS)
def test_k3_mixed_matches_plain(cuda, hidden, rows, tiers):
    """``fused_gram_mixed.cu`` at each tile height, forced, and at the
    height the wrapper picks, for batches 1, 37, 100, 4096 and 65,537 with
    an fx == 0 row: values within the fp32 tolerance of the plain version,
    the gradient gate, the fx == 0 slot exactly 0, one launch per call;
    its value equals the fp32 K2's at the same height bit for bit."""
    m, obs, _ = _model(hidden, cuda)
    fn = _k3_mixed(m, obs, tiers, cuda, rows)
    k2 = {h: make_fused_loglik_gram(m.config, m.normalizer, obs, 25.0, precision="highest",
                                    tile_rows=h, device=cuda) for h in MIXED_HEIGHTS}
    ops = fn.operands(m.params)
    for n in (1, 37, 100, 4096, 65537):
        x = _prior_rows(n, cuda)
        fn.launches = 0
        vk, gk = fn(m.params, x)
        vp, gp = loglik_grad_gram_reference(ops, x)
        height = fn.rows_for(n)
        v2 = k2[height](m.params, x)
        torch.cuda.synchronize()
        assert fn.launches == 1 and height in MIXED_HEIGHTS and (rows is None or height == rows)
        assert torch.equal(vk, v2)
        vk, gk, vp, gp = (t.cpu().numpy() for t in (vk, gk, vp, gp))
        assert vk.shape == (n,) and gk.shape == (n, 7)
        assert np.isfinite(vk).all() and np.isfinite(gk).all()
        _close_values(vk, vp, float(ops.c), "highest")
        assert grad_gate_violation(gk, gp) <= 0.0
        assert gk[0, 2] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("rows", MIXED_HEIGHTS)
@pytest.mark.parametrize("tiers", MIXED_PAIRS)
def test_k3_mixed_members_equal_single_launches(cuda, rows, tiers):
    """M = 3: one member-batched launch equals the three members' single
    launches bit for bit at each height, at 1, 37, 100, 4096 and 65,537
    rows, and holds to its member-batched plain version."""
    ens, obs = _members((288, 352, 288, 224), cuda)
    batched = _k3_mixed(ens, obs, tiers, cuda, rows, members=3)
    singles = [_k3_mixed(ens, obs, tiers, cuda, rows) for _ in range(3)]
    views = ens.member_params(ens.params)
    ops = batched.operands(ens.params)
    for n in (1, 37, 100, 4096, 65537):
        x = _prior_rows(n, cuda)
        v3, g3 = batched(ens.params, x)
        vp, gp = fused_loglik.loglik_grad_gram_members_reference(ops, x)
        for m, (f, p) in enumerate(zip(singles, views)):
            v1, g1 = f(p, x)
            assert torch.equal(v3[m], v1) and torch.equal(g3[m], g1), (n, m)
            _close_values(v3[m].cpu().numpy(), vp[m].cpu().numpy(), float(ops.c[m]), "highest")
            assert grad_gate_violation(g3[m].cpu().numpy(), gp[m].cpu().numpy()) <= 0.0
    assert batched.launches == 5


@pytest.mark.cuda
@pytest.mark.parametrize("rows", MIXED_HEIGHTS)
def test_k3_mixed_rows_are_independent(cuda, rows):
    """A row's value and gradient do not depend on the other rows of its
    tile: one row alone equals the same row inside a batch of 100 bit for
    bit, and a NaN row leaves the others as they were."""
    m, obs, data = _model((288, 352, 288, 224), cuda)
    x = _rows(data, 100, cuda)
    fn = _k3_mixed(m, obs, MIXED_PAIRS[1], cuda, rows)
    vb, gb = fn(m.params, x)
    for i in (0, 7, 45, 99):
        v1, g1 = fn(m.params, x[i])
        assert torch.equal(v1[0], vb[i]) and torch.equal(g1[0], gb[i])
    bad = x.clone()
    bad[11, 4] = float("nan")
    v, g = fn(m.params, bad)
    keep = torch.arange(100, device=cuda) != 11
    assert torch.isnan(v[11])
    assert torch.equal(v[keep], vb[keep]) and torch.equal(g[keep], gb[keep])


@pytest.mark.cuda
def test_k3_mixed_refused_launch_raises(cuda):
    """A tile height the C entry point was not built for is refused
    there and raises with its CUDA error string; nothing falls back to
    another kernel or the plain version."""
    m, obs, data = _model((32, 48, 32, 24), cuda)
    fn = _k3_mixed(m, obs, MIXED_PAIRS[0], cuda)
    fn.tile_rows = 64
    with pytest.raises(RuntimeError, match="K3 launch failed: invalid argument"):
        fn(m.params, _rows(data, 5, cuda))


@pytest.mark.cuda
def test_hmc_with_an_exact_value_and_a_bf16_force_runs_the_mixed_k3(cuda):
    """``loglik_and_grad_fn(precision="contract", grad_precision="default",
    backend="kernel")`` is ``fused_gram_mixed.cu``, and ``sample_hmc``
    launches it once per gradient: once at the start, then once per
    leapfrog step."""
    m, obs, _ = _model((32, 48, 32, 24), cuda)
    k3 = m.loglik_and_grad_fn(obs, 25.0, backend="kernel", precision="contract",
                              grad_precision="default")
    assert k3.mixed and not k3.tensor_cores and not k3.register_tiled
    k3.launches = 0
    res = sample_hmc(k3, m.params, n_walkers=256, n_warmup=20, n_steps=20, seed=1, device=cuda)
    assert k3.launches >= 41
    assert np.isfinite(res.chain).all() and res.chain.shape == (4, 256, 7)


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
    member-batched wrapper over the stacked weights) against the same
    mixture over the plain versions, at 4096 and 8192 rows: values within
    the member bound (the mixture's logsumexp is 1-Lipschitz in the max
    norm), K3's gradient under the gate. Ten calls launch 10 kernels (one
    per call) and fold the stacked operands once."""
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
    assert fn.launches == 10 and fn.folds == 1


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


# every route of K1, K2 and K3: (kernel, value tier, backward tier)
MEMBER_ROUTES = [("k1", "highest", None), ("k1", "high", None), ("k1", "default", None),
                 ("k1_predict", "highest", None), ("k1_predict", "high", None),
                 ("k2", "highest", None), ("k2", "high", None), ("k2", "default", None),
                 ("k3", "highest", "highest"), ("k3", "high", "default"), ("k3", "high", "high"),
                 ("k3", "highest", "default"), ("k3", "highest", "high"),
                 ("k3", "high", "highest"), ("k3_wide", "high", "highest")]
MEMBER_IDS = [f"{k}-{t}-{g}" for k, t, g in MEMBER_ROUTES]


def _member_hidden(route, hidden):
    """``hidden``, its first layer 1500 wide on the ``k3_wide`` route: too
    wide for ``fused_gram_mma.cu``'s reverse mode, so K3 runs
    ``fused_loglik_grad_gram.cu``."""
    return (1500, *hidden[1:]) if route[0] == "k3_wide" else hidden


def _members(hidden, dev, n=3):
    """An ensemble of ``n`` randomly initialised members on ``dev`` and an
    observation."""
    from tpu21cmvae_torch.models.ensemble import DeepEnsemble

    data = synthetic_dataset(512, 64, 128, seed=7)
    ens = DeepEnsemble([DirectEmulator(data, config=DirectEmulatorConfig(hidden_dims=hidden),
                                       seed=20 + i, device=dev) for i in range(n)])
    obs = ens.members[0].predict(data.par_test[0]) + np.random.default_rng(5).normal(0, 5.0, 451)
    return ens, obs


def _route_wrapper(ens, obs, route, dev, members=None):
    import functools

    from tpu21cmvae_torch.ops.fold import fold_emulator_constants

    kernel, tier, grad = route
    cfg, norm = ens.config, ens.normalizer
    if kernel == "k1":
        return make_fused_loglik(cfg, norm, obs, 25.0, precision=tier, members=members,
                                 device=dev)
    if kernel == "k1_predict":
        return fused_mlp.FusedMLP(cfg.mlp().sizes, log_clamp_input=True, precision=tier,
                                  members=members, device=dev,
                                  fold=functools.partial(fold_emulator_constants, norm=norm))
    if kernel == "k2":
        return make_fused_loglik_gram(cfg, norm, obs, 25.0, precision=tier, members=members,
                                      device=dev)
    fn = make_fused_loglik_grad_gram(cfg, norm, obs, 25.0, precision=tier,
                                     grad_precision=grad, members=members, device=dev)
    if kernel == "k3_wide":
        assert fn.wide and not (fn.reverse or fn.tensor_cores or fn.mixed or fn.register_tiled)
    return fn


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [(32, 48, 32, 24), (288, 352, 288, 224)])
@pytest.mark.parametrize("route", MEMBER_ROUTES, ids=MEMBER_IDS)
def test_member_batched_launch_equals_single_launches(cuda, route, hidden):
    """One member-batched launch (M = 3, the members on grid y) equals the
    three members' single-model launches bit for bit, at 1, 37 and 1000
    rows: a member's CTAs run the same arithmetic in the same order. One
    launch per call."""
    ens, obs = _members(_member_hidden(route, hidden), cuda)
    batched = _route_wrapper(ens, obs, route, cuda, members=3)
    singles = [_route_wrapper(ens, obs, route, cuda) for _ in range(3)]
    views = ens.member_params(ens.params)
    for n in (1, 37, 1000):
        x = _rows_prior(n, cuda)
        with torch.no_grad():
            got = _tuple(batched(ens.params, x))
            want = [_tuple(f(p, x)) for f, p in zip(singles, views)]
        for part, g in enumerate(got):
            assert g.shape[0] == 3
            for m in range(3):
                assert torch.equal(g[m], want[m][part]), (n, m, part)
    assert batched.launches == 3 and all(f.launches == 3 for f in singles)


@pytest.mark.cuda
@pytest.mark.parametrize("route", MEMBER_ROUTES, ids=MEMBER_IDS)
def test_one_member_launch_equals_the_single_launch(cuda, route):
    """M = 1: the member-batched wrapper over a one-member stack equals
    today's single-model launch bit for bit."""
    ens, obs = _members(_member_hidden(route, (32, 48, 32, 24)), cuda, n=1)
    x = _rows_prior(37, cuda)
    with torch.no_grad():
        got = _tuple(_route_wrapper(ens, obs, route, cuda, members=1)(ens.params, x))
        want = _tuple(_route_wrapper(ens, obs, route, cuda)(ens.members[0].params, x))
    for g, w in zip(got, want):
        assert g.shape == (1, *w.shape) and torch.equal(g[0], w)


@pytest.mark.cuda
@pytest.mark.parametrize("route", MEMBER_ROUTES, ids=MEMBER_IDS)
def test_member_count_beyond_the_grid_is_refused(cuda, route, monkeypatch):
    """A wrapper of more members than a grid's y axis holds (65,535) is
    refused when it is built, and every C entry refuses such a launch: a
    single model's operands launched as 65,536 members with zero strides
    fail, as 65,535 they run, every member equal to the single launch."""
    from tpu21cmvae_torch.ops.kernels import _common

    ens, obs = _members(_member_hidden(route, (32, 48, 32, 24)), cuda, n=1)
    with pytest.raises(ValueError, match="members"):
        _route_wrapper(ens, obs, route, cuda, members=_common.MAX_MEMBERS + 1)
    fn = _route_wrapper(ens, obs, route, cuda)
    params = ens.members[0].params
    x = _rows_prior(1, cuda)
    # every member reads the one model's operands: zero strides
    for module in (fused_mlp, fused_loglik):
        monkeypatch.setattr(module, "member_strides",
                            lambda tensors, members: _common.member_strides(tensors, None))
    kernel = route[0]
    ops = (fn.mlp if kernel == "k1" else fn).operands(params)

    def run(n_members):
        """The kernel's raw outputs for ``n_members`` copies of the model
        (None: the single-model launch)."""
        import dataclasses

        wide = dataclasses.replace(ops, members=n_members)
        with torch.no_grad():
            if kernel.startswith("k1"):
                rows = (fn.mlp if kernel == "k1" else fn).tile_rows
                return _tuple(fused_mlp._fused_mlp_cuda(wide, x, rows))
            if kernel == "k2":
                return _tuple(fused_loglik._loglik_gram_cuda(wide, x, fn.tile_rows))
            return fused_loglik._loglik_grad_gram_cuda(wide, x, fn.rows_for(1) or 8)

    want = run(None)
    with pytest.raises(RuntimeError, match="launch failed"):
        run(_common.MAX_MEMBERS + 1)
    got = run(_common.MAX_MEMBERS)
    for g, w in zip(got, want):
        assert g.shape == (_common.MAX_MEMBERS, *w.shape)
        assert torch.equal(g, w.expand_as(g))


# K3 on 64-row wgmma tiles (csrc/fused_gram_tall.cu): the pair it is built
# for, on the flagship and on a narrow network whose widths need padding;
# the other bf16 pairs keep the 16-row kernel
TALL_PAIRS = [("high", "default")]
BF16_PAIRS = [("high", "default"), ("high", "high"), ("default", "default"), ("default", "high")]
TALL_NETS = [(288, 352, 288, 224), (32, 48, 32, 24)]


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", TALL_NETS, ids=["flagship", "narrow"])
@pytest.mark.parametrize("tiers", TALL_PAIRS, ids=[f"{a}-{b}" for a, b in TALL_PAIRS])
def test_k3_tall_matches_plain(cuda, hidden, tiers):
    """Batches at the crossover, at 65,536 and at a ragged 65,536 + 37
    rows run the tall kernel, one launch each: values within the value
    tier's tolerance of the plain version, gradients under the gradient
    gate, every row's value and gradient finite (the ragged last tile's
    too), the fx == 0 slot exactly 0."""
    m, obs, _ = _model(hidden, cuda)
    fn = make_fused_loglik_grad_gram(m.config, m.normalizer, obs, 25.0, precision=tiers[0],
                                     grad_precision=tiers[1], device=cuda)
    assert fn.tall_plan is not None
    ops = fn.operands(m.params)
    for n in (fused_loglik.tall_crossover(fn.sm_count), 65_536, 65_536 + 37):
        x = _prior_rows(n, cuda)
        fn.launches = fn.tall_launches = 0
        vk, gk = fn(m.params, x)
        vp, gp = loglik_grad_gram_reference(ops, x)
        torch.cuda.synchronize()
        assert fn.batch_route(n) == "tall" and fn.launches == fn.tall_launches == 1
        vk, gk, vp, gp = (t.cpu().numpy() for t in (vk, gk, vp, gp))
        assert vk.shape == (n,) and gk.shape == (n, 7)
        assert np.isfinite(vk).all() and np.isfinite(gk).all()
        _close_values(vk, vp, float(ops.c), tiers[0])
        assert grad_gate_violation(gk, gp) <= 0.0
        assert gk[0, 2] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("tiers", BF16_PAIRS, ids=[f"{a}-{b}" for a, b in BF16_PAIRS])
def test_k3_below_the_crossover_keeps_the_16_row_kernel(cuda, tiers):
    """Below the crossover (one row short of it, HMC's 4096 walkers, a
    single row), and at any batch at the bf16 pairs the tall kernel is not
    built for, a call runs ``fused_gram_mma.cu`` as before: bit for bit
    its direct launch, the tall count unmoved."""
    m, obs, _ = _model((288, 352, 288, 224), cuda)
    fn = make_fused_loglik_grad_gram(m.config, m.normalizer, obs, 25.0, precision=tiers[0],
                                     grad_precision=tiers[1], device=cuda)
    ops = fn.operands(m.params)
    assert (fn.tall_plan is not None) == (tiers in TALL_PAIRS)
    first = fused_loglik.tall_crossover(fn.sm_count) - 1 if fn.tall_plan else 65_536
    for n in (first, 4096, 1):
        x = _prior_rows(n, cuda)
        got = fn(m.params, x)
        want = fused_loglik._loglik_grad_gram_cuda(ops, x)
        assert fn.batch_route(n) == "mma" and fn.tall_launches == 0
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_k3_tall_launch_is_found_as_k3_and_counted(cuda):
    """One profiled call at 65,536 rows shows a single launch, under a
    name the benchmark's K3 pattern finds (``port_bench/readers.py``) and
    its K2 pattern does not, and the route counter counts it."""
    from port_bench import readers, trace
    from tpu21cmvae_torch.utils.profiling import recording

    m, obs, _ = _model((288, 352, 288, 224), cuda)
    fn = make_fused_loglik_grad_gram(m.config, m.normalizer, obs, 25.0, precision="high",
                                     grad_precision="default", device=cuda)
    x = _prior_rows(65_536, cuda)
    fn(m.params, x)
    torch.cuda.synchronize()
    with trace.profiled() as out, recording() as rec:
        fn(m.params, x)
        torch.cuda.synchronize()
    kernels = [name for name, _, _, kind in out["device"] if kind == "kernel"]
    k3 = [name for name in kernels if readers.KERNELS["k3"].search(name)]
    assert len(k3) == 1 and "tall" in k3[0], kernels
    assert not readers.KERNELS["k2"].search(k3[0])
    assert rec.counters.get("k3.route.tall") == 1 and "k3.route.mma" not in rec.counters


# the benchmark configurations' prior box (port_bench/configs/*.json)
BOX_CELL = np.array([[1e-4, 0.5], [4.2, 100.0], [1e-4, 1000.0], [0.04, 0.09], [1.0, 1.5],
                     [0.1, 3.0], [10.0, 50.0]])


@pytest.mark.cuda
def test_ensemble_hmc_at_65536_walkers_holds_to_the_float64_mixture(cuda):
    """The shipped three-member ensemble's HMC at the published widths and
    65,536 walkers (100 + 200, the benchmark's ``ensemble-hmc-65k``),
    through the member-batched K3 at (bf16x3, bf16), against the plain
    float64 mixture (``port_bench/reference_ensemble.py``), in blocks:
    the carried log-density at the final walkers less the log-Jacobian,
    and the mixture's value and gradient there, under the cell's own
    limits (set between the program's sound runs and the control's,
    PERF.md §2), which the control (the reference at bf16, its gradient at
    fp8 e4m3) fails. Every K3 call is one launch at a batch the tall
    kernel takes on one model, so ``k3.tall_declined`` counts each."""
    import json
    import os

    from port_bench.reference import in_blocks, jacobian_logdet
    from port_bench.reference_ensemble import MixtureReference
    from tpu21cmvae_torch.models.ensemble import DeepEnsemble
    from tpu21cmvae_torch.utils.profiling import recording

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    directory = os.path.join(root, "pretrained", "ensemble_direct")
    with open(os.path.join(root, "port_bench", "workloads", "ensemble-hmc-65k.json")) as fh:
        limits = {k: v["limit"] for k, v in json.load(fh)["limits"].items()}
    ens = DeepEnsemble.load(directory, device=cuda)
    ref = MixtureReference(directory, device=cuda)
    rng = np.random.default_rng(26)
    truth = BOX_CELL[:, 0] + rng.uniform(0.05, 0.95, (1, 7)) * (BOX_CELL[:, 1] - BOX_CELL[:, 0])
    obs = (ref.forward(truth).cpu().numpy()[0] + rng.normal(0, 5.0, 451)).astype(np.float32)
    valgrad = ens._hmc_valgrad(obs, 25.0)
    valgrad.launches = 0
    with recording() as rec:
        res = ens.sample_posterior(obs, 25.0, sampler="hmc", bounds=BOX_CELL.astype(np.float32),
                                   n_walkers=65_536, n_warmup=100, n_steps=200, seed=1)
        torch.cuda.synchronize()
    calls = sum(n for k, n in rec.counters.items() if k.startswith("k3.route."))
    assert calls == valgrad.launches > 300 and rec.counters["k3.route.mma"] == calls
    assert rec.counters["k3.tall_declined"] == calls
    assert sum(s.name == "mixture" for s in rec.spans) == calls

    lo, hi = torch.as_tensor(BOX_CELL.astype(np.float32), dtype=torch.float64).T
    x = torch.as_tensor(res.final, dtype=torch.float64)
    f = (x - lo) / (hi - lo)
    inside = torch.all((f > 1e-4) & (f < 1 - 1e-4), dim=-1)
    jac = jacobian_logdet(x, lo, hi)

    def q999(lp):
        return float(torch.quantile(torch.abs(lp - want)[inside], 0.999))

    want = in_blocks(lambda r: ref.loglik(r, obs, 25.0), res.final) + jac
    assert q999(torch.as_tensor(res.logp, dtype=torch.float64)) <= limits["logp_gap_q999"]
    assert q999(in_blocks(lambda r: ref.loglik(r, obs, 25.0, "bf16"), res.final) + jac) > (
        limits["logp_gap_q999"])
    xf = torch.as_tensor(res.final, device=cuda)
    with torch.no_grad():
        ll, g = valgrad(ens.params, xf)
    assert q999(ll.double().cpu() + jac) <= limits["logp_gap_q999"]
    _, g_ref = in_blocks(lambda r: ref.loglik_and_grad(r, obs, 25.0), res.final)
    _, g_ctrl = in_blocks(lambda r: ref.loglik_and_grad(r, obs, 25.0, "bf16", "fp8"), res.final)

    def grad_err(gg):
        rel = torch.linalg.vector_norm(gg.double().cpu() - g_ref, dim=-1) / (
            torch.linalg.vector_norm(g_ref, dim=-1))
        return float(torch.quantile(rel, 0.99))

    assert grad_err(g) <= limits["grad_err"] < grad_err(g_ctrl)

