"""Folds, precision tiers, likelihoods and the analytic gradient of the
PyTorch port, held to the JAX package on the same weights and inputs.

Tolerances: "test_loglik tolerance" is ``tests/test_loglik.py:468-472``
(values rtol 2e-4, atol 2e-3·max|v|; gradients rtol 2e-3, atol
2e-3·max|g|) — the bound between two implementations of one tier whose
summation orders differ, on the gram form's cancellation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu21cmvae.models.direct import DirectEmulator as JaxEmulator
from tpu21cmvae.ops.loglik import make_loglik as jax_make_loglik
from tpu21cmvae.ops.loglik import make_loglik_and_grad as jax_make_loglik_and_grad
from tpu21cmvae.ops.pallas.fused_loglik import make_fused_loglik_gram as jax_fused_gram
from tpu21cmvae.sampling._common import valgrad_from_loglik as jax_valgrad_from_loglik
from tpu21cmvae.utils.config import DirectEmulatorConfig as JaxConfig
from tpu21cmvae_torch.models.direct import DirectEmulator
from tpu21cmvae_torch.ops import fold
from tpu21cmvae_torch.ops.kernels.fused_loglik import make_fused_loglik_gram
from tpu21cmvae_torch.ops.loglik import KernelLoglik, make_loglik, make_loglik_and_grad
from tpu21cmvae_torch.sampling._common import valgrad_from_loglik
from tpu21cmvae_torch.utils.config import DirectEmulatorConfig

SMALL = (32, 48, 32, 24)


@pytest.fixture(scope="module")
def pair(splits):
    """The same small model in both packages, and an observation."""
    jm = JaxEmulator(splits, config=JaxConfig(hidden_dims=SMALL), seed=1)
    tm = DirectEmulator.from_numpy(
        jax.tree_util.tree_map(np.asarray, jm.params),
        jax.tree_util.tree_map(np.asarray, jm.normalizer),
        config=DirectEmulatorConfig(hidden_dims=SMALL), device="cpu",
    )
    sig = jm.predict(splits.par_test[0])
    obs = (sig + np.random.default_rng(5).normal(0, 5.0, sig.shape)).astype(np.float32)
    return jm, tm, obs


def _raw(splits, n, fx_zero_row=None):
    raw = np.asarray(splits.par_test[:n], np.float32).copy()
    if fx_zero_row is not None:
        raw[fx_zero_row, 2] = 0.0
    return raw


def _close_values(got, want):
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-3 * np.abs(want).max())


def _close_grads(got, want):
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3 * np.abs(want).max())


def test_fold_constants_exact(pair, splits):
    """Folding the normalizer into the first/last layers reproduces
    par_transform → mlp → unpreproc (``tests/test_pallas.py::
    test_fold_constants_exact``), and the folds equal the JAX folds."""
    from tpu21cmvae.ops.pallas.fused_mlp import fold_emulator_constants as jfold
    from tpu21cmvae_torch.ops.mlp import mlp_apply
    from tpu21cmvae_torch.ops.transforms import par_transform, unpreproc

    jm, tm, _ = pair
    raw = torch.as_tensor(_raw(splits, 17))
    ref = unpreproc(mlp_apply(tm.params, par_transform(raw, tm.normalizer)), tm.normalizer)
    folded = fold.fold_emulator_constants(tm.params, tm.normalizer)
    got = mlp_apply(folded, fold._log_clamp(raw))
    np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(),
                               rtol=2e-4, atol=2e-3)
    for mine, theirs in zip(folded, jfold(jm.params, jm.normalizer)):
        for k in ("w", "b"):
            np.testing.assert_allclose(mine[k].detach().numpy(), np.asarray(theirs[k]),
                                       rtol=1e-5, atol=1e-6)


def test_gram_fold_identity_and_parity(pair):
    """h·G·hᵀ + 2h·u + c == ‖h@W + b‖² (``tests/test_loglik.py::
    test_gram_fold_identity``), and (G, u, c) equal the JAX gram fold."""
    from tpu21cmvae.ops.pallas.fused_loglik import gram_fold as jgram
    from tpu21cmvae.ops.pallas.fused_loglik import noise_scale as jscale

    jm, tm, obs = pair
    with torch.no_grad():
        scale = fold.noise_scale(25.0, 451, device="cpu")
        trunk, G, u, c = fold.gram_fold(tm.params, tm.normalizer, torch.as_tensor(obs), scale)
        *ftrunk, last = fold.fold_loglik_constants(
            tm.params, tm.normalizer, torch.as_tensor(obs), scale)
    assert len(trunk) == len(ftrunk) == len(SMALL)
    h = torch.randn(17, last["w"].shape[0], generator=torch.Generator().manual_seed(3))
    want = torch.sum((h @ last["w"] + last["b"]) ** 2, dim=-1)
    got = torch.sum((h @ G + 2.0 * u) * h, dim=-1) + c
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4)
    _, jG, ju, jc = jgram(jm.params, jm.normalizer, jnp.asarray(obs), jscale(25.0, 451))
    for mine, theirs in ((G, jG), (u, ju)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=1e-5,
                                   atol=1e-5 * float(mine.abs().max()))
    assert float(c) == pytest.approx(float(jc), rel=1e-5)


def test_fold_loglik_constants_exact(pair, splits):
    """The folded network's output is the whitened residual (pred − obs)/σ."""
    from tpu21cmvae_torch.ops.mlp import mlp_apply

    _, tm, obs = pair
    raw = _raw(splits, 9)
    scale = fold.noise_scale(25.0, 451, device="cpu")
    folded = fold.fold_loglik_constants(tm.params, tm.normalizer, torch.as_tensor(obs), scale)
    r = mlp_apply(folded, fold._log_clamp(torch.as_tensor(raw))).detach().numpy()
    want = (tm.predict(raw) - obs) / 5.0
    np.testing.assert_allclose(r, want, rtol=2e-4, atol=2e-3)


def test_tier_split_and_names_match_jax():
    """The integer-mask hi/lo split and the bf16 rounding are bit-for-bit
    the JAX package's (``fused_mlp.py::_split_hi_lo``)."""
    from tpu21cmvae.ops.pallas.fused_mlp import _split_hi_lo as jsplit

    x = np.random.default_rng(0).normal(size=(64, 33)).astype(np.float32) * 37.0
    x[0, :4] = [0.0, -0.0, 1e-30, 3.0e38]
    hi, lo = fold._split_hi_lo(torch.as_tensor(x))
    jhi, jlo = jsplit(jnp.asarray(x))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi, np.float32))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo, np.float32))
    np.testing.assert_array_equal(
        fold.bf16_round(torch.as_tensor(x)).numpy(),
        np.asarray(jnp.asarray(x).astype(jnp.bfloat16), np.float32),
    )
    assert [fold.resolve_tier(p) for p in ("highest", "contract", "HIGH", "default")] == [
        "f32", "f32", "bf16x3", "bf16"]
    assert fold.resolve_tier(None, "highest") == "f32"
    with pytest.raises(ValueError, match="precision"):
        fold.resolve_tier("high-split")
    a, w = x[1:4], x[1:34, :5]
    exact = a.astype(np.float64) @ w
    bound = np.abs(a).astype(np.float64) @ np.abs(w)  # Σ|products|
    for tier, rel in (("f32", 1e-6), ("bf16x3", 1e-5), ("bf16", 1e-2)):
        got = fold.tier_matmul(torch.as_tensor(a), fold.prepare_operand(torch.as_tensor(w), tier),
                               tier).numpy()
        assert (np.abs(got - exact) <= rel * bound).all(), tier


@pytest.mark.parametrize("method", ["direct", "gram"])
@pytest.mark.parametrize("precision", ["highest", "high"])
def test_make_loglik_matches_jax(pair, splits, method, precision):
    """Both methods at the exact and bf16x3 tiers, against JAX XLA at the
    same tier name (XLA computes HIGH in full fp32 on the CPU), on a batch
    with an fx = 0 row."""
    jm, tm, obs = pair
    raw = _raw(splits, 33, fx_zero_row=2)
    want = np.asarray(jax_make_loglik(jm.config, jm.normalizer, obs, 25.0, method=method,
                                      precision=precision)(jm.params, jnp.asarray(raw)))
    fn = make_loglik(tm.config, tm.normalizer, obs, 25.0, method=method, precision=precision)
    got = fn(tm.params, torch.as_tensor(raw)).detach().numpy()
    assert got.shape == (33,)
    _close_values(got, want)
    one = fn(tm.params, torch.as_tensor(raw[0])).detach().numpy()
    assert one.shape == (1,)
    _close_values(one, want[:1])


def test_analytic_gram_grad_matches_autodiff_and_jax(pair, splits):
    """Hand-written backward == torch.autograd through the same gram
    forward (``tests/test_loglik.py:418-422``: values rtol 1e-6, gradients
    rtol 1e-5, atol 1e-6·max|g|) == the JAX analytic variant (test_loglik
    tolerance); the fx = 0 clamp gives exactly 0 in slot 2."""
    jm, tm, obs = pair
    raw = _raw(splits, 65, fx_zero_row=3)
    kw = dict(precision="highest", grad_precision="highest")
    va, ga = make_loglik_and_grad(tm.config, tm.normalizer, obs, 25.0,
                                  variant="analytic", **kw)(tm.params, torch.as_tensor(raw))
    vd, gd = make_loglik_and_grad(tm.config, tm.normalizer, obs, 25.0,
                                  variant="autodiff", precision="highest")(
        tm.params, torch.as_tensor(raw))
    va, ga, vd, gd = (t.detach().numpy() for t in (va, ga, vd, gd))
    np.testing.assert_allclose(va, vd, rtol=1e-6)
    np.testing.assert_allclose(ga, gd, rtol=1e-5, atol=1e-6 * np.abs(gd).max())
    assert ga[3, 2] == 0.0 and gd[3, 2] == 0.0
    vj, gj = jax_make_loglik_and_grad(jm.config, jm.normalizer, obs, 25.0,
                                      variant="analytic", **kw)(jm.params, jnp.asarray(raw))
    _close_values(va, np.asarray(vj))
    _close_grads(ga, np.asarray(gj))
    # the direct method's autodiff gradient agrees with the gram one
    vdd, gdd = make_loglik_and_grad(tm.config, tm.normalizer, obs, 25.0, method="direct",
                                    precision="highest")(tm.params, torch.as_tensor(raw))
    _close_values(vdd.numpy(), va)
    _close_grads(gdd.numpy(), ga)


def test_perbin_noise_vector(pair, splits):
    """A (451,) σ² vector weights the bins the same way in both packages."""
    jm, tm, obs = pair
    nv = np.linspace(4.0, 100.0, 451).astype(np.float32)
    raw = _raw(splits, 16, fx_zero_row=0)
    for method in ("direct", "gram"):
        want = np.asarray(jax_make_loglik(jm.config, jm.normalizer, obs, nv, method=method,
                                          precision="highest")(jm.params, jnp.asarray(raw)))
        got = make_loglik(tm.config, tm.normalizer, obs, nv, method=method,
                          precision="highest")(tm.params, torch.as_tensor(raw))
        _close_values(got.detach().numpy(), want)
    vj, gj = jax_make_loglik_and_grad(jm.config, jm.normalizer, obs, nv, precision="highest",
                                      grad_precision="highest")(jm.params, jnp.asarray(raw))
    vt, gt = make_loglik_and_grad(tm.config, tm.normalizer, obs, nv, precision="highest",
                                  grad_precision="highest")(tm.params, torch.as_tensor(raw))
    _close_values(vt.numpy(), np.asarray(vj))
    _close_grads(gt.numpy(), np.asarray(gj))


def test_grad_finite_difference(pair, splits):
    """The analytic gradient agrees with central differences of the value
    (``tests/test_loglik.py::test_grad_finite_difference``)."""
    _, tm, obs = pair
    base = make_loglik(tm.config, tm.normalizer, obs, 25.0, method="gram",
                       precision="highest")
    ana = make_loglik_and_grad(tm.config, tm.normalizer, obs, 25.0, precision="highest",
                               grad_precision="highest")
    theta = np.asarray(splits.par_test[1], np.float64)
    base = torch.no_grad()(base)
    g = ana(tm.params, torch.as_tensor(theta, dtype=torch.float32))[1].numpy()[0]
    for j in range(7):
        h = 1e-3 * max(abs(theta[j]), 1e-3)
        tp, tmn = theta.copy(), theta.copy()
        tp[j] += h
        tmn[j] -= h
        fd = (float(base(tm.params, torch.as_tensor(tp, dtype=torch.float32))[0])
              - float(base(tm.params, torch.as_tensor(tmn, dtype=torch.float32))[0])) / (2 * h)
        assert abs(g[j] - fd) <= 2e-2 * (abs(fd) + np.abs(g).mean() + 1.0), (j, g[j], fd)


def test_refusals(pair):
    _, tm, obs = pair
    cfg, norm = tm.config, tm.normalizer

    class Unknown:  # not a noise spec of the port: refused by type
        pass

    with pytest.raises(TypeError, match="noise_var"):
        make_loglik(cfg, norm, obs, Unknown())
    with pytest.raises(TypeError, match="noise_var"):
        make_loglik_and_grad(cfg, norm, obs, Unknown(), backend="kernel")
    with pytest.raises(ValueError):
        make_loglik(cfg, norm, obs, np.ones(450))
    with pytest.raises(ValueError, match="backend"):
        make_loglik(cfg, norm, obs, backend="cuda")
    with pytest.raises(ValueError, match="method"):
        make_loglik(cfg, norm, obs, method="cholesky")
    with pytest.raises(NotImplementedError, match="ReLU"):
        make_loglik(DirectEmulatorConfig(hidden_dims=SMALL, activation="tanh"), norm, obs,
                    backend="kernel")
    with pytest.raises(ValueError, match="variant"):
        make_loglik_and_grad(cfg, norm, obs, variant="nope")
    with pytest.raises(ValueError, match="analytic"):
        make_loglik_and_grad(cfg, norm, obs, method="direct", variant="analytic")
    with pytest.raises(ValueError, match="gram"):
        make_loglik_and_grad(cfg, norm, obs, backend="kernel", method="direct")
    with pytest.raises(ValueError, match="precision"):
        make_loglik(cfg, norm, obs, precision="high-stacked")


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_plain_k2_matches_pallas_k2(pair, splits, precision):
    """K2's plain version against the JAX package's Pallas K2 (interpret
    mode, one 40-row grid step) on 37 rows with an fx == 0 row, at
    test_loglik tolerance; the wrapper ran no kernel on CPU tensors."""
    jm, tm, obs = pair
    raw = _raw(splits, 37, fx_zero_row=5)
    want = np.asarray(jax_fused_gram(jm.config, jm.normalizer, obs, 25.0, precision=precision,
                                     block_rows=40, interpret=True)(jm.params, jnp.asarray(raw)))
    fn = make_fused_loglik_gram(tm.config, tm.normalizer, obs, 25.0, precision=precision,
                                device="cpu")
    got = fn(tm.params, torch.as_tensor(raw)).numpy()
    assert got.shape == (37,) and np.isfinite(got).all()
    _close_values(got, want)
    assert fn.launches == 0
    assert fn.operands(tm.params).wt == ()  # K2 never reads the backward operands
    assert fn(tm.params, torch.as_tensor(raw[5])).shape == (1,)


@pytest.mark.parametrize("method", ["direct", "gram"])
def test_kernel_backend_on_cpu_equals_torch_backend(pair, splits, method):
    """``loglik_fn(backend="kernel")`` runs K1/K2's plain version on CPU
    tensors: the same values as ``backend="torch"``, one memoised object
    whose launch count stays 0."""
    _, tm, obs = pair
    raw = torch.as_tensor(_raw(splits, 29, fx_zero_row=1))
    kern = tm.loglik_fn(obs, 25.0, backend="kernel", method=method)
    assert isinstance(kern, KernelLoglik)
    assert tm.loglik_fn(obs, 25.0, backend="kernel", method=method) is kern
    with torch.no_grad():
        got = kern(tm.params, raw).numpy()
        want = tm.loglik_fn(obs, 25.0, method=method)(tm.params, raw).numpy()
    _close_values(got, want)
    if method == "gram":  # the same folds and products in the same order
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    assert kern.launches == 0
    kern.launches = 5
    assert kern.fused.launches == 5


@pytest.mark.parametrize("method", ["direct", "gram"])
@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_loglik_fn_gradient_matches_jax_autodiff(pair, splits, method, backend):
    """``loglik_fn`` is differentiable again (it ran under no_grad):
    ``valgrad_from_loglik`` over it — through the kernel backend's
    autograd.Function, whose backward is the plain twin's — matches JAX's
    ``valgrad_from_loglik(jm.loglik_fn(...))`` at the default bf16x3 tier
    (JAX's XLA HIGH is fp32 on the CPU), rtol 2e-3; the fx == 0 slot is 0.
    The weight gradient of one layer matches ``jax.grad`` too."""
    jm, tm, obs = pair
    raw = _raw(splits, 33, fx_zero_row=4)
    vj, gj = jax_valgrad_from_loglik(jm.loglik_fn(obs, 25.0, method=method))(
        jm.params, jnp.asarray(raw))
    fn = tm.loglik_fn(obs, 25.0, backend=backend, method=method)
    vt, gt = valgrad_from_loglik(fn)(tm.params, torch.as_tensor(raw))
    assert not vt.requires_grad
    _close_values(vt.numpy(), np.asarray(vj))
    _close_grads(gt.numpy(), np.asarray(gj))
    assert gt[4, 2] == 0.0
    wj = jax.grad(lambda p: jnp.sum(jm.loglik_fn(obs, 25.0, method=method)(
        p, jnp.asarray(raw))))(jm.params)[1]["w"]
    (wt,) = torch.autograd.grad(fn(tm.params, torch.as_tensor(raw)).sum(), tm.params[1]["w"])
    _close_grads(wt.numpy(), np.asarray(wj))


def test_tier_dense_gradient_keeps_the_tier():
    """Autograd through the bf16x3 split alone dropped the ``w_lo``
    term (the integer mask passes no gradient); ``tier_dense`` gives the
    gradient of the exact product to the bf16x3 tier's accuracy, and the
    single-pass bf16 gradient to bf16's."""
    rng = np.random.default_rng(2)
    a = torch.tensor(rng.normal(size=(16, 40)), dtype=torch.float32, requires_grad=True)
    w = torch.tensor(rng.normal(size=(40, 24)), dtype=torch.float32, requires_grad=True)
    g = torch.tensor(rng.normal(size=(16, 24)), dtype=torch.float32)
    a64, w64, g64 = (t.detach().double() for t in (a, w, g))
    want = (g64 @ w64.T, a64.T @ g64)
    bound = (g64.abs() @ w64.abs().T, a64.abs().T @ g64.abs())  # Σ|products|
    # per product: bf16x3 drops lo·lo and rounds lo once (≤ ~2⁻¹⁵ of
    # |a·w|), bf16 rounds both operands (≤ ~2⁻⁷)
    for tier, rel in (("f32", 1e-6), ("bf16x3", 3e-5), ("bf16", 1e-2)):
        got = torch.autograd.grad(fold.tier_dense(a, w, tier), (a, w), g)
        for mine, ref, b in zip(got, want, bound):
            assert ((mine.double() - ref).abs() <= rel * b).all(), tier
    split = fold.tier_matmul(a, fold.prepare_operand(w, "bf16x3"), "bf16x3")
    ga, _ = torch.autograd.grad(split, (a, w), g)
    assert ((ga.double() - want[0]).abs() > 1e-3 * bound[0]).any()  # the fault
