"""Foreground marginalization in the PyTorch port
(``tpu21cmvae_torch/foregrounds.py`` and the folds that take its dense
whitening), held to the JAX package on the same weights and inputs, case
for case with ``tests/test_foregrounds.py``.

Tolerances: ``marginalize_foreground`` fields bit-equal; folds 1e-5
relative (to each array's largest entry); likelihood values on every
backend, method and variant within ``2e-3·max|logL|`` of the JAX value
(the JAX suite's own bound), exact-tier torch against exact-tier XLA
within 1e-5 of ``max|logL|``; gradients within ``2e-3·max|g|``.

One exception, with its reason. The observation ``obs`` carries a
1.5·10³ mK foreground, and ``(b − obs) @ R`` projects it out in float32:
each entry of the folded bias is a sum of 451 products of size ~10¹ that
cancel to ~1. Two fp32 summation orders of that sum (torch's and XLA's)
differ by ~1e-3 of the folded bias and ~1.3e-4 of ``max|logL|`` (measured
here; the JAX suite allows 1e-3 of drift for the same cancellation,
``tests/test_foregrounds.py:83-98``). So the 1e-5 comparisons are made on
``obs_clean`` (the same signal and noise, no foreground injected), where
nothing cancels, and on ``obs`` the folded bias is held to 1e-5 of its
sum of ABSOLUTE products (the dot product's error scale), ``u`` and ``c``
to what that lets through, and the values to the JAX suite's 2e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_pair import make_pair, one_torch_thread, train_box  # noqa: F401

from tpu21cmvae import foregrounds as jfg
from tpu21cmvae.ops.loglik import make_loglik as jax_make_loglik
from tpu21cmvae.ops.loglik import make_loglik_and_grad as jax_make_loglik_and_grad
from tpu21cmvae.ops.loglik import make_loglik_and_grad_from_predict as jax_grad_from_predict
from tpu21cmvae.ops.loglik import make_loglik_from_predict as jax_from_predict
from tpu21cmvae.ops.pallas import fused_loglik as jfused
from tpu21cmvae_torch import foregrounds as tfg
from tpu21cmvae_torch.ops import fold
from tpu21cmvae_torch.ops.loglik import (
    make_loglik,
    make_loglik_and_grad,
    make_loglik_and_grad_from_predict,
    make_loglik_from_predict,
)
from tpu21cmvae_torch.ops.mlp import mlp_apply
from tpu21cmvae_torch.ops.transforms import par_transform, unpreproc

HIDDEN = (32, 24)  # tests/test_foregrounds.py:31-35
A_TRUE = np.array([1500.0, -120.0, 40.0, -8.0, 2.0])


@pytest.fixture(scope="module")
def tiny(splits):
    """Both models, the linlog basis, the truth signal and an observation
    ``signal + F·a_true + N(0, 25)``."""
    jm, tm = make_pair(splits, HIDDEN)
    F = tfg.linlog_basis(tm.frequencies, 5)
    sig = tm.predict(splits.par_test[0])
    obs = (sig + F @ A_TRUE + _noise(sig)).astype(np.float32)
    return jm, tm, F, sig, obs


def _noise(sig):
    return np.random.default_rng(1).normal(0, 5, sig.shape)


@pytest.fixture(scope="module")
def obs_clean(tiny):
    """``tiny``'s observation without the injected foreground."""
    sig = tiny[3]
    return (sig + _noise(sig)).astype(np.float32)


def _theta(tm, n=8):
    return np.asarray(tm.data.par_test[:n], np.float32)


def _values(fn, params, theta):
    with torch.no_grad():
        return fn(params, torch.as_tensor(theta)).numpy().astype(np.float64)


def _brute_force_marginal(pred, obs, F, nv, pv):
    """float64 reference: logN(d; m(θ), N + F·S·Fᵀ) + ½log|2πN|."""
    r = np.asarray(pred, np.float64) - np.asarray(obs, np.float64)
    n_diag = np.full(F.shape[0], float(nv))
    C = np.diag(n_diag) + F @ np.diag(pv) @ F.T
    return (-0.5 * np.einsum("bi,ij,bj->b", r, np.linalg.inv(C), r)
            - 0.5 * (np.linalg.slogdet(C)[1] - np.sum(np.log(n_diag))))


@pytest.mark.parametrize("prior_var", [None, 1e6, "vector"])
def test_marginalize_foreground_fields_bit_equal(tiny, prior_var):
    """The NumPy copy builds the JAX module's spec bit for bit: ``whiten``,
    ``log_norm``, ``memo_key``, on the model's own axis and entry point."""
    jm, tm, F, _, _ = tiny
    nv = np.linspace(4.0, 60.0, 451)
    for k, kw in ((5, dict(basis=F)), (4, dict(n_terms=4, basis="powerlaw", nu_ref=90.0))):
        pv = np.linspace(1e3, 1e6, k) if prior_var == "vector" else prior_var
        want = jm.marginalize_foreground(nv, prior_var=pv, **kw)
        got = tm.marginalize_foreground(nv, prior_var=pv, **kw)
        assert got.whiten.dtype == np.float32
        assert got.whiten.tobytes() == want.whiten.tobytes()
        assert got.log_norm == want.log_norm
        assert got.memo_key() == want.memo_key()
        assert got.n_terms == want.n_terms
        np.testing.assert_array_equal(got.basis, want.basis)


@pytest.mark.parametrize("injected", [False, True])
def test_folds_match_jax(tiny, obs_clean, injected):
    """``noise_scale``, ``noise_log_norm``, ``fold_loglik_constants`` and
    ``gram_fold`` under the dense whitening equal the JAX folds: 1e-5 of
    each array's largest entry without a foreground in the observation;
    with one, the folded bias within 1e-5 of its sum of absolute products
    (module docstring), and ``u``, ``c`` within what that lets through.
    The gram identity holds."""
    jm, tm, F, _, obs = tiny
    obs = obs if injected else obs_clean
    mn_t = tm.marginalize_foreground(25.0, basis=F)
    mn_j = jm.marginalize_foreground(25.0, basis=F)
    scale = fold.noise_scale(mn_t, 451, device="cpu")
    jscale = jfused.noise_scale(mn_j, 451)
    assert scale.shape == (451, 451) and scale.dtype == torch.float32
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    assert fold.noise_log_norm(mn_t) == jfused.noise_log_norm(mn_j) == mn_j.log_norm
    assert fold.noise_log_norm(25.0) == 0.0
    with torch.no_grad():
        folded = fold.fold_loglik_constants(tm.params, tm.normalizer, torch.as_tensor(obs), scale)
        trunk, G, u, c = fold.gram_fold(tm.params, tm.normalizer, torch.as_tensor(obs), scale)
        plain = fold.fold_emulator_constants(tm.params, tm.normalizer)[-1]
        # Σ|products| of the folded bias, and what 1e-5 of it moves u and c by
        b_tol = 1e-5 * ((plain["b"] - torch.as_tensor(obs)).abs() @ scale.abs()).numpy()
    jfolded = jfused.fold_loglik_constants(jm.params, jm.normalizer, jnp.asarray(obs), jscale)
    _, jG, ju, jc = jfused.gram_fold(jm.params, jm.normalizer, jnp.asarray(obs), jscale)
    jw, jb = np.asarray(jfolded[-1]["w"]), np.asarray(jfolded[-1]["b"])

    def rel(a):
        return 1e-5 * np.abs(a).max()

    for mine, theirs in zip(folded[:-1], jfolded[:-1]):
        for k in ("w", "b"):
            want = np.asarray(theirs[k])
            np.testing.assert_allclose(mine[k].detach().numpy(), want, rtol=0, atol=rel(want))
    w, b = folded[-1]["w"], folded[-1]["b"]
    np.testing.assert_allclose(w.numpy(), jw, rtol=0, atol=rel(jw))
    np.testing.assert_allclose(G.numpy(), np.asarray(jG), rtol=0, atol=rel(jG))
    if injected:
        assert (np.abs(b.numpy() - jb) <= b_tol).all()
        assert (np.abs(u.numpy() - np.asarray(ju)) <= np.abs(jw) @ b_tol + rel(ju)).all()
        assert abs(float(c) - float(jc)) <= 2.0 * np.abs(jb) @ b_tol + 1e-5 * float(jc)
        assert np.abs(b.numpy() - jb).max() > rel(jb)  # the cancellation is real
    else:
        np.testing.assert_allclose(b.numpy(), jb, rtol=0, atol=rel(jb))
        np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0, atol=rel(ju))
        assert float(c) == pytest.approx(float(jc), rel=1e-5)
    assert len(trunk) == len(HIDDEN)
    h = torch.randn(9, w.shape[0], generator=torch.Generator().manual_seed(3))
    np.testing.assert_allclose((torch.sum((h @ G + 2.0 * u) * h, dim=-1) + c).numpy(),
                               torch.sum((h @ w + b) ** 2, dim=-1).numpy(), rtol=1e-4)


@pytest.mark.parametrize("injected", [False, True])
def test_matches_brute_force_marginal(tiny, obs_clean, injected):
    """Proper-prior marginalized likelihood == the float64 marginal
    Gaussian, on the direct, gram and from_predict paths; each equals the
    JAX value at the exact tier, to 1e-5 of max|logL| without a foreground
    in the observation and to the JAX suite's bound with one (module
    docstring)."""
    jm, tm, F, _, obs = tiny
    obs = obs if injected else obs_clean
    pv = np.full(5, 1e6)
    mn_t = tm.marginalize_foreground(25.0, basis=F, prior_var=pv)
    mn_j = jm.marginalize_foreground(25.0, basis=F, prior_var=pv)
    theta = _theta(tm)
    ref = _brute_force_marginal(tm.predict(theta), obs, F, 25.0, pv)
    scale = np.abs(ref).max()
    parity = (2e-3 if injected else 1e-5) * scale
    for method in ("direct", "gram"):
        ll = _values(tm.loglik_fn(obs, mn_t, method=method, precision="highest"),
                     tm.params, theta)
        assert np.abs(ll - ref).max() < 2e-3 * scale, method
        want = np.asarray(jm.loglik_fn(obs, mn_j, method=method, precision="highest")(
            jm.params, theta), np.float64)
        assert np.abs(ll - want).max() < parity, method
    gen = make_loglik_from_predict(tm.predict_fn("highest"), obs, mn_t, device="cpu")
    ll = _values(gen, tm.params, theta)
    assert np.abs(ll - ref).max() < 2e-3 * scale
    want = np.asarray(jax_from_predict(jm.predict_fn("highest"), obs, mn_j)(jm.params, theta))
    assert np.abs(ll - want).max() < parity

    def predict(weights, raw):  # differentiable, unlike the model's no_grad predict_fn
        return unpreproc(mlp_apply(weights, par_transform(raw, tm.normalizer)), tm.normalizer)

    v, g = make_loglik_and_grad_from_predict(predict, obs, mn_t, device="cpu")(tm.params, theta)
    np.testing.assert_allclose(v.numpy(), ll, rtol=1e-6)
    _, gj = jax_grad_from_predict(jm.predict_fn("highest"), obs, mn_j)(jm.params, theta)
    assert not g.requires_grad
    assert np.abs(g.numpy() - np.asarray(gj)).max() < 2e-3 * np.abs(np.asarray(gj)).max()


def test_flat_prior_is_injection_invariant(tiny):
    """Flat coefficient prior → P annihilates the foreground columns, so
    ANY F·a added to the observation leaves logL unchanged (up to float32
    roundoff of the 1e4-scale injected spectrum), on both methods, while
    the plain likelihood moves by a huge margin."""
    _, tm, F, _, obs = tiny
    mn = tm.marginalize_foreground(25.0, basis=F)
    theta = _theta(tm)
    obs2 = (obs + (F @ np.random.default_rng(7).normal(0, 100, 5))).astype(np.float32)
    for method in ("gram", "direct"):
        base = _values(tm.loglik_fn(obs, mn, method=method, precision="highest"),
                       tm.params, theta)
        moved = _values(tm.loglik_fn(obs2, mn, method=method, precision="highest"),
                        tm.params, theta)
        assert np.abs(moved - base).max() < 1e-3 * np.abs(base).max(), method
    plain = _values(tm.loglik_fn(obs, 25.0, precision="highest"), tm.params, theta)
    plain2 = _values(tm.loglik_fn(obs2, 25.0, precision="highest"), tm.params, theta)
    assert np.abs(plain2 - plain).min() > 100.0


@pytest.mark.parametrize("prior_var", [None, 1e6])
def test_all_backends_agree(tiny, prior_var):
    """torch-direct / torch-gram / kernel-direct / kernel-gram (the
    kernels' plain versions on CPU tensors) at two tiers, and the
    analytic, kernel and autodiff value-and-gradient variants, agree with
    the JAX XLA direct value and autodiff gradient on a
    MarginalizedNoise; the JAX Pallas kernels (interpret mode, one small
    block) agree with the port's wrappers."""
    jm, tm, F, _, obs = tiny
    mn_t = tm.marginalize_foreground(25.0, basis=F, prior_var=prior_var)
    mn_j = jm.marginalize_foreground(25.0, basis=F, prior_var=prior_var)
    theta = _theta(tm)
    ref = np.asarray(jax_make_loglik(jm.config, jm.normalizer, obs, mn_j, method="direct",
                                     precision="highest")(jm.params, jnp.asarray(theta)))
    scale = np.abs(ref).max()
    for backend in ("torch", "kernel"):
        for method in ("direct", "gram"):
            for precision in ("highest", "high"):
                fn = make_loglik(tm.config, tm.normalizer, obs, mn_t, backend=backend,
                                 method=method, precision=precision)
                ll = _values(fn, tm.params, theta)
                assert np.abs(ll - ref).max() < 2e-3 * scale, (backend, method, precision)
                if backend == "kernel":
                    assert fn.launches == 0  # CPU tensors: the plain version ran
    for build, method in ((jfused.make_fused_loglik, "direct"),
                          (jfused.make_fused_loglik_gram, "gram")):
        want = np.asarray(build(jm.config, jm.normalizer, obs, mn_j, block_rows=8,
                                interpret=True, precision="highest")(
            jm.params, jnp.asarray(theta)))
        got = _values(make_loglik(tm.config, tm.normalizer, obs, mn_t, backend="kernel",
                                  method=method, precision="highest"), tm.params, theta)
        assert np.abs(got - want).max() < 2e-3 * scale, method
    vd, gd = jax_make_loglik_and_grad(jm.config, jm.normalizer, obs, mn_j, variant="autodiff",
                                      method="direct", precision="highest")(
        jm.params, jnp.asarray(theta))
    gscale = np.abs(np.asarray(gd)).max()
    variants = [dict(backend="torch"), dict(backend="kernel"),
                dict(backend="torch", variant="autodiff"),
                dict(backend="torch", variant="autodiff", method="direct")]
    for kw in variants:
        va, ga = make_loglik_and_grad(tm.config, tm.normalizer, obs, mn_t, precision="highest",
                                      **kw)(tm.params, torch.as_tensor(theta))
        assert not va.requires_grad and not ga.requires_grad
        assert np.abs(va.numpy() - np.asarray(vd)).max() < 2e-3 * scale, kw
        assert np.abs(ga.numpy() - np.asarray(gd)).max() < 2e-3 * gscale, kw
    vk, gk = jfused.make_fused_loglik_grad_gram(
        jm.config, jm.normalizer, obs, mn_j, block_rows=8, interpret=True, precision="highest")(
        jm.params, jnp.asarray(theta))
    assert np.abs(va.numpy() - np.asarray(vk)).max() < 2e-3 * scale
    assert np.abs(ga.numpy() - np.asarray(gk)).max() < 2e-3 * gscale


def test_coeff_posterior_recovers_injection(tiny):
    """GLS coefficient posterior pulls the injected foreground back out
    of a residual, within its own error bars; reconstruct() returns the
    matching spectrum; both equal the JAX module's on the same input."""
    jm, tm, F, sig, obs = tiny
    mn = tm.marginalize_foreground(25.0, basis=F)
    r = np.asarray(obs, np.float64) - sig
    mean, cov = mn.coeff_posterior(r)
    pull = np.abs(mean - A_TRUE) / np.sqrt(np.diag(cov))
    assert pull.max() < 4.0, pull
    rec = mn.reconstruct(mean)
    assert rec.shape == (F.shape[0],)
    assert np.abs(rec - F @ A_TRUE).max() < 10.0
    means, _ = mn.coeff_posterior(np.stack([r, r]))
    np.testing.assert_allclose(means[0], mean)
    jmean, jcov = jm.marginalize_foreground(25.0, basis=F).coeff_posterior(r)
    np.testing.assert_allclose(mean, jmean, rtol=1e-12)
    np.testing.assert_allclose(cov, jcov, rtol=1e-12)


def test_log_norm_shifts_evidence_not_posterior(tiny):
    """Posterior densities differ by a constant between prior_var choices,
    and the constant equals the two conventions' log_norm difference."""
    _, tm, F, _, obs = tiny
    theta = _theta(tm, 6)
    mn_wide = tm.marginalize_foreground(25.0, basis=F, prior_var=np.full(5, 1e8))
    mn_flat = tm.marginalize_foreground(25.0, basis=F)
    lw = _values(tm.loglik_fn(obs, mn_wide, precision="highest"), tm.params, theta)
    lf = _values(tm.loglik_fn(obs, mn_flat, precision="highest"), tm.params, theta)
    d = lw - lf
    assert d.max() - d.min() < 2e-3 * np.abs(lf).max()
    np.testing.assert_allclose(d.mean(), mn_wide.log_norm - mn_flat.log_norm, atol=0.05)


def test_memoization_and_validation(tiny):
    """Model-level memo keys distinguish MarginalizedNoise by VALUE, on
    both backends (two specs give two kernel wrappers, never one reused);
    input validation is loud."""
    _, tm, F, _, obs = tiny
    mn1 = tm.marginalize_foreground(25.0, basis=F)
    mn1b = tm.marginalize_foreground(25.0, basis=F)
    mn2 = tm.marginalize_foreground(25.0, basis=F, prior_var=np.full(5, 1e4))
    for backend in ("torch", "kernel"):
        assert tm.loglik_fn(obs, mn1, backend=backend) is tm.loglik_fn(obs, mn1b, backend=backend)
        assert tm.loglik_fn(obs, mn1, backend=backend) is not tm.loglik_fn(obs, mn2,
                                                                           backend=backend)
        assert tm.loglik_fn(obs, mn1, backend=backend) is not tm.loglik_fn(obs, 25.0,
                                                                           backend=backend)
    k3 = tm.loglik_and_grad_fn(obs, mn1, backend="kernel")
    assert k3 is tm.loglik_and_grad_fn(obs, mn1b, backend="kernel")
    assert k3 is not tm.loglik_and_grad_fn(obs, mn2, backend="kernel")
    with torch.no_grad():
        c1, c2 = (float(tm.loglik_and_grad_fn(obs, mn, backend="kernel").operands(tm.params).c)
                  for mn in (mn1, mn2))
    assert c1 != c2  # each wrapper folded its own spec
    with pytest.raises(ValueError, match="bins"):
        tfg.marginalize_foreground(F[:100], 25.0, n_bins=451)
    with pytest.raises(ValueError, match="positive"):
        tfg.marginalize_foreground(F, -1.0)
    with pytest.raises(ValueError, match="fewer"):
        tfg.marginalize_foreground(np.ones((4, 4)), 1.0)
    with pytest.raises(ValueError, match="singular|dependent"):
        tfg.marginalize_foreground(np.stack([F[:, 0], F[:, 0]], axis=1), 25.0)
    bad = tfg.MarginalizedNoise(whiten=np.eye(100, dtype=np.float32), log_norm=0.0,
                                basis=np.ones((100, 1)), noise_var=np.ones(100), prior_var=None)
    for backend in ("torch", "kernel"):
        for method in ("gram", "direct"):
            with pytest.raises(ValueError, match="bins"):
                tm.loglik_fn(obs, bad, memo=False, backend=backend, method=method)
    with pytest.raises(ValueError, match="bins"):
        tm.loglik_and_grad_fn(obs, bad, memo=False, backend="kernel")


def test_bases_shapes_and_conditioning():
    freqs = np.linspace(50.0, 200.0, 451)
    for kind in ("linlog", "powerlaw", "polynomial"):
        b = tfg.foreground_basis(freqs, 6, kind)
        assert b.shape == (451, 6) and np.isfinite(b).all()
        assert b.tobytes() == jfg.foreground_basis(freqs, 6, kind).tobytes()
        mn = tfg.marginalize_foreground(b, 1.0)
        assert np.isfinite(mn.log_norm)
        # P has exactly k zero eigenvalues (flat prior projects k dims)
        w64 = np.asarray(mn.whiten, np.float64)
        assert (np.linalg.eigvalsh(w64 @ w64.T) < 1e-9).sum() == 6
    with pytest.raises(ValueError, match="n_terms"):
        tfg.polynomial_basis(freqs, 0)
    with pytest.raises(ValueError, match="nu_ref"):
        tfg.foreground_basis(freqs, 3, "polynomial", nu_ref=100.0)
    with pytest.raises(ValueError, match="kind"):
        tfg.foreground_basis(freqs, 3, "sinusoid")
    b = tfg.powerlaw_basis(freqs, 3, nu_ref=100.0)
    assert abs(b[np.argmin(np.abs(freqs - 100.0)), 0] - 1.0) < 1e-2


def test_sampler_recovers_theta_under_foreground(tiny):
    """End to end: MH sampling with the marginalized likelihood
    concentrates near the true parameters even though the observation is
    dominated by a foreground the plain likelihood would chase."""
    _, tm, F, sig, obs = tiny
    mn = tm.marginalize_foreground(25.0, basis=F)
    res = tm.sample_posterior(obs, mn, sampler="mh", bounds=train_box(tm.data.par_train),
                              n_walkers=256, n_steps=150, n_warmup=100, seed=0)
    ll = _values(tm.loglik_fn(obs, mn, precision="highest"), tm.params, res.flat)
    pred = tm.predict(res.flat[np.argmax(ll)])
    # the marginalized fit explains the SIGNAL component: residual to
    # truth far below the foreground amplitude (~1e3 mK)
    assert np.abs(pred - sig).mean() < 50.0


def test_sample_noise_matches_whitened_form(tiny):
    """For draws from sample_noise, the whitened quadratic form is chi^2
    with n − K dof under the flat prior and n dof under a proper prior;
    the draws equal the JAX module's from the same generator."""
    jm, tm = tiny[0], tiny[1]
    n, n_draw = 451, 4000
    nv = np.full(n, 25.0)
    flat = tm.marginalize_foreground(nv, n_terms=5)
    x = flat.sample_noise(np.random.default_rng(42), n_draw, flat_coeff_scale=500.0)
    xj = jm.marginalize_foreground(nv, n_terms=5).sample_noise(
        np.random.default_rng(42), n_draw, flat_coeff_scale=500.0)
    np.testing.assert_array_equal(x, xj)
    z = x @ flat.whiten.astype(np.float64)
    dof = n - 5
    assert abs(np.einsum("bi,bi->b", z, z).mean() / dof - 1.0) < (
        5 * np.sqrt(2.0 / dof / n_draw) + 0.01)
    proper = tm.marginalize_foreground(nv, n_terms=5, prior_var=1e4)
    zp = proper.sample_noise(np.random.default_rng(43), n_draw) @ proper.whiten.astype(np.float64)
    assert abs(np.einsum("bi,bi->b", zp, zp).mean() / n - 1.0) < (
        5 * np.sqrt(2.0 / n / n_draw) + 0.01)
