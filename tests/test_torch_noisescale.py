"""Noise-level marginalization in the PyTorch port
(``tpu21cmvae_torch/noisescale.py``), case for case with
``tests/test_noisescale.py``, each value also held to the JAX package's on
the same weights and inputs.

Tolerances: ``wrap_value`` and ``wrap_valgrad`` against the JAX wraps of
the same base outputs 1e-5; likelihood values against the JAX value
``2e-3·max|logL|`` (exact-tier torch against exact-tier XLA 1e-5 of
``max|logL|``), gradients ``2e-3·max|g|``; the float64 brute-force
integrals at the JAX suite's own absolute bounds.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_pair import make_pair, one_torch_thread  # noqa: F401

from tpu21cmvae import noisescale as jns
from tpu21cmvae.ops.loglik import make_loglik as jax_make_loglik
from tpu21cmvae.ops.loglik import make_loglik_and_grad as jax_make_loglik_and_grad
from tpu21cmvae_torch import noisescale as tns
from tpu21cmvae_torch.foregrounds import linlog_basis
from tpu21cmvae_torch.noisescale import ScaleMarginalNoise, marginalize_noise_scale
from tpu21cmvae_torch.ops.loglik import make_loglik, make_loglik_and_grad
from tpu21cmvae_torch.sampling._common import valgrad_from_loglik


@pytest.fixture(scope="module")
def pair(splits):
    return make_pair(splits, (24, 24))


@pytest.fixture(scope="module")
def noise_shape():
    return np.random.default_rng(3).uniform(5.0, 50.0, 451)


@pytest.fixture(scope="module")
def obs(pair, splits, noise_shape):
    """Generated at TRUE level 2.5× the assumed shape: the scale marginal
    must absorb it."""
    sig = pair[1].predict(splits.par_test[0])
    return (sig + np.random.default_rng(5).normal(0, np.sqrt(2.5 * noise_shape))).astype(
        np.float32)


@pytest.fixture(scope="module")
def rows(splits):
    return np.asarray(splits.par_test[:6], np.float32)


def _values(fn, params, theta):
    with torch.no_grad():
        return fn(params, torch.as_tensor(theta)).numpy()


def _sigma_quad(log_integrand_of_s2):
    """log ∫ f(σ²) dσ² by trapezoid on a wide log-σ² grid (float64)."""
    ls2 = np.linspace(-14.0, 14.0, 60001)
    s2 = np.exp(ls2)
    vals = log_integrand_of_s2(s2) + ls2  # dσ² = σ²·d(logσ²)
    mx = vals.max()
    return mx + np.log(np.trapezoid(np.exp(vals - mx), ls2))


@pytest.mark.parametrize("alpha,beta", [(None, None), (3.0, 2.0)])
@pytest.mark.parametrize("n_terms", [None, 4])
def test_wraps_match_jax(alpha, beta, n_terms):
    """``wrap_value`` and ``wrap_valgrad`` over the same base outputs
    (values from far below to the floor, random gradients) equal the JAX
    wraps at 1e-5, over a diagonal and a flat-prior foreground base; the
    spec's constants and memo key are the JAX spec's."""
    from tpu21cmvae.foregrounds import marginalize_foreground as jax_fg
    from tpu21cmvae_torch.foregrounds import marginalize_foreground as torch_fg

    rng = np.random.default_rng(0)
    nv = rng.uniform(5.0, 50.0, 451)
    if n_terms is None:
        base_t = base_j = nv
    else:
        F = linlog_basis(np.linspace(50.0, 200.0, 451), n_terms)
        base_t, base_j = torch_fg(F, nv), jax_fg(F, nv)
    sm_t = marginalize_noise_scale(base_t, alpha=alpha, beta=beta)
    sm_j = jns.marginalize_noise_scale(base_j, alpha=alpha, beta=beta)
    assert sm_t.memo_key() == sm_j.memo_key()
    for name in ("n_eff", "shape_coef", "log_norm_const"):
        assert getattr(sm_t, name)(451) == getattr(sm_j, name)(451)
    assert sm_t.base_log_norm() == sm_j.base_log_norm()
    ln0 = sm_t.base_log_norm()
    ll = (ln0 - np.concatenate([[0.0, 1e-30, 1e-12], rng.uniform(0.1, 5e4, 29)])).astype(
        np.float32)
    g = rng.normal(size=(32, 7)).astype(np.float32) * 100.0
    want_v = np.asarray(sm_j.wrap_value(lambda p, x: jnp.asarray(ll), 451)(None, None))
    got_v = sm_t.wrap_value(lambda p, x: torch.as_tensor(ll), 451)(None, None)
    np.testing.assert_allclose(got_v.numpy(), want_v, rtol=1e-5)
    wv, wg = sm_j.wrap_valgrad(lambda p, x: (jnp.asarray(ll), jnp.asarray(g)), 451)(None, None)
    gv, gg = sm_t.wrap_valgrad(lambda p, x: (torch.as_tensor(ll), torch.as_tensor(g)), 451)(
        None, None)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5)
    np.testing.assert_allclose(gg.numpy(), np.asarray(wg), rtol=1e-5)
    assert np.isfinite(gv.numpy()).all() and np.isfinite(gg.numpy()).all()
    assert np.abs(gg.numpy()).max() <= tns._GMAX
    assert (tns._FLOOR_REL, tns._GMAX) == (jns._FLOOR_REL, jns._GMAX)


def test_wrap_passes_launches_and_stays_differentiable():
    """The wrapped object reads and sets the wrapped callable's
    ``launches``; ``wrap_value`` stays differentiable by autograd, with
    the chain-rule gradient ``a/t·∇logL`` that ``wrap_valgrad`` applies."""

    class Counted:
        launches = 3

        def __call__(self, params, x):
            return -0.5 * torch.sum(x * x, dim=-1)

    sm = marginalize_noise_scale(25.0, alpha=3.0, beta=2.0)
    base = Counted()
    wrapped = sm.wrap_value(base, 451)
    assert wrapped.base is base and wrapped.launches == 3
    wrapped.launches = 0
    assert base.launches == 0
    x = torch.tensor(np.random.default_rng(1).normal(size=(5, 7)), dtype=torch.float32)
    v, g = valgrad_from_loglik(wrapped)(None, x)
    wv, wg = sm.wrap_valgrad(lambda p, r: (base(p, r), -r), 451)(None, x)
    np.testing.assert_allclose(v.numpy(), wv.numpy(), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), wg.numpy(), rtol=1e-5)
    with pytest.raises(AttributeError):
        sm.wrap_value(lambda p, r: r, 451).launches  # a plain function counts nothing


@pytest.mark.parametrize("alpha,beta", [(None, None), (3.0, 2.0)])
def test_brute_force_parity_diag(pair, obs, rows, noise_shape, alpha, beta):
    """Wrapped value == float64 numeric integral over σ², in the
    dropped-constant convention (drop −½log|2πN₀|), and == the JAX value."""
    jm, tm = pair
    sm = marginalize_noise_scale(noise_shape, alpha=alpha, beta=beta)
    got = _values(tm.loglik_fn(obs, sm, precision="highest", memo=False), tm.params, rows)
    r = np.asarray(tm.predict(rows), np.float64) - np.asarray(obs, np.float64)
    q0 = np.sum(r * r / noise_shape, axis=-1)
    n = len(noise_shape)

    def log_prior(s2):
        if alpha is None:
            return -np.log(s2)  # Jeffreys, unnormalized
        return alpha * math.log(beta) - math.lgamma(alpha) - (alpha + 1) * np.log(s2) - beta / s2

    want = np.array([
        _sigma_quad(lambda s2, q=q: log_prior(s2) - (n / 2) * np.log(s2) - q / (2 * s2))
        for q in q0
    ])
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)
    jsm = jns.marginalize_noise_scale(noise_shape, alpha=alpha, beta=beta)
    jgot = np.asarray(jm.loglik_fn(obs, jsm, precision="highest", memo=False)(jm.params, rows))
    np.testing.assert_allclose(got, jgot, rtol=0, atol=1e-5 * np.abs(jgot).max())


def test_brute_force_parity_foreground_composed(pair, rows, noise_shape, splits):
    """ScaleMarginalNoise over a flat-prior MarginalizedNoise ==
    independent float64 double marginalization: exact Gaussian algebra
    over the K coefficients at each σ, then numeric quadrature over σ²;
    checks n_eff = n_bins − K and the composed constant. Also == the JAX
    value (the observation carries a 600 mK foreground, so at the JAX
    suite's bound: tests/test_torch_foregrounds.py says why)."""
    jm, tm = pair
    F = linlog_basis(tm.frequencies, 4)
    sig = tm.predict(splits.par_test[1])
    obs = (sig + F @ np.array([600.0, -40.0, 12.0, -3.0])
           + np.random.default_rng(11).normal(0, np.sqrt(2.0 * noise_shape))).astype(np.float32)
    mn = tm.marginalize_foreground(noise_shape, n_terms=4, basis="linlog")
    sm = marginalize_noise_scale(mn)
    got = _values(tm.loglik_fn(obs, sm, precision="highest", memo=False), tm.params, rows)

    r = np.asarray(tm.predict(rows), np.float64) - np.asarray(obs, np.float64)
    n, k = F.shape
    nv = np.asarray(noise_shape, np.float64)
    fn_mat = F / nv[:, None]                       # N₀⁻¹F
    a_mat = F.T @ fn_mat                           # FᵀN₀⁻¹F
    _, logdet_a = np.linalg.slogdet(a_mat)
    q_p = np.sum(r * (r / nv), axis=-1) - np.einsum(
        "bi,ij,bj->b", r @ fn_mat, np.linalg.inv(a_mat), r @ fn_mat)
    want = np.array([
        _sigma_quad(lambda s2, q=q: -np.log(s2) - ((n - k) / 2) * np.log(s2) - q / (2 * s2))
        + (k / 2) * math.log(2 * math.pi) - 0.5 * logdet_a
        for q in q_p
    ])
    # atol: the float32 whiten factor projects a ~600-amplitude foreground
    # to ~0, a few 1e-2 of roundoff in q_P (exact in float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=0.05)
    jsm = jns.marginalize_noise_scale(jm.marginalize_foreground(noise_shape, n_terms=4))
    jgot = np.asarray(jm.loglik_fn(obs, jsm, precision="highest", memo=False)(jm.params, rows))
    np.testing.assert_allclose(got, jgot, rtol=0, atol=2e-3 * np.abs(jgot).max())


def test_valgrad_matches_autodiff(pair, obs, rows, noise_shape):
    """wrap_valgrad's chain-rule rescale == autograd through the wrapped
    value, on the analytic (gram) and autodiff (direct) gradient routes
    and on both backends, and == the JAX value and gradient."""
    jm, tm = pair
    sm = marginalize_noise_scale(noise_shape, alpha=2.0, beta=3.0)
    val_fn = tm.loglik_fn(obs, sm, precision="highest", memo=False)
    want_v, want_g = (t.numpy() for t in valgrad_from_loglik(val_fn)(
        tm.params, torch.as_tensor(rows)))
    jsm = jns.marginalize_noise_scale(noise_shape, alpha=2.0, beta=3.0)
    for method, backend in (("gram", "torch"), ("direct", "torch"), ("gram", "kernel")):
        fn = tm.loglik_and_grad_fn(obs, sm, method=method, backend=backend,
                                   precision="highest", memo=False)
        v, g = (t.numpy() for t in fn(tm.params, torch.as_tensor(rows)))
        np.testing.assert_allclose(v, want_v, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(g, want_g, rtol=1e-4, atol=1e-4)
        if backend == "torch":
            jv, jg = jm.loglik_and_grad_fn(obs, jsm, method=method, precision="highest",
                                           memo=False)(jm.params, rows)
            np.testing.assert_allclose(v, np.asarray(jv), rtol=0, atol=2e-3 * np.abs(v).max())
            np.testing.assert_allclose(g, np.asarray(jg), rtol=0, atol=2e-3 * np.abs(g).max())
    kern = tm.loglik_fn(obs, sm, backend="kernel", precision="highest", memo=False)
    kv, kg = valgrad_from_loglik(kern)(tm.params, torch.as_tensor(rows))
    np.testing.assert_allclose(kv.numpy(), want_v, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(kg.numpy(), want_g, rtol=1e-4, atol=1e-4)
    assert kern.launches == 0


def test_backend_parity(pair, obs, rows, noise_shape):
    """Plain gram/direct and the kernel wrappers (their plain versions on
    CPU tensors) agree under scale marginalization at two tiers: the wrap
    is backend-blind. The JAX Pallas kernels (interpret mode) and XLA
    agree with them."""
    jm, tm = pair
    sm = marginalize_noise_scale(noise_shape)
    jsm = jns.marginalize_noise_scale(noise_shape)
    ref = _values(tm.loglik_fn(obs, sm, method="direct", precision="highest", memo=False),
                  tm.params, rows)
    for backend, method in [("torch", "gram"), ("kernel", "direct"), ("kernel", "gram")]:
        fn = make_loglik(tm.config, tm.normalizer, obs, sm, backend=backend, method=method,
                         precision="highest")
        np.testing.assert_allclose(_values(fn, tm.params, rows), ref, rtol=1e-4, atol=5e-3)
        high = make_loglik(tm.config, tm.normalizer, obs, sm, backend=backend, method=method)
        np.testing.assert_allclose(_values(high, tm.params, rows), ref, rtol=0,
                                   atol=2e-3 * np.abs(ref).max())
    for backend, method in [("xla", "direct"), ("pallas", "direct"), ("pallas", "gram")]:
        fn = jax_make_loglik(jm.config, jm.normalizer, obs, jsm, backend=backend, method=method,
                             precision="highest", block_rows=8, interpret=backend == "pallas")
        want = np.asarray(fn(jm.params, jnp.asarray(rows)))
        np.testing.assert_allclose(ref, want, rtol=0, atol=2e-3 * np.abs(want).max())
    jv, jg = jax_make_loglik_and_grad(jm.config, jm.normalizer, obs, jsm, backend="pallas",
                                      precision="highest", block_rows=8, interpret=True)(
        jm.params, jnp.asarray(rows))
    v, g = make_loglik_and_grad(tm.config, tm.normalizer, obs, sm, backend="kernel",
                                precision="highest")(tm.params, torch.as_tensor(rows))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=2e-3 * np.abs(jv).max())
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=2e-3 * np.abs(jg).max())


def test_scale_invariance_of_posterior_shape(pair, obs, rows, noise_shape):
    """Jeffreys scale marginal is invariant to rescaling the assumed
    noise shape: logL differences between parameter rows are identical
    for base shapes nv and 100·nv (only the constant shifts)."""
    _, tm = pair
    a = _values(tm.loglik_fn(obs, marginalize_noise_scale(noise_shape), precision="highest",
                             memo=False), tm.params, rows)
    b = _values(tm.loglik_fn(obs, marginalize_noise_scale(100.0 * noise_shape),
                             precision="highest", memo=False), tm.params, rows)
    np.testing.assert_allclose(a - a[0], b - b[0], rtol=0, atol=2e-2)


def test_sigma2_posterior_readout(pair, splits, noise_shape):
    """The σ² posterior concentrates near the true injected level when
    the residual is pure noise; equal to the JAX module's readout."""
    _, tm = pair
    sig = tm.predict(splits.par_test[2])
    true_level = 2.5
    obs = sig + np.random.default_rng(13).normal(0, np.sqrt(true_level * noise_shape))
    sm = marginalize_noise_scale(noise_shape)
    a_post, b_post = sm.sigma2_posterior(obs - sig)
    mean = b_post / (a_post - 1)
    assert abs(mean - true_level) < 3 * mean / math.sqrt(a_post - 2)
    a2, b2 = sm.sigma2_posterior(np.stack([obs - sig] * 3))
    assert np.allclose(b2, b_post) and b2.shape == (3,)
    ja, jb = jns.marginalize_noise_scale(noise_shape).sigma2_posterior(obs - sig)
    assert (a_post, b_post) == (ja, jb)
    mn = tm.marginalize_foreground(noise_shape, n_terms=4)
    fa, fb = marginalize_noise_scale(mn, alpha=3.0, beta=2.0).sigma2_posterior(obs - sig)
    assert fa == 3.0 + 0.5 * (451 - 4) and fb < 2.0 + b_post


def test_validation_and_memo(pair, obs, noise_shape):
    _, tm = pair
    with pytest.raises(ValueError, match="together"):
        marginalize_noise_scale(noise_shape, alpha=2.0)
    with pytest.raises(ValueError, match="alpha > 0"):
        marginalize_noise_scale(noise_shape, alpha=-1.0, beta=1.0)
    with pytest.raises(ValueError, match="positive"):
        marginalize_noise_scale(-1.0)
    sm = marginalize_noise_scale(noise_shape)
    with pytest.raises(ValueError, match="already marginalized"):
        marginalize_noise_scale(sm)
    with pytest.raises(TypeError, match="ScaleMarginalNoise is unwrapped"):
        from tpu21cmvae_torch.ops.fold import noise_scale

        noise_scale(sm, 451, device="cpu")
    # value-keyed memo: same spec → same object, on both backends
    for backend in ("torch", "kernel"):
        f1 = tm.loglik_fn(obs, marginalize_noise_scale(noise_shape), backend=backend)
        f2 = tm.loglik_fn(obs, marginalize_noise_scale(noise_shape), backend=backend)
        f3 = tm.loglik_fn(obs, marginalize_noise_scale(noise_shape, alpha=2.0, beta=2.0),
                          backend=backend)
        assert f1 is f2 and f1 is not f3
        assert f1 is not tm.loglik_fn(obs, noise_shape, backend=backend)
    g1 = tm.loglik_and_grad_fn(obs, marginalize_noise_scale(noise_shape), backend="kernel")
    assert g1 is tm.loglik_and_grad_fn(obs, marginalize_noise_scale(noise_shape),
                                       backend="kernel")
    assert g1.launches == 0 and g1.base.name == "K3"


def test_sampler_end_to_end(pair, splits, noise_shape):
    """A short HMC chain (the default sampler) under the scale marginal
    concentrates on the true parameters even though the assumed noise
    level is 4× off: the workflow the feature exists for."""
    _, tm = pair
    truth = np.asarray(splits.par_test[3], np.float32)
    sig = tm.predict(truth)
    obs = (sig + np.random.default_rng(17).normal(0, np.sqrt(4.0 * noise_shape))).astype(
        np.float32)
    res = tm.sample_posterior(obs, marginalize_noise_scale(noise_shape), n_walkers=64,
                              n_steps=150, n_warmup=75, seed=0)
    lo = np.percentile(res.chain, 1, axis=(0, 1))
    hi = np.percentile(res.chain, 99, axis=(0, 1))
    inside = (truth >= lo) & (truth <= hi)
    assert inside.sum() >= truth.size - 2


def test_zero_residual_jeffreys_finite(pair, splits, rows):
    """A noiseless observation evaluated at its own parameters gives
    residual q = 0; under Jeffreys (beta=0) the exact marginal diverges,
    but the implementation must floor it to a FINITE value, with finite
    gradients on the analytic route, on the kernel backend and by
    autograd through the floored value."""
    _, tm = pair
    obs0 = tm.predict(splits.par_test[0]).astype(np.float32)
    sm = marginalize_noise_scale(np.full(451, 25.0, np.float32))
    batch = np.concatenate([np.asarray(splits.par_test[:1], np.float32), rows])
    for backend in ("torch", "kernel"):
        fn = make_loglik(tm.config, tm.normalizer, obs0, sm, backend=backend)
        ll = _values(fn, tm.params, batch)
        assert np.isfinite(ll).all(), ll
        assert ll[0] >= ll[1:].max()  # a perfect fit is the MAP
        v, g = make_loglik_and_grad(tm.config, tm.normalizer, obs0, sm, backend=backend)(
            tm.params, torch.as_tensor(batch))
        assert np.isfinite(v.numpy()).all() and np.isfinite(g.numpy()).all()
        v, g = valgrad_from_loglik(fn)(tm.params, torch.as_tensor(batch))
        assert np.isfinite(v.numpy()).all() and np.isfinite(g.numpy()).all()


def test_sample_noise_generative_moments(pair, noise_shape):
    """sample_noise draws from the spec's own generative model; Jeffreys
    refuses; scalar bases refuse (no bin count); the draws are the JAX
    module's from the same generator."""
    _, tm = pair
    n_draw = 3000
    sm = marginalize_noise_scale(noise_shape, alpha=4.0, beta=9.0)
    x = sm.sample_noise(np.random.default_rng(11), n_draw)
    np.testing.assert_array_equal(
        x, jns.marginalize_noise_scale(noise_shape, alpha=4.0, beta=9.0).sample_noise(
            np.random.default_rng(11), n_draw))
    lvl = np.mean(x * x / noise_shape, axis=1)  # ~ sigma^2_i (n=451)
    want = 9.0 / 3.0
    sd = math.sqrt((want**2 / 2.0) / n_draw)  # var = b^2/((a-1)^2(a-2))
    assert abs(lvl.mean() - want) < 6 * sd + 0.02
    rng = np.random.default_rng(12)
    with pytest.raises(ValueError, match="Jeffreys"):
        marginalize_noise_scale(noise_shape).sample_noise(rng, 2)
    with pytest.raises(ValueError, match="per-bin"):
        marginalize_noise_scale(25.0, alpha=4.0, beta=9.0).sample_noise(rng, 2)
    mn = tm.marginalize_foreground(noise_shape, n_terms=4)
    xf = marginalize_noise_scale(mn, alpha=4.0, beta=9.0).sample_noise(
        rng, n_draw, flat_coeff_scale=500.0)
    z = xf @ mn.whiten.astype(np.float64)
    assert abs((np.einsum("bi,bi->b", z, z) / (451 - 4)).mean() - want) < 6 * sd + 0.02


def test_direct_construction_validates_prior():
    """ScaleMarginalNoise built directly (not via the factory) rejects
    half-specified InvGamma priors."""
    with pytest.raises(ValueError, match="together"):
        ScaleMarginalNoise(base=25.0, alpha=3.0)
    with pytest.raises(ValueError, match="together"):
        ScaleMarginalNoise(base=25.0, beta=5.0)
    with pytest.raises(ValueError, match="alpha > 0"):
        ScaleMarginalNoise(base=25.0, alpha=-1.0, beta=2.0)
