"""The port's normalizing flows (``tpu21cmvae_torch/flows.py``) against the
JAX package's (``tpu21cmvae/flows.py``).

Tolerances: the coupling stack on the same carried-across parameters
(``flow_forward``, ``flow_inverse``, ``log_q``) to rtol/atol 1e-5; five
steps of ``fit_flow`` on the normals JAX draws from its keys (fed through
``vi._normal``) to 1e-4 in every parameter and ELBO; ``flow_evidence`` on
JAX's draws to 1e-4 in log Z (the weights differ in the last float32
digits, and PSIS reorders nothing at that scale); the JAX suite's
analytic targets (``tests/test_flows.py``) at its own assertions and
sizes, except where a test says otherwise. The batched evidence and its
khat escalation are in ``tests/test_torch_evidence_batch.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_pair import make_pair, one_torch_thread, train_box  # noqa: F401
from test_torch_vi import feed
from tpu21cmvae import flows as jfl
from tpu21cmvae_torch import flows as tfl
from tpu21cmvae_torch.flows import (
    FlowEvidenceResult,
    FlowResult,
    _base_logpdf,
    _masks,
    evidence_with_flow,
    fit_flow,
    fit_flow_batch,
    flow_evidence,
    flow_evidence_batch,
    flow_forward,
    flow_inverse,
)
from tpu21cmvae_torch.sampling import evidence as tev

# -- curved-ridge target (raw space, 3 params) ---------------------------
_B = 0.4
_BOUNDS = np.array([[-6.0, 6.0], [-6.0, 6.0], [-3.0, 3.0]], np.float32)


def _banana_logp(x):
    x0, x1, x2 = x[..., 0], x[..., 1], x[..., 2]
    r = x1 - _B * x0**2 + 1.0
    return -0.5 * (x0**2 / 4.0) - 0.5 * (r / 0.25) ** 2 - 0.5 * (x2 / 0.5) ** 2


def _autograd_valgrad(logp):
    def valgrad(params, x):
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            v = logp(x)
            (g,) = torch.autograd.grad(v.sum(), x)
        return v.detach(), g

    return valgrad


_banana_valgrad = _autograd_valgrad(_banana_logp)


def _banana_logz_true():
    """Box-normalized evidence by quadrature (the target factorizes)."""
    g0 = np.linspace(-6, 6, 1201)
    g1 = np.linspace(-6, 6, 1201)
    g2 = np.linspace(-3, 3, 601)
    p0, p1 = np.meshgrid(g0, g1, indexing="ij")
    f01 = np.exp(-0.5 * p0**2 / 4.0 - 0.5 * ((p1 - _B * p0**2 + 1.0) / 0.25) ** 2)
    z01 = np.trapezoid(np.trapezoid(f01, g1, axis=1), g0)
    z2 = np.trapezoid(np.exp(-0.5 * (g2 / 0.5) ** 2), g2)
    return math.log(z01 * z2 / (12.0 * 12.0 * 6.0))


def _gauss_logp(mu, sig):
    mu_t, sig_t = torch.as_tensor(mu), torch.as_tensor(sig)

    def logp(x):
        return -0.5 * torch.sum(((x - mu_t) / sig_t) ** 2, dim=-1)

    return logp


def _jax_random_theta(n_params, n_layers, width, seed, scale):
    """A JAX flow theta away from the identity: every leaf perturbed."""
    theta = jfl.init_flow(jax.random.key(seed), n_params, n_layers=n_layers, width=width)
    leaves, tree = jax.tree_util.tree_flatten(theta)
    keys = jax.random.split(jax.random.key(seed + 100), len(leaves))
    return jax.tree_util.tree_map(np.asarray, jax.tree_util.tree_unflatten(tree, [
        leaf + scale * jax.random.normal(k, leaf.shape, leaf.dtype)
        for leaf, k in zip(leaves, keys)]))


def _random_flow(n_layers, seed):
    """``tests/test_flows.py::_random_flow``, carried across."""
    theta = _jax_random_theta(3, n_layers, 8, seed, 0.2)
    return FlowResult.from_theta(theta, lo=_BOUNDS[:, 0], hi=_BOUNDS[:, 1], device="cpu")


# -- parity on carried-across parameters and injected draws -----------------------


def test_coupling_stack_matches_jax():
    """``flow_forward``, ``flow_inverse`` and ``log_q`` on the same perturbed
    theta and inputs: y, z, both logdets and log q to rtol/atol 1e-5; the
    module's parameter names follow JAX's theta keys, and reading the
    theta back returns it unchanged."""
    theta = _jax_random_theta(5, 4, 16, 0, 0.3)
    masks = jfl._masks(5, 4)
    np.testing.assert_array_equal(_masks(5, 4), masks)
    flow = tfl.RealNVP(theta, device="cpu")
    names = {n for n, _ in flow.named_parameters()}
    assert {"mu", "d", "a", "layers.0.w1", "layers.3.b2"} <= names and len(names) == 3 + 4 * 4
    back = flow.theta()
    for k in ("mu", "d", "a"):
        np.testing.assert_array_equal(back[k], theta[k])
    np.testing.assert_array_equal(back["layers"][2]["w2"], theta["layers"][2]["w2"])
    z = np.asarray(jax.random.normal(jax.random.key(2), (64, 5)), np.float32)
    y_j, ld_j = jax.jit(lambda th, q: jfl.flow_forward(th, q, masks))(theta, jnp.asarray(z))
    with torch.no_grad():
        y, ld = flow_forward(flow, torch.as_tensor(z))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_j), rtol=1e-5, atol=1e-5)
    zb_j, ldi_j = jax.jit(lambda th, q: jfl.flow_inverse(th, q, masks))(theta, y_j)
    with torch.no_grad():
        zb, ldi = flow_inverse(flow, torch.as_tensor(np.asarray(y_j)))
    np.testing.assert_allclose(zb.numpy(), np.asarray(zb_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ldi.numpy(), np.asarray(ldi_j), rtol=1e-5, atol=1e-5)
    lo, hi = -np.ones(5), np.ones(5)
    jres = jfl.FlowResult(theta=theta, masks=masks, elbo=np.zeros(1), _lo=lo, _hi=hi)
    mine = FlowResult.from_theta(theta, lo=lo, hi=hi, device="cpu")
    np.testing.assert_allclose(mine.log_q(np.asarray(y_j)), jres.log_q(y_j), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("warm_start", [False, True])
def test_fit_flow_matches_jax_on_its_draws(monkeypatch, warm_start):
    """Five ELBO steps (after three warm-start ADVI steps, or from the
    wide start) on the normals JAX draws: ``split(key(seed))`` into the
    init and fit keys, one ``split`` per coupling layer's ``w1``, and
    ``split(k_fit, n_steps)`` for the steps (``flows.py:408-409,433``); the
    warm start first draws ADVI's own. Every parameter and the ELBO trace
    equal JAX's to 1e-4 on a target whose gradients stay away from 0."""
    n_steps, n_mc, n_layers, width, seed, warm = 5, 32, 4, 8, 2, 3
    mu, sig = np.array([1.5, -2.5, 1.1], np.float32), np.array([0.6, 0.5, 0.4], np.float32)

    def jax_vg(params, x):
        z = (x - mu) / sig
        return -0.5 * jnp.sum(z * z, -1), -z / sig

    kw = dict(bounds=_BOUNDS, n_steps=n_steps, n_mc=n_mc, n_layers=n_layers, width=width,
              seed=seed, warm_start=warm_start, warm_steps=warm)
    theirs = jfl.fit_flow(jax_vg, None, **kw)
    k_init, k_fit = jax.random.split(jax.random.key(seed))
    draws = ([jax.random.normal(k, (n_mc, 3), jnp.float32)
              for k in jax.random.split(jax.random.key(seed), warm)] if warm_start else [])
    key = k_init
    for _ in range(n_layers):
        key, k1 = jax.random.split(key)
        draws.append(jax.random.normal(k1, (3, width), jnp.float32))
    draws += [jax.random.normal(k, (n_mc, 3), jnp.float32)
              for k in jax.random.split(k_fit, n_steps)]
    queue = feed(monkeypatch, draws)
    mine = fit_flow(_autograd_valgrad(_gauss_logp(mu, sig)), None, device="cpu", **kw)
    assert not queue
    np.testing.assert_allclose(mine.elbo, theirs.elbo, rtol=1e-4, atol=1e-4)
    got, want = mine.theta, theirs.theta
    for k in ("mu", "d", "a"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4)
    for gl, wl in zip(got["layers"], want["layers"]):
        for k in ("w1", "b1", "w2", "b2"):
            np.testing.assert_allclose(gl[k], wl[k], rtol=1e-4, atol=1e-4)
    assert np.abs(got["layers"][0]["w2"]).max() > 1e-3  # the couplings moved


def test_flow_evidence_matches_jax_on_its_draws(monkeypatch):
    """``flow_evidence`` of a carried-across random flow on JAX's draws
    (``normal(key(seed), (n_is, P))``): log Z, its error, khat and the
    weight ESS equal JAX's (log Z to 1e-4); ``evidence_with_flow`` with a
    prefitted flow scores it at ``seed + 1``."""
    fl = _random_flow(6, 4)
    jflow = jfl.FlowResult(theta=fl.theta, masks=fl.masks, elbo=np.zeros(1),
                           _lo=fl._lo, _hi=fl._hi)
    n_is, seed = 4096, 7
    theirs = jfl.flow_evidence(lambda p, x: _banana_logp(x), None, jflow, bounds=_BOUNDS,
                               n_is=n_is, seed=seed)
    z = jax.random.normal(jax.random.key(seed), (n_is, 3), jnp.float32)
    feed(monkeypatch, [z])
    mine = flow_evidence(lambda p, x: _banana_logp(x), None, fl, bounds=_BOUNDS, n_is=n_is,
                         seed=seed)
    assert isinstance(mine, FlowEvidenceResult)
    assert mine.logz == pytest.approx(theirs.logz, abs=1e-4)
    assert mine.logz_err == pytest.approx(theirs.logz_err, rel=1e-3)
    assert mine.khat == pytest.approx(theirs.khat, abs=1e-3)
    assert mine.is_ess == pytest.approx(theirs.is_ess, rel=1e-3)
    np.testing.assert_allclose(mine._x, np.asarray(theirs._x), rtol=1e-5, atol=1e-5)
    feed(monkeypatch, [jax.random.normal(jax.random.key(seed + 1), (n_is, 3), jnp.float32)])
    again = evidence_with_flow(lambda p, x: _banana_logp(x), None, None, flow=fl,
                               bounds=_BOUNDS, n_is=n_is, seed=seed, device="cpu")
    theirs1 = jfl.evidence_with_flow(lambda p, x: _banana_logp(x), None, None, flow=jflow,
                                     bounds=_BOUNDS, n_is=n_is, seed=seed)
    assert again.flow is fl
    assert again.logz == pytest.approx(theirs1.logz, abs=1e-4)


@pytest.fixture(scope="module")
def pair(splits):
    return make_pair(splits, (16,))


@pytest.fixture(scope="module")
def tiny(pair, splits):
    jm, tm = pair
    obs = np.asarray(jm.predict(splits.par_test[0]), np.float32)
    return jm, tm, obs, train_box(splits.par_train)


# -- the JAX suite's targets (tests/test_flows.py) --------------------------------------


def test_flow_is_an_exact_density():
    """``tests/test_flows.py::test_flow_is_an_exact_density``: the
    round-trip is exact, both logdets agree and match autograd's
    Jacobian determinant row by row, on a non-identity flow."""
    flow = tfl.RealNVP(_jax_random_theta(5, 4, 16, 0, 0.3), device="cpu")
    z = torch.as_tensor(np.asarray(jax.random.normal(jax.random.key(2), (64, 5)), np.float32))
    with torch.no_grad():
        y, ld_f = flow(z)
        z_back, ld_i = flow.inverse(y)
    np.testing.assert_allclose(z_back.numpy(), z.numpy(), atol=2e-5)
    np.testing.assert_allclose(ld_i.numpy(), ld_f.numpy(), rtol=3e-5, atol=2e-6)
    jac = torch.stack([torch.autograd.functional.jacobian(lambda q: flow(q[None])[0][0], z[i])
                       for i in range(8)])
    _, ref = np.linalg.slogdet(jac.detach().numpy().astype(np.float64))
    np.testing.assert_allclose(ld_f[:8].numpy(), ref, rtol=2e-5)


def test_flow_init_is_identity_gaussian():
    """``tests/test_flows.py::test_flow_init_is_identity_gaussian``."""
    gen = torch.Generator().manual_seed(0)
    flow = tfl.RealNVP(tfl.init_flow(gen, 3, n_layers=6, width=8), device="cpu")
    z = torch.randn((32, 3), generator=gen)
    with torch.no_grad():
        y, ld = flow(z)
    np.testing.assert_allclose(y.numpy(), z.numpy() * 1.5, rtol=1e-6)
    np.testing.assert_allclose(ld.numpy(), 3 * math.log(1.5), rtol=1e-6)


@pytest.fixture(scope="module")
def banana_flow():
    """The JAX suite's banana fit (1500 steps × 256 draws after the
    400-step ADVI warm start), shared by the two tests that fit it there
    (at 1200 and 1500 steps)."""
    return fit_flow(_banana_valgrad, None, bounds=_BOUNDS, n_steps=1500, n_mc=256, seed=0,
                    device="cpu")


def test_fit_flow_beats_gaussian_on_curved_ridge(banana_flow):
    """``tests/test_flows.py::test_fit_flow_beats_gaussian_on_curved_ridge``:
    the ELBO climbs from the ADVI warm start and flattens, clears
    full-rank ADVI's by 0.3 nats, and the draws trace the ridge."""
    from tpu21cmvae_torch.vi import fit_advi

    flow = banana_flow
    assert isinstance(flow, FlowResult)
    n = len(flow.elbo)
    assert flow.elbo[-n // 5:].mean() > flow.elbo[: n // 5].mean() + 0.2
    assert flow.elbo[-n // 5:].mean() - flow.elbo[-2 * n // 5: -n // 5].mean() < 1.0
    adv = fit_advi(_banana_valgrad, None, bounds=_BOUNDS, n_steps=800, n_mc=256, seed=0,
                   device="cpu")
    lo, span = torch.as_tensor(_BOUNDS[:, 0]), torch.as_tensor(_BOUNDS[:, 1] - _BOUNDS[:, 0])

    def target(y):
        y = torch.as_tensor(np.asarray(y, np.float32))
        jac = torch.sum(torch.nn.functional.logsigmoid(y) + torch.nn.functional.logsigmoid(-y), -1)
        return (_banana_logp(lo + span * torch.sigmoid(y)) + jac).numpy()

    ys = flow.sample_y(8192, seed=3).numpy()
    elbo_flow = float(target(ys).mean() - flow.log_q(ys).mean())
    eps = np.random.default_rng(3).standard_normal((8192, 3))
    h_adv = float(np.linalg.slogdet(adv.chol)[1] + 0.5 * 3 * math.log(2 * math.pi * math.e))
    elbo_adv = float(target(adv.mu + eps @ adv.chol.T).mean()) + h_adv
    assert elbo_flow > elbo_adv + 0.3, (elbo_flow, elbo_adv)
    draws = flow.sample(65536, seed=1)
    for c in (-2.0, 2.0):
        sel = np.abs(draws[:, 0] - c) < 0.3
        assert sel.sum() > 200
        assert abs(draws[sel, 1].mean() - (_B * c**2 - 1.0)) < 0.3


def test_flow_evidence_exact_and_lighter_tailed_than_t(banana_flow):
    """``tests/test_flows.py::test_flow_evidence_exact_and_lighter_tailed_than_t``:
    the flow's log Z matches quadrature, its khat clears 0.7 and beats
    Laplace's by 0.1 with 3× its weight ESS; the resampled posterior sits
    on the ridge. khat is compared as the mean over three seeds on each
    side (importance seeds 1–3 for the flow, Laplace seeds 0–2): one
    draw of either scatters by about ±0.1 (the JAX package's own flow
    gives 0.48, 0.71 and 0.58 at importance seeds 1–3), which the JAX
    suite's single draw at seed 1 does not show."""
    evs = [flow_evidence(lambda p, x: _banana_logp(x), None, banana_flow, bounds=_BOUNDS,
                         seed=s) for s in (1, 2, 3)]
    ev = evs[0]
    assert isinstance(ev, FlowEvidenceResult)
    assert abs(ev.logz - _banana_logz_true()) < max(4 * ev.logz_err, 0.05)
    laps = [tev.laplace_evidence(lambda p, x: _banana_logp(x), None, bounds=_BOUNDS,
                                 n_starts=512, n_steps=500, seed=s, device="cpu")
            for s in (0, 1, 2)]
    khat = float(np.mean([e.khat for e in evs]))
    lap_khat = float(np.mean([lap.khat for lap in laps]))
    assert khat < 0.7, khat
    assert khat < lap_khat - 0.1, (khat, lap_khat)
    assert ev.is_ess > 3 * laps[0].is_ess, (ev.is_ess, laps[0].is_ess)
    post = ev.posterior(4096, seed=2)
    assert post.shape == (4096, 3)
    sel = np.abs(post[:, 0] - 2.0) < 0.4
    assert abs(post[sel, 1].mean() - (_B * 4.0 - 1.0)) < 0.35
    assert "khat" in ev.summary()


def test_flow_evidence_prior_convention():
    """``tests/test_flows.py::test_flow_evidence_prior_convention`` (a
    600-step fit, the JAX suite's 700): a tight Gaussian prior reproduces
    quadrature, and a constant shift of ``log_prior`` cannot move log Z."""
    from tpu21cmvae_torch.priors import GaussianBoxPrior

    mu = np.array([0.5, -1.0, 0.2], np.float32)
    sig = np.array([0.6, 0.8, 0.4], np.float32)
    logp = _gauss_logp(mu, sig)
    prior = GaussianBoxPrior.for_params({0: (1.0, 0.25)}, n_params=3, bounds=_BOUNDS)
    logz_true = 0.0
    for j in range(3):
        g = np.linspace(_BOUNDS[j, 0], _BOUNDS[j, 1], 100001, dtype=np.float64)
        like = np.exp(-0.5 * ((g - mu[j]) / sig[j]) ** 2)
        pi = np.exp(-0.5 * ((g - 1.0) / 0.25) ** 2) if j == 0 else np.ones_like(g)
        logz_true += math.log(np.trapezoid(like * pi, g) / np.trapezoid(pi, g))
    flow = fit_flow(_autograd_valgrad(logp), None, bounds=_BOUNDS, n_steps=600, n_mc=256,
                    seed=0, log_prior=prior.log_prior, device="cpu")
    ev = flow_evidence(lambda p, x: logp(x), None, flow, bounds=_BOUNDS,
                       log_prior=prior.log_prior, seed=1)
    assert abs(ev.logz - logz_true) < max(4 * ev.logz_err, 0.05)
    ev_base = flow_evidence(lambda p, x: logp(x), None, flow, bounds=_BOUNDS,
                            log_prior=lambda x: prior.log_prior(x), seed=1)
    ev_shift = flow_evidence(lambda p, x: logp(x), None, flow, bounds=_BOUNDS,
                             log_prior=lambda x: prior.log_prior(x) + 5.0, seed=1)
    assert ev_shift.logz == pytest.approx(ev_base.logz, abs=1e-3)
    assert ev_base.logz == pytest.approx(ev.logz, abs=0.05)


def test_fit_flow_tracks_fresh_params():
    """``tests/test_flows.py::test_fit_flow_tracks_fresh_params_through_cache``:
    two fits through one ``valgrad`` with different ``params`` follow
    their own targets (the port keeps no program cache to go stale)."""
    def valgrad(params, x):
        z = x - params
        return -0.5 * torch.sum(z * z, dim=-1), -z

    kw = dict(bounds=_BOUNDS, n_steps=400, n_mc=128, seed=0, warm_start=False, device="cpu")
    f_a = fit_flow(valgrad, torch.tensor([2.0, 2.0, 0.5]), **kw)
    f_b = fit_flow(valgrad, torch.tensor([-2.0, -2.0, -0.5]), **kw)
    np.testing.assert_allclose(f_a.mean(), [2.0, 2.0, 0.5], atol=0.3)
    np.testing.assert_allclose(f_b.mean(), [-2.0, -2.0, -0.5], atol=0.3)


def test_flow_evidence_follows_the_architecture():
    """``tests/test_flows.py::test_flow_evidence_cache_keyed_on_architecture``:
    a deeper flow through the same likelihood after a shallower one scores
    with its own coupling stack, as a fresh likelihood does."""
    def loglik(p, x):
        return _banana_logp(x)

    f6, f8 = _random_flow(6, 0), _random_flow(8, 1)
    flow_evidence(loglik, None, f6, bounds=_BOUNDS, n_is=2048, seed=3)
    ev8 = flow_evidence(loglik, None, f8, bounds=_BOUNDS, n_is=2048, seed=3)
    fresh = flow_evidence(lambda p, x: _banana_logp(x), None, f8, bounds=_BOUNDS, n_is=2048,
                          seed=3)
    assert f8.flow.masks.shape[0] == 8
    assert ev8.logz == pytest.approx(fresh.logz, abs=1e-6)
    assert ev8.khat == pytest.approx(fresh.khat, abs=1e-6)


def test_flow_evidence_rejects_mismatched_bounds():
    """``tests/test_flows.py::test_flow_evidence_rejects_mismatched_bounds``,
    and the batched form's shared-architecture check."""
    flow = _random_flow(4, 2)
    other = _BOUNDS.copy()
    other[0, 1] = 5.0
    with pytest.raises(ValueError, match="bounds"):
        flow_evidence(lambda p, x: _banana_logp(x), None, flow, bounds=other)
    with pytest.raises(ValueError, match="bounds"):
        flow_evidence_batch(lambda p, x: _banana_logp(x), None, [flow], bounds=other)
    with pytest.raises(ValueError, match="architecture"):
        flow_evidence_batch(lambda p, x: _banana_logp(x), None, [flow, _random_flow(6, 3)],
                            bounds=_BOUNDS)


def test_base_logpdf_is_standard_normal():
    """``tests/test_flows.py::test_base_logpdf_is_standard_normal``."""
    z = np.array([[0.0, 0.0], [1.0, -2.0]], np.float32)
    want = -0.5 * (z**2).sum(-1) - math.log(2 * math.pi)
    np.testing.assert_allclose(_base_logpdf(torch.as_tensor(z)).numpy(), want, rtol=1e-6)


def test_model_level_flow_fit_and_evidence(tiny):
    """``tests/test_flows.py::test_model_level_flow_fit_and_evidence`` on the
    small model carried across: in-box draws, ``log_evidence(method="flow")``
    with a prefitted ``flow=`` (reused) within the cross-method budget of
    the nested reference and of JAX's flow evidence of the same
    observation; fit kwargs beside ``flow=`` refused; ``mesh=`` refused
    (the flow evidence takes none, as JAX's) without a ROADMAP item
    number."""
    jm, tm, obs, bounds = tiny
    flow = tm.fit_flow(obs, 25.0, bounds=bounds, n_steps=400, n_mc=128, seed=0)
    draws = flow.sample(4096, seed=1)
    assert draws.shape == (4096, 7)
    assert (draws >= bounds[:, 0] - 1e-4).all() and (draws <= bounds[:, 1] + 1e-4).all()
    ev = tm.log_evidence(obs, 25.0, bounds=bounds, method="flow", flow=flow, n_is=4096, seed=5)
    nes = tm.log_evidence(obs, 25.0, bounds=bounds, method="nested", n_live=256, n_mh=12, seed=0)
    assert isinstance(ev, FlowEvidenceResult) and np.isfinite(ev.logz)
    assert ev.flow is flow
    assert abs(ev.logz - nes.logz) < max(6 * (ev.logz_err + nes.logz_err), 3.0)
    theirs = jm.log_evidence(obs, 25.0, bounds=bounds, method="flow", n_steps=400, n_mc=128,
                             n_is=4096, seed=5)
    assert abs(ev.logz - theirs.logz) < max(6 * (ev.logz_err + theirs.logz_err), 3.0)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tm.log_evidence(obs, 25.0, bounds=bounds, method="flow", flow=flow, n_steps=100)
    with pytest.raises(ValueError, match="'flow'"):
        tm.log_evidence(obs, 25.0, method="typo")
    with pytest.raises(TypeError, match="mesh") as err:  # the flow takes none, as JAX's
        tm.log_evidence(obs, 25.0, method="flow", mesh=object())
    assert "queue" not in str(err.value) and "item" not in str(err.value)


def test_fit_flow_batch_is_deterministic_and_checks_x0():
    """``tests/test_flows.py::test_fit_flow_batch_program_caches_on_the_likelihood``,
    for a port without program caches: two batch fits with one seed give
    the same flows bit for bit, another seed others; a wrong ``x0`` shape
    is refused."""
    mus = torch.tensor([[0.0, 0.0, 0.0], [1.0, -1.0, 0.5]])

    def vg_multi(params, x):
        z = x.reshape(2, x.shape[0] // 2, 3) - mus[:, None, :]
        return (-0.5 * torch.sum(z * z, -1)).reshape(-1), (-z).reshape(-1, 3)

    kw = dict(bounds=_BOUNDS, n_steps=40, n_mc=32, warm_steps=20, device="cpu")
    a = fit_flow_batch(vg_multi, None, 2, seed=0, **kw)
    b = fit_flow_batch(vg_multi, None, 2, seed=0, **kw)
    c = fit_flow_batch(vg_multi, None, 2, seed=1, **kw)
    for fa, fb in zip(a, b):
        np.testing.assert_array_equal(fa.theta["layers"][0]["w1"], fb.theta["layers"][0]["w1"])
        np.testing.assert_array_equal(fa.elbo, fb.elbo)
    assert not np.array_equal(a[0].theta["mu"], c[0].theta["mu"])
    with pytest.raises(ValueError, match="x0"):
        fit_flow_batch(vg_multi, None, 2, seed=0, x0=np.zeros(3), **kw)
