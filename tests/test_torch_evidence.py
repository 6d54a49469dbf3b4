"""The port's evidence estimators (``sampling/evidence.py``: the
stepping-stone ladder, Laplace + adaptive importance sampling, model
comparison) and ``DirectEmulator.log_evidence`` against the JAX package.

Tolerances: the NumPy stages (``_gpd_fit``, ``_psis``, ``_amis_sharpen``
on the same draws, ``_finish_laplace``, the ladder's stepping-stone
reduction) bit for bit in float64; Laplace's deterministic stages on the
small emulator at the same whitened point to rtol 1e-3 (the Hessian by
double autograd in both libraries, in float32); the closed-form targets
at the JAX suite's own assertions (``tests/test_nested.py``,
``tests/test_sampling.py``); on the small emulator, each method's log Z
against JAX's within the larger of 0.5 nat and four combined standard
errors (the runs draw different randoms).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_pair import make_pair, one_torch_thread, train_box  # noqa: F401
from tpu21cmvae.sampling import evidence as jev
from tpu21cmvae_torch.sampling import evidence as tev
from tpu21cmvae_torch.sampling._common import RoutedLoglik
from tpu21cmvae_torch.sampling.evidence import (
    EvidenceResult,
    LaplaceResult,
    laplace_evidence,
    log_evidence,
)

MU = np.array([0.5, -1.0, 2.0], np.float32)
SIG = np.array([0.3, 0.7, 0.2], np.float32)
LO, HI = MU - 4 * SIG, MU + 4 * SIG
BOUNDS = np.stack([LO, HI], axis=1)


def _gauss(mu, sig):
    mu_t, sig_t = torch.as_tensor(mu), torch.as_tensor(sig)

    def loglik(params, x):
        return -0.5 * torch.sum(((x - mu_t) / sig_t) ** 2, dim=-1)

    return loglik


def _same(a, b):
    assert np.asarray(a).dtype == np.asarray(b).dtype
    assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


# -- the NumPy stages, bit for bit ---------------------------------------------------


@pytest.mark.parametrize("k_true", [-0.2, 0.45, 1.2])
def test_gpd_fit_and_psis_are_bit_exact(k_true):
    """The generalized-Pareto fit and Pareto smoothing on weights with a
    known tail index, and the degenerate inputs (non-finite, too few, a
    flat tail), equal JAX's in float64."""
    rng = np.random.default_rng(int(10 * k_true) + 3)
    u = rng.uniform(size=5000)
    w = np.expm1(-k_true * np.log1p(-u)) / k_true
    logw = np.log(w + 1e-12) + 3.0
    exc = np.sort(w[w > np.quantile(w, 0.8)] - np.quantile(w, 0.8))
    for mine, theirs in zip(tev._gpd_fit(exc), jev._gpd_fit(exc)):
        _same(np.float64(mine), np.float64(theirs))
    for lw in (logw, np.full(50, -np.inf), np.zeros(8), np.zeros(400)):
        (sm, k), (sm_j, k_j) = tev._psis(lw.copy()), jev._psis(lw.copy())
        _same(sm, sm_j)
        _same(np.float64(k), np.float64(k_j))


def test_amis_sharpen_and_finish_laplace_are_bit_exact():
    """Three adaptive rounds over two observations, on the same draws (a
    stand-in for the device program that draws from NumPy in the round's
    order and scores an analytic whitened density), and the finished
    result from the combined cloud, equal JAX's in float64."""
    mus = np.array([[0.2, -0.1, 0.3], [1.0, 0.5, -0.2]])
    chol = np.stack([np.diag([0.3, 0.2, 0.5]), np.diag([0.1, 0.4, 0.2])])

    def fake(counter):
        def run_is(mu, L, key):
            mu, L = np.asarray(mu, np.float32), np.asarray(L, np.float32)
            rng = np.random.default_rng(counter.pop(0))
            t = rng.standard_t(4.0, size=(2, 1024, 3)).astype(np.float32)
            y = mu[:, None, :] + np.einsum("oik,ojk->oij", t, L)
            g = -0.5 * np.sum(((y - mus[:, None]) / 0.2) ** 2, axis=-1) - np.abs(y).sum(-1)
            return g, y

        return run_is

    kw = dict(n_is=1024, n_rounds=3, seed=5)
    lw, y = tev._amis_sharpen(fake([1, 2, 3]), mus, chol, **kw)
    lw_j, y_j = jev._amis_sharpen(fake([1, 2, 3]), mus, chol, **kw)
    _same(lw, lw_j)
    _same(y, y_j)
    fields = dict(logz=0.0, map_params=np.zeros(3, np.float32), map_logp=0.0,
                  cov=np.eye(3), pd=True)
    lo, hi = np.array([-1.0, -2.0, 0.0]), np.array([1.0, 2.0, 3.0])
    mine = tev._finish_laplace(tev.LaplaceResult(**fields), lw[0], y[0], lo, hi)
    theirs = jev._finish_laplace(jev.LaplaceResult(**fields), lw_j[0], y_j[0], lo, hi)
    for name in ("logz", "logz_err", "is_ess", "khat", "_is_x", "_is_logw"):
        _same(np.asarray(getattr(mine, name)), np.asarray(getattr(theirs, name)))


def _jax_stepping_stone(ss, ss_c, n_steps, n_walkers):
    """``tpu21cmvae/sampling/evidence.py:306-324``, as written there."""
    ss = np.asarray(ss, np.float64)
    ss_c = np.asarray(ss_c, np.float64)
    rung_logz = np.logaddexp.reduce(ss, axis=0) - np.log(n_steps * n_walkers)
    coarse_logz = float((np.logaddexp.reduce(ss_c, axis=0) - np.log(n_steps * n_walkers)).sum())
    half = n_steps // 2
    a = np.logaddexp.reduce(ss[:half], axis=0) - np.log(half * n_walkers)
    b = np.logaddexp.reduce(ss[half: 2 * half], axis=0) - np.log(half * n_walkers)
    rung_err = 0.5 * np.abs(a - b)
    return rung_logz, float(np.sqrt((rung_err**2).sum())), coarse_logz, rung_err


@pytest.mark.parametrize("n_steps", [2, 7, 40])
def test_stepping_stone_reduction_is_bit_exact(n_steps):
    """The ladder's pooled estimate, split-half error and half-density
    estimate from given per-step log-sums (float32, as the device makes
    them; an odd step count leaves the last step out of the halves)."""
    rng = np.random.default_rng(n_steps)
    ss = rng.normal(-3.0, 2.0, size=(n_steps, 11)).astype(np.float32)
    ss_c = rng.normal(-5.0, 2.0, size=(n_steps, 6)).astype(np.float32)
    for mine, theirs in zip(tev.stepping_stone(ss, ss_c, 64),
                            _jax_stepping_stone(ss, ss_c, n_steps, 64)):
        _same(np.asarray(mine, np.float64), np.asarray(theirs, np.float64))


# -- the closed-form targets ---------------------------------------------------------


def test_log_evidence_matches_analytic_gaussian():
    """``tests/test_sampling.py::test_log_evidence_matches_analytic_gaussian``:
    the stepping-stone log Z of a truncated Gaussian under the flat box,
    healthy acceptance on every rung (the independence rung ~1), and the
    β=1 rung a posterior sample set."""
    logz_true = -float(np.log(HI - LO).sum())
    for d in range(3):
        a = (LO[d] - MU[d]) / (math.sqrt(2) * SIG[d])
        b = (HI[d] - MU[d]) / (math.sqrt(2) * SIG[d])
        logz_true += math.log(SIG[d] * math.sqrt(2 * math.pi)) + math.log(
            0.5 * (math.erf(b) - math.erf(a)))
    res = log_evidence(_gauss(MU, SIG), None, n_rungs=24, n_walkers=256, n_steps=300,
                       n_warmup=150, bounds=BOUNDS, seed=0, device="cpu")
    assert isinstance(res, EvidenceResult)
    assert abs(res.logz - logz_true) < 0.15
    assert res.rung_logz.shape == (23,)
    assert np.isclose(res.rung_logz.sum(), res.logz)
    assert (res.accept_rate > 0.15).all()
    assert res.accept_rate[0] > 0.95
    assert np.allclose(res.posterior.mean(0), MU, atol=4 * SIG / np.sqrt(50))
    assert "log Z" in res.summary()
    with pytest.raises(ValueError, match="n_rungs"):
        log_evidence(_gauss(MU, SIG), None, n_rungs=1, bounds=BOUNDS, device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        log_evidence(_gauss(MU, SIG), None, bounds=BOUNDS, mesh=object(), device="cpu")


def test_laplace_evidence_analytic_gaussian():
    """``tests/test_nested.py::test_laplace_evidence_analytic_gaussian``:
    the saddle point on a wide-box Gaussian (n_is=0: no MC term), the
    raw-space covariance, in-box Gaussian draws; the default IS rounds
    exact within their error bar at near-full weight ESS."""
    lo, hi = MU - 10 * SIG, MU + 10 * SIG
    bounds = np.stack([lo, hi], axis=1)
    logz_true = -float(np.log((hi - lo).astype(np.float64)).sum())
    for s in SIG:
        logz_true += math.log(s * math.sqrt(2 * math.pi))
    kw = dict(bounds=bounds, n_starts=256, n_steps=300, seed=0, device="cpu")
    res0 = laplace_evidence(_gauss(MU, SIG), None, n_is=0, **kw)
    assert isinstance(res0, LaplaceResult)
    assert res0.pd
    assert abs(res0.logz - logz_true) < 0.05
    assert np.isnan(res0.logz_err)
    assert np.allclose(res0.map_params, MU, atol=0.02 * SIG)
    assert np.allclose(np.sqrt(np.diag(res0.cov)), SIG, rtol=0.03)
    draws = res0.posterior(4096, seed=1)
    assert draws.shape == (4096, 3)
    assert (draws >= lo - 1e-5).all() and (draws <= hi + 1e-5).all()
    assert np.allclose(draws.mean(0), MU, atol=0.1 * SIG)
    res = laplace_evidence(_gauss(MU, SIG), None, **kw)
    assert abs(res.logz - logz_true) < max(3 * res.logz_err, 1e-2)
    assert res.logz_err < 0.01
    assert res.is_ess > 0.8 * 4096
    assert res.logz_laplace == pytest.approx(res0.logz)
    d = res.posterior(5000, seed=1)
    assert (d >= lo - 1e-5).all() and (d <= hi + 1e-5).all()
    assert np.allclose(d.mean(0), MU, atol=0.1 * SIG)
    assert np.allclose(d.std(0), SIG, rtol=0.1)
    assert "±" in res.summary() and "ESS" in res.summary()


def test_amis_adaptation_lifts_ess_on_sharp_mode_wide_bulk():
    """``tests/test_nested.py::test_amis_adaptation_lifts_ess_on_sharp_mode_wide_bulk``:
    a scale mixture with 70 % of its mass 12× wider than the mode's
    curvature; three adaptive rounds match the closed form and lift the
    weight-ESS fraction over 10× the one-shot Hessian proposal's."""
    sig = np.array([0.1, 0.15, 0.08], np.float64)
    mu = np.array([0.2, -0.4, 1.0], np.float64)
    wide, p = 12.0, 3
    lo, hi = mu - 60 * sig, mu + 60 * sig
    bounds = np.stack([lo, hi], 1).astype(np.float32)
    mu_t, sig_t = torch.as_tensor(mu, dtype=torch.float32), torch.as_tensor(sig, dtype=torch.float32)

    def loglik(params, x):
        zn = torch.sum(((x - mu_t) / sig_t) ** 2, dim=-1)
        zw = torch.sum(((x - mu_t) / (wide * sig_t)) ** 2, dim=-1)
        return torch.logaddexp(math.log(0.3) - 0.5 * zn,
                               math.log(0.7) - p * math.log(wide) - 0.5 * zw)

    true = -float(np.log(hi - lo).sum()) + float(np.log(sig * math.sqrt(2 * math.pi)).sum())
    kw = dict(bounds=bounds, n_starts=256, n_steps=400, n_is=4096, seed=0, device="cpu")
    one = laplace_evidence(loglik, None, n_rounds=1, **kw)
    ada = laplace_evidence(loglik, None, n_rounds=3, **kw)
    assert abs(ada.logz - true) < max(4 * ada.logz_err, 0.03)
    frac_one = one.is_ess / one._is_logw.shape[0]
    frac_ada = ada.is_ess / ada._is_logw.shape[0]
    assert frac_ada > 10 * frac_one, (frac_one, frac_ada)
    assert ada.logz_err < 0.2 * one.logz_err


def test_psis_recovers_tail_index_and_preserves_bulk():
    """``tests/test_nested.py::test_psis_recovers_tail_index_and_preserves_bulk``."""
    rng = np.random.default_rng(0)
    k_true, n = 0.45, 20000
    u = rng.uniform(size=n)
    w = np.expm1(-k_true * np.log1p(-u)) / k_true
    logw = np.log(w + 1e-12) + 3.0
    sm, khat = tev._psis(logw)
    assert abs(khat - k_true) < 0.12
    assert sm.max() <= logw.max() + 1e-12
    assert np.sum(~np.isclose(sm, logw)) <= int(3 * np.sqrt(n)) + 1
    lse = np.logaddexp.reduce
    assert abs(lse(sm) - lse(logw)) < 0.05


def test_laplace_prior_normalization_convention():
    """``tests/test_nested.py::test_laplace_prior_normalization_convention``:
    under a ``log_prior`` Laplace reports the evidence under the
    box-normalized prior (1-D quadrature for the truth), through the
    analytic ``log_box_mean`` and the Monte-Carlo route alike, and a
    constant shift of the raw log-density does not move it."""
    from tpu21cmvae_torch.priors import GaussianBoxPrior

    prior = GaussianBoxPrior.for_params({0: (float(MU[0] + 0.2), 0.05)}, n_params=3,
                                        bounds=BOUNDS)
    logz_true = 0.0
    for j in range(3):
        g = np.linspace(float(LO[j]), float(HI[j]), 200001, dtype=np.float64)
        like = np.exp(-0.5 * ((g - float(MU[j])) / float(SIG[j])) ** 2)
        pi = np.exp(-0.5 * ((g - float(MU[0]) - 0.2) / 0.05) ** 2) if j == 0 else np.ones_like(g)
        logz_true += math.log(np.trapezoid(like * pi, g) / np.trapezoid(pi, g))
    lo, hi = torch.as_tensor(LO), torch.as_tensor(HI)
    lbm_exact = tev._prior_log_box_mean(prior.log_prior, lo, hi)
    lbm_mc = tev._prior_log_box_mean(lambda x: prior.log_prior(x), lo, hi)
    assert lbm_exact == pytest.approx(prior.log_box_mean(LO, HI))
    assert abs(lbm_mc - lbm_exact) < 0.05
    kw = dict(bounds=BOUNDS, n_starts=256, n_steps=400, seed=0, device="cpu")
    res = laplace_evidence(_gauss(MU, SIG), None, log_prior=prior.log_prior, **kw)
    assert abs(res.logz - logz_true) < max(4 * res.logz_err, 0.05)
    assert abs(res.logz_laplace - logz_true) < 0.25
    base = laplace_evidence(_gauss(MU, SIG), None, log_prior=lambda x: prior.log_prior(x), **kw)
    shifted = laplace_evidence(_gauss(MU, SIG), None,
                               log_prior=lambda x: prior.log_prior(x) + 5.0, **kw)
    assert shifted.logz == pytest.approx(base.logz, abs=1e-3)
    assert abs(base.logz - res.logz) < 0.1


def test_laplace_takes_each_route_of_a_routed_likelihood():
    """Given a :class:`RoutedLoglik`, the ascent runs its ``valgrad``
    (``n_steps + 1`` calls of ``n_starts`` rows, no autograd through the
    value), the Hessian its ``plain`` route (one row), the IS rounds its
    value (``n_rounds`` calls of ``n_is`` rows); the estimate is the
    bare likelihood's."""
    calls = {"value": [], "valgrad": [], "plain": []}
    base = _gauss(MU, SIG)

    def value(params, x):
        calls["value"].append(x.shape[0])
        return base(params, x).detach()  # a kernel's value carries no graph

    def valgrad(params, x):
        calls["valgrad"].append(x.shape[0])
        z = (x - torch.as_tensor(MU)) / torch.as_tensor(SIG)
        return -0.5 * torch.sum(z * z, dim=-1), -z / torch.as_tensor(SIG)

    def plain(params, x):
        calls["plain"].append(x.shape[0])
        return base(params, x)

    lo, hi = MU - 10 * SIG, MU + 10 * SIG
    kw = dict(bounds=np.stack([lo, hi], 1), n_starts=64, n_steps=200, n_is=512, n_rounds=2,
              seed=0, device="cpu")
    res = laplace_evidence(RoutedLoglik(value, valgrad=valgrad, plain=plain), None, **kw)
    assert calls["valgrad"] == [64] * 201
    assert calls["value"] == [512, 512]
    assert set(calls["plain"]) == {1}
    ref = laplace_evidence(base, None, **kw)
    assert res.logz == pytest.approx(ref.logz, abs=1e-4)


# -- the small emulator -----------------------------------------------------------------


@pytest.fixture(scope="module")
def pair(splits):
    return make_pair(splits, (16,))


@pytest.fixture(scope="module")
def setup(pair, splits):
    jm, tm = pair
    obs = np.asarray(jm.predict(splits.par_test[0]), np.float32)
    return jm, tm, obs, train_box(splits.par_train)


def test_laplace_deterministic_stages_match_jax(setup):
    """At JAX's ascent end point: the whitened Hessian of the exact-tier
    likelihood (the port through the plain likelihood by double
    autograd) and the saddle point's log Z and raw-space covariance at
    ``n_is=0``, to rtol 1e-3."""
    jm, tm, obs, bounds = setup
    jres = jev.laplace_evidence(jm.loglik_fn(obs, 25.0, precision="contract"), jm.params,
                                bounds=bounds, n_starts=128, n_steps=300, n_is=0, seed=0)
    lo, hi = bounds[:, 0], bounds[:, 1]
    y = tev._logit_in_box(jres.map_params, lo, hi)
    hess = jev._build_laplace_hess(jm.loglik_fn(obs, 25.0, precision="contract"), None,
                                   jnp.asarray(lo), jnp.asarray(hi), jev._LaplaceHessProgram())
    h_jax = np.asarray(hess(jm.params, jnp.asarray(y)), np.float64)
    plain = tm.loglik_fn(obs, 25.0, precision="contract")
    tlo, thi = torch.as_tensor(lo), torch.as_tensor(hi)
    h = tev.laplace_hessian(RoutedLoglik(None, plain=plain), None, tlo, thi, tm.params,
                            torch.as_tensor(y))
    np.testing.assert_allclose(h, h_jax, rtol=1e-3, atol=1e-3 * np.abs(h_jax).max())
    with torch.no_grad():
        g = float(tev._whitened_density(plain, None, tlo, thi - tlo)(tm.params,
                                                                     torch.as_tensor(y)[None]))
    res = tev.laplace_saddle(jres.map_params, y, g, h, lo, hi, 0.0)
    assert res.pd == jres.pd
    assert res.logz == pytest.approx(jres.logz, rel=1e-3)
    np.testing.assert_allclose(res.cov, jres.cov, rtol=1e-3, atol=1e-3 * np.abs(jres.cov).max())


@pytest.mark.parametrize("method,kw", [
    ("nested", dict(n_live=512, n_mh=24)),
    ("smc", dict(n_particles=1024)),
    ("laplace", dict(n_starts=256, n_steps=300, n_is=4096)),
    ("ladder", dict(n_rungs=16, n_walkers=64, n_steps=200, n_warmup=100)),
])
def test_log_evidence_matches_jax_on_the_small_model(setup, method, kw):
    """``DirectEmulator.log_evidence`` by each method on the same weights
    and observation: the port's log Z within max(0.5, 4 combined
    standard errors) of JAX's, of the same result type's fields."""
    jm, tm, obs, bounds = setup
    mine = tm.log_evidence(obs, 25.0, bounds=bounds, method=method, seed=0, **kw)
    theirs = jm.log_evidence(obs, 25.0, bounds=bounds, method=method, seed=0, **kw)
    assert type(mine).__name__ == type(theirs).__name__
    err = math.hypot(mine.logz_err, theirs.logz_err)
    assert abs(mine.logz - theirs.logz) < max(0.5, 4.0 * err), (mine.logz, theirs.logz, err)
    if method == "laplace":
        assert mine.pd and np.isfinite(mine.khat) and mine.is_ess > 50


def test_compare_evidence_and_refusals(setup):
    """``compare_evidence`` ranks the generating model over a copy whose
    signal is scaled 25 % (the JAX suite's broken variant), reports Bayes
    factors against the winner; an unknown method is refused, and a mesh
    before any work."""
    from tpu21cmvae_torch.nested import nested_sampling
    from tpu21cmvae_torch.sampling.evidence import EvidenceComparison, compare_evidence

    _, tm, obs, bounds = setup
    base = tm.predict_fn()
    obs_t = torch.as_tensor(obs)

    class Broken:
        def log_evidence(self, obs, noise_var, **kw):
            def loglik(params, raw):
                r = 1.25 * base(params, raw) - obs_t
                return -0.5 * torch.sum(r * r, dim=-1) / noise_var

            return nested_sampling(loglik, tm.params, device="cpu", **kw)

    comp = compare_evidence({"direct": tm, "broken": Broken()}, obs, 25.0, bounds=bounds,
                            n_live=128, n_mh=8, seed=0)
    assert isinstance(comp, EvidenceComparison)
    assert comp.names[int(np.argmax(comp.logz))] == "direct"
    assert comp.log_bayes.max() == 0.0
    assert comp.logz[0] > comp.logz[1] + 10.0
    assert "preferred" in comp.summary()
    assert comp.results["direct"].posterior(8).shape == (8, 7)
    with pytest.raises(ValueError, match=">= 2"):
        compare_evidence({"only": tm}, obs, 25.0)
    with pytest.raises(ValueError, match="method must be"):
        tm.log_evidence(obs, 25.0, bounds=bounds, method="bogus")
    with pytest.raises(TypeError, match="Mesh"):
        tm.log_evidence(obs, 25.0, bounds=bounds, method="ladder", mesh=object())


_SIGNATURES = {
    "DirectEmulator.log_evidence": ("models.direct", "DirectEmulator.log_evidence"),
    "nested.nested_sampling": ("nested", "nested_sampling"),
    "nested.nested_sampling_batch": ("nested", "nested_sampling_batch"),
    "sampling.evidence.log_evidence": ("sampling.evidence", "log_evidence"),
    "sampling.evidence.laplace_evidence": ("sampling.evidence", "laplace_evidence"),
    "sampling.evidence.compare_evidence": ("sampling.evidence", "compare_evidence"),
    "sampling.pt.sample_pt": ("sampling.pt", "sample_pt"),
    "sampling.smc.sample_smc": ("sampling.smc", "sample_smc"),
    "sampling.evidence.laplace_evidence_multi": ("sampling.evidence", "laplace_evidence_multi"),
    "sampling.evidence.laplace_evidence_multi_auto": ("sampling.evidence",
                                                      "laplace_evidence_multi_auto"),
    "DirectEmulator.log_evidence_batch": ("models.direct", "DirectEmulator.log_evidence_batch"),
    "DirectEmulator.fit_advi": ("models.direct", "DirectEmulator.fit_advi"),
    "DirectEmulator.fit_flow": ("models.direct", "DirectEmulator.fit_flow"),
    "vi.fit_advi": ("vi", "fit_advi"),
    "vi.fit_advi_batch": ("vi", "fit_advi_batch"),
    "flows.fit_flow": ("flows", "fit_flow"),
    "flows.fit_flow_batch": ("flows", "fit_flow_batch"),
    "flows.flow_evidence": ("flows", "flow_evidence"),
    "flows.flow_evidence_batch": ("flows", "flow_evidence_batch"),
    "flows.evidence_with_flow": ("flows", "evidence_with_flow"),
    "flows.evidence_with_flow_batch": ("flows", "evidence_with_flow_batch"),
}


@pytest.mark.parametrize("name", sorted(_SIGNATURES))
def test_entry_point_signatures_match_jax(name):
    """Each evidence and variational entry point takes the JAX package's
    parameters, with their defaults, in the same order; the functions
    that build tensors add only the required keyword ``device``."""
    import importlib
    import inspect

    module, attr = _SIGNATURES[name]

    def params(pkg):
        obj = importlib.import_module(f"{pkg}.{module}")
        for part in attr.split("."):
            obj = getattr(obj, part)
        return [(p.name, p.kind, p.default) for p in inspect.signature(obj).parameters.values()]

    mine, theirs = params("tpu21cmvae_torch"), params("tpu21cmvae")
    device = ("device", inspect.Parameter.KEYWORD_ONLY, inspect.Parameter.empty)
    if device in mine:
        mine.remove(device)
        assert not module.startswith("models")
    assert mine == theirs
