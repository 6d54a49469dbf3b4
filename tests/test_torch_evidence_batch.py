"""The port's batched evidence with its khat escalation
(``sampling/evidence.py::laplace_evidence_multi`` and
``laplace_evidence_multi_auto``) and the batched flows
(``flows.py::evidence_with_flow_batch``) against the JAX package's
(``tpu21cmvae/sampling/evidence.py``, ``tpu21cmvae/flows.py``).

Tolerances: the batched Laplace stages against the single-observation
ones on the same whitened points to rtol 1e-4 (Hessians) and 1e-3
(modes, saddle points), their IS estimates within four combined standard
errors; on the small model, each row's log Z within max(0.5, 4 combined
standard errors) of JAX's (the runs draw different randoms); the JAX
suite's analytic targets (``tests/test_flows.py``) at its own
assertions, some at smaller fit budgets (each noted), as a flow step
here is a Python loop over eager tensors.
"""

import math

import numpy as np
import pytest
import torch

from _torch_pair import make_pair, one_torch_thread, train_box  # noqa: F401
from test_torch_flows import (
    _B,
    _BOUNDS,
    _autograd_valgrad,
    _banana_logp,
    _banana_logz_true,
    _banana_valgrad,
    _gauss_logp,
)
from tpu21cmvae_torch.flows import FlowEvidenceResult, evidence_with_flow, evidence_with_flow_batch
from tpu21cmvae_torch.sampling import evidence as tev


@pytest.fixture(scope="module")
def pair(splits):
    return make_pair(splits, (16,))


@pytest.fixture(scope="module")
def tiny(pair, splits):
    jm, tm = pair
    obs = np.asarray(jm.predict(splits.par_test[0]), np.float32)
    return jm, tm, obs, train_box(splits.par_train)


def test_laplace_multi_matches_single_row_by_row():
    """``laplace_evidence_multi`` over two stacked Gaussian observations
    against ``laplace_evidence`` on each: the same modes, Hessians (at the
    same whitened point, to rtol 1e-4) and saddle points, and IS estimates
    within four combined standard errors of each other and the closed
    form."""
    mus = np.array([[0.5, -1.0, 0.2], [-0.5, 0.8, -0.4]], np.float32)
    sig = np.array([0.6, 0.8, 0.4], np.float32)
    logps = [_gauss_logp(m, sig) for m in mus]

    def multi(params, x):
        n = x.shape[0] // 2
        return torch.cat([logps[0](x[:n]), logps[1](x[n:])])

    kw = dict(bounds=_BOUNDS, n_starts=256, n_steps=400, n_is=4096, seed=0, device="cpu")
    res = tev.laplace_evidence_multi(multi, None, 2, **kw)
    lo, hi = torch.as_tensor(_BOUNDS[:, 0]), torch.as_tensor(_BOUNDS[:, 1])
    y = torch.as_tensor(np.stack([r._y_map for r in res]).astype(np.float32))
    h_multi = tev.laplace_hessian(multi, None, lo, hi, None, y)
    log_v = float(np.log(_BOUNDS[:, 1] - _BOUNDS[:, 0]).sum())
    truth = -log_v + float(np.log(sig * math.sqrt(2 * math.pi)).sum())
    for o in range(2):
        one = tev.laplace_evidence(lambda p, x, o=o: logps[o](x), None, **kw)
        h_one = tev.laplace_hessian(lambda p, x, o=o: logps[o](x), None, lo, hi, None, y[o])
        np.testing.assert_allclose(h_multi[o], h_one, rtol=1e-4, atol=1e-4 * np.abs(h_one).max())
        np.testing.assert_allclose(res[o].map_params, one.map_params, atol=1e-3)
        assert res[o].logz_laplace == pytest.approx(one.logz_laplace, abs=1e-3)
        err = math.hypot(res[o].logz_err, one.logz_err)
        assert abs(res[o].logz - one.logz) < max(4 * err, 1e-2)
        assert abs(res[o].logz - truth) < max(4 * res[o].logz_err, 1e-2)
        assert res[o].pd and res[o].method_used == "laplace"


def test_laplace_multi_matches_jax_on_the_small_model(tiny, splits):
    """``laplace_evidence_multi`` on two observations of the small model
    through the stacked contract-tier likelihood: every row's log Z
    within max(0.5, 4 combined standard errors) of JAX's, and the MAP
    log-densities within 0.5 nats."""
    jm, tm, obs, bounds = tiny
    obs2 = np.stack([obs, np.asarray(jm.predict(splits.par_test[1]), np.float32)])
    kw = dict(bounds=bounds, n_starts=256, n_steps=300, n_is=2048, seed=0)
    mine = tev.laplace_evidence_multi(tm.loglik_multi_fn(obs2, 25.0, precision="contract"),
                                      tm.params, 2, device="cpu", **kw)
    from tpu21cmvae.sampling import laplace_evidence_multi

    theirs = laplace_evidence_multi(jm.loglik_multi_fn(obs2, 25.0, precision="contract"),
                                    jm.params, 2, **kw)
    for m, t in zip(mine, theirs):
        assert abs(m.map_logp - t.map_logp) < 0.5, (m.map_logp, t.map_logp)
        err = math.hypot(m.logz_err, t.logz_err)
        assert abs(m.logz - t.logz) < max(0.5, 4 * err), (m.logz, t.logz, err)


def _two_rows():
    """The escalation test's batch: row 0 the banana, row 1 a Gaussian."""
    mu = np.array([0.5, -1.0, 0.2], np.float32)
    sig = np.array([0.6, 0.8, 0.4], np.float32)
    gauss = _gauss_logp(mu, sig)

    def multi_loglik(params, x):
        n = x.shape[0] // 2
        return torch.cat([_banana_logp(x[:n]), gauss(x[n:])])

    row_loglik = [lambda p, x: _banana_logp(x), lambda p, x: gauss(x)]
    row_valgrad = [_banana_valgrad, _autograd_valgrad(gauss)]
    return multi_loglik, dict(row_loglik=lambda i: row_loglik[i],
                              row_valgrad=lambda i: row_valgrad[i])


def test_batched_evidence_khat_escalation_closes_the_loop():
    """``tests/test_flows.py::test_batched_evidence_khat_escalation_closes_the_loop``
    (the ``method="flow"`` and ``final="smc"`` passes on 300-step flows
    after 200-step warm starts and 1024 particles, the JAX suite's 400,
    400 and 2048): under ``"auto"``
    only the flagged banana row escalates, its flow estimate replaces the
    headline fields and matches quadrature; ``"flow"`` attempts every row
    and adopts only a strictly better khat; ``final="smc"`` settles the
    rows that still fail, with khat NaN and the estimator named."""
    multi, rows = _two_rows()
    lap_kw = dict(n_starts=512, n_steps=400, n_is=4096, seed=0, device="cpu")
    base = tev.laplace_evidence_multi_auto(multi, None, 2, bounds=_BOUNDS, method="laplace",
                                           **rows, **lap_kw)
    assert [r.method_used for r in base] == ["laplace", "laplace"]
    thr = float(np.clip((base[0].khat + base[1].khat) / 2, 0.2, 0.7))
    assert base[1].khat < thr < base[0].khat or base[0].khat >= 0.7
    res = tev.laplace_evidence_multi_auto(multi, None, 2, bounds=_BOUNDS, method="auto",
                                          khat_threshold=thr,
                                          flow_kwargs=dict(n_steps=1500, n_mc=256),
                                          **rows, **lap_kw)
    assert res[0].method_used == "flow"
    assert res[1].method_used == "laplace"
    assert isinstance(res[0].escalation, FlowEvidenceResult)
    assert res[1].escalation is None
    assert res[0].logz == res[0].escalation.logz
    assert abs(res[0].logz - _banana_logz_true()) < max(4 * res[0].logz_err, 0.1)
    assert res[0].khat < 0.7
    post = res[0].posterior(4096, seed=2)
    sel = np.abs(post[:, 0] - 2.0) < 0.4
    assert abs(post[sel, 1].mean() - (_B * 4.0 - 1.0)) < 0.35
    assert res[1].logz == base[1].logz
    assert "flow-IS escalation" in res[0].summary()

    allf = tev.laplace_evidence_multi_auto(multi, None, 2, bounds=_BOUNDS, method="flow",
                                           flow_kwargs=dict(n_steps=300, n_mc=128,
                                                            warm_steps=200),
                                           **rows, **lap_kw)
    assert all(isinstance(r.escalation, FlowEvidenceResult) for r in allf)
    for r in allf:
        if r.method_used == "flow":
            assert r.khat == r.escalation.khat
        else:
            assert r.khat <= r.escalation.khat
    with pytest.raises(ValueError, match="'laplace', 'auto' or 'flow'"):
        tev.laplace_evidence_multi_auto(multi, None, 2, bounds=_BOUNDS, method="typo", **rows,
                                        device="cpu")

    fin = tev.laplace_evidence_multi_auto(multi, None, 2, bounds=_BOUNDS, method="auto",
                                          khat_threshold=0.02,
                                          flow_kwargs=dict(n_steps=300, n_mc=128,
                                                           warm_steps=200),
                                          final="smc",
                                          final_kwargs=dict(n_particles=1024, n_mh=8),
                                          **rows, **lap_kw)
    esc = [r for r in fin if r.method_used == "smc"]
    assert esc, [r.method_used for r in fin]
    for r in esc:
        assert r.final_result is not None
        assert np.isnan(r.khat)
        assert np.isfinite(r.logz) and np.isfinite(r.logz_err)
        assert r.posterior(64, seed=0).shape == (64, 3)
        s = r.summary()
        assert "definitive" in s and "Confirm with" not in s
    if fin[0].method_used == "smc":
        assert abs(fin[0].logz - _banana_logz_true()) < max(6 * fin[0].logz_err, 0.3)
    with pytest.raises(ValueError, match="'nested' or 'smc'"):
        tev.laplace_evidence_multi_auto(multi, None, 2, bounds=_BOUNDS, final="typo", **rows,
                                        device="cpu")


def test_batched_escalation_and_nested_final_take_the_stacked_paths():
    """With ``rows_loglik`` and ``rows_valgrad`` the flagged rows' flows fit
    and sweep as one stacked batch (each stacked function made once, on
    both rows) and the remaining rows settle in one ``nested_sampling_batch``
    whose estimates match quadrature; under a ``log_prior`` a nested final
    without its ``prior_transform`` is refused."""
    multi, rows = _two_rows()
    calls = []

    def rows_loglik(idx):
        calls.append(("loglik", list(idx)))
        return multi

    def rows_valgrad(idx):
        calls.append(("valgrad", list(idx)))
        return _autograd_valgrad(lambda x: multi(None, x))

    kw = dict(bounds=_BOUNDS, n_starts=256, n_steps=300, n_is=2048, seed=0, device="cpu")
    res = tev.laplace_evidence_multi_auto(
        multi, None, 2, method="flow", khat_threshold=-np.inf,
        flow_kwargs=dict(n_steps=200, n_mc=64, warm_steps=100), final="nested",
        final_kwargs=dict(n_live=256, n_mh=12), rows_loglik=rows_loglik,
        rows_valgrad=rows_valgrad, **rows, **kw)
    assert ("valgrad", [0, 1]) in calls and ("loglik", [0, 1]) in calls
    assert calls.count(("loglik", [0, 1])) == 2  # the flow sweep, then nested
    mu, sig = np.array([0.5, -1.0, 0.2]), np.array([0.6, 0.8, 0.4])
    log_v = float(np.log(_BOUNDS[:, 1] - _BOUNDS[:, 0]).sum())
    truths = (_banana_logz_true(), -log_v + float(np.log(sig * math.sqrt(2 * math.pi)).sum()))
    for r, truth in zip(res, truths):
        assert isinstance(r.escalation, FlowEvidenceResult)
        assert r.method_used == "nested" and np.isnan(r.khat)
        assert abs(r.logz - truth) < max(4 * r.logz_err, 0.3), (r.logz, truth)
        assert r.posterior(16, seed=1).shape == (16, 3)
    del mu
    with pytest.raises(ValueError, match="prior_transform"):
        tev.laplace_evidence_multi_auto(multi, None, 2, method="laplace", final="nested",
                                        khat_threshold=1e9, log_prior=lambda x: x[:, 0] * 0.0,
                                        rows_loglik=rows_loglik, **rows, **kw)


def test_flow_batch_matches_sequential_on_mixed_rows():
    """``tests/test_flows.py::test_flow_batch_matches_sequential_on_mixed_rows``
    (fits of 700 steps, the JAX suite's 900): two stacked flows, one
    Gaussian and one banana, each reproduce their closed-form evidence at
    a healthy weight ESS, and the banana row agrees with the sequential
    path."""
    mu_g = np.array([0.5, -1.0, 0.5], np.float32)
    sig_g = np.array([0.4, 0.6, 0.3], np.float32)
    gauss = _gauss_logp(mu_g, sig_g)

    def ll_multi(params, x):
        xr = x.reshape(2, x.shape[0] // 2, 3)
        return torch.cat([gauss(xr[0]), _banana_logp(xr[1])])

    kw = dict(bounds=_BOUNDS, n_steps=700, n_mc=128, n_is=8192, device="cpu")
    batch = evidence_with_flow_batch(ll_multi, _autograd_valgrad(lambda x: ll_multi(None, x)),
                                     None, 2, seed=0, **kw)
    assert len(batch) == 2
    log_v = float(np.log((_BOUNDS[:, 1] - _BOUNDS[:, 0]).astype(np.float64)).sum())
    true_g = -log_v + sum(math.log(s * math.sqrt(2 * math.pi)) for s in sig_g)
    for r, true in zip(batch, (true_g, _banana_logz_true())):
        assert abs(r.logz - true) < max(0.1, 4 * r.logz_err), (r.logz, true)
        assert r.is_ess > 0.2 * r.n_draws
        assert r.flow is not None
    seq = evidence_with_flow(lambda p, x: _banana_logp(x), _banana_valgrad, None, seed=11, **kw)
    assert abs(batch[1].logz - seq.logz) < max(0.15, 4 * math.hypot(batch[1].logz_err,
                                                                     seq.logz_err))
    assert batch[1].posterior(256, seed=5).shape == (256, 3)


def test_model_log_evidence_batch_matches_jax(tiny, splits):
    """``DirectEmulator.log_evidence_batch`` on two observations of the
    small model: under ``method="laplace"`` each row's log Z within
    max(0.5, 4 combined standard errors) of JAX's; under ``"flow"`` with
    ``final="nested"`` and ``"smc"`` (``khat_threshold=-inf``: every row
    through every stage) each row ends on the named definitive estimator,
    finite, its flow attempt on the record, and within max(1, 6 combined
    standard errors) of its Laplace estimate; a mesh is refused."""
    jm, tm, obs, bounds = tiny
    obs2 = np.stack([obs, np.asarray(jm.predict(splits.par_test[1]), np.float32)])
    kw = dict(bounds=bounds, n_starts=128, n_steps=200, n_is=2048, seed=0)
    mine = tm.log_evidence_batch(obs2, 25.0, method="laplace", **kw)
    theirs = jm.log_evidence_batch(obs2, 25.0, method="laplace", **kw)
    for m, t in zip(mine, theirs):
        assert m.method_used == t.method_used == "laplace"
        err = math.hypot(m.logz_err, t.logz_err)
        assert abs(m.logz - t.logz) < max(0.5, 4 * err), (m.logz, t.logz, err)
    for final, fkw in (("nested", dict(n_live=128, n_mh=8)), ("smc", dict(n_particles=512))):
        res = tm.log_evidence_batch(obs2, 25.0, method="flow", khat_threshold=-np.inf,
                                    final=final, final_kwargs=fkw,
                                    flow_kwargs=dict(n_steps=80, warm_steps=40, n_mc=64,
                                                     n_is=1024), **kw)
        for r, lap in zip(res, mine):
            assert r.method_used == final and np.isnan(r.khat)
            assert isinstance(r.escalation, FlowEvidenceResult) and r.final_result is not None
            assert np.isfinite(r.logz) and np.isfinite(r.logz_err)
            err = math.hypot(r.logz_err, lap.logz_err)
            assert abs(r.logz - lap.logz) < max(1.0, 6 * err), (final, r.logz, lap.logz)
    with pytest.raises(TypeError, match="Mesh"):
        tm.log_evidence_batch(obs2, 25.0, mesh=object(), **kw)


def test_flow_batch_matches_jax_on_its_draws(monkeypatch):
    """``evidence_with_flow_batch`` on two stacked Gaussian rows with row
    centres, fed the normals JAX draws from its keys (the batched ADVI
    warm start's ``split(key(seed), warm)``, each row's couplings from
    ``fold_in(k_init, o)``, the fit's ``split(k_fit, n_steps)``, the sweep's
    ``key(seed + 1)``; ``flows.py:718-770,830-878``): every row's flow
    parameters and ELBO trace equal JAX's to 1e-4, and its log Z to 1e-3."""
    import jax
    import jax.numpy as jnp

    from test_torch_vi import feed
    from tpu21cmvae import flows as jfl

    n_obs, n_steps, warm, n_mc, n_layers, width, n_is, seed = 2, 4, 3, 32, 2, 8, 512, 5
    mus = np.array([[1.5, -2.5, 1.1], [-1.0, 2.0, 0.5]], np.float32)
    sig = np.array([0.6, 0.5, 0.4], np.float32)

    def jax_ll(params, x):
        z = (x.reshape(n_obs, -1, 3) - mus[:, None, :]) / sig
        return (-0.5 * jnp.sum(z * z, -1)).reshape(-1)

    def jax_vg(params, x):
        z = (x.reshape(n_obs, -1, 3) - mus[:, None, :]) / sig
        return (-0.5 * jnp.sum(z * z, -1)).reshape(-1), (-z / sig).reshape(-1, 3)

    def torch_ll(params, x):
        z = (x.reshape(n_obs, -1, 3) - torch.as_tensor(mus)[:, None, :]) / torch.as_tensor(sig)
        return (-0.5 * torch.sum(z * z, -1)).reshape(-1)

    x0 = np.array([[1.0, -2.0, 1.0], [-0.5, 1.5, 0.2]])
    kw = dict(bounds=_BOUNDS, n_steps=n_steps, n_mc=n_mc, n_layers=n_layers, width=width,
              warm_steps=warm, x0=x0, n_is=n_is, seed=seed)
    theirs = jfl.evidence_with_flow_batch(jax_ll, jax_vg, None, n_obs, **kw)
    k_init, k_fit = jax.random.split(jax.random.key(seed))
    draws = [jax.random.normal(k, (n_obs, n_mc, 3), jnp.float32)
             for k in jax.random.split(jax.random.key(seed), warm)]
    for o in range(n_obs):
        key = jax.random.fold_in(k_init, o)
        for _ in range(n_layers):
            key, k1 = jax.random.split(key)
            draws.append(jax.random.normal(k1, (3, width), jnp.float32))
    draws += [jax.random.normal(k, (n_obs, n_mc, 3), jnp.float32)
              for k in jax.random.split(k_fit, n_steps)]
    draws.append(jax.random.normal(jax.random.key(seed + 1), (n_obs, n_is, 3), jnp.float32))
    queue = feed(monkeypatch, draws)
    mine = evidence_with_flow_batch(torch_ll, _autograd_valgrad(lambda x: torch_ll(None, x)),
                                    None, n_obs, device="cpu", **kw)
    assert not queue
    for m, t in zip(mine, theirs):
        np.testing.assert_allclose(m.flow.elbo, t.flow.elbo, rtol=1e-4, atol=1e-4)
        got, want = m.flow.theta, t.flow.theta
        for k in ("mu", "d", "a"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4)
        for gl, wl in zip(got["layers"], want["layers"]):
            for k in ("w1", "b1", "w2", "b2"):
                np.testing.assert_allclose(gl[k], np.asarray(wl[k]), rtol=1e-4, atol=1e-4)
        assert m.logz == pytest.approx(t.logz, abs=1e-3)
        assert m.khat == pytest.approx(t.khat, abs=1e-2)
