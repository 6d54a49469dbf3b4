"""The port's HTTP service: the inference endpoints (``/sample``,
``/fit``, ``/evidence``, ``/gof``; the targets of ``tests/test_serve.py``
from ``:329``), held to the JAX service on the same weights.

The port's samplers draw from torch generators, JAX's from its keys, so
the two services agree in schema and in statistics, not draw for draw.
Tolerances, on this small model (each several times the spread measured
on three observations): ``/fit``'s best logL within 1.5 nats of JAX's
(256 starts × 300 steps; measured ≤ 0.6), Laplace's log Z within 0.25
nats (measured ≤ 0.015), and ``/sample``'s posterior means within 0.5
of JAX's posterior sd per parameter (256 walkers, 200 + 200 steps;
measured ≤ 0.19), its sds within a factor 1.25 (measured 0.91–1.10).
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from _torch_pair import make_pair, one_torch_thread  # noqa: F401

from tpu21cmvae_torch.serve import EmulatorService, make_server


@pytest.fixture(scope="module")
def pair(splits):
    return make_pair(splits, (48, 56))


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


@pytest.fixture(scope="module")
def server(model):
    srv = make_server(model, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srv
    srv.shutdown()


@pytest.fixture(scope="module")
def jax_service(pair):
    from tpu21cmvae.serve import EmulatorService as JaxService

    return JaxService(pair[0])


@pytest.fixture(scope="module")
def bounds(splits):
    par = np.asarray(splits.par_train, np.float64)
    lo, hi = par.min(0), par.max(0)
    lo[:3] = np.maximum(lo[:3], 1e-6)
    return np.stack([lo, hi], 1).tolist()


def _obs(model, splits, k, noise=5.0):
    truth = np.asarray(splits.par_test[k], np.float32)
    rng = np.random.default_rng(k)
    return truth, np.asarray(model.predict(truth)) + rng.normal(0, noise, 451)


def _url(server, path):
    host, port = server.server_address[:2]
    return f"http://{host}:{port}{path}"


def _post(server, path, payload):
    req = urllib.request.Request(_url(server, path), data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _code(server, path, payload) -> int:
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server, path, payload)
    return ei.value.code


def test_sample_mh_and_pt_match_jax(server, jax_service, model, splits, bounds):
    """``/sample`` returns JAX's keys, and its MH posterior JAX's
    statistics; PT adds the swap rates and the ladder; bad options are
    400s, as in JAX."""
    _, obs = _obs(model, splits, 0)
    req = {"obs": obs.tolist(), "noise_var": 25.0, "bounds": bounds, "n_walkers": 256,
           "n_steps": 200, "n_warmup": 200, "thin": 5, "seed": 0, "max_samples": 50}
    out = _post(server, "/sample", req)
    want = jax_service.sample(obs, 25.0, **{k: v for k, v in req.items()
                                            if k not in ("obs", "noise_var")})
    assert set(out) == set(want)
    assert out["sampler"] == "mh" and len(out["mean"]) == 7 and len(out["ess"]) == 7
    assert 1 <= len(out["samples"]) <= 50 and out["accept_rate"] > 0.05
    sd = np.asarray(want["std"])
    assert (np.abs(np.asarray(out["mean"]) - want["mean"]) <= 0.5 * sd).all()
    assert (np.abs(np.log(np.asarray(out["std"]) / sd)) <= np.log(1.25)).all()
    assert out["quantiles"]["0.5"][3] == pytest.approx(out["mean"][3], abs=5 * out["std"][3])
    assert _post(server, "/sample", dict(req, seed=1))["mean"] != out["mean"]

    pt_req = dict(req, sampler="pt", n_rungs=8, n_walkers=32, n_steps=20, n_warmup=20)
    pt = _post(server, "/sample", pt_req)
    pt_jax = jax_service.sample(obs, 25.0, **{k: v for k, v in pt_req.items()
                                              if k not in ("obs", "noise_var")})
    assert set(pt) == set(pt_jax)
    assert len(pt["swap_rate"]) == 7 and pt["betas"][-1] == 1.0
    for bad in (dict(req, n_walkers=10**6), dict(req, bogus=1), dict(req, sampler="hmc")):
        assert _code(server, "/sample", bad) == 400


def test_fit_matches_jax(server, jax_service, model, splits, bounds):
    truth, obs = _obs(model, splits, 2)
    req = {"obs": obs.tolist(), "noise_var": 25.0, "bounds": bounds, "n_starts": 256,
           "n_steps": 300, "seed": 0, "top": 5}
    out = _post(server, "/fit", req)
    want = jax_service.fit(obs, 25.0, **{k: v for k, v in req.items()
                                         if k not in ("obs", "noise_var")})
    assert set(out) == set(want)
    assert len(out["best"]) == 7 and len(out["top"]) == 5
    assert out["top_logp"][0] == pytest.approx(out["best_logp"])
    assert out["top_logp"] == sorted(out["top_logp"], reverse=True)
    lo, hi = np.asarray(bounds).T
    best = np.asarray(out["best"])
    assert (best >= lo - 1e-6).all() and (best <= hi + 1e-6).all()
    assert abs(out["best_logp"] - want["best_logp"]) <= 1.5
    for bad in (dict(req, n_starts=10**6), dict(req, bogus=1), dict(req, top=0)):
        assert _code(server, "/fit", bad) == 400


def test_evidence_methods_match_jax(server, jax_service, model, splits, bounds):
    """``/evidence``: Laplace (MAP and covariance) within 0.25 nats of
    JAX's; nested and SMC with an error bar and a posterior block, within
    a few nats of Laplace as in the JAX suite; JAX's keys for each
    method; bad methods and caps are 400s."""
    _, obs = _obs(model, splits, 0)
    req = {"obs": obs.tolist(), "noise_var": 25.0, "bounds": bounds, "seed": 0}
    opts = {k: v for k, v in req.items() if k not in ("obs", "noise_var")}
    lap = _post(server, "/evidence", dict(req, n_starts=256, n_steps=400))
    lap_jax = jax_service.evidence(obs, 25.0, n_starts=256, n_steps=400, **opts)
    assert set(lap) == set(lap_jax) and lap["method"] == "laplace"
    assert np.asarray(lap["cov"]).shape == (7, 7) and len(lap["map_params"]) == 7
    assert abs(lap["logz"] - lap_jax["logz"]) <= 0.25
    nes = _post(server, "/evidence", dict(req, method="nested", n_live=256, n_mh=8,
                                          max_samples=64))
    assert np.isfinite(nes["logz"]) and nes["logz_err"] > 0
    assert 1 <= len(nes["posterior"]) <= 64
    assert abs(lap["logz"] - nes["logz"]) < 6.0
    smc = _post(server, "/evidence", dict(req, method="smc", n_particles=512, n_mh=4,
                                          max_samples=64))
    assert np.isfinite(smc["logz"]) and smc["logz_err"] >= 0 and smc["n_stages"] >= 2
    assert 1 <= len(smc["posterior"]) <= 64 and abs(smc["logz"] - nes["logz"]) < 6.0
    for method, extra in (("nested", dict(n_live=64, n_mh=2, max_samples=8)),
                          ("smc", dict(n_particles=64, n_mh=2, max_samples=8))):
        jax_keys = set(jax_service.evidence(obs, 25.0, method=method, **extra, **opts))
        assert set({"nested": nes, "smc": smc}[method]) == jax_keys
    for bad in (dict(req, method="ladder"), dict(req, n_live=10**6),
                dict(req, method="smc", n_particles=10**6), dict(req, bogus=1)):
        assert _code(server, "/evidence", bad) == 400


def test_gof_endpoint_matches_jax(server, jax_service, model, splits):
    """``/gof`` on truth-jittered draws: clean passes and matches JAX's
    p-value (one predict of the same draws, at the contract tier), a
    ripple is flagged, the foreground spec drops K dof, and missing
    draws, the scale-marginal spec and unknown options are 400s."""
    rng = np.random.default_rng(3)
    truth = np.asarray(splits.par_test[0], np.float64)
    clean = np.asarray(model.predict(truth))
    obs = clean + rng.normal(0.0, 5.0, clean.shape)
    draws = (truth[None] * (1 + rng.normal(0, 1e-4, (64, 7)))).tolist()
    out = _post(server, "/gof", {"obs": obs.tolist(), "noise_var": 25.0, "draws": draws})
    want = jax_service.gof(obs, 25.0, draws=draws)
    assert set(out) == set(want)
    assert 0.01 < out["p_value"] < 0.99 and out["dof"] == clean.shape[0]
    assert out["p_value"] == pytest.approx(want["p_value"], abs=1e-3)
    assert out["q_over_dof"] == pytest.approx(want["q_over_dof"], rel=1e-4)
    assert "no evidence" in out["summary"]
    nu = np.asarray(model.frequencies)
    bad = obs + 25.0 * np.sin(2 * np.pi * (nu - nu.min()) / 8.0)
    out_bad = _post(server, "/gof", {"obs": bad.tolist(), "noise_var": 25.0, "draws": draws})
    assert out_bad["p_value"] < 0.01 and out_bad["max_bin_z"] > 3.0
    out_fg = _post(server, "/gof", {"obs": obs.tolist(), "noise_var": 25.0, "draws": draws,
                                    "fg_terms": 4})
    assert out_fg["dof"] == clean.shape[0] - 4
    for payload in ({"obs": obs.tolist(), "noise_var": 25.0},
                    {"obs": obs.tolist(), "noise_var": 25.0, "draws": draws,
                     "noise_scale_marginal": True},
                    {"obs": obs.tolist(), "noise_var": 25.0, "draws": draws, "bogus_option": 1}):
        assert _code(server, "/gof", payload) == 400


def test_kernel_route_on_the_cpu(model, splits, bounds):
    """The routing a CUDA model takes, run here on the kernels' plain
    versions: the service's likelihood is a RoutedLoglik whose value is
    the K2 wrapper and whose ``valgrad`` is the K3 wrapper at the same
    tier; ``/fit`` goes through K3's operands, Laplace too; repeated
    requests on one observation reuse one wrapper, whose operands fold
    once."""
    from tpu21cmvae_torch.ops.kernels.fused_loglik import FusedLoglikGradGram
    from tpu21cmvae_torch.ops.loglik import KernelLoglik
    from tpu21cmvae_torch.sampling._common import RoutedLoglik

    svc = EmulatorService(model)
    svc.backend = "kernel"
    _, obs = _obs(model, splits, 5)
    rows = np.asarray(splits.par_test[:9], np.float32)
    plain = svc.loglik(rows, obs, 25.0)
    (sharded, fn), = svc._loglik.values()
    assert isinstance(fn, RoutedLoglik) and isinstance(fn.value, KernelLoglik)
    assert isinstance(fn.valgrad, FusedLoglikGradGram) and fn.valgrad.tier == fn.value.fused.tier
    assert sharded.fns[0] is fn
    with torch.no_grad():
        want = model.loglik_fn(obs, 25.0)(model.params, torch.as_tensor(rows)).numpy()
    np.testing.assert_allclose(plain, want, rtol=1e-5, atol=1e-2)
    fit = svc.fit(obs, 25.0, n_starts=64, n_steps=60, bounds=bounds, seed=0, top=3)
    lap = svc.evidence(obs, 25.0, n_starts=64, n_steps=100, bounds=bounds, seed=0)
    svc.sample(obs, 25.0, n_walkers=32, n_steps=10, n_warmup=10, thin=5, bounds=bounds)
    svc.loglik(rows, obs, 25.0)
    assert list(svc._loglik.values())[0][1] is fn
    assert fn.value.fused.operands.folds == 1 and fn.valgrad.operands.folds == 1
    assert np.isfinite(fit["best_logp"]) and np.isfinite(lap["logz"]) and lap["pd"]
