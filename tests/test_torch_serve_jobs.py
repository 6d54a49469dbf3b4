"""The port's HTTP service: the marginalized noise specs and the async
jobs (the targets of ``tests/test_serve.py`` ``:485``–``:701``).

Tolerances: a marginalized ``/loglik`` within 1e-5·(|logL| + c/2) +
2e-2 nats of the port's in-process likelihood under the same spec (the
same plain function, called through the service), and within 2e-4 ·
|logL| + 2e-2 of JAX's in-process likelihood under its spec (the JAX
suite's own bound for the served value).
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from _torch_pair import make_pair, one_torch_thread  # noqa: F401

from tpu21cmvae_torch.serve import make_server


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


def _url(server, path):
    host, port = server.server_address[:2]
    return f"http://{host}:{port}{path}"


def _post(server, path, payload):
    req = urllib.request.Request(_url(server, path), data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(server, path):
    with urllib.request.urlopen(_url(server, path), timeout=30) as r:
        return json.loads(r.read())


def _in_process(model, obs, spec, rows):
    with torch.no_grad():
        return model.loglik_fn(obs, spec)(model.params, torch.as_tensor(rows)).numpy()


def test_foreground_marginalized_endpoints(server, pair, splits):
    """``fg_terms`` marginalizes a linear foreground out of the served
    likelihood: the value matches both packages' in-process likelihood
    under the spec, the cache keys on its value, ``/sample`` and
    ``/evidence`` run under it, and a bad basis is a 400."""
    from tpu21cmvae.foregrounds import linlog_basis

    jm, model = pair
    rng = np.random.default_rng(5)
    F = linlog_basis(model.frequencies, 4)
    sig = np.asarray(model.predict(splits.par_test[0]))
    obs = (sig + F @ np.array([800.0, -60.0, 20.0, -4.0])
           + rng.normal(0, 5, sig.shape)).astype(np.float32)
    rows = np.asarray(splits.par_test[:9], np.float32)
    fg = {"fg_terms": 4, "fg_basis": "linlog"}
    got = np.asarray(_post(server, "/loglik", {"params": rows.tolist(), "obs": obs.tolist(),
                                               "noise_var": 25.0, **fg})["loglik"])
    mine = _in_process(model, obs, model.marginalize_foreground(25.0, n_terms=4), rows)
    np.testing.assert_allclose(got, mine, rtol=1e-5, atol=2e-2)
    jmn = jm.marginalize_foreground(25.0, n_terms=4, basis="linlog")
    want = np.asarray(jm.loglik_fn(obs, jmn)(jm.params, rows))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-2)
    svc = server.service
    n_cached = len(svc._loglik)
    _post(server, "/loglik", {"params": rows.tolist(), "obs": obs.tolist(), "noise_var": 25.0,
                              **fg})
    assert len(svc._loglik) == n_cached
    _post(server, "/loglik", {"params": rows.tolist(), "obs": obs.tolist(), "noise_var": 25.0,
                              "fg_terms": 3})
    assert len(svc._loglik) == n_cached + 1
    out = _post(server, "/sample", {"obs": obs.tolist(), "noise_var": 25.0, **fg,
                                    "n_walkers": 128, "n_steps": 40, "n_warmup": 20,
                                    "thin": 4, "max_samples": 64})
    assert len(out["mean"]) == 7 and np.isfinite(out["mean"]).all()
    out = _post(server, "/evidence", {"obs": obs.tolist(), "noise_var": 25.0, **fg,
                                      "method": "laplace", "n_starts": 256, "n_steps": 200})
    assert np.isfinite(out["logz"])
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server, "/loglik", {"params": rows.tolist(), "obs": obs.tolist(),
                                  "fg_terms": 4, "fg_basis": "sinusoid"})
    assert ei.value.code == 400


def test_scale_marginal_endpoints(server, pair, splits):
    """``noise_scale_marginal`` marginalizes the noise level: the value
    matches both packages' in-process likelihood, it composes with
    ``fg_terms`` and an InvGamma prior, the cache keys on it, alpha
    without the flag is a 400, and ``/sample`` runs under it."""
    from tpu21cmvae.noisescale import marginalize_noise_scale as jax_scale
    from tpu21cmvae_torch.noisescale import marginalize_noise_scale

    jm, model = pair
    rng = np.random.default_rng(9)
    sig = np.asarray(model.predict(splits.par_test[0]))
    obs = (sig + rng.normal(0, 10.0, sig.shape)).astype(np.float32)
    rows = np.asarray(splits.par_test[:7], np.float32)
    nv = np.full(sig.shape[-1], 25.0, np.float32)
    base = {"params": rows.tolist(), "obs": obs.tolist(), "noise_var": 25.0,
            "noise_scale_marginal": True}
    got = np.asarray(_post(server, "/loglik", base)["loglik"])
    np.testing.assert_allclose(got, _in_process(model, obs, marginalize_noise_scale(nv), rows),
                               rtol=1e-5, atol=2e-2)
    np.testing.assert_allclose(got, np.asarray(jm.loglik_fn(obs, jax_scale(nv))(jm.params, rows)),
                               rtol=2e-4, atol=2e-2)
    got2 = np.asarray(_post(server, "/loglik", dict(base, noise_alpha=3.0, noise_beta=2.0,
                                                    fg_terms=3))["loglik"])
    spec2 = marginalize_noise_scale(model.marginalize_foreground(nv, n_terms=3), alpha=3.0,
                                    beta=2.0)
    np.testing.assert_allclose(got2, _in_process(model, obs, spec2, rows), rtol=1e-5, atol=2e-2)
    jspec2 = jax_scale(jm.marginalize_foreground(nv, n_terms=3), alpha=3.0, beta=2.0)
    np.testing.assert_allclose(got2, np.asarray(jm.loglik_fn(obs, jspec2)(jm.params, rows)),
                               rtol=2e-4, atol=2e-2)
    n_cached = len(server.service._loglik)
    _post(server, "/loglik", base)
    assert len(server.service._loglik) == n_cached
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server, "/loglik", {"params": rows.tolist(), "obs": obs.tolist(),
                                  "noise_var": 25.0, "noise_alpha": 3.0})
    assert ei.value.code == 400
    out = _post(server, "/sample", {"obs": obs.tolist(), "noise_var": 25.0,
                                    "noise_scale_marginal": True, "n_walkers": 128,
                                    "n_steps": 40, "n_warmup": 20, "thin": 4, "max_samples": 32})
    assert np.isfinite(out["mean"]).all()


def _poll(server, path, limit=600):
    for _ in range(limit):
        status = _get(server, path)
        if status["status"] in ("done", "error"):
            return status
        time.sleep(0.1)
    raise AssertionError(f"job did not finish: {status}")


def test_async_sample_job_keeps_server_live(server, model, splits):
    """A long ``/sample`` as an async job (202 + ``/result/<id>``): while
    it runs ``/health`` answers at once, a sync ``/sample`` with a short
    ``busy_timeout_s`` gets 503 with a retry hint, and the polled result
    has the sync endpoint's keys; an unknown job id is a 400."""
    obs = np.asarray(model.predict(splits.par_test[3]))
    sub = _post(server, "/sample", {"obs": obs.tolist(), "noise_var": 25.0, "async": True,
                                    "n_walkers": 1024, "n_steps": 800, "n_warmup": 400,
                                    "thin": 10, "seed": 0})
    assert set(sub) == {"job_id", "result_path"}
    t0 = time.monotonic()
    assert _get(server, "/health")["status"] == "ok"
    assert time.monotonic() - t0 < 5.0
    saw_503 = False
    for _ in range(100):
        status = _get(server, sub["result_path"])
        if status["status"] == "running":
            try:
                _post(server, "/sample", {"obs": obs.tolist(), "noise_var": 25.0,
                                          "busy_timeout_s": 0.05, "n_walkers": 64,
                                          "n_steps": 20, "n_warmup": 10, "thin": 5})
            except urllib.error.HTTPError as e:
                assert e.code == 503 and "retry" in json.dumps(json.loads(e.read()))
                saw_503 = True
                break
        elif status["status"] in ("done", "error"):
            break
        time.sleep(0.05)
    status = _poll(server, sub["result_path"])
    assert status["status"] == "done", status
    assert status["sampler"] == "mh" and len(status["mean"]) == 7
    assert status["ess"] is not None and status["ess_tail"] is not None
    print(f"saw_503={saw_503}")
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(server, "/result/nope")
    assert ei.value.code == 400


def test_async_jobs_generalize_to_evidence_and_fit(server, model, splits):
    """Every long POST honors ``async``: ``/evidence`` and ``/fit`` jobs
    end with the sync payloads; an invalid job ends as ``error`` naming
    the option, and the worker lives on."""
    obs = np.asarray(model.predict(splits.par_test[5]))

    def run_job(path, payload):
        sub = _post(server, path, {**payload, "async": True})
        assert set(sub) == {"job_id", "result_path"}
        return _poll(server, sub["result_path"])

    ev = run_job("/evidence", {"obs": obs.tolist(), "noise_var": 25.0, "method": "laplace",
                               "n_starts": 128, "n_steps": 200, "seed": 0})
    assert ev["status"] == "done" and np.isfinite(ev["logz"])
    fit = run_job("/fit", {"obs": obs.tolist(), "noise_var": 25.0, "n_starts": 64,
                           "n_steps": 100, "seed": 0})
    assert fit["status"] == "done" and len(fit["best"]) == 7
    bad = run_job("/fit", {"obs": obs.tolist(), "noise_var": 25.0, "bogus_option": 1})
    assert bad["status"] == "error" and "bogus_option" in bad["error"]
    ev2 = run_job("/evidence", {"obs": obs.tolist(), "noise_var": 25.0, "method": "laplace",
                                "n_starts": 128, "n_steps": 200, "seed": 1})
    assert ev2["status"] == "done"
