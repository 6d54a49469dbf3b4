"""The port's HTTP service: the plumbing and the value endpoints (the
targets of ``tests/test_serve.py`` up to the sampling endpoints), with
the JAX service on the same weights as the reference.

The real stdlib server runs on a free port in a daemon thread; urllib
talks to it. Tolerances: ``/predict`` within 1e-5 of the signal
amplitude of JAX's; ``/loglik`` at the served tier within the bf16x3
bound of the kernels' tests, 1e-4·(|logL| + c/2) + 1e-2 nats (``c`` the
gram fold's constant: the plain bf16x3 emulation against JAX's fp32 CPU
matmuls), and within 1e-5·(|logL| + c/2) + 1e-2 of the port's own
in-process likelihood.
"""

import gc
import json
import threading
import time
import urllib.error
import urllib.request
import weakref

import numpy as np
import pytest
import torch

from _torch_pair import make_pair, one_torch_thread  # noqa: F401

from tpu21cmvae_torch.serve import MAX_BODY_BYTES, EmulatorService, load_obs_specs, make_server


@pytest.fixture(scope="module")
def pair(splits):
    return make_pair(splits, (48, 56))


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


def _start(model):
    srv = make_server(model, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture(scope="module")
def server(model):
    srv = _start(model)
    yield srv
    srv.shutdown()


@pytest.fixture(scope="module")
def jax_server(pair):
    from tpu21cmvae.serve import make_server as jax_make_server

    srv = jax_make_server(pair[0], port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srv
    srv.shutdown()


def _url(server, path):
    host, port = server.server_address[:2]
    return f"http://{host}:{port}{path}"


def _post(server, path, payload):
    req = urllib.request.Request(_url(server, path), data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _status(server, path, payload) -> int:
    try:
        _post(server, path, payload)
    except urllib.error.HTTPError as e:
        return e.code
    return 200


def _half_c(model, obs, nv) -> float:
    fused = model.loglik_fn(obs, nv, backend="kernel").fused
    return 0.5 * float(fused.operands(model.params).c)


def test_health_keys_and_values_match_jax(server, jax_server, model):
    with urllib.request.urlopen(_url(server, "/health"), timeout=60) as r:
        h = json.loads(r.read())
    with urllib.request.urlopen(_url(jax_server, "/health"), timeout=60) as r:
        hj = json.loads(r.read())
    assert set(h) == set(hj)
    assert h["status"] == "ok" and h["kind"] == "DirectEmulator"
    assert h["n_bins"] == model.config.n_bins and h["par_labels"][0] == "fstar"
    assert {k: h[k] for k in h if k != "devices"} == {k: hj[k] for k in hj if k != "devices"}
    assert h["devices"] == ["cpu"]


def test_predict_matches_model_and_jax(server, jax_server, model, splits):
    rows = np.asarray(splits.par_test[:13], np.float32)
    out = _post(server, "/predict", {"params": rows.tolist()})
    outj = _post(jax_server, "/predict", {"params": rows.tolist()})
    assert set(out) == set(outj) == {"signals"}
    got = np.asarray(out["signals"], np.float32)
    assert got.shape == (13, model.config.n_bins)
    np.testing.assert_array_equal(got, model.predict(rows))
    want = np.asarray(outj["signals"], np.float32)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_loglik_matches_jax_at_the_served_tier(server, jax_server, model, splits):
    obs = model.predict(splits.par_test[0]) + np.random.default_rng(2).normal(0, 5.0, 451)
    rows = np.asarray(splits.par_test[:9], np.float32)
    req = {"params": rows.tolist(), "obs": obs.tolist(), "noise_var": 25.0}
    out, outj = _post(server, "/loglik", req), _post(jax_server, "/loglik", req)
    assert set(out) == set(outj) == {"loglik"}
    got, want = np.asarray(out["loglik"]), np.asarray(outj["loglik"])
    assert got.shape == (9,)
    half_c = _half_c(model, obs.astype(np.float32), 25.0)
    assert (np.abs(got - want) <= 1e-4 * (np.abs(want) + half_c) + 1e-2).all()
    with torch.no_grad():
        mine = model.loglik_fn(obs, 25.0)(model.params, torch.as_tensor(rows)).numpy()
    assert (np.abs(got - mine) <= 1e-5 * (np.abs(mine) + half_c) + 1e-2).all()
    # a second call on the same observation reuses the cached entry
    n_cached = len(server.service._loglik)
    _post(server, "/loglik", req)
    assert len(server.service._loglik) == n_cached


def test_status_codes_match_jax(server, jax_server, splits):
    """The same malformed requests get the same codes from both services:
    400 for a bad body, 404 for an unknown path, 413 for a declared body
    over the cap (before any of it is read)."""
    for path, payload in (("/predict", {"wrong": 1}), ("/nowhere", {}),
                          ("/loglik", {"params": [[0.1] * 7]}),
                          ("/sample", {"obs": [0.0] * 451, "sampler": "hmc"})):
        assert _status(server, path, payload) == _status(jax_server, path, payload)
    assert _status(server, "/predict", {"wrong": 1}) == 400

    def oversized(srv):
        req = urllib.request.Request(_url(srv, "/predict"), data=b"x" * 64, headers={
            "Content-Type": "application/json", "Content-Length": str(MAX_BODY_BYTES + 1)})
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=60)
        return exc.value.code, json.loads(exc.value.read())

    (code, body), (code_j, _) = oversized(server), oversized(jax_server)
    assert code == code_j == 413 and "limit" in body["error"]


def test_service_embeddable_and_warmup_up_to(model, splits):
    svc = EmulatorService(model)
    svc.warmup((1, 64))
    assert svc.predict(splits.par_test[:3]).shape == (3, model.config.n_bins)
    assert svc.predict(splits.par_test[0]).shape == (1, model.config.n_bins)
    seen = []
    real = svc._sharded.fns[0]
    svc._sharded.fns[0] = lambda p, x: (seen.append(x.shape[0]), real(p, x))[1]
    svc.warmup(up_to=64)  # quantum 8 → buckets 8, 16, 32, 64
    assert seen == [8, 16, 32, 64]
    for n in (3, 11, 30, 60):
        assert svc.predict(np.zeros((n, 7), np.float32) + 0.5).shape[0] == n


def test_idle_keepalive_client_does_not_block_server(server):
    import http.client

    host, port = server.server_address[:2]
    c1 = http.client.HTTPConnection(host, port, timeout=30)
    c1.request("GET", "/health")
    r1 = c1.getresponse()
    assert r1.status == 200 and r1.getheader("Connection") == "close"
    r1.read()
    with urllib.request.urlopen(_url(server, "/health"), timeout=30) as r2:
        assert json.loads(r2.read())["status"] == "ok"
    c1.close()


def test_malformed_loglik_does_not_poison_cache(server, model, splits):
    obs = model.predict(splits.par_test[0])
    rows = np.asarray(splits.par_test[:4], np.float32).tolist()
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server, "/loglik", {"params": rows, "obs": [obs.tolist()], "noise_var": 25.0})
    assert ei.value.code == 400 and "flat list" in json.loads(ei.value.read())["error"]
    out = _post(server, "/loglik", {"params": rows, "obs": obs.tolist(), "noise_var": 25.0})
    assert np.isfinite(out["loglik"]).all()


def test_warmup_loglik_first_request_is_warm(model, splits):
    """A warmed (obs, noise_var) pair builds nothing at its first request:
    with the builder poisoned, the warm one still answers and a cold one
    fails."""
    svc = EmulatorService(model, loglik_cache=4)
    obs = np.asarray(splits.signal_test[0], np.float32)
    svc.warmup_loglik([(obs, 25.0)], batch_sizes=(4,))
    real = svc.model.loglik_fn

    def poisoned(*a, **k):
        raise AssertionError("cold build after warmup")

    svc.model.loglik_fn = poisoned
    try:
        out = svc.loglik(splits.par_test[:3], obs, 25.0)
        assert out.shape == (3,) and np.isfinite(out).all()
        with pytest.raises(AssertionError, match="cold build"):
            svc.loglik(splits.par_test[:3], obs + 1.0, 25.0)
    finally:
        del svc.model.loglik_fn
    assert svc.model.loglik_fn == real


def test_lru_cap_and_eviction_frees_the_wrappers(model, splits):
    """The LRU is the only owner of its entries: warmed entries respect
    the cap, and an evicted entry's likelihood — a wrapper with its own
    folded operands (``memo=False``) — is collected. The port's form of
    the JAX suite's eviction test."""
    svc = EmulatorService(model, loglik_cache=2)
    base = np.asarray(splits.signal_test[0], np.float32)
    svc.warmup_loglik([(base + i, 25.0) for i in range(4)], batch_sizes=(4,))
    assert len(svc._loglik) == 2

    svc = EmulatorService(model, loglik_cache=1)
    kernel_value = model.loglik_fn(base, 25.0, backend="kernel", memo=False)
    ops_ref = weakref.ref(kernel_value.fused.operands(model.params))
    svc._build_loglik = lambda m, o, nv: kernel_value
    svc.loglik(splits.par_test[:4], base, 25.0)
    ref = weakref.ref(kernel_value)
    del kernel_value, svc._build_loglik
    assert ref() is not None  # held by the LRU alone
    assert model.loglik_fn(base, 25.0, backend="kernel") is not ref()  # no memo holds it
    svc.loglik(splits.par_test[:4], base + 1.0, 25.0)  # cap 1 → evicts the first
    gc.collect()
    assert ref() is None and ops_ref() is None, "evicted wrapper or its operands still pinned"


def test_health_answers_during_long_device_call(server):
    svc = server.service
    real = svc._sharded

    class Slow:
        def __call__(self, params):
            time.sleep(2.0)
            return real(params)

    svc._sharded = Slow()
    try:
        t = threading.Thread(target=lambda: _post(
            server, "/predict", {"params": [[0.05, 16, 1, 0.06, 1.3, 2, 30]]}), daemon=True)
        t.start()
        time.sleep(0.3)
        t0 = time.perf_counter()
        with urllib.request.urlopen(_url(server, "/health"), timeout=60) as r:
            assert json.loads(r.read())["status"] == "ok"
        assert time.perf_counter() - t0 < 1.5
        t.join(timeout=30)
    finally:
        svc._sharded = real


def test_requests_in_fresh_threads_build_no_graph(server, model, splits):
    """Grad mode is thread-local and every request runs in a new thread:
    the likelihood call inside a request sees grad mode off and returns
    a tensor with no graph, though the weights require grad."""
    assert all(t.requires_grad for layer in model.params for t in layer.values())
    obs = np.asarray(splits.signal_test[1], np.float32)
    _post(server, "/loglik", {"params": [[0.05, 16, 1, 0.06, 1.3, 2, 30]], "obs": obs.tolist(),
                              "noise_var": 25.0})
    sharded = next(reversed(server.service._loglik.values()))[0]  # the newest entry
    real = sharded.fns[0]
    seen = []

    def recording(p, x):
        out = real(p, x)
        seen.append((threading.current_thread() is threading.main_thread(),
                     torch.is_grad_enabled(), out.requires_grad, out.grad_fn))
        return out

    sharded.fns[0] = recording
    try:
        _post(server, "/loglik", {"params": [[0.05, 16, 1, 0.06, 1.3, 2, 30]],
                                  "obs": obs.tolist(), "noise_var": 25.0})
    finally:
        sharded.fns[0] = real
    assert seen == [(False, False, False, None)]


def test_load_obs_specs_roundtrip(tmp_path, splits):
    """The spec files read as JAX's ``load_obs_specs`` reads them."""
    from tpu21cmvae.serve import load_obs_specs as jax_load

    obs = np.asarray(splits.signal_test[:2], np.float32)
    jpath = tmp_path / "specs.json"
    jpath.write_text(json.dumps([{"obs": obs[0].tolist(), "noise_var": 25.0},
                                 {"obs": obs[1].tolist()}]))
    npath = tmp_path / "specs.npz"
    curve = np.linspace(1.0, 2.0, obs.shape[1]).astype(np.float32)
    for path, blob in ((jpath, None), (npath, dict(noise_var=np.float32(9.0))),
                       (npath, dict(noise_var=np.array([25.0, 16.0]))),
                       (npath, dict(noise_var=curve))):
        if blob is not None:
            np.savez(path, obs=obs, **blob)
        mine, theirs = load_obs_specs(str(path)), jax_load(str(path))
        assert len(mine) == len(theirs) == 2
        for (o, n), (oj, nj) in zip(mine, theirs):
            np.testing.assert_array_equal(o, oj)
            np.testing.assert_array_equal(n, nj)
    np.savez(npath, obs=obs, noise_var=np.ones(5, np.float32))
    with pytest.raises(ValueError, match="matches neither"):
        load_obs_specs(str(npath))
