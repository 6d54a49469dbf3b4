"""The port's deployment artifacts (``tpu21cmvae_torch.deploy``): the
targets of ``tests/test_deploy.py``.

An artifact is self-contained (weights and normalization folded in; it
replays in a process that imports only ``torch``), takes any batch size,
and reproduces the port's in-process plain functions: predict and the
likelihoods to float32 rounding (the same operations on the same
device), the replay within 5e-5 of JAX's predict on the same weights.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_pair import make_pair, one_torch_thread  # noqa: F401

from tpu21cmvae_torch import deploy


@pytest.fixture(scope="module")
def pair(splits):
    return make_pair(splits, (16, 16), seed=3)


@pytest.fixture(scope="module")
def direct(pair):
    return pair[1]


def _rows(rng, n):
    from tpu21cmvae_torch.data.synthetic import PAR_RANGES

    lo, hi = np.asarray(PAR_RANGES, np.float32).T
    return (lo + rng.uniform(0.1, 0.9, (n, 7)) * (hi - lo)).astype(np.float32)


def test_predict_artifact_roundtrip(tmp_path, direct, rng):
    path = deploy.save_predict_artifact(direct, str(tmp_path / "em.pt2"))
    fn = deploy.load_artifact(path, device="cpu")
    assert fn.platforms == ("cpu",) and fn.n_in == 7 and fn.device == torch.device("cpu")
    for n in (0, 1, 5, 13):  # one artifact, every batch size
        raw = _rows(rng, n)
        got = fn(raw)
        assert got.shape == (n, 451)  # 2-D input is never squeezed
        if n:
            np.testing.assert_array_equal(got, np.atleast_2d(direct.predict(raw)))


def test_artifact_replays_jax_predict(tmp_path, pair, rng):
    """On the same weights the port's artifact replays JAX's predict
    within 5e-5 (the reference's batched-vs-single tolerance)."""
    jm, tm = pair
    fn = deploy.load_artifact(deploy.save_predict_artifact(tm, str(tmp_path / "em.pt2")),
                              device="cpu")
    raw = _rows(rng, 17)
    assert np.abs(fn(raw) - np.asarray(jm.predict(raw))).max() <= 5e-5


def test_single_row_squeeze_convention(tmp_path, direct):
    fn = deploy.load_artifact(deploy.save_predict_artifact(direct, str(tmp_path / "em.pt2")),
                              device="cpu")
    row = _rows(np.random.default_rng(0), 1)[0]
    out = fn(row)
    assert out.shape == (451,)
    np.testing.assert_array_equal(out, direct.predict(row))
    np.testing.assert_array_equal(fn(row.tolist()), out)


def test_loglik_artifact_matches_plain_loglik(tmp_path, direct, rng):
    obs = np.asarray(direct.predict(_rows(rng, 1)[0]))
    raw = _rows(rng, 9)
    for method in ("direct", "gram"):
        path = deploy.save_loglik_artifact(direct, str(tmp_path / f"ll_{method}.pt2"), obs, 1e-2,
                                           method=method)
        with torch.no_grad():
            want = direct.loglik_fn(obs, 1e-2, method=method)(direct.params,
                                                              torch.as_tensor(raw)).numpy()
        got = deploy.load_artifact(path, device="cpu")(raw)
        assert got.shape == (9,)
        np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(ValueError, match="kernel"):
        deploy.export_loglik(direct, obs, 1e-2, backend="kernel")


def test_valgrad_artifact_matches_plain_valgrad(tmp_path, direct, rng):
    obs = np.asarray(direct.predict(_rows(rng, 1)[0]))
    raw = _rows(rng, 6)
    fn = deploy.load_artifact(deploy.save_valgrad_artifact(direct, str(tmp_path / "vg.pt2"),
                                                           obs, 1e-2), device="cpu")
    got_v, got_g = fn(raw)
    want_v, want_g = direct.loglik_and_grad_fn(obs, 1e-2)(direct.params, torch.as_tensor(raw))
    assert got_v.shape == (6,) and got_g.shape == (6, 7)
    np.testing.assert_allclose(got_v, want_v.numpy(), rtol=1e-6)
    np.testing.assert_allclose(got_g, want_g.numpy(), rtol=1e-5,
                               atol=1e-6 * float(want_g.abs().max()))
    v1, g1 = fn(raw[0])
    assert v1.shape == () and g1.shape == (7,)


def test_two_stage_family_exports(tmp_path, splits, rng):
    """The AE exports predict and loglik; it has no analytic backward, so
    no value+gradient artifact."""
    from tpu21cmvae_torch.models.autoencoder import AutoEncoderEmulator
    from tpu21cmvae_torch.utils.config import AutoEncoderConfig

    cfg = AutoEncoderConfig(latent_dim=3, enc_hidden_dims=(8,), dec_hidden_dims=(8,),
                            em_hidden_dims=(8,))
    ae = AutoEncoderEmulator(splits, config=cfg, seed=5, device="cpu")
    raw = _rows(rng, 4)
    fn = deploy.load_artifact(deploy.save_predict_artifact(ae, str(tmp_path / "ae.pt2")),
                              device="cpu")
    np.testing.assert_array_equal(fn(raw), ae.predict(raw))
    obs = ae.predict(raw[0])
    ll = deploy.load_artifact(deploy.save_loglik_artifact(ae, str(tmp_path / "ael.pt2"), obs),
                              device="cpu")
    with torch.no_grad():
        want = ae.loglik_fn(obs)(ae.params, torch.as_tensor(raw)).numpy()
    np.testing.assert_allclose(ll(raw), want, rtol=1e-6)
    with pytest.raises(NotImplementedError, match="analytic backward"):
        deploy.export_valgrad(ae, obs)


def test_ensemble_exports_mean_prediction(tmp_path, splits, rng):
    from tpu21cmvae_torch.models.direct import DirectEmulator
    from tpu21cmvae_torch.models.ensemble import DeepEnsemble
    from tpu21cmvae_torch.utils.config import DirectEmulatorConfig

    ens = DeepEnsemble([DirectEmulator(splits, config=DirectEmulatorConfig(hidden_dims=(16, 16)),
                                       seed=s, device="cpu") for s in (0, 1)])
    raw = _rows(rng, 4)
    fn = deploy.load_artifact(deploy.save_predict_artifact(ens, str(tmp_path / "ens.pt2")),
                              device="cpu")
    np.testing.assert_allclose(fn(raw), ens.predict(raw), rtol=1e-6, atol=1e-5)
    # the in-process model is untouched by the trace
    np.testing.assert_allclose(ens.predict(raw), fn(raw), rtol=1e-6, atol=1e-5)


def test_precision_tier_forwarding(tmp_path, direct, rng):
    """A bf16x3 export holds the bf16x3 plain chain: the model's own
    bf16x3 predict, within bf16x3's distance of the fp32 contract."""
    fn = deploy.load_artifact(deploy.save_predict_artifact(direct, str(tmp_path / "hi.pt2"),
                                                           precision="high"), device="cpu")
    raw = _rows(rng, 3)
    with torch.no_grad():
        want = direct.predict_fn(precision="high")(direct.params, torch.as_tensor(raw)).numpy()
    np.testing.assert_allclose(fn(raw), want, rtol=1e-6, atol=1e-5)
    amp = np.abs(direct.predict(raw)).max()
    assert np.abs(fn(raw) - direct.predict(raw)).max() <= 1e-4 * amp


def test_platforms_are_the_checked_device_types(tmp_path, direct, monkeypatch):
    """``platforms`` lists where the replay was checked; ``cuda`` cannot
    be checked without a card, and a device type the artifact was not
    checked on is refused at load."""
    with pytest.raises(ValueError, match="platforms"):
        deploy.export_predict(direct, platforms=("tpu",))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="without a CUDA device"):
        deploy.export_predict(direct, platforms=("cpu", "cuda"))
    path = deploy.save_predict_artifact(direct, str(tmp_path / "em.pt2"))
    with pytest.raises(ValueError, match="checked on"):
        deploy.load_artifact(path, device="cuda")


def test_loaders_take_no_default_device(tmp_path, direct, splits):
    """Loading an artifact, and the golden checks that build a model,
    name their device: none of them picks one for the caller."""
    from tpu21cmvae_torch.verify import check_ae_golden, check_direct_golden

    path = deploy.save_predict_artifact(direct, str(tmp_path / "em.pt2"))
    with pytest.raises(TypeError, match="device"):
        deploy.load_artifact(path)
    with pytest.raises(TypeError, match="device"):
        check_direct_golden(splits, None)
    with pytest.raises(TypeError, match="device"):
        check_ae_golden(splits, None)


class _RoundedProducts(TorchDispatchMode):
    """Every float32 matrix product with its operands rounded to
    ``bits`` mantissa bits, as a card running TF32 products (10 bits)
    rounds them; ``bits=23`` changes nothing."""

    _MM = {torch.ops.aten.mm.default: (0, 1), torch.ops.aten.addmm.default: (1, 2),
           torch.ops.aten.bmm.default: (0, 1)}

    def __init__(self, bits):
        super().__init__()
        self.drop = 23 - bits

    def _round(self, t):
        if not self.drop or t.dtype != torch.float32:
            return t
        i = t.contiguous().view(torch.int32)
        return ((i + (1 << (self.drop - 1))) & -(1 << self.drop)).view(torch.float32)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self._MM:
            args = tuple(self._round(a) if k in self._MM[func] else a
                         for k, a in enumerate(args))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kind", ["predict", "loglik", "valgrad"])
def test_tf32_replay_is_refused(kind, direct, monkeypatch, rng):
    """A replay whose products ran at TF32 is refused at export at the
    fp32 tier; the same replay at full fp32 mantissa passes."""
    obs = np.asarray(direct.predict(_rows(rng, 1)[0]))
    export = {"predict": lambda: deploy.export_predict(direct),
              "loglik": lambda: deploy.export_loglik(direct, obs, 1e-2, precision="contract"),
              "valgrad": lambda: deploy.export_valgrad(direct, obs, 1e-2,
                                                       precision="contract")}[kind]
    move = deploy._move

    class Replay:
        def __init__(self, program, bits):
            self.program, self.bits = program, bits

        def module(self):
            mod = self.program.module()

            def run(x):
                with _RoundedProducts(self.bits):
                    return mod(x)

            return run

    monkeypatch.setattr(deploy, "_move", lambda p, d: Replay(move(p, d), 23))
    assert export().platforms == ("cpu",)
    monkeypatch.setattr(deploy, "_move", lambda p, d: Replay(move(p, d), 10))
    with pytest.raises(RuntimeError, match="disagrees"):
        export()


def test_cli_export_artifact(tmp_path, direct, rng, capsys):
    from tpu21cmvae_torch.__main__ import main

    ckpt = str(tmp_path / "model.npz")
    direct.save(ckpt)
    out = str(tmp_path / "deploy.pt2")
    main(["export-artifact", ckpt, "--out", out, "--device", "cpu"])
    assert "platforms cpu" in capsys.readouterr().out
    raw = _rows(rng, 3)
    np.testing.assert_array_equal(deploy.load_artifact(out, device="cpu")(raw), direct.predict(raw))
    obs = np.asarray(direct.predict(raw[0]))
    spec = str(tmp_path / "obs.npz")
    np.savez(spec, obs=obs, noise_var=np.float32(1e-2))
    ll_out = str(tmp_path / "ll.pt2")
    main(["export-artifact", ckpt, "--obs", spec, "--out", ll_out, "--device", "cpu"])
    with torch.no_grad():
        want = direct.loglik_fn(obs, 1e-2)(direct.params, torch.as_tensor(raw)).numpy()
    np.testing.assert_allclose(deploy.load_artifact(ll_out, device="cpu")(raw), want, rtol=1e-6)
    assert main(["export-artifact", ckpt, "--valgrad", "--device", "cpu"]) == 2
    assert main(["export-artifact", ckpt, "--platforms", "tpu", "--device", "cpu"]) == 2
    vg_out = str(tmp_path / "vg.pt2")
    main(["export-artifact", ckpt, "--obs", spec, "--out", vg_out, "--valgrad", "--device", "cpu"])
    v, g = deploy.load_artifact(vg_out, device="cpu")(raw)
    assert v.shape == (3,) and g.shape == (3, 7)


def test_artifact_replays_with_torch_alone(tmp_path, direct, rng):
    """The artifact needs no model state and no package: a fresh process
    that imports only torch (and refuses the port and JAX) replays it."""
    path = deploy.save_predict_artifact(direct, str(tmp_path / "em.pt2"))
    raw = _rows(rng, 3)
    np.save(str(tmp_path / "raw.npy"), raw)
    want = direct.predict(raw)
    code = (
        "import sys, torch, numpy as np\n"
        "sys.modules['tpu21cmvae_torch'] = None; sys.modules['jax'] = None\n"
        f"fn = torch.export.load({path!r}).module()\n"
        f"x = torch.as_tensor(np.load({str(tmp_path / 'raw.npy')!r}))\n"
        f"np.save({str(tmp_path / 'out.npy')!r}, fn(x).numpy())\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('tpu21cmvae', 'tpu21cmvae_torch', 'jax') and sys.modules[m] is not None)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), capture_output=True,
                          text=True, timeout=300, env={k: v for k, v in os.environ.items()
                                                       if k != "PYTHONPATH"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    np.testing.assert_array_equal(np.load(str(tmp_path / "out.npy")), want)

