"""``python -m tpu21cmvae_torch`` against ``python -m tpu21cmvae`` on the
same checkpoint file (the CLI targets of ``tests/test_io_cli.py``), all
with ``--device cpu``: the model-lifecycle commands, the fit and the
goodness of fit, the refused commands and the device flag.

``predict``'s signals agree with JAX's within 1e-5 of their amplitude;
every output file has JAX's keys and shapes; ``fit``'s best logL is
within 1.5 nats of JAX's (256 starts × 300 steps from different draws;
at JAX's own test's 32 × 60 the two stop 11 nats apart, short of the
mode);
``gof`` gives JAX's exit code and p-value within 1e-3 on the same chain
file (one predict of the same draws).
"""

import json

import numpy as np
import pytest

from _torch_pair import one_torch_thread  # noqa: F401

from tpu21cmvae.__main__ import main as jax_main
from tpu21cmvae_torch.__main__ import main

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def files(splits, tmp_path_factory):
    """A small JAX-trained-shape checkpoint and an observation spec file
    that both CLIs read."""
    from tpu21cmvae.models.direct import DirectEmulator
    from tpu21cmvae.utils.config import DirectEmulatorConfig

    d = tmp_path_factory.mktemp("cli")
    model = DirectEmulator(splits, config=DirectEmulatorConfig(hidden_dims=(16,)))
    ckpt = str(d / "m.npz")
    model.save(ckpt)
    obs = np.asarray(model.predict(splits.par_test[0]))
    obs_file = str(d / "obs.json")
    with open(obs_file, "w") as f:
        json.dump({"obs": obs.tolist(), "noise_var": 25.0}, f)
    return {"dir": d, "ckpt": ckpt, "obs": obs_file, "model": model}


def _keys_and_shapes(path):
    blob = np.load(path)
    return {k: blob[k].shape for k in blob.files}


def test_train_evaluate_predict(files, splits, capsys):
    """``train`` (3 epochs) writes a checkpoint that JAX's CLI reads;
    ``evaluate`` prints both tables; ``predict`` on JAX's checkpoint
    gives JAX's signals within 1e-5 of their amplitude."""
    from tpu21cmvae_torch.data.dataset import save_dataset

    d = files["dir"]
    ds = str(d / "ds.h5")
    save_dataset(splits, ds)
    model = str(d / "trained.npz")
    main(["train", "direct", "--dataset", ds, "--epochs", "3", "--out", model, *CPU])
    out = capsys.readouterr().out
    assert "test error" in out and "saved" in out
    main(["evaluate", model, "--dataset", ds, *CPU])
    out = capsys.readouterr().out
    assert "relative" in out and "absolute" in out
    jax_main(["evaluate", model, "--dataset", ds])
    assert "relative" in capsys.readouterr().out

    params = str(d / "p.npy")
    np.save(params, np.asarray(splits.par_test[:5], np.float32))
    mine, theirs = str(d / "s.npy"), str(d / "s_jax.npy")
    main(["predict", files["ckpt"], params, "--out", mine, *CPU])
    jax_main(["predict", files["ckpt"], params, "--out", theirs])
    a, b = np.load(mine), np.load(theirs)
    assert a.shape == b.shape == (5, splits.n_bins)
    assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    assert "emulated 5 signal(s)" in capsys.readouterr().out


def test_export_h5_matches_jax(files, splits, capsys):
    from tpu21cmvae.models.autoencoder import AutoEncoderEmulator
    from tpu21cmvae.utils.config import AutoEncoderConfig
    from tpu21cmvae_torch.models.io_keras import load_keras_mlp
    from tpu21cmvae_torch.ops.mlp import mlp_sizes

    d = files["dir"]
    main(["export-h5", files["ckpt"], "--out", str(d / "m.h5"), *CPU])
    jax_main(["export-h5", files["ckpt"], "--out", str(d / "m_jax.h5")])
    assert "wrote" in capsys.readouterr().out
    for a, b in zip(load_keras_mlp(str(d / "m.h5")), load_keras_mlp(str(d / "m_jax.h5"))):
        np.testing.assert_array_equal(a["w"], b["w"])
        np.testing.assert_array_equal(a["b"], b["b"])
    assert mlp_sizes(load_keras_mlp(str(d / "m.h5"))) == (7, 16, splits.n_bins)
    ae = AutoEncoderEmulator(splits, config=AutoEncoderConfig(
        latent_dim=4, enc_hidden_dims=(16,), dec_hidden_dims=(16,), em_hidden_dims=(12,)))
    ckpt = str(d / "ae.npz")
    ae.save(ckpt)
    main(["export-h5", ckpt, "--out", str(d / "ae.h5"), *CPU])
    for stage, sizes in (("em", (7, 12, 4)), ("enc", (451, 16, 4)), ("dec", (4, 16, 451))):
        assert mlp_sizes(load_keras_mlp(str(d / f"ae_{stage}.h5"))) == sizes


def test_fit_matches_jax(files):
    d = files["dir"]
    mine, theirs = str(d / "fit.npz"), str(d / "fit_jax.npz")
    args = ["fit", files["ckpt"], "--obs", files["obs"], "--starts", "256", "--steps", "300"]
    assert main([*args, "--out", mine, *CPU]) == 0
    jax_main([*args, "--out", theirs])
    assert _keys_and_shapes(mine) == _keys_and_shapes(theirs)
    a, b = np.load(mine), np.load(theirs)
    assert a["params"].shape == (256, 7) and a["logp"].max() == a["best_logp"]
    print("fit best logL, port and JAX:", float(a["best_logp"]), float(b["best_logp"]))
    assert abs(float(a["best_logp"]) - float(b["best_logp"])) <= 1.5


def test_prior_flag(files):
    """A delta-like prior on tau pins the chain's tau mean within 0.003
    of the prior's mean (the JAX suite's bound); a malformed spec exits
    with the format in the message."""
    d = files["dir"]
    out = str(d / "prior.npz")
    main(["sample", files["ckpt"], "--obs", files["obs"], "--sampler", "mh", "--walkers", "64",
          "--steps", "100", "--warmup", "150", "--thin", "5", "--prior", "3:0.054:0.0003",
          "--out", out, *CPU])
    chain = np.load(out)["chain"].reshape(-1, 7)
    assert abs(chain[:, 3].mean() - 0.054) < 0.003
    with pytest.raises(SystemExit, match="IDX:MEAN:SIGMA"):
        main(["sample", files["ckpt"], "--obs", files["obs"], "--prior", "bogus", "--out", out,
              *CPU])


def test_gof_matches_jax(files, splits):
    """The same fabricated chain file scores the same in both: exit 0 on
    the model's own observation, 1 on an unmodeled ripple, 0 on a
    final-only chain, 2 under the refused scale-marginal spec."""
    d, model = files["dir"], files["model"]
    rng = np.random.default_rng(0)
    truth = np.asarray(splits.par_test[0], np.float32)
    clean = np.asarray(model.predict(truth))
    obs = clean + rng.normal(0.0, 5.0, clean.shape)
    nu = np.asarray(model.frequencies)
    specs = {}
    for name, o in (("ok", obs), ("bad", obs + 25.0 * np.sin(2 * np.pi * (nu - nu.min()) / 8.0))):
        specs[name] = str(d / f"gof_{name}.json")
        with open(specs[name], "w") as f:
            json.dump({"obs": o.tolist(), "noise_var": 25.0}, f)
    draws = truth[None] + rng.normal(0, 1e-4, (2, 64, 7)).astype(np.float32) * np.abs(truth)
    chain, chain_f = str(d / "gof_chain.npz"), str(d / "gof_final.npz")
    np.savez_compressed(chain, chain=draws, final=draws[-1])
    np.savez_compressed(chain_f, chain=np.zeros((0, 64, 7), np.float32), final=draws[-1])
    for obs_file, chain_file, extra, want in (
            (specs["ok"], chain, [], 0), (specs["bad"], chain, [], 1),
            (specs["ok"], chain_f, [], 0), (specs["ok"], chain, ["--marginalize-noise-scale"], 2)):
        args = ["gof", files["ckpt"], "--obs", obs_file, "--chain", chain_file, *extra]
        assert main([*args, *CPU]) == want == jax_main(args)


def test_gof_p_value_matches_jax(files, splits, capsys):
    from tpu21cmvae.calibration import goodness_of_fit as jax_gof
    from tpu21cmvae_torch.calibration import goodness_of_fit
    from tpu21cmvae_torch.models import load_model

    model = files["model"]
    truth = np.asarray(splits.par_test[1], np.float32)
    obs = np.asarray(model.predict(truth)) + np.random.default_rng(4).normal(0, 5.0, 451)
    draws = truth[None] * (1 + np.random.default_rng(5).normal(0, 1e-4, (64, 7)))
    mine = goodness_of_fit(load_model(files["ckpt"], device="cpu"), obs, 25.0, draws)
    theirs = jax_gof(model, obs, 25.0, draws)
    assert mine.p_value == pytest.approx(theirs.p_value, abs=1e-3)


def test_refused_commands_and_the_device_flag(files, capsys, monkeypatch):
    """``download`` and ``tune --download`` exit non-zero naming why;
    without a CUDA device the default ``--device cuda`` exits non-zero
    with a message, never falling back to the CPU."""
    import torch

    assert main(["download"]) == 2
    assert "fetches nothing" in capsys.readouterr().err
    assert main(["tune", "--trials", "1", "--download"]) == 2
    assert "fetches nothing" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["predict", files["ckpt"], "x.npy"], ["verify"],
                 ["fit", files["ckpt"], "--obs", files["obs"]], ["tune", "--trials", "1"]):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 2
        assert "no CUDA device" in capsys.readouterr().err


def test_top_level_help_renders(capsys):
    """``--help`` renders for the program and every command JAX's CLI
    has, the refused ``download`` included."""
    with pytest.raises(SystemExit) as e:
        main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    for cmd in ("train", "sample", "evidence", "profile", "serve", "tune", "download"):
        assert cmd in out
    for cmd in ("download", "train", "evaluate", "predict", "tune", "sample", "fit", "advi",
                "profile", "evidence", "sbc", "gof", "serve", "verify", "export-h5",
                "export-artifact"):
        with pytest.raises(SystemExit) as e:
            main([cmd, "--help"])
        assert e.value.code == 0, cmd
        capsys.readouterr()
