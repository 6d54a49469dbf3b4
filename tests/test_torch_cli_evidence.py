"""``python -m tpu21cmvae_torch`` against ``python -m tpu21cmvae``: the
evidence commands (the CLI targets of ``tests/test_io_cli.py`` ``:459``
and ``:627``), all with ``--device cpu`` on the same checkpoint file.

Every output file has JAX's keys and shapes (apart from the arrays
whose length the run itself picks: nested iterations, SMC stages).
Laplace's log Z agrees with JAX's within 0.5 nats (256 starts × 300
steps; a deterministic saddle point sharpened by importance sampling
from different draws) and each row of the batched ``auto`` evidence
within 1 nat of JAX's row.
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
    from tpu21cmvae.models.direct import DirectEmulator
    from tpu21cmvae.utils.config import DirectEmulatorConfig

    d = tmp_path_factory.mktemp("cli_evidence")
    model = DirectEmulator(splits, config=DirectEmulatorConfig(hidden_dims=(16,)))
    ckpt = str(d / "m.npz")
    model.save(ckpt)
    obs = np.asarray(model.predict(splits.par_test[0]))
    obs_file = str(d / "obs.json")
    with open(obs_file, "w") as f:
        json.dump({"obs": obs.tolist(), "noise_var": 25.0}, f)
    return {"dir": d, "ckpt": ckpt, "obs": obs_file, "model": model}


def _both(files, args, name):
    """Run ``args`` through both CLIs; return the two output files."""
    d = files["dir"]
    mine, theirs = str(d / f"{name}.npz"), str(d / f"{name}_jax.npz")
    rc = main([*args, "--out", mine, *CPU])
    rc_jax = jax_main([*args, "--out", theirs])
    return np.load(mine), np.load(theirs), rc, rc_jax


def _same_schema(a, b, skip=()):
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        if k not in skip:
            assert a[k].shape == b[k].shape, k


def test_evidence_methods(files):
    base = ["evidence", files["ckpt"], "--obs", files["obs"]]
    a, b, _, _ = _both(files, [*base, "--method", "ladder", "--rungs", "8", "--walkers", "64",
                               "--steps", "40", "--warmup", "30"], "ladder")
    _same_schema(a, b)
    assert np.isfinite(a["logz"]) and np.isfinite(a["ladder_drift"])
    assert a["rung_logz"].shape == (7,) and a["posterior"].shape == (64, 7)
    a, b, _, _ = _both(files, [*base, "--live", "256", "--mh-steps", "8"], "nested")
    _same_schema(a, b, skip=("samples", "logl", "log_w"))  # one row per nested iteration
    assert np.isfinite(a["logz"]) and np.isfinite(a["logz_err"])
    assert a["posterior"].shape == (4096, 7)
    a, b, _, _ = _both(files, [*base, "--method", "laplace", "--fit-starts", "256",
                               "--fit-steps", "300"], "laplace")
    _same_schema(a, b)
    assert a["cov"].shape == (7, 7) and a["posterior"].shape == (4096, 7)
    assert abs(float(a["logz"]) - float(b["logz"])) <= 0.5
    a, b, _, _ = _both(files, [*base, "--method", "smc", "--walkers", "64"], "ev_smc")
    _same_schema(a, b, skip=("betas", "stage_ess", "accept_rate"))
    assert a["posterior"].shape == (512, 7) and a["betas"][-1] == 1.0


def test_evidence_batch_auto(files, splits, capsys):
    """A multi-observation file runs the batched escalation in both
    CLIs, row for row within 1 nat; the per-observation-only methods, a
    mixed noise spec, a single-observation ``auto``, a single-observation
    ``--final`` and an empty file are refused with exit 2, as in JAX."""
    d, model = files["dir"], files["model"]
    rows = [np.asarray(model.predict(splits.par_test[i])).tolist() for i in (0, 1)]
    spec = str(d / "batch.json")
    with open(spec, "w") as f:
        json.dump([{"obs": o, "noise_var": 25.0} for o in rows], f)
    a, b, rc, rc_jax = _both(files, ["evidence", files["ckpt"], "--obs", spec,
                                     "--method", "auto"], "batch")
    assert rc == rc_jax == 0
    _same_schema(a, b)
    assert np.isfinite(a["logz"]).all() and (np.abs(a["logz"] - b["logz"]) <= 1.0).all()
    assert set(a["method_used"]) <= {"laplace", "flow", "nested", "smc"}
    assert "method" in capsys.readouterr().out
    out = str(d / "x.npz")
    spec2, spec1, empty = (str(d / n) for n in ("mixed.json", "one.json", "empty.json"))
    with open(spec2, "w") as f:
        json.dump([{"obs": rows[0], "noise_var": 25.0}, {"obs": rows[1], "noise_var": 16.0}], f)
    with open(spec1, "w") as f:
        json.dump({"obs": rows[0], "noise_var": 25.0}, f)
    with open(empty, "w") as f:
        json.dump([], f)
    for argv in (["--obs", spec, "--method", "nested"], ["--obs", spec2, "--method", "auto"],
                 ["--obs", spec1, "--method", "auto"],
                 ["--obs", spec1, "--method", "laplace", "--final", "nested"],
                 ["--obs", empty, "--method", "auto"]):
        args = ["evidence", files["ckpt"], *argv, "--out", out]
        assert main([*args, *CPU]) == 2 == jax_main(args)
