"""``python -m tpu21cmvae_torch`` against ``python -m tpu21cmvae``: the
sampling and calibration commands (``sample``, ``sbc``, ``advi``,
``profile``; the CLI targets of ``tests/test_io_cli.py`` ``:352``,
``:512`` and ``:533``), all with ``--device cpu`` on the same checkpoint
file. Every output file has JAX's keys and shapes, apart from the arrays
whose length the run itself picks (an SMC anneal's stages).
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

    d = tmp_path_factory.mktemp("cli_infer")
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


def test_sample_mh_nuts_smc(files):
    base = ["sample", files["ckpt"], "--obs", files["obs"]]
    a, b, _, _ = _both(files, [*base, "--sampler", "mh", "--walkers", "32", "--steps", "20",
                               "--warmup", "10", "--thin", "5"], "mh")
    _same_schema(a, b)
    assert a["final"].shape == (32, 7) and a["chain"].shape == (4, 32, 7)
    assert np.isfinite(a["logp"]).all()
    a, b, _, _ = _both(files, [*base, "--sampler", "nuts", "--walkers", "32", "--steps", "10",
                               "--warmup", "20", "--max-depth", "4", "--thin", "5"], "nuts")
    _same_schema(a, b)
    assert np.isfinite(a["mean_leapfrog"]) and np.isfinite(a["divergence_rate"])
    a, b, _, _ = _both(files, [*base, "--sampler", "smc", "--walkers", "512"], "smc")
    _same_schema(a, b, skip=("betas", "stage_ess", "accept_rate"))  # the anneal's own length
    assert a["final"].shape == (512, 7) and np.isfinite(a["logz"]) and a["betas"][-1] == 1.0


def test_sbc(files):
    a, b, rc, rc_jax = _both(files, ["sbc", files["ckpt"], "--sims", "24", "--walkers", "32",
                                     "--steps", "60", "--warmup", "80"], "sbc")
    _same_schema(a, b)
    assert a["ranks"].shape == (24, 7) and a["pvalues"].shape == (7,)
    assert rc in (0, 1) and rc_jax in (0, 1)


def test_advi_and_profile(files):
    base = ["--obs", files["obs"]]
    a, b, _, _ = _both(files, ["advi", files["ckpt"], *base, "--steps", "60", "--mc", "64",
                               "--samples", "128"], "advi")
    _same_schema(a, b)
    assert a["samples"].shape == (128, 7) and np.isfinite(a["elbo"]).all()
    a, b, _, _ = _both(files, ["profile", files["ckpt"], *base, "--index", "3", "--points", "7",
                               "--starts", "16", "--steps", "40"], "profile")
    _same_schema(a, b)
    np.testing.assert_array_equal(a["grid"], b["grid"])
    lo68, hi68 = a["interval68"]
    lo95, hi95 = a["interval95"]
    assert lo95 <= lo68 <= hi68 <= hi95
