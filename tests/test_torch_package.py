"""The PyTorch port stands alone, and its NumPy-only copies equal the JAX
package's modules they copy."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_pulls_in_no_jax():
    """``tpu21cmvae_torch`` and every module of the slice import without
    JAX and without the JAX package (a subprocess: this one has jax)."""
    code = (
        "import sys\n"
        "import tpu21cmvae_torch, tpu21cmvae_torch.ops.kernels.fused_loglik, "
        "tpu21cmvae_torch.ops.kernels.fused_mlp, tpu21cmvae_torch.ops.kernels._build, "
        "tpu21cmvae_torch.sampling.gradient, tpu21cmvae_torch.sampling.mh, "
        "tpu21cmvae_torch.models._memo, tpu21cmvae_torch.utils.metrics, "
        "tpu21cmvae_torch.foregrounds, tpu21cmvae_torch.noisescale, tpu21cmvae_torch.priors, "
        "tpu21cmvae_torch.ops.fisher, tpu21cmvae_torch.ops.loglik, "
        "tpu21cmvae_torch.sampling.reweight, tpu21cmvae_torch.sampling.predictive, "
        "tpu21cmvae_torch.sampling.fit, tpu21cmvae_torch.sampling.driver, "
        "tpu21cmvae_torch.calibration, tpu21cmvae_torch.nested, "
        "tpu21cmvae_torch.sampling.pt, tpu21cmvae_torch.sampling.smc, "
        "tpu21cmvae_torch.sampling.evidence, tpu21cmvae_torch.vi, tpu21cmvae_torch.flows, "
        "tpu21cmvae_torch.train, tpu21cmvae_torch.train.scan, tpu21cmvae_torch.ops.losses, "
        "tpu21cmvae_torch.utils.logging, tpu21cmvae_torch.data.dataset, "
        "tpu21cmvae_torch.models, tpu21cmvae_torch.models.autoencoder, "
        "tpu21cmvae_torch.models.vae, tpu21cmvae_torch.models.ensemble, "
        "tpu21cmvae_torch.models.io_keras, tpu21cmvae_torch.parallel, "
        "tpu21cmvae_torch.parallel.mesh, tpu21cmvae_torch.parallel.inference, "
        "tpu21cmvae_torch.serve, tpu21cmvae_torch.deploy, tpu21cmvae_torch.verify, "
        "tpu21cmvae_torch.__main__, tpu21cmvae_torch.utils.profiling\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tpu21cmvae', 'h5py'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_top_level_names_cover_the_jax_packages_families():
    """The model families, their configs and recipes sit at the top level
    of the port as they do in the JAX package (``tpu21cmvae/__init__.py``),
    and ``load_model`` beside them (the JAX package's is in ``models``)."""
    import tpu21cmvae
    import tpu21cmvae_torch

    names = ["DirectEmulator", "AutoEncoder", "AutoEncoderEmulator", "VAE", "VAEEmulator",
             "DeepEnsemble", "AE_EMULATOR_TRAIN_DEFAULT", "AE_EMULATOR_TRAIN_STRONG",
             "AE_TRAIN_DEFAULT", "AE_TRAIN_STRONG", "DIRECT_TRAIN_DEFAULT", "DIRECT_TRAIN_STRONG",
             "AutoEncoderConfig", "DirectEmulatorConfig", "TrainConfig", "VAEConfig"]
    for name in names:
        assert hasattr(tpu21cmvae, name) and hasattr(tpu21cmvae_torch, name), name
    from tpu21cmvae_torch.models import load_model

    assert tpu21cmvae_torch.load_model is load_model


#: Top-level names of the JAX package that the port leaves out, each
#: with its reason.
OMITTED = {
    "error_jnp": "not ported: the JAX-traceable copy of `error`; the port's `error` "
                 "is the NumPy metric (ROADMAP, Not ported)",
}


def test_top_level_names_match_the_jax_package():
    """Every public name of ``tpu21cmvae/__init__.py`` is a public name
    of the port's, apart from the listed omissions; the port's extras
    are its own additions (``load_model`` and the results and helpers
    the JAX package keeps in submodules)."""
    import types

    import tpu21cmvae
    import tpu21cmvae_torch

    def names(pkg):
        return {n for n, v in vars(pkg).items()
                if not isinstance(v, types.ModuleType)
                and (not n.startswith("_") or n == "__version__")
                and n not in ("annotations",)} - {"__builtins__"}

    jax_names, port_names = names(tpu21cmvae), names(tpu21cmvae_torch)
    assert jax_names - port_names == set(OMITTED)
    assert tpu21cmvae_torch.__version__ == tpu21cmvae.__version__
    assert tpu21cmvae_torch.PAR_LABELS == tpu21cmvae.PAR_LABELS
    assert tpu21cmvae_torch.NU_0 == tpu21cmvae.NU_0
    extras = port_names - jax_names
    assert extras <= {"BatchGOFResult", "GOFResult", "MLPConfig", "NUTSSampleResult",
                      "goodness_of_fit", "goodness_of_fit_batch", "load_checkpoint",
                      "load_model", "run_batched_chain", "save_checkpoint",
                      "synthetic_dataset", "synthetic_params"}, extras


def test_make_emcee_log_prob_matches_jax(splits):
    """NumPy in and out, ``-inf`` outside the box without scoring the
    row, JAX's values inside on the same weights, under no_grad."""
    import jax

    from _torch_pair import make_pair
    from tpu21cmvae.sampling import make_emcee_log_prob as jax_adapter
    from tpu21cmvae_torch import make_emcee_log_prob

    jm, tm = make_pair(splits, (16,))
    obs = tm.predict(splits.par_test[0])
    seen = []

    def loglik(params, raw):
        seen.append((raw.shape[0], torch.is_grad_enabled()))
        return tm.loglik_fn(obs, 25.0)(params, raw)

    lp = make_emcee_log_prob(loglik, tm.params, device="cpu")
    lp_jax = jax_adapter(jm.loglik_fn(jax.numpy.asarray(obs), 25.0), jm.params)
    coords = np.asarray(splits.par_test[:5], np.float32).copy()
    coords[1, 3] = 10.0  # outside the box
    got, want = lp(coords), lp_jax(coords)
    assert got.dtype.kind == "f" and np.isneginf(got[1]) and np.isneginf(want[1])
    np.testing.assert_allclose(got[[0, 2, 3, 4]], want[[0, 2, 3, 4]], rtol=2e-4, atol=1e-2)
    assert seen == [(4, False)]  # the row outside the box was not scored
    one = lp(coords[0])
    assert isinstance(one, float) and one == pytest.approx(float(got[0]), abs=1e-2)
    assert np.isneginf(lp(coords[1])) and len(seen) == 2  # no call for it alone


def test_synthetic_data_and_axes_byte_identical(splits):
    from tpu21cmvae.utils.frequency import default_frequencies, default_redshifts
    from tpu21cmvae_torch.data.synthetic import synthetic_dataset, synthetic_params
    from tpu21cmvae_torch.utils import frequency as tfreq

    mine = synthetic_dataset(512, 128, 128, seed=7)
    for a, b in zip(mine, splits):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert tfreq.default_redshifts().tobytes() == default_redshifts().tobytes()
    assert tfreq.default_frequencies().tobytes() == default_frequencies().tobytes()
    from tpu21cmvae.data.synthetic import synthetic_params as jax_params

    a = synthetic_params(64, np.random.default_rng(0))
    b = jax_params(64, np.random.default_rng(0))
    assert a.tobytes() == b.tobytes()


def test_config_and_error_metric_match():
    from tpu21cmvae.utils.config import DirectEmulatorConfig as JaxConfig
    from tpu21cmvae.utils.metrics import error as jax_error
    from tpu21cmvae_torch.utils.config import DirectEmulatorConfig
    from tpu21cmvae_torch.utils.frequency import default_frequencies
    from tpu21cmvae_torch.utils.metrics import error

    assert dataclasses.asdict(DirectEmulatorConfig()) == dataclasses.asdict(JaxConfig())
    assert DirectEmulatorConfig().mlp().sizes == JaxConfig().mlp().sizes
    assert DirectEmulatorConfig().mlp().weight_count == JaxConfig().mlp().weight_count
    rng = np.random.default_rng(3)
    t, p = rng.normal(size=(5, 451)), rng.normal(size=(5, 451))
    nu = default_frequencies()
    for kw in ({}, {"relative": False}, {"nu_arr": nu, "flow": 0, "fhigh": 100.0}):
        np.testing.assert_array_equal(error(t, p, **kw), jax_error(t, p, **kw))
    np.testing.assert_array_equal(error(t[0], p[0]), jax_error(t[0], p[0]))


def test_grad_gate_matches_bench():
    """The port's gradient gate is bench_mcmc.py's, number for number."""
    import bench_mcmc
    from tpu21cmvae_torch.utils.metrics import grad_gate_violation

    rng = np.random.default_rng(4)
    ref = rng.normal(size=(300, 7))
    for scale in (1e-4, 1e-2, 0.3):
        got = ref + scale * rng.normal(size=ref.shape)
        assert grad_gate_violation(got, ref) == pytest.approx(
            bench_mcmc._grad_gate_violation(got, ref), rel=1e-12
        )


def test_loglik_gate_matches_bench():
    """The port's likelihood gate is bench_mcmc.py's, number for number,
    on both sides of the bound."""
    import bench_mcmc
    from tpu21cmvae_torch.utils.metrics import loglik_gate_violation

    rng = np.random.default_rng(6)
    ref = -np.abs(rng.normal(0.0, 300.0, size=500)) - 200.0
    for scale in (1e-3, 0.1, 2.0):
        got = ref + scale * rng.normal(size=ref.shape)
        want = bench_mcmc._gate_violation(got, ref)
        assert loglik_gate_violation(got, ref) == pytest.approx(want, rel=1e-12, abs=1e-12)
    assert loglik_gate_violation(ref + 0.2, ref) < 0.0 < loglik_gate_violation(ref + 0.3, ref)


def test_sample_result_diagnostics_match():
    """The NumPy/SciPy SampleResult copy gives the JAX package's R̂, bulk
    ESS and tail ESS on the same chain."""
    from tpu21cmvae.sampling.results import SampleResult as JaxResult
    from tpu21cmvae_torch.sampling.results import SampleResult

    rng = np.random.default_rng(5)
    chain = np.cumsum(rng.normal(size=(40, 16, 3)), axis=0).astype(np.float32)
    kw = dict(chain=chain, final=chain[-1], logp=np.zeros(16),
              accept_rate=np.ones(40), step_size=0.1)
    a, b = SampleResult(**kw), JaxResult(**kw)
    np.testing.assert_array_equal(a.rhat(), b.rhat())
    np.testing.assert_array_equal(a.ess(), b.ess())
    np.testing.assert_array_equal(a.ess_tail(), b.ess_tail())
    assert a.summary() == b.summary()


def test_memo_returns_one_object_per_value():
    from tpu21cmvae_torch.models._memo import _CAP, memo_program, noise_key

    class Holder:
        pass

    h = Holder()
    obs = np.arange(4, dtype=np.float32)
    f1 = memo_program(h, ("k", obs, noise_key(2.0)), object)
    f2 = memo_program(h, ("k", obs.copy(), noise_key(np.float64(2.0))), object)
    assert f1 is f2
    assert memo_program(h, ("k", obs, noise_key(3.0)), object) is not f1
    assert memo_program(h, ("k", obs, noise_key(2.0)), object, memo=False) is not f1
    for i in range(_CAP + 1):
        memo_program(h, ("fill", i), object)
    assert len(h._t21_loglik_memo) == _CAP


def test_tensor_inputs_keep_their_device():
    """A model built on the CPU keeps every tensor there (the device is
    the caller's explicit choice)."""
    from tpu21cmvae_torch.models.direct import DirectEmulator
    from tpu21cmvae_torch.utils.config import DirectEmulatorConfig

    norm = {"signal_mean": np.zeros(451), "signal_std": 1.0,
            "par_min": -np.ones(7), "par_max": np.ones(7)}
    m = DirectEmulator.from_numpy(
        tuple({"w": np.zeros((a, b)), "b": np.zeros(b)}
              for a, b in ((7, 8), (8, 451))),
        norm, config=DirectEmulatorConfig(hidden_dims=(8,)), device="cpu",
    )
    assert all(t.device.type == "cpu" for layer in m.params for t in layer.values())
    assert m.normalizer.device == torch.device("cpu")
    with pytest.raises(TypeError):
        DirectEmulator(normalizer=m.normalizer)  # no device: refused
