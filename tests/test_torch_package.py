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
        "tpu21cmvae_torch.ops.kernels._build, tpu21cmvae_torch.sampling.gradient, "
        "tpu21cmvae_torch.models._memo, tpu21cmvae_torch.utils.metrics\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tpu21cmvae'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


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
