"""Port predict against the JAX package: transforms, the MLP, and the
flagship checkpoint end to end."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu21cmvae.models import load_model
from tpu21cmvae.models.direct import DirectEmulator as JaxEmulator
from tpu21cmvae.utils.config import DirectEmulatorConfig as JaxConfig
from tpu21cmvae_torch.data.synthetic import synthetic_params
from tpu21cmvae_torch.models.direct import DirectEmulator
from tpu21cmvae_torch.utils.config import DirectEmulatorConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIRECT = os.path.join(REPO, "pretrained", "direct_synthetic.npz")
SMALL = (32, 48, 32, 24)


def _rel_to_amplitude(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def flagship():
    return load_model(DIRECT), DirectEmulator.from_checkpoint(DIRECT, device="cpu")


def test_flagship_predict_matches_jax(flagship):
    """Port predict vs JAX predict_fn() at HIGHEST on the shipped flagship
    checkpoint, with an fx = 0 row: rel-to-amplitude ≤ 1e-5 (both are
    fp32 with the skinny first layer exact; only summation order and
    log10 rounding differ)."""
    jm, tm = flagship
    raw = synthetic_params(257, np.random.default_rng(11)).astype(np.float32)
    raw[3, 2] = 0.0
    want = np.asarray(jm.predict_fn()(jm.params, jnp.asarray(raw)))
    got = tm.predict(raw)
    assert got.shape == (257, 451)
    assert _rel_to_amplitude(got, want) <= 1e-5
    assert _rel_to_amplitude(got[3], want[3]) <= 1e-5  # the fx = 0 row
    one = tm.predict(raw[0])
    assert one.shape == (451,)
    assert _rel_to_amplitude(one, want[0]) <= 1e-5


def test_flagship_golden_test_error():
    """The golden contract of ``tests/test_pretrained.py::
    test_pretrained_direct_golden`` on the split the checkpoint was
    trained on, which the port's generator reproduces byte for byte."""
    from tpu21cmvae.data.synthetic import synthetic_dataset as jax_dataset
    from tpu21cmvae_torch.data.synthetic import synthetic_dataset

    golden = synthetic_dataset(n_train=26888, n_val=1704, n_test=1704, seed=0)
    theirs = jax_dataset(n_train=26888, n_val=1704, n_test=1704, seed=0)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(golden, theirs))
    em = DirectEmulator.from_checkpoint(DIRECT, golden, device="cpu")
    err = em.test_error()
    assert err.mean() < 0.20 and np.median(err) < 0.20 and err.max() < 3.0


def test_from_numpy_matches_small_jax_model(splits):
    """``from_numpy`` on a JAX model's params and normalizer predicts what
    that model predicts, and test_error agrees."""
    jm = JaxEmulator(splits, config=JaxConfig(hidden_dims=SMALL), seed=5)
    tm = DirectEmulator.from_numpy(
        jax.tree_util.tree_map(np.asarray, jm.params),
        jax.tree_util.tree_map(np.asarray, jm.normalizer),
        config=DirectEmulatorConfig(hidden_dims=SMALL), device="cpu", data=splits,
    )
    raw = splits.par_test[:64]
    assert _rel_to_amplitude(tm.predict(raw), jm.predict(raw)) <= 1e-5
    np.testing.assert_allclose(tm.test_error(), jm.test_error(), rtol=1e-4)
    np.testing.assert_allclose(
        tm.test_error(relative=False, flow=60.0, fhigh=120.0),
        jm.test_error(relative=False, flow=60.0, fhigh=120.0), rtol=1e-4,
    )


def test_normalizer_and_transforms_match(splits, normalizer):
    from tpu21cmvae.ops.transforms import par_transform as jpt
    from tpu21cmvae.ops.transforms import preproc as jpre
    from tpu21cmvae_torch.ops.transforms import (
        Normalizer,
        par_transform,
        preproc,
        unpreproc,
    )

    norm = Normalizer.from_data(splits.par_train, splits.signal_train, device="cpu")
    for name in ("signal_mean", "signal_std", "par_min", "par_max"):
        np.testing.assert_array_equal(
            getattr(norm, name).numpy(), np.asarray(getattr(normalizer, name))
        )
    raw = splits.par_test[:20].astype(np.float32).copy()
    raw[0, 2] = 0.0
    np.testing.assert_allclose(
        par_transform(torch.as_tensor(raw), norm).numpy(),
        np.asarray(jpt(jnp.asarray(raw), normalizer)), rtol=1e-6, atol=1e-6,
    )
    assert par_transform(torch.as_tensor(raw[0]), norm).shape == (1, 7)
    sig = torch.as_tensor(splits.signal_test[:5].astype(np.float32))
    np.testing.assert_allclose(
        preproc(sig, norm).numpy(), np.asarray(jpre(jnp.asarray(sig.numpy()), normalizer)),
        rtol=1e-6, atol=1e-6,
    )
    np.testing.assert_allclose(unpreproc(preproc(sig, norm), norm).numpy(), sig.numpy(),
                               rtol=1e-5, atol=1e-4)


def test_mlp_init_and_activations():
    from tpu21cmvae_torch.ops.mlp import MLP, init_mlp, mlp_apply, resolve_activation

    g = torch.Generator().manual_seed(0)
    params = init_mlp(g, (7, 16, 5), device="cpu")
    limit = (6.0 / (7 + 16)) ** 0.5
    assert params[0]["w"].shape == (7, 16) and params[1]["w"].shape == (16, 5)
    assert float(params[0]["w"].abs().max()) <= limit
    assert float(params[1]["b"].abs().max()) == 0.0
    again = init_mlp(torch.Generator().manual_seed(0), (7, 16, 5), device="cpu")
    assert torch.equal(params[0]["w"], again[0]["w"])
    net = MLP((7, 16, 5), device="cpu", seed=0)
    assert torch.equal(net.params[0]["w"], params[0]["w"])
    x = torch.randn(4, 7, generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(net(x).detach().numpy(),
                               mlp_apply(params, x).numpy(), rtol=0, atol=0)
    z = np.linspace(-3, 3, 13).astype(np.float32)
    for name in ("relu", "tanh", "sigmoid", "gelu", "elu", "softplus", "linear"):
        from tpu21cmvae.ops.mlp import resolve_activation as jact

        np.testing.assert_allclose(
            resolve_activation(name)(torch.as_tensor(z)).numpy(),
            np.asarray(jact(name)(jnp.asarray(z))), rtol=1e-6, atol=1e-6,
        )
    with pytest.raises(ValueError):
        resolve_activation("swishy")
    with pytest.raises(ValueError, match="expected"):
        MLP((7, 16, 5), device="cpu", params=({"w": np.zeros((7, 15)), "b": np.zeros(15)},
                                              {"w": np.zeros((15, 5)), "b": np.zeros(5)}))


@pytest.mark.parametrize("tier", ["high", "default"])
def test_fast_tier_predict_within_tier_class(flagship, tier):
    """On trained weights the bf16x3 tier stays inside bench.py's forward
    gate (≤ 1.5e-3 rel-to-amplitude of the contract path) and single-pass
    bf16 falls outside it — the JAX package's accuracy finding, re-checked
    on the port's arithmetic."""
    _, tm = flagship
    raw = torch.as_tensor(synthetic_params(512, np.random.default_rng(2)).astype(np.float32))
    exact = tm.predict_fn()(tm.params, raw).numpy()
    fast = tm.predict_fn(tier)(tm.params, raw).numpy()
    err = _rel_to_amplitude(fast, exact)
    assert np.isfinite(fast).all()
    if tier == "high":
        assert err <= 1.5e-3
    else:
        assert 1.5e-3 < err < 5e-2
