"""Checkpoints pass between the JAX package and the PyTorch port: the
port binds the JAX flatten order by position, checks every shape, and
writes the treedef string JAX writes."""

import json
import os

import jax
import numpy as np
import pytest

from tpu21cmvae.models.direct import DirectEmulator as JaxEmulator
from tpu21cmvae.ops.mlp import init_mlp
from tpu21cmvae.ops.transforms import Normalizer as JaxNormalizer
from tpu21cmvae.utils.config import DirectEmulatorConfig as JaxConfig
from tpu21cmvae_torch.models.direct import DirectEmulator, checkpoint_treedef
from tpu21cmvae_torch.utils.config import DirectEmulatorConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIRECT = os.path.join(REPO, "pretrained", "direct_synthetic.npz")
SMALL = (32, 48, 32, 24)


@pytest.fixture(scope="module")
def jax_small(splits):
    return JaxEmulator(splits, config=JaxConfig(hidden_dims=SMALL), seed=3)


def test_shipped_checkpoint_binds_every_leaf():
    m = DirectEmulator.from_checkpoint(DIRECT, device="cpu")
    with np.load(DIRECT) as data:
        leaves = [data[f"leaf_{i}"] for i in range(14)]
    norm = m.normalizer.to_numpy()
    for i, name in enumerate(("signal_mean", "signal_std", "par_min", "par_max")):
        np.testing.assert_array_equal(norm[name], leaves[i])
    sizes = (7, 288, 352, 288, 224, 451)
    for i, layer in enumerate(m.params):
        assert tuple(layer["w"].shape) == (sizes[i], sizes[i + 1])
        np.testing.assert_array_equal(layer["b"].detach().numpy(), leaves[4 + 2 * i])
        np.testing.assert_array_equal(layer["w"].detach().numpy(), leaves[5 + 2 * i])
    assert m.config.hidden_dims == sizes[1:-1]
    assert m.redshifts.shape == (451,)


@pytest.mark.parametrize("n_hidden", [0, 2, 4])
def test_treedef_string_is_what_jax_writes(n_hidden):
    cfg = JaxConfig(hidden_dims=(8,) * n_hidden)
    tree = {
        "params": init_mlp(jax.random.key(0), cfg.mlp().sizes),
        "normalizer": JaxNormalizer.template(cfg.n_bins, cfg.n_params),
    }
    assert checkpoint_treedef(n_hidden + 1) == str(jax.tree_util.tree_structure(tree))


def test_port_saved_checkpoint_loads_in_jax(tmp_path, jax_small, splits):
    port = DirectEmulator.from_numpy(
        jax.tree_util.tree_map(np.asarray, jax_small.params),
        jax.tree_util.tree_map(np.asarray, jax_small.normalizer),
        config=DirectEmulatorConfig(hidden_dims=SMALL),
        device="cpu",
    )
    path = str(tmp_path / "port.npz")
    port.save(path)
    back = JaxEmulator.from_checkpoint(path)
    raw = splits.par_test[:16]
    np.testing.assert_array_equal(back.predict(raw), jax_small.predict(raw))
    with np.load(path) as data:
        header = json.loads(bytes(data["__header__"]).decode())
    assert header["format_version"] == 1
    assert header["treedef"] == checkpoint_treedef(len(SMALL) + 1)


def test_jax_saved_checkpoint_loads_in_port(tmp_path, jax_small):
    path = str(tmp_path / "jax.npz")
    jax_small.save(path)
    port = DirectEmulator.from_checkpoint(path, device="cpu")
    for mine, theirs in zip(port.params, jax_small.params):
        for k in ("w", "b"):
            np.testing.assert_array_equal(mine[k].detach().numpy(), np.asarray(theirs[k]))
    np.testing.assert_array_equal(port.redshifts, jax_small.redshifts)


def test_native_precision_round_trips(tmp_path, jax_small):
    jax_small.native_precision = "default"
    try:
        path = str(tmp_path / "native.npz")
        jax_small.save(path)
        port = DirectEmulator.from_checkpoint(path, device="cpu")
    finally:
        jax_small.native_precision = None
    assert port.native_precision == "default"
    again = str(tmp_path / "again.npz")
    port.save(again)
    assert DirectEmulator.from_checkpoint(again, device="cpu").native_precision == "default"
    assert JaxEmulator.from_checkpoint(again).native_precision == "default"


def test_shape_mismatch_and_version_raise(tmp_path):
    with np.load(DIRECT) as data:
        arrays = {k: data[k] for k in data.files}
    bad = dict(arrays, leaf_5=arrays["leaf_5"][:, :100])
    path = str(tmp_path / "bad.npz")
    np.savez(path, **bad)
    with pytest.raises(ValueError, match="leaf_5"):
        DirectEmulator.from_checkpoint(path, device="cpu")
    header = json.loads(bytes(arrays["__header__"]).decode())
    header["format_version"] = 2
    future = dict(arrays, __header__=np.frombuffer(json.dumps(header).encode(), np.uint8))
    path = str(tmp_path / "future.npz")
    np.savez(path, **future)
    with pytest.raises(ValueError, match="format_version"):
        DirectEmulator.from_checkpoint(path, device="cpu")
