"""The port's Keras h5 reader and writer (``tpu21cmvae_torch/models/io_keras.py``)
against the JAX package's, on files the tests write (the reference's own
shipped h5 weights are not in the repository). Needs ``h5py``, which the
port imports only inside these functions."""

import jax
import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

from _torch_pair import one_torch_thread  # noqa: E402,F401
from tpu21cmvae.models.autoencoder import AutoEncoderEmulator as JaxAE  # noqa: E402
from tpu21cmvae.models.direct import DirectEmulator as JaxDirect  # noqa: E402
from tpu21cmvae.models.io_keras import keras_model_config as jax_keras_model_config  # noqa: E402
from tpu21cmvae.models.io_keras import load_keras_mlp as jax_load  # noqa: E402
from tpu21cmvae.models.io_keras import save_keras_mlp as jax_save  # noqa: E402
from tpu21cmvae.ops.mlp import init_mlp  # noqa: E402
from tpu21cmvae_torch.models.autoencoder import AutoEncoderEmulator  # noqa: E402
from tpu21cmvae_torch.models.direct import DirectEmulator  # noqa: E402
from tpu21cmvae_torch.models.io_keras import (  # noqa: E402
    keras_model_config,
    load_keras_mlp,
    read_keras_h5_layers,
    save_keras_mlp,
)
from tpu21cmvae_torch.ops.mlp import mlp_sizes  # noqa: E402
from tpu21cmvae_torch.ops.transforms import Normalizer  # noqa: E402


def jax_mlp(seed, sizes):
    return jax.tree_util.tree_map(np.asarray, init_mlp(jax.random.key(seed), sizes))


def assert_same_layers(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for k in ("w", "b"):
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]))


def test_files_pass_both_ways(tmp_path):
    params = jax_mlp(1, (7, 12, 9, 5))
    jax_save(str(tmp_path / "jax.h5"), params)
    mine = load_keras_mlp(str(tmp_path / "jax.h5"))
    assert_same_layers(mine, params)
    assert all(isinstance(layer["w"], np.ndarray) and layer["w"].dtype == np.float32
               for layer in mine)
    assert mlp_sizes(mine) == (7, 12, 9, 5)
    # the port writes tensors; JAX reads the file, and so does the port
    tensors = tuple({k: torch.tensor(v) for k, v in layer.items()} for layer in params)
    save_keras_mlp(str(tmp_path / "port.h5"), tensors, activation="tanh", name="Encoder",
                   loss=None)
    assert_same_layers(jax_load(str(tmp_path / "port.h5")), params)
    assert_same_layers(load_keras_mlp(str(tmp_path / "port.h5")), params)
    assert keras_model_config(params, "tanh", "Encoder") == jax_keras_model_config(
        params, "tanh", "Encoder")
    with h5py.File(str(tmp_path / "port.h5"), "r") as a, h5py.File(str(tmp_path / "jax.h5"),
                                                                   "r") as b:
        assert "training_config" not in a.attrs and "training_config" in b.attrs
        assert list(a["model_weights"].attrs["layer_names"]) == list(
            b["model_weights"].attrs["layer_names"])


def test_reader_orders_layers_without_the_attribute(tmp_path):
    """A weights file without ``layer_names`` is read in natural order
    (dense_2 before dense_10), as the JAX reader does; a chain that does
    not link is refused."""
    params = jax_mlp(2, (4,) + (6,) * 11 + (3,))
    path = str(tmp_path / "w.h5")
    jax_save(path, params)
    with h5py.File(path, "a") as f:
        del f["model_weights"].attrs["layer_names"]
    names = [n for n, _ in read_keras_h5_layers(path)]
    assert names[:3] == ["dense", "dense_1", "dense_2"] and names[-1] == "dense_11"
    assert_same_layers(load_keras_mlp(path), jax_load(path))
    with h5py.File(path, "a") as f:
        f["model_weights"].attrs["layer_names"] = [b"dense_1", b"dense"]
    with pytest.raises(ValueError, match="chain"):
        load_keras_mlp(path)


def test_model_imports_equal_jax(tmp_path, splits):
    """``DirectEmulator.from_keras_h5`` and ``AutoEncoderEmulator.from_keras_h5``
    on h5 files JAX writes give JAX's imports: the same architecture and
    predictions within 1e-5 of the amplitude."""
    direct = jax_mlp(3, (7, 16, 16, 451))
    jax_save(str(tmp_path / "emulator.h5"), direct)
    jd = JaxDirect.from_keras_h5(str(tmp_path / "emulator.h5"), splits)
    td = DirectEmulator.from_keras_h5(str(tmp_path / "emulator.h5"), splits, device="cpu")
    assert td.config.hidden_dims == tuple(jd.config.hidden_dims) == (16, 16)
    raw = splits.par_test[:8]
    want = np.asarray(jd.predict(raw))
    amp = np.abs(want).max(axis=1, keepdims=True)
    assert float((np.abs(td.predict(raw) - want) / amp).max()) <= 1e-5

    paths = {}
    for name, sizes, seed in (("ae_emulator", (7, 16, 16, 6), 4), ("encoder", (451, 24, 6), 5),
                              ("decoder", (6, 8, 24, 451), 6)):
        paths[name] = str(tmp_path / f"{name}.h5")
        jax_save(paths[name], jax_mlp(seed, sizes))
    args = (paths["ae_emulator"], paths["encoder"], paths["decoder"])
    ja = JaxAE.from_keras_h5(*args, splits)
    norm = Normalizer.from_arrays(jax.tree_util.tree_map(np.asarray, ja.normalizer),
                                  device="cpu")
    ta = AutoEncoderEmulator.from_keras_h5(*args, splits, normalizer=norm, device="cpu")
    assert ta.config.latent_dim == 6 and ta.config.dec_hidden_dims == (8, 24)
    assert ta.config.em_hidden_dims == (16, 16) and ta.config.enc_hidden_dims == (24,)
    want = np.asarray(ja.predict(raw))
    amp = np.abs(want).max(axis=1, keepdims=True)
    assert float((np.abs(ta.predict(raw) - want) / amp).max()) <= 1e-5
    rec = np.asarray(ja.reconstruct(splits.signal_test[:4]))
    assert float((np.abs(ta.reconstruct(splits.signal_test[:4]) - rec)
                  / np.abs(rec).max(axis=1, keepdims=True)).max()) <= 1e-5
