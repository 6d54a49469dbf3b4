"""Import/export for the reference's pretrained Keras ``.h5`` weight files
(the port of ``tpu21cmvae/models/io_keras.py``).

The reference ships four pretrained models under
``VeryAccurateEmulator/models/autoencoder_based_emulator/`` (plus
``models/emulator.h5`` for the direct emulator) saved with Keras 2.7's
HDF5 serializer (reference ``emulator.py:319-337, 667-699``). This module
reads them with h5py directly — no TensorFlow required — into layer
dicts of float32 NumPy arrays, which every model constructor of the port
copies to its device. Kernels are stored in the Keras ``(in, out)``
layout, which is also ours (:mod:`tpu21cmvae_torch.ops.mlp`), so no
transposition. ``h5py`` is imported inside the functions that read or
write a file: nothing else in the port needs it.

Layout (verified against the shipped files):
``model_weights/<layer>/<layer>/{kernel:0, bias:0}`` with layer ordering
recorded in the group attributes ``layer_names`` / ``weight_names``.

:func:`save_keras_mlp` writes a FULL Keras model file back — weights in
the same layout plus ``model_config``/``training_config`` JSON attrs
mirroring the shipped artifacts' schema (verified against
``ae_emulator.h5``) — so a reference user's plain
``tf.keras.models.load_model(path)`` (reference ``emulator.py:319-337``)
consumes it directly, architecture included; no TensorFlow is required
on this side.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpu21cmvae_torch.ops.mlp import MLPParams

KERAS_VERSION = b"2.7.0"  # the serializer dialect the reference artifacts use


def _host(a) -> np.ndarray:
    """A float32 NumPy copy of an array or tensor (no torch import)."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def _decode(names) -> List[str]:
    return [n.decode() if isinstance(n, bytes) else str(n) for n in names]


def _natural_key(name: str):
    """Sort key splitting trailing digits: dense < dense_2 < dense_10."""
    import re

    return [
        int(part) if part.isdigit() else part
        for part in re.split(r"(\d+)", name)
    ]


def read_keras_h5_layers(path: str) -> List[Tuple[str, Dict[str, np.ndarray]]]:
    """Read ordered (layer_name, {'kernel': ..., 'bias': ...}) pairs from a
    Keras-2.x HDF5 model or weights file. Layers without weights are
    skipped; ordering follows the file's ``layer_names`` attribute."""
    import h5py

    out = []
    with h5py.File(path, "r") as f:
        g = f["model_weights"] if "model_weights" in f else f
        if "layer_names" in g.attrs:
            layer_names = _decode(g.attrs["layer_names"])
        else:
            # no ordering attribute: h5py yields keys lexicographically,
            # which mis-orders dense_10 before dense_2 — sort naturally
            # (equal-width layers would pass the shape-chain check and
            # load silently wrong otherwise)
            layer_names = sorted(g.keys(), key=_natural_key)
        for lname in layer_names:
            lg = g[lname]
            weight_names = _decode(lg.attrs.get("weight_names", []))
            if not weight_names:
                continue
            tensors = {}
            for wname in weight_names:
                arr = np.asarray(lg[wname])
                base = wname.rsplit("/", 1)[-1].split(":")[0]
                tensors[base] = arr
            out.append((lname, tensors))
    return out


def load_keras_mlp(path: str, dtype=np.float32) -> MLPParams:
    """Load a sequential dense MLP saved by Keras as layer dicts of NumPy
    arrays.

    Validates that consecutive layer shapes chain (out_dim of layer i ==
    in_dim of layer i+1) so a mis-ordered file fails loudly.
    """
    layers = read_keras_h5_layers(path)
    if not layers:
        raise ValueError(f"No weight-bearing layers found in {path!r}")
    params = []
    prev_out = None
    for lname, tensors in layers:
        if "kernel" not in tensors or "bias" not in tensors:
            raise ValueError(f"Layer {lname!r} in {path!r} is not Dense-like")
        w, b = tensors["kernel"], tensors["bias"]
        if w.ndim != 2 or b.shape != (w.shape[1],):
            raise ValueError(f"Unexpected shapes in layer {lname!r}: {w.shape}, {b.shape}")
        if prev_out is not None and w.shape[0] != prev_out:
            raise ValueError(
                f"Layer {lname!r} input dim {w.shape[0]} does not chain from "
                f"previous output dim {prev_out} in {path!r}"
            )
        prev_out = w.shape[1]
        params.append({"w": np.asarray(w, dtype), "b": np.asarray(b, dtype)})
    return tuple(params)


def _dense_config(name: str, units: int, activation: str) -> dict:
    """One Dense layer's Keras-2.7 serialized config (field-for-field the
    schema of the shipped ``ae_emulator.h5`` model_config)."""
    return {
        "name": name,
        "trainable": True,
        "dtype": "float32",
        "units": int(units),
        "activation": activation,
        "use_bias": True,
        "kernel_initializer": {
            "class_name": "GlorotUniform",
            "config": {"seed": None},
        },
        "bias_initializer": {"class_name": "Zeros", "config": {}},
        "kernel_regularizer": None,
        "bias_regularizer": None,
        "activity_regularizer": None,
        "kernel_constraint": None,
        "bias_constraint": None,
    }


def keras_model_config(
    params: MLPParams,
    activation: str = "relu",
    name: str = "Emulator",
    input_name: str = "input",
) -> dict:
    """Keras ``model_config`` dict for a dense MLP: a ``Functional``
    graph of InputLayer → Dense chain, hidden layers activated, linear
    head — the exact topology the reference's builder produces
    (reference ``emulator.py:12-48``) and the exact serialization schema
    its shipped artifacts carry."""
    in_dim = int(params[0]["w"].shape[0])
    layers = [
        {
            "class_name": "InputLayer",
            "config": {
                "batch_input_shape": [None, in_dim],
                "dtype": "float32",
                "sparse": False,
                "ragged": False,
                "name": input_name,
            },
            "name": input_name,
            "inbound_nodes": [],
        }
    ]
    prev = input_name
    for i, layer in enumerate(params):
        lname = "dense" if i == 0 else f"dense_{i}"
        act = activation if i < len(params) - 1 else "linear"
        layers.append(
            {
                "class_name": "Dense",
                "config": _dense_config(
                    lname, layer["w"].shape[1], act
                ),
                "name": lname,
                "inbound_nodes": [[[prev, 0, 0, {}]]],
            }
        )
        prev = lname
    return {
        "class_name": "Functional",
        "config": {
            "name": name,
            "layers": layers,
            "input_layers": [[input_name, 0, 0]],
            "output_layers": [[prev, 0, 0]],
        },
    }


def _training_config(loss: str, learning_rate: float) -> dict:
    """Keras-2.7 ``training_config`` schema (matches ``ae_emulator.h5``)."""
    return {
        "loss": loss,
        "metrics": None,
        "weighted_metrics": None,
        "loss_weights": None,
        "optimizer_config": {
            "class_name": "Adam",
            "config": {
                "name": "Adam",
                "learning_rate": float(learning_rate),
                "decay": 0.0,
                "beta_1": 0.9,
                "beta_2": 0.999,
                "epsilon": 1e-07,
                "amsgrad": False,
            },
        },
    }


def save_keras_mlp(
    path: str,
    params: MLPParams,
    activation: str = "relu",
    name: str = "Emulator",
    loss: Optional[str] = "mean_squared_error",
    learning_rate: float = 0.01,
) -> str:
    """Write layer dicts (arrays or tensors) as a FULL Keras-2.x HDF5
    model file.

    Produces the ``model_weights/<layer>/<layer>/{kernel:0, bias:0}``
    layout with ``layer_names``/``weight_names`` attributes PLUS the
    root ``model_config`` (architecture) and ``training_config`` attrs,
    structurally matching the reference's shipped artifacts — so
    ``tf.keras.models.load_model(path)`` reconstructs the architecture
    and weights directly (the reference user workflow,
    ``emulator.py:319-337``), with no hand-built ``Sequential`` needed.
    Also readable by :func:`load_keras_mlp`. Kernels are already stored
    in the Keras ``(in, out)`` layout, so no transposition happens.

    ``loss=None`` omits ``training_config`` (the model loads
    uncompiled — required when the true loss is a custom object, e.g.
    the relative-MSE closure the reference injects at load time).
    """
    import h5py

    with h5py.File(path, "w") as f:
        g = f.create_group("model_weights")
        cfg = keras_model_config(params, activation, name)
        input_name = cfg["config"]["layers"][0]["name"]
        # input layer first, with no weights — as the reference files do
        g.create_group(input_name).attrs["weight_names"] = np.zeros((0,))
        layer_names = [input_name]
        for i, layer in enumerate(params):
            lname = "dense" if i == 0 else f"dense_{i}"
            layer_names.append(lname)
            lg = g.create_group(lname).create_group(lname)
            lg.create_dataset("kernel:0", data=_host(layer["w"]))
            lg.create_dataset("bias:0", data=_host(layer["b"]))
            g[lname].attrs["weight_names"] = [
                f"{lname}/kernel:0".encode(),
                f"{lname}/bias:0".encode(),
            ]
        g.attrs["layer_names"] = [n.encode() for n in layer_names]
        g.attrs["backend"] = b"tensorflow"
        g.attrs["keras_version"] = KERAS_VERSION
        f.attrs["backend"] = b"tensorflow"
        f.attrs["keras_version"] = KERAS_VERSION
        f.attrs["model_config"] = json.dumps(cfg).encode()
        if loss is not None:
            f.attrs["training_config"] = json.dumps(
                _training_config(loss, learning_rate)
            ).encode()
    return path
