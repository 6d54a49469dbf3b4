"""Checkpoint files: the JAX package's ``.npz`` format, read and written
without JAX (the port of ``tpu21cmvae/models/checkpoint.py``).

A checkpoint is one ``.npz`` holding ``leaf_0 … leaf_{n-1}`` (the leaves
of a JAX pytree in its flatten order) and a ``__header__`` JSON blob with
``format_version`` 1, the pytree's ``treedef`` string, ``n_leaves`` and
the user metadata, written atomically (temp file + ``os.replace``). The
port has no pytrees: callers bind leaves by position, and write the
``treedef`` string JAX would write, so files pass between the packages.
"""

from __future__ import annotations

import json
from typing import List, Optional, Tuple

import numpy as np

from tpu21cmvae_torch.utils.io import atomic_write

_FORMAT_VERSION = 1


def save_checkpoint(path: str, leaves, treedef: str,
                    metadata: Optional[dict] = None) -> str:
    """Save arrays (in JAX flatten order) with their ``treedef`` string."""
    arrays = {f"leaf_{i}": np.asarray(leaf) for i, leaf in enumerate(leaves)}
    header = json.dumps(
        {
            "format_version": _FORMAT_VERSION,
            "treedef": treedef,
            "n_leaves": len(arrays),
            "metadata": metadata or {},
        }
    )
    with atomic_write(path) as f:
        np.savez(
            f, __header__=np.frombuffer(header.encode(), dtype=np.uint8), **arrays
        )
    return path


def _header(data, path: str) -> dict:
    header = json.loads(bytes(data["__header__"]).decode())
    version = header.get("format_version")
    if version != _FORMAT_VERSION:
        raise ValueError(
            f"Checkpoint {path!r} has format_version {version!r}; this "
            f"build reads version {_FORMAT_VERSION}"
        )
    return header


def load_checkpoint(path: str) -> Tuple[List[np.ndarray], dict]:
    """``(leaves, metadata)``: the arrays in stored (flatten) order."""
    with np.load(path) as data:
        header = _header(data, path)
        leaves = [data[f"leaf_{i}"] for i in range(header["n_leaves"])]
    return leaves, header["metadata"]
