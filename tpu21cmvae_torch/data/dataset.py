"""The 21cmGEM dataset container and its HDF5 file (a NumPy copy of the
parts of ``tpu21cmvae/data/dataset.py`` that need no network).

Nothing happens at import. The port has no downloader: put the file at
:func:`default_cache_path` (or pass its path) and :func:`ensure_dataset`
reads it; :mod:`tpu21cmvae_torch.data.synthetic` needs no file at all.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np

from tpu21cmvae_torch.utils.io import atomic_write

_KEYS = (
    "par_train",
    "par_val",
    "par_test",
    "signal_train",
    "signal_val",
    "signal_test",
)


class DataSplits(NamedTuple):
    """The six arrays of the 21cmGEM dataset (h5 keys at reference
    ``emulator.py:199-204``). Signals are in mK over 451 bins, z=5-50."""

    par_train: np.ndarray
    par_val: np.ndarray
    par_test: np.ndarray
    signal_train: np.ndarray
    signal_val: np.ndarray
    signal_test: np.ndarray

    @property
    def n_params(self) -> int:
        return self.par_train.shape[-1]

    @property
    def n_bins(self) -> int:
        return self.signal_train.shape[-1]


def load_dataset(path: str) -> DataSplits:
    """Read the six splits from an HDF5 file into host memory."""
    import h5py

    with h5py.File(path, "r") as hf:
        return DataSplits(*(np.asarray(hf[k]) for k in _KEYS))


def save_dataset(splits: DataSplits, path: str) -> str:
    """Write splits to HDF5 with the reference's key layout (readable by
    :func:`load_dataset`, the JAX package's and the reference's loader at
    reference ``emulator.py:198-204``), atomically."""
    import h5py

    with atomic_write(path, suffix=".h5.part") as f:
        with h5py.File(f, "w") as hf:
            for key, arr in zip(_KEYS, splits):
                hf.create_dataset(key, data=np.asarray(arr))
    return path


def default_cache_path() -> str:
    """``$TPU21CMVAE_CACHE`` or ``~/.cache/tpu21cmvae/dataset_21cmVAE.h5``
    (the JAX package's cache path)."""
    root = os.environ.get(
        "TPU21CMVAE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "tpu21cmvae"),
    )
    return os.path.join(root, "dataset_21cmVAE.h5")


def ensure_dataset(path: Optional[str] = None) -> DataSplits:
    """Load the 21cmGEM dataset from ``path`` (default
    :func:`default_cache_path`). Unlike the JAX package's, it never
    downloads: a missing file raises ``FileNotFoundError``."""
    path = path or default_cache_path()
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no 21cmGEM dataset at {path}; copy dataset_21cmVAE.h5 there (or set "
            "TPU21CMVAE_CACHE to its directory): this package does not download it"
        )
    return load_dataset(path)
