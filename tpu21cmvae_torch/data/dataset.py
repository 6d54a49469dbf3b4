"""The 21cmGEM dataset container (a NumPy copy of the parts of
``tpu21cmvae/data/dataset.py`` that need no network)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

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
