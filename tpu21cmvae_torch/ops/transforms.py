"""Signal standardization and parameter transforms on tensors
(the port of ``tpu21cmvae/ops/transforms.py``; reference
``preprocess.py``: ``preproc`` ``:4-24``, ``unpreproc`` ``:27-46``,
``par_transform`` ``:49-110``).

The statistics are computed once, in float64 on the host, into a
:class:`Normalizer` that every checkpoint carries, so inference never
needs the training data.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from tpu21cmvae_torch.ops.fold import _FX_CLAMP, _N_LOG_COLS, _log_clamp

FIELDS = ("signal_mean", "signal_std", "par_min", "par_max")
"""Normalizer fields in the JAX package's pytree (and checkpoint) order."""


@dataclasses.dataclass(frozen=True)
class Normalizer:
    """Normalization constants as tensors on one device.

    ``signal_mean`` (bins,): per-bin training-signal mean;
    ``signal_std`` (): global std over all training-signal elements;
    ``par_min``, ``par_max`` (n_params,): per-column range of the
    LOG-transformed training parameters.
    """

    signal_mean: torch.Tensor
    signal_std: torch.Tensor
    par_min: torch.Tensor
    par_max: torch.Tensor

    @classmethod
    def from_arrays(cls, fields, *, device, dtype=torch.float32) -> "Normalizer":
        """From the four fields of a mapping or of any object that has
        them as attributes (e.g. the JAX package's Normalizer after
        ``tree_map(np.asarray, …)``)."""
        get = fields.__getitem__ if isinstance(fields, Mapping) else (
            lambda name: getattr(fields, name)
        )
        return cls(*(
            torch.tensor(np.asarray(get(name)), dtype=dtype, device=device)
            for name in FIELDS
        ))

    @classmethod
    def from_data(cls, par_train, signal_train, *, device,
                  dtype=torch.float32) -> "Normalizer":
        """Compute the constants once from the training split, in float64
        on the host (the reference's NumPy defaults), stored at
        ``dtype`` on ``device``."""
        par_train = np.asarray(par_train, dtype=np.float64)
        signal_train = np.asarray(signal_train, dtype=np.float64)
        logp = _log_transform_np(par_train)
        return cls.from_arrays(
            {
                "signal_mean": signal_train.mean(axis=0),
                "signal_std": signal_train.std(),
                "par_min": logp.min(axis=0),
                "par_max": logp.max(axis=0),
            },
            device=device,
            dtype=dtype,
        )

    @classmethod
    def template(cls, n_bins: int, n_params: int) -> "Normalizer":
        """Shape-only stand-in (uninitialized NumPy fields) for binding
        checkpoint leaves by position."""
        return cls(np.empty((n_bins,), np.float32), np.empty((), np.float32),
                   np.empty((n_params,), np.float32), np.empty((n_params,), np.float32))

    @property
    def device(self) -> torch.device:
        return self.signal_mean.device

    @property
    def scaled_mean(self) -> torch.Tensor:
        """signal_mean / signal_std — the constant the relative-MSE loss
        adds back to standardized signals (reference ``emulator.py:70-72``)."""
        return self.signal_mean / self.signal_std

    def to_numpy(self) -> dict:
        return {name: getattr(self, name).detach().cpu().numpy() for name in FIELDS}


def resolve_normalizer(data, normalizer, *, device) -> Normalizer:
    """The constructor rule every model family shares: an explicit
    Normalizer wins; otherwise one is computed from ``data``'s training
    split on ``device``; with neither, fail loudly."""
    if normalizer is not None:
        return normalizer
    if data is None:
        raise ValueError(
            "Provide `data` (to compute normalization constants) or an "
            "explicit `normalizer`."
        )
    return Normalizer.from_data(data.par_train, data.signal_train, device=device)


def _log_transform_np(params: np.ndarray) -> np.ndarray:
    """Host-side: log10 of the first three columns with the fx==0 clamp."""
    out = params.astype(np.float64, copy=True)
    head = out[:, :_N_LOG_COLS]
    head[head[:, 2] == 0.0, 2] = _FX_CLAMP
    out[:, :_N_LOG_COLS] = np.log10(head)
    return out


def preproc(signal: torch.Tensor, norm: Normalizer) -> torch.Tensor:
    """Standardize signals: subtract the per-bin training mean, divide by
    the global training std."""
    return (signal - norm.signal_mean) / norm.signal_std


def unpreproc(signal: torch.Tensor, norm: Normalizer) -> torch.Tensor:
    """Exact inverse of :func:`preproc`."""
    return signal * norm.signal_std + norm.signal_mean


def par_transform(params: torch.Tensor, norm: Normalizer) -> torch.Tensor:
    """Raw astrophysical parameters → network input: log10 of columns
    0-2 (``fx == 0`` clamped to 1e-6), then the affine map sending the
    training range of each column onto [-1, 1]. 1-D inputs are promoted
    to a single row (reference ``preprocess.py:71-72``)."""
    params = torch.atleast_2d(params)
    return 2.0 * (_log_clamp(params) - norm.par_min) / (norm.par_max - norm.par_min) - 1.0
