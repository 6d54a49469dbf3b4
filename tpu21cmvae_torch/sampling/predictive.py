"""Posterior-predictive signal bands (:func:`posterior_predictive`; a
NumPy copy of ``tpu21cmvae/sampling/predictive.py``)."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PredictiveBand:
    """Signal-space posterior predictive summary from
    :func:`posterior_predictive`.

    ``levels``: the requested quantile levels ``(Q,)``. ``bands``: the
    per-bin signal quantiles ``(Q, n_bins)`` in mK, e.g. the default
    (0.16, 0.5, 0.84) rows are the 68 % credible band around the
    median curve. ``mean`` / ``std``: per-bin predictive mean and
    spread ``(n_bins,)``. The bin axis is the canonical redshift grid
    (:func:`tpu21cmvae_torch.utils.frequency.default_redshifts`)."""

    levels: np.ndarray
    bands: np.ndarray
    mean: np.ndarray
    std: np.ndarray


def posterior_predictive(
    predict,
    samples,
    *,
    quantiles=(0.16, 0.5, 0.84),
    noise_var: float = 0.0,
    seed: int = 0,
    max_batch: int = 65536,
) -> PredictiveBand:
    """Push posterior parameter samples through the emulator and
    summarize the implied signal per frequency bin: the
    reconstructed-signal credible band 21-cm analyses plot next to the
    data, with the whole flat chain going through the batched device
    path.

    ``predict``: the model's ``predict`` method, or any
    ``(N, n_params) → (N, n_bins)`` callable that returns arrays.
    ``samples``: posterior draws, e.g. ``SampleResult.flat``.
    ``noise_var``: optionally add observation noise (scalar variance or
    per-bin array, mK²) to get the predictive of the OBSERVED spectrum
    rather than of the signal. ``max_batch`` bounds device memory:
    samples stream through in chunks (quantiles are computed on the
    host over the full set).
    """
    samples = np.atleast_2d(np.asarray(samples, np.float32))
    outs = []
    for i in range(0, samples.shape[0], max_batch):
        outs.append(np.atleast_2d(np.asarray(predict(samples[i:i + max_batch]))))
    sig = np.concatenate(outs, axis=0).astype(np.float64)
    if np.any(np.asarray(noise_var) > 0):
        rng = np.random.default_rng(seed)
        sig = sig + rng.normal(0.0, 1.0, sig.shape) * np.sqrt(noise_var)
    levels = np.asarray(quantiles, np.float64)
    return PredictiveBand(
        levels=levels,
        bands=np.quantile(sig, levels, axis=0),
        mean=sig.mean(axis=0),
        std=sig.std(axis=0),
    )
