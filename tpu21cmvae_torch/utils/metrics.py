"""Evaluation metrics for emulated global signals (host-side NumPy).

``error`` and ``band_mask`` are copies of ``tpu21cmvae/utils/metrics.py``
(Eq. 1 of Bye et al. 2022, reference ``emulator.py:129-192``, with
``flow=0`` honoured as a bound and a boolean band mask).
:func:`grad_gate_violation` is the gradient accuracy gate of
``bench_mcmc.py::_grad_gate_violation``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

GRAD_RTOL = 1e-2
"""Gradient gate: q99.9 of the per-row relative error."""

GRAD_MAX_REL = 0.5
"""Gradient gate: cap on the worst row's relative error."""


def error(
    true_signal,
    pred_signal,
    relative: bool = True,
    nu_arr: Optional[np.ndarray] = None,
    flow: Optional[float] = None,
    fhigh: Optional[float] = None,
) -> np.ndarray:
    """Per-signal RMSE between true and predicted signals.

    ``relative=True`` divides each RMSE by the max |amplitude| of the
    true signal in the selected band and expresses it as a percent
    (reference ``emulator.py:189-191``); else mK. ``flow``/``fhigh`` are
    inclusive band bounds in the units of ``nu_arr`` (required with
    either bound). Returns one error per signal (a scalar array for a
    single 1-D signal pair).
    """
    true_signal = np.asarray(true_signal)
    pred_signal = np.asarray(pred_signal)
    band = flow is not None or fhigh is not None
    if band and nu_arr is None:
        raise ValueError(
            "No frequency array is given, cannot compute error in the "
            "specified frequency band."
        )
    # promote each side independently: a squeezed single-row prediction
    # against a (1, bins) truth must still reduce over the bin axis
    squeeze = pred_signal.ndim == 1 and true_signal.ndim == 1
    pred_signal = np.atleast_2d(pred_signal)
    true_signal = np.atleast_2d(true_signal)

    if band:
        mask = band_mask(nu_arr, flow, fhigh)
        pred_signal = pred_signal[:, mask]
        true_signal = true_signal[:, mask]

    err = np.sqrt(np.mean((pred_signal - true_signal) ** 2, axis=1))
    if relative:
        err = err / np.max(np.abs(true_signal), axis=1) * 100.0
    return err[0] if squeeze else err


def band_mask(nu_arr, flow=None, fhigh=None) -> np.ndarray:
    """Boolean frequency-band mask (inclusive bounds; ``flow=0`` valid)."""
    nu_arr = np.asarray(nu_arr)
    mask = np.ones(nu_arr.shape, dtype=bool)
    if flow is not None:
        mask &= nu_arr >= flow
    if fhigh is not None:
        mask &= nu_arr <= fhigh
    return mask


def grad_rel_error(got, ref) -> np.ndarray:
    """Per-row gradient error ``‖got − ref‖ / (‖ref‖ + rms‖ref‖)``: the
    rms term keeps rows whose exact gradient is near zero (the mode)
    from dominating."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    norm = np.linalg.norm(ref, axis=1)
    rms = np.sqrt(np.mean(norm**2))
    return np.linalg.norm(got - ref, axis=1) / (norm + rms)


def grad_gate_violation(got, ref) -> float:
    """Worst excess over the two-part gradient gate (≤ 0 passes): q99.9
    of :func:`grad_rel_error` ≤ :data:`GRAD_RTOL` and its max ≤
    :data:`GRAD_MAX_REL`. Not a max over rows alone: a different
    summation order or tier can flip an isolated ReLU mask on a kink
    row, whose exact gradient is set-valued, and move that one row by
    O(1) whatever the matmul accuracy."""
    rel = grad_rel_error(got, ref)
    q999 = float(np.quantile(rel, 0.999))
    return max(q999 - GRAD_RTOL, float(rel.max()) - GRAD_MAX_REL)
