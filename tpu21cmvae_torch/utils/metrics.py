"""Evaluation metrics for emulated global signals (host-side NumPy).

``error`` and ``band_mask`` are copies of ``tpu21cmvae/utils/metrics.py``
(Eq. 1 of Bye et al. 2022, reference ``emulator.py:129-192``, with
``flow=0`` honoured as a bound and a boolean band mask).
:func:`loglik_gate_violation` and :func:`grad_gate_violation` are the
likelihood and gradient accuracy gates of ``bench_mcmc.py``
(``_gate_violation``, ``_grad_gate_violation``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

LOGLIK_ATOL = 0.25
"""Likelihood gate: |ΔlogL| allowed at the posterior mode."""

LOGLIK_RTOL = 1.5e-3
"""Likelihood gate: |ΔlogL| allowed per unit of depth below the mode."""

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


def loglik_gate_violation(got, ref) -> float:
    """Worst excess of |got − ref| over the depth-scaled allowance
    :data:`LOGLIK_ATOL` + :data:`LOGLIK_RTOL` · (max ref − ref) (≤ 0
    passes), ``ref`` the exact-tier log-likelihoods of the same rows: an
    accept decision compares two proposals' logL, so the bound is tight
    at the mode and grows with the depth below it."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    depth = ref.max() - ref
    return float((np.abs(got - ref) - (LOGLIK_ATOL + LOGLIK_RTOL * depth)).max())


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


def grad_gate_beside(got, ref, exact) -> float:
    """Worst excess (≤ 0 passes) of ``got``'s gradient error against
    ``exact`` over ``ref``'s own, by the gate's two parts: q99.9 of
    :func:`grad_rel_error` against ``exact`` at most ``ref``'s plus
    :data:`GRAD_RTOL`, its max at most ``ref``'s plus
    :data:`GRAD_MAX_REL`. Where ``ref`` equals ``exact`` this is
    :func:`grad_gate_violation` of ``got``. For two roundings of one tier
    (a kernel and its plain version) whose forward rounds so often that
    they part on more than 0.1 % of rows, which :func:`grad_gate_violation`
    between them cannot allow: ``got`` may be no less accurate than
    ``ref``, by the gate's margins, every row counted against ``exact``
    (the plain version at the exact tiers on the same weights)."""
    mine, theirs = grad_rel_error(got, exact), grad_rel_error(ref, exact)
    q = [float(np.quantile(r, 0.999)) for r in (mine, theirs)]
    return max(q[0] - q[1] - GRAD_RTOL, float(mine.max() - theirs.max()) - GRAD_MAX_REL)

