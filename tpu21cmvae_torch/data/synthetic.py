"""Synthetic 21-cm-like dataset for tests and offline development.

The real 21cmGEM dataset is a ~300 MB Zenodo download
(reference ``__init__.py:8-16``) that is not always available. This module
generates a smooth, deterministic, *learnable* surrogate: a parametric
absorption-trough + emission-bump model of the global signal whose shape
depends on all 7 astrophysical parameters, drawn from ranges shaped like
the 21cmGEM priors (including ``fx == 0`` rows, which exercise the log
clamp at reference ``preprocess.py:76``).

This is NOT the 21cmGEM physics — it exists so that the end-to-end
pipeline (transforms → training → prediction → error metrics) can be
exercised and trained to convergence without the real data.
"""

from __future__ import annotations

import numpy as np

from tpu21cmvae_torch.data.dataset import DataSplits
from tpu21cmvae_torch.utils.frequency import default_redshifts

# Parameter ranges in the order [fstar, Vc, fx, tau, alpha, nu_min, Rmfp],
# shaped like the 21cmGEM priors (Bye et al. 2022 Table; column order at
# reference emulator.py:293-301). fstar/Vc/fx are log-uniform.
PAR_RANGES = np.array(
    [
        [1e-4, 0.5],  # fstar
        [4.2, 100.0],  # Vc [km/s]
        [1e-4, 1000.0],  # fx (plus explicit zeros)
        [0.04, 0.09],  # tau
        [1.0, 1.5],  # alpha
        [0.1, 3.0],  # nu_min [keV]
        [10.0, 50.0],  # Rmfp [Mpc]
    ]
)

_FX_ZERO_FRACTION = 0.05


def synthetic_params(n: int, rng: np.random.Generator) -> np.ndarray:
    """Draw n parameter rows; columns 0-2 log-uniform, rest uniform."""
    lo, hi = PAR_RANGES[:, 0], PAR_RANGES[:, 1]
    u = rng.uniform(size=(n, 7))
    pars = lo + u * (hi - lo)
    for c in range(3):
        pars[:, c] = 10 ** (
            np.log10(lo[c]) + u[:, c] * (np.log10(hi[c]) - np.log10(lo[c]))
        )
    zero = rng.uniform(size=n) < _FX_ZERO_FRACTION
    pars[zero, 2] = 0.0
    return pars


def synthetic_signals(pars: np.ndarray, redshifts=None) -> np.ndarray:
    """Map parameter rows to smooth 451-bin δT(z) curves in mK.

    Absorption trough whose depth, center, and width move with the
    parameters, partially erased by X-ray heating (fx), plus a small
    emission bump at low z for strongly-heated models.
    """
    if redshifts is None:
        redshifts = default_redshifts()
    z = np.asarray(redshifts)[None, :]
    p = np.asarray(pars, dtype=np.float64)

    lfstar = np.log10(np.clip(p[:, 0:1], 1e-6, None))  # [-4, -0.3]
    lvc = np.log10(np.clip(p[:, 1:2], 1e-6, None))  # [0.62, 2]
    lfx = np.log10(np.where(p[:, 2:3] == 0.0, 1e-6, p[:, 2:3]))  # [-6, 3]
    tau = p[:, 3:4]
    alpha = p[:, 4:5]
    nu_min = p[:, 5:6]
    rmfp = p[:, 6:7]

    # Trough center: earlier star formation (high fstar, low Vc) pulls the
    # absorption feature to higher z.
    z_c = 14.0 + 4.0 * (lfstar + 4.0) / 3.7 - 3.0 * (lvc - 0.62) / 1.38 + 20.0 * (
        tau - 0.04
    )
    width = 2.5 + 1.5 * (alpha - 1.0) + rmfp / 40.0 + 0.5 * (lvc - 0.62)
    # Trough depth shrinks with X-ray heating.
    heat = 1.0 / (1.0 + np.exp(-(lfx + 1.0)))  # 0 (no heating) → 1
    depth = (60.0 + 150.0 * (lfstar + 4.0) / 3.7) * (1.0 - 0.85 * heat)

    trough = -depth * np.exp(-0.5 * ((z - z_c) / width) ** 2)

    # Emission bump below the trough for heated models.
    z_e = np.clip(z_c - 2.5 * width, 5.5, None)
    bump = (
        25.0
        * heat
        * (0.3 + nu_min / 3.0)
        * np.exp(-0.5 * ((z - z_e) / (0.8 * width)) ** 2)
    )

    # High-z collisional-coupling tail common to all models.
    tail = -15.0 * np.exp(-((50.0 - z) / 12.0) ** 2)

    return (trough + bump + tail).astype(np.float64)


def synthetic_dataset(
    n_train: int = 2048,
    n_val: int = 256,
    n_test: int = 256,
    seed: int = 0,
    redshifts=None,
) -> DataSplits:
    """Generate train/val/test splits shaped like the 21cmGEM dataset."""
    rng = np.random.default_rng(seed)
    pars = synthetic_params(n_train + n_val + n_test, rng)
    sigs = synthetic_signals(pars, redshifts)
    i1, i2 = n_train, n_train + n_val
    return DataSplits(
        par_train=pars[:i1],
        par_val=pars[i1:i2],
        par_test=pars[i2:],
        signal_train=sigs[:i1],
        signal_val=sigs[i1:i2],
        signal_test=sigs[i2:],
    )
