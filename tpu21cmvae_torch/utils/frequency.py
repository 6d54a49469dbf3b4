"""Redshift ↔ frequency conversions for the 21-cm line.

Pure functions, safe on NumPy or JAX arrays. Capability parity with the
reference's ``redshift2freq`` / ``freq2redshift``
(reference ``emulator.py:86-126``) minus its quirk: the reference's
``freq2redshift`` mutates its input in place (``nu *= 1e6``,
``emulator.py:124``); these never mutate.
"""

from __future__ import annotations

import numpy as np

NU_0 = 1420405751.7667
"""Rest frequency of the 21-cm hyperfine line, in Hz
(reference ``emulator.py:86``)."""

N_BINS = 451
"""Number of redshift/frequency bins in a standard global-signal curve."""

N_PARAMS = 7
"""Number of astrophysical input parameters."""


def redshift2freq(z):
    """Convert redshift(s) to observed 21-cm frequency in MHz.

    ν [MHz] = NU_0 / (1 + z) / 1e6  (reference ``emulator.py:89-106``).
    """
    return NU_0 / (1.0 + z) / 1e6


def freq2redshift(nu):
    """Convert observed frequency(ies) in MHz to redshift.

    z = NU_0 / (ν·1e6) − 1  (reference ``emulator.py:109-126``, without the
    in-place input mutation).
    """
    return NU_0 / (np.asarray(nu, dtype=np.float64) * 1e6) - 1.0


def default_redshifts() -> np.ndarray:
    """The canonical 451-bin redshift axis, z = 5…50 in steps of 0.1
    (reference ``emulator.py:197``)."""
    return np.linspace(5.0, 50.0, N_BINS)


def default_frequencies() -> np.ndarray:
    """Frequency axis (MHz) corresponding to :func:`default_redshifts`."""
    return redshift2freq(default_redshifts())
