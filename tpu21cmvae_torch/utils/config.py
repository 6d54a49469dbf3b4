"""Frozen architecture dataclasses (a copy of the two the inference slice
needs from ``tpu21cmvae/utils/config.py``)."""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    """Architecture of one dense MLP (hidden activation + linear head)."""

    in_dim: int
    hidden_dims: Tuple[int, ...]
    out_dim: int
    activation: str = "relu"

    @property
    def sizes(self) -> Tuple[int, ...]:
        return (self.in_dim, *self.hidden_dims, self.out_dim)

    @property
    def weight_count(self) -> int:
        """Total trainable scalars (named to avoid colliding with the
        emulator configs' ``n_params`` = number of INPUT parameters)."""
        s = self.sizes
        return sum(s[i] * s[i + 1] + s[i + 1] for i in range(len(s) - 1))


@dataclasses.dataclass(frozen=True)
class DirectEmulatorConfig:
    """Flagship params→signal MLP: 7 → 288 → 352 → 288 → 224 → 451
    (371,907 params; reference ``emulator.py:196,303-309``)."""

    n_params: int = 7
    n_bins: int = 451
    hidden_dims: Tuple[int, ...] = (288, 352, 288, 224)
    activation: str = "relu"

    def mlp(self) -> MLPConfig:
        return MLPConfig(self.n_params, self.hidden_dims, self.n_bins, self.activation)
