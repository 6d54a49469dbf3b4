"""Frozen configuration dataclasses (a copy of the parts of
``tpu21cmvae/utils/config.py`` the port runs: the direct, autoencoder and
VAE emulators' architectures and their training recipes)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


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


DIRECT_ALIGNED = DirectEmulatorConfig(hidden_dims=(256, 256, 128, 128, 128))
"""The aligned flagship architecture, 7 → 256 → 256 → 128 → 128 → 128 →
451 (191,939 weights): every hidden width a multiple of 128, found by a
throughput-aware successive-halving search and shipped, fine-tuned for
the single-pass bf16 tier (``native_precision="default"``), as
``pretrained/direct_aligned_bf16.npz``. Load it with
``DirectEmulator.from_checkpoint`` and predict at
``predict_fn(precision="native")``."""


@dataclasses.dataclass(frozen=True)
class AutoEncoderConfig:
    """Autoencoder-based emulator architecture (reference
    ``emulator.py:521-525``; the shipped h5 weights' widths)."""

    n_params: int = 7
    n_bins: int = 451
    latent_dim: int = 9
    enc_hidden_dims: Tuple[int, ...] = (352,)
    dec_hidden_dims: Tuple[int, ...] = (32, 352)
    em_hidden_dims: Tuple[int, ...] = (352, 352, 352, 224)
    activation: str = "relu"

    def encoder(self) -> MLPConfig:
        return MLPConfig(self.n_bins, self.enc_hidden_dims, self.latent_dim, self.activation)

    def decoder(self) -> MLPConfig:
        return MLPConfig(self.latent_dim, self.dec_hidden_dims, self.n_bins, self.activation)

    def emulator(self) -> MLPConfig:
        return MLPConfig(self.n_params, self.em_hidden_dims, self.latent_dim, self.activation)


@dataclasses.dataclass(frozen=True)
class VAEConfig(AutoEncoderConfig):
    """Variational variant: the encoder emits (mu, logvar) and the loss
    adds ``beta`` times the KL term, warmed up linearly over
    ``kl_anneal_epochs`` epochs (0: no warm-up). The reconstruction term
    is the per-bin relative MSE (O(1e-4) once trained), so a KL term of
    weight 1 collapses the posterior; the JAX package's sweep on the
    synthetic set found β = 1e-4 with a 50-epoch warm-up keeps every
    latent active (``tpu21cmvae/utils/config.py``)."""

    beta: float = 1e-4
    kl_anneal_epochs: int = 50


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """One training run. Canonical values are the reference's recipe
    (``notebooks/Training.ipynb`` cells 4-5; batch size at
    reference ``emulator.py:372``)."""

    epochs: int = 350
    batch_size: int = 256
    learning_rate: float = 0.01
    # Adam moments — Keras defaults (epsilon=1e-7, not optax's 1e-8).
    beta_1: float = 0.9
    beta_2: float = 0.999
    epsilon: float = 1e-7
    # EarlyStopping(monitor=val_loss, ...) semantics.
    early_stop_patience: Optional[int] = 15
    early_stop_min_delta: float = 1e-10
    restore_best_weights: bool = True
    # ReduceLROnPlateau semantics.
    plateau_patience: Optional[int] = 5
    plateau_factor: float = 0.95
    plateau_min_delta: float = 5e-9
    plateau_min_lr: float = 1e-4
    seed: int = 0


DIRECT_TRAIN_DEFAULT = TrainConfig()
"""Direct-emulator recipe: Adam lr=0.01, 350 epochs, plateau factor 0.95
(``Training.ipynb`` cells 4-5)."""

DIRECT_TRAIN_STRONG = TrainConfig(early_stop_patience=30)
"""The reference recipe with doubled early-stopping patience: the
published patience of 15 with min_delta=1e-10 often fires while the LR
schedule is still working; patience 30 trains longer and reached a lower
mean error on the synthetic set in the JAX package's runs
(``tpu21cmvae/utils/config.py``)."""

AE_TRAIN_DEFAULT = TrainConfig(
    epochs=250,
    learning_rate=1e-3,
    early_stop_min_delta=5e-10,
    plateau_factor=0.9,
)
"""Autoencoder stage recipe: Adam lr=1e-3, 250 epochs, plateau factor 0.9
(``Training.ipynb`` cells 10-11)."""

AE_EMULATOR_TRAIN_DEFAULT = TrainConfig(
    epochs=250,
    learning_rate=1e-2,
    early_stop_min_delta=5e-5,
    plateau_factor=0.9,
    plateau_min_delta=5e-3,
)
"""Params→latent stage recipe: Adam lr=1e-2, 250 epochs, looser deltas
(``Training.ipynb`` cells 10-11)."""

AE_TRAIN_STRONG = dataclasses.replace(AE_TRAIN_DEFAULT, early_stop_patience=30)
AE_EMULATOR_TRAIN_STRONG = dataclasses.replace(AE_EMULATOR_TRAIN_DEFAULT, early_stop_patience=30)
"""Patience-30 variants of the two stage recipes (see
:data:`DIRECT_TRAIN_STRONG`)."""
