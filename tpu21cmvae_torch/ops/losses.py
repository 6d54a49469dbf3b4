"""Per-sample training losses on tensors (the port of
``tpu21cmvae/ops/losses.py``).

The relative-MSE amplitude constant ``scaled_mean = mean/std`` comes from
the :class:`~tpu21cmvae_torch.ops.transforms.Normalizer` once
(``Normalizer.scaled_mean``), not from the training split on every step
as in the reference's ``relative_mse_loss`` closure (reference
``emulator.py:51-83``).
"""

from __future__ import annotations

import torch


def mse(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Per-sample mean squared error over the last axis (the Keras
    ``mean_squared_error`` of the params→latent stage, reference
    ``emulator.py:756-764``)."""
    return torch.mean((y_true - y_pred) ** 2, dim=-1)


def relative_mse(y_true: torch.Tensor, y_pred: torch.Tensor, scaled_mean) -> torch.Tensor:
    """Per-sample relative MSE, the square of the paper's figure of merit:
    ``mse / amplitude²``, the amplitude being max |value| of the TRUE
    signal recovered into std units by adding back ``scaled_mean``
    (reference ``emulator.py:68-81``). Inputs are standardized signals."""
    amp = torch.amax(torch.abs(y_true + scaled_mean), dim=-1)
    return mse(y_true, y_pred) / (amp * amp)


def kl_divergence(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Per-sample KL(q(z|x) ‖ N(0, I)) of a diagonal Gaussian:
    −½ Σ_j (1 + logvar − mu² − exp(logvar)) (the VAE family's term)."""
    return -0.5 * torch.sum(1.0 + logvar - mu * mu - torch.exp(logvar), dim=-1)
