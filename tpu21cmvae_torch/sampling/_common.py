"""Shared sampler helpers: prior box, walker init, thinning, prior
resolution (the parts of ``tpu21cmvae/sampling/_common.py`` that HMC
needs)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _resolve_bounds(bounds, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(lo, hi)`` float32 tensors on ``device`` from a (P, 2) box
    (default: the 21cmGEM-shaped ``PAR_RANGES``)."""
    if bounds is None:
        from tpu21cmvae_torch.data.synthetic import PAR_RANGES

        bounds = PAR_RANGES
    b = torch.as_tensor(np.asarray(bounds, np.float32), device=device)
    return b[:, 0].contiguous(), b[:, 1].contiguous()


def _init_walkers(generator: torch.Generator, n_walkers: int, lo, hi):
    """Uniform draws in the box, from ``generator`` (on ``lo``'s device)."""
    u = torch.rand((n_walkers, lo.shape[0]), generator=generator,
                   device=lo.device, dtype=torch.float32)
    return lo + (hi - lo) * u


def _thin_state(n_steps: int, thin: int, x: torch.Tensor):
    """``(n_keep, buf)``: a preallocated ``(n_keep, *x.shape)`` buffer for
    the thinned chain, ``n_keep = n_steps // thin`` (0 when ``thin`` is
    0). Only kept steps are ever stored."""
    n_keep = n_steps // thin if thin else 0
    return n_keep, torch.zeros((n_keep, *x.shape), dtype=x.dtype, device=x.device)


def _thin_write(buf: torch.Tensor, t: int, x: torch.Tensor, thin: int):
    """Store ``x`` for 0-based step ``t`` if it is kept: step ``t`` is
    kept iff ``(t + 1) % thin == 0``, into row ``(t + 1) // thin − 1``."""
    if thin and (t + 1) % thin == 0:
        buf[(t + 1) // thin - 1] = x


def _resolve_log_prior(log_prior):
    """None → the flat box prior, ``(B, P) → (B,)`` zeros. Smooth priors
    over the raw parameters wait for ROADMAP queue 8."""
    if log_prior is not None:
        raise NotImplementedError(
            "the port samples under the flat box prior only; log_prior "
            "support waits for ROADMAP queue 8"
        )
    return lambda x: torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
