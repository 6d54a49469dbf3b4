"""The plain reference of a deep ensemble, in float64 PyTorch: M members'
:class:`~port_bench.reference.Reference`, one per ``member_*.npz`` of a
checkpoint directory, scored as the equal-weight mixture of deep
ensembles (Lakshminarayanan, Pritzel & Blundell 2017, arXiv:1612.01474):

* the signal, the members' mean (what an observation is drawn from);
* ``log p = logsumexp_m l_m − log M``;
* its gradient ``Σ_m softmax(l)_m ∇l_m``, exact from the members' own
  gradients (∇ logsumexp = Σ softmax · ∇l), so nothing differentiates
  through the logsumexp.

Each member's ``mode`` (and ``grad_mode``) is passed on, so the control,
every member's products at the lower precision, runs through the same
mixture. It imports nothing of the program and takes nothing the
program made.
"""

from __future__ import annotations

import glob
import math
import os

import torch

from port_bench.reference import Reference


class MixtureReference:
    """The ensemble under ``directory`` (``member_00.npz`` …, in name
    order) on ``device``."""

    def __init__(self, directory: str, *, device):
        paths = sorted(glob.glob(os.path.join(directory, "member_*.npz")))
        if not paths:
            raise FileNotFoundError(f"no member_*.npz under {directory}")
        self.members = [Reference(p, device=device) for p in paths]
        self.device = self.members[0].device
        self._log_m = math.log(len(self.members))

    def forward(self, raw, mode: str = "f64") -> torch.Tensor:
        """The members' mean signal (B, n_bins) in mK, float64."""
        return torch.stack([m.forward(raw, mode) for m in self.members]).mean(dim=0)

    def loglik(self, raw, obs, noise_var: float, mode: str = "f64") -> torch.Tensor:
        """``logsumexp_m l_m − log M`` per row, float64."""
        lm = torch.stack([m.loglik(raw, obs, noise_var, mode) for m in self.members])
        return torch.logsumexp(lm, dim=0) - self._log_m

    def loglik_and_grad(self, raw, obs, noise_var: float, mode: str = "f64", grad_mode=None):
        """The mixture's log-likelihood and its gradient with respect to
        the raw parameters (B, n_params): the members' gradients weighted
        by ``softmax_m(l_m)``."""
        lm, gm = (torch.stack(t) for t in zip(*(
            m.loglik_and_grad(raw, obs, noise_var, mode, grad_mode) for m in self.members)))
        w = torch.softmax(lm, dim=0)
        return torch.logsumexp(lm, dim=0) - self._log_m, torch.sum(w[..., None] * gm, dim=0)
