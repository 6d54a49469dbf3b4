"""Informative priors for the samplers (the port of
``tpu21cmvae/priors.py``).

The samplers in :mod:`tpu21cmvae_torch.sampling` default to the flat box
prior (the 21cmGEM prior shape), but real 21-cm analyses constrain some
astrophysical parameters externally, e.g. Planck's optical-depth
measurement is a Gaussian prior on ``tau``. This module provides the two
prior representations of the JAX package:

* ``log_prior(x) → (B,)``: a log-density over RAW parameters, added to
  the log-likelihood by the chain samplers
  (:func:`~tpu21cmvae_torch.sampling.mh.sample_mh`,
  :func:`~tpu21cmvae_torch.sampling.mh.sample_ensemble`,
  :func:`~tpu21cmvae_torch.sampling.gradient.sample_hmc`) and by
  :func:`~tpu21cmvae_torch.sampling.reweight.reweight`. Normalization is
  optional: sampler output is invariant to a constant shift.
* ``prior_transform(u) → (B, P)``: the MultiNest/dynesty convention, a
  map from the unit cube to parameter space such that uniform ``u`` gives
  prior-distributed ``θ`` (what a nested sampler consumes).

:class:`GaussianBoxPrior` builds both views from one spec: independent
per-parameter truncated Gaussians inside the prior box, with ``sigma``
``None``/``inf`` marking a parameter as flat. Both views take a tensor
(or an array) and return a tensor on the input's device; ``log_prior`` is
differentiable by ``torch.autograd`` (each row independent, as HMC's
force requires). Constants are built in float64 NumPy and cast to
float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["GaussianBoxPrior", "ndtri"]

_SQRT2 = 1.4142135623730951


def _ndtr(z: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.special.erf(z / _SQRT2))


def _f32(a, like: torch.Tensor) -> torch.Tensor:
    """A float64 host constant as float32 on ``like``'s device."""
    return torch.as_tensor(np.asarray(a, np.float32), device=like.device)


@dataclasses.dataclass(frozen=True)
class GaussianBoxPrior:
    """Independent truncated-Gaussian priors inside the prior box.

    ``mean`` / ``sigma``: per-parameter center and width in RAW units;
    a ``sigma`` of ``None`` (or ``inf``/``nan``) keeps that parameter's
    prior flat over the box. ``bounds``: the ``(P, 2)`` box (defaults to
    the 21cmGEM-shaped ranges). Example: a Planck-style ±0.006
    constraint on ``tau`` (parameter 3), everything else flat::

        prior = GaussianBoxPrior.for_params(
            {3: (0.054, 0.006)}, n_params=7)
        res = em.sample_posterior(obs, nv, log_prior=prior.log_prior)
    """

    mean: np.ndarray
    sigma: np.ndarray
    lo: np.ndarray
    hi: np.ndarray

    @classmethod
    def build(
        cls,
        mean: Sequence[Optional[float]],
        sigma: Sequence[Optional[float]],
        bounds=None,
    ) -> "GaussianBoxPrior":
        from tpu21cmvae_torch.sampling._common import _resolve_bounds

        lo, hi = _resolve_bounds(bounds, "cpu")
        lo = lo.numpy().astype(np.float64)
        hi = hi.numpy().astype(np.float64)
        p = lo.shape[0]
        m = np.array(
            [np.nan if v is None else float(v) for v in mean], np.float64
        )
        s = np.array(
            [np.inf if v is None else float(v) for v in sigma], np.float64
        )
        if m.shape != (p,) or s.shape != (p,):
            raise ValueError(
                f"mean and sigma must have length {p}; got "
                f"{m.shape} / {s.shape}"
            )
        s = np.where(np.isnan(s), np.inf, s)
        gauss = np.isfinite(s)
        if (s[gauss] <= 0).any():
            raise ValueError("Gaussian sigmas must be positive")
        if np.isnan(m[gauss]).any():
            raise ValueError("Gaussian parameters need a finite mean")
        return cls(mean=m, sigma=s, lo=lo, hi=hi)

    @classmethod
    def for_params(
        cls, constraints: dict, n_params: int = 7, bounds=None
    ) -> "GaussianBoxPrior":
        """Build from ``{index: (mean, sigma)}``; other params flat."""
        mean = [None] * n_params
        sigma = [None] * n_params
        for idx, (m, s) in constraints.items():
            mean[int(idx)] = m
            sigma[int(idx)] = s
        return cls.build(mean, sigma, bounds)

    # -- the two consumer views --------------------------------------------

    def log_prior(self, x) -> torch.Tensor:
        """Log-density ``(B, P) → (B,)`` over RAW parameters (up to a
        constant; rows independent), on ``x``'s device. Gaussian dims
        contribute ``−½((x−m)/s)²``, flat dims 0. The box indicator
        itself is enforced by the samplers' bounds handling, not here, so
        the function stays smooth for HMC."""
        x = torch.as_tensor(x)
        if not np.isfinite(self.sigma).any():
            return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        m, inv_s = self._gauss_constants(x.device)
        z = (x - m) * inv_s
        return -0.5 * torch.sum(z * z, dim=-1)

    def _gauss_constants(self, device):
        """``(mean, 1/sigma)`` as float32 on ``device`` (0 on flat dims),
        built once per device: a sampler calls :meth:`log_prior` on every
        step."""
        cache = self.__dict__.setdefault("_on_device", {})
        if device not in cache:
            gauss = np.isfinite(self.sigma)
            like = torch.empty(0, device=device)
            cache[device] = (
                _f32(np.where(gauss, self.mean, 0.0), like),
                _f32(np.where(gauss, 1.0 / np.where(gauss, self.sigma, 1.0), 0.0), like),
            )
        return cache[device]

    def log_box_mean(self, lo=None, hi=None) -> float:
        """``log E_flat[exp(log_prior)]`` over the box: the constant
        that converts a raw-density integral against the NORMALIZED
        flat measure (``∫ f·π_raw dx / V``) into one against the box-
        normalized prior (``∫ f dπ̃``). Analytic: per Gaussian dim
        ``log[s·√(2π)·(Φ(b)−Φ(a)) / span]``, flat dims 0. ``lo``/``hi``
        override the box (an evidence call's bounds may differ from the
        prior's)."""
        lo = self.lo if lo is None else np.asarray(lo, np.float64)
        hi = self.hi if hi is None else np.asarray(hi, np.float64)
        gauss = np.isfinite(self.sigma)
        total = 0.0
        for j in np.nonzero(gauss)[0]:
            s, m = float(self.sigma[j]), float(self.mean[j])
            a = 0.5 * (1.0 + math.erf((lo[j] - m) / (s * _SQRT2)))
            b = 0.5 * (1.0 + math.erf((hi[j] - m) / (s * _SQRT2)))
            mass = s * math.sqrt(2.0 * math.pi) * (b - a)
            total += math.log(mass) - math.log(float(hi[j] - lo[j]))
        return total

    def prior_transform(self, u) -> torch.Tensor:
        """Unit-cube map ``(B, P) → (B, P)`` on ``u``'s device: uniform
        ``u`` gives prior-distributed θ (exact truncated-Gaussian inverse
        CDF on Gaussian dims, affine on flat dims)."""
        u = torch.as_tensor(u).to(torch.float32)
        gauss = np.isfinite(self.sigma)
        lo, hi = _f32(self.lo, u), _f32(self.hi, u)
        flat_x = lo + (hi - lo) * u
        if not gauss.any():
            return flat_x
        m = np.where(gauss, self.mean, 0.0)
        s = np.where(gauss, self.sigma, 1.0)
        a = _ndtr(_f32((self.lo - m) / s, u))
        b = _ndtr(_f32((self.hi - m) / s, u))
        # clamp the re-mapped quantile off the exact tails so ndtri
        # stays finite at u ∈ {0, 1}
        q = torch.clamp(a + (b - a) * u, 1e-7, 1.0 - 1e-7)
        gauss_x = _f32(m, u) + _f32(s, u) * ndtri(q)
        return torch.where(torch.as_tensor(gauss, device=u.device), gauss_x, flat_x)


def ndtri(q: torch.Tensor) -> torch.Tensor:
    """Inverse standard-normal CDF (Φ⁻¹) via erfinv."""
    return _SQRT2 * torch.special.erfinv(2.0 * q - 1.0)
