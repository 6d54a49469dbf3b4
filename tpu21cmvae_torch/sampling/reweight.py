"""Importance reweighting of posterior chains under a changed
likelihood or prior (:func:`reweight`; the port of
``tpu21cmvae/sampling/reweight.py``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class WeightedPosterior:
    """Importance-weighted posterior samples from :func:`reweight`.

    ``samples``: (N, n_params) raw-parameter rows; ``logw``:
    per-sample log importance weights (normalized to max 0). Summary
    methods mirror the unweighted :class:`SampleResult` views;
    ``ess()`` is the Kish effective sample size ``(Σw)²/Σw²`` — the
    honest "how many samples survived the prior swap" number. If it is
    a small fraction of N, the new prior barely overlaps the sampled
    posterior: re-run the sampler with ``log_prior=`` instead.
    """

    samples: np.ndarray
    logw: np.ndarray

    def _w(self) -> np.ndarray:
        w = np.exp(self.logw - self.logw.max())
        return w / w.sum()

    def ess(self) -> float:
        w = self._w()
        return float(1.0 / np.sum(w**2))

    def mean(self) -> np.ndarray:
        return self._w() @ self.samples

    def std(self) -> np.ndarray:
        w = self._w()
        mu = w @ self.samples
        return np.sqrt(w @ (self.samples - mu) ** 2)

    def quantile(self, q) -> np.ndarray:
        """Weighted per-parameter quantiles (q scalar or array)."""
        w = self._w()
        qs = np.atleast_1d(np.asarray(q, np.float64))
        out = np.empty((qs.shape[0], self.samples.shape[1]))
        for j in range(self.samples.shape[1]):
            order = np.argsort(self.samples[:, j])
            cdf = np.cumsum(w[order])
            out[:, j] = np.interp(qs, cdf, self.samples[order, j])
        return out[0] if np.ndim(q) == 0 else out

    def resample(self, n: int, seed: int = 0) -> np.ndarray:
        """``n`` equal-weight draws (multinomial resampling)."""
        rng = np.random.default_rng(seed)
        idx = rng.choice(self.samples.shape[0], size=n, p=self._w())
        return self.samples[idx]


def reweight(
    result,
    new_log_prior,
    old_log_prior=None,
    *,
    max_samples: int = 200_000,
    device,
) -> WeightedPosterior:
    """Swap the prior of an ALREADY-SAMPLED posterior by importance
    reweighting — the standard "what if we adopt the Planck tau
    constraint?" workflow without rerunning the sampler: a chain drawn
    from ``L·π_old`` reweighted by ``w ∝ π_new/π_old`` targets
    ``L·π_new`` exactly (within the Kish-ESS budget).

    ``result``: a :class:`SampleResult` (or anything with ``.flat``),
    or a bare ``(N, n_params)`` array. ``new_log_prior`` /
    ``old_log_prior``: log-densities over raw parameters (e.g.
    :meth:`tpu21cmvae_torch.priors.GaussianBoxPrior.log_prior`), called
    on one float32 tensor of all rows on ``device``; ``None`` means
    flat. Arrays larger than ``max_samples`` rows are evenly thinned
    first. The weights come back as float64 NumPy.
    ALWAYS check :meth:`WeightedPosterior.ess` — a collapsed ESS means
    the new prior moved the posterior beyond the sampled cloud and the
    honest path is re-sampling with ``log_prior=new_log_prior``.
    """
    if isinstance(result, np.ndarray) or not hasattr(result, "chain"):
        # bare array (ndarray.flat is numpy's 1-D ITERATOR, not ours)
        flat = np.asarray(result, np.float32)
    else:
        flat = np.asarray(result.flat, np.float32)
    if flat.ndim != 2:
        raise ValueError(f"need (N, n_params) samples; got {flat.shape}")
    if flat.shape[0] > max_samples:
        flat = flat[:: int(np.ceil(flat.shape[0] / max_samples))]
    with torch.no_grad():
        x = torch.as_tensor(flat, device=device)
        logw = torch.zeros((flat.shape[0],), dtype=torch.float32, device=device)
        if new_log_prior is not None:
            logw = logw + new_log_prior(x)
        if old_log_prior is not None:
            logw = logw - old_log_prior(x)
    logw = logw.cpu().numpy().astype(np.float64)
    if not np.isfinite(logw).any():
        raise ValueError(
            "all importance weights are zero/non-finite: the new prior "
            "has no support on the sampled posterior"
        )
    logw = np.where(np.isfinite(logw), logw, -np.inf)
    return WeightedPosterior(samples=flat, logw=logw - logw.max())
