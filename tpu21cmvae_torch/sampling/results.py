"""Sampler result container and convergence diagnostics
(:class:`SampleResult`) — a NumPy/SciPy copy of
``tpu21cmvae/sampling/results.py``.

Diagnostics implement Vehtari, Gelman, Simpson, Carpenter & Bürkner
2021 ("Rank-normalization, folding, and localization: an improved R̂")
in full: :meth:`SampleResult.rhat` is the rank-normalized split-R̂
max-combined with the folded variant (§4.1-4.2 — the paper's headline
fix over plain split-R̂, which reads clean whenever chains agree in
mean and variance even if their TAILS differ), :meth:`SampleResult.ess`
is the rank-normalized bulk ESS using the combined multi-chain
autocorrelation estimator (§3.2 eq. 10 — between-chain variance
included, so unmixed chains cannot fake a large ESS), and
:meth:`SampleResult.ess_tail` is the 5 %/95 % quantile-indicator ESS
(§4.3) that this domain's own heavy-tailed posteriors (see the PSIS
khat machinery of the JAX package) make load-bearing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def _rank_normal(x: np.ndarray) -> np.ndarray:
    """Pooled average-tie fractional ranks → normal scores
    ``Φ⁻¹((r − 3/8)/(S + 1/4))`` (Vehtari et al. 2021 eq. 14, the Blom
    offset). ``x`` is one parameter's draws, any shape; ranks pool over
    ALL draws so chains stay comparable."""
    from scipy.special import ndtri
    from scipy.stats import rankdata

    r = rankdata(x, method="average", axis=None).reshape(x.shape)
    return ndtri((r - 0.375) / (x.size + 0.25))


def _split_rhat(c: np.ndarray) -> np.ndarray:
    """Split-R̂ per parameter of ``(n, m, p)`` draws (Gelman–Rubin with
    split chains; Vehtari et al. 2021 eq. 4)."""
    n = c.shape[0]
    half = n // 2
    # (2·m) split chains × half steps × p
    c = np.concatenate([c[:half], c[half: 2 * half]], axis=1)
    m = c.mean(axis=0)  # per-chain mean
    w = c.var(axis=0, ddof=1).mean(axis=0)  # within-chain
    b = half * m.var(axis=0, ddof=1)  # between-chain
    var_plus = (half - 1) / half * w + b / half
    return np.sqrt(var_plus / np.maximum(w, 1e-300))


def _ess_core(c: np.ndarray) -> np.ndarray:
    """Per-parameter ESS of ``(n, m, p)`` draws with the combined
    multi-chain autocorrelation estimator (Vehtari et al. 2021 §3.2):
    ``ρ̂_t = 1 − (W − s̄_t)/var⁺`` so between-chain disagreement counts
    against the ESS, Geyer initial-positive-sequence truncation with the
    monotone adjustment, and ``τ`` floored at 1 (this estimator never
    claims super-efficiency, keeping ESS ≤ n·m). Zero-variance series
    (e.g. a tail indicator no chain ever toggles) return NaN."""
    n, m, p = c.shape
    W = c.var(axis=0, ddof=1).mean(axis=0)
    chain_means = c.mean(axis=0)
    b_over_n = (chain_means.var(axis=0, ddof=1) if m > 1
                else np.zeros(p))
    var_plus = (n - 1) / n * W + b_over_n
    x = c - chain_means[None]
    out = np.empty(p)
    for j in range(p):
        if not (W[j] > 0 and var_plus[j] > 0):
            out[j] = np.nan
            continue
        # per-chain biased autocovariance via FFT, averaged over chains
        f = np.fft.rfft(x[:, :, j], n=2 * n, axis=0)
        s = np.fft.irfft(f * np.conj(f), axis=0)[:n].mean(axis=1) / n
        rho = 1.0 - (W[j] - s) / var_plus[j]
        # Geyer: τ = −1 + 2·Σ_k P_k over pair sums P_k = ρ_{2k}+ρ_{2k+1},
        # truncated at the first non-positive pair and forced monotone
        # non-increasing
        tau = -1.0
        prev = np.inf
        for t in range(0, n - 1, 2):
            pair = rho[t] + rho[t + 1]
            if pair <= 0:
                break
            pair = min(pair, prev)
            prev = pair
            tau += 2.0 * pair
        out[j] = n * m / max(tau, 1.0)
    return out


@dataclasses.dataclass
class SampleResult:
    """Posterior samples and diagnostics from one sampler run.

    ``chain``: thinned post-warmup samples, shape
    ``(n_kept, n_walkers, n_params)`` in RAW parameter units (empty
    first axis when ``thin=0`` — final state only). ``final``: the last
    walker positions ``(n_walkers, n_params)``. ``logp``: final
    log-posterior per walker. ``accept_rate``: per-step mean acceptance
    over the sampling phase. ``step_size``: the (adapted) HMC step, or
    the MH proposal scale — the mean over adaptation blocks when
    ``adapt_blocks > 1``, with the per-block values in
    ``block_step_sizes`` (shape ``(adapt_blocks,)``; ``None`` for
    samplers without block adaptation).
    """

    chain: np.ndarray
    final: np.ndarray
    logp: np.ndarray
    accept_rate: np.ndarray
    step_size: float
    block_step_sizes: Optional[np.ndarray] = None

    @property
    def flat(self) -> np.ndarray:
        """Chain flattened to ``(n_kept · n_walkers, n_params)``."""
        return self.chain.reshape(-1, self.chain.shape[-1])

    def _checked_chain(self, what: str) -> np.ndarray:
        n = self.chain.shape[0]
        if n < 4:
            raise ValueError(
                f"{what} needs >= 4 kept steps, have {n}; run with thin > 0"
            )
        return self.chain.astype(np.float64)

    def rhat(self, rank_normalized: bool = True) -> np.ndarray:
        """Rank-normalized split-R̂ per parameter, max-combined with the
        folded variant (Vehtari et al. 2021 §4.1-4.2), treating each
        walker as a chain. Rank normalization is the paper's headline
        fix: plain split-R̂ compares chain means and variances only, so
        chains that agree there but differ in their TAILS read clean —
        the folded statistic (ranks of ``|θ − median|``) catches exactly
        that. ``rank_normalized=False`` gives the plain eq.-4 statistic.
        Values near 1 indicate mixing; needs ≥ 4 kept steps
        (``thin > 0``)."""
        c = self._checked_chain("rhat")
        if not rank_normalized:
            return _split_rhat(c)
        z = np.empty_like(c)
        zf = np.empty_like(c)
        folded = np.abs(c - np.median(c, axis=(0, 1), keepdims=True))
        for j in range(c.shape[-1]):
            z[:, :, j] = _rank_normal(c[:, :, j])
            zf[:, :, j] = _rank_normal(folded[:, :, j])
        return np.maximum(_split_rhat(z), _split_rhat(zf))

    def ess(self, rank_normalized: bool = True) -> np.ndarray:
        """Bulk effective sample size per parameter across all walkers
        (Vehtari et al. 2021 §3.2/§4.2): the combined multi-chain
        autocorrelation estimator — between-chain variance enters
        ``var⁺``, so unmixed walkers cannot fake a large ESS — on
        rank-normalized draws (``rank_normalized=False`` for raw
        draws). Autocorrelation is measured at the thinned cadence, so
        this is the ESS of the RETURNED samples. Bulk ESS describes
        center-of-mass convergence only; pair it with
        :meth:`ess_tail` before trusting credible-interval endpoints."""
        c = self._checked_chain("ess")
        if rank_normalized:
            z = np.empty_like(c)
            for j in range(c.shape[-1]):
                z[:, :, j] = _rank_normal(c[:, :, j])
            c = z
        return _ess_core(c)

    def ess_tail(self, quantiles=(0.05, 0.95)) -> np.ndarray:
        """Tail effective sample size per parameter (Vehtari et al.
        2021 §4.3): the minimum over ``quantiles`` of the ESS of the
        indicator series ``I(θ ≤ Q_q)`` (pooled quantile). This is the
        sample size backing tail-quantile estimates — heavy-tailed or
        tail-unmixed chains read low here while bulk ESS looks clean
        (this stack's PSIS khat diagnostics show such posteriors occur
        in this domain). NaN when no chain ever toggles an indicator
        (far too few draws to say anything about that tail)."""
        c = self._checked_chain("ess_tail")
        per_q = []
        for q in quantiles:
            thresh = np.quantile(c, q, axis=(0, 1), keepdims=True)
            per_q.append(_ess_core((c <= thresh).astype(np.float64)))
        return np.minimum.reduce(per_q)

    def autocorr_time(self) -> np.ndarray:
        """Integrated autocorrelation time per parameter, in units of
        STORED (thinned) steps — emcee's ``get_autocorr_time``
        convention, derived from the same Geyer-truncated estimate as
        :meth:`ess` (``τ = kept_steps · n_walkers / ESS``; multiply by
        ``thin`` for raw chain steps). Rule of thumb: trust moments
        once the stored chain is ≳ 50·τ long."""
        n, n_walkers, _ = self.chain.shape
        return n * n_walkers / self.ess()

    def summary(self, labels=None) -> str:
        samples = self.flat if self.chain.size else self.final
        mean, std = samples.mean(0), samples.std(0)
        labels = labels or [f"p{i}" for i in range(samples.shape[-1])]
        lines = [
            f"  {l:>8}: {m:12.5g} ± {s:10.4g}"
            for l, m, s in zip(labels, mean, std)
        ]
        return (
            f"accept rate {float(np.mean(self.accept_rate)):.2f}, "
            f"step {self.step_size:.3g}\n" + "\n".join(lines)
        )
