"""Normalizing-flow variational inference: posterior fits and
importance-sampled evidence for posteriors the Gaussian tools cannot
cover (curved ridges, skew) — the port of ``tpu21cmvae/flows.py``.

A RealNVP flow (Dinh et al. 2017) maps a standard normal ``z`` to the
sigmoid-whitened ``y`` space through a full-rank affine base (the ADVI
parameterization ``μ + (tril(A, −1) + diag(e^d))·z``) and a stack of
affine couplings whose log-scale and shift are one-hidden-layer tanh
networks of the frozen half of the coordinates. Its density ``log q(y) =
log N(z) − log|det ∂y/∂z|`` is exact in both directions.

The fit (:func:`fit_flow`) is reparameterized ELBO ascent: each step
draws ``n_mc`` normals, pushes them through the flow with its parameters
requiring gradients, takes the target's y-gradient from one call of the
first-order ``valgrad`` (on a CUDA model, one K3 launch) on the detached
draws, and pulls both that gradient and the log-determinant's back to
the parameters in one backward pass; then the same hand-written Adam as
ADVI and the MAP fits (:class:`tpu21cmvae_torch.sampling.fit.Adam`). By
default a 400-step ADVI fit seeds the base first (``warm_start``), so
the couplings only learn the bend. The evidence (:func:`flow_evidence`) is one value call on ``n_is`` flow
draws (on a CUDA model, one K2 launch at the contract tier from
``DirectEmulator.log_evidence(method="flow")``), Pareto-smoothed on the
host. The batched forms stack every flow's parameters on a leading
observation axis and make one stacked likelihood call per step.

The JAX package runs each fit as one ``lax.scan``; here it is a Python
loop whose tensors stay on the device. Every random is a standard normal
draw from a ``torch.Generator`` seeded with ``seed``, taken through
:func:`tpu21cmvae_torch.vi._normal` (one seam for a test to feed both
packages the same draws).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu21cmvae_torch import vi as _vi
from tpu21cmvae_torch.sampling._common import _resolve_bounds, _resolve_log_prior
from tpu21cmvae_torch.sampling.evidence import _prior_log_box_mean, _psis
from tpu21cmvae_torch.sampling.fit import Adam, cosine_rate
from tpu21cmvae_torch.sampling.gradient import _whitened_center, _whitened_vi_target
from tpu21cmvae_torch.vi import _row_centers, fit_advi, fit_advi_batch

__all__ = ["FlowResult", "FlowEvidenceResult", "fit_flow", "fit_flow_batch",
           "flow_evidence_batch", "evidence_with_flow_batch", "flow_evidence",
           "evidence_with_flow"]

#: the couplings' log-scales are s = CAP·tanh(raw/CAP): every layer's
#: expansion stays within e^±CAP, so a half-trained conditioner cannot
#: blow a draw out of float32 range
_SCALE_CAP = 3.0


def _masks(n_params: int, n_layers: int) -> np.ndarray:
    """Alternating-parity binary masks, one per coupling layer: ``m[i, j]
    = (j + i) % 2``, so consecutive layers freeze complementary halves."""
    j = np.arange(n_params)
    return np.stack([((j + i) % 2).astype(np.float32) for i in range(n_layers)])


class Coupling(nn.Module):
    """One coupling layer's conditioner weights ``w1`` (P, W), ``b1``
    (W,), ``w2`` (W, 2P), ``b2`` (2P,), each with an optional leading
    observation axis."""

    def __init__(self, w1, b1, w2, b2):
        super().__init__()
        self.w1, self.b1, self.w2, self.b2 = (nn.Parameter(t) for t in (w1, b1, w2, b2))


class RealNVP(nn.Module):
    """The flow: base parameters ``mu`` (P,), ``d`` (P,), ``a`` (P, P) and
    the couplings ``layers[i]`` (:class:`Coupling`), named after the JAX
    package's theta keys, with the mask stack as a buffer. Every
    parameter may carry a leading observation axis (``O`` stacked flows,
    :func:`fit_flow_batch`); then :meth:`forward` takes ``z`` (O, N, P).
    ``theta``: a dict of arrays or tensors in the JAX layout (``mu``,
    ``d``, ``a``, ``layers`` a list of dicts with ``w1``, ``b1``, ``w2``,
    ``b2``), so a JAX flow's theta (``tpu21cmvae.flows.FlowResult.theta``)
    builds the same flow here; ``masks`` default to :func:`_masks`."""

    def __init__(self, theta: dict, masks=None, *, device):
        super().__init__()

        def param(x):
            if isinstance(x, torch.Tensor):
                return x.detach().to(device=device, dtype=torch.float32).clone()
            return torch.as_tensor(np.array(x, np.float32), device=device)

        self.mu, self.d, self.a = (nn.Parameter(param(theta[k])) for k in ("mu", "d", "a"))
        self.layers = nn.ModuleList(
            Coupling(*(param(layer[k]) for k in ("w1", "b1", "w2", "b2")))
            for layer in theta["layers"])
        if masks is None:
            masks = _masks(self.mu.shape[-1], len(self.layers))
        self.register_buffer("masks", param(masks))

    def forward(self, z):
        return flow_forward(self, z)

    def inverse(self, y):
        return flow_inverse(self, y)

    def theta(self) -> dict:
        """The parameters as float32 NumPy arrays in the JAX layout."""
        def host(p):
            return p.detach().cpu().numpy()

        return {"mu": host(self.mu), "d": host(self.d), "a": host(self.a),
                "layers": [{k: host(getattr(layer, k)) for k in ("w1", "b1", "w2", "b2")}
                           for layer in self.layers]}


def init_flow(gen: torch.Generator, n_params: int, *, n_layers: int = 6, width: int = 64,
              mu0=None, d0: float = math.log(1.5), chol0=None) -> dict:
    """Flow parameters (a theta dict of tensors on ``gen``'s device) at
    the near-identity start: every coupling's output layer is zero, so
    the flow starts as its base Gaussian, by default the wide diagonal
    ADVI start (``σ = e^{d0}``), with ``chol0`` (a whitened-space
    lower-triangular Cholesky factor, e.g. ``ADVIResult.chol``) the
    matched full-rank Gaussian. ``w1`` is drawn from ``gen`` (one
    :func:`tpu21cmvae_torch.vi._normal` per layer) and scaled by 1/√P."""
    device = gen.device
    mu = (torch.zeros((n_params,), dtype=torch.float32, device=device) if mu0 is None
          else torch.as_tensor(mu0, dtype=torch.float32, device=device))
    if chol0 is not None:
        c = np.asarray(chol0, np.float64)
        d = torch.as_tensor(np.log(np.diag(c)).astype(np.float32), device=device)
        a = torch.as_tensor(np.tril(c, -1).astype(np.float32), device=device)
    else:
        d = torch.full((n_params,), d0, dtype=torch.float32, device=device)
        a = torch.zeros((n_params, n_params), dtype=torch.float32, device=device)
    layers = []
    for _ in range(n_layers):
        layers.append({
            "w1": _vi._normal(gen, (n_params, width)) * (1.0 / math.sqrt(n_params)),
            "b1": torch.zeros((width,), dtype=torch.float32, device=device),
            "w2": torch.zeros((width, 2 * n_params), dtype=torch.float32, device=device),
            "b2": torch.zeros((2 * n_params,), dtype=torch.float32, device=device),
        })
    return {"mu": mu, "d": d, "a": a, "layers": layers}


def _stack_thetas(thetas) -> dict:
    """Stack theta dicts on a leading observation axis."""
    return {
        **{k: torch.stack([th[k] for th in thetas]) for k in ("mu", "d", "a")},
        "layers": [{k: torch.stack([th["layers"][i][k] for th in thetas])
                    for k in ("w1", "b1", "w2", "b2")}
                   for i in range(len(thetas[0]["layers"]))],
    }


def _base_chol(flow):
    """The base Cholesky factor ``tril(a, −1) + diag(exp(d))``."""
    n = flow.d.shape[-1]
    tril = torch.tril(torch.ones((n, n), dtype=flow.a.dtype, device=flow.a.device), -1)
    return flow.a * tril + torch.diag_embed(torch.exp(flow.d))


def _coupling_st(layer, m, y):
    """The conditioner: the frozen half ``m·y`` → (log-scale, shift) for
    the moving half, through one tanh hidden layer; both are exactly 0 on
    the frozen half."""
    h = torch.tanh(torch.baddbmm(layer.b1.unsqueeze(-2), y * m, layer.w1) if y.dim() == 3
                   else torch.addmm(layer.b1, y * m, layer.w1))
    st = (torch.baddbmm(layer.b2.unsqueeze(-2), h, layer.w2) if y.dim() == 3
          else torch.addmm(layer.b2, h, layer.w2))
    n = y.shape[-1]
    s = _SCALE_CAP * torch.tanh(st[..., :n] / _SCALE_CAP)
    return s * (1.0 - m), st[..., n:] * (1.0 - m)


def flow_forward(flow, z):
    """``z (…, B, P) → (y (…, B, P), logdet (…, B))``: the base affine,
    then the coupling stack; differentiable in the flow's parameters.
    A coupling moves ``y → y·e^s + t``, which is the JAX package's ``y·m +
    (1 − m)·(y·e^s + t)`` exactly, since ``s`` and ``t`` vanish on the
    frozen half."""
    y = flow.mu.unsqueeze(-2) + z @ _base_chol(flow).transpose(-1, -2)
    logdet = torch.sum(flow.d, dim=-1).unsqueeze(-1).expand(z.shape[:-1])
    for layer, m in zip(flow.layers, flow.masks):
        s, t = _coupling_st(layer, m, y)
        y = y * torch.exp(s) + t
        logdet = logdet + torch.sum(s, dim=-1)
    return y, logdet


def flow_inverse(flow, y):
    """``y (…, B, P) → (z (…, B, P), logdet (…, B))`` with the same logdet
    convention as :func:`flow_forward` (``log|det ∂y/∂z|``), so ``log
    q(y) = log N(z) − logdet`` either way; the base by a triangular
    solve."""
    logdet = torch.zeros(y.shape[:-1], dtype=y.dtype, device=y.device)
    for layer, m in zip(reversed(flow.layers), reversed(flow.masks)):
        s, t = _coupling_st(layer, m, y)
        y = (y - t) * torch.exp(-s)
        logdet = logdet + torch.sum(s, dim=-1)
    z = torch.linalg.solve_triangular(
        _base_chol(flow), (y - flow.mu.unsqueeze(-2)).transpose(-1, -2), upper=False,
    ).transpose(-1, -2)
    return z, logdet + torch.sum(flow.d, dim=-1).unsqueeze(-1)


def _base_logpdf(z):
    return -0.5 * torch.sum(z * z, dim=-1) - 0.5 * z.shape[-1] * math.log(2.0 * math.pi)


@dataclasses.dataclass
class FlowResult:
    """Fitted normalizing-flow posterior approximation from
    :func:`fit_flow`.

    ``flow``: the :class:`RealNVP` on its device; ``elbo``: the per-step
    ELBO (base entropy included; a flat tail means converged). In raw
    parameter units: :meth:`sample`, :meth:`mean` / :meth:`std`;
    :meth:`log_q` is the exact whitened-space density the importance
    sampling needs. ``theta`` and ``masks`` read the flow back as NumPy
    in the JAX package's layout."""

    flow: RealNVP
    elbo: np.ndarray
    _lo: np.ndarray
    _hi: np.ndarray

    @classmethod
    def from_theta(cls, theta: dict, *, lo, hi, masks=None, elbo=None,
                   device) -> "FlowResult":
        """A result around a JAX flow ``theta`` (see :class:`RealNVP`)
        fitted in the box ``[lo, hi]``."""
        return cls(flow=RealNVP(theta, masks, device=device),
                   elbo=np.zeros(0, np.float32) if elbo is None else np.asarray(elbo),
                   _lo=np.asarray(lo, np.float64), _hi=np.asarray(hi, np.float64))

    @property
    def theta(self) -> dict:
        return self.flow.theta()

    @property
    def masks(self) -> np.ndarray:
        return self.flow.masks.cpu().numpy()

    @torch.no_grad()
    def sample_y(self, n: int, seed: int = 0) -> torch.Tensor:
        """``n`` iid draws in the whitened ``y`` space (a tensor on the
        flow's device)."""
        gen = torch.Generator(device=self.flow.mu.device).manual_seed(seed)
        y, _ = self.flow(_vi._normal(gen, (n, self.flow.mu.shape[-1])))
        return y

    def sample(self, n: int, seed: int = 0) -> np.ndarray:
        """``n`` iid raw-parameter draws from the fitted posterior."""
        y = self.sample_y(n, seed).cpu().numpy().astype(np.float64)
        s = np.exp(-np.logaddexp(0.0, -y))  # overflow-safe sigmoid
        return (self._lo + (self._hi - self._lo) * s).astype(np.float32)

    @torch.no_grad()
    def log_q(self, y) -> np.ndarray:
        """The flow's exact log-density of whitened rows ``y (B, P)``."""
        y = torch.as_tensor(np.asarray(y, np.float32), device=self.flow.mu.device)
        z, ld = self.flow.inverse(y)
        return (_base_logpdf(z) - ld).cpu().numpy()

    def mean(self, n: int = 65536, seed: int = 0) -> np.ndarray:
        return self.sample(n, seed).mean(0)

    def std(self, n: int = 65536, seed: int = 0) -> np.ndarray:
        return self.sample(n, seed).std(0)


def flow_step(flow, integrand, params, adam, t: int, z, *, n_steps: int,
              learning_rate: float):
    """One ELBO-ascent step from the normal draws ``z`` ((n_mc, P), or (O,
    n_mc, P) for a stacked flow): ``y, logdet = flow(z)`` with the
    parameters requiring gradients, the target's y-gradient from one
    ``integrand`` call on the detached draws (non-finite entries counted
    as zero), one backward of ``Σ g_y·y / n_mc + Σ_o mean(logdet)``, then
    ``adam`` (a :class:`~tpu21cmvae_torch.sampling.fit.Adam` over the
    flow's parameters) in place. Returns the step's ELBO, () or (O,)."""
    p = z.shape[-1]
    n_mc = z.shape[-2]
    with torch.enable_grad():
        y, logdet = flow(z)
        with torch.no_grad():
            f, g_y = integrand(params, y.detach().reshape(-1, p))
        f = f.reshape(z.shape[:-1])
        g_y = torch.where(torch.isfinite(g_y), g_y, 0.0).reshape(z.shape)
        # ∂/∂θ E[f(y) + logdet]: one backward carries the integrand's
        # cotangent and the log-determinant's (the entropy's ascent)
        objective = torch.sum(g_y * y) / n_mc + torch.sum(torch.mean(logdet, dim=-1))
        grads = torch.autograd.grad(objective, adam.params)
    h_base = 0.5 * p * math.log(2.0 * math.pi * math.e)  # the base's entropy
    elbo = f.mean(dim=-1) + logdet.detach().mean(dim=-1) + h_base
    with torch.no_grad():
        adam.step(grads, t, cosine_rate(learning_rate, t, n_steps))
    return elbo


def run_flow_fit(flow, integrand, params, *, n_steps: int, learning_rate: float, draw):
    """``n_steps`` ELBO-ascent steps of ``flow`` in place; ``draw(t)``
    gives step ``t``'s normal draws. Returns the ELBO trace, (n_steps,)
    or (n_steps, O), on the flow's device."""
    adam = Adam(flow.parameters())
    lead = flow.mu.shape[:-1]
    elbo = torch.empty((n_steps, *lead), dtype=torch.float32, device=flow.mu.device)
    for t in range(1, n_steps + 1):
        elbo[t - 1] = flow_step(flow, integrand, params, adam, t, draw(t),
                                n_steps=n_steps, learning_rate=learning_rate)
    return elbo


def fit_flow(
    valgrad,
    params,
    *,
    n_steps: int = 1500,
    n_mc: int = 256,
    n_layers: int = 6,
    width: int = 64,
    bounds=None,
    learning_rate: float = 3e-3,
    seed: int = 0,
    x0=None,
    log_prior=None,
    warm_start: bool = True,
    warm_steps: int = 400,
    device,
) -> FlowResult:
    """Fit a RealNVP flow to the posterior by reparameterized ELBO ascent:
    :func:`tpu21cmvae_torch.vi.fit_advi`'s upgrade for curved or skewed
    posteriors.

    ``valgrad(params, raw) → (logL, ∇logL)``: the value+gradient function
    (``model.loglik_and_grad_fn``; K3 on a CUDA model), called once per
    step. ``x0``: an optional raw-space center for the base. ``log_prior``:
    an optional smooth prior added to the target. ``warm_start`` (default
    True) seeds the base from a ``warm_steps``-step
    :func:`~tpu21cmvae_torch.vi.fit_advi` (the same ``seed``, ``n_mc``,
    ``x0`` and prior), which the JAX package measured load-bearing on
    sharp posteriors; the fit then makes ``warm_steps + n_steps``
    likelihood calls. The couplings' first weights and the fit's draws
    come from a ``torch.Generator`` on ``device`` seeded with ``seed``.
    Check ``FlowResult.elbo``: a climbing tail means raise ``n_steps``."""
    device = torch.empty(0, device=device).device
    lo, hi = _resolve_bounds(bounds, device)
    p = int(lo.shape[0])
    lo_np, hi_np = lo.cpu().numpy(), hi.cpu().numpy()
    mu0 = None if x0 is None else _whitened_center(x0, lo_np, hi_np, device)
    chol0 = None
    if warm_start:
        adv = fit_advi(valgrad, params, n_steps=warm_steps, n_mc=n_mc, bounds=bounds,
                       seed=seed, x0=x0, log_prior=log_prior, device=device)
        mu0, chol0 = torch.as_tensor(adv.mu, device=device), adv.chol
    gen = torch.Generator(device=device).manual_seed(seed)
    flow = RealNVP(init_flow(gen, p, n_layers=n_layers, width=width, mu0=mu0, chol0=chol0),
                   device=device)
    integrand = _whitened_vi_target(valgrad, lo, hi - lo, log_prior, span_jac=False)
    elbo = run_flow_fit(flow, integrand, params, n_steps=n_steps, learning_rate=learning_rate,
                        draw=lambda t: _vi._normal(gen, (n_mc, p)))
    return FlowResult(flow=flow, elbo=elbo.cpu().numpy(), _lo=lo_np.astype(np.float64),
                      _hi=hi_np.astype(np.float64))


@dataclasses.dataclass
class FlowEvidenceResult:
    """Flow-proposal importance-sampled evidence from
    :func:`flow_evidence`.

    ``logz`` / ``logz_err``: the evidence under the box-normalized prior
    and its MC error; ``khat``: the PSIS tail index (below 0.7 the flow
    covers the posterior; above, refit it or use nested sampling);
    ``is_ess``: the Kish effective sample size of the weights.
    :meth:`posterior` importance-resamples raw-parameter draws; ``flow``:
    the proposal (set by :func:`evidence_with_flow`)."""

    logz: float
    logz_err: float
    khat: float
    is_ess: float
    n_draws: int
    _x: np.ndarray
    _logw: np.ndarray
    flow: Optional[FlowResult] = None

    def posterior(self, n: int, seed: int = 0) -> np.ndarray:
        w = np.exp(self._logw - self._logw.max())
        w /= w.sum()
        idx = np.random.default_rng(seed).choice(self._x.shape[0], size=n, p=w)
        return self._x[idx]

    def summary(self) -> str:
        return (
            f"log Z = {self.logz:.2f} ± {self.logz_err:.2f} "
            f"(flow-IS, {self.n_draws} draws, "
            f"ESS {self.is_ess:.0f}, khat {self.khat:.2f})"
        )


def _check_box(flows, lo, hi):
    lo64, hi64 = lo.cpu().numpy().astype(np.float64), hi.cpu().numpy().astype(np.float64)
    for fl in flows:
        if not (np.array_equal(lo64, fl._lo) and np.array_equal(hi64, fl._hi)):
            raise ValueError(
                "bounds do not match the box the flow was fitted in "
                f"(fit lo={fl._lo.tolist()} hi={fl._hi.tolist()}); "
                "pass the same bounds= used for fit_flow, or refit")


@torch.no_grad()
def flow_is_weights(flow, loglik, params, lo, hi, log_prior, z):
    """The importance weights of the flow draws from normals ``z`` ((n, P),
    or (O, n, P) for a stacked flow with a stacked ``loglik``): the
    whitened target ``logL (+ log π) + Σ log σ'(y)`` minus the flow's
    exact ``log q``, and the raw draws. One ``loglik`` call."""
    p = z.shape[-1]
    y, logdet = flow(z)
    logq = _base_logpdf(z) - logdet
    xr = lo + (hi - lo) * torch.clamp(torch.sigmoid(y), 1e-7, 1.0 - 1e-7)
    ll = loglik(params, xr.reshape(-1, p))
    if log_prior is not None:
        ll = ll + _resolve_log_prior(log_prior)(xr.reshape(-1, p))
    yf = y.reshape(-1, p)
    g = ll + torch.sum(F.logsigmoid(yf) + F.logsigmoid(-yf), dim=-1)
    return g.reshape(z.shape[:-1]) - logq, xr


def _flow_evidence_result(logw, xr, prior_lbm: float) -> FlowEvidenceResult:
    """Pareto-smooth one flow's weights (float64, host) and reduce them."""
    logw = np.asarray(logw, np.float64)
    logw, khat = _psis(np.where(np.isfinite(logw), logw, -np.inf))
    m = logw.max()
    w = np.exp(logw - m)
    mean_w = float(w.mean())
    return FlowEvidenceResult(
        logz=float(m + np.log(mean_w)) - prior_lbm,
        logz_err=float(w.std(ddof=1) / (np.sqrt(float(w.size)) * mean_w)),
        khat=float(khat),
        is_ess=float(w.sum() ** 2 / (w * w).sum()),
        n_draws=int(logw.shape[0]),
        _x=np.asarray(xr, np.float32),
        _logw=logw,
    )


def flow_evidence(
    loglik,
    params,
    flow: FlowResult,
    *,
    n_is: int = 16384,
    bounds=None,
    seed: int = 0,
    log_prior=None,
) -> FlowEvidenceResult:
    """Importance-sampled ``log Z`` with a fitted flow as the proposal,
    on the flow's device: ``n_is`` flow draws (from a ``torch.Generator``
    seeded with ``seed``) scored by ONE ``loglik`` call against the
    whitened target, the weights Pareto-smoothed (PSIS) and reduced under
    the box-normalized-prior convention. ``bounds`` and ``log_prior``
    must be the fit's; a box other than the fit's raises."""
    device = flow.flow.mu.device
    lo, hi = _resolve_bounds(bounds, device)
    _check_box([flow], lo, hi)
    prior_lbm = _prior_log_box_mean(log_prior, lo, hi)
    gen = torch.Generator(device=device).manual_seed(seed)
    z = _vi._normal(gen, (n_is, int(lo.shape[0])))
    logw, xr = flow_is_weights(flow.flow, loglik, params, lo, hi, log_prior, z)
    return _flow_evidence_result(logw.cpu().numpy(), xr.cpu().numpy(), prior_lbm)


def evidence_with_flow(
    loglik,
    valgrad,
    params,
    *,
    bounds=None,
    n_is: int = 16384,
    seed: int = 0,
    log_prior=None,
    flow: Optional[FlowResult] = None,
    device,
    **fit_kwargs,
) -> FlowEvidenceResult:
    """The ``method="flow"`` evidence: fit a flow on the value+gradient
    function (:func:`fit_flow`, seeded ``seed``), then importance-sample
    the evidence through it with the VALUE function
    (:func:`flow_evidence`, seeded ``seed + 1``). ``flow=`` reuses a fit
    (then fit kwargs are refused); the result carries its proposal in
    ``.flow``."""
    if flow is None:
        flow = fit_flow(valgrad, params, bounds=bounds, seed=seed, log_prior=log_prior,
                        device=device, **fit_kwargs)
    elif fit_kwargs:
        raise ValueError(
            "fit kwargs and a prefitted flow= are mutually exclusive; "
            f"got both (kwargs {sorted(fit_kwargs)})")
    res = flow_evidence(loglik, params, flow, bounds=bounds, n_is=n_is, seed=seed + 1,
                        log_prior=log_prior)
    res.flow = flow
    return res


def _split(flow: RealNVP, elbo, lo, hi) -> list:
    """One :class:`FlowResult` per row of a stacked flow."""
    theta, masks = flow.theta(), flow.masks
    device = flow.mu.device
    out = []
    for o in range(theta["mu"].shape[0]):
        row = {**{k: theta[k][o] for k in ("mu", "d", "a")},
               "layers": [{k: layer[k][o] for k in layer} for layer in theta["layers"]]}
        out.append(FlowResult(flow=RealNVP(row, masks, device=device), elbo=elbo[:, o],
                              _lo=lo, _hi=hi))
    return out


def fit_flow_batch(
    valgrad_multi,
    params,
    n_obs: int,
    *,
    n_steps: int = 1500,
    n_mc: int = 256,
    n_layers: int = 6,
    width: int = 64,
    bounds=None,
    learning_rate: float = 3e-3,
    seed: int = 0,
    x0=None,
    log_prior=None,
    warm_start: bool = True,
    warm_steps: int = 400,
    device,
) -> list:
    """Batched :func:`fit_flow`: ``n_obs`` independent flows, one per
    observation of a stacked likelihood ``valgrad_multi(params, raw
    (O·W, P)) → ((O·W,), (O·W, P))``, their parameters stacked on a
    leading axis, every step ONE observation-major ``(n_obs·n_mc)``-row
    call and one backward (the rows are independent, so the stacked
    Jacobian is block-diagonal). ``x0``: optional ``(n_obs, P)`` raw-space
    centers; ``warm_start`` seeds every base from
    :func:`~tpu21cmvae_torch.vi.fit_advi_batch`. Returns ``n_obs``
    :class:`FlowResult`, ordered like the observations."""
    device = torch.empty(0, device=device).device
    lo, hi = _resolve_bounds(bounds, device)
    p = int(lo.shape[0])
    lo_np, hi_np = lo.cpu().numpy(), hi.cpu().numpy()
    mu0 = chol0 = None
    if x0 is not None:
        centers = _row_centers(x0, n_obs, lo_np, hi_np)
    if warm_start:
        adv = fit_advi_batch(valgrad_multi, params, n_obs, n_steps=warm_steps, n_mc=n_mc,
                             bounds=bounds, seed=seed, x0=x0, log_prior=log_prior,
                             device=device)
        mu0 = np.stack([r.mu for r in adv])
        chol0 = np.stack([r.chol for r in adv])
    elif x0 is not None:
        mu0 = centers.astype(np.float32)
    gen = torch.Generator(device=device).manual_seed(seed)
    thetas = [init_flow(gen, p, n_layers=n_layers, width=width,
                        mu0=None if mu0 is None else mu0[o],
                        chol0=None if chol0 is None else chol0[o])
              for o in range(n_obs)]
    flow = RealNVP(_stack_thetas(thetas), device=device)
    integrand = _whitened_vi_target(valgrad_multi, lo, hi - lo, log_prior, span_jac=False)
    elbo = run_flow_fit(flow, integrand, params, n_steps=n_steps, learning_rate=learning_rate,
                        draw=lambda t: _vi._normal(gen, (n_obs, n_mc, p)))
    return _split(flow, elbo.cpu().numpy(), lo_np.astype(np.float64), hi_np.astype(np.float64))


def flow_evidence_batch(
    loglik_multi,
    params,
    flows,
    *,
    n_is: int = 16384,
    bounds=None,
    seed: int = 0,
    log_prior=None,
) -> list:
    """Batched :func:`flow_evidence`: every flow's ``n_is`` draws scored by
    ONE stacked-likelihood call (observation-major rows), each row
    Pareto-smoothed on the host. ``flows``: ``n_obs`` :class:`FlowResult`
    of one architecture (one mask stack), on one device. Returns
    ``n_obs`` :class:`FlowEvidenceResult`."""
    device = flows[0].flow.mu.device
    lo, hi = _resolve_bounds(bounds, device)
    _check_box(flows, lo, hi)
    masks = flows[0].masks
    for fl in flows:
        if not np.array_equal(fl.masks, masks):
            raise ValueError(
                "flow_evidence_batch needs one shared architecture; got differing mask stacks")
    prior_lbm = _prior_log_box_mean(log_prior, lo, hi)
    stacked = RealNVP(_stack_thetas([
        {**{k: getattr(fl.flow, k) for k in ("mu", "d", "a")},
         "layers": [{k: getattr(layer, k) for k in ("w1", "b1", "w2", "b2")}
                    for layer in fl.flow.layers]}
        for fl in flows]), masks, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    z = _vi._normal(gen, (len(flows), n_is, int(lo.shape[0])))
    logw, xr = flow_is_weights(stacked, loglik_multi, params, lo, hi, log_prior, z)
    logw, xr = logw.cpu().numpy(), xr.cpu().numpy()
    return [_flow_evidence_result(logw[o], xr[o], prior_lbm) for o in range(len(flows))]


def evidence_with_flow_batch(
    loglik_multi,
    valgrad_multi,
    params,
    n_obs: int,
    *,
    bounds=None,
    n_is: int = 16384,
    seed: int = 0,
    log_prior=None,
    device,
    **fit_kwargs,
) -> list:
    """Batched :func:`evidence_with_flow`: ``n_obs`` flows fitted together
    (:func:`fit_flow_batch`, seeded ``seed``), then every evidence in one
    stacked sweep (:func:`flow_evidence_batch`, seeded ``seed + 1``); each
    result carries its flow in ``.flow``."""
    flows = fit_flow_batch(valgrad_multi, params, n_obs, bounds=bounds, seed=seed,
                           log_prior=log_prior, device=device, **fit_kwargs)
    out = flow_evidence_batch(loglik_multi, params, flows, bounds=bounds, n_is=n_is,
                              seed=seed + 1, log_prior=log_prior)
    for r, fl in zip(out, flows):
        r.flow = fl
    return out
