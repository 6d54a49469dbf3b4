"""Shared sampler helpers: prior box, walker init, thinning, the mesh
check, prior resolution, dual-averaging constants, the gradient
adapter and the routed likelihood that feeds it
(the parts of ``tpu21cmvae/sampling/_common.py`` that the ported
samplers need)."""

from __future__ import annotations

import math
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


def _refuse_mesh(mesh):
    """The samplers and fits take the JAX package's ``mesh=``: None or a
    one-device :class:`~tpu21cmvae_torch.parallel.mesh.Mesh` is the
    single-device no-op (as JAX's ``_shard_walkers`` is on one device);
    a larger mesh, or anything that is not a ``Mesh``, is refused."""
    if mesh is None:
        return
    from tpu21cmvae_torch.parallel.mesh import Mesh

    if isinstance(mesh, Mesh) and mesh.devices.size == 1:
        return
    raise NotImplementedError(
        "mesh= (walkers sharded over several devices) waits for the port of "
        "parallel/'s distributed half (torch.distributed); the port samples on one "
        "device: pass a one-device Mesh or none"
    )


def _resolve_log_prior(log_prior):
    """None → the flat box prior, ``(B, P) → (B,)`` zeros.

    A supplied ``log_prior`` must be a row-wise-independent log-density
    over RAW parameters, ``(B, P) tensor → (B,) tensor`` on the input's
    device, finite inside the prior box and, for HMC, differentiable by
    ``torch.autograd``; normalization optional (see
    :class:`tpu21cmvae_torch.priors.GaussianBoxPrior`). The samplers keep
    the box as a hard indicator on top of it.
    """
    if log_prior is None:
        return lambda x: torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    return log_prior


def _log_prior_val_grad(log_prior, x: torch.Tensor):
    """``(log π(x), ∇log π(x))`` row-wise, both detached: the gradient of
    the summed value on a detached leaf, valid because ``log_prior`` is
    required to be row-independent (the sum's gradient separates). A
    prior that does not depend on ``x`` has a zero gradient."""
    with torch.enable_grad():
        leaf = x.detach().requires_grad_(True)
        lpr = log_prior(leaf)
        g = None
        if lpr.requires_grad:
            (g,) = torch.autograd.grad(lpr.sum(), leaf, allow_unused=True)
    return lpr.detach(), torch.zeros_like(x) if g is None else g


def _dual_averaging_consts(init: float):
    """(mu, gamma, t0, kappa) — Hoffman & Gelman (2014) Alg. 5 defaults,
    shared by the HMC step and the MH proposal-scale adaptation."""
    return math.log(10.0 * init), 0.05, 10.0, 0.75


class RoutedLoglik:
    """A value likelihood ``(params, raw) → (B,)`` that also carries the
    routes of the same likelihood its consumers need besides the value:
    ``valgrad``, a value-and-gradient function (a K3 wrapper, which
    :func:`valgrad_from_loglik` takes in place of autograd), and
    ``plain``, a twice-differentiable plain version (a kernel's value
    has no second derivative; Laplace's Hessian needs one). Either may
    be None. ``DirectEmulator.log_evidence(method="laplace")`` builds
    one; a bare function behaves as one with neither."""

    def __init__(self, value, *, valgrad=None, plain=None):
        self.value, self.valgrad, self.plain = value, valgrad, plain

    def __call__(self, params, raw):
        return self.value(params, raw)


def valgrad_from_loglik(loglik):
    """``(params, raw) → (logL, ∇logL)`` over a VALUE likelihood: its
    ``valgrad`` route where it carries one (:class:`RoutedLoglik`), else
    autodiff (:func:`tpu21cmvae_torch.ops.loglik.per_row_grad`: a
    row-wise VJP with a ones cotangent, exact because the likelihood is
    row-independent, as in the JAX package). The gradient is with
    respect to ``raw``; both outputs are detached. (The JAX package
    caches the adapter on the likelihood for its compiled-program
    caches; eager PyTorch has none to keep.)"""
    from tpu21cmvae_torch.ops.loglik import per_row_grad

    routed = getattr(loglik, "valgrad", None)
    return per_row_grad(loglik) if routed is None else routed


def make_emcee_log_prob(loglik, params, bounds=None, *, device):
    """Adapter for external ensemble samplers (emcee et al.): a batched
    likelihood as a NumPy-in, NumPy-out log-probability with a flat box
    prior::

        sampler = emcee.EnsembleSampler(
            nwalkers, 7,
            make_emcee_log_prob(em.loglik_fn(obs, noise_var), em.params,
                                device=em.device),
            vectorize=True,   # one device call per ensemble move
        )

    Rows outside the box score ``-inf`` without touching the device (the
    emulator's log-transform is undefined for negative values there); the
    rows inside go to ``device`` as one float32 batch, scored under
    ``torch.no_grad()``. A 1-D ``coords`` returns a float. For chains
    that stay on the device prefer the port's own samplers."""
    lo, hi = _resolve_bounds(bounds, "cpu")
    lo_np, hi_np = lo.numpy(), hi.numpy()

    def log_prob(coords):
        arr = np.atleast_2d(np.asarray(coords, np.float32))
        inside = ((arr >= lo_np) & (arr <= hi_np)).all(axis=1)
        lp = np.full(arr.shape[0], -np.inf, np.float32)
        if inside.any():
            with torch.no_grad():
                x = torch.as_tensor(np.ascontiguousarray(arr[inside]), device=device)
                lp[inside] = loglik(params, x).cpu().numpy()
        return float(lp[0]) if np.ndim(coords) == 1 else lp

    return log_prob
