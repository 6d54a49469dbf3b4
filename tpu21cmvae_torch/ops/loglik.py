"""Gaussian log-likelihood of an observed signal under the emulator, and
its per-row gradient (the port of ``tpu21cmvae/ops/loglik.py``).

``logL(θ) = −½·Σ_bins (emulate(θ) − obs)²/σ²`` per row of raw parameter
draws. Two backends:

* ``"torch"`` (the JAX package's ``"xla"``) — plain tensor operations;
* ``"kernel"`` (its ``"pallas"``) — the value and gradient as one CUDA
  kernel, K3 (:mod:`tpu21cmvae_torch.ops.kernels.fused_loglik`). The
  value-only kernels (K1 for ``method="direct"``, K2 for ``"gram"``) are
  not ported yet.

Noise is diagonal only: a scalar or per-bin variance σ².
"""

from __future__ import annotations

import numpy as np
import torch

from tpu21cmvae_torch.ops.fold import (
    _log_clamp,
    gram_fold,
    noise_log_norm,
    noise_scale,
    obs_tensor,
    prepare_operand,
    resolve_tier,
    tier_matmul,
)
from tpu21cmvae_torch.ops.kernels.fused_loglik import (
    gram_operands,
    loglik_grad_gram_reference,
    make_fused_loglik_grad_gram,
)
from tpu21cmvae_torch.ops.mlp import (
    SKINNY_DENSE_MAX_IN,
    mlp_apply,
    resolve_activation,
    skinny_dense,
)
from tpu21cmvae_torch.ops.transforms import par_transform, unpreproc


def _rows(raw, device) -> torch.Tensor:
    return torch.atleast_2d(torch.as_tensor(raw, dtype=torch.float32, device=device))


def make_loglik(config, norm, obs, noise_var=1.0, *, backend: str = "torch",
                method: str = "direct", precision=None):
    """Build ``fn(params, raw) → (B,)`` Gaussian log-likelihoods; a 1-D
    ``raw`` scores as one row.

    ``method="direct"`` evaluates the full network and reduces the
    residual; ``method="gram"`` collapses the output layer into the
    quadratic form of :func:`~tpu21cmvae_torch.ops.fold.gram_fold` (the
    451-wide output never exists), at the price of cancellation near the
    posterior mode. ``precision`` (default ``"high"``) tiers the
    non-skinny matmuls; ``"contract"``/``"highest"`` is exact fp32.
    """
    if method not in ("direct", "gram"):
        raise ValueError(f"method must be 'direct' or 'gram'; got {method!r}")
    if backend == "kernel":
        raise NotImplementedError(
            "the value-only kernels K1 (method='direct') and K2 "
            "(method='gram') are not ported yet (ROADMAP queue 2); use "
            "backend='torch', or make_loglik_and_grad(backend='kernel')"
        )
    if backend != "torch":
        raise ValueError(f"backend must be 'torch' or 'kernel'; got {backend!r}")
    tier = resolve_tier(precision, "high")
    device = norm.device
    obs = obs_tensor(obs, config.n_bins, device=device)
    log_norm = noise_log_norm(noise_var)
    act = resolve_activation(config.activation)

    if method == "gram":
        scale = noise_scale(noise_var, config.n_bins, device=device)

        def loglik_gram(params, raw):
            trunk, G, u, c = gram_fold(params, norm, obs, scale)
            h = _log_clamp(_rows(raw, device))
            for i, layer in enumerate(trunk):  # trunk layers are hidden
                if i == 0 and layer["w"].shape[0] <= SKINNY_DENSE_MAX_IN:
                    h = skinny_dense(h, layer["w"], layer["b"])
                else:
                    h = tier_matmul(h, prepare_operand(layer["w"], tier), tier) + layer["b"]
                h = act(h)
            g = tier_matmul(h, prepare_operand(G, tier), tier)
            return -0.5 * (torch.sum((g + 2.0 * u) * h, dim=-1) + c) + log_norm

        return loglik_gram

    noise_scale(noise_var, config.n_bins, device=device)  # validates the spec
    inv_var = 1.0 / torch.as_tensor(
        np.asarray(noise_var, np.float32), device=device
    )

    def loglik(params, raw):
        x = par_transform(_rows(raw, device), norm)
        pred = unpreproc(mlp_apply(params, x, config.activation, precision or "high"), norm)
        return -0.5 * torch.sum((pred - obs) ** 2 * inv_var, dim=-1) + log_norm

    return loglik


def make_loglik_and_grad(config, norm, obs, noise_var=1.0, *,
                         backend: str = "torch", method: str = "gram",
                         variant=None, precision=None, grad_precision=None):
    """Build ``fn(params, raw) → (logL (B,), dlogL/draw (B, n_params))``
    — the gradient-based sampler's inner loop. The gradient is with
    respect to the RAW parameters.

    * ``backend="torch", variant="autodiff"`` — ``torch.autograd``
      through :func:`make_loglik` (one backward; each row's value
      depends only on its own row, so the ones-cotangent VJP is the
      per-row gradient);
    * ``backend="torch", method="gram", variant="analytic"`` (default) —
      the hand-written backward: ReLU masks, transposed-weight products
      at ``grad_precision``, the gram head's gradient reusing ``h@G``,
      the first layer's backward exact;
    * ``backend="kernel", method="gram"`` — the same as one CUDA kernel
      (K3), which runs its plain version for CPU tensors.

    ``precision`` (default ``"high"``) tiers the value, ``grad_precision``
    (default: the same) the backward; a cheaper backward only costs HMC
    acceptance rate, never the posterior.
    """
    if variant is None:
        variant = "autodiff" if method == "direct" else "analytic"
    if backend == "kernel":
        if method != "gram" or variant == "autodiff":
            raise ValueError(
                "the fused value+grad kernel exists for method='gram' only; "
                f"got method={method!r}, variant={variant!r}"
            )
        return make_fused_loglik_grad_gram(
            config, norm, obs, noise_var,
            precision="high" if precision is None else precision,
            grad_precision=grad_precision, device=norm.device,
        )
    if backend != "torch":
        raise ValueError(f"backend must be 'torch' or 'kernel'; got {backend!r}")
    if variant == "autodiff":
        base = make_loglik(config, norm, obs, noise_var, backend=backend,
                           method=method, precision=precision)

        def loglik_grad_ad(params, raw):
            with torch.enable_grad():
                x = _rows(raw, norm.device).detach().requires_grad_(True)
                val = base(params, x)
                (g,) = torch.autograd.grad(val.sum(), x)
            return val.detach(), g

        return loglik_grad_ad
    if variant != "analytic":
        raise ValueError(f"variant must be 'autodiff' or 'analytic'; got {variant!r}")
    if method != "gram":
        raise ValueError("the analytic backward exists for method='gram' only")
    if config.activation != "relu":
        raise NotImplementedError(
            "the analytic backward hard-codes ReLU masks; got "
            f"activation={config.activation!r} — use variant='autodiff'"
        )
    tier = resolve_tier(precision, "high")
    grad_tier = tier if grad_precision is None else resolve_tier(grad_precision)
    device = norm.device
    obs = obs_tensor(obs, config.n_bins, device=device)
    scale = noise_scale(noise_var, config.n_bins, device=device)
    log_norm = noise_log_norm(noise_var)

    @torch.no_grad()
    def loglik_grad(params, raw):
        ops = gram_operands(params, norm, obs, scale, log_norm, tier, grad_tier)
        return loglik_grad_gram_reference(ops, _rows(raw, device))

    return loglik_grad
