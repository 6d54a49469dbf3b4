"""Gaussian log-likelihood of an observed signal under the emulator, and
its per-row gradient (the port of ``tpu21cmvae/ops/loglik.py``).

``logL(θ) = −½·rᵀ·P·r + log_norm`` per row of raw parameter draws, with
``r = emulate(θ) − obs`` and ``P`` the noise spec's precision. Two
backends:

* ``"torch"`` (the JAX package's ``"xla"``) — plain tensor operations;
* ``"kernel"`` (its ``"pallas"``) — one CUDA kernel per call
  (:mod:`tpu21cmvae_torch.ops.kernels.fused_loglik`): the value alone
  by K1 (``method="direct"``) or K2 (``"gram"``), the value with its
  gradient by K3. Each wrapper runs its plain version for CPU tensors.
  :func:`make_member_loglik` and :func:`make_member_loglik_and_grad`
  build the same kernels over an ensemble's stacked weights, all members
  in one launch per call (JAX's ``vmap`` of the kernel likelihood over
  the member axis).

Both backends' value functions are differentiable by ``torch.autograd``
with respect to the raw rows and the weights, as the JAX package's are.

Every factory takes the same noise specs: a scalar or per-bin variance
σ² (``P = diag(1/σ²)``, ``log_norm = 0``); a foreground-marginalized
:class:`~tpu21cmvae_torch.foregrounds.MarginalizedNoise` (``P = R·Rᵀ``
projects the foreground modes out; ``R`` folds into the output layer, so
the gram form and the kernels keep their shapes); or a
:class:`~tpu21cmvae_torch.noisescale.ScaleMarginalNoise` over either,
which every factory unwraps to its base spec and re-scores by an exact
scalar post-transform of the value (and a per-row rescale of the
gradient). The stacked-observation factories (:func:`make_loglik_multi`)
score ``O`` observations in one call under one shared spec, in plain
PyTorch on both devices; the ``*_from_predict`` factories take any
``(weights, raw) → signals`` function. The factories that take the
normalizer give a likelihood with a ``replica(device)``, the same
likelihood made on another device, for a mesh.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu21cmvae_torch.foregrounds import MarginalizedNoise
from tpu21cmvae_torch.noisescale import ScaleMarginalNoise
from tpu21cmvae_torch.ops.fold import (
    _log_clamp,
    fold_loglik_constants,
    gram_fold,
    noise_log_norm,
    noise_scale,
    obs_tensor,
    resolve_tier,
    tier_dense,
)
from tpu21cmvae_torch.ops.kernels.fused_loglik import (
    gram_operands,
    loglik_grad_gram_reference,
    make_fused_loglik,
    make_fused_loglik_gram,
    make_fused_loglik_grad_gram,
)
from tpu21cmvae_torch.ops.mlp import (
    SKINNY_DENSE_MAX_IN,
    mlp_apply,
    resolve_activation,
    skinny_dense,
)
from tpu21cmvae_torch.ops.transforms import par_transform, unpreproc
from tpu21cmvae_torch.parallel.mesh import replica_of, replicable, tree_to
from tpu21cmvae_torch.utils.profiling import WRAPPERS, span


def _on_each_device(factory):
    """``factory(config, norm, …)`` whose likelihood carries a
    ``replica(device)``: the same call with ``norm`` on that device
    (:func:`~tpu21cmvae_torch.parallel.mesh.replicable`), for a mesh.
    Everything else the likelihood closes over is made from ``norm``'s
    device."""

    @functools.wraps(factory)
    def make(config, norm, *args, **kwargs):
        return replicable(lambda d: factory(config, tree_to(norm, d), *args, **kwargs),
                          norm.device)

    return make


def _rows(raw, device) -> torch.Tensor:
    return torch.atleast_2d(torch.as_tensor(raw, dtype=torch.float32, device=device))


def _resid_quad(noise_var, n_bins: int, *, device):
    """``(residual (…, n_bins) → rᵀ·P·r rows, log_norm)`` for a noise
    spec: diagonal (scalar or per-bin σ²) or foreground-marginalized
    (``z = r @ R`` in fp32, then the sum of squares). The shared residual
    reduction of every likelihood path here that does not fold the noise
    into the weights."""
    scale = noise_scale(noise_var, n_bins, device=device)
    log_norm = noise_log_norm(noise_var)
    if scale.ndim == 2:

        def quad(r):
            z = r @ scale
            return torch.sum(z * z, dim=-1)

        return quad, log_norm
    inv_var = scale * scale

    def quad(r):
        return torch.sum(r * r * inv_var, dim=-1)

    return quad, log_norm


def _obs_bins(obs) -> int:
    return int(np.shape(obs)[-1])


def make_loglik_from_predict(predict_fn, obs, noise_var=1.0, *, device):
    """Generic Gaussian log-likelihood over ANY ``(weights, raw) →
    signals`` prediction function on ``device`` (a model family without
    the single-MLP folds plugs its ``predict_fn`` in here). The direct
    family should prefer :func:`make_loglik`, whose folded, gram and
    kernel forms only exist for a single-MLP forward. ``noise_var``: any
    spec of the module docstring."""
    if isinstance(noise_var, ScaleMarginalNoise):
        base = make_loglik_from_predict(predict_fn, obs, noise_var.base, device=device)
        return noise_var.wrap_value(base, _obs_bins(obs))
    n_bins = _obs_bins(obs)
    obs = obs_tensor(obs, n_bins, device=device)
    quad, log_norm = _resid_quad(noise_var, n_bins, device=device)

    def loglik(weights, raw):
        pred = predict_fn(weights, _rows(raw, device))
        return -0.5 * quad(pred - obs) + log_norm

    return loglik


def make_loglik_multi_from_predict(predict_fn, obs_batch, noise_var=1.0, *, device):
    """Stacked-observation companion of :func:`make_loglik_from_predict`
    for any ``(weights, raw) → signals`` function (the two-stage families'
    batched-survey path): row ``o·W + w`` of the observation-major batch
    scores against ``obs_batch[o]``, ``W`` inferred per call (see
    :func:`make_loglik_multi`). ``noise_var``: a scalar, a per-bin vector
    or a ``MarginalizedNoise`` shared across observations, or a
    ``ScaleMarginalNoise`` over one (the level marginalized per
    observation)."""
    if isinstance(noise_var, ScaleMarginalNoise):
        base = make_loglik_multi_from_predict(predict_fn, obs_batch, noise_var.base,
                                              device=device)
        return noise_var.wrap_value(base, _obs_bins(obs_batch))
    n_bins = _obs_bins(obs_batch)
    obs = _obs_batch_tensor(obs_batch, n_bins, device=device)
    n_obs = obs.shape[0]
    _check_multi_noise(noise_var, n_bins)
    quad, log_norm = _resid_quad(noise_var, n_bins, device=device)

    def loglik(weights, raw):
        raw = _rows(raw, device)
        w = _rows_per_obs(raw, n_obs)
        r = predict_fn(weights, raw).reshape(n_obs, w, n_bins) - obs[:, None, :]
        return (-0.5 * quad(r) + log_norm).reshape(-1)

    return loglik


def per_row_grad(loglik, *, device=None):
    """Wrap a batched ``(weights, raw) → (B,)`` likelihood as
    ``(weights, raw) → ((B,), (B, P))``, both detached, by a
    ones-cotangent VJP: exact whenever each row's value depends only on
    its own row (true for every likelihood in this module: observation
    pairing is a static reshape, never a cross-row reduction). ``raw``
    goes to ``device`` (default: where it is) before the gradient's leaf
    is made. Given a ``device`` and a likelihood with a ``replica``, the
    result has one too: the same wrap of the likelihood's replica."""
    if device is not None and hasattr(loglik, "replica"):
        return replicable(lambda d: _per_row_grad(replica_of(loglik, d), d), device)
    return _per_row_grad(loglik, device)


def _per_row_grad(loglik, device):
    def loglik_and_grad(weights, raw):
        with span("autograd_valgrad", WRAPPERS), torch.enable_grad():
            x = torch.atleast_2d(torch.as_tensor(raw, dtype=torch.float32, device=device))
            x = x.detach().requires_grad_(True)
            val = loglik(weights, x)
            (g,) = torch.autograd.grad(val, x, torch.ones_like(val))
        return val.detach(), g

    return loglik_and_grad


def make_loglik_and_grad_from_predict(predict_fn, obs, noise_var=1.0, *, device):
    """Value + per-row gradient companion of
    :func:`make_loglik_from_predict` (:func:`per_row_grad` over it), for
    a ``predict_fn`` that ``torch.autograd`` can differentiate
    (``DirectEmulator.predict_fn`` runs under ``no_grad`` and serves the
    value factory only). The direct family's :func:`make_loglik_and_grad`
    has analytic and fused variants."""
    return per_row_grad(make_loglik_from_predict(predict_fn, obs, noise_var, device=device),
                        device=device)


class _KernelValue(torch.autograd.Function):
    """A value kernel's forward, with the backward of its plain twin:
    autograd through ``make_loglik(backend="torch")`` at the same tier,
    recomputed from the saved inputs (the JAX package's ``custom_vjp``
    around its Pallas likelihoods, ``ops/loglik.py:184-206``)."""

    @staticmethod
    def forward(ctx, fused, twin, raw, *weights):
        ctx.twin = twin
        ctx.save_for_backward(raw, *weights)
        return fused(_layers(weights), raw)

    @staticmethod
    def backward(ctx, g):
        raw, *weights = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip((raw, *weights), ctx.needs_input_grad[2:])]
        with torch.enable_grad():
            val = ctx.twin(_layers(inputs[1:]), inputs[0])
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(val, wanted, g, allow_unused=True))
        return (None, None, *(next(grads) if t.requires_grad else None for t in inputs))


def _layers(weights) -> tuple:
    """``(w0, b0, w1, b1, …)`` back into layer dicts."""
    return tuple({"w": w, "b": b} for w, b in zip(weights[::2], weights[1::2]))


class KernelLoglik:
    """``(params, raw) → (B,)`` by a value kernel (K1 or K2), with
    gradients by the plain twin (:class:`_KernelValue`). ``raw`` follows
    the kernel wrapper's rules: a contiguous float32 tensor on its
    device, which launches the kernel on CUDA and runs the plain version
    on the CPU. :attr:`launches` is the kernel wrapper's count."""

    def __init__(self, fused, twin):
        self.fused = fused
        self.twin = twin

    @property
    def launches(self) -> int:
        return self.fused.launches

    @launches.setter
    def launches(self, n: int):
        self.fused.launches = n

    def __call__(self, params, raw):
        with span("kernel_value", WRAPPERS):
            weights = [t for layer in params for t in (layer["w"], layer["b"])]
            return _KernelValue.apply(self.fused, self.twin, raw, *weights)


def _stacked_twin(twin, members: int):
    """``(stacked, raw) → (M, B)``: ``twin`` on each member's layers of a
    stacked tree, the plain twin of a member-batched value kernel (its
    autograd rule)."""

    def stacked(params, raw):
        return torch.stack([twin(tuple({"w": layer["w"][m], "b": layer["b"][m]}
                                       for layer in params), raw)
                            for m in range(members)])

    return stacked


@_on_each_device
def make_member_loglik(config, norm, obs, noise_var=1.0, *, members: int,
                       method: str = "direct", precision=None):
    """``fn(stacked, raw) → (M, B)``: the kernel log-likelihood of each of
    an ensemble's ``members`` at once, from its stacked weights (layer
    dicts of ``(M, in, out)`` / ``(M, out)``), one launch of K1
    (``method="direct"``) or K2 (``"gram"``) per call: what
    :func:`make_loglik` with ``backend="kernel"`` gives one model, member
    m's row bit for bit that model's. ``noise_var``, ``method`` and
    ``precision`` as :func:`make_loglik`; a
    :class:`~tpu21cmvae_torch.noisescale.ScaleMarginalNoise` re-scores
    every member's value. Differentiable through the plain twin, per
    member, as :class:`KernelLoglik`."""
    if method not in ("direct", "gram"):
        raise ValueError(f"method must be 'direct' or 'gram'; got {method!r}")
    if isinstance(noise_var, ScaleMarginalNoise):
        base = make_member_loglik(config, norm, obs, noise_var.base, members=members,
                                  method=method, precision=precision)
        return noise_var.wrap_value(base, config.n_bins)
    build = make_fused_loglik if method == "direct" else make_fused_loglik_gram
    return KernelLoglik(
        build(config, norm, obs, noise_var, precision="high" if precision is None else precision,
              members=members, device=norm.device),
        _stacked_twin(make_loglik(config, norm, obs, noise_var, backend="torch",
                                  method=method, precision=precision), members),
    )


@_on_each_device
def make_member_loglik_and_grad(config, norm, obs, noise_var=1.0, *, members: int,
                                method: str = "gram", precision=None, grad_precision=None):
    """``fn(stacked, raw) → (logL (M, B), dlogL/draw (M, B, n_params))``
    for each of an ensemble's ``members`` at once, one K3 launch per call:
    what :func:`make_loglik_and_grad` with ``backend="kernel"`` gives one
    model, member m's rows bit for bit that model's. Tiers and noise specs
    as there; ``method`` must be ``"gram"``."""
    if method != "gram":
        raise ValueError(
            f"the fused value+grad kernel exists for method='gram' only; got method={method!r}")
    if isinstance(noise_var, ScaleMarginalNoise):
        base = make_member_loglik_and_grad(config, norm, obs, noise_var.base, members=members,
                                           precision=precision, grad_precision=grad_precision)
        return noise_var.wrap_valgrad(base, config.n_bins)
    return make_fused_loglik_grad_gram(
        config, norm, obs, noise_var, precision="high" if precision is None else precision,
        grad_precision=grad_precision, members=members, device=norm.device,
    )


@_on_each_device
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
    ``backend="kernel"`` returns a :class:`KernelLoglik`: K1 (direct) or
    K2 (gram) forward, whose ``raw`` must be a contiguous float32 tensor
    on ``norm``'s device, and this backend's gradient.
    """
    if method not in ("direct", "gram"):
        raise ValueError(f"method must be 'direct' or 'gram'; got {method!r}")
    if isinstance(noise_var, ScaleMarginalNoise):
        # an exact scalar post-transform of the σ = 1 base likelihood:
        # every backend, method and tier below is reused unchanged, and
        # the kernel backend's plain twin is built from the base spec too
        base = make_loglik(config, norm, obs, noise_var.base, backend=backend,
                           method=method, precision=precision)
        return noise_var.wrap_value(base, config.n_bins)
    if backend == "kernel":
        build = make_fused_loglik if method == "direct" else make_fused_loglik_gram
        return KernelLoglik(
            build(config, norm, obs, noise_var,
                  precision="high" if precision is None else precision,
                  device=norm.device),
            make_loglik(config, norm, obs, noise_var, backend="torch",
                        method=method, precision=precision),
        )
    if backend != "torch":
        raise ValueError(f"backend must be 'torch' or 'kernel'; got {backend!r}")
    tier = resolve_tier(precision, "high")
    device = norm.device
    obs = obs_tensor(obs, config.n_bins, device=device)
    act = resolve_activation(config.activation)

    if method == "gram":
        scale = noise_scale(noise_var, config.n_bins, device=device)
        log_norm = noise_log_norm(noise_var)

        def loglik_gram(params, raw):
            trunk, G, u, c = gram_fold(params, norm, obs, scale)
            h = _log_clamp(_rows(raw, device))
            for i, layer in enumerate(trunk):  # trunk layers are hidden
                if i == 0 and layer["w"].shape[0] <= SKINNY_DENSE_MAX_IN:
                    h = skinny_dense(h, layer["w"], layer["b"])
                else:
                    h = tier_dense(h, layer["w"], tier) + layer["b"]
                h = act(h)
            g = tier_dense(h, G, tier)
            return -0.5 * (torch.sum((g + 2.0 * u) * h, dim=-1) + c) + log_norm

        return loglik_gram

    quad, log_norm = _resid_quad(noise_var, config.n_bins, device=device)

    def loglik(params, raw):
        x = par_transform(_rows(raw, device), norm)
        pred = unpreproc(mlp_apply(params, x, config.activation, precision or "high"), norm)
        return -0.5 * quad(pred - obs) + log_norm

    return loglik

def _check_multi_noise(noise_var, n_bins: int):
    """Shared-noise validation for the stacked-observation factories: a
    scalar, a per-bin (n_bins,) vector, or a MarginalizedNoise of the
    right bin count (per-OBSERVATION noise would break the shared gram
    structure: score heterogeneous-noise surveys in groups)."""
    if isinstance(noise_var, MarginalizedNoise):
        if noise_var.whiten.shape != (n_bins, n_bins):
            raise ValueError(
                f"MarginalizedNoise built for {noise_var.whiten.shape[0]} "
                f"bins; the observations have {n_bins}"
            )
        return
    nv = np.asarray(noise_var, np.float32)
    if nv.ndim > 1 or (nv.ndim == 1 and nv.shape[0] != n_bins):
        raise ValueError(
            "noise_var must be a scalar, a per-bin vector shared across "
            f"observations, or a MarginalizedNoise; got shape {nv.shape}"
        )


def _obs_batch_tensor(obs_batch, n_bins: int, *, device) -> torch.Tensor:
    """Observed signals (O, n_bins) as float32 on ``device``; one
    (n_bins,) signal is a batch of one."""
    if isinstance(obs_batch, torch.Tensor):
        obs_batch = obs_batch.detach().cpu().numpy()
    obs = np.atleast_2d(np.asarray(obs_batch, np.float32))
    if obs.ndim != 2 or obs.shape[1] != n_bins:
        raise ValueError(f"obs_batch must be (O, {n_bins}); got {obs.shape}")
    return torch.as_tensor(obs, device=device)


def _rows_per_obs(raw: torch.Tensor, n_obs: int) -> int:
    if raw.shape[0] % n_obs:
        raise ValueError(
            f"batch of {raw.shape[0]} rows does not divide across {n_obs} "
            "observations; pass observation-major rows, W per obs"
        )
    return raw.shape[0] // n_obs


@_on_each_device
def make_loglik_multi(config, norm, obs_batch, noise_var=1.0, *, method: str = "gram",
                      precision=None):
    """Stacked-observation likelihood: ``fn(params, raw (O·W, P)) →
    (O·W,)`` where row ``o·W + w`` scores against ``obs_batch[o]``:
    many observed spectra in ONE call. ``W`` is inferred from the batch
    (rows must be observation-major and divide evenly by ``O``), so the
    same samplers run ``O`` independent posteriors at once.

    ``obs_batch``: (O, n_bins) observed signals in mK. ``noise_var``: a
    scalar, a per-bin (n_bins,) variance or a
    :class:`~tpu21cmvae_torch.foregrounds.MarginalizedNoise`, SHARED
    across observations, or a
    :class:`~tpu21cmvae_torch.noisescale.ScaleMarginalNoise` over one
    (the level is then marginalized per observation). ``method="gram"``
    keeps the single-observation structure: ``G = WWᵀ`` and the trunk do
    not depend on the observation (computed once per call), only the
    small ``u`` and ``c`` become per-observation rows. Precision as in
    :func:`make_loglik`. Plain PyTorch on both devices, as the JAX
    package's stacked forms are plain XLA.
    """
    if method not in ("direct", "gram"):
        raise ValueError(f"method must be 'direct' or 'gram'; got {method!r}")
    if isinstance(noise_var, ScaleMarginalNoise):
        base = make_loglik_multi(config, norm, obs_batch, noise_var.base, method=method,
                                 precision=precision)
        return noise_var.wrap_value(base, config.n_bins)
    device = norm.device
    obs = _obs_batch_tensor(obs_batch, config.n_bins, device=device)
    n_obs = obs.shape[0]
    _check_multi_noise(noise_var, config.n_bins)
    tier = resolve_tier(precision, "high")

    if method == "direct":
        quad, log_norm = _resid_quad(noise_var, config.n_bins, device=device)

        def loglik_direct(params, raw):
            raw = _rows(raw, device)
            w = _rows_per_obs(raw, n_obs)
            x = par_transform(raw, norm)
            pred = unpreproc(mlp_apply(params, x, config.activation, precision or "high"), norm)
            r = pred.reshape(n_obs, w, config.n_bins) - obs[:, None, :]
            return (-0.5 * quad(r) + log_norm).reshape(-1)

        return loglik_direct

    scale = noise_scale(noise_var, config.n_bins, device=device)
    log_norm = noise_log_norm(noise_var)
    act = resolve_activation(config.activation)
    zero_obs = torch.zeros(config.n_bins, dtype=torch.float32, device=device)

    def constants(params):
        # one fold at obs = 0 gives the shared trunk and the whitened last
        # layer (Wₛ, b₀); G = Wₛ Wₛᵀ does not depend on the observation,
        # and each observation only shifts the folded bias (b_o = b₀ −
        # whiten(obs_o)), so the gram constants vectorize exactly:
        # u_o = Wₛ b_o, c_o = b_o·b_o, small (O, hidden) rows
        *trunk, last = fold_loglik_constants(params, norm, zero_obs, scale)
        w_s, b0 = last["w"], last["b"]
        whitened = obs @ scale if scale.ndim == 2 else obs * scale
        b_all = b0 - whitened  # (O, n_bins)
        return trunk, w_s @ w_s.T, b_all @ w_s.T, torch.sum(b_all * b_all, dim=-1)

    def loglik_gram(params, raw):
        raw = _rows(raw, device)
        w_rows = _rows_per_obs(raw, n_obs)
        trunk, G, u_all, c_all = constants(params)
        h = _log_clamp(raw)
        for i, layer in enumerate(trunk):
            if i == 0 and layer["w"].shape[0] <= SKINNY_DENSE_MAX_IN:
                h = skinny_dense(h, layer["w"], layer["b"])
            else:
                h = tier_dense(h, layer["w"], tier) + layer["b"]
            h = act(h)
        g1 = tier_dense(h, G, tier)  # shared across observations
        hh = h.reshape(n_obs, w_rows, -1)
        gg = g1.reshape(n_obs, w_rows, -1)
        quad = torch.sum((gg + 2.0 * u_all[:, None, :]) * hh, dim=-1) + c_all[:, None]
        return (-0.5 * quad + log_norm).reshape(-1)

    return loglik_gram


@_on_each_device
def make_loglik_and_grad_multi(config, norm, obs_batch, noise_var=1.0, *,
                               method: str = "gram", precision=None):
    """Value + per-row gradient companion of :func:`make_loglik_multi`,
    the stacked-observation HMC inner loop ``(params, (O·W, P)) →
    ((O·W,), (O·W, P))``, by :func:`per_row_grad`: every row's logL
    depends only on its own row (the observation pairing is a static
    reshape), so the block-diagonal Jacobian collapses to the per-row
    gradient in one backward pass."""
    return per_row_grad(
        make_loglik_multi(config, norm, obs_batch, noise_var, method=method,
                          precision=precision),
        device=norm.device,
    )


@_on_each_device
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
    if isinstance(noise_var, ScaleMarginalNoise):
        # the exact chain rule through the scalar post-transform: the
        # analytic and fused gradient backends carry over unchanged
        base = make_loglik_and_grad(
            config, norm, obs, noise_var.base, backend=backend, method=method,
            variant=variant, precision=precision, grad_precision=grad_precision,
        )
        return noise_var.wrap_valgrad(base, config.n_bins)
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
        return per_row_grad(make_loglik(config, norm, obs, noise_var, backend=backend,
                                        method=method, precision=precision),
                            device=norm.device)
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
