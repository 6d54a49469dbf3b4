"""Keras Adam, in place on a list of tensors (the port of
``tpu21cmvae/train/adam.py``).

The reference recipes train with the Keras Adam (``notebooks/Training.ipynb``
cells 4, 10), which differs from ``torch.optim.Adam`` in where epsilon
goes: ``p -= lr_t * m / (sqrt(v) + eps)`` with eps = 1e-7 outside the
uncorrected second moment and ``lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)``.
``lr_t`` is computed on the host in float32, as the JAX package computes
it on the device, from a 1-based step count; every update runs as a few
``torch._foreach_*`` operations over the flat list, so the parameters
keep their identity and their version counters move (which is what the
kernels' operand caches key on).
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from tpu21cmvae_torch.utils.tree import tree_leaves


class AdamState(NamedTuple):
    """``step``: updates taken so far (JAX stores it as an int32 scalar);
    ``mu``, ``nu``: the moments, one tensor per parameter tensor in the
    parameters' flatten order."""

    step: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def adam_init(params) -> AdamState:
    """Zero moments for the leaves of ``params``."""
    leaves = tree_leaves(params)
    return AdamState(0, [torch.zeros_like(p) for p in leaves],
                     [torch.zeros_like(p) for p in leaves])


def adam_state_from_arrays(step, mu, nu, *, device) -> AdamState:
    """The port's state from the JAX package's ``AdamState`` as arrays:
    ``step`` a scalar, ``mu`` and ``nu`` pytrees (or flat lists in
    flatten order) of arrays."""
    def load(tree):
        return [torch.tensor(np.asarray(a), dtype=torch.float32, device=device)
                for a in tree_leaves(tree)]

    return AdamState(int(np.asarray(step)), load(mu), load(nu))


def bias_corrected_lr(lr, t: int, beta_1: float, beta_2: float) -> float:
    """``lr * sqrt(1 - beta_2^t) / (1 - beta_1^t)`` in float32."""
    f32 = np.float32
    t = f32(t)
    return float(f32(lr) * np.sqrt(f32(1.0) - f32(beta_2) ** t)
                 / (f32(1.0) - f32(beta_1) ** t))


@torch.no_grad()
def adam_update(grads, params, state: AdamState, lr, beta_1: float = 0.9,
                beta_2: float = 0.999, epsilon: float = 1e-7) -> AdamState:
    """One Adam step on the leaves of ``params``, in place; returns the
    state with the step counted. ``grads``: one tensor per leaf, in
    flatten order."""
    params = tree_leaves(params)
    grads = list(grads)
    t = state.step + 1
    mu, nu = state.mu, state.nu
    # the JAX expression's operations one by one (beta_1 * m + (1 - beta_1) * g):
    # each product rounds before the sum, as there
    torch._foreach_mul_(mu, beta_1)
    torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - beta_1))
    torch._foreach_mul_(nu, beta_2)
    g2 = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(g2, 1.0 - beta_2)
    torch._foreach_add_(nu, g2)
    denom = torch._foreach_sqrt(nu)
    torch._foreach_add_(denom, epsilon)
    step = torch._foreach_mul(mu, bias_corrected_lr(lr, t, beta_1, beta_2))
    torch._foreach_div_(step, denom)
    torch._foreach_sub_(params, step)
    return AdamState(t, mu, nu)
