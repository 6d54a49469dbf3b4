"""Dense MLP: an ``nn.Module`` holding the weights, and a plain function
on ``{"w", "b"}`` layer dicts (the port of ``tpu21cmvae/ops/mlp.py``;
replaces the reference's Keras ``_gen_model``, ``emulator.py:12-48``).

Weights keep the Keras kernel layout ``(in_dim, out_dim)``, as in the
JAX package, so both packages read the same checkpoints without
transposition and the tests compare like with like. Initialization is
the Keras Dense default (Glorot-uniform kernels, zero biases), drawn
from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu21cmvae_torch.ops.fold import prepare_operand, resolve_tier, tier_matmul

MLPParams = Tuple[dict, ...]

_ACTIVATIONS = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    # jax.nn.gelu's default is the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "elu": F.elu,
    "softplus": F.softplus,
    "linear": lambda x: x,
}

SKINNY_DENSE_MAX_IN = 8
"""At or below this fan-in, a dense layer runs as exact fp32
broadcast-FMA over the fan-in at every precision tier (the 7-parameter
input layer)."""


def resolve_activation(activation: Union[str, Callable]) -> Callable:
    """A Keras-style name (reference ``emulator.py:25-27``) or a
    callable."""
    if callable(activation):
        return activation
    try:
        return _ACTIVATIONS[activation]
    except KeyError:
        raise ValueError(
            f"Unknown activation {activation!r}; one of {sorted(_ACTIVATIONS)} "
            "or a callable."
        ) from None


def glorot_uniform_init(generator: torch.Generator, in_dim: int, out_dim: int,
                        *, device) -> torch.Tensor:
    """Keras Dense default kernel init: U(-limit, limit),
    limit = sqrt(6 / (fan_in + fan_out)). Drawn on the host generator,
    then moved, so a seed gives the same weights on every device."""
    limit = (6.0 / (in_dim + out_dim)) ** 0.5
    w = torch.empty((in_dim, out_dim), dtype=torch.float32)
    w.uniform_(-limit, limit, generator=generator)
    return w.to(device)


def init_mlp(generator: torch.Generator, sizes: Sequence[int], *,
             device) -> MLPParams:
    """Layer dicts for widths ``sizes = (in, *hidden, out)``."""
    return tuple(
        {
            "w": glorot_uniform_init(generator, d_in, d_out, device=device),
            "b": torch.zeros((d_out,), dtype=torch.float32, device=device),
        }
        for d_in, d_out in zip(sizes[:-1], sizes[1:])
    )


def skinny_dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` as explicit broadcast multiply-adds over the (small)
    fan-in — exact fp32 whatever the matmul tier."""
    acc = b[None, :] + x[:, 0:1] * w[0][None, :]
    for k in range(1, w.shape[0]):
        acc = acc + x[:, k: k + 1] * w[k][None, :]
    return acc


def mlp_apply(params: MLPParams, x: torch.Tensor, activation="relu",
              precision="highest") -> torch.Tensor:
    """Forward pass: ``activation`` after every layer except the last,
    which is linear (reference ``emulator.py:45-46``). ``precision`` is
    one tier for every non-skinny layer (see
    :func:`tpu21cmvae_torch.ops.fold.resolve_tier`); a first layer with
    fan-in ≤ :data:`SKINNY_DENSE_MAX_IN` is always exact."""
    act = resolve_activation(activation)
    tier = resolve_tier(precision, "highest")
    for i, layer in enumerate(params):
        w = layer["w"]
        if i == 0 and x.ndim == 2 and w.shape[0] <= SKINNY_DENSE_MAX_IN:
            x = skinny_dense(x, w, layer["b"])
        else:
            x = tier_matmul(x, prepare_operand(w, tier), tier) + layer["b"]
        if i < len(params) - 1:
            x = act(x)
    return x


def _tensor(a, device) -> torch.Tensor:
    """A float32 copy of an array or tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device=device, dtype=torch.float32).clone()
    return torch.tensor(np.asarray(a), dtype=torch.float32, device=device)


class MLP(nn.Module):
    """The weights of one dense MLP as module parameters.

    ``params`` (optional): layer dicts of arrays or tensors in Keras
    ``(in, out)`` layout, copied to ``device`` as float32 after a shape
    check; without them, Glorot init from a generator seeded with
    ``seed``.
    """

    def __init__(self, sizes: Sequence[int], activation="relu", *, device,
                 params=None, seed: int = 0):
        super().__init__()
        self.sizes = tuple(int(s) for s in sizes)
        self.activation = activation
        if params is None:
            params = init_mlp(torch.Generator().manual_seed(seed), self.sizes,
                              device=device)
        if len(params) != len(self.sizes) - 1:
            raise ValueError(
                f"{len(params)} layers given for sizes {self.sizes}"
            )
        ws, bs = [], []
        for i, layer in enumerate(params):
            w, b = _tensor(layer["w"], device), _tensor(layer["b"], device)
            want = (self.sizes[i], self.sizes[i + 1])
            if tuple(w.shape) != want or tuple(b.shape) != want[1:]:
                raise ValueError(
                    f"layer {i}: w {tuple(w.shape)}, b {tuple(b.shape)}; "
                    f"expected {want} and {want[1:]}"
                )
            ws.append(nn.Parameter(w))
            bs.append(nn.Parameter(b))
        self.weights = nn.ParameterList(ws)
        self.biases = nn.ParameterList(bs)

    @property
    def params(self) -> MLPParams:
        """The layers as ``{"w": (in, out), "b": (out,)}`` dicts — the
        argument of every plain function in the port."""
        return tuple({"w": w, "b": b} for w, b in zip(self.weights, self.biases))

    def forward(self, x: torch.Tensor, precision="highest") -> torch.Tensor:
        return mlp_apply(self.params, x, self.activation, precision)
