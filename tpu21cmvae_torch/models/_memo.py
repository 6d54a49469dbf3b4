"""Instance-level memo for likelihood functions (a NumPy copy of
``tpu21cmvae/models/_memo.py``).

The model-level likelihood factories (``loglik_fn``,
``loglik_and_grad_fn``) build a fresh closure per call; the fused
kernel wrapper also caches its folded weights on itself. Memoizing the
factory on the model instance makes the likelihood object identity
follow the VALUE of ``(obs, noise_var, flags)``: repeated sampling
calls on the same observation reuse one wrapper, its folded weights and
its launch counter.

Bounded at ``_CAP`` entries per model with LRU eviction; callers that
manage likelihood lifetimes themselves pass ``memo=False``. A model's
replica on another device (:func:`replica_on`) starts with no memo.
"""

from __future__ import annotations

import collections
import copy

import numpy as np
import torch

from tpu21cmvae_torch.utils.profiling import count
from tpu21cmvae_torch.utils.tree import tree_map

_CAP = 8


def _key_part(p):
    if isinstance(p, np.ndarray):
        return p.tobytes()
    return p


def noise_key(noise_var):
    """Value-identity key part for a noise spec: arrays/scalars key by
    float64 bytes; objects exposing ``memo_key()`` (e.g.
    the JAX package's ``MarginalizedNoise``) key by it."""
    mk = getattr(noise_var, "memo_key", None)
    if callable(mk):
        return mk()
    return np.asarray(noise_var, np.float64)


def memo_program(model, key_parts, build, *, memo: bool = True):
    """Return ``build()`` memoized on ``model`` under ``key_parts``.

    ``key_parts``: tuple of hashables; ``np.ndarray`` entries are keyed
    by their bytes (callers normalize dtype first so byte-equality
    means value-equality). ``memo=False`` bypasses the cache entirely.
    """
    if not memo:
        return build()
    key = tuple(_key_part(p) for p in key_parts)
    cache = model.__dict__.setdefault(
        "_t21_loglik_memo", collections.OrderedDict()
    )
    fn = cache.get(key)
    if fn is None:
        count("memo.miss")
        fn = cache[key] = build()
        if len(cache) > _CAP:
            cache.popitem(last=False)
    else:
        count("memo.hit")
        cache.move_to_end(key)
    return fn


def replica_on(model, device):
    """``model`` itself when ``device`` is its own, else a shallow copy,
    with no memo, whose ``device`` and normalizer are ``device``'s: what
    the functions its ``predict_fn()`` and ``loglik_fn()`` build close
    over. The weights are passed to every call, so they stay shared."""
    device = torch.empty(0, device=device).device
    if device == model.device:
        return model
    rep = copy.copy(model)
    rep.__dict__.pop("_t21_loglik_memo", None)
    rep.device = device
    rep.normalizer = tree_map(lambda t: t.to(device) if isinstance(t, torch.Tensor) else t,
                              model.normalizer)
    return rep
