"""The same small emulator in both packages, for the port's parity tests:
the JAX model is built from the shared synthetic splits, and the port's
model carries its weights and normalizer through
``DirectEmulator.from_numpy``. Also the training shuffles JAX draws, fed
to the port through its one training draw seam."""

import contextlib

import jax
import numpy as np
import pytest
import torch

try:  # optional: also holds NumPy's BLAS (the 451 × 451 eigh) to one thread
    from threadpoolctl import threadpool_limits
except ImportError:
    threadpool_limits = None

from tpu21cmvae.models.direct import DirectEmulator as JaxEmulator
from tpu21cmvae.utils.config import DirectEmulatorConfig as JaxConfig
from tpu21cmvae_torch.models.direct import DirectEmulator
from tpu21cmvae_torch.utils.config import DirectEmulatorConfig


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread (and one BLAS thread, where ``threadpoolctl`` is
    installed) while a module that imports this fixture runs, restored
    after it. These tests push narrow tensors through long Python loops
    (sampler steps, autograd calls) and factor 451 × 451 matrices; with
    several test workers on the same cores, the thread pools cost them
    far more in waiting than they gain."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    blas = threadpool_limits(limits=1) if threadpool_limits else contextlib.nullcontext()
    with blas:
        yield
    torch.set_num_threads(before)


def make_pair(splits, hidden, seed: int = 0):
    """``(jax model, port model on the CPU)`` with hidden widths
    ``hidden`` and identical weights."""
    jm = JaxEmulator(splits, config=JaxConfig(hidden_dims=hidden), seed=seed)
    tm = DirectEmulator.from_numpy(
        jax.tree_util.tree_map(np.asarray, jm.params),
        jax.tree_util.tree_map(np.asarray, jm.normalizer),
        config=DirectEmulatorConfig(hidden_dims=hidden), device="cpu", data=splits,
    )
    return jm, tm


def train_box(par_train) -> np.ndarray:
    """The (7, 2) box around the training parameters that the JAX suite's
    sampler tests use (5 % padding, log columns kept positive)."""
    par = np.asarray(par_train, np.float64)
    lo, hi = par.min(0), par.max(0)
    pad = 0.05 * (hi - lo) + 1e-6
    lo, hi = lo - pad, hi + pad
    lo[:3] = np.maximum(lo[:3], 1e-6)
    return np.stack([lo, hi], axis=1).astype(np.float32)


def jax_shuffles(seed: int, n_epochs: int, n: int) -> list:
    """The permutations JAX's ``fit`` and ``fit_scan`` draw in epochs
    ``0 … n_epochs-1`` for ``seed`` over ``n`` real rows: the root key
    split once per epoch, the epoch key split into (shuffle, loss) keys
    (``tpu21cmvae/train/loop.py:146``, ``:372``)."""
    key = jax.random.key(seed)
    out = []
    for _ in range(n_epochs):
        key, sub = jax.random.split(key)
        shuffle_key, _ = jax.random.split(sub)
        out.append(np.asarray(jax.random.permutation(shuffle_key, n)))
    return out


@contextlib.contextmanager
def jax_seam():
    """Route the port's training shuffle seam (``train.loop._permutation``)
    to the permutations JAX draws for the same ``(seed, epoch, n)``."""
    from tpu21cmvae_torch.train import loop

    drawn = {}

    def permutation(seed, epoch, n, device):
        have = drawn.get((seed, n), [])
        if len(have) <= epoch:
            have = drawn[(seed, n)] = jax_shuffles(seed, max(epoch + 1, 2 * len(have)), n)
        return torch.tensor(have[epoch], device=device)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "_permutation", permutation)
        yield


def jax_loss_keys(seed: int, n_epochs: int) -> list:
    """The loss keys JAX's ``fit`` and ``fit_scan`` derive in epochs ``0 …
    n_epochs-1`` for ``seed``: the second half of each epoch key's split
    (``tpu21cmvae/train/loop.py:146``)."""
    key = jax.random.key(seed)
    out = []
    for _ in range(n_epochs):
        key, sub = jax.random.split(key)
        out.append(jax.random.split(sub)[1])
    return out


@contextlib.contextmanager
def jax_normal_seam(batch_size: int):
    """Route the port's stochastic-loss seam (``train.loop._normal``) to
    the normals JAX draws for the same batch: ``normal(fold_in(loss_key,
    step), (batch_size, k))`` in training (JAX pads a short last batch to
    ``batch_size`` rows; its real rows take the first rows of the draw),
    ``normal(key(seed ^ 0x5EED), shape)`` for validation (the port passes
    that seed with ``EVAL_EPOCH``)."""
    from tpu21cmvae_torch.train import loop

    keys = {}

    def normal(seed, epoch, step, shape, device):
        if epoch == loop.EVAL_EPOCH:
            draw = jax.random.normal(jax.random.key(seed), tuple(shape))
            return torch.tensor(np.asarray(draw), device=device)
        have = keys.get(seed, [])
        if len(have) <= epoch:
            have = keys[seed] = jax_loss_keys(seed, max(epoch + 1, 2 * len(have)))
        draw = jax.random.normal(jax.random.fold_in(have[epoch], step),
                                 (batch_size, *tuple(shape)[1:]))
        return torch.tensor(np.asarray(draw)[: shape[0]], device=device)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "_normal", normal)
        yield
