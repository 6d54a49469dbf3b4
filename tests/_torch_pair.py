"""The same small emulator in both packages, for the port's parity tests:
the JAX model is built from the shared synthetic splits, and the port's
model carries its weights and normalizer through
``DirectEmulator.from_numpy``."""

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
