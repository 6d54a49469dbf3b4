"""The tier-native bf16 checkpoints in the port: the counterpart of
``tests/test_pretrained.py::test_pretrained_bf16_native_golden``.

Both shipped checkpoints fine-tuned for the single-pass bf16 tier
(``pretrained/direct_synthetic_bf16.npz`` on the flagship widths,
``pretrained/direct_aligned_bf16.npz`` on
:data:`~tpu21cmvae_torch.utils.config.DIRECT_ALIGNED`) load through
``DirectEmulator.from_checkpoint``, predict the golden split's test set
at their native tier (``predict_fn(precision="native")``) within the JAX
suite's bounds of 0.20 % and 0.25 % mean relative error, and keep their
native tier through a save.

The port's ``"default"`` tier rounds every product's operands to bf16 on
the CPU too, where JAX's lowers to f32, so the port's test is the
stricter of the two; the bounds are JAX's.
"""

import os

import numpy as np
import pytest
import torch

from _torch_pair import one_torch_thread  # noqa: F401
from tpu21cmvae.utils.config import DIRECT_ALIGNED as JAX_DIRECT_ALIGNED
from tpu21cmvae_torch.models.direct import DirectEmulator
from tpu21cmvae_torch.utils.config import DIRECT_ALIGNED, DirectEmulatorConfig
from tpu21cmvae_torch.utils.metrics import error

PRETRAINED = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "pretrained")


@pytest.fixture(scope="module")
def refdata():
    from tpu21cmvae_torch.data.synthetic import synthetic_dataset

    # the split the checkpoints were trained on
    return synthetic_dataset(n_train=26888, n_val=1704, n_test=1704, seed=0)


def test_direct_aligned_is_jaxs():
    assert DIRECT_ALIGNED == DirectEmulatorConfig(hidden_dims=(256, 256, 128, 128, 128))
    assert DIRECT_ALIGNED.hidden_dims == tuple(JAX_DIRECT_ALIGNED.hidden_dims)
    assert (DIRECT_ALIGNED.n_params, DIRECT_ALIGNED.n_bins, DIRECT_ALIGNED.activation) == (
        JAX_DIRECT_ALIGNED.n_params, JAX_DIRECT_ALIGNED.n_bins, JAX_DIRECT_ALIGNED.activation)


@pytest.mark.parametrize("fname,config,bound", [
    ("direct_synthetic_bf16.npz", None, 0.20),
    ("direct_aligned_bf16.npz", DIRECT_ALIGNED, 0.25),
])
def test_pretrained_bf16_native_golden(refdata, tmp_path, fname, config, bound):
    em = DirectEmulator.from_checkpoint(os.path.join(PRETRAINED, fname), device="cpu")
    assert em.native_precision == "default"
    if config is not None:
        assert em.config == config
    with torch.no_grad():
        pred = em.predict_fn(precision="native")(
            em.params, torch.as_tensor(np.asarray(refdata.par_test, np.float32))).numpy()
    err = error(refdata.signal_test, pred, relative=True, nu_arr=em.frequencies)
    assert err.mean() < bound, (fname, err.mean())
    # saving round-trips the native tier
    out = str(tmp_path / ("rt_" + fname))
    em.save(out)
    assert DirectEmulator.from_checkpoint(out, device="cpu").native_precision == "default"
