"""The benchmark's plain reference against the port's plain CPU path on
the shipped checkpoints, at small batches, and its lower precisions."""

import os

import numpy as np
import pytest
import torch

from port_bench import harness
from port_bench.reference import MODES, Reference, _round

CKPT = {"direct": "pretrained/direct_synthetic.npz", "ae": "pretrained/ae_synthetic.npz"}
BOX = np.array([[1e-4, 0.5], [4.2, 100.0], [1e-4, 1000.0], [0.04, 0.09], [1.0, 1.5],
                [0.1, 3.0], [10.0, 50.0]])


def _model(family):
    path = os.path.join(harness.ROOT, CKPT[family])
    if family == "direct":
        from tpu21cmvae_torch.models.direct import DirectEmulator

        return DirectEmulator.from_checkpoint(path, device="cpu")
    from tpu21cmvae_torch.models.autoencoder import AutoEncoderEmulator

    return AutoEncoderEmulator.from_checkpoint(path, device="cpu")


def _rows(n, seed=0):
    rng = np.random.default_rng(seed)
    x = (BOX[:, 0] + (BOX[:, 1] - BOX[:, 0]) * rng.uniform(size=(n, 7))).astype(np.float32)
    x[0, 2] = 0.0  # the log-clamp path
    return x


@pytest.mark.parametrize("family", ["direct", "ae"])
def test_forward_against_the_ports_plain_path(family):
    torch.set_num_threads(1)
    model = _model(family)
    ref = Reference(os.path.join(harness.ROOT, CKPT[family]), device="cpu")
    x = _rows(37)
    got = model.predict(x).astype(np.float64)
    want = ref.forward(x).numpy()
    # float32 through five to eight layers: within 1e-5 of the amplitude
    err = np.max(np.abs(got - want), axis=1) / np.max(np.abs(want), axis=1)
    assert np.max(err) < 1e-5


@pytest.mark.parametrize("family", ["direct", "ae"])
def test_loglik_and_gradient_against_the_ports_plain_path(family):
    torch.set_num_threads(1)
    model = _model(family)
    path = os.path.join(harness.ROOT, CKPT[family])
    ref = Reference(path, device="cpu")
    x = _rows(64, seed=1)
    x[0, 2] = 3.0
    obs = (ref.forward(_rows(2, seed=2)[1:]).numpy()[0]
           + np.random.default_rng(3).normal(0, 5.0, 451)).astype(np.float32)
    nv = 25.0
    kw = {"precision": "contract"} if family == "direct" else {}
    ll, g = model.loglik_and_grad_fn(obs, nv, **kw)(model.params, torch.as_tensor(x))
    ll_ref, g_ref = ref.loglik_and_grad(x, obs, nv)
    # the fp32 value of a sum of 451 squares of residuals whose scale is
    # the observation's: |Δ| within 1e-5 of |logL| + ½ Σ obs² / σ²
    scale = torch.abs(ll_ref) + 0.5 * float(np.sum(obs.astype(np.float64) ** 2)) / nv
    assert torch.max(torch.abs(ll.double() - ll_ref) / scale) < 1e-5
    rel = torch.linalg.vector_norm(g.double() - g_ref, dim=-1) / torch.linalg.vector_norm(
        g_ref, dim=-1)
    assert torch.median(rel) < 1e-4 and torch.max(rel) < 1e-2
    # the gradient is the derivative of the value, by central differences
    h = 1e-4 * (BOX[:, 1] - BOX[:, 0])
    for j in range(7):
        xp, xm = x[1:4].astype(np.float64).copy(), x[1:4].astype(np.float64).copy()
        xp[:, j] += h[j]
        xm[:, j] -= h[j]
        fd = (ref.loglik(xp, obs, nv) - ref.loglik(xm, obs, nv)) / (2 * h[j])
        assert torch.allclose(fd, g_ref[1:4, j], rtol=1e-3, atol=1e-3 * float(
            torch.max(torch.abs(g_ref[1:4]))))


def test_lower_precisions_round_as_stated():
    t = torch.tensor([1.0 + 2.0**-11, 1.0 + 2.0**-9, 3.14159265358979, -1e-3],
                     dtype=torch.float64)
    assert _round(t, "tf32")[0] == 1.0  # 10 stored mantissa bits: 2^-11 rounds away
    assert _round(t, "tf32")[1] == 1.0 + 2.0**-9
    assert _round(t, "bf16")[1] == 1.0  # 7 stored bits
    assert abs(float(_round(t, "fp8")[2]) - 3.14159265) < 3.14159265 * 2**-3
    errs = []
    ref = Reference(os.path.join(harness.ROOT, CKPT["direct"]), device="cpu")
    x = _rows(256, seed=4)
    want = ref.forward(x)
    for mode in MODES:
        got = ref.forward(x, mode)
        errs.append(float(torch.max(torch.abs(got - want) / torch.amax(
            torch.abs(want), dim=1, keepdim=True))))
    # each mode reads worse than the one above it
    assert errs == sorted(errs) and errs[0] == 0.0 and errs[2] > 30 * errs[1]
