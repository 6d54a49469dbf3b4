"""The deep ensemble's mixture against the benchmark's plain float64
mixture (``port_bench/reference_ensemble.py::MixtureReference``) on the
CPU: a seeded random three-member ensemble at small widths, saved with
``DeepEnsemble.save`` and read back by both; its likelihood, its value
and gradient, and HMC's carried log-density at its final walkers.

Tolerances, each relative to the gram form's cancellation scale ``|logL|
+ ½ Σ obs² / σ²`` (the mixture's logsumexp is 1-Lipschitz in the max
norm, so the members' bounds carry to it):

* fp32 (``precision="contract"``): 1e-7. A float32 sum of 451 squared
  residuals of the observation's size rounds at ~6e-8 of the scale at
  worst; these members read ~5e-9.
* bf16x3, the HMC value tier (``"high"``): 2e-6. Its three bf16 passes
  hold each product to ~2^-16 of its operands; these members read ~2e-7.
  The reference at bf16 (the cell's control, one bf16 pass) reads ~3e-5,
  so it fails both.
* The gradient at (bf16x3, bf16), HMC's pair: the median relative error
  within 1e-2 (bf16's 8 bits, 2^-8 ≈ 4e-3 per operand; ~2e-3 here) and
  the largest within 0.3 (a row near a ReLU edge flips a mask). The
  control's fp8 gradient reads a median of ~7e-2.
"""

import numpy as np
import pytest
import torch

from port_bench.reference import jacobian_logdet
from port_bench.reference_ensemble import MixtureReference
from tpu21cmvae_torch.data.synthetic import synthetic_dataset
from tpu21cmvae_torch.models.direct import DirectEmulator
from tpu21cmvae_torch.models.ensemble import DeepEnsemble
from tpu21cmvae_torch.utils.config import DirectEmulatorConfig

BOX = np.array([[1e-4, 0.5], [4.2, 100.0], [1e-4, 1000.0], [0.04, 0.09], [1.0, 1.5],
                [0.1, 3.0], [10.0, 50.0]])
NV = 25.0
VALUE_RTOL = {"contract": 1e-7, "high": 2e-6}
GRAD_MEDIAN, GRAD_MAX = 1e-2, 0.3


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A seeded random three-member ensemble at hidden (16, 12), saved and
    loaded back, its reference from the same files, and an observation
    drawn from the reference's mean signal."""
    torch.set_num_threads(1)
    data = synthetic_dataset(512, 64, 128, seed=7)
    ens = DeepEnsemble([DirectEmulator(data, config=DirectEmulatorConfig(hidden_dims=(16, 12)),
                                       seed=20 + i, device="cpu") for i in range(3)])
    directory = str(tmp_path_factory.mktemp("ensemble"))
    ens.save(directory)
    ens = DeepEnsemble.load(directory, device="cpu")
    ref = MixtureReference(directory, device="cpu")
    rng = np.random.default_rng(0)
    obs = (ref.forward(_rows(2, 1)[1:]).numpy()[0] + rng.normal(0, 5.0, 451)).astype(np.float32)
    return ens, ref, obs


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    x = (BOX[:, 0] + (BOX[:, 1] - BOX[:, 0]) * rng.uniform(size=(n, 7))).astype(np.float32)
    x[0, 2] = 0.0  # the log-clamp path
    return x


def _scale(ll, obs):
    return torch.abs(ll) + 0.5 * float(np.sum(obs.astype(np.float64) ** 2)) / NV


def _rel_gap(got, want, obs):
    return float(torch.max(torch.abs(torch.as_tensor(got).double() - want) / _scale(want, obs)))


def _grad_errs(g, g_ref):
    return (torch.linalg.vector_norm(torch.as_tensor(g).double() - g_ref, dim=-1)
            / torch.linalg.vector_norm(g_ref, dim=-1))


def test_the_reference_reads_every_member_and_their_mean(saved):
    ens, ref, _ = saved
    assert len(ref.members) == len(ens.members) == 3
    x = _rows(37, 2)
    got = ens.predict(x).astype(np.float64)
    want = ref.forward(x).numpy()
    # float32 through three layers: within 1e-5 of the amplitude
    assert np.max(np.abs(got - want)) < 1e-5 * np.max(np.abs(want))


@pytest.mark.parametrize("precision", ["contract", "high"])
def test_mixture_loglik_against_the_reference(saved, precision):
    ens, ref, obs = saved
    x = _rows(256, 3)
    got = ens.loglik_fn(obs, NV, precision=precision)(ens.params, torch.as_tensor(x))
    want = ref.loglik(x, obs, NV)
    assert _rel_gap(got, want, obs) < VALUE_RTOL[precision]
    assert _rel_gap(ref.loglik(x, obs, NV, "bf16"), want, obs) > VALUE_RTOL[precision]


def test_mixture_value_and_gradient_against_the_reference(saved):
    ens, ref, obs = saved
    x = _rows(256, 4)
    ll, g = ens.loglik_and_grad_fn(obs, NV, grad_precision="default")(ens.params,
                                                                      torch.as_tensor(x))
    ll_ref, g_ref = ref.loglik_and_grad(x, obs, NV)
    assert _rel_gap(ll, ll_ref, obs) < VALUE_RTOL["high"]
    errs = _grad_errs(g, g_ref)
    assert torch.median(errs) < GRAD_MEDIAN and torch.max(errs) < GRAD_MAX
    _, g_ctrl = ref.loglik_and_grad(x, obs, NV, "bf16", "fp8")
    assert torch.median(_grad_errs(g_ctrl, g_ref)) > GRAD_MEDIAN
    # the softmax-weighted gradient is the mixture's derivative, by central
    # differences in float64
    h = 1e-4 * (BOX[:, 1] - BOX[:, 0])
    for j in range(7):
        xp, xm = x[1:4].astype(np.float64).copy(), x[1:4].astype(np.float64).copy()
        xp[:, j] += h[j]
        xm[:, j] -= h[j]
        fd = (ref.loglik(xp, obs, NV) - ref.loglik(xm, obs, NV)) / (2 * h[j])
        assert torch.allclose(fd, g_ref[1:4, j], rtol=1e-3,
                              atol=1e-3 * float(torch.max(torch.abs(g_ref[1:4]))))


def test_hmc_carries_the_mixtures_log_density(saved):
    """HMC's carried log-density at its final walkers, less the sigmoid
    map's log-Jacobian, is the reference mixture's at those walkers (on
    walkers at least 1e-4 of the span inside the box, where the float32
    position still fixes the log-Jacobian)."""
    ens, ref, obs = saved
    box = BOX.astype(np.float32)
    res = ens.sample_posterior(obs, NV, sampler="hmc", bounds=box, n_walkers=64, n_warmup=10,
                               n_steps=5, seed=1)
    x = torch.as_tensor(res.final, dtype=torch.float64)
    lo, hi = torch.as_tensor(box, dtype=torch.float64).T
    f = (x - lo) / (hi - lo)
    inside = torch.all((f > 1e-4) & (f < 1 - 1e-4), dim=-1)
    assert bool(inside.any())
    jac = jacobian_logdet(x, lo, hi)
    carried = torch.as_tensor(res.logp, dtype=torch.float64)[inside]
    want = (ref.loglik(res.final, obs, NV) + jac)[inside]
    assert _rel_gap(carried, want, obs) < VALUE_RTOL["high"]
    control = (ref.loglik(res.final, obs, NV, "bf16") + jac)[inside]
    assert _rel_gap(control, want, obs) > VALUE_RTOL["high"]
