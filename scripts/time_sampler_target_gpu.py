#!/usr/bin/env python3
"""Host time per likelihood call of the samplers' targets on one NVIDIA
GPU, under the diagonal noise spec and the marginalized one, with and
without a prior.

The samplers of ``tpu21cmvae_torch`` wait on the host, so what a noise
spec or a prior costs them is the small launches it adds per call, not
kernel time. This script times, at the flagship checkpoint and the
samplers' batches, one call of

* HMC's whitened target (``sampling/gradient.py::_whitened_target`` over
  the K3 wrapper, 4096 rows), and
* the gradient-free samplers' box score (``sampling/mh.py::_box_score``
  over the K2 wrapper, 8192 rows),

for the diagonal spec (σ² = 25) and for
``marginalize_noise_scale(marginalize_foreground(25.0), alpha=3, beta=2)``,
each with and without a Gaussian prior on tau, and the prior's own calls
(its value; its value and autograd gradient). Each figure is the host's
clock over back-to-back calls (``host_us``: until the last call returns;
``wall_us``: until the device is idle), after a warmup; it also counts
the device kernels per call with ``torch.profiler``.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit:

    python3 scripts/time_sampler_target_gpu.py [--calls 300]

It prints the card's name and power limit and one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tpu21cmvae_torch.data.synthetic import synthetic_params  # noqa: E402
from tpu21cmvae_torch.foregrounds import linlog_basis  # noqa: E402
from tpu21cmvae_torch.models.direct import DirectEmulator  # noqa: E402
from tpu21cmvae_torch.noisescale import marginalize_noise_scale  # noqa: E402
from tpu21cmvae_torch.priors import GaussianBoxPrior  # noqa: E402
from tpu21cmvae_torch.sampling import gradient, mh  # noqa: E402
from tpu21cmvae_torch.sampling._common import (  # noqa: E402
    _log_prior_val_grad,
    _resolve_bounds,
    _resolve_log_prior,
)

CHECKPOINT = os.path.join(ROOT, "pretrained", "direct_synthetic.npz")
FG_COEFFS = (1500.0, -120.0, 40.0, -8.0, 2.0)


def bench(fn, calls: int) -> dict:
    """Host µs per call over ``calls`` back-to-back calls, until the last
    returns and until the device is idle, after 20 warmup calls."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return {"host_us": 1e6 * host / calls, "wall_us": 1e6 * (time.perf_counter() - t0) / calls}


def device_kernels_per_call(fn, calls: int = 20) -> float:
    """Device kernels launched per call, counted by ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    launched = sum(e.count for e in prof.key_averages()
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx"))
    return launched / calls


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--calls", type=int, default=300, help="timed calls per case")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_sampler_target_gpu: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0], flush=True)

    model = DirectEmulator.from_checkpoint(CHECKPOINT, device=dev)
    rng = np.random.default_rng(0)
    truth = synthetic_params(1, rng)[0]
    signal = model.predict(truth)
    obs = signal + rng.normal(0.0, 5.0, 451)
    obs_fg = (signal + linlog_basis(model.frequencies, 5) @ np.asarray(FG_COEFFS)
              + rng.normal(0.0, 5.0, 451)).astype(np.float32)
    spec = marginalize_noise_scale(model.marginalize_foreground(25.0, n_terms=5),
                                   alpha=3.0, beta=2.0)
    prior = GaussianBoxPrior.for_params({3: (float(truth[3]), 0.006)})
    lo, hi = _resolve_bounds(None, dev)

    def draws(n):
        return torch.as_tensor(synthetic_params(n, rng).astype(np.float32), device=dev)

    x_hmc, x_mh = draws(4096), draws(8192)
    y = gradient._whiten_init(x_hmc, lo, hi - lo)
    cases = {}
    for name, o, nv in (("diagonal", obs, 25.0), ("marginalized", obs_fg, spec)):
        k3 = model.loglik_and_grad_fn(o, nv, backend="kernel", grad_precision="default")
        k2 = model.loglik_fn(o, nv, backend="kernel")
        cases[f"k3_wrapper/{name}"] = lambda k3=k3: k3(model.params, x_hmc)
        for label, log_prior in (("flat", None), ("tau_prior", prior.log_prior)):
            _, target = gradient._whitened_target(k3, log_prior, lo, hi - lo)
            score = mh._box_score(k2, _resolve_log_prior(log_prior), lo, hi)
            cases[f"hmc_target/{name}/{label}"] = lambda target=target: target(model.params, y)
            cases[f"box_score/{name}/{label}"] = torch.no_grad()(
                lambda score=score: score(model.params, x_mh))
    cases["prior_value"] = lambda: prior.log_prior(x_hmc)
    cases["prior_value_and_autograd_gradient"] = lambda: _log_prior_val_grad(
        prior.log_prior, x_hmc)

    # every timing first: once the profiler has run, its hooks stay in the
    # process and slow each later launch
    out = {name: bench(fn, args.calls) for name, fn in cases.items()}
    for name, fn in cases.items():
        out[name]["device_kernels_per_call"] = device_kernels_per_call(fn)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
