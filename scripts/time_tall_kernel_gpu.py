#!/usr/bin/env python3
"""Time K3 at a bf16 tier pair on the flagship checkpoint: the tall kernel
(``csrc/fused_gram_tall.cu``, 64-row wgmma tiles), the 16-row kernel it
takes over from (``csrc/fused_gram_mma.cu``), the plain version and the
bound, at the samplers' batches, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and
``nvcc``:

    python3 scripts/time_tall_kernel_gpu.py [--rows 4096,6144,8192,16384,32768,65536]
                                            [--tiers high/default,high/high]

Each kernel is launched directly (``fused_loglik._loglik_grad_gram_tall_cuda``
and ``fused_loglik._loglik_grad_gram_cuda``) on the operands one
``make_fused_loglik_grad_gram`` wrapper packed, so both run at every
batch whatever the wrapper's crossover. Times are device ms per call
over back-to-back calls (``chip_smoke.stream_ms``), the two kernels in
turns (16-row, tall, tall, 16-row), the plain version's one call between
two CUDA events (``chip_smoke.time_ms``), the bound
``chip_smoke.bound``. Prints one JSON line, keyed ``<value>-<backward>/<rows>``
with the wrapper's route for that batch, and the card's ``nvidia-smi``
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROWS = (4096, 6144, 8192, 16384, 32768, 65536)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rows", default=",".join(str(n) for n in ROWS))
    parser.add_argument("--tiers", default="high/default,high/high")
    args = parser.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import numpy as np
    import torch

    import chip_smoke as smoke
    from tpu21cmvae_torch.data.synthetic import synthetic_params
    from tpu21cmvae_torch.models.direct import DirectEmulator
    from tpu21cmvae_torch.ops.kernels import fused_loglik as fl
    from tpu21cmvae_torch.ops.fold import resolve_tier

    if not torch.cuda.is_available():
        print("time_tall_kernel_gpu: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    model = DirectEmulator.from_checkpoint(smoke.CHECKPOINT, device=dev)
    rng = np.random.default_rng(0)
    obs = model.predict(synthetic_params(1, rng)[0]) + rng.normal(0.0, 5.0, model.config.n_bins)
    widths = (model.config.n_params, *model.config.hidden_dims)
    out = {"torch": torch.__version__}
    for pair in args.tiers.split(","):
        tiers = tuple(pair.split("/"))
        fn = fl.make_fused_loglik_grad_gram(model.config, model.normalizer, obs, smoke.NOISE_VAR,
                                            precision=tiers[0], grad_precision=tiers[1],
                                            device=dev)
        ops = fn.operands(model.params)
        for n in (int(r) for r in args.rows.split(",")):
            x = smoke.rows(n, rng)
            reps = 50 if n <= 16384 else 20

            def tall():
                return fl._loglik_grad_gram_tall_cuda(ops, x, fn.tall_plan, fn.sm_count)

            def was():
                return fl._loglik_grad_gram_cuda(ops, x)

            t = [smoke.stream_ms(f, reps) for f in (was, tall, tall, was)]
            out[f"{tiers[0]}-{tiers[1]}/{n}"] = {
                "tall_ms": (t[1] + t[2]) / 2, "was_ms": (t[0] + t[3]) / 2,
                "plain_ms": smoke.time_ms(lambda: fl.loglik_grad_gram_reference(ops, x), 5),
                "bound_ms": smoke.bound("k3", widths, n, resolve_tier(tiers[0]),
                                        resolve_tier(tiers[1]))[0],
                "route": fn.batch_route(n), "turns": t,
            }
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(out), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
