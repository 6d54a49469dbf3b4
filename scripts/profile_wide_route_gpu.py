#!/usr/bin/env python3
"""Where K3's wide route (``csrc/fused_loglik_grad_gram.cu``) spends its
time, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and
``nvcc``:

    python3 scripts/profile_wide_route_gpu.py [--rows 65536] [--hidden 3200,64,64]

On a network of ``--hidden`` randomly initialised from chip_smoke's
``WIDE_SEED`` with the flagship checkpoint's normalizer, at (fp32, fp32)
and (bf16x3, fp32), at every tile height the route is built for, it
times the device time per call (``chip_smoke.stream_ms``) of the kernel
running its whole op program, and of the kernel running the program
stripped of one kind of op at a time (``no_skinny``, ``no_fin``,
``no_dx``, ``no_gram``) or of every op but the products (``mm_only``):
the stripped runs compute nothing right, but the difference from the
whole program is what that kind of op costs. Prints one JSON line and
the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rows", type=int, default=65_536)
    parser.add_argument("--hidden", default="3200,64,64")
    args = parser.parse_args()
    import numpy as np
    import torch

    import chip_smoke as smoke
    from tpu21cmvae_torch.data.synthetic import synthetic_params
    from tpu21cmvae_torch.models.direct import DirectEmulator
    from tpu21cmvae_torch.ops.kernels import fused_loglik, wide
    from tpu21cmvae_torch.utils.config import DirectEmulatorConfig

    if not torch.cuda.is_available():
        print("profile_wide_route_gpu: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    norm = DirectEmulator.from_checkpoint(smoke.CHECKPOINT, device=dev).normalizer
    config = DirectEmulatorConfig(hidden_dims=tuple(int(w) for w in args.hidden.split(",")))
    net = DirectEmulator(config=config, normalizer=norm, seed=smoke.WIDE_SEED, device=dev)
    rng = np.random.default_rng(0)
    obs = net.predict(synthetic_params(1, rng)[0]) + rng.normal(0.0, 5.0, config.n_bins)
    x = smoke.rows(args.rows, rng)
    out = {"hidden": list(config.hidden_dims), "rows": args.rows}
    for tiers in (("highest", "highest"), ("high", "highest")):
        fn = smoke.k3_wrapper(net, obs, tiers, dev)
        ops = fn.operands(net.params)
        table = ops.program.cpu()
        codes = table[:, 0]
        keep = {"full": torch.ones_like(codes, dtype=torch.bool)}
        for name, code in (("no_skinny", wide.OP_SKINNY), ("no_fin", wide.OP_FIN),
                           ("no_dx", wide.OP_DX), ("no_gram", wide.OP_GRAM)):
            keep[name] = codes != code
        keep["mm_only"] = ((codes == wide.OP_MM) | (codes == wide.OP_RING)
                           | (codes == wide.OP_DX_WRITE))
        for name, kept in keep.items():
            # the C entry takes the program's length from the plan
            route = fused_loglik.WideLaunch(fn.plan._replace(ops=fn.plan.ops[:int(kept.sum())]),
                                            True, fn.sm_count, dev)
            stripped = dataclasses.replace(ops, program=table[kept].contiguous().to(dev))
            for h in fn.heights:
                out[f"{tiers[0]}/{tiers[1]}@{h}/{name}"] = smoke.stream_ms(
                    lambda: route(stripped, x, h), 10)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(out), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
