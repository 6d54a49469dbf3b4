#!/usr/bin/env python3
"""Time the exact-tier value kernels, K1 as the direct likelihood (sum
of squares) and K2, through one tree's own wrappers, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and
``nvcc``:

    python3 scripts/time_value_kernels_gpu.py [TREE] [--precision highest,high,default]

TREE (default: this checkout) is the root of a tree of this repository,
for example a parent commit unpacked with ``git archive`` under
``build/``; its ``tpu21cmvae_torch`` and ``chip_smoke.py`` are imported
from there, so the kernels are built from its sources and timed by its
own ``chip_smoke.time_ms`` (one wrapper call between two CUDA events,
median) and ``chip_smoke.stream_ms`` (device time per call over
back-to-back calls). On the flagship checkpoint with chip_smoke's
observation and noise (σ² = 25) at precision ``"highest"`` (or at each
tier of ``--precision``; a tier other than ``"highest"`` keyed
``k1_sumsq@tier`` and ``k2@tier``), it times both kernels at 409,600
rows (each sampler chain's draws) and 1,048,576 rows, and prints one
JSON line and the card's ``nvidia-smi`` name and
power limit. Run it for two trees in turns (a, b, b, a) to compare them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROWS = ((409_600, 5), (1_048_576, 3))  # (rows, repeats)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("tree", nargs="?", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--precision", default="highest", help="comma-separated tiers")
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as smoke
    from tpu21cmvae_torch.data.synthetic import synthetic_params
    from tpu21cmvae_torch.models.direct import DirectEmulator

    if not torch.cuda.is_available():
        print("time_value_kernels_gpu: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    model = DirectEmulator.from_checkpoint(smoke.CHECKPOINT, device=dev)
    rng = np.random.default_rng(0)
    truth = synthetic_params(1, rng)[0]
    obs = model.predict(truth) + rng.normal(0.0, 5.0, model.config.n_bins)
    tiers = args.precision.split(",")
    pairs = {t: smoke.value_kernels(model, obs, t, dev)[0] for t in tiers}
    out = {"tree": os.path.relpath(tree), "torch": torch.__version__}
    for n, repeats in ROWS:
        x = smoke.rows(n, rng)
        for tier, key in ((t, k) for t in tiers for k in ("k1_sumsq", "k2")):
            kernel = pairs[tier][key][0]
            name = key if tier == "highest" else f"{key}@{tier}"
            with torch.no_grad():
                out[f"{name}/{n}"] = {
                    "kernel_ms": smoke.time_ms(lambda: kernel(x), repeats, warmup=1),
                    "kernel_stream_ms": smoke.stream_ms(lambda: kernel(x), repeats),
                }
        del x
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(out), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
