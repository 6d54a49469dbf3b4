#!/usr/bin/env python3
"""Time the exact-tier K3 (the fused gram value-and-gradient kernel at
value tier fp32 and backward tier fp32) through one tree's own wrappers,
on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and
``nvcc``:

    python3 scripts/time_grad_kernel_gpu.py [TREE] [--heights 64,32,16,8]
                                            [--rows 4096,65536]
                                            [--tiers high/default,high/high]
                                            [--hidden 3200,64,64] [--members 3]

TREE (default: this checkout) is the root of a tree of this repository,
for example a parent commit unpacked with ``git archive`` under
``build/``; its ``tpu21cmvae_torch`` and ``chip_smoke.py`` are imported
from there, so the kernel is built from its sources and timed by its own
``chip_smoke.time_ms`` (one wrapper call between two CUDA events,
median) and ``chip_smoke.stream_ms`` (device time per call over
back-to-back calls). On the flagship checkpoint with chip_smoke's
observation and noise (σ² = 25) at precision ("highest", "highest") (or
at each ``value/backward`` pair of ``--tiers``, keyed ``k3_value_backward``),
it times the kernel, as ``make_fused_loglik_grad_gram`` builds it, and its
plain version at 4096 rows (an HMC ensemble) and 65,536 rows (or the
batches of ``--rows``), and prints one JSON line and the card's
``nvidia-smi`` name and power limit. With ``--heights`` (a tree whose
``make_fused_loglik_grad_gram`` takes ``tile_rows=``) it also times the
device time per call of each forced tile height, in turns there and back.
With ``--hidden`` the network is not the checkpoint but one of those
hidden widths, randomly initialised from chip_smoke's ``WIDE_SEED`` with
the checkpoint's normalizer (``--hidden 3200,64,64``: K3's wide route);
with ``--members M`` it also times one member-batched launch over M such
networks (seeds ``WIDE_SEED`` + 1 … + M, keyed ``…_m<M>``) beside its
plain version. Run it for two trees in turns (a, b, b, a) to compare
them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROWS = (4096, 65_536)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("tree", nargs="?", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--heights", default="",
                        help="comma-separated tile heights to force, e.g. 64,32,16,8")
    parser.add_argument("--rows", default=",".join(str(n) for n in ROWS),
                        help="comma-separated batch sizes")
    parser.add_argument("--tiers", default="highest/highest",
                        help="comma-separated value/backward tier pairs")
    parser.add_argument("--hidden", default="",
                        help="comma-separated hidden widths of a seeded network, e.g. 3200,64,64")
    parser.add_argument("--members", type=int, default=0,
                        help="also time one member-batched launch of this many seeded networks")
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    heights = tuple(int(h) for h in args.heights.split(",") if h)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as smoke
    from tpu21cmvae_torch.data.synthetic import synthetic_params
    from tpu21cmvae_torch.models.direct import DirectEmulator
    from tpu21cmvae_torch.models.ensemble import DeepEnsemble
    from tpu21cmvae_torch.ops.kernels.fused_loglik import (
        loglik_grad_gram_members_reference,
        loglik_grad_gram_reference,
        make_fused_loglik_grad_gram,
    )
    from tpu21cmvae_torch.utils.config import DirectEmulatorConfig

    if not torch.cuda.is_available():
        print("time_grad_kernel_gpu: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    model = DirectEmulator.from_checkpoint(smoke.CHECKPOINT, device=dev)
    ens = None
    if args.hidden:
        config = DirectEmulatorConfig(hidden_dims=tuple(int(w) for w in args.hidden.split(",")))
        norm = model.normalizer
        model = DirectEmulator(config=config, normalizer=norm, seed=smoke.WIDE_SEED, device=dev)
        if args.members:
            ens = DeepEnsemble([DirectEmulator(config=config, normalizer=norm,
                                               seed=smoke.WIDE_SEED + 1 + i, device=dev)
                                for i in range(args.members)])
    rng = np.random.default_rng(0)
    truth = synthetic_params(1, rng)[0]
    obs = model.predict(truth) + rng.normal(0.0, 5.0, model.config.n_bins)

    def build(tiers=("highest", "highest"), **kw):
        return make_fused_loglik_grad_gram(model.config, model.normalizer, obs, smoke.NOISE_VAR,
                                           precision=tiers[0], grad_precision=tiers[1],
                                           device=dev, **kw)

    fns = {}  # key: (wrapper, its params, its plain version)
    for pair in args.tiers.split(","):
        tiers = tuple(pair.split("/"))
        key = "k3" if tiers == ("highest", "highest") else f"k3_{tiers[0]}_{tiers[1]}"
        fns[key] = (build(tiers), model.params, loglik_grad_gram_reference)
        if ens is not None:
            fns[f"{key}_m{args.members}"] = (
                build(tiers, members=args.members), ens.params,
                loglik_grad_gram_members_reference)
    forced = {h: build(tile_rows=h) for h in heights}
    out = {"tree": os.path.relpath(tree), "torch": torch.__version__,
           "hidden": list(model.config.hidden_dims)}
    for n in (int(n) for n in args.rows.split(",")):
        repeats = 50 if n <= 8192 else 20
        x = smoke.rows(n, rng)
        for key, (fn, params, plain) in fns.items():
            ops = fn.operands(params)
            out[f"{key}/{n}"] = {
                "kernel_ms": smoke.time_ms(lambda: fn(params, x), repeats),
                "kernel_stream_ms": smoke.stream_ms(lambda: fn(params, x), repeats),
                "plain_ms": smoke.time_ms(lambda: plain(ops, x), repeats),
            }
            if hasattr(fn, "rows_for"):
                out[f"{key}/{n}"]["tile_rows"] = fn.rows_for(n)
        turns = heights + heights[::-1]
        t = [smoke.stream_ms(lambda: forced[h](model.params, x), repeats) for h in turns]
        for i, h in enumerate(heights):
            out[f"k3@{h}/{n}"] = {"kernel_stream_ms": (t[i] + t[-1 - i]) / 2}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(out), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
