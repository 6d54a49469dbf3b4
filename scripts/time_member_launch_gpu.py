#!/usr/bin/env python3
"""Time every route of K1, K2 and K3 through one tree's own wrappers, on
one NVIDIA GPU: one model's launch and, for a tree whose wrappers take
``members=``, one member-batched launch of the shipped three-member
ensemble beside its three single launches.

Run from the root of a checkout, on a machine with a CUDA card and
``nvcc``:

    python3 scripts/time_member_launch_gpu.py [TREE] [--rows 256,4096,8192]

TREE (default: this checkout) is the root of a tree of this repository,
for example a parent commit unpacked with ``git archive`` under
``build/``; its ``tpu21cmvae_torch`` and ``chip_smoke.py`` are imported
from there, so the kernels are built from its sources and timed by its
own ``chip_smoke.time_ms`` (one wrapper call between two CUDA events,
median) and ``chip_smoke.stream_ms`` (device time per call over
back-to-back calls). The routes: K1 as the direct likelihood (sumsq) at
fp32 (``fused_mlp.cu``) and bf16x3 (``fused_mlp_mma.cu``), K2 at fp32
(``fused_loglik_gram.cu``) and bf16x3 (``fused_gram_mma.cu``), K3 at
(high, default) (``fused_gram_mma.cu``), (fp32, fp32)
(``fused_loglik_grad_gram_f32.cu``) and (fp32, bf16)
(``fused_gram_mixed.cu``), on the members of
``pretrained/ensemble_direct`` (flagship widths) with chip_smoke's noise
(σ² = 25). Prints one JSON line and the card's ``nvidia-smi`` name and
power limit. Run it for two trees in turns (a, b, b, a) to compare them.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

ROWS = (256, 4096, 8192)
ROUTES = {  # route: (kernel, value tier, backward tier)
    "k1/highest": ("k1", "highest", None),
    "k1/high": ("k1", "high", None),
    "k2/highest": ("k2", "highest", None),
    "k2/high": ("k2", "high", None),
    "k3/high/default": ("k3", "high", "default"),
    "k3/highest/highest": ("k3", "highest", "highest"),
    "k3/highest/default": ("k3", "highest", "default"),
}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("tree", nargs="?", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--rows", default=",".join(str(n) for n in ROWS),
                        help="comma-separated batch sizes")
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as smoke
    from tpu21cmvae_torch.data.synthetic import synthetic_params
    from tpu21cmvae_torch.models.ensemble import DeepEnsemble
    from tpu21cmvae_torch.ops.kernels.fused_loglik import (
        make_fused_loglik,
        make_fused_loglik_grad_gram,
        make_fused_loglik_gram,
    )

    if not torch.cuda.is_available():
        print("time_member_launch_gpu: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    ens = DeepEnsemble.load(os.path.join(tree, "pretrained", "ensemble_direct"), device=dev)
    rng = np.random.default_rng(0)
    truth = synthetic_params(1, rng)[0]
    obs = ens.members[0].predict(truth) + rng.normal(0.0, 5.0, ens.config.n_bins)
    batched_ok = "members" in inspect.signature(make_fused_loglik_gram).parameters

    def build(route, **kw):
        kernel, tier, grad = route
        common = (ens.config, ens.normalizer, obs, smoke.NOISE_VAR)
        if kernel == "k1":
            return make_fused_loglik(*common, precision=tier, device=dev, **kw)
        if kernel == "k2":
            return make_fused_loglik_gram(*common, precision=tier, device=dev, **kw)
        return make_fused_loglik_grad_gram(*common, precision=tier, grad_precision=grad,
                                           device=dev, **kw)

    views = [m.params for m in ens.members]
    out = {"tree": os.path.relpath(tree), "torch": torch.__version__}
    for name, route in ROUTES.items():
        singles = [build(route) for _ in views]
        batched = build(route, members=len(views)) if batched_ok else None
        for n in (int(n) for n in args.rows.split(",")):
            x = smoke.rows(n, rng)
            repeats = 30

            def one():
                return singles[0](views[0], x)

            entry = {"kernel_ms": smoke.time_ms(one, repeats),
                     "kernel_stream_ms": smoke.stream_ms(one, repeats)}
            if batched is not None:
                def three():
                    return [f(p, x) for f, p in zip(singles, views)]

                def m3():
                    return batched(ens.params, x)

                entry.update({
                    "m3_kernel_ms": smoke.time_ms(m3, repeats),
                    "m3_kernel_stream_ms": smoke.stream_ms(m3, repeats),
                    "single3_ms": smoke.time_ms(three, repeats),
                    "single3_stream_ms": smoke.stream_ms(three, repeats)})
            out[f"{name}/{n}"] = entry
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(out), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
