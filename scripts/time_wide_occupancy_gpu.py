#!/usr/bin/env python3
"""What holds the wide route's K2 back on hidden (1536,)×3 at bf16x3,
on one NVIDIA GPU: its plan's tile height and CTAs per SM, or its grid.

Run from the root of a checkout, on a machine with a CUDA card and
``nvcc``:

    python3 scripts/time_wide_occupancy_gpu.py [--budgets 110000]

On chip_smoke's phase-22 network (hidden (1536,)×3 randomly initialised
from ``WIDE_ROUTES_SEED`` with the flagship checkpoint's normalizer),
it launches the wide route's operands directly
(``fused_loglik.WideLaunch``) and times the device time per call
(``chip_smoke.stream_ms``) at 4096 and 65,536 rows, in turns (a, b, b,
a), of:

- ``k2``: K2 at bf16x3 on the wrappers' plan (the full shared-memory
  budget: everything held in shared memory, 16-row tiles, one CTA per
  row tile, the CTAs per SM the card's shared memory allows);
- ``k2@B``: K2 at bf16x3 on the plan under a shared-memory budget of B
  bytes (each of ``--budgets``): vectors spilled to the workspace, the
  tile height and CTAs per SM that buys, on the persistent grid;
- ``k2@B/16``: the same plan at 16-row tiles;
- ``k2@B/grid``: the same plan at its tallest height on one CTA per row
  tile (a workspace region for each), not on the persistent grid;
- ``k3``: K3 at (bf16x3, bf16), the samplers' pair, on the wrappers'
  plan.

Each plan is printed with its heights, shared bytes, resident CTAs and
spilled vectors; every K2 plan's values are checked bit for bit against
the wrappers' plan's (no placement or height moves a sum). Prints one
JSON line and the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROWS = ((4096, 20), (65_536, 5))  # (rows, calls per timing)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--budgets", default="110000", help="comma-separated bytes")
    args = parser.parse_args()
    import numpy as np
    import torch

    import chip_smoke as smoke
    from tpu21cmvae_torch.data.synthetic import synthetic_params
    from tpu21cmvae_torch.models.direct import DirectEmulator
    from tpu21cmvae_torch.ops.kernels import fused_loglik, wide
    from tpu21cmvae_torch.utils.config import DirectEmulatorConfig

    if not torch.cuda.is_available():
        print("time_wide_occupancy_gpu: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    norm = DirectEmulator.from_checkpoint(smoke.CHECKPOINT, device=dev).normalizer
    config = DirectEmulatorConfig(hidden_dims=smoke.WIDE_NETS["1536x3"])
    net = DirectEmulator(config=config, normalizer=norm, seed=smoke.WIDE_ROUTES_SEED, device=dev)
    rng = np.random.default_rng(0)
    obs = net.predict(synthetic_params(1, rng)[0]) + rng.normal(0.0, 5.0, config.n_bins)

    k2 = smoke.wide_route_call(net, obs, ("high", None), dev)
    k3 = smoke.wide_route_call(net, obs, ("high", "default"), dev)
    base = dataclasses.replace(k2[1], slabs=None, packed=None, program=None, frags=None)
    calls, plans = {}, {}

    def describe(plan):
        return {"heights": list(plan.heights),
                "shared_bytes": [wide.plan_bytes(plan, h) for h in plan.heights],
                "resident_ctas": [wide.resident_ctas(plan, h, sms) for h in plan.heights],
                "spilled": sorted(map(list, plan.spilled)), "ws_cols": plan.ws_cols}

    calls["k2"], plans["k2"] = k2[3], describe(k2[2].plan)
    calls["k3"], plans["k3"] = k3[3], describe(k3[2].plan)
    for budget in map(int, args.budgets.split(",")):
        ops = fused_loglik.pack_wide_operands(base, budget)
        route = fused_loglik.WideLaunch(fused_loglik.ops_plan(base, budget), False, sms, dev)
        plans[f"k2@{budget}"] = describe(route.plan)
        for h in route.plan.heights:
            key = f"k2@{budget}" if h == route.plan.heights[0] else f"k2@{budget}/{h}"
            calls[key] = lambda x, ops=ops, route=route, h=h: route(ops, x, h)
        # one CTA per row tile, each with a region of its own
        h = route.plan.heights[0]
        tiles = fused_loglik.WideLaunch(route.plan, False, sms, dev)
        tiles.workspace = torch.empty(-(-ROWS[-1][0] // h) * wide.ws_cta_bytes(route.plan, h),
                                      dtype=torch.uint8, device=dev)
        calls[f"k2@{budget}/grid"] = lambda x, ops=ops, tiles=tiles, h=h: tiles(
            ops, x, h, ctas=-(-x.shape[0] // h))

    out = {"hidden": list(config.hidden_dims), "plans": plans, "bit_for_bit": {}}
    for n, reps in ROWS:
        x = smoke.rows(n, rng)
        want = calls["k2"](x)
        for key, call in calls.items():
            if key.startswith("k2@"):
                out["bit_for_bit"][f"{key}@{n}"] = bool(torch.equal(call(x), want))
        for key, call in calls.items():
            if key == "k2":
                continue
            turns = [smoke.stream_ms(lambda c=c: c(x), reps)
                     for c in (calls["k2"], call, call, calls["k2"])]
            out[f"{key}@{n}"] = {"ms": turns[1:3], "k2_ms": [turns[0], turns[3]]}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(out), flush=True)
    print(smi, flush=True)
    return 0 if all(out["bit_for_bit"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
