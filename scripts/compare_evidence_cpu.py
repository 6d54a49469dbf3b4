#!/usr/bin/env python3
"""The SMC and ladder evidences of both packages on the flagship
checkpoint, on the CPU: ``DirectEmulator.log_evidence(method="smc")`` and
``(method="ladder")`` of the JAX package (``tpu21cmvae``) and of the port
(``tpu21cmvae_torch``) at the JAX defaults (SMC: 4096 particles, 8 MH
moves per stage; the ladder: 32 rungs × 256 walkers, 200 + 400 steps,
from a warm start of ``fit_params`` 1024 × 500), on the observation
``chip_smoke.py`` phases 5-17 use (σ² = 25 mK²), for each of ``--seeds``.

It tells whether a gap between the card's estimate and the importance
witness of ``chip_smoke.py`` phase 12 is the port's or the estimator's:
if both packages land at the same log Z within their seed spread, the
estimator itself sits there. Each estimate is printed as one JSON line;
then, per method, each package's mean and seed standard deviation over
the seeds, the port's mean minus JAX's, and their combined spread
(√(sd_jax² + sd_port²)). Needs both packages and JAX on the CPU:

    JAX_PLATFORMS=cpu python3 scripts/compare_evidence_cpu.py [--seeds 0 1 2]
        [--methods smc ladder]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    parser.add_argument("--methods", nargs="+", default=["smc", "ladder"],
                        choices=["smc", "ladder"])
    args = parser.parse_args()

    import torch

    from chip_smoke import CHECKPOINT, NOISE_VAR
    from compare_flow_evidence_cpu import smoke_observation
    from tpu21cmvae.models.direct import DirectEmulator as JaxEmulator
    from tpu21cmvae_torch.models.direct import DirectEmulator

    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    port = DirectEmulator.from_checkpoint(CHECKPOINT, device="cpu")
    jax_model = JaxEmulator.from_checkpoint(CHECKPOINT)
    truth, obs = smoke_observation(port.predict)
    print(json.dumps({"obs_sum": float(np.sum(obs)), "obs_0": float(obs[0]),
                      "truth": truth.tolist()}), flush=True)

    models = {"jax": jax_model, "port": port}
    logz = {}
    for method in args.methods:
        for seed in args.seeds:
            for name, model in models.items():
                t0 = time.perf_counter()
                res = model.log_evidence(obs, NOISE_VAR, method=method, seed=seed)
                wall = time.perf_counter() - t0
                logz.setdefault((method, name), []).append(float(res.logz))
                print(json.dumps({"method": method, "package": name, "seed": seed,
                                  "logz": float(res.logz),
                                  "logz_err": float(getattr(res, "logz_err", float("nan"))),
                                  "wall_s": wall}), flush=True)
        stats = {}
        for name in models:
            vals = np.asarray(logz[(method, name)])
            stats[name] = (float(vals.mean()), float(vals.std(ddof=1)) if vals.size > 1 else 0.0)
        spread = math.hypot(stats["jax"][1], stats["port"][1])
        diff = stats["port"][0] - stats["jax"][0]
        print(json.dumps({"method": method, "jax_mean": stats["jax"][0],
                          "jax_sd": stats["jax"][1], "port_mean": stats["port"][0],
                          "port_sd": stats["port"][1], "port_minus_jax": diff,
                          "combined_spread": spread, "within_spread": abs(diff) <= spread}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
