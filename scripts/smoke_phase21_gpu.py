#!/usr/bin/env python3
"""Run phase 21 of ``chip_smoke.py`` alone on one CUDA card: build the
kernels, re-derive phase 5's truth and observation from the smoke's
seed, then ``chip_smoke.mesh_phase``: HMC and MH on ``Mesh([cuda:0,
cuda:0])`` against the unsharded chains, the fp32 K3's halves, two
gloo processes on the card (MH and ``dp_fit``), the tuner, and the
likelihoods and entry points on ``Mesh([cuda:0, cpu])``. Every
failed check is printed and the run goes on where it can, so one call
shows them all; the exit code is 1 if any failed.

    env PYTHONPATH=. python3 scripts/smoke_phase21_gpu.py

(Phase 5's observation in the whole smoke comes later in its generator's
stream, so the two runs score different observations of the same
truth.)
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    fails = []

    def check(ok, what):
        if not ok:
            fails.append(what)
            print("CHECK FAILED:", what, flush=True)

    cs.check = check
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, f"torch {torch.__version__} (CUDA {torch.version.cuda})", flush=True)
    t0 = time.perf_counter()
    cs._build.build()
    cs._build.load_library()
    print(f"built in {time.perf_counter() - t0:.2f} s", flush=True)
    dev = torch.device("cuda")
    model = cs.DirectEmulator.from_checkpoint(cs.CHECKPOINT, device=dev)
    rng = np.random.default_rng(0)
    truth = cs.synthetic_params(1, rng)[0]
    obs = model.predict(truth) + rng.normal(0.0, 5.0, model.config.n_bins)
    launches, ranks = cs.mesh_phase(model, obs, dev, smi)
    print(json.dumps({"launches_mesh": launches, "launches_mesh_ranks": ranks}), flush=True)
    print("failed checks:", fails, flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
