#!/usr/bin/env python3
"""Run phase 19 of ``chip_smoke.py`` alone on one CUDA card: build the
kernels, re-derive phase 5's truth and observation from the smoke's seed,
make phase 18's golden split, then ``chip_smoke.families_phase``. Every
failed check is printed and the run goes on, so one call shows them all;
the exit code is 1 if any failed.

    env PYTHONPATH=. python3 scripts/smoke_phase19_gpu.py

(Phase 5's observation in the whole smoke comes later in its generator's
stream, so the two runs score different observations of the same
truth.)
"""

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
    print(smi, flush=True)
    t0 = time.perf_counter()
    cs._build.build()
    cs._build.load_library()
    print(f"built in {time.perf_counter() - t0:.2f} s", flush=True)
    dev = torch.device("cuda")
    model = cs.DirectEmulator.from_checkpoint(cs.CHECKPOINT, device=dev)
    rng = np.random.default_rng(0)
    truth = cs.synthetic_params(1, rng)[0]
    obs = model.predict(truth) + rng.normal(0.0, 5.0, model.config.n_bins)
    cs.families_phase(truth, obs, cs.synthetic_dataset(**cs.TRAIN_SPLIT), dev, smi)
    print("failed checks:", fails, flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
