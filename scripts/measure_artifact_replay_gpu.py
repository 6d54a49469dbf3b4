#!/usr/bin/env python3
"""Measure how far a ``torch.export`` artifact's replay lies from the
in-process plain function, on one CUDA card and on the host CPU, beside
the limits ``tpu21cmvae_torch.deploy`` holds it to at export.

On ``pretrained/direct_synthetic.npz`` and one observation (a prior
draw's prediction plus 5 mK of noise, σ² = 25), for predict, loglik and
valgrad at the fp32 tier and at bf16x3: export on the card (which runs
the export check on both platforms), then replay on the CPU, on the
card, and on the card with TF32 products switched on, each against the
in-process plain function on the card, on deploy's five probe rows and
on 4096 prior draws. Prints one JSON object per case as worst |Δ| over
deploy's limit (≤ 1 passes), then the card's name and power limit, and
writes everything to ``chiprun_out/artifact_replay.json``.

    env PYTHONPATH=. python3 scripts/measure_artifact_replay_gpu.py
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

from tpu21cmvae_torch import deploy
from tpu21cmvae_torch.data.synthetic import synthetic_params
from tpu21cmvae_torch.models import load_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(ROOT, "pretrained", "direct_synthetic.npz")
NOISE_VAR = 25.0


def replay(program, x, device, tf32: bool):
    mod = deploy._move(program, device).module()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        with torch.no_grad():
            return deploy._to_host(mod(x.to(device)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    model = load_model(CHECKPOINT, device=dev)
    rng = np.random.default_rng(0)
    truth = synthetic_params(1, rng)[0].astype(np.float32)
    obs = (model.predict(truth) + rng.normal(0.0, 5.0, model.config.n_bins)).astype(np.float32)
    rows = {"probe": deploy._probe(7, dev),
            "prior_4096": torch.as_tensor(synthetic_params(4096, rng).astype(np.float32),
                                          device=dev)}
    cases = []
    for tier in ("contract", "high"):
        cases += [
            ("predict", tier, deploy.export_predict(model, precision=tier),
             model.predict_fn(precision=tier), deploy._Gate("predict", deploy.resolve_tier(tier))),
            ("loglik", tier, deploy.export_loglik(model, obs, NOISE_VAR, precision=tier),
             model.loglik_fn(obs, NOISE_VAR, memo=False, precision=tier),
             deploy._loglik_gate(model, "loglik", obs, NOISE_VAR, {"precision": tier})),
            ("valgrad", tier, deploy.export_valgrad(model, obs, NOISE_VAR, precision=tier),
             model.loglik_and_grad_fn(obs, NOISE_VAR, memo=False, precision=tier),
             deploy._loglik_gate(model, "valgrad", obs, NOISE_VAR, {"precision": tier})),
        ]
    out = {"value_scale_s": deploy._value_scale(obs, NOISE_VAR), "cases": []}
    for kind, tier, exported, fn, gate in cases:
        rec = {"kind": kind, "tier": tier, "platforms": list(exported.platforms)}
        for label, x in rows.items():
            with torch.no_grad():
                want = deploy._to_host(fn(model.params, x))
            for name, device, tf32 in (("cpu", "cpu", False), ("cuda", "cuda", False),
                                       ("cuda_tf32", "cuda", True)):
                got = replay(exported.program, x, device, tf32)
                rec[f"{label}/{name}"] = deploy._replay_worst(got, want, gate)
                rec[f"{label}/{name}/max_abs"] = float(np.abs(got[0] - want[0]).max())
        out["cases"].append(rec)
        print(json.dumps(rec), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    out["card"] = smi
    out["torch"] = torch.__version__
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "artifact_replay.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
