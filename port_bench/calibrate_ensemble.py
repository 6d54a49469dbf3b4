"""The readings a deep-ensemble cell's limits are set from, on the chip at
the cell's own sizes, in one process:

    python3 port_bench/calibrate_ensemble.py --workload ensemble-hmc-65k --seeds 101 102 …

For each seed, as ``port_bench/calibrate.py`` reads a one-model sampler
cell: one sampler call's numbers against the float64 mixture
(:class:`~port_bench.reference_ensemble.MixtureReference`), the
control's (the mixture at the lower precision the cell's ``workloads``
file names, put in the program's place on the same walkers) and the
``draws_gap`` of walkers that never moved (uniform in the box, as a step
that returns its state unchanged leaves them). One JSON line per seed on
standard output, with spreads of the carried log-density's and the
gradient's errors.
"""

import os
import sys

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import argparse  # noqa: E402
import json  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from port_bench import harness  # noqa: E402
from port_bench.calibrate import _spread  # noqa: E402
from port_bench.reference import in_blocks, jacobian_logdet  # noqa: E402


def _grad_rel(g, g_ref):
    g = torch.as_tensor(g).double()
    return _spread(torch.linalg.vector_norm(g - g_ref, dim=-1)
                   / torch.linalg.vector_norm(g_ref, dim=-1))


def posterior_seed(ctx, drv, ctrl):
    st = drv.setup(ctx)
    drv.window(ctx, st, 0.0)
    drv.program_outputs(ctx, st)
    obs, out = st.obs, drv.outputs(st)
    drv.free_program(st)
    ref = drv.reference(ctx)
    box = torch.as_tensor(np.asarray(ctx.config["prior_box"], np.float32), dtype=torch.float64)
    lo, hi = box[:, 0], box[:, 1]
    nv = ctx.config["noise_var"]
    final = out["finals"][0]
    x = torch.as_tensor(final, dtype=torch.float64)
    lp = in_blocks(lambda r: ref.loglik(r, obs, nv), final) + jacobian_logdet(x, lo, hi)
    keep = drv.inside(x, lo, hi)
    control = drv.control_outputs(ctx, obs, out, ref, ctrl["mode"], ctrl["grad_mode"])
    _, g_ref = in_blocks(lambda r: ref.loglik_and_grad(r, obs, nv), final)
    detail = {
        "inside": float(keep.double().mean()),
        "abs_gap": _spread(torch.abs(torch.as_tensor(out["logps"][0]).double() - lp)[keep]),
        "control_abs_gap": _spread(
            torch.abs(torch.as_tensor(control["logps"][0]).double() - lp)[keep]),
        "grad_rel": _grad_rel(out["grads"][0], g_ref),
        "control_grad_rel": _grad_rel(control["grads"][0], g_ref),
    }
    rng = np.random.default_rng([ctx.seed, 99])
    b = np.asarray(ctx.config["prior_box"], np.float32)
    starts = (b[:, 0] + (b[:, 1] - b[:, 0]) * rng.uniform(
        size=(ctx.traffic["n_walkers"], b.shape[0]))).astype(np.float32)
    still = {"finals": [starts], "logps": [lp.numpy()], "chains": {0: starts[None]},
             "grads": {}}
    return {"program": drv.readings(ctx, obs, out, ref),
            "control": drv.readings(ctx, obs, control, ref),
            "unmoved_draws_gap": drv.readings(ctx, obs, still, ref)["draws_gap"],
            "detail": detail}


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("calibration runs on the chip", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctrl = harness._json(harness.ROOT, "port_bench", "workloads", a.workload + ".json")["control"]
    for seed in a.seeds:
        ctx = harness.load(a.workload, seed=seed, seconds=0.0, trace=False, device="cuda:0")
        print(json.dumps({"workload": a.workload, "seed": seed,
                          **posterior_seed(ctx, harness.generator(ctx), ctrl)}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
