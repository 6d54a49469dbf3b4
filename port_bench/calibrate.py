"""The readings a cell's limits are set from, on the chip at the cell's
own sizes, in one process:

    python3 port_bench/calibrate.py --workload <cell> --seeds 1 2 3 … [--seconds S]

For each seed: the program's numbers (one sampler call, or ``--seconds``
of emulation calls), the control's (the reference at the lower precision
the cell's ``workloads`` file names, put in the program's place on the
same walkers or rows) and, for a sampler, the numbers of walkers that
never moved (uniform in the box, as a step that returns its state
unchanged leaves them). One JSON line per seed on standard output, with
spreads of the carried log-density's and the gradient's errors.
"""

import os
import sys

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import argparse  # noqa: E402
import json  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from port_bench import harness  # noqa: E402
from port_bench.reference import Reference, in_blocks, jacobian_logdet  # noqa: E402


def _spread(x):
    x = torch.as_tensor(x, dtype=torch.float64).flatten()
    return {"median": float(torch.median(x)), "q99": float(torch.quantile(x, 0.99)),
            "q999": float(torch.quantile(x, 0.999)), "max": float(torch.max(x))}


def posterior_seed(ctx, drv, ctrl):
    st = drv.setup(ctx)
    drv.window(ctx, st, 0.0)
    drv.program_outputs(ctx, st)
    obs, out = st.obs, drv.outputs(st)
    drv.free_program(st)
    ref = Reference(ctx.path(ctx.config["checkpoint"]), device=ctx.device)
    grad_sampler = ctx.traffic["sampler"] in drv.GRADIENT_SAMPLERS
    box = torch.as_tensor(np.asarray(ctx.config["prior_box"], np.float32), dtype=torch.float64)
    lo, hi = box[:, 0], box[:, 1]
    nv = ctx.config["noise_var"]
    final = out["finals"][0]
    ll = in_blocks(lambda x: ref.loglik(x, obs, nv), final)
    lp = ll + (jacobian_logdet(torch.as_tensor(final, dtype=torch.float64), lo, hi)
               if grad_sampler else 0.0)
    keep = (drv.inside(torch.as_tensor(final, dtype=torch.float64), lo, hi) if grad_sampler
            else torch.ones(final.shape[0], dtype=torch.bool))
    scale = torch.abs(ll) + 0.5 * float(np.sum(obs.astype(np.float64) ** 2)) / nv
    gap = torch.abs(torch.as_tensor(out["logps"][0]).double() - lp)
    detail = {"inside": float(keep.double().mean()),
              "abs_gap": _spread(gap[keep]), "rel_gap": _spread((gap / scale)[keep]),
              "ll_median": float(torch.median(ll)), "ll_max": float(torch.max(ll)),
              "obs_sq_half": float(0.5 * np.sum(obs.astype(np.float64) ** 2) / nv)}
    if grad_sampler:
        _, g_ref = in_blocks(lambda x: ref.loglik_and_grad(x, obs, nv), final)
        g = torch.as_tensor(out["grads"][0]).double()
        detail["grad_rel"] = _spread(torch.linalg.vector_norm(g - g_ref, dim=-1)
                                     / torch.linalg.vector_norm(g_ref, dim=-1))
    control = drv.control_outputs(ctx, obs, out, ref, ctrl["mode"], ctrl["grad_mode"])
    ctrl_lp = torch.as_tensor(control["logps"][0]).double()
    detail["control_abs_gap"] = _spread(torch.abs(ctrl_lp - lp)[keep])
    detail["control_rel_gap"] = _spread((torch.abs(ctrl_lp - lp) / scale)[keep])
    if grad_sampler:
        gc_ = torch.as_tensor(control["grads"][0]).double()
        detail["control_grad_rel"] = _spread(torch.linalg.vector_norm(gc_ - g_ref, dim=-1)
                                             / torch.linalg.vector_norm(g_ref, dim=-1))
    rng = np.random.default_rng([ctx.seed, 99])
    b = np.asarray(ctx.config["prior_box"], np.float32)
    starts = (b[:, 0] + (b[:, 1] - b[:, 0]) * rng.uniform(
        size=(ctx.traffic["n_walkers"], b.shape[0]))).astype(np.float32)
    still = {"finals": [starts], "logps": [lp.numpy()], "chains": {0: starts[None]},
             "grads": {}}
    unmoved = drv.readings(ctx, obs, still, ref)
    return {"program": drv.readings(ctx, obs, out, ref),
            "control": drv.readings(ctx, obs, control, ref),
            "unmoved_draws_gap": unmoved["draws_gap"], "detail": detail}


def emulate_seed(ctx, drv, ctrl):
    st = drv.setup(ctx)
    rec = drv.window(ctx, st, ctx.seconds)
    program, control = drv.check(ctx, st, control=ctrl)
    return {"calls": rec["calls"], "program": program, "control": control}


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("calibration runs on the chip", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in a.seeds:
        ctx = harness.load(a.workload, seed=seed, seconds=a.seconds, trace=False,
                           device="cuda:0")
        drv = harness.generator(ctx)
        ctrl = harness._json(harness.ROOT, "port_bench", "workloads",
                             a.workload + ".json")["control"]
        run = posterior_seed if ctx.traffic["generator"] == "posterior" else emulate_seed
        print(json.dumps({"workload": a.workload, "seed": seed, **run(ctx, drv, ctrl)}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
