#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit (``nvcc``):

    python3 chip_smoke.py

Phases, one line each:

1. require a CUDA device; pin TF32 off for matmuls and convolutions;
   print the card's ``nvidia-smi`` name and power limit;
2. build the port's CUDA kernels from ``tpu21cmvae_torch/ops/kernels/csrc``;
3. hold K3 (the fused gram value-and-gradient kernel) against its plain
   PyTorch version on the card, at the flagship widths of
   ``pretrained/direct_synthetic.npz``, for batches 1, 37, 4096 and
   65,537 and three tier pairs;
4. time K3 and its plain version at 4096 and 65,536 rows (CUDA events,
   warmup excluded, median of repeats);
5. the main path through the public entry points: load the checkpoint,
   predict (held to a float64 NumPy forward of the same file), and sample
   a posterior with HMC, whose every leapfrog step runs K3.

Then one JSON line per kernel, and a last line
``{"ok": true, "device": {...}}``. Any failed check raises and the
script exits non-zero without that line; it also exits non-zero, with
no result, where no CUDA device is present.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from tpu21cmvae_torch.data.synthetic import synthetic_params
from tpu21cmvae_torch.models.direct import DirectEmulator
from tpu21cmvae_torch.ops.kernels import _build
from tpu21cmvae_torch.ops.kernels.fused_loglik import (
    loglik_grad_gram_reference,
    make_fused_loglik_grad_gram,
)
from tpu21cmvae_torch.utils.metrics import grad_gate_violation, grad_rel_error

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(ROOT, "pretrained", "direct_synthetic.npz")
K3_SOURCE = "tpu21cmvae_torch/ops/kernels/csrc/fused_loglik_grad_gram.cu"
K3_REPLACES = "tpu21cmvae/ops/pallas/fused_loglik.py:401"
TIER_PAIRS = (("highest", "highest"), ("high", "high"), ("high", "default"))
MAIN_TIERS = ("high", "default")  # what sample_posterior runs K3 at
NOISE_VAR = 25.0
# Value tolerance, kernel vs plain: |Δ logL| ≤ rtol·(|logL| + c/2) + 1e-2
# nats. Both compute the same products and differ only in summation
# order. The gram form sums quad = ‖r‖² − c from terms of size ~c (c =
# b·b of the folded output layer, ~2.5·10⁴ for the observation here), so
# its rounding scales with |logL| + c/2, not with |logL|: near the mode
# |logL| ≪ c/2. At an fp32 value tier rtol is 1e-5. At the bf16 tiers an
# ulp of difference in an activation can move its bf16-rounded part (lo =
# bf16_rn(a − hi), or bf16_rn(a)) by one bf16 step, ~2⁷ ulps, on elements
# at a rounding boundary: two summation orders of the same plain version
# differ by up to 1.3e-5 of that scale on the CPU, so rtol is 1e-4 there.
VALUE_RTOL = {"highest": 1e-5, "high": 1e-4, "default": 1e-4}
VALUE_ATOL = 1e-2
GRAD_Q999_F32 = 1e-4  # q99.9 of per-row gradient error at (highest, highest)


def check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def numpy_forward(path: str, raw: np.ndarray) -> np.ndarray:
    """The checkpoint's signals in float64 NumPy: its own reading of the
    file (leaf order: Normalizer fields, then each layer's b, w)."""
    with np.load(path) as data:
        header = json.loads(bytes(data["__header__"]).decode())
        leaves = [data[f"leaf_{i}"].astype(np.float64) for i in range(header["n_leaves"])]
    mean, std, pmin, pmax = leaves[:4]
    layers = [(leaves[i + 1], leaves[i]) for i in range(4, len(leaves), 2)]
    x = np.asarray(raw, np.float64).copy()
    x[:, 2] = np.where(x[:, 2] == 0.0, 1e-6, x[:, 2])
    x[:, :3] = np.log10(x[:, :3])
    h = 2.0 * (x - pmin) / (pmax - pmin) - 1.0
    for i, (w, b) in enumerate(layers):
        h = h @ w + b
        if i < len(layers) - 1:
            h = np.maximum(h, 0.0)
    return h * std + mean


def rows(n: int, rng) -> torch.Tensor:
    """n prior draws with an fx == 0 row first (the log-clamp path)."""
    x = synthetic_params(n, rng).astype(np.float32)
    x[0, 2] = 0.0
    return torch.as_tensor(x, device="cuda")


def time_ms(fn, repeats: int, warmup: int = 3) -> float:
    """Median device time of one call (CUDA events), warmup excluded."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main() -> int:
    # -- phase 1: device ----------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"phase 1: torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"{torch.cuda.get_device_name(0)}; allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    print(smi, flush=True)

    # -- phase 2: build -----------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"phase 2: built {os.path.relpath(lib_path, ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    dev = torch.device("cuda")
    model = DirectEmulator.from_checkpoint(CHECKPOINT, device=dev)
    rng = np.random.default_rng(0)
    truth = synthetic_params(1, rng)[0]
    obs = model.predict(truth) + rng.normal(0.0, 5.0, model.config.n_bins)

    # -- phase 3: kernel vs plain at flagship widths ------------------------
    wrappers = {
        tiers: make_fused_loglik_grad_gram(
            model.config, model.normalizer, obs, NOISE_VAR,
            precision=tiers[0], grad_precision=tiers[1], device=dev,
        )
        for tiers in TIER_PAIRS
    }
    report = {}
    main_err = None
    for tiers, fn in wrappers.items():
        ops = fn.operands(model.params)
        for n in (1, 37, 4096, 65537):
            x = rows(n, rng)
            vk, gk = fn(model.params, x)
            vp, gp = loglik_grad_gram_reference(ops, x)
            torch.cuda.synchronize()
            vk, gk, vp, gp = (t.cpu().numpy() for t in (vk, gk, vp, gp))
            check(vk.shape == (n,) and gk.shape == (n, 7), f"shapes {tiers} n={n}")
            check(bool(np.isfinite(vk).all() and np.isfinite(gk).all()),
                  f"finite {tiers} n={n}")
            tol = VALUE_RTOL[tiers[0]] * (np.abs(vp) + 0.5 * abs(float(ops.c))) + VALUE_ATOL
            dv = np.abs(vk - vp)
            check(bool((dv <= tol).all()),
                  f"value {tiers} n={n}: worst |Δ|/tol {float((dv / tol).max()):.3g}")
            check(gk[0, 2] == 0.0, f"fx == 0 gradient slot {tiers} n={n}: {gk[0, 2]}")
            rel = grad_rel_error(gk, gp)
            q999 = float(np.quantile(rel, 0.999))
            gate = grad_gate_violation(gk, gp)
            check(gate <= 0.0, f"gradient gate {tiers} n={n}: {gate:.3g}")
            if tiers == ("highest", "highest"):
                check(q999 <= GRAD_Q999_F32, f"gradient q99.9 {tiers} n={n}: {q999:.3g}")
            report[f"{tiers[0]}/{tiers[1]}/{n}"] = {
                "value_max_abs": float(dv.max()),
                "value_worst_over_tol": float((dv / tol).max()),
                "grad_q999_rel": q999,
                "grad_max_rel": float(rel.max()),
            }
            if tiers == MAIN_TIERS and n == 4096:
                main_err = float(dv.max())
    torch.cuda.synchronize()
    print(f"phase 3: kernel == plain within tolerance at every batch and tier "
          f"pair {json.dumps(report)}", flush=True)

    # -- phase 4: timing ----------------------------------------------------
    timings = {}
    for tiers, fn in wrappers.items():
        ops = fn.operands(model.params)
        for n, repeats in ((4096, 50), (65536, 20)):
            x = rows(n, rng)
            kernel_ms = time_ms(lambda: fn(model.params, x), repeats)
            plain_ms = time_ms(lambda: loglik_grad_gram_reference(ops, x), repeats)
            timings[f"{tiers[0]}/{tiers[1]}/{n}"] = {
                "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            }
    torch.cuda.synchronize()
    print(f"phase 4: median ms per call {json.dumps(timings)}", flush=True)

    # -- phase 5: the main path ---------------------------------------------
    t0 = time.perf_counter()
    model = DirectEmulator.from_checkpoint(CHECKPOINT, device=dev)
    one = model.predict(truth)
    batch = synthetic_params(4096, rng)
    batch[0, 2] = 0.0
    many = model.predict(batch)
    ref_one = numpy_forward(CHECKPOINT, truth[None])[0]
    ref_many = numpy_forward(CHECKPOINT, batch)
    err_one = float(np.abs(one - ref_one).max() / np.abs(ref_one).max())
    err_many = float(np.abs(many - ref_many).max() / np.abs(ref_many).max())
    check(one.shape == (451,) and many.shape == (4096, 451), "predict shapes")
    check(err_one <= 1e-5 and err_many <= 1e-5,
          f"predict vs float64 forward: {err_one:.3g}, {err_many:.3g}")
    obs = one + rng.normal(0.0, 5.0, 451)
    n_warmup, n_steps = 100, 200
    valgrad = model.loglik_and_grad_fn(obs, NOISE_VAR, backend="kernel",
                                       grad_precision=MAIN_TIERS[1])
    valgrad.launches = 0
    torch.cuda.synchronize()
    t_hmc = time.perf_counter()
    res = model.sample_posterior(obs, NOISE_VAR, sampler="hmc", n_walkers=4096,
                                 n_warmup=n_warmup, n_steps=n_steps)
    torch.cuda.synchronize()
    hmc_s = time.perf_counter() - t_hmc
    launches = valgrad.launches
    check(model.loglik_and_grad_fn(obs, NOISE_VAR, backend="kernel",
                                   grad_precision=MAIN_TIERS[1]) is valgrad,
          "sample_posterior used the memoized K3 wrapper")
    check(launches >= n_warmup + n_steps,
          f"K3 launches {launches} < {n_warmup + n_steps}")
    check(bool(np.isfinite(res.chain).all() and np.isfinite(res.logp).all()),
          "finite chains")
    check(res.chain.shape == (n_steps // 5, 4096, 7), f"chain shape {res.chain.shape}")
    acc = float(np.mean(res.accept_rate))
    check(0.3 <= acc <= 0.99, f"mean acceptance {acc:.3f}")
    flat = res.flat
    mean, sd = flat.mean(0), flat.std(0)
    # The truth must be a typical posterior point. Per parameter: inside
    # the pooled chain's central 99.9 %. In likelihood: the share of
    # draws scoring at least logL(truth) (exact tier) inside [0.001,
    # 0.999] — the truth's rank among the draws, as simulation-based
    # calibration reads it. (|mean − truth|/sd is printed, not gated: at
    # these sampler settings a share of walkers stays far from the mode
    # and drags the mean, in the JAX sampler as in this one.)
    lo_q, hi_q = np.quantile(flat, [0.0005, 0.9995], axis=0)
    check(bool(((truth >= lo_q) & (truth <= hi_q)).all()),
          f"truth inside the central 99.9 % of every marginal: {lo_q} {hi_q}")
    exact = model.loglik_fn(obs, NOISE_VAR, precision="contract")
    ll_draws = exact(model.params, torch.as_tensor(flat, device=dev)).cpu().numpy()
    ll_truth = float(exact(model.params, torch.as_tensor(truth, dtype=torch.float32,
                                                         device=dev))[0])
    share = float(np.mean(ll_draws >= ll_truth))
    check(0.001 <= share <= 0.999, f"likelihood rank of the truth {share:.4f}")
    print("phase 5: " + json.dumps({
        "predict_rel_err": [err_one, err_many],
        "truth": truth.tolist(), "mean": mean.tolist(), "sd": sd.tolist(),
        "z": (np.abs(mean - truth) / sd).tolist(),
        "truth_rank": np.mean(flat < truth, axis=0).tolist(),
        "loglik_truth": ll_truth, "share_at_least_truth": share,
        "loglik_draws_max": float(ll_draws.max()),
        "rhat_max": float(res.rhat().max()),
        "accept": acc, "step_size": res.step_size, "k3_launches": launches,
        "hmc_wall_s": hmc_s, "phase_wall_s": time.perf_counter() - t0,
    }), flush=True)

    main_t = timings[f"{MAIN_TIERS[0]}/{MAIN_TIERS[1]}/4096"]
    print(json.dumps({"kernels": [{
        "name": "fused_loglik_grad_gram",
        "route": "cuda",
        "source": K3_SOURCE,
        "replaces": K3_REPLACES,
        "launches": launches,
        "max_abs_err": main_err,
        "ms": main_t["kernel_ms"],
        "plain_ms": main_t["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
