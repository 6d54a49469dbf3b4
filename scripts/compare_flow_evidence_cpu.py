#!/usr/bin/env python3
"""The flow evidence of both packages on the flagship checkpoint, on the
CPU: ``DirectEmulator.log_evidence(method="flow")`` of the JAX package
(``tpu21cmvae``) and of the port (``tpu21cmvae_torch``) at the JAX
defaults (a 400-step ADVI warm start, 1500 ELBO steps × 256 draws of a
6-layer, 64-wide RealNVP flow, 16,384 importance draws), on the
observation ``chip_smoke.py`` phases 5-17 use, for each of ``--seeds``.
``--fp32-fit`` adds the port with its fit on the exact-tier gradient
(``loglik_and_grad_fn(precision="contract")``): the port's plain route
on the CPU runs the card's tiers, bf16x3 values and a single-pass bf16
backward, where JAX's XLA route on the CPU computes in fp32.
``--jax-draws`` adds the port fed every normal draw JAX's run takes from
its keys (the ADVI warm start's ``split(key(seed), 400)``, the couplings'
first weights from ``split(key(seed))[0]``, the fit's ``split(k_fit,
1500)``, the sweep's ``key(seed + 1)``), through the port's draw seam
``tpu21cmvae_torch.vi._normal``: what is left between the two is
arithmetic, not the random streams.

The observation is rebuilt by replaying the smoke's NumPy draws up to
phase 5 (the truth, the first observation's noise, phases 3-4's test
rows, phase 5's predict batch, then phase 5's noise); its sum and first
bin are printed beside those phase 17 prints. Each estimate is printed
as one JSON line, then the differences between the packages against
their combined standard errors. Needs both packages and JAX on the CPU:

    JAX_PLATFORMS=cpu python3 scripts/compare_flow_evidence_cpu.py [--seeds 0 1]
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


def smoke_observation(predict):
    """Phase 5's observation of ``chip_smoke.py``: the same generator,
    advanced through the same draws."""
    from chip_smoke import K3_F32_HEIGHTS, TIER_PAIRS
    from tpu21cmvae_torch.data.synthetic import synthetic_params

    rng = np.random.default_rng(0)
    truth = synthetic_params(1, rng)[0]
    rng.normal(0.0, 5.0, 451)  # the observation of phases 3-4
    for _ in range(len(TIER_PAIRS) + len(K3_F32_HEIGHTS)):  # phase 3's held batches
        for n in (1, 37, 4096, 65537):
            synthetic_params(n, rng)
    for _ in TIER_PAIRS:  # phase 4's timing rows, then its tile heights'
        for n in (4096, 65536):
            synthetic_params(n, rng)
    for n in (4096, 65536):
        synthetic_params(n, rng)
    synthetic_params(4096, rng)  # phase 5's predict batch
    return truth, predict(truth) + rng.normal(0.0, 5.0, 451)


def jax_flow_draws(seed, n_params=7, warm=400, n_steps=1500, n_mc=256, n_layers=6,
                   width=64, n_is=16384):
    """Every normal draw of the JAX package's ``log_evidence(method="flow",
    seed=seed)`` at the defaults, in the order the port takes them."""
    import jax
    import jax.numpy as jnp

    draws = [jax.random.normal(k, (n_mc, n_params), jnp.float32)
             for k in jax.random.split(jax.random.key(seed), warm)]
    key, k_fit = jax.random.split(jax.random.key(seed))
    for _ in range(n_layers):
        key, k1 = jax.random.split(key)
        draws.append(jax.random.normal(k1, (n_params, width), jnp.float32))
    draws += [jax.random.normal(k, (n_mc, n_params), jnp.float32)
              for k in jax.random.split(k_fit, n_steps)]
    draws.append(jax.random.normal(jax.random.key(seed + 1), (n_is, n_params), jnp.float32))
    return [np.array(d) for d in draws]


def on_jax_draws(seed, run):
    """``run()`` with the port's normal draws replaced by JAX's."""
    import torch

    import tpu21cmvae_torch.vi as vi

    queue = jax_flow_draws(seed)
    real = vi._normal

    def fed(gen, shape):
        d = queue.pop(0)
        assert d.shape == tuple(shape), (d.shape, shape)
        return torch.as_tensor(d, device=gen.device)

    vi._normal = fed
    try:
        out = run()
    finally:
        vi._normal = real
    assert not queue, len(queue)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0])
    parser.add_argument("--fp32-fit", action="store_true")
    parser.add_argument("--jax-draws", action="store_true")
    args = parser.parse_args()

    import torch

    from chip_smoke import CHECKPOINT, NOISE_VAR
    from tpu21cmvae.models.direct import DirectEmulator as JaxEmulator
    from tpu21cmvae_torch.models.direct import DirectEmulator

    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    port = DirectEmulator.from_checkpoint(CHECKPOINT, device="cpu")
    jax_model = JaxEmulator.from_checkpoint(CHECKPOINT)
    truth, obs = smoke_observation(port.predict)
    print(json.dumps({"obs_sum": float(np.sum(obs)), "obs_0": float(obs[0]),
                      "truth": truth.tolist()}), flush=True)
    from tpu21cmvae_torch.flows import evidence_with_flow

    runs = [("jax", lambda seed: jax_model.log_evidence(obs, NOISE_VAR, method="flow",
                                                         seed=seed)),
            ("port", lambda seed: port.log_evidence(obs, NOISE_VAR, method="flow", seed=seed))]
    if args.fp32_fit:
        runs.append(("port_fp32_fit", lambda seed: evidence_with_flow(
            port.loglik_fn(obs, NOISE_VAR, precision="contract"),
            port.loglik_and_grad_fn(obs, NOISE_VAR, precision="contract"), port.params,
            seed=seed, device="cpu")))
    if args.jax_draws:
        runs.append(("port_on_jax_draws", lambda seed: on_jax_draws(
            seed, lambda: port.log_evidence(obs, NOISE_VAR, method="flow", seed=seed))))
    rows = {}
    for seed in args.seeds:
        for name, run in runs:
            t0 = time.perf_counter()
            res = run(seed)
            wall = time.perf_counter() - t0
            rows[(name, seed)] = res
            elbo = np.asarray(res.flow.elbo)
            print(json.dumps({"package": name, "seed": seed, "logz": res.logz,
                              "logz_err": res.logz_err, "khat": res.khat, "is_ess": res.is_ess,
                              "elbo_tail_mean": float(elbo[-100:].mean()),
                              "median": np.median(res.posterior(4096, seed=1), 0).tolist(),
                              "wall_s": wall}), flush=True)
        a, b = rows[("jax", seed)], rows[("port", seed)]
        err = math.hypot(a.logz_err, b.logz_err)
        print(json.dumps({"seed": seed, "port_minus_jax": b.logz - a.logz,
                          "combined_err": err, "within_err": abs(b.logz - a.logz) <= err,
                          "within_4err": abs(b.logz - a.logz) <= 4 * err}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
