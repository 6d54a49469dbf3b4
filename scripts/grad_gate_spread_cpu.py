#!/usr/bin/env python3
"""How much the gradient gate's statistics move between two roundings of
one tier pair on a deep network, on the CPU.

Run from the root of a checkout (no card needed; a few minutes at
65,536 rows):

    python3 scripts/grad_gate_spread_cpu.py [--pairs high/high,high/default]
        [--rows 4096] [--trials 3]

On chip_smoke's phase-22 network of hidden (256,)×12 (randomly
initialised from ``WIDE_ROUTES_SEED`` with the flagship checkpoint's
normalizer), for each (value, backward) tier pair of ``--pairs`` and
each of ``--trials`` draws of ``--rows`` prior rows, it computes the
wide route's gradient through its CPU emulation
(``tests/_torch_f32.py::emulate_wide``, the kernel's program op by op)
and the plain version's at the pair, and holds each against the plain
(fp32, fp32) gradient on the same weights: q99.9 and max of
``grad_rel_error``, the rows off by more than 1e-2, and
``grad_gate_beside``; and the gate between emulation and plain
(``grad_gate_violation``). One line per draw.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--pairs", default="high/high,high/default,default/highest")
    parser.add_argument("--rows", type=int, default=4096)
    parser.add_argument("--trials", type=int, default=3)
    args = parser.parse_args()
    import numpy as np
    import torch
    from _torch_f32 import emulate_wide

    import chip_smoke as smoke
    from tpu21cmvae_torch.data.synthetic import synthetic_params
    from tpu21cmvae_torch.models.direct import DirectEmulator
    from tpu21cmvae_torch.ops.kernels.fused_loglik import (
        loglik_grad_gram_reference,
        make_fused_loglik_grad_gram,
    )
    from tpu21cmvae_torch.utils.config import DirectEmulatorConfig
    from tpu21cmvae_torch.utils.metrics import (
        grad_gate_beside,
        grad_gate_violation,
        grad_rel_error,
    )

    torch.set_num_threads(4)
    norm = DirectEmulator.from_checkpoint(os.path.join(ROOT, smoke.CHECKPOINT),
                                          device="cpu").normalizer
    config = DirectEmulatorConfig(hidden_dims=smoke.WIDE_NETS["256x12"])
    net = DirectEmulator(config=config, normalizer=norm, seed=smoke.WIDE_ROUTES_SEED,
                         device="cpu")
    rng = np.random.default_rng(smoke.WIDE_ROUTES_SEED)
    obs = net.predict(synthetic_params(1, rng)[0]) + rng.normal(0.0, 5.0, config.n_bins)

    def operands(tiers):
        return make_fused_loglik_grad_gram(
            config, norm, obs, smoke.NOISE_VAR, precision=tiers[0], grad_precision=tiers[1],
            device="cpu").operands(net.params)

    exact = operands(("highest", "highest"))
    for pair in args.pairs.split(","):
        tiers = tuple(pair.split("/"))
        ops = operands(tiers)
        for trial in range(args.trials):
            x = torch.as_tensor(synthetic_params(args.rows, rng).astype(np.float32))
            x[0, 2] = 0.0
            ge = loglik_grad_gram_reference(exact, x)[1].numpy()
            gp = loglik_grad_gram_reference(ops, x)[1].numpy()
            gk = emulate_wide(ops, x)[1].numpy()
            rk, rp = grad_rel_error(gk, ge), grad_rel_error(gp, ge)
            print(f"{pair} rows={args.rows} trial={trial} "
                  f"q999_vs_exact emulation={np.quantile(rk, 0.999):.4f} "
                  f"plain={np.quantile(rp, 0.999):.4f} "
                  f"max_vs_exact emulation={rk.max():.4f} plain={rp.max():.4f} "
                  f"rows_off emulation={int((rk > 1e-2).sum())} plain={int((rp > 1e-2).sum())} "
                  f"grad_gate_beside={grad_gate_beside(gk, gp, ge):.4f} "
                  f"gate_emulation_vs_plain={grad_gate_violation(gk, gp):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
