"""Where the port's kernel wrappers refuse a network the JAX package runs.

The JAX package's fused kernels take any width: their weights sit in a
TPU core's VMEM under a 110 MB scoped limit
(``tpu21cmvae/ops/pallas/fused_loglik.py:69``), and on the CPU they run
in interpret mode at every width. The port's wrappers refuse, when they
are built, a network whose row tile does not fit an H100 block's shared
memory. This script builds every wrapper on the CPU (nothing is folded
or launched) over a grid of trunks and prints, per (kernel, tier, layer
count), the narrowest uniform hidden width (a multiple of 32, up to
4096) the port refuses, per kernel and tier the smallest fan-in (of 1 to
12, 160 and 4096, on the flagship's hidden widths and on (4096, 4096))
it refuses, and whether the shipped widths and (256,)×12 are taken; null
wherever nothing is refused.

    python3 scripts/port_refusals_cpu.py
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tpu21cmvae_torch.ops.kernels.fused_loglik import (  # noqa: E402
    make_fused_loglik,
    make_fused_loglik_grad_gram,
    make_fused_loglik_gram,
)
from tpu21cmvae_torch.ops.transforms import Normalizer  # noqa: E402
from tpu21cmvae_torch.utils.config import DirectEmulatorConfig  # noqa: E402

TIERS = ("highest", "high", "default")
LAYERS = (1, 2, 3, 4, 8)
WIDTHS = range(32, 4097, 32)
FAN_INS = (*range(1, 13), 160, 4096)


def builds(kernel, tiers, hidden, n_params=7) -> bool:
    """Whether the wrapper of ``kernel`` at ``tiers`` takes ``hidden`` after
    ``n_params`` inputs."""
    cfg = DirectEmulatorConfig(n_params=n_params, hidden_dims=hidden)
    norm = Normalizer(signal_mean=torch.zeros(cfg.n_bins), signal_std=torch.tensor(1.0),
                      par_min=torch.zeros(n_params), par_max=torch.ones(n_params))
    obs = np.zeros(cfg.n_bins, np.float32)
    try:
        if kernel == "K1":
            make_fused_loglik(cfg, norm, obs, precision=tiers[0], device="cpu")
        elif kernel == "K2":
            make_fused_loglik_gram(cfg, norm, obs, precision=tiers[0], device="cpu")
        else:
            make_fused_loglik_grad_gram(cfg, norm, obs, precision=tiers[0],
                                        grad_precision=tiers[1], device="cpu")
    except NotImplementedError:
        return False
    return True


def main() -> int:
    cases = [("K1", (t,)) for t in TIERS] + [("K2", (t,)) for t in TIERS]
    cases += [("K3", (a, b)) for a in TIERS for b in TIERS]
    out = {}
    for kernel, tiers in cases:
        key = f"{kernel} {'/'.join(tiers)}"
        out[key] = {}
        for layers in LAYERS:
            refused = next((w for w in WIDTHS if not builds(kernel, tiers, (w,) * layers)), None)
            out[key][layers] = refused
    shipped = [(288, 352, 288, 224), (256, 256, 128, 128, 128)]
    taken = {f"{k} {'/'.join(t)}": all(builds(k, t, h) for h in shipped) for k, t in cases}
    deep = {f"{k} {'/'.join(t)}": builds(k, t, (256,) * 12) for k, t in cases}
    fan_in = {f"{k} {'/'.join(t)}": next((n for n in FAN_INS for hidden in shipped[:1] + [
        (4096, 4096)] if not builds(k, t, hidden, n)), None) for k, t in cases}
    print(json.dumps({"narrowest_refused_uniform_width": out, "shipped_widths_taken": taken,
                      "deep_256x12_taken": deep, "smallest_refused_fan_in": fan_in}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
