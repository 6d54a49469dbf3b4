"""What the per-layer metrics share: the port's kernels found by name in
the traced slice, their roofline shares, and the model's work in the
slice.

The names are the CUDA kernels' own, as the profiler reports them
(demangled, or mangled where it does not demangle). The wide route's
kernel serves K1, K2 and K3 alike and runs on no network of the
benchmark, so it is none of these.
"""

from __future__ import annotations

import re
from typing import Optional

from port_bench import yardstick

KERNELS = {
    "k1": re.compile(r"fused_mlp_kernel|fused_mlp_mma_kernel"),
    "k2": re.compile(r"fused_loglik_gram_kernel|fused_gram_mma_kernel(<\d+, ?0>|ILi\d+ELi0E)"),
    "k3": re.compile(r"fused_loglik_grad_gram_f32_kernel|fused_gram_mixed_kernel"
                     r"|fused_gram_mma_kernel(<\d+, ?[1-9]\d*>|ILi\d+ELi[1-9]\d*E)"),
}


def launches(record: dict, kernel: str) -> list:
    """Durations in seconds of every launch of ``kernel`` in the slice."""
    pat = KERNELS[kernel]
    return [(e - s) * 1e-9 for name, s, e, kind in record.get("trace", {}).get("device", [])
            if kind == "kernel" and pat.search(name)]


def rows_per_launch(record: dict, kernel: str, n_launches: int) -> float:
    """Rows in one launch: K1's are the slice's emulated rows over its
    launches; K2's and K3's the sampler's batch (one launch per
    likelihood call)."""
    if kernel == "k1":
        return record["trace"]["rows_value"] / n_launches
    return record["rows_per_launch"]


def roofline_pct(record: dict, kernel: str) -> Optional[float]:
    """The least time the chip could take over the kernel's mean device
    time per launch in the slice, in percent; None where it did not run."""
    times = launches(record, kernel)
    if not times:
        return None
    rows = rows_per_launch(record, kernel, len(times))
    least = yardstick.least_seconds(record["config"], kernel, rows)
    return 100.0 * least * len(times) / sum(times)


def slice_seconds(record: dict) -> Optional[float]:
    tr = record.get("trace")
    return None if not tr else (tr["hi_ns"] - tr["lo_ns"]) * 1e-9


def model_flops(record: dict) -> float:
    """The model's FLOPs of all the work in the slice: every row a
    likelihood or an emulation call was asked for, a forward pass each,
    twice that with the gradient (the rows the benchmark counted around
    its calls into the program, whatever ran them)."""
    tr = record["trace"]
    per_row = 2.0 * yardstick.macs_per_row(record["config"])
    return per_row * (tr["rows_value"] + 2 * tr["rows_valgrad"])


def mfu_pct(record: dict) -> Optional[float]:
    span = slice_seconds(record)
    if not span:
        return None
    flops = model_flops(record)
    return 100.0 * flops / (span * yardstick.PEAK_FLOPS) if flops else None


def busy_seconds(record: dict) -> float:
    """Seconds of the slice in which the device ran a kernel, copy or fill."""
    tr = record["trace"]
    return yardstick.union_seconds([(s, e) for _, s, e, _ in tr["device"]], tr["lo_ns"],
                                   tr["hi_ns"])


def idle_pct(record: dict) -> Optional[float]:
    """The share of the slice in which the device ran nothing, in percent."""
    tr = record.get("trace")
    if not tr or not tr["device"]:
        return None
    return 100.0 * (1.0 - busy_seconds(record) / slice_seconds(record))
