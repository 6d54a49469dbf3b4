"""The yardstick of a deep ensemble (a configuration of ``"family":
"ensemble"``): M members of the direct emulator's widths, whose work in a
member-batched launch, or in a slice, is M times one member's, counted
from the configuration as :mod:`port_bench.yardstick` counts one model's,
whatever implements the launch. Each reader returns None for a
configuration of another family, or where the slice holds nothing to
read."""

from __future__ import annotations

from typing import Optional

from port_bench import readers, yardstick


def member_config(config: dict) -> Optional[dict]:
    """One member's configuration (the direct emulator's widths), or None
    for a configuration that is no ensemble."""
    return dict(config, family="direct") if config.get("family") == "ensemble" else None


def least_seconds(config: dict, kernel: str, rows: int) -> float:
    """The least time the chip could take for one member-batched call of
    ``kernel`` over ``rows`` rows of each member: M members' FLOPs over
    the peak or their bytes (the weights M times) over the bandwidth,
    whichever is larger."""
    return config["members"] * yardstick.least_seconds(member_config(config), kernel, rows)


def roofline_pct(record: dict, kernel: str) -> Optional[float]:
    """The least time of one member-batched launch over the kernel's mean
    device time per launch in the slice, in percent."""
    if member_config(record["config"]) is None:
        return None
    times = readers.launches(record, kernel)
    if not times:
        return None
    least = least_seconds(record["config"], kernel, record["rows_per_launch"])
    return 100.0 * least * len(times) / sum(times)


def mfu_pct(record: dict) -> Optional[float]:
    """M members' FLOPs of every row the slice's likelihood calls were
    asked for (a forward pass each, twice that with the gradient) over the
    slice's time at 989 TFLOP/s, in percent."""
    member = member_config(record["config"])
    span = readers.slice_seconds(record)
    if member is None or not span:
        return None
    tr = record["trace"]
    flops = (record["config"]["members"] * 2.0 * yardstick.macs_per_row(member)
             * (tr["rows_value"] + 2 * tr["rows_valgrad"]))
    return 100.0 * flops / (span * yardstick.PEAK_FLOPS) if flops else None
