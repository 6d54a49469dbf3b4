"""predict_ms_p95: the 95th percentile over every emulation call in the
window of its host-clock time from the call until its signals are ready."""

from port_bench.yardstick import quantile


def read(record):
    if "signals" not in record["work"]:
        return None
    return 1e3 * quantile(record["call_s"], 0.95)
