"""mfu_pct.signals: the model's FLOPs of all the work in the traced slice over
the slice's wall time × 989 TFLOP/s, in percent."""

from port_bench.readers import mfu_pct


def read(record):
    if "signals" not in record["work"]:
        return None
    return mfu_pct(record)
