"""k2_roofline: K2's share of its roofline in the traced slice: the
least time the chip could take for one launch (the model's FLOPs over
989 TFLOP/s or its bytes over 3.35 TB/s, whichever is larger) over the
kernel's mean device time per launch, in percent."""

from port_bench.readers import roofline_pct


def read(record):
    return roofline_pct(record, "k2")
