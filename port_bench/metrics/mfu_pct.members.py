"""mfu_pct.members: M members' FLOPs of all the work in the traced slice
(every row its likelihood calls were asked for, a forward and a backward
pass each per member) over the slice's wall time × 989 TFLOP/s, in
percent."""

from port_bench.members import mfu_pct


def read(record):
    if "draws" not in record["work"]:
        return None
    return mfu_pct(record)
