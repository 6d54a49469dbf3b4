"""k3_roofline.members: the member-batched K3's share of its roofline in
the traced slice: the least time the chip could take for one launch over
all M members (M times one member's FLOPs over 989 TFLOP/s or its bytes,
the weights M times, over 3.35 TB/s, whichever is larger) over the
kernel's mean device time per launch, in percent."""

from port_bench.members import roofline_pct


def read(record):
    return roofline_pct(record, "k3")
