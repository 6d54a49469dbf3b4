"""device_idle_pct.signals: the share of the traced slice in which the device
ran no kernel, copy or fill, in percent."""

from port_bench.readers import idle_pct


def read(record):
    if "signals" not in record["work"]:
        return None
    return idle_pct(record)
