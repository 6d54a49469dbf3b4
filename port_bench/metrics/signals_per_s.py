"""signals_per_s: rows emulated by all calls in the window, over the
window's seconds."""


def read(record):
    signals = record["work"].get("signals")
    return None if signals is None else signals / record["window_s"]
