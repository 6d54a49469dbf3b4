"""kernels_per_iter.draws: device kernels of every kind in the traced
slice (one whole sampler call) over the sampler iterations in it
(warm-up and kept)."""


def read(record):
    tr = record.get("trace")
    if not tr or "draws" not in record["work"]:
        return None
    n = sum(1 for *_, kind in tr["device"] if kind == "kernel")
    return n / tr["iterations"] if n else None
