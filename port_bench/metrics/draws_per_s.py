"""draws_per_s: post-warm-up walker iterations (walkers × n_steps per
sampler call) completed in the window, over the window's seconds."""


def read(record):
    draws = record["work"].get("draws")
    return None if draws is None else draws / record["window_s"]
