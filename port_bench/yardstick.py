"""The benchmark's yardstick: the H100's published peaks, the model's work
and bytes per row counted from a configuration's widths, and the
statistics the metrics share.

The work is the model's, never an implementation's: a forward pass is
two FLOPs per multiply-add of every layer to the ``n_bins`` outputs, a
gradient adds the backward to the inputs (the same products again), each
product is counted once whatever tier or fold runs it, and a gram head
that replaces the output layer is not counted. So every implementation
of the same call reads the same work, and no share can pass 100 %.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit.
PEAK_FLOPS = 989e12  # bf16 tensor cores: the highest dense rate the model's work can run at
PEAK_BYTES = 3.35e12  # HBM3

K_EVALS = {"k1": 1, "k2": 1, "k3": 2}  # forward passes' worth of products per row


def layer_widths(config: dict) -> list:
    """``[(fan_in, fan_out), …]`` of every layer from parameters to signal,
    in order: the direct emulator's one MLP, or the autoencoder-based
    emulator's params → latent MLP followed by its decoder."""
    if config["family"] == "direct":
        sizes = [config["n_params"], *config["hidden_dims"], config["n_bins"]]
        return list(zip(sizes[:-1], sizes[1:]))
    if config["family"] == "autoencoder":
        em = [config["n_params"], *config["em_hidden_dims"], config["latent_dim"]]
        dec = [config["latent_dim"], *config["dec_hidden_dims"], config["n_bins"]]
        return list(zip(em[:-1], em[1:])) + list(zip(dec[:-1], dec[1:]))
    raise ValueError(f"unknown family {config['family']!r}")


def macs_per_row(config: dict) -> int:
    """Multiply-adds of one forward pass of one row (370,304 for the
    flagship, 501,440 for the autoencoder-based emulator)."""
    return sum(a * b for a, b in layer_widths(config))


def weight_bytes(config: dict) -> int:
    """The model's float32 weights and biases, each byte once."""
    return 4 * sum(a * b + b for a, b in layer_widths(config))


def kernel_flops(config: dict, kernel: str, rows: int) -> float:
    """The model's FLOPs of one call of ``kernel`` over ``rows``: K1 and
    K2 a forward pass, K3 a forward and the backward to the inputs."""
    return 2.0 * K_EVALS[kernel] * macs_per_row(config) * rows


def kernel_bytes(config: dict, kernel: str, rows: int) -> float:
    """Bytes one call must move, each input and output byte once: the
    parameter rows in, K1's signals / K2's value / K3's value and
    gradient out, and the weights."""
    n_in, n_bins = config["n_params"], config["n_bins"]
    out = {"k1": n_bins, "k2": 1, "k3": 1 + n_in}[kernel]
    return 4.0 * rows * (n_in + out) + weight_bytes(config)


def least_seconds(config: dict, kernel: str, rows: int) -> float:
    """The least time the chip could take for one call: the larger of the
    model's FLOPs over the peak and the bytes over the bandwidth."""
    return max(kernel_flops(config, kernel, rows) / PEAK_FLOPS,
               kernel_bytes(config, kernel, rows) / PEAK_BYTES)


def quantile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q`` quantile (0 ≤ q ≤ 1) by linear interpolation between
    the order statistics (the 'inclusive' method); None when empty."""
    xs = sorted(values)
    if not xs:
        return None
    pos = q * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_seconds(intervals, lo_ns: int, hi_ns: int) -> float:
    """Seconds of ``[lo_ns, hi_ns]`` covered by the union of
    ``(start_ns, end_ns)`` intervals."""
    covered, cur_s, cur_e = 0, None, None
    for s, e in sorted((max(s, lo_ns), min(e, hi_ns)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                covered += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        covered += cur_e - cur_s
    return covered * 1e-9
