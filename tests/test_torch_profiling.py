"""The port's profiling utilities (``tpu21cmvae_torch.utils.profiling``)
on the CPU: timing, a trace with a named region, the roofline prices
against ``chip_smoke.py::bound``'s, and the NaN trap."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from tpu21cmvae_torch.utils import profiling


def test_benchmark_times_every_call():
    calls = []
    res = profiling.benchmark(lambda x: calls.append(x), 3, iters=5, warmup=2,
                              items_per_call=10, name="noop")
    assert len(calls) == 7 and len(res.times_s) == 5
    assert res.name == "noop" and res.items_per_sec > 0 and "noop" in res.summary()
    assert res.min_s <= res.mean_s and res.std_s >= 0


def test_annotate_inside_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("t21_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = glob.glob(os.path.join(str(tmp_path), "trace_*.json"))
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "t21_region" in names


def test_device_memory_stats_is_none_on_the_cpu():
    assert profiling.device_memory_stats("cpu") is None


def test_flop_prices_match_the_smoke_bound():
    """The products per row ``chip_smoke.py::bound`` prices for the
    flagship K1 (the dense layers on the tensor cores, the skinny first
    layer apart), unpadded; the MFU line charges bf16x3 three passes."""
    import chip_smoke

    sizes = (7, 288, 352, 288, 224, 451)
    flops = profiling.matmul_flops_per_row(sizes)
    dense = sum(a * b for a, b in zip(sizes[1:-1], sizes[2:]))
    assert flops == 2 * dense
    assert profiling.matmul_flops_per_row(sizes, skip_first=False) == flops + 2 * 7 * 288
    assert (profiling.H100_BF16_PEAK_FLOPS, profiling.H100_F32_PEAK_FLOPS,
            profiling.H100_HBM_BYTES_PER_S) == (chip_smoke.PEAK_BF16, chip_smoke.PEAK_F32,
                                                chip_smoke.PEAK_BYTES)
    n = 1 << 20
    ms, by = chip_smoke.bound("k1", sizes, n, "bf16x3")
    assert by == "operations"
    t_ops = n * (3 * flops / chip_smoke.PEAK_BF16 + 2 * 7 * 288 / chip_smoke.PEAK_F32)
    assert ms == pytest.approx(1e3 * t_ops)
    rows_per_s = n / (ms * 1e-3)
    line = profiling.mfu_line("k1", rows_per_s, flops, "high")
    share = rows_per_s * flops * 3 / chip_smoke.PEAK_BF16 * 100
    assert f"{share:.1f}% of the H100 bf16 peak" in line
    assert "f32 peak" in profiling.mfu_line("k1", 1e6, flops, "highest")


def test_debug_guard_traps_a_nan():
    x = torch.tensor([1.0, -1.0])
    assert torch.isnan(torch.sqrt(x)).any()  # no trap outside the guard
    with pytest.raises(FloatingPointError, match="NaN"):
        with profiling.debug_guard():
            torch.sqrt(x)
    with profiling.debug_guard():
        torch.exp(torch.tensor([1000.0]))  # Inf is trapped only on request
    with pytest.raises(FloatingPointError, match="Inf"):
        with profiling.debug_guard(infs=True):
            torch.exp(torch.tensor([1000.0]))
    assert np.isnan(torch.sqrt(x).numpy()).any()  # the mode is gone after the region
