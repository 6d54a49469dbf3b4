"""Profiling, tracing and timing utilities (the port of
``tpu21cmvae/utils/profiling.py``), over ``torch.profiler``:

* :func:`trace` — a Chrome trace of the enclosed region written to
  ``logdir`` (CPU ops, and CUDA kernels where a card is present);
* :func:`annotate` — a named region that shows up inside the trace;
* :func:`benchmark` — timing with warmup excluded and the device
  synchronized after every sample;
* :func:`device_memory_stats` — the CUDA caching allocator's counters;
* :func:`debug_guard` — an opt-in NaN (and Inf) trap for debug runs;
* :func:`matmul_flops_per_row` and :func:`mfu_line` — roofline
  accounting against the H100's peaks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import statistics
import time
from typing import Callable, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed region with ``torch.profiler`` and write a
    Chrome trace (``trace_<ns>.json``) into ``logdir``; view it in
    Perfetto or ``chrome://tracing``. Yields the profiler. CUDA activity
    is recorded where a card is present; synchronize inside the region so
    that no queued kernel escapes it."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{time.time_ns()}.json"))


def annotate(name: str):
    """A named region on the trace timeline
    (``torch.profiler.record_function``); a context manager."""
    return torch.profiler.record_function(name)


@dataclasses.dataclass
class BenchmarkResult:
    """Timing distribution for one callable (seconds per call)."""

    name: str
    times_s: List[float]
    items_per_call: Optional[int] = None

    @property
    def mean_s(self) -> float:
        return statistics.fmean(self.times_s)

    @property
    def min_s(self) -> float:
        return min(self.times_s)

    @property
    def std_s(self) -> float:
        return statistics.pstdev(self.times_s) if len(self.times_s) > 1 else 0.0

    @property
    def items_per_sec(self) -> Optional[float]:
        if self.items_per_call is None:
            return None
        return self.items_per_call / self.mean_s

    def summary(self) -> str:
        s = (f"{self.name}: {self.mean_s * 1e3:.3f} ms/call (min {self.min_s * 1e3:.3f}, "
             f"std {self.std_s * 1e3:.3f}, n={len(self.times_s)})")
        if self.items_per_call is not None:
            s += f", {self.items_per_sec:.1f} items/s"
        return s


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def benchmark(fn: Callable, *args, iters: int = 20, warmup: int = 2,
              items_per_call: Optional[int] = None, name: Optional[str] = None
              ) -> BenchmarkResult:
    """Time ``fn(*args)`` on the host clock: ``warmup`` calls first (the
    kernel library build, operand folds, allocator growth), excluded;
    every timed sample ends in a device synchronize, so it covers the
    device's work, not only its launch. Throughput follows from
    ``items_per_call`` (e.g. the batch size)."""
    for _ in range(warmup):
        fn(*args)
        _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    return BenchmarkResult(name=name or getattr(fn, "__name__", "fn"), times_s=times,
                           items_per_call=items_per_call)


def device_memory_stats(device=None) -> Optional[dict]:
    """The CUDA caching allocator's counters for ``device``
    (``torch.cuda.memory_stats``: bytes allocated, reserved, peaks …), or
    None for the CPU or where no card is present."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.memory_stats(device)


class _NonFiniteTrap(TorchDispatchMode):
    """Checks every floating-point output of every tensor operation."""

    def __init__(self, nans: bool, infs: bool):
        super().__init__()
        self.nans, self.infs = nans, infs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel():
                if self.nans and bool(torch.isnan(t).any()):
                    raise FloatingPointError(f"NaN produced by {func}")
                if self.infs and bool(torch.isinf(t).any()):
                    raise FloatingPointError(f"Inf produced by {func}")
        return out


@contextlib.contextmanager
def debug_guard(nans: bool = True, infs: bool = False):
    """Opt-in numerical tripwire: raise ``FloatingPointError`` naming the
    operation when any tensor operation in the region (in this thread)
    produces a NaN (and, with ``infs``, an Inf). PyTorch has no forward
    NaN trap of its own (JAX's ``jax_debug_nans``): the region runs
    under a dispatch mode that checks every floating-point output, and
    under autograd's anomaly mode, which traps NaNs in backward passes.
    A kernel launched through ``ctypes`` is not a tensor operation, so
    its output is checked at the next operation that reads it. Every
    check syncs with the device: debug runs only."""
    with torch.autograd.set_detect_anomaly(nans), _NonFiniteTrap(nans, infs):
        yield


# -- roofline accounting ------------------------------------------------------

#: Published dense peaks of one H100 SXM at its 700 W limit: bf16 on the
#: tensor cores, fp32 on the CUDA cores, and the HBM3 rate (the numbers
#: ``chip_smoke.py`` prices its kernels' bounds with).
H100_BF16_PEAK_FLOPS = 989e12
H100_F32_PEAK_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12

#: Per tier: the type whose peak prices a product and the passes a
#: product costs on it (bf16x3: three bf16 products; the fp32 tiers run
#: on the CUDA cores).
TIER_PASSES = {"highest": ("f32", 1), "contract": ("f32", 1), "high": ("bf16", 3),
               "default": ("bf16", 1)}


def matmul_flops_per_row(sizes, skip_first: bool = True) -> int:
    """Matmul FLOPs per batch row of a dense chain of ``sizes``, unpadded
    (Hopper's tensor cores take any multiple of 16 without a 128-lane
    tile to fill). ``skip_first`` drops a skinny first layer (fan-in ≤ 8),
    which the kernels run as exact fp32 FMA on the CUDA cores, as
    ``chip_smoke.py::bound`` prices it apart."""
    pairs = list(zip(sizes[:-1], sizes[1:]))
    if skip_first and pairs and sizes[0] <= 8:
        pairs = pairs[1:]
    return 2 * sum(a * b for a, b in pairs)


def padded_flops_per_row(sizes, tier: str = "highest") -> int:
    """Matmul FLOPs per batch row that K1 multiplies for a dense chain of
    ``sizes``, padding included, at ``tier``: at the fp32 tiers
    (``csrc/fused_mlp.cu``, what ``predict`` and the served ``/predict``
    run) each fan-in is padded to 32 and each fan-out to 128-column slabs
    (``ops/kernels/_common.py``: ``PAD_K``, ``SLAB_N``); at the bf16
    tiers (``csrc/fused_mlp_mma.cu``) both to multiples of 16, the
    ``mma.m16n8k16`` fragments. A skinny first layer (fan-in ≤ 8) runs
    apart, unpadded, on the CUDA cores, and is left out, as in
    :func:`matmul_flops_per_row`. The cost the tuner ranks trials by."""
    from tpu21cmvae_torch.ops.fold import resolve_tier
    from tpu21cmvae_torch.ops.kernels._common import PAD_K, SLAB_N

    def up(n, m):
        return -(-n // m) * m

    k_pad, n_pad = (PAD_K, SLAB_N) if resolve_tier(tier, "highest") == "f32" else (16, 16)
    pairs = list(zip(sizes[:-1], sizes[1:]))
    if pairs and sizes[0] <= 8:
        pairs = pairs[1:]
    return 2 * sum(up(a, k_pad) * up(b, n_pad) for a, b in pairs)


def mfu_line(label: str, rows_per_s: float, flops_per_row: float, tier: str,
             peak: Optional[float] = None) -> str:
    """One-line roofline statement: the logical FLOP rate, and the share
    of the H100 peak of the tier's type that it takes once the tier's
    passes are charged (bf16x3 costs three bf16 products per product).
    ``peak`` overrides the table's peak (another card, another limit)."""
    kind, passes = TIER_PASSES.get(tier.lower(), ("bf16", 1))
    if peak is None:
        peak = H100_F32_PEAK_FLOPS if kind == "f32" else H100_BF16_PEAK_FLOPS
    rate = rows_per_s * flops_per_row
    return (f"MFU[{label}]: {rate / 1e12:.1f} TFLOP/s logical; x {passes} {kind} pass(es) "
            f"({tier}) -> {rate * passes / peak * 100:.1f}% of the H100 {kind} peak")
