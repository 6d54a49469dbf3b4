"""Profiling, tracing and timing utilities (the port of
``tpu21cmvae/utils/profiling.py``), over ``torch.profiler``:

* :func:`span`, :func:`count` and :func:`recording` — the program's own
  spans and counters, recorded in memory while a :func:`recording` is
  open and free (one flag test) while none is;
* :func:`trace` — a Chrome trace of the enclosed region written to
  ``logdir``: the profiler's CPU ops and CUDA kernels, and the program's
  spans beside them;
* :func:`benchmark` — timing with warmup excluded and the device
  synchronized after every sample;
* :func:`device_memory_stats` — the CUDA caching allocator's counters;
* :func:`debug_guard` — an opt-in NaN (and Inf) trap for debug runs;
* :func:`padded_flops_per_row` — K1's products per row, padding
  included, that the tuner ranks trials by.

**Spans.** The program opens a span at each layer boundary of its hot
path, in one of four layers (:data:`ENTRY`, :data:`SAMPLER`,
:data:`WRAPPERS`, :data:`KERNELS`): ``device_call`` (or ``call``)
with its ``split_rows``, ``run`` and ``merge_rows`` at the entry point;
``sample_posterior`` with its ``start``, ``warmup``, ``draws`` and
``collect`` in the sampler loop; one per likelihood wrapper call, named
by the wrapper (``K1``, ``K2``, ``K3``, ``kernel_value``,
``autograd_valgrad``, and a deep ensemble's ``mixture`` around its
member-batched wrapper's); one per kernel launch, named by the C entry,
around the launch alone. Counters: ``operand.hit``/``operand.fold`` (the
wrappers' folded weights), ``memo.hit``/``memo.miss`` (the models'
likelihood memo), ``k3.route.<route>`` (each K3 call on the card by the
kernel it runs) and ``k3.tall_declined`` (each member-batched K3 call on
the card that the one-model tall kernel would have taken: 1, else 0). Spans are stamped with ``time.time_ns()``, the Unix-epoch
clock on which ``torch.profiler`` reports its events, so a span and the
runtime call or kernel it launched compare directly (the profiler's
device timestamps have been seen to run off its host timestamps by up
to 17 ms within some slices on an H100: ``port_bench/spans.py`` checks
each slice).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import threading
import time
from typing import Callable, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode


# the layers of the hot path, from the entry point down: each span names one
ENTRY, SAMPLER, WRAPPERS, KERNELS = ("entry point", "sampler loop", "likelihood wrappers",
                                     "kernels")
LAYERS = (ENTRY, SAMPLER, WRAPPERS, KERNELS)


class Span:
    """One span of a :func:`recording`: its ``name`` and ``layer``,
    ``start_ns`` and ``end_ns`` (``time.time_ns()``; ``end_ns`` None while
    it is open), the index of its ``parent`` in the recording's spans
    (None for a root), the index of its ``root`` (itself for a root: every
    span of one request shares it) and the ``thread`` that opened it. The
    context manager :func:`span` returns while recording."""

    __slots__ = ("name", "layer", "start_ns", "end_ns", "parent", "root", "thread", "_rec")

    def __init__(self, name: str, layer: str, start_ns: int = 0, end_ns: Optional[int] = None,
                 parent: Optional[int] = None, root: Optional[int] = None,
                 thread: Optional[int] = None):
        self.name, self.layer = name, layer
        self.start_ns, self.end_ns = start_ns, end_ns
        self.parent, self.root, self.thread = parent, root, thread
        self._rec = None

    def __enter__(self):
        rec = self._rec
        stack = rec._stack()
        with rec._lock:
            index = len(rec.spans)
            rec.spans.append(self)
        self.thread = threading.get_ident()
        if stack:
            self.parent = stack[-1]
            self.root = rec.spans[self.parent].root
        else:
            self.root = index
        stack.append(index)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        self._rec._stack().pop()
        return False


class Recording:
    """What :func:`recording` yields: ``spans`` (:class:`Span`, in the
    order they opened) and ``counters`` (name → total), filled while the
    recording is open, from every thread."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack


class _Noop:
    """The context :func:`span` returns while nothing records: shared,
    reentrant, and cheaper to enter than ``contextlib.nullcontext``."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_active: Optional[Recording] = None
_NOOP = _Noop()


def span(name: str, layer: str):
    """A context manager that records the enclosed region as a
    :class:`Span` of ``layer`` (one of :data:`LAYERS`) while a
    :func:`recording` is open; the
    shared no-op context otherwise (no allocation, no clock read)."""
    rec = _active
    if rec is None:
        return _NOOP
    s = Span(name, layer)
    s._rec = rec
    return s


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the process-wide counter ``name`` while a
    :func:`recording` is open; nothing otherwise."""
    rec = _active
    if rec is None:
        return
    with rec._lock:
        rec.counters[name] = rec.counters.get(name, 0) + n


def recording_open() -> bool:
    """Whether a :func:`recording` is open: a counter whose value costs
    work to compute is computed only then."""
    return _active is not None


@contextlib.contextmanager
def recording():
    """Record the program's spans and counters while the body runs, in
    memory, and yield the :class:`Recording` that holds them. One at a
    time per process; nothing is written out."""
    global _active
    if _active is not None:
        raise RuntimeError("a recording is already open in this process")
    rec = _active = Recording()
    try:
        yield rec
    finally:
        _active = None


def _span_events(spans, base_ns: int, pid: int) -> list:
    """``spans`` as Chrome trace complete events (``"X"``), microseconds
    after ``base_ns``."""
    return [{"ph": "X", "cat": s.layer, "name": s.name, "pid": pid, "tid": s.thread,
             "ts": (s.start_ns - base_ns) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": {"layer": s.layer, "span": i, "parent": s.parent, "root": s.root}}
            for i, s in enumerate(spans) if s.end_ns is not None]


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed region with ``torch.profiler`` and write a
    Chrome trace (``trace_<ns>.json``) into ``logdir``; view it in
    Perfetto or ``chrome://tracing``. The region runs inside a
    :func:`recording`, whose spans join the profiler's events in the file.
    Yields the profiler. CUDA activity is recorded where a card is
    present; synchronize inside the region so that no queued kernel
    escapes it."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        with recording() as rec:
            yield prof
    path = os.path.join(logdir, f"trace_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        doc = json.load(fh)
    doc["traceEvents"].extend(_span_events(rec.spans, doc.get("baseTimeNanoseconds", 0),
                                           os.getpid()))
    with open(path, "w") as fh:
        json.dump(doc, fh)


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


# -- pricing ------------------------------------------------------------------


def padded_flops_per_row(sizes, tier: str = "highest") -> int:
    """Matmul FLOPs per batch row that K1 multiplies for a dense chain of
    ``sizes``, padding included, at ``tier``: at the fp32 tiers
    (``csrc/fused_mlp.cu``, what ``predict`` and the served ``/predict``
    run) each fan-in is padded to 32 and each fan-out to 128-column slabs
    (``ops/kernels/_common.py``: ``PAD_K``, ``SLAB_N``); at the bf16
    tiers (``csrc/fused_mlp_mma.cu``) both to multiples of 16, the
    ``mma.m16n8k16`` fragments. A skinny first layer (fan-in ≤ 8) runs
    apart, unpadded, on the CUDA cores, and is left out, as
    ``chip_smoke.py::bound`` prices it apart. The cost the tuner ranks
    trials by."""
    from tpu21cmvae_torch.ops.fold import resolve_tier
    from tpu21cmvae_torch.ops.kernels._common import PAD_K, SLAB_N

    def up(n, m):
        return -(-n // m) * m

    k_pad, n_pad = (PAD_K, SLAB_N) if resolve_tier(tier, "highest") == "f32" else (16, 16)
    pairs = list(zip(sizes[:-1], sizes[1:]))
    if pairs and sizes[0] <= 8:
        pairs = pairs[1:]
    return 2 * sum(up(a, k_pad) * up(b, n_pad) for a, b in pairs)
