"""The program's own spans and counters in a traced slice
(``tpu21cmvae_torch.utils.profiling``), and the arithmetic that reads
them beside the device's operations.

:func:`recorded` profiles a slice as :func:`port_bench.trace.profiled`
does, with the program's recording open inside it: the summary gains
``spans`` (the program's :class:`~tpu21cmvae_torch.utils.profiling.Span`
records), ``counters``, ``launch_ns`` and ``clock_least_ns``. Spans are
stamped with ``time.time_ns()``, the clock on which ``torch.profiler``
reports the host's runtime calls and, in most slices, the device's
operations, so a span and a kernel compare directly. In some slices the
profiler's device timestamps run off its host timestamps (by up to 17 ms
on an H100): :func:`clock_holds` finds them, and the readers that set a
span against the device's timeline read nothing there. Without a card
the slice's bounds are taken on the spans' clock.

The readers below take a run's record whose ``trace`` holds such a
summary and return None where it holds no spans (a program that records
none). A likelihood wrapper's span is of the layer ``WRAPPERS``, a
launch's of ``KERNELS`` (``tpu21cmvae_torch.utils.profiling``).
"""

from __future__ import annotations

import bisect
import contextlib
import statistics
import time
from typing import Optional

import torch

from port_bench import readers, trace
from tpu21cmvae_torch.utils.profiling import ENTRY, KERNELS, SAMPLER, WRAPPERS, recording

# how far before its launch call a kernel may seem to start: the two
# clocks' reading error
CLOCK_SLACK_NS = 5_000
# where a gap in the device's work is put: the layer of the innermost span
# the host was in
IDLE_OF_LAYER = {SAMPLER: "sampler", WRAPPERS: "wrapper", KERNELS: "wrapper", ENTRY: "entry"}
IDLE_KINDS = ("sampler", "wrapper", "entry", "outside")


def _launch_times(events):
    """Two dicts by the profiler's correlation id: the host's start of
    each runtime launch call, and each device operation's event."""
    host, device = {}, {}
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device[e.correlation_id()] = e
        elif "aunchKernel" in e.name():
            host[e.correlation_id()] = e.start_ns()
    return host, device


@contextlib.contextmanager
def recorded():
    """:func:`~port_bench.trace.profiled` with the program's
    ``recording()`` open inside the profile; the summary gains ``spans``,
    ``counters``, ``launch_ns`` (each kernel's start → the start of the
    runtime call that launched it, on the host) and ``clock_least_ns``
    (the least of kernel start − launch call start: below
    −:data:`CLOCK_SLACK_NS` the profiler's device clock ran off its host
    clock in this slice). Without a card the slice is the body's time on
    the spans' clock."""
    out = {}
    if not torch.cuda.is_available():
        with recording() as rec:
            lo = time.time_ns()
            yield out
            hi = time.time_ns()
        out.update(lo_ns=lo, hi_ns=hi, device=[], launch_ns={}, clock_least_ns=None,
                   spans=rec.spans, counters=dict(rec.counters))
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trace._mark()
        with recording() as rec:
            yield out
        trace._mark()
    events = prof.profiler.kineto_results.events()
    host, device = _launch_times(events)
    launch_ns = {e.start_ns(): host[c] for c, e in device.items() if c in host}
    out.update(trace.summarize(events), spans=rec.spans, counters=dict(rec.counters),
               launch_ns=launch_ns,
               clock_least_ns=min((k - r for k, r in launch_ns.items()), default=None))


def clock_holds(record) -> bool:
    """Whether no kernel of the slice starts more than
    :data:`CLOCK_SLACK_NS` before the runtime call that launched it: the
    profiler's device clock agrees with its host clock, which the spans
    share. The readers that set a span against the device's timeline read
    nothing where it does not."""
    least = (record.get("trace") or {}).get("clock_least_ns")
    return least is None or least >= -CLOCK_SLACK_NS


def _spans(record) -> Optional[list]:
    tr = record.get("trace") or {}
    return tr.get("spans") or None


def _children(spans) -> dict:
    kids = {}
    for i, s in enumerate(spans):
        if s.parent is not None:
            kids.setdefault(s.parent, []).append(i)
    return kids


def _descendants(kids, i):
    todo = list(kids.get(i, ()))
    while todo:
        j = todo.pop()
        yield j
        todo.extend(kids.get(j, ()))


def _covered_ns(intervals) -> int:
    """Nanoseconds covered by the union of ``(start, end)`` intervals."""
    covered, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                covered += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return covered + (cur_e - cur_s if cur_e is not None else 0)


def wrapper_self_ns(spans, names=None) -> list:
    """For each outermost likelihood-wrapper span (named in ``names``, if
    given), its duration less the time its launch descendants cover: the
    wrappers' own host time per likelihood call, in nanoseconds."""
    kids = _children(spans)
    out = []
    for i, s in enumerate(spans):
        if s.layer != WRAPPERS or (names is not None and s.name not in names):
            continue
        p = s.parent
        while p is not None and spans[p].layer != WRAPPERS:
            p = spans[p].parent
        if p is not None:
            continue
        launched = [(spans[j].start_ns, spans[j].end_ns) for j in _descendants(kids, i)
                    if spans[j].layer == KERNELS]
        out.append(s.end_ns - s.start_ns - _covered_ns(launched))
    return out


def wrapper_us(record, names=None) -> Optional[float]:
    """Mean of :func:`wrapper_self_ns` over the slice, microseconds."""
    spans = _spans(record)
    own = wrapper_self_ns(spans, names) if spans else []
    return 1e-3 * statistics.fmean(own) if own else None


def entry_us(record) -> Optional[float]:
    """Mean duration of the slice's ``device_call`` spans, microseconds."""
    spans = _spans(record)
    d = [s.end_ns - s.start_ns for s in spans or () if s.name == "device_call"]
    return 1e-3 * statistics.fmean(d) if d else None


def launch_pairs(record, kernel: str) -> list:
    """``(launch span, device operation)`` for each launch of ``kernel``
    (``"k1"``, ``"k2"`` or ``"k3"``) in the slice: each device kernel that
    ``port_bench.readers.KERNELS[kernel]`` matches, with the launch span of
    a ``<kernel>_*`` C entry that holds the runtime call that launched it
    (``launch_ns``). A kernel whose record or runtime call the profiler
    dropped is left out, and shifts no other pair."""
    tr = record.get("trace") or {}
    launched = sorted((s for s in tr.get("spans") or () if s.layer == KERNELS
                       and s.name.startswith(kernel + "_")), key=lambda s: s.start_ns)
    starts = [s.start_ns for s in launched]
    host = tr.get("launch_ns") or {}
    pat = readers.KERNELS[kernel]
    pairs = []
    for op in tr.get("device", ()):
        t = host.get(op[1])
        if op[3] != "kernel" or t is None or not pat.search(op[0]):
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= launched[i].end_ns:
            pairs.append((launched[i], op))
    return pairs


def launch_lead_us(record, kernels) -> Optional[float]:
    """Median over the slice's launches of ``kernels`` of the time from
    the launch span's end to the kernel's start on the device,
    microseconds: how long a launch waits in the queue."""
    if not clock_holds(record):
        return None
    leads = [op[1] - s.end_ns for k in kernels for s, op in launch_pairs(record, k)]
    return 1e-3 * statistics.median(leads) if leads else None


def _gaps(tr):
    """``(start_ns, end_ns)`` of each stretch of the slice in which the
    device runs nothing, found as :func:`port_bench.trace.idle_gaps`
    finds them, each operation clipped to the slice."""
    lo, hi = tr["lo_ns"], tr["hi_ns"]
    cur = lo
    for _, s, e, _ in tr["device"]:
        s, e = max(s, lo), min(e, hi)
        if s > cur:
            yield cur, s
        cur = max(cur, e)
    if hi > cur:
        yield cur, hi


def _innermost(spans) -> list:
    """``(start_ns, end_ns, index)`` pieces, in time order, over which the
    deepest open span (the latest opened, among equals) stays the same:
    one sweep over the spans' starts and ends. Time in no span is in no
    piece."""
    depth = []
    for s in spans:  # a parent is recorded before its children
        depth.append(0 if s.parent is None else depth[s.parent] + 1)
    edges = sorted({t for s in spans for t in (s.start_ns, s.end_ns)})
    order = sorted(range(len(spans)), key=lambda i: spans[i].start_ns)
    pieces, active, k = [], [], 0
    for t0, t1 in zip(edges, edges[1:]):
        while k < len(order) and spans[order[k]].start_ns <= t0:
            active.append(order[k])
            k += 1
        active = [i for i in active if spans[i].end_ns > t0]
        if active:
            top = max(active, key=lambda i: (depth[i], spans[i].start_ns))
            if pieces and pieces[-1][2] == top and pieces[-1][1] == t0:
                pieces[-1] = (pieces[-1][0], t1, top)
            else:
                pieces.append((t0, t1, top))
    return pieces


def attributed_gaps(record) -> Optional[list]:
    """``(ns, span)`` for each stretch of the slice in which the device
    runs nothing, cut where the innermost open span changes: the span the
    host was in over those nanoseconds, or None outside the program.
    None where the slice holds no spans or no device operations."""
    spans = _spans(record)
    if not spans or not record["trace"]["device"] or not clock_holds(record):
        return None
    pieces = _innermost(spans)
    out, k = [], 0
    for g0, g1 in _gaps(record["trace"]):
        while k < len(pieces) and pieces[k][1] <= g0:
            k += 1
        t, j = g0, k
        while t < g1:
            if j < len(pieces) and pieces[j][0] < g1:
                p0, p1, i = pieces[j]
                if p0 > t:  # before the piece: in no span
                    out.append((p0 - t, None))
                    t = p0
                end = min(p1, g1)
                out.append((end - t, spans[i]))
                t = end
                j += 1
            else:
                out.append((g1 - t, None))
                t = g1
    return out


def idle_shares(record) -> Optional[dict]:
    """The share of the slice, in percent, in which the device runs
    nothing, put down to the layer of the innermost span the host was in
    (:func:`attributed_gaps`): ``sampler``, ``wrapper`` (a likelihood
    wrapper or its launch), ``entry`` or ``outside`` the program. They
    add up to :func:`port_bench.readers.idle_pct`."""
    gaps = attributed_gaps(record)
    if gaps is None:
        return None
    total = dict.fromkeys(IDLE_KINDS, 0)
    for ns, s in gaps:
        total["outside" if s is None else IDLE_OF_LAYER[s.layer]] += ns
    tr = record["trace"]
    return {k: 100.0 * v / (tr["hi_ns"] - tr["lo_ns"]) for k, v in total.items()}


def cache_hit_pct(record) -> Optional[float]:
    """Operand and memo lookups that hit, over all of them in the slice,
    in percent."""
    c = (record.get("trace") or {}).get("counters")
    if c is None:
        return None
    hits = c.get("operand.hit", 0) + c.get("memo.hit", 0)
    looks = hits + c.get("operand.fold", 0) + c.get("memo.miss", 0)
    return 100.0 * hits / looks if looks else None
