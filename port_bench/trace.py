"""The traced slice of a run: ``torch.profiler`` over a bounded part of
the window, reduced in memory to what the per-layer metrics read.

Only the device's activity is recorded (CUPTI's kernels, copies and
fills): recording every host operation costs microseconds each, which in
a host-bound loop doubled the slice's wall time. The slice is bracketed
on the device by two marker kernels, each launched once the device is
idle, so that it spans the host's time before the first operation and
after the last. The host's side of a slice is counted by the benchmark
itself (:class:`Counted`, around the calls into the likelihood).
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch

_DEVICE_KINDS = {"kernel": "kernel", "gpu_memcpy": "copy", "gpu_memset": "fill"}


def _mark():
    """A marker kernel on an idle device."""
    torch.cuda.synchronize()
    torch.cuda._sleep(1)
    torch.cuda.synchronize()


@contextlib.contextmanager
def profiled():
    """Profile the body's device activity; yields a dict that holds the
    summary once the body has finished. Without a card (the CPU tests)
    the slice is the body's host time and has no device operations."""
    out = {}
    if not torch.cuda.is_available():
        lo = time.perf_counter_ns()
        yield out
        out.update(lo_ns=lo, hi_ns=time.perf_counter_ns(), device=[])
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _mark()
        yield out
        _mark()
    out.update(summarize(prof.profiler.kineto_results.events()))


def _kind(ev):
    """``kernel``, ``copy`` or ``fill`` for a device operation, else None
    (the host's runtime calls and the spans' device-side marks)."""
    if ev.device_type() != torch.autograd.DeviceType.CUDA:
        return None
    activity = str(getattr(ev, "activity_type", lambda: "")())
    kind = _DEVICE_KINDS.get(activity)
    if kind is None and "annotation" not in activity:
        name = ev.name()
        kind = "copy" if name.startswith("Memcpy") else "fill" if name.startswith("Memset") \
            else "kernel"
    return kind


def summarize(events) -> dict:
    """Reduce the profiler's events to the slice's summary: ``lo_ns`` and
    ``hi_ns`` (the start of the first marker and the end of the last) and
    ``device`` (``[name, start_ns, end_ns, kind]`` between them, in time
    order)."""
    device = sorted(([e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), kind]
                     for e in events if (kind := _kind(e)) is not None), key=lambda r: r[1])
    if len(device) < 2:
        return {}
    return {"lo_ns": device[0][1], "hi_ns": device[-1][2], "device": device[1:-1]}


def idle_gaps(summary: dict, top: int = 10):
    """The longest gaps in which the device ran nothing, each named by the
    device operation that ends it, which the host was preparing:
    ``[[name, seconds], …]``."""
    gaps, cur = [], summary["lo_ns"]
    for name, s, e, _ in summary["device"]:
        if s > cur:
            gaps.append((s - cur, f"before {name}"))
        cur = max(cur, e)
    if summary["hi_ns"] > cur:
        gaps.append((summary["hi_ns"] - cur, "end of slice"))
    return [[name, dur * 1e-9] for dur, name in sorted(gaps, key=lambda g: -g[0])[:top]]


def device_ops(summary: dict, top: int = 10):
    """The device operations that took most time: ``[[name, seconds], …]``."""
    tot = collections.Counter()
    for name, s, e, _ in summary["device"]:
        tot[name] += e - s
    return [[n, t * 1e-9] for n, t in tot.most_common(top)]


class Counted:
    """A likelihood the benchmark hands the program in a traced slice: it
    counts the rows of every call (``counts[kind]``) and forwards the
    call, and every attribute, to ``fn``."""

    def __init__(self, fn, counts: dict, kind: str):
        self.fn, self.counts, self.kind = fn, counts, kind

    def __call__(self, params, raw, *args, **kwargs):
        self.counts[self.kind] += int(raw.shape[0])
        return self.fn(params, raw, *args, **kwargs)

    def __getattr__(self, name):
        return getattr(self.fn, name)


@contextlib.contextmanager
def counted(model, counts: dict):
    """Inside the block, the likelihoods ``model`` builds for its
    samplers (``loglik_fn``: ``counts["value"]``, ``loglik_and_grad_fn``:
    ``counts["valgrad"]``) count the rows they are called on: instance
    attributes that shadow the two builders, removed at the end."""
    for name, kind in (("loglik_fn", "value"), ("loglik_and_grad_fn", "valgrad")):
        build = getattr(model, name)
        setattr(model, name,
                lambda *a, _build=build, _kind=kind, **kw: Counted(_build(*a, **kw), counts, _kind))
    try:
        yield counts
    finally:
        del model.loglik_fn, model.loglik_and_grad_fn
