"""Bulk emulation: a closed loop with one client, each call emulating a
batch of parameter rows through ``ShardedEmulator.for_model(model,
backend="kernel").device_call``, the signals left on the device.

The traffic file gives ``rows`` per call, ``n_batches`` input batches
made on the device from the seed (uniform in the prior box) and sent in
turn, ``sample_rows`` rows of each call's signals kept for the check (a
seeded draw, copied into a buffer of ``pick_cycle`` calls made in
set-up, so that the window allocates nothing of its own; a longer window
keeps its last ``pick_cycle`` calls), ``trace_skip`` calls before the
traced slice and ``trace_calls`` calls in it.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from port_bench.reference import Reference, in_blocks
from port_bench.trace import profiled


@dataclasses.dataclass
class State:
    emulator: object
    batches: list
    picks: torch.Tensor
    kept: torch.Tensor
    calls: int = 0


def setup(ctx) -> State:
    from tpu21cmvae_torch.models.direct import DirectEmulator
    from tpu21cmvae_torch.parallel.inference import ShardedEmulator
    from tpu21cmvae_torch.parallel.mesh import make_mesh

    t = ctx.traffic
    model = DirectEmulator.from_checkpoint(ctx.path(ctx.config["checkpoint"]), device=ctx.device)
    emulator = ShardedEmulator.for_model(model, mesh=make_mesh([ctx.device]), backend="kernel")
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    box = torch.as_tensor(np.asarray(ctx.config["prior_box"], np.float32), device=ctx.device)
    lo, span = box[:, 0], box[:, 1] - box[:, 0]
    batches = [lo + span * torch.rand((t["rows"], box.shape[0]), generator=gen,
                                      device=ctx.device)
               for _ in range(t["n_batches"])]
    picks = torch.randint(0, t["rows"], (t["pick_cycle"], t["sample_rows"]), generator=gen,
                          device=ctx.device)
    kept = torch.empty((t["pick_cycle"], t["sample_rows"], ctx.config["n_bins"]),
                       device=ctx.device)
    st = State(emulator=emulator, batches=batches, picks=picks, kept=kept)
    torch.index_select(st.emulator.device_call(batches[0]), 0, picks[0], out=kept[0])
    _sync(ctx)
    return st


def _sync(ctx):
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)


def window(ctx, st: State, seconds: float) -> dict:
    """Calls until the first that finishes after ``seconds``, each timed
    from the call until its signals are ready; with ``ctx.trace`` calls
    ``trace_skip`` … ``trace_skip + trace_calls − 1`` are profiled and
    the others' host time inside ``device_call`` is kept."""
    t = ctx.traffic
    nb, cycle = len(st.batches), st.picks.shape[0]
    call_s, enqueue_s = [], []
    first, last = t["trace_skip"], t["trace_skip"] + t["trace_calls"] - 1
    prof, trace = None, None
    t_open = time.perf_counter()
    i = 0
    while True:
        if ctx.trace and i == first:
            prof = profiled()
            trace = prof.__enter__()
        t0 = time.perf_counter()
        out = st.emulator.device_call(st.batches[i % nb])
        t_enq = time.perf_counter()
        _sync(ctx)
        t1 = time.perf_counter()
        call_s.append(t1 - t0)
        if prof is None:
            enqueue_s.append(t_enq - t0)
        torch.index_select(out, 0, st.picks[i % cycle], out=st.kept[i % cycle])
        del out
        if prof is not None and i == last:
            prof.__exit__(None, None, None)
            prof = None
        i += 1
        if t1 - t_open >= seconds and prof is None:
            break
    st.calls = i
    rec = {"window_s": t1 - t_open, "calls": i, "call_s": call_s, "failed": 0,
           "work": {"signals": i * t["rows"]}, "rows_per_launch": t["rows"]}
    if ctx.trace:
        rec["enqueue_s"] = enqueue_s
        rec["trace"] = dict(trace, iterations=t["trace_calls"],
                            rows_value=t["trace_calls"] * t["rows"], rows_valgrad=0)
    return rec


def outputs(st: State) -> dict:
    """The kept rows of the last ``pick_cycle`` calls' signals (every
    call's, in a window of fewer) and the inputs they came from, on the
    host."""
    nb, cycle = len(st.batches), st.picks.shape[0]
    calls = range(max(0, st.calls - cycle), st.calls)
    rows = [st.batches[i % nb].index_select(0, st.picks[i % cycle]) for i in calls]
    return {"inputs": torch.cat(rows).cpu(),
            "signals": torch.cat([st.kept[i % cycle] for i in calls]).cpu()}


def readings(ctx, out: dict, ref: Reference) -> dict:
    """``signal_err``: the widest |signal − reference| over a kept row,
    relative to that row's amplitude (its largest |reference|); a
    non-finite signal reads NaN, which no limit passes."""
    sig = in_blocks(ref.forward, out["inputs"])
    r = torch.as_tensor(out["signals"], dtype=torch.float64) - sig
    err = torch.amax(torch.abs(r), dim=-1) / torch.amax(torch.abs(sig), dim=-1)
    return {"signal_err": float(torch.max(err))}


def control_outputs(ctx, out: dict, ref: Reference, mode: str) -> dict:
    """The control in the program's place: the reference's signals at
    the lower precision on the same rows."""
    return {"inputs": out["inputs"],
            "signals": in_blocks(lambda x: ref.forward(x, mode), out["inputs"]).float()}


def check(ctx, st: State, control=None):
    """The program's readings; with ``control`` (the cell file's
    ``{"mode"}``) also the control's on the same rows."""
    out = outputs(st)
    st.emulator = st.batches = st.kept = None
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = Reference(ctx.path(ctx.config["checkpoint"]), device=ctx.device)
    if control is None:
        return readings(ctx, out, ref)
    return readings(ctx, out, ref), readings(ctx, control_outputs(ctx, out, ref, control["mode"]),
                                              ref)
