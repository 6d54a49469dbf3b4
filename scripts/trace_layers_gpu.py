"""The program's spans and counters in the benchmark cells' traced slices
on the H100, beside the same slices with the program's recording off.

    python3 scripts/trace_layers_gpu.py [--cells a,b] [--seed N] [--repeats 3] [--out FILE]

from the root of a checkout, on a machine with a card. For each cell
(default: every cell of ``BENCHMARK.json``) it runs the cell's set-up,
then ``repeats`` pairs of traced windows just long enough to hold the
cell's slice (one sampler call; predict's calls ``trace_skip`` …), one
with the program's recording open inside the profile
(``port_bench.spans.recorded``) and one without
(``port_bench.trace.profiled``), the order alternating. Each window
prints one JSON line (also written to ``--out``, where given): the
slice's wall time and the cell's per-layer metrics; with recording on
also what ``port_bench/spans.py`` reads (the wrappers' own host time,
the launch-to-start lead, the idle share put down to each layer and to
the innermost span's name, the cache hits, the counters) and the checks:
whether the profiler's device clock held to its host clock in the slice
(``port_bench.spans.clock_holds``), whether every K1/K2/K3 kernel paired
with a launch span starts no earlier than 5 µs before that span's start,
and whether the idle shares add up to ``device_idle_pct``. The first
line is the off-path cost of one ``span()`` on the host's CPU. The
correctness check of a benchmark run is not made here.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import timeit
from unittest import mock

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from port_bench import harness, readers, spans, trace  # noqa: E402

LEAD_ALLOWED_NS = 5_000


def span_off_ns(n: int = 1_000_000) -> float:
    """The best of five timings of ``with span(...): pass`` with recording
    off, nanoseconds per span."""
    from tpu21cmvae_torch.utils.profiling import WRAPPERS, span

    best = min(timeit.repeat('with span("K3", WRAPPERS): pass',
                             globals={"span": span, "WRAPPERS": WRAPPERS}, number=n, repeat=5))
    return 1e9 * best / n


def clock_check(record) -> dict:
    """Per kernel: its launch spans, the launches paired with a kernel,
    and the least (kernel start − launch span start), microseconds;
    ``late`` counts kernels that start more than 5 µs before their launch
    span."""
    out = {}
    for k in ("k1", "k2", "k3"):
        n = sum(s.layer == spans.KERNELS and s.name.startswith(k + "_")
                for s in record["trace"]["spans"])
        d = [op[1] - s.start_ns for s, op in spans.launch_pairs(record, k)]
        if n:
            out[k] = {"launches": n, "pairs": len(d),
                      "least_us": 1e-3 * min(d) if d else None,
                      "late": sum(x < -LEAD_ALLOWED_NS for x in d)}
    return out


def span_readings(record) -> dict:
    tr = record["trace"]
    shares = spans.idle_shares(record)
    by_name = {}
    for ns, s in spans.attributed_gaps(record) or ():
        key = "outside" if s is None else s.name
        by_name[key] = by_name.get(key, 0) + ns
    width = tr["hi_ns"] - tr["lo_ns"]
    own = spans.wrapper_self_ns(tr["spans"])
    k1_own = spans.wrapper_self_ns(tr["spans"], names={"K1"})
    idle = readers.idle_pct(record)
    return {
        "wrapper_us": spans.wrapper_us(record),
        "wrapper_us_median": 1e-3 * statistics.median(own) if own else None,
        "wrapper_calls": len(own),
        "wrapper_us_k1": 1e-3 * statistics.fmean(k1_own) if k1_own else None,
        "entry_us": spans.entry_us(record),
        "launch_lead_us": {k: spans.launch_lead_us(record, (k,)) for k in ("k1", "k2", "k3")},
        "idle_shares": shares,
        "idle_sum_minus_device_idle": None if shares is None else sum(shares.values()) - idle,
        "idle_by_span": {k: 100.0 * v / width for k, v in
                         sorted(by_name.items(), key=lambda kv: -kv[1])[:8]},
        "cache_hit_pct": spans.cache_hit_pct(record),
        "counters": tr["counters"],
        "spans": len(tr["spans"]),
        "clock": clock_check(record),
        "clock_least_us": (None if tr["clock_least_ns"] is None
                           else 1e-3 * tr["clock_least_ns"]),
        "clock_holds": spans.clock_holds(record),
    }


def window(ctx, drv, st, record_spans: bool) -> dict:
    # one sampler call; predict's window ends with the first call after
    # the slice once 3 s have passed (its skipped calls take ~0.5 s)
    seconds = 0.0 if ctx.traffic["generator"] == "posterior" else 3.0
    with mock.patch.object(drv, "profiled", spans.recorded if record_spans else trace.profiled):
        record = drv.window(ctx, st, seconds)
    record.update(setup_s=0.0, config=ctx.config, traffic=ctx.traffic, cell=ctx.cell["name"])
    line = {"cell": ctx.cell["name"], "recording": record_spans, "calls": record["calls"],
            "slice_s": readers.slice_seconds(record),
            "metrics": {m["name"]: harness.reader(m["name"])(record) for m in ctx.per_layer}}
    if record_spans:
        line.update(span_readings(record))
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cells", default=None)
    p.add_argument("--seed", type=int, default=2**31 + 101)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as fh:
        cells = [w["name"] for w in json.load(fh)["workloads"]]
    if a.cells:
        cells = a.cells.split(",")
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out or os.devnull, "w") as out:
        def emit(line):
            text = json.dumps(line)
            print(text, flush=True)
            out.write(text + "\n")
            out.flush()

        emit({"span_off_ns": span_off_ns(), "device": torch.cuda.get_device_name(0)})
        for cell in cells:
            ctx = harness.load(cell, seed=a.seed, seconds=0.0, trace=True, device="cuda:0")
            drv = harness.generator(ctx)
            st = drv.setup(ctx)
            for r in range(a.repeats):
                for on in ((True, False) if r % 2 == 0 else (False, True)):
                    emit(window(ctx, drv, st, on))
            del st
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
