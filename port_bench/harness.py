"""One run of one benchmark cell: set-up, the measured window, the
check against the reference, the metrics, and the result line.

Everything that belongs to one cell, configuration, traffic mix or
metric is found by its name:

* ``BENCHMARK.json`` (the root of the checkout): the cells, each naming
  its configuration and traffic mix, and the metrics with their cells;
* ``port_bench/configs/<config>.json``: the configuration as it is run;
* ``port_bench/traffic/<traffic>.json``: the mix's parameters, read by
  the generator it names (``port_bench/generators/<generator>.py``);
* ``port_bench/workloads/<cell>.json``: the limits of the cell's check,
  and the readings they were set from;
* ``port_bench/metrics/<metric>.py``: a ``read(record)`` that returns the
  metric's value from the run's record, or None where it finds nothing.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time

import torch

from port_bench import readers
from port_bench.trace import device_ops, idle_gaps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu21cmvae")


@dataclasses.dataclass
class Ctx:
    """What a run is given: the cell, its configuration, traffic and
    limits, the seed, the window's length, whether to trace, the device."""

    root: str
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    seed: int
    seconds: float
    trace: bool
    device: torch.device

    def path(self, rel: str) -> str:
        return os.path.join(self.root, rel)


def _json(*parts):
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def load(cell_name: str, *, seed: int, seconds: float, trace: bool, device,
         root: str = ROOT) -> Ctx:
    """The context of a run of ``cell_name`` from the checkout at ``root``."""
    manifest = _json(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if cell_name not in cells:
        raise SystemExit(f"no workload {cell_name!r} in BENCHMARK.json")
    cell = cells[cell_name]

    def mine(metrics):
        return [m for m in metrics if cell_name in m.get("workloads", [cell_name])]

    return Ctx(root=root, cell=cell,
               config=_json(root, "port_bench", "configs", cell["config"] + ".json"),
               traffic=_json(root, "port_bench", "traffic", cell["traffic"] + ".json"),
               limits=_json(root, "port_bench", "workloads", cell_name + ".json")["limits"],
               end_to_end=mine(manifest["end_to_end"]), per_layer=mine(manifest["per_layer"]),
               seed=seed, seconds=seconds, trace=trace,
               device=torch.empty(0, device=device).device)


def generator(ctx: Ctx):
    return importlib.import_module("port_bench.generators." + ctx.traffic["generator"])


def reader(name: str, root: str = ROOT):
    """The ``read`` function of ``port_bench/metrics/<name>.py``."""
    path = os.path.join(root, "port_bench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("port_bench_metric_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole (``tpu21cmvae_torch`` is not
    ``tpu21cmvae``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _finite(x):
    return x if x is not None and math.isfinite(x) else None


def compare(readings: dict, limits: dict) -> dict:
    """Each number compared beside its limit; a number that is not
    finite reads None and passes nothing."""
    return {name: {"value": _finite(readings[name]), "limit": limits[name]["limit"]}
            for name in limits}


def passes(checks: dict) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())


def run(ctx: Ctx, t_start: float) -> dict:
    """Set-up, window, check and metrics of one run; returns the result
    object (without the device's name), ``t_start`` the process's start
    on ``time.perf_counter``'s clock."""
    drv = generator(ctx)
    t_setup = time.perf_counter()
    state = drv.setup(ctx)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    t_open = time.perf_counter()
    record = {"setup_s": t_open - t_start, "config": ctx.config,
              "traffic": ctx.traffic, "cell": ctx.cell["name"]}
    record.update(drv.window(ctx, state, ctx.seconds))
    peak = (torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0)
    checks = compare(drv.check(ctx, state), ctx.limits)
    correct = record["failed"] == 0 and passes(checks)
    metrics = {}
    for m in (ctx.per_layer if ctx.trace else ctx.end_to_end):
        value = _finite(reader(m["name"], ctx.root)(record))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": record["calls"], "failed": record["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu", "kind": None, "count": int(ctx.cell["chips"]),
                         "memory_peak_bytes": int(peak)}}
    if ctx.trace and "trace" in record:
        tr = record["trace"]
        result["device"]["window_s"] = readers.slice_seconds(record)
        result["device"]["busy_s"] = readers.busy_seconds(record)
        result["breakdown"] = {"device_ops": device_ops(tr), "idle_gaps": idle_gaps(tr)}
    calls = record["call_s"]
    result["window"] = (f"{record['calls']} calls in {record['window_s']:.3f} s, "
                        f"{min(calls):.4f}-{max(calls):.4f} s each; set-up "
                        f"{t_setup - t_start:.2f} s before the generator's, "
                        f"{t_open - t_setup:.2f} s in it")
    result["checks"] = checks
    return result


def main(argv=None, t_start=None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description="One run of one benchmark cell on the H100.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    manifest = _json(ROOT, "BENCHMARK.json")
    chips = {w["name"]: int(w["chips"]) for w in manifest["workloads"]}.get(a.workload)
    if chips is None:
        print(f"no workload {a.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{a.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = load(a.workload, seed=a.seed, seconds=a.seconds, trace=bool(a.trace),
               device="cuda:0")
    result = run(ctx, t_start)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 4
    result["device"]["kind"] = torch.cuda.get_device_name(0)
    print(f"window: {result.pop('window')}", file=sys.stderr)
    result["checks"] = result.pop("checks")
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
