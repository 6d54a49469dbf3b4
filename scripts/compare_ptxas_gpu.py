#!/usr/bin/env python3
"""Build the CUDA kernels of two trees of this repository and compare
what ``ptxas`` reports for each kernel: registers and spill-store bytes.

Run from the root of a checkout, on a machine with ``nvcc``:

    python3 scripts/compare_ptxas_gpu.py PARENT [CHANGE]

PARENT and CHANGE (default: this checkout) are roots of trees of this
repository, for example a parent commit unpacked with ``git archive``
under ``build/``. Each tree's kernels are built from its own
``tpu21cmvae_torch/ops/kernels/csrc`` by its own ``_build.build()``, both
at once, and each build's ``ptxas -v`` log is read by this checkout's
``chip_smoke.ptxas_report``. Prints one JSON line per tree (the report by
kernel), then one line naming the kernels whose registers or spill bytes
differ between the trees and those present in only one; exits 1 if a
kernel present in both differs. Needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = ("import sys; from tpu21cmvae_torch.ops.kernels import _build; "
         "print(_build.ptxas_log_path(_build.build()))")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("parent")
    parser.add_argument("change", nargs="?", default=HERE)
    args = parser.parse_args()
    sys.path.insert(0, HERE)
    from chip_smoke import ptxas_report

    trees = {"parent": os.path.abspath(args.parent), "change": os.path.abspath(args.change)}
    procs = {k: subprocess.Popen([sys.executable, "-c", BUILD], cwd=tree, text=True,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 env={**os.environ, "PYTHONPATH": tree})
             for k, tree in trees.items()}
    reports = {}
    for k, proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            print(f"compare_ptxas_gpu: the {k} build failed:\n{err}", file=sys.stderr)
            return 2
        with open(out.strip().splitlines()[-1]) as fh:
            reports[k] = ptxas_report(fh.read())
        print(json.dumps({"tree": k, "path": trees[k], "ptxas": reports[k]}), flush=True)
    parent, change = reports["parent"], reports["change"]
    differ = sorted(k for k in parent.keys() & change.keys() if parent[k] != change[k])
    print(json.dumps({"differ": {k: {"parent": parent[k], "change": change[k]} for k in differ},
                      "parent_only": sorted(parent.keys() - change.keys()),
                      "change_only": sorted(change.keys() - parent.keys())}), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
