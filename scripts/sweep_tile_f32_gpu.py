#!/usr/bin/env python3
"""Time the register-tiled fp32 kernels (``csrc/fused_mlp.cu`` K1,
``csrc/fused_loglik_gram.cu`` K2, device code ``csrc/tile_f32.cuh``) at
other slab geometries than the committed one, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and
``nvcc``:

    python3 scripts/sweep_tile_f32_gpu.py [CSRC_DIR ...]

For the committed sources, for each (slab depth, ring slots), and for
each CSRC_DIR given (another tree's ``csrc/`` with the same C entry
points, built as it is), it
copies the two sources and their headers into ``build/sweep_tile_f32/``,
sets ``Ring``'s ``kDepth`` and ``kSlots`` to those values at every tile
height, builds a shared library with ``nvcc`` (all builds at once), and
reads ``ptxas``'s registers and spills. Then, on the flagship
checkpoint's folded operands (``pretrained/direct_synthetic.npz``,
noise σ² = 25), it launches K1 sumsq and K2 of every build at every tile
height asked for, checks that each result equals the committed build's
bit for bit (the summation order does not depend on the slab geometry),
and times each one's device time per call over back-to-back launches
(CUDA events), the builds in turns forward then backward. A build whose
shared memory does not fit a height is left out there. It prints one
JSON line and the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tpu21cmvae_torch.data.synthetic import synthetic_params  # noqa: E402
from tpu21cmvae_torch.models.direct import DirectEmulator  # noqa: E402
from tpu21cmvae_torch.ops.kernels import _build  # noqa: E402
from tpu21cmvae_torch.ops.kernels._common import pointers  # noqa: E402
from tpu21cmvae_torch.ops.kernels.fused_loglik import (  # noqa: E402
    make_fused_loglik,
    make_fused_loglik_gram,
)

CSRC = os.path.join(ROOT, "tpu21cmvae_torch", "ops", "kernels", "csrc")
OUT = os.path.join(ROOT, "build", "sweep_tile_f32")
SOURCES = ("fused_mlp.cu", "fused_loglik_gram.cu")
# (slab depth, ring slots) builds beside the committed one (None)
GEOMETRIES = (None, (8, 3), (16, 3), (32, 3), (16, 2), (32, 2))
HEIGHTS = (64, 32)
ROWS = (409_600, 1_048_576)
CALLS, ROUNDS = 3, 3


def name(geometry) -> str:
    if geometry is None:
        return "committed"
    if isinstance(geometry, str):
        return geometry
    return f"{geometry[0]}x{geometry[1]}"


def build(geometry) -> tuple:
    """Copy, patch and start compiling one geometry (or another tree's
    sources, as they are); returns (library path, nvcc process)."""
    d = os.path.join(OUT, name(geometry).strip("/").replace("/", "_"))
    os.makedirs(d, exist_ok=True)
    csrc = geometry if isinstance(geometry, str) else CSRC
    for f in os.listdir(csrc):
        if f.endswith(".cuh") or f in SOURCES:
            shutil.copy(os.path.join(csrc, f), d)
    if isinstance(geometry, tuple):
        path = os.path.join(d, "tile_f32.cuh")
        with open(path) as fh:
            text = fh.read()
        # the first definitions are Ring's (K1, K2); K3's GradRing derives from them
        text, n1 = re.subn(r"static constexpr int kDepth = [^;]*;",
                           f"static constexpr int kDepth = {geometry[0]};", text, count=1)
        text, n2 = re.subn(r"static constexpr int kSlots = [^;]*;",
                           f"static constexpr int kSlots = {geometry[1]};", text, count=1)
        assert n1 == n2 == 1, "tile_f32.cuh no longer defines Ring's kDepth and kSlots"
        assert text.index("struct Ring {") < text.index("kDepth = ") < text.index("struct GradRing")
        with open(path, "w") as fh:
            fh.write(text)
    lib = os.path.join(d, "lib.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", lib,
           *(os.path.join(d, s) for s in SOURCES)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def registers(log: str) -> dict:
    """Registers and spill-store bytes of every kernel in a ``ptxas -v``
    log (``chip_smoke.py::ptxas_report``)."""
    from chip_smoke import ptxas_report

    return ptxas_report(log)


def stream_ms(fn) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(ROUNDS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CALLS):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / CALLS)
    return float(np.median(times))


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_tile_f32_gpu: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    jobs = {g: build(g) for g in (*GEOMETRIES, *sys.argv[1:])}
    libs, regs = {}, {}
    for g, (path, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {g}:\n{err}")
        lib = ctypes.CDLL(path)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.k1_fused_mlp.argtypes = [p, p, i, i, p, p, i, i, i, p]
        lib.k2_fused_loglik_gram.argtypes = [p, p, i, i, p, p, i, p]
        libs[g], regs[name(g)] = lib, registers(err)

    model = DirectEmulator.from_checkpoint(
        os.path.join(ROOT, "pretrained", "direct_synthetic.npz"), device=dev)
    rng = np.random.default_rng(0)
    obs = model.predict(synthetic_params(1, rng)[0]) + rng.normal(0.0, 5.0, 451)
    k1 = make_fused_loglik(model.config, model.normalizer, obs, 25.0, precision="contract",
                           device=dev).mlp
    ops1 = k1.operands(model.params)
    k2 = make_fused_loglik_gram(model.config, model.normalizer, obs, 25.0,
                                precision="contract", device=dev)
    ops2 = k2.operands(model.params)
    w1 = (ctypes.c_int * len(ops1.widths))(*ops1.widths)
    w2 = (ctypes.c_int * len(ops2.widths))(*ops2.widths)
    p1 = pointers([ops1.w[0], ops1.b[0], *ops1.slabs])
    p2 = pointers([ops2.w0, ops2.b0, *ops2.slabs])

    def call(lib, kernel, rows, x, out):
        s = torch.cuda.current_stream().cuda_stream
        if kernel == "k1_sumsq":
            rc = lib.k1_fused_mlp(x.data_ptr(), out.data_ptr(), x.shape[0], len(ops1.w), w1, p1,
                                  1, 1, rows, s)
        else:
            rc = lib.k2_fused_loglik_gram(x.data_ptr(), out.data_ptr(), x.shape[0],
                                          len(ops2.widths) - 1, w2, p2, rows, s)
        return rc

    result = {}
    for n in ROWS:
        x = torch.as_tensor(synthetic_params(n, rng).astype(np.float32), device=dev)
        for kernel in ("k1_sumsq", "k2"):
            for rows in HEIGHTS:
                runs = []
                for g, lib in libs.items():
                    out = torch.empty(n, device=dev)
                    if call(lib, kernel, rows, x, out) != 0:
                        continue  # this geometry's shared memory does not fit the height
                    runs.append((g, lib, out))
                base = runs[0][2]
                torch.cuda.synchronize()
                for g, _, out in runs:
                    assert torch.equal(out, base), f"{kernel} {rows} {g} differs from {runs[0][0]}"
                times = {}
                for g, lib, out in runs + runs[::-1]:
                    t = stream_ms(lambda: call(lib, kernel, rows, x, out))
                    times.setdefault(name(g), []).append(t)
                result[f"{kernel}/{rows}/{n}"] = {k: sum(v) / len(v) for k, v in times.items()}
        del x
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"device_ms": result, "registers": regs}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
