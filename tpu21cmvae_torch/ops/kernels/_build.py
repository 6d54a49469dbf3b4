"""Build the port's CUDA kernels from the ``csrc/`` sources at first use,
and load them with ``ctypes``.

Every ``.cu`` file in ``csrc/`` (each may include the shared ``.cuh``
headers there) is compiled by its own ``nvcc`` process, all of them at
once, and the objects are linked into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds). The library
lands in ``build/tpu21cmvae_torch/`` at the root of the checkout, named
by a hash of the sources, headers and flags, so an edited source
rebuilds and an unchanged one loads the library already there; beside
it, ``ptxas``'s report of every kernel's registers and spills. Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(CSRC)))),
    "build",
    "tpu21cmvae_torch",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA toolkit is "
            "needed to build the port's kernels"
        )
    return path


def _files(*suffixes):
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(suffixes)
    )


def library_path() -> str:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _files(".cu", ".cuh"):
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libt21kernels-{h.hexdigest()[:16]}.so")


def ptxas_log_path(lib: str) -> str:
    """Where ``ptxas -v``'s report for the library ``lib`` lives."""
    return lib + ".ptxas.txt"


def _run_all(commands) -> str:
    """Start every command at once; raise with the stderr of the ones
    that fail, else return their stderr joined."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in commands]
    failed, logs = [], []
    for cmd, proc in zip(commands, procs):
        _, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} (exit {proc.returncode}):\n{err}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return "".join(logs)


def build() -> str:
    """Compile the sources unless the library for them exists; returns
    its path. Raises with nvcc's stderr if the build fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        nvcc = _nvcc()
        objects = []
        compiles = []
        for src in _files(".cu"):
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            objects.append(obj)
            compiles.append([nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", obj, src])
        report = _run_all(compiles)
        lib = os.path.join(tmp, "lib.so")
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objects]])
        with open(ptxas_log_path(out), "w") as fh:
            fh.write(report)
        os.replace(lib, out)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C
    signatures."""
    lib = ctypes.CDLL(build())
    p, i = ctypes.c_void_p, ctypes.c_int
    # every entry: x, outputs, n_rows, n_layers, widths, ptrs, member
    # strides, n_members, then its own ints and the stream
    lib.k1_fused_mlp.argtypes = [p, p, i, i, p, p, p, i, i, i, i, p]
    lib.k1_fused_mlp_mma.argtypes = [p, p, i, i, p, p, p, i, i, i, i, p]
    lib.k2_fused_loglik_gram.argtypes = [p, p, i, i, p, p, p, i, i, p]
    lib.k2_fused_loglik_gram_mma.argtypes = [p, p, i, i, p, p, p, i, i, p]
    # the wide route: 11 ints of its plan and grid, then the workspace
    wide = [i] * 11 + [p, p]
    lib.k3_fused_loglik_grad_gram.argtypes = [p, p, p, i, i, p, p, p, i, *wide]
    lib.k2_fused_loglik_gram_wide.argtypes = [p, p, i, i, p, p, p, i, *wide]
    # K1 on the wide route: the same, then log_clamp and reduce before the stream
    lib.k1_fused_mlp_wide.argtypes = [p, p, i, i, p, p, p, i, *wide[:-1], i, i, p]
    lib.k3_fused_loglik_grad_gram_f32.argtypes = [p, p, p, i, i, p, p, p, i, i, p]
    lib.k3_fused_loglik_grad_gram_mma.argtypes = [p, p, p, i, i, p, p, p, i, i, i, p]
    lib.k3_fused_loglik_grad_gram_mixed.argtypes = [p, p, p, i, i, p, p, p, i, i, i, p]
    lib.k3_fused_loglik_grad_gram_reverse.argtypes = [p, p, p, i, i, p, p, p, i, i, p]
    # the tall route: both tier codes, then its plan and its grid
    lib.k3_fused_loglik_grad_gram_tall.argtypes = [p, p, p, i, i, p, p, p, i, i, i, p, i, p]
    for entry in ("k1_fused_mlp", "k1_fused_mlp_mma", "k1_fused_mlp_wide",
                  "k2_fused_loglik_gram", "k2_fused_loglik_gram_mma", "k2_fused_loglik_gram_wide",
                  "k3_fused_loglik_grad_gram",
                  "k3_fused_loglik_grad_gram_f32", "k3_fused_loglik_grad_gram_mma",
                  "k3_fused_loglik_grad_gram_mixed", "k3_fused_loglik_grad_gram_reverse",
                  "k3_fused_loglik_grad_gram_tall"):
        getattr(lib, entry).restype = i
    lib.t21_error_string.argtypes = [i]
    lib.t21_error_string.restype = ctypes.c_char_p
    return lib
