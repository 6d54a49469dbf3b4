"""Build the port's CUDA kernels from the ``csrc/*.cu`` sources at first
use, and load them with ``ctypes``.

Every ``.cu`` file in ``csrc/`` is compiled by ``nvcc`` into one shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds). The library lands in ``build/tpu21cmvae_torch/`` at the root of
the checkout, named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads the library already there.
Nothing here runs at import time.
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
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


def _sources():
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cu")
    )


def library_path() -> str:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libt21kernels-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources unless the library for them exists; returns
    its path. Raises with nvcc's stderr if the build fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.part")
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}):\n{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C
    signatures."""
    lib = ctypes.CDLL(build())
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.k3_fused_loglik_grad_gram.argtypes = [p, p, p, i, i, p, p, i, i, p]
    lib.k3_fused_loglik_grad_gram.restype = i
    lib.k3_error_string.argtypes = [i]
    lib.k3_error_string.restype = ctypes.c_char_p
    return lib
