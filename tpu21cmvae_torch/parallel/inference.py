"""Mesh-split mega-batch inference (the port of
``tpu21cmvae/parallel/inference.py``).

A batch of parameter draws is one call per device: the batch is padded
to a bucket (a power-of-two multiple of the mesh's quantum, by repeating
row 0), split into one chunk per device, each chunk run against that
device's replica of the weights, and the outputs put back in order with
the padding cut off. JAX pads so that its compiled programs see a
bounded set of shapes; the port pads the same way, so a kernel sees the
same bounded set of batch heights (and tile heights) whatever the
request sizes.

The multi-device split is held on a mesh of several CPU entries
(``tests/test_torch_parallel.py``); no test runs it on several GPUs.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from tpu21cmvae_torch.parallel.mesh import Mesh, make_mesh, merge_rows, replicate, split_rows
from tpu21cmvae_torch.utils.profiling import ENTRY, span


def _bucket_size(n: int, quantum: int) -> int:
    """Smallest power-of-two multiple of ``quantum`` ≥ n (min 1 quantum)."""
    b = quantum
    while b < n:
        b *= 2
    return b


class ShardedEmulator:
    """Wrap a ``(weights, raw) → out`` function for mesh-split batched
    inference; ``out`` is (B, …) per row of ``raw``.

    ``predict_fn``: one function that every mesh device calls, or one
    per device in mesh order (a function bound to one device's operands,
    such as a kernel wrapper, serves that device only). ``params`` are
    replicated to every device. Typically built from a model with
    :meth:`for_model`. On a mesh of several processes
    (:func:`~tpu21cmvae_torch.parallel.mesh.multihost_init`) each process
    runs its own entries' chunks and every process gets the whole output
    (``all_gather``); every process must make the same calls.
    """

    def __init__(
        self,
        predict_fn: Union[Callable, Sequence[Callable]],
        params,
        mesh: Optional[Mesh] = None,
        min_quantum: int = 8,
    ):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.devices = self.mesh.device_list
        n_dev = len(self.devices)
        # every bucket must divide evenly across the mesh — lcm, not max,
        # so non-power-of-two meshes (3, 5, 6 devices, …) split cleanly
        self.quantum = math.lcm(min_quantum, n_dev)
        fns = list(predict_fn) if isinstance(predict_fn, (list, tuple)) else [predict_fn] * n_dev
        if len(fns) != n_dev:
            raise ValueError(f"{len(fns)} functions for a {n_dev}-device mesh")
        self.fns = fns
        self.params = replicate(params, self.mesh)

    @classmethod
    def for_model(cls, model, mesh: Optional[Mesh] = None, backend: str = "torch",
                  precision=None, **kwargs):
        """Build from any model exposing ``predict_fn()`` + ``params`` (all
        four families), on ``mesh`` (default: every visible CUDA device).

        ``backend="kernel"`` (the direct family only, as JAX's
        ``"pallas"``) serves through K1, one
        :func:`~tpu21cmvae_torch.ops.kernels.fused_mlp.make_fused_emulate`
        wrapper per device (the counterpart of
        ``parallel/fused.py::sharded_fused_predict``), at ``precision``,
        default the exact-fp32 contract tier that ``predict_fn()`` runs
        (``csrc/fused_mlp.cu``); JAX's Pallas route defaults to bf16x3.
        ``backend="torch"`` (JAX's ``"xla"``) calls the model's
        ``predict_fn``."""
        mesh = mesh if mesh is not None else make_mesh()
        reps = [model.replica(d) if mesh.is_local(i) else None
                for i, d in enumerate(mesh.device_list)]
        if backend == "kernel":
            from tpu21cmvae_torch.models.direct import DirectEmulator
            from tpu21cmvae_torch.ops.kernels.fused_mlp import make_fused_emulate

            if not isinstance(model, DirectEmulator):
                raise ValueError(
                    f"backend='kernel' serves the direct family only; got {type(model).__name__}"
                )
            fns = [None if m is None else make_fused_emulate(
                m.config, m.normalizer, precision="highest" if precision is None else precision,
                device=m.device) for m in reps]
            return cls(fns, model.params, mesh=mesh, **kwargs)
        if backend != "torch":
            raise ValueError(f"backend must be 'torch' or 'kernel'; got {backend!r}")
        # only the direct family's (and the ensemble's) predict_fn takes a tier
        fns = [None if m is None else m.predict_fn() if precision is None
               else m.predict_fn(precision=precision) for m in reps]
        return cls(fns, model.params, mesh=mesh, **kwargs)

    def _run(self, chunks) -> list:
        """Each of this process's devices' function on its chunk (mesh
        order; the other processes' entries are skipped), all launched
        before any output is read back."""
        with torch.no_grad():
            return [fn(p, c) for i, (fn, p, c) in enumerate(zip(self.fns, self.params, chunks))
                    if self.mesh.is_local(i)]

    def __call__(self, raw_params) -> np.ndarray:
        """Emulate a batch of parameter draws; returns a host ndarray.

        Pads to a bucket boundary (replicating row 0, results discarded);
        a single row comes back squeezed, as ``DirectEmulator.predict``
        returns it."""
        with span("call", ENTRY):
            with span("split_rows", ENTRY):
                raw = np.atleast_2d(np.asarray(raw_params, dtype=np.float32))
                n = raw.shape[0]
                b = _bucket_size(n, self.quantum)
                if b != n:
                    raw = np.concatenate([raw, np.broadcast_to(raw[:1], (b - n, raw.shape[1]))],
                                         axis=0)
                # split_rows makes each chunk contiguous: NumPy may lay a padded
                # batch out column-major, and the kernels take row-major rows only
                chunks, sizes = split_rows(torch.as_tensor(raw), self.mesh)
            with span("run", ENTRY):
                outs = self._run(chunks)
            with span("merge_rows", ENTRY):
                out = merge_rows(outs, self.mesh, sizes, "cpu").numpy()[:n]
        return out[0] if n == 1 else out

    def warmup(self, batch_sizes, n_params: int = 7) -> None:
        """Run one call per bucket the given batch sizes hit. Eager PyTorch
        compiles nothing, but the first call builds the kernel library,
        creates the BLAS handles and folds the operands, so a later
        request pays none of it."""
        buckets = sorted({_bucket_size(max(int(n), 1), self.quantum) for n in batch_sizes})
        for b in buckets:
            chunks, _ = split_rows(torch.ones((b, n_params), dtype=torch.float32), self.mesh)
            for o in self._run(chunks):
                o.cpu()

    def device_call(self, raw_params_device):
        """The path for callers that keep data on the devices: no padding,
        no host transfer. A tensor (its batch divisible by the mesh size)
        is split over the mesh and the output comes back as one tensor on
        the input's device; a list of per-device shards
        (:func:`~tpu21cmvae_torch.parallel.mesh.shard_batch`) gives one
        output per device of this process."""
        with span("device_call", ENTRY):
            if isinstance(raw_params_device, (list, tuple)):
                with span("run", ENTRY):
                    return self._run(raw_params_device)
            x = raw_params_device
            if x.shape[0] % len(self.devices):
                raise ValueError(
                    f"the batch ({x.shape[0]}) must divide evenly across the "
                    f"{len(self.devices)}-device mesh"
                )
            with span("split_rows", ENTRY):
                chunks, sizes = split_rows(x, self.mesh)
            with span("run", ENTRY):
                outs = self._run(chunks)
            with span("merge_rows", ENTRY):
                return merge_rows(outs, self.mesh, sizes, x.device)
