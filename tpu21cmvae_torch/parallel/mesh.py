"""The device mesh of one process and its placement helpers (the port of
``tpu21cmvae/parallel/mesh.py``).

JAX's mesh is one process driving every local device along one
``"data"`` axis: weights replicated, the batch split over the devices.
The port keeps that model: a :class:`Mesh` is a tuple of
``torch.device``\\ s, :func:`replicate` copies a tree of tensors to each
of them and :func:`shard_batch` splits a batch's leading axis into one
chunk per device. Several processes (``torch.distributed``) are not part
of this module: :func:`multihost_init` refuses, naming the slice of the
port that brings them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tpu21cmvae_torch.utils.tree import tree_map

DATA_AXIS = "data"


class Mesh:
    """A 1-D mesh: ``devices`` in order, one named axis.

    ``.devices`` is a NumPy object array, so ``mesh.devices.size`` and
    ``mesh.devices.ravel()`` read as they do on a JAX mesh."""

    def __init__(self, devices: Sequence, axis_names: Tuple[str, ...] = (DATA_AXIS,)):
        devs = [torch.empty(0, device=d).device for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = np.empty(len(devs), dtype=object)
        self.devices[:] = devs
        self.axis_names = tuple(axis_names)

    @property
    def device_list(self) -> list:
        return list(self.devices.ravel())

    def __repr__(self) -> str:
        return f"Mesh(devices={[str(d) for d in self.device_list]}, axis_names={self.axis_names})"


def make_mesh(devices: Optional[Sequence] = None, axis: str = DATA_AXIS) -> Mesh:
    """1-D mesh over the given devices, or over every visible CUDA device.
    Without a CUDA device and without ``devices`` it raises: it never
    falls back to the CPU (pass ``devices=[torch.device("cpu")]`` for
    that)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() takes every visible CUDA device and none is visible; "
                "pass devices= (e.g. [torch.device('cpu')]) to build a mesh without one"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return Mesh(devices, (axis,))


def multihost_init(**kwargs) -> None:
    """JAX's multi-host initialization. The port's mesh is one process;
    several processes wait for the port of ``parallel/``'s distributed
    half (``torch.distributed``: data-parallel training and walkers
    sharded over devices)."""
    raise NotImplementedError(
        "multihost_init: several processes wait for the port of parallel/'s distributed "
        "half (torch.distributed); a Mesh here is one process's local devices"
    )


def tree_to(tree, device):
    """``tree`` (dicts, tuples, lists, dataclasses of tensors) with every
    tensor on ``device``; a tensor already there is the same object, so
    identity-keyed operand caches stay valid."""
    return tree_map(lambda t: t.to(device) if isinstance(t, torch.Tensor) else t, tree)


def replicate(tree, mesh: Mesh) -> list:
    """One copy of ``tree`` per mesh device, in mesh order (the weights)."""
    return [tree_to(tree, d) for d in mesh.device_list]


def shard_batch(x, mesh: Mesh, axis: str = DATA_AXIS) -> list:
    """Split the leading (batch) axis of ``x`` into one equal chunk per
    mesh device, each on its device. The batch must divide evenly."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has axes {mesh.axis_names}; got {axis!r}")
    x = torch.as_tensor(x)
    n_dev = mesh.devices.size
    if x.shape[0] % n_dev:
        raise ValueError(
            f"the leading dimension ({x.shape[0]}) must divide evenly across the "
            f"{n_dev}-device mesh"
        )
    return [c.to(d) for c, d in zip(torch.tensor_split(x, n_dev), mesh.device_list)]
