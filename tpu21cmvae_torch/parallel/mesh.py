"""The device mesh, its placement helpers and the processes behind it
(the port of ``tpu21cmvae/parallel/mesh.py``).

JAX's mesh is every device of every process along one ``"data"`` axis:
weights replicated, the batch split over the devices. The port keeps
that model: a :class:`Mesh` is a tuple of ``torch.device``\\ s, each
owned by one process, :func:`replicate` copies a tree of tensors to each
of them and :func:`shard_batch` splits a batch's leading axis into one
chunk per device. :func:`split_rows` and :func:`merge_rows` are the one
split and gather of every mesh-split call (``ShardedEmulator``, the
samplers' ``MeshSplit``), and :func:`replicable` / :func:`replica_of`
the one way a device-bound function is made again on another device.
Without :func:`multihost_init` every entry belongs to
this process. After it, :func:`make_mesh` returns the global mesh: each
process's local devices in process order, of which this process drives
only its own (:attr:`Mesh.local_devices`), and the per-row results meet
through :func:`all_gather_rows` and :func:`all_reduce_sum`.
"""

from __future__ import annotations

import datetime
import socket
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu21cmvae_torch.utils.tree import tree_map

DATA_AXIS = "data"

# the process group multihost_init formed: every process's local CUDA
# devices (as strings), and the NCCL group when each process has cards of
# its own (None: collectives of CUDA tensors run on the gloo group)
_GROUP = {"layout": None, "nccl": None}


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class Mesh:
    """A 1-D mesh: ``devices`` in order, one named axis, and the process
    that owns each entry.

    ``.devices`` is a NumPy object array, so ``mesh.devices.size``,
    ``mesh.size`` and ``mesh.devices.ravel()`` read as they do on a JAX
    mesh. ``processes`` (default: all this process's) gives each entry's
    owner, in the process order of ``torch.distributed``; an entry owned
    by another process names a device of that process."""

    def __init__(self, devices: Sequence, axis_names: Tuple[str, ...] = (DATA_AXIS,),
                 processes: Optional[Sequence[int]] = None):
        devices = list(devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.process_index = _rank()
        procs = ([self.process_index] * len(devices) if processes is None
                 else [int(p) for p in processes])
        if len(procs) != len(devices):
            raise ValueError(f"{len(procs)} process indices for {len(devices)} devices")
        if procs != sorted(procs):
            raise ValueError("a mesh lists each process's devices together, in process order")
        # a local device must exist (no fallback); another process's is a name
        devs = [torch.empty(0, device=d).device if p == self.process_index else torch.device(d)
                for d, p in zip(devices, procs)]
        self.devices = np.empty(len(devs), dtype=object)
        self.devices[:] = devs
        self.processes = tuple(procs)
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_list(self) -> list:
        return list(self.devices.ravel())

    @property
    def n_processes(self) -> int:
        return len(set(self.processes))

    def is_local(self, i: int) -> bool:
        """Whether this process drives entry ``i``."""
        return self.processes[i] == self.process_index

    @property
    def local_devices(self) -> list:
        """The entries this process drives, in mesh order."""
        return [d for i, d in enumerate(self.device_list) if self.is_local(i)]

    def __repr__(self) -> str:
        procs = "" if self.n_processes == 1 else f", processes={list(self.processes)}"
        return (f"Mesh(devices={[str(d) for d in self.device_list]}, "
                f"axis_names={self.axis_names}{procs})")


def _visible_cuda(local_device_ids) -> List[torch.device]:
    if not torch.cuda.is_available():
        return []
    ids = range(torch.cuda.device_count()) if local_device_ids is None else local_device_ids
    return [torch.device("cuda", int(i)) for i in ids]


def _card_id(d: torch.device) -> str:
    """A name of the physical card behind ``d`` that two processes on one
    host agree on (its UUID where PyTorch reads one)."""
    uuid = getattr(torch.cuda.get_device_properties(d), "uuid", None)
    return str(uuid) if uuid is not None else f"{socket.gethostname()}:{d.index}"


def multihost_init(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   local_device_ids: Optional[Sequence[int]] = None,
                   initialization_timeout: int = 300) -> None:
    """Join ``num_processes`` processes into one ``torch.distributed``
    group (the keywords of JAX's ``jax.distributed.initialize``): process
    ``process_id`` of them, meeting at ``tcp://<coordinator_address>``
    (``host:port``; process 0 listens there). Nothing detects a cluster:
    all three are required. ``local_device_ids``: the CUDA devices this
    process drives (default: every visible one).

    The default group is gloo. When every process has CUDA devices and no
    card is driven by two processes, an NCCL group is formed beside it and
    carries the collectives of CUDA tensors; NCCL refuses two processes on
    one card, so processes that share one keep gloo, which moves CUDA
    tensors through the host itself. A group that fails to form raises
    (after ``initialization_timeout`` seconds at most)."""
    import torch.distributed as dist

    if None in (coordinator_address, num_processes, process_id):
        raise ValueError("multihost_init needs coordinator_address, num_processes and "
                         "process_id: nothing here detects a cluster")
    if dist.is_initialized():
        raise RuntimeError("multihost_init: torch.distributed is already initialized")
    timeout = datetime.timedelta(seconds=initialization_timeout)
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=timeout)
    local = _visible_cuda(local_device_ids)
    layout = [None] * int(num_processes)
    dist.all_gather_object(layout, ([str(d) for d in local], [_card_id(d) for d in local]))
    cards = [c for _, ids in layout for c in ids]
    own_cards = all(ids for _, ids in layout) and len(set(cards)) == len(cards)
    _GROUP["layout"] = [devs for devs, _ in layout]
    _GROUP["nccl"] = dist.new_group(backend="nccl", timeout=timeout) if own_cards else None


def make_mesh(devices: Optional[Sequence] = None, axis: str = DATA_AXIS) -> Mesh:
    """1-D mesh over the given devices, or over every visible CUDA device.
    Without a CUDA device and without ``devices`` it raises: it never
    falls back to the CPU (pass ``devices=[torch.device("cpu")]`` for
    that).

    After :func:`multihost_init` the mesh is global: ``devices`` (default:
    the process's ``local_device_ids``) are this process's entries, and
    every process must call ``make_mesh`` alike, since the lists are
    exchanged."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        if devices is None:
            layout = _GROUP["layout"]
            if layout is None or not all(layout):
                raise RuntimeError("make_mesh(): a process has no CUDA device; pass devices=")
        else:
            layout = [None] * dist.get_world_size()
            dist.all_gather_object(layout, [str(torch.device(d)) for d in devices])
        flat = [(d, p) for p, devs in enumerate(layout) for d in devs]
        return Mesh([d for d, _ in flat], (axis,), processes=[p for _, p in flat])
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() takes every visible CUDA device and none is visible; "
                "pass devices= (e.g. [torch.device('cpu')]) to build a mesh without one"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return Mesh(devices, (axis,))


def tree_to(tree, device):
    """``tree`` (dicts, tuples, lists, dataclasses of tensors) with every
    tensor on ``device``; a tensor already there is the same object, so
    identity-keyed operand caches stay valid."""
    return tree_map(lambda t: t.to(device) if isinstance(t, torch.Tensor) else t, tree)


class DeviceCopies:
    """A tree of tensors on whichever device it is asked for: the tree
    itself where its tensors already are, else one copy per device, made
    once and refreshed in place whenever the source tensors' version
    counters move (an in-place weight update). A copy keeps its identity,
    so an operand cache keyed on identity and version refolds exactly
    when the weights change. ``requires_grad``: the copies are leaves
    that take gradients (data-parallel training)."""

    def __init__(self, requires_grad: bool = False):
        self.requires_grad = requires_grad
        self._hits = {}

    def __call__(self, tree, device):
        from tpu21cmvae_torch.utils.tree import tree_leaves

        src = [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]
        if all(t.device == device for t in src):
            return tree
        versions = [t._version for t in src]
        hit = self._hits.get(device)
        if hit is None or len(hit[0]) != len(src) or any(a is not b for a, b in zip(hit[0], src)):
            copy = tree_map(lambda t: t.detach().to(device).requires_grad_(self.requires_grad)
                            if isinstance(t, torch.Tensor) else t, tree)
            hit = self._hits[device] = [src, versions, copy]
        elif hit[1] != versions:
            with torch.no_grad():
                for dst, t in zip(tree_leaves(hit[2]), src):
                    dst.copy_(t)
            hit[1] = versions
        return hit[2]


def _canonical(device) -> torch.device:
    return torch.empty(0, device=device).device


def replicable(build, device):
    """``build(device)``, a callable bound to ``device`` (a likelihood, its
    kernel wrapper and plain twin), given a ``replica(d)`` that is
    ``build(d)``: the same callable made again on ``d``, and itself on its
    own device. The one way the port remakes a device-bound callable for
    a mesh; a composite (``RoutedLoglik``, ``MixtureLoglik``) defines
    ``replica`` as the composite of its parts' replicas."""
    home = _canonical(device)
    fn = build(home)

    def replica(d):
        d = _canonical(d)
        return fn if d == home else replicable(build, d)

    fn.replica = replica
    return fn


def replica_of(fn, device):
    """``fn``'s replica on ``device`` (its ``replica(device)``), made once
    and cached on ``fn``, keyed by the device; a callable without
    ``replica`` is itself on every device, so it must take rows on each
    device it is given them on."""
    make = getattr(fn, "replica", None)
    if make is None:
        return fn
    device = _canonical(device)
    cache = fn.__dict__.setdefault("_t21_replicas", {})
    if device not in cache:
        cache[device] = make(device)
    return cache[device]


def replicate(tree, mesh: Mesh) -> list:
    """One copy of ``tree`` per mesh device, in mesh order (the weights).
    Entries of other processes get None: their process holds them."""
    return [tree_to(tree, d) if mesh.is_local(i) else None
            for i, d in enumerate(mesh.device_list)]


def shard_batch(x, mesh: Mesh, axis: str = DATA_AXIS) -> list:
    """Split the leading (batch) axis of ``x`` into one equal chunk per
    mesh device, each on its device (None for another process's entry).
    The batch must divide evenly."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has axes {mesh.axis_names}; got {axis!r}")
    x = torch.as_tensor(x)
    n_dev = mesh.devices.size
    if x.shape[0] % n_dev:
        raise ValueError(
            f"the leading dimension ({x.shape[0]}) must divide evenly across the "
            f"{n_dev}-device mesh"
        )
    return [c.to(d) if mesh.is_local(i) else None
            for i, (c, d) in enumerate(zip(torch.tensor_split(x, n_dev), mesh.device_list))]


def split_rows(x: torch.Tensor, mesh: Mesh, groups: int = 1):
    """``x``'s rows cut into one contiguous chunk per mesh entry, each on
    its entry's device (None for another process's entry), and the rows
    each entry takes: the first ``n % mesh.size`` entries one more than
    the rest. ``groups``: ``x`` is that many equal blocks of rows (the
    stacked-observation likelihoods' observation-major rows), each cut
    alike, and a chunk holds its slice of every block."""
    blocks = x.reshape(groups, -1, *x.shape[1:])
    q, r = divmod(blocks.shape[1], mesh.size)
    sizes = [q + (i < r) for i in range(mesh.size)]
    starts = np.cumsum([0] + sizes)
    chunks = [blocks[:, starts[i]: starts[i + 1]].reshape(-1, *x.shape[1:]).to(d).contiguous()
              if mesh.is_local(i) else None
              for i, d in enumerate(mesh.device_list)]
    return chunks, sizes


def merge_rows(outs: list, mesh: Mesh, sizes: Sequence[int], device, groups: int = 1):
    """The inverse of :func:`split_rows`: the outputs of this process's
    entries (mesh order; each a tensor or a tuple of tensors with the
    chunk's rows leading) as one tensor (or tuple) on ``device`` in the
    rows' order, the other processes' entries gathered in
    (:func:`all_gather_rows`), so every process returns the whole."""
    if isinstance(outs[0], tuple):
        return tuple(merge_rows([o[k] for o in outs], mesh, sizes, device, groups)
                     for k in range(len(outs[0])))
    parts = [o.to(device) for o in outs]
    if mesh.n_processes > 1:
        per_proc = [[groups * s for s, p in zip(sizes, mesh.processes) if p == q]
                    for q in sorted(set(mesh.processes))]
        gathered = all_gather_rows(torch.cat(parts), [sum(c) for c in per_proc])
        parts = [t for rows, c in zip(gathered, per_proc) for t in torch.split(rows, c)]
    tail = parts[0].shape[1:]
    return torch.cat([p.reshape(groups, s, *tail) for p, s in zip(parts, sizes)],
                     dim=1).reshape(-1, *tail)


# -- collectives across the mesh's processes ----------------------------------


def _group_for(t: torch.Tensor):
    """The group a collective of ``t`` runs on: NCCL's for a CUDA tensor
    when :func:`multihost_init` formed one, else the default gloo group.
    Gloo takes CUDA tensors in ``all_gather``, ``all_reduce`` and
    ``broadcast`` (probed by ``chip_smoke.py`` phase 21 on torch 2.11
    with CUDA 12.8), copying them through the host itself, so no
    collective here stages them."""
    return _GROUP["nccl"] if t.device.type == "cuda" else None


def all_gather_rows(local: torch.Tensor, counts: Sequence[int]) -> list:
    """Every process's rows, one tensor per process in process order, on
    ``local``'s device: process ``p`` contributes ``counts[p]`` rows
    (``local`` holds this process's). Each process sends its rows padded
    to the largest count, since ``all_gather`` takes equal shapes."""
    import torch.distributed as dist

    width = max(counts)
    pad = local.new_zeros((width - local.shape[0], *local.shape[1:]))
    mine = (torch.cat([local, pad]) if pad.shape[0] else local).contiguous()
    parts = [torch.empty_like(mine) for _ in counts]
    dist.all_gather(parts, mine, group=_group_for(local))
    return [p[:n] for p, n in zip(parts, counts)]


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over every process (a new tensor on ``t``'s device)."""
    import torch.distributed as dist

    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=_group_for(t))
    return out
