"""Data-parallel training over a device mesh (the port of
``tpu21cmvae/parallel/train_dp.py``).

JAX trains data-parallel by sharding every batch over the mesh and
letting XLA insert the gradient all-reduce. The port makes that
all-reduce explicit: each batch (its rows padded to a mesh multiple by
cycling real rows, the pad rows weighted 0, as :func:`_pad_to_mesh`
pads) is cut into one chunk per mesh device; each device takes its
chunk's masked loss sum and that sum's gradient on its own replica of
the weights; the gradients are summed onto the weights' device in mesh
order (and across processes by ``all_reduce(SUM)``), then divided by the
batch's real row count. Adam then runs once, on every process alike, on
that reduced gradient, and the replicas are refreshed in place from the
updated weights: their identity stays, their version counter moves, so
an operand cache keyed on both refolds.

The loss function runs on every mesh device: like a plain likelihood on
a mesh, it must accept weights and rows there.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu21cmvae_torch.parallel.mesh import DeviceCopies, Mesh, all_reduce_sum
from tpu21cmvae_torch.train.adam import adam_init, adam_update
from tpu21cmvae_torch.train.loop import fit
from tpu21cmvae_torch.utils.config import TrainConfig
from tpu21cmvae_torch.utils.tree import tree_leaves


def _pad_to_mesh(x, mesh: Mesh):
    """Pad the leading axis to a mesh-size multiple by cycling real rows
    (finite values: a 0-weight row must not produce a NaN loss, since
    ``0 × NaN = NaN`` would poison the masked reduction). Returns
    ``(padded_array, n_real)``; no-op when already divisible. A tensor
    stays a tensor, anything else becomes float32 NumPy.

    Real split sizes are rarely divisible (21cmGEM: 26,889 train / 1,704
    val — reference ``sample_notebook.ipynb`` cell 19)."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x, np.float32)
    n = x.shape[0]
    pad = (-n) % mesh.size
    if pad == 0:
        return x, n
    reps = -(-pad // n)  # pad may exceed n for tiny arrays
    if isinstance(x, torch.Tensor):
        return torch.cat([x, torch.cat([x] * reps)[:pad]]), n
    return np.concatenate([x, np.concatenate([x] * reps, axis=0)[:pad]], axis=0), n


class _DataParallel:
    """The step :func:`~tpu21cmvae_torch.train.loop.fit` runs in place of
    its own when training data-parallel (its ``_dp``): one batch's
    masked loss sum and gradient per mesh device, reduced, then one Adam
    update (:meth:`train_step`); the validation pass split alike
    (:meth:`evaluate`). ``stochastic``: the loss's first extra argument
    is a source of normals, which each chunk reads its rows of."""

    def __init__(self, mesh: Mesh, stochastic: bool = False):
        self.mesh, self.stochastic = mesh, stochastic
        # the weights on each mesh device, refreshed after each Adam update
        self._replica = DeviceCopies(requires_grad=True)

    def _chunk_args(self, args, rows, n, device):
        """The loss's extra arguments for one chunk: a stochastic loss's
        source of normals draws for the whole batch (the draw a
        one-device step sees) and hands the chunk its rows."""
        if not self.stochastic:
            return args
        src = args[0]

        def noise(shape):
            return src((n, *tuple(shape)[1:]))[rows].to(device)

        return (noise, *args[1:])

    def _sums(self, params, loss_fn, x, y, args, grad: bool):
        """``(masked loss sum, [gradient sums] or None)`` over the rows of
        ``x``, on the weights' device, reduced over the mesh."""
        n = x.shape[0]
        idx, _ = _pad_to_mesh(torch.arange(n, device=x.device), self.mesh)
        weight = (torch.arange(idx.shape[0], device=x.device) < n).to(x.dtype)
        size = idx.shape[0] // self.mesh.size
        home = tree_leaves(params)[0].device
        total, grads = None, None
        for i, d in enumerate(self.mesh.device_list):
            if not self.mesh.is_local(i):
                continue
            rows = idx[i * size: (i + 1) * size]
            p = self._replica(params, d)
            leaves = tree_leaves(p)
            loss = loss_fn(p, x[rows].to(d), y[rows].to(d),
                           *self._chunk_args(args, rows, n, d))
            s = (loss * weight[i * size: (i + 1) * size].to(d)).sum()
            g = torch.autograd.grad(s, leaves) if grad else ()
            s, g = s.detach().to(home), [t.to(home) for t in g]
            total = s if total is None else total + s
            if grad:
                grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        if self.mesh.n_processes > 1:
            # one all-reduce of the loss and every gradient, packed flat
            parts = [total.reshape(1)] + ([t.reshape(-1) for t in grads] if grad else [])
            flat = all_reduce_sum(torch.cat(parts))
            total, off = flat[0], 1
            if grad:
                out = []
                for t in grads:
                    out.append(flat[off: off + t.numel()].reshape(t.shape))
                    off += t.numel()
                grads = out
        return total, grads

    def train_step(self, params, leaves, loss_fn, bx, by, state, lr, cfg: TrainConfig,
                   args=()):
        """:func:`~tpu21cmvae_torch.train.loop._train_step` over the mesh:
        ``(mean loss, state)``, ``leaves`` updated in place."""
        total, grads = self._sums(params, loss_fn, bx, by, args, grad=True)
        n = bx.shape[0]
        state = adam_update([g / n for g in grads], leaves, state, lr, beta_1=cfg.beta_1,
                            beta_2=cfg.beta_2, epsilon=cfg.epsilon)
        return total / n, state

    @torch.no_grad()
    def evaluate(self, params, loss_fn, x, y, n_real: int, extra=()):
        """Mean per-sample loss over the first ``n_real`` rows."""
        total, _ = self._sums(params, loss_fn, x[:n_real], y[:n_real], extra, grad=False)
        return total / n_real


def make_dp_train_step(loss_fn, cfg: TrainConfig, mesh: Mesh):
    """One data-parallel train step: ``(params, opt_state, lr, bx, by) →
    (params, opt_state, loss)``. ``params`` (a tree of float32 leaf
    tensors on one device, which holds the result) are updated in place;
    ``opt_state`` None starts Adam; the batch is one tensor or
    :func:`~tpu21cmvae_torch.parallel.mesh.shard_batch`'s chunks. The
    all-reduce is the explicit one of this module's docstring."""
    dp = _DataParallel(mesh)

    def step(params, opt_state, lr, bx, by):
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        home = leaves[0].device
        bx, by = (torch.cat([c.to(home) for c in b]) if isinstance(b, (list, tuple))
                  else torch.as_tensor(b, device=home) for b in (bx, by))
        state = adam_init(params) if opt_state is None else opt_state
        loss, state = dp.train_step(params, leaves, loss_fn, bx, by, state, float(lr), cfg)
        return params, state, loss

    return step


def _dp_args(mesh, x_train, y_train, x_val, y_val):
    """The four splits padded to mesh multiples and their real counts."""
    x_train, n_train = _pad_to_mesh(x_train, mesh)
    y_train, _ = _pad_to_mesh(y_train, mesh)
    x_val, n_val = _pad_to_mesh(x_val, mesh)
    y_val, _ = _pad_to_mesh(y_val, mesh)
    return (x_train, y_train, x_val, y_val), n_train, n_val


def dp_fit(
    params,
    loss_fn,
    x_train,
    y_train,
    x_val,
    y_val,
    cfg: TrainConfig,
    mesh: Mesh,
    *,
    opt_state=None,
    stochastic: bool = False,
    pass_epoch: bool = False,
    verbose: bool = False,
    **fit_kwargs,
):
    """Data-parallel :func:`~tpu21cmvae_torch.train.loop.fit`: the same
    epochs, shuffles, callbacks and checkpoints, every batch and the
    validation pass split over ``mesh``. Split sizes need not divide the
    mesh: the splits are padded to mesh multiples (:func:`_pad_to_mesh`)
    and only their real rows are drawn, and each batch is padded and
    weight-masked as the module docstring says, so the run follows the
    one-device one up to the summation order."""
    splits, n_train, n_val = _dp_args(mesh, x_train, y_train, x_val, y_val)
    return fit(params, loss_fn, *splits, cfg, opt_state=opt_state, stochastic=stochastic,
               pass_epoch=pass_epoch, verbose=verbose, n_train_real=n_train,
               n_val_real=n_val, _dp=_DataParallel(mesh, stochastic), **fit_kwargs)


def dp_fit_scan(
    params,
    loss_fn,
    x_train,
    y_train,
    x_val,
    y_val,
    cfg: TrainConfig,
    mesh: Mesh,
    *,
    opt_state=None,
    stochastic: bool = False,
    pass_epoch: bool = False,
):
    """Data-parallel :func:`~tpu21cmvae_torch.train.scan.fit_scan` (the
    device-loop trainer's float32 callback semantics), split over
    ``mesh`` as :func:`dp_fit`."""
    from tpu21cmvae_torch.train.scan import fit_scan

    splits, n_train, n_val = _dp_args(mesh, x_train, y_train, x_val, y_val)
    return fit_scan(params, loss_fn, *splits, cfg, opt_state=opt_state, stochastic=stochastic,
                    pass_epoch=pass_epoch, n_train_real=n_train, n_val_real=n_val,
                    _dp=_DataParallel(mesh, stochastic))
