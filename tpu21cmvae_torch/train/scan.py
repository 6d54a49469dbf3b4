"""The device-loop trainer's semantics (the port of
``tpu21cmvae/train/scan.py``).

In the JAX package :func:`fit_scan` is one XLA program: a ``lax.scan``
over epochs whose carry holds the parameters, the Adam moments, a float32
learning rate and both callbacks' monitors, with the stop decision as a
carried flag. This port keeps what a caller can see of it — the same
float32 callback arithmetic, hence the same history, stop epoch and best
epoch, and an empty ``epoch_time_s`` — and runs the epochs of
:func:`~tpu21cmvae_torch.train.loop.fit`, reading the device once per
epoch. The one-program mechanism is not ported: capturing a whole run as
a CUDA graph is ROADMAP queue 1 item 2's work (taking the host out of
the loops), not a port of these semantics.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tpu21cmvae_torch.sampling._common import _as_mesh
from tpu21cmvae_torch.train import loop
from tpu21cmvae_torch.train.adam import AdamState, adam_init
from tpu21cmvae_torch.train.loop import (
    History,
    LossFn,
    _assign,
    _evaluate,
    _epoch_args,
    _prepare,
    _run_epoch,
)
from tpu21cmvae_torch.utils.config import TrainConfig
from tpu21cmvae_torch.utils.tree import tree_leaves, tree_map


def fit_scan(
    params,
    loss_fn: LossFn,
    x_train,
    y_train,
    x_val,
    y_val,
    cfg: TrainConfig,
    *,
    opt_state: Optional[AdamState] = None,
    stochastic: bool = False,
    pass_epoch: bool = False,
    n_train_real: Optional[int] = None,
    n_val_real: Optional[int] = None,
    _dp=None,
):
    """Train ``params`` in place with the JAX whole-run program's
    semantics; returns ``(params, opt_state, History)``.

    The contract of :func:`~tpu21cmvae_torch.train.loop.fit` without its
    host hooks (progress bar, epoch callback, checkpoints), ``_dp``
    included. The learning
    rate and both monitors are float32, as in the JAX scan's carry: a
    plateau multiplies the float32 rate, and an improvement is
    ``val < best − min_delta`` in float32. ``stochastic=True`` draws
    through the host loop's seam, as there.
    """
    device, x_train, y_train, x_val, y_val, n_real, nv_real = _prepare(
        params, x_train, y_train, x_val, y_val, n_train_real, n_val_real)
    if opt_state is None:
        opt_state = adam_init(params)
    f32 = np.float32
    use_early = cfg.early_stop_patience is not None
    use_plateau = cfg.plateau_patience is not None
    es_min_delta, pl_min_delta = f32(abs(cfg.early_stop_min_delta)), f32(abs(cfg.plateau_min_delta))
    min_lr, factor = f32(cfg.plateau_min_lr), f32(cfg.plateau_factor)

    lr = f32(cfg.learning_rate)
    es_best, es_wait, es_best_epoch, best_params = f32(np.inf), 0, -1, None
    pl_best, pl_wait = f32(np.inf), 0
    stopped_at = -1
    losses, val_losses, lrs = [], [], []
    for_epoch, extra_val = _epoch_args(cfg, stochastic, pass_epoch, device)
    for epoch in range(cfg.epochs):
        perm = loop._permutation(cfg.seed, epoch, n_real, device)  # the draw seam
        opt_state, train_loss = _run_epoch(params, loss_fn, x_train, y_train, opt_state,
                                           lr, cfg, perm, *for_epoch(epoch), dp=_dp)
        val_loss = _evaluate(params, loss_fn, x_val, y_val, nv_real, extra_val, dp=_dp)
        train_loss, val_loss = (f32(v) for v in torch.stack([train_loss, val_loss]).tolist())
        losses.append(train_loss)
        val_losses.append(val_loss)
        lrs.append(lr)  # the rate the epoch ran with

        if use_early:
            if val_loss < f32(es_best - es_min_delta):
                es_best, es_best_epoch, es_wait = val_loss, epoch, 0
                best_params = tree_map(lambda t: t.detach().clone(), params)
            else:
                es_wait += 1
            if es_wait >= cfg.early_stop_patience:
                stopped_at = epoch
        if use_plateau:
            if val_loss < f32(pl_best - pl_min_delta):
                pl_best, pl_wait = val_loss, 0
            else:
                pl_wait += 1
            if pl_wait >= cfg.plateau_patience and lr > min_lr:
                lr = max(f32(lr * factor), min_lr)
                pl_wait = 0
        if stopped_at >= 0:
            break  # the scan's later epochs are no-ops

    if use_early and cfg.restore_best_weights and stopped_at >= 0 and es_best_epoch >= 0:
        _assign(params, best_params)
    history = History(
        loss=[float(v) for v in losses],
        val_loss=[float(v) for v in val_losses],
        lr=[float(v) for v in lrs],
        epoch_time_s=[],
        stopped_epoch=None if stopped_at < 0 else stopped_at,
        best_epoch=es_best_epoch if use_early and es_best_epoch >= 0 else None,
    )
    return params, opt_state, history


def fit_scan_stack(
    params_stack,
    loss_fn: LossFn,
    x_train,
    y_train,
    x_val,
    y_val,
    cfg: TrainConfig,
    *,
    seeds,
    opt_state_stack: Optional[AdamState] = None,
    stochastic: bool = False,
    pass_epoch: bool = False,
    n_train_real: Optional[int] = None,
    n_val_real: Optional[int] = None,
    mesh=None,
):
    """Train M member replicas (the deep-ensemble construction: same data
    and recipe, per-member seeds); returns ``(params_stack,
    opt_state_stack, [History per member])``.

    ``params_stack``: a params tree whose every leaf has a leading member
    axis of size ``len(seeds)``, trained in place; member ``i`` runs
    :func:`fit_scan` with ``seed=seeds[i]``, exactly as it would alone.
    The JAX package runs the members as one vmapped program; here they
    train one after another (a batched form is ROADMAP queue 1 item 2's
    work). ``opt_state_stack``: an :class:`AdamState` whose ``step`` is an
    (M,) array and whose moments carry the member axis.

    ``mesh`` shards the member axis: member ``i`` trains on mesh device
    ``i // (M / mesh.size)`` (contiguous blocks; ``M`` must divide over
    the mesh, as in JAX), on its own copy of the data there, so
    ``loss_fn`` must accept weights and rows on every mesh device. Each
    member's result is the one it reaches alone. Across processes each
    trains its own devices' members, and the stacks and histories meet by
    an all-reduce (other processes' members enter as zeros) and an
    ``all_gather_object``.
    """
    seeds = [int(s) for s in seeds]
    leaves = tree_leaves(params_stack)
    lead = {int(t.shape[0]) for t in leaves}
    if lead != {len(seeds)}:
        raise ValueError(f"params_stack leading axes {sorted(lead)} != len(seeds)={len(seeds)}")
    m = len(seeds)
    home = leaves[0].device
    placed = [(home, True)] * m
    if _as_mesh(mesh) is not None:
        if m % mesh.size != 0:
            raise ValueError(f"{m} members do not shard evenly over {mesh.size} devices")
        per = m // mesh.size
        placed = [(mesh.device_list[i // per], mesh.is_local(i // per)) for i in range(m)]
    data = {}
    states, histories = [None] * m, [None] * m
    for i, seed in enumerate(seeds):
        dev, local = placed[i]
        if not local:
            continue
        if dev not in data:
            data[dev] = [loop._as_rows(a, dev) for a in (x_train, y_train, x_val, y_val)]
        member = tree_map(lambda t: t[i].detach().clone().to(dev), params_stack)
        state = None
        if opt_state_stack is not None:
            state = AdamState(int(np.asarray(opt_state_stack.step)[i]),
                              [mu[i].clone().to(dev) for mu in opt_state_stack.mu],
                              [nu[i].clone().to(dev) for nu in opt_state_stack.nu])
        member, state, history = fit_scan(
            member, loss_fn, *data[dev],
            dataclasses.replace(cfg, seed=seed), opt_state=state, stochastic=stochastic,
            pass_epoch=pass_epoch, n_train_real=n_train_real, n_val_real=n_val_real,
        )
        with torch.no_grad():
            for dst, src in zip(leaves, tree_leaves(member)):
                dst[i].copy_(src)
        states[i] = AdamState(state.step, [t.to(home) for t in state.mu],
                              [t.to(home) for t in state.nu])
        histories[i] = history
    if mesh is not None and mesh.n_processes > 1:
        return _meet_members(params_stack, states, histories, placed)
    opt_state_stack = AdamState(
        np.asarray([s.step for s in states], np.int32),
        [torch.stack(ms) for ms in zip(*(s.mu for s in states))],
        [torch.stack(vs) for vs in zip(*(s.nu for s in states))],
    )
    return params_stack, opt_state_stack, histories


def _meet_members(params_stack, states, histories, placed):
    """Every process's trained members in every process: the stacks
    summed over processes with the members a process did not train as
    zeros (exact: x + 0 = x), the histories gathered as objects."""
    import torch.distributed as dist

    from tpu21cmvae_torch.parallel.mesh import all_reduce_sum

    local = [ok for _, ok in placed]
    mask = torch.as_tensor(local, device=tree_leaves(params_stack)[0].device)
    like = next(s for s in states if s is not None)

    def meet(stack):
        keep = mask.reshape(-1, *([1] * (stack.ndim - 1)))
        return all_reduce_sum(torch.where(keep, stack, torch.zeros_like(stack)))

    with torch.no_grad():
        for t in tree_leaves(params_stack):
            t.copy_(meet(t))
        mu = [meet(torch.stack([s.mu[k] if s is not None else torch.zeros_like(like.mu[k])
                                for s in states])) for k in range(len(like.mu))]
        nu = [meet(torch.stack([s.nu[k] if s is not None else torch.zeros_like(like.nu[k])
                                for s in states])) for k in range(len(like.nu))]
    steps = meet(torch.as_tensor([s.step if s is not None else 0 for s in states]))
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, {i: h for i, h in enumerate(histories) if h is not None})
    merged = {i: h for part in gathered for i, h in part.items()}
    return (params_stack,
            AdamState(steps.cpu().numpy().astype(np.int32), mu, nu),
            [merged[i] for i in range(len(states))])
