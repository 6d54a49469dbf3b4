"""The training loop: one host-driven epoch at a time over data held on
the device (the port of ``tpu21cmvae/train/loop.py``; it replaces the
reference's Keras ``Model.fit``, reference ``emulator.py:369-378``).

* An epoch gathers the shuffled training rows once, then runs one
  autograd step and one Keras-Adam update (:mod:`.adam`) per batch of
  256 (reference ``emulator.py:372``). The batch loss is the mean of its
  per-sample losses; the epoch loss is the float32 sum of batch loss ×
  batch rows over the rows, the sample-weighted mean Keras reports. A
  ragged last batch is shorter; pad rows (``n_train_real`` < rows) are
  never drawn, so the JAX package's all-padding batches, no-ops there,
  do not exist here.
* The host reads the device once per epoch (train and validation loss
  together) and runs EarlyStopping and ReduceLROnPlateau on those values
  with Keras-exact semantics (:mod:`.callbacks`).
* The shuffle comes from one seam, :func:`_permutation`, a function of
  ``(seed, epoch)``, and a stochastic loss's normals from another,
  :func:`_normal`, a function of ``(seed, epoch, step)``: the same draws
  on every device, and a resumed run re-derives them without replaying
  a key schedule.
* With ``checkpoint_dir`` the loop saves the whole training state
  atomically every N epochs, in the JAX package's ``ckpt_NNNNNN.npz``
  layout (the same leaves, structure string and metadata), so either
  package resumes the other's run.

The JAX module's program-factory cache (``_WeakFnCache``) is not ported:
it exists to avoid retracing jitted programs, and eager PyTorch traces
nothing.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from tpu21cmvae_torch.models.checkpoint import load_checkpoint, save_checkpoint
from tpu21cmvae_torch.train.adam import AdamState, adam_init, adam_update
from tpu21cmvae_torch.train.callbacks import EarlyStopping, ReduceLROnPlateau
from tpu21cmvae_torch.utils.config import TrainConfig
from tpu21cmvae_torch.utils.tree import tree_leaves, tree_map, tree_unflatten, treedef

LossFn = Callable[..., torch.Tensor]  # (params, x, y) -> per-sample losses


@dataclasses.dataclass
class History:
    """Per-epoch training record (superset of the Keras ``History`` dict
    the reference returns, ``emulator.py:379-381``)."""

    loss: List[float] = dataclasses.field(default_factory=list)
    val_loss: List[float] = dataclasses.field(default_factory=list)
    lr: List[float] = dataclasses.field(default_factory=list)
    epoch_time_s: List[float] = dataclasses.field(default_factory=list)
    stopped_epoch: Optional[int] = None
    best_epoch: Optional[int] = None

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _permutation(seed: int, epoch: int, n: int, device) -> torch.Tensor:
    """Epoch ``epoch``'s shuffle of ``range(n)``: ``torch.randperm`` on a
    CPU generator seeded from ``(seed, epoch)``, moved to ``device`` (the
    same rows on every device). Training's one draw seam."""
    g = torch.Generator().manual_seed(((seed & 0xFFFFFFFF) << 32) | (epoch & 0xFFFFFFFF))
    return torch.randperm(n, generator=g).to(device)


EVAL_EPOCH = -1
"""The ``epoch`` under which :func:`_normal` gives a run's validation
draw (one per run, as the JAX package's ``eval_key``)."""


def _normal(seed: int, epoch: int, step: int, shape, device) -> torch.Tensor:
    """Standard normals of ``shape`` for batch ``step`` of epoch ``epoch``
    (``epoch=EVAL_EPOCH``: the validation draw): ``torch.randn`` on a CPU
    generator seeded from ``(seed, epoch, step)``, moved to ``device``.
    Training's second draw seam, the port's counterpart of the JAX
    package's ``normal(fold_in(loss_key, step), shape)``."""
    words = np.random.SeedSequence([seed & 0xFFFFFFFF, epoch + 1, step]).generate_state(2)
    g = torch.Generator().manual_seed((int(words[0]) << 32) | int(words[1]))
    return torch.randn(tuple(shape), generator=g).to(device)


def _noise(seed: int, epoch: int, step: int, device):
    """A stochastic loss's source of normals for one batch: ``shape →
    (shape) normals`` through :func:`_normal` (looked up at call time, so
    the seam can be replaced)."""
    return lambda shape: _normal(seed, epoch, step, shape, device)


def _trainable(params) -> list:
    """The leaves of ``params``, float32 leaf tensors on one device, each
    made to require grad (they are trained in place)."""
    leaves = tree_leaves(params)
    for t in leaves:
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 or not t.is_leaf:
            raise TypeError("params must hold float32 leaf tensors (they are trained in place)")
        if t.device != leaves[0].device:
            raise ValueError(f"params span {t.device} and {leaves[0].device}")
        t.requires_grad_(True)
    return leaves


def _as_rows(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(a, np.float32), device=device)


def _n_real(n_real: Optional[int], n: int, name: str) -> int:
    n_real = n if n_real is None else int(n_real)
    if not 0 < n_real <= n:
        raise ValueError(f"{name}={n_real} must be in (0, {n}]")
    return n_real


@torch.no_grad()
def _assign(params, values) -> None:
    """Copy ``values`` (a tree like ``params``) into the tensors of
    ``params``, in place."""
    if values is params:
        return
    for dst, src in zip(tree_leaves(params), tree_leaves(values)):
        dst.copy_(torch.as_tensor(src))


def _train_step(params, leaves, loss_fn: LossFn, bx, by, state: AdamState, lr,
                cfg: TrainConfig, extra=()):
    """One batch: mean per-sample loss, its gradient, one Adam update of
    ``leaves`` in place. Returns ``(loss, state)``, the loss on the
    device."""
    loss = loss_fn(params, bx, by, *extra).sum() / bx.shape[0]
    grads = torch.autograd.grad(loss, leaves)
    state = adam_update(grads, leaves, state, lr, beta_1=cfg.beta_1,
                        beta_2=cfg.beta_2, epsilon=cfg.epsilon)
    return loss.detach(), state


def _run_epoch(params, loss_fn: LossFn, x, y, state: AdamState, lr, cfg: TrainConfig,
               perm: torch.Tensor, extra=(), noise=None, dp=None):
    """One epoch over the rows ``perm`` in batches of ``cfg.batch_size``.
    ``noise``: None, or ``step → source of normals`` for a stochastic
    loss, passed before ``extra``. ``dp``: None, or the data-parallel
    step of :mod:`tpu21cmvae_torch.parallel.train_dp` that takes each
    batch's place. Returns ``(state, mean loss)``, the loss on the
    device."""
    leaves = tree_leaves(params)
    xs, ys = x[perm], y[perm]
    total = x.new_zeros(())
    train_step = _train_step if dp is None else dp.train_step
    for step, start in enumerate(range(0, perm.shape[0], cfg.batch_size)):
        bx, by = xs[start: start + cfg.batch_size], ys[start: start + cfg.batch_size]
        args = extra if noise is None else (noise(step), *extra)
        loss, state = train_step(params, leaves, loss_fn, bx, by, state, lr, cfg, args)
        total = total + loss * bx.shape[0]
    return state, total / perm.shape[0]


@torch.no_grad()
def _evaluate(params, loss_fn: LossFn, x, y, n_real: int, extra=(), dp=None) -> torch.Tensor:
    """Mean per-sample loss over the first ``n_real`` rows, on the device
    (``dp``: split over a mesh as :func:`_run_epoch`'s batches)."""
    if dp is not None:
        return dp.evaluate(params, loss_fn, x, y, n_real, extra)
    per_sample = loss_fn(params, x, y, *extra)
    if n_real == x.shape[0]:
        return per_sample.mean()
    return per_sample[:n_real].sum() / n_real


def _epoch_args(cfg: TrainConfig, stochastic: bool, pass_epoch: bool, device):
    """``(epoch → (extra, noise))`` for :func:`_run_epoch` and the
    validation pass's arguments after ``(params, x, y)``: the epoch index
    with ``pass_epoch`` (validation gets the last epoch's), and with
    ``stochastic`` each batch's normals and the run's one validation
    draw."""
    val = (cfg.epochs - 1,) if pass_epoch else ()
    if stochastic:
        val = (_noise(cfg.seed ^ 0x5EED, EVAL_EPOCH, 0, device), *val)

    def for_epoch(epoch):
        noise = (lambda step: _noise(cfg.seed, epoch, step, device)) if stochastic else None
        return ((epoch,) if pass_epoch else ()), noise

    return for_epoch, val


def _prepare(params, x_train, y_train, x_val, y_val, n_train_real, n_val_real):
    """The leaves' device, the four splits on it, and the real row counts."""
    device = _trainable(params)[0].device
    x_train, y_train, x_val, y_val = (_as_rows(a, device)
                                      for a in (x_train, y_train, x_val, y_val))
    return (device, x_train, y_train, x_val, y_val,
            _n_real(n_train_real, x_train.shape[0], "n_train_real"),
            _n_real(n_val_real, x_val.shape[0], "n_val_real"))


def fit(
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
    verbose: bool = False,
    epoch_callback: Optional[Callable] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 10,
    checkpoint_keep: Optional[int] = 3,
    resume: bool = False,
    n_train_real: Optional[int] = None,
    n_val_real: Optional[int] = None,
    _dp=None,
):
    """Train ``params`` in place to minimize the mean of ``loss_fn``'s
    per-sample losses; returns ``(params, opt_state, History)``.

    ``params``: a tree (layer dicts) of float32 leaf tensors, all on the
    device training runs on; the data move there. ``loss_fn(params, x,
    y) -> (batch,)``; with ``pass_epoch=True`` the epoch index is
    appended as a last argument (the validation monitor gets the final
    epoch's, so schedule-dependent losses keep a stationary monitor).
    With ``stochastic=True`` the signature is ``loss_fn(params, x, y,
    noise[, epoch])``: ``noise(shape)`` gives standard normals, fresh for
    every batch (:func:`_normal` at ``(cfg.seed, epoch, batch)``) and one
    fixed draw per run for the validation pass (at ``(cfg.seed ^ 0x5EED,
    EVAL_EPOCH, 0)``, as the JAX package's ``eval_key``), so the monitor
    the callbacks watch stays deterministic.

    With ``checkpoint_dir`` the full training state is saved atomically
    every ``checkpoint_every`` epochs (and at the end or on an early
    stop); ``resume=True`` restores the latest checkpoint there, the JAX
    package's or this one's, and continues. Only the newest
    ``checkpoint_keep`` files are kept (None keeps all).

    ``n_train_real``/``n_val_real``: true sample counts when the arrays
    carry trailing pad rows; pad rows never enter a loss or a gradient.
    ``_dp`` is :func:`~tpu21cmvae_torch.parallel.train_dp.dp_fit`'s: every
    batch and the validation pass split over its mesh.
    """
    device, x_train, y_train, x_val, y_val, n_real, nv_real = _prepare(
        params, x_train, y_train, x_val, y_val, n_train_real, n_val_real)
    if opt_state is None:
        opt_state = adam_init(params)
    early: Optional[EarlyStopping] = None
    if cfg.early_stop_patience is not None:
        early = EarlyStopping(
            patience=cfg.early_stop_patience,
            min_delta=cfg.early_stop_min_delta,
            restore_best_weights=cfg.restore_best_weights,
        )
    plateau: Optional[ReduceLROnPlateau] = None
    if cfg.plateau_patience is not None:
        plateau = ReduceLROnPlateau(
            patience=cfg.plateau_patience,
            factor=cfg.plateau_factor,
            min_delta=cfg.plateau_min_delta,
            min_lr=cfg.plateau_min_lr,
        )

    history = History()
    lr = float(cfg.learning_rate)
    start_epoch = 0

    if resume and checkpoint_dir is not None:
        path = latest_checkpoint(checkpoint_dir)
        if path is not None:
            new_params, opt_state, best, meta = load_train_checkpoint(path, params,
                                                                      device=device)
            _assign(params, new_params)
            start_epoch = meta["epoch"] + 1
            lr = meta["lr"]
            h = meta["history"]
            for k in ("loss", "val_loss", "lr", "epoch_time_s"):
                setattr(history, k, list(h[k]))
            history.stopped_epoch = h.get("stopped_epoch")
            history.best_epoch = h.get("best_epoch")
            if early is not None and meta.get("early") is not None:
                early.restore(meta["early"], best)
            if plateau is not None and meta.get("plateau") is not None:
                plateau.restore(meta["plateau"])
            if history.stopped_epoch is not None:
                # the run had already stopped early: the checkpoint was
                # written before best_epoch was set, so take it from the
                # restored monitor, as an uninterrupted run would
                if early is not None:
                    _assign(params, early.final_weights(params))
                    history.best_epoch = early.best_epoch if early.best_epoch >= 0 else None
                return params, opt_state, history

    progress = _progress_bar(cfg.epochs) if verbose else None
    for_epoch, extra_val = _epoch_args(cfg, stochastic, pass_epoch, device)

    for epoch in range(start_epoch, cfg.epochs):
        t0 = time.perf_counter()
        perm = _permutation(cfg.seed, epoch, n_real, device)
        opt_state, train_loss = _run_epoch(params, loss_fn, x_train, y_train, opt_state,
                                           lr, cfg, perm, *for_epoch(epoch), dp=_dp)
        val_loss = _evaluate(params, loss_fn, x_val, y_val, nv_real, extra_val, dp=_dp)
        # the epoch's one read from the device
        train_loss, val_loss = torch.stack([train_loss, val_loss]).tolist()
        history.loss.append(train_loss)
        history.val_loss.append(val_loss)
        history.lr.append(lr)
        history.epoch_time_s.append(time.perf_counter() - t0)

        if progress is not None:
            progress.set_postfix(loss=train_loss, val_loss=val_loss, lr=lr)
            progress.update(1)
        if epoch_callback is not None:
            epoch_callback(epoch, params, opt_state, history)

        stop = False
        if early is not None:
            stop = early.update(epoch, val_loss, params)
        if plateau is not None:
            lr = plateau.update(val_loss, lr)
        if stop:
            history.stopped_epoch = epoch
        if checkpoint_dir is not None and (
            stop or epoch == cfg.epochs - 1 or (epoch + 1) % checkpoint_every == 0
        ):
            _save_train_checkpoint(
                checkpoint_dir, epoch, params, opt_state,
                early.best_weights if early is not None else None,
                lr, history, early, plateau, keep=checkpoint_keep,
            )
        if stop:
            break

    if early is not None:
        _assign(params, early.final_weights(params))
        # None (not -1) when no epoch ever improved, matching fit_scan
        history.best_epoch = early.best_epoch if early.best_epoch >= 0 else None
    if progress is not None:
        progress.close()
    return params, opt_state, history


# -- checkpoint/resume -------------------------------------------------------


def _train_tree(params, opt_state: AdamState, best_weights):
    """The JAX package's training-checkpoint tree: ``best_weights`` (the
    params stand in when there are none), ``opt_state`` as ``AdamState(step,
    mu, nu)`` with the moments shaped like ``params``, and ``params``."""
    return {
        "params": params,
        "opt_state": AdamState(
            np.asarray(opt_state.step, np.int32),
            tree_unflatten(params, opt_state.mu),
            tree_unflatten(params, opt_state.nu),
        ),
        "best_weights": best_weights if best_weights is not None else params,
    }


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _save_train_checkpoint(
    ckpt_dir, epoch, params, opt_state, best_weights, lr, history, early,
    plateau, keep=None,
):
    """Atomic full-training-state checkpoint ``ckpt_dir/ckpt_NNNNNN.npz``
    in the JAX package's layout; prunes all but the newest ``keep``
    files afterwards."""
    tree = _train_tree(params, opt_state, best_weights)
    meta = {
        "epoch": epoch,
        "lr": lr,
        "history": {
            "loss": history.loss,
            "val_loss": history.val_loss,
            "lr": history.lr,
            "epoch_time_s": history.epoch_time_s,
            "stopped_epoch": history.stopped_epoch,
            "best_epoch": history.best_epoch,
        },
        "early": early.state() if early is not None else None,
        "has_best": best_weights is not None,
        "plateau": plateau.state() if plateau is not None else None,
    }
    save_checkpoint(os.path.join(ckpt_dir, f"ckpt_{epoch:06d}.npz"),
                    [_host(a) for a in tree_leaves(tree)], treedef(tree), meta)
    if keep is not None:
        for stale in _checkpoint_names(ckpt_dir)[:-keep]:
            os.unlink(os.path.join(ckpt_dir, stale))


def _checkpoint_names(ckpt_dir) -> List[str]:
    return sorted(n for n in os.listdir(ckpt_dir)
                  if n.startswith("ckpt_") and n.endswith(".npz"))


def latest_checkpoint(ckpt_dir) -> Optional[str]:
    """Path of the newest ``ckpt_NNNNNN.npz`` in a directory, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    names = _checkpoint_names(ckpt_dir)
    return os.path.join(ckpt_dir, names[-1]) if names else None


def load_train_checkpoint(path: str, like, *, device):
    """A training checkpoint of either package →
    ``(params, opt_state, best_weights, meta)`` on ``device``.

    ``like``: a params tree with the checkpoint's structure (its values
    are not read). ``params`` and ``best_weights`` come back as trees
    like it of new tensors (``best_weights`` None when the file holds
    none), ``opt_state`` as the port's :class:`AdamState`.
    """
    template = _train_tree(like, AdamState(0, tree_leaves(like), tree_leaves(like)), None)
    leaves, meta = load_checkpoint(path, treedef=treedef(template))
    if len(leaves) != len(tree_leaves(template)):
        raise ValueError(f"{path} has {len(leaves)} leaves; the template has "
                         f"{len(tree_leaves(template))}")
    tree = tree_unflatten(template, leaves)

    def load(t):
        return torch.tensor(np.asarray(t), dtype=torch.float32, device=device)

    state = tree["opt_state"]
    opt_state = AdamState(int(state.step), [load(a) for a in tree_leaves(state.mu)],
                          [load(a) for a in tree_leaves(state.nu)])
    best = tree_map(load, tree["best_weights"]) if meta.get("has_best") else None
    return tree_map(load, tree["params"]), opt_state, best, meta


def _progress_bar(total):
    try:
        from tqdm import tqdm
    except ImportError:
        return None
    return tqdm(total=total, desc="train", leave=False)


def make_mlp_loss(apply_fn: Callable, per_sample_loss: Callable) -> LossFn:
    """Compose a forward function and a per-sample loss into the
    ``loss_fn`` signature :func:`fit` expects."""

    def loss_fn(params, x, y):
        return per_sample_loss(y, apply_fn(params, x))

    return loss_fn
