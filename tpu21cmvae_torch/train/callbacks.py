"""Host-side training callbacks replicating Keras semantics exactly (the
port of ``tpu21cmvae/train/callbacks.py``).

The reference's training recipes hinge on the interaction of Keras
``EarlyStopping`` and ``ReduceLROnPlateau`` (``Training.ipynb`` cells 5,
11) — patience windows, min_delta sign conventions, and
restore-best-weights behavior determine whether retraining reaches the
published 0.34 % accuracy. These classes replicate TF-2.x behavior
bit-for-bit for the min-mode/val-loss configuration the reference uses:

* EarlyStopping: improvement iff ``current < best − min_delta``; on stop,
  optionally restore the weights from the best epoch.
* ReduceLROnPlateau: improvement iff ``current < best − min_delta``;
  after ``patience`` non-improving epochs (outside cooldown), multiply lr
  by ``factor`` clamped to ``min_lr`` and reset the wait counter.

They mutate only their own state. The port trains its tensors in place,
so "saving weights" is a detached clone of the best epoch's tensors on
their device (a reference would follow the live weights, and
``restore_best_weights`` would silently return the last ones).
"""

from __future__ import annotations

from typing import Any, Optional

from tpu21cmvae_torch.utils.tree import tree_map


class EarlyStopping:
    """min-mode Keras EarlyStopping on a scalar monitor (val_loss)."""

    def __init__(
        self,
        patience: int = 15,
        min_delta: float = 0.0,
        restore_best_weights: bool = True,
    ):
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.restore_best_weights = restore_best_weights
        self.best = float("inf")
        self.best_epoch = -1
        self.best_weights: Optional[Any] = None
        self.wait = 0
        self.stopped_epoch: Optional[int] = None

    def update(self, epoch: int, current: float, params) -> bool:
        """Record this epoch's monitor value. Returns True to stop."""
        if current < self.best - self.min_delta:
            self.best = current
            self.best_epoch = epoch
            self.wait = 0
            if self.restore_best_weights:
                self.best_weights = tree_map(lambda t: t.detach().clone(), params)
            return False
        self.wait += 1
        if self.wait >= self.patience:
            self.stopped_epoch = epoch
            return True
        return False

    def final_weights(self, params):
        """Weights to end training with. Keras restores the best weights
        only when stopping was triggered; otherwise the last weights
        stand (TF 2.7 behavior)."""
        if (
            self.restore_best_weights
            and self.stopped_epoch is not None
            and self.best_weights is not None
        ):
            return self.best_weights
        return params

    def state(self) -> dict:
        """JSON-serializable monitor state for checkpoint/resume
        (``best_weights`` holds tensors — checkpointed separately)."""
        return {
            "best": self.best,
            "best_epoch": self.best_epoch,
            "wait": self.wait,
            "stopped_epoch": self.stopped_epoch,
        }

    def restore(self, state: dict, best_weights=None) -> None:
        self.best = state["best"]
        self.best_epoch = state["best_epoch"]
        self.wait = state["wait"]
        self.stopped_epoch = state["stopped_epoch"]
        if best_weights is not None:
            self.best_weights = best_weights


class ReduceLROnPlateau:
    """min-mode Keras ReduceLROnPlateau on a scalar monitor (val_loss)."""

    def __init__(
        self,
        patience: int = 5,
        factor: float = 0.95,
        min_delta: float = 5e-9,
        min_lr: float = 1e-4,
        cooldown: int = 0,
    ):
        if factor >= 1.0:
            raise ValueError("ReduceLROnPlateau requires factor < 1.0")
        self.patience = patience
        self.factor = factor
        self.min_delta = abs(min_delta)
        self.min_lr = min_lr
        self.cooldown = cooldown
        self.cooldown_counter = 0
        self.best = float("inf")
        self.wait = 0

    def update(self, current: float, lr: float) -> float:
        """Record this epoch's monitor value; returns the (possibly
        reduced) learning rate."""
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        if current < self.best - self.min_delta:
            self.best = current
            self.wait = 0
        elif self.cooldown_counter <= 0:
            self.wait += 1
            # wait resets only when a reduction actually happens (TF 2.x
            # ReduceLROnPlateau.on_epoch_end).
            if self.wait >= self.patience and lr > self.min_lr:
                lr = max(lr * self.factor, self.min_lr)
                self.cooldown_counter = self.cooldown
                self.wait = 0
        return lr

    def state(self) -> dict:
        """JSON-serializable monitor state for checkpoint/resume."""
        return {
            "best": self.best,
            "wait": self.wait,
            "cooldown_counter": self.cooldown_counter,
        }

    def restore(self, state: dict) -> None:
        self.best = state["best"]
        self.wait = state["wait"]
        self.cooldown_counter = state["cooldown_counter"]
