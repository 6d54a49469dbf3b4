"""Structured training metrics: JSONL / CSV writers and live logging (a
copy of ``tpu21cmvae/utils/logging.py``).

The reference's only observability is the Keras ``History`` dict returned
from ``train`` and a tqdm bar (reference ``emulator.py:366-381``;
SURVEY.md §5). Here per-epoch metrics stream to disk as they happen —
append-only JSONL (crash-safe, resumable) or CSV — via an
``epoch_callback`` that plugs into the training loop
(:func:`tpu21cmvae_torch.train.loop.fit`), and a completed ``History`` can be
exported after the fact.
"""

from __future__ import annotations

import csv
import json
import os
from typing import IO, Optional


class MetricsLogger:
    """Append-only JSONL metrics writer.

    One JSON object per line: ``{"epoch": 3, "loss": ..., "val_loss": ...,
    "lr": ..., "epoch_time_s": ...}`` plus anything passed to
    :meth:`log`. Each line is flushed immediately so a preempted
    job keeps every finished epoch on disk.

    Use :meth:`epoch_callback` to attach to ``fit(...,
    epoch_callback=...)``.
    """

    def __init__(self, path: str, mode: str = "a"):
        self.path = path
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._fh: Optional[IO] = open(path, mode)

    def log(self, **metrics) -> None:
        if self._fh is None:
            raise ValueError(f"MetricsLogger({self.path!r}) is closed")
        self._fh.write(json.dumps(metrics) + "\n")
        self._fh.flush()

    def epoch_callback(self, epoch, params, opt_state, history) -> None:
        """Signature matches ``fit``'s ``epoch_callback`` hook; writes the
        just-finished epoch's row."""
        self.log(
            epoch=epoch,
            loss=history.loss[-1],
            val_loss=history.val_loss[-1],
            lr=history.lr[-1],
            epoch_time_s=history.epoch_time_s[-1],
        )

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_jsonl(path: str) -> list:
    """Read a JSONL metrics file back into a list of dicts."""
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def history_to_jsonl(history, path: str) -> str:
    """Export a completed :class:`~tpu21cmvae_torch.train.loop.History` to
    JSONL (one row per epoch)."""
    # truncate: an export is a snapshot of THIS history, not an append
    with MetricsLogger(path, mode="w") as logger:
        for i in range(len(history.loss)):
            logger.log(
                epoch=i,
                loss=history.loss[i],
                val_loss=history.val_loss[i],
                lr=history.lr[i],
                epoch_time_s=history.epoch_time_s[i],
            )
    return path


def history_to_csv(history, path: str) -> str:
    """Export a completed ``History`` to CSV (header + one row per
    epoch) — the format notebook/matplotlib workflows expect."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow(["epoch", "loss", "val_loss", "lr", "epoch_time_s"])
        for i in range(len(history.loss)):
            writer.writerow(
                [
                    i,
                    history.loss[i],
                    history.val_loss[i],
                    history.lr[i],
                    history.epoch_time_s[i],
                ]
            )
    return path
