"""Shared filesystem helpers."""

from __future__ import annotations

import contextlib
import os
import tempfile


@contextlib.contextmanager
def atomic_write(path: str, suffix: str = ".part"):
    """Write-then-rename: yields an open binary file object whose contents
    land at ``path`` only if the block completes; on any failure the temp
    file is removed and ``path`` is untouched. A preempted or crashed
    writer never leaves a torn file (the property the checkpoint/resume
    story depends on)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=suffix)
    try:
        with os.fdopen(fd, "wb") as fh:
            yield fh
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
