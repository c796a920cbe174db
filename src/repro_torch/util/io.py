"""Crash-safe file writes (port of ``repro/util/io.py``): the bytes go to a
temp file in the target's directory, are fsynced, and replace the target
with ``os.replace`` — a reader sees the old complete file or the new one,
never a prefix.  Plans (``PrunePlan.save``) and prune reports
(``PruneReport.save``) are written through these helpers."""
from __future__ import annotations

import json
import os
from typing import Any


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Atomically replace ``path`` with ``data`` (creating parent dirs)."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"     # per-writer temp, same filesystem
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):           # a failed replace leaves no litter
            try:
                os.unlink(tmp)
            except OSError:
                pass


def atomic_write_text(path: str, text: str) -> None:
    atomic_write_bytes(path, text.encode("utf-8"))


def atomic_write_json(path: str, obj: Any, *, indent: int | None = 1) -> None:
    atomic_write_text(path, json.dumps(obj, indent=indent) + "\n")
