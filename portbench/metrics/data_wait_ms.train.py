"""Data layer (``data/loader.py`` ``DataLoader`` over ``data/dataset.py``): the mean time a
step waited for its next batch from the loader, over the window's steps, in ms."""

from __future__ import annotations


def read(trace: dict) -> float | None:
    waits = trace.get("data_wait_s") or []
    return 1e3 * sum(waits) / len(waits) if waits else None
