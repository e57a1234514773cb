"""Trainer layer (``train/trainer.py`` ``F5Trainer._apply``: the gradient norm, clipping,
AdamW and the EMA): device time of the kernels that ran between the opening and the
closing marker the benchmark launches in stream order around ``_apply``, per update,
over the traced stretch, in ms."""

from __future__ import annotations


def read(trace: dict) -> float | None:
    n = trace.get("updates_traced") or 0
    if not n or not trace.get("update_device_s"):
        return None
    return 1e3 * trace["update_device_s"] / n
