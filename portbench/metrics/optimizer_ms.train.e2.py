"""Trainer layer in E2's step (``train/trainer.py`` ``F5Trainer._apply``: the gradient
norm, clipping, and kernel 13's AdamW + EMA over E2's leaves, the RMSNorm weights and
``skip_proj`` among them): device time of the kernels between the opening and the closing
marker the benchmark launches in stream order around ``_apply``, per update, in ms."""

from __future__ import annotations


def read(trace: dict) -> float | None:
    n = trace.get("updates_traced") or 0
    if not n or not trace.get("update_device_s"):
        return None
    return 1e3 * trace["update_device_s"] / n
