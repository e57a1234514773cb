"""Data layer (``DynamicBatchSampler``, ``TTSCollator``): padded frames over collated
frames (rows × frames of each batch) across the window's steps, in %."""

from __future__ import annotations


def read(trace: dict) -> float | None:
    padded = trace.get("padded_frames") or 0
    if not padded:
        return None
    return 100.0 * (padded - trace["kept_frames"]) / padded
