"""Device in the MMDiT's training step: the share of the traced stretch in which nothing
ran, in %."""

from __future__ import annotations


def read(trace: dict) -> float | None:
    if not trace.get("window_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
