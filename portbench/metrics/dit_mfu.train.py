"""DiT step in training: model FLOPs of the window's steps (3 × the forward, products
only, at each row's kept frames, recomputation not counted; ``portbench/flops.py``) over
the window × the card's bf16 peak, in %."""

from __future__ import annotations

from portbench.flops import BF16_FLOPS


def read(trace: dict) -> float | None:
    if not trace.get("train_flops"):
        return None
    return 100.0 * trace["train_flops"] / (trace["seconds"] * BF16_FLOPS)
