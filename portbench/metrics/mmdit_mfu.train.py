"""MMDiT step in training: model FLOPs of the window's steps (3 × the forward, products
only, both streams at each row's kept frames, the joint attention over 2n keys,
recomputation not counted; ``portbench/reference/mmdit.py``) over the window × the
card's bf16 peak, in %: the whole step's share of peak."""

from __future__ import annotations

from portbench.flops import BF16_FLOPS


def read(trace: dict) -> float | None:
    if not trace.get("train_flops"):
        return None
    return 100.0 * trace["train_flops"] / (trace["seconds"] * BF16_FLOPS)
