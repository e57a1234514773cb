"""Kernel row 5 (``csrc/flash_lanes_bwd.cu``) in the MMDiT's step, over the joint
``[text; audio]`` sequence of 2T tokens, keys ``T + len``: the bound time of the traced
``flash_lanes_bwd`` calls (shapes from a wrapper, ``portbench/flops.py``) over the device
time of the attention-backward kernels the trace shows, in %."""

from __future__ import annotations

from portbench.record import kernel_s


def read(trace: dict) -> float | None:
    t = kernel_s(trace, "bwd_dq") + kernel_s(trace, "bwd_dkdv") + kernel_s(trace, "attn_delta")
    if not t or not trace.get("attn_bwd_bound_s"):
        return None
    return 100.0 * trace["attn_bwd_bound_s"] / t
