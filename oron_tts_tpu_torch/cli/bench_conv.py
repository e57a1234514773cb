"""Time the grouped conv + Mish kernel at the shapes the DiT gives it, one line each.

The position-embedding conv (``ops/grouped_conv.py``, kernel 2) on bf16
``x [B, T, C]`` with 31 taps and 16 groups::

    python -m oron_tts_tpu_torch.cli.bench_conv [--shapes base,small,train] [--iters 20]
        [--device cpu]

Shapes: ``base`` (``[2, 832, 1024]``, group width 64: one request's two CFG
rows), ``small`` (``[2, 832, 512]``, width 32: ``configs/local.yaml``) and
``train`` (``[12, 2048, 1024]``: the single-chip training batch). Each line
holds the kernel's time launched one call at a time (``ms``) and from a
CUDA graph of ``iters`` calls (``graph_ms``, which leaves out the wrapper's
host time), ``F.conv1d`` with groups + Mish (``library_ms``), the least time
the card could take (``bound_ms``: the operations over the H100's bf16 peak,
or the bytes over its memory rate) and the card's name. CUDA events time
the card; ``--device cpu`` runs the plain version at one tenth of the frames
on the host clock, as a smoke test.

To time another checkout's kernel with this script, run it as a file with
that checkout's root on ``PYTHONPATH`` (its wrapper is the one imported).
"""

from __future__ import annotations

import argparse
import json
import math
import time

SHAPES = {"base": (2, 832, 1024), "small": (2, 832, 512), "train": (12, 2048, 1024)}
TAPS, GROUPS = 31, 16
H100_BF16_FLOPS, H100_BYTES = 989e12, 3.35e12


def main(argv: list[str] | None = None) -> list[dict]:
    """Print one JSON line per shape and return them."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default=",".join(SHAPES),
                    help="comma-separated, of " + ", ".join(SHAPES))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rows = bench(args.shapes.split(","), args.iters, args.device)
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows


def bench(shapes: list[str], iters: int = 20, device: str | None = None) -> list[dict]:
    """One row per shape of ``SHAPES``: the times and bound described above."""
    import torch
    import torch.nn.functional as F

    from oron_tts_tpu_torch.ops import grouped_conv as gc
    from oron_tts_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    gen = torch.Generator(device=dev).manual_seed(0)

    def timed(fn) -> float:
        """Milliseconds a call, ``iters`` calls one at a time after a warm-up."""
        fn()
        if dev.type == "cpu":
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return (time.perf_counter() - t0) * 1e3 / iters
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters

    def graphed(fn) -> float:
        """Milliseconds a call, ``iters`` calls captured in one CUDA graph and replayed."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters

    rows = []
    for name in shapes:
        B, T, C = SHAPES[name]
        if dev.type == "cpu":
            T //= 10
        width = C // GROUPS
        x = torch.randn(B, T, C, generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn(TAPS, width, C, generator=gen, device=dev)
             / math.sqrt(TAPS * width)).to(torch.bfloat16)
        bias = 0.1 * torch.randn(C, generator=gen, device=dev)
        xt, wt = x.transpose(1, 2).contiguous(), w.permute(2, 1, 0).contiguous()
        flops = 2.0 * B * T * C * width * TAPS
        nbytes = 2 * x.numel() * 2 + w.numel() * 2 + bias.numel() * 4
        row = {"shape": name, "x": [B, T, C], "group_width": width, "card": card,
               "ms": timed(lambda: gc.grouped_conv1d_mish(x, w, bias, GROUPS)),
               "library_ms": timed(lambda: gc.mish(F.conv1d(
                   xt, wt, bias.to(x.dtype), padding=TAPS // 2, groups=GROUPS))),
               "bound_ms": max(flops / H100_BF16_FLOPS, nbytes / H100_BYTES) * 1e3}
        if dev.type == "cuda":
            row["graph_ms"] = graphed(lambda: gc.grouped_conv1d_mish(x, w, bias, GROUPS))
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
