"""Time the int8 serving levers against bf16 on the card, per projection and end to end.

    python -m oron_tts_tpu_torch.cli.bench_quantized            # kernel tier
    python -m oron_tts_tpu_torch.cli.bench_quantized --e2e      # + end-to-end RTF
    python -m oron_tts_tpu_torch.cli.bench_quantized --smoke --e2e   # CPU, tiny shapes and model

Counterpart of the JAX package's ``scripts/bench_quantized.py``. Two tiers:

1. Kernel tier: the three quantized Base projections, (K, N) = (1,024,
   1,024), (1,024, 4,096) and (4,096, 1,024), at the serving row counts
   M = 512, 3,200 and 16,384 (2·B·T of a CFG solve: a short chunk, one
   17 s utterance, a group of eight). Weights N(0, 0.02²) and bf16 x from a
   seeded generator. Three variants: bf16 ``F.linear`` (the baseline, as
   the JAX script's ``lax.dot``); w8a16, ``ops.quantized_matmul`` (kernel 9,
   ``csrc/qmm.cu``, at the tile ``qmm_plan`` picks); w8a8, ``w8a8_matmul``
   (``quantize_activations`` and ``torch._int_mm``; the JAX package computes
   it outside any Pallas kernel too). On the card each variant is timed as a
   CUDA graph of 20 calls, replayed 5 times, the fastest replay over 20: the
   counterpart of the JAX script's in-jit scan, which keeps the host's
   per-call time out. The w8a16 output is held against its plain version
   (``quantized_matmul_plain`` in f32) at every shape, as ``chip_smoke.py``
   holds it: off by at most half a bf16 step beyond 1e-5 of the largest
   output (``w8a16_excess`` against ``w8a16_tol``).
2. ``--e2e``: ``F5TTS`` at the Base width with one seeded DiT tree loaded
   into a fresh model for each of bf16, ``int8`` and ``int8_dynamic``
   (``quantize_for_serving``), synthesizing the JAX script's sentence in 32
   steps, seed 0: one cold call, then the best of three, with wall, audio
   seconds and RTF; the waveform must be finite. The JAX tier decodes with
   random bf16 Vocos weights; the port uses the vocoder its facade loads by
   default (the bundled Vocos, f32 on the card), as the port's other benches
   do. The tier times; it does not judge the audio.
"""

from __future__ import annotations

import argparse
import sys
import time

DIM = 1024
LAYERS = (("to_qkv (1024->1024)", DIM, DIM), ("ff in_proj (1024->4096)", DIM, 4 * DIM),
          ("ff out_proj (4096->1024)", 4 * DIM, DIM))
ROWS = (512, 3200, 16384)
TEXT = "Сайн байна уу, энэ бол интонацийг шалгах урт өгүүлбэр юм."
MODES = (None, "int8", "int8_dynamic")
ITERS, REPS = 20, 5


def operands(m: int, k: int, n: int, device, generator):
    """bf16 x ``[m, k]`` and f32 weights N(0, 0.02²) ``[n, k]`` (``nn.Linear``'s layout)."""
    import torch

    w = torch.randn(n, k, generator=generator, device=device) * 0.02
    x = torch.randn(m, k, generator=generator, device=device).to(torch.bfloat16)
    return x, w


def variants(x, w) -> dict:
    """The three products of ``x`` with ``w``, each a call with no arguments."""
    import torch
    import torch.nn.functional as F

    from oron_tts_tpu_torch.ops.quantized_matmul import (
        quantize_weight,
        quantized_matmul,
        w8a8_matmul,
    )

    q, s = quantize_weight(w)
    wb = w.to(torch.bfloat16)
    return {"bf16": lambda: F.linear(x, wb), "w8a16": lambda: quantized_matmul(x, q, s),
            "w8a8": lambda: w8a8_matmul(x, q, s)}


def graph_seconds(fn, iters: int = ITERS, reps: int = REPS) -> float:
    """Seconds a call: ``iters`` calls captured in one CUDA graph, the fastest of ``reps`` replays.

    The wrappers' host-side checks run while the graph is captured, not in a replay.
    """
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up: builds and loads the kernel's library
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(stop) / 1e3)
    del graph
    return best / iters


def host_seconds(fn, iters: int, reps: int) -> float:
    """Seconds a call on the host clock, the fastest of ``reps`` runs of ``iters`` calls (CPU)."""
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, time.perf_counter() - t0)
    return best / iters


def kernel_tier(dev, smoke: bool) -> list[dict]:
    import torch

    from oron_tts_tpu_torch.ops.quantized_matmul import (
        qmm_plan,
        quantize_weight,
        quantized_matmul_plain,
    )

    layers, rows = LAYERS, ROWS
    timer = graph_seconds
    if smoke:
        layers = (("to_qkv (64->64)", 64, 64), ("ff in_proj (64->256)", 64, 256),
                  ("ff out_proj (256->64)", 256, 64))
        rows = (40, 96)

        def timer(fn):
            return host_seconds(fn, iters=2, reps=2)

    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    for m in rows:
        print(f"\n## M={m} rows", flush=True)
        for name, k, n in layers:
            x, w = operands(m, k, n, dev, gen)
            calls = variants(x, w)
            t = {v: timer(fn) for v, fn in calls.items()}
            flops = 2 * m * k * n
            # kernel 9 against its plain version (chip_smoke.py's check_qmm rule)
            q, s = quantize_weight(w)
            ref = quantized_matmul_plain(x.float(), q, s)
            diff = (calls["w8a16"]().float() - ref).abs()
            out.append({"m": m, "name": name, "k": k, "n": n, "w8a16_tile": qmm_plan(m, k, n).bm,
                        **{f"{v}_us": sec * 1e6 for v, sec in t.items()},
                        "bf16_tflops": flops / t["bf16"] / 1e12,
                        "w8a16_speedup": t["bf16"] / t["w8a16"],
                        "w8a8_speedup": t["bf16"] / t["w8a8"],
                        "w8a16_excess": float((diff - 2.0 ** -8 * ref.abs()).max()),
                        "w8a16_tol": 1e-5 * float(ref.abs().max())})
            print(f"{name:28s} bf16 {t['bf16'] * 1e6:8.1f} us"
                  f" ({flops / t['bf16'] / 1e12:5.1f} TF/s) |"
                  f" w8a16 {t['w8a16'] * 1e6:8.1f} us ({t['bf16'] / t['w8a16']:4.2f}x) |"
                  f" w8a8 {t['w8a8'] * 1e6:8.1f} us ({t['bf16'] / t['w8a8']:4.2f}x)", flush=True)
    return out


def e2e_tier(dev, smoke: bool) -> list[dict]:
    import numpy as np

    from oron_tts_tpu_torch.config import F5Config
    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from oron_tts_tpu_torch.utils.weights import seeded_dit_params

    model_cfg = {"p_dropout": 0.0}
    steps, reps = 32, 3
    if smoke:
        model_cfg.update(dim=64, depth=2, heads=2, text_dim=32, ff_mult=2, conv_layers=1)
        steps, reps = 2, 1
    cfg = F5Config.from_dict({"model": model_cfg})
    params = seeded_dit_params(cfg.model, seed=2)
    out = []
    for mode in MODES:
        model = F5TTS(cfg, device=dev)
        model.load_params(params)
        if mode:
            model.quantize_for_serving(mode)
        t0 = time.perf_counter()
        wav = model.synthesize(TEXT, n_steps=steps, seed=0)
        cold = time.perf_counter() - t0
        wall = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            wav = model.synthesize(TEXT, n_steps=steps, seed=0)  # a host array: synchronised
            wall = min(wall, time.perf_counter() - t0)
        audio_s = wav.size / model.sample_rate
        label = mode or "bf16"
        print(f"{label:14s} compile+first {cold:6.1f}s  wall {wall:.3f}s  "
              f"audio {audio_s:.2f}s  RTF {wall / audio_s:.4f}", flush=True)
        if not np.isfinite(wav).all():
            raise AssertionError(f"non-finite waveform in {label}")
        out.append({"mode": label, "steps": steps, "first_s": cold, "wall_s": wall,
                    "audio_s": audio_s, "rtf": wall / audio_s})
    return out


def main(argv: list[str] | None = None) -> dict:
    """Print the tiers' lines; return their rows (``kernel``, and ``e2e`` with ``--e2e``)."""
    ap = argparse.ArgumentParser(description="The int8 serving levers against bf16")
    ap.add_argument("--e2e", action="store_true", help="also the end-to-end synthesis tier")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true", help="CPU, tiny shapes and a tiny model")
    args = ap.parse_args(argv)

    from oron_tts_tpu_torch.utils.device import card_name, resolve_device

    dev = resolve_device("cpu" if args.smoke else args.device)  # the card, or raise
    card = card_name(dev)
    print(f"# device={card}", file=sys.stderr)
    result = {"device": card, "kernel": kernel_tier(dev, args.smoke)}
    if args.e2e:
        print("\n## end-to-end Base 32-step synthesis", flush=True)
        result["e2e"] = e2e_tier(dev, args.smoke)
    return result


if __name__ == "__main__":
    main()
