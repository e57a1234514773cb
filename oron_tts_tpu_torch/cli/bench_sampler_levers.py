"""Time the sampler's levers side by side at the Base width on the card.

    python -m oron_tts_tpu_torch.cli.bench_sampler_levers            # the card, Base bf16
    python -m oron_tts_tpu_torch.cli.bench_sampler_levers --smoke    # CPU, a tiny model

Counterpart of the JAX package's ``scripts/bench_sampler_levers.py``. The
Base DiT (dim 1,024, depth 22, 16 heads of 64, dropout 0) in bf16 with the
port's default attention (the lanes kernel) and the grouped conv kernel,
seeded weights (``utils.weights.seeded_dit_params``), 120 letters: 1,560
frames in a bucket of 1,600, computed as the JAX code computes it (its
docstring says 1,664). Text ids and the initial noise come from a seed;
``cond`` is zero and ``lens`` 0; CFG 2.0, sway −1. The cases, with the JAX
labels:

  baseline          32-step Euler, CFG every step, AdaLN tables hoisted
  no-hoist          the same with ``hoist_t_mods=False``: the timestep MLP and
                    every AdaLN projection run inside each forward
  cfg-interval      32-step Euler, CFG only for t in [0.10, 0.70]
  midpoint-16       16 midpoint steps = 32 velocity evaluations
  midpoint+interval both
  int8 w8a16        the six projections a block in int8 through kernel 9
  int8_dynamic w8a8 per-token int8 activations, ``torch._int_mm``
  int8_dyn+interval the w8a8 model with the CFG interval

The int8 models are built from the same bf16 model by
``quantize_dit_params``. Each case is timed as one cold call and the best of
three, on the host clock around a solve that ends in a synchronise (the
host reads the mel's mean, which must be finite); RTF(solve) is the best over
the 16.64 s of audio the 1,560 frames hold. Each case's mel (the generated
frames) is also held against a reference case by relative L2: the bf16 cases
against the baseline, the int8 cases against the bf16 case with the same
interval setting. An eager solve is host-bound, so on the card one more
solve of each case runs under ``torch.profiler``: its device-busy seconds,
the kernels it launched and the launches of kernels 1, 2 and 9 (the lanes
attention forward, the grouped conv, the w8a16 product) tell a lever that
cuts device work from one that cuts nothing.
"""

from __future__ import annotations

import argparse
import copy
import math
import sys
import time

LETTERS, CFG, SWAY, SEED = 120, 2.0, -1.0, 0
INTERVAL = (0.10, 0.70)
BASE, INTERVAL_CASE = "baseline (euler32, hoist, full CFG)", "cfg-interval [0.10,0.70]"
# (label, weights, sampler keywords, the case its mel is held against); midpoint
# takes half the steps, so every case makes the same number of velocity evaluations
CASES = (
    (BASE, "bf16", {}, None),
    ("no-hoist", "bf16", dict(hoist_t_mods=False), BASE),
    (INTERVAL_CASE, "bf16", dict(cfg_interval=INTERVAL), BASE),
    ("midpoint-16 (32 NFE)", "bf16", dict(method="midpoint"), BASE),
    ("midpoint-16 + interval", "bf16", dict(method="midpoint", cfg_interval=INTERVAL), BASE),
    ("int8 w8a16", "int8", {}, BASE),
    ("int8_dynamic w8a8", "int8_dynamic", {}, BASE),
    ("int8_dynamic + interval", "int8_dynamic", dict(cfg_interval=INTERVAL), INTERVAL_CASE),
)


def rel_l2(a, b) -> float:
    """``|a - b| / |b|`` in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def main(argv: list[str] | None = None) -> dict:
    """Print one line per case; return the cases' numbers by label."""
    ap = argparse.ArgumentParser(description="The sampler's levers side by side")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="CPU, dim 64, depth 2, 8 letters, 4 steps")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from oron_tts_tpu_torch.config import ModelConfig
    from oron_tts_tpu_torch.models.cfm import CFM
    from oron_tts_tpu_torch.models.dit import DiT, quantize_dit_params
    from oron_tts_tpu_torch.ops.flash_attention import flash_lanes_fwd
    from oron_tts_tpu_torch.ops.grouped_conv import grouped_conv1d_mish
    from oron_tts_tpu_torch.ops.quantized_matmul import quantized_matmul
    from oron_tts_tpu_torch.utils.device import card_name, default_dtype, resolve_device
    from oron_tts_tpu_torch.utils.weights import from_flax_params, seeded_dit_params

    mcfg, letters, steps = ModelConfig(), LETTERS, 32
    if args.smoke:
        mcfg = ModelConfig(dim=64, depth=2, heads=2, text_dim=32, ff_mult=2, conv_layers=1)
        letters, steps = 8, 4
    dev = resolve_device("cpu" if args.smoke else args.device)  # the card, or raise
    cuda = dev.type == "cuda"
    dtype = default_dtype(dev)
    card = card_name(dev)
    print(f"# device={card}", file=sys.stderr)
    t_total = letters * 13
    T = -(-t_total // 64) * 64
    audio_s = t_total * 256 / 24000

    t0 = time.perf_counter()
    with torch.device(dev):
        dit = DiT(dim=mcfg.dim, depth=mcfg.depth, heads=mcfg.heads, dim_head=mcfg.dim_head,
                  ff_mult=mcfg.ff_mult, mel_dim=100, vocab_size=mcfg.vocab_size,
                  text_dim=mcfg.text_dim, conv_layers=mcfg.conv_layers, dropout=0.0)
    dit = dit.to(dtype).eval()
    dit.load_state_dict(from_flax_params(seeded_dit_params(mcfg, seed=SEED)), strict=True)
    w8a16 = quantize_dit_params(copy.deepcopy(dit), "int8")
    models = {"bf16": CFM(dit), "int8": CFM(w8a16),
              "int8_dynamic": CFM(quantize_dit_params(copy.deepcopy(w8a16), "int8_dynamic"))}

    rng = np.random.default_rng(SEED)
    text = torch.from_numpy(rng.integers(0, mcfg.vocab_size, (1, T))).to(dev)
    noise = torch.from_numpy(rng.standard_normal((1, T, 100), dtype=np.float32)).to(dev)
    cond = torch.zeros(1, T, 100, device=dev)
    duration, lens = torch.tensor([t_total]), torch.tensor([0])
    counters = {f.__name__: f for f in (flash_lanes_fwd, grouped_conv1d_mish, quantized_matmul)}
    setup = time.perf_counter() - t0
    results: dict[str, dict] = {}
    mels: dict[str, torch.Tensor] = {}
    for label, weights, kw, ref in CASES:
        kw = dict(kw, steps=steps // 2 if kw.get("method") == "midpoint" else steps)
        cfm = models[weights]

        def solve():
            mel, _ = cfm.sample(cond, text, duration, lens, cfg_strength=CFG,
                                sway_sampling_coef=SWAY, noise=noise, **kw)
            return mel, float(mel.abs().mean())  # the host waits for the device here

        t0 = time.perf_counter()
        mel, mean = solve()
        first = time.perf_counter() - t0
        if not math.isfinite(mean):
            raise AssertionError(f"non-finite mel mean in {label}")
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            solve()
            best = min(best, time.perf_counter() - t0)
        mels[label] = mel[0, :t_total].float().cpu()
        row = {"weights": weights, "steps": kw["steps"], "first_s": first, "solve_s": best,
               "rtf": best / audio_s, "mel_abs_mean": mean, "vs": ref,
               "rel_l2": None if ref is None else rel_l2(mels[label], mels[ref])}
        line = (f"{label:38s} compile/first {first:6.1f}s  solve {best:.3f}s  "
                f"RTF(solve) {best / audio_s:.4f}")
        if cuda:
            row.update(profiled(torch, solve, counters))
            line += (f"  device {row['device_busy_s']:.3f}s  kernels {row['device_kernels']}  "
                     f"launches {row['launches']}")
        print(line, flush=True)
        results[label] = row
    return {"device": card, "model": {"dim": mcfg.dim, "depth": mcfg.depth, "heads": mcfg.heads,
                                      "dtype": str(dtype)},
            "frames": t_total, "bucket": T, "audio_s": audio_s, "setup_s": setup, "cases": results}


def profiled(torch, solve, counters: dict) -> dict:
    """One more solve under ``torch.profiler``: device time, kernels, and the wrappers' launches.

    Only the device's activity is traced, and its raw events are summed: a solve
    launches 25,000-84,000 kernels, and building the profiler's Python event
    objects for them took 5-18 s a solve on the H100's host.
    """
    from torch.profiler import ProfilerActivity, profile

    before = {n: f.launches for n, f in counters.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve()
        wall = time.perf_counter() - t0
    kernels = [ev.duration_ns() for ev in prof.profiler.kineto_results.events()
               if ev.device_type() == torch.autograd.DeviceType.CUDA and ev.duration_ns() > 0]
    busy = sum(kernels) / 1e9
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")
    return {"profiled_wall_s": wall, "trace_s": time.perf_counter() - t0 - wall,
            "device_busy_s": busy, "device_idle_share": 1.0 - busy / wall,
            "device_kernels": len(kernels),
            "launches": {n: f.launches - before[n] for n, f in counters.items()}}


if __name__ == "__main__":
    main()
