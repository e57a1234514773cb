"""Model-level cost decomposition: per-block cost, fixed overhead, attention's share.

Counterpart of the JAX package's ``scripts/bench_model_ablation.py``: times
8 chained ``DiT.forward_cfg`` calls (the sampler's unit of work, both CFG rows
in one batch) at the synthesis shape, Base width, bf16: 120 letters, 1,560
frames, bucket 1,600 (as the JAX script computes it). Variants: depth
{22, 11} × ``attn_impl`` {flash, einsum, packed, skip}, all loaded from one
seeded Base tree (depth 11 takes blocks 0-10). The depth pair gives the
per-block cost and the fixed overhead; "skip" (V passed through,
projections kept) gives attention's absolute cost::

    python -m oron_tts_tpu_torch.cli.bench_model_ablation [--device cpu]

Each variant is timed best of three on the host clock around work that ends
in a synchronise; the first call is reported as the JAX script reports its
compile time. Run eagerly, a forward is ~800 launches and the host bounds
it, so on the card two more forwards of each variant run under
``torch.profiler`` and the device time of their kernels is reported beside
the wall time; the derived lines use device time there (the JAX script's
single jitted scan has no host time to separate).
"""

from __future__ import annotations

import argparse
import sys
import time

IMPLS = ("flash", "einsum", "packed", "skip")
DEPTHS = (22, 11)
LETTERS, ITERS, SEED = 120, 8, 0


def main(argv: list[str] | None = None) -> dict[str, dict[tuple[int, str], float]]:
    """Print one line per variant and the derived lines.

    Returns seconds per forward by (depth, impl): ``wall``, and ``device``
    on the card (empty on the CPU).
    """
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from oron_tts_tpu_torch.config import ModelConfig
    from oron_tts_tpu_torch.models.dit import DiT
    from oron_tts_tpu_torch.utils.device import resolve_device
    from oron_tts_tpu_torch.utils.weights import from_flax_params, seeded_dit_params

    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# device={name}", file=sys.stderr)
    t_total = LETTERS * 13
    T = -(-t_total // 64) * 64
    mcfg = ModelConfig()  # Base
    kw = dict(dim=mcfg.dim, heads=mcfg.heads, dim_head=mcfg.dim_head, ff_mult=mcfg.ff_mult,
              mel_dim=100, vocab_size=mcfg.vocab_size, text_dim=mcfg.text_dim,
              conv_layers=mcfg.conv_layers, dropout=0.0)
    state = {k: v.to(dev, torch.bfloat16) for k, v in from_flax_params(
        seeded_dit_params(mcfg, seed=SEED)).items()}

    gen = torch.Generator(device=dev).manual_seed(SEED)
    text = torch.randint(0, 65, (1, T), generator=gen, device=dev)
    noise = torch.randn(1, T, 100, generator=gen, device=dev)
    cond = torch.zeros(1, T, 100, device=dev)
    mask = torch.arange(T, device=dev)[None, :] < t_total
    time_ = torch.full((1,), 0.5, device=dev)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize()

    results: dict[tuple[int, str], float] = {}
    device: dict[tuple[int, str], float] = {}

    def device_seconds(fn) -> float:
        """Device time of the kernels ``fn`` launches, summed (torch.profiler)."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
        return sum(ev.device_time_total for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e6

    @torch.no_grad()
    def measure(depth: int, impl: str) -> float:
        with torch.device(dev):
            model = DiT(depth=depth, attn_impl=impl, **kw)
        model = model.to(torch.bfloat16).eval()
        keep = {k: v for k, v in state.items()
                if not (k.startswith("block") and int(k[5:].split(".")[0]) >= depth)}
        model.load_state_dict(keep, strict=True)
        te = model.embed_text(text, T)

        def run(iters: int = ITERS) -> None:
            x = noise
            for _ in range(iters):
                pred, null = model.forward_cfg(x, cond, te, te, time_, mask)
                x = x + 0.03 * (pred + (pred - null) * 2.0).float()
            sync()

        t0 = time.perf_counter()
        run()
        first = time.perf_counter() - t0
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
        dt = best / ITERS
        line = f"depth={depth:2d} attn={impl:7s} {dt * 1e3:8.2f} ms/fwd"
        if dev.type == "cuda":  # two forwards under the profiler: its cost grows with events
            device[(depth, impl)] = device_seconds(lambda: run(2)) / 2
            line += f", device {device[(depth, impl)] * 1e3:8.2f} ms/fwd"
        print(f"{line} (first call {first:.1f}s)", flush=True)
        results[(depth, impl)] = dt
        return dt

    deep, shallow = DEPTHS
    for depth in DEPTHS:
        for impl in IMPLS:
            measure(depth, impl)

    basis = device or results
    f22, f11 = basis[(deep, "flash")], basis[(shallow, "flash")]
    s22 = basis[(deep, "skip")]
    per_block = (f22 - f11) / (deep - shallow)
    fixed = f22 - deep * per_block
    attn = {impl: (basis[(deep, impl)] - s22) / deep for impl in ("flash", "einsum", "packed")}
    print(f"# --- derived ({'device' if device else 'wall'} time) ---", file=sys.stderr)
    print(f"# per-block (flash): {per_block * 1e3:.3f} ms; fixed: {fixed * 1e3:.2f} ms/fwd",
          file=sys.stderr)
    print(f"# attention per block: flash {attn['flash'] * 1e3:.3f} ms, "
          f"einsum {attn['einsum'] * 1e3:.3f} ms, packed {attn['packed'] * 1e3:.3f} ms",
          file=sys.stderr)
    print(f"# attention share of a depth-{deep} forward: flash "
          f"{attn['flash'] * deep / f22:.3f}", file=sys.stderr, flush=True)
    return {"wall": results, "device": device}


if __name__ == "__main__":
    main()
