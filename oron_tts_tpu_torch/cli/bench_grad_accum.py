"""Time gradient accumulation on the card: a window of micro-batches against the fused step.

    python -m oron_tts_tpu_torch.cli.bench_grad_accum            # the card, Base bf16
    python -m oron_tts_tpu_torch.cli.bench_grad_accum --smoke    # CPU, a tiny model

Counterpart of the JAX package's ``scripts/bench_grad_accum.py``. At the
Base width (bf16 lanes, dropout 0.1, seeded weights), ``F5Trainer`` with
``grad_accumulation_steps`` 4 runs windows of 4 micro-batches of
``[3, 2048]`` frames through ``_accum_step`` and ``_apply_accum``, timed
three ways, each over 6 windows after two warm-up windows:

- ``pipelined``: nothing is read on the host inside a window;
- ``per-micro host sync``: the running loss is read after every micro-batch;
- ``remat``: pipelined, with ``gradient_checkpointing`` on.

Beside them, the fused ``[12, 2048]`` step (``train_step``), the same frames
in one batch. Each reports ms a window (or step) and kept frames a second,
with the card's name and power limit. On the card this drives kernels 2, 4,
5, 10 and 11 (the grouped conv, the lanes attention forward with row
statistics and its backward, GELU+dropout both ways).
"""

from __future__ import annotations

import argparse
import tempfile
import time


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description="Gradient accumulation against the fused step")
    ap.add_argument("--smoke", action="store_true",
                    help="CPU, a two-layer model of width 64, 2 x 128-frame micro-batches")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from oron_tts_tpu_torch.config import F5Config
    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from oron_tts_tpu_torch.train.trainer import F5Trainer
    from oron_tts_tpu_torch.utils.device import card_name, resolve_device
    from oron_tts_tpu_torch.utils.weights import seeded_dit_params

    cfg = F5Config()  # Base: dim 1024, depth 22, heads 16, dropout 0.1
    B, T, K, iters = 3, 2048, 4, 6  # scripts/bench_grad_accum.py's protocol
    if args.smoke:
        B, T, K, iters = 2, 128, 2, 1
        cfg = F5Config.from_dict({"model": {"dim": 64, "depth": 2, "heads": 2, "text_dim": 32,
                                            "ff_mult": 2, "conv_layers": 1}})
    device = resolve_device("cpu" if args.smoke else None)  # the card, or raise
    cuda = device.type == "cuda"
    model = F5TTS(cfg, device=device, dtype=torch.bfloat16 if cuda else torch.float32)
    model.load_params(seeded_dit_params(cfg.model, seed=1))
    rng = np.random.default_rng(0)
    n_mels = cfg.audio.n_mels

    def batch(rows: int) -> dict:
        return {"mel": (0.5 * rng.standard_normal((rows, n_mels, T))).astype(np.float32),
                "text_ids": rng.integers(0, cfg.model.vocab_size, (rows, T)).astype(np.int32),
                "mel_lengths": np.full((rows,), T, np.int32)}

    micro, fused = batch(B), batch(B * K)
    config = {"learning_rate": 1e-4, "warmup_steps": 1000, "num_epochs": 100,
              "grad_accumulation_steps": K, "use_tqdm": False, "seed": 0}

    def sync() -> None:
        if cuda:
            torch.cuda.synchronize(device)

    results: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        trainer = F5Trainer(config, model, [micro] * K, log_dir=f"{tmp}/logs",
                            checkpoint_dir=f"{tmp}/ckpt")
        generator = torch.Generator().manual_seed(0)

        def window(sync_each_micro: bool) -> dict:
            acc = trainer._zero_accum()
            for _ in range(K):
                trainer._accum_step(acc, micro, generator)
                if sync_each_micro:
                    float(acc["loss_sum"])  # a host read after every micro-batch
            return trainer._apply_accum(acc)

        frames = B * K * T

        def timed(name: str, fn, remat: bool = False) -> None:
            model.backbone.gradient_checkpointing = remat
            for _ in range(2):  # warm-up
                fn()
            sync()
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            for _ in range(iters):
                metrics = fn()
            sync()
            dt = (time.perf_counter() - t0) / iters
            results[name] = {"ms": dt * 1e3, "frames_per_s": frames / dt,
                             "loss": metrics["loss"], "ok": metrics["ok"],
                             "peak_gb": torch.cuda.max_memory_allocated(device) / 1e9
                             if cuda else None}
            print(f"{name}: {dt * 1e3:.1f} ms -> {frames / dt:,.0f} frames/s "
                  f"(loss {metrics['loss']:.3f})", flush=True)

        timed("pipelined", lambda: window(False))
        timed("per-micro host sync", lambda: window(True))
        timed("remat", lambda: window(False), remat=True)
        timed("fused", lambda: trainer.train_step(fused, generator))
        model.backbone.gradient_checkpointing = False
        trainer.finish()
    pipe, fused_ms = results["pipelined"]["ms"], results["fused"]["ms"]
    payload = {"device": card_name(device), "micro_batch": [B, T], "accum": K,
               "fused_batch": [B * K, T], "iters": iters, **results,
               "sync_cost": results["per-micro host sync"]["ms"] / pipe - 1,
               "window_over_fused": pipe / fused_ms}
    print(f"per-micro-batch host sync costs {payload['sync_cost'] * 100:+.1f}% window time; "
          f"a window takes {payload['window_over_fused']:.3f}x the fused step")
    return payload


if __name__ == "__main__":
    main()
