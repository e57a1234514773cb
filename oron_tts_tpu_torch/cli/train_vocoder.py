"""Train the Vocos vocoder (mel → waveform) on a local corpus (PyTorch, one GPU).

    python -m oron_tts_tpu_torch.cli.train_vocoder --data-dir data/synth_speech \\
        [--steps 100000] [--gan --gan-start-step N --resume] [--device cpu]

Counterpart of the JAX package's ``scripts/train_vocoder.py``, flag for
flag. The corpus (``metadata.json`` of ``audio_path`` records, its last
``--holdout-frac`` left out for ``cli.eval_vocoder``) is packed into one
tensor on the device; each window of ``k = min(--log-interval, 25)`` steps
samples its crop starts ``[k, batch]`` on the host (numpy, seed 1) and runs
k guarded steps (``train/vocoder.py``). Steps are counted in whole windows;
a checkpoint is written when ``step % --save-interval < k`` and at the end.

Stage 1 minimises MR-STFT + mel L1 under AdamW with a warm-up cosine
schedule; ``--gan`` resumes a run at or past ``--gan-start-step`` into the
LSGAN stage (MPD + MRD discriminators, both nets AdamW(b1 0.8, b2 0.99)).
Checkpoints are ``vocos_step_*.npz`` with a ``config.json``; the GAN stage
tags its generator checkpoints ``stage: "gan"`` and writes the
discriminator as ``vocos_disc_step_*.npz``. Both packages read each other's
checkpoints, optimizer moments and schedule position included, and
``F5TTS.load_vocoder`` / ``cli.infer --vocoder`` load them.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train the OronTTS vocoder (PyTorch)")
    parser.add_argument("--data-dir", type=str, required=True,
                        help="Directory with metadata.json (cli.prepare or "
                             "cli.make_synthetic_speech output)")
    parser.add_argument("--checkpoint-dir", type=str, default="output/vocoder")
    parser.add_argument("--steps", type=int, default=100000)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--crop-frames", type=int, default=64)
    parser.add_argument("--learning-rate", type=float, default=2e-4)
    parser.add_argument("--dim", type=int, default=512)
    parser.add_argument("--n-layers", type=int, default=8)
    parser.add_argument("--head-mode", type=str, default="mag_phase",
                        choices=["mag_phase", "real_imag"],
                        help="mag_phase (the official Vocos parametrization; trains far "
                             "better from scratch) or real_imag")
    parser.add_argument("--save-interval", type=int, default=5000)
    parser.add_argument("--log-interval", type=int, default=100)
    parser.add_argument("--holdout-frac", type=float, default=0.05,
                        help="Tail fraction of the corpus excluded from training "
                             "(cli.eval_vocoder scores on it)")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--gan", action="store_true",
                        help="Enable the adversarial stage (MPD+MRD, LSGAN)")
    parser.add_argument("--gan-start-step", type=int, default=0,
                        help="Step at which the GAN stage kicks in")
    parser.add_argument("--disc-lr", type=float, default=2e-4)
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    return parser


def load_corpus(data_dir: str, holdout_frac: float, sample_rate: int) -> list:
    """Peak-normalized mono clips of ``metadata.json`` without its held-out tail."""
    import numpy as np

    from oron_tts_tpu_torch.data.wav import normalize_peak, read_wav, resample

    metadata = json.loads((Path(data_dir) / "metadata.json").read_text())
    if holdout_frac > 0:
        n_hold = int(len(metadata) * holdout_frac)
        if n_hold:
            metadata = metadata[:-n_hold]
            print(f"Holding out last {n_hold} clips for evaluation")
    print(f"Loading {len(metadata)} clips...")
    audios = []
    for m in metadata:
        wav, sr = read_wav(m["audio_path"])
        if wav.ndim > 1:
            wav = wav.mean(axis=1)
        if sr != sample_rate:
            wav = resample(wav, sr, sample_rate)
        audios.append(normalize_peak(wav.astype(np.float32)))
    return audios


class _Net:
    """A module's parameters as a list, and their flax-layout trees both ways."""

    def __init__(self, module) -> None:
        self.module = module
        named = list(module.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]

    def to_tree(self, tensors) -> dict:
        from oron_tts_tpu_torch.utils.weights import to_flax_params

        return to_flax_params(dict(zip(self.names, tensors)))

    def from_tree(self, tree) -> list:
        from oron_tts_tpu_torch.utils.weights import from_flax_params

        flat = from_flax_params(tree)
        return [flat[n] for n in self.names]

    def load(self, tree) -> None:
        import torch

        with torch.no_grad():
            for p, s in zip(self.params, self.from_tree(tree)):
                p.copy_(s)


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from oron_tts_tpu_torch.models.vocos import VocosDecoder
    from oron_tts_tpu_torch.ops.mel import MelConfig
    from oron_tts_tpu_torch.train.checkpoint import CheckpointManager
    from oron_tts_tpu_torch.train.vocoder import (
        OptaxAdamW,
        make_vocoder_superstep,
        pack_corpus,
        warmup_cosine_schedule,
    )
    from oron_tts_tpu_torch.utils.device import resolve_device
    from oron_tts_tpu_torch.utils.weights import init_module_params

    device = resolve_device(args.device)  # the card, or raise; --device cpu on purpose
    mel_cfg = MelConfig()
    audios = load_corpus(args.data_dir, args.holdout_frac, mel_cfg.sample_rate)

    vocoder = VocosDecoder(dim=args.dim, n_layers=args.n_layers,
                           intermediate_dim=args.dim * 3, head_mode=args.head_mode)
    gen = _Net(vocoder)
    gen.load(init_module_params(vocoder, seed=0))
    vocoder.to(device).train()

    opt = OptaxAdamW(gen.params, warmup_cosine_schedule(args.learning_rate, args.steps))
    crop_len = args.crop_frames * mel_cfg.hop_length
    k_steps = max(1, min(args.log_interval, 25))
    step_fn = make_vocoder_superstep(vocoder, opt, mel_cfg, crop_len, k_steps)

    cm = CheckpointManager(args.checkpoint_dir, model_name="vocos", max_checkpoints=3)
    start_step = 0
    info: dict = {}
    if args.resume:
        info = cm.load()
        if info.get("params") is not None:
            gen.load(info["params"])
            # Adam moments and the schedule position (the count drives it); a
            # GAN-stage checkpoint carries the GAN generator optimizer instead
            if info.get("opt") is not None and info.get("stage") != "gan":
                opt.load_optax_state(info["opt"], gen.from_tree)
            start_step = int(info.get("step", 0))
            print(f"Resumed from step {start_step}")

    rng = np.random.default_rng(1)
    voc_config = {"dim": args.dim, "n_layers": args.n_layers,
                  "intermediate_dim": args.dim * 3, "head_mode": args.head_mode}
    flat_np, offsets, max_starts = pack_corpus(audios, crop_len)
    flat = torch.from_numpy(flat_np).to(device)
    print(f"Corpus on device: {flat_np.nbytes/1e6:.0f} MB, {len(audios)} clips; "
          f"{k_steps} steps/window", flush=True)

    def sample_starts() -> np.ndarray:
        clips = rng.integers(0, len(audios), size=(k_steps, args.batch_size))
        within = rng.random((k_steps, args.batch_size))
        return offsets[clips] + (within * (max_starts[clips] + 1)).astype(np.int64)

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    windows: list[dict] = []
    t0 = time.monotonic()
    if args.gan:
        from oron_tts_tpu_torch.models.discriminators import VocoderDiscriminator
        from oron_tts_tpu_torch.train.vocoder import make_gan_superstep

        if start_step < args.gan_start_step:
            # the loop below is all-adversarial; entering it before
            # --gan-start-step would start the GAN stage early
            raise SystemExit(
                f"--gan-start-step {args.gan_start_step} not reached: resume checkpoint "
                f"is at step {start_step}. Run the MR-STFT stage (without --gan) up to "
                f"that step first.")
        disc_module = VocoderDiscriminator()
        disc = _Net(disc_module)
        disc.load(init_module_params(disc_module, seed=1))
        disc_module.to(device).train()
        d_opt = OptaxAdamW(disc.params, args.disc_lr, b1=0.8, b2=0.99)
        g_opt = OptaxAdamW(gen.params, args.learning_rate, b1=0.8, b2=0.99)
        if info.get("stage") == "gan" and info.get("opt") is not None:
            # resuming a GAN-stage run: continue the generator's adversarial moments
            g_opt.load_optax_state(info["opt"], gen.from_tree)
        gan_step_fn = make_gan_superstep(vocoder, disc_module, g_opt, d_opt, mel_cfg,
                                         crop_len, k_steps)
        d_cm = CheckpointManager(args.checkpoint_dir, model_name="vocos_disc",
                                 max_checkpoints=1)
        d_info = d_cm.load() if args.resume else {}
        if d_info.get("params") is not None:
            disc.load(d_info["params"])
            if d_info.get("opt") is not None:
                d_opt.load_optax_state(d_info["opt"], disc.from_tree)

        step = start_step
        while step < args.steps:
            # a window always runs k_steps steps; --steps rounds up to a whole window
            w0 = time.monotonic()
            m = gan_step_fn(flat, sample_starts())
            sync()
            step += k_steps
            windows.append({"step": step, "seconds": time.monotonic() - w0,
                            "g_loss_mean": float(np.nanmean(m[:, 0])),
                            "d_loss_mean": float(np.nanmean(m[:, 1])),
                            "mel_l1_mean": float(np.nanmean(m[:, 2])),
                            "finite": bool(np.isfinite(m).all())})
            if (step // k_steps) % max(1, args.log_interval // k_steps) == 0 \
                    or step >= args.steps:
                rate = (step - start_step) / (time.monotonic() - t0)
                print(f"step {step}/{args.steps} | g={m[-1, 0]:.4f} d={m[-1, 1]:.4f} "
                      f"mel={m[-1, 2]:.4f} (window mel {np.nanmean(m[:, 2]):.4f}) | "
                      f"gnorm={m[-1, 3]:.2f} | {rate:.1f} it/s", flush=True)
            if step % args.save_interval < k_steps or step >= args.steps:
                cm.save(step, gen.to_tree(gen.params), opt_state=g_opt.optax_state(gen.to_tree),
                        loss=float(m[-1, 0]), config=voc_config, extra_state={"stage": "gan"})
                d_cm.save(step, disc.to_tree(disc.params),
                          opt_state=d_opt.optax_state(disc.to_tree))
        print(f"Done. Use: cli.infer --vocoder {cm.latest_checkpoint()}")
        return {"stage": "gan", "start_step": start_step, "step": step, "windows": windows,
                "seconds": time.monotonic() - t0, "checkpoint": str(cm.latest_checkpoint()),
                "disc_checkpoint": str(d_cm.latest_checkpoint())}

    step = start_step
    while step < args.steps:
        w0 = time.monotonic()
        losses, gnorms = step_fn(flat, sample_starts())
        sync()
        step += k_steps
        n_skip = int((~(np.isfinite(losses) & np.isfinite(gnorms))).sum())
        windows.append({"step": step, "seconds": time.monotonic() - w0,
                        "loss_mean": float(np.nanmean(losses)), "loss_last": float(losses[-1]),
                        "gnorm_last": float(gnorms[-1]), "skipped": n_skip})
        if (step // k_steps) % max(1, args.log_interval // k_steps) == 0 or step >= args.steps:
            rate = (step - start_step) / (time.monotonic() - t0)
            print(f"step {step}/{args.steps} | loss={losses[-1]:.4f} "
                  f"(window mean {np.nanmean(losses):.4f}) | gnorm={gnorms[-1]:.3f} | "
                  f"skipped={n_skip} | {rate:.1f} it/s", flush=True)
        if step % args.save_interval < k_steps or step >= args.steps:
            cm.save(step, gen.to_tree(gen.params), opt_state=opt.optax_state(gen.to_tree),
                    loss=float(losses[-1]), config=voc_config)
    print(f"Done. Use: cli.infer --vocoder {cm.latest_checkpoint()}")
    return {"stage": "mr_stft", "start_step": start_step, "step": step, "windows": windows,
            "seconds": time.monotonic() - t0, "checkpoint": str(cm.latest_checkpoint())}


if __name__ == "__main__":
    main()
