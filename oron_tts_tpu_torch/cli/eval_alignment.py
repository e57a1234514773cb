"""Did it learn TTS? Train on the tone-code corpus and score held-out sentences.

    python -m oron_tts_tpu_torch.cli.eval_alignment --dim 512 --depth 12 --heads 8 \\
        --text-dim 256 --epochs 60 --out ALIGNMENT_h100_small.json

CPU smoke (seconds, a high CER):

    python -m oron_tts_tpu_torch.cli.eval_alignment --device cpu --sentences 24 \\
        --dim 64 --depth 2 --heads 2 --epochs 2 --holdout 2 --n-steps 4 --out a.json

Counterpart of the JAX package's ``scripts/eval_tts_alignment.py``, with its
flags and its JSON payload (``evals/alignment.py`` protocol). A corpus is
rendered from random letters (``cli/make_tone_corpus.py``), ``F5Trainer``
trains on all but the last ``--holdout`` sentences, and each held-out
sentence is synthesized ref-free and decoded back to letters by a per-frame
mel argmax: the character error rate (CER) is about 1 untrained and falls
toward 0 as the model learns text-conditioned generation. Each of the raw and
EMA weights is scored three ways: at the exact duration (chars·13 frames,
spaces included), at the facade's ref-free heuristic (13 frames a non-space
character), and with a duration table fitted on the training split.

The payload adds ``device`` (the card's name and power limit), and leaves out
the JAX payload's ``backend``. ``--checkpoint-dir`` also writes the trained
checkpoint and its ``config.json`` (with the fitted duration table) there,
for ``cli.export`` and ``cli.infer``. ``ORON_ALIGN_SKIP_BASELINE`` (the JAX
script's switch) skips the untrained baseline. Runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from pathlib import Path

import numpy as np

SR = 24000


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Tone-code alignment eval (PyTorch, one GPU)")
    ap.add_argument("--sentences", type=int, default=512, help="corpus size incl. holdout")
    ap.add_argument("--holdout", type=int, default=24,
                    help="held-out sentences scored after training")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--text-dim", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--frames-budget", type=int, default=8192,
                    help="DynamicBatchSampler frame budget per batch")
    ap.add_argument("--n-steps", type=int, default=32, help="ODE steps at eval synthesis")
    ap.add_argument("--cfg-strength", type=float, default=2.0)
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--checkpoint-dir", type=Path, default=None,
                    help="also write the trained checkpoint and config.json here")
    ap.add_argument("--out", type=Path, default=Path("ALIGNMENT.json"))
    args = ap.parse_args(argv)
    if args.epochs < 1:
        ap.error("--epochs must be >= 1 (the payload reports final train loss)")
    return args


def score(model, texts: list[str], n_steps: int, cfg_strength: float, seed: int,
          exact_duration: bool = True) -> tuple[float, list[float]]:
    """Mean CER over ``texts``: synthesize each ref-free, decode, compare.

    ``exact_duration`` passes the corpus' true length (13 frames × cleaned
    characters, spaces included), so the mel sits at the training
    distribution's duration; without it the facade estimates the length
    (its chars·13 heuristic counts no spaces, about 15% short on this
    corpus, or the calibrated table when one is installed).
    """
    from oron_tts_tpu_torch.evals.alignment import (
        FRAMES_PER_CHAR,
        HOP,
        char_error_rate,
        decode_logmel,
        expected_letters,
    )
    from oron_tts_tpu_torch.text.cleaner import TextCleaner

    cleaner = TextCleaner()
    cers = []
    for i, text in enumerate(texts):
        dur_s = None
        if exact_duration:
            dur_s = len(cleaner.clean(text, "mn")) * FRAMES_PER_CHAR * HOP / SR
        mel = model.synthesize_mel(text, n_steps=n_steps, cfg_strength=cfg_strength,
                                   seed=seed + i, target_duration_s=dur_s)
        cers.append(char_error_rate(expected_letters(text), decode_logmel(mel)))
    return float(np.mean(cers)), [round(c, 4) for c in cers]


def main(argv: list[str] | None = None) -> dict:
    """Run the protocol; writes ``--out`` and returns the payload."""
    args = parse_args(argv)

    from oron_tts_tpu_torch.cli.make_tone_corpus import build_corpus
    from oron_tts_tpu_torch.config import F5Config
    from oron_tts_tpu_torch.data.dataset import DynamicBatchSampler, TTSCollator, TTSDataset
    from oron_tts_tpu_torch.data.duration_stats import stats_from_texts
    from oron_tts_tpu_torch.data.loader import DataLoader
    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from oron_tts_tpu_torch.train.trainer import F5Trainer
    from oron_tts_tpu_torch.utils.device import card_name, resolve_device

    device = resolve_device(args.device)  # raises without CUDA unless --device cpu
    texts, wavs = build_corpus(args.sentences, args.seed)
    if not 0 < args.holdout < len(texts):
        raise SystemExit("--holdout must be in (0, --sentences)")
    # the alphabet-cover sentences lead the corpus; hold out from the tail
    hold_texts = texts[-args.holdout:]
    train_texts, train_wavs = texts[:-args.holdout], wavs[:-args.holdout]

    ds = TTSDataset(audio_arrays=train_wavs, texts=train_texts, sample_rate=SR)
    loader = DataLoader(
        ds, DynamicBatchSampler([len(w) / SR for w in train_wavs], args.frames_budget,
                                sample_rate=SR),
        # rows padded to a multiple of 8, as in the JAX protocol (padded rows
        # have mel_length 0 and drop out of the masked loss)
        TTSCollator(pad_batch_to_multiple=8),
        num_workers=0,
    )

    cfg = {
        "sample_rate": SR, "n_mels": 100,
        "learning_rate": args.lr, "warmup_steps": 200,
        "num_epochs": args.epochs, "ema_decay": 0.995,
        "max_grad_norm": 1.0, "use_tqdm": False,
        "audio_sample_interval": 10**9, "log_interval": 10**9,
        "model": {
            "vocab_size": 65, "dim": args.dim, "depth": args.depth,
            "heads": args.heads, "ff_mult": 2, "text_dim": args.text_dim,
            "conv_layers": 2, "p_dropout": 0.0,
        },
    }
    model = F5TTS.from_config(F5Config.from_dict(cfg), device=device)
    model.init_params(args.seed)
    card = card_name(device)
    print(f"model: dim={args.dim} depth={args.depth} params={model.num_params() / 1e6:.1f}M "
          f"device={card} dtype={model.dtype}")

    if os.environ.get("ORON_ALIGN_SKIP_BASELINE"):
        untrained_cer = float("nan")
        print("skipping untrained baseline (ORON_ALIGN_SKIP_BASELINE)")
    else:
        untrained_cer, _ = score(model, hold_texts[: min(4, len(hold_texts))],
                                 args.n_steps, args.cfg_strength, args.seed)
        print(f"untrained baseline CER (4 clips): {untrained_cer:.3f}")

    with tempfile.TemporaryDirectory() as tmp:
        trainer = F5Trainer(
            config=cfg, model=model, train_loader=loader,
            log_dir=str(Path(tmp) / "logs"),
            checkpoint_dir=str(args.checkpoint_dir or Path(tmp) / "ckpt"),
        )
        t0 = time.time()
        for epoch in range(args.epochs):
            loss = trainer.train_epoch(total_epochs=args.epochs)
            if epoch % 5 == 0 or epoch == args.epochs - 1:
                print(f"epoch {epoch + 1}/{args.epochs} loss={loss:.4f} "
                      f"({time.time() - t0:.0f}s)", flush=True)
        if model.device.type == "cuda":
            import torch

            torch.cuda.synchronize(model.device)
        train_s = time.time() - t0
        trainer.finish()

    # the calibrated ref-free duration: the per-token frames table fitted on
    # the training split only, as cli/train.py fits it on a real corpus
    dur_stats = stats_from_texts(train_texts, "mn", [len(w) / SR for w in train_wavs], SR, 256)
    if args.checkpoint_dir is not None:
        cfg["duration_stats"] = dur_stats
        trainer.save_checkpoint(loss=loss)
        trainer.checkpoint_manager.wait()
        print(f"wrote checkpoint to {args.checkpoint_dir}")

    results = {}
    for name, weights in (("raw", trainer.state.params), ("ema", trainer.state.ema)):
        trainer._sync_working_set(weights)
        cer, per_clip = score(model, hold_texts, args.n_steps, args.cfg_strength, args.seed)
        model.set_duration_stats(None)
        cer_rf, _ = score(model, hold_texts, args.n_steps, args.cfg_strength, args.seed,
                          exact_duration=False)
        model.set_duration_stats(dur_stats)
        cer_cal, _ = score(model, hold_texts, args.n_steps, args.cfg_strength, args.seed,
                           exact_duration=False)
        model.set_duration_stats(None)
        results[name] = {"cer": round(cer, 4), "per_clip": per_clip,
                         "cer_reffree_duration": round(cer_rf, 4),
                         "cer_reffree_calibrated": round(cer_cal, 4)}
        print(f"holdout CER ({name}): {cer:.4f} (ref-free heuristic: {cer_rf:.4f}, "
              f"calibrated: {cer_cal:.4f})")

    payload = {
        "protocol": "tone-code alignment (oron_tts_tpu_torch/evals/alignment.py)",
        "device": card,
        "untrained_cer_4clip": round(untrained_cer, 4),
        "holdout": results,
        "train_seconds": round(train_s, 1),
        "steps": int(trainer.global_step),
        # raw frames over the whole run (data, collate, device steps included)
        "frames_per_s": round(args.epochs * sum(len(w) // 256 for w in train_wavs) / train_s),
        "final_train_loss": round(float(loss), 4),
        "config": {k: cfg[k] for k in ("learning_rate", "num_epochs", "ema_decay", "model")},
        "sentences": args.sentences, "holdout_n": args.holdout,
        "n_steps": args.n_steps, "cfg_strength": args.cfg_strength,
        "seed": args.seed,
        "duration_stats_global": dur_stats["global"] if dur_stats else None,
    }
    args.out.write_text(json.dumps(payload, indent=1))
    print(f"wrote {args.out}")
    return payload


if __name__ == "__main__":
    main()
