"""Steady-state training throughput on the real data path.

    python -m oron_tts_tpu_torch.cli.bench_train_e2e [--fixed-shape-frames-per-s N]
    python -m oron_tts_tpu_torch.cli.bench_train_e2e --smoke     # CPU, tiny model

Counterpart of the JAX package's ``scripts/bench_train_e2e.py``. It renders a
tone-code corpus with an MBSpeech-like length (13-14 words of 4 letters,
8.9-9.6 s a clip, so every batch collates to one shape), then drives
``python -m oron_tts_tpu_torch.cli.train --from-local`` on
``configs/bench_e2e.yaml`` (Base): WAV decode and mel extraction in the
loader's threads, the frame-budget sampler, the collator, validation each
epoch. The trainer's epoch lines (``↳ epoch N: 12.3s | ...``) give the epoch
times; epochs 3 and later are the steady state. Writes
``TRAIN_E2E_h100.json`` with the card's name and power limit.

``--fixed-shape-frames-per-s`` takes the kept frames a second of the
fixed-shape ``[12, 2048]`` step (``chip_smoke.py``'s ``train`` lines) and
records the ratio of the two.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
EPOCH_LINE = re.compile(r"epoch \d+: ([0-9.]+)s \|")


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="End-to-end training throughput (PyTorch, one GPU)")
    ap.add_argument("--sentences", type=int, default=500)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--data-dir", type=Path, default=REPO_ROOT / "output" / "e2e_corpus")
    ap.add_argument("--work-dir", type=Path, default=REPO_ROOT / "output" / "e2e_run")
    ap.add_argument("--smoke", action="store_true",
                    help="CPU, configs/test.yaml, 24 clips, 2 epochs (pipeline check only)")
    ap.add_argument("--fixed-shape-frames-per-s", type=float, default=None,
                    help="kept frames/s of the fixed-shape step, for the ratio")
    ap.add_argument("--out", type=Path, default=REPO_ROOT / "TRAIN_E2E_h100.json")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)
    from oron_tts_tpu_torch.cli.make_tone_corpus import build_corpus, write_corpus
    from oron_tts_tpu_torch.utils.device import card_name, resolve_device

    device = resolve_device("cpu" if args.smoke else None)  # the card, or raise
    n = 24 if args.smoke else args.sentences
    # a narrow length band (832-897 frames, one 1,024-frame bucket; 24 clips
    # fill the 24,576-frame budget): every batch collates to (24, 1024), the
    # frames of the fixed-shape [12, 2048] step
    kw = {} if args.smoke else {"min_words": 13, "max_words": 14, "min_len": 4, "max_len": 4}
    t0 = time.time()
    texts, wavs = build_corpus(n, 0, **kw)
    meta = write_corpus(args.data_dir, texts, wavs)
    total_s = sum(m["duration"] for m in meta)
    # cli/train.py's 90/10 split: about 90% of the audio is trained on
    train_s = total_s * 0.9
    train_frames = int(train_s * 24000 / 256)
    print(f"corpus: {n} clips, {total_s / 60:.1f} min audio "
          f"({time.time() - t0:.0f}s to generate)", flush=True)

    cfg = "configs/test.yaml" if args.smoke else "configs/bench_e2e.yaml"
    cmd = [sys.executable, "-m", "oron_tts_tpu_torch.cli.train", "--config", cfg,
           "--from-local", "--data-dir", str(args.data_dir),
           "--num-epochs", str(2 if args.smoke else args.epochs),
           "--checkpoint-dir", str(args.work_dir / "ckpt"),
           "--log-dir", str(args.work_dir / "logs")]
    if args.smoke:
        cmd += ["--device", "cpu"]
    print("running:", " ".join(cmd), flush=True)
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=str(REPO_ROOT), timeout=7200)
    wall = time.time() - t0
    log = proc.stdout + proc.stderr
    args.work_dir.mkdir(parents=True, exist_ok=True)
    (args.work_dir / "train.log").write_text(log)
    if proc.returncode != 0:
        print(log[-4000:])
        raise SystemExit(f"cli.train failed rc={proc.returncode}")

    epoch_s = [float(m.group(1)) for m in EPOCH_LINE.finditer(log)]
    if not epoch_s:
        print(log[-4000:])
        raise SystemExit("no epoch timings found in cli.train's output")
    steady = epoch_s[2:] if len(epoch_s) > 3 else epoch_s[-1:]
    steady_s = sum(steady) / len(steady)
    payload = {
        "protocol": "python -m oron_tts_tpu_torch.cli.train --from-local on a tone-code "
                    "corpus (TTSDataset, DynamicBatchSampler, collator, validation)",
        "device": card_name(device),
        "config": cfg,
        "clips": n, "audio_minutes": round(total_s / 60, 1),
        "train_frames_per_epoch": train_frames,
        "epochs": len(epoch_s),
        "epoch_seconds": [round(s, 2) for s in epoch_s],
        "epoch1_s": round(epoch_s[0], 2),
        "steady_epoch_s": round(steady_s, 3),
        "steady_frames_per_s": round(train_frames / steady_s),
        "steady_audio_s_per_s": round(train_s / steady_s, 1),
        "total_wall_s": round(wall, 1),
    }
    if args.fixed_shape_frames_per_s:
        payload["fixed_shape_frames_per_s"] = args.fixed_shape_frames_per_s
        payload["ratio_vs_fixed_shape"] = round(
            train_frames / steady_s / args.fixed_shape_frames_per_s, 3)
    args.out.write_text(json.dumps(payload, indent=1))
    print(json.dumps(payload, indent=1))
    print(f"wrote {args.out}")
    return payload


if __name__ == "__main__":
    main()
