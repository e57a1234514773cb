"""End-to-end smoke harness of the PyTorch port: twelve steps on synthetic audio.

    python -m oron_tts_tpu_torch.cli.test_pipeline [--device cpu] [--hf]

Counterpart of the JAX package's ``scripts/test_pipeline.py``, on a tiny model
(dim 64, depth 2): config validation → tokenizer → cleaner → chunking → mel
(the device's log-mel against the host's) → dataset → collator → model
forward (``F5TTS.forward``) → backward (finite, non-zero gradients) → one
train epoch with a checkpoint → sampler synthesis → optionally ten real
records streamed from the HuggingFace hub (``--hf``, network). It runs on the
card unless ``--device cpu`` is given. Exit code 0 iff every step passes.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

REPO_ROOT = Path(__file__).resolve().parents[2]
TINY_MODEL = {
    "vocab_size": 65, "dim": 64, "depth": 2, "heads": 2, "ff_mult": 2,
    "text_dim": 32, "conv_layers": 2, "p_dropout": 0.0,
}


def synth_audio(duration_s: float = 1.5, sr: int = 24000, freq: float = 220.0) -> np.ndarray:
    t = np.arange(int(sr * duration_s)) / sr
    return (0.5 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def step_config(device) -> None:
    from oron_tts_tpu_torch.config import F5Config, load_config

    for name in ("local", "runpod", "colab", "test"):
        cfg = F5Config.from_dict(load_config(REPO_ROOT / f"configs/{name}.yaml"))
        assert cfg.audio.sample_rate == 24000
        assert cfg.audio.n_mels == 100
        assert cfg.model.vocab_size == 65
        assert cfg.model.dim % cfg.model.heads == 0


def step_tokenizer(device) -> None:
    from oron_tts_tpu_torch.text import CyrillicTokenizer

    tok = CyrillicTokenizer()
    assert tok.vocab_size == 65
    ids = tok.encode("сайн байна уу", lang="mn")
    assert tok.unk_id not in ids
    assert tok.decode(ids) == "сайн байна уу"


def step_cleaner(device) -> None:
    from oron_tts_tpu_torch.text import TextCleaner

    c = TextCleaner()
    out = c.clean("Тэр 25 настай, 3-р сард төрсөн!", lang="mn")
    assert "25" not in out and "хорин таван" in out
    assert len(c.text_to_sequence("Сайн байна уу, 100₮ өгнө үү.", lang="mn")) > 10


def step_chunking(device) -> None:
    from oron_tts_tpu_torch.models.f5tts import split_text_for_synthesis

    text = "Нэг өгүүлбэр. " * 30
    chunks = split_text_for_synthesis(text, 120)
    assert all(len(c) <= 120 for c in chunks)
    assert " ".join(chunks) == text.strip()


def step_mel(device) -> None:
    from oron_tts_tpu_torch.data.dataset import TTSDataset
    from oron_tts_tpu_torch.ops.audio import AudioProcessor

    ap = AudioProcessor(device=device)
    audio = synth_audio(1.0)
    mel = ap.mel_spectrogram(audio).cpu().numpy()
    assert mel.shape == (100, 1 + len(audio) // 256)
    assert np.isfinite(mel).all()
    host = TTSDataset(audio_arrays=[audio], texts=["а"])._mel(audio)
    err = np.abs(host - mel)
    # an f32 FFT's rounding (the host's is f64) moves the bins near the 1e-5
    # log floor, where it turns into large log differences: audible bins
    # must agree tightly, floor bins loosely. The JAX harness calls bins above
    # ln 1.2e-4 (-9) audible; torch's f32 FFT on the CPU moves bins up to
    # about ln 3.4e-4 (-8) by more than its tolerance, so -8 here
    audible = host > -8.0
    assert err[audible].mean() < 5e-4, err[audible].mean()
    assert err[audible].max() < 1e-2, err[audible].max()
    assert err.mean() < 0.2, err.mean()


def _make_dataset(n: int = 4):
    from oron_tts_tpu_torch.data.dataset import TTSDataset

    arrays = [synth_audio(1.0 + 0.3 * i, freq=200 + 30 * i) for i in range(n)]
    ds = TTSDataset(audio_arrays=arrays, texts=["сайн байна уу тавтай морил"] * n,
                    sample_rate=24000)
    ds.durations = [len(a) / 24000 for a in arrays]
    return ds


def step_dataset(device) -> None:
    item = _make_dataset()[0]
    assert item["mel"].shape[0] == 100
    assert item["text_ids"].shape[0] == item["mel"].shape[1]
    assert item["mask"].all()


def step_collator(device) -> None:
    from oron_tts_tpu_torch.data.dataset import TTSCollator

    ds = _make_dataset()
    batch = TTSCollator(pad_to_multiple=64)([ds[i] for i in range(4)])
    assert batch["mel"].shape[0] == 4
    assert batch["mel"].shape[2] % 64 == 0
    for i in range(4):
        T = batch["mel_lengths"][i]
        assert batch["mask"][i, :T].all()
        assert not batch["mask"][i, T:].any()
        assert (batch["text_ids"][i, T:] == -1).all()


def _tiny_model(device):
    from oron_tts_tpu_torch.config import F5Config
    from oron_tts_tpu_torch.models.f5tts import F5TTS

    model = F5TTS.from_config(F5Config.from_dict(
        {"sample_rate": 24000, "n_mels": 100, "model": TINY_MODEL}), device=device)
    model.init_params(0)
    return model


def _batch():
    from oron_tts_tpu_torch.data.dataset import TTSCollator

    ds = _make_dataset()
    return TTSCollator(pad_to_multiple=64)([ds[0], ds[1]])


def step_forward(device) -> None:
    import torch

    model, batch = _tiny_model(device), _batch()
    with torch.no_grad():
        loss = float(model.forward(batch["mel"], batch["text_ids"],
                                   torch.from_numpy(batch["mel_lengths"]),
                                   generator=torch.Generator().manual_seed(0)))
    assert np.isfinite(loss) and loss > 0


def step_backward(device) -> None:
    import torch

    model, batch = _tiny_model(device), _batch()
    params = list(model.backbone.parameters())
    for p in params:
        p.requires_grad_(True)
    loss = model.forward(batch["mel"], batch["text_ids"], torch.from_numpy(batch["mask"]),
                         generator=torch.Generator().manual_seed(1))
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [g for g in grads if g is not None]
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert any(float(g.abs().max()) > 0 for g in grads)


def step_train_epoch(device) -> None:
    from oron_tts_tpu_torch.data.dataset import FixedBatchSampler, TTSCollator
    from oron_tts_tpu_torch.data.loader import DataLoader
    from oron_tts_tpu_torch.train.trainer import F5Trainer

    ds, model = _make_dataset(), _tiny_model(device)
    cfg = {
        "sample_rate": 24000, "n_mels": 100, "model": TINY_MODEL,
        "learning_rate": 1e-3, "warmup_steps": 1, "num_epochs": 1,
        "use_tqdm": False, "audio_sample_interval": 1000,
    }
    loader = DataLoader(ds, FixedBatchSampler(len(ds), 2), TTSCollator(pad_to_multiple=64),
                        num_workers=0)
    with tempfile.TemporaryDirectory() as d:
        trainer = F5Trainer(config=cfg, model=model, train_loader=loader,
                            log_dir=f"{d}/logs", checkpoint_dir=f"{d}/ckpt")
        loss = trainer.train_epoch(total_epochs=1)
        assert np.isfinite(loss)
        assert trainer.save_checkpoint(loss=loss).exists()


def step_sampler(device) -> None:
    wav = _tiny_model(device).synthesize("сайн байна уу", n_steps=2, target_duration_s=0.6,
                                         seed=0)
    assert wav.ndim == 1 and np.isfinite(wav).all() and len(wav) > 0


def step_hf_data(device) -> None:
    """Optional: ten real records streamed from the hub (network)."""
    import datasets as hfd

    from oron_tts_tpu_torch.data.dataset import TTSDataset
    from oron_tts_tpu_torch.data.hf import MBSpeechWrapper

    items = []
    for item in MBSpeechWrapper().load(split="train", streaming=True):
        items.append(item)
        if len(items) >= 10:
            break
    tts = TTSDataset.from_hf_dataset(hfd.Dataset.from_list(items), text_column="sentence_norm")
    assert len(tts) > 0
    assert tts[0]["mel"].shape[0] == 100


STEPS = [
    ("config validation", step_config),
    ("tokenizer", step_tokenizer),
    ("text cleaner", step_cleaner),
    ("text chunking", step_chunking),
    ("mel extraction", step_mel),
    ("dataset", step_dataset),
    ("collator", step_collator),
    ("model forward", step_forward),
    ("backward grads finite", step_backward),
    ("train epoch + checkpoint", step_train_epoch),
    ("sampler synthesis", step_sampler),
]


def main(argv: list[str] | None = None) -> int:
    """Run the steps; returns the number that failed (the process's exit code)."""
    parser = argparse.ArgumentParser(description="OronTTS smoke harness (PyTorch port)")
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    parser.add_argument("--hf", action="store_true",
                        help="also stream 10 real samples from the HF hub")
    args = parser.parse_args(argv)

    from oron_tts_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)  # raises without CUDA unless --device cpu
    steps = list(STEPS) + ([("HF real data (10 samples)", step_hf_data)] if args.hf else [])
    failed = []
    for i, (name, fn) in enumerate(steps, 1):
        t0 = time.monotonic()
        try:
            fn(device)
            print(f"[{i:2d}/{len(steps)}] PASS {name} ({time.monotonic() - t0:.1f}s)")
        except Exception:  # noqa: BLE001 - every step is reported, the run goes on
            print(f"[{i:2d}/{len(steps)}] FAIL {name}")
            traceback.print_exc()
            failed.append(name)
    if failed:
        print(f"\nFAILED steps: {failed}")
    else:
        print(f"\nAll {len(steps)} steps passed on {device}.")
    return len(failed)


if __name__ == "__main__":
    sys.exit(1 if main() else 0)
