"""Training CLI of the PyTorch port (local data, one GPU).

    python -m oron_tts_tpu_torch.cli.train --config configs/test.yaml \\
        --from-local --data-dir data/processed [--device cpu]

Counterpart of the JAX package's ``cli/train.py`` for ``--from-local`` data
(a ``metadata.json`` of ``audio_path``/``text`` records). It runs on the card
unless ``--device cpu`` is given. The HuggingFace dataset path, the hub
push and the device mesh are not ported yet (``ROADMAP.md``): their flags
are accepted and raise an error that says so.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

NOT_PORTED = (
    "{flag} is not ported to the PyTorch package yet (see ROADMAP.md, "
    "'Still to port'); use --from-local --data-dir"
)


def _metadata_attr_tokens(value: object) -> list[str]:
    if isinstance(value, list):
        return [str(t) for t in value]
    if isinstance(value, str) and value.strip():
        return [value.strip()]
    return []


def build_dataset(data_dir: str, config: dict, default_lang: str = "mn"):
    """``TTSDataset`` over ``<data_dir>/metadata.json``, with header-only durations.

    Files whose header cannot be read are left out up front: a zero-frame
    estimate would mislead the frame-budget sampler.
    """
    from oron_tts_tpu_torch.data.dataset import TTSDataset
    from oron_tts_tpu_torch.data.wav import wav_info

    metadata_path = Path(data_dir) / "metadata.json"
    with open(metadata_path) as f:
        metadata = json.load(f)
    durations, keep = [], []
    for m in metadata:
        try:
            durations.append(wav_info(m["audio_path"])[0])
            keep.append(m)
        except (OSError, ValueError, KeyError) as exc:
            print(f"[train] skipping unreadable audio {m.get('audio_path')}: "
                  f"{type(exc).__name__}: {exc}")
    if len(keep) < len(metadata):
        print(f"[train] skipped {len(metadata) - len(keep)}/{len(metadata)} samples "
              f"with unreadable WAV headers")
    if not keep:
        raise ValueError(f"no readable samples in {metadata_path}")
    ds = TTSDataset(
        audio_paths=[Path(m["audio_path"]) for m in keep],
        texts=[m["text"] for m in keep],
        langs=[m.get("lang", default_lang) for m in keep],
        sample_rate=config.get("sample_rate", 24000),
        n_mels=config.get("n_mels", 100),
        attr_tokens_list=[_metadata_attr_tokens(m.get("attr_tokens")) for m in keep],
        cache_bytes=int(config.get("dataset_cache_bytes", 2 << 30)),
    )
    ds.durations = durations
    return ds


class _Subset:
    def __init__(self, base, indices):
        self.base, self.indices = base, list(indices)
        self.durations = ([base.durations[i] for i in self.indices]
                          if getattr(base, "durations", None) else [])

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.base[self.indices[i]]


def build_loaders(dataset, config: dict):
    """Seeded 90/10 split, samplers and loaders, as the JAX package's CLI."""
    import numpy as np

    from oron_tts_tpu_torch.data.dataset import (
        DynamicBatchSampler,
        FixedBatchSampler,
        TTSCollator,
    )
    from oron_tts_tpu_torch.data.loader import DataLoader

    n = len(dataset)
    val_size = int(n * 0.1)
    perm = np.random.default_rng(42).permutation(n)
    val_idx = set(perm[:val_size].tolist()) if val_size >= 2 else set()
    train_subset = _Subset(dataset, [i for i in range(n) if i not in val_idx])
    val_subset = _Subset(dataset, sorted(val_idx)) if val_idx else None

    batch_size = config.get("batch_size", 16)
    frame_batches = config.get("batch_size_type", "sample") == "frame"
    num_workers = config.get("num_workers", 4)
    collator = TTSCollator(pad_to_multiple=config.get("pad_to_multiple", 64),
                           n_mels=config.get("n_mels", 100))
    collator.pad_batch_to_multiple = max(
        1, config.get("batch_pad_multiple", 0) or (8 if frame_batches else 1))
    if frame_batches and train_subset.durations:
        sampler = DynamicBatchSampler(
            durations=train_subset.durations,
            frames_threshold=config.get("frames_threshold", 6000),
            max_samples=config.get("max_samples", 0),
            sample_rate=config.get("sample_rate", 24000),
            hop_length=config.get("hop_length", 256),
        )
    else:
        sampler = FixedBatchSampler(len(train_subset), batch_size)
    train_loader = DataLoader(train_subset, sampler, collator, num_workers=num_workers)
    val_loader = None
    if val_subset is not None:
        val_loader = DataLoader(
            val_subset,
            FixedBatchSampler(len(val_subset), batch_size, shuffle=False, drop_last=False),
            collator, num_workers=max(num_workers // 2, 1),
        )
    return train_loader, val_loader


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="Train OronTTS F5-TTS (PyTorch, one GPU)")
    parser.add_argument("--config", type=str, default="configs/runpod.yaml")
    parser.add_argument("--data-dir", type=str, default="data/processed")
    parser.add_argument("--from-local", action="store_true",
                        help="Use <data-dir>/metadata.json (the only data path so far)")
    parser.add_argument("--lang", type=str, default="mn", choices=["mn", "kz"])
    parser.add_argument("--log-dir", type=str, default="output/logs")
    parser.add_argument("--checkpoint-dir", type=str, default="output/checkpoints")
    parser.add_argument("--pretrain-ckpt", type=str, default=None,
                        help="Pretrained .npz checkpoint (either package's)")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--resume-best", action="store_true")
    parser.add_argument("--num-epochs", type=int, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    # accepted for flag parity with the JAX package; not ported yet
    parser.add_argument("--dataset", type=str, default=None)
    parser.add_argument("--push-to-hub", action="store_true")
    parser.add_argument("--hf-repo", type=str, default=None)
    parser.add_argument("--mesh", type=str, default=None)
    parser.add_argument("--multihost", action="store_true")
    args = parser.parse_args(argv)

    for flag, given in (("--dataset / the HuggingFace dataset path", args.dataset),
                        ("--push-to-hub", args.push_to_hub), ("--hf-repo", args.hf_repo),
                        ("--mesh", args.mesh), ("--multihost", args.multihost)):
        if given:
            parser.error(NOT_PORTED.format(flag=flag))
    if not args.from_local:
        parser.error(NOT_PORTED.format(flag="Loading a dataset from HuggingFace"))

    import torch

    from oron_tts_tpu_torch.config import F5Config, load_config
    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from oron_tts_tpu_torch.train.trainer import F5Trainer, TrainingPreempted
    from oron_tts_tpu_torch.utils.device import resolve_device
    from oron_tts_tpu_torch.utils.weights import load_npz_tree

    device = resolve_device(args.device)  # raises without CUDA unless --device cpu
    config = load_config(args.config)
    if args.num_epochs:
        config["num_epochs"] = args.num_epochs
    if config.get("gradient_checkpointing") == "auto":
        config["gradient_checkpointing"] = False

    dataset = build_dataset(args.data_dir, config, args.lang)
    print(f"Dataset size: {len(dataset)}")
    train_loader, val_loader = build_loaders(dataset, config)

    bf16 = config.get("mixed_precision", "bfloat16") == "bfloat16" and device.type == "cuda"
    model = F5TTS(F5Config.from_dict(config), device=device,
                  dtype=torch.bfloat16 if bf16 else torch.float32)
    model.init_params(0)
    print(f"Model parameters: {model.num_params():,}")

    trainer = F5Trainer(
        config=config, model=model, train_loader=train_loader, val_loader=val_loader,
        log_dir=args.log_dir, checkpoint_dir=args.checkpoint_dir,
    )
    if args.pretrain_ckpt:
        path = Path(args.pretrain_ckpt)
        if path.suffix != ".npz":
            parser.error("--pretrain-ckpt takes an .npz checkpoint; converting "
                         ".pt/.safetensors files is not ported yet (see ROADMAP.md)")
        trees = load_npz_tree(path)
        trainer.set_params(trees.get("ema") or trees.get("params") or trees)
        print(f"Loaded pretrained weights from {path}")
    if args.resume or args.resume_best:
        trainer.load_checkpoint(load_best=args.resume_best)

    num_epochs = args.num_epochs or config.get("num_epochs", 500)
    trainer.install_signal_handlers()  # SIGTERM → checkpoint, then TrainingPreempted
    try:
        trainer.train(num_epochs=num_epochs, save_interval=config.get("save_interval", 5))
    except TrainingPreempted as exc:
        print(f"[WARN] {exc} — resume with --resume")


if __name__ == "__main__":
    main()
