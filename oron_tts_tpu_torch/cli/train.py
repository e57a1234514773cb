"""Training CLI of the PyTorch port (local or HuggingFace data, one GPU or a mesh).

    python -m oron_tts_tpu_torch.cli.train --config configs/test.yaml \\
        --from-local --data-dir data/processed [--device cpu]

    python -m oron_tts_tpu_torch.cli.train --config configs/runpod.yaml \\
        --dataset btsee/mbspeech_mn [--split train --text-column sentence_norm]

    python -m torch.distributed.run --nproc-per-node 4 \\
        -m oron_tts_tpu_torch.cli.train --config configs/runpod.yaml --mesh 2x2

    python -m oron_tts_tpu_torch.cli.train --config configs/e2_base.yaml \\
        --from-local --data-dir data/processed

Counterpart of the JAX package's ``cli/train.py``: ``--from-local`` data (a
``metadata.json`` of ``audio_path``/``text`` records) or a HuggingFace
dataset (``--dataset``, ingested by ``TTSDataset.from_hf_dataset``, which
needs the ``datasets`` library and the network). It runs on the card unless
``--device cpu`` is given. ``gradient_checkpointing: auto`` is decided by the
memory estimate of ``utils/memory.py`` for the worst padded batch the
collator can build, against the card's memory (the host's with ``--device
cpu``), for the backbone the config names (``model.backbone``, counted as
its class counts itself). ``--pretrain-ckpt`` takes an ``.npz`` checkpoint
(either package's) or, for a backbone with the reference's torch layout
(``Backbone.torch_layout``), its ``.pt`` or ``.safetensors`` file, whose
tensors of another shape (an official checkpoint's text embedding) keep
their fresh values and are printed. ``--push-to-hub`` mirrors the checkpoint directory
to ``--hf-repo`` every ``--hub-upload-interval`` interval saves and once at
the end (``huggingface_hub`` and the network; the token from ``--hf-token``
or ``HF_TOKEN``).

``--mesh DPxTP`` trains on a ``("data", "model")`` mesh (``parallel/mesh.py``),
one process per rank under ``torchrun``; a mesh whose size is not the
world's raises and names the command. Under ``torchrun`` without ``--mesh``
every rank is a data rank. In a world of more than one process the batches
come from ``GlobalBatchSchedule`` (train and validation): each data rank
loads its rows of every global batch at the globally agreed shape, and frame
batches pad their rows to a multiple of ``lcm(8, DP)``. ``--multihost`` takes
the ``torchrun --nnodes`` environment (it raises without it) and prints each
process's place; ``--num-gpus`` is accepted and ignored, as in the JAX
package: the world's size comes from ``torchrun``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
from pathlib import Path

from oron_tts_tpu_torch.cli import mesh_or_exit


def resolve_hf_token(token: str | None = None) -> str | None:
    return (token or os.getenv("HF_TOKEN") or os.getenv("HUGGING_FACE_HUB_TOKEN")
            or os.getenv("HUGGINGFACE_HUB_TOKEN"))


def _metadata_attr_tokens(value: object) -> list[str]:
    if isinstance(value, list):
        return [str(t) for t in value]
    if isinstance(value, str) and value.strip():
        return [value.strip()]
    return []


def build_hf_dataset(args, config: dict):
    """``TTSDataset`` over a HuggingFace dataset's raw audio bytes (``--dataset``)."""
    from oron_tts_tpu_torch.data.dataset import TTSDataset
    from oron_tts_tpu_torch.data.hf import HFDatasetWrapper

    sample_rate = config.get("sample_rate", 24000)
    print(f"Loading dataset from HuggingFace: {args.dataset}")
    wrapper = HFDatasetWrapper(args.dataset, dataset_config=args.dataset_config,
                               cache_dir=args.cache_dir, sample_rate=sample_rate)
    return TTSDataset.from_hf_dataset(
        wrapper.load(split=args.split), audio_column=args.audio_column,
        text_column=args.text_column, lang_column=args.lang_column,
        gender_column=args.gender_column, age_column=args.age_column,
        sample_rate=sample_rate, n_mels=config.get("n_mels", 100), default_lang=args.lang,
        cache_bytes=int(config.get("dataset_cache_bytes", 2 << 30)),
    )


def auto_remat_frames(config: dict) -> int:
    """Padded frames of the worst batch ``build_loaders`` can produce (one card)."""
    from oron_tts_tpu_torch.data.dataset import frames_for_duration
    from oron_tts_tpu_torch.utils.memory import worst_case_padded_frames

    collator = make_collator(config)
    sample_rate = config.get("sample_rate", 24000)
    hop_length = config.get("hop_length", 256)
    t_multiple = collator.pad_to_multiple
    max_clip = frames_for_duration(config.get("max_duration_s", 30.0), sample_rate, hop_length)
    if config.get("batch_size_type", "sample") == "frame":
        return worst_case_padded_frames(
            int(config.get("frames_threshold", 6000)), max_clip,
            row_multiple=collator.pad_batch_to_multiple, t_multiple=t_multiple,
            max_samples=int(config.get("max_samples", 0)),
            min_clip_frames=frames_for_duration(
                config.get("min_duration_s", 1.0), sample_rate, hop_length),
        )
    rows = config.get("batch_size", 16)
    rows = -(-rows // collator.pad_batch_to_multiple) * collator.pad_batch_to_multiple
    return rows * (-(-max_clip // t_multiple) * t_multiple)


def decide_gradient_checkpointing(config: dict, device) -> bool:
    """``gradient_checkpointing: auto`` → the estimate's choice, printed."""
    from oron_tts_tpu_torch.models.f5tts import config_activation_depth, config_param_count
    from oron_tts_tpu_torch.utils.memory import (
        auto_gradient_checkpointing,
        device_memory_bytes,
        host_memory_bytes,
    )

    frames = auto_remat_frames(config)
    budget = device_memory_bytes(device) if device.type == "cuda" else host_memory_bytes()
    bf16 = config.get("mixed_precision", "bfloat16") == "bfloat16" and device.type == "cuda"
    remat = auto_gradient_checkpointing(config, frames, config_param_count(config),
                                        device_bytes=budget, bf16_compute=bf16,
                                        act_depth=config_activation_depth(config))
    print(f"gradient_checkpointing=auto -> {remat} ({frames} frames)")
    return remat


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


def make_collator(config: dict, n_data: int = 1):
    """The collator ``build_loaders`` pads batches with, as the JAX package's CLI sets it:
    frame batches pad their rows to a multiple of ``lcm(8, n_data)``."""
    from oron_tts_tpu_torch.data.dataset import TTSCollator

    frame_batches = config.get("batch_size_type", "sample") == "frame"
    return TTSCollator(
        pad_to_multiple=config.get("pad_to_multiple", 64), n_mels=config.get("n_mels", 100),
        pad_batch_to_multiple=config.get("batch_pad_multiple", 0)
        or math.lcm(8 if frame_batches else 1, n_data))


def global_schedules(train_subset, val_subset, config: dict, mesh):
    """``GlobalBatchSchedule`` for train and validation: this data rank's rows."""
    from oron_tts_tpu_torch.data.dataset import GlobalBatchSchedule, frames_for_duration

    sample_rate = config.get("sample_rate", 24000)
    hop_length = config.get("hop_length", 256)

    def est_frames(subset):
        return [frames_for_duration(d, sample_rate, hop_length) for d in subset.durations]

    if not train_subset.durations:
        raise SystemExit("a mesh run needs per-sample durations for the global batch "
                         "schedule (metadata.json audio must be readable WAV, or use an "
                         "HF dataset)")
    common = dict(num_hosts=mesh.n_data, host_id=mesh.data_rank,
                  pad_to_multiple=config.get("pad_to_multiple", 64),
                  rows_multiple_per_host=1, seed=config.get("seed", 0))
    batch_size = config.get("batch_size", 16)
    if config.get("batch_size_type", "sample") == "frame":
        sampler = GlobalBatchSchedule(
            est_frames(train_subset), frames_threshold=config.get("frames_threshold", 6000),
            max_samples=config.get("max_samples", 0), **common)
    else:
        sampler = GlobalBatchSchedule(est_frames(train_subset), batch_size=batch_size, **common)
    val_sampler = (GlobalBatchSchedule(est_frames(val_subset), batch_size=batch_size,
                                       shuffle=False, **common)
                   if val_subset is not None else None)
    return sampler, val_sampler


def build_loaders(dataset, config: dict, mesh=None):
    """Seeded 90/10 split, samplers and loaders, as the JAX package's CLI.

    Under a mesh of more than one process both splits stay global and
    ``GlobalBatchSchedule`` hands each data rank its rows.
    """
    import numpy as np

    from oron_tts_tpu_torch.data.dataset import DynamicBatchSampler, FixedBatchSampler
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
    collator = make_collator(config, 1 if mesh is None else mesh.n_data)
    if mesh is not None and mesh.world > 1:
        sampler, val_sampler = global_schedules(train_subset, val_subset, config, mesh)
        return (DataLoader(train_subset, sampler, collator, num_workers=num_workers),
                DataLoader(val_subset, val_sampler, collator,
                           num_workers=max(num_workers // 2, 1))
                if val_sampler is not None else None)
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
    parser = argparse.ArgumentParser(description="Train OronTTS F5-TTS (PyTorch)")
    parser.add_argument("--config", type=str, default="configs/runpod.yaml")
    parser.add_argument("--data-dir", type=str, default="data/processed")
    parser.add_argument("--from-local", action="store_true",
                        help="Use <data-dir>/metadata.json instead of a HuggingFace dataset")
    parser.add_argument("--dataset", type=str, default="btsee/mbspeech_mn")
    parser.add_argument("--dataset-config", type=str, default=None,
                        help="Optional HF dataset config/subset")
    parser.add_argument("--split", type=str, default="train")
    parser.add_argument("--audio-column", type=str, default="audio")
    parser.add_argument("--text-column", type=str, default=None)
    parser.add_argument("--lang-column", type=str, default=None)
    parser.add_argument("--gender-column", type=str, default=None,
                        help="Metadata column mapped to [FEMALE]/[MALE]")
    parser.add_argument("--age-column", type=str, default=None,
                        help="Metadata column mapped to [YOUNG]/[MIDDLE]/[ELDERLY]")
    parser.add_argument("--cache-dir", type=str, default="output/data/cache")
    parser.add_argument("--lang", type=str, default="mn", choices=["mn", "kz"])
    parser.add_argument("--log-dir", type=str, default="output/logs")
    parser.add_argument("--checkpoint-dir", type=str, default="output/checkpoints")
    parser.add_argument("--pretrain-ckpt", type=str, default=None,
                        help="Pretrained .npz checkpoint (either package's) or a "
                             "reference .pt/.safetensors file")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--resume-best", action="store_true")
    parser.add_argument("--num-epochs", type=int, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--push-to-hub", action="store_true")
    parser.add_argument("--hf-repo", type=str, default="btsee/oron-tts")
    parser.add_argument("--hf-token", type=str, default=None)
    parser.add_argument("--hub-private", action="store_true")
    parser.add_argument("--hub-upload-interval", type=int, default=1)
    parser.add_argument("--mesh", type=str, default=None,
                        help="Device mesh as DPxTP (e.g. 4x1, 2x2), one process per rank "
                             "under torchrun")
    parser.add_argument("--multihost", action="store_true",
                        help="Join a multi-node run from the torchrun --nnodes environment")
    parser.add_argument("--num-gpus", type=int, default=None,
                        help="(compat) accepted and ignored; torchrun sets the world")
    args = parser.parse_args(argv)
    args.hf_token = resolve_hf_token(args.hf_token)
    if args.hub_upload_interval < 1:
        parser.error("--hub-upload-interval must be >= 1")
    if args.num_gpus is not None:
        print(f"--num-gpus {args.num_gpus} is ignored: launch one process per GPU with "
              f"python -m torch.distributed.run --nproc-per-node N and pass --mesh DPxTP")

    import torch
    import torch.distributed as dist

    from oron_tts_tpu_torch.parallel import mesh as pmesh

    if args.multihost:
        if "RANK" not in os.environ or "MASTER_ADDR" not in os.environ:
            parser.error("--multihost needs the torchrun environment: python -m "
                         "torch.distributed.run --nnodes N --nproc-per-node G "
                         "--rdzv-endpoint HOST:PORT -m oron_tts_tpu_torch.cli.train ... "
                         "--multihost")
        pmesh.init_from_env(pmesh.local_device(args.device))
        local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
        print(f"Process {dist.get_rank()}/{dist.get_world_size()}, {local} local devices")
    # mesh before loaders: the data size fixes the row multiple and the schedule
    mesh = None
    if args.mesh:
        mesh = mesh_or_exit(parser, args.mesh, args.device)
    elif pmesh._env_world() > 1 or dist.is_initialized():
        mesh = pmesh.make_mesh(None, 1, device=args.device)
    if mesh is not None:
        print(f"Device mesh: {mesh.shape} (rank {mesh.rank} of {mesh.world}, {mesh.device})")

    from oron_tts_tpu_torch.config import F5Config, load_config
    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from oron_tts_tpu_torch.train.trainer import F5Trainer, TrainingPreempted
    from oron_tts_tpu_torch.utils.device import resolve_device
    from oron_tts_tpu_torch.utils.weights import load_npz_tree

    # raises without CUDA unless --device cpu; a mesh rank runs on cuda:LOCAL_RANK
    device = mesh.device if mesh is not None else resolve_device(args.device)
    config = load_config(args.config)
    if args.num_epochs:
        config["num_epochs"] = args.num_epochs

    dataset = (build_dataset(args.data_dir, config, args.lang) if args.from_local
               else build_hf_dataset(args, config))
    print(f"Dataset size: {len(dataset)}")
    # calibrate the ref-free duration from the corpus; the table rides the
    # config into config.json beside every checkpoint (data/duration_stats.py)
    if dataset.durations and dataset.texts:
        from oron_tts_tpu_torch.data.duration_stats import stats_from_texts

        stats = stats_from_texts(
            dataset.texts, dataset.langs, dataset.durations,
            config.get("sample_rate", 24000), config.get("hop_length", 256),
        )
        if stats is not None:
            config["duration_stats"] = stats
            print(f"Duration calibration: global "
                  f"{stats['global']:.2f} frames/token over {stats['n']} clips")
    train_loader, val_loader = build_loaders(dataset, config, mesh)
    if config.get("gradient_checkpointing") == "auto":
        config["gradient_checkpointing"] = decide_gradient_checkpointing(config, device)

    bf16 = config.get("mixed_precision", "bfloat16") == "bfloat16" and device.type == "cuda"
    model = F5TTS(F5Config.from_dict(config), device=device,
                  dtype=torch.bfloat16 if bf16 else torch.float32)
    model.init_params(0)
    print(f"Model parameters: {model.num_params():,}")

    trainer = F5Trainer(
        config=config, model=model, train_loader=train_loader, val_loader=val_loader,
        log_dir=args.log_dir, checkpoint_dir=args.checkpoint_dir,
        hub_repo_id=args.hf_repo if args.push_to_hub else None, hub_token=args.hf_token,
        hub_private=args.hub_private, hub_upload_interval=args.hub_upload_interval,
        mesh=mesh,
    )
    if args.pretrain_ckpt:
        path = Path(args.pretrain_ckpt)
        if path.suffix != ".npz" and not model.backbone.torch_layout:
            raise SystemExit(f"--pretrain-ckpt {path.name}: a {model.config.model.backbone} "
                             f"takes an .npz checkpoint (the torch layout is another backbone's)")
        if path.suffix == ".npz":
            trees = load_npz_tree(path)
            trainer.set_params(trees.get("ema") or trees.get("params") or trees)
        else:
            from oron_tts_tpu_torch.utils.torch_compat import (
                convert_f5tts_state_dict,
                load_torch_checkpoint,
                merge_compatible,
            )

            m = model.config.model
            converted = convert_f5tts_state_dict(
                load_torch_checkpoint(path), depth=m.depth, conv_layers=m.conv_layers)
            # non-strict: a leaf of another shape (an official F5-TTS text
            # embedding against the 65-token vocabulary) keeps its fresh init
            merged, skipped = merge_compatible(
                trainer._flax_tree(trainer.state.params), converted)  # whole under a mesh
            trainer.set_params(merged)
            if skipped:
                print(f"[WARN] Shape-skipped pretrained keys (first 5): {skipped[:5]}")
        print(f"Loaded pretrained weights from {path}")
    if args.resume or args.resume_best:
        trainer.load_checkpoint(load_best=args.resume_best)

    num_epochs = args.num_epochs or config.get("num_epochs", 500)
    trainer.install_signal_handlers()  # SIGTERM → checkpoint, then TrainingPreempted
    completed = False
    try:
        trainer.train(num_epochs=num_epochs, save_interval=config.get("save_interval", 5))
        completed = True
    except TrainingPreempted as exc:
        print(f"[WARN] {exc} — resume with --resume")
    finally:
        if args.push_to_hub and trainer.is_main_process:
            try:
                url = trainer.push_to_hub(args.hf_repo, token=args.hf_token,
                                          private=args.hub_private)
                print(f"Model and logs pushed to: {url}")
            except Exception as exc:
                if completed:
                    raise
                print(f"[WARN] Final HF upload skipped after interrupted run: {exc}")


if __name__ == "__main__":
    main()
