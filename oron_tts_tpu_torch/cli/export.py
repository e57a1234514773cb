"""Export a native checkpoint to the reference's torch formats.

    python -m oron_tts_tpu_torch.cli.export --checkpoint output/checkpoints \\
        --output f5tts_export.safetensors [--no-ema] [--format pt]

Counterpart of the JAX package's ``scripts/export.py``. It reads an ``.npz``
checkpoint (either package's) or the newest one in a checkpoint directory
and writes the DiT under the reference F5TTS's keys (``cfm.backbone.*``,
``utils/torch_compat.py``): ``.safetensors``, or a ``.pt`` holding
``{"ema_state_dict": ...}`` (EMA weights) or ``{"model_state_dict": ...}``
(raw weights, ``--no-ema``, or a checkpoint without EMA). The PyTorch
reference, the JAX package and ``cli.infer`` load either file.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv: list[str] | None = None) -> Path:
    parser = argparse.ArgumentParser(description="Export an OronTTS checkpoint to torch formats")
    parser.add_argument("--checkpoint", type=str, required=True,
                        help=".npz checkpoint file or checkpoint directory")
    parser.add_argument("--output", type=str, required=True,
                        help="Output path (.safetensors or .pt)")
    parser.add_argument("--format", choices=["safetensors", "pt"], default=None,
                        help="Defaults from the output extension")
    parser.add_argument("--no-ema", action="store_true", help="Export raw weights instead of EMA")
    args = parser.parse_args(argv)

    import torch

    from oron_tts_tpu_torch.train.checkpoint import CheckpointManager, load_pytree_npz
    from oron_tts_tpu_torch.utils.torch_compat import export_f5tts_state_dict, save_safetensors

    path = Path(args.checkpoint)
    if path.is_dir():
        cm = CheckpointManager(path)
        found = cm.latest_checkpoint() or (cm.best_path() if cm.best_path().exists() else None)
        if found is None:
            raise SystemExit(f"error: no checkpoint found in {path}")
        path = found
    trees, meta = load_pytree_npz(path)
    params = trees.get("params") if args.no_ema else (trees.get("ema") or trees.get("params"))
    if params is None:
        raise SystemExit(f"error: no params in {path}")
    which = "raw" if args.no_ema or trees.get("ema") is None else "EMA"
    print(f"Exporting {which} weights from {path} (step {meta.get('step', '?')})")

    sd = export_f5tts_state_dict(params)
    out = Path(args.output)
    fmt = args.format or ("pt" if out.suffix == ".pt" else "safetensors")
    out.parent.mkdir(parents=True, exist_ok=True)
    if fmt == "safetensors":
        save_safetensors(sd, out)
    else:
        torch.save({"ema_state_dict" if which == "EMA" else "model_state_dict":
                    {k: torch.from_numpy(v.copy()) for k, v in sd.items()}}, out)
    print(f"Saved {len(sd)} tensors to {out} ({fmt})")
    return out


if __name__ == "__main__":
    main()
