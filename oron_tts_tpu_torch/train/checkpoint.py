"""Checkpointing with the JAX package's on-disk contract (numpy only).

One ``.npz`` per checkpoint holding flattened trees (``params/…``,
``ema/…``, ``opt/…``) and a ``__meta__`` record, named
``f5tts_step_{step:08d}.npz`` with ``f5tts_best.npz`` and a ``config.json``
sidecar; ``max_checkpoints`` step files are kept. ``params`` and ``ema``
are written in the flax layout (``utils/weights.to_flax_params``), so
either package reads the other's parameters and EMA
(``oron_tts_tpu/train/checkpoint.py:100-142``).

The F5 trainer's optimizer tree is the port's own: ``opt/mu/<flax path>``
and ``opt/nu/<flax path>`` (the AdamW moments, laid out like the parameters)
and ``opt/count`` (the number of applied updates); it also reads the JAX
package's optax state. The vocoder trainer writes optax's nested state
itself (``train/vocoder.py`` ``OptaxAdamW.optax_state``), so the JAX
package resumes it.

``push_to_hub``/``pull_from_hub`` mirror a checkpoint directory to a
HuggingFace model repository. They import ``huggingface_hub`` when called
and need the network.

bf16 leaves (the first moment by default) are stored as uint16 and listed
under ``__bf16__`` in the meta record, as the JAX package stores them; on
load they come back widened to f32, which is exact.
"""

from __future__ import annotations

import json
import re
import threading
from collections.abc import Mapping
from pathlib import Path
from typing import Any, Callable

import numpy as np

_SEP = "/"


def flatten_tree(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    flat: dict[str, np.ndarray] = {}
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            key = f"{prefix}{_SEP}{k}" if prefix else str(k)
            flat.update(flatten_tree(v, key))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            key = f"{prefix}{_SEP}#{i}" if prefix else f"#{i}"
            flat.update(flatten_tree(v, key))
    else:
        flat[prefix] = np.asarray(tree)
    return flat


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> Any:
    root: dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def resolve(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            items = sorted(node.items(), key=lambda kv: int(kv[0][1:]))
            return [resolve(v) for _, v in items]
        return {k: resolve(v) for k, v in node.items()}

    return resolve(root)


def _widen_bf16(value: np.ndarray) -> np.ndarray:
    return (value.view(np.uint16).astype(np.uint32) << 16).view(np.float32)


def host_snapshot(
    trees: Mapping[str, Any],
    meta: Mapping[str, Any] | None = None,
    bf16_prefixes: tuple[str, ...] = (),
) -> dict[str, np.ndarray]:
    """Trees of host numpy leaves → the flat npz dict, with the meta record.

    Leaves under ``bf16_prefixes`` hold bf16-representable f32 values and
    are stored as their upper 16 bits.
    """
    flat: dict[str, np.ndarray] = {}
    for name, tree in trees.items():
        if tree is not None:
            flat.update(flatten_tree(tree, name))
    bf16_keys = [k for k in flat if k.startswith(bf16_prefixes)] if bf16_prefixes else []
    for key in bf16_keys:
        bits = np.ascontiguousarray(flat[key], dtype=np.float32).view(np.uint32)
        flat[key] = (bits >> 16).astype(np.uint16)
    full_meta = dict(meta or {})
    if bf16_keys:
        full_meta["__bf16__"] = bf16_keys
    if full_meta:
        flat["__meta__"] = np.frombuffer(json.dumps(full_meta).encode(), dtype=np.uint8)
    return flat


def write_npz(path: str | Path, flat: Mapping[str, np.ndarray]) -> None:
    """Atomic npz write (temporary file + rename)."""
    tmp = Path(path).with_name(".tmp-" + Path(path).name)
    np.savez(tmp, **flat)
    tmp.replace(path)


def save_pytree_npz(path: str | Path, trees: Mapping[str, Any],
                    meta: Mapping[str, Any] | None = None) -> None:
    """trees: name → tree of host numpy leaves, e.g. {"params": ...}."""
    write_npz(path, host_snapshot(trees, meta))


def load_pytree_npz(path: str | Path) -> tuple[dict[str, Any], dict[str, Any]]:
    """Returns ({name: tree}, meta); bf16 leaves widened to f32."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    meta: dict[str, Any] = {}
    raw_meta = flat.pop("__meta__", None)
    if raw_meta is not None:
        meta = json.loads(raw_meta.tobytes().decode())
    bf16 = set(meta.pop("__bf16__", []))
    groups: dict[str, dict[str, np.ndarray]] = {}
    for key, value in flat.items():
        if key in bf16 or (value.dtype.kind == "V" and value.dtype.itemsize == 2):
            value = _widen_bf16(value)
        name, _, rest = key.partition(_SEP)
        groups.setdefault(name, {})[rest] = value
    return {name: unflatten_tree(g) for name, g in groups.items()}, meta


def _is_step_checkpoint(name: str, model_name: str) -> bool:
    return re.fullmatch(rf"{re.escape(model_name)}_step_\d{{8}}\.npz", name) is not None


def stale_remote_checkpoint_paths(
    remote_paths: list[str], local_paths: list[str], model_name: str
) -> list[str]:
    """Remote step checkpoints no longer in the local rotation (for hub sync)."""
    local = {Path(p).name for p in local_paths if _is_step_checkpoint(Path(p).name, model_name)}
    return [p for p in remote_paths
            if _is_step_checkpoint(Path(p).name, model_name) and Path(p).name not in local]


class CheckpointManager:
    """Rotating checkpoints, optionally written on a background thread.

    With ``async_writes=True`` the snapshot the caller hands in is written
    and rotated on one writer thread; a second save joins the first, every
    read joins the writer, and a writer failure re-raises on the next
    ``save`` or ``wait``.
    """

    def __init__(
        self,
        checkpoint_dir: str | Path,
        model_name: str = "f5tts",
        max_checkpoints: int = 5,
        async_writes: bool = False,
    ) -> None:
        self.checkpoint_dir = Path(checkpoint_dir)
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
        self.model_name = model_name
        self.max_checkpoints = max_checkpoints
        self.async_writes = async_writes
        self._writer: threading.Thread | None = None
        self._writer_error: BaseException | None = None

    def wait(self) -> None:
        """Block until an in-flight write finishes; re-raise its error."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._writer_error is not None:
            err, self._writer_error = self._writer_error, None
            raise err

    def _run_write(self, fn: Callable[[], None]) -> None:
        if not self.async_writes:
            fn()
            return
        self.wait()

        def job() -> None:
            try:
                fn()
            except BaseException as exc:  # surfaced by the next wait()/save
                self._writer_error = exc

        # non-daemon: interpreter exit joins it, so no truncated file survives
        self._writer = threading.Thread(target=job, name="ckpt-writer", daemon=False)
        self._writer.start()

    def step_path(self, step: int) -> Path:
        return self.checkpoint_dir / f"{self.model_name}_step_{step:08d}.npz"

    def best_path(self) -> Path:
        return self.checkpoint_dir / f"{self.model_name}_best.npz"

    def config_path(self) -> Path:
        return self.checkpoint_dir / "config.json"

    def _snapshot(self, step, params, opt_state, ema_params, loss, config, extra_state):
        meta: dict[str, Any] = {"step": step, "loss": loss}
        if extra_state:
            meta.update(extra_state)
        bf16 = ()
        opt = opt_state
        if isinstance(opt_state, Mapping):
            bf16 = ("opt/mu",) if opt_state.get("mu_bf16") else ()
            opt = {k: v for k, v in opt_state.items() if k != "mu_bf16"}
        flat = host_snapshot({"params": params, "opt": opt, "ema": ema_params}, meta, bf16)
        if config is not None:
            self.config_path().write_text(json.dumps(dict(config), indent=2))
        return flat

    def save(
        self,
        step: int,
        params: Any,
        opt_state: dict[str, Any] | None = None,
        ema_params: Any = None,
        loss: float | None = None,
        config: Mapping[str, Any] | None = None,
        is_best: bool = False,
        extra_state: Mapping[str, Any] | None = None,
    ) -> Path:
        """Write the step file (and the best file), then rotate.

        ``params`` and ``ema_params`` are flax-layout trees of host numpy
        arrays; ``opt_state`` is ``{"mu", "nu", "count", "mu_bf16"}`` (the F5
        trainer's) or an optax state of nested tuples (the vocoder trainer's).
        """
        path = self.step_path(step)
        flat = self._snapshot(step, params, opt_state, ema_params, loss, config, extra_state)

        def write() -> None:
            write_npz(path, flat)
            if is_best:
                write_npz(self.best_path(), flat)
            self._rotate()

        self._run_write(write)
        return path

    def save_best(
        self,
        step: int,
        params: Any,
        opt_state: dict[str, Any] | None = None,
        ema_params: Any = None,
        loss: float | None = None,
        config: Mapping[str, Any] | None = None,
        extra_state: Mapping[str, Any] | None = None,
    ) -> Path:
        """Write only ``f5tts_best.npz`` (no step file, no rotation)."""
        flat = self._snapshot(step, params, opt_state, ema_params, loss, config, extra_state)
        self._run_write(lambda: write_npz(self.best_path(), flat))
        return self.best_path()

    def load(self, path: str | Path | None = None, load_best: bool = False) -> dict[str, Any]:
        """Returns {params, opt, ema, step, loss, ...}; a fresh dict if missing."""
        self.wait()
        if path is None:
            path = self.best_path() if load_best else self.latest_checkpoint()
        if path is None or not Path(path).exists():
            return {"step": 0, "loss": None, "params": None, "ema": None, "opt": None}
        trees, meta = load_pytree_npz(path)
        out: dict[str, Any] = {
            "params": trees.get("params"), "opt": trees.get("opt"), "ema": trees.get("ema"),
        }
        out.update(meta)
        out.setdefault("step", 0)
        return out

    def load_config(self) -> dict[str, Any] | None:
        if self.config_path().exists():
            return json.loads(self.config_path().read_text())
        return None

    def _step_checkpoints(self) -> list[Path]:
        out = [
            p for p in self.checkpoint_dir.glob(f"{self.model_name}_step_*.npz")
            if _is_step_checkpoint(p.name, self.model_name)
        ]
        return sorted(out, key=lambda p: int(p.stem.rsplit("_", 1)[-1]))

    def latest_checkpoint(self) -> Path | None:
        self.wait()
        ckpts = self._step_checkpoints()
        return ckpts[-1] if ckpts else None

    def _rotate(self) -> None:
        ckpts = self._step_checkpoints()
        while len(ckpts) > self.max_checkpoints:
            ckpts.pop(0).unlink()

    # ── hub mirroring ────────────────────────────────────────────────────

    def push_to_hub(self, repo_id: str, token: str | None = None, private: bool = False,
                    log_dir: str | Path | None = None) -> str:
        """Upload the directory (and a model card) to ``repo_id``, drop remote step
        files the local rotation no longer holds, then upload ``log_dir`` as
        ``tb_logs``. Joins an in-flight write first."""
        from huggingface_hub import HfApi

        self.wait()  # never upload a half-written rotation
        (self.checkpoint_dir / "README.md").write_text(self._model_card(), encoding="utf-8")
        api = HfApi()
        api.create_repo(repo_id=repo_id, token=token, private=private, exist_ok=True)
        api.upload_folder(folder_path=str(self.checkpoint_dir), repo_id=repo_id, token=token)
        self._cleanup_remote(api, repo_id, token)
        if log_dir is not None and any(p.is_file() for p in Path(log_dir).rglob("*")):
            api.upload_folder(folder_path=str(log_dir), repo_id=repo_id,
                              path_in_repo="tb_logs", token=token)
        return f"https://huggingface.co/{repo_id}"

    def _cleanup_remote(self, api: Any, repo_id: str, token: str | None) -> None:
        local = [p.name for p in self.checkpoint_dir.glob(f"{self.model_name}_step_*.npz")]
        info = api.model_info(repo_id=repo_id, token=token, files_metadata=False)
        remote = [s.rfilename for s in (info.siblings or [])]
        stale = stale_remote_checkpoint_paths(remote, local, self.model_name)
        if stale:
            api.delete_files(
                repo_id=repo_id, repo_type="model", delete_patterns=stale, token=token,
                commit_message=f"Remove {len(stale)} stale {self.model_name} checkpoints")

    def pull_from_hub(self, repo_id: str, filename: str = "f5tts_best.npz",
                      token: str | None = None) -> Path:
        from huggingface_hub import hf_hub_download

        return Path(hf_hub_download(repo_id=repo_id, filename=filename, token=token,
                                    local_dir=str(self.checkpoint_dir)))

    def _model_card(self) -> str:
        config = self.load_config() or {}
        m = config.get("model", {})
        return f"""---
language:
  - mn
  - kk
license: mit
tags:
  - tts
  - text-to-speech
  - mongolian
  - kazakh
  - flow-matching
  - f5-tts
  - pytorch
library_name: pytorch
pipeline_tag: text-to-speech
---

# OronTTS — F5-TTS for Mongolian & Kazakh (PyTorch)

Non-autoregressive TTS based on F5-TTS (flow matching + DiT). The
checkpoints are `.npz` files in the flax layout, which both the JAX and the
PyTorch package load.

| Parameter | Value |
|-----------|-------|
| dim | {m.get("dim", "?")} |
| depth | {m.get("depth", "?")} |
| heads | {m.get("heads", "?")} |
| vocab_size | {m.get("vocab_size", 65)} |
| sample_rate | {config.get("sample_rate", 24000)} Hz |
| mel_bins | {config.get("n_mels", 100)} |
"""
