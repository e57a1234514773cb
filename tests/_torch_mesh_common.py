"""Shared pieces of the port's mesh tests: tiny models and a gloo launcher.

Each multi-rank case runs ``tests/_torch_mesh_worker.py`` in 2 or 4 OS
processes on a free localhost port. The worker's process group times out
after 60 s and every process has a subprocess timeout, so a collective that
never completes fails its test instead of hanging the suite.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "_torch_mesh_worker.py"
PROC_TIMEOUT_S = 150

SERVE_TEXTS = [f"сайн байна уу та нар {i}" for i in range(8)]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_env() -> dict[str, str]:
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO), HF_DATASETS_OFFLINE="1")
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    return env


def spawn(case: str, world: int, out: Path, args: dict | None = None,
          timeout: float = PROC_TIMEOUT_S) -> list[str]:
    """Run ``case`` on ``world`` gloo ranks; returns each rank's output, failing on any error."""
    out.mkdir(parents=True, exist_ok=True)
    port = str(free_port())
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), case, str(r), str(world), port, str(out),
             json.dumps(args or {})],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=str(out),
            env=worker_env())
        for r in range(world)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {case} failed:\n{log[-4000:]}"
    return logs


def rank_results(out: Path, world: int) -> list[dict]:
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)]


def tiny_serving_model(mesh=None, quant: str | None = None):
    """Seeded tiny DiT (4 heads, dim 64) with a seeded one-layer Vocos, on the CPU."""
    import torch

    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from oron_tts_tpu_torch.models.vocos import VocosDecoder
    from oron_tts_tpu_torch.utils.weights import (
        from_flax_params,
        init_module_params,
        seeded_dit_params,
    )

    torch.manual_seed(0)
    cfg = {"sample_rate": 24000, "n_mels": 100,
           "model": {"vocab_size": 65, "dim": 64, "depth": 2, "heads": 4, "ff_mult": 2,
                     "text_dim": 32, "conv_layers": 1, "p_dropout": 0.0}}
    model = F5TTS.from_config(cfg, device="cpu")
    model.load_params(seeded_dit_params(model.config.model, seed=0))
    vocoder = VocosDecoder(n_mels=100, dim=32, n_layers=1, intermediate_dim=64)
    model.set_vocoder(vocoder, from_flax_params(init_module_params(vocoder, seed=1)))
    if quant:
        model.quantize_for_serving(quant)
    if mesh is not None:
        model.set_mesh(mesh)
    return model


def load_npz(path: Path) -> dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def http_post(port: int, path: str, payload: dict) -> tuple[int, bytes]:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def http_health(port: int) -> dict:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return json.loads(exc.read())


def write_tiny_checkpoint(path: Path) -> tuple[Path, Path]:
    """The tiny serving model's DiT as a checkpoint directory, its Vocos beside it.

    Returns (checkpoint dir, vocoder ``.npz``); each directory has its own
    ``config.json``.
    """
    from oron_tts_tpu_torch.train.checkpoint import flatten_tree, write_npz
    from oron_tts_tpu_torch.utils.weights import to_flax_params

    model = tiny_serving_model(None)
    ckpt, voc = path / "ckpt", path / "vocoder"
    ckpt.mkdir(parents=True, exist_ok=True)
    voc.mkdir(parents=True, exist_ok=True)
    params = to_flax_params({k: v.float() for k, v in model.backbone.state_dict().items()})
    write_npz(ckpt / "f5tts_step_00000001.npz", flatten_tree({"params": params}))
    (ckpt / "config.json").write_text(json.dumps({"model": {
        "vocab_size": 65, "dim": 64, "depth": 2, "heads": 4, "ff_mult": 2, "text_dim": 32,
        "conv_layers": 1, "p_dropout": 0.0}}))
    vparams = to_flax_params(model.vocoder.state_dict())
    write_npz(voc / "vocos.npz", flatten_tree({"params": vparams}))
    (voc / "config.json").write_text(json.dumps({"dim": 32, "n_layers": 1,
                                                  "intermediate_dim": 64}))
    return ckpt, voc / "vocos.npz"
