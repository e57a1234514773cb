"""One rank of a CPU gloo mesh run for tests/test_torch_mesh*.py.

    python tests/_torch_mesh_worker.py <case> <rank> <world> <port> <out_dir> [json args]

Initialises the default process group itself (gloo on 127.0.0.1, a 60 s
timeout, so a collective that never completes fails the run instead of
hanging it), builds the mesh over it and runs one case; rank 0 (or every
rank, where the case says so) writes its results under ``out_dir``.
"""

from __future__ import annotations

import json
import os
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

torch.set_num_threads(1)

TINY = {
    "sample_rate": 24000, "n_mels": 100, "learning_rate": 1e-3, "warmup_steps": 2,
    "num_epochs": 1, "use_tqdm": False, "log_interval": 10**9,
    "audio_sample_interval": 10**9, "max_grad_norm": 1.0,
    "model": {"vocab_size": 65, "dim": 64, "depth": 2, "heads": 4, "ff_mult": 2,
              "text_dim": 16, "conv_layers": 1, "p_dropout": 0.0},
}
GLOBAL_B, T = 4, 64


def tiny_config(dropout: float = 0.0, backbone: str = "DiT", **extra) -> dict:
    """``TINY``; ``backbone="UNetT"`` makes it E2's (4 blocks, text at the mel width,
    RoPE on head 0)."""
    cfg = json.loads(json.dumps(TINY))
    cfg["model"]["p_dropout"] = dropout
    if backbone == "UNetT":
        for key in ("text_dim", "conv_layers"):
            cfg["model"].pop(key)
        cfg["model"].update(backbone="UNetT", depth=4, pe_attn_head=1, text_mask_padding=False)
    cfg.update(extra)
    return cfg


def global_batch(seed: int = 3) -> dict[str, np.ndarray]:
    """A batch whose rows hold different span counts (lengths 64, 37, 50, 23),
    and the eval noise ``x0`` [B, T, n_mels] that the JAX comparison injects."""
    rng = np.random.default_rng(seed)
    return {
        "mel": rng.standard_normal((GLOBAL_B, 100, T)).astype(np.float32),
        "text_ids": rng.integers(0, 65, (GLOBAL_B, T)).astype(np.int32),
        "mel_lengths": np.array([64, 37, 50, 23], np.int32),
        "x0": rng.standard_normal((GLOBAL_B, T, 100)).astype(np.float32),
    }


def rows_of(batch: dict, sl: slice) -> dict:
    return {k: v[sl] for k, v in batch.items()}


class _NoLoader:
    dataset: list = []

    def __len__(self) -> int:
        return 1

    def __iter__(self):
        return iter(())


def train_two_steps(mesh, cfg: dict, tmp: str, resume: bool = False) -> dict:
    """Two ``F5Trainer.train_step`` calls on this rank's rows; whole trees after.

    With ``resume`` the state is saved (rank 0 writes, in its own
    directory) and a fresh trainer on every rank loads it: ``resume_equal``
    says whether its gathered trees are the saved ones, bit for bit.
    """
    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from oron_tts_tpu_torch.parallel.mesh import batch_rows
    from oron_tts_tpu_torch.train.trainer import F5Trainer
    from oron_tts_tpu_torch.utils.weights import seeded_dit_params

    model = F5TTS.from_config(cfg, device="cpu")
    if model.config.model.backbone == "DiT":
        model.load_params(seeded_dit_params(model.config.model, seed=0))
    else:  # seeded, so every rank draws the same tree
        model.init_params(0)
    trainer = F5Trainer(cfg, model, _NoLoader(), log_dir=f"{tmp}/logs",
                        checkpoint_dir=f"{tmp}/ckpt", mesh=mesh)
    batch = global_batch()
    local = rows_of(batch, batch_rows(mesh, GLOBAL_B))
    with torch.no_grad():
        eval_loss = model.cfm.loss(
            torch.from_numpy(local["mel"]), torch.from_numpy(local["text_ids"]),
            torch.from_numpy(local["mel_lengths"]), train=False,
            x0=torch.from_numpy(local["x0"])).item()
    generator = torch.Generator().manual_seed(11)
    metrics = [trainer.train_step(local, generator) for _ in range(2)]
    from oron_tts_tpu_torch.train.checkpoint import flatten_tree

    trees = trainer._checkpoint_trees(None)  # gathers under a mesh
    flat = {f"params/{k}": v for k, v in flatten_tree(trees["params"]).items()}
    flat.update({f"mu/{k}": np.asarray(v, np.float32)
                 for k, v in flatten_tree(trees["opt_state"]["mu"]).items()})
    flat.update({f"nu/{k}": v for k, v in flatten_tree(trees["opt_state"]["nu"]).items()})
    st = trainer.state
    resume_equal = None
    if resume:
        trainer.save_checkpoint(loss=1.0)
        trainer.checkpoint_manager.wait()
        fresh_model = F5TTS.from_config(cfg, device="cpu")
        fresh = F5Trainer(cfg, fresh_model, _NoLoader(), log_dir=f"{tmp}/logs2",
                          checkpoint_dir=f"{tmp}/ckpt", mesh=mesh)
        fresh.load_checkpoint()
        again = fresh._checkpoint_trees(None)
        resume_equal = fresh.global_step == 2 and all(
            np.array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))
            for part in ("params", "ema_params")
            for a, b in zip(flatten_tree(trees[part]).values(),
                            flatten_tree(again[part]).values())) and all(
            np.array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))
            for m in ("mu", "nu")
            for a, b in zip(flatten_tree(trees["opt_state"][m]).values(),
                            flatten_tree(again["opt_state"][m]).values()))
    return {
        "resume_equal": resume_equal,
        "eval_loss": eval_loss,
        "loss": [m["loss"] for m in metrics], "grad_norm": [m["grad_norm"] for m in metrics],
        "ok": [m["ok"] for m in metrics], "flat": flat,
        "moment_numel": int(sum(t.numel() for t in st.mu)),
        "split_moment_numel": int(sum(t.numel() for t, a in zip(st.mu, trainer.zero_axes)
                                      if a is not None)),
        "param_numel": int(sum(t.numel() for t in st.params)),
        "zero_axes": trainer.zero_axes,
    }


def case_train(mesh, out: Path, args: dict) -> None:
    """Each of ``args["runs"]`` (dropout, zero, resume, bucket): two steps; rank 0
    writes trees_<j>.npz."""
    from oron_tts_tpu_torch.train import trainer as trainer_mod

    results = []
    default_bucket = trainer_mod.GRAD_BUCKET_ELEMENTS
    for j, run in enumerate(args["runs"]):
        # a small bucket splits the gradient collectives into many flat buffers
        trainer_mod.GRAD_BUCKET_ELEMENTS = run.get("bucket", default_bucket)
        cfg = tiny_config(run.get("dropout", 0.0), run.get("backbone", "DiT"),
                          shard_opt_states=run.get("zero", False))
        res = train_two_steps(mesh, cfg, str(out / f"r{mesh.rank}_{j}"),
                              resume=run.get("resume", False))
        flat = res.pop("flat")
        if mesh.is_main:
            np.savez(out / f"trees_{j}.npz", **flat)
        results.append(res)
    (out / f"rank{mesh.rank}.json").write_text(json.dumps(results))


def case_serve(mesh, out: Path, args: dict) -> None:
    from _torch_mesh_common import SERVE_TEXTS, tiny_serving_model

    model = tiny_serving_model(mesh)
    wavs = model.synthesize_batch(SERVE_TEXTS, n_steps=2, seed=0)
    one = model.synthesize("сайн байна уу", n_steps=2, seed=0)
    refused = ""
    try:
        model.quantize_for_serving("int8")
    except NotImplementedError as exc:
        refused = str(exc)
    model.quantize_for_serving("int8_dynamic")
    dyn = model.synthesize_batch(SERVE_TEXTS[:4], n_steps=2, seed=0)
    set_mesh_refused = ""
    plain = tiny_serving_model(None)
    plain.quantize_for_serving("int8")
    try:
        plain.set_mesh(mesh)
    except NotImplementedError as exc:
        set_mesh_refused = str(exc)
    if mesh.is_main:
        np.savez(out / "serve.npz", **{f"w{i}": w for i, w in enumerate(wavs)}, one=one,
                 **{f"d{i}": w for i, w in enumerate(dyn)})
    (out / f"rank{mesh.rank}.json").write_text(json.dumps({
        "int8_refused": refused, "set_mesh_refused": set_mesh_refused,
        "n": len(wavs), "heads": model.backbone.local_heads}))


def checksum(tensors) -> float:
    return float(sum(t.detach().abs().double().sum() for t in tensors))


def case_cli_train(rank: int, out: Path, args: dict) -> None:
    """One ``cli.train`` epoch under ``--mesh``, then a fresh trainer resumes.

    Each rank has its own log and checkpoint directory, so what rank 1 finds
    on disk is nothing; the resume must come from rank 0's broadcast.
    """
    from oron_tts_tpu_torch.cli import train as cli_train
    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from oron_tts_tpu_torch.train import trainer as trainer_mod

    seen: dict = {}
    validate = trainer_mod.F5Trainer.validate
    init = trainer_mod.F5Trainer.__init__

    def spy_init(self, *a, **k):
        init(self, *a, **k)
        seen.setdefault("trainer", self)
        seen["writer"] = self.writer is not None

    def spy_validate(self, *a, **k):
        val = validate(self, *a, **k)
        seen.setdefault("val", []).append(val)
        return val

    trainer_mod.F5Trainer.__init__ = spy_init
    trainer_mod.F5Trainer.validate = spy_validate
    ckpt, logs = out / f"ckpt{rank}", out / f"logs{rank}"
    cli_train.main(args["argv"] + ["--log-dir", str(logs), "--checkpoint-dir", str(ckpt)])
    trainer = seen["trainer"]
    trainer_mod.F5Trainer.__init__ = init
    model = F5TTS.from_config(trainer.config, device="cpu")
    fresh = trainer_mod.F5Trainer(trainer.config, model, trainer.train_loader,
                                  log_dir=str(out / f"logs2_{rank}"),
                                  checkpoint_dir=str(ckpt), mesh=trainer.mesh)
    fresh.load_checkpoint()
    (out / f"rank{rank}.json").write_text(json.dumps({
        "val_loss": seen["val"], "best_val": trainer._best_val,
        "global_step": trainer.global_step, "n_train_batches": len(trainer.train_loader),
        "writer_active": seen["writer"],
        "log_files": sorted(p.name for p in logs.glob("*")) if logs.exists() else [],
        "ckpt_files": sorted(p.name for p in ckpt.glob("*.npz")) if ckpt.exists() else [],
        "resume_step": fresh.global_step, "resume_epoch": fresh.epoch,
        "resume_best_val": fresh._best_val,
        "resume_checksum": checksum(fresh.state.params),
        "trained_checksum": checksum(trainer.state.params),
    }))


def case_cli_serve(rank: int, out: Path, args: dict) -> None:
    """``cli.serve`` under ``--mesh``: rank 0 answers requests, rank 1 follows."""
    import threading
    import time
    from concurrent.futures import ThreadPoolExecutor

    from oron_tts_tpu_torch.cli import serve
    from oron_tts_tpu_torch.data.wav import read_wav_bytes

    server = serve.create_server(args["argv"])
    if server is None:  # the follower: returned after rank 0's stop command
        (out / f"rank{rank}.json").write_text(json.dumps({"follower": True}))
        return
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    from _torch_mesh_common import http_health, http_post

    health = http_health(port)
    code, one = http_post(port, "/synthesize", {"text": "сайн байна уу", "steps": 2,
                                                "seed": 3})
    texts = [f"сайн байна уу {i}" for i in range(8)]
    batcher = server.service.batcher
    submitted = []
    submit = batcher.submit

    def counted(*a, **k):
        submitted.append(1)
        return submit(*a, **k)

    batcher.submit = counted
    with ThreadPoolExecutor(8) as pool:
        # a busy device (the model lock held) while all eight arrive: the
        # dispatcher holds one batch and the rest queue, so at least two merge
        with server.service.model_lock:
            futures = [pool.submit(http_post, port, "/synthesize",
                                   {"text": texts[i], "steps": 2, "seed": 10 + i})
                       for i in range(8)]
            for _ in range(600):
                if len(submitted) == 8:
                    break
                time.sleep(0.05)
            time.sleep(0.1)  # the last arrival reaches its queue
        burst = [f.result() for f in futures]
    after = http_health(port)
    serve.begin_drain(server)
    thread.join(timeout=60)
    serve.close_server(server)
    answers = [(code, one)] + burst
    errors = [b.decode(errors="replace") for c, b in answers if c != 200]
    if not errors:
        wavs = {f"b{i}": read_wav_bytes(b)[0] for i, (_, b) in enumerate(burst)}
        np.savez(out / "serve_cli.npz", one=read_wav_bytes(one)[0], **wavs)
    (out / f"rank{rank}.json").write_text(json.dumps({
        "health": health, "after": after, "codes": [c for c, _ in answers],
        "errors": errors}))


def case_cli_infer(rank: int, out: Path, args: dict) -> None:
    from oron_tts_tpu_torch.cli import infer

    infer.main(args["argv"] + ["--output", str(out / f"r{rank}" / "out.wav")])
    (out / f"rank{rank}.json").write_text(json.dumps({"done": True}))


def main() -> int:
    case, rank, world, port, out = sys.argv[1:6]
    args = json.loads(sys.argv[6]) if len(sys.argv) > 6 else {}
    rank, world = int(rank), int(world)
    out = Path(out)
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": "0",
                       "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port,
                       "LOCAL_WORLD_SIZE": str(world)})
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    try:
        if case.startswith("cli"):
            {"cli_train": case_cli_train, "cli_serve": case_cli_serve,
             "cli_infer": case_cli_infer}[case](rank, out, args)
        else:
            from oron_tts_tpu_torch.parallel.mesh import make_mesh

            mesh = make_mesh(args["dp"], args["tp"], device="cpu")
            {"train": case_train, "serve": case_serve}[case](mesh, out, args)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
