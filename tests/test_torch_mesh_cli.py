"""PyTorch port, ``cli.train`` and ``cli.infer`` under ``--mesh`` on CPU gloo ranks.

Two ranks run one ``cli.train --mesh 2x1`` epoch over clips of different
lengths (so a rank-local bucket would differ from its peer's: the
``GlobalBatchSchedule`` agrees them), with validation and a checkpoint,
each rank with its own log and checkpoint directory. Both ranks see the
same batch count, validation loss and best; only rank 0 writes TensorBoard
and a checkpoint; a fresh trainer on each rank, rank 1 with no file on its
disk, resumes rank 0's step, epoch, best and weights. The checkpoint loads
into the JAX package, whose eval loss on it equals the single-process port's.
``cli.infer --mesh 2x1`` writes its WAV on rank 0 only, equal to one process.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_mesh_common import rank_results, spawn, write_tiny_checkpoint
from test_torch_serve_load import one_thread  # noqa: F401 (autouse: tiny models)

REPO = Path(__file__).resolve().parents[1]


def _corpus(path: Path, n: int = 20) -> Path:
    """``n`` seeded sine clips of 0.6-1.55 s and their ``metadata.json``."""
    from oron_tts_tpu_torch.data.wav import write_wav

    path.mkdir(parents=True, exist_ok=True)
    records = []
    for i in range(n):
        t = np.arange(int(24000 * (0.6 + 0.05 * i))) / 24000
        wav = (0.4 * np.sin(2 * np.pi * (180 + 15 * i) * t)).astype(np.float32)
        write_wav(path / f"c{i}.wav", wav, 24000)
        records.append({"audio_path": str(path / f"c{i}.wav"), "text": "сайн байна уу",
                        "lang": "mn"})
    (path / "metadata.json").write_text(json.dumps(records))
    return path


def test_two_rank_cli_train_epoch_checkpoint_and_resume(tmp_path):
    import yaml

    cfg = yaml.safe_load((REPO / "configs" / "test.yaml").read_text())
    cfg["batch_size"] = 4
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    data = _corpus(tmp_path / "data")
    argv = ["--config", str(tmp_path / "cfg.yaml"), "--from-local", "--data-dir", str(data),
            "--device", "cpu", "--mesh", "2x1", "--num-epochs", "1"]
    spawn("cli_train", 2, tmp_path / "run", {"argv": argv}, timeout=200)
    r = rank_results(tmp_path / "run", 2)
    assert r[0]["n_train_batches"] == r[1]["n_train_batches"] == 5  # 18 clips / 4
    assert r[0]["global_step"] == r[1]["global_step"] == 5
    assert len(r[0]["val_loss"]) == 1 and r[0]["val_loss"] == r[1]["val_loss"]
    assert r[0]["val_loss"][0] > 0 and r[0]["best_val"] == r[1]["best_val"] == r[0]["val_loss"][0]
    # rank-0 exclusivity: one TensorBoard writer, one checkpoint writer
    assert r[0]["writer_active"] and not r[1]["writer_active"]
    assert r[0]["log_files"] and not r[1]["log_files"]
    assert r[0]["ckpt_files"] == ["f5tts_best.npz", "f5tts_step_00000005.npz"]
    assert r[1]["ckpt_files"] == []
    for i in range(2):  # rank 1 resumes what rank 0 wrote
        assert r[i]["resume_step"] == 5 and r[i]["resume_epoch"] == 1
        assert r[i]["resume_best_val"] == r[0]["best_val"]
        np.testing.assert_allclose(r[i]["resume_checksum"], r[0]["trained_checksum"],
                                   rtol=1e-12)

    # the JAX package reads the checkpoint; its eval loss is the port's
    from oron_tts_tpu.models import cfm as jcfm
    from oron_tts_tpu.models.dit import DiT as JDiT
    from oron_tts_tpu.train import checkpoint as jckpt
    from oron_tts_tpu_torch.models.f5tts import F5TTS

    trees, meta = jckpt.load_pytree_npz(tmp_path / "run" / "ckpt0" / "f5tts_step_00000005.npz")
    assert meta["step"] == 5 and meta["epoch"] == 1
    port = F5TTS.from_config(cfg, device="cpu")
    m = port.config.model
    jmodel = jcfm.CFM(JDiT(dim=m.dim, depth=m.depth, heads=m.heads, dim_head=m.dim_head,
                           ff_mult=m.ff_mult, text_dim=m.text_dim,
                           conv_layers=m.conv_layers, dropout=0.0))
    rng = np.random.default_rng(5)
    mel = rng.standard_normal((2, 100, 64)).astype(np.float32)
    ids = rng.integers(0, 65, (2, 64)).astype(np.int32)
    lens = np.array([64, 41], np.int32)
    x0 = rng.standard_normal((2, 64, 100)).astype(np.float32)
    j_loss = float(jmodel.loss({"params": jax.tree_util.tree_map(jnp.asarray, trees["params"])},
                               jnp.asarray(mel), jnp.asarray(ids), jnp.asarray(lens),
                               jax.random.PRNGKey(0), train=False, x0=jnp.asarray(x0)))
    port.load_params(jax.tree_util.tree_map(np.asarray, trees["params"]))
    with torch.no_grad():
        p_loss = port.cfm.loss(torch.from_numpy(mel), torch.from_numpy(ids),
                               torch.from_numpy(lens), train=False,
                               x0=torch.from_numpy(x0)).item()
    np.testing.assert_allclose(p_loss, j_loss, rtol=1e-5)


def test_cli_infer_mesh_writes_on_rank_0(tmp_path):
    from oron_tts_tpu_torch.cli import infer
    from oron_tts_tpu_torch.data.wav import read_wav

    ckpt, vocoder = write_tiny_checkpoint(tmp_path / "model")
    argv = ["--checkpoint", str(ckpt), "--vocoder", str(vocoder), "--device", "cpu",
            "--text", "сайн байна уу", "--steps", "2", "--seed", "1"]
    spawn("cli_infer", 2, tmp_path / "run", {"argv": argv + ["--mesh", "2x1"]})
    assert (tmp_path / "run" / "r0" / "out.wav").exists()
    assert not (tmp_path / "run" / "r1").exists()
    infer.main(argv + ["--output", str(tmp_path / "single.wav")])
    got, rate = read_wav(tmp_path / "run" / "r0" / "out.wav")
    want, _ = read_wav(tmp_path / "single.wav")
    assert rate == 24000 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-3)
    shutil.rmtree(tmp_path / "run")
