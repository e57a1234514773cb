"""Hub mirroring of checkpoints (``train/checkpoint.py``, ``F5Trainer``, ``cli.train``).

No network: a stand-in ``huggingface_hub`` in ``sys.modules`` records every
call and keeps a remote file list. Remote step files the local rotation
dropped are deleted (the same list as the JAX package's
``stale_remote_checkpoint_paths``), an upload joins an in-flight async write
first, ``pull_from_hub`` downloads into the checkpoint directory, the
trainer pushes every ``hub_upload_interval`` interval saves on the main
process and logs (does not raise) a failed upload, and ``cli.train``
accepts ``--push-to-hub``, ``--hf-repo``, ``--hub-private`` and
``--hub-upload-interval``.
"""

from __future__ import annotations

import json
import signal
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from oron_tts_tpu.train import checkpoint as jckpt
from oron_tts_tpu_torch.train import checkpoint as tckpt

REPO = Path(__file__).resolve().parents[1]


class StandInHub:
    """Records calls; the "remote" is a set of file names."""

    def __init__(self, remote: list[str] | None = None, fail: bool = False) -> None:
        self.calls: list[tuple] = []
        self.remote = set(remote or [])
        self.fail = fail
        self.seen_at_upload: list[list[str]] = []
        hub = self

        class HfApi:
            def create_repo(self, repo_id, token=None, private=False, exist_ok=False):
                hub.calls.append(("create_repo", repo_id, token, private, exist_ok))

            def upload_folder(self, folder_path, repo_id, token=None, path_in_repo=None):
                if hub.fail:
                    raise ConnectionError("no network")
                names = sorted(p.name for p in Path(folder_path).iterdir() if p.is_file())
                hub.seen_at_upload.append(names)
                hub.calls.append(("upload_folder", Path(folder_path).name, repo_id,
                                  path_in_repo))
                prefix = f"{path_in_repo}/" if path_in_repo else ""
                hub.remote |= {prefix + n for n in names}

            def model_info(self, repo_id, token=None, files_metadata=False):
                return types.SimpleNamespace(siblings=[
                    types.SimpleNamespace(rfilename=n) for n in sorted(hub.remote)])

            def delete_files(self, repo_id, repo_type, delete_patterns, token=None,
                             commit_message=""):
                hub.calls.append(("delete_files", repo_id, sorted(delete_patterns)))
                hub.remote -= set(delete_patterns)

        def hf_hub_download(repo_id, filename, token=None, local_dir=None):
            hub.calls.append(("hf_hub_download", repo_id, filename, token))
            path = Path(local_dir) / filename
            path.write_bytes(b"remote bytes")
            return str(path)

        self.module = types.ModuleType("huggingface_hub")
        self.module.HfApi = HfApi
        self.module.hf_hub_download = hf_hub_download


@pytest.fixture
def hub(monkeypatch):
    stand_in = StandInHub()
    monkeypatch.setitem(__import__("sys").modules, "huggingface_hub", stand_in.module)
    return stand_in


@pytest.mark.parametrize("remote,local", [
    (["f5tts_step_00000001.npz", "f5tts_step_00000002.npz", "f5tts_best.npz", "README.md",
      "vocos_step_00000001.npz", "tb_logs/x", "sub/f5tts_step_00000003.npz"],
     ["f5tts_step_00000002.npz", "f5tts_step_00000004.npz"]),
    (["vocos_step_00000010.npz", "vocos_disc_step_00000010.npz", "f5tts_step_1.npz"],
     ["vocos_step_00000020.npz"]),
    ([], []),
])
@pytest.mark.parametrize("model_name", ["f5tts", "vocos"])
def test_stale_remote_paths_match_jax(remote, local, model_name):
    got = tckpt.stale_remote_checkpoint_paths(remote, local, model_name)
    assert got == jckpt.stale_remote_checkpoint_paths(remote, local, model_name)


def _tree(seed):
    return {"block0": {"kernel": np.full((2, 3), seed, np.float32)}}


def test_push_uploads_and_drops_stale_remote_files(tmp_path, hub):
    hub.remote = {"f5tts_step_00000001.npz", "f5tts_step_00000002.npz", "other.bin"}
    cm = tckpt.CheckpointManager(tmp_path / "ckpt", max_checkpoints=2, async_writes=True)
    for step in (3, 4, 5):
        cm.save(step, _tree(step), config={"model": {"dim": 64, "depth": 2, "heads": 2}})
    logs = tmp_path / "logs"
    logs.mkdir()
    (logs / "events.out").write_text("x")
    url = cm.push_to_hub("org/oron", token="tok", private=True, log_dir=logs)
    assert url == "https://huggingface.co/org/oron"
    # the async write of step 5 and the rotation finished before the upload
    assert hub.seen_at_upload[0] == ["README.md", "config.json", "f5tts_step_00000004.npz",
                                     "f5tts_step_00000005.npz"]
    assert hub.calls[0] == ("create_repo", "org/oron", "tok", True, True)
    assert ("delete_files", "org/oron", ["f5tts_step_00000001.npz",
                                         "f5tts_step_00000002.npz"]) in hub.calls
    assert ("upload_folder", "logs", "org/oron", "tb_logs") in hub.calls
    assert hub.remote == {"README.md", "config.json", "f5tts_step_00000004.npz",
                          "f5tts_step_00000005.npz", "other.bin", "tb_logs/events.out"}
    card = (tmp_path / "ckpt" / "README.md").read_text()
    assert "| dim | 64 |" in card and "| depth | 2 |" in card and "pytorch" in card


def test_push_without_logs_or_stale_files(tmp_path, hub):
    cm = tckpt.CheckpointManager(tmp_path, model_name="vocos")
    cm.save(2, _tree(2))
    cm.push_to_hub("org/voc", log_dir=tmp_path / "no_logs")
    assert [c[0] for c in hub.calls] == ["create_repo", "upload_folder"]


def test_pull_downloads_into_the_checkpoint_dir(tmp_path, hub):
    cm = tckpt.CheckpointManager(tmp_path)
    path = cm.pull_from_hub("org/oron", token="tok")
    assert path == tmp_path / "f5tts_best.npz" and path.read_bytes() == b"remote bytes"
    assert hub.calls == [("hf_hub_download", "org/oron", "f5tts_best.npz", "tok")]


def _tiny_trainer(tmp_path, **hub_kw):
    from oron_tts_tpu_torch.config import F5Config
    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from oron_tts_tpu_torch.train.trainer import F5Trainer

    cfg = F5Config.from_dict({"model": {"dim": 32, "depth": 1, "heads": 2, "text_dim": 16,
                                        "ff_mult": 2, "conv_layers": 1}})
    model = F5TTS(cfg, device="cpu", dtype=torch.float32)
    return F5Trainer({"use_tqdm": False}, model, [None], log_dir=str(tmp_path / "logs"),
                     checkpoint_dir=str(tmp_path / "ckpt"), **hub_kw)


def test_trainer_pushes_every_interval_and_survives_a_failure(tmp_path, hub):
    trainer = _tiny_trainer(tmp_path, hub_repo_id="org/oron", hub_token="tok",
                            hub_private=True, hub_upload_interval=2)
    trainer.save_checkpoint(loss=1.0)
    for _ in range(4):
        trainer._maybe_push_to_hub()
    assert [c for c in hub.calls if c[0] == "create_repo"] == [
        ("create_repo", "org/oron", "tok", True, True)] * 2
    hub.fail = True
    trainer._upload_count = 1
    trainer._maybe_push_to_hub()  # logged, not raised
    trainer.finish()
    none = _tiny_trainer(tmp_path / "b")
    none._maybe_push_to_hub()
    assert none.hub_repo_id is None and none._upload_count == 0


def test_cli_train_accepts_the_hub_flags(tmp_path, hub):
    from oron_tts_tpu_torch.cli import train as cli_train
    from oron_tts_tpu_torch.data.wav import write_wav

    rng = np.random.default_rng(0)
    records = []
    for i in range(4):
        t = np.arange(int(24000 * rng.uniform(1.2, 1.8))) / 24000
        path = tmp_path / f"clip{i}.wav"
        write_wav(path, (0.3 * np.sin(2 * np.pi * 220 * (i + 1) * t)).astype(np.float32), 24000)
        records.append({"audio_path": str(path), "text": "сайн байна уу", "lang": "mn"})
    (tmp_path / "metadata.json").write_text(json.dumps(records))
    prev = signal.getsignal(signal.SIGTERM)
    try:
        cli_train.main(["--config", str(REPO / "configs" / "test.yaml"), "--from-local",
                        "--data-dir", str(tmp_path), "--device", "cpu", "--num-epochs", "2",
                        "--log-dir", str(tmp_path / "logs"), "--checkpoint-dir",
                        str(tmp_path / "ckpt"), "--push-to-hub", "--hf-repo", "org/tiny",
                        "--hf-token", "tok", "--hub-private", "--hub-upload-interval", "2"])
    finally:
        signal.signal(signal.SIGTERM, prev)
    # save_interval 1: two interval saves, one push at the second, one at the end
    assert [c for c in hub.calls if c[0] == "create_repo"] == [
        ("create_repo", "org/tiny", "tok", True, True)] * 2
    assert "f5tts_step_00000004.npz" in hub.remote


@pytest.mark.parametrize("flags", [["--hub-upload-interval", "0"]])
def test_cli_train_refuses_a_zero_upload_interval(flags, capsys):
    from oron_tts_tpu_torch.cli import train as cli_train

    with pytest.raises(SystemExit):
        cli_train.main(["--device", "cpu", "--push-to-hub", "--from-local"] + flags)
    assert "--hub-upload-interval must be >= 1" in capsys.readouterr().err
