"""``cli.train_vocoder`` on the CPU against the JAX package's ``scripts/train_vocoder.py``.

A width-32 Vocos on a seeded six-clip corpus, two steps a window. The
port's checkpoint decodes in both facades (within 1e-5 of the waveform's
largest value); a checkpoint either package writes resumes in the other
with its Adam moments and schedule position: two more steps from the same
checkpoint move the parameters by the same amount in both (the norms of
the two moves within 5% and their cosine above 0.95, where a restarted
schedule would move them ~100x less and zeroed moments by a different
direction), and the continued checkpoint counts 4 updates.
"""

from __future__ import annotations

import importlib.util
import json
import shutil
import sys

import numpy as np
import pytest
import torch

from oron_tts_tpu.models import f5tts as jf5
from oron_tts_tpu_torch.cli import make_synthetic_speech, train_vocoder
from oron_tts_tpu_torch.models import f5tts as tf5
from oron_tts_tpu_torch.train.checkpoint import load_pytree_npz

from conftest import REPO_ROOT

# the JAX package's script, loaded from its file: putting scripts/ on sys.path
# would let scripts/profile.py shadow the standard library's profile module
_spec = importlib.util.spec_from_file_location(
    "jax_train_vocoder", REPO_ROOT / "scripts" / "train_vocoder.py")
jtrain = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jtrain)

TINY = {
    "sample_rate": 24000, "n_fft": 1024, "hop_length": 256, "n_mels": 100,
    "model": {"vocab_size": 65, "dim": 64, "depth": 2, "heads": 2, "ff_mult": 2,
              "text_dim": 32, "conv_layers": 2, "p_dropout": 0.0},
}
ARGS = ["--dim", "32", "--n-layers", "1", "--batch-size", "2", "--crop-frames", "8",
        "--log-interval", "2", "--save-interval", "2", "--holdout-frac", "0.2",
        "--device", "cpu"]


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny models on one intra-op thread: on a CPU shared by several test workers,
    each op's thread team would otherwise wait on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory) -> str:
    out = tmp_path_factory.mktemp("synth")
    make_synthetic_speech.main(["--out", str(out), "-n", "6", "--seed", "0"])
    return str(out)


def run_jax(argv: list[str], monkeypatch) -> None:
    monkeypatch.setattr(sys, "argv", ["train_vocoder.py"] + argv)
    monkeypatch.setenv("ORON_COMPILE_CACHE", "0")  # no cache under $HOME
    jtrain.main()


def flat_params(path) -> dict[str, np.ndarray]:
    trees, meta = load_pytree_npz(path)
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                out[prefix + k] = np.asarray(v)

    walk(trees["params"], "")
    return out


def opt_counts(path) -> list[int]:
    """Every scalar count of the optax state (Adam's and the schedule's)."""
    with np.load(path) as data:
        return [int(data[k]) for k in data.files if k.startswith("opt/") and data[k].ndim == 0]


def move(before, after) -> np.ndarray:
    return np.concatenate([(after[k] - before[k]).ravel() for k in sorted(before)])


def test_checkpoint_decodes_in_both_facades(tmp_path, corpus):
    out = train_vocoder.main(["--data-dir", corpus, "--checkpoint-dir", str(tmp_path),
                              "--steps", "4"] + ARGS)
    assert [w["step"] for w in out["windows"]] == [2, 4]
    assert all(np.isfinite(w["loss_mean"]) and w["skipped"] == 0 for w in out["windows"])
    ckpt = tmp_path / "vocos_step_00000004.npz"
    assert (tmp_path / "vocos_step_00000002.npz").exists() and ckpt.exists()
    assert json.loads((tmp_path / "config.json").read_text()) == {
        "dim": 32, "n_layers": 1, "intermediate_dim": 96, "head_mode": "mag_phase"}
    assert opt_counts(ckpt) == [4, 4]

    mel = np.random.default_rng(0).standard_normal((1, 100, 40)).astype(np.float32) - 6.0
    model = tf5.F5TTS.from_config(TINY, device="cpu")
    model.load_vocoder(ckpt)
    got = model._decode_mel(torch.from_numpy(mel))
    jmodel = jf5.F5TTS.from_config(TINY)
    jmodel.load_vocoder(str(ckpt))
    import jax.numpy as jnp

    ref = np.asarray(jmodel._decode_mel(jnp.asarray(mel)))
    assert got.shape == ref.shape == (40 * 256,)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(tmp_path, corpus, monkeypatch, writer):
    """One package writes step 2; each package continues it to step 4."""
    first = tmp_path / "first"
    argv = ["--data-dir", corpus, "--checkpoint-dir", str(first), "--steps", "2"] + ARGS
    if writer == "jax":
        run_jax(argv, monkeypatch)
    else:
        train_vocoder.main(argv)
    start = flat_params(first / "vocos_step_00000002.npz")
    for name in ("jax", "port"):
        shutil.copytree(first, tmp_path / name)
        argv = ["--data-dir", corpus, "--checkpoint-dir", str(tmp_path / name), "--steps", "4",
                "--resume"] + ARGS
        if name == "jax":
            run_jax(argv, monkeypatch)
        else:
            train_vocoder.main(argv)
        assert opt_counts(tmp_path / name / "vocos_step_00000004.npz") == [4, 4]
    moved = {name: move(start, flat_params(tmp_path / name / "vocos_step_00000004.npz"))
             for name in ("jax", "port")}
    nj, nt = np.linalg.norm(moved["jax"]), np.linalg.norm(moved["port"])
    cosine = float(moved["jax"] @ moved["port"] / (nj * nt))
    assert abs(nt / nj - 1) < 0.05 and cosine > 0.95, (nj, nt, cosine)
