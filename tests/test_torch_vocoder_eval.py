"""``cli.eval_vocoder`` against ``scripts/eval_vocoder.py``, and the GAN stage of
``cli.train_vocoder``, on the CPU.

The bundled Vocos scored on four seeded out-of-distribution clips: the
port's MR-STFT and mel-L1 within 1e-3 of the JAX script's, and its
Griffin-Lim floor within 0.03 / 0.015 (the initial phase is a torch draw,
not ``jax.random``'s). ``--ship-to`` writes a file that ``ORON_VOCOS_CKPT``
loads. The GAN stage refuses to start before ``--gan-start-step``, tags its
checkpoints, and resumes both nets' Adam moments.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from oron_tts_tpu_torch.cli import eval_vocoder, make_synthetic_speech, train_vocoder
from oron_tts_tpu_torch.models.f5tts import BUNDLED_VOCODER
from oron_tts_tpu_torch.train.checkpoint import load_pytree_npz

from conftest import REPO_ROOT

_spec = importlib.util.spec_from_file_location(
    "jax_eval_vocoder", REPO_ROOT / "scripts" / "eval_vocoder.py")
jeval = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jeval)


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny models on one intra-op thread: on a CPU shared by several test workers,
    each op's thread team would otherwise wait on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def synth(tmp_path_factory, *args: str) -> str:
    out = tmp_path_factory.mktemp("synth")
    make_synthetic_speech.main(["--out", str(out), *args])
    return str(out)


def test_eval_matches_the_jax_script(tmp_path_factory, monkeypatch, capsys):
    data = synth(tmp_path_factory, "--family", "ood", "-n", "4", "--seed", "123")
    argv = ["--checkpoint", str(BUNDLED_VOCODER), "--data-dir", data, "--holdout-frac", "1.0",
            "--clips", "8", "--griffin-lim", "--device", "cpu"]
    monkeypatch.setattr(sys, "argv", ["eval_vocoder.py"] + argv)
    jeval.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ship = tmp_path_factory.mktemp("ship")
    got = eval_vocoder.main(argv + ["--ship-to", str(ship)])
    assert got["clips"] == want["clips"] == 4  # clamped to the held-out pool
    assert abs(got["mr_stft_exact"] - want["mr_stft"]) <= 1e-3, (got, want)
    assert abs(got["mel_l1_exact"] - want["mel_l1"]) <= 1e-3, (got, want)
    assert abs(got["griffin_lim_mr_stft"] - want["griffin_lim_mr_stft"]) <= 0.03
    assert abs(got["griffin_lim_mel_l1"] - want["griffin_lim_mel_l1"]) <= 0.015
    assert got["mr_stft"] < got["griffin_lim_mr_stft"] and got["mel_l1"] < got["griffin_lim_mel_l1"]

    # the shipped file: parameters only, the config beside it, loaded by ORON_VOCOS_CKPT
    from oron_tts_tpu_torch.models import f5tts as tf5

    shipped = ship / "vocos_default.npz"
    trees, meta = load_pytree_npz(shipped)
    assert set(trees) == {"params"} and meta["eval_mr_stft"] == got["mr_stft_exact"]
    assert json.loads((ship / "EVAL.json").read_text())["mel_l1"] == got["mel_l1"]
    cfg = {"model": {"vocab_size": 65, "dim": 64, "depth": 2, "heads": 2, "ff_mult": 2,
                     "text_dim": 32, "conv_layers": 1}}
    mel = torch.from_numpy(
        np.random.default_rng(1).standard_normal((1, 100, 24)).astype(np.float32) - 5.0)
    monkeypatch.setenv("ORON_VOCOS_CKPT", str(shipped))
    model = tf5.F5TTS.from_config(cfg, device="cpu")
    model.load_vocoder()
    from_env = model._decode_mel(mel)
    model.load_vocoder(BUNDLED_VOCODER)
    assert np.array_equal(from_env, model._decode_mel(mel))


def test_holdout_pool_is_what_training_left_out(tmp_path_factory):
    data = synth(tmp_path_factory, "-n", "10", "--seed", "2")
    assert len(train_vocoder.load_corpus(data, 0.2, 24000)) == 8
    args = eval_vocoder.build_parser().parse_args(
        ["--checkpoint", "x", "--data-dir", data, "--holdout-frac", "0.2", "--clips", "5"])
    crop = 2 * 24000
    wavs = eval_vocoder.held_out_clips(args, crop, 24000)
    assert args.clips == 2 and len(wavs) == 2 and all(len(w) == crop for w in wavs)
    from oron_tts_tpu_torch.data.wav import normalize_peak, read_wav

    meta = json.loads((Path(data) / "metadata.json").read_text())
    tail = normalize_peak(read_wav(meta[-1]["audio_path"])[0].astype(np.float32))[:crop]
    np.testing.assert_array_equal(wavs[1][: len(tail)], tail)


def opt_counts(path) -> list[int]:
    """Every scalar count of the optax state in a checkpoint."""
    with np.load(path) as data:
        return [int(data[k]) for k in data.files if k.startswith("opt/") and data[k].ndim == 0]


def leaves(path) -> np.ndarray:
    with np.load(path) as data:
        return np.concatenate([data[k].ravel() for k in sorted(data.files)
                               if k.startswith("params/")])


def test_gan_stage_resumes_both_nets(tmp_path_factory):
    data = synth(tmp_path_factory, "-n", "5", "--seed", "4")
    ckpt = tmp_path_factory.mktemp("gan")
    base = ["--data-dir", data, "--checkpoint-dir", str(ckpt), "--dim", "32", "--n-layers",
            "1", "--batch-size", "2", "--crop-frames", "4", "--log-interval", "2",
            "--save-interval", "2", "--holdout-frac", "0", "--device", "cpu"]
    train_vocoder.main(base + ["--steps", "2"])
    with pytest.raises(SystemExit, match="--gan-start-step 4 not reached"):
        train_vocoder.main(base + ["--steps", "6", "--resume", "--gan", "--gan-start-step", "4"])
    out = train_vocoder.main(base + ["--steps", "4", "--resume", "--gan", "--gan-start-step", "2"])
    assert out["stage"] == "gan" and all(w["finite"] for w in out["windows"])
    g4, d4 = ckpt / "vocos_step_00000004.npz", ckpt / "vocos_disc_step_00000004.npz"
    assert load_pytree_npz(g4)[1]["stage"] == "gan"
    # a GAN checkpoint's generator moments are the GAN optimizer's (2 updates), not
    # the MR-STFT stage's; constant learning rates: no schedule count
    assert opt_counts(g4) == [2] and opt_counts(d4) == [2]
    before = leaves(g4), leaves(d4)
    train_vocoder.main(base + ["--steps", "6", "--resume", "--gan"])
    g6, d6 = ckpt / "vocos_step_00000006.npz", ckpt / "vocos_disc_step_00000006.npz"
    assert not d4.exists()  # one discriminator file kept
    assert opt_counts(g6) == [4] and opt_counts(d6) == [4]  # resumed, not restarted
    for old, new in zip(before, (leaves(g6), leaves(d6))):
        assert old.shape == new.shape and not np.array_equal(old, new)
