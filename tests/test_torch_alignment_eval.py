"""PyTorch port, the tone-code alignment eval against the JAX package (CPU).

``oron_tts_tpu_torch/evals/alignment.py`` and ``cli/make_tone_corpus.py`` are
the port's copies of the JAX protocol: the same letters, tones, corpus,
decoding and CER, compared here bit for bit (``np.array_equal``, string
equality). Then the facade's duration at the protocol's exact length, an
untrained model's score, the ``cli.eval_alignment`` payload and the corpus
through ``cli.train``, all on a tiny model on the CPU.
"""

import importlib.util
import json
import sys

import numpy as np
import pytest

from oron_tts_tpu.evals import alignment as jal
from oron_tts_tpu.ops.mel import MelConfig as JMelConfig
from oron_tts_tpu.ops.mel import log_mel_numpy
from oron_tts_tpu_torch.cli import make_tone_corpus
from oron_tts_tpu_torch.evals import alignment as tal

from conftest import REPO_ROOT

# the JAX package's script, loaded from its file: putting scripts/ on sys.path
# would let scripts/profile.py shadow the standard library's profile module
_spec = importlib.util.spec_from_file_location(
    "jax_make_tone_corpus", REPO_ROOT / "scripts" / "make_tone_corpus.py")
jcorpus = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jcorpus)

SENTENCES = [
    "сайн байна уу",
    "монгол улс",
    "өнөөдөр сайхан өдөр байна",
    "бүх хүн төрөлхөөс эрх чөлөөтэй",
    "уул усаа хайрла",  # repeated letters must stay distinct
    "Сайн уу? 2024 он, 10-р сар!",  # numbers and punctuation through the cleaner
]
TINY = {
    "sample_rate": 24000, "n_fft": 1024, "hop_length": 256, "n_mels": 100,
    "model": {"vocab_size": 65, "dim": 64, "depth": 2, "heads": 2, "ff_mult": 2,
              "text_dim": 32, "conv_layers": 2, "p_dropout": 0.0},
}


def test_constants_match_jax():
    for name in ("SR", "HOP", "FRAMES_PER_CHAR", "TONE_FRAMES", "FIRST_BIN", "BIN_STEP",
                 "LETTERS", "AMPLITUDE", "RAMP"):
        assert getattr(tal, name) == getattr(jal, name), name
    assert tal.FRAMES_PER_CHAR == 13 and tal.TONE_FRAMES == 9 and len(tal.LETTERS) == 35


def test_letter_tables_match_jax_bit_for_bit():
    assert tal.letter_bins() == jal.letter_bins()
    got, ref = tal.letter_frequencies(), jal.letter_frequencies()
    assert list(got) == list(ref)
    assert np.array_equal(np.array(list(got.values())), np.array(list(ref.values())))


@pytest.mark.parametrize("text", SENTENCES + [" ".join(jal.LETTERS), "", "?!"])
def test_render_and_expected_letters_match_jax_bit_for_bit(text):
    assert tal.expected_letters(text) == jal.expected_letters(text)
    got, ref = tal.render_text(text), jal.render_text(text)
    assert got.dtype == ref.dtype == np.float32
    assert np.array_equal(got, ref)


def test_build_corpus_matches_jax():
    texts, wavs = make_tone_corpus.build_corpus(40, seed=3)
    ref_texts, ref_wavs = jcorpus.build_corpus(40, seed=3)
    assert texts == ref_texts
    assert len(wavs) == len(ref_wavs) == 40
    assert all(np.array_equal(a, b) for a, b in zip(wavs, ref_wavs))
    # the long-clip variant of bench_train_e2e
    kw = {"min_words": 13, "max_words": 14, "min_len": 4, "max_len": 4}
    assert make_tone_corpus.build_corpus(8, 0, **kw)[0] == jcorpus.build_corpus(8, 0, **kw)[0]
    assert set("".join(texts)) - {" "} == set(tal.LETTERS)
    assert all(len(w) / tal.SR >= 1.0 for w in wavs)


def test_corpus_cli_writes_the_jax_layout(tmp_path, monkeypatch):
    """Both CLIs write the same metadata (paths aside) and the same WAV bytes."""
    make_tone_corpus.main(["--out", str(tmp_path / "port"), "--sentences", "7", "--seed", "5"])
    monkeypatch.setattr(sys, "argv", ["make_tone_corpus.py", "--out", str(tmp_path / "jax"),
                                      "--sentences", "7", "--seed", "5"])
    jcorpus.main()
    got = json.loads((tmp_path / "port" / "metadata.json").read_text())
    ref = json.loads((tmp_path / "jax" / "metadata.json").read_text())
    assert len(got) == len(ref) == 7
    for g, r in zip(got, ref):
        assert g["audio_path"].replace("/port/", "/jax/") == r["audio_path"]
        assert {k: v for k, v in g.items() if k != "audio_path"} == {
            k: v for k, v in r.items() if k != "audio_path"}
        assert open(g["audio_path"], "rb").read() == open(r["audio_path"], "rb").read()


def test_decode_waveform_matches_jax_and_round_trips():
    texts, wavs = make_tone_corpus.build_corpus(40, seed=3)
    alphabet = " ".join(tal.LETTERS)
    for text, wav in [(alphabet, tal.render_text(alphabet))] + list(zip(texts, wavs)):
        got = tal.decode_waveform(wav)
        assert got == jal.decode_waveform(wav)
        assert got == tal.expected_letters(text)  # lossless
    assert len(tal.decode_waveform(tal.render_text(alphabet))) == 35


@pytest.mark.parametrize("threshold,min_run", [(-2.0, 3), (-4.0, 1), (0.0, 5)])
def test_decode_logmel_matches_jax(threshold, min_run):
    rng = np.random.default_rng(11)
    # a rendered sentence's log-mel, then the same with seeded noise on it
    logmel = log_mel_numpy(jal.render_text(SENTENCES[3]), JMelConfig())
    noisy = logmel + rng.normal(0.0, 2.0, size=logmel.shape).astype(np.float32)
    for m in (logmel, noisy, rng.normal(-3.0, 3.0, size=(100, 300)).astype(np.float32)):
        assert tal.decode_logmel(m, threshold, min_run) == jal.decode_logmel(m, threshold, min_run)


@pytest.mark.parametrize("ref,hyp", [
    ("абв", "абв"), ("абв", "аб"), ("абв", ""), ("аб", "ба"), ("а", "ааааа"),
    ("сайнбайнауу", "сйнбайнаууу"), ("өнөөдөр", "өөнөдр"),
])
def test_char_error_rate_matches_jax(ref, hyp):
    assert tal.char_error_rate(ref, hyp) == jal.char_error_rate(ref, hyp)


def test_char_error_rate_refuses_an_empty_reference():
    with pytest.raises(ValueError):
        tal.char_error_rate("", "аб")


def test_synthesize_mel_at_the_exact_duration_has_jax_frame_count():
    """The eval's exact duration, n·13·256/24000 s, gives the same T in both facades."""
    from oron_tts_tpu.models.f5tts import F5TTS as JF5TTS
    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from oron_tts_tpu_torch.text.cleaner import TextCleaner

    jmodel = JF5TTS.from_config(TINY)
    jmodel.init_params(0)
    model = F5TTS.from_config(TINY, device="cpu")
    model.load_params(jmodel.variables["params"])  # the same weights
    for i, text in enumerate(SENTENCES[:3]):
        n = len(TextCleaner().clean(text, "mn"))
        dur = n * tal.FRAMES_PER_CHAR * tal.HOP / tal.SR
        got = model.synthesize_mel(text, n_steps=1, seed=i, target_duration_s=dur)
        ref = jmodel.synthesize_mel(text, n_steps=1, seed=i, target_duration_s=dur)
        assert got.shape == np.asarray(ref).shape == (100, n * 13)


def test_untrained_model_scores_high_cer():
    """An untrained model must not "pass": CER > 0.5, as the JAX test pins."""
    from oron_tts_tpu_torch.models.f5tts import F5TTS

    model = F5TTS.from_config(TINY, device="cpu")
    model.init_params(0)
    text = "сайн байна уу"
    mel = model.synthesize_mel(text, n_steps=2, seed=0)
    assert mel.ndim == 2 and mel.shape[0] == 100 and mel.shape[1] > 0
    assert tal.char_error_rate(tal.expected_letters(text), tal.decode_logmel(mel)) > 0.5


# the JAX script's payload (scripts/eval_tts_alignment.py), which the port
# writes without "backend" and with "device"
JAX_PAYLOAD_KEYS = {
    "protocol", "backend", "untrained_cer_4clip", "holdout", "train_seconds", "steps",
    "frames_per_s", "final_train_loss", "config", "sentences", "holdout_n", "n_steps",
    "cfg_strength", "seed", "duration_stats_global",
}


def test_eval_alignment_cli_smoke_writes_the_jax_payload(tmp_path):
    from oron_tts_tpu_torch.cli import eval_alignment

    out = tmp_path / "align.json"
    payload = eval_alignment.main([
        "--device", "cpu", "--sentences", "24", "--dim", "64", "--depth", "2",
        "--heads", "2", "--epochs", "2", "--holdout", "2", "--n-steps", "4",
        "--out", str(out), "--checkpoint-dir", str(tmp_path / "ckpt")])
    assert json.loads(out.read_text()) == payload
    assert set(payload) == JAX_PAYLOAD_KEYS - {"backend"} | {"device"}
    assert payload["device"] == "cpu"
    for name in ("raw", "ema"):
        h = payload["holdout"][name]
        assert set(h) == {"cer", "per_clip", "cer_reffree_duration", "cer_reffree_calibrated"}
        assert len(h["per_clip"]) == 2
        assert all(0.0 <= h[k] <= 1.0 for k in h if k != "per_clip")
    assert payload["steps"] > 0 and np.isfinite(payload["final_train_loss"])
    assert payload["config"]["model"]["dim"] == 64
    # the trained checkpoint, with the fitted table in its config.json
    cfg = json.loads((tmp_path / "ckpt" / "config.json").read_text())
    assert cfg["duration_stats"]["global"] == payload["duration_stats_global"]
    assert list((tmp_path / "ckpt").glob("f5tts_step_*.npz"))


def test_tone_corpus_trains_through_cli_train(tmp_path, capsys):
    from oron_tts_tpu_torch.cli import train

    make_tone_corpus.main(["--out", str(tmp_path / "corpus"), "--sentences", "24"])
    train.main(["--config", str(REPO_ROOT / "configs" / "test.yaml"), "--from-local",
                "--data-dir", str(tmp_path / "corpus"), "--num-epochs", "1",
                "--device", "cpu", "--checkpoint-dir", str(tmp_path / "ckpt"),
                "--log-dir", str(tmp_path / "logs")])
    out = capsys.readouterr().out
    assert "Dataset size: 24" in out
    # the epoch line cli.bench_train_e2e parses
    from oron_tts_tpu_torch.cli.bench_train_e2e import EPOCH_LINE

    assert len(EPOCH_LINE.findall(out)) == 1


def test_wav_scoring_cli(tmp_path, capsys):
    """``python -m oron_tts_tpu_torch.evals.alignment`` scores WAVs as the eval scores mels."""
    from oron_tts_tpu_torch.data.wav import write_wav

    text = SENTENCES[4]
    write_wav(tmp_path / "clean.wav", tal.render_text(text), tal.SR)
    write_wav(tmp_path / "silent.wav", np.zeros(tal.SR, np.float32), tal.SR)
    rows = tal.main(["--text", text, str(tmp_path / "clean.wav"), str(tmp_path / "silent.wav")])
    assert [r["cer"] for r in rows] == [0.0, 1.0]
    assert rows[0]["decoded"] == rows[0]["expected"] == jal.expected_letters(text)
    assert [json.loads(line) for line in capsys.readouterr().out.splitlines()] == rows


def test_eval_and_bench_refuse_a_silent_cpu(tmp_path, monkeypatch):
    """Without a card and without --device cpu both CLIs raise before any work."""
    import torch

    from oron_tts_tpu_torch.cli import bench_train_e2e, eval_alignment

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        eval_alignment.main(["--out", str(tmp_path / "a.json")])
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_train_e2e.main(["--data-dir", str(tmp_path / "c"), "--work-dir", str(tmp_path / "w"),
                              "--out", str(tmp_path / "e.json")])
    assert not list(tmp_path.iterdir())
