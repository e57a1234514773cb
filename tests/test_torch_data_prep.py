"""PyTorch port, data preparation against the JAX package (CPU, no network, no ffmpeg).

The port keeps its own copies of the JAX package's host code: WAV bytes
(header-only durations, decoding, silence trimming), the spectral-gate
denoiser, the attribute tokens of HuggingFace metadata, the raw-bytes
dataset mode and ``from_hf_dataset``, ``cli.prepare``, the local Common
Voice cleaner and the native audiokit log-mel. Each is held against the JAX
one on seeded audio; the HuggingFace records are an in-memory
``datasets.Dataset`` and the Common Voice archive a seeded tar of WAV clips
(the JAX script's MP3 decoder replaced by a WAV reader). Last, the ported
12-step smoke harness on the CPU.
"""

import csv
import importlib.util
import io
import json
import os
import tarfile
from pathlib import Path

import numpy as np
import pytest

os.environ.setdefault("HF_DATASETS_OFFLINE", "1")
os.environ.setdefault("HF_HUB_OFFLINE", "1")

from oron_tts_tpu import native as jnative  # noqa: E402
from oron_tts_tpu.cli import prepare as jprepare  # noqa: E402
from oron_tts_tpu.data import dataset as jdataset  # noqa: E402
from oron_tts_tpu.data import denoiser as jdenoiser  # noqa: E402
from oron_tts_tpu.data import wav as jwav  # noqa: E402
from oron_tts_tpu_torch import native  # noqa: E402
from oron_tts_tpu_torch.cli import clean_local_cv, prepare  # noqa: E402
from oron_tts_tpu_torch.data import dataset as tdataset  # noqa: E402
from oron_tts_tpu_torch.data import denoiser as tdenoiser  # noqa: E402
from oron_tts_tpu_torch.data import hf as thf  # noqa: E402
from oron_tts_tpu_torch.data import wav as twav  # noqa: E402
from oron_tts_tpu_torch.ops.audio import AudioProcessor  # noqa: E402

from test_torch_serve_load import one_thread  # noqa: E402,F401 (autouse: tiny models)

REPO = Path(__file__).resolve().parent.parent
SR = 24000
WORDS = "сайн байна уу монгол хэл өнөөдөр цаг агаар сайхан тал нутаг".split()


def _clip(rng, seconds: float, rate: int = SR) -> np.ndarray:
    """Voiced syllables in a noise floor, quiet at both ends."""
    n = int(seconds * rate)
    t = np.arange(n) / rate
    f0 = rng.uniform(110, 220)
    voiced = sum(np.sin(2 * np.pi * f0 * k * t) / k for k in range(1, 5))
    env = np.clip(np.sin(2 * np.pi * rng.uniform(2.5, 4.5) * t), 0, None) ** 2
    env[: rate // 5] = env[-(rate // 5):] = 0.0
    return (0.3 * voiced * env + 0.003 * rng.standard_normal(n)).astype(np.float32)


def _records(n=6, seed=0, rates=(SR,)):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        rate = rates[i % len(rates)]
        audio = _clip(rng, float(rng.uniform(1.2, 3.0)), rate)
        if i % 3 == 2:  # a stereo file: both decoders take the channel mean
            audio = np.stack([audio, 0.5 * audio], axis=1)
        out.append({
            "sentence": " ".join(rng.choice(WORDS, size=int(rng.integers(2, 6)))) + ".",
            "client_id": f"spk{i % 2}", "gender": ["female", "M", "other", None][i % 4],
            "age": ["twenties", "fifties", "Seventies", "unknown"][i % 4],
            "audio": {"bytes": twav.wav_bytes(audio, rate), "path": None},
        })
    return out


# ── WAV bytes ───────────────────────────────────────────────────────────


@pytest.mark.parametrize("rate", [16000, 24000, 48000])
def test_wav_bytes_info_and_decoding_match_jax(rate):
    rec = _records(3, seed=rate, rates=(rate,))
    for r in rec:
        raw = r["audio"]["bytes"]
        assert twav.wav_info_bytes(raw) == jwav.wav_info_bytes(raw)
        np.testing.assert_array_equal(twav.decode_audio_bytes(raw, SR),
                                      jwav.decode_audio_bytes(raw, SR))
    for bad in (b"", b"RIFF\x00", b"RIFF\x10\x00\x00\x00WAVEfmt "):
        with pytest.raises(ValueError):
            twav.wav_info_bytes(bad)
        with pytest.raises(ValueError):
            jwav.wav_info_bytes(bad)


def test_non_wav_bytes_need_ffmpeg(monkeypatch):
    monkeypatch.setattr(twav.shutil, "which", lambda name: None)
    with pytest.raises(ValueError, match="ffmpeg"):
        twav.decode_audio_bytes(b"ID3\x03not a wave file", SR)


@pytest.mark.parametrize("top_db,frame,hop", [(20.0, 2048, 512), (30.0, 1024, 256),
                                              (10.0, 4096, 1024)])
def test_trim_silence_matches_jax(top_db, frame, hop):
    rng = np.random.default_rng(int(top_db))
    for audio in (_clip(rng, 2.0), np.zeros(5000, np.float32), _clip(rng, 0.05),
                  np.zeros(0, np.float32)):
        got = twav.trim_silence(audio, top_db, frame, hop)
        np.testing.assert_array_equal(got, jwav.trim_silence(audio, top_db, frame, hop))
    ap = AudioProcessor(device="cpu")
    audio = _clip(rng, 2.0)
    np.testing.assert_array_equal(ap.trim_silence(audio, top_db, frame, hop),
                                  jwav.trim_silence(audio, top_db, frame, hop))
    assert ap.get_audio_duration(audio) == len(audio) / SR


def test_audio_processor_saves_what_it_loads(tmp_path):
    ap = AudioProcessor(device="cpu")
    audio = _clip(np.random.default_rng(1), 1.0)
    ap.save_audio(tmp_path / "a.wav", audio)
    loaded, rate = ap.load_audio(tmp_path / "a.wav")
    assert rate == SR
    np.testing.assert_allclose(loaded, audio, atol=1 / 32767)  # PCM16's step


# ── denoiser ────────────────────────────────────────────────────────────


def test_spectral_gate_and_denoiser_match_jax():
    rng = np.random.default_rng(4)
    noisy = _clip(rng, 2.5) + 0.02 * rng.standard_normal(int(2.5 * SR)).astype(np.float32)
    for kw in ({}, {"threshold_sigma": 1.0, "reduction_db": 12.0, "mask_smooth": 1}):
        np.testing.assert_array_equal(tdenoiser.spectral_gate(noisy, SR, **kw),
                                      jdenoiser.spectral_gate(noisy, SR, **kw))
    short = noisy[:1000]
    assert tdenoiser.spectral_gate(short, SR) is short
    port = tdenoiser.AudioDenoiser(backend="spectral")
    ref = jdenoiser.AudioDenoiser(backend="spectral")
    assert port.backend == ref.backend == "spectral"
    for rate in (SR, 16000):
        np.testing.assert_array_equal(port.denoise(noisy, rate), ref.denoise(noisy, rate))


def test_denoise_batch_counts_failures(tmp_path):
    audio = _clip(np.random.default_rng(5), 1.5)
    twav.write_wav(tmp_path / "in.wav", audio, SR)
    den = tdenoiser.AudioDenoiser(backend="spectral")
    ok, failed = den.denoise_batch([(tmp_path / "in.wav", tmp_path / "out.wav"),
                                    (tmp_path / "missing.wav", tmp_path / "x.wav")])
    assert (ok, failed) == (1, 1)
    jden = jdenoiser.AudioDenoiser(backend="spectral")
    jden.denoise_file(tmp_path / "in.wav", tmp_path / "ref.wav")
    assert (tmp_path / "out.wav").read_bytes() == (tmp_path / "ref.wav").read_bytes()


# ── HuggingFace metadata and the dataset ───────────────────────────────


def test_attr_tokens_match_jax():
    assert tdataset.GENDER_ATTR_TOKENS == jdataset.GENDER_ATTR_TOKENS
    assert tdataset.AGE_ATTR_TOKENS == jdataset.AGE_ATTR_TOKENS
    values = ["female", "F", " Male ", "boy", "other", "none", None, "", "NaN", "x",
              "twenties", "Fifties", "senior", "middle-aged", "60s", "unknown", 42]
    for g in values:
        for a in values:
            item = {"g": g, "a": a}
            for cols in (("g", "a"), ("g", None), (None, "a"), ("missing", "a"), (None, None)):
                assert (tdataset.attr_tokens_from_metadata(item, *cols)
                        == jdataset.attr_tokens_from_metadata(item, *cols))


def test_bytes_mode_item_matches_jax():
    raws = [r["audio"]["bytes"] for r in _records(3, seed=8, rates=(SR, 16000))]
    texts, attrs = ["сайн байна уу", "Монгол 25", "тал"], [["[FEMALE]"], [], ["[YOUNG]"]]
    port = tdataset.TTSDataset(audio_bytes_list=raws, texts=texts, attr_tokens_list=attrs)
    ref = jdataset.TTSDataset(audio_bytes_list=raws, texts=texts, attr_tokens_list=attrs)
    for i in range(3):
        got, want = port[i], ref[i]
        # both take the native audiokit log-mel: one C++ source
        np.testing.assert_allclose(got["mel"], want["mel"], atol=1e-4)
        np.testing.assert_array_equal(got["text_ids"], want["text_ids"])
        assert got["mel"].shape == want["mel"].shape and got["text"] == want["text"]
    assert port.mel_extractor == "native audiokit"


def test_dataset_needs_one_storage_mode():
    with pytest.raises(ValueError, match="audio_bytes_list"):
        tdataset.TTSDataset(texts=["a"])


def _hf(records):
    from datasets import Dataset

    return Dataset.from_list(records)


def test_from_hf_dataset_matches_jax():
    records = _records(6, seed=2, rates=(SR, 16000))
    records.append({**records[0], "sentence": "  "})  # empty text: filtered
    short = twav.wav_bytes(np.zeros(SR // 4, np.float32), SR)
    records.append({**records[1], "audio": {"bytes": short, "path": None}})  # too short
    records.append({**records[2], "audio": {"bytes": b"", "path": None}})  # no audio
    kw = dict(text_column=None, gender_column="gender", age_column="age")
    port = tdataset.TTSDataset.from_hf_dataset(_hf(records), **kw)
    ref = jdataset.TTSDataset.from_hf_dataset(_hf(records), **kw)
    assert len(port) == len(ref) == 6
    assert port.texts == ref.texts and port.langs == ref.langs
    assert port.attr_tokens_list == ref.attr_tokens_list
    assert port.durations == ref.durations
    assert port.audio_bytes_list == ref.audio_bytes_list
    np.testing.assert_allclose(port[5]["mel"], ref[5]["mel"], atol=1e-4)
    with pytest.raises(ValueError, match="No text column"):
        tdataset.TTSDataset.from_hf_dataset(_hf([{"words": "a", "audio": records[0]["audio"]}]))


def test_hf_wrappers_construct_without_the_network():
    w = thf.HFDatasetWrapper("a/b", dataset_config="c", cache_dir="d", sample_rate=16000)
    assert (w.dataset_name, w.dataset_config, w.cache_dir, w.sample_rate) == ("a/b", "c", "d",
                                                                             16000)
    assert thf.CommonVoiceWrapper().dataset_name == "btsee/common-voices-24-mn"
    mb = thf.MBSpeechWrapper(cache_dir="x")
    assert (mb.dataset_name, mb.text_column, mb.cache_dir) == ("btsee/mbspeech_mn",
                                                               "sentence_norm", "x")


# ── cli.prepare and the local Common Voice cleaner ──────────────────────


def _meta_and_samples(meta, out_dir):
    rows = [{**m, "audio_path": Path(m["audio_path"]).relative_to(out_dir).as_posix()}
            for m in meta]
    return rows, [twav.read_wav(m["audio_path"])[0] for m in meta]


@pytest.mark.parametrize("denoise", [True, False], ids=["denoised", "raw"])
def test_prepare_matches_jax(tmp_path, denoise, capsys):
    records = _records(6, seed=3, rates=(SR, 16000))
    records.append({**records[0], "sentence": "123"})  # numbers become words
    records.append({**records[1], "audio": {"bytes": twav.wav_bytes(np.zeros(500), SR),
                                            "path": None}})  # under 1,024 samples
    kw = dict(denoise=denoise, text_column="sentence", start_index=3)
    meta = prepare.process_dataset(_hf(records), tmp_path / "port", "mn", **kw)
    ref = jprepare.process_dataset(_hf(records), tmp_path / "jax", "mn", **kw)
    got, got_wavs = _meta_and_samples(meta, tmp_path / "port")
    want, want_wavs = _meta_and_samples(ref, tmp_path / "jax")
    assert got == want and len(got) == 7 and got[0]["audio_path"] == "wavs/000003.wav"
    for a, b in zip(got_wavs, want_wavs):
        np.testing.assert_array_equal(a, b)
    # plain records need no datasets library and give the same result
    plain = prepare.process_dataset(records, tmp_path / "plain", "mn", **kw)
    assert _meta_and_samples(plain, tmp_path / "plain")[0] == got
    path = prepare.create_metadata(tmp_path / "port", meta)
    assert json.loads(path.read_text()) == meta


def _load_jax_cv_script():
    spec = importlib.util.spec_from_file_location("jax_clean_local_cv",
                                                  REPO / "scripts" / "clean_local_cv.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _cv_archive(path: Path, records) -> None:
    tsv = io.StringIO()
    writer = csv.writer(tsv, delimiter="\t")
    writer.writerow(["client_id", "path", "sentence", "up_votes"])
    with tarfile.open(path, "w:gz") as tar:
        for i, rec in enumerate(records):
            # Common Voice's names; the bytes are WAV (no MP3 decoder here)
            name = f"common_voice_mn_{i:05d}.mp3"
            writer.writerow([rec["client_id"], name, rec["sentence"], 2])
            data = rec["audio"]["bytes"]
            info = tarfile.TarInfo(f"cv-corpus-24/mn/clips/{name}")
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
        writer.writerow(["spk9", "missing.mp3", "сайн", 1])
        data = tsv.getvalue().encode()
        info = tarfile.TarInfo("cv-corpus-24/mn/validated.tsv")
        info.size = len(data)
        tar.addfile(info, io.BytesIO(data))


@pytest.mark.parametrize("denoise", [False, True], ids=["raw", "denoised"])
def test_clean_local_cv_matches_jax(tmp_path, monkeypatch, denoise):
    records = _records(5, seed=6, rates=(SR, 48000))
    records.append({**records[0], "audio": {"bytes": twav.wav_bytes(np.zeros(SR), SR),
                                            "path": None}})  # silence: trimmed to nothing
    _cv_archive(tmp_path / "cv.tar.gz", records)
    jscript = _load_jax_cv_script()
    monkeypatch.setattr(jscript, "load_mp3_bytes",
                        lambda raw, sr: jwav.decode_audio_bytes(raw, sr))
    ref = jscript.extract_and_process_cv(tmp_path / "cv.tar.gz", tmp_path / "jax",
                                         denoise=denoise, max_samples=4)
    # the port decodes WAV clips itself; MP3 would go through ffmpeg
    meta = clean_local_cv.main(["--archive", str(tmp_path / "cv.tar.gz"), "--output-dir",
                                str(tmp_path / "port"), "--max-samples", "4"]
                               + (["--denoise"] if denoise else []))
    got, got_wavs = _meta_and_samples(meta, tmp_path / "port")
    want, want_wavs = _meta_and_samples(ref, tmp_path / "jax")
    assert got == want and len(got) == 4
    assert [m["speaker_id"] for m in got] == ["0", "1", "0", "1"]
    for a, b in zip(got_wavs, want_wavs):
        np.testing.assert_array_equal(a, b)
    assert json.loads((tmp_path / "port" / "metadata.json").read_text()) == meta


# ── the native log-mel and the smoke harness ───────────────────────────


@pytest.mark.parametrize("n", [1024 * 2, 24000, 61_111])
def test_native_log_mel_matches_jax_native(n):
    audio = _clip(np.random.default_rng(n), n / SR)
    got = native.log_mel(audio, SR, 1024, 256, 1024, 100)
    want = jnative.log_mel(audio, SR, 1024, 256, 1024, 100)
    assert got is not None and want is not None, "both libraries build with g++"
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert native.log_mel(audio[:100], SR, 1024, 256, 1024, 100) is None  # reflect pad refuses
    peak = audio * 3.0
    assert native.normalize_peak_inplace(peak)
    np.testing.assert_allclose(peak, twav.normalize_peak(audio * 3.0), atol=1e-6)
    assert native.lib_path().parent == REPO / "build" / "audiokit"


def test_dataset_falls_back_to_the_torch_log_mel(monkeypatch):
    from oron_tts_tpu_torch.ops.mel import log_mel_spectrogram

    import torch

    monkeypatch.setattr(native, "log_mel", lambda *a, **k: None)
    audio = _clip(np.random.default_rng(9), 1.5)
    ds = tdataset.TTSDataset(audio_arrays=[audio], texts=["сайн"])
    np.testing.assert_array_equal(
        ds[0]["mel"], log_mel_spectrogram(torch.from_numpy(twav.normalize_peak(audio)),
                                          ds.mel_config).numpy())
    assert ds.mel_extractor == "torch (ops/mel.py)"


def test_test_pipeline_passes_on_the_cpu(capsys):
    from oron_tts_tpu_torch.cli import test_pipeline

    assert test_pipeline.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("PASS") == 11 and "All 11 steps passed on cpu." in out
