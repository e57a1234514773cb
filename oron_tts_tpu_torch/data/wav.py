"""Self-contained WAV (RIFF) reading/writing on numpy.

Counterpart of the JAX package's ``data/wav.py``: PCM 8/16/24/32 and IEEE
float32/64 decode, PCM16/float32 encode (whole files, and a header plus
PCM16 pieces for a stream of unknown length), header-only durations of a
file or of bytes, decoding of any audio bytes (WAV in-process, other
containers through an ``ffmpeg`` subprocess), polyphase resampling, peak
normalization and energy-based silence trimming.
"""

from __future__ import annotations

import io
import shutil
import struct
import subprocess
from pathlib import Path

import numpy as np

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def read_wav_bytes(data: bytes) -> tuple[np.ndarray, int]:
    """Decode RIFF/WAVE bytes → (float32 samples [n] or [n, ch], sample_rate).

    Raises ValueError for anything malformed (including truncated chunks).
    """
    try:
        return _read_wav_bytes(data)
    except struct.error as exc:
        raise ValueError(f"malformed WAVE data: {exc}") from exc


def _read_wav_bytes(data: bytes) -> tuple[np.ndarray, int]:
    buf = io.BytesIO(data)
    riff, _size, wave = struct.unpack("<4sI4s", buf.read(12))
    if riff != b"RIFF" or wave != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")

    fmt = None
    raw = None
    while True:
        header = buf.read(8)
        if len(header) < 8:
            break
        chunk_id, chunk_size = struct.unpack("<4sI", header)
        payload = buf.read(chunk_size)
        if chunk_size % 2:
            buf.read(1)  # chunks are word-aligned
        if chunk_id == b"fmt ":
            fmt = payload
        elif chunk_id == b"data":
            raw = payload
        if fmt is not None and raw is not None:
            break
    if fmt is None or raw is None:
        raise ValueError("missing fmt/data chunk")

    audio_format, channels, sample_rate, _, _, bits = struct.unpack("<HHIIHH", fmt[:16])
    if audio_format == _WAVE_FORMAT_EXTENSIBLE and len(fmt) >= 40:
        audio_format = struct.unpack("<H", fmt[24:26])[0]

    if audio_format == _WAVE_FORMAT_IEEE_FLOAT:
        dtype = np.float32 if bits == 32 else np.float64
        samples = np.frombuffer(raw, dtype=dtype).astype(np.float32)
    elif audio_format == _WAVE_FORMAT_PCM:
        if bits == 16:
            samples = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            samples = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            ints = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
            samples = ints.astype(np.float32) / float(1 << 23)
        elif bits == 8:
            samples = (
                np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0
            ) / 128.0
        else:
            raise ValueError(f"unsupported PCM bit depth: {bits}")
    else:
        raise ValueError(f"unsupported WAVE format code: {audio_format:#x}")

    if channels > 1:
        samples = samples.reshape(-1, channels)
    return samples, sample_rate


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    return read_wav_bytes(Path(path).read_bytes())


def wav_info(path: str | Path) -> tuple[float, int]:
    """Header-only (duration_seconds, sample_rate) of a WAV file.

    Reads the first 64 KiB and falls back to the whole file for exotic chunk
    layouts. Raises ValueError for malformed data.
    """
    with open(path, "rb") as f:
        head = f.read(65536)
    try:
        return _wav_info_bytes(head)
    except (ValueError, struct.error):
        try:
            return _wav_info_bytes(Path(path).read_bytes())
        except struct.error as exc:
            raise ValueError(f"malformed WAVE data: {exc}") from exc


def wav_info_bytes(data: bytes) -> tuple[float, int]:
    """(duration_seconds, sample_rate) of WAV bytes without decoding the samples.

    Raises ValueError for malformed or truncated data (never struct.error).
    """
    try:
        return _wav_info_bytes(data)
    except struct.error as exc:
        raise ValueError(f"malformed WAVE data: {exc}") from exc


def _wav_info_bytes(data: bytes) -> tuple[float, int]:
    buf = io.BytesIO(data)
    riff, _size, wave = struct.unpack("<4sI4s", buf.read(12))
    if riff != b"RIFF" or wave != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    sample_rate = channels = bits = data_size = None
    while sample_rate is None or data_size is None:
        header = buf.read(8)
        if len(header) < 8:
            break
        chunk_id, chunk_size = struct.unpack("<4sI", header)
        if chunk_id == b"fmt ":
            payload = buf.read(chunk_size)
            _, channels, sample_rate, _, _, bits = struct.unpack("<HHIIHH", payload[:16])
        else:
            if chunk_id == b"data":
                data_size = chunk_size
            buf.seek(chunk_size + chunk_size % 2, 1)
    if sample_rate is None or data_size is None or not channels or not bits:
        raise ValueError("missing fmt/data chunk")
    return data_size // (channels * bits // 8) / sample_rate, sample_rate


def wav_bytes(
    samples: np.ndarray, sample_rate: int, subtype: str = "pcm16"
) -> bytes:
    """Encode float samples ([n] or [n, ch]) as RIFF/WAVE bytes."""
    samples = np.asarray(samples)
    channels = 1 if samples.ndim == 1 else samples.shape[1]

    if subtype == "pcm16":
        payload = pcm16_bytes(samples)
        audio_format, bits = _WAVE_FORMAT_PCM, 16
    elif subtype == "float32":
        payload = samples.astype("<f4").tobytes()
        audio_format, bits = _WAVE_FORMAT_IEEE_FLOAT, 32
    else:
        raise ValueError(f"unsupported subtype: {subtype}")

    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    fmt = struct.pack(
        "<HHIIHH", audio_format, channels, sample_rate, byte_rate, block_align, bits
    )
    out = io.BytesIO()
    out.write(struct.pack("<4sI4s", b"RIFF", 36 + len(payload), b"WAVE"))
    out.write(struct.pack("<4sI", b"fmt ", len(fmt)))
    out.write(fmt)
    out.write(struct.pack("<4sI", b"data", len(payload)))
    out.write(payload)
    return out.getvalue()


def write_wav(
    path: str | Path,
    samples: np.ndarray,
    sample_rate: int,
    subtype: str = "pcm16",
) -> None:
    """Write float samples ([n] or [n, ch]) as PCM16 or FLOAT32 WAV."""
    Path(path).write_bytes(wav_bytes(samples, sample_rate, subtype))


def wav_stream_header(sample_rate: int, channels: int = 1) -> bytes:
    """RIFF/WAVE PCM16 header for a stream of unknown length.

    The RIFF and data sizes are 0xFFFFFFFF (the usual streaming convention:
    players read until the end). ``pcm16_bytes`` payloads follow it.
    """
    bits = 16
    fmt = struct.pack(
        "<HHIIHH", _WAVE_FORMAT_PCM, channels, sample_rate,
        sample_rate * channels * bits // 8, channels * bits // 8, bits,
    )
    return (struct.pack("<4sI4s", b"RIFF", 0xFFFFFFFF, b"WAVE")
            + struct.pack("<4sI", b"fmt ", len(fmt)) + fmt
            + struct.pack("<4sI", b"data", 0xFFFFFFFF))


def pcm16_bytes(samples: np.ndarray) -> bytes:
    """Float samples in [-1, 1] → little-endian PCM16 payload bytes."""
    return np.round(np.clip(np.asarray(samples), -1.0, 1.0) * 32767.0).astype("<i2").tobytes()


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (host-side, scipy)."""
    if orig_sr == target_sr:
        return audio
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(orig_sr, target_sr)
    return resample_poly(audio, target_sr // g, orig_sr // g).astype(np.float32)


def normalize_peak(audio: np.ndarray) -> np.ndarray:
    """Peak-normalize with a silence guard."""
    peak = float(np.abs(audio).max()) if audio.size else 0.0
    if peak < 1e-8:
        return audio
    return np.clip(audio / (peak + 1e-7), -1.0, 1.0)


def decode_audio_bytes(raw: bytes, target_sr: int) -> np.ndarray:
    """Audio bytes (WAV in-process, anything else through ``ffmpeg``) → mono f32 at ``target_sr``.

    Downmixes by the channel mean and resamples, as the JAX package does.
    """
    try:
        samples, sr = read_wav_bytes(raw)
    except ValueError:
        # ffmpeg decodes straight to the target rate: no second resample
        samples, sr = _decode_via_ffmpeg(raw, target_sr)
    if samples.ndim > 1:
        samples = samples.mean(axis=1)
    if sr != target_sr:
        samples = resample(samples, sr, target_sr)
    return samples.astype(np.float32)


def _decode_via_ffmpeg(raw: bytes, target_sr: int = 48000) -> tuple[np.ndarray, int]:
    if shutil.which("ffmpeg") is None:
        raise ValueError("unsupported audio container and ffmpeg not available")
    proc = subprocess.run(
        ["ffmpeg", "-v", "quiet", "-i", "pipe:0", "-f", "f32le", "-ac", "1",
         "-ar", str(target_sr), "pipe:1"],
        input=raw, stdout=subprocess.PIPE, check=True,
    )
    return np.frombuffer(proc.stdout, dtype="<f4").copy(), target_sr


def trim_silence(
    audio: np.ndarray,
    top_db: float = 20.0,
    frame_length: int = 2048,
    hop_length: int = 512,
) -> np.ndarray:
    """Energy-based edge trim (``librosa.effects.trim`` semantics)."""
    if audio.size == 0:
        return audio
    if len(audio) >= frame_length:
        n_frames = max(1, 1 + (len(audio) - frame_length) // hop_length)
    else:
        n_frames = 1
    rms = np.empty(n_frames, dtype=np.float64)
    for i in range(n_frames):
        seg = audio[i * hop_length: i * hop_length + frame_length]
        rms[i] = np.sqrt(np.mean(seg.astype(np.float64) ** 2) + 1e-20)
    keep = 20.0 * np.log10(rms / rms.max()) > -top_db
    if not keep.any():
        return audio[:0]
    first, last = np.argmax(keep), len(keep) - 1 - np.argmax(keep[::-1])
    start = first * hop_length
    end = min(len(audio), last * hop_length + frame_length)
    return audio[start:end]
