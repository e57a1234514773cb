"""PyTorch port, log-mel: short and batched waveforms and the kernel's host tables.

The plain version (the CPU path of ``log_mel_fused``) against the JAX
package's ``log_mel_spectrogram``, ``log_mel_pallas`` in interpret mode and
``AudioProcessor.mel_spectrogram`` on the same numpy inputs; and the tables
``csrc/fused_mel.cu`` reads (FFT twiddles, the filterbank as runs of
non-zero bins), which are built on the host. The kernel itself is held
against the plain version on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oron_tts_tpu.ops.audio import AudioProcessor as JAudioProcessor
from oron_tts_tpu.ops.mel import MelConfig as JMelConfig
from oron_tts_tpu.ops.mel import log_mel_spectrogram as j_log_mel
from oron_tts_tpu.ops.pallas_mel import log_mel_pallas
from oron_tts_tpu_torch.ops.audio import AudioProcessor
from oron_tts_tpu_torch.ops.fused_mel import (
    KERNEL_N_FFT,
    _twiddles,
    fft_passes,
    log_mel_fused,
    sparse_filterbank,
)
from oron_tts_tpu_torch.ops.mel import MelConfig, mel_filterbank, reflect_index


def _audio(shape, seed=0):
    return (0.3 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("L", [1, 2, 3, 300, 512, 513, 1500])
def test_reflect_index_is_numpys_reflect(L):
    x = np.arange(L)
    np.testing.assert_array_equal(x[reflect_index(L, 512).numpy()], np.pad(x, 512, mode="reflect"))


# n_fft/2 = 512 samples or fewer: the pad reflects more than once
@pytest.mark.parametrize("L", [1, 300, 512, 513])
def test_log_mel_short_waveforms_match_jax(L):
    audio = _audio(L)
    out = log_mel_fused(torch.from_numpy(audio), MelConfig()).numpy()
    assert out.shape == (100, 1 + L // 256)
    np.testing.assert_allclose(out, np.asarray(j_log_mel(jnp.asarray(audio), JMelConfig())),
                               atol=1e-4)
    np.testing.assert_allclose(out, np.asarray(log_mel_pallas(audio, JMelConfig(), interpret=True)),
                               atol=1e-4)


@pytest.mark.parametrize("shape", [(1, 5000), (3, 5000), (2, 3, 24000)])
def test_audio_processor_batches_match_jax(shape):
    audio = _audio(shape, seed=1)
    out = AudioProcessor(device="cpu").mel_spectrogram(audio)
    ref = np.asarray(JAudioProcessor().mel_spectrogram(audio))
    assert out.shape == ref.shape
    assert out.shape == (shape[:-1] if shape[0] > 1 else ()) + (100, 1 + shape[-1] // 256)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)


def test_sparse_filterbank_rebuilds_the_dense_one():
    cfg = MelConfig()
    bands, weights = sparse_filterbank(cfg)
    dense = np.zeros_like(mel_filterbank(cfg))
    for m, (first, count, offset) in enumerate(bands.T):
        dense[first: first + count, m] = weights[offset: offset + count]
    np.testing.assert_array_equal(dense, mel_filterbank(cfg))
    assert bands.dtype == np.int32 and weights.size == int(bands[1].sum())


@pytest.mark.parametrize("n_fft", KERNEL_N_FFT)
def test_fft_tables_give_the_rfft(n_fft):
    # the kernel's arithmetic in float64 from its f32 table: Stockham passes
    # (each butterfly's inputs turned by the table, then a DFT of R points),
    # then the even/odd split of z[n] = x[2n] + i x[2n+1]
    m = n_fft // 2
    tw = _twiddles(n_fft).astype(np.float64)
    x = np.random.default_rng(2).standard_normal((3, n_fft))
    z, off = x[:, 0::2] + 1j * x[:, 1::2], 0
    for r_, ns in fft_passes(m):
        j = np.arange(m // r_)
        v = np.stack([z[:, j + r * (m // r_)] for r in range(r_)], axis=1)
        if ns > 1:
            for r in range(1, r_):
                idx = off + (r - 1) * ns + j % ns
                v[:, r] *= tw[0, idx] - 1j * tw[1, idx]
            off += (r_ - 1) * ns
        v = np.fft.fft(v, axis=1)
        base = (j // ns) * ns * r_ + j % ns
        for r in range(r_):
            z[:, base + r * ns] = v[:, r]
    k = np.arange(m // 2 + 1)
    a, c = z[:, k], np.conj(z[:, (m - k) % m])
    w = tw[0, off + k] - 1j * tw[1, off + k]
    assert tw.shape[1] == off + m // 2 + 1
    mag = np.empty((3, m + 1))
    mag[:, m - k] = np.abs((a + c) / 2 - w * (a - c) / 2j)
    mag[:, k] = np.abs((a + c) / 2 + w * (a - c) / 2j)
    # f32 twiddles: a few ulp of the largest bin
    np.testing.assert_allclose(mag, np.abs(np.fft.rfft(x)), atol=1e-5)
