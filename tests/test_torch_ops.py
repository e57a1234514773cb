"""PyTorch port, kernel modules: plain versions vs the JAX package on the CPU.

Each CUDA kernel's wrapper takes its plain version for CPU tensors; these
tests feed the same numpy inputs to that path and to the JAX function (its
Pallas kernel in interpret mode, or its plain reference). The kernels
themselves are held against the plain versions on the card by
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oron_tts_tpu.ops.flash_attention import flash_attention_lanes
from oron_tts_tpu.ops.grouped_conv import _conv_mish_ref, grouped_conv1d_pallas
from oron_tts_tpu.ops.mel import MelConfig as JMelConfig
from oron_tts_tpu.ops.mel import log_mel_numpy, mel_filterbank as j_filterbank
from oron_tts_tpu.ops.pallas_mel import log_mel_pallas
from oron_tts_tpu.ops.stft import istft_real as j_istft_real
from oron_tts_tpu_torch.ops.flash_attention import flash_lanes_fwd, flash_lanes_plain
from oron_tts_tpu_torch.ops.fused_mel import log_mel_fused
from oron_tts_tpu_torch.ops.grouped_conv import grouped_conv1d_mish, grouped_conv1d_mish_plain
from oron_tts_tpu_torch.ops.mel import MelConfig, mel_filterbank
from oron_tts_tpu_torch.ops.stft import istft_real

CFG = MelConfig()


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("T,heads", [(128, 2), (256, 4)])
def test_attention_plain_matches_jax_lanes(T, heads):
    rng = np.random.default_rng(0)
    B, D = 2, 64
    q, k, v = (rng.standard_normal((B, T, heads * D)).astype(np.float32) for _ in range(3))
    lens = np.asarray([T, T - 37], np.int32)
    ref = np.asarray(flash_attention_lanes(q, k, v, jnp.asarray(lens), heads, True))
    out = flash_lanes_fwd(_t(q), _t(k), _t(v), _t(lens), heads)
    assert out.dtype == torch.float32 and out.shape == (B, T, heads * D)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)


def test_attention_all_keys_masked_gives_uniform_weights():
    # kv_len 0: every key at -1e30, so every key weighs the same (TPU semantics)
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((1, 64, 128)).astype(np.float32) for _ in range(3))
    out = flash_lanes_plain(_t(q), _t(k), _t(v), torch.tensor([0]), 2).numpy()
    np.testing.assert_allclose(out, np.broadcast_to(v.mean(axis=1, keepdims=True), out.shape),
                               atol=1e-5)


# group widths 64 (Base) and, with 16 groups and 31 taps, each other width
# the wgmma kernel takes: 16, 32 (Small) and 128
@pytest.mark.parametrize("C,G,K,T", [(256, 4, 7, 24), (1024, 16, 31, 40), (256, 16, 31, 20),
                                     (512, 16, 31, 20), (2048, 16, 31, 20)])
def test_grouped_conv_plain_matches_jax_pallas(C, G, K, T):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    w = (0.05 * rng.standard_normal((K, C // G, C))).astype(np.float32)
    b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    ref = np.asarray(grouped_conv1d_pallas(x, w, b, G, True, True))
    np.testing.assert_allclose(
        np.asarray(_conv_mish_ref(x, w, b, G, True)), ref, atol=1e-5
    )
    out = grouped_conv1d_mish(_t(x), _t(w), _t(b), G)
    assert out.shape == (2, T, C)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_grouped_conv_plain_keeps_input_dtype():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((1, 16, 128)).astype(np.float32))
    w = torch.from_numpy((0.1 * rng.standard_normal((5, 32, 128))).astype(np.float32))
    b = torch.zeros(128)
    y16 = grouped_conv1d_mish_plain(x.bfloat16(), w, b, 4)
    assert y16.dtype == torch.bfloat16
    y32 = grouped_conv1d_mish_plain(x.bfloat16().float(), w, b, 4)
    np.testing.assert_allclose(y16.float().numpy(), y32.numpy(), atol=2e-2)



def test_bench_conv_runs_on_the_cpu(capsys):
    from oron_tts_tpu_torch.cli import bench_conv

    rows = bench_conv.main(["--device", "cpu", "--iters", "1", "--shapes", "small"])
    assert [r["shape"] for r in rows] == ["small"] and rows[0]["x"] == [2, 83, 512]
    assert rows[0]["ms"] > 0 and rows[0]["card"] == "cpu" and "graph_ms" not in rows[0]
    assert '"shape": "small"' in capsys.readouterr().out

def test_filterbank_matches_jax():
    np.testing.assert_array_equal(mel_filterbank(CFG), j_filterbank(JMelConfig()))


@pytest.mark.parametrize("n", [24000, 30001, 4096])
def test_log_mel_plain_matches_jax_pallas_and_numpy(n):
    rng = np.random.default_rng(0)
    audio = (0.3 * rng.standard_normal(n)).astype(np.float32)
    out = log_mel_fused(_t(audio), CFG).numpy()
    assert out.shape == (100, 1 + n // 256)
    np.testing.assert_allclose(out, log_mel_numpy(audio, JMelConfig()), atol=1e-4)
    mel_p = np.asarray(log_mel_pallas(audio, JMelConfig(), interpret=True))
    np.testing.assert_allclose(out, mel_p, atol=1e-4)


def test_log_mel_silence_hits_floor():
    out = log_mel_fused(torch.zeros(8192), CFG).numpy()
    np.testing.assert_allclose(out, np.log(1e-5), atol=1e-5)


@pytest.mark.parametrize("normalized,padding", [(False, "same"), (True, "center")])
def test_istft_real_matches_jax(normalized, padding):
    rng = np.random.default_rng(4)
    B, F_, T = 2, 513, 40
    re = rng.standard_normal((B, F_, T)).astype(np.float32)
    im = rng.standard_normal((B, F_, T)).astype(np.float32)
    lens = np.asarray([T, 27], np.int32)
    # the vocoder zeroes pad frames, whose envelope would otherwise be ~eps
    valid = np.arange(T)[None, None, :] < lens[:, None, None]
    re, im = re * valid, im * valid
    ref = np.asarray(j_istft_real(re, im, 1024, 256, normalized=normalized,
                                  padding=padding, lens=jnp.asarray(lens)))
    out = istft_real(_t(re), _t(im), 1024, 256, normalized=normalized,
                     padding=padding, lens=_t(lens)).numpy()
    assert out.shape == ref.shape
    # each row's first lens·hop samples are what a decode keeps; past them
    # the envelope tends to 0 and only amplifies rounding
    for row, n in enumerate(lens * 256):
        np.testing.assert_allclose(out[row, :n], ref[row, :n], atol=1e-5)
    ref_full = np.asarray(j_istft_real(re, im, 1024, 256, padding=padding))
    out_full = istft_real(_t(re), _t(im), 1024, 256, padding=padding).numpy()
    np.testing.assert_allclose(out_full, ref_full, atol=1e-5)
