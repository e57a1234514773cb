"""PyTorch port, the training kernels' plain versions vs the JAX package (CPU).

The stats forward, the attention backward and the fused GELU+dropout pair
each have a plain PyTorch version that the wrappers (and the autograd
Functions around them) take for CPU tensors. The same numpy inputs go
through those and through the JAX package's Pallas kernels in interpret
mode. The CUDA kernels are held against the plain versions on the card by
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oron_tts_tpu.ops.flash_attention import (
    _flash_lanes_bwd_call,
    _flash_lanes_fwd_stats_call,
    flash_attention_lanes as j_flash_attention_lanes,
)
from oron_tts_tpu.ops.gelu_dropout import _keep_mask, _threshold as j_threshold
from oron_tts_tpu.ops.gelu_dropout import gelu_dropout as j_gelu_dropout
from oron_tts_tpu.ops.grouped_conv import _conv_mish_ref
from oron_tts_tpu_torch.ops.flash_attention import (
    flash_attention_lanes,
    flash_lanes_bwd,
    flash_lanes_bwd_plain,
    flash_lanes_fwd,
    flash_lanes_fwd_stats,
    flash_lanes_fwd_stats_plain,
    flash_lanes_plain,
)
from oron_tts_tpu_torch.ops.gelu_dropout import (
    _threshold,
    gelu_dropout,
    gelu_dropout_bwd_plain,
    gelu_dropout_plain,
    hash_dropout,
    keep_mask_plain,
)
from oron_tts_tpu_torch.ops.grouped_conv import grouped_conv1d_mish_grad


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _qkv(seed, B, T, heads, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, heads * 64)).astype(np.float32) for _ in range(n)]


def _lse_to_port_layout(lse, heads):
    """JAX [B, H·D/128, 128/D, T] → the port's [B, H, T] (head = tile·2 + slot)."""
    lse = np.asarray(lse)
    return lse.reshape(lse.shape[0], heads, lse.shape[-1])


ATTN_CASES = [(128, 2, [128, 91]), (256, 4, [256, 1])]


@pytest.mark.parametrize("T,heads,lens", ATTN_CASES)
def test_stats_forward_plain_matches_jax(T, heads, lens):
    q, k, v = _qkv(0, 2, T, heads)
    lens = np.asarray(lens, np.int32)
    j_out, j_lse = _flash_lanes_fwd_stats_call(q, k, v, jnp.asarray(lens), heads, interpret=True)
    out, lse = flash_lanes_fwd_stats(_t(q), _t(k), _t(v), _t(lens), heads)
    assert lse.shape == (2, heads, T) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), _lse_to_port_layout(j_lse, heads), atol=1e-4)
    # the stats forward's output is the plain forward's, bit for bit
    assert torch.equal(out, flash_lanes_plain(_t(q), _t(k), _t(v), _t(lens), heads))
    assert torch.equal(out, flash_lanes_fwd(_t(q), _t(k), _t(v), _t(lens), heads))


def test_stats_forward_row_without_keys():
    # kv_len 0 is outside training; the port documents lse2 = log2 T there
    q, k, v = _qkv(5, 1, 64, 2)
    out, lse = flash_lanes_fwd_stats_plain(_t(q), _t(k), _t(v), torch.tensor([0]), 2)
    np.testing.assert_allclose(lse.numpy(), np.log2(64.0), atol=1e-6)
    np.testing.assert_allclose(
        out.numpy(), np.broadcast_to(v.mean(axis=1, keepdims=True), v.shape), atol=1e-5)


@pytest.mark.parametrize("T,heads,lens", ATTN_CASES)
def test_backward_plain_matches_jax_kernel(T, heads, lens):
    q, k, v, dout = _qkv(1, 2, T, heads, n=4)
    lens = np.asarray(lens, np.int32)
    j_out, j_lse = _flash_lanes_fwd_stats_call(q, k, v, jnp.asarray(lens), heads, interpret=True)
    j_grads = _flash_lanes_bwd_call(q, k, v, jnp.asarray(lens), j_out, dout, j_lse, heads,
                                    interpret=True)
    out, lse = flash_lanes_fwd_stats_plain(_t(q), _t(k), _t(v), _t(lens), heads)
    grads = flash_lanes_bwd(_t(q), _t(k), _t(v), _t(lens), out, _t(dout), lse, heads)
    for got, ref in zip(grads, j_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4)
    # keys past kv_len receive exactly nothing
    assert not grads[1][1, lens[1]:].any() and not grads[2][1, lens[1]:].any()


def test_backward_plain_matches_jax_grad():
    T, heads = 128, 2
    q, k, v, w = _qkv(2, 2, T, heads, n=4)
    lens = np.asarray([T, T - 50], np.int32)

    def j_loss(q, k, v):
        return jnp.sum(j_flash_attention_lanes(q, k, v, jnp.asarray(lens), heads, True) * w)

    j_grads = jax.grad(j_loss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    (flash_attention_lanes(tq, tk, tv, _t(lens), heads) * _t(w)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), j_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4)


def test_attention_function_matches_autograd_of_plain():
    T, heads = 96, 2
    q, k, v, w = _qkv(3, 3, T, heads, n=4)
    lens = _t(np.asarray([96, 40, 7], np.int32))
    grads = []
    for fn in (flash_attention_lanes, flash_lanes_plain):
        tq, tk, tv = (_t(x).clone().requires_grad_(True) for x in (q, k, v))
        (fn(tq, tk, tv, lens, heads) * _t(w)).sum().backward()
        grads.append((tq.grad, tk.grad, tv.grad))
    for got, ref in zip(*grads):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5)
    # without a gradient the Function is the plain forward kernel's path
    with torch.no_grad():
        assert torch.equal(flash_attention_lanes(_t(q), _t(k), _t(v), lens, heads),
                           flash_lanes_plain(_t(q), _t(k), _t(v), lens, heads))


def test_backward_plain_rounds_like_the_kernel_in_bf16():
    # ds and p are rounded to the input type before the three products
    T, heads = 64, 1
    q, k, v, dout = (_t(x).bfloat16() for x in _qkv(4, 1, T, heads, n=4))
    lens = torch.tensor([50], dtype=torch.int32)
    out, lse = flash_lanes_fwd_stats_plain(q, k, v, lens, heads)
    lo = flash_lanes_bwd_plain(q, k, v, lens, out, dout, lse, heads)
    hi = flash_lanes_bwd_plain(q.float(), k.float(), v.float(), lens, out.float(),
                               dout.float(), lse, heads)
    for a, b in zip(lo, hi):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), b.numpy(), atol=3e-2)


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_dropout_plain_matches_jax(rate, dtype):
    rng = np.random.default_rng(6)
    x32 = (2.0 * rng.standard_normal((6, 8, 32))).astype(np.float32)
    dy32 = rng.standard_normal((6, 8, 32)).astype(np.float32)
    seed = -123456789
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jdy = jnp.asarray(x32).astype(jdt), jnp.asarray(dy32).astype(jdt)
    j_y, vjp = jax.vjp(lambda a: j_gelu_dropout(a, jnp.int32(seed), rate, True), jx)
    (j_dx,) = vjp(jdy)
    tx, tdy = _t(x32).to(tdt), _t(dy32).to(tdt)
    y = gelu_dropout_plain(tx, seed, rate)
    dx = gelu_dropout_bwd_plain(tx, tdy, seed, rate)
    tol = 1e-5 if dtype == "float32" else 4e-2  # bf16: one rounding of values up to ~8
    np.testing.assert_allclose(y.float().numpy(), np.asarray(j_y.astype(jnp.float32)), atol=tol)
    np.testing.assert_allclose(dx.float().numpy(), np.asarray(j_dx.astype(jnp.float32)), atol=tol)
    # the mask, element for element, against the JAX package's own hash
    if rate:
        thr = j_threshold(rate)
        assert thr == _threshold(rate)
        j_keep = np.asarray(_keep_mask(jnp.int32(seed), jnp.int32(0), (48, 32), 32, thr))
        keep = keep_mask_plain(48 * 32, seed, thr, "cpu").numpy().reshape(48, 32)
        np.testing.assert_array_equal(keep, j_keep)
        pos = np.abs(x32) + 0.5  # gelu > 0, so a zero is a dropped element
        j_zero = np.asarray(j_gelu_dropout(jnp.asarray(pos), jnp.int32(seed), rate, True)) == 0
        np.testing.assert_array_equal(gelu_dropout_plain(_t(pos), seed, rate).numpy() == 0, j_zero)
        np.testing.assert_array_equal(j_zero.reshape(48, 32), ~j_keep)


def test_gelu_dropout_function_autograd_and_seeds():
    rng = np.random.default_rng(7)
    x = _t(rng.standard_normal((4, 16, 64)).astype(np.float32)).requires_grad_(True)
    dy = _t(rng.standard_normal((4, 16, 64)).astype(np.float32))
    y = gelu_dropout(x, 42, 0.1)
    (dx,) = torch.autograd.grad(y, x, dy)
    assert torch.equal(dx, gelu_dropout_bwd_plain(x.detach(), dy, 42, 0.1))
    assert torch.equal(y, gelu_dropout(x, 42, 0.1))            # a function of the seed
    assert not torch.equal(y == 0, gelu_dropout(x, 43, 0.1) == 0)
    # rate 0 is plain GELU, and its gradient is GELU's
    x2 = x.detach().clone().requires_grad_(True)
    ref = torch.nn.functional.gelu(x2, approximate="tanh")
    (ref_dx,) = torch.autograd.grad(ref, x2, dy)
    y0 = gelu_dropout(x, 1, 0.0)
    (dx0,) = torch.autograd.grad(y0, x, dy)
    np.testing.assert_allclose(y0.detach().numpy(), ref.detach().numpy(), atol=1e-6)
    np.testing.assert_allclose(dx0.numpy(), ref_dx.numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="rate"):
        gelu_dropout_plain(x.detach(), 0, 1.0)


def test_hash_dropout_shares_the_mask():
    x = torch.ones(8, 16, 32)
    y = hash_dropout(x, 9, 0.25)
    keep = keep_mask_plain(x.numel(), 9, _threshold(0.25), "cpu").reshape(x.shape)
    assert torch.equal(y != 0, keep)
    np.testing.assert_allclose(y[keep].numpy(), 1 / 0.75, rtol=1e-6)
    assert 0.2 < (~keep).float().mean() < 0.3
    assert hash_dropout(x, 9, 0.0) is x


@pytest.mark.parametrize("C,G,K,T", [(256, 4, 7, 24), (128, 2, 31, 40)])
def test_conv_function_gradients_match_jax_vjp(C, G, K, T):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    w = (0.05 * rng.standard_normal((K, C // G, C))).astype(np.float32)
    b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    g = rng.standard_normal((2, T, C)).astype(np.float32)
    j_y, vjp = jax.vjp(lambda a, c, d: _conv_mish_ref(a, c, d, G, True), x, w, b)
    j_grads = vjp(jnp.asarray(g))
    tx, tw, tb = (_t(a).requires_grad_(True) for a in (x, w, b))
    y = grouped_conv1d_mish_grad(tx, tw, tb, G)
    grads = torch.autograd.grad(y, (tx, tw, tb), _t(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(j_y), atol=1e-5)
    for got, ref in zip(grads, j_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
