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
    _inv_keep,
    _threshold,
    dropout_plain,
    gelu_dropout,
    gelu_dropout_bwd_plain,
    gelu_dropout_plain,
    hash_dropout,
    keep_mask_plain,
)
from oron_tts_tpu_torch.ops.grouped_conv import grouped_conv1d_mish_grad


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _qkv(seed, B, T, heads, n=3, dim_head=64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, heads * dim_head)).astype(np.float32) for _ in range(n)]


def _lse_to_port_layout(lse, heads):
    """JAX [B, H·D/128, 128/D, T] → the port's [B, H, T] (head = tile·2 + slot)."""
    lse = np.asarray(lse)
    return lse.reshape(lse.shape[0], heads, lse.shape[-1])


# the other head widths the JAX lanes rule admits (layers.py:489-492): D = 16
# and 128 with H·D a multiple of 128, and 3 heads of 40, 5 of 20 and 2 of 12
# (H·D <= 128); the first two cases are the D = 64 ones
WIDTH_CASES = [
    pytest.param(128, 2, [128, 91], 64, id="128-2-lens0"),
    pytest.param(256, 4, [256, 1], 64, id="256-4-lens1"),
    pytest.param(128, 8, [128, 77], 16, id="d16-h8"),
    pytest.param(128, 2, [128, 77], 128, id="d128-h2"),
    pytest.param(128, 3, [128, 77], 40, id="d40-h3"),
    pytest.param(128, 5, [128, 77], 20, id="d20-h5"),   # zero-padded to 24 on the card
    pytest.param(128, 2, [128, 77], 12, id="d12-h2"),   # ... and to 16
]


@pytest.mark.parametrize("T,heads,lens,dim_head", WIDTH_CASES)
def test_stats_forward_plain_matches_jax(T, heads, lens, dim_head):
    q, k, v = _qkv(0, 2, T, heads, dim_head=dim_head)
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


@pytest.mark.parametrize("T,heads,lens,dim_head", WIDTH_CASES)
def test_backward_plain_matches_jax_kernel(T, heads, lens, dim_head):
    q, k, v, dout = _qkv(1, 2, T, heads, n=4, dim_head=dim_head)
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


def _rows(B, T, lens):
    return torch.arange(T)[None, :] < torch.tensor(lens)[:, None]


def _old_hash_dropout(x, seed, rate, **place):
    """The attention output's dropout as the port had it: a bf16 scale, then a product."""
    keep = keep_mask_plain(x.numel(), seed, _threshold(rate), x.device, x.shape[-1],
                           **place).reshape(x.shape)
    return x * (keep.to(x.dtype) * _inv_keep(rate))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True], ids=["all_rows", "row_mask"])
def test_hash_dropout_function_forward_and_backward(dtype, masked):
    seed, rate, B, T, C = 77, 0.1, 3, 10, 48
    g = torch.Generator().manual_seed(3)
    x = torch.randn(B, T, C, generator=g).to(dtype).requires_grad_(True)
    dy = torch.randn(B, T, C, generator=g).to(dtype)
    rows = _rows(B, T, [10, 7, 1]) if masked else None
    y = hash_dropout(x, seed, rate, row0=20, rows=rows)
    assert torch.equal(y, dropout_plain(x.detach(), seed, rate, row0=20, rows=rows))
    (dx,) = torch.autograd.grad(y, x, dy)
    keep = keep_mask_plain(x.numel(), seed, _threshold(rate), "cpu", C, row0=20).reshape(x.shape)
    if masked:
        keep = keep & rows[..., None]
    want = torch.where(keep, dy.float() * torch.tensor(1 / (1 - rate)), 0.0).to(dtype)
    assert torch.equal(dx, want)
    if masked:
        assert not y[~rows].any() and not dx[~rows].any()
        assert y[rows].ne(0).float().mean() > 0.8


@pytest.mark.parametrize("shard", ["row", "column", "2x2"])
@pytest.mark.parametrize("masked", [False, True], ids=["all_rows", "row_mask"])
def test_hash_dropout_shards_draw_the_whole_calls_mask(shard, masked):
    """Shards placed by ``row0`` (data) and ``gcols``/``col0`` (tensor) concatenate
    to one call over the whole tensor, forward and backward."""
    seed, rate, R, C = 2**31 + 5, 0.3, 24, 64
    g = torch.Generator().manual_seed(4)
    x = torch.randn(R, C, generator=g).requires_grad_(True)
    dy = torch.randn(R, C, generator=g)
    rows = torch.rand(R, generator=g) < 0.7 if masked else None
    y = hash_dropout(x, seed, rate, rows=rows)
    (dx,) = torch.autograd.grad(y, x, dy)
    r_cut = {"row": [0, 12, 24], "column": [0, 24], "2x2": [0, 12, 24]}[shard]
    c_cut = {"row": [0, 64], "column": [0, 16, 64], "2x2": [0, 40, 64]}[shard]
    for r0, r1 in zip(r_cut, r_cut[1:]):
        for c0, c1 in zip(c_cut, c_cut[1:]):
            part = x.detach()[r0:r1, c0:c1].clone().requires_grad_(True)
            part_rows = None if rows is None else rows[r0:r1]
            yp = hash_dropout(part, seed, rate, row0=r0, gcols=C, col0=c0, rows=part_rows)
            (dxp,) = torch.autograd.grad(yp, part, dy[r0:r1, c0:c1])
            assert torch.equal(yp, y[r0:r1, c0:c1])
            assert torch.equal(dxp, dx[r0:r1, c0:c1])


def test_hash_dropout_rate_zero():
    x = torch.randn(2, 5, 8)
    assert hash_dropout(x, 1, 0.0) is x
    rows = _rows(2, 5, [5, 2])
    assert torch.equal(hash_dropout(x, 1, 0.0, rows=rows), x.masked_fill(~rows[..., None], 0.0))


@pytest.mark.parametrize("place", [dict(), dict(row0=3), dict(row0=2, gcols=40, col0=8)],
                         ids=["flat", "row0", "column_shard"])
def test_hash_dropout_f32_is_bit_equal_to_the_old_form(place):
    x = torch.randn(6, 9, 32, generator=torch.Generator().manual_seed(5))
    for rate in (0.1, 0.25):
        assert torch.equal(hash_dropout(x, -99, rate, **place),
                           _old_hash_dropout(x, -99, rate, **place))


def test_hash_dropout_bf16_scale_is_rounded_once():
    """bf16: ``x · (1/(1 − rate))`` in f32, rounded once; the old form rounded the
    scale to bf16 first (1.109375 for 1/0.9)."""
    x = torch.randn(4, 16, 64, generator=torch.Generator().manual_seed(6)).to(torch.bfloat16)
    seed, rate = 11, 0.1
    keep = keep_mask_plain(x.numel(), seed, _threshold(rate), "cpu", 64).reshape(x.shape)
    exact = torch.where(keep, x.double() / (1 - rate), 0.0)
    new, old = hash_dropout(x, seed, rate), _old_hash_dropout(x, seed, rate)
    assert torch.equal(new, exact.float().to(torch.bfloat16))
    assert (new.double() - exact).abs().sum() < (old.double() - exact).abs().sum()
    assert not torch.equal(new, old)


def test_attention_drops_out_and_zeroes_padded_rows():
    from oron_tts_tpu_torch.models.layers import Attention

    torch.manual_seed(7)
    attn = Attention(64, 2, 32, dropout=0.1, attn_impl="lanes")
    B, T = 3, 12
    x = torch.randn(B, T, 64)
    mask = _rows(B, T, [12, 5, 1])
    lens = mask.sum(-1, dtype=torch.int32)
    with torch.no_grad():
        plain = attn(x, kv_lens=lens)  # neither dropout nor re-mask
        y0 = attn(x, mask=mask)
        y = attn(x, mask=mask, seed=123, batch0=4)
    # without a seed: padded rows zeroed, nothing dropped
    assert torch.equal(y0, plain.masked_fill(~mask[..., None], 0.0))
    # with one: the old dropout and re-mask, one after the other, in f32
    want = _old_hash_dropout(plain, 123, 0.1, row0=4 * T).masked_fill(~mask[..., None], 0.0)
    assert torch.equal(y, want)


def test_sampler_never_reaches_the_dropout(monkeypatch):
    from oron_tts_tpu_torch.models import layers
    from test_torch_batch import DURATIONS, LENS, _sample_inputs
    from test_torch_slice import _port_model

    def refuse(*args, **kwargs):
        raise AssertionError("the sampler called hash_dropout")

    monkeypatch.setattr(layers, "hash_dropout", refuse)
    model = _port_model()
    cond, ids, noise = _sample_inputs()
    mel, _ = model.cfm.sample(torch.from_numpy(cond), torch.from_numpy(ids),
                              torch.from_numpy(DURATIONS), torch.from_numpy(LENS), steps=2,
                              noise=torch.from_numpy(noise))
    assert torch.isfinite(mel).all()


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
