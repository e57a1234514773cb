"""PyTorch port, classic-layout attention kernels against the JAX package.

The plain versions of kernels 6, 7, 8 and 12 (``ops/flash_attention.py``:
``flash_attention``, its backward, ``flash_attention_packed`` and
``flash_nosm``) against the JAX kernels run in interpret mode, as
``tests/test_flash_attention.py`` and ``test_flash_backward.py`` run them;
the two repairs of this slice (the lanes kernels at head width 32 and the
position-embedding conv's route at the Small and test widths); the attention
bench on the CPU. Inputs come from numpy seeds; everything runs in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oron_tts_tpu.models import layers as jl
from oron_tts_tpu.ops import flash_attention as jfa
from oron_tts_tpu_torch.models import layers as tl
from oron_tts_tpu_torch.ops import flash_attention as tfa
from oron_tts_tpu_torch.utils.weights import from_flax_params

ATOL = 2e-5


def _qkv(shape, seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _lens(kind, B, T):
    return {"masked": np.asarray([T, T - 37][:B], np.int32),
            "empty_row": np.asarray([T - 37, 0][:B], np.int32),
            "unmasked": None}[kind]


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# ── kernel 6: the classic forward ───────────────────────────────────────


@pytest.mark.parametrize("T,block_k,D,kind,use_exp2", [
    (128, None, 64, "masked", True),
    (128, None, 64, "unmasked", True),
    (128, None, 64, "empty_row", True),
    (128, None, 64, "masked", False),
    (128, None, 32, "masked", True),
    (128, None, 48, "empty_row", True),
    (384, None, 48, "masked", True),
    (384, 128, 64, "masked", True),     # the JAX streaming (online softmax) path
    (384, 128, 64, "empty_row", True),
    (384, 128, 32, "unmasked", False),
])
def test_flash_attention_plain_matches_jax_kernel(T, block_k, D, kind, use_exp2):
    B, H = 2, 2
    q, k, v = _qkv((B, H, T, D), seed=T + D)
    lens = _lens(kind, B, T)
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_lens=_j(lens),
                              block_k=block_k, interpret=True, use_exp2=use_exp2)
    out = tfa.flash_attention(_t(q), _t(k), _t(v), kv_lens=_t(lens), use_exp2=use_exp2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_flash_attention_reduces_a_prefix_mask_to_lengths():
    q, k, v = _qkv((2, 2, 64, 32), seed=3)
    mask = np.arange(64)[None, :] < np.asarray([64, 20])[:, None]
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              kv_mask=jnp.asarray(mask), interpret=True)
    out = tfa.flash_attention(_t(q), _t(k), _t(v), kv_mask=_t(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_empty_row_averages_every_key():
    q, k, v = _qkv((1, 2, 64, 32), seed=4)
    out = tfa.flash_attention(_t(q), _t(k), _t(v), kv_lens=torch.tensor([0]))
    np.testing.assert_allclose(out.numpy(), np.broadcast_to(v.mean(axis=2, keepdims=True),
                                                             v.shape), atol=1e-6)


# ── kernel 8: the packed forward ────────────────────────────────────────


@pytest.mark.parametrize("H,kind", [(4, "masked"), (4, "unmasked"), (3, "masked")])
def test_flash_attention_packed_plain_matches_jax_kernel(H, kind):
    B, T, D = 2, 128, 64
    q, k, v = _qkv((B, H, T, D), seed=H)
    lens = _lens(kind, B, T)
    ref = jfa.flash_attention_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     kv_lens=_j(lens), interpret=True)
    before = tfa.flash_attention.launches, tfa.flash_attention_packed.launches
    out = tfa.flash_attention_packed(_t(q), _t(k), _t(v), kv_lens=_t(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    # CPU tensors take the plain versions: no launch is counted
    assert (tfa.flash_attention.launches, tfa.flash_attention_packed.launches) == before


def test_flash_attention_packed_refuses_a_gradient():
    q, k, v = (torch.randn(1, 2, 16, 32, requires_grad=True) for _ in range(3))
    with pytest.raises(RuntimeError, match="no backward"):
        tfa.flash_attention_packed(q, k, v)
    with torch.no_grad():
        assert tfa.flash_attention_packed(q, k, v).shape == q.shape


# ── kernel 7: the classic backward ──────────────────────────────────────


@pytest.mark.parametrize("D", [32, 64])
def test_flash_attention_gradients_match_jax_grad(D):
    B, H, T = 2, 2, 128
    q, k, v, probe = _qkv((B, H, T, D), seed=10 + D, n=4)
    lens = np.asarray([T - 37, 0], np.int32)  # the second row has every key masked

    def j_loss(q_, k_, v_):
        out = jfa.flash_attention_trainable(q_, k_, v_, jnp.asarray(lens), True)
        return jnp.sum(out * probe)

    j_grads = jax.grad(j_loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = tfa.flash_attention_trainable(tq, tk, tv, _t(lens))
    (out * _t(probe)).sum().backward()
    for got, ref, name in zip((tq.grad, tk.grad, tv.grad), j_grads, "qkv"):
        ref = np.asarray(ref)
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got.numpy() / scale, ref / scale, atol=2e-4,
                                   err_msg=f"d{name}")
        # the kv_len = 0 row gets the JAX kernel's non-zero gradients
        assert np.abs(got.numpy()[1]).max() > 1e-3 and np.abs(ref[1]).max() > 1e-3


def test_flash_attention_trainable_defaults_lengths_to_t():
    q, k, v = (torch.randn(1, 2, 32, 32, requires_grad=True) for _ in range(3))
    a = tfa.flash_attention_trainable(q, k, v)
    b = tfa.flash_attention_trainable(q, k, v, torch.tensor([32]))
    torch.testing.assert_close(a, b)
    torch.testing.assert_close(a, tfa.flash_attention(q, k, v))


# ── kernel 12: the bench's no-softmax split ─────────────────────────────


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_flash_nosm_plain_matches_the_jax_formula(dtype):
    """``_nosm_kernel`` is a closure inside ``scripts/bench_attention.py``'s
    ``main()`` and cannot be imported, so its body is written out here."""
    B, H, T, D = 2, 2, 128, 64
    q, k, v = (jnp.asarray(x, dtype) for x in _qkv((B, H, T, D), seed=12))

    def nosm(q_, k_, v_):
        s = jax.lax.dot_general(q_, k_, (((1,), (1,)), ((), ())),
                                preferred_element_type=jnp.float32)
        acc = jax.lax.dot((s * (1.0 / T)).astype(v_.dtype), v_,
                          preferred_element_type=jnp.float32)
        return acc.astype(q_.dtype)

    ref = np.asarray(jax.vmap(nosm)(q.reshape(B * H, T, D), k.reshape(B * H, T, D),
                                    v.reshape(B * H, T, D)).astype(jnp.float32)).reshape(B, H, T, D)
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt) for x in (q, k, v))
    out = tfa.flash_nosm(tq, tk, tv).float().numpy()
    # bf16: the same rounded P and one output rounding on each side
    atol = 1e-5 if dtype == np.float32 else 2.0 ** -8 * np.abs(ref).max()
    np.testing.assert_allclose(out, ref, atol=atol)


# ── repairs: lanes at head width 32, the conv's route ───────────────────


def test_lanes_plain_at_head_width_32_matches_jax_kernel():
    B, T, H, D = 2, 64, 2, 32
    q, k, v, probe = _qkv((B, T, H * D), seed=32, n=4)
    lens = np.asarray([T, T - 11], np.int32)
    ref = jfa.flash_attention_lanes(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(lens), H, True)
    np.testing.assert_allclose(tfa.flash_lanes_plain(_t(q), _t(k), _t(v), _t(lens), H).numpy(),
                               np.asarray(ref), atol=ATOL)
    j_grads = jax.grad(lambda *a: jnp.sum(jfa.flash_attention_lanes(
        *a, jnp.asarray(lens), H, True) * probe), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    (tfa.flash_attention_lanes(tq, tk, tv, _t(lens), H) * _t(probe)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), j_grads):
        scale = np.abs(np.asarray(ref)).max()
        np.testing.assert_allclose(got.numpy() / scale, np.asarray(ref) / scale, atol=2e-4)


@pytest.mark.parametrize("dim,route", [(512, "kernel"), (64, "library")])
def test_conv_position_embedding_routes_like_jax(dim, route):
    """dim 512 (the Small config, group width 32): the JAX package runs its
    Pallas conv and the port its kernel; dim 64 (configs/test.yaml, width 4):
    both hand the shape to the library's grouped conv."""
    B, T = 2, 48
    rng = np.random.default_rng(dim)
    x = rng.standard_normal((B, T, dim)).astype(np.float32)
    mask = np.arange(T)[None, :] < np.asarray([T, T - 9])[:, None]
    jmod = jl.ConvPositionEmbedding(dim, impl="pallas")
    with pytest.MonkeyPatch.context() as mp:
        if route == "kernel":
            # the JAX Pallas conv runs on the CPU in interpret mode only
            from oron_tts_tpu.ops import grouped_conv as jgc

            real = jgc.grouped_conv1d_pallas
            mp.setattr(jgc, "grouped_conv1d_pallas",
                       lambda x_, k_, b_, groups, fuse_mish=False, interpret=False:
                       real(x_, k_, b_, groups, fuse_mish, True))
        params = jmod.init(jax.random.PRNGKey(0), x[:, :8], None)["params"]
        params = jax.tree_util.tree_map(
            lambda a: np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32),
            params)
        ref = jmod.apply({"params": params}, x, jnp.asarray(mask))
    port = tl.ConvPositionEmbedding(dim)
    port.load_state_dict(from_flax_params(jax.device_get(params)), strict=True)
    assert port.route == tl.conv_route(dim, 16) == route
    out = port(_t(x), _t(mask))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-4)


def test_conv_route_follows_the_jax_rule():
    assert tl.conv_route(1024, 16) == "kernel"   # Base, width 64
    assert tl.conv_route(512, 16) == "kernel"    # Small, width 32
    assert tl.conv_route(128, 16) == "kernel"    # width 8: the bf16 kernel raises on it
    assert tl.conv_route(64, 16) == "library"    # test config, dim % 128 != 0
    assert tl.conv_route(768, 16) == "library"   # width 48 does not divide 128


# ── the bench entry point ───────────────────────────────────────────────


def test_bench_attention_runs_on_the_cpu(capsys):
    from oron_tts_tpu_torch.cli import bench_attention

    res = bench_attention.main(["--device", "cpu", "--t", "128", "--iters", "1", "--h", "2",
                                "--backward"])
    err = capsys.readouterr()
    assert "# best:" in err.err
    assert "flash_nosm kernel (no softmax)" in err.out and "flash fwd+bwd (grads)" in err.out
    assert len(res) == 8 and all(v > 0 for v in res.values())
