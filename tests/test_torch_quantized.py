"""PyTorch port, int8 serving: quantization, both matmuls and the quantized DiT
against the JAX package on the CPU.

The port keeps a quantized weight as ``[N, K]`` (JAX: ``[K, N]``), so the
tests transpose when they compare integers. On the CPU the port's
``quantized_matmul`` takes its plain version; the JAX kernel runs in Pallas
interpret mode, as in ``tests/test_quantized.py``. The quantized DiT loads
the integers JAX's ``quantize_dit_params`` produced, through
``from_flax_params``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oron_tts_tpu.ops.quantized_matmul as jq
import oron_tts_tpu_torch.ops.quantized_matmul as tq
from oron_tts_tpu.models.dit import quantize_dit_params as j_quantize_dit_params
from oron_tts_tpu.models.f5tts import F5TTS as JF5TTS
from oron_tts_tpu.config import F5Config as JF5Config
from oron_tts_tpu.config import ModelConfig as JModelConfig
from oron_tts_tpu.models.layers import QDense as jl_QDense
from oron_tts_tpu_torch.models import layers as tl
from oron_tts_tpu_torch.models.dit import QUANT_TARGETS, DiT, quantize_dit_params
from oron_tts_tpu_torch.utils.weights import from_flax_params, to_flax_params

from test_torch_models import DEPTH, DIM, HEADS, TEXT_DIM, tiny_params

SHAPES = [(13, 96, 64), (8, 64, 128), (2, 256, 384)]


def _weight(k, n, seed=1, zero_cols=0):
    w = np.random.default_rng(seed).standard_normal((k, n)).astype(np.float32)
    w[:, :zero_cols] = 0.0
    return w


@pytest.mark.parametrize("k,n,zero_cols", [(96, 64, 3), (64, 128, 0), (256, 384, 1)])
def test_quantize_weight_bit_equal_to_jax(k, n, zero_cols):
    w = _weight(k, n, zero_cols=zero_cols)
    q_ref, s_ref = jq.quantize_weight(jnp.asarray(w))
    q, s = tq.quantize_weight(torch.from_numpy(w.T.copy()))  # the port's [N, K]
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (n,)
    np.testing.assert_array_equal(q.numpy().T, np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(s.numpy()[:zero_cols], 1.0)
    deq = tq.dequantize_weight(q, s, torch.float32)
    np.testing.assert_array_equal(
        deq.numpy().T, np.asarray(jq.dequantize_weight(q_ref, s_ref, jnp.float32)))
    assert float(deq[:zero_cols].abs().max() if zero_cols else 0.0) == 0.0


def test_quantize_weight_stacked_layout():
    w = _weight(96, 64, zero_cols=2)
    stacked = np.stack([w, 3.0 * w])
    q_ref, s_ref = jq.quantize_weight(jnp.asarray(stacked))
    q, s = tq.quantize_weight(torch.from_numpy(stacked.transpose(0, 2, 1).copy()))
    np.testing.assert_array_equal(q.numpy().transpose(0, 2, 1), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_quantized_matmul_f32_matches_jax_kernel_and_ref(m, k, n):
    x = np.random.default_rng(1).standard_normal((m, k)).astype(np.float32)
    q_ref, s_ref = jq.quantize_weight(jnp.asarray(_weight(k, n)))
    q, s = torch.from_numpy(np.asarray(q_ref).T.copy()), torch.from_numpy(np.array(s_ref))
    out = tq.quantized_matmul(torch.from_numpy(x), q, s)  # CPU: the plain version
    assert out.dtype == torch.float32 and out.shape == (m, n)
    np.testing.assert_array_equal(out.numpy(),
                                  tq.quantized_matmul_plain(torch.from_numpy(x), q, s).numpy())
    kernel = np.asarray(jq.quantized_matmul(jnp.asarray(x), q_ref, s_ref, interpret=True))
    ref = np.asarray(jq.quantized_matmul_ref(jnp.asarray(x), q_ref, s_ref))
    # f32 sums in another order: 1e-5 of the output's largest value
    tol = 1e-5 * float(np.abs(ref).max())
    assert float(np.abs(out.numpy() - kernel).max()) <= tol
    assert float(np.abs(out.numpy() - ref).max()) <= tol


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_quantized_matmul_bf16_within_one_ulp_of_jax(m, k, n):
    x = np.random.default_rng(2).standard_normal((m, k)).astype(np.float32)
    q_ref, s_ref = jq.quantize_weight(jnp.asarray(_weight(k, n)))
    q, s = torch.from_numpy(np.asarray(q_ref).T.copy()), torch.from_numpy(np.array(s_ref))
    out = tq.quantized_matmul(torch.from_numpy(x).to(torch.bfloat16), q, s)
    assert out.dtype == torch.bfloat16
    ref = np.asarray(jq.quantized_matmul_ref(jnp.asarray(x, jnp.bfloat16), q_ref, s_ref)
                     .astype(jnp.float32))
    # both accumulate in f32 and round once; the f32 sums differ in order, so
    # a value next to a rounding boundary may land one bf16 step apart
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert (np.abs(out.float().numpy() - ref) <= ulp).all()


def test_quantized_matmul_leading_dims_and_guards():
    x = np.random.default_rng(3).standard_normal((2, 5, 64)).astype(np.float32)
    q_ref, s_ref = jq.quantize_weight(jnp.asarray(_weight(64, 32)))
    q, s = torch.from_numpy(np.asarray(q_ref).T.copy()), torch.from_numpy(np.array(s_ref))
    out = tq.quantized_matmul(torch.from_numpy(x), q, s)
    assert out.shape == (2, 5, 32)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jq.quantized_matmul(jnp.asarray(x), q_ref, s_ref, interpret=True)),
        atol=1e-5)
    with pytest.raises(ValueError, match="int8"):
        tq.quantized_matmul(torch.from_numpy(x), q.float(), s)
    with pytest.raises(ValueError, match="do not fit"):
        tq.quantized_matmul(torch.from_numpy(x[..., :32]), q, s)
    with pytest.raises(ValueError, match="do not fit"):
        tq.quantized_matmul(torch.from_numpy(x), q, s[:-1])


@pytest.mark.parametrize("m,k,n", [(16, 128, 96), (40, 64, 128), (3, 96, 40)])
def test_w8a8_matmul_matches_jax(m, k, n):
    """(40, 64, 128) takes ``torch._int_mm``, the others the exact float64 route."""
    x = np.random.default_rng(4).standard_normal((m, k)).astype(np.float32)
    x[1] = 0.0  # an all-zero token: its scale is the 1e-8 floor
    q_ref, s_ref = jq.quantize_weight(jnp.asarray(_weight(k, n, zero_cols=1)))
    q, s = torch.from_numpy(np.asarray(q_ref).T.copy()), torch.from_numpy(np.array(s_ref))
    x_q, x_scale = tq.quantize_activations(torch.from_numpy(x))
    amax = jnp.max(jnp.abs(jnp.asarray(x)), axis=-1, keepdims=True)
    j_scale = jnp.maximum(amax, 1e-8) / 127.0
    j_xq = jnp.clip(jnp.round(jnp.asarray(x) / j_scale), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(x_q.numpy(), np.asarray(j_xq))
    acc = tq.int8_product(x_q, q)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(
        acc.numpy(), np.asarray(j_xq).astype(np.int64) @ np.asarray(q_ref).astype(np.int64))
    out = tq.w8a8_matmul(torch.from_numpy(x), q, s).numpy()
    ref = np.asarray(jq.w8a8_matmul(jnp.asarray(x), q_ref, s_ref))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6 * float(np.abs(ref).max()))


def _quantized_pair(mode):
    """The JAX backbone with ``quant=mode`` and the port's, holding the same integers."""
    jm = JF5TTS(JF5Config(model=JModelConfig(
        dim=DIM, depth=DEPTH, heads=HEADS, text_dim=TEXT_DIM, conv_layers=1)), dtype=jnp.float32)
    qparams = jax.device_get(j_quantize_dit_params(tiny_params()))
    backbone = jm.backbone.clone(quant=mode)
    dit = DiT(dim=DIM, depth=DEPTH, heads=HEADS, text_dim=TEXT_DIM, conv_layers=1,
              quant=mode).eval()
    dit.load_state_dict(from_flax_params(qparams), strict=True)
    return backbone, qparams, dit


# int8 repeats the plain model's arithmetic with exact integers, so it holds
# the unquantized parity tolerance; int8_dynamic rounds activations to int8,
# where an f32 difference of one ulp before the rounding can move a value by
# a whole step (1/127 of the token's largest), hence the wider bound
@pytest.mark.parametrize("mode,atol", [("int8", 2e-4), ("int8_dynamic", 2e-2)])
def test_quantized_dit_forward_matches_jax(mode, atol):
    backbone, qparams, dit = _quantized_pair(mode)
    rng = np.random.default_rng(7)
    B, T = 2, 48
    x = rng.standard_normal((B, T, 100)).astype(np.float32)
    cond = rng.standard_normal((B, T, 100)).astype(np.float32)
    ids = rng.integers(1, 60, size=(B, T)).astype(np.int32)
    ids[1, 35:] = -1
    t = np.asarray([0.2, 0.7], np.float32)
    mask = np.arange(T)[None, :] < np.asarray([T, 35])[:, None]
    ref = backbone.apply({"params": qparams}, jnp.asarray(x), jnp.asarray(cond),
                         jnp.asarray(ids), jnp.asarray(t), mask=jnp.asarray(mask))
    with torch.no_grad():
        out = dit(torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(ids),
                  torch.from_numpy(t), mask=torch.from_numpy(mask))
    assert all(isinstance(getattr(dit.block0.attn, n), tl.QDense)
               for n in ("to_q", "to_k", "to_v", "to_out"))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol)


def test_quantize_dit_params_swaps_the_six_projections_and_matches_jax_integers():
    dit = DiT(dim=DIM, depth=DEPTH, heads=HEADS, text_dim=TEXT_DIM, conv_layers=1).eval()
    dit.load_state_dict(from_flax_params(tiny_params()), strict=True)
    n_before = sum(t.numel() for t in dit.state_dict().values())
    quantize_dit_params(dit, "int8")
    swapped = sorted(name.rsplit(".", 1)[-1] for name, m in dit.named_modules()
                     if isinstance(m, tl.QDense))
    assert swapped == sorted(list(QUANT_TARGETS) * DEPTH)
    assert not any(isinstance(m, tl.QDense) for name, m in dit.named_modules()
                   if name.rsplit(".", 1)[-1] not in QUANT_TARGETS)
    # the same integers and scales as JAX's converter, and the tree crosses back
    ref = jax.device_get(j_quantize_dit_params(tiny_params()))
    tree = to_flax_params(dit.state_dict())
    for block in ("block0", "block1"):
        for group, names in (("attn", ("to_q", "to_k", "to_v", "to_out")),
                             ("ff", ("in_proj", "out_proj"))):
            for name in names:
                got, want = tree[block][group][name], ref[block][group][name]
                assert set(got) == {"kernel_q", "scale", "bias"}
                assert got["kernel_q"].dtype == np.int8
                np.testing.assert_array_equal(got["kernel_q"], want["kernel_q"])
                np.testing.assert_array_equal(got["scale"], want["scale"])
                np.testing.assert_array_equal(got["bias"], want["bias"])
    # scales add N values per projection; nothing else changes size
    n_after = sum(t.numel() for t in dit.state_dict().values())
    assert n_after == n_before + DEPTH * (4 * DIM + 4 * DIM + DIM)
    # a second call only switches the mode
    quantize_dit_params(dit, "int8_dynamic")
    assert dit.quant == "int8_dynamic" and dit.block1.ff.in_proj.mode == "int8_dynamic"
    with pytest.raises(ValueError, match="unknown quant mode"):
        quantize_dit_params(dit, "int4")


def test_make_dense_and_qdense_bias_in_output_type():
    assert isinstance(tl.make_dense(8, 4), torch.nn.Linear)
    layer = tl.make_dense(16, 8, "int8")
    assert isinstance(layer, tl.QDense) and layer.weight_q.shape == (8, 16)
    lin = torch.nn.Linear(16, 8)
    q = tl.QDense.from_linear(lin, "int8")
    x = torch.randn(3, 16, generator=torch.Generator().manual_seed(0))
    want = tq.quantized_matmul_plain(x, q.weight_q, q.scale) + lin.bias
    np.testing.assert_array_equal(q(x).detach().numpy(), want.detach().numpy())
    with pytest.raises(ValueError, match="unknown quant mode"):
        tl.QDense(4, 4, "int4")


# ── the bias in the w8a16 epilogue ──────────────────────────────────────


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_quantized_matmul_bias_is_the_jax_qdense_order(dtype, m, k, n):
    """``bias=`` gives the product rounded to x's dtype plus the bias in that
    dtype, bit for bit the unfused add, and the JAX ``QDense`` arithmetic
    (``quantized_matmul_ref`` then ``y + bias.astype(y.dtype)``)."""
    rng = np.random.default_rng(m + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    bias = (0.5 * rng.standard_normal(n)).astype(np.float32)
    q_ref, s_ref = jq.quantize_weight(jnp.asarray(_weight(k, n, zero_cols=2)))
    q, s = torch.from_numpy(np.asarray(q_ref).T.copy()), torch.from_numpy(np.array(s_ref))
    t_dtype, j_dtype = getattr(torch, dtype), getattr(jnp, dtype)
    tx, tb = torch.from_numpy(x).to(t_dtype), torch.from_numpy(bias)
    fused = tq.quantized_matmul(tx, q, s, bias=tb)
    unfused = tq.quantized_matmul(tx, q, s) + tb.to(t_dtype)
    assert fused.dtype == t_dtype and torch.equal(fused, unfused)
    assert torch.equal(tq.quantized_matmul_plain(tx, q, s, tb), fused)
    y_ref = jq.quantized_matmul_ref(jnp.asarray(x, j_dtype), q_ref, s_ref)
    ref = np.asarray((y_ref + jnp.asarray(bias).astype(y_ref.dtype)).astype(jnp.float32))
    # the zero channels are the bias exactly, rounded once to x's dtype
    np.testing.assert_array_equal(fused[:, :2].float().numpy(), ref[:, :2])
    got = fused.float().numpy()
    if dtype == "float32":
        assert float(np.abs(got - ref).max()) <= 1e-5 * float(np.abs(ref).max())
    else:
        # the product may land one bf16 step from JAX's (f32 sums in another
        # order); the add rounds once more, half a step of the sum
        y = np.abs(np.asarray(y_ref.astype(jnp.float32)))
        step = lambda a: 2.0 ** (np.floor(np.log2(np.maximum(a, 1e-30))) - 7)  # noqa: E731
        assert (np.abs(got - ref) <= step(y) + step(np.abs(ref))).all()
    with pytest.raises(ValueError, match="do not fit"):
        tq.quantized_matmul(tx, q, s, bias=tb[:-1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qdense_with_a_bias_matches_the_jax_module(dtype):
    """The port's ``QDense`` (int8) against the JAX ``QDense`` on the same
    integers, scale and bias: f32 within 1e-5 of the largest value, bf16
    within one bf16 step of each value."""
    rng = np.random.default_rng(11)
    k, n = 96, 40
    w = _weight(k, n, seed=5, zero_cols=1)
    bias = (0.3 * rng.standard_normal(n)).astype(np.float32)
    x = rng.standard_normal((3, 7, k)).astype(np.float32)
    q_ref, s_ref = jq.quantize_weight(jnp.asarray(w))
    j_dtype, t_dtype = getattr(jnp, dtype), getattr(torch, dtype)
    jmod = jl_QDense(features=n, dtype=j_dtype, mode="int8")
    ref = np.asarray(jmod.apply({"params": {"kernel_q": q_ref, "scale": s_ref,
                                            "bias": jnp.asarray(bias)}},
                                jnp.asarray(x, j_dtype)).astype(jnp.float32))
    layer = tl.QDense(k, n, "int8")
    layer.weight_q = torch.from_numpy(np.asarray(q_ref).T.copy())
    layer.scale = torch.from_numpy(np.array(s_ref))
    layer.bias = torch.nn.Parameter(torch.from_numpy(bias).to(t_dtype), requires_grad=False)
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).float().numpy()
    if dtype == "float32":
        assert float(np.abs(got - ref).max()) <= 1e-5 * float(np.abs(ref).max())
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        assert (np.abs(got - ref) <= ulp).all()
