"""PyTorch port, model modules: each against its flax counterpart on the CPU.

A tiny DiT (dim 128, heads 2, depth 2, text_dim 64, one ConvNeXt block)
is initialised by the JAX package, every parameter is perturbed so none is
zero (JAX zero-initialises the AdaLN projections and ``proj_out``), and
the tree is carried into the port with ``from_flax_params``. Inputs come
from numpy; both sides run in f32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oron_tts_tpu.config import F5Config as JF5Config
from oron_tts_tpu.config import ModelConfig as JModelConfig
from oron_tts_tpu.models import layers as jl
from oron_tts_tpu.models.dit import precompute_t_mods as j_precompute_t_mods
from oron_tts_tpu.models.f5tts import F5TTS as JF5TTS
from oron_tts_tpu.models.text_embed import TextEmbedding as JTextEmbedding
from oron_tts_tpu.models.vocos import VocosDecoder as JVocos
from oron_tts_tpu.train.checkpoint import load_pytree_npz
from oron_tts_tpu_torch.models import layers as tl
from oron_tts_tpu_torch.models.dit import DiT
from oron_tts_tpu_torch.models.f5tts import BUNDLED_VOCODER
from oron_tts_tpu_torch.models.text_embed import TextEmbedding
from oron_tts_tpu_torch.models.vocos import VocosDecoder
from oron_tts_tpu_torch.utils.weights import from_flax_params, load_npz_tree

DIM, HEADS, DEPTH, TEXT_DIM, T = 128, 2, 2, 64, 48
ATOL = 1e-4


def perturbed(tree, seed=0, scale=0.05):
    """Every leaf plus scaled noise, so no tensor is zero."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + scale * rng.standard_normal(np.shape(x)).astype(np.float32),
        tree,
    )


@functools.lru_cache(maxsize=1)
def tiny_params():
    cfg = JF5Config(model=JModelConfig(dim=DIM, depth=DEPTH, heads=HEADS,
                                       text_dim=TEXT_DIM, conv_layers=1))
    model = JF5TTS(cfg)
    return perturbed(jax.device_get(model.init_params(0)["params"]))


def port(module, flax_tree):
    module.load_state_dict(from_flax_params(flax_tree), strict=True)
    return module.eval()


def t_(a):
    return torch.from_numpy(np.asarray(a))


def close(out, ref, atol=ATOL):
    out = out.detach().numpy() if torch.is_tensor(out) else out
    np.testing.assert_allclose(out, np.asarray(ref), atol=atol)


def inputs(seed=0, batch=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, T, DIM)).astype(np.float32)
    lens = np.asarray([T, T - 13][:batch])
    mask = np.arange(T)[None, :] < lens[:, None]
    return x, mask


def test_sinusoidal_rope_and_positions():
    t = np.asarray([0.0, 0.3, 1.0], np.float32)
    close(tl.sinusoidal_embedding(t_(t), 256), jl.sinusoidal_embedding(jnp.asarray(t), 256))
    for a, b in zip(tl.rope_tables(T, 64), jl.rope_tables(T, 64)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tl.text_position_table(64, 100), jl.text_position_table(64, 100))
    x = np.random.default_rng(1).standard_normal((2, T, DIM)).astype(np.float32)
    cos, sin = jl.rope_tables(T, 64)
    jq, jk = jl.apply_rope_lanes(x, x + 1, cos, sin, HEADS)
    cl, sl = tl.lanes_rope(T, 64, HEADS, "cpu", torch.float32)
    pq, pk = tl.apply_rope_lanes(t_(x), t_(x + 1), cl, sl, HEADS)
    close(pq, jq, 1e-5)
    close(pk, jk, 1e-5)


def test_timestep_embedding():
    p = tiny_params()["time_embed"]
    t = np.asarray([0.1, 0.7], np.float32)
    ref = jl.TimestepEmbedding(DIM).apply({"params": p}, jnp.asarray(t))
    close(port(tl.TimestepEmbedding(DIM), p)(t_(t)), ref)


def test_conv_position_embedding_with_mask():
    p = tiny_params()["input_embed"]["conv_pos_embed"]
    x, mask = inputs()
    ref = jl.ConvPositionEmbedding(DIM).apply({"params": p}, x, jnp.asarray(mask))
    close(port(tl.ConvPositionEmbedding(DIM), p)(t_(x), t_(mask)), ref)


def test_convnext_block_grn_depthwise():
    p = tiny_params()["text_embed"]["block0"]
    x = np.random.default_rng(2).standard_normal((2, T, TEXT_DIM)).astype(np.float32)
    ref = jl.ConvNeXtV2Block(TEXT_DIM, 2 * TEXT_DIM).apply({"params": p}, x)
    close(port(tl.ConvNeXtV2Block(TEXT_DIM, 2 * TEXT_DIM), p)(t_(x)), ref)


def test_adaln_attention_feedforward_block():
    p = tiny_params()["block0"]
    x, mask = inputs(3)
    emb = np.random.default_rng(4).standard_normal((2, DIM)).astype(np.float32)
    ref = jl.AdaLayerNorm(DIM).apply({"params": p["attn_norm"]}, x, emb)
    out = port(tl.AdaLayerNorm(DIM), p["attn_norm"])(t_(x), t_(emb))
    for a, b in zip(out, ref):
        close(a, b)
    mods = np.random.default_rng(5).standard_normal(6 * DIM).astype(np.float32)
    ref = jl.AdaLayerNorm(DIM).apply({"params": p["attn_norm"]}, x, None, mods=mods)
    out = port(tl.AdaLayerNorm(DIM), p["attn_norm"])(t_(x), None, mods=t_(mods))
    for a, b in zip(out, ref):
        close(a, b)

    cos, sin = jl.rope_tables(T, 64)
    ref = jl.Attention(DIM, HEADS).apply(
        {"params": p["attn"]}, x, jnp.asarray(mask), (jnp.asarray(cos), jnp.asarray(sin))
    )
    # the port's Attention builds its own tables (lanes_rope, tested above)
    close(port(tl.Attention(DIM, HEADS), p["attn"])(t_(x), t_(mask)), ref)

    ref = jl.FeedForward(DIM).apply({"params": p["ff"]}, x)
    close(port(tl.FeedForward(DIM), p["ff"])(t_(x)), ref)

    ref = jl.DiTBlock(DIM, HEADS, dropout=0.0).apply(
        {"params": p}, x, emb, jnp.asarray(mask), (jnp.asarray(cos), jnp.asarray(sin))
    )
    close(port(tl.DiTBlock(DIM, HEADS), p)(t_(x), t_(emb), t_(mask)), ref)


def test_adaln_final():
    p = tiny_params()["norm_out"]
    x, _ = inputs(6)
    emb = np.random.default_rng(7).standard_normal((2, DIM)).astype(np.float32)
    ref = jl.AdaLayerNormFinal(DIM).apply({"params": p}, x, emb)
    close(port(tl.AdaLayerNormFinal(DIM), p)(t_(x), t_(emb)), ref)


@pytest.mark.parametrize("drop_text", [False, True])
def test_text_embedding(drop_text):
    p = tiny_params()["text_embed"]
    ids = np.asarray([[3, 9, 14, 2, 60, -1, -1], [5, 5, 7, 1, 2, 3, 4]], np.int32)
    for seq_len in (5, 12):
        ref = JTextEmbedding(65, TEXT_DIM, conv_layers=1).apply(
            {"params": p}, jnp.asarray(ids), seq_len, drop_text=drop_text
        )
        out = port(TextEmbedding(65, TEXT_DIM, conv_layers=1), p)(t_(ids), seq_len, drop_text)
        close(out, ref)


def _jax_dit():
    from oron_tts_tpu.models.dit import DiT as JDiT

    return JDiT(dim=DIM, depth=DEPTH, heads=HEADS, dim_head=64, text_dim=TEXT_DIM,
                conv_layers=1, dropout=0.0)


def _port_dit():
    return port(DiT(dim=DIM, depth=DEPTH, heads=HEADS, dim_head=64, text_dim=TEXT_DIM,
                    conv_layers=1), tiny_params())


def _dit_inputs():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1, T, 100)).astype(np.float32)
    cond = rng.standard_normal((1, T, 100)).astype(np.float32)
    ids = rng.integers(1, 64, size=(1, T)).astype(np.int32)
    ids[0, T - 6:] = -1
    mask = np.arange(T)[None, :] < T - 6
    return x, cond, ids, mask


def test_dit_call():
    x, cond, ids, mask = _dit_inputs()
    time = np.asarray([0.4], np.float32)
    ref = _jax_dit().apply({"params": tiny_params()}, x, cond, ids, jnp.asarray(time),
                           mask=jnp.asarray(mask))
    out = _port_dit()(t_(x), t_(cond), t_(ids), t_(time), mask=t_(mask))
    close(out, ref)


@pytest.mark.parametrize("hoisted", [False, True])
def test_dit_forward_cfg(hoisted):
    x, cond, ids, mask = _dit_inputs()
    params = tiny_params()
    jd, pd = _jax_dit(), _port_dit()
    te_c = jd.apply({"params": params}, jnp.asarray(ids), T, False, method="embed_text")
    te_u = jd.apply({"params": params}, jnp.asarray(ids), T, True, method="embed_text")
    time = np.asarray([0.25], np.float32)
    jt = pt = None
    if hoisted:
        grid = np.asarray([0.0, 0.25, 0.6], np.float32)
        jemb = jd.apply({"params": params}, jnp.asarray(grid), method="embed_time")
        bm, fm = j_precompute_t_mods(params, jemb, DEPTH, False)
        jt = (bm[:, 1], fm[1])
        pbm, pfm = pd.precompute_t_mods(pd.embed_time(t_(grid)))
        close(pbm, bm)
        close(pfm, fm)
        pt = (pbm[:, 1], pfm[1])
    ref = jd.apply({"params": params}, x, cond, te_c, te_u, jnp.asarray(time),
                   jnp.asarray(mask), method="forward_cfg", t_mods=jt)
    ptc = pd.embed_text(t_(ids), T, False)
    ptu = pd.embed_text(t_(ids), T, True)
    close(ptc, te_c)
    close(ptu, te_u)
    out = pd.forward_cfg(t_(x), t_(cond), ptc, ptu, t_(time), t_(mask), t_mods=pt)
    close(out[0], ref[0])
    close(out[1], ref[1])


@pytest.mark.parametrize("with_lens", [False, True])
def test_vocos_bundled_checkpoint(with_lens):
    trees, _ = load_pytree_npz(BUNDLED_VOCODER)
    jv = JVocos(head_mode="mag_phase")
    pv = port(VocosDecoder(head_mode="mag_phase"), load_npz_tree(BUNDLED_VOCODER)["params"])
    mel = (np.random.default_rng(9).standard_normal((2, 100, 32)) - 4.0).astype(np.float32)
    lens = np.asarray([32, 21], np.int32)
    if with_lens:
        mel = mel * (np.arange(32)[None, None, :] < lens[:, None, None])
        ref = np.asarray(jv.apply({"params": trees["params"]}, mel, jnp.asarray(lens)))
        out = pv(t_(mel), t_(lens)).detach().numpy()
        for row, n in enumerate(lens * 256):
            close(out[row, :n], ref[row, :n])
    else:
        ref = jv.apply({"params": trees["params"]}, mel)
        close(pv(t_(mel)), ref)


@pytest.mark.parametrize("with_lens", [False, True])
def test_vocos_real_imag_head_with_layer_scale(with_lens):
    kw = dict(dim=64, n_layers=2, intermediate_dim=128, head_mode="real_imag", layer_scale=True)
    mel = np.random.default_rng(10).standard_normal((2, 100, 24)).astype(np.float32)
    jv = JVocos(**kw)
    params = perturbed(jax.device_get(jv.init(jax.random.PRNGKey(0), mel)["params"]), seed=1)
    pv = port(VocosDecoder(**kw), params)
    lens = np.asarray([24, 17], np.int32)
    if with_lens:
        mel = mel * (np.arange(24)[None, None, :] < lens[:, None, None])
        ref = np.asarray(jv.apply({"params": params}, mel, jnp.asarray(lens)))
        out = pv(t_(mel), t_(lens)).detach().numpy()
        assert out.shape == ref.shape == (2, 24 * 256)
        for row, n in enumerate(lens * 256):
            close(out[row, :n], ref[row, :n])
    else:
        close(pv(t_(mel)), jv.apply({"params": params}, mel))
