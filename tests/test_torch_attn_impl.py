"""PyTorch port, the attention-implementation switch against the JAX package.

``attn_impl`` in {einsum, lanes, flash, packed, skip} on ``Attention``, a
two-block ``DiT`` and a 4-step ``CFM.sample``; the routing of
(heads, dim_head, use_flash, attn_impl) to an implementation; the
gradients through "flash"; ``F5TTS(use_flash=False)``. The JAX package runs
its Pallas kernels in interpret mode. Widths: dim 64, heads 2, so D = 32
fits both the lanes and the classic layout. Inputs come from numpy seeds;
everything runs in f32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oron_tts_tpu.ops.flash_attention as jfa
from oron_tts_tpu.models import layers as jl
from oron_tts_tpu.models.cfm import CFM as JCFM
from oron_tts_tpu.models.dit import DiT as JDiT
from oron_tts_tpu_torch.config import F5Config, ModelConfig
from oron_tts_tpu_torch.models import layers as tl
from oron_tts_tpu_torch.models.cfm import CFM
from oron_tts_tpu_torch.models.dit import DiT
from oron_tts_tpu_torch.models.f5tts import F5TTS
from oron_tts_tpu_torch.utils.weights import from_flax_params, seeded_dit_params, to_flax_params

DIM, HEADS, DH, DEPTH, TEXT_DIM, T = 64, 2, 32, 2, 32, 32
IMPLS = ("einsum", "lanes", "flash", "packed", "skip")
KW = dict(dim=DIM, depth=DEPTH, heads=HEADS, dim_head=DH, text_dim=TEXT_DIM, conv_layers=1)


@functools.lru_cache(maxsize=1)
def dit_params():
    """A seeded DiT tree in the flax layout, every tensor non-zero (numpy)."""
    return seeded_dit_params(ModelConfig(dim=DIM, depth=DEPTH, heads=HEADS, text_dim=TEXT_DIM,
                                         conv_layers=1), seed=0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, T, DIM)).astype(np.float32)
    mask = np.arange(T)[None, :] < np.asarray([T, T - 7])[:, None]
    return x, mask


def _port_rope(impl):
    if impl == "lanes":
        return tl.lanes_rope(T, DH, HEADS, "cpu", torch.float32)
    return tl.heads_rope(T, DH, "cpu", torch.float32)


def _port_attention(impl, params):
    attn = tl.Attention(DIM, HEADS, DH, attn_impl=impl)
    attn.load_state_dict(from_flax_params(params), strict=True)
    return attn.eval()


# ── routing ─────────────────────────────────────────────────────────────


def _jax_route(heads, dim_head, use_flash, attn_impl, monkeypatch):
    """What the JAX ``Attention`` runs: the kernel function it calls, or einsum."""
    called = []

    def recorder(name):
        def fn(q, *args, **kwargs):
            called.append(name)
            return jnp.zeros_like(q)
        return fn

    for name, impl in (("flash_attention_lanes", "lanes"), ("flash_attention_trainable", "flash"),
                       ("flash_attention_packed", "packed")):
        monkeypatch.setattr(jfa, name, recorder(impl))
    mod = jl.Attention(dim=16, heads=heads, dim_head=dim_head, use_flash=use_flash,
                       attn_impl=attn_impl)
    x = jnp.zeros((1, 8, 16))
    mod.apply(mod.init(jax.random.PRNGKey(0), x), x)
    return called[0] if called else "einsum"


@pytest.mark.parametrize("heads,dim_head", [(16, 64), (2, 32), (4, 48), (3, 40), (12, 16)])
@pytest.mark.parametrize("use_flash,attn_impl", [
    (True, None), (False, None), (False, "lanes"), (True, "packed"),
])
def test_routing_matches_jax(heads, dim_head, use_flash, attn_impl, monkeypatch):
    try:
        want = _jax_route(heads, dim_head, use_flash, attn_impl, monkeypatch)
    except ValueError as exc:
        with pytest.raises(ValueError, match="attn_impl='lanes' needs"):
            tl.resolve_attn_impl(heads, dim_head, use_flash, attn_impl)
        assert "attn_impl='lanes' needs" in str(exc)
        return
    assert tl.resolve_attn_impl(heads, dim_head, use_flash, attn_impl) == want
    assert tl.Attention(16, heads, dim_head, use_flash=use_flash, attn_impl=attn_impl).impl == want


def test_routing_table_cases():
    assert tl.resolve_attn_impl(4, 48) == "flash"       # lanes does not fit: classic
    assert tl.resolve_attn_impl(16, 64) == "lanes"      # Base
    assert tl.resolve_attn_impl(2, 32) == "lanes"       # configs/test.yaml
    assert tl.resolve_attn_impl(16, 64, use_flash=False) == "einsum"
    assert tl.resolve_attn_impl(16, 64, attn_impl="skip") == "skip"
    with pytest.raises(ValueError, match="attn_impl='lanes' needs"):
        tl.resolve_attn_impl(4, 48, attn_impl="lanes")
    with pytest.raises(ValueError, match="must be one of"):
        tl.resolve_attn_impl(4, 48, attn_impl="sdpa")


def test_f5tts_use_flash():
    def backbone_impl(dim, heads, **kw):
        cfg = F5Config(model=ModelConfig(dim=dim, depth=1, heads=heads, text_dim=32,
                                         conv_layers=1))
        return F5TTS(cfg, device="cpu", **kw).backbone.attn_impl

    assert backbone_impl(64, 2) == "lanes"
    assert backbone_impl(64, 2, use_flash=True) == "lanes"
    assert backbone_impl(64, 2, use_flash=False) == "einsum"
    assert backbone_impl(192, 4) == "flash"  # dim_head 48


# ── modules against the JAX modules, per impl ───────────────────────────


@pytest.mark.parametrize("impl", IMPLS)
def test_attention_matches_jax(impl):
    params = dit_params()["block0"]["attn"]
    x, mask = _inputs(1)
    cos, sin = jl.rope_tables(T, DH)
    jmod = jl.Attention(dim=DIM, heads=HEADS, dim_head=DH, attn_impl=impl)
    ref = jmod.apply({"params": params}, x, mask=jnp.asarray(mask),
                     rope=(jnp.asarray(cos), jnp.asarray(sin)))
    with torch.no_grad():  # "packed" is forward only, as in the JAX package
        out = _port_attention(impl, params)(_t(x), mask=_t(mask), rope=_port_rope(impl))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("impl", ["flash", "lanes", "einsum"])
def test_attention_gradients_match_jax(impl):
    """As ``tests/test_flash_backward.py:62-93``: a linear probe on the output,
    gradients of every parameter and of the input."""
    params = dit_params()["block0"]["attn"]
    x, mask = _inputs(2)
    probe = np.random.default_rng(3).standard_normal((2, T, DIM)).astype(np.float32)
    cos, sin = jl.rope_tables(T, DH)
    jmod = jl.Attention(dim=DIM, heads=HEADS, dim_head=DH, attn_impl=impl)

    def loss(p, x_):
        out = jmod.apply({"params": p}, x_, mask=jnp.asarray(mask),
                         rope=(jnp.asarray(cos), jnp.asarray(sin)))
        return jnp.sum(out * probe)

    j_params, j_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    attn = _port_attention(impl, params)
    tx = _t(x).requires_grad_(True)
    (attn(tx, mask=_t(mask), rope=_port_rope(impl)) * _t(probe)).sum().backward()
    got = to_flax_params({n: p.grad for n, p in attn.named_parameters()})
    flat_got = jax.tree_util.tree_leaves(got)
    flat_ref = jax.tree_util.tree_leaves(jax.device_get(j_params))
    assert len(flat_got) == len(flat_ref) == 8
    for a, b in zip(flat_got, flat_ref):
        np.testing.assert_allclose(a, np.asarray(b), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(j_x), rtol=2e-4, atol=2e-4)


def _jax_dit(impl):
    return JDiT(dim=DIM, depth=DEPTH, heads=HEADS, dim_head=DH, text_dim=TEXT_DIM,
                conv_layers=1, dropout=0.0, attn_impl=impl)


def _port_dit(impl):
    dit = DiT(**KW, dropout=0.0, attn_impl=impl)
    dit.load_state_dict(from_flax_params(dit_params()), strict=True)
    return dit.eval()


@pytest.mark.parametrize("impl", IMPLS)
def test_two_block_dit_matches_jax(impl):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, T, 100)).astype(np.float32)
    cond = rng.standard_normal((2, T, 100)).astype(np.float32)
    ids = rng.integers(0, 60, (2, T)).astype(np.int32)
    time = np.asarray([0.2, 0.7], np.float32)
    _, mask = _inputs()
    ref = _jax_dit(impl).apply({"params": dit_params()}, x, cond, ids, time, jnp.asarray(mask))
    dit = _port_dit(impl)
    assert dit.attn_impl == impl
    with torch.no_grad():
        out = dit(_t(x), _t(cond), _t(ids), _t(time), mask=_t(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-3)


def test_cfm_sample_on_flash_matches_jax():
    rng = np.random.default_rng(6)
    Tm = 64
    cond = np.zeros((1, Tm, 100), np.float32)
    cond[0, :12] = rng.standard_normal((12, 100))
    ids = rng.integers(1, 60, (1, Tm)).astype(np.int32)
    ids[0, 50:] = -1
    duration, lens = np.asarray([57]), np.asarray([12])
    noise = rng.standard_normal((1, Tm, 100)).astype(np.float32)
    ref, _ = JCFM(_jax_dit("flash")).sample(
        {"params": dit_params()}, cond, ids, duration, lens, steps=4, cfg_strength=2.0,
        sway_sampling_coef=-1.0, noise=noise)
    out = CFM(_port_dit("flash")).sample(
        _t(cond), _t(ids), _t(duration), _t(lens), steps=4, cfg_strength=2.0,
        sway_sampling_coef=-1.0, noise=_t(noise))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
