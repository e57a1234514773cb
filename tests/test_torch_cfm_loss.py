"""PyTorch port, ``CFM.loss`` and its gradients against the JAX package (CPU).

The same numpy-seeded weights (a perturbed tiny DiT carried across with
``from_flax_params``), mel, text ids, lengths and ``x0`` go through the JAX
package's deterministic eval loss (``train=False``) and the port's. The
JAX side runs once with its einsum attention and once with
``DiT(use_flash=True)``, the lanes Pallas kernels in interpret mode. Then
the port's own training loss: finite, a function of the generator seed, and
unchanged by gradient checkpointing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch._dynamo  # noqa: F401  (see below)

from oron_tts_tpu.models import cfm as jcfm
from oron_tts_tpu.models.dit import DiT as JDiT
from oron_tts_tpu_torch.models import cfm as tcfm
from oron_tts_tpu_torch.models.dit import DiT
from oron_tts_tpu_torch.ops import flash_attention as t_flash
from oron_tts_tpu_torch.ops import gelu_dropout as t_gd
from oron_tts_tpu_torch.utils.weights import from_flax_params

from test_torch_models import DEPTH, DIM, HEADS, TEXT_DIM, tiny_params

# torch.utils.checkpoint imports torch._dynamo at its first call, and that
# imports the standard library's ``profile``. Another test file of this suite
# puts scripts/ (which holds a profile.py) at the head of sys.path while it
# runs; importing torch._dynamo here, at collection, keeps the gradient
# checkpointing test independent of which tests ran before it in the process.

B, T_MEL, N_MELS = 2, 64, 100
KW = dict(dim=DIM, depth=DEPTH, heads=HEADS, dim_head=64, text_dim=TEXT_DIM, conv_layers=1)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((B, T_MEL, N_MELS)).astype(np.float32)
    ids = rng.integers(0, 60, (B, T_MEL)).astype(np.int32)
    lens = np.asarray([T_MEL, T_MEL - 21], np.int32)
    ids[1, lens[1]:] = -1
    x0 = rng.standard_normal((B, T_MEL, N_MELS)).astype(np.float32)
    return mel, ids, lens, x0


def _port_cfm(dropout=0.0, **kw):
    dit = DiT(**KW, dropout=dropout, **kw)
    dit.load_state_dict(from_flax_params(tiny_params()), strict=True)
    return tcfm.CFM(dit)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("use_flash", [False, True], ids=["einsum", "lanes"])
def test_eval_loss_and_gradients_match_jax(use_flash):
    mel, ids, lens, x0 = _batch()
    j = jcfm.CFM(JDiT(**KW, dropout=0.0, use_flash=use_flash))

    def j_loss(params):
        return j.loss({"params": params}, jnp.asarray(mel), jnp.asarray(ids), jnp.asarray(lens),
                      jax.random.PRNGKey(0), train=False, x0=jnp.asarray(x0))

    j_val, j_grads = jax.value_and_grad(j_loss)(tiny_params())
    ref_grads = from_flax_params(jax.device_get(j_grads))

    cfm = _port_cfm()
    loss = cfm.loss(_t(mel), _t(ids), _t(lens), train=False, x0=_t(x0))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_val), rtol=1e-5)
    named = dict(cfm.backbone.named_parameters())
    assert set(named) == set(ref_grads)
    for name, ref in ref_grads.items():
        got = named[name].grad
        assert got is not None, name
        scale = max(float(ref.abs().max()), 1e-8)
        assert float((got - ref).abs().max()) <= 2e-4 * scale, name


def test_eval_loss_accepts_channel_first_mel():
    mel, ids, lens, x0 = _batch(1)
    cfm = _port_cfm()
    a = cfm.loss(_t(mel), _t(ids), _t(lens), train=False, x0=_t(x0))
    b = cfm.loss(_t(mel.transpose(0, 2, 1).copy()), _t(ids), _t(lens), train=False, x0=_t(x0))
    assert torch.equal(a, b)
    # no x0: a fixed noise, so the eval loss is comparable between epochs
    assert torch.equal(cfm.loss(_t(mel), _t(ids), _t(lens), train=False),
                       cfm.loss(_t(mel), _t(ids), _t(lens), train=False))


def test_span_mask_from_fracs_matches_jax():
    lens = np.asarray([64, 43, 10, 1], np.int32)
    frac = np.asarray([0.7, 0.93, 1.0, 0.85], np.float32)
    starts = np.asarray([0.0, 0.51, 0.99, 0.3], np.float32)
    ref = jcfm.span_mask_from_fracs(jnp.asarray(lens), jnp.asarray(frac), jnp.asarray(starts), 64)
    got = tcfm.span_mask_from_fracs(_t(lens), _t(frac), _t(starts), 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(tcfm.lens_to_mask(_t(lens), 64).numpy(),
                                  np.asarray(jcfm.lens_to_mask(jnp.asarray(lens), 64)))


def test_train_loss_is_finite_and_a_function_of_the_seed():
    mel, ids, lens, _ = _batch(2)
    cfm = _port_cfm(dropout=0.1)
    args = (_t(mel), _t(ids), _t(lens))
    a = cfm.loss(*args, torch.Generator().manual_seed(5))
    b = cfm.loss(*args, torch.Generator().manual_seed(5))
    c = cfm.loss(*args, torch.Generator().manual_seed(6))
    assert torch.isfinite(a) and torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="Generator"):
        cfm.loss(*args, None)


def test_train_loss_runs_the_training_ops(monkeypatch):
    """Dropout on: every block takes the attention Function's stats forward
    and backward and the fused GELU+dropout forward and backward."""
    calls = {"stats": 0, "bwd": 0, "gd_fwd": 0, "gd_bwd": 0}

    def counted(key, fn):
        def wrapper(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(t_flash, "flash_lanes_fwd_stats", counted("stats", t_flash.flash_lanes_fwd_stats))
    monkeypatch.setattr(t_flash, "flash_lanes_bwd", counted("bwd", t_flash.flash_lanes_bwd))
    monkeypatch.setattr(t_gd, "gelu_dropout_fwd", counted("gd_fwd", t_gd.gelu_dropout_fwd))
    monkeypatch.setattr(t_gd, "gelu_dropout_bwd", counted("gd_bwd", t_gd.gelu_dropout_bwd))
    mel, ids, lens, _ = _batch(3)
    cfm = _port_cfm(dropout=0.1)
    cfm.loss(_t(mel), _t(ids), _t(lens), torch.Generator().manual_seed(1)).backward()
    assert calls == {"stats": DEPTH, "bwd": DEPTH, "gd_fwd": DEPTH, "gd_bwd": DEPTH}
    # the eval loss is deterministic: no fused dropout pass
    calls.update(dict.fromkeys(calls, 0))
    with torch.no_grad():
        cfm.loss(_t(mel), _t(ids), _t(lens), train=False)
    assert calls == {"stats": 0, "bwd": 0, "gd_fwd": 0, "gd_bwd": 0}


def test_gradient_checkpointing_leaves_gradients_unchanged():
    mel, ids, lens, _ = _batch(4)
    grads = []
    for remat in (False, True):
        cfm = _port_cfm(dropout=0.1, gradient_checkpointing=remat)
        loss = cfm.loss(_t(mel), _t(ids), _t(lens), torch.Generator().manual_seed(9))
        loss.backward()
        grads.append((loss.detach(), [p.grad.clone() for p in cfm.backbone.parameters()]))
    assert torch.equal(grads[0][0], grads[1][0])
    for a, b in zip(grads[0][1], grads[1][1]):
        assert torch.equal(a, b)  # the recomputation redraws the same masks
