"""PyTorch port: AdaLN-Zero's passes around a DiT block (``ops/adaln.py``).

On the CPU:

- each entry point on CPU tensors equals the eager expressions the DiT block had,
  forward and every gradient, bit for bit, in f32 and bf16, with one modulation row
  and with B, and runs under eager autograd, not the kernels' ``autograd.Function``;
- ``torch.autograd.gradcheck`` passes on each in float64;
- a tiny DiT's outputs and gradients equal those of the eager block it replaces,
  leaf for leaf, with and without ``gradient_checkpointing``, and the sampler's
  hoisted single-row modulation gives the same velocity;
- the launch refuses what the kernels do not take before it looks at the device,
  and a CPU call counts no launch.

On the card (``card`` marker; ``python -m pytest tests/test_torch_adaln.py -m card
--noconftest`` there, since this file imports no JAX):

- each kernel against its plain form computed in f32 from the same inputs, at a
  Base step's ``[48, 1000, 1024]`` with ragged lengths, at a ``T`` that is not a
  multiple of either tile and a width that leaves lanes idle, and at a narrow
  width with flat rows; one modulation row and B; bf16 and f32;
- two runs of each backward are bit-equal (the sums have a fixed order);
- one traced training step of a tiny DiT counts ``adaln.fused_calls``
  9 × depth + 3, and the sampler 3 × depth + 1 a forward.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from oron_tts_tpu_torch.ops import adaln
from oron_tts_tpu_torch.utils import trace

OPS = {"modulate": adaln.MODULATE, "gate_residual_modulate": adaln.GATE_RESIDUAL_MODULATE,
       "gate_residual": adaln.GATE_RESIDUAL}
ENTRY = {adaln.MODULATE: lambda x, y, g, s, sh: adaln.adaln_modulate(x, s, sh),
         adaln.GATE_RESIDUAL_MODULATE: adaln.gate_residual_modulate,
         adaln.GATE_RESIDUAL: lambda x, y, g, s, sh: adaln.gate_residual(x, y, g)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the card: python -m pytest "
                    "tests/test_torch_adaln.py -m card --noconftest)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def tracer_off():
    trace.stop()
    yield
    trace.stop()


def _eager(op, x, y, gate, scale, shift):
    """The DiT block's expressions before the kernels, as written there."""
    ln = F.layer_norm
    if op == adaln.MODULATE:
        return ln(x, x.shape[-1:], eps=1e-6) * (1 + scale[:, None]) + shift[:, None]
    x1 = x + gate[:, None] * y
    if op == adaln.GATE_RESIDUAL:
        return x1
    return x1, ln(x1, x1.shape[-1:], eps=1e-6) * (1 + scale[:, None]) + shift[:, None]


def _inputs(op, B, T, D, mods_rows, dtype, device="cpu", seed=0):
    """x, y [B, T, D] and chunks of a [rows, 6·D] modulation, those ``op`` reads."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x, y = (torch.randn(B, T, D, generator=gen, device=device).to(dtype) for _ in range(2))
    mods = (0.5 * torch.randn(mods_rows, 6 * D, generator=gen, device=device)).to(dtype)
    shift, scale, gate = mods.chunk(6, dim=-1)[:3]
    return (x, None if op == adaln.MODULATE else y, None if op == adaln.MODULATE else gate,
            None if op == adaln.GATE_RESIDUAL else scale,
            None if op == adaln.GATE_RESIDUAL else shift), mods


def _outputs_and_grads(fn, ins, mods, seed=1):
    """fn's outputs and the gradients of a fixed weighted sum of them, by input."""
    leaves = [None if t is None else t.detach().requires_grad_(True) for t in ins[:2]]
    mods = mods.detach().requires_grad_(True)
    shift, scale, gate = mods.chunk(6, dim=-1)[:3]
    args = [*leaves, None if ins[2] is None else gate, None if ins[3] is None else scale,
            None if ins[4] is None else shift]
    outs = fn(*args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    gen = torch.Generator(device=ins[0].device).manual_seed(seed)
    grads = [torch.randn(o.shape, generator=gen, device=o.device).to(o.dtype) for o in outs]
    wrt = [t for t in [*leaves, mods] if t is not None]
    return [o.detach() for o in outs], torch.autograd.grad(outs, wrt, grads)


# ── CPU: the plain path ─────────────────────────────────────────────────────

@pytest.mark.parametrize("mods_rows", ["one", "batch"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(OPS))
def test_plain_path_is_the_eager_expressions_bit_for_bit(name, dtype, mods_rows):
    op = OPS[name]
    B = 3
    ins, mods = _inputs(op, B, 7, 16, 1 if mods_rows == "one" else B, dtype)
    got, got_g = _outputs_and_grads(ENTRY[op], ins, mods)
    want, want_g = _outputs_and_grads(lambda *a: _eager(op, *a), ins, mods)
    for a, b in zip([*got, *got_g], [*want, *want_g]):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("mods_rows", [1, 2])
@pytest.mark.parametrize("name", list(OPS))
def test_gradcheck_in_float64(name, mods_rows):
    op = OPS[name]
    ins, _ = _inputs(op, 2, 3, 8, mods_rows, torch.float64)
    leaves = tuple(None if t is None else t.detach().clone().requires_grad_(True) for t in ins)
    assert torch.autograd.gradcheck(ENTRY[op], leaves)


def _tiny_dit(remat: bool):
    from oron_tts_tpu_torch.models.dit import DiT

    torch.manual_seed(0)
    model = DiT(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=20, text_dim=16,
                conv_layers=1, dropout=0.1, gradient_checkpointing=remat)
    for p in model.parameters():  # AdaLN starts at zero: give the modulation some size
        p.data.normal_(0, 0.2, generator=torch.Generator().manual_seed(p.numel()))
    return model


def _parent_block_forward(self, x, t, mask=None, tmods=None, kv_lens=None, seeds=None, batch0=0):
    attn_seed, ff_seed = seeds if seeds is not None else (None, None)
    mods = self.attn_norm.linear(F.silu(t)) if tmods is None else tmods
    mods = mods[None, :] if mods.ndim == 1 else mods
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = torch.chunk(mods, 6, dim=-1)
    normed = _eager(adaln.MODULATE, x, None, None, scale_msa, shift_msa)
    x = x + gate_msa[:, None] * self.attn(
        normed, mask=mask, kv_lens=kv_lens, seed=attn_seed, batch0=batch0)
    ff_in = _eager(adaln.MODULATE, x, None, None, scale_mlp, shift_mlp)
    return x + gate_mlp[:, None] * self.ff(ff_in, seed=ff_seed, batch0=batch0)


def _parent_final_forward(self, x, emb, mods=None):
    mods = self.linear(F.silu(emb)) if mods is None else mods
    mods = mods[None, :] if mods.ndim == 1 else mods
    scale, shift = torch.chunk(mods, 2, dim=-1)
    return F.layer_norm(x, x.shape[-1:], eps=1e-6) * (1 + scale)[:, None] + shift[:, None]


def _velocity_and_grads(model, seeds):
    gen = torch.Generator().manual_seed(3)
    B, T = 3, 12
    x, cond = torch.randn(B, T, 20, generator=gen), torch.randn(B, T, 20, generator=gen)
    text = torch.randint(1, 60, (B, T), generator=gen)
    time = torch.rand(B, generator=gen)
    mask = torch.arange(T)[None, :] < torch.tensor([12, 9, 4])[:, None]
    out = model(x, cond, text, time, mask=mask, dropout_seeds=seeds)
    dy = torch.randn(out.shape, generator=gen)
    names, params = zip(*model.named_parameters())
    return out.detach(), dict(zip(names, torch.autograd.grad(out, params, dy)))


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_tiny_dit_equals_the_parents_eager_block(monkeypatch, remat):
    from oron_tts_tpu_torch.models import layers

    model = _tiny_dit(remat)
    seeds = [(11 + i, 21 + i) for i in range(2)]
    got, got_g = _velocity_and_grads(model, seeds)
    monkeypatch.setattr(layers.DiTBlock, "forward", _parent_block_forward)
    monkeypatch.setattr(layers.AdaLayerNormFinal, "forward", _parent_final_forward)
    want, want_g = _velocity_and_grads(model, seeds)
    assert torch.equal(got, want)
    bad = [n for n in want_g if not torch.equal(got_g[n], want_g[n])]
    assert not bad, f"gradients differ at {bad}"


def test_hoisted_single_row_mods_give_the_parents_velocity(monkeypatch):
    from oron_tts_tpu_torch.models import layers

    model = _tiny_dit(False).eval()
    gen = torch.Generator().manual_seed(5)
    B, T = 2, 10
    x, cond = torch.randn(B, T, 20, generator=gen), torch.randn(B, T, 20, generator=gen)
    te_c, te_u = (model.embed_text(torch.randint(1, 60, (B, T), generator=gen), T)
                  for _ in range(2))

    def run():
        with torch.no_grad():
            block_mods, final_mods = model.precompute_t_mods(model.embed_time(torch.tensor([0.3])))
            t_mods = (block_mods[:, 0], final_mods[0])
            return torch.cat(model.forward_cfg(x, cond, te_c, te_u, None, t_mods=t_mods))

    got = run()
    monkeypatch.setattr(layers.DiTBlock, "forward", _parent_block_forward)
    monkeypatch.setattr(layers.AdaLayerNormFinal, "forward", _parent_final_forward)
    assert torch.equal(got, run())


def test_a_cpu_call_counts_no_launch():
    ins, mods = _inputs(adaln.GATE_RESIDUAL_MODULATE, 2, 5, 8, 2, torch.float32)
    before = (adaln.adaln_fwd.launches, adaln.adaln_bwd.launches)
    trace.start()
    _outputs_and_grads(ENTRY[adaln.GATE_RESIDUAL_MODULATE], ins, mods)
    assert "adaln.fused_calls" not in trace.stop()["counters"]
    assert (adaln.adaln_fwd.launches, adaln.adaln_bwd.launches) == before


MISUSE = {
    "dim_not_a_multiple_of_8": (dict(D=12), "multiple of 8"),
    "dim_too_wide": (dict(D=4104), "multiple of 8"),
    "x_not_contiguous": (dict(x=lambda t: t.transpose(0, 1).contiguous().transpose(0, 1)),
                         "contiguous"),
    "y_not_contiguous": (dict(y=lambda t: t.transpose(1, 2).contiguous().transpose(1, 2)),
                         "contiguous"),
    "mods_batch": (dict(mods_rows=3), r"\[1 or B=2"),
    "mods_column_stride": (dict(scale=lambda m: m.t().contiguous().t()), "row must be contiguous"),
    "dtype": (dict(dtype=torch.float16), "bf16 or f32"),
    "cpu_device": (dict(), "unsupported device"),
}


@pytest.mark.parametrize("case", list(MISUSE))
def test_the_launch_refuses_what_the_kernels_do_not_take(case):
    spec, match = MISUSE[case]
    op = adaln.GATE_RESIDUAL_MODULATE
    (x, y, gate, scale, shift), _ = _inputs(op, 2, 24, spec.get("D", 16), spec.get("mods_rows", 2),
                                            spec.get("dtype", torch.float32))
    x, y, scale = (spec.get(k, lambda t: t)(t) for k, t in (("x", x), ("y", y), ("scale", scale)))
    with pytest.raises(ValueError, match=match):
        adaln.adaln_fwd(op, x, y, gate, scale, shift)


@pytest.mark.parametrize("name", list(OPS))
def test_a_cpu_call_is_eager_autograd_not_the_function(name):
    op = OPS[name]
    ins, mods = _inputs(op, 2, 5, 8, 2, torch.float32)
    leaves = [None if t is None else t.detach().requires_grad_(True) for t in ins]
    outs = ENTRY[op](*leaves)
    for o in outs if isinstance(outs, tuple) else (outs,):
        assert o.grad_fn is not None and "AdaLN" not in type(o.grad_fn).__name__


# ── the card: kernels against their plain forms ────────────────────────────

SHAPES = {
    "base_ragged": (48, 1000, 1024),  # a Base step; y zero past each row's length
    "odd_t": (5, 333, 768),           # T no multiple of 16 or 64; 3 of 4 vectors a lane
    "narrow_flat": (3, 70, 64),       # 8 of 32 lanes; some rows constant (variance 0)
}


def _reference(op, ins, grads, dtype):
    """The plain form in f32 from the same inputs: outputs, then dx, dy and the sums
    d scale, d shift, d gate, those ``op`` has. x1 is rounded to ``dtype`` before its
    LayerNorm, as it is stored and read (the eager form does the same)."""
    f = [None if t is None else t.detach().float().requires_grad_(True) for t in ins]
    x, y, gate, scale, shift = f
    if op == adaln.GATE_RESIDUAL:
        outs = (adaln.gate_residual_plain(*f),)
    elif op == adaln.MODULATE:
        outs = (adaln.adaln_modulate_plain(*f),)
    else:
        x1 = adaln.gate_residual_plain(*f)
        x1 = x1 + (x1.to(dtype).float() - x1).detach()  # the stored value, exact gradients
        outs = (x1, adaln.adaln_modulate_plain(x1, None, None, scale, shift))
    wrt = [t for t in f if t is not None]
    got = torch.autograd.grad(outs, wrt, [g.float() for g in grads])
    return [o.detach() for o in outs], dict(zip([n for n, t in zip("x y gate scale shift".split(),
                                                                   f) if t is not None], got))


def _close(name, got, want, dtype):
    """|got - want| <= rtol |want| + atol max |want|. rtol: one bf16 step (2^-8) for a
    value rounded once from f32, or 1e-5 for f32; atol 2e-5 of the tensor's largest
    value: f32 sums over 1,024 columns or up to 48,000 rows taken in another order."""
    got, want = got.float(), want.float()
    rtol = 2.0**-8 if dtype == torch.bfloat16 else 1e-5
    tol = rtol * want.abs() + 2e-5 * want.abs().max()
    worst = ((got - want).abs() / tol).max().item()
    assert worst <= 1.0, f"{name}: {worst:.3f} of its tolerance"


@pytest.mark.card
@pytest.mark.parametrize("mods_rows", ["one", "batch"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", list(OPS))
def test_kernel_against_its_plain_form_in_f32(card, name, shape, dtype, mods_rows):
    op = OPS[name]
    B, T, D = SHAPES[shape]
    ins, _ = _inputs(op, B, T, D, 1 if mods_rows == "one" else B, dtype, card, seed=len(shape))
    ins = list(ins)
    gen = torch.Generator(device=card).manual_seed(7)
    if shape == "base_ragged" and ins[1] is not None:  # attention zeroes padded rows
        lens = torch.randint(1, T + 1, (B,), generator=gen, device=card)
        ins[1] = ins[1] * (torch.arange(T, device=card)[None, :] < lens[:, None])[..., None]
    if shape == "narrow_flat":
        ins[0][:, ::7] = ins[0][:, ::7, :1]
    grads = [torch.randn(B, T, D, generator=gen, device=card).to(dtype) for _ in range(2)]
    out, x1, stats = adaln.adaln_fwd(op, *ins)
    if op == adaln.MODULATE:
        outs, saved, dh, dres = [out], ins[0], grads[0], None
    elif op == adaln.GATE_RESIDUAL_MODULATE:
        outs, saved, dh, dres = [x1, out], x1, grads[1], grads[0]
    else:
        outs, saved, dh, dres = [x1], None, None, grads[0]
    dx, dy, sums = adaln.adaln_bwd(op, saved, ins[1], dh, dres, stats, ins[2], ins[3])
    torch.cuda.synchronize()
    want, want_g = _reference(op, ins, [g for g in (dres, dh) if g is not None], dtype)
    for i, (a, b) in enumerate(zip(outs, want)):
        _close(f"output {i}", a, b, dtype)
    if dx is not None:
        _close("dx", dx, want_g["x"], dtype)
    if dy is not None:
        _close("dy", dy, want_g["y"], dtype)
    names = {adaln.MODULATE: ["scale", "shift"], adaln.GATE_RESIDUAL_MODULATE:
             ["scale", "shift", "gate"], adaln.GATE_RESIDUAL: ["gate"]}[op]
    for q, n in enumerate(names):
        _close(f"d {n}", sums[q], want_g[n], dtype)


@pytest.mark.card
@pytest.mark.parametrize("name", list(OPS))
def test_two_runs_are_bit_equal(card, name):
    op = OPS[name]
    B, T, D = SHAPES["base_ragged"]
    ins, _ = _inputs(op, B, T, D, B, torch.bfloat16, card)
    gen = torch.Generator(device=card).manual_seed(9)
    g = torch.randn(B, T, D, generator=gen, device=card).to(torch.bfloat16)

    def run():
        out, x1, stats = adaln.adaln_fwd(op, *ins)
        saved = {adaln.MODULATE: ins[0], adaln.GATE_RESIDUAL_MODULATE: x1}.get(op)
        dh = None if op == adaln.GATE_RESIDUAL else g
        dres = None if op == adaln.MODULATE else g.flip(0)
        res = [out, x1, stats, *adaln.adaln_bwd(op, saved, ins[1], dh, dres, stats, ins[2],
                                                ins[3])]
        return [None if t is None else t.clone() for t in res]

    first, second = run(), run()
    torch.cuda.synchronize()
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(first, second))


def _tiny_config() -> dict:
    model = {"vocab_size": 65, "dim": 128, "depth": 4, "heads": 2, "ff_mult": 2,
             "p_dropout": 0.1, "text_dim": 32, "conv_layers": 2}
    return {"sample_rate": 24000, "n_fft": 1024, "hop_length": 256, "n_mels": 100,
            "learning_rate": 1e-3, "warmup_steps": 2, "num_epochs": 1, "ema_decay": 0.999,
            "max_grad_norm": 1.0, "grad_accumulation_steps": 1, "use_tqdm": False,
            "log_interval": 1, "save_interval": 1000, "max_checkpoints": 1, "model": model}


@pytest.mark.card
def test_traced_step_and_sampler_count_their_launches(card, tmp_path):
    from oron_tts_tpu_torch.config import F5Config
    from oron_tts_tpu_torch.data.dataset import FixedBatchSampler, TTSCollator, TTSDataset
    from oron_tts_tpu_torch.data.loader import DataLoader
    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from oron_tts_tpu_torch.train.trainer import F5Trainer

    cfg = _tiny_config()
    depth, sr = cfg["model"]["depth"], cfg["sample_rate"]
    arrays = [(0.4 * np.sin(2 * np.pi * (200 + 20 * i) * np.arange(int(sr * (1 + 0.3 * i)))
                            / sr)).astype(np.float32) for i in range(3)]
    ds = TTSDataset(audio_arrays=arrays, texts=["сайн байна уу"] * 3, sample_rate=sr)
    loader = DataLoader(ds, FixedBatchSampler(3, 3, seed=1), TTSCollator(pad_to_multiple=64),
                        num_workers=0)
    model = F5TTS.from_config(F5Config.from_dict(cfg), device="cuda")
    trainer = F5Trainer(config=cfg, model=model, train_loader=loader,
                        log_dir=str(tmp_path / "logs"), checkpoint_dir=str(tmp_path / "ckpt"))
    trace.start()
    trainer.train_step(next(iter(loader)), torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    assert trace.stop()["counters"].get("adaln.fused_calls") == 9 * depth + 3

    B, T = 2, 128
    cond = torch.zeros(B, T, 100, device=card, dtype=model.dtype)
    ids = torch.randint(1, 64, (B, T), device=card, dtype=torch.int32)
    fwd = adaln.adaln_fwd.launches
    trace.start()
    with torch.no_grad():
        mel, _ = model.cfm.sample(cond, ids, torch.tensor([128, 100]), torch.tensor([0, 10]),
                                  steps=2)
    torch.cuda.synchronize()
    calls = trace.stop()["counters"].get("adaln.fused_calls", 0)
    assert calls == adaln.adaln_fwd.launches - fwd and calls > 0
    assert calls % (3 * depth + 1) == 0
    assert torch.isfinite(mel.float()).all()
