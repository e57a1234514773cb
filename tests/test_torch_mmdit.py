"""PyTorch port, F5-TTS's ``MMDiT`` backbone against its plain reference (CPU, f32).

``tests/plain_mmdit.py`` is plain float32 ``torch`` that imports nothing of the
port; the port's ``MMDiT`` (dim 64, depth 3, heads 4: four heads of width 16, two
two-stream blocks and a context-pre-only last block) is held to it on seeded
random weights. The tolerances are set by float32 rounding through three blocks
(relative gaps of 1e-7 to 1e-6); each is under a tenth of the gap that rounding
the reference's weights and inputs to bfloat16 makes (about 1e-3 relative,
checked here), so a bfloat16 reference would fail every one of them.

Also: the port's ``[text; audio]`` joint order against upstream's ``[audio;
text]`` with its two-segment key mask; the last block's keys-and-values-only
text; ``CFM.loss`` and every gradient with the port's dropout masks, the two
FFNs' masks distinct; equal gradients under ``gradient_checkpointing``; one
``F5Trainer`` step and a checkpoint round trip; ``forward_cfg`` against two
forwards; ``CFM.sample``, hoisted and not, against the reference's Euler solve;
the tracer's ``mmdit.joint`` spans and ``mmdit.*`` counters; TP 2 refused before
anything is sliced; ``configs/mmdit_base.yaml`` and its parameter count;
``gradient_checkpointing: auto`` with two streams a block; ``cli.train`` on a
tiny MMDiT config.

On the card (``card`` marker; ``python -m pytest tests/test_torch_mmdit.py -m card
--noconftest`` there): the lanes kernels (rows 4–5) against their plain forms at
joint lengths ``[B, 2T]`` with ``kv_lens = T + len``, up to T = 1,920; a tiny
MMDiT's loss and every gradient through the kernels (f32) against the plain
forms on the CPU; and one traced training step's ``adaln.fused_calls``
(``18·depth − 3``, 285 at depth 16) and ``attn_dropout.fused_calls`` (``2·depth``, 32).
"""

from __future__ import annotations

import json
import signal
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import plain_mmdit as R
from oron_tts_tpu_torch.config import F5Config, load_config
from oron_tts_tpu_torch.models.f5tts import F5TTS, build_backbone, config_param_count
from oron_tts_tpu_torch.models.mmdit import MMDiT
from oron_tts_tpu_torch.ops.gelu_dropout import _inv_keep, _threshold, keep_mask_plain
from oron_tts_tpu_torch.utils import memory as mem
from oron_tts_tpu_torch.utils import trace

REPO = Path(__file__).resolve().parent.parent
HEADS = 4
TINY = {
    "sample_rate": 24000, "n_mels": 100, "learning_rate": 1e-3, "warmup_steps": 2,
    "num_epochs": 1, "ema_decay": 0.999, "max_grad_norm": 1.0, "use_tqdm": False,
    "log_interval": 1, "save_interval": 1, "max_checkpoints": 2, "audio_sample_interval": 1000,
    "model": {"backbone": "MMDiT", "vocab_size": 65, "dim": 64, "depth": 3, "heads": HEADS,
              "ff_mult": 2, "p_dropout": 0.0, "text_mask_padding": True},
}
VEL_TOL = 1e-5   # velocity: max |port − reference| over max |reference|
GRAD_TOL = 1e-4  # each gradient: ‖port − reference‖ over ‖reference‖
LOSS_TOL = 1e-5  # loss: relative
SOLVE_TOL = 1e-5  # solve: ‖port − reference‖ over the reference's displacement from the noise
ORDER_TOL = 1e-6  # the two joint orders: the same sums over keys in another order


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny models on one intra-op thread (a CPU shared by several test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg(**model) -> dict:
    cfg = json.loads(json.dumps(TINY))
    cfg["model"].update(model)
    return cfg


def seeded_state(model: F5TTS, seed: int = 7) -> dict[str, torch.Tensor]:
    """Every tensor non-zero: linear weights N(0, 1/fan_in), biases N(0, 0.05²), the
    token table N(0, 1), the output bias −3 (where speech's log-mel lies)."""
    g = torch.Generator().manual_seed(seed)
    state = {}
    for k, v in model.backbone.state_dict().items():
        r = torch.randn(v.shape, generator=g)
        if k == "proj_out.bias":
            r = r * 0.05 - 3.0
        elif k.endswith(".bias"):
            r = 0.05 * r
        elif v.ndim == 3:
            r = r / np.sqrt(v.shape[0] * v.shape[1])
        elif not k.endswith("embed.weight"):
            r = r / np.sqrt(v.shape[1])
        state[k] = r
    model.backbone.load_state_dict(state)
    model.params_loaded = True
    return {k: v.clone() for k, v in state.items()}


def make(seed: int = 7, use_flash: bool = True, **model) -> tuple[F5TTS, dict]:
    m = F5TTS(F5Config.from_dict(tiny_cfg(**model)), device="cpu", dtype=torch.float32,
              use_flash=use_flash)
    return m, seeded_state(m, seed)


def inputs(B: int = 3, T: int = 96, seed: int = 0):
    """Text ids shorter than T (padded) with −1 padding inside them too."""
    g = torch.Generator().manual_seed(seed)
    x, cond = torch.randn(B, T, 100, generator=g), torch.randn(B, T, 100, generator=g)
    ids = torch.randint(-1, 64, (B, T - 20), generator=g)
    t = torch.rand(B, generator=g)
    return x, cond, ids, t


def gap(got: torch.Tensor, want: torch.Tensor, keep=None) -> float:
    d = (got - want).abs() if keep is None else (got - want)[keep].abs()
    return float(d.max() / want.abs().max())


def port_drop(rate: float):
    """The port's masks for the reference: pair i's (attention, FFN) seeds over the global
    index of ``[rows, T, C]`` from row 0."""
    def dropout(seeds):
        def for_pair(i: int):
            a_seed, f_seed = seeds[i]

            def drop(kind: str, x: torch.Tensor) -> torch.Tensor:
                seed = a_seed if kind == "attn" else f_seed
                keep = keep_mask_plain(x.numel(), seed, _threshold(rate), x.device,
                                       cols=x.shape[-1]).reshape(x.shape)
                return torch.where(keep, x * torch.tensor(_inv_keep(rate)), torch.zeros_like(x))
            return drop
        return for_pair
    return dropout


RAGGED = torch.tensor([96, 70, 33])


@pytest.mark.parametrize("masked,drop_audio,drop_text,impl,depth", [
    (False, False, False, "lanes", 3),
    (True, False, False, "lanes", 3),
    (True, True, False, "lanes", 3),
    (True, True, True, "lanes", 3),
    (True, False, False, "einsum", 3),
    (True, False, False, "lanes", 1),
], ids=["no_mask", "mask", "drop_audio", "drop_text", "heads_first", "context_only_block"])
def test_velocity_matches_the_reference(masked, drop_audio, drop_text, impl, depth):
    model, state = make(use_flash=impl == "lanes", depth=depth)
    assert model.backbone.attn_impl == impl
    x, cond, ids, t = inputs()
    lens = RAGGED if masked else torch.tensor([96, 96, 96])
    mask = torch.arange(96)[None] < lens[:, None]
    with torch.no_grad():
        got = model.backbone(x, cond, ids, t, mask=mask if masked else None,
                             drop_audio_cond=drop_audio, drop_text=drop_text)
        want = R.velocity(state, x, cond, ids, t, mask, HEADS, drop_audio, drop_text)
    assert gap(got, want, mask[..., None].expand_as(want)) < VEL_TOL


def test_the_tolerance_refuses_a_bfloat16_reference():
    """Rounding the reference's weights and inputs to bfloat16 moves it ~1e-3: over ten
    times every tolerance here."""
    _, state = make()
    x, cond, ids, t = inputs()
    mask = torch.arange(96)[None] < RAGGED[:, None]

    def bf16(a):
        return a.to(torch.bfloat16).float()

    with torch.no_grad():
        want = R.velocity(state, x, cond, ids, t, mask, HEADS)
        rounded = R.velocity({k: bf16(v) for k, v in state.items()}, bf16(x), bf16(cond), ids,
                             bf16(t), mask, HEADS)
    worst = 10 * max(VEL_TOL, GRAD_TOL, LOSS_TOL, SOLVE_TOL)
    assert gap(rounded, want, mask[..., None].expand_as(want)) > worst


def test_the_text_first_order_equals_upstreams_audio_first():
    """``[text; audio]`` with one key prefix ``T + len`` against upstream's ``[audio;
    text]`` with its two-segment mask: the same attention, keys summed in another order."""
    model, state = make()
    x, cond, ids, t = inputs()
    mask = torch.arange(96)[None] < RAGGED[:, None]
    with torch.no_grad():
        port = model.backbone(x, cond, ids, t, mask=mask)
        first = R.velocity(state, x, cond, ids, t, mask, HEADS)
        upstream = R.velocity(state, x, cond, ids, t, mask, HEADS, order="audio_first")
    keep = mask[..., None].expand_as(first)
    assert gap(first, upstream, keep) < ORDER_TOL
    assert gap(port, upstream, keep) < VEL_TOL


def test_the_last_block_gives_keys_and_values_only():
    """No text query, output projection or FFN in the last block; its text stream still
    moves the audio through its keys and values."""
    model, state = make()
    keys = [k for k in state if k.startswith("block2.")]
    assert not any(k.startswith(("block2.attn.to_q_c", "block2.attn.to_out_c", "block2.ff_c"))
                   for k in keys)
    assert "block2.attn.to_k_c.weight" in keys and "block1.attn.to_q_c.weight" in state
    assert state["block2.attn_norm_c.linear.weight"].shape == (128, 64)  # AdaLN-Zero-Final
    x, cond, ids, t = inputs()
    with torch.no_grad():
        a = model.backbone(x, cond, ids, t)
        model.backbone.block2.attn.to_v_c.bias.add_(1.0)
        b = model.backbone(x, cond, ids, t)
    assert not torch.allclose(a, b)


def test_loss_and_every_gradient_match_the_reference():
    rate = 0.1
    model, state = make(p_dropout=rate)
    model.backbone.train()
    assert model.backbone.dropout_pairs == 5
    g = torch.Generator().manual_seed(5)
    B, T = 4, 128
    mel = torch.randn(B, 100, T, generator=g) - 4
    ids = torch.randint(0, 64, (B, T), generator=g)
    lens = torch.tensor([128, 100, 64, 0], dtype=torch.int32)
    loss = model.cfm.loss(mel, ids, lens, torch.Generator().manual_seed(3), train=True)
    loss.backward()
    d = R.draws(torch.Generator().manual_seed(3), B, T, 100, 5, (0.3, 0.2))
    # block 0's audio FFN and text FFN draw from distinct seeds, so distinct masks
    ff_x, ff_c = d["seeds"][0][1], d["seeds"][3][1]
    assert ff_x != ff_c
    th = _threshold(rate)
    assert not torch.equal(keep_mask_plain(B * T * 128, ff_x, th, "cpu", cols=128),
                           keep_mask_plain(B * T * 128, ff_c, th, "cpu", cols=128))
    p = {k: v.clone().requires_grad_(True) for k, v in state.items()}
    want = R.cfm_loss(p, mel, ids, lens, d, HEADS, dropout=port_drop(rate)(d["seeds"]))
    want.backward()
    assert abs(loss.item() - want.item()) <= LOSS_TOL * abs(want.item())
    named = dict(model.backbone.named_parameters())
    assert set(named) == set(p)
    for name, param in named.items():
        ref = p[name].grad
        assert float(ref.norm()) > 0, name  # every weight reaches the loss
        assert float((param.grad - ref).norm()) <= GRAD_TOL * float(ref.norm()), name


def test_gradient_checkpointing_gives_equal_gradients():
    grads = []
    for remat in (False, True):
        model, _ = make(p_dropout=0.1)
        model.backbone.train()
        model.backbone.gradient_checkpointing = remat
        g = torch.Generator().manual_seed(5)
        mel = torch.randn(3, 100, 64, generator=g) - 4
        ids = torch.randint(0, 64, (3, 64), generator=g)
        loss = model.cfm.loss(mel, ids, torch.tensor([64, 50, 20]),
                              torch.Generator().manual_seed(9), train=True)
        loss.backward()
        grads.append([p.grad.clone() for p in model.backbone.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def _trainer(tmp_path, tag: str):
    from oron_tts_tpu_torch.data.dataset import FixedBatchSampler, TTSCollator
    from oron_tts_tpu_torch.data.loader import DataLoader
    from oron_tts_tpu_torch.train.trainer import F5Trainer

    from test_torch_trainer import _synthetic_dataset

    cfg = tiny_cfg(p_dropout=0.1)
    ds = _synthetic_dataset(4)
    loader = DataLoader(ds, FixedBatchSampler(len(ds), 2, seed=1), TTSCollator(pad_to_multiple=64),
                        num_workers=0)
    model = F5TTS.from_config(F5Config.from_dict(cfg), device="cpu")
    seeded_state(model)
    return F5Trainer(config=cfg, model=model, train_loader=loader,
                     log_dir=str(tmp_path / f"logs{tag}"), checkpoint_dir=str(tmp_path / "ckpt"))


def test_trainer_step_and_checkpoint_round_trip(tmp_path):
    trainer = _trainer(tmp_path, "a")
    before = [p.clone() for p in trainer.state.params]
    batch = next(iter(trainer.train_loader))
    metrics = trainer.train_step(batch, torch.Generator().manual_seed(0))
    assert metrics["ok"] and np.isfinite(metrics["loss"])
    st = trainer.state
    assert st.step == 1 and any(not torch.equal(a, b) for a, b in zip(before, st.params))
    assert "block1.attn.to_out_c.weight" in st.names and "block2.ff_x.in_proj.weight" in st.names
    trainer.save_checkpoint(loss=metrics["loss"])
    trainer.checkpoint_manager.wait()
    fresh = _trainer(tmp_path, "b")
    fresh.load_checkpoint()
    assert fresh.global_step == 1
    for part in ("params", "ema", "mu", "nu"):
        for a, b in zip(getattr(st, part), getattr(fresh.state, part)):
            assert torch.equal(a.float(), b.float()), part
    for w, m in zip(fresh.work, fresh.state.params):
        assert torch.equal(w.detach().float(), m)


def test_forward_cfg_equals_two_forwards():
    """The doubled batch ``[cond; uncond]``, both streams' hoisted tables, against a
    conditional forward and one with the audio and the text dropped."""
    model, _ = make()
    bb = model.backbone
    x, cond, ids, t = inputs()
    mask = torch.arange(96)[None] < RAGGED[:, None]
    with torch.no_grad():
        te, te_null = bb.embed_text(ids, 96), bb.embed_text(ids, 96, drop_text=True)
        tables = bb.precompute_t_mods(bb.embed_time(t[:1]))
        tm = tuple(tab.select(-2, 0) for tab in tables)
        pred, null = bb.forward_cfg(x, cond, te, te_null, None, mask, t_mods=tm)
        t0 = t[:1].expand(3)
        want = bb(x, cond, ids, t0, mask=mask)
        want_null = bb(x, cond, ids, t0, mask=mask, drop_audio_cond=True, drop_text=True)
    keep = mask[..., None].expand_as(want)
    assert gap(pred, want, keep) < VEL_TOL and gap(null, want_null, keep) < VEL_TOL


@pytest.mark.parametrize("hoist", [True, False])
def test_sample_matches_the_reference_euler_solve(hoist):
    model, state = make()
    B, T = 2, 128
    g = torch.Generator().manual_seed(2)
    cond = torch.zeros(B, T, 100)
    cond[0, :30] = torch.randn(30, 100, generator=g) - 4
    ids = torch.randint(-1, 64, (B, T), generator=g)
    duration, lens = torch.tensor([128, 90]), torch.tensor([30, 0])
    noise = torch.randn(B, T, 100, generator=g)
    got, _ = model.cfm.sample(cond, ids, duration, lens, steps=4, cfg_strength=2.0,
                              sway_sampling_coef=-1.0, noise=noise, hoist_t_mods=hoist)
    want = R.euler_solve(state, cond, ids, duration, lens, noise, 4, 2.0, -1.0, HEADS)
    for r in range(B):
        n = int(duration[r])
        moved = (want[r, :n] - noise[r, :n]).norm()
        assert float((got[r, :n] - want[r, :n]).norm()) < SOLVE_TOL * float(moved)


def test_tracer_records_the_joint_spans_and_counters_of_one_forward():
    depth, B, T = 4, 2, 64
    model, _ = make(depth=depth)
    x, cond, ids, t = inputs(B, T)
    trace.stop()
    try:
        with torch.no_grad():
            model.backbone(x, cond, ids, t)
        assert trace._spans == [] and trace._counters == {}  # off: nothing
        trace.start()
        with torch.no_grad():
            model.backbone(x, cond, ids, t)
        rec = trace.stop()
    finally:
        trace.stop()
    # each block: one span around the concatenation of the streams, one around the split
    assert [s["name"] for s in rec["spans"]] == ["mmdit.joint"] * (2 * depth)
    assert rec["counters"] == {"mmdit.joint_tokens": B * 2 * T,
                               "mmdit.text_tokens": int((ids[:, :T] >= 0).sum())}


def test_tensor_parallel_is_refused_before_anything_is_sliced():
    from types import SimpleNamespace

    model, state = make()
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        model.backbone.shard(SimpleNamespace(n_model=2, model_rank=0, model_group=None))
    assert model.backbone.mesh is None
    assert all(torch.equal(v, state[k]) for k, v in model.backbone.state_dict().items())


def test_mmdit_base_yaml_has_its_widths_and_count():
    config = load_config(REPO / "configs" / "mmdit_base.yaml")
    m = F5Config.from_dict(config).model
    assert (m.backbone, m.dim, m.depth, m.heads, m.dim_head, m.ff_mult) == (
        "MMDiT", 1024, 16, 16, 64, 4)
    assert (m.text_dim, m.conv_layers, m.text_mask_padding) == (1024, 0, True)
    assert (config["frames_threshold"], config["max_samples"], config["learning_rate"],
            config["warmup_steps"], config["max_grad_norm"]) == (32000, 64, 7.5e-5, 20000, 1.0)
    assert config["gradient_checkpointing"] is False
    with torch.device("meta"):
        backbone = build_backbone(m, config["n_mels"], False)
    assert isinstance(backbone, MMDiT) and backbone.dropout_pairs == 31
    n = sum(t.numel() for t in backbone.state_dict().values())
    # 15 two-stream blocks of 37.78 M, a last block of 23.09 M (no to_q_c), 7.85 M besides
    assert n == config_param_count(config) == 597_633_124


def test_auto_counts_two_streams_a_block():
    """``auto`` estimates the MMDiT's activations over 2·depth block-streams: at 32,000
    padded frames a step fits an 80 GB card, at 48,000 it recomputes; the DiT's count,
    one a block, would fit both. The config's own worst batch (30 s clips packed to 24
    rows of 2,048 frames) recomputes on the H100's 85,017,493,504 bytes."""
    from oron_tts_tpu_torch.cli.train import auto_remat_frames
    from oron_tts_tpu_torch.models.f5tts import config_activation_depth

    config = load_config(REPO / "configs" / "mmdit_base.yaml")
    n = config_param_count(config)
    streams = config_activation_depth(config)
    assert streams == 32
    card = 80 * 10**9
    assert [mem.auto_gradient_checkpointing(config, f, n, device_bytes=card, act_depth=streams)
            for f in (32_000, 48_000)] == [False, True]
    assert not mem.auto_gradient_checkpointing(config, 48_000, n, device_bytes=card)
    worst = auto_remat_frames(config)
    assert worst == 49_152
    assert mem.auto_gradient_checkpointing(config, worst, n, device_bytes=85_017_493_504,
                                           act_depth=streams)


def test_cli_train_runs_a_tiny_mmdit_config(tmp_path, capsys):
    from oron_tts_tpu_torch.cli import train as cli_train
    from oron_tts_tpu_torch.data.wav import write_wav

    from test_torch_trainer import _synthetic_dataset

    ds = _synthetic_dataset(4)
    records = []
    for i, audio in enumerate(ds.audio_arrays):
        write_wav(tmp_path / f"clip{i}.wav", audio, 24000)
        records.append({"audio_path": str(tmp_path / f"clip{i}.wav"), "text": ds.texts[i]})
    (tmp_path / "metadata.json").write_text(json.dumps(records))
    config = load_config(REPO / "configs" / "mmdit_base.yaml")
    config["model"].update(dim=64, depth=2, heads=4)
    config.update(frames_threshold=600, max_samples=2, num_workers=0, use_tqdm=False,
                  save_interval=1, async_checkpoint=False, mixed_precision="float32",
                  gradient_checkpointing="auto")
    (tmp_path / "mmdit.yaml").write_text(yaml.safe_dump(config))
    prev = signal.getsignal(signal.SIGTERM)
    try:
        cli_train.main(["--config", str(tmp_path / "mmdit.yaml"), "--from-local", "--data-dir",
                        str(tmp_path), "--device", "cpu", "--num-epochs", "1", "--log-dir",
                        str(tmp_path / "logs"), "--checkpoint-dir", str(tmp_path / "ckpt")])
    finally:
        signal.signal(signal.SIGTERM, prev)
    out = capsys.readouterr().out
    with torch.device("meta"):
        n = sum(t.numel() for t in build_backbone(
            F5Config.from_dict(config).model, config["n_mels"], False).state_dict().values())
    assert f"Model parameters: {n:,}" in out
    assert "gradient_checkpointing=auto -> False" in out
    assert list((tmp_path / "ckpt").glob("f5tts_step_*.npz"))


# ── on the card ─────────────────────────────────────────────────────────────


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the card: python -m pytest "
                    "tests/test_torch_mmdit.py -m card --noconftest)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("T,dtype", [(200, torch.float32), (200, torch.bfloat16),
                                     (1000, torch.bfloat16), (1920, torch.bfloat16)])
def test_lanes_kernels_at_joint_lengths(card, T, dtype):
    """Rows 4–5 over ``[B, 2T, H·D]`` with ``kv_lens = T + len``: the stats forward and
    the backward against their plain forms (chip_smoke's tolerances: the output 5e-3
    (bf16) or 2e-4 (f32) absolute, the row statistic 1e-4, each gradient 1e-2 (bf16)
    or 2e-4 (f32) of its reference's largest value); the backward twice for equal bits."""
    from oron_tts_tpu_torch.ops import flash_attention as fa

    B, H, D = 2, 16, 64
    gen = torch.Generator(device=card).manual_seed(T)
    lens = torch.tensor([T + T, T + T // 3], dtype=torch.int32, device=card)
    q, k, v, do = (torch.randn(B, 2 * T, H * D, generator=gen, device=card).to(dtype)
                   for _ in range(4))
    out, lse = fa.flash_lanes_fwd_stats(q, k, v, lens, H)
    ref_out, ref_lse = fa.flash_lanes_fwd_stats_plain(q.float(), k.float(), v.float(), lens, H)
    grads = fa.flash_lanes_bwd(q, k, v, lens, out, do, lse, H)
    again = fa.flash_lanes_bwd(q, k, v, lens, out, do, lse, H)
    refs = fa.flash_lanes_bwd_plain(q.float(), k.float(), v.float(), lens, out.float(),
                                    do.float(), lse, H)
    bf16 = dtype == torch.bfloat16
    assert float((out.float() - ref_out).abs().max()) <= (5e-3 if bf16 else 2e-4)
    assert float((lse - ref_lse).abs().max()) <= 1e-4
    rel = 1e-2 if bf16 else 2e-4
    for got, twice, ref in zip(grads, again, refs):
        assert torch.equal(got, twice)
        assert float((got.float() - ref).abs().max()) <= rel * float(ref.abs().max())


def _train_grads(device, dtype, trace_on=False, depth=3):
    """A tiny MMDiT's training loss and gradients (dropout on, ragged rows)."""
    cfg = tiny_cfg(dim=128, heads=2, depth=depth, p_dropout=0.1)
    model = F5TTS(F5Config.from_dict(cfg), device=device, dtype=dtype)
    seeded_state(model)
    model.backbone.train()
    gm = torch.Generator().manual_seed(8)
    B, T = 3, 320
    mel = (torch.randn(B, 100, T, generator=gm) - 4).to(device)
    ids = torch.randint(-1, 64, (B, T), generator=gm).to(device)
    lens = torch.tensor([320, 250, 97], dtype=torch.int32, device=device)
    if trace_on:
        trace.start()
    loss = model.cfm.loss(mel, ids, lens, torch.Generator().manual_seed(3), train=True)
    loss.backward()
    counters = trace.stop()["counters"] if trace_on else {}
    grads = {n: p.grad.float().cpu() for n, p in model.backbone.named_parameters()}
    return float(loss.detach()), grads, counters, model.backbone.depth


@pytest.mark.card
def test_one_training_step_through_the_kernels_equals_the_plain_forms(card):
    """f32 on the card (lanes rows 4–5, rows 10–11, 14, 15) against f32 on the CPU (their
    plain forms): the loss and every gradient within 1e-3 of its norm (f32 rounding
    through other summation orders); then a traced bf16 step at depth 16 counts AdaLN's
    passes (9 a stream a block, 3 for the last block's text, 3 for ``norm_out``:
    ``18·depth − 3`` = 285) and row 14's launches (``2·depth`` = 32)."""
    loss_card, grads_card, _, _ = _train_grads(card, torch.float32)
    loss_cpu, grads_cpu, _, _ = _train_grads("cpu", torch.float32)
    assert abs(loss_card - loss_cpu) <= 1e-4 * abs(loss_cpu)
    for name, ref in grads_cpu.items():
        assert float((grads_card[name] - ref).norm()) <= 1e-3 * float(ref.norm()) + 1e-12, name
    _, _, counters, depth = _train_grads(card, torch.bfloat16, trace_on=True, depth=16)
    print(f"a step at depth {depth}: adaln.fused_calls {counters.get('adaln.fused_calls')}, "
          f"attn_dropout.fused_calls {counters.get('attn_dropout.fused_calls')}")
    assert (counters["adaln.fused_calls"], counters["attn_dropout.fused_calls"]) == (285, 32)
