"""PyTorch port, E2 TTS's ``UNetT`` backbone against its plain reference (CPU, f32).

``tests/plain_unett.py`` is plain float32 ``torch`` that imports nothing of the
port; the port's ``UNetT`` (dim 64, depth 4, heads 4: four heads of width 16,
two skips) is held to it on seeded random weights. The tolerances are set by
float32 rounding through four blocks (relative gaps of 1e-7 to 1e-6); each is
under a tenth of the gap that rounding the reference's weights and inputs to
bfloat16 makes (about 1e-3 relative, checked here), so a bfloat16 reference
would fail every one of them.

Also: ``CFM.loss`` and every gradient with the port's dropout masks; equal
gradients under ``gradient_checkpointing``; one ``F5Trainer`` step and a
checkpoint round trip; ``CFM.sample`` against the reference's Euler solve;
the tracer's ``unett.skip`` spans and ``unett.*`` counters; TP 2 on CPU gloo
ranks against one process; ``configs/e2_base.yaml`` at the published widths
and its parameter count; ``cli.train`` on a tiny E2 config; and the DiT that
``configs/runpod.yaml`` builds, with its count and ``auto`` choice, as before.
"""

from __future__ import annotations

import json
import signal
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import plain_unett as R
from oron_tts_tpu_torch.config import F5Config, load_config
from oron_tts_tpu_torch.models.dit import DiT, dit_param_count
from oron_tts_tpu_torch.models.f5tts import F5TTS, build_backbone, config_param_count
from oron_tts_tpu_torch.models.unett import UNetT
from oron_tts_tpu_torch.ops.gelu_dropout import _inv_keep, _threshold, keep_mask_plain
from oron_tts_tpu_torch.utils import memory as mem
from oron_tts_tpu_torch.utils import trace

REPO = Path(__file__).resolve().parent.parent
HEADS = 4
TINY = {
    "sample_rate": 24000, "n_mels": 100, "learning_rate": 1e-3, "warmup_steps": 2,
    "num_epochs": 1, "ema_decay": 0.999, "max_grad_norm": 1.0, "use_tqdm": False,
    "log_interval": 1, "save_interval": 1, "max_checkpoints": 2, "audio_sample_interval": 1000,
    "model": {"backbone": "UNetT", "vocab_size": 65, "dim": 64, "depth": 4, "heads": HEADS,
              "ff_mult": 2, "p_dropout": 0.0, "text_mask_padding": False, "pe_attn_head": 1},
}
VEL_TOL = 1e-5   # velocity: max |port − reference| over max |reference|
GRAD_TOL = 1e-4  # each gradient: ‖port − reference‖ over ‖reference‖
LOSS_TOL = 1e-5  # loss: relative
SOLVE_TOL = 1e-5  # solve: ‖port − reference‖ over the reference's displacement from the noise


def tiny_cfg(**model) -> dict:
    cfg = json.loads(json.dumps(TINY))
    cfg["model"].update(model)
    return cfg


def seeded_state(model: F5TTS, seed: int = 7) -> dict[str, torch.Tensor]:
    """Every tensor non-zero: linear weights N(0, 1/fan_in), norms 1 + N(0, 0.1²),
    biases N(0, 0.05²), the output bias −3 (where speech's log-mel lies)."""
    g = torch.Generator().manual_seed(seed)
    state = {}
    for k, v in model.backbone.state_dict().items():
        r = torch.randn(v.shape, generator=g)
        if k == "proj_out.bias":
            r = r * 0.05 - 3.0
        elif v.ndim == 1 and k.endswith(".weight"):  # the RMSNorms'
            r = 1.0 + 0.1 * r
        elif k.endswith(".bias"):
            r = 0.05 * r
        elif v.ndim == 3:
            r = r / np.sqrt(v.shape[0] * v.shape[1])
        elif k.endswith("embed.weight"):
            pass
        else:
            r = r / np.sqrt(v.shape[1])
        state[k] = r
    model.backbone.load_state_dict(state)
    model.params_loaded = True
    return {k: v.clone() for k, v in state.items()}


def make(seed: int = 7, **model) -> tuple[F5TTS, dict]:
    m = F5TTS(F5Config.from_dict(tiny_cfg(**model)), device="cpu", dtype=torch.float32)
    return m, seeded_state(m, seed)


def inputs(B: int = 3, T: int = 96, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    x, cond = torch.randn(B, T, 100, generator=g), torch.randn(B, T, 100, generator=g)
    ids = torch.randint(-1, 64, (B, T - 20), generator=g)
    t = torch.rand(B, generator=g)
    return x, cond, ids, t


def gap(got: torch.Tensor, want: torch.Tensor, keep=None) -> float:
    d = (got - want).abs() if keep is None else (got - want)[keep].abs()
    return float(d.max() / want.abs().max())


def port_drop(rate: float):
    """The port's masks for the reference: block i's (attention, FFN) seeds, the global
    index of ``[rows, T + 1, C]`` from row 0."""
    def dropout(seeds):
        def for_block(i: int):
            a_seed, f_seed = seeds[i]

            def drop(kind: str, x: torch.Tensor) -> torch.Tensor:
                seed = a_seed if kind == "attn" else f_seed
                keep = keep_mask_plain(x.numel(), seed, _threshold(rate), x.device,
                                       cols=x.shape[-1]).reshape(x.shape)
                return torch.where(keep, x * torch.tensor(_inv_keep(rate)), torch.zeros_like(x))
            return drop
        return for_block
    return dropout


@pytest.mark.parametrize("masked,drop_audio,drop_text,pe,impl", [
    (False, False, False, 1, "lanes"),
    (True, False, False, 1, "lanes"),
    (True, True, False, 1, "lanes"),
    (True, True, True, 1, "lanes"),
    (True, False, False, None, "lanes"),
    (True, False, False, 1, "einsum"),
    (True, False, False, None, "einsum"),
], ids=["no_mask", "mask", "drop_audio", "drop_text", "rope_all_heads", "heads_first",
        "heads_first_all_heads"])
def test_velocity_matches_the_reference(masked, drop_audio, drop_text, pe, impl):
    model, state = make(pe_attn_head=pe)
    if impl == "einsum":
        model = F5TTS(F5Config.from_dict(tiny_cfg(pe_attn_head=pe)), device="cpu",
                      dtype=torch.float32, use_flash=False)
        model.backbone.load_state_dict(state)
    assert model.backbone.attn_impl == impl
    x, cond, ids, t = inputs()
    lens = torch.tensor([96, 70, 33]) if masked else torch.tensor([96, 96, 96])
    mask = torch.arange(96)[None] < lens[:, None]
    with torch.no_grad():
        got = model.backbone(x, cond, ids, t, mask=mask if masked else None,
                             drop_audio_cond=drop_audio, drop_text=drop_text)
        want = R.velocity(state, x, cond, ids, t, mask, HEADS, pe, drop_audio, drop_text)
    keep = mask[..., None].expand_as(want)
    assert gap(got, want, keep) < VEL_TOL


def test_the_tolerance_refuses_a_bfloat16_reference():
    """Rounding the reference's weights and inputs to bfloat16 moves it ~1e-3: over ten
    times every tolerance here."""
    model, state = make()
    x, cond, ids, t = inputs()
    mask = torch.arange(96)[None] < torch.tensor([96, 70, 33])[:, None]

    def bf16(a):
        return a.to(torch.bfloat16).float()

    with torch.no_grad():
        want = R.velocity(state, x, cond, ids, t, mask, HEADS)
        rounded = R.velocity({k: bf16(v) for k, v in state.items()}, bf16(x), bf16(cond), ids,
                             bf16(t), mask, HEADS)
    worst = 10 * max(VEL_TOL, GRAD_TOL, LOSS_TOL, SOLVE_TOL)
    assert gap(rounded, want, mask[..., None].expand_as(want)) > worst


def test_rope_rotates_the_first_head_only():
    """``pe_attn_head: 1`` on the lanes layout: head 0's 16 lanes rotated, heads 1-3's
    as they were."""
    from oron_tts_tpu_torch.models.layers import apply_partial_rope_lanes, lanes_rope

    g = torch.Generator().manual_seed(1)
    q, k = torch.randn(1, 9, 64, generator=g), torch.randn(1, 9, 64, generator=g)
    cos, sin = lanes_rope(9, 16, 1, "cpu", torch.float32)
    qr, kr = apply_partial_rope_lanes(q, k, cos, sin, 1)
    assert torch.equal(qr[..., 16:], q[..., 16:]) and torch.equal(kr[..., 16:], k[..., 16:])
    assert not torch.allclose(qr[..., :16], q[..., :16])


def test_loss_and_every_gradient_match_the_reference():
    rate = 0.1
    model, state = make(p_dropout=rate)
    model.backbone.train()
    g = torch.Generator().manual_seed(5)
    B, T = 4, 128
    mel = torch.randn(B, 100, T, generator=g) - 4
    ids = torch.randint(0, 64, (B, T), generator=g)
    lens = torch.tensor([128, 100, 64, 0], dtype=torch.int32)
    loss = model.cfm.loss(mel, ids, lens, torch.Generator().manual_seed(3), train=True)
    loss.backward()
    d = R.draws(torch.Generator().manual_seed(3), B, T, 100, 4, (0.3, 0.2))
    p = {k: v.clone().requires_grad_(True) for k, v in state.items()}
    want = R.cfm_loss(p, mel, ids, lens, d, HEADS, 1, dropout=port_drop(rate)(d["seeds"]))
    want.backward()
    assert abs(loss.item() - want.item()) <= LOSS_TOL * abs(want.item())
    named = dict(model.backbone.named_parameters())
    assert set(named) == set(p)
    # the key bias reaches head 0 alone (RoPE's): the others' gradient is exactly 0
    assert not named["block0.attn.to_k.bias"].grad[16:].any()
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
    assert "block3.skip_proj.weight" in st.names and "norm_out.weight" in st.names
    trainer.save_checkpoint(loss=metrics["loss"])
    trainer.checkpoint_manager.wait()
    fresh = _trainer(tmp_path, "b")
    fresh.load_checkpoint()
    assert fresh.global_step == 1
    for part in ("params", "ema", "mu", "nu"):
        for a, b in zip(getattr(st, part), getattr(fresh.state, part)):
            assert torch.equal(a.float(), b.float()), part
    # the working set follows the masters
    for w, m in zip(fresh.work, fresh.state.params):
        assert torch.equal(w.detach().float(), m)


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


def test_tracer_records_the_skips_and_counters_of_one_forward():
    depth, dim, B, T = 24, 32, 2, 64
    model = F5TTS(F5Config.from_dict(tiny_cfg(depth=depth, dim=dim, heads=2)), device="cpu",
                  dtype=torch.float32)
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
    assert [s["name"] for s in rec["spans"]] == ["unett.skip"] * (depth // 2)
    assert rec["counters"] == {"unett.tokens": B * (T + 1),
                               "unett.skip_bytes": depth // 2 * B * (T + 1) * dim * 4}


def test_tensor_parallel_matches_one_process(tmp_path):
    """TP 2 over gloo: each rank keeps two heads (head 0, the one RoPE rotates, on rank
    0), the skip projections and norms whole; two steps with dropout equal the single
    process's."""
    import _torch_mesh_worker as W
    from _torch_mesh_common import load_npz, rank_results, spawn

    runs = [{"dropout": 0.1, "backbone": "UNetT"}]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = W.train_two_steps(None, W.tiny_config(0.1, "UNetT"), str(tmp_path / "single"))
    finally:
        torch.set_num_threads(threads)
    spawn("train", 2, tmp_path / "tp2", {"dp": 1, "tp": 2, "runs": runs})
    ranks = rank_results(tmp_path / "tp2", 2)
    assert ranks[0][0]["param_numel"] < single["param_numel"]
    np.testing.assert_allclose(ranks[0][0]["loss"], single["loss"], rtol=1e-5)
    trees = load_npz(tmp_path / "tp2" / "trees_0.npz")
    assert set(trees) == set(single["flat"])
    for key, want in single["flat"].items():
        np.testing.assert_allclose(trees[key], want, atol=1e-5, err_msg=key)


def test_e2_base_yaml_has_the_published_widths():
    config = load_config(REPO / "configs" / "e2_base.yaml")
    m = F5Config.from_dict(config).model
    assert (m.backbone, m.dim, m.depth, m.heads, m.ff_mult) == ("UNetT", 1024, 24, 16, 4)
    assert (m.text_dim, m.conv_layers, m.text_mask_padding, m.pe_attn_head) == (100, 0, False, 1)
    assert (config["frames_threshold"], config["max_samples"], config["learning_rate"],
            config["warmup_steps"], config["max_grad_norm"]) == (38400, 64, 7.5e-5, 20000, 1.0)
    assert config["gradient_checkpointing"] is False
    with torch.device("meta"):
        backbone = build_backbone(m, config["n_mels"], False)
    assert isinstance(backbone, UNetT)
    n = sum(t.numel() for t in backbone.state_dict().values())
    assert n == config_param_count(config) == 333_222_444


def test_runpod_still_builds_the_dit_with_its_keys_count_and_choice():
    config = load_config(REPO / "configs" / "runpod.yaml")
    m = F5Config.from_dict(config).model
    assert m.backbone == "DiT"
    with torch.device("meta"):
        backbone = build_backbone(m, 100, False)
        direct = DiT(dim=1024, depth=22, heads=16, dim_head=64, ff_mult=4, mel_dim=100,
                     vocab_size=65, text_dim=512, conv_layers=4, dropout=0.1)
    assert type(backbone) is DiT
    assert {k: tuple(v.shape) for k, v in backbone.state_dict().items()} == {
        k: tuple(v.shape) for k, v in direct.state_dict().items()}
    n = config_param_count(config)
    assert n == dit_param_count(1024, 22) == 427_780_608
    # auto: remat below the H100's 85,017,493,504 bytes, none on it (runpod's 67,584 frames)
    assert [mem.auto_gradient_checkpointing(config, 67_584, n, device_bytes=b)
            for b in (80 * 10**9, 85_017_493_504)] == [True, False]


def test_cli_train_runs_a_tiny_e2_config(tmp_path, capsys):
    from oron_tts_tpu_torch.cli import train as cli_train
    from oron_tts_tpu_torch.data.wav import write_wav

    from test_torch_trainer import _synthetic_dataset

    ds = _synthetic_dataset(4)
    records = []
    for i, audio in enumerate(ds.audio_arrays):
        write_wav(tmp_path / f"clip{i}.wav", audio, 24000)
        records.append({"audio_path": str(tmp_path / f"clip{i}.wav"), "text": ds.texts[i]})
    (tmp_path / "metadata.json").write_text(json.dumps(records))
    config = load_config(REPO / "configs" / "e2_base.yaml")
    config["model"].update(dim=64, depth=4, heads=4)
    config.update(frames_threshold=600, max_samples=2, num_workers=0, use_tqdm=False,
                  save_interval=1, async_checkpoint=False, mixed_precision="float32")
    (tmp_path / "e2.yaml").write_text(yaml.safe_dump(config))
    prev = signal.getsignal(signal.SIGTERM)
    try:
        cli_train.main(["--config", str(tmp_path / "e2.yaml"), "--from-local", "--data-dir",
                        str(tmp_path), "--device", "cpu", "--num-epochs", "1", "--log-dir",
                        str(tmp_path / "logs"), "--checkpoint-dir", str(tmp_path / "ckpt")])
    finally:
        signal.signal(signal.SIGTERM, prev)
    out = capsys.readouterr().out
    with torch.device("meta"):  # the module's own count
        n = sum(t.numel() for t in build_backbone(
            F5Config.from_dict(config).model, config["n_mels"], False).state_dict().values())
    assert f"Model parameters: {n:,}" in out
    assert list((tmp_path / "ckpt").glob("f5tts_step_*.npz"))
