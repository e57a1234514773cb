"""The MMDiT's plain reference (``portbench/reference/mmdit.py``) and its cell on the CPU.

- the benchmark's copy against the repository's test copy, ``tests/plain_mmdit.py``
  (loaded by its path): the same velocity and loss on the same weights;
- ``mmdit-base`` resolves to ``reference/mmdit.py``, which meets the contract;
- ``train_step_flops`` and ``solve_flops`` against a count by hand at a small size;
- ``dit_state`` draws every key of the program's MMDiT;
- the program's MMDiT against this reference at a tiny width, and the cell's
  training check end to end with faults it must refuse, under the cell's limits.

Tolerances: the two float32 copies compute the same expressions in another order
(1e-6 relative); the program against the reference, 1e-5 on the loss and 1e-4 of
each gradient's norm (float32 rounding through three blocks, as the UNetT's).
"""

from __future__ import annotations

import importlib.util
import json
import time

import pytest
import torch

from portbench import check, training
from portbench import run as prun
from portbench.reference import CONTRACT, architecture, mmdit
from portbench.reference import train as RTrain
from portbench.tests import tiny
from portbench.weights import dit_state

ROOT = tiny.ROOT
CELL = "mmdit.train.32k"
SEED = 2**31 + 2424


def mmdit_config(**model) -> dict:
    cfg = json.loads((ROOT / "portbench" / "configs" / "mmdit-base.json").read_text())
    cfg["model"].update(dim=64, depth=3, heads=4, ff_mult=2, **model)
    return cfg


def plain():
    """``tests/plain_mmdit.py``, by its path (the benchmark imports nothing of tests/)."""
    path = ROOT / "tests" / "plain_mmdit.py"
    spec = importlib.util.spec_from_file_location("plain_mmdit_by_path", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def program_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    from oron_tts_tpu_torch.config import F5Config
    from oron_tts_tpu_torch.models.f5tts import build_backbone

    with torch.device("meta"):
        backbone = build_backbone(F5Config.from_dict(cfg).model, cfg["n_mels"], False)
    return {k: tuple(v.shape) for k, v in backbone.state_dict().items()}


@pytest.fixture(scope="module")
def drawn():
    cfg = mmdit_config()
    return cfg, dit_state(program_shapes(cfg), SEED, "cpu", torch.float32, mmdit)


def test_mmdit_base_resolves_to_the_mmdit_reference():
    _, cell, cfg = prun.load_spec(ROOT, CELL)
    assert cell["config"] == "mmdit-base" and cfg["model"]["backbone"] == "MMDiT"
    assert architecture(cfg) is mmdit
    assert all(callable(getattr(mmdit, f)) for f in CONTRACT)
    assert mmdit.dropout_pairs(cfg) == 31


def test_the_draw_covers_every_mmdit_key(drawn):
    cfg, state = drawn
    shapes = program_shapes(cfg)
    assert list(state) == list(shapes)
    assert all(tuple(state[k].shape) == s for k, s in shapes.items())
    assert "block1.attn.to_out_c.weight" in state and "block2.attn.to_q_c.weight" not in state
    assert tuple(state["input_embed.proj.weight"].shape) == (64, 200)


def test_the_benchmark_copy_equals_the_test_copy(drawn):
    cfg, state = drawn
    R2 = plain()
    P = mmdit.params(state, cfg, "cpu")
    g = torch.Generator().manual_seed(4)
    B, T = 3, 80
    x, cond = torch.randn(B, T, 100, generator=g), torch.randn(B, T, 100, generator=g)
    ids = torch.randint(-1, 64, (B, T), generator=g)
    t = torch.rand(B, generator=g)
    mask = torch.arange(T)[None] < torch.tensor([80, 51, 7])[:, None]
    for drop_audio, drop_text in ((False, False), (True, False), (True, True)):
        with torch.no_grad():
            a = mmdit.velocity(P, x, cond, ids, t, mask, drop_audio, drop_text)
            b = R2.velocity(state, x, cond, ids, t, mask, 4, drop_audio, drop_text)
        assert float((a - b)[mask].abs().max()) <= 1e-6 * float(b[mask].abs().max())

    m = cfg["model"]
    mel = torch.randn(4, 100, 64, generator=g) - 4
    tid = torch.randint(0, 64, (4, 64), generator=g)
    lens = torch.tensor([64, 40, 17, 0], dtype=torch.int32)
    d = RTrain.draws(torch.Generator().manual_seed(8), 4, 64, 100, 5, (0.3, 0.2))
    loss, _ = RTrain.loss_and_grads(P, mel, tid, lens, d, (0.7, 1.0), m["p_dropout"], 4,
                                    velocity=mmdit.velocity)
    rate = m["p_dropout"]

    def dropout(i):
        def drop(kind, x):
            seed = d["seeds"][i][0 if kind == "attn" else 1]
            keep = RTrain.keep_mask(tuple(x.shape), seed, rate, 0, x.device)
            return x * keep.float() * (1.0 / (1.0 - rate))
        return drop

    want = R2.cfm_loss(state, mel, tid, lens, d, 4, dropout=dropout)
    assert loss == pytest.approx(float(want), rel=1e-6)


def test_flops_equal_a_count_by_hand():
    cfg = mmdit_config()
    d, depth, ff, mel = 64, 3, 2, 100
    stream = 8 * d * d + 4 * ff * d * d
    blocks = (2 * depth - 1) * stream + 4 * d * d  # the last block's text: k and v
    frame = 2 * 200 * d + 2 * 2 * d * 4 * 31 + 2 * d * mel
    mods = 5 * 2 * d * 6 * d + 2 * d * 2 * d + 2 * d * 2 * d + 2 * 256 * d + 2 * d * d

    def fwd(n):  # 2n queries over 2n keys in two blocks, n over 2n in the last
        return n * (blocks + frame) + 4 * d * (2 * (2 * n) ** 2 + n * 2 * n)

    assert mmdit.train_step_flops(cfg, [50, 0, 7]) == 3 * (fwd(50) + fwd(7) + 2 * mods)
    assert mmdit.solve_flops(cfg, [50], 8, guided=True) == 2 * 8 * fwd(50) + 8 * mods
    assert mmdit.solve_flops(cfg, [50, 9], 4, guided=False) == 4 * (fwd(50) + fwd(9)) + 4 * mods
    # at d = 16: 31 stream-blocks and the last block's k, v: 748·d² a frame, 1.42× the
    # DiT Base's 528·d²
    base = json.loads((ROOT / "portbench" / "configs" / "mmdit-base.json").read_text())
    assert mmdit.token_flops(mmdit.model_dims(base)) == 748 * 1024 * 1024


def test_the_program_matches_the_reference(drawn):
    from oron_tts_tpu_torch.config import F5Config
    from oron_tts_tpu_torch.models.f5tts import F5TTS

    cfg, state = drawn
    model = F5TTS.from_config(F5Config.from_dict(cfg), device="cpu", dtype=torch.float32)
    model.backbone.load_state_dict(state)
    P = mmdit.params(state, cfg, "cpu")
    g = torch.Generator().manual_seed(5)
    B, T = 8, 128
    mel = torch.randn(B, 100, T, generator=g) - 4
    ids = torch.randint(0, 64, (B, T), generator=g)
    lens = torch.tensor([128, 100, 90, 64, 50, 128, 0, 0], dtype=torch.int32)
    for p in model.backbone.parameters():
        p.requires_grad_(True)
        p.grad = None
    loss = model.cfm.loss(mel, ids, lens, torch.Generator().manual_seed(3), train=True)
    loss.backward()
    m = cfg["model"]
    d = RTrain.draws(torch.Generator().manual_seed(3), B, T, 100, mmdit.dropout_pairs(cfg),
                     (m["audio_drop_prob"], m["cond_drop_prob"]))
    want, grads = RTrain.loss_and_grads(P, mel, ids, lens, d, (0.7, 1.0), m["p_dropout"], 3,
                                         velocity=mmdit.velocity)
    assert loss.item() == pytest.approx(want, rel=1e-5)
    for (name, p), gr in zip(model.backbone.named_parameters(), grads):
        assert (p.grad - gr).norm() <= 1e-4 * gr.norm() + 1e-9, name


def train(fault: str | None = None) -> dict:
    cfg = mmdit_config()
    cfg.update(frames_threshold=2000, max_samples=8, num_workers=2)
    return training.run({"name": CELL}, cfg, tiny.mix("runpod_frames"), SEED, 2.0, False, "cpu",
                        time.perf_counter(), ROOT, fault=fault)


def test_the_mmdit_training_cell_runs_and_is_correct():
    out = train()
    ok, compared = prun.verdict(out, check.load_limits(ROOT, CELL))
    assert ok, compared
    assert out["train_frames_per_s"] > 0 and out["attempted"] > 0
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert set(prun.end_to_end(bench, cell, out)) == {"train_frames_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["half_batch", "unchanged"])
def test_an_mmdit_training_fault_is_not_correct(fault):
    ok, compared = prun.verdict(train(fault), check.load_limits(ROOT, CELL))
    assert not ok, compared
