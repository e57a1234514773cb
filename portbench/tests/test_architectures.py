"""A configuration's architecture is found by its backbone, and a new one needs no harness edit.

The DiT that ``oron-base`` names (by default) goes through the dispatch bit for bit as
it went through direct calls; a stub architecture, registered as a module of
``portbench.reference`` for one test, goes through the training check's reference
side, the window's FLOP count and the weights' draw.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

from portbench import check, check_train, training
from portbench import run as prun
from portbench.reference import architecture, dit
from portbench.reference import train as RTrain
from portbench.reference.layers import fp8_rows
from portbench.tests import tiny
from portbench.weights import MEL_MEAN, dit_state

ROOT = tiny.ROOT
CELL = "base.train.48k"
SEED = 2**31 + 4242


def checkout(tmp_path, cfg: dict):
    """A checkout holding ``BENCHMARK.json`` and ``cfg`` as ``oron-base``'s file."""
    (tmp_path / "portbench" / "configs").mkdir(parents=True)
    (tmp_path / "portbench" / "configs" / "oron-base.json").write_text(json.dumps(cfg))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def base_config() -> dict:
    return json.loads((ROOT / "portbench" / "configs" / "oron-base.json").read_text())


# ── (a) the selector ──────────────────────────────────────────────────────


@pytest.mark.parametrize("how", ["as_is", "named", "key_removed"])
def test_oron_base_resolves_to_the_dit(tmp_path, how):
    root = ROOT
    if how != "as_is":
        cfg = base_config()
        if how == "named":
            cfg["model"]["backbone"] = "DiT"
        else:
            cfg["model"].pop("backbone", None)
        root = checkout(tmp_path, cfg)
    _, _, cfg = prun.load_spec(root, CELL)
    assert architecture(cfg) is dit


@pytest.mark.parametrize("name,says", [
    ("NoSuchNet", "portbench/reference/nosuchnet.py is missing"),
    ("Mel", "portbench/reference/mel.py lacks params, velocity, dropout_pairs"),
    ("E2-TTS", "no module name, so no portbench/reference/e2-tts.py"),
])
def test_an_unknown_backbone_stops_in_load_spec_naming_the_file(tmp_path, name, says):
    cfg = base_config()
    cfg["model"]["backbone"] = name
    root = checkout(tmp_path, cfg)
    with pytest.raises(SystemExit) as exc:
        prun.load_spec(root, CELL)
    assert says in str(exc.value.code)


def test_the_run_stops_before_set_up_on_an_unknown_backbone(tmp_path):
    cfg = base_config()
    cfg["model"]["backbone"] = "NoSuchNet"
    root = checkout(tmp_path, cfg)
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELL, "--seed",
                          str(SEED), "--seconds", "1", "--trace", "0"], cwd=root,
                         env={**os.environ, "PYTHONPATH": str(ROOT)}, capture_output=True,
                         text=True, timeout=300)
    # exit 1 with the message, not 2: it stopped before it looked for a card
    assert out.returncode == 1 and out.stdout.strip() == ""
    assert "portbench/reference/nosuchnet.py is missing" in out.stderr


# ── (b) the DiT through the dispatch, as it was through direct calls ──────


def rules_before(key: str, shape: tuple[int, ...]) -> tuple[float, float]:
    """``portbench/weights.py``'s rules as they were before architectures had a say."""
    if key == "proj_out.bias":
        return 0.02, MEL_MEAN
    if key.endswith(".bias") or key.endswith("grn.gamma") or key.endswith("grn.beta"):
        return 0.02, 0.0
    if key.endswith("norm.weight") and len(shape) == 1:
        return 0.02, 1.0
    if key.endswith("embed.weight") and len(shape) == 2:
        return 1.0, 0.0
    if len(shape) == 3:
        return 1.0 / math.sqrt(shape[0] * shape[1]), 0.0
    if len(shape) == 2:
        return 1.0 / math.sqrt(shape[1]), 0.0
    raise ValueError(key)


def state_before(shapes: dict, seed: int) -> dict:
    gen = torch.Generator().manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)
    flat = torch.randn(sum(math.prod(s) for s in shapes.values()), generator=gen)
    out, at = {}, 0
    for key, shape in shapes.items():
        n = math.prod(shape)
        std, mean = rules_before(key, shape)
        out[key] = flat[at: at + n].view(shape) * std + mean
        at += n
    return out


@pytest.fixture(scope="module")
def tiny_shapes():
    from oron_tts_tpu_torch.config import F5Config
    from oron_tts_tpu_torch.models.f5tts import F5TTS

    cfg = tiny.config()
    model = F5TTS.from_config(F5Config.from_dict(cfg), device="cpu", dtype=torch.float32)
    return cfg, {k: tuple(v.shape) for k, v in model.backbone.state_dict().items()}


def direct_velocity(P, x, cond, ids, t, mask, drop_audio, drop_text, dropout=None):
    """What the training loss called before the dispatch: the DiT's functions by name."""
    te = dit.text_embedding(P, ids, x.shape[1], drop=drop_text)
    return dit.dit_forward(P, x, cond, te, t, mask, drop_audio=drop_audio, dropout=dropout)


def test_the_dispatched_dit_draws_trains_and_counts_as_before(tiny_shapes):
    cfg, shapes = tiny_shapes
    m = cfg["model"]
    arch = architecture(cfg)
    state = dit_state(shapes, SEED, "cpu", torch.float32, arch)
    before = state_before(shapes, SEED)
    assert list(state) == list(before)
    assert all(torch.equal(state[k], before[k]) for k in state)
    P, Pd = arch.params(state, cfg, "cpu"), dit.Params(state, m["heads"])
    assert all(torch.equal(P.p[k], Pd.p[k]) for k in Pd.p)

    g = torch.Generator().manual_seed(5)
    B, T = 8, 128
    mel = torch.randn(B, 100, T, generator=g) - 4
    ids = torch.randint(0, 64, (B, T), generator=g)
    lens = torch.tensor([128, 100, 90, 64, 50, 128, 0, 0], dtype=torch.int32)
    probs = (m["audio_drop_prob"], m["cond_drop_prob"])
    d = RTrain.draws(torch.Generator().manual_seed(3), B, T, 100, arch.dropout_pairs(cfg), probs)
    assert len(d["seeds"]) == m["depth"]
    rate = m["p_dropout"]
    got = RTrain.loss_and_grads(P, mel, ids, lens, d, (0.7, 1.0), rate, 3,
                                velocity=arch.velocity)
    want = RTrain.loss_and_grads(Pd, mel, ids, lens, d, (0.7, 1.0), rate, 3,
                                 velocity=direct_velocity)
    assert got[0] == want[0]
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


# the counts portbench/flops.py gave at oron-base before they moved beside the DiT
FLOPS_BEFORE = [
    ("train_step_flops", ([500, 0],), 926209327104.0),
    ("train_step_flops", ([1600, 913, 64, 0],), 5342050160640.0),
    ("solve_flops", ([500], 32, True), 19489204043776),
    ("solve_flops", ([500, 1211], 16, False), 17918431367168),
]


@pytest.mark.parametrize("fn,args,want", FLOPS_BEFORE)
def test_the_dispatched_flop_count_is_the_one_before(fn, args, want):
    cfg = base_config()
    assert getattr(architecture(cfg), fn)(cfg, *args) == want


def test_the_window_flops_sum_the_steps_by_their_share():
    steps = [{"share": 1.0, "lengths": [500, 0]}, {"share": 0.5, "lengths": [1600, 913, 64, 0]}]
    assert training.window_flops(base_config(), steps) == 926209327104.0 + 0.5 * 5342050160640.0


# ── (c) a new architecture, as new files only ─────────────────────────────

STUB = "portbench.reference.stubnet"
HIDDEN, TEXT = 24, 8


def stub_architecture() -> types.ModuleType:
    """A two-block MLP backbone with its own FLOP count and one weight of its own."""
    mod = types.ModuleType(STUB)
    n_in = 2 * 100 + TEXT + 1

    def shapes(cfg):
        return {"embed.weight": (cfg["model"]["vocab_size"] + 1, TEXT),
                "blocks.0.proj.weight": (HIDDEN, n_in), "blocks.0.proj.bias": (HIDDEN,),
                "blocks.1.proj.weight": (HIDDEN, HIDDEN), "blocks.1.proj.bias": (HIDDEN,),
                "blocks.gain": (HIDDEN,),  # no rule of portbench/weights.py knows it
                "proj_out.weight": (100, HIDDEN), "proj_out.bias": (100,)}

    def params(state, cfg, device="cpu", quant=None):
        p = {k: v.detach().to(device=device, dtype=torch.float32) for k, v in state.items()}
        return types.SimpleNamespace(p=p, quant=quant)

    def linear(P, h, name):
        w, b = P.p[name + ".weight"], P.p[name + ".bias"]
        if P.quant == "fp8":
            return torch.matmul(fp8_rows(h), fp8_rows(w).t()) + b
        return torch.matmul(h, w.t()) + b

    def velocity(P, x, cond, ids, t, mask, drop_audio, drop_text, dropout=None):
        B, T, _ = x.shape
        if drop_audio:
            cond = torch.zeros_like(cond)
        shifted = torch.nn.functional.pad(ids.long() + 1, (0, max(0, T - ids.shape[1])))[:, :T]
        if drop_text:
            shifted = torch.zeros_like(shifted)
        h = torch.cat([x, cond, P.p["embed.weight"][shifted],
                       t.float()[:, None, None].expand(B, T, 1)], dim=-1)
        for i in range(2):
            h = torch.tanh(linear(P, h, f"blocks.{i}.proj"))
            if dropout is not None:
                h = dropout(i)("ff", h)
        return linear(P, h * P.p["blocks.gain"], "proj_out") * mask[..., None]

    def forward_flops(frames):
        return 2 * frames * (n_in * HIDDEN + HIDDEN * HIDDEN + HIDDEN * 100)

    mod.shapes, mod.params, mod.velocity = shapes, params, velocity
    mod.dropout_pairs = lambda cfg: 2
    mod.train_step_flops = lambda cfg, rows: 3.0 * sum(forward_flops(n) for n in rows if n > 0)
    mod.solve_flops = lambda cfg, rows, steps, guided=True: (
        (2 if guided else 1) * steps * sum(forward_flops(n) for n in rows))
    mod.weight_rule = lambda key, shape: (0.1, 1.0) if key == "blocks.gain" else None
    return mod


def test_a_new_architecture_comes_in_as_files_only(tmp_path, monkeypatch):
    stub = stub_architecture()
    monkeypatch.setitem(sys.modules, STUB, stub)
    cfg = tiny.train_config()
    cfg["model"]["backbone"] = "StubNet"
    assert architecture(cfg) is stub
    prun.load_spec(checkout(tmp_path / "checkout", cfg), CELL)  # the selector takes it

    # the weights: the harness's rules, and the architecture's for its own key
    shapes = stub.shapes(cfg)
    with pytest.raises(ValueError, match="blocks.gain"):
        dit_state(shapes, SEED, "cpu", torch.float32, dit)  # the DiT has no rule for it
    state = dit_state(shapes, SEED, "cpu", torch.float32, stub)
    assert list(state) == list(shapes)
    assert abs(float(state["blocks.gain"].mean()) - 1.0) < 0.1

    # the training check's reference side: three steps of the reference and of the
    # control in the program's place, compared by the four numbers
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    meta = training.make_corpus(tiny.mix("runpod_frames"), SEED, corpus)
    out = {"names": list(shapes), "check_clips": [[0, 1], [2, 3], [4, 5]], "ok": [True] * 3}
    res = check_train.training(cfg, cfg, meta, out, SEED, shapes, "cpu", control=True)
    assert set(res["numbers"]) == {"loss_gap", "grad_gap", "update_gap", "ema_gap"}
    assert all(math.isfinite(v) for v in res["numbers"].values())
    assert res["numbers"]["loss_gap"] > 0  # the control's float8 products ran in the stub
    assert len(res["steps"]["reference_loss"]) == 3

    # the traced window's model FLOPs are the architecture's count
    steps = [{"share": 1.0, "lengths": [100, 0]}, {"share": 0.5, "lengths": [64, 32]}]
    assert training.window_flops(cfg, steps) == (stub.train_step_flops(cfg, [100, 0])
                                                 + 0.5 * stub.train_step_flops(cfg, [64, 32]))

    # a serving cell's check needs sample(), which this architecture lacks
    with pytest.raises(LookupError, match="stubnet.py has no sample"):
        check.serving(cfg, None, None, [], {}, SEED, shapes, "cpu")


def test_a_new_cell_reports_its_throughput_through_an_entry_of_its_own(tmp_path, monkeypatch):
    """A training cell of the stub architecture, added to BENCHMARK.json as new entries
    only, gets its throughput: an end-to-end entry ``train_frames_per_s.stub`` that lists
    it reads the training record's ``train_frames_per_s``; the accepted cell's line is as
    it was."""
    monkeypatch.setitem(sys.modules, STUB, stub_architecture())
    cfg = tiny.train_config()
    cfg["model"]["backbone"] = "StubNet"
    root = checkout(tmp_path / "checkout", base_config())
    (root / "portbench" / "configs" / "stub.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "stub", "source": "a test",
                             "file": "portbench/configs/stub.json", "reduced": [],
                             "why": "a second architecture"})
    bench["workloads"].append({"name": "stub.train", "config": "stub",
                               "traffic": "runpod_frames", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "train_frames_per_s.stub", "unit": "frames/s",
                                "better": "higher", "bound": 0.1, "source": "host_clock",
                                "workloads": ["stub.train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    _, cell, got = prun.load_spec(root, "stub.train")
    assert architecture(got) is sys.modules[STUB]

    rec = {"train_frames_per_s": 1234.5, "setup_s": 6.5}  # the keys training.run writes
    assert prun.end_to_end(bench, cell, rec) == {
        "train_frames_per_s.stub": {"value": 1234.5, "unit": "frames/s"},
        "setup_s": {"value": 6.5, "unit": "s"}}
    base = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert prun.end_to_end(bench, base, rec) == {
        "train_frames_per_s": {"value": 1234.5, "unit": "frames/s"},
        "setup_s": {"value": 6.5, "unit": "s"}}
