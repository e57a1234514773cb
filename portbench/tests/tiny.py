"""A tiny width of the benchmark's configurations and mixes, for runs on the CPU, and the
serving mixes and limits that no cell of ``BENCHMARK.json`` runs yet."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from portbench import traffic as tr

ROOT = Path(__file__).resolve().parents[2]


def config(name: str = "oron-base") -> dict:
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    cfg["model"].update(dim=64, depth=2, heads=2, text_dim=32, ff_mult=2)
    return cfg


def small(depth: int) -> dict:
    """The Small DiT's widths (local.yaml: dim 512, heads 8, text_dim 256) at ``depth``
    blocks, on Base's serving settings, which Small shares."""
    cfg = json.loads((ROOT / "portbench" / "configs" / "oron-base.json").read_text())
    cfg["model"].update(dim=512, depth=depth, heads=8, text_dim=256)
    return cfg


# The serving modes of the generator and the server, which no cell of BENCHMARK.json
# runs yet (PERF.md, Open questions): an open loop, a voice-cloned solo client, and a
# many-client closed loop.
TEST_MIXES = {
    "open_loop": {
        "driver": "open_loop", "schedule_seed": 16001, "lead_in_s": 8.0, "rate_per_s": 3.0,
        "max_in_flight": 128,
        "text": {"median_letters": 48, "sigma": 0.6, "min_letters": 12, "max_letters": 240,
                 "word_letters": [2, 10], "sentence_words": [6, 12],
                 "langs": {"mn": 0.8, "kz": 0.2}},
        "request": {"steps": 32, "cfg_strength": 2.0, "sway_sampling_coef": -1.0, "speed": 1.0},
        "server": {"max_batch": 16, "max_queue": 64},
        "check": {"requests": 6},
    },
    "cloned_solo": {
        "driver": "closed_loop", "schedule_seed": 16002, "clients": 1, "pool": 400,
        "text": {"median_letters": 40, "sigma": 0.6, "min_letters": 8, "max_letters": 120,
                 "word_letters": [2, 10], "sentence_words": [6, 12], "langs": {"mn": 1.0}},
        "ref_audio": {"voices": 8, "min_s": 3.0, "max_s": 10.0, "letters_per_s": 12},
        "request": {"steps": 32, "cfg_strength": 2.0, "sway_sampling_coef": -1.0, "speed": 1.0},
        "server": {"max_batch": 16, "max_queue": 64},
        "check": {"requests": 6, "candidates": 24},
    },
    "clients": {
        "driver": "closed_loop", "schedule_seed": 16003, "clients": 16, "pool": 600,
        "text": {"median_letters": 200, "sigma": 0.4, "min_letters": 120, "max_letters": 360,
                 "word_letters": [2, 10], "sentence_words": [6, 12],
                 "langs": {"mn": 0.8, "kz": 0.2}},
        "request": {"steps": 32, "cfg_strength": 2.0, "sway_sampling_coef": -1.0, "speed": 1.0},
        "server": {"max_batch": 16, "max_queue": 64},
        "check": {"requests": 4, "candidates": 32},
    },
}


# The serving check's limits, set on the card from the Small cloned cell's readings at
# its full size (PERF.md): the program's largest reading and the control's smallest.
_CONTROL = "the control: f32 reference with fp8 DiT products and TF32 vocoder and mel products"
SERVE_LIMITS = {
    "mel_gap": {"limit": 0.018, "lower": 0.005538340568933505, "upper": 0.0429018323551771,
                "upper_from": _CONTROL},
    "wav_gap": {"limit": 0.001, "lower": 0.00010879849219889557, "upper": 0.005777038242627072,
                "upper_from": _CONTROL},
    "ref_mel_gap": {"limit": 1e-05, "lower": 1.7099098723018346e-07,
                    "upper": 0.0001396262802994655, "upper_from": _CONTROL},
}


def load_mix(name: str) -> dict:
    """A test mix by name, else the benchmark's mix file of that name."""
    if name in TEST_MIXES:
        return copy.deepcopy(TEST_MIXES[name])
    return tr.load_mix(ROOT, name)


def mix(name: str) -> dict:
    m = load_mix(name)
    if "request" in m:
        m["request"]["steps"] = 2
        m["text"]["max_letters"] = min(150, m["text"]["max_letters"])
    if m["driver"] == "open_loop":  # a backlog the CPU clears within a short window
        m["rate_per_s"], m["lead_in_s"] = 4.0, 1.0
    if m["driver"] == "closed_loop":  # a merged batch the CPU finishes within one
        m["clients"] = min(m["clients"], 4)
    if m["driver"] == "train":
        m["corpus"].update(clips=40, recordings=2, max_s=4.0, median_s=2.0)
    return m


def train_config() -> dict:
    cfg = config("oron-base")
    cfg.update(frames_threshold=2000, max_samples=8, num_workers=2)
    return cfg
