"""The one traffic generator: a mix's JSON parameters and a seed → the run's requests.

Every seed gets the same schedule: text lengths are the lognormal's
quantiles at (i + ½)/n, clipped to the mix's range, open-loop gaps the
exponential's (rescaled so that the rate holds exactly), the languages in
their shares and the voices' durations uniform over their range, all put in
order by the mix's own ``schedule_seed``. The run's seed draws what the
requests say: the letters, the voices' audio and texts, and the row seeds.
So a seed changes the content and the noise, never how much work a run holds
nor when it arrives; an open loop's bursts are the same in every run.

An open loop also sends ``lead_in_s`` seconds of the same traffic before the
window opens, so that the window starts on a queue in its steady state;
those requests count in no metric.

Parameters a mix file may set (see ``traffic/*.json``):

- ``driver``: ``open_loop`` (Poisson arrivals at ``rate_per_s``),
  ``closed_loop`` (``clients`` each sending its next request when the last
  one answered) or ``train``;
- ``text``: ``median_letters``, ``sigma``, ``min_letters``,
  ``max_letters``, ``word_letters`` [lo, hi], ``sentence_words`` [lo, hi]
  and ``langs`` {lang: share};
- ``ref_audio`` (voice cloning): ``voices``, ``min_s``, ``max_s``,
  ``letters_per_s``;
- ``request``: the solver settings every request sends;
- ``pool``: how many requests a closed loop can draw on (cycled);
- ``check``: how many finished requests the correctness check reads.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from statistics import NormalDist

import numpy as np

from portbench import audio

ALPHABET = {"mn": "абвгдеёжзийклмноөпрстуүфхцчшщъыьэюя"}
ALPHABET["kz"] = ALPHABET["mn"] + "әғқңұһі"


@dataclass
class Request:
    index: int
    text: str
    lang: str
    seed: int
    due_s: float = 0.0          # open loop: when it falls due, from the window's start
    voice: int | None = None    # cloned: index into the voices


@dataclass
class Voice:
    wav: bytes
    text: str
    seconds: float


@dataclass
class Traffic:
    mix: dict
    requests: list[Request]
    voices: list[Voice] = field(default_factory=list)


def load_mix(root: Path, name: str) -> dict:
    return json.loads((root / "portbench" / "traffic" / f"{name}.json").read_text())


def quantile_lengths(n: int, median: float, sigma: float, lo: int, hi: int) -> list[int]:
    nd = NormalDist()
    return [int(min(hi, max(lo, round(median * math.exp(sigma * nd.inv_cdf((i + 0.5) / n))))))
            for i in range(n)]


def make_text(rng: np.random.Generator, letters: int, lang: str, spec: dict) -> str:
    """Seeded words of the language's letters, ``letters`` letters in all; sentences
    end with a full stop and now and then hold a comma."""
    wlo, whi = spec.get("word_letters", [2, 10])
    slo, shi = spec.get("sentence_words", [6, 12])
    abc = ALPHABET[lang]
    words, left = [], letters
    sentence_left = int(rng.integers(slo, shi + 1))
    while left > 0:
        n = min(left, int(rng.integers(wlo, whi + 1)))
        if 0 < left - n < wlo:  # no word shorter than the range at the end
            n = left
        word = "".join(abc[i] for i in rng.integers(0, len(abc), n))
        left -= n
        sentence_left -= 1
        if sentence_left == 0 or left == 0:
            word += "."
            sentence_left = int(rng.integers(slo, shi + 1))
        elif rng.random() < 0.08:
            word += ","
        words.append(word)
    return " ".join(words)


def generate(mix: dict, seed: int, seconds: float) -> Traffic:
    """The run's requests (and voices) for ``mix`` under ``seed``."""
    rng = np.random.default_rng(seed)
    order = np.random.default_rng(int(mix.get("schedule_seed", 0)))
    spec = mix["text"]
    lead = float(mix.get("lead_in_s", 0.0)) if mix["driver"] == "open_loop" else 0.0
    if mix["driver"] == "open_loop":
        n = max(1, int(mix["rate_per_s"] * (seconds + lead)))
    else:
        n = int(mix["pool"])
    lengths = quantile_lengths(n, spec["median_letters"], spec["sigma"],
                               spec["min_letters"], spec["max_letters"])
    lengths = [lengths[i] for i in order.permutation(n)]
    langs: list[str] = []
    for lang, share in sorted(spec.get("langs", {"mn": 1.0}).items()):
        langs += [lang] * int(round(share * n))
    langs = (langs + ["mn"] * n)[:n]
    langs = [langs[i] for i in order.permutation(n)]
    base = int(seed) % (1 << 30)
    reqs = [Request(i, make_text(rng, lengths[i], langs[i], spec), langs[i], base + 64 * i)
            for i in range(n)]
    if mix["driver"] == "open_loop":
        gaps = np.array([-math.log(1.0 - (i + 0.5) / n) for i in range(n)])
        gaps = gaps[order.permutation(n)] * ((seconds + lead) / gaps.sum())
        for r, t in zip(reqs, np.cumsum(gaps) - gaps[0] * 0.5 - lead):
            r.due_s = float(t)
    voices = []
    if "ref_audio" in mix:
        ra = mix["ref_audio"]
        k = int(ra["voices"])
        secs = [ra["min_s"] + (ra["max_s"] - ra["min_s"]) * (i + 0.5) / k for i in range(k)]
        secs = [secs[i] for i in order.permutation(k)]
        for s in secs:
            clip = audio.speech_clip(rng, s)
            text = make_text(rng, max(1, round(ra["letters_per_s"] * s)), "mn", spec)
            voices.append(Voice(audio.pcm16_wav(clip), text, s))
        for r in reqs:
            r.voice = int(order.integers(0, k))
            r.lang = "mn"
    return Traffic(mix, reqs, voices)


def check_set(traffic: Traffic, seed: int, lo: int, hi: int) -> list[int]:
    """Indices of the requests whose answers the correctness check reads: the longest
    of ``requests[lo:hi]`` and others of them drawn from the seed."""
    want = int(traffic.mix.get("check", {}).get("requests", 6))
    pool = traffic.requests[lo:hi]
    longest = max(pool, key=lambda r: len(r.text)).index
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])
    others = [pool[int(i)].index for i in rng.permutation(len(pool))
              if pool[int(i)].index != longest]
    return sorted([longest] + others[: want - 1])
