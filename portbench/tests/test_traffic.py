"""The traffic generator: seeded, every seed the same sizes, the mixes' distributions."""

from __future__ import annotations

import math
import statistics

import numpy as np
import pytest

from portbench import audio
from portbench import traffic as tr
from portbench.reference import text as RT
from portbench.tests.tiny import ROOT, load_mix

SERVING = ("open_loop", "cloned_solo", "clients")


def letters(text: str) -> int:
    return sum(c.isalpha() for c in text)


@pytest.mark.parametrize("name", SERVING)
def test_same_seed_same_requests(name):
    mix = load_mix(name)
    a, b = tr.generate(mix, 2**31 + 5, 20.0), tr.generate(mix, 2**31 + 5, 20.0)
    assert [(r.text, r.lang, r.seed, r.due_s, r.voice) for r in a.requests] == \
           [(r.text, r.lang, r.seed, r.due_s, r.voice) for r in b.requests]
    assert [v.wav for v in a.voices] == [v.wav for v in b.voices]


@pytest.mark.parametrize("name", SERVING)
def test_every_seed_the_same_sizes(name):
    mix = load_mix(name)
    a, b = tr.generate(mix, 1, 20.0), tr.generate(mix, 987654321987, 20.0)
    assert [letters(r.text) for r in a.requests] == [letters(r.text) for r in b.requests]
    assert [r.lang for r in a.requests] == [r.lang for r in b.requests]
    assert [r.due_s for r in a.requests] == [r.due_s for r in b.requests]
    assert [r.voice for r in a.requests] == [r.voice for r in b.requests]
    assert [v.seconds for v in a.voices] == [v.seconds for v in b.voices]
    assert [r.text for r in a.requests] != [r.text for r in b.requests]
    assert [r.seed for r in a.requests] != [r.seed for r in b.requests]


@pytest.mark.parametrize("name", SERVING)
def test_lengths_follow_the_mix(name):
    mix = load_mix(name)
    spec = mix["text"]
    t = tr.generate(mix, 3, 40.0 if mix["driver"] == "closed_loop" else 200.0)
    n = [letters(r.text) for r in t.requests]
    assert min(n) >= spec["min_letters"] and max(n) <= spec["max_letters"]
    if spec["min_letters"] < spec["median_letters"] < spec["max_letters"]:
        assert abs(statistics.median(n) - spec["median_letters"]) <= 1
    logs = [math.log(x) for x in n if spec["min_letters"] < x < spec["max_letters"]]
    q1, _, q3 = statistics.quantiles(logs, n=4)
    assert (q3 - q1) / 1.349 == pytest.approx(spec["sigma"], rel=0.25)
    shares = {lang: sum(r.lang == lang for r in t.requests) / len(n)
              for lang in spec.get("langs", {"mn": 1.0})}
    for lang, share in spec.get("langs", {"mn": 1.0}).items():
        assert shares[lang] == pytest.approx(share, abs=0.02)
    for r in t.requests:  # the front end takes every text, in its language's letters
        RT.token_ids(r.text, r.lang)
        assert set(r.text) <= set(tr.ALPHABET[r.lang] + " .,")


def test_open_loop_is_a_poisson_schedule_over_the_window():
    mix = load_mix("open_loop")
    seconds, lead = 40.0, mix["lead_in_s"]
    t = tr.generate(mix, 11, seconds)
    due = [r.due_s for r in t.requests]
    assert len(due) == int(mix["rate_per_s"] * (seconds + lead))
    assert -lead < due[0] < 0 and max(due) < seconds
    assert sum(0 <= d < seconds for d in due) == pytest.approx(mix["rate_per_s"] * seconds, rel=0.1)
    gaps = np.diff(due)
    assert np.std(gaps) / np.mean(gaps) == pytest.approx(1.0, abs=0.25)  # exponential


def test_cloned_voices():
    mix = load_mix("cloned_solo")
    t = tr.generate(mix, 5, 40.0)
    ra = mix["ref_audio"]
    assert len(t.voices) == ra["voices"]
    for v in t.voices:
        pcm, sr = audio.wav_pcm16(v.wav)
        assert sr == audio.SR and ra["min_s"] <= len(pcm) / sr <= ra["max_s"]
        assert letters(v.text) == round(ra["letters_per_s"] * v.seconds)
    assert {r.voice for r in t.requests} == set(range(ra["voices"]))


def test_check_set_holds_the_longest():
    mix = load_mix("open_loop")
    t = tr.generate(mix, 8, 40.0)
    got = tr.check_set(t, 8, 0, len(t.requests))
    longest = max(t.requests, key=lambda r: len(r.text)).index
    assert longest in got and len(got) == mix["check"]["requests"]
    assert got == tr.check_set(t, 8, 0, len(t.requests))


def test_training_corpus(tmp_path):
    from portbench import training

    mix = tr.load_mix(ROOT, "runpod_frames")
    mix["corpus"].update(clips=30, recordings=2)
    meta = training.make_corpus(mix, 3, tmp_path)
    c = mix["corpus"]
    secs = sorted(len(audio.wav_pcm16((tmp_path / f"clip{i:05d}.wav").read_bytes())[0]) / audio.SR
                  for i in range(len(meta)))
    assert c["min_s"] - 0.05 <= secs[0] and secs[-1] <= c["max_s"] + 0.05
    assert statistics.median(secs) == pytest.approx(c["median_s"], rel=0.05)
    again = tmp_path / "again"
    again.mkdir()
    assert [m["text"] for m in training.make_corpus(mix, 3, again)] == [m["text"] for m in meta]
