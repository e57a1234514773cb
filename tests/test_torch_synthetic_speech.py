"""``cli.make_synthetic_speech`` against the JAX package's script: the same WAV
bytes and ``metadata.json`` (``audio_path`` aside) for a seed, a family and
``--augment-prob``."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import pytest

from oron_tts_tpu_torch.cli import make_synthetic_speech

from conftest import REPO_ROOT

_spec = importlib.util.spec_from_file_location(
    "jax_make_synthetic_speech", REPO_ROOT / "scripts" / "make_synthetic_speech.py")
jsynth = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jsynth)


@pytest.mark.parametrize("extra", [["--family", "train"], ["--family", "ood"],
                                   ["--family", "train", "--augment-prob", "0.5"],
                                   ["--family", "train", "--coverage-fraction", "0.6"]])
def test_corpus_is_byte_identical_to_the_script(tmp_path, monkeypatch, extra):
    args = ["-n", "5", "--seed", "7"] + extra
    monkeypatch.setattr(sys, "argv", ["make_synthetic_speech.py", "--out",
                                      str(tmp_path / "jax")] + args)
    jsynth.main()
    meta = make_synthetic_speech.main(["--out", str(tmp_path / "port")] + args)
    want = json.loads((tmp_path / "jax" / "metadata.json").read_text())
    got = json.loads((tmp_path / "port" / "metadata.json").read_text())
    assert got == meta and len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert Path(g["audio_path"]).parent == tmp_path / "port" / "wavs"
        assert Path(g["audio_path"]).read_bytes() == Path(w["audio_path"]).read_bytes()
        assert {k: v for k, v in g.items() if k != "audio_path"} == \
            {k: v for k, v in w.items() if k != "audio_path"}
