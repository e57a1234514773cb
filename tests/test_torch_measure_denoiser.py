"""``cli.measure_denoiser``: the port's denoiser measurement reproduces the JAX script's
``DENOISER.json`` row for row, and never writes that file."""

from __future__ import annotations

import json
from pathlib import Path

from oron_tts_tpu_torch.cli import measure_denoiser

REPO = Path(__file__).resolve().parent.parent


def test_rows_equal_the_jax_scripts_table(tmp_path):
    out = tmp_path / "denoiser.json"
    payload = measure_denoiser.main(["--out", str(out)])
    want = json.loads((REPO / "DENOISER.json").read_text())
    written = json.loads(out.read_text())
    assert written == payload
    assert len(want["rows"]) == 20
    # SNRs and mel-L1 as the JAX script rounds them (2 and 4 places)
    assert written["rows"] == want["rows"]
    assert written["backends_measured"] == want["backends_measured"]


def test_default_out_is_not_the_jax_file(tmp_path, monkeypatch):
    monkeypatch.setattr(measure_denoiser, "REPO_ROOT", tmp_path)
    monkeypatch.setattr(measure_denoiser, "SNRS_DB", (20.0,))
    payload = measure_denoiser.main([])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["DENOISER_torch.json"]
    assert len(payload["rows"]) == 5
