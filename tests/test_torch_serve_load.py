"""PyTorch port, the serving benches ``cli.bench_serve_load`` and ``cli.bench_streaming`` (CPU).

A tiny model (dim 64, depth 2) and a tiny seeded Vocos behind the port's own
server in this process: 8 clients send 12 mixed-length requests of 2 steps.
Every request is served, the payload carries the JAX script's keys (and the
port's own), and a short queue sheds requests with 429s that the clients
retry until served. The streaming bench installs its seeded Vocos through
``set_vocoder`` and reports time to first audio.
"""

import json

import pytest
import torch

from oron_tts_tpu_torch.cli import bench_serve_load, bench_streaming

from test_torch_griffin_lim import _official_vocos

TINY = ["--device", "cpu", "--dim", "64", "--depth", "2", "--heads", "2", "--text-dim", "32",
        "--steps", "2"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny models on one intra-op thread: on a CPU shared by several test workers,
    each op's thread team would otherwise wait on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def load_args(tmp_path_factory):
    """8 clients, 12 requests, and a seeded two-layer Vocos of width 64: the default
    one decodes a 96-letter request for seconds on a busy CPU."""
    path = tmp_path_factory.mktemp("vocos") / "vocos.pt"
    torch.save(_official_vocos(), path)
    return TINY + ["--clients", "8", "--requests", "12", "--vocoder", str(path)]
# the JAX script's payload keys (scripts/bench_serve_load.py), less XLA's prewarm
JAX_KEYS = {"clients", "requests", "steps", "max_batch", "model", "wall_s", "req_per_s",
            "audio_s_per_s", "latency_ms", "latency_ms_by_chars", "merged_batches",
            "request_timeout_s", "responses_429", "responses_504", "shed_requests"}


def test_texts_follow_the_jax_schedule():
    texts = bench_serve_load.request_texts(7, seed=0)
    assert [len(t.replace(" ", "")) for t in texts] == [16, 48, 96, 16, 48, 96, 16]
    assert all(len(w) == 4 for t in texts for w in t.split())
    assert texts == bench_serve_load.request_texts(7, seed=0)


def test_default_run_serves_every_request(tmp_path, load_args):
    out = tmp_path / "load.json"
    payload = bench_serve_load.main(load_args + ["--out", str(out)])
    assert JAX_KEYS <= payload.keys()
    assert {"warmup_s", "card", "device", "solve_estimate_s"} <= payload.keys()
    assert payload["card"] == "cpu" and payload["requests"] == 12
    assert payload["responses_429"] == payload["responses_504"] == payload["shed_requests"] == 0
    assert set(payload["latency_ms"]) == {"p50", "p95", "p99", "mean"}
    assert set(payload["latency_ms_by_chars"]) == {"16", "48", "96"}
    lat = payload["latency_ms"]
    assert 0 < lat["p50"] <= lat["p95"] <= lat["p99"]
    assert payload["merged_batches"] >= 1  # 8 clients at once: requests share solves
    written = json.loads(out.read_text())
    assert written["profiles"]["default"] == json.loads(json.dumps(payload))


def test_admission_control_sheds_and_every_request_is_still_served(tmp_path, load_args):
    """A queue of two: of 8 requests at once, those that find it full are answered
    429 and served on a retry.

    The wait ceiling stays high on purpose. The server counts a request's own
    solve against its ceiling, and a solve's time on a shared CPU is unknown (the
    vocoder alone takes seconds under load): a ceiling low enough to shed here
    would also time out requests whose solve outlasts it, on every retry. The
    ceiling's shedding is held on the card (chip_smoke.py, serve_load)."""
    out = tmp_path / "load.json"
    out.write_text(json.dumps({"profiles": {"default": {"kept": True}}}))
    payload = bench_serve_load.main(load_args + ["--out", str(out), "--max-queue", "2",
                                            "--label", "shed"])
    assert payload["responses_429"] > 0 and payload["shed_requests"] > 0
    assert payload["responses_504"] == 0 and payload["max_queue"] == 2
    assert payload["requests"] == 12  # main raises if one was never served
    profiles = json.loads(out.read_text())["profiles"]
    assert profiles["default"] == {"kept": True} and "shed" in profiles


def test_streaming_reports_time_to_first_audio():
    payload = bench_streaming.main(TINY + ["--chars", "260", "--runs", "1", "--vocoder-dim", "64",
                                           "--vocoder-layers", "2"])
    assert payload["chunks"] >= 3 and payload["pieces"] >= payload["chunks"]
    assert 0 < payload["ttfa_s"] < payload["total_s"]
    assert payload["audio_s"] > 0 and payload["rtf_total"] == pytest.approx(
        payload["total_s"] / payload["audio_s"])
