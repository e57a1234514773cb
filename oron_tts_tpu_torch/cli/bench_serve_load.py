"""Tail latency of the HTTP server under concurrent mixed-length load (PyTorch port).

    python -m oron_tts_tpu_torch.cli.bench_serve_load                 # the card, Base
    python -m oron_tts_tpu_torch.cli.bench_serve_load --profile fast
    python -m oron_tts_tpu_torch.cli.bench_serve_load --clients 64 --request-timeout 5.4 \\
        --label shed
    python -m oron_tts_tpu_torch.cli.bench_serve_load --device cpu --dim 64 --depth 2 \\
        --heads 2 --text-dim 32 --clients 8 --requests 12 --steps 2 --out load.json

Counterpart of the JAX package's ``scripts/bench_serve_load.py``. The port's
server (``cli/serve.py``: ``Service``, ``MicroBatcher``,
``DrainingHTTPServer``) runs in this process on 127.0.0.1 over a model with
seeded random weights (latency depends on the architecture, not the
weights) and the bundled Vocos (or ``--vocoder``). One warm-up request per length class goes
through the server before the clock starts, so kernel builds and first
launches fall outside it (``warmup_s``). Then N client threads send
``/synthesize`` requests of three lengths (4, 12 and 24 four-letter words:
16, 48 and 96 letters), round-robin, request i with seed i, each client
retrying a 429 after its ``Retry-After`` and a 504 after 2 s until served.
Reported: latency p50/p95/p99/mean, overall and by length, requests and
audio seconds a second, merged batches, 429s, 504s, shed requests, the
batcher's solve-time estimate at the end, and the card. The payload lands in
``--out`` under ``profiles.<label>`` (the label defaults to the profile).
"""

from __future__ import annotations

import argparse
import json
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np

REPO_ROOT = Path(__file__).resolve().parents[2]
WORDS = (4, 12, 24)          # -> 16 / 48 / 96 letters
LENGTHS = tuple(4 * w for w in WORDS)
LETTERS = list("абвгдежзиклмнопрстуфхцчшыэюя")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Serving latency under concurrent load")
    ap.add_argument("--clients", type=int, default=32)
    ap.add_argument("--requests", type=int, default=96,
                    help="total requests across all clients")
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--dim", type=int, default=1024)
    ap.add_argument("--depth", type=int, default=22)
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--text-dim", type=int, default=512)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--max-queue", type=int, default=64,
                    help="the server's cap on queued requests; beyond it, 429 + Retry-After")
    ap.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    ap.add_argument("--vocoder", type=str, default=None,
                    help="as cli.serve's: a Vocos file or griffin_lim (default: the bundled Vocos)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", choices=["default", "fast"], default="default",
                    help="'fast' is serve.py's --profile fast: int8_dynamic weights and the "
                         "guidance interval as defaults")
    ap.add_argument("--request-timeout", type=float, default=120.0,
                    help="the server's wait ceiling; low values exercise admission control "
                         "(429 + Retry-After) under this burst")
    ap.add_argument("--label", type=str, default=None,
                    help="key of this run under 'profiles' in --out (default: the profile)")
    ap.add_argument("--out", type=Path, default=REPO_ROOT / "SERVE_LOAD_h100.json")
    return ap


def request_texts(n: int, seed: int) -> list[str]:
    """The fixed schedule: round-robin lengths, seeded four-letter words."""
    rng = np.random.default_rng(seed)
    return [" ".join("".join(rng.choice(LETTERS, size=4)) for _ in range(WORDS[i % len(WORDS)]))
            for i in range(n)]


def pct(xs: list[float], q: float) -> float:
    s = sorted(xs)
    return s[min(len(s) - 1, int(len(s) * q))]


def _post(port: int, body: bytes) -> None:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/synthesize", data=body,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=600) as resp:
        if resp.status != 200:
            raise RuntimeError(f"/synthesize answered {resp.status}")
        resp.read()


def build_model(args: argparse.Namespace):
    """The served model: random weights from ``init_params(seed)`` at the flags' width."""
    from oron_tts_tpu_torch.config import F5Config
    from oron_tts_tpu_torch.models.f5tts import F5TTS

    cfg = {"sample_rate": 24000, "n_mels": 100,
           "model": {"vocab_size": 65, "dim": args.dim, "depth": args.depth,
                     "heads": args.heads, "ff_mult": 4 if args.dim >= 512 else 2,
                     "text_dim": args.text_dim, "conv_layers": 4, "p_dropout": 0.0}}
    model = F5TTS.from_config(F5Config.from_dict(cfg), device=args.device)
    model.init_params(args.seed)
    model.load_vocoder(args.vocoder)
    if args.profile == "fast":
        model.quantize_for_serving("int8_dynamic")
    return model


def main(argv: list[str] | None = None, model=None) -> dict:
    """Run the bench; ``model`` (from :func:`build_model` with the same flags) skips the
    build, so one process can load once and run several ceilings."""
    args = build_parser().parse_args(argv)
    import torch

    from oron_tts_tpu_torch.cli import serve
    from oron_tts_tpu_torch.utils.device import card_name

    if model is None:
        model = build_model(args)
    profile_defaults = {}
    if args.profile == "fast":
        profile_defaults = {"cfg_interval": serve.FAST_PROFILE_CFG_INTERVAL}
    card = card_name(model.device)
    print(f"device={model.device} ({card}) params={model.num_params() / 1e6:.0f}M", flush=True)

    service = serve.Service(model, max_batch=args.max_batch, max_queue=args.max_queue,
                            request_timeout_s=args.request_timeout,
                            profile_defaults=profile_defaults)
    httpd = serve.DrainingHTTPServer(("127.0.0.1", 0), service)
    server_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    server_thread.start()
    port = httpd.server_address[1]
    try:
        # one request a length class through the server: kernel builds, the
        # vocoder's load and the first launches stay outside the clock, and
        # outside the wait ceiling under test
        t0 = time.perf_counter()
        service.request_timeout_s = max(args.request_timeout, 600.0)
        for text in request_texts(len(WORDS), args.seed + 1):
            _post(port, json.dumps({"text": text, "steps": args.steps, "seed": 0}).encode())
        if model.device.type == "cuda":
            torch.cuda.synchronize()
        service.request_timeout_s = args.request_timeout
        warm_s = time.perf_counter() - t0
        merged_before = service.batcher.merged_batches
        shed_before = service.batcher.shed_requests

        reqs = request_texts(args.requests, args.seed)
        lat: list[float] = []
        lat_by_len: dict[int, list[float]] = {n: [] for n in LENGTHS}
        shed = {"n429": 0, "n504": 0}
        lock = threading.Lock()
        it = iter(enumerate(reqs))
        errors: list[BaseException] = []

        def client() -> None:
            while True:
                with lock:
                    try:
                        i, text = next(it)
                    except StopIteration:
                        return
                body = json.dumps({"text": text, "steps": args.steps, "seed": i}).encode()
                t = time.perf_counter()
                served, conn_errors = False, 0
                for _ in range(50):
                    try:
                        _post(port, body)
                        served = True
                        break
                    except urllib.error.HTTPError as exc:
                        exc.read()
                        if exc.code == 429:
                            with lock:
                                shed["n429"] += 1
                            time.sleep(float(exc.headers.get("Retry-After", 1)))
                            continue
                        if exc.code == 504:
                            with lock:
                                shed["n504"] += 1
                            # back off: an immediate retry hammers a busy device
                            time.sleep(2.0)
                            continue
                        raise
                    except OSError:  # a reset connection; 429s do not spend this budget
                        conn_errors += 1
                        if conn_errors > 3:
                            raise
                        time.sleep(0.2 * conn_errors)
                if not served:
                    raise RuntimeError(f"request {i} never served after 50 attempts")
                dt = time.perf_counter() - t
                with lock:
                    lat.append(dt)
                    lat_by_len[LENGTHS[i % len(LENGTHS)]].append(dt)

        def guarded() -> None:
            try:
                client()
            except BaseException as exc:  # noqa: BLE001 - re-raised on the main thread
                with lock:
                    errors.append(exc)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=guarded) for _ in range(args.clients)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
        server_thread.join(timeout=30)
    if errors:
        raise errors[0]
    if len(lat) != args.requests:
        raise RuntimeError(f"{args.requests - len(lat)} requests were never served")

    audio_s = sum(int(LENGTHS[i % len(LENGTHS)] * 13) / 93.75 for i in range(len(reqs)))
    payload = {
        "clients": args.clients, "requests": args.requests, "steps": args.steps,
        "max_batch": args.max_batch, "max_queue": args.max_queue, "profile": args.profile,
        "model": {"dim": args.dim, "depth": args.depth, "heads": args.heads,
                  "dtype": str(model.dtype).replace("torch.", ""),
                  "quantize": model.quant_mode},
        "device": str(model.device), "card": card,
        "warmup_s": warm_s,
        "wall_s": wall,
        "req_per_s": len(lat) / wall,
        "audio_s_per_s": audio_s / wall,
        "latency_ms": {"p50": pct(lat, 0.50) * 1e3, "p95": pct(lat, 0.95) * 1e3,
                       "p99": pct(lat, 0.99) * 1e3, "mean": float(np.mean(lat)) * 1e3},
        "latency_ms_by_chars": {
            str(n): {"p50": pct(v, 0.5) * 1e3, "p95": pct(v, 0.95) * 1e3,
                     "p99": pct(v, 0.99) * 1e3}
            for n, v in lat_by_len.items() if v},
        "merged_batches": service.batcher.merged_batches - merged_before,
        "request_timeout_s": args.request_timeout,
        "responses_429": shed["n429"],
        "responses_504": shed["n504"],
        "shed_requests": service.batcher.shed_requests - shed_before,
        "solve_estimate_s": service.batcher.solve_estimate_s,
    }
    label = args.label or args.profile
    existing: dict = {}
    if args.out.exists():
        try:
            existing = json.loads(args.out.read_text())
        except ValueError:
            existing = {}
    existing.setdefault("profiles", {})[label] = payload
    args.out.write_text(json.dumps(existing, indent=1))
    print(json.dumps(payload, indent=1))
    print(f"wrote {args.out} [{label}]")
    return payload


if __name__ == "__main__":
    main()
