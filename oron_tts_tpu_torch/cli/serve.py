"""HTTP server for synthesis with the PyTorch port (one GPU or a mesh).

    python -m oron_tts_tpu_torch.cli.serve --checkpoint <dir-or-.npz> \\
        [--port 8080] [--quantize int8|int8_dynamic] [--profile fast] [--device cpu]

    python -m torch.distributed.run --nproc-per-node 4 \\
        -m oron_tts_tpu_torch.cli.serve --checkpoint <dir> --mesh 2x2

POST /synthesize  {"text": "...", "lang": "mn", "steps": 32, "seed": 0,
                   "cfg_strength": 2.0, "speed": 1.0, "cfg_interval": [lo, hi],
                   "method": "euler"}  → audio/wav bytes.
                  Voice cloning: add "ref_audio_b64" (base64 WAV) or
                  "ref_audio_path" (a file on the server) and "ref_text"; it
                  works on all three synthesis endpoints, and
                  /synthesize_batch clones one voice across the whole batch.
POST /synthesize_stream  same body → chunked audio/wav: a WAV header, then
                   PCM16 pieces as each text chunk's solve is fetched (time to
                   first audio is one single-chunk solve).
POST /synthesize_batch {"texts": [...], ...} → JSON
                   {"wavs_base64": [...], "sample_rate": 24000}
GET  /healthz → {"status": "ok", "merged_batches": N, "params": N,
                 "requests": N, "latency_p50_ms": x, "latency_p95_ms": x, ...}

Counterpart of the JAX package's ``cli/serve.py``. One process, one thread per
connection. Concurrent ref-free /synthesize requests are merged by a
micro-batcher: requests with the same solver parameters that arrive while
the device is busy ride one length-grouped solve (``F5TTS.synthesize_batch``).
Every row draws its noise from its own seed, so a merged request's audio
equals its solo audio: batching changes latency, never outputs. On the card
that matters more than anywhere: a solve is tens of thousands of kernel
launches sent by one host thread, and a merged solve sends the same
number for all its rows.

All state lives in a :class:`Service` that the HTTP server carries
(``server.service``); nothing is module-level, so two servers can run in one
process. Every call into the model happens under ``Service.model_lock``: the
dispatcher thread and the handler threads take turns, the kernels' launch
counters (plain ints) are only ever bumped by the lock's holder, and the
model's own methods run under ``torch.no_grad`` (which is per thread).

``--mesh DPxTP`` (one process per rank under ``torchrun``): rank 0 runs the
HTTP server and the micro-batcher; every other rank runs :func:`follow`.
Each model call on rank 0 (:class:`MeshModel`) first broadcasts a small
command to every rank — the method, the texts (from which every rank
derives the same token ids and durations), the row seeds and the solver
settings (steps, CFG, sway, ``cfg_interval``, method), and a cloned
request's reference WAV bytes — and then every rank runs the same solve on
its shard (``F5TTS.set_mesh``). A drain or shutdown broadcasts a stop
command; a 429 or a 504 broadcasts nothing, since no solve runs. Under a
mesh /synthesize_stream solves every chunk before its first piece is sent
(the ranks cannot wait on a client between solves). /healthz reports the
mesh's shape.

Not ported, because they steer XLA: ``--warmup-full`` (it compiles
executables), ``--no-scan-blocks`` and the compilation cache.
"""

from __future__ import annotations

import argparse
import base64
import hmac
import json
import logging
import os
import signal
import tempfile
import threading
import time
from collections import deque
from collections.abc import Iterator
from contextlib import contextmanager
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any

from oron_tts_tpu_torch.cli import mesh_or_exit, validate_quantize_mesh
from oron_tts_tpu_torch.data.wav import pcm16_bytes, wav_bytes, wav_stream_header

# The solve-time estimate a fresh batcher starts from, before it has timed a
# solve of its own: one merged Base-width bf16 solve of 8 rows × 832 frames (a
# full `GROUP_FRAME_BUDGET`), 32 steps, vocoder included, took 1.40 s on an
# NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, serve phase, `merged_solve`),
# rounded up. Starting high sheds a first wave of overload early; a low prior
# would admit it into certain timeouts until the estimate converges.
SOLVE_EWMA_PRIOR_S = 1.5
FAST_PROFILE_CFG_INTERVAL = (0.10, 0.70)
_logger = logging.getLogger(__name__)


class RequestTimeout(Exception):
    """Waiting for device work took longer than ``--request-timeout``."""


class Overloaded(Exception):
    """Admission control refused the request (429 + Retry-After).

    The queue's projected wait exceeds the request timeout, so the request
    is shed now instead of queuing toward a certain 504 that would still cost
    a solve. ``retry_after_s`` is the projected time for the backlog to clear.
    """

    def __init__(self, msg: str, retry_after_s: float) -> None:
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class _Request:
    __slots__ = ("text", "seed", "done", "result", "error", "abandoned", "taken")

    def __init__(self, text: str, seed: int) -> None:
        self.text = text
        self.seed = seed
        self.done = threading.Event()
        self.result = None
        self.error: Exception | None = None
        # set when the submitting handler has already answered 504: the
        # dispatcher drops such entries instead of solving for nobody
        self.abandoned = False
        # set (under the batcher's condition) when the dispatcher pops the
        # request; says who owns the `_queued` decrement when a timeout races it
        self.taken = False


def _freeze(d: dict) -> tuple:
    return tuple(sorted(d.items()))


class MicroBatcher:
    """Cross-request dynamic batching for ref-free /synthesize.

    Requests queue under their solver parameters; a dispatcher thread takes
    everything compatible that queued up while the previous solve ran and
    runs one ``synthesize_batch`` with per-request seeds. Under no load a
    request runs alone, after ``window_s`` (which lets near-simultaneous
    arrivals coalesce).
    """

    def __init__(self, service: "Service", max_batch: int = 16, window_s: float = 0.003,
                 max_queue: int = 64) -> None:
        self._service = service
        self._max_batch = max_batch
        self._window_s = window_s
        self._max_queue = max_queue
        self._cv = threading.Condition()
        self._queues: dict[tuple, list[_Request]] = {}
        # requests waiting and still owed a solve: an abandoned entry leaves
        # the count when its submit times out, a live one when it is taken
        self._queued = 0
        self._solve_ewma_s = SOLVE_EWMA_PRIOR_S
        self._solves_timed = 0
        self._closed = False
        self.merged_batches = 0  # batches that served more than one request
        self.shed_requests = 0   # admissions refused (429)
        self._thread = threading.Thread(target=self._loop, name="micro-batcher", daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop the dispatcher thread (queued requests are left to their timeouts)."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=30)

    def _solves_ahead_locked(self) -> int:
        """Batched solves needed to clear the backlog (hold ``_cv``).

        Counted per parameter key, since requests only batch with
        neighbours of the same key. Abandoned entries are left out: the
        dispatcher drops them without solving.
        """
        total = 0
        for reqs in self._queues.values():
            n = sum(1 for r in reqs if not r.abandoned)
            total += (n + self._max_batch - 1) // self._max_batch
        return total

    @property
    def solve_estimate_s(self) -> float:
        """The current estimate of one batched solve's wall time."""
        return self._solve_ewma_s

    def projected_wait_s(self) -> float:
        """Projected queue wait of a new request: solves ahead × the solve-time estimate.

        The request's own solve is left out on purpose: the request timeout
        bounds waiting, not device work, so an idle server always admits.
        """
        with self._cv:
            return self._solves_ahead_locked() * self._solve_ewma_s

    def _record_solve(self, seconds: float) -> None:
        """Fold one solve's wall time into the estimate.

        The first solve a batcher times carries one-off costs (building and
        loading the kernels, the matmul library's start-up), which would push
        the estimate up and shed traffic that later solves could serve: it
        is left out.
        """
        self._solves_timed += 1
        if self._solves_timed > 1:
            self._solve_ewma_s += 0.3 * (seconds - self._solve_ewma_s)

    def submit(self, text: str, seed: int, params: dict) -> Any:
        timeout_s = self._service.request_timeout_s
        req = _Request(text, seed)
        with self._cv:
            projected = self._solves_ahead_locked() * self._solve_ewma_s
            if self._queued >= self._max_queue or projected > timeout_s:
                self.shed_requests += 1
                raise Overloaded(
                    f"server overloaded: {self._queued} requests queued, projected wait "
                    f"{projected:.1f}s exceeds the {timeout_s:.0f}s request timeout",
                    retry_after_s=projected,
                )
            self._queues.setdefault(_freeze(params), []).append(req)
            self._queued += 1
            self._cv.notify()
        if not req.done.wait(timeout=timeout_s):
            with self._cv:
                req.abandoned = True
                if not req.taken:
                    self._queued -= 1
            raise RequestTimeout(
                f"request timed out after {timeout_s:.0f}s in the synthesis queue")
        if req.error is not None:
            raise req.error
        return req.result

    def _take_batch(self) -> tuple[tuple | None, list[_Request] | None]:
        """Pop up to ``max_batch`` live requests that share one parameter key.

        A served key is deleted and its leftovers re-inserted at the end, so
        the dict never keeps stale client-chosen parameter combinations and a
        key with a long backlog cannot starve the others. Abandoned entries
        are dropped before slicing, so they take no slot of the batch.
        """
        for key in list(self._queues):
            reqs = [r for r in self._queues[key] if not r.abandoned]
            for r in self._queues[key]:
                r.taken = r.taken or r.abandoned
            batch, rest = reqs[: self._max_batch], reqs[self._max_batch:]
            del self._queues[key]
            if rest:
                self._queues[key] = rest
            for r in batch:
                r.taken = True
            self._queued -= len(batch)
            if batch:
                return key, batch
        return None, None

    def _loop(self) -> None:
        service = self._service
        while True:
            with self._cv:
                while not self._closed and not any(self._queues.values()):
                    self._cv.wait()
                if self._closed:
                    return
            time.sleep(self._window_s)  # let near-simultaneous arrivals land
            with self._cv:
                key, batch = self._take_batch()
            # an entry may have been abandoned between the pop and here
            batch = [r for r in batch or [] if not r.abandoned]
            if not batch:
                continue
            params = dict(key)
            try:
                with service.model_lock:
                    # timed inside the lock: the estimate is of one solve, not
                    # of lock contention
                    t_solve = time.perf_counter()
                    wavs = service.model.synthesize_batch(
                        [r.text for r in batch], seeds=[r.seed for r in batch], **params)
                    self._record_solve(time.perf_counter() - t_solve)
                if len(batch) > 1:
                    self.merged_batches += 1
                for r, w in zip(batch, wavs):
                    r.result = w
            except Exception as exc:  # noqa: BLE001 - the loop must survive any request
                if len(batch) == 1:
                    batch[0].error = exc
                else:
                    # one bad request (whitespace-only text, say) must not fail
                    # its neighbours: each is retried alone
                    for r in batch:
                        try:
                            with service.model_lock:
                                r.result = service.model.synthesize(
                                    text=r.text, seed=r.seed, **params)
                        except Exception as solo_exc:  # noqa: BLE001
                            r.error = solo_exc
            for r in batch:
                r.done.set()


class Service:
    """What the handlers share: the model, its lock, the batcher, settings and statistics."""

    def __init__(self, model, batching: bool = True, max_batch: int = 16, max_queue: int = 64,
                 window_s: float = 0.003, request_timeout_s: float = 120.0,
                 auth_token: str | None = None, profile_defaults: dict | None = None,
                 meta: dict | None = None) -> None:
        self.model = model
        self.model_lock = threading.Lock()
        # ceiling on how long a request waits for device work (the batcher's
        # queue, or the model lock); a solve already running is never interrupted
        self.request_timeout_s = request_timeout_s
        self.auth_token = auth_token
        # sampler defaults applied when a request does not set the parameter
        self.profile_defaults = dict(profile_defaults or {})
        self.meta = {"params": model.num_params(), **(meta or {})}
        self.draining = False
        self._stats_lock = threading.Lock()  # guards the counter and the deque
        self._latencies_s: deque[float] = deque(maxlen=512)
        self._requests_total = 0
        self.batcher = (MicroBatcher(self, max_batch, window_s, max_queue)
                        if batching else None)

    def close(self) -> None:
        if self.batcher is not None:
            self.batcher.close()

    def record_latency(self, t0: float) -> None:
        with self._stats_lock:
            self._latencies_s.append(time.perf_counter() - t0)
            self._requests_total += 1

    def health(self) -> dict:
        with self._stats_lock:
            total = self._requests_total
            lat = sorted(self._latencies_s)
        out: dict[str, Any] = {
            "status": "draining" if self.draining else "ok",
            "merged_batches": self.batcher.merged_batches if self.batcher else 0,
            "requests": total,
        }
        if self.batcher is not None:
            out["shed_requests"] = self.batcher.shed_requests
            out["projected_wait_s"] = round(self.batcher.projected_wait_s(), 2)
        if lat:
            out["latency_p50_ms"] = round(lat[len(lat) // 2] * 1e3, 1)
            out["latency_p95_ms"] = round(lat[min(len(lat) - 1, int(len(lat) * 0.95))] * 1e3, 1)
        return {**out, **self.meta}

    @contextmanager
    def model_lock_bounded(self) -> Iterator[None]:
        """The model lock with the request's wait ceiling (504 on timeout)."""
        if not self.model_lock.acquire(timeout=self.request_timeout_s):
            raise RequestTimeout(
                f"request timed out after {self.request_timeout_s:.0f}s waiting for the device")
        try:
            yield
        finally:
            self.model_lock.release()


@contextmanager
def _ref_audio(req: dict) -> Iterator[dict]:
    """A request's voice-cloning reference, as ``synthesize`` keyword arguments.

    ``ref_audio_b64`` (base64 WAV bytes, for remote clients) is written to a
    temporary file for the length of the request; ``ref_audio_path`` names a
    file on the server. Yields ``{}`` for a ref-free request.
    """
    b64 = req.get("ref_audio_b64")
    path = req.get("ref_audio_path")
    if b64 and path:
        raise ValueError("pass ref_audio_b64 OR ref_audio_path, not both")
    if b64:
        try:
            data = base64.b64decode(b64, validate=True)
        except (ValueError, TypeError) as exc:
            raise ValueError(f"invalid ref_audio_b64: {exc}") from None
        fd, tmp = tempfile.mkstemp(suffix=".wav")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            yield {"ref_audio_path": tmp, "ref_text": req.get("ref_text")}
        finally:
            os.unlink(tmp)
    elif path:
        if not Path(path).exists():
            raise ValueError(f"ref_audio_path not found: {path}")
        yield {"ref_audio_path": path, "ref_text": req.get("ref_text")}
    else:
        yield {}


class Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # socket timeout: an idle keep-alive connection closes itself after this
    # long, so a drain's server_close() can join every handler thread
    timeout = 30
    # room for a base64 reference WAV, small enough that a hostile
    # Content-Length cannot exhaust the host's memory
    MAX_BODY_BYTES = 32 * 1024 * 1024
    MAX_BATCH_TEXTS = 256

    @property
    def service(self) -> Service:
        return self.server.service

    def _json(self, code: int, obj: dict, headers: dict | None = None) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        for name, value in (headers or {}).items():
            self.send_header(name, value)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _authorized(self) -> bool:
        """Bearer-token gate for the synthesis endpoints (open when no token is set)."""
        token = self.service.auth_token
        if token is None:
            return True
        header = self.headers.get("Authorization", "")
        supplied = header.removeprefix("Bearer ").strip()
        if header.startswith("Bearer ") and hmac.compare_digest(supplied, token):
            return True
        self._json(401, {"error": "missing or invalid bearer token"},
                   {"WWW-Authenticate": "Bearer"})
        return False

    def do_GET(self) -> None:  # noqa: N802 - http.server's name
        if self.path == "/healthz":
            health = self.service.health()
            self._json(503 if self.service.draining else 200, health)
        else:
            self._json(404, {"error": "not found"})

    def _read_request(self) -> dict | None:
        """The JSON body, or ``None`` after an error response was sent."""
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            # the body was never read: a reused connection would parse it as
            # the next request, so it closes
            self.close_connection = True
            self._json(400, {"error": "invalid Content-Length header"})
            return None
        if length < 0 or length > self.MAX_BODY_BYTES:
            self.close_connection = True  # as above; rfile.read(-1) would also block
            self._json(413, {"error": f"body size {length} out of range "
                                      f"(max {self.MAX_BODY_BYTES} bytes)"})
            return None
        try:
            req = json.loads(self.rfile.read(length) or b"{}")
        except ValueError:
            self._json(400, {"error": "invalid JSON body"})
            return None
        if not isinstance(req, dict):
            self._json(400, {"error": "the JSON body must be an object"})
            return None
        return req

    def _sampler_params(self, req: dict) -> tuple[dict, int | None]:
        """Solver settings and seed of a request; ``ValueError``/``TypeError`` on garbage."""
        defaults = self.service.profile_defaults
        sway = req.get("sway_sampling_coef", -1.0)
        ci = req.get("cfg_interval", defaults.get("cfg_interval"))
        if ci is not None:
            if not isinstance(ci, (list, tuple)) or len(ci) != 2:
                raise ValueError("cfg_interval must be [lo, hi]")
            ci = (float(ci[0]), float(ci[1]))  # a tuple: part of the batcher's key
            if not 0.0 <= ci[0] <= ci[1]:
                raise ValueError("cfg_interval needs 0 <= lo <= hi")
        method = str(req.get("method", defaults.get("method", "euler")))
        if method not in ("euler", "midpoint"):
            raise ValueError("method must be 'euler' or 'midpoint'")
        common = dict(
            lang=req.get("lang", "mn"),
            n_steps=int(req.get("steps", 32)),
            cfg_strength=float(req.get("cfg_strength", 2.0)),
            sway_sampling_coef=None if sway is None else float(sway),
            speed=float(req.get("speed", 1.0)),
            cfg_interval=ci,
            method=method,
        )
        seed = req.get("seed")
        return common, None if seed is None else int(seed)

    def do_POST(self) -> None:  # noqa: N802 - http.server's name
        if not self._authorized():
            self.close_connection = True  # the body was not read
            return
        req = self._read_request()
        if req is None:
            return
        try:
            common, seed = self._sampler_params(req)
        except (TypeError, ValueError) as exc:
            self._json(400, {"error": f"invalid parameter: {exc}"})
            return
        service = self.service
        t0 = time.perf_counter()
        try:
            with _ref_audio(req) as ref:
                common.update(ref)
                if self.path in ("/synthesize", "/synthesize_stream"):
                    text = req.get("text")
                    if not isinstance(text, str) or not text.strip():
                        self._json(400, {"error": "missing 'text' string"})
                        return
                    if self.path == "/synthesize_stream":
                        self._stream(text, seed, common)
                        service.record_latency(t0)
                        return
                    wav = self._synthesize_one(text, seed, common, cloned=bool(ref))
                    body = wav_bytes(wav, service.model.sample_rate)
                    self.send_response(200)
                    self.send_header("Content-Type", "audio/wav")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/synthesize_batch":
                    texts = req.get("texts")
                    if (not texts or not isinstance(texts, list)
                            or not all(isinstance(t, str) for t in texts)):
                        self._json(400, {"error": "missing 'texts' list of strings"})
                        return
                    if len(texts) > self.MAX_BATCH_TEXTS:
                        self._json(413, {"error": f"too many texts ({len(texts)}; max "
                                                  f"{self.MAX_BATCH_TEXTS} per request)"})
                        return
                    with service.model_lock_bounded():
                        wavs = service.model.synthesize_batch(texts, seed=seed, **common)
                    rate = service.model.sample_rate
                    self._json(200, {
                        "sample_rate": rate,
                        "wavs_base64": [base64.b64encode(wav_bytes(w, rate)).decode()
                                        for w in wavs],
                    })
                    service.record_latency(t0)
                else:
                    self._json(404, {"error": "not found"})
        except Overloaded as exc:
            self._json(429, {"error": str(exc)},
                       {"Retry-After": str(max(1, int(exc.retry_after_s + 0.5)))})
        except RequestTimeout as exc:
            self._json(504, {"error": str(exc)})
        except ValueError as exc:
            self._json(400, {"error": str(exc)})
        except Exception as exc:  # noqa: BLE001 - the server must stay up
            self._json(500, {"error": f"{type(exc).__name__}: {exc}"})

    def _synthesize_one(self, text: str, seed: int | None, common: dict, cloned: bool):
        """One /synthesize request: through the batcher unless it clones a voice.

        ``synthesize_batch`` chunks long texts itself, so a paragraph's chunk
        rows merge with other requests' rows. An unseeded request is pinned to
        seed 0, the rule ``synthesize`` itself uses. A cloned request skips the
        batcher: the reference mel is part of the solve, so merging would
        need identical references within a group.
        """
        service = self.service
        t0 = time.perf_counter()
        try:
            if service.batcher is not None and not cloned:
                return service.batcher.submit(text, 0 if seed is None else seed, common)
            with service.model_lock_bounded():
                return service.model.synthesize(text=text, seed=seed, **common)
        finally:
            service.record_latency(t0)

    def _stream(self, text: str, seed: int | None, common: dict) -> None:
        service = self.service
        # a generator validates at its first next(): pull the first piece
        # before any header goes out, so that a bad request is still a clean 400
        gen = service.model.synthesize_stream(text=text, seed=seed, **common)
        with service.model_lock_bounded():
            first = next(gen)

        self.send_response(200)
        self.send_header("Content-Type", "audio/wav")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def write_chunk(payload: bytes) -> None:
            self.wfile.write(f"{len(payload):X}\r\n".encode() + payload + b"\r\n")

        # The lock guards the next() calls (device work) only; socket writes
        # happen outside it, so a slow reader cannot hold up other requests.
        # Once the headers are out, a failure can only cut the stream short.
        try:
            write_chunk(wav_stream_header(service.model.sample_rate))
            write_chunk(pcm16_bytes(first))
            while True:
                with service.model_lock:
                    try:
                        piece = next(gen)
                    except StopIteration:
                        break
                write_chunk(pcm16_bytes(piece))
            self.wfile.write(b"0\r\n\r\n")
        except Exception as exc:  # noqa: BLE001 - the response has already begun
            self.log_message("stream aborted: %s: %s", type(exc).__name__, exc)
            self.close_connection = True

    def log_message(self, fmt: str, *fmt_args: Any) -> None:
        # the access log goes through logging (main() shows it), so a process
        # that embeds the server decides itself what reaches its output
        _logger.info("%s %s", self.address_string(), fmt % fmt_args)


def run_command(model, cmd: dict) -> Any:
    """Run one broadcast command on this rank's model (a cloned request's
    reference WAV is written to a temporary file for the call)."""
    kwargs = dict(cmd["kwargs"])
    ref = kwargs.pop("ref_audio_bytes", None)
    tmp = None
    try:
        if ref is not None:
            fd, tmp = tempfile.mkstemp(suffix=".wav")
            with os.fdopen(fd, "wb") as f:
                f.write(ref)
            kwargs["ref_audio_path"] = tmp
        if cmd["method"] == "synthesize_stream":
            return list(model.synthesize_stream(**kwargs))
        return getattr(model, cmd["method"])(**kwargs)
    finally:
        if tmp is not None:
            os.unlink(tmp)


class MeshModel:
    """Rank 0's handle on a model sharded over a mesh.

    Every synthesis call broadcasts its command to the followers first, then
    runs it here; callers hold ``Service.model_lock``, so commands go out in
    the order the solves run. Everything else is the model's.
    """

    def __init__(self, model, mesh) -> None:
        self.model, self.mesh = model, mesh

    def __getattr__(self, name: str) -> Any:
        return getattr(self.model, name)

    def _call(self, entry: str, /, **kwargs: Any) -> Any:
        from oron_tts_tpu_torch.parallel.mesh import broadcast_tree

        path = kwargs.get("ref_audio_path")
        if path is not None:
            kwargs = dict(kwargs, ref_audio_bytes=Path(path).read_bytes())
            del kwargs["ref_audio_path"]
        cmd = {"method": entry, "kwargs": kwargs}
        broadcast_tree(cmd, device=self.mesh.device)
        return run_command(self.model, cmd)

    def synthesize(self, **kwargs: Any):
        return self._call("synthesize", **kwargs)

    def synthesize_batch(self, texts: list[str], **kwargs: Any):
        return self._call("synthesize_batch", texts=list(texts), **kwargs)

    def synthesize_stream(self, **kwargs: Any) -> Iterator:
        yield from self._call("synthesize_stream", **kwargs)

    def stop(self) -> None:
        from oron_tts_tpu_torch.parallel.mesh import broadcast_tree

        broadcast_tree({"method": "stop"}, device=self.mesh.device)


def follow(model, mesh) -> int:
    """A follower rank's loop: run every broadcast command until a stop; returns the count.

    A command that fails here failed on rank 0 too (the same validation
    runs everywhere before any collective), which answers the client.
    """
    from oron_tts_tpu_torch.parallel.mesh import broadcast_tree

    done = 0
    while True:
        cmd = broadcast_tree(None, device=mesh.device)
        if cmd["method"] == "stop":
            return done
        try:
            run_command(model, cmd)
        except Exception as exc:  # noqa: BLE001 - rank 0 reports it
            _logger.info("follower: %s: %s", type(exc).__name__, exc)
        done += 1


class DrainingHTTPServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` that finishes accepted requests when it closes.

    ``server_close()`` joins the handler threads in flight; with
    :func:`begin_drain`, a terminating deployment answers every accepted
    request (a queued submit is a synchronous wait inside its handler
    thread, so the batcher drains with them).
    """

    daemon_threads = False
    block_on_close = True
    # socketserver's default backlog of 5 resets a burst of concurrent
    # connects; solves queue for seconds, so deep connection queues are normal
    request_queue_size = 128

    def __init__(self, address: tuple[str, int], service: Service) -> None:
        super().__init__(address, Handler)
        self.service = service


def begin_drain(server: DrainingHTTPServer) -> None:
    """Flip /healthz to 503 "draining" and stop accepting; returns at once.

    ``shutdown()`` blocks until ``serve_forever`` has returned, so it runs on
    a thread of its own; the caller then joins the handlers with
    ``server_close()``.
    """
    server.service.draining = True
    threading.Thread(target=server.shutdown, daemon=True).start()


def install_drain_handlers(server: DrainingHTTPServer) -> None:
    """SIGTERM/SIGINT → :func:`begin_drain`; a second signal exits at once.

    Call from the main thread only (the signal module requires it).
    """
    def on_term(signum, frame) -> None:  # noqa: ARG001 - the signal signature
        if server.service.draining:
            print("[serve] second signal: force exit")
            os._exit(1)
        print("[serve] draining in-flight requests...")
        begin_drain(server)

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="OronTTS HTTP server (PyTorch)")
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--vocoder", type=str, default=None)
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--no-ema", action="store_true")
    parser.add_argument("--warmup", action="store_true",
                        help="Run one default-shaped synthesis at start-up (builds the "
                             "kernels, starts the matmul library)")
    parser.add_argument("--no-batching", action="store_true",
                        help="Disable the cross-request micro-batcher")
    parser.add_argument("--max-batch", type=int, default=16,
                        help="Micro-batcher cap on merged requests per solve")
    parser.add_argument("--max-queue", type=int, default=64,
                        help="Cap on queued /synthesize requests; beyond it (or when the "
                             "projected wait exceeds --request-timeout) new requests get "
                             "429 + Retry-After")
    parser.add_argument("--profile", type=str, default=None, choices=["fast"],
                        help="'fast' makes int8_dynamic (w8a8) weights and the guidance "
                             "interval [0.10, 0.70] the server's defaults; a request's own "
                             "parameters still win")
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    parser.add_argument("--quantize", type=str, default=None, choices=["int8", "int8_dynamic"],
                        help="Serve the DiT projections in int8: 'int8' = w8a16 through the "
                             "hand-written kernel, 'int8_dynamic' = w8a8")
    parser.add_argument("--fp32", action="store_true",
                        help="Force float32 compute and parameters (default: bf16 on the card)")
    parser.add_argument("--mesh", type=str, default=None,
                        help="Multi-GPU mesh as DPxTP (e.g. 2x2), one process per rank under "
                             "torchrun; rank 0 serves HTTP, the others follow")
    parser.add_argument("--auth-token", type=str, default=None,
                        help="Require 'Authorization: Bearer <token>' on the synthesis "
                             "endpoints (/healthz stays open); also ORON_SERVE_TOKEN")
    parser.add_argument("--request-timeout", type=float, default=120.0,
                        help="Most seconds a request waits for device work before 504; a "
                             "solve already running is never interrupted")
    return parser


def create_server(argv: list[str] | None = None) -> DrainingHTTPServer:
    """Parse the flags, load the model and bind the socket; the caller serves.

    Under ``--mesh`` a follower rank (not rank 0) gets no server: it runs
    :func:`follow` here and returns None once rank 0 has stopped.
    """
    from oron_tts_tpu_torch.cli.infer import load_model

    parser = build_parser()
    args = parser.parse_args(argv)
    meta: dict[str, Any] = {}
    profile_defaults: dict[str, Any] = {}
    if args.profile == "fast":
        # an explicit --quantize wins over the profile's int8_dynamic
        args.quantize = args.quantize or "int8_dynamic"
        profile_defaults["cfg_interval"] = FAST_PROFILE_CFG_INTERVAL
        meta["profile"] = "fast"
        print(f"[serve] profile=fast: {args.quantize} + cfg_interval"
              f"{FAST_PROFILE_CFG_INTERVAL} defaults")
    validate_quantize_mesh(parser, args.quantize, args.mesh)
    mesh = mesh_or_exit(parser, args.mesh, args.device) if args.mesh else None
    model = load_model(args.checkpoint, use_ema=not args.no_ema,
                       precision="float32" if args.fp32 else None, quantize=args.quantize,
                       device=args.device if mesh is None else mesh.device)
    if args.quantize:
        meta["quantize"] = args.quantize
    meta["device"] = str(model.device)
    model.load_vocoder(args.vocoder)
    if mesh is not None:
        model.set_mesh(mesh)
        meta["mesh"] = dict(mesh.shape)
        print(f"[serve] mesh: {mesh.shape} (rank {mesh.rank} of {mesh.world})")
        if not mesh.is_main:
            n = follow(model, mesh)
            print(f"[serve] follower rank {mesh.rank}: {n} commands, stopped")
            return None
        model = MeshModel(model, mesh)
    if args.warmup:
        print("[serve] warmup synthesis...")
        if args.no_batching:
            model.synthesize("а" * 120, n_steps=32, **profile_defaults)
        else:  # the path a /synthesize request takes
            model.synthesize_batch(["а" * 120], n_steps=32, seed=0, **profile_defaults)
        print("[serve] warmup done")
    auth_token = args.auth_token or os.environ.get("ORON_SERVE_TOKEN")
    if auth_token:
        print("[serve] bearer-token auth enabled")
    service = Service(
        model, batching=not args.no_batching, max_batch=args.max_batch,
        max_queue=args.max_queue, request_timeout_s=args.request_timeout,
        auth_token=auth_token, profile_defaults=profile_defaults, meta=meta)
    return DrainingHTTPServer((args.host, args.port), service)


def close_server(server: DrainingHTTPServer) -> None:
    """Join the handlers, stop the batcher and, under a mesh, the followers."""
    server.server_close()
    server.service.close()
    if isinstance(server.service.model, MeshModel):
        server.service.model.stop()


def main(argv: list[str] | None = None) -> None:
    logging.basicConfig(level=logging.INFO, format="[serve] %(message)s")
    server = create_server(argv)
    if server is None:  # a mesh follower, stopped by rank 0
        return
    install_drain_handlers(server)
    host, port = server.server_address[:2]
    print(f"[serve] listening on http://{host}:{port}")
    try:
        server.serve_forever()
    finally:
        # after a drain, serve_forever has returned; server_close joins the
        # handler threads, so every accepted request is answered first
        close_server(server)
    print("[serve] drained, exiting")


if __name__ == "__main__":
    main()
