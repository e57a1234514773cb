"""Serving cells: the port's HTTP server in this process, driven by open or closed loops.

The server is the program's own (``cli/serve.py``: ``Service`` behind a
``DrainingHTTPServer`` on 127.0.0.1, port 0), over a model with seeded
weights made on the device. Clients speak HTTP to it from threads of this
process. An open loop sends each request when it falls due, whatever is in
flight, and times it from when it was due; a closed loop's clients each send
their next request when the last one answered, and time from the send.

Wrappers on the model object record what the correctness check needs (the
mel each checked row was solved to, and the length it was padded to), and,
in a traced run, spans and call shapes for the per-layer metrics.
"""

from __future__ import annotations

import base64
import gc
import http.client
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from portbench import audio, flops, record
from portbench.reference import architecture
from portbench.traffic import Traffic, check_set

DRAIN_S = 60.0  # how long answers due in the window are waited for once it closes
HTTP_TIMEOUT_S = 180.0  # past the server's own 120 s wait ceiling and a solve


def port_config(cfg: dict) -> dict:
    """The configuration file's keys that the program reads."""
    return {k: v for k, v in cfg.items() if k not in ("source", "assumed", "note")}


def build_model(cfg: dict, seed: int, device: str):
    """The served model: the configuration at its width, weights from ``seed``."""
    import torch

    from oron_tts_tpu_torch.config import F5Config
    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from portbench.weights import dit_state

    dtype = getattr(torch, cfg["dit_dtype"]) if device != "cpu" else torch.float32
    model = F5TTS.from_config(F5Config.from_dict(port_config(cfg)), device=device, dtype=dtype)
    shapes = {k: tuple(v.shape) for k, v in model.backbone.state_dict().items()}
    model.backbone.load_state_dict(dit_state(shapes, seed, model.device, dtype,
                                             architecture(cfg)), strict=True)
    model.params_loaded = True
    model.load_vocoder()
    return model, shapes


def _body(traffic: Traffic, i: int) -> bytes:
    r = traffic.requests[i]
    body = {"text": r.text, "lang": r.lang, "seed": r.seed, **traffic.mix["request"]}
    if r.voice is not None:
        v = traffic.voices[r.voice]
        body["ref_audio_b64"] = base64.b64encode(v.wav).decode()
        body["ref_text"] = v.text
    return json.dumps(body).encode()


def _post(port: int, body: bytes) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=HTTP_TIMEOUT_S)
    try:
        conn.request("POST", "/synthesize", body, {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


class Served:
    """Per request: when it was due or sent, when it answered, and what."""

    def __init__(self, n: int) -> None:
        self.t_due = [None] * n
        self.t_sent = [None] * n
        self.t_done = [None] * n
        self.status = [None] * n
        self.samples = [0] * n
        self.wav: dict[int, bytes] = {}

    def send(self, port: int, traffic: Traffic, i: int, keep: set[int], probe=None) -> None:
        self.t_sent[i] = time.perf_counter()
        t0 = record.now_ns()
        try:
            status, data = _post(port, _body(traffic, i))
        except OSError:
            status, data = -1, b""
        self.t_done[i] = time.perf_counter()
        if probe is not None:
            probe.span("request", t0, record.now_ns(), index=i)
        self.status[i] = status
        if status == 200:
            try:
                self.samples[i] = len(audio.wav_pcm16(data)[0])
            except ValueError:
                self.status[i] = -2
            if i in keep:
                self.wav[i] = data


def install_probes(model, service, probe: record.Probe | None, capture: dict,
                   watch_seeds: set[int], device) -> None:
    """Wrap the program's layer entries on this model (and its kernels' wrappers).

    Always: ``CFM.sample`` keeps the mel of every row whose seed is watched, and
    the length the row was padded to. Traced: spans of batches, solves, lock waits
    and vocoder calls, and the shapes of each attention-forward and log-mel call.
    """
    import torch

    cfm = model.cfm
    sample = cfm.sample  # an instance attribute set here shadows the class's method

    def sample_probe(cond, text_ids, duration, lens, *args, seed=None, **kw):
        t0 = record.now_ns()
        out = sample(cond, text_ids, duration, lens, *args, seed=seed, **kw)
        seeds = list(seed) if isinstance(seed, (list, tuple)) else []
        for row, s in enumerate(seeds):
            if s in watch_seeds:
                capture[s] = {"mel": out[0][row].detach().clone(), "bucket": cond.shape[1],
                              "rows": cond.shape[0]}
        if probe is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            d = [int(x) for x in torch.as_tensor(duration).tolist()]
            probe.span("solve", t0, record.now_ns(), steps=kw.get("steps", 32),
                       frames=d, bucket=int(cond.shape[1]),
                       guided=kw.get("cfg_strength", 1.0) >= 1e-5)
        return out

    cfm.sample = sample_probe
    if probe is None:
        return

    synth_batch = model.synthesize_batch

    def batch_probe(texts, *a, seeds=None, **kw):
        t0 = record.now_ns()
        probe.call("batch", rows=len(texts), seeds=list(seeds or []), t0=t0)
        try:
            return synth_batch(texts, *a, seeds=seeds, **kw)
        finally:
            probe.span("batch", t0, record.now_ns(), rows=len(texts))

    model.synthesize_batch = batch_probe

    submit = service.batcher.submit

    def submit_probe(text, seed, params):
        probe.call("submit", seed=seed, t0=record.now_ns())
        return submit(text, seed, params)

    service.batcher.submit = submit_probe

    bounded = service.model_lock_bounded

    class _LockProbe:
        def __enter__(self):
            self.t0 = record.now_ns()
            self.cm = bounded()
            self.cm.__enter__()
            probe.span("model lock wait", self.t0, record.now_ns())
            return self

        def __exit__(self, *exc):
            return self.cm.__exit__(*exc)

    service.model_lock_bounded = _LockProbe

    decode = model._decode_mel_group

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def decode_probe(mel, lens):
        sync()
        t0 = record.now_ns()
        out = decode(mel, lens)
        sync()
        probe.span("vocoder", t0, record.now_ns())
        return out

    model._decode_mel_group = decode_probe
    _wrap_kernels(probe)


def remove_probes(model, service) -> None:
    """Undo :func:`install_probes` (the instance attributes and the module globals)."""
    from oron_tts_tpu_torch.ops import audio as ops_audio
    from oron_tts_tpu_torch.ops import flash_attention as fa

    for obj, names in ((model.cfm, ("sample",)),
                       (model, ("synthesize_batch", "_decode_mel_group")),
                       (service, ("model_lock_bounded",)), (service.batcher, ("submit",))):
        for name in names:
            obj.__dict__.pop(name, None)
    for mod, name in ((fa, "flash_lanes_fwd"), (ops_audio, "log_mel_fused")):
        orig = getattr(getattr(mod, name), "__wrapped__", None)
        if orig is not None:
            setattr(mod, name, orig)


def _wrap_kernels(probe: record.Probe) -> None:
    """Record each attention-forward and log-mel call's shape (module globals)."""
    from oron_tts_tpu_torch.ops import audio as ops_audio
    from oron_tts_tpu_torch.ops import flash_attention as fa

    fwd = fa.flash_lanes_fwd

    def fwd_probe(q, k, v, kv_lens, heads):
        if probe.tracing:  # the key lengths stay on the device until the window closes
            B, T, HD = q.shape
            probe.call("attn_fwd", B=B, T=T, H=heads, D=HD // heads, kv=kv_lens)
        return fwd(q, k, v, kv_lens, heads)

    fwd_probe.__wrapped__ = fwd
    fwd_probe.launches = fwd.launches  # the program's wrapper counts its launches on itself
    fa.flash_lanes_fwd = fwd_probe
    mel = ops_audio.log_mel_fused

    def mel_probe(x, cfg=None):
        probe.call("log_mel", waves=int(np.prod(x.shape[:-1])) if x.ndim > 1 else 1,
                   samples=int(x.shape[-1]))
        return mel(x, cfg) if cfg is not None else mel(x)

    mel_probe.__wrapped__ = mel
    ops_audio.log_mel_fused = mel_probe


def run_window(port: int, traffic: Traffic, seconds: float, served: Served, keep: set[int],
               probe, on_open) -> dict:
    """Drive the load; returns the window's bounds and what the generator saw."""
    mix = traffic.mix
    n = len(traffic.requests)
    if mix["driver"] == "open_loop":
        pool = ThreadPoolExecutor(max_workers=int(mix.get("max_in_flight", 128)))
        late = []
        t_open = time.perf_counter() + float(mix.get("lead_in_s", 0.0))
        opened = False
        futures = []
        for r in traffic.requests:
            due = t_open + r.due_s
            if r.due_s >= 0 and not opened:
                if time.perf_counter() < t_open:
                    time.sleep(t_open - time.perf_counter())
                on_open(t_open)
                opened = True
            served.t_due[r.index] = due
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late.append(time.perf_counter() - due)
            futures.append(pool.submit(served.send, port, traffic, r.index, keep, probe))
        if not opened:
            on_open(t_open)
        t_close = t_open + seconds
        if time.perf_counter() < t_close:
            time.sleep(t_close - time.perf_counter())
        pool.shutdown(wait=False)
        deadline = t_close + DRAIN_S
        for f in futures:
            left = deadline - time.perf_counter()
            if left > 0:
                try:
                    f.result(timeout=left)
                except TimeoutError:
                    pass
        pool.shutdown(wait=True, cancel_futures=True)
        return {"t_open": t_open, "t_close": t_close, "late_p90_s": record.pct(late, 0.9),
                "late_max_s": max(late)}

    clients = int(mix["clients"])
    nxt = [0]
    lock = threading.Lock()
    state = {"open": None, "close": None}
    first_done = threading.Barrier(clients + 1)

    def client(c: int) -> None:
        first = True
        while True:
            with lock:
                if state["close"] is not None and time.perf_counter() >= state["close"]:
                    return
                i = nxt[0] % n
                nxt[0] += 1
            if served.t_sent[i] is not None:  # the pool came round again: keep the first
                return
            served.send(port, traffic, i, keep, probe)
            if first:
                first = False
                first_done.wait()

    threads = [threading.Thread(target=client, args=(c,), name=f"client-{c}")
               for c in range(clients)]
    for th in threads:
        th.start()
    first_done.wait()  # every client is running and has had an answer
    t_open = time.perf_counter()
    on_open(t_open)
    with lock:
        state["close"] = t_open + seconds
    for th in threads:
        th.join(timeout=seconds + DRAIN_S + 600)
    return {"t_open": t_open, "t_close": t_open + seconds}


def warm_up(model, traffic: Traffic) -> None:
    """The cell's shapes, once, outside the window: every length class of the mix
    through ``synthesize_batch`` (as the batcher merges them) and through
    ``synthesize`` (as a solo or cloned request runs), at two steps."""
    import tempfile

    req = dict(traffic.mix["request"])
    kw = dict(cfg_strength=req.get("cfg_strength", 2.0),
              sway_sampling_coef=req.get("sway_sampling_coef", -1.0), n_steps=2)
    by_len = sorted(traffic.requests, key=lambda r: len(r.text))
    picks = [by_len[int(q * (len(by_len) - 1))] for q in np.linspace(0, 1, 8)]
    if traffic.voices:
        for v in traffic.voices:
            with tempfile.NamedTemporaryFile(suffix=".wav") as f:
                f.write(v.wav)
                f.flush()
                for r in (picks[0], picks[-1]):
                    model.synthesize(r.text, lang=r.lang, seed=0, ref_audio_path=f.name,
                                     ref_text=v.text, **kw)
        return
    for lang in sorted({r.lang for r in traffic.requests}):
        texts = [r.text for r in by_len if r.lang == lang]
        texts = [texts[int(q * (len(texts) - 1))] for q in np.linspace(0, 1, 8)] * 2
        model.synthesize_batch(texts, lang=lang, seeds=list(range(len(texts))), **kw)
    for r in (picks[0], picks[-1]):
        model.synthesize(r.text, lang=r.lang, seed=0, **kw)


class Stack:
    """The program under test: the model, its ``Service`` and the HTTP server."""

    def __init__(self, cfg: dict, seed: int, device: str, server: dict) -> None:
        from oron_tts_tpu_torch.cli import serve

        self.arch = architecture(cfg)
        self.model, self.shapes = build_model(cfg, seed, device)
        self.service = serve.Service(self.model, max_batch=int(server.get("max_batch", 16)),
                                     max_queue=int(server.get("max_queue", 64)))
        self.httpd = serve.DrainingHTTPServer(("127.0.0.1", 0), self.service)
        self.thread = threading.Thread(target=self.httpd.serve_forever, name="http", daemon=True)
        self.thread.start()
        self.port = self.httpd.server_address[1]

    def load_weights(self, seed: int) -> None:
        """New weights from ``seed`` into the same model (a calibration's next seed)."""
        from portbench.weights import dit_state

        m = self.model
        m.backbone.load_state_dict(dit_state(self.shapes, seed, m.device, m.dtype, self.arch),
                                   strict=True)

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.service.close()
        self.thread.join(timeout=30)


def checked_requests(traffic: Traffic, seed: int) -> list[int]:
    """The requests the correctness check reads, all of them due or sent inside the
    window: an open loop's lead-in and a closed loop's first request a client (its
    ramp) come before it."""
    mix = traffic.mix
    if mix["driver"] == "closed_loop":
        lo = int(mix.get("clients", 1))
    else:
        lo = next(r.index for r in traffic.requests if r.due_s >= 0)
    hi = len(traffic.requests) if mix["driver"] == "open_loop" else lo + int(
        mix.get("check", {}).get("candidates", 24))
    return check_set(traffic, seed, lo, hi)


def measure(stack: Stack, cfg: dict, traffic: Traffic, seed: int, seconds: float, trace: bool,
            setup_t0: float) -> dict:
    """Warm the cell's shapes, drive one window, and keep what the check reads."""
    import torch

    model, service = stack.model, stack.service
    checked = checked_requests(traffic, seed)
    keep = set(checked)
    watch = {traffic.requests[i].seed + c for i in keep for c in range(8)}
    capture: dict[int, dict] = {}
    probe = record.Probe() if trace else None
    served = Served(len(traffic.requests))
    out: dict = {"checked": checked}
    install_probes(model, service, probe, capture, watch, model.device)
    try:
        warm_up(model, traffic)
        cuda = model.device.type == "cuda"
        if trace and cuda:
            record.profiler_warm_up()
        if cuda:
            torch.cuda.synchronize()
        opened = threading.Event()

        def on_open(t_open: float) -> None:
            out["setup_s"] = time.perf_counter() - setup_t0
            opened.set()

        result: dict = {}

        def drive() -> None:
            try:
                result["window"] = run_window(stack.port, traffic, seconds, served, keep, probe,
                                              on_open)
            except BaseException as exc:  # noqa: BLE001 - re-raised on the main thread
                result["error"] = exc
                opened.set()

        driver = threading.Thread(target=drive, name="load")
        driver.start()
        opened.wait()
        box: dict = {}
        if trace and "error" not in result:  # the profiler starts and stops on this thread
            length = min(TRACE_S, seconds)
            time.sleep((seconds - length) / 2)
            trace_on(box, probe, length)
        driver.join()
        if "error" in result:
            raise result["error"]
        window = result["window"]
        if cuda:
            torch.cuda.synchronize()
            out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
        out["health"] = service.health()
    finally:
        remove_probes(model, service)
    out.update(_end_to_end(traffic, served, window, seconds))
    if trace:
        out["trace"] = _trace_record(box["prof"], box, probe, window, cfg, seconds)
    out["served"] = served
    out["mels"] = {s: {"mel": c["mel"].float().cpu(), "bucket": c["bucket"], "rows": c["rows"]}
                   for s, c in capture.items()}
    return out


def run(cell: dict, cfg: dict, traffic: Traffic, seed: int, seconds: float, trace: bool,
        device: str, setup_t0: float, root) -> dict:
    """One serving run; returns the harness's record (metrics, checks, trace)."""
    import torch

    from portbench import check

    stack = Stack(cfg, seed, device, traffic.mix.get("server", {}))
    try:
        out = measure(stack, cfg, traffic, seed, seconds, trace, setup_t0)
    finally:
        stack.close()
    shapes = stack.shapes
    # the program's state goes before the reference runs, so that the peak stays its own
    del stack
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    out["checks"] = check.serving(cfg, traffic, out["served"], out["checked"], out["mels"],
                                  seed, shapes, device, root=root)
    return out


TRACE_S = 10.0  # the device trace's stretch, in the middle of the window


def trace_on(box: dict, probe: record.Probe, length: float) -> None:
    """Record the device for ``length`` seconds (CUDA activity only), from this thread."""
    prof = record.trace_start(box, probe)
    time.sleep(length)
    record.trace_stop(box, probe, prof)


def _end_to_end(traffic: Traffic, served: Served, window: dict, seconds: float) -> dict:
    mix = traffic.mix
    t_open, t_close = window["t_open"], window["t_close"]
    lat, attempted, failed, audio_s, bad = [], 0, 0, 0.0, 0
    for i in range(len(traffic.requests)):
        t0 = served.t_due[i] if mix["driver"] == "open_loop" else served.t_sent[i]
        if t0 is None or not (t_open <= t0 < t_close):
            if (served.t_done[i] is not None and served.status[i] == 200
                    and t_open <= served.t_done[i] < t_close):
                audio_s += served.samples[i] / audio.SR
            continue
        attempted += 1
        ok = served.status[i] == 200
        if not ok:
            failed += 1
            bad += served.status[i] not in (429, 503, 504)
        lat.append(served.t_done[i] - t0 if ok else float("inf"))
        if ok and served.t_done[i] < t_close:
            audio_s += served.samples[i] / audio.SR
    out = {"attempted": attempted, "failed": failed, "errors": bad,
           "latency_p90_s": record.pct(lat, 0.9) if lat else float("inf"),
           "latency_p50_s": record.pct(lat, 0.5) if lat else float("inf"),
           "audio_s_per_s": audio_s / seconds, "window": window}
    return out


def _trace_record(prof, box: dict, probe: record.Probe, window: dict, cfg: dict,
                  seconds: float) -> dict:
    """The traced run's reductions that the per-layer readers take."""
    events = record.aligned(record.read_profiler(prof), box)
    t0, t1 = box["t0"], box["t1"]
    dev = record.device_summary(events, t0, t1)
    spans = probe.spans
    gaps = record.idle_gaps(dev["busy"], t0, t1, spans)
    # the window in the spans' clock: its open and close, from perf_counter to time_ns
    shift = time.time_ns() - int(time.perf_counter() * 1e9)
    w0, w1 = int(window["t_open"] * 1e9) + shift, int(window["t_close"] * 1e9) + shift
    in_window = [sp for sp in spans if w0 <= sp["t0"] < w1]
    submits = {c["seed"]: c["t0"] for c in probe.calls["submit"]}
    waits = [c["t0"] - submits[s] for c in probe.calls["batch"] if w0 <= c["t0"] < w1
             for s in c["seeds"] if s in submits]
    waits += [sp["t1"] - sp["t0"] for sp in in_window if sp["name"] == "model lock wait"]
    arch = architecture(cfg)
    solves = [sp for sp in in_window if sp["name"] == "solve"]
    return {
        "busy_s": dev["busy_s"], "window_s": (t1 - t0) / 1e9, "seconds": seconds,
        "kernels": dev["by_name"], "idle_gaps": gaps,
        "queue_waits_s": [w / 1e9 for w in waits],
        "batch_rows": [c["rows"] for c in probe.calls["batch"] if w0 <= c["t0"] < w1],
        "solves": [{"s": (sp["t1"] - sp["t0"]) / 1e9, "steps": sp["steps"], "frames": sp["frames"],
                    "bucket": sp["bucket"], "guided": sp["guided"]} for sp in solves],
        "solve_flops": sum(arch.solve_flops(cfg, sp["frames"], sp["steps"], sp["guided"])
                           for sp in solves),
        "vocoder_s": sum((sp["t1"] - sp["t0"]) / 1e9 for sp in in_window
                         if sp["name"] == "vocoder"),
        "attn_fwd_bound_s": sum(
            flops.attn_fwd_bound_s(c["B"], c["T"], c["H"], c["D"],
                                   int(c["kv"].clamp(max=c["T"]).sum()))
            for c in probe.calls["attn_fwd"] if c["traced"]),
        "mel_bound_s": sum(flops.mel_bound_s(c["waves"], c["samples"])
                           for c in probe.calls["log_mel"] if c["traced"]),
    }
