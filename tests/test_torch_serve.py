"""PyTorch port, the HTTP server: real requests against a server in this process.

After ``tests/test_serve.py``, on a tiny CPU model (the perturbed DiT of
``test_torch_models`` with the text blocks' GRN ``gamma`` at zero, so that a
row is free of its bucket: ``test_torch_batch.pad_silent_params``). The
server's state is a ``Service`` on the HTTP server, so each test that needs
other settings changes that object and restores it.
"""

import base64
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from oron_tts_tpu_torch.cli import serve
from oron_tts_tpu_torch.cli.infer import load_model
from oron_tts_tpu_torch.cli.infer import main as infer_main
from oron_tts_tpu_torch.data.wav import read_wav, read_wav_bytes, wav_bytes, write_wav
from oron_tts_tpu_torch.train.checkpoint import flatten_tree, write_npz

from test_torch_batch import PARAGRAPH, pad_silent_model, pad_silent_params
from test_torch_models import DEPTH, DIM, HEADS, TEXT_DIM

PCM_ATOL = 2.5 / 32767  # a couple of PCM16 steps: float sums in another order
PARAMS = dict(lang="mn", n_steps=1, cfg_strength=2.0, sway_sampling_coef=-1.0, speed=1.0,
              cfg_interval=None, method="euler")


@pytest.fixture(scope="module")
def httpd():
    service = serve.Service(pad_silent_model())
    server = serve.DrainingHTTPServer(("127.0.0.1", 0), service)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server
    server.shutdown()
    server.server_close()
    service.close()
    thread.join(timeout=30)
    assert not thread.is_alive()


@pytest.fixture
def service(httpd):
    return httpd.service


@pytest.fixture
def port(httpd):
    return httpd.server_address[1]


def _post(port, path, payload, token=None):
    headers = {} if token is None else {"Authorization": f"Bearer {token}"}
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(), headers=headers,
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers, exc.read()


def _health(port):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def test_healthz(port):
    code, body = _health(port)
    assert code == 200 and body["status"] == "ok" and body["params"] > 0
    assert "shed_requests" in body and "projected_wait_s" in body
    assert _post(port, "/nope", {})[0] == 404
    try:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/nope", timeout=30)
    except urllib.error.HTTPError as exc:
        assert exc.code == 404


def test_synthesize_returns_wav_equal_to_the_facade(port, service):
    status, headers, body = _post(port, "/synthesize", {"text": "сайн", "steps": 1, "seed": 3})
    assert status == 200 and headers.get("Content-Type") == "audio/wav" and body[:4] == b"RIFF"
    wav, sr = read_wav_bytes(body)
    assert sr == 24000 and len(wav) > 0 and np.isfinite(wav).all()
    want = service.model.synthesize("сайн", n_steps=1, seed=3)
    np.testing.assert_allclose(wav, read_wav_bytes(wav_bytes(want, sr))[0], atol=PCM_ATOL)
    code, health = _health(port)
    assert health["requests"] >= 1 and health["latency_p50_ms"] > 0


def test_synthesize_batch_endpoint(port, service):
    status, _, body = _post(port, "/synthesize_batch",
                            {"texts": ["нэг", "хоёр гурав"], "steps": 1, "seed": 4})
    assert status == 200
    payload = json.loads(body)
    assert payload["sample_rate"] == 24000 and len(payload["wavs_base64"]) == 2
    want = service.model.synthesize_batch(["нэг", "хоёр гурав"], n_steps=1, seed=4)
    for b64, w in zip(payload["wavs_base64"], want):
        got, _ = read_wav_bytes(base64.b64decode(b64))
        np.testing.assert_allclose(got, read_wav_bytes(wav_bytes(w, 24000))[0], atol=PCM_ATOL)


@pytest.mark.parametrize("extra", [{}, {"cfg_interval": [0.1, 0.7], "method": "midpoint"}],
                         ids=["euler", "interval+midpoint"])
def test_stream_endpoint_matches_synthesize(port, extra):
    body = {"text": PARAGRAPH, "steps": 2, "seed": 2, **extra}
    status, headers, streamed = _post(port, "/synthesize_stream", body)
    assert status == 200 and headers.get("Content-Type") == "audio/wav"
    assert headers.get("Transfer-Encoding") == "chunked" and streamed[:4] == b"RIFF"
    status, _, solo = _post(port, "/synthesize", body)
    assert status == 200 and len(streamed) == len(solo)
    got, _ = read_wav_bytes(streamed)  # reads the streaming header's unknown sizes too
    want, _ = read_wav_bytes(solo)
    np.testing.assert_allclose(got, want, atol=PCM_ATOL)


def test_concurrent_requests_merge_and_match_solo(port, service, monkeypatch):
    texts = ["нэг хоёр гурав", "сайн байна уу", "тавтай морилно уу"]
    seeds = [3, 7, 11]
    solo = [_post(port, "/synthesize", {"text": t, "steps": 1, "seed": s})[2]
            for t, s in zip(texts, seeds)]
    before = service.batcher.merged_batches
    results = [None] * 3

    def wait_for(cond):
        deadline = time.monotonic() + 30
        while not cond() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert cond()

    took = threading.Event()
    real_take = service.batcher._take_batch

    def spy():
        key, batch = real_take()
        if batch:
            took.set()
        return key, batch

    monkeypatch.setattr(service.batcher, "_take_batch", spy)
    with service.model_lock:  # a busy device: the dispatcher takes one request and waits
        blocker = threading.Thread(target=_post, args=(
            port, "/synthesize", {"text": "за", "steps": 1}))
        blocker.start()
        assert took.wait(timeout=30)
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(i, _post(
            port, "/synthesize", {"text": texts[i], "steps": 1, "seed": seeds[i]})))
            for i in range(3)]
        for th in threads:
            th.start()
        wait_for(lambda: service.batcher._queued == 3)  # all three wait behind it
    blocker.join(timeout=120)
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive()
    assert service.batcher.merged_batches == before + 1
    for (status, _, body), expect in zip(results, solo):
        assert status == 200
        got, want = read_wav_bytes(body)[0], read_wav_bytes(expect)[0]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=PCM_ATOL)


def test_voice_cloning_by_base64(port, service, tmp_path):
    sr = 24000
    ref = (0.3 * np.sin(2 * np.pi * 220 * np.arange(sr // 2) / sr)).astype(np.float32)
    body = {"text": "сайн", "steps": 1, "seed": 6, "ref_text": "тийм",
            "ref_audio_b64": base64.b64encode(wav_bytes(ref, sr)).decode()}
    status, headers, payload = _post(port, "/synthesize", body)
    assert status == 200 and headers.get("Content-Type") == "audio/wav"
    write_wav(tmp_path / "ref.wav", ref, sr)
    want = service.model.synthesize("сайн", n_steps=1, seed=6,
                                    ref_audio_path=tmp_path / "ref.wav", ref_text="тийм")
    got, _ = read_wav_bytes(payload)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=PCM_ATOL)
    # a server-side path works too; both at once, a missing file and bad base64 are 400s
    status, _, by_path = _post(port, "/synthesize", {
        "text": "сайн", "steps": 1, "seed": 6, "ref_text": "тийм",
        "ref_audio_path": str(tmp_path / "ref.wav")})
    assert status == 200 and by_path == payload
    for bad, needle in (({"ref_audio_b64": "!!!not-base64!!!"}, b"ref_audio_b64"),
                        ({"ref_audio_path": str(tmp_path / "none.wav")}, b"not found"),
                        ({"ref_audio_b64": "AAAA", "ref_audio_path": "x"}, b"not both")):
        status, _, payload = _post(port, "/synthesize", {"text": "x", "steps": 1, **bad})
        assert status == 400 and needle in payload


@pytest.mark.parametrize("path,payload,code,needle", [
    ("/synthesize", {}, 400, b"missing 'text'"),
    ("/synthesize", {"text": "   "}, 400, b"missing 'text'"),
    ("/synthesize", {"text": 123}, 400, b"missing 'text'"),
    ("/synthesize_stream", {"text": 123}, 400, b"missing 'text'"),
    ("/synthesize_stream", {"text": "x", "steps": 0}, 400, b"n_steps"),
    ("/synthesize", {"text": "x", "steps": None}, 400, b"invalid parameter"),
    ("/synthesize", {"text": "x", "seed": "abc"}, 400, b"invalid parameter"),
    ("/synthesize", {"text": "x", "sway_sampling_coef": "abc"}, 400, b"invalid parameter"),
    ("/synthesize", {"text": "x", "cfg_interval": [0.8, 0.2]}, 400, b"cfg_interval"),
    ("/synthesize", {"text": "x", "cfg_interval": 0.5}, 400, b"cfg_interval"),
    ("/synthesize", {"text": "x", "method": "heun"}, 400, b"method"),
    ("/synthesize", {"text": "x", "lang": "en", "steps": 1}, 400, b"Unsupported language"),
    ("/synthesize_batch", {"texts": ["ok", 5]}, 400, b"missing 'texts'"),
    ("/synthesize_batch", {"texts": ["x"] * 257}, 413, b"too many texts"),
    ("/nope", {}, 404, b"not found"),
])
def test_error_paths(port, path, payload, code, needle):
    status, headers, body = _post(port, path, payload)
    assert status == code and needle in body
    assert headers.get("Content-Type") == "application/json"


def test_malformed_bodies(port):
    for raw, needle in ((b"{not json", b"invalid JSON"), (b"[1, 2]", b"must be an object")):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/synthesize", data=raw,
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=30)
        assert err.value.code == 400 and needle in err.value.read()


@pytest.mark.parametrize("bad_len,code", [(b"-1", b"413"), (str(32 * 1024 * 1024 + 1).encode(),
                                                           b"413"), (b"abc", b"400")])
def test_hostile_content_length_closes_the_connection(port, bad_len, code):
    """The unread body must not be parsed as a second request on a kept-alive socket."""
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(b"POST /synthesize HTTP/1.1\r\nHost: t\r\nContent-Type: application/json\r\n"
                  b"Content-Length: " + bad_len + b"\r\n\r\nGET /healthz HTTP/1.1\r\n\r\n")
        s.settimeout(10)
        data = b""
        while True:  # the server closes: recv drains to EOF instead of hanging
            chunk = s.recv(4096)
            if not chunk:
                break
            data += chunk
    assert code in data.split(b"\r\n", 1)[0], data[:120]
    assert b"HTTP/1.1 200" not in data


def test_bearer_auth_gate(port, service):
    service.auth_token = "s3cret"
    try:
        code, headers, body = _post(port, "/synthesize", {"text": "сайн"})
        assert code == 401 and b"bearer" in body.lower()
        assert headers.get("WWW-Authenticate") == "Bearer"
        assert _post(port, "/synthesize", {"text": "сайн"}, token="wrong")[0] == 401
        code, _, body = _post(port, "/synthesize", {"text": "сайн", "steps": 1}, token="s3cret")
        assert code == 200 and len(body) > 44
        assert _health(port)[0] == 200  # stays open for load-balancer probes
    finally:
        service.auth_token = None


@pytest.mark.parametrize("path,payload", [
    ("/synthesize", {"text": "сайн", "steps": 1}),             # waits in the batcher's queue
    ("/synthesize_batch", {"texts": ["сайн"], "steps": 1}),    # waits for the model lock
    ("/synthesize_stream", {"text": "сайн", "steps": 1}),
])
def test_request_timeout_is_a_504(port, service, path, payload):
    old = service.request_timeout_s
    service.request_timeout_s = 0.3
    try:
        with service.model_lock:  # a wedged device
            code, _, body = _post(port, path, payload)
        assert code == 504 and b"timed out" in body
    finally:
        service.request_timeout_s = old
    time.sleep(0.1)
    assert service.batcher._queued == 0  # the abandoned entry left the backlog


def _idle_batcher(service, **fields):
    """A batcher without a dispatcher thread, its queues set by the test."""
    b = serve.MicroBatcher.__new__(serve.MicroBatcher)
    b._service, b._cv = service, threading.Condition()
    b._max_batch, b._max_queue, b._queues, b._queued = 16, 64, {}, 0
    b._solve_ewma_s, b._solves_timed = serve.SOLVE_EWMA_PRIOR_S, 0
    b.merged_batches = b.shed_requests = 0
    for name, value in fields.items():
        setattr(b, name, value)
    return b


def test_admission_control_429_by_projected_wait(port, service):
    queues = {("k", i): [serve._Request(f"t{j}", 0) for j in range(2)] for i in range(5)}
    b = _idle_batcher(service, _max_batch=2, _queues=queues, _queued=10, _solve_ewma_s=5.0)
    saved, old = service.batcher, service.request_timeout_s
    service.batcher, service.request_timeout_s = b, 1.0  # 5 solves × 5 s against 1 s
    try:
        code, headers, body = _post(port, "/synthesize", {"text": "сайн", "steps": 1})
        assert code == 429 and b"overloaded" in body and b.shed_requests == 1
        assert headers.get("Retry-After") == "25"
        assert _health(port)[1]["shed_requests"] == 1
    finally:
        service.batcher, service.request_timeout_s = saved, old


def test_admission_hard_queue_cap(port, service):
    b = _idle_batcher(service, _max_queue=4, _queued=4, _solve_ewma_s=0.001)
    saved, service.batcher = service.batcher, b
    try:
        assert _post(port, "/synthesize", {"text": "сайн", "steps": 1})[0] == 429
    finally:
        service.batcher = saved


def test_take_batch_rotates_busy_keys_and_drops_abandoned(service):
    b = _idle_batcher(service, _max_batch=2)
    reqs_a = [serve._Request(f"a{i}", 0) for i in range(5)]
    req_b = serve._Request("b", 0)
    gone = serve._Request("gone", 0)
    gone.abandoned = True  # its submit already took it out of `_queued`
    b._queues = {("k", "a"): [gone] + reqs_a, ("k", "b"): [req_b]}
    b._queued = 6
    assert b._solves_ahead_locked() == 4
    assert b._take_batch() == (("k", "a"), reqs_a[:2])
    assert b._take_batch() == (("k", "b"), [req_b])  # a's backlog does not starve b
    assert b._take_batch() == (("k", "a"), reqs_a[2:4])
    assert b._take_batch() == (("k", "a"), reqs_a[4:])
    assert b._take_batch() == (None, None)
    assert b._queues == {} and b._queued == 0 and gone.taken


def test_first_solve_stays_out_of_the_estimate(service):
    b = _idle_batcher(service)
    b._record_solve(40.0)  # kernels are built and libraries start on the first solve
    assert b._solve_ewma_s == serve.SOLVE_EWMA_PRIOR_S
    b._record_solve(serve.SOLVE_EWMA_PRIOR_S + 1.0)
    assert b._solve_ewma_s == pytest.approx(serve.SOLVE_EWMA_PRIOR_S + 0.3)


def test_batcher_isolates_a_bad_request(service):
    batcher = serve.MicroBatcher(service, window_s=0.3)
    results = {}

    def submit(name, text):
        try:
            results[name] = batcher.submit(text, 5, PARAMS)
        except Exception as exc:  # noqa: BLE001 - the test inspects it
            results[name] = exc

    threads = [threading.Thread(target=submit, args=("good", "сайн")),
               threading.Thread(target=submit, args=("bad", "   "))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        batcher.close()
    assert isinstance(results["bad"], ValueError)
    assert isinstance(results["good"], np.ndarray) and len(results["good"])
    assert not batcher._thread.is_alive()


def test_abandoned_requests_are_not_solved(service):
    calls = []

    class CountingModel:
        sample_rate = 24000

        def num_params(self):
            return 1

        def synthesize_batch(self, texts, seeds=None, **kw):
            calls.append(list(texts))
            return [np.zeros(8, np.float32) for _ in texts]

    svc = serve.Service(CountingModel(), window_s=0.2, request_timeout_s=0.05)
    try:
        with svc.model_lock:  # wedge the device while the requests queue and time out
            for text in ("сайн", "байна"):
                with pytest.raises(serve.RequestTimeout):
                    svc.batcher.submit(text, 0, PARAMS)
            time.sleep(0.4)  # the dispatcher takes, and drops, both
        time.sleep(0.3)
        assert calls == [] and svc.batcher._queued == 0
        svc.request_timeout_s = 30.0
        assert len(svc.batcher.submit("сайн", 0, PARAMS)) == 8 and calls == [["сайн"]]
    finally:
        svc.close()


def test_many_threads_keep_the_backlog_count_consistent(service):
    """More submitters than cores against a fast fake model: every request is
    answered once and the backlog count returns to zero (a lost update on
    ``_queued`` would leave it off)."""
    import sys

    class EchoModel:
        sample_rate = 24000

        def num_params(self):
            return 1

        def synthesize_batch(self, texts, seeds=None, **kw):
            return [np.full(4, s, np.float32) for s in seeds]

    svc = serve.Service(EchoModel(), window_s=0.0, max_batch=4, max_queue=10_000)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    results = {}
    try:
        def worker(i):
            out = [svc.batcher.submit("t", i * 100 + j, {**PARAMS, "n_steps": 1 + j % 3})
                   for j in range(20)]
            results[i] = [int(o[0]) for o in out]

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
        svc.close()
    assert results == {i: [i * 100 + j for j in range(20)] for i in range(32)}
    assert svc.batcher._queued == 0 and svc.batcher._queues == {}
    assert svc.batcher.merged_batches > 0


def test_healthz_reports_draining(port, service):
    service.draining = True
    try:
        code, body = _health(port)
        assert code == 503 and body["status"] == "draining"
    finally:
        service.draining = False


def test_drain_finishes_the_request_in_flight(service):
    class SlowModel:
        sample_rate = 24000

        def num_params(self):
            return 1

        def synthesize(self, text, seed=None, **kw):
            time.sleep(0.6)
            return service.model.synthesize(text, seed=seed, **kw)

    svc = serve.Service(SlowModel(), batching=False)
    server = serve.DrainingHTTPServer(("127.0.0.1", 0), svc)
    thread = threading.Thread(target=server.serve_forever)
    thread.start()
    result = {}
    client = threading.Thread(target=lambda: result.update(resp=_post(
        server.server_address[1], "/synthesize", {"text": "сайн", "steps": 1})))
    client.start()
    time.sleep(0.25)  # accepted, the solve is in flight
    serve.begin_drain(server)
    assert svc.draining
    server.server_close()  # joins the handler thread in flight
    client.join(timeout=30)
    thread.join(timeout=30)
    assert not client.is_alive() and not thread.is_alive()
    code, headers, body = result["resp"]
    assert code == 200 and headers.get("Content-Type") == "audio/wav" and len(body) > 44


# ── the CLIs: a checkpoint directory on disk, --device cpu ────────────────


@pytest.fixture(scope="module")
def checkpoint_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt")
    write_npz(path / "f5tts_step_00000007.npz", flatten_tree({"params": pad_silent_params()}))
    (path / "config.json").write_text(json.dumps({"model": {
        "dim": DIM, "depth": DEPTH, "heads": HEADS, "text_dim": TEXT_DIM, "conv_layers": 1}}))
    return path


def test_create_server_profile_fast_on_the_cpu(checkpoint_dir):
    server = serve.create_server(["--checkpoint", str(checkpoint_dir), "--device", "cpu",
                                  "--port", "0", "--profile", "fast", "--max-batch", "4",
                                  "--request-timeout", "30", "--auth-token", "tok", "--warmup"])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        svc, port = server.service, server.server_address[1]
        assert svc.model.quant_mode == "int8_dynamic" and svc.model.device.type == "cpu"
        assert svc.profile_defaults == {"cfg_interval": (0.10, 0.70)}
        assert svc.request_timeout_s == 30 and svc.batcher._max_batch == 4
        health = _health(port)[1]
        assert health["profile"] == "fast" and health["quantize"] == "int8_dynamic"
        assert health["device"] == "cpu"
        body = {"text": "сайн байна", "steps": 4, "seed": 1}
        code, _, by_default = _post(port, "/synthesize", body, token="tok")
        assert code == 200
        want = svc.model.synthesize("сайн байна", n_steps=4, seed=1, cfg_interval=(0.1, 0.7))
        np.testing.assert_allclose(read_wav_bytes(by_default)[0], want, atol=PCM_ATOL)
        # a request's own interval wins over the profile's
        code, _, own = _post(port, "/synthesize", {**body, "cfg_interval": [0.0, 1.0]},
                             token="tok")
        want = svc.model.synthesize("сайн байна", n_steps=4, seed=1)
        np.testing.assert_allclose(read_wav_bytes(own)[0], want, atol=PCM_ATOL)
        assert own != by_default
    finally:
        server.shutdown()
        server.server_close()
        server.service.close()
        thread.join(timeout=30)


def test_create_server_plain_flags_on_the_cpu(checkpoint_dir):
    server = serve.create_server(["--checkpoint", str(checkpoint_dir), "--device", "cpu",
                                  "--port", "0", "--no-batching", "--fp32", "--no-ema",
                                  "--quantize", "int8", "--max-queue", "3"])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        import torch

        svc, port = server.service, server.server_address[1]
        assert svc.batcher is None and svc.model.dtype == torch.float32
        assert svc.model.quant_mode == "int8" and svc.profile_defaults == {}
        health = _health(port)[1]
        assert health["quantize"] == "int8" and health["merged_batches"] == 0
        assert "shed_requests" not in health
        code, _, body = _post(port, "/synthesize", {"text": "сайн", "steps": 1, "seed": 2})
        assert code == 200
        want = svc.model.synthesize("сайн", n_steps=1, seed=2)
        np.testing.assert_allclose(read_wav_bytes(body)[0], want, atol=PCM_ATOL)
    finally:
        server.shutdown()
        server.server_close()
        server.service.close()
        thread.join(timeout=30)


def test_serve_and_infer_refuse_what_is_not_ported(checkpoint_dir, tmp_path, monkeypatch,
                                                   capsys):
    # --mesh 2x4 without a world of 8 is refused for the world (naming
    # torchrun); with --quantize int8 it keeps the w8a16 refusal
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for argv, says in (
            (["--checkpoint", str(checkpoint_dir), "--device", "cpu", "--mesh", "2x4"],
             "does not cover 1 process"),
            (["--checkpoint", str(checkpoint_dir), "--device", "cpu", "--mesh", "2x4",
              "--quantize", "int8"], "single-device")):
        with pytest.raises(SystemExit):
            serve.create_server(argv)
        err = capsys.readouterr().err
        assert says in err and "ROADMAP.md" not in err
    assert "torch.distributed.run --nproc-per-node 8" not in err  # the int8 refusal comes first
    # torch checkpoints are read since the torch_compat port: an unreadable one
    # is refused by its reader, a hub id or a missing file as a vocoder too
    (tmp_path / "model.safetensors").write_bytes(b"x")
    with pytest.raises(ValueError, match="safetensors header"):
        load_model(str(tmp_path / "model.safetensors"), device="cpu")
    with pytest.raises(SystemExit, match="does not exist"):
        load_model(str(tmp_path / "missing"), device="cpu")
    for vocoder, match in (("charactr/vocos-mel-24khz", "hub id"),
                           (str(tmp_path / "vocos.pt"), "no Vocos checkpoint")):
        with pytest.raises(FileNotFoundError, match=match):
            infer_main(["--checkpoint", str(checkpoint_dir), "--device", "cpu", "--text", "x",
                        "--vocoder", vocoder])
    infer_main(["--checkpoint", str(checkpoint_dir), "--device", "cpu", "--text", "сайн",
                "--steps", "1", "--vocoder", "griffin_lim", "--output", str(tmp_path / "gl.wav")])
    wav, rate = read_wav(tmp_path / "gl.wav")
    assert rate == 24000 and len(wav) > 0 and np.isfinite(wav).all()
    # a calibrated duration table in config.json is read, no longer refused
    stats_dir = tmp_path / "stats"
    stats_dir.mkdir()
    table = {"fpc": [9.5] * 65, "global": 9.5, "n": 8}
    config = json.loads((checkpoint_dir / "config.json").read_text())
    (stats_dir / "config.json").write_text(json.dumps({**config, "duration_stats": table}))
    name = "f5tts_step_00000007.npz"
    (stats_dir / name).write_bytes((checkpoint_dir / name).read_bytes())
    assert load_model(str(stats_dir), device="cpu").duration_stats == table
    # without a card and without --device cpu both CLIs raise before any work
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.create_server(["--checkpoint", str(checkpoint_dir), "--port", "0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        infer_main(["--checkpoint", str(checkpoint_dir), "--text", "сайн"])


def test_infer_cli_text_and_text_file(checkpoint_dir, tmp_path):
    out = tmp_path / "out" / "one.wav"
    infer_main(["--checkpoint", str(checkpoint_dir), "--device", "cpu", "--text", PARAGRAPH,
                "--steps", "2", "--seed", "4", "--max-chars-per-chunk", "40",
                "--cfg-interval", "0.1,0.7", "--ode-method", "midpoint",
                "--quantize", "int8", "--output", str(out)])
    wav, sr = read_wav(out)
    model = load_model(str(checkpoint_dir), device="cpu", quantize="int8")
    want = model.synthesize(PARAGRAPH, n_steps=2, seed=4, max_chars_per_chunk=40,
                            cfg_interval=(0.1, 0.7), method="midpoint")
    assert sr == 24000 and wav.shape == want.shape
    np.testing.assert_allclose(wav, want, atol=PCM_ATOL)

    lines = tmp_path / "lines.txt"
    lines.write_text("Сайн байна уу\n\nБаярлалаа\n")
    infer_main(["--checkpoint", str(checkpoint_dir / "f5tts_step_00000007.npz"), "--device",
                "cpu", "--text-file", str(lines), "--steps", "1", "--seed", "2",
                "--output", str(tmp_path / "batch.wav")])
    plain = load_model(str(checkpoint_dir), device="cpu")
    want = plain.synthesize_batch(["Сайн байна уу", "Баярлалаа"], n_steps=1, seed=2)
    for i, w in enumerate(want):
        got, _ = read_wav(tmp_path / f"batch_{i:03d}.wav")
        np.testing.assert_allclose(got, w, atol=PCM_ATOL)
    with pytest.raises(SystemExit):
        infer_main(["--checkpoint", str(checkpoint_dir), "--device", "cpu"])
    with pytest.raises(SystemExit):
        infer_main(["--checkpoint", str(checkpoint_dir), "--device", "cpu", "--text", "x",
                    "--cfg-interval", "0.9,0.1"])
