"""Spans and counters of the port's own layers, recorded in memory while switched on.

Off unless a caller switches it on: :func:`start` clears and arms it,
:func:`stop` disarms it and returns ``{"spans": [...], "counters": {...}}``.
Off, :func:`span` returns one shared no-op context after a single flag check
and :func:`count` returns at once, so the training path pays next to nothing.

A span is a dict: ``name``, ``t0`` and ``t1`` from ``time.time_ns()`` (the
clock a device trace can be moved onto), ``id``, ``parent`` (the id of the
innermost span open on the same thread, or None), ``step`` (the optimizer
step it belongs to; a span given none takes its parent's) and the caller's
attributes. It is recorded when it closes. A counter is a running sum of
whole numbers, safe to add to from worker threads. The tracer never
synchronises the device, records no CUDA events and launches nothing.

    from oron_tts_tpu_torch.utils import trace

    trace.start()
    with trace.span("train.step", step=7) as sp:
        if sp is not None:      # on: attributes worked out only now
            sp["rows"] = 48
        ...
    trace.count("collate.frames_kept", 1234)
    recorded = trace.stop()
"""

from __future__ import annotations

import itertools
import threading
import time

_on = False
_lock = threading.Lock()
_spans: list[dict] = []
_counters: dict[str, int] = {}
_ids = itertools.count(1)
_local = threading.local()


def enabled() -> bool:
    """Whether spans and counters are being recorded."""
    return _on


def start() -> None:
    """Clear what was recorded and record from now on."""
    global _on
    with _lock:
        _spans.clear()
        _counters.clear()
        _on = True


def stop() -> dict:
    """Stop recording; the closed spans (in the order they closed) and the counters."""
    global _on
    with _lock:
        _on = False
        out = {"spans": list(_spans), "counters": dict(_counters)}
        _spans.clear()
        _counters.clear()
    return out


class _Off:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("rec",)

    def __init__(self, rec: dict) -> None:
        self.rec = rec

    def __enter__(self) -> dict:
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        rec = self.rec
        rec["id"] = next(_ids)
        parent = stack[-1] if stack else None
        rec["parent"] = None if parent is None else parent["id"]
        if rec["step"] is None and parent is not None:
            rec["step"] = parent["step"]
        stack.append(rec)
        rec["t0"] = time.time_ns()
        return rec

    def __exit__(self, *exc) -> bool:
        rec = self.rec
        rec["t1"] = time.time_ns()
        _local.stack.pop()
        with _lock:
            if _on:
                _spans.append(rec)
        return False


def span(name: str, step: int | None = None, **attrs):
    """A context recording ``name`` from entry to exit; it yields the span's dict (to
    add attributes to) when on, None when off."""
    if not _on:
        return _OFF
    return _Span({"name": name, "step": step, **attrs})


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name``."""
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n
