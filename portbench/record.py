"""What a traced run records, and its reduction: spans, calls, and the device trace.

Spans and call records come from the benchmark's own wrappers around calls
into the program's layers (:class:`Probe`); host times are
``time.time_ns()``, the clock the profiler stamps device events with, so
a device gap can be named by the span open on the host at the time. The
device trace is ``torch.profiler`` over CUDA activity only, for a stretch
in the middle of the measured window.
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from collections import defaultdict


def pct(values: list[float], q: float) -> float:
    """The nearest-rank ``q`` quantile: the ``ceil(q·n)``-th smallest value (``inf`` counts)."""
    s = sorted(values)
    if not s:
        raise ValueError("no values")
    return s[min(len(s) - 1, max(0, math.ceil(q * len(s) - 1e-9) - 1))]


def now_ns() -> int:
    return time.time_ns()


class Probe:
    """Thread-safe lists of spans and call records, filled by wrappers."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.spans: list[dict] = []
        self.calls: dict[str, list[dict]] = defaultdict(list)
        self.tracing = False  # set while the profiler records

    def span(self, name: str, t0: int, t1: int, **attrs) -> None:
        with self._lock:
            self.spans.append({"name": name, "t0": t0, "t1": t1, **attrs})

    def call(self, kind: str, **attrs) -> None:
        attrs["traced"] = self.tracing
        with self._lock:
            self.calls[kind].append(attrs)


def device_summary(events: list[tuple[str, int, int]], t0: int, t1: int) -> dict:
    """Busy seconds (the union of device intervals inside [t0, t1]), time by kernel name,
    and the merged busy intervals."""
    by_name: dict[str, list] = defaultdict(lambda: [0.0, 0])
    ivs = []
    for name, s, e in events:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        entry = by_name[name]
        entry[0] += (e - s) / 1e9
        entry[1] += 1
        ivs.append((s, e))
    ivs.sort()
    merged: list[list[int]] = []
    for s, e in ivs:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) / 1e9
    return {"busy_s": busy, "by_name": dict(by_name), "busy": merged}


def idle_gaps(busy: list[list[int]], t0: int, t1: int, spans: list[dict],
              min_gap_ns: int = 20_000) -> dict[str, float]:
    """Idle device seconds inside [t0, t1], by the innermost benchmark span open on the
    host at each gap's midpoint (gaps under ``min_gap_ns`` are launch spacing and are
    summed as ``between launches``)."""
    gaps, at = [], t0
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if at < t1:
        gaps.append((at, t1))
    spans = sorted(spans, key=lambda sp: sp["t0"])
    out: dict[str, float] = defaultdict(float)
    for s, e in gaps:
        if e - s < min_gap_ns:
            out["between launches"] += (e - s) / 1e9
            continue
        mid = (s + e) // 2
        open_ = [sp for sp in spans if sp["t0"] <= mid < sp["t1"]]
        name = (min(open_, key=lambda sp: sp["t1"] - sp["t0"])["name"] if open_
                else "no benchmark span open")
        out[name] += (e - s) / 1e9
    return dict(out)


def read_profiler(prof) -> list[tuple[str, int, int]]:
    """(name, start ns, end ns) of every device event in a finished profiler."""
    import torch

    out = []
    try:
        events = prof.profiler.kineto_results.events()
        for ev in events:
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                out.append((ev.name(), ev.start_ns(), ev.end_ns()))
    except AttributeError:  # an older profiler: its FunctionEvents, in µs from its start
        base = prof.profiler.kineto_results.trace_start_ns()
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                s = base + int(ev.time_range.start * 1000)
                out.append((ev.name, s, base + int(ev.time_range.end * 1000)))
    return out


def kernel_s(trace: dict, key: str) -> float:
    """Device seconds of the traced kernels whose name holds ``key``."""
    return sum(s for name, (s, _) in trace.get("kernels", {}).items() if key in name)


MARKER_CYCLES = 20_000  # a short ``torch.cuda._sleep``: the clock marker a trace starts with
# a span's edges on the device, in stream order: a short spin opens, a long one closes
OPEN_CYCLES, CLOSE_CYCLES = 1_000, 30_000
LONG_NS = 8_000  # a spin this long or longer closes a span (the clock marker, ~10 us, too)


def is_marker(name: str) -> bool:
    return "spin_kernel" in name or "sleep" in name.lower()


def edge(probe: Probe, opens: bool) -> None:
    """While tracing, launch a span's opening or closing marker: on one stream it starts
    after every kernel launched before it and before every kernel launched after it,
    without a sync."""
    if probe.tracing:
        import torch

        torch.cuda._sleep(OPEN_CYCLES if opens else CLOSE_CYCLES)


def between_edges(events: list[tuple[str, int, int]]) -> tuple[float, int]:
    """Device seconds of the kernels that ran between each opening marker and the long
    marker after it, and the number of such pairs; a long marker with no opening one
    before it (the clock's) closes nothing."""
    marks = sorted((s, e) for name, s, e in events if is_marker(name))
    kernels = sorted((s, e) for name, s, e in events if not is_marker(name))
    starts = [s for s, _ in kernels]
    spans, open_end = [], None
    for s, e in marks:
        if e - s < LONG_NS:
            open_end = e
        elif open_end is not None:
            spans.append((open_end, s))
            open_end = None
    total, pairs = 0.0, 0
    for a1, b0 in spans:
        k = bisect.bisect_left(starts, a1)
        while k < len(kernels) and kernels[k][1] <= b0:
            total += (kernels[k][1] - kernels[k][0]) / 1e9
            k += 1
        pairs += 1
    return total, pairs


def profiler_warm_up() -> None:
    """Start and stop the profiler once during set-up: its first start pays CUPTI's
    initialisation, seconds that would otherwise fall inside the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    torch.cuda._sleep(MARKER_CYCLES)
    torch.cuda.synchronize()
    prof.stop()


def trace_start(box: dict, probe: Probe):
    """Start the device trace on this thread; a marker kernel launched on an idle device
    at a known host time ties the device clock to ``now_ns``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    torch.cuda.synchronize()
    box["marker_host"] = now_ns()
    torch.cuda._sleep(MARKER_CYCLES)
    box["t0"] = now_ns()
    box["t0_perf"] = time.perf_counter()
    probe.tracing = True
    return prof


def trace_stop(box: dict, probe: Probe, prof) -> None:
    import torch

    probe.tracing = False
    torch.cuda.synchronize()
    box["t1"] = now_ns()
    prof.stop()
    box["prof"] = prof


def aligned(events: list[tuple[str, int, int]], box: dict) -> list[tuple[str, int, int]]:
    """Device events moved onto the host clock by the marker's offset (its launch
    latency, some microseconds, stays in); unchanged when no marker was traced."""
    marks = [s for name, s, _ in events if is_marker(name)]
    if not marks or "marker_host" not in box:
        return events
    shift = min(marks) - box["marker_host"]
    box["clock_shift_ns"] = shift
    return [(name, s - shift, e - shift) for name, s, e in events]
