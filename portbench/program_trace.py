"""The program's own spans and counters beside the device trace of a training run.

``oron_tts_tpu_torch/utils/trace.py`` records, while switched on, spans at the
training path's layer boundaries (``loader.wait``; ``train.step`` and its
phases ``train.h2d``, ``train.forward`` with ``cfm.draw`` inside it,
``train.backward``, ``train.grads``, ``train.read``, ``train.update``) and
the collator's counters (``collate.frames_kept``, ``collate.frames_collated``),
on ``time.time_ns()``. This module moves the profiler's device operations and
runtime calls onto that clock (:func:`clocks`) and reduces them together:

- ``idle_by_span``: idle device seconds of every gap, whatever its length, by
  the innermost program span open at the gap's midpoint (its own time: a
  child's interval counts for the child), else ``outside the program``;
- ``launches_by_span``: device operations and their seconds by the innermost
  program span open when each was launched; the launch is the runtime call
  (``cudaLaunchKernel`` and kin, ``cudaMemcpyAsync``) that the profiler ties to
  the operation by its correlation id;
- ``idle_gaps``: :func:`portbench.record.idle_gaps` over the benchmark's spans
  and the program's together, so a gap inside the benchmark's ``step`` span is
  named by the program's phase;
- :data:`METRICS`: six per-layer readings of those keys.

The harness does not run any of this: ``portbench/run.py`` reads none of these
keys. This module's entry point runs a cell through the harness with the
program's tracer switched on, and prints the harness's result line and then a
line of the program's readings::

    python3 -m portbench.program_trace --workload base.train.48k --seed 7 --seconds 51

``--profile 0`` leaves the device trace off and keeps the tracer on for the
whole run: the tracer's own cost is that run's rate against ``--trace 0``'s.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import sys
from collections import defaultdict

from portbench import record

OUTSIDE = "outside the program"
LAUNCH_PHASES = ("train.forward", "train.backward", "train.grads", "train.update")
IDLE_NS = 20_000  # a gap this long before a kernel: the device waited for its launch


def read_launches(prof) -> tuple[list[tuple], dict[int, int]]:
    """The device operations of a finished profiler as (name, start ns, end ns,
    correlation id), and the host start (ns, profiler clock) of each runtime call by
    its correlation id."""
    import torch

    ops, calls = [], {}
    for ev in prof.profiler.kineto_results.events():
        corr = int(ev.correlation_id())
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            ops.append((ev.name(), ev.start_ns(), ev.end_ns(), corr))
        elif corr and ev.name().startswith("cu"):
            calls[corr] = ev.start_ns()
    return ops, calls


def clocks(ops: list[tuple], calls: dict[int, int], box: dict):
    """The maps from the profiler's two clocks onto the host's.

    Runtime calls are stamped on a host clock: one offset moves them, read off the
    launch of the marker the trace ends with (``marker_host_end``; without one, the
    one it starts with), its few microseconds of Python left in. Device times wander
    against it by milliseconds (a rate, then a jump back, as the profiler re-syncs the
    two). An operation that starts after the device sat idle began as soon as it was
    launched, so its start less its launch reads the wander there (plus the launch
    latency, microseconds); a device time is moved by the least of the nearest such
    readings (a start that waited on more than its launch reads high), interpolated.
    Returns (device to host, call to host), and records the wander's range in
    ``box["clock_wander_us"]``."""
    marks = sorted((s, corr) for name, s, _, corr in ops if record.is_marker(name))
    if not marks:
        return (lambda t: t), (lambda t: t)
    if "marker_host_end" in box:
        corr, host = marks[-1][1], box["marker_host_end"]
    else:
        corr, host = marks[0][1], box.get("marker_host")
    if host is None or corr not in calls:
        return (lambda t: t), (lambda t: t)
    call_shift = calls[corr] - host
    idle, last_end = [], None
    for name, s, e, corr in sorted(ops, key=lambda op: op[1]):
        # a kernel's; a pageable copy's chunks start long after their one call
        if (last_end is not None and s - last_end >= IDLE_NS and corr in calls
                and not name.startswith("Mem")):
            idle.append((s, s - calls[corr]))
        last_end = e if last_end is None else max(last_end, e)
    if not idle:
        return (lambda t: t - call_shift), (lambda t: t - call_shift)
    at, raw = [t for t, _ in idle], [x for _, x in idle]
    n = len(raw)
    lag = []
    for i in range(n):  # no start precedes its launch: the least of 7 around each
        h = min(3, i, n - 1 - i)
        lag.append(min(raw[i - h: i + h + 1]))
    box["clock_wander_us"] = [min(lag) / 1e3, max(lag) / 1e3]

    def device(t: int) -> int:
        k = bisect.bisect_right(at, t)
        if k == 0 or k == len(at):
            return t - lag[min(k, len(at) - 1)] - call_shift
        a, b = at[k - 1], at[k]
        w = (t - a) / (b - a) if b > a else 0.0
        return t - round(lag[k - 1] + w * (lag[k] - lag[k - 1])) - call_shift

    return device, (lambda t: t - call_shift)


def launched(ops: list[tuple], calls: dict[int, int], device, call) -> list[tuple]:
    """(name, start, end, launch) on the host clock, ``launch`` None where no runtime
    call carries the operation's correlation id."""
    out = []
    for name, s, e, corr in ops:
        at = calls.get(corr) if corr else None
        start = device(s)
        out.append((name, start, start + (e - s), None if at is None else call(at)))
    return out


class Timeline:
    """Each instant labelled by the innermost program span open then (spans nest on
    one thread, so the latest opened that is still open)."""

    def __init__(self, spans: list[dict]) -> None:
        pieces: list[tuple[int, int, str]] = []
        stack: list[dict] = []
        at = None

        def close_until(t: int) -> None:
            nonlocal at
            while stack and stack[-1]["t1"] <= t:
                top = stack.pop()
                if top["t1"] > at:
                    pieces.append((at, top["t1"], top["name"]))
                    at = top["t1"]

        for sp in sorted(spans, key=lambda sp: (sp["t0"], -sp["t1"])):
            close_until(sp["t0"])
            if stack and sp["t0"] > at:
                pieces.append((at, sp["t0"], stack[-1]["name"]))
            at = sp["t0"] if at is None else max(at, sp["t0"])
            stack.append(sp)
        if stack:
            close_until(max(sp["t1"] for sp in stack))
        self.pieces = pieces
        self.starts = [p[0] for p in pieces]

    def at(self, t: int) -> str:
        k = bisect.bisect_right(self.starts, t) - 1
        if k >= 0 and t < self.pieces[k][1]:
            return self.pieces[k][2]
        return OUTSIDE


def gaps(busy: list[list[int]], t0: int, t1: int) -> list[tuple[int, int]]:
    """The idle stretches of [t0, t1] between merged busy intervals."""
    out, at = [], t0
    for s, e in busy:
        if s > at:
            out.append((at, min(s, t1)))
        at = max(at, e)
    if at < t1:
        out.append((at, t1))
    return [(s, e) for s, e in out if e > s]


def idle_by_span(busy: list[list[int]], t0: int, t1: int, spans: list[dict]) -> dict[str, float]:
    """Idle device seconds of every gap by the innermost program span at its midpoint."""
    line, out = Timeline(spans), defaultdict(float)
    for s, e in gaps(busy, t0, t1):
        out[line.at((s + e) // 2)] += (e - s) / 1e9
    return dict(out)


def launches_by_span(ops: list[tuple], spans: list[dict]) -> dict[str, list]:
    """[count, device seconds] of the operations by the innermost program span open at
    their launch; the benchmark's marker kernels are left out, and operations with no
    matched launch come under ``unmatched``."""
    line, out = Timeline(spans), defaultdict(lambda: [0, 0.0])
    for name, s, e, at in ops:
        if record.is_marker(name):
            continue
        entry = out["unmatched" if at is None else line.at(at)]
        entry[0] += 1
        entry[1] += (e - s) / 1e9
    return dict(out)


def whole_steps(spans: list[dict], t0: int, t1: int) -> tuple[list[dict], set[int]]:
    """The ``train.step`` spans inside [t0, t1], and the ids of every span under them."""
    steps = [sp for sp in spans
             if sp["name"] == "train.step" and t0 <= sp["t0"] and sp["t1"] <= t1]
    parent = {sp["id"]: sp["parent"] for sp in spans}
    roots = {sp["id"] for sp in steps}
    under = set()
    for sp in spans:
        k = sp["id"]
        while k is not None and k not in roots:
            k = parent.get(k)
        if k is not None:
            under.add(sp["id"])
    return steps, under


def extend(rec: dict, box: dict, bench_spans: list[dict], program: dict,
           ops: list[tuple]) -> dict:
    """Add the program's keys to a training trace record (``training._trace_record``'s),
    and name its idle gaps by both span sets; ``ops`` are :func:`launched`'s. The
    stretch read starts with the first step that began after the profiler began to
    record (``box["recorded_from"]``): what was launched before then is not in it."""
    t0, t1 = box["t0"], box["t1"]
    begun = max(t0, box.get("recorded_from", t0))
    t0 = min((sp["t0"] for sp in program["spans"]
              if sp["name"] == "train.step" and sp["t0"] >= begun), default=begun)
    dev = record.device_summary([(n, s, e) for n, s, e, _ in ops], t0, t1)
    spans = program["spans"]
    steps, under = whole_steps(spans, t0, t1)
    inside = [sp for sp in spans if sp["id"] in under]
    step_ivs = sorted((sp["t0"], sp["t1"]) for sp in steps)
    starts = [a for a, _ in step_ivs]

    def in_step(t: int) -> bool:
        k = bisect.bisect_right(starts, t) - 1
        return k >= 0 and t <= step_ivs[k][1]

    mine = [op for op in ops if not record.is_marker(op[0])]
    rec.update({
        "program_spans": spans, "program_counters": program["counters"],
        "program_window_s": (t1 - t0) / 1e9, "program_busy_s": dev["busy_s"],
        "idle_by_span": idle_by_span(dev["busy"], t0, t1, spans),
        "launches_by_span": launches_by_span([op for op in ops if t0 <= op[1] < t1], spans),
        "idle_gaps": record.idle_gaps(dev["busy"], t0, t1, bench_spans + spans),
        "whole_steps": len(steps),
        "step_span_s": {n: sum(sp["t1"] - sp["t0"] for sp in inside if sp["name"] == n) / 1e9
                        for n in sorted({sp["name"] for sp in inside})},
        "loader_wait_s": sum(sp["t1"] - sp["t0"] for sp in spans if sp["name"] == "loader.wait"
                             and t0 <= sp["t0"] and sp["t1"] <= t1) / 1e9,
        "launches_matched": sum(op[3] is not None for op in mine),
        "launches_in_steps": sum(op[3] is not None and in_step(op[3]) for op in mine),
    })
    return rec


def _per_step(trace: dict, seconds: float) -> float | None:
    n = trace.get("whole_steps") or 0
    return 1e3 * seconds / n if n else None


def loader_wait_ms(trace: dict) -> float | None:
    """Data layer (``DataLoader``): ``loader.wait`` per step, ms."""
    return _per_step(trace, trace.get("loader_wait_s", 0.0))


def collate_pad_share(trace: dict) -> float | None:
    """Data layer (``TTSCollator``): padded over collated frames of the batches collated
    while tracing, %."""
    c = trace.get("program_counters") or {}
    collated = c.get("collate.frames_collated") or 0
    if not collated:
        return None
    return 100.0 * (collated - c["collate.frames_kept"]) / collated


def feed_ms(trace: dict) -> float | None:
    """DiT step's inputs: ``train.h2d`` and ``cfm.draw`` per step, ms."""
    s = trace.get("step_span_s") or {}
    return _per_step(trace, s.get("train.h2d", 0.0) + s.get("cfm.draw", 0.0))


def update_host_ms(trace: dict) -> float | None:
    """Trainer (``F5Trainer._apply``): the host's ``train.update`` per step, ms."""
    return _per_step(trace, (trace.get("step_span_s") or {}).get("train.update", 0.0))


def launch_idle_share(trace: dict) -> float | None:
    """Device by host phase: idle time in the own time of the launching phases over the
    traced stretch, %."""
    idle = trace.get("idle_by_span")
    if idle is None or not trace.get("program_window_s"):
        return None
    return 100.0 * sum(idle.get(n, 0.0) for n in LAUNCH_PHASES) / trace["program_window_s"]


def launches_per_step(trace: dict) -> float | None:
    """Kernels: device operations launched inside whole ``train.step`` spans, per step."""
    n = trace.get("whole_steps") or 0
    return trace["launches_in_steps"] / n if n and trace.get("launches_matched") else None


METRICS = {
    "loader_wait_ms.train": loader_wait_ms, "collate_pad_share.train": collate_pad_share,
    "feed_ms.train": feed_ms, "update_host_ms.train": update_host_ms,
    "launch_idle_share.train": launch_idle_share, "launches_per_step.train": launches_per_step,
}


def phase_ms(spans: list[dict], skip: int = 0) -> dict[str, float]:
    """Mean host ms per step of each span under ``train.step`` (the first ``skip`` steps
    left out), with ``loader.wait`` over the same steps."""
    steps = sorted((sp for sp in spans if sp["name"] == "train.step"), key=lambda sp: sp["t0"])
    steps = steps[skip:]
    if not steps:
        return {}
    t0, t1 = steps[0]["t0"], steps[-1]["t1"]
    _, under = whole_steps(spans, t0, t1)
    out: dict[str, float] = defaultdict(float)
    for sp in spans:
        if sp["id"] in under or (sp["name"] == "loader.wait" and t0 <= sp["t0"] < t1):
            out[sp["name"]] += (sp["t1"] - sp["t0"]) / 1e6 / len(steps)
    return {"steps": len(steps), **dict(sorted(out.items()))}


@contextlib.contextmanager
def program_traced(state: dict):
    """Within: a traced training run also records the program's spans and counters from
    the start of the device trace to its end, and its trace record carries
    :func:`extend`'s keys (kept in ``state["trace"]``, the operations with their launch
    times in ``state["ops"]``). The device trace ends with a second clock marker."""
    from oron_tts_tpu_torch.utils import trace
    from portbench import training

    start, stop, make = record.trace_start, record.trace_stop, training._trace_record

    def trace_start(box, probe):
        prof = start(box, probe)
        trace.start()
        return prof

    def trace_stop(box, probe, prof):
        import torch

        torch.cuda.synchronize()  # a second clock marker, on an idle device
        box["marker_host_end"] = record.now_ns()
        torch.cuda._sleep(record.MARKER_CYCLES)
        stop(box, probe, prof)
        state["program"] = trace.stop()

    def trace_record(box, probe, cfg, seconds, t_open, t_close):
        rec = make(box, probe, cfg, seconds, t_open, t_close)
        ops, calls = read_launches(box["prof"])
        device, call = clocks(ops, calls, box)
        state["ops"] = launched(ops, calls, device, call)
        if calls:  # the profiler records nothing launched before this
            box["recorded_from"] = call(min(calls.values()))
        state["box"] = box
        state["trace"] = extend(rec, box, probe.spans, state.pop("program"), state["ops"])
        return rec

    record.trace_start, record.trace_stop, training._trace_record = (
        trace_start, trace_stop, trace_record)
    try:
        yield state
    finally:
        record.trace_start, record.trace_stop, training._trace_record = start, stop, make
        trace.stop()


def main(argv: list[str] | None = None) -> int:
    from portbench import run as prun
    from portbench.training import CHECK_STEPS

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--profile", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    run_args = ["--workload", args.workload, "--seed", str(args.seed),
                "--seconds", str(args.seconds), "--trace", str(args.profile)]
    if args.profile:
        with program_traced({}) as state:
            rc = prun.main(run_args)
        tr = state.get("trace")
        if tr is None:
            return rc or 1
        line = {"program_metrics": {k: f(tr) for k, f in METRICS.items()},
                "phase_ms": phase_ms(tr["program_spans"]),
                "idle_by_span": tr["idle_by_span"], "launches_by_span": tr["launches_by_span"],
                "launches": {k: tr[k] for k in ("launches_matched", "launches_in_steps",
                                                "whole_steps")},
                "device_idle_share": 100.0 * (1 - tr["program_busy_s"] / tr["program_window_s"]),
                "program_window_s": tr["program_window_s"],
                "clock_wander_us": state["box"].get("clock_wander_us")}
    else:
        from oron_tts_tpu_torch.utils import trace

        trace.start()
        try:
            rc = prun.main(run_args)
        finally:
            out = trace.stop()
        line = {"phase_ms": phase_ms(out["spans"], skip=CHECK_STEPS),
                "counters": out["counters"]}
    print(json.dumps(line), file=sys.stderr, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
