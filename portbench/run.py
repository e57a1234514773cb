"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload base.train.48k --seed 7 --seconds 51 --trace 0

Reads ``BENCHMARK.json`` at the checkout's root and finds, by name, the
cell's configuration (``portbench/configs/<config>.json``), traffic mix
(``portbench/traffic/<mix>.json``), limits (``portbench/limits/<cell>.json``)
and, with ``--trace 1``, each per-layer metric's reader
(``portbench/metrics/<metric>.py``). The configuration's ``model.backbone``
(``"DiT"`` where it is absent), lower-cased, names its architecture:
``portbench/reference/<backbone>.py``, the plain reference with its FLOP count
and weight rules (the contract is ``portbench/reference/__init__.py``). An
unknown backbone stops the run there, before any set-up, naming the missing
file.

It makes the inputs and weights from ``--seed``, sets the cell up (weights
on the device, the kernels built or loaded from ``build/`` inside the
checkout, the cell's shapes warmed), measures for ``--seconds``, then checks
the answers against the plain reference. The last line of standard output is
the result: ``{"correct", "attempted", "failed", "metrics", "device"[,
"breakdown"]}``; the numbers compared, each beside its limit, are the last
lines of standard error and the line's last key. Without a card, or with
fewer cards than the cell asks for, it exits 2 and prints no result; if JAX
or the JAX package was loaded, it exits 3.

A configuration of a new architecture comes in as new files and entries
only: ``portbench/configs/<config>.json`` (naming its ``backbone``),
``portbench/reference/<backbone>.py``, ``portbench/limits/<cell>.json``, a
reader ``portbench/metrics/<metric>.py`` for each per-layer metric it adds
with its test case ``portbench/tests/metric_cases/<metric>.json``, and in
``BENCHMARK.json`` its ``configs`` entry, the cell's ``workloads`` entry,
those ``per_layer`` entries, and an ``end_to_end`` entry for each quantity
it reports besides ``setup_s`` (a new traffic mix adds
``portbench/traffic/<mix>.json``). An accepted metric's ``workloads`` list
stays as it is: the new entry is named ``<quantity>.<suffix>``, as
``train_frames_per_s.e2``, lists the new cell, takes its own bound, and
reads the record's ``<quantity>`` (``end_to_end``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "oron_tts_tpu")


def process_age_s() -> float | None:
    """Seconds since this process started (Linux), or None."""
    try:
        start_ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def cache_env(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout; no JAX through
    libraries that would load it."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_spec(root: Path, workload: str) -> tuple[dict, dict, dict]:
    """The benchmark, the cell and its configuration, whose architecture is found here."""
    from portbench.reference import architecture

    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((root / conf["file"]).read_text())
    try:
        architecture(cfg)
    except LookupError as exc:
        raise SystemExit(f"config {conf['name']!r}: {exc}") from None
    return bench, cell, cfg


def run_cell(root: Path, bench: dict, cell: dict, cfg: dict, seed: int, seconds: float,
             trace: bool, device: str, setup_t0: float) -> dict:
    """Set up, measure and check one cell; returns the harness's record."""
    from portbench import traffic as tr

    mix = tr.load_mix(root, cell["traffic"])
    if mix["driver"] == "train":
        from portbench import training

        return training.run(cell, cfg, mix, seed, seconds, trace, device, setup_t0, root)
    from portbench import serving

    traffic = tr.generate(mix, seed, seconds)
    return serving.run(cell, cfg, traffic, seed, seconds, trace, device, setup_t0, root)


def end_to_end(bench: dict, cell: dict, rec: dict) -> dict:
    """The cell's end-to-end metrics. A metric is the record's quantity of its own name
    or, where the record has none, of its name's stem before the first dot: an entry
    ``train_frames_per_s.<suffix>`` whose ``workloads`` lists a cell added later reads
    ``train_frames_per_s`` there, with no accepted entry edited."""
    out = {}
    for m in bench["end_to_end"]:
        if "workloads" in m and cell["name"] not in m["workloads"]:
            continue
        key = m["name"] if m["name"] in rec else m["name"].split(".", 1)[0]
        out[m["name"]] = {"value": float(rec[key]), "unit": m["unit"]}
    return out


def per_layer(root: Path, bench: dict, cell: dict, rec: dict) -> dict:
    """Each per-layer metric's reader, by name; a reader that finds nothing is left out."""
    import importlib.util

    out = {}
    for m in bench["per_layer"]:
        if "workloads" in m and cell["name"] not in m["workloads"]:
            continue
        path = root / "portbench" / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(out)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(rec["trace"])
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def verdict(rec: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and the numbers compared, each with its limit."""
    checks = rec["checks"]
    compared = {k: {"value": v, "limit": limits[k]["limit"]} for k, v in checks["numbers"].items()}
    ok = (not checks["problems"] and rec.get("errors", 0) == 0
          and all(c["value"] <= c["limit"] for c in compared.values()))
    return ok, compared


def breakdown(trace: dict) -> dict:
    ops = sorted(trace["kernels"].items(), key=lambda kv: -kv[1][0])[:10]
    gaps = sorted(trace["idle_gaps"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:120], s] for n, (s, _) in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}


def main(argv: list[str] | None = None) -> int:
    t0 = time.perf_counter()
    age = process_age_s()
    setup_t0 = t0 - (age if age is not None else 0.0)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    cache_env(root)
    bench, cell, cfg = load_spec(root, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"needs {cell['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    from portbench import check

    limits = check.load_limits(root, cell["name"])
    rec = run_cell(root, bench, cell, cfg, args.seed, args.seconds, bool(args.trace), "cuda",
                   setup_t0)
    bad = loaded_forbidden()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    ok, compared = verdict(rec, limits)
    metrics = (per_layer(root, bench, cell, rec) if args.trace
               else end_to_end(bench, cell, rec))
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": int(cell["chips"]), "memory_peak_bytes": rec["memory_peak_bytes"]}
    line = {"correct": ok, "attempted": rec["attempted"], "failed": rec["failed"],
            "metrics": metrics, "device": dev}
    if args.trace:
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
        line["breakdown"] = breakdown(rec["trace"])
    line["compared"] = compared
    detail = {k: v for k, v in rec["checks"].items() if k != "numbers"}
    print(json.dumps({"checked": detail}, default=str), file=sys.stderr)
    for name, c in compared.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
