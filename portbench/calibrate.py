"""Read a serving cell's compared numbers over many seeds, and its control's, in one process.

    python3 -m portbench.calibrate --workload base.serve.poisson --seconds 12 \
        --seeds 11,12,13 --control-seeds 11,12,13

Each seed gets its own weights, traffic and window at the cell's load (the
first ``--seconds`` of it), and the numbers the run's check compares. On the
control seeds the same requests are compared once more with the program's
answers replaced by the reference computed in float8 e4m3 (every product's
operands), the precision below the configuration's bfloat16. One JSON line a
seed and a closing summary (the program's largest reading, the control's
smallest) go to standard output. For choosing limits, not part of a run.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated run seeds")
    ap.add_argument("--control-seeds", default="", help="seeds also read under the control")
    ap.add_argument("--rate", type=float, default=None,
                    help="an open loop's rate (default: the mix's)")
    ap.add_argument("--fault", default=None,
                    help="a training cell: plant this fault (training.plant) and read it")
    args = ap.parse_args(argv)
    root = Path.cwd()
    from portbench import run as prun

    prun.cache_env(root)
    _, cell, cfg = prun.load_spec(root, args.workload)
    import torch

    from portbench import check, serving
    from portbench import traffic as tr

    mix = tr.load_mix(root, cell["traffic"])
    if args.rate:
        mix["rate_per_s"] = args.rate
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    if mix["driver"] == "train":
        return _train(cell, cfg, mix, seeds, controls, args, root)
    stack = None
    lower, upper = {}, {}
    try:
        for seed in seeds:
            t0 = time.perf_counter()
            if stack is None:
                stack = serving.Stack(cfg, seed, "cuda", mix.get("server", {}))
            else:
                stack.load_weights(seed)
            traffic = tr.generate(mix, seed, args.seconds)
            out = serving.measure(stack, cfg, traffic, seed, args.seconds, False, t0)
            line = {"seed": seed, "attempted": out["attempted"], "failed": out["failed"],
                    "latency_p90_s": out["latency_p90_s"]}
            got = check.serving(cfg, traffic, out["served"], out["checked"], out["mels"], seed,
                                stack.shapes, "cuda", root=root)
            line["program"] = got["numbers"]
            line["problems"] = got["problems"]
            line["requests"] = got["requests"]
            for k, v in got["numbers"].items():
                lower[k] = max(lower.get(k, 0.0), v)
            if seed in controls:
                ctl = check.serving(cfg, traffic, out["served"], out["checked"], out["mels"],
                                    seed, stack.shapes, "cuda", control=True, root=root)
                line["control"] = ctl["numbers"]
                for k, v in ctl["numbers"].items():
                    upper[k] = min(upper.get(k, float("inf")), v)
            line["s"] = time.perf_counter() - t0
            print(json.dumps(line), flush=True)
            torch.cuda.empty_cache()
    finally:
        if stack is not None:
            stack.close()
    print(json.dumps({"workload": args.workload, "card": torch.cuda.get_device_name(0),
                      "lower": lower, "upper": upper}), flush=True)
    return 0


def _train(cell, cfg, mix, seeds, controls, args, root) -> int:
    """A training cell: one whole run a seed (its set-up builds the trainer anew)."""
    import torch

    from portbench import training

    lower, upper = {}, {}
    for seed in seeds:
        t0 = time.perf_counter()
        out = training.run(cell, cfg, mix, seed, args.seconds, False, "cuda", t0, root,
                           fault=args.fault, control=seed in controls)
        line = {"seed": seed, "fault": args.fault, "program": out["checks"]["numbers"],
                "problems": out["checks"]["problems"], "steps": out["checks"]["steps"],
                "train_frames_per_s": out["train_frames_per_s"], "setup_s": out["setup_s"]}
        for k, v in out["checks"]["numbers"].items():
            lower[k] = max(lower.get(k, 0.0), v)
        if "control" in out:
            line["control"] = out["control"]["numbers"]
            for k, v in out["control"]["numbers"].items():
                upper[k] = min(upper.get(k, float("inf")), v)
        line["s"] = time.perf_counter() - t0
        line["steps"].pop("left_out_leaves", None)
        print(json.dumps(line), flush=True)
        del out
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "fault": args.fault, "lower": lower,
                      "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
