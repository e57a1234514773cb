"""Nothing the benchmark runs loads JAX or the JAX package; the reference loads no program."""

from __future__ import annotations

import json
import subprocess
import sys

from portbench.tests.tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "oron_tts_tpu"}

HARNESS = """
import json, sys, time
from portbench import calibrate, check, check_train, run, serving, training, traffic as tr
from portbench.tests import tiny
cfg, mix = tiny.config(), tiny.mix("cloned_solo")
traffic = tr.generate(mix, 1, 2.0)
stack = serving.Stack(cfg, 1, "cpu", mix["server"])
try:
    out = serving.measure(stack, cfg, traffic, 1, 2.0, False, time.perf_counter())
finally:
    stack.close()
check.serving(cfg, traffic, out["served"], out["checked"], out["mels"], 1, stack.shapes, "cpu")
run.per_layer(run.Path("."), json.load(open("BENCHMARK.json")),
              {"name": "base.train.48k"}, {"trace": {"seconds": 1.0, "kernels": {}}})
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

# every module under portbench/reference/, so that an architecture's reference added
# later is held to the same rule
REFERENCE = """
import importlib, json, pathlib, sys
import portbench.reference as ref
imported = []
for path in sorted(pathlib.Path(ref.__file__).parent.glob("*.py")):
    name = "portbench.reference" + ("" if path.stem == "__init__" else "." + path.stem)
    importlib.import_module(name)
    imported.append(name)
print(json.dumps(imported))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def printed(code: str) -> list:
    """The JSON of each line that ``code`` prints, run in a fresh interpreter."""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, check=True)
    return [json.loads(line) for line in out.stdout.strip().splitlines()]


def loaded(code: str) -> set[str]:
    return set(printed(code)[-1])


def test_the_harness_loads_no_jax_nor_the_jax_package():
    mods = loaded(HARNESS)
    assert "oron_tts_tpu_torch" in mods  # the program was driven
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    imported, mods = printed(REFERENCE)[-2:]
    # the glob found the package, the DiT's architecture and the training step
    assert {"portbench.reference.dit", "portbench.reference.train"} <= set(imported), imported
    bad = set(mods) & (FORBIDDEN | {"oron_tts_tpu_torch"})
    assert not bad, bad


def test_the_run_refuses_without_a_card():
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "base.train.48k",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout.strip() == ""
