"""The plain references, and the architecture that each configuration names.

A configuration names its architecture as F5-TTS's own configurations do, by
``model.backbone`` (``"DiT"`` where the key is absent). Lower-cased, the name
is a module of this package: ``"DiT"`` is ``portbench/reference/dit.py``,
``"UNetT"`` would be ``portbench/reference/unett.py``. ``architecture(cfg)``
imports it; ``portbench.run.load_spec`` does so before any set-up, and stops
the run, naming the file, where there is none. Everything the harness knows
of a model's shape it asks that module, so that a new architecture comes in
as new files only (the list is in ``portbench/run.py``).

An architecture module is plain PyTorch or NumPy, imports nothing of the
program and nothing of JAX, and has these functions:

- ``params(state, cfg, device, quant=None)``: the float32 reference's weights
  from ``state`` (the program's state dict, drawn by ``portbench.weights``), as
  an object whose ``p`` maps every key of ``state``, in its order, to a
  float32 tensor on ``device``. ``quant="fp8"`` gives the control: every
  matrix product with both operands rounded to float8 e4m3.
- ``velocity(P, x, cond, ids, t, mask, drop_audio, drop_text, dropout=None)``:
  the text embedding and the backbone's forward that the CFM loss needs.
  ``x`` and ``cond`` are ``[B, T, n_mels]``, ``ids`` ``[B, Nt]`` token ids
  (−1 pads), ``t`` ``[B]``, ``mask`` ``[B, T]`` bool; returns ``[B, T,
  n_mels]``. ``dropout(i)`` gives the ``i``-th seed pair's callable
  ``drop(kind, tensor)`` (``kind`` is ``"attn"`` or ``"ff"``); without it the
  forward is the inference one.
- ``dropout_pairs(cfg)``: how many (attention, FFN) seed pairs a training
  step draws, in the program's order (``portbench.reference.train.draws``).
- ``train_step_flops(cfg, row_frames)``: products only of one training step
  over rows of those kept frames (3 × the forward, no recomputation counted).
- ``solve_flops(cfg, row_frames, steps, guided)``: products only of one CFG
  Euler solve of those rows.

and may have:

- ``weight_rule(key, shape)``: ``(std, mean)`` of a tensor that
  ``portbench.weights``'s own rules do not know (they come first, in their
  order), or None;
- ``sample(P, ids, cond, ref_frames, total, seed, steps, cfg, sway,
  bucket=None)``: one row's CFG Euler solve, ``(mel, initial noise)``, as
  ``dit.sample`` has it. Only serving cells need it; their check refuses an
  architecture without it.
"""

from __future__ import annotations

import importlib
from types import ModuleType

DEFAULT = "DiT"
CONTRACT = ("params", "velocity", "dropout_pairs", "train_step_flops", "solve_flops")


def architecture(cfg: dict) -> ModuleType:
    """The module of the configuration's backbone; LookupError, naming the file, where
    there is none or it lacks a function of the contract."""
    return module(cfg["model"].get("backbone", DEFAULT))


def module(name: str) -> ModuleType:
    stem = str(name).lower()
    where = f"portbench/reference/{stem}.py"
    if not stem.isidentifier():
        raise LookupError(f"backbone {name!r}: no module name, so no {where}")
    full = f"{__name__}.{stem}"
    try:
        mod = importlib.import_module(full)
    except ModuleNotFoundError as exc:
        if exc.name != full:
            raise
        raise LookupError(f"backbone {name!r}: {where} is missing") from None
    missing = [f for f in CONTRACT if not callable(getattr(mod, f, None))]
    if missing:
        raise LookupError(f"backbone {name!r}: {where} lacks {', '.join(missing)}")
    return mod
