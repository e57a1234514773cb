"""How ``correct`` is decided in a training cell: its first three steps against the reference.

The reference builds the same three batches from the same WAV files and
texts (its own decode, peak normalisation, log-mel, token ids and
collation: rows padded to a multiple of 8, frames to a multiple of 64),
draws the same random numbers from a generator seeded alike, and takes three
float32 steps of the CFM loss, clipping, AdamW and the EMA from the same
initial weights, through the architecture that the configuration names
(``portbench/reference/__init__.py``). Four numbers compare the two, each by
its worst case:

- ``loss_gap``: |loss − reference loss| / |reference loss|, over the three steps;
- ``grad_gap``: the first step's gradient as the optimizer took it (clipped),
  read off the program's second moment after one step (ν = (1 − β2)·g²), each
  leaf's norm against the reference's;
- ``update_gap``: each leaf's change of the weights over the three steps;
- ``ema_gap``: each leaf's change of the EMA over the three steps.

A leaf's gap is |‖program‖ − ‖reference‖| over the larger of the reference's
norm of that leaf and of the median leaf. Leaves whose reference gradient is
under a thousandth of the median leaf's (nought but rounding, such as a key
projection's bias under softmax) move by round-off alone and are left out.
"""

from __future__ import annotations

import numpy as np

from portbench import audio
from portbench.reference import architecture
from portbench.reference import text as RT
from portbench.reference import train as RTrain
from portbench.reference.mel import log_mel

ROW_MULTIPLE, FRAME_MULTIPLE = 8, 64
ZERO_GRAD = 1e-3


def collate(meta: list[dict], clips: list[int]) -> tuple:
    """The reference's batch of ``clips``: mel [B, M, T], ids [B, T], lengths [B]."""
    mels, ids = [], []
    for i in clips:
        pcm, _ = audio.wav_pcm16(open(meta[i]["audio_path"], "rb").read())
        x = pcm.astype(np.float32) / 32768.0
        peak = float(np.abs(x).max())
        if peak >= 1e-8:
            x = np.clip(x / (peak + 1e-7), -1.0, 1.0)
        m = log_mel(x)
        mels.append(m)
        ids.append(RT.stretch(RT.token_ids(meta[i]["text"], meta[i]["lang"]), m.shape[1]))
    n = len(clips)
    B = -(-n // ROW_MULTIPLE) * ROW_MULTIPLE
    T = -(-max(m.shape[1] for m in mels) // FRAME_MULTIPLE) * FRAME_MULTIPLE
    mel = np.zeros((B, mels[0].shape[0], T), np.float32)
    tid = np.full((B, T), -1, np.int64)
    lens = np.zeros(B, np.int32)
    for r, (m, t) in enumerate(zip(mels, ids)):
        mel[r, :, : m.shape[1]] = m
        tid[r, : len(t)] = t
        lens[r] = m.shape[1]
    return mel, tid, lens


def rows_per_block(T: int) -> int:
    """Rows the reference takes through one forward and backward (its f32 attention
    keeps [rows, heads, T, T] for every block)."""
    return max(1, min(8, int(2.5e6 // (T * T))))


def reference_steps(arch, P, cfg: dict, config: dict, meta: list[dict], clips: list,
                    seed: int, names: list[str], device) -> dict:
    """The reference's three steps of the architecture ``arch`` from its weights ``P``:
    losses, the first clipped gradient, and the weights and EMA before and after."""
    import torch

    m = cfg["model"]
    params = [P.p[n] for n in names]
    opt = RTrain.AdamW(params, config["learning_rate"], config["betas"], config["warmup_steps"],
                       config["ema_decay"], config["max_grad_norm"])
    p0 = [p.detach().cpu().numpy().copy() for p in params]
    gen = torch.Generator().manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)
    probs = (m["audio_drop_prob"], m["cond_drop_prob"])
    pairs = arch.dropout_pairs(cfg)
    order = {n: k for k, n in enumerate(P.p)}
    losses, g1 = [], None
    for k, batch in enumerate(clips):
        mel, tid, lens = collate(meta, batch)
        d = RTrain.draws(gen, mel.shape[0], mel.shape[2], mel.shape[1], pairs, probs)
        loss, grads = RTrain.loss_and_grads(
            P, torch.from_numpy(mel).to(device), torch.from_numpy(tid), torch.from_numpy(lens),
            d, tuple(m["frac_lengths_mask"]), m["p_dropout"], rows_per_block(mel.shape[2]),
            velocity=arch.velocity)
        used = opt.step([grads[order[n]] for n in names])
        if k == 0:
            g1 = [g.cpu().numpy() for g in used]
        losses.append(loss)
    return {"losses": losses, "g1": g1, "p0": p0,
            "p3": [p.cpu().numpy() for p in params], "e3": [e.cpu().numpy() for e in opt.ema]}


def compare(got: dict, ref: dict, names: list[str]) -> dict:
    """The four numbers of ``got`` (the program's steps, or the control's) against ``ref``."""
    norms = np.array([float(np.linalg.norm(g)) for g in ref["g1"]])
    keep = list(norms >= ZERO_GRAD * float(np.median(norms)))
    numbers, where = {}, {}
    lp, lr = np.array(got["losses"]), np.array(ref["losses"])
    numbers["loss_gap"] = float(np.max(np.abs(lp - lr) / np.abs(lr)))
    numbers["grad_gap"], w = RTrain.leaf_gap(got["g1"], ref["g1"], keep)
    where["grad_gap"] = names[w]
    for key, a, b in (("update_gap", "p3", "p0"), ("ema_gap", "e3", "p0")):
        numbers[key], w = RTrain.leaf_gap([x - y for x, y in zip(got[a], got[b])],
                                          [x - y for x, y in zip(ref[a], ref[b])], keep)
        where[key] = names[w]
    return {"numbers": numbers, "worst_leaf": where,
            "left_out_leaves": [n for n, k in zip(names, keep) if not k]}


def training(cfg: dict, config: dict, meta: list[dict], out: dict, seed: int, shapes: dict,
             device, control: bool = False) -> dict:
    """Numbers and problems of a training run's three checked steps; with ``control``
    the program's steps are replaced by the reference's in float8 products."""
    import torch

    from portbench.check import _no_tf32
    from portbench.weights import dit_state

    _no_tf32()
    dtype = getattr(torch, cfg["dit_dtype"]) if str(device) != "cpu" else torch.float32
    arch = architecture(cfg)
    names = out["names"]

    def steps(quant):
        P = arch.params(dit_state(shapes, seed, device, dtype, arch), cfg, device, quant=quant)
        return reference_steps(arch, P, cfg, config, meta, out["check_clips"], seed, names,
                               device)

    ref = steps(None)
    if control:
        got = steps("fp8")
    else:
        b2 = config["betas"][1]
        got = {"losses": out["losses"],
               "g1": [np.sqrt(v.numpy() / (1.0 - b2)) for v in out["nu1"]],
               "p0": [p.numpy() for p in out["params0"]], "p3": [p.numpy() for p in out["params3"]],
               "e3": [p.numpy() for p in out["ema3"]]}
    res = compare(got, ref, names)
    problems = [] if control or all(out["ok"]) else ["a checked step was skipped by the guard"]
    return {"numbers": res["numbers"], "problems": problems,
            "steps": {"loss": got["losses"], "reference_loss": ref["losses"],
                      "left_out_leaves": res["left_out_leaves"], "worst_leaf": res["worst_leaf"]}}
