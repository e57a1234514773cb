"""How ``correct`` is decided: the served answers against the plain reference.

For each checked request the reference works the answer out again from what
the client sent, stage by stage, and each stage is compared on its own:

- ``mel_gap`` (text front end, sampler, DiT): the reference cleans and
  splits the text, tokenises, sizes each chunk, and solves every CFG Euler
  step through every DiT block from the row's own noise; the L2 distance
  between the mel the program solved (what ``CFM.sample`` returned for the
  request's rows) and the reference's, over the generated frames, relative to
  the reference's displacement from the initial noise; the largest over the
  checked requests;
- ``wav_gap`` (vocoder, inverse STFT, chunk joining, PCM16): the reference
  vocodes the program's own solved mel of each chunk, joins the chunks with
  0.25 s of silence and encodes PCM16; the L2 distance of the served samples
  from that, relative to it; the largest over the checked requests (a length
  that differs reads as infinite). The reference reads the program's mel only
  to judge the stage that consumed it;
- ``ref_mel_gap`` (cloned requests: the reference voice's log-mel, kernel 3):
  the L2 distance between the mel magnitudes (``exp`` of the log-mel) of the
  conditioning frames of the program's solve and of the reference's log-mel
  of the WAV the client sent, relative to the reference's; the largest over
  the checked requests.

Each row is solved by the reference padded to the length the program padded
it to (the text encoder's GRN pools over padding, so the length is part of
the row's arithmetic); that length must be a multiple of 64 at least the
row's own. The control puts the reference in the program's place one
precision below the configuration's: float8 e4m3 products in the DiT
(bfloat16 in the configuration), TF32 products in the vocoder and the mel
filterbank (float32). Each number's limit, with the readings it was set
from, is in ``limits/<workload>.json``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from portbench import audio
from portbench.reference import architecture
from portbench.reference import text as RT
from portbench.reference import vocos as V
from portbench.reference.layers import tf32
from portbench.reference.mel import log_mel

BUCKET = 64


def load_limits(root: Path, workload: str) -> dict:
    return json.loads((root / "portbench" / "limits" / f"{workload}.json").read_text())


def _no_tf32() -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _voice_wave(traffic, i: int) -> np.ndarray:
    """Request ``i``'s reference voice as the server reads it: PCM16 / 32768, peak-normalised."""
    pcm, _ = audio.wav_pcm16(traffic.voices[traffic.requests[i].voice].wav)
    x = pcm.astype(np.float32) / 32768.0
    peak = float(np.abs(x).max())
    return np.clip(x / (peak + 1e-7), -1.0, 1.0) if peak >= 1e-8 else x


def plan(traffic, i: int) -> list[dict]:
    """The rows of request ``i``: seed, stretched ids, reference frames, total frames."""
    req = traffic.requests[i]
    speed = float(traffic.mix["request"].get("speed", 1.0))
    cond = np.zeros((0, 100), np.float32)
    ref_frames, ref_ids = 0, []
    if req.voice is not None:
        v = traffic.voices[req.voice]
        cond = log_mel(_voice_wave(traffic, i)).T  # [frames, n_mels]
        ref_frames, ref_ids = cond.shape[0], RT.token_ids(v.text, req.lang)
    rows = []
    for c, chunk in enumerate(RT.split_text(req.text)):
        ids = RT.token_ids(chunk, req.lang)
        target = RT.target_frames(chunk, ids, ref_frames, ref_ids, speed)
        total = ref_frames + target
        stretched = (RT.stretch(ref_ids, ref_frames) + RT.stretch(ids, target) if ref_frames
                     else RT.stretch(ids, total))
        rows.append({"seed": req.seed + c, "ids": stretched, "cond": cond,
                     "ref_frames": ref_frames, "total": total})
    return rows


def solve_rows(sample, P, rows: list[dict], buckets: dict[int, int], request: dict,
               device) -> list:
    """Each row's reference mel (generated frames only) and its initial noise, by the
    architecture's ``sample``."""
    import torch

    out = []
    for row in rows:
        mel, noise = sample(P, row["ids"], torch.from_numpy(row["cond"]).to(device),
                            row["ref_frames"], row["total"], row["seed"],
                            int(request.get("steps", 32)),
                            float(request.get("cfg_strength", 2.0)),
                            request.get("sway_sampling_coef", -1.0),
                            bucket=buckets.get(row["seed"]))
        rf = row["ref_frames"]
        out.append((mel[rf:], noise[rf:]))
    return out


def vocode_rows(voc, mels: list, rnd=None) -> np.ndarray:
    """Chunks vocoded and joined with the pause, as PCM16 values."""
    pause = np.zeros(int(audio.SR * RT.PAUSE_S), np.float32)
    parts = []
    for k, mel in enumerate(mels):
        if k:
            parts.append(pause)
        parts.append(V.vocode(voc, mel, rnd=rnd).cpu().numpy())
    return V.pcm16(np.concatenate(parts))


def _rel(a, b, base) -> tuple[float, float]:
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float((d * d).sum()), float((np.asarray(base, np.float64) ** 2).sum())


def serving(cfg: dict, traffic, served, checked: list[int], mels: dict, seed: int,
            shapes: dict, device, control: bool = False, root: Path | None = None) -> dict:
    """Numbers and problems of one serving run's checked requests.

    ``mels`` maps a row seed to what ``CFM.sample`` returned for it. With
    ``control`` the program's answers are replaced by the reference computed one
    precision lower (the control), at the program's padded lengths.
    """
    import torch

    from portbench.weights import dit_state

    arch = architecture(cfg)
    sample = getattr(arch, "sample", None)
    if sample is None:
        stem = arch.__name__.rsplit(".", 1)[-1]
        raise LookupError(f"portbench/reference/{stem}.py has no sample(), which a serving "
                          "cell's check needs")
    _no_tf32()
    root = root or Path.cwd()
    dtype = getattr(torch, cfg["dit_dtype"]) if str(device) != "cpu" else torch.float32
    state = dit_state(shapes, seed, device, dtype, arch)
    P = arch.params(state, cfg, device)
    Pc = arch.params(state, cfg, device, quant="fp8") if control else None
    del state
    voc = V.load_vocos(root, device)
    request = traffic.mix["request"]
    problems, per = [], []
    worst: dict[str, float] = {"mel_gap": 0.0, "wav_gap": 0.0}
    for i in checked:
        if served.t_sent[i] is None:  # a closed loop closed before it came round
            continue
        if served.status[i] != 200:
            problems.append(f"request {i} answered {served.status[i]}")
            continue
        rows = plan(traffic, i)
        caps = [mels.get(r["seed"]) for r in rows]
        if any(c is None for c in caps):
            problems.append(f"request {i}: a row was never solved")
            continue
        buckets = {r["seed"]: c["bucket"] for r, c in zip(rows, caps)}
        for r in rows:
            b = buckets[r["seed"]]
            if b % BUCKET or b < r["total"]:
                problems.append(f"request {i}: padded to {b} frames for {r['total']}")
        ref = solve_rows(sample, P, rows, buckets, request, device)
        if control:
            got = [m for m, _ in solve_rows(sample, Pc, rows, buckets, request, device)]
            got_wav = vocode_rows(voc, got, rnd=tf32)
        else:
            got = [c["mel"][r["ref_frames"]: r["total"]].to(device) for r, c in zip(rows, caps)]
            got_wav = audio.wav_pcm16(served.wav[i])[0]
        num = den = 0.0
        for (m, noise), g in zip(ref, got):
            n, d = _rel(g.cpu().numpy(), m.cpu().numpy(), (m - noise).cpu().numpy())
            num, den = num + n, den + d
        gaps = {"mel_gap": float(np.sqrt(num / den))}
        judge = vocode_rows(voc, got)
        if len(judge) != len(got_wav):
            gaps["wav_gap"] = float("inf")
        else:
            n, d = _rel(got_wav, judge, judge)
            gaps["wav_gap"] = float(np.sqrt(n / max(d, 1.0)))
        if rows[0]["ref_frames"]:
            rf = rows[0]["ref_frames"]
            ref_mel = rows[0]["cond"]
            got_ref = (log_mel(_voice_wave(traffic, i), tf32=True).T if control
                       else caps[0]["mel"][:rf].numpy())
            n, d = _rel(np.exp(got_ref), np.exp(ref_mel), np.exp(ref_mel))
            gaps["ref_mel_gap"] = float(np.sqrt(n / d))
        for k, v in gaps.items():
            worst[k] = max(worst.get(k, 0.0), v)
        per.append({"request": i, "chunks": len(rows), "frames": [r["total"] for r in rows],
                    **gaps})
    if not per:
        problems.append("no checked request was answered")
    return {"numbers": worst, "problems": problems, "requests": per}
