"""Plain float32 E2 TTS backbone, F5-TTS's ``UNetT``: the architecture ``"UNetT"``.

A configuration whose ``model.backbone`` is ``"UNetT"`` is found here
(``portbench/reference/__init__.py`` holds the contract; its functions close
this file, with the FLOP count).

Written from the published architecture (E2 TTS, arXiv:2406.18009; SWivid/
F5-TTS ``src/f5_tts/model/backbones/unett.py`` under ``configs/
E2TTS_Base.yaml``) in plain ``torch`` operations over the served model's
state dict (``block{i}.skip_proj.weight`` ``[dim, 2·dim]``, ``block{i}.
attn_norm.weight``, ``norm_out.weight``, the DiT's names elsewhere). Every
product runs in float32 with TF32 off; nothing here imports the program. The
equations:

- text: ``Embedding(vocab + 1, n_mels)[ids + 1]``, cut or padded to T with 0,
  no masking of the padding (``text_mask_padding: False``, no conv blocks);
- ``h = proj(cat[x, cond, text])``, then the DiT's conv position embedding;
- the time embedding is prepended as a token (T + 1, the mask left-padded
  with True); RoPE (rotate-half, over the T + 1 positions) on the first
  ``pe_attn_head`` heads;
- blocks ``0 .. depth/2 − 1`` push their input; each later block first takes
  ``skip_proj(cat[h, pop()])``; every block ``h += Attn(RMSNorm(h))``, ``h +=
  FF(RMSNorm(h))``, RMSNorm the mean square (eps 1e-6) and a weight;
- the velocity is ``proj_out(RMSNorm(h)[:, 1:])``.

Upstream pairs RoPE's lanes as x_transformers does (adjacent lanes); the
program and this reference pair lane i with i + D/2 (the same rotation up to
a fixed permutation of each head's lanes). Both add the key bias on the
rotated heads alone: elsewhere it shifts a query's scores by a constant, which
softmax ignores, so its gradient is exactly zero rather than rounding noise. The repository's test copy,
``tests/plain_unett.py``, lists every departure; ``portbench/tests/
test_unett_reference.py`` holds this file to it.

``quant="fp8"`` is the control, as the DiT's: both operands of every matrix
product (the projections, ``skip_proj``, the attention's scores and its
weighted sum) rounded to float8 e4m3 with one scale a row.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import dit
from portbench.reference.layers import EPS, fp8_rows, gelu_tanh


class Params(dit.Params):
    """The state dict in float32 on one device; a projection may have no bias."""

    def __init__(self, state, heads: int, pe_attn_head: int | None, device="cpu",
                 quant: str | None = None) -> None:
        depth = sum(1 for k in state if k.endswith(".attn.to_q.weight"))
        skip = f"block{depth - 1}.skip_proj.weight"
        if skip not in state or any(k.startswith("text_embed.block") for k in state):
            raise LookupError(f"the program's state has no {skip} or has text conv blocks: "
                              "it built another backbone than the UNetT its configuration names")
        super().__init__(state, heads, device, quant)
        self.pe_attn_head = heads if pe_attn_head is None else pe_attn_head

    def linear(self, x: torch.Tensor, name: str) -> torch.Tensor:
        w, b = self.p[name + ".weight"], self.p.get(name + ".bias")
        y = (torch.matmul(fp8_rows(x), fp8_rows(w).t()) if self.quant == "fp8"
             else torch.matmul(x, w.t()))
        return y if b is None else y + b


def rms_norm(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt((x * x).mean(dim=-1, keepdim=True) + EPS) * weight


def attention(P: Params, pre: str, x, mask, cos, sin) -> torch.Tensor:
    B, T, _ = x.shape
    H, D, n = P.heads, P.dim_head, P.pe_attn_head
    b = P[f"{pre}.to_k.bias"]
    kb = torch.cat([b[:n * D], torch.zeros_like(b[n * D:])])  # inert on unrotated heads
    w = P[f"{pre}.to_k.weight"]
    k = (torch.matmul(fp8_rows(x), fp8_rows(w).t()) if P.quant == "fp8"
         else torch.matmul(x, w.t())) + kb
    q, k, v = (y.view(B, T, H, D).transpose(1, 2)
               for y in (P.linear(x, f"{pre}.to_q"), k, P.linear(x, f"{pre}.to_v")))
    q = torch.cat([dit._rotate(q[:, :n], cos, sin), q[:, n:]], dim=1)
    k = torch.cat([dit._rotate(k[:, :n], cos, sin), k[:, n:]], dim=1)
    if P.quant == "fp8":
        q, k = fp8_rows(q), fp8_rows(k)
    s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(D)
    s = s.masked_fill(~mask[:, None, None, :], -1e30)
    a = torch.softmax(s, dim=-1)
    if P.quant == "fp8":
        a, v = fp8_rows(a), fp8_rows(v.transpose(-1, -2)).transpose(-1, -2)
    o = torch.matmul(a, v).transpose(1, 2).reshape(B, T, H * D)
    return P.linear(o, f"{pre}.to_out") * mask[..., None]


def unett_forward(P: Params, x, cond, text_emb, t, mask, drop_audio=False,
                  dropout=None) -> torch.Tensor:
    """Velocity [B, T, n_mels]; ``dropout(i)`` gives block i's ``drop`` callable, whose
    tensors are ``[B, T + 1, ·]``."""
    if drop_audio:
        cond = torch.zeros_like(cond)
    h = dit.input_embedding(P, x, cond, text_emb, mask)
    h = torch.cat([dit.timestep_embedding(P, t)[:, None], h], dim=1)
    mask = F.pad(mask, (1, 0), value=True)
    cos, sin = dit.rope(h.shape[1], P.dim_head, h.device)
    skips = []
    for i in range(P.depth):
        pre = f"block{i}"
        drop = None if dropout is None else dropout(i)
        if i < P.depth // 2:
            skips.append(h)
        else:
            h = P.linear(torch.cat([h, skips.pop()], dim=-1), pre + ".skip_proj")
        a = attention(P, pre + ".attn", rms_norm(h, P[pre + ".attn_norm.weight"]), mask, cos, sin)
        if drop is not None:
            a = drop("attn", a) * mask[..., None]
        h = h + a
        f = gelu_tanh(P.linear(rms_norm(h, P[pre + ".ff_norm.weight"]), pre + ".ff.in_proj"))
        if drop is not None:
            f = drop("ff", f)
        h = h + P.linear(f, pre + ".ff.out_proj")
    return P.linear(rms_norm(h, P["norm_out.weight"])[:, 1:], "proj_out")


# ── the architecture's contract (portbench/reference/__init__.py) ─────────


def params(state: dict[str, torch.Tensor], cfg: dict, device="cpu",
           quant: str | None = None) -> Params:
    m = cfg["model"]
    return Params(state, m["heads"], m.get("pe_attn_head"), device, quant=quant)


def velocity(P: Params, x, cond, ids, t, mask, drop_audio: bool, drop_text: bool,
             dropout=None) -> torch.Tensor:
    """The character embedding of ``ids`` at ``x``'s length, then the UNetT's velocity."""
    te = dit.text_embedding(P, ids, x.shape[1], drop=drop_text)
    return unett_forward(P, x, cond, te, t, mask, drop_audio=drop_audio, dropout=dropout)


def dropout_pairs(cfg: dict) -> int:
    """One (attention, FFN) seed pair a block."""
    return cfg["model"]["depth"]


def weight_rule(key: str, shape: tuple[int, ...]) -> tuple[float, float] | None:
    """The final RMSNorm's weight, ``norm_out.weight``, as the blocks' norms: 1 + N(0, 0.02²)."""
    return (0.02, 1.0) if key == "norm_out.weight" and len(shape) == 1 else None


# ── model FLOPs (products only; elementwise work counts nothing) ──────────


def model_dims(cfg: dict) -> dict:
    m = cfg["model"]
    mel = cfg.get("n_mels", 100)
    return {"dim": m["dim"], "depth": m["depth"], "heads": m["heads"], "ff_mult": m["ff_mult"],
            "text_dim": m.get("text_dim") or mel, "mel_dim": mel}


def token_flops(m: dict) -> float:
    """Products of one of the T + 1 tokens through the blocks and the skip projections,
    attention's key loop aside."""
    dim, depth, ff = m["dim"], m["depth"], m["ff_mult"]
    block = 8 * dim * dim + 4 * dim * dim * ff
    return depth * block + depth // 2 * 2 * (2 * dim) * dim


def frame_flops(m: dict) -> float:
    """Products of one mel frame outside the blocks: the input projection, the conv
    position embedding's two grouped convs (k 31, 16 groups), the output projection."""
    dim, mel, td = m["dim"], m["mel_dim"], m["text_dim"]
    return 2 * (2 * mel + td) * dim + 2 * (2 * dim * (dim // 16) * 31) + 2 * dim * mel


def time_flops(m: dict) -> float:
    """The time embedding's MLP of one row: 256 → dim → dim."""
    return 2 * 256 * m["dim"] + 2 * m["dim"] * m["dim"]


def row_flops(m: dict, frames: int) -> float:
    """One forward of one row of ``frames`` kept frames, ``frames + 1`` tokens, each
    attending to the row's own tokens; the time MLP aside."""
    tokens = frames + 1
    attn = 4 * tokens * tokens * m["dim"] * m["depth"]
    return tokens * token_flops(m) + frames * frame_flops(m) + attn


def solve_flops(cfg: dict, row_frames: list[int], steps: int, guided: bool = True) -> float:
    """A CFG Euler solve: per step one forward of each row, two when guided; the time
    embedding once a step (hoisted over the schedule); the text lookup has no products."""
    m = model_dims(cfg)
    branches = 2 if guided else 1
    return branches * steps * sum(row_flops(m, n) for n in row_frames) + steps * time_flops(m)


def train_step_flops(cfg: dict, row_frames: list[int]) -> float:
    """One training step: 3 × the forward of each row at its kept frames, with its time
    embedding (no recomputation counted)."""
    m = model_dims(cfg)
    return 3.0 * sum(row_flops(m, n) + time_flops(m) for n in row_frames if n > 0)
