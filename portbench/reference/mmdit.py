"""Plain float32 MMDiT, F5-TTS's two-stream joint-attention backbone: the architecture
``"MMDiT"``.

A configuration whose ``model.backbone`` is ``"MMDiT"`` is found here
(``portbench/reference/__init__.py`` holds the contract; its functions close
this file, with the FLOP count).

Written from the published architecture (SWivid/F5-TTS ``src/f5_tts/model/
backbones/mmdit.py``; the block is Stable Diffusion 3's, arXiv:2403.03206) in
plain ``torch`` operations over the served model's state dict
(``block{i}.attn_norm_x.linear``, ``block{i}.attn_norm_c.linear``,
``block{i}.attn.to_q_c`` … ``to_out_c``, ``block{i}.ff_x``, ``block{i}.ff_c``,
``input_embed.proj`` ``[dim, 2·n_mels]``). Every product runs in float32 with
TF32 off; nothing here imports the program. The equations (``mod(h, sc, sh) =
LN(h)·(1 + sc) + sh``, LN without scale or bias, eps 1e-6; ``e`` the time
embedding):

- audio ``x = proj([x_t, cond])`` plus the DiT's conv position embedding;
  text ``c = Embedding(ids + 1) + sinusoid(position)`` at ``dim``, zeroed at the
  padding (``text_mask_padding: true``), the ids cut or padded to T;
- block i < depth − 1: each stream's ``chunk₆(W·SiLU(e))``; one attention over
  ``[mod(c); mod(x)]``, RoPE on each stream over its own positions, every text
  key admitted and audio keys past the row's length masked; ``x += g₁·Drop(W_out
  A_x)`` (padded rows zeroed), ``x += g₂·FF_x(mod(x))``; ``c += g₁ᶜ·W_outᶜ A_c``,
  ``c += g₂ᶜ·FF_c(mod(c))``;
- the last block: the text through ``chunk₂`` (AdaLN-Zero-Final) gives keys and
  values only; its queries reach no output and are left out;
- the velocity is ``proj_out(mod(x, chunk₂(W_out·SiLU(e))))``.

The text is frame-rate (each clip's characters stretched over its mel
frames, this system's text path), as long as the audio, where upstream feeds
one token a character. RoPE pairs lane i with i + D/2 (upstream: adjacent lanes,
the same rotation up to a fixed permutation of each head's lanes). The
repository's test copy, ``tests/plain_mmdit.py``, lists every departure;
``portbench/tests/test_mmdit_reference.py`` holds this file to it.

Dropout: block i's attention and audio FFN take seed pair i, its text FFN the
FFN seed of pair ``depth + i`` (``dropout_pairs``: ``2·depth − 1``).

``quant="fp8"`` is the control, as the DiT's: both operands of every matrix
product (the projections, the attention's scores and its weighted sum) rounded to
float8 e4m3 with one scale a row.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import dit
from portbench.reference.layers import conv1d_same, fp8_rows, gelu_tanh, layer_norm, mish, silu


class Params(dit.Params):
    """The state dict in float32 on one device; checks that it is an MMDiT's."""

    def __init__(self, state, heads: int, device="cpu", quant: str | None = None) -> None:
        if "block0.attn.to_k_c.weight" not in state:
            raise LookupError("the program's state has no block0.attn.to_k_c.weight: it built "
                              "another backbone than the MMDiT its configuration names")
        super().__init__(state, heads, device, quant)


def modulate(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    return layer_norm(x) * (1 + scale[:, None]) + shift[:, None]


def text_embedding(P: Params, ids: torch.Tensor, length: int, drop: bool) -> torch.Tensor:
    """[B, Nt] ids (−1 pads) → [B, length, dim]: the lookup, positions, padding zeroed."""
    shifted = ids.long() + 1
    nt = shifted.shape[1]
    shifted = (shifted[:, :length] if nt >= length
               else torch.nn.functional.pad(shifted, (0, length - nt)))
    keep = (shifted != 0)[..., None]
    if drop:
        shifted = torch.zeros_like(shifted)
    emb = P["text_embed.embed.weight"][shifted]
    return (emb + dit.text_positions(emb.shape[-1], length, emb.device)[None]) * keep


def audio_embedding(P: Params, x, cond, mask) -> torch.Tensor:
    h = P.linear(torch.cat([x, cond], dim=-1), "input_embed.proj")
    keep = mask[..., None].float()
    y = h * keep
    for c in ("conv1", "conv2"):
        pre = "input_embed.conv_pos_embed." + c
        y = mish(conv1d_same(y, P[pre + ".weight"], P[pre + ".bias"], groups=16)) * keep
    return y + h


def joint_attention(P: Params, pre: str, x, c, mask, cos, sin, pre_only: bool):
    """``(A_x, A_c)`` ``[B, T, H·D]`` before the output projections, the attention over
    ``[c; x]``; ``A_c`` None where the text gives keys and values only."""
    B, T, _ = x.shape
    H, D = P.heads, P.dim_head

    def project(h, name, rotated=True):
        y = P.linear(h, f"{pre}.{name}").view(B, T, H, D).transpose(1, 2)
        return dit._rotate(y, cos, sin) if rotated else y

    k = torch.cat([project(c, "to_k_c"), project(x, "to_k")], dim=2)
    v = torch.cat([project(c, "to_v_c", False), project(x, "to_v", False)], dim=2)
    qx = project(x, "to_q")
    q = qx if pre_only else torch.cat([project(c, "to_q_c"), qx], dim=2)
    keys = torch.cat([torch.ones_like(mask), mask], dim=1)
    if P.quant == "fp8":
        q, k = fp8_rows(q), fp8_rows(k)
    s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(D)
    s = s.masked_fill(~keys[:, None, None, :], -1e30)
    a = torch.softmax(s, dim=-1)
    if P.quant == "fp8":
        a, v = fp8_rows(a), fp8_rows(v.transpose(-1, -2)).transpose(-1, -2)
    o = torch.matmul(a, v).transpose(1, 2).reshape(B, q.shape[2], H * D)
    return (o, None) if pre_only else (o[:, T:], o[:, :T])


def mmdit_forward(P: Params, x, cond, text_emb, t, mask, drop_audio=False,
                  dropout=None) -> torch.Tensor:
    """Velocity [B, T, n_mels]; ``dropout(i)`` gives seed pair i's ``drop`` callable."""
    if drop_audio:
        cond = torch.zeros_like(cond)
    e = silu(dit.timestep_embedding(P, t))
    x = audio_embedding(P, x, cond, mask)
    c = text_emb
    cos, sin = dit.rope(x.shape[1], P.dim_head, x.device)
    keep = mask[..., None].float()
    for i in range(P.depth):
        pre, last = f"block{i}", i == P.depth - 1
        mx = torch.chunk(P.linear(e, pre + ".attn_norm_x.linear"), 6, dim=-1)
        mc = torch.chunk(P.linear(e, pre + ".attn_norm_c.linear"), 2 if last else 6, dim=-1)
        c_hat = modulate(c, mc[0], mc[1]) if last else modulate(c, mc[1], mc[0])
        a_x, a_c = joint_attention(P, pre + ".attn", modulate(x, mx[1], mx[0]), c_hat, mask,
                                   cos, sin, last)
        y = P.linear(a_x, pre + ".attn.to_out")
        if dropout is not None:
            y = dropout(i)("attn", y)
        x = x + mx[2][:, None] * (y * keep)
        f = gelu_tanh(P.linear(modulate(x, mx[4], mx[3]), pre + ".ff_x.in_proj"))
        if dropout is not None:
            f = dropout(i)("ff", f)
        x = x + mx[5][:, None] * P.linear(f, pre + ".ff_x.out_proj")
        if last:
            break
        c = c + mc[2][:, None] * P.linear(a_c, pre + ".attn.to_out_c")
        f = gelu_tanh(P.linear(modulate(c, mc[4], mc[3]), pre + ".ff_c.in_proj"))
        if dropout is not None:
            f = dropout(P.depth + i)("ff", f)
        c = c + mc[5][:, None] * P.linear(f, pre + ".ff_c.out_proj")
    scale, shift = torch.chunk(P.linear(e, "norm_out.linear"), 2, dim=-1)
    return P.linear(modulate(x, scale, shift), "proj_out")


# ── the architecture's contract (portbench/reference/__init__.py) ─────────


def params(state: dict[str, torch.Tensor], cfg: dict, device="cpu",
           quant: str | None = None) -> Params:
    return Params(state, cfg["model"]["heads"], device, quant=quant)


def velocity(P: Params, x, cond, ids, t, mask, drop_audio: bool, drop_text: bool,
             dropout=None) -> torch.Tensor:
    """The text stream of ``ids`` at ``x``'s length, then the MMDiT's velocity."""
    te = text_embedding(P, ids.to(x.device), x.shape[1], drop=drop_text)
    return mmdit_forward(P, x, cond, te, t, mask, drop_audio=drop_audio, dropout=dropout)


def dropout_pairs(cfg: dict) -> int:
    """A pair a block, and one more a block but the last (its text FFN)."""
    return 2 * cfg["model"]["depth"] - 1


# ── model FLOPs (products only; elementwise work counts nothing) ──────────


def model_dims(cfg: dict) -> dict:
    m = cfg["model"]
    return {"dim": m["dim"], "depth": m["depth"], "heads": m["heads"], "ff_mult": m["ff_mult"],
            "mel_dim": cfg.get("n_mels", 100)}


def token_flops(m: dict) -> float:
    """Products of one frame of both streams through the blocks, attention's key loop
    aside: q, k, v, out and the FFN a stream a block, but the last block's text, which
    has k and v alone."""
    dim, depth, ff = m["dim"], m["depth"], m["ff_mult"]
    stream = 8 * dim * dim + 4 * dim * dim * ff
    return (2 * depth - 1) * stream + 4 * dim * dim


def frame_flops(m: dict) -> float:
    """Products of one mel frame outside the blocks: the audio projection, the conv
    position embedding's two grouped convs (k 31, 16 groups), the output projection."""
    dim, mel = m["dim"], m["mel_dim"]
    return 2 * (2 * mel) * dim + 2 * (2 * dim * (dim // 16) * 31) + 2 * dim * mel


def row_flops(m: dict, frames: int) -> float:
    """One forward of one row of ``frames`` kept frames in each stream. The joint
    attention runs 2n queries over 2n keys a block, the last block's n audio queries
    over 2n keys."""
    n, dim, depth = frames, m["dim"], m["depth"]
    attn = 4 * dim * ((depth - 1) * (2 * n) * (2 * n) + n * (2 * n))
    return n * (token_flops(m) + frame_flops(m)) + attn


def row_mod_flops(m: dict) -> float:
    """One row's AdaLN projections and time MLP: six chunks a stream a block (two for the
    last block's text), ``norm_out``'s two, and 256 → dim → dim."""
    dim, depth = m["dim"], m["depth"]
    adaln = (2 * depth - 1) * 2 * dim * 6 * dim + 2 * dim * 2 * dim + 2 * dim * 2 * dim
    return adaln + 2 * 256 * dim + 2 * dim * dim


def solve_flops(cfg: dict, row_frames: list[int], steps: int, guided: bool = True) -> float:
    """A CFG Euler solve: per step one forward of each row, two when guided; the AdaLN
    tables and the time MLP once a step (hoisted over the schedule); the text lookup
    has no products."""
    m = model_dims(cfg)
    branches = 2 if guided else 1
    return branches * steps * sum(row_flops(m, n) for n in row_frames) + steps * row_mod_flops(m)


def train_step_flops(cfg: dict, row_frames: list[int]) -> float:
    """One training step: 3 × the forward of each row at its kept frames, each stream
    ``n`` long, with each row's AdaLN projections and time MLP (no recomputation
    counted)."""
    m = model_dims(cfg)
    return 3.0 * sum(row_flops(m, n) + row_mod_flops(m) for n in row_frames if n > 0)
