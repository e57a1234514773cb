"""E2 TTS's backbone, the flat U-Net transformer ``UNetT`` (PyTorch).

E2 TTS (arXiv:2406.18009), as F5-TTS publishes it
(``src/f5_tts/model/backbones/unett.py``, ``configs/E2TTS_Base.yaml``): the
text is a plain character embedding at the mel width, concatenated with the
noised mel and the masked conditioning, projected to ``dim`` and given the
DiT's convolutional position embedding (:class:`~.backbone.InputEmbedding`). The
time embedding is prepended as one more token, so the blocks run over
``T + 1`` positions, the mask left-padded with True (the lanes kernels take
``kv_lens = mask.sum + 1``). Each block is pre-RMSNorm attention and FFN
with no AdaLN; blocks ``0 .. depth/2 − 1`` push their input onto a stack,
and each later block first pops the stack and projects ``[h, skip]`` from
``2·dim`` back to ``dim`` (``skip_proj``, no bias). RoPE runs over the
``T + 1`` positions on the first ``pe_attn_head`` heads only, in the port's
rotate-half convention (F5-TTS takes x_transformers', which pairs adjacent
lanes: the same rotation up to a fixed permutation of each head's lanes).
The output is ``proj_out(RMSNorm(h)[:, 1:])``.

The interface is the DiT's (:class:`~.backbone.Backbone`: ``forward``,
``forward_cfg``, ``embed_text``, ``embed_time``, ``depth``, ``shard``/
``unshard``), and so are the attention and FFN modules, the kernels and the
dropout: a block's masks sit at row ``batch0 · (T + 1)``. Under
``gradient_checkpointing`` a later block is recomputed with its popped skip
as an input. :meth:`UNetT.shard` splits attention and FFN as the DiT's does;
``skip_proj`` and the norms stay whole (``parallel/mesh.py``'s default), and
head 0 is rotated on the rank that holds it (each ``Attention`` sizes its RoPE
tables for the heads it rotates). With no AdaLN, the sampler hoists only the
time embedding (:meth:`UNetT.precompute_t_mods`).

Tracing (``utils/trace.py``): span ``unett.skip`` around each later block's
concatenation and ``skip_proj``; counters ``unett.tokens`` (``B·(T + 1)`` a
forward) and ``unett.skip_bytes`` (the skip stack's bytes at its deepest, a
forward).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from oron_tts_tpu_torch.models.backbone import Backbone
from oron_tts_tpu_torch.models.layers import Attention, FeedForward, RMSNorm, kv_lengths
from oron_tts_tpu_torch.utils import trace


class UNetTBlock(nn.Module):
    """``[skip_proj(cat[h, skip])]``, then ``h + Attn(RMSNorm(h))`` and ``h + FF(RMSNorm(h))``."""

    def __init__(self, dim: int, heads: int, dim_head: int = 64, ff_mult: int = 4,
                 dropout: float = 0.0, quant: str | None = None, use_flash: bool = True,
                 attn_impl: str | None = None, pe_attn_head: int | None = None,
                 skip: bool = False) -> None:
        super().__init__()
        self.skip_proj = nn.Linear(2 * dim, dim, bias=False) if skip else None
        self.attn_norm = RMSNorm(dim)
        self.attn = Attention(dim, heads, dim_head, dropout, quant, use_flash, attn_impl,
                              pe_attn_head=pe_attn_head)
        self.ff_norm = RMSNorm(dim)
        self.ff = FeedForward(dim, ff_mult, dropout, quant)

    def shard(self, tp) -> None:
        self.attn.shard(tp)
        self.ff.shard(tp)

    def unshard(self) -> None:
        self.attn.unshard()
        self.ff.unshard()

    def forward(self, x, skip=None, mask=None, kv_lens=None, seeds=None, batch0=0):
        if skip is not None:
            with trace.span("unett.skip"):
                x = self.skip_proj(torch.cat([x, skip], dim=-1))
        attn_seed, ff_seed = seeds if seeds is not None else (None, None)
        x = x + self.attn(self.attn_norm(x), mask=mask, kv_lens=kv_lens, seed=attn_seed,
                          batch0=batch0)
        return x + self.ff(self.ff_norm(x), seed=ff_seed, batch0=batch0)


class UNetT(Backbone):
    config_fields = ("text_mask_padding", "pe_attn_head")

    def __init__(
        self,
        dim: int = 1024,
        depth: int = 24,
        heads: int = 16,
        dim_head: int = 64,
        ff_mult: int = 4,
        mel_dim: int = 100,
        vocab_size: int = 65,
        text_dim: int | None = None,
        conv_layers: int = 0,
        text_mask_padding: bool = True,
        pe_attn_head: int | None = None,
        dropout: float = 0.1,
        gradient_checkpointing: bool = False,
        quant: str | None = None,
        use_flash: bool = True,
        attn_impl: str | None = None,
    ) -> None:
        if depth % 2:
            raise ValueError(f"UNetT's depth must be even, got {depth}")
        if conv_layers and not text_mask_padding:
            raise ValueError("text conv blocks re-zero the text padding here: "
                             "text_mask_padding False needs conv_layers 0")
        super().__init__(dim, depth, heads, dim_head, ff_mult, mel_dim, vocab_size,
                         mel_dim if text_dim is None else text_dim, conv_layers, dropout,
                         gradient_checkpointing, quant)
        for i in range(depth):
            self.add_module(f"block{i}", UNetTBlock(
                dim, heads, dim_head, ff_mult, dropout, quant, use_flash, attn_impl,
                pe_attn_head, skip=i >= depth // 2))
        self.norm_out = RMSNorm(dim)
        self.proj_out = nn.Linear(dim, mel_dim)

    def _transformer(self, h, t, mask, t_mods=None, dropout_seeds=None, batch0=0):
        B, T, _ = h.shape
        if t is None:  # the hoisted time embedding of this step
            t = t_mods[0].expand(B, -1)
        h = torch.cat([t[:, None].to(h.dtype), h], dim=1)
        T1 = T + 1
        mask = None if mask is None else F.pad(mask, (1, 0), value=True)
        kv_lens = kv_lengths(mask, B, T1, h.device)
        if trace.enabled():
            trace.count("unett.tokens", B * T1)
            trace.count("unett.skip_bytes", self.depth // 2 * h.numel() * h.element_size())
        remat = self.gradient_checkpointing and torch.is_grad_enabled()
        half, skips = self.depth // 2, []
        for i, blk in enumerate(self.blocks):
            skip = skips.pop() if i >= half else None
            if i < half:
                skips.append(h)
            args = (h, skip, mask, kv_lens,
                    None if dropout_seeds is None else dropout_seeds[i], batch0)
            h = checkpoint(blk, *args, use_reentrant=False) if remat else blk(*args)
        return self.proj_out(self.norm_out(h)[:, 1:])

    def precompute_t_mods(self, t_emb: torch.Tensor) -> tuple[torch.Tensor]:
        """No AdaLN: the hoisted tables are the time embedding ``[S, dim]`` alone."""
        return (t_emb,)
