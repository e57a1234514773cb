"""F5-TTS's MMDiT backbone: SD3's two-stream joint-attention DiT over speech (PyTorch).

As F5-TTS publishes it (``src/f5_tts/model/backbones/mmdit.py``; the block is
Stable Diffusion 3's, arXiv:2403.03206). The audio stream is
``Linear(2·n_mels → dim)([x, cond])`` plus the DiT's convolutional position
embedding (:class:`~.backbone.InputEmbedding` without the text); the text
stream is its own, ``Embedding(ids + 1)`` at ``dim`` with sinusoidal positions,
zeroed at the padding (``text_mask_padding``; no ConvNeXt blocks). Both
are ``[B, T, dim]``: this system hands every backbone frame-rate text, each
clip's characters stretched over its mel frames.

Each block (:class:`MMDiTBlock`) modulates each stream with its own AdaLN-Zero
(``attn_norm_x``, ``attn_norm_c``), runs one attention over ``[text; audio]``
(:class:`~.layers.JointAttention`: per-stream projections and RoPE, every text
key admitted, so the key mask is the prefix ``T + len``), and gives each stream
its gated residual and its own FFN (``ff_x``, ``ff_c``). The last block is
"context pre-only": the text supplies keys and values alone, through
AdaLN-Zero-Final, and is then dropped. The output is ``proj_out(norm_out(x, t))``.

Dropout: block ``i`` takes seed pair ``i`` for its attention output and audio
FFN, and the FFN seed of pair ``depth + i`` for its text FFN (upstream drops no
text attention output, so that pair's first seed goes unused): ``2·depth − 1``
pairs a training forward (:attr:`MMDiT.dropout_pairs`). Under
``gradient_checkpointing`` each block is recomputed with both streams as inputs.
The sampler hoists both streams' AdaLN tables (:meth:`MMDiT.precompute_t_mods`).
Tensor parallelism is not built: :meth:`MMDiT.shard` at TP > 1 raises before
anything is sliced.

Tracing (``utils/trace.py``): span ``mmdit.joint`` (from ``JointAttention``)
around each block's concatenation of the streams and the split of its output;
counters ``mmdit.joint_tokens`` (``B·2T`` a forward) and ``mmdit.text_tokens``
(the text's non-padding positions a text embedding: one host read of the ids
while tracing is on).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from oron_tts_tpu_torch.config import ModelConfig
from oron_tts_tpu_torch.models.backbone import Backbone
from oron_tts_tpu_torch.models.layers import (
    AdaLayerNorm,
    AdaLayerNormFinal,
    FeedForward,
    JointAttention,
    kv_lengths,
)
from oron_tts_tpu_torch.ops.adaln import gate_residual, gate_residual_modulate
from oron_tts_tpu_torch.utils import trace
from oron_tts_tpu_torch.utils.weights import init_module_params


class MMDiTBlock(nn.Module):
    """Two AdaLN-Zero streams around one joint attention; ``context_pre_only``: the text
    gives keys and values only (AdaLN-Zero-Final, no ``to_out_c``, no text FFN)."""

    def __init__(self, dim: int, heads: int, dim_head: int = 64, ff_mult: int = 4,
                 dropout: float = 0.0, quant: str | None = None, use_flash: bool = True,
                 attn_impl: str | None = None, context_pre_only: bool = False) -> None:
        super().__init__()
        self.context_pre_only = context_pre_only
        self.attn_norm_c = AdaLayerNormFinal(dim) if context_pre_only else AdaLayerNorm(dim)
        self.attn_norm_x = AdaLayerNorm(dim)
        self.attn = JointAttention(dim, heads, dim_head, dropout, quant, use_flash, attn_impl,
                                   context_pre_only)
        if not context_pre_only:
            self.ff_c = FeedForward(dim, ff_mult, dropout, quant)
        self.ff_x = FeedForward(dim, ff_mult, dropout, quant)

    def forward(self, x, c, t, kv_lens, mask=None, key_mask=None, mods_x=None, mods_c=None,
                seeds=None, batch0=0):
        """``(x, c)`` after the block (``c`` None after the last); ``kv_lens`` and
        ``key_mask`` are the joint keys, ``seeds`` ``(attention, audio FFN, text FFN)``."""
        attn_seed, ffx_seed, ffc_seed = seeds if seeds is not None else (None, None, None)
        if self.context_pre_only:
            normed_c = self.attn_norm_c(c, t, mods=mods_c)
        else:
            normed_c, gate_c, shift_mlp_c, scale_mlp_c, gate_mlp_c = self.attn_norm_c(
                c, t, mods=mods_c)
        normed_x, gate_x, shift_mlp_x, scale_mlp_x, gate_mlp_x = self.attn_norm_x(
            x, t, mods=mods_x)
        y_x, y_c = self.attn(normed_x, normed_c, kv_lens, mask=mask, key_mask=key_mask,
                             seed=attn_seed, batch0=batch0)
        if self.context_pre_only:
            c = None
        else:
            c, ff_in = gate_residual_modulate(c, y_c, gate_c, scale_mlp_c, shift_mlp_c)
            c = gate_residual(c, self.ff_c(ff_in, seed=ffc_seed, batch0=batch0), gate_mlp_c)
        x, ff_in = gate_residual_modulate(x, y_x, gate_x, scale_mlp_x, shift_mlp_x)
        return gate_residual(x, self.ff_x(ff_in, seed=ffx_seed, batch0=batch0), gate_mlp_x), c


class MMDiT(Backbone):
    config_fields = ("text_mask_padding",)
    text_stream = True

    def __init__(
        self,
        dim: int = 1024,
        depth: int = 16,
        heads: int = 16,
        dim_head: int = 64,
        ff_mult: int = 4,
        mel_dim: int = 100,
        vocab_size: int = 65,
        text_dim: int | None = None,
        conv_layers: int = 0,
        text_mask_padding: bool = True,
        dropout: float = 0.1,
        gradient_checkpointing: bool = False,
        quant: str | None = None,
        use_flash: bool = True,
        attn_impl: str | None = None,
    ) -> None:
        if text_dim not in (None, dim):
            raise ValueError(f"the MMDiT's text stream is at the model width {dim}, "
                             f"got text_dim {text_dim}")
        if conv_layers:
            raise ValueError("the MMDiT's text embedding has no conv blocks: conv_layers 0")
        if not text_mask_padding:
            raise ValueError("the MMDiT's text stream zeroes its padding: "
                             "text_mask_padding False is not built")
        if depth < 1:
            raise ValueError(f"the MMDiT needs a block, got depth {depth}")
        super().__init__(dim, depth, heads, dim_head, ff_mult, mel_dim, vocab_size, dim, 0,
                         dropout, gradient_checkpointing, quant)
        for i in range(depth):
            self.add_module(f"block{i}", MMDiTBlock(dim, heads, dim_head, ff_mult, dropout, quant,
                                                    use_flash, attn_impl, i == depth - 1))
        self.norm_out = AdaLayerNormFinal(dim)
        self.proj_out = nn.Linear(dim, mel_dim)

    @classmethod
    def activation_depth(cls, m: ModelConfig) -> int:
        """Two streams a block."""
        return 2 * m.depth

    @property
    def dropout_pairs(self) -> int:
        """A pair a block, and one more a block but the last for its text FFN."""
        return 2 * self.depth - 1

    def shard(self, mesh) -> None:
        if mesh.n_model > 1:
            raise NotImplementedError("the MMDiT has no tensor-parallel split; use TP 1")
        super().shard(mesh)

    def initial_params(self, seed: int = 0) -> dict[str, Any]:
        """Flax's initialisers, with both streams' AdaLN projections, ``norm_out`` and
        ``proj_out`` zero, as upstream's ``initialize_weights``."""
        return init_module_params(
            self, seed, zeroed=("attn_norm_x", "attn_norm_c", "norm_out", "proj_out"))

    def embed_text(self, text_ids: torch.Tensor, seq_len: int, drop_text: bool = False):
        if trace.enabled():
            trace.count("mmdit.text_tokens", int((text_ids[:, :seq_len] >= 0).sum()))
        return super().embed_text(text_ids, seq_len, drop_text=drop_text)

    def _transformer(self, h, t, mask, t_mods=None, dropout_seeds=None, batch0=0):
        x, c = h
        B, T, _ = x.shape
        kv_lens = T + kv_lengths(mask, B, T, x.device)
        key_mask = None if mask is None else F.pad(mask, (T, 0), value=True)
        if trace.enabled():
            trace.count("mmdit.joint_tokens", B * 2 * T)
        mods_x, mods_c, mods_c_last, final_mods = (
            t_mods if t_mods is not None else (None, None, None, None))
        remat = self.gradient_checkpointing and torch.is_grad_enabled()
        last = self.depth - 1
        for i, blk in enumerate(self.blocks):
            seeds = None
            if dropout_seeds is not None:
                seeds = (*dropout_seeds[i], None if i == last else dropout_seeds[self.depth + i][1])
            mc = mods_c_last if i == last else (None if mods_c is None else mods_c[i])
            args = (x, c, t, kv_lens, mask, key_mask, None if mods_x is None else mods_x[i], mc,
                    seeds, batch0)
            x, c = checkpoint(blk, *args, use_reentrant=False) if remat else blk(*args)
        return self.proj_out(self.norm_out(x, t, mods=final_mods))

    def precompute_t_mods(self, t_emb: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """Both streams' AdaLN tables for a whole timestep schedule.

        ``t_emb`` [S, dim] is ``embed_time`` over the step grid. Returns (audio
        ``[depth, S, 6·dim]``, text ``[depth − 1, S, 6·dim]``, the last block's text
        ``[S, 2·dim]``, ``norm_out``'s ``[S, 2·dim]``); at step i pass each with its
        second-last axis taken as ``t_mods``.
        """
        act = F.silu(t_emb)
        blocks = self.blocks
        mods_c = [blk.attn_norm_c.linear(act) for blk in blocks[:-1]]
        return (torch.stack([blk.attn_norm_x.linear(act) for blk in blocks]),
                torch.stack(mods_c) if mods_c else act.new_zeros(0, *act.shape[:-1], 6 * self.dim),
                blocks[-1].attn_norm_c.linear(act), self.norm_out.linear(act))
