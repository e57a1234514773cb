"""Diffusion Transformer backbone for F5-TTS flow matching (PyTorch).

Counterpart of the JAX package's ``models/dit.py`` in the unrolled
``block{i}`` layout. The text embedding is computed once per CFG branch by
the caller (``embed_text``) and passed in; ``forward_cfg`` runs the
conditional and unconditional rows as one doubled batch, the input
embedding included (one grouped-conv launch per conv for both rows).

``use_flash`` and ``attn_impl`` are the JAX package's attention switch
(``layers.resolve_attn_impl``); the default is the lanes kernels. Each
block's ``Attention`` builds the RoPE tables its choice takes.

Training calls ``forward`` with ``dropout_seeds``, one ``(attention, FFN)``
pair of ints per block; without them the pass is deterministic (the JAX
package's ``deterministic=True``). ``gradient_checkpointing`` recomputes
each block in the backward through ``torch.utils.checkpoint``; the seeds
are plain arguments, so the recomputation draws the same masks. The JAX
package's ``scan_blocks``, ``remat_policy`` and AOT layouts steer XLA and
have no counterpart here.

Under a mesh (``parallel/mesh.py``) :meth:`DiT.shard` keeps this rank's
slice of every block's attention and FFN projections (Megatron TP over the
model group) and :meth:`DiT.unshard` gathers them back; everything else
(AdaLN, the text and input embeddings with the conv position embedding,
``norm_out``, ``proj_out``) stays whole on every rank. ``batch0``, the
global index of the batch's first row, places a data rank's dropout masks.

What the DiT shares with E2's UNetT is :class:`~.backbone.Backbone`.

For int8 serving, ``quantize_dit_params`` swaps the six attention and FFN
projections of every block of any backbone for ``QDense`` after load;
``DiT(quant=mode)`` builds them so from the start, to load a tree that is
already quantized.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from oron_tts_tpu_torch.config import ModelConfig
from oron_tts_tpu_torch.models.backbone import Backbone
from oron_tts_tpu_torch.models.layers import (
    QUANT_MODES,
    AdaLayerNormFinal,
    DiTBlock,
    QDense,
    kv_lengths,
)
from oron_tts_tpu_torch.utils.weights import init_module_params


def dit_param_count(dim: int, depth: int, text_dim: int = 512,
                    mel_dim: int = 100, ff_mult: int = 4,
                    vocab_size: int = 65, conv_layers: int = 4) -> int:
    """Approximate DiT parameter count from config dims (Base ≈ 428M); the JAX
    package's ``utils/memory.py`` formula."""
    per_block = (4 + 2 * ff_mult + 6) * dim * dim  # qkvo + ffn + AdaLN
    text = vocab_size * text_dim + conv_layers * (
        7 * text_dim + 2 * 2 * text_dim * text_dim
    )
    input_embed = (2 * mel_dim + text_dim) * dim + 2 * dim * dim // 16 * 31
    final = dim * mel_dim + 2 * dim * dim + 256 * dim + dim * dim  # + time MLP
    return depth * per_block + text + input_embed + final


class DiT(Backbone):
    torch_layout = True  # utils/torch_compat.py converts the reference's checkpoints

    def __init__(
        self,
        dim: int = 1024,
        depth: int = 22,
        heads: int = 16,
        dim_head: int = 64,
        ff_mult: int = 4,
        mel_dim: int = 100,
        vocab_size: int = 65,
        text_dim: int = 512,
        conv_layers: int = 4,
        dropout: float = 0.1,
        gradient_checkpointing: bool = False,
        quant: str | None = None,
        use_flash: bool = True,
        attn_impl: str | None = None,
    ) -> None:
        super().__init__(dim, depth, heads, dim_head, ff_mult, mel_dim, vocab_size, text_dim,
                         conv_layers, dropout, gradient_checkpointing, quant)
        for i in range(depth):
            self.add_module(f"block{i}", DiTBlock(dim, heads, dim_head, ff_mult, dropout, quant,
                                                  use_flash, attn_impl))
        self.norm_out = AdaLayerNormFinal(dim)
        self.proj_out = nn.Linear(dim, mel_dim)

    @classmethod
    def param_count(cls, m: ModelConfig, n_mels: int) -> int:
        """:func:`dit_param_count`, the JAX package's count, which ``auto``'s choices rest on."""
        return dit_param_count(m.dim, m.depth, text_dim=m.text_dim, mel_dim=n_mels,
                               ff_mult=m.ff_mult, vocab_size=m.vocab_size,
                               conv_layers=m.conv_layers)

    def initial_params(self, seed: int = 0) -> dict[str, Any]:
        """The JAX package's initial scheme: flax's initialisers, with the AdaLN
        projections and ``proj_out`` all zero, so the model starts as the
        identity-gated stack the JAX package starts from."""
        return init_module_params(self, seed, zeroed=("attn_norm", "norm_out", "proj_out"))

    def _transformer(self, h, t, mask, t_mods=None, dropout_seeds=None, batch0=0):
        kv_lens = kv_lengths(mask, h.shape[0], h.shape[1], h.device)
        block_mods, final_mods = t_mods if t_mods is not None else (None, None)
        remat = self.gradient_checkpointing and torch.is_grad_enabled()
        for i, blk in enumerate(self.blocks):
            args = (h, t, mask, None if block_mods is None else block_mods[i],
                    kv_lens, None if dropout_seeds is None else dropout_seeds[i], batch0)
            h = checkpoint(blk, *args, use_reentrant=False) if remat else blk(*args)
        return self.proj_out(self.norm_out(h, t, mods=final_mods))

    def precompute_t_mods(self, t_emb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """AdaLN modulation tables for a whole timestep schedule.

        ``t_emb`` [S, dim] is ``embed_time`` over the step grid. Returns
        (block_mods [depth, S, 6·dim], final_mods [S, 2·dim]); at step i pass
        ``(block_mods[:, i], final_mods[i])`` as ``t_mods``.
        """
        act = torch.nn.functional.silu(t_emb)
        block_mods = torch.stack([blk.attn_norm.linear(act) for blk in self.blocks])
        return block_mods, self.norm_out.linear(act)


QUANT_TARGETS = frozenset({"to_q", "to_k", "to_v", "to_out", "in_proj", "out_proj"})


def quantize_dit_params(backbone: Backbone, mode: str = "int8") -> Backbone:
    """Swap the hot projections of every block of ``backbone`` for :class:`QDense`, in memory.

    The attention and FFN projections (``QUANT_TARGETS``; a DiT's AdaLN
    projections are hoisted out of the sampling loop instead,
    ``precompute_t_mods``) become int8 weights with one f32 scale per output
    channel; biases and everything else stay as they are. Checkpoints on disk
    are never quantized: this runs after load. A model that is already
    quantized only switches its mode (both modes read the same integers).
    """
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quant mode: {mode!r}")
    for parent in list(backbone.modules()):
        for name, child in list(parent.named_children()):
            if name not in QUANT_TARGETS:
                continue
            if isinstance(child, QDense):
                child.mode = mode
            elif isinstance(child, nn.Linear):
                setattr(parent, name, QDense.from_linear(child, mode))
    backbone.quant = mode
    return backbone
