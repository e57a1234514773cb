"""Weights in the JAX package's flax layout, and their PyTorch state dicts.

The port names its submodules after the flax parameter tree
(``block{i}.attn.to_q``, ``input_embed.conv_pos_embed.conv1``, …), so one
rename carries both the DiT and the vocoder across:

- dense ``kernel`` [in, out]   → ``weight`` [out, in] (``nn.Linear``)
- conv ``kernel`` [K, cin/g, C] → ``weight`` in the same layout (the port's
  convs, the grouped-conv kernel included, read it as the JAX package does)
- ``embedding`` and LayerNorm ``scale`` → ``weight``; everything else keeps
  its name and shape.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Any

import numpy as np
import torch

from oron_tts_tpu_torch.config import ModelConfig


def load_npz_tree(path: str | Path) -> dict[str, Any]:
    """Flat ``params/<a>/<b>/...`` npz (the JAX checkpoint format) → nested dict.

    bf16 leaves (listed in the ``__meta__`` record, or stored as 2-byte
    voids) are widened to float32 without ml_dtypes.
    """
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    raw_meta = flat.pop("__meta__", None)
    meta = json.loads(raw_meta.tobytes().decode()) if raw_meta is not None else {}
    bf16 = set(meta.get("__bf16__", []))
    tree: dict[str, Any] = {}
    for key, value in flat.items():
        if key in bf16 or (value.dtype.kind == "V" and value.dtype.itemsize == 2):
            value = (value.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def from_flax_params(tree: dict[str, Any]) -> dict[str, torch.Tensor]:
    """Flax parameter tree (numpy leaves) → float32 state dict for the port."""
    out: dict[str, torch.Tensor] = {}

    def walk(node: dict[str, Any], prefix: str) -> None:
        for name, value in node.items():
            if isinstance(value, dict):
                walk(value, f"{prefix}{name}.")
                continue
            arr = np.asarray(value, dtype=np.float32)
            if name == "kernel":
                name = "weight"
                if arr.ndim == 2:
                    arr = arr.T
            elif name in ("embedding", "scale"):
                name = "weight"
            out[prefix + name] = torch.from_numpy(np.ascontiguousarray(arr))

    walk(tree, "")
    return out


def to_flax_params(state: dict[str, torch.Tensor]) -> dict[str, Any]:
    """The inverse of :func:`from_flax_params`: state dict → flax tree (numpy f32).

    ``weight`` becomes ``kernel`` (2-D transposed back, 3-D conv weights as
    they are), ``embedding`` under a module named ``embed``, or ``scale``
    (1-D, a LayerNorm's).
    """
    tree: dict[str, Any] = {}
    for key, value in state.items():
        *parents, leaf = key.split(".")
        arr = value.detach().to(device="cpu", dtype=torch.float32).numpy()
        if leaf == "weight":
            if arr.ndim == 2 and parents and parents[-1] == "embed":
                leaf = "embedding"
            elif arr.ndim >= 2:
                leaf = "kernel"
                if arr.ndim == 2:
                    arr = arr.T
            else:
                leaf = "scale"
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree


def init_dit_params(config: ModelConfig, n_mels: int = 100, seed: int = 0) -> dict[str, Any]:
    """A fresh DiT tree under the JAX package's initial scheme.

    Dense and conv kernels LeCun-normal (truncated at ±2σ, variance
    1/fan_in), embeddings N(0, 1/dim), biases and GRN 0, LayerNorm scales 1,
    and the AdaLN projections and ``proj_out`` all zero, so the model starts
    as the identity-gated stack the JAX package starts from. The scheme is
    the same; the random stream is numpy's, not ``jax.random``'s.
    """
    rng = np.random.default_rng(seed)
    zeroed = ("attn_norm", "norm_out", "proj_out")

    def trunc_normal(shape: tuple[int, ...], std: float) -> np.ndarray:
        out = rng.standard_normal(shape, dtype=np.float32)
        bad = np.abs(out) > 2.0
        while bad.any():
            out[bad] = rng.standard_normal(int(bad.sum()), dtype=np.float32)
            bad = np.abs(out) > 2.0
        return out * np.float32(std / 0.87962566103423978)

    def redraw(node: dict[str, Any], path: tuple[str, ...]) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for name, value in node.items():
            if isinstance(value, dict):
                out[name] = redraw(value, path + (name,))
            elif any(z in path for z in zeroed) or name in ("bias", "gamma", "beta"):
                out[name] = np.zeros(value.shape, np.float32)
            elif name == "scale":
                out[name] = np.ones(value.shape, np.float32)
            elif name == "embedding":
                out[name] = rng.standard_normal(value.shape, dtype=np.float32) / np.float32(
                    math.sqrt(value.shape[-1]))
            else:  # kernel: fan_in is every axis but the last
                out[name] = trunc_normal(value.shape, 1.0 / math.sqrt(math.prod(value.shape[:-1])))
        return out

    return redraw(seeded_dit_params(config, n_mels, seed), ())


def seeded_dit_params(
    config: ModelConfig, n_mels: int = 100, seed: int = 0
) -> dict[str, Any]:
    """A full DiT parameter tree in the flax layout, every tensor non-zero.

    The JAX package zero-initialises the AdaLN projections and ``proj_out``;
    with those zeros the velocity is 0 and no kernel output reaches the mel,
    so a smoke run on random weights would prove nothing. Here dense and
    conv kernels are N(0, 1/fan_in) (AdaLN projections ×0.1, to keep 22
    modulated blocks tame), biases and GRN N(0, 0.02²), LayerNorm scales
    1 + N(0, 0.02²), embeddings N(0, 1).
    """
    rng = np.random.default_rng(seed)

    def normal(shape: tuple[int, ...], std: float, mean: float = 0.0) -> np.ndarray:
        return (rng.standard_normal(shape, dtype=np.float32) * std + mean).astype(
            np.float32
        )

    def dense(fan_in: int, fan_out: int, gain: float = 1.0) -> dict[str, np.ndarray]:
        return {
            "kernel": normal((fan_in, fan_out), gain / math.sqrt(fan_in)),
            "bias": normal((fan_out,), 0.02),
        }

    def conv(k: int, cin_g: int, chans: int) -> dict[str, np.ndarray]:
        return {
            "kernel": normal((k, cin_g, chans), 1.0 / math.sqrt(k * cin_g)),
            "bias": normal((chans,), 0.02),
        }

    def layer_norm(dim: int) -> dict[str, np.ndarray]:
        return {"scale": normal((dim,), 0.02, 1.0), "bias": normal((dim,), 0.02)}

    dim, td = config.dim, config.text_dim
    inner = config.heads * config.dim_head
    groups = 16
    text_embed: dict[str, Any] = {
        "embed": {"embedding": normal((config.vocab_size + 1, td), 1.0)}
    }
    for i in range(config.conv_layers):
        text_embed[f"block{i}"] = {
            "dwconv": conv(7, 1, td),
            "norm": layer_norm(td),
            "pwconv1": dense(td, 2 * td),
            "grn": {
                "gamma": normal((1, 1, 2 * td), 0.02),
                "beta": normal((1, 1, 2 * td), 0.02),
            },
            "pwconv2": dense(2 * td, td),
        }
    params: dict[str, Any] = {
        "time_embed": {"mlp_in": dense(256, dim), "mlp_out": dense(dim, dim)},
        "text_embed": text_embed,
        "input_embed": {
            "proj": dense(2 * n_mels + td, dim),
            "conv_pos_embed": {
                "conv1": conv(31, dim // groups, dim),
                "conv2": conv(31, dim // groups, dim),
            },
        },
    }
    for i in range(config.depth):
        params[f"block{i}"] = {
            "attn_norm": {"linear": dense(dim, 6 * dim, gain=0.1)},
            "attn": {
                "to_q": dense(dim, inner),
                "to_k": dense(dim, inner),
                "to_v": dense(dim, inner),
                "to_out": dense(inner, dim),
            },
            "ff": {
                "in_proj": dense(dim, dim * config.ff_mult),
                "out_proj": dense(dim * config.ff_mult, dim),
            },
        }
    params["norm_out"] = {"linear": dense(dim, 2 * dim, gain=0.1)}
    params["proj_out"] = dense(dim, n_mels)
    return params
