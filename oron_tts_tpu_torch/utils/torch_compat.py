"""The reference's torch checkpoint layout ↔ the flax parameter tree.

Counterpart of the JAX package's ``utils/torch_compat.py``. The reference
F5-TTS names its DiT after torch modules (``transformer_blocks.{i}.attn.to_q``,
``text_embed.text_blocks.{i}.dwconv``, ``cfm.backbone.*`` at the F5TTS level);
the flax tree, which both packages load (``utils/weights.py``
``from_flax_params``), names the same tensors ``block{i}/attn/to_q``:

- torch Linear weight [out, in]  ↔ flax Dense kernel [in, out] (transposed)
- torch Conv1d weight [out, in/g, k] ↔ flax Conv kernel [k, in/g, out]
- Embedding, LayerNorm and GRN tensors keep their shapes.

Values are numpy arrays (bf16 widened to f32). ``.safetensors`` files are read
and written here (``load_safetensors``, ``save_safetensors``), without the
``safetensors`` package.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

_ORIG_MOD = "._orig_mod."


def _np(value: Any) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:
            value = value.float()
        return value.numpy()
    return np.asarray(value)


def _linear(sd: Mapping[str, Any], key: str) -> dict[str, np.ndarray]:
    return {"kernel": _np(sd[f"{key}.weight"]).T, "bias": _np(sd[f"{key}.bias"])}


def _conv1d(sd: Mapping[str, Any], key: str) -> dict[str, np.ndarray]:
    return {"kernel": _np(sd[f"{key}.weight"]).transpose(2, 1, 0),
            "bias": _np(sd[f"{key}.bias"])}


def _layernorm(sd: Mapping[str, Any], key: str) -> dict[str, np.ndarray]:
    return {"scale": _np(sd[f"{key}.weight"]), "bias": _np(sd[f"{key}.bias"])}


def strip_compiled_prefix(state_dict: Mapping[str, Any]) -> dict[str, Any]:
    """Remove ``torch.compile``'s ``_orig_mod.`` from the keys.

    A compiled top-level module prefixes its keys with ``_orig_mod.`` (no dot
    before it), which the mid-key replace alone would miss.
    """
    return {k.removeprefix("_orig_mod.").replace(_ORIG_MOD, "."): v
            for k, v in state_dict.items()}


def strip_prefix(state_dict: Mapping[str, Any], prefix: str) -> dict[str, Any]:
    plen = len(prefix)
    return {k[plen:]: v for k, v in state_dict.items() if k.startswith(prefix)}


def _convnext_block(sd: Mapping[str, Any], key: str) -> dict[str, Any]:
    return {
        "dwconv": _conv1d(sd, f"{key}.dwconv"),
        "norm": _layernorm(sd, f"{key}.norm"),
        "pwconv1": _linear(sd, f"{key}.pwconv1"),
        "grn": {"gamma": _np(sd[f"{key}.grn.gamma"]), "beta": _np(sd[f"{key}.grn.beta"])},
        "pwconv2": _linear(sd, f"{key}.pwconv2"),
    }


def convert_dit_state_dict(state_dict: Mapping[str, Any], depth: int,
                           conv_layers: int) -> dict[str, Any]:
    """Reference torch DiT state dict → flax DiT parameter tree."""
    sd = strip_compiled_prefix(state_dict)
    text_embed: dict[str, Any] = {"embed": {"embedding": _np(sd["text_embed.text_embed.weight"])}}
    for i in range(conv_layers):
        text_embed[f"block{i}"] = _convnext_block(sd, f"text_embed.text_blocks.{i}")
    params: dict[str, Any] = {
        "time_embed": {
            "mlp_in": _linear(sd, "time_embed.time_mlp.0"),
            "mlp_out": _linear(sd, "time_embed.time_mlp.2"),
        },
        "text_embed": text_embed,
        "input_embed": {
            "proj": _linear(sd, "input_embed.proj"),
            "conv_pos_embed": {
                "conv1": _conv1d(sd, "input_embed.conv_pos_embed.conv1d.0"),
                "conv2": _conv1d(sd, "input_embed.conv_pos_embed.conv1d.2"),
            },
        },
        "norm_out": {"linear": _linear(sd, "norm_out.linear")},
        "proj_out": _linear(sd, "proj_out"),
    }
    for i in range(depth):
        b = f"transformer_blocks.{i}"
        params[f"block{i}"] = {
            "attn_norm": {"linear": _linear(sd, f"{b}.attn_norm.linear")},
            "attn": {
                "to_q": _linear(sd, f"{b}.attn.to_q"),
                "to_k": _linear(sd, f"{b}.attn.to_k"),
                "to_v": _linear(sd, f"{b}.attn.to_v"),
                "to_out": _linear(sd, f"{b}.attn.to_out.0"),
            },
            "ff": {
                "in_proj": _linear(sd, f"{b}.ff.ff.0"),
                "out_proj": _linear(sd, f"{b}.ff.ff.3"),
            },
        }
    return params


def convert_f5tts_state_dict(state_dict: Mapping[str, Any], depth: int,
                             conv_layers: int) -> dict[str, Any]:
    """Reference F5TTS (``cfm.backbone.*``) state dict → flax DiT tree."""
    sd = strip_compiled_prefix(state_dict)
    backbone = strip_prefix(sd, "cfm.backbone.") or sd  # or already backbone-level keys
    return convert_dit_state_dict(backbone, depth=depth, conv_layers=conv_layers)


def merge_compatible(params: dict[str, Any],
                     loaded: dict[str, Any]) -> tuple[dict[str, Any], list[str]]:
    """Overlay ``loaded`` onto ``params``, skipping leaves whose shape differs.

    The reference's non-strict pretrained load: an official F5-TTS Base
    checkpoint loads while the 65-token Cyrillic text embedding keeps its
    fresh initialization. Returns (merged, skipped paths), each path
    ``a/b/c``, a missing leaf as ``"a/b/c (missing)"``.
    """
    skipped: list[str] = []

    def walk(base: dict[str, Any], cand: Any, path: str) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for name, leaf in sorted(base.items()):  # the JAX tree's leaf order
            p = f"{path}/{name}" if path else name
            c = cand.get(name) if isinstance(cand, dict) else None
            if isinstance(leaf, dict):
                out[name] = walk(leaf, c, p)
            elif c is None or isinstance(c, dict):
                skipped.append(p + " (missing)")
                out[name] = leaf
            elif np.shape(c) != np.shape(leaf):
                skipped.append(p)
                out[name] = leaf
            else:
                out[name] = np.asarray(c, dtype=np.asarray(leaf).dtype)
        return out

    return walk(params, loaded, ""), skipped


def load_torch_checkpoint(path: str | Path, prefer_ema: bool = True,
                          weights_only: bool = False) -> dict[str, np.ndarray]:
    """Read a reference ``.pt`` or ``.safetensors`` checkpoint into numpy arrays.

    EMA weights first, as the reference's inference does; ``prefer_ema=False``
    takes the raw training weights. ``weights_only=True`` restricts the
    pickle to tensors: use it for any file from elsewhere (a full training
    checkpoint of a local trusted run needs the default, its optimizer state
    is not weights-only loadable).
    """
    if str(path).endswith(".safetensors"):
        return {k: _np(v) for k, v in load_safetensors(path).items()}
    ckpt = torch.load(path, map_location="cpu", weights_only=weights_only)
    if isinstance(ckpt, dict):
        keys = ("ema_state_dict", "ema_model_state_dict", "model_state_dict")
        if not prefer_ema:
            keys = ("model_state_dict", "ema_state_dict", "ema_model_state_dict")
        for key in keys:
            if key in ckpt:
                ckpt = ckpt[key]
                break
    return {k: _np(v) for k, v in ckpt.items()}


# ── flax tree → the reference's torch state dict ───────────────────────


def _t_linear(sd: dict[str, np.ndarray], key: str, p: Mapping[str, Any]) -> None:
    sd[f"{key}.weight"] = np.asarray(p["kernel"]).T
    sd[f"{key}.bias"] = np.asarray(p["bias"])


def _t_conv1d(sd: dict[str, np.ndarray], key: str, p: Mapping[str, Any]) -> None:
    sd[f"{key}.weight"] = np.asarray(p["kernel"]).transpose(2, 1, 0)
    sd[f"{key}.bias"] = np.asarray(p["bias"])


def _t_layernorm(sd: dict[str, np.ndarray], key: str, p: Mapping[str, Any]) -> None:
    sd[f"{key}.weight"] = np.asarray(p["scale"])
    sd[f"{key}.bias"] = np.asarray(p["bias"])


def _t_convnext(sd: dict[str, np.ndarray], key: str, p: Mapping[str, Any]) -> None:
    _t_conv1d(sd, f"{key}.dwconv", p["dwconv"])
    _t_layernorm(sd, f"{key}.norm", p["norm"])
    _t_linear(sd, f"{key}.pwconv1", p["pwconv1"])
    sd[f"{key}.grn.gamma"] = np.asarray(p["grn"]["gamma"])
    sd[f"{key}.grn.beta"] = np.asarray(p["grn"]["beta"])
    _t_linear(sd, f"{key}.pwconv2", p["pwconv2"])


def export_dit_state_dict(params: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """Flax DiT tree → reference torch DiT state dict (numpy values).

    The exact inverse of :func:`convert_dit_state_dict`: checkpoints trained
    here load into the PyTorch reference (strict, but for RoPE's
    ``inv_freq`` buffer, which torch derives from the config).
    """
    sd: dict[str, np.ndarray] = {}
    _t_linear(sd, "time_embed.time_mlp.0", params["time_embed"]["mlp_in"])
    _t_linear(sd, "time_embed.time_mlp.2", params["time_embed"]["mlp_out"])

    te = params["text_embed"]
    sd["text_embed.text_embed.weight"] = np.asarray(te["embed"]["embedding"])
    for i in range(sum(1 for k in te if k.startswith("block"))):
        _t_convnext(sd, f"text_embed.text_blocks.{i}", te[f"block{i}"])

    _t_linear(sd, "input_embed.proj", params["input_embed"]["proj"])
    cpe = params["input_embed"]["conv_pos_embed"]
    _t_conv1d(sd, "input_embed.conv_pos_embed.conv1d.0", cpe["conv1"])
    _t_conv1d(sd, "input_embed.conv_pos_embed.conv1d.2", cpe["conv2"])

    for i in range(sum(1 for k in params if k.startswith("block"))):
        blk, base = params[f"block{i}"], f"transformer_blocks.{i}"
        _t_linear(sd, f"{base}.attn_norm.linear", blk["attn_norm"]["linear"])
        for proj in ("q", "k", "v"):
            _t_linear(sd, f"{base}.attn.to_{proj}", blk["attn"][f"to_{proj}"])
        _t_linear(sd, f"{base}.attn.to_out.0", blk["attn"]["to_out"])
        _t_linear(sd, f"{base}.ff.ff.0", blk["ff"]["in_proj"])
        _t_linear(sd, f"{base}.ff.ff.3", blk["ff"]["out_proj"])

    _t_linear(sd, "norm_out.linear", params["norm_out"]["linear"])
    _t_linear(sd, "proj_out", params["proj_out"])
    return sd


def export_f5tts_state_dict(params: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """Flax DiT tree → reference F5TTS-level keys (``cfm.backbone.*``)."""
    return {f"cfm.backbone.{k}": v for k, v in export_dit_state_dict(params).items()}


# ── safetensors ────────────────────────────────────────────────────────
# An 8-byte little-endian header length, a JSON header mapping each name to
# {"dtype", "shape", "data_offsets": [begin, end]} (offsets into the byte
# buffer after the header; an optional "__metadata__" of strings), then the
# little-endian tensor bytes.

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
    "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def load_safetensors(path: str | Path) -> dict[str, torch.Tensor]:
    """A ``.safetensors`` file → CPU tensors; raises ``ValueError`` on a bad header."""
    data = bytearray(Path(path).read_bytes())
    if len(data) < 8:
        raise ValueError(f"{path}: {len(data)} bytes, too short for a safetensors header")
    (n,) = struct.unpack("<Q", data[:8])
    if 8 + n > len(data):
        raise ValueError(f"{path}: header of {n} bytes overruns the {len(data)}-byte file")
    try:
        header = json.loads(data[8: 8 + n].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise ValueError(f"{path}: unreadable safetensors header: {exc}") from exc
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the safetensors header is not a JSON object")
    start, size = 8 + n, len(data) - 8 - n
    out: dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        try:
            dtype = _ST_DTYPES[info["dtype"]]
            shape = [int(s) for s in info["shape"]]
            begin, end = (int(o) for o in info["data_offsets"])
        except (KeyError, TypeError, ValueError) as exc:
            raise ValueError(f"{path}: tensor {name!r} has an unreadable entry {info!r}") from exc
        count = int(np.prod(shape, dtype=np.int64))
        if not 0 <= begin <= end <= size or end - begin != count * dtype.itemsize:
            raise ValueError(f"{path}: tensor {name!r} offsets {begin}..{end} do not hold "
                             f"{shape} {info['dtype']} in a {size}-byte buffer")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        out[name] = torch.frombuffer(data, dtype=dtype, count=count,
                                     offset=start + begin).reshape(shape)
    return out


def save_safetensors(state_dict: Mapping[str, Any], path: str | Path) -> None:
    """Write numpy arrays or tensors (bf16 tensors as BF16) as ``.safetensors``."""
    header: dict[str, Any] = {}
    blobs, offset = [], 0
    for name in sorted(state_dict):
        value = state_dict[name]
        if isinstance(value, torch.Tensor):
            t = value.detach().cpu()
        else:  # ascontiguousarray makes a 0-d array 1-d: keep the shape
            a = np.asarray(value)
            t = torch.from_numpy(np.ascontiguousarray(a).reshape(a.shape))
        if t.dtype not in _ST_NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no safetensors name")
        raw = t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)  # the tensor bytes start 8-aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)
