"""Seeded backbone weights, made on the device in one draw.

Every tensor is non-zero (a zero AdaLN or output projection would make the
velocity 0, and no kernel's output would reach the mel). Linear weights are
N(0, 1/fan_in); conv kernels N(0, 1/(K·cin)); the token table N(0, 1);
LayerNorm scales 1 + N(0, 0.02²); biases and GRN N(0, 0.02²), except the
output projection's bias, which is centred on ``MEL_MEAN`` so that the
generated log-mel lies where speech's does and the vocoder gives audio that
is not clipped flat. A tensor that none of these rules knows takes its
architecture's ``weight_rule`` (``portbench/reference/__init__.py``). The
same tensors go to the program and to the reference.
"""

from __future__ import annotations

import math

import torch

MEL_MEAN = -3.0  # natural-log mel of speech lies in about [-11, 2]


def _std_and_mean(key: str, shape: tuple[int, ...], rule=None) -> tuple[float, float]:
    if key == "proj_out.bias":
        return 0.02, MEL_MEAN
    if key.endswith(".bias") or key.endswith("grn.gamma") or key.endswith("grn.beta"):
        return 0.02, 0.0
    if key.endswith("norm.weight") and len(shape) == 1:
        return 0.02, 1.0
    if key.endswith("embed.weight") and len(shape) == 2:
        return 1.0, 0.0
    if len(shape) == 3:  # conv [K, cin/groups, C]
        return 1.0 / math.sqrt(shape[0] * shape[1]), 0.0
    if len(shape) == 2:  # linear [out, in]
        return 1.0 / math.sqrt(shape[1]), 0.0
    found = rule(key, shape) if rule is not None else None
    if found is None:
        raise ValueError(f"no rule for {key} {shape}")
    return found


def dit_state(shapes: dict[str, tuple[int, ...]], seed: int, device, dtype: torch.dtype,
              arch) -> dict[str, torch.Tensor]:
    """The state dict for ``shapes`` (in their order), drawn from ``seed`` on ``device``;
    ``arch`` is the architecture module whose ``weight_rule``, if it has one, takes the
    keys that the rules here do not know."""
    rule = getattr(arch, "weight_rule", None)
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for key, shape in shapes.items():
        n = math.prod(shape)
        std, mean = _std_and_mean(key, shape, rule)
        out[key] = (flat[at: at + n].view(shape) * std + mean).to(dtype)
        at += n
    del flat
    return out
