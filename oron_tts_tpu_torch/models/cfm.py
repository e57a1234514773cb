"""Conditional flow matching sampler: CFG Euler solve (PyTorch).

Counterpart of the inference half of the JAX package's ``models/cfm.py``:
sway-warped time grid, classifier-free guidance as one doubled-batch
forward per step (``pred + (pred − null)·cfg``), AdaLN projections hoisted
over the whole schedule before the loop, and the conditioning region
re-substituted at the end. The Euler state stays f32 whatever the model's
compute dtype, as in the JAX sampler.

``cfg_interval`` and the midpoint solver are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from oron_tts_tpu_torch.models.dit import DiT, precompute_t_mods


def lens_to_mask(lens: torch.Tensor, length: int) -> torch.Tensor:
    return torch.arange(length, device=lens.device)[None, :] < lens[:, None]


def sway_timesteps_host(steps: int, coef: float | None) -> np.ndarray:
    """Float64 integration grid of steps+1 points, optionally sway-warped."""
    t = np.linspace(0.0, 1.0, steps + 1)
    if coef is not None:
        t = t + coef * (np.cos(np.pi / 2 * t) - 1 + t)
    return t


def draw_noise(
    batch: int, length: int, n_mels: int, generator: torch.Generator, device: torch.device
) -> torch.Tensor:
    """Initial ODE noise [batch, length, n_mels] f32 from ``generator``."""
    return torch.randn(
        (batch, length, n_mels), generator=generator, device=device, dtype=torch.float32
    )


class CFM:
    """Stateless sampler around a DiT backbone."""

    def __init__(self, backbone: DiT, n_mels: int = 100) -> None:
        self.backbone = backbone
        self.n_mels = n_mels

    @torch.no_grad()
    def sample(
        self,
        cond: torch.Tensor,
        text_ids: torch.Tensor,
        duration: torch.Tensor,
        lens: torch.Tensor,
        steps: int = 32,
        cfg_strength: float = 1.0,
        sway_sampling_coef: float | None = None,
        seed: int | None = None,
        noise: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """Euler-ODE generation.

        Args:
            cond: conditioning mel, zero-padded to the full length [B, T, M].
            text_ids: [B, T] stretched token ids (−1 = padding).
            duration: [B] total lengths; lens: [B] conditioning lengths.
            noise: optional [B, T, M] initial noise; otherwise drawn from a
                ``torch.Generator`` on cond's device seeded with ``seed``.

        Returns:
            mel [B, T, M] f32.
        """
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        if cfg_strength < 0:
            raise ValueError(f"cfg_strength must be >= 0, got {cfg_strength}")
        batch, max_dur, n_mels = cond.shape
        d = np.asarray(torch.as_tensor(duration).cpu())
        ln = np.asarray(torch.as_tensor(lens).cpu())
        if d.size != batch or ln.size != batch:
            raise ValueError("duration/lens must have one value per sample")
        if (d <= 0).any():
            raise ValueError("duration values must be > 0")
        if (ln < 0).any():
            raise ValueError("lens values must be >= 0")
        if (ln > d).any():
            raise ValueError("conditioning lens must be <= duration for every sample")
        if (d > max_dur).any():
            raise ValueError("duration must be <= padded cond length")

        device = cond.device
        cond = cond.float()
        duration = torch.as_tensor(d, dtype=torch.int64, device=device)
        lens = torch.as_tensor(ln, dtype=torch.int64, device=device)
        cond_mask = lens_to_mask(lens, max_dur)[..., None]
        step_cond = torch.where(cond_mask, cond, 0.0)
        attn_mask = lens_to_mask(duration, max_dur)

        if noise is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(0 if seed is None else int(seed))
            noise = draw_noise(batch, max_dur, n_mels, gen, device)
        x = torch.where(attn_mask[..., None], noise.to(device).float(), 0.0)

        dit = self.backbone
        te_cond = dit.embed_text(text_ids, max_dur, drop_text=False)
        te_uncond = dit.embed_text(text_ids, max_dur, drop_text=True)

        grid = sway_timesteps_host(steps, sway_sampling_coef).astype(np.float32)
        t_dev = torch.from_numpy(grid).to(device)
        use_cfg = cfg_strength >= 1e-5
        block_mods, final_mods = precompute_t_mods(dit, dit.embed_time(t_dev[:-1]))

        for i in range(steps):
            dt = float(grid[i + 1] - grid[i])
            tm = (block_mods[:, i], final_mods[i])
            t_b = t_dev[i].expand(batch)
            if use_cfg:
                pred, null = dit.forward_cfg(
                    x, step_cond, te_cond, te_uncond, t_b, attn_mask, t_mods=tm
                )
                v = pred + (pred - null) * cfg_strength
            else:
                v = dit(x, step_cond, text_ids, t_b, mask=attn_mask,
                        text_embed=te_cond, t_mods=tm)
            x = x + v.float() * dt  # dt is an f32 grid difference
        return torch.where(cond_mask, cond, x)
