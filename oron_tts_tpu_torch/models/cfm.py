"""Conditional flow matching: the training loss and the CFG Euler sampler.

Counterpart of the JAX package's ``models/cfm.py``. ``CFM.loss``: a random
contiguous span per sample, ``t ~ U(0, 1)`` per sample, one CFG dropout
decision per batch (dropping the text forces dropping the audio), and the
MSE between the predicted and the true flow over the span's frames × mel
bins. Every random number of a training loss comes from one explicit CPU
``torch.Generator`` (so a step is the same on the CPU and on the card):
span fractions, span starts, times, the two drop decisions, ``x0``, and one
``(attention, FFN)`` dropout seed pair per DiT block, in that order. With
``train=False`` the loss is deterministic (``t = 0.5``, a centred span of
the middle fraction, no dropout). The streams differ from ``jax.random``'s;
parity tests pass ``x0`` in.

``CFM.sample``: sway-warped time grid, classifier-free guidance as one doubled-batch
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


def span_mask_from_fracs(
    lens: torch.Tensor, frac_lengths: torch.Tensor, starts_u: torch.Tensor, length: int
) -> torch.Tensor:
    """Contiguous span per row: width ``frac·len``, start ``U·(len − span)``."""
    span = (frac_lengths * lens).to(torch.int32)
    max_start = lens - span
    start = torch.clamp((max_start * starts_u).to(torch.int32), min=0)
    end = start + span
    pos = torch.arange(length, device=lens.device)[None, :]
    return (pos >= start[:, None]) & (pos < end[:, None])


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
    """Stateless trainer/sampler around a DiT backbone."""

    def __init__(
        self,
        backbone: DiT,
        n_mels: int = 100,
        audio_drop_prob: float = 0.3,
        cond_drop_prob: float = 0.2,
        frac_lengths_mask: tuple[float, float] = (0.7, 1.0),
    ) -> None:
        self.backbone = backbone
        self.n_mels = n_mels
        self.audio_drop_prob = audio_drop_prob
        self.cond_drop_prob = cond_drop_prob
        self.frac_lengths_mask = frac_lengths_mask

    def loss(
        self,
        mel: torch.Tensor,
        text_ids: torch.Tensor,
        lens: torch.Tensor | None,
        generator: torch.Generator | None = None,
        train: bool = True,
        x0: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """Scalar CFM loss (f32). mel: [B, n_mels, T] or [B, T, n_mels].

        ``generator`` is a CPU generator and is required when ``train``;
        ``x0`` overrides the drawn noise.
        """
        if mel.ndim == 3 and mel.shape[1] == self.n_mels:
            mel = mel.transpose(1, 2)
        x1 = mel.float()
        device = x1.device
        batch, seq_len = x1.shape[0], x1.shape[1]
        if lens is None:
            lens = torch.full((batch,), seq_len, dtype=torch.int32)
        lens = lens.to(device=device, dtype=torch.int32)
        mask = lens_to_mask(lens, seq_len)
        lo, hi = self.frac_lengths_mask
        dropout_seeds = None
        if train:
            if generator is None:
                raise ValueError("a training loss needs a torch.Generator")
            draws = torch.rand((3, batch), generator=generator)
            frac = (lo + (hi - lo) * draws[0]).to(device)
            span = span_mask_from_fracs(lens, frac, draws[1].to(device), seq_len) & mask
            t = draws[2].to(device)
            drop_a, drop_t = (torch.rand(2, generator=generator) < torch.tensor(
                [self.audio_drop_prob, self.cond_drop_prob])).tolist()
            drop_text = bool(drop_t)
            drop_audio = bool(drop_a) or drop_text
            if x0 is None:
                x0 = torch.randn(x1.shape, generator=generator)
            seeds = torch.randint(
                -2**31, 2**31, (self.backbone.depth, 2), generator=generator).tolist()
            dropout_seeds = [tuple(pair) for pair in seeds]
        else:
            mid = (lo + hi) / 2
            span_len = (mid * lens).to(torch.int32)
            start = torch.clamp((lens - span_len) // 2, min=0)
            pos = torch.arange(seq_len, device=device)[None, :]
            span = (pos >= start[:, None]) & (pos < (start + span_len)[:, None]) & mask
            t = torch.full((batch,), 0.5, device=device)
            drop_audio = drop_text = False
            if x0 is None:
                x0 = torch.randn(x1.shape, generator=torch.Generator().manual_seed(0))
        x0 = x0.to(device=device, dtype=torch.float32)

        cond = torch.where(span[..., None], 0.0, x1)
        tb = t[:, None, None]
        phi = (1 - tb) * x0 + tb * x1
        flow = x1 - x0
        pred = self.backbone(
            phi, cond, text_ids.to(device), t, mask=mask, drop_audio_cond=drop_audio,
            drop_text=drop_text, dropout_seeds=dropout_seeds,
        )
        se = torch.square(pred.float() - flow)
        weight = span[..., None].to(se.dtype)
        # mean over the span's frames × mel bins
        denom = weight.sum() * se.shape[-1]
        return (se * weight).sum() / torch.clamp(denom, min=1.0)

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
