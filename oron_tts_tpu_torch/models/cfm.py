"""Conditional flow matching: the training loss and the CFG Euler sampler.

Counterpart of the JAX package's ``models/cfm.py``. ``CFM.loss``: a random
contiguous span per sample, ``t ~ U(0, 1)`` per sample, one CFG dropout
decision per batch (dropping the text forces dropping the audio), and the
MSE between the predicted and the true flow over the span's frames × mel
bins. Every random number of a training loss comes from one explicit CPU
``torch.Generator`` (so a step is the same on the CPU and on the card):
span fractions, span starts, times, the two drop decisions, ``x0``, and the
backbone's ``dropout_pairs`` ``(attention, FFN)`` dropout seed pairs (one a block;
the MMDiT's text FFNs take more), in that order. With
``train=False`` the loss is deterministic (``t = 0.5``, a centred span of
the middle fraction, no dropout). The streams differ from ``jax.random``'s;
parity tests pass ``x0`` in.

Under a mesh (``self.mesh``, set by ``F5TTS.set_mesh``) a data rank holds
its block of the global batch's rows (``mesh.batch_rows``). Every per-row
draw is then made for the whole global batch from the one generator and
this rank's rows are kept, so a data-parallel step sees the single-process
spans, times and noise; the per-block dropout seeds are drawn identically
on every rank, since every rank's generator has the same seed and draws in
the same order. The loss is the masked mean over the global batch: the
numerator's value and the denominator are summed over the data group and
divided once (a mean of per-rank means would weigh ranks with fewer span
frames wrongly); its gradient on a rank is that of its own numerator over
the global denominator, so summing the gradients over the data group gives
the single-process gradient.

``CFM.sample``: sway-warped time grid, classifier-free guidance as one doubled-batch
forward per step (``pred + (pred − null)·cfg``), AdaLN projections hoisted
over the whole schedule before the loop (both streams' for an MMDiT; a UNetT, which
has none, hoists its time embedding alone; ``hoist_t_mods=False`` runs them inside
every forward
instead, as the reference does), and the conditioning region
re-substituted at the end. The ODE state stays f32 whatever the model's
compute dtype, as in the JAX sampler. ``cfg_interval=(lo, hi)`` applies guidance only at
the steps whose time lies in the interval (the others run one cond-only
forward); ``method="midpoint"`` takes two velocity evaluations per step.

Initial noise is a pure function of (row seed, frame, mel bin)
(:func:`per_row_noise`): a row of any batch, in any bucket, on the CPU or
the card, draws what its seed draws alone. That is what lets a server merge
requests without changing their audio. The stream is the port's own, not
``jax.random``'s; parity tests pass ``noise`` in.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

from oron_tts_tpu_torch.models.backbone import Backbone
from oron_tts_tpu_torch.parallel.mesh import all_reduce_sum
from oron_tts_tpu_torch.utils import trace


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


_M32 = 0xFFFFFFFF


def _fmix32(z: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finaliser on int64 tensors holding uint32 values."""
    z = ((z ^ (z >> 16)) * 0x85EBCA6B) & _M32
    z = ((z ^ (z >> 13)) * 0xC2B2AE35) & _M32
    return z ^ (z >> 16)


def per_row_noise(
    seeds: Sequence[int], length: int, n_mels: int, device: torch.device | str,
    rows: Sequence[int] | None = None,
) -> torch.Tensor:
    """Initial ODE noise ``[len(seeds), length, n_mels]`` f32, one seed per row.

    ``noise[i, t, m]`` is a counter hash of ``(seeds[i], rows[i], t, m)`` turned
    into a standard normal by Box-Muller, so it depends on nothing else: not on
    the batch, the row's position, or the padded length. The hash runs in
    uint32 wrap-around (int64 tensors masked to 32 bits) and the transform in
    float64 rounded once to f32, the same on the CPU and on the card up to
    the last bit of ``log`` and ``cos``. ``rows`` defaults to zeros; a single
    seed shared by a whole batch passes the row indices instead.
    """
    n = len(seeds)
    folded = [((int(s) & 0xFFFFFFFFFFFFFFFF) ^ ((int(s) & 0xFFFFFFFFFFFFFFFF) >> 32)) & _M32
              for s in seeds]
    seed_t = torch.tensor(folded, dtype=torch.int64, device=device)
    row_t = torch.tensor(list(rows) if rows is not None else [0] * n,
                         dtype=torch.int64, device=device)
    row_key = _fmix32((seed_t * 0x9E3779B1 + row_t * 0x7FEB352D + 0x165667B1) & _M32)
    frames = torch.arange(length, dtype=torch.int64, device=device)
    frame_key = _fmix32((row_key[:, None] ^ ((frames * 0x85EBCA77) & _M32)[None, :]))
    bins = torch.arange(n_mels, dtype=torch.int64, device=device)
    counter = frame_key[:, :, None] + ((bins * 0xC2B2AE3D) & _M32)[None, None, :]
    z1 = _fmix32(counter & _M32)
    z2 = _fmix32((counter + 0x27D4EB2F) & _M32)
    u1 = (z1.to(torch.float64) + 1.0) / 4294967296.0  # (0, 1]
    u2 = z2.to(torch.float64) / 4294967296.0           # [0, 1)
    normal = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * np.pi * u2)
    return normal.to(torch.float32)


def cfg_segments(
    steps: int, sway_sampling_coef: float | None, cfg_interval: tuple[float, float] | None,
    use_cfg: bool,
) -> list[tuple[int, int, bool]]:
    """Contiguous step ranges ``(start, stop, guided)`` of one solve.

    Without an interval (or without guidance) it is one range. With one, a
    step is guided when its time on the float64 sway-warped grid lies in
    ``[lo, hi]``; the grid is monotonic, so at most three ranges come out.
    """
    if not (use_cfg and cfg_interval is not None):
        return [(0, steps, use_cfg)]
    lo, hi = float(cfg_interval[0]), float(cfg_interval[1])
    t = sway_timesteps_host(steps, sway_sampling_coef)[:-1]
    inside = (t >= lo) & (t <= hi)
    bounds = [0] + [i for i in range(1, steps) if inside[i] != inside[i - 1]] + [steps]
    return [(a, b, bool(inside[a])) for a, b in zip(bounds, bounds[1:])]


class CFM:
    """Stateless trainer/sampler around a backbone (``models/backbone.py``)."""

    def __init__(
        self,
        backbone: Backbone,
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
        self.mesh = None

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
        ``x0`` overrides the drawn noise (this rank's rows under a mesh).
        """
        if mel.ndim == 3 and mel.shape[1] == self.n_mels:
            mel = mel.transpose(1, 2)
        x1 = mel.float()
        device = x1.device
        batch, seq_len = x1.shape[0], x1.shape[1]
        data_group = None if self.mesh is None else self.mesh.data_group
        # this rank's rows [row0, row0 + batch) of a global batch of g_batch
        g_batch, row0 = batch, 0
        if data_group is not None:
            g_batch, row0 = batch * self.mesh.n_data, batch * self.mesh.data_rank
        rows = slice(row0, row0 + batch)
        if lens is None:
            lens = torch.full((batch,), seq_len, dtype=torch.int32)
        lens = lens.to(device=device, dtype=torch.int32)
        mask = lens_to_mask(lens, seq_len)
        lo, hi = self.frac_lengths_mask
        dropout_seeds = None
        if train:
            if generator is None:
                raise ValueError("a training loss needs a torch.Generator")
            with trace.span("cfm.draw"):
                draws = torch.rand((3, g_batch), generator=generator)[:, rows]
                frac = (lo + (hi - lo) * draws[0]).to(device)
                span = span_mask_from_fracs(lens, frac, draws[1].to(device), seq_len) & mask
                t = draws[2].to(device)
                drop_a, drop_t = (torch.rand(2, generator=generator) < torch.tensor(
                    [self.audio_drop_prob, self.cond_drop_prob])).tolist()
                drop_text = bool(drop_t)
                drop_audio = bool(drop_a) or drop_text
                if x0 is None:
                    x0 = torch.randn((g_batch, *x1.shape[1:]), generator=generator)[rows]
                seeds = torch.randint(
                    -2**31, 2**31, (self.backbone.dropout_pairs, 2),
                    generator=generator).tolist()
                dropout_seeds = [tuple(pair) for pair in seeds]
                x0 = x0.to(device=device, dtype=torch.float32)
        else:
            mid = (lo + hi) / 2
            span_len = (mid * lens).to(torch.int32)
            start = torch.clamp((lens - span_len) // 2, min=0)
            pos = torch.arange(seq_len, device=device)[None, :]
            span = (pos >= start[:, None]) & (pos < (start + span_len)[:, None]) & mask
            t = torch.full((batch,), 0.5, device=device)
            drop_audio = drop_text = False
            if x0 is None:
                x0 = torch.randn((g_batch, *x1.shape[1:]),
                                 generator=torch.Generator().manual_seed(0))[rows]
            x0 = x0.to(device=device, dtype=torch.float32)

        cond = torch.where(span[..., None], 0.0, x1)
        tb = t[:, None, None]
        phi = (1 - tb) * x0 + tb * x1
        flow = x1 - x0
        pred = self.backbone(
            phi, cond, text_ids.to(device), t, mask=mask, drop_audio_cond=drop_audio,
            drop_text=drop_text, dropout_seeds=dropout_seeds, batch0=row0,
        )
        se = torch.square(pred.float() - flow)
        weight = span[..., None].to(se.dtype)
        # mean over the span's frames × mel bins
        denom = weight.sum() * se.shape[-1]
        if data_group is None:
            return (se * weight).sum() / torch.clamp(denom, min=1.0)
        denom = all_reduce_sum(denom.detach().clone(), data_group)
        local = (se * weight).sum() / torch.clamp(denom, min=1.0)
        total = all_reduce_sum(local.detach().clone(), data_group)
        # the global loss's value, this rank's share of its gradient
        return local + (total - local.detach())

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
        seed: int | Sequence[int] | None = None,
        noise: torch.Tensor | None = None,
        return_trajectory: bool = False,
        max_duration: int = 65536,
        hoist_t_mods: bool = True,
        cfg_interval: tuple[float, float] | None = None,
        method: str = "euler",
    ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """ODE generation (Euler or explicit midpoint).

        Args:
            cond: conditioning mel, zero-padded to the full length [B, T, M].
            text_ids: [B, T] stretched token ids (−1 = padding).
            duration: [B] total lengths; lens: [B] conditioning lengths.
            seed: one int for the batch (row i then draws from ``(seed, i)``),
                or one int per row (row i draws what ``seed[i]`` draws alone,
                whatever the batch: :func:`per_row_noise`).
            noise: optional [B, T, M] initial noise, instead of ``seed``.
            return_trajectory: also return the state before the first step and
                after every step (per step, for either method), on the device.
            max_duration: the most frames ``cond`` may hold; more raises
                before anything runs on the device.
            hoist_t_mods: compute the timestep MLP and every AdaLN projection
                for the whole step schedule once, before the loop (the
                default). ``False`` computes them inside each forward from the
                step's time, the reference's shape and a bench lever
                (``cli/bench_sampler_levers.py``); the two agree within f32
                rounding.
            cfg_interval: optional ``(lo, hi)``: guidance (the doubled forward
                and the guided combine) applies only at steps whose time lies
                in ``[lo, hi]``; the others run one cond-only forward. ``None``
                applies it at every step; ``(0, 1)`` is identical to ``None``.
            method: ``"euler"`` or ``"midpoint"`` (two velocity evaluations per
                step, second order).

        Returns:
            (mel [B, T, M] f32, trajectory [steps + 1, B, T, M] f32 or None),
            as the JAX package's ``sample``.
        """
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        if method not in ("euler", "midpoint"):
            raise ValueError(f"method must be 'euler' or 'midpoint', got {method!r}")
        if cfg_strength < 0:
            raise ValueError(f"cfg_strength must be >= 0, got {cfg_strength}")
        if cfg_interval is not None and not (
                0.0 <= float(cfg_interval[0]) <= float(cfg_interval[1])):
            raise ValueError(f"cfg_interval must satisfy 0 <= lo <= hi, got {cfg_interval}")
        batch, max_dur, n_mels = cond.shape
        if max_dur > max_duration:
            raise ValueError(f"duration exceeds max_duration={max_duration}")
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
            if seed is None or isinstance(seed, int):
                noise = per_row_noise([0 if seed is None else seed] * batch, max_dur, n_mels,
                                      device, rows=range(batch))
            else:
                if len(seed) != batch:
                    raise ValueError("a list of seeds must have one entry per row")
                noise = per_row_noise(seed, max_dur, n_mels, device)
        x = torch.where(attn_mask[..., None], noise.to(device).float(), 0.0)

        dit = self.backbone
        use_cfg = cfg_strength >= 1e-5
        segments = cfg_segments(steps, sway_sampling_coef, cfg_interval, use_cfg)
        te_cond = dit.embed_text(text_ids, max_dur, drop_text=False)
        te_uncond = None
        if any(guided for _, _, guided in segments):
            te_uncond = dit.embed_text(text_ids, max_dur, drop_text=True)

        grid = sway_timesteps_host(steps, sway_sampling_coef).astype(np.float32)
        t_dev = torch.from_numpy(grid).to(device)
        times = t_dev[:-1]
        if method == "midpoint":  # rows [steps, 2·steps): the half steps, each in
            # the JAX sampler's own f32 formula for its path
            half = ((t_dev[:-1] + t_dev[1:]) / 2 if hoist_t_mods
                    else t_dev[:-1] + (t_dev[1:] - t_dev[:-1]) / 2)
            times = torch.cat([times, half])
        if hoist_t_mods:  # the DiT's AdaLN tables; a UNetT's time embedding alone
            tables = dit.precompute_t_mods(dit.embed_time(times))

        def velocity(x: torch.Tensor, row: int, guided: bool) -> torch.Tensor:
            tm = tuple(t.select(-2, row) for t in tables) if hoist_t_mods else None
            t_b = times[row].expand(batch)
            if not guided:
                return dit(x, step_cond, text_ids, t_b, mask=attn_mask,
                           text_embed=te_cond, t_mods=tm).float()
            pred, null = dit.forward_cfg(
                x, step_cond, te_cond, te_uncond, t_b, attn_mask, t_mods=tm)
            return (pred + (pred - null) * cfg_strength).float()

        trajectory = [x] if return_trajectory else None
        for start, stop, guided in segments:
            for i in range(start, stop):
                dt = float(grid[i + 1] - grid[i])  # an f32 grid difference
                v = velocity(x, i, guided)
                if method == "midpoint":
                    v = velocity(x + v * (dt / 2), steps + i, guided)
                x = x + v * dt
                if trajectory is not None:
                    trajectory.append(x)
        out = torch.where(cond_mask, cond, x)
        return out, (torch.stack(trajectory) if trajectory is not None else None)
