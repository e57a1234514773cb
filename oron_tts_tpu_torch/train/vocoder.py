"""Vocoder (VocosDecoder) training: mel → waveform reconstruction (PyTorch).

Counterpart of the JAX package's ``train/vocoder.py``. The MR-STFT stage
minimises a multi-resolution STFT loss (spectral convergence + log-magnitude
L1) plus a log-mel L1; the optional GAN stage adds the LSGAN losses and
feature matching against ``models/discriminators.py``. ``torch.fft.rfft``
stands in for the JAX package's real-DFT matmuls.

The optimizers are optax's, written out in tensor ops (``OptaxAdamW``):
``chain(clip_by_global_norm(max_norm), adamw(lr, b1, b2, weight_decay=1e-4))``,
the learning rate a constant or a schedule read at the update count before
the update. The guard (``guarded_step``) reads the loss and the gradient
norm on the host once a step; when either is not finite the parameters, the
moments and the count (hence the schedule) all stay as they were, as the
JAX ``guarded_update`` keeps them.

A "superstep" runs K guarded steps over a corpus packed into one tensor on
the device, from crop starts ``[K, B]`` sampled on the host, and returns the
K losses and gradient norms (``[K, 4]`` metrics for the GAN stage). Offsets
into the packed corpus are int64, so it may exceed 2^31 samples (the JAX
package refuses that: its indices are int32).
"""

from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch

from oron_tts_tpu_torch.ops.mel import (
    MelConfig,
    log_mel_numpy,
    log_mel_spectrogram,
    stft_magnitude_eps,
)
from oron_tts_tpu_torch.train.trainer import _optax_adam_state, make_lr_schedule

RESOLUTIONS = ((512, 128), (1024, 256), (2048, 512))


def multi_resolution_stft_loss(
    pred: torch.Tensor, target: torch.Tensor,
    resolutions: tuple[tuple[int, int], ...] = RESOLUTIONS,
) -> torch.Tensor:
    """Spectral convergence (Frobenius norms over the whole batch) + log-magnitude
    L1, averaged over the resolutions."""
    total = 0.0
    for n_fft, hop in resolutions:
        p = stft_magnitude_eps(pred, n_fft, hop)
        t = stft_magnitude_eps(target, n_fft, hop)
        sc = torch.linalg.vector_norm(t - p) / torch.clamp(torch.linalg.vector_norm(t), min=1e-6)
        mag = torch.mean(torch.abs(torch.log(p + 1e-7) - torch.log(t + 1e-7)))
        total = total + sc + mag
    return total / len(resolutions)


def mel_l1(pred: torch.Tensor, target: torch.Tensor, mel_cfg: MelConfig) -> torch.Tensor:
    return torch.mean(torch.abs(log_mel_spectrogram(pred, mel_cfg)
                                - log_mel_spectrogram(target, mel_cfg)))


def vocoder_loss(
    vocoder: torch.nn.Module, mel: torch.Tensor, wav_target: torch.Tensor,
    mel_cfg: MelConfig, mel_weight: float = 1.0,
) -> torch.Tensor:
    """mel [B, n_mels, T], wav_target [B, T·hop]; trims both to the shorter."""
    wav_pred = vocoder(mel)
    n = min(wav_pred.shape[-1], wav_target.shape[-1])
    wav_pred, wav_target = wav_pred[:, :n], wav_target[:, :n]
    loss = multi_resolution_stft_loss(wav_pred, wav_target)
    if mel_weight > 0:
        loss = loss + mel_weight * mel_l1(wav_pred, wav_target, mel_cfg)
    return loss


def lsgan_d_loss(real_logits: list[torch.Tensor], fake_logits: list[torch.Tensor]) -> torch.Tensor:
    """Least-squares discriminator loss: real → 1, fake → 0."""
    loss = 0.0
    for r, f in zip(real_logits, fake_logits):
        loss = loss + torch.mean((r - 1.0) ** 2) + torch.mean(f ** 2)
    return loss / len(real_logits)


def lsgan_g_loss(fake_logits: list[torch.Tensor]) -> torch.Tensor:
    loss = 0.0
    for f in fake_logits:
        loss = loss + torch.mean((f - 1.0) ** 2)
    return loss / len(fake_logits)


def feature_matching_loss(real_feats: list[list[torch.Tensor]],
                          fake_feats: list[list[torch.Tensor]]) -> torch.Tensor:
    loss, n = 0.0, 0
    for rf, ff in zip(real_feats, fake_feats):
        for r, f in zip(rf, ff):
            loss = loss + torch.mean(torch.abs(r - f))
            n += 1
    return loss / max(n, 1)


# ── the optimizer ────────────────────────────────────────────────────────


def warmup_cosine_schedule(lr: float, steps: int) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(lr·1e-2, lr, min(500, max(steps // 20, 1)),
    steps)``: linear warm-up, then a cosine to 0."""
    return make_lr_schedule(lr, min(500, max(steps // 20, 1)), steps, eta_min=0.0,
                            start_factor=1e-2)


class OptaxAdamW:
    """``optax.chain(clip_by_global_norm(max_norm), adamw(lr, b1, b2, eps, weight_decay))``.

    Over a list of f32 parameters, with f32 moments. optax clips by
    ``g / ‖g‖ · max_norm`` only when ``‖g‖ ≥ max_norm``, decays every
    parameter (biases and norms too), and reads a schedule at the count
    before the update, so the first update runs at ``lr(0)``.
    """

    def __init__(self, params: list[torch.Tensor], lr: float | Callable[[int], float],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4, max_norm: float = 1.0) -> None:
        self.params = params
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay, self.max_norm = weight_decay, max_norm
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0  # updates applied; drives the schedule

    @property
    def scheduled(self) -> bool:
        return callable(self.lr)

    def lr_at(self, count: int) -> float:
        return float(np.float32(self.lr(count) if callable(self.lr) else self.lr))

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor], grad_norm: float) -> None:
        f32 = np.float32
        count_inc = self.count + 1
        bc1 = float(f32(1) - f32(self.b1) ** f32(count_inc))
        bc2 = float(f32(1) - f32(self.b2) ** f32(count_inc))
        lr = self.lr_at(self.count)
        if grad_norm >= self.max_norm:
            grads = torch._foreach_mul(torch._foreach_div(grads, grad_norm), self.max_norm)
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, upd, alpha=-lr)
        self.count = count_inc

    # optax's state layout: the JAX package writes ``tx.init(params)`` as
    # nested tuples (``checkpoint.flatten_tree``'s ``#i`` keys; empty states
    # leave no entry) and resumes by its leaves in order
    def optax_state(self, to_tree: Callable[[list[torch.Tensor]], Any]) -> tuple:
        """The optax state of this chain, leaves as host numpy, for a checkpoint."""
        count = np.asarray(self.count, np.int32)
        adam = (count, to_tree(self.mu), to_tree(self.nu))
        return ((), (adam, (), (count,)) if self.scheduled else (adam, (), ()))

    def load_optax_state(self, opt: Any, from_tree: Callable[[Any], list[torch.Tensor]]) -> None:
        """Moments and count from an optax state tree (the JAX package's or ours)."""
        adam = _optax_adam_state(opt)
        if adam is None:
            raise ValueError("no optax Adam state (count, mu, nu) in the checkpoint's opt tree")
        count, mu, nu = adam
        with torch.no_grad():
            for dst, src in ((self.mu, from_tree(mu)), (self.nu, from_tree(nu))):
                for d, s in zip(dst, src):
                    d.copy_(s)
        self.count = int(count)


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def _grads(params: list[torch.Tensor]) -> list[torch.Tensor]:
    out = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    for p in params:
        p.grad = None
    return out


def guarded_step(opt: OptaxAdamW, loss: torch.Tensor, aux: tuple = ()) -> tuple[float, ...]:
    """Backward of ``loss``, then ``opt``'s update unless the loss or the
    gradient norm is not finite. One host read; returns (loss, grad norm, *aux)."""
    loss.backward()
    grads = _grads(opt.params)
    norm = global_norm(grads)
    values = torch.stack([loss.detach().float(), norm, *(a.detach().float() for a in aux)])
    loss_v, norm_v, *aux_v = values.tolist()
    if math.isfinite(loss_v) and math.isfinite(norm_v):
        opt.update(grads, norm_v)
    return (loss_v, norm_v, *aux_v)


def gather_crops(flat: torch.Tensor, starts: torch.Tensor, crop_len: int) -> torch.Tensor:
    """[N] corpus, [B] int64 starts → [B, crop_len] crops, on the corpus's device."""
    idx = starts.to(flat.device, torch.int64)[:, None] + torch.arange(crop_len, device=flat.device)
    return flat[idx]


def _input_mel(wav: torch.Tensor, mel_cfg: MelConfig) -> torch.Tensor:
    return log_mel_spectrogram(wav, mel_cfg)[..., : wav.shape[-1] // mel_cfg.hop_length]


def make_vocoder_train_step(vocoder: torch.nn.Module, opt: OptaxAdamW, mel_cfg: MelConfig):
    """step(mel, wav) → (loss, grad norm): one guarded MR-STFT + mel-L1 update."""

    def step(mel: torch.Tensor, wav: torch.Tensor) -> tuple[float, float]:
        return guarded_step(opt, vocoder_loss(vocoder, mel, wav, mel_cfg))

    return step


def make_vocoder_train_step_wav(vocoder: torch.nn.Module, opt: OptaxAdamW, mel_cfg: MelConfig):
    """step(wav) → (loss, grad norm); the input mel is the crop's own, cut to
    ``crop_len // hop`` frames."""

    def step(wav: torch.Tensor) -> tuple[float, float]:
        return guarded_step(opt, vocoder_loss(vocoder, _input_mel(wav, mel_cfg), wav, mel_cfg))

    return step


def make_vocoder_superstep(vocoder: torch.nn.Module, opt: OptaxAdamW, mel_cfg: MelConfig,
                           crop_len: int, k_steps: int):
    """superstep(flat, starts [K, B]) → (losses [K], grad norms [K]): K guarded steps."""

    def superstep(flat: torch.Tensor, starts) -> tuple[np.ndarray, np.ndarray]:
        starts = torch.as_tensor(np.asarray(starts), dtype=torch.int64)
        if starts.shape[0] != k_steps:
            raise ValueError(f"starts {tuple(starts.shape)}: a superstep runs {k_steps} steps")
        out = []
        for batch_starts in starts:
            wav = gather_crops(flat, batch_starts, crop_len)
            out.append(guarded_step(opt, vocoder_loss(vocoder, _input_mel(wav, mel_cfg), wav,
                                                      mel_cfg)))
        losses, gnorms = np.asarray(out, np.float32).T
        return losses, gnorms

    return superstep


def crop_wavs(audios: list[np.ndarray], crop_len: int,
              rng: np.random.Generator | None = None) -> np.ndarray:
    """Random waveform crops [B, crop_len] (the mel is computed on the device)."""
    rng = rng or np.random.default_rng()
    out = np.zeros((len(audios), crop_len), np.float32)
    for i, audio in enumerate(audios):
        if len(audio) <= crop_len:
            out[i, : len(audio)] = audio
        else:
            start = int(rng.integers(0, len(audio) - crop_len))
            out[i] = audio[start: start + crop_len]
    return out


def pack_corpus(audios: list[np.ndarray], crop_len: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(flat [N], clip_offsets [C], max_starts [C]); clips shorter than
    ``crop_len`` are zero-padded to it, so every clip yields a crop."""
    pieces, offsets, max_starts = [], [], []
    pos = 0
    for audio in audios:
        a = audio.astype(np.float32)
        if len(a) < crop_len:
            a = np.pad(a, (0, crop_len - len(a)))
        pieces.append(a)
        offsets.append(pos)
        max_starts.append(len(a) - crop_len)
        pos += len(a)
    return (np.concatenate(pieces), np.asarray(offsets, np.int64),
            np.asarray(max_starts, np.int64))


def crop_batch(audios: list[np.ndarray], mel_cfg: MelConfig, crop_frames: int = 64,
               rng: np.random.Generator | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Random aligned (mel, wav) crops: [B, n_mels, crop], [B, crop·hop]; the
    mel is the cropped waveform's own (numpy, as the JAX package computes it)."""
    rng = rng or np.random.default_rng()
    crop_len = crop_frames * mel_cfg.hop_length
    wavs, mels = [], []
    for audio in audios:
        if len(audio) <= crop_len:
            piece = np.zeros(crop_len, np.float32)
            piece[: len(audio)] = audio
        else:
            start = int(rng.integers(0, len(audio) - crop_len))
            piece = audio[start: start + crop_len]
        wavs.append(piece)
        mels.append(log_mel_numpy(piece, mel_cfg)[:, :crop_frames])
    return np.stack(mels), np.stack(wavs)


# ── adversarial stage (--gan) ────────────────────────────────────────────


def _gan_losses(vocoder, discriminator, mel, real, mel_cfg, weights):
    """The generator's total (adv + fm·2 + stft + mel·15 by default) and its parts."""
    adv_w, fm_w, mel_w = weights
    fake = vocoder(mel)
    n = min(fake.shape[-1], real.shape[-1])
    fake_c, real_c = fake[:, :n], real[:, :n]
    fake_logits, fake_feats = discriminator(fake_c)
    _, real_feats = discriminator(real_c)
    adv = lsgan_g_loss(fake_logits)
    fm = feature_matching_loss(real_feats, fake_feats)
    stft = multi_resolution_stft_loss(fake_c, real_c)
    ml1 = mel_l1(fake_c, real_c, mel_cfg)
    return adv_w * adv + fm_w * fm + stft + mel_w * ml1, (adv, fm, stft, ml1)


def _d_loss(vocoder, discriminator, mel, real):
    with torch.no_grad():
        fake = vocoder(mel)
    n = min(fake.shape[-1], real.shape[-1])
    real_logits, _ = discriminator(real[:, :n])
    fake_logits, _ = discriminator(fake[:, :n])
    return lsgan_d_loss(real_logits, fake_logits)


def make_gan_superstep(
    vocoder: torch.nn.Module, discriminator: torch.nn.Module, g_opt: OptaxAdamW,
    d_opt: OptaxAdamW, mel_cfg: MelConfig, crop_len: int, k_steps: int,
    adv_weight: float = 1.0, fm_weight: float = 2.0, mel_weight: float = 15.0,
):
    """superstep(flat, starts [K, B]) → metrics [K, 4] of (g_loss, d_loss, mel_l1, g_gnorm).

    Each step: a guarded discriminator update on the current generator's
    (detached) output, then a guarded generator update against the updated
    discriminator. The discriminator's parameters take no gradient in the
    generator's backward.
    """
    weights = (adv_weight, fm_weight, mel_weight)

    def superstep(flat: torch.Tensor, starts) -> np.ndarray:
        starts = torch.as_tensor(np.asarray(starts), dtype=torch.int64)
        if starts.shape[0] != k_steps:
            raise ValueError(f"starts {tuple(starts.shape)}: a superstep runs {k_steps} steps")
        rows = []
        for batch_starts in starts:
            wav = gather_crops(flat, batch_starts, crop_len)
            mel = _input_mel(wav, mel_cfg)
            d_loss, _ = guarded_step(d_opt, _d_loss(vocoder, discriminator, mel, wav))
            discriminator.requires_grad_(False)
            try:
                total, (_, _, _, ml1) = _gan_losses(vocoder, discriminator, mel, wav, mel_cfg,
                                                    weights)
                g_loss, g_gnorm, ml1_v = guarded_step(g_opt, total, (ml1,))
            finally:
                discriminator.requires_grad_(True)
            rows.append((g_loss, d_loss, ml1_v, g_gnorm))
        return np.asarray(rows, np.float32)

    return superstep


def make_gan_train_steps(
    vocoder: torch.nn.Module, discriminator: torch.nn.Module, g_opt: OptaxAdamW,
    d_opt: OptaxAdamW, mel_cfg: MelConfig,
    adv_weight: float = 1.0, fm_weight: float = 2.0, mel_weight: float = 15.0,
):
    """(g_step, d_step): LSGAN updates, unguarded (a non-finite step is applied).

    ``d_step(mel, wav) → d_loss``; ``g_step(mel, wav) → (g_loss, (adv, fm, stft, mel_l1))``.
    """
    weights = (adv_weight, fm_weight, mel_weight)

    def d_step(mel: torch.Tensor, wav: torch.Tensor) -> float:
        loss = _d_loss(vocoder, discriminator, mel, wav)
        loss.backward()
        grads = _grads(d_opt.params)
        d_opt.update(grads, float(global_norm(grads)))
        return float(loss.detach())

    def g_step(mel: torch.Tensor, wav: torch.Tensor) -> tuple[float, tuple[float, ...]]:
        discriminator.requires_grad_(False)
        try:
            total, aux = _gan_losses(vocoder, discriminator, mel, wav, mel_cfg, weights)
            total.backward()
        finally:
            discriminator.requires_grad_(True)
        grads = _grads(g_opt.params)
        g_opt.update(grads, float(global_norm(grads)))
        return float(total.detach()), tuple(float(a.detach()) for a in aux)

    return g_step, d_step
