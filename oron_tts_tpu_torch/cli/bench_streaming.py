"""Time to first audio (TTFA) of ``F5TTS.synthesize_stream`` (PyTorch port).

    python -m oron_tts_tpu_torch.cli.bench_streaming            # the card, Base, bf16
    python -m oron_tts_tpu_torch.cli.bench_streaming --device cpu --dim 64 --depth 2 \\
        --heads 2 --text-dim 32 --steps 2 --chars 200 --vocoder-dim 64 --vocoder-layers 2

Counterpart of the JAX package's ``scripts/bench_streaming.py``: a DiT with
seeded random weights, every tensor non-zero (Base: dim 1024, depth 22, bf16
on the card), and a
Vocos with seeded random weights installed through ``F5TTS.set_vocoder``; a
long Mongolian text (600 characters by default) that splits into chunks of
at most 120; 32 Euler steps with CFG. One warm-up pass (kernel builds, first
launches), then the best of three streams by total time. Reported: TTFA
(wall time until the first waveform piece is on the host), total (until the
last), pieces, audio seconds and RTF(total). Timing only: piece-against-
batch numerics are held by the tests and ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

WORDS = ("сайн байна уу та нар өнөөдөр хэрхэн байна вэ монгол улс "
         "сайхан орон юм шүү өргөн уудам тал нутаг").split()


def long_text(chars: int) -> str:
    text, i = "", 0
    while len(text) < chars:
        text += WORDS[i % len(WORDS)] + " "
        i += 1
    return text.strip()


def seeded_vocoder(torch, model, dim: int = 512, n_layers: int = 8, seed: int = 2):
    """A ``VocosDecoder`` (the default size unless given) and seeded weights, as the JAX
    bench's ``random_params_like``: matrices N(0, 0.02²), norm scales ones, biases zeros."""
    from oron_tts_tpu_torch.models.vocos import VocosDecoder

    a = model.config.audio
    module = VocosDecoder(n_mels=model.n_mels, dim=dim, n_layers=n_layers,
                          intermediate_dim=3 * dim, n_fft=a.n_fft, hop_length=a.hop_length)
    gen = torch.Generator().manual_seed(seed)
    state = {}
    for k, v in module.state_dict().items():
        if v.ndim >= 2:
            state[k] = torch.randn(v.shape, generator=gen) * 0.02
        else:  # a 1-D ".weight" is a LayerNorm scale
            state[k] = torch.ones_like(v) if k.endswith(".weight") else torch.zeros_like(v)
    return module, state


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description="Streaming time to first audio")
    ap.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    ap.add_argument("--dim", type=int, default=1024)
    ap.add_argument("--depth", type=int, default=22)
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--text-dim", type=int, default=512)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--chars", type=int, default=600)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--vocoder-dim", type=int, default=512)
    ap.add_argument("--vocoder-layers", type=int, default=8)
    args = ap.parse_args(argv)
    import torch

    from oron_tts_tpu_torch.config import F5Config
    from oron_tts_tpu_torch.models.f5tts import F5TTS, split_text_for_synthesis
    from oron_tts_tpu_torch.utils.device import card_name
    from oron_tts_tpu_torch.utils.weights import seeded_dit_params

    cfg = {"sample_rate": 24000, "n_mels": 100, "n_fft": 1024, "hop_length": 256,
           "model": {"dim": args.dim, "depth": args.depth, "heads": args.heads,
                     "dim_head": 64, "ff_mult": 4 if args.dim >= 512 else 2,
                     "text_dim": args.text_dim, "conv_layers": 4, "vocab_size": 65,
                     "p_dropout": 0.0}}
    model = F5TTS(F5Config.from_dict(cfg), device=args.device)
    model.load_params(seeded_dit_params(model.config.model, seed=2))
    model.set_vocoder(*seeded_vocoder(torch, model, args.vocoder_dim, args.vocoder_layers))
    text = long_text(args.chars)
    n_chunks = len(split_text_for_synthesis(text, 120))

    def run():
        t0 = time.perf_counter()
        ttfa, pieces = None, []
        for piece in model.synthesize_stream(text, n_steps=args.steps, seed=0):
            if ttfa is None:
                ttfa = time.perf_counter() - t0
            pieces.append(np.asarray(piece))
        total = time.perf_counter() - t0
        wav = np.concatenate(pieces)
        if not np.isfinite(wav).all():
            raise AssertionError("the stream produced non-finite samples")
        return ttfa, total, len(pieces), wav.shape[0] / model.sample_rate

    t0 = time.perf_counter()
    run()  # kernel builds and first launches
    warmup_s = time.perf_counter() - t0
    ttfa, total, n_pieces, audio_s = min((run() for _ in range(args.runs)), key=lambda r: r[1])
    payload = {"device": str(model.device), "card": card_name(model.device),
               "model": {"dim": args.dim, "depth": args.depth,
                         "dtype": str(model.dtype).replace("torch.", "")},
               "chars": len(text), "chunks": n_chunks, "steps": args.steps,
               "pieces": n_pieces, "audio_s": audio_s, "warmup_s": warmup_s,
               "ttfa_s": ttfa, "total_s": total, "ttfa_over_total": ttfa / total,
               "rtf_total": total / audio_s}
    print(f"text: {len(text)} chars, {n_chunks} chunks, {n_pieces} pieces, "
          f"{audio_s:.1f} audio-s\nTTFA {ttfa:.3f}s  total {total:.3f}s  "
          f"ttfa/total {ttfa / total:.2f}  RTF(total) {total / audio_s:.4f}")
    print(json.dumps(payload))
    return payload


if __name__ == "__main__":
    main()
