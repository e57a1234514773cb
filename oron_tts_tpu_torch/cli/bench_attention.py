"""Time the attention variants at the synthesis shape, one line each.

Counterpart of the JAX package's ``scripts/bench_attention.py``: q, k, v
``[B, H, T, D]`` bf16 with prefix ``kv_len = int(0.94 T)`` rounded down to 8
(1,560 of 1,664 keys by default)::

    python -m oron_tts_tpu_torch.cli.bench_attention [--t 1664] [--b 2] [--h 16]
        [--d 64] [--iters 20] [--backward] [--device cpu]

Rows: the card's matmul rate (a 4096³ bf16 ``torch.matmul``), the two
attention products alone with the ``[T, T]`` scores materialised (two
``torch.matmul``), the no-softmax kernel (``flash_nosm``), einsum attention
in plain tensor ops, the classic kernel with exp and with exp2, the packed
head-pair kernel, and with ``--backward`` forward + backward through
autograd for the classic kernels and for einsum. Each row chains ``iters``
calls, ``o + q`` feeding the next, as the JAX script's scan does, and is
timed with CUDA events (the host clock with ``--device cpu``, where the
kernels' plain versions run). TFLOP/s counts ``4·T²·D·B·H`` for every row,
as the JAX script does. The JAX script's stock Pallas row and its sweep of
the packed kernel's q block (a VMEM knob) have no counterpart.
"""

from __future__ import annotations

import argparse
import math
import sys
import time


def main(argv: list[str] | None = None) -> dict[str, float]:
    """Print the rows and the ``# best:`` line; return seconds per call by row."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--t", type=int, default=1664)
    ap.add_argument("--b", type=int, default=2)
    ap.add_argument("--h", type=int, default=16)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--backward", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from oron_tts_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_packed,
        flash_attention_trainable,
        flash_nosm,
    )
    from oron_tts_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    B, H, T, D = args.b, args.h, args.t, args.d
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# device={name} B={B} H={H} T={T} D={D}", file=sys.stderr)
    kv_len = int(T * 0.94) // 8 * 8
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(B, H, T, D, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    kv_lens = torch.full((B,), kv_len, dtype=torch.int32, device=dev)
    mask = torch.arange(T, device=dev)[None, :] < kv_lens[:, None]

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def chain(step, x0, n: int) -> float:
        """Seconds for ``n`` chained calls of ``step`` after one warm-up call."""
        step(x0)
        sync()
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        x = x0
        for _ in range(n):
            x = step(x)
        if dev.type == "cuda":
            stop.record()
            torch.cuda.synchronize()
            return start.elapsed_time(stop) / 1e3
        return time.perf_counter() - t0

    def einsum_attn(x, k_, v_):
        logits = torch.matmul(x.float(), k_.float().transpose(-1, -2)) * (1.0 / math.sqrt(D))
        logits = logits.masked_fill(~mask[:, None, None, :], -1e9)
        return torch.matmul(torch.softmax(logits, dim=-1).to(x.dtype), v_)

    results: dict[str, float] = {}
    flops = 4 * T * T * D * B * H

    def timed(label: str, op) -> float:
        with torch.no_grad():
            dt = chain(lambda x: (op(x, k, v) + q).to(q.dtype), q, args.iters) / args.iters
        print(f"{label:48s} {dt * 1e3:8.3f} ms   {flops / dt / 1e12:6.1f} TFLOP/s eff",
              flush=True)
        results[label] = dt
        return dt

    n = 4096
    a = torch.randn(n, n, generator=gen, device=dev).to(torch.bfloat16)
    bmat = (torch.randn(n, n, generator=gen, device=dev) / n).to(torch.bfloat16)
    with torch.no_grad():
        dt = chain(lambda x: torch.matmul(x, bmat), a, args.iters) / args.iters
    print(f"{f'peak sanity: {n}^3 bf16 matmul':48s} {dt * 1e3:8.3f} ms   "
          f"{2 * n ** 3 / dt / 1e12:6.1f} TFLOP/s", flush=True)
    del a, bmat

    def matmul_only(x, k_, v_):
        s = torch.matmul(x, k_.transpose(-1, -2))
        return torch.matmul(s, v_)

    timed("torch.matmul x2 (scores materialised)", matmul_only)
    timed("flash_nosm kernel (no softmax)", lambda x, k_, v_: flash_nosm(x, k_, v_))
    timed("einsum (plain tensor ops)", einsum_attn)
    timed("flash exp", lambda x, k_, v_: flash_attention(x, k_, v_, kv_lens=kv_lens,
                                                          use_exp2=False))
    timed("flash exp2", lambda x, k_, v_: flash_attention(x, k_, v_, kv_lens=kv_lens))
    timed("flash packed 2-head", lambda x, k_, v_: flash_attention_packed(
        x, k_, v_, kv_lens=kv_lens))

    if args.backward:
        def fwd_bwd(attn):
            def op(x, k_, v_):
                with torch.enable_grad():
                    xs, ks, vs = (t.detach().requires_grad_(True) for t in (x, k_, v_))
                    loss = (attn(xs, ks, vs).float() ** 2).sum()
                    g = torch.autograd.grad(loss, (xs, ks, vs))
                return g[0] + g[1] + g[2]
            return op

        timed("flash fwd+bwd (grads)", fwd_bwd(
            lambda x, k_, v_: flash_attention_trainable(x, k_, v_, kv_lens)))
        timed("einsum fwd+bwd (grads)", fwd_bwd(einsum_attn))

    best = min(results, key=results.get)
    print(f"# best: {best} ({results[best] * 1e3:.3f} ms)", file=sys.stderr, flush=True)
    return results


if __name__ == "__main__":
    main()
