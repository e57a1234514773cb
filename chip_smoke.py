#!/usr/bin/env python3
"""Drive the PyTorch port's synthesis, training, serving, attention, data, vocoder, lever and mesh slices on one GPU.

Run from the repository root on a machine with a CUDA card::

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):

1. device: the card's name and power limit (``nvidia-smi``); TF32 off.
2. build: ``nvcc`` builds every kernel of ``oron_tts_tpu_torch/csrc`` into
   ``build/torch_kernels/`` (one process per source, in parallel, each
   timed); where ``cuobjdump`` is found, the count of HGMMA (wgmma)
   instructions in the SASS of each attention library, of the w8a16 one and
   of the grouped conv (each must hold some, and the w8a16 and conv ones no
   HMMA); the bf16 forward body's registers, spills and blocks an SM at
   each template width, with the shared memory a block asks for; the w8a16
   kernel's registers, spills, wgmma serialisation and blocks an SM at each
   tile; the conv kernel's at each group width and rows a block
   (``conv_build``); the log-mel kernel's at each n_fft (``mel_build``).
3. kernels: each kernel against its plain PyTorch version on the card at
   the slice's shapes, with its time, the plain version's, a PyTorch
   library call's where one computes the same function, and its bound
   (every time from calls launched one by one, as in earlier slices; the
   attention forwards and their library calls are also timed from a CUDA
   graph of the calls, ``graph_ms`` and ``library_graph_ms``, since a
   call's host side can outlast its kernel);
   the two attention backwards also with their two launches (pass A: dQ,
   pass B: dK and dV) timed apart, and called twice on the same inputs,
   which must give the same bits. The forwards (classic, packed, no-softmax
   and lanes) also at small shapes at every template width of the forward
   body, 16 to 256, and at head widths 20, 12 and 40, which the wrappers
   zero-pad (f32 and bf16, a ``kv_len = 0`` row, odd H); the classic
   backward at every width of its body to 128, at 40, 20 and 12, and in its
   wide variant at 136, 192 and 256 (also timed at 2,048 frames, heads of 192,
   256 and 320), the lanes one at 12 to 128 (with 2, 3, 5, 8 and 16 heads, a
   ``kv_len = 0`` row's gradients exactly zero); heads wider than 256 (264,
   320, 512 and 1,000: the kernels' wide bodies) through every classic
   kernel and the lanes forward, bf16 and f32, the backward twice for
   identical bits, and a lanes backward at 136 refused before any launch;
   the w8a16 kernel at ragged shapes and at the Base and Small projections
   for M = 1,664 to 13,312, timed one call at a time and from a CUDA graph
   beside bf16 ``F.linear``, its bias in the epilogue bit-equal to a
   separate add and two calls bit-equal, and ``QDense`` (int8) launching it
   alone; the grouped conv at group widths 4, 8, 16, 32, 64 and 128 and at
   ragged lengths (200, 60 and 1 frames), timed one call at a time and from
   a CUDA graph at the Base shape (its kernel row) and at the Small and
   training shapes (``cli.bench_conv``, ``conv_shapes``); the log-mel at
   ``[1, 240000]`` (10 s; timed one call at a time and from a CUDA graph,
   beside its plain cuFFT-based version both ways), at 30,001, 512, 300 and
   1 samples, as batches ``[8, 240000]`` (timed, with its bound) and
   ``[2, 3, 24000]`` in one launch each, at its other n_fft (256, 512 and
   2,048), on silence (log(1e-5)) and twice on one batch for identical
   bits; the trainer's fused AdamW + EMA + working copy (row 13) over Base's
   363 leaves, bit-equal to the eager update on one clipped step, timed with
   its launches' host time beside the eager update and ``torch._fused_adamw_``.
4. reference: a small f32 model on the card against the same model on the
   CPU (plain versions), same weights and noise: mel and waveform agree;
   then one training step of a small f32 model on both from the same
   weights, batch and generator seed, with heads of 64 and of 192: loss,
   gradient norm and update agree.
5. slice: ``F5TTS.synthesize`` at the Base width in bf16 with seeded DiT
   weights and the bundled vocoder, ref-free and voice-cloned, 32 steps,
   CFG 2; launch counts are zeroed just before each and read just after.
6. profile: one more synthesis of each kind under ``torch.profiler``: the
   device time by kernel kind, the device's idle share of the wall time and
   the number of kernels launched.
7. train: ``F5Trainer`` at the Base width in bf16 (seeded weights, dropout
   0.1, no rematerialisation) over a seeded synthetic ``TTSDataset`` of 24
   clips in batches of ``[12, 2048]`` frames: a warm-up epoch through
   ``train_epoch``, then timed steps with per-step launch counts (one fused
   update a step), one more
   step under ``torch.profiler``, and a checkpoint written and read back.
8. reference_serve: the small f32 model with int8 weights (``int8`` through
   the w8a16 kernel, ``int8_dynamic``) on the card against the CPU.
9. batch_knee: the per-row time of one ``synthesize_batch`` solve at 1 to 8
   rows of 832 frames (Base, bf16, 8 steps), the sweep
   ``F5TTS.GROUP_FRAME_BUDGET`` was set from (an earlier sweep also ran 16
   rows and rows of 1,600 frames; PERF.md keeps its readings).
10. serve: the HTTP server (``cli/serve.py``) in this process on 127.0.0.1 at
    the Base width cut to 11 blocks (since the mesh phase; ``CUT_DEPTH``),
    from a seeded checkpoint written to a temporary
    directory, three times: bf16, ``--quantize int8`` and ``--profile fast``.
    Each answers /healthz, a ref-free /synthesize, eight concurrent
    /synthesize that merge into one solve (each held against its solo
    audio), a voice-cloned request, a /synthesize_batch of four, a
    /synthesize_stream of three chunks (held against /synthesize; time to
    first audio), a 429 from a full queue and a drain. The int8 server's
    launch counts are zeroed before its requests and read after them, and
    one merged solve of each server is traced by ``torch.profiler``; then
    int8 against bf16 on that solve (per-row time, kernel 9's device time).
11. classic: the Base-width DiT at 11 blocks (``CUT_DEPTH``) rebuilt with
    ``attn_impl`` "flash" and "packed" from the seeded tree: ``CFM.sample`` + the vocoder under ``bench.py``'s
    protocol (120 letters, 1,560 frames, bucket 1,600, 32 steps, CFG 2) with
    the noise of a lanes solve, held against it; five ``F5Trainer`` steps on
    "flash" at ``[12, 2048]`` (two warm-up, three timed), the first step's
    loss held against the lanes model's on the same batch and generator
    seed, and one more step under ``torch.profiler``; then
    ``cli.bench_attention --t 1664 --backward`` and
    ``cli.bench_model_ablation`` as a user runs them. Launch counts are
    zeroed before each piece and read after it.
12. widths: ``F5TTS.synthesize`` at ``configs/local.yaml``'s width (the
    Small config: dim 512, the conv kernel at group width 32), two
    ``cli.train`` epochs on ``configs/test.yaml`` (head width 32 through the
    lanes kernels, the conv through ``F.conv1d``), and two ``F5Trainer``
    steps in bf16 on that config with dim 128 and one head (head width 128
    through the lanes kernels, the conv kernel at group width 8), two more
    with dim 384 and two heads of 192 (the classic "flash" kernels, the
    backward's wide variant), two more and a synthesis with dim 640 and two
    heads of 320 (the classic kernels' wide bodies), and one synthesis of
    that config with dim 128 and a DiT of 5 heads of width 20 (seeded
    weights; the lanes kernels with each head padded to 24), all on the
    card.
13. align: ``cli.eval_alignment`` (the tone-code quality eval) at the Small
    width, cut to 64 sentences (4 held out), 4 epochs and 8-step syntheses:
    bf16 training and synthesis on the card, the CERs each in [0, 1], the
    loss finite; launch counts are zeroed before and read after.
14. interop: the seeded Base-width weights at 11 blocks (``CUT_DEPTH``)
    exported by ``cli.export`` to ``.pt``
    and ``.safetensors`` and loaded back through ``cli.infer.load_model`` on
    the card, each file's mel bit-equal to the ``.npz`` load's (same seed);
    ``griffin_lim`` on the card against the CPU (within 1e-3 of the
    waveform's largest value); the bundled Vocos written in the official
    torch layout and loaded through the converter, decoding as the ``.npz``
    does (within 1e-5 of the largest value).
15. memory: ``F5Trainer`` steps on ``configs/runpod.yaml``'s model (Base,
    bf16, dropout 0.1) at ``[12, 2048]`` to ``[24, 2048]`` frames with
    rematerialisation off and on: each step's peak memory beside
    ``utils/memory.py``'s estimate, the constants the points imply,
    ``gradient_checkpointing: auto``'s choice for each shipped config that
    sets it, and one step at runpod's worst padded batch ``[24, 2816]`` with
    that choice; fails if the estimate falls below a measured peak.
16. serve_load: ``cli.bench_serve_load`` at its defaults but the depth (Base
    width at 11 blocks since the mesh phase, bf16, 32 clients, 96
    mixed-length requests, 32 steps, batches of up to 16), which
    must shed nothing, then 128 requests of 8 steps at once against a wait
    ceiling of 1.5 default solve estimates, which must answer 429s; every
    request is served in both.
17. streaming: ``cli.bench_streaming`` (Base width at 11 blocks, bf16, a
    seeded Vocos installed by ``set_vocoder``, 600 characters): time to
    first audio and total.
18. prepare: 24 seeded clips of 1.5-6 s through ``cli.prepare``'s record
    path (decode, spectral-gate denoise, peak normalization, silence trim,
    WAV, metadata), a seeded local Common Voice tar of WAV clips through
    ``cli.clean_local_cv``, one ``cli.train --from-local`` epoch on
    ``configs/test.yaml`` over the prepared clips and one more over them as
    bytes, then ``cli.test_pipeline`` on the card; the dataset's host
    log-mel must be the native one.

19. vocoder: the bundled Vocos scored by ``cli.eval_vocoder`` on the seeded
    out-of-distribution corpus (``cli.make_synthetic_speech --family ood -n
    40 --seed 123``, 32 clips of 2 s, with Griffin-Lim) against the
    reference's MR-STFT 1.0808 and mel-L1 0.2356 (within 0.003; Griffin-Lim
    1.2061 / 0.4034 within 0.03 / 0.015); ``cli.train_vocoder`` from scratch
    at full width (dim 512, 8 blocks, mag/phase, batches of 16 crops of 64
    frames) on a seeded 64-clip training corpus, 200 steps in windows of 25:
    every window finite, no step skipped, the last window's mean loss below
    the first's, one more window under ``torch.profiler``; the checkpoint
    loaded by ``F5TTS.load_vocoder`` decodes a mel; then the GAN stage
    (``--resume --gan --gan-start-step 200 --steps 250``): finite losses,
    both nets moved, the discriminator's checkpoint written.
20. grad_accum: ``cli.bench_grad_accum`` at its defaults (Base bf16, windows
    of 4 × ``[3, 2048]`` pipelined, with a host read after every
    micro-batch, and with remat, beside the fused ``[12, 2048]`` step),
    launch counts zeroed before and read after.
21. levers: ``cli.bench_sampler_levers`` at its defaults (the Base DiT at
    all 22 blocks, bf16, 120 letters in a bucket of 1,600, 32 Euler steps,
    CFG 2): baseline, no-hoist (``hoist_t_mods=False``), the CFG interval
    [0.10, 0.70], midpoint-16 with and without it, int8 w8a16, int8_dynamic
    w8a8 with and without it; each timed cold and best of three, one more
    solve of each traced; every mel finite, and no-hoist and the int8 cases
    held against their bf16 case by relative L2 (``LEVER_REL_L2_TOL``). Then
    ``cli.bench_quantized --e2e``: the three Base projections at M = 512,
    3,200 and 16,384 in bf16, w8a16 (kernel 9, held against its plain
    version at each shape) and w8a8, each from a CUDA graph, and Base
    synthesis in bf16, ``int8`` and ``int8_dynamic``. Launch counts zeroed
    before both and read after.
22. mesh: the ``("data", "model")`` mesh on the one card. A world of one
    on NCCL through the entry points, under ``python -m
    torch.distributed.run --nproc-per-node 1`` at Base bf16 from a seeded
    checkpoint: ``cli.train --mesh 1x1`` (two steps of ``[12, T ≤ 2048]``
    over 26 seeded clips; its step lines and parameters bit-equal to
    ``cli.train``'s trainer without a mesh on the same state, batches and
    generator seed, built in this process by the CLI's own helpers),
    ``cli.infer --mesh 1x1`` (a ref-free WAV bit-equal to ``cli.infer``
    without a mesh), ``cli.serve --mesh 1x1`` (/healthz with the mesh's
    shape, one /synthesize, eight concurrent that merge, a drain), and the
    step time at ``[12, 2048]`` (22 blocks) with a world-of-one mesh beside
    none. One rank under ``torchrun`` runs the three entry points' mains in
    turn (``chip_smoke.py --mesh-cli``), at 6 of the 22 blocks. Then two
    processes sharing the card over a gloo group this script initialises
    (NCCL refuses two ranks on one device): TP 2 (``make_mesh(1, 2)``: the
    lanes kernels at 8 heads), DP 2 and DP 2 with ZeRO-1, two steps each at
    a global ``[4, 2048]`` (Base bf16, dropout 0.1), the first step's loss
    and gradient norm held against one process (rel 1e-2 and 5e-2: one bf16
    forward and backward whose row-parallel sums or rows are split), each
    rank's peak memory; and a TP-2 ref-free 4-step ``synthesize_mel`` against
    one process (rel L2 0.1). Their step times are gloo staging through the
    host, not scaling. Kernels 10/11 on column, row and 2 × 2 shards run in
    the kernels phase (``kernel_shard``).

Then the kernel table and, last, ``{"ok": true, "device": {...}}``.
Without CUDA it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

H100_BF16_FLOPS = 989e12  # dense tensor-core peak, SXM data sheet
H100_F32_FLOPS = 67e12    # CUDA-core f32 peak
H100_BYTES = 3.35e12      # HBM3 bytes/s
SERVE_STEPS = 32
MN_TEXT = "Монгол хэл бол Төв Азийн өргөн уудам нутагт олон сая хүний ярьдаг хэл юм."
REF_TEXT = "Өнөөдөр цаг агаар сайхан байна"
# Since the mesh phase (22) the serve, classic, interop, serve_load and streaming
# phases run the Base width at half its depth, to keep the whole script inside
# its time limit; their full-depth readings stay in PERF.md
CUT_DEPTH = 11


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def cuda_graph_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn()``: ``iters`` calls captured in one CUDA graph
    and replayed, timed with CUDA events. Calls shorter than their host-side
    launch (a wrapper's checks and the ``ctypes`` call, some 40 us) would
    make :func:`cuda_ms` time the host; a replay launches them back to back."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(stop) / (3 * iters)


def bound_ms(flops: float, peak: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / H100_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def sdpa_by_backend(torch, F, qh, kh, vh, mask, timer=cuda_ms) -> dict[str, float | str]:
    """SDPA's time under each backend it offers (by ``timer``); a backend
    that refuses a bool mask at these shapes is recorded with its refusal,
    not timed."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    out: dict[str, float | str] = {}
    for name in ("MATH", "EFFICIENT_ATTENTION", "FLASH_ATTENTION", "CUDNN_ATTENTION"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        try:
            with sdpa_kernel([backend]):
                out[name] = timer(lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=mask))
        except RuntimeError as exc:  # a yardstick only: the port never calls SDPA
            out[name] = "refused: " + str(exc).splitlines()[0][:80]
    return out


def fastest(times: dict[str, float | str]) -> tuple[str, float]:
    name = min((k for k, v in times.items() if isinstance(v, float)), key=lambda k: times[k])
    return name, times[name]


def forward_times(fn) -> dict[str, float]:
    """An attention forward's time launched one by one and from a CUDA graph."""
    return {"ms": cuda_ms(fn), "graph_ms": cuda_graph_ms(fn)}


def sdpa_yardstick(torch, F, qh, kh, vh, mask) -> dict:
    """SDPA's fastest backend, timed both ways as the forward beside it."""
    per_call = sdpa_by_backend(torch, F, qh, kh, vh, mask)
    graphed = sdpa_by_backend(torch, F, qh, kh, vh, mask, timer=cuda_graph_ms)
    best, best_ms = fastest(per_call)
    graph_best, graph_ms = fastest(graphed)
    return {"library_ms": best_ms, "library": "SDPA " + best, "sdpa_ms_by_backend": per_call,
            "library_graph_ms": graph_ms, "library_graph": "SDPA " + graph_best,
            "sdpa_graph_ms_by_backend": graphed}


def backward_passes(torch, kind, q, k, v, lens, out, do, lse=None, heads=None) -> dict:
    """The bf16 backward's two launches timed apart (CUDA events).

    Pass A (dQ, with delta and, for the classic kernel, the recomputed lse2)
    and pass B (dK, dV) are launched through the library directly, so the
    wrappers' launch counts do not move; pass B reads the scratch a full call
    left first. ``kind`` is "lanes" or "classic".
    """
    from oron_tts_tpu_torch.ops import _build

    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    stream = _build.stream_ptr(q.device)
    if kind == "lanes":
        B, T, HD = q.shape
        delta = torch.empty((B, heads, T), dtype=torch.float32, device=q.device)
        lib = _build.load("flash_lanes_bwd")

        def call(passes):
            _build.check(lib.flash_lanes_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
                lse.data_ptr(), lens.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), B, T, heads, HD // heads, 1.0 / math.sqrt(HD // heads), 1, passes,
                stream), "flash_lanes_bwd")
    else:
        B, H, T, D = q.shape
        lse2 = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
        delta = torch.empty_like(lse2)
        lib = _build.load("flash_classic_bwd")

        def call(passes):
            _build.check(lib.flash_classic_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
                lens.data_ptr(), lse2.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), B, H, T, D, 1.0 / math.sqrt(D), 1, passes, stream),
                "flash_classic_bwd")
    call(3)
    return {"pass_a_ms": cuda_ms(lambda: call(1), iters=5),
            "pass_b_ms": cuda_ms(lambda: call(2), iters=5)}


def bit_identical(first, second) -> bool:
    import torch

    return all(torch.equal(a, b) for a, b in zip(first, second))


WGMMA_LIBS = ("flash_lanes", "flash_classic", "flash_lanes_bwd", "flash_classic_bwd", "qmm",
              "grouped_conv")
NO_HMMA_LIBS = ("qmm", "grouped_conv")  # their bf16 tensor-core paths are wgmma alone


def hgmma_counts(libs: dict) -> dict:
    """HGMMA (wgmma) and HMMA (mma.sync) instructions in the SASS of each
    library built on wgmma, by kernel. Each must hold some HGMMA; the w8a16
    and grouped-conv libraries must hold no HMMA."""
    import os
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {"cuobjdump": "not found"}
    counts = {}
    for name in WGMMA_LIBS:
        run = subprocess.run([tool, "-sass", str(libs[name])], capture_output=True, text=True)
        if run.returncode != 0:
            counts[name] = "cuobjdump failed: " + run.stderr.strip()[:200]
            continue
        sass, per_fn = run.stdout, {}
        for chunk in sass.split("Function : ")[1:]:
            n = chunk.count("HGMMA")
            if n:
                per_fn[chunk.split("\n", 1)[0].strip()] = n
        hmma = sum(1 for line in sass.splitlines() if "HMMA." in line)
        counts[name] = {"total": sum(per_fn.values()), "hmma": hmma, "by_kernel": per_fn}
        if not per_fn:
            raise AssertionError(f"{name}: no HGMMA instruction in its SASS")
        if name in NO_HMMA_LIBS and hmma:
            raise AssertionError(f"{name}: {hmma} HMMA (mma.sync) instructions remain in its SASS")
    return counts


def qmm_build(log: str) -> dict:
    """Registers, spills and ptxas's wgmma serialisation notes of the w8a16
    kernel at each tile (``-Xptxas -v`` of ``qmm``), and the blocks an SM holds
    (the occupancy API)."""
    import re

    from oron_tts_tpu_torch.ops import _build
    from oron_tts_tpu_torch.ops.quantized_matmul import QMM_TILES

    tiles, current = {}, None
    for line in log.splitlines():
        m = re.search(r"qmm_wgmmaILi(\d+)E", line)
        if m:
            current = tiles.setdefault(int(m.group(1)), {"wgmma_serialised": False})
            if "C7512" in line or "serialized" in line:
                current["wgmma_serialised"] = True
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            current["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
            current = None
    lib = _build.load("qmm")
    for bm in QMM_TILES:
        row = tiles.setdefault(bm, {})
        row["blocks_per_sm"] = lib.qmm_blocks_per_sm(bm)
        if row["blocks_per_sm"] < 1:
            raise AssertionError(f"the w8a16 kernel at tile {bm} fits no SM: {row}")
    return {str(k): tiles[k] for k in sorted(tiles)}


def forward_build(log: str) -> dict:
    """Registers and spills of the bf16 forward body at each template width
    (``-Xptxas -v`` of ``flash_classic``; the lanes library builds the same
    kernel), the blocks an SM holds (the occupancy API), and the dynamic
    shared memory a block asks for, computed as ``FwdSmem<DP>::BYTES`` is
    (ptxas reports static shared memory only, and the body has none)."""
    import re

    from oron_tts_tpu_torch.ops import _build

    widths, current = {}, None
    for line in log.splitlines():
        m = re.search(r"entry function '(_ZN4oron4attn14attn_fwd_wgmmaILi(\d+)ELi(\d)E\S*)'", line)
        if m:
            current = (int(m.group(2)), "nosm" if m.group(3) == "2" else "softmax")
            continue
        if current is None:
            continue
        row = widths.setdefault(current[0], {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            row[current[1] + "_spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            row[current[1] + "_registers"] = int(m.group(1))
            current = None
    lib = _build.load("flash_classic")
    for dp in range(16, 257, 16):
        row = widths.setdefault(dp, {})
        row["smem_bytes_computed"] = 2 * (128 + 5 * 64) * dp
        row["blocks_per_sm"] = lib.flash_fwd_blocks_per_sm(dp)
        if row["blocks_per_sm"] < 1:
            raise AssertionError(f"the forward at width {dp} fits no SM: {row}")
    return {str(k): widths[k] for k in sorted(widths)}


def conv_build(log: str) -> dict:
    """Registers and spills of the bf16 grouped-conv kernel at each group
    width and rows a block (``-Xptxas -v`` of ``grouped_conv``), the blocks an
    SM holds at 31 taps (the occupancy API) and the dynamic shared memory a
    block asks for, computed as ``conv_smem`` does (ptxas reports static
    shared memory only, and the kernel has none)."""
    import re

    from oron_tts_tpu_torch.ops import _build
    from oron_tts_tpu_torch.ops.grouped_conv import WGMMA_GROUP_WIDTHS

    tiles, current = {}, None
    for line in log.splitlines():
        m = re.search(r"gconv_wgmmaILi(\d+)ELi(\d)E", line)
        if m:
            current = tiles.setdefault((int(m.group(1)), 128 * int(m.group(2))), {})
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            current["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
            current = None
    lib = _build.load("grouped_conv")
    for width in WGMMA_GROUP_WIDTHS:
        bm = 256 if width <= 64 else 128  # rows a block, as grouped_conv.cu picks them
        row = tiles.setdefault((width, bm), {})
        taps = max(1, 128 // width)  # a ring slot's taps; four slots
        row["smem_bytes_computed"] = 2 * (4 * taps * width * width
                                          + (bm + -(-31 // taps) * taps - 1) * width)
        row["blocks_per_sm"] = lib.grouped_conv_blocks_per_sm(width, 31)
        if row["blocks_per_sm"] < 1:
            raise AssertionError(f"the conv at width {width}, {bm} rows fits no SM: {row}")
    return {f"{w}x{bm}": tiles[(w, bm)] for w, bm in sorted(tiles)}


def mel_build(log: str) -> dict:
    """Registers and spills of the log-mel kernel at each n_fft (``-Xptxas
    -v`` of ``fused_mel``; the instance is named by M = n_fft / 2)."""
    import re

    by_n_fft, current = {}, None
    for line in log.splitlines():
        m = re.search(r"log_mel_kernelILi(\d+)E", line)
        if m:
            current = by_n_fft.setdefault(2 * int(m.group(1)), {})
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            current["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
            current = None
    return dict(sorted(by_n_fft.items()))


TRAIN_B, TRAIN_T = 12, 2048  # the single-chip training shape (Base, bf16)


def train_clip_frames() -> list[int]:
    """24 seeded clip lengths in frames, 12 s to 21.8 s; clips 0 and 12 the longest."""
    import numpy as np

    frames = np.random.default_rng(5).integers(1125, TRAIN_T, size=24)
    frames[::TRAIN_B] = TRAIN_T
    return [int(f) for f in frames]


def check_train_kernels(torch, F, report) -> list[dict]:
    """Kernels 4, 5, 10, 11 at the training shapes against their plain versions."""
    from oron_tts_tpu_torch.ops.flash_attention import (
        flash_lanes_bwd,
        flash_lanes_bwd_plain,
        flash_lanes_fwd,
        flash_lanes_fwd_stats,
        flash_lanes_fwd_stats_plain,
    )
    from oron_tts_tpu_torch.ops.gelu_dropout import (
        gelu_dropout_bwd,
        gelu_dropout_bwd_plain,
        gelu_dropout_fwd,
        gelu_dropout_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rows = []
    src_fwd = "oron_tts_tpu_torch/csrc/flash_lanes.cu"
    src_bwd = "oron_tts_tpu_torch/csrc/flash_lanes_bwd.cu"
    src_gd = "oron_tts_tpu_torch/csrc/gelu_dropout.cu"

    def attention_case(B, T, H, lens, dtype, rel_tol, shape_tag=None, timed=False):
        D = 64
        out_tol = 5e-3 if dtype == torch.bfloat16 else 2e-4  # flash_lanes_fwd's tolerances
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        q, k, v, do = (torch.randn(B, T, H * D, generator=gen, device=dev).to(dtype)
                       for _ in range(4))
        out, lse = flash_lanes_fwd_stats(q, k, v, lens_t, H)
        same = torch.equal(out, flash_lanes_fwd(q, k, v, lens_t, H))
        ref_out, ref_lse = flash_lanes_fwd_stats_plain(q.float(), k.float(), v.float(), lens_t, H)
        dq, dk, dv = flash_lanes_bwd(q, k, v, lens_t, out, do, lse, H)
        same_bits = bit_identical((dq, dk, dv), flash_lanes_bwd(q, k, v, lens_t, out, do, lse, H))
        refs = flash_lanes_bwd_plain(q.float(), k.float(), v.float(), lens_t, out.float(),
                                     do.float(), lse, H)
        torch.cuda.synchronize()
        if not same_bits:
            raise AssertionError(f"flash_lanes_bwd ({dtype}): two calls differ")
        if not same:
            raise AssertionError("flash_lanes_fwd_stats and flash_lanes_fwd outputs differ")
        tag = {} if shape_tag is None else {"shape": shape_tag}
        fwd_row = {"name": "flash_lanes_fwd_stats", "dtype": str(dtype), **tag,
                   "out_bit_equal_to_fwd": same,
                   "out_max_abs_err": (out.float() - ref_out).abs().max().item(),
                   "out_tol": out_tol,
                   "max_abs_err": (lse - ref_lse).abs().max().item(), "tol": 1e-4}
        # each gradient is held to rel_tol of its own reference's largest value
        names = ("dq", "dk", "dv")
        errs = {n: (a.float() - r).abs().max().item() for n, a, r in zip(names, (dq, dk, dv), refs)}
        tols = {n + "_tol": rel_tol * r.abs().max().item() for n, r in zip(names, refs)}
        bwd_row = {"name": "flash_lanes_bwd", "dtype": str(dtype), **tag, **errs, **tols,
                   "max_abs_err": max(errs.values()), "tol": max(tols.values()),
                   "bit_identical_twice": same_bits}
        if timed:
            kept = float(lens_t.clamp(max=T).sum())
            qh, kh, vh, doh = (x.view(B, T, H, D).transpose(1, 2).contiguous().requires_grad_(
                x is not do) for x in (q, k, v, do))
            mask = (torch.arange(T, device=dev)[None, :] < lens_t[:, None])[:, None, None, :]
            yardstick = sdpa_yardstick(torch, F, qh.detach(), kh.detach(), vh.detach(), mask)
            best = yardstick["library"].removeprefix("SDPA ")
            from torch.nn.attention import SDPBackend, sdpa_kernel

            with sdpa_kernel([getattr(SDPBackend, best)]):
                lib_out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
                lib_bwd = cuda_ms(lambda: torch.autograd.grad(
                    lib_out, (qh, kh, vh), doh, retain_graph=True), iters=5)
            del lib_out
            nb = q.numel() * 2
            b_ms, b_by = bound_ms(4.0 * T * H * D * kept, H100_BF16_FLOPS,
                                  4 * nb + lse.numel() * 4 + lens_t.numel() * 4)
            fwd_row.update(
                **forward_times(lambda: flash_lanes_fwd_stats(q, k, v, lens_t, H)),
                plain_ms=cuda_ms(lambda: flash_lanes_fwd_stats_plain(q, k, v, lens_t, H), iters=3),
                **yardstick,
                bound_ms=b_ms, bound_by=b_by, route="cuda", source=src_fwd,
                replaces="oron_tts_tpu/ops/flash_attention.py:424")
            b_ms, b_by = bound_ms(10.0 * T * H * D * kept, H100_BF16_FLOPS,
                                  8 * nb + lse.numel() * 4 + lens_t.numel() * 4)
            bwd_row.update(
                ms=cuda_ms(lambda: flash_lanes_bwd(q, k, v, lens_t, out, do, lse, H), iters=5),
                plain_ms=cuda_ms(lambda: flash_lanes_bwd_plain(
                    q, k, v, lens_t, out, do, lse, H), iters=3),
                library_ms=lib_bwd, library="autograd backward of SDPA " + best,
                bound_ms=b_ms, bound_by=b_by, route="cuda", source=BWD_SRC, entry=src_bwd,
                replaces="oron_tts_tpu/ops/flash_attention.py:528",
                **backward_passes(torch, "lanes", q, k, v, lens_t, out, do, lse, H))
            rows.extend([fwd_row, bwd_row])
        report(fwd_row)
        report(bwd_row)
        if not fwd_row["out_max_abs_err"] <= out_tol:
            raise AssertionError(f"flash_lanes_fwd_stats ({dtype}) output off by "
                                 f"{fwd_row['out_max_abs_err']}")
        for n in names:
            if not errs[n] <= tols[n + "_tol"]:
                raise AssertionError(f"flash_lanes_bwd ({dtype}) {n} off by {errs[n]}, "
                                     f"tolerance {tols[n + '_tol']}")

    # the training shape, ragged kv_lens >= 1: f32 once small, bf16 timed
    attention_case(3, 200, 4, [200, 137, 1], torch.float32, 2e-4, "edge T=200")
    attention_case(3, 200, 4, [200, 137, 1], torch.bfloat16, 1e-2, "edge T=200")
    attention_case(2, 832, 16, [832, 755], torch.float32, 2e-4, "T=832")
    attention_case(TRAIN_B, TRAIN_T, 16, train_clip_frames()[:TRAIN_B], torch.bfloat16, 1e-2,
                   timed=True)

    # the conv's training pair at the training shape: the kernel's forward,
    # held against its plain version in f32 on the same bf16 values, and the
    # backward the Function takes through the library reference (no kernel)
    from oron_tts_tpu_torch.ops.grouped_conv import (
        grouped_conv1d_mish,
        grouped_conv1d_mish_grad,
        grouped_conv1d_mish_plain,
    )

    xc = torch.randn(TRAIN_B, TRAIN_T, 1024, generator=gen, device=dev).to(torch.bfloat16)
    wc = (torch.randn(31, 64, 1024, generator=gen, device=dev) / 44.5).to(torch.bfloat16)
    bc = (0.1 * torch.randn(1024, generator=gen, device=dev)).to(torch.bfloat16)
    report({"name": "grouped_conv1d_mish", "dtype": "torch.bfloat16",
            "shape": [TRAIN_B, TRAIN_T, 1024], "tol": 2e-2,
            "max_abs_err": (grouped_conv1d_mish(xc, wc, bc, 16).float() - grouped_conv1d_mish_plain(
                xc.float(), wc.float(), bc.float(), 16)).abs().max().item()})
    for leaf in (xc, wc, bc):
        leaf.requires_grad_(True)
    yc = grouped_conv1d_mish_grad(xc, wc, bc, 16)
    dyc = torch.randn_like(yc)
    emit({"phase": "conv_training_pair", "shape": [TRAIN_B, TRAIN_T, 1024],
          "forward_kernel_ms": cuda_ms(lambda: grouped_conv1d_mish_grad(xc, wc, bc, 16)),
          "backward_reference_ms": cuda_ms(lambda: torch.autograd.grad(
              yc, (xc, wc, bc), dyc, retain_graph=True), iters=5)})
    del xc, wc, bc, yc, dyc

    # GELU + dropout at [B*T, 4*dim]; the mask is read off a positive input,
    # where a zero can only be a dropped element
    seed, rate = -1234567, 0.1
    for shape, dtype in (((5, 7, 33), torch.float32), ((5, 7, 33), torch.bfloat16),
                         ((TRAIN_B * TRAIN_T, 4096), torch.float32),
                         ((TRAIN_B * TRAIN_T, 4096), torch.bfloat16)):
        x = torch.randn(*shape, generator=gen, device=dev).to(dtype)
        dy = torch.randn(*shape, generator=gen, device=dev).to(dtype)
        pos = x.abs() + 0.5
        mask_equal = (
            torch.equal(gelu_dropout_fwd(pos, seed, rate) == 0, gelu_dropout_plain(pos, seed, rate) == 0)
            and torch.equal(gelu_dropout_bwd(pos, pos, seed, rate) == 0,
                            gelu_dropout_bwd_plain(pos, pos, seed, rate) == 0))
        dropped = (gelu_dropout_fwd(pos, seed, rate) == 0).float().mean().item()
        del pos
        # bf16: one rounding of the storage type, relative to the value; f32:
        # 1e-5 of (|value| + 1), as tanhf and fused multiply-adds differ from
        # the plain ops by a few ulp, more where dGELU's terms cancel
        ulp, floor = (2.0 ** -7, 1e-3) if dtype == torch.bfloat16 else (1e-5, 1.0)
        big = len(shape) == 2
        for name, got, ref, line in (
            ("gelu_dropout_fwd", gelu_dropout_fwd(x, seed, rate),
             gelu_dropout_plain(x, seed, rate), 76),
            ("gelu_dropout_bwd", gelu_dropout_bwd(x, dy, seed, rate),
             gelu_dropout_bwd_plain(x, dy, seed, rate), 87),
        ):
            diff = (got.float() - ref.float()).abs()
            rel = (diff / (ref.float().abs() + floor)).max().item()
            row = {"name": name, "dtype": str(dtype), "shape": list(shape),
                   "mask_equal": mask_equal, "dropped_share": dropped,
                   "max_abs_err": diff.max().item(), "max_rel_err": rel, "tol": ulp,
                   "tol_on": "max_rel_err"}
            del diff
            if not mask_equal:
                raise AssertionError(f"{name}: the dropout mask differs from the plain version")
            if big and dtype == torch.bfloat16:
                bwd = name.endswith("bwd")
                xs = x.clone().requires_grad_(True)
                if bwd:
                    lib_y = F.dropout(F.gelu(xs, approximate="tanh"), rate)
                    lib_ms = cuda_ms(lambda: torch.autograd.grad(lib_y, xs, dy, retain_graph=True))
                    del lib_y
                    k_ms = cuda_ms(lambda: gelu_dropout_bwd(x, dy, seed, rate))
                    p_ms = cuda_ms(lambda: gelu_dropout_bwd_plain(x, dy, seed, rate), iters=3)
                else:
                    lib_ms = cuda_ms(lambda: F.dropout(F.gelu(x, approximate="tanh"), rate))
                    k_ms = cuda_ms(lambda: gelu_dropout_fwd(x, seed, rate))
                    p_ms = cuda_ms(lambda: gelu_dropout_plain(x, seed, rate), iters=3)
                n = x.numel()
                b_ms, b_by = bound_ms((40.0 if bwd else 25.0) * n, H100_F32_FLOPS,
                                      (3 if bwd else 2) * n * 2)
                row.update(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                           library="F.dropout(F.gelu(tanh))" + (" autograd backward" if bwd else ""),
                           bound_ms=b_ms, bound_by=b_by, route="cuda", source=src_gd,
                           replaces=f"oron_tts_tpu/ops/gelu_dropout.py:{line}")
                rows.append(row)
            emit({"phase": "kernel", **row})
            if not rel <= ulp:
                raise AssertionError(f"{name} ({dtype}) off by {rel} relative")
    check_gelu_shards(torch, gen, dev, seed, rate)
    return rows


# [rows, 4·dim] of a Base FFN at [12, 2048] frames; the shards a mesh rank holds
GELU_SHARDS = {"column": (slice(None), slice(2048, 4096)),
               "row": (slice(12288, 24576), slice(None)),
               "2x2": (slice(12288, 24576), slice(0, 2048))}


def check_gelu_shards(torch, gen, dev, seed: int, rate: float) -> None:
    """Kernels 10/11 on shards placed by global index: bit-equal to the full call's slice.

    A column shard (tensor parallelism), a row shard (data parallelism) and
    a 2 × 2 shard of ``[24576, 4096]`` bf16, forward and backward; each
    shard's output and mask equal the same slice of one call over the whole
    tensor, bit for bit. The column shard runs the kernel's division path,
    timed beside the whole call.
    """
    from oron_tts_tpu_torch.ops.gelu_dropout import gelu_dropout_bwd, gelu_dropout_fwd

    shape = (TRAIN_B * TRAIN_T, 4096)
    x = torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)
    dy = torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)
    full_y, full_dx = gelu_dropout_fwd(x, seed, rate), gelu_dropout_bwd(x, dy, seed, rate)
    full_ms = cuda_ms(lambda: gelu_dropout_fwd(x, seed, rate))
    for name, (rows, cols) in GELU_SHARDS.items():
        xs, dys = x[rows, cols].contiguous(), dy[rows, cols].contiguous()
        place = dict(row0=rows.start or 0, gcols=shape[1], col0=cols.start or 0)
        y = gelu_dropout_fwd(xs, seed, rate, **place)
        dx = gelu_dropout_bwd(xs, dys, seed, rate, **place)
        same = (torch.equal(y, full_y[rows, cols]) and torch.equal(dx, full_dx[rows, cols])
                and torch.equal(y == 0, full_y[rows, cols] == 0))
        emit({"phase": "kernel_shard", "name": "gelu_dropout", "shard": name,
              "shape": list(xs.shape), "place": place, "bit_equal_to_full_slice": same,
              "ms": cuda_ms(lambda: gelu_dropout_fwd(xs, seed, rate, **place)),
              "whole_call_ms": full_ms, "whole_shape": list(shape)})
        if not same:
            raise AssertionError(f"gelu_dropout on the {name} shard differs from the full "
                                 "call's slice")
    del x, dy, full_y, full_dx


def check_kernels(torch, F) -> list[dict]:
    from oron_tts_tpu_torch.config import ModelConfig
    from oron_tts_tpu_torch.ops.flash_attention import flash_lanes_fwd, flash_lanes_plain
    from oron_tts_tpu_torch.ops.fused_mel import KERNEL_N_FFT, log_mel_fused, log_mel_plain
    from oron_tts_tpu_torch.ops.grouped_conv import (
        grouped_conv1d_mish,
        grouped_conv1d_mish_plain,
        mish,
    )
    from oron_tts_tpu_torch.ops.mel import MelConfig, mel_constants
    from oron_tts_tpu_torch.utils.weights import seeded_dit_params

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = []

    def report(row: dict) -> None:
        emit({"phase": "kernel", **row})
        key = row.get("tol_on", "max_abs_err")
        if not row[key] <= row["tol"]:
            raise AssertionError(f"{row['name']} ({row['dtype']}) off by {row[key]} ({key})")

    # 1. lanes attention: q/k/v [2, 832, 1024], kv_lens [832, 755]
    B, T, H, D = 2, 832, 16, 64
    lens = torch.tensor([832, 755], dtype=torch.int32, device=dev)
    # bf16: the plain version in f32 on the same (already rounded) inputs, so
    # the error is the kernel's own (P rounded to bf16, one output rounding)
    for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 5e-3)):
        q, k, v = (torch.randn(B, T, H * D, generator=gen, device=dev).to(dtype) for _ in range(3))
        out = flash_lanes_fwd(q, k, v, lens, H)
        ref = flash_lanes_plain(q.float(), k.float(), v.float(), lens, H)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        row = {"name": "flash_lanes_fwd", "dtype": str(dtype), "max_abs_err": err, "tol": tol}
        if dtype == torch.bfloat16:
            qh, kh, vh = (x.view(B, T, H, D).transpose(1, 2).contiguous() for x in (q, k, v))
            mask = (torch.arange(T, device=dev)[None, :] < lens[:, None])[:, None, None, :]
            flops = 4.0 * T * H * D * float(lens.clamp(max=T).sum())
            b_ms, b_by = bound_ms(flops, H100_BF16_FLOPS, 4 * q.numel() * 2 + lens.numel() * 4)
            row.update(
                **forward_times(lambda: flash_lanes_fwd(q, k, v, lens, H)),
                plain_ms=cuda_ms(lambda: flash_lanes_plain(q, k, v, lens, H)),
                bound_ms=b_ms, bound_by=b_by,
                route="cuda", source="oron_tts_tpu_torch/csrc/flash_lanes.cu",
                replaces="oron_tts_tpu/ops/flash_attention.py:387",
            )
            # the library yardstick: SDPA under each backend, the fastest kept
            row.update(sdpa_yardstick(torch, F, qh, kh, vh, mask))
            rows.append(row)
        report(row)

    # 2. grouped conv + Mish: x [2, 832, 1024], Base conv weights [31, 64, 1024]
    p = seeded_dit_params(ModelConfig(), seed=0)["input_embed"]["conv_pos_embed"]["conv1"]
    C, G = 1024, 16
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        x = torch.randn(B, T, C, generator=gen, device=dev).to(dtype)
        w = torch.from_numpy(p["kernel"]).to(dev, dtype)
        bias = torch.from_numpy(p["bias"]).to(dev)
        out = grouped_conv1d_mish(x, w, bias, G)
        # the plain version in f32 on the same (already rounded) values; the
        # kernel also sums in f32 and rounds once, at its output
        ref = grouped_conv1d_mish_plain(x.float(), w.float(), bias, G)
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        row = {"name": "grouped_conv1d_mish", "dtype": str(dtype), "max_abs_err": err, "tol": tol}
        if dtype == torch.bfloat16:
            xt = x.transpose(1, 2).contiguous()
            wt = w.permute(2, 1, 0).contiguous()
            bt = bias.to(dtype)
            K, cin_g = w.shape[0], w.shape[1]
            flops = 2.0 * B * T * C * cin_g * K
            nbytes = 2 * x.numel() * 2 + w.numel() * 2 + bias.numel() * 4
            b_ms, b_by = bound_ms(flops, H100_BF16_FLOPS, nbytes)
            row.update(
                **forward_times(lambda: grouped_conv1d_mish(x, w, bias, G)),
                plain_ms=cuda_ms(lambda: grouped_conv1d_mish_plain(x, w, bias, G)),
                library_ms=cuda_ms(lambda: mish(F.conv1d(xt, wt, bt, padding=K // 2, groups=G))),
                library="F.conv1d groups 16 + Mish",
                bound_ms=b_ms, bound_by=b_by,
                route="cuda", source="oron_tts_tpu_torch/csrc/grouped_conv.cu",
                replaces="oron_tts_tpu/ops/grouped_conv.py:34",
            )
            rows.append(row)
        report(row)

    # ragged edges: T not a multiple of any tile, a row with every key masked
    lens3 = torch.tensor([200, 137, 0], dtype=torch.int32, device=dev)
    for dtype, tol, conv_tol in ((torch.float32, 2e-4, 2e-4), (torch.bfloat16, 5e-3, 2e-2)):
        q, k, v = (torch.randn(3, 200, 256, generator=gen, device=dev).to(dtype) for _ in range(3))
        err = (flash_lanes_fwd(q, k, v, lens3, 4).float()
               - flash_lanes_plain(q.float(), k.float(), v.float(), lens3, 4)).abs().max().item()
        report({"name": "flash_lanes_fwd", "dtype": str(dtype), "shape": "edge T=200",
                "max_abs_err": err, "tol": tol})
        x = torch.randn(1, 200, C, generator=gen, device=dev).to(dtype)
        w = torch.from_numpy(p["kernel"]).to(dev, dtype)
        err = (grouped_conv1d_mish(x, w, bias, G).float()
               - grouped_conv1d_mish_plain(x.float(), w.float(), bias, G)).abs().max().item()
        report({"name": "grouped_conv1d_mish", "dtype": str(dtype), "shape": "edge T=200",
                "max_abs_err": err, "tol": conv_tol})

    # the conv at the Small and training shapes (the Base one is its kernel
    # row above), as cli.bench_conv times them: one call at a time, from a
    # CUDA graph, F.conv1d + Mish, the bound
    from oron_tts_tpu_torch.cli import bench_conv

    for conv_row in bench_conv.bench(["small", "train"]):
        emit({"phase": "conv_shapes", **conv_row})

    # 3. fused log-mel: 10 s of seeded noise at 24 kHz, [1, 240000]
    cfg = MelConfig()
    window, fb = mel_constants(cfg)
    taps = int((fb != 0).sum())

    def mel_bound(audio, out) -> tuple[float, str]:
        # the least work for the function: window, a real FFT (2.5 N log2 N),
        # magnitudes, the filterbank's non-zero taps (its triangles overlap
        # only pairwise) and the log a frame; bytes: audio, output, window and
        # those taps
        per_frame = (cfg.n_fft + 2.5 * cfg.n_fft * math.log2(cfg.n_fft) + 3.0 * cfg.n_freqs
                     + 2.0 * taps + cfg.n_mels)
        nbytes = (audio.numel() + out.numel() + window.size + taps) * 4
        return bound_ms(out.numel() // cfg.n_mels * per_frame, H100_F32_FLOPS, nbytes)

    def mel_case(shape, timed=False) -> dict:
        audio = 0.3 * torch.randn(*shape, generator=gen, device=dev)
        out = log_mel_fused(audio, cfg)
        ref = log_mel_plain(audio, cfg)
        torch.cuda.synchronize()
        row = {"name": "log_mel_fused", "dtype": "torch.float32", "shape": list(shape),
               "max_abs_err": (out - ref).abs().max().item(), "tol": 1e-3}
        if shape[-1] == 1:
            # one sample: every frame is c * window, whose spectrum is two
            # bins; the other bins hold each f32 FFT's own rounding of those
            # two (~1e-6), which puts high bands at the 1e-5 floor, where the
            # log magnifies it. Held as mels, relative to the largest one
            mel, mel_ref = out.exp(), ref.exp()
            row.update(max_exp_rel_err=((mel - mel_ref).abs().max() / mel_ref.max()).item(),
                       tol=1e-6, tol_on="max_exp_rel_err")
        if tuple(out.shape) != tuple(shape[:-1]) + (cfg.n_mels, 1 + shape[-1] // cfg.hop_length):
            raise AssertionError(f"log_mel_fused: shape {tuple(out.shape)} for {shape}")
        if timed:
            b_ms, b_by = mel_bound(audio, out)
            row.update(ms=cuda_ms(lambda: log_mel_fused(audio, cfg)),
                       graph_ms=cuda_graph_ms(lambda: log_mel_fused(audio, cfg)),
                       plain_ms=cuda_ms(lambda: log_mel_plain(audio, cfg)),
                       plain_graph_ms=cuda_graph_ms(lambda: log_mel_plain(audio, cfg)),
                       library_ms=None, bound_ms=b_ms, bound_by=b_by)
        return row

    row = mel_case((1, 240000), timed=True)
    row.update(route="cuda", source="oron_tts_tpu_torch/csrc/fused_mel.cu",
               replaces="oron_tts_tpu/ops/pallas_mel.py:26")
    rows.append(row)
    report(row)
    # the edge L = 30,001; 512 samples or fewer, where the pad reflects more
    # than once (F6); batches in one launch (F7), the first also timed
    for shape in ((1, 30001), (1,), (300,), (1, 512), (8, 240000), (2, 3, 24000)):
        report(mel_case(shape, timed=shape == (8, 240000)))
    # the kernel's other instances, which no config in the repository uses
    for n_fft in KERNEL_N_FFT:
        other = MelConfig(n_fft=n_fft, hop_length=n_fft // 4, win_length=n_fft)
        if other != cfg:
            audio = 0.3 * torch.randn(2, 30001, generator=gen, device=dev)
            err = (log_mel_fused(audio, other) - log_mel_plain(audio, other)).abs().max().item()
            report({"name": "log_mel_fused", "dtype": "torch.float32",
                    "shape": f"n_fft {n_fft} [2, 30001]", "max_abs_err": err, "tol": 1e-3})
    silence = log_mel_fused(torch.zeros(2, 8192, device=dev), cfg)
    report({"name": "log_mel_fused", "dtype": "torch.float32", "shape": "silence [2, 8192]",
            "max_abs_err": (silence - math.log(cfg.log_clip)).abs().max().item(), "tol": 1e-5})
    audio = 0.3 * torch.randn(8, 240000, generator=gen, device=dev)
    if not bit_identical([log_mel_fused(audio, cfg)], [log_mel_fused(audio, cfg)]):
        raise AssertionError("log_mel_fused: two calls on the same batch differ")
    del audio, q, k, v, x
    torch.cuda.empty_cache()
    return (rows + check_train_kernels(torch, F, report) + check_qmm(torch, F, report)
            + check_classic_kernels(torch, F, report) + check_fused_update(torch, report))


FUSED_SRC = "oron_tts_tpu_torch/csrc/fused_adamw_ema.cu"
# bytes a parameter of one pass over the update's state: f32 gradient (read), f32 master
# (read, write), bf16 mu (read, write), f32 nu (read, write), f32 EMA (read, write), bf16
# working copy (write); torch._fused_adamw_ moves 28: gradient, master, f32 mu and nu
FUSED_BYTES, FUSED_LIBRARY_BYTES = 34, 28


def check_fused_update(torch, report) -> list[dict]:
    """Row 13: the trainer's AdamW + EMA + working copy over Base's 363 leaves in one
    launch against the eager update on the same state (one clipped step, bit-equal),
    then both timed, with the launches' host time, the bound and, as the yardstick,
    ``torch._fused_adamw_`` on f32 moments (AdamW alone; the port never calls it)."""
    import numpy as np

    from oron_tts_tpu_torch.models.dit import DiT
    from oron_tts_tpu_torch.ops import fused_update as fu

    dev = torch.device("cuda")
    with torch.device("meta"):
        shapes = [tuple(p.shape) for p in DiT().parameters()]
    gen = torch.Generator(device=dev).manual_seed(13)
    masters = [0.05 * torch.randn(s, generator=gen, device=dev) for s in shapes]
    kern = {"masters": masters,
            "grads": [1e-3 * torch.randn(s, generator=gen, device=dev) for s in shapes],
            "mu": [(1e-4 * torch.randn(s, generator=gen, device=dev)).to(torch.bfloat16)
                   for s in shapes],
            "nu": [1e-8 * torch.rand(s, generator=gen, device=dev) for s in shapes],
            "ema": [p + 1e-3 * torch.randn(s, generator=gen, device=dev)
                    for p, s in zip(masters, shapes)],
            "work": [p.to(torch.bfloat16) for p in masters]}
    plain = {k: [t.clone() for t in v] for k, v in kern.items()}
    f32 = np.float32
    step = fu.Step(lr=float(f32(1e-4)), betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01,
                   bc1=float(f32(1) - f32(0.9) ** f32(41)),
                   bc2=float(f32(1) - f32(0.999) ** f32(41)), decay=float(f32(0.9999)),
                   one_minus_decay=float(f32(1) - f32(0.9999)), max_grad_norm=1.0,
                   clip_norm=2.5)

    def args(d):
        return d["masters"], d["grads"], d["mu"], d["nu"], d["ema"], d["work"], step

    fu.adamw_ema(*args(kern))
    fu.adamw_ema_plain(*args(plain))
    torch.cuda.synchronize()
    n = sum(math.prod(s) for s in shapes)
    row = {"name": "adamw_ema", "dtype": "torch.bfloat16",
           "shape": f"Base: {len(shapes)} leaves, {n} parameters",
           "leaves_differing": sum(not torch.equal(a, b) for k in kern
                                   for a, b in zip(kern[k], plain[k])),
           "max_abs_err": max(float((a.float() - b.float()).abs().max()) for k in kern
                              for a, b in zip(kern[k], plain[k])), "tol": 0.0}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        fu.adamw_ema(*args(kern))
    host_ms = (time.perf_counter() - t0) * 1e2  # the launches' host side, no wait
    b_ms, b_by = bound_ms(25.0 * n, H100_F32_FLOPS, FUSED_BYTES * n)
    row.update(ms=cuda_ms(lambda: fu.adamw_ema(*args(kern))), host_ms=host_ms,
               plain_ms=cuda_ms(lambda: fu.adamw_ema_plain(*args(plain)), iters=5),
               bound_ms=b_ms, bound_by=b_by, route="cuda", source=FUSED_SRC,
               replaces="none (XLA fuses optax's update)")
    del plain
    ps, gs = kern["masters"], kern["grads"]
    m32, v32 = [torch.zeros_like(p) for p in ps], [torch.zeros_like(p) for p in ps]
    counts = [torch.tensor(41.0, device=dev) for _ in ps]
    row.update(library_ms=cuda_ms(lambda: torch._fused_adamw_(
                   ps, gs, m32, v32, [], counts, lr=1e-4, beta1=0.9, beta2=0.999,
                   weight_decay=0.01, eps=1e-8, amsgrad=False, maximize=False)),
               library="torch._fused_adamw_, f32 mu and nu, no EMA or working copy",
               library_bound_ms=FUSED_LIBRARY_BYTES * n / H100_BYTES * 1e3)
    report(row)
    del kern, ps, gs, m32, v32
    torch.cuda.empty_cache()
    return [row]


CLASSIC_SRC = "oron_tts_tpu_torch/csrc/flash_classic.cu"
# the forward body's template widths, and 20, 12 and 40, which the wrappers
# pad to 24, 16 and 40
FWD_WIDTHS = tuple(range(16, 257, 16)) + (20, 12, 40)
WIDE_HEADS = (264, 320, 512, 1000)  # above the template instances: the wide bodies (F5)
BWD_SRC = "oron_tts_tpu_torch/csrc/flash_bwd.cuh"  # rows 5 and 7: one wgmma body
# bench.py's synthesis protocol: 120 letters, 1,560 frames; its comment says
# "bucketed to 1664", its arithmetic (and the facade's multiple of 64) 1,600
SYNTH_LETTERS, SYNTH_STEPS = 120, 32


def grad_errors(got, refs, rel_tol) -> dict:
    """Each gradient's max |error| and its tolerance, rel_tol of its reference's max.

    ``max_rel_err`` is the largest error over its reference's max, held to
    ``rel_tol``; ``max_abs_err`` is the largest error.
    """
    names = ("dq", "dk", "dv")
    errs = {n: (a.float() - r.float()).abs().max().item() for n, a, r in zip(names, got, refs)}
    tops = {n: r.float().abs().max().item() for n, r in zip(names, refs)}
    return {**errs, **{n + "_tol": rel_tol * tops[n] for n in names},
            "max_abs_err": max(errs.values()),
            "max_rel_err": max(errs[n] / tops[n] for n in names),
            "tol": rel_tol, "tol_on": "max_rel_err"}


def check_classic_kernels(torch, F, report) -> list[dict]:
    """Kernels 6, 7, 8 and 12 against their plain versions, and the two repairs.

    Tolerances as for the lanes kernels: forwards 5e-3 absolute in bf16 (the
    plain version in f32 on the same rounded inputs: the error is P rounded
    to bf16 and one output rounding), gradients 1e-2 of each reference's
    largest value in bf16; f32 forwards 1e-5 absolute and f32 gradients 1e-5
    of the largest value (sums in another order).
    """
    from oron_tts_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_plain,
        flash_attention_packed,
        flash_attention_plain,
        flash_lanes_bwd,
        flash_lanes_bwd_plain,
        flash_lanes_fwd,
        flash_lanes_fwd_stats,
        flash_lanes_fwd_stats_plain,
        flash_nosm,
        flash_nosm_plain,
    )
    from oron_tts_tpu_torch.ops.grouped_conv import (
        grouped_conv1d_mish,
        grouped_conv1d_mish_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    rows = []
    bf16, f32 = torch.bfloat16, torch.float32
    fwd_tol = {bf16: 5e-3, f32: 1e-5}
    grad_tol = {bf16: 1e-2, f32: 1e-5}

    def qkv(shape, dtype, n=3):
        return [torch.randn(*shape, generator=gen, device=dev).to(dtype) for _ in range(n)]

    def lens_of(values):
        return torch.tensor(values, dtype=torch.int32, device=dev)

    def kept_keys(lens, T):
        return float(lens.clamp(min=0, max=T).sum())

    def sdpa_mask(lens, T):
        return (torch.arange(T, device=dev)[None, :] < lens[:, None])[:, None, None, :]

    def nosm_row(q, k, v) -> dict:
        """Kernel 12's error. The plain version takes f32 q and k and the
        input-typed v, so it rounds each weight q.k / T to v's type as the
        kernel does and keeps its output in f32. Its output is not an average
        (no softmax): in bf16 it reaches ~4, where the kernel's one output
        rounding is up to 2^-8 of the value, so the error beyond that
        rounding is what is held to 5e-3: q.k and P.V summed in another
        order, and the rare weight on a rounding midpoint that rounds the
        other way for it."""
        ref = flash_nosm_plain(q.float(), k.float(), v)
        diff = (flash_nosm(q, k, v).float() - ref).abs()
        half_step = 2.0 ** -8 if q.dtype == bf16 else 0.0
        return {"name": "flash_nosm", "dtype": str(q.dtype), "shape": list(q.shape),
                "max_abs_err": diff.max().item(), "ref_max": ref.abs().max().item(),
                "max_excess": (diff - half_step * ref.abs()).max().item(),
                "tol": fwd_tol[q.dtype], "tol_on": "max_excess"}

    # kernels 6, 8 and 12 at small shapes, at every template width of the
    # forward body (16 to 256) and at 20, 12 and 40, which the wrappers pad
    # to 24, 16 and 40 (F3): f32 and bf16, exp and exp2, a kv_len = 0 row
    # (every key weighs 1/T), odd H for the packed one
    for dtype in (f32, bf16):
        for D in FWD_WIDTHS:
            for H in (3, 4):
                q, k, v = qkv((2, H, 200, D), dtype)
                lens = lens_of([137, 0])
                for name, got, ref in (
                    ("flash_attention", flash_attention(q, k, v, kv_lens=lens),
                     flash_attention_plain(q.float(), k.float(), v.float(), kv_lens=lens)),
                    ("flash_attention", flash_attention(q, k, v, kv_lens=lens, use_exp2=False),
                     flash_attention_plain(q.float(), k.float(), v.float(), kv_lens=lens,
                                           use_exp2=False)),
                    ("flash_attention", flash_attention(q, k, v),
                     flash_attention_plain(q.float(), k.float(), v.float())),
                    ("flash_attention_packed", flash_attention_packed(q, k, v, kv_lens=lens),
                     flash_attention_plain(q.float(), k.float(), v.float(), kv_lens=lens)),
                ):
                    report({"name": name, "dtype": str(dtype), "shape": [2, H, 200, D],
                            "kv_lens": [137, 0],
                            "max_abs_err": (got.float() - ref).abs().max().item(),
                            "tol": fwd_tol[dtype]})
            report(nosm_row(q, k, v))

    # kernel 7 at small shapes, the kv_len = 0 row's gradients non-zero: every
    # template width of the backward body to 128, 40 padded to 48 (R4), 20 and
    # 12 (F3), and the wide variant at 136, 192 and 256 (F4)
    for dtype in (f32, bf16):
        for D in (16, 32, 48, 64, 80, 96, 112, 128, 40, 20, 12, 136, 192, 256):
            q, k, v, do = qkv((2, 4, 200, D), dtype, 4)
            lens = lens_of([137, 0])
            out = flash_attention(q, k, v, kv_lens=lens)
            got = flash_attention_bwd(q, k, v, lens, out, do)
            same_bits = bit_identical(got, flash_attention_bwd(q, k, v, lens, out, do))
            refs = flash_attention_bwd_plain(q.float(), k.float(), v.float(), lens,
                                             out.float(), do.float())
            empty_row = min(g[1].float().abs().max().item() for g in got)
            report({"name": "flash_attention_bwd", "dtype": str(dtype),
                    "shape": [2, 4, 200, D], "kv_lens": [137, 0],
                    **grad_errors(got, refs, grad_tol[dtype]),
                    "kv_len_0_row_min_grad_max": empty_row, "bit_identical_twice": same_bits})
            if not same_bits:
                raise AssertionError(f"flash_attention_bwd at D = {D}: two calls differ")
            if not empty_row > 0:
                raise AssertionError("flash_attention_bwd: the kv_len = 0 row has a zero gradient")

    # kernel 12 small, f32 and bf16
    for dtype in (f32, bf16):
        report(nosm_row(*qkv((2, 4, 200, 64), dtype)))

    # the synthesis shape: kernels 6, 8 and 12, timed, bf16
    B, H, T, D = 2, 16, 1664, 64
    q, k, v = qkv((B, H, T, D), bf16)
    lens = lens_of([SYNTH_LETTERS * 13] * B)
    kept = kept_keys(lens, T)
    nb = q.numel() * 2
    mask = sdpa_mask(lens, T)
    yardstick = sdpa_yardstick(torch, F, q, k, v, mask)
    ref = flash_attention_plain(q.float(), k.float(), v.float(), kv_lens=lens)
    for name, fn, line in (
        ("flash_attention", lambda: flash_attention(q, k, v, kv_lens=lens), 32),
        ("flash_attention_packed", lambda: flash_attention_packed(q, k, v, kv_lens=lens), 246),
    ):
        b_ms, b_by = bound_ms(4.0 * T * D * H * kept, H100_BF16_FLOPS, 4 * nb + lens.numel() * 4)
        row = {"name": name, "dtype": str(bf16), "shape": [B, H, T, D], "kv_lens": lens.tolist(),
               "max_abs_err": (fn().float() - ref).abs().max().item(), "tol": 5e-3,
               **forward_times(fn),
               "plain_ms": cuda_ms(lambda: flash_attention_plain(q, k, v, kv_lens=lens), iters=5),
               **yardstick,
               "bound_ms": b_ms, "bound_by": b_by, "route": "cuda", "source": CLASSIC_SRC,
               "replaces": f"oron_tts_tpu/ops/flash_attention.py:{line}"}
        rows.append(row)
        report(row)
    flash_exp_ms = cuda_ms(lambda: flash_attention(q, k, v, kv_lens=lens, use_exp2=False))
    emit({"phase": "kernel_variant", "name": "flash_attention", "use_exp2": False,
          "ms": flash_exp_ms, "shape": [B, H, T, D]})
    b_ms, b_by = bound_ms(4.0 * T * D * H * B * T, H100_BF16_FLOPS, 4 * nb)
    row = {**nosm_row(q, k, v),
           **forward_times(lambda: flash_nosm(q, k, v)),
           "plain_ms": cuda_ms(lambda: flash_nosm_plain(q, k, v), iters=5),
           "library_ms": cuda_ms(lambda: torch.matmul(torch.matmul(q, k.transpose(-1, -2)), v)),
           "library_graph_ms": cuda_graph_ms(
               lambda: torch.matmul(torch.matmul(q, k.transpose(-1, -2)), v)),
           "library": "torch.matmul(torch.matmul(q, k^T), v), two calls, 1/T left out",
           "bound_ms": b_ms, "bound_by": b_by, "route": "cuda", "source": CLASSIC_SRC,
           "replaces": "scripts/bench_attention.py:128"}
    rows.append(row)
    report(row)
    del q, k, v, ref

    # the training shape: kernel 7, timed, bf16, against SDPA's backward
    B, T = TRAIN_B, TRAIN_T
    q, k, v, do = qkv((B, H, T, D), bf16, 4)
    lens = lens_of(train_clip_frames()[:B])
    kept = kept_keys(lens, T)
    out = flash_attention(q, k, v, kv_lens=lens)
    got = flash_attention_bwd(q, k, v, lens, out, do)
    same_bits = bit_identical(got, flash_attention_bwd(q, k, v, lens, out, do))
    refs = flash_attention_bwd_plain(q.float(), k.float(), v.float(), lens, out.float(),
                                     do.float())
    errs = grad_errors(got, refs, 1e-2)
    del got, refs
    if not same_bits:
        raise AssertionError("flash_attention_bwd: two calls differ")
    mask = sdpa_mask(lens, T)
    fwd_times = sdpa_by_backend(torch, F, q, k, v, mask)
    best, _ = fastest(fwd_times)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qs, ks, vs = (x.detach().requires_grad_(True) for x in (q, k, v))
    with sdpa_kernel([getattr(SDPBackend, best)]):
        lib_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(lib_out, (qs, ks, vs), do,
                                                      retain_graph=True), iters=5)
    del lib_out, qs, ks, vs
    b_ms, b_by = bound_ms(10.0 * T * D * H * kept, H100_BF16_FLOPS,
                          8 * q.numel() * 2 + lens.numel() * 4)
    row = {"name": "flash_attention_bwd", "dtype": str(bf16), "shape": [B, H, T, D],
           "kept_keys": kept, **errs,
           "ms": cuda_ms(lambda: flash_attention_bwd(q, k, v, lens, out, do), iters=5),
           "plain_ms": cuda_ms(lambda: flash_attention_bwd_plain(q, k, v, lens, out, do), iters=3),
           "library_ms": lib_bwd, "library": "autograd backward of SDPA " + best,
           "bound_ms": b_ms, "bound_by": b_by, "route": "cuda", "source": BWD_SRC,
           "entry": "oron_tts_tpu_torch/csrc/flash_classic_bwd.cu",
           "replaces": "oron_tts_tpu/ops/flash_attention.py:749", "bit_identical_twice": same_bits,
           **backward_passes(torch, "classic", q, k, v, lens, out, do)}
    rows.append(row)
    report(row)
    del q, k, v, do, out
    torch.cuda.empty_cache()

    # F4: the wide variant at the training shape's 2,048 frames, heads of 192
    # and 256 (5 and 4 heads: the Base width's 1,024 columns or just under);
    # F5: the wide bodies at heads of 320 (3 heads)
    for D, Hw in ((192, 5), (256, 4), (320, 3)):
        q, k, v, do = qkv((B, Hw, T, D), bf16, 4)
        out = flash_attention(q, k, v, kv_lens=lens)
        got = flash_attention_bwd(q, k, v, lens, out, do)
        same_bits = bit_identical(got, flash_attention_bwd(q, k, v, lens, out, do))
        refs = flash_attention_bwd_plain(q.float(), k.float(), v.float(), lens, out.float(),
                                         do.float())
        errs = grad_errors(got, refs, 1e-2)
        del got, refs
        b_ms, b_by = bound_ms(10.0 * T * D * Hw * kept, H100_BF16_FLOPS,
                              8 * q.numel() * 2 + lens.numel() * 4)
        row = {"phase": "kernel_wide", "name": "flash_attention_bwd", "dtype": str(bf16),
               "shape": [B, Hw, T, D], "kept_keys": kept, **errs,
               "bit_identical_twice": same_bits,
               "ms": cuda_ms(lambda: flash_attention_bwd(q, k, v, lens, out, do), iters=5),
               "forward_ms": cuda_ms(lambda: flash_attention(q, k, v, kv_lens=lens), iters=5),
               "bound_ms": b_ms, "bound_by": b_by,
               **backward_passes(torch, "classic", q, k, v, lens, out, do)}
        qs, ks, vs = (x.detach().requires_grad_(True) for x in (q, k, v))
        try:
            with sdpa_kernel([getattr(SDPBackend, best)]):
                lib_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
                row["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
                    lib_out, (qs, ks, vs), do, retain_graph=True), iters=5)
            row["library"] = "autograd backward of SDPA " + best
            del lib_out
        except RuntimeError as exc:  # a yardstick only: the port never calls SDPA
            row["library_ms"], row["library"] = None, f"SDPA {best} refused: {exc}"[:120]
        del qs, ks, vs
        emit(row)
        if not (errs["max_rel_err"] <= 1e-2 and same_bits):
            raise AssertionError(f"flash_attention_bwd at D = {D}: {errs}, two calls equal "
                                 f"{same_bits}")
        del q, k, v, do, out
        torch.cuda.empty_cache()

    # kernels 1 and 4 at every template width of the forward body and at 20
    # and 12 (padded to 24 and 16, F3), f32 and bf16; a kv_len = 0 row
    for dtype in (f32, bf16):
        for D in FWD_WIDTHS:
            Hl = 5 if D == 20 else 2
            q, k, v = qkv((2, 200, Hl * D), dtype)
            lens = lens_of([137, 0])
            out, lse = flash_lanes_fwd_stats(q, k, v, lens, Hl)
            ref_out, ref_lse = flash_lanes_fwd_stats_plain(q.float(), k.float(), v.float(), lens,
                                                           Hl)
            same = torch.equal(out, flash_lanes_fwd(q, k, v, lens, Hl))
            report({"name": "flash_lanes_fwd_stats", "dtype": str(dtype), "shape": [2, 200, Hl * D],
                    "head_dim": D, "out_bit_equal_to_fwd": same,
                    "lse_max_abs_err": (lse - ref_lse).abs().max().item(),
                    "max_abs_err": (out.float() - ref_out).abs().max().item(),
                    "tol": fwd_tol[dtype]})
            if not same or not (lse - ref_lse).abs().max().item() <= 1e-4:
                raise AssertionError(f"lanes forward at D = {D}: stats output equal {same}, "
                                     f"lse off by {(lse - ref_lse).abs().max().item()}")

    # repairs: lanes forward, stats and backward at D = 32 (PR 4), 16 and 128
    # (R2), 3 heads of 40 (R4, padded to 48), 5 heads of 20 and 2 of 12 (F3,
    # padded to 24 and 16); a kv_len = 0 row gets zeros
    for dtype, (Bl, Tl, Hl, D) in ((f32, (2, 200, 2, 32)), (bf16, (2, 200, 2, 32)),
                                   (bf16, (2, 832, 16, 32)), (f32, (2, 200, 8, 16)),
                                   (bf16, (2, 200, 8, 16)), (f32, (2, 200, 2, 128)),
                                   (bf16, (2, 200, 2, 128)), (f32, (2, 200, 3, 40)),
                                   (bf16, (2, 200, 3, 40)), (f32, (2, 200, 5, 20)),
                                   (bf16, (2, 200, 5, 20)), (f32, (2, 200, 2, 12)),
                                   (bf16, (2, 200, 2, 12))):
        q, k, v, do = qkv((Bl, Tl, Hl * D), dtype, 4)
        lens = lens_of([Tl - 63, 0] if Tl == 200 else [Tl, Tl - 63])
        out, lse = flash_lanes_fwd_stats(q, k, v, lens, Hl)
        ref_out, ref_lse = flash_lanes_fwd_stats_plain(q.float(), k.float(), v.float(), lens, Hl)
        same = torch.equal(out, flash_lanes_fwd(q, k, v, lens, Hl))
        got = flash_lanes_bwd(q, k, v, lens, out, do, lse, Hl)
        same_bits = bit_identical(got, flash_lanes_bwd(q, k, v, lens, out, do, lse, Hl))
        refs = flash_lanes_bwd_plain(q.float(), k.float(), v.float(), lens, out.float(),
                                     do.float(), lse, Hl)
        empty_zero = all(not g[1].any() for g in got) if lens[1] == 0 else None
        report({"name": "flash_lanes_fwd_stats", "dtype": str(dtype), "shape": [Bl, Tl, Hl * D],
                "head_dim": D, "out_bit_equal_to_fwd": same,
                "lse_max_abs_err": (lse - ref_lse).abs().max().item(),
                "max_abs_err": (out.float() - ref_out).abs().max().item(), "tol": fwd_tol[dtype]})
        report({"name": "flash_lanes_bwd", "dtype": str(dtype), "shape": [Bl, Tl, Hl * D],
                "head_dim": D, "kv_lens": lens.tolist(), **grad_errors(got, refs, grad_tol[dtype]),
                "kv_len_0_row_zero": empty_zero, "bit_identical_twice": same_bits})
        if not (same and same_bits and empty_zero is not False):
            raise AssertionError(f"lanes kernels at D = {D}: stats output {same}, two backward "
                                 f"calls equal {same_bits}, kv_len = 0 row zero {empty_zero}")

    # F5: heads wider than 256 (the kernels' wide bodies: D in chunks for S
    # and dP, 128 output columns a block; f32: 64) through the classic
    # forwards (exp2 and exp), the packed and no-softmax ones, the lanes
    # forward with its statistics, and the classic backward, twice for
    # identical bits; a kv_len = 0 row
    for D in WIDE_HEADS:
        for dtype in (bf16, f32):
            q, k, v, do = qkv((2, 4, 200, D), dtype, 4)
            lens = lens_of([137, 0])
            qf, kf, vf = q.float(), k.float(), v.float()
            for name, got, ref in (
                ("flash_attention", flash_attention(q, k, v, kv_lens=lens),
                 flash_attention_plain(qf, kf, vf, kv_lens=lens)),
                ("flash_attention", flash_attention(q, k, v, kv_lens=lens, use_exp2=False),
                 flash_attention_plain(qf, kf, vf, kv_lens=lens, use_exp2=False)),
                ("flash_attention_packed", flash_attention_packed(q, k, v, kv_lens=lens),
                 flash_attention_plain(qf, kf, vf, kv_lens=lens)),
            ):
                report({"name": name, "dtype": str(dtype), "shape": [2, 4, 200, D],
                        "kv_lens": [137, 0], "wide": True,
                        "max_abs_err": (got.float() - ref).abs().max().item(),
                        "tol": fwd_tol[dtype]})
            # the no-softmax output is no average: it grows with sqrt(D), and
            # so does the count of weights q.k / T that round the other way
            # (beyond the output's rounding, 6.6e-3 at D = 512 in bf16), so
            # the wide rows are held to 1e-2 of the plain version's largest
            # value (1e-5 in f32)
            row = nosm_row(q, k, v)
            report({**row, "wide": True, "max_rel_err": row["max_abs_err"] / row["ref_max"],
                    "tol": grad_tol[dtype], "tol_on": "max_rel_err"})
            ql, kl, vl = (x.transpose(1, 2).reshape(2, 200, 4 * D) for x in (q, k, v))
            out, lse = flash_lanes_fwd_stats(ql, kl, vl, lens, 4)
            ref_out, ref_lse = flash_lanes_fwd_stats_plain(ql.float(), kl.float(), vl.float(),
                                                           lens, 4)
            report({"name": "flash_lanes_fwd_stats", "dtype": str(dtype),
                    "shape": [2, 200, 4 * D], "head_dim": D, "wide": True,
                    "lse_max_abs_err": (lse - ref_lse).abs().max().item(),
                    "max_abs_err": (out.float() - ref_out).abs().max().item(),
                    "tol": fwd_tol[dtype]})
            out = flash_attention(q, k, v, kv_lens=lens)
            got = flash_attention_bwd(q, k, v, lens, out, do)
            same_bits = bit_identical(got, flash_attention_bwd(q, k, v, lens, out, do))
            refs = flash_attention_bwd_plain(qf, kf, vf, lens, out.float(), do.float())
            report({"name": "flash_attention_bwd", "dtype": str(dtype),
                    "shape": [2, 4, 200, D], "kv_lens": [137, 0], "wide": True,
                    **grad_errors(got, refs, grad_tol[dtype]), "bit_identical_twice": same_bits})
            if not same_bits:
                raise AssertionError(f"flash_attention_bwd at D = {D}: two calls differ")
            del q, k, v, do, out, got, refs

    # the lanes backward stops at 128 (the lanes rule admits no wider head):
    # a head of 136 raises before any launch
    launched = flash_lanes_bwd.launches
    try:
        flash_lanes_bwd(*qkv((1, 64, 136), bf16), lens_of([64]), *qkv((1, 64, 136), bf16, 2),
                        torch.zeros(1, 1, 64, device=dev), 1)
        refused = None
    except ValueError as exc:
        refused = str(exc)[:120]
    emit({"phase": "kernel_refusals", "head_dims": {"flash_lanes_bwd": 136}, "refused": refused})
    if refused is None or launched != flash_lanes_bwd.launches:
        raise AssertionError("a lanes backward at head width 136 was not refused before launch")

    # the grouped conv at every group width of its wgmma kernel, 16, 32 (the
    # Small config), 64 (Base) and 128, at 832 frames and at ragged lengths:
    # 200, 60 (inside one block's rows) and a single frame; and at 8 and 4
    # (R3, the SIMT kernel in bf16)
    from oron_tts_tpu_torch.ops.grouped_conv import WGMMA_GROUP_WIDTHS

    for C, T in ([(16 * wd, T) for wd in WGMMA_GROUP_WIDTHS for T in (832, 200, 60, 1)]
                 + [(128, 200), (64, 200)]):
        for dtype, tol in ((f32, 1e-4), (bf16, 2e-2)):
            x = torch.randn(2, T, C, generator=gen, device=dev).to(dtype)
            w = (torch.randn(31, C // 16, C, generator=gen, device=dev)
                 / math.sqrt(31 * C // 16)).to(dtype)
            bias = 0.1 * torch.randn(C, generator=gen, device=dev)
            report({"name": "grouped_conv1d_mish", "dtype": str(dtype), "shape": [2, T, C],
                    "group_width": C // 16,
                    "max_abs_err": (grouped_conv1d_mish(x, w, bias, 16).float()
                                    - grouped_conv1d_mish_plain(x.float(), w.float(), bias, 16)
                                    ).abs().max().item(), "tol": tol})
    return rows


def check_reference(torch) -> None:
    """Small f32 model: card (kernels) vs CPU (plain versions), same inputs."""
    from oron_tts_tpu_torch.config import F5Config, ModelConfig
    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from oron_tts_tpu_torch.utils.weights import seeded_dit_params

    mcfg = ModelConfig(dim=256, depth=2, heads=4, text_dim=64, conv_layers=1)
    params = seeded_dit_params(mcfg, seed=1)
    rng = torch.Generator().manual_seed(2)
    T, ref_len, dur = 192, 40, 170
    cond = torch.zeros(1, T, 100)
    cond[0, :ref_len] = torch.randn(ref_len, 100, generator=rng)
    ids = torch.randint(1, 64, (1, T), generator=rng)
    ids[0, dur:] = -1
    noise = torch.randn(1, T, 100, generator=rng)
    mels, wavs = [], []
    for device in ("cuda", "cpu"):
        model = F5TTS(F5Config(model=mcfg), device=device, dtype=torch.float32)
        model.load_params(params)
        mel, _ = model.cfm.sample(
            cond.to(device), ids.to(device), torch.tensor([dur]), torch.tensor([ref_len]),
            steps=4, cfg_strength=2.0, sway_sampling_coef=-1.0, noise=noise,
        )
        gen = mel[:, ref_len:dur].transpose(1, 2)
        mels.append(gen.cpu())
        wavs.append(model._decode_mel(gen))
    mel_err = (mels[0] - mels[1]).abs().max().item()
    wav_err = float(abs(wavs[0] - wavs[1]).max())
    peak = float(abs(wavs[1]).max())
    emit({"phase": "reference", "mel_max_abs_err": mel_err, "mel_tol": 1e-3,
          "wav_max_abs_err": wav_err, "wav_tol": 1e-3 * peak, "wav_peak": peak})
    if not (mel_err <= 1e-3 and wav_err <= 1e-3 * peak and math.isfinite(peak) and peak > 0):
        raise AssertionError("card and CPU disagree on the small model")


def check_train_reference(torch) -> None:
    """One training step of a small f32 model: card (kernels) vs CPU (plain).

    Twice: heads of 64 (the lanes kernels) and two heads of 192 (dim 384:
    the lanes rule sends them to the classic "flash" kernels, and on the card
    the classic backward runs its wide variant, F4). Same seeded weights,
    batch and generator seed, so the same spans, times, noise and dropout
    masks. Tolerances: loss 1e-4 and gradient norm 1e-3 relative (f32 sums in
    another order); the update (new − old parameters) 1e-2 in relative L2
    norm. Adam's first step is g/(|g| + 1e-8), which amplifies a difference
    of 1e-7 in a gradient near zero to the size of the step, so single
    elements may differ while the update as a whole agrees.
    """
    import numpy as np

    from oron_tts_tpu_torch.config import F5Config, ModelConfig
    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from oron_tts_tpu_torch.ops.flash_attention import flash_attention_bwd, flash_lanes_bwd
    from oron_tts_tpu_torch.train.trainer import F5Trainer
    from oron_tts_tpu_torch.utils.weights import seeded_dit_params

    for dim, heads in ((256, 4), (384, 2)):
        mcfg = ModelConfig(dim=dim, depth=2, heads=heads, text_dim=64, conv_layers=1,
                           p_dropout=0.1)
        params = seeded_dit_params(mcfg, seed=3)
        rng = np.random.default_rng(4)
        batch = {
            "mel": rng.standard_normal((2, 100, 192)).astype(np.float32),
            "text_ids": rng.integers(0, 60, (2, 192)).astype(np.int32),
            "mel_lengths": np.asarray([192, 150], np.int32),
        }
        cfg = {"learning_rate": 1e-3, "warmup_steps": 0, "num_epochs": 1, "use_tqdm": False}
        results = []
        with tempfile.TemporaryDirectory() as tmp:
            for device in ("cuda", "cpu"):
                model = F5TTS(F5Config(model=mcfg), device=device, dtype=torch.float32)
                model.load_params(params)
                impl = model.backbone.attn_impl
                trainer = F5Trainer(cfg, model, [batch], log_dir=f"{tmp}/{device}/logs",
                                    checkpoint_dir=f"{tmp}/{device}/ckpt")
                before = [p.cpu().clone() for p in trainer.state.params]
                bwd = (flash_lanes_bwd.launches, flash_attention_bwd.launches)
                m = trainer.train_step(batch, torch.Generator().manual_seed(11))
                if device == "cuda":
                    torch.cuda.synchronize()
                    bwd = (flash_lanes_bwd.launches - bwd[0], flash_attention_bwd.launches - bwd[1])
                    card_bwd = dict(zip(("flash_lanes_bwd", "flash_attention_bwd"), bwd))
                update = torch.cat([(p.cpu() - b).flatten()
                                    for p, b in zip(trainer.state.params, before)])
                results.append((m, update))
        (m_gpu, u_gpu), (m_cpu, u_cpu) = results
        loss_err = abs(m_gpu["loss"] - m_cpu["loss"]) / abs(m_cpu["loss"])
        norm_err = abs(m_gpu["grad_norm"] - m_cpu["grad_norm"]) / m_cpu["grad_norm"]
        upd_err = ((u_gpu - u_cpu).norm() / u_cpu.norm()).item()
        emit({"phase": "reference_train", "dim": dim, "head_dim": dim // heads,
              "attn_impl": impl, "backward_launches_on_card": card_bwd,
              "loss": m_gpu["loss"], "loss_rel_err": loss_err,
              "loss_tol": 1e-4, "grad_norm": m_gpu["grad_norm"], "grad_norm_rel_err": norm_err,
              "grad_norm_tol": 1e-3, "update_rel_l2_err": upd_err, "update_tol": 1e-2,
              "update_l2": u_cpu.norm().item(), "ok": [m_gpu["ok"], m_cpu["ok"]]})
        want = "flash_attention_bwd" if dim // heads > 128 else "flash_lanes_bwd"
        if not (m_gpu["ok"] and m_cpu["ok"] and loss_err <= 1e-4 and norm_err <= 1e-3
                and upd_err <= 1e-2 and u_cpu.norm().item() > 0 and card_bwd[want] == 2):
            raise AssertionError(f"card and CPU disagree on one training step of the small "
                                 f"model at head width {dim // heads} (backward launches "
                                 f"{card_bwd})")


# the lanes and classic attention kernels share their device bodies
# (csrc/flash_fwd.cuh, flash_bwd.cuh) and so their names
PROFILE_KINDS = (
    ("attention_bwd", ("bwd_dkdv", "bwd_dq", "attn_delta")),
    ("gelu_dropout", ("gelu_dropout_kernel",)),
    ("attention_fwd", ("attn_fwd_",)),
    ("grouped_conv", ("gconv_",)),
    ("fused_mel", ("log_mel_kernel",)),
    ("quantized_matmul", ("qmm_",)),
    ("matmul", ("nvjet", "gemm", "gemv", "cutlass", "xmma", "cublas", "matmul")),
)


def profile_once(torch, synthesize) -> dict:
    """Device time by kernel kind and idle share of one traced synthesis."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        synthesize()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t_stop = time.perf_counter()
    by_kind: dict[str, float] = {}
    by_name: dict[str, list] = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA or ev.device_time_total <= 0:
            continue
        low = ev.name.lower()
        kind = next((k for k, keys in PROFILE_KINDS if any(x in low for x in keys)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + ev.device_time_total / 1e6
        entry = by_name.setdefault(ev.name[:90], [0.0, 0])
        entry[0] += ev.device_time_total / 1e6
        entry[1] += 1
    busy = sum(by_kind.values())
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {
        "wall_s": wall, "device_busy_s": busy, "device_idle_share": 1.0 - busy / wall,
        "device_s_by_kind": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
        "device_kernels": sum(c for _, c in by_name.values()),
        "top_kernels": [{"name": n, "s": t, "launches": c} for n, (t, c) in top],
        "trace_s": time.perf_counter() - t_stop,  # the profiler's own stop and event walk
    }


def run_slice(torch, smi: str) -> dict[str, int]:
    import numpy as np

    from oron_tts_tpu_torch.config import F5Config
    from oron_tts_tpu_torch.data.wav import write_wav
    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from oron_tts_tpu_torch.ops.flash_attention import flash_lanes_fwd
    from oron_tts_tpu_torch.ops.fused_mel import log_mel_fused
    from oron_tts_tpu_torch.ops.grouped_conv import grouped_conv1d_mish
    from oron_tts_tpu_torch.utils.weights import seeded_dit_params

    kernels = (flash_lanes_fwd, grouped_conv1d_mish, log_mel_fused)
    cfg = F5Config()
    t0 = time.perf_counter()
    model = F5TTS(cfg)  # the card, bf16
    assert model.device.type == "cuda" and model.dtype == torch.bfloat16
    model.load_params(seeded_dit_params(cfg.model, seed=0))
    model.load_vocoder()
    n_params = sum(p.numel() for p in model.backbone.parameters())
    emit({"phase": "load", "seconds": time.perf_counter() - t0, "dit_params": n_params})
    model.synthesize(MN_TEXT, n_steps=2, seed=0)  # warm-up: cuBLAS handles, caches

    depth, steps = cfg.model.depth, 32
    totals = {k.__name__: 0 for k in kernels}
    with tempfile.TemporaryDirectory() as tmp:
        wav_ref = 0.3 * np.random.default_rng(0).standard_normal(5 * 24000).astype(np.float32)
        write_wav(Path(tmp) / "ref.wav", wav_ref, 24000, subtype="float32")
        modes = (("ref_free", {}),
                 ("voice_cloned", {"ref_audio_path": Path(tmp) / "ref.wav",
                                   "ref_text": REF_TEXT}))
        for mode, extra in modes:
            ids = model.text_cleaner.text_to_sequence(MN_TEXT, lang="mn")
            ref_len, ref_ids = 0, []
            if extra:
                ref_len = 1 + len(wav_ref) // cfg.audio.hop_length
                ref_ids = model.text_cleaner.text_to_sequence(REF_TEXT, lang="mn")
            target_len = model._target_len(MN_TEXT, ids, None, ref_len, ref_ids, 1.0)
            for k in kernels:
                k.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wav = model.synthesize(MN_TEXT, lang="mn", n_steps=steps, cfg_strength=2.0,
                                   sway_sampling_coef=-1.0, seed=0, **extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {k.__name__: k.launches for k in kernels}
            rms = float(np.sqrt(np.mean(np.square(wav, dtype=np.float64))))
            audio_s = len(wav) / cfg.audio.sample_rate
            emit({"phase": "slice", "mode": mode, "letters": len(MN_TEXT.replace(" ", "")),
                  "target_frames": target_len, "bucket": model._bucket(ref_len + target_len),
                  "samples": len(wav), "rms": rms, "wall_s": wall, "audio_s": audio_s,
                  "rtf": wall / audio_s, "launches": counts, "card": smi})
            want = {"flash_lanes_fwd": steps * depth, "grouped_conv1d_mish": steps * 2,
                    "log_mel_fused": 1 if extra else 0}
            if counts != want:
                raise AssertionError(f"{mode}: launches {counts}, expected {want}")
            if len(wav) != target_len * cfg.audio.hop_length:
                raise AssertionError(f"{mode}: {len(wav)} samples for {target_len} frames")
            if not (np.isfinite(wav).all() and rms > 0):
                raise AssertionError(f"{mode}: output not finite or silent")
            for name, n in counts.items():
                totals[name] += n
        # after the counts were read: one traced synthesis of each kind
        for mode, extra in modes:
            emit({"phase": "profile", "mode": mode, "card": smi, **profile_once(
                torch, lambda: model.synthesize(MN_TEXT, lang="mn", n_steps=steps,
                                                cfg_strength=2.0, sway_sampling_coef=-1.0,
                                                seed=0, **extra))})
    return totals


def run_train(torch, smi: str) -> dict[str, int]:
    """F5Trainer at the Base width, bf16, batches of [12, 2048] frames."""
    import numpy as np

    from oron_tts_tpu_torch.config import F5Config
    from oron_tts_tpu_torch.data.dataset import FixedBatchSampler, TTSCollator, TTSDataset
    from oron_tts_tpu_torch.data.loader import DataLoader
    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from oron_tts_tpu_torch.ops.flash_attention import (
        flash_lanes_bwd,
        flash_lanes_fwd,
        flash_lanes_fwd_stats,
    )
    from oron_tts_tpu_torch.ops.fused_update import adamw_ema
    from oron_tts_tpu_torch.ops.gelu_dropout import gelu_dropout_bwd, gelu_dropout_fwd
    from oron_tts_tpu_torch.ops.grouped_conv import grouped_conv1d_mish
    from oron_tts_tpu_torch.train.trainer import F5Trainer
    from oron_tts_tpu_torch.utils.weights import seeded_dit_params

    kernels = (flash_lanes_fwd, flash_lanes_fwd_stats, flash_lanes_bwd, gelu_dropout_fwd,
               gelu_dropout_bwd, grouped_conv1d_mish, adamw_ema)
    cfg = F5Config()  # Base: dim 1024, depth 22, heads 16, p_dropout 0.1, no remat
    depth = cfg.model.depth
    config = {"learning_rate": 1e-4, "warmup_steps": 2, "num_epochs": 4, "use_tqdm": False,
              "log_interval": 1, "max_checkpoints": 1, "seed": 0}

    t0 = time.perf_counter()
    rng = np.random.default_rng(6)
    hop = cfg.audio.hop_length
    arrays = [(0.3 * rng.standard_normal((f - 1) * hop, dtype=np.float32))
              for f in train_clip_frames()]
    dataset = TTSDataset(audio_arrays=arrays, texts=[MN_TEXT] * len(arrays),
                         sample_rate=cfg.audio.sample_rate, n_mels=cfg.audio.n_mels)
    loader = DataLoader(dataset, FixedBatchSampler(len(dataset), TRAIN_B, shuffle=False),
                        TTSCollator(pad_to_multiple=64), num_workers=2)
    model = F5TTS(cfg)  # the card, bf16
    assert model.device.type == "cuda" and model.dtype == torch.bfloat16
    model.load_params(seeded_dit_params(cfg.model, seed=0))
    with tempfile.TemporaryDirectory() as tmp:
        trainer = F5Trainer(config, model, loader, log_dir=f"{tmp}/logs",
                            checkpoint_dir=f"{tmp}/ckpt")
        emit({"phase": "train_setup", "seconds": time.perf_counter() - t0,
              "clips": len(dataset), "clip_seconds": [round(len(a) / 24000, 2) for a in arrays][:4],
              "dit_params": model.num_params()})
        watched = (0, 1, 2, -3, -2, -1)  # time embedding ... output projection
        before = [trainer.state.params[i].clone() for i in watched]
        ema_before = [trainer.state.ema[i].clone() for i in watched]

        # warm-up: one epoch (two optimizer steps) through the trainer's own loop
        torch.cuda.reset_peak_memory_stats()
        warm_loss = trainer.train_epoch(total_epochs=config["num_epochs"])
        torch.cuda.synchronize()
        emit({"phase": "train_warmup", "steps": trainer.global_step, "avg_loss": warm_loss})
        if trainer.global_step != 2 or not math.isfinite(warm_loss):
            raise AssertionError("the warm-up epoch did not take two finite steps")

        totals = {k.__name__: 0 for k in kernels}
        want = {"flash_lanes_fwd": 0, "flash_lanes_fwd_stats": depth, "flash_lanes_bwd": depth,
                "gelu_dropout_fwd": depth, "gelu_dropout_bwd": depth,
                "grouped_conv1d_mish": 2, "adamw_ema": 1}
        step_ms = []
        for epoch in (1, 2):
            loader.batch_sampler.set_epoch(epoch)
            generator = torch.Generator().manual_seed(config["seed"] + epoch)
            for batch in loader:
                shape = tuple(batch["mel"].shape)
                frames = int(batch["mel_lengths"].sum())
                for k in kernels:
                    k.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = trainer.train_step(batch, generator)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                counts = {k.__name__: k.launches for k in kernels}
                step_ms.append(ms)
                emit({"phase": "train", "step": trainer.state.step, "batch": list(shape),
                      "mel_frames": frames, "loss": m["loss"], "grad_norm": m["grad_norm"],
                      "ok": m["ok"], "step_ms": ms, "frames_per_s": frames / ms * 1e3,
                      "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "launches": counts, "card": smi})
                if shape != (TRAIN_B, cfg.audio.n_mels, TRAIN_T):
                    raise AssertionError(f"batch shape {shape}")
                if not (m["ok"] and math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
                    raise AssertionError(f"step not finite: {m}")
                if counts != want:
                    raise AssertionError(f"launches {counts}, expected {want}")
                for name, n in counts.items():
                    totals[name] += n
        moved = all(not torch.equal(trainer.state.params[i], b) for i, b in zip(watched, before))
        ema_moved = all(not torch.equal(trainer.state.ema[i], b)
                        for i, b in zip(watched, ema_before))
        emit({"phase": "train_summary", "steps": len(step_ms), "step_ms_mean": sum(step_ms) / len(step_ms),
              "step_ms_min": min(step_ms), "params_moved": moved, "ema_moved": ema_moved,
              "optimizer_steps": trainer.state.step, "card": smi})
        if not (moved and ema_moved and trainer.state.step == 6):
            raise AssertionError("parameters or EMA did not move")

        # after the counts were read: one traced step
        batch = next(iter(loader))
        generator = torch.Generator().manual_seed(99)
        emit({"phase": "profile", "mode": "train_step", "card": smi,
              **profile_once(torch, lambda: trainer.train_step(batch, generator))})

        # a checkpoint written, read back, and compared
        t0 = time.perf_counter()
        path = trainer.save_checkpoint(loss=m["loss"])
        trainer.checkpoint_manager.wait()
        wrote = time.perf_counter() - t0
        st = trainer.state
        probes = (st.params[-3], st.ema[5], st.mu[7], st.nu[-3])
        keep = [t.clone() for t in probes]
        step, count = trainer.global_step, st.count
        for t in probes:
            t.zero_()
        t0 = time.perf_counter()
        trainer.load_checkpoint()  # copies into the same tensors
        same = all(torch.equal(k, t) for k, t in zip(keep, probes))
        emit({"phase": "train_checkpoint", "file": path.name, "bytes": path.stat().st_size,
              "write_s": wrote, "read_s": time.perf_counter() - t0, "restored_equal": same,
              "step": trainer.global_step})
        if not (same and trainer.global_step == step and trainer.state.count == count):
            raise AssertionError("the checkpoint did not read back what was written")
    return totals


QMM_SRC = "oron_tts_tpu_torch/csrc/qmm.cu"
# (K, N, per block) of a DiT block's six int8 projections: q, k, v, out, ff1, ff2
BASE_PROJECTIONS = ((1024, 1024, 4), (1024, 4096, 1), (4096, 1024, 1))
SMALL_PROJECTIONS = ((512, 512, 4), (512, 2048, 1), (2048, 512, 1))  # configs/local.yaml
QMM_M = (1664, 6144, 13312)  # one request's 2 x 832 rows; a middle batch; eight merged


def check_qmm(torch, F, report) -> list[dict]:
    """Kernel 9 (w8a16) against its plain version, and w8a8 against the CPU.

    Tolerances. The plain version runs in f32 on the same values and is not
    rounded. f32: 1e-5 of the largest output (sums of up to 4,096 products in
    another order). bf16: the kernel also sums in f32 and rounds once, at its
    output, so it may be off by that rounding, half a bf16 step (2^-8 of
    the value), beyond the f32 bound. Every case also runs with a bias in the
    epilogue, which must equal the product without it plus a separate add in
    x's type, bit for bit, and twice, which must give identical bits.
    """
    from torch.profiler import ProfilerActivity, profile

    from oron_tts_tpu_torch.models.layers import QDense
    from oron_tts_tpu_torch.ops.quantized_matmul import (
        QMM_TILES,
        dequantize_weight,
        int8_product,
        qmm_plan,
        quantize_activations,
        quantize_weight,
        quantized_matmul,
        quantized_matmul_plain,
        w8a8_matmul,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)

    def case(m, k, n, dtype, timed=False, zero_col=False):
        x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
        w = torch.randn(n, k, generator=gen, device=dev) / math.sqrt(k)
        if zero_col:
            w[n // 2] = 0.0  # an all-zero output channel: its scale is 1
        w_q, scale = quantize_weight(w)
        bias = (0.1 * torch.randn(n, generator=gen, device=dev)).to(dtype)
        out = quantized_matmul(x, w_q, scale)
        fused = quantized_matmul(x, w_q, scale, bias)
        same_bias = torch.equal(fused, out + bias)
        twice = torch.equal(quantized_matmul(x, w_q, scale, bias), fused)
        ref = quantized_matmul_plain(x.float(), w_q, scale)
        torch.cuda.synchronize()
        diff = (out.float() - ref).abs()
        top = ref.abs().max().item()
        if dtype == torch.bfloat16:
            excess = (diff - (2.0 ** -8) * ref.abs()).max().item()
        else:
            excess = diff.max().item()
        row = {"name": "quantized_matmul", "dtype": str(dtype), "shape": [m, k, n],
               "plan": list(qmm_plan(m, k, n)) if dtype == torch.bfloat16 else None,
               "max_abs_err": diff.max().item(), "max_excess": excess, "tol": 1e-5 * top,
               "tol_on": "max_excess", "ref_max": top, "bias_bit_equal": same_bias,
               "bit_identical_twice": twice}
        if zero_col and not (scale[n // 2].item() == 1.0
                             and out[:, n // 2].abs().max().item() == 0.0):
            raise AssertionError("quantized_matmul: a zero channel must stay exactly zero")
        if timed:
            w_bf = w.to(dtype)
            b_ms, b_by = bound_ms(2.0 * m * k * n, H100_BF16_FLOPS,
                                  m * k * 2 + n * k + n * 4 + n * 2 + m * n * 2)
            row.update(
                ms=cuda_ms(lambda: quantized_matmul(x, w_q, scale, bias)),
                graph_ms=cuda_graph_ms(lambda: quantized_matmul(x, w_q, scale, bias)),
                plain_ms=cuda_ms(lambda: quantized_matmul_plain(x, w_q, scale, bias), iters=5),
                library_ms=cuda_ms(lambda: F.linear(x, dequantize_weight(w_q, scale, dtype),
                                                    bias)),
                library="dequantize to bf16 + F.linear",
                library_graph_ms=cuda_graph_ms(
                    lambda: F.linear(x, dequantize_weight(w_q, scale, dtype), bias)),
                linear_bf16_ms=cuda_ms(lambda: F.linear(x, w_bf, bias)),
                linear_bf16_graph_ms=cuda_graph_ms(lambda: F.linear(x, w_bf, bias)),
                bound_ms=b_ms, bound_by=b_by)
            row["tflops_graph"] = 2.0 * m * k * n / row["graph_ms"] / 1e9
        emit({"phase": "kernel", **row})
        if not (excess <= row["tol"] and same_bias and twice):
            raise AssertionError(f"quantized_matmul {dtype} [{m},{k},{n}]: off by {excess} "
                                 f"beyond its tolerance {row['tol']}, fused bias equal "
                                 f"{same_bias}, two calls equal {twice}")
        return row

    # ragged edges: M = 1 and 13, N = 40 and 136 (element stores), K = 96;
    # grids of a few blocks (M = 13 and 200); odd counts of k tiles (K = 1,088:
    # 17); a zero channel in each
    for dtype in (torch.float32, torch.bfloat16):
        for m, k, n in ((1, 96, 40), (13, 96, 40), (13, 1024, 1024), (200, 4096, 136),
                        (300, 1024, 200), (1664, 1088, 1024)):
            case(m, k, n, dtype, zero_col=True)
    for k, n, _ in BASE_PROJECTIONS:
        case(1664, k, n, torch.float32)
    timed = {}
    for widths, projections, ms in (("base", BASE_PROJECTIONS, QMM_M),
                                    ("small", SMALL_PROJECTIONS, (1664, 13312))):
        for k, n, _ in projections:
            for m in ms:
                timed[widths, m, k, n] = case(m, k, n, torch.bfloat16, timed=True)

    # the rows of the kernel table: the six projections of one block, times
    # and bounds summed, at M = 1,664 (one request; this is the table's row)
    # and at 13,312 (a merged solve of eight), Base widths
    rows = []
    for m in (1664, 13312):
        block = [(timed["base", m, k, n], count) for k, n, count in BASE_PROJECTIONS]
        row = {"name": "quantized_matmul", "dtype": "torch.bfloat16",
               "shape": f"one block's six projections, M={m}",
               "max_abs_err": max(r["max_abs_err"] for r, _ in block),
               "bound_by": "operations", "route": "cuda", "source": QMM_SRC,
               "replaces": "oron_tts_tpu/ops/quantized_matmul.py:55",
               "library": "dequantize to bf16 + F.linear", "plans": [r["plan"] for r, _ in block]}
        for key in ("ms", "graph_ms", "plain_ms", "library_ms", "library_graph_ms",
                    "linear_bf16_ms", "linear_bf16_graph_ms", "bound_ms"):
            row[key] = sum(r[key] * count for r, count in block)
        row["bound_share_graph"] = row["bound_ms"] / row["graph_ms"]
        row["vs_linear_bf16_graph"] = row["graph_ms"] / row["linear_bf16_graph_ms"]
        if any(r["bound_by"] != "operations" for r, _ in block):
            raise AssertionError(f"a Base projection at M={m} is not bound by operations")
        emit({"phase": "kernel_block", **row})
        if m == 1664:
            rows.append(row)

    # the grid, through the C entry (the wrapper's count does not move): the
    # plan's tile against every other tile the kernel is built for, at one
    # request's q/k/v/out shape (the plan: 104 blocks of 128 rows in one
    # partial wave) and at a short request's (two CFG rows of a 64-frame
    # bucket: 16 blocks of 64 rows)
    from oron_tts_tpu_torch.ops import _build

    lib = _build.load("qmm")
    grids = {}
    for m, k, n in ((1664, 1024, 1024), (128, 1024, 1024)):
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        w_q, scale = quantize_weight(torch.randn(n, k, generator=gen, device=dev) / math.sqrt(k))
        bias = (0.1 * torch.randn(n, generator=gen, device=dev)).to(torch.bfloat16)
        want = quantized_matmul(x, w_q, scale, bias)

        def direct(bm):
            out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
            _build.check(lib.qmm_w8a16(
                x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
                m, k, n, bm, 1, _build.stream_ptr(dev)), "qmm_w8a16")
            return out

        by_tile = {}
        for bm in QMM_TILES:
            got = direct(bm)
            by_tile[f"bm{bm}"] = {
                "graph_ms": cuda_graph_ms(lambda: direct(bm)),
                "max_abs_diff_vs_plan": (got.float() - want.float()).abs().max().item()}
        grids[f"{m}x{k}x{n}"] = {"plan": list(qmm_plan(m, k, n)), "by_tile": by_tile}
    emit({"phase": "qmm_grid", "shapes": grids})

    # QDense (int8) launches the kernel alone: the bias is in its epilogue
    lin = torch.nn.Linear(1024, 1024).to(dev, torch.bfloat16)
    layer = QDense.from_linear(lin, "int8")
    x = torch.randn(2, 832, 1024, generator=gen, device=dev).to(torch.bfloat16)
    with torch.no_grad():
        layer(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            layer(x)
            torch.cuda.synchronize()
    names = [ev.name for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA]
    emit({"phase": "qdense_launches", "input": [2, 832, 1024], "device_kernels": names})
    if len(names) != 1 or "qmm_" not in names[0]:
        raise AssertionError(f"QDense (int8) launched {names}, not the w8a16 kernel alone")

    # what torch._int_mm takes on this card (reported, not relied on: the port
    # asks int8_product, which falls back to an exact float64 product)
    probes = {}
    for m, k, n in ((17, 64, 64), (16, 64, 64), (32, 100, 64), (32, 64, 40), (32, 64, 44)):
        a = torch.ones(m, k, dtype=torch.int8, device=dev)
        b = torch.ones(n, k, dtype=torch.int8, device=dev)
        try:
            probes[f"{m}x{k}x{n}"] = bool((torch._int_mm(a, b.t()) == k).all().item())
        except RuntimeError as exc:  # a probe of the library's limits, printed
            probes[f"{m}x{k}x{n}"] = "refused: " + str(exc).splitlines()[0][:90]
    emit({"phase": "int_mm_probe", "accepted": probes})

    # w8a8 on the card against the CPU's result on the same values: the
    # int8 activations and the s32 product are exact on both, the f32 rescale
    # multiplies in the same order
    for m, k, n in ((1664, 1024, 4096), (13, 96, 40), (40, 100, 44)):
        x = torch.randn(m, k, generator=gen, device=dev)
        w_q, scale = quantize_weight(torch.randn(n, k, generator=gen, device=dev) / math.sqrt(k))
        x_q = quantize_activations(x)[0]
        exact = (torch.equal(x_q.cpu(), quantize_activations(x.cpu())[0])
                 and torch.equal(int8_product(x_q, w_q).cpu(), int8_product(x_q.cpu(), w_q.cpu())))
        got = w8a8_matmul(x, w_q, scale)
        want = w8a8_matmul(x.cpu(), w_q.cpu(), scale.cpu())
        err = ((got.cpu() - want).abs().max() / want.abs().max()).item()
        emit({"phase": "w8a8", "shape": [m, k, n], "max_rel_err": err, "tol": 1e-6,
              "integers_equal_to_cpu": exact})
        if not (err <= 1e-6 and exact):
            raise AssertionError(f"w8a8_matmul on the card differs from the CPU: {err}")
    times = {}
    for k, n, _ in BASE_PROJECTIONS:
        x = torch.randn(1664, k, generator=gen, device=dev).to(torch.bfloat16)
        w_q, scale = quantize_weight(torch.randn(n, k, generator=gen, device=dev) / math.sqrt(k))
        x_q = quantize_activations(x)[0]
        times[f"{k}x{n}"] = {
            "w8a8_matmul_ms": cuda_ms(lambda: w8a8_matmul(x, w_q, scale)),
            "int8_product_only_ms": cuda_ms(lambda: int8_product(x_q, w_q)),
            "linear_bf16_ms": timed["base", 1664, k, n]["linear_bf16_ms"]}
    emit({"phase": "w8a8_time", "m": 1664, "dtype": "torch.bfloat16", "by_shape": times})
    return rows


def check_reference_serve(torch) -> None:
    """Small f32 model with int8 weights: card (kernel) against CPU (plain).

    Same weights, same injected noise. ``int8`` repeats the unquantized
    reference's arithmetic with exact integers: mel within 1e-3 of its largest
    value. Under
    ``int8_dynamic`` an activation next to a rounding boundary may land on
    the neighbouring integer on the two devices (1/127 of its token's
    largest value), so the mel is held to 2e-2 of its largest value.
    """
    from oron_tts_tpu_torch.config import F5Config, ModelConfig
    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from oron_tts_tpu_torch.ops.quantized_matmul import quantized_matmul
    from oron_tts_tpu_torch.utils.weights import seeded_dit_params

    mcfg = ModelConfig(dim=256, depth=2, heads=4, text_dim=64, conv_layers=1)
    params = seeded_dit_params(mcfg, seed=1)
    rng = torch.Generator().manual_seed(2)
    B, T = 2, 192
    durs, refs = [170, 121], [40, 0]
    cond = torch.zeros(B, T, 100)
    cond[0, :40] = torch.randn(40, 100, generator=rng)
    ids = torch.randint(1, 64, (B, T), generator=rng)
    for b, d in enumerate(durs):
        ids[b, d:] = -1
    noise = torch.randn(B, T, 100, generator=rng)
    for mode, tol in (("int8", 1e-3), ("int8_dynamic", 2e-2)):
        mels = []
        for device in ("cuda", "cpu"):
            model = F5TTS(F5Config(model=mcfg), device=device, dtype=torch.float32)
            model.load_params(params)
            model.quantize_for_serving(mode)
            quantized_matmul.launches = 0
            mels.append(model.cfm.sample(
                cond.to(device), ids.to(device), torch.tensor(durs), torch.tensor(refs),
                steps=4, cfg_strength=2.0, sway_sampling_coef=-1.0, noise=noise,
                cfg_interval=(0.1, 0.7), method="midpoint")[0].cpu())
            if device == "cuda":
                launches = quantized_matmul.launches
        err = (mels[0] - mels[1]).abs().max().item()
        top = mels[1].abs().max().item()
        emit({"phase": "reference_serve", "mode": mode, "mel_max_abs_err": err,
              "mel_tol": tol * top, "mel_max": top, "kernel_launches_on_card": launches})
        # 4 midpoint steps = 8 forwards of 2 blocks x 6 projections
        if not (err <= tol * top and launches == (96 if mode == "int8" else 0)):
            raise AssertionError(f"card and CPU disagree on the small {mode} model")


def serve_params(cfg) -> dict:
    """Seeded Base weights with the text blocks' GRN ``gamma`` at zero, as at initialisation.

    That GRN normalises by a sum over the whole padded sequence (in the JAX
    package and upstream alike), so with a non-zero ``gamma`` a row feels
    how much padding its bucket adds and "merged equals solo" cannot hold
    across buckets for any implementation. ``run_batch_knee`` reports how
    large that effect is on the unmodified seeded weights.
    """
    from oron_tts_tpu_torch.utils.weights import seeded_dit_params

    params = seeded_dit_params(cfg.model, seed=0)
    for name, block in params["text_embed"].items():
        if name.startswith("block"):
            block["grn"]["gamma"][...] = 0.0
    return params


def letters(n: int, salt: int = 0) -> str:
    """A text of exactly ``n`` Mongolian letters in short words (``13 n`` target frames)."""
    alphabet = "абвгдеёжзийклмноөпрстуүфхцчшыэюя"
    out, i = [], salt
    while sum(len(w) for w in out) < n:
        size = min(3 + (i * 7 + salt) % 5, n - sum(len(w) for w in out))
        out.append("".join(alphabet[(i * 11 + j * 5 + salt) % len(alphabet)] for j in range(size)))
        i += 1
    return " ".join(out)


def run_batch_knee(torch, smi: str) -> None:
    """Per-row solve time of ``synthesize_batch`` against rows x bucket (Base, bf16)."""
    import numpy as np

    from oron_tts_tpu_torch.config import F5Config
    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from oron_tts_tpu_torch.utils.weights import seeded_dit_params

    cfg = F5Config()
    model = F5TTS(cfg)
    model.load_params(seeded_dit_params(cfg.model, seed=0))
    model.load_vocoder()
    budget = F5TTS.GROUP_FRAME_BUDGET
    F5TTS.GROUP_FRAME_BUDGET = 1 << 30  # the sweep looks past the constant it informs
    points = []
    try:
        model.synthesize_batch([letters(64)], n_steps=2, seed=0, max_chars_per_chunk=0)
        # the 16-row point, the 1,600-frame rows and the 2- and 4-row points
        # are left out for the script's length (PERF.md keeps their earlier
        # readings)
        for n_letters, bucket, row_counts in ((64, 832, (1, 8)),):
            for rows in row_counts:
                texts = [letters(n_letters, salt=r) for r in range(rows)]
                best = None
                for _ in range(2):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    wavs = model.synthesize_batch(texts, n_steps=8, seed=0, max_batch=rows,
                                                  max_chars_per_chunk=0)
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                    best = dt if best is None else min(best, dt)
                if any(len(w) != n_letters * 13 * cfg.audio.hop_length for w in wavs):
                    raise AssertionError("batch_knee: a row has the wrong length")
                points.append({"rows": rows, "bucket": bucket, "frames": rows * bucket,
                               "solve_s": best, "per_row_s": best / rows,
                               "per_row_frame_us": best / rows / bucket * 1e6})
        # how much a row feels its bucket on the unmodified seeded weights
        # (the text blocks' GRN sums over the padding too): one text at its
        # own bucket and padded to 1,600 frames
        text = letters(64)
        own = model.synthesize_mel(text, n_steps=8, seed=0)
        model.pad_to_multiple = 1600
        wide = model.synthesize_mel(text, n_steps=8, seed=0)
        model.pad_to_multiple = 64
        leak = float(np.linalg.norm(own - wide) / np.linalg.norm(own))
    finally:
        F5TTS.GROUP_FRAME_BUDGET = budget
    emit({"phase": "batch_knee", "steps": 8, "points": points, "group_frame_budget": budget,
          "bucket_leak_rel_l2_seeded_weights": leak, "card": smi})
    del model
    torch.cuda.empty_cache()


def http_post(port: int, path: str, payload: dict, timeout: float = 600.0):
    """(status, headers, body) of one POST to the server in this process."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers, exc.read()


def http_health(port: int) -> tuple[int, dict]:
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


# Waveforms of two runs that should be "the same" are compared by the relative
# L2 distance. In f32 that is rounding (2e-5 on the CPU). In bf16 a merged
# solve runs its matmuls at another M than the solo solve, the library picks
# other tilings, sums round elsewhere in bf16, 32 steps x 22 blocks carry that
# along and the vocoder's phase head amplifies it: this script read 0.009 to
# 0.046 over 24 requests on an H100 (PERF.md); the bound leaves 3x room.
MERGED_REL_L2_TOL = 0.15
# chunks solved at the same shapes on both routes: equal up to PCM16 rounding
STREAM_ABS_TOL = 1e-4
# mel of a quantized model against the bf16 model's, same seed, relative L2:
# the JAX package's own bounds for its small f32 model
# (tests/test_quantized.py: 0.01 for int8, 0.03 for int8_dynamic), which the
# Base model in bf16 over 32 steps also keeps (0.0017 and 0.0018 measured)
QUANT_MEL_REL_L2_TOL = {"int8": 0.01, "fast": 0.03}


def rel_l2(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def run_serve(torch, smi: str) -> dict[str, int]:
    """The HTTP server at the Base width: bf16, ``--quantize int8``, ``--profile fast``."""
    import base64
    import http.client
    import threading

    import numpy as np

    from oron_tts_tpu_torch.cli import serve
    from oron_tts_tpu_torch.config import F5Config
    from oron_tts_tpu_torch.data.wav import read_wav_bytes, wav_bytes
    from oron_tts_tpu_torch.models.f5tts import F5TTS, split_text_for_synthesis
    from oron_tts_tpu_torch.ops.flash_attention import flash_lanes_fwd
    from oron_tts_tpu_torch.ops.fused_mel import log_mel_fused
    from oron_tts_tpu_torch.ops.grouped_conv import grouped_conv1d_mish
    from oron_tts_tpu_torch.ops.quantized_matmul import quantized_matmul
    from oron_tts_tpu_torch.train.checkpoint import flatten_tree, write_npz

    kernels = (flash_lanes_fwd, grouped_conv1d_mish, log_mel_fused, quantized_matmul)
    cfg = F5Config.from_dict({"model": {"depth": CUT_DEPTH}})
    depth, hop, rate = cfg.model.depth, cfg.audio.hop_length, cfg.audio.sample_rate
    eight = [letters(60 + i % 5, salt=i) for i in range(8)]  # 780-832 frames: bucket 832
    seeds = [11 + 3 * i for i in range(8)]
    # three chunks (1,274, 871 and 455 frames) whose lengths lie too far apart
    # to share a group, so that the stream and /synthesize solve each chunk at
    # the same shape and can be held to each other sample by sample
    paragraph = f"{letters(97, 1)}. {letters(66, 2)}. {letters(34, 3)}."
    chunk_frames = [13 * len(c.replace(" ", "")) for c in split_text_for_synthesis(paragraph, 120)]
    if len(chunk_frames) != 3 or any(len(g) != 1 for g in F5TTS._length_groups(
            chunk_frames, 64, 16)):
        raise AssertionError(f"the stream's paragraph no longer gives three lone chunks: "
                             f"{chunk_frames}")
    wav_ref = 0.3 * np.random.default_rng(0).standard_normal(5 * rate).astype(np.float32)
    ref_b64 = base64.b64encode(wav_bytes(wav_ref, rate, subtype="float32")).decode()
    totals = {k.__name__: 0 for k in kernels}
    bf16_mels: dict[str, np.ndarray] = {}
    merged: dict[str, dict] = {}  # per mode: the merged solve's per-row time and its trace

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_npz(Path(tmp) / "f5tts_step_00000001.npz",
                  flatten_tree({"params": serve_params(cfg)}))
        (Path(tmp) / "config.json").write_text(json.dumps({"model": {"depth": depth}}))
        emit({"phase": "serve_checkpoint", "seconds": time.perf_counter() - t0,
              "bytes": (Path(tmp) / "f5tts_step_00000001.npz").stat().st_size})

        for mode, flags in (("bf16", []), ("int8", ["--quantize", "int8"]),
                            ("fast", ["--profile", "fast"])):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            server = serve.create_server(["--checkpoint", tmp, "--port", "0", "--warmup",
                                          "--max-queue", "8", *flags])
            service, port = server.service, server.server_address[1]
            model = service.model
            loop = threading.Thread(target=server.serve_forever, name="serve-forever")
            loop.start()
            if not (model.device.type == "cuda" and model.dtype == torch.bfloat16
                    and model.config.model.dim == 1024 and model.config.model.depth == depth):
                raise AssertionError("the server did not load the Base width in bf16 on the card")
            for k in kernels:
                k.launches = 0
            code, health = http_health(port)
            if code != 200 or health["status"] != "ok" or health["device"] != "cuda":
                raise AssertionError(f"{mode}: /healthz said {code} {health}")
            report = {"phase": "serve", "mode": mode, "card": smi,
                      "start_s": time.perf_counter() - t0,
                      "weight_bytes": model.weight_bytes(), "params": health["params"]}

            def post_wav(payload: dict) -> tuple[np.ndarray, float]:
                t = time.perf_counter()
                status, headers, body = http_post(port, "/synthesize", payload)
                dt = time.perf_counter() - t
                if status != 200 or headers.get("Content-Type") != "audio/wav":
                    raise AssertionError(f"{mode}: /synthesize said {status} {body[:200]!r}")
                wav, sr = read_wav_bytes(body)
                if sr != rate or not (np.isfinite(wav).all() and float(np.abs(wav).max()) > 0):
                    raise AssertionError(f"{mode}: /synthesize returned no sound")
                return wav, dt

            # one ref-free request, alone
            before = quantized_matmul.launches
            wav, dt = post_wav({"text": MN_TEXT, "seed": 0, "steps": SERVE_STEPS})
            qmm_solo = quantized_matmul.launches - before
            if len(wav) != len(MN_TEXT.replace(" ", "")) * 13 * hop:
                raise AssertionError(f"{mode}: {len(wav)} samples, not 13 frames a letter")
            report["solo"] = {"latency_s": dt, "audio_s": len(wav) / rate,
                              "rtf": dt / (len(wav) / rate), "qmm_launches": qmm_solo}

            # eight solo answers, then the same eight at once: one merged solve
            solo = [post_wav({"text": t, "seed": s, "steps": SERVE_STEPS})
                    for t, s in zip(eight, seeds)]
            merged_before = http_health(port)[1]["merged_batches"]
            before = quantized_matmul.launches
            with service.model_lock:  # a busy device: the requests queue behind it
                first = threading.Thread(target=http_post, args=(
                    port, "/synthesize", {"text": "за", "seed": 1, "steps": 2}))
                first.start()
                time.sleep(0.3)  # the dispatcher has taken it and waits for the lock
                results: list = [None] * 8

                def one(i: int) -> None:
                    results[i] = post_wav({"text": eight[i], "seed": seeds[i],
                                           "steps": SERVE_STEPS})

                pending = [threading.Thread(target=one, args=(i,)) for i in range(8)]
                for th in pending:
                    th.start()
                deadline = time.monotonic() + 60
                while service.batcher._queued < 8 and time.monotonic() < deadline:
                    time.sleep(0.01)
                queued = service.batcher._queued
                torch.cuda.synchronize()
                t_release = time.perf_counter()
            first.join(timeout=600)
            for th in pending:
                th.join(timeout=600)
            merged_s = time.perf_counter() - t_release
            if queued != 8 or any(r is None for r in results) or first.is_alive():
                raise AssertionError(f"{mode}: the eight requests did not all queue and return")
            merged_batches = http_health(port)[1]["merged_batches"] - merged_before
            devs = [rel_l2(got[0], want[0]) for got, want in zip(results, solo)]
            report["merged"] = {
                "requests": 8, "bucket": 832, "merged_batches": merged_batches,
                "wall_s_after_release": merged_s, "per_row_s": merged_s / 8,
                "solo_latency_s_mean": sum(d for _, d in solo) / 8,
                "rel_l2_vs_solo_max": max(devs), "rel_l2_vs_solo": devs,
                "tol": MERGED_REL_L2_TOL,
                "qmm_launches": quantized_matmul.launches - before,
            }
            if merged_batches < 1:
                raise AssertionError(f"{mode}: no merged batch")
            if any(g[0].shape != w[0].shape for g, w in zip(results, solo)) or not (
                    max(devs) <= MERGED_REL_L2_TOL):
                raise AssertionError(f"{mode}: a merged request differs from its solo audio: "
                                     f"{devs}")

            # the solve itself, without HTTP and queueing: eight rows against one
            with service.model_lock:
                timing = {}
                for name, texts_, seeds_ in (("rows8", eight, seeds), ("rows1", eight[:1], seeds[:1])):
                    best = None
                    for _ in range(2):
                        torch.cuda.synchronize()
                        t = time.perf_counter()
                        model.synthesize_batch(texts_, seeds=seeds_, n_steps=SERVE_STEPS,
                                               **service.profile_defaults)
                        torch.cuda.synchronize()
                        dt = time.perf_counter() - t
                        best = dt if best is None else min(best, dt)
                    timing[name + "_solve_s"] = best
            timing["per_row_s"] = timing["rows8_solve_s"] / 8
            report["merged_solve"] = timing

            # a voice-cloned request (base64 reference)
            wav, dt = post_wav({"text": MN_TEXT, "seed": 0, "steps": SERVE_STEPS,
                                "ref_audio_b64": ref_b64, "ref_text": REF_TEXT})
            report["cloned"] = {"latency_s": dt, "audio_s": len(wav) / rate,
                                "rtf": dt / (len(wav) / rate)}

            # /synthesize_batch of four texts
            t = time.perf_counter()
            status, _, body = http_post(port, "/synthesize_batch", {
                "texts": eight[:4], "seed": 5, "steps": SERVE_STEPS})
            dt = time.perf_counter() - t
            wavs = [read_wav_bytes(base64.b64decode(b))[0]
                    for b in json.loads(body)["wavs_base64"]] if status == 200 else []
            if status != 200 or [len(w) for w in wavs] != [
                    len(t_.replace(" ", "")) * 13 * hop for t_ in eight[:4]]:
                raise AssertionError(f"{mode}: /synthesize_batch said {status}")
            audio = sum(len(w) for w in wavs) / rate
            report["batch4"] = {"latency_s": dt, "audio_s": audio, "rtf": dt / audio}

            # /synthesize_stream: time to the first audio bytes, total, and the
            # joined pieces against /synthesize
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
            payload = json.dumps({"text": paragraph, "seed": 7, "steps": SERVE_STEPS})
            t = time.perf_counter()
            conn.request("POST", "/synthesize_stream", body=payload)
            resp = conn.getresponse()
            head = resp.read(44 + 2)  # the WAV header and the first sample
            ttfa = time.perf_counter() - t
            streamed = head + resp.read()
            total = time.perf_counter() - t
            conn.close()
            whole, whole_s = post_wav({"text": paragraph, "seed": 7, "steps": SERVE_STEPS})
            got = read_wav_bytes(streamed)[0]
            dev = float(np.abs(got - whole).max()) if got.shape == whole.shape else float("inf")
            report["stream"] = {"chunk_frames": chunk_frames, "ttfa_s": ttfa, "total_s": total,
                                "synthesize_s": whole_s, "audio_s": len(whole) / rate,
                                "max_abs_dev_vs_synthesize": dev, "tol": STREAM_ABS_TOL}
            if resp.status != 200 or not dev <= STREAM_ABS_TOL:
                raise AssertionError(f"{mode}: the stream differs from /synthesize by {dev}")

            # the mel of this model against the bf16 model's, same seed
            kw = {"cfg_interval": serve.FAST_PROFILE_CFG_INTERVAL} if mode == "fast" else {}
            with service.model_lock:
                mel = model.synthesize_mel(MN_TEXT, n_steps=SERVE_STEPS, seed=0, **kw)
                if mode == "bf16":
                    bf16_mels["int8"] = mel
                    bf16_mels["fast"] = model.synthesize_mel(
                        MN_TEXT, n_steps=SERVE_STEPS, seed=0,
                        cfg_interval=serve.FAST_PROFILE_CFG_INTERVAL)
            if mode != "bf16":
                dev = rel_l2(mel, bf16_mels[mode])
                report["mel_rel_l2_vs_bf16"] = dev
                report["mel_tol"] = QUANT_MEL_REL_L2_TOL[mode]
                if not dev <= QUANT_MEL_REL_L2_TOL[mode]:
                    raise AssertionError(f"{mode}: mel deviates from bf16 by {dev}")

            # a full queue sheds with 429 + Retry-After; the queued ones are served
            with service.model_lock:
                first = threading.Thread(target=http_post, args=(
                    port, "/synthesize", {"text": "за", "seed": 1, "steps": 2}))
                first.start()
                time.sleep(0.3)
                fill = [threading.Thread(target=http_post, args=(
                    port, "/synthesize", {"text": "за", "seed": i, "steps": 2}))
                    for i in range(8)]
                for th in fill:
                    th.start()
                deadline = time.monotonic() + 60
                while service.batcher._queued < 8 and time.monotonic() < deadline:
                    time.sleep(0.01)
                status, headers, body = http_post(port, "/synthesize",
                                                  {"text": "за", "steps": 2})
            for th in [first, *fill]:
                th.join(timeout=600)
            report["shed"] = {"status": status, "retry_after": headers.get("Retry-After"),
                              "shed_requests": http_health(port)[1]["shed_requests"]}
            if status != 429 or not headers.get("Retry-After") or b"overloaded" not in body:
                raise AssertionError(f"{mode}: a full queue answered {status}")

            # the counters of the main path, read before anything else runs
            counts = {k.__name__: k.launches for k in kernels}
            report["launches"] = counts
            if mode == "int8":
                # 6 projections x 22 blocks x 32 steps, for one row or eight
                want = 6 * depth * SERVE_STEPS
                if qmm_solo != want or report["merged"]["qmm_launches"] != want + 6 * depth * 2:
                    raise AssertionError(
                        f"int8: quantized_matmul launched {qmm_solo} times for the solo "
                        f"request and {report['merged']['qmm_launches']} for the merged "
                        f"solve plus its 2-step blocker, expected {want} and "
                        f"{want + 6 * depth * 2}")
                for name, n in counts.items():
                    totals[name] += n
            elif counts["quantized_matmul"] != 0:
                raise AssertionError(f"{mode}: the w8a16 kernel ran without --quantize int8")
            # after the counts were read: one traced merged solve
            traced = profile_once(torch, lambda: model.synthesize_batch(
                eight, seeds=seeds, n_steps=SERVE_STEPS, **service.profile_defaults))
            emit({"phase": "profile", "mode": f"serve_{mode}_merged_8x832", "card": smi,
                  **traced})
            merged[mode] = {"per_row_s": timing["per_row_s"], "traced": traced}

            # drain: a request in flight is answered, then the server is gone
            inflight: dict = {}
            client = threading.Thread(target=lambda: inflight.update(
                resp=post_wav({"text": eight[0], "seed": 2, "steps": SERVE_STEPS})))
            client.start()
            time.sleep(0.2)
            serve.begin_drain(server)
            draining = service.draining
            server.server_close()  # joins the handler in flight
            client.join(timeout=600)
            loop.join(timeout=60)
            service.close()
            report["drain"] = {"answered_in_flight": "resp" in inflight,
                               "threads_left": [t.name for t in threading.enumerate()
                                                if t is not threading.main_thread()
                                                and not t.daemon]}
            if not (draining and "resp" in inflight and not loop.is_alive()
                    and not client.is_alive()):
                raise AssertionError(f"{mode}: the drain dropped the request in flight")
            report["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
            report["requests"] = service.health()["requests"]
            report["mode_s"] = time.perf_counter() - t0
            emit(report)
            del server, service, model

    # int8 against bf16 on the merged 8 x 832 solve: per-row time, and the
    # device time of kernel 9 against bf16's cuBLAS products
    kinds = {mode: r["traced"]["device_s_by_kind"] for mode, r in merged.items()}
    emit({"phase": "serve_int8_vs_bf16", "card": smi,
          "per_row_s": {mode: r["per_row_s"] for mode, r in merged.items()},
          "int8_over_bf16_per_row": merged["int8"]["per_row_s"] / merged["bf16"]["per_row_s"],
          "wall_s_traced": {mode: r["traced"]["wall_s"] for mode, r in merged.items()},
          "device_busy_s": {mode: r["traced"]["device_busy_s"] for mode, r in merged.items()},
          "device_kernels": {mode: r["traced"]["device_kernels"] for mode, r in merged.items()},
          "quantized_matmul_device_s": kinds["int8"].get("quantized_matmul", 0.0),
          "matmul_device_s": {mode: k.get("matmul", 0.0) for mode, k in kinds.items()},
          "other_device_s": {mode: k.get("other", 0.0) for mode, k in kinds.items()}})
    return totals


CLASSIC_MEL_REL_L2_TOL = 0.1  # bf16, 32 steps x 22 blocks, other roundings of the same math
CLASSIC_LOSS_REL_TOL = 1e-2   # one bf16 forward of the same weights, batch and noise


def kernel_wrappers() -> dict:
    """The attention and GELU+dropout wrappers whose launches the classic phase counts."""
    from oron_tts_tpu_torch.ops import flash_attention as fa
    from oron_tts_tpu_torch.ops.gelu_dropout import gelu_dropout_bwd, gelu_dropout_fwd

    return {f.__name__: f for f in (
        fa.flash_attention, fa.flash_attention_packed, fa.flash_attention_bwd, fa.flash_nosm,
        fa.flash_lanes_fwd, fa.flash_lanes_fwd_stats, fa.flash_lanes_bwd, gelu_dropout_fwd,
        gelu_dropout_bwd)}


def zero_counts(wrappers: dict) -> None:
    import torch

    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0


def read_counts(wrappers: dict) -> dict[str, int]:
    import torch

    torch.cuda.synchronize()
    return {n: fn.launches for n, fn in wrappers.items()}


def with_attn_impl(torch, model, impl: str, state: dict):
    """Rebuild ``model``'s backbone (an F5TTS) under ``attn_impl=impl`` from ``state``.

    ``F5TTS`` has no ``attn_impl`` (neither has the JAX facade); the switch
    lives on ``DiT``, as in the JAX package's ``bench.py``.
    """
    from oron_tts_tpu_torch.models.cfm import CFM
    from oron_tts_tpu_torch.models.dit import DiT

    m, a = model.config.model, model.config.audio
    model.backbone = model.cfm = None
    with torch.device(model.device):
        dit = DiT(dim=m.dim, depth=m.depth, heads=m.heads, dim_head=m.dim_head,
                  ff_mult=m.ff_mult, mel_dim=a.n_mels, vocab_size=m.vocab_size,
                  text_dim=m.text_dim, conv_layers=m.conv_layers, dropout=m.p_dropout,
                  attn_impl=impl)
    dit = dit.to(model.dtype).eval()
    dit.load_state_dict(state, strict=True)
    if dit.attn_impl != impl:
        raise AssertionError(f"asked for {impl}, the blocks run {dit.attn_impl}")
    model.backbone = dit
    model.cfm = CFM(dit, n_mels=a.n_mels, audio_drop_prob=m.audio_drop_prob,
                    cond_drop_prob=m.cond_drop_prob, frac_lengths_mask=m.frac_lengths_mask)
    return model


def run_classic(torch, smi: str) -> dict[str, int]:
    """Synthesis and training on the classic-layout attention, and the two benches."""
    import numpy as np

    from oron_tts_tpu_torch.cli import bench_attention, bench_model_ablation
    from oron_tts_tpu_torch.config import F5Config
    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from oron_tts_tpu_torch.train.trainer import F5Trainer
    from oron_tts_tpu_torch.utils.weights import from_flax_params, seeded_dit_params

    wrappers = kernel_wrappers()
    totals = {n: 0 for n in wrappers}

    def add(counts: dict) -> None:
        for n, c in counts.items():
            totals[n] += c

    cfg = F5Config.from_dict({"model": {"depth": CUT_DEPTH}})
    depth, hop, rate = cfg.model.depth, cfg.audio.hop_length, cfg.audio.sample_rate
    params = seeded_dit_params(cfg.model, seed=0)
    state = from_flax_params(params)
    model = F5TTS(cfg)
    model.load_params(params)
    model.load_vocoder()

    # synthesis: bench.py's protocol, the same text ids and noise for every impl
    frames = SYNTH_LETTERS * 13
    T = -(-frames // 64) * 64
    gen = torch.Generator().manual_seed(0)
    text = torch.randint(0, 65, (1, T), generator=gen).to(model.device)
    noise = torch.randn(1, T, cfg.audio.n_mels, generator=gen)
    cond = torch.zeros(1, T, cfg.audio.n_mels, device=model.device)
    duration, lens = torch.tensor([frames]), torch.tensor([0])
    audio_s = frames * hop / rate
    mels = {}
    for impl in ("lanes", "flash", "packed"):
        with_attn_impl(torch, model, impl, state)

        def solve(steps: int):
            mel, _ = model.cfm.sample(cond, text, duration, lens, steps=steps,
                                      cfg_strength=2.0, sway_sampling_coef=-1.0, noise=noise)
            return mel, model._decode_mel(mel[:, :frames].transpose(1, 2))

        solve(2)  # warm-up
        zero_counts(wrappers)
        t0 = time.perf_counter()
        mel, wav = solve(SYNTH_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts(wrappers)
        mels[impl] = mel[0, :frames].float().cpu().numpy()
        row = {"phase": "classic_synthesis", "impl": impl, "frames": frames, "bucket": T,
               "steps": SYNTH_STEPS, "wall_s": wall, "audio_s": audio_s, "rtf": wall / audio_s,
               "samples": len(wav), "launches": {n: c for n, c in counts.items() if c},
               "card": smi}
        if impl != "lanes":
            row["mel_rel_l2_vs_lanes"] = rel_l2(mels[impl], mels["lanes"])
            row["tol"] = CLASSIC_MEL_REL_L2_TOL
        emit(row)
        want = {"lanes": "flash_lanes_fwd", "flash": "flash_attention",
                "packed": "flash_attention_packed"}[impl]
        attn = {n: c for n, c in counts.items() if n.startswith("flash_")}
        if attn != {n: (SYNTH_STEPS * depth if n == want else 0) for n in attn}:
            raise AssertionError(f"{impl} synthesis launched {attn}, expected "
                                 f"{SYNTH_STEPS * depth} of {want} and nothing else")
        if not (np.isfinite(wav).all() and len(wav) == frames * hop and np.abs(wav).max() > 0):
            raise AssertionError(f"{impl} synthesis: no finite sound of {frames} frames")
        if impl != "lanes" and not row["mel_rel_l2_vs_lanes"] <= CLASSIC_MEL_REL_L2_TOL:
            raise AssertionError(f"{impl} synthesis: mel {row['mel_rel_l2_vs_lanes']} from lanes")
        if impl != "lanes":
            add(counts)
    del mels

    # training: CFM.loss -> backward -> guarded_update on attn_impl="flash", as
    # bench.py does with ORON_TRAIN_IMPL=flash; the lanes loss on the same
    # batch and generator seed first
    rng = np.random.default_rng(7)
    batch = {"mel": (0.5 * rng.standard_normal((TRAIN_B, cfg.audio.n_mels, TRAIN_T))
                     ).astype(np.float32),
             "text_ids": rng.integers(0, 65, (TRAIN_B, TRAIN_T)).astype(np.int32),
             "mel_lengths": np.asarray(train_clip_frames()[:TRAIN_B], np.int32)}
    kept = int(batch["mel_lengths"].sum())
    with_attn_impl(torch, model, "lanes", state)
    dev_batch = {k: torch.from_numpy(v).to(model.device) for k, v in batch.items()}
    with torch.no_grad():
        lanes_loss = model.cfm.loss(dev_batch["mel"], dev_batch["text_ids"],
                                    dev_batch["mel_lengths"], torch.Generator().manual_seed(0),
                                    train=True).item()
    del dev_batch
    with_attn_impl(torch, model, "flash", state)
    config = {"learning_rate": 1e-4, "warmup_steps": 2, "num_epochs": 1, "use_tqdm": False}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        trainer = F5Trainer(config, model, [batch], log_dir=f"{tmp}/logs",
                            checkpoint_dir=f"{tmp}/ckpt")
        step_ms, want = [], {"flash_attention": depth, "flash_attention_bwd": depth,
                             "gelu_dropout_fwd": depth, "gelu_dropout_bwd": depth}
        for step in range(5):
            zero_counts(wrappers)
            t0 = time.perf_counter()
            m = trainer.train_step(batch, torch.Generator().manual_seed(step))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = read_counts(wrappers)
            add(counts)
            if step >= 2:
                step_ms.append(ms)
            if step == 0:
                loss_rel = abs(m["loss"] - lanes_loss) / abs(lanes_loss)
            emit({"phase": "classic_train", "step": step, "timed": step >= 2,
                  "batch": [TRAIN_B, TRAIN_T], "kept_frames": kept, "loss": m["loss"],
                  "grad_norm": m["grad_norm"], "ok": m["ok"], "step_ms": ms,
                  "frames_per_s": kept / ms * 1e3, "launches": {n: c for n, c in counts.items() if c},
                  "card": smi})
            if not (m["ok"] and math.isfinite(m["loss"])):
                raise AssertionError(f"classic training step {step} not finite: {m}")
            if {n: c for n, c in counts.items() if c} != want:
                raise AssertionError(f"classic training step {step}: launches {counts}, "
                                     f"expected {want}")
        # after the counts were read: one traced step on "flash", beside the
        # train phase's traced step on "lanes"
        emit({"phase": "profile", "mode": "train_step_flash", "card": smi,
              **profile_once(torch, lambda: trainer.train_step(
                  batch, torch.Generator().manual_seed(5)))})
        del trainer
    mean = sum(step_ms) / len(step_ms)
    emit({"phase": "classic_train_summary", "impl": "flash", "step_ms_mean": mean,
          "step_ms_min": min(step_ms), "frames_per_s": kept / mean * 1e3,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "first_step_loss_vs_lanes_rel": loss_rel, "lanes_loss": lanes_loss,
          "tol": CLASSIC_LOSS_REL_TOL, "card": smi})
    if not loss_rel <= CLASSIC_LOSS_REL_TOL:
        raise AssertionError(f"the flash step's loss is {loss_rel} from the lanes loss")
    del model
    torch.cuda.empty_cache()

    # the two bench entry points, as a user runs them
    zero_counts(wrappers)
    res = bench_attention.main(["--t", "1664", "--backward"])
    counts = read_counts(wrappers)
    add(counts)
    emit({"phase": "bench_attention", "ms": {k: v * 1e3 for k, v in res.items()},
          "launches": {n: c for n, c in counts.items() if c}, "card": smi})
    if counts["flash_nosm"] == 0 or counts["flash_attention_bwd"] == 0:
        raise AssertionError(f"bench_attention did not run kernels 12 and 7: {counts}")
    torch.cuda.empty_cache()
    zero_counts(wrappers)
    res = bench_model_ablation.main([])
    counts = read_counts(wrappers)
    add(counts)
    deep = {impl: res["device"][(22, impl)] for impl in ("flash", "einsum", "packed", "skip")}
    emit({"phase": "bench_model_ablation",
          **{f"{kind}_ms_per_forward": {f"depth{d}_{impl}": v * 1e3 for (d, impl), v in r.items()}
             for kind, r in res.items()},
          "attention_device_share_flash": (deep["flash"] - deep["skip"]) / deep["flash"],
          "launches": {n: c for n, c in counts.items() if c}, "card": smi})
    torch.cuda.empty_cache()
    return totals


def run_widths(torch, smi: str) -> dict[str, int]:
    """The Small config's synthesis and configs/test.yaml's training on the card."""
    import json
    import signal

    import numpy as np

    from oron_tts_tpu_torch.cli import train as cli_train
    from oron_tts_tpu_torch.config import F5Config, load_config
    from oron_tts_tpu_torch.data.wav import write_wav
    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from oron_tts_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        flash_lanes_bwd,
        flash_lanes_fwd,
        flash_lanes_fwd_stats,
    )
    from oron_tts_tpu_torch.ops.grouped_conv import grouped_conv1d_mish
    from oron_tts_tpu_torch.train.trainer import F5Trainer
    from oron_tts_tpu_torch.utils.weights import seeded_dit_params

    repo = Path(__file__).resolve().parent
    wrappers = {f.__name__: f for f in (flash_lanes_fwd, flash_lanes_fwd_stats, flash_lanes_bwd,
                                        grouped_conv1d_mish, flash_attention,
                                        flash_attention_bwd)}
    cfg = F5Config.from_file(repo / "configs" / "local.yaml")
    model = F5TTS(cfg)  # the card, bf16
    model.load_params(seeded_dit_params(cfg.model, seed=0))
    model.load_vocoder()
    conv = model.backbone.input_embed.conv_pos_embed
    model.synthesize(MN_TEXT, n_steps=2, seed=0)
    zero_counts(wrappers)
    t0 = time.perf_counter()
    wav = model.synthesize(MN_TEXT, lang="mn", n_steps=8, cfg_strength=2.0,
                           sway_sampling_coef=-1.0, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    synth_counts = read_counts(wrappers)
    m = cfg.model
    emit({"phase": "widths_synthesis", "config": "configs/local.yaml", "dim": m.dim,
          "heads": m.heads, "depth": m.depth, "conv_route": conv.route,
          "conv_group_width": m.dim // conv.groups, "attn_impl": model.backbone.attn_impl,
          "steps": 8, "wall_s": wall, "samples": len(wav), "launches": synth_counts, "card": smi})
    want = {"flash_lanes_fwd": 8 * m.depth, "flash_lanes_fwd_stats": 0, "flash_lanes_bwd": 0,
            "grouped_conv1d_mish": 8 * 2, "flash_attention": 0, "flash_attention_bwd": 0}
    if synth_counts != want or conv.route != "kernel" or m.dim // conv.groups != 32:
        raise AssertionError(f"Small synthesis: launches {synth_counts}, expected {want}, "
                             f"conv route {conv.route}")
    if not (np.isfinite(wav).all() and np.abs(wav).max() > 0):
        raise AssertionError("Small synthesis: no finite sound")
    del model
    torch.cuda.empty_cache()

    # F3: 5 heads of width 20 (H·D = 100, which the JAX lanes rule admits),
    # configs/test.yaml's model with dim 128 and a DiT of 5 heads of 20
    # overridden in memory, seeded weights; the wrapper pads each head to 24
    from oron_tts_tpu_torch.models.cfm import CFM
    from oron_tts_tpu_torch.models.dit import DiT

    config = load_config(repo / "configs" / "test.yaml")
    config["model"] = {**config["model"], "dim": 128, "heads": 8}
    model = F5TTS(F5Config.from_dict(config), dtype=torch.bfloat16)
    model.init_params(0)
    model.load_vocoder()
    m, a = model.config.model, model.config.audio
    torch.manual_seed(0)
    with torch.device(model.device):
        dit = DiT(dim=m.dim, depth=m.depth, heads=5, dim_head=20, ff_mult=m.ff_mult,
                  mel_dim=a.n_mels, vocab_size=m.vocab_size, text_dim=m.text_dim,
                  conv_layers=m.conv_layers, dropout=0.0)
    model.backbone = dit.to(torch.bfloat16).eval()
    model.cfm = CFM(model.backbone, n_mels=a.n_mels)
    zero_counts(wrappers)
    t0 = time.perf_counter()
    wav = model.synthesize(MN_TEXT, lang="mn", n_steps=8, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    d20_counts = read_counts(wrappers)
    emit({"phase": "widths_synthesis_d20", "config": "configs/test.yaml + dim 128, 5 heads of 20",
          "heads": 5, "head_dim": 20, "attn_impl": model.backbone.attn_impl, "steps": 8,
          "wall_s": wall, "samples": len(wav), "launches": d20_counts, "card": smi})
    if (d20_counts["flash_lanes_fwd"] != 8 * m.depth or model.backbone.attn_impl != "lanes"
            or not (np.isfinite(wav).all() and np.abs(wav).max() > 0)):
        raise AssertionError(f"5 heads of 20: launches {d20_counts}, "
                             f"impl {model.backbone.attn_impl}, finite sound "
                             f"{bool(np.isfinite(wav).all())}")
    del model, dit
    torch.cuda.empty_cache()

    # two epochs of the train CLI on configs/test.yaml (dim 64, heads 2: D = 32, f32)
    with tempfile.TemporaryDirectory() as tmp:
        records = []
        for i in range(5):
            t = np.arange(int(24000 * (1.0 + 0.3 * i))) / 24000
            path = Path(tmp) / f"clip{i}.wav"
            write_wav(path, (0.4 * np.sin(2 * np.pi * (200 + 20 * i) * t)).astype(np.float32),
                      24000)
            records.append({"audio_path": str(path), "text": "сайн байна уу", "lang": "mn"})
        (Path(tmp) / "metadata.json").write_text(json.dumps(records))
        zero_counts(wrappers)
        prev = signal.getsignal(signal.SIGTERM)
        t0 = time.perf_counter()
        try:
            cli_train.main(["--config", str(repo / "configs" / "test.yaml"), "--from-local",
                            "--data-dir", tmp, "--log-dir", f"{tmp}/logs",
                            "--checkpoint-dir", f"{tmp}/ckpt", "--num-epochs", "2"])
        finally:
            signal.signal(signal.SIGTERM, prev)
        wall = time.perf_counter() - t0
        train_counts = read_counts(wrappers)
        ckpts = sorted(p.name for p in Path(f"{tmp}/ckpt").glob("f5tts_step_*.npz"))
        emit({"phase": "widths_train", "config": "configs/test.yaml", "epochs": 2,
              "wall_s": wall, "checkpoints": ckpts, "launches": train_counts, "card": smi})
        if not (train_counts["flash_lanes_fwd_stats"] > 0 and train_counts["flash_lanes_bwd"] > 0
                and train_counts["grouped_conv1d_mish"] == 0 and ckpts):
            raise AssertionError(f"test.yaml training: launches {train_counts}, "
                                 f"checkpoints {ckpts}")

        # two F5Trainer steps in bf16 at dim 128, heads 1, depth 2: configs/test.yaml
        # with those fields overridden here, so D = 128 lanes (R2) and the
        # group-width-8 conv kernel (R3) train through the CLI's data path
        config = load_config(repo / "configs" / "test.yaml")
        config["model"] = {**config["model"], "dim": 128, "heads": 1, "depth": 2}
        config["mixed_precision"] = "bfloat16"
        loader, _ = cli_train.build_loaders(cli_train.build_dataset(tmp, config), config)
        model = F5TTS(F5Config.from_dict(config), dtype=torch.bfloat16)
        model.init_params(0)
        conv = model.backbone.input_embed.conv_pos_embed
        trainer = F5Trainer(config, model, loader, log_dir=f"{tmp}/logs128",
                            checkpoint_dir=f"{tmp}/ckpt128")
        batch = next(iter(loader))
        zero_counts(wrappers)
        t0 = time.perf_counter()
        losses = [trainer.train_step(batch, torch.Generator().manual_seed(step))
                  for step in range(2)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        d128_counts = read_counts(wrappers)
        del trainer, model
        emit({"phase": "widths_train_d128",
              "config": "configs/test.yaml + dim 128, heads 1, bf16", "head_dim": 128,
              "conv_route": conv.route, "conv_group_width": 128 // conv.groups, "steps": 2,
              "loss": [m["loss"] for m in losses], "ok": [m["ok"] for m in losses],
              "wall_s": wall, "launches": d128_counts, "card": smi})
        if not (all(m["ok"] and math.isfinite(m["loss"]) for m in losses)
                and d128_counts["flash_lanes_fwd_stats"] == 4
                and d128_counts["flash_lanes_bwd"] == 4
                and d128_counts["grouped_conv1d_mish"] == 4 and conv.route == "kernel"):
            raise AssertionError(f"dim-128 bf16 training: launches {d128_counts}, steps {losses}")

        # F4: two bf16 F5Trainer steps with two heads of 192 (dim 384, depth 2):
        # the lanes rule sends them to "flash", whose backward runs the wide
        # variant of csrc/flash_bwd.cuh
        config["model"] = {**config["model"], "dim": 384, "heads": 2, "depth": 2}
        model = F5TTS(F5Config.from_dict(config), dtype=torch.bfloat16)
        model.init_params(0)
        trainer = F5Trainer(config, model, loader, log_dir=f"{tmp}/logs192",
                            checkpoint_dir=f"{tmp}/ckpt192")
        impl = model.backbone.attn_impl
        zero_counts(wrappers)
        t0 = time.perf_counter()
        losses = [trainer.train_step(batch, torch.Generator().manual_seed(step))
                  for step in range(2)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        d192_counts = read_counts(wrappers)
        del trainer, model
        emit({"phase": "widths_train_d192",
              "config": "configs/test.yaml + dim 384, heads 2, bf16", "head_dim": 192,
              "attn_impl": impl, "steps": 2, "loss": [m["loss"] for m in losses],
              "ok": [m["ok"] for m in losses], "wall_s": wall, "launches": d192_counts,
              "card": smi})
        if not (all(m["ok"] and math.isfinite(m["loss"]) for m in losses) and impl == "flash"
                and d192_counts["flash_attention"] == 4
                and d192_counts["flash_attention_bwd"] == 4):
            raise AssertionError(f"head-192 bf16 training on flash: impl {impl}, launches "
                                 f"{d192_counts}, steps {losses}")

        # F5: two bf16 F5Trainer steps with two heads of 320 (dim 640, depth 2),
        # wider than the kernels' template instances, so "flash" runs their
        # wide bodies; then an 8-step synthesis of that config
        config["model"] = {**config["model"], "dim": 640, "heads": 2, "depth": 2}
        model = F5TTS(F5Config.from_dict(config), dtype=torch.bfloat16)
        model.init_params(0)
        trainer = F5Trainer(config, model, loader, log_dir=f"{tmp}/logs320",
                            checkpoint_dir=f"{tmp}/ckpt320")
        impl = model.backbone.attn_impl
        zero_counts(wrappers)
        t0 = time.perf_counter()
        losses = [trainer.train_step(batch, torch.Generator().manual_seed(step))
                  for step in range(2)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        d320_counts = read_counts(wrappers)
        del trainer, model
    emit({"phase": "widths_train_d320", "config": "configs/test.yaml + dim 640, heads 2, bf16",
          "head_dim": 320, "attn_impl": impl, "steps": 2, "loss": [m["loss"] for m in losses],
          "ok": [m["ok"] for m in losses], "wall_s": wall, "launches": d320_counts,
          "card": smi})
    if not (all(m["ok"] and math.isfinite(m["loss"]) for m in losses) and impl == "flash"
            and d320_counts["flash_attention"] == 4 and d320_counts["flash_attention_bwd"] == 4):
        raise AssertionError(f"head-320 bf16 training on flash: impl {impl}, launches "
                             f"{d320_counts}, steps {losses}")
    model = F5TTS(F5Config.from_dict(config), dtype=torch.bfloat16)
    model.init_params(0)
    model.load_vocoder()
    zero_counts(wrappers)
    t0 = time.perf_counter()
    wav = model.synthesize(MN_TEXT, lang="mn", n_steps=8, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    d320_synth = read_counts(wrappers)
    impl, depth = model.backbone.attn_impl, model.config.model.depth
    del model
    emit({"phase": "widths_synthesis_d320", "config": "configs/test.yaml + dim 640, heads 2",
          "head_dim": 320, "attn_impl": impl, "steps": 8, "wall_s": wall, "samples": len(wav),
          "launches": d320_synth, "card": smi})
    if (d320_synth["flash_attention"] != 8 * depth or impl != "flash"
            or not (np.isfinite(wav).all() and np.abs(wav).max() > 0)):
        raise AssertionError(f"heads of 320: launches {d320_synth}, impl {impl}, finite sound "
                             f"{bool(np.isfinite(wav).all())}")
    return {n: synth_counts[n] + d20_counts[n] + train_counts[n] + d128_counts[n]
            + d192_counts[n] + d320_counts[n] + d320_synth[n] for n in wrappers}


def run_align(torch, smi: str) -> dict[str, int]:
    """The tone-code quality eval at the Small width, cut short, through its CLI.

    ``cli.eval_alignment`` as a user runs it, on the card: 64 sentences (4
    held out), 4 epochs of bf16 ``F5Trainer`` on "lanes", 8-step syntheses.
    Its CERs are not the quality number (that is the full protocol's, 512
    sentences and 60 epochs): here each must be a rate in [0, 1] and the
    loss finite, and the counters show which kernels trained and sampled.
    """
    from oron_tts_tpu_torch.cli import eval_alignment
    from oron_tts_tpu_torch.ops.grouped_conv import grouped_conv1d_mish

    wrappers = kernel_wrappers() | {"grouped_conv1d_mish": grouped_conv1d_mish}
    with tempfile.TemporaryDirectory() as tmp:
        zero_counts(wrappers)
        t0 = time.perf_counter()
        payload = eval_alignment.main([
            "--dim", "512", "--depth", "12", "--heads", "8", "--text-dim", "256",
            "--sentences", "64", "--epochs", "4", "--holdout", "4", "--n-steps", "8",
            "--out", str(Path(tmp) / "align.json")])
        counts = read_counts(wrappers)
        wall = time.perf_counter() - t0
    cers = {f"{w}_{k}": payload["holdout"][w][k] for w in ("raw", "ema")
            for k in ("cer", "cer_reffree_duration", "cer_reffree_calibrated")}
    emit({"phase": "align", "config": "Small (dim 512, depth 12, heads 8, text_dim 256), bf16",
          "sentences": 64, "holdout": 4, "epochs": 4, "n_steps": 8,
          "untrained_cer_4clip": payload["untrained_cer_4clip"], **cers,
          "steps": payload["steps"], "train_seconds": payload["train_seconds"],
          "frames_per_s": payload["frames_per_s"], "final_train_loss": payload["final_train_loss"],
          "wall_s": wall, "launches": counts, "device": payload["device"], "card": smi})
    if not (math.isfinite(payload["final_train_loss"]) and payload["steps"] > 0
            and all(0.0 <= c <= 1.0 for c in [*cers.values(), payload["untrained_cer_4clip"]])):
        raise AssertionError(f"align: loss {payload['final_train_loss']}, CERs {cers}")
    ran = ("flash_lanes_fwd", "flash_lanes_fwd_stats", "flash_lanes_bwd", "grouped_conv1d_mish")
    if not all(counts[n] > 0 for n in ran):
        raise AssertionError(f"align: launches {counts}")
    return counts


def vocos_torch_layout(torch, params: dict) -> dict:
    """A Vocos flax tree in the official torch layout: ``convert_vocos_state_dict``'s inverse."""
    import numpy as np

    def lin(p):
        return {"weight": p["kernel"].T, "bias": p["bias"]}

    def conv(p):
        return {"weight": p["kernel"].transpose(2, 1, 0), "bias": p["bias"]}

    def ln(p):
        return {"weight": p["scale"], "bias": p["bias"]}

    parts = {"backbone.embed": conv(params["embed"]), "backbone.norm": ln(params["norm_pre"]),
             "backbone.final_layer_norm": ln(params["norm_post"]), "head.out": lin(params["head"])}
    for i in range(sum(1 for k in params if k.startswith("block"))):
        b, key = params[f"block{i}"], f"backbone.convnext.{i}"
        parts |= {f"{key}.dwconv": conv(b["dwconv"]), f"{key}.norm": ln(b["norm"]),
                  f"{key}.pwconv1": lin(b["pwconv1"]), f"{key}.pwconv2": lin(b["pwconv2"])}
        if "gamma" in b:
            parts[key] = {"gamma": b["gamma"]}
    return {f"{k}.{n}": torch.from_numpy(np.ascontiguousarray(v))
            for k, d in parts.items() for n, v in d.items()}


def run_interop(torch, smi: str) -> dict[str, int]:
    """Base weights through ``cli.export`` and back through ``cli.infer.load_model``;
    Griffin-Lim and a torch-layout Vocos on the card."""
    import numpy as np

    from oron_tts_tpu_torch.cli import export
    from oron_tts_tpu_torch.cli.infer import load_model
    from oron_tts_tpu_torch.config import F5Config
    from oron_tts_tpu_torch.evals.alignment import render_text
    from oron_tts_tpu_torch.models.f5tts import BUNDLED_VOCODER
    from oron_tts_tpu_torch.ops.flash_attention import flash_lanes_fwd
    from oron_tts_tpu_torch.ops.griffin_lim import griffin_lim
    from oron_tts_tpu_torch.ops.grouped_conv import grouped_conv1d_mish
    from oron_tts_tpu_torch.ops.mel import MelConfig, log_mel_spectrogram
    from oron_tts_tpu_torch.train.checkpoint import flatten_tree, write_npz
    from oron_tts_tpu_torch.utils.weights import load_npz_tree, seeded_dit_params

    wrappers = {f.__name__: f for f in (flash_lanes_fwd, grouped_conv1d_mish)}
    cfg = F5Config.from_dict({"model": {"depth": CUT_DEPTH}})
    mels, seconds, sizes = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp)
        write_npz(ckpt / "f5tts_step_00000001.npz",
                  flatten_tree({"params": seeded_dit_params(cfg.model, seed=0)}))
        (ckpt / "config.json").write_text(json.dumps({"model": {"depth": CUT_DEPTH}}))
        for fmt in ("pt", "safetensors"):
            t0 = time.perf_counter()
            out = export.main(["--checkpoint", str(ckpt), "--output", str(ckpt / f"f5tts.{fmt}")])
            seconds[f"export_{fmt}"] = time.perf_counter() - t0
            sizes[fmt] = out.stat().st_size
        zero_counts(wrappers)
        for name in ("npz", "pt", "safetensors"):
            t0 = time.perf_counter()
            model = load_model(str(ckpt if name == "npz" else ckpt / f"f5tts.{name}"))
            seconds[f"load_{name}"] = time.perf_counter() - t0
            if not (model.device.type == "cuda" and model.dtype == torch.bfloat16):
                raise AssertionError(f"{name}: loaded on {model.device} in {model.dtype}")
            mels[name] = model.synthesize_mel(MN_TEXT, n_steps=8, seed=0)
            if name != "safetensors":
                del model
        counts = read_counts(wrappers)

        # Griffin-Lim on the card against the CPU, on a rendered sentence's mel
        mcfg = MelConfig()
        log_mel = log_mel_spectrogram(torch.from_numpy(render_text(MN_TEXT)), mcfg)[None]
        t0 = time.perf_counter()
        gl_card = griffin_lim(log_mel.cuda(), mcfg, n_iter=32).cpu()
        torch.cuda.synchronize()
        seconds["griffin_lim_card"] = time.perf_counter() - t0
        gl_cpu = griffin_lim(log_mel, mcfg, n_iter=32)
        gl_err = float((gl_card - gl_cpu).abs().max() / gl_cpu.abs().max())

        # the bundled Vocos in the official torch layout, through the converter
        tree = load_npz_tree(BUNDLED_VOCODER)
        torch.save(vocos_torch_layout(torch, tree.get("ema") or tree.get("params") or tree),
                   ckpt / "vocos.pt")
        mel = torch.from_numpy(mels["npz"]).cuda()[None]
        model.load_vocoder()
        wav_npz = model._decode_mel(mel)
        model.load_vocoder(ckpt / "vocos.pt")
        wav_pt = model._decode_mel(mel)
        voc_err = float(np.abs(wav_pt - wav_npz).max() / np.abs(wav_npz).max())
        del model
    same = {n: bool(np.array_equal(mels[n], mels["npz"])) for n in ("pt", "safetensors")}
    emit({"phase": "interop", "config": f"Base width, {CUT_DEPTH} blocks, bf16, seeded",
          "frames": mels["npz"].shape[-1],
          "bytes": sizes, "seconds": seconds, "mel_bit_equal_to_npz": same,
          "griffin_lim_frames": int(log_mel.shape[-1]), "griffin_lim_rel_err": gl_err,
          "vocos_torch_layout_rel_err": voc_err, "launches": counts, "card": smi})
    if not all(same.values()):
        raise AssertionError(f"interop: exported weights give another mel: {same}")
    if not (gl_err <= 1e-3 and voc_err <= 1e-5 and np.isfinite(wav_pt).all()):
        raise AssertionError(f"interop: Griffin-Lim card vs CPU {gl_err} (tolerance 1e-3 of the "
                             f"largest), torch-layout Vocos {voc_err} (1e-5)")
    if not all(counts[n] > 0 for n in wrappers):
        raise AssertionError(f"interop: launches {counts}")
    return counts


MEMORY_POINTS = ((12, 2048), (16, 2048), (20, 2048), (24, 2048))  # no-remat and remat
RUNPOD_WORST = (24, 2816)  # configs/runpod.yaml's worst padded batch (67,584 frames)
AUTO_CONFIGS = ("local", "colab", "runpod", "bench_e2e")


def run_memory(torch, smi: str) -> dict[str, int]:
    """Peak memory of Base bf16 training steps against ``utils/memory.py``'s estimate (F10).

    ``F5Trainer.train_step`` on ``configs/runpod.yaml``'s model (Base,
    dropout 0.1, "lanes") over full seeded batches: each point's
    ``torch.cuda.max_memory_allocated`` with rematerialisation off and on,
    the constants the points imply (activation bytes a frame, model dim and
    block; the margin the CUDA context and the allocator's slack leave),
    ``gradient_checkpointing: auto``'s choice for each shipped config that
    sets it, and one step at runpod's worst padded batch with that choice.
    Fails if the estimate falls below a measured peak.
    """
    import numpy as np

    from oron_tts_tpu_torch.cli.train import auto_remat_frames
    from oron_tts_tpu_torch.config import F5Config, load_config
    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from oron_tts_tpu_torch.ops.flash_attention import flash_lanes_bwd, flash_lanes_fwd_stats
    from oron_tts_tpu_torch.train.trainer import F5Trainer
    from oron_tts_tpu_torch.utils import memory as mem
    from oron_tts_tpu_torch.utils.weights import seeded_dit_params

    wrappers = {f.__name__: f for f in (flash_lanes_fwd_stats, flash_lanes_bwd)}
    root = Path(__file__).resolve().parent
    config = load_config(root / "configs" / "runpod.yaml")
    config["gradient_checkpointing"] = False
    m = config["model"]
    dim, depth = m["dim"], m["depth"]
    total = mem.device_memory_bytes()
    choices = {}
    for name in AUTO_CONFIGS:
        c = load_config(root / "configs" / f"{name}.yaml")
        frames = auto_remat_frames(c)
        cm = c["model"]
        choices[name] = {"frames": frames, "remat": mem.auto_gradient_checkpointing(c, frames),
                         "estimate_gb": mem.estimate_train_bytes(
                             mem.config_param_count(c), frames, cm["dim"], cm["depth"]) / 1e9}
    n_est = mem.config_param_count(config)
    state = n_est * mem.state_bytes_per_param()

    torch.cuda.empty_cache()
    # tensors an earlier phase left alive are not this step's: peaks are taken above them
    baseline = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = F5TTS(F5Config.from_dict(config))  # the card, bf16
    model.load_params(seeded_dit_params(model.config.model, seed=0))
    trainer = F5Trainer({**config, "use_tqdm": False, "log_interval": 10**9}, model, [None],
                        log_dir=tempfile.mkdtemp(), checkpoint_dir=tempfile.mkdtemp())
    rng = np.random.default_rng(7)
    setup_s = time.perf_counter() - t0

    def step(rows: int, t: int, remat: bool) -> dict:
        batch = {"mel": rng.standard_normal((rows, 100, t), dtype=np.float32),
                 "text_ids": rng.integers(1, 65, (rows, t)).astype(np.int32),
                 "mel_lengths": np.full(rows, t, np.int32)}
        model.backbone.gradient_checkpointing = remat
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        frames = rows * t
        est = mem.estimate_train_bytes(n_est, frames, dim, depth, remat=remat)
        point = {"batch": [rows, t], "frames": frames, "remat": remat, "estimate_gb": est / 1e9}
        t1 = time.perf_counter()
        try:
            out = trainer.train_step(batch, torch.Generator().manual_seed(frames))
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError:
            # recorded, not raised: the estimate must then lie above the card's budget
            for p in trainer.work:
                p.grad = None
            torch.cuda.empty_cache()
            point |= {"oom": True,
                      "peak_gb": (torch.cuda.max_memory_allocated() - baseline) / 1e9}
            emit({"phase": "memory_point", **point, "card": smi})
            return point
        free, _ = torch.cuda.mem_get_info()
        point |= {"oom": False,
                  "peak_gb": (torch.cuda.max_memory_allocated() - baseline) / 1e9,
                  "reserved_gb": (torch.cuda.max_memory_reserved() - baseline) / 1e9,
                  "outside_torch_gb": (total - free - torch.cuda.memory_reserved()) / 1e9,
                  "step_s": time.perf_counter() - t1, "loss": out["loss"], "ok": out["ok"]}
        emit({"phase": "memory_point", **point, "card": smi})
        return point

    step(*MEMORY_POINTS[0], False)  # warm-up: first launches, the matmul library's workspace
    zero_counts(wrappers)
    points = [step(rows, t, remat) for remat in (False, True) for rows, t in MEMORY_POINTS]
    worst_remat = choices["runpod"]["remat"]
    points.append(step(*RUNPOD_WORST, worst_remat))
    counts = read_counts(wrappers)
    n_params = model.num_params()
    del trainer, model
    torch.cuda.empty_cache()

    ran = [p for p in points if not p["oom"]]

    def line(pts):  # least squares: peak bytes = intercept + slope · frames
        f = np.array([p["frames"] for p in pts], float)
        y = np.array([p["peak_gb"] * 1e9 for p in pts])
        slope, intercept = np.polyfit(f, y, 1)
        return float(slope), float(intercept)

    slope_off, icpt_off = line([p for p in ran if not p["remat"]])
    slope_on, icpt_on = line([p for p in ran if p["remat"]])
    fit_act = slope_off / (dim * depth)
    fit_remat = (slope_on / dim - fit_act) / depth
    slack = max(p["reserved_gb"] / p["peak_gb"] for p in ran)
    outside = max(p["outside_torch_gb"] for p in ran) * 1e9
    emit({"phase": "memory", "config": "configs/runpod.yaml (Base, dropout 0.1), bf16, lanes",
          "device_bytes": total, "baseline_gb": baseline / 1e9,
          "state_bytes_per_param": mem.state_bytes_per_param(),
          "params_estimated": n_est, "params": n_params,
          "act_bytes_per_frame_dim_layer": mem.ACT_BYTES_PER_FRAME_DIM_LAYER,
          "remat_bytes_per_frame_dim_layer": mem.REMAT_BYTES_PER_FRAME_DIM_LAYER,
          "margin": mem.MEMORY_MARGIN,
          "state_gb": state / 1e9,
          "fitted": {"act_bytes_per_frame_dim_layer": fit_act,
                     "remat_bytes_per_frame_dim_layer": fit_remat,
                     "intercept_gb": icpt_off / 1e9, "intercept_remat_gb": icpt_on / 1e9,
                     "reserved_over_allocated": slack,
                     "margin": (1 - outside / total) / slack},
          "points": [{k: p.get(k) for k in ("batch", "remat", "oom", "peak_gb", "estimate_gb",
                                             "step_s")} for p in points],
          "auto": choices, "runpod_worst": {"batch": list(RUNPOD_WORST), "remat": worst_remat,
                                            "peak_gb": points[-1]["peak_gb"]},
          "setup_s": setup_s, "launches": counts, "card": smi})
    below = [p for p in ran if p["estimate_gb"] < p["peak_gb"]]
    if below:
        raise AssertionError(f"memory: the estimate is below the measured peak at {below}")
    budget = total * mem.MEMORY_MARGIN / 1e9
    wrong = [p for p in points if p["oom"] and p["estimate_gb"] <= budget]
    if wrong or points[-1]["oom"]:
        raise AssertionError(
            f"memory: out of memory where the estimate fits: {wrong or points[-1]}")
    if not all(p["ok"] and math.isfinite(p["loss"]) for p in ran):
        raise AssertionError("memory: a step was not finite")
    if not all(counts[n] > 0 for n in wrappers):
        raise AssertionError(f"memory: launches {counts}")
    return counts


SERVE_LOAD_DEPTH = ["--depth", str(CUT_DEPTH)]  # the full depth: SERVE_LOAD_h100.json


def run_serve_load(torch, smi: str) -> dict[str, int]:
    """``cli.bench_serve_load`` at its defaults but the depth (Base width, 11 blocks, bf16,
    32 clients, 96 requests, 32 steps), then once more with a wait ceiling low enough to
    shed.

    The shed run sends 128 requests of 8 steps from 128 clients at once
    against a ceiling of 1.5 default solve estimates (32 steps): the fresh
    server's estimate is at least 0.735 s after its warm-up
    (``SOLVE_EWMA_PRIOR_S`` folded twice), so a request with six or more
    batches of 16 ahead of it is answered 429 whatever the card's speed,
    while the admitted ones, whose 8-step solves take a fraction of the
    ceiling, are served. One model serves both runs; each starts a fresh
    server.
    """
    from oron_tts_tpu_torch.cli import bench_serve_load
    from oron_tts_tpu_torch.ops.flash_attention import flash_lanes_fwd
    from oron_tts_tpu_torch.ops.grouped_conv import grouped_conv1d_mish

    wrappers = {f.__name__: f for f in (flash_lanes_fwd, grouped_conv1d_mish)}
    keys = ("warmup_s", "wall_s", "req_per_s", "audio_s_per_s", "latency_ms",
            "latency_ms_by_chars", "merged_batches", "request_timeout_s", "responses_429",
            "responses_504", "shed_requests", "solve_estimate_s")
    model = bench_serve_load.build_model(
        bench_serve_load.build_parser().parse_args(SERVE_LOAD_DEPTH))
    with tempfile.TemporaryDirectory() as tmp:
        out = str(Path(tmp) / "serve_load.json")
        zero_counts(wrappers)
        default = bench_serve_load.main(["--out", out] + SERVE_LOAD_DEPTH, model=model)
        counts = read_counts(wrappers)
        emit({"phase": "serve_load", "run": "default", **{k: default[k] for k in keys},
              "launches": counts, "card": smi})
        if default["shed_requests"] or default["responses_429"] or default["responses_504"]:
            raise AssertionError(f"serve_load: the default run shed requests: {default}")
        timeout = round(1.5 * default["solve_estimate_s"], 2)
        shed = bench_serve_load.main(["--out", out, "--request-timeout", str(timeout),
                                      "--clients", "128", "--requests", "128", "--steps", "8",
                                      "--label", "shed"] + SERVE_LOAD_DEPTH, model=model)
        del model
        emit({"phase": "serve_load", "run": "shed", "clients": 128, "requests": 128, "steps": 8,
              **{k: shed[k] for k in keys}, "card": smi})
        if not shed["responses_429"]:
            raise AssertionError(f"serve_load: a {timeout} s ceiling shed nothing")
    if not all(counts[n] > 0 for n in wrappers):
        raise AssertionError(f"serve_load: launches {counts}")
    return counts


def run_streaming(torch, smi: str) -> dict[str, int]:
    """``cli.bench_streaming``: Base width at 11 blocks, bf16, with a seeded Vocos set by
    ``set_vocoder``."""
    from oron_tts_tpu_torch.cli import bench_streaming
    from oron_tts_tpu_torch.ops.flash_attention import flash_lanes_fwd
    from oron_tts_tpu_torch.ops.grouped_conv import grouped_conv1d_mish

    wrappers = {f.__name__: f for f in (flash_lanes_fwd, grouped_conv1d_mish)}
    zero_counts(wrappers)
    payload = bench_streaming.main(SERVE_LOAD_DEPTH)
    counts = read_counts(wrappers)
    emit({"phase": "streaming", **payload, "launches": counts})
    if not (payload["pieces"] > 1 and 0 < payload["ttfa_s"] < payload["total_s"]):
        raise AssertionError(f"streaming: {payload}")
    if not all(counts[n] > 0 for n in wrappers):
        raise AssertionError(f"streaming: launches {counts}")
    return counts


PREP_CLIPS = 24
PREP_WORDS = ("сайн байна уу монгол хэл өнөөдөр цаг агаар сайхан тал нутаг өргөн "
              "уудам орон юм").split()


def speech_like(rng, seconds: float, rate: int = 24000):
    """A seeded clip: voiced syllables (harmonics under an envelope) in a noise floor,
    with 0.2 s of quiet at each end for the trim."""
    import numpy as np

    n = int(seconds * rate)
    t = np.arange(n) / rate
    f0 = rng.uniform(110, 220)
    voiced = sum(np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 6.3)) / k for k in range(1, 6))
    envelope = np.clip(np.sin(2 * np.pi * rng.uniform(2.5, 4.5) * t), 0, None) ** 2
    edge = int(0.2 * rate)
    envelope[:edge] = envelope[-edge:] = 0.0
    clip = 0.3 * voiced * envelope + 0.003 * rng.standard_normal(n)
    return clip.astype(np.float32)


def run_prepare(torch, smi: str) -> dict[str, int]:
    """Data preparation on seeded clips, a local Common Voice tar, then training on the card."""
    import csv
    import io
    import tarfile

    import numpy as np

    from oron_tts_tpu_torch import native
    from oron_tts_tpu_torch.cli import clean_local_cv, prepare, test_pipeline
    from oron_tts_tpu_torch.cli import train as cli_train
    from oron_tts_tpu_torch.config import F5Config, load_config
    from oron_tts_tpu_torch.data.dataset import TTSDataset
    from oron_tts_tpu_torch.data.wav import wav_bytes, wav_info_bytes
    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from oron_tts_tpu_torch.ops.flash_attention import flash_lanes_bwd, flash_lanes_fwd_stats
    from oron_tts_tpu_torch.train.trainer import F5Trainer

    wrappers = {f.__name__: f for f in (flash_lanes_fwd_stats, flash_lanes_bwd)}
    rng = np.random.default_rng(11)
    seconds = {}
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        records = []
        for i in range(PREP_CLIPS):
            words = " ".join(rng.choice(PREP_WORDS, size=int(rng.integers(3, 9))))
            clip = speech_like(rng, float(rng.uniform(1.5, 6.0)))
            records.append({"sentence": words.capitalize() + ".", "client_id": f"c{i % 4}",
                            "audio": {"bytes": wav_bytes(clip, 24000), "path": None}})
        t0 = time.perf_counter()
        meta = prepare.process_dataset(records, tmp / "prepared", "mn", denoise=True)
        prepare.create_metadata(tmp / "prepared", meta)
        seconds["prepare"] = time.perf_counter() - t0

        tsv = io.StringIO()
        writer = csv.writer(tsv, delimiter="\t")
        writer.writerow(["client_id", "path", "sentence"])
        archive = tmp / "cv.tar.gz"
        with tarfile.open(archive, "w:gz") as tar:
            for i, rec in enumerate(records[:8]):
                name = f"common_voice_mn_{i:04d}.wav"
                writer.writerow([rec["client_id"], name, rec["sentence"]])
                data = rec["audio"]["bytes"]
                info = tarfile.TarInfo(f"cv-corpus/mn/clips/{name}")
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))
            data = tsv.getvalue().encode()
            info = tarfile.TarInfo("cv-corpus/mn/validated.tsv")
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
        t0 = time.perf_counter()
        cv_meta = clean_local_cv.main(["--archive", str(archive), "--output-dir",
                                       str(tmp / "cv"), "--denoise"])
        seconds["clean_local_cv"] = time.perf_counter() - t0

        zero_counts(wrappers)
        t0 = time.perf_counter()
        cli_train.main(["--config", str(root / "configs" / "test.yaml"), "--from-local",
                        "--data-dir", str(tmp / "prepared"), "--device", "cuda",
                        "--num-epochs", "1", "--log-dir", str(tmp / "logs"),
                        "--checkpoint-dir", str(tmp / "ckpt")])
        seconds["train_cli"] = time.perf_counter() - t0
        checkpoints = sorted(p.name for p in (tmp / "ckpt").glob("f5tts_step_*.npz"))

        # one more epoch over the same WAVs held as bytes (the HuggingFace path's mode)
        config = load_config(root / "configs" / "test.yaml")
        dataset = TTSDataset(audio_bytes_list=[Path(m["audio_path"]).read_bytes() for m in meta],
                             texts=[m["text"] for m in meta])
        dataset.durations = [wav_info_bytes(b)[0] for b in dataset.audio_bytes_list]
        loader, _ = cli_train.build_loaders(dataset, config)
        model = F5TTS(F5Config.from_dict(config), device="cuda", dtype=torch.float32)
        model.init_params(0)
        t0 = time.perf_counter()
        trainer = F5Trainer({**config, "use_tqdm": False}, model, loader,
                            log_dir=str(tmp / "logs2"), checkpoint_dir=str(tmp / "ckpt2"))
        loss = trainer.train_epoch(total_epochs=1)
        seconds["train_bytes_epoch"] = time.perf_counter() - t0
        counts = read_counts(wrappers)

    t0 = time.perf_counter()
    failed = test_pipeline.main(["--device", "cuda"])
    seconds["test_pipeline"] = time.perf_counter() - t0
    extractor = dataset.mel_extractor
    emit({"phase": "prepare", "clips": PREP_CLIPS, "prepared": len(meta),
          "clean_local_cv": len(cv_meta), "checkpoints": checkpoints,
          "bytes_epoch_loss": loss, "extractor": extractor, "native": native.available(),
          "test_pipeline_failed": failed, "seconds": seconds, "launches": counts, "card": smi})
    if extractor != "native audiokit":
        raise AssertionError(f"prepare: the host log-mel was {extractor}, not the native one")
    if not (len(meta) == PREP_CLIPS and len(cv_meta) == 8 and checkpoints
            and math.isfinite(loss) and failed == 0):
        raise AssertionError(f"prepare: {len(meta)} prepared, {len(cv_meta)} from the tar, "
                             f"checkpoints {checkpoints}, loss {loss}, {failed} steps failed")
    if not all(counts[n] > 0 for n in wrappers):
        raise AssertionError(f"prepare: launches {counts}")
    return counts


VOC_REF = {"mr_stft": 1.0808, "mel_l1": 0.2356}  # the JAX eval of the bundled Vocos
VOC_GL_REF = {"mr_stft": 1.2061, "mel_l1": 0.4034}
VOC_STEPS, VOC_GAN_STEPS = 200, 250


def params_of(path) -> "np.ndarray":
    import numpy as np

    with np.load(path) as data:
        return np.concatenate([data[k].ravel() for k in sorted(data.files)
                               if k.startswith("params/")])


def run_vocoder(torch, smi: str) -> dict[str, int]:
    """Eval of the bundled Vocos against the reference, then MR-STFT and GAN training."""
    import numpy as np

    from oron_tts_tpu_torch.cli import eval_vocoder, make_synthetic_speech, train_vocoder
    from oron_tts_tpu_torch.models.discriminators import VocoderDiscriminator
    from oron_tts_tpu_torch.models.f5tts import BUNDLED_VOCODER, F5TTS
    from oron_tts_tpu_torch.models.vocos import VocosDecoder
    from oron_tts_tpu_torch.ops.mel import MelConfig
    from oron_tts_tpu_torch.train.checkpoint import CheckpointManager, flatten_tree
    from oron_tts_tpu_torch.train.vocoder import OptaxAdamW, make_vocoder_superstep, pack_corpus
    from oron_tts_tpu_torch.utils.weights import from_flax_params, init_module_params

    seconds = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        make_synthetic_speech.main(["--out", str(tmp / "ood"), "--family", "ood", "-n", "40",
                                    "--seed", "123"])
        seconds["ood_corpus"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ev = eval_vocoder.main(["--checkpoint", str(BUNDLED_VOCODER), "--data-dir",
                                str(tmp / "ood"), "--holdout-frac", "1.0", "--griffin-lim"])
        seconds["eval"] = time.perf_counter() - t0
        emit({"phase": "vocoder_eval", "clips": ev["clips"], "mr_stft": ev["mr_stft_exact"],
              "mel_l1": ev["mel_l1_exact"], "griffin_lim_mr_stft": ev["griffin_lim_mr_stft"],
              "griffin_lim_mel_l1": ev["griffin_lim_mel_l1"], "reference": VOC_REF,
              "griffin_lim_reference": VOC_GL_REF, "seconds": seconds["eval"], "card": smi})
        if not (ev["clips"] == 32 and abs(ev["mr_stft_exact"] - VOC_REF["mr_stft"]) <= 0.003
                and abs(ev["mel_l1_exact"] - VOC_REF["mel_l1"]) <= 0.003
                and abs(ev["griffin_lim_mr_stft"] - VOC_GL_REF["mr_stft"]) <= 0.03
                and abs(ev["griffin_lim_mel_l1"] - VOC_GL_REF["mel_l1"]) <= 0.015):
            raise AssertionError(f"vocoder eval off the reference: {ev}")

        t0 = time.perf_counter()
        make_synthetic_speech.main(["--out", str(tmp / "train"), "-n", "64", "--seed", "0"])
        seconds["train_corpus"] = time.perf_counter() - t0
        ckpt = tmp / "ckpt"
        base = ["--data-dir", str(tmp / "train"), "--checkpoint-dir", str(ckpt),
                "--log-interval", "25"]
        baseline = torch.cuda.memory_allocated() / 1e9  # what earlier phases left alive
        torch.cuda.reset_peak_memory_stats()
        out = train_vocoder.main(base + ["--steps", str(VOC_STEPS)])
        peak = torch.cuda.max_memory_allocated() / 1e9
        windows = out["windows"]
        mel_cfg = MelConfig()
        crop_s = 64 * mel_cfg.hop_length / mel_cfg.sample_rate
        train_s = sum(w["seconds"] for w in windows[1:])  # the first window warms up
        steps_per_s = 25 * (len(windows) - 1) / train_s
        report = {"phase": "vocoder_train", "config": "dim 512, 8 blocks, mag_phase, batch 16, "
                  "64-frame crops, fp32", "steps": out["step"], "windows": len(windows),
                  "window_loss_mean": [w["loss_mean"] for w in windows],
                  "skipped": sum(w["skipped"] for w in windows),
                  "first_window_s": windows[0]["seconds"], "steps_per_s": steps_per_s,
                  "audio_s_per_s": steps_per_s * 16 * crop_s, "peak_gb": peak,
                  "baseline_gb": baseline,
                  "seconds": out["seconds"], "card": smi}
        if not (out["step"] == VOC_STEPS and report["skipped"] == 0
                and all(math.isfinite(x) for x in report["window_loss_mean"])
                and report["window_loss_mean"][-1] < report["window_loss_mean"][0]):
            emit(report)
            raise AssertionError("vocoder training: not finite, skipped, or did not learn")

        # one more window, traced: launches per step and the device's idle share
        step_path = ckpt / f"vocos_step_{VOC_STEPS:08d}.npz"
        info = CheckpointManager(ckpt, model_name="vocos").load(step_path)
        vocoder = VocosDecoder(head_mode="mag_phase")
        vocoder.load_state_dict(from_flax_params(info["params"]))
        vocoder.cuda().train()
        opt = OptaxAdamW(list(vocoder.parameters()), 2e-4)
        window = make_vocoder_superstep(vocoder, opt, mel_cfg, 64 * mel_cfg.hop_length, 25)
        audios = train_vocoder.load_corpus(str(tmp / "train"), 0.05, mel_cfg.sample_rate)
        flat_np, offsets, max_starts = pack_corpus(audios, 64 * mel_cfg.hop_length)
        flat = torch.from_numpy(flat_np).cuda()
        rng = np.random.default_rng(5)
        clips = rng.integers(0, len(audios), size=(25, 16))
        starts = offsets[clips] + (rng.random((25, 16)) * (max_starts[clips] + 1)).astype(np.int64)
        prof = profile_once(torch, lambda: window(flat, starts))
        report["profile"] = {k: prof[k] for k in ("wall_s", "device_busy_s", "device_idle_share",
                                                  "device_kernels", "device_s_by_kind")}
        report["launches_per_step"] = prof["device_kernels"] / 25
        emit(report)
        del vocoder, opt, window, flat

        model = F5TTS.from_config({"model": {"dim": 64, "depth": 2, "heads": 2, "text_dim": 32,
                                             "ff_mult": 2, "conv_layers": 1}}, device="cuda")
        model.load_vocoder(step_path)
        mel = torch.randn(1, 100, 80, generator=torch.Generator().manual_seed(0)) - 5.0
        wav = model._decode_mel(mel.cuda())
        if not (wav.shape == (80 * 256,) and np.isfinite(wav).all() and np.abs(wav).max() > 0):
            raise AssertionError(f"the trained vocoder decoded {wav.shape}, finite "
                                 f"{np.isfinite(wav).all()}")
        del model

        torch.cuda.reset_peak_memory_stats()
        gan = train_vocoder.main(base + ["--steps", str(VOC_GAN_STEPS), "--resume", "--gan",
                                         "--gan-start-step", str(VOC_STEPS)])
        gan_peak = torch.cuda.max_memory_allocated() / 1e9
        disc_path = ckpt / f"vocos_disc_step_{VOC_GAN_STEPS:08d}.npz"
        g_moved = not np.array_equal(params_of(step_path),
                                     params_of(ckpt / f"vocos_step_{VOC_GAN_STEPS:08d}.npz"))
        d_init = flatten_tree(init_module_params(VocoderDiscriminator(), seed=1), "params")
        d_init = np.concatenate([d_init[k].ravel() for k in sorted(d_init)])
        d_moved = disc_path.exists() and not np.array_equal(d_init, params_of(disc_path))
        gw = gan["windows"]
        gan_s = sum(w["seconds"] for w in gw[1:]) or gw[0]["seconds"]
        emit({"phase": "vocoder_gan", "steps": gan["step"] - VOC_STEPS,
              "g_loss_mean": [w["g_loss_mean"] for w in gw],
              "d_loss_mean": [w["d_loss_mean"] for w in gw],
              "mel_l1_mean": [w["mel_l1_mean"] for w in gw],
              "steps_per_s": 25 * max(len(gw) - 1, 1) / gan_s, "first_window_s": gw[0]["seconds"],
              "peak_gb": gan_peak, "baseline_gb": baseline, "generator_moved": g_moved, "discriminator_moved": d_moved,
              "disc_checkpoint": disc_path.name if disc_path.exists() else None,
              "seconds": {**seconds, "gan": gan["seconds"]}, "card": smi})
        if not (gan["step"] == VOC_GAN_STEPS and all(w["finite"] for w in gw)
                and g_moved and d_moved):
            raise AssertionError("vocoder GAN stage: not finite, or a net did not move")
    return {}


def run_grad_accum(torch, smi: str) -> dict[str, int]:
    """``cli.bench_grad_accum`` at its defaults: accumulation windows against the fused step."""
    from oron_tts_tpu_torch.cli import bench_grad_accum
    from oron_tts_tpu_torch.ops.flash_attention import flash_lanes_bwd, flash_lanes_fwd_stats
    from oron_tts_tpu_torch.ops.gelu_dropout import gelu_dropout_bwd, gelu_dropout_fwd
    from oron_tts_tpu_torch.ops.grouped_conv import grouped_conv1d_mish

    wrappers = {f.__name__: f for f in (grouped_conv1d_mish, flash_lanes_fwd_stats,
                                        flash_lanes_bwd, gelu_dropout_fwd, gelu_dropout_bwd)}
    zero_counts(wrappers)
    out = bench_grad_accum.main([])
    counts = read_counts(wrappers)
    emit({"phase": "grad_accum", **out, "launches": counts, "card": smi})
    modes = ("pipelined", "per-micro host sync", "remat", "fused")
    if not all(out[m]["ok"] and math.isfinite(out[m]["loss"]) for m in modes):
        raise AssertionError(f"grad_accum: a step was not applied: {out}")
    if not all(counts[n] > 0 for n in wrappers):
        raise AssertionError(f"grad_accum: launches {counts}")
    return counts



# --- phase 21: the levers --------------------------------------------------
# Relative L2 of a lever's mel (the generated frames) against its bf16 case on
# the same noise. No-hoist runs the same math with the AdaLN products at 2 rows
# in place of the schedule's 32, so bf16 rounds elsewhere: a tight bound. The
# int8 cases take the serve phase's bounds (QUANT_MEL_REL_L2_TOL: 0.01 for
# int8, the "fast" profile's 0.03 for int8_dynamic), each against the bf16 case
# with the same interval setting. The CFG interval and midpoint cases are other
# solvers of the same ODE: on random weights nothing bounds their distance, so
# they are held to finiteness only (their distances are printed).
LEVER_REL_L2_TOL = {"no-hoist": 1e-2, "int8 w8a16": QUANT_MEL_REL_L2_TOL["int8"],
                    "int8_dynamic w8a8": QUANT_MEL_REL_L2_TOL["fast"],
                    "int8_dynamic + interval": QUANT_MEL_REL_L2_TOL["fast"]}


def run_levers(torch, smi: str) -> dict[str, int]:
    """``cli.bench_sampler_levers`` and ``cli.bench_quantized --e2e`` at their defaults."""
    from oron_tts_tpu_torch.cli import bench_quantized, bench_sampler_levers
    from oron_tts_tpu_torch.ops.flash_attention import flash_lanes_fwd
    from oron_tts_tpu_torch.ops.grouped_conv import grouped_conv1d_mish
    from oron_tts_tpu_torch.ops.quantized_matmul import quantized_matmul

    wrappers = {f.__name__: f for f in (flash_lanes_fwd, grouped_conv1d_mish, quantized_matmul)}
    zero_counts(wrappers)
    t0 = time.perf_counter()
    levers = bench_sampler_levers.main([])
    levers_s = time.perf_counter() - t0
    quant = bench_quantized.main(["--e2e"])
    counts = read_counts(wrappers)
    emit({"phase": "levers", **levers, "tol": LEVER_REL_L2_TOL, "seconds": levers_s, "card": smi})
    emit({"phase": "quantized", **quant, "seconds": time.perf_counter() - t0 - levers_s,
          "card": smi})
    cases = levers["cases"]
    if levers["model"]["depth"] != 22 or len(cases) != 8:
        raise AssertionError(f"levers: expected 8 cases at 22 blocks, got {levers['model']}")
    for label, row in cases.items():
        tol = LEVER_REL_L2_TOL.get(label)
        if not math.isfinite(row["mel_abs_mean"]) or (tol is not None and not row["rel_l2"] <= tol):
            raise AssertionError(f"levers: {label} off its {row['vs']} case: {row}")
    for row in quant["kernel"]:
        if not row["w8a16_excess"] <= row["w8a16_tol"]:
            raise AssertionError(f"quantized: kernel 9 off its plain version: {row}")
    if len(quant["kernel"]) != 9 or len(quant["e2e"]) != 3:
        raise AssertionError(f"quantized: rows {len(quant['kernel'])}, modes {len(quant['e2e'])}")
    if not all(counts[n] > 0 for n in wrappers):
        raise AssertionError(f"levers: launches {counts}")
    return counts


# --- phase 22: the mesh ---------------------------------------------------
# Two ranks share the one card over a gloo group this script initialises (NCCL
# refuses two ranks on one device; the port itself never picks gloo on CUDA).
# Their step times are bound by gloo staging every collective through the
# host: they are a functional check, not a scaling measurement.
MESH_B, MESH_STEPS = 4, 2          # the global batch [4, 2048] of the two-rank runs
MESH_LOSS_REL_TOL = 1e-2           # one bf16 forward of the same weights, batch and noise,
                                   # with the row-parallel sums (TP) or the rows (DP) split
MESH_NORM_REL_TOL = 5e-2           # the bf16 backward on top of it
MESH_MEL_REL_L2_TOL = 0.1          # bf16, 4 steps x 22 blocks, TP's sums in another order
MESH_CASES = (("tp2", 1, 2, False), ("dp2", 2, 1, False), ("dp2_zero1", 2, 1, True))
# the world-of-one entry-point runs (cli.train/infer/serve under torchrun) take the
# Base width at 6 of its 22 blocks: their check is bit-equality with no mesh, and a
# full-depth checkpoint costs a 6 GB write; the step times stay at full depth
MESH_CLI_DEPTH = 6
MESH_SYNTH = dict(n_steps=4, seed=0)


def mesh_batch(rows: int = MESH_B):
    """A seeded global batch ``[rows, 100, 2048]``, rows of 2048 to 1500 frames."""
    import numpy as np

    rng = np.random.default_rng(21)
    return {"mel": rng.standard_normal((rows, 100, TRAIN_T)).astype(np.float32),
            "text_ids": rng.integers(1, 65, (rows, TRAIN_T)).astype(np.int32),
            "mel_lengths": np.resize(np.array([2048, 1800, 1500, 2048], np.int32), rows)}


class _NoLoader:
    dataset: list = []

    def __len__(self) -> int:
        return MESH_STEPS

    def __iter__(self):
        return iter(())


def mesh_train_steps(torch, cfg, params, mesh, zero: bool, rows: int = MESH_B,
                     steps: int = MESH_STEPS) -> dict:
    """``steps`` bf16 F5Trainer steps (dropout 0.1) on this rank's rows of ``mesh_batch(rows)``."""
    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from oron_tts_tpu_torch.parallel.mesh import batch_rows
    from oron_tts_tpu_torch.train.trainer import F5Trainer

    config = {"learning_rate": 1e-4, "warmup_steps": 2, "num_epochs": 1, "use_tqdm": False,
              "log_interval": 10**9, "audio_sample_interval": 10**9,
              "shard_opt_states": zero}
    model = F5TTS(cfg, device=None if mesh is None else mesh.device)
    model.load_params(params)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = F5Trainer(config, model, _NoLoader(), log_dir=f"{tmp}/l",
                            checkpoint_dir=f"{tmp}/c", mesh=mesh)
        batch = mesh_batch(rows)
        local = {k: v[batch_rows(mesh, rows)] for k, v in batch.items()}
        generator = torch.Generator().manual_seed(7)
        out = {"loss": [], "grad_norm": [], "ok": [], "step_ms": []}
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = trainer.train_step(local, generator)
            torch.cuda.synchronize()
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
            for k in ("loss", "grad_norm", "ok"):
                out[k].append(m[k])
        out["moment_gb"] = sum(t.numel() * t.element_size()
                               for t in trainer.state.mu + trainer.state.nu) / 1e9
        out["rows"] = int(local["mel"].shape[0])
        del trainer
    del model
    return out


def mesh_rank_main(argv: list[str]) -> int:
    """One of the two ranks that share the card (``--mesh-rank R PORT OUT CHECKPOINT``)."""
    import datetime
    import os

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    rank, port, out, ckpt = int(argv[0]), argv[1], Path(argv[2]), argv[3]
    os.environ["LOCAL_RANK"] = "0"  # both ranks on cuda:0
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=300))
    from oron_tts_tpu_torch.config import F5Config
    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from oron_tts_tpu_torch.parallel.mesh import make_mesh
    from oron_tts_tpu_torch.utils.weights import load_npz_tree

    cfg = F5Config()  # Base: 16 heads of 64, dropout 0.1, 22 blocks
    params = load_npz_tree(ckpt)["params"]  # the phase's seeded checkpoint
    wrappers = kernel_wrappers()
    result: dict = {"rank": rank}
    for name, dp, tp, zero in MESH_CASES:
        mesh = make_mesh(dp, tp, device="cuda")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(wrappers)
        res = mesh_train_steps(torch, cfg, params, mesh, zero)
        res["launches"] = {n: c for n, c in read_counts(wrappers).items() if c}
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        result[name] = res
    mesh = make_mesh(1, 2, device="cuda")
    model = F5TTS(cfg, device=mesh.device)
    model.load_params(params)
    model.set_mesh(mesh)
    zero_counts(wrappers)
    mel = model.synthesize_mel(MN_TEXT, **MESH_SYNTH)
    result["tp2_synth"] = {"launches": {n: c for n, c in read_counts(wrappers).items() if c},
                           "local_heads": model.backbone.local_heads,
                           "attn_impl": model.backbone.attn_impl}
    if rank == 0:
        np.save(out / "tp2_mel.npy", mel)
    (out / f"rank{rank}.json").write_text(json.dumps(result))
    dist.destroy_process_group()
    return 0


def mesh_corpus(root: Path, config: dict) -> tuple[Path, Path]:
    """WAVs of ``train_clip_frames`` lengths and two more, their metadata, and a Base
    bf16 config."""
    import numpy as np
    import yaml

    from oron_tts_tpu_torch.data.wav import write_wav

    data = root / "data"
    data.mkdir()
    rng = np.random.default_rng(6)
    records = []
    # 26 clips: the 90/10 split keeps 24, two [12, T ≤ 2048] batches an epoch
    for i, f in enumerate(train_clip_frames() + [1200, 1300]):
        path = data / f"clip{i:02d}.wav"
        write_wav(path, (0.3 * rng.standard_normal((f - 1) * 256)).astype(np.float32), 24000)
        records.append({"audio_path": str(path), "text": MN_TEXT, "lang": "mn"})
    (data / "metadata.json").write_text(json.dumps(records))
    cfg_path = root / "base.yaml"
    cfg_path.write_text(yaml.safe_dump(config))
    return data, cfg_path


def run_cmd(argv: list[str], timeout: float, env: dict | None = None) -> tuple[str, float]:
    """Run one entry point to its end; its output, and the wall seconds it took."""
    import os

    t0 = time.perf_counter()
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=timeout,
                          env={**os.environ, **(env or {})})
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(argv[:6])} ... exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return proc.stdout + proc.stderr, seconds


def torchrun(port: int) -> list[str]:
    return [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "1",
            "--master-addr", "127.0.0.1", "--master-port", str(port)]


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def step_lines(log: str) -> list[tuple[float, float]]:
    import re

    return [(float(a), float(b)) for a, b in
            re.findall(r"Step \d+ \| loss=([-\d.naif]+) \| lr=\S+ \| grad_norm=([-\d.naif]+)", log)]


def mesh_cli_main(argv: list[str]) -> int:
    """``cli.train``, ``cli.infer`` and ``cli.serve`` with ``--mesh 1x1`` in this torchrun rank.

    ``--mesh-cli ROOT``: the arguments come from ``ROOT/mesh_cli.json``, the
    results go to ``ROOT/mesh_cli_out.json``. The server answers /healthz,
    one /synthesize and eight concurrent requests that arrive while the
    device is busy (the model lock held), so that they merge; then it drains.
    """
    import threading
    from concurrent.futures import ThreadPoolExecutor

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from oron_tts_tpu_torch.cli import infer, serve, train

    root = Path(argv[0])
    spec = json.loads((root / "mesh_cli.json").read_text())
    seconds = {}
    t0 = time.perf_counter()
    train.main(spec["train"] + ["--mesh", "1x1"])
    seconds["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    infer.main(spec["infer"] + ["--mesh", "1x1"])
    seconds["infer"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    server = serve.create_server(spec["serve"] + ["--mesh", "1x1", "--port", "0"])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    health = http_health(port)[1]
    code, _, _ = http_post(port, "/synthesize", {"text": MN_TEXT, "steps": 8, "seed": 0})
    texts = [letters(60 + 5 * i, i) for i in range(8)]
    batcher, submitted, submit = server.service.batcher, [], server.service.batcher.submit

    def counted(*a, **k):
        submitted.append(1)
        return submit(*a, **k)

    batcher.submit = counted
    with ThreadPoolExecutor(8) as pool:
        with server.service.model_lock:  # a busy device while all eight arrive
            futures = [pool.submit(http_post, port, "/synthesize",
                                   {"text": texts[i], "steps": 8, "seed": i}) for i in range(8)]
            for _ in range(1200):
                if len(submitted) == 8:
                    break
                time.sleep(0.05)
            time.sleep(0.1)
        burst = [f.result() for f in futures]
    after = http_health(port)[1]
    serve.begin_drain(server)
    thread.join(timeout=120)
    serve.close_server(server)  # the stop command: followers would end here
    seconds["serve"] = time.perf_counter() - t0
    (root / "mesh_cli_out.json").write_text(json.dumps({
        "seconds": seconds,
        "serve": {"healthz": health, "codes": [code] + [c for c, _, _ in burst],
                  "merged_batches": after["merged_batches"],
                  "drained": not thread.is_alive()}}))
    return 0


def cli_train_plain(torch, cfg_path: Path, data: Path, ckpt: Path, root: Path):
    """``cli.train``'s trainer without a mesh, built by its own helpers, in this process.

    The same config, corpus, split, loaders, fresh model and
    ``--pretrain-ckpt`` weights as the CLI; one epoch, no checkpoint. Returns
    (its step lines and whole parameters, each step's ms).
    """
    from oron_tts_tpu_torch.cli import train as cli_train
    from oron_tts_tpu_torch.config import F5Config, load_config
    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from oron_tts_tpu_torch.train.checkpoint import flatten_tree
    from oron_tts_tpu_torch.train.trainer import F5Trainer
    from oron_tts_tpu_torch.utils.weights import load_npz_tree

    config = load_config(str(cfg_path))
    dataset = cli_train.build_dataset(str(data), config)
    train_loader, val_loader = cli_train.build_loaders(dataset, config)
    model = F5TTS(F5Config.from_dict(config), dtype=torch.bfloat16)
    model.init_params(0)
    trainer = F5Trainer(config, model, train_loader, val_loader,
                        log_dir=str(root / "log_plain"), checkpoint_dir=str(root / "run_plain"))
    trees = load_npz_tree(ckpt / "f5tts_step_00000001.npz")
    trainer.set_params(trees.get("ema") or trees.get("params") or trees)
    steps, step_ms, batches = [], [], []
    train_step = trainer.train_step

    def spy(batch, generator):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = train_step(batch, generator)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        steps.append(f"{m['loss']:.4f}/{m['grad_norm']:.4f}")
        batches.append(list(batch["mel"].shape))
        return m

    trainer.train_step = spy
    trainer.train(num_epochs=1, save_interval=10**9)
    params = flatten_tree(trainer._flax_tree(trainer.state.params))
    del trainer, model
    torch.cuda.empty_cache()
    return {"steps": steps, "params": params, "batches": batches}, step_ms


def run_mesh(torch, smi: str) -> dict[str, int]:
    """Phase 22: the mesh on one card (NCCL world of one; two gloo ranks sharing the card)."""
    import numpy as np

    from oron_tts_tpu_torch.config import F5Config
    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from oron_tts_tpu_torch.parallel.mesh import make_mesh
    from oron_tts_tpu_torch.train.checkpoint import flatten_tree, write_npz

    t_phase = time.perf_counter()
    cfg = F5Config()
    totals: dict[str, int] = {}

    def add(counts: dict) -> None:
        for k, n in counts.items():
            totals[k] = totals.get(k, 0) + n

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        # 1. NCCL with a world of one, through the entry points, at the Base width
        # (MESH_CLI_DEPTH blocks) in bf16, from a seeded checkpoint
        cli_model = {"depth": MESH_CLI_DEPTH}
        ckpt = root / "ckpt"
        ckpt.mkdir()
        write_npz(ckpt / "f5tts_step_00000001.npz", flatten_tree(
            {"params": serve_params(F5Config.from_dict({"model": cli_model}))}))
        (ckpt / "config.json").write_text(json.dumps({"model": cli_model}))
        params = serve_params(cfg)  # the full Base tree: step times and the two ranks
        full_ckpt = root / "base.npz"
        write_npz(full_ckpt, flatten_tree({"params": params}))
        config = {"model": cli_model, "batch_size": TRAIN_B, "num_epochs": 1,
                  "learning_rate": 1e-4,
                  "save_best_between_intervals": False,
                  "warmup_steps": 2, "log_interval": 1, "save_interval": 1,
                  "max_checkpoints": 1, "use_tqdm": False, "num_workers": 2,
                  "audio_sample_interval": 10**9, "gradient_checkpointing": False,
                  "mixed_precision": "bfloat16", "seed": 0}
        data, cfg_path = mesh_corpus(root, config)
        train_args = ["--config", str(cfg_path), "--from-local", "--data-dir", str(data),
                      "--pretrain-ckpt", str(ckpt / "f5tts_step_00000001.npz")]
        infer_args = ["--checkpoint", str(ckpt), "--text", MN_TEXT, "--steps", "8",
                      "--seed", "0"]
        (root / "mesh_cli.json").write_text(json.dumps({
            "train": train_args + ["--checkpoint-dir", str(root / "run_mesh"),
                                   "--log-dir", str(root / "log_mesh")],
            "infer": infer_args + ["--output", str(root / "mesh.wav")],
            "serve": ["--checkpoint", str(ckpt)]}))
        # one rank under torchrun runs the three entry points' mains in turn (one
        # process start and one NCCL world for all three, to fit the time limit)
        log, wall = run_cmd(torchrun(free_port()) + [__file__, "--mesh-cli", str(root)], 600)
        got = json.loads((root / "mesh_cli_out.json").read_text())
        # the no-mesh trainer of the same state, batches and generator seed: cli.train's
        # own steps, in this process, without its checkpoint write
        plain, step_ms = cli_train_plain(torch, cfg_path, data, ckpt, root)
        with np.load(root / "run_mesh" / "f5tts_step_00000002.npz") as npz:
            same = all(np.array_equal(npz[f"params/{k}"], v) for k, v in plain["params"].items())
            n_params = sum(1 for k in npz.files if k.startswith("params/"))
        steps = step_lines(log)
        emit({"phase": "mesh_train_1x1", "entry": "cli.train --mesh 1x1 (torchrun, NCCL)",
              "steps_mesh": steps, "steps_plain": plain["steps"], "batches": plain["batches"],
              "params_bit_equal": same and n_params == len(plain["params"]),
              "nccl": "Device mesh: {'data': 1, 'model': 1}" in log,
              "plain_step_ms": step_ms, "wall_s": {"torchrun_all_three": wall, **got["seconds"]},
              "card": smi})
        if not (same and n_params == len(plain["params"]) and len(steps) == 2
                and [f"{a:.4f}/{b:.4f}" for a, b in steps] == plain["steps"]):
            raise AssertionError("cli.train --mesh 1x1 differs from the trainer without a mesh")
        del plain

        from oron_tts_tpu_torch.cli import infer as cli_infer

        t0 = time.perf_counter()
        cli_infer.main(infer_args + ["--output", str(root / "plain.wav")])
        plain_s = time.perf_counter() - t0
        wavs = {m: (root / f"{m}.wav").read_bytes() for m in ("mesh", "plain")}
        emit({"phase": "mesh_infer_1x1", "entry": "cli.infer --mesh 1x1 (torchrun, NCCL)",
              "wav_bytes": len(wavs["mesh"]), "bit_equal": wavs["mesh"] == wavs["plain"],
              "wall_s": {"mesh": got["seconds"]["infer"], "plain_in_process": plain_s},
              "card": smi})
        if wavs["mesh"] != wavs["plain"]:
            raise AssertionError("cli.infer --mesh 1x1 differs from cli.infer without a mesh")
        srv = got["serve"]
        emit({"phase": "mesh_serve_1x1", "entry": "cli.serve --mesh 1x1 (torchrun, NCCL)",
              **srv, "card": smi})
        if not (srv["healthz"].get("mesh") == {"data": 1, "model": 1}
                and srv["codes"] == [200] * 9 and srv["merged_batches"] >= 1
                and srv["drained"]):
            raise AssertionError(f"cli.serve --mesh 1x1: {srv}")

        # the step time at [12, 2048] and 22 blocks with and without a world-of-one
        # mesh, in this process; the first step of each is a warm-up
        wrappers = kernel_wrappers()
        times = {}
        for mode in ("plain", "mesh"):
            mesh = make_mesh(1, 1, device="cuda") if mode == "mesh" else None
            zero_counts(wrappers)
            times[mode] = mesh_train_steps(torch, cfg, params, mesh, False, rows=TRAIN_B,
                                           steps=3)
            times[mode]["launches"] = {n: c for n, c in read_counts(wrappers).items() if c}
            add(times[mode]["launches"])
            torch.cuda.empty_cache()
        torch.distributed.destroy_process_group()
        same_steps = (times["mesh"]["loss"] == times["plain"]["loss"]
                      and times["mesh"]["grad_norm"] == times["plain"]["grad_norm"])
        emit({"phase": "mesh_step_1x1", "batch": [TRAIN_B, TRAIN_T],
              "step_ms_mesh": times["mesh"]["step_ms"],
              "step_ms_plain": times["plain"]["step_ms"],
              "mesh_over_plain": times["mesh"]["step_ms"][-1] / times["plain"]["step_ms"][-1],
              "loss": times["mesh"]["loss"], "bit_equal": same_steps, "card": smi})
        if not same_steps:
            raise AssertionError(f"the world-of-one step differs: {times}")

        # 2. two ranks sharing the card over gloo, at Base bf16, dropout 0.1
        ref = mesh_train_steps(torch, cfg, params, None, False)
        model = F5TTS(cfg)
        model.load_params(params)
        ref_mel = model.synthesize_mel(MN_TEXT, **MESH_SYNTH)
        del model
        torch.cuda.empty_cache()
        gloo_port = free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, __file__, "--mesh-rank", str(r),
                                   str(gloo_port), str(root), str(full_ckpt)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=900)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, o) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"mesh rank {r} exited {p.returncode}:\n{o[-4000:]}")
        ranks = [json.loads((root / f"rank{r}.json").read_text()) for r in range(2)]
        for name, dp, tp, zero in MESH_CASES:
            got = [rk[name] for rk in ranks]
            loss_rel = abs(got[0]["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0])
            norm_rel = abs(got[0]["grad_norm"][0] - ref["grad_norm"][0]) / ref["grad_norm"][0]
            agree = all(g["loss"] == got[0]["loss"] and g["grad_norm"] == got[0]["grad_norm"]
                        for g in got)
            for g in got:
                add(g["launches"])
            emit({"phase": "mesh_two_ranks", "case": name, "mesh": {"data": dp, "model": tp},
                  "zero1": zero, "global_batch": [MESH_B, TRAIN_T], "rows_per_rank": got[0]["rows"],
                  "loss": got[0]["loss"], "grad_norm": got[0]["grad_norm"],
                  "single_loss": ref["loss"][0], "single_grad_norm": ref["grad_norm"][0],
                  "loss_rel_err": loss_rel, "loss_tol": MESH_LOSS_REL_TOL,
                  "grad_norm_rel_err": norm_rel, "grad_norm_tol": MESH_NORM_REL_TOL,
                  "ranks_agree": agree, "peak_gb_by_rank": [g["peak_gb"] for g in got],
                  "moment_gb_by_rank": [g["moment_gb"] for g in got],
                  "step_ms_by_rank": [g["step_ms"] for g in got],
                  "step_ms_note": "gloo staging through the host, two ranks on one card",
                  "launches_by_rank": [g["launches"] for g in got], "card": smi})
            if not (agree and all(all(g["ok"]) for g in got) and loss_rel <= MESH_LOSS_REL_TOL
                    and norm_rel <= MESH_NORM_REL_TOL):
                raise AssertionError(f"two-rank {name}: loss {loss_rel}, norm {norm_rel}, "
                                     f"ranks agree {agree}")
        mel = np.load(root / "tp2_mel.npy")
        mel_rel = float(np.linalg.norm(mel - ref_mel) / np.linalg.norm(ref_mel))
        synth = [rk["tp2_synth"] for rk in ranks]
        for s_ in synth:
            add(s_["launches"])
        emit({"phase": "mesh_two_ranks", "case": "tp2_synthesize_mel", "shape": list(mel.shape),
              "mel_rel_l2": mel_rel, "tol": MESH_MEL_REL_L2_TOL,
              "local_heads": synth[0]["local_heads"], "attn_impl": synth[0]["attn_impl"],
              "launches_by_rank": [s_["launches"] for s_ in synth],
              "seconds": time.perf_counter() - t0, "card": smi})
        if not (mel.shape == ref_mel.shape and mel_rel <= MESH_MEL_REL_L2_TOL
                and synth[0]["local_heads"] == 8 and synth[0]["attn_impl"] == "lanes"):
            raise AssertionError(f"TP-2 synthesis: rel L2 {mel_rel}, {synth[0]}")
    emit({"phase": "mesh_summary", "seconds": time.perf_counter() - t_phase,
          "launches": totals, "card": smi})
    return totals


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from oron_tts_tpu_torch.ops import _build
    from oron_tts_tpu_torch.utils.device import card_name

    smi = card_name("cuda")
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    logs: dict[str, str] = {}
    build_s: dict[str, float] = {}
    libs = _build.build_all(verbose=True, logs=logs, seconds=build_s)
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "seconds_by_library": build_s,
          "libraries": [str(p.relative_to(_build.BUILD_DIR.parents[1])) for p in libs.values()]})
    emit({"phase": "sass", "hgmma": hgmma_counts(libs)})
    emit({"phase": "forward_build", "by_width": forward_build(logs.get("flash_classic", ""))})
    emit({"phase": "qmm_build", "by_tile": qmm_build(logs.get("qmm", ""))})
    emit({"phase": "conv_build", "by_tile": conv_build(logs.get("grouped_conv", ""))})
    emit({"phase": "mel_build", "by_n_fft": mel_build(logs.get("fused_mel", ""))})

    seconds = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.empty_cache()
        seconds[name] = time.perf_counter() - t
        return out

    rows = timed("kernels", check_kernels, torch, F)
    timed("reference", check_reference, torch)
    timed("reference_train", check_train_reference, torch)
    timed("reference_serve", check_reference_serve, torch)
    launches: dict[str, int] = {}
    for name, phase in (("slice", run_slice), ("train", run_train), ("serve", run_serve),
                        ("batch_knee", run_batch_knee), ("classic", run_classic),
                        ("widths", run_widths), ("align", run_align), ("interop", run_interop),
                        ("memory", run_memory), ("serve_load", run_serve_load),
                        ("streaming", run_streaming), ("prepare", run_prepare),
                        ("vocoder", run_vocoder), ("grad_accum", run_grad_accum),
                        ("levers", run_levers), ("mesh", run_mesh)):
        for kernel, n in (timed(name, phase, torch, smi) or {}).items():
            launches[kernel] = launches.get(kernel, 0) + n
    emit({"phase": "phase_seconds", **seconds, "total_s": time.perf_counter() - t0})
    emit({"kernels": [
        {k: row[k] for k in ("name", "route", "source", "replaces")}
        | {"launches": launches[row["name"]]}
        | {k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms")}
        | {"library": row.get("library"), "shape": row.get("shape")}
        | {k: row[k] for k in ("entry", "pass_a_ms", "pass_b_ms", "graph_ms", "library_graph_ms",
                               "plain_graph_ms", "linear_bf16_ms", "linear_bf16_graph_ms",
                               "host_ms", "library_bound_ms")
           if k in row}
        for row in rows
    ], "card": smi})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:  # one of the mesh phase's two ranks
        sys.exit(mesh_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--mesh-cli"]:  # the mesh phase's torchrun rank
        sys.exit(mesh_cli_main(sys.argv[2:]))
    sys.exit(main())
