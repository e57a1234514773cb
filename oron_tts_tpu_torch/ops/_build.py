"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` (ten of them: ``flash_lanes``, ``flash_lanes_bwd``,
``flash_classic``, ``flash_classic_bwd``, ``gelu_dropout``, ``grouped_conv``,
``fused_mel``, ``qmm``, ``fused_adamw_ema``, ``adaln``; the attention sources share
``flash_fwd.cuh`` and ``flash_bwd.cuh``, and they, ``qmm`` and
``grouped_conv`` share ``wgmma.cuh``) exposes a plain C
interface and becomes its own shared library,
``build/torch_kernels/lib<name>_<hash>.so`` under the repository
root, compiled for ``sm_90a`` the first time a wrapper meets a CUDA tensor
(or when ``build_all`` is called). The hash covers the source, every
header and the flags, so an edited kernel is rebuilt and a built one is
reused.
Sources are compiled in parallel, one ``nvcc`` process each.

Wrappers import this module lazily: the CPU never looks for ``nvcc``.
Every pointer and the stream go through ``ctypes.c_void_p`` (a bare int
would be cut to 32 bits), and every C entry point returns
``cudaGetLastError()``, which :func:`check` turns into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# -split-compile=0 optimises a source's kernels on every core: the attention
# libraries hold dozens of template instances each, and build in half the time
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-split-compile=0",
    "-shared", "-Xcompiler", "-fPIC",
)
KERNELS = ("flash_lanes", "flash_lanes_bwd", "flash_classic", "flash_classic_bwd",
           "gelu_dropout", "grouped_conv", "fused_mel", "qmm", "fused_adamw_ema", "adaln")

# C signatures: argument ctypes per entry point (all return int)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U, _L = ctypes.c_uint32, ctypes.c_longlong
SIGNATURES = {
    "flash_lanes": {
        # q, k, v, kv_lens, out, B, T, H, D (a multiple of 8), scale (1/sqrt of
        # the true width), is_bf16, stream
        "flash_lanes_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P),
        # q, k, v, kv_lens, out, lse2 [B, H, T] f32, B, T, H, D, scale, is_bf16, stream
        "flash_lanes_fwd_stats": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P),
    },
    "flash_lanes_bwd": {
        # q, k, v, out, dout, lse2, kv_lens, delta (scratch [B, H, T] f32),
        # dq, dk, dv, B, T, H, D, scale, is_bf16, passes (3; 1 or 2 for one), stream
        "flash_lanes_bwd": (_P,) * 11 + (_I, _I, _I, _I, _F, _I, _I, _P),
    },
    "flash_classic": {
        # q, k, v, kv_lens, out, B, H, T, D, scale, use_exp2, is_bf16, stream
        "flash_classic_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P),
        # q, k, v, kv_lens, out, B, H, T, D, scale, is_bf16, stream
        "flash_packed_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P),
        # q, k, v, out, B, H, T, D, is_bf16, stream
        "flash_nosm": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
        # D: blocks of the bf16 forward an SM holds
        "flash_fwd_blocks_per_sm": (_I,),
    },
    "flash_classic_bwd": {
        # q, k, v, out, dout, kv_lens, lse2 and delta (scratch [B, H, T] f32),
        # dq, dk, dv, B, H, T, D, scale, is_bf16, passes (3; 1 or 2 for one), stream
        "flash_classic_bwd": (_P,) * 11 + (_I, _I, _I, _I, _F, _I, _I, _P),
    },
    "gelu_dropout": {
        # x, out, n, seed, threshold, inv_keep, is_bf16, cols, row0, gcols, col0, stream
        "gelu_dropout_fwd": (_P, _P, _L, _U, _U, _F, _I, _L, _L, _L, _L, _P),
        # x, dy, dx, n, seed, threshold, inv_keep, is_bf16, cols, row0, gcols, col0, stream
        "gelu_dropout_bwd": (_P, _P, _P, _L, _U, _U, _F, _I, _L, _L, _L, _L, _P),
        # x (dy), row_keep (a byte a row, or null), out, n, seed, threshold, inv_keep,
        # is_bf16, cols, row0, gcols, col0, stream
        "dropout_fwd": (_P, _P, _P, _L, _U, _U, _F, _I, _L, _L, _L, _L, _P),
        "dropout_bwd": (_P, _P, _P, _L, _U, _U, _F, _I, _L, _L, _L, _L, _P),
    },
    "grouped_conv": {
        # x, w, bias(f32), y, B, T, C, groups, K, is_bf16, stream
        "grouped_conv1d_mish": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
        # group width, K: blocks of the bf16 wgmma kernel an SM holds
        "grouped_conv_blocks_per_sm": (_I, _I),
    },
    "fused_mel": {
        # audio [B, L], B, L, window, twiddle [2, T], T, bands [3, n_mels] int32,
        # weights, n_taps, out, n_frames, n_fft, hop, n_mels, log_clip, stream
        "log_mel_fused": (_P, _I, _I, _P, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _F, _P),
    },
    "qmm": {
        # x [M, K], w_q int8 [N, K], scale f32 [N], bias [N] in x's type or null,
        # out [M, N], M, K, N, bm (quantized_matmul.qmm_plan), is_bf16, stream
        "qmm_w8a16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
        # bm: blocks of the bf16 kernel an SM holds
        "qmm_blocks_per_sm": (_I,),
    },
    "fused_adamw_ema": {
        # leaf table (ops/fused_update.py leaf_table), leaves, chunk, chunks, -lr, b1,
        # bf16(b1), 1 - b1, b2, 1 - b2, 1/bc1, 1/bc2, eps, weight decay, EMA decay,
        # 1 - decay, 1/norm, max norm, flags, stream
        "fused_adamw_ema": (_P, _I, _L, _L) + (_F,) * 14 + (_I, _P),
    },
    "adaln": {
        # op, x, y, out, x1, stats, gate, gate row stride, scale, its stride, shift, its
        # stride, B, T, dim, tile rows, is_bf16, stream
        "adaln_fwd": (_I,) + (_P,) * 6 + (_L, _P, _L, _P, _L) + (_I,) * 5 + (_P,),
        # op, x, y, dh, dres, stats, gate, gate row stride, scale, its stride, dx, dy,
        # partials, dmods, mods rows, B, T, dim, tile rows, is_bf16, stream
        "adaln_bwd": (_I,) + (_P,) * 6 + (_L, _P, _L) + (_P,) * 4 + (_I,) * 6 + (_P,),
    },
}

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for hdr in sorted(CSRC.glob("*.cuh")):
        src += hdr.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_all(names: tuple[str, ...] = KERNELS, verbose: bool = False,
              logs: dict[str, str] | None = None,
              seconds: dict[str, float] | None = None) -> dict[str, Path]:
    """Compile every missing library, all ``nvcc`` processes at once.

    ``verbose`` adds ``-Xptxas=-v`` and prints each compiler log to stderr;
    ``logs`` and ``seconds``, when given, receive each compiled library's
    log and the wall seconds its ``nvcc`` took, by name.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    start = time.perf_counter()
    todo = {n: _lib_path(n) for n in names}
    procs = {}
    for name, out in todo.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out)

    def finish(proc):
        log, _ = proc.communicate()
        return log, time.perf_counter() - start

    with ThreadPoolExecutor(max(len(procs), 1)) as pool:
        done = dict(zip(procs, pool.map(finish, (proc for proc, _, _ in procs.values()))))
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, took = done[name]
        if seconds is not None:
            seconds[name] = took
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        if logs is not None:
            logs[name] = log
        if verbose and log.strip():
            print(log.strip(), file=sys.stderr)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return todo


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        path = build_all((name,))[name]
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
