// Classic-layout attention forwards for Hopper (sm_90a): three TPU kernels.
//
//   flash_classic_fwd  replaces oron_tts_tpu/ops/flash_attention.py:32
//                      (_flash_kernel, called by flash_attention :157)
//   flash_packed_fwd   replaces oron_tts_tpu/ops/flash_attention.py:246
//                      (_flash_packed_kernel, flash_attention_packed :292)
//   flash_nosm         replaces scripts/bench_attention.py:128
//                      (_nosm_kernel, flash_nosm :140)
//
// q, k, v and o are [B, H, T, D], contiguous, bf16 or f32; kv_lens [B] int32
// is read for every (b, h) row, as the TPU kernels read their [B*H] copy. The
// device body is flash_fwd.cuh's with the classic Layout (row stride D): the
// lanes kernels' body with another stride. D is a multiple of 16 from 32 to
// 128.
//
// flash_classic_fwd: one group of 128 threads per (64 query rows, head, batch
// row); exp2 of s*scale*log2(e) or (use_exp2 = 0) exp of s*scale. The TPU
// kernel runs a two-pass softmax over a whole key row when T <= 2048 and an
// online one above; here keys always stream in tiles of 64 with the online
// softmax, which gives the same value.
//
// flash_packed_fwd: the same function for even H, one block of 256 threads
// per (64 query rows, head pair, batch row): heads 2j and 2j+1 run side by
// side, each with its own online softmax and its own shared memory, and the
// block writes both. The TPU kernel packs the pair into one [2T, 2D]
// block-diagonal product with zero halves to fill its 128-lane matrix unit;
// that doubles the MACs and is not carried over. Odd H is the wrapper's
// business (the JAX function falls back to flash_attention there).
//
// flash_nosm: (q.k^T in f32) * (1/T), cast to the input type, times V with
// f32 accumulation; no mask, no scale, no softmax. The bench uses it to split
// attention's time between the two products and the softmax.
//
// Bound on the H100: ~4*T*kv*H*D flops over ~8*B*H*T*D bytes, ~400 flops per
// byte at the synthesis shape, so the tensor cores; bf16 runs mma.sync
// m16n8k16 with f32 accumulators (no wgmma/TMA yet), f32 a SIMT path in true
// f32.
#include "flash_fwd.cuh"

using namespace oron::attn;

#define ORON_CLASSIC_DIMS 32, 48, 64, 80, 96, 112, 128

extern "C" int flash_classic_fwd(const void* q, const void* k, const void* v,
                                 const void* kv_lens, void* out, int B, int H, int T,
                                 int Dh, int use_exp2, int is_bf16, void* stream) {
  const float sm_scale = 1.f / sqrtf((float)Dh);
  const float scale = use_exp2 ? 1.4426950408889634f * sm_scale : sm_scale;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return with_head_dim<ORON_CLASSIC_DIMS>(Dh, [&](auto d) {
    constexpr int D = decltype(d)::value;
    return launch_fwd<D, SOFTMAX, 1>(q, k, v, kv_lens, out, nullptr, B, T, H,
                                     classic_layout(T, H, D), scale, use_exp2, is_bf16, st);
  });
}

extern "C" int flash_packed_fwd(const void* q, const void* k, const void* v,
                                const void* kv_lens, void* out, int B, int H, int T,
                                int Dh, int is_bf16, void* stream) {
  if (H % 2) return (int)cudaErrorInvalidValue;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)Dh);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return with_head_dim<ORON_CLASSIC_DIMS>(Dh, [&](auto d) {
    constexpr int D = decltype(d)::value;
    return launch_fwd<D, SOFTMAX, 2>(q, k, v, kv_lens, out, nullptr, B, T, H,
                                     classic_layout(T, H, D), scale_log2, 1, is_bf16, st);
  });
}

extern "C" int flash_nosm(const void* q, const void* k, const void* v, void* out, int B,
                          int H, int T, int Dh, int is_bf16, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return with_head_dim<ORON_CLASSIC_DIMS>(Dh, [&](auto d) {
    constexpr int D = decltype(d)::value;
    return launch_fwd<D, NOSM, 1>(q, k, v, nullptr, out, nullptr, B, T, H,
                                  classic_layout(T, H, D), 1.f / (float)T, 1, is_bf16, st);
  });
}
