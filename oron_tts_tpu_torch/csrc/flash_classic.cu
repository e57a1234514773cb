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
// lanes kernels' body with another stride. D is any multiple of 8 (the
// wrapper zero-pads any other width and passes the scale of the true one); to
// 256 a width that is not a multiple of 16 runs padded to the next one, above
// 256 the body's wide form runs (attn_fwd_wide: D in chunks for S, one part
// of 128 output columns a block).
//
// flash_classic_fwd: one block of two warpgroups per (128 query rows, head,
// batch row); exp2 of s*scale*log2(e) or (use_exp2 = 0) exp of s*scale. The
// TPU kernel runs a two-pass softmax over a whole key row when T <= 2048 and
// an online one above; here keys always stream in tiles of 64 with the online
// softmax, which gives the same value.
//
// flash_packed_fwd: the same function for even H; one launch writes both
// heads of every pair. The TPU kernel packs the pair into one [2T, 2D]
// block-diagonal product with zero halves to fill its 128-lane matrix unit;
// that doubles the MACs and is not carried over, and neither is a block that
// holds both heads' K/V tiles: the two heads share no tile, and one head's
// K/V tile feeding 128 query rows halves the copies a product needs. So a
// block here is the classic kernel's, and the packed launch differs from it
// only in its contract (even H; odd H is the wrapper's business, as the JAX
// function falls back to flash_attention there).
//
// flash_nosm: (q.k^T in f32) * (1/T), cast to the input type, times V with
// f32 accumulation; no mask, no scale, no softmax. The bench uses it to split
// attention's time between the two products and the softmax.
//
// Bound on the H100: ~4*T*kv*H*D flops over ~8*B*H*T*D bytes, ~400 flops per
// byte at the synthesis shape, so the tensor cores; bf16 runs wgmma with a
// cp.async ring (flash_fwd.cuh), f32 a SIMT path in true f32.
#include "flash_fwd.cuh"

using namespace oron::attn;

// scale: 1/sqrt(D) of the true head width (Dh may be a zero-padded one)
extern "C" int flash_classic_fwd(const void* q, const void* k, const void* v,
                                 const void* kv_lens, void* out, int B, int H, int T,
                                 int Dh, float scale, int use_exp2, int is_bf16, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return launch_fwd_any<SOFTMAX>(q, k, v, kv_lens, out, nullptr, B, T, H, Dh,
                                 classic_layout(T, H, Dh), scale, use_exp2, is_bf16, st);
}

extern "C" int flash_packed_fwd(const void* q, const void* k, const void* v,
                                const void* kv_lens, void* out, int B, int H, int T,
                                int Dh, float scale, int is_bf16, void* stream) {
  if (H % 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return launch_fwd_any<SOFTMAX>(q, k, v, kv_lens, out, nullptr, B, T, H, Dh,
                                 classic_layout(T, H, Dh), scale, 1, is_bf16, st);
}

extern "C" int flash_nosm(const void* q, const void* k, const void* v, void* out, int B,
                          int H, int T, int Dh, int is_bf16, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return launch_fwd_any<NOSM>(q, k, v, nullptr, out, nullptr, B, T, H, Dh,
                              classic_layout(T, H, Dh), 1.f / (float)T, 1, is_bf16, st);
}

// Blocks of the bf16 forward (every entry above and the lanes ones run it)
// that one SM holds at head width Dh; a negative value is a CUDA error.
extern "C" int flash_fwd_blocks_per_sm(int Dh) {
  return with_padded_dim<FWD_MAX_DH>(Dh, [&](auto d) {
    constexpr int DP = decltype(d)::value;
    return fwd_blocks_per_sm<DP>();
  });
}
