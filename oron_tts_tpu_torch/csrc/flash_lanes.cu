// Lanes-layout flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernels oron_tts_tpu/ops/flash_attention.py:387
// (_flash_lanes_kernel) and :424 (_flash_lanes_fwd_stats_kernel: the same
// output plus the row statistic the backward reads). q, k, v and o stay in
// the [B, T, H*D] layout the projections write: a block reads its head's D
// columns with strided rows, so no head transpose is ever materialised. The
// device body is flash_fwd.cuh's (semantics, design and the online softmax
// are described there), with the lanes Layout; head widths 32 and 64.
//
// Bound on the H100: at the slice's shapes (T ~ 832, H*D = 1024) the work
// is ~4*T*kv*H*D flops over ~8*T*H*D bytes, some 400 flops per byte, so
// the bound is the tensor cores. bf16 uses mma.sync m16n8k16 with f32
// accumulators (not yet wgmma/TMA); f32 inputs take a plain SIMT kernel
// in true f32, one query row per thread.
//
// Stats: the online softmax ends with the row's running max m and sum l in
// registers, so flash_lanes_fwd_stats writes lse2 = m + log2(max(l, 1e-30)),
// in base-2 units of the scaled scores s = q.k / sqrt(D) * log2(e), to a
// [B, H, T] f32 tensor (the TPU keeps [B, H*D/128, 128/D, T]). Both entry
// points launch the same kernel; a null lse pointer skips that one store, so
// the attention output is bit-equal between them. A row with kv_len <= 0 gets
// lse2 = log2(T) (equal weights); the TPU's -1e30 mask gives -1e30 there.
// Training never has such a row with a non-zero gradient.
#include "flash_fwd.cuh"

namespace {

using namespace oron::attn;

int launch_lanes(const void* q, const void* k, const void* v, const void* kv_lens,
                 void* out, float* lse, int B, int T, int H, int Dh, int is_bf16,
                 void* stream) {
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)Dh);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return with_head_dim<32, 64>(Dh, [&](auto d) {
    constexpr int D = decltype(d)::value;
    return launch_fwd<D, SOFTMAX, 1>(q, k, v, kv_lens, out, lse, B, T, H,
                                     lanes_layout(T, H, D), scale_log2, 1, is_bf16, st);
  });
}

}  // namespace

extern "C" int flash_lanes_fwd(const void* q, const void* k, const void* v,
                               const void* kv_lens, void* out, int B, int T,
                               int H, int Dh, int is_bf16, void* stream) {
  return launch_lanes(q, k, v, kv_lens, out, nullptr, B, T, H, Dh, is_bf16, stream);
}

// Same output, plus lse2 [B, H, T] f32 for the backward.
extern "C" int flash_lanes_fwd_stats(const void* q, const void* k, const void* v,
                                     const void* kv_lens, void* out, void* lse,
                                     int B, int T, int H, int Dh, int is_bf16,
                                     void* stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return launch_lanes(q, k, v, kv_lens, out, static_cast<float*>(lse), B, T, H, Dh,
                      is_bf16, stream);
}
