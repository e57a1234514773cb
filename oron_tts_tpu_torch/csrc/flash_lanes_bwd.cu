// Lanes-layout flash attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel oron_tts_tpu/ops/flash_attention.py:528
// (_flash_lanes_bwd_kernel): dq, dk, dv from q, k, v, the forward's output,
// its gradient and the row statistic lse2 [B, H, T] that
// flash_lanes_fwd_stats saved. All [B, T, H*D] tensors keep that layout.
// The math, the two passes (dQ with the delta prologue per query tile, then
// dK/dV per key tile; wgmma, cp.async, no atomics) and the f32 SIMT path are
// flash_bwd.cuh's, with the lanes Layout. Head widths: multiples of 8 from 8
// to 128 (the wrapper zero-pads any narrower width to the next multiple of
// 8 and passes the scale of the true one). A row with kv_len <= 0 gets zero
// gradients.
//
// Bound on the H100: 10*T*kv*H*D flops (five products) over ~16*T*H*D bytes,
// far above 295 flops per byte, so the tensor cores bound it.
#include "flash_bwd.cuh"

using namespace oron::attn;

// delta is [B, H, T] f32 scratch the wrapper allocates; lse is the forward's;
// scale is 1/sqrt(D) of the true head width. passes: 3 for the gradients (1
// and 2 run pass A or B alone, for timing).
extern "C" int flash_lanes_bwd(const void* q, const void* k, const void* v,
                               const void* out, const void* dout, const void* lse,
                               const void* kv_lens, void* delta, void* dq, void* dk,
                               void* dv, int B, int T, int H, int Dh, float scale,
                               int is_bf16, int passes, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const Layout lay = lanes_layout(T, H, Dh);
  if (Dh > 128) return (int)cudaErrorInvalidValue;
  if (!is_bf16)
    return launch_bwd_f32(q, k, v, out, dout, const_cast<void*>(lse), kv_lens, delta, dq, dk,
                          dv, B, T, H, Dh, lay, scale, 0, passes, st);
  return with_padded_dim(Dh, [&](auto d) {
    constexpr int DP = decltype(d)::value;
    return launch_bwd<DP, false>(q, k, v, out, dout, const_cast<void*>(lse), kv_lens, delta,
                                 dq, dk, dv, B, T, H, Dh, lay, scale, passes, st);
  });
}
