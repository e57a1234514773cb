// Lanes-layout flash attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel oron_tts_tpu/ops/flash_attention.py:528
// (_flash_lanes_bwd_kernel): dq, dk, dv from q, k, v, the forward's output,
// its gradient and the row statistic lse2 [B, H, T] that
// flash_lanes_fwd_stats saved. All [B, T, H*D] tensors keep that layout.
// The math, the three passes (delta, dK/dV per key tile, dQ per query tile,
// no atomics) and the f32 SIMT path are flash_bwd.cuh's, with the lanes
// Layout; head widths 32 and 64. A row with kv_len <= 0 gets zero gradients.
//
// Bound on the H100: 10*T*kv*H*D flops (five products) over ~16*T*H*D bytes,
// far above 295 flops per byte, so the tensor cores bound it.
#include "flash_bwd.cuh"

using namespace oron::attn;

// delta is [B, H, T] f32 scratch the wrapper allocates; lse is the forward's.
extern "C" int flash_lanes_bwd(const void* q, const void* k, const void* v,
                               const void* out, const void* dout, const void* lse,
                               const void* kv_lens, void* delta, void* dq, void* dk,
                               void* dv, int B, int T, int H, int Dh, int is_bf16,
                               void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return with_head_dim<32, 64>(Dh, [&](auto d) {
    constexpr int D = decltype(d)::value;
    const Layout lay = lanes_layout(T, H, D);
    if (is_bf16)
      return launch_bwd<__nv_bfloat16, D>(q, k, v, out, dout, lse, kv_lens, delta, dq, dk,
                                          dv, B, T, H, lay, 0, st);
    return launch_bwd<float, D>(q, k, v, out, dout, lse, kv_lens, delta, dq, dk, dv, B, T,
                                H, lay, 0, st);
  });
}
