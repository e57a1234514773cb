// Classic-layout flash attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel oron_tts_tpu/ops/flash_attention.py:749
// (_flash_bwd_kernel, called by _flash_bwd :831, the VJP of
// flash_attention_trainable :874): dq, dk, dv of [B, H, T, D] q, k, v from
// the forward's output and its gradient. D is 32, 48 or 64.
//
// Like the TPU kernel it receives no saved statistics and recomputes the row
// max and sum from s = q.k: a stats pass (flash_fwd.cuh in STATS mode, the
// forward without its PV product) writes lse2 = m + log2(max(l, 1e-30)) to a
// scratch [B, H, T]; then flash_bwd.cuh's three passes run with the classic
// Layout, p = exp2(s - lse2) standing for the TPU's exp2(s - m) / l. A row
// with kv_len <= 0 gets the TPU kernel's gradients: every key weighs 1/T
// (its -1e30 mask makes all scores equal), and dq, dk, dv follow from those
// weights, non-zero.
//
// Design: the TPU kernel is one program per (b, h) looping over query
// blocks and carrying dK/dV; that would be 192 blocks at the training shape
// on 132 SMs. Here the dK/dV pass has one block per (64 keys, head, batch
// row) and the dQ pass one per (64 queries, head, batch row): 6,144 blocks
// each at [12*16, 2048, 64], and no atomics.
//
// Bound on the H100: 10*T*kv*B*H*D flops (five products) over ~16*B*H*T*D
// bytes, so the tensor cores; the stats pass and the two recomputes add
// 2 + 4 products' worth (mma.sync, no wgmma/TMA yet).
#include "flash_bwd.cuh"

using namespace oron::attn;

// lse and delta are [B, H, T] f32 scratch the wrapper allocates.
extern "C" int flash_classic_bwd(const void* q, const void* k, const void* v,
                                 const void* out, const void* dout, const void* kv_lens,
                                 void* lse, void* delta, void* dq, void* dk, void* dv,
                                 int B, int H, int T, int Dh, int is_bf16, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)Dh);
  return with_head_dim<32, 48, 64>(Dh, [&](auto d) {
    constexpr int D = decltype(d)::value;
    const Layout lay = classic_layout(T, H, D);
    const int err = launch_fwd<D, STATS, 1>(q, k, nullptr, kv_lens, nullptr,
                                            static_cast<float*>(lse), B, T, H, lay,
                                            scale_log2, 1, is_bf16, st);
    if (err != 0) return err;
    if (is_bf16)
      return launch_bwd<__nv_bfloat16, D>(q, k, v, out, dout, lse, kv_lens, delta, dq, dk,
                                          dv, B, T, H, lay, 1, st);
    return launch_bwd<float, D>(q, k, v, out, dout, lse, kv_lens, delta, dq, dk, dv, B, T,
                                H, lay, 1, st);
  });
}
