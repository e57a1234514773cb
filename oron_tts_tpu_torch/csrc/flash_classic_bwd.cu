// Classic-layout flash attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel oron_tts_tpu/ops/flash_attention.py:749
// (_flash_bwd_kernel, called by _flash_bwd :831, the VJP of
// flash_attention_trainable :874): dq, dk, dv of [B, H, T, D] q, k, v from
// the forward's output and its gradient. Head widths: every multiple of 8,
// as the forward and the TPU kernel (the wrapper zero-pads any other width to
// the next multiple of 8 and passes the scale of the true one); from 136 to
// 256 the body's wide variant runs (flash_bwd.cuh, BwdTile), above 256 its
// chunked bodies (bwd_dq_wide, bwd_dkdv_wide), one part of 128 columns of dQ,
// or of dK and dV, a block.
//
// Like the TPU kernel it receives no saved statistics: pass A of
// flash_bwd.cuh (CLASSIC) first sweeps S over the keys below kv_len and
// writes lse2 = m + log2(max(l, 1e-30)) to a scratch [B, H, T], then computes
// dQ; pass B reads those rows for dK and dV. p = exp2(s - lse2) stands for
// the TPU's exp2(s - m) / l. A row with kv_len <= 0 gets the TPU kernel's
// gradients: every key weighs 1/T (its -1e30 mask makes all scores equal),
// and dq, dk, dv follow from those weights, non-zero.
//
// Design: the TPU kernel is one program per (b, h) looping over query
// blocks and carrying dK/dV; that would be 192 blocks at the training shape
// on 132 SMs. Here pass A has one block per (128 queries, head, batch row)
// and pass B one per (128 keys, head, batch row): 3,072 blocks each at
// [12*16, 2048, 64], two launches, no atomics.
//
// Bound on the H100: 10*T*kv*B*H*D flops (five products) over ~16*B*H*T*D
// bytes, so the tensor cores; the statistics sweep and the recomputed S and
// dP add three products' worth.
#include "flash_bwd.cuh"

using namespace oron::attn;

// lse and delta are [B, H, T] f32 scratch the wrapper allocates; scale is
// 1/sqrt(D) of the true head width. passes: 3 for the gradients (1 and 2 run
// pass A or B alone, for timing).
extern "C" int flash_classic_bwd(const void* q, const void* k, const void* v,
                                 const void* out, const void* dout, const void* kv_lens,
                                 void* lse, void* delta, void* dq, void* dk, void* dv,
                                 int B, int H, int T, int Dh, float scale, int is_bf16,
                                 int passes, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const Layout lay = classic_layout(T, H, Dh);
  if (!is_bf16)
    return launch_bwd_f32(q, k, v, out, dout, lse, kv_lens, delta, dq, dk, dv, B, T, H, Dh, lay,
                          scale, 1, passes, st);
  if (Dh > FWD_MAX_DH)
    return launch_bwd_wide(q, k, v, out, dout, lse, kv_lens, delta, dq, dk, dv, B, T, H, Dh, lay,
                           scale, passes, st);
  return with_padded_dim<FWD_MAX_DH>(Dh, [&](auto d) {
    constexpr int DP = decltype(d)::value;
    return launch_bwd<DP, true>(q, k, v, out, dout, lse, kv_lens, delta, dq, dk, dv, B, T, H,
                                Dh, lay, scale, passes, st);
  });
}
