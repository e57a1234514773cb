// The trainer's guarded AdamW + EMA + working-set copy over every leaf in one
// multi-tensor launch, for Hopper (sm_90a).
//
// Replaces no TPU kernel: in the JAX package XLA fuses optax's update
// (oron_tts_tpu/train/trainer.py _guarded_update) on its own. The port's eager
// update (ops/fused_update.py adamw_ema_plain) ran ~23 PyTorch operations a
// leaf, 8,349 launches a step for Base's 363 leaves, and moved several times
// the bytes below through temporaries.
//
// Bound on the H100: bytes. One pass reads and writes each state once, 34
// bytes a parameter: the f32 gradient (read, 4), the f32 master (read and
// write, 8), the bf16 first moment (read and write, 4), the f32 second moment
// (read and write, 8), the f32 EMA (read and write, 8) and the bf16 working
// copy (write, 2); ~25 f32 operations against them. So the design is only
// about memory: one pass with every intermediate in registers, 16-byte loads
// and stores of four f32 (8 bytes of four bf16) where the leaf's addresses
// allow, neighbouring threads on neighbouring addresses, and one launch for all
// leaves through a table. The table holds a descriptor a leaf (Leaf, written
// by ops/fused_update.py leaf_table): its addresses, its size, the layout of
// the master it writes and its first chunk. Each block takes one chunk of
// `chunk` elements of one leaf (a multiple of 4, the wrapper's CHUNK), and
// finds its leaf by a search over the table.
//
// The master may be a strided view (ZeRO-1: this rank's block along a
// non-leading axis): element i of the view lies at (i / run) * stride + i % run.
// Every other tensor is contiguous in the view's order. A ZeRO-1 step launches
// twice: the AdamW half on the views (kAdam), then, after the masters are
// gathered, the EMA and the working copy on the whole masters (kEma). A step
// on whole tensors launches once (kAdam | kEma) and never reads a master back.
//
// The arithmetic repeats the eager CUDA path's roundings, in its order, so
// the two are bit-equal: each eager operation is one f32 rounding here
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), a division by a Python
// float is a multiplication by its f32 reciprocal (PyTorch's CUDA division by
// a CPU scalar), `update.add_(p, alpha=wd)` is the fused a + alpha * b that
// PyTorch's add kernel compiles to, the bf16 first moment times the
// bf16-rounded b1 is rounded to bf16 (optax's order), and every stored bf16
// is rounded to nearest even. The wrapper rounds each Python float to f32 as
// TensorIterator does. Per element:
//   g  = clip ? (g * (1 / norm)) * max_norm : g
//   mu = g * (1 - b1) + [bf16](m * bf16(b1))   (an f32 m, or the exact form
//                                               after a resume: m * b1 in f32)
//   v  = v * b2 + (g * g) * (1 - b2)
//   u  = (mu * (1 / bc1)) / (sqrt(v * (1 / bc2)) + eps);  u = fma(wd, p, u)
//   p  = p + u * (-lr);  m = mu;  e = e * decay + p * (1 - decay);  w = p
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// launch flags
constexpr int kClip = 1;     // scale the gradient by max_norm / norm
constexpr int kMuExact = 2;  // a bf16 moment times b1 in f32 (the first step after a resume)
constexpr int kAdam = 4;     // the AdamW half: master, moments
constexpr int kEma = 8;      // the EMA and the working copy, from the master

// per-leaf flags
constexpr long long kVec = 1;     // addresses aligned and runs a multiple of 4: vector path
constexpr long long kMBf16 = 2;   // first moment in bf16 (else f32)
constexpr long long kWBf16 = 4;   // working parameter in bf16 (else f32)

// One leaf; 8-byte fields in the order of ops/fused_update.py LEAF_FIELDS.
struct Leaf {
  float* p;         // master (or its view)
  const float* g;   // gradient
  void* m;          // first moment
  float* v;         // second moment
  float* e;         // EMA (unused without kEma)
  void* w;          // working parameter (unused without kEma)
  long long n;      // elements
  long long run;    // contiguous run of the master (n when whole)
  long long stride; // the master's elements from one run to the next
  long long chunk0; // the leaf's first chunk in the launch
  long long flags;
};

struct Scalars {
  float neg_lr, b1, b1_lp, one_minus_b1, b2, one_minus_b2, inv_bc1, inv_bc2, eps, wd;
  float decay, one_minus_decay, clip_inv, clip_max;
  int flags;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// AdamW on one element: updates p and v, returns the new first moment in f32
template <bool MBF16>
__device__ __forceinline__ float adam(float g, float m, float& p, float& v, const Scalars& s) {
  if (s.flags & kClip) g = __fmul_rn(__fmul_rn(g, s.clip_inv), s.clip_max);
  const float mb = MBF16 && !(s.flags & kMuExact) ? bf16_round(__fmul_rn(m, s.b1_lp))
                                                  : __fmul_rn(m, s.b1);
  const float mu = __fadd_rn(__fmul_rn(g, s.one_minus_b1), mb);
  v = __fadd_rn(__fmul_rn(v, s.b2), __fmul_rn(__fmul_rn(g, g), s.one_minus_b2));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, s.inv_bc2)), s.eps);
  float u = __fdiv_rn(__fmul_rn(mu, s.inv_bc1), den);
  u = __fmaf_rn(s.wd, p, u);
  p = __fadd_rn(p, __fmul_rn(u, s.neg_lr));
  return mu;
}

__device__ __forceinline__ float ema(float e, float p, const Scalars& s) {
  return __fadd_rn(__fmul_rn(e, s.decay), __fmul_rn(p, s.one_minus_decay));
}

__device__ __forceinline__ long long master_at(const Leaf& L, long long i) {
  return L.run == L.n ? i : (i / L.run) * L.stride + i % L.run;
}

template <bool MBF16>
__device__ __forceinline__ float load_m(const void* m, long long i) {
  if constexpr (MBF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(m)[i]);
  else return static_cast<const float*>(m)[i];
}

template <bool BF16>
__device__ __forceinline__ void store_lp(void* dst, long long i, float x) {
  if constexpr (BF16) static_cast<__nv_bfloat16*>(dst)[i] = __float2bfloat16_rn(x);
  else static_cast<float*>(dst)[i] = x;
}

template <bool MBF16>
__device__ __forceinline__ float4 load_m4(const void* m, long long i) {
  if constexpr (MBF16) {
    const uint2 raw = *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(m) + i);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(a.x, a.y, b.x, b.y);
  } else {
    return *reinterpret_cast<const float4*>(static_cast<const float*>(m) + i);
  }
}

template <bool BF16>
__device__ __forceinline__ void store_lp4(void* dst, long long i, float4 x) {
  if constexpr (BF16) {
    __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
    __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
    uint2 raw;
    raw.x = *reinterpret_cast<uint32_t*>(&a);
    raw.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(dst) + i) = raw;
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(dst) + i) = x;
  }
}

template <int MODE, bool MBF16, bool WBF16>
__device__ __forceinline__ void one(const Leaf& L, long long i, const Scalars& s) {
  float* pp = L.p + master_at(L, i);
  float p = *pp;
  if constexpr ((MODE & kAdam) != 0) {
    float v = L.v[i];
    const float mu = adam<MBF16>(L.g[i], load_m<MBF16>(L.m, i), p, v, s);
    *pp = p;
    L.v[i] = v;
    store_lp<MBF16>(L.m, i, mu);
  }
  if constexpr ((MODE & kEma) != 0) {
    L.e[i] = ema(L.e[i], p, s);
    store_lp<WBF16>(L.w, i, p);
  }
}

// four elements from i (a multiple of 4): one vector access a tensor
template <int MODE, bool MBF16, bool WBF16>
__device__ __forceinline__ void four(const Leaf& L, long long i, const Scalars& s) {
  float4* pp = reinterpret_cast<float4*>(L.p + master_at(L, i));
  float4 p = *pp;
  if constexpr ((MODE & kAdam) != 0) {
    const float4 g = *reinterpret_cast<const float4*>(L.g + i);
    const float4 m = load_m4<MBF16>(L.m, i);
    float4 v = *reinterpret_cast<const float4*>(L.v + i);
    float4 mu;
    mu.x = adam<MBF16>(g.x, m.x, p.x, v.x, s);
    mu.y = adam<MBF16>(g.y, m.y, p.y, v.y, s);
    mu.z = adam<MBF16>(g.z, m.z, p.z, v.z, s);
    mu.w = adam<MBF16>(g.w, m.w, p.w, v.w, s);
    *pp = p;
    *reinterpret_cast<float4*>(L.v + i) = v;
    store_lp4<MBF16>(L.m, i, mu);
  }
  if constexpr ((MODE & kEma) != 0) {
    float4 e = *reinterpret_cast<const float4*>(L.e + i);
    e.x = ema(e.x, p.x, s);
    e.y = ema(e.y, p.y, s);
    e.z = ema(e.z, p.z, s);
    e.w = ema(e.w, p.w, s);
    *reinterpret_cast<float4*>(L.e + i) = e;
    store_lp4<WBF16>(L.w, i, p);
  }
}

template <int MODE, bool MBF16, bool WBF16>
__device__ __forceinline__ void chunk(const Leaf& L, long long start, long long end,
                                      const Scalars& s) {
  long long tail = start;
  if (L.flags & kVec) {
    tail = start + ((end - start) & ~3LL);
    for (long long i = start + 4 * threadIdx.x; i < tail; i += 4 * kThreads)
      four<MODE, MBF16, WBF16>(L, i, s);
  }
  for (long long i = tail + threadIdx.x; i < end; i += kThreads) one<MODE, MBF16, WBF16>(L, i, s);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
adamw_ema_kernel(const Leaf* __restrict__ leaves, int n_leaves, long long chunk_elems,
                 Scalars s) {
  __shared__ int found;
  const long long c = blockIdx.x;
  // the leaf whose chunks hold c: chunk0 ascends, and an empty leaf holds none
  for (int l = threadIdx.x; l < n_leaves; l += kThreads) {
    const long long c1 = l + 1 < n_leaves ? leaves[l + 1].chunk0 : (1LL << 62);
    if (leaves[l].chunk0 <= c && c < c1) found = l;
  }
  __syncthreads();
  const Leaf L = leaves[found];
  const long long start = (c - L.chunk0) * chunk_elems;
  const long long end = start + chunk_elems < L.n ? start + chunk_elems : L.n;
  const bool mb = L.flags & kMBf16, wb = L.flags & kWBf16;
  if (mb && wb) chunk<MODE, true, true>(L, start, end, s);
  else if (mb) chunk<MODE, true, false>(L, start, end, s);
  else if (wb) chunk<MODE, false, true>(L, start, end, s);
  else chunk<MODE, false, false>(L, start, end, s);
}

}  // namespace

// table: n_leaves Leaf records on the device; chunk: elements a block takes
// (a multiple of 4); n_chunks: the last leaf's chunk0 plus its chunks. flags:
// kClip | kMuExact | kAdam | kEma. Returns cudaGetLastError().
extern "C" int fused_adamw_ema(const void* table, int n_leaves, long long chunk,
                               long long n_chunks,
                               float neg_lr, float b1, float b1_lp, float one_minus_b1, float b2,
                               float one_minus_b2, float inv_bc1, float inv_bc2, float eps,
                               float wd, float decay, float one_minus_decay, float clip_inv,
                               float clip_max, int flags, void* stream) {
  if (n_leaves <= 0 || n_chunks <= 0) return 0;
  if (chunk <= 0 || chunk % 4) return (int)cudaErrorInvalidValue;
  const Scalars s{neg_lr, b1, b1_lp, one_minus_b1, b2, one_minus_b2, inv_bc1, inv_bc2, eps, wd,
                  decay, one_minus_decay, clip_inv, clip_max, flags};
  const Leaf* leaves = static_cast<const Leaf*>(table);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)n_chunks);
  switch (flags & (kAdam | kEma)) {
    case kAdam | kEma:
      adamw_ema_kernel<kAdam | kEma><<<grid, kThreads, 0, st>>>(leaves, n_leaves, chunk, s);
      break;
    case kAdam:
      adamw_ema_kernel<kAdam><<<grid, kThreads, 0, st>>>(leaves, n_leaves, chunk, s);
      break;
    case kEma:
      adamw_ema_kernel<kEma><<<grid, kThreads, 0, st>>>(leaves, n_leaves, chunk, s);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
