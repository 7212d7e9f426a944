// flash_decode on Hopper: replaces the Pallas kernel
// repro/kernels/flash_decode.py (flash_decode, :55 / :65), single-query
// attention of q (BH, 1, D) against a contiguous cache k, v (BH, T, D)
//
//     out[b] = sum_j softmax_j(q[b] . k[b, j] * D^-0.5) v[b, j]
//
// where keys past `pos` (a device int32 shared by every row, the last valid
// index) get the score -1e30 and keys past T do not exist, as in
// ref.flash_decode_ref. Scores, m, l and the accumulator are fp32; p is
// rounded to the input type before the PV product, and out = acc / max(l,
// 1e-30), as the Pallas body does.
//
// Bound on an H100: a row reads its live K and V rows once against 4 * D
// FLOPs a key, so it is bound by bytes: at llama2-7b's decode (BH 128,
// D 128, pos 1024) 67 MB of bf16 K/V, 0.020 ms at 3.35 TB/s; at a full
// 4096 cache 268 MB, 0.080 ms.
//
// Two kernels; flash_decode.route (kernels/flash_decode.py) picks one by
// (dtype, D):
//  * flash_decode_split_launch, where D x itemsize is a multiple of 16 (a
//    row is whole 16-byte vectors): the split-KV decode core of
//    csrc/decode_split.cuh, shared with paged_attn_decode. T is cut into
//    chunks of 256 keys spread over blocks, each warp streams its keys
//    through a cp.async ring, and a second kernel merges the chunks in
//    order; its note says what the design does about latency and
//    occupancy.
//  * flash_decode_launch, every other D (bf16 D 100, f32 D 6): one block
//    of 128 threads per row walks the live keys (those <= min(pos, T - 1);
//    all T where pos < 0, whose keys all score -1e30 in the reference) in
//    tiles of KT = 32, staged into shared memory as fp32 with 16-byte
//    loads where rows allow them, rows padded to Dp = 4 x an odd number of
//    floats. Four threads score a key (interleaved quarters of D, summed
//    by shuffles, so a warp's reads of 8 keys fall on distinct banks);
//    warp 0 runs the online softmax over the tile's 32 keys; each thread
//    then owns one or two output channels and accumulates p V in
//    registers.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "convert.cuh"
#include "decode_split.cuh"

namespace {

constexpr int KT = 32;            // keys a tile holds
constexpr int kThreads = 128;     // 4 threads a key; channels tid, tid + 128
constexpr int kMaxD = 256;
constexpr int kMaxSmem = 232448;  // an H100 block's dynamic shared memory
constexpr float kNegInf = -1e30f;

using cvt::from_f;
using cvt::to_f;

// One tile's K and V rows (KT x D each, row-major with row length D) into
// fp32 shared rows of Dp floats; rows at or past `valid` become zeros.
// Columns D..Dp-1 are never written here (the kernel zeroes them once).
// With 16-byte loads, every load of the tile is issued before the first
// is used, so a tile costs one memory latency rather than one a load.
template <typename T>
__device__ __forceinline__ void stage_kv(const T* __restrict__ ksrc,
                                         const T* __restrict__ vsrc,
                                         float* ks, float* vs, int valid,
                                         int D, int Dp, bool vec) {
  if (vec) {
    constexpr int kVec = 16 / (int)sizeof(T);
    constexpr int kPer = (KT * kMaxD / kVec + kThreads - 1) / kThreads;
    const int nvec = D / kVec;
    const int total = KT * nvec;
    uint4 kb[kPer], vb[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = threadIdx.x + u * kThreads;
      const int r = i / nvec;
      if (i < total && r < valid) {
        const size_t off = (size_t)r * D + (i - r * nvec) * kVec;
        kb[u] = __ldg(reinterpret_cast<const uint4*>(ksrc + off));
        vb[u] = __ldg(reinterpret_cast<const uint4*>(vsrc + off));
      } else {
        kb[u] = vb[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (i >= total) break;
      const int r = i / nvec, c = (i - r * nvec) * kVec;
      float* ko = ks + r * Dp + c;
      float* vo = vs + r * Dp + c;
      const T* ke = reinterpret_cast<const T*>(&kb[u]);
      const T* ve = reinterpret_cast<const T*>(&vb[u]);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        ko[e] = to_f(ke[e]);     // rows past `valid` hold zero bits
        vo[e] = to_f(ve[e]);
      }
    }
  } else {
    for (int i = threadIdx.x; i < KT * D; i += kThreads) {
      const int r = i / D, c = i - r * D;
      const size_t off = (size_t)r * D + c;
      ks[r * Dp + c] = r < valid ? to_f(ksrc[off]) : 0.f;
      vs[r * Dp + c] = r < valid ? to_f(vsrc[off]) : 0.f;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ pos,
                        T* __restrict__ out, int T_len, int D, int Dp,
                        float scale, int vec) {
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // (KT, Dp)
  float* vs = ks + KT * Dp;                      // (KT, Dp)
  float* qs = vs + KT * Dp;                      // (Dp,)
  float* ps = qs + Dp;                           // (KT,) scores, then p
  float* c_s = ps + KT;                          // this tile's corr; final l

  const int bh = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31;
  // zero the padding columns of the K, V and q rows once
  const int padc = Dp - D;
  for (int i = tid; i < (2 * KT + 1) * padc; i += kThreads)
    ks[(i / padc) * Dp + D + i % padc] = 0.f;
  for (int c = tid; c < D; c += kThreads) qs[c] = to_f(q[(size_t)bh * D + c]);

  const int p_pos = *pos;
  const int last = p_pos < 0 ? T_len - 1 : min(p_pos, T_len - 1);
  const int d_end = 4 * ((D + 3) / 4);
  const int key = tid >> 2, part = tid & 3;      // scoring: 4 threads a key
  float m = kNegInf, l = 0.f;                    // live in warp 0
  float acc[2] = {0.f, 0.f};

  for (int k0 = 0; k0 <= last; k0 += KT) {
    __syncthreads();  // the previous tile's K, V and p are consumed
    const int valid = min(KT, last - k0 + 1);
    const size_t at = ((size_t)bh * T_len + k0) * D;
    stage_kv(k + at, v + at, ks, vs, valid, D, Dp, vec != 0);
    __syncthreads();

    float s = 0.f;
    const float* krow = ks + key * Dp;
    for (int d = part; d < d_end; d += 4) s = fmaf(qs[d], krow[d], s);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (part == 0) ps[key] = s;
    __syncthreads();

    if (tid < 32) {
      const int kp = k0 + lane;
      const bool counted = kp <= last;
      const float sv = kp <= p_pos ? ps[lane] * scale : kNegInf;
      float mx = counted ? sv : -INFINITY;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m, mx);
      const float pr = counted ? expf(sv - m_new) : 0.f;
      float sum = pr;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float corr = expf(m - m_new);
      l = l * corr + sum;
      m = m_new;
      ps[lane] = to_f(from_f<T>(pr));
      if (lane == 0) c_s[0] = corr;
    }
    __syncthreads();

    const float corr = c_s[0];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = tid + kThreads * j;
      if (c < D) {
        float a = 0.f;
#pragma unroll 8
        for (int r = 0; r < KT; ++r) a = fmaf(ps[r], vs[r * Dp + c], a);
        acc[j] = acc[j] * corr + a;
      }
    }
  }

  if (tid == 0) c_s[1] = l;
  __syncthreads();
  const float lf = fmaxf(c_s[1], 1e-30f);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = tid + kThreads * j;
    if (c < D) out[(size_t)bh * D + c] = from_f<T>(acc[j] / lf);
  }
}

// a row of Dp = 4 x odd floats: the scoring reads of 8 keys fall on
// distinct banks
int padded_width(int D) {
  int m = (D + 3) / 4 + 1;
  if (m % 2 == 0) ++m;
  return 4 * m;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* pos, void* out, int bh, int T_len, int D,
                   float scale, cudaStream_t stream) {
  const int Dp = padded_width(D);
  const size_t smem = sizeof(float) * ((size_t)2 * KT * Dp + Dp + KT + 2);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  const int vec = (ptrs % 16 == 0) && (D % (16 / (int)sizeof(T)) == 0);
  flash_decode_kernel<T><<<bh, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, static_cast<T*>(out), T_len, D, Dp,
      scale, vec);
  return cudaGetLastError();
}

}  // namespace

// q: (bh, 1, D); k, v: (bh, T, D); out: like q; all contiguous. pos: one
// int32 on the device, the last valid key index (keys past it are masked).
// D from 1 to 256; T >= 1; scale is D^-0.5. dtype 0 is float32, 1 is
// bfloat16. Returns the launch error (0 on success).
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* pos, void* out,
                                   int bh, int t, int d, float scale,
                                   int dtype, void* stream) {
  if (bh <= 0 || t <= 0 || d <= 0 || d > kMaxD)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ps = static_cast<const int*>(pos);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, ps, out, bh, t, d, scale, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, ps, out, bh, t, d, scale, st);
  return (int)cudaErrorInvalidValue;
}

// The split-KV core's route: the same operands, D x itemsize a multiple of
// 16 up to 256, q, k and v 16-byte aligned; part_acc (bh, nch, D) and
// part_ml (bh, nch, 2), float32, are the merge's workspace, nch = ceil(t /
// 256), both may be null where nch is 1. Returns the launch error.
extern "C" int flash_decode_split_launch(const void* q, const void* k,
                                         const void* v, const void* pos,
                                         void* out, void* part_acc,
                                         void* part_ml, int bh, int t, int d,
                                         int nch, float scale, int dtype,
                                         void* stream) {
  if (bh <= 0 || t <= 0) return (int)cudaErrorInvalidValue;
  dsplit::Params P{};
  P.q = q;
  P.k = k;
  P.v = v;
  P.table = nullptr;       // row b's keys: rows b * t .. b * t + t - 1
  P.pos = static_cast<const int*>(pos);
  P.out = out;
  P.part_acc = static_cast<float*>(part_acc);
  P.part_ml = static_cast<float*>(part_ml);
  P.rows = bh;
  P.kh = 1;
  P.grp = 1;
  P.hd = d;
  P.nblk = 1;
  P.bs = t;
  P.window = 0;
  P.pos_stride = 0;        // one pos shared by every row
  P.nch = nch;
  P.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dsplit::run<float, 1>(P, st);
  if (dtype == 1) return (int)dsplit::run<__nv_bfloat16, 1>(P, st);
  return (int)cudaErrorInvalidValue;
}
