// flash_attention on Hopper: replaces the Pallas kernel
// repro/kernels/flash_attention.py (flash_attention), softmax attention of
// q (BH, S, D) against k, v (BH, T, D) with an online softmax
//
//     out[b, i] = sum_j softmax_j(q[b, i] . k[b, j] * D^-0.5) v[b, j]
//
// over the keys j < T, and under `causal` only j <= i (the top-left mask
// of ref.flash_attention_ref, not the bottom-right one). Scores, the
// running max m, the running sum l and the accumulator are fp32; p is
// rounded to the input type before the PV product, and out = acc / max(l,
// 1e-30), as the Pallas body does.
//
// Bound on an H100: a causal S = T = 4096 call at D 128 (llama2-7b's
// prefill, 32 heads) does 4 * D FLOPs for each of the S (S + 1) / 2 live
// (query, key) pairs a head, 1.37e11 FLOPs, against 134 MB of q, k, v and
// out in bf16: 0.139 ms at 989 TFLOP/s against 0.040 ms at 3.35 TB/s, so
// it is bound by operations. This first version runs on the fp32 FMA
// units, not the tensor cores (67 TFLOP/s, so 2 ms at best there).
//
// Design. The Pallas grid's sequential kv axis, which carries (m, l, acc)
// in VMEM scratch from one step to the next, becomes a loop inside the
// block: each block owns one (bh, 64-row q tile), blocks run in parallel
// with no carry between them, and the heaviest causal tiles are launched
// first. The block stages its Q tile once and each 32-key K/V tile in
// turn into shared memory as fp32, with 16-byte loads where rows allow
// them; a row is padded to Dp = 4 x an odd number of floats, so the
// float4 reads of 8 neighbouring rows fall on distinct banks. 256 threads
// own a 4 x 2 patch of the 64 x 32 score tile (rows ty + 16 i, keys tx +
// 16 j) and 4 rows x NJ columns of the accumulator (columns tx + 16 j, in
// registers), so the 16 threads of a row reduce its max and sum with
// shuffles and rescale their own accumulator columns. Under `causal`
// every K/V tile wholly above the diagonal is skipped, as pl.when(run)
// does; the ragged S and T edges are masked here, nothing is padded by
// the caller. Keys past T get p = 0; masked keys get the score -1e30, as
// in the reference (tile 0 always holds a live key of every row). The
// tile width is sized from D, and the shared memory (77 KB at D 128, 142
// KB at D 256) is requested with cudaFuncSetAttribute past 48 KB.
// Tensor-core (wgmma) tiles and TMA pipelining are later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "convert.cuh"

namespace {

constexpr int BQ = 64;            // query rows a block owns
constexpr int BK = 32;            // keys a K/V tile holds
constexpr int BKP = BK + 4;       // row of the p tile, 16-byte aligned
constexpr int kThreads = 256;     // 16 column x 16 row threads
constexpr int kMaxSmem = 232448;  // an H100 block's dynamic shared memory
constexpr float kNegInf = -1e30f;

using cvt::from_f;
using cvt::to_f;

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// rows x D elements of a row-major (., D) tensor into fp32 shared rows of
// Dp floats; rows at or past `valid` become zeros. Columns D..Dp-1 are
// never written here (the kernel zeroes them once).
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src,
                                           float* dst, int rows, int valid,
                                           int D, int Dp, bool vec) {
  if (vec) {
    constexpr int kVec = 16 / (int)sizeof(T);
    const int nvec = D / kVec;
    for (int i = threadIdx.x; i < rows * nvec; i += blockDim.x) {
      const int r = i / nvec, c = (i - r * nvec) * kVec;
      float* o = dst + r * Dp + c;
      if (r < valid) {
        const uint4 raw =
            __ldg(reinterpret_cast<const uint4*>(src + (size_t)r * D + c));
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int k = 0; k < kVec; ++k) o[k] = to_f(e[k]);
      } else {
#pragma unroll
        for (int k = 0; k < kVec; ++k) o[k] = 0.f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
      const int r = i / D, c = i - r * D;
      dst[r * Dp + c] = r < valid ? to_f(src[(size_t)r * D + c]) : 0.f;
    }
  }
}

// NJ accumulator columns a thread owns: D <= 16 * NJ
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
    flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out, int S,
                      int T_len, int D, int Dp, float scale, int causal,
                      int vec) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // (BQ, Dp)
  float* ks = qs + BQ * Dp;                      // (BK, Dp)
  float* vs = ks + BK * Dp;                      // (BK, Dp)
  float* ps = vs + BK * Dp;                      // (BQ, BKP) rounded p

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heavy tiles first
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int d4n = (D + 3) / 4;                   // float4s a row's dot reads

  // zero the padding columns of the Q, K and V rows once
  const int padc = Dp - D;
  for (int i = tid; i < (BQ + 2 * BK) * padc; i += kThreads)
    qs[(i / padc) * Dp + D + i % padc] = 0.f;
  stage_rows(q + ((size_t)bh * S + q0) * D, qs, BQ, min(BQ, S - q0), D, Dp,
             vec != 0);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int n_kt = (T_len + BK - 1) / BK;
  int last_kt = n_kt - 1;
  if (causal) last_kt = min(last_kt, (min(q0 + BQ, S) - 1) / BK);
  const float4* q4 = reinterpret_cast<const float4*>(qs);
  const float4* k4 = reinterpret_cast<const float4*>(ks);
  const float4* p4 = reinterpret_cast<const float4*>(ps);
  const int dp4 = Dp / 4;

  for (int kt = 0; kt <= last_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K, V and p are consumed
    const int kvalid = min(BK, T_len - k0);
    stage_rows(k + ((size_t)bh * T_len + k0) * D, ks, BK, kvalid, D, Dp,
               vec != 0);
    stage_rows(v + ((size_t)bh * T_len + k0) * D, vs, BK, kvalid, D, Dp,
               vec != 0);
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
    for (int d4 = 0; d4 < d4n; ++d4) {
      float4 a[4], b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = q4[(ty + 16 * i) * dp4 + d4];
#pragma unroll
      for (int j = 0; j < 2; ++j) b[j] = k4[(tx + 16 * j) * dp4 + d4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float t = s[i][j];
          t = fmaf(a[i].x, b[j].x, t);
          t = fmaf(a[i].y, b[j].y, t);
          t = fmaf(a[i].z, b[j].z, t);
          t = fmaf(a[i].w, b[j].w, t);
          s[i][j] = t;
        }
    }

    // online softmax per row; a row's 16 threads share one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float sv[2];
      bool ex[2];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ex[j] = kpos < T_len;
        const bool live = ex[j] && (!causal || kpos <= qpos);
        sv[j] = live ? s[i][j] * scale : kNegInf;
        if (ex[j]) mx = fmaxf(mx, sv[j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = ex[j] ? expf(sv[j] - m_new) : 0.f;
        psum += p;
        ps[(ty + 16 * i) * BKP + tx + 16 * j] = to_f(from_f<T>(p));
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    // acc += p V over this tile's keys
#pragma unroll 2
    for (int r4 = 0; r4 < BK / 4; ++r4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = p4[(ty + 16 * i) * (BKP / 4) + r4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const float* vrow = vs + (4 * r4 + rr) * Dp;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = tx + 16 * j;
          const float vv = c < D ? vrow[c] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[i][j] = fmaf(comp(pa[i], rr), vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float lf = fmaxf(l[i], 1e-30f);
    T* orow = out + ((size_t)bh * S + row) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D) orow[c] = from_f<T>(acc[i][j] / lf);
    }
  }
}

// a row of Dp = 4 x odd floats: float4 reads of 8 consecutive rows at one
// column fall on distinct banks
int padded_width(int D) {
  int m = (D + 3) / 4 + 1;
  if (m % 2 == 0) ++m;
  return 4 * m;
}

size_t smem_bytes(int Dp) {
  return sizeof(float) * ((size_t)BQ * Dp + 2 * (size_t)BK * Dp + BQ * BKP);
}

template <typename T, int NJ>
cudaError_t launch_nj(const void* q, const void* k, const void* v, void* out,
                      int bh, int S, int T_len, int D, float scale,
                      int causal, int vec, cudaStream_t stream) {
  const int Dp = padded_width(D);
  const size_t smem = smem_bytes(Dp);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attn_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(bh, (S + BQ - 1) / BQ);
  flash_attn_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, T_len, D, Dp, scale,
      causal, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int bh, int S, int T_len, int D, float scale, int causal,
                   cudaStream_t stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  const int vec = (ptrs % 16 == 0) && (D % (16 / (int)sizeof(T)) == 0);
  if (D <= 16)
    return launch_nj<T, 1>(q, k, v, out, bh, S, T_len, D, scale, causal, vec,
                           stream);
  if (D <= 32)
    return launch_nj<T, 2>(q, k, v, out, bh, S, T_len, D, scale, causal, vec,
                           stream);
  if (D <= 64)
    return launch_nj<T, 4>(q, k, v, out, bh, S, T_len, D, scale, causal, vec,
                           stream);
  if (D <= 128)
    return launch_nj<T, 8>(q, k, v, out, bh, S, T_len, D, scale, causal, vec,
                           stream);
  return launch_nj<T, 16>(q, k, v, out, bh, S, T_len, D, scale, causal, vec,
                          stream);
}

}  // namespace

// q: (bh, S, D); k, v: (bh, T, D); out: like q; all contiguous. D from 1
// to 256; S, T >= 1; scale is D^-0.5; causal 1 masks keys past the
// query's index. dtype 0 is float32, 1 is bfloat16. Returns the launch
// error (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int bh, int s,
                                      int t, int d, float scale, int causal,
                                      int dtype, void* stream) {
  if (bh <= 0 || s <= 0 || t <= 0 || d <= 0 || d > 256 ||
      (s + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, out, bh, s, t, d, scale, causal, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, out, bh, s, t, d, scale,
                                      causal, st);
  return (int)cudaErrorInvalidValue;
}
