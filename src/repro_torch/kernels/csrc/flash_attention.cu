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
// 1e-30), as the Pallas body does. Masked keys score -1e30, keys at or
// past T get p = 0, and the ragged S and T edges are masked here: the
// caller pads nothing.
//
// Bound on an H100: a causal S = T = 4096 call at D 128 (llama2-7b's
// prefill, 32 heads) does 4 * D FLOPs for each of the S (S + 1) / 2 live
// (query, key) pairs a head, 1.37e11 FLOPs, against 134 MB of q, k, v and
// out in bf16: 0.139 ms at 989 TFLOP/s against 0.040 ms at 3.35 TB/s, so
// it is bound by operations, and only wgmma reaches that rate.
//
// Two routes, chosen by flash_attention.route(dtype, D) in the wrapper:
//
// * tensor cores (flash_attention_tc_launch): bfloat16 with D a multiple
//   of 16 up to 256 (every head width in configs/). D is padded with zeros
//   to DP = 64, 128 or 256. A block owns 128 q rows of one (bh) and has
//   three warpgroups: a producer, whose first thread loads Q once and K
//   and V tiles of BK keys by TMA (128-byte swizzle, zero fill past S, T
//   and D) into a two-slot ring each, guarded by full / empty mbarriers,
//   so loads run ahead of the arithmetic; and two consumers of 64 rows
//   each. In its turn j a consumer issues S(j) = Q K(j)^T, wgmma
//   m64nBKk16 with both operands K-major in shared memory, and O += P(j -
//   1) V(j - 1), wgmma m64nDPk16 with P from registers (the fp32 score
//   fragment, packed to bf16, is the register-A layout) and V read
//   MN-major; then runs tile j's online softmax on the fragment (a thread
//   owns two rows; max and sum reduce over a quad with shuffles; exp2 with
//   the scale folded into log2 e). The consumers' turns alternate through
//   named barriers, so one's softmax runs while the other's products hold
//   the tensor cores (ping-pong). BK is 128 at DP 64 and 128 (64 + 64 fp32
//   registers a thread for S and O at D 128), 64 at DP 256 (O alone is
//   128); setmaxnreg gives the consumers 232 registers and the producer
//   40. Shared memory: 160 KB at D 128, 192 KB at D 256. Only diagonal and
//   ragged tiles are masked, K/V tiles past the block's last row are not
//   loaded, and the heaviest q tiles launch first. At D 128 the 128 x 128
//   tiles do 1.40e11 FLOPs for the 1.37e11 the bound counts.
// * SIMT (flash_attention_launch): float32 at any D from 1 to 256, and
//   bfloat16 with D off the 16 grid. It runs on the fp32 FMA units (67
//   TFLOP/s, so 2.1 ms at best for the 1.40e11 FLOPs its 64 x 32 tiles do
//   at the shape above). The Pallas grid's sequential kv axis, which
//   carries (m, l, acc) in VMEM scratch, becomes a loop inside the block:
//   each block owns one (bh, 64-row q tile), and the heaviest causal tiles
//   are launched first. The block stages its Q tile once and each 32-key
//   K/V tile in turn into shared memory as fp32, with 16-byte loads where
//   rows allow them; a row is padded to Dp = 4 x an odd number of floats,
//   so the float4 reads of 8 neighbouring rows fall on distinct banks. 256
//   threads own a 4 x 2 patch of the 64 x 32 score tile (rows ty + 16 i,
//   keys tx + 16 j) and 4 rows x NJ columns of the accumulator, so the 16
//   threads of a row reduce its max and sum with shuffles. Under `causal`
//   every K/V tile wholly above the diagonal is skipped, as pl.when(run)
//   does (tile 0 always holds a live key of every row). Shared memory (77
//   KB at D 128, 142 KB at D 256) is requested past 48 KB.
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "convert.cuh"
#include "wgmma.cuh"

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

// ---- tensor-core route ----------------------------------------------------

namespace tc {

constexpr int kRows = 128;        // q rows a block owns, 64 a consumer
constexpr int kConsumers = 256;   // two consumer warpgroups
constexpr int kThreads = 384;     // and a producer warpgroup
constexpr int kStages = 2;        // the K and the V ring
constexpr int kProducerRegs = 40;   // 128 x 40 + 256 x 232 <= 65536
constexpr int kConsumerRegs = 232;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

template <int DP, int BK>
struct Smem {
  static constexpr int kQ = kRows * DP * 2;  // bytes of the Q tile
  static constexpr int kKV = BK * DP * 2;    // bytes of one K or V tile
  // mbarriers: Q full; K full, K empty, V full, V empty for each slot
  static constexpr int kBars = 8 * (1 + 4 * kStages);
  // + 1024 to align the tiles to the swizzle atom
  static constexpr int kBytes = kQ + 2 * kStages * kKV + kBars + 1024;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, one MUFU op
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One online-softmax step on tile k0's score fragment, in place: under
// kMask keys at or past T score -inf (p = 0) and, under `causal`, keys
// past the row -1e30, as the reference. m is in raw score units; s becomes
// p = 2^((s - m) sl2); l (this thread's share of the row sum) is rescaled
// and grows by p; each row's rescale factor goes to corr.
template <int BK, bool kMask>
__device__ __forceinline__ void softmax_step(float (&s)[BK / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             int k0, int row0, int T_len,
                                             int causal, float sl2) {
  const int col = 2 * (threadIdx.x & 3);
  if constexpr (kMask) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + 8 * j + col + e;
          float& x = s[4 * j + 2 * h + e];
          if (kpos >= T_len) x = -INFINITY;
          else if (causal && kpos > row0 + 8 * h) x = kNegInf;
        }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx);
    corr[h] = ex2((m[h] - m_new) * sl2);
    const float off = m_new * sl2;
    m[h] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * h + e];
        x = ex2(fmaf(x, sl2, -off));
        sum += x;
      }
    l[h] = l[h] * corr[h] + sum;
  }
}

// S = Q K^T for one warpgroup: DP / 16 steps of 16 columns, both operands
// K-major; qa is the warpgroup's 64 rows in the Q tile, ka a K slot
template <int DP, int BK>
__device__ __forceinline__ void qk_product(float (&s)[BK / 2], uint32_t qa,
                                           uint32_t ka) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk & 3) << 5;  // 16 columns, 32 bytes
    wg::wgmma_ss<BK>(
        s, wg::desc_sw128(qa + (kk >> 2) * (kRows * 128) + off, 16, 1024),
        wg::desc_sw128(ka + (kk >> 2) * (BK * 128) + off, 16, 1024), kk > 0);
  }
  wg::wgmma_commit();
}

// O += P V for one warpgroup: BK / 16 steps of 16 keys, P from registers,
// the V slot va read MN-major (64-column blocks BK * 128 bytes apart)
template <int DP, int BK>
__device__ __forceinline__ void pv_product(float (&o)[DP / 2],
                                           const uint32_t (&pa)[BK / 16][4],
                                           uint32_t va) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wg::wgmma_rs<DP>(o, pa[kk],
                     wg::desc_sw128(va + kk * (16 * 128), BK * 128, 1024));
  wg::wgmma_commit();
}

// A block owns 128 q rows of one (bh) and has three warpgroups. The
// producer's first thread loads Q once and K and V tiles of BK keys by TMA
// into a ring of two slots each, every slot with a `full` mbarrier (the
// TMA bytes landed) and an `empty` one (both consumers are done with it).
// Each consumer warpgroup owns 64 rows and walks the block's tiles: in its
// turn j it issues S(j) = Q K(j)^T and O += P(j - 1) V(j - 1), waits for
// both, frees the two slots, and runs tile j's softmax on the fragment.
// The turns of the two consumers alternate through two named barriers
// (ping-pong): one warpgroup's softmax runs while the other's products
// hold the tensor cores. setmaxnreg gives the consumers 232 registers a
// thread and the producer 40. Every branch around a wgmma depends on the
// block or on a warp-uniform value (the warpgroup index comes through a
// shuffle): under a branch ptxas may take for divergent it serialises the
// wgmmas (C7520). So both consumers run every tile of the block; a tile
// wholly above a warpgroup's rows (at BK 64 the last one of warpgroup 0)
// is masked to p = 0, and rows past S compute what they compute and are
// not stored.
template <int DP, int BK>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attn_tc(const __grid_constant__ CUtensorMap tmq,
                  const __grid_constant__ CUtensorMap tmk,
                  const __grid_constant__ CUtensorMap tmv,
                  bf16* __restrict__ out, int S, int T_len, int D, float sl2,
                  int causal) {
  using Sm = Smem<DP, BK>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (wg::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + Sm::kQ;               // K slots: sk + i kKV
  const uint32_t sv = sk + kStages * Sm::kKV;    // V slots: sv + i kKV
  const uint32_t bars = sv + kStages * Sm::kKV;
  const uint32_t q_full = bars;
  auto k_full = [&](int i) { return bars + 8 * (1 + i); };
  auto k_empty = [&](int i) { return bars + 8 * (1 + kStages + i); };
  auto v_full = [&](int i) { return bars + 8 * (1 + 2 * kStages + i); };
  auto v_empty = [&](int i) { return bars + 8 * (1 + 3 * kStages + i); };

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // heavy tiles first
  const int tid = threadIdx.x;
  const int n_kt = (T_len + BK - 1) / BK;
  int last = n_kt - 1;                           // the block's last K/V tile
  if (causal) last = min(last, (min(q0 + kRows, S) - 1) / BK);

  if (tid == 0) {
    wg::mbar_init(q_full, 1);
    for (int i = 0; i < kStages; ++i) {
      wg::mbar_init(k_full(i), 1);
      wg::mbar_init(v_full(i), 1);
      wg::mbar_init(k_empty(i), kConsumers);
      wg::mbar_init(v_empty(i), kConsumers);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  // the role, uniform in each warp as the compiler sees it
  const int grp = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (grp == 2) {  // producer
    wg::setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      wg::mbar_expect_tx(q_full, Sm::kQ);
#pragma unroll
      for (int cb = 0; cb < DP / 64; ++cb)
        wg::tma_load_3d(sq + cb * (kRows * 128), &tmq, q_full, cb * 64, q0,
                        bh);
      for (int t = 0; t <= last; ++t) {
        const int i = t % kStages;
        const uint32_t used = ((t / kStages) - 1) & 1;  // the slot's last use
        if (t >= kStages) wg::mbar_wait(k_empty(i), used);
        wg::mbar_expect_tx(k_full(i), Sm::kKV);
#pragma unroll
        for (int cb = 0; cb < DP / 64; ++cb)
          wg::tma_load_3d(sk + i * Sm::kKV + cb * (BK * 128), &tmk, k_full(i),
                          cb * 64, t * BK, bh);
        if (t >= kStages) wg::mbar_wait(v_empty(i), used);
        wg::mbar_expect_tx(v_full(i), Sm::kKV);
#pragma unroll
        for (int cb = 0; cb < DP / 64; ++cb)
          wg::tma_load_3d(sv + i * Sm::kKV + cb * (BK * 128), &tmv, v_full(i),
                          cb * 64, t * BK, bh);
      }
    }
    return;
  }

  // consumers
  wg::setmaxnreg_inc<kConsumerRegs>();
  const int lane = tid & 31;
  const int row0 = q0 + 16 * (tid >> 5) + (lane >> 2);  // and row0 + 8
  const uint32_t qa = sq + grp * (64 * 128);            // the warpgroup's Q
  // only diagonal and ragged tiles are masked: the first tile that needs
  // it is a ragged last one, or one that reaches past row q0
  int first_edge = T_len % BK ? n_kt - 1 : n_kt;
  if (causal) first_edge = min(first_edge, (q0 + 1) / BK);
  auto full_parity = [](int t) { return (uint32_t)((t / kStages) & 1); };

  // turns: warpgroup g waits on named barrier 1 + g, then lets the other
  // go; warpgroup 1 lets warpgroup 0 take the first turn
  auto turn_begin = [&]() { wg::bar_sync(1 + grp, kConsumers); };
  auto turn_end = [&]() { wg::bar_arrive(2 - grp, kConsumers); };
  if (grp == 1) turn_end();

  float o[DP / 2], s[BK / 2];
  uint32_t pa[BK / 16][4];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
  auto pack_p = [&]() {  // keys 16 kk .. 16 kk + 15 are A's 16 columns
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
  };

  // turn 0: S(0) alone
  wg::mbar_wait(q_full, 0);
  wg::mbar_wait(k_full(0), 0);
  turn_begin();
  wg::wgmma_fence();
  qk_product<DP, BK>(s, qa, sk);
  turn_end();
  wg::wgmma_wait<0>();
  wg::reg_fence(s);
  wg::mbar_arrive(k_empty(0));
  if (first_edge == 0)
    softmax_step<BK, true>(s, m, l, corr, 0, row0, T_len, causal, sl2);
  else
    softmax_step<BK, false>(s, m, l, corr, 0, row0, T_len, causal, sl2);
  pack_p();

  // turn j: S(j) and PV(j - 1), then tile j's softmax (masked if `masked`)
  auto turn = [&](int j, auto masked) {
    const int i = j % kStages, ip = (j - 1) % kStages;
    wg::mbar_wait(k_full(i), full_parity(j));
    wg::mbar_wait(v_full(ip), full_parity(j - 1));
    turn_begin();
    wg::reg_fence(o);
    wg::reg_fence(pa);
    wg::wgmma_fence();
    qk_product<DP, BK>(s, qa, sk + i * Sm::kKV);
    pv_product<DP, BK>(o, pa, sv + ip * Sm::kKV);
    turn_end();
    wg::wgmma_wait<0>();
    wg::reg_fence(s);
    wg::reg_fence(o);
    wg::mbar_arrive(k_empty(i));
    wg::mbar_arrive(v_empty(ip));
    softmax_step<BK, decltype(masked)::value>(s, m, l, corr, j * BK, row0,
                                               T_len, causal, sl2);
#pragma unroll
    for (int c = 0; c < DP / 8; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        o[4 * c + 2 * h] *= corr[h];
        o[4 * c + 2 * h + 1] *= corr[h];
      }
    pack_p();
  };
  // the tiles that need no mask first, so that no branch sits in the loop
  int j = 1;
  for (const int plain = min(last + 1, first_edge); j < plain; ++j)
    turn(j, std::false_type{});
  for (; j <= last; ++j) turn(j, std::true_type{});

  // the last turn: PV(last) alone; warpgroup 0 hands warpgroup 1 its turn
  wg::mbar_wait(v_full(last % kStages), full_parity(last));
  turn_begin();
  wg::reg_fence(o);
  wg::reg_fence(pa);
  wg::wgmma_fence();
  pv_product<DP, BK>(o, pa, sv + (last % kStages) * Sm::kKV);
  if (grp == 0) turn_end();
  wg::wgmma_wait<0>();
  wg::reg_fence(o);

  const int col = 2 * (lane & 3);                // in each 8-column block
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float lf = fmaxf(lt, 1e-30f);
    const int row = row0 + 8 * h;
    if (row >= S) continue;
    bf16* orow = out + ((size_t)bh * S + row) * D;
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) {
      const int cc = 8 * c + col;
      if (cc < D)
        *reinterpret_cast<uint32_t*>(orow + cc) =
            pack_bf16(o[4 * c + 2 * h] / lf, o[4 * c + 2 * h + 1] / lf);
    }
  }
}

template <int DP, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int bh, int S, int T_len, int D, float scale, int causal,
                   cudaStream_t stream) {
  constexpr int smem = Smem<DP, BK>::kBytes;
  static_assert(smem <= kMaxSmem, "the tiles fit an H100 block");
  CUtensorMap tmq, tmk, tmv;
  if (!wg::tensor_map(&tmq, q, bh, S, D, kRows) ||
      !wg::tensor_map(&tmk, k, bh, T_len, D, BK) ||
      !wg::tensor_map(&tmv, v, bh, T_len, D, BK))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attn_tc<DP, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (S + kRows - 1) / kRows);
  flash_attn_tc<DP, BK><<<grid, kThreads, smem, stream>>>(
      tmq, tmk, tmv, static_cast<bf16*>(out), S, T_len, D, scale * kLog2e,
      causal);
  return cudaGetLastError();
}

}  // namespace tc

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

// The tensor-core route: q, k, v, out bfloat16, contiguous and 16-byte
// aligned; D a multiple of 16 from 16 to 256; S, T >= 1. Same arguments
// as flash_attention_launch otherwise. Returns the launch error.
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, void* out, int bh,
                                         int s, int t, int d, float scale,
                                         int causal, void* stream) {
  const uintptr_t ptrs =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  if (bh <= 0 || s <= 0 || t <= 0 || d < 16 || d > 256 || d % 16 != 0 ||
      ptrs % 16 != 0 || (s + tc::kRows - 1) / tc::kRows > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return (int)tc::launch<64, 128>(q, k, v, out, bh, s, t, d, scale, causal,
                                    st);
  if (d <= 128)
    return (int)tc::launch<128, 128>(q, k, v, out, bh, s, t, d, scale,
                                     causal, st);
  return (int)tc::launch<256, 64>(q, k, v, out, bh, s, t, d, scale, causal,
                                  st);
}
