// paged_attn_decode on Hopper: replaces the Pallas kernel
// repro/kernels/paged_attention.py (paged_attn_decode), GQA single-query
// attention straight off the serving engine's block pool.
//
// Each row b is one query token at logical position pos[b] of its lane;
// table[b, j] names the physical block that holds the lane's logical block
// j. For kv head h, the grp query heads h*grp .. h*grp+grp-1 are scored
// against every live key (logical position p <= pos[b], and p > pos[b] -
// window when window > 0) with an online softmax in fp32: p is rounded to
// the input type before the PV product, and out = acc / max(l, 1e-30), as
// the Pallas body does.
//
// Bound on an H100: one row reads its lane's live K and V rows once
// (2 * depth * hd * sizeof(T) per kv head) beside q and out, against
// 4 * grp * hd FLOPs per key, so it is bound by bytes. This first version
// is simple: one block per (row, kv head), 128 threads, walking the live
// keys in tiles of KT logical positions; each tile's K and V rows are read
// with 16-byte vector loads into shared memory (fp32), scored one thread
// per (query head, key) pair, and accumulated one thread per (query head,
// channel) pair. Only the live tiles are visited: from the first tile the
// window reaches up to pos[b] / KT, so no table entry past a row's depth is
// read. (The Pallas kernel walks all blocks and masks them; a wholly masked
// leading block cancels there through corr = exp(-1e30 - m) = 0, so
// skipping it gives the same result.) Splitting a long context over
// several blocks, and TMA / mbarrier pipelining, are later work.
//
// The tile is KT logical positions whatever the pool's block size, so a
// row's arithmetic depends only on its query, its keys and pos: a lane
// read through a paged table and the same lane read from a contiguous
// cache (a pool of one block per lane) give bitwise the same output.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int KT = 16;          // logical key positions per tile
constexpr int kThreads = 128;
constexpr int kMaxPerThread = 16;  // grp * hd <= kThreads * kMaxPerThread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// one 16-byte vector of T, widened to fp32 into dst
template <typename T>
__device__ __forceinline__ void load_vec(const T* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) dst[i] = to_f(e[i]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                      const T* __restrict__ v_pool,
                      const int* __restrict__ table,
                      const int* __restrict__ pos, T* __restrict__ out,
                      int kh, int grp, int hd, int nblk, int bs, int window,
                      float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                  // (grp, hd)
  float* ks = qs + grp * hd;         // (KT, hd)
  float* vs = ks + KT * hd;          // (KT, hd)
  float* ss = vs + KT * hd;          // (grp, KT) scores, then rounded p
  float* m_s = ss + grp * KT;        // (grp,) running max
  float* l_s = m_s + grp;            // (grp,) running sum
  float* c_s = l_s + grp;            // (grp,) this tile's correction

  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int heads = kh * grp;
  const size_t q_off = ((size_t)b * heads + (size_t)h * grp) * hd;
  for (int i = tid; i < grp * hd; i += kThreads) qs[i] = to_f(q[q_off + i]);
  for (int g = tid; g < grp; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  const int n_own = (grp * hd + kThreads - 1) / kThreads;
  float acc[kMaxPerThread];
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) acc[k] = 0.f;

  const int p_pos = pos[b];
  const int p_last = min(p_pos, nblk * bs - 1);
  int t_first = 0;
  if (window > 0 && p_pos - window + 1 > 0) t_first = (p_pos - window + 1) / KT;
  const int t_last = p_last >= 0 ? p_last / KT : -1;
  const int* row_table = table + (size_t)b * nblk;
  constexpr int kVec = 16 / (int)sizeof(T);
  const int nvec = hd / kVec;
  __syncthreads();

  for (int t = t_first; t <= t_last; ++t) {
    // K and V rows of this tile's live positions, zeros past p_last
    for (int i = tid; i < KT * nvec; i += kThreads) {
      const int r = i / nvec, c = (i % nvec) * kVec;
      const int p = t * KT + r;
      if (p <= p_last) {
        const int blk = row_table[p / bs];
        const size_t off =
            (((size_t)blk * bs + (p % bs)) * kh + h) * hd + c;
        load_vec(k_pool + off, ks + r * hd + c);
        load_vec(v_pool + off, vs + r * hd + c);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          ks[r * hd + c + e] = vs[r * hd + c + e] = 0.f;
      }
    }
    __syncthreads();
    for (int i = tid; i < grp * KT; i += kThreads) {
      const int g = i / KT, r = i % KT;
      const int p = t * KT + r;
      const bool live = p <= p_last && (window <= 0 || p > p_pos - window);
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qs[g * hd + d], ks[r * hd + d], s);
      ss[i] = live ? s * scale : kNegInf;
    }
    __syncthreads();
    for (int g = tid; g < grp; g += kThreads) {
      const float m_prev = m_s[g];
      float m_new = m_prev;
      for (int r = 0; r < KT; ++r) m_new = fmaxf(m_new, ss[g * KT + r]);
      float lsum = 0.f;
      for (int r = 0; r < KT; ++r) {
        const float pr = expf(ss[g * KT + r] - m_new);
        lsum += pr;
        ss[g * KT + r] = to_f(from_f<T>(pr));   // p in v's type for PV
      }
      const float corr = expf(m_prev - m_new);
      l_s[g] = l_s[g] * corr + lsum;
      m_s[g] = m_new;
      c_s[g] = corr;
    }
    __syncthreads();
    // unrolled over the fixed bound so acc stays in registers
#pragma unroll
    for (int k = 0; k < kMaxPerThread; ++k) {
      const int e = tid + k * kThreads;
      if (k < n_own && e < grp * hd) {
        const int g = e / hd, d = e % hd;
        float pv = 0.f;
        for (int r = 0; r < KT; ++r)
          pv = fmaf(ss[g * KT + r], vs[r * hd + d], pv);
        acc[k] = acc[k] * c_s[g] + pv;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) {
    const int e = tid + k * kThreads;
    if (k < n_own && e < grp * hd) {
      const int g = e / hd;
      out[q_off + e] = from_f<T>(acc[k] / fmaxf(l_s[g], 1e-30f));
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* table, const int* pos, void* out, int rows,
                   int kh, int grp, int hd, int nblk, int bs, int window,
                   float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)grp * hd + 2 * KT * hd + grp * KT + 3 * grp);
  dim3 grid(rows, kh);
  paged_attn_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), table, pos, static_cast<T*>(out), kh,
      grp, hd, nblk, bs, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q: (rows, kh * grp, hd); k_pool / v_pool: (nblocks, bs, kh, hd);
// table: (rows, nblk) int32; pos: (rows,) int32; out: like q. dtype 0 is
// float32, 1 is bfloat16. Returns the launch error (0 on success).
extern "C" int paged_attn_decode_launch(const void* q, const void* k_pool,
                                        const void* v_pool, const void* table,
                                        const void* pos, void* out, int rows,
                                        int kh, int grp, int hd, int nblk,
                                        int bs, int window, float scale,
                                        int dtype, void* stream) {
  if (rows <= 0) return 0;
  if (hd % 8 != 0 || grp * hd > kThreads * kMaxPerThread || hd > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  const int* ps = static_cast<const int*>(pos);
  if (dtype == 0)
    return (int)launch<float>(q, k_pool, v_pool, tb, ps, out, rows, kh, grp,
                              hd, nblk, bs, window, scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k_pool, v_pool, tb, ps, out, rows,
                                      kh, grp, hd, nblk, bs, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
