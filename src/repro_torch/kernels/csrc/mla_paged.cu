// mla_paged_decode on Hopper: replaces the Pallas kernel
// repro/kernels/paged_attention.py (mla_paged_decode), deepseek-v2's
// multi-head latent attention in its absorbed form, straight off the
// serving engine's latent block pools.
//
// Row b is one query token at logical position pos[b] of its lane; table[b,
// j] names the physical block that holds the lane's logical block j. For
// each head h the kernel computes
//
//     s_t   = (q_abs[b, h] . cc_t + q_pe[b, h] . cp_t) * scale,  t <= pos[b]
//     o_lat = sum_t softmax(s)_t * cc_t                        (r channels)
//
// with an online softmax in fp32: p is rounded to the input type before the
// latent-value product, and o_lat = acc / max(l, 1e-30), as the Pallas body
// does. The caller expands o_lat through W_uv.
//
// Bound on an H100: a row reads its lane's live latent and rope-key rows
// once ((r + dr) * depth * sizeof(T)) beside q and out, against
// 4 * H * (r + dr/2) FLOPs per key. At the engine's decode depth that is
// bytes; at long contexts and H = 128 the FLOPs catch up with the bytes on
// bf16 tensor cores, and a SIMT fp32 kernel such as this one is far above
// both (PERF.md states the numbers).
//
// Two routes (paged_attention.mla_route): bfloat16 at deepseek-v2's widths
// (r 512, dr 64) runs the tensor-core kernel of csrc/mla_tc.cuh, behind
// mla_paged_decode_tc_launch; float32, and bfloat16 at any other width,
// the SIMT kernel below, behind mla_paged_decode_launch.
//
// Design of the SIMT kernel (fp32 arithmetic): one block per (row, group
// of G heads), 256 threads, walking the live keys in tiles of KT logical
// positions. Each tile's latent (KT x r) and rope-key (KT x dr) rows are
// copied once into shared memory in their own type by cp.async, 16 bytes
// a thread, double-buffered: tile t + 1 is in flight while tile t is
// scored, and one tile serves all G heads. Scores: warp w takes keys 2w and
// 2w + 1 for all G heads, each lane a stride of the channels, so every
// latent value read from shared memory feeds G FMAs; the lanes' 16 partial
// sums are folded in 16 shuffles (each level keeps half of the values).
// Softmax: one warp per head, a lane per key. The latent-value product:
// each thread owns NC channels of every head, so every latent value read
// feeds G FMAs again. The accumulator o_lat (G x r floats) lives in
// registers, indexed by compile-time trip counts (NC is a template
// argument). Only the live tiles are visited, from 0 to pos[b] / KT: the
// Pallas grid walks every block and masks it, and a wholly masked block
// adds exactly zero there. A row with pos[b] < 0 has every key masked, and
// the reference's softmax is then the uniform average of the view's latent
// rows: the kernel counts every view key at the score -1e30 there.
//
// The tile is KT logical positions whatever the pool's block size, and a
// head's sums never depend on the group it shares a block with, so a
// row's arithmetic depends only on its query, its keys and pos: a lane
// read through a paged table and the same lane read from a contiguous
// cache (a pool of one block per lane) give bitwise the same output,
// whatever the number of rows in the call.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "mla_tc.cuh"

namespace {

constexpr int KT = 16;               // logical key positions per tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKeysPerWarp = KT / kWarps;
constexpr int kAccPerThread = 16;    // G * NC accumulators per thread
constexpr int kMaxGroup = 8;         // heads per block
constexpr int kMaxRank = 1024;       // NC = r / kThreads <= 4
constexpr int kTargetBlocks = 256;   // split heads finer below this
constexpr float kNegInf = -1e30f;
static_assert(KT == kWarps * kKeysPerWarp, "a warp scores whole keys");
static_assert(kMaxGroup * kKeysPerWarp == 16, "the fold takes 16 sums");
static_assert(KT <= 32, "the softmax takes a lane per key");

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

// 16 bytes global -> shared, asynchronous; zero-filled when !valid (then
// nothing is read from src)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one level of a warp fold of 2 * HALF values: a lane keeps half of them
// (the upper half when bit 2 * HALF of its lane id is set) and adds its
// partner's copy of that half
template <int HALF>
__device__ __forceinline__ void fold_level(float* v, int lane) {
  const bool up = (lane & (2 * HALF)) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float keep = up ? v[i + HALF] : v[i];
    const float give = up ? v[i] : v[i + HALF];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, give, 2 * HALF);
  }
}

// start the copies of tile t's live latent and rope-key rows into (cs, ps);
// rows past p_last are zero-filled
template <typename T>
__device__ __forceinline__ void copy_tile(
    T* cs, T* ps, const T* __restrict__ cc_pool,
    const T* __restrict__ cp_pool, const int* __restrict__ row_table, int t,
    int p_last, int r, int dr, int bs, int tid) {
  constexpr int kVec = 16 / (int)sizeof(T);
  const int nvr = r / kVec, nv = nvr + dr / kVec;
  for (int i = tid; i < KT * nv; i += kThreads) {
    const int row = i / nv, v = i % nv;
    const bool lat = v < nvr;
    const int c = (lat ? v : v - nvr) * kVec;
    const int p = t * KT + row;
    const bool live = p <= p_last;
    const T* src = cc_pool;
    if (live) {
      const size_t prow = (size_t)row_table[p / bs] * bs + (p % bs);
      src = lat ? cc_pool + prow * r + c : cp_pool + prow * dr + c;
    }
    cp_async16(lat ? cs + row * r + c : ps + row * dr + c, src, live);
  }
}

// NC: channels of each head a thread owns in the latent-value product
// (r <= NC * kThreads); a block takes grp <= G_MAX heads
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
    mla_kernel(const T* __restrict__ q_abs, const T* __restrict__ q_pe,
               const T* __restrict__ cc_pool, const T* __restrict__ cp_pool,
               const int* __restrict__ table, const int* __restrict__ pos,
               T* __restrict__ out, int heads, int grp, int r, int dr,
               int nblk, int bs, float scale) {
  constexpr int G_MAX = kAccPerThread / NC < kMaxGroup ?
                        kAccPerThread / NC : kMaxGroup;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tile_elems = KT * (r + dr);
  T* tiles = reinterpret_cast<T*>(smem_raw);   // 2 x ((KT, r), (KT, dr))
  float* qa = reinterpret_cast<float*>(tiles + 2 * tile_elems);  // (grp, r)
  float* qp = qa + grp * r;          // (grp, dr) rope queries
  float* ss = qp + grp * dr;         // (KT, grp) scores, then rounded p
  float* m_s = ss + KT * grp;        // (grp,) running max
  float* l_s = m_s + grp;            // (grp,) running sum
  float* c_s = l_s + grp;            // (grp,) this tile's correction

  const int b = blockIdx.x, h0 = blockIdx.y * grp, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // the counted keys: those <= pos[b] in the view; where pos[b] < 0, every
  // view key, scored -1e30 (a uniform average, as the reference's softmax
  // over a fully masked row)
  const int p_pos = pos[b];
  const int p_last = p_pos < 0 ? nblk * bs - 1 : min(p_pos, nblk * bs - 1);
  const int t_last = p_last / KT;
  const int* row_table = table + (size_t)b * nblk;
  {
    copy_tile(tiles, tiles + KT * r, cc_pool, cp_pool, row_table, 0, p_last,
               r, dr, bs, tid);
    cp_async_commit();
  }
  const size_t qa_off = ((size_t)b * heads + h0) * r;
  const size_t qp_off = ((size_t)b * heads + h0) * dr;
  for (int i = tid; i < grp * r; i += kThreads)
    qa[i] = to_f(q_abs[qa_off + i]);
  for (int i = tid; i < grp * dr; i += kThreads)
    qp[i] = to_f(q_pe[qp_off + i]);
  for (int g = tid; g < grp; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  float acc[G_MAX][NC];
#pragma unroll
  for (int g = 0; g < G_MAX; ++g)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[g][j] = 0.f;

  for (int t = 0; t <= t_last; ++t) {
    const T* cs = tiles + (t & 1) * tile_elems;
    const T* ps = cs + KT * r;
    if (t < t_last) {
      T* nxt = tiles + ((t + 1) & 1) * tile_elems;
      copy_tile(nxt, nxt + KT * r, cc_pool, cp_pool, row_table, t + 1,
                 p_last, r, dr, bs, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    {
      // scores: this warp's keys for every head of the group
      const int k0 = warp * kKeysPerWarp;
      float sc[kMaxGroup * kKeysPerWarp];
#pragma unroll
      for (int i = 0; i < kMaxGroup * kKeysPerWarp; ++i) sc[i] = 0.f;
      for (int c = lane; c < r; c += 32) {
        float cv[kKeysPerWarp];
#pragma unroll
        for (int j = 0; j < kKeysPerWarp; ++j)
          cv[j] = to_f(cs[(k0 + j) * r + c]);
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          if (g < grp) {
            const float q = qa[g * r + c];
#pragma unroll
            for (int j = 0; j < kKeysPerWarp; ++j)
              sc[g * kKeysPerWarp + j] =
                  fmaf(q, cv[j], sc[g * kKeysPerWarp + j]);
          }
        }
      }
      for (int c = lane; c < dr; c += 32) {
        float cv[kKeysPerWarp];
#pragma unroll
        for (int j = 0; j < kKeysPerWarp; ++j)
          cv[j] = to_f(ps[(k0 + j) * dr + c]);
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          if (g < grp) {
            const float q = qp[g * dr + c];
#pragma unroll
            for (int j = 0; j < kKeysPerWarp; ++j)
              sc[g * kKeysPerWarp + j] =
                  fmaf(q, cv[j], sc[g * kKeysPerWarp + j]);
          }
        }
      }
      // fold the 16 per-lane sums over the 32 lanes: lanes 2i and 2i + 1
      // end with the total of value i
      fold_level<8>(sc, lane);
      fold_level<4>(sc, lane);
      fold_level<2>(sc, lane);
      fold_level<1>(sc, lane);
      sc[0] += __shfl_xor_sync(0xffffffffu, sc[0], 1);
      const int idx = lane >> 1;
      const int g = idx / kKeysPerWarp, key = k0 + idx % kKeysPerWarp;
      if ((lane & 1) == 0 && g < grp)
        ss[key * grp + g] = t * KT + key > p_last ? -INFINITY
                            : p_pos < 0 ? kNegInf : sc[0] * scale;
    }
    __syncthreads();
    if (warp < grp) {
      // online softmax of head `warp`, a lane per key
      const int g = warp;
      const float v = lane < KT ? ss[lane * grp + g] : kNegInf;
      float mx = v;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float p = lane < KT ? expf(v - m_new) : 0.f;
      float lsum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
      if (lane < KT) ss[lane * grp + g] = to_f(from_f<T>(p));  // p as T
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[g] = l_s[g] * corr + lsum;
        m_s[g] = m_new;
        c_s[g] = corr;
      }
    }
    __syncthreads();
    // latent-value product: channels tid + j * kThreads of every head
#pragma unroll
    for (int g = 0; g < G_MAX; ++g)
      if (g < grp)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[g][j] *= c_s[g];
#pragma unroll
    for (int row = 0; row < KT; ++row) {
      float cv[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = tid + j * kThreads;
        cv[j] = c < r ? to_f(cs[row * r + c]) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < G_MAX; ++g) {
        if (g < grp) {
          const float pr = ss[row * grp + g];
#pragma unroll
          for (int j = 0; j < NC; ++j) acc[g][j] = fmaf(pr, cv[j], acc[g][j]);
        }
      }
    }
    __syncthreads();
  }

  __syncthreads();            // l_s is final (also when no tile was live)
#pragma unroll
  for (int g = 0; g < G_MAX; ++g) {
    if (g < grp) {
      const float l = fmaxf(l_s[g], 1e-30f);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = tid + j * kThreads;
        if (c < r) out[qa_off + (size_t)g * r + c] = from_f<T>(acc[g][j] / l);
      }
    }
  }
}

template <typename T, int NC>
cudaError_t launch_nc(const void* q_abs, const void* q_pe,
                      const void* cc_pool, const void* cp_pool,
                      const int* table, const int* pos, void* out, int rows,
                      int heads, int r, int dr, int nblk, int bs,
                      float scale, cudaStream_t stream) {
  // heads per block: the largest power of two up to G_MAX that divides
  // the head count, halved while the grid is small (the arithmetic of a
  // head does not depend on its group)
  constexpr int G_MAX = kAccPerThread / NC < kMaxGroup ?
                        kAccPerThread / NC : kMaxGroup;
  int grp = G_MAX;
  while (grp > 1 && heads % grp != 0) grp /= 2;
  while (grp > 1 && (long)rows * (heads / grp) < kTargetBlocks) grp /= 2;
  const size_t smem = 2 * sizeof(T) * KT * (size_t)(r + dr) +
                      sizeof(float) * ((size_t)grp * (r + dr) + KT * grp +
                                       3 * grp);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mla_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(rows, heads / grp);
  mla_kernel<T, NC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q_abs), static_cast<const T*>(q_pe),
      static_cast<const T*>(cc_pool), static_cast<const T*>(cp_pool), table,
      pos, static_cast<T*>(out), heads, grp, r, dr, nblk, bs, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q_abs, const void* q_pe, const void* cc_pool,
                   const void* cp_pool, const int* table, const int* pos,
                   void* out, int rows, int heads, int r, int dr, int nblk,
                   int bs, float scale, cudaStream_t stream) {
  if (r <= kThreads)
    return launch_nc<T, 1>(q_abs, q_pe, cc_pool, cp_pool, table, pos, out,
                           rows, heads, r, dr, nblk, bs, scale, stream);
  if (r <= 2 * kThreads)
    return launch_nc<T, 2>(q_abs, q_pe, cc_pool, cp_pool, table, pos, out,
                           rows, heads, r, dr, nblk, bs, scale, stream);
  return launch_nc<T, 4>(q_abs, q_pe, cc_pool, cp_pool, table, pos, out,
                         rows, heads, r, dr, nblk, bs, scale, stream);
}

}  // namespace

// q_abs: (rows, heads, r); q_pe: (rows, heads, dr); cc_pool: (nblocks, bs,
// r); cp_pool: (nblocks, bs, dr); table: (rows, nblk) int32; pos: (rows,)
// int32; out: like q_abs. dtype 0 is float32, 1 is bfloat16. r and dr must
// be multiples of 8 (16-byte rows in bf16) and at most kMaxRank. Returns the
// launch error (0 on success).
extern "C" int mla_paged_decode_launch(const void* q_abs, const void* q_pe,
                                       const void* cc_pool,
                                       const void* cp_pool, const void* table,
                                       const void* pos, void* out, int rows,
                                       int heads, int r, int dr, int nblk,
                                       int bs, float scale, int dtype,
                                       void* stream) {
  if (rows <= 0) return 0;
  if (r % 8 != 0 || dr % 8 != 0 || r <= 0 || r > kMaxRank || dr < 0 ||
      dr > kMaxRank || heads <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  const int* ps = static_cast<const int*>(pos);
  if (dtype == 0)
    return (int)launch<float>(q_abs, q_pe, cc_pool, cp_pool, tb, ps, out,
                              rows, heads, r, dr, nblk, bs, scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q_abs, q_pe, cc_pool, cp_pool, tb, ps,
                                      out, rows, heads, r, dr, nblk, bs,
                                      scale, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core route (csrc/mla_tc.cuh): bfloat16 operands, r 512, dr 64,
// q_abs, q_pe, the pools and part_acc 16-byte aligned. part_acc (rows,
// heads, nch, r) and part_ml (rows, heads, nch, 2), float32, are the
// merge's workspace, nch = ceil(nblk * bs / mla_tc::kChunk); both may be
// null where nch is 1. Other arguments as mla_paged_decode_launch's.
// Returns the launch error (0 on success).
extern "C" int mla_paged_decode_tc_launch(
    const void* q_abs, const void* q_pe, const void* cc_pool,
    const void* cp_pool, const void* table, const void* pos, void* out,
    void* part_acc, void* part_ml, int rows, int heads, int r, int dr,
    int nblk, int bs, int nch, float scale, void* stream) {
  if (r != mla_tc::kRank || dr != mla_tc::kRope)
    return (int)cudaErrorInvalidValue;
  mla_tc::Params P{};
  P.q_abs = static_cast<const __nv_bfloat16*>(q_abs);
  P.q_pe = static_cast<const __nv_bfloat16*>(q_pe);
  P.cc = static_cast<const __nv_bfloat16*>(cc_pool);
  P.cp = static_cast<const __nv_bfloat16*>(cp_pool);
  P.table = static_cast<const int*>(table);
  P.pos = static_cast<const int*>(pos);
  P.out = static_cast<__nv_bfloat16*>(out);
  P.part_acc = static_cast<float*>(part_acc);
  P.part_ml = static_cast<float*>(part_ml);
  P.rows = rows;
  P.heads = heads;
  P.nblk = nblk;
  P.bs = bs;
  P.nch = nch;
  P.scale2 = scale * 1.4426950408889634f;
  return (int)mla_tc::run(P, static_cast<cudaStream_t>(stream));
}
