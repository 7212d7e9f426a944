// router_score on Hopper: replaces the Pallas kernel
// repro/kernels/router_score.py (router_score, :29 / :36), the CMoE
// analytical router's fused scoring
//
//     s[t, n] = act(x[t] . Wg_R[:, n]) * (x[t] . Wu_R[:, n])     fp32 out
//
// over x (T, d) in f32 or bf16 and the representative-neuron columns
// Wg_R / Wu_R (d, N_r), N_r of 5 to 13. g and u are fp32 sums of exact
// products and are not rounded to x's type (ref.router_score_ref).
//
// Bound on an H100: N_r is tiny, so the op is bound by the bytes of x (at
// T 512, d 1024, N_r 5, bf16: 1.05 MB, about 0.3 us at 3.35 TB/s; the
// 10.5 MFLOP are nothing), and the tensor cores gain nothing: a SIMT
// kernel that reads x once, with the whole card.
//
// Design. The plan (blocks, rows a warp, the weights' chunk) is host logic,
// router_score.plan(T, d, N_r, itemsize), which the wrapper passes in.
//  * x is read once, in 16-byte vectors (8 bf16 or 4 f32 a lane): a warp
//    takes one row at a time, lane l the vectors l, l + 32, ... of it; a
//    block has kWarps warps, and T 512 spreads over 128 blocks.
//  * The weights are staged in shared memory once a block, in their own
//    type, by 16-byte cp.async while the row's first x vectors are in
//    flight. Their natural layout already serves a lane: the E rows of d
//    that one x vector meets are N_r contiguous 16-byte vectors of Wg_R
//    (and of Wu_R). Those groups sit N_r | 1 vectors apart, an odd stride,
//    so a quarter warp's 16-byte reads hit 8 distinct bank groups. Only
//    past 48 KB (d 4096 at N_r 13; d 4096 at N_r 5 in bf16) are the
//    weights staged in chunks of rows of d, once for each row a warp takes.
//  * N_r is a template argument (1 to 16): the products of a group unroll
//    into fixed registers, 2 x N_r fp32 partial sums a lane, folded by a
//    warp butterfly at the row's end. A lane sums its groups in order of
//    d, so a row's scores do not depend on the call.
#include <stdint.h>

#include "ffn_core.cuh"

namespace {

constexpr int kWarps = 4;            // router_score.ROUTER_WARPS
constexpr int kThreads = 32 * kWarps;
constexpr int kBatch = 4;            // x vectors a lane keeps in flight
constexpr int kSmemBudget = 48 * 1024;  // router_score.ROUTER_SMEM
constexpr int kMaxCols = 16;         // router_score.MAX_ROUTER_COLS

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// a 16-byte vector of T widened to fp32 (a bf16 is the high half of an
// fp32: the value __bfloat162float gives)
template <typename T>
__device__ __forceinline__ void widen(const uint4& raw, float* f) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 2) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else {
      f[i] = __uint_as_float(w[i]);
    }
  }
}

// groups: d / E vectors of x a row; cg: groups staged a chunk
template <typename T, int NR>
__global__ void __launch_bounds__(kThreads)
    router_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                  const T* __restrict__ wu, float* __restrict__ out, int t,
                  int groups, int cg, int rows_per_warp, int act) {
  constexpr int E = 16 / (int)sizeof(T);
  constexpr int NRP = NR | 1;          // an odd stride of vectors a group
  extern __shared__ uint4 wsm[];       // Wg_R's chunk, then Wu_R's
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nchunks = (groups + cg - 1) / cg;
  const uint4* wg4 = reinterpret_cast<const uint4*>(wg);
  const uint4* wu4 = reinterpret_cast<const uint4*>(wu);

  for (int i = 0; i < rows_per_warp; ++i) {
    const int row = (i * gridDim.x + blockIdx.x) * kWarps + warp;
    const bool live = row < t;      // a dead row still joins the barriers
    const uint4* xr = reinterpret_cast<const uint4*>(x) +
                      (size_t)(live ? row : 0) * groups;
    float g[NR], u[NR];
#pragma unroll
    for (int n = 0; n < NR; ++n) g[n] = u[n] = 0.f;
    for (int c = 0; c < nchunks; ++c) {
      const int g0 = c * cg, ng = min(cg, groups - g0);
      const bool stage = nchunks > 1 || i == 0;   // block-uniform
      if (stage) {
        if (i > 0 || c > 0) __syncthreads();      // the last chunk is read
        for (int v = threadIdx.x; v < ng * NR; v += kThreads) {
          const int gi = v / NR, j = v - gi * NR;
          cp_async16(&wsm[gi * NRP + j], wg4 + (size_t)g0 * NR + v);
          cp_async16(&wsm[(cg + gi) * NRP + j], wu4 + (size_t)g0 * NR + v);
        }
        cp_async_commit();
      }
      for (int gb = 0; gb < ng; gb += 32 * kBatch) {
        uint4 xv[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const int gi = gb + lane + 32 * q;
          xv[q] = live && gi < ng ? __ldg(xr + g0 + gi)
                                  : make_uint4(0u, 0u, 0u, 0u);
        }
        if (gb == 0 && stage) {  // the first x vectors are in flight
          cp_async_wait_all();
          __syncthreads();
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const int gi = gb + lane + 32 * q;
          if (gi >= ng) continue;
          float xf[E];
          widen<T>(xv[q], xf);
          const uint4* wq = &wsm[gi * NRP];
          const uint4* uq = &wsm[(cg + gi) * NRP];
#pragma unroll
          for (int j = 0; j < NR; ++j) {
            float wf[E], uf[E];
            widen<T>(wq[j], wf);
            widen<T>(uq[j], uf);
            // vector j of the group holds its elements f = E j .. E j + E
            // - 1, element f being row f / NR of the group, column f % NR
#pragma unroll
            for (int e = 0; e < E; ++e) {
              const int f = j * E + e;
              g[f % NR] = fmaf(xf[f / NR], wf[e], g[f % NR]);
              u[f % NR] = fmaf(xf[f / NR], uf[e], u[f % NR]);
            }
          }
        }
      }
    }
    if (!live) continue;            // warp-uniform
#pragma unroll
    for (int n = 0; n < NR; ++n)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        g[n] += __shfl_xor_sync(0xffffffffu, g[n], off);
        u[n] += __shfl_xor_sync(0xffffffffu, u[n], off);
      }
    if (lane == 0) {
#pragma unroll
      for (int n = 0; n < NR; ++n)
        out[(size_t)row * NR + n] = ffn::act_fn(g[n], act) * u[n];
    }
  }
}

template <typename T, int NR>
cudaError_t launch(const void* x, const void* wg, const void* wu, float* out,
                   int t, int d, int nr, int blocks, int chunk,
                   int rows_per_warp, int act, cudaStream_t stream) {
  if constexpr (NR < kMaxCols) {
    if (nr != NR)
      return launch<T, NR + 1>(x, wg, wu, out, t, d, nr, blocks, chunk,
                               rows_per_warp, act, stream);
  } else {
    if (nr != NR) return cudaErrorInvalidValue;
  }
  constexpr int E = 16 / (int)sizeof(T);
  constexpr int NRP = NR | 1;
  const int cg = chunk / E;
  const size_t smem = 2 * sizeof(uint4) * (size_t)cg * NRP;
  if (d % E != 0 || chunk % E != 0 || cg < 1 || smem > kSmemBudget ||
      (long long)blocks * kWarps * rows_per_warp < t)
    return cudaErrorInvalidValue;
  router_kernel<T, NR><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(wu), out, t, d / E, cg, rows_per_warp, act);
  return cudaGetLastError();
}

}  // namespace

// x: (t, d); wg_r / wu_r: (d, nr) in x's type, contiguous and 16-byte
// aligned; out: (t, nr) float32. d a multiple of 16 bytes of x's type; nr
// from 1 to 16. blocks, chunk (rows of d staged at once) and rows_per_warp
// are router_score.plan's. Returns the launch error (cudaSuccess == 0).
extern "C" int router_score_launch(const void* x, const void* wg,
                                   const void* wu, void* out, int t, int d,
                                   int nr, int blocks, int chunk,
                                   int rows_per_warp, int dtype, int act,
                                   void* stream) {
  if (t <= 0) return (int)cudaSuccess;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(wg) |
                         reinterpret_cast<uintptr_t>(wu);
  if (nr <= 0 || nr > kMaxCols || d <= 0 || blocks <= 0 ||
      rows_per_warp <= 0 || ptrs % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == ffn::kF32)
    return (int)launch<float, 1>(x, wg, wu, o, t, d, nr, blocks, chunk,
                                 rows_per_warp, act, s);
  if (dtype == ffn::kBF16)
    return (int)launch<__nv_bfloat16, 1>(x, wg, wu, o, t, d, nr, blocks,
                                         chunk, rows_per_warp, act, s);
  return (int)cudaErrorInvalidValue;
}
