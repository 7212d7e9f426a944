// router_score on Hopper: replaces the Pallas kernel
// repro/kernels/router_score.py (router_score), the CMoE analytical router's
// fused scoring
//
//     s[t, n] = act(x[t] . Wg_R[:, n]) * (x[t] . Wu_R[:, n])     fp32 out
//
// over x (T, d) in f32 or bf16 and the representative-neuron columns
// Wg_R / Wu_R (d, N_r), N_r of 5 to 13. g and u are fp32 sums of exact
// products and are not rounded to x's type (ref.router_score_ref).
//
// Bound on an H100: N_r is tiny, so the op is bound by the bytes of x (at
// T 512, d 1024, N_r 5, bf16: 1.05 MB, about 0.3 us at 3.35 TB/s; the
// 10.5 MFLOP are nothing). The design reads x exactly once: each warp owns
// kRowsPerWarp token rows, its lanes stride over d with neighbouring lanes
// on neighbouring elements, and every lane keeps 2 x NR fp32 partial sums
// per row in registers. The weights are too large for shared memory at
// d 4096 in f32 (426 KB at N_r 13), so each block stages them in chunks of
// kChunk rows of d, transposed to [n][k] (one padding column, so neither
// the staging writes nor the lane-consecutive reads conflict on a bank).
// A warp butterfly sums the lanes' partials at the end. A 64-column FFN
// tile (ffn_core.cuh) would waste 92% of its columns at N_r 5, and rounds
// its hidden values, so this is a kernel of its own.
#include "ffn_core.cuh"

namespace {

constexpr int kWarps = 8;         // 256 threads a block
constexpr int kRowsPerWarp = 2;   // token rows a warp owns
constexpr int kChunk = 256;       // rows of d staged per pass

template <typename T, int NR>
__global__ void __launch_bounds__(kWarps * 32)
    router_score_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                        const T* __restrict__ wu, float* __restrict__ out,
                        int t, int d, int nr, int act) {
  __shared__ float wg_s[NR][kChunk + 1];
  __shared__ float wu_s[NR][kChunk + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = (blockIdx.x * kWarps + warp) * kRowsPerWarp;

  float g[kRowsPerWarp][NR], u[kRowsPerWarp][NR];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int n = 0; n < NR; ++n) g[r][n] = u[r][n] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kChunk) {
    const int kc = min(kChunk, d - k0);
    __syncthreads();  // the previous chunk is consumed
    // n fastest: consecutive threads read consecutive weight elements
    for (int i = threadIdx.x; i < kChunk * NR; i += kWarps * 32) {
      const int kk = i / NR, n = i % NR;
      const bool ok = kk < kc && n < nr;
      const size_t at = (size_t)(k0 + kk) * nr + n;
      wg_s[n][kk] = ok ? ffn::to_f(wg[at]) : 0.f;
      wu_s[n][kk] = ok ? ffn::to_f(wu[at]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = row0 + r;
      if (row >= t) continue;  // warp-uniform
      const T* xr = x + (size_t)row * d + k0;
      for (int kk = lane; kk < kc; kk += 32) {
        const float xv = ffn::to_f(xr[kk]);
#pragma unroll
        for (int n = 0; n < NR; ++n) {
          g[r][n] = fmaf(xv, wg_s[n][kk], g[r][n]);
          u[r][n] = fmaf(xv, wu_s[n][kk], u[r][n]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    if (row >= t) continue;  // warp-uniform: every lane takes the shuffles
#pragma unroll
    for (int n = 0; n < NR; ++n) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        g[r][n] += __shfl_xor_sync(0xffffffffu, g[r][n], off);
        u[r][n] += __shfl_xor_sync(0xffffffffu, u[r][n], off);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int n = 0; n < NR; ++n)
        if (n < nr)
          out[(size_t)row * nr + n] = ffn::act_fn(g[r][n], act) * u[r][n];
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* wg, const void* wu, float* out,
                   int t, int d, int nr, int act, cudaStream_t stream) {
  const dim3 grid((t + kWarps * kRowsPerWarp - 1) / (kWarps * kRowsPerWarp));
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(wg);
  const T* up = static_cast<const T*>(wu);
  if (nr <= 8)
    router_score_kernel<T, 8><<<grid, kWarps * 32, 0, stream>>>(
        xp, gp, up, out, t, d, nr, act);
  else if (nr <= 16)
    router_score_kernel<T, 16><<<grid, kWarps * 32, 0, stream>>>(
        xp, gp, up, out, t, d, nr, act);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

// x: (t, d); wg_r / wu_r: (d, nr) in x's type; out: (t, nr) float32.
// Returns the launch error (cudaSuccess == 0).
extern "C" int router_score_launch(const void* x, const void* wg,
                                   const void* wu, void* out, int t, int d,
                                   int nr, int dtype, int act,
                                   void* stream) {
  if (t <= 0) return (int)cudaSuccess;
  if (nr <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == ffn::kF32)
    return (int)launch<float>(x, wg, wu, o, t, d, nr, act, s);
  if (dtype == ffn::kBF16)
    return (int)launch<__nv_bfloat16>(x, wg, wu, o, t, d, nr, act, s);
  return (int)cudaErrorInvalidValue;
}
