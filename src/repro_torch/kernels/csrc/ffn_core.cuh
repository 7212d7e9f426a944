// Tiled GLU-FFN core shared by the four expert/FFN kernels of the port.
//
// Replaces the fused Pallas bodies of repro/kernels/swiglu.py (swiglu_ffn),
// repro/kernels/moe_gmm.py (moe_gmm_ragged and moe_gmm) and
// repro/kernels/moe_gather.py (moe_gather). All four compute, per output
// row r with expert e(r):
//
//     h[r]   = round_T(act(x[a(r)] . Wg[e]) * (x[a(r)] . Wu[e]))   fp32 sums
//     out[r] = round_T(h[r] . Wd[e])                               fp32 sums
//
// and differ only in the row rule:
//   kDense      e = 0,                     a(r) = r        (swiglu_ffn)
//   kTileOwner  e = owner[r / block_c],    a(r) = r        (moe_gmm_ragged)
//   kPerRow     e = eidx[r],               a(r) = r / top_k (moe_gather);
//               e == num_experts is the sentinel: no loads, no FLOPs, and
//               the down stage writes an exact zero row.
//   kCapacity   e = r / C,                 a(r) = r        (moe_gmm: dense
//               (E, C, d) capacity buffers, C = block_c). Tiles never
//               straddle experts: the grid runs E x ceil(C / BM) row tiles
//               and each masks its local rows >= C.
//
// Design. The TPU kernels carry the down-projection sum across a sequential
// grid axis in VMEM scratch. Hopper blocks run in no order, so the port runs
// two launches on one stream: stage 1 (gate/up/act) writes h for every row
// to device memory, stage 2 (down) reads it back. h is rounded to the input
// type exactly where the Pallas bodies round it (before the down product).
// The h round trip costs 2 * rows * m * sizeof(T) bytes of device traffic
// that the TPU kernel keeps in VMEM (h is 2.9 MB at the calibration
// forward's T=512, f=2816 in bf16, so 5.8 MB moved, beside 17.3 MB of
// weights); fusing it back is later work. Each block computes a BM x BN
// output tile with a BK-deep shared-memory K loop and TM x TN fp32
// accumulators per thread (SIMT FMA): exact in f32, far from the bf16
// tensor-core bound. It serves float32 for all four kernels, and bf16
// only where d or m is off the 8 grid; bf16 otherwise runs on the tensor
// cores (ffn_tc.cuh): swiglu_ffn and moe_gmm through its rule kCapacity,
// moe_gmm_ragged through kOwner and moe_gather through kGather, all with
// one per-row arithmetic.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "convert.cuh"

namespace ffn {

enum RowRule { kDense = 0, kTileOwner = 1, kPerRow = 2, kCapacity = 3 };
enum Act { kSwiglu = 0, kGeglu = 1 };
enum DType { kF32 = 0, kBF16 = 1 };

struct Args {
  const void* a;   // stage 1: x (a rows, K); stage 2: h (rows, K)
  const void* b0;  // (E, K, N) bank: wg (stage 1) or wd (stage 2)
  const void* b1;  // (E, K, N) bank: wu (stage 1); unused in stage 2
  void* c;         // (rows, N): h (stage 1) or out (stage 2)
  const int* ids;  // owner per row tile (kTileOwner) / expert per row (kPerRow)
  int rows, K, N, num_experts;
  int rule, block_c, top_k, act;
};

using cvt::from_f;
using cvt::to_f;

// swish(g) = g * sigmoid(g); gelu is the tanh form, jax.nn.gelu's default
__device__ __forceinline__ float act_fn(float g, int act) {
  if (act == kSwiglu) return g * (1.0f / (1.0f + expf(-g)));
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * g * (1.0f + tanhf(k0 * (g + 0.044715f * g * g * g)));
}

// One BM x BN tile of stage 1 (GLU = true: two banks, act epilogue writes h)
// or stage 2 (GLU = false: one bank, plain epilogue writes out). All rows of
// a tile share one expert: BM == block_c under kTileOwner, BM == 1
// under kPerRow, and under kCapacity a tile covers BM rows of one expert's
// C (rows from row_end on belong to the next expert and are masked).
template <typename T, int BM, int BN, int BK, int TM, int TN, bool GLU>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    ffn_tile(const Args p) {
  constexpr int NT = (BM / TM) * (BN / TN);
  int row0 = blockIdx.x * BM;
  int row_end = p.rows;
  const int col0 = blockIdx.y * BN;
  const int tid = threadIdx.x;

  int e = 0;
  if (p.rule == kTileOwner) e = p.ids[row0 / p.block_c];
  else if (p.rule == kPerRow) e = p.ids[row0];
  else if (p.rule == kCapacity) {
    const int tiles = (p.block_c + BM - 1) / BM;  // row tiles per expert
    e = blockIdx.x / tiles;
    row0 = e * p.block_c + (blockIdx.x % tiles) * BM;
    row_end = (e + 1) * p.block_c;
  }
  T* C = static_cast<T*>(p.c);
  if (e < 0 || e >= p.num_experts) {
    // sentinel (dead) row: stage 1 leaves h unwritten (stage 2 never reads
    // it); stage 2 writes the exact zero row the Pallas kernel emits
    if constexpr (!GLU) {
      for (int i = tid; i < BM * BN; i += NT) {
        const int r = row0 + i / BN, n = col0 + i % BN;
        if (r < p.rows && n < p.N) C[(size_t)r * p.N + n] = from_f<T>(0.f);
      }
    }
    return;
  }

  const T* A = static_cast<const T*>(p.a);
  const size_t bank = (size_t)p.K * p.N;
  const T* B0 = static_cast<const T*>(p.b0) + (size_t)e * bank;
  const T* B1 = GLU ? static_cast<const T*>(p.b1) + (size_t)e * bank : B0;

  __shared__ float As[BK][BM];
  __shared__ float Bs0[BK][BN];
  __shared__ float Bs1[GLU ? BK : 1][GLU ? BN : 1];

  const int ty = tid / (BN / TN), tx = tid % (BN / TN);
  float acc0[TM][TN], acc1[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc0[i][j] = acc1[i][j] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, kk = i % BK;
      const int row = row0 + r, k = k0 + kk;
      float v = 0.f;
      if (row < row_end && k < p.K) {
        const int arow = (GLU && p.rule == kPerRow) ? row / p.top_k : row;
        v = to_f(A[(size_t)arow * p.K + k]);
      }
      As[kk][r] = v;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int kk = i / BN, n = i % BN;
      const int k = k0 + kk, col = col0 + n;
      const bool ok = k < p.K && col < p.N;
      Bs0[kk][n] = ok ? to_f(B0[(size_t)k * p.N + col]) : 0.f;
      if constexpr (GLU) Bs1[kk][n] = ok ? to_f(B1[(size_t)k * p.N + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b0[TN], b1[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        b0[j] = Bs0[kk][tx + j * (BN / TN)];
        if constexpr (GLU) b1[j] = Bs1[kk][tx + j * (BN / TN)];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc0[i][j] = fmaf(a[i], b0[j], acc0[i][j]);
          if constexpr (GLU) acc1[i][j] = fmaf(a[i], b1[j], acc1[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + ty + i * (BM / TM);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tx + j * (BN / TN);
      if (row < row_end && col < p.N) {
        const float v = GLU ? act_fn(acc0[i][j], p.act) * acc1[i][j]
                            : acc0[i][j];
        C[(size_t)row * p.N + col] = from_f<T>(v);
      }
    }
  }
}

// Tile shapes: 64 x 64 tiles of 256 threads (4 x 4 outputs each) for the
// token-major rules; one row per block for the per-row (gather) rule, 64
// columns wide, one output per thread.
constexpr int kBM = 64, kBN = 64, kBK = 16, kTM = 4, kTN = 4;
constexpr int kRowBN = 64, kRowBK = 64;

template <typename T, bool GLU>
cudaError_t launch_stage(const Args& p, cudaStream_t stream) {
  if (p.rule == kPerRow) {
    dim3 grid(p.rows, (p.N + kRowBN - 1) / kRowBN);
    ffn_tile<T, 1, kRowBN, kRowBK, 1, 1, GLU><<<grid, kRowBN, 0, stream>>>(p);
  } else {
    const int row_tiles =
        p.rule == kCapacity
            ? p.num_experts * ((p.block_c + kBM - 1) / kBM)
            : (p.rows + kBM - 1) / kBM;
    dim3 grid(row_tiles, (p.N + kBN - 1) / kBN);
    ffn_tile<T, kBM, kBN, kBK, kTM, kTN, GLU>
        <<<grid, (kBM / kTM) * (kBN / kTN), 0, stream>>>(p);
  }
  return cudaGetLastError();
}

// Both stages, in order, on `stream`. x: (x rows, d); wg/wu: (E, d, m);
// wd: (E, m, d); h: (rows, m) scratch; out: (rows, d). Returns the first
// launch error (cudaSuccess == 0).
template <typename T>
cudaError_t run_ffn(const void* x, const int* ids, const void* wg,
                    const void* wu, const void* wd, void* h, void* out,
                    int rows, int d, int m, int num_experts, int rule,
                    int block_c, int top_k, int act, cudaStream_t stream) {
  if (rows <= 0 || d <= 0 || m <= 0) return cudaSuccess;
  Args s1{x, wg, wu, h, ids, rows, d, m, num_experts,
          rule, block_c, top_k, act};
  cudaError_t err = launch_stage<T, true>(s1, stream);
  if (err != cudaSuccess) return err;
  Args s2{h, wd, nullptr, out, ids, rows, m, d, num_experts,
          rule, block_c, top_k, act};
  return launch_stage<T, false>(s2, stream);
}

inline int run_ffn_dtype(int dtype, const void* x, const int* ids,
                         const void* wg, const void* wu, const void* wd,
                         void* h, void* out, int rows, int d, int m,
                         int num_experts, int rule, int block_c, int top_k,
                         int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return (int)run_ffn<float>(x, ids, wg, wu, wd, h, out, rows, d, m,
                               num_experts, rule, block_c, top_k, act, s);
  if (dtype == kBF16)
    return (int)run_ffn<__nv_bfloat16>(x, ids, wg, wu, wd, h, out, rows, d,
                                       m, num_experts, rule, block_c, top_k,
                                       act, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace ffn
