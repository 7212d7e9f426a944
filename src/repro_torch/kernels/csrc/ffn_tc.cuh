// Tensor-core GLU-FFN core for bfloat16 on Hopper (sm_90a): the route that
// swiglu_ffn and moe_gmm take for bf16 operands with d and m multiples of 8
// (swiglu.route / moe_gmm.route in the wrappers). float32, and bf16 off
// that grid, stay on the SIMT core (ffn_core.cuh), whose fp32 products are
// exact where TF32 would not be.
//
// It computes what ffn_core.cuh computes, with the same rounding points as
// the Pallas bodies (repro/kernels/swiglu.py, repro/kernels/moe_gmm.py):
//
//     h[e, c]   = round_bf16(act(x[e, c] . Wg[e]) * (x[e, c] . Wu[e]))
//     out[e, c] = round_bf16(h[e, c] . Wd[e])
//
// g, u and the down product are fp32 accumulators; h is formed in fp32 in
// the epilogue and rounded once. x, h and out are (E, C, K) buffers (E = 1,
// C = T for swiglu_ffn), the banks (E, K, N).
//
// Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s). moe_gmm at deepseek-v2's
// experts (E 160, C 8, d 5120, m 1536) moves 7.55 GB of weights for 60
// GFLOP: bound by bytes, 2.26 ms. swiglu_ffn at the calibration forward
// (T 512, d 1024, f 2816) does 8.86 GFLOP on 19.4 MB: bound by
// operations, 9.0 us; at zamba2's decode (T 4, d 2048, f 8192) it streams
// 100.7 MB of weights: bound by bytes, 0.030 ms.
//
// Design. Two launches on one stream, as ffn_core.cuh: stage 1 (gate, up,
// act) writes h, stage 2 (down) reads it; at these shapes h (2.9 MB for
// qwen, 3.9 MB for deepseek) stays in the 50 MB L2. A block owns BN output
// columns of one expert's rows and has one or two consumer warpgroups of
// 64 rows each, which run wgmma m64nBNk16 with fp32 accumulators (two, g
// and u, over the same A tile in stage 1), and a producer warp, whose
// first lane loads K slices of 64 by TMA into a ring of shared-memory
// stages guarded by full / empty mbarriers, so that loads run ahead of the
// products. Stage 1 takes two warpgroups where an expert has more than 64
// rows: they share each B tile, which halves its reads from L2 (at T 512
// the 64-row blocks read 136 MB from L2 for 11.5 MB of weights; two
// warpgroups took the function from 0.0384 to 0.0286 ms inside a CUDA
// graph, tools/bench_ffn.py, PERF.md). At 64 rows or fewer a second one
// would hold only padding and cost a ring stage (0.0622 against 0.0535 ms
// at zamba2's decode), and in stage 2 two were slower (0.0326 ms).
// A (x or h) is K-major, as Q in flash_attention; the banks are
// N-contiguous, so B is read MN-major, as V there (the transpose bit, LBO
// between 64-column blocks, SBO between 8-row groups). The tensor maps are
// 3-D over (E, C, K) and (E, K, N), 128-byte swizzled: a 64-row box at C =
// 8 reads zeros past C, not the next expert's rows, and K and N past their
// ends read zeros, so no edge needs code; the epilogue stores only rows < C
// and columns < N. Each wgmma group stays in flight while the next slice's
// group is issued (wait_group 1), and a slice's stage is freed once its
// group has finished. Roles come through __shfl_sync and the loop has no
// branch around a product, so ptxas keeps the wgmmas asynchronous.
//
// Width invariance. A warpgroup's row tile is 64 for every T and C and
// runs the same products on it whichever block holds it, the K loop runs
// in one order, and no split of K is ever chosen, so a row's result does
// not depend on the other rows of the call. BN is 128 where the weights
// alone give at least two waves of such column tiles (E x ceil(N / 128) >=
// 264: deepseek's experts), else 64 (swiglu_ffn's stage 2 at N = 1024 fills
// 128 SMs at T = 512 only with 64-wide tiles); it depends on E and N, never
// on the row count. The ring takes up to 112 KB, so two blocks share an SM
// and one block's epilogue overlaps the other's loads. At zamba2's decode
// the function runs near 0.054 ms against its 0.030 ms bound; neither a
// 32-wide column tile (twice stage 2's 32 blocks) nor a 200 KB ring (one
// block an SM) moved that by more than 4%, so neither is kept (PERF.md).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "ffn_core.cuh"
#include "wgmma.cuh"

namespace ffn_tc {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;                // rows a consumer warpgroup owns
constexpr int kBK = 64;                  // K of a stage: one 128-byte row
constexpr int kRingBudget = 112 * 1024;  // two blocks an SM
constexpr int kMaxStages = 8;
constexpr int kWideTiles = 264;          // two waves of 132 SMs

template <int BN, bool GLU, int WGS>
struct Ring {
  static constexpr int kA = WGS * kRows * kBK * 2;  // the A tile: 8 KB a WG
  static constexpr int kB = kBK * BN * 2;     // one bank's tile
  static constexpr int kStage = kA + (GLU ? 2 : 1) * kB;
  static constexpr int kStages = kRingBudget / kStage < kMaxStages
                                     ? kRingBudget / kStage
                                     : kMaxStages;
  // mbarriers: full and empty for each stage; + 1024 to align the tiles to
  // the swizzle atom
  static constexpr int kBytes = kStages * kStage + 16 * kStages + 1024;
  static_assert(kStages >= 2, "a ring of at least two stages");
};

// One (WGS x 64) x BN tile of stage 1 (GLU: g and u over two banks, h
// written in the epilogue) or stage 2 (one bank, out written), WGS consumer
// warpgroups of 64 rows each over the same B tiles. Block (x, y) owns
// columns x BN.. of rows (y % tiles) WGS 64.. of expert y / tiles; C is the
// rows an expert has, K the depth, N the width.
template <int BN, bool GLU, int WGS>
__global__ void __launch_bounds__(WGS * 128 + 32)
    ffn_tc_tile(const __grid_constant__ CUtensorMap tma,
                const __grid_constant__ CUtensorMap tmb0,
                const __grid_constant__ CUtensorMap tmb1,
                bf16* __restrict__ out, int C, int K, int N, int tiles,
                int act) {
  using R = Ring<BN, GLU, WGS>;
  constexpr int kConsumers = WGS * 128;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (wg::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = ring + R::kStages * R::kStage;
  auto full = [&](int i) { return bars + 8 * i; };
  auto empty = [&](int i) { return bars + 8 * (R::kStages + i); };
  auto slot_a = [&](int i) { return ring + i * R::kStage; };
  auto slot_b = [&](int i, int b) {
    return ring + i * R::kStage + R::kA + b * R::kB;
  };

  const int e = blockIdx.y / tiles;
  const int row0 = (blockIdx.y % tiles) * (WGS * kRows);  // within e
  const int col0 = blockIdx.x * BN;
  const int nk = (K + kBK - 1) / kBK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < R::kStages; ++i) {
      wg::mbar_init(full(i), 1);
      wg::mbar_init(empty(i), kConsumers);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  // the role, uniform in each warp as the compiler sees it
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  if (warp == kConsumers / 32) {  // producer
    if (tid == kConsumers) {
      for (int t = 0; t < nk; ++t) {
        const int i = t % R::kStages;
        if (t >= R::kStages)
          wg::mbar_wait(empty(i), ((t / R::kStages) - 1) & 1);
        wg::mbar_expect_tx(full(i), R::kStage);
        wg::tma_load_3d(slot_a(i), &tma, full(i), t * kBK, row0, e);
#pragma unroll
        for (int cb = 0; cb < BN / 64; ++cb) {
          wg::tma_load_3d(slot_b(i, 0) + cb * (kBK * 128), &tmb0, full(i),
                          col0 + 64 * cb, t * kBK, e);
          if constexpr (GLU)
            wg::tma_load_3d(slot_b(i, 1) + cb * (kBK * 128), &tmb1, full(i),
                            col0 + 64 * cb, t * kBK, e);
        }
      }
    }
    return;
  }

  // consumer warpgroup grp: rows 64 grp.. of the tile
  const int grp = warp / 4;
  float g[BN / 2], u[GLU ? BN / 2 : 1];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) g[j] = 0.f;
#pragma unroll
  for (int j = 0; j < (GLU ? BN / 2 : 1); ++j) u[j] = 0.f;

  for (int t = 0; t < nk; ++t) {
    const int i = t % R::kStages;
    wg::mbar_wait(full(i), (t / R::kStages) & 1);
    wg::reg_fence(g);
    wg::reg_fence(u);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // A: 16 K columns, 32 bytes into each swizzled row; B: 16 K rows down
      const uint64_t da = wg::desc_sw128(
          slot_a(i) + grp * (kRows * 128) + kk * 32, 16, 1024);
      wg::wgmma_ss<BN, 1>(
          g, da, wg::desc_sw128(slot_b(i, 0) + kk * (16 * 128), kBK * 128,
                                1024), 1);
      if constexpr (GLU)
        wg::wgmma_ss<BN, 1>(
            u, da, wg::desc_sw128(slot_b(i, 1) + kk * (16 * 128), kBK * 128,
                                  1024), 1);
    }
    wg::wgmma_commit();
    wg::reg_fence(g);
    wg::reg_fence(u);
    wg::wgmma_wait<1>();  // slice t - 1's products are done: free its stage
    if (t > 0) wg::mbar_arrive(empty((t - 1) % R::kStages));
  }
  wg::wgmma_wait<0>();
  wg::reg_fence(g);
  wg::reg_fence(u);

  // epilogue: in warp w, lane l holds rows 16 w + l / 4 (+ 8) and columns
  // 8 j + 2 (l % 4) + {0, 1} of the tile
  const int lane = tid & 31;
  const int col = col0 + 2 * (lane & 3);
  bf16* base = out + (size_t)e * C * N;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 16 * (tid >> 5) + (lane >> 2) + 8 * h;
    if (row >= C) continue;
    bf16* orow = base + (size_t)row * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = col + 8 * j;
      if (c >= N) continue;
      float v0 = g[4 * j + 2 * h], v1 = g[4 * j + 2 * h + 1];
      if constexpr (GLU) {
        v0 = ffn::act_fn(v0, act) * u[4 * j + 2 * h];
        v1 = ffn::act_fn(v1, act) * u[4 * j + 2 * h + 1];
      }
      *reinterpret_cast<__nv_bfloat162*>(orow + c) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

template <int BN, bool GLU, int WGS>
cudaError_t launch_stage(const void* a, const void* b0, const void* b1,
                         void* c, int E, int C, int K, int N, int act,
                         cudaStream_t stream) {
  using R = Ring<BN, GLU, WGS>;
  CUtensorMap ta, tb0, tb1;
  if (!wg::tensor_map(&ta, a, E, C, K, WGS * kRows) ||
      !wg::tensor_map(&tb0, b0, E, K, N, kBK) ||
      !wg::tensor_map(&tb1, GLU ? b1 : b0, E, K, N, kBK))
    return cudaErrorInvalidValue;
  // on every launch: a function-local static here would be one symbol
  // shared by every library that includes this header (the dynamic linker
  // unifies them), so one library's first call would skip the others'
  const cudaError_t err = cudaFuncSetAttribute(
      ffn_tc_tile<BN, GLU, WGS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      R::kBytes);
  if (err != cudaSuccess) return err;
  const int tiles = (C + WGS * kRows - 1) / (WGS * kRows);
  dim3 grid((N + BN - 1) / BN, E * tiles);
  ffn_tc_tile<BN, GLU, WGS><<<grid, WGS * 128 + 32, R::kBytes, stream>>>(
      ta, tb0, tb1, static_cast<bf16*>(c), C, K, N, tiles, act);
  return cudaGetLastError();
}

// BN from the weights alone (E and N), never from the row count
template <bool GLU, int WGS>
cudaError_t stage(const void* a, const void* b0, const void* b1, void* c,
                  int E, int C, int K, int N, int act, cudaStream_t stream) {
  if ((long long)E * ((N + 127) / 128) >= kWideTiles)
    return launch_stage<128, GLU, WGS>(a, b0, b1, c, E, C, K, N, act,
                                       stream);
  return launch_stage<64, GLU, WGS>(a, b0, b1, c, E, C, K, N, act, stream);
}

// Both stages, in order, on `stream`. x: (E, C, d); wg, wu: (E, d, m); wd:
// (E, m, d); h: (E, C, m) scratch; out: (E, C, d); all bf16, contiguous,
// 16-byte aligned, d and m multiples of 8 (the tensor maps' 16-byte
// strides). Stage 1 gives a block two consumer warpgroups where an expert
// has more than one 64-row tile (they share each B tile, which halves the
// weight reads from L2), else one (a second would hold only padding and
// take a ring stage's room). Returns the first launch error (cudaSuccess
// == 0).
inline int run(const void* x, const void* wg, const void* wu, const void* wd,
               void* h, void* out, int E, int C, int d, int m, int act,
               void* stream) {
  const uintptr_t ptrs =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wg) |
      reinterpret_cast<uintptr_t>(wu) | reinterpret_cast<uintptr_t>(wd) |
      reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(out);
  if (E < 0 || C < 0 || d < 0 || m < 0 || d % 8 || m % 8 || ptrs % 16 ||
      (long long)E * ((C + kRows - 1) / kRows) > 65535)
    return (int)cudaErrorInvalidValue;
  if (E == 0 || C == 0 || d == 0 || m == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      C > kRows ? stage<true, 2>(x, wg, wu, h, E, C, d, m, act, s)
                : stage<true, 1>(x, wg, wu, h, E, C, d, m, act, s);
  if (err != cudaSuccess) return (int)err;
  return (int)stage<false, 1>(h, wd, nullptr, out, E, C, m, d, act, s);
}

}  // namespace ffn_tc
