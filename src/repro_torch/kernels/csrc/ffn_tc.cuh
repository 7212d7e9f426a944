// Tensor-core GLU-FFN core for bfloat16 on Hopper (sm_90a): the route that
// all four FFN kernels take for bf16 operands with d and m multiples of 8
// (ffn_route in the wrappers): swiglu_ffn and moe_gmm (rule kCapacity),
// moe_gmm_ragged (kOwner) and moe_gather (kGather). float32, and bf16 off
// that grid, stay on the SIMT core (ffn_core.cuh), whose fp32 products are
// exact where TF32 would not be.
//
// It computes what ffn_core.cuh computes, with the same rounding points as
// the Pallas bodies (repro/kernels/swiglu.py, moe_gmm.py, moe_gather.py):
//
//     h[r]   = round_bf16(act(x[a(r)] . Wg[e(r)]) * (x[a(r)] . Wu[e(r)]))
//     out[r] = round_bf16(h[r] . Wd[e(r)])
//
// g, u and the down product are fp32 accumulators; h is formed in fp32 in
// the epilogue and rounded once. The banks are (E, K, N). The rules differ
// only in which rows a block gathers and whose weights it streams:
//   kCapacity  x, h, out (E, C, K) buffers (E = 1, C = T for swiglu_ffn):
//              block y is row tile y % tiles of expert y / tiles;
//   kOwner     the (P, K) expert-sorted layout of moe_gmm_ragged: block y is
//              64-row tile y, its expert owner[y];
//   kGather    moe_gather's (n,) expert ids, row r reading token r / top_k:
//              block x is row x. The block of the first row of each run of
//              64 rows of one expert (in row order) gathers that run's
//              token rows into its A tile, one 1-row TMA box each, and
//              streams the expert's B tiles once for all of them; the other
//              blocks exit. A sentinel id (outside [0, E)) loads nothing
//              and runs no product: stage 1 writes no h row for it, stage 2
//              an exact zero row.
//
// Bounds on an H100 (989 TFLOP/s bf16, 3.35 TB/s). moe_gmm at deepseek-v2's
// experts (E 160, C 8, d 5120, m 1536) moves 7.55 GB of weights for 60
// GFLOP: bound by bytes, 2.26 ms. moe_gmm_ragged at deepseek's static
// prefill (768 live rows of a 10880-row layout) streams the live experts'
// 7.45 GB: 2.24 ms by bytes; at qwen's (384 of 704 rows, 5 experts of
// 1024 x 352) 10.8 MB, 0.0037 ms. moe_gather at deepseek's decode (24 rows,
// about 21 distinct experts) streams their 0.99 GB: 0.31 ms by bytes.
// swiglu_ffn at the calibration forward (T 512, d 1024, f 2816) does 8.86
// GFLOP on 19.4 MB: bound by operations, 9.0 us.
//
// Design. Two launches on one stream, as ffn_core.cuh: stage 1 (gate, up,
// act) writes h, stage 2 (down) reads it; at these shapes h stays in the
// 50 MB L2. A block owns BN output columns of one expert's rows and has one
// or two consumer warpgroups of 64 rows each, which run wgmma m64nBNk16
// with fp32 accumulators (two, g and u, over the same A tile in stage 1),
// and a producer warp, whose first lane loads K slices of 64 by TMA into a
// ring of shared-memory stages guarded by full / empty mbarriers, so that
// loads run ahead of the products. Stage 1 of kCapacity takes two
// warpgroups where an expert has more than 64 rows: they share each B
// tile, which halves its reads from L2 (at T 512 the 64-row blocks read
// 136 MB from L2 for 11.5 MB of weights; two warpgroups took swiglu_ffn
// from 0.0384 to 0.0286 ms inside a CUDA graph, tools/bench_ab.py ffn,
// PERF.md). At 64 rows or fewer a second one would hold only padding and
// cost a ring stage (0.0622 against 0.0535 ms at zamba2's decode), and in
// stage 2 two were slower (0.0326 ms). kOwner and kGather keep one: a
// ragged tile's neighbour may belong to another expert, and a gathered
// run holds at most 64 rows.
// A (x or h) is K-major, as Q in flash_attention; the banks are
// N-contiguous, so B is read MN-major, as V there (the transpose bit, LBO
// between 64-column blocks, SBO between 8-row groups). The tensor maps are
// 128-byte swizzled, 3-D over (E, C, K) and (E, K, N) (a (1, rows, K) map
// for the 2-D A of kOwner and kGather): a 64-row box at C = 8 reads zeros
// past C, not the next expert's rows, and K and N past their ends read
// zeros, so no edge needs code; the epilogue stores only live rows and
// columns < N. A gathered row's 1-row box lands at row j of the A tile,
// where the swizzle (a function of the shared address) puts it as a 64-row
// box would; rows past the run are never stored. Each wgmma group stays
// in flight while the next slice's group is issued (wait_group 1), and a
// slice's stage is freed once its group has finished. Roles come through
// __shfl_sync and the loop has no branch around a product, so ptxas keeps
// the wgmmas asynchronous.
//
// Where the tiles are padding. A ragged layout sizes P for the worst case
// (P = round_up(N + E * 63, 64)): at deepseek's prefill 768 of its 10880
// rows are live, and about 11 trailing tiles hold only zero rows with
// owner E - 1. They run as any tile: zero rows give exact zero rows
// (act(0) * 0 = 0), which is what ragged_combine reads for a sentinel
// assignment; expert E - 1's B tiles are then read by up to 12 blocks in
// flight at once, mostly from L2, and the tensor cores' work on padding
// (about 0.5 ms at deepseek) hides under the weight stream, as moe_gmm's
// does at C = 8. Skipping them would need the live row count, which the
// kernel's entry (the reference's signature) does not carry.
//
// One arithmetic for a routed row. A warpgroup's row tile is 64 for every
// rule, row count and place, the K loop runs in one order (slices of 64,
// four k16 steps each), no split of K is ever chosen, h is rounded once,
// and BN comes from the weights alone (E and N), so a (token row, expert)
// pair gives bitwise the same output row through moe_gather, moe_gmm_ragged
// and moe_gmm on the same bank, whatever the other rows of the call
// (chip_smoke.py phase 4a checks it; the serving engine's overlap parity
// stands on it). BN is 128 where the weights give at least two waves of
// such column tiles (E x ceil(N / 128) >= 264: deepseek's experts), else
// 64 (swiglu_ffn's stage 2 at N = 1024 fills 128 SMs at T = 512 only with
// 64-wide tiles). The ring takes up to 112 KB, so two blocks share an SM
// and one block's epilogue overlaps the other's loads. At zamba2's decode
// swiglu_ffn runs near 0.054 ms against its 0.030 ms bound; neither a
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

// which rows a block serves and whose weights it streams (see the note)
enum Rule { kCapacity = 0, kOwner = 1, kGather = 2 };

struct Params {
  bf16* out;        // (rows, N), or (E, C, N) under kCapacity
  const int* ids;   // owner per tile (kOwner), expert per row (kGather)
  int C;            // rows: of an expert (kCapacity), of the call (else)
  int K, N;         // depth, width
  int tiles;        // kCapacity: row tiles an expert
  int num_experts;
  int a_div;        // kGather: row r reads A row r / a_div
  int act;
};

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

// rows [r0, r1) x columns [col0, col0 + BN) of out (row stride N) set to
// exact zeros by the whole block
template <int BN>
__device__ void zero_rows(bf16* out, int r0, int r1, int col0, int N) {
  for (int i = threadIdx.x; i < (r1 - r0) * BN; i += blockDim.x) {
    const int c = col0 + i % BN;
    if (c < N) out[(size_t)(r0 + i / BN) * N + c] = __float2bfloat16(0.f);
  }
}

// One (WGS x 64) x BN tile of stage 1 (GLU: g and u over two banks, h
// written in the epilogue) or stage 2 (one bank, out written), WGS consumer
// warpgroups of 64 rows each over the same B tiles; which rows and expert,
// by RULE (see the note).
template <int BN, bool GLU, int WGS, int RULE>
__global__ void __launch_bounds__(WGS * 128 + 32)
    ffn_tc_tile(const __grid_constant__ CUtensorMap tma,
                const __grid_constant__ CUtensorMap tmb0,
                const __grid_constant__ CUtensorMap tmb1, const Params p) {
  static_assert(RULE == kCapacity || WGS == 1, "one warpgroup a tile");
  using R = Ring<BN, GLU, WGS>;
  constexpr int kConsumers = WGS * 128;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int run_rows[kRows];  // kGather: the rows of the block's run
  __shared__ int run_len;
  const uint32_t ring = (wg::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = ring + R::kStages * R::kStage;
  auto full = [&](int i) { return bars + 8 * i; };
  auto empty = [&](int i) { return bars + 8 * (R::kStages + i); };
  auto slot_a = [&](int i) { return ring + i * R::kStage; };
  auto slot_b = [&](int i, int b) {
    return ring + i * R::kStage + R::kA + b * R::kB;
  };

  const int tid = threadIdx.x;
  const int col0 = (RULE == kGather ? blockIdx.y : blockIdx.x) * BN;
  const int nk = (p.K + kBK - 1) / kBK;
  int e, row0 = 0, a_outer = 0, live = WGS * kRows;
  bf16* base = p.out;
  if constexpr (RULE == kCapacity) {
    e = blockIdx.y / p.tiles;
    row0 = (blockIdx.y % p.tiles) * (WGS * kRows);  // within e
    a_outer = e;
    base += (size_t)e * p.C * p.N;
  } else if constexpr (RULE == kOwner) {
    e = p.ids[blockIdx.y];
    row0 = blockIdx.y * kRows;
    if (e < 0 || e >= p.num_experts) {
      // no expert: stage 1 leaves h unwritten (stage 2 never reads it),
      // stage 2 writes the tile's rows as exact zeros
      if constexpr (!GLU) zero_rows<BN>(p.out, row0, row0 + kRows, col0, p.N);
      return;
    }
  } else {
    const int r = blockIdx.x;
    e = p.ids[r];
    if (e < 0 || e >= p.num_experts) {  // the sentinel
      if constexpr (!GLU) zero_rows<BN>(p.out, r, r + 1, col0, p.N);
      return;
    }
    if (tid < 32) {
      // r leads a run if its rank among the rows of e is a multiple of 64;
      // the run is the next 64 of those rows from r on
      int rank = 0;
      for (int b = 0; b < r; b += 32) {
        const int j = b + tid;
        rank += __popc(__ballot_sync(0xffffffffu, j < r && p.ids[j] == e));
      }
      int len = 0;
      if (rank % kRows == 0) {
        for (int b = r; b < p.C && len < kRows; b += 32) {
          const int j = b + tid;
          const bool hit = j < p.C && p.ids[j] == e;
          const unsigned mask = __ballot_sync(0xffffffffu, hit);
          const int at = len + __popc(mask & ((1u << tid) - 1u));
          if (hit && at < kRows) run_rows[at] = j;
          len += __popc(mask);
        }
      }
      if (tid == 0) run_len = len < kRows ? len : kRows;
    }
    __syncthreads();
    live = run_len;
    if (live == 0) return;  // another block leads r's run
  }

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
      const uint32_t bytes = RULE == kGather
                                 ? live * 128 + (R::kStage - R::kA)
                                 : R::kStage;
      for (int t = 0; t < nk; ++t) {
        const int i = t % R::kStages;
        if (t >= R::kStages)
          wg::mbar_wait(empty(i), ((t / R::kStages) - 1) & 1);
        wg::mbar_expect_tx(full(i), bytes);
        if constexpr (RULE == kGather) {
          for (int j = 0; j < live; ++j)
            wg::tma_load_3d(slot_a(i) + 128 * j, &tma, full(i), t * kBK,
                            run_rows[j] / p.a_div, 0);
        } else {
          wg::tma_load_3d(slot_a(i), &tma, full(i), t * kBK, row0, a_outer);
        }
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
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int local = 16 * (tid >> 5) + (lane >> 2) + 8 * h;
    int row;
    if constexpr (RULE == kGather) {
      if (local >= live) continue;
      row = run_rows[local];
    } else {
      row = row0 + local;
      if (row >= p.C) continue;
    }
    bf16* orow = base + (size_t)row * p.N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = col + 8 * j;
      if (c >= p.N) continue;
      float v0 = g[4 * j + 2 * h], v1 = g[4 * j + 2 * h + 1];
      if constexpr (GLU) {
        v0 = ffn::act_fn(v0, p.act) * u[4 * j + 2 * h];
        v1 = ffn::act_fn(v1, p.act) * u[4 * j + 2 * h + 1];
      }
      *reinterpret_cast<__nv_bfloat162*>(orow + c) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

// One stage at column tile BN. a: the A source, an (a_outer, a_rows, K)
// tensor; b0, b1: (E, K, N) banks (b1 unused in stage 2).
template <int BN, bool GLU, int WGS, int RULE>
cudaError_t launch_stage(const void* a, int a_outer, int a_rows,
                         const void* b0, const void* b1, int E, Params p,
                         cudaStream_t stream) {
  using R = Ring<BN, GLU, WGS>;
  CUtensorMap ta, tb0, tb1;
  if (!wg::tensor_map(&ta, a, a_outer, a_rows, p.K,
                      RULE == kGather ? 1 : WGS * kRows) ||
      !wg::tensor_map(&tb0, b0, E, p.K, p.N, kBK) ||
      !wg::tensor_map(&tb1, GLU ? b1 : b0, E, p.K, p.N, kBK))
    return cudaErrorInvalidValue;
  // on every launch: a function-local static here would be one symbol
  // shared by every library that includes this header (the dynamic linker
  // unifies them), so one library's first call would skip the others'
  const cudaError_t err = cudaFuncSetAttribute(
      ffn_tc_tile<BN, GLU, WGS, RULE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, R::kBytes);
  if (err != cudaSuccess) return err;
  const int cols = (p.N + BN - 1) / BN;
  dim3 grid(cols, p.C / kRows);                        // kOwner: P / 64
  if (RULE == kCapacity) {
    p.tiles = (p.C + WGS * kRows - 1) / (WGS * kRows);
    grid = dim3(cols, E * p.tiles);
  } else if (RULE == kGather) {
    grid = dim3(p.C, cols);
  }
  ffn_tc_tile<BN, GLU, WGS, RULE>
      <<<grid, WGS * 128 + 32, R::kBytes, stream>>>(ta, tb0, tb1, p);
  return cudaGetLastError();
}

// BN from the weights alone (E and N), never from the row count
template <bool GLU, int WGS, int RULE>
cudaError_t stage(const void* a, int a_outer, int a_rows, const void* b0,
                  const void* b1, int E, const Params& p,
                  cudaStream_t stream) {
  if ((long long)E * ((p.N + 127) / 128) >= kWideTiles)
    return launch_stage<128, GLU, WGS, RULE>(a, a_outer, a_rows, b0, b1, E,
                                             p, stream);
  return launch_stage<64, GLU, WGS, RULE>(a, a_outer, a_rows, b0, b1, E, p,
                                          stream);
}

// Both stages, in order, on `stream`; wg, wu: (E, d, m); wd: (E, m, d);
// all bf16, contiguous, 16-byte aligned, d and m multiples of 8 (the tensor
// maps' 16-byte strides). By RULE:
//   kCapacity  x: (E, C, d) buffers, h: (E, C, m), out: (E, C, d); stage 1
//              gives a block two consumer warpgroups where an expert has
//              more than one 64-row tile (they share each B tile, which
//              halves the weight reads from L2), else one;
//   kOwner     x: (C, d), C a multiple of 64, ids: (C / 64,) owners;
//              h: (C, m), out: (C, d);
//   kGather    x: (x_rows, d) tokens, ids: (C,) expert per row, row r
//              reading token r / top_k; h: (C, m), out: (C, d).
// Returns the first launch error (cudaSuccess == 0).
template <int RULE>
int run(const void* x, const int* ids, const void* wg, const void* wu,
        const void* wd, void* h, void* out, int E, int C, int x_rows, int d,
        int m, int top_k, int act, void* stream) {
  const uintptr_t ptrs =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wg) |
      reinterpret_cast<uintptr_t>(wu) | reinterpret_cast<uintptr_t>(wd) |
      reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(out);
  const long long y_blocks =
      RULE == kCapacity ? (long long)E * ((C + kRows - 1) / kRows)
                        : RULE == kOwner ? C / kRows : 1;
  if (E < 0 || C < 0 || d < 0 || m < 0 || d % 8 || m % 8 || ptrs % 16 ||
      y_blocks > 65535 || (RULE == kOwner && C % kRows) ||
      (RULE == kGather && (top_k <= 0 || x_rows < 0 ||
                           (long long)x_rows * top_k < C)))
    return (int)cudaErrorInvalidValue;
  if (C == 0 || d == 0 || m == 0) return (int)cudaSuccess;
  if (E == 0)  // every row of an owner or gather call names an expert
    return RULE == kCapacity ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* hb = static_cast<bf16*>(h);
  const Params p1{hb, ids, C, d, m, 0, E, top_k, act};
  const Params p2{static_cast<bf16*>(out), ids, C, m, d, 0, E, 1, act};
  const int outer = RULE == kCapacity ? E : 1;
  const int rows1 = RULE == kGather ? x_rows : C;
  cudaError_t err;
  if constexpr (RULE == kCapacity)
    err = C > kRows ? stage<true, 2, RULE>(x, outer, rows1, wg, wu, E, p1, s)
                    : stage<true, 1, RULE>(x, outer, rows1, wg, wu, E, p1, s);
  else
    err = stage<true, 1, RULE>(x, outer, rows1, wg, wu, E, p1, s);
  if (err != cudaSuccess) return (int)err;
  return (int)stage<false, 1, RULE>(h, outer, C, wd, nullptr, E, p2, s);
}

}  // namespace ffn_tc
