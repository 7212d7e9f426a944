// mla_paged_decode on Hopper's tensor cores: the bf16 route of
// csrc/mla_paged.cu (the f32 route and widths off this one keep that
// file's SIMT kernel). It replaces the Pallas kernel
// repro/kernels/paged_attention.py (mla_paged_decode, :162 / :192).
//
// Function, as the Pallas body: for row b (one query token at logical
// position pos[b] of a lane whose logical block j is the physical block
// table[b, j]) and head h,
//
//     s_t   = (q_abs[b, h] . cc_t + q_pe[b, h] . cp_t) * scale,  t <= pos[b]
//     o_lat = sum_t p_t cc_t / max(l, 1e-30),   p = exp(s - m) rounded to
//             bf16 for the product, l the fp32 sum of the unrounded p
//
// A row at pos[b] < 0 counts every key of its view at the score -1e30: the
// uniform average of the view's latent rows, as ref.py computes.
//
// Bound on an H100: a row reads its live latent and rope-key rows once
// ((r + dr) x 2 bytes a key) against 2 x H x (r + dr) + 2 x H x r FLOPs a
// key. At MLA_LONG (32 rows x 2049 keys, 128 heads, r 512, dr 64) that is
// 75.5 MB (0.0225 ms at 3.35 TB/s) against 18.2 GFLOP (0.018 ms at
// 989 TFLOP/s bf16): both near, so the products must run on the tensor
// cores (fp32 SIMT FMA alone would take 0.27 ms).
//
// Design.
//  * Heads are the M dimension. Every head of a row reads the same keys, so
//    a block takes the heads of one row in a wgmma M tile of 64 and
//    computes S (64 x keys) = [q_abs | q_pe] . [cc | cp]^T and O (64 x r)
//    += P . cc. A block takes 64 heads, or 32 or 16 where rows x head
//    groups x chunks would leave SMs idle (the engine's decode: 4 rows, one
//    chunk; the host picks it from the grid alone); rows of the tile past
//    its heads, or past the call's, are zero queries and are not stored.
//    One tile of kKeys latent rows with their rope
//    columns, in shared memory in the 128-byte-swizzled layout of
//    wgmma.cuh, is K for the first product (K-major) and V for the second
//    (its latent columns read MN-major).
//  * Two warpgroups. The O accumulator is 64 x 512 fp32: each warpgroup
//    holds half of its columns (128 registers a thread). The score tile is
//    split by keys: warpgroup g computes the scores of keys 32 g .. 32 g +
//    31 (m64n32, all 576 columns), the two exchange their row maxima
//    through shared memory, and each packs its p into bf16 A fragments
//    that it hands to the other through the tile's rope columns (no longer
//    read once both score products are done). A fragment's layout depends
//    only on the thread's index in its warpgroup, so thread i of one
//    warpgroup reads exactly what thread i of the other wrote. Both then
//    run O += P V over all 64 keys, P from registers (wgmma_rs), V from the
//    tile. Each warpgroup keeps the fp32 sum l over its own keys; the two
//    are added at the end in a fixed order. O is rescaled only where a
//    row's maximum moved (a factor of 1 is exact), so most tiles of a long
//    row skip the 128 products a thread.
//  * Copies. The table gives physical blocks of bs rows; every thread
//    copies its 16-byte pieces of two key rows through it with cp.async
//    (zero-filled past the last counted key, so a dead key adds 0 x 0)
//    into a ring of two tiles: tile t + 1 is in flight while tile t is
//    multiplied. The query tile (64 x 576 bf16, 72 KB) is copied once, and
//    its copies are in flight while the block reads the pool row of each
//    of its chunk's keys through the table into shared memory, so no table
//    read waits in front of a tile's copies. Shared memory: 72 KB of
//    queries + 2 x 72 KB of keys + the exchange + 4 KB of pool rows.
//  * Fixed key chunks and an in-order merge. A block takes (row, head
//    group, chunk of kChunk logical positions), kChunk a constant never
//    chosen from the call (common.MLA_CHUNK; tests hold the two equal).
//    It reads pos on the device and returns at once where its chunk holds
//    no counted key. Where the view spans more than one chunk, each block
//    writes fp32 (m, l, acc) partials and a second kernel merges a (row,
//    head)'s live chunks in chunk order, with no atomics (launched as a
//    programmatic dependent, as in decode_split.cuh). Where the view fits
//    one chunk (the engine's decode views), no merge runs. A row with one
//    live chunk comes out bitwise the same either way: the merge weighs
//    that chunk by exp2(0) = 1 and adds it to zero. The chunk is sized from
//    the bytes: at MLA_LONG's view of 2064 keys, chunks of 1024 keep the
//    partials (rows x heads x chunks x (r + 2) x 4 bytes, written and read
//    again) to a third of the keys' bytes, and 128 full blocks fill the
//    card in one wave.
//  * Bitwise invariance. A head's output depends only on its own query
//    row, the row's keys, pos and the fixed order of the products' K steps
//    and of the tiles: never on which heads share its M tile, on the
//    call's rows, on the pool's block size or on the table's width. So a
//    row alone or in a call, paged or contiguous, agrees bitwise, which
//    the serving engine's parity gates rest on.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "wgmma.cuh"

// Internal linkage, as decode_split.cuh: no symbol is shared with another
// library of the port.
namespace mla_tc {
namespace {

// kChunk is common.MLA_CHUNK, which sizes the merge's workspace
constexpr int kChunk = 1024;         // logical key positions a block takes
constexpr int kRank = 512;           // r, the latent width (MLA_TC_RANK)
constexpr int kRope = 64;            // dr, the rope-key width (MLA_TC_ROPE)
constexpr int kCols = kRank + kRope;
constexpr int kColBlocks = kCols / 64;         // 64-column swizzled blocks
constexpr int kHeads = 64;           // wgmma's M: the heads of a tile
constexpr int kMinGroup = 16;        // the fewest heads a block takes
constexpr int kTargetBlocks = 132;   // an H100's SMs: groups shrink below
constexpr int kKeys = 64;            // keys a tile holds
constexpr int kThreads = 256;        // two warpgroups
constexpr int kStages = 2;
constexpr int kBlockBytes = 64 * 128;           // one 64 x 64 column block
constexpr int kTileBytes = kColBlocks * kBlockBytes;
constexpr int kXchBytes = kThreads * 2 * 4;     // two floats a thread
constexpr int kRowsBytes = kChunk * 4;          // a chunk's pool rows
constexpr int kSmem =
    1024 + kTileBytes * (1 + kStages) + kXchBytes + kRowsBytes;
constexpr int kMergeThreads = kRank / 4;        // a float4 of channels each
constexpr float kNegInf = -1e30f;
static_assert(kChunk % kKeys == 0, "a chunk is whole tiles");
static_assert(kRope == 64, "P is handed over in the tile's rope block");
static_assert(8 * kThreads * 4 == kBlockBytes, "8 P words a thread");
static_assert(kSmem <= 232448, "the tiles fit an H100 block");

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// the generic proxy's writes (cp.async, st.shared) visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// d = A B (scale_d 0) or d += A B, m64n32k16, both operands K-major in
// shared memory: the score product of one warpgroup's 32 keys
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

struct Params {
  const __nv_bfloat16* q_abs;   // (rows, heads, kRank)
  const __nv_bfloat16* q_pe;    // (rows, heads, kRope)
  const __nv_bfloat16* cc;      // (nblocks, bs, kRank)
  const __nv_bfloat16* cp;      // (nblocks, bs, kRope)
  const int* table;             // (rows, nblk)
  const int* pos;               // (rows,)
  __nv_bfloat16* out;           // like q_abs
  float* part_acc;              // (rows, heads, nch, kRank) when nch > 1
  float* part_ml;               // (rows, heads, nch, 2): m, l
  int rows, heads, nblk, bs, nch;
  int group, groups;            // heads a block takes, blocks a row's heads
  float scale2;                 // scale x log2(e): scores in log2 units
};

// The counted keys of a row: [0, last] of the view; `masked` where pos < 0
// (every view key counted at the score -1e30).
__device__ __forceinline__ int last_key(int p, int view, bool* masked) {
  *masked = p < 0;
  return p < 0 ? view - 1 : min(p, view - 1);
}

// Start the copies of the key tile at logical position base into the slot
// at `tile`: thread i copies 16-byte piece i % 8 of every 64-column block
// of key rows i / 8 and i / 8 + 32, through the chunk's pool rows (prows,
// indexed from the chunk's first position c_lo); rows past `hi` are
// zero-filled.
__device__ __forceinline__ void copy_keys(const Params& P, uint32_t tile,
                                          const int* prows, int c_lo,
                                          int base, int hi) {
  const int c = threadIdx.x & 7;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = (threadIdx.x >> 3) + 32 * half;
    const int p = base + row;
    const bool live = p <= hi;
    const size_t prow = live ? (size_t)prows[p - c_lo] : 0;
    const uint32_t dst = tile + row * 128 + ((c ^ (row & 7)) << 4);
#pragma unroll
    for (int cb = 0; cb < kColBlocks; ++cb) {
      const __nv_bfloat16* src =
          cb < kRank / 64 ? P.cc + prow * kRank + cb * 64 + c * 8
                          : P.cp + prow * kRope + (cb - kRank / 64) * 64 +
                                c * 8;
      cp_async16(dst + cb * kBlockBytes, live ? src : P.cc, live);
    }
  }
}

// One block: (row b, head group, chunk). 256 threads, two warpgroups.
__global__ void __launch_bounds__(kThreads, 1) split_kernel(const Params P) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (wg::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + kTileBytes;           // slots: sk + i kTileBytes
  float* xch = reinterpret_cast<float*>(
      smem_raw + (sk + kStages * kTileBytes - wg::smem_addr(smem_raw)));
  int* prows = reinterpret_cast<int*>(xch + 2 * kThreads);

  int idx = blockIdx.x;
  // rows fastest, chunks slowest: the full leading chunks of every row are
  // dealt out first
  const int b = idx % P.rows;
  idx /= P.rows;
  const int hg = idx % P.groups, chunk = idx / P.groups;
  const int view = P.nblk * P.bs;
  bool masked;
  const int last = last_key(P.pos[b], view, &masked);
  const int c_lo = chunk * kChunk;
  // the merge kernel may be scheduled once every block has started: it
  // waits for this grid's end itself (griddepcontrol.wait)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (c_lo > last) return;
  const int hi = min(c_lo + kChunk - 1, last);
  const int ntiles = (hi - c_lo) / kKeys + 1;
  const int* row_table = P.table + (size_t)b * P.nblk;
  const int tid = threadIdx.x;
  const int h0 = hg * P.group;

  // the query tile (heads past the call's are zero) and the first keys
  {
    const int c = tid & 7;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = (tid >> 3) + 32 * half;
      const bool live = row < P.group && h0 + row < P.heads;
      const size_t qrow = (size_t)b * P.heads + h0 + row;
      const uint32_t dst = sq + row * 128 + ((c ^ (row & 7)) << 4);
#pragma unroll
      for (int cb = 0; cb < kColBlocks; ++cb) {
        const __nv_bfloat16* src =
            cb < kRank / 64 ? P.q_abs + qrow * kRank + cb * 64 + c * 8
                            : P.q_pe + qrow * kRope +
                                  (cb - kRank / 64) * 64 + c * 8;
        cp_async16(dst + cb * kBlockBytes, live ? src : P.q_abs, live);
      }
    }
  }
  // the pool row of every counted key of the chunk, read through the
  // table once, a thread's reads all in flight together (no table read
  // waits in front of a tile's copies)
  int pr[kChunk / kThreads];
#pragma unroll
  for (int j = 0; j < kChunk / kThreads; ++j) {
    const int p = c_lo + tid + j * kThreads;
    pr[j] = p <= hi ? row_table[p / P.bs] * P.bs + p % P.bs : 0;
  }
#pragma unroll
  for (int j = 0; j < kChunk / kThreads; ++j)
    prows[tid + j * kThreads] = pr[j];
  __syncthreads();
  copy_keys(P, sk, prows, c_lo, c_lo, hi);
  cp_async_commit();

  // the warpgroup, uniform in each warp as the compiler sees it (a branch
  // that ptxas may take for divergent serialises the wgmmas)
  const int g = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int tw = tid & 127;                  // thread in its warpgroup
  const int lane = tid & 31;
  // this thread's rows of the M tile (and + 8), and its first key column
  const int r0 = 16 * (tw >> 5) + (lane >> 2);
  const int kcol = 32 * g + 2 * (lane & 3);

  float oh[kRank / 4];                       // 64 x 256 over 128 threads
#pragma unroll
  for (int i = 0; i < kRank / 4; ++i) oh[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    const uint32_t st = sk + (t % kStages) * kTileBytes;
    const int base = c_lo + t * kKeys;
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();   // tile t (and the queries) landed; tile t - 1 done

    // S: this warpgroup's 32 keys x all 576 columns. A descriptor's low 14
    // bits are the address / 16, so a step's offset is added to it.
    float s[16];
    const uint64_t qd = wg::desc_sw128(sq, 16, 1024);
    const uint64_t kd = wg::desc_sw128(st + g * (32 * 128), 16, 1024);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kCols / 16; ++kk) {
      // 16 columns (32 bytes) a step, 4 steps a 64-column block
      const uint32_t at = ((kk >> 2) * kBlockBytes + ((kk & 3) << 5)) >> 4;
      wgmma_ss_n32(s, qd + at, kd + at, kk > 0);
    }
    wg::wgmma_commit();
    // the next tile's copies, issued while the tensor cores run S (their
    // issue takes the load units some thousand cycles a tile)
    if (t + 1 < ntiles) {
      copy_keys(P, sk + ((t + 1) % kStages) * kTileBytes, prows, c_lo,
                base + kKeys, hi);
      cp_async_commit();
    }
    wg::wgmma_wait<0>();
    wg::reg_fence(s);

    // this warpgroup's row maxima over its keys, in log2 units; keys past
    // the last counted one score -inf (p = 0)
    float mx[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * h + e];
          const int key = base + kcol + 8 * j + e;
          x = key > hi ? -INFINITY : (masked ? kNegInf : x * P.scale2);
          mx[h] = fmaxf(mx[h], x);
        }
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    }
    xch[2 * tid] = mx[0];
    xch[2 * tid + 1] = mx[1];
    __syncthreads();   // both maxima written; both score products done
    const int other = tid ^ 128;
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], fmaxf(mx[h], xch[2 * other + h]));
      corr[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * h + e];
          x = exp2f(x - m_new);
          sum += x;
        }
      l[h] = l[h] * corr[h] + sum;
    }
    // p as bf16 A fragments: keys 16 kk .. 16 kk + 15 of this warpgroup's
    // 32; handed to the other warpgroup through the rope block
    uint32_t own[2][4], pa[4][4];
    uint32_t* xp = reinterpret_cast<uint32_t*>(
        smem_raw + (st + kRank / 64 * kBlockBytes - wg::smem_addr(smem_raw)));
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        own[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
        xp[(4 * kk + r) * kThreads + tid] = own[kk][r];
      }
    __syncthreads();   // both warpgroups' p written
    // keys 0-31 are warpgroup 0's, 32-63 warpgroup 1's (selects, not a
    // runtime index: the fragments stay in registers)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint32_t theirs = xp[(4 * kk + r) * kThreads + other];
        pa[kk][r] = g == 0 ? own[kk][r] : theirs;
        pa[2 + kk][r] = g == 0 ? theirs : own[kk][r];
      }

    // rescale O where a row's maximum moved (a factor of exactly 1 leaves
    // it as it is: most tiles of a long row skip the 128 products)
    if (!__all_sync(0xffffffffu, corr[0] == 1.f && corr[1] == 1.f)) {
#pragma unroll
      for (int c = 0; c < kRank / 16; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          oh[4 * c + 2 * h] *= corr[h];
          oh[4 * c + 2 * h + 1] *= corr[h];
        }
    }
    // O += P V: this warpgroup's 256 latent columns, 4 steps of 16 keys
    const uint64_t vd = wg::desc_sw128(
        st + (g * kRank / 128) * kBlockBytes, kBlockBytes, 1024);
    wg::reg_fence(oh);
    wg::reg_fence(pa);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wg::wgmma_rs<kRank / 2>(oh, pa[kk], vd + kk * (16 * 128 >> 4));
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::reg_fence(oh);
  }

  // l over all 64 keys of every tile: each thread's columns, its quad, then
  // warpgroup 0's keys before warpgroup 1's
  float lq[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lq[h] = l[h] + __shfl_xor_sync(0xffffffffu, l[h], 1);
    lq[h] += __shfl_xor_sync(0xffffffffu, lq[h], 2);
  }
  __syncthreads();     // every read of the maxima is done
  xch[2 * tid] = lq[0];
  xch[2 * tid + 1] = lq[1];
  __syncthreads();
  const int lo_t = tid & 127, hi_t = lo_t + 128;
  const int col0 = g * (kRank / 2) + 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lt = xch[2 * lo_t + h] + xch[2 * hi_t + h];
    const int head = h0 + r0 + 8 * h;
    if (r0 + 8 * h >= P.group || head >= P.heads) continue;
    const size_t rh = (size_t)b * P.heads + head;
    if (P.nch == 1) {
      // acc / max(l, 1e-30) as acc times one rounded reciprocal, in this
      // kernel and the merge alike (128 divisions a thread took 4 us)
      const float rl = 1.f / fmaxf(lt, 1e-30f);
      __nv_bfloat16* orow = P.out + rh * kRank + col0;
#pragma unroll
      for (int c = 0; c < kRank / 16; ++c)
        *reinterpret_cast<uint32_t*>(orow + 8 * c) =
            pack_bf16(oh[4 * c + 2 * h] * rl, oh[4 * c + 2 * h + 1] * rl);
    } else {
      const size_t at = rh * P.nch + chunk;
      float* arow = P.part_acc + at * kRank + col0;
#pragma unroll
      for (int c = 0; c < kRank / 16; ++c)
        *reinterpret_cast<float2*>(arow + 8 * c) =
            make_float2(oh[4 * c + 2 * h], oh[4 * c + 2 * h + 1]);
      if (g == 0 && (lane & 3) == 0) {
        P.part_ml[2 * at] = m[h];
        P.part_ml[2 * at + 1] = lt;
      }
    }
  }
}

// One block per (row, head): the live chunks' partials in chunk order,
// out = acc / max(l, 1e-30) (times its reciprocal, as the split kernel
// writes a row of one chunk). A thread owns 4 channels; it issues the loads
// of a batch of chunks' partials before their weights are known.
__global__ void __launch_bounds__(kMergeThreads) merge_kernel(const Params P) {
  constexpr int kBatch = 4;
  extern __shared__ float ws[];              // m[n], then l[n]
  const int rh = blockIdx.x;                 // b * heads + head
  const int b = rh / P.heads;
  bool masked;
  const int n = last_key(P.pos[b], P.nblk * P.bs, &masked) / kChunk + 1;
  const float* __restrict__ ml = P.part_ml + (size_t)rh * P.nch * 2;
  const float* __restrict__ pa =
      P.part_acc + (size_t)rh * P.nch * kRank + 4 * threadIdx.x;
  // launched as a programmatic dependent of the split kernel: wait for its
  // grid to finish (and its partials to be visible) only here
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  float4 x[kBatch];
#pragma unroll
  for (int j = 0; j < kBatch; ++j)
    if (j < n) x[j] = *reinterpret_cast<const float4*>(pa + (size_t)j * kRank);
  for (int i = threadIdx.x; i < n; i += kMergeThreads) {
    ws[i] = ml[2 * i];
    ws[n + i] = ml[2 * i + 1];
  }
  __syncthreads();
  float mx = -INFINITY;
  for (int i = 0; i < n; ++i) mx = fmaxf(mx, ws[i]);
  float l = 0.f, a[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i0 = 0; i0 < n; i0 += kBatch) {
    if (i0 > 0) {
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (i0 + j < n)
          x[j] = *reinterpret_cast<const float4*>(pa +
                                                  (size_t)(i0 + j) * kRank);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (i0 + j < n) {
        const float wt = exp2f(ws[i0 + j] - mx);
        l += ws[n + i0 + j] * wt;
        a[0] += x[j].x * wt;
        a[1] += x[j].y * wt;
        a[2] += x[j].z * wt;
        a[3] += x[j].w * wt;
      }
    }
  }
  const float rl = 1.f / fmaxf(l, 1e-30f);   // as the split kernel's
  __nv_bfloat16* out = P.out + (size_t)rh * kRank + 4 * threadIdx.x;
  *reinterpret_cast<uint32_t*>(out) = pack_bf16(a[0] * rl, a[1] * rl);
  *reinterpret_cast<uint32_t*>(out + 2) = pack_bf16(a[2] * rl, a[3] * rl);
}

// Checks the call and launches the split kernel (and the merge). nch must
// be ceil(nblk * bs / kChunk), the count the wrapper sized the workspace by.
cudaError_t run(Params P, cudaStream_t stream) {
  if (P.rows <= 0) return cudaSuccess;
  const long long view = (long long)P.nblk * P.bs;
  if (P.heads <= 0 || P.nblk <= 0 || P.bs <= 0 || view > INT_MAX ||
      P.nch != (view + kChunk - 1) / kChunk ||
      2 * sizeof(float) * P.nch > 48 * 1024 ||   // the merge's weights
      (P.nch > 1 && (P.part_acc == nullptr || P.part_ml == nullptr)))
    return cudaErrorInvalidValue;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(P.q_abs) |
                         reinterpret_cast<uintptr_t>(P.q_pe) |
                         reinterpret_cast<uintptr_t>(P.cc) |
                         reinterpret_cast<uintptr_t>(P.cp) |
                         reinterpret_cast<uintptr_t>(P.part_acc);
  if (ptrs % 16 != 0) return cudaErrorInvalidValue;
  // heads a block takes: 64, halved (to 16 at least) while the grid leaves
  // SMs idle; the rows of the M tile past them are zero queries, and a
  // head's arithmetic does not depend on its tile
  P.group = kHeads;
  while (P.group > kMinGroup &&
         (long long)P.rows * ((P.heads + P.group - 1) / P.group) * P.nch <
             kTargetBlocks)
    P.group /= 2;
  P.groups = (P.heads + P.group - 1) / P.group;
  const long long blocks = (long long)P.rows * P.groups * P.nch;
  if (blocks > INT_MAX || (long long)P.rows * P.heads > INT_MAX)
    return cudaErrorInvalidValue;
  // on every launch: a function-local static would be one symbol across
  // the port's libraries
  cudaError_t err = cudaFuncSetAttribute(
      split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  split_kernel<<<(int)blocks, kThreads, kSmem, stream>>>(P);
  err = cudaGetLastError();
  if (err != cudaSuccess || P.nch == 1) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P.rows * P.heads);
  cfg.blockDim = dim3(kMergeThreads);
  cfg.dynamicSmemBytes = 2 * sizeof(float) * P.nch;
  cfg.stream = stream;
  // programmatic dependent launch: the merge's launch overlaps the split
  // kernel's last blocks
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, merge_kernel, P);
}

}  // namespace
}  // namespace mla_tc
