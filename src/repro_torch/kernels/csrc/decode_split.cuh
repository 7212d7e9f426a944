// The split-KV decode core on Hopper: single-query attention with an online
// softmax, for flash_decode (a contiguous cache, csrc/flash_decode.cu) and
// paged_attn_decode (a block table, csrc/paged_attn.cu).
//
// It replaces the sequential kv grid axis of the Pallas kernels
// repro/kernels/flash_decode.py (flash_decode, :55 / :65) and
// repro/kernels/paged_attention.py (paged_attn_decode, :86 / :119), which
// carry m, l and acc in scratch from one kv block to the next. Here one
// row's keys are spread over blocks, and a second pass merges them.
//
// Function. Row b is one query token at position pos[b] (flash_decode: one
// pos shared by every row) of a lane whose logical key j lives at a
// contiguous row or through table[b, j / bs]. For kv head h, each query
// head g of its group attends the keys of the row's view (T keys, or
// nblk * bs) that the mask keeps: j <= pos, and j > pos - window when
// window > 0. Scores are fp32 (q . k) * scale, p is rounded to the input
// type before the PV product, and out = acc / max(l, 1e-30), as the Pallas
// bodies do. Where the mask keeps no key of the view (pos < 0, or a window
// wholly past it), every view key scores -1e30 and the softmax is the
// uniform average of the view's V rows, as ref.py computes.
//
// Bound on an H100: a row reads its live K and V rows once (2 x live keys
// x hd x itemsize a kv head) against 4 x grp x hd FLOPs a key, so at grp
// up to ~70 (bf16) it is bound by bytes: 67 MB at flash_decode's llama2-7b
// decode (BH 128, T 1100, pos 1024, D 128), 0.020 ms at 3.35 TB/s; 268 MB
// at paged_attn_decode's 32 rows x depth 2048 x 16 kv heads of 64, 0.080.
//
// Design.
//  * Fixed key chunks. A row's logical positions are cut into chunks of
//    kChunk = 256 (against 128 and 512: tools/bench_ab.py decode --core,
//    PERF.md); one block of 4 warps takes one (row, kv head, slice of
//    at most kMaxHeads query heads, chunk). kChunk never depends on the
//    call's rows, the pool's block size or the table's width, so a row's
//    arithmetic depends only on its query, its keys, pos and window. A
//    block reads pos on the device and returns at once where its chunk
//    holds no counted key; the host sizes the grid from the view alone.
//  * Bytes in flight. A chunk is cut into tiles of kTileSteps x 32 / G
//    keys, dealt to the warps in turn (so a short view still spreads over
//    all 4 warps), and each warp streams its tiles through its own ring of
//    kStages slots in shared memory, copied by 16-byte cp.async.cg in the
//    input type (no fp32 staging). A lane owns 16 bytes of a key row (G =
//    hd / 8 lanes score a key in bf16), and it copies exactly the K and V
//    vectors it later reads, so the ring needs no barrier: each lane waits
//    on its own copy groups. A warp keeps 2 tiles in flight, 4 KB at hd
//    128 in bf16: ~128 KB an SM at 8 blocks of 26 KB. The first tiles are
//    in flight before q is read. Blocks are dealt rows first, so every
//    row's full chunks spread over the SMs before the ragged last ones.
//  * Softmax. Each warp keeps its own online softmax per query head, in
//    log2 units (p = exp2(s - m), one MUFU op a key): a tile's scores are
//    summed by shuffles within each lane group, its max taken across the
//    warp, acc and l rescaled once a tile. At the chunk's end the lane
//    groups are folded by shuffles and the warps merged through shared
//    memory in warp order.
//  * Merge. Where the view spans more than one chunk, each block writes its
//    fp32 (m, l, acc) to a workspace the wrapper allocates, and a second
//    kernel merges a (row, query head)'s live chunks in chunk order, with
//    no atomics; it is launched as a programmatic dependent (PDL), so its
//    launch overlaps the split kernel's last blocks, and it loads a batch
//    of partials before their weights are known. Where the view fits one
//    chunk, the block writes the output and no merge runs. A row with one
//    live chunk comes out bitwise the same either way: the merge weighs
//    that chunk by exp2(0) = 1 and adds it to zero. So rows alone or in a
//    call, paged or contiguous, through a narrow or a wide table, agree
//    bitwise, which the serving engine's parity gates rest on
//    (models/attention.py rows_attention).
//  * Query-head groups. A decode step has one query row, and the served
//    groups run from 1 to 48 query heads a kv head (granite's MQA), so
//    the products here run as SIMT arithmetic: groups wider than one are
//    sliced over blocks of at most 8 heads whose queries sit in registers,
//    each head with its own softmax, so a head's arithmetic does not
//    depend on its slice. mma.sync over a group of 8 or more is later
//    work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "convert.cuh"

// Internal linkage: csrc/flash_decode.cu and csrc/paged_attn.cu each build
// their own copy of these templates, so no symbol (and no launch stub's
// local static) is shared between the two libraries.
namespace dsplit {
namespace {

// kChunk is common.DECODE_CHUNK, which sizes the merge's workspace
// (tests/test_torch_decode_split.py holds the two equal)
constexpr int kChunk = 256;          // logical key positions a block takes
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;           // tiles in a warp's ring
constexpr int kTileSteps = 2;         // keys a lane group takes from a tile
constexpr int kMaxHeads = 8;         // query heads a block scores
constexpr int kMaxHd = 256;
constexpr int kMergeThreads = 64;    // a float4 of channels each: hd <= 256
constexpr float kNegInf = -1e30f;
static_assert(kChunk % (32 * kTileSteps) == 0, "a chunk is whole tiles");
static_assert(kStages >= 2, "a ring keeps a tile in flight");

struct Params {
  const void* q;          // (rows, kh * grp, hd)
  const void* k;          // pool (nblocks, bs, kh, hd), or (rows, T, hd)
  const void* v;
  const int* table;       // (rows, nblk); nullptr: row b's keys are block b
  const int* pos;         // pos[b * pos_stride]
  void* out;              // like q
  float* part_acc;        // (rows, kh * grp, nch, hd) when nch > 1
  float* part_ml;         // (rows, kh * grp, nch, 2): m, l
  int rows, kh, grp, hd, nblk, bs, window, pos_stride, nch;
  int slices, slice_heads;  // query heads split into slices of slice_heads
  int warp_bytes;           // shared memory of one warp
  float scale;
};

// The counted keys of a row: [first, last] of the view, scored unless
// `masked` (no key of the view passes the mask: every view key then
// scores -1e30).
struct Range {
  int first, last;
  bool masked;
};

__device__ __forceinline__ Range live_range(int p, int view, int window) {
  Range r;
  r.last = min(p, view - 1);
  r.first = window > 0 ? max(0, p - window + 1) : 0;
  r.masked = r.first > r.last;
  if (r.masked) {
    r.first = 0;
    r.last = view - 1;
  }
  return r;
}

// A key row of hd values is nvec 16-byte vectors, scored by a group of G
// lanes, each of which owns vpl of them (vectors sub and sub + G): vpl is
// 2 past 32 vectors (f32 rows past hd 128), else 1, and G is the power of
// two >= nvec / vpl, at most 32; a warp scores kpw = 32 / G keys at once,
// and a tile holds kTileSteps such steps.
struct Geometry {
  int nvec, vpl, G, kpw, kt;
};

__host__ __device__ __forceinline__ Geometry geometry(int hd, int elem) {
  Geometry g;
  g.nvec = hd * elem / 16;
  g.vpl = g.nvec > 32 ? 2 : 1;
  g.G = 1;
  while (g.G * g.vpl < g.nvec && g.G < 32) g.G <<= 1;
  g.kpw = 32 / g.G;
  g.kt = kTileSteps * g.kpw;
  return g;
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

// one 16-byte vector of shared memory in one LDS.128 (a load read through a
// T pointer was narrowed into one 2-byte load per bf16 value, 4-way bank
// conflicted across a warp whose lanes read 16 bytes apart: this read
// halved the arithmetic's time)
__device__ __forceinline__ uint4 lds128(const void* p) {
  uint4 v;
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a));
  return v;
}

// a 16-byte vector of T widened to fp32 from its 32-bit words: a bf16 is
// the high half of an fp32 (the value __bfloat162float gives)
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

// One block: (row b, kv head h, query-head slice, chunk). VPL: 16-byte
// vectors a lane owns in a key row (2 only for f32 past hd 128); GH: query
// heads a block holds (a power of two >= slice_heads).
template <typename T, int VPL, int GH>
__global__ void __launch_bounds__(kThreads)
    split_kernel(const Params P) {
  constexpr int E = 16 / (int)sizeof(T);
  constexpr int CH = VPL * E;              // channels a lane owns
  constexpr unsigned kFull = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  int idx = blockIdx.x;
  // rows fastest, chunks slowest: the full leading chunks of every row are
  // dealt out first, the ragged last chunks after them
  const int b = idx % P.rows;
  idx /= P.rows;
  const int h = idx % P.kh;
  idx /= P.kh;
  const int slice = idx % P.slices, chunk = idx / P.slices;
  const Range R = live_range(P.pos[(size_t)b * P.pos_stride],
                             P.nblk * P.bs, P.window);
  const int c_lo = chunk * kChunk;
  // the merge kernel may be scheduled once every block has started: it
  // waits for this grid's end itself (griddepcontrol.wait)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (c_lo > R.last || c_lo + kChunk - 1 < R.first) return;

  const Geometry geo = geometry(P.hd, (int)sizeof(T));
  const int nvec = geo.nvec, G = geo.G, kpw = geo.kpw, kt = geo.kt;
  const int slot = lane / G, sub = lane % G;
  const int g0 = slice * P.slice_heads;
  const int ng = min(P.slice_heads, P.grp - g0);
  const size_t qrow0 = (size_t)b * P.kh * P.grp + (size_t)h * P.grp + g0;
  const int hd = P.hd;
  // scores in log2 units (q . k * scale * log2 e): p = exp2(s - m), one
  // MUFU op, equal to exp((q . k) * scale - m') up to rounding
  const float scale2 = P.scale * 1.4426950408889634f;

  // the chunk's counted keys, [lo, hi], and their row offsets (for every
  // warp: the tiles of a chunk go to the warps in turn)
  const int lo = max(c_lo, R.first), hi = min(c_lo + kChunk - 1, R.last);
  long long* rowoff = reinterpret_cast<long long*>(smem);    // kChunk
  unsigned char* ring =
      smem + kChunk * sizeof(long long) + (size_t)warp * P.warp_bytes;
  const int tile_bytes = kt * nvec * 16;   // one K (or V) tile
  const T* kp = static_cast<const T*>(P.k);
  const T* vp = static_cast<const T*>(P.v);
  for (int i = threadIdx.x; i < kChunk; i += kThreads) {
    const int p = c_lo + i;
    if (p >= lo && p <= hi) {
      const long long row =
          P.table ? (long long)P.table[(size_t)b * P.nblk + p / P.bs] * P.bs +
                        p % P.bs
                  : (long long)b * P.bs + p;
      rowoff[i] = (row * P.kh + h) * hd;
    }
  }

  __syncthreads();                         // rowoff is filled

  // this warp's tiles: i = warp, warp + kWarps, ... of the chunk's tiles
  // of kt positions, those that hold a counted key
  const int i0 = (lo - c_lo) / kt, i1 = (hi - c_lo) / kt;
  const int i_first = i0 + ((warp - i0) % kWarps + kWarps) % kWarps;
  const int ntiles = i_first > i1 ? 0 : (i1 - i_first) / kWarps + 1;
  // a lane copies the K and V vectors it reads itself, so the ring needs
  // no barrier: slot j % kStages is refilled by the lane that read it
  auto issue = [&](int j) {
    unsigned char* ks = ring + (j % kStages) * 2 * tile_bytes;
    unsigned char* vs = ks + tile_bytes;
    const int base = c_lo + (i_first + j * kWarps) * kt;
#pragma unroll
    for (int st = 0; st < kTileSteps; ++st) {
      const int r = st * kpw + slot;
      const int p = base + r;
      const bool valid = p >= lo && p <= hi;
      const long long off = valid ? rowoff[p - c_lo] : 0;
#pragma unroll
      for (int u = 0; u < VPL; ++u) {
        const int vi = sub + G * u;
        if (vi < nvec) {
          cp_async16(ks + (r * nvec + vi) * 16, kp + off + vi * E, valid);
          cp_async16(vs + (r * nvec + vi) * 16, vp + off + vi * E, valid);
        }
      }
    }
  };
  // the first tiles are in flight before q is read
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) issue(s);
    cp_async_commit();
  }
  const T* qp = static_cast<const T*>(P.q);
  float qf[GH][CH];
#pragma unroll
  for (int hh = 0; hh < GH; ++hh)
#pragma unroll
    for (int u = 0; u < VPL; ++u) {
      const int vi = sub + G * u;
      if (hh < ng && vi < nvec) {
        widen<T>(__ldg(reinterpret_cast<const uint4*>(qp + (qrow0 + hh) * hd +
                                                      vi * E)),
                 &qf[hh][u * E]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) qf[hh][u * E + e] = 0.f;
      }
    }
  float m[GH], l[GH], acc[GH][CH];
#pragma unroll
  for (int hh = 0; hh < GH; ++hh) {
    m[hh] = -INFINITY;
    l[hh] = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c) acc[hh][c] = 0.f;
  }

  if (ntiles > 0) {
    for (int t = 0; t < ntiles; ++t) {
      if (t + kStages - 1 < ntiles) issue(t + kStages - 1);
      cp_async_commit();
      cp_async_wait<kStages - 1>();         // tile t has landed
      const unsigned char* ks = ring + (t % kStages) * 2 * tile_bytes;
      const unsigned char* vs = ks + tile_bytes;
      const int base = c_lo + (i_first + t * kWarps) * kt;

      // scores of this lane group's keys, for every head of the slice
      float sc[kTileSteps][GH];
#pragma unroll
      for (int st = 0; st < kTileSteps; ++st) {
        const int r = st * kpw + slot;
        float s[GH];
#pragma unroll
        for (int hh = 0; hh < GH; ++hh) s[hh] = 0.f;
#pragma unroll
        for (int u = 0; u < VPL; ++u) {
          const int vi = sub + G * u;
          if (vi < nvec) {
            float kf[E];
            widen<T>(lds128(ks + (r * nvec + vi) * 16), kf);
#pragma unroll
            for (int hh = 0; hh < GH; ++hh)
#pragma unroll
              for (int e = 0; e < E; ++e)
                s[hh] = fmaf(qf[hh][u * E + e], kf[e], s[hh]);
          }
        }
        // sum over the lane group: every level shuffles (no branch, so no
        // divergence checks around the shuffles), those past the group
        // add zero
#pragma unroll
        for (int hh = 0; hh < GH; ++hh)
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {    // the levels o < G count
            const float y = __shfl_xor_sync(kFull, s[hh], o);
            s[hh] += o < G ? y : 0.f;
          }
        const int p = base + r;
        const bool live = p >= lo && p <= hi;
#pragma unroll
        for (int hh = 0; hh < GH; ++hh)
          sc[st][hh] = !live ? -INFINITY
                             : (R.masked ? kNegInf : s[hh] * scale2);
      }
      // the tile's max across the warp; rescale once a tile
#pragma unroll
      for (int hh = 0; hh < GH; ++hh) {
        float mx = sc[0][hh];
#pragma unroll
        for (int st = 1; st < kTileSteps; ++st) mx = fmaxf(mx, sc[st][hh]);
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {      // the levels o >= G count
          const float y = __shfl_xor_sync(kFull, mx, o);
          mx = o >= G ? fmaxf(mx, y) : mx;
        }
        const float m_new = fmaxf(m[hh], mx);
        if (m_new != m[hh]) {    // warp-uniform; else corr = exp2(0) = 1
          const float corr = exp2f(m[hh] - m_new);
          m[hh] = m_new;
          l[hh] *= corr;
#pragma unroll
          for (int c = 0; c < CH; ++c) acc[hh][c] *= corr;
        }
      }
#pragma unroll
      for (int st = 0; st < kTileSteps; ++st) {
        const int r = st * kpw + slot;
        float pr[GH];
#pragma unroll
        for (int hh = 0; hh < GH; ++hh) {
          const float p = exp2f(sc[st][hh] - m[hh]);
          l[hh] += p;
          pr[hh] = cvt::to_f(cvt::from_f<T>(p));   // p in v's type for PV
        }
#pragma unroll
        for (int u = 0; u < VPL; ++u) {
          const int vi = sub + G * u;
          if (vi < nvec) {
            float vf[E];
            widen<T>(lds128(vs + (r * nvec + vi) * 16), vf);
#pragma unroll
            for (int hh = 0; hh < GH; ++hh)
#pragma unroll
              for (int e = 0; e < E; ++e)
                acc[hh][u * E + e] = fmaf(pr[hh], vf[e], acc[hh][u * E + e]);
          }
        }
      }
    }
    cp_async_wait<0>();
    // fold the lane groups (each summed its own keys at the warp's m)
#pragma unroll
    for (int hh = 0; hh < GH; ++hh)
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {        // o = G, ..., 16
        if (o < G) continue;
        l[hh] += __shfl_xor_sync(kFull, l[hh], o);
#pragma unroll
        for (int c = 0; c < CH; ++c)
          acc[hh][c] += __shfl_xor_sync(kFull, acc[hh][c], o);
      }
  }

  // this warp's (m, l, acc) over its ring (every lane is done with it);
  // a warp with no counted key leaves m = -inf, l = 0, acc = 0
  __syncwarp();
  float* res = reinterpret_cast<float*>(ring);  // m[GH], l[GH], acc[GH][hd]
  if (lane == 0) {
#pragma unroll
    for (int hh = 0; hh < GH; ++hh) {
      res[hh] = m[hh];
      res[GH + hh] = l[hh];
    }
  }
  if (slot == 0) {
#pragma unroll
    for (int hh = 0; hh < GH; ++hh)
#pragma unroll
      for (int u = 0; u < VPL; ++u) {
        const int vi = sub + G * u;
        if (vi < nvec)
#pragma unroll
          for (int e = 0; e < E; ++e)
            res[2 * GH + hh * hd + vi * E + e] = acc[hh][u * E + e];
      }
  }
  __syncthreads();

  // merge the warps in warp order
  for (int i = threadIdx.x; i < ng * hd; i += kThreads) {
    const int hh = i / hd, c = i - hh * hd;
    const float* w_res[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      w_res[w] = reinterpret_cast<const float*>(
          smem + kChunk * sizeof(long long) + (size_t)w * P.warp_bytes);
    float mb = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, w_res[w][hh]);
    float lb = 0.f, ab = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(w_res[w][hh] - mb);
      lb += w_res[w][GH + hh] * wt;
      ab += w_res[w][2 * GH + hh * hd + c] * wt;
    }
    const size_t qrow = qrow0 + hh;
    if (P.nch == 1) {
      static_cast<T*>(P.out)[qrow * hd + c] =
          cvt::from_f<T>(ab / fmaxf(lb, 1e-30f));
    } else {
      const size_t at = qrow * P.nch + chunk;
      P.part_acc[at * hd + c] = ab;
      if (c == 0) {
        P.part_ml[2 * at] = mb;
        P.part_ml[2 * at + 1] = lb;
      }
    }
  }
}

// One block per (row, query head): the live chunks' partials in chunk
// order, out = acc / max(l, 1e-30). A thread owns 4 channels; it issues
// the loads of a batch of chunks' partials before the chunks' weights are
// known, so a merge costs about two memory round trips.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
    merge_kernel(const Params P) {
  constexpr int kBatch = 8;
  extern __shared__ float ws[];            // m[n], then l[n]
  const int heads = P.kh * P.grp;
  const int rh = blockIdx.x;               // b * heads + query head
  const int b = rh / heads;
  const Range R = live_range(P.pos[(size_t)b * P.pos_stride],
                             P.nblk * P.bs, P.window);
  const int c0 = R.first / kChunk;
  const int n = R.last / kChunk - c0 + 1;  // live chunks
  const float* __restrict__ ml = P.part_ml + ((size_t)rh * P.nch + c0) * 2;
  const float* __restrict__ pa =
      P.part_acc + ((size_t)rh * P.nch + c0) * P.hd + 4 * threadIdx.x;
  const bool mine = 4 * (int)threadIdx.x < P.hd;
  // launched as a programmatic dependent of the split kernel: wait for
  // its grid to finish (and its partials to be visible) only here
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  float4 x[kBatch];
#pragma unroll
  for (int j = 0; j < kBatch; ++j)
    if (mine && j < n)
      x[j] = *reinterpret_cast<const float4*>(pa + (size_t)j * P.hd);
  for (int i = threadIdx.x; i < n; i += kMergeThreads) {
    ws[i] = ml[2 * i];
    ws[n + i] = ml[2 * i + 1];
  }
  __syncthreads();
  if (!mine) return;
  float mx = -INFINITY;
  for (int i = 0; i < n; ++i) mx = fmaxf(mx, ws[i]);
  float l = 0.f, a[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i0 = 0; i0 < n; i0 += kBatch) {
    if (i0 > 0) {
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (i0 + j < n)
          x[j] = *reinterpret_cast<const float4*>(pa +
                                                  (size_t)(i0 + j) * P.hd);
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
  const float lf = fmaxf(l, 1e-30f);
  T* out = static_cast<T*>(P.out) + (size_t)rh * P.hd + 4 * threadIdx.x;
#pragma unroll
  for (int e = 0; e < 4; ++e) out[e] = cvt::from_f<T>(a[e] / lf);
}

template <typename T, int VPL, int GH>
cudaError_t launch_split(Params P, cudaStream_t stream) {
  const Geometry geo = geometry(P.hd, (int)sizeof(T));
  const size_t ring = (size_t)kStages * 2 * geo.kt * geo.nvec * 16;
  const size_t res = sizeof(float) * (size_t)GH * (P.hd + 2);
  const size_t body = ((ring > res ? ring : res) + 15) / 16 * 16;
  P.warp_bytes = (int)body;
  // at most 51200 bytes (f32 rows of hd 256); past the default 48 KB
  // (only f32 rows past hd 224) the kernel must be allowed more, on every
  // launch: a function-local static here would be one symbol shared by
  // both libraries that include this header
  const size_t smem = kChunk * sizeof(long long) + (size_t)kWarps * body;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        split_kernel<T, VPL, GH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long blocks =
      (long long)P.rows * P.kh * P.slices * P.nch;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  split_kernel<T, VPL, GH><<<(int)blocks, kThreads, smem, stream>>>(P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || P.nch == 1) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P.rows * P.kh * P.grp);
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
  return cudaLaunchKernelEx(&cfg, merge_kernel<T>, P);
}

// Checks the call and launches the split kernel (and the merge). MaxGH
// bounds the query heads a block may hold in this library (1 where the
// caller has no groups). nch must be ceil(nblk * bs / kChunk), the count
// the wrapper sized the workspace by.
template <typename T, int MaxGH>
cudaError_t run(Params P, cudaStream_t stream) {
  if (P.rows <= 0) return cudaSuccess;
  const int view = P.nblk * P.bs;
  if (P.kh <= 0 || P.grp <= 0 || P.hd <= 0 || P.hd > kMaxHd ||
      (P.hd * (int)sizeof(T)) % 16 != 0 || P.nblk <= 0 || P.bs <= 0 ||
      P.nch != (view + kChunk - 1) / kChunk ||
      2 * sizeof(float) * P.nch > 48 * 1024 ||   // the merge's weights
      (P.nch > 1 && (P.part_acc == nullptr || P.part_ml == nullptr)))
    return cudaErrorInvalidValue;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(P.q) |
                         reinterpret_cast<uintptr_t>(P.k) |
                         reinterpret_cast<uintptr_t>(P.v) |
                         reinterpret_cast<uintptr_t>(P.part_acc);
  if (ptrs % 16 != 0) return cudaErrorInvalidValue;
  const Geometry geo = geometry(P.hd, (int)sizeof(T));
  const bool wide = geo.vpl == 2;        // 2 vectors a lane
  const int max_heads = wide ? kMaxHeads / 2 : kMaxHeads;
  P.slices = (P.grp + max_heads - 1) / max_heads;
  P.slice_heads = (P.grp + P.slices - 1) / P.slices;
  int gh = 1;
  while (gh < P.slice_heads) gh <<= 1;
  if (gh > MaxGH) return cudaErrorInvalidValue;
  if (wide) {                             // only f32 rows are that wide
    if constexpr (sizeof(T) == 4) {
      if (gh == 1) return launch_split<T, 2, 1>(P, stream);
      if constexpr (MaxGH >= 2)
        if (gh == 2) return launch_split<T, 2, 2>(P, stream);
      if constexpr (MaxGH >= 4)
        if (gh == 4) return launch_split<T, 2, 4>(P, stream);
    }
    return cudaErrorInvalidValue;
  }
  if (gh == 1) return launch_split<T, 1, 1>(P, stream);
  if constexpr (MaxGH >= 2)
    if (gh == 2) return launch_split<T, 1, 2>(P, stream);
  if constexpr (MaxGH >= 4)
    if (gh == 4) return launch_split<T, 1, 4>(P, stream);
  if constexpr (MaxGH >= 8)
    if (gh == 8) return launch_split<T, 1, 8>(P, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace dsplit
