// ssd_scan on Hopper: replaces the Pallas kernel repro/kernels/ssd_scan.py
// (ssd_scan) and the elementwise set-up of its wrapper
// repro/kernels/ops.py (ssd_scan): the Mamba2 SSD chunk scan, y and the
// final state, from a starting state h0 (the Pallas kernel starts from
// zero; its wrapper sends every call with a state to the plain scan).
//
// Per (batch, head), with A = -exp(a_log), dta = dt * A and xw = x * dt,
// the sequence is cut in chunks of L rows and h (P x N, fp32) carried:
//   l = cumsum(dta) within the chunk
//   y = ((C B^T) * tril(exp(l_t - l_s))) xw + (C h^T) * exp(l) + D x
//   h = h * exp(l_end) + (xw * exp(l_end - l))^T B
// The arithmetic keeps fp32's accuracy, as the Pallas body's fp32 does
// (the products as 3xTF32 on the tensor cores, below); x, B and C may be
// bf16 and are widened on load; y and h_fin are written in fp32.
//
// Bound on an H100: per chunk a head does 2 L P N FMAs for C h^T, as many
// for the state, and L^2 P / 2 for the masked product; C B^T (L^2 N / 2) is
// the same for every head of a batch row (one B/C group). The state (P x N
// fp32) is read and written once per call. A prefill of 32 tokens from a
// fresh state is bound by those bytes; a long sequence by fp32 operations.
//
// Design: the SSD chunked form (arXiv:2405.21060, section 7), in at most
// three kernels, each a grid of independent blocks of 256 threads over
// (head slice, chunk, batch row), so a long sequence fills the card:
//   1. chunk_states (chunks 0 .. nc-2): S_c = (xw * exp(l_end - l))^T B,
//      the chunk's state from zero, and l_end; into a workspace.
//   2. state_pass, one thread per 4 state entries of a (batch, head):
//      h_{c+1} = h_c * exp(l_end,c) + S_c from h0, written over S_c, so the
//      workspace then holds the start state of chunks 1 .. nc-1.
//   3. chunk_out (every chunk): y from the chunk's start state (h0 or the
//      workspace); the last chunk's block also writes h_fin.
// A call of one chunk (every prefill of <= 64 tokens) runs only chunk_out:
// no workspace, no second launch. The chunk is L = 64 rows (32 when the
// sequence fits in 32, so no row of a tile is padding, or when N > 128, so
// a block fits in shared memory); the function does not depend on it.
// The model's chunk of 256 is not used: its B and C tiles alone would
// exceed a block's shared memory.
//
// Filling the card: a chunk_out block takes one chunk of one batch row,
// a slice of up to 64 of a head's channels (the columns p of y and rows p
// of h are independent: only M = (C B^T) * decay is shared across them)
// and hg heads in turn. It computes C B^T once, in registers, and reuses
// it for each of its heads; the wrapper picks hg so that at least three
// blocks per SM remain (4 at 2 x 2048, 1 at the 4 x 32 prefill). While a
// head computes, the block's cp.async copies bring the next head's start
// state, raw x rows and dt into a second buffer set, so only the first
// head of a block waits on memory.
//
// The products run on the tensor cores (mma.sync m16n8k8, TF32 in, fp32
// sums), one warp a 16-row tile: C B^T, M xw and C h^T (16 x L/2 tiles,
// 8 warps over L x 64) and the state (16 x NCAP/2, 8 warps over 64 x
// NCAP). TF32 alone keeps about three digits, under the 1e-4 x max|ref|
// the kernel is held to, so an fp32 operand is split as hi + lo (3xTF32:
// hi*lo + lo*hi + hi*hi, about fp32's accuracy). bf16 B and C are exact
// in TF32 and go in unsplit: C B^T takes one pass, C h^T and the state
// two, M xw three; fp32 B and C (the f32 model) take three everywhere.
// Fragments are read from [row][k] shared rows padded to 4 mod 32 floats,
// 32 distinct banks a load. (An fp32 SIMT version of this design, with
// register-blocked 4 x 4 tiles, was bound by its shared loads and slower.)
//
// Traps kept: exp(l_t - l_s) is one exponent, computed only for s <= t (l
// is a running sum of dta <= 0, so exp(-l_s) alone overflows in a long
// chunk, and inf * 0 is NaN); every other exponent (exp(l), exp(l_end -
// l), exp(l_end)) is <= 1. Rows past the sequence load dta = 0 and xw = B
// = C = 0, so they leave h unchanged. The kernels allocate nothing: the
// wrapper hands over the workspace, y and h_fin; nothing synchronises with
// the host, so a call can be captured in a CUDA graph. x, B and C come in
// 16-byte loads where their rows allow, each thread issuing all its loads
// before its first store (a loop of load-then-store waits out one memory
// latency per element); y and h_fin go out in whole 32-byte sectors (h_fin
// through shared memory). The dynamic shared memory attribute is set on
// every launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // 8 warps: 4 row x 2 column blocks
constexpr int kPS = 64;             // head channels a block takes
constexpr int kMaxSmem = 232448;    // bytes a block may use on Hopper

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Everything a launch needs, passed by value. Strides are in elements. The
// workspace holds the (nc - 1) chunk states of every (batch, head) as
// ws[b][c][head][p][N4] (N4 = N rounded up to 4) and lend[b][c][head].
struct Scan {
  const void* xh;
  const float* dt;
  const void* bm;
  const void* cm;
  const float* a_log;
  const float* d_skip;
  const float* h0;
  float* y;
  float* h_fin;
  float* ws;
  float* lend;
  int seq, nh, P, N, N4, nc, hg;
  long long xs_b, xs_s, dts_b, dts_s, bs_b, bs_s, cs_b, cs_s;

  __device__ size_t state(int b, int c, int h) const {
    return (((size_t)b * (nc - 1) + c) * nh + h) * (size_t)P * N4;
  }
  __device__ size_t lend_at(int b, int c, int h) const {
    return ((size_t)b * (nc - 1) + c) * nh + h;
  }
};

// Shared memory of one block, in floats. C, B and H rows hold NCAP + 4
// floats, xw^T and M rows L + 4: 4 mod 32 floats each (see warp_mma).
// chunk_out double-buffers what it prefetches for a head (its start state,
// its raw x rows and dt); a raw x row holds kPS + 16 bytes, so the 8 rows
// a quarter warp reads at once fall in 8 distinct bank groups.
template <typename T, int L, int NCAP>
struct Layout {
  static constexpr int NS = NCAP + 4;
  static constexpr int LS = L + 4;
  static constexpr int XRS = kPS + 16 / (int)sizeof(T);      // elements
  static constexpr int XRF = L * XRS * (int)sizeof(T) / 4;   // floats
  // chunk_out
  static constexpr int C = 0;                 // (L, NS)      C rows
  static constexpr int B = C + L * NS;        // (L, NS)      B rows
  static constexpr int H = B + L * NS;        // 2 x (kPS, NS) start state
  static constexpr int X = H + 2 * kPS * NS;  // (kPS, LS)    xw^T
  static constexpr int M = X + kPS * LS;      // (L, LS)      masked C B^T
  static constexpr int XRAW = M + L * LS;     // 2 x (L, XRS) x rows, as T
  static constexpr int DT = XRAW + 2 * XRF;   // 2 x (L,)     dt
  static constexpr int LV = DT + 2 * L;       // (L,)         l
  static constexpr int W = LV + L;            // (L,)         exp(l_end - l)
  static constexpr int END = W + L;
  // chunk_states: B (rows of NCAP + 8: read only as [k][col]), xw^T, one
  // set of raw x rows and dt, l, w
  static constexpr int BS = NCAP + 8;
  static constexpr int SX = L * BS;
  static constexpr int SXRAW = SX + kPS * LS;
  static constexpr int SDT = SXRAW + XRF;
  static constexpr int SL = SDT + L;
  static constexpr int SW = SL + L;
  static constexpr int SEND = SW + L;
};

// 3xTF32: v = hi + lo, both TF32 (10 mantissa bits), to about 2^-22 of
// |v|; hi*lo + lo*hi + hi*hi (in that order, into one fp32 sum) keeps a
// product to about 2^-21, where TF32 alone keeps 2^-11.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  const float r = v - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's product on the tensor cores: acc[j] (the m16n8 tile at rows
// r0 .. r0+15, columns c0 + 8 j ..) += sum over k in [k0, k1) (steps of 8)
// of A[row][k] (scaled by w[k] where SCALE) * B[k][col]. A is stored
// [row][k] (stride as); B [k][col] (stride bs) where KROWS, else [col][k].
// SA / SB: the operand is split into hi + lo (3xTF32); an operand that is
// exact in TF32 (a widened bf16 value: 7 mantissa bits) goes in as it is,
// which leaves 2 passes (one split) or 1 (none), each product still exact
// to fp32's order. With strides of 4 mod 32 floats every fragment load of
// a [row][k] operand hits 32 distinct banks (row g at bank 4 g + k mod 4);
// a [k][col] operand wants 8 mod 32. Accumulator element e of tile j sits
// at row r0 + lane / 4 + 8 (e / 2), column c0 + 8 j + 2 (lane % 4) + e % 2.
template <int NT, bool KROWS, bool SCALE, bool SA, bool SB>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const float* A,
                                         int as, int r0, const float* w,
                                         const float* Bm, int bs, int c0,
                                         int k0, int k1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const float* ap = A + (r0 + g) * as + t4;
#pragma unroll 4
  for (int k = k0; k < k1; k += 8) {
    float av[4] = {ap[k], ap[8 * as + k], ap[k + 4], ap[8 * as + k + 4]};
    if (SCALE) {
      const float w0 = w[k + t4], w1 = w[k + t4 + 4];
      av[0] *= w0, av[1] *= w0, av[2] *= w1, av[3] *= w1;
    }
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (SA)
        split_tf32(av[i], ah[i], al[i]);
      else
        ah[i] = __float_as_uint(av[i]);
    }
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float bv[2];
      if (KROWS) {
        bv[0] = Bm[(k + t4) * bs + c0 + 8 * j + g];
        bv[1] = Bm[(k + t4 + 4) * bs + c0 + 8 * j + g];
      } else {
        const float* bp = Bm + (c0 + 8 * j + g) * bs + k + t4;
        bv[0] = bp[0], bv[1] = bp[4];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (SB)
          split_tf32(bv[i], bh[j][i], bl[j][i]);
        else
          bh[j][i] = __float_as_uint(bv[i]);
      }
    }
    if (SB) {
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(acc[j], ah, bl[j][0], bl[j][1]);
    }
    if (SA) {
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(acc[j], al, bh[j][0], bh[j][1]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[j], ah, bh[j][0], bh[j][1]);
  }
}

// 16-byte loads of x, B and C: 4 float32 or 8 bfloat16 values, widened
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void widen(const uint4& r, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(&r);
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void widen(const uint4& r, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 v = __bfloat1622float2(h[k]);
      f[2 * k] = v.x, f[2 * k + 1] = v.y;
    }
  }
};

// Whether rows of `cols` elements at src (row stride ss) can be read in
// 16-byte loads.
template <typename T>
__device__ bool vec_ok(const T* src, long long ss, int cols) {
  return cols % Vec<T>::kN == 0 &&
         (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
         (ss * (long long)sizeof(T)) % 16 == 0;
}

// dst[t][n] for t < L, n < COLS: rows of a (seq, N) operand from row c0
// on, widened to fp32, zero past len rows and N columns. Every load of a
// thread is issued before the first store.
template <typename T, int L, int COLS>
__device__ void load_rows(float* dst, int ds, const T* src, long long ss,
                          int len, int N) {
  constexpr int V = Vec<T>::kN, PR = COLS / V, IT = L * PR / kThreads;
  static_assert(L * PR % kThreads == 0, "whole loads per thread");
  const int tid = threadIdx.x;
  if (vec_ok(src, ss, N)) {
    uint4 raw[IT];
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int i = it * kThreads + tid, t = i / PR, n = i % PR * V;
      raw[it] = t < len && n < N
                    ? *reinterpret_cast<const uint4*>(src + t * ss + n)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int i = it * kThreads + tid, t = i / PR, n = i % PR * V;
      float f[V];
      Vec<T>::widen(raw[it], f);
#pragma unroll
      for (int k = 0; k < V; k += 4)
        *reinterpret_cast<float4*>(dst + t * ds + n + k) =
            make_float4(f[k], f[k + 1], f[k + 2], f[k + 3]);
    }
    return;
  }
  constexpr int IS = L * COLS / kThreads;
  static_assert(IS % 8 == 0, "batches of 8 loads");
#pragma unroll 1
  for (int it0 = 0; it0 < IS; it0 += 8) {
    float f[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = (it0 + j) * kThreads + tid, t = i / COLS, n = i % COLS;
      f[j] = t < len && n < N ? to_f(src[t * ss + n]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = (it0 + j) * kThreads + tid, t = i / COLS, n = i % COLS;
      dst[t * ds + n] = f[j];
    }
  }
}

// H[p][n] (p < kPS, n < N8 = N rounded up to 8) from rows of src (row
// stride rs): zero past pv rows and N columns. 16-byte cp.async copies when
// N % 4 == 0 and src is 16-byte aligned; the caller waits with
// cp_async_wait_all.
__device__ void load_state(float* H, int hs, const float* src, int rs,
                           int pv, int N) {
  const int N8 = (N + 7) & ~7;
  if ((N & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
      (rs & 3) == 0) {
    const int q8 = N8 / 4;
    for (int i = threadIdx.x; i < kPS * q8; i += kThreads) {
      const int p = i / q8, q = i - p * q8;
      float* d = H + p * hs + 4 * q;
      if (p < pv && 4 * q < N)
        cp_async16(d, src + (size_t)p * rs + 4 * q);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  for (int i = threadIdx.x; i < kPS * N8; i += kThreads) {
    const int p = i / N8, n = i - p * N8;
    H[p * hs + n] = p < pv && n < N ? src[(size_t)p * rs + n] : 0.f;
  }
}

// The start state of head h's rows of the slice for chunk c: h0 (row
// stride N) in chunk 0, else the workspace (row stride N4); null for zeros.
__device__ const float* start_state(const Scan& s, int b, int c, int h,
                                    int p0, int& rs) {
  if (c > 0) {
    rs = s.N4;
    return s.ws + s.state(b, c - 1, h) + (size_t)p0 * s.N4;
  }
  rs = s.N;
  return s.h0 == nullptr
             ? nullptr
             : s.h0 + (((size_t)b * s.nh + h) * s.P + p0) * s.N;
}

// Start copying head h's raw x rows and dt for chunk c, and its start
// state where Hb is not null (chunk_out), into one buffer set (cp.async
// where aligned; the caller waits with cp_async_wait_all), zero past len
// rows, pv channels and N columns.
template <typename T, int L, int NCAP>
__device__ void prefetch_head(const Scan& s, int b, int c, int len, int h,
                              int p0, int pv, float* Hb, T* Xb, float* Db) {
  using Y = Layout<T, L, NCAP>;
  const int tid = threadIdx.x, c0 = c * L;
  int rs = 0;
  const float* hsrc =
      Hb == nullptr ? nullptr : start_state(s, b, c, h, p0, rs);
  if (hsrc != nullptr) load_state(Hb, Y::NS, hsrc, rs, pv, s.N);
  const T* xb = static_cast<const T*>(s.xh) + b * s.xs_b + c0 * s.xs_s +
                (size_t)h * s.P + p0;
  if (vec_ok(xb, s.xs_s, s.P)) {
    constexpr int V = Vec<T>::kN, PR = kPS / V;
    for (int i = tid; i < L * PR; i += kThreads) {
      const int t = i / PR, p = i % PR * V;
      T* d = Xb + t * Y::XRS + p;
      if (t < len && p < pv)
        cp_async16(d, xb + t * s.xs_s + p);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int i = tid; i < L * kPS; i += kThreads) {
      const int t = i / kPS, p = i % kPS;
      Xb[t * Y::XRS + p] = t < len && p < pv ? xb[t * s.xs_s + p]
                                             : static_cast<T>(0.f);
    }
  }
  const float* dtb = s.dt + b * s.dts_b + h + c0 * s.dts_s;
  if (tid < L) {
    if (tid < len)
      cp_async4(Db + tid, dtb + tid * s.dts_s);
    else
      Db[tid] = 0.f;
  }
}

// A head's set-up from its buffer set, once it is in: l (inclusive cumsum
// of dta over the chunk, one warp; rows past len add 0, so they repeat l
// of the last live row) and xw^T[p][t] = x * dt, read as 16-byte rows of
// raw x.
template <typename T, int L, int NCAP>
__device__ void setup_head(const Scan& s, int h, int len, const T* Xb,
                           const float* Db, float* xw, float* lv) {
  using Y = Layout<T, L, NCAP>;
  const int tid = threadIdx.x;
  if (tid < 32) {
    constexpr int K = L / 32;
    const float a = -expf(s.a_log[h]);
    float v[K];
    float run = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int t = tid * K + j;
      run += t < len ? Db[t] * a : 0.f;
      v[j] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += o;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (tid == 0) excl = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) lv[tid * K + j] = excl + v[j];
  }
  constexpr int V = Vec<T>::kN, IT = L * (kPS / V) / kThreads;
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int i = it * kThreads + tid, t = i % L, p = i / L * V;
    float f[V];
    Vec<T>::widen(*reinterpret_cast<const uint4*>(Xb + t * Y::XRS + p), f);
    const float d = Db[t];
#pragma unroll
    for (int k = 0; k < V; ++k) xw[(p + k) * Y::LS + t] = f[k] * d;
  }
}

// Pass 1: the state of each chunk but the last from zero, and its l_end.
// Grid (nh * slices, nc - 1, batch).
template <typename T, int L, int NCAP>
__global__ void __launch_bounds__(kThreads)
    chunk_states_kernel(Scan s) {
  using Y = Layout<T, L, NCAP>;
  constexpr int NT = NCAP / 16;     // 8-column tiles of a warp's state tile
  constexpr bool kExact = sizeof(T) == 2;   // bf16 B and C: exact in TF32
  extern __shared__ __align__(16) float sm[];
  float* Bs = sm;
  float* Xs = sm + Y::SX;
  T* Xraw = reinterpret_cast<T*>(sm + Y::SXRAW);
  float* Dts = sm + Y::SDT;
  float* Ls = sm + Y::SL;
  float* Ws = sm + Y::SW;

  const int nps = (s.P + kPS - 1) / kPS;
  const int h = blockIdx.x / nps, ps = blockIdx.x % nps;
  const int c = blockIdx.y, b = blockIdx.z;
  const int c0 = c * L;
  const int p0 = ps * kPS, pv = min(kPS, s.P - p0);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;

  prefetch_head<T, L, NCAP>(s, b, c, L, h, p0, pv, nullptr, Xraw, Dts);
  load_rows<T, L, NCAP>(Bs, Y::BS, static_cast<const T*>(s.bm) +
                                       b * s.bs_b + c0 * s.bs_s,
                        s.bs_s, L, s.N);
  cp_async_wait_all();
  __syncthreads();
  setup_head<T, L, NCAP>(s, h, L, Xraw, Dts, Xs, Ls);
  __syncthreads();
  if (tid < L) Ws[tid] = expf(Ls[L - 1] - Ls[tid]);
  if (tid == 0 && ps == 0) s.lend[s.lend_at(b, c, h)] = Ls[L - 1];
  __syncthreads();

  // rows p of the warp's tile from pr0, columns n from nc0
  const int pr0 = (w & 3) * 16, nc0 = (w >> 2) * (NCAP / 2);
  float acc[NT][4] = {};
  warp_mma<NT, true, true, true, !kExact>(acc, Xs, Y::LS, pr0, Ws,
                                                   Bs, Y::BS, nc0, 0, L);
  float* out = s.ws + s.state(b, c, h) + (size_t)p0 * s.N4;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int p = pr0 + (lane >> 2) + 4 * e;
      const int n = nc0 + 8 * j + 2 * (lane & 3);
      if (p < pv && n < s.N4)
        *reinterpret_cast<float2*>(out + (size_t)p * s.N4 + n) =
            make_float2(acc[j][e], acc[j][e + 1]);
    }
}

// Pass 2: the start state of chunks 1 .. nc-1, over the chunk states, in
// order of chunks. Grid (ceil(P * N4 / 4 / 256), nh, batch).
__global__ void __launch_bounds__(kThreads) state_pass_kernel(Scan s) {
  const int b = blockIdx.z, h = blockIdx.y;
  const int q4 = s.N4 / 4;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= s.P * q4) return;
  const int p = i / q4, n = 4 * (i - p * q4);
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (s.h0 != nullptr) {
    const float* src = s.h0 + (((size_t)b * s.nh + h) * s.P + p) * s.N;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (n + e < s.N) v[e] = src[n + e];
  }
  for (int c = 0; c < s.nc - 1; ++c) {
    const float dec = expf(s.lend[s.lend_at(b, c, h)]);
    float4* st = reinterpret_cast<float4*>(s.ws + s.state(b, c, h) +
                                           (size_t)p * s.N4 + n);
    const float4 add = *st;
    v[0] = v[0] * dec + add.x;
    v[1] = v[1] * dec + add.y;
    v[2] = v[2] * dec + add.z;
    v[3] = v[3] * dec + add.w;
    *st = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// Pass 3: y of one chunk for hg heads from each head's start state; the
// last chunk also writes h_fin. Grid (nh / hg * slices, nc, batch).
// Blocks of chunk_out that fit on an SM side by side (each also holds 1 KB
// of the SM's 228 KB): two for the small layouts (zamba2's 32-token
// prefill), where registers are then capped at 128 a thread; else one,
// which leaves the compiler up to 255.
template <typename T, int L, int NCAP>
struct OutBlocks {
  static constexpr int value =
      2 * (Layout<T, L, NCAP>::END * 4 + 1024) <= 233472 ? 2 : 1;
};

template <typename T, int L, int NCAP>
__global__ void __launch_bounds__(kThreads, OutBlocks<T, L, NCAP>::value)
    chunk_out_kernel(Scan s) {
  using Y = Layout<T, L, NCAP>;
  constexpr int RT = L / 16;        // 16-row tiles of the chunk
  constexpr int NTY = L / 16;       // 8-column tiles of a C B^T / y tile
  constexpr int NTS = NCAP / 16;    // 8-column tiles of a state tile
  constexpr bool kExact = sizeof(T) == 2;   // bf16 B and C: exact in TF32
  extern __shared__ __align__(16) float sm[];
  float* Cs = sm + Y::C;
  float* Bs = sm + Y::B;
  float* Hs = sm + Y::H;
  float* Xs = sm + Y::X;
  float* Ms = sm + Y::M;
  T* Xraw = reinterpret_cast<T*>(sm + Y::XRAW);
  float* Dts = sm + Y::DT;
  float* Ls = sm + Y::LV;
  float* Ws = sm + Y::W;

  const int nps = (s.P + kPS - 1) / kPS;
  const int grp = blockIdx.x / nps, ps = blockIdx.x % nps;
  const int c = blockIdx.y, b = blockIdx.z;
  const int c0 = c * L, len = min(L, s.seq - c0);
  const int len8 = (len + 7) & ~7, N8 = (s.N + 7) & ~7;
  const int p0 = ps * kPS, pv = min(kPS, s.P - p0);
  const bool last = c == s.nc - 1;
  const bool has_state = c > 0 || s.h0 != nullptr;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  // C B^T and y: the warp's tile is rows t [tr0, tr0 + 16), columns (s of
  // C B^T, p of y) [tc0, tc0 + L / 2)
  const int tr0 = (w % RT) * 16, tc0 = (w / RT) * (L / 2);
  const bool rows_live = tr0 < len;
  const bool g_live = rows_live && tc0 < L;
  const bool g_above = tc0 >= tr0 + 16;          // every s > every t
  const int kmask = min(len8, tr0 + 16);
  // the state: rows p [sr0, sr0 + 16), columns n [sc0, sc0 + NCAP / 2)
  const int sr0 = (w & 3) * 16, sc0 = (w >> 2) * (NCAP / 2);

  prefetch_head<T, L, NCAP>(s, b, c, len, grp * s.hg, p0, pv, Hs, Xraw,
                            Dts);
  load_rows<T, L, NCAP>(Cs, Y::NS, static_cast<const T*>(s.cm) +
                                       b * s.cs_b + c0 * s.cs_s,
                        s.cs_s, len, s.N);
  load_rows<T, L, NCAP>(Bs, Y::NS, static_cast<const T*>(s.bm) +
                                       b * s.bs_b + c0 * s.bs_s,
                        s.bs_s, len, s.N);
  __syncthreads();
  float cb[NTY][4] = {};
  if (g_live && !g_above)
    warp_mma<NTY, false, false, !kExact, !kExact>(
        cb, Cs, Y::NS, tr0, nullptr, Bs, Y::NS, tc0, 0, N8);

  for (int hi = 0; hi < s.hg; ++hi) {
    const int h = grp * s.hg + hi, buf = hi & 1;
    const float* Hb = Hs + buf * kPS * Y::NS;
    const T* Xb = Xraw + buf * L * Y::XRS;
    const float* Db = Dts + buf * L;
    // head h's buffers are in, and every reader of the other set (head
    // h - 1) is done: start head h + 1's copies into it
    cp_async_wait_all();
    __syncthreads();
    if (hi + 1 < s.hg)
      prefetch_head<T, L, NCAP>(s, b, c, len, h + 1, p0, pv,
                                Hs + (buf ^ 1) * kPS * Y::NS,
                                Xraw + (buf ^ 1) * L * Y::XRS,
                                Dts + (buf ^ 1) * L);
    setup_head<T, L, NCAP>(s, h, len, Xb, Db, Xs, Ls);
    __syncthreads();
    if (last && tid < L) Ws[tid] = expf(Ls[L - 1] - Ls[tid]);
    if (g_live) {
#pragma unroll
      for (int j = 0; j < NTY; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = tr0 + g + 8 * (e >> 1);
          const int u = tc0 + 8 * j + 2 * t4 + (e & 1);
          Ms[t * Y::LS + u] =
              !g_above && u <= t ? cb[j][e] * expf(Ls[t] - Ls[u]) : 0.f;
        }
    }
    __syncthreads();

    float ya[NTY][4] = {}, yb[NTY][4] = {};
    if (rows_live) {
      warp_mma<NTY, false, false, true, true>(ya, Ms, Y::LS, tr0, nullptr,
                                              Xs, Y::LS, tc0, 0, kmask);
      if (has_state)
        warp_mma<NTY, false, false, !kExact, true>(
            yb, Cs, Y::NS, tr0, nullptr, Hb, Y::NS, tc0, 0, N8);
      // y in pairs of adjacent channels: a warp's store fills whole
      // 32-byte sectors, 8 rows of 32 bytes
      const float dsk = s.d_skip[h];
      float* yh = s.y + ((size_t)b * s.seq * s.nh + h) * s.P + p0;
      const bool pairs = (s.P & 1) == 0;
#pragma unroll
      for (int j = 0; j < NTY; ++j)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int t = tr0 + g + 4 * e;
          const int p = tc0 + 8 * j + 2 * t4;
          if (t >= len || p >= pv) continue;
          const float el = expf(Ls[t]);
          const float v0 = (ya[j][e] + yb[j][e] * el) +
                           to_f(Xb[t * Y::XRS + p]) * dsk;
          const float v1 = (ya[j][e + 1] + yb[j][e + 1] * el) +
                           to_f(Xb[t * Y::XRS + p + 1]) * dsk;
          float* o = yh + (size_t)(c0 + t) * s.nh * s.P + p;
          if (pairs) {
            *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
          } else {
            o[0] = v0;
            if (p + 1 < pv) o[1] = v1;
          }
        }
    }
    if (!last) continue;

    float acc[NTS][4] = {};
    warp_mma<NTS, true, true, true, !kExact>(
        acc, Xs, Y::LS, sr0, Ws, Bs, Y::NS, sc0, 0, len8);
    // h_fin over the start state in place (each entry read and written by
    // its own thread, once every warp's C h^T is done), then out in
    // 16-byte rows
    const float dec = expf(Ls[L - 1]);
    float* Hw = Hs + buf * kPS * Y::NS;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NTS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float* hv = Hw + (sr0 + g + 8 * (e >> 1)) * Y::NS + sc0 + 8 * j +
                    2 * t4 + (e & 1);
        *hv = has_state ? *hv * dec + acc[j][e] : acc[j][e];
      }
    __syncthreads();
    float* out = s.h_fin + (((size_t)b * s.nh + h) * s.P + p0) * s.N;
    if ((s.N & 3) == 0) {
      const int q4 = s.N / 4;
      for (int i = tid; i < pv * q4; i += kThreads) {
        const int p = i / q4, n = 4 * (i - p * q4);
        *reinterpret_cast<float4*>(out + (size_t)p * s.N + n) =
            *reinterpret_cast<const float4*>(Hw + p * Y::NS + n);
      }
    } else {
      for (int i = tid; i < pv * s.N; i += kThreads) {
        const int p = i / s.N, n = i - p * s.N;
        out[(size_t)p * s.N + n] = Hw[p * Y::NS + n];
      }
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  // on every launch: a function-local static would be one symbol across
  // libraries that include the same code
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int L, int NCAP>
cudaError_t launch_states(const Scan& s, int batch, cudaStream_t st) {
  const size_t smem = sizeof(float) * Layout<T, L, NCAP>::SEND;
  const cudaError_t err = allow_smem(chunk_states_kernel<T, L, NCAP>, smem);
  if (err != cudaSuccess) return err;
  const int nps = (s.P + kPS - 1) / kPS;
  chunk_states_kernel<T, L, NCAP>
      <<<dim3(s.nh * nps, s.nc - 1, batch), kThreads, smem, st>>>(s);
  return cudaGetLastError();
}

template <typename T, int L, int NCAP>
cudaError_t launch_out(const Scan& s, int batch, cudaStream_t st) {
  const size_t smem = sizeof(float) * Layout<T, L, NCAP>::END;
  const cudaError_t err = allow_smem(chunk_out_kernel<T, L, NCAP>, smem);
  if (err != cudaSuccess) return err;
  const int nps = (s.P + kPS - 1) / kPS;
  chunk_out_kernel<T, L, NCAP>
      <<<dim3(s.nh / s.hg * nps, s.nc, batch), kThreads, smem, st>>>(s);
  return cudaGetLastError();
}

// The (dtype, chunk, state width) instantiations: chunk 64 with N <= 128,
// chunk 32 with N <= 256.
template <template <typename, int, int> class F>
cudaError_t dispatch(const Scan& s, int batch, int chunk, int dtype,
                     cudaStream_t st) {
  const int ncap = s.N <= 64 ? 64 : s.N <= 128 ? 128 : s.N <= 256 ? 256 : 0;
  if (ncap == 0 || (chunk != 32 && chunk != 64) ||
      (chunk == 64 && ncap == 256) || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
#define SSD_CASE(T, L, NC)                                  \
  if (chunk == L && ncap == NC) return F<T, L, NC>::run(s, batch, st);
  if (dtype == 0) {
    SSD_CASE(float, 32, 64) SSD_CASE(float, 32, 128) SSD_CASE(float, 32, 256)
    SSD_CASE(float, 64, 64) SSD_CASE(float, 64, 128)
  } else {
    SSD_CASE(__nv_bfloat16, 32, 64) SSD_CASE(__nv_bfloat16, 32, 128)
    SSD_CASE(__nv_bfloat16, 32, 256) SSD_CASE(__nv_bfloat16, 64, 64)
    SSD_CASE(__nv_bfloat16, 64, 128)
  }
#undef SSD_CASE
  return cudaErrorInvalidValue;
}

template <typename T, int L, int NC>
struct StatesLaunch {
  static cudaError_t run(const Scan& s, int batch, cudaStream_t st) {
    return launch_states<T, L, NC>(s, batch, st);
  }
};

template <typename T, int L, int NC>
struct OutLaunch {
  static cudaError_t run(const Scan& s, int batch, cudaStream_t st) {
    return launch_out<T, L, NC>(s, batch, st);
  }
};

bool bad_sizes(int batch, int seq, int nh, int P, int N, int chunk) {
  return batch <= 0 || seq <= 0 || nh <= 0 || P <= 0 || N <= 0 ||
         batch > 65535 || (seq + chunk - 1) / chunk > 65535;
}

}  // namespace

// Operands, for the three entries: xh (batch, seq, nh, P) with batch /
// sequence strides xs_b / xs_s and (head, channel) contiguous; dt (batch,
// seq, nh) fp32, strides dts_b / dts_s, heads contiguous; b, c (batch, seq,
// N), strides bs_* / cs_*, N contiguous; a_log, d_skip (nh,) fp32; h0
// (batch, nh, P, N) fp32 contiguous, or null for zeros; ws the workspace
// (batch, nc - 1, nh, P, N4) fp32 and lend (batch, nc - 1, nh) fp32, nc =
// ceil(seq / chunk), N4 = N rounded up to 4; y (batch, seq, nh, P) and
// h_fin (batch, nh, P, N) fp32, contiguous. Strides are in elements; dtype
// (of xh, b and c) 0 is float32, 1 is bfloat16; chunk is 32 or 64 (32
// where N > 128). Each returns the launch error (0 on success).

// Pass 1 (chunks 0 .. nc-2; needs nc >= 2).
extern "C" int ssd_chunk_states_launch(
    const void* xh, const void* dt, const void* b, const void* a_log,
    void* ws, void* lend, int batch, int seq, int nh, int P, int N,
    long long xs_b, long long xs_s, long long dts_b, long long dts_s,
    long long bs_b, long long bs_s, int chunk, int dtype, void* stream) {
  if (bad_sizes(batch, seq, nh, P, N, chunk) || seq <= chunk)
    return (int)cudaErrorInvalidValue;
  Scan s{};
  s.xh = xh;
  s.dt = static_cast<const float*>(dt);
  s.bm = b;
  s.a_log = static_cast<const float*>(a_log);
  s.ws = static_cast<float*>(ws);
  s.lend = static_cast<float*>(lend);
  s.seq = seq, s.nh = nh, s.P = P, s.N = N, s.N4 = (N + 3) & ~3;
  s.nc = (seq + chunk - 1) / chunk, s.hg = 1;
  s.xs_b = xs_b, s.xs_s = xs_s, s.dts_b = dts_b, s.dts_s = dts_s;
  s.bs_b = bs_b, s.bs_s = bs_s;
  return (int)dispatch<StatesLaunch>(s, batch, chunk, dtype,
                                     static_cast<cudaStream_t>(stream));
}

// Pass 2: over ws in place, from h0 (null: zeros).
extern "C" int ssd_state_pass_launch(const void* h0, void* ws,
                                     const void* lend, int batch, int seq,
                                     int nh, int P, int N, int chunk,
                                     void* stream) {
  if (bad_sizes(batch, seq, nh, P, N, chunk) || seq <= chunk)
    return (int)cudaErrorInvalidValue;
  Scan s{};
  s.h0 = static_cast<const float*>(h0);
  s.ws = static_cast<float*>(ws);
  s.lend = const_cast<float*>(static_cast<const float*>(lend));
  s.seq = seq, s.nh = nh, s.P = P, s.N = N, s.N4 = (N + 3) & ~3;
  s.nc = (seq + chunk - 1) / chunk;
  const int per_head = P * (s.N4 / 4);
  state_pass_kernel<<<dim3((per_head + kThreads - 1) / kThreads, nh, batch),
                      kThreads, 0, static_cast<cudaStream_t>(stream)>>>(s);
  return (int)cudaGetLastError();
}

// Pass 3: y of every chunk and h_fin; ws holds the start states of chunks
// 1 .. nc-1 (unused, may be null, when nc == 1). hg heads a block (a
// divisor of nh).
extern "C" int ssd_chunk_out_launch(
    const void* xh, const void* dt, const void* b, const void* c,
    const void* a_log, const void* d_skip, const void* h0, const void* ws,
    void* y, void* h_fin, int batch, int seq, int nh, int P, int N,
    long long xs_b, long long xs_s, long long dts_b, long long dts_s,
    long long bs_b, long long bs_s, long long cs_b, long long cs_s,
    int chunk, int hg, int dtype, void* stream) {
  if (bad_sizes(batch, seq, nh, P, N, chunk) || hg <= 0 || nh % hg != 0 ||
      (seq > chunk && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  Scan s{};
  s.xh = xh;
  s.dt = static_cast<const float*>(dt);
  s.bm = b;
  s.cm = c;
  s.a_log = static_cast<const float*>(a_log);
  s.d_skip = static_cast<const float*>(d_skip);
  s.h0 = static_cast<const float*>(h0);
  s.ws = const_cast<float*>(static_cast<const float*>(ws));
  s.y = static_cast<float*>(y);
  s.h_fin = static_cast<float*>(h_fin);
  s.seq = seq, s.nh = nh, s.P = P, s.N = N, s.N4 = (N + 3) & ~3;
  s.nc = (seq + chunk - 1) / chunk, s.hg = hg;
  s.xs_b = xs_b, s.xs_s = xs_s, s.dts_b = dts_b, s.dts_s = dts_s;
  s.bs_b = bs_b, s.bs_s = bs_s, s.cs_b = cs_b, s.cs_s = cs_s;
  return (int)dispatch<OutLaunch>(s, batch, chunk, dtype,
                                  static_cast<cudaStream_t>(stream));
}
