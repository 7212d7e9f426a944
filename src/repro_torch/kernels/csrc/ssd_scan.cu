// ssd_scan on Hopper: replaces the Pallas kernel repro/kernels/ssd_scan.py
// (ssd_scan) and the elementwise set-up of its wrapper
// repro/kernels/ops.py (ssd_scan): the Mamba2 SSD chunk scan, y and the
// final state, from a starting state h0 (the Pallas kernel starts from
// zero; its wrapper sends every call with a state to the plain scan).
//
// Per (batch, head), with A = -exp(a_log), dta = dt * A and xw = x * dt,
// the sequence is walked in chunks of LC rows carrying h (P x N, fp32):
//   l = cumsum(dta) within the chunk
//   y = ((C B^T) * tril(exp(l_t - l_s))) xw + (C h^T) * exp(l) + D x
//   h = h * exp(l_end) + (xw * exp(l_end - l))^T B
// All arithmetic is fp32, as the Pallas body's; x, B and C may be bf16 and
// are widened on load; y and h_fin are written in fp32.
//
// Bound on an H100: per chunk of L rows a head does about 4 L P N + L^2 P
// FLOPs against (P + 1) * L input values and L * P outputs, and the state
// (P x N fp32) is read and written once per call. At serving shapes (a
// 32-token prefill from a fresh state) the state dominates the bytes and
// the call is bound by bytes; at long sequences by fp32 operations (the
// products are fp32, so tensor cores in bf16 do not apply unless the
// inputs are rounded, which the reference does not do).
//
// Design of this first version: simple SIMT fp32. The TPU grid ran the
// chunks of one (batch, head) in order and kept h in VMEM scratch; blocks
// on the GPU run in no order, so one block of 256 threads owns one
// (batch, head) and loops over the chunks itself, with h in shared memory
// for the whole call. The chunk is LC = 64 rows whatever chunk the model
// names (any chunk gives the same function up to rounding): at the
// config's 256 rows and N = 128 the fp32 B and C tiles alone would be
// 256 KB, over the 227 KB a block may have. Shared memory (N = 128, P =
// 64): B and C tiles and h with rows padded to N + 1 floats (so a warp
// walking rows of them hits 32 banks), the xw tile and the masked decay
// matrix, 129 KB, requested with cudaFuncSetAttribute. B and C are read
// once per chunk from their batch's rows, not broadcast per head; x, dt,
// B and C are read through batch and sequence strides (views of the conv
// output), so the wrapper makes no transposed or padded copies. The
// ragged last chunk is masked here: rows past the sequence load dta = 0
// and xw = B = C = 0, so they leave h unchanged (decay 1, no input). The
// decay above the diagonal is never computed (exp of l_t - l_s >= 0 there
// could overflow, and inf * 0 is NaN). Register-blocked or tensor-core
// products, and splitting a long sequence over blocks with a second pass
// for the state, are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int LC = 64;              // rows per chunk
constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;    // bytes a block may use on Hopper

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ xh, const float* __restrict__ dt,
                    const T* __restrict__ bm, const T* __restrict__ cm,
                    const float* __restrict__ a_log,
                    const float* __restrict__ d_skip,
                    const float* __restrict__ h0, float* __restrict__ y,
                    float* __restrict__ h_fin, int seq, int nh, int P, int N,
                    long long xs_b, long long xs_s, long long dts_b,
                    long long dts_s, long long bs_b, long long bs_s,
                    long long cs_b, long long cs_s) {
  extern __shared__ float smem[];
  const int NP = N + 1;             // padded row stride of B, C and h
  float* bs = smem;                 // (LC, NP) B rows of the chunk
  float* cs = bs + LC * NP;         // (LC, NP) C rows
  float* xw = cs + LC * NP;         // (LC, P)  x * dt
  float* hs = xw + LC * P;          // (P, NP)  the carried state
  float* ms = hs + P * NP;          // (LC, LC) (C B^T) * decay, lower part
  float* ls = ms + LC * LC;         // (LC,)    cumulative log-decay
  float* ws = ls + LC;              // (LC,)    exp(l_end - l)

  const int batch = blockIdx.x / nh;
  const int head = blockIdx.x % nh;
  const int tid = threadIdx.x;
  const float a = -expf(a_log[head]);
  const float dsk = d_skip[head];
  const size_t hoff = ((size_t)batch * nh + head) * P * N;

  for (int i = tid; i < P * N; i += kThreads)
    hs[(i / N) * NP + i % N] = h0 != nullptr ? h0[hoff + i] : 0.f;

  const T* xb = xh + batch * xs_b + (size_t)head * P;
  const float* dtb = dt + batch * dts_b + head;
  const T* bb = bm + batch * bs_b;
  const T* cb = cm + batch * cs_b;
  float* yb = y + ((size_t)batch * seq * nh + head) * P;

  for (int c0 = 0; c0 < seq; c0 += LC) {
    const int len = min(LC, seq - c0);
    __syncthreads();                // the last chunk's readers are done
    for (int i = tid; i < LC * N; i += kThreads) {
      const int t = i / N, n = i % N;
      const bool live = t < len;
      bs[t * NP + n] = live ? to_f(bb[(c0 + t) * bs_s + n]) : 0.f;
      cs[t * NP + n] = live ? to_f(cb[(c0 + t) * cs_s + n]) : 0.f;
    }
    for (int i = tid; i < LC * P; i += kThreads) {
      const int t = i / P, p = i % P;
      xw[i] = t < len ? to_f(xb[(c0 + t) * xs_s + p]) * dtb[(c0 + t) * dts_s]
                      : 0.f;
    }
    if (tid < 32) {
      // inclusive prefix sum of dta over the chunk: each lane sums K
      // consecutive rows, then the lanes' totals are scanned by shuffles
      constexpr int K = LC / 32;
      float v[K];
      float run = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int t = tid * K + j;
        run += t < len ? dtb[(c0 + t) * dts_s] * a : 0.f;
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
      for (int j = 0; j < K; ++j) ls[tid * K + j] = excl + v[j];
    }
    __syncthreads();

    // the rows past len repeat l[len - 1] (dta = 0), so l_end is the last
    // live row's
    const float lend = ls[LC - 1];
    for (int t = tid; t < LC; t += kThreads) ws[t] = expf(lend - ls[t]);
    for (int i = tid; i < LC * LC; i += kThreads) {
      const int t = i / LC, s = i % LC;
      float m = 0.f;
      if (s <= t && t < len) {
        float acc = 0.f;
        for (int n = 0; n < N; ++n) acc += cs[t * NP + n] * bs[s * NP + n];
        m = acc * expf(ls[t] - ls[s]);
      }
      ms[i] = m;
    }
    __syncthreads();

    // y = intra (M xw) + inter (C h^T * exp(l)) + D x, from the h of the
    // chunk's start
    for (int i = tid; i < len * P; i += kThreads) {
      const int t = i / P, p = i % P;
      float intra = 0.f;
      for (int s = 0; s <= t; ++s) intra += ms[t * LC + s] * xw[s * P + p];
      float inter = 0.f;
      for (int n = 0; n < N; ++n) inter += cs[t * NP + n] * hs[p * NP + n];
      const float xv = to_f(xb[(c0 + t) * xs_s + p]);
      yb[(size_t)(c0 + t) * nh * P + p] =
          (intra + inter * expf(ls[t])) + xv * dsk;
    }
    __syncthreads();

    // h = h * exp(l_end) + sum_s xw_s exp(l_end - l_s) B_s
    const float dec = expf(lend);
    for (int i = tid; i < P * N; i += kThreads) {
      const int p = i / N, n = i % N;
      float acc = 0.f;
      for (int s = 0; s < len; ++s)
        acc += xw[s * P + p] * ws[s] * bs[s * NP + n];
      hs[p * NP + n] = hs[p * NP + n] * dec + acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += kThreads)
    h_fin[hoff + i] = hs[(i / N) * NP + i % N];
}

size_t smem_bytes(int P, int N) {
  return sizeof(float) * ((size_t)2 * LC * (N + 1) + (size_t)LC * P +
                          (size_t)P * (N + 1) + LC * LC + 2 * LC);
}

template <typename T>
cudaError_t launch(const void* xh, const void* dt, const void* b,
                   const void* c, const void* a_log, const void* d_skip,
                   const void* h0, void* y, void* h_fin, int batch, int seq,
                   int nh, int P, int N, long long xs_b, long long xs_s,
                   long long dts_b, long long dts_s, long long bs_b,
                   long long bs_s, long long cs_b, long long cs_s,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(P, N);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  ssd_scan_kernel<T><<<batch * nh, kThreads, smem, stream>>>(
      static_cast<const T*>(xh), static_cast<const float*>(dt),
      static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<const float*>(a_log), static_cast<const float*>(d_skip),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(h_fin), seq, nh, P, N, xs_b, xs_s, dts_b, dts_s,
      bs_b, bs_s, cs_b, cs_s);
  return cudaGetLastError();
}

}  // namespace

// xh: (batch, seq, nh, P) with batch / sequence strides xs_b / xs_s and
// (head, channel) contiguous; dt: (batch, seq, nh) fp32, strides dts_b /
// dts_s, heads contiguous; b, c: (batch, seq, N), strides bs_* / cs_*, N
// contiguous; a_log, d_skip: (nh,) fp32; h0: (batch, nh, P, N) fp32 or
// null for zeros; y: (batch, seq, nh, P) fp32 and h_fin: (batch, nh, P, N)
// fp32, contiguous. Strides are in elements. dtype (of xh, b and c) 0 is
// float32, 1 is bfloat16. Returns the launch error (0 on success).
extern "C" int ssd_scan_launch(const void* xh, const void* dt, const void* b,
                               const void* c, const void* a_log,
                               const void* d_skip, const void* h0, void* y,
                               void* h_fin, int batch, int seq, int nh, int P,
                               int N, long long xs_b, long long xs_s,
                               long long dts_b, long long dts_s,
                               long long bs_b, long long bs_s, long long cs_b,
                               long long cs_s, int dtype, void* stream) {
  if (batch <= 0 || nh <= 0 || P <= 0 || N <= 0 || seq < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(xh, dt, b, c, a_log, d_skip, h0, y, h_fin,
                              batch, seq, nh, P, N, xs_b, xs_s, dts_b, dts_s,
                              bs_b, bs_s, cs_b, cs_s, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(xh, dt, b, c, a_log, d_skip, h0, y,
                                      h_fin, batch, seq, nh, P, N, xs_b,
                                      xs_s, dts_b, dts_s, bs_b, bs_s, cs_b,
                                      cs_s, s);
  return (int)cudaErrorInvalidValue;
}
