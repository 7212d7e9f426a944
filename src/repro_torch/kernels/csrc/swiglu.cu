// swiglu_ffn on Hopper: replaces the Pallas kernel repro/kernels/swiglu.py
// (swiglu_ffn), the dense fused GLU FFN of the calibration forward and of
// zamba2's shared block.
//
// Bound on an H100 at the calibration shapes (T=512, d=1024, f=2816, bf16):
// 8.86 GFLOP against 19.4 MB of inputs and output, so compute-bound on the
// bf16 tensor cores (about 9.0 us at 989 TFLOP/s; the bytes alone take about
// 5.8 us at 3.35 TB/s). At zamba2's decode (T=4, d=2048, f=8192) it streams
// 100.7 MB of weights: bound by bytes, about 0.030 ms.
//
// Two entries, chosen by swiglu.route(dtype, d, f) in the wrapper:
// * swiglu_ffn_tc_launch: bfloat16 with d and f multiples of 8 (every
//   config's widths), on the tensor cores through ffn_tc.cuh (TMA ring,
//   wgmma, E = 1 and C = T);
// * swiglu_ffn_launch: float32 at any width, and bf16 off that grid, on the
//   SIMT core ffn_core.cuh in fp32 FMA (exact in f32, where TF32 is not).
//   Its 64 x 64 output tiles walk the weight tiles in the same column order
//   across row tiles, so weight tiles are reused from L2.
#include "ffn_core.cuh"
#include "ffn_tc.cuh"

extern "C" int swiglu_ffn_launch(const void* x, const void* wg, const void* wu,
                                 const void* wd, void* h, void* out, int t,
                                 int d, int f, int dtype, int act,
                                 void* stream) {
  return ffn::run_ffn_dtype(dtype, x, nullptr, wg, wu, wd, h, out, t, d, f,
                            /*num_experts=*/1, ffn::kDense, /*block_c=*/1,
                            /*top_k=*/1, act, stream);
}

// x: (t, d); wg, wu: (d, f); wd: (f, d); h: (t, f) scratch; out: (t, d);
// bfloat16, contiguous, 16-byte aligned, d and f multiples of 8. Returns
// the first launch error (0 on success).
extern "C" int swiglu_ffn_tc_launch(const void* x, const void* wg,
                                    const void* wu, const void* wd, void* h,
                                    void* out, int t, int d, int f, int act,
                                    void* stream) {
  return ffn_tc::run<ffn_tc::kCapacity>(x, nullptr, wg, wu, wd, h, out,
                                        /*E=*/1, /*C=*/t, /*x_rows=*/t, d, f,
                                        /*top_k=*/1, act, stream);
}
