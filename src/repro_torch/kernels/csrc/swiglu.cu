// swiglu_ffn on Hopper: replaces the Pallas kernel repro/kernels/swiglu.py
// (swiglu_ffn), the dense fused GLU FFN of the calibration forward.
//
// Bound on an H100 at the calibration shapes (T=512, d=1024, f=2816, bf16):
// 8.86 GFLOP against 19.4 MB of inputs and output, so compute-bound on the
// bf16 tensor cores (about 9.0 us at 989 TFLOP/s; the bytes alone take about
// 5.8 us at 3.35 TB/s). This first version runs the shared SIMT core
// (ffn_core.cuh) in fp32 FMA, not on the tensor cores: it is correct in both
// types and slow against that bound. The 64 x 64 output tiles walk the
// weight tiles in the same column order across row tiles, so weight tiles
// are reused from L2 rather than re-read from device memory.
#include "ffn_core.cuh"

extern "C" int swiglu_ffn_launch(const void* x, const void* wg, const void* wu,
                                 const void* wd, void* h, void* out, int t,
                                 int d, int f, int dtype, int act,
                                 void* stream) {
  return ffn::run_ffn_dtype(dtype, x, nullptr, wg, wu, wd, h, out, t, d, f,
                            /*num_experts=*/1, ffn::kDense, /*block_c=*/1,
                            /*top_k=*/1, act, stream);
}
