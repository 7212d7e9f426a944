// The two grouped expert FFNs of repro/kernels/moe_gmm.py on Hopper, one
// library over the shared cores (ffn_core.cuh, SIMT; ffn_tc.cuh, tensor
// cores): both Pallas kernels live in one file and share one body, so
// their ports share one translation unit and one nvcc process.
//
// moe_gmm_ragged_launch replaces moe_gmm_ragged, the grouped routed experts
// over the expert-sorted, block-aligned ragged layout at prefill.
//
// Bound on an H100 at the serving prefill shapes (384 live rows of a 704-row
// layout, 5 experts of m=352, d=1024, bf16): 0.83 GFLOP against 12.4 MB of
// weights and activations, so memory-bound (about 3.7 us at 3.35 TB/s).
// The layout block block_c equals the 64-row CUDA tile, so tile i takes its
// expert from owner[i]; all tiles of one expert read the same weight tiles in
// the same column order, so each expert's slab streams from device memory
// about once and the rest comes from L2. The h round trip through device
// memory (2 x P x m x 2 B) and the all-zero padding rows of the layout (at
// most 63 per expert) are the known costs of this first version.
#include "ffn_core.cuh"
#include "ffn_tc.cuh"

extern "C" int moe_gmm_ragged_launch(const void* xp, const void* owner,
                                     const void* wg, const void* wu,
                                     const void* wd, void* h, void* out,
                                     int p_rows, int d, int m,
                                     int num_experts, int block_c, int dtype,
                                     int act, void* stream) {
  return ffn::run_ffn_dtype(dtype, xp, static_cast<const int*>(owner), wg,
                            wu, wd, h, out, p_rows, d, m, num_experts,
                            ffn::kTileOwner, block_c, /*top_k=*/1, act,
                            stream);
}

// moe_gmm_launch replaces moe_gmm, the expert FFN over dense (E, C, d)
// capacity buffers (the bounded-buffer path: dispatch -> expert_ffn ->
// combine). Rule kCapacity: row r of the flattened (E * C) buffer belongs to
// expert r / C; each expert runs ceil(C / 64) row tiles and masks the rows
// past C, so C and m need no padding (the JAX wrapper pads both).
//
// Bound on an H100 at deepseek-v2's expert widths (E 160, C 8, d 5120,
// m 1536, bf16): 7.55 GB of weights against 60 GFLOP, so memory-bound
// (about 2.26 ms at 3.35 TB/s). Two entries, chosen by moe_gmm.route(dtype,
// d, m) in the wrapper:
// * moe_gmm_tc_launch: bfloat16 with d and m multiples of 8 (every
//   config's expert widths), on the tensor cores through ffn_tc.cuh. Its
//   3-D tensor maps over (E, C, d) read zeros past C, so at C = 8 a 64-row
//   tile's 56 empty rows cost no bytes, and their products (8x the useful
//   work, about 0.49 ms of tensor-core time) hide under the 2.26 ms of
//   weight streaming. Each weight tile is read by one block.
// * moe_gmm_launch: float32, and bf16 off that grid, on the SIMT core
//   (rule kCapacity). At C = 8 its 64-row tiles do 8x the useful FMA work
//   in fp32 (about 7.2 ms at 67 TFLOP/s), which is why it runs near 24 ms
//   in bf16 at deepseek's widths.
extern "C" int moe_gmm_launch(const void* xbuf, const void* wg,
                              const void* wu, const void* wd, void* h,
                              void* out, int num_experts, int capacity,
                              int d, int m, int dtype, int act,
                              void* stream) {
  return ffn::run_ffn_dtype(dtype, xbuf, nullptr, wg, wu, wd, h, out,
                            num_experts * capacity, d, m, num_experts,
                            ffn::kCapacity, /*block_c=*/capacity,
                            /*top_k=*/1, act, stream);
}

// The tensor-core route of moe_gmm_launch: xbuf, the banks, h and out
// bfloat16, contiguous and 16-byte aligned; d and m multiples of 8.
extern "C" int moe_gmm_tc_launch(const void* xbuf, const void* wg,
                                 const void* wu, const void* wd, void* h,
                                 void* out, int num_experts, int capacity,
                                 int d, int m, int act, void* stream) {
  return ffn_tc::run(xbuf, wg, wu, wd, h, out, num_experts, capacity, d, m,
                     act, stream);
}
