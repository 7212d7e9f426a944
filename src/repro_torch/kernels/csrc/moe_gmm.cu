// moe_gmm_ragged on Hopper: replaces the Pallas kernel
// repro/kernels/moe_gmm.py (moe_gmm_ragged), the grouped routed experts over
// the expert-sorted, block-aligned ragged layout at prefill.
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
