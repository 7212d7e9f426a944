// The two grouped expert FFNs of repro/kernels/moe_gmm.py on Hopper, one
// library with two entry points over the shared core (ffn_core.cuh): both
// Pallas kernels live in one file and share one body, so their ports share
// one translation unit and one nvcc process.
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
// (about 2.25 ms at 3.35 TB/s). Each weight tile is read by exactly one
// block (one expert's row tiles, and at C <= 64 there is one), so the banks
// stream from device memory once. At C = 8 a 64-row tile computes 56 masked
// rows: the SIMT FMA work is 8x the useful work, the first version's known
// cost beside the h round trip.
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
