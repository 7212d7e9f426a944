// The two grouped expert FFNs of repro/kernels/moe_gmm.py on Hopper, one
// library over the shared cores (ffn_core.cuh, SIMT; ffn_tc.cuh, tensor
// cores): both Pallas kernels live in one file and share one body, so
// their ports share one translation unit and one nvcc process. Each has
// two entries, chosen by moe_gmm.route(dtype, d, m) in the wrappers:
// bfloat16 with d and m multiples of 8 (every config's expert widths) on
// the tensor cores through ffn_tc.cuh (`_tc_launch`), float32 and bf16 off
// that grid on the SIMT core in fp32 FMA (exact in f32, where TF32 is not).
//
// moe_gmm_ragged replaces moe_gmm_ragged, the grouped routed experts over
// the expert-sorted, block-aligned ragged layout at prefill. The layout
// block block_c equals the 64-row CUDA tile, so tile i takes its expert
// from owner[i]. Bound on an H100: at qwen's serving prefill (384 live rows
// of a 704-row layout, 5 experts of m=352, d=1024) 0.83 GFLOP against 12.4
// MB, bytes, about 3.7 us; at deepseek-v2's (768 live rows of 10880, 160
// experts of 5120 x 1536) the live experts' 7.45 GB, bytes, 2.24 ms.
// * moe_gmm_ragged_tc_launch (rule kOwner): a block streams its tile
//   owner's B tiles by TMA into a wgmma ring; all tiles of one expert read
//   the same weight tiles in the same column order, so each expert's slab
//   streams from device memory about once and the rest comes from L2. The
//   zero rows of the layout (the padding of each expert's last tile, the
//   trailing tiles) run as live ones and give exact zeros; their products
//   hide under the weight stream (ffn_tc.cuh's note).
// * moe_gmm_ragged_launch (rule kTileOwner of ffn_core.cuh): 64 x 64 SIMT
//   tiles, at 8x the useful fp32 FMA work on deepseek's padding tiles,
//   which is why it ran near 26.6 ms there.
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

// The tensor-core route of moe_gmm_ragged_launch: xp (P, d) with P a
// multiple of 64, owner (P / 64,) int32, the banks, h (P, m) and out (P, d)
// bfloat16, contiguous and 16-byte aligned; d and m multiples of 8. An
// owner outside [0, E) gives its tile exact zero rows.
extern "C" int moe_gmm_ragged_tc_launch(const void* xp, const void* owner,
                                        const void* wg, const void* wu,
                                        const void* wd, void* h, void* out,
                                        int p_rows, int d, int m,
                                        int num_experts, int act,
                                        void* stream) {
  return ffn_tc::run<ffn_tc::kOwner>(xp, static_cast<const int*>(owner), wg,
                                     wu, wd, h, out, num_experts, p_rows,
                                     p_rows, d, m, /*top_k=*/1, act, stream);
}

// moe_gmm replaces moe_gmm, the expert FFN over dense (E, C, d) capacity
// buffers (the bounded-buffer path: dispatch -> expert_ffn -> combine).
// Each expert runs ceil(C / 64) row tiles and masks the rows past C, so C
// and m need no padding (the JAX wrapper pads both).
//
// Bound on an H100 at deepseek-v2's expert widths (E 160, C 8, d 5120,
// m 1536, bf16): 7.55 GB of weights against 60 GFLOP, so memory-bound
// (about 2.26 ms at 3.35 TB/s).
// * moe_gmm_tc_launch (rule kCapacity): its 3-D tensor maps over (E, C, d)
//   read zeros past C, so at C = 8 a 64-row tile's 56 empty rows cost no
//   bytes, and their products (8x the useful work, about 0.49 ms of
//   tensor-core time) hide under the 2.26 ms of weight streaming. Each
//   weight tile is read by one block.
// * moe_gmm_launch (rule kCapacity of ffn_core.cuh): at C = 8 its 64-row
//   tiles do 8x the useful FMA work in fp32 (about 7.2 ms at 67 TFLOP/s),
//   which is why it runs near 24 ms in bf16 at deepseek's widths.
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
  return ffn_tc::run<ffn_tc::kCapacity>(xbuf, nullptr, wg, wu, wd, h, out,
                                        num_experts, capacity, capacity, d,
                                        m, /*top_k=*/1, act, stream);
}
