// moe_gather on Hopper: replaces the Pallas kernel
// repro/kernels/moe_gather.py (moe_gather), the routed experts at decode,
// one row per (token, expert) pair with no gathered weight copies. Two
// entries, chosen by moe_gather.route(dtype, d, m) in the wrapper.
//
// Bound on an H100: negligible FLOPs against the live expert slabs, so
// memory-bound. At qwen's serving decode (4 tokens x top-3 = 12 rows, at
// most 5 distinct experts of m=352, d=1024) at most 10.8 MB, about 3.2 us;
// at deepseek-v2's (24 rows, about 21 distinct of its 160 experts of 5120 x
// 1536) about 0.99 GB, 0.31 ms; its mixed steps run up to 156 rows.
// * moe_gather_tc_launch: bfloat16 with d and m multiples of 8 (every
//   config's expert widths), on the tensor cores through ffn_tc.cuh (rule
//   kGather). The block of the first row of each run of 64 rows of one
//   expert gathers their token rows (1-row TMA boxes into the swizzled A
//   tile) and streams that expert's B tiles once for all of them, with no
//   sort and no host sync; the other blocks exit. So each live slab is
//   read once a call, whatever the rows that share it, and a row gives
//   bitwise what moe_gmm_ragged and moe_gmm give it on the same bank.
// * moe_gather_launch: float32, and bf16 off that grid, on the SIMT core
//   (rule kPerRow of ffn_core.cuh): one block per row and 64 columns,
//   reading its row's expert slab straight from the stacked bank; rows
//   that share an expert re-read the slab from L2.
// On both, the sentinel id E loads nothing, runs no FLOPs and writes an
// exact zero row.
#include "ffn_core.cuh"
#include "ffn_tc.cuh"

extern "C" int moe_gather_launch(const void* xf, const void* eidx,
                                 const void* wg, const void* wu,
                                 const void* wd, void* h, void* out,
                                 int n_rows, int d, int m, int num_experts,
                                 int top_k, int dtype, int act,
                                 void* stream) {
  return ffn::run_ffn_dtype(dtype, xf, static_cast<const int*>(eidx), wg, wu,
                            wd, h, out, n_rows, d, m, num_experts,
                            ffn::kPerRow, /*block_c=*/1, top_k, act, stream);
}

// xf (T, d), eidx (T * top_k,) int32 in [0, E], the banks, h (n, m) and out
// (n, d): bfloat16, contiguous and 16-byte aligned; d and m multiples of 8.
extern "C" int moe_gather_tc_launch(const void* xf, const void* eidx,
                                    const void* wg, const void* wu,
                                    const void* wd, void* h, void* out,
                                    int t, int n_rows, int d, int m,
                                    int num_experts, int top_k, int act,
                                    void* stream) {
  return ffn_tc::run<ffn_tc::kGather>(xf, static_cast<const int*>(eidx), wg,
                                      wu, wd, h, out, num_experts, n_rows, t,
                                      d, m, top_k, act, stream);
}
