// moe_gather on Hopper: replaces the Pallas kernel
// repro/kernels/moe_gather.py (moe_gather), the routed experts at decode,
// one row per (token, expert) pair with no gathered weight copies.
//
// Bound on an H100 at the serving decode shapes (4 tokens x top-3 = 12 rows,
// at most 5 distinct experts of m=352, d=1024, bf16): negligible FLOPs
// against at most 10.8 MB of live expert slabs, so memory-bound (at most
// about 3.2 us at 3.35 TB/s). Each block serves one row and 64 columns,
// reading its row's expert slab straight from the stacked bank; rows that
// share an expert re-read the slab from L2. The sentinel id E loads nothing,
// runs no FLOPs and writes an exact zero row.
#include "ffn_core.cuh"

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
