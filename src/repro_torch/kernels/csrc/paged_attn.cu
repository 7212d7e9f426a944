// paged_attn_decode on Hopper: replaces the Pallas kernel
// repro/kernels/paged_attention.py (paged_attn_decode, :86 / :119), GQA
// single-query attention straight off the serving engine's block pool.
//
// Each row b is one query token at logical position pos[b] of its lane;
// table[b, j] names the physical block that holds the lane's logical block
// j. For kv head h, the grp query heads h*grp .. h*grp+grp-1 attend every
// key at a logical position p <= pos[b] (and p > pos[b] - window when
// window > 0) of the row's view (nblk * bs positions); where no key of the
// view passes, every view key counts with the score -1e30 (a uniform
// average), as ref.paged_attn_decode_ref computes.
//
// Bound on an H100: a row reads its lane's live K and V rows once (2 x
// live keys x hd x itemsize a kv head) beside q and out, against 4 x grp x
// hd FLOPs a key, so it is bound by bytes: 268 MB at 32 rows x depth 2048
// x 16 kv heads of 64 in bf16, 0.080 ms at 3.35 TB/s.
//
// Design: the split-KV decode core, csrc/decode_split.cuh (its note says
// what it does about latency and occupancy). The Pallas kernel walks
// every block of the table and masks it; the core reads only the counted
// keys, in chunks of fixed logical positions whatever the pool's block
// size, so a lane read through a paged table and the same lane read from a
// contiguous cache (a pool of one block per lane) give bitwise the same
// output, as do a row alone and inside a call of many rows. Query-head
// groups of any width are sliced over blocks of at most 8 heads (granite's
// 48 per kv head of 128 is 6 slices). The served archs' groups run from
// 1 (qwen, llama2) through 2 (gemma3), 4 (phi3), 5 (llama4) and 6
// (internvl2) to 48 (granite, MQA); each slice's products run as SIMT
// arithmetic, not on the tensor cores.
#include "decode_split.cuh"

// q: (rows, kh * grp, hd); k_pool / v_pool: (nblocks, bs, kh, hd); table:
// (rows, nblk) int32; pos: (rows,) int32; out: like q. part_acc (rows, kh *
// grp, nch, hd) and part_ml (rows, kh * grp, nch, 2), float32, are the
// merge's workspace, nch = ceil(nblk * bs / 256); both may be null where
// nch is 1. hd a multiple of 8 up to 256; q, the pools and part_acc
// 16-byte aligned. dtype 0 is float32, 1 is bfloat16. Returns the launch
// error (0 on success).
extern "C" int paged_attn_decode_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* pos, void* out, void* part_acc, void* part_ml, int rows,
    int kh, int grp, int hd, int nblk, int bs, int window, int nch,
    float scale, int dtype, void* stream) {
  if (hd % 8 != 0) return (int)cudaErrorInvalidValue;
  dsplit::Params P{};
  P.q = q;
  P.k = k_pool;
  P.v = v_pool;
  P.table = static_cast<const int*>(table);
  P.pos = static_cast<const int*>(pos);
  P.out = out;
  P.part_acc = static_cast<float*>(part_acc);
  P.part_ml = static_cast<float*>(part_ml);
  P.rows = rows;
  P.kh = kh;
  P.grp = grp;
  P.hd = hd;
  P.nblk = nblk;
  P.bs = bs;
  P.window = window;
  P.pos_stride = 1;
  P.nch = nch;
  P.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dsplit::run<float, dsplit::kMaxHeads>(P, s);
  if (dtype == 1)
    return (int)dsplit::run<__nv_bfloat16, dsplit::kMaxHeads>(P, s);
  return (int)cudaErrorInvalidValue;
}
