// Chunked-prefill paged attention for Hopper (sm_90a), fp32 arithmetic.
//
// Replaces the Pallas TPU kernel
// paddle_tpu/ops/pallas/paged_attention.py::chunk_prefill_attention_kernel
// (body _chunk_kernel).  One sequence's prefill chunk q[n, H, D]: row r sits
// at position start + r and attends causally to keys [0, start + r], read
// through the sequence's page table [max_pages] (prefix and the chunk's own
// keys, which the caller scattered into the pools first).  Rows past the
// chunk's real length are padding: they compute at their nominal positions
// like the others and the caller discards them.  Every row sees key 0, so
// every output row is written.
//
// What bounds it on an H100.  Each staged K/V row serves the 16 rows of a
// tile, so the fp32 FMAs of the visible (row, key) pairs outweigh the
// bytes once the prefix is long: the main path's chunk (n 64 at start
// 536; H 12, D 64, page 16) does 0.112 GFLOP, 1.67 us at the 67 TFLOP/s
// fp32 FMA rate, and reads 4.1 MB of f32 K/V (1.3 MB int8), 1.2 us at
// 3.35 TB/s: operations bound it.  The first version walked each 8-row
// tile's pages one after another in one block, a barrier and a global
// round trip a page with no load in flight during the products: 96
// blocks, 134.5 us (f32) and 162.1 us (int8), slower than its plain
// version.
//
// Design.  The chunk is one descriptor of the ragged kernel (lens [n],
// kv_lens [start + n]), so it runs the ragged kernel's split walk
// (rpa_walk_item in paged_attention_common.cuh): items of (16-row tile,
// split of >= 64 keys, head), the splits' pages in flight by cp.async, a
// tile's splits merged in a fixed order by its last block.  start and n
// are host ints, so the host knows the items: the grid is exactly the
// items times H, with no descriptor scan and no block that exits idle (at
// the main shape 9 + 9 + 10 + 10 = 38 items x 12 heads = 456 blocks).  A
// block finds its (tile, split) from blockIdx.x by counting each tile's
// splits (rpa_tile_splits, arithmetic only), tiles from the last to the
// first: the tiles with the most splits come first.
// ops/paged_attention.py::chunk_work_items mirrors the items in order.

#include "paged_attention_common.cuh"

// Grid: one block per (item, head), head fastest.  __launch_bounds__ as
// the ragged kernel's: 4 blocks an SM keep every instantiation unspilled.
template <typename KV, int VEC, int NDC>
__global__ void __launch_bounds__(RPA_THREADS, 4)
cpa_kernel(const float* __restrict__ q, const KV* __restrict__ k_pool,
           const KV* __restrict__ v_pool, const float* __restrict__ k_scale,
           const float* __restrict__ v_scale, long long s_page, long long s_row,
           long long s_head, const int* __restrict__ page_table,
           int max_pages, int start, float* __restrict__ out,
           float* __restrict__ ws, int* __restrict__ counters, int n, int H,
           int D, int page_size, float scale, bool q_async) {
  const int h = blockIdx.x % H;
  int split = blockIdx.x / H;
  int t = (n - 1) / RPA_QB, n_splits;
  for (;; --t) {  // the grid holds exactly the items: t stays >= 0
    n_splits = rpa_tile_splits(n, start + n, t, page_size, max_pages);
    if (split < n_splits) break;
    split -= n_splits;
  }
  const int row0 = t * RPA_QB;
  rpa_walk_item<KV, VEC, NDC>(
      q, k_pool, v_pool, k_scale, v_scale, s_page, s_row, s_head,
      page_table, max_pages, row0, min(RPA_QB, n - row0), split, n_splits,
      start + row0, h, out, ws, counters, H, D, page_size, scale, q_async);
}

// q/out [n, H, D] f32 contiguous; pools f32, bf16 or int8 (kv_dtype 0, 1,
// 2), with element strides s_page/s_row/s_head and a unit D stride; an int8
// pool's k_scale/v_scale [P, H] f32 (NULL for float pools); page_table
// [max_pages] int32; start >= 0 the chunk's first position; ws f32 scratch
// of n * H * MS * DR floats on a 16-byte boundary and counters int32
// [n * H], zero, as rpa_ragged_paged_attention's.  Returns the CUDA error
// code of the launch (0 on success).
extern "C" int cpa_chunk_prefill_attention(
    const void* q, const void* k_pool, const void* v_pool, int kv_dtype,
    const void* k_scale, const void* v_scale, long long s_page,
    long long s_row, long long s_head, const void* page_table, int max_pages,
    int start, void* out, void* ws, void* counters, int n, int H, int D,
    int page_size, float scale, void* stream) {
  if (n <= 0 || H <= 0) return 0;
  if (start < 0 ||
      pa_bad_args(kv_dtype, k_scale, v_scale, D, page_size, max_pages))
    return (int)cudaErrorInvalidValue;
  long long items = 0;
  for (int t = 0; t * RPA_QB < n; ++t)
    items += rpa_tile_splits(n, start + n, t, page_size, max_pages);
  const bool q_async = pa_q_async(q, D);
  return pa_dispatch(kv_dtype, k_pool, v_pool, D, [&](auto inst) {
    using I = decltype(inst);
    return pa_launch<I>(
        cpa_kernel<typename I::KV, I::VEC, I::NDC>, items * H, D, page_size,
        static_cast<cudaStream_t>(stream), q, k_pool, v_pool, k_scale,
        v_scale, s_page, s_row, s_head, page_table, max_pages, start, out,
        ws, counters, n, H, D, page_size, scale, q_async);
  });
}
