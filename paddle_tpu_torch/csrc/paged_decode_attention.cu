// Paged decode attention for Hopper (sm_90a), fp32 arithmetic.
//
// Replaces the Pallas TPU kernel
// paddle_tpu/ops/pallas/paged_attention.py::paged_decode_attention_kernel
// (body _decode_kernel).  One query row per sequence: q[B, H, D], and
// sequence b attends to its first seq_lens[b] keys through its page table
// page_tables[b, :].  seq_lens[b] == 0 (the fused decode step's dummy rows)
// writes exact zeros.  Pages i with i * page_size >= seq_len are never
// read; page-table padding is page 0, which is always in bounds.
//
// What bounds it on an H100.  Each K/V byte of the visible pages is read
// once and feeds 2 flops (4 D per key for QK and PV), so the bytes over
// 3.35 TB/s bound it: the main path's batch (B 8 over 16..632 keys; H 12,
// D 64, page 16) reads 23.7 MB of f32 K/V, 7.06 us (6.0 MB, 1.78 us
// int8).  Bytes in flight across the card are what reach that rate.  The
// first version ran one block per (row, head), 96 blocks on 132 SMs, its
// 4 warps walking a row's pages in turn with no load in flight during
// the products: 23.9 us (f32) and 67.2 us (int8, which also spilled).
//
// Design.  A decode batch is B one-row descriptors of the ragged kernel
// (lens 1, kv_lens seq_lens), so it runs the ragged kernel's split walk
// (rpa_walk_item in paged_attention_common.cuh): each row's keys cut into
// splits of >= 64 keys, one block a (row, split, head), the split's pages
// in flight by 16-byte cp.async, the 4 warps sharing its keys, a row's
// splits merged in a fixed order by its last block.  seq_lens lives on
// the device and the host reads none of it: the grid is the bound
// B x ceil(max_pages / SP) x H, with b-major items (row b, split k) at
// b * ceil(max_pages / SP) + k; each block reads its row's seq_len and
// leaves at once past the row's splits.  A row that sees no key has no
// split, and its split-0 block writes its zeros.
// ops/paged_attention.py::decode_work_items mirrors the live items.

#include "paged_attention_common.cuh"

// Grid: one block per (row, split, head), head fastest.  __launch_bounds__
// as the ragged kernel's: 4 blocks an SM keep every instantiation
// unspilled.
template <typename KV, int VEC, int NDC>
__global__ void __launch_bounds__(RPA_THREADS, 4)
pda_kernel(const float* __restrict__ q, const KV* __restrict__ k_pool,
           const KV* __restrict__ v_pool, const float* __restrict__ k_scale,
           const float* __restrict__ v_scale, long long s_page, long long s_row,
           long long s_head, const int* __restrict__ page_tables,
           int max_pages, const int* __restrict__ seq_lens,
           float* __restrict__ out, float* __restrict__ ws,
           int* __restrict__ counters, int H, int D, int page_size,
           float scale, bool q_async) {
  const int h = blockIdx.x % H;
  const int ms = rpa_max_splits(max_pages, page_size);
  const int b = blockIdx.x / H / ms;
  const int split = blockIdx.x / H - b * ms;
  const int seq_len = seq_lens[b];
  const int n_splits = rpa_tile_splits(1, seq_len, 0, page_size, max_pages);
  if (split >= n_splits) {
    if (split == 0)  // the row sees no key: exact zeros
      for (int d = threadIdx.x; d < D; d += RPA_THREADS)
        out[((long long)b * H + h) * D + d] = 0.f;
    return;
  }
  rpa_walk_item<KV, VEC, NDC>(
      q, k_pool, v_pool, k_scale, v_scale, s_page, s_row, s_head,
      page_tables + (long long)b * max_pages, max_pages, b, 1, split,
      n_splits, seq_len - 1, h, out, ws, counters, H, D, page_size, scale,
      q_async);
}

// q/out [B, H, D] f32 contiguous; pools f32, bf16 or int8 (kv_dtype 0, 1,
// 2), with element strides s_page/s_row/s_head and a unit D stride; an int8
// pool's k_scale/v_scale [P, H] f32 (NULL for float pools); page_tables
// [B, max_pages] and seq_lens [B] int32; ws f32 scratch of B * H * MS * DR
// floats on a 16-byte boundary and counters int32 [B * H], zero, as
// rpa_ragged_paged_attention's.  Returns the CUDA error code of the
// launch (0 on success).
extern "C" int pda_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, int kv_dtype,
    const void* k_scale, const void* v_scale, long long s_page,
    long long s_row, long long s_head, const void* page_tables,
    int max_pages, const void* seq_lens, void* out, void* ws, void* counters,
    int B, int H, int D, int page_size, float scale, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (pa_bad_args(kv_dtype, k_scale, v_scale, D, page_size, max_pages))
    return (int)cudaErrorInvalidValue;
  const long long blocks =
      (long long)B * rpa_max_splits(max_pages, page_size) * H;
  const bool q_async = pa_q_async(q, D);
  return pa_dispatch(kv_dtype, k_pool, v_pool, D, [&](auto inst) {
    using I = decltype(inst);
    return pa_launch<I>(
        pda_kernel<typename I::KV, I::VEC, I::NDC>, blocks, D, page_size,
        static_cast<cudaStream_t>(stream), q, k_pool, v_pool, k_scale,
        v_scale, s_page, s_row, s_head, page_tables, max_pages, seq_lens,
        out, ws, counters, H, D, page_size, scale, q_async);
  });
}
