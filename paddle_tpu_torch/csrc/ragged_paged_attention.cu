// Ragged paged attention for Hopper (sm_90a), fp32 arithmetic.
//
// Replaces the Pallas TPU kernel
// paddle_tpu/ops/pallas/paged_attention.py::ragged_paged_attention_kernel
// (body _ragged_kernel).  One packed token axis q[T, H, D] holds the
// decode rows and the prefill chunks of one engine step; descriptor s owns
// packed rows [starts[s], starts[s] + lens[s]) and has kv_lens[s] keys in
// the cache after this step's writes, so row r of s sits at position
// kv_lens[s] - lens[s] + (r - starts[s]) and attends causally to keys
// [0, position] through its page table.  Rows no descriptor owns are left
// untouched (the wrapper zero-fills the output); lens == 0 descriptors
// never run.  Pools are f32, bf16 or int8 (int8 element x of page p, head
// h reads as float(x) * (scale[p * H + h] * (1/127)), the factor computed
// first in f32: the Pallas body's expression), in the token layout
// [P, ps, H, D] or the kernel layout [H, P, ps, D], through the strides.
//
// What bounds it on an H100.  The main path's step (T = 72 rows, S = 9:
// eight decode rows over 16..632 keys and one 64-row chunk finishing a
// 600-token prompt; H 12, D 64, page 16) reads 19.1 MB of f32 K/V, 5.70
// us at 3.35 TB/s, and does 0.119 GFLOP, 1.78 us at the 67 TFLOP/s fp32
// FMA rate: bytes bound f32 pools, the FMA rate int8 ones.  The work is
// small, so latency holds a kernel back: how many loads are in flight on
// the card and whether anything computes while they land.  The first
// version ran one block per 8-row tile that walked up to 40 pages in
// turn, each page a barrier, a global round trip and another barrier, with
// no load in flight during the products: 192 live blocks, 165.8 us (f32)
// and 182.5 us (int8).  fp32 FMA on the CUDA cores is enough for 0.119
// GFLOP; TF32 tensor cores would break the 2e-5 parity with the fp32
// plain version.
//
// Design.
// - Work items.  A tile is RPA_QB = 16 consecutive rows of one descriptor
//   (rows over the 4 warps, 4 each) or a one-row tile, a decode row (the
//   4 warps share its keys; 4 lanes a key, each summing every 4th chunk
//   of D).  A tile's keys up to its last row's position (at most
//   max_pages pages) are cut into splits of SP = ceil(64 / ps) whole
//   pages, at least 64 keys (4 pages of 16, 1 of 64, 16 of 4, 13 of 5).
//   One block runs one item, (tile, split) of one head; items of
//   multi-row tiles, the longest, come first.
// - No host sync.  The grid is an upper bound from what the host knows:
//   min(T, ceil(T / 16) + S) tiles x ceil(max_pages / SP) splits x H.
//   Each block reads lens/kv_lens, counts each descriptor's items (a
//   thread a descriptor), scans the counts and finds its own item; blocks
//   past the last item exit at once.  At the main shape (pages bucket 64)
//   the grid is 14 x 16 x 12 = 2688 blocks, of which 948 are live for
//   chip_smoke.py phase 8's contexts (it prints the count) and the other
//   1740 exit after the scan.
// - Loads in flight.  A split's pages are staged in two halves of
//   ceil(SP / 2) pages (at most 64 keys), both issued at once as 16-byte
//   cp.async copies of the raw pool bytes (q's rows join the first) into
//   two shared-memory buffers, so the second half lands while the first
//   one's scores and P.V run; int8 page factors are loaded while the
//   copies fly.  bf16 and int8 are converted as they are read from shared
//   memory, 16 bytes a read.  Staged rows are padded by 16 bytes: 8 lanes
//   reading 8 keys hit 32 distinct banks.  What 16-byte copies cannot
//   take (D x element size not a multiple of 16, a pool off a 16-byte
//   boundary) is staged by plain loads into rows of an odd word count
//   (conflict-free scalar reads): a path of this kernel (VEC = 1), not a
//   fall back.
// - Lanes.  Scores: every lane owns keys (lanes j, j + 32 of a stage on a
//   multi-row tile; 8 keys x 4 lanes a warp on a one-row tile).  P.V:
//   lanes over D; a multi-row tile's p go through shared memory, one
//   float4 of a warp's 4 rows a key.
// - Merge.  A tile with one split writes its rows.  Otherwise each item
//   writes its rows' (acc, m, l) records to a workspace [T, H, MS, DR],
//   bumps an int counter of (tile's first row, head) after a
//   __threadfence, and the item that arrives last copies the tile's
//   records into its shared memory by cp.async and folds them in split
//   order 0, 1, ... into a running (M, L, acc); it sets the counter back
//   to 0.  No float atomics: the same bits from every launch, and no state
//   left between launches.
// - Rules of the first version kept: masked keys weigh exactly 0; a split
//   a row cannot see (m = -1e30, l = 0) merges as the identity; a row that
//   sees no key writes zeros.
// - Shared.  Everything after the item is found, staging through the
//   merge, is rpa_walk_item in paged_attention_common.cuh, which the
//   chunk-prefill and paged-decode kernels run too.
// Shared memory (rpa_smem): q rows 16 x D f32, 4 stage buffers (K and V
// of two halves) of ceil(SP / 2) x ps rows, a scratch for p or the warps'
// merge rows, the int8 factors and the split's page ids.  A stage buffer
// at D 64, page 16 (32 keys): f32 8,704 B, bf16 4,608 B, int8 2,560 B; a
// block 44,288 / 27,904 / 19,712 B.  At D 128, page 64 (64 keys, the
// largest case chip_smoke.py runs): f32 33,792 B a buffer, 148,736 B a
// block.

#include "paged_attention_common.cuh"

// A descriptor's items, counted as (multi-row tiles' << 32) | one-row
// tiles': the kernel runs every multi-row item (the longest) first.
__device__ __forceinline__ long long rpa_desc_items(int len, int kv, int ps,
                                                    int max_pages) {
  long long n = 0;
  for (int t = 0; t * RPA_QB < len; ++t) {
    const long long k = rpa_tile_splits(len, kv, t, ps, max_pages);
    n += len - t * RPA_QB > 1 ? k << 32 : k;
  }
  return n;
}

// Inclusive sum of v over the block's threads in order; `total` gets the
// block's sum.  Every thread calls it.
__device__ __forceinline__ long long rpa_block_scan(long long v,
                                                    long long* warp_tot,
                                                    long long& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  long long before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < RPA_WARPS; ++w) {
    if (w < warp) before += warp_tot[w];
    total += warp_tot[w];
  }
  __syncthreads();  // warp_tot is free for the next call
  return before + v;
}

// Grid: one block per (item, head), head fastest; see the note above.
// __launch_bounds__(.., 4): left to itself, ptxas aims at 5-7 blocks an
// SM (72-96 registers) and spills a few bytes in some instantiations;
// with a floor of 4 blocks it keeps every instantiation unspilled
// (100-128 registers, measured on the card).
template <typename KV, int VEC, int NDC>
__global__ void __launch_bounds__(RPA_THREADS, 4)
rpa_kernel(const float* __restrict__ q, const KV* __restrict__ k_pool,
           const KV* __restrict__ v_pool, const float* __restrict__ k_scale,
           const float* __restrict__ v_scale, long long s_page, long long s_row,
           long long s_head, const int* __restrict__ page_tables,
           int max_pages, const int* __restrict__ starts,
           const int* __restrict__ lens, const int* __restrict__ kv_lens,
           float* __restrict__ out, float* __restrict__ ws,
           int* __restrict__ counters, int S, int H, int D, int page_size,
           float scale, bool q_async) {
  const int tid = threadIdx.x;
  const int h = blockIdx.x % H;
  const int item = blockIdx.x / H;
  const int ps = page_size;
  __shared__ long long warp_tot[RPA_WARPS];
  // the item: first packed row, rows, split, splits of its tile, the
  // tile's first position, descriptor
  __shared__ int sh_item[6];

  // ---- this block's item.  Items are numbered multi-row tiles' first,
  // then one-row tiles', each class in descriptor, tile and split order
  // (ops/paged_attention.py::ragged_work_items mirrors it).  Every thread
  // counts a descriptor's items, the block scans the counts (a first pass
  // totals them when S exceeds the block) and the thread whose range
  // holds this block's item records it.
  long long grand = 0;
  if (S > RPA_THREADS) {
    for (int base = 0; base < S; base += RPA_THREADS) {
      const int s = base + tid;
      long long total;
      rpa_block_scan(s < S ? rpa_desc_items(lens[s], kv_lens[s], ps,
                                            max_pages)
                           : 0,
                     warp_tot, total);
      grand += total;
    }
  }
  long long carry = 0;
  for (int base = 0; base < S; base += RPA_THREADS) {
    const int s = base + tid;
    const long long cnt =
        s < S ? rpa_desc_items(lens[s], kv_lens[s], ps, max_pages) : 0;
    long long total;
    const long long first = carry + rpa_block_scan(cnt, warp_tot, total) - cnt;
    if (S <= RPA_THREADS) grand = total;
    const long long multi = grand >> 32;
    const long long lo = item - (first >> 32);
    const long long lo1 = item - multi - (first & 0xffffffffLL);
    const bool multi_item = lo >= 0 && lo < (cnt >> 32);
    if (multi_item || (lo1 >= 0 && lo1 < (cnt & 0xffffffffLL))) {
      // this thread's descriptor holds the item: find its tile and split
      const int len = lens[s], kv = kv_lens[s];
      int t = 0, split = (int)(multi_item ? lo : lo1), n_splits;
      for (;; ++t) {
        if ((len - t * RPA_QB == 1) == multi_item) continue;  // other class
        n_splits = rpa_tile_splits(len, kv, t, ps, max_pages);
        if (split < n_splits) break;
        split -= n_splits;
      }
      sh_item[0] = starts[s] + t * RPA_QB;
      sh_item[1] = min(RPA_QB, len - t * RPA_QB);
      sh_item[2] = split;
      sh_item[3] = n_splits;
      sh_item[4] = kv - len + t * RPA_QB;
      sh_item[5] = s;
    }
    carry += total;
    if (item < (carry >> 32) ||
        (item >= multi && item - multi < (carry & 0xffffffffLL)))
      break;  // block-uniform: found
  }
  if (item >= (grand >> 32) + (grand & 0xffffffffLL))
    return;  // no work: the whole block leaves
  __syncthreads();
  rpa_walk_item<KV, VEC, NDC>(
      q, k_pool, v_pool, k_scale, v_scale, s_page, s_row, s_head,
      page_tables + (long long)sh_item[5] * max_pages, max_pages,
      sh_item[0], sh_item[1], sh_item[2], sh_item[3], sh_item[4], h, out,
      ws, counters, H, D, ps, scale, q_async);
}

// q/out [T, H, D] f32 contiguous; pools f32, bf16 or int8 (kv_dtype 0, 1,
// 2), with element strides s_page/s_row/s_head and a unit D stride; an int8
// pool's k_scale/v_scale [P, H] f32 (NULL for float pools); page_tables
// [S, max_pages] and starts/lens/kv_lens [S] int32; ws f32 scratch of
// T * H * MS * DR floats on a 16-byte boundary (MS = ceil(max_pages /
// ceil(64 / page_size)), DR = D + 2 rounded up to a multiple of 4; any
// contents) and counters int32 [T * H], zero (the kernel leaves them
// zero).  Returns the CUDA error code of the launch (0 on
// success).
extern "C" int rpa_ragged_paged_attention(
    const void* q, const void* k_pool, const void* v_pool, int kv_dtype,
    const void* k_scale, const void* v_scale, long long s_page,
    long long s_row, long long s_head, const void* page_tables,
    int max_pages, const void* starts, const void* lens, const void* kv_lens,
    void* out, void* ws, void* counters, int T, int S, int H, int D,
    int page_size, float scale, void* stream) {
  if (T <= 0 || S <= 0 || H <= 0 || max_pages <= 0) return 0;
  if (pa_bad_args(kv_dtype, k_scale, v_scale, D, page_size, max_pages))
    return (int)cudaErrorInvalidValue;
  // an upper bound on the items from shapes alone: at most one tile a
  // row, and at most ceil(T / 16) + S tiles
  const long long by_tile = (long long)(T + RPA_QB - 1) / RPA_QB + S;
  const long long blocks = (by_tile < T ? by_tile : T) *
                           rpa_max_splits(max_pages, page_size) * H;
  const bool q_async = pa_q_async(q, D);
  return pa_dispatch(kv_dtype, k_pool, v_pool, D, [&](auto inst) {
    using I = decltype(inst);
    return pa_launch<I>(
        rpa_kernel<typename I::KV, I::VEC, I::NDC>, blocks, D, page_size,
        static_cast<cudaStream_t>(stream), q, k_pool, v_pool, k_scale,
        v_scale, s_page, s_row, s_head, page_tables, max_pages, starts,
        lens, kv_lens, out, ws, counters, S, H, D, page_size, scale,
        q_async);
  });
}
