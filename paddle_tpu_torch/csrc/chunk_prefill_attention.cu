// Chunked-prefill paged attention for Hopper (sm_90a), fp32 arithmetic.
//
// Replaces the Pallas TPU kernel
// paddle_tpu/ops/pallas/paged_attention.py::chunk_prefill_attention_kernel
// (body _chunk_kernel).  One sequence's prefill chunk q[n, H, D]: row r sits
// at position start + r and attends causally to keys [0, start + r], read
// through the sequence's page table [max_pages] (prefix and the chunk's own
// keys, which the caller scattered into the pools first).  Rows past the
// chunk's real length are padding: they compute at their nominal positions
// like the others and the caller discards them.  `start` is a host int
// passed by value: no device scalar, no sync.
//
// Design.  The TPU grid (head, page) runs in order and carries the whole
// chunk's [n, D] online-softmax state across the page axis.  CUDA blocks
// run in parallel, so the chunk is cut into QB-row tiles: grid (row tile,
// head), and each block walks pages 0 .. (start + last row) / page_size of
// the one page table, reading the page ids itself (no scalar prefetch on a
// GPU).  The whole block stages each [page_size, D] K and V page into
// shared memory through the pool's strides (both pool layouts; bf16 pools
// upcast to f32 on load, int8 pools dequantized with their page's [P, H]
// scale as the Pallas body's int8 branch does), then each warp updates the online-softmax state
// (m, l, acc) of its QB / WARPS rows in registers: lanes over the page's
// keys for the scores, over D for the P.V accumulate.  That walk
// (pa_attend_tile in paged_attention_common.cuh) is shared with the ragged
// kernel; this kernel works out its tile's rows and positions.
// Every row sees key 0, so every output row is written.
//
// What bounds it on an H100.  A 64-row chunk reuses each staged page for QB
// rows per block and across its tiles through L2, so the fp32 FMA rate of
// the CUDA cores (67 TFLOP/s) over the visible (row, key) pairs bounds it
// once the prefix is long; short prefixes are bound by the K/V bytes.  This
// first version walks a tile's pages one after another with a block-wide
// barrier per page and no load/compute overlap; cp.async/TMA pipelining,
// wgmma on bf16 pools and split-K over pages are later work.

#include "paged_attention_common.cuh"

#define CPA_QB 8                       // chunk rows per block (one tile)
#define CPA_WARPS 4

template <typename KV>
__global__ void __launch_bounds__(CPA_WARPS * 32)
cpa_kernel(const float* __restrict__ q, const KV* __restrict__ k_pool,
           const KV* __restrict__ v_pool, const float* __restrict__ k_scale,
           const float* __restrict__ v_scale, long long s_page, long long s_row,
           long long s_head, const int* __restrict__ page_table,
           int max_pages, int start, float* __restrict__ out, int n, int H,
           int D, int page_size, float scale, bool vec4) {
  const int row0 = blockIdx.x * CPA_QB;
  const int h = blockIdx.y;
  const int n_rows = min(CPA_QB, n - row0);
  const int qpos0 = start + row0;
  extern __shared__ float smem[];
  pa_attend_tile<KV, CPA_QB, CPA_WARPS>(
      q, k_pool, v_pool, k_scale, v_scale, s_page, s_row, s_head, page_table,
      max_pages, row0,
      qpos0, n_rows, h, out, H, D, page_size, scale, vec4, smem);
}

template <typename KV>
static int cpa_launch(const void* q, const void* k_pool, const void* v_pool,
                      const void* k_scale, const void* v_scale,
                      long long s_page, long long s_row, long long s_head,
                      const void* page_table, int max_pages, int start,
                      void* out, int n, int H, int D, int page_size,
                      float scale, cudaStream_t stream) {
  const size_t smem = pa_staged_smem(CPA_QB, D, page_size);
  const int err = pa_allow_smem(cpa_kernel<KV>, smem);
  if (err != 0) return err;
  dim3 grid((n + CPA_QB - 1) / CPA_QB, H);
  cpa_kernel<KV><<<grid, CPA_WARPS * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const KV*>(k_pool),
      static_cast<const KV*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), s_page, s_row, s_head,
      static_cast<const int*>(page_table), max_pages, start,
      static_cast<float*>(out), n, H, D, page_size, scale,
      pa_vec4<KV>(k_pool, v_pool, D));
  return (int)cudaGetLastError();
}

// q/out [n, H, D] f32 contiguous; pools f32, bf16 or int8 (kv_dtype 0, 1,
// 2), with element strides s_page/s_row/s_head and a unit D stride; an int8
// pool's k_scale/v_scale [P, H] f32 (NULL for float pools); page_table
// [max_pages] int32; start >= 0 the chunk's first position.  Returns the
// CUDA error code of the launch (0 on success).
extern "C" int cpa_chunk_prefill_attention(
    const void* q, const void* k_pool, const void* v_pool, int kv_dtype,
    const void* k_scale, const void* v_scale, long long s_page,
    long long s_row, long long s_head, const void* page_table, int max_pages,
    int start, void* out, int n, int H, int D, int page_size, float scale,
    void* stream) {
  if (n <= 0 || H <= 0) return 0;
  if (D < 1 || D > PA_MAX_D || page_size < 1 || page_size > PA_MAX_PS ||
      max_pages < 1 || start < 0 ||
      (kv_dtype == PA_KV_INT8) != (k_scale != nullptr && v_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case PA_KV_F32:
      return cpa_launch<float>(q, k_pool, v_pool, k_scale, v_scale, s_page,
                               s_row, s_head, page_table, max_pages, start,
                               out, n, H, D, page_size, scale, st);
    case PA_KV_BF16:
      return cpa_launch<__nv_bfloat16>(q, k_pool, v_pool, k_scale, v_scale,
                                       s_page, s_row, s_head, page_table,
                                       max_pages, start, out, n, H, D,
                                       page_size, scale, st);
    case PA_KV_INT8:
      return cpa_launch<int8_t>(q, k_pool, v_pool, k_scale, v_scale, s_page,
                                s_row, s_head, page_table, max_pages, start,
                                out, n, H, D, page_size, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
