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
// never run.
//
// Design.  The TPU grid (head, descriptor, page, q-tile) runs in order and
// carries one online-softmax state in VMEM across descriptors.  CUDA
// blocks run in parallel, so here every block owns one output tile
// outright: grid (q-tile within the descriptor, descriptor, head), QB rows
// per tile.  A tile that starts past the descriptor's length exits at
// once.  Each packed row belongs to at most one descriptor, so no two
// blocks write the same row and no cross-block reduction exists.  A block
// walks pages 0 .. qpos_max / page_size of its descriptor (qpos_max: the
// position of the tile's last row), reading page_tables[s, i] itself
// (there is no scalar prefetch on a GPU), stages the [page_size, D] K and V
// tiles in shared memory through the pool's strides (so the token layout
// [P, ps, H, D] and the kernel layout [H, P, ps, D] both work; bf16 pools
// are upcast to f32 on load and int8 pools dequantized with their page's
// [P, H] scale, the Pallas body's int8 branch; each thread issues its
// 4-wide loads of a page before storing any), and runs an online softmax whose state
// (m, l, acc) stays in registers: one warp per query row, lanes over the
// page's keys for the scores and over D for the P.V accumulate.  That
// walk (pa_attend_tile) lives in paged_attention_common.cuh, shared with
// the chunk-prefill kernel; this kernel works out its tile's descriptor.
//
// What bounds it on an H100.  Decode rows (one query per descriptor) read
// every visible K/V byte once and do 4*D flops per key: bytes of K/V over
// 3.35 TB/s bound them.  Long prefill chunks reuse each page for up to QB
// rows per block (and across the chunk's tiles through L2), so there the
// fp32 FMA rate of the CUDA cores (67 TFLOP/s) is the bound.  This first
// version keeps the arithmetic in fp32 FMA on the CUDA cores — TF32 tensor
// cores would break the 2e-5 parity with the fp32 reference — and skips
// the rows a tile does not hold and the pages past its causal horizon.
// An int8 pool moves a quarter of the f32 bytes (plus one f32 scale per
// page and head): the same walk, reading bytes.
// Overlapping the page loads with compute (cp.async/TMA), wgmma on bf16
// pools and split-K over pages for long contexts are later work.

#include "paged_attention_common.cuh"

#define RPA_QB 8                       // query rows per block (one tile)
#define RPA_WARPS 4

template <typename KV>
__global__ void __launch_bounds__(RPA_WARPS * 32)
rpa_kernel(const float* __restrict__ q, const KV* __restrict__ k_pool,
           const KV* __restrict__ v_pool, const float* __restrict__ k_scale,
           const float* __restrict__ v_scale, long long s_page, long long s_row,
           long long s_head, const int* __restrict__ page_tables,
           int max_pages, const int* __restrict__ starts,
           const int* __restrict__ lens, const int* __restrict__ kv_lens,
           float* __restrict__ out, int H, int D, int page_size,
           float scale, bool vec4) {
  const int tile = blockIdx.x;
  const int s = blockIdx.y;
  const int h = blockIdx.z;
  const int len = lens[s];
  const int row_off = tile * RPA_QB;
  if (row_off >= len) return;  // tile past the descriptor (or len == 0)
  const int n_rows = min(RPA_QB, len - row_off);
  const int row0 = starts[s] + row_off;       // first packed row of tile
  const int qpos0 = kv_lens[s] - len + row_off;  // its position
  if (qpos0 + n_rows - 1 < 0) return;  // no row of the tile sees a key
  extern __shared__ float smem[];
  pa_attend_tile<KV, RPA_QB, RPA_WARPS>(
      q, k_pool, v_pool, k_scale, v_scale, s_page, s_row, s_head,
      page_tables + (long long)s * max_pages, max_pages, row0, qpos0, n_rows,
      h, out, H, D, page_size, scale, vec4, smem);
}

template <typename KV>
static int rpa_launch(const void* q, const void* k_pool, const void* v_pool,
                      const void* k_scale, const void* v_scale,
                      long long s_page, long long s_row, long long s_head,
                      const void* page_tables, int max_pages,
                      const void* starts, const void* lens,
                      const void* kv_lens, void* out, int T, int S, int H,
                      int D, int page_size, float scale,
                      cudaStream_t stream) {
  const size_t smem = pa_staged_smem(RPA_QB, D, page_size);
  const int err = pa_allow_smem(rpa_kernel<KV>, smem);
  if (err != 0) return err;
  dim3 grid((T + RPA_QB - 1) / RPA_QB, S, H);
  rpa_kernel<KV><<<grid, RPA_WARPS * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const KV*>(k_pool),
      static_cast<const KV*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), s_page, s_row, s_head,
      static_cast<const int*>(page_tables), max_pages,
      static_cast<const int*>(starts), static_cast<const int*>(lens),
      static_cast<const int*>(kv_lens), static_cast<float*>(out), H, D,
      page_size, scale, pa_vec4<KV>(k_pool, v_pool, D));
  return (int)cudaGetLastError();
}

// q/out [T, H, D] f32 contiguous; pools f32, bf16 or int8 (kv_dtype 0, 1,
// 2), with element strides s_page/s_row/s_head and a unit D stride; an int8
// pool's k_scale/v_scale [P, H] f32 (NULL for float pools); page_tables
// [S, max_pages] and starts/lens/kv_lens [S] int32.  Returns the CUDA error
// code of the launch (0 on success).
extern "C" int rpa_ragged_paged_attention(
    const void* q, const void* k_pool, const void* v_pool, int kv_dtype,
    const void* k_scale, const void* v_scale, long long s_page,
    long long s_row, long long s_head, const void* page_tables,
    int max_pages, const void* starts, const void* lens, const void* kv_lens,
    void* out, int T, int S, int H, int D, int page_size, float scale,
    void* stream) {
  if (T <= 0 || S <= 0 || H <= 0) return 0;
  if (D < 1 || D > PA_MAX_D || page_size < 1 || page_size > PA_MAX_PS ||
      (kv_dtype == PA_KV_INT8) != (k_scale != nullptr && v_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case PA_KV_F32:
      return rpa_launch<float>(q, k_pool, v_pool, k_scale, v_scale, s_page,
                               s_row, s_head, page_tables, max_pages, starts,
                               lens, kv_lens, out, T, S, H, D, page_size,
                               scale, st);
    case PA_KV_BF16:
      return rpa_launch<__nv_bfloat16>(q, k_pool, v_pool, k_scale, v_scale,
                                       s_page, s_row, s_head, page_tables,
                                       max_pages, starts, lens, kv_lens, out,
                                       T, S, H, D, page_size, scale, st);
    case PA_KV_INT8:
      return rpa_launch<int8_t>(q, k_pool, v_pool, k_scale, v_scale, s_page,
                                s_row, s_head, page_tables, max_pages,
                                starts, lens, kv_lens, out, T, S, H, D,
                                page_size, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
