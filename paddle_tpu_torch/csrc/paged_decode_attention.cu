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
// Design.  The TPU grid (sequence, head, page) runs in order and carries
// one row's online-softmax state across the page axis.  Here one block of
// WARPS warps owns one (sequence, head) outright, so nothing crosses
// blocks.  A single query row has no rows to tile (the ragged kernel's
// 8-row tile would leave 7 of 8 rows idle), so the block's warps split the
// sequence's PAGES instead: warp w walks pages w, w + WARPS, ..., reading
// each page id itself (no scalar prefetch on a GPU) and each page's K and
// V rows straight from the pool through its strides (both pool layouts;
// bf16 upcast on load; int8 dequantized on load with the page's [P, H]
// scale, the Pallas body's int8 branch).  Within a page, lanes own keys for the scores
// (lane j reads K row j, 4-wide where aligned) and D elements for the P.V
// accumulate (coalesced V rows, loaded eight keys at a time before use).
// Each warp keeps its own (m, l, acc); at the end the warps combine them
// through shared memory.  No __syncthreads inside the page walk.
//
// What bounds it on an H100.  Each K/V byte of the visible pages is read
// once and feeds 2 flops (4*D per key for QK and PV), so the bytes over
// 3.35 TB/s bound it.  A decode batch of 8 sequences x 12 heads is 96
// blocks on 132 SMs, and a 632-key context is 40 pages of 16 walked ten
// to a warp: latency, not bandwidth, sets this first version's time.
// An int8 pool moves a quarter of the f32 bytes (plus one f32 scale per
// page and head), so its bound is a quarter of the f32 one; the walk is the
// same.  Split-K over pages across blocks, cp.async/TMA staging and wgmma on
// bf16 pools are later work.

#include "paged_attention_common.cuh"

#define PDA_WARPS 4
#define PDA_KG 8                       // keys per group of V-row loads

template <typename KV>
__global__ void __launch_bounds__(PDA_WARPS * 32)
pda_kernel(const float* __restrict__ q, const KV* __restrict__ k_pool,
           const KV* __restrict__ v_pool, const float* __restrict__ k_scale,
           const float* __restrict__ v_scale, long long s_page, long long s_row,
           long long s_head, const int* __restrict__ page_tables,
           int max_pages, const int* __restrict__ seq_lens,
           float* __restrict__ out, int H, int D, int page_size,
           float scale, bool vec4) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int seq_len = max(seq_lens[b], 0);
  const int n_pages = min((seq_len + page_size - 1) / page_size, max_pages);

  __shared__ float q_s[PA_MAX_D];                 // scale folded
  __shared__ float m_s[PDA_WARPS], l_s[PDA_WARPS];
  __shared__ float acc_s[PDA_WARPS][PA_MAX_D];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row = ((long long)b * H + h) * D;
  for (int d = tid; d < D; d += blockDim.x) q_s[d] = q[row + d] * scale;
  __syncthreads();

  float m = PA_NEG_INF, l = 0.f;
  float acc[PA_MAX_D / 32];
#pragma unroll
  for (int c = 0; c < PA_MAX_D / 32; ++c) acc[c] = 0.f;

  const int* pt = page_tables + (long long)b * max_pages;
  const KV* kb = k_pool + (long long)h * s_head;
  const KV* vb = v_pool + (long long)h * s_head;
  for (int pi = warp; pi < n_pages; pi += PDA_WARPS) {
    const long long page = pt[pi];
    const KV* kp = kb + page * s_page;
    const KV* vp = vb + page * s_page;
    const float kf = pa_page_factor<KV>(k_scale, page, H, h);
    const float vf = pa_page_factor<KV>(v_scale, page, H, h);
    const int kn = min(page_size, seq_len - pi * page_size);  // live keys
    float p[PA_MAX_PS / 32];
    float mx = PA_NEG_INF;
#pragma unroll
    for (int c = 0; c < PA_MAX_PS / 32; ++c) {
      const int j = lane + 32 * c;
      float sc = PA_NEG_INF;
      if (j < kn) {
        const KV* kr = kp + j * s_row;
        float a = 0.f;
        if (vec4) {
#pragma unroll 8
          for (int d = 0; d < D; d += 4) {
            const float4 k4 = pa_dq4<KV>(pa_load4(kr + d), kf);
            a = fmaf(q_s[d], k4.x, a);
            a = fmaf(q_s[d + 1], k4.y, a);
            a = fmaf(q_s[d + 2], k4.z, a);
            a = fmaf(q_s[d + 3], k4.w, a);
          }
        } else {
#pragma unroll 8
          for (int d = 0; d < D; ++d)
            a = fmaf(q_s[d], pa_dq<KV>(pa_to_f32(kr[d]), kf), a);
        }
        sc = a;
      }
      p[c] = sc;
      mx = fmaxf(mx, sc);
    }
    mx = pa_warp_max(mx);
    const float m_cur = fmaxf(m, mx);
    const float alpha = expf(m - m_cur);
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < PA_MAX_PS / 32; ++c) {
      // masked keys contribute exactly 0
      p[c] = (p[c] <= PA_NEG_INF * 0.5f) ? 0.f : expf(p[c] - m_cur);
      psum += p[c];
    }
    psum = pa_warp_sum(psum);
    l = l * alpha + psum;
    m = m_cur;
#pragma unroll
    for (int c = 0; c < PA_MAX_D / 32; ++c) acc[c] *= alpha;
    // P.V: lanes over D, p_j broadcast from the lane that owns key j.
    // The V rows of PDA_KG keys are loaded before any is used, so a group
    // costs about one memory latency, not one per key.
    for (int j0 = 0; j0 < kn; j0 += PDA_KG) {
      const float pc = j0 < 32 ? p[0] : p[1];  // j0..j0+KG-1 share one c
      float vv[PDA_KG][PA_MAX_D / 32];
#pragma unroll
      for (int u = 0; u < PDA_KG; ++u) {
        const KV* vr = vp + (long long)(j0 + u) * s_row;
#pragma unroll
        for (int dc = 0; dc < PA_MAX_D / 32; ++dc) {
          const int d = lane + 32 * dc;
          vv[u][dc] = (j0 + u < kn && d < D)
                          ? pa_dq<KV>(pa_to_f32(vr[d]), vf) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < PDA_KG; ++u) {
        const float pj = __shfl_sync(0xffffffffu, pc, (j0 + u) & 31);
#pragma unroll
        for (int dc = 0; dc < PA_MAX_D / 32; ++dc)
          acc[dc] = fmaf(pj, vv[u][dc], acc[dc]);
      }
    }
  }

  // combine the warps' states: a warp that walked no page holds
  // (NEG_INF, 0, 0) and weighs exp(NEG_INF - M) = 0; seq_len == 0 leaves
  // L == 0 and writes exact zeros
  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
#pragma unroll
  for (int dc = 0; dc < PA_MAX_D / 32; ++dc) {
    const int d = lane + 32 * dc;
    if (d < D) acc_s[warp][d] = acc[dc];
  }
  __syncthreads();
  float M = PA_NEG_INF;
#pragma unroll
  for (int w = 0; w < PDA_WARPS; ++w) M = fmaxf(M, m_s[w]);
  float wgt[PDA_WARPS];
  float L = 0.f;
#pragma unroll
  for (int w = 0; w < PDA_WARPS; ++w) {
    wgt[w] = expf(m_s[w] - M);
    L += l_s[w] * wgt[w];
  }
  const float inv = L > 0.f ? 1.f / L : 0.f;
  for (int d = tid; d < D; d += blockDim.x) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < PDA_WARPS; ++w) a = fmaf(acc_s[w][d], wgt[w], a);
    out[row + d] = a * inv;
  }
}

template <typename KV>
static int pda_launch(const void* q, const void* k_pool, const void* v_pool,
                      const void* k_scale, const void* v_scale,
                      long long s_page, long long s_row, long long s_head,
                      const void* page_tables, int max_pages,
                      const void* seq_lens, void* out, int B, int H, int D,
                      int page_size, float scale, cudaStream_t stream) {
  dim3 grid(B, H);
  pda_kernel<KV><<<grid, PDA_WARPS * 32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const KV*>(k_pool),
      static_cast<const KV*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), s_page, s_row, s_head,
      static_cast<const int*>(page_tables), max_pages,
      static_cast<const int*>(seq_lens), static_cast<float*>(out), H, D,
      page_size, scale, pa_vec4<KV>(k_pool, v_pool, D));
  return (int)cudaGetLastError();
}

// q/out [B, H, D] f32 contiguous; pools f32, bf16 or int8 (kv_dtype 0, 1,
// 2), with element strides s_page/s_row/s_head and a unit D stride; an int8
// pool's k_scale/v_scale [P, H] f32 (NULL for float pools); page_tables
// [B, max_pages] and seq_lens [B] int32.  Returns the CUDA error code of
// the launch (0 on success).
extern "C" int pda_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, int kv_dtype,
    const void* k_scale, const void* v_scale, long long s_page,
    long long s_row, long long s_head, const void* page_tables,
    int max_pages, const void* seq_lens, void* out, int B, int H, int D,
    int page_size, float scale, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (D < 1 || D > PA_MAX_D || page_size < 1 || page_size > PA_MAX_PS ||
      max_pages < 1 || H > 65535 ||
      (kv_dtype == PA_KV_INT8) != (k_scale != nullptr && v_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case PA_KV_F32:
      return pda_launch<float>(q, k_pool, v_pool, k_scale, v_scale, s_page,
                               s_row, s_head, page_tables, max_pages,
                               seq_lens, out, B, H, D, page_size, scale, st);
    case PA_KV_BF16:
      return pda_launch<__nv_bfloat16>(q, k_pool, v_pool, k_scale, v_scale,
                                       s_page, s_row, s_head, page_tables,
                                       max_pages, seq_lens, out, B, H, D,
                                       page_size, scale, st);
    case PA_KV_INT8:
      return pda_launch<int8_t>(q, k_pool, v_pool, k_scale, v_scale, s_page,
                                s_row, s_head, page_tables, max_pages,
                                seq_lens, out, B, H, D, page_size, scale,
                                st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
