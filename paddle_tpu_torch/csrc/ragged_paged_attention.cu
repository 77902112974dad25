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
// Shared memory (rpa_smem): q rows 16 x D f32, 4 stage buffers (K and V
// of two halves) of ceil(SP / 2) x ps rows, a scratch for p or the warps'
// merge rows, the int8 factors and the split's page ids.  A stage buffer
// at D 64, page 16 (32 keys): f32 8,704 B, bf16 4,608 B, int8 2,560 B; a
// block 44,288 / 27,904 / 19,712 B.  At D 128, page 64 (64 keys, the
// largest case chip_smoke.py runs): f32 33,792 B a buffer, 148,736 B a
// block.

#include "paged_attention_common.cuh"

#define RPA_QB 16           // rows of a multi-row tile
#define RPA_WARPS 4
#define RPA_THREADS (RPA_WARPS * 32)
#define RPA_RPW (RPA_QB / RPA_WARPS)  // rows a warp owns in a multi-row tile
#define RPA_SPLIT_KEYS 64   // a split holds at least this many keys
#define RPA_MAX_SPLIT 64    // most pages a split holds (page size 1)
#define RPA_MAX_STAGE 64    // most keys a stage holds (any page size)
#define RPA_GROUP 8         // keys a warp scores at once on a one-row tile

static_assert(RPA_RPW == 4, "a key's p of a warp's rows is one float4");

__host__ __device__ inline int rpa_split_pages(int ps) {
  return (RPA_SPLIT_KEYS + ps - 1) / ps;
}
__host__ __device__ inline int rpa_stage_pages(int ps) {
  return (rpa_split_pages(ps) + 1) / 2;
}
__host__ __device__ inline int rpa_max_splits(int max_pages, int ps) {
  return (max_pages + rpa_split_pages(ps) - 1) / rpa_split_pages(ps);
}
// floats of one split partial in the workspace: acc [D], m, l, padded to
// 16 bytes
__host__ __device__ inline int rpa_record(int D) { return (D + 2 + 3) / 4 * 4; }

// Elements between two staged rows: 16 bytes of padding on the cp.async
// path; otherwise an odd number of 4-byte words.
template <typename KV>
__host__ __device__ inline int rpa_row_stride(int D, bool async16) {
  constexpr int per_word = 4 / (int)sizeof(KV);
  if (async16) return D + 4 * per_word;
  const int words = (D + per_word - 1) / per_word;
  return (words | 1) * per_word;
}

template <typename KV>
__host__ __device__ inline int rpa_buf_bytes(int D, int ps, bool async16) {
  const int b = rpa_stage_pages(ps) * ps * rpa_row_stride<KV>(D, async16) *
                (int)sizeof(KV);
  return (b + 15) / 16 * 16;
}

// Byte offsets into the dynamic shared memory.  `scratch` holds a
// multi-row tile's p (per warp [64 keys][4 rows]) or a one-row tile's
// per-warp (acc, m, l), never both.
struct RpaSmem {
  int q, kv, scratch, fk, split, total;
};
template <typename KV>
__host__ __device__ inline RpaSmem rpa_smem(int D, int ps, bool async16) {
  RpaSmem o;
  o.q = 0;                                    // [QB][D] f32
  o.kv = o.q + RPA_QB * D * 4;                // K0, V0, K1, V1
  o.scratch = o.kv + 4 * rpa_buf_bytes<KV>(D, ps, async16);
  const int p_bytes = RPA_WARPS * RPA_MAX_STAGE * RPA_RPW * 4;
  const int merge_bytes = RPA_WARPS * (D + 2) * 4;
  o.fk = o.scratch + (p_bytes > merge_bytes ? p_bytes : merge_bytes);
  o.split = o.fk + 4 * RPA_MAX_STAGE * 4;     // fk[2][64], fv[2][64]
  o.total = o.split + RPA_MAX_SPLIT * 4;      // the split's page ids
  return o;
}

// Splits of tile t of a descriptor with len rows and kv keys (0 when no
// row of the tile sees a key).  ops/paged_attention.py::ragged_work_items
// mirrors this rule.
__device__ __forceinline__ int rpa_tile_splits(int len, int kv, int t,
                                               int ps, int max_pages) {
  const int off = t * RPA_QB;
  const int qlast = kv - len + off + min(RPA_QB, len - off) - 1;
  if (qlast < 0) return 0;
  const int sp = rpa_split_pages(ps);
  return (min(qlast / ps + 1, max_pages) + sp - 1) / sp;
}

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

// a[r] += the dot of query row r (q + r * q_stride, f32) with the staged
// K row kr, over elements [u, u + VEC), in order.
template <typename KV, int VEC, int R>
__device__ __forceinline__ void rpa_dot(const float* q, int q_stride,
                                        const KV* kr, int u, float f,
                                        float (&a)[R]) {
  if constexpr (VEC == 1) {
    const float x = pa_dq<KV>(pa_to_f32(kr[u]), f);
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] = fmaf(q[r * q_stride + u], x, a[r]);
  } else {
    const uint4 raw = pa_raw16(kr + u);
#pragma unroll
    for (int g = 0; g < VEC / 4; ++g) {
      const float4 x = pa_unpack4<KV>(raw, g, f);
#pragma unroll
      for (int r = 0; r < R; ++r)
        a[r] = pa_dot4(
            *reinterpret_cast<const float4*>(q + r * q_stride + u + 4 * g),
            x, a[r]);
    }
  }
}

// One stage of a multi-row tile.  Warp w owns rows w + 4 r (q_s rows past
// the tile are zeros; their results are never written).  Scores: lanes
// own keys j = lane, lane + 32 of the stage's sk keys.  P.V: the warp's p
// go through shared memory (p_s, one float4 of its 4 rows a key), lanes
// own elements d = lane + 32 c.
template <typename KV, int VEC, int NDC>
__device__ __forceinline__ void rpa_rows_stage(
    const float* q_s, const KV* k_s, const KV* v_s, int rs, const float* fk,
    const float* fv, float* p_s, int sk, int col0, int qpos0, int D,
    float scale, float (&m)[RPA_RPW], float (&l)[RPA_RPW],
    float (&acc)[RPA_RPW][NDC]) {
  constexpr bool INT8 = std::is_same<KV, int8_t>::value;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float sc[2][RPA_RPW];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
#pragma unroll
    for (int r = 0; r < RPA_RPW; ++r) sc[c][r] = 0.f;
    const int j = lane + 32 * c;
    if (j < sk) {
      const KV* kr = k_s + j * rs;
      const float f = INT8 ? fk[j] : 1.f;
      constexpr int UN = VEC < 16 ? 16 / VEC : 1;  // 16 elements a step
      for (int u = 0; u < D; u += UN * VEC) {
#pragma unroll
        for (int k = 0; k < UN; ++k)
          if (u + k * VEC < D)
            rpa_dot<KV, VEC, RPA_RPW>(q_s + warp * D, RPA_WARPS * D, kr,
                                      u + k * VEC, f, sc[c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RPA_RPW; ++r) {
    const int qpos = qpos0 + warp + RPA_WARPS * r;
    float mx = PA_NEG_INF;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = lane + 32 * c;
      sc[c][r] = (j < sk && col0 + j <= qpos) ? sc[c][r] * scale
                                              : PA_NEG_INF;
      mx = fmaxf(mx, sc[c][r]);
    }
    mx = pa_warp_max(mx);
    const float m_cur = fmaxf(m[r], mx);
    const float alpha = expf(m[r] - m_cur);
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      // masked keys contribute exactly 0
      sc[c][r] = (sc[c][r] <= PA_NEG_INF * 0.5f) ? 0.f
                                                 : expf(sc[c][r] - m_cur);
      psum += sc[c][r];
    }
    l[r] = l[r] * alpha + pa_warp_sum(psum);
    m[r] = m_cur;
#pragma unroll
    for (int dc = 0; dc < NDC; ++dc) acc[r][dc] *= alpha;
  }
#pragma unroll
  for (int c = 0; c < 2; ++c)
    if (32 * c < sk)
      *reinterpret_cast<float4*>(p_s + 4 * (lane + 32 * c)) =
          make_float4(sc[c][0], sc[c][1], sc[c][2], sc[c][3]);
  __syncwarp();
#pragma unroll 4
  for (int j = 0; j < sk; ++j) {
    const float4 pj = *reinterpret_cast<const float4*>(p_s + 4 * j);
    const KV* vr = v_s + j * rs;
    const float f = INT8 ? fv[j] : 1.f;
#pragma unroll
    for (int dc = 0; dc < NDC; ++dc) {
      const int d = lane + 32 * dc;
      if (d < D) {
        const float vv = pa_dq<KV>(pa_to_f32(vr[d]), f);
        acc[0][dc] = fmaf(pj.x, vv, acc[0][dc]);
        acc[1][dc] = fmaf(pj.y, vv, acc[1][dc]);
        acc[2][dc] = fmaf(pj.z, vv, acc[2][dc]);
        acc[3][dc] = fmaf(pj.w, vv, acc[3][dc]);
      }
    }
  }
  __syncwarp();  // p_s is free for the next stage
}

// One stage of a one-row tile.  Warp w takes keys [w kw, w kw + kw) of
// the stage (kw = a quarter of the stage's capacity, at most 16), 8 at a
// time: lane 4 g + part scores key g of the group over the VEC-element
// chunks part, part + 4, ... of D, and the 4 lanes' sums meet by
// xor-shuffles.
template <typename KV, int VEC, int NDC>
__device__ __forceinline__ void rpa_row_stage(
    const float* q_s, const KV* k_s, const KV* v_s, int rs, const float* fk,
    const float* fv, int sk, int kw, int col0, int qpos, int D, float scale,
    float& m, float& l, float (&acc)[NDC]) {
  constexpr bool INT8 = std::is_same<KV, int8_t>::value;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, part = lane & 3;
  float p[2];
  float mx = PA_NEG_INF;
#pragma unroll
  for (int rd = 0; rd < 2; ++rd) {
    p[rd] = PA_NEG_INF;
    if (rd * RPA_GROUP >= kw) continue;  // warp-uniform
    const int kk = rd * RPA_GROUP + g;
    const int j = warp * kw + kk;
    const bool live = kk < kw && j < sk;
    float a[1] = {0.f};
    if (live) {
      const KV* kr = k_s + j * rs;
      const float f = INT8 ? fk[j] : 1.f;
#pragma unroll 4
      for (int u = part * VEC; u < D; u += 4 * VEC)
        rpa_dot<KV, VEC, 1>(q_s, 0, kr, u, f, a);
    }
    a[0] += __shfl_xor_sync(0xffffffffu, a[0], 1);
    a[0] += __shfl_xor_sync(0xffffffffu, a[0], 2);
    if (live && col0 + j <= qpos) p[rd] = a[0] * scale;
    mx = fmaxf(mx, p[rd]);
  }
  mx = pa_warp_max(mx);
  const float m_cur = fmaxf(m, mx);
  const float alpha = expf(m - m_cur);
  float psum = 0.f;
#pragma unroll
  for (int rd = 0; rd < 2; ++rd) {
    // masked keys contribute exactly 0
    p[rd] = (p[rd] <= PA_NEG_INF * 0.5f) ? 0.f : expf(p[rd] - m_cur);
    if (part == 0) psum += p[rd];  // each key counted once
  }
  l = l * alpha + pa_warp_sum(psum);
  m = m_cur;
#pragma unroll
  for (int dc = 0; dc < NDC; ++dc) acc[dc] *= alpha;
#pragma unroll
  for (int rd = 0; rd < 2; ++rd) {
#pragma unroll 4
    for (int gg = 0; gg < RPA_GROUP; ++gg) {
      const int kk = rd * RPA_GROUP + gg;
      const int j = warp * kw + kk;
      if (kk >= kw || j >= sk) break;  // warp-uniform
      const float pj = __shfl_sync(0xffffffffu, p[rd], 4 * gg);
      const KV* vr = v_s + j * rs;
      const float f = INT8 ? fv[j] : 1.f;
#pragma unroll
      for (int dc = 0; dc < NDC; ++dc) {
        const int d = lane + 32 * dc;
        if (d < D) acc[dc] = fmaf(pj, pa_dq<KV>(pa_to_f32(vr[d]), f), acc[dc]);
      }
    }
  }
}

// Grid: one block per (item, head), head fastest; see the note above.
// VEC: elements a staged read takes (16 bytes of them on the cp.async
// path, 1 on the plain-load path).  NDC: 32-element chunks of D a lane
// accumulates (2 up to D 64, else 4).  q_async: q rows are copied by
// cp.async too (D % 4 == 0 and q on a 16-byte boundary).
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
           int* __restrict__ counters, int T, int S, int H, int D,
           int page_size, float scale, bool q_async) {
  constexpr bool ASYNC = VEC > 1;
  constexpr bool INT8 = std::is_same<KV, int8_t>::value;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x % H;
  const int item = blockIdx.x / H;
  const int ps = page_size;
  __shared__ long long warp_tot[RPA_WARPS];
  // the item: first packed row, rows, split, splits of its tile, the
  // tile's first position, descriptor (re-read after the stages: nothing
  // of it needs to stay in registers through them)
  __shared__ int sh_item[6];
  __shared__ int sh_last;

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
  const int n_rows = sh_item[1];
  const int qpos0 = sh_item[4];
  const int SP = rpa_split_pages(ps), SG = rpa_stage_pages(ps);
  const int n_pages = min((qpos0 + n_rows - 1) / ps + 1, max_pages);
  const int pg_lo = sh_item[2] * SP;
  const int n_sp = min(SP, n_pages - pg_lo);  // this split's pages
  const int n_st = (n_sp + SG - 1) / SG;      // its stages: 1 or 2

  // ---- shared memory
  extern __shared__ __align__(16) unsigned char rpa_smem_raw[];
  const RpaSmem o = rpa_smem<KV>(D, ps, ASYNC);
  const int rs = rpa_row_stride<KV>(D, ASYNC);
  const int buf = rpa_buf_bytes<KV>(D, ps, ASYNC);
  float* q_s = reinterpret_cast<float*>(rpa_smem_raw + o.q);
  float* scratch = reinterpret_cast<float*>(rpa_smem_raw + o.scratch);
  float* fk_s = reinterpret_cast<float*>(rpa_smem_raw + o.fk);
  int* pages_s = reinterpret_cast<int*>(rpa_smem_raw + o.split);

  // q rows (rows past a multi-row tile zero) and the split's page ids;
  // q's copies join stage 0's cp.async group
  const long long hd = (long long)H * D;
  const float* qb = q + (long long)sh_item[0] * hd + (long long)h * D;
  const int q_rows = n_rows == 1 ? 1 : RPA_QB;
  if (q_async) {
    const int units = D / 4;
    for (int e = tid; e < q_rows * units; e += RPA_THREADS) {
      const int i = e / units, c = 4 * (e - i * units);
      if (i < n_rows)
        pa_cp16(q_s + i * D + c, qb + i * hd + c);
      else
        *reinterpret_cast<float4*>(q_s + i * D + c) =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int e = tid; e < q_rows * D; e += RPA_THREADS) {
      const int i = e / D;
      q_s[e] = i < n_rows ? qb[i * hd + (e - i * D)] : 0.f;
    }
  }
  const int* pt = page_tables + (long long)sh_item[5] * max_pages + pg_lo;
  for (int i = tid; i < n_sp; i += RPA_THREADS) pages_s[i] = pt[i];
  __syncthreads();

  // ---- stage st of the split into buffer st & 1: the copies, then (int8)
  // each key's page factors, loaded while the copies are in flight
  const KV* kb = k_pool + (long long)h * s_head;
  const KV* vb = v_pool + (long long)h * s_head;
  auto issue = [=](int st) {
    const int p0 = st * SG;
    const int sk = min(SG, n_sp - p0) * ps;
    KV* ks = reinterpret_cast<KV*>(rpa_smem_raw + o.kv + 2 * (st & 1) * buf);
    KV* vs = reinterpret_cast<KV*>(reinterpret_cast<unsigned char*>(ks) + buf);
    if constexpr (ASYNC) {
      const int units = D / VEC;
      for (int e = tid; e < sk * units; e += RPA_THREADS) {
        const int j = e / units;
        const int c = (e - j * units) * VEC;
        const int pg = j / ps;
        const long long off = (long long)pages_s[p0 + pg] * s_page +
                              (long long)(j - pg * ps) * s_row + c;
        pa_cp16(ks + j * rs + c, kb + off);
        pa_cp16(vs + j * rs + c, vb + off);
      }
    } else {
      for (int e = tid; e < sk * D; e += RPA_THREADS) {
        const int j = e / D;
        const int d = e - j * D;
        const int pg = j / ps;
        const long long off = (long long)pages_s[p0 + pg] * s_page +
                              (long long)(j - pg * ps) * s_row + d;
        ks[j * rs + d] = kb[off];
        vs[j * rs + d] = vb[off];
      }
    }
    pa_commit();  // (an empty group on the plain-load path)
  };
  auto factors = [=](int st) {
    if constexpr (INT8) {
      const int p0 = st * SG;
      const int sk = min(SG, n_sp - p0) * ps;
      float* fk = fk_s + (st & 1) * RPA_MAX_STAGE;
      for (int j = tid; j < sk; j += RPA_THREADS) {
        const long long page = pages_s[p0 + j / ps];
        fk[j] = pa_page_factor<KV>(k_scale, page, H, h);
        fk[2 * RPA_MAX_STAGE + j] = pa_page_factor<KV>(v_scale, page, H, h);
      }
    }
  };

  float m[RPA_RPW], l[RPA_RPW], acc[RPA_RPW][NDC];
#pragma unroll
  for (int r = 0; r < RPA_RPW; ++r) {
    m[r] = PA_NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int dc = 0; dc < NDC; ++dc) acc[r][dc] = 0.f;
  }
  const int nr = n_rows > warp ? (n_rows - warp + RPA_WARPS - 1) / RPA_WARPS
                               : 0;  // rows this warp owns
  const int kw = (SG * ps + RPA_WARPS - 1) / RPA_WARPS;

  issue(0);
  if (n_st > 1) issue(1);
  factors(0);
  if (n_st > 1) factors(1);
  for (int st = 0; st < n_st; ++st) {
    if (st + 1 < n_st)
      pa_wait<1>();
    else
      pa_wait<0>();
    __syncthreads();  // stage st (and q, the factors) visible to every warp
    const KV* ks = reinterpret_cast<const KV*>(rpa_smem_raw + o.kv +
                                               2 * (st & 1) * buf);
    const KV* vs = reinterpret_cast<const KV*>(
        reinterpret_cast<const unsigned char*>(ks) + buf);
    const float* fk = fk_s + (st & 1) * RPA_MAX_STAGE;
    const int sk = min(SG, n_sp - st * SG) * ps;
    const int col0 = (pg_lo + st * SG) * ps;
    if (n_rows == 1)
      rpa_row_stage<KV, VEC, NDC>(q_s, ks, vs, rs, fk,
                                  fk + 2 * RPA_MAX_STAGE, sk, kw, col0,
                                  qpos0, D, scale, m[0], l[0], acc[0]);
    else if (nr > 0)
      rpa_rows_stage<KV, VEC, NDC>(
          q_s, ks, vs, rs, fk, fk + 2 * RPA_MAX_STAGE,
          scratch + warp * RPA_MAX_STAGE * RPA_RPW, sk, col0, qpos0, D,
          scale, m, l, acc);
  }

  // ---- this split's rows: written out (one split) or to the workspace
  const volatile int* item_v = sh_item;
  const int row0 = item_v[0], split = item_v[2], n_splits = item_v[3];
  const int MS = rpa_max_splits(max_pages, ps);
  const int DR = rpa_record(D);
  auto put = [=](int row, float mm, float ll, float a, int d) {
    if (n_splits == 1) {
      out[row * hd + (long long)h * D + d] = a * (ll > 0.f ? 1.f / ll : 0.f);
    } else {
      float* rec = ws + (((long long)row * H + h) * MS + split) * DR;
      rec[d] = a;
      if (d == 0) {
        rec[D] = mm;
        rec[D + 1] = ll;
      }
    }
  };
  if (n_rows == 1) {
    // the 4 warps' shares of the row's keys, merged in warp order
    float* acc_w = scratch;
    float* m_w = scratch + RPA_WARPS * D;
    float* l_w = m_w + RPA_WARPS;
    if (lane == 0) {
      m_w[warp] = m[0];
      l_w[warp] = l[0];
    }
#pragma unroll
    for (int dc = 0; dc < NDC; ++dc) {
      const int d = lane + 32 * dc;
      if (d < D) acc_w[warp * D + d] = acc[0][dc];
    }
    __syncthreads();
    if (tid < D) {
      float mm = PA_NEG_INF;
#pragma unroll
      for (int w = 0; w < RPA_WARPS; ++w) mm = fmaxf(mm, m_w[w]);
      float ll = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < RPA_WARPS; ++w) {
        const float wt = expf(m_w[w] - mm);
        ll = fmaf(l_w[w], wt, ll);
        a = fmaf(acc_w[w * D + tid], wt, a);
      }
      put(row0, mm, ll, a, tid);
    }
  } else {
#pragma unroll
    for (int r = 0; r < RPA_RPW; ++r) {
      if (r >= nr) continue;
#pragma unroll
      for (int dc = 0; dc < NDC; ++dc) {
        const int d = lane + 32 * dc;
        if (d < D) put(row0 + warp + RPA_WARPS * r, m[r], l[r], acc[r][dc], d);
      }
    }
  }
  if (n_splits == 1) return;

  // ---- the last of the tile's items merges its splits in order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int seen = atomicAdd(&counters[row0 * H + h], 1);
    sh_last = seen == n_splits - 1;
  }
  __syncthreads();
  if (!sh_last) return;
  __threadfence();
  // Groups of the tile's records come into the free shared memory (q, the
  // stage buffers, the scratch) by cp.async, all copies in flight at once;
  // then each thread folds its row's elements part, part + tpr, ... of
  // the group into a running (M, L, acc) in split order.
  float* rec_s = reinterpret_cast<float*>(rpa_smem_raw + o.q);
  const int group = (o.fk - o.q) / (n_rows * DR * 4);  // splits a group
  const int tpr = n_rows == 1 ? RPA_THREADS : RPA_THREADS / RPA_QB;
  const int i = tid / tpr, part = tid - i * tpr;
  const float* rec_g = ws + ((long long)row0 * H + h) * MS * DR;
  const long long row_stride = (long long)H * MS * DR;  // next packed row
  float mm = PA_NEG_INF, ll = 0.f, a[PA_MAX_D / 8];
#pragma unroll
  for (int k = 0; k < PA_MAX_D / 8; ++k) a[k] = 0.f;
  for (int sp0 = 0; sp0 < n_splits; sp0 += group) {
    const int gn = min(group, n_splits - sp0);
    const int units = DR / 4;
    for (int e = tid; e < n_rows * gn * units; e += RPA_THREADS) {
      const int rr = e / (gn * units);
      const int rest = e - rr * gn * units;
      const int g = rest / units;
      pa_cp16(rec_s + (rr * gn + g) * DR + 4 * (rest - g * units),
              rec_g + rr * row_stride + (long long)(sp0 + g) * DR +
                  4 * (rest - g * units));
    }
    pa_commit();
    pa_wait<0>();
    __syncthreads();
    if (i < n_rows) {
      for (int g = 0; g < gn; ++g) {
        const float* rec = rec_s + (i * gn + g) * DR;
        const float m_sp = rec[D];
        const float m_new = fmaxf(mm, m_sp);
        const float c_old = expf(mm - m_new), c_sp = expf(m_sp - m_new);
        ll = fmaf(ll, c_old, rec[D + 1] * c_sp);
#pragma unroll
        for (int k = 0; k < PA_MAX_D / 8; ++k) {
          const int d = part + tpr * k;
          if (d < D) a[k] = fmaf(a[k], c_old, rec[d] * c_sp);
        }
        mm = m_new;
      }
    }
    __syncthreads();  // the group is consumed
  }
  if (i < n_rows) {
    const float inv = ll > 0.f ? 1.f / ll : 0.f;
    float* orow = out + (row0 + i) * hd + (long long)h * D;
#pragma unroll
    for (int k = 0; k < PA_MAX_D / 8; ++k) {
      const int d = part + tpr * k;
      if (d < D) orow[d] = a[k] * inv;
    }
  }
  if (tid == 0) counters[row0 * H + h] = 0;  // ready for the next launch
}

template <typename KV, int VEC, int NDC>
static int rpa_launch_vec(const void* q, const void* k_pool,
                          const void* v_pool, const void* k_scale,
                          const void* v_scale, long long s_page,
                          long long s_row, long long s_head,
                          const void* page_tables, int max_pages,
                          const void* starts, const void* lens,
                          const void* kv_lens, void* out, void* ws,
                          void* counters, int T, int S, int H, int D,
                          int page_size, float scale, cudaStream_t stream) {
  const long long by_tile = (long long)(T + RPA_QB - 1) / RPA_QB + S;
  const long long tiles = by_tile < T ? by_tile : T;
  const long long blocks = tiles * rpa_max_splits(max_pages, page_size) * H;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = rpa_smem<KV>(D, page_size, VEC > 1).total;
  const int err = pa_allow_smem(rpa_kernel<KV, VEC, NDC>, smem);
  if (err != 0) return err;
  const bool q_async = D % 4 == 0 && reinterpret_cast<size_t>(q) % 16 == 0;
  rpa_kernel<KV, VEC, NDC><<<(unsigned)blocks, RPA_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const KV*>(k_pool),
      static_cast<const KV*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), s_page, s_row, s_head,
      static_cast<const int*>(page_tables), max_pages,
      static_cast<const int*>(starts), static_cast<const int*>(lens),
      static_cast<const int*>(kv_lens), static_cast<float*>(out),
      static_cast<float*>(ws), static_cast<int*>(counters), T, S, H, D,
      page_size, scale, q_async);
  return (int)cudaGetLastError();
}

template <typename KV, int VEC>
static int rpa_launch_ndc(const void* q, const void* k_pool,
                          const void* v_pool, const void* k_scale,
                          const void* v_scale, long long s_page,
                          long long s_row, long long s_head,
                          const void* page_tables, int max_pages,
                          const void* starts, const void* lens,
                          const void* kv_lens, void* out, void* ws,
                          void* counters, int T, int S, int H, int D,
                          int page_size, float scale, cudaStream_t stream) {
  if (D <= 64)
    return rpa_launch_vec<KV, VEC, 2>(
        q, k_pool, v_pool, k_scale, v_scale, s_page, s_row, s_head,
        page_tables, max_pages, starts, lens, kv_lens, out, ws, counters, T,
        S, H, D, page_size, scale, stream);
  return rpa_launch_vec<KV, VEC, 4>(
      q, k_pool, v_pool, k_scale, v_scale, s_page, s_row, s_head,
      page_tables, max_pages, starts, lens, kv_lens, out, ws, counters, T,
      S, H, D, page_size, scale, stream);
}

template <typename KV>
static int rpa_launch(const void* q, const void* k_pool, const void* v_pool,
                      const void* k_scale, const void* v_scale,
                      long long s_page, long long s_row, long long s_head,
                      const void* page_tables, int max_pages,
                      const void* starts, const void* lens,
                      const void* kv_lens, void* out, void* ws,
                      void* counters, int T, int S, int H, int D,
                      int page_size, float scale, cudaStream_t stream) {
  if (pa_async16<KV>(k_pool, v_pool, D))
    return rpa_launch_ndc<KV, 16 / sizeof(KV)>(
        q, k_pool, v_pool, k_scale, v_scale, s_page, s_row, s_head,
        page_tables, max_pages, starts, lens, kv_lens, out, ws, counters, T,
        S, H, D, page_size, scale, stream);
  return rpa_launch_ndc<KV, 1>(q, k_pool, v_pool, k_scale, v_scale, s_page,
                               s_row, s_head, page_tables, max_pages, starts,
                               lens, kv_lens, out, ws, counters, T, S, H, D,
                               page_size, scale, stream);
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
  if (D < 1 || D > PA_MAX_D || page_size < 1 || page_size > PA_MAX_PS ||
      (kv_dtype == PA_KV_INT8) != (k_scale != nullptr && v_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case PA_KV_F32:
      return rpa_launch<float>(q, k_pool, v_pool, k_scale, v_scale, s_page,
                               s_row, s_head, page_tables, max_pages, starts,
                               lens, kv_lens, out, ws, counters, T, S, H, D,
                               page_size, scale, st);
    case PA_KV_BF16:
      return rpa_launch<__nv_bfloat16>(
          q, k_pool, v_pool, k_scale, v_scale, s_page, s_row, s_head,
          page_tables, max_pages, starts, lens, kv_lens, out, ws, counters,
          T, S, H, D, page_size, scale, st);
    case PA_KV_INT8:
      return rpa_launch<int8_t>(q, k_pool, v_pool, k_scale, v_scale, s_page,
                                s_row, s_head, page_tables, max_pages,
                                starts, lens, kv_lens, out, ws, counters, T,
                                S, H, D, page_size, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
