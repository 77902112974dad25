// Device code shared by the paged-attention kernels (ragged, paged decode,
// chunk prefill): pool element conversion (the bf16 upcast, the int8
// dequant), cp.async staging, warp reductions, and the split walk that all
// three run: one work item, a tile of query rows over one split of its
// keys, from staging through the merge of the tile's splits.  Every
// kernel computes in fp32 with f32 accumulation on the CUDA cores; TF32
// tensor cores would break the 2e-5 parity with the fp32 plain versions.
//
// Pools are float, __nv_bfloat16 or int8_t (the KV template parameter).
// An int8 pool comes with [P, H] float32 scales for K and V: element x of
// page p, head h decodes as float(x) * (scale[p * H + h] * (1/127)), the
// factor computed first in f32, exactly the Pallas bodies' and the plain
// versions' expression, so the operands entering the products are bitwise
// equal to theirs.  Pages are dequantized as they are read; no pool is
// ever dequantized as a whole.
//
// The split walk (rpa_walk_item; the ragged kernel's source gives the
// design at length).  A work item is a tile of n_rows consecutive query
// rows of one head: RPA_QB = 16 rows of one sequence (rows over the 4
// warps, 4 each) or one row (a decode row: the 4 warps share its keys).
// A tile's keys up to its last row's position (at most max_pages pages)
// are cut into splits of SP = ceil(64 / page_size) whole pages
// (rpa_tile_splits); one block runs one (tile, split, head).  A split's
// pages come in two halves by 16-byte cp.async copies of the raw pool
// bytes, the second landing while the first is consumed; bf16 and int8
// are converted as they are read from shared memory.  A tile with one
// split writes its rows; otherwise each item writes its (acc, m, l)
// records to a workspace, and the tile's last arriving item (an int
// counter per (tile's first row, head)) merges them in split order and
// sets the counter back to 0: the same bits from every launch.  Each
// kernel finds its block's item its own way and calls the walk.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define PA_MAX_D 128
#define PA_MAX_PS 64
#define PA_NEG_INF (-1e30f)
#define PA_INV_QMAX (1.0f / 127.0f)  // == float32(1/127)

__device__ __forceinline__ float pa_to_f32(float x) { return x; }
__device__ __forceinline__ float pa_to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float pa_to_f32(int8_t x) { return (float)x; }

// The dequant factor of page `page`, head h: scale * (1/127) for an int8
// pool, 1 (never applied) for a float one, whose scale is NULL.
template <typename KV>
__device__ __forceinline__ float pa_page_factor(const float* scale,
                                                long long page, int H,
                                                int h) {
  if constexpr (std::is_same<KV, int8_t>::value)
    return scale[page * H + h] * PA_INV_QMAX;
  else
    return 1.f;
}

// A loaded element as the products see it: int8 times its page factor,
// float and bf16 as they are.
template <typename KV>
__device__ __forceinline__ float pa_dq(float x, float factor) {
  if constexpr (std::is_same<KV, int8_t>::value)
    return x * factor;
  else
    return x;
}

__device__ __forceinline__ float pa_warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float pa_warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename Kernel>
inline int pa_allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// ---- Raw staging: cp.async copies of pool bytes, converted on read ----
//
// K/V rows are copied into shared memory as they lie in the pool (16-byte
// cp.async, no registers held) and each element is converted when it is
// read: bf16 upcast, int8 times its page factor.

__device__ __forceinline__ void pa_cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void pa_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void pa_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Whether a pool pair takes 16-byte copies: a row of D elements is a whole
// number of 16-byte units (then so is every page, row and head stride) and
// both pools start on a 16-byte boundary.
template <typename KV>
inline bool pa_async16(const void* k_pool, const void* v_pool, int D) {
  return (D * sizeof(KV)) % 16 == 0 &&
         reinterpret_cast<size_t>(k_pool) % 16 == 0 &&
         reinterpret_cast<size_t>(v_pool) % 16 == 0;
}

// 16 raw bytes at p (shared memory, 16-byte aligned).
__device__ __forceinline__ uint4 pa_raw16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// Elements 4 g .. 4 g + 3 of 16 raw bytes of KV elements as f32, int8
// times `factor` (g < 16 / (4 sizeof(KV)), a compile-time constant where
// unrolled).
template <typename KV>
__device__ __forceinline__ float4 pa_unpack4(uint4 raw, int g,
                                             float factor) {
  if constexpr (std::is_same<KV, float>::value) {
    return make_float4(__uint_as_float(raw.x), __uint_as_float(raw.y),
                       __uint_as_float(raw.z), __uint_as_float(raw.w));
  } else if constexpr (std::is_same<KV, __nv_bfloat16>::value) {
    const unsigned a = g == 0 ? raw.x : raw.z, b = g == 0 ? raw.y : raw.w;
    // a bf16 is the top half of an f32
    return make_float4(__uint_as_float(a << 16),
                       __uint_as_float(a & 0xffff0000u),
                       __uint_as_float(b << 16),
                       __uint_as_float(b & 0xffff0000u));
  } else {
    const unsigned w =
        g == 0 ? raw.x : g == 1 ? raw.y : g == 2 ? raw.z : raw.w;
    // sign-extend byte i of the word, then the page factor
    return make_float4((float)((int)(w << 24) >> 24) * factor,
                       (float)((int)(w << 16) >> 24) * factor,
                       (float)((int)(w << 8) >> 24) * factor,
                       (float)((int)w >> 24) * factor);
  }
}

// a + dot(q, x) over 4 elements, in order
__device__ __forceinline__ float pa_dot4(float4 q, float4 x, float a) {
  a = fmaf(q.x, x.x, a);
  a = fmaf(q.y, x.y, a);
  a = fmaf(q.z, x.z, a);
  return fmaf(q.w, x.w, a);
}

// ---- The split walk ----

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

// Splits of tile t (rows [16 t, 16 t + 16) of len) of a sequence whose
// len rows end at its kv-th key, so row r sits at position kv - len + r:
// 0 when no row of the tile sees a key.  ops/paged_attention.py::
// ragged_tile_splits mirrors this rule.
__host__ __device__ inline int rpa_tile_splits(int len, int kv, int t,
                                               int ps, int max_pages) {
  const int off = t * RPA_QB;
  const int rows = len - off < RPA_QB ? len - off : RPA_QB;
  const int qlast = kv - len + off + rows - 1;
  if (qlast < 0) return 0;
  const int sp = rpa_split_pages(ps);
  const int pages = qlast / ps + 1 < max_pages ? qlast / ps + 1 : max_pages;
  return (pages + sp - 1) / sp;
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

// One work item, run by the whole block of RPA_THREADS threads: rows row0
// .. row0 + n_rows - 1 (n_rows 1 or up to RPA_QB) of q/out [*, H, D] at
// positions qpos0, qpos0 + 1, ... of head h attend causally to the keys
// of split `split` of their tile's n_splits, through pt_row, the page
// table of their sequence ([max_pages] entries).  ws [rows, H, MS, DR]
// f32 (MS = rpa_max_splits, DR = rpa_record) and counters [rows * H]
// int32, zero, take a tile with more than one split; the dynamic shared
// memory is rpa_smem(...).total bytes.  VEC: elements a staged read takes
// (16 bytes of them on the cp.async path, 1 on the plain-load path; a
// pool the cp.async path cannot take is staged by plain loads into rows
// of an odd word count).  NDC: 32-element chunks of D a lane accumulates
// (2 up to D 64, else 4).  q_async: q rows are copied by cp.async too.
template <typename KV, int VEC, int NDC>
__device__ __forceinline__ void rpa_walk_item(
    const float* __restrict__ q, const KV* __restrict__ k_pool,
    const KV* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, long long s_page, long long s_row,
    long long s_head, const int* __restrict__ pt_row, int max_pages,
    int row0, int n_rows, int split, int n_splits, int qpos0, int h,
    float* __restrict__ out, float* __restrict__ ws,
    int* __restrict__ counters, int H, int D, int ps, float scale,
    bool q_async) {
  constexpr bool ASYNC = VEC > 1;
  constexpr bool INT8 = std::is_same<KV, int8_t>::value;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // row0, split and n_splits are read back from here after the stages, so
  // nothing of them needs to stay in registers through them
  __shared__ int sh_item[3];
  __shared__ int sh_last;
  if (tid == 0) {
    sh_item[0] = row0;
    sh_item[1] = split;
    sh_item[2] = n_splits;
  }
  const int SP = rpa_split_pages(ps), SG = rpa_stage_pages(ps);
  const int n_pages = min((qpos0 + n_rows - 1) / ps + 1, max_pages);
  const int pg_lo = split * SP;
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
  const float* qb = q + (long long)row0 * hd + (long long)h * D;
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
  const int* pt = pt_row + pg_lo;
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
  row0 = item_v[0];
  split = item_v[1];
  n_splits = item_v[2];
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
  const long long row_stride = (long long)H * MS * DR;  // next row
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

// ---- Launching ----

// The pool dtype codes of the C entry points.
enum PaKvDtype { PA_KV_F32 = 0, PA_KV_BF16 = 1, PA_KV_INT8 = 2 };

// The instantiation a launch takes: the pool type, VEC and NDC (see
// rpa_walk_item).
template <typename KV_, int VEC_, int NDC_>
struct PaInst {
  using KV = KV_;
  static constexpr int VEC = VEC_, NDC = NDC_;
};

template <typename KV, int VEC, typename F>
inline int pa_dispatch_ndc(int D, F& launch) {
  if (D <= 64) return launch(PaInst<KV, VEC, 2>{});
  return launch(PaInst<KV, VEC, 4>{});
}

template <typename KV, typename F>
inline int pa_dispatch_vec(const void* k_pool, const void* v_pool, int D,
                           F& launch) {
  if (pa_async16<KV>(k_pool, v_pool, D))
    return pa_dispatch_ndc<KV, 16 / sizeof(KV)>(D, launch);
  return pa_dispatch_ndc<KV, 1>(D, launch);
}

// launch(PaInst<KV, VEC, NDC>{}) for the pool dtype code, the pools'
// alignment and D; returns its result (a CUDA error code).
template <typename F>
inline int pa_dispatch(int kv_dtype, const void* k_pool, const void* v_pool,
                       int D, F&& launch) {
  switch (kv_dtype) {
    case PA_KV_F32:
      return pa_dispatch_vec<float>(k_pool, v_pool, D, launch);
    case PA_KV_BF16:
      return pa_dispatch_vec<__nv_bfloat16>(k_pool, v_pool, D, launch);
    case PA_KV_INT8:
      return pa_dispatch_vec<int8_t>(k_pool, v_pool, D, launch);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Launch `kernel` on `blocks` blocks of RPA_THREADS threads with the split
// walk's shared memory for the instantiation I; returns the CUDA error
// code of the launch.
template <typename I, typename... KArgs, typename... Args>
inline int pa_launch(void (*kernel)(KArgs...), long long blocks, int D,
                     int ps, cudaStream_t stream, Args... args) {
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = rpa_smem<typename I::KV>(D, ps, I::VEC > 1).total;
  const int err = pa_allow_smem(kernel, smem);
  if (err != 0) return err;
  kernel<<<(unsigned)blocks, RPA_THREADS, smem, stream>>>(
      static_cast<KArgs>(args)...);
  return (int)cudaGetLastError();
}

// Whether q's rows take 16-byte copies.
inline bool pa_q_async(const void* q, int D) {
  return D % 4 == 0 && reinterpret_cast<size_t>(q) % 16 == 0;
}

// The argument checks the three entry points share: what the kernels take
// (D, page size, a page table) and scales with an int8 pool only.
inline bool pa_bad_args(int kv_dtype, const void* k_scale,
                        const void* v_scale, int D, int page_size,
                        int max_pages) {
  return D < 1 || D > PA_MAX_D || page_size < 1 || page_size > PA_MAX_PS ||
         max_pages < 1 ||
         (kv_dtype == PA_KV_INT8) != (k_scale != nullptr &&
                                      v_scale != nullptr);
}

extern "C" const char* pa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
