// Device code shared by the paged-attention kernels (ragged, paged decode,
// chunk prefill): pool element loads with the bf16 upcast and the int8
// dequant, staging one [page_size, D] K/V page into shared memory through
// the pool's strides, warp reductions, the online-softmax update of one
// query row over one staged page, and the whole walk of a tile of query
// rows over its pages (the ragged and chunk-prefill kernels' body).  Every
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
template <typename KV>
__device__ __forceinline__ float4 pa_dq4(float4 x, float factor) {
  return make_float4(pa_dq<KV>(x.x, factor), pa_dq<KV>(x.y, factor),
                     pa_dq<KV>(x.z, factor), pa_dq<KV>(x.w, factor));
}

// four consecutive elements as f32 (16 bytes of f32, 8 of bf16, 4 of int8)
__device__ __forceinline__ float4 pa_load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 pa_load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 pa_load4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
}

// Whether a pool pair takes 4-wide loads: D % 4 == 0 (then every page, row
// and head stride is a multiple of 4 elements too) and both pools aligned
// to 4 elements.  Otherwise (a pool that starts off such an address, or an
// odd D) every load is scalar.
template <typename KV>
inline bool pa_vec4(const void* k_pool, const void* v_pool, int D) {
  const size_t align = 4 * sizeof(KV);
  return D % 4 == 0 && reinterpret_cast<size_t>(k_pool) % align == 0 &&
         reinterpret_cast<size_t>(v_pool) % align == 0;
}

// Stage one [page_size, D] K and V page into shared memory as f32 (K rows
// with stride kst, V rows with stride D; int8 elements times their page
// factors kf, vf), the whole block cooperating.  With vec4 every thread
// first issues up to PA_STAGE 4-wide loads of K and of V, and only then
// stores them, so a page costs about one global-memory latency rather than
// one per element a thread copies.
#define PA_STAGE 4
template <typename KV>
__device__ __forceinline__ void pa_stage_page(
    const KV* __restrict__ kp, const KV* __restrict__ vp, long long s_row,
    float* k_s, float* v_s, int kst, int D, int page_size, bool vec4,
    float kf, float vf) {
  const int nt = blockDim.x;
  if (!vec4) {
    for (int e = threadIdx.x; e < page_size * D; e += nt) {
      const int j = e / D;
      const int d = e - j * D;
      const long long off = j * s_row + d;
      k_s[j * kst + d] = pa_dq<KV>(pa_to_f32(kp[off]), kf);
      v_s[j * D + d] = pa_dq<KV>(pa_to_f32(vp[off]), vf);
    }
    return;
  }
  const int n4 = page_size * D / 4;
  for (int base = threadIdx.x; base < n4; base += nt * PA_STAGE) {
    float4 kr[PA_STAGE], vr[PA_STAGE];
#pragma unroll
    for (int u = 0; u < PA_STAGE; ++u) {
      const int e = 4 * (base + u * nt);
      if (e < 4 * n4) {
        const int j = e / D;
        const long long off = j * s_row + (e - j * D);
        kr[u] = pa_dq4<KV>(pa_load4(kp + off), kf);
        vr[u] = pa_dq4<KV>(pa_load4(vp + off), vf);
      }
    }
#pragma unroll
    for (int u = 0; u < PA_STAGE; ++u) {
      const int e = 4 * (base + u * nt);
      if (e < 4 * n4) {
        const int j = e / D;
        const int d = e - j * D;
        float* kd = k_s + j * kst + d;
        float* vd = v_s + j * D + d;
        kd[0] = kr[u].x; kd[1] = kr[u].y; kd[2] = kr[u].z; kd[3] = kr[u].w;
        vd[0] = vr[u].x; vd[1] = vr[u].y; vd[2] = vr[u].z; vd[3] = vr[u].w;
      }
    }
  }
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

// The online-softmax update of ONE query row, held by one warp, over one
// staged page: q_row [D] (scale folded in) in shared memory, the page's
// K rows at k_s (stride kst) and V rows at v_s (stride D), keys at
// positions col0 + j.  Keys past the row's position qpos are masked and
// contribute exactly 0.  Lanes own keys j = lane, lane + 32 for the scores
// and D elements d = lane + 32 c for the P.V accumulate; (m, l, acc) stay
// in the calling warp's registers.
__device__ __forceinline__ void pa_row_page_update(
    const float* q_row, const float* k_s, int kst, const float* v_s, int D,
    int page_size, int col0, int qpos, float& m, float& l,
    float (&acc)[PA_MAX_D / 32]) {
  const int lane = threadIdx.x & 31;
  float p[PA_MAX_PS / 32];
  float mx = PA_NEG_INF;
#pragma unroll
  for (int c = 0; c < PA_MAX_PS / 32; ++c) {
    const int j = lane + 32 * c;
    float sc = PA_NEG_INF;
    if (j < page_size && col0 + j <= qpos) {
      float a = 0.f;
      const float* kr = k_s + j * kst;
      for (int d = 0; d < D; ++d) a = fmaf(q_row[d], kr[d], a);
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
  // P.V: lanes over D, p_j broadcast from the lane that owns key j
#pragma unroll
  for (int c = 0; c < PA_MAX_PS / 32; ++c) {
    const int jn = min(32, page_size - 32 * c);
    for (int jj = 0; jj < jn; ++jj) {
      const float pj = __shfl_sync(0xffffffffu, p[c], jj);
      const float* vr = v_s + (32 * c + jj) * D;
#pragma unroll
      for (int dc = 0; dc < PA_MAX_D / 32; ++dc) {
        const int d = lane + 32 * dc;
        if (d < D) acc[dc] = fmaf(pj, vr[d], acc[dc]);
      }
    }
  }
}

// One block's tile of n_rows (<= QB) consecutive query rows of one head h:
// rows row0 .. row0 + n_rows - 1 of q/out [*, H, D] sit at positions
// qpos0, qpos0 + 1, ... and attend causally through the page table pt
// (k_scale/v_scale: an int8 pool's [P, H] scales, NULL otherwise).
// The block walks pages 0 .. (last row's position) / page_size, at most
// max_pages: the whole block stages each K/V page into shared memory, then
// each of the WARPS warps updates the online-softmax state (m, l, acc) of
// its QB / WARPS rows in registers.  smem holds pa_staged_smem(QB, D,
// page_size) bytes.  A row that saw no key is written as zeros.  The ragged
// and the chunk-prefill kernels each work out their tile's descriptor and
// call this.
template <typename KV, int QB, int WARPS>
__device__ __forceinline__ void pa_attend_tile(
    const float* __restrict__ q, const KV* __restrict__ k_pool,
    const KV* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, long long s_page, long long s_row,
    long long s_head, const int* __restrict__ pt, int max_pages, int row0,
    int qpos0, int n_rows, int h, float* __restrict__ out, int H, int D,
    int page_size, float scale, bool vec4, float* smem) {
  constexpr int RPW = QB / WARPS;                 // rows per warp
  const int n_pages = min((qpos0 + n_rows - 1) / page_size + 1, max_pages);
  float* q_s = smem;                              // [QB][D], scale folded
  float* k_s = q_s + QB * D;                      // [page_size][D + 1]
  float* v_s = k_s + page_size * (D + 1);         // [page_size][D]
  const int kst = D + 1;  // odd row stride: conflict-free column reads
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long hd = (long long)H * D;

  for (int e = tid; e < n_rows * D; e += blockDim.x) {
    const int i = e / D;
    const int d = e - i * D;
    q_s[i * D + d] = q[(row0 + i) * hd + (long long)h * D + d] * scale;
  }

  float m[RPW], l[RPW];
  float acc[RPW][PA_MAX_D / 32];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = PA_NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < PA_MAX_D / 32; ++c) acc[r][c] = 0.f;
  }

  const KV* kb = k_pool + (long long)h * s_head;
  const KV* vb = v_pool + (long long)h * s_head;
  for (int pi = 0; pi < n_pages; ++pi) {
    const long long page = pt[pi];
    __syncthreads();  // q_s written; the previous page consumed
    pa_stage_page(kb + page * s_page, vb + page * s_page, s_row, k_s, v_s,
                  kst, D, page_size, vec4,
                  pa_page_factor<KV>(k_scale, page, H, h),
                  pa_page_factor<KV>(v_scale, page, H, h));
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int i = warp * RPW + r;
      if (i >= n_rows) break;  // warp-uniform
      pa_row_page_update(q_s + i * D, k_s, kst, v_s, D, page_size,
                         pi * page_size, qpos0 + i, m[r], l[r], acc[r]);
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int i = warp * RPW + r;
    if (i >= n_rows) break;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    float* orow = out + (row0 + i) * hd + (long long)h * D;
#pragma unroll
    for (int dc = 0; dc < PA_MAX_D / 32; ++dc) {
      const int d = lane + 32 * dc;
      if (d < D) orow[d] = acc[r][dc] * inv;
    }
  }
}

// Shared-memory bytes of a block that holds `q_rows` query rows and one
// staged K page (rows padded to D + 1: conflict-free column reads) and V
// page; above 48 KB the kernel must be allowed more first.
inline size_t pa_staged_smem(int q_rows, int D, int page_size) {
  return sizeof(float) * ((size_t)q_rows * D +
                          (size_t)page_size * (D + 1) +
                          (size_t)page_size * D);
}

template <typename Kernel>
inline int pa_allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// ---- Raw staging: cp.async copies of pool bytes, converted on read ----
//
// Kernels that keep page loads in flight copy K/V rows into shared memory
// as they lie in the pool (16-byte cp.async, no registers held) and
// convert each element when they read it: bf16 upcast, int8 times its page
// factor, so the operands entering the products are the same f32 values
// the staging above produces.

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

// The pool dtype codes of the C entry points.
enum PaKvDtype { PA_KV_F32 = 0, PA_KV_BF16 = 1, PA_KV_INT8 = 2 };

extern "C" const char* pa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
