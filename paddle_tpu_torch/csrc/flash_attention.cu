// Flash attention for training on Hopper (sm_90a), fp32 arithmetic:
// the forward, the dK/dV and the dQ kernels.
//
// Replaces the Pallas TPU kernels of
// paddle_tpu/ops/pallas/flash_attention.py: _flash_fwd_call (body
// _fwd_kernel), and _flash_bwd_call's _bwd_dkdv_kernel and
// _bwd_dq_kernel.  Inputs are [BH, L, D] row-major, float32 or bfloat16:
// qs (q with the 1/sqrt(D) scale folded in), k, v, and for the backward
// dO [BH, Lq, D] plus lse and delta [BH, Lq] f32 (delta = rowsum(dO*out),
// computed by the caller).  km is null or an additive key mask [Bm, Lk]
// f32 read at row bh / heads.  Under causal, query row i sees key j iff
// i + (Lk - Lq) >= j.  Masked scores are NEG_INF and their weights are
// exactly 0 (s <= NEG_INF / 2), so a row that sees no key gets out 0 and
// lse NEG_INF.  With bf16 inputs, p and dS are rounded to bf16 before
// their products (the Pallas bodies' p.astype(v.dtype), ds.astype(q.dtype));
// outputs are in the input dtype.
//
// Design.  The TPU grid runs in order and carries the online-softmax
// state (or the dK/dV, dQ sums) in VMEM scratch across its last grid
// axis.  Here each block owns one 64-row tile outright and walks the
// other axis in a loop, so nothing crosses blocks and no atomics are
// needed (the results are deterministic):
// - forward: one block per (64-row q tile, bh); K and V tiles of 64 keys
//   are staged in shared memory, the state (m, l, acc) stays in
//   registers; under causal the K tiles past the tile's last row's limit
//   are never read (_causal_block_runs), the diagonal tile is masked;
// - dK/dV: one block per (64-key tile, bh), walking the q tiles that can
//   see it, dK and dV summed in registers;
// - dQ: one block per (q tile, bh), walking the K tiles.
// 256 threads as a 16 x 16 grid: thread (ty, tx) computes a 4 x 4 block
// of each 64 x 64 score tile (rows ty*4.., columns tx, tx+16, ...) and
// owns 4 rows x ceil(D/16) columns (tx, tx+16, ...) of each output tile.
// A row's 16 threads are one half-warp, so row max and sum are four
// shuffles.  Tiles sit in shared memory with rows padded to D + 1 floats,
// so column walks are free of bank conflicts.
//
// What bounds it on an H100.  At the training shape (BH 96, L 512, D 64,
// causal) the forward does 2 products of 2*L*L/2*D flops per head and
// moves ~50 MB: 67 TFLOP/s of fp32 FMA bounds it by operations (~48 us),
// and the backward's 4 (dK/dV) and 3 (dQ) products likewise.  This first
// version reads its operands from shared memory at 2 FMAs per load, so
// shared-memory bandwidth, not the FMA rate, sets its time; register
// tiles larger than 4 x 4, cp.async/TMA staging and wgmma on bf16 (TF32
// would break the 2e-5 parity with the fp32 plain versions) are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define FA_B 64                // rows of a q tile = keys of a K tile
#define FA_THREADS 256
#define FA_MAX_D 128
#define FA_NEG_INF (-1e30f)
#define FA_LDP (FA_B + 1)      // row stride of the 64 x 64 weight tiles

__device__ __forceinline__ float fa_f32(float x) { return x; }
__device__ __forceinline__ float fa_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T fa_out(float x);
template <>
__device__ __forceinline__ float fa_out<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 fa_out<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// x rounded to T's precision (round to nearest even), back in f32
template <typename T>
__device__ __forceinline__ float fa_round(float x) {
  return fa_f32(fa_out<T>(x));
}

__device__ __forceinline__ float fa_half_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float fa_half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows row0 .. row0 + 63 of a [n_rows, D] matrix into dst[64][ld] as
// f32; rows past n_rows are zeros.
template <typename T>
__device__ __forceinline__ void fa_load_tile(const T* __restrict__ src,
                                             int row0, int n_rows, int D,
                                             float* dst, int ld) {
  for (int e = threadIdx.x; e < FA_B * D; e += FA_THREADS) {
    const int i = e / D;
    const int d = e - i * D;
    const int row = row0 + i;
    dst[i * ld + d] = row < n_rows ? fa_f32(src[(long long)row * D + d])
                                   : 0.f;
  }
}

// s[r][c] += A[ty*4 + r] . B[tx + 16c] over D (rows of two [64][ld]
// tiles); with A2/B2 also s2 += A2[..] . B2[..] in the same walk.
template <bool TWO>
__device__ __forceinline__ void fa_dots(const float* A, const float* B,
                                        const float* A2, const float* B2,
                                        int ld, int D, int ty, int tx,
                                        float s[4][4], float s2[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[r][c] = 0.f;
      if (TWO) s2[r][c] = 0.f;
    }
  const float* a = A + ty * 4 * ld;
  const float* b = B + tx * ld;
  const float* a2 = TWO ? A2 + ty * 4 * ld : nullptr;
  const float* b2 = TWO ? B2 + tx * ld : nullptr;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = a[r * ld + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = b[16 * c * ld + d];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = fmaf(av[r], bv[c], s[r][c]);
    if (TWO) {
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = a2[r * ld + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = b2[16 * c * ld + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s2[r][c] = fmaf(av[r], bv[c], s2[r][c]);
    }
  }
}

// The masked score of (row, key): NEG_INF past either edge or above the
// causal diagonal; the key mask added otherwise.
__device__ __forceinline__ float fa_mask(float s, int row, int key, int Lq,
                                         int Lk, const float* kmr,
                                         bool causal, int offset) {
  if (row >= Lq || key >= Lk) return FA_NEG_INF;
  if (kmr) s += kmr[key];
  if (causal && row + offset < key) return FA_NEG_INF;
  return s;
}

// K tiles a q tile starting at row q0 walks: all, or under causal those
// up to its last real row's limit (none when that limit is negative).
__device__ __forceinline__ int fa_k_tiles(int q0, int Lq, int Lk,
                                          bool causal) {
  const int n = (Lk + FA_B - 1) / FA_B;
  if (!causal) return n;
  const int limit = min(q0 + FA_B, Lq) - 1 + (Lk - Lq);
  return limit < 0 ? 0 : min(n, limit / FA_B + 1);
}

// ------------------------------ forward ---------------------------------

template <typename T, int NC>
__global__ void __launch_bounds__(FA_THREADS)
fa_fwd_kernel(const T* __restrict__ qs, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ km,
              int heads, bool causal, T* __restrict__ out,
              float* __restrict__ lse, int Lq, int Lk, int D) {
  const int qb = blockIdx.x;
  const int bh = blockIdx.y;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int ld = D + 1;
  const int offset = Lk - Lq;
  const int q0 = qb * FA_B;
  extern __shared__ float smem[];
  float* q_s = smem;                 // [64][ld]
  float* k_s = q_s + FA_B * ld;      // [64][ld]
  float* v_s = k_s + FA_B * ld;      // [64][ld]
  float* p_s = v_s + FA_B * ld;      // [64][FA_LDP]
  const T* kg = k + (long long)bh * Lk * D;
  const T* vg = v + (long long)bh * Lk * D;
  const float* kmr = km ? km + (long long)(bh / heads) * Lk : nullptr;
  fa_load_tile(qs + (long long)bh * Lq * D, q0, Lq, D, q_s, ld);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = FA_NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }
  const int n_kb = fa_k_tiles(q0, Lq, Lk, causal);
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * FA_B;
    __syncthreads();  // q_s written; the previous tiles consumed
    fa_load_tile(kg, k0, Lk, D, k_s, ld);
    fa_load_tile(vg, k0, Lk, D, v_s, ld);
    __syncthreads();
    float s[4][4];
    fa_dots<false>(q_s, k_s, nullptr, nullptr, ld, D, ty, tx, s, s);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty * 4 + r;
      float mx = FA_NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = fa_mask(s[r][c], q0 + i, k0 + tx + 16 * c, Lq, Lk, kmr,
                          causal, offset);
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_cur = fmaxf(m[r], fa_half_max(mx));
      const float alpha = expf(m[r] - m_cur);  // rescale of the old state
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p =
            s[r][c] <= FA_NEG_INF * 0.5f ? 0.f : expf(s[r][c] - m_cur);
        psum += p;
        p_s[i * FA_LDP + tx + 16 * c] = fa_round<T>(p);
      }
      l[r] = l[r] * alpha + fa_half_sum(psum);
      m[r] = m_cur;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();
    for (int j = 0; j < FA_B; ++j) {
      float pr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) pr[r] = p_s[(ty * 4 + r) * FA_LDP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 16 * c;
        if (d < D) {
          const float vv = v_s[j * ld + d];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(pr[r], vv, acc[r][c]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty * 4 + r;
    if (row >= Lq) continue;
    const float safe_l = l[r] > 0.f ? l[r] : 1.f;
    T* orow = out + ((long long)bh * Lq + row) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) orow[d] = fa_out<T>(acc[r][c] / safe_l);
    }
    if (tx == 0)
      lse[(long long)bh * Lq + row] =
          l[r] > 0.f ? m[r] + logf(safe_l) : FA_NEG_INF;
  }
}

// ------------------------------- dK/dV ----------------------------------

template <typename T, int NC>
__global__ void __launch_bounds__(FA_THREADS)
fa_dkdv_kernel(const T* __restrict__ qs, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ km,
               int heads, bool causal, const T* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk,
               T* __restrict__ dv, int Lq, int Lk, int D) {
  const int kb = blockIdx.x;
  const int bh = blockIdx.y;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int ld = D + 1;
  const int offset = Lk - Lq;
  const int k0 = kb * FA_B;
  extern __shared__ float smem[];
  float* k_s = smem;                    // [64][ld]
  float* v_s = k_s + FA_B * ld;         // [64][ld]
  float* q_s = v_s + FA_B * ld;         // [64][ld]
  float* do_s = q_s + FA_B * ld;        // [64][ld]
  float* pt_s = do_s + FA_B * ld;       // [64 keys][FA_LDP]: p^T
  float* dst_s = pt_s + FA_B * FA_LDP;  // [64 keys][FA_LDP]: dS^T
  float* lse_s = dst_s + FA_B * FA_LDP; // [64]
  float* delta_s = lse_s + FA_B;        // [64]
  const T* qg = qs + (long long)bh * Lq * D;
  const T* dog = dout + (long long)bh * Lq * D;
  const float* kmr = km ? km + (long long)(bh / heads) * Lk : nullptr;
  fa_load_tile(k + (long long)bh * Lk * D, k0, Lk, D, k_s, ld);
  fa_load_tile(v + (long long)bh * Lk * D, k0, Lk, D, v_s, ld);

  float dka[4][NC], dva[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dka[r][c] = dva[r][c] = 0.f;
  // the first q tile that can see key k0: its row k0 - offset
  const int first = causal ? k0 - offset : 0;
  const int n_qb = (Lq + FA_B - 1) / FA_B;
  for (int qb = first <= 0 ? 0 : first / FA_B; qb < n_qb; ++qb) {
    const int q0 = qb * FA_B;
    __syncthreads();  // k_s, v_s written; the previous q tile consumed
    fa_load_tile(qg, q0, Lq, D, q_s, ld);
    fa_load_tile(dog, q0, Lq, D, do_s, ld);
    for (int i = threadIdx.x; i < FA_B; i += FA_THREADS) {
      const bool live = q0 + i < Lq;
      lse_s[i] = live ? lse[(long long)bh * Lq + q0 + i] : 0.f;
      delta_s[i] = live ? delta[(long long)bh * Lq + q0 + i] : 0.f;
    }
    __syncthreads();
    // transposed tiles: rows are keys (ty*4 + r), columns q rows (tx+16c)
    float st[4][4], dpt[4][4];
    fa_dots<true>(k_s, q_s, v_s, do_s, ld, D, ty, tx, st, dpt);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = ty * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = tx + 16 * c;
        const float s = fa_mask(st[r][c], q0 + i, k0 + j, Lq, Lk, kmr,
                                causal, offset);
        const float p =
            s <= FA_NEG_INF * 0.5f ? 0.f : expf(s - lse_s[i]);
        pt_s[j * FA_LDP + i] = fa_round<T>(p);
        dst_s[j * FA_LDP + i] = fa_round<T>(p * (dpt[r][c] - delta_s[i]));
      }
    }
    __syncthreads();
    for (int i = 0; i < FA_B; ++i) {
      float pr[4], dr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pr[r] = pt_s[(ty * 4 + r) * FA_LDP + i];
        dr[r] = dst_s[(ty * 4 + r) * FA_LDP + i];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 16 * c;
        if (d < D) {
          const float o = do_s[i * ld + d];
          const float qv = q_s[i * ld + d];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            dva[r][c] = fmaf(pr[r], o, dva[r][c]);
            dka[r][c] = fmaf(dr[r], qv, dka[r][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = k0 + ty * 4 + r;
    if (key >= Lk) continue;
    const long long base = ((long long)bh * Lk + key) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) {
        dk[base + d] = fa_out<T>(dka[r][c]);
        dv[base + d] = fa_out<T>(dva[r][c]);
      }
    }
  }
}

// -------------------------------- dQ ------------------------------------

template <typename T, int NC>
__global__ void __launch_bounds__(FA_THREADS)
fa_dq_kernel(const T* __restrict__ qs, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ km,
             int heads, bool causal, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, int Lq, int Lk, int D) {
  const int qb = blockIdx.x;
  const int bh = blockIdx.y;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int ld = D + 1;
  const int offset = Lk - Lq;
  const int q0 = qb * FA_B;
  extern __shared__ float smem[];
  float* q_s = smem;                   // [64][ld]
  float* do_s = q_s + FA_B * ld;       // [64][ld]
  float* k_s = do_s + FA_B * ld;       // [64][ld]
  float* v_s = k_s + FA_B * ld;        // [64][ld]
  float* ds_s = v_s + FA_B * ld;       // [64 rows][FA_LDP]
  float* lse_s = ds_s + FA_B * FA_LDP; // [64]
  float* delta_s = lse_s + FA_B;       // [64]
  const T* kg = k + (long long)bh * Lk * D;
  const T* vg = v + (long long)bh * Lk * D;
  const float* kmr = km ? km + (long long)(bh / heads) * Lk : nullptr;
  fa_load_tile(qs + (long long)bh * Lq * D, q0, Lq, D, q_s, ld);
  fa_load_tile(dout + (long long)bh * Lq * D, q0, Lq, D, do_s, ld);
  for (int i = threadIdx.x; i < FA_B; i += FA_THREADS) {
    const bool live = q0 + i < Lq;
    lse_s[i] = live ? lse[(long long)bh * Lq + q0 + i] : 0.f;
    delta_s[i] = live ? delta[(long long)bh * Lq + q0 + i] : 0.f;
  }

  float dqa[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dqa[r][c] = 0.f;
  const int n_kb = fa_k_tiles(q0, Lq, Lk, causal);
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * FA_B;
    __syncthreads();  // q_s, do_s, lse_s, delta_s written; tiles consumed
    fa_load_tile(kg, k0, Lk, D, k_s, ld);
    fa_load_tile(vg, k0, Lk, D, v_s, ld);
    __syncthreads();
    float s[4][4], dp[4][4];
    fa_dots<true>(q_s, k_s, do_s, v_s, ld, D, ty, tx, s, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        const float sc = fa_mask(s[r][c], q0 + i, k0 + j, Lq, Lk, kmr,
                                 causal, offset);
        const float p =
            sc <= FA_NEG_INF * 0.5f ? 0.f : expf(sc - lse_s[i]);
        ds_s[i * FA_LDP + j] = fa_round<T>(p * (dp[r][c] - delta_s[i]));
      }
    }
    __syncthreads();
    for (int j = 0; j < FA_B; ++j) {
      float dr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) dr[r] = ds_s[(ty * 4 + r) * FA_LDP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 16 * c;
        if (d < D) {
          const float kv = k_s[j * ld + d];
#pragma unroll
          for (int r = 0; r < 4; ++r) dqa[r][c] = fmaf(dr[r], kv, dqa[r][c]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty * 4 + r;
    if (row >= Lq) continue;
    T* dqr = dq + ((long long)bh * Lq + row) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) dqr[d] = fa_out<T>(dqa[r][c]);
    }
  }
}

// ------------------------------ launches --------------------------------

// dynamic shared memory of each kernel at head dim D (kept equal to
// paddle_tpu_torch/ops/flash_attention.py::kernel_smem_bytes)
static size_t fa_smem_fwd(int D) {
  return sizeof(float) * (3 * FA_B * (D + 1) + FA_B * FA_LDP);
}
static size_t fa_smem_dkdv(int D) {
  return sizeof(float) *
         (4 * FA_B * (D + 1) + 2 * FA_B * FA_LDP + 2 * FA_B);
}
static size_t fa_smem_dq(int D) {
  return sizeof(float) * (4 * FA_B * (D + 1) + FA_B * FA_LDP + 2 * FA_B);
}

// Allow `kernel` the most shared memory any head dim of its NC needs,
// once per instantiation.
template <typename Kernel>
static int fa_allow(Kernel kernel, size_t smem, bool* done) {
  if (*done || smem <= 48 * 1024) return 0;
  const int rc = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc == 0) *done = true;
  return rc;
}

template <typename T, int NC>
static int fa_fwd_launch(const void* qs, const void* k, const void* v,
                         const void* km, int heads, int causal, void* out,
                         void* lse, int BH, int Lq, int Lk, int D,
                         cudaStream_t st) {
  static bool allowed = false;
  const int rc = fa_allow(fa_fwd_kernel<T, NC>, fa_smem_fwd(16 * NC),
                          &allowed);
  if (rc) return rc;
  dim3 grid((Lq + FA_B - 1) / FA_B, BH);
  fa_fwd_kernel<T, NC><<<grid, FA_THREADS, fa_smem_fwd(D), st>>>(
      static_cast<const T*>(qs), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(km), heads,
      causal != 0, static_cast<T*>(out), static_cast<float*>(lse), Lq, Lk,
      D);
  return (int)cudaGetLastError();
}

template <typename T, int NC>
static int fa_dkdv_launch(const void* qs, const void* k, const void* v,
                          const void* km, int heads, int causal,
                          const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv, int BH,
                          int Lq, int Lk, int D, cudaStream_t st) {
  static bool allowed = false;
  const int rc = fa_allow(fa_dkdv_kernel<T, NC>, fa_smem_dkdv(16 * NC),
                          &allowed);
  if (rc) return rc;
  dim3 grid((Lk + FA_B - 1) / FA_B, BH);
  fa_dkdv_kernel<T, NC><<<grid, FA_THREADS, fa_smem_dkdv(D), st>>>(
      static_cast<const T*>(qs), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(km), heads,
      causal != 0, static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), Lq, Lk, D);
  return (int)cudaGetLastError();
}

template <typename T, int NC>
static int fa_dq_launch(const void* qs, const void* k, const void* v,
                        const void* km, int heads, int causal,
                        const void* dout, const void* lse,
                        const void* delta, void* dq, int BH, int Lq, int Lk,
                        int D, cudaStream_t st) {
  static bool allowed = false;
  const int rc = fa_allow(fa_dq_kernel<T, NC>, fa_smem_dq(16 * NC),
                          &allowed);
  if (rc) return rc;
  dim3 grid((Lq + FA_B - 1) / FA_B, BH);
  fa_dq_kernel<T, NC><<<grid, FA_THREADS, fa_smem_dq(D), st>>>(
      static_cast<const T*>(qs), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(km), heads,
      causal != 0, static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), Lq, Lk, D);
  return (int)cudaGetLastError();
}

// One instantiation per dtype and column count NC = ceil(D / 16) rounded
// up to 2, 4 or 8.
#define FA_DISPATCH(LAUNCH, ...)                                      \
  do {                                                                \
    if (bf16) {                                                       \
      if (D <= 32) return LAUNCH<__nv_bfloat16, 2>(__VA_ARGS__);      \
      if (D <= 64) return LAUNCH<__nv_bfloat16, 4>(__VA_ARGS__);      \
      return LAUNCH<__nv_bfloat16, 8>(__VA_ARGS__);                   \
    }                                                                 \
    if (D <= 32) return LAUNCH<float, 2>(__VA_ARGS__);                \
    if (D <= 64) return LAUNCH<float, 4>(__VA_ARGS__);                \
    return LAUNCH<float, 8>(__VA_ARGS__);                             \
  } while (0)

static bool fa_bad_shape(int BH, int Lq, int Lk, int D, int heads) {
  return D < 1 || D > FA_MAX_D || BH > 65535 || Lq < 0 || Lk < 0 ||
         heads < 1;
}

// qs/out [BH, Lq, D], k/v [BH, Lk, D] (f32, or bf16 when bf16 != 0),
// km null or [Bm, Lk] f32, lse [BH, Lq] f32; all contiguous.  Returns the
// CUDA error code of the launch (0 on success).
extern "C" int fa_flash_fwd(const void* qs, const void* k, const void* v,
                            const void* km, int heads, int causal, int bf16,
                            void* out, void* lse, int BH, int Lq, int Lk,
                            int D, void* stream) {
  if (fa_bad_shape(BH, Lq, Lk, D, heads)) return (int)cudaErrorInvalidValue;
  if (BH == 0 || Lq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FA_DISPATCH(fa_fwd_launch, qs, k, v, km, heads, causal, out, lse, BH, Lq,
              Lk, D, st);
}

// As fa_flash_fwd, plus dout [BH, Lq, D] in the input dtype and delta
// [BH, Lq] f32; writes dk, dv [BH, Lk, D] in the input dtype.
extern "C" int fa_flash_bwd_dkdv(const void* qs, const void* k,
                                 const void* v, const void* km, int heads,
                                 int causal, int bf16, const void* dout,
                                 const void* lse, const void* delta,
                                 void* dk, void* dv, int BH, int Lq, int Lk,
                                 int D, void* stream) {
  if (fa_bad_shape(BH, Lq, Lk, D, heads)) return (int)cudaErrorInvalidValue;
  if (BH == 0 || Lk == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FA_DISPATCH(fa_dkdv_launch, qs, k, v, km, heads, causal, dout, lse,
              delta, dk, dv, BH, Lq, Lk, D, st);
}

// As fa_flash_bwd_dkdv; writes dq [BH, Lq, D] (of the scaled qs).
extern "C" int fa_flash_bwd_dq(const void* qs, const void* k,
                               const void* v, const void* km, int heads,
                               int causal, int bf16, const void* dout,
                               const void* lse, const void* delta, void* dq,
                               int BH, int Lq, int Lk, int D, void* stream) {
  if (fa_bad_shape(BH, Lq, Lk, D, heads)) return (int)cudaErrorInvalidValue;
  if (BH == 0 || Lq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FA_DISPATCH(fa_dq_launch, qs, k, v, km, heads, causal, dout, lse, delta,
              dq, BH, Lq, Lk, D, st);
}

extern "C" const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
