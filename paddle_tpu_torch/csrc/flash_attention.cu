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
// All three kernels run on the tensor cores with mma.sync and share one
// set of building blocks (the fb_* helpers below); each block owns a
// 64-row tile and walks the other axis in tiles of 32 rows, so each
// output element is summed by one thread in a fixed order: no atomics,
// and two runs give bitwise equal results.
//
// Forward design (fa_fwd_kernel).  The TPU grid runs in order and carries
// the online-softmax state in VMEM scratch across its last grid axis.
// Here one block of 4 warps owns 64 q rows of one head (16 rows a warp)
// and walks the K/V tiles of 32 keys in a loop, so nothing crosses
// blocks; under causal the K tiles past the tile's last row's limit are
// never read, and a warp skips the tiles past its own 16 rows' limit.
// K, V and the key-mask row arrive by cp.async as in the backward (below).
// S = Q.K^T is computed into registers (fb_scores), masked there, and
// the online softmax runs on the accumulator fragments: a lane holds rows
// g and g + 8 and columns 2t, 2t + 1 of each 8-key tile, so a row's max
// and sum are two shuffles across the lane quad; the state (m, l and the
// [16, D] accumulator) stays in registers and is rescaled by exp(m_old -
// m_new).  The weights p feed out += P.V (fb_accumulate) as A operands
// as they stand.  With bf16 inputs p is rounded to bf16 before P.V while
// l sums the unrounded p, as the Pallas body does.  Q is read from shared
// memory for every K tile, as in the dQ kernel.  __launch_bounds__(128,
// 3) holds a thread to 168 registers, so three blocks share an SM (at D
// 64, f32: 49,408 bytes of shared memory each).  Holding Q's split
// fragments in registers instead needs more than 168 (two blocks an SM,
// slower), and under the same bound it spills and is no faster.
//
// What bounds the forward on an H100.  At the training shape (BH 96, L
// 512, D 64, causal) it does 2 products of 2*D flops per visible (row,
// key) pair, 3.2 GFLOP (19.6 us at the 3xTF32 rate), against ~50 MB (15
// us at 3.35 TB/s): bound by operations, like the backward.
//
// Backward design (fa_dkdv_kernel, fa_dq_kernel: one body,
// fa_bwd_body).  Each block owns a 64-row tile (dK/dV: 64 keys with
// their K and V; dQ: 64 q rows with their Q, dO, lse and delta) and walks
// the other axis in tiles of 32 rows.  dQ stays its own kernel, so S and
// dP are computed by both (7 products where a fused kernel with atomics
// needs 5).
// - Products on tensor cores with mma.sync.  4 warps, each owning 16 rows
//   of the owned tile.  S (dK/dV: S^T = K.Q^T) and dP are computed into
//   registers; p = exp(s - lse) and dS = p (dP - delta) run on the
//   accumulator fragments, which then feed the second products (dV +=
//   P^T.dO, dK += dS^T.Q; dQ += dS.K) as A operands without a trip
//   through shared memory.  fp32 inputs take m16n8k8 TF32 MMAs in the
//   3xTF32 split: a = big + small with big = a rounded to TF32 (to
//   nearest, ties away: cvt.rna.tf32.f32's rounding, done as an add and a
//   mask, since cvt.rna compiles to a longer compare-and-select sequence
//   that made both kernels markedly slower on an H100) and small = a -
//   big (exact; the MMA reads it
//   truncated to TF32), and acc += small_a.big_b + big_a.small_b +
//   big_a.big_b, which keeps the products at fp32 accuracy (one-pass
//   TF32 keeps 10 mantissa bits and misses the 1e-4 parity with the fp32
//   plain versions).  The m16n8 accumulator gives a thread columns 2t,
//   2t+1 of each 8-column tile where the TF32 A operand wants t, t+4: the
//   second products permute their k index inside each 8-step instead
//   (A position t <- column 2t, t+4 <- 2t+1, and B rows read to match),
//   so no shuffle is needed.  bf16 inputs take m16n8k16 bf16 MMAs, with
//   operands read by ldmatrix (.trans for the transposed reads); their
//   accumulator layout is already the A layout.  p and dS are rounded to
//   the input dtype before their products (a no-op for fp32).
// - Staging.  The walked tiles (dK/dV: Q, dO, lse, delta; dQ: K, V and
//   the key mask) arrive by cp.async into the second of two buffers
//   while the first is computed, behind cp.async.wait_group and one
//   barrier; the owned tiles are loaded once with the first walked
//   tile.  Rows whose address is 16-byte aligned take 16-byte copies,
//   else 4-byte copies where 4-byte aligned (f32 and bf16 at D = 30),
//   else plain loads (bf16 at odd D).  Columns past D and rows past L
//   are zero-filled by the copy (its source size 0), so D 16/30 and
//   ragged L need no other masking of the products.
// - Shared memory without bank conflicts.  Q, dO (dK/dV) and K (dQ) are
//   read along rows (B of S = X.Y^T) and along columns (B of the second
//   products), and no single row padding serves both.  Tiles are
//   unpadded, rows at least 8 chunks of 16 bytes wide (32 f32 or 64 bf16
//   elements), and chunk c of row r is stored at chunk c ^ (r & 7): the
//   direct reads (rows g = lane/4, column t) and the permuted column reads
//   (rows 2t, 2t+1, columns g) each fall on 32 distinct banks, and so do
//   the 8 row addresses of every ldmatrix.  At D = 64, f32: 66,048 bytes
//   per block (2 owned tiles of 64 rows, 2 x 2 walked tiles of 32, the
//   lse / delta / key-mask rows), so 3 blocks of 128 threads share an SM.
// - Longest walk first.  The grid is one-dimensional with bh fastest:
//   dK/dV starts the lowest key tiles (under causal they see the most q
//   tiles) across all bh, dQ the highest q tiles.
//
// What bounds the backward on an H100.  At the training shape dK/dV does
// 4 products and dQ 3 of 2*D flops per visible (row, key) pair: 6.5 and
// 4.8 GFLOP, about 39 and 29 us at the 3xTF32 rate (495 / 3 = 165
// TFLOP/s dense), against 76 and 63 MB (23 and 19 us at 3.35 TB/s): they
// are bound by operations.  They reach about a fifth of that bound:
// mma.sync runs below the rate only wgmma reaches, and the split's add,
// mask and subtract for every operand read take as many issue slots as
// the MMAs themselves.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define FA_MAX_D 128
#define FA_NEG_INF (-1e30f)

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

// The masked score of (row, key): NEG_INF past either edge or above the
// causal diagonal; the key's mask value kmv added otherwise.
__device__ __forceinline__ float fa_mask(float s, int row, int key, int Lq,
                                         int Lk, float kmv, bool causal,
                                         int offset) {
  if (row >= Lq || key >= Lk || (causal && row + offset < key))
    return FA_NEG_INF;
  return s + kmv;
}

// ---------------------------- building blocks -----------------------------

#define FB_M 64          // rows of the owned tile: 4 warps x 16
#define FB_N 32          // rows of a walked tile
#define FB_THREADS 128

// Row width in elements of a tile for head dims up to DMAX: at
// least 8 chunks of 16 bytes, so the XOR swizzle stays inside the row.
template <typename T, int DMAX>
__host__ __device__ constexpr int fb_width() {
  return DMAX > 128 / (int)sizeof(T) ? DMAX : 128 / (int)sizeof(T);
}

// Element (r, c) of a swizzled tile of W-element rows: 16-byte chunk
// c / CH of row r sits at chunk (c / CH) ^ (r & 7).
template <typename T, int W>
__device__ __forceinline__ int fb_idx(int r, int c) {
  constexpr int CH = 16 / sizeof(T);
  return r * W + (((c / CH) ^ (r & 7)) * CH) + (c % CH);
}

__device__ __forceinline__ unsigned fb_smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// cp.async of `bytes` (0 or the full size) from src; the rest of the
// destination is zero-filled
__device__ __forceinline__ void fb_cp16(void* dst, const void* src,
                                        int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   fb_smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void fb_cp4(void* dst, const void* src,
                                       int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   fb_smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void fb_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void fb_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// How rows of D elements at `p` can be copied: 16 (16-byte cp.async), 4
// (4-byte cp.async) or 0 (plain loads).
template <typename T>
__device__ __forceinline__ int fb_copy_mode(const T* p, int D) {
  const unsigned long long a = (unsigned long long)p;
  const int row = D * (int)sizeof(T);
  if (a % 16 == 0 && row % 16 == 0) return 16;
  if (a % 4 == 0 && row % 4 == 0) return 4;
  return 0;
}

// Rows row0 .. row0 + ROWS - 1 of a [n_rows, D] matrix into the swizzled
// tile dst[ROWS][W]; elements past D or n_rows are zeros.
template <typename T, int W, int ROWS>
__device__ __forceinline__ void fb_load_tile(const T* __restrict__ src,
                                             int row0, int n_rows, int D,
                                             T* dst, int mode) {
  if (mode == 16) {
    constexpr int PER = 16 / sizeof(T), UNITS = W / PER;
    for (int e = threadIdx.x; e < ROWS * UNITS; e += FB_THREADS) {
      const int i = e / UNITS, c = (e % UNITS) * PER, row = row0 + i;
      const bool live = row < n_rows && c < D;
      fb_cp16(dst + fb_idx<T, W>(i, c),
              live ? src + (long long)row * D + c : src, live ? 16 : 0);
    }
  } else if (mode == 4) {
    constexpr int PER = 4 / sizeof(T), UNITS = W / PER;
    for (int e = threadIdx.x; e < ROWS * UNITS; e += FB_THREADS) {
      const int i = e / UNITS, c = (e % UNITS) * PER, row = row0 + i;
      const bool live = row < n_rows && c < D;
      fb_cp4(dst + fb_idx<T, W>(i, c),
             live ? src + (long long)row * D + c : src, live ? 4 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * W; e += FB_THREADS) {
      const int i = e / W, c = e % W, row = row0 + i;
      dst[fb_idx<T, W>(i, c)] = row < n_rows && c < D
                                    ? src[(long long)row * D + c]
                                    : fa_out<T>(0.f);
    }
  }
}

// src[row0 .. row0 + FB_N - 1] (f32) into dst, zeros past n
__device__ __forceinline__ void fb_load_row(const float* __restrict__ src,
                                            int row0, int n, float* dst) {
  const int i = threadIdx.x;
  if (i < FB_N) {
    const bool live = row0 + i < n;
    fb_cp4(dst + i, live ? src + row0 + i : src, live ? 4 : 0);
  }
}

// x = big + small for the 3xTF32 products: big is x rounded to TF32 to
// nearest, ties away (cvt.rna.tf32.f32's rounding as an add and a mask,
// bit-identical for finite x; see the note at the head), small = x - big
// is exact in fp32, and the MMA reads it as TF32 by ignoring its 13 low
// bits.
__device__ __forceinline__ void fb_split(float x, unsigned& big,
                                         unsigned& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}
__device__ __forceinline__ void fb_mma_tf32(float c[4], const unsigned a[4],
                                            unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c += a.b at fp32 accuracy: the 3xTF32 split, small products first
__device__ __forceinline__ void fb_mma3(float c[4], const unsigned ab[4],
                                        const unsigned as[4],
                                        const unsigned bb[2],
                                        const unsigned bs[2]) {
  fb_mma_tf32(c, as, bb[0], bb[1]);
  fb_mma_tf32(c, ab, bs[0], bs[1]);
  fb_mma_tf32(c, ab, bb[0], bb[1]);
}
__device__ __forceinline__ void fb_split4(const float x[4], unsigned big[4],
                                          unsigned small[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) fb_split(x[i], big[i], small[i]);
}

__device__ __forceinline__ void fb_mma_bf16(float c[4], const unsigned a[4],
                                            unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void fb_ldsm4(unsigned r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(fb_smem_addr(p)));
}
__device__ __forceinline__ void fb_ldsm4_t(unsigned r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(fb_smem_addr(p)));
}
__device__ __forceinline__ unsigned fb_pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Per-lane parts of the swizzled offsets (fb_idx) of every fragment
// read, so that each read in the unrolled loops below is one of these
// plus a compile-time constant.  lane = 4g + t.
template <typename T, int W>
struct FbLane {
  // f32, direct: (row r0 + g, column 4C + t) is at r0 W + 4 (C & ~7) +
  // dir[C & 7] (r0 a multiple of 8)
  int dir[8];
  // f32, permuted columns: (row k0 + 2t + e, column 8dt + g) is at k0 W +
  // 8 (dt & ~3) + tr[dt & 3][e] (k0 a multiple of 8)
  int tr[4][2];
  // bf16, ldmatrix row addresses of a 16 x 16 block at rows r0, chunks
  // K (even): A and .trans reads at r0 W + 8 (K & ~7) + la[(K & 7) / 2],
  // B direct reads likewise with lb
  int la[4], lb[4];

  __device__ __forceinline__ explicit FbLane(int lane) {
    const int g = lane >> 2, t = lane & 3;
    const int rl = lane & 7, hi = lane >> 4, m1 = (lane >> 3) & 1;
#pragma unroll
    for (int c = 0; c < 8; ++c) dir[c] = g * W + (c ^ g) * 4 + t;
#pragma unroll
    for (int d3 = 0; d3 < 4; ++d3)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        tr[d3][e] = (2 * t + e) * W +
                    (2 * (d3 ^ t) + ((g >> 2) ^ e)) * 4 + (g & 3);
#pragma unroll
    for (int k4 = 0; k4 < 4; ++k4) {
      la[k4] = (rl + 8 * m1) * W + ((2 * k4) ^ hi ^ rl) * 8;
      lb[k4] = (rl + 8 * hi) * W + ((2 * k4) ^ m1 ^ rl) * 8;
    }
  }
};

// s[nt] += X[16 rows of xa] . Y[rows 8nt .. 8nt + 7 of yb]^T over DMAX
// columns, for the FB_N / 8 column tiles nt (lane g = lane / 4, t =
// lane % 4; accumulator rows g, g + 8, columns 2t, 2t + 1).
template <typename T, int DMAX, int W>
__device__ __forceinline__ void fb_scores(const T* xa, const T* yb,
                                          float s[FB_N / 8][4],
                                          const FbLane<T, W>& o) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int k0 = 0; k0 < DMAX; k0 += 8) {
      // columns k0 + t (chunk C0) and k0 + t + 4 (chunk C0 + 1)
      const int C0 = k0 / 4, C1 = C0 + 1;
      const int off0 = 4 * (C0 & ~7) + o.dir[C0 & 7];
      const int off1 = 4 * (C1 & ~7) + o.dir[C1 & 7];
      const float a[4] = {xa[off0], xa[8 * W + off0], xa[off1],
                          xa[8 * W + off1]};
      unsigned ab[4], as[4];
      fb_split4(a, ab, as);
#pragma unroll
      for (int nt = 0; nt < FB_N / 8; ++nt) {
        unsigned bb[2], bs[2];
        fb_split(yb[8 * nt * W + off0], bb[0], bs[0]);
        fb_split(yb[8 * nt * W + off1], bb[1], bs[1]);
        fb_mma3(s[nt], ab, as, bb, bs);
      }
    }
  } else {
#pragma unroll
    for (int k0 = 0; k0 < DMAX; k0 += 16) {
      const int K = k0 / 8;
      unsigned a[4];
      fb_ldsm4(a, xa + 8 * (K & ~7) + o.la[(K & 7) >> 1]);
#pragma unroll
      for (int np = 0; np < FB_N / 16; ++np) {
        unsigned b[4];
        fb_ldsm4(b, yb + 16 * np * W + 8 * (K & ~7) + o.lb[(K & 7) >> 1]);
        fb_mma_bf16(s[2 * np], a, b[0], b[1]);
        fb_mma_bf16(s[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
}

// acc[dt] += P . Y[:, 8dt .. 8dt + 7]: P the [16, FB_N] accumulator
// fragments of fb_scores (already in T's precision), Y the walked tile yb
// [FB_N rows][DMAX columns].  For TF32 the k index is permuted inside
// each 8-step (A position t <- column 2t, t + 4 <- 2t + 1; B rows 2t,
// 2t + 1 to match), so the accumulator serves as A as it stands.
template <typename T, int DMAX, int W>
__device__ __forceinline__ void fb_accumulate(float p[FB_N / 8][4],
                                              const T* yb,
                                              float acc[DMAX / 8][4],
                                              const FbLane<T, W>& o) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int kc = 0; kc < FB_N / 8; ++kc) {
      const float a[4] = {p[kc][0], p[kc][2], p[kc][1], p[kc][3]};
      unsigned ab[4], as[4];
      fb_split4(a, ab, as);
#pragma unroll
      for (int dt = 0; dt < DMAX / 8; ++dt) {
        const T* y = yb + 8 * kc * W + 8 * (dt & ~3);
        unsigned bb[2], bs[2];
        fb_split(y[o.tr[dt & 3][0]], bb[0], bs[0]);
        fb_split(y[o.tr[dt & 3][1]], bb[1], bs[1]);
        fb_mma3(acc[dt], ab, as, bb, bs);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < FB_N / 16; ++kk) {
      const unsigned a[4] = {fb_pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                             fb_pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                             fb_pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                             fb_pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DMAX / 16; ++dp) {
        const int K = 2 * dp;
        unsigned b[4];
        fb_ldsm4_t(b, yb + 16 * kk * W + 8 * (K & ~7) + o.la[(K & 7) >> 1]);
        fb_mma_bf16(acc[2 * dp], a, b[0], b[1]);
        fb_mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
  }
}

// ------------------------------ forward ---------------------------------

// Block b owns q tile n_q - 1 - b / BH (the highest first: under causal
// they walk the most K tiles) of head b % BH.
template <typename T, int NC>
__global__ void __launch_bounds__(FB_THREADS, 3)
fa_fwd_kernel(const T* __restrict__ qs, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ km,
              int heads, bool causal, T* __restrict__ out,
              float* __restrict__ lse, int BH, int Lq, int Lk, int D) {
  constexpr int DMAX = 16 * NC;
  constexpr int W = fb_width<T, DMAX>();
  constexpr int NT = FB_N / 8, DT = DMAX / 8;
  const int bh = blockIdx.x % BH;
  const int n_q = (Lq + FB_M - 1) / FB_M;
  const int q0 = (n_q - 1 - (int)(blockIdx.x / BH)) * FB_M;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int offset = Lk - Lq;

  extern __shared__ __align__(16) unsigned char fb_smem[];
  T* q_s = reinterpret_cast<T*>(fb_smem);  // [FB_M][W]
  T* ys = q_s + FB_M * W;                  // 2 buffers x {K, V} [FB_N][W]
  float* km_s = reinterpret_cast<float*>(ys + 4 * FB_N * W);  // 2 x FB_N

  const T* qg = qs + (long long)bh * Lq * D;
  const T* kg = k + (long long)bh * Lk * D;
  const T* vg = v + (long long)bh * Lk * D;
  const float* kmr = km ? km + (long long)(bh / heads) * Lk : nullptr;
  const int mode_k = fb_copy_mode(kg, D), mode_v = fb_copy_mode(vg, D);

  // the K tiles the block walks (up to its last row's causal limit), and
  // those this warp's 16 rows see
  const int n_walk = (Lk + FB_N - 1) / FB_N;
  auto tiles_to = [&](int last_row) {
    if (!causal) return n_walk;
    const int limit = last_row + offset;
    return limit < 0 ? 0 : min(n_walk, limit / FB_N + 1);
  };
  const int w_end = tiles_to(min(q0 + FB_M, Lq) - 1);
  const int r0 = q0 + warp * 16;
  const int w_warp = r0 >= Lq ? 0 : tiles_to(min(r0 + 16, Lq) - 1);

  auto stage = [&](int w, int buf) {
    T* kb = ys + buf * 2 * FB_N * W;
    fb_load_tile<T, W, FB_N>(kg, w * FB_N, Lk, D, kb, mode_k);
    fb_load_tile<T, W, FB_N>(vg, w * FB_N, Lk, D, kb + FB_N * W, mode_v);
    if (kmr) fb_load_row(kmr, w * FB_N, Lk, km_s + buf * FB_N);
  };

  float m[2] = {FA_NEG_INF, FA_NEG_INF}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  if (w_end > 0) {
    fb_load_tile<T, W, FB_M>(qg, q0, Lq, D, q_s, fb_copy_mode(qg, D));
    stage(0, 0);
  }
  fb_commit();
  const FbLane<T, W> lane_off(lane);
  const T* xa = q_s + warp * 16 * W;
  for (int w = 0; w < w_end; ++w) {
    const int buf = w & 1;
    if (w + 1 < w_end) stage(w + 1, buf ^ 1);
    fb_commit();
    fb_wait<1>();  // tile w (and Q) arrived
    __syncthreads();
    if (w < w_warp) {
      const T* kt = ys + buf * 2 * FB_N * W;
      const T* vt = kt + FB_N * W;
      const float* kmt = km_s + buf * FB_N;
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      fb_scores<T, DMAX, W>(xa, kt, s, lane_off);
      // mask; each row's max over the tile (rows g + 8h, h = e / 2)
      float mx[2] = {FA_NEG_INF, FA_NEG_INF};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cw = 8 * nt + 2 * t + (e & 1);
          s[nt][e] = fa_mask(s[nt][e], r0 + g + 8 * (e >> 1), w * FB_N + cw,
                             Lq, Lk, kmr ? kmt[cw] : 0.f, causal, offset);
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
      float m_new[2], alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        m_new[h] = fmaxf(m[h], mx[h]);
        alpha[h] = expf(m[h] - m_new[h]);  // rescale of the old state
      }
      // p = exp(s - m_new), exactly 0 where masked; l sums the f32 p,
      // P.V takes p rounded to T
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = s[nt][e] <= FA_NEG_INF * 0.5f
                              ? 0.f
                              : expf(s[nt][e] - m_new[e >> 1]);
          psum[e >> 1] += p;
          s[nt][e] = fa_round<T>(p);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 1);
        psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 2);
        l[h] = l[h] * alpha[h] + psum[h];
        m[h] = m_new[h];
      }
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[dt][e] *= alpha[e >> 1];
      fb_accumulate<T, DMAX, W>(s, vt, acc, lane_off);
    }
    __syncthreads();  // buffer buf consumed before it is staged again
  }
  fb_wait<0>();

  // out = acc / l in T; lse = m + log(l), or NEG_INF with out 0 for a row
  // that sees no key
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r >= Lq) continue;
    const float safe_l = l[h] > 0.f ? l[h] : 1.f;
    T* orow = out + ((long long)bh * Lq + r) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d = 8 * dt + 2 * t + j;
        if (d < D) orow[d] = fa_out<T>(acc[dt][2 * h + j] / safe_l);
      }
    if (t == 0)
      lse[(long long)bh * Lq + r] =
          l[h] > 0.f ? m[h] + logf(safe_l) : FA_NEG_INF;
  }
}

// ---------------------------- backward ----------------------------------

// The body of both backward kernels.  DQ = false (dK/dV): the block owns
// 64 keys (K, V) and walks the q tiles that see them; out1 = dk, out2 =
// dv.  DQ = true: the block owns 64 q rows (Q, dO, lse, delta) and walks
// the K tiles they see; out1 = dq.  Block b is owned tile b / BH (dQ:
// counted from the last) of head b % BH.
template <typename T, int NC, bool DQ>
__device__ __forceinline__ void fa_bwd_body(
    const T* __restrict__ qs, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ km, int heads,
    bool causal, const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ out1,
    T* __restrict__ out2, int BH, int Lq, int Lk, int D) {
  constexpr int DMAX = 16 * NC;
  constexpr int W = fb_width<T, DMAX>();
  constexpr int NT = FB_N / 8, DT = DMAX / 8;
  const int bh = blockIdx.x % BH;
  const int L_own = DQ ? Lq : Lk, L_walk = DQ ? Lk : Lq;
  const int n_own = (L_own + FB_M - 1) / FB_M;
  const int ob = DQ ? n_own - 1 - (int)(blockIdx.x / BH) : blockIdx.x / BH;
  const int o0 = ob * FB_M;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int offset = Lk - Lq;

  extern __shared__ __align__(16) unsigned char fb_smem[];
  T* x1 = reinterpret_cast<T*>(fb_smem);  // owned [FB_M][W]: K or Q
  T* x2 = x1 + FB_M * W;                  // owned: V or dO
  T* ys = x2 + FB_M * W;                  // 2 buffers x {Y1, Y2} [FB_N][W]
  float* rows_s = reinterpret_cast<float*>(ys + 4 * FB_N * W);
  // rows_s: 2 buffers x [2][FB_N]: lse, delta (dK/dV) or key mask (dQ)

  const long long qo = (long long)bh * Lq * D, ko = (long long)bh * Lk * D;
  const T* own1 = DQ ? qs + qo : k + ko;
  const T* own2 = DQ ? dout + qo : v + ko;
  const T* walk1 = DQ ? k + ko : qs + qo;
  const T* walk2 = DQ ? v + ko : dout + qo;
  const float* kmr = km ? km + (long long)(bh / heads) * Lk : nullptr;
  const float* lser = lse + (long long)bh * Lq;
  const float* deltar = delta + (long long)bh * Lq;
  const int mode_w1 = fb_copy_mode(walk1, D), mode_w2 = fb_copy_mode(walk2, D);

  // the walked tiles: dQ those up to its last row's causal limit,
  // dK/dV those from the first q row that sees key o0
  const int n_walk = (L_walk + FB_N - 1) / FB_N;
  int w_first = 0, w_end = n_walk;
  if (causal) {
    if (DQ) {
      const int limit = min(o0 + FB_M, Lq) - 1 + offset;
      w_end = limit < 0 ? 0 : min(n_walk, limit / FB_N + 1);
    } else {
      const int first = o0 - offset;
      w_first = first <= 0 ? 0 : first / FB_N;
    }
  }

  // this thread's owned rows (accumulator rows g and g + 8 of its warp)
  float lse_o[2], delta_o[2], km_o[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = o0 + warp * 16 + g + 8 * h;
    lse_o[h] = DQ && r < Lq ? lser[r] : 0.f;
    delta_o[h] = DQ && r < Lq ? deltar[r] : 0.f;
    km_o[h] = !DQ && kmr && r < Lk ? kmr[r] : 0.f;
  }

  auto stage = [&](int w, int buf) {
    T* y1 = ys + buf * 2 * FB_N * W;
    fb_load_tile<T, W, FB_N>(walk1, w * FB_N, L_walk, D, y1, mode_w1);
    fb_load_tile<T, W, FB_N>(walk2, w * FB_N, L_walk, D, y1 + FB_N * W,
                             mode_w2);
    float* rb = rows_s + buf * 2 * FB_N;
    if (DQ) {
      if (kmr) fb_load_row(kmr, w * FB_N, Lk, rb);
    } else {
      fb_load_row(lser, w * FB_N, Lq, rb);
      fb_load_row(deltar, w * FB_N, Lq, rb + FB_N);
    }
  };

  float acc[DQ ? 1 : 2][DT][4];
#pragma unroll
  for (int o = 0; o < (DQ ? 1 : 2); ++o)
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[o][dt][e] = 0.f;

  if (w_first < w_end) {
    fb_load_tile<T, W, FB_M>(own1, o0, L_own, D, x1, fb_copy_mode(own1, D));
    fb_load_tile<T, W, FB_M>(own2, o0, L_own, D, x2, fb_copy_mode(own2, D));
    stage(w_first, 0);
  }
  fb_commit();
  const FbLane<T, W> lane_off(lane);
  const T* xa1 = x1 + warp * 16 * W;
  const T* xa2 = x2 + warp * 16 * W;
  for (int w = w_first; w < w_end; ++w) {
    const int buf = (w - w_first) & 1;
    if (w + 1 < w_end) stage(w + 1, buf ^ 1);
    fb_commit();
    fb_wait<1>();  // tile w (and the owned tiles) arrived
    __syncthreads();
    const T* y1 = ys + buf * 2 * FB_N * W;
    const T* y2 = y1 + FB_N * W;
    const float* rb = rows_s + buf * 2 * FB_N;
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    fb_scores<T, DMAX, W>(xa1, y1, s, lane_off);   // S (dK/dV: S^T)
    fb_scores<T, DMAX, W>(xa2, y2, dp, lane_off);  // dP (dK/dV: dP^T)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int r = o0 + warp * 16 + g + 8 * h;  // owned row
        const int cw = 8 * nt + 2 * t + (e & 1);   // walked row in tile
        const int c = w * FB_N + cw;
        const int row = DQ ? r : c, key = DQ ? c : r;
        float sc = s[nt][e];
        if (row >= Lq || key >= Lk || (causal && row + offset < key))
          sc = FA_NEG_INF;
        else
          sc += DQ ? (kmr ? rb[cw] : 0.f) : km_o[h];
        const float l = DQ ? lse_o[h] : rb[cw];
        const float dl = DQ ? delta_o[h] : rb[FB_N + cw];
        const float p = sc <= FA_NEG_INF * 0.5f ? 0.f : expf(sc - l);
        s[nt][e] = fa_round<T>(p);
        dp[nt][e] = fa_round<T>(p * (dp[nt][e] - dl));
      }
    // dK/dV: dK += dS^T.Q, dV += P^T.dO; dQ: dQ += dS.K
    fb_accumulate<T, DMAX, W>(dp, y1, acc[0], lane_off);
    if constexpr (!DQ) fb_accumulate<T, DMAX, W>(s, y2, acc[1], lane_off);
    __syncthreads();  // buffer buf consumed before it is staged again
  }
  fb_wait<0>();

#pragma unroll
  for (int o = 0; o < (DQ ? 1 : 2); ++o) {
    T* dst = (o == 0 ? out1 : out2) + (long long)bh * L_own * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = o0 + warp * 16 + g + 8 * h;
      if (r >= L_own) continue;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int d = 8 * dt + 2 * t + j;
          if (d < D)
            dst[(long long)r * D + d] = fa_out<T>(acc[o][dt][2 * h + j]);
        }
    }
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(FB_THREADS)
fa_dkdv_kernel(const T* __restrict__ qs, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ km,
               int heads, bool causal, const T* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk,
               T* __restrict__ dv, int BH, int Lq, int Lk, int D) {
  fa_bwd_body<T, NC, false>(qs, k, v, km, heads, causal, dout, lse, delta,
                            dk, dv, BH, Lq, Lk, D);
}

template <typename T, int NC>
__global__ void __launch_bounds__(FB_THREADS)
fa_dq_kernel(const T* __restrict__ qs, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ km,
             int heads, bool causal, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, int BH, int Lq, int Lk, int D) {
  fa_bwd_body<T, NC, true>(qs, k, v, km, heads, causal, dout, lse, delta,
                           dq, nullptr, BH, Lq, Lk, D);
}

// ------------------------------ launches --------------------------------

// dynamic shared memory of each kernel at column count NC, dtype T (the
// largest is kept equal to
// paddle_tpu_torch/ops/flash_attention.py::kernel_smem_bytes).
// Forward: the Q tile of FB_M rows, two buffers of the K and V tiles of
// FB_N rows, two buffers of the key-mask row of FB_N
template <typename T, int NC>
static size_t fa_smem_fwd() {
  return sizeof(T) * fb_width<T, 16 * NC>() * (FB_M + 4 * FB_N) +
         sizeof(float) * 2 * FB_N;
}
// both backward kernels at column count NC, dtype T: two owned tiles of
// FB_M rows, two buffers of two walked tiles of FB_N rows, two buffers of
// two f32 rows of FB_N
template <typename T, int NC>
static size_t fa_smem_bwd() {
  return sizeof(T) * fb_width<T, 16 * NC>() * (2 * FB_M + 4 * FB_N) +
         sizeof(float) * 4 * FB_N;
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
  const size_t smem = fa_smem_fwd<T, NC>();
  const int rc = fa_allow(fa_fwd_kernel<T, NC>, smem, &allowed);
  if (rc) return rc;
  const unsigned blocks = (unsigned)((Lq + FB_M - 1) / FB_M) * BH;
  fa_fwd_kernel<T, NC><<<blocks, FB_THREADS, smem, st>>>(
      static_cast<const T*>(qs), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(km), heads,
      causal != 0, static_cast<T*>(out), static_cast<float*>(lse), BH, Lq,
      Lk, D);
  return (int)cudaGetLastError();
}

template <typename T, int NC>
static int fa_dkdv_launch(const void* qs, const void* k, const void* v,
                          const void* km, int heads, int causal,
                          const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv, int BH,
                          int Lq, int Lk, int D, cudaStream_t st) {
  static bool allowed = false;
  const size_t smem = fa_smem_bwd<T, NC>();
  const int rc = fa_allow(fa_dkdv_kernel<T, NC>, smem, &allowed);
  if (rc) return rc;
  const unsigned blocks = (unsigned)((Lk + FB_M - 1) / FB_M) * BH;
  fa_dkdv_kernel<T, NC><<<blocks, FB_THREADS, smem, st>>>(
      static_cast<const T*>(qs), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(km), heads,
      causal != 0, static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), BH, Lq, Lk, D);
  return (int)cudaGetLastError();
}

template <typename T, int NC>
static int fa_dq_launch(const void* qs, const void* k, const void* v,
                        const void* km, int heads, int causal,
                        const void* dout, const void* lse,
                        const void* delta, void* dq, int BH, int Lq, int Lk,
                        int D, cudaStream_t st) {
  static bool allowed = false;
  const size_t smem = fa_smem_bwd<T, NC>();
  const int rc = fa_allow(fa_dq_kernel<T, NC>, smem, &allowed);
  if (rc) return rc;
  const unsigned blocks = (unsigned)((Lq + FB_M - 1) / FB_M) * BH;
  fa_dq_kernel<T, NC><<<blocks, FB_THREADS, smem, st>>>(
      static_cast<const T*>(qs), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(km), heads,
      causal != 0, static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), BH, Lq, Lk, D);
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
