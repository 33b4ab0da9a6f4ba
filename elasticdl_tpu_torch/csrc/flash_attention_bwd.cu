// Flash-attention backward for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's `_flash_bwd`
// (elasticdl_tpu/ops/flash_attention.py:208), the custom-VJP backward of
// the Pallas TPU kernel `_fwd_kernel` (:48); XLA compiles it there, so
// this is the hand kernel of the port's `_Flash.backward`.  It computes
// exactly what that function and the port's plain `_flash_bwd` compute,
// by recompute from the forward's log-sum-exp, with nothing O(L^2) kept
// in device memory:
//
//   delta = rowsum(dO * O)                        (f32)
//   S     = Q K^T * scale  (causal: -1e30 above the diagonal)
//   P     = exp(S - lse)                          (f32)
//   dV    = P_(input type)^T dO
//   dP    = dO V^T
//   dS    = (P * (dP - delta) * scale)_(input type)
//   dQ    = dS K,   dK = dS^T Q
//
// Products accumulate in f32; P and dS are rounded to the input type where
// the reference rounds them (`pc = p.astype(q.dtype)`, `ds.astype`); the
// outputs are written in the input type, contiguous (B, L, H, D).
//
// Bound: operations.  At bench_bert's shape (B 64, L 512, H 12, D 64,
// bf16) the five products take 5 * 2*B*H*L^2*D = 128.8 GFLOP, 0.130 ms at
// 989 TFLOP/s dense bf16; the bytes (q, k, v, O, dO and lse read once, dQ,
// dK, dV written once: 404 MB) take 0.121 ms at 3.35 TB/s.
//
// Design: three launches, no atomics, so a result is the same bits from
// run to run.
//   1. delta: one warp per (batch, row, head) row of O and dO
//      (`delta_kernel`), in both variants.
//   2. dK/dV: one block per (64-key tile, head, batch), looping over the
//      query tiles (causal: from the diagonal on); it recomputes S and dP
//      for each pair of tiles and accumulates dK and dV in registers.
//   3. dQ: one block per (64-query tile, head, batch), looping over the
//      key tiles (causal: up to the diagonal); it recomputes S and dP
//      again and accumulates dQ.  That makes 7 products where the bound
//      counts 5: the price of no atomics.
// Two variants, picked by the wrapper's predicate
// (ops/flash_attention.py::backward_tensor_core_ok), never by a failure:
//   - `mma_sync` (bf16, D = 64 or 128, 16-byte aligned rows): tensor cores by
//     mma.sync m16n8k16 (bf16 in, f32 accumulate).  4 warps, each owning
//     16 rows of the block's tile.  The S and dP accumulators turn into
//     the A fragments of the next product in registers (the C and A
//     fragment layouts of m16n8k16 coincide), rounded to bf16 on the way,
//     which is the reference's rounding of P and dS.  Tiles sit in shared
//     memory as bf16 rows padded by 8 elements, so the ldmatrix loads of
//     the fragments fall in distinct banks; ldmatrix.trans gives the B
//     operands that run along a tile's rows (dO and Q for dV and dK, K
//     for dQ).  No cp.async or TMA pipeline, no wgmma: later work.
//   - `cuda_core` (f32, other D, unaligned views): f32 FMAs on the CUDA
//     cores with the forward's thread map (4 rows x 8 strided columns per
//     thread, 128 threads); tiles staged in shared memory as f32, P^T and
//     dS through shared memory to the next product.
// Query rows past q_len and keys past k_len are zero-filled and masked;
// rows past the length are never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int TILE = 64;          // rows of the block's own tile
constexpr int COL_GROUPS = 8;     // cuda_core: lanes sharing rows
constexpr int ROWS = 4;           // cuda_core: rows per thread
constexpr int S_COLS = TILE / COL_GROUPS;
constexpr int P_LD = TILE + 1;    // cuda_core: padded P/dS row
constexpr int PAD = 8;            // mma: bf16 elements of row padding

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back: the reference's cast to the input type
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// ---- 1. delta = rowsum(dO * O) ----------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
    delta_kernel(const T* __restrict__ o, const T* __restrict__ g,
                 float* __restrict__ delta, int batch, int heads, int q_len,
                 int d, int64_t o_bs, int64_t o_rs, int64_t g_bs,
                 int64_t g_rs) {
  const int lane = threadIdx.x % 32;
  const int64_t row_id =
      (int64_t)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (row_id >= (int64_t)batch * q_len * heads) return;
  const int h = (int)(row_id % heads);
  const int row = (int)((row_id / heads) % q_len);
  const int b = (int)(row_id / ((int64_t)heads * q_len));
  const T* orow = o + b * o_bs + row * o_rs + (int64_t)h * d;
  const T* grow = g + b * g_bs + row * g_rs + (int64_t)h * d;
  float sum = 0.f;
  for (int c = lane; c < d; c += 32)
    sum = fmaf(to_float(orow[c]), to_float(grow[c]), sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  // (B, H, Lq): a tile's 64 rows of one head are contiguous
  if (lane == 0) delta[((int64_t)b * heads + h) * q_len + row] = sum;
}

// ---- cuda_core variant ------------------------------------------------

// A 64-row tile of one head as f32 with row pitch d + 1; rows past `rows`
// are zero.
template <typename T>
__device__ __forceinline__ void load_tile_f32(float* dst, const T* src,
                                              int row0, int rows,
                                              int64_t row_stride, int d) {
  const int ld = d + 1;
  for (int idx = threadIdx.x; idx < TILE * d; idx += THREADS) {
    const int r = idx / d;
    const int c = idx - r * d;
    const int row = row0 + r;
    float val = 0.f;
    if (row < rows) val = to_float(src[(int64_t)row * row_stride + c]);
    dst[r * ld + c] = val;
  }
}

template <typename T, int D_MAX>
__global__ void __launch_bounds__(THREADS)
    dkdv_core_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int heads, int q_len, int k_len,
                     int d, int64_t q_bs, int64_t q_rs, int64_t k_bs,
                     int64_t k_rs, int64_t v_bs, int64_t v_rs, int64_t g_bs,
                     int64_t g_rs, float scale, int causal) {
  constexpr int O_COLS = D_MAX / COL_GROUPS;
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* ks = smem;
  float* vs = ks + TILE * ld;
  float* qs = vs + TILE * ld;
  float* gs = qs + TILE * ld;
  float* pt = gs + TILE * ld;       // P^T (keys x queries), rounded
  float* dst = pt + TILE * P_LD;    // dS^T, rounded
  float* lse_s = dst + TILE * P_LD;
  float* delta_s = lse_s + TILE;

  const int k0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int cg = threadIdx.x % COL_GROUPS;
  const int r0 = (threadIdx.x / COL_GROUPS) * ROWS;  // this thread's keys

  const T* qh = q + b * q_bs + (int64_t)h * d;
  const T* kh = k + b * k_bs + (int64_t)h * d;
  const T* vh = v + b * v_bs + (int64_t)h * d;
  const T* gh = g + b * g_bs + (int64_t)h * d;
  const float* delta_h = delta + ((int64_t)b * heads + h) * q_len;

  load_tile_f32(ks, kh, k0, k_len, k_rs, d);
  load_tile_f32(vs, vh, k0, k_len, v_rs, d);

  float acc_dk[ROWS][O_COLS];
  float acc_dv[ROWS][O_COLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int c = 0; c < O_COLS; ++c) acc_dk[i][c] = acc_dv[i][c] = 0.f;

  // causal: queries above this key tile's first key see none of it
  const int q_start = causal ? k0 : 0;
  for (int q0 = q_start; q0 < q_len; q0 += TILE) {
    __syncthreads();  // the previous tile's readers are done
    load_tile_f32(qs, qh, q0, q_len, q_rs, d);
    load_tile_f32(gs, gh, q0, q_len, g_rs, d);
    for (int i = threadIdx.x; i < TILE; i += THREADS) {
      const int row = q0 + i;
      const bool in = row < q_len;
      lse_s[i] = in ? lse[((int64_t)b * q_len + row) * heads + h] : 0.f;
      delta_s[i] = in ? delta_h[row] : 0.f;
    }
    __syncthreads();

    // S^T and dP^T for this thread's 4 keys x 8 queries
    float s[ROWS][S_COLS];
    float dp[ROWS][S_COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < S_COLS; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float kv[ROWS], vv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        kv[i] = ks[(r0 + i) * ld + c];
        vv[i] = vs[(r0 + i) * ld + c];
      }
#pragma unroll
      for (int j = 0; j < S_COLS; ++j) {
        const float qv = qs[(cg + j * COL_GROUPS) * ld + c];
        const float gv = gs[(cg + j * COL_GROUPS) * ld + c];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          s[i][j] = fmaf(kv[i], qv, s[i][j]);
          dp[i][j] = fmaf(vv[i], gv, dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int key = k0 + r0 + i;
#pragma unroll
      for (int j = 0; j < S_COLS; ++j) {
        const int qi = cg + j * COL_GROUPS;
        const int row = q0 + qi;
        const bool valid = row < q_len && (!causal || row >= key);
        const float p = valid ? expf(s[i][j] * scale - lse_s[qi]) : 0.f;
        pt[(r0 + i) * P_LD + qi] = round_to<T>(p);
        dst[(r0 + i) * P_LD + qi] =
            round_to<T>(p * (dp[i][j] - delta_s[qi]) * scale);
      }
    }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q
    const int qmax = min(TILE, q_len - q0);
    for (int qq = 0; qq < qmax; ++qq) {
      float pv[ROWS], dsv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        pv[i] = pt[(r0 + i) * P_LD + qq];
        dsv[i] = dst[(r0 + i) * P_LD + qq];
      }
#pragma unroll
      for (int c = 0; c < O_COLS; ++c) {
        const int col = cg + c * COL_GROUPS;
        if (col < d) {
          const float gv = gs[qq * ld + col];
          const float qv = qs[qq * ld + col];
#pragma unroll
          for (int i = 0; i < ROWS; ++i) {
            acc_dv[i][c] = fmaf(pv[i], gv, acc_dv[i][c]);
            acc_dk[i][c] = fmaf(dsv[i], qv, acc_dk[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int key = k0 + r0 + i;
    if (key >= k_len) continue;
    const int64_t off = (((int64_t)b * k_len + key) * heads + h) * d;
#pragma unroll
    for (int c = 0; c < O_COLS; ++c) {
      const int col = cg + c * COL_GROUPS;
      if (col < d) {
        dk[off + col] = from_float<T>(acc_dk[i][c]);
        dv[off + col] = from_float<T>(acc_dv[i][c]);
      }
    }
  }
}

template <typename T, int D_MAX>
__global__ void __launch_bounds__(THREADS)
    dq_core_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ g,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq,
                   int heads, int q_len, int k_len, int d, int64_t q_bs,
                   int64_t q_rs, int64_t k_bs, int64_t k_rs, int64_t v_bs,
                   int64_t v_rs, int64_t g_bs, int64_t g_rs, float scale,
                   int causal) {
  constexpr int O_COLS = D_MAX / COL_GROUPS;
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* qs = smem;
  float* gs = qs + TILE * ld;
  float* ks = gs + TILE * ld;
  float* vs = ks + TILE * ld;
  float* dss = vs + TILE * ld;      // dS (queries x keys), rounded

  const int q0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int cg = threadIdx.x % COL_GROUPS;
  const int r0 = (threadIdx.x / COL_GROUPS) * ROWS;  // this thread's rows

  const T* qh = q + b * q_bs + (int64_t)h * d;
  const T* kh = k + b * k_bs + (int64_t)h * d;
  const T* vh = v + b * v_bs + (int64_t)h * d;
  const T* gh = g + b * g_bs + (int64_t)h * d;

  load_tile_f32(qs, qh, q0, q_len, q_rs, d);
  load_tile_f32(gs, gh, q0, q_len, g_rs, d);
  float lse_r[ROWS], delta_r[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q0 + r0 + i;
    const bool in = row < q_len;
    lse_r[i] = in ? lse[((int64_t)b * q_len + row) * heads + h] : 0.f;
    delta_r[i] =
        in ? delta[((int64_t)b * heads + h) * q_len + row] : 0.f;
  }

  float acc[ROWS][O_COLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int c = 0; c < O_COLS; ++c) acc[i][c] = 0.f;

  // causal: keys past this Q tile's last row are all masked
  const int k_end = causal ? min(k_len, q0 + TILE) : k_len;
  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    __syncthreads();
    load_tile_f32(ks, kh, k0, k_len, k_rs, d);
    load_tile_f32(vs, vh, k0, k_len, v_rs, d);
    __syncthreads();

    float s[ROWS][S_COLS];
    float dp[ROWS][S_COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < S_COLS; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[ROWS], gv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        qv[i] = qs[(r0 + i) * ld + c];
        gv[i] = gs[(r0 + i) * ld + c];
      }
#pragma unroll
      for (int j = 0; j < S_COLS; ++j) {
        const float kv = ks[(cg + j * COL_GROUPS) * ld + c];
        const float vv = vs[(cg + j * COL_GROUPS) * ld + c];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          s[i][j] = fmaf(qv[i], kv, s[i][j]);
          dp[i][j] = fmaf(gv[i], vv, dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = q0 + r0 + i;
#pragma unroll
      for (int j = 0; j < S_COLS; ++j) {
        const int kj = cg + j * COL_GROUPS;
        const int key = k0 + kj;
        const bool valid =
            key < k_len && row < q_len && (!causal || key <= row);
        const float p = valid ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        dss[(r0 + i) * P_LD + kj] =
            round_to<T>(p * (dp[i][j] - delta_r[i]) * scale);
      }
    }
    __syncthreads();

    const int kmax = min(TILE, k_len - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float dsv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) dsv[i] = dss[(r0 + i) * P_LD + kk];
#pragma unroll
      for (int c = 0; c < O_COLS; ++c) {
        const int col = cg + c * COL_GROUPS;
        if (col < d) {
          const float kv = ks[kk * ld + col];
#pragma unroll
          for (int i = 0; i < ROWS; ++i) acc[i][c] = fmaf(dsv[i], kv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q0 + r0 + i;
    if (row >= q_len) continue;
    const int64_t off = (((int64_t)b * q_len + row) * heads + h) * d;
#pragma unroll
    for (int c = 0; c < O_COLS; ++c) {
      const int col = cg + c * COL_GROUPS;
      if (col < d) dq[off + col] = from_float<T>(acc[i][c]);
    }
  }
}

// ---- mma variant (bf16, D = 64 or 128) --------------------------------

typedef __nv_bfloat16 bf16;

// D[16x8] += A[16x16] B[16x8]; bf16 operands, f32 accumulators.
// Fragments (lane = 4 * grp + tig): A {(grp, 2tig..), (grp+8, 2tig..),
// (grp, 2tig+8..), (grp+8, 2tig+8..)}; B {(k 2tig.., n grp), (k 2tig+8..,
// n grp)}; C {(grp, 2tig), (grp, 2tig+1), (grp+8, 2tig), (grp+8, 2tig+1)}.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats as one register of bf16 (lo in the low half), rounded to
// nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 blocks from shared memory: lane l gives the address of
// row l % 8 of block l / 8, and receives in r[i] its two elements of
// block i, (row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1) as stored,
// or of the block's transpose with `trans`.
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* row) {
  if (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
        "{%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(row)));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
        "{%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(row)));
}

// `rows` rows of one head into shared memory (pitch D + PAD), 16 bytes a
// thread per load; rows past `len` are zero.
template <int D>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src,
                                               int row0, int rows, int len,
                                               int64_t row_stride) {
  constexpr int CHUNKS = D / 8;
  constexpr int LD = D + PAD;
  for (int idx = threadIdx.x; idx < rows * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS;
    const int c = (idx - r * CHUNKS) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < len)
      val = *reinterpret_cast<const uint4*>(src + (int64_t)row * row_stride +
                                            c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// The A fragment of rows row0.. (16) and columns col0.. (16) of a tile:
// blocks (rows, columns) +(0, 0), +(8, 0), +(0, 8), +(8, 8).
template <int D>
__device__ __forceinline__ void ld_a(uint32_t a[4], const bf16* tile,
                                     int row0, int col0, int lane) {
  constexpr int LD = D + PAD;
  const int blk = lane >> 3;
  ldsm_x4<false>(a, tile + (row0 + (blk & 1) * 8 + (lane & 7)) * LD + col0 +
                        (blk >> 1) * 8);
}

// B fragments of two n-tiles of M^T, where M's rows n0.. (16) are the
// product's columns and its columns k0.. (16) the reduction: b[0], b[1]
// for n-tile n0 and b[2], b[3] for n0 + 8.
template <int D>
__device__ __forceinline__ void ld_b_rows(uint32_t b[4], const bf16* tile,
                                          int n0, int k0, int lane) {
  constexpr int LD = D + PAD;
  const int blk = lane >> 3;
  ldsm_x4<false>(b, tile + (n0 + (blk >> 1) * 8 + (lane & 7)) * LD + k0 +
                        (blk & 1) * 8);
}

// B fragments of two n-tiles of M itself, where M's rows k0.. (16) are the
// reduction and its columns n0.. (16) the product's columns (transposed
// blocks): b[0], b[1] for n-tile n0 and b[2], b[3] for n0 + 8.
template <int D>
__device__ __forceinline__ void ld_b_cols(uint32_t b[4], const bf16* tile,
                                          int k0, int n0, int lane) {
  constexpr int LD = D + PAD;
  const int blk = lane >> 3;
  ldsm_x4<true>(b, tile + (k0 + (blk & 1) * 8 + (lane & 7)) * LD + n0 +
                       (blk >> 1) * 8);
}

// A fragments of a 16 x 16 chunk of a C-layout accumulator (n-tiles nt,
// nt + 1), rounded to bf16
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float c0[4],
                                       const float c1[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Stores a warp's 16 x D accumulator (rows row0.. of a (B, L, H, D)
// output) as bf16 pairs.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float acc[][4],
                                           int b, int h, int heads, int len,
                                           int row0, int grp, int tig) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + grp + 8 * half;
    if (row >= len) continue;
    bf16* dst = out + (((int64_t)b * len + row) * heads + h) * D + 2 * tig;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          pack_bf16(acc[n][2 * half], acc[n][2 * half + 1]);
  }
}

template <int D>
struct MmaCfg {
  // dK/dV: the query tile each iteration brings in (32 at D = 128 keeps
  // the S/dP accumulators beside dK and dV within the register file)
  static constexpr int BQ = D == 64 ? 64 : 32;
  // dK/dV blocks resident per SM: at D = 64 three (at most 170 registers
  // a thread; without the bound ptxas takes 185 and only two fit)
  static constexpr int DKDV_MIN_BLOCKS = D == 64 ? 3 : 1;
  static constexpr int LD = D + PAD;
  static constexpr int DKDV_SMEM =
      (2 * TILE + 2 * BQ) * LD * 2 + 2 * BQ * 4;
  static constexpr int DQ_SMEM = 4 * TILE * LD * 2;
};

template <int D>
__global__ void __launch_bounds__(THREADS, MmaCfg<D>::DKDV_MIN_BLOCKS)
    dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int heads, int q_len, int k_len,
                    int64_t q_bs, int64_t q_rs, int64_t k_bs, int64_t k_rs,
                    int64_t v_bs, int64_t v_rs, int64_t g_bs, int64_t g_rs,
                    float scale, int causal) {
  constexpr int BQ = MmaCfg<D>::BQ;
  constexpr int LD = MmaCfg<D>::LD;
  constexpr int QN = BQ / 8;   // n-tiles of S^T (queries)
  constexpr int DN = D / 8;    // n-tiles of dK, dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + TILE * LD;
  bf16* qs = vs + TILE * LD;
  bf16* gs = qs + BQ * LD;
  float* lse_s = reinterpret_cast<float*>(gs + BQ * LD);
  float* delta_s = lse_s + BQ;

  const int k0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / 4;
  const int tig = lane % 4;
  const int wrow = warp * 16;   // this warp's keys within the tile

  const bf16* qh = q + b * q_bs + (int64_t)h * D;
  const bf16* kh = k + b * k_bs + (int64_t)h * D;
  const bf16* vh = v + b * v_bs + (int64_t)h * D;
  const bf16* gh = g + b * g_bs + (int64_t)h * D;
  const float* delta_h = delta + ((int64_t)b * heads + h) * q_len;

  load_tile_bf16<D>(ks, kh, k0, TILE, k_len, k_rs);
  load_tile_bf16<D>(vs, vh, k0, TILE, k_len, v_rs);

  float acc_dk[DN][4];
  float acc_dv[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[n][e] = acc_dv[n][e] = 0.f;

  // causal: queries before this key tile's first key see none of it
  const int q_start = causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_start; q0 < q_len; q0 += BQ) {
    __syncthreads();
    load_tile_bf16<D>(qs, qh, q0, BQ, q_len, q_rs);
    load_tile_bf16<D>(gs, gh, q0, BQ, q_len, g_rs);
    for (int i = threadIdx.x; i < BQ; i += THREADS) {
      const int row = q0 + i;
      const bool in = row < q_len;
      lse_s[i] = in ? lse[((int64_t)b * q_len + row) * heads + h] : 0.f;
      delta_s[i] = in ? delta_h[row] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x BQ queries
    float s[QN][4];
    float dp[QN][4];
#pragma unroll
    for (int n = 0; n < QN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a_k[4], a_v[4];
      ld_a<D>(a_k, ks, wrow, kk, lane);
      ld_a<D>(a_v, vs, wrow, kk, lane);
#pragma unroll
      for (int n = 0; n < QN; n += 2) {
        uint32_t b_q[4], b_g[4];
        ld_b_rows<D>(b_q, qs, n * 8, kk, lane);
        ld_b_rows<D>(b_g, gs, n * 8, kk, lane);
        mma_bf16(s[n], a_k, b_q);
        mma_bf16(s[n + 1], a_k, b_q + 2);
        mma_bf16(dp[n], a_v, b_g);
        mma_bf16(dp[n + 1], a_v, b_g + 2);
      }
    }
    // P^T in s, dS^T in dp (f32; rounded to bf16 by c_to_a)
#pragma unroll
    for (int n = 0; n < QN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + wrow + grp + 8 * (e >> 1);
        const int qi = n * 8 + 2 * tig + (e & 1);
        const int row = q0 + qi;
        const bool valid = row < q_len && (!causal || row >= key);
        const float p = valid ? expf(s[n][e] * scale - lse_s[qi]) : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - delta_s[qi]) * scale;
      }

    // dV += P^T dO, dK += dS^T Q (reduction over the BQ queries)
#pragma unroll
    for (int kq = 0; kq < QN / 2; ++kq) {
      uint32_t a_p[4], a_ds[4];
      c_to_a(a_p, s[2 * kq], s[2 * kq + 1]);
      c_to_a(a_ds, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
      for (int n = 0; n < DN; n += 2) {
        uint32_t b_g[4], b_q[4];
        ld_b_cols<D>(b_g, gs, kq * 16, n * 8, lane);
        ld_b_cols<D>(b_q, qs, kq * 16, n * 8, lane);
        mma_bf16(acc_dv[n], a_p, b_g);
        mma_bf16(acc_dv[n + 1], a_p, b_g + 2);
        mma_bf16(acc_dk[n], a_ds, b_q);
        mma_bf16(acc_dk[n + 1], a_ds, b_q + 2);
      }
    }
  }

  store_rows<D>(dk, acc_dk, b, h, heads, k_len, k0 + wrow, grp, tig);
  store_rows<D>(dv, acc_dv, b, h, heads, k_len, k0 + wrow, grp, tig);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ g,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq,
                  int heads, int q_len, int k_len, int64_t q_bs,
                  int64_t q_rs, int64_t k_bs, int64_t k_rs, int64_t v_bs,
                  int64_t v_rs, int64_t g_bs, int64_t g_rs, float scale,
                  int causal) {
  constexpr int LD = MmaCfg<D>::LD;
  constexpr int KN = TILE / 8;  // n-tiles of S (keys)
  constexpr int DN = D / 8;     // n-tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* gs = qs + TILE * LD;
  bf16* ks = gs + TILE * LD;
  bf16* vs = ks + TILE * LD;

  const int q0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / 4;
  const int tig = lane % 4;
  const int wrow = warp * 16;   // this warp's queries within the tile

  const bf16* qh = q + b * q_bs + (int64_t)h * D;
  const bf16* kh = k + b * k_bs + (int64_t)h * D;
  const bf16* vh = v + b * v_bs + (int64_t)h * D;
  const bf16* gh = g + b * g_bs + (int64_t)h * D;

  load_tile_bf16<D>(qs, qh, q0, TILE, q_len, q_rs);
  load_tile_bf16<D>(gs, gh, q0, TILE, q_len, g_rs);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + wrow + grp + 8 * half;
    const bool in = row < q_len;
    lse_r[half] = in ? lse[((int64_t)b * q_len + row) * heads + h] : 0.f;
    delta_r[half] =
        in ? delta[((int64_t)b * heads + h) * q_len + row] : 0.f;
  }

  float acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int k_end = causal ? min(k_len, q0 + TILE) : k_len;
  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    __syncthreads();
    load_tile_bf16<D>(ks, kh, k0, TILE, k_len, k_rs);
    load_tile_bf16<D>(vs, vh, k0, TILE, k_len, v_rs);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: this warp's 16 queries x 64 keys
    float s[KN][4];
    float dp[KN][4];
#pragma unroll
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a_q[4], a_g[4];
      ld_a<D>(a_q, qs, wrow, kk, lane);
      ld_a<D>(a_g, gs, wrow, kk, lane);
#pragma unroll
      for (int n = 0; n < KN; n += 2) {
        uint32_t b_k[4], b_v[4];
        ld_b_rows<D>(b_k, ks, n * 8, kk, lane);
        ld_b_rows<D>(b_v, vs, n * 8, kk, lane);
        mma_bf16(s[n], a_q, b_k);
        mma_bf16(s[n + 1], a_q, b_k + 2);
        mma_bf16(dp[n], a_g, b_v);
        mma_bf16(dp[n + 1], a_g, b_v + 2);
      }
    }
#pragma unroll
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const int row = q0 + wrow + grp + 8 * half;
        const int key = k0 + n * 8 + 2 * tig + (e & 1);
        const bool valid =
            key < k_len && row < q_len && (!causal || key <= row);
        const float p =
            valid ? expf(s[n][e] * scale - lse_r[half]) : 0.f;
        dp[n][e] = p * (dp[n][e] - delta_r[half]) * scale;
      }

    // dQ += dS K (reduction over the 64 keys)
#pragma unroll
    for (int kq = 0; kq < KN / 2; ++kq) {
      uint32_t a_ds[4];
      c_to_a(a_ds, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
      for (int n = 0; n < DN; n += 2) {
        uint32_t b_k[4];
        ld_b_cols<D>(b_k, ks, kq * 16, n * 8, lane);
        mma_bf16(acc[n], a_ds, b_k);
        mma_bf16(acc[n + 1], a_ds, b_k + 2);
      }
    }
  }

  store_rows<D>(dq, acc, b, h, heads, q_len, q0 + wrow, grp, tig);
}

// ---- launches ---------------------------------------------------------

struct Args {
  const void *q, *k, *v, *o, *g, *lse;
  void *delta, *dq, *dk, *dv;
  int batch, heads, q_len, k_len, d;
  int64_t q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, g_bs, g_rs;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T>
cudaError_t launch_delta(const Args& a) {
  const int64_t rows = (int64_t)a.batch * a.q_len * a.heads;
  const int64_t blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  delta_kernel<T><<<(unsigned)blocks, THREADS, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.g),
      static_cast<float*>(a.delta), a.batch, a.heads, a.q_len, a.d, a.o_bs,
      a.o_rs, a.g_bs, a.g_rs);
  return cudaGetLastError();
}

template <typename T, int D_MAX>
cudaError_t launch_core(const Args& a) {
  cudaError_t err = launch_delta<T>(a);
  if (err != cudaSuccess) return err;
  const size_t tile = (size_t)TILE * (a.d + 1);
  const size_t dkdv_smem =
      sizeof(float) * (4 * tile + 2 * (size_t)TILE * P_LD + 2 * TILE);
  const size_t dq_smem = sizeof(float) * (4 * tile + (size_t)TILE * P_LD);
  err = cudaFuncSetAttribute(dkdv_core_kernel<T, D_MAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dkdv_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_core_kernel<T, D_MAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dq_smem);
  if (err != cudaSuccess) return err;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* g = static_cast<const T*>(a.g);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  const dim3 kv_grid((a.k_len + TILE - 1) / TILE, a.heads, a.batch);
  dkdv_core_kernel<T, D_MAX><<<kv_grid, THREADS, dkdv_smem, a.stream>>>(
      q, k, v, g, lse, delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.heads, a.q_len, a.k_len, a.d, a.q_bs, a.q_rs, a.k_bs, a.k_rs, a.v_bs,
      a.v_rs, a.g_bs, a.g_rs, a.scale, a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 q_grid((a.q_len + TILE - 1) / TILE, a.heads, a.batch);
  dq_core_kernel<T, D_MAX><<<q_grid, THREADS, dq_smem, a.stream>>>(
      q, k, v, g, lse, delta, static_cast<T*>(a.dq), a.heads, a.q_len,
      a.k_len, a.d, a.q_bs, a.q_rs, a.k_bs, a.k_rs, a.v_bs, a.v_rs, a.g_bs,
      a.g_rs, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_core(const Args& a) {
  if (a.d <= 64) return launch_core<T, 64>(a);
  return launch_core<T, 128>(a);
}

template <int D>
cudaError_t launch_mma(const Args& a) {
  cudaError_t err = launch_delta<bf16>(a);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkdv_mma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MmaCfg<D>::DKDV_SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_mma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MmaCfg<D>::DQ_SMEM);
  if (err != cudaSuccess) return err;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* g = static_cast<const bf16*>(a.g);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  const dim3 kv_grid((a.k_len + TILE - 1) / TILE, a.heads, a.batch);
  dkdv_mma_kernel<D><<<kv_grid, THREADS, MmaCfg<D>::DKDV_SMEM, a.stream>>>(
      q, k, v, g, lse, delta, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.heads, a.q_len, a.k_len, a.q_bs, a.q_rs,
      a.k_bs, a.k_rs, a.v_bs, a.v_rs, a.g_bs, a.g_rs, a.scale, a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 q_grid((a.q_len + TILE - 1) / TILE, a.heads, a.batch);
  dq_mma_kernel<D><<<q_grid, THREADS, MmaCfg<D>::DQ_SMEM, a.stream>>>(
      q, k, v, g, lse, delta, static_cast<bf16*>(a.dq), a.heads, a.q_len,
      a.k_len, a.q_bs, a.q_rs, a.k_bs, a.k_rs, a.v_bs, a.v_rs, a.g_bs,
      a.g_rs, a.scale, a.causal);
  return cudaGetLastError();
}

}  // namespace

// variant: 0 = cuda_core, 1 = mma_sync.  dtype: 0 = float32, 1 = bfloat16.
// q/k/v/o/g are (B, L, H, D) with the (H, D) dims contiguous and the given
// batch and row strides (elements); lse is (B, Lq, H) f32; delta is an
// (B, H, Lq) f32 scratch; dq/dk/dv are contiguous (B, L, H, D) outputs.
// Returns a cudaError_t (0 = success), checked after each of the three
// launches: a refused launch never runs, and a later synchronize would
// not report it.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* g, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int variant, int dtype, int batch, int heads, int q_len,
    int k_len, int head_dim, long long q_bs, long long q_rs, long long k_bs,
    long long k_rs, long long v_bs, long long v_rs, long long o_bs,
    long long o_rs, long long g_bs, long long g_rs, float scale, int causal,
    void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 ||
      q_len < 1 || k_len < 1 || head_dim < 1 || head_dim > 128)
    return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();  // an earlier, unrelated error is not ours
  const Args a{q,    k,    v,    o,    g,    lse,  delta, dq,    dk,
               dv,   batch, heads, q_len, k_len, head_dim, q_bs, q_rs,
               k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, g_bs, g_rs, scale,
               causal, static_cast<cudaStream_t>(stream)};
  if (variant == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    if (head_dim == 64) return (int)launch_mma<64>(a);
    if (head_dim == 128) return (int)launch_mma<128>(a);
    return (int)cudaErrorInvalidValue;
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)dispatch_core<float>(a);
  if (dtype == 1) return (int)dispatch_core<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}
