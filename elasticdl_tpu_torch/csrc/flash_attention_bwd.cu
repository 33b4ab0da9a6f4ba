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
//      (`delta_kernel`).
//   2. dK/dV: one block per (64-key tile, head, batch), looping over the
//      query tiles (causal: from the diagonal on); it recomputes S and dP
//      for each pair of tiles and accumulates dK and dV in registers.
//   3. dQ: one block per (64-query tile, head, batch), looping over the
//      key tiles (causal: up to the diagonal); it recomputes S and dP
//      again and accumulates dQ.  That makes 7 products where the bound
//      counts 5: the price of no atomics.
// This source is the `cuda_core` variant: f32, D other than 64 and 128,
// and bf16 views TMA cannot describe (ops/flash_attention.py::
// backward_wgmma_ok picks it, never a failure).  bf16 at D = 64 or 128 runs
// on the tensor cores in flash_attention_bwd_sm90.cu (TMA + wgmma).  f32
// FMAs on the CUDA cores with the forward's thread map (4 rows x 8 strided
// columns per thread, 128 threads); tiles staged in shared memory as f32,
// P^T and dS through shared memory to the next product.
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/k/v/o/g are (B, L, H, D) with the
// (H, D) dims contiguous and the given batch and row strides (elements);
// lse is (B, Lq, H) f32; delta is an (B, H, Lq) f32 scratch; dq/dk/dv are
// contiguous (B, L, H, D) outputs.  Returns a cudaError_t (0 = success),
// checked after each of the three launches: a refused launch never runs,
// and a later synchronize would not report it.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* g, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int dtype, int batch, int heads, int q_len, int k_len,
    int head_dim, long long q_bs, long long q_rs, long long k_bs,
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
  if (dtype == 0) return (int)dispatch_core<float>(a);
  if (dtype == 1) return (int)dispatch_core<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}
