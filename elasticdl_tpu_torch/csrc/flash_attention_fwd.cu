// Flash-attention forward for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in
// elasticdl_tpu/ops/flash_attention.py (launched by `_pallas_forward`).
// It computes, per (batch, head), softmax(Q K^T * scale) V with an online
// softmax (running max m, normaliser l, f32 accumulator), optionally
// causal, and writes O in the input type plus the log-sum-exp
// m + log(max(l, 1e-30)) in f32 for the backward.
//
// Layout: q, k and v are (B, L, H, D) with the last two dims contiguous;
// head h is the column chunk [h*D, (h+1)*D) of each row, read in place
// (no transpose), and the batch and row strides are arguments, so the
// q/k/v column slices of a fused QKV projection are read without a copy.
// O is written contiguous (B, Lq, H, D); lse is (B, Lq, H).
//
// Bound: at BERT-base serving shapes (L=512, D=64, bf16) the FLOPs are
// 4*B*H*L^2*D and the bytes 4*B*L*H*D*2, so on the tensor cores the
// kernel would be bound by memory (about 61 us at B=64, 3.35 TB/s).
// This kernel is plain CUDA C++ on the CUDA cores, bound by shared-memory
// loads feeding the f32 FMAs, far above that bound.  It serves f32 and
// the shapes the tensor-core kernel does not take; bf16 at D = 64 or 128
// with aligned strides goes to flash_attention_fwd_sm90.cu (wgmma, TMA).
//
// Design: one block of 128 threads per (Q tile of 64 rows, head, batch).
// The Q tile is staged in shared memory as f32; K and V stream through
// shared memory in tiles of 64 rows.  Each thread owns 4 query rows and
// 8 score columns (strided by 8) of the 64x64 score tile and the same 4
// rows of the output accumulator (columns strided by 8), so a row's
// softmax statistics are reduced over 8 neighbouring lanes with warp
// shuffles.  Probabilities go through shared memory to the P*V product.
// Shared-memory rows are padded by one float so the strided accesses
// fall in distinct banks.  Causal blocks stop streaming at the diagonal;
// keys past k_len in the ragged last tile are masked, rows past q_len
// are never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_Q = 64;
constexpr int BLOCK_K = 64;
constexpr int THREADS = 128;
constexpr int COL_GROUPS = 8;                  // lanes sharing query rows
constexpr int ROWS = 4;                        // query rows per thread
constexpr int S_COLS = BLOCK_K / COL_GROUPS;   // score columns per thread
constexpr int P_LD = BLOCK_K + 1;              // padded P row
constexpr float NEG_INF = -1e30f;

static_assert(THREADS / COL_GROUPS * ROWS == BLOCK_Q, "tile mapping");

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

// Copy a 64-row tile of one head (rows row0.., columns 0..d-1) into
// shared memory as f32 with row pitch d + 1; rows past `rows` are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int rows, int64_t row_stride,
                                          int d) {
  const int ld = d + 1;
  for (int idx = threadIdx.x; idx < BLOCK_K * d; idx += THREADS) {
    const int r = idx / d;
    const int c = idx - r * d;
    const int row = row0 + r;
    float val = 0.f;
    if (row < rows) val = to_float(src[(int64_t)row * row_stride + c]);
    dst[r * ld + c] = val;
  }
}

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 1; off < COL_GROUPS; off <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 1; off < COL_GROUPS; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D_MAX>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int heads, int q_len, int k_len,
                     int d, int64_t q_bs, int64_t q_rs, int64_t k_bs,
                     int64_t k_rs, int64_t v_bs, int64_t v_rs, float scale,
                     int causal) {
  constexpr int O_COLS = D_MAX / COL_GROUPS;  // output columns per thread
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* qs = smem;
  float* ks = qs + BLOCK_Q * ld;
  float* vs = ks + BLOCK_K * ld;
  float* ps = vs + BLOCK_K * ld;

  const int q0 = blockIdx.x * BLOCK_Q;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int cg = threadIdx.x % COL_GROUPS;
  const int r0 = (threadIdx.x / COL_GROUPS) * ROWS;

  const T* qh = q + (int64_t)b * q_bs + (int64_t)h * d;
  const T* kh = k + (int64_t)b * k_bs + (int64_t)h * d;
  const T* vh = v + (int64_t)b * v_bs + (int64_t)h * d;

  load_tile(qs, qh, q0, q_len, q_rs, d);

  float acc[ROWS][O_COLS];
  float m[ROWS];
  float l[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < O_COLS; ++c) acc[i][c] = 0.f;
  }

  // causal: keys above this Q tile's last row are all masked
  const int k_end = causal ? min(k_len, q0 + BLOCK_Q) : k_len;
  const int n_tiles = (k_end + BLOCK_K - 1) / BLOCK_K;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BLOCK_K;
    __syncthreads();  // the previous tile's readers are done with ks/vs/ps
    load_tile(ks, kh, k0, k_len, k_rs, d);
    load_tile(vs, vh, k0, k_len, v_rs, d);
    __syncthreads();

    float s[ROWS][S_COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < S_COLS; ++j) s[i][j] = 0.f;

    for (int c = 0; c < d; ++c) {
      float qv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) qv[i] = qs[(r0 + i) * ld + c];
#pragma unroll
      for (int j = 0; j < S_COLS; ++j) {
        const float kv = ks[(cg + j * COL_GROUPS) * ld + c];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) s[i][j] = fmaf(qv[i], kv, s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = q0 + r0 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < S_COLS; ++j) {
        const int key = k0 + cg + j * COL_GROUPS;
        float x = s[i][j] * scale;
        if (key >= k_len || (causal && key > row)) x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float correction = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < S_COLS; ++j) {
        // masked entries contribute nothing, even in a fully masked row
        const float p = s[i][j] > NEG_INF * 0.5f ? expf(s[i][j] - m_new) : 0.f;
        s[i][j] = p;
        sum += p;
      }
      l[i] = l[i] * correction + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < O_COLS; ++c) acc[i][c] *= correction;
#pragma unroll
      for (int j = 0; j < S_COLS; ++j)
        ps[(r0 + i) * P_LD + cg + j * COL_GROUPS] = s[i][j];
    }
    __syncthreads();

    const int kmax = min(BLOCK_K, k_len - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float pv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) pv[i] = ps[(r0 + i) * P_LD + kk];
#pragma unroll
      for (int c = 0; c < O_COLS; ++c) {
        const int col = cg + c * COL_GROUPS;
        if (col < d) {
          const float vv = vs[kk * ld + col];
#pragma unroll
          for (int i = 0; i < ROWS; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q0 + r0 + i;
    if (row >= q_len) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    T* out_row = o + (((int64_t)b * q_len + row) * heads + h) * d;
#pragma unroll
    for (int c = 0; c < O_COLS; ++c) {
      const int col = cg + c * COL_GROUPS;
      if (col < d) out_row[col] = from_float<T>(acc[i][c] / l_safe);
    }
    if (cg == 0)
      lse[((int64_t)b * q_len + row) * heads + h] = m[i] + logf(l_safe);
  }
}

template <typename T, int D_MAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int batch, int heads, int q_len, int k_len,
                   int d, int64_t q_bs, int64_t q_rs, int64_t k_bs,
                   int64_t k_rs, int64_t v_bs, int64_t v_rs, float scale,
                   int causal, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(BLOCK_Q + 2 * BLOCK_K) * (d + 1) +
                       (size_t)BLOCK_Q * P_LD);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D_MAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((q_len + BLOCK_Q - 1) / BLOCK_Q, heads, batch);
  flash_fwd_kernel<T, D_MAX><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      heads, q_len, k_len, d, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(const void* q, const void* k, const void* v,
                         void* o, void* lse, int batch, int heads, int q_len,
                         int k_len, int d, int64_t q_bs, int64_t q_rs,
                         int64_t k_bs, int64_t k_rs, int64_t v_bs,
                         int64_t v_rs, float scale, int causal,
                         cudaStream_t stream) {
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, lse, batch, heads, q_len, k_len, d,
                         q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale, causal,
                         stream);
  return launch<T, 128>(q, k, v, o, lse, batch, heads, q_len, k_len, d, q_bs,
                        q_rs, k_bs, k_rs, v_bs, v_rs, scale, causal, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success):
// the launch is checked right away, since a refused launch never runs and
// a later synchronize would not report it.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   int dtype, int batch, int heads, int q_len,
                                   int k_len, int head_dim, long long q_bs,
                                   long long q_rs, long long k_bs,
                                   long long k_rs, long long v_bs,
                                   long long v_rs, float scale, int causal,
                                   void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 ||
      q_len < 1 || k_len < 1 || head_dim < 1 || head_dim > 128)
    return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();  // an earlier, unrelated error is not ours
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_dim<float>(q, k, v, o, lse, batch, heads, q_len,
                                    k_len, head_dim, q_bs, q_rs, k_bs, k_rs,
                                    v_bs, v_rs, scale, causal, s);
  if (dtype == 1)
    return (int)dispatch_dim<__nv_bfloat16>(q, k, v, o, lse, batch, heads,
                                            q_len, k_len, head_dim, q_bs, q_rs,
                                            k_bs, k_rs, v_bs, v_rs, scale,
                                            causal, s);
  return (int)cudaErrorInvalidValue;
}
