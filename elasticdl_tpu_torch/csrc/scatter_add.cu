// Deterministic embedding scatter-add for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_pallas_kernel` in
// scripts/probe_pallas_scatter.py:68 (launched by `pallas_scatter_add`).
// It computes the same function:
//
//     table'[r] = table[r] + grads[i1] + grads[i2] + ...
//
// summed left to right over the positions i1 < i2 < ... where ids == r.
// The TPU kernel gets that order from its serial grid; blocks on Hopper
// run in no order, so the order comes from the ids instead.  The wrapper
// (ops/scatter_add.py) sorts the int32 ids with a stable sort and passes
// the sorted ids and the permutation; equal ids then sit in one segment
// in original-index order.  No float atomics: they would reorder the sums,
// and the port holds K-step vs flat training and run to run bitwise.
//
// Design: three launches, none of which adds a float in another order.
// 1. permute: sorted_grads[k] = grads[order[k]], one thread per float4
//    (or float), so each segment's rows are contiguous and their
//    addresses need no earlier load.
// 2. long segments, longer than `long_segment` ids (the wrapper passes
//    64): each goes to a whole block of 128 threads.  The block streams
//    the segment's contiguous grads rows through a 4-stage shared-memory
//    ring with cp.async (16-byte copies from warps 1-3, issued three
//    chunks ahead), and the lanes that own the row's D columns (D
//    lanes at D=16, one lane at D=1) run the add chain out of shared
//    memory in order, from table[r], carrying the partial sums in shared
//    memory from chunk to chunk; the row is written once.  The segment
//    plan comes from the wrapper, sync-free: at every anchor position
//    j*long_segment of the sorted ids, the head and end of the segment
//    that holds it (two `torch.searchsorted` calls on integers).  Every
//    segment longer than long_segment holds an anchor; the block of its
//    first anchor takes it.  So the hot rows' chains run in parallel on
//    separate SMs, and a chain's links cost a shared-memory load and a
//    dependent FADD (a few ns) instead of a DRAM round trip.
// 3. short segments: a group of lanes owns one sorted position.  Only the
//    head of a short segment works (the others, and the heads of long
//    segments, return at once).  The head's lanes run over the row's D
//    columns, start from table[r], add the segment's rows in order and
//    write row r once, in place.  Where D % 4 == 0 and the pointers are
//    16-byte aligned a lane moves a float4 of 4 columns, else one
//    column.  A group is min(32, next power of two >= D / width) lanes,
//    so a warp packs 32 / group segments: 8 at D=16, 32 at D=1 (the
//    `fm_linear` arena's 4-byte rows), one at 32 or more vectors, where
//    each lane takes the vectors lane, lane + 32, ...  A head walks its
//    segment CHUNK entries at a time, loading the chunk before adding it
//    in order, so its loads overlap.
//
// Rows are in range by construction (hash mod capacity plus offset), as
// the JAX package promises XLA with PROMISE_IN_BOUNDS; this kernel does
// not check each id.  The CPU plain version (index_add_) raises on one.
//
// Bound: bytes.  Each id is read once (N*4), each grads row once
// (N*D*4), and each of the U touched table rows read and written once
// (2*U*D*4); the adds are one per grads element.  The critical path is
// now the longest segment's chain of dependent adds out of shared memory
// (6,446 links at the main shape, about 5 ns each on an H100) beside the permute's
// pass over the grads at HBM rate; the order of the adds forbids a tree.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 16;  // segment entries whose loads are in flight together
constexpr int LONG_THREADS = 128;
constexpr int STAGES = 4;
constexpr int STAGE_FLOATS = 4096;             // grads elements per chunk
constexpr int STAGE_PITCH = STAGE_FLOATS + 8;  // + a misaligned start's units
constexpr int LONG_SMEM = (STAGES * STAGE_PITCH) * 4;
constexpr int COPY_LANE0 = 32;  // warps 1-3 copy, warp 0 adds
constexpr int BATCH = 32;       // shared-memory loads ahead of the adds

// Rows move as float4 (VEC = 4) when D % 4 == 0 and the pointers are
// 16-byte aligned, else as floats; an add of two float4s adds each column
// on its own, so every column's chain keeps its order.
template <int VEC>
using vec_t = typename std::conditional<VEC == 4, float4, float>::type;

__device__ __forceinline__ float add_columns(float a, float b) {
  return a + b;
}
__device__ __forceinline__ float4 add_columns(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// sorted_grads[k] = grads[order[k]]: the grads rows in sorted-id order,
// one thread per vector, so each segment's rows become contiguous.
template <int VEC>
__global__ void __launch_bounds__(THREADS) permute_rows_kernel(
    float* __restrict__ sorted_grads, const float* __restrict__ grads,
    const long long* __restrict__ order, int64_t n, int dim) {
  using V = vec_t<VEC>;
  const int vdim = dim / VEC;
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n * vdim) return;
  const int64_t k = i / vdim;
  reinterpret_cast<V*>(sorted_grads)[i] =
      __ldg(reinterpret_cast<const V*>(grads) + __ldg(order + k) * vdim +
            (i - k * vdim));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest STAGES - 1 has landed (for this thread)
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1) : "memory");
}

// One block per anchor position blockIdx.x * long_segment; it works only
// if the segment holding its anchor is longer than long_segment and
// holds no earlier anchor.  Chunk c of the segment is the grads elements
// [first + c*cf, first + (c+1)*cf), cf a whole number of rows; warps 1-3
// copy it in 16-byte units from the aligned address at or below its
// start, so it sits at offset start % 4 of its stage, while the column
// lanes (warp 0 at D <= 32) run the chains.  sorted_grads must have 4
// floats of slack past n*dim for the last unit.  DIM > 0 fixes the row
// width at compile time; DIM == 0 takes dim_arg.
template <int DIM>
__global__ void __launch_bounds__(LONG_THREADS) scatter_add_long_kernel(
    float* __restrict__ table, const int32_t* __restrict__ sorted_ids,
    const float* __restrict__ sorted_grads,
    const int32_t* __restrict__ anchor_heads,
    const int32_t* __restrict__ anchor_ends, int dim_arg,
    int long_segment) {
  extern __shared__ __align__(16) float ring[];
  const int dim = DIM > 0 ? DIM : dim_arg;
  float* acc_s = ring + STAGES * STAGE_PITCH;  // partial sums, per column
  const int64_t anchor = (int64_t)blockIdx.x * long_segment;
  const int64_t head = anchor_heads[blockIdx.x];
  const int64_t end = anchor_ends[blockIdx.x];
  if (end - head <= long_segment) return;  // a short segment
  if (blockIdx.x > 0 && head <= anchor - long_segment) return;  // not first
  const int32_t row = sorted_ids[head];
  float* dst_row = table + (int64_t)row * dim;
  const int64_t first = head * dim;
  const int64_t count = (end - head) * dim;
  const int64_t cf = (int64_t)(STAGE_FLOATS / dim) * dim;
  const int64_t chunks = (count + cf - 1) / cf;

  for (int c = threadIdx.x; c < dim; c += LONG_THREADS) acc_s[c] = dst_row[c];

  auto issue = [&](int64_t c) {
    if (c < chunks && threadIdx.x >= COPY_LANE0) {
      const int64_t start = first + c * cf;
      const int64_t base = start & ~int64_t(3);
      const int64_t floats = (start - base) + min(cf, count - c * cf);
      const int units = (int)((floats + 3) / 4);
      float* dst = ring + (c % STAGES) * STAGE_PITCH;
      for (int u = threadIdx.x - COPY_LANE0; u < units;
           u += LONG_THREADS - COPY_LANE0)
        cp_async16(dst + 4 * u, sorted_grads + base + 4 * u);
    }
    cp_async_commit();  // empty groups keep the count uniform
  };

  for (int c = 0; c < STAGES - 1; ++c) issue(c);
  for (int64_t c = 0; c < chunks; ++c) {
    issue(c + STAGES - 1);
    cp_async_wait_ring();
    __syncthreads();  // chunk c has landed for every thread's copies
    const int64_t start = first + c * cf;
    const float* src = ring + (c % STAGES) * STAGE_PITCH + (start & 3);
    const int rows = (int)(min(cf, count - c * cf) / dim);
    for (int col = threadIdx.x; col < dim; col += LONG_THREADS) {
      const float* p = src + col;
      float acc = acc_s[col];
      // BATCH shared-memory loads, then their adds in order
      int e = 0;
      for (; e + BATCH <= rows; e += BATCH) {
        float v[BATCH];
#pragma unroll
        for (int k = 0; k < BATCH; ++k) v[k] = p[(e + k) * dim];
#pragma unroll
        for (int k = 0; k < BATCH; ++k) acc += v[k];
      }
      for (; e < rows; ++e) acc += p[e * dim];
      acc_s[col] = acc;
    }
    __syncthreads();  // the stage is free for chunk c + STAGES
  }
  for (int c = threadIdx.x; c < dim; c += LONG_THREADS) dst_row[c] = acc_s[c];
}

// A group of 1 << group_shift lanes per sorted position, each lane a
// vector of VEC columns.
template <int VEC>
__global__ void __launch_bounds__(THREADS) scatter_add_segments_kernel(
    float* __restrict__ table, const int32_t* __restrict__ sorted_ids,
    const float* __restrict__ sorted_grads, int64_t n, int dim,
    int group_shift, int long_segment) {
  using V = vec_t<VEC>;
  const int vdim = dim / VEC;
  const int64_t tid = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t p = tid >> group_shift;          // sorted position
  const int lane = (int)(tid & ((1 << group_shift) - 1));
  if (p >= n) return;
  const int32_t row = sorted_ids[p];
  if (p > 0 && sorted_ids[p - 1] == row) return;  // not a segment head
  // longer than long_segment: scatter_add_long_kernel's segment
  if (p + long_segment < n && sorted_ids[p + long_segment] == row) return;
  V* dst = reinterpret_cast<V*>(table) + (int64_t)row * vdim;
  const V* src = reinterpret_cast<const V*>(sorted_grads);
  for (int c = lane; c < vdim; c += (1 << group_shift)) {
    V acc = dst[c];
    for (int64_t j = p;; j += CHUNK) {
      bool in[CHUNK];
      V val[CHUNK];
      // Addresses do not depend on earlier loads, so the chunk's loads
      // overlap; positions past n read position n-1, and entries past
      // the segment are read (contiguous, in cache) but not added.
#pragma unroll
      for (int k = 0; k < CHUNK; ++k) {
        const int64_t q = j + k < n ? j + k : n - 1;
        // sorted ids: the entries of the segment are a prefix of the chunk
        in[k] = (j + k < n) & (__ldg(sorted_ids + q) == row);
        val[k] = __ldg(src + q * vdim + c);
      }
#pragma unroll
      for (int k = 0; k < CHUNK; ++k) {
        if (in[k]) acc = add_columns(acc, val[k]);
      }
      if (!in[CHUNK - 1]) break;
    }
    dst[c] = acc;
  }
}

}  // namespace

// table: (R, dim) f32, updated in place; sorted_ids: (n,) int32 sorted
// ascending by a stable sort; order: (n,) int64, the sort's permutation
// (sorted_ids[k] == ids[order[k]]); grads: (n, dim) f32 in the original
// id order; sorted_grads: f32 scratch of n*dim + 4 elements;
// anchor_heads/anchor_ends: (ceil(n / long_segment),) int32, the first
// and one-past-last sorted position of the segment holding position
// j*long_segment.  dim <= 4096.  Returns the CUDA error of the launches
// (0 on success).
extern "C" int scatter_add_segments(void* table, const void* sorted_ids,
                                    const void* order, const void* grads,
                                    void* sorted_grads,
                                    const void* anchor_heads,
                                    const void* anchor_ends, long long n,
                                    int dim, int long_segment,
                                    void* stream) {
  if (n <= 0 || dim <= 0 || dim > STAGE_FLOATS || long_segment < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec4 = dim % 4 == 0 &&
                    ((uintptr_t)table | (uintptr_t)grads |
                     (uintptr_t)sorted_grads) % 16 == 0;
  const int vdim = vec4 ? dim / 4 : dim;
  const long long permute_blocks = (n * vdim + THREADS - 1) / THREADS;
  const long long anchors = (n + long_segment - 1) / long_segment;
  int group_shift = 0;
  while ((1 << group_shift) < vdim && group_shift < 5) ++group_shift;
  const long long blocks = ((n << group_shift) + THREADS - 1) / THREADS;
  if (blocks > INT_MAX || permute_blocks > INT_MAX || anchors > INT_MAX)
    return (int)cudaErrorInvalidConfiguration;
  const int long_smem = LONG_SMEM + dim * 4;
  void (*long_kernel)(float*, const int32_t*, const float*, const int32_t*,
                      const int32_t*, int, int) =
      dim == 16 ? scatter_add_long_kernel<16>
                : dim == 1 ? scatter_add_long_kernel<1>
                           : scatter_add_long_kernel<0>;
  cudaError_t err = cudaFuncSetAttribute(
      long_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, long_smem);
  if (err != cudaSuccess) return (int)err;
  (vec4 ? permute_rows_kernel<4> : permute_rows_kernel<1>)
      <<<(unsigned)permute_blocks, THREADS, 0, s>>>(
          static_cast<float*>(sorted_grads), static_cast<const float*>(grads),
          static_cast<const long long*>(order), (int64_t)n, dim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  long_kernel<<<(unsigned)anchors, LONG_THREADS, long_smem, s>>>(
      static_cast<float*>(table), static_cast<const int32_t*>(sorted_ids),
      static_cast<const float*>(sorted_grads),
      static_cast<const int32_t*>(anchor_heads),
      static_cast<const int32_t*>(anchor_ends), dim, long_segment);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  (vec4 ? scatter_add_segments_kernel<4> : scatter_add_segments_kernel<1>)
      <<<(unsigned)blocks, THREADS, 0, s>>>(
      static_cast<float*>(table), static_cast<const int32_t*>(sorted_ids),
      static_cast<const float*>(sorted_grads), (int64_t)n, dim, group_shift,
      long_segment);
  return (int)cudaGetLastError();
}
