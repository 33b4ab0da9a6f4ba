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
// Design: two launches.  The first writes the grads rows in sorted order
// (sorted_grads[k] = grads[order[k]], one thread per element), so that
// each segment's rows are contiguous and their addresses need no earlier
// load.  In the second, a group of lanes owns one sorted position.  Only
// the head of a segment (the first position of its id) works; the others
// return at once.  The head's lanes run over the row's D columns, start
// from table[r], add the segment's rows in order and write row r once,
// in place.  A group is min(32, next power of two >= D) lanes, so a warp
// packs 32 / group segments: 2 at D=16, 32 at D=1 (the `fm_linear`
// arena's 4-byte rows), one at D >= 32, where each lane takes the columns
// lane, lane + 32, ...  A head walks its segment CHUNK entries at a time,
// loading the chunk before adding it in order, so its loads overlap.
//
// Rows are in range by construction (hash mod capacity plus offset), as
// the JAX package promises XLA with PROMISE_IN_BOUNDS; this kernel does
// not check each id.  The CPU plain version (index_add_) raises on one.
//
// Bound: bytes.  Each id is read once (N*4), each grads row once
// (N*D*4), and each of the U touched table rows read and written once
// (2*U*D*4); the adds are one per grads element.  Known weakness: hot
// rows.  One segment is one serial chain of dependent adds on one group,
// so a zipf(1.5) row that takes ~38% of a field's ids is the kernel's
// critical path, whatever the rest of the card does.  A split-and-combine
// that keeps a fixed order is later work.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 16;  // segment entries whose loads are in flight together

// sorted_grads[k] = grads[order[k]]: the grads rows in sorted-id order,
// one thread per element, so each segment's rows become contiguous.
__global__ void __launch_bounds__(THREADS) permute_rows_kernel(
    float* __restrict__ sorted_grads, const float* __restrict__ grads,
    const long long* __restrict__ order, int64_t n, int dim) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n * dim) return;
  const int64_t k = i / dim;
  sorted_grads[i] = __ldg(grads + __ldg(order + k) * dim + (i - k * dim));
}

__global__ void __launch_bounds__(THREADS) scatter_add_segments_kernel(
    float* __restrict__ table, const int32_t* __restrict__ sorted_ids,
    const float* __restrict__ sorted_grads, int64_t n, int dim,
    int group_shift) {
  const int64_t tid = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t p = tid >> group_shift;          // sorted position
  const int lane = (int)(tid & ((1 << group_shift) - 1));
  if (p >= n) return;
  const int32_t row = sorted_ids[p];
  if (p > 0 && sorted_ids[p - 1] == row) return;  // not a segment head
  float* dst = table + (int64_t)row * dim;
  for (int c = lane; c < dim; c += (1 << group_shift)) {
    float acc = dst[c];
    for (int64_t j = p;; j += CHUNK) {
      bool in[CHUNK];
      float val[CHUNK];
      // Addresses do not depend on earlier loads, so the chunk's loads
      // overlap; positions past n read position n-1, and entries past
      // the segment are read (contiguous, in cache) but not added.
#pragma unroll
      for (int k = 0; k < CHUNK; ++k) {
        const int64_t q = j + k < n ? j + k : n - 1;
        // sorted ids: the entries of the segment are a prefix of the chunk
        in[k] = (j + k < n) & (__ldg(sorted_ids + q) == row);
        val[k] = __ldg(sorted_grads + q * dim + c);
      }
#pragma unroll
      for (int k = 0; k < CHUNK; ++k) {
        if (in[k]) acc += val[k];
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
// id order; sorted_grads: (n, dim) f32 scratch.  Returns the CUDA error
// of the launches (0 on success).
extern "C" int scatter_add_segments(void* table, const void* sorted_ids,
                                    const void* order, const void* grads,
                                    void* sorted_grads, long long n, int dim,
                                    void* stream) {
  if (n <= 0 || dim <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long permute_blocks = (n * dim + THREADS - 1) / THREADS;
  int group_shift = 0;
  while ((1 << group_shift) < dim && group_shift < 5) ++group_shift;
  const long long blocks = ((n << group_shift) + THREADS - 1) / THREADS;
  if (blocks > INT_MAX || permute_blocks > INT_MAX)
    return (int)cudaErrorInvalidConfiguration;
  permute_rows_kernel<<<(unsigned)permute_blocks, THREADS, 0, s>>>(
      static_cast<float*>(sorted_grads), static_cast<const float*>(grads),
      static_cast<const long long*>(order), (int64_t)n, dim);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scatter_add_segments_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
      static_cast<float*>(table), static_cast<const int32_t*>(sorted_ids),
      static_cast<const float*>(sorted_grads), (int64_t)n, dim, group_shift);
  return (int)cudaGetLastError();
}
