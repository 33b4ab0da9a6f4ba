// Flash-attention forward on Hopper's tensor cores (sm_90a): TMA loads,
// an mbarrier-driven K/V ring fed by one producer warp, and both products
// by wgmma with bf16 operands and f32 accumulation.
//
// Replaces the Pallas TPU kernel `_fwd_kernel`
// (elasticdl_tpu/ops/flash_attention.py:48, launched by `_pallas_forward`)
// for bf16 inputs with D = 64 or 128; flash_attention_fwd.cu keeps every
// other case (f32, other D) on the CUDA cores.  Same function: per (batch,
// head), softmax(Q K^T * scale) V by an online softmax, with the running
// max and normaliser and the output accumulator in f32, the -1e30 sentinel
// and exact zeros for masked keys, the causal early stop, O in bf16 and
// lse = m + log(max(l, 1e-30)) in f32 in the (B, Lq, H) layout.  As in the
// TPU kernel (`p.astype(v.dtype)` at :101), P is rounded to bf16 for the
// PV product while l sums the f32 probabilities.
//
// Bound: bytes.  At the BERT serving shape (64, 512, 12, 64) q, k, v and o
// are 50.3 MB each and lse 1.6 MB: 203 MB over 3.35 TB/s = 60.6 us, above
// the 51.5 GFLOP over 989 TFLOP/s = 52 us of the two products.  What the
// design does about it: every q/k/v byte moves once from HBM into shared
// memory by TMA (the four Q tiles of a (batch, head) run as neighbouring
// blocks, so their K/V reads after the first come from L2), with no
// conversion or register staging on the way; the products run on the
// tensor cores, so neither the FMA pipes nor shared-memory loads bound it.
// The exponentials (B*H*Lq*Lk = 201M at the serve shape, 16 per clock per
// SM) are the next floor, about 52 us.
//
// Layout: q, k, v are (B, L, H, D) with the (H, D) dims contiguous; each is
// described to TMA as a 3-D tensor (H*D columns, L rows, B batches) with
// its own row and batch strides in bytes, so the q/k/v column views of the
// fused QKV product (row stride 3*H*D*2 = 4608 B) are read in place.  A
// head is the column box [h*D, h*D + 64) (two boxes at D = 128), 128 bytes
// wide, loaded with the 128-byte swizzle that wgmma's descriptors expect.
// Rows past L come back as zeros (TMA's out-of-bounds fill); keys past
// k_len are masked, query rows past q_len are never stored.
//
// Block: 288 threads for a Q tile of 128 rows of one (batch, head).  Warps
// 0-7 are two consumer warpgroups of 64 query rows each; warp 8 is the
// producer, whose lane 0 loads the Q tile once and streams K/V tiles of 64
// keys into a ring of STAGES stages (full/empty mbarrier pairs).  A
// consumer warpgroup computes S = Q K^T (wgmma m64n64k16, A and B from
// shared memory, K-major), runs the online softmax on the accumulator
// fragments in registers (a row's 64 scores live in the 4 lanes of a
// quad), converts P to bf16 A-fragments in registers and computes O += P V
// (wgmma m64n64k16, A from registers, V from shared memory MN-major with
// the transpose flag), then releases the stage.  The exponentials run in
// base 2 on pre-scaled scores.  Causal blocks stop streaming at the
// diagonal; a warpgroup whose 64 rows all lie above a tile skips its math
// but still releases the stage.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 128;  // query rows per block
constexpr int BLOCK_N = 64;   // keys per K/V tile
constexpr int WG_ROWS = 64;   // query rows per consumer warpgroup
constexpr int CONSUMER_WGS = BLOCK_M / WG_ROWS;
constexpr int CONSUMER_THREADS = CONSUMER_WGS * 128;
constexpr int THREADS = CONSUMER_THREADS + 32;  // + one producer warp
constexpr int ATOM_BYTES = 128;                 // one swizzled row: 64 bf16
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Cfg {
  static constexpr int ATOMS = D / 64;  // 128-byte column atoms per row
  static constexpr int STAGES = D == 64 ? 4 : 2;
  static constexpr int MIN_BLOCKS = D == 64 ? 2 : 1;
  static constexpr int Q_ATOM = BLOCK_M * ATOM_BYTES;   // one Q atom
  static constexpr int KV_ATOM = BLOCK_N * ATOM_BYTES;  // one K or V atom
  static constexpr int Q_BYTES = ATOMS * Q_ATOM;
  static constexpr int KV_BYTES = ATOMS * KV_ATOM;      // one K or V tile
  static constexpr int SMEM = 1024 /* alignment slack */ + Q_BYTES +
                              2 * STAGES * KV_BYTES + (2 * STAGES + 1) * 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Returns once the phase of parity `parity` has completed.  A wait that
// lasts 10 s means a load or an arrival was lost: the kernel traps (a
// launch error the caller sees) instead of holding the card forever.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t start = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - start > 10000000000ull) __trap();
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int col, int row,
                                            int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row), "r"(batch)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle.  lbo and sbo
// are in 16-byte units: K-major tiles use (1, 64), 8-row groups 1024 B
// apart; the MN-major V tile uses sbo 64 between 8-key groups (lbo, the
// distance to a next 64-column atom, is not used at N = 64).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t desc = (smem_u32(p) & 0x3FFFF) >> 4;
  desc |= static_cast<uint64_t>(lbo & 0x3FFF) << 16;
  desc |= static_cast<uint64_t>(sbo & 0x3FFF) << 32;
  desc |= 1ull << 62;
  return desc;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses to accumulator registers across
// the asynchronous wgmma.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WGMMA_D32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WGMMA_D32_OPERANDS(d)                                               \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (64x64 f32) (+)= A (64x16 bf16, shared, K-major) * B (16x64 bf16,
// shared, K-major); scale_d == 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WGMMA_D32_OPERANDS(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64x64 f32) += A (64x16 bf16, registers) * B (16x64 bf16, shared,
// MN-major: the transpose flag is set).
__device__ __forceinline__ void wgmma_rs_m64n64k16_tb(float (&d)[32],
                                                      const uint32_t (&a)[4],
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : WGMMA_D32_OPERANDS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator fragment of wgmma m64nN (per warpgroup): warp w owns rows
// 16w..16w+15; lane owns rows g = lane/4 and g + 8 and, in each 8-column
// chunk j, columns 8j + 2(lane%4) + {0, 1}: d[4j + 2*half + e] is row
// g + 8*half, column 8j + 2(lane%4) + e.  That is also the A-operand
// register layout of a k16 slice, so S converts to P fragments in place.
template <int D>
__global__ void __launch_bounds__(THREADS, Cfg<D>::MIN_BLOCKS)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int heads, int q_len,
                          int k_len, float scale_log2, int causal) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled tiles want 1024-byte alignment
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_s = smem;
  uint8_t* k_s = q_s + C::Q_BYTES;
  uint8_t* v_s = k_s + C::STAGES * C::KV_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(v_s + C::STAGES * C::KV_BYTES);
  uint64_t* empty = full + C::STAGES;
  uint64_t* q_full = empty + C::STAGES;

  const int q0 = blockIdx.x * BLOCK_M;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k_end = causal ? min(k_len, q0 + BLOCK_M) : k_len;
  const int n_tiles = (k_end + BLOCK_N - 1) / BLOCK_N;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_THREADS);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMER_THREADS) {
    // ---- producer warp: lane 0 issues every TMA load ----
    if (threadIdx.x == CONSUMER_THREADS) {
      mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int a = 0; a < C::ATOMS; ++a)
        tma_load_3d(q_s + a * C::Q_ATOM, &q_map, q_full, h * D + a * 64, q0,
                    b);
      for (int t = 0; t < n_tiles; ++t) {
        const int stage = t % C::STAGES;
        mbar_wait(&empty[stage], ((t / C::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[stage], 2 * C::KV_BYTES);
#pragma unroll
        for (int a = 0; a < C::ATOMS; ++a) {
          tma_load_3d(k_s + stage * C::KV_BYTES + a * C::KV_ATOM, &k_map,
                      &full[stage], h * D + a * 64, t * BLOCK_N, b);
          tma_load_3d(v_s + stage * C::KV_BYTES + a * C::KV_ATOM, &v_map,
                      &full[stage], h * D + a * 64, t * BLOCK_N, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int quad = lane % 4;
  const int wg_row0 = q0 + wg * WG_ROWS;
  const int row_lo = wg_row0 + warp * 16 + lane / 4;  // + 8 * half

  float acc[C::ATOMS][32];
#pragma unroll
  for (int a = 0; a < C::ATOMS; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[a][i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // running max, base-2 scaled scores
  float l[2] = {0.f, 0.f};          // this lane's share of the normaliser

  mbar_wait(q_full, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t % C::STAGES;
    const int k0 = t * BLOCK_N;
    mbar_wait(&full[stage], (t / C::STAGES) & 1);
    // causal: keys of this tile above every row of this warpgroup
    if (!(causal && k0 > wg_row0 + WG_ROWS - 1)) {
      const uint8_t* k_tile = k_s + stage * C::KV_BYTES;
      const uint8_t* v_tile = v_s + stage * C::KV_BYTES;
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        const int a = kd / 4, off = (kd % 4) * 32;  // atom, byte column
        wgmma_ss_m64n64k16(
            s,
            sw128_desc(q_s + a * C::Q_ATOM + wg * WG_ROWS * ATOM_BYTES + off,
                       1, 64),
            sw128_desc(k_tile + a * C::KV_ATOM + off, 1, 64), kd > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row_lo + 8 * half;
        float mx = m[half];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * j + 2 * half + e;
            const int key = k0 + 8 * j + 2 * quad + e;
            float x = s[idx] * scale_log2;
            if (key >= k_len || (causal && key > row)) x = NEG_INF;
            s[idx] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float correction = fast_exp2(m[half] - mx);
        m[half] = mx;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * j + 2 * half + e;
            // masked entries contribute nothing, even in a masked row
            const float p =
                s[idx] > NEG_INF * 0.5f ? fast_exp2(s[idx] - mx) : 0.f;
            s[idx] = p;
            sum += p;
          }
        l[half] = l[half] * correction + sum;
#pragma unroll
        for (int a = 0; a < C::ATOMS; ++a)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[a][4 * j + 2 * half] *= correction;
            acc[a][4 * j + 2 * half + 1] *= correction;
          }
      }

      // P as bf16 A-fragments: k16 slice kk is score chunks 2kk, 2kk + 1
      uint32_t p_frag[BLOCK_N / 16][4];
#pragma unroll
      for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
        p_frag[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        p_frag[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        p_frag[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        p_frag[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
#pragma unroll
      for (int a = 0; a < C::ATOMS; ++a) fence_regs(acc[a]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BLOCK_N / 16; ++kk)
#pragma unroll
        for (int a = 0; a < C::ATOMS; ++a)
          wgmma_rs_m64n64k16_tb(
              acc[a], p_frag[kk],
              sw128_desc(v_tile + a * C::KV_ATOM + kk * 16 * ATOM_BYTES,
                         C::KV_ATOM / 16, 64));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int a = 0; a < C::ATOMS; ++a) fence_regs(acc[a]);
    }
    mbar_arrive(&empty[stage]);
  }

  // ---- epilogue: O / l in bf16, lse in f32 ----
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float l_row = l[half];
    l_row += __shfl_xor_sync(0xffffffffu, l_row, 1);
    l_row += __shfl_xor_sync(0xffffffffu, l_row, 2);
    const float l_safe = fmaxf(l_row, 1e-30f);
    const float inv = 1.f / l_safe;
    const int row = row_lo + 8 * half;
    if (row >= q_len) continue;
    __nv_bfloat16* out_row =
        o + ((static_cast<int64_t>(b) * q_len + row) * heads + h) * D;
#pragma unroll
    for (int a = 0; a < C::ATOMS; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = a * 64 + 8 * j + 2 * quad;
        *reinterpret_cast<__nv_bfloat162*>(out_row + col) =
            __floats2bfloat162_rn(acc[a][4 * j + 2 * half] * inv,
                                  acc[a][4 * j + 2 * half + 1] * inv);
      }
    if (quad == 0)
      lse[(static_cast<int64_t>(b) * q_len + row) * heads + h] =
          m[half] * LN2 + logf(l_safe);
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime's
// cudaGetDriverEntryPoint (no link against the driver library).
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* entry = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &entry,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(entry);
  }
  return fn;
}

// (B, L, H*D) bf16 with element strides (row_stride, batch_stride), boxes of
// 64 columns x box_rows rows, 128-byte swizzle, zeros out of bounds.
CUresult make_map(CUtensorMap* map, const void* ptr, int batch, int len,
                  int width, long long row_stride, long long batch_stride,
                  int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  if (batch == 1) batch_stride = row_stride * len;  // never stepped over
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row_stride) * 2,
                                 static_cast<cuuint64_t>(batch_stride) * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int batch, int heads, int q_len, int k_len, long long q_bs,
           long long q_rs, long long k_bs, long long k_rs, long long v_bs,
           long long v_rs, float scale, int causal, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  CUresult res = make_map(&q_map, q, batch, q_len, heads * D, q_rs, q_bs,
                          BLOCK_M);
  if (res == CUDA_SUCCESS)
    res = make_map(&k_map, k, batch, k_len, heads * D, k_rs, k_bs, BLOCK_N);
  if (res == CUDA_SUCCESS)
    res = make_map(&v_map, v, batch, k_len, heads * D, v_rs, v_bs, BLOCK_N);
  // driver errors are returned offset by 10000, apart from CUDA runtime ones
  if (res != CUDA_SUCCESS) return 10000 + static_cast<int>(res);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg<D>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((q_len + BLOCK_M - 1) / BLOCK_M, heads, batch);
  flash_fwd_sm90_kernel<D><<<grid, THREADS, Cfg<D>::SMEM, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), heads, q_len, k_len, scale * LOG2E, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q/k/v (B, L, H, D), D = 64 or 128, (H, D) contiguous, 16-byte
// aligned base pointers and row/batch strides (elements) that are
// multiples of 8.  o: contiguous (B, Lq, H, D) bf16; lse: (B, Lq, H) f32.
// Returns 0 on success, a cudaError_t, or 10000 + a CUresult when a tensor
// map is refused.
extern "C" int flash_attention_fwd_sm90(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int batch, int heads, int q_len, int k_len, int head_dim, long long q_bs,
    long long q_rs, long long k_bs, long long k_rs, long long v_bs,
    long long v_rs, float scale, int causal, void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 ||
      q_len < 1 || k_len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();  // an earlier, unrelated error is not ours
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return launch<64>(q, k, v, o, lse, batch, heads, q_len, k_len, q_bs, q_rs,
                      k_bs, k_rs, v_bs, v_rs, scale, causal, s);
  if (head_dim == 128)
    return launch<128>(q, k, v, o, lse, batch, heads, q_len, k_len, q_bs,
                       q_rs, k_bs, k_rs, v_bs, v_rs, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
