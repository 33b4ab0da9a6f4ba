// Flash-attention backward on Hopper's tensor cores (sm_90a): TMA loads,
// mbarrier rings fed by one producer warp, and every product by wgmma with
// bf16 operands and f32 accumulation.
//
// Replaces the JAX package's `_flash_bwd`
// (elasticdl_tpu/ops/flash_attention.py:208), the custom-VJP backward of
// the Pallas TPU kernel `_fwd_kernel` (:48); XLA compiles it there.  This
// source takes bf16 inputs at D = 64 or 128; flash_attention_bwd.cu keeps
// every other case (f32, other D, views TMA cannot describe) on the CUDA
// cores.  Same function, by recompute from the forward's log-sum-exp, with
// nothing O(L^2) kept in device memory:
//
//   delta = rowsum(dO * O)                        (f32)
//   S     = Q K^T * scale  (causal: -1e30 above the diagonal)
//   P     = exp(S - lse)                          (f32)
//   dV    = P_bf16^T dO,   dP = dO V^T
//   dS    = (P * (dP - delta) * scale)_bf16
//   dQ    = dS K,          dK = dS^T Q
//
// P and dS are rounded to bf16 where the reference rounds them (`pc =
// p.astype(q.dtype)`, `ds.astype`); products accumulate in f32; dQ, dK and
// dV are written in bf16, contiguous (B, L, H, D).
//
// Bound: operations.  At bench_bert's shape (B 64, L 512, H 12, D 64) the
// five products of the function take 5 * 2*B*H*L^2*D = 128.8 GFLOP, 0.130 ms
// at 989 TFLOP/s dense bf16; the bytes (q, k, v, O, dO and lse read once,
// dQ, dK, dV written once: 404 MB) take 0.121 ms at 3.35 TB/s.  This design
// runs 7 products (S and dP are recomputed by both passes: the price of no
// atomics), a floor of 0.182 ms.  What it does about the bound: every
// product runs on the tensor cores by wgmma from 128-byte-swizzled shared
// memory, tiles arrive by TMA into a ring that one producer warp keeps
// ahead of the two consumer warpgroups, and P and dS never leave the
// registers: the accumulator fragment of one product is the A operand of
// the next, converted to bf16 in place.  The exponentials run in base 2 on
// pre-scaled scores (the lse copy below is stored times log2(e)).
//
// Three launches, no atomics, so a result is the same bits on every call
// (the remat contract of the model needs that):
//   1. prep (`flash_bwd_prep_kernel`): delta and lse * log2(e) as (B, H, Lq)
//      f32, 16-byte loads of O and dO.  The copy of lse exists because lse
//      is (B, Lq, H): its per-head stride is H * 4 bytes (24 B at H = 6),
//      which TMA, needing global strides in multiples of 16 B, cannot
//      describe.
//   2. dK/dV (`flash_bwd_dkdv_sm90_kernel`): a block owns 128 keys of one
//      (batch, head): two consumer warpgroups of 64 keys and one producer
//      warpgroup.  K and V load once by TMA; the producer streams (Q, dO,
//      lse, delta) tiles of BQ queries (64 at D = 64, 32 at D = 128, so the
//      S/dP accumulators fit beside dK and dV in the register file) through
//      a ring of full/empty mbarrier pairs.  Per tile a warpgroup computes
//      S^T = K Q^T and dP^T = V dO^T (SS: A and B K-major), P^T and dS^T on
//      the fragments (lse and delta index their columns), then dV += P^T dO
//      and dK += dS^T Q (RS: A from registers, B MN-major with the
//      transpose flag).  Causal blocks start at the diagonal's tile.
//   3. dQ (`flash_bwd_dq_sm90_kernel`): a block owns 128 query rows, Q and
//      dO load once, the producer streams (K, V) tiles of 64 keys; the
//      forward's structure with one more product: S = Q K^T and dP = dO V^T
//      (SS), P and dS on the fragments, dQ += dS K (RS, K MN-major).  At
//      D = 64 a tile's dQ product and the next tile's scores are issued as
//      one group.  Causal blocks stop at the diagonal.
// Both warpgroups of a block walk the same tiles: a loop bound that differs
// between them, or a product outstanding across a branch, makes ptxas
// serialize every wgmma of the kernel.  A causal tile that lies wholly
// above a warpgroup's diagonal is computed and masked to zeros, which adds
// nothing.  Registers: ptxas gives a 384-thread block 168 a thread; the
// producer warpgroup drops to 24 by setmaxnreg and the consumers rise to
// 240, which dK, dV, S^T, dP^T and the bf16 fragments need at D = 64.
// Masking: TMA fills rows past the length with zeros.  A query past q_len
// then has S = 0 and a zero lse, so P would be 1: the dK/dV pass masks it
// explicitly, and the dQ pass masks keys past k_len; masked entries take
// the -1e30 sentinel before the exponential, which gives exactly 0.  Rows
// past the length are never stored.
//
// Layout: q, k, v, O and dO are (B, L, H, D) with the (H, D) dims
// contiguous, each described to TMA as a 3-D tensor (H*D columns, L rows,
// B batches) with its own row and batch strides, so the column views of
// the fused QKV product (row stride 3*H*D*2 = 4608 B) are read in place.
// A head is the column box [h*D, h*D + 64) (two boxes at D = 128), 128
// bytes wide, loaded with the 128-byte swizzle that wgmma's descriptors
// expect; at D = 128 each product runs as two 64-column atoms.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int KEY_TILE = 128;   // keys per dK/dV block
constexpr int ROW_TILE = 128;   // query rows per dQ block
constexpr int BLOCK_N = 64;     // keys per K/V tile of the dQ pass
constexpr int WG_ROWS = 64;     // rows (keys or queries) per warpgroup
constexpr int CONSUMER_THREADS = 256;            // two warpgroups
constexpr int THREADS = CONSUMER_THREADS + 128;  // + a producer warpgroup
// Registers a thread: a 384-thread block, one an SM, gets 168 (the whole
// register file); the producer warpgroup hands most of its share to the
// consumers (24 + 2 x 240 = 3 x 168).  The launch checks that the
// kernel was built with LAUNCH_REGS, so setmaxnreg.inc always finds its
// registers.
constexpr int LAUNCH_REGS = 168;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
static_assert(PRODUCER_REGS + 2 * CONSUMER_REGS <= 3 * LAUNCH_REGS,
              "setmaxnreg would wait for registers the block does not own");
constexpr int ATOM_BYTES = 128;                 // one swizzled row: 64 bf16
constexpr int PREP_THREADS = 256;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int ATOMS = D / 64;  // 128-byte column atoms per row
  // dK/dV pass: BQ queries per stage
  static constexpr int BQ = D == 64 ? 64 : 32;
  // Whether the dQ pass issues a tile's dQ product and the next tile's
  // scores as one group (see `dq_consumer`).  At D = 128 the extra live
  // scores would not fit beside dQ: ptxas would serialize the wgmmas.
  static constexpr bool DQ_PIPELINE = D == 64;
  static constexpr int DKDV_STAGES = 6;  // ring of (Q, dO, lse, delta)
  static constexpr int KV_ATOM = KEY_TILE * ATOM_BYTES;
  static constexpr int KV_BYTES = ATOMS * KV_ATOM;  // the block's K or V
  static constexpr int QS_ATOM = BQ * ATOM_BYTES;
  static constexpr int QS_BYTES = ATOMS * QS_ATOM;  // one stage's Q or dO
  static constexpr int VEC_BYTES = BQ * 4;          // one stage's lse or delta
  static constexpr int DKDV_SMEM =
      1024 /* alignment slack */ + 2 * KV_BYTES +
      DKDV_STAGES * (2 * QS_BYTES + 2 * VEC_BYTES) +
      (2 * DKDV_STAGES + 1) * 8;
  // dQ pass
  static constexpr int DQ_STAGES = D == 64 ? 4 : 2;  // ring of (K, V)
  static constexpr int ROW_ATOM = ROW_TILE * ATOM_BYTES;
  static constexpr int ROW_BYTES = ATOMS * ROW_ATOM;  // the block's Q or dO
  static constexpr int KT_ATOM = BLOCK_N * ATOM_BYTES;
  static constexpr int KT_BYTES = ATOMS * KT_ATOM;    // one stage's K or V
  static constexpr int DQ_SMEM = 1024 + 2 * ROW_BYTES +
                                 DQ_STAGES * 2 * KT_BYTES +
                                 (2 * DQ_STAGES + 1) * 8;
};

// ---- shared memory, mbarriers, TMA ------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
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

__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty,
                                              int stages, uint64_t* once) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_THREADS);
    }
    mbar_init(once, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
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

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row)
      : "memory");
}

// ---- wgmma ------------------------------------------------------------

// wgmma shared-memory matrix descriptor, 128-byte swizzle.  lbo and sbo
// are in 16-byte units: K-major tiles use (1, 64), 8-row groups 1024 B
// apart; MN-major B tiles (rows along the reduction) use sbo 64 between
// 8-row groups (lbo, the distance to a next 64-column atom, is not used at
// N = 64).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t desc = (smem_u32(p) & 0x3FFFF) >> 4;
  desc |= static_cast<uint64_t>(lbo & 0x3FFF) << 16;
  desc |= static_cast<uint64_t>(sbo & 0x3FFF) << 32;
  desc |= 1ull << 62;
  return desc;
}

// a K-major tile's k16 slice kd: its atom and byte column
template <int ATOM>
__device__ __forceinline__ uint64_t kmajor_desc(const uint8_t* tile, int kd) {
  return sw128_desc(tile + (kd / 4) * ATOM + (kd % 4) * 32, 1, 64);
}

// an MN-major B tile's k16 slice kk (rows 16kk..) in column atom a
template <int ATOM>
__device__ __forceinline__ uint64_t mnmajor_desc(const uint8_t* tile, int a,
                                                 int kk) {
  return sw128_desc(tile + a * ATOM + kk * 16 * ATOM_BYTES, ATOM / 16, 64);
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

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Keeps the compiler from moving accesses to accumulator registers across
// the asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for bf16 A fragments that an asynchronous wgmma still reads:
// they stay in their registers until its wait.
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[i][r])::"memory");
}

#define WGMMA_D16                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WGMMA_D16_OPERANDS(d)                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
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
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
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

// The same at N = 32: the dK/dV pass's S^T and dP^T at D = 128 (BQ = 32).
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WGMMA_D16
      ", %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : WGMMA_D16_OPERANDS(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64x64 f32) += A (64x16 bf16, registers) * B (16x64 bf16, shared,
// MN-major: the transpose flag is set).
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32],
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
// register layout of a k16 slice, so k16 slice kk of a bf16 A operand is
// chunks 2kk and 2kk + 1, rounded in place (an m64nN fragment of F = N / 2
// floats gives F / 8 slices).
template <int F>
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[F / 8][4],
                                           const float (&d)[F]) {
#pragma unroll
  for (int kk = 0; kk < F / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// Stores a warpgroup's 64 x D accumulator (rows row_lo, row_lo + 8 of this
// lane) into a contiguous (B, len, H, D) bf16 output; rows past len are not
// stored.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out,
                                           const float (&acc)[D / 64][32],
                                           int b, int h, int heads, int len,
                                           int row_lo, int quad) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_lo + 8 * half;
    if (row >= len) continue;
    bf16* dst = out + ((static_cast<int64_t>(b) * len + row) * heads + h) * D;
#pragma unroll
    for (int a = 0; a < D / 64; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + a * 64 + 8 * j + 2 * quad) =
            __floats2bfloat162_rn(acc[a][4 * j + 2 * half],
                                  acc[a][4 * j + 2 * half + 1]);
  }
}

// ---- 1. delta and lse * log2(e) ---------------------------------------

// D / 8 threads per (batch, head, row), 16 bytes of O and of dO each; rows
// in (B, H, Lq) order, so the writes are contiguous.
template <int D>
__global__ void __launch_bounds__(PREP_THREADS)
    flash_bwd_prep_kernel(const bf16* __restrict__ o,
                          const bf16* __restrict__ g,
                          const float* __restrict__ lse,
                          float* __restrict__ delta,
                          float* __restrict__ lse2, int batch, int heads,
                          int q_len, int64_t o_bs, int64_t o_rs,
                          int64_t g_bs, int64_t g_rs) {
  constexpr int LANES = D / 8;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * PREP_THREADS +
                    threadIdx.x;
  const int64_t row_id = t / LANES;
  const int chunk = static_cast<int>(t % LANES);
  // no early return: every lane of the warp takes part in the shuffles
  const bool in = row_id < static_cast<int64_t>(batch) * heads * q_len;
  const int row = static_cast<int>(row_id % q_len);
  const int bh = static_cast<int>(row_id / q_len);
  const int h = bh % heads;
  const int b = bh / heads;
  float sum = 0.f;
  if (in) {
    const uint4 ov = *reinterpret_cast<const uint4*>(
        o + b * o_bs + row * o_rs + static_cast<int64_t>(h) * D + chunk * 8);
    const uint4 gv = *reinterpret_cast<const uint4*>(
        g + b * g_bs + row * g_rs + static_cast<int64_t>(h) * D + chunk * 8);
    const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 of = __bfloat1622float2(op[i]);
      const float2 gf = __bfloat1622float2(gp[i]);
      sum = fmaf(of.x, gf.x, sum);
      sum = fmaf(of.y, gf.y, sum);
    }
  }
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (in && chunk == 0) {
    delta[row_id] = sum;
    lse2[row_id] =
        lse[(static_cast<int64_t>(b) * q_len + row) * heads + h] * LOG2E;
  }
}

// ---- 2. dK and dV -----------------------------------------------------

// The dK/dV pass of one consumer warpgroup (64 keys from wg_key0 on).  Each
// tile runs as two groups: its scores, then its dV and dK products.
// (Issuing the next tile's scores with this tile's dV and dK, as the dQ
// pass does, makes ptxas serialize every wgmma of the kernel for want of
// registers: measured slower.)
template <int D>
__device__ __forceinline__ void dkdv_consumer(
    const uint8_t* k_wg, const uint8_t* v_wg, const uint8_t* q_s,
    const uint8_t* g_s, const float* lse_s, const float* delta_s,
    uint64_t* full, uint64_t* empty, uint64_t* kv_full, bf16* dk, bf16* dv,
    int b, int h, int heads, int q_len, int k_len, int q_start, int n_tiles,
    int wg_key0, float scale, float scale_log2, int causal) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ;
  constexpr int STAGES = C::DKDV_STAGES;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int quad = lane % 4;
  const int key_lo = wg_key0 + warp * 16 + lane / 4;  // + 8 * half

  float dk_acc[C::ATOMS][32];
  float dv_acc[C::ATOMS][32];
#pragma unroll
  for (int a = 0; a < C::ATOMS; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[a][i] = dv_acc[a][i] = 0.f;

  mbar_wait(kv_full, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t % STAGES;
    const int q0 = q_start + t * BQ;
    const uint8_t* q_tile = q_s + stage * C::QS_BYTES;
    const uint8_t* g_tile = g_s + stage * C::QS_BYTES;
    mbar_wait(&full[stage], (t / STAGES) & 1);

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x BQ queries
    float s[BQ / 2];
    float dp[BQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      wgmma_ss(s, kmajor_desc<C::KV_ATOM>(k_wg, kd),
               kmajor_desc<C::QS_ATOM>(q_tile, kd), kd > 0);
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      wgmma_ss(dp, kmajor_desc<C::KV_ATOM>(v_wg, kd),
               kmajor_desc<C::QS_ATOM>(g_tile, kd), kd > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P^T into s and dS^T into dp; the columns are queries
    const float* lse_t = lse_s + stage * BQ;
    const float* delta_t = delta_s + stage * BQ;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * quad + e;
        const int row = q0 + col;
        const float l2 = lse_t[col];
        const float dl = delta_t[col];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int idx = 4 * j + 2 * half + e;
          const int key = key_lo + 8 * half;
          const bool valid = row < q_len && (!causal || row >= key);
          const float p =
              fast_exp2(valid ? fmaf(s[idx], scale_log2, -l2) : NEG_INF);
          s[idx] = p;
          dp[idx] = p * (dp[idx] - dl) * scale;
        }
      }
    uint32_t p_frag[BQ / 16][4];
    uint32_t ds_frag[BQ / 16][4];
    to_a_frags(p_frag, s);
    to_a_frags(ds_frag, dp);

    // dV += P^T dO and dK += dS^T Q: the reduction runs over the queries
#pragma unroll
    for (int a = 0; a < C::ATOMS; ++a) {
      fence_regs(dk_acc[a]);
      fence_regs(dv_acc[a]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int a = 0; a < C::ATOMS; ++a) {
        wgmma_rs_tb(dv_acc[a], p_frag[kk],
                    mnmajor_desc<C::QS_ATOM>(g_tile, a, kk));
        wgmma_rs_tb(dk_acc[a], ds_frag[kk],
                    mnmajor_desc<C::QS_ATOM>(q_tile, a, kk));
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int a = 0; a < C::ATOMS; ++a) {
      fence_regs(dk_acc[a]);
      fence_regs(dv_acc[a]);
    }
    mbar_arrive(&empty[stage]);
  }

  store_rows<D>(dk, dk_acc, b, h, heads, k_len, key_lo, quad);
  store_rows<D>(dv, dv_acc, b, h, heads, k_len, key_lo, quad);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                               const __grid_constant__ CUtensorMap g_map,
                               const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map,
                               const __grid_constant__ CUtensorMap lse2_map,
                               const __grid_constant__ CUtensorMap delta_map,
                               bf16* __restrict__ dk, bf16* __restrict__ dv,
                               int heads, int q_len, int k_len, float scale,
                               float scale_log2, int causal) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ;
  constexpr int STAGES = C::DKDV_STAGES;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled tiles want 1024-byte alignment
  uint8_t* k_s = align_1024(smem_raw);
  uint8_t* v_s = k_s + C::KV_BYTES;
  uint8_t* q_s = v_s + C::KV_BYTES;             // STAGES Q tiles
  uint8_t* g_s = q_s + STAGES * C::QS_BYTES;    // STAGES dO tiles
  float* lse_s = reinterpret_cast<float*>(g_s + STAGES * C::QS_BYTES);
  float* delta_s = lse_s + STAGES * BQ;
  uint64_t* full = reinterpret_cast<uint64_t*>(delta_s + STAGES * BQ);
  uint64_t* empty = full + STAGES;
  uint64_t* kv_full = empty + STAGES;

  const int k0 = blockIdx.x * KEY_TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  // causal: queries before this block's first key see none of it
  const int q_start = causal ? (k0 / BQ) * BQ : 0;
  const int n_tiles = q_start < q_len ? (q_len - q_start + BQ - 1) / BQ : 0;

  init_barriers(full, empty, STAGES, kv_full);

  if (threadIdx.x >= CONSUMER_THREADS) {
    // ---- producer warpgroup: lane 0 of its first warp issues every load
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMER_THREADS) {
      mbar_expect_tx(kv_full, 2 * C::KV_BYTES);
#pragma unroll
      for (int a = 0; a < C::ATOMS; ++a) {
        tma_load_3d(k_s + a * C::KV_ATOM, &k_map, kv_full, h * D + a * 64, k0,
                    b);
        tma_load_3d(v_s + a * C::KV_ATOM, &v_map, kv_full, h * D + a * 64, k0,
                    b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int stage = t % STAGES;
        const int q0 = q_start + t * BQ;
        mbar_wait(&empty[stage], ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[stage], 2 * C::QS_BYTES + 2 * C::VEC_BYTES);
#pragma unroll
        for (int a = 0; a < C::ATOMS; ++a) {
          tma_load_3d(q_s + stage * C::QS_BYTES + a * C::QS_ATOM, &q_map,
                      &full[stage], h * D + a * 64, q0, b);
          tma_load_3d(g_s + stage * C::QS_BYTES + a * C::QS_ATOM, &g_map,
                      &full[stage], h * D + a * 64, q0, b);
        }
        tma_load_2d(lse_s + stage * BQ, &lse2_map, &full[stage], q0,
                    b * heads + h);
        tma_load_2d(delta_s + stage * BQ, &delta_map, &full[stage], q0,
                    b * heads + h);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 keys each ----
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = threadIdx.x / 128;
    dkdv_consumer<D>(k_s + wg * WG_ROWS * ATOM_BYTES,
                     v_s + wg * WG_ROWS * ATOM_BYTES, q_s, g_s, lse_s,
                     delta_s, full, empty, kv_full, dk, dv, b, h, heads,
                     q_len, k_len, q_start, n_tiles, k0 + wg * WG_ROWS, scale,
                     scale_log2, causal);
  }
}

// ---- 3. dQ ------------------------------------------------------------

// The dQ pass of one consumer warpgroup (64 query rows from wg_row0 on).
// With DQ_PIPELINE, tile t + 1's S and dP products are issued behind tile
// t's dQ product, in the same group: the tensor cores run them back to
// back, and every group is still waited for in the block that issues it
// (a product outstanding across a branch would be serialized by ptxas).
template <int D>
__device__ __forceinline__ void dq_consumer(
    const uint8_t* q_wg, const uint8_t* g_wg, const uint8_t* k_s,
    const uint8_t* v_s, const float* lse2, const float* delta,
    uint64_t* full, uint64_t* empty, uint64_t* qg_full, bf16* dq, int b,
    int h, int heads, int q_len, int k_len, int n_tiles, int wg_row0,
    float scale, float scale_log2, int causal) {
  using C = Cfg<D>;
  constexpr int STAGES = C::DQ_STAGES;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int quad = lane % 4;
  const int row_lo = wg_row0 + warp * 16 + lane / 4;  // + 8 * half

  float lse_r[2], delta_r[2];
  const int64_t bh_row = (static_cast<int64_t>(b) * heads + h) * q_len;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_lo + 8 * half;
    lse_r[half] = row < q_len ? lse2[bh_row + row] : 0.f;
    delta_r[half] = row < q_len ? delta[bh_row + row] : 0.f;
  }

  float acc[C::ATOMS][32];
#pragma unroll
  for (int a = 0; a < C::ATOMS; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[a][i] = 0.f;

  mbar_wait(qg_full, 0);

  // S = Q K^T and dP = dO V^T of tile t: 64 rows x 64 keys
  float s[32];
  float dp[32];
  auto issue_scores = [&](int t) {
    const int stage = t % STAGES;
    const uint8_t* k_tile = k_s + stage * C::KT_BYTES;
    const uint8_t* v_tile = v_s + stage * C::KT_BYTES;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      wgmma_ss(s, kmajor_desc<C::ROW_ATOM>(q_wg, kd),
               kmajor_desc<C::KT_ATOM>(k_tile, kd), kd > 0);
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      wgmma_ss(dp, kmajor_desc<C::ROW_ATOM>(g_wg, kd),
               kmajor_desc<C::KT_ATOM>(v_tile, kd), kd > 0);
  };

  // Tile t, whose scores are in s and dp: dS, then dQ += dS K, with tile
  // t + 1's scores in the same group when `next` (a constant at each call
  // site, so the branches fold away).
  auto tile = [&](int t, bool next) {
    const int stage = t % STAGES;
    const int kt0 = t * BLOCK_N;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row_lo + 8 * half;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * j + 2 * half + e;
          const int key = kt0 + 8 * j + 2 * quad + e;
          const bool valid = key < k_len && (!causal || key <= row);
          const float p = fast_exp2(
              valid ? fmaf(s[idx], scale_log2, -lse_r[half]) : NEG_INF);
          dp[idx] = p * (dp[idx] - delta_r[half]) * scale;
        }
    }
    uint32_t ds_frag[BLOCK_N / 16][4];
    to_a_frags(ds_frag, dp);
    if (next) mbar_wait(&full[(t + 1) % STAGES], ((t + 1) / STAGES) & 1);

    // the reduction runs over the tile's keys
    const uint8_t* k_tile = k_s + stage * C::KT_BYTES;
#pragma unroll
    for (int a = 0; a < C::ATOMS; ++a) fence_regs(acc[a]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk)
#pragma unroll
      for (int a = 0; a < C::ATOMS; ++a)
        wgmma_rs_tb(acc[a], ds_frag[kk],
                    mnmajor_desc<C::KT_ATOM>(k_tile, a, kk));
    if (next) issue_scores(t + 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_frags(ds_frag);
#pragma unroll
    for (int a = 0; a < C::ATOMS; ++a) fence_regs(acc[a]);
    fence_regs(s);
    fence_regs(dp);
    mbar_arrive(&empty[stage]);
  };

  auto scores = [&](int t) {
    mbar_wait(&full[t % STAGES], (t / STAGES) & 1);
    wgmma_fence();
    issue_scores(t);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);
  };
  if (C::DQ_PIPELINE) {
    scores(0);
    for (int t = 0; t + 1 < n_tiles; ++t) tile(t, true);
    tile(n_tiles - 1, false);
  } else {
    for (int t = 0; t < n_tiles; ++t) {
      scores(t);
      tile(t, false);
    }
  }

  store_rows<D>(dq, acc, b, h, heads, q_len, row_lo, quad);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap g_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             const float* __restrict__ lse2,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dq, int heads, int q_len,
                             int k_len, float scale, float scale_log2,
                             int causal) {
  using C = Cfg<D>;
  constexpr int STAGES = C::DQ_STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align_1024(smem_raw);
  uint8_t* g_s = q_s + C::ROW_BYTES;
  uint8_t* k_s = g_s + C::ROW_BYTES;            // STAGES K tiles
  uint8_t* v_s = k_s + STAGES * C::KT_BYTES;    // STAGES V tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(v_s + STAGES * C::KT_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* qg_full = empty + STAGES;

  const int q0 = blockIdx.x * ROW_TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  // causal: keys past this block's last row are all masked
  const int k_end = causal ? min(k_len, q0 + ROW_TILE) : k_len;
  const int n_tiles = (k_end + BLOCK_N - 1) / BLOCK_N;

  init_barriers(full, empty, STAGES, qg_full);

  if (threadIdx.x >= CONSUMER_THREADS) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMER_THREADS) {
      mbar_expect_tx(qg_full, 2 * C::ROW_BYTES);
#pragma unroll
      for (int a = 0; a < C::ATOMS; ++a) {
        tma_load_3d(q_s + a * C::ROW_ATOM, &q_map, qg_full, h * D + a * 64,
                    q0, b);
        tma_load_3d(g_s + a * C::ROW_ATOM, &g_map, qg_full, h * D + a * 64,
                    q0, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int stage = t % STAGES;
        mbar_wait(&empty[stage], ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[stage], 2 * C::KT_BYTES);
#pragma unroll
        for (int a = 0; a < C::ATOMS; ++a) {
          tma_load_3d(k_s + stage * C::KT_BYTES + a * C::KT_ATOM, &k_map,
                      &full[stage], h * D + a * 64, t * BLOCK_N, b);
          tma_load_3d(v_s + stage * C::KT_BYTES + a * C::KT_ATOM, &v_map,
                      &full[stage], h * D + a * 64, t * BLOCK_N, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = threadIdx.x / 128;
    dq_consumer<D>(q_s + wg * WG_ROWS * ATOM_BYTES,
                   g_s + wg * WG_ROWS * ATOM_BYTES, k_s, v_s, lse2, delta,
                   full, empty, qg_full, dq, b, h, heads, q_len, k_len,
                   n_tiles, q0 + wg * WG_ROWS, scale, scale_log2, causal);
  }
}

// ---- launches ---------------------------------------------------------

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

// A contiguous (rows, len) f32 array (delta or lse * log2(e) as (B*H, Lq)),
// boxes of box_cols x 1, no swizzle, zeros out of bounds.  len * 4 bytes
// must be a multiple of 16: Lq is a multiple of 8.
CUresult make_vec_map(CUtensorMap* map, const void* ptr, int rows, int len,
                      int box_cols) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(len) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), 1};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr),
            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

struct Args {
  const void *q, *k, *v, *o, *g, *lse;
  void *delta, *lse2, *dq, *dk, *dv;
  int batch, heads, q_len, k_len;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, g_bs, g_rs;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <int D>
int launch(const Args& a) {
  using C = Cfg<D>;
  const int width = a.heads * D;
  const int rows = a.batch * a.heads;
  // every tensor map first: a refused one returns before any launch
  CUtensorMap kv_q, kv_g, kv_k, kv_v, kv_lse2, kv_delta;
  CUtensorMap q_q, q_g, q_k, q_v;
  CUresult res = make_map(&kv_q, a.q, a.batch, a.q_len, width, a.q_rs,
                          a.q_bs, C::BQ);
  if (res == CUDA_SUCCESS)
    res = make_map(&kv_g, a.g, a.batch, a.q_len, width, a.g_rs, a.g_bs,
                   C::BQ);
  if (res == CUDA_SUCCESS)
    res = make_map(&kv_k, a.k, a.batch, a.k_len, width, a.k_rs, a.k_bs,
                   KEY_TILE);
  if (res == CUDA_SUCCESS)
    res = make_map(&kv_v, a.v, a.batch, a.k_len, width, a.v_rs, a.v_bs,
                   KEY_TILE);
  if (res == CUDA_SUCCESS)
    res = make_vec_map(&kv_lse2, a.lse2, rows, a.q_len, C::BQ);
  if (res == CUDA_SUCCESS)
    res = make_vec_map(&kv_delta, a.delta, rows, a.q_len, C::BQ);
  if (res == CUDA_SUCCESS)
    res = make_map(&q_q, a.q, a.batch, a.q_len, width, a.q_rs, a.q_bs,
                   ROW_TILE);
  if (res == CUDA_SUCCESS)
    res = make_map(&q_g, a.g, a.batch, a.q_len, width, a.g_rs, a.g_bs,
                   ROW_TILE);
  if (res == CUDA_SUCCESS)
    res = make_map(&q_k, a.k, a.batch, a.k_len, width, a.k_rs, a.k_bs,
                   BLOCK_N);
  if (res == CUDA_SUCCESS)
    res = make_map(&q_v, a.v, a.batch, a.k_len, width, a.v_rs, a.v_bs,
                   BLOCK_N);
  // driver errors are returned offset by 10000, apart from CUDA runtime ones
  if (res != CUDA_SUCCESS) return 10000 + static_cast<int>(res);
  // setmaxnreg.inc waits until the block's own registers allow it: refuse
  // a build whose register count would leave it waiting (checked once per
  // D; the count is the binary's)
  static const cudaError_t regs_ok = [] {
    const void* kernels[2] = {
        reinterpret_cast<const void*>(flash_bwd_dkdv_sm90_kernel<D>),
        reinterpret_cast<const void*>(flash_bwd_dq_sm90_kernel<D>)};
    for (const void* fn : kernels) {
      cudaFuncAttributes attr;
      const cudaError_t e = cudaFuncGetAttributes(&attr, fn);
      if (e != cudaSuccess) return e;
      if (attr.numRegs != LAUNCH_REGS) return cudaErrorInvalidConfiguration;
    }
    return cudaSuccess;
  }();
  if (regs_ok != cudaSuccess) return static_cast<int>(regs_ok);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_sm90_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::DKDV_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_sm90_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::DQ_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int64_t prep_threads =
      static_cast<int64_t>(rows) * a.q_len * (D / 8);
  const int64_t prep_blocks = (prep_threads + PREP_THREADS - 1) / PREP_THREADS;
  if (prep_blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_prep_kernel<D><<<static_cast<unsigned>(prep_blocks),
                             PREP_THREADS, 0, a.stream>>>(
      static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.g),
      static_cast<const float*>(a.lse), static_cast<float*>(a.delta),
      static_cast<float*>(a.lse2), a.batch, a.heads, a.q_len, a.o_bs, a.o_rs,
      a.g_bs, a.g_rs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const float scale_log2 = a.scale * LOG2E;
  const dim3 kv_grid((a.k_len + KEY_TILE - 1) / KEY_TILE, a.heads, a.batch);
  flash_bwd_dkdv_sm90_kernel<D><<<kv_grid, THREADS, C::DKDV_SMEM, a.stream>>>(
      kv_q, kv_g, kv_k, kv_v, kv_lse2, kv_delta, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.heads, a.q_len, a.k_len, a.scale,
      scale_log2, a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 q_grid((a.q_len + ROW_TILE - 1) / ROW_TILE, a.heads, a.batch);
  flash_bwd_dq_sm90_kernel<D><<<q_grid, THREADS, C::DQ_SMEM, a.stream>>>(
      q_q, q_g, q_k, q_v, static_cast<const float*>(a.lse2),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.dq), a.heads,
      a.q_len, a.k_len, a.scale, scale_log2, a.causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q/k/v/o/g (B, L, H, D), D = 64 or 128, (H, D) contiguous, 16-byte
// aligned base pointers, row/batch strides (elements) that are multiples of
// 8, rows and batches that do not overlap; lse (B, Lq, H) f32, contiguous;
// delta and lse2 (B, H, Lq) f32 scratch; dq/dk/dv contiguous (B, L, H, D)
// bf16 outputs.  Lq and Lk are multiples of 8.  Returns 0 on success, a
// cudaError_t (checked after each of the three launches: a refused launch
// never runs, and a later synchronize would not report it), or 10000 + a
// CUresult when a tensor map is refused.
extern "C" int flash_attention_bwd_sm90(
    const void* q, const void* k, const void* v, const void* o,
    const void* g, const void* lse, void* delta, void* lse2, void* dq,
    void* dk, void* dv, int batch, int heads, int q_len, int k_len,
    int head_dim, long long q_bs, long long q_rs, long long k_bs,
    long long k_rs, long long v_bs, long long v_rs, long long o_bs,
    long long o_rs, long long g_bs, long long g_rs, float scale, int causal,
    void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 ||
      q_len < 1 || k_len < 1 || q_len % 8 != 0 || k_len % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();  // an earlier, unrelated error is not ours
  const Args a{q,    k,    v,    o,    g,    lse,  delta, lse2,  dq,
               dk,   dv,   batch, heads, q_len, k_len, q_bs, q_rs, k_bs,
               k_rs, v_bs, v_rs, o_bs, o_rs, g_bs, g_rs, scale, causal,
               static_cast<cudaStream_t>(stream)};
  if (head_dim == 64) return launch<64>(a);
  if (head_dim == 128) return launch<128>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}
