// Flash attention in bf16 or float16 on Hopper's tensor cores (sm_90a):
// wgmma fed by TMA under mbarriers, with a warp-specialised producer.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:93
// `flash_attention` (body `_kernel`) for bf16 and float16 inputs (one
// template over the element type T: wgmma's .bf16 or .f16 operands, a
// BFLOAT16 or FLOAT16 tensor map; the layouts are the same): for each
// query row,
// softmax(q k^T * h^-1/2) v over its key blocks, with the running max m, sum
// l and accumulator in float32, the causal and sliding-window masks
// (window only with causal), the tail mask col < T, the skip of key blocks
// the causal/window geometry makes dead (the predicate of
// flash_attention.cu, at this kernel's block sizes), GQA by reading kv
// head n*K/N for query head n, and the output acc / max(l, 1e-30) in T.
// Float32 inputs, head_dims that are not multiples of 8 or past 256, and
// bases TMA cannot read go to flash_attention.cu (CUDA cores, float32
// products).
// The plain version is repro_torch/kernels/flash_attention/ref.py.
//
// What bounds it: operations.  At minitron-8b's layer (B=1, S=4096, N=32,
// K=8, h=128, causal) the work is 1.3747e11 flop against 8.3886e7 B of
// q/k/v/out: 1640 flop per byte, far right of the card's ridge (~295 for
// bf16), so the bound is the bf16 tensor-core rate.
//
// Design, per CTA of 384 threads = three warpgroups, one (128-row q block,
// query head, batch):
// - Warpgroups 0 and 1 consume, 64 query rows each; warpgroup 2 produces:
//   one thread issues every TMA copy.  setmaxnreg gives the consumers 240
//   registers and the producer 24; the roles split in one if/else that
//   never reconverges.
// - TMA reads the model layout q (B, S, N, h), k/v (B, T, K, h) through one
//   4-D tensor map each, dims (h, heads, seq, B), as boxes of 64 columns
//   (128 bytes, the 128-byte swizzle's span) by 128 rows; rows past S or T
//   arrive as zeros, so nothing is padded.  The q tile is loaded once; k
//   and v go through a ring of two stages, each with a full barrier for k,
//   one for v (so S = q k^T starts before v lands) and an empty barrier
//   the consumers' eight warps arrive on.  Loads of the next block overlap
//   this block's products and softmax.
// - S = q k^T: wgmma m64n128k16 with both operands in shared memory, both
//   K-major, h/16 k-steps, float32 accumulators (64 registers a thread).
// - Softmax on the accumulator fragments: each row lies on 4 lanes of a
//   warp, so its max reduces with two xor-shuffles; the row sum stays
//   per lane until the epilogue.  Exponentials in base 2 (ex2.approx) of
//   s * h^-1/2 * log2(e) - m, one FFMA and one MUFU op per score.  Masks
//   (-1e30, as in the TPU kernel) are applied from the fragment's (row,
//   col), only on blocks that touch the diagonal, the window's edge or the
//   tail; there the exponent is (s - m) * h^-1/2 * log2(e).
// - O += P v: P is rounded to T in registers and fed as wgmma's register
//   A operand (the accumulator fragment of S is A's fragment); v is the
//   shared-memory B operand, MN-major (imm-trans-b), so it is never
//   transposed.  l is summed from the float32 P before rounding.
// - Grid order: the heaviest causal q blocks first, and the N/K query
//   heads that share a kv head next to each other (their k/v stay in L2).
// - Epilogue: acc / max(l, 1e-30) in T, rows < S only, straight from
//   registers.
//
// Head_dims: the kernel is built at HD = 64, 128 and 256, and a head_dim h
// (a multiple of 8, so that a row is a multiple of 16 bytes, as TMA's
// strides must be) runs at the smallest HD >= h.  The tensor maps keep the
// true h as their first dimension, so TMA fills columns h..HD-1 with zeros
// (nothing is padded in memory): they add exact zeros to q k^T, give zero
// output columns that are never stored, and the scale is h^-1/2.  At HD =
// 256 the key blocks are 64 rows (q 64 KB + 2 stages of k and v 128 KB;
// 128-row blocks would need 320 KB), S = q k^T is m64n64k16, and O += P v
// is two m64n128k16 per k-step, one per 128 output columns (128
// accumulator registers a consumer thread).
//
// Rounding, against the TPU kernel: P is rounded to T before P v (the
// TPU kernel keeps it in float32; the port's einsum path rounds it too,
// models/layers/attention.py `probs.to(v.dtype)`); exp is ex2.approx of
// the scaled score (relative error ~2^-22), the scale and the max folded
// into one FFMA on unmasked blocks; q k^T and P v sum their
// products in the tensor cores' order, 16 at a time per k-step; l is summed
// per lane and the four lanes at the end.  The bf16 tolerance 2e-2 covers
// all of it (tests/test_torch_llm_kernels.py emulates these numerics;
// tests/test_torch_kernel_dtypes.py in float16, whose P keeps 11 bits,
// below 2^-14 fewer: an absolute error under 2^-25 a probability).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 128;         // query rows per CTA
constexpr int CONSUMERS = 2;    // consumer warpgroups, 64 query rows each
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int STAGES = 2;       // k/v ring depth
constexpr int SPAN = 128;       // bytes of one swizzled row: 64 columns
constexpr float NEG_INF = -1e30f;

template <int HD>
struct Smem {
  static constexpr int BK = HD == 256 ? 64 : 128;  // key rows per block
  static constexpr int CHUNKS = HD / 64;         // 64-column boxes per row
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;   // one of k or v, one stage
  static constexpr int TILES = Q_BYTES + STAGES * 2 * KV_BYTES;
  // + 1024 to align the base for the swizzle, + the barriers
  static constexpr int BYTES = TILES + 1024 + 8 * (1 + 3 * STAGES);
  static_assert(BYTES <= 232448, "over the opt-in shared memory of a block");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box of a 4-D tensor map into shared memory; completion is reported
// to `bar` as transaction bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start address,
// leading byte offset `lbo` (K-major: unused, 16; MN-major: the distance
// between 64-column chunks), stride byte offset 1024 (eight 128-byte rows).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
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

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma instructions.
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats as a packed pair of T (bf16 or float16), the low one first.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The wgmma instructions below in bf16 or in float16 (T): one asm body,
// its type written in by `ty`.
#define WGMMA_D64                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),       \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),       \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),       \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),       \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),       \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),       \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define WGMMA_D32                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])
#define REGS64                                                               \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"                        \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"              \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"              \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"              \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"              \
  "%60, %61, %62, %63"
#define REGS32                                                               \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"                        \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"              \
  "%24, %25, %26, %27, %28, %29, %30, %31"
// both operands in shared memory, both K-major (scale-d from a predicate)
#define WGMMA_SS_N128(ty)                                                    \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                               \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." ty "." ty " {" REGS64       \
  "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
#define WGMMA_SS_N64(ty)                                                     \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                               \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." ty "." ty " {" REGS32        \
  "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
// A in registers, B in shared memory MN-major (imm-trans-b = 1)
#define WGMMA_RS_N128(ty)                                                    \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                               \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." ty "." ty " {" REGS64       \
  "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
#define WGMMA_RS_N64(ty)                                                     \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                               \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." ty "." ty " {" REGS32        \
  "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"

template <typename T>
constexpr bool kHalf = std::is_same<T, __half>::value;

// D (64 x 128, float32) (+)= A (64 x 16, smem) * B (16 x 128, smem), both
// K-major under the 128-byte swizzle.
template <typename T>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  if constexpr (kHalf<T>)
    asm volatile(WGMMA_SS_N128("f16") : WGMMA_D64
                 : "l"(da), "l"(db), "r"(scale_d));
  else
    asm volatile(WGMMA_SS_N128("bf16") : WGMMA_D64
                 : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, float32) (+)= A (64 x 16, smem) * B (16 x 64, smem), both
// K-major under the 128-byte swizzle.
template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  if constexpr (kHalf<T>)
    asm volatile(WGMMA_SS_N64("f16") : WGMMA_D32
                 : "l"(da), "l"(db), "r"(scale_d));
  else
    asm volatile(WGMMA_SS_N64("bf16") : WGMMA_D32
                 : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, float32) += A (64 x 16, registers) * B (16 x 128, smem),
// B MN-major under the 128-byte swizzle (imm-trans-b = 1).
template <typename T>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  if constexpr (kHalf<T>)
    asm volatile(WGMMA_RS_N128("f16") : WGMMA_D64
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                   "r"(1));
  else
    asm volatile(WGMMA_RS_N128("bf16") : WGMMA_D64
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                   "r"(1));
}

// D (64 x 64, float32) += A (64 x 16, registers) * B (16 x 64, smem),
// B MN-major under the 128-byte swizzle (imm-trans-b = 1).
template <typename T>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  if constexpr (kHalf<T>)
    asm volatile(WGMMA_RS_N64("f16") : WGMMA_D32
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                   "r"(1));
  else
    asm volatile(WGMMA_RS_N64("bf16") : WGMMA_D32
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                   "r"(1));
}

// S (+)= q k^T for one k-step: n128 at 128-row key blocks, n64 at 64
template <typename T>
__device__ __forceinline__ void wgmma_qk(float (&s)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  wgmma_ss_n128<T>(s, da, db, scale_d);
}
template <typename T>
__device__ __forceinline__ void wgmma_qk(float (&s)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  wgmma_ss_n64<T>(s, da, db, scale_d);
}

// O += P v for one k-step of 16 key rows; `vb` is the k-step's first row of
// the v tile, `lbo` the distance between its 64-column chunks.
template <typename T>
__device__ __forceinline__ void wgmma_pv(float (&o)[32], const uint32_t (&a)[4],
                                         uint32_t vb, uint32_t lbo) {
  wgmma_rs_n64<T>(o, a, sw128_desc(vb, lbo));
}
template <typename T>
__device__ __forceinline__ void wgmma_pv(float (&o)[64], const uint32_t (&a)[4],
                                         uint32_t vb, uint32_t lbo) {
  wgmma_rs_n128<T>(o, a, sw128_desc(vb, lbo));
}
// HD = 256: columns 0-127 from chunks 0-1, columns 128-255 from chunks 2-3;
// the halves of o are n128 fragments, and side by side they are the n256
// fragment (column 8 (idx / 4) + ...), so nothing else changes
template <typename T>
__device__ __forceinline__ void wgmma_pv(float (&o)[128], const uint32_t (&a)[4],
                                         uint32_t vb, uint32_t lbo) {
  wgmma_rs_n128<T>(*reinterpret_cast<float(*)[64]>(&o[0]), a,
                   sw128_desc(vb, lbo));
  wgmma_rs_n128<T>(*reinterpret_cast<float(*)[64]>(&o[64]), a,
                   sw128_desc(vb + 2 * lbo, lbo));
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1) flash_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, T* __restrict__ out,
    int S, int T_len, int N, int K, int h, int causal, int window,
    float scale_log2) {
  using L = Smem<HD>;
  constexpr int BK = L::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t bars = base + L::TILES;
  const uint32_t q_full = bars;
  // k_full[s] = bars + 8 (1 + s), v_full[s] = ... + 8 STAGES, empty[s] = ...
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * STAGES + s); };
  auto k_tile = [&](int s) {
    return base + L::Q_BYTES + static_cast<uint32_t>(s) * 2 * L::KV_BYTES;
  };

  // blockIdx.x -> (query head fastest, then q block heaviest first, batch)
  const int num_qb = (S + BQ - 1) / BQ;
  int id = blockIdx.x;
  const int n = id % N;
  id /= N;
  const int qb = num_qb - 1 - id % num_qb;
  const int b = id / num_qb;
  const int kvh = n * K / N;
  const int i0 = qb * BQ;

  // live key blocks [j_begin, j_end): flash_attention.cu's skip predicate
  const int num_kb = (T_len + BK - 1) / BK;
  int j_begin = 0, j_end = num_kb;
  if (causal) {
    j_end = min(num_kb, (i0 + BQ - 1) / BK + 1);
    if (window > 0) {
      const int lo = i0 - window + 1 - (BK - 1);  // live iff j*BK >= lo
      j_begin = lo > 0 ? (lo + BK - 1) / BK : 0;
    }
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), CONSUMERS * 4);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // ---- producer: one thread issues every copy --------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == CONSUMERS * 128) {
      mbar_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < L::CHUNKS; ++c)
        tma_load(sq + c * BQ * SPAN, &map_q, q_full, 64 * c, n, i0, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int j = j_begin; j < j_end; ++j) {
        mbar_wait(empty(stage), phase ^ 1);
        const uint32_t sk = k_tile(stage), sv = sk + L::KV_BYTES;
        mbar_expect_tx(k_full(stage), L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < L::CHUNKS; ++c)
          tma_load(sk + c * BK * SPAN, &map_k, k_full(stage), 64 * c, kvh,
                   j * BK, b);
        mbar_expect_tx(v_full(stage), L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < L::CHUNKS; ++c)
          tma_load(sv + c * BK * SPAN, &map_v, v_full(stage), 64 * c, kvh,
                   j * BK, b);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup --------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    // this thread's rows (r_in, r_in + 8) within the CTA's block, and its
    // first column within each group of 8 accumulator columns
    const int r_in = wg * 64 + warp * 16 + lane / 4;
    const int cq = 2 * (lane % 4);
    float o[HD / 2];
    float s[BK / 2];
    float m[2] = {NEG_INF, NEG_INF};  // running max, unscaled
    float l[2] = {0.0f, 0.0f};        // running sum, this lane's columns
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.0f;

    mbar_wait(q_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int j = j_begin; j < j_end; ++j) {
      const int j0 = j * BK;
      const uint32_t sk = k_tile(stage), sv = sk + L::KV_BYTES;

      // S = q k^T
      mbar_wait(k_full(stage), phase);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        const int c = ks / 4, kk = ks % 4;
        const uint64_t da = sw128_desc(
            sq + c * BQ * SPAN + wg * 64 * SPAN + kk * 32, 16);
        const uint64_t db = sw128_desc(sk + c * BK * SPAN + kk * 32, 16);
        wgmma_qk<T>(s, da, db, ks > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // masks, on blocks that are not live for every (row, col)
      const bool whole = j0 + BK <= T_len &&
                         (!causal || (j0 + BK - 1 <= i0 &&
                                      (window <= 0 || j0 >= i0 + BQ - window)));
      if (!whole) {
#pragma unroll
        for (int idx = 0; idx < BK / 2; ++idx) {
          const int row = i0 + r_in + 8 * ((idx / 2) % 2);
          const int col = j0 + 8 * (idx / 4) + cq + idx % 2;
          bool keep = col < T_len;
          if (causal) {
            keep = keep && col <= row;
            if (window > 0) keep = keep && col > row - window;
          }
          if (!keep) s[idx] = NEG_INF;
        }
      }

      // online softmax on the fragments: rows r_in (i = 0) and r_in + 8
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int idx = 0; idx < BK / 2; ++idx)
        mx[(idx / 2) % 2] = fmaxf(mx[(idx / 2) % 2], s[idx]);
      float alpha[2], ms[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        alpha[i] = ex2(__fmul_rn(__fsub_rn(m[i], mx[i]), scale_log2));
        m[i] = mx[i];
        ms[i] = __fmul_rn(mx[i], scale_log2);
      }
      if (whole) {  // every score is real: one FFMA per score
#pragma unroll
        for (int idx = 0; idx < BK / 2; ++idx) {
          const int i = (idx / 2) % 2;
          s[idx] = ex2(__fmaf_rn(s[idx], scale_log2, -ms[i]));
          rs[i] = __fadd_rn(rs[i], s[idx]);
        }
      } else {
        // subtract first, as the TPU kernel does: a row masked through this
        // block has s = m = -1e30 and p = exp(0) = 1 (wiped by the next live
        // block's alpha = 0), where the fused form would leave the rounding
        // residue of m * scale (~1e22) in the exponent
#pragma unroll
        for (int idx = 0; idx < BK / 2; ++idx) {
          const int i = (idx / 2) % 2;
          s[idx] = ex2(__fmul_rn(__fsub_rn(s[idx], mx[i]), scale_log2));
          rs[i] = __fadd_rn(rs[i], s[idx]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = __fadd_rn(__fmul_rn(alpha[i], l[i]), rs[i]);
#pragma unroll
      for (int idx = 0; idx < HD / 2; ++idx)
        o[idx] = __fmul_rn(o[idx], alpha[(idx / 2) % 2]);
      // P in T: the fragment of S's 16 columns kk is A's fragment
      uint32_t p[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          p[kk][r] = pack2<T>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

      // O += P v
      mbar_wait(v_full(stage), phase);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_pv<T>(o, p[kk], sv + kk * 16 * SPAN, BK * SPAN);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      if (lane == 0) mbar_arrive(empty(stage));
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // epilogue: acc / max(l, 1e-30) in T, rows < S, columns < h
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float lt = l[i];
      lt = __fadd_rn(lt, __shfl_xor_sync(0xffffffffu, lt, 1));
      lt = __fadd_rn(lt, __shfl_xor_sync(0xffffffffu, lt, 2));
      const float denom = fmaxf(lt, 1e-30f);
      const int row = i0 + r_in + 8 * i;
      if (row < S) {
        T* orow = out + ((static_cast<long long>(b) * S + row) * N + n) * h;
#pragma unroll
        for (int jj = 0; jj < HD / 8; ++jj)
          if (8 * jj < h)  // h % 8 == 0: both columns of the pair are < h
            *reinterpret_cast<uint32_t*>(orow + 8 * jj + cq) =
                pack2<T>(__fdiv_rn(o[4 * jj + 2 * i], denom),
                         __fdiv_rn(o[4 * jj + 2 * i + 1], denom));
      }
    }
  }
}

// cuTensorMapEncodeTiled, fetched from the driver once (no -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The model layout (B, seq, heads, h) of 2-byte `type` as dims (h, heads,
// seq, B),
// boxes of 64 columns x `rows` rows under the 128-byte swizzle; columns past
// h and rows past seq arrive as zeros.  Returns 0, or 1000 + the driver's
// CUresult.
int encode(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
           int hd, int heads, int seq, int batch, int rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * seq};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, type, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(r);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int T_len, int N, int K, int h, int causal, int window,
           cudaStream_t stream) {
  auto kernel = flash_attention_wgmma_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<HD>::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const CUtensorMapDataType type = kHalf<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap mq, mk, mv;
  int e = encode(&mq, type, q, h, N, S, B, BQ);
  if (e == 0) e = encode(&mk, type, k, h, K, T_len, B, Smem<HD>::BK);
  if (e == 0) e = encode(&mv, type, v, h, K, T_len, B, Smem<HD>::BK);
  if (e != 0) return e;
  // h^-1/2 * log2(e) for the true h (not HD), rounded once to float32
  const float scale_log2 = static_cast<float>(
      1.4426950408889634 / sqrt(static_cast<double>(h)));
  const int grid = (S + BQ - 1) / BQ * N * B;
  kernel<<<grid, THREADS, Smem<HD>::BYTES, stream>>>(
      mq, mk, mv, static_cast<T*>(out), S, T_len, N, K, h, causal, window,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_h(const void* q, const void* k, const void* v, void* out, int B,
             int S, int T_len, int N, int K, int h, int causal, int window,
             cudaStream_t st) {
  if (h <= 64)
    return launch<T, 64>(q, k, v, out, B, S, T_len, N, K, h, causal, window,
                         st);
  if (h <= 128)
    return launch<T, 128>(q, k, v, out, B, S, T_len, N, K, h, causal, window,
                          st);
  return launch<T, 256>(q, k, v, out, B, S, T_len, N, K, h, causal, window,
                        st);
}

}  // namespace

// q/out (B, S, N, h), k/v (B, T, K, h), bf16 (is_half 0) or float16
// (is_half 1), contiguous, 16-byte aligned, h a multiple of 8 from 8 to
// 256.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k,
                                            const void* v, void* out, int B,
                                            int S, int T_len, int N, int K,
                                            int h, int causal, int window,
                                            int is_half, void* stream) {
  if (B <= 0 || S <= 0 || N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T_len <= 0)  // no keys: l = 0 and the output is 0, as in the kernel
    return static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(B) * S * N * h * 2, st));
  if (h <= 0 || h > 256 || h % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_half)
    return launch_h<__half>(q, k, v, out, B, S, T_len, N, K, h, causal,
                            window, st);
  return launch_h<__nv_bfloat16>(q, k, v, out, B, S, T_len, N, K, h, causal,
                                 window, st);
}
