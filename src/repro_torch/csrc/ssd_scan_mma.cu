// Mamba-2 chunked SSD scan in bf16 or float16 on Hopper's tensor cores
// (sm_90a), chunk-parallel.
//
// Replaces the TPU kernel repro/kernels/ssd/kernel.py:74 `ssd_scan` (body
// `_kernel`) for bf16 and float16 inputs (one template over the element
// type T: mma.sync's .bf16 or .f16 operands, whose fragment layouts are the
// same).  Per (b, h) and chunk of Q rows, with
// cum = cumsum(da) within the chunk:
//   att[i,j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j      for j <= i
//   y_i      = sum_j att[i,j] x_j + exp(cum_i) * (C_i @ state)
//   state    = exp(cum_Q) * state + sum_j B_j^T exp(cum_Q - cum_j) dt_j x_j
// with the (N, P) state in float32.  Float32 inputs (and the shapes this
// kernel is not built for, and bases it cannot copy) go to ssd_scan.cu
// (CUDA cores).  The plain version is repro_torch/kernels/ssd/ref.py
// `ssd_scan_ref`.
//
// What bounds it: bytes.  At mamba2-370m's layer (B=4, L=4096, H=32, P=64,
// N=128, chunk 256) the work is ~43 GFLOP against 0.47 GB of x, B, C
// (bf16, group-expanded), da, dt and y (float32): ~0.044 ms at the bf16
// tensor-core rate against ~0.14 ms at the HBM rate.  The three passes
// below move 0.94 GB (B and x twice, the 67 MB state scratch four times).
//
// Design.  The TPU kernel carries the state through its sequential grid;
// blocks on Hopper run in no order, so the scan is split the way the SSD
// paper's GPU algorithm splits it (arXiv:2405.21060 §6), in three
// launches on the caller's stream:
//  1. chunk states, one CTA per (b, h, chunk), one warp per 16 state rows:
//     cum by a warp scan, w_j = exp(cum_Q - cum_j) dt_j, the chunk's own
//     state S_c = (B (.) w)^T x into the float32 scratch, and exp(cum_Q).
//  2. state pass, float32 on CUDA cores, one thread per 4 state elements,
//     in order over the chunks and in place on the scratch:
//     enter[c] = state; state = exp(cum_Q[c]) state + S_c (8 chunks' loads
//     in flight before their stores).
//  3. output, one CTA of 8 warps per (b, h, chunk): per 16-row tile,
//     y = exp(cum_i) (C @ enter[c]), then for each 16-column tile j <= i,
//     S = C B^T, the decay, dt and causal select in registers, y += att x.
//     y is written once, in float32.
// Each kernel loads its chunk's B, C and x tiles once, with cp.async, into
// shared memory under a 16-byte-chunk XOR swizzle (ldmatrix reads them
// without bank conflicts).  Pass 3 issues its copies in stages of 64 rows
// of B and x (all of C with the first), each counted by an mbarrier
// (cp.async.mbarrier.arrive), and a warp waits for a stage when it first
// reaches it, so the first tiles' products overlap the later loads.
// Warp-level mma.sync m16n8k16 (bf16 or float16 in, float32 accumulators) does every product; S's accumulator fragment is att's A
// fragment, so att never touches shared memory.  In pass 3 each warp takes
// the 16-row tiles w and Q/16-1-w, so the triangle's work is even across
// warps, and unrolls its column tiles by two, so one tile's S overlaps the
// previous tile's att x.  Shared memory: ~194 KB for pass 3 at N=128, Q=256 (one CTA per
// SM), ~97 KB for pass 1.  The wrapper allocates the (B, H, NC, N, P)
// float32 scratch and the (B, H, NC) decays; the kernels allocate nothing.
//
// Numerics.  C, B and x are exact in T; att, B (.) w and enter are
// float32.  Each float32 operand v is split into hi = T(v) and
// lo = T(v - hi), and both products go into the same float32
// accumulator: ~16 bits of the operand in bf16 (~22 in float16), where one
// bf16 rounding (~2^-9 per term) would leave errors of ~0.3 at N=128,
// chunk 256 where the outputs cancel (tests/test_torch_llm_kernels.py and
// tests/test_torch_kernel_dtypes.py model these numerics).  bf16 has
// float32's range.  Float16 does not, so its build scales each operand
// block by a power of two before the split and the float32 product back
// after it, both exact: B (.) w by a warp's 16 state rows over the chunk,
// enter by chunk, att by row with a running exponent over its column tiles
// (raised, acc's rows are rescaled first; see SPLIT_TOP below).  An
// operand's hi + lo is then within 2^-22 of its block's largest magnitude
// (2^-38 absolute for a block under 2), and no operand overflows short of
// float32's range.  That build adds y's state term after the att terms, as
// the reference's kernel does, so att's exponent follows att alone.  The
// decay is taken only for j <= i, by a select: for j > i, cum_i - cum_j > 0
// and exp of it can overflow.  That per-element decay is ex2.approx of
// (cum_i - cum_j) log2(e), as flash_attention_wgmma.cu's softmax does (the
// accurate expf's instruction sequence per element slowed pass 3
// measurably); the per-row exps
// (exp(cum_i), w_j, exp(cum_Q)) are expf.  cum is a per-lane sequential sum
// plus a warp scan, as in ssd_scan.cu; the tensor cores sum 16 products per
// k-step in their own order, and S sums its even and odd k-steps apart.
// Built with --fmad=false, no fast math.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int P = 64;          // head channels: x and y rows of 128 bytes
constexpr int OUT_WARPS = 8;   // pass 3
constexpr int OUT_THREADS = OUT_WARPS * 32;
constexpr int PASS_THREADS = 256;  // pass 2
constexpr int PASS_BATCH = 8;      // pass 2: chunks loaded at once
constexpr int STAGE_ROWS = 64;     // pass 3: rows of B and x per load stage

template <int N, int Q>
struct Layout {
  static constexpr int ROW_BYTES = 2 * N;    // one row of B or C
  static constexpr int BC_BYTES = Q * ROW_BYTES;
  static constexpr int X_BYTES = Q * P * 2;
  static constexpr int E_BYTES = N * P * 2;  // one of enter's hi and lo
  static constexpr int STATE_THREADS = 2 * N;  // pass 1: a warp per 16 rows
  // pass 1: B, x, w, cum, dt
  static constexpr int STATE_SMEM = BC_BYTES + X_BYTES + 3 * Q * 4;
  // pass 3: C, B, x, enter hi and lo, cum, dt, a barrier per load stage
  static constexpr int STAGES = Q / STAGE_ROWS;
  static constexpr int OUT_SMEM =
      2 * BC_BYTES + X_BYTES + 2 * E_BYTES + 2 * Q * 4 + 8 * STAGES;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `c` of row `r` in a tile of RB-byte rows:
// the chunk index is XORed with r % 8, so the 8 rows one ldmatrix phase
// reads at one logical chunk fall in 8 different bank groups.
template <int RB>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * RB + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The barrier at `bar` counts one arrival per thread when all of that
// thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
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

// `rows` rows of RB bytes from global `src` into the swizzled tile at `dst`.
template <int RB>
__device__ __forceinline__ void load_rows(uint32_t dst, const void* src,
                                          int rows, int tid, int nthreads) {
  constexpr int CH = RB / 16;
  const char* s = static_cast<const char*>(src);
  for (int e = tid; e < rows * CH; e += nthreads) {
    const int r = e / CH, c = e % CH;
    cp_async16(dst + swz<RB>(r, c),
               s + static_cast<long long>(r) * RB + c * 16);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// D (16 x 8, float32) += A (16 x 16, row) * B (16 x 8, col), both bf16 or
// both float16 (T)
template <typename T>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a packed pair of T (the low element first), and back.
template <typename T>
struct Pair;
template <>
struct Pair<__nv_bfloat16> {
  __device__ static uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  __device__ static float2 unpack(uint32_t v) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
  }
};
template <>
struct Pair<__half> {
  __device__ static uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  __device__ static float2 unpack(uint32_t v) {
    return __half22float2(*reinterpret_cast<__half2*>(&v));
  }
};

// (v0, v1) -> hi = T(v), lo = T(v - hi), each packed low element first
template <typename T>
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  hi = Pair<T>::pack(v0, v1);
  const float2 hf = Pair<T>::unpack(hi);
  lo = Pair<T>::pack(__fsub_rn(v0, hf.x), __fsub_rn(v1, hf.y));
}

// exp(x) as 2^(x log2 e) on the MUFU unit (ex2.approx, relative error
// ~2^-22), for the per-element decay of pass 3
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n"
      : "=f"(y)
      : "f"(__fmul_rn(x, 1.4426950408889634f)));
  return y;
}

template <typename T>
constexpr bool kHalf = std::is_same<T, __half>::value;

// float16's split scales.  A float32 operand block is multiplied by 2^-e
// before its split and the product by 2^e after it, both exact in float32.
// e = ilogb(m) - SPLIT_TOP puts the block's largest magnitude m in [2^14,
// 2^15), below float16's 65504; e is clamped to [E_MIN, E_MAX], so 2^e,
// 2^-e and 2^-(e' - e) for any two such e < e' are normal floats.  Pass 3
// raises att's running exponent of a row, when a tile needs a larger one,
// to ATT_SLACK above what that tile needs.
constexpr int SPLIT_TOP = 14;
constexpr int E_MIN = -13;
constexpr int E_MAX = 113;
constexpr int ATT_SLACK = 8;

// 2^e for e in [-126, 127], from its bits
__device__ __forceinline__ float pow2(int e) {
  return __int_as_float((e + 127) << 23);
}

// ilogb(m) - SPLIT_TOP for m >= 0 (zero and subnormals read as 2^-127)
__device__ __forceinline__ int need_exp(float m) {
  return static_cast<int>(__float_as_uint(m) >> 23) - 127 - SPLIT_TOP;
}

__device__ __forceinline__ int split_exp(float m) {
  return min(max(need_exp(m), E_MIN), E_MAX);
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

// two packed float16 pairs -> the packed pair of their larger magnitudes
__device__ __forceinline__ uint32_t habs_max(uint32_t u, uint32_t v) {
  __half2 m = __hmax2(__habs2(*reinterpret_cast<__half2*>(&u)),
                      __habs2(*reinterpret_cast<__half2*>(&v)));
  return *reinterpret_cast<uint32_t*>(&m);
}

// cum[0..Q) = inclusive cumsum of itself, by warp 0: each lane sums Q/32
// consecutive values in order, then a warp scan of the lane totals (the
// order of ssd_scan.cu).
template <int Q>
__device__ __forceinline__ void chunk_cumsum(float* cum, int warp, int lane) {
  if (warp != 0) return;
  constexpr int PER = Q / 32;
  const int s0 = lane * PER;
  float run = 0.0f;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    run = __fadd_rn(run, cum[s0 + k]);
    cum[s0 + k] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl = __fadd_rn(incl, t);
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0f;
#pragma unroll
  for (int k = 0; k < PER; ++k) cum[s0 + k] = __fadd_rn(cum[s0 + k], excl);
}

// cum and dt of rows [row0, row0 + Q) into shared memory; cum scanned.
template <int Q>
__device__ __forceinline__ void load_cum(float* cum, float* dtv,
                                         const float* da, const float* dt,
                                         long long row0, int tid,
                                         int nthreads) {
  for (int i = tid; i < Q; i += nthreads) {
    cum[i] = da[row0 + i];
    dtv[i] = dt[row0 + i];
  }
  __syncthreads();
  chunk_cumsum<Q>(cum, tid >> 5, tid & 31);
  __syncthreads();
}

// ---- pass 1: each chunk's own state -----------------------------------------
template <typename T, int N, int Q>
__global__ void __launch_bounds__(2 * N) ssd_chunk_state_kernel(
    const T* __restrict__ x, const float* __restrict__ da,
    const float* __restrict__ dt, const T* __restrict__ bmat,
    float* __restrict__ states, float* __restrict__ decay, int L, int NC) {
  using Lay = Layout<N, Q>;
  constexpr int NT = Lay::STATE_THREADS;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sb = smem_u32(smem);
  const uint32_t sx = sb + Lay::BC_BYTES;
  float* wv = reinterpret_cast<float*>(smem + Lay::BC_BYTES + Lay::X_BYTES);
  float* cum = wv + Q;
  float* dtv = cum + Q;

  const int c = blockIdx.x % NC;
  const long long bh = blockIdx.x / NC;
  const long long row0 = bh * L + static_cast<long long>(c) * Q;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  load_rows<2 * N>(sb, bmat + row0 * N, Q, tid, NT);
  load_rows<2 * P>(sx, x + row0 * P, Q, tid, NT);
  load_cum<Q>(cum, dtv, da, dt, row0, tid, NT);
  const float last = cum[Q - 1];
  for (int i = tid; i < Q; i += NT)
    wv[i] = __fmul_rn(expf(__fsub_rn(last, cum[i])), dtv[i]);
  if (tid == 0) decay[bh * NC + c] = expf(last);
  cp_async_wait_all();
  __syncthreads();

  // S_c rows [16 warp, 16 warp + 16) = sum_j (B_j w_j)^T x_j over the chunk:
  // A = (B (.) w)^T through ldmatrix.trans of B's rows, B operand = x rows.
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3, rr = lane & 7;
  // float16: the warp's rows of B (.) w split at 2^-e, from their largest
  // magnitude, max over each k pair of the two rows' |B| (exact in T) times
  // |w| (rounding keeps the order, so this is the largest |B_jn w_j|)
  float down = 1.0f, up = 1.0f;
  if constexpr (kHalf<T>) {
    float m = 0.0f;
#pragma unroll 4
    for (int j0 = 0; j0 < Q; j0 += 16) {
      uint32_t a[4];
      ldsm_x4_t(a, sb + swz<2 * N>(j0 + rr + 8 * (mi >> 1), 2 * warp + (mi & 1)));
      const float2 b01 = Pair<T>::unpack(habs_max(a[0], a[1]));
      const float2 b89 = Pair<T>::unpack(habs_max(a[2], a[3]));
      const int k = j0 + 2 * t;
      m = fmaxf(m, fmaxf(__fmul_rn(b01.x, fabsf(wv[k])),
                         __fmul_rn(b01.y, fabsf(wv[k + 1]))));
      m = fmaxf(m, fmaxf(__fmul_rn(b89.x, fabsf(wv[k + 8])),
                         __fmul_rn(b89.y, fabsf(wv[k + 9]))));
    }
    const int e = split_exp(warp_max(m));
    down = pow2(-e);
    up = pow2(e);
  }
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[nt][q] = 0.0f;
#pragma unroll 2
  for (int j0 = 0; j0 < Q; j0 += 16) {
    uint32_t a[4], ahi[4], alo[4];
    ldsm_x4_t(a, sb + swz<2 * N>(j0 + rr + 8 * (mi >> 1), 2 * warp + (mi & 1)));
    // a[0], a[1]: k = j0 + 2t, 2t+1; a[2], a[3]: k = j0 + 2t + 8, 2t + 9
    const float2 w01 = make_float2(wv[j0 + 2 * t], wv[j0 + 2 * t + 1]);
    const float2 w89 = make_float2(wv[j0 + 2 * t + 8], wv[j0 + 2 * t + 9]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 bv = Pair<T>::unpack(a[q]);
      const float2 w = q < 2 ? w01 : w89;
      float v0 = __fmul_rn(bv.x, w.x), v1 = __fmul_rn(bv.y, w.y);
      if constexpr (kHalf<T>) {
        v0 = __fmul_rn(v0, down);
        v1 = __fmul_rn(v1, down);
      }
      split2<T>(v0, v1, ahi[q], alo[q]);
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, sx + swz<2 * P>(j0 + rr + 8 * (mi & 1), 2 * np + (mi >> 1)));
      mma<T>(acc[2 * np], ahi, b[0], b[1]);
      mma<T>(acc[2 * np], alo, b[0], b[1]);
      mma<T>(acc[2 * np + 1], ahi, b[2], b[3]);
      mma<T>(acc[2 * np + 1], alo, b[2], b[3]);
    }
  }
  if constexpr (kHalf<T>) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[nt][q] = __fmul_rn(acc[nt][q], up);
  }
  float* out = states + (bh * NC + c) * static_cast<long long>(N * P);
  const int m0 = 16 * warp + g;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = 8 * nt + 2 * t;
    *reinterpret_cast<float2*>(out + m0 * P + col) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(out + (m0 + 8) * P + col) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
}

// ---- pass 2: the states entering each chunk ---------------------------------
// One thread per 4 consecutive state elements; PASS_BATCH chunks' loads are
// issued before their stores.
__global__ void __launch_bounds__(PASS_THREADS) ssd_state_pass_kernel(
    float* __restrict__ states, const float* __restrict__ decay, int NC,
    int NP) {
  const int per_bh = NP / (4 * PASS_THREADS);
  const long long bh = blockIdx.x / per_bh;
  const int e = ((blockIdx.x % per_bh) * PASS_THREADS + threadIdx.x) * 4;
  float4* s = reinterpret_cast<float4*>(states + bh * NC * NP + e);
  const long long stride = NP / 4;  // float4s between chunks
  const float* dec = decay + bh * NC;
  float4 state = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c0 = 0; c0 < NC; c0 += PASS_BATCH) {
    float4 sc[PASS_BATCH];
    float d[PASS_BATCH];
#pragma unroll
    for (int k = 0; k < PASS_BATCH; ++k) {
      if (c0 + k < NC) {
        sc[k] = s[(c0 + k) * stride];
        d[k] = dec[c0 + k];
      }
    }
#pragma unroll
    for (int k = 0; k < PASS_BATCH; ++k) {
      if (c0 + k < NC) {
        s[(c0 + k) * stride] = state;
        state.x = __fadd_rn(__fmul_rn(d[k], state.x), sc[k].x);
        state.y = __fadd_rn(__fmul_rn(d[k], state.y), sc[k].y);
        state.z = __fadd_rn(__fmul_rn(d[k], state.z), sc[k].z);
        state.w = __fadd_rn(__fmul_rn(d[k], state.w), sc[k].w);
      }
    }
  }
}

// ---- pass 3: y ---------------------------------------------------------------
template <typename T, int N, int Q>
__global__ void __launch_bounds__(OUT_THREADS, 1) ssd_chunk_out_kernel(
    const T* __restrict__ x, const float* __restrict__ da,
    const float* __restrict__ dt, const T* __restrict__ bmat,
    const T* __restrict__ cmat, const float* __restrict__ states,
    float* __restrict__ y, int L, int NC) {
  using Lay = Layout<N, Q>;
  constexpr int MT = Q / 16;  // 16-row tiles of the chunk
  constexpr int KS = N / 16;  // k-steps over the state
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sc = smem_u32(smem);
  const uint32_t sb = sc + Lay::BC_BYTES;
  const uint32_t sx = sb + Lay::BC_BYTES;
  const uint32_t seh = sx + Lay::X_BYTES;
  const uint32_t sel = seh + Lay::E_BYTES;
  uint8_t* eh = smem + 2 * Lay::BC_BYTES + Lay::X_BYTES;
  uint8_t* el = eh + Lay::E_BYTES;
  float* cum = reinterpret_cast<float*>(el + Lay::E_BYTES);
  float* dtv = cum + Q;
  const uint32_t bars = smem_u32(dtv + Q);  // stage s at bars + 8 s

  const int c = blockIdx.x % NC;
  const long long bh = blockIdx.x / NC;
  const long long row0 = bh * L + static_cast<long long>(c) * Q;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) {
    for (int st = 0; st < Lay::STAGES; ++st) mbar_init(bars + 8 * st, OUT_THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // stage 0: all of C and B, x rows [0, 64); stage s: B, x rows [64 s, 64 s + 64)
  load_rows<2 * N>(sc, cmat + row0 * N, Q, tid, OUT_THREADS);
#pragma unroll 1
  for (int st = 0; st < Lay::STAGES; ++st) {
    const int r0 = st * STAGE_ROWS;
    load_rows<2 * N>(sb + r0 * 2 * N, bmat + (row0 + r0) * N, STAGE_ROWS, tid,
                     OUT_THREADS);
    load_rows<2 * P>(sx + r0 * 2 * P, x + (row0 + r0) * P, STAGE_ROWS, tid,
                     OUT_THREADS);
    cp_async_arrive(bars + 8 * st);
  }
  // the entering state (zero for the first chunk), split into T hi/lo;
  // float16 splits it at 2^-e from its largest magnitude (enter_up = 2^e)
  float enter_up = 1.0f;
  if (c > 0) {
    const float4* src = reinterpret_cast<const float4*>(
        states + (bh * NC + c) * static_cast<long long>(N * P));
    constexpr int PER = N * P / 4 / OUT_THREADS;
    float4 vs[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) vs[k] = src[tid + k * OUT_THREADS];
    float down = 1.0f;
    if constexpr (kHalf<T>) {
      __shared__ float warp_top[OUT_WARPS];
      float m = 0.0f;
#pragma unroll
      for (int k = 0; k < PER; ++k)
        m = fmaxf(m, fmaxf(fmaxf(fabsf(vs[k].x), fabsf(vs[k].y)),
                           fmaxf(fabsf(vs[k].z), fabsf(vs[k].w))));
      m = warp_max(m);
      if (lane == 0) warp_top[warp] = m;
      __syncthreads();
#pragma unroll
      for (int k = 0; k < OUT_WARPS; ++k) m = fmaxf(m, warp_top[k]);
      const int e = split_exp(m);
      down = pow2(-e);
      enter_up = pow2(e);
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = tid + k * OUT_THREADS;
      float4 v = vs[k];
      if constexpr (kHalf<T>) {
        v.x = __fmul_rn(v.x, down);
        v.y = __fmul_rn(v.y, down);
        v.z = __fmul_rn(v.z, down);
        v.w = __fmul_rn(v.w, down);
      }
      const int r = 4 * e / P, col = 4 * e % P;
      const uint32_t off = swz<2 * P>(r, col / 8) + (col % 8) * 2;
      uint32_t h0, l0, h1, l1;
      split2<T>(v.x, v.y, h0, l0);
      split2<T>(v.z, v.w, h1, l1);
      *reinterpret_cast<uint2*>(eh + off) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(el + off) = make_uint2(l0, l1);
    }
  }
  load_cum<Q>(cum, dtv, da, dt, row0, tid, OUT_THREADS);

  // each warp waits for a stage when it first reaches it
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3, rr = lane & 7;
  float* yc = y + row0 * P;
  // tiles w and MT-1-w when there are two per warp, else tile w
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    const int mt = pass == 0 ? warp : MT - 1 - warp;
    if (mt >= MT || (pass == 1 && MT <= OUT_WARPS)) break;
    const int i0 = 16 * mt;
    mbar_wait(bars, 0);
    uint32_t cf[KS][4];  // C rows [i0, i0 + 16) as A fragments
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      ldsm_x4(cf[ks], sc + swz<2 * N>(i0 + (lane & 15), 2 * ks + (lane >> 4)));
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[nt][q] = 0.0f;
    const float cum0 = cum[i0 + g], cum1 = cum[i0 + g + 8];
    // bf16: the carried state first, exp(cum_i) * (C_i @ enter)
    if constexpr (!kHalf<T>) {
      if (c > 0) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int r = 16 * ks + rr + 8 * (mi & 1);
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            const uint32_t off = swz<2 * P>(r, 2 * np + (mi >> 1));
            uint32_t bh4[4], bl4[4];
            ldsm_x4_t(bh4, seh + off);
            ldsm_x4_t(bl4, sel + off);
            mma<T>(acc[2 * np], cf[ks], bh4[0], bh4[1]);
            mma<T>(acc[2 * np], cf[ks], bl4[0], bl4[1]);
            mma<T>(acc[2 * np + 1], cf[ks], bh4[2], bh4[3]);
            mma<T>(acc[2 * np + 1], cf[ks], bl4[2], bl4[3]);
          }
        }
        const float e0 = expf(cum0), e1 = expf(cum1);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          acc[nt][0] = __fmul_rn(e0, acc[nt][0]);
          acc[nt][1] = __fmul_rn(e0, acc[nt][1]);
          acc[nt][2] = __fmul_rn(e1, acc[nt][2]);
          acc[nt][3] = __fmul_rn(e1, acc[nt][3]);
        }
      }
    }
    // float16: rows g and g + 8 of acc hold y's att terms times 2^-r0 and
    // 2^-r1, att's running exponents
    int r0 = E_MIN, r1 = E_MIN;
    // the lower-triangular column tiles: y_i += sum_j att[i,j] x_j
#pragma unroll 2
    for (int j0 = 0; j0 <= i0; j0 += 16) {
      if (j0 % STAGE_ROWS == 0) mbar_wait(bars + 8 * (j0 / STAGE_ROWS), 0);
      // S = C B^T over the 16 columns, even and odd k-steps in separate
      // accumulators (four independent mma chains)
      float s[2][4], s_odd[2][4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        s[0][q] = s[1][q] = s_odd[0][q] = s_odd[1][q] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t b[4];
        ldsm_x4(b, sb + swz<2 * N>(j0 + rr + 8 * (mi >> 1), 2 * ks + (mi & 1)));
        float(&d0)[4] = ks % 2 ? s_odd[0] : s[0];
        float(&d1)[4] = ks % 2 ? s_odd[1] : s[1];
        mma<T>(d0, cf[ks], b[0], b[1]);
        mma<T>(d1, cf[ks], b[2], b[3]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        s[0][q] = __fadd_rn(s[0][q], s_odd[0][q]);
        s[1][q] = __fadd_rn(s[1][q], s_odd[1][q]);
      }
      // att in registers: element q of n-tile nt is row i0 + g + 8 (q / 2),
      // column j0 + 8 nt + 2t + q % 2
      uint32_t ahi[4], alo[4];
      if constexpr (!kHalf<T>) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          float v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = i0 + g + 8 * (q >> 1);
            const int j = j0 + 8 * nt + 2 * t + (q & 1);
            v[q] = 0.0f;
            if (j <= i)
              v[q] = __fmul_rn(
                  __fmul_rn(s[nt][q],
                            exp_approx(__fsub_rn(q < 2 ? cum0 : cum1, cum[j]))),
                  dtv[j]);
          }
          // A fragment of att: a0 (row g, k 2t), a1 (row g+8, k 2t),
          // a2 (row g, k 2t+8), a3 (row g+8, k 2t+8)
          split2<T>(v[0], v[1], ahi[2 * nt], alo[2 * nt]);
          split2<T>(v[2], v[3], ahi[2 * nt + 1], alo[2 * nt + 1]);
        }
      } else {
        // float16: the whole tile first, then its rows' scales
        float v[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = i0 + g + 8 * (q >> 1);
            const int j = j0 + 8 * nt + 2 * t + (q & 1);
            v[nt][q] = 0.0f;
            if (j <= i)
              v[nt][q] = __fmul_rn(
                  __fmul_rn(s[nt][q],
                            exp_approx(__fsub_rn(q < 2 ? cum0 : cum1, cum[j]))),
                  dtv[j]);
          }
        // the tile's largest |att| in rows g and g + 8, over the lane quad
        float m0 = fmaxf(fmaxf(fabsf(v[0][0]), fabsf(v[0][1])),
                         fmaxf(fabsf(v[1][0]), fabsf(v[1][1])));
        float m1 = fmaxf(fmaxf(fabsf(v[0][2]), fabsf(v[0][3])),
                         fmaxf(fabsf(v[1][2]), fabsf(v[1][3])));
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
          m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
        }
        const int need0 = need_exp(m0), need1 = need_exp(m1);
        if (__any_sync(0xffffffffu, need0 > r0 || need1 > r1)) {
          // a larger exponent: acc's rows rescaled by 2^-(raise), exact
          const int n0 = need0 > r0 ? min(need0 + ATT_SLACK, E_MAX) : r0;
          const int n1 = need1 > r1 ? min(need1 + ATT_SLACK, E_MAX) : r1;
          const float f0 = pow2(r0 - n0), f1 = pow2(r1 - n1);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            acc[nt][0] = __fmul_rn(acc[nt][0], f0);
            acc[nt][1] = __fmul_rn(acc[nt][1], f0);
            acc[nt][2] = __fmul_rn(acc[nt][2], f1);
            acc[nt][3] = __fmul_rn(acc[nt][3], f1);
          }
          r0 = n0;
          r1 = n1;
        }
        const float d0 = pow2(-r0), d1 = pow2(-r1);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          split2<T>(__fmul_rn(v[nt][0], d0), __fmul_rn(v[nt][1], d0),
                    ahi[2 * nt], alo[2 * nt]);
          split2<T>(__fmul_rn(v[nt][2], d1), __fmul_rn(v[nt][3], d1),
                    ahi[2 * nt + 1], alo[2 * nt + 1]);
        }
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, sx + swz<2 * P>(j0 + rr + 8 * (mi & 1), 2 * np + (mi >> 1)));
        mma<T>(acc[2 * np], ahi, b[0], b[1]);
        mma<T>(acc[2 * np], alo, b[0], b[1]);
        mma<T>(acc[2 * np + 1], ahi, b[2], b[3]);
        mma<T>(acc[2 * np + 1], alo, b[2], b[3]);
      }
    }
    // float16: y = 2^r (acc) + exp(cum_i) (2^e (C_i @ enter split at 2^-e)),
    // the state term last, as the reference's kernel adds it
    if constexpr (kHalf<T>) {
      const float u0 = pow2(r0), u1 = pow2(r1);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[nt][0] = __fmul_rn(acc[nt][0], u0);
        acc[nt][1] = __fmul_rn(acc[nt][1], u0);
        acc[nt][2] = __fmul_rn(acc[nt][2], u1);
        acc[nt][3] = __fmul_rn(acc[nt][3], u1);
      }
      if (c > 0) {
        float st[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) st[nt][q] = 0.0f;
        // C_i @ enter, as the bf16 build's state term above, into st
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int r = 16 * ks + rr + 8 * (mi & 1);
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            const uint32_t off = swz<2 * P>(r, 2 * np + (mi >> 1));
            uint32_t bh4[4], bl4[4];
            ldsm_x4_t(bh4, seh + off);
            ldsm_x4_t(bl4, sel + off);
            mma<T>(st[2 * np], cf[ks], bh4[0], bh4[1]);
            mma<T>(st[2 * np], cf[ks], bl4[0], bl4[1]);
            mma<T>(st[2 * np + 1], cf[ks], bh4[2], bh4[3]);
            mma<T>(st[2 * np + 1], cf[ks], bl4[2], bl4[3]);
          }
        }
        const float e0 = expf(cum0), e1 = expf(cum1);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[nt][q] = __fadd_rn(
                acc[nt][q],
                __fmul_rn(q < 2 ? e0 : e1, __fmul_rn(st[nt][q], enter_up)));
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = 8 * nt + 2 * t;
      *reinterpret_cast<float2*>(yc + (i0 + g) * P + col) =
          make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(yc + (i0 + g + 8) * P + col) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
  }
  cp_async_wait_all();  // a warp with no tile still waits for its copies
}

template <typename T, int N, int Q>
int launch(const void* x, const void* da, const void* dt, const void* bmat,
           const void* cmat, void* y, void* states, void* decay, int bh,
           int L, cudaStream_t stream) {
  using Lay = Layout<N, Q>;
  const int NC = L / Q;
  auto k1 = ssd_chunk_state_kernel<T, N, Q>;
  auto k3 = ssd_chunk_out_kernel<T, N, Q>;
  cudaError_t err = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::STATE_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        k3, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::OUT_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* xb = static_cast<const T*>(x);
  const auto* bb = static_cast<const T*>(bmat);
  const auto* cb = static_cast<const T*>(cmat);
  const auto* daf = static_cast<const float*>(da);
  const auto* dtf = static_cast<const float*>(dt);
  auto* st = static_cast<float*>(states);
  auto* dec = static_cast<float*>(decay);
  const int chunks = bh * NC;
  k1<<<chunks, Lay::STATE_THREADS, Lay::STATE_SMEM, stream>>>(
      xb, daf, dtf, bb, st, dec, L, NC);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_state_pass_kernel<<<bh * (N * P / (4 * PASS_THREADS)), PASS_THREADS,
                          0, stream>>>(st, dec, NC, N * P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k3<<<chunks, OUT_THREADS, Lay::OUT_SMEM, stream>>>(
      xb, daf, dtf, bb, cb, st, static_cast<float*>(y), L, NC);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int N>
int launch_q(const void* x, const void* da, const void* dt, const void* bmat,
             const void* cmat, void* y, void* states, void* decay, int bh,
             int L, int chunk, cudaStream_t stream) {
  switch (chunk) {
    case 64:
      return launch<T, N, 64>(x, da, dt, bmat, cmat, y, states, decay, bh, L,
                              stream);
    case 128:
      return launch<T, N, 128>(x, da, dt, bmat, cmat, y, states, decay, bh,
                               L, stream);
    case 256:
      return launch<T, N, 256>(x, da, dt, bmat, cmat, y, states, decay, bh,
                               L, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_n(const void* x, const void* da, const void* dt, const void* bmat,
             const void* cmat, void* y, void* states, void* decay, int bh,
             int L, int N, int chunk, cudaStream_t stream) {
  if (N == 64)
    return launch_q<T, 64>(x, da, dt, bmat, cmat, y, states, decay, bh, L,
                           chunk, stream);
  if (N == 128)
    return launch_q<T, 128>(x, da, dt, bmat, cmat, y, states, decay, bh, L,
                            chunk, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Head-major x (BH, L, 64), B and C (BH, L, N) in bf16 (is_half 0) or
// float16 (is_half 1), float32 da and dt (BH, L), y (BH, L, 64) float32;
// scratch `states` (BH, L/chunk, N, 64) and `decay` (BH, L/chunk) float32.
// N in {64, 128}, chunk in {64, 128, 256}, L % chunk == 0; x, B and C
// 16-byte aligned (cp.async).
extern "C" int ssd_scan_mma_launch(const void* x, const void* da,
                                   const void* dt, const void* bmat,
                                   const void* cmat, void* y, void* states,
                                   void* decay, int bh, int L, int P_, int N,
                                   int chunk, int is_half, void* stream) {
  if (bh <= 0 || L <= 0) return 0;
  if (P_ != P || chunk <= 0 || L % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_half)
    return launch_n<__half>(x, da, dt, bmat, cmat, y, states, decay, bh, L,
                            N, chunk, s);
  return launch_n<__nv_bfloat16>(x, da, dt, bmat, cmat, y, states, decay, bh,
                                 L, N, chunk, s);
}
