// Mamba-2 chunked SSD scan on Hopper's tensor cores (sm_90a), chunk-parallel,
// in split TF32: the route `mma_tf32` of repro_torch/kernels/ssd/ops.py,
// every call the bf16 build (ssd_scan_mma.cu, `mma_bf16`) does not take:
// float32, and bf16 or float16 at any other shape or base.
//
// Replaces the TPU kernel repro/kernels/ssd/kernel.py:74 `ssd_scan` (body
// `_kernel`).  Per (b, h) and per chunk of Q rows, with cum = cumsum(da):
//   att[i,j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j      for j <= i
//   y_i      = exp(cum_i) * (C_i @ state) + sum_j att[i,j] x_j
//   state    = exp(cum_Q) * state + sum_j B_j^T exp(cum_Q - cum_j) dt_j x_j
// with the (N, P) float32 state carried from chunk to chunk.  Its plain
// version is repro_torch/kernels/ssd/ref.py `ssd_scan_ref`.
//
// What bounds it: operations.  Float32 products take three or four TF32
// products each (below), so the least time is the work at a third of TF32's
// 495 TFLOP/s (0.26 ms at mamba2-370m's float32 layer, B=4, L=4096, H=32,
// P=64, N=128, chunk 256); 16-bit inputs, exact in TF32, are bounded by
// their bytes.
//
// Design.  The TPU kernel carries the state through its sequential grid;
// blocks on Hopper run in no order, so the scan is split the way the SSD
// paper's GPU algorithm splits it (arXiv:2405.21060 §6), in three launches
// on the caller's stream, over a float32 scratch the wrapper allocates
// (ssd_scan_scratch_floats: the (BH, L/Q, N, P) chunk states, the (BH,
// L/Q) decays exp(cum_Q) and the (BH, L) cumsums):
//  1. chunk states: one CTA per (b, h, chunk, 64 state rows, slab of 64
//     head channels) computes cum (every CTA of a chunk the same way), w_j =
//     exp(cum_Q - cum_j) dt_j, and S_c = (B (.) w)^T x over the chunk's rows
//     in k-tiles of 64; the chunk's first CTA writes cum and exp(cum_Q).
//  2. state pass: float32 on the CUDA cores, one thread per state element,
//     in order over the chunks and in place: enter[c] = state; state =
//     exp(cum_Q[c]) state + S_c (8 chunks' loads in flight).
//  3. output: one CTA per (b, h, chunk, 64-row block, slab), heaviest row
//     blocks first: y = exp(cum_i) (C_i @ enter[c]) over N in k-tiles of 64,
//     then for each 64-column block j <= i in order, S = C B^T over N in
//     k-tiles, att = (S exp(cum_i - cum_j)) dt_j in registers, y += att x.
// Every product is mma.sync m16n8k8 on TF32 operands.  Each CTA is four
// warps of 16 rows by 64 columns; the tiles (k-tiles of B, C and the
// entering state, the x rows of a column block, the block's cum and dt)
// stream through two stages of shared memory by cp.async, the next stage's
// copies in flight during this stage's products, so any N runs with the
// same shared memory (107 KB in float32 for pass 3, two CTAs an SM) and no
// second kernel.  S's accumulator fragment is att's A fragment with the
// chunk rows of each k-step permuted (A's column t is row 2t, column t + 4
// row 2t + 1; x is read at the same rows), so att never leaves registers;
// C B^T and C @ enter take d_state in the same order, so a lane loads its
// two C (and B) elements of a k-step as one pair.  Each k-step issues each
// kind of product over all eight 8-column tiles before the next kind, and
// forms every tile with no branch (a tile past the head channels or the
// diagonal multiplies staged zeros or att's masked entries): branches cost
// more than those products.  Tiles stay in the input's own type, each row
// padded so that the fragment loads hit distinct banks (rows 4 or 8 words
// past a multiple of 32, by how a tile is read).  Each tensor is copied
// with the widest cp.async (16, 8 or 4 bytes) its base and row bytes allow;
// a 16-bit tensor at a 2-byte aligned base is read as the aligned 4-byte
// words under each 8 elements and realigned with byte permutes, never
// reading a word that holds no element of the row.  d_state and the
// chunk's rows are padded in shared memory with zeros to the k-step (8);
// pad rows of the state update weigh w = 0.  Head_dim runs in slabs of 64
// channels, one CTA each; an output column reads only its own columns of x
// and of the state, and every column does the same adds in the same order
// whatever P is.
//
// Numerics.  Each float32 operand v of a product is split at fragment load
// into big = tf32(v) and small = tf32(v - big), tf32 being cvt.rna.tf32's
// rounding (to nearest, ties away from zero); bf16 and float16 x, B and C
// are exact in TF32 and are not split.  Per k-step of 8: C B^T, C @ enter
// and (B (.) w)^T x add small*big, then big*small (the terms with a small
// part, into an accumulator of their own) and big*big; att x also adds
// small*small first (where x is float32).  Each block of 64 k (N, or the
// chunk's rows) is summed from zero in the tensor cores, whose sums
// truncate, and added to the running float32 sum as (big + small) with
// rounded adds, so no long truncating chain runs.  The scalar math keeps
// the CUDA-core kernel's rounding, each operation alone (built with
// --fmad=false, which mma does not feel): cum is a per-lane sequential sum
// plus a warp scan in float64, rounded once; exp(cum_i - cum_j) is the
// accurate expf, taken only for j <= i by a select; att = (S decay) dt_j;
// the state pass's multiply and add.  tests/test_torch_cuda.py holds this
// arithmetic's plain model (_ssd_tf32_numerics), which the CPU tests hold
// to the TPU kernel and the card tests hold this kernel to.
//
// Sizes: any head_dim and d_state >= 1, any base, and a chunk up to 39,680
// rows (pass 1 keeps the chunk's weights in shared memory beside its
// tiles); beyond that, device memory: the inputs, y and the scratch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 128;      // four warps of 16 rows
constexpr int TILE = 64;          // rows of a block, columns of a k-tile or slab
constexpr int PASS_THREADS = 256; // pass 2
constexpr int PASS_BATCH = 8;     // pass 2: chunks loaded at once
constexpr int MAX_SMEM = 232448;  // the opt-in shared memory of a block
constexpr long long MAX_GRID = 0x7fffffffLL;

template <typename T>
constexpr bool kF32 = std::is_same<T, float>::value;

// Bytes of a shared row of 64 elements of `elt` bytes: a multiple of 16
// whose 4-byte words are r (4 or 8) past a multiple of 32.
__host__ __device__ constexpr int pitch(int elt, int r) {
  return ((TILE * elt / 4 + 32 - r) / 32 * 32 + r) * 4;
}

// Shared memory of pass 1 (B and x tiles in two stages, the chunk's
// weights) and of pass 3 (per stage: C, B or the entering state, x, and the
// column block's cum and dt).  Pass 3 reads C and B along their rows in
// pairs (64 bits in float32: rows 8 words past a multiple of 32; 32 bits
// in 16 bits: 4), x and the entering state across their rows (4).
template <typename T>
struct Smem {
  static constexpr int LD1 = pitch(sizeof(T), 8);
  static constexpr int TILE1 = TILE * LD1;
  static constexpr int LDC = kF32<T> ? pitch(4, 8) : pitch(sizeof(T), 4);
  static constexpr int LDX = pitch(sizeof(T), 4);
  static constexpr int LDE = pitch(4, 4);
  static constexpr int TILEC = TILE * LDC;
  static constexpr int TILEX = TILE * LDX;
  static constexpr int SLOT = TILEC > TILE * LDE ? TILEC : TILE * LDE;
  static constexpr int STAGE3 = TILEC + SLOT + TILEX + 2 * TILE * 4;
  static constexpr int PASS3 = 2 * STAGE3;
  static int pass1(int q) { return 4 * TILE1 + 4 * ((q + TILE - 1) / TILE * TILE); }
};

// the bytes of one cp.async of each tensor (16, 8 or 4, or 2: 16-bit
// elements realigned in registers)
struct Vecs {
  int x, b, c, e;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool valid) {
  const int n = valid ? BYTES : 0;  // 0: fill with zeros, read nothing
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(BYTES), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Elements [0, n) of the 8 16-bit elements at the 2-byte aligned p (zeros
// from n on; n <= 0: all zeros) as 16 bytes at shared dst.  The aligned
// 4-byte words under them are loaded and realigned with byte permutes; a
// word holding no element < n is never read.
__device__ __forceinline__ void realign16(uint32_t dst, const void* p, int n) {
  uint32_t out[4] = {0u, 0u, 0u, 0u};
  if (n > 0) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    const uint32_t* w =
        reinterpret_cast<const uint32_t*>(a & ~static_cast<uintptr_t>(3));
    if ((a & 3) == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)  // word i: elements 2i, 2i + 1
        if (2 * i < n) out[i] = w[i];
    } else {
      uint32_t x[5];
#pragma unroll
      for (int i = 0; i < 5; ++i)  // word i: elements 2i - 1 (low), 2i
        x[i] = 2 * i - 1 < n ? w[i] : 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) out[i] = __byte_perm(x[i], x[i + 1], 0x5432);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (2 * i >= n)
        out[i] = 0u;
      else if (2 * i + 1 >= n)
        out[i] &= 0xffffu;
    }
  }
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(out[0]), "r"(out[1]), "r"(out[2]), "r"(out[3])
               : "memory");
}

// Rows [row0, row0 + 64) of a matrix whose row r starts at src + r * stride
// (elements), columns [0, 64), to shared memory at dst, `ld` bytes a row:
// rows < rows and columns < valid from memory, the rest zeros.  VEC is the
// bytes of one cp.async (the base, the row bytes and valid's bytes are
// multiples of it), or 2: 8 elements a thread realigned in registers
// (visible after the next barrier, like the copies after their wait).
template <typename T, int VEC>
__device__ __forceinline__ void stage_vec(uint32_t dst, int ld, const T* src,
                                          long long stride, int row0, int rows,
                                          int valid) {
  constexpr int UNIT = VEC == 2 ? 16 : VEC;  // shared bytes a step
  constexpr int E = UNIT / static_cast<int>(sizeof(T));
  constexpr int CPR = TILE / E;  // steps a row
  for (int idx = threadIdx.x; idx < TILE * CPR; idx += THREADS) {
    const int r = idx / CPR, c = idx % CPR;
    const int gr = row0 + r, col = c * E;
    const uint32_t d = dst + r * ld + c * UNIT;
    const T* s = src + static_cast<long long>(gr) * stride + col;
    if constexpr (VEC == 2) {
      realign16(d, s, gr < rows ? valid - col : 0);
    } else {
      const bool ok = gr < rows && col < valid;
      cp_async<VEC>(d, ok ? s : src, ok);
    }
  }
}

template <typename T>
__device__ __forceinline__ void stage(int vec, uint32_t dst, int ld,
                                      const T* src, long long stride, int row0,
                                      int rows, int valid) {
  switch (vec) {
    case 16:
      stage_vec<T, 16>(dst, ld, src, stride, row0, rows, valid);
      break;
    case 8:
      stage_vec<T, 8>(dst, ld, src, stride, row0, rows, valid);
      break;
    case 4:
      stage_vec<T, 4>(dst, ld, src, stride, row0, rows, valid);
      break;
    default:
      if constexpr (!kF32<T>)
        stage_vec<T, 2>(dst, ld, src, stride, row0, rows, valid);
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

// element (r, c) of a shared tile of T with rows of ld bytes, as float32
template <typename T>
__device__ __forceinline__ float at(const uint8_t* tile, int ld, int r, int c) {
  return to_float(*reinterpret_cast<const T*>(tile + r * ld + c * sizeof(T)));
}

// elements (r, c) and (r, c + 1), c even, in one load
template <typename T>
__device__ __forceinline__ float2 at2(const uint8_t* tile, int ld, int r,
                                      int c) {
  const uint8_t* p = tile + r * ld + c * sizeof(T);
  if constexpr (kF32<T>)
    return *reinterpret_cast<const float2*>(p);
  else if constexpr (std::is_same<T, __half>::value)
    return __half22float2(*reinterpret_cast<const __half2*>(p));
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// D (16 x 8, float32) += A (16 x 8) B (8 x 8), TF32 operands (not
// volatile: the compiler may interleave independent products)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// cvt.rna.tf32.f32 on a finite float32's bits: to TF32's 10 mantissa bits,
// to nearest, ties away from zero (every operand here is finite)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// v = big + small (to ~2^-22 of v), each a TF32 value; unsplit (SPLIT
// false: a 16-bit input, exact in TF32), big = v and small unused
template <bool SPLIT>
__device__ __forceinline__ void split(float v, uint32_t& big, uint32_t& small) {
  if constexpr (SPLIT) {
    big = tf32(v);
    small = tf32(__fsub_rn(v, __uint_as_float(big)));
  } else {
    big = __float_as_uint(v);
  }
}

// One k-step of the split product over the eight 8-column tiles, into
// (big, small): small += the terms with a small part (small*small where
// FOUR, then small*big, then big*small, as far as the operands are split),
// big += big*big.  (ab, as): A's fragment; bv[nt]: B's two elements of
// tile nt, split here if SB.  Each kind of product runs over every tile
// before the next kind, so one accumulator's successive products are 8
// apart and need not wait on each other.  Every tile is formed, whatever
// its columns hold: a tile past the slab's head channels or the diagonal
// multiplies zeros (staged, or att's masked entries) and adds exact zeros,
// and a branch around it would cost more than its products (it keeps the
// scheduler from overlapping the loads, splits and products).
template <bool SA, bool SB, bool FOUR>
__device__ __forceinline__ void products(float (&big)[8][4],
                                         float (&small)[8][4],
                                         const uint32_t (&ab)[4],
                                         const uint32_t (&as)[4],
                                         const float (&bv)[8][2]) {
  uint32_t bb[8][2], bs[8][2];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    split<SB>(bv[nt][0], bb[nt][0], bs[nt][0]);
    split<SB>(bv[nt][1], bb[nt][1], bs[nt][1]);
  }
  if constexpr (SA && SB && FOUR) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) mma_tf32(small[nt], as, bs[nt][0], bs[nt][1]);
  }
  if constexpr (SA) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) mma_tf32(small[nt], as, bb[nt][0], bb[nt][1]);
  }
  if constexpr (SB) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) mma_tf32(small[nt], ab, bs[nt][0], bs[nt][1]);
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) mma_tf32(big[nt], ab, bb[nt][0], bb[nt][1]);
}

template <int NT>
__device__ __forceinline__ void zero(float (&a)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) a[i][q] = 0.0f;
}

// run += (big + small), element by element, each add rounded
__device__ __forceinline__ void add_block(float (&run)[8][4],
                                          const float (&big)[8][4],
                                          const float (&small)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      run[i][q] = __fadd_rn(run[i][q], __fadd_rn(big[i][q], small[i][q]));
}

// cum[0..Q) = the inclusive cumsum of da[0..Q) (global), by the whole CTA,
// synchronised after: each lane of warp 0 sums ceil(Q/32) consecutive values
// in order, then a warp scan of the lane totals, accumulated in float64 and
// rounded once (a float32 running sum is off by up to ulp(|cum|), which
// exp(cum_i - cum_j) turns into a relative error of the whole att row).
__device__ __forceinline__ void chunk_cum(float* cum, const float* da, int Q) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < Q; i += THREADS) cum[i] = da[i];
  __syncthreads();
  if (warp == 0) {
    const int per = (Q + 31) / 32;
    const int s0 = lane * per;
    double run = 0.0;
    for (int k = 0; k < per; ++k) {
      const int i = s0 + k;
      if (i < Q) run += static_cast<double>(cum[i]);
    }
    double incl = run;
    for (int off = 1; off < 32; off <<= 1) {
      const double t = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += t;
    }
    double excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.0;
    for (int k = 0; k < per; ++k) {
      const int i = s0 + k;
      if (i < Q) {
        excl += static_cast<double>(cum[i]);
        cum[i] = static_cast<float>(excl);
      }
    }
  }
  __syncthreads();
}

// ---- pass 1: each chunk's own state -----------------------------------------
// S_c[n0 + m, p0 + p] = sum_j (B_j,n w_j) x_j,p: A = (B (.) w)^T read across
// the B tile's rows, B = the x tile; blockIdx.x = (slab fastest, state-row
// tile, chunk, b*h).
template <typename T>
__global__ void __launch_bounds__(THREADS, 2) ssd_chunk_state_kernel(
    const T* __restrict__ x, const float* __restrict__ da,
    const float* __restrict__ dt, const T* __restrict__ bmat,
    float* __restrict__ states, float* __restrict__ decay,
    float* __restrict__ cums, int L, int P, int N, int Q, Vecs vec) {
  using S = Smem<T>;
  constexpr bool F32 = kF32<T>;
  constexpr int LD = S::LD1;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t s0 = smem_u32(smem);
  float* w = reinterpret_cast<float*>(smem + 4 * S::TILE1);  // cum, then w

  const int slabs = (P + TILE - 1) / TILE, ntiles = (N + TILE - 1) / TILE;
  const int NC = L / Q;
  long long id = blockIdx.x;
  const int slab = static_cast<int>(id % slabs);
  id /= slabs;
  const int ntile = static_cast<int>(id % ntiles);
  id /= ntiles;
  const int c = static_cast<int>(id % NC);
  const long long bh = id / NC;
  const int p0 = slab * TILE, n0 = ntile * TILE;
  const long long row0 = bh * L + static_cast<long long>(c) * Q;
  const T* xc = x + row0 * P + p0;
  const T* bc = bmat + row0 * N + n0;
  const int KT = (Q + TILE - 1) / TILE;  // k-tiles of the chunk's rows
  const int tid = threadIdx.x;

  auto stage_kt = [&](int kt, int st) {
    const uint32_t d = s0 + st * 2 * S::TILE1;
    stage<T>(vec.b, d, LD, bc, N, kt * TILE, Q, N - n0);
    stage<T>(vec.x, d + S::TILE1, LD, xc, P, kt * TILE, Q, P - p0);
    cp_commit();
  };
  stage_kt(0, 0);

  chunk_cum(w, da + row0, Q);
  const float last = w[Q - 1];
  if (slab == 0 && ntile == 0) {
    for (int i = tid; i < Q; i += THREADS) cums[row0 + i] = w[i];
    if (tid == 0) decay[bh * NC + c] = expf(last);
  }
  __syncthreads();  // every thread has read cum_Q
  // w_j = exp(cum_Q - cum_j) dt_j, zero on the pad rows
  for (int i = tid; i < KT * TILE; i += THREADS)
    w[i] = i < Q ? __fmul_rn(expf(__fsub_rn(last, w[i])), dt[row0 + i]) : 0.0f;

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int m0 = 16 * warp;  // the warp's state rows in the tile
  const bool idle = n0 + m0 >= N;
  float run[8][4];
  zero(run);
  for (int kt = 0; kt < KT; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < KT) {
      stage_kt(kt + 1, st ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (!idle) {
      const uint8_t* bt = smem + st * 2 * S::TILE1;
      const uint8_t* xt = bt + S::TILE1;
      const float* wk = w + kt * TILE;
      const int steps = min(8, (Q - kt * TILE + 7) / 8);
      float big[8][4], small[8][4];
      zero(big);
      zero(small);
      for (int ks = 0; ks < steps; ++ks) {
        const int k = 8 * ks + t;  // rows k and k + 4 of the tile
        const float w0 = wk[k], w1 = wk[k + 4];
        // a0 (state row g, chunk row k), a1 (g + 8, k), a2 (g, k + 4),
        // a3 (g + 8, k + 4)
        const float av[4] = {__fmul_rn(at<T>(bt, LD, k, m0 + g), w0),
                             __fmul_rn(at<T>(bt, LD, k, m0 + g + 8), w0),
                             __fmul_rn(at<T>(bt, LD, k + 4, m0 + g), w1),
                             __fmul_rn(at<T>(bt, LD, k + 4, m0 + g + 8), w1)};
        uint32_t ab[4], as[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split<true>(av[i], ab[i], as[i]);
        float bv[8][2];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          bv[nt][0] = at<T>(xt, LD, k, 8 * nt + g);
          bv[nt][1] = at<T>(xt, LD, k + 4, 8 * nt + g);
        }
        products<true, F32, false>(big, small, ab, as, bv);
      }
      add_block(run, big, small);
    }
    __syncthreads();  // stage st consumed before the next copies into it
  }
  if (idle) return;
  float* out = states + (bh * NC + c) * static_cast<long long>(N) * P;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + m0 + g + 8 * h;
    if (n >= N) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int p = p0 + 8 * nt + 2 * t;
      float* o = out + static_cast<long long>(n) * P + p;
      if (p < P) o[0] = run[nt][2 * h];
      if (p + 1 < P) o[1] = run[nt][2 * h + 1];
    }
  }
}

// ---- pass 2: the states entering each chunk ---------------------------------
__global__ void __launch_bounds__(PASS_THREADS) ssd_state_pass_kernel(
    float* __restrict__ states, const float* __restrict__ decay,
    long long total, int NC, long long NP) {
  const long long e = static_cast<long long>(blockIdx.x) * PASS_THREADS +
                      threadIdx.x;
  if (e >= total) return;
  const long long bh = e / NP;
  float* s = states + bh * NC * NP + e % NP;
  const float* dec = decay + bh * NC;
  float state = 0.0f;
  for (int c0 = 0; c0 < NC; c0 += PASS_BATCH) {
    float sc[PASS_BATCH], d[PASS_BATCH];
#pragma unroll
    for (int k = 0; k < PASS_BATCH; ++k) {
      if (c0 + k < NC) {
        sc[k] = s[(c0 + k) * NP];
        d[k] = dec[c0 + k];
      }
    }
#pragma unroll
    for (int k = 0; k < PASS_BATCH; ++k) {
      if (c0 + k < NC) {
        s[(c0 + k) * NP] = state;
        state = __fadd_rn(__fmul_rn(d[k], state), sc[k]);
      }
    }
  }
}

// ---- pass 3: y ---------------------------------------------------------------
// blockIdx.x = (slab fastest, chunk and b*h, row block heaviest first).  The
// CTA's jobs, in order, each one stage of tiles: the state term's k-tiles
// of N (chunks after the first), then for each column block jb <= rb the
// scores' k-tiles of N, x and the block's cum and dt riding the last.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2) ssd_chunk_out_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const T* __restrict__ bmat, const T* __restrict__ cmat,
    const float* __restrict__ states, const float* __restrict__ cums,
    float* __restrict__ y, int BH, int L, int P, int N, int Q, Vecs vec) {
  using S = Smem<T>;
  constexpr bool F32 = kF32<T>;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t s0 = smem_u32(smem);

  const int slabs = (P + TILE - 1) / TILE, NC = L / Q;
  const int RB = (Q + TILE - 1) / TILE;
  long long id = blockIdx.x;
  const int slab = static_cast<int>(id % slabs);
  id /= slabs;
  const long long chunks = static_cast<long long>(BH) * NC;
  const long long bhc = id % chunks;
  const int rb = RB - 1 - static_cast<int>(id / chunks);
  const int c = static_cast<int>(bhc % NC);
  const long long bh = bhc / NC;
  const int i0 = rb * TILE, p0 = slab * TILE;
  const long long row0 = bh * L + static_cast<long long>(c) * Q;
  const T* cc = cmat + row0 * N;
  const T* bc = bmat + row0 * N;
  const T* xc = x + row0 * P + p0;
  const float* enter = states + (bh * NC + c) * static_cast<long long>(N) * P + p0;
  const int NKT = (N + TILE - 1) / TILE;  // k-tiles of N
  const int first = c > 0 ? NKT : 0;      // the state term's jobs
  const int jobs = first + (rb + 1) * NKT;
  const int tid = threadIdx.x;

  auto stage_job = [&](int job, int st) {
    const uint32_t d = s0 + st * S::STAGE3;
    const bool state = job < first;
    const int r = job - first;
    const int kt = state ? job : r % NKT, jb = r / NKT;
    stage<T>(vec.c, d, S::LDC, cc + kt * TILE, N, i0, Q, N - kt * TILE);
    if (state) {
      stage<float>(vec.e, d + S::TILEC, S::LDE,
                   enter + static_cast<long long>(kt) * TILE * P, P, 0,
                   N - kt * TILE, P - p0);
    } else {
      stage<T>(vec.b, d + S::TILEC, S::LDC, bc + kt * TILE, N, jb * TILE, Q,
               N - kt * TILE);
      if (kt == NKT - 1) {
        stage<T>(vec.x, d + S::TILEC + S::SLOT, S::LDX, xc, P, jb * TILE, Q,
                 P - p0);
        // the block's cum (threads 0-63) and dt (64-127), zeros past Q
        const int j = jb * TILE + (tid & 63);
        const float* src = (tid < 64 ? cums : dt) + row0 + j;
        cp_async<4>(d + S::TILEC + S::SLOT + S::TILEX + 4 * tid,
                    j < Q ? src : dt, j < Q);
      }
    }
    cp_commit();
  };
  stage_job(0, 0);

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int m0 = 16 * warp;  // the warp's rows in the block
  const bool idle = i0 + m0 >= Q;
  const int ia = i0 + m0 + g, ib = ia + 8;   // this lane's two rows
  const float cum_a = cums[row0 + min(ia, Q - 1)];
  const float cum_b = cums[row0 + min(ib, Q - 1)];
  float yacc[8][4], sacc[8][4];
  zero(yacc);
  zero(sacc);
  for (int job = 0; job < jobs; ++job) {
    const int st = job & 1;
    if (job + 1 < jobs) {
      stage_job(job + 1, st ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bool state = job < first;
    const int r = job - first;
    const int kt = state ? job : r % NKT, jb = r / NKT;
    if (!idle) {
      const uint8_t* ct = smem + st * S::STAGE3;
      const uint8_t* bt = ct + S::TILEC;  // B, or the entering state
      const int steps = min(8, (N - kt * TILE + 7) / 8);
      float big[8][4], small[8][4];
      zero(big);
      zero(small);
      for (int ks = 0; ks < steps; ++ks) {
        // the k-step's columns in the order the fragments want them: A's
        // column t is column 2t of the step, column t + 4 is 2t + 1 (the
        // same 8 terms), so each lane loads its two as one pair
        const int k = 8 * ks + 2 * t;
        const float2 cg = at2<T>(ct, S::LDC, m0 + g, k);
        const float2 ch = at2<T>(ct, S::LDC, m0 + g + 8, k);
        // C's A fragment: a0 (row g), a1 (g + 8), a2 (g), a3 (g + 8)
        const float av[4] = {cg.x, ch.x, cg.y, ch.y};
        uint32_t ab[4], as[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split<F32>(av[i], ab[i], as[i]);
        float bv[8][2];
        if (state) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            bv[nt][0] = at<float>(bt, S::LDE, k, 8 * nt + g);
            bv[nt][1] = at<float>(bt, S::LDE, k + 1, 8 * nt + g);
          }
          products<F32, true, false>(big, small, ab, as, bv);
        } else {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const float2 b2 = at2<T>(bt, S::LDC, 8 * nt + g, k);
            bv[nt][0] = b2.x;
            bv[nt][1] = b2.y;
          }
          products<F32, F32, false>(big, small, ab, as, bv);
        }
      }
      add_block(sacc, big, small);
      if (kt == NKT - 1) {
        if (state) {
          // y = exp(cum_i) (C_i @ enter): rows g (q < 2) and g + 8
          const float ea = expf(cum_a), eb = expf(cum_b);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            yacc[nt][0] = __fmul_rn(ea, sacc[nt][0]);
            yacc[nt][1] = __fmul_rn(ea, sacc[nt][1]);
            yacc[nt][2] = __fmul_rn(eb, sacc[nt][2]);
            yacc[nt][3] = __fmul_rn(eb, sacc[nt][3]);
          }
        } else {
          // att in registers, then y += att x over the block's rows
          const uint8_t* xt = bt + S::SLOT;
          const float* cj = reinterpret_cast<const float*>(xt + S::TILEX);
          const float* dj = cj + TILE;
          const int j0 = jb * TILE;
          zero(big);
          zero(small);
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            // S's n-tile kk: element q is row g + 8 (q / 2), column
            // 8 kk + 2t + q % 2; exp of 0 where j > i, then the select
            float v[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int i = q < 2 ? ia : ib;
              const int jl = 8 * kk + 2 * t + (q & 1);
              const bool keep = j0 + jl <= i;
              const float e = expf(
                  keep ? __fsub_rn(q < 2 ? cum_a : cum_b, cj[jl]) : 0.0f);
              v[q] = keep && i < Q
                         ? __fmul_rn(__fmul_rn(sacc[kk][q], e), dj[jl])
                         : 0.0f;
            }
            // A's column t is row 2t, column t + 4 row 2t + 1
            const float av2[4] = {v[0], v[2], v[1], v[3]};
            uint32_t ab2[4], as2[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) split<true>(av2[i], ab2[i], as2[i]);
            float bv[8][2];
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
              bv[nt][0] = at<T>(xt, S::LDX, 8 * kk + 2 * t, 8 * nt + g);
              bv[nt][1] = at<T>(xt, S::LDX, 8 * kk + 2 * t + 1, 8 * nt + g);
            }
            products<true, F32, true>(big, small, ab2, as2, bv);
          }
          add_block(yacc, big, small);
        }
        zero(sacc);
      }
    }
    __syncthreads();  // stage st consumed before the next copies into it
  }
  if (idle) return;
  float* yc = y + row0 * P + p0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = h ? ib : ia;
    if (i >= Q) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int p = 8 * nt + 2 * t;
      if (p0 + p < P) yc[static_cast<long long>(i) * P + p] = yacc[nt][2 * h];
      if (p0 + p + 1 < P)
        yc[static_cast<long long>(i) * P + p + 1] = yacc[nt][2 * h + 1];
    }
  }
}

// The widest cp.async (16, 8 or 4 bytes) that a base and its rows of n
// elements allow, or 2 (16 bits only: realigned in registers).
int vec_of(const void* p, int n, int elt) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  for (int v = 16; v >= 4; v /= 2)
    if (a % v == 0 && (static_cast<long long>(n) * elt) % v == 0) return v;
  return 2;
}

// floats of the scratch: chunk states, decays, cumsums
long long scratch_floats(long long bh, int L, int P, int N, int Q) {
  const long long nc = L / Q;
  return bh * nc * N * P + bh * nc + bh * L;
}

template <typename T>
int launch(const void* x, const void* da, const void* dt, const void* bmat,
           const void* cmat, void* y, void* scratch, int bh, int L, int P,
           int N, int Q, cudaStream_t stream) {
  using S = Smem<T>;
  constexpr int elt = static_cast<int>(sizeof(T));
  const int NC = L / Q;
  const int smem1 = S::pass1(Q);
  if (smem1 > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const long long slabs = (P + TILE - 1) / TILE;
  const long long grid1 = static_cast<long long>(bh) * NC * ((N + TILE - 1) / TILE) * slabs;
  const long long grid3 = static_cast<long long>(bh) * NC * ((Q + TILE - 1) / TILE) * slabs;
  const long long total = static_cast<long long>(bh) * N * P;
  const long long grid2 = (total + PASS_THREADS - 1) / PASS_THREADS;
  if (grid1 > MAX_GRID || grid2 > MAX_GRID || grid3 > MAX_GRID)
    return static_cast<int>(cudaErrorInvalidValue);
  auto k1 = ssd_chunk_state_kernel<T>;
  auto k3 = ssd_chunk_out_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        k3, cudaFuncAttributeMaxDynamicSharedMemorySize, S::PASS3);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* states = static_cast<float*>(scratch);
  float* decay = states + static_cast<long long>(bh) * NC * N * P;
  float* cums = decay + static_cast<long long>(bh) * NC;
  Vecs vec;
  vec.x = vec_of(x, P, elt);
  vec.b = vec_of(bmat, N, elt);
  vec.c = vec_of(cmat, N, elt);
  vec.e = vec_of(states, P, 4);
  const auto* xt = static_cast<const T*>(x);
  const auto* bt = static_cast<const T*>(bmat);
  const auto* ct = static_cast<const T*>(cmat);
  const auto* daf = static_cast<const float*>(da);
  const auto* dtf = static_cast<const float*>(dt);
  k1<<<static_cast<unsigned>(grid1), THREADS, smem1, stream>>>(
      xt, daf, dtf, bt, states, decay, cums, L, P, N, Q, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_state_pass_kernel<<<static_cast<unsigned>(grid2), PASS_THREADS, 0,
                          stream>>>(states, decay, total, NC,
                                    static_cast<long long>(N) * P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k3<<<static_cast<unsigned>(grid3), THREADS, S::PASS3, stream>>>(
      xt, dtf, bt, ct, states, cums, static_cast<float*>(y), bh, L, P, N, Q,
      vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of the scratch ssd_scan_launch needs for these sizes (the chunk
// states, decays and cumsums), or -1 when the chunk is too long for pass
// 1's shared memory (past 39,680 rows).
extern "C" long long ssd_scan_scratch_floats(int bh, int L, int P, int N,
                                             int chunk) {
  if (chunk <= 0 || L % chunk != 0) return -1;
  if (Smem<float>::pass1(chunk) > MAX_SMEM) return -1;
  return scratch_floats(bh, L, P, N, chunk);
}

// Head-major x, B, C (BH, L, P / N) in float32, bfloat16 or float16 (dtype
// 0, 1, 2), float32 da and dt (BH, L), y (BH, L, P) float32; `scratch` the
// ssd_scan_scratch_floats floats.  Any P, N >= 1, L % chunk == 0, any base.
extern "C" int ssd_scan_launch(const void* x, const void* da, const void* dt,
                               const void* bmat, const void* cmat, void* y,
                               void* scratch, int bh, int L, int P, int N,
                               int chunk, int dtype, void* stream) {
  if (bh <= 0 || L <= 0) return 0;
  if (P <= 0 || N <= 0 || chunk <= 0 || L % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, da, dt, bmat, cmat, y, scratch, bh, L, P, N,
                           chunk, s);
    case 1:
      return launch<__nv_bfloat16>(x, da, dt, bmat, cmat, y, scratch, bh, L,
                                   P, N, chunk, s);
    case 2:
      return launch<__half>(x, da, dt, bmat, cmat, y, scratch, bh, L, P, N,
                            chunk, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
