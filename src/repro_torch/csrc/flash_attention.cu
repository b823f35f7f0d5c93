// Blockwise online-softmax attention (flash attention) on Hopper's tensor
// cores through mma.sync (sm_90a): the route `mma_sync` of
// repro_torch/kernels/flash_attention/ops.py, every call the wgmma build
// (flash_attention_wgmma.cu) does not take.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:93
// `flash_attention` (body `_kernel`): for each query row, softmax(q k^T *
// h^-1/2) v over its key blocks, with the running max m, sum l and
// accumulator kept in float32, the causal and sliding-window masks (window
// only with causal), the tail mask col < T, a skip of key blocks the
// causal/window geometry makes dead, and GQA by reading kv head n*K/N for
// query head n.  Its plain version is
// repro_torch/kernels/flash_attention/ref.py `attention_ref`.
//
// Layout: the model's own, q/out (B, S, N, h) and k/v (B, T, K, h), read
// through their row strides (N*h and K*h), so the wrapper copies nothing.
// Element types float32, bfloat16 and float16 (dtype codes 0, 1, 2), any
// head_dim h >= 1, any base address.
//
// What bounds it: operations.  At S = 4096, h = 128 the causal work is
// ~137 GFLOP against ~84 MB of q/k/v/out, far right of the card's ridge.
// bf16 and float16 run on the tensor cores at their 989 TFLOP/s peak;
// float32 runs three TF32 products for each one (below), so its least
// time is the work at a third of TF32's 495 TFLOP/s.
//
// Design, per CTA of four warps over one (q block, query head, batch,
// slice of output columns):
// - Each warp owns 16 q rows a m-tile, two m-tiles (a 128-row q block)
//   where the slice is at most 128 columns, else one (64 rows): their
//   scores and their output accumulator stay in registers (the
//   flash-attention-2 shape).  S = q k^T comes from mma.sync m16n8k16 (bf16
//   or f16 in, float32 accumulate) or, in float32, m16n8k8 on TF32 parts,
//   with both operands read by ldmatrix and each k fragment used by both
//   m-tiles.  Key blocks are as wide as the registers allow without a
//   spill: 48 or 64 keys in 16 bits, 16 or 32 in float32.  The online
//   softmax runs on the accumulator fragments: a row lies on one lane
//   quad, so its max takes two xor shuffles, and its sum stays per lane
//   until the epilogue.  P never leaves registers: in 16 bits it is rounded
//   to the input's type and is, packed in pairs, the A fragment of P v
//   (m16n8k16's C layout is its A layout), with v read by ldmatrix.trans;
//   in float32 the key order within each group of 8 is permuted (A's
//   column t <- key 2t, t + 4 <- key 2t + 1) so that the C fragment is
//   again the A fragment, and v is read at the same keys.
// - Tiles in shared memory in the input's own type: q, and k and v blocks
//   in two stages when they fit beside a second CTA (cp.async of the next
//   block overlaps this block's products), each row padded by 16 bytes so
//   that ldmatrix's eight rows fall in eight distinct bank groups.  The
//   head_dim is padded with staged zeros only to the k-step (16 columns in
//   16 bits, 8 in float32), so h = 100 runs 112 columns.  Each tensor is
//   copied with the widest cp.async (16, 8 or 4 bytes) that its base and
//   its row bytes allow; a 16-bit tensor at a 2-byte aligned base (or an
//   odd h) is read as the aligned 4-byte words under each 8 elements,
//   realigned with byte permutes and stored to shared memory from
//   registers, never reading a word that holds no element of the row.
// - Past h = 256 the output columns are split across CTAs into slices of at
//   most 256 (ceil(h/256) slices of equal width, rounded to 16), so that the
//   accumulator fits in registers; every slice stages q and k at their full
//   width and forms the same scores in the same order, so its running max
//   and sum are bitwise every other slice's.  Where q and one k block do
//   not fit in shared memory (float32 past h ~ 512, 16 bits past ~ 1000),
//   q and k are staged in pieces of columns, q again for every key block;
//   the products are added in the same order either way.
// - Launch order: the slices of a q block next to each other, then the
//   query heads, then the q blocks heaviest causal row first.
//
// Numerics.  Masked scores are -1e30 after the products, as in the TPU
// kernel, so a row whose first live block is wholly masked for it
// collects weight that the next live block's rescale (alpha = 0) wipes,
// and no masked value enters a product.  16 bits: float32 scores, the
// max on the unscaled scores, p = 2^((s - m) * h^-1/2 * log2 e) by
// ex2.approx, l summed from the float32 p, p rounded to the input's type
// before P v (as the wgmma build and the einsum path do).  float32 (split
// TF32): each operand x of both products is split at fragment load into
// big = tf32(x) and small = tf32(x - big), tf32 being cvt.rna.tf32.f32's
// rounding (to nearest, ties away from zero), and each k-step adds
// small*big, then big*small, then big*big: about 21 bits of each product,
// where one TF32 product keeps 11 and misses the 2e-5 rule.  The tensor
// cores truncate as they add, so the scores sum their small terms apart
// from the big ones (added in float32 at the end), and P v sums each key
// block from zero before o = o * alpha + that block in float32: no long
// truncating chain runs across a row's keys.  The scores are scaled by
// h^-1/2 before the max, p = expf(s - m).  Built with --fmad=false and
// without fast math: the scalar math rounds each operation alone (mma is
// not affected).  tests/test_torch_cuda.py holds plain models of both
// arithmetics (_mma_sync_numerics), which the CPU tests hold to the TPU
// kernel and the card tests hold this kernel to.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 128;    // four warps
constexpr float NEG_INF = -1e30f;
constexpr int MAX_SMEM = 232448;  // the opt-in shared memory of a block
constexpr int SM_SMEM = 233472;   // an SM's, 1 KB of it reserved a block

template <typename T>
constexpr bool kF32 = std::is_same<T, float>::value;
// columns a k-step (32 bytes in either type)
template <typename T>
constexpr int kKS = kF32<T> ? 8 : 16;

// What the host decides for a launch (all but the vectors are per call).
struct Plan {
  int dq;          // head_dim padded to the k-step: the columns of q k^T
  int dp;          // columns of q and k staged at once (dq: q stays resident)
  int sw;          // output columns of a slice, a multiple of 16
  int slices;      // ceil(h / sw)
  int stages;      // k/v buffers, 1 or 2
  int lq;          // bytes a shared row of q and k: dp * elt + 16
  int lv;          // bytes a shared row of v: sw * elt + 16
  int vq, vk, vv;  // bytes a copy of q, k, v: 16, 8, 4 (cp.async), 2 (realign)
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

// Rows [row0, row0 + R) of a matrix whose row r starts at src + r * stride
// (elements), columns [0, cols), to shared memory at dst, `pitch` bytes a
// row: rows < rows and columns < valid from memory, the rest zeros.  VEC
// is the bytes of one cp.async (the base, the row bytes and valid's bytes
// are multiples of it), or 2: 8 elements a thread realigned in registers
// (visible after the next barrier, like the copies after their wait).
template <typename T, int R, int VEC>
__device__ __forceinline__ void stage_vec(uint32_t dst, int pitch,
                                          const T* src, long long stride,
                                          int row0, int rows, int cols,
                                          int valid) {
  constexpr int UNIT = VEC == 2 ? 16 : VEC;  // shared bytes a step
  constexpr int E = UNIT / static_cast<int>(sizeof(T));
  const int cpr = cols / E;  // steps a row
  const int dr = THREADS / cpr, dc = THREADS - dr * cpr;
  int r = threadIdx.x / cpr, c = threadIdx.x - r * cpr;
  for (int idx = threadIdx.x; idx < R * cpr; idx += THREADS) {
    const int gr = row0 + r, col = c * E;
    const uint32_t d = dst + r * pitch + c * UNIT;
    const T* s = src + static_cast<long long>(gr) * stride + col;
    if constexpr (VEC == 2) {
      realign16(d, s, gr < rows ? valid - col : 0);
    } else {
      const bool ok = gr < rows && col < valid;
      cp_async<VEC>(d, ok ? s : src, ok);
    }
    c += dc;
    r += dr;
    if (c >= cpr) {
      c -= cpr;
      ++r;
    }
  }
}

template <typename T, int R>
__device__ __forceinline__ void stage(int vec, uint32_t dst, int pitch,
                                      const T* src, long long stride, int row0,
                                      int rows, int cols, int valid) {
  switch (vec) {
    case 16:
      stage_vec<T, R, 16>(dst, pitch, src, stride, row0, rows, cols, valid);
      break;
    case 8:
      stage_vec<T, R, 8>(dst, pitch, src, stride, row0, rows, cols, valid);
      break;
    case 4:
      stage_vec<T, R, 4>(dst, pitch, src, stride, row0, rows, cols, valid);
      break;
    default:
      if constexpr (!kF32<T>)
        stage_vec<T, R, 2>(dst, pitch, src, stride, row0, rows, cols, valid);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// D (16 x 8, float32) += A (16 x 16) B (16 x 8), in bf16 or float16 (T)
template <typename T>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
        "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D (16 x 8, float32) += A (16 x 8) B (8 x 8), TF32 operands
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// cvt.rna.tf32.f32 on a finite float32's bits: to TF32's 10 mantissa bits,
// to nearest, ties away from zero (the conversion's own test for
// infinities and NaN is left out: every operand here is finite)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small (to ~2^-22 of x), each a TF32 value
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(__fsub_rn(x, __uint_as_float(big)));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

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

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}

// Columns col, col + 1 (the second where `both`) of an output row.
template <typename T>
__device__ __forceinline__ void store2(T* p, float x, float y, bool both) {
  if (both && reinterpret_cast<uintptr_t>(p) % (2 * sizeof(T)) == 0) {
    if constexpr (kF32<T>)
      *reinterpret_cast<float2*>(p) = make_float2(x, y);
    else
      *reinterpret_cast<uint32_t*>(p) = pack2<T>(x, y);
  } else {
    p[0] = from_float<T>(x);
    if (both) p[1] = from_float<T>(y);
  }
}

// s (this warp's MT m-tiles of 16 rows x NT * 8 keys) += q k^T over
// `steps` k-steps of 32 bytes; qa, ka: this lane's ldmatrix addresses in
// the q tile (its first m-tile) and the k tile.  float32 adds its small
// terms (small*big, then big*small) to c and its big*big terms to s, each
// in k-step order, so that the tensor cores' truncating sums of s see one
// term a k-step (s + c is formed by the caller).  Every call adds the same
// products in the same order, whatever pieces the columns come in.
template <typename T, int MT, int NT>
__device__ __forceinline__ void qk(float (&s)[MT][NT][4], float (&c)[MT][NT][4],
                                   uint32_t qa, uint32_t ka, int lq, int steps) {
  for (int ks = 0; ks < steps; ++ks, qa += 32, ka += 32) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) ldsm_x4(a[mt], qa + mt * 16 * lq);
    if constexpr (kF32<T>) {
      uint32_t ab[MT][4], as[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split(__uint_as_float(a[mt][i]), ab[mt][i], as[mt][i]);
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t r[4], bb[4], bs[4];  // tiles 2p (0, 1) and 2p + 1 (2, 3)
        ldsm_x4(r, ka + p * 16 * lq);
#pragma unroll
        for (int i = 0; i < 4; ++i) split(__uint_as_float(r[i]), bb[i], bs[i]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            float(&cu)[4] = c[mt][2 * p + u];
            mma_tf32(cu, as[mt], bb[2 * u], bb[2 * u + 1]);
            mma_tf32(cu, ab[mt], bs[2 * u], bs[2 * u + 1]);
            mma_tf32(s[mt][2 * p + u], ab[mt], bb[2 * u], bb[2 * u + 1]);
          }
      }
    } else {
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t r[4];
        ldsm_x4(r, ka + p * 16 * lq);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16<T>(s[mt][2 * p], a[mt], r[0], r[1]);
          mma16<T>(s[mt][2 * p + 1], a[mt], r[2], r[3]);
        }
      }
    }
  }
}

// o (MT m-tiles of 16 rows x OT * 8 columns, the first cw stored) =
// o * alpha + p v.  16 bits: o is rescaled first and p v added in place,
// reading v by ldmatrix.trans at this lane's address va.  float32: each
// 8-column tile's p v over this key block is summed from zero (so the
// tensor cores' truncating sums run over one block only) and added as
// o * alpha + that in float32, reading v from the tile at vs (g, t: the
// lane's group and place in it).
template <typename T, int MT, int NT, int OT>
__device__ __forceinline__ void pv(float (&o)[MT][OT][4],
                                   const float (&p)[MT][NT][4],
                                   const float (&alpha)[MT][2], uint32_t va,
                                   const uint8_t* vs, int lv, int cw, int g,
                                   int t) {
  if constexpr (kF32<T>) {
    // A's column t is key 2t, column t + 4 key 2t + 1: the C fragment
    uint32_t pb[MT][NT][4], ps[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        const float pa[4] = {p[mt][kk][0], p[mt][kk][2], p[mt][kk][1],
                             p[mt][kk][3]};
#pragma unroll
        for (int i = 0; i < 4; ++i) split(pa[i], pb[mt][kk][i], ps[mt][kk][i]);
      }
    const float* v0 = reinterpret_cast<const float*>(vs + 2 * t * lv) + g;
#pragma unroll
    for (int nt = 0; nt < OT; ++nt) {
      if (8 * nt < cw) {
        float acc[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][i] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < NT; ++kk) {
          const float* r0 = reinterpret_cast<const float*>(
                                reinterpret_cast<const uint8_t*>(v0) +
                                kk * 8 * lv) + 8 * nt;
          const float* r1 = reinterpret_cast<const float*>(
              reinterpret_cast<const uint8_t*>(r0) + lv);
          uint32_t b0b, b0s, b1b, b1s;
          split(*r0, b0b, b0s);
          split(*r1, b1b, b1s);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_tf32(acc[mt], ps[mt][kk], b0b, b1b);
            mma_tf32(acc[mt], pb[mt][kk], b0s, b1s);
            mma_tf32(acc[mt], pb[mt][kk], b0b, b1b);
          }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            o[mt][nt][i] =
                __fadd_rn(__fmul_rn(o[mt][nt][i], alpha[mt][i / 2]), acc[mt][i]);
      }
    }
  } else {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < OT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          o[mt][nt][i] = __fmul_rn(o[mt][nt][i], alpha[mt][i / 2]);
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = pack2<T>(p[mt][2 * kk][0], p[mt][2 * kk][1]);
        a[mt][1] = pack2<T>(p[mt][2 * kk][2], p[mt][2 * kk][3]);
        a[mt][2] = pack2<T>(p[mt][2 * kk + 1][0], p[mt][2 * kk + 1][1]);
        a[mt][3] = pack2<T>(p[mt][2 * kk + 1][2], p[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int c2 = 0; c2 < OT / 2; ++c2) {
        if (16 * c2 < cw) {
          uint32_t r[4];
          ldsm_x4_trans(r, va + kk * 16 * lv + c2 * 32);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma16<T>(o[mt][2 * c2], a[mt], r[0], r[1]);
            mma16<T>(o[mt][2 * c2 + 1], a[mt], r[2], r[3]);
          }
        }
      }
    }
  }
}

// One CTA: MT m-tiles of 16 q rows a warp (BQ = 64 MT rows), DV output
// columns of registers.  `scale` is h^-1/2 (float32) or h^-1/2 * log2(e)
// (16 bits), rounded once.
template <typename T, int DV, int MT, int BK>
__global__ void __launch_bounds__(THREADS, 1) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int S, int T_len, int N, int K, int h, int causal,
    int window, float scale, Plan pl) {
  constexpr bool F32 = kF32<T>;
  constexpr int BQ = 64 * MT;
  constexpr int KS = kKS<T>;
  constexpr int NT = BK / 8;  // 8-key tiles of the scores
  constexpr int OT = DV / 8;  // 8-column tiles of the output
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sq = smem_u32(smem);
  const int kv_bytes = BK * (pl.lq + pl.lv);  // a stage: k, then v
  auto k_off = [&](int st) { return BQ * pl.lq + st * kv_bytes; };
  auto v_off = [&](int st) { return k_off(st) + BK * pl.lq; };

  // blockIdx.x -> (slice, query head, q block heaviest first, batch)
  int id = blockIdx.x;
  const int slice = id % pl.slices;
  id /= pl.slices;
  const int n = id % N;
  id /= N;
  const int num_qb = (S + BQ - 1) / BQ;
  const int qb = num_qb - 1 - id % num_qb;
  const int b = id / num_qb;
  const int i0 = qb * BQ;
  const int c0 = slice * pl.sw, cw = min(pl.sw, h - c0);
  const int kvh = n * K / N;
  const long long q_stride = static_cast<long long>(N) * h;
  const long long kv_stride = static_cast<long long>(K) * h;
  const T* qh = q + (static_cast<long long>(b) * S * N + n) * h;
  const T* kh = k + (static_cast<long long>(b) * T_len * K + kvh) * h;
  const T* vh = v + (static_cast<long long>(b) * T_len * K + kvh) * h + c0;

  // live key blocks [jb, je): above the diagonal, or wholly before the
  // window, they are dead
  const int num_kb = (T_len + BK - 1) / BK;
  int jb = 0, je = num_kb;
  if (causal) {
    je = min(num_kb, (i0 + BQ - 1) / BK + 1);
    if (window > 0) {
      const int lo = i0 - window + 1 - (BK - 1);  // live iff j * BK >= lo
      jb = lo > 0 ? (lo + BK - 1) / BK : 0;
    }
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // this lane's ldmatrix rows (bytes from a tile's base): q's A fragment
  // (the warp's first m-tile), k's B fragments of two 8-key tiles, v's (16
  // bits, transposed) of two 8-column tiles
  const uint32_t q_lane =
      (warp * 16 * MT + lane % 8 + 8 * ((lane / 8) % 2)) * pl.lq +
      16 * (lane / 16);
  const uint32_t k_lane =
      (lane % 8 + 8 * (lane / 16)) * pl.lq + 16 * ((lane / 8) % 2);
  const uint32_t v_lane =
      (lane % 8 + 8 * ((lane / 8) % 2)) * pl.lv + 16 * (lane / 16);

  auto stage_q = [&](int d0) {
    stage<T, BQ>(pl.vq, sq, pl.lq, qh + d0, q_stride, i0, S, pl.dp,
                 min(pl.dp, h - d0));
  };
  auto stage_k = [&](int j, int st, int d0) {
    stage<T, BK>(pl.vk, sq + k_off(st), pl.lq, kh + d0, kv_stride, j * BK,
                 T_len, pl.dp, min(pl.dp, h - d0));
  };
  auto stage_v = [&](int j, int st) {
    stage<T, BK>(pl.vv, sq + v_off(st), pl.lv, vh, kv_stride, j * BK, T_len,
                 pl.sw, cw);
  };

  float o[MT][OT][4];
  float m[MT][2], l[MT][2];  // rows g and g + 8 of each m-tile; l: this
                             // lane's share of the row sums
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < OT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[mt][nt][i] = 0.0f;
    m[mt][0] = m[mt][1] = NEG_INF;
    l[mt][0] = l[mt][1] = 0.0f;
  }

  const bool resident = pl.dp == pl.dq;
  if (resident) {
    stage_q(0);
    if (jb < je) {
      stage_k(jb, 0, 0);
      stage_v(jb, 0);
    }
    cp_commit();
  }
  int st = 0;
  for (int j = jb; j < je; ++j) {
    const int j0 = j * BK;
    float s[MT][NT][4], c[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[mt][nt][i] = c[mt][nt][i] = 0.0f;

    // S = q k^T
    if (resident) {
      if (pl.stages == 2) {
        if (j + 1 < je) {
          stage_k(j + 1, st ^ 1, 0);
          stage_v(j + 1, st ^ 1);
        }
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      qk<T, MT, NT>(s, c, sq + q_lane, sq + k_off(st) + k_lane, pl.lq,
                    pl.dq / KS);
    } else {
      for (int d0 = 0; d0 < pl.dq; d0 += pl.dp) {
        __syncthreads();  // the previous piece's q and k are consumed
        stage_q(d0);
        stage_k(j, 0, d0);
        if (d0 == 0) stage_v(j, 0);
        cp_commit();
        cp_wait<0>();
        __syncthreads();
        qk<T, MT, NT>(s, c, sq + q_lane, sq + k_off(0) + k_lane, pl.lq,
                      min(pl.dp, pl.dq - d0) / KS);
      }
    }

    // masks (-1e30 after the products) on blocks not live for every
    // (row, col); float32 adds its small terms and scales here
    const bool whole =
        j0 + BK <= T_len &&
        (!causal || (j0 + BK - 1 <= i0 &&
                     (window <= 0 || j0 >= i0 + BQ - window)));
    float alpha[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int row0 = i0 + warp * 16 * MT + mt * 16 + g;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          bool keep = true;
          if (!whole) {
            const int row = row0 + 8 * (i / 2);
            const int col = j0 + 8 * nt + 2 * t + i % 2;
            keep = col < T_len;
            if (causal) {
              keep = keep && col <= row;
              if (window > 0) keep = keep && col > row - window;
            }
          }
          float& x = s[mt][nt][i];
          if (F32)
            x = keep ? __fmul_rn(__fadd_rn(x, c[mt][nt][i]), scale) : NEG_INF;
          else if (!keep)
            x = NEG_INF;
        }

      // online softmax on the fragments: rows g (i < 2) and g + 8
      float mx[2] = {m[mt][0], m[mt][1]};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          mx[i / 2] = fmaxf(mx[i / 2], s[mt][nt][i]);
      float rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[mt][r] = F32 ? expf(__fsub_rn(m[mt][r], mx[r]))
                           : ex2(__fmul_rn(__fsub_rn(m[mt][r], mx[r]), scale));
        m[mt][r] = mx[r];
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i / 2;
          float& x = s[mt][nt][i];
          x = F32 ? expf(__fsub_rn(x, mx[r]))
                  : ex2(__fmul_rn(__fsub_rn(x, mx[r]), scale));
          rs[r] = __fadd_rn(rs[r], x);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        l[mt][r] = __fadd_rn(__fmul_rn(alpha[mt][r], l[mt][r]), rs[r]);
    }

    // O = O * alpha + P v
    pv<T, MT, NT, OT>(o, s, alpha, sq + v_off(st) + v_lane, smem + v_off(st),
                      pl.lv, cw, g, t);
    __syncthreads();  // every warp is done with this stage's k and v
    if (resident && pl.stages == 1 && j + 1 < je) {
      stage_k(j + 1, 0, 0);
      stage_v(j + 1, 0);
      cp_commit();
    }
    if (pl.stages == 2) st ^= 1;
  }
  cp_wait<0>();

  // epilogue: o / max(l, 1e-30) in T, rows < S, the slice's columns < cw
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lt = l[mt][r];
      lt = __fadd_rn(lt, __shfl_xor_sync(0xffffffffu, lt, 1));
      lt = __fadd_rn(lt, __shfl_xor_sync(0xffffffffu, lt, 2));
      const float denom = fmaxf(lt, 1e-30f);
      const int row = i0 + warp * 16 * MT + mt * 16 + g + 8 * r;
      if (row >= S) continue;
      T* orow = out + ((static_cast<long long>(b) * S + row) * N + n) * h + c0;
#pragma unroll
      for (int nt = 0; nt < OT; ++nt) {
        const int col = 8 * nt + 2 * t;
        if (col < cw)
          store2<T>(orow + col, __fdiv_rn(o[mt][nt][2 * r], denom),
                    __fdiv_rn(o[mt][nt][2 * r + 1], denom), col + 1 < cw);
      }
    }
}

// The widest cp.async (16, 8 or 4 bytes) that a base and its rows of h
// elements allow, or 2 (16 bits only: realigned in registers).
int vec_of(const void* p, int h, int elt) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  for (int v = 16; v >= 4; v /= 2)
    if (a % v == 0 && (static_cast<long long>(h) * elt) % v == 0) return v;
  return 2;
}

template <typename T, int DV, int MT, int BK>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int T_len, int N, int K, int h, int causal, int window,
           const Plan& pl, int bytes, float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, DV, MT, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>((S + 64 * MT - 1) / (64 * MT)) * N * B *
      pl.slices;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, T_len, N, K, h,
      causal, window, scale, pl);
  return static_cast<int>(cudaGetLastError());
}

// The plan: slices of the output columns, two m-tiles a warp where the
// accumulator of at most 128 columns leaves room for them, the shared tiles
// (two k/v stages where two CTAs still share an SM, else where they fit;
// q in pieces only where q and one k/v stage do not fit) and each
// tensor's copy width.
template <typename T>
int launch_t(const void* q, const void* k, const void* v, void* out, int B,
             int S, int T_len, int N, int K, int h, int causal, int window,
             cudaStream_t stream) {
  constexpr int elt = static_cast<int>(sizeof(T));
  constexpr int KS = kKS<T>;
  Plan pl;
  pl.dq = (h + KS - 1) / KS * KS;
  const int ns = (h + 255) / 256;
  pl.sw = ((h + ns - 1) / ns + 15) / 16 * 16;
  pl.slices = (h + pl.sw - 1) / pl.sw;
  pl.lv = pl.sw * elt + 16;
  // two m-tiles a warp where the accumulator is at most 128 columns wide;
  // key blocks as wide as the registers then allow without a spill, and
  // (float32 at 256 columns) as two CTAs an SM need
  const int mt = pl.sw <= 128 ? 2 : 1;
  const int bq = 64 * mt;
  const int BK =
      kF32<T> ? (mt == 2 || pl.dq <= 256 ? 16 : 32) : (mt == 2 ? 48 : 64);
  auto need = [&](int dp, int stages) {
    const long long lq = static_cast<long long>(dp) * elt + 16;
    return bq * lq + stages * BK * (lq + pl.lv);
  };
  const long long two = SM_SMEM / 2 - 1024;
  pl.dp = pl.dq;
  if (need(pl.dq, 2) <= two)
    pl.stages = 2;
  else if (need(pl.dq, 1) <= two)
    pl.stages = 1;
  else if (need(pl.dq, 2) <= MAX_SMEM)
    pl.stages = 2;
  else if (need(pl.dq, 1) <= MAX_SMEM)
    pl.stages = 1;
  else {
    pl.stages = 1;
    const long long room =
        (MAX_SMEM - static_cast<long long>(BK) * pl.lv) / (bq + BK) - 16;
    pl.dp = static_cast<int>(room / elt) / KS * KS;
  }
  pl.lq = pl.dp * elt + 16;
  pl.vq = vec_of(q, h, elt);
  pl.vk = vec_of(k, h, elt);
  pl.vv = vec_of(v, h, elt);
  const int bytes = static_cast<int>(need(pl.dp, pl.stages));
  const double r = 1.0 / sqrt(static_cast<double>(h));  // the true h
  const float scale =
      static_cast<float>(kF32<T> ? r : r * 1.4426950408889634);
#define FLASH_ARGS                                                         \
  q, k, v, out, B, S, T_len, N, K, h, causal, window, pl, bytes, scale, stream
  if constexpr (kF32<T>) {
    if (pl.sw <= 64) return launch<T, 64, 2, 16>(FLASH_ARGS);
    if (pl.sw <= 128) return launch<T, 128, 2, 16>(FLASH_ARGS);
    return BK == 16 ? launch<T, 256, 1, 16>(FLASH_ARGS)
                    : launch<T, 256, 1, 32>(FLASH_ARGS);
  } else {
    if (pl.sw <= 64) return launch<T, 64, 2, 48>(FLASH_ARGS);
    if (pl.sw <= 128) return launch<T, 128, 2, 48>(FLASH_ARGS);
    return launch<T, 256, 1, 64>(FLASH_ARGS);
  }
#undef FLASH_ARGS
}

}  // namespace

// q/out (B, S, N, h), k/v (B, T, K, h), contiguous, in float32 (dtype 0),
// bfloat16 (1) or float16 (2); any h >= 1, any base.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int T_len, int N, int K, int h,
                                      int causal, int window, int dtype,
                                      void* stream) {
  if (B <= 0 || S <= 0 || N <= 0) return 0;
  if (h <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_t<float>(q, k, v, out, B, S, T_len, N, K, h, causal,
                             window, s);
    case 1:
      return launch_t<__nv_bfloat16>(q, k, v, out, B, S, T_len, N, K, h,
                                     causal, window, s);
    case 2:
      return launch_t<__half>(q, k, v, out, B, S, T_len, N, K, h, causal,
                              window, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
