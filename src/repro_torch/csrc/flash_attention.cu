// Blockwise online-softmax attention (flash attention), for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py
// `flash_attention` (body `_kernel`): for each query row, softmax(q k^T *
// h^-1/2) v over its key block sequence, with the running max m, sum l and
// accumulator kept in float32, the causal and sliding-window masks, the
// tail mask col < T, a skip of key blocks the causal/window geometry makes
// dead, and GQA by reading kv head n*K/N for query head n.  Its plain
// version is repro_torch/kernels/flash_attention/ref.py `attention_ref`.
//
// Layout: the model's own, q/out (B, S, N, h) and k/v (B, T, K, h), read
// through their row strides (N*h and K*h), so the wrapper copies nothing.
// Element types float32, bfloat16 and float16 (one template; every product
// in float32).  Any head_dim h from 1 to 256 runs in the instantiation HD =
// 64, 128 or 256 that is the smallest >= h: columns h..HD-1 are staged as
// zeros (they add exact zeros to q k^T and to nothing that is stored), the
// epilogue writes columns < h only, and the scale is h^-1/2.
//
// Past h = 256 the tiles of a 256-column build already take 209 KB, so
// the work is split two ways (SPLIT = true, HD = 256): the output columns
// across CTAs, in slices of 256 (blockIdx.x = q block * slices + slice),
// and q k^T inside each CTA over pieces of 256 columns of q and k, staged
// in turn (q again for every key block) and added to the same scores, d
// ascending.  Every slice's CTA so forms the same scores from the same
// inputs in the same order, so its running max and sum are bitwise those
// of every other slice, and each writes its own columns of the output.
// The slices cost ceil(h/256) times the score work.  No size limit beyond
// the grid's (ceil(S/64) * ceil(h/256) < 2^31 blocks, N and B < 65536)
// and device memory.
//
// Design: one CTA of 256 threads per (q block of 64 rows, query head,
// batch).  The q tile and each 64-row k and v tile are staged in shared
// memory as float32 (q and k rows padded by one word against bank
// conflicts), 115 KB at HD=128 and 209 KB at HD=256, set through
// cudaFuncAttributeMaxDynamicSharedMemorySize.  Each thread owns a 4x4
// micro-tile of the 64x64 score tile (rows ty+16a, columns tx+16b) and
// the matching rows of the 64 x h accumulator (columns tx+16b); row max
// and row sum reduce over the 16 lanes that share a row with shuffles.
// The probabilities go through shared memory for the P @ V product.
// Rows past S are computed on zeros and never written.
//
// What bounds it: operations.  At S=4096, h=128 the causal work is ~137
// GFLOP against ~84 MB of q/k/v/out, far right of the card's ridge point.
// This kernel uses CUDA cores in float32, not the tensor cores (wgmma), so
// it stands far above the bf16 tensor-core bound; that redesign is later
// work.
//
// Numerics: float32 scores, exp and sums; built with --fmad=false and
// without fast math.  Masked scores are -1e30, as in the TPU kernel, so
// a row whose first live block is wholly masked for it collects weight
// that the next live block's rescale (alpha = exp(-1e30 - m) = 0) wipes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;
constexpr int MAX_SMEM = 232448;  // the opt-in shared memory of a block

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
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

template <int HD>
constexpr int smem_floats() {
  // q (BQ x HD+1), k (BK x HD+1), v (BK x HD), p (BQ x BK+1)
  return BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1);
}
static_assert(smem_floats<256>() * 4 <= MAX_SMEM, "HD=256 tiles do not fit");

// Stage rows [row0, row0 + 64) of one head into shared memory as float32,
// zeros past `rows` and in columns h..HD-1.  `stride` is the element
// distance between rows.
template <typename T, int HD, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride, int row0,
                                          int rows, int h) {
  for (int e = threadIdx.x; e < 64 * HD; e += THREADS) {
    const int r = e / HD, c = e % HD;
    const int gr = row0 + r;
    dst[r * LD + c] =
        gr < rows && c < h
            ? to_float(src[static_cast<long long>(gr) * stride + c])
            : 0.0f;
  }
}

template <typename T, int HD, bool SPLIT>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int S, int T_len, int N, int K, int h, int causal,
    int window, float scale) {
  constexpr int LDQ = HD + 1, LDK = HD + 1, LDV = HD, LDP = BK + 1;
  constexpr int CB = HD / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + BQ * LDQ;
  float* vs = ks + BK * LDK;
  float* ps = vs + BK * LDV;

  // SPLIT: blockIdx.x = q block * slices + slice, the slice's output
  // columns [c0, c0 + cw)
  const int slices = SPLIT ? (h + HD - 1) / HD : 1;
  const int qb = blockIdx.x / slices, n = blockIdx.y, b = blockIdx.z;
  const int c0 = (blockIdx.x % slices) * HD, cw = min(HD, h - c0);
  const int kvh = n * K / N;
  const int i0 = qb * BQ;
  const long long q_stride = static_cast<long long>(N) * h;
  const long long kv_stride = static_cast<long long>(K) * h;
  const T* qh = q + (static_cast<long long>(b) * S * N + n) * h;
  const T* kh = k + (static_cast<long long>(b) * T_len * K + kvh) * h;
  const T* vh = v + (static_cast<long long>(b) * T_len * K + kvh) * h;
  T* oh = out + (static_cast<long long>(b) * S * N + n) * h;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  if (!SPLIT) load_tile<T, HD, LDQ>(qs, qh, q_stride, i0, S, h);

  float m[4], l[4], acc[4][CB];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = NEG_INF;
    l[a] = 0.0f;
#pragma unroll
    for (int c = 0; c < CB; ++c) acc[a][c] = 0.0f;
  }

  const int num_kb = (T_len + BK - 1) / BK;
  for (int j = 0; j < num_kb; ++j) {
    const int j0 = j * BK;
    // dead-block skip: above the diagonal, or wholly outside the window
    if (causal) {
      if (j0 > i0 + BQ - 1) break;
      if (window > 0 && j0 + BK - 1 < i0 - window + 1) continue;
    }
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.0f;
    // S = q k^T, its sum over d ascending: at once, or (SPLIT) over pieces
    // of HD columns of q and k, each staged in turn (zeros past h)
    for (int d0 = 0; d0 < (SPLIT ? h : 1); d0 += HD) {
      __syncthreads();  // the previous piece's (or block's) tiles are consumed
      if (SPLIT) {
        load_tile<T, HD, LDQ>(qs, qh + d0, q_stride, i0, S, min(HD, h - d0));
        load_tile<T, HD, LDK>(ks, kh + d0, kv_stride, j0, T_len,
                              min(HD, h - d0));
        if (d0 == 0) load_tile<T, HD, LDV>(vs, vh + c0, kv_stride, j0, T_len, cw);
      } else {
        load_tile<T, HD, LDK>(ks, kh, kv_stride, j0, T_len, h);
        load_tile<T, HD, LDV>(vs, vh, kv_stride, j0, T_len, h);
      }
      __syncthreads();
      for (int d = 0; d < HD; ++d) {
        float qa[4], kc[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) qa[a] = qs[(ty + 16 * a) * LDQ + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) kc[c] = ks[(tx + 16 * c) * LDK + d];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            s[a][c] = __fadd_rn(s[a][c], __fmul_rn(qa[a], kc[c]));
      }
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = i0 + ty + 16 * a;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = j0 + tx + 16 * c;
        bool keep = col < T_len;
        if (causal) {
          keep = keep && col <= row;
          if (window > 0) keep = keep && col > row - window;
        }
        s[a][c] = keep ? __fmul_rn(s[a][c], scale) : NEG_INF;
        mx = fmaxf(mx, s[a][c]);
      }
      // the 16 lanes of a row are lanes [0,16) or [16,32) of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(__fsub_rn(s[a][c], m_new));
        ps[(ty + 16 * a) * LDP + tx + 16 * c] = p;
        sum = __fadd_rn(sum, p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
      const float alpha = expf(__fsub_rn(m[a], m_new));
      l[a] = __fadd_rn(__fmul_rn(alpha, l[a]), sum);
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < CB; ++c) acc[a][c] = __fmul_rn(acc[a][c], alpha);
    }
    __syncthreads();  // p complete

    for (int kk = 0; kk < BK; ++kk) {
      float pa[4], vc[CB];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = ps[(ty + 16 * a) * LDP + kk];
#pragma unroll
      for (int c = 0; c < CB; ++c) vc[c] = vs[kk * LDV + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < CB; ++c)
          acc[a][c] = __fadd_rn(acc[a][c], __fmul_rn(pa[a], vc[c]));
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = i0 + ty + 16 * a;
    if (row >= S) continue;
    const float denom = fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int c = 0; c < CB; ++c)
      if (tx + 16 * c < cw)
        oh[static_cast<long long>(row) * q_stride + c0 + tx + 16 * c] =
            from_float<T>(__fdiv_rn(acc[a][c], denom));
  }
}

template <typename T, int HD, bool SPLIT = false>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int T_len, int N, int K, int h, int causal, int window,
           cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * static_cast<int>(sizeof(float));
  auto kernel = flash_attention_kernel<T, HD, SPLIT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long slices = SPLIT ? (h + HD - 1) / HD : 1;
  const long long blocks = (S + BQ - 1) / BQ * slices;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), N, B);
  // h^-1/2 (the true h, not HD) rounded once to float32, as the plain
  // version's scalar is
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(h)));
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, T_len, N, K, h,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_h(const void* q, const void* k, const void* v, void* out, int B,
             int S, int T_len, int N, int K, int h, int causal, int window,
             cudaStream_t s) {
  if (h <= 64)
    return launch<T, 64>(q, k, v, out, B, S, T_len, N, K, h, causal, window,
                         s);
  if (h <= 128)
    return launch<T, 128>(q, k, v, out, B, S, T_len, N, K, h, causal, window,
                          s);
  if (h <= 256)
    return launch<T, 256>(q, k, v, out, B, S, T_len, N, K, h, causal, window,
                          s);
  return launch<T, 256, true>(q, k, v, out, B, S, T_len, N, K, h, causal,
                              window, s);
}

}  // namespace

// q/out (B, S, N, h), k/v (B, T, K, h), contiguous, in float32 (dtype 0),
// bfloat16 (1) or float16 (2); any h >= 1.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int T_len, int N, int K, int h,
                                      int causal, int window, int dtype,
                                      void* stream) {
  if (B <= 0 || S <= 0 || N <= 0) return 0;
  if (h <= 0 || B > 65535 || N > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_h<float>(q, k, v, out, B, S, T_len, N, K, h, causal,
                             window, s);
    case 1:
      return launch_h<__nv_bfloat16>(q, k, v, out, B, S, T_len, N, K, h,
                                     causal, window, s);
    case 2:
      return launch_h<__half>(q, k, v, out, B, S, T_len, N, K, h, causal,
                              window, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
