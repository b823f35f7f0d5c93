// Fused RMSNorm over rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rmsnorm/kernel.py `rmsnorm_fused`
// (body `_kernel`): per row of x (R, D), the float32 mean square, rsqrt of
// it plus eps, the float32 scale, and a cast back to x's dtype.  Its plain
// version is repro_torch/kernels/rmsnorm/ref.py `rmsnorm_ref`.
//
// What bounds it: bytes.  Each row is read once and written once, with a
// few operations per element.  Three kernels, chosen by the wrapper from
// the shape (repro_torch/kernels/rmsnorm/ops.py `kernel_for`):
// - `warp` (D <= 2048): one warp per row, two rows per 64-thread CTA.
//   Each lane loads its 16-byte vectors (8 bf16 or float16, or 4 float32)
//   of the row,
//   keeps them in registers, sums their squares, reduces with warp
//   shuffles alone (no shared memory, no __syncthreads), then scales the
//   held values with the scale read as float4 and stores 16 bytes at a
//   time.  x is read from device memory once.  Small CTAs free their slot
//   as soon as their two rows are done; eight rows per 256-thread CTA lost
//   to F.rms_norm at (16384, 1024) float32 (PERF.md).
// - `cta` (D > 2048, at most 2048 vectors: bf16 and float16 D <= 16384,
//   float32 D <= 8192): one 256-thread CTA per row, the same vectors held in registers,
//   one shared-memory step for the row sum.
// - `scalar`: D not a multiple of the vector width, a base pointer that is
//   not 16-byte aligned, or a row too long to hold: one 256-thread CTA per
//   row with 2- or 4-byte loads, the row read a second time for the scale.
//
// x is loaded and out stored with the streaming (evict-first) cache hint:
// neither is read again, and the scale stays in L1.
//
// Element types: float32, bfloat16 and float16 (one template, the dtype
// code from the wrapper); a 2-byte row has the same vector width in either
// 16-bit type, so the wrapper's choice of kernel does not depend on which.
//
// Numerics: float32 throughout; the row's sum order is the kernel's (not
// PyTorch's); built with --fmad=false and without fast math.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;            // threads of the cta and scalar kernels
constexpr int WARPS = BLOCK / 32;
constexpr int ROWS_PER_CTA = 2;       // the warp kernel: one warp per row

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

// 16 bytes of T as E floats, and back.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int E = 4;
  __device__ static void unpack(const uint4& u, float (&f)[E]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float (&f)[E]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ static void unpack(const uint4& u, float (&f)[E]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 -> float32 is a shift, exactly
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint32_t pack2(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  __device__ static uint4 pack(const float (&f)[E]) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                      pack2(f[6], f[7]));
  }
};
template <>
struct Vec<__half> {
  static constexpr int E = 8;
  __device__ static void unpack(const uint4& u, float (&f)[E]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // float16 -> float32 is exact
      const float2 v = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
  __device__ static uint32_t pack2(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  __device__ static uint4 pack(const float (&f)[E]) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                      pack2(f[6], f[7]));
  }
};

// Sum of squares of the held vectors buf[i] = row vector lane + i * step.
template <typename T, int V>
__device__ __forceinline__ float load_row(const uint4* __restrict__ row,
                                          uint4 (&buf)[V], int first,
                                          int step, int nv) {
  constexpr int E = Vec<T>::E;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = first + i * step;
    if (c < nv) {
      buf[i] = __ldcs(row + c);
      float f[E];
      Vec<T>::unpack(buf[i], f);
#pragma unroll
      for (int e = 0; e < E; ++e) sq = __fadd_rn(sq, __fmul_rn(f[e], f[e]));
    }
  }
  return sq;
}

// x * r * scale for the held vectors, stored 16 bytes at a time.
template <typename T, int V>
__device__ __forceinline__ void store_row(uint4* __restrict__ orow,
                                          const float4* __restrict__ scale,
                                          const uint4 (&buf)[V], float r,
                                          int first, int step, int nv) {
  constexpr int E = Vec<T>::E;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = first + i * step;
    if (c < nv) {
      float f[E], w[E];
      Vec<T>::unpack(buf[i], f);
#pragma unroll
      for (int q = 0; q < E / 4; ++q) {
        const float4 s4 = __ldg(scale + c * (E / 4) + q);
        w[4 * q] = s4.x;
        w[4 * q + 1] = s4.y;
        w[4 * q + 2] = s4.z;
        w[4 * q + 3] = s4.w;
      }
#pragma unroll
      for (int e = 0; e < E; ++e) f[e] = __fmul_rn(__fmul_rn(f[e], r), w[e]);
      __stcs(orow + c, Vec<T>::pack(f));
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float inv_rms(float total, int d, float eps) {
  return rsqrtf(__fadd_rn(__fdiv_rn(total, static_cast<float>(d)), eps));
}

// One warp per row, ROWS_PER_CTA rows per CTA; V = vectors a lane holds.
template <typename T, int V>
__global__ void __launch_bounds__(ROWS_PER_CTA * 32) rmsnorm_warp_kernel(
    const T* __restrict__ x, const float* __restrict__ scale,
    T* __restrict__ out, int rows, int d, float eps) {
  const int row = blockIdx.x * ROWS_PER_CTA + threadIdx.x / 32;
  if (row >= rows) return;  // whole warps only: nothing below syncs the CTA
  const int lane = threadIdx.x % 32;
  const int nv = d / Vec<T>::E;
  const long long base = static_cast<long long>(row) * d;
  uint4 buf[V];
  const float sq = load_row<T, V>(reinterpret_cast<const uint4*>(x + base),
                                  buf, lane, 32, nv);
  const float r = inv_rms(warp_sum(sq), d, eps);
  store_row<T, V>(reinterpret_cast<uint4*>(out + base),
                  reinterpret_cast<const float4*>(scale), buf, r, lane, 32,
                  nv);
}

// One CTA per row; V = vectors a thread holds.
template <typename T, int V>
__global__ void __launch_bounds__(BLOCK) rmsnorm_cta_kernel(
    const T* __restrict__ x, const float* __restrict__ scale,
    T* __restrict__ out, int d, float eps) {
  __shared__ float warp_sums[WARPS];
  const int nv = d / Vec<T>::E;
  const long long base = static_cast<long long>(blockIdx.x) * d;
  uint4 buf[V];
  const float sq =
      warp_sum(load_row<T, V>(reinterpret_cast<const uint4*>(x + base), buf,
                              threadIdx.x, BLOCK, nv));
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = sq;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) total = __fadd_rn(total, warp_sums[w]);
  store_row<T, V>(reinterpret_cast<uint4*>(out + base),
                  reinterpret_cast<const float4*>(scale), buf,
                  inv_rms(total, d, eps), threadIdx.x, BLOCK, nv);
}

// Any D: one CTA per row, scalar loads, two passes over the row.
template <typename T>
__global__ void __launch_bounds__(BLOCK) rmsnorm_scalar_kernel(
    const T* __restrict__ x, const float* __restrict__ scale,
    T* __restrict__ out, int d, float eps) {
  __shared__ float warp_sums[WARPS];
  __shared__ float inv;
  const long long base = static_cast<long long>(blockIdx.x) * d;
  const T* row = x + base;
  float sq = 0.0f;
  for (int j = threadIdx.x; j < d; j += BLOCK) {
    const float v = to_float(row[j]);
    sq = __fadd_rn(sq, __fmul_rn(v, v));
  }
  sq = warp_sum(sq);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = sq;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int w = 0; w < WARPS; ++w) total = __fadd_rn(total, warp_sums[w]);
    inv = inv_rms(total, d, eps);
  }
  __syncthreads();
  const float r = inv;
  T* orow = out + base;
  for (int j = threadIdx.x; j < d; j += BLOCK) {
    const float v = to_float(row[j]);
    orow[j] = from_float<T>(__fmul_rn(__fmul_rn(v, r), __ldg(scale + j)));
  }
}

// The least power of two V >= the vectors a lane must hold (D <= 2048 is
// at most 8 bf16 or float16, or 16 float32, vectors a lane).
template <typename T>
int launch_warp(const T* x, const float* scale, T* out, int rows, int d,
                float eps, cudaStream_t s) {
  const int need = (d / Vec<T>::E + 31) / 32;
  const int grid = (rows + ROWS_PER_CTA - 1) / ROWS_PER_CTA;
  constexpr int threads = ROWS_PER_CTA * 32;
  if (need <= 1)
    rmsnorm_warp_kernel<T, 1><<<grid, threads, 0, s>>>(x, scale, out, rows, d, eps);
  else if (need <= 2)
    rmsnorm_warp_kernel<T, 2><<<grid, threads, 0, s>>>(x, scale, out, rows, d, eps);
  else if (need <= 4)
    rmsnorm_warp_kernel<T, 4><<<grid, threads, 0, s>>>(x, scale, out, rows, d, eps);
  else if (need <= 8)
    rmsnorm_warp_kernel<T, 8><<<grid, threads, 0, s>>>(x, scale, out, rows, d, eps);
  else if (need <= 16)
    rmsnorm_warp_kernel<T, 16><<<grid, threads, 0, s>>>(x, scale, out, rows, d, eps);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_cta(const T* x, const float* scale, T* out, int rows, int d,
               float eps, cudaStream_t s) {
  const int need = (d / Vec<T>::E + BLOCK - 1) / BLOCK;
  if (need <= 1)
    rmsnorm_cta_kernel<T, 1><<<rows, BLOCK, 0, s>>>(x, scale, out, d, eps);
  else if (need <= 2)
    rmsnorm_cta_kernel<T, 2><<<rows, BLOCK, 0, s>>>(x, scale, out, d, eps);
  else if (need <= 4)
    rmsnorm_cta_kernel<T, 4><<<rows, BLOCK, 0, s>>>(x, scale, out, d, eps);
  else if (need <= 8)
    rmsnorm_cta_kernel<T, 8><<<rows, BLOCK, 0, s>>>(x, scale, out, d, eps);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* xp, const void* sp, void* op, int rows, int d,
           float eps, int kernel, cudaStream_t s) {
  const T* x = static_cast<const T*>(xp);
  const float* scale = static_cast<const float*>(sp);
  T* out = static_cast<T*>(op);
  if (kernel == 1) return launch_warp<T>(x, scale, out, rows, d, eps, s);
  if (kernel == 2) return launch_cta<T>(x, scale, out, rows, d, eps, s);
  rmsnorm_scalar_kernel<T><<<rows, BLOCK, 0, s>>>(x, scale, out, d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16; kernel: 0 scalar, 1 warp per
// row, 2 CTA per row (see the note above).
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* out,
                              int rows, int d, float eps, int dtype,
                              int kernel, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, scale, out, rows, d, eps, kernel, s);
    case 1:
      return launch<__nv_bfloat16>(x, scale, out, rows, d, eps, kernel, s);
    case 2:
      return launch<__half>(x, scale, out, rows, d, eps, kernel, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
