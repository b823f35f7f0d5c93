// Fused RMSNorm over rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rmsnorm/kernel.py `rmsnorm_fused`
// (body `_kernel`): per row of x (R, D), the float32 mean square, rsqrt of
// it plus eps, the float32 scale, and a cast back to x's dtype.  Its plain
// version is repro_torch/kernels/rmsnorm/ref.py `rmsnorm_ref`.
//
// What bounds it: bytes.  Each row is read once from device memory (the
// second pass finds it in L1/L2) and written once, with a few operations
// per element.  One CTA of 256 threads per row: threads stride the row
// with coalesced loads, sum squares in float32, reduce by warp shuffles
// and one shared-memory step, then scale and store.  Simple first: no
// vector loads, no several rows per CTA.
//
// Numerics: float32 throughout, the row's reduction order is the CTA's
// (not PyTorch's); built with --fmad=false and without fast math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(BLOCK) rmsnorm_kernel(
    const T* __restrict__ x, const float* __restrict__ scale,
    T* __restrict__ out, int d, float eps) {
  __shared__ float warp_sums[BLOCK / 32];
  __shared__ float inv_rms;
  const long long base = static_cast<long long>(blockIdx.x) * d;
  const T* row = x + base;
  float sq = 0.0f;
  for (int j = threadIdx.x; j < d; j += BLOCK) {
    const float v = to_float(row[j]);
    sq = __fadd_rn(sq, __fmul_rn(v, v));
  }
  for (int off = 16; off > 0; off >>= 1)
    sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, off));
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = sq;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int w = 0; w < BLOCK / 32; ++w) total = __fadd_rn(total, warp_sums[w]);
    const float var = __fdiv_rn(total, static_cast<float>(d));
    inv_rms = rsqrtf(__fadd_rn(var, eps));
  }
  __syncthreads();
  const float r = inv_rms;
  T* orow = out + base;
  for (int j = threadIdx.x; j < d; j += BLOCK) {
    const float v = to_float(row[j]);
    orow[j] = from_float<T>(__fmul_rn(__fmul_rn(v, r), __ldg(scale + j)));
  }
}

}  // namespace

extern "C" int rmsnorm_launch(const void* x, const void* scale, void* out,
                              int rows, int d, float eps, int is_bf16,
                              void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    rmsnorm_kernel<__nv_bfloat16><<<rows, BLOCK, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
        static_cast<__nv_bfloat16*>(out), d, eps);
  } else {
    rmsnorm_kernel<float><<<rows, BLOCK, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<float*>(out), d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
