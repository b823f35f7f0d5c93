// Fused MHLJ step on the ragged (flat CSR) layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/walk_transition/kernel.py
// `walk_transition_ragged` (body `_ragged_kernel`): per walk, a binary
// search of the walk's own per-edge CDF segment for u_mh * total (the MH
// move), d ~ TruncGeom(p_d, r) by the closed-form inverse CDF, d uniform
// hops through the CSR arrays (the Levy jump), and the jump/MH select.
// Its plain version is repro_torch/kernels/walk_transition/ref.py, and the
// two must agree bit for bit on the same CDF and uniforms.
//
// What bounds it: per walk a dependent chain of about
// search_iters + 2r + 3 scattered 4-byte loads (node -> indptr/degree ->
// CDF probes -> neighbor id, or node -> degree/indptr -> neighbor id per
// hop), each costing one 32-byte sector of device memory.  The bytes are
// few; the chain's latency is what sets the time at small W.  The design:
// one thread per walk (256 threads a block, the tail masked, no padding of
// W), so every walk's chain runs independently and enough walks are in
// flight to hide latency; each walk loads only the branch its jump flag
// selects; every table read goes through the read-only path (__ldg).
//
// Numerics: built with --fmad=false and without fast math, so u * total,
// -u * z and u * deg round as separate float32 products, as the plain
// version's do.  All indices are int32 (the wrapper rejects nnz >= 2^31).

#include <cuda_runtime.h>

namespace {

constexpr int U_JUMP = 0;
constexpr int U_MH = 1;
constexpr int U_DIST = 2;
constexpr int U_HOP0 = 3;
constexpr int BLOCK = 256;

__global__ void __launch_bounds__(BLOCK) walk_transition_ragged_kernel(
    const int* __restrict__ nodes,       // (W,) current node per walk
    const int* __restrict__ indptr,      // (n+1,) CSR row pointers
    const int* __restrict__ degrees,     // (n,) true degrees
    const int* __restrict__ indices,     // (nnz,) CSR neighbor ids
    const float* __restrict__ edge_cdf,  // (nnz,) flat per-edge CDF
    const float* __restrict__ uniforms,  // (W, 3 + r), slot 0 = jump flag
    const float* __restrict__ den_ptr,   // (1,) float32 log(1 - p_d)
    int* __restrict__ next_nodes,        // (W,) out
    int* __restrict__ hops,              // (W,) out
    int num_walks, int r, float z, int search_iters) {
  const int w = blockIdx.x * BLOCK + threadIdx.x;
  if (w >= num_walks) return;
  const float* u = uniforms + static_cast<long long>(w) * (U_HOP0 + r);
  const int v = __ldg(nodes + w);

  if (!(__ldg(u + U_JUMP) > 0.5f)) {
    // MH move: count of segment entries < u_mh * total, clamped to deg-1.
    const int start = __ldg(indptr + v);
    const int deg = __ldg(degrees + v);
    const float total = __ldg(edge_cdf + start + deg - 1);
    const float t = __fmul_rn(__ldg(u + U_MH), total);
    int lo = 0, hi = deg;
    for (int it = 0; it < search_iters && lo < hi; ++it) {
      const int mid = (lo + hi) >> 1;
      const float c = __ldg(edge_cdf + start + min(mid, deg - 1));
      if (c < t) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    next_nodes[w] = __ldg(indices + start + min(lo, deg - 1));
    hops[w] = 1;
    return;
  }

  // Levy jump: d = clamp(ceil(log1p(-u * z) / log(1 - p_d)), 1, r).
  const float x = __fmul_rn(-__ldg(u + U_DIST), z);
  const float q = __fdiv_rn(log1pf(x), __ldg(den_ptr));
  int d = static_cast<int>(ceilf(q));
  d = max(1, min(d, r));
  int v_cur = v;
  for (int j = 0; j < d; ++j) {
    const int deg_c = __ldg(degrees + v_cur);
    const float uh = __ldg(u + U_HOP0 + j);
    const int hop_idx =
        min(static_cast<int>(__fmul_rn(uh, static_cast<float>(deg_c))),
            deg_c - 1);
    v_cur = __ldg(indices + __ldg(indptr + v_cur) + hop_idx);
  }
  next_nodes[w] = v_cur;
  hops[w] = d;
}

}  // namespace

extern "C" int walk_transition_ragged_launch(
    const void* nodes, const void* indptr, const void* degrees,
    const void* indices, const void* edge_cdf, const void* uniforms,
    const void* den, void* next_nodes, void* hops, int num_walks, int r,
    float z, int search_iters, void* stream) {
  if (num_walks <= 0) return 0;
  const int grid = (num_walks + BLOCK - 1) / BLOCK;
  walk_transition_ragged_kernel<<<grid, BLOCK, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nodes), static_cast<const int*>(indptr),
      static_cast<const int*>(degrees), static_cast<const int*>(indices),
      static_cast<const float*>(edge_cdf),
      static_cast<const float*>(uniforms), static_cast<const float*>(den),
      static_cast<int*>(next_nodes), static_cast<int*>(hops), num_walks, r,
      z, search_iters);
  return static_cast<int>(cudaGetLastError());
}
