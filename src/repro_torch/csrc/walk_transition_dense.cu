// Fused MHLJ step over the resident padded tables, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/walk_transition/kernel.py
// `walk_transition` (body `_kernel`), the engine's dense layout: per walk
// at node v, the MH move inverts row v of the (n, max_deg) P_IS table,
// d ~ TruncGeom(p_d, r) comes from the closed-form inverse CDF, d uniform
// hops run through the (n, max_deg) neighbor table, and the jump flag
// selects.  Its plain version is repro_torch/core/engine.py
// `mhlj_transition_math` on `row_probs[nodes]`, and the two agree bit for
// bit.
//
// The MH move follows the row-CDF rule (a sequential, left-to-right
// float32 accumulation along the row) and reads only the row's first
// deg(v) entries: the pads past them are exact zeros, which leave every
// prefix sum unchanged and are never counted (u * total <= total), and
// they repeat v in the neighbor table — so stopping at deg(v) gives the
// full-width plain version's answer.  Pass 2 stops at the first
// cdf >= u * total (rows are non-negative, the CDF non-decreasing).
//
// What bounds it: a short dependent chain of scattered loads per walk
// (node -> degree -> about deg(v) row entries -> neighbor id, or node ->
// degree -> neighbor id per hop).  One thread per walk (256 a block, the
// tail masked); each walk loads only the branch its jump flag selects;
// every table read goes through the read-only path (__ldg).
//
// Numerics: built with --fmad=false and without fast math, as the ragged
// kernel.  Row offsets v * max_deg are 64-bit: n * max_deg exceeds 2^31 on
// million-node hub graphs.

#include <cuda_runtime.h>

namespace {

constexpr int U_JUMP = 0;
constexpr int U_MH = 1;
constexpr int U_DIST = 2;
constexpr int U_HOP0 = 3;
constexpr int BLOCK = 256;

__global__ void __launch_bounds__(BLOCK) walk_transition_dense_kernel(
    const int* __restrict__ nodes,       // (W,) current node per walk
    const float* __restrict__ row_probs, // (n, max_deg) P_IS rows, pads 0
    const int* __restrict__ neighbors,   // (n, max_deg) ids, pads = row id
    const int* __restrict__ degrees,     // (n,) true degrees
    const float* __restrict__ uniforms,  // (W, 3 + r), slot 0 = jump flag
    const float* __restrict__ den_ptr,   // (1,) float32 log(1 - p_d)
    int* __restrict__ next_nodes,        // (W,) out
    int* __restrict__ hops,              // (W,) out
    int num_walks, int max_deg, int r, float z) {
  const int w = blockIdx.x * BLOCK + threadIdx.x;
  if (w >= num_walks) return;
  const float* u = uniforms + static_cast<long long>(w) * (U_HOP0 + r);
  const int v = __ldg(nodes + w);

  if (!(__ldg(u + U_JUMP) > 0.5f)) {
    const long long base = static_cast<long long>(v) * max_deg;
    const float* row = row_probs + base;
    const int deg = __ldg(degrees + v);
    float total = 0.0f;
    for (int j = 0; j < deg; ++j) total = __fadd_rn(total, __ldg(row + j));
    const float thr = __fmul_rn(__ldg(u + U_MH), total);
    float acc = 0.0f;
    int idx = 0;
    for (; idx < deg; ++idx) {
      acc = __fadd_rn(acc, __ldg(row + idx));
      if (!(acc < thr)) break;
    }
    next_nodes[w] = __ldg(neighbors + base + min(idx, max_deg - 1));
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
    v_cur = __ldg(neighbors + static_cast<long long>(v_cur) * max_deg +
                  hop_idx);
  }
  next_nodes[w] = v_cur;
  hops[w] = d;
}

}  // namespace

extern "C" int walk_transition_dense_launch(
    const void* nodes, const void* row_probs, const void* neighbors,
    const void* degrees, const void* uniforms, const void* den,
    void* next_nodes, void* hops, int num_walks, int max_deg, int r, float z,
    void* stream) {
  if (num_walks <= 0) return 0;
  const int grid = (num_walks + BLOCK - 1) / BLOCK;
  walk_transition_dense_kernel<<<grid, BLOCK, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nodes), static_cast<const float*>(row_probs),
      static_cast<const int*>(neighbors), static_cast<const int*>(degrees),
      static_cast<const float*>(uniforms), static_cast<const float*>(den),
      static_cast<int*>(next_nodes), static_cast<int*>(hops), num_walks,
      max_deg, r, z);
  return static_cast<int>(cudaGetLastError());
}
