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
// Design: a warp per walk, 8 walks a block, so W=2048 walks fill the
// card.  A walk whose flag is 0 reads only the first deg(v) entries of its
// row: the pads past them are exact zeros, which change no prefix and are
// never counted (u * total <= total), and they repeat v in the neighbor
// table, so stopping at deg(v) gives the full-width plain version's
// answer.  The warp reads those entries coalesced and inverts them with
// walk_row_cdf.cuh, which keeps the row-CDF rule bit for bit by two exact
// facts: adding 0.0f to a non-negative sum changes no bit (so the chain
// runs over the nonzero entries only), and the rounded CDF never
// decreases (so the pick is the first running sum that reaches u * total,
// found by a ballot over block checkpoints and one block added again).
// A walk whose flag is set takes the Lévy branch on the warp's lane 0,
// exactly as before: log1pf, __fdiv_rn, ceilf, the clamp, then d hops.
//
// What bounds it: the dependent chain, not bytes (a few hundred KB a
// launch).  Per MH walk: node -> degree -> row -> one add per nonzero
// entry (a hub's ~1200) -> neighbor id; per jumping walk, 2 dependent
// loads per hop (degree, neighbor id), up to 2r.  The slowest walk sets
// the kernel's time.
//
// Numerics: built with --fmad=false and without fast math (no flush to
// zero), as the ragged kernel.  Row offsets v * max_deg are 64-bit:
// n * max_deg exceeds 2^31 on million-node hub graphs.

#include <cuda_runtime.h>

#include "walk_row_cdf.cuh"

namespace {

using walk_row_cdf::SEG;

constexpr int U_JUMP = 0;
constexpr int U_MH = 1;
constexpr int U_DIST = 2;
constexpr int U_HOP0 = 3;
constexpr int WARPS = 8;  // walks (warps) per block

__global__ void __launch_bounds__(32 * WARPS) walk_transition_dense_kernel(
    const int* __restrict__ nodes,       // (W,) current node per walk
    const float* __restrict__ row_probs, // (n, max_deg) P_IS rows, pads 0
    const int* __restrict__ neighbors,   // (n, max_deg) ids, pads = row id
    const int* __restrict__ degrees,     // (n,) true degrees
    const float* __restrict__ uniforms,  // (W, 3 + r), slot 0 = jump flag
    const float* __restrict__ den_ptr,   // (1,) float32 log(1 - p_d)
    int* __restrict__ next_nodes,        // (W,) out
    int* __restrict__ hops,              // (W,) out
    int num_walks, int max_deg, int r, float z) {
  __shared__ __align__(16) float s_val[WARPS * SEG];
  __shared__ int s_col[WARPS * SEG];
  const int lane = static_cast<int>(threadIdx.x & 31u);
  const int slot = static_cast<int>(threadIdx.x >> 5);
  const int w = blockIdx.x * WARPS + slot;
  if (w >= num_walks) return;  // the whole warp leaves together
  const float* u = uniforms + static_cast<long long>(w) * (U_HOP0 + r);
  const int v = __ldg(nodes + w);

  if (!(__ldg(u + U_JUMP) > 0.5f)) {
    const long long base = static_cast<long long>(v) * max_deg;
    const int idx = walk_row_cdf::row_cdf_count(
        lane, row_probs + base, __ldg(degrees + v), u + U_MH,
        s_val + slot * SEG, s_col + slot * SEG);
    if (lane == 0) {
      next_nodes[w] = __ldg(neighbors + base + min(idx, max_deg - 1));
      hops[w] = 1;
    }
    return;
  }
  if (lane != 0) return;

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
  const int grid = (num_walks + WARPS - 1) / WARPS;
  walk_transition_dense_kernel<<<grid, 32 * WARPS, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nodes), static_cast<const float*>(row_probs),
      static_cast<const int*>(neighbors), static_cast<const int*>(degrees),
      static_cast<const float*>(uniforms), static_cast<const float*>(den),
      static_cast<int*>(next_nodes), static_cast<int*>(hops), num_walks,
      max_deg, r, z);
  return static_cast<int>(cudaGetLastError());
}
