// MH-move CDF inversion over gathered row tiles, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/walk_transition/kernel.py
// `walk_transition_sparse` (body `_sparse_kernel`): per walk, the index
// of u_mh * total in its row's CDF, clamped to width - 1, and the
// neighbor at that index.  It is the MH move of the engine's sparse
// layout and the tile op of the bucketed dispatch (one launch per degree
// bucket, at that bucket's width).  Its plain version is
// repro_torch/core/engine.py `mh_cdf_invert`, and the two agree bit for
// bit on the same tiles.
//
// Design: a warp per walk, 8 walks a block, so W=2048 walks at width
// 1196 are 2048 warps over all SMs.  The warp reads its row coalesced
// (16-byte loads where the row's base is aligned) and inverts it with
// walk_row_cdf.cuh: the sequential float32 chain runs over the row's
// nonzero entries only, and the pick is the first running sum that
// reaches u * total.  That keeps the row-CDF rule bit for bit by two
// exact facts (walk_row_cdf.cuh): adding 0.0f to a non-negative sum
// changes no bit, and the rounded CDF never decreases, so the first
// crossing is the count of cdf < thr and lies on a nonzero entry.  Then
// lane 0 clamps and reads one neighbor id.
//
// What bounds it: not the bytes.  Every row entry is read once (the total
// needs them all), 4.9 KB a walk at width 1196, and the one block that is
// added again comes from L1/L2; at W=2048 that read is a small part of
// the launch's measured time (chip_smoke.py phase 4, PERF.md).  The time
// is set by a per-launch floor, on which the narrow bucket tiles sit, and
// by the dependent part, one add per nonzero: a P_IS tile row holds
// deg(v) nonzeros at most, so only a hub walk's chain (~1200 adds) is
// long, and where a walk sits at a hub that chain sets the launch's time.
//
// Gate: `live`, when not null, is one device byte read by every warp
// before anything else.  Where it is 0 the launch writes v_mh = 0 and
// reads no tile: the compacted bucketed dispatch puts both of its
// branches (the compacted tiles and the full-width fallback) into one
// CUDA graph and lets the device's overflow flag pick, in place of the
// reference's lax.cond (repro/core/engine.py, `_bucketed_mh_compacted`).
//
// Numerics: built with --fmad=false and without fast math (no flush to
// zero); every add and the threshold product round alone.  Offsets into
// the tiles are 64-bit.

#include <cuda_runtime.h>

#include "walk_row_cdf.cuh"

namespace {

using walk_row_cdf::SEG;

constexpr int WARPS = 8;  // walks (warps) per block

__global__ void __launch_bounds__(32 * WARPS) walk_transition_sparse_kernel(
    const float* __restrict__ rows,     // (W, width) P_IS rows
    const int* __restrict__ neigh_rows, // (W, width) padded neighbor rows
    const float* __restrict__ u_mh,     // (W,) the U_MH uniform per walk
    const unsigned char* __restrict__ live,  // 1-byte gate, or null
    int* __restrict__ v_mh,             // (W,) out
    int num_walks, int width) {
  __shared__ __align__(16) float s_val[WARPS * SEG];
  __shared__ int s_col[WARPS * SEG];
  const int lane = static_cast<int>(threadIdx.x & 31u);
  const int slot = static_cast<int>(threadIdx.x >> 5);
  const int w = blockIdx.x * WARPS + slot;
  if (w >= num_walks) return;  // the whole warp leaves together
  if (live != nullptr && *live == 0) {  // gated off: no tile is read
    if (lane == 0) v_mh[w] = 0;
    return;
  }
  const long long base = static_cast<long long>(w) * width;
  const int idx = walk_row_cdf::row_cdf_count(
      lane, rows + base, width, u_mh + w, s_val + slot * SEG,
      s_col + slot * SEG);
  if (lane == 0) v_mh[w] = __ldg(neigh_rows + base + min(idx, width - 1));
}

}  // namespace

extern "C" int walk_transition_sparse_launch(
    const void* rows, const void* neigh_rows, const void* u_mh,
    const void* live, void* v_mh, int num_walks, int width, void* stream) {
  if (num_walks <= 0) return 0;
  if (width <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (num_walks + WARPS - 1) / WARPS;
  walk_transition_sparse_kernel<<<grid, 32 * WARPS, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const int*>(neigh_rows),
      static_cast<const float*>(u_mh), static_cast<const unsigned char*>(live),
      static_cast<int*>(v_mh), num_walks, width);
  return static_cast<int>(cudaGetLastError());
}
