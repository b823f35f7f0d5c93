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
// The row-CDF rule: the CDF is a sequential, left-to-right float32
// accumulation along the row (cdf[j] = cdf[j-1] + row[j]), the order the
// plain version's `row_cdf` uses.  Pass 1 sums the whole row to get the
// total; pass 2 re-accumulates and stops at the first cdf >= u * total.
// Rows are non-negative, so the CDF is non-decreasing and that stop index
// equals count(cdf < u * total).
//
// What bounds it: every row is read in full once (pass 1), and in part
// again (pass 2, usually from L1/L2), plus one neighbor id per walk.  One
// thread per walk (256 a block, the tail masked, no padding of W); each
// thread walks its own row, so a warp's loads at one column are strided by
// the row width — uncoalesced, one 32-byte sector per thread per 8
// columns.  Simple and correct first; a warp-per-row layout is the lever.
//
// Numerics: built with --fmad=false and without fast math; every add and
// the threshold product round alone.  Offsets into the tiles are 64-bit.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;

__global__ void __launch_bounds__(BLOCK) walk_transition_sparse_kernel(
    const float* __restrict__ rows,     // (W, width) P_IS rows
    const int* __restrict__ neigh_rows, // (W, width) padded neighbor rows
    const float* __restrict__ u_mh,     // (W,) the U_MH uniform per walk
    int* __restrict__ v_mh,             // (W,) out
    int num_walks, int width) {
  const int w = blockIdx.x * BLOCK + threadIdx.x;
  if (w >= num_walks) return;
  const long long base = static_cast<long long>(w) * width;
  const float* row = rows + base;
  float total = 0.0f;
  for (int j = 0; j < width; ++j) total = __fadd_rn(total, __ldg(row + j));
  const float thr = __fmul_rn(__ldg(u_mh + w), total);
  float acc = 0.0f;
  int idx = 0;
  for (; idx < width; ++idx) {
    acc = __fadd_rn(acc, __ldg(row + idx));
    if (!(acc < thr)) break;
  }
  v_mh[w] = __ldg(neigh_rows + base + min(idx, width - 1));
}

}  // namespace

extern "C" int walk_transition_sparse_launch(
    const void* rows, const void* neigh_rows, const void* u_mh, void* v_mh,
    int num_walks, int width, void* stream) {
  if (num_walks <= 0) return 0;
  const int grid = (num_walks + BLOCK - 1) / BLOCK;
  walk_transition_sparse_kernel<<<grid, BLOCK, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const int*>(neigh_rows),
      static_cast<const float*>(u_mh), static_cast<int*>(v_mh), num_walks,
      width);
  return static_cast<int>(cudaGetLastError());
}
