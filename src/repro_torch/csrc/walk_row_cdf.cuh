// The row-CDF inversion shared by the sparse and dense walk kernels.
//
// One warp inverts one walk's float32 row of `len` columns under the
// port's row-CDF rule: cdf[j] = cdf[j-1] + row[j] added left to right in
// float32, thr = u * cdf[len-1] rounded once, the pick count(cdf < thr).
// Rows are non-negative.  Two exact facts keep the answer bitwise equal to
// the sequential version while the warp skips the zeros:
//
//  1. acc + 0.0f == acc for every acc >= 0 under round-to-nearest (also
//     for denormals and -0.0; the build flushes nothing to zero), so the
//     chain over the nonzero entries only, in column order, gives every
//     prefix the full chain gives.
//  2. The rounded CDF never decreases, so for thr > 0 the count is the
//     column of the first entry whose running sum reaches thr, and that
//     entry is nonzero; for thr <= 0 (or NaN) the count is 0.
//
// The row is read in segments of SEG = 128 columns, coalesced: 16-byte
// vector loads (lane l holds columns 4l .. 4l+3) when the row's base is
// 16-byte aligned, else scalar loads (lane l holds columns l + 32k).
// BATCH segments are loaded before any is added, so several loads are in
// flight per warp.  A segment's nonzeros are packed into shared memory in
// column order (ballots and popcounts give each one its rank), and every
// lane runs the same add chain over them from shared memory (broadcast
// reads), so all lanes hold the same running sum.  The segments fall into
// at most 32 checkpoint blocks; lane j keeps the sum at the end of block
// j.  Once the total is known, one ballot finds the first block whose
// checkpoint reaches thr, and only that block is read and added again
// (from its predecessor's checkpoint, so with the same prefixes), stopping
// at the first crossing.  The add chain is the dependent part: one
// float32 add per nonzero entry, plus one block again.
//
// A warp per walk at every width, the narrow bucket widths too: a group of
// fewer lanes would put several walks in one warp, whose add chains and
// ballots diverge and then run one after another.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace walk_row_cdf {

constexpr int V = 4;            // columns a lane holds per segment
constexpr int SEG = 32 * V;     // columns a segment covers
constexpr int BATCH = 4;        // segments loaded before any is added
constexpr unsigned FULL = 0xffffffffu;

// This lane's V entries of segment s, zeros past len (which fact 1 skips).
__device__ __forceinline__ void load_segment(const float* row, int len, int s,
                                             int lane, bool vec,
                                             float (&x)[V]) {
  const int base = s * SEG;
  if (vec) {
    const int c = base + V * lane;
    if (c + V <= len) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(row + c));
      x[0] = q.x;
      x[1] = q.y;
      x[2] = q.z;
      x[3] = q.w;
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) x[k] = c + k < len ? __ldg(row + c + k) : 0.0f;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = base + 32 * k + lane;
      x[k] = c < len ? __ldg(row + c) : 0.0f;
    }
  }
}

// acc + s[0] + s[1] + ... + s[n-1], one add at a time in that order, the
// loads (16-byte, from the warp's shared buffer) grouped ahead of the adds.
__device__ __forceinline__ float add_run(float acc, const float* s, int n) {
  int i = 0;
#pragma unroll 2
  for (; i + 16 <= n; i += 16) {
    float e[16];
#pragma unroll
    for (int k = 0; k < 16; k += 4) {
      const float4 q = *reinterpret_cast<const float4*>(s + i + k);
      e[k] = q.x;
      e[k + 1] = q.y;
      e[k + 2] = q.z;
      e[k + 3] = q.w;
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) acc = __fadd_rn(acc, e[k]);
  }
#pragma unroll 4
  for (; i < n; ++i) acc = __fadd_rn(acc, s[i]);
  return acc;
}

// Adds segment s's nonzero entries to acc in column order.  With SEARCH,
// stops at the first running sum that reaches thr and returns its column;
// otherwise (or if none does) returns -1.  Uniform across the warp.
template <bool SEARCH>
__device__ __forceinline__ int add_segment(int lane, const float (&x)[V],
                                           int s, bool vec, float* s_val,
                                           int* s_col, float& acc,
                                           float thr) {
  bool nz[V];
  unsigned b[V];
  int n = 0;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    nz[k] = x[k] != 0.0f;
    b[k] = __ballot_sync(FULL, nz[k]);
    n += __popc(b[k]);
  }
  if (n == 0) return -1;
  // each nonzero's rank in column order within the segment
  const unsigned below = (1u << lane) - 1u;
  const int base = s * SEG;
  int r = 0;
  if (vec) {  // lane l holds columns V*l + k: all of lower lanes come first
#pragma unroll
    for (int k = 0; k < V; ++k) r += __popc(b[k] & below);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (nz[k]) {
        s_val[r] = x[k];
        if (SEARCH) s_col[r] = base + V * lane + k;
        ++r;
      }
    }
  } else {  // lane l holds columns 32*k + l: all of lower k come first
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (nz[k]) {
        const int rk = r + __popc(b[k] & below);
        s_val[rk] = x[k];
        if (SEARCH) s_col[rk] = base + 32 * k + lane;
      }
      r += __popc(b[k]);
    }
  }
  __syncwarp();
  int found = -1;
  if (SEARCH) {
    for (int i = 0; i < n && found < 0; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(s_val + i);
      const float e[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (found < 0 && i + k < n) {
          acc = __fadd_rn(acc, e[k]);
          if (!(acc < thr)) found = s_col[i + k];
        }
      }
    }
  } else {
    acc = add_run(acc, s_val, n);
  }
  __syncwarp();  // the buffer is read before the next segment packs
  return found;
}

// count(cdf < *u * cdf[len-1]) over row[0, len) under the row-CDF rule, in
// 0 .. len (len only if no prefix reaches a positive threshold, which a
// non-negative row and u < 1 never give).  Every lane of the warp calls it
// with the same arguments and gets the same answer; s_val and s_col hold
// SEG entries each (16-byte aligned), the warp's own.  *u is read after
// the total, so it holds no register across the row's loop.
__device__ __forceinline__ int row_cdf_count(int lane, const float* row,
                                             int len, const float* u,
                                             float* s_val, int* s_col) {
  const bool vec = (reinterpret_cast<uintptr_t>(row) & 15u) == 0;
  const int nseg = (len + SEG - 1) / SEG;
  const int per = (nseg + 31) / 32;  // segments per checkpoint block
  float acc = 0.0f;
  float cp = 0.0f;  // lane j: the sum at the end of block j (total past it)
  int block = 0, in_block = 0;
  for (int s0 = 0; s0 < nseg; s0 += BATCH) {
    float x[BATCH][V];
#pragma unroll
    for (int t = 0; t < BATCH; ++t)
      if (s0 + t < nseg) load_segment(row, len, s0 + t, lane, vec, x[t]);
#pragma unroll
    for (int t = 0; t < BATCH; ++t) {
      const int s = s0 + t;
      if (s < nseg) {
        add_segment<false>(lane, x[t], s, vec, s_val, s_col, acc, 0.0f);
        if (++in_block == per || s + 1 == nseg) {
          if (lane >= block) cp = acc;
          ++block;
          in_block = 0;
        }
      }
    }
  }
  const float thr = __fmul_rn(__ldg(u), acc);
  if (!(thr > 0.0f)) return 0;
  const unsigned hit = __ballot_sync(FULL, !(cp < thr));
  if (hit == 0) return len;
  const int j = __ffs(hit) - 1;
  const float before = __shfl_sync(FULL, cp, j > 0 ? j - 1 : 0);
  acc = j > 0 ? before : 0.0f;
  const int s_end = min((j + 1) * per, nseg);
  for (int s = j * per; s < s_end; ++s) {
    float x[V];
    load_segment(row, len, s, lane, vec, x);
    const int c = add_segment<true>(lane, x, s, vec, s_val, s_col, acc, thr);
    if (c >= 0) return c;
  }
  return len;
}

}  // namespace walk_row_cdf
