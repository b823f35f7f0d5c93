// Mamba-2 chunked SSD scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd/kernel.py `ssd_scan` (body
// `_kernel`).  Per (b, h) and per chunk of Q rows, with cum = cumsum(da):
//   att[i,j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j      for j <= i
//   y_i      = sum_j att[i,j] x_j + exp(cum_i) * (C_i @ state)
//   state    = exp(cum_Q) * state + sum_j B_j^T exp(cum_Q - cum_j) dt_j x_j
// with the (N, P) float32 state carried from chunk to chunk.  Its plain
// version is repro_torch/kernels/ssd/ref.py `ssd_scan_ref`.
//
// Design: the TPU kernel leans on its grid running in order to carry the
// state in VMEM.  Here one persistent CTA of 256 threads per (b, h, slab of
// at most 64 head channels) walks its chunks in order and keeps the state
// in shared memory (32 KB at N=128, P=64).  The state's columns are
// independent (output column p reads only x's column p and the state's
// column p), so a head_dim P > 64 runs as ceil(P/64) slabs, one CTA each,
// every column doing the same adds in the same order as at P <= 64; the
// scores C B^T are computed again in each slab's CTA.  Q x Q and Q x N do
// not fit at once (Q=256, N=128 would need 128 KB for each of B and C in
// float32), so a chunk is tiled in
// 64-row blocks: for each row block of C, the state term, then the
// lower-triangular column blocks of B and x (score tile through shared
// memory), then the y rows; after all row blocks, the state update over
// the column blocks.  Each thread owns a 4x4 micro-tile of every 64x64
// product (rows ty+16a, columns tx+16b), and a 4x4-per-16-rows tile of
// the state.  Shared memory is ~131 KB at N=128, Q=256 and ~227 KB at
// N=256, Q=256 (the state-update weights overwrite dt in place to fit), set
// through cudaFuncAttributeMaxDynamicSharedMemorySize.  At the prefill
// shape (B=4, H=32, P=64) that is 128 CTAs on 132 SMs.
//
// d_state: the thread tile covers 128 state rows (8 x 16) or, for N > 128,
// 256 (a second instantiation).  An N that is not a multiple of 16 is
// padded in shared memory to the next multiple: the B and C tiles' extra
// columns are zeros, so the padded state rows stay zero, and the products
// over the state run over n < N only.  Past N = 256 (or at N = 256 with a
// chunk past 288 rows) the whole state does not fit beside the tiles:
// `ssd_scan_pieced_kernel` (below) keeps it in a float32 scratch in device
// memory and sums over it in pieces of at most 256 rows, in the same order.
//
// Sizes: head_dim up to 65535 slabs of 64 channels (grid.y), any d_state,
// and a chunk up to ~23,000 rows (cum, dt and a 16-row piece in 227 KB);
// beyond those only device memory bounds them: the inputs, y, and for
// pieces the B*H*ceil(P/64)*N*64*4-byte scratch (at P = 512, N = 1024,
// B*H = 64: 0.13 GB).
//
// What bounds it: operations, on CUDA cores in float32 (about 21 MFLOP
// per chunk per head against 0.2 MB of inputs); no tensor cores yet.
//
// Numerics: float32 throughout, x/B/C read as float32, bfloat16 or
// float16 (one template; da and dt arrive as float32, the wrapper casting
// them as the TPU kernel does first), y written as float32, except the within-chunk cumsum: a per-lane
// sequential sum plus a warp scan in float64, rounded once to float32.
// In float32 that scan set the route's error at chunk >= 128 (up to 2.1x
// the plain version's distance to the float64 result at d_state 64, chunk
// 128, on an H100), since exp(cum_i - cum_j) turns cum's absolute rounding
// error into a relative error of the output.  Rounding cum once moves that
// error but does not remove it: under mamba2's decay (cum ~ -800 within a
// chunk, half an ulp 3e-5) either cumsum can land ahead at the largest
// error, by input (tests/test_torch_llm_kernels.py), and at mamba2's layer
// 0 on an H100 this route went from 1.0x to 1.39x the plain version's
// error, within the 2x rule.  Built with --fmad=false and without fast
// math.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;     // rows of a block of the chunk
constexpr int MAX_N = 256;   // state rows the larger thread tile covers
constexpr int LDX = TILE;    // x tile and state row stride (a slab's columns)
constexpr int MAX_SLABS = 65535;  // slabs of 64 head channels: grid.y's limit
constexpr int LDM = TILE + 1;
constexpr int MAX_SMEM = 232448;  // the opt-in shared memory of a block

// d_state rounded up to the thread tile's 16 rows
__host__ __device__ inline int padded_states(int n) {
  return (n + 15) / 16 * 16;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

__host__ __device__ inline int smem_floats(int q, int n) {
  const int np = padded_states(n), ldn = np + 1;
  return np * LDX           // state
         + 2 * TILE * ldn   // C and B tiles
         + TILE * LDX       // x tile
         + TILE * LDM       // score tile
         + 2 * q;           // cum, dt (then the state-update weights)
}

// rows [row0, row0 + 64) of a block with row stride `stride`, as float32
// with a row stride of ld, zeros past `rows` and past `width` (up to
// `cols`).
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int stride, int width, int cols,
                                          int row0, int rows) {
  for (int e = threadIdx.x; e < TILE * cols; e += THREADS) {
    const int r = e / cols, c = e % cols;
    const int gr = row0 + r;
    dst[r * ld + c] =
        (gr < rows && c < width)
            ? to_float(src[static_cast<long long>(gr) * stride + c])
            : 0.0f;
  }
}

// cum[0..Q) = the inclusive cumsum of da[0..Q) and dtv = dt[0..Q), by the
// whole CTA, synchronised after: each lane of warp 0 sums Q/32 consecutive
// values in order, then a warp scan of the lane totals, accumulated in
// float64 and rounded once (a float32 running sum is off by up to
// ulp(|cum|), ~1e-5 at cum ~ -100, which exp(cum_i - cum_j) turns into a
// relative error of the whole att row).
__device__ __forceinline__ void chunk_cum(float* cum, float* dtv,
                                          const float* da, const float* dt,
                                          int Q) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < Q; i += THREADS) {
    cum[i] = da[i];
    dtv[i] = dt[i];
  }
  __syncthreads();
  if (warp == 0) {
    const int per = (Q + 31) / 32;
    const int s0 = lane * per;
    double run = 0.0;
    for (int k = 0; k < per; ++k) {
      const int i = s0 + k;
      if (i < Q) run += static_cast<double>(cum[i]);
    }
    double incl = run;
    for (int off = 1; off < 32; off <<= 1) {
      const double t = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += t;
    }
    double excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.0;
    for (int k = 0; k < per; ++k) {
      const int i = s0 + k;
      if (i < Q) {
        excl += static_cast<double>(cum[i]);
        cum[i] = static_cast<float>(excl);
      }
    }
  }
  __syncthreads();
}

template <typename T, int TILE_N>
__global__ void __launch_bounds__(THREADS) ssd_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ da,
    const float* __restrict__ dt, const T* __restrict__ bmat,
    const T* __restrict__ cmat, float* __restrict__ y, int L, int P, int N,
    int Q) {
  extern __shared__ float smem[];
  const int np = padded_states(N), ldn = np + 1;
  float* st = smem;              // (np, LDX) state, columns >= pw stay 0
  float* ct = st + np * LDX;     // (64, np+1) C rows, columns >= N zero
  float* bt = ct + TILE * ldn;   // (64, np+1) B rows, columns >= N zero
  float* xt = bt + TILE * ldn;   // (64, LDX) x rows of this slab
  float* sm = xt + TILE * LDX;   // (64, 65) score tile
  float* cum = sm + TILE * LDM;  // (Q,)
  float* dtv = cum + Q;          // (Q,)
  float* wv = dtv;               // (Q,) the state-update weights, over dt

  const long long bh = blockIdx.x;
  const int p0 = blockIdx.y * LDX;      // this slab's first head channel
  const int pw = min(LDX, P - p0);      // and its width
  const T* xh = x + bh * L * P + p0;
  const T* bh_b = bmat + bh * L * N;
  const T* bh_c = cmat + bh * L * N;
  const float* dah = da + bh * L;
  const float* dth = dt + bh * L;
  float* yh = y + bh * L * P + p0;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n_tiles = np / 16;  // state rows per thread: ty + 16a, a < n_tiles

  for (int e = tid; e < np * LDX; e += THREADS) st[e] = 0.0f;

  for (int l0 = 0; l0 < L; l0 += Q) {
    __syncthreads();  // the previous chunk's state update is done
    chunk_cum(cum, dtv, dah + l0, dth + l0, Q);

    for (int i0 = 0; i0 < Q; i0 += TILE) {
      load_tile<T>(ct, ldn, bh_c, N, N, np, l0 + i0, l0 + Q);
      __syncthreads();
      float acc[4][4];
      // the carried state's term: exp(cum_i) * (C_i @ state)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
      for (int n = 0; n < N; ++n) {
        float ca[4], sb[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) ca[a] = ct[(ty + 16 * a) * ldn + n];
#pragma unroll
        for (int b = 0; b < 4; ++b) sb[b] = st[n * LDX + tx + 16 * b];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            acc[a][b] = __fadd_rn(acc[a][b], __fmul_rn(ca[a], sb[b]));
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
        const float e = i < Q ? expf(cum[i]) : 0.0f;
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = __fmul_rn(e, acc[a][b]);
      }
      // the lower-triangular blocks: y_i += sum_j att[i,j] x_j
      for (int j0 = 0; j0 <= i0; j0 += TILE) {
        __syncthreads();  // the previous block's b, x and scores are consumed
        load_tile<T>(bt, ldn, bh_b, N, N, np, l0 + j0, l0 + Q);
        load_tile<T>(xt, LDX, xh, P, pw, LDX, l0 + j0, l0 + Q);
        __syncthreads();
        float s[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) s[a][b] = 0.0f;
        for (int n = 0; n < N; ++n) {
          float ca[4], bb[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) ca[a] = ct[(ty + 16 * a) * ldn + n];
#pragma unroll
          for (int b = 0; b < 4; ++b) bb[b] = bt[(tx + 16 * b) * ldn + n];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b)
              s[a][b] = __fadd_rn(s[a][b], __fmul_rn(ca[a], bb[b]));
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + ty + 16 * a;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int j = j0 + tx + 16 * b;
            float v = 0.0f;
            if (j <= i && i < Q)
              v = __fmul_rn(
                  __fmul_rn(s[a][b], expf(__fsub_rn(cum[i], cum[j]))),
                  dtv[j]);
            sm[(ty + 16 * a) * LDM + tx + 16 * b] = v;
          }
        }
        __syncthreads();
        for (int kk = 0; kk < TILE; ++kk) {
          float pa[4], xb[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) pa[a] = sm[(ty + 16 * a) * LDM + kk];
#pragma unroll
          for (int b = 0; b < 4; ++b) xb[b] = xt[kk * LDX + tx + 16 * b];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b)
              acc[a][b] = __fadd_rn(acc[a][b], __fmul_rn(pa[a], xb[b]));
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
        if (i >= Q) continue;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int p = tx + 16 * b;
          if (p < pw) yh[static_cast<long long>(l0 + i) * P + p] = acc[a][b];
        }
      }
      __syncthreads();  // c tile consumed before the next row block
    }

    // state = exp(cum_Q) * state + sum_j B_j^T (exp(cum_Q - cum_j) dt_j) x_j
    const float last = cum[Q - 1];
    for (int i = tid; i < Q; i += THREADS)  // in place: each i is one thread's
      wv[i] = __fmul_rn(expf(__fsub_rn(last, cum[i])), dtv[i]);
    const float decay = expf(last);
    float sacc[TILE_N / 16][4];
#pragma unroll
    for (int a = 0; a < TILE_N / 16; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) sacc[a][b] = 0.0f;
    for (int j0 = 0; j0 < Q; j0 += TILE) {
      __syncthreads();
      load_tile<T>(bt, ldn, bh_b, N, N, np, l0 + j0, l0 + Q);
      load_tile<T>(xt, LDX, xh, P, pw, LDX, l0 + j0, l0 + Q);
      __syncthreads();
      const int rows = min(TILE, Q - j0);
      for (int jj = 0; jj < rows; ++jj) {
        const float w = wv[j0 + jj];
        float xb[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) xb[b] = xt[jj * LDX + tx + 16 * b];
#pragma unroll
        for (int a = 0; a < TILE_N / 16; ++a) {
          if (a < n_tiles) {
            const float bw = __fmul_rn(bt[jj * ldn + ty + 16 * a], w);
#pragma unroll
            for (int b = 0; b < 4; ++b)
              sacc[a][b] = __fadd_rn(sacc[a][b], __fmul_rn(bw, xb[b]));
          }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < TILE_N / 16; ++a) {
      if (a < n_tiles) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          float* s = st + (ty + 16 * a) * LDX + tx + 16 * b;
          *s = __fadd_rn(__fmul_rn(decay, *s), sacc[a][b]);
        }
      }
    }
  }
}

// The same scan with the state in pieces of `piece` rows (a multiple of
// 16, at most 256), for a d_state or a chunk whose whole state does not fit
// in shared memory beside the tiles (N > 256, or N = 256 at chunk > 288).
// The state lives in a float32 scratch in device memory, (BH, slabs, N, 64)
// (the slab's rows are read and written by its own CTA only, and stay in
// L2), and each sum over the state's rows runs over the pieces in order:
// C_i @ state and C_i . B_j load a piece of C's (and B's or the state's)
// columns at a time and add its terms to the same accumulators, n
// ascending, so every output is the sum the whole-state kernel would form,
// add for add; the state update runs piece by piece, each row's sum over j
// as in the whole-state kernel.  C's rows are loaded again for every piece
// and every column block (the price of not holding them).
// (one CTA an SM: its ~227 KB of shared memory allow no second, so the
// launch bounds leave it the registers that hold sacc without spilling)
template <typename T>
__global__ void __launch_bounds__(THREADS, 1) ssd_scan_pieced_kernel(
    const T* __restrict__ x, const float* __restrict__ da,
    const float* __restrict__ dt, const T* __restrict__ bmat,
    const T* __restrict__ cmat, float* __restrict__ y,
    float* __restrict__ state, int L, int P, int N, int Q, int piece) {
  extern __shared__ float smem[];
  const int ldn = piece + 1;
  float* st = smem;               // (piece, LDX) a piece of the state
  float* ct = st + piece * LDX;   // (64, piece+1) C rows, a piece of columns
  float* bt = ct + TILE * ldn;    // (64, piece+1) B rows, a piece of columns
  float* xt = bt + TILE * ldn;    // (64, LDX) x rows of this slab
  float* sm = xt + TILE * LDX;    // (64, 65) score tile
  float* cum = sm + TILE * LDM;   // (Q,)
  float* dtv = cum + Q;           // (Q,)
  float* wv = dtv;                // (Q,) the state-update weights, over dt

  const long long bh = blockIdx.x;
  const int p0 = blockIdx.y * LDX;
  const int pw = min(LDX, P - p0);
  const T* xh = x + bh * L * P + p0;
  const T* bh_b = bmat + bh * L * N;
  const T* bh_c = cmat + bh * L * N;
  const float* dah = da + bh * L;
  const float* dth = dt + bh * L;
  float* yh = y + bh * L * P + p0;
  float* sg = state + (bh * gridDim.y + blockIdx.y) * N * LDX;  // (N, LDX)

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  for (long long e = tid; e < static_cast<long long>(N) * LDX; e += THREADS)
    sg[e] = 0.0f;

  for (int l0 = 0; l0 < L; l0 += Q) {
    __syncthreads();  // the previous chunk's state update is done
    chunk_cum(cum, dtv, dah + l0, dth + l0, Q);

    for (int i0 = 0; i0 < Q; i0 += TILE) {
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
      // the carried state's term: exp(cum_i) * (C_i @ state), n ascending
      for (int n0 = 0; n0 < N; n0 += piece) {
        const int w = min(piece, N - n0);
        __syncthreads();  // the previous piece's c and state are consumed
        load_tile<T>(ct, ldn, bh_c + n0, N, w, w, l0 + i0, l0 + Q);
        for (int e = tid; e < w * LDX; e += THREADS)
          st[e] = sg[static_cast<long long>(n0) * LDX + e];
        __syncthreads();
        for (int n = 0; n < w; ++n) {
          float ca[4], sb[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) ca[a] = ct[(ty + 16 * a) * ldn + n];
#pragma unroll
          for (int b = 0; b < 4; ++b) sb[b] = st[n * LDX + tx + 16 * b];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b)
              acc[a][b] = __fadd_rn(acc[a][b], __fmul_rn(ca[a], sb[b]));
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
        const float e = i < Q ? expf(cum[i]) : 0.0f;
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = __fmul_rn(e, acc[a][b]);
      }
      // the lower-triangular blocks: y_i += sum_j att[i,j] x_j
      for (int j0 = 0; j0 <= i0; j0 += TILE) {
        float s[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) s[a][b] = 0.0f;
        for (int n0 = 0; n0 < N; n0 += piece) {
          const int w = min(piece, N - n0);
          __syncthreads();  // the previous piece's c and b (and the x and
                            // scores of the previous block) are consumed
          load_tile<T>(ct, ldn, bh_c + n0, N, w, w, l0 + i0, l0 + Q);
          load_tile<T>(bt, ldn, bh_b + n0, N, w, w, l0 + j0, l0 + Q);
          if (n0 == 0) load_tile<T>(xt, LDX, xh, P, pw, LDX, l0 + j0, l0 + Q);
          __syncthreads();
          for (int n = 0; n < w; ++n) {
            float ca[4], bb[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) ca[a] = ct[(ty + 16 * a) * ldn + n];
#pragma unroll
            for (int b = 0; b < 4; ++b) bb[b] = bt[(tx + 16 * b) * ldn + n];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int b = 0; b < 4; ++b)
                s[a][b] = __fadd_rn(s[a][b], __fmul_rn(ca[a], bb[b]));
          }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + ty + 16 * a;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int j = j0 + tx + 16 * b;
            float v = 0.0f;
            if (j <= i && i < Q)
              v = __fmul_rn(
                  __fmul_rn(s[a][b], expf(__fsub_rn(cum[i], cum[j]))),
                  dtv[j]);
            sm[(ty + 16 * a) * LDM + tx + 16 * b] = v;
          }
        }
        __syncthreads();
        for (int kk = 0; kk < TILE; ++kk) {
          float pa[4], xb[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) pa[a] = sm[(ty + 16 * a) * LDM + kk];
#pragma unroll
          for (int b = 0; b < 4; ++b) xb[b] = xt[kk * LDX + tx + 16 * b];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b)
              acc[a][b] = __fadd_rn(acc[a][b], __fmul_rn(pa[a], xb[b]));
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
        if (i >= Q) continue;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int p = tx + 16 * b;
          if (p < pw) yh[static_cast<long long>(l0 + i) * P + p] = acc[a][b];
        }
      }
    }
    __syncthreads();  // every row block has read the state and dt

    // state = exp(cum_Q) * state + sum_j B_j^T (exp(cum_Q - cum_j) dt_j) x_j,
    // a piece of rows at a time; each thread updates its own elements
    const float last = cum[Q - 1];
    for (int i = tid; i < Q; i += THREADS)
      wv[i] = __fmul_rn(expf(__fsub_rn(last, cum[i])), dtv[i]);
    const float decay = expf(last);
    for (int n0 = 0; n0 < N; n0 += piece) {
      const int w = min(piece, N - n0);
      float sacc[MAX_N / 16][4];
#pragma unroll
      for (int a = 0; a < MAX_N / 16; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) sacc[a][b] = 0.0f;
      for (int j0 = 0; j0 < Q; j0 += TILE) {
        __syncthreads();
        load_tile<T>(bt, ldn, bh_b + n0, N, w, w, l0 + j0, l0 + Q);
        load_tile<T>(xt, LDX, xh, P, pw, LDX, l0 + j0, l0 + Q);
        __syncthreads();
        const int rows = min(TILE, Q - j0);
        for (int jj = 0; jj < rows; ++jj) {
          const float wj = wv[j0 + jj];
          float xb[4];
#pragma unroll
          for (int b = 0; b < 4; ++b) xb[b] = xt[jj * LDX + tx + 16 * b];
#pragma unroll
          for (int a = 0; a < MAX_N / 16; ++a) {
            if (ty + 16 * a < w) {
              const float bw = __fmul_rn(bt[jj * ldn + ty + 16 * a], wj);
#pragma unroll
              for (int b = 0; b < 4; ++b)
                sacc[a][b] = __fadd_rn(sacc[a][b], __fmul_rn(bw, xb[b]));
            }
          }
        }
      }
#pragma unroll
      for (int a = 0; a < MAX_N / 16; ++a) {
        if (ty + 16 * a < w) {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            float* sp = sg + static_cast<long long>(n0 + ty + 16 * a) * LDX +
                        tx + 16 * b;
            *sp = __fadd_rn(__fmul_rn(decay, *sp), sacc[a][b]);
          }
        }
      }
    }
  }
}

// The rows of the state's pieces, or 0 when the whole state fits in shared
// memory beside the tiles (the whole-state kernel), or -1 when not even a
// piece of 16 rows does (a chunk past ~23,000 rows).
int piece_rows(int N, int Q) {
  if (N <= MAX_N && smem_floats(Q, N) * 4 <= MAX_SMEM) return 0;
  for (int piece = MAX_N; piece >= 16; piece /= 2)
    if (smem_floats(Q, piece) * 4 <= MAX_SMEM) return piece;
  return -1;
}

template <typename T, int TILE_N>
int launch(const void* x, const void* da, const void* dt, const void* bmat,
           const void* cmat, void* y, int bh, int L, int P, int N, int Q,
           cudaStream_t stream) {
  const int bytes = smem_floats(Q, N) * static_cast<int>(sizeof(float));
  auto kernel = ssd_scan_kernel<T, TILE_N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (P + LDX - 1) / LDX);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(da),
      static_cast<const float*>(dt), static_cast<const T*>(bmat),
      static_cast<const T*>(cmat), static_cast<float*>(y), L, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_pieced(const void* x, const void* da, const void* dt,
                  const void* bmat, const void* cmat, void* y, void* state,
                  int bh, int L, int P, int N, int Q, int piece,
                  cudaStream_t stream) {
  const int bytes = smem_floats(Q, piece) * static_cast<int>(sizeof(float));
  auto kernel = ssd_scan_pieced_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (P + LDX - 1) / LDX);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(da),
      static_cast<const float*>(dt), static_cast<const T*>(bmat),
      static_cast<const T*>(cmat), static_cast<float*>(y),
      static_cast<float*>(state), L, P, N, Q, piece);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* da, const void* dt, const void* bmat,
             const void* cmat, void* y, void* state, int bh, int L, int P,
             int N, int Q, cudaStream_t s) {
  const int piece = piece_rows(N, Q);
  if (piece < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (piece > 0)
    return launch_pieced<T>(x, da, dt, bmat, cmat, y, state, bh, L, P, N, Q,
                            piece, s);
  return padded_states(N) > 128
             ? launch<T, 256>(x, da, dt, bmat, cmat, y, bh, L, P, N, Q, s)
             : launch<T, 128>(x, da, dt, bmat, cmat, y, bh, L, P, N, Q, s);
}

}  // namespace

// Floats of the state scratch ssd_scan_launch needs for these sizes:
// bh * ceil(P/64) * N * 64 when the state goes in pieces, 0 when it fits in
// shared memory, -1 when the chunk is too long for any piece.
extern "C" long long ssd_scan_scratch_floats(int bh, int P, int N, int chunk) {
  const int piece = piece_rows(N, chunk);
  if (piece <= 0) return piece;
  return static_cast<long long>(bh) * ((P + LDX - 1) / LDX) * N * LDX;
}

// Head-major x, B, C (BH, L, P / N) in float32, bfloat16 or float16 (dtype
// 0, 1, 2), float32 da and dt (BH, L), y (BH, L, P) float32; `state` the
// scratch of ssd_scan_scratch_floats floats (unused when that is 0).
extern "C" int ssd_scan_launch(const void* x, const void* da, const void* dt,
                               const void* bmat, const void* cmat, void* y,
                               void* state, int bh, int L, int P, int N,
                               int chunk, int dtype, void* stream) {
  if (bh <= 0 || L <= 0) return 0;
  if (P <= 0 || (P + LDX - 1) / LDX > MAX_SLABS || N <= 0 || chunk <= 0 ||
      L % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch<float>(x, da, dt, bmat, cmat, y, state, bh, L, P, N,
                             chunk, s);
    case 1:
      return dispatch<__nv_bfloat16>(x, da, dt, bmat, cmat, y, state, bh, L,
                                     P, N, chunk, s);
    case 2:
      return dispatch<__half>(x, da, dt, bmat, cmat, y, state, bh, L, P, N,
                              chunk, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
