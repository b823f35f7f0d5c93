// Fused MHLJ step on the ragged (flat CSR) layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/walk_transition/kernel.py
// `walk_transition_ragged` (body `_ragged_kernel`): per walk, the index of
// u_mh * total in the walk's own per-edge CDF segment (the MH move),
// d ~ TruncGeom(p_d, r) by the closed-form inverse CDF, d uniform hops
// through the CSR arrays (the Levy jump), and the jump/MH select.  Its
// plain version is repro_torch/kernels/walk_transition/ref.py (a binary
// search), and the two agree bit for bit on the same CDF and uniforms.
//
// What bounds it: not bytes (a walk reads a few 32-byte sectors) but the
// chain of dependent scattered loads each walk must wait out, and a floor
// per launch.  The design shortens the chain and fills the card:
//
// * A group of G lanes takes one walk, 128 threads a block.  G is a
//   template parameter; the wrapper launches G = 32 (kernel.RAGGED_GROUP),
//   the fastest of 4, 8, 16 and 32 on the H100 (chip_smoke.py times each):
//   a warp a walk, so W=2048 walks make 512 blocks and W=8192 make 2048,
//   no walk waits on another's loads, and every warp takes one branch
//   (PR 12's thread-a-walk warps paid the MH and jump chains one after
//   the other).  A block's walks outside W are whole masked groups; every
//   shuffle and ballot names only its own group's lanes.
// * The MH move reads the segment with the group's lanes.  Round 1 reads
//   G entries at once: the whole segment when deg <= G, else G entries
//   spaced evenly and ending at deg-1, so the total (entry deg-1) comes in
//   the same round.  Each lane compares its entry with t = u_mh * total
//   and a ballot counts those below t; later rounds probe G entries of the
//   one interval left between two probes, until it holds at most G
//   entries.  An MH walk on a row of degree <= G so waits on 4 loads
//   (node and flag; row pointer and degree; segment; neighbor id) where
//   the binary search waited on 4 + ceil(log2(deg + 1)); at the BA(1M,3)
//   hub (degree 3799) 3 rounds at G = 32 replace the total and 12 probes.
//   Because the segment never decreases (the row-CDF rule adds
//   non-negative entries in order, and float rounding is monotone), the
//   probes below t form a prefix, and the count equals the binary
//   search's count(cdf < t) exactly.
// * The walk's node and its whole uniform row come in one round (the row
//   coalesced, a slot a lane, the rest by shuffle), so neither branch
//   waits on the flag before its own loads.  The Levy jump runs on the
//   whole group; each hop issues degree and row pointer together (one
//   address for the group), so a jump of d hops waits on 1 + 2d loads.
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
constexpr int BLOCK = 128;

__device__ __forceinline__ int hop(int v, float uh, const int* __restrict__ indptr,
                                   const int* __restrict__ degrees,
                                   const int* __restrict__ indices) {
  const int deg = __ldg(degrees + v);
  const int start = __ldg(indptr + v);
  const int k = min(static_cast<int>(__fmul_rn(uh, static_cast<float>(deg))),
                    deg - 1);
  return __ldg(indices + start + k);
}

// Offset of probe j (0 <= j < G) of a round over the n > G unknown entries
// from lo: G probes spaced evenly, the last at lo + n - 1.
template <int G>
__device__ __forceinline__ int probe(int lo, int n, int j) {
  return lo + static_cast<int>((static_cast<long long>(j + 1) * n) / G) - 1;
}

template <int G>
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
    int num_walks, int r, float z) {
  static_assert(G >= 4 && G <= 32 && (G & (G - 1)) == 0, "G: 4, 8, 16 or 32");
  const int gl = threadIdx.x % G;  // lane within the group
  const int w = blockIdx.x * (BLOCK / G) + threadIdx.x / G;
  const int first_lane = (threadIdx.x & 31) & ~(G - 1);
  const unsigned gmask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1u) << first_lane;
  if (w < num_walks) {
    // One round of loads before anything else: the node, log(1 - p_d) and
    // the walk's uniform row, slot gl on lane gl (slots G, 2G, ... come in
    // later batches, which only hops past slot G-1 need).
    const float* u = uniforms + static_cast<long long>(w) * (U_HOP0 + r);
    const int v = __ldg(nodes + w);
    const float den = __ldg(den_ptr);
    float row = gl < U_HOP0 + r ? __ldg(u + gl) : 0.0f;
    const auto slot = [&](int k) { return __shfl_sync(gmask, row, k, G); };
    int next, nhops;
    if (!(slot(U_JUMP) > 0.5f)) {
      // MH move: count of segment entries < u_mh * total, clamped to deg-1.
      const int start = __ldg(indptr + v);
      const int deg = __ldg(degrees + v);
      const float um = slot(U_MH);
      int lo = 0, n = deg;
      float t = 0.0f;
      for (bool first = true;; first = false) {
        const bool last = n <= G;  // this round reads every entry left
        const int q = last ? lo + gl : probe<G>(lo, n, gl);
        const bool on = !last || gl < n;
        const float c = on ? __ldg(edge_cdf + start + q) : 0.0f;
        if (first) {  // entry deg-1 sits on lane n-1 (last) or G-1
          const float total = __shfl_sync(gmask, c, last ? n - 1 : G - 1, G);
          t = __fmul_rn(um, total);
        }
        const int below = __popc(__ballot_sync(gmask, on && c < t) & gmask);
        if (last) {
          lo += below;
          break;
        }
        if (below == G) {  // every probe, the interval's last entry too
          lo += n;
          break;
        }
        // the crossing lies after probe below-1 and at or before probe below
        const int next_lo = below ? probe<G>(lo, n, below - 1) + 1 : lo;
        n = probe<G>(lo, n, below) - next_lo;
        lo = next_lo;
      }
      next = __ldg(indices + start + min(lo, deg - 1));
      nhops = 1;
    } else {
      // Levy jump: d = clamp(ceil(log1p(-u * z) / log(1 - p_d)), 1, r).
      const float x = __fmul_rn(-slot(U_DIST), z);
      const float qd = __fdiv_rn(log1pf(x), den);
      const int d = max(1, min(static_cast<int>(ceilf(qd)), r));
      next = v;
      for (int j = 0, batch = 0; j < d; ++j) {
        const int k = U_HOP0 + j - batch;  // hop j's slot in this batch
        if (k == G) {  // the next G slots, issued with this hop's loads
          batch += G;
          row = batch + gl < U_HOP0 + r ? __ldg(u + batch + gl) : 0.0f;
        }
        next = hop(next, slot(k == G ? 0 : k), indptr, degrees, indices);
      }
      nhops = d;
    }
    if (gl == 0) {
      next_nodes[w] = next;
      hops[w] = nhops;
    }
  }
}

template <int G>
int launch(const void* nodes, const void* indptr, const void* degrees,
           const void* indices, const void* edge_cdf, const void* uniforms,
           const void* den, void* next_nodes, void* hops, int num_walks,
           int r, float z, cudaStream_t stream) {
  const int grid = (num_walks + BLOCK / G - 1) / (BLOCK / G);
  walk_transition_ragged_kernel<G><<<grid, BLOCK, 0, stream>>>(
      static_cast<const int*>(nodes), static_cast<const int*>(indptr),
      static_cast<const int*>(degrees), static_cast<const int*>(indices),
      static_cast<const float*>(edge_cdf),
      static_cast<const float*>(uniforms), static_cast<const float*>(den),
      static_cast<int*>(next_nodes), static_cast<int*>(hops), num_walks, r,
      z);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// group: lanes a walk, 4, 8, 16 or 32 (any other value is refused).
extern "C" int walk_transition_ragged_launch(
    const void* nodes, const void* indptr, const void* degrees,
    const void* indices, const void* edge_cdf, const void* uniforms,
    const void* den, void* next_nodes, void* hops, int num_walks, int r,
    float z, int group, void* stream) {
  if (num_walks <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 4:
      return launch<4>(nodes, indptr, degrees, indices, edge_cdf, uniforms,
                       den, next_nodes, hops, num_walks, r, z, s);
    case 8:
      return launch<8>(nodes, indptr, degrees, indices, edge_cdf, uniforms,
                       den, next_nodes, hops, num_walks, r, z, s);
    case 16:
      return launch<16>(nodes, indptr, degrees, indices, edge_cdf, uniforms,
                        den, next_nodes, hops, num_walks, r, z, s);
    case 32:
      return launch<32>(nodes, indptr, degrees, indices, edge_cdf, uniforms,
                        den, next_nodes, hops, num_walks, r, z, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
