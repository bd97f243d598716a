// Sorted-set intersection count over the live prefixes of resident tiles:
//   ra = index_a ? index_a[q] : q,  ma = length_a ? min(length_a[ra], Ba) : Ba
//   (rb, mb likewise for b),
//   out[q] = #{(p, s) : p < ma, s < mb, a[ra, p] == b[rb, s] != SENTINEL}.
//
// Replaces: src/repro/kernels/intersect/kernel.py, intersect_count_kernel
// (pl.pallas_call at :55, body _kernel at :29).  The TPU compares all B*B
// pairs of two [Q, B] operands that the caller gathered from the tiles
// first, walking b in 128-wide chunks along the grid.
//
// Bound on the H100: bytes.  Leaf tiles hold a sorted live prefix then
// SENTINEL padding, so the function needs the 128-byte lines of each named
// tile's live prefix (once per distinct tile), the indices, each named
// tile's length, and out (Q*4).  The first port read two gathered [Q, B]
// copies that the caller had built, staged all Bb ids of b in shared memory
// and searched the whole padded row.
//
// Design: the gather is fused in (the kernel reads index_a[q], index_b[q]
// and the tiles themselves; no [Q, B] copy is made), and a warp takes one
// pair and reads only the two live prefixes.  The warp first copies both
// prefixes into its slice of shared memory, up to 16 loads in flight per
// lane, so a pair's lines arrive in one or two round trips to memory.
// Then it merges the two sorted prefixes there along the merge path: lane
// t takes the t-th of 32 equal runs of the merged order, finds where its
// run starts with one binary search along the diagonal, and walks it,
// (ma + mb) / 32 steps, ties taken from a
// first, so when it takes an id v of a, the ids of b before it are all
// < v.  When b's live ids are distinct (leaf tiles are sets) a step is
// branch-free: it counts 1 when b's next id equals v.  When b repeats an
// id, each taken v walks b's run of ids equal to v instead, which counts
// upper - lower bound: exact with repeated values.  A reduce over the
// warp gives the int32 count.  A block holds up to 8 pairs, fewer when
// the two widths are so wide that 8 slices of Ba + Bb ids would not fit
// in shared memory; one slice must fit (Ba + Bb <= 58,112 ids).
// What sets the time: the bytes of the prefixes, the round trips one pair
// waits on in turn (index, length, the prefixes), and the merge steps.
// Designs that streamed a from global memory 32 ids per step (against b in
// registers when b had at most 32 ids, else binary searches in b, over all
// of it or over windows) waited on one load per step, up to 16 steps for a
// hub tile; the merge with a branch at each step paid both sides of it
// (PERF.md).  This is the paper's merge/probe rule (section 6.5): the host
// still makes the smaller tile the probing operand a when the sizes differ
// tenfold (core/analytics.py).  a and b may have different widths (tier
// pairs need no padding).  An index outside [0, n) traps, as an
// out-of-range gather would; the context reports it at its next
// synchronisation.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kSentinel = 0x7fffffff;
constexpr int kMaxPairs = 8;  // pairs per block at most: blockDim.x = 32 * pairs
constexpr int kStage = 8;     // ids of each prefix loaded per lane per round
constexpr size_t kMaxSmem = 227 * 1024;  // shared memory one block may hold

__device__ __forceinline__ long long tile_of(const int* index, long long q, long long n) {
  const long long r = index ? (long long)__ldg(index + q) : q;
  if (r < 0 || r >= n) __trap();
  return r;
}

__global__ void __launch_bounds__(kMaxPairs * 32)
intersect_count_kernel(const int* __restrict__ a, const int* __restrict__ b,
                       const int* __restrict__ index_a, const int* __restrict__ index_b,
                       const int* __restrict__ length_a, const int* __restrict__ length_b,
                       int* __restrict__ out, long long Q, long long n_a, long long n_b, int Ba,
                       int Bb) {
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x >> 5;
  const long long q = (long long)blockIdx.x * (blockDim.x >> 5) + g;
  if (q >= Q) return;  // the whole warp leaves together
  const long long ra = tile_of(index_a, q, n_a), rb = tile_of(index_b, q, n_b);
  const int ma = length_a ? min(max(__ldg(length_a + ra), 0), Ba) : Ba;
  const int mb = length_b ? min(max(__ldg(length_b + rb), 0), Bb) : Bb;
  const int* arow = a + ra * (long long)Ba;
  const int* brow = b + rb * (long long)Bb;
  extern __shared__ int smem[];  // [pairs][Ba + Bb]
  int* sa = smem + (size_t)g * (Ba + Bb);
  int* sb = sa + Ba;
  for (int j0 = 0; j0 < max(ma, mb); j0 += kStage * 32) {
    int va[kStage], vb[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int j = j0 + u * 32 + lane;
      va[u] = j < ma ? __ldg(arow + j) : 0;
      vb[u] = j < mb ? __ldg(brow + j) : 0;
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int j = j0 + u * 32 + lane;
      if (j < ma) sa[j] = va[u];
      if (j < mb) sb[j] = vb[u];
    }
  }
  __syncwarp();
  const int total = ma + mb;
  const int per = (total + 31) / 32;
  const int d0 = min(lane * per, total), d1 = min(d0 + per, total);
  // the split of diagonal d0: a[0:i] and b[0:d0-i] come first
  int lo = max(0, d0 - mb), hi = min(d0, ma);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sa[mid] <= sb[d0 - mid - 1]) lo = mid + 1; else hi = mid;
  }
  bool repeats = false;  // does b repeat an id (SENTINEL padding aside)?
  for (int k = lane; k + 1 < mb; k += 32) repeats |= sb[k] == sb[k + 1] && sb[k] != kSentinel;
  repeats = __any_sync(0xffffffffu, repeats);
  unsigned cnt = 0;
  int i = lo, j = d0 - lo;
  if (!repeats) {
    for (int d = d0; d < d1; ++d) {
      const int x = i < ma ? sa[i] : kSentinel;
      const int y = j < mb ? sb[j] : kSentinel;
      const bool take_a = j >= mb || (i < ma && x <= y);
      cnt += (take_a && j < mb && x == y && x != kSentinel) ? 1u : 0u;
      i += take_a ? 1 : 0;
      j += take_a ? 0 : 1;
    }
  } else {
    for (int d = d0; d < d1; ++d) {
      if (j >= mb || (i < ma && sa[i] <= sb[j])) {
        const int v = sa[i++];
        if (v != kSentinel)
          for (int k = j; k < mb && sb[k] == v; ++k) ++cnt;
      } else {
        ++j;
      }
    }
  }
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  if (lane == 0) out[q] = (int)cnt;
}

}  // namespace

// a [n_a, Ba], b [n_b, Bb] int32 tiles, each row sorted over its live
// prefix; index_a, index_b [Q] int32 tiles of each pair (null: tile q, and
// then Q <= n); length_a [n_a], length_b [n_b] int32 live ids of each tile
// (null: the full width); out [Q] int32.  Ba + Bb <= 58,112 (one pair's
// slice of shared memory).
extern "C" int intersect_count_launch(const void* a, const void* b, const void* index_a,
                                      const void* index_b, const void* length_a,
                                      const void* length_b, void* out, long long Q,
                                      long long n_a, long long n_b, int Ba, int Bb,
                                      void* stream) {
  if (Q <= 0) return 0;
  if (Ba < 0 || Bb < 0 || n_a < 0 || n_b < 0) return (int)cudaErrorInvalidValue;
  const size_t slice = ((size_t)Ba + Bb) * sizeof(int);
  if (slice > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int pairs = slice ? (int)std::min<size_t>(kMaxPairs, kMaxSmem / slice) : kMaxPairs;
  const size_t smem = (size_t)pairs * slice;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        intersect_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (Q + pairs - 1) / pairs;
  intersect_count_kernel<<<(unsigned)blocks, pairs * 32, smem, (cudaStream_t)stream>>>(
      (const int*)a, (const int*)b, (const int*)index_a, (const int*)index_b,
      (const int*)length_a, (const int*)length_b, (int*)out, Q, n_a, n_b, Ba, Bb);
  return (int)cudaGetLastError();
}
