// Batched leaf search over the live prefix of resident tiles:
//   r = index ? index[q] : q,  m = length ? min(length[r], B) : B,
//   pos[q] = #(rows[r, 0:m] < t[q]),  found[q] = any(rows[r, 0:m] == t[q]).
//
// Replaces: src/repro/kernels/leaf_search/kernel.py, leaf_search_kernel
// (pl.pallas_call at :40, body _kernel at :24), the Search(u, v) probe over
// sorted, SENTINEL-padded [Q, B] int32 leaf rows that the caller gathered
// from the resident tiles first.
//
// Bound on the H100: bytes, and the latency of dependent loads.  On a
// sorted row a search needs one 32-byte sector per probe until its
// interval fits in one sector (7 at B=512, fewer on a short live prefix),
// far below the card's integer rate.  The first port scanned the whole
// B-wide row of a gathered copy: 2 KiB per query read, plus the copy.
//
// Design: the gather is fused in (the kernel reads index[q] and the tile
// itself; no [Q, B] copy is made), and one thread binary-searches only the
// live prefix rows[r, 0:m].  Each query is a chain of dependent loads
// (index, length, then about log2(m) probes), so what pays is the most
// queries in flight and the fewest sectors per query: groups of 2-32 lanes
// per query, probing several ids per level, were slower on the card
// (PERF.md).  A tile row is sorted, so the answer equals the full-row count
// whenever t != SENTINEL (int32 max): no vertex id reaches that.  An index
// outside [0, n) traps, as an out-of-range gather would; the context then
// reports the failure at its next synchronisation.  `found` is written as
// one byte per query and viewed as torch.bool by the wrapper.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
leaf_search_kernel(const int* __restrict__ rows, const int* __restrict__ targets,
                   const int* __restrict__ index, const int* __restrict__ length,
                   uint8_t* __restrict__ found, int* __restrict__ pos, long long Q, long long n,
                   int B) {
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (q >= Q) return;
  const int t = __ldg(targets + q);
  const long long r = index ? (long long)__ldg(index + q) : q;
  if (r < 0 || r >= n) __trap();
  const int m = length ? min(max(__ldg(length + r), 0), B) : B;
  const int* row = rows + r * (long long)B;
  // the answer lies in [lo, hi]: ids before lo are < t, from hi on >= t.
  // Every probe that moves hi reads an id >= t, and the last one reads
  // row[pos], so a match is always probed.
  int lo = 0, hi = m;
  bool hit = false;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int x = __ldg(row + mid);
    hit |= (x == t);
    if (x < t) lo = mid + 1; else hi = mid;
  }
  pos[q] = lo;
  found[q] = hit ? 1 : 0;
}

}  // namespace

// rows [n, B] int32, each row sorted over its live prefix and SENTINEL past
// it; targets [Q] int32; index [Q] int32 tile of each query in [0, n) (null:
// row q, and then Q <= n); length [n] int32 live ids of each tile (null: B);
// found [Q] uint8, pos [Q] int32.
extern "C" int leaf_search_launch(const void* rows, const void* targets, const void* index,
                                  const void* length, void* found, void* pos, long long Q,
                                  long long n, int B, void* stream) {
  if (Q <= 0) return 0;
  if (B < 0 || n < 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (Q + kThreads - 1) / kThreads;
  leaf_search_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)rows, (const int*)targets, (const int*)index, (const int*)length,
      (uint8_t*)found, (int*)pos, Q, n, B);
  return (int)cudaGetLastError();
}
