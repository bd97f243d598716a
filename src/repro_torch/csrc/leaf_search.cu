// Batched leaf search: found[q] = any(rows[q, :] == t[q]), pos[q] = count(rows[q, :] < t[q]).
//
// Replaces: src/repro/kernels/leaf_search/kernel.py, leaf_search_kernel
// (pl.pallas_call at :40, body _kernel at :24), the Search(u, v) probe over
// sorted, SENTINEL-padded [Q, B] int32 leaf rows.
//
// Bound on the H100: bytes.  On a sorted row a binary search needs one
// 32-byte sector per probe until its interval fits in one sector (7 at
// B=512), far below the card's integer rate.  This kernel scans the whole
// B-wide row (Q*B*4 bytes), so it moves several times what it needs.
//
// Design: one warp per query.  Lane l reads elements l, l+32, ... so each
// warp-wide load is one coalesced 128-byte transaction; each lane counts
// `< t` and tests `== t`, and __reduce_add_sync / __any_sync combine the
// lanes (no shared memory, no block barrier).  The kernel masks the ragged
// last block itself, so the caller never pads Q.  `found` is written as one
// byte per query and viewed as torch.bool by the wrapper.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps, 8 queries per block

__global__ void leaf_search_kernel(const int* __restrict__ rows,
                                   const int* __restrict__ targets,
                                   uint8_t* __restrict__ found,
                                   int* __restrict__ pos, long long Q, int B) {
  const int lane = threadIdx.x & 31;
  const long long q = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (q >= Q) return;  // warp-uniform: the whole warp leaves together
  const int t = __ldg(targets + q);
  const int* row = rows + q * (long long)B;
  unsigned less = 0;
  bool hit = false;
  for (int j = lane; j < B; j += 32) {
    const int v = __ldg(row + j);
    less += (v < t);
    hit |= (v == t);
  }
  less = __reduce_add_sync(0xffffffffu, less);
  const bool any = __any_sync(0xffffffffu, hit);
  if (lane == 0) {
    pos[q] = (int)less;
    found[q] = any ? 1 : 0;
  }
}

}  // namespace

extern "C" int leaf_search_launch(const void* rows, const void* targets, void* found,
                                  void* pos, long long Q, int B, void* stream) {
  if (Q <= 0) return 0;
  const long long blocks = (Q + kThreads / 32 - 1) / (kThreads / 32);
  leaf_search_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)rows, (const int*)targets, (uint8_t*)found, (int*)pos, Q, B);
  return (int)cudaGetLastError();
}
