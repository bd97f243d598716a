// Sorted-set intersection count: out[i] = #{(p, q) : a[i, p] == b[i, q] != SENTINEL}.
//
// Replaces: src/repro/kernels/intersect/kernel.py, intersect_count_kernel
// (pl.pallas_call at :55, body _kernel at :29).  The TPU compares all B*B
// pairs, walking b in 128-wide chunks along the grid.
//
// Bound on the H100: bytes.  Leaf tiles hold a sorted live prefix then
// SENTINEL padding, so the function needs only the 128-byte lines of a[i]
// and b[i] up to their first SENTINEL, plus out (Q*4).  This kernel stages
// all Bb ids of b[i], so it reads more than that.  The probe does
// Ba*log2(Bb) compares per pair instead of the TPU's Ba*Bb, which keeps the
// work far below the integer rate.
//
// Design: one warp per pair.  The warp stages b[i] (sorted, SENTINEL-padded,
// as leaf tiles are) in its own slice of shared memory, then each lane takes
// the live elements of a[i] with stride 32 and binary-searches each one in
// b[i]: upper_bound - lower_bound counts every equal element, so the count
// is exact even with repeated values.  A warp reduce gives the int32 count.
// This is the paper's probe rule (section 6.5); the host still chooses
// which tile is the probing operand (core/analytics.py).  a and b may have
// different widths (Ba, Bb), so tier pairs need no padding.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSentinel = 0x7fffffff;
constexpr int kMaxWarps = 8;
constexpr size_t kSmemBudget = 48 * 1024;

__device__ __forceinline__ int lower_bound(const int* b, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (b[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int upper_bound(const int* b, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (b[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void intersect_count_kernel(const int* __restrict__ a, const int* __restrict__ b,
                                       int* __restrict__ out, long long Q, int Ba, int Bb) {
  extern __shared__ int sb[];  // [warps][Bb]
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long q = (long long)blockIdx.x * (blockDim.x >> 5) + w;
  if (q >= Q) return;  // warp-uniform; warps never share their slice
  int* my = sb + (size_t)w * Bb;
  const int* brow = b + q * (long long)Bb;
  for (int j = lane; j < Bb; j += 32) my[j] = __ldg(brow + j);
  __syncwarp();
  const int* arow = a + q * (long long)Ba;
  unsigned cnt = 0;
  for (int p = lane; p < Ba; p += 32) {
    const int v = __ldg(arow + p);
    if (v != kSentinel) cnt += upper_bound(my, Bb, v) - lower_bound(my, Bb, v);
  }
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  if (lane == 0) out[q] = (int)cnt;
}

}  // namespace

extern "C" int intersect_count_launch(const void* a, const void* b, void* out, long long Q,
                                      int Ba, int Bb, void* stream) {
  if (Q <= 0) return 0;
  const size_t row_bytes = (size_t)(Bb > 0 ? Bb : 1) * sizeof(int);
  if (row_bytes > kSmemBudget) return (int)cudaErrorInvalidValue;
  int warps = (int)(kSmemBudget / row_bytes);
  if (warps > kMaxWarps) warps = kMaxWarps;
  const long long blocks = (Q + warps - 1) / warps;
  intersect_count_kernel<<<(unsigned)blocks, warps * 32, warps * row_bytes,
                           (cudaStream_t)stream>>>((const int*)a, (const int*)b, (int*)out,
                                                   Q, Ba, Bb);
  return (int)cudaGetLastError();
}
