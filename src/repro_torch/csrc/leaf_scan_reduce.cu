// Leaf scan-reduce: y[i] = sum over j with rows[i, j] != SENTINEL of x[rows[i, j]].
//
// Replaces: src/repro/kernels/spmm/kernel.py, leaf_scan_reduce_kernel
// (pl.pallas_call at :47, body _scan_reduce_kernel at :34).  On the TPU the
// gather vals = x[rows] runs in XLA before the kernel (spmm/ops.py:47-48)
// and the [N, B] f32 vals array goes through HBM.
//
// Bound on the H100: bytes.  Leaf tiles hold a sorted live prefix then
// SENTINEL padding, so the function needs only each row's lines up to its
// first SENTINEL, the distinct x entries it touches, and y (N*4); one add
// per element is nothing next to that.  This kernel reads all B slots of
// every row (N*B*4), so on sparse tiles it moves far more than it needs.
//
// Design: one warp per tile row.  Lanes read the row coalesced (lane l takes
// columns l, l+32, ...), do the masked gather x[rows[i, j]] themselves (x is
// small enough to stay in L2 across rows), and accumulate in f32 registers;
// a butterfly __shfl_xor_sync reduce gives the row sum.  The gathered vals
// never reach HBM.  Ids are clamped to [0, nx) like a JAX gather.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSentinel = 0x7fffffff;

__global__ void leaf_scan_reduce_kernel(const int* __restrict__ rows,
                                        const float* __restrict__ x,
                                        float* __restrict__ out, long long N, int B,
                                        long long nx) {
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (i >= N) return;  // warp-uniform
  const int* row = rows + i * (long long)B;
  float acc = 0.f;
  for (int j = lane; j < B; j += 32) {
    const int r = __ldg(row + j);
    if (r != kSentinel) {
      const long long k = r < 0 ? 0 : (r >= nx ? nx - 1 : (long long)r);
      acc += __ldg(x + k);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[i] = acc;
}

}  // namespace

extern "C" int leaf_scan_reduce_launch(const void* rows, const void* x, void* out,
                                       long long N, int B, long long nx, void* stream) {
  if (N <= 0) return 0;
  if (nx <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (N + kThreads / 32 - 1) / (kThreads / 32);
  leaf_scan_reduce_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)rows, (const float*)x, (float*)out, N, B, nx);
  return (int)cudaGetLastError();
}
