// Leaf scan-reduce over each tile's live prefix:
//   m = length ? min(max(length[i], 0), B) : B,
//   y[i] = sum over j < m with rows[i, j] != SENTINEL of x[clamp(rows[i, j], 0, nx - 1)].
//
// Replaces: src/repro/kernels/spmm/kernel.py, leaf_scan_reduce_kernel
// (pl.pallas_call at :47, body _scan_reduce_kernel at :34).  On the TPU the
// gather vals = x[rows] runs in XLA before the kernel (spmm/ops.py:47-48)
// and the [N, B] f32 vals array goes through HBM.
//
// Bound on the H100: bytes.  Leaf tiles hold a sorted live prefix then
// SENTINEL padding, so the function needs each tile's lines up to its live
// length, that length (4 bytes), the distinct x entries it touches, and y
// (N*4); one add per element is nothing next to that.  On the R-MAT path
// the live prefixes fill about 6% of the slots, so the first port, a warp
// reading all B slots of every tile, was bound by bytes of padding.
//
// Design: a group of kLanes = 8 lanes owns one tile (four tiles a warp) and
// reads only its live prefix, 16 bytes (four ids) a lane at a time on
// the "vec4" route (B % 4 == 0 and rows 16-byte aligned), one id a lane a
// step on the "scalar" route.  The ids stream through with evict-first
// loads (__ldcs), so the tiles do not push x out of L2; the x gathers of
// each int4 are issued independently through the read-only path (__ldg),
// four in flight a lane.  Each lane sums in f64: in f32 a lane's running
// sum over a full tile's ids (B / kLanes of them) drifts from a tree-ordered
// sum by more than 1e-5 on some hub tiles, and an f64 add costs nothing
// next to a gather.  A butterfly __shfl_xor_sync within the group gives the
// sum and the group's first lane writes y[i], rounded once to f32.  Ids are
// clamped to [0, nx) like a JAX gather.
//
// kLanes was chosen on the card from a sweep of group sizes (PERF.md): on
// scale-22 R-MAT tiles (31.7 live ids a tile on average) groups of 4 / 8 /
// 16 / 32 lanes took 0.490 / 0.472 / 0.503 / 0.648 ms.  Loading the next
// int4 before this one's gathers, or two int4 a step, gained under 1%: the
// tiles of more than 32 ids took 0.38 ms at every group size from 8 up.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;  // lanes a tile, a power of two <= 32
constexpr int kSentinel = 0x7fffffff;

__device__ __forceinline__ float gather(const float* __restrict__ x, int id, bool live,
                                        long long nx) {
  if (!live || id == kSentinel) return 0.f;
  const long long k = id < 0 ? 0 : (id >= nx ? nx - 1 : (long long)id);
  return __ldg(x + k);
}

template <bool VEC4>
__global__ void __launch_bounds__(kThreads)
leaf_scan_reduce_kernel(const int* __restrict__ rows, const float* __restrict__ x,
                        const int* __restrict__ length, float* __restrict__ out, long long N,
                        int B, long long nx) {
  const int lane = threadIdx.x & 31;
  const int sub = lane & (kLanes - 1);
  const unsigned gmask = (kLanes == 32 ? 0xffffffffu : (1u << kLanes) - 1)
                         << (lane & ~(kLanes - 1));
  const long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) / kLanes;
  if (i >= N) return;  // the whole group leaves together
  const int m = length ? min(max(__ldg(length + i), 0), B) : B;
  const int* row = rows + i * (long long)B;
  double acc = 0.0;
  if (VEC4) {
    for (int k = 4 * sub; k < m; k += 4 * kLanes) {
      const int4 v = __ldcs(reinterpret_cast<const int4*>(row + k));
      const float a = gather(x, v.x, true, nx);
      const float b = gather(x, v.y, k + 1 < m, nx);
      const float c = gather(x, v.z, k + 2 < m, nx);
      const float d = gather(x, v.w, k + 3 < m, nx);
      acc += ((double)a + b) + ((double)c + d);
    }
  } else {
    for (int k = sub; k < m; k += kLanes) acc += gather(x, __ldcs(row + k), true, nx);
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(gmask, acc, off);
  if (sub == 0) out[i] = (float)acc;
}

}  // namespace

// rows [N, B] int32 (SENTINEL pads); x [nx] f32; length [N] int32 live ids of
// each tile or null (all B); out [N] f32.  vec4 = 1 takes the int4 route:
// B % 4 == 0 and rows 16-byte aligned, else the launch is refused.
extern "C" int leaf_scan_reduce_launch(const void* rows, const void* x, const void* length,
                                       void* out, long long N, int B, long long nx, int vec4,
                                       void* stream) {
  if (N <= 0) return 0;
  if (nx <= 0 || B < 0) return (int)cudaErrorInvalidValue;
  if (vec4 && (B % 4 != 0 || ((uintptr_t)rows % 16) != 0)) return (int)cudaErrorInvalidValue;
  const long long blocks = (N * kLanes + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec4)
    leaf_scan_reduce_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const int*)rows, (const float*)x, (const int*)length, (float*)out, N, B, nx);
  else
    leaf_scan_reduce_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const int*)rows, (const float*)x, (const int*)length, (float*)out, N, B, nx);
  return (int)cudaGetLastError();
}
