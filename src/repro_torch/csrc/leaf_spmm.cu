// Leaf SpMM over each tile's live prefix:
//   m = length ? min(length[i], B) : B,
//   out[i, :] = sum over j < m with rows[i, j] != SENTINEL of H[rows[i, j], :].
//
// Replaces: src/repro/kernels/spmm/kernel.py, leaf_spmm_kernel
// (pl.pallas_call at :102, body _spmm_kernel at :61).  The TPU form builds a
// one-hot of each row block against a vertex tile of H and contracts it on
// the MXU, with H padded to v_tile rows and 128 columns (spmm/ops.py:66-73);
// neither the one-hot nor the padding is ported.
//
// Bound on the H100: bytes.  The function needs each tile's live ids (its
// lines up to the first SENTINEL), each distinct H row it touches once
// (d*4 bytes) and out (N*d*4); the gather itself touches live*d*4 bytes,
// which L2 serves in part when tiles share neighbours.  One add per
// gathered float is far below the f32 rate.  The first port staged all B
// ids of every tile in shared memory and had each feature thread walk all
// B slots, so it was bound by instructions over padding (6% of the slots
// are live on the R-MAT path), not by bytes.
//
// Design (csrc/embedding_bag.cu's lane groups): a group of gs lanes owns one
// tile, gs = d/4 rounded up to a power of two and at most 32 (a warp at
// d = 128), each lane reading 16 bytes (a float4) of every gathered H row,
// so a row is one coalesced load.  The group reads only the tile's live
// prefix, gs ids at a time (one coalesced load, kept in registers), and
// broadcasts them with __shfl_sync: nothing passes through shared memory.
// Each lane issues kLoads independent row loads before it adds any, into
// kAcc separate accumulators, so several rows are in flight per lane.  The
// sum is written once; rows wider than 4*gs floats are walked in column
// slices.  Ids are clamped to [0, nv) like a JAX gather.  The "scalar"
// route (d % 4 != 0, or H not 16-byte aligned) is the same kernel with one
// float per lane.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSentinel = 0x7fffffff;
constexpr int kThreads = 256;
constexpr int kLoads = 8;  // independent H-row loads in flight per lane
constexpr int kAcc = 4;    // accumulators per lane

__device__ __forceinline__ void add(float4& a, const float4& r) {
  a.x += r.x;
  a.y += r.y;
  a.z += r.z;
  a.w += r.w;
}

__device__ __forceinline__ void add(float& a, float r) { a += r; }

template <typename V>
__device__ __forceinline__ V zero();

template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

template <>
__device__ __forceinline__ float zero<float>() {
  return 0.f;
}

// cols = d / (sizeof(V) / 4) vectors per H and out row; gs a power of two <= 32.
template <typename V>
__global__ void __launch_bounds__(kThreads)
leaf_spmm_kernel(const int* __restrict__ rows, const V* __restrict__ H,
                 const int* __restrict__ length, V* __restrict__ out, long long N, int B,
                 int cols, long long nv, int gs) {
  const int lane = threadIdx.x & 31;
  const int sub = lane & (gs - 1);
  const unsigned gmask = gs == 32 ? 0xffffffffu : ((1u << gs) - 1) << (lane & ~(gs - 1));
  const long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) / gs;
  if (i >= N) return;  // the whole group leaves together
  const int m = length ? min(max(__ldg(length + i), 0), B) : B;
  const int* row = rows + i * (long long)B;
  for (int c0 = 0; c0 < cols; c0 += gs) {  // uniform over the group
    const int c = c0 + sub;
    const bool col = c < cols;
    V acc[kAcc];
#pragma unroll
    for (int u = 0; u < kAcc; ++u) acc[u] = zero<V>();
    for (int k0 = 0; k0 < m; k0 += gs) {
      const int my = k0 + sub < m ? __ldg(row + k0 + sub) : kSentinel;
      const int n = min(gs, m - k0);
      for (int j = 0; j < n; j += kLoads) {
        V r[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          // lanes past n (or past gs, which the shuffle wraps) load nothing
          const int id = __shfl_sync(gmask, my, j + u, gs);
          r[u] = zero<V>();
          if (col && j + u < n && id != kSentinel) {
            const long long k = id < 0 ? 0 : (id >= nv ? nv - 1 : (long long)id);
            r[u] = __ldg(H + k * cols + c);
          }
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u) add(acc[u % kAcc], r[u]);
      }
    }
#pragma unroll
    for (int u = 1; u < kAcc; ++u) add(acc[0], acc[u]);
    if (col) out[i * (long long)cols + c] = acc[0];
  }
}

}  // namespace

// rows [N, B] int32 (SENTINEL pads); H [nv, d] f32; length [N] int32 live ids
// of each tile or null (all B); out [N, d] f32.  vec4 = 1 takes the float4
// route: d % 4 == 0 and H, out 16-byte aligned, else the launch is refused.
extern "C" int leaf_spmm_launch(const void* rows, const void* H, const void* length, void* out,
                                long long N, int B, int d, long long nv, int vec4,
                                void* stream) {
  if (N <= 0 || d <= 0) return 0;
  if (nv <= 0 || B < 0) return (int)cudaErrorInvalidValue;
  if (vec4 && (d % 4 != 0 || ((uintptr_t)H % 16) != 0 || ((uintptr_t)out % 16) != 0))
    return (int)cudaErrorInvalidValue;
  const int cols = vec4 ? d / 4 : d;
  int gs = 1;
  while (gs < cols && gs < 32) gs <<= 1;
  const long long blocks = (N * gs + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec4)
    leaf_spmm_kernel<float4><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const int*)rows, (const float4*)H, (const int*)length, (float4*)out, N, B, cols, nv,
        gs);
  else
    leaf_spmm_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const int*)rows, (const float*)H, (const int*)length, (float*)out, N, B, cols, nv, gs);
  return (int)cudaGetLastError();
}
