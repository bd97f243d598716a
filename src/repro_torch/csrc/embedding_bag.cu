// EmbeddingBag: out[i, :] = sum over k with ids[i, k] >= 0 of w[i, k] * table[ids[i, k], :];
// mean mode divides by max(sum of those w[i, k], 1e-9).
//
// Replaces: src/repro/kernels/embedding_bag/kernel.py, embedding_bag_kernel
// (pl.pallas_call at :48, body _kernel at :25), with the masking and the
// mean of src/repro/kernels/embedding_bag/ops.py:12.  The TPU prefetches the
// ids into SMEM ahead of the grid so that each grid step (i, k) DMAs one
// table row into VMEM and adds it into the revisited output block of bag i;
// padding is clamped to row 0 with weight 0, so row 0 is still read.
//
// Bound on the H100: bytes.  The function needs each distinct table row it
// touches once (d*4 bytes), the ids and weights (N*K*4 bytes each) and the
// output (N*d*4 bytes).  One multiply-add per gathered float is far below
// the f32 rate.
//
// Design: a group of gs threads owns one bag, gs = d/4 rounded up to a
// power of two and at most 32, each thread reading 16 bytes of a row, so a
// 128-byte row (d = 32) is one coalesced load and a warp serves 32/gs bags.
// The block loads its own ids: each lane of a group loads one id and weight
// of its bag, gs at a time, and the group broadcasts them with __shfl_sync,
// so neither passes through shared memory.  Padding ids (< 0) load
// nothing.  The sum stays in f32 registers and is written once; rows wider
// than 4*gs floats are walked in column tiles.  d must be a multiple of 4
// and the table and output 16-byte aligned; the wrapper refuses other inputs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void fma_row(float4& a, float w, const float4& r) {
  a.x = fmaf(w, r.x, a.x);
  a.y = fmaf(w, r.y, a.y);
  a.z = fmaf(w, r.z, a.z);
  a.w = fmaf(w, r.w, a.w);
}

__device__ __forceinline__ void divide(float4& a, float c) {
  a.x = a.x / c;
  a.y = a.y / c;
  a.z = a.z / c;
  a.w = a.w / c;
}

// cols = d / 4 float4 columns per row.
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const float* __restrict__ table, const int* __restrict__ ids,
                     const float* __restrict__ w, float* __restrict__ out, long long N, int K,
                     int cols, int gs, int mean) {
  const int sub = (threadIdx.x & 31) % gs;
  const long long bag = ((long long)blockIdx.x * kThreads + threadIdx.x) / gs;
  const bool live = bag < N;  // dead lanes still join every shuffle
  const int* bag_ids = ids + (live ? bag : 0) * (long long)K;
  const float* bag_w = w ? w + (live ? bag : 0) * (long long)K : nullptr;
  const float4* tab = reinterpret_cast<const float4*>(table);
  float4* o = reinterpret_cast<float4*>(out) + (live ? bag : 0) * (long long)cols;
  for (int c0 = 0; c0 < cols; c0 += gs) {  // uniform over the warp
    const int c = c0 + sub;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    float wsum = 0.f;
    for (int k0 = 0; k0 < K; k0 += gs) {
      int my_id = -1;
      float my_w = 0.f;
      if (live && k0 + sub < K) {
        my_id = __ldg(bag_ids + k0 + sub);
        my_w = bag_w ? __ldg(bag_w + k0 + sub) : 1.f;
      }
      const int n = min(gs, K - k0);
      for (int j = 0; j < n; ++j) {
        const int id = __shfl_sync(0xffffffffu, my_id, j, gs);
        const float wj = __shfl_sync(0xffffffffu, my_w, j, gs);
        if (id >= 0) {
          wsum += wj;
          if (c < cols) fma_row(acc, wj, __ldg(tab + (long long)id * cols + c));
        }
      }
    }
    if (live && c < cols) {
      if (mean) divide(acc, fmaxf(wsum, 1e-9f));
      o[c] = acc;
    }
  }
}

}  // namespace

// table [V, d] f32, ids [N, K] int32 (-1 pads; live ids must lie in [0, V)),
// w [N, K] f32 or null (weights of 1), out [N, d] f32; mode 0 = sum, 1 = mean.
// d % 4 == 0 and table, out 16-byte aligned.
extern "C" int embedding_bag_launch(const void* table, const void* ids, const void* w, void* out,
                                    long long N, int K, long long V, int d, int mode,
                                    void* stream) {
  if (N <= 0 || d <= 0) return 0;
  if (V <= 0 || K < 0 || (mode != 0 && mode != 1) || d % 4 != 0 ||
      ((uintptr_t)table % 16) != 0 || ((uintptr_t)out % 16) != 0)
    return (int)cudaErrorInvalidValue;
  const int cols = d / 4;
  int gs = 1;
  while (gs < cols && gs < 32) gs <<= 1;
  const long long blocks = (N * gs + kThreads - 1) / kThreads;
  embedding_bag_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const int*)ids, (const float*)w, (float*)out, N, K, cols, gs, mode);
  return (int)cudaGetLastError();
}
