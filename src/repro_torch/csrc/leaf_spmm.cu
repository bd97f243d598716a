// Leaf SpMM: out[i, :] = sum over j with rows[i, j] != SENTINEL of H[rows[i, j], :].
//
// Replaces: src/repro/kernels/spmm/kernel.py, leaf_spmm_kernel
// (pl.pallas_call at :102, body _spmm_kernel at :61).  The TPU form builds a
// one-hot of each row block against a vertex tile of H and contracts it on
// the MXU, with H padded to v_tile rows and 128 columns (spmm/ops.py:66-73);
// neither the one-hot nor the padding is ported.
//
// Bound on the H100: bytes.  The function needs each row's lines up to its
// first SENTINEL (leaf tiles hold a sorted live prefix), each distinct H row
// it touches once (d*4 bytes), and out (N*d*4); the gather itself touches
// live*d*4 bytes, which L2 serves in part when rows share neighbours.  One
// add per gathered float is far below the f32 rate.  This kernel stages
// all B ids of each row.
//
// Design: a block of (F, R) threads covers R tile rows and F <= 128
// consecutive features.  The R rows' ids are staged in shared memory
// (R*B*4 bytes, 8 KB at R=4, B=512) once, then every thread walks its
// row's B ids and adds H[id, f]: the F threads of a row read F consecutive
// floats of one H row, so each gather is coalesced.  The sum stays in a
// register and is written once.  Dead columns (SENTINEL) load nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSentinel = 0x7fffffff;
constexpr int kRows = 4;  // tile rows per block (blockDim.y)

__global__ void leaf_spmm_kernel(const int* __restrict__ rows, const float* __restrict__ H,
                                 float* __restrict__ out, long long N, int B, int d,
                                 long long nv) {
  extern __shared__ int srow[];  // [kRows][B]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long long i = (long long)blockIdx.x * kRows + ty;
  int* my = srow + ty * B;
  if (i < N) {
    const int* row = rows + i * (long long)B;
    for (int j = tx; j < B; j += blockDim.x) my[j] = __ldg(row + j);
  }
  __syncthreads();
  const int f = blockIdx.y * blockDim.x + tx;
  if (i >= N || f >= d) return;
  float acc = 0.f;
#pragma unroll 4
  for (int j = 0; j < B; ++j) {
    const int r = my[j];
    if (r != kSentinel) {
      const long long k = r < 0 ? 0 : (r >= nv ? nv - 1 : (long long)r);
      acc += __ldg(H + k * d + f);
    }
  }
  out[i * d + f] = acc;
}

}  // namespace

extern "C" int leaf_spmm_launch(const void* rows, const void* H, void* out, long long N,
                                int B, int d, long long nv, void* stream) {
  if (N <= 0 || d <= 0) return 0;
  if (nv <= 0) return (int)cudaErrorInvalidValue;
  const int F = d >= 128 ? 128 : ((d + 31) / 32) * 32;
  const size_t smem = (size_t)kRows * B * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        leaf_spmm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 block(F, kRows);
  dim3 grid((unsigned)((N + kRows - 1) / kRows), (unsigned)((d + F - 1) / F));
  leaf_spmm_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const int*)rows, (const float*)H, (float*)out, N, B, d, nv);
  return (int)cudaGetLastError();
}
