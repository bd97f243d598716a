// Flash decode: grouped-query attention of one new token against a KV cache,
// with online softmax, an optional softcap and a live length per sequence.
//
//   s[b,h,g,t] = softcap(q[b,h,g,:] . k[b,t,h,:] / sqrt(dh))   for t < kv_len[b]
//   acc = sum_t exp(s - m) v[b,t,h,:],  m = max_t s,  l = sum_t exp(s - m)
//
// Replaces: src/repro/kernels/flash_decode/kernel.py, flash_decode_kernel
// (pl.pallas_call at :95, body _kernel at :38) and the final acc / l of
// src/repro/kernels/flash_decode/ops.py.  The TPU grid is (batch, kv_head,
// S / 512) with the sequence axis walked in order and (acc, m, l) carried in
// revisited output blocks; every block past kv_len is still streamed and
// masked.
//
// Bound on the H100: bytes.  A query reads K and V of its sequence once up
// to kv_len: 2 * B * kv_len * KV * dh elements (537 MB at B = 4,
// kv_len = 32768, KV = 8, dh = 128 in bf16), plus q and the output.  Its
// 4 * G * dh flops per position and KV head are far below the f32 rate.
//
// Design: split-K.  One block per (b, h) would give B * KV = 32 blocks for
// 132 SMs, so the sequence is cut into chunks of a fixed number of rows,
// one block each: block (c, h, b) takes rows [c * chunk, (c + 1) * chunk)
// of the first kv_len[b] (never the masked tail; a chunk past kv_len[b]
// returns at once) and writes a partial (acc, m, l).  Every live chunk
// costs the same, so sequences of different lengths and the last wave
// leave few SMs idle.  A second small kernel merges the live partials of a
// (b, h, g) with the log-sum-exp rule of flash_decode.ops.merge_partials
// and divides acc by l when asked.
// Inside a block no step waits for another warp: each warp walks its own
// rows straight from device memory, L = dh * sizeof(T) / 16 lanes per row
// with one 16-byte load each (a 256-byte bf16 row is one coalesced load of
// 16 lanes, so a warp reads 32 / L rows at once), kU rows per lane issued
// together for K and for V.  Each lane keeps the G query heads' slices of
// q for its 16 bytes in registers; a row's G dot products are summed over
// its L lanes with xor shuffles; the running max, the rescale and the
// f32 accumulators stay in registers, with one max per kU * 32 / L rows
// and a rescale only when that max moves; exponentials use the fast
// exp2-based __expf (a few ulp; the sums stay f32).
// The warps' states meet once, in shared memory, at the end.  K and V are
// f32 or bf16; everything accumulates in f32.  G is a template argument
// (at most 8), so that q and the accumulators stay in registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kU = 4;     // rows per lane in flight (K and V each)
constexpr int kMaxG = 8;  // query heads per KV head
constexpr float kNegInf = -1e30f;  // the reference's mask value

// 16 bytes of K or V as floats
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int kElems = 4;
  __device__ __forceinline__ static void load(const uint4& c, float* f) {
    f[0] = __uint_as_float(c.x);
    f[1] = __uint_as_float(c.y);
    f[2] = __uint_as_float(c.z);
    f[3] = __uint_as_float(c.w);
  }
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kElems = 8;
  __device__ __forceinline__ static void load(const uint4& c, float* f) {
    const unsigned w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
};

// Grid (n_chunks, KV, B).  q [B, KV, G, dh] f32; k, v [B, S, KV, dh] T;
// partials pacc [B, KV, n_chunks, G, dh], pm / pl [B, KV, n_chunks, G] f32;
// chunk is a multiple of kWarps * kU * 32 / L rows.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
flash_decode_split_kernel(const float* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const int* __restrict__ kv_len,
                          float* __restrict__ pacc, float* __restrict__ pm,
                          float* __restrict__ pl, int S, int KV, int dh, int L, int chunk,
                          float scale, float softcap) {
  constexpr int VE = Chunk<T>::kElems;
  extern __shared__ __align__(16) float smem[];  // m, l [kWarps][G]; acc [kWarps][G][dh]
  float* sm_m = smem;
  float* sm_l = sm_m + kWarps * G;
  float* sm_acc = sm_l + kWarps * G;

  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int R = 32 / L, sub = lane % L, rg = lane / L;
  const int len = min(max(kv_len[b], 0), S);
  const int p_begin = sp * chunk, p_end = min(len, p_begin + chunk);
  if (p_begin >= p_end) return;  // past kv_len: the merge skips this partial
  const long long seq_stride = (long long)KV * dh;
  const long long bh = (long long)b * KV + h;
  const T* kb = k + ((long long)b * S * KV + h) * dh + sub * VE;
  const T* vb = v + ((long long)b * S * KV + h) * dh + sub * VE;

  float qr[G][VE];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float4* qg = reinterpret_cast<const float4*>(q + (bh * G + g) * dh + sub * VE);
#pragma unroll
    for (int e = 0; e < VE / 4; ++e) {
      const float4 x = __ldg(qg + e);
      qr[g][4 * e] = x.x;
      qr[g][4 * e + 1] = x.y;
      qr[g][4 * e + 2] = x.z;
      qr[g][4 * e + 3] = x.w;
    }
  }
  float m[G], l[G], acc[G][VE];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[g][e] = 0.f;
  }

  for (int r0 = p_begin + warp * kU * R; r0 < p_end; r0 += kWarps * kU * R) {
    uint4 kc[kU], vc[kU];
    bool ok[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int row = r0 + u * R + rg;
      ok[u] = row < p_end;
      kc[u] = vc[u] = make_uint4(0u, 0u, 0u, 0u);
      if (ok[u]) {
        kc[u] = __ldg(reinterpret_cast<const uint4*>(kb + row * seq_stride));
        vc[u] = __ldg(reinterpret_cast<const uint4*>(vb + row * seq_stride));
      }
    }
    float s[kU][G];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float kf[VE];
      Chunk<T>::load(kc[u], kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < VE; ++e) d = fmaf(qr[g][e], kf[e], d);
        for (int o = L >> 1; o; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        d *= scale;
        if (softcap > 0.f) d = softcap * tanhf(d / softcap);
        s[u][g] = ok[u] ? d : kNegInf;
      }
    }
    float p[kU][G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = s[0][g];
#pragma unroll
      for (int u = 1; u < kU; ++u) mx = fmaxf(mx, s[u][g]);
      for (int o = L; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if (mx > m[g]) {  // warp-uniform: rescale only when the max moves
        const float alpha = __expf(m[g] - mx);
        m[g] = mx;
        l[g] *= alpha;
#pragma unroll
        for (int e = 0; e < VE; ++e) acc[g][e] *= alpha;
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        p[u][g] = ok[u] ? __expf(s[u][g] - m[g]) : 0.f;
        l[g] += p[u][g];
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float vf[VE];
      Chunk<T>::load(vc[u], vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int e = 0; e < VE; ++e) acc[g][e] = fmaf(p[u][g], vf[e], acc[g][e]);
      }
    }
  }

  // the warp's row groups share m; sum their l and acc
#pragma unroll
  for (int g = 0; g < G; ++g) {
    for (int o = L; o < 32; o <<= 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
      for (int e = 0; e < VE; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
    }
  }
  if (rg == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < VE; ++e) sm_acc[(warp * G + g) * dh + sub * VE + e] = acc[g][e];
      if (sub == 0) {
        sm_m[warp * G + g] = m[g];
        sm_l[warp * G + g] = l[g];
      }
    }
  }
  __syncthreads();
  // the warps' states merged into this split's partial, in a fixed order
  const long long part = bh * gridDim.x + sp;
  for (int i = threadIdx.x; i < G * dh; i += kThreads) {
    const int g = i / dh;
    float mm = kNegInf;
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w * G + g]);
    float a = 0.f;
    for (int w = 0; w < kWarps; ++w) a += expf(sm_m[w * G + g] - mm) * sm_acc[w * G * dh + i];
    pacc[part * G * dh + i] = a;
  }
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float mm = kNegInf;
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w * G + g]);
    float ls = 0.f;
    for (int w = 0; w < kWarps; ++w) ls += expf(sm_m[w * G + g] - mm) * sm_l[w * G + g];
    pm[part * G + g] = mm;
    pl[part * G + g] = ls;
  }
}

// Grid (B * KV, G), dh threads at most: the log-sum-exp merge of the
// live chunks' partials; acc / l when normalize, else (acc, m, l).  A
// sequence without live positions gives (0, -1e30, 0).
__global__ void flash_decode_merge_kernel(const float* __restrict__ pacc,
                                          const float* __restrict__ pm,
                                          const float* __restrict__ pl,
                                          const int* __restrict__ kv_len, float* __restrict__ out,
                                          float* __restrict__ out_m, float* __restrict__ out_l,
                                          int S, int KV, int G, int dh, int chunk, int n_chunks,
                                          int normalize) {
  const long long bh = blockIdx.x;
  const int g = blockIdx.y;
  const int len = min(max(kv_len[bh / KV], 0), S);
  const int live = (len + chunk - 1) / chunk;
  float m = kNegInf;
  for (int c = 0; c < live; ++c) m = fmaxf(m, pm[(bh * n_chunks + c) * G + g]);
  float l = 0.f;
  for (int c = 0; c < live; ++c) {
    const long long i = (bh * n_chunks + c) * G + g;
    l += expf(pm[i] - m) * pl[i];
  }
  for (int d = threadIdx.x; d < dh; d += blockDim.x) {
    float a = 0.f;
    for (int c = 0; c < live; ++c) {
      const long long i = (bh * n_chunks + c) * G + g;
      a += expf(pm[i] - m) * pacc[i * dh + d];
    }
    out[(bh * G + g) * dh + d] = normalize ? a / l : a;
  }
  if (!normalize && threadIdx.x == 0) {
    out_m[bh * G + g] = m;
    out_l[bh * G + g] = l;
  }
}

template <typename T, int G>
int launch_g(const float* q, const T* k, const T* v, const int* kv_len, float* pacc, float* pm,
             float* pl, int B, int S, int KV, int dh, int L, int chunk, int n_chunks,
             float softcap, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kWarps * G * (dh + 2);
  const float scale = 1.0f / sqrtf((float)dh);
  flash_decode_split_kernel<T, G><<<dim3(n_chunks, KV, B), kThreads, smem, stream>>>(
      q, k, v, kv_len, pacc, pm, pl, S, KV, dh, L, chunk, scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const float* q, const T* k, const T* v, const int* kv_len, float* pacc, float* pm,
           float* pl, float* out, float* out_m, float* out_l, int B, int S, int KV, int G, int dh,
           int chunk, float softcap, int normalize, cudaStream_t stream) {
  // L lanes of 16 bytes per row: a power of two up to a warp
  const int row_bytes = dh * (int)sizeof(T);
  const int L = row_bytes / 16;
  const int n_chunks = (S + chunk - 1) / chunk;
  if (row_bytes % 16 || L < 1 || L > 32 || (L & (L - 1)) || chunk % (kWarps * kU * (32 / L)) ||
      ((uintptr_t)k % 16) || ((uintptr_t)v % 16) || ((uintptr_t)q % 16))
    return (int)cudaErrorInvalidValue;
  int e = cudaSuccess;
  if (n_chunks > 0) switch (G) {
#define FD_CASE(n)                                                                        \
  case n:                                                                                 \
    e = launch_g<T, n>(q, k, v, kv_len, pacc, pm, pl, B, S, KV, dh, L, chunk, n_chunks, \
                       softcap, stream);                                                  \
    break;
    FD_CASE(1) FD_CASE(2) FD_CASE(3) FD_CASE(4) FD_CASE(5) FD_CASE(6) FD_CASE(7) FD_CASE(8)
#undef FD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  flash_decode_merge_kernel<<<dim3(B * KV, G), dh < 128 ? dh : 128, 0, stream>>>(
      pacc, pm, pl, kv_len, out, out_m, out_l, S, KV, G, dh, chunk, n_chunks, normalize);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, KV, G, dh] f32; k, v [B, S, KV, dh] (bf16 when `bf16`, else f32);
// kv_len [B] int32; chunk rows per block, a multiple of 16 * 32 / L for
// L = dh * sizeof(element) / 16; scratch pacc [B, KV, n_chunks, G, dh],
// pm / pl [B, KV, n_chunks, G] f32 with n_chunks = ceil(S / chunk); out [B, KV, G, dh] f32 (acc / l when `normalize`,
// else acc with out_m / out_l [B, KV, G]).  softcap <= 0 means none.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* kv_len, void* pacc, void* pm, void* pl, void* out,
                                   void* out_m, void* out_l, int B, int S, int KV, int G, int dh,
                                   int chunk, int bf16, float softcap, int normalize,
                                   void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0) return 0;
  if (G > kMaxG || dh < 1 || chunk < 1 || S < 0 || B > 65535 || KV > 65535)
    return (int)cudaErrorInvalidValue;
  if (!normalize && (out_m == nullptr || out_l == nullptr)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>((const float*)q, (const __nv_bfloat16*)k,
                                 (const __nv_bfloat16*)v, (const int*)kv_len, (float*)pacc,
                                 (float*)pm, (float*)pl, (float*)out, (float*)out_m,
                                 (float*)out_l, B, S, KV, G, dh, chunk, softcap, normalize, st);
  return launch<float>((const float*)q, (const float*)k, (const float*)v, (const int*)kv_len,
                       (float*)pacc, (float*)pm, (float*)pl, (float*)out, (float*)out_m,
                       (float*)out_l, B, S, KV, G, dh, chunk, softcap, normalize, st);
}
