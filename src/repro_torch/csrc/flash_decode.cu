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
// 4 * G * dh flops per position and KV head are far below the card's rate.
//
// Both routes split K.  One block per (b, h) would give B * KV = 32 blocks
// for 132 SMs, so the sequence is cut into chunks of a fixed number of
// rows, one block each: block (c, h, b) takes rows [c * chunk,
// (c + 1) * chunk) of the first kv_len[b] (never the masked tail; a chunk
// past kv_len[b] returns at once) and writes a partial (acc, m, l).  Every
// live chunk costs the same, so sequences of different lengths and the
// last wave leave few SMs idle.  A second small kernel merges the live
// partials of a (b, h, g) with the log-sum-exp rule of
// flash_decode.ops.merge_partials and divides acc by l when asked.  The
// wrapper picks the route from the element type and dh alone.
//
// Route "mma" (bf16 K/V, dh a multiple of 16 up to 256): tensor cores.
// The CUDA-core route below ran at 30% of the bound's rate at decode_32k:
// it is bound by issue, not bytes (16 lanes per row repeat each softmax,
// and every dot product costs shuffles).  Here each warp walks tiles of 16
// positions of its block's chunk (warp w takes tiles w, w + 4, ...) through
// a ring of 3 shared-memory stages filled by cp.async, so the next tiles'
// K and V are in flight while the current one is computed.  Rows are
// padded by 16 bytes, which puts the 8 rows of every ldmatrix in distinct
// banks.  Per tile:
//  - S^T [16 pos x 8 heads] = K [16 x dh] q^T [dh x 8] with
//    mma.m16n8k16 (bf16 in, f32 sum): positions are M, the G <= 8 query
//    heads are N (padded with zero heads), dh is K.  K comes by ldmatrix.
//    q is f32, so it is split into kSplit = 3 bf16 terms (q1 = bf16(q),
//    q2 = bf16(q - q1), q3 = bf16(q - q1 - q2)) and S = K q1 + K q2 + K q3:
//    K is exactly bf16, each product is exact in f32, and three terms
//    carry q to a relative 2^-24, as the f32 reference does.  Two terms
//    (2^-16) left the unnormalized partial acc 1.4x outside its atol
//    where a sum of ~1000 terms nearly cancels.
//  - The softmax runs once per (position, head): each score lives in one
//    thread's accumulator (positions g and g + 8, heads 2t and 2t + 1 of
//    lane 4g + t), the running max per head is a max over the 8 lanes that
//    share a column (3 xor shuffles), and exp is taken once per element.
//  - acc^T [dh x 8] += V^T [dh x 16 pos] P^T [16 pos x 8]: V^T comes by
//    ldmatrix.trans, and P is split into 3 bf16 terms like q.  The score
//    fragment holds P with positions on rows; movmatrix.trans turns it into
//    the B operand, positions on K.  acc stays in f32 registers, heads 2t
//    and 2t + 1 in the same lanes as their max, so a rescale needs no
//    shuffle.
// Tensor work is 3x what the product needs and still far below the
// bytes' time.  The warps' states meet once, in shared memory, at the end.
// A chunk is 2048 rows (ops.MMA_CHUNK_ROWS): every block start and end
// costs a pipeline fill and a merge, and fewer, longer blocks measured
// faster at decode_32k.  dh / 16 is a template argument so that q's terms
// and acc stay in registers.
//
// Route "simt" (f32 K/V, or bf16 rows of other widths: any row of L words
// of 16 bytes, 1 <= L <= 64, dh <= 256): CUDA cores.  Inside a block no
// step waits for another warp: each warp walks its own rows straight from
// device memory in groups of P lanes a row, P the power of two at or above
// L up to a warp (a 256-byte bf16 row is one coalesced load of 16 lanes, so
// a warp reads 32 / P rows at once).  Lane i of a group holds the row's
// 16-byte words i, i + P, ...: W = ceil(L / 32) words, one where L <= 32,
// two for f32 rows above 128 floats.  Words past L (lanes L..P-1 of a group,
// and the tail of the second word) load nothing, hold zero q and add 0 to
// the sums: they cost instruction slots, not bytes.  Each lane keeps the G
// query heads' slices of q for its words in registers; a row's G dot products
// are summed over its P lanes with xor shuffles; the running max, the
// rescale and the f32 accumulators stay in registers, with one max per
// kU / W * 32 / P rows and a rescale only when that max moves;
// exponentials use the fast exp2-based __expf (a few ulp; the sums stay
// f32).  K and V are f32 or bf16; everything accumulates in f32.  G and W
// are template arguments (G at most 8), so that q and the accumulators
// stay in registers; with W = 2 each lane keeps kU / 2 rows in flight, so
// that the loads in flight per lane stay 2 kU words.  The warps' states
// take 4 kWarps G (dh + 2) bytes of shared memory: 33,024 at G = 8 and
// dh = 256, under the 48 KB a block gets without asking.
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
// a row is L words of 16 bytes read by P lanes, W words a lane; chunk is a
// multiple of kWarps * (kU / W) * 32 / P rows.
template <typename T, int G, int W>
__global__ void __launch_bounds__(kThreads)
flash_decode_split_kernel(const float* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const int* __restrict__ kv_len,
                          float* __restrict__ pacc, float* __restrict__ pm,
                          float* __restrict__ pl, int S, int KV, int dh, int L, int P, int chunk,
                          float scale, float softcap) {
  constexpr int VE = Chunk<T>::kElems;
  constexpr int U = kU / W;  // rows in flight per lane
  extern __shared__ __align__(16) float smem[];  // m, l [kWarps][G]; acc [kWarps][G][dh]
  float* sm_m = smem;
  float* sm_l = sm_m + kWarps * G;
  float* sm_acc = sm_l + kWarps * G;

  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int R = 32 / P, sub = lane % P, rg = lane / P;
  const int len = min(max(kv_len[b], 0), S);
  const int p_begin = sp * chunk, p_end = min(len, p_begin + chunk);
  if (p_begin >= p_end) return;  // past kv_len: the merge skips this partial
  const long long seq_stride = (long long)KV * dh;
  const long long bh = (long long)b * KV + h;
  const T* kb = k + ((long long)b * S * KV + h) * dh;
  const T* vb = v + ((long long)b * S * KV + h) * dh;
  int word[W];   // this lane's 16-byte words of a row
  bool live[W];  // word < L: the others load nothing and stay zero
#pragma unroll
  for (int j = 0; j < W; ++j) {
    word[j] = j * P + sub;
    live[j] = word[j] < L;
  }

  float qr[G][W][VE];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const float4* qg = reinterpret_cast<const float4*>(q + (bh * G + g) * dh + word[j] * VE);
#pragma unroll
      for (int e = 0; e < VE / 4; ++e) {
        const float4 x = live[j] ? __ldg(qg + e) : make_float4(0.f, 0.f, 0.f, 0.f);
        qr[g][j][4 * e] = x.x;
        qr[g][j][4 * e + 1] = x.y;
        qr[g][j][4 * e + 2] = x.z;
        qr[g][j][4 * e + 3] = x.w;
      }
    }
  }
  float m[G], l[G], acc[G][W][VE];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < W; ++j)
#pragma unroll
      for (int e = 0; e < VE; ++e) acc[g][j][e] = 0.f;
  }

  for (int r0 = p_begin + warp * U * R; r0 < p_end; r0 += kWarps * U * R) {
    uint4 kc[U][W], vc[U][W];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = r0 + u * R + rg;
      ok[u] = row < p_end;
#pragma unroll
      for (int j = 0; j < W; ++j) {
        kc[u][j] = vc[u][j] = make_uint4(0u, 0u, 0u, 0u);
        if (ok[u] && live[j]) {
          const long long off = row * seq_stride + word[j] * VE;
          kc[u][j] = __ldg(reinterpret_cast<const uint4*>(kb + off));
          vc[u][j] = __ldg(reinterpret_cast<const uint4*>(vb + off));
        }
      }
    }
    float s[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[W][VE];
#pragma unroll
      for (int j = 0; j < W; ++j) Chunk<T>::load(kc[u][j], kf[j]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int j = 0; j < W; ++j)
#pragma unroll
          for (int e = 0; e < VE; ++e) d = fmaf(qr[g][j][e], kf[j][e], d);
        for (int o = P >> 1; o; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        d *= scale;
        if (softcap > 0.f) d = softcap * tanhf(d / softcap);
        s[u][g] = ok[u] ? d : kNegInf;
      }
    }
    float p[U][G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = s[0][g];
#pragma unroll
      for (int u = 1; u < U; ++u) mx = fmaxf(mx, s[u][g]);
      for (int o = P; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if (mx > m[g]) {  // warp-uniform: rescale only when the max moves
        const float alpha = __expf(m[g] - mx);
        m[g] = mx;
        l[g] *= alpha;
#pragma unroll
        for (int j = 0; j < W; ++j)
#pragma unroll
          for (int e = 0; e < VE; ++e) acc[g][j][e] *= alpha;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u][g] = ok[u] ? __expf(s[u][g] - m[g]) : 0.f;
        l[g] += p[u][g];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int j = 0; j < W; ++j) {
        float vf[VE];
        Chunk<T>::load(vc[u][j], vf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
#pragma unroll
          for (int e = 0; e < VE; ++e) acc[g][j][e] = fmaf(p[u][g], vf[e], acc[g][j][e]);
        }
      }
    }
  }

  // the warp's row groups share m; sum their l and acc
#pragma unroll
  for (int g = 0; g < G; ++g) {
    for (int o = P; o < 32; o <<= 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
      for (int j = 0; j < W; ++j)
#pragma unroll
        for (int e = 0; e < VE; ++e)
          acc[g][j][e] += __shfl_xor_sync(0xffffffffu, acc[g][j][e], o);
    }
  }
  if (rg == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int j = 0; j < W; ++j)
        if (live[j])
#pragma unroll
          for (int e = 0; e < VE; ++e)
            sm_acc[(warp * G + g) * dh + word[j] * VE + e] = acc[g][j][e];
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

// Grid (B * KV, G), kMergeThreads threads: the log-sum-exp merge of the
// live chunks' partials; acc / l when normalize, else (acc, m, l).  A
// sequence without live positions gives (0, -1e30, 0).  Every warp finds
// the max m; warp w sums the chunks c = w (mod 4), each lane a float4 of
// acc at a time (dh a multiple of 4, at most 256), so the partials' loads
// are independent and in flight together; the warps' sums meet in shared
// memory in a fixed order.
constexpr int kMergeThreads = 128;
constexpr int kMergeWarps = kMergeThreads / 32;

__global__ void __launch_bounds__(kMergeThreads)
flash_decode_merge_kernel(const float* __restrict__ pacc, const float* __restrict__ pm,
                          const float* __restrict__ pl, const int* __restrict__ kv_len,
                          float* __restrict__ out, float* __restrict__ out_m,
                          float* __restrict__ out_l, int S, int KV, int G, int dh, int chunk,
                          int n_chunks, int normalize) {
  __shared__ float4 sm_acc[kMergeWarps][64];
  __shared__ float sm_l[kMergeWarps];
  const long long bh = blockIdx.x;
  const int g = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int len = min(max(kv_len[bh / KV], 0), S);
  const int live = (len + chunk - 1) / chunk;
  const int d4n = dh / 4;
  const float* pmg = pm + bh * n_chunks * G + g;
  const float* plg = pl + bh * n_chunks * G + g;
  float m = kNegInf;
  for (int c = lane; c < live; c += 32) m = fmaxf(m, pmg[(long long)c * G]);
#pragma unroll
  for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float4 a[2] = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
  float l = 0.f;
#pragma unroll 4
  for (int c = warp; c < live; c += kMergeWarps) {
    const long long i = (bh * n_chunks + c) * G + g;
    const float w = expf(pmg[(long long)c * G] - m);
    l += w * plg[(long long)c * G];
    const float4* src = reinterpret_cast<const float4*>(pacc + i * dh);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int d4 = lane + 32 * j;
      if (d4 < d4n) {
        const float4 x = src[d4];
        a[j].x += w * x.x;
        a[j].y += w * x.y;
        a[j].z += w * x.z;
        a[j].w += w * x.w;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    if (lane + 32 * j < d4n) sm_acc[warp][lane + 32 * j] = a[j];
  if (lane == 0) sm_l[warp] = l;
  __syncthreads();
  float lt = 0.f;
  for (int w = 0; w < kMergeWarps; ++w) lt += sm_l[w];
  for (int d4 = threadIdx.x; d4 < d4n; d4 += kMergeThreads) {
    float4 t = sm_acc[0][d4];
    for (int w = 1; w < kMergeWarps; ++w) {
      const float4 x = sm_acc[w][d4];
      t.x += x.x;
      t.y += x.y;
      t.z += x.z;
      t.w += x.w;
    }
    if (normalize) {
      t.x /= lt;
      t.y /= lt;
      t.z /= lt;
      t.w /= lt;
    }
    reinterpret_cast<float4*>(out + (bh * G + g) * dh)[d4] = t;
  }
  if (!normalize && threadIdx.x == 0) {
    out_m[bh * G + g] = m;
    out_l[bh * G + g] = lt;
  }
}

template <typename T, int G, int W>
int launch_g(const float* q, const T* k, const T* v, const int* kv_len, float* pacc, float* pm,
             float* pl, int B, int S, int KV, int dh, int L, int P, int chunk, int n_chunks,
             float softcap, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kWarps * G * (dh + 2);  // at most 33,024 bytes
  const float scale = 1.0f / sqrtf((float)dh);
  flash_decode_split_kernel<T, G, W><<<dim3(n_chunks, KV, B), kThreads, smem, stream>>>(
      q, k, v, kv_len, pacc, pm, pl, S, KV, dh, L, P, chunk, scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T, int W>
int launch_w(const float* q, const T* k, const T* v, const int* kv_len, float* pacc, float* pm,
             float* pl, int B, int S, int KV, int G, int dh, int L, int P, int chunk,
             int n_chunks, float softcap, cudaStream_t stream) {
  switch (G) {
#define FD_CASE(n)                                                                             \
  case n:                                                                                      \
    return launch_g<T, n, W>(q, k, v, kv_len, pacc, pm, pl, B, S, KV, dh, L, P, chunk, n_chunks, \
                             softcap, stream);
    FD_CASE(1) FD_CASE(2) FD_CASE(3) FD_CASE(4) FD_CASE(5) FD_CASE(6) FD_CASE(7) FD_CASE(8)
#undef FD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const float* q, const T* k, const T* v, const int* kv_len, float* pacc, float* pm,
           float* pl, float* out, float* out_m, float* out_l, int B, int S, int KV, int G, int dh,
           int chunk, float softcap, int normalize, cudaStream_t stream) {
  // L words of 16 bytes a row (dh <= 256: L <= 64), read by groups of P
  // lanes (the power of two at or above L, at most a warp), W words a lane
  const int row_bytes = dh * (int)sizeof(T);
  const int L = row_bytes / 16;
  int P = 1;
  while (P < L && P < 32) P <<= 1;
  const int W = (L + 31) / 32;
  const int n_chunks = (S + chunk - 1) / chunk;
  if (row_bytes % 16 || L < 1 || dh > 256 || chunk % (kWarps * (kU / W) * (32 / P)) ||
      ((uintptr_t)k % 16) || ((uintptr_t)v % 16) || ((uintptr_t)q % 16))
    return (int)cudaErrorInvalidValue;
  int e = cudaSuccess;
  if (n_chunks > 0) {
    if (W == 1)
      e = launch_w<T, 1>(q, k, v, kv_len, pacc, pm, pl, B, S, KV, G, dh, L, P, chunk, n_chunks,
                         softcap, stream);
    else if constexpr (sizeof(T) == 4)  // two words a lane: f32 rows of 132-256 floats
      e = launch_w<T, 2>(q, k, v, kv_len, pacc, pm, pl, B, S, KV, G, dh, L, P, chunk, n_chunks,
                         softcap, stream);
    else
      return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  flash_decode_merge_kernel<<<dim3(B * KV, G), kMergeThreads, 0, stream>>>(
      pacc, pm, pl, kv_len, out, out_m, out_l, S, KV, G, dh, chunk, n_chunks, normalize);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// Route "mma": bf16 K/V on tensor cores
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;   // positions per warp step (the mma's M)
constexpr int kStages = 3;  // shared-memory ring depth per warp
constexpr int kN = 8;       // query heads per KV head, padded (the mma's N)
constexpr int kSplit = 3;   // bf16 terms of an f32 operand (q, p)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; zero-filled when !valid (no bytes are read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}
// c += a b: m16n8k16, bf16 in, f32 sum
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}
// (x0, x1) -> kSplit packed bf16 pairs, each the rounded residual of the
// ones before: their sum is (x0, x1) to a relative 2^-(8 kSplit)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t* t) {
#pragma unroll
  for (int i = 0; i < kSplit; ++i) {
    const __nv_bfloat16 h0 = __float2bfloat16_rn(x0), h1 = __float2bfloat16_rn(x1);
    t[i] = pack_bf16(h0, h1);
    x0 -= __bfloat162float(h0);
    x1 -= __bfloat162float(h1);
  }
}

// Grid (n_chunks, KV, B), kThreads threads, smem_bytes<NK>() of dynamic
// shared memory.  dh = 16 * NK; q [B, KV, G, dh] f32; k, v [B, S, KV, dh]
// bf16; partials as in the CUDA-core route; chunk a multiple of kTile.
template <int NK>
__host__ __device__ constexpr int row_stride() {  // bf16 elements per shared row: dh + 16 bytes
  return 16 * NK + 8;
}
template <int NK>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)kWarps * kStages * 2 * kTile * row_stride<NK>() * sizeof(__nv_bfloat16);
}

template <int NK>
__global__ void __launch_bounds__(kThreads)
flash_decode_mma_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const int* __restrict__ kv_len,
                        float* __restrict__ pacc, float* __restrict__ pm,
                        float* __restrict__ pl, int S, int KV, int G, int chunk,
                        int n_chunks, float scale, float softcap) {
  constexpr int DH = 16 * NK;
  constexpr int RS = row_stride<NK>();
  constexpr int TILE = kTile * RS;  // one K or V tile, bf16 elements
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // the mma fragments' row group and column pair
  const int len = min(max(kv_len[b], 0), S);
  const int p_begin = sp * chunk, p_end = min(len, p_begin + chunk);
  if (p_begin >= p_end) return;  // past kv_len: the merge skips this partial
  const long long seq_stride = (long long)KV * DH;
  const long long bh = (long long)b * KV + h;
  const __nv_bfloat16* kb = k + ((long long)b * S * KV + h) * DH;
  const __nv_bfloat16* vb = v + ((long long)b * S * KV + h) * DH;
  __nv_bfloat16* wring = ring + warp * kStages * 2 * TILE;  // this warp's stages: K, V

  // acc^T tile mt: c0 (dh 16 mt + gq, head 2 tq), c1 (same dh, head 2 tq + 1),
  // c2, c3 the same at dh + 8
  float acc[NK][4];
#pragma unroll
  for (int mt = 0; mt < NK; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // heads 2 tq, 2 tq + 1

  const int n_tiles = (p_end - p_begin + kTile - 1) / kTile;
  const int my_tiles = warp < n_tiles ? (n_tiles - warp + kWarps - 1) / kWarps : 0;

  // tile i of this warp (the chunk's tile warp + i * kWarps) into stage st
  auto load_tile = [&](int i, int st) {
    const int r0 = p_begin + (warp + i * kWarps) * kTile;
    __nv_bfloat16* sk = wring + st * 2 * TILE;
    __nv_bfloat16* sv = sk + TILE;
#pragma unroll
    for (int j = 0; j < NK; ++j) {  // 16 rows of 2 NK 16-byte pieces, NK per lane
      const int c = lane + 32 * j;
      const int row = c / (2 * NK), col = (c % (2 * NK)) * 8;
      const bool ok = r0 + row < p_end;
      const long long off = (long long)(ok ? r0 + row : p_begin) * seq_stride + col;
      cp_async16(smem_addr(sk + row * RS + col), kb + off, ok);
      cp_async16(smem_addr(sv + row * RS + col), vb + off, ok);
    }
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < my_tiles) load_tile(st, st);
    cp_async_commit();
  }
  // while the first tiles are in flight: q^T as the B operand (dh on K,
  // heads on N), split into kSplit bf16 terms; lane (gq, tq) holds head gq
  // at dh 16 ks + 2 tq + {0, 1} and + 8
  uint32_t qs[NK][2][kSplit];
  {
    const float* qg = q + (bh * G + min(gq, G - 1)) * DH;
#pragma unroll
    for (int ks = 0; ks < NK; ++ks) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = 16 * ks + 8 * half + 2 * tq;
        const float2 x = gq < G ? *reinterpret_cast<const float2*>(qg + d) : make_float2(0.f, 0.f);
        split_bf16(x.x, x.y, qs[ks][half]);
      }
    }
  }
  // ldmatrix row addresses: K as the A operand (lane -> row lane % 16, dh
  // half lane / 16); V^T by .trans (lane -> position (lane & 7) + 8 * bit 4,
  // dh half bit 3)
  const int k_off = ((lane & 15) * RS + (lane >> 4) * 8) * 2;
  const int v_off = (((lane & 7) + ((lane >> 4) << 3)) * RS + ((lane >> 3) & 1) * 8) * 2;

  for (int it = 0; it < my_tiles; ++it) {
    if (it + kStages - 1 < my_tiles) load_tile(it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this tile's group has landed
    __syncwarp();
    const __nv_bfloat16* sk = wring + (it % kStages) * 2 * TILE;
    const uint32_t ka = smem_addr(sk) + k_off;
    const uint32_t va = smem_addr(sk + TILE) + v_off;
    const int r0 = p_begin + (warp + it * kWarps) * kTile;

    // S^T = sum over the terms of q of K q_term, one accumulator each
    float st[kSplit][4];
#pragma unroll
    for (int i = 0; i < kSplit; ++i) st[i][0] = st[i][1] = st[i][2] = st[i][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NK; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, ka + ks * 32);
#pragma unroll
      for (int i = 0; i < kSplit; ++i) {
        const uint32_t bq[2] = {qs[ks][0][i], qs[ks][1][i]};
        mma_bf16(st[i], a, bq);
      }
    }
    float s[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x = st[kSplit - 1][i];  // the small terms first
#pragma unroll
      for (int j = kSplit - 2; j >= 0; --j) x += st[j][i];
      x *= scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      s[i] = x;
    }
    if (r0 + gq >= p_end) s[0] = s[1] = kNegInf;
    if (r0 + gq + 8 >= p_end) s[2] = s[3] = kNegInf;
    float p[4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float mx = fmaxf(s[j], s[2 + j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      const float mn = fmaxf(m[j], mx);
      const float alpha = __expf(m[j] - mn);
      m[j] = mn;
      p[j] = __expf(s[j] - mn);
      p[2 + j] = __expf(s[2 + j] - mn);
      l[j] = l[j] * alpha + p[j] + p[2 + j];
#pragma unroll
      for (int mt = 0; mt < NK; ++mt) {
        acc[mt][j] *= alpha;
        acc[mt][2 + j] *= alpha;
      }
    }
    // P^T as the B operand (positions on K, heads on N), in kSplit terms
    uint32_t p0[kSplit], p1[kSplit], bp[kSplit][2];
    split_bf16(p[0], p[1], p0);  // positions 0-7
    split_bf16(p[2], p[3], p1);  // positions 8-15
#pragma unroll
    for (int i = 0; i < kSplit; ++i) {
      bp[i][0] = movmatrix_trans(p0[i]);
      bp[i][1] = movmatrix_trans(p1[i]);
    }
#pragma unroll
    for (int mt = 0; mt < NK; ++mt) {
      uint32_t a[4];
      ldmatrix_x4_trans(a, va + mt * 32);
#pragma unroll
      for (int i = kSplit - 1; i >= 0; --i) mma_bf16(acc[mt], a, bp[i]);
    }
    __syncwarp();  // every lane is done with this stage before it refills
  }
  cp_async_wait<0>();

  // l over the 8 lanes that share a column pair
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 4);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 8);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 16);
  }
  __syncthreads();  // the rings are free: reuse them for the warps' states
  float* sm_m = reinterpret_cast<float*>(smem_raw);  // [kWarps][kN]
  float* sm_l = sm_m + kWarps * kN;                  // [kWarps][kN]
  float* sm_acc = sm_l + kWarps * kN;                // [kWarps][kN][DH]
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int hd = warp * kN + 2 * tq + j;
    if (gq == 0) {
      sm_m[hd] = m[j];
      sm_l[hd] = l[j];
    }
#pragma unroll
    for (int mt = 0; mt < NK; ++mt) {
      sm_acc[hd * DH + 16 * mt + gq] = acc[mt][j];
      sm_acc[hd * DH + 16 * mt + gq + 8] = acc[mt][2 + j];
    }
  }
  __syncthreads();
  // the warps' states merged into this split's partial, in a fixed order
  const long long part = bh * n_chunks + sp;
  for (int i = threadIdx.x; i < G * DH; i += kThreads) {
    const int g = i / DH, d = i % DH;
    float mm = kNegInf;
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w * kN + g]);
    float a = 0.f;
    for (int w = 0; w < kWarps; ++w)
      a += expf(sm_m[w * kN + g] - mm) * sm_acc[(w * kN + g) * DH + d];
    pacc[part * G * DH + i] = a;
  }
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float mm = kNegInf;
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w * kN + g]);
    float ls = 0.f;
    for (int w = 0; w < kWarps; ++w) ls += expf(sm_m[w * kN + g] - mm) * sm_l[w * kN + g];
    pm[part * G + g] = mm;
    pl[part * G + g] = ls;
  }
}

constexpr int kMaxCards = 64;  // cards a process may launch on

template <int NK>
int launch_nk(const float* q, const __nv_bfloat16* k, const __nv_bfloat16* v, const int* kv_len,
              float* pacc, float* pm, float* pl, int B, int S, int KV, int G, int chunk,
              int n_chunks, float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<NK>();
  static_assert(smem >= sizeof(float) * kWarps * kN * (16 * NK + 2), "state must fit the ring");
  // The attribute belongs to the current card: set once per card and
  // instantiation, before any graph capture (the wrapper enters the card).
  static bool sized[kMaxCards] = {};
  int card = 0;
  cudaError_t e = cudaGetDevice(&card);
  if (e != cudaSuccess) return (int)e;
  if (card < 0 || card >= kMaxCards) return (int)cudaErrorInvalidDevice;
  if (!sized[card]) {
    e = cudaFuncSetAttribute(flash_decode_mma_kernel<NK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    sized[card] = true;
  }
  const float scale = 1.0f / sqrtf((float)(16 * NK));
  flash_decode_mma_kernel<NK><<<dim3(n_chunks, KV, B), kThreads, smem, stream>>>(
      q, k, v, kv_len, pacc, pm, pl, S, KV, G, chunk, n_chunks, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q [B, KV, G, dh] f32; k, v [B, S, KV, dh] (bf16 when `bf16`, else f32);
// kv_len [B] int32; dh <= 256 with rows of a multiple of 16 bytes; chunk
// rows per block, a multiple of 4 * (4 / W) * 32 / P for the row's L =
// dh * sizeof(element) / 16 words, P lanes a row and W words a lane (see
// launch); scratch pacc [B, KV, n_chunks, G, dh],
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

// Route "mma": the same arguments for bf16 k, v with dh a multiple of 16 in
// [16, 256] and chunk a multiple of 16; G <= 8.
extern "C" int flash_decode_mma_launch(const void* q, const void* k, const void* v,
                                       const void* kv_len, void* pacc, void* pm, void* pl,
                                       void* out, void* out_m, void* out_l, int B, int S, int KV,
                                       int G, int dh, int chunk, float softcap, int normalize,
                                       void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0) return 0;
  if (G > tc::kN || dh < 16 || dh > 256 || dh % 16 || chunk < tc::kTile || chunk % tc::kTile ||
      S < 0 || B > 65535 || KV > 65535 || ((uintptr_t)k % 16) || ((uintptr_t)v % 16) ||
      ((uintptr_t)q % 8))
    return (int)cudaErrorInvalidValue;
  if (!normalize && (out_m == nullptr || out_l == nullptr)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int n_chunks = (S + chunk - 1) / chunk;
  const float* qf = (const float*)q;
  const __nv_bfloat16* kh = (const __nv_bfloat16*)k;
  const __nv_bfloat16* vh = (const __nv_bfloat16*)v;
  float *pa = (float*)pacc, *pmm = (float*)pm, *pll = (float*)pl;
  int e = cudaSuccess;
  if (n_chunks > 0) switch (dh / 16) {
#define FD_MMA_CASE(n)                                                                     \
  case n:                                                                                  \
    e = tc::launch_nk<n>(qf, kh, vh, (const int*)kv_len, pa, pmm, pll, B, S, KV, G, chunk, \
                         n_chunks, softcap, st);                                           \
    break;
      FD_MMA_CASE(1) FD_MMA_CASE(2) FD_MMA_CASE(3) FD_MMA_CASE(4) FD_MMA_CASE(5)
      FD_MMA_CASE(6) FD_MMA_CASE(7) FD_MMA_CASE(8) FD_MMA_CASE(9) FD_MMA_CASE(10)
      FD_MMA_CASE(11) FD_MMA_CASE(12) FD_MMA_CASE(13) FD_MMA_CASE(14) FD_MMA_CASE(15)
      FD_MMA_CASE(16)
#undef FD_MMA_CASE
    }
  if (e != cudaSuccess) return e;
  flash_decode_merge_kernel<<<dim3(B * KV, G), kMergeThreads, 0, st>>>(
      pa, pmm, pll, (const int*)kv_len, (float*)out, (float*)out_m, (float*)out_l, S, KV, G, dh,
      chunk, n_chunks, normalize);
  return (int)cudaGetLastError();
}
