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
// Route "mma" (bf16 K/V, dh a multiple of 16 up to 256): tensor cores.  The
// first CUDA-core kernel ran at 30% of the bound's rate at decode_32k: it
// was bound by instructions, not bytes (16 lanes per row repeated each
// softmax, and every dot product cost shuffles).  Here each warp walks tiles
// of 16 positions of its block's chunk (warp w takes tiles w, w + 4, ...)
// through a ring of 3 shared-memory stages filled by cp.async, so the next
// tiles' K and V are in flight while the current one is computed.  Rows are
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
// of 16 bytes, 1 <= L <= 64, dh <= 256): CUDA cores.  The first CUDA-core
// kernel read a row with a group of lanes, summed each of its G dot
// products with a chain of xor shuffles, repeated the softmax on every lane
// of the group and used each step's loads in the same step: it was bound by
// instructions and latency (10% of the bound at G 8, dh 80).  Here, as on
// route "mma", each warp walks tiles of T positions of its block's chunk
// (warp w takes tiles w, w + 4, ...) through its own ring of kStages
// shared-memory stages filled by cp.async, so the next tiles' K and V are
// in flight while the current one is computed.  A staged row takes L | 1
// words: the odd stride puts the same word of 8 rows in 8 distinct banks.
// Per tile:
//  - Scores: lane t + T hg takes position t and the heads hg, hg + H, ...
//    (H = 32 / T head groups).  It runs their dot products over its staged
//    K row and q's rows, which sit in shared memory and are read as
//    broadcasts: no shuffle.
//  - The softmax runs once per (position, head): the tile's max of a head
//    is one xor-shuffle max over the T lanes of its head group (log2 T
//    steps a tile, not a chain a row), and exp is taken once per score.
//    Each lane keeps its heads' running max and its own positions' part of
//    the sum; p and each head's rescale factor go to the warp's slot in
//    shared memory.
//  - acc += p V: lane i holds acc of the (head, word) pairs i + 32 j (head
//    pair % G, word pair / G): at most 8 G / VE pairs (VE elements a
//    word), 8 G floats.  For four positions at a time it reads its pair's
//    p as one float4 and the staged V words (at G 8, lanes 8 i to 8 i + 7
//    hold the 8 heads of one word and read it as a broadcast).  acc stays
//    in f32 registers and no lane sums another's.
// The warps' states meet once, in shared memory, at the end.  T is the
// largest of 32, 16, 8 and 4 whose rings (kWarps x kStages K and V tiles
// of T rows) fit kRingBytes: 16 at f32 dh 64-80, 8 at dh 128-144, 4 at
// dh 256, 32 for bf16 dh 24 and 72.  G and T are template arguments, so
// that the scores and acc stay in registers and every loop over heads and
// a tile's positions is unrolled and branch-free: the first build of this
// design, with T and the heads a lane as run-time bounds, branched once a
// head a word and ran at 17-32% of the bound's rate at G 8, dh 80.
// Shared memory: q (4 G QS bytes, QS = dh rounded to an odd number of
// float4), p (4 kWarps G (T + 4) bytes) and the rings, which hold the
// warps' states (4 kWarps G (dh + 2) bytes) at the end: 91,264 bytes at
// f32 dh 80, G 8 (two blocks an SM), 77,344 at dh 144, G 2.  Two stages of
// a 90,112-byte budget and 1024 rows a chunk measured fastest over the
// CUDA-core shapes of the model paths (kernels/flash_decode/probe_simt.py
// times the others); exponentials use the fast exp2-based __expf (a few
// ulp; the sums stay f32).  K and V are f32 or bf16; everything
// accumulates in f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// ---------------------------------------------------------------------------
// Route "simt": f32 K/V, and bf16 rows of other widths, on CUDA cores
// ---------------------------------------------------------------------------
namespace simt {

using tc::cp_async16;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::kMaxCards;
using tc::smem_addr;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;                  // shared-memory ring depth per warp
constexpr int kRingBytes = 90112;           // the warps' rings together, at most
constexpr int kMaxTile = 32, kMinTile = 4;  // positions per warp tile
constexpr int kMaxSmem = 232448;            // the H100's dynamic shared memory a block

// A staged row of L 16-byte words takes L | 1 words: an odd stride puts the
// same word of 8 consecutive rows in 8 distinct banks.
__host__ __device__ constexpr int row_stride(int L) { return L | 1; }
inline long long ring_bytes(int T, int L) {
  return (long long)kWarps * kStages * 2 * T * row_stride(L) * 16;
}
// Positions per warp tile: the largest power of two from kMaxTile down to
// kMinTile whose rings fit kRingBytes.  kWarps x kMaxTile divides ops.py's
// CHUNK_ROWS, so every tile size divides the chunk.
inline int tile_rows(int L) {
  int T = kMaxTile;
  while (T > kMinTile && ring_bytes(T, L) > kRingBytes) T >>= 1;
  return T;
}
// q's row stride in floats: dh rounded up to an odd number of float4, so
// that two head groups' rows in one read fall in distinct banks
__host__ __device__ constexpr int q_stride(int dh) { return 4 * ((dh / 4) | 1); }

// Grid (n_chunks, KV, B), kThreads threads; q [B, KV, G, dh] f32; k, v
// [B, S, KV, dh] E; partials pacc [B, KV, n_chunks, G, dh], pm / pl [B, KV,
// n_chunks, G] f32; T positions a warp tile (tile_rows); dynamic shared
// memory: q [G][QS], p [kWarps][G][T + 4] (T probabilities, then the
// rescale factor), then the rings [kWarps][kStages][K, V][T][RS] words,
// which hold the warps' states at the end.  G and T are template arguments:
// every loop over heads, head groups and a tile's positions is unrolled
// and branch-free, so that a tile's shared loads are in flight together.
template <typename E, int G, int T>
__global__ void __launch_bounds__(kThreads)
flash_decode_simt_kernel(const float* __restrict__ q, const E* __restrict__ k,
                         const E* __restrict__ v, const int* __restrict__ kv_len,
                         float* __restrict__ pacc, float* __restrict__ pm,
                         float* __restrict__ pl, int S, int KV, int dh, int chunk, float scale,
                         float softcap) {
  constexpr int VE = Chunk<E>::kElems;  // elements of a 16-byte word
  constexpr int NP = 8 * G / VE;        // (head, word) pairs a lane: G L / 32, L <= 256 / VE
  constexpr int H = 32 / T;             // head groups: lane t + T hg takes heads hg + i H
  constexpr int GH = (G + H - 1) / H;   // heads a lane, i < GH
  constexpr int PS = T + 4;             // a row of p: T probabilities, the rescale factor
  const int L = dh / VE, RS = row_stride(L), QS = q_stride(dh);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* p_s = q_s + G * QS;
  uint4* ring = reinterpret_cast<uint4*>(p_s + kWarps * G * PS);

  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int len = min(max(kv_len[b], 0), S);
  const int p_begin = sp * chunk, p_end = min(len, p_begin + chunk);
  if (p_begin >= p_end) return;  // past kv_len: the merge skips this partial
  const long long seq_stride = (long long)KV * dh;
  const long long bh = (long long)b * KV + h;
  const E* kb = k + ((long long)b * S * KV + h) * dh;
  const E* vb = v + ((long long)b * S * KV + h) * dh;

  const int d4n = dh / 4;
  for (int i = threadIdx.x; i < G * d4n; i += kThreads) {
    const int g = i / d4n, c = i - g * d4n;
    reinterpret_cast<float4*>(q_s + g * QS)[c] =
        __ldg(reinterpret_cast<const float4*>(q + (bh * G + g) * dh) + c);
  }
  __syncthreads();

  const int n_tiles = (p_end - p_begin + T - 1) / T;
  const int my_tiles = warp < n_tiles ? (n_tiles - warp + kWarps - 1) / kWarps : 0;
  uint4* wring = ring + warp * kStages * 2 * T * RS;  // this warp's stages: K, V
  float* pw = p_s + warp * G * PS;                     // this warp's p and rescale factors

  // Tile i of this warp (the chunk's tile warp + i * kWarps) into stage st:
  // word x = lane + 32 j of a tile is row x / L, column x % L, so a lane's
  // copies step by the same offsets in every tile.
  const int r_lane = lane / L, c_lane = lane % L, dr = 32 / L, dc = 32 % L;
  const long long d_off = dr * seq_stride + dc * VE, wrap_off = seq_stride - (long long)L * VE;
  const int d_so = dr * RS + dc, wrap_so = RS - L;
  auto load_tile = [&](int i, int st) {
    const int r0 = p_begin + (warp + i * kWarps) * T;
    const uint32_t sk = smem_addr(wring + st * 2 * T * RS), sv = sk + T * RS * 16;
    const E* k0 = kb + r0 * seq_stride;
    const E* v0 = vb + r0 * seq_stride;
    const int rows = p_end - r0;  // rows past it are zero-filled
    int r = r_lane, c = c_lane, so = r_lane * RS + c_lane;
    long long off = r_lane * seq_stride + c_lane * VE;
    for (int x = lane; x < T * L; x += 32) {
      const bool ok = r < rows;
      cp_async16(sk + so * 16, k0 + (ok ? off : 0), ok);
      cp_async16(sv + so * 16, v0 + (ok ? off : 0), ok);
      r += dr;
      c += dc;
      off += d_off;
      so += d_so;
      if (c >= L) {
        c -= L;
        ++r;
        off += wrap_off;
        so += wrap_so;
      }
    }
  };

  const int t_lane = lane % T, hg = lane / T;
  const float* qh[GH];  // this lane's heads' rows of q
#pragma unroll
  for (int i = 0; i < GH; ++i) qh[i] = q_s + min(hg + i * H, G - 1) * QS;
  float m[GH], l[GH];  // per head of this lane: running max, sum over its positions
#pragma unroll
  for (int i = 0; i < GH; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  // p V: pair lane + 32 j is head (pair % G), word (pair / G); np pairs are
  // live somewhere in the warp, those past G L in none
  const int np = (G * L + 31) / 32;
  float acc[NP][VE];
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < my_tiles) load_tile(st, st);
    cp_async_commit();
  }
  for (int it = 0; it < my_tiles; ++it) {
    if (it + kStages - 1 < my_tiles) load_tile(it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this tile's group has landed
    __syncwarp();
    const uint4* sk = wring + (it % kStages) * 2 * T * RS;
    const uint4* sv = sk + T * RS;
    const int r0 = p_begin + (warp + it * kWarps) * T;

    // scores of position t_lane against this lane's heads: no shuffle
    float s[GH];
#pragma unroll
    for (int i = 0; i < GH; ++i) s[i] = 0.f;
    const uint4* krow = sk + t_lane * RS;
#pragma unroll 4
    for (int w = 0; w < L; ++w) {
      const uint4 kw = krow[w];  // one 16-byte shared load
      float kf[VE];
      Chunk<E>::load(kw, kf);
#pragma unroll
      for (int i = 0; i < GH; ++i) {
        const float4* qw = reinterpret_cast<const float4*>(qh[i] + w * VE);
#pragma unroll
        for (int e4 = 0; e4 < VE / 4; ++e4) {
          const float4 x = qw[e4];
          s[i] = fmaf(x.x, kf[4 * e4], s[i]);
          s[i] = fmaf(x.y, kf[4 * e4 + 1], s[i]);
          s[i] = fmaf(x.z, kf[4 * e4 + 2], s[i]);
          s[i] = fmaf(x.w, kf[4 * e4 + 3], s[i]);
        }
      }
    }
    // the softmax once per (position, head): one max per head a tile over
    // the T lanes of a head group
    const bool live = r0 + t_lane < p_end;
    float x[GH], mx[GH];
#pragma unroll
    for (int i = 0; i < GH; ++i) {
      x[i] = s[i] * scale;
      if (softcap > 0.f) x[i] = softcap * tanhf(x[i] / softcap);
      x[i] = live ? x[i] : kNegInf;
      mx[i] = x[i];
    }
#pragma unroll
    for (int o = 1; o < T; o <<= 1)
#pragma unroll
      for (int i = 0; i < GH; ++i) mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], o));
#pragma unroll
    for (int i = 0; i < GH; ++i) {
      const float mn = fmaxf(m[i], mx[i]);
      const float alpha = __expf(m[i] - mn);
      const float p = live ? __expf(x[i] - mn) : 0.f;
      m[i] = mn;
      l[i] = l[i] * alpha + p;
      const int g = hg + i * H;
      if (g < G) {
        pw[g * PS + t_lane] = p;
        if (t_lane == 0) pw[g * PS + T] = alpha;
      }
    }
    __syncwarp();
    // acc = alpha acc + sum over the tile's positions of p V, a pair at a time
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      if (j < np) {
        const int pair = lane + 32 * j;
        const int g = pair % G, w = min(pair / G, L - 1);  // a dead pair reads a live word
        const float* pg = pw + g * PS;
        const float a = pg[T];
#pragma unroll
        for (int e = 0; e < VE; ++e) acc[j][e] *= a;
#pragma unroll
        for (int t4 = 0; t4 < T; t4 += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(pg + t4);
          const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const uint4 vw = sv[(t4 + u) * RS + w];
            float vf[VE];
            Chunk<E>::load(vw, vf);
#pragma unroll
            for (int e = 0; e < VE; ++e) acc[j][e] = fmaf(pv[u], vf[e], acc[j][e]);
          }
        }
      }
    }
    __syncwarp();  // every lane is done with this stage and p before they refill
  }
  cp_async_wait<0>();

  // l over the T lanes of a head group
#pragma unroll
  for (int o = 1; o < T; o <<= 1)
#pragma unroll
    for (int i = 0; i < GH; ++i) l[i] += __shfl_xor_sync(0xffffffffu, l[i], o);
  __syncthreads();  // the rings are free: reuse them for the warps' states
  float* sm_m = reinterpret_cast<float*>(ring);  // [kWarps][G]
  float* sm_l = sm_m + kWarps * G;               // [kWarps][G]
  float* sm_acc = sm_l + kWarps * G;             // [kWarps][G][dh]
  if (t_lane == 0) {
#pragma unroll
    for (int i = 0; i < GH; ++i) {
      const int g = hg + i * H;
      if (g < G) {
        sm_m[warp * G + g] = m[i];
        sm_l[warp * G + g] = l[i];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int pair = lane + 32 * j;
    if (j < np && pair < G * L) {
      float* dst = sm_acc + (warp * G + pair % G) * dh + (pair / G) * VE;
#pragma unroll
      for (int e = 0; e < VE; ++e) dst[e] = acc[j][e];
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

// Dynamic shared memory of a launch: q, p, and the rings or the warps'
// states, whichever is larger
inline long long smem_bytes(int G, int dh, int L, int T) {
  const long long state = 4LL * kWarps * G * (dh + 2);
  const long long rings = ring_bytes(T, L);
  return 4LL * G * q_stride(dh) + 4LL * kWarps * G * (T + 4) + (rings > state ? rings : state);
}

template <typename E, int G, int T>
int launch_t(const float* q, const E* k, const E* v, const int* kv_len, float* pacc, float* pm,
             float* pl, int B, int S, int KV, int dh, int chunk, int n_chunks, float softcap,
             cudaStream_t stream) {
  const int L = dh * (int)sizeof(E) / 16;
  const long long smem = smem_bytes(G, dh, L, T);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  // The attributes belong to the current card: set once per card and
  // instantiation, to the most any launch asks, before any graph capture
  // (the wrapper enters the card).
  static bool sized[kMaxCards] = {};
  int card = 0;
  cudaError_t e = cudaGetDevice(&card);
  if (e != cudaSuccess) return (int)e;
  if (card < 0 || card >= kMaxCards) return (int)cudaErrorInvalidDevice;
  if (!sized[card]) {
    e = cudaFuncSetAttribute(flash_decode_simt_kernel<E, G, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_decode_simt_kernel<E, G, T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    sized[card] = true;
  }
  const float scale = 1.0f / sqrtf((float)dh);
  flash_decode_simt_kernel<E, G, T><<<dim3(n_chunks, KV, B), kThreads, (size_t)smem, stream>>>(
      q, k, v, kv_len, pacc, pm, pl, S, KV, dh, chunk, scale, softcap);
  return (int)cudaGetLastError();
}

template <typename E, int G>
int launch_g(const float* q, const E* k, const E* v, const int* kv_len, float* pacc, float* pm,
             float* pl, int B, int S, int KV, int dh, int T, int chunk, int n_chunks,
             float softcap, cudaStream_t stream) {
  switch (T) {
    case 32:
      return launch_t<E, G, 32>(q, k, v, kv_len, pacc, pm, pl, B, S, KV, dh, chunk, n_chunks,
                                softcap, stream);
    case 16:
      return launch_t<E, G, 16>(q, k, v, kv_len, pacc, pm, pl, B, S, KV, dh, chunk, n_chunks,
                                softcap, stream);
    case 8:
      return launch_t<E, G, 8>(q, k, v, kv_len, pacc, pm, pl, B, S, KV, dh, chunk, n_chunks,
                               softcap, stream);
    case 4:
      return launch_t<E, G, 4>(q, k, v, kv_len, pacc, pm, pl, B, S, KV, dh, chunk, n_chunks,
                               softcap, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename E>
int launch(const float* q, const E* k, const E* v, const int* kv_len, float* pacc, float* pm,
           float* pl, float* out, float* out_m, float* out_l, int B, int S, int KV, int G, int dh,
           int chunk, float softcap, int normalize, cudaStream_t stream) {
  // L words of 16 bytes a row (dh <= 256: L <= 64); T positions a warp tile
  const int row_bytes = dh * (int)sizeof(E);
  const int L = row_bytes / 16;
  if (row_bytes % 16 || L < 1 || dh > 256 || ((uintptr_t)k % 16) || ((uintptr_t)v % 16) ||
      ((uintptr_t)q % 16))
    return (int)cudaErrorInvalidValue;
  const int T = tile_rows(L);
  if (ring_bytes(T, L) > kRingBytes || chunk % (kWarps * T)) return (int)cudaErrorInvalidValue;
  const int n_chunks = (S + chunk - 1) / chunk;
  int e = cudaSuccess;
  if (n_chunks > 0) switch (G) {
#define FD_SIMT_CASE(n)                                                                        \
  case n:                                                                                      \
    e = launch_g<E, n>(q, k, v, kv_len, pacc, pm, pl, B, S, KV, dh, T, chunk, n_chunks, softcap, \
                       stream);                                                                \
    break;
      FD_SIMT_CASE(1) FD_SIMT_CASE(2) FD_SIMT_CASE(3) FD_SIMT_CASE(4) FD_SIMT_CASE(5)
      FD_SIMT_CASE(6) FD_SIMT_CASE(7) FD_SIMT_CASE(8)
#undef FD_SIMT_CASE
      default:
        return (int)cudaErrorInvalidValue;
    }
  if (e != cudaSuccess) return e;
  flash_decode_merge_kernel<<<dim3(B * KV, G), kMergeThreads, 0, stream>>>(
      pacc, pm, pl, kv_len, out, out_m, out_l, S, KV, G, dh, chunk, n_chunks, normalize);
  return (int)cudaGetLastError();
}

}  // namespace simt

}  // namespace

// Route "simt".  q [B, KV, G, dh] f32; k, v [B, S, KV, dh] (bf16 when
// `bf16`, else f32); kv_len [B] int32; dh <= 256 with rows of a multiple of
// 16 bytes; chunk rows per block, a multiple of 4 T for the row's T
// positions a warp tile (simt::tile_rows); scratch pacc [B, KV, n_chunks,
// G, dh], pm / pl [B, KV, n_chunks, G] f32 with n_chunks = ceil(S /
// chunk); out [B, KV, G, dh] f32 (acc / l when `normalize`, else acc with
// out_m / out_l [B, KV, G]).  softcap <= 0 means none.
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
    return simt::launch<__nv_bfloat16>((const float*)q, (const __nv_bfloat16*)k,
                                       (const __nv_bfloat16*)v, (const int*)kv_len, (float*)pacc,
                                       (float*)pm, (float*)pl, (float*)out, (float*)out_m,
                                       (float*)out_l, B, S, KV, G, dh, chunk, softcap, normalize,
                                       st);
  return simt::launch<float>((const float*)q, (const float*)k, (const float*)v,
                             (const int*)kv_len, (float*)pacc, (float*)pm, (float*)pl, (float*)out,
                             (float*)out_m, (float*)out_l, B, S, KV, G, dh, chunk, softcap,
                             normalize, st);
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
