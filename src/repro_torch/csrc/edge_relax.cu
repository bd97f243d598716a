// Edge relax: one pass over a shard's COO edges (u = src[e], v = dst[e]),
// the per-iteration step of BFS, SSSP and WCC (core/distributed.py):
//   mode 0, flag (BFS):      out[v] = 1 for each live edge with x[u] != 0
//                            (x the bool frontier, out int32 zeroed);
//   mode 1, min_plus (SSSP): out[v] = min(out[v], x[u] + w[e]) for each live
//                            edge with x[u] finite (x f32 distances, out a
//                            copy of x);
//   mode 2, min_both (WCC):  a = x[u], b = x[v]; a < b lowers out[v] to a,
//                            b < a lowers out[u] to b (x int32 labels, out a
//                            copy of x).
// An edge is live when valid (if given) says so and both ids lie in [0, n):
// pad slots and SENTINEL ids are never dereferenced.  x is read, out written
// (Jacobi), so the result is min(x, the plain version's reduction) bit for
// bit: min is exact in any order, and x[u] + w[e] is the same single f32 add.
//
// Replaces no TPU kernel: the JAX package reduces with jax.ops.segment_max /
// segment_min (src/repro/core/distributed.py), which XLA lowers itself.  The
// port's torch chain for the same step (int64 keys, a gathered [m] copy, a
// cast, an identity-filled n + 1 output, scatter_reduce_, whose identity fill
// scatters again through all m keys) held about 33 of 44 busy seconds of the
// benchmark's analytics cell, about 6-7 ms a BFS iteration on 125M edges.
//
// Bound on the H100: bytes of the edge arrays, 8 B an edge of int32 ids
// (12 with SSSP's weights), 0.30 ms for 125M edges at 3.35 TB/s; the vertex
// vectors (4-17 MB at n = 2^22) sit in the 50 MB L2, and the gathers and
// atomics into them are L2 traffic.  Design:
// - a warp takes 128 consecutive edges a step, 4 a lane by 16-byte loads of
//   src, dst and w (evict-first, __ldcs, so they do not push the vertex
//   vectors out of L2); a grid of 8 blocks of 256 threads an SM strides over
//   the edges.  Unaligned operands (a slice at an odd offset) take the same
//   loop with scalar loads;
// - BFS and SSSP read a lane's dst (and w) only when one of its four sources
//   is in the frontier or at a finite distance, so an iteration with a small
//   frontier reads little more than src, 4 B an edge;
// - x is read through the read-only path (__ldg); src is grouped by source,
//   so x[u] hits L1 within a lane's four edges;
// - out[v] is loaded (L2, __ldcg) before any atomic, and the atomic is
//   issued only when the candidate lowers the value seen: values only fall,
//   so a stale load only costs an atomic that changes nothing, and R-MAT's
//   hubs stop taking atomics once their value is small.  BFS stores 1 with
//   no atomic at all;
// - WCC's "into u" side (b < a) is aggregated: a lane keeps the min of its
//   run of equal u, and a segmented min over the warp's lanes (shuffles
//   checking the key) leaves one atomic a run of equal u in the warp.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFlag = 0, kMinPlus = 1, kMinBoth = 2;

struct Args {
  const int* src;
  const int* dst;
  const unsigned char* valid;  // null: every slot live
  const void* x;
  const float* w;
  void* out;
  long long m;
  int n;
};

__device__ __forceinline__ bool in_range(int id, int n) { return (unsigned)id < (unsigned)n; }

// out = min(out, c) for floats, exact: with the sign bit clear a float orders
// as its int bits, with it set in reverse as its unsigned bits.
__device__ __forceinline__ void atomic_min_f32(float* out, float c) {
  if (__float_as_int(c) >= 0)
    atomicMin(reinterpret_cast<int*>(out), __float_as_int(c));
  else
    atomicMax(reinterpret_cast<unsigned*>(out), __float_as_uint(c));
}

__device__ __forceinline__ void lower_i32(int* out, int c) {
  if (c < __ldcg(out)) atomicMin(out, c);
}

// Four consecutive slots 4q .. 4q + 3 of p: one 16-byte load on the VEC route,
// else (and for a quad past the last whole one) each slot alone, 0 past m.
template <bool VEC>
__device__ __forceinline__ void load4(const int* p, long long q, long long m, int (&r)[4]) {
  const long long e0 = 4 * q;
  if (VEC && e0 + 4 <= m) {
    const int4 t = __ldcs(reinterpret_cast<const int4*>(p) + q);
    r[0] = t.x; r[1] = t.y; r[2] = t.z; r[3] = t.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) r[k] = e0 + k < m ? __ldcs(p + e0 + k) : 0;
  }
}

template <bool VEC>
__device__ __forceinline__ void load4(const float* p, long long q, long long m, float (&r)[4]) {
  const long long e0 = 4 * q;
  if (VEC && e0 + 4 <= m) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p) + q);
    r[0] = t.x; r[1] = t.y; r[2] = t.z; r[3] = t.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) r[k] = e0 + k < m ? __ldcs(p + e0 + k) : 0.f;
  }
}

// Slots of quad q that hold an edge (before m, valid if given) whose source
// id lies in [0, n).
template <bool VEC>
__device__ __forceinline__ void live_sources(const Args& a, long long q, int (&u)[4],
                                             bool (&live)[4]) {
  const long long e0 = 4 * q;
  load4<VEC>(a.src, q, a.m, u);
  unsigned vb = 0x01010101u;
  if (a.valid && VEC && e0 + 4 <= a.m) {
    vb = __ldcs(reinterpret_cast<const unsigned*>(a.valid) + q);
  } else if (a.valid) {
    vb = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (e0 + k < a.m) vb |= (unsigned)__ldcs(a.valid + e0 + k) << (8 * k);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    live[k] = e0 + k < a.m && ((vb >> (8 * k)) & 0xffu) && in_range(u[k], a.n);
}

template <int MODE, bool VEC>
__global__ void __launch_bounds__(kThreads) edge_relax_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const long long quads = (a.m + 3) / 4;
  const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) / 32;
  const long long warps = (long long)gridDim.x * (kThreads / 32);
  // every lane of a warp runs the same steps (the shuffles need all 32)
  for (long long base = warp * 32; base < quads; base += warps * 32) {
    const long long q = base + lane;
    int u[4], v[4];
    bool act[4] = {false, false, false, false};
    if (q < quads) live_sources<VEC>(a, q, u, act);
    if (MODE == kFlag) {
      // only sources in the frontier need their destination read
      const unsigned char* x = static_cast<const unsigned char*>(a.x);
      int* out = static_cast<int*>(a.out);
#pragma unroll
      for (int k = 0; k < 4; ++k) act[k] = act[k] && __ldg(x + u[k]);
      if (act[0] || act[1] || act[2] || act[3]) {
        load4<VEC>(a.dst, q, a.m, v);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (act[k] && in_range(v[k], a.n) && __ldcg(out + v[k]) == 0) out[v[k]] = 1;
      }
    } else if (MODE == kMinPlus) {
      // only sources at a finite distance need their destination and weight
      const float* x = static_cast<const float*>(a.x);
      float* out = static_cast<float*>(a.out);
      float du[4], w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        du[k] = act[k] ? __ldg(x + u[k]) : 0.f;
        act[k] = act[k] && du[k] < __int_as_float(0x7f800000);  // +inf (or NaN) lowers nothing
      }
      if (act[0] || act[1] || act[2] || act[3]) {
        load4<VEC>(a.dst, q, a.m, v);
        load4<VEC>(a.w, q, a.m, w);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!act[k] || !in_range(v[k], a.n)) continue;
          const float c = du[k] + w[k];
          if (c < __ldcg(out + v[k])) atomic_min_f32(out + v[k], c);
        }
      }
    } else {
      const int* x = static_cast<const int*>(a.x);
      int* out = static_cast<int*>(a.out);
      int run = -1, best = 0x7fffffff;  // this lane's open run of equal u (b < a side)
      if (act[0] || act[1] || act[2] || act[3]) {
        load4<VEC>(a.dst, q, a.m, v);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!act[k] || !in_range(v[k], a.n)) continue;
          const int xa = __ldg(x + u[k]);
          const int xb = __ldg(x + v[k]);
          if (xa < xb) {
            lower_i32(out + v[k], xa);
          } else if (xb < xa) {
            if (u[k] != run) {
              if (run >= 0) lower_i32(out + run, best);
              run = u[k];
              best = xb;
            } else {
              best = min(best, xb);
            }
          }
        }
      }
      // segmented min over lanes with the same open run: after the five steps
      // the first lane of each stretch of equal keys holds the stretch's min
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int okey = __shfl_down_sync(kFull, run, off);
        const int obest = __shfl_down_sync(kFull, best, off);
        if (lane + off < 32 && okey == run) best = min(best, obest);
      }
      const int prev = __shfl_up_sync(kFull, run, 1);
      if (run >= 0 && (lane == 0 || prev != run)) lower_i32(out + run, best);
    }
  }
}

template <int MODE>
void launch(const Args& a, bool vec, unsigned blocks, cudaStream_t s) {
  if (vec)
    edge_relax_kernel<MODE, true><<<blocks, kThreads, 0, s>>>(a);
  else
    edge_relax_kernel<MODE, false><<<blocks, kThreads, 0, s>>>(a);
}

}  // namespace

// mode 0 flag, 1 min_plus, 2 min_both; src, dst [m] int32; valid [m] bool or
// null; x [n] (bool, f32, int32 by mode); w [m] f32 (min_plus only, else
// null); out [n] (int32 zeros for flag, a copy of x otherwise).  The 16-byte
// route is taken when src, dst and w are 16-byte aligned and valid 4-byte.
extern "C" int edge_relax_launch(int mode, const void* src, const void* dst, const void* valid,
                                 const void* x, const void* w, void* out, long long m, int n,
                                 void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (mode < kFlag || mode > kMinBoth || (mode == kMinPlus && !w)) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const Args a{(const int*)src, (const int*)dst, (const unsigned char*)valid, x,
               (const float*)w, out, m, n};
  const bool vec = (((uintptr_t)src | (uintptr_t)dst | (uintptr_t)w) % 16 == 0) &&
                   ((uintptr_t)valid % 4 == 0);
  const long long warps = ((m + 3) / 4 + 31) / 32;
  long long blocks = (warps * 32 + kThreads - 1) / kThreads;
  if (blocks > (long long)sms * kBlocksPerSM) blocks = (long long)sms * kBlocksPerSM;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == kFlag)
    launch<kFlag>(a, vec, (unsigned)blocks, s);
  else if (mode == kMinPlus)
    launch<kMinPlus>(a, vec, (unsigned)blocks, s);
  else
    launch<kMinBoth>(a, vec, (unsigned)blocks, s);
  return (int)cudaGetLastError();
}
