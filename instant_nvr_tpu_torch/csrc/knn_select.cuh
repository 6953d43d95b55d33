// Pass 1 of the per-part KNN kernels for Hopper (sm_90a), shared by
// knn_blend.cu and knn_topk.cu as knn_pallas.py shares
// _best_k_for_tile_loop between _knn_blend_kernel and _knn_kernel.
//
// What it computes.  For each query q and its block's part, the kK nearest
// of the part's real vertices (the first len rows) by the exact float32
// d^2 = (dx^2 + dy^2) + dz^2 of the plain PyTorch version, with
// round-to-nearest intrinsics (every file that includes this one is built
// with --fmad=false).  The result is the kK smallest (d^2, index) pairs in
// lexicographic order, sorted: on an exact distance tie the lower index
// wins, as a scan in index order with a strict `d2 < worst` does on the TPU
// (`take = m < worst`) and in the kernels before this design.  A slot no
// real vertex fills keeps d^2 = kFarInit and index 0.
//
// What bounds it on this card: issued instructions.  Every (query, vertex)
// pair needs a few float32 operations (the bound of chip_smoke.knn_bound
// counts 8), the inputs are a few MB and L2-resident, so time is
// instructions per pair over the SMs' issue rate (4 warp-instructions per
// clock per SM).  Before this design the loop held 145 SASS instructions
// for 4 pairs, the sorted insertion inline, and a warp ran the insertion
// at most vertices (some lane of the 32 almost always had a new
// neighbour).  Now the loop over a group of 32 positions holds 397
// instructions for 64 pairs (6.2 a pair: 3 FFMA, a compare, a mask update,
// half an LDS.128) and a re-check 46 (tools/sass_loops.py).
//
// Design.
// 1. Filter, then re-check exactly.  The shared-memory tile holds each
//    vertex as (x, y, z, w) with w = |v|^2 (1 - kMarginV u) computed once
//    when the tile is stored (u = 2^-24).  A pair costs three explicit FMAs
//    and a compare: s = fma(-2qx, x, fma(-2qy, y, fma(-2qz, z, w))) against
//    thr = fma(d4, 1 + kMarginB u, nq), nq = (kMarginQ u |q|^2 - |q|^2) +
//    kMarginAbs, d4 the query's current 4th d^2.  A vertex that passes
//    (`!(s >= thr)`, so NaN passes) gets the exact d^2 above and the
//    lexicographic insertion.  The FMA intrinsics fuse under --fmad=false.
// 2. Proof that the filter never rejects a vertex the exact scan keeps.
//    Write D = |q - v|^2 (real), S = |v|^2 - 2 q.v, so D = |q|^2 + S, and
//    E for the exact form in float32.  Each operation rounds with relative
//    error <= u plus, for a product or FMA whose result is subnormal, an
//    absolute error eta <= 2^-150 (a subtraction or addition of floats is
//    exact when subnormal).  Assume |q|^2, |v|^2 <= kFilterMax = 2^100, so
//    nothing overflows (|q|, |v| <= 2^50).
//    (a) E >= (1 - 5u) D - 4 eta (two roundings in dx^2, three in the
//        sums, all terms >= 0).  So E <= d4 gives D <= d4 (1 + 5.01u) +
//        4.01 eta.
//    (b) |q|^2 and |v|^2 are computed as fma(x, x, fma(y, y, z*z)): within
//        (1 +- 3.01u) of the real value, +- 3 eta.  w = fl(vv - kMarginV u
//        vv) <= vv (1 - (kMarginV - 1) u) + eta.  Each of the three FMAs of
//        s adds u times a partial sum, and every partial sum is at most
//        |q|^2 + |v|^2 + w (as 2|a b| <= a^2 + b^2), so
//        s <= S + 3u |q|^2 + (10.02 - kMarginV) u |v|^2 + 8 eta
//          <= d4 (1 + 5.01u) - |q|^2 (1 - 3u) + 12.01 eta     (kMarginV >= 11).
//    (c) nq >= -|q|^2 (1 - (kMarginQ - 5.03) u) + kMarginAbs (1 - u) - 4.01 eta,
//        and thr >= d4 + nq + u (kMarginB - 1.01) d4 - u |nq| - eta, so
//        thr - s >= (kMarginB - 6.02) u d4 + (kMarginQ - 9.04) u |q|^2
//                   + kMarginAbs / 2 - 17.02 eta > 0
//        for kMarginB, kMarginQ >= 10 (kMarginAbs = 2^-120 >> 17 eta).
//    So E <= d4 implies s < thr: the filter passes every vertex whose exact
//    d^2 is at or below the current 4th, ties included.  A query with
//    |q|^2 > kFilterMax or not finite gets nq = NaN (thr NaN: every vertex
//    passes); a vertex with |v|^2 > kFilterMax or not finite gets w = NaN
//    (it passes for every query).  Outside the assumption the scan is then
//    the exact one.  tests/test_torch_knn_filter.py reads these constants
//    from this file and holds an emulation of the filter to this claim.
//    The margin is ~1e-6 (|q|^2 + |v|^2 + d4), far below the distances
//    between neighbouring vertices at body scale.
// 3. Coarse to fine, in groups.  The part is scanned in the order
//    index = (k * stride) mod len, stride the first integer from
//    floor(0.618 len) up that is coprime with len (a bijection), so the
//    first positions spread over the part and the 4th
//    distance falls fast (in index order a query below a band of vertices
//    sees nearly every row come closer).  Each lane tests a group of
//    kGroup = 32 positions against the threshold of the group's start,
//    collecting a bit mask per query, then re-checks the set bits in
//    position order; the warp diverges once per group, not once per
//    vertex.  The lexicographic (d^2, index) order makes the result
//    independent of the scan order: it equals the index-order scan's.
//    Keys are one 64-bit word, (float bits of d^2) << 32 | index (d^2 >= 0,
//    so the bits order as the floats), kept sorted in registers.
// 4. kQ queries per thread, all of the block's part: one shared-memory load
//    of a vertex serves kQ queries and the loop's overhead is spread over
//    kQ pairs.
// 5. Fill.  Blocks of kThreads = 64 threads (2 warps) take kThreads * kQ
//    queries of one part; the grid is (ceil(C / (kThreads kQ)), P) and
//    gridDim.y counts ranks, not parts: rank 0 is the longest part, so its
//    blocks are dispatched first and the shortest parts fill the tail;
//    empty parts' blocks only write their outputs.  At kQ = 2 the kernels
//    use 72 registers (ptxas, no spills) and 10 KB of shared memory, so
//    14 blocks (28 warps) fit on an SM.  The render chunk (C = 65,536,
//    P = 5) gives 512 x 5 = 2,560 blocks, 19.4 per SM on 132 SMs: 1.39
//    waves of small blocks, which the dispatcher balances; the train step
//    (C = 16,384) 128 x 5 = 640 blocks, 4.8 per SM (9.7 warps), one wave.
// 6. Tiles are double-buffered: while a tile of kTile positions is
//    scanned, each thread holds its kTile / kThreads loads of the next one
//    in registers (the 12-byte rows of part_pts do not meet cp.async's
//    16-byte alignment) and stores them, as float4 with w, after the scan;
//    one barrier per tile.
// Measured and rejected (NVIDIA H100 80GB HBM3, 700 W; device time of
// tools/kernel_ab.py against a copy with one constant changed): kQ = 4 was
// 20-29% slower at the train shape, 5-7% with ragged parts and equal at
// the render chunk; kQ = 1 16-20% slower at the render chunk for 3-9%
// gained elsewhere.  Counted, not timed (tools/knn_filter.py, the render
// chunk's queries): centring the filter's coordinates on a part's first
// vertex re-checks exactly as many vertices (238.2 a query over the 5
// parts), and so does the bare comparison without the margin, so neither
// centring nor a tighter margin can gain; the index order re-checks 482.9.
// Not tried: the whole part in dynamic shared memory (the kernels take any
// M; a tile costs each thread 4 loads and one barrier per 256 positions).
#pragma once

#include <cuda_runtime.h>

namespace knn_select {

constexpr int kThreads = 64;        // threads per block
constexpr int kQ = 2;               // queries per thread
constexpr int kTile = 256;          // positions per shared-memory tile
constexpr int kGroup = 32;          // positions per filter mask
constexpr int kK = 4;               // neighbours
constexpr float kFarInit = 1.5e9f;  // "no neighbour": exp(-1.5e9 / 2r^2) == 0

// the filter's margin (see the proof above); tests read these lines
constexpr int kMarginV = 16;             // w = |v|^2 (1 - kMarginV u)
constexpr int kMarginQ = 16;             // nq = kMarginQ u |q|^2 - |q|^2 + kMarginAbs
constexpr int kMarginB = 16;             // thr = d4 (1 + kMarginB u) + nq
constexpr float kMarginAbs = 0x1p-120f;  // covers subnormal rounding
constexpr float kFilterMax = 0x1p100f;   // larger |q|^2 or |v|^2: always pass
constexpr float kUlp = 0x1p-24f;         // u

static_assert(kTile % kThreads == 0 && kTile % kGroup == 0, "tile shape");
static_assert(kGroup == 32, "one 32-bit mask per group");

struct Tiles {
  float4 v[2][kTile];  // (x, y, z, w) in scan order
  int idx[2][kTile];   // their vertex indices
};

// The block's part and scan stride, chosen by thread 0.
struct Plan {
  int part, len, stride;
};

__device__ __forceinline__ int clamp_len(const int* lengths, int p, int M) {
  return max(0, min(lengths[p], M));
}

// Thread 0 only: the part of rank `rank` (longest first, ties by part
// index; for P > 32 rank == part) and its scan stride.
__device__ __forceinline__ Plan make_plan(const int* __restrict__ lengths,
                                          int P, int M, int rank) {
  int part = rank;
  if (P <= 32) {
    for (int i = 0; i < P; ++i) {
      const int li = clamp_len(lengths, i, M);
      int r = 0;
      for (int k = 0; k < P; ++k) {
        const int lk = clamp_len(lengths, k, M);
        r += (lk > li) || (lk == li && k < i);
      }
      if (r == rank) part = i;
    }
  }
  const int len = clamp_len(lengths, part, M);
  unsigned s = max(1u, (unsigned)(0.6180339887 * len));
  for (;; ++s) {  // gcd(len - 1, len) == 1 ends it for len >= 2
    unsigned a = s, b = (unsigned)max(len, 1);
    while (b) {
      const unsigned t = a % b;
      a = b;
      b = t;
    }
    if (a == 1) break;
  }
  return {part, len, (int)s};
}

__device__ __forceinline__ float key_d2(unsigned long long key) {
  return __uint_as_float((unsigned)(key >> 32));
}

__device__ __forceinline__ int key_index(unsigned long long key) {
  return (int)(unsigned)key;
}

// Every thread of the block calls this (it synchronises the block).
// verts: the part's (M, 3) vertices; plan: make_plan's, same on all
// threads; q*: the thread's kQ queries, live[i] false for a query past C
// (its filter passes only NaN; its keys go unused).  key[i]: the kK
// smallest (d^2, index) keys of query i, ascending; an unfilled slot holds
// kFarInit with index 0.
__device__ __forceinline__ void best_k(const float* __restrict__ verts,
                                       const Plan plan, const float (&qx)[kQ],
                                       const float (&qy)[kQ],
                                       const float (&qz)[kQ],
                                       const bool (&live)[kQ], Tiles& sm,
                                       unsigned long long (&key)[kQ][kK]) {
  const unsigned long long far =
      (unsigned long long)__float_as_uint(kFarInit) << 32;
  float ax[kQ], ay[kQ], az[kQ], nq[kQ], thr[kQ];
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
#pragma unroll
    for (int k = 0; k < kK; ++k) key[i][k] = far;
    ax[i] = __fmul_rn(-2.f, qx[i]);
    ay[i] = __fmul_rn(-2.f, qy[i]);
    az[i] = __fmul_rn(-2.f, qz[i]);
    const float qq = __fmaf_rn(qx[i], qx[i],
                               __fmaf_rn(qy[i], qy[i], __fmul_rn(qz[i], qz[i])));
    nq[i] = !live[i] ? -__int_as_float(0x7f800000)
            : qq <= kFilterMax
                ? __fadd_rn(__fmaf_rn(qq, kMarginQ * kUlp, -qq), kMarginAbs)
                : __int_as_float(0x7fffffff);
    thr[i] = __fmaf_rn(kFarInit, 1.f + kMarginB * kUlp, nq[i]);
  }
  const int len = plan.len;
  if (len == 0) return;

  // load slot l of this thread holds position tid + l * kThreads of each
  // tile; pos[l] is its vertex index, advanced by one tile's positions
  constexpr int kLoads = kTile / kThreads;
  const unsigned ulen = (unsigned)len;
  const unsigned step = (unsigned)((unsigned long long)kTile * plan.stride % ulen);
  unsigned pos[kLoads];
#pragma unroll
  for (int l = 0; l < kLoads; ++l)
    pos[l] = (unsigned)((unsigned long long)(threadIdx.x + l * kThreads) *
                        plan.stride % ulen);
  float lx[kLoads], ly[kLoads], lz[kLoads];
  auto load = [&](int t0) {
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      if (t0 + (int)threadIdx.x + l * kThreads < len) {
        const float* v = verts + (size_t)pos[l] * 3;
        lx[l] = __ldg(v);
        ly[l] = __ldg(v + 1);
        lz[l] = __ldg(v + 2);
      }
    }
  };
  auto store = [&](int buf, int t0) {
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int j = threadIdx.x + l * kThreads;
      if (t0 + j < len) {
        const float vv = __fmaf_rn(lx[l], lx[l],
                                   __fmaf_rn(ly[l], ly[l], __fmul_rn(lz[l], lz[l])));
        const float w = vv <= kFilterMax ? __fmaf_rn(vv, -kMarginV * kUlp, vv)
                                         : __int_as_float(0x7fffffff);
        sm.v[buf][j] = make_float4(lx[l], ly[l], lz[l], w);
        sm.idx[buf][j] = (int)pos[l];
      }
      pos[l] += step;
      if (pos[l] >= ulen) pos[l] -= ulen;
    }
  };

  load(0);
  store(0, 0);
  __syncthreads();
  const int ntiles = (len + kTile - 1) / kTile;
  for (int t = 0; t < ntiles; ++t) {
    const int t0 = t * kTile;
    const bool next = t + 1 < ntiles;
    if (next) load(t0 + kTile);
    const float4* tv = sm.v[t & 1];
    const int* ti = sm.idx[t & 1];
    const int n = min(kTile, len - t0);
    for (int g = 0; g < n; g += kGroup) {
      unsigned mask[kQ];
#pragma unroll
      for (int i = 0; i < kQ; ++i) mask[i] = 0u;
#pragma unroll
      for (int jj = 0; jj < kGroup; ++jj) {
        const float4 v = tv[g + jj];
#pragma unroll
        for (int i = 0; i < kQ; ++i) {
          const float s = __fmaf_rn(ax[i], v.x,
                                    __fmaf_rn(ay[i], v.y, __fmaf_rn(az[i], v.z, v.w)));
          if (!(s >= thr[i])) mask[i] |= 1u << jj;
        }
      }
      const unsigned valid = n - g >= kGroup ? ~0u : (1u << (n - g)) - 1u;
#pragma unroll
      for (int i = 0; i < kQ; ++i) {
        unsigned m = mask[i] & valid;
        if (!m) continue;
        do {
          const int jj = __ffs(m) - 1;
          m &= m - 1u;
          const float4 v = tv[g + jj];
          const float dx = __fsub_rn(qx[i], v.x);
          const float dy = __fsub_rn(qy[i], v.y);
          const float dz = __fsub_rn(qz[i], v.z);
          const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                     __fmul_rn(dz, dz));
          const unsigned long long c =
              (unsigned long long)__float_as_uint(d2) << 32 | (unsigned)ti[g + jj];
          // sorted insertion: c goes before the first larger key, the
          // others shift down one slot, the last falls out
          const bool c0 = c < key[i][0], c1 = c < key[i][1];
          const bool c2 = c < key[i][2], c3 = c < key[i][3];
          key[i][3] = c2 ? key[i][2] : (c3 ? c : key[i][3]);
          key[i][2] = c1 ? key[i][1] : (c2 ? c : key[i][2]);
          key[i][1] = c0 ? key[i][0] : (c1 ? c : key[i][1]);
          key[i][0] = c0 ? c : key[i][0];
        } while (m);
        thr[i] = __fmaf_rn(key_d2(key[i][kK - 1]), 1.f + kMarginB * kUlp, nq[i]);
      }
    }
    if (next) store((t + 1) & 1, t0 + kTile);
    __syncthreads();
  }
}

}  // namespace knn_select
