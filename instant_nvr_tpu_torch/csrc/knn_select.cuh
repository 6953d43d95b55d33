// Pass 1 of the per-part KNN kernels for Hopper (sm_90a), shared by
// knn_blend.cu and knn_topk.cu as knn_pallas.py shares
// _best_k_for_tile_loop between _knn_blend_kernel and _knn_kernel.
//
// One thread per (query, part), one block per (kThreads-query tile, part).
// The block streams its part's vertices, and only the real ones (the first
// lengths[p] rows), through shared memory in tiles of kTile (x, y, z, pad)
// float4s (16 KB); every thread reads the same vertex at once (a broadcast,
// no bank conflicts) and keeps its best kK (d^2, index) sorted ascending in
// registers.  A new vertex enters only if strictly nearer than the current
// kK-th, so on exact ties the earlier vertex wins, as `take = m < worst`
// does on the TPU.  d^2 is (dx^2 + dy^2) + dz^2 with round-to-nearest
// intrinsics, the rounding of the plain PyTorch version (every file that
// includes this one is built with --fmad=false, so nothing around it fuses
// either), not the |q|^2 + |v|^2 - 2 q.v form whose cancellation flips
// neighbours.  Slots no real vertex fills keep d^2 = kFarInit, index -1.
#pragma once

#include <cuda_runtime.h>

namespace knn_select {

constexpr int kThreads = 128;       // queries per block
constexpr int kTile = 1024;         // vertices per shared-memory tile
constexpr int kK = 4;               // neighbours
constexpr float kFarInit = 1.5e9f;  // "no neighbour": exp(-1.5e9 / 2r^2) == 0

// Every thread of the block calls this (it synchronises the block).
// verts: the part's (M, 3) vertices; len: its real count, 0 <= len <= M.
__device__ __forceinline__ void best_k(const float* __restrict__ verts, int len,
                                       float qx, float qy, float qz,
                                       float4* tile, float (&bd)[kK],
                                       int (&bi)[kK]) {
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    bd[k] = kFarInit;
    bi[k] = -1;
  }
  for (int t0 = 0; t0 < len; t0 += kTile) {
    const int n = min(kTile, len - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float* v = verts + (size_t)(t0 + j) * 3;
      tile[j] = make_float4(v[0], v[1], v[2], 0.f);
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float4 v = tile[j];
      const float dx = __fsub_rn(qx, v.x);
      const float dy = __fsub_rn(qy, v.y);
      const float dz = __fsub_rn(qz, v.z);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      if (d2 < bd[kK - 1]) {
        // sorted insertion: the new vertex goes before the first strictly
        // larger entry; everything after it shifts down one slot
        float cd = d2;
        int ci = t0 + j;
        bool shifting = false;
#pragma unroll
        for (int k = 0; k < kK; ++k) {
          if (shifting || cd < bd[k]) {
            const float td = bd[k];
            const int ti = bi[k];
            bd[k] = cd;
            bi[k] = ci;
            cd = td;
            ci = ti;
            shifting = true;
          }
        }
      }
    }
  }
}

}  // namespace knn_select
