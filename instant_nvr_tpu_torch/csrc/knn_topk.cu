// Per-part 4 nearest vertices (squared distance + index) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel instant_nvr_tpu/ops/pallas/knn_pallas.py:
// _knn_kernel (knn_topk_pallas, pass 1 in _best_k_for_tile_loop).  For every
// body part p and query point q it finds the 4 nearest of the part's real
// vertices (the first lengths[p] rows of part_pts[p]) by exact float32
// squared distance and writes them in ascending order:
//   out_d2[p, c, 0:4]  the squared distances,
//   out_idx[p, c, 0:4] the vertex indices (int32).
// A slot no real vertex fills (a part with fewer than 4) holds d2 = 1.5e9
// and index 0, the TPU kernel's initial values (knn_pallas.py:99-100): its
// gaussian weight is exactly 0, and the index is safe to gather with.
//
// Design.  Pass 1 is knn_blend.cu's (knn_select.cuh): one thread per
// (query, part), one block per (128-query tile, part), grid (ceil(C/128),
// P); the part's real vertices stream through shared memory and each thread
// keeps its best 4 sorted in registers.  The thread then writes its 4
// distances as one 16-byte store and its 4 indices as another.
//
// What bounds it: compute, as knn_blend.cu.  About 8 flops per (query,
// vertex) pair, C * sum(lengths) * 8 ~ 3.6 GFLOP at 65,536 queries and
// 6,890 vertices, on the SMs' float32 units; the outputs are P * C * 32
// bytes (10.5 MB there).
#include <cuda_runtime.h>

#include "knn_select.cuh"

namespace {

using knn_select::kK;
using knn_select::kThreads;
using knn_select::kTile;

static_assert(kK == 4, "one float4 / int4 store per (query, part)");

__global__ void __launch_bounds__(kThreads)
knn_topk_kernel(const float* __restrict__ query,     // (C, 3)
                const float* __restrict__ part_pts,  // (P, M, 3)
                const int* __restrict__ lengths,     // (P,)
                float4* __restrict__ out_d2,         // (P, C) x 4
                int4* __restrict__ out_idx,          // (P, C) x 4
                int C, int M) {
  __shared__ float4 tile[kTile];
  const int p = blockIdx.y;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const bool live = c < C;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    qx = query[3 * c + 0];
    qy = query[3 * c + 1];
    qz = query[3 * c + 2];
  }
  float bd[kK];
  int bi[kK];
  knn_select::best_k(part_pts + (size_t)p * M * 3, max(0, min(lengths[p], M)),
                     qx, qy, qz, tile, bd, bi);
  if (!live) return;

  const size_t o = (size_t)p * C + c;
  out_d2[o] = make_float4(bd[0], bd[1], bd[2], bd[3]);
  out_idx[o] = make_int4(max(bi[0], 0), max(bi[1], 0), max(bi[2], 0),
                         max(bi[3], 0));
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int knn_topk_launch(const float* query, const float* part_pts,
                               const int* lengths, float* out_d2, int* out_idx,
                               int C, int P, int M, void* stream) {
  const dim3 grid((C + kThreads - 1) / kThreads, P);
  knn_topk_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      query, part_pts, lengths, reinterpret_cast<float4*>(out_d2),
      reinterpret_cast<int4*>(out_idx), C, M);
  return static_cast<int>(cudaGetLastError());
}
