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
// Design.  Pass 1 is knn_blend.cu's (knn_select.cuh: a three-FMA filter
// with an exact re-check, 2 queries per thread, blocks of 64 threads ranked
// longest part first, double-buffered tiles).  Each thread then writes,
// for each of its queries, the 4 distances as one 16-byte store and the 4
// indices as another; neighbouring threads hold neighbouring queries, so a
// warp's stores are contiguous.
//
// What bounds it: issued instructions, as knn_blend.cu (chip_smoke.py
// counts 8 float32 operations per (query, vertex) pair for the bound:
// C * sum(lengths) * 8 ~ 3.6 GFLOP at 65,536 queries and 6,890 vertices);
// the outputs are P * C * 32 bytes (10.5 MB there).
#include <cuda_runtime.h>

#include "knn_select.cuh"

namespace {

using knn_select::kK;
using knn_select::kQ;
using knn_select::kThreads;

static_assert(kK == 4, "one float4 / int4 store per (query, part)");

__global__ void __launch_bounds__(kThreads)
knn_topk_kernel(const float* __restrict__ query,     // (C, 3)
                const float* __restrict__ part_pts,  // (P, M, 3)
                const int* __restrict__ lengths,     // (P,)
                float4* __restrict__ out_d2,         // (P, C) x 4
                int4* __restrict__ out_idx,          // (P, C) x 4
                int C, int P, int M) {
  __shared__ knn_select::Tiles sm;
  __shared__ knn_select::Plan plan;
  if (threadIdx.x == 0) plan = knn_select::make_plan(lengths, P, M, blockIdx.y);
  __syncthreads();
  const knn_select::Plan pl = plan;

  int c[kQ];
  bool live[kQ];
  float qx[kQ], qy[kQ], qz[kQ];
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    c[i] = (blockIdx.x * kQ + i) * kThreads + threadIdx.x;
    live[i] = c[i] < C;
    const int cc = live[i] ? c[i] : 0;
    qx[i] = query[3 * cc + 0];
    qy[i] = query[3 * cc + 1];
    qz[i] = query[3 * cc + 2];
  }
  unsigned long long key[kQ][kK];
  knn_select::best_k(part_pts + (size_t)pl.part * M * 3, pl, qx, qy, qz, live,
                     sm, key);

#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    if (!live[i]) continue;
    const size_t o = (size_t)pl.part * C + c[i];
    out_d2[o] = make_float4(knn_select::key_d2(key[i][0]), knn_select::key_d2(key[i][1]),
                            knn_select::key_d2(key[i][2]), knn_select::key_d2(key[i][3]));
    out_idx[o] = make_int4(knn_select::key_index(key[i][0]),
                           knn_select::key_index(key[i][1]),
                           knn_select::key_index(key[i][2]),
                           knn_select::key_index(key[i][3]));
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int knn_topk_launch(const float* query, const float* part_pts,
                               const int* lengths, float* out_d2, int* out_idx,
                               int C, int P, int M, void* stream) {
  const dim3 grid((C + kThreads * kQ - 1) / (kThreads * kQ), P);
  knn_topk_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      query, part_pts, lengths, reinterpret_cast<float4*>(out_d2),
      reinterpret_cast<int4*>(out_idx), C, P, M);
  return static_cast<int>(cudaGetLastError());
}
