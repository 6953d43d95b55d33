// Fused per-part KNN + gaussian blend-weight aggregation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel instant_nvr_tpu/ops/pallas/knn_pallas.py:
// _knn_blend_kernel (pass 1 in _best_k_for_tile_loop).  For every query
// point q and every body part p it finds the 4 nearest of the part's real
// vertices (the first lengths[p] rows of part_pts[p]) by exact float32
// squared distance, weights them with exp(-d^2 / 2r^2) normalised by
// (sum + eps), and writes
//   out[c, p, 0:D] = sum_k w_k * part_pbw[p, idx_k, :]
//   out[c, p, D]   = sum_k w_k * d_k, or 1e6 when the nearest vertex lies
//                    beyond 8 r (far rule of instant_nvr_tpu/ops/knn.py).
// Empty parts give a zero blend and 1e6.  The layout is (C, P, D+1), what
// the model consumes, so no transpose follows.
//
// Design.  Pass 1 (knn_select.cuh, shared with knn_topk.cu): one thread per
// (query, part), one block per (128-query tile, part), grid (ceil(C/128),
// P); the part's real vertices stream through shared memory and each thread
// keeps its best 4 sorted in registers, by the plain version's exact f32
// d^2.  The 4 selected blend-weight rows are read in float32 straight from
// global memory (L2-resident: a part's table is ~130 KB).  The TPU kernel
// split them into bf16 hi+lo halves only because its matrix unit truncates
// f32; nothing here is bf16.
//
// What bounds it: compute.  About 8 flops per (query, vertex) pair, so
// C * sum(lengths) * 8 ~ 3.6 GFLOP per render chunk at 65,536 queries and
// 6,890 vertices, on the SMs' float32 units (no tensor cores); memory
// traffic is a few MB.  Making it fast is later work: warp-cooperative
// top-k, tensor-core distance tiles with an exact re-check of the winners,
// coalesced output stores.
#include <cuda_runtime.h>

#include "knn_select.cuh"

namespace {

using knn_select::kK;
using knn_select::kThreads;
using knn_select::kTile;

__global__ void __launch_bounds__(kThreads)
knn_blend_kernel(const float* __restrict__ query,     // (C, 3)
                 const float* __restrict__ part_pts,  // (P, M, 3)
                 const float* __restrict__ part_pbw,  // (P, M, D)
                 const int* __restrict__ lengths,     // (P,)
                 float* __restrict__ out,             // (C, P, D + 1)
                 int C, int P, int M, int D,
                 float two_r2, float far_dist, float eps) {
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

  // gaussian weights: the elementwise math of knn_pallas.py:132-138
  float d[kK], w[kK];
  float wsum = 0.f;
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    d[k] = fminf(sqrtf(fmaxf(bd[k], 0.f)), 1e10f);
    w[k] = expf(-(d[k] * d[k]) / two_r2);
    wsum += w[k];
  }
  const float denom = wsum + eps;
  float agg_dist = 0.f;
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    w[k] = w[k] / denom;
    agg_dist += d[k] * w[k];
  }
  // bd is sorted, so d[0] is the nearest distance
  if (!(d[0] <= far_dist)) agg_dist = 1e6f;

  float* o = out + ((size_t)c * P + p) * (D + 1);
  const float* pbw = part_pbw + (size_t)p * M * D;
  for (int j = 0; j < D; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      if (bi[k] >= 0) acc += w[k] * pbw[(size_t)bi[k] * D + j];
    }
    o[j] = acc;
  }
  o[D] = agg_dist;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int knn_blend_launch(const float* query, const float* part_pts,
                                const float* part_pbw, const int* lengths,
                                float* out, int C, int P, int M, int D,
                                float two_r2, float far_dist, float eps,
                                void* stream) {
  const dim3 grid((C + kThreads - 1) / kThreads, P);
  knn_blend_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      query, part_pts, part_pbw, lengths, out, C, P, M, D, two_r2, far_dist,
      eps);
  return static_cast<int>(cudaGetLastError());
}
