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
// Design.  One thread per (query, part), one block per (128-query tile,
// part): grid (ceil(C/128), P).  The block streams its part's vertices, and
// only the real ones, through shared memory in tiles of 1024 (x, y, z, pad)
// float4s (16 KB); every thread reads the same vertex at once (a broadcast,
// no bank conflicts) and keeps its best 4 (d^2, index) sorted in registers.
// A new vertex enters only if strictly nearer than the current 4th, so on
// exact ties the earlier vertex wins, as `take = m < worst` does on the TPU.
// d^2 is (dx^2 + dy^2) + dz^2 with round-to-nearest intrinsics, the same
// rounding as the plain PyTorch version (no fused multiply-add; the file is
// built with --fmad=false so the epilogue does not fuse either), not the
// |q|^2 + |v|^2 - 2 q.v form whose cancellation flips neighbours.  The 4
// selected blend-weight rows are read in float32 straight from global
// memory (L2-resident: a part's table is ~130 KB).  The TPU kernel split
// them into bf16 hi+lo halves only because its matrix unit truncates f32;
// nothing here is bf16.
//
// What bounds it: compute.  About 8 flops per (query, vertex) pair, so
// C * sum(lengths) * 8 ~ 3.6 GFLOP per render chunk at 65,536 queries and
// 6,890 vertices, on the SMs' float32 units (no tensor cores); memory
// traffic is a few MB.  Making it fast is later work: warp-cooperative
// top-k, tensor-core distance tiles with an exact re-check of the winners,
// coalesced output stores.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // queries per block
constexpr int kTile = 1024;     // vertices per shared-memory tile
constexpr int kK = 4;           // neighbours
constexpr float kFarInit = 1.5e9f;  // "no neighbour": exp(-1.5e9 / 2r^2) == 0

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
  const int len = max(0, min(lengths[p], M));
  const float* verts = part_pts + (size_t)p * M * 3;

  float bd[kK];
  int bi[kK];
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
