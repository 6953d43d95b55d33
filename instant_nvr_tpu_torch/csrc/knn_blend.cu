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
// Design.  Pass 1 (knn_select.cuh, shared with knn_topk.cu): each thread
// holds 2 queries of its block's part; a three-FMA filter of the expanded
// |v|^2 - 2 q.v form, with a proved float32 margin, sends only the
// vertices that may enter a query's best 4 to the exact (dx^2 + dy^2) + dz^2
// and a sorted insertion; the part is scanned coarse to fine through
// double-buffered shared-memory tiles, the longest part's blocks first.
// The selection is the plain version's exactly (on a tie the lower index
// wins).  The epilogue reads each selected blend-weight row in float32 as
// 16-byte loads (L2-resident: a part's table is ~130 KB) and stages the
// block's rows of D + 1 outputs in the tiles' shared memory, so that a
// warp then writes whole rows of neighbouring floats; before, each thread
// made D scalar gathers per neighbour and D + 1 stores at a (P (D + 1))-
// float stride, and the kernel took 38% longer than knn_topk on the same
// pass 1 (0.2583 against 0.1866 ms of device time at the render chunk,
// tools/kernel_ab.py; NVIDIA H100 80GB HBM3, 700 W); restaged, 0.2207
// against 0.1862.  Rows that are not 16-byte aligned take scalar loads,
// and D + 1 > 40 direct stores.  The TPU kernel split the rows into bf16 hi+lo halves only
// because its matrix unit truncates f32; nothing here is bf16.
//
// What bounds it: issued instructions in pass 1 (knn_select.cuh); the
// bound chip_smoke.py states counts 8 float32 operations per (query,
// vertex) pair, C * sum(lengths) * 8 ~ 3.6 GFLOP per render chunk at
// 65,536 queries and 6,890 vertices; memory traffic is a few MB.
#include <cuda_runtime.h>

#include <cstdint>

#include "knn_select.cuh"

namespace {

using knn_select::kK;
using knn_select::kQ;
using knn_select::kThreads;

__global__ void __launch_bounds__(kThreads)
knn_blend_kernel(const float* __restrict__ query,     // (C, 3)
                 const float* __restrict__ part_pts,  // (P, M, 3)
                 const float* __restrict__ part_pbw,  // (P, M, D)
                 const int* __restrict__ lengths,     // (P,)
                 float* __restrict__ out,             // (C, P, D + 1)
                 int C, int P, int M, int D,
                 float two_r2, float far_dist, float eps, bool vec,
                 bool staged) {
  __shared__ knn_select::Tiles sm;
  __shared__ knn_select::Plan plan;
  if (threadIdx.x == 0) plan = knn_select::make_plan(lengths, P, M, blockIdx.y);
  __syncthreads();
  const knn_select::Plan pl = plan;
  const int p = pl.part;

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
  knn_select::best_k(part_pts + (size_t)p * M * 3, pl, qx, qy, qz, live, sm,
                     key);

  const float* pbw = part_pbw + (size_t)p * M * D;
  // pass 1 ended with a barrier, so the tiles' shared memory is free: it
  // stages the block's kThreads rows of D + 1 floats for each query slot
  float* stage = reinterpret_cast<float*>(&sm);
  const int row = D + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const int c0 = (blockIdx.x * kQ + i) * kThreads;
    float* o = staged ? stage + threadIdx.x * row
                      : out + ((size_t)c[i] * P + p) * row;
    if (live[i]) {
      // gaussian weights: the elementwise math of knn_pallas.py:132-138
      float d[kK], w[kK];
      const float* r[kK];
      bool real[kK];
      float wsum = 0.f;
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        const float d2 = knn_select::key_d2(key[i][k]);
        real[k] = d2 < knn_select::kFarInit;
        r[k] = pbw + (size_t)knn_select::key_index(key[i][k]) * D;
        d[k] = fminf(sqrtf(fmaxf(d2, 0.f)), 1e10f);
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
      // the keys are sorted, so d[0] is the nearest distance
      if (!(d[0] <= far_dist)) agg_dist = 1e6f;
      // each column sums its neighbours in slot order, as before: the
      // 16-byte loads change no rounding
      if (vec) {
        for (int j = 0; j < D; j += 4) {
          float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int k = 0; k < kK; ++k) {
            if (!real[k]) continue;
            const float4 v = __ldg(reinterpret_cast<const float4*>(r[k] + j));
            acc.x += w[k] * v.x;
            acc.y += w[k] * v.y;
            acc.z += w[k] * v.z;
            acc.w += w[k] * v.w;
          }
          o[j] = acc.x;
          o[j + 1] = acc.y;
          o[j + 2] = acc.z;
          o[j + 3] = acc.w;
        }
      } else {
        for (int j = 0; j < D; ++j) {
          float acc = 0.f;
#pragma unroll
          for (int k = 0; k < kK; ++k) {
            if (real[k]) acc += w[k] * __ldg(r[k] + j);
          }
          o[j] = acc;
        }
      }
      o[D] = agg_dist;
    }
    if (staged) {
      // a warp writes whole rows: D + 1 neighbouring floats a store
      __syncthreads();
      const int n = min(kThreads, C - c0);
      for (int rr = warp; rr < n; rr += kThreads / 32) {
        float* dst = out + ((size_t)(c0 + rr) * P + p) * row;
        for (int col = lane; col < row; col += 32) dst[col] = stage[rr * row + col];
      }
      __syncthreads();
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int knn_blend_launch(const float* query, const float* part_pts,
                                const float* part_pbw, const int* lengths,
                                float* out, int C, int P, int M, int D,
                                float two_r2, float far_dist, float eps,
                                void* stream) {
  const dim3 grid((C + kThreads * kQ - 1) / (kThreads * kQ), P);
  // 16-byte row loads when every row starts 16-byte aligned; the staged
  // stores when a slot's rows fit in the tiles' shared memory
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(part_pbw) % 16 == 0;
  const bool staged =
      (size_t)(D + 1) * kThreads * sizeof(float) <= sizeof(knn_select::Tiles);
  knn_blend_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      query, part_pts, part_pbw, lengths, out, C, P, M, D, two_r2, far_dist,
      eps, vec, staged);
  return static_cast<int>(cudaGetLastError());
}
