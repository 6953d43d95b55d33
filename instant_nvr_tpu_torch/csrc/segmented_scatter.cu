// Table-gradient scatter-add for big hash tables, for Hopper (sm_90a): REDs
// into a self-cleaning float32 workspace, then an exchange pass.
//
// Replaces the Pallas TPU kernels of
// instant_nvr_tpu/ops/pallas/segmented_scatter.py: _scatter_kernel_f1 (F=1,
// the scalar part grids) and _scatter_kernel (F = 2..128), pallas_call in
// segmented_scatter_add.  Contract: from R records (keys (R,) int32, payload
// (R, F) bf16) it computes
//   acc[keys[r], f] += payload[r, f]        in float32
// and writes out = bf16(acc), (n_rows, F).  Keys outside [0, n_rows) are
// dropped, as XLA drops out-of-range scatter indices.
//
// Design.  The TPU version sorts the records per level and folds 128-record
// blocks into the table with one-hot matrix products, because a TPU scatter
// runs one row at a time.  Hopper has float32 atomics in L2, so the port is
// record-parallel, with no sort and no level windows.  One host call
// enqueues two kernels:
//   1. red_kernel zeroes `out` (16-byte stores) and adds every record into
//      a persistent float32 workspace that is all zero between calls, one
//      RED per group of lanes with equal keys (scatter_common.cuh);
//   2. exchange_kernel, one thread per (record, f): the group's leader
//      swaps its workspace entry for 0 (atomicExch) and writes bf16 of what
//      it got to `out` when that is not 0.  Exactly one thread sees each
//      touched entry's sum; a sum of exactly 0 leaves the zero of pass 1,
//      as the plain version gives; a NaN sum is stored; and the workspace is
//      all zero again when the call ends.
// Zero payloads are skipped in both passes: they add nothing, and a record
// that added nothing need not collect.  The float32 sums are taken in
// whatever order the atomics land, so results differ from an ordered sum
// only in the last float32 bits, which can move the bf16 rounding by one ulp.
//
// What bounds it: memory.  The bf16 output (2F B per table row, 21 MB for
// the body's hash table of 10.5 M rows) is the only dense traffic, with no
// float32 fill or cast pass over the table; per record 4 B of key and 2F B
// of payload are read twice, and two atomics and a 2-byte store hit random
// sectors.  Where keys repeat, as in a train step's records, the warp
// aggregation removes most of that random traffic.  Where every key is
// distinct it all remains, and the exchange pass (an atomic that returns
// its value, then a scattered store) takes more time than the REDs:
// PERF.md gives the measured split.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "scatter_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr long long kMaxBlocks = 132 * 8;   // grid-stride beyond this

// The workspace entry of element e (record e >> log2_f, feature e & fmask),
// or -1 for an element past the end, a key outside the table or a zero
// payload.
__device__ __forceinline__ int element_slot(const int* __restrict__ keys,
                                            const __nv_bfloat16* __restrict__ payload,
                                            long long e, long long n_elems,
                                            int log2_f, int n_rows, float* v) {
  *v = 0.f;
  if (e >= n_elems) return -1;
  const int k = __ldg(keys + (e >> log2_f));
  *v = __bfloat162float(payload[e]);
  if ((unsigned)k >= (unsigned)n_rows || *v == 0.f) return -1;
  return (k << log2_f) | (int)(e & ((1 << log2_f) - 1));
}

__global__ void __launch_bounds__(kThreads)
red_kernel(const int* __restrict__ keys,
           const __nv_bfloat16* __restrict__ payload,   // (R, F)
           float* __restrict__ ws,                      // (n_rows, F), zero
           __nv_bfloat16* __restrict__ out,             // (n_rows, F), 16-B aligned
           long long n_elems, long long n_out, int log2_f, int n_rows) {
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * kThreads;
  uint4* out16 = reinterpret_cast<uint4*>(out);
  const long long n16 = n_out >> 3;
  // streaming stores: the zeros need not stay in L2, where the workspace
  // lines the atomics touch are wanted
  for (long long i = tid; i < n16; i += nthreads) __stcs(out16 + i, make_uint4(0, 0, 0, 0));
  for (long long i = (n16 << 3) + tid; i < n_out; i += nthreads) {
    out[i] = __float2bfloat16_rn(0.f);
  }

  for (long long base = (long long)blockIdx.x * kThreads * kUnroll; base < n_elems;
       base += nthreads * kUnroll) {
    int slot[kUnroll];
    float val[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      slot[j] = element_slot(keys, payload, base + j * kThreads + threadIdx.x,
                             n_elems, log2_f, n_rows, &val[j]);
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const unsigned peers = __match_any_sync(warp_aggregate::kFull, slot[j]);
      const float s = warp_aggregate::group_sum(peers, val[j]);
      if (slot[j] >= 0 && s != 0.f && warp_aggregate::group_leader(peers)) {
        atomicAdd(ws + slot[j], s);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
exchange_kernel(const int* __restrict__ keys,
                const __nv_bfloat16* __restrict__ payload,
                float* __restrict__ ws, __nv_bfloat16* __restrict__ out,
                long long n_elems, int log2_f, int n_rows) {
  const long long nthreads = (long long)gridDim.x * kThreads;
  for (long long base = (long long)blockIdx.x * kThreads * kUnroll; base < n_elems;
       base += nthreads * kUnroll) {
    int slot[kUnroll];
    float val[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      slot[j] = element_slot(keys, payload, base + j * kThreads + threadIdx.x,
                             n_elems, log2_f, n_rows, &val[j]);
    }
    // the leaders' exchanges first, all in flight together, then the stores
    bool lead[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const unsigned peers = __match_any_sync(warp_aggregate::kFull, slot[j]);
      lead[j] = slot[j] >= 0 && warp_aggregate::group_leader(peers);
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) val[j] = lead[j] ? atomicExch(ws + slot[j], 0.f) : 0.f;
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (val[j] != 0.f) out[slot[j]] = __float2bfloat16_rn(val[j]);
    }
  }
}

int blocks_for(long long n) {
  const long long b = (n + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  return (int)(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

}  // namespace

// ws must hold n_rows << log2_f zeros, and holds them again when the call's
// work ends; out must be 16-byte aligned.  Enqueues both passes on `stream`
// of `device`; returns a cudaError_t (0 = both launched).
extern "C" int segmented_scatter_launch(const int* keys, const void* payload,
                                        float* ws, void* out, long long R,
                                        int log2_f, int n_rows, int device,
                                        void* stream) {
  if (R < 0 || n_rows < 1 || (reinterpret_cast<std::uintptr_t>(out) & 15u)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceGuard guard(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_elems = R << log2_f;
  const long long n_out = (long long)n_rows << log2_f;
  const auto* pay = static_cast<const __nv_bfloat16*>(payload);
  auto* o = static_cast<__nv_bfloat16*>(out);
  red_kernel<<<blocks_for(n_elems > n_out / 8 ? n_elems : n_out / 8), kThreads, 0, s>>>(
      keys, pay, ws, o, n_elems, n_out, log2_f, n_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_elems == 0) return static_cast<int>(err);
  exchange_kernel<<<blocks_for(n_elems), kThreads, 0, s>>>(keys, pay, ws, o, n_elems,
                                                           log2_f, n_rows);
  return static_cast<int>(cudaGetLastError());
}
