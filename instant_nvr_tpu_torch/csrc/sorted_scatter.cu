// Deterministic table-gradient scatter-add for Hopper (sm_90a): records
// sorted by key, each key's run summed by one warp in a fixed order.
//
// Replaces, under fix_random, the Pallas TPU kernels of
// instant_nvr_tpu/ops/pallas/segmented_scatter.py (_scatter_kernel_f1,
// _scatter_kernel; pallas_call in segmented_scatter_add) and of
// onehot_scatter.py (_kernel) for every table.  The TPU kernel is
// deterministic by construction: it sorts each level's records by key
// (segmented_scatter.py:322-343) and folds each segment in float32.  The
// port's other two kernels add with float32 atomics, whose order changes
// from run to run.  This one keeps the TPU kernel's contract and its
// determinism: from R records sorted by key (keys (R,) int32 ascending, a
// stable torch.sort in the wrapper; payload (R, F) bf16, gathered in that
// order) it computes
//   out[k, f] = sum of payload[r, f] over the run of records with key k
// in float32, rounded once to bf16, and writes every row: +0 where no
// record has the key.  Keys outside [0, n_rows) are dropped.
//
// Design: no atomics, no workspace.  One host call enqueues two kernels:
//   1. zero_kernel writes +0 to every output element;
//   2. segment_kernel: each warp takes a window of 32 records; a record
//      whose key differs from the one before it starts a run, and the
//      warp of the window that holds a run's first record sums the whole
//      run (it may reach past the window), so each run has one owner.
//      F <= 32: lane l adds the run's (records x F) elements l, l + 32,
//      ... (all of feature l % F), then a fixed xor-shuffle tree folds the
//      lanes of each feature; F > 32: lane l adds feature f0 + l record by
//      record, in record order.  Every float32 add happens in an order
//      fixed by the keys alone, so two runs give the same bits.  Against an
//      add in record order (the plain version) the F <= 32 tree may round
//      differently, by at most one bf16 ulp of the row after rounding.
//
// What bounds it: memory.  The output (2F B a row) is written twice
// (zeros, then the touched rows), the sorted keys are read about twice and
// the payload once.  The sort and gather outside the kernel move the keys
// and payload several more times; a warp per 32 records idles on short
// runs.  Speed is later work: PERF.md gives its time beside its bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "scatter_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kMaxBlocks = 132 * 16;   // grid-stride beyond this

using bf16 = __nv_bfloat16;

__global__ void __launch_bounds__(kThreads) zero_kernel(bf16* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    out[i] = __float2bfloat16_rn(0.f);
  }
}

__global__ void __launch_bounds__(kThreads)
segment_kernel(const int* __restrict__ keys,        // (R,) ascending
               const bf16* __restrict__ payload,    // (R, F) in key order
               bf16* __restrict__ out,              // (n_rows, F), zeroed
               long long R, int log2_f, int n_rows) {
  const int lane = threadIdx.x & 31;
  const int F = 1 << log2_f;
  const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * kThreads) >> 5;
  for (long long base = warp * 32; base < R; base += n_warps * 32) {
    const long long r = base + lane;
    int key = -1;
    bool start = false;
    if (r < R) {
      key = keys[r];
      start = (unsigned)key < (unsigned)n_rows && (r == 0 || keys[r - 1] != key);
    }
    unsigned starts = __ballot_sync(kFull, start);
    while (starts) {                                  // uniform over the warp
      const int src = __ffs(starts) - 1;
      starts &= starts - 1;
      const int k = __shfl_sync(kFull, key, src);
      const long long r0 = base + src;
      // the run's end: the keys are sorted, so the records of k from r0 on
      // fill a prefix of every 32-record window they reach
      long long end = r0;
      for (;;) {
        const long long rr = end + lane;
        const unsigned in = __ballot_sync(kFull, rr < R && keys[rr] == k);
        end += __popc(in);
        if (in != kFull) break;
      }
      bf16* row = out + ((long long)k << log2_f);
      if (F <= 32) {
        const bf16* p = payload + (r0 << log2_f);
        const long long n = (end - r0) << log2_f;
        float s = 0.f;
        for (long long e = lane; e < n; e += 32) s += __bfloat162float(p[e]);
        for (int o = 16; o >= F; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
        if (lane < F) row[lane] = __float2bfloat16_rn(s);
      } else {
        for (int f0 = 0; f0 < F; f0 += 32) {
          float s = 0.f;
          for (long long rr = r0; rr < end; ++rr) {
            s += __bfloat162float(payload[(rr << log2_f) + f0 + lane]);
          }
          row[f0 + lane] = __float2bfloat16_rn(s);
        }
      }
    }
  }
}

int blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return (int)(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

}  // namespace

// keys ascending (R,) int32; payload (R, F = 1 << log2_f) bf16 in key
// order; out (n_rows, F) bf16.  Enqueues both kernels on `stream` of
// `device`; returns a cudaError_t (0 = launched).
extern "C" int sorted_scatter_launch(const int* keys, const void* payload, void* out,
                                     long long R, int log2_f, int n_rows, int device,
                                     void* stream) {
  if (R < 0 || n_rows < 1 || log2_f < 0 || log2_f > 7) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceGuard guard(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* o = static_cast<bf16*>(out);
  const long long n_out = (long long)n_rows << log2_f;
  zero_kernel<<<blocks_for(n_out), kThreads, 0, s>>>(o, n_out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || R == 0) return static_cast<int>(err);
  segment_kernel<<<blocks_for(R), kThreads, 0, s>>>(keys, static_cast<const bf16*>(payload),
                                                    o, R, log2_f, n_rows);
  return static_cast<int>(cudaGetLastError());
}
