// Table-gradient scatter-add for big hash tables, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of
// instant_nvr_tpu/ops/pallas/segmented_scatter.py: _scatter_kernel_f1 (F=1,
// the scalar part grids) and _scatter_kernel (F = 2..128).  Contract: from R
// records (keys (R,) int32, payload (R, F) bf16) it computes
//   acc[keys[r], f] += payload[r, f]        in float32
// and writes out = bf16(acc), (n_rows, F).  Keys outside [0, n_rows) are
// dropped, as XLA drops out-of-range scatter indices.
//
// Design.  The TPU version sorts the records per level and folds 128-record
// blocks into the table with one-hot matrix products, because a TPU scatter
// runs one row at a time.  Hopper has float32 atomics in L2, so the port is
// record-parallel: one thread per (record, feature) element, a grid-stride
// loop, one atomicAdd (a RED, its result unused) into a float32 workspace
// the wrapper zeroes, then a second kernel on the same stream rounds the
// workspace to bf16.  No sort, no level windows: the atomics need neither.
// The float32 sums are taken in whatever order the atomics land, so results
// differ from an ordered sum only in the last float32 bits, which can move
// the bf16 rounding by one ulp.
//
// What bounds it: memory.  Per record 4 B of key + 2F B of payload read and
// one atomic to a random row (32 B sector traffic in L2; the body's 42 MB
// float32 workspace does not stay in the 50 MB L2 beside everything else),
// plus 4F + 2F B per table row for the cast pass and 4F B for the wrapper's
// zero fill.  For the body's hash table (655,360 records, 10.5 M rows) the
// row passes dominate: ~105 MB of traffic.  Making it fast is later work:
// warp-aggregated atomics on runs of equal keys, a deterministic order, and
// fusing the cast into the optimizer's read of the gradient.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 32;   // grid-stride beyond this

__global__ void __launch_bounds__(kThreads)
scatter_add_kernel(const int* __restrict__ keys,
                   const __nv_bfloat16* __restrict__ payload,  // (R, F)
                   float* __restrict__ acc,                    // (n_rows, F)
                   long long n_elems, int log2_f, int n_rows) {
  const int fmask = (1 << log2_f) - 1;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_elems; i += stride) {
    const int k = __ldg(keys + (i >> log2_f));
    if ((unsigned)k < (unsigned)n_rows) {
      atomicAdd(acc + (((long long)k << log2_f) | (i & fmask)),
                __bfloat162float(payload[i]));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
to_bf16_kernel(const float* __restrict__ acc, __nv_bfloat16* __restrict__ out,
               long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = __float2bfloat16_rn(acc[i]);
  }
}

int blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return (int)(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

}  // namespace

// acc must hold n_rows << log2_f zeros.  Launches the scatter and the cast on
// `stream`; returns cudaGetLastError() (0 = both launched).
extern "C" int segmented_scatter_launch(const int* keys, const void* payload,
                                        float* acc, void* out, long long R,
                                        int log2_f, int n_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_elems = R << log2_f;
  const long long n_out = (long long)n_rows << log2_f;
  if (n_elems > 0) {
    scatter_add_kernel<<<blocks_for(n_elems), kThreads, 0, s>>>(
        keys, static_cast<const __nv_bfloat16*>(payload), acc, n_elems, log2_f,
        n_rows);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  to_bf16_kernel<<<blocks_for(n_out), kThreads, 0, s>>>(
      acc, static_cast<__nv_bfloat16*>(out), n_out);
  return static_cast<int>(cudaGetLastError());
}
