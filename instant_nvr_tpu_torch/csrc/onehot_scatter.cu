// Table-gradient scatter-add for small tables, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel instant_nvr_tpu/ops/pallas/onehot_scatter.py:
// _kernel.  Same contract as segmented_scatter.cu (acc[keys[r], f] +=
// payload[r, f] in float32, out = bf16(acc)), for tables of a few tens of
// thousands of rows that receive hundreds of thousands of records: the
// deformer's hash and dense tables (one call per feature column) and the
// arms' dense part tables.  Records are level-major: level l's R / n_levels
// records have keys inside the row window [lo[l], lo[l + 1]).
//
// Design.  The TPU version keeps the whole table in VMEM and folds chunks of
// records into it with one-hot matrix products.  Here one block takes one
// (level, chunk of that level's records) pair: it zeroes its level's window
// x F float32 accumulator in shared memory, adds its records into it with
// shared-memory atomics (a hot row costs a shared atomic, not an L2 round
// trip), then flushes the nonzero entries into the float32 workspace with
// global atomics; a last kernel rounds the workspace to bf16.  A record
// whose key falls outside its level's window (the contract forbids it) goes
// straight to the workspace, and one outside the table is dropped.  Windows
// above 48 KB use the opt-in dynamic shared memory (the deformer's hash
// level: 16,411 rows = 64 KB at F=1); the wrapper refuses windows beyond the
// card's opt-in limit.  The wrapper sizes a chunk to at least the window, so
// zeroing and flushing cost no more than the records themselves.
//
// What bounds it: shared-memory atomic throughput and the flush.  Per record
// 4 B key + 2F B payload are read once; per block the window is written
// twice in shared memory and flushed once.  Making it fast is later work:
// warp-aggregated updates of equal keys, a deterministic flush order, and
// more blocks per level when a level's window is small.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxLevels = 64;
constexpr int kDefaultSmem = 48 * 1024;

struct LevelWindows {
  int lo[kMaxLevels + 1];
};

// grid (chunks per level, n_levels); dynamic shared memory: window_rows << log2_f floats
__global__ void __launch_bounds__(kThreads)
onehot_scatter_kernel(const int* __restrict__ keys,
                      const __nv_bfloat16* __restrict__ payload,  // (R, F)
                      float* __restrict__ ws,                     // (n_rows, F)
                      LevelWindows win, int recs_per_level, int chunk,
                      int log2_f, int n_rows) {
  extern __shared__ float acc[];
  const int level = blockIdx.y;
  const int lo = win.lo[level];
  const int rows = win.lo[level + 1] - lo;
  const int n_acc = rows << log2_f;
  const int fmask = (1 << log2_f) - 1;
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  const long long r0 = (long long)level * recs_per_level + (long long)blockIdx.x * chunk;
  const long long r1 = (long long)level * recs_per_level +
                       min((long long)recs_per_level, (long long)(blockIdx.x + 1) * chunk);
  for (long long e = (r0 << log2_f) + threadIdx.x; e < (r1 << log2_f);
       e += blockDim.x) {
    const int k = __ldg(keys + (e >> log2_f));
    const int f = (int)(e & fmask);
    const float v = __bfloat162float(payload[e]);
    const int local = k - lo;
    if ((unsigned)local < (unsigned)rows) {
      atomicAdd(acc + ((local << log2_f) | f), v);
    } else if ((unsigned)k < (unsigned)n_rows) {
      atomicAdd(ws + (((long long)k << log2_f) | f), v);
    }
  }
  __syncthreads();

  float* dst = ws + ((long long)lo << log2_f);
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) {
    const float v = acc[i];
    if (v != 0.f) atomicAdd(dst + i, v);
  }
}

__global__ void __launch_bounds__(kThreads)
to_bf16_kernel(const float* __restrict__ ws, __nv_bfloat16* __restrict__ out,
               long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = __float2bfloat16_rn(ws[i]);
  }
}

}  // namespace

// ws must hold n_rows << log2_f zeros; level_offsets is a HOST array of
// n_levels + 1 row starts.  Launches the scatter and the cast on `stream`;
// returns a cudaError_t (0 = both launched).
extern "C" int onehot_scatter_launch(const int* keys, const void* payload,
                                     float* ws, void* out,
                                     const int* level_offsets, int n_levels,
                                     int R, int log2_f, int n_rows, int chunk,
                                     int window_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_levels < 1 || n_levels > kMaxLevels || chunk < 1 || R % n_levels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LevelWindows win;
  for (int l = 0; l <= n_levels; ++l) win.lo[l] = level_offsets[l];
  const int recs_per_level = R / n_levels;
  const size_t smem = (size_t)window_rows * (sizeof(float) << log2_f);
  if (smem > (size_t)kDefaultSmem) {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (smem > (size_t)optin) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = cudaFuncSetAttribute(
        onehot_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (recs_per_level > 0) {
    const dim3 grid((recs_per_level + chunk - 1) / chunk, n_levels);
    onehot_scatter_kernel<<<grid, kThreads, smem, s>>>(
        keys, static_cast<const __nv_bfloat16*>(payload), ws, win,
        recs_per_level, chunk, log2_f, n_rows);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long n_out = (long long)n_rows << log2_f;
  long long blocks = (n_out + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : (blocks > 132 * 16 ? 132 * 16 : blocks);
  to_bf16_kernel<<<(int)blocks, kThreads, 0, s>>>(
      ws, static_cast<__nv_bfloat16*>(out), n_out);
  return static_cast<int>(cudaGetLastError());
}
