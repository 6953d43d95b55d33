// Table-gradient scatter-add for small tables, for Hopper (sm_90a): thread
// block clusters reduce one level's row window through distributed shared
// memory.
//
// Replaces the Pallas TPU kernel instant_nvr_tpu/ops/pallas/onehot_scatter.py:
// _kernel (pallas_call in onehot_scatter_add).  Same contract as
// segmented_scatter.cu (acc[keys[r], f] += payload[r, f] in float32,
// out = bf16(acc), keys outside [0, n_rows) dropped), for tables of a few
// tens of thousands of rows that receive hundreds of thousands of records:
// the deformer's hash and dense tables (one call per feature column) and the
// arms' dense part tables.  Records are level-major: level l's R / n_levels
// records have keys inside the row window [lo[l], lo[l + 1]).  A record whose
// key falls outside its level's window is dropped, as on the TPU, where its
// one-hot row matches no row of the window.
//
// Design.  The TPU version keeps the table in VMEM and folds chunks of
// records into it with one-hot matrix products.  Here each level gets one
// cluster of up to 8 blocks (the portable limit), or several clusters when
// it has many records; the wrapper's onehot_plan picks the shape.  Each
// block zeroes its level's window (rows x F float32) in shared memory, folds
// its chunk of records into it with shared-memory atomics, one per group of
// lanes with equal keys where a warp holds a run of them
// (scatter_common.cuh), and after cluster.sync() block rank r sums its
// 1/cluster_size share of the window's entries over every peer's shared
// memory (map_shared_rank), in rank order.
//   * One cluster per level (the arms' dense tables, the deformer's dense
//     table): that sum is final, and the block writes it to `out` as bf16.
//     The kernel also zeroes the rows of `out` that no window covers.  No
//     float32 workspace, no fill, no cast pass: one launch.
//   * Several clusters per level (the deformer's hash table): each adds its
//     nonzero sums into the persistent float32 workspace (REDs).  A ticket
//     counter per level behind the workspace counts the level's finished
//     clusters; in the last one each block exchanges its share of the
//     window's workspace entries for zeros and writes them to `out` as bf16,
//     and the ticket is reset, so the workspace is all zero again when the
//     kernel ends.
// Zero payloads are skipped (they add nothing).
//
// What bounds it: not bytes (4 B of key and 2F B of payload per record, 2F B
// per table row written once: 2.2 MB for the deformer's hash table) but the
// shared-memory atomics: a float32 atomicAdd to shared memory is a
// compare-and-swap loop on sm_90 (ATOMS.CAST.SPIN in the SASS), so an SM
// folds records slowly, and a run of equal keys serialises.  The design
// turns runs into one atomic, gives each block about 4k records (four loads
// in flight per thread) and, for a level with many records, spreads them
// over enough clusters to fill the card once; the price is the window's
// REDs and exchanges per cluster.  One launch, no pass over a float32 table.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "scatter_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 4;
constexpr int kMaxLevels = 64;
constexpr int kMaxCluster = 8;
constexpr int kMaxDevices = 64;
constexpr int kClusterRefused = -1;   // returned when no cluster of this shape fits an SM group

struct LevelWindows {
  int lo[kMaxLevels + 1];
};

// grid (cluster_size x clusters_per_level, n_levels), clusters along x;
// dynamic shared memory: the widest window x F floats.  `tickets` is null
// with one cluster per level.
__global__ void __launch_bounds__(kThreads)
onehot_cluster_kernel(const int* __restrict__ keys,
                      const __nv_bfloat16* __restrict__ payload,  // (R, F)
                      float* __restrict__ ws,                     // (n_rows, F), zero
                      __nv_bfloat16* __restrict__ out,            // (n_rows, F)
                      unsigned* __restrict__ tickets,             // (n_levels,), zero
                      LevelWindows win, int n_levels, int recs_per_level,
                      int chunk, int log2_f, int n_rows) {
  extern __shared__ float acc[];
  cg::cluster_group cluster = cg::this_cluster();
  const int level = blockIdx.y;
  const int lo = win.lo[level];
  const int rows = win.lo[level + 1] - lo;
  const int n_acc = rows << log2_f;
  const int lo_e = lo << log2_f;
  const int fmask = (1 << log2_f) - 1;

  // rows of out outside every window (none when the windows span the table)
  {
    const long long head = (long long)win.lo[0] << log2_f;
    const long long tail = (long long)win.lo[n_levels] << log2_f;
    const long long n_unc = head + (((long long)n_rows << log2_f) - tail);
    const long long stride = (long long)gridDim.x * gridDim.y * kThreads;
    for (long long i = ((long long)blockIdx.y * gridDim.x + blockIdx.x) * kThreads +
                       threadIdx.x;
         i < n_unc; i += stride) {
      out[i < head ? i : tail + (i - head)] = __float2bfloat16_rn(0.f);
    }
  }

  for (int i = threadIdx.x; i < n_acc; i += kThreads) acc[i] = 0.f;
  __syncthreads();

  // this block's records, four per thread in flight
  const long long first = (long long)level * recs_per_level;
  const long long e0 = (first + (long long)blockIdx.x * chunk) << log2_f;
  const long long e1 =
      (first + min((long long)recs_per_level, (long long)(blockIdx.x + 1) * chunk))
      << log2_f;
  for (long long base = e0; base < e1; base += kThreads * kUnroll) {
    int slot[kUnroll];
    float val[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long e = base + j * kThreads + threadIdx.x;
      int k = -1;
      float v = 0.f;
      if (e < e1) {
        k = __ldg(keys + (e >> log2_f));
        v = __bfloat162float(payload[e]);
      }
      const unsigned local = (unsigned)k - (unsigned)lo;
      slot[j] = (local < (unsigned)rows && v != 0.f)
                    ? (((int)local << log2_f) | (int)(e & fmask)) : -1;
      val[j] = v;
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (warp_aggregate::any_run(slot[j])) {
        const unsigned peers = __match_any_sync(warp_aggregate::kFull, slot[j]);
        const float s = warp_aggregate::group_sum(peers, val[j]);
        if (slot[j] >= 0 && warp_aggregate::group_leader(peers)) atomicAdd(acc + slot[j], s);
      } else if (slot[j] >= 0) {
        atomicAdd(acc + slot[j], val[j]);
      }
    }
  }

  // every peer's window is complete: reduce this rank's share over the cluster
  cluster.sync();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int share = (n_acc + cs - 1) / cs;
  const int i1 = min(n_acc, (rank + 1) * share);
  for (int i = rank * share + threadIdx.x; i < i1; i += kThreads) {
    float s = 0.f;
    for (int q = 0; q < cs; ++q) s += *cluster.map_shared_rank(acc + i, q);
    if (tickets == nullptr) {
      out[lo_e + i] = __float2bfloat16_rn(s);
    } else if (s != 0.f) {
      atomicAdd(ws + lo_e + i, s);
    }
  }
  if (tickets == nullptr) {
    cluster.sync();   // no block leaves while a peer still reads its window
    return;
  }

  // several clusters per level: the level's last cluster to finish rounds
  // the window, each block its share, and leaves the workspace and the
  // ticket at zero.  Rank 0 draws the cluster's ticket once every block's
  // REDs are fenced and posts in its window's first word (read by then)
  // whether the cluster came last.
  __threadfence();
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    const unsigned t = atomicAdd(tickets + level, 1u);
    reinterpret_cast<unsigned*>(acc)[0] = t == gridDim.x / cs - 1u;
  }
  cluster.sync();
  const unsigned last = *reinterpret_cast<unsigned*>(cluster.map_shared_rank(acc, 0));
  cluster.sync();   // rank 0's flag is read: blocks may leave
  if (!last) return;
  __threadfence();
  for (int i = rank * share + threadIdx.x; i < i1; i += kThreads * kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int e = i + j * kThreads;
      v[j] = e < i1 ? atomicExch(ws + lo_e + e, 0.f) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (i + j * kThreads < i1) out[lo_e + i + j * kThreads] = __float2bfloat16_rn(v[j]);
    }
  }
  if (rank == 0 && threadIdx.x == 0) atomicExch(tickets + level, 0u);
}

// per device: the dynamic shared memory the kernel was opted into, and per
// cluster size the most shared memory a cluster was found to fit with
int g_smem_set[kMaxDevices];
int g_smem_fits[kMaxDevices][kMaxCluster + 1];

}  // namespace

// One launch on `device`.  level_offsets is a HOST array of n_levels + 1 row
// starts; ws (n_rows << log2_f floats, then n_levels ticket words, all zero)
// is used only when clusters_per_level > 1, and left all zero.  Returns a
// cudaError_t (0 = launched), or -1 when no cluster of this shape and
// shared memory can be resident on the card.
extern "C" int onehot_scatter_launch(const int* keys, const void* payload,
                                     float* ws, void* out,
                                     const int* level_offsets, int n_levels,
                                     int R, int log2_f, int n_rows,
                                     int clusters_per_level, int cluster_size,
                                     int smem_bytes, int device, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || R < 0 || R % n_levels ||
      cluster_size < 1 || cluster_size > kMaxCluster || clusters_per_level < 1 ||
      smem_bytes < 0 || device < 0 || device >= kMaxDevices ||
      (clusters_per_level > 1 && ws == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceGuard guard(device);
  LevelWindows win;
  for (int l = 0; l <= n_levels; ++l) win.lo[l] = level_offsets[l];
  const int recs_per_level = R / n_levels;
  const int blocks = cluster_size * clusters_per_level;
  const int chunk = recs_per_level > 0 ? (recs_per_level + blocks - 1) / blocks : 1;
  unsigned* tickets = clusters_per_level > 1
      ? reinterpret_cast<unsigned*>(ws + ((long long)n_rows << log2_f)) : nullptr;

  if (smem_bytes > g_smem_set[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        onehot_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_smem_set[device] = smem_bytes;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster_size;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, n_levels, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const int checked = smem_bytes > 0 ? smem_bytes : 1;
  if (checked > g_smem_fits[device][cluster_size]) {
    int n_clusters = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(
        &n_clusters, onehot_cluster_kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_clusters < 1) return kClusterRefused;
    g_smem_fits[device][cluster_size] = checked;
  }
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, onehot_cluster_kernel, keys, static_cast<const __nv_bfloat16*>(payload),
      ws, static_cast<__nv_bfloat16*>(out), tickets, win, n_levels, recs_per_level,
      chunk, log2_f, n_rows));
}
