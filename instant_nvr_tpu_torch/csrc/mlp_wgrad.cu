// The weight and bias gradients of an MLP's linear layer, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves its MLPs' products to XLA
// (instant_nvr_tpu/models/nn.py), and the port multiplies the same
// bf16-rounded operands in float32 with torch.matmul / torch.bmm
// (instant_nvr_tpu_torch/models/nn.py).  Their weight gradient, x^T g, of
// a stacked layer went to a cuBLAS float32 batched GEMM whose few 32x32
// output tiles each walked the whole row axis (32,768 rows a part) alone,
// on a handful of the card's 132 SMs: half of a fit step's device time
// (PERF.md, section 5).  This kernel computes the same sums, the operands
// unrounded (g in float32, x as the forward gave it), in float32 fused
// multiply-adds:
//   dw[p] = sum_r x[p, r, :]^T g[p, r, :]   (din, dout)
//   db[p] = sum_r g[p, r, :]                 (dout)
// for x (parts, rows, din) and g (parts, rows, dout), row-major float32.
//
// Design.  The output is the (din + 1) x dout matrix of dw with db as its
// last row: x's column of ones.  Pass 1 (mlp_wgrad_kernel): the grid is
// (row slab, part, output tile).  The slab count comes from the shape:
// enough blocks for two waves of the card's resident blocks, unless a slab
// would then hold so few rows that its partial, written once, weighs more
// than a quarter of the operands it read.  A block streams its slab's
// rows of x and g through shared memory in stages of up to 4,096 floats,
// double-buffered with cp.async, each row padded to a multiple of 4 floats
// (x's row followed by its 1 and zeros, g's by zeros), 16-byte pieces
// where the source rows allow, 4-byte ones otherwise.  A thread owns a 4 x
// 4 tile of the output and accumulates it in registers from one float4 of
// the staged row of x and one of g a row: 16 FMAs for two shared loads.
// Where the output has fewer tiles than the block has threads, the block's
// threads form row groups that take every group-th row of a stage, and
// their sums are added in group order at the end.  The block writes its
// partial to a scratch buffer.  Pass 2 (mlp_wgrad_sum_kernel): a block
// takes 32 outputs of a part; each of its 8 warps sums one contiguous
// eighth of the slabs in slab order, and the 8 sums are added in warp
// order.  No atomics: every output's sum has one fixed order for a given
// shape on a given card, so a captured step replays its eager run bit for
// bit.
//
// What bounds it: at a fit step's shapes (din, dout <= 70) the operands,
// read once from device memory at 3.35 TB/s, slightly above the float32
// FMAs on the CUDA cores at 67 TFLOP/s.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxGroups = 4;       // row groups a block
constexpr int kStageFloats = 4096;  // floats of staged x and g rows a stage
constexpr int kSumWarps = 8;        // pass 2: slab groups a block
constexpr int kMaxDevices = 64;

struct Args {
  const float* x;
  const float* g;
  float* partial;      // (parts, slabs, din + 1, dout)
  int parts, rows, din, dout;
  int slabs, slab_rows, stage_rows;
  int xs, gs;          // staged row strides: din + 1 and dout rounded up to 4
  int iq, jq;          // the block's output tile, in 4 x 4 tiles: along i, along j
  int tiles_i;         // output tiles along i (blockIdx.z % tiles_i)
  int groups;          // row groups: blockDim.x = groups x iq x jq
  int x_vec, g_vec;    // rows copied 16 bytes at a time
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// rows [0, n) of w floats (contiguous in src) to dst with row stride ds,
// in pieces of P floats (4: w % 4 == 0 and src 16-byte aligned)
template <int P>
__device__ __forceinline__ void stage_rows(float* dst, int ds, const float* src, int w, int n) {
  const int q = w / P, T = blockDim.x;
  const int dr = T / q, dc = T - dr * q;
  int r = threadIdx.x / q, c = threadIdx.x - r * q;
  for (int e = threadIdx.x; e < n * q; e += T) {
    if constexpr (P == 4)
      cp_async16(dst + r * ds + 4 * c, src + r * w + 4 * c);
    else
      cp_async4(dst + r * ds + c, src + r * w + c);
    c += dc;
    r += dr;
    if (c >= q) {
      c -= q;
      ++r;
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads) mlp_wgrad_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int stage = a.stage_rows * (a.xs + a.gs);
  const int slab = blockIdx.x, part = blockIdx.y;
  const int tile_i = blockIdx.z % a.tiles_i, tile_j = blockIdx.z / a.tiles_i;
  const int tile = a.iq * a.jq;
  const int rg = threadIdx.x / tile, q = threadIdx.x - rg * tile;
  const int i0 = 4 * (tile_i * a.iq + q / a.jq), j0 = 4 * (tile_j * a.jq + q % a.jq);
  const bool inside = i0 < a.xs && j0 < a.gs;  // in the staged rows
  const int cols = a.din + 1;

  // each stage buffer's padding: x's column of ones and zeros, g's zeros
  for (int b = 0; b < 2; ++b) {
    float* xb = smem + b * stage;
    float* gb = xb + a.stage_rows * a.xs;
    for (int e = threadIdx.x; e < a.stage_rows * (a.xs - a.din); e += blockDim.x) {
      const int r = e / (a.xs - a.din), c = a.din + e % (a.xs - a.din);
      xb[r * a.xs + c] = c == a.din ? 1.f : 0.f;
    }
    for (int e = threadIdx.x; e < a.stage_rows * (a.gs - a.dout); e += blockDim.x) {
      const int r = e / (a.gs - a.dout), c = a.dout + e % (a.gs - a.dout);
      gb[r * a.gs + c] = 0.f;
    }
  }

  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;

  const long long r0 = static_cast<long long>(slab) * a.slab_rows;
  const int n = static_cast<int>(min(static_cast<long long>(a.slab_rows), a.rows - r0));
  const float* xp = a.x + (static_cast<long long>(part) * a.rows + r0) * a.din;
  const float* gp = a.g + (static_cast<long long>(part) * a.rows + r0) * a.dout;
  const int R = a.stage_rows;
  const int chunks = (n + R - 1) / R;
  auto load = [&](int c) {
    float* xb = smem + (c & 1) * stage;
    float* gb = xb + R * a.xs;
    const int cr = min(R, n - c * R);
    const float* xc = xp + static_cast<long long>(c) * R * a.din;
    const float* gc = gp + static_cast<long long>(c) * R * a.dout;
    if (a.x_vec)
      stage_rows<4>(xb, a.xs, xc, a.din, cr);
    else
      stage_rows<1>(xb, a.xs, xc, a.din, cr);
    if (a.g_vec)
      stage_rows<4>(gb, a.gs, gc, a.dout, cr);
    else
      stage_rows<1>(gb, a.gs, gc, a.dout, cr);
  };
  load(0);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) load(c + 1);
    cp_async_commit();  // an empty group on the last stage keeps the wait uniform
    cp_async_wait_one();
    __syncthreads();
    if (inside) {
      const float* xb = smem + (c & 1) * stage + i0;
      const float* gb = smem + (c & 1) * stage + R * a.xs + j0;
      const int cr = min(R, n - c * R);
#pragma unroll 4
      for (int r = rg; r < cr; r += a.groups) {
        const float4 xv = *reinterpret_cast<const float4*>(xb + r * a.xs);
        const float4 gv = *reinterpret_cast<const float4*>(gb + r * a.gs);
        const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
        const float ga[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = __fmaf_rn(xa[u], ga[v], acc[u][v]);
      }
    }
    __syncthreads();  // the next stage's copy overwrites this buffer
  }

  // the row groups' sums, added in group order by group 0
  if (a.groups > 1) {
    float* red = smem;  // (16, groups, tile)
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) red[((4 * u + v) * a.groups + rg) * tile + q] = acc[u][v];
    __syncthreads();
    if (rg != 0) return;
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        float s = red[(4 * u + v) * a.groups * tile + q];
        for (int k = 1; k < a.groups; ++k) s += red[((4 * u + v) * a.groups + k) * tile + q];
        acc[u][v] = s;
      }
  }
  float* out = a.partial + (static_cast<long long>(part) * a.slabs + slab) * cols * a.dout;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v)
      if (i0 + u < cols && j0 + v < a.dout)
        out[static_cast<long long>(i0 + u) * a.dout + j0 + v] = acc[u][v];
}

// blockIdx.y = part; 32 outputs (lanes) x kSumWarps slab groups (warps)
__global__ void __launch_bounds__(32 * kSumWarps)
    mlp_wgrad_sum_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                         float* __restrict__ db, int slabs, int din, int dout) {
  __shared__ float sums[kSumWarps][32];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int per_part = (din + 1) * dout;
  const int e = blockIdx.x * 32 + lane;
  const int s0 = static_cast<int>(static_cast<long long>(slabs) * w / kSumWarps);
  const int s1 = static_cast<int>(static_cast<long long>(slabs) * (w + 1) / kSumWarps);
  float s = 0.f;
  if (e < per_part) {
    const float* p = partial + static_cast<long long>(blockIdx.y) * slabs * per_part + e;
#pragma unroll 8
    for (int t = s0; t < s1; ++t) s += p[static_cast<long long>(t) * per_part];
  }
  sums[w][lane] = s;
  __syncthreads();
  if (w != 0 || e >= per_part) return;
  float t = sums[0][lane];
#pragma unroll
  for (int k = 1; k < kSumWarps; ++k) t += sums[k][lane];
  if (e < din * dout)
    dw[static_cast<long long>(blockIdx.y) * din * dout + e] = t;
  else
    db[static_cast<long long>(blockIdx.y) * dout + (e - din * dout)] = t;
}

struct Plan {
  Args a;
  int tiles, threads;
  size_t smem;
};

int ceil_div(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

int min_int(int a, int b) { return a < b ? a : b; }

int max_int(int a, int b) { return a > b ? a : b; }

// the device's SM count and the kernel's resident blocks an SM by warps a
// block, read once
int g_sms[kMaxDevices];
int g_per_sm[kMaxDevices][kMaxThreads / 32 + 1];

// The launch's shape from the call's: false for sizes the kernel does not take.
bool make_plan(int parts, int rows, int din, int dout, Plan& p) {
  if (parts < 1 || parts > 65535 || rows < 1 || din < 1 || dout < 1 || din + dout > 1024)
    return false;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return false;
  Args& a = p.a;
  a.parts = parts;
  a.rows = rows;
  a.din = din;
  a.dout = dout;
  const int cols = din + 1;
  a.xs = (cols + 3) & ~3;
  a.gs = (dout + 3) & ~3;
  // the output tile: up to 16 tiles of 4 along j and kMaxThreads in all
  a.jq = min_int(a.gs / 4, 16);
  a.iq = min_int(a.xs / 4, kMaxThreads / a.jq);
  a.tiles_i = ceil_div(a.xs / 4, a.iq);
  p.tiles = a.tiles_i * ceil_div(a.gs / 4, a.jq);
  if (p.tiles > 65535) return false;
  const int tile = a.iq * a.jq;
  a.groups = max_int(1, min_int(kMaxGroups, kMaxThreads / tile));
  p.threads = a.groups * tile;
  a.stage_rows = kStageFloats / (a.xs + a.gs);
  // two stages, or the row groups' 16 sums a thread: at most 2 kStageFloats
  p.smem = sizeof(float) * 2 * kStageFloats;
  if (g_sms[dev] == 0) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return false;
    g_sms[dev] = sms;
  }
  int& per_sm = g_per_sm[dev][(p.threads + 31) / 32];
  if (per_sm == 0) {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, mlp_wgrad_kernel, p.threads,
                                                      p.smem) != cudaSuccess)
      return false;
    per_sm = n > 0 ? n : 1;
  }
  // two waves of resident blocks, each slab at least a stage and at least
  // four times its partial's floats in operand floats
  const long long target = 2LL * g_sms[dev] * per_sm;
  const int want = ceil_div(target, static_cast<long long>(parts) * p.tiles);
  const int min_rows = max_int(a.stage_rows, ceil_div(4LL * cols * dout, din + dout));
  const int slabs = max_int(1, min_int(want, ceil_div(rows, min_rows)));
  a.slab_rows = ceil_div(rows, slabs);
  a.slabs = ceil_div(rows, a.slab_rows);
  return true;
}

}  // namespace

// The number of row slabs a launch of this shape makes (the scratch buffer
// holds parts x slabs x (din + 1) x dout floats), on the current device;
// -1 for sizes the kernel does not take.
extern "C" int mlp_wgrad_slabs(int parts, int rows, int din, int dout) {
  Plan p;
  return make_plan(parts, rows, din, dout, p) ? p.a.slabs : -1;
}

// On `stream`, for x (parts, rows, din) and g (parts, rows, dout) float32,
// contiguous: dw (parts, din, dout) and db (parts, dout) through `partial`,
// the scratch buffer of mlp_wgrad_slabs's size.  Returns cudaGetLastError()
// (0 = launched), or cudaErrorInvalidValue for sizes the kernel does not
// take or a slab count that is not this shape's (nothing runs).
extern "C" int mlp_wgrad_launch(const float* x, const float* g, float* partial, float* dw,
                                float* db, int parts, int rows, int din, int dout, int slabs,
                                void* stream) {
  Plan p;
  if (!make_plan(parts, rows, din, dout, p) || p.a.slabs != slabs)
    return static_cast<int>(cudaErrorInvalidValue);
  p.a.x = x;
  p.a.g = g;
  p.a.partial = partial;
  p.a.x_vec = din % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  p.a.g_vec = dout % 4 == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  mlp_wgrad_kernel<<<dim3(p.a.slabs, parts, p.tiles), p.threads, p.smem, s>>>(p.a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_part = (din + 1) * dout;
  mlp_wgrad_sum_kernel<<<dim3(ceil_div(per_part, 32), parts), 32 * kSumWarps, 0, s>>>(
      partial, dw, db, p.a.slabs, din, dout);
  return static_cast<int>(cudaGetLastError());
}
