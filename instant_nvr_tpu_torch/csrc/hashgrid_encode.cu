// Fused multiresolution hash-grid encoding, forward and backward, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package's encoding forward
// (instant_nvr_tpu/ops/hashgrid.py:hashgrid_encode, multi_hashgrid_encode)
// is a chain of XLA ops that its jit fuses.  The port's plain chain
// (instant_nvr_tpu_torch/ops/hashgrid.py) runs that chain op by op and
// writes every (level, corner, point) index, weight and value to device
// memory, tens of KB a point, against 76 B a point of output; in the render
// those chains took 68-71% of the device time (PERF.md, section 5).  The
// forward kernel computes the same numbers in one pass, on every CUDA
// encoder call (with a gradient asked, its autograd Function's forward): the
// normalisation to the box, the corners (dense x n^2 + y n + z rows, or the
// uint32 prime-xor hash mod the table size), the trilinear weights, the
// table gather, the lerp and the feature and level sums, and writes the
// callers' (M, out_dim) rows, the normalised points first when the spec
// includes them.
//
// The same numbers as the plain chain on the card, not only close ones:
// every product and sum is one IEEE float32 operation in the plain chain's
// order (the file is built with --fmad=false, so nothing is contracted):
//   x01 = (p - b0) / (b1 - b0); fd = x01 * (res - 1); the corner truncated
//   toward zero, clipped to [0, res - 1]; the offset from the clipped
//   corner; weights (w_x * w_y) * w_z, corner bits z fastest;
//   a sum over the 8 corners, or over features or levels, in the order
//   torch.sum's CUDA reduction takes over the plain chain's tensors: over a
//   dimension that is not the innermost of a contiguous tensor (every sum
//   of hashgrid_encode_plain), four partial sums of every fourth term, then
//   ((a0 + a1) + a2) + a3; over the corners of multi_hashgrid_encode_plain,
//   whose (level, corner, point) tensors are laid out point-major (its
//   level sizes are a transposed (L, M) array), and over the innermost
//   dimension (its feature sum when the tables are not scalar): halves,
//   each term of the first plus its partner in the second, until one is
//   left.
// Table values are read in the table's dtype (bf16 or float32) and widened
// to float32; nothing is computed in bf16.
//
// Design.  A block holds 32 points (one a lane) and all their levels: warp w
// takes levels w, w + 8, ...  A lane computes its level's 8 corner rows and
// weights, gathers the rows through the read-only cache and reduces them in
// registers; the level's values go to shared memory, and the block then
// writes its 32 output rows, which lie next to each other in memory, with
// neighbouring threads on neighbouring floats.  Several part grids run in one
// launch: their points are part-major, and a by-value parameter block
// (__grid_constant__) holds each part's segment start, tables, bounds row
// and level constants; a lane finds its part by the segment starts.
//
// What bounds it: the gathers, 8 a (point, level), each a 32-byte sector
// of L2 or device memory for a 2- to 64-byte row; the bf16 part tables of
// inb_377 (17.87 M rows, 36 MB) fit the 50 MB L2.  The bound chip_smoke.py
// states counts the points, the distinct table rows the call gathers and
// the output, each once, over device memory's bandwidth.
//
// Backward (hashgrid_backward_kernel, one launch an encoder call that asks
// for a gradient).  It recomputes each (point, level)'s corners and weights
// from the points, as the forward does, and writes:
//   - the table-gradient records the scatter kernels of ops/scatter.py sum:
//     each corner's row (int32) and payload, level-major (level, corner,
//     point) within each part's dense and hashed table, the payload being
//     the cotangent of the level's value(s) times the corner's weight with
//     the plain chain's autograd products in its order ((g F) w for
//     hashgrid_encode_plain's scalar grids, (g w) F for
//     multi_hashgrid_encode_plain's), rounded once to bf16 (or kept float32
//     where the table's gradient is exact); a table the encoders read by
//     feature column gets its payload feature-major, one column a scatter;
//   - where asked, d loss / d points in float32 in one fixed order: each
//     corner's sum over features of cotangent x value, times the
//     derivative of its weight, summed over the corners in order, times
//     (res - 1); the levels summed in order, the normalised points'
//     own cotangent last, divided by the box's extent.
// The same block shape as the forward: a lane a point, a warp a level; the
// cotangent rows are staged in shared memory with one coalesced read, and
// the levels' point gradients are summed in shared memory.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxParts = 8;
constexpr int kMaxLevels = 32;
constexpr int kMaxStaged = 256;  // values a point stages: levels x (1 or F)
constexpr int kPoints = 32;      // points a block: one a lane
constexpr int kWarps = 8;
constexpr int kThreads = kPoints * kWarps;

// what a level's lanes compute, and what the block writes
enum Mode : int {
  kScalar = 0,      // F * the corners' lerp of one value a row
  kLevelSum = 1,    // the features' sum, a column a level (multi_order: each
                    // row's sum, then the lerp; else each feature's lerp first)
  kFeatureSum = 2,  // each feature's lerp, summed over the levels (F columns)
  kConcat = 3,      // each feature's lerp (L x F columns)
};

struct Part {
  const void* dense;     // (dense rows[, F]) in the table dtype
  const void* hash;      // (hashed levels x table_size[, F])
  const float* bounds;   // (2, 3): the box's low and high corners
  unsigned table_size;
  int start_hash;        // the first hashed level
  int entries[kMaxLevels];       // cells a side, each level
  int dense_offset[kMaxLevels];  // each dense level's first row
};

struct Params {
  Part part[kMaxParts];
  int seg_start[kMaxParts + 1];  // part p's points: [seg_start[p], seg_start[p + 1])
  int n_parts, n_points, n_levels, n_features, mode, include_input, out_dim;
  int multi_order;               // sum in multi_hashgrid_encode_plain's order
  int stride;                    // floats a point's staged values take
  unsigned prime[3];
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t v) {  // bf16 bits
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// Row `row` of a table with V values a row, widened to float32.  The
// launch function checks that the table starts 16-byte aligned.
template <typename T, int V>
__device__ __forceinline__ void load_row(const T* __restrict__ table, uint32_t row,
                                         float (&v)[V]) {
  constexpr int kBytes = V * static_cast<int>(sizeof(T));
  const T* p = table + static_cast<size_t>(row) * V;
  if constexpr (kBytes >= 16) {
    uint4 raw[kBytes / 16];
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) raw[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
    const T* e = reinterpret_cast<const T*>(raw);
#pragma unroll
    for (int f = 0; f < V; ++f) v[f] = widen(e[f]);
  } else if constexpr (kBytes == 8) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int f = 0; f < V; ++f) v[f] = widen(e[f]);
  } else if constexpr (kBytes == 4) {
    const unsigned raw = __ldg(reinterpret_cast<const unsigned*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int f = 0; f < V; ++f) v[f] = widen(e[f]);
  } else {
    v[0] = widen(__ldg(p));
  }
}

// torch.sum's order over a dimension that is not the innermost: term j
// goes to partial sum j % 4, each starting from 0; then ((a0 + a1) + a2) + a3.
template <int N>
__device__ __forceinline__ float sum_mod4(const float (&x)[N]) {
  float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < N; ++j) a[j & 3] = __fadd_rn(a[j & 3], x[j]);
  return __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), a[2]), a[3]);
}

// torch.sum's order over the innermost dimension of N (a power of two)
// values: each term of the first half plus its partner in the second, then
// the same over the first half, ... (a warp's shuffle-down tree, one value a
// lane).
template <int N>
__device__ __forceinline__ float sum_halves(float (&x)[N]) {
#pragma unroll
  for (int s = N / 2; s > 0; s >>= 1) {
#pragma unroll
    for (int j = 0; j < s; ++j) x[j] = __fadd_rn(x[j], x[j + s]);
  }
  return x[0];
}

// One (point, level): the level's value(s) into dst (1, or V for kFeatureSum
// and kConcat).
template <typename T, int V>
__device__ __forceinline__ void encode_level(const Params& P, const Part& part, int l,
                                             const float (&x)[3], float* dst) {
  const int n = part.entries[l];
  const float scale = __fsub_rn(static_cast<float>(n), 1.0f);
  int lo[3], hi[3];
  float w0[3], w1[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float fd = __fmul_rn(x[d], scale);
    const long long b = __float2int_rz(fd);  // as .to(int32): toward zero
    lo[d] = static_cast<int>(min(max(b, 0LL), static_cast<long long>(n - 1)));
    hi[d] = static_cast<int>(min(max(b + 1, 0LL), static_cast<long long>(n - 1)));
    const float off = __fsub_rn(fd, static_cast<float>(lo[d]));
    w0[d] = __fsub_rn(1.0f, off);
    w1[d] = off;
  }
  const bool dense = l < part.start_hash;
  const T* __restrict__ table = static_cast<const T*>(dense ? part.dense : part.hash);
  const uint32_t base = dense ? static_cast<uint32_t>(part.dense_offset[l])
                              : static_cast<uint32_t>(l - part.start_hash) * part.table_size;

  // corner c's row and weight; corner bits (x, y, z) = (c & 4, c & 2, c & 1)
  auto corner = [&](int c, float& w) -> uint32_t {
    const int ix = (c & 4) ? hi[0] : lo[0];
    const int iy = (c & 2) ? hi[1] : lo[1];
    const int iz = (c & 1) ? hi[2] : lo[2];
    w = __fmul_rn(__fmul_rn((c & 4) ? w1[0] : w0[0], (c & 2) ? w1[1] : w0[1]),
                  (c & 1) ? w1[2] : w0[2]);
    if (dense) return base + static_cast<uint32_t>((ix * n + iy) * n + iz);
    const uint32_t h = (static_cast<uint32_t>(ix) * P.prime[0]) ^
                       (static_cast<uint32_t>(iy) * P.prime[1]) ^
                       (static_cast<uint32_t>(iz) * P.prime[2]);
    return base + h % part.table_size;
  };

  // the 8 corners in pairs q_i = c_i + c_(i+4), then, as torch.sum orders
  // them: ((q0 + q1) + q2) + q3 over contiguous (level, corner, point)
  // products (hashgrid_encode_plain), (q0 + q2) + (q1 + q3) over the
  // point-major ones of multi_hashgrid_encode_plain
  auto corners = [&](const float (&q)[4]) -> float {
    return P.multi_order ? __fadd_rn(__fadd_rn(q[0], q[2]), __fadd_rn(q[1], q[3]))
                         : __fadd_rn(__fadd_rn(__fadd_rn(q[0], q[1]), q[2]), q[3]);
  };
  if (P.mode == kLevelSum && P.multi_order) {
    // multi_hashgrid_encode_plain sums each row's features before the lerp
    float q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float wa, wb, va[V], vb[V];
      const uint32_t ra = corner(i, wa), rb = corner(i + 4, wb);
      load_row<T, V>(table, ra, va);
      load_row<T, V>(table, rb, vb);
      q[i] = __fadd_rn(__fmul_rn(wa, sum_halves(va)), __fmul_rn(wb, sum_halves(vb)));
    }
    dst[0] = corners(q);
    return;
  }
  float q[V][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float wa, wb, va[V], vb[V];
    const uint32_t ra = corner(i, wa), rb = corner(i + 4, wb);
    load_row<T, V>(table, ra, va);
    load_row<T, V>(table, rb, vb);
#pragma unroll
    for (int f = 0; f < V; ++f)
      q[f][i] = __fadd_rn(__fmul_rn(wa, va[f]), __fmul_rn(wb, vb[f]));
  }
  float s[V];
#pragma unroll
  for (int f = 0; f < V; ++f) s[f] = corners(q[f]);
  if (P.mode == kScalar) {
    // F * sum: the same float as the sum of F * value (F a power of two)
    dst[0] = __fmul_rn(s[0], static_cast<float>(P.n_features));
  } else if (P.mode == kLevelSum) {
    dst[0] = sum_mod4(s);
  } else {
#pragma unroll
    for (int f = 0; f < V; ++f) dst[f] = s[f];
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
hashgrid_encode_kernel(const __grid_constant__ Params P,
                       const float* __restrict__ pts,  // (M, 3)
                       float* __restrict__ out) {      // (M, out_dim)
  extern __shared__ float staged[];                    // (kPoints, stride)
  __shared__ float x01[kPoints][3];
  __shared__ int part_of[kPoints];
  const int m0 = blockIdx.x * kPoints;
  const int n_pts = min(kPoints, P.n_points - m0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  if (threadIdx.x < kPoints) {
    int p = 0;
    float x[3] = {0.f, 0.f, 0.f};
    if (lane < n_pts) {
      const int m = m0 + lane;
      while (p + 1 < P.n_parts && m >= P.seg_start[p + 1]) ++p;
      const float* b = P.part[p].bounds;
#pragma unroll
      for (int d = 0; d < 3; ++d)
        x[d] = __fdiv_rn(__fsub_rn(pts[3 * m + d], b[d]), __fsub_rn(b[3 + d], b[d]));
    }
    part_of[lane] = p;
#pragma unroll
    for (int d = 0; d < 3; ++d) x01[lane][d] = x[d];
  }
  __syncthreads();

  const int per_level = (P.mode == kFeatureSum || P.mode == kConcat) ? V : 1;
  if (lane < n_pts) {
    const Part& part = P.part[part_of[lane]];
    const float x[3] = {x01[lane][0], x01[lane][1], x01[lane][2]};
    for (int l = warp; l < P.n_levels; l += kWarps)
      encode_level<T, V>(P, part, l, x, staged + lane * P.stride + l * per_level);
  }
  __syncthreads();

  // the block's rows, neighbouring threads on neighbouring floats
  const int D = P.out_dim, skip = P.include_input ? 3 : 0;
  float* dst = out + static_cast<size_t>(m0) * D;
  for (int i = threadIdx.x; i < n_pts * D; i += kThreads) {
    const int pt = i / D, col = i - pt * D;
    float v;
    if (col < skip) {
      v = x01[pt][col];
    } else if (P.mode == kFeatureSum) {
      // over the levels, in torch.sum's order (see sum_mod4)
      const float* src = staged + pt * P.stride + (col - skip);
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      for (int l = 0; l < P.n_levels; ++l) a[l & 3] = __fadd_rn(a[l & 3], src[l * V]);
      v = __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), a[2]), a[3]);
    } else {
      v = staged[pt * P.stride + (col - skip)];
    }
    dst[i] = v;
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

struct BackParams {
  Params fwd;
  int need_pts;                     // write d loss / d points
  int payload_bf16;                 // payload values in bf16 (1) or float32 (0)
  int g_stride;                     // floats a staged cotangent row takes
  int feature_major[kMaxParts][2];  // part p's dense / hashed payload (V, R) (1) or (R, V) (0)
};

// float32 -> bf16 bits, to the nearest even, as torch's cast rounds
__device__ __forceinline__ uint16_t to_bf16(float v) {
  const uint32_t u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0;  // NaN
  return static_cast<uint16_t>((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

// One (point, level): its 8 records and, with need_pts, the level's
// d loss / d x01 into dx[0..2].  gs: the point's cotangent row; k, kp: the
// point's place in its part and the part's points.
template <typename T, int V>
__device__ __forceinline__ void backward_level(const BackParams& B, const Part& part, int p,
                                               int l, int k, int kp, const float (&x)[3],
                                               const float* gs, int* __restrict__ idx,
                                               void* __restrict__ payload, float* dx) {
  const Params& P = B.fwd;
  const int n = part.entries[l];
  const float scale = __fsub_rn(static_cast<float>(n), 1.0f);
  int lo[3], hi[3];
  float w0[3], w1[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float fd = __fmul_rn(x[d], scale);
    const long long b = __float2int_rz(fd);  // as .to(int32): toward zero
    lo[d] = static_cast<int>(min(max(b, 0LL), static_cast<long long>(n - 1)));
    hi[d] = static_cast<int>(min(max(b + 1, 0LL), static_cast<long long>(n - 1)));
    const float off = __fsub_rn(fd, static_cast<float>(lo[d]));
    w0[d] = __fsub_rn(1.0f, off);
    w1[d] = off;
  }
  const int S = part.start_hash;
  const bool dense = l < S;
  const T* __restrict__ table = static_cast<const T*>(dense ? part.dense : part.hash);
  const uint32_t base = dense ? static_cast<uint32_t>(part.dense_offset[l])
                              : static_cast<uint32_t>(l - S) * part.table_size;

  // the cotangent of the level's value(s)
  const int skip = P.include_input ? 3 : 0;
  float ge[V];
#pragma unroll
  for (int f = 0; f < V; ++f)
    ge[f] = gs[skip + (P.mode == kConcat ? l * V + f : P.mode == kFeatureSum ? f : l)];
  const float nf = static_cast<float>(P.n_features);

  // the records of this level's table: (levels of the table, 8, kp), after
  // the part's earlier points' and, for the hashed table, its dense levels'
  const long long first = static_cast<long long>(P.n_levels) * 8 * P.seg_start[p] +
                          (dense ? 0LL : static_cast<long long>(S) * 8 * kp);
  const long long rows_t = static_cast<long long>(dense ? S : P.n_levels - S) * 8 * kp;
  const bool fmajor = B.feature_major[p][dense ? 0 : 1];
  const int lt = dense ? l : l - S;

  float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int ix = (c & 4) ? hi[0] : lo[0];
    const int iy = (c & 2) ? hi[1] : lo[1];
    const int iz = (c & 1) ? hi[2] : lo[2];
    const float wx = (c & 4) ? w1[0] : w0[0];
    const float wy = (c & 2) ? w1[1] : w0[1];
    const float wz = (c & 1) ? w1[2] : w0[2];
    const float w = __fmul_rn(__fmul_rn(wx, wy), wz);
    uint32_t row;
    if (dense) {
      row = base + static_cast<uint32_t>((ix * n + iy) * n + iz);
    } else {
      const uint32_t h = (static_cast<uint32_t>(ix) * P.prime[0]) ^
                         (static_cast<uint32_t>(iy) * P.prime[1]) ^
                         (static_cast<uint32_t>(iz) * P.prime[2]);
      row = base + h % part.table_size;
    }
    const long long r = (static_cast<long long>(lt) * 8 + c) * kp + k;
    idx[first + r] = static_cast<int>(row);
#pragma unroll
    for (int f = 0; f < V; ++f) {
      float v;
      if (P.mode == kScalar)
        v = P.multi_order ? __fmul_rn(__fmul_rn(ge[0], w), nf) : __fmul_rn(__fmul_rn(ge[0], nf), w);
      else
        v = __fmul_rn(ge[f], w);
      const long long at = first * V + (fmajor ? f * rows_t + r : r * V + f);
      if (B.payload_bf16)
        static_cast<uint16_t*>(payload)[at] = to_bf16(v);
      else
        static_cast<float*>(payload)[at] = v;
    }
    if (B.need_pts) {
      float val[V];
      load_row<T, V>(table, row, val);
      float u;
      if (P.mode == kScalar) {
        u = __fmul_rn(__fmul_rn(ge[0], val[0]), nf);
      } else {
        u = 0.f;
#pragma unroll
        for (int f = 0; f < V; ++f) u = __fadd_rn(u, __fmul_rn(ge[f], val[f]));
      }
      // d w / d offset: the other two dimensions' weights, signed by the bit
      const float d0 = __fmul_rn(wy, wz), d1 = __fmul_rn(wx, wz), d2 = __fmul_rn(wx, wy);
      acc[0] = __fadd_rn(acc[0], __fmul_rn(u, (c & 4) ? d0 : -d0));
      acc[1] = __fadd_rn(acc[1], __fmul_rn(u, (c & 2) ? d1 : -d1));
      acc[2] = __fadd_rn(acc[2], __fmul_rn(u, (c & 1) ? d2 : -d2));
    }
  }
  if (B.need_pts) {
#pragma unroll
    for (int d = 0; d < 3; ++d) dx[d] = __fmul_rn(acc[d], scale);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
hashgrid_backward_kernel(const __grid_constant__ BackParams B,
                         const float* __restrict__ pts,   // (M, 3)
                         const float* __restrict__ g,     // (M, out_dim): d loss / d output
                         int* __restrict__ idx,           // the records' rows
                         void* __restrict__ payload,      // their values
                         float* __restrict__ pts_grad) {  // (M, 3), with need_pts
  extern __shared__ float smem[];
  __shared__ float x01[kPoints][3];
  __shared__ int part_of[kPoints];
  const Params& P = B.fwd;
  const int m0 = blockIdx.x * kPoints;
  const int n_pts = min(kPoints, P.n_points - m0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int D = P.out_dim, L = P.n_levels;
  float* gs = smem;                           // (kPoints, g_stride): cotangent rows
  float* dx = smem + kPoints * B.g_stride;    // (kPoints, L, 3): each level's d / d x01

  if (threadIdx.x < kPoints) {
    int p = 0;
    float x[3] = {0.f, 0.f, 0.f};
    if (lane < n_pts) {
      const int m = m0 + lane;
      while (p + 1 < P.n_parts && m >= P.seg_start[p + 1]) ++p;
      const float* b = P.part[p].bounds;
#pragma unroll
      for (int d = 0; d < 3; ++d)
        x[d] = __fdiv_rn(__fsub_rn(pts[3 * m + d], b[d]), __fsub_rn(b[3 + d], b[d]));
    }
    part_of[lane] = p;
#pragma unroll
    for (int d = 0; d < 3; ++d) x01[lane][d] = x[d];
  }
  for (int i = threadIdx.x; i < n_pts * D; i += kThreads) {
    const int pt = i / D;
    gs[pt * B.g_stride + (i - pt * D)] = g[static_cast<size_t>(m0) * D + i];
  }
  __syncthreads();

  if (lane < n_pts) {
    const int p = part_of[lane];
    const int kp = P.seg_start[p + 1] - P.seg_start[p];
    const int k = m0 + lane - P.seg_start[p];
    const float x[3] = {x01[lane][0], x01[lane][1], x01[lane][2]};
    for (int l = warp; l < L; l += kWarps)
      backward_level<T, V>(B, P.part[p], p, l, k, kp, x, gs + lane * B.g_stride, idx, payload,
                           dx + (lane * L + l) * 3);
  }
  if (!B.need_pts) return;
  __syncthreads();

  // each point's gradient: the levels in order, then x01's own cotangent
  for (int t = threadIdx.x; t < n_pts * 3; t += kThreads) {
    const int pt = t / 3, d = t - 3 * pt;
    float s = 0.f;
    for (int l = 0; l < L; ++l) s = __fadd_rn(s, dx[(pt * L + l) * 3 + d]);
    if (P.include_input) s = __fadd_rn(s, gs[pt * B.g_stride + d]);
    const float* b = P.part[part_of[pt]].bounds;
    pts_grad[static_cast<size_t>(m0) * 3 + t] = __fdiv_rn(s, __fsub_rn(b[3 + d], b[d]));
  }
}

template <typename T>
cudaError_t launch_backward_typed(const BackParams& b, int values_per_row, const float* pts,
                                  const float* g, int* idx, void* payload, float* pts_grad,
                                  size_t smem, cudaStream_t stream) {
  const dim3 grid((b.fwd.n_points + kPoints - 1) / kPoints);
  switch (values_per_row) {
    case 1: hashgrid_backward_kernel<T, 1><<<grid, kThreads, smem, stream>>>(b, pts, g, idx, payload, pts_grad); break;
    case 2: hashgrid_backward_kernel<T, 2><<<grid, kThreads, smem, stream>>>(b, pts, g, idx, payload, pts_grad); break;
    case 4: hashgrid_backward_kernel<T, 4><<<grid, kThreads, smem, stream>>>(b, pts, g, idx, payload, pts_grad); break;
    case 8: hashgrid_backward_kernel<T, 8><<<grid, kThreads, smem, stream>>>(b, pts, g, idx, payload, pts_grad); break;
    case 16: hashgrid_backward_kernel<T, 16><<<grid, kThreads, smem, stream>>>(b, pts, g, idx, payload, pts_grad); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Params from the launch functions' arguments (see hashgrid_encode_launch);
// false for sizes the kernels do not take.
bool fill_params(Params& p, int n_points, int n_parts, const int* seg_start,
                 const unsigned long long* tables, const int* part_ints, int n_levels,
                 int n_features, int values_per_row, int mode, int multi_order,
                 int include_input, int out_dim, const unsigned* primes) {
  if (n_parts < 1 || n_parts > kMaxParts || n_levels < 1 || n_levels > kMaxLevels ||
      mode < kScalar || mode > kConcat || n_points < 1)
    return false;
  const int per_level = (mode == kFeatureSum || mode == kConcat) ? values_per_row : 1;
  if (n_levels * per_level > kMaxStaged) return false;
  p = Params{};
  for (int q = 0; q < n_parts; ++q) {
    const int* row = part_ints + q * (2 + 2 * n_levels);
    Part& part = p.part[q];
    part.dense = reinterpret_cast<const void*>(tables[3 * q]);
    part.hash = reinterpret_cast<const void*>(tables[3 * q + 1]);
    part.bounds = reinterpret_cast<const float*>(tables[3 * q + 2]);
    if (reinterpret_cast<uintptr_t>(part.dense) % 16 || reinterpret_cast<uintptr_t>(part.hash) % 16)
      return false;
    part.start_hash = row[0];
    part.table_size = static_cast<unsigned>(row[1]);
    for (int l = 0; l < n_levels; ++l) {
      part.entries[l] = row[2 + l];
      part.dense_offset[l] = row[2 + n_levels + l];
    }
  }
  for (int q = 0; q <= n_parts; ++q) p.seg_start[q] = seg_start[q];
  p.n_parts = n_parts;
  p.n_points = n_points;
  p.n_levels = n_levels;
  p.n_features = n_features;
  p.mode = mode;
  p.multi_order = multi_order;
  p.include_input = include_input;
  p.out_dim = out_dim;
  // an odd stride: lanes staging the same level hit different banks
  p.stride = n_levels * per_level + ((n_levels * per_level) % 2 == 0);
  for (int d = 0; d < 3; ++d) p.prime[d] = primes[d];
  return true;
}

template <typename T>
cudaError_t launch_typed(const Params& p, int values_per_row, const float* pts, float* out,
                         size_t smem, cudaStream_t stream) {
  const dim3 grid((p.n_points + kPoints - 1) / kPoints);
  switch (values_per_row) {
    case 1: hashgrid_encode_kernel<T, 1><<<grid, kThreads, smem, stream>>>(p, pts, out); break;
    case 2: hashgrid_encode_kernel<T, 2><<<grid, kThreads, smem, stream>>>(p, pts, out); break;
    case 4: hashgrid_encode_kernel<T, 4><<<grid, kThreads, smem, stream>>>(p, pts, out); break;
    case 8: hashgrid_encode_kernel<T, 8><<<grid, kThreads, smem, stream>>>(p, pts, out); break;
    case 16: hashgrid_encode_kernel<T, 16><<<grid, kThreads, smem, stream>>>(p, pts, out); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for sizes the kernel does not take (nothing runs).
//   tables: 3 x n_parts device pointers (dense, hash, bounds of each part);
//   part_ints: n_parts rows of (start_hash, table_size, entries[n_levels],
//   dense_offset[n_levels]); seg_start: n_parts + 1 point offsets;
//   values_per_row: 1 for a scalar table, else n_features; bf16: the tables'
//   dtype (1) or float32 (0); multi_order: the sums in
//   multi_hashgrid_encode_plain's order (1) or hashgrid_encode_plain's (0).
extern "C" int hashgrid_encode_launch(const float* pts, float* out, int n_points,
                                      int n_parts, const int* seg_start,
                                      const unsigned long long* tables,
                                      const int* part_ints, int n_levels, int n_features,
                                      int values_per_row, int bf16, int mode,
                                      int multi_order, int include_input, int out_dim,
                                      const unsigned* primes, void* stream) {
  Params p;
  if (!fill_params(p, n_points, n_parts, seg_start, tables, part_ints, n_levels, n_features,
                   values_per_row, mode, multi_order, include_input, out_dim, primes))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * kPoints * p.stride;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bf16 ? launch_typed<uint16_t>(p, values_per_row, pts, out, smem, s)
                               : launch_typed<float>(p, values_per_row, pts, out, smem, s);
  return static_cast<int>(err);
}

// The backward on `stream`: the forward's arguments (the points, the part
// grids and their tables as hashgrid_encode_launch takes them), then
//   g: (n_points, out_dim) float32, d loss / d the forward's output;
//   idx: n_levels x 8 x n_points int32 rows; payload: as many records x
//   values_per_row values (bf16 with payload_bf16, else float32); the
//   records part by part, each part's dense levels then its hashed ones,
//   each table (levels, 8, the part's points);
//   feature_major: 2 x n_parts flags, each part's dense and hashed table's
//   payload (values_per_row, records) (1) or (records, values_per_row) (0);
//   pts_grad: (n_points, 3) float32, written with need_pts (else unused).
// Returns cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for
// sizes the kernel does not take (nothing runs).
extern "C" int hashgrid_backward_launch(const float* pts, const float* g, int* idx,
                                        void* payload, float* pts_grad, int n_points,
                                        int n_parts, const int* seg_start,
                                        const unsigned long long* tables,
                                        const int* part_ints, const int* feature_major,
                                        int n_levels, int n_features, int values_per_row,
                                        int bf16, int mode, int multi_order,
                                        int include_input, int out_dim,
                                        const unsigned* primes, int payload_bf16,
                                        int need_pts, void* stream) {
  BackParams b;
  if (!fill_params(b.fwd, n_points, n_parts, seg_start, tables, part_ints, n_levels,
                   n_features, values_per_row, mode, multi_order, include_input, out_dim,
                   primes))
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode == kScalar ? values_per_row != 1 : values_per_row != n_features)
    return static_cast<int>(cudaErrorInvalidValue);
  b.need_pts = need_pts;
  b.payload_bf16 = payload_bf16;
  b.g_stride = out_dim + (out_dim % 2 == 0);
  for (int q = 0; q < kMaxParts; ++q)
    for (int t = 0; t < 2; ++t) b.feature_major[q][t] = q < n_parts ? feature_major[2 * q + t] : 0;
  const size_t smem = sizeof(float) * kPoints * (b.g_stride + 3 * n_levels);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_backward_typed<uint16_t>(b, values_per_row, pts, g, idx, payload, pts_grad,
                                             smem, s)
           : launch_backward_typed<float>(b, values_per_row, pts, g, idx, payload, pts_grad,
                                          smem, s);
  return static_cast<int>(err);
}
