// Deterministic table-gradient scatter-add for Hopper (sm_90a): records
// grouped by output tile in a stable bucket pass that carries the payload,
// then one block per tile (or per split of a hot tile) that orders its
// records by row in shared memory, sums each row in record order and
// writes the whole tile once.
//
// Replaces, under fix_random, the Pallas TPU kernels of
// instant_nvr_tpu/ops/pallas/segmented_scatter.py (_scatter_kernel_f1 and
// _scatter_kernel; pallas_call in segmented_scatter_add) and of
// onehot_scatter.py (_kernel) for every table.  The TPU kernel is
// deterministic by construction: it sorts each level's keys with the bf16
// payload as a passenger (segmented_scatter.py:322-343), hands each macro
// tile of TILE_ROWS rows its segment of records (searchsorted) and writes
// each output tile whole, zeros included, in one grid step.  This kernel
// keeps that idea -- tile ownership -- with blocks shaped for this card.
// Contract (the wrapper's sorted_scatter_add): from R records (keys (R,)
// int32, payload (R, F) bf16, F a power of two <= 128) it computes
//   out[k, f] = sum of payload[r, f] over the records with key k
// in float32, rounded once to bf16, and writes every row: +0 where no
// record lands.  Keys outside [0, n_rows) are dropped.  No float atomics
// anywhere: every float32 add happens in an order fixed by the inputs
// alone, so two launches give the same bits.
//
// Two regimes (the wrapper's sorted_plan picks one and every size):
//   * small: n_rows x F <= 36,864 (the deformer's tables and the arms'
//     dense tables, one feature column each): the whole table is one tile
//     whose float32 sums fit one block's shared memory (144 KB).  No
//     bucket pass: the records are cut into splits of consecutive records,
//     and each split's block sums its records into a partial table.
//   * tiled: larger tables are cut into tiles of 8,192 / F rows (32 KB of
//     float32 sums).  A stable bucket pass, one radix pass over the tile
//     index (two beyond 2,048 tiles, low digit first), moves each record
//     into its tile's bucket in record order: count_kernel counts each
//     block's records per tile (integer shared atomics: exact in any
//     order), prefix_kernel and scan_kernel turn the (block, tile) counts
//     into bucket offsets in a fixed order and build the tile pass's work
//     list, and scatter_kernel orders each block's records by tile in
//     shared memory (ranks from per-warp counts and ballots, no
//     __match_any_sync) and writes each tile's run of them to consecutive
//     addresses.  With F = 1 and one pass a record travels as one 32-bit
//     word, its row inside the tile over its bf16 payload: no key array,
//     no index, no gather.  Dropped keys go nowhere.
// tile_kernel takes one work item: a tile, or a split of a tile with more
// than `split` records.  For each chunk of its records (2,048 / F tiled,
// 4,096 / F small), in bucket order: a tiled row that holds one record of
// the chunk (two row bitmaps: seen once, seen twice) takes it directly;
// the other records are compacted in record order and ordered by row,
// stably -- by rank up to 256 of them, else by a shared-memory LSD radix
// sort (8-bit digits, per-warp counts, ranks in record order, a pass of a
// single digit skipped), or not at all when they are in row order already
// (a single hot row) -- then one thread per (run of a row, feature) sums
// the run in record order from +0 and adds it to the row's float32 sum
// (runs handed out round robin from a list of their starts, so a hot
// chunk's long runs spread over the block).  An item that owns its whole tile
// writes every row of it as bf16 with 16-byte stores: the table is written
// once, with no zero pass.  The splits of a tile (the pileup and hot-row
// cases, the small regime's tables) write float32 partial tiles to the
// workspace, and combine_kernel adds them in split order from +0 and
// writes the tile.
//
// Summation order: a row whose records all fall in one chunk is summed in
// record order from +0, bit-equal to the plain version (which adds each
// row's records in record order); a row whose records span chunks is
// summed chunk by chunk, then split by split, which may differ from the
// plain version by one bf16 ulp of the row (plus float32 reordering where
// a row's sum cancels).  sorted_scatter_add_ordered (ops/scatter.py)
// follows this order in plain PyTorch, bit for bit.
//
// What bounds it: bytes.  The output is written once (2F B a row); each
// record is read (4 + 2F B), written to its bucket and read again (4 B
// with F = 1); a tile's splits add one float32 tile each, written and read
// once.  The small regime reads each record once.  In practice the bucket
// pass's latency chain (four kernels) and the tile pass's per-tile phases
// bound it (PERF.md).  Sizes: blocks of 256 threads; chunks and tiles as
// above; splits of at least 4,096 / F records and a quarter of a tile's
// elements, at most 256 a tile; bucket blocks of 256-4,096 records.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "scatter_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDigitBits = 8;                 // the in-block sort's digits
constexpr int kScanThreads = 1024;
constexpr int kSliceElems = 256;                 // combine_kernel's share of a tile
constexpr int kMaxDevices = 64;
constexpr int kScratchWords = 36;                // the block scans' scratch (33, padded)

using bf16 = __nv_bfloat16;

// The plan, in the order of sorted_plan's fields (ops/scatter.py); the
// wrapper passes it as an int64 array.
enum PlanField {
  kR, kLog2F, kNRows, kTiled, kTileRows, kLog2Tile, kTileElems, kChunk, kSplit, kMaxSplit,
  kRowBits, kPasses, kBinsLo, kBitsLo, kBinsHi, kBlockRecords, kBlocks, kTiles, kWorkMax,
  kCombineMax, kSlotsMax, kCombineGrid, kTileSmem, kScatterSmem, kSmallSplits, kPacked,
  kBucketPacked, kOffCounts, kOffTot, kOffBinsLo, kOffBinsHi, kOffTileStart, kOffHeader, kOffWork,
  kOffCombine, kOffSlot, kOffKeys, kOffPay, kOffTmpKeys, kOffTmpPay, kOffPartials,
  kWorkspaceBytes, kPlanFields
};

struct Plan {
  int R, log2_f, n_rows, tiled, tile_rows, log2_tile, tile_elems, chunk, split, max_split;
  int row_bits, block_records, small_splits, packed, bucket_packed;
};

// F = 1: a record travels as one word, its tile-local row over its bf16
// payload's bits
__device__ __forceinline__ uint32_t pack_word(uint32_t row, bf16 x) {
  return (row << 16) | __bfloat16_as_ushort(x);
}

__device__ __forceinline__ float word_payload(uint32_t w) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)(w & 0xffffu)));
}

// The in-block sort's digits: one pass of up to 8 bits, or two of half
// the row bits each; its counters are kWarps << bits.
__host__ __device__ __forceinline__ int sort_digit_bits(int row_bits) {
  return row_bits <= kMaxDigitBits ? row_bits : (row_bits + 1) / 2;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// The dynamic shared memory of a tile_kernel block, as byte offsets from
// its start (see tile_kernel): the kernel carves it so, and the launch
// refuses a plan whose tile_smem is not `bytes`.
struct TileSmem {
  int wa, wb, cnt, seen1, seen2, scratch, spay, bytes;
};

__host__ __device__ __forceinline__ TileSmem tile_smem_layout(int tile_elems, int chunk,
                                                             int row_bits, int tiled,
                                                             int tile_rows, int packed,
                                                             int log2_f) {
  const int bm_words = tiled ? (tile_rows + 31) >> 5 : 0;
  TileSmem m;
  m.wa = 4 * ((tile_elems + 3) & ~3);
  m.wb = m.wa + 4 * chunk;
  m.cnt = m.wb + 4 * chunk;
  m.seen1 = m.cnt + 4 * (kWarps << sort_digit_bits(row_bits));
  m.seen2 = m.seen1 + 4 * bm_words;
  m.scratch = m.seen2 + 4 * bm_words;
  m.spay = m.scratch + 4 * kScratchWords;
  m.bytes = m.spay + (packed ? 0 : 2 * (chunk << log2_f));
  return m;
}

// ... and of a scatter_kernel block of block_records records and `bins`
// buckets: skeys and lkeys (block_records ints each), the per-warp counts,
// goff, the scratch, then lidx (block_records shorts).
__host__ __device__ __forceinline__ int scatter_smem_bytes(int block_records, int bins) {
  return 4 * (2 * block_records + (kWarps + 1) * bins + kScratchWords) + 2 * block_records;
}

// The splits of a tile of n records (the wrapper's sorted_splits).
__device__ __forceinline__ int n_splits(int n, int split, int max_split) {
  const int s = (n + split - 1) / split;
  return s < 1 ? 1 : (s > max_split ? max_split : s);
}

// Exclusive scan of v over the block (blockDim.x a multiple of 32, at most
// 1024); *total gets the block's sum.  scratch: 33 ints of shared memory.
// Every thread must call it; it ends with a barrier, so scratch is free.
__device__ int block_scan(int v, int* scratch, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < n_warps ? scratch[lane] : 0;
    int z = w;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, z, o);
      if (lane >= o) z += y;
    }
    if (lane < n_warps) scratch[lane] = z - w;
    if (lane == 31) scratch[32] = z;
  }
  __syncthreads();
  const int res = scratch[warp] + x - v;
  *total = scratch[32];
  __syncthreads();
  return res;
}

// The lanes of the warp whose digit d (`bits` bits) equals this lane's,
// among the lanes with `valid` set: one ballot a bit, no __match_any_sync
// (whose cost grows with the distinct values a warp holds).  Every lane of
// the warp must call it.
__device__ __forceinline__ unsigned peers_of(int d, bool valid, int bits) {
  unsigned peers = __ballot_sync(kFull, valid);
  for (int k = 0; k < bits; ++k) {
    const bool bit = (d >> k) & 1;
    const unsigned m = __ballot_sync(kFull, bit);
    peers &= bit ? m : ~m;
  }
  return peers;
}

// One step of a stable multisplit: this warp's next 32 records (in record
// order, lane order) take consecutive places after the earlier records of
// their digit; base[d] is the warp's next place for digit d and is moved
// past the step's records.  Returns the lane's place (valid lanes only);
// base[d * stride] is the warp's next place for digit d.
__device__ __forceinline__ int multisplit_place(int d, bool valid, int bits, int* base,
                                                int stride) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = peers_of(d, valid, bits);
  const int first = valid ? base[d * stride] : 0;
  __syncwarp();
  if (valid && lane == __ffs(peers) - 1) base[d * stride] = first + __popc(peers);
  __syncwarp();
  return first + __popc(peers & ((1u << lane) - 1u));
}

// ---------------------------------------------------------------------------
// the bucket pass (tiled regime)
// ---------------------------------------------------------------------------

// The radix digit of a record: its tile's bits [shift, shift + width) (the
// mask is all ones on the last pass), or -1 for a key outside the table.
__device__ __forceinline__ int digit_of(int key, int n_rows, int log2_tile, int shift,
                                        unsigned mask) {
  if ((unsigned)key >= (unsigned)n_rows) return -1;
  return (int)(((unsigned)key >> log2_tile >> shift) & mask);
}

// counts[b, d] = the records of block b's range with digit d.
__global__ void __launch_bounds__(kThreads)
count_kernel(const int* __restrict__ keys, const int* __restrict__ n_dev, int* __restrict__ counts,
             int R, int n_rows, int log2_tile, int shift, unsigned mask, int bins,
             int block_records) {
  extern __shared__ int cnt[];
  const int n = n_dev ? *n_dev : R;
  const int start = blockIdx.x * block_records;
  int nb = n - start;
  nb = nb < 0 ? 0 : (nb > block_records ? block_records : nb);
  for (int d = threadIdx.x; d < bins; d += kThreads) cnt[d] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < nb; i += kThreads) {
    const int d = digit_of(keys[start + i], n_rows, log2_tile, shift, mask);
    if (d >= 0) atomicAdd(&cnt[d], 1);
  }
  __syncthreads();
  int* row = counts + (long long)blockIdx.x * bins;
  for (int d = threadIdx.x; d < bins; d += kThreads) row[d] = cnt[d];
}

// block_scan of N values at once (one set of barriers).  scratch:
// N x 33 ints.
template <int N>
__device__ void block_scan_n(const int* v, int* excl, int* total, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int x[N];
  for (int k = 0; k < N; ++k) {
    x[k] = v[k];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x[k], o);
      if (lane >= o) x[k] += y;
    }
    if (lane == 31) scratch[k * 33 + warp] = x[k];
  }
  __syncthreads();
  if (warp == 0) {
    for (int k = 0; k < N; ++k) {
      const int w = lane < n_warps ? scratch[k * 33 + lane] : 0;
      int z = w;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, z, o);
        if (lane >= o) z += y;
      }
      if (lane < n_warps) scratch[k * 33 + lane] = z - w;
      if (lane == 31) scratch[k * 33 + 32] = z;
    }
  }
  __syncthreads();
  for (int k = 0; k < N; ++k) {
    excl[k] = scratch[k * 33 + warp] + x[k] - v[k];
    total[k] = scratch[k * 33 + 32];
  }
  __syncthreads();
}

// The work list of the tile pass, from the tiles' bucket starts: tile t
// gets n_splits(its records) items, (t << 8) | split, in tile order; a tile
// of several splits gets the next index of the combine list and the first
// of its partial-tile slots.  An item is {(t << 8) | split, the tile's
// first bucket position, its records, its first slot}.  header = {items,
// tiles with several splits}.  One block; thread i takes consecutive tiles.
__device__ void build_work(const int* __restrict__ tile_start, int n_tiles, int split,
                           int max_split, int4* __restrict__ work, int* __restrict__ combine,
                           int* __restrict__ slot, int* __restrict__ header, int* scratch) {
  const int each = (n_tiles + blockDim.x - 1) / blockDim.x;
  const int t0 = threadIdx.x * each;
  const int t1 = t0 + each < n_tiles ? t0 + each : n_tiles;
  int v[3] = {0, 0, 0};
  for (int t = t0; t < t1; ++t) {
    const int ns = n_splits(tile_start[t + 1] - tile_start[t], split, max_split);
    v[0] += ns;
    v[1] += ns > 1;
    v[2] += ns > 1 ? ns : 0;
  }
  int e[3], total[3];
  block_scan_n<3>(v, e, total, scratch);
  for (int t = t0; t < t1; ++t) {
    const int first = tile_start[t], n = tile_start[t + 1] - first;
    const int ns = n_splits(n, split, max_split);
    for (int s = 0; s < ns; ++s) work[e[0] + s] = make_int4((t << 8) | s, first, n, e[2]);
    e[0] += ns;
    if (ns > 1) {
      combine[e[1]++] = t;
      slot[t] = e[2];
      e[2] += ns;
    }
  }
  if (threadIdx.x == 0) {
    header[0] = total[0];
    header[1] = total[1];
  }
}

// For each digit d (32 a block): counts[b, d] <- the sum of counts[b', d]
// over b' < b, tot[d] <- the sum over every block.  Thread (lane, warp)
// takes digit 32 * blockIdx.x + lane and one 32nd of the blocks.
__global__ void __launch_bounds__(kScanThreads)
prefix_kernel(int* __restrict__ counts, int* __restrict__ tot, int n_blocks, int bins) {
  constexpr int kScanWarps = kScanThreads / 32;
  __shared__ int part[kScanWarps][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = blockIdx.x * 32 + lane;
  const int per = (n_blocks + kScanWarps - 1) / kScanWarps;
  const int b0 = warp * per;
  const int b1 = b0 + per < n_blocks ? b0 + per : n_blocks;
  int s = 0;
  if (d < bins) {
    for (int b = b0; b < b1; ++b) s += counts[(long long)b * bins + d];
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0) {
    int run = 0;
    for (int w = 0; w < kScanWarps; ++w) {
      const int c = part[w][lane];
      part[w][lane] = run;
      run += c;
    }
    if (d < bins) tot[d] = run;
  }
  __syncthreads();
  if (d < bins) {
    int run = part[warp][lane];
    for (int b = b0; b < b1; ++b) {
      int* c = counts + (long long)b * bins + d;
      const int v = *c;
      *c = run;
      run += v;
    }
  }
}

// bin_start[0..bins] <- the exclusive scan of tot (bin_start[bins] = the
// records bucketed); on the last radix pass of one, the digits are the
// tiles, and with `work` the block also builds the work list as
// build_work does, from the same registers.  One block of kScanThreads
// threads, bins <= 2 kScanThreads; thread i takes consecutive digits.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* __restrict__ tot, int* __restrict__ bin_start, int bins, int split,
            int max_split, int4* __restrict__ work, int* __restrict__ combine,
            int* __restrict__ slot, int* __restrict__ header) {
  __shared__ int scratch[4 * 33];
  const int each = (bins + kScanThreads - 1) / kScanThreads;
  const int d0 = threadIdx.x * each;
  int c[2] = {0, 0};
  int v[4] = {0, 0, 0, 0};                      // records, items, multi tiles, their slots
  for (int k = 0; k < each; ++k) {
    const int d = d0 + k;
    c[k] = d < bins ? tot[d] : 0;
    const int ns = d < bins ? n_splits(c[k], split, max_split) : 0;
    v[0] += c[k];
    v[1] += ns;
    v[2] += ns > 1;
    v[3] += ns > 1 ? ns : 0;
  }
  int e[4], total[4];
  block_scan_n<4>(v, e, total, scratch);
  for (int k = 0; k < each; ++k) {
    const int d = d0 + k;
    if (d >= bins) break;
    bin_start[d] = e[0];
    if (work != nullptr) {
      const int ns = n_splits(c[k], split, max_split);
      for (int s = 0; s < ns; ++s) work[e[1] + s] = make_int4((d << 8) | s, e[0], c[k], e[3]);
      e[1] += ns;
      if (ns > 1) {
        combine[e[2]++] = d;
        slot[d] = e[3];
        e[3] += ns;
      }
    }
    e[0] += c[k];
  }
  if (threadIdx.x == 0) {
    bin_start[bins] = total[0];
    if (work != nullptr) {
      header[0] = total[1];
      header[1] = total[2];
    }
  }
}

// Each block moves its range of records (block_records, a multiple of 256)
// into their digits' buckets, stably: the block first orders its records by
// digit in shared memory (warp w takes the w-th eighth of the range, 32
// records a step; places by multisplit_place), so that each digit's
// records leave as one run of consecutive addresses, at bin_start[d] +
// counts[b, d] (the digit's records of earlier blocks).  With `pack` (one
// radix pass, F = 1) a record leaves as one word (pack_word: the row inside
// its tile, the payload); else as its key and its F payload values.
// `bits` covers the digits (bins <= 1 << bits).
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const int* __restrict__ keys, const bf16* __restrict__ pay,
               const int* __restrict__ n_dev, const int* __restrict__ counts,
               const int* __restrict__ bin_start, int* __restrict__ out_keys,
               bf16* __restrict__ out_pay, int R, int log2_f, int n_rows, int log2_tile,
               int shift, unsigned mask, int bins, int bits, int block_records, int pack) {
  extern __shared__ int smem_i[];
  int* skeys = smem_i;                        // block_records, in record order
  int* lkeys = skeys + block_records;         // block_records, in digit order
  int* wcnt = lkeys + block_records;          // kWarps x bins
  int* goff = wcnt + kWarps * bins;           // bins
  int* scratch = goff + bins;                 // kScratchWords
  unsigned short* lidx =                      // block_records
      reinterpret_cast<unsigned short*>(scratch + kScratchWords);
  const int n = n_dev ? *n_dev : R;
  const int start = blockIdx.x * block_records;
  int nb = n - start;
  nb = nb < 0 ? 0 : (nb > block_records ? block_records : nb);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int F = 1 << log2_f;
  const int* before = counts + (long long)blockIdx.x * bins;
  for (int d = threadIdx.x; d < bins; d += kThreads) goff[d] = bin_start[d] + before[d];
  for (int i = threadIdx.x; i < nb; i += kThreads) skeys[i] = keys[start + i];
  for (int j = threadIdx.x; j < kWarps * bins; j += kThreads) wcnt[j] = 0;
  __syncthreads();
  const int per_warp = block_records / kWarps;
  const int w0 = warp * per_warp;
  int* mine = wcnt + warp * bins;
  for (int i = w0 + lane; i < w0 + per_warp && i < nb; i += 32) {
    const int d = digit_of(skeys[i], n_rows, log2_tile, shift, mask);
    if (d >= 0) atomicAdd(&mine[d], 1);       // integer counts: exact in any order
  }
  __syncthreads();
  // the block's digit d starts at loff[d] (a scan over the digits); warp
  // w's records of d at loff[d] + the records of d in earlier warps
  const int each = (bins + kThreads - 1) / kThreads;
  const int d0 = threadIdx.x * each;
  const int d1 = d0 + each < bins ? d0 + each : bins;
  int sum = 0;
  for (int d = d0; d < d1; ++d) {
    for (int w = 0; w < kWarps; ++w) sum += wcnt[w * bins + d];
  }
  int n_valid;
  int loff = block_scan(sum, scratch, &n_valid);
  for (int d = d0; d < d1; ++d) {
    goff[d] -= loff;
    for (int w = 0; w < kWarps; ++w) {
      const int c = wcnt[w * bins + d];
      wcnt[w * bins + d] = loff;
      loff += c;
    }
  }
  __syncthreads();
  for (int i = w0 + lane; i < w0 + per_warp; i += 32) {
    const bool in = i < nb;
    const int key = in ? skeys[i] : -1;
    const int d = in ? digit_of(key, n_rows, log2_tile, shift, mask) : -1;
    const int lp = multisplit_place(d, d >= 0, bits, mine, 1);
    if (d >= 0) {
      lkeys[lp] = key;
      lidx[lp] = (unsigned short)i;
    }
  }
  __syncthreads();
  // consecutive threads, consecutive places of a digit's run
  if (pack) {
    for (int j0 = threadIdx.x; j0 < n_valid; j0 += 4 * kThreads) {
      bf16 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {             // four payload loads in flight
        const int j = j0 + u * kThreads;
        v[u] = j < n_valid ? pay[start + lidx[j]] : bf16();
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + u * kThreads;
        if (j >= n_valid) break;
        const int key = lkeys[j];
        const int pos = goff[digit_of(key, n_rows, log2_tile, shift, mask)] + j;
        out_keys[pos] = (int)pack_word((uint32_t)key & ((1u << log2_tile) - 1u), v[u]);
      }
    }
    return;
  }
  for (int j = threadIdx.x; j < n_valid; j += kThreads) {
    const int key = lkeys[j];
    const int pos = goff[digit_of(key, n_rows, log2_tile, shift, mask)] + j;
    const long long src = (long long)(start + lidx[j]) << log2_f;
    {
      out_keys[pos] = key;
      bf16* dst = out_pay + ((long long)pos << log2_f);
      for (int f = 0; f < F; ++f) dst[f] = pay[src + f];
    }
  }
}

// Two radix passes: the tiles' bucket starts from the bucketed keys (sorted
// by tile): tile_start[u] = the first position whose tile is >= u.
__global__ void __launch_bounds__(kThreads)
boundary_kernel(const int* __restrict__ bkeys, const int* __restrict__ n_dev,
                int* __restrict__ tile_start, int n_tiles, int log2_tile) {
  const int n = *n_dev;
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (n == 0) {
    for (long long u = p; u <= n_tiles; u += (long long)gridDim.x * kThreads) tile_start[u] = 0;
    return;
  }
  if (p >= n) return;
  const int t = bkeys[p] >> log2_tile;
  const int prev = p == 0 ? -1 : bkeys[p - 1] >> log2_tile;
  for (int u = prev + 1; u <= t; ++u) tile_start[u] = (int)p;
  if (p == n - 1) {
    for (int u = t + 1; u <= n_tiles; ++u) tile_start[u] = n;
  }
}

__global__ void __launch_bounds__(kScanThreads)
work_kernel(const int* __restrict__ tile_start, int n_tiles, int split, int max_split,
            int4* __restrict__ work, int* __restrict__ combine, int* __restrict__ slot,
            int* __restrict__ header) {
  __shared__ int scratch[3 * 33];
  build_work(tile_start, n_tiles, split, max_split, work, combine, slot, header, scratch);
}

// ---------------------------------------------------------------------------
// the tile pass
// ---------------------------------------------------------------------------

// Stable LSD radix sort of n <= chunk words (row << 16 | index) by their
// row bits: one pass of up to 8 bits, or two of half the bits each.  Warp w
// takes positions [w * per, w * per + per) of each pass's input, 32 at a
// time, so places follow the input order: counts per (digit, warp), a scan
// in that order, then multisplit_place.  A pass whose words all share
// their digit (a hot level's few rows) leaves the order as it is and is
// skipped.  cnt holds kWarps << sort_digit_bits(row_bits) counters; scratch
// 33 ints.
// Returns the buffer that holds the result.  Starts and ends with a
// barrier passed.
__device__ uint32_t* block_sort(uint32_t* a, uint32_t* b, int n, int row_bits, int* cnt,
                                int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = ((n + kWarps - 1) / kWarps + 31) & ~31;
  const int lo = warp * per;
  const int hi = lo + per < n ? lo + per : n;
  const int bits = sort_digit_bits(row_bits);
  const int passes = bits ? (row_bits + bits - 1) / bits : 0;
  const int bins = 1 << bits;
  const unsigned dmask = (unsigned)bins - 1u;
  const int total = bins * kWarps;
  const int each = (total + kThreads - 1) / kThreads;   // counters a thread scans
  int* c = cnt;                                 // laid out (digit, warp)
  for (int pass = 0; pass < passes; ++pass) {
    const int shift = 16 + pass * bits;
    for (int j = threadIdx.x; j < total; j += kThreads) c[j] = 0;
    const uint32_t first = n > 0 ? (a[0] >> shift) & dmask : 0u;
    __syncthreads();
    bool same = true;
    for (int i = lo + lane; i < hi; i += 32) {
      const uint32_t d = (a[i] >> shift) & dmask;
      same &= d == first;
      atomicAdd(&c[(int)d * kWarps + warp], 1);
    }
    if (__syncthreads_and(same)) continue;      // one digit: the order stands
    const int j0 = threadIdx.x * each;
    const int j1 = j0 + each < total ? j0 + each : total;
    int sum = 0;
    for (int j = j0; j < j1; ++j) sum += c[j];
    int all;
    int run = block_scan(sum, scratch, &all);
    for (int j = j0; j < j1; ++j) {
      const int v = c[j];
      c[j] = run;
      run += v;
    }
    __syncthreads();
    int* mine = c + warp;                       // digit d's counter at mine[d * kWarps]
    for (int i = lo + lane; i < lo + per; i += 32) {
      const bool in = i < hi;
      const uint32_t w = in ? a[i] : 0u;
      const int d = (int)((w >> shift) & dmask);
      const int place = multisplit_place(d, in, bits, mine, kWarps);
      if (in) b[place] = w;
    }
    __syncthreads();
    uint32_t* t = a;
    a = b;
    b = t;
  }
  return a;
}

// The payload (feature f) of word q: spay null, the words carry their
// payload (F = 1); else their index into spay.
__device__ __forceinline__ float payload_at(const uint32_t* w, int q, const bf16* spay,
                                            int log2_f, int f) {
  return spay ? __bfloat162float(spay[((w[q] & 0xffffu) << log2_f) + f]) : word_payload(w[q]);
}

// The sum of a run of words [q0, q1) (feature f), in order from +0,
// sixteen loads in flight.
__device__ __forceinline__ float run_sum(const uint32_t* w, int q0, int q1, const bf16* spay,
                                         int log2_f, int f) {
  float sum = 0.f;
  int q = q0;
  for (; q + 16 <= q1; q += 16) {
    float v[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) v[u] = payload_at(w, q + u, spay, log2_f, f);
#pragma unroll
    for (int u = 0; u < 16; ++u) sum += v[u];
  }
  for (; q < q1; ++q) sum += payload_at(w, q, spay, log2_f, f);
  return sum;
}

// The sums of the rows of `w` (n words, sorted by row, each row's records
// in record order), each run added in order from +0 and then into acc.
// Up to kThreads words: one thread a (word, feature), which sums the run
// the word starts (its end by doubling steps, then a binary search).
// More: the runs' first positions are listed first (warp ballots, in
// position order, into `starts`: n ints), so that threads take whole runs
// round robin, one per (run, feature), and a run ends where the next
// begins -- a hot chunk's long runs spread over the block.  scratch:
// kWarps ints.  Every thread must call it.
__device__ void run_sums(const uint32_t* w, int n, const bf16* spay, float* acc, int log2_f,
                         int* starts, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int F = 1 << log2_f;
  if (n <= kThreads) {
    for (int j = threadIdx.x; j < (n << log2_f); j += kThreads) {
      const int q0 = j >> log2_f, f = j & (F - 1);
      const uint32_t r = w[q0] >> 16;
      if (q0 > 0 && (w[q0 - 1] >> 16) == r) continue;
      int lo = q0 + 1, hi = q0 + 1, step = 1;
      while (hi < n && (w[hi] >> 16) == r) {
        lo = hi + 1;
        step <<= 1;
        hi = q0 + step;
      }
      if (hi > n) hi = n;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if ((w[mid] >> 16) == r) lo = mid + 1; else hi = mid;
      }
      acc[(r << log2_f) + f] += run_sum(w, q0, lo, spay, log2_f, f);
    }
    return;
  }
  const int per = ((n + kWarps - 1) / kWarps + 31) & ~31;
  const int lo = warp * per;
  const int hi = lo + per < n ? lo + per : n;
  int mine = 0;
  for (int i = lo + lane; i < lo + per; i += 32) {
    const bool first = i < hi && (i == 0 || (w[i] >> 16) != (w[i - 1] >> 16));
    mine += __popc(__ballot_sync(kFull, first));
  }
  if (lane == 0) scratch[warp] = mine;
  __syncthreads();
  int base = 0, n_runs = 0;
  for (int v = 0; v < kWarps; ++v) {
    base += v < warp ? scratch[v] : 0;
    n_runs += scratch[v];
  }
  for (int i = lo + lane; i < lo + per; i += 32) {
    const bool first = i < hi && (i == 0 || (w[i] >> 16) != (w[i - 1] >> 16));
    const unsigned m = __ballot_sync(kFull, first);
    if (first) starts[base + __popc(m & ((1u << lane) - 1u))] = i;
    base += __popc(m);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < (n_runs << log2_f); j += kThreads) {
    const int run = j >> log2_f, f = j & (F - 1);
    const int q0 = starts[run];
    const int q1 = run + 1 < n_runs ? starts[run + 1] : n;
    acc[((w[q0] >> 16) << log2_f) + f] += run_sum(w, q0, q1, spay, log2_f, f);
  }
}

// One work item: tile t's split s (small regime: the table, split
// blockIdx.x).  Dynamic shared memory (tile_smem_layout): the tile's
// float32 sums (tile_elems, rounded up to 4), two word buffers of `chunk`,
// the sort counters, (tiled) two row bitmaps, the scan scratch, then (F > 1) the
// chunk's payload (chunk x F bf16).  A record is a word: its tile-local row
// over its payload (F = 1: pack_word) or over its index in the chunk.  Each
// chunk of the tiled regime: the rows that hold one record of the chunk
// take it directly; the records of the other rows ("dups", found with the
// bitmaps: seen once, seen twice) are compacted in record order.  The
// small regime compacts every record of a row of the table.  The compacted
// records are ordered by row, stably -- by rank (a record's count of
// records of a lower row, or of its row and earlier) up to 256 of them,
// else by block_sort -- then summed run by run.
__global__ void __launch_bounds__(kThreads)
tile_kernel(const int* __restrict__ keys, const bf16* __restrict__ pay,
            bf16* __restrict__ out, float* __restrict__ partials,
            const int* __restrict__ tile_start, const int4* __restrict__ work,
            const int* __restrict__ header, const int* __restrict__ slot, Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TileSmem m = tile_smem_layout(p.tile_elems, p.chunk, p.row_bits, p.tiled, p.tile_rows,
                                      p.packed, p.log2_f);
  const int bm_words = p.tiled ? (p.tile_rows + 31) >> 5 : 0;
  float* acc = reinterpret_cast<float*>(smem);
  uint32_t* wa = reinterpret_cast<uint32_t*>(smem + m.wa);
  uint32_t* wb = reinterpret_cast<uint32_t*>(smem + m.wb);
  int* cnt = reinterpret_cast<int*>(smem + m.cnt);
  unsigned* seen1 = reinterpret_cast<unsigned*>(smem + m.seen1);
  unsigned* seen2 = reinterpret_cast<unsigned*>(smem + m.seen2);
  int* scratch = reinterpret_cast<int*>(smem + m.scratch);
  bf16* spay = p.packed ? nullptr : reinterpret_cast<bf16*>(smem + m.spay);

  int t, s, first, n_t, slot_t = 0;
  if (p.tiled) {
    const int4 item = work[blockIdx.x];        // in bounds: work_max entries
    if ((int)blockIdx.x >= header[0]) return;
    t = item.x >> 8;
    s = item.x & 255;
    first = item.y;
    n_t = item.z;
    slot_t = item.w;
  } else {
    t = 0;
    s = blockIdx.x;
    first = 0;
    n_t = p.R;
  }
  const int ns = p.tiled ? n_splits(n_t, p.split, p.max_split) : p.small_splits;
  const int len = (n_t + ns - 1) / ns;
  const int a = first + s * len;
  const int b = a + len < first + n_t ? a + len : first + n_t;
  const int row0 = t * p.tile_rows;
  const int rows = p.n_rows - row0 < p.tile_rows ? p.n_rows - row0 : p.tile_rows;
  const int log2_f = p.log2_f, F = 1 << log2_f;
  const int E = rows << log2_f;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int c0 = a; c0 < b || c0 == a; c0 += p.chunk) {
    const int n = b - c0 < p.chunk ? b - c0 : p.chunk;
    // every load of the chunk in flight at once: kPer = 4,096 / 256
    // elements a thread (chunk x F <= 4,096)
    constexpr int kPer = 16;
    const bf16* src = pay + ((long long)c0 << log2_f);
    int key[kPer];
    bf16 v[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = threadIdx.x + u * kThreads;
      key[u] = i < n ? keys[c0 + i] : 0;
      v[u] = (p.packed && !p.bucket_packed && i < n) ? src[i] : bf16();
    }
    if (c0 == a) {
      for (int e = threadIdx.x; e < E; e += kThreads) acc[e] = 0.f;
    }
    __syncthreads();                            // the previous chunk is done
    for (int j = threadIdx.x; j < bm_words; j += kThreads) seen1[j] = seen2[j] = 0u;
    if (!p.packed) {
      for (int j = threadIdx.x; j < (n << log2_f); j += kThreads) spay[j] = src[j];
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (i >= n) continue;
      uint32_t w;
      if (p.bucket_packed) {
        w = (uint32_t)key[u];
      } else {
        // tiled: the bucket holds only this tile's keys; small: a key
        // outside the table gets the row `rows`, past every real row
        const uint32_t r = (p.tiled || (unsigned)key[u] < (unsigned)p.n_rows)
                               ? (uint32_t)(key[u] - row0) : (uint32_t)rows;
        w = p.packed ? pack_word(r, v[u]) : (r << 16) | (uint32_t)i;
      }
      wa[i] = w;
    }
    if (p.tiled) {
      // the bitmaps: seen once, seen twice.  Of a run of lanes that hold one
      // row, only the first sets the bits (a hot row's records come in runs)
      for (int u = 0; u < kPer && u * kThreads < n; ++u) {
        const int i = threadIdx.x + u * kThreads;      // uniform over the warp
        const uint32_t r = i < n ? wa[i] >> 16 : 0xffffu;
        const uint32_t before = __shfl_up_sync(kFull, r, 1);
        const uint32_t after = __shfl_down_sync(kFull, r, 1);
        const bool head = i < n && (lane == 0 || before != r);
        const bool more = lane < 31 && after == r && i + 1 < n;
        if (head) {
          const unsigned bit = 1u << (r & 31);
          if ((atomicOr(&seen1[r >> 5], bit) & bit) || more) atomicOr(&seen2[r >> 5], bit);
        }
      }
    }
    __syncthreads();
    // tiled: rows of one record take it; the others' records ("dups") are
    // counted per warp, then compacted in record order
    const int per = ((n + kWarps - 1) / kWarps + 31) & ~31;
    const int lo = warp * per;
    const int hi = lo + per < n ? lo + per : n;
    int mine = 0;
    for (int i = lo + lane; i < lo + per; i += 32) {
      const bool in = i < hi;
      const uint32_t w = in ? wa[i] : 0u;
      const int r = (int)(w >> 16);
      const bool dup = in && r < rows && (!p.tiled || (seen2[r >> 5] >> (r & 31) & 1u));
      if (p.tiled && in && !dup) {
        for (int f = 0; f < F; ++f) acc[(r << log2_f) + f] += 0.f + payload_at(wa, i, spay, log2_f, f);
      }
      mine += __popc(__ballot_sync(kFull, dup));
    }
    if (lane == 0) scratch[warp] = mine;
    __syncthreads();
    int base = 0, n_dup = 0;
    for (int w = 0; w < kWarps; ++w) {
      base += w < warp ? scratch[w] : 0;
      n_dup += scratch[w];
    }
    for (int i = lo + lane; i < lo + per; i += 32) {
      const bool in = i < hi;
      const uint32_t w = in ? wa[i] : 0u;
      const int r = (int)(w >> 16);
      const bool dup = in && r < rows && (!p.tiled || (seen2[r >> 5] >> (r & 31) & 1u));
      const unsigned m = __ballot_sync(kFull, dup);
      if (dup) wb[base + __popc(m & ((1u << lane) - 1u))] = w;
      base += __popc(m);
    }
    __syncthreads();
    // more than the rank sort takes: in row order already (a single hot
    // row, or presorted keys)?
    bool ordered = n_dup > kThreads;
    for (int i = (int)threadIdx.x + 1; ordered && i < n_dup; i += kThreads) {
      ordered &= (wb[i - 1] >> 16) <= (wb[i] >> 16);
    }
    const uint32_t* w = wa;
    if (n_dup > kThreads && __syncthreads_and(ordered)) {
      w = wb;
    } else if (n_dup <= kThreads) {
      if ((int)threadIdx.x < n_dup) {
        const uint32_t me = wb[threadIdx.x];
        const uint32_t r = me >> 16;
        int rank = 0;
        for (int k = 0; k < n_dup; ++k) {
          const uint32_t rk = wb[k] >> 16;
          rank += rk < r || (rk == r && k < (int)threadIdx.x);
        }
        wa[rank] = me;
      }
      __syncthreads();
    } else {
      w = block_sort(wb, wa, n_dup, p.row_bits, cnt, scratch);
    }
    run_sums(w, n_dup, spay, acc, log2_f, reinterpret_cast<int*>(w == wa ? wb : wa), scratch);
  }
  __syncthreads();
  if (ns == 1) {
    bf16* o = out + ((long long)row0 << log2_f);
    const int nv = E >> 3;
    for (int v = threadIdx.x; v < nv; v += kThreads) {
      const float4 lo = reinterpret_cast<const float4*>(acc)[2 * v];
      const float4 hi = reinterpret_cast<const float4*>(acc)[2 * v + 1];
      uint4 pk;
      pk.x = pack_bf16(lo.x, lo.y);
      pk.y = pack_bf16(lo.z, lo.w);
      pk.z = pack_bf16(hi.x, hi.y);
      pk.w = pack_bf16(hi.z, hi.w);
      reinterpret_cast<uint4*>(o)[v] = pk;
    }
    for (int e = (nv << 3) + threadIdx.x; e < E; e += kThreads) o[e] = __float2bfloat16_rn(acc[e]);
  } else {
    float* dst = partials + ((long long)slot_t + s) * p.tile_elems;
    for (int e = threadIdx.x; e < E; e += kThreads) dst[e] = acc[e];
  }
}

// The tiles of several splits: each slice of kSliceElems entries is the sum
// of its partial tiles in split order, from +0, rounded once to bf16.
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ partials, bf16* __restrict__ out,
               const int* __restrict__ tile_start, const int* __restrict__ combine,
               const int* __restrict__ slot, const int* __restrict__ header, Plan p) {
  const int m_tiles = p.tiled ? header[1] : (p.small_splits > 1 ? 1 : 0);
  const int slices = (p.tile_elems + kSliceElems - 1) / kSliceElems;
  for (int w = blockIdx.x; w < m_tiles * slices; w += gridDim.x) {
    const int m = w / slices, sl = w - m * slices;
    const int t = p.tiled ? combine[m] : 0;
    const int ns = p.tiled ? n_splits(tile_start[t + 1] - tile_start[t], p.split, p.max_split)
                           : p.small_splits;
    const float* part = partials + (long long)(p.tiled ? slot[t] : 0) * p.tile_elems;
    const int row0 = t * p.tile_rows;
    const int rows = p.n_rows - row0 < p.tile_rows ? p.n_rows - row0 : p.tile_rows;
    const int E = rows << p.log2_f;
    const int e1 = (sl + 1) * kSliceElems < E ? (sl + 1) * kSliceElems : E;
    bf16* o = out + ((long long)row0 << p.log2_f);
    for (int e = sl * kSliceElems + threadIdx.x; e < e1; e += kThreads) {
      const float* x = part + e;
      float sum = 0.f;
      int s = 0;
      for (; s + 8 <= ns; s += 8) {            // eight loads in flight, adds in order
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = x[(long long)(s + u) * p.tile_elems];
#pragma unroll
        for (int u = 0; u < 8; ++u) sum += v[u];
      }
      for (; s < ns; ++s) sum += x[(long long)s * p.tile_elems];
      o[e] = __float2bfloat16_rn(sum);
    }
  }
}

int g_smem_set[kMaxDevices][2];

cudaError_t allow_smem(const void* kernel, int which, int device, int bytes) {
  if (bytes <= 48 * 1024 || bytes <= g_smem_set[device][which]) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) g_smem_set[device][which] = bytes;
  return err;
}

// One radix pass of the bucket pass: count, scan, move.  `n_dev` is null on
// the first pass (R records) and the first pass's total on the second.
cudaError_t bucket_pass(const long long* q, unsigned char* ws, const int* keys, const bf16* pay,
                        const int* n_dev, int* out_keys, bf16* out_pay, int shift,
                        unsigned mask, int bins, int* bin_start, bool last, cudaStream_t s) {
  int* counts = reinterpret_cast<int*>(ws + q[kOffCounts]);
  int* tot = reinterpret_cast<int*>(ws + q[kOffTot]);
  const int R = (int)q[kR], n_rows = (int)q[kNRows], log2_tile = (int)q[kLog2Tile];
  const int nb = (int)q[kBlocks], br = (int)q[kBlockRecords];
  int* header = reinterpret_cast<int*>(ws + q[kOffHeader]);
  count_kernel<<<nb, kThreads, bins * (int)sizeof(int), s>>>(
      keys, n_dev, counts, R, n_rows, log2_tile, shift, mask, bins, br);
  prefix_kernel<<<(bins + 31) / 32, kScanThreads, 0, s>>>(counts, tot, nb, bins);
  int4* work = last && q[kPasses] == 1 ? reinterpret_cast<int4*>(ws + q[kOffWork]) : nullptr;
  scan_kernel<<<1, kScanThreads, 0, s>>>(
      tot, bin_start, bins, (int)q[kSplit], (int)q[kMaxSplit], work,
      reinterpret_cast<int*>(ws + q[kOffCombine]), reinterpret_cast<int*>(ws + q[kOffSlot]),
      header);
  int bits = 0;
  while ((1 << bits) < bins) ++bits;
  scatter_kernel<<<nb, kThreads, (int)q[kScatterSmem], s>>>(
      keys, pay, n_dev, counts, bin_start, out_keys, out_pay, R, (int)q[kLog2F], n_rows,
      log2_tile, shift, mask, bins, bits, br, last ? (int)q[kBucketPacked] : 0);
  return cudaGetLastError();
}

}  // namespace

// keys (R,) int32; payload (R, F) bf16; out (n_rows, F) bf16; ws the
// workspace of plan[kWorkspaceBytes] bytes (16-byte aligned, any content);
// plan the kPlanFields int64 of sorted_plan.  Enqueues every kernel on
// `stream` of `device`; returns a cudaError_t (0 = launched).
extern "C" int sorted_scatter_launch(const int* keys, const void* payload, void* out, void* ws,
                                     const long long* plan, int device, void* stream) {
  const long long* q = plan;
  if (q[kR] < 0 || q[kNRows] < 1 || q[kLog2F] < 0 || q[kLog2F] > 7 || q[kChunk] < 1 ||
      q[kChunk] > 65536 || q[kRowBits] > 16 || device < 0 || device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceGuard guard(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* w = static_cast<unsigned char*>(ws);
  const bf16* pay = static_cast<const bf16*>(payload);
  bf16* o = static_cast<bf16*>(out);
  Plan p{(int)q[kR], (int)q[kLog2F], (int)q[kNRows], (int)q[kTiled], (int)q[kTileRows],
         (int)q[kLog2Tile], (int)q[kTileElems], (int)q[kChunk], (int)q[kSplit],
         (int)q[kMaxSplit], (int)q[kRowBits], (int)q[kBlockRecords], (int)q[kSmallSplits],
         (int)q[kPacked], (int)q[kBucketPacked]};
  // the plan's shared-memory sizes must be what the kernels carve
  const int bins = (int)(q[kBinsLo] > q[kBinsHi] ? q[kBinsLo] : q[kBinsHi]);
  if (q[kTileSmem] != tile_smem_layout(p.tile_elems, p.chunk, p.row_bits, p.tiled, p.tile_rows,
                                       p.packed, p.log2_f).bytes ||
      (p.tiled && q[kScatterSmem] != scatter_smem_bytes(p.block_records, bins))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = allow_smem((const void*)tile_kernel, 0, device, (int)q[kTileSmem]);
  if (err == cudaSuccess && p.tiled) {
    err = allow_smem((const void*)scatter_kernel, 1, device, (int)q[kScatterSmem]);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  float* partials = reinterpret_cast<float*>(w + q[kOffPartials]);
  int* tile_start = reinterpret_cast<int*>(w + q[kOffTileStart]);
  int4* work = reinterpret_cast<int4*>(w + q[kOffWork]);
  int* combine = reinterpret_cast<int*>(w + q[kOffCombine]);
  int* slot = reinterpret_cast<int*>(w + q[kOffSlot]);
  int* header = reinterpret_cast<int*>(w + q[kOffHeader]);
  const int* tkeys = keys;
  const bf16* tpay = pay;
  if (p.tiled) {
    int* bkeys = reinterpret_cast<int*>(w + q[kOffKeys]);
    bf16* bpay = reinterpret_cast<bf16*>(w + q[kOffPay]);
    if (q[kPasses] == 1) {
      err = bucket_pass(q, w, keys, pay, nullptr, bkeys, bpay, 0, ~0u, (int)q[kTiles],
                        tile_start, true, s);
    } else {
      // low digit first, then the high digit: both stable, so the buckets
      // come out by tile and, inside one, in record order
      int* lo_start = reinterpret_cast<int*>(w + q[kOffBinsLo]);
      int* hi_start = reinterpret_cast<int*>(w + q[kOffBinsHi]);
      int* mkeys = reinterpret_cast<int*>(w + q[kOffTmpKeys]);
      bf16* mpay = reinterpret_cast<bf16*>(w + q[kOffTmpPay]);
      const int bins_lo = (int)q[kBinsLo];
      err = bucket_pass(q, w, keys, pay, nullptr, mkeys, mpay, 0, (unsigned)bins_lo - 1u,
                        bins_lo, lo_start, false, s);
      if (err == cudaSuccess) {
        err = bucket_pass(q, w, mkeys, mpay, lo_start + bins_lo, bkeys, bpay, (int)q[kBitsLo],
                          ~0u, (int)q[kBinsHi], hi_start, true, s);
      }
      if (err == cudaSuccess) {
        const long long grid = (q[kR] + kThreads - 1) / kThreads;
        boundary_kernel<<<(int)(grid < 1 ? 1 : grid), kThreads, 0, s>>>(
            bkeys, lo_start + bins_lo, tile_start, (int)q[kTiles], p.log2_tile);
        work_kernel<<<1, kScanThreads, 0, s>>>(tile_start, (int)q[kTiles], p.split,
                                               p.max_split, work, combine, slot, header);
        err = cudaGetLastError();
      }
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    tkeys = bkeys;
    tpay = bpay;
  }
  const int items = p.tiled ? (int)q[kWorkMax] : p.small_splits;
  tile_kernel<<<items, kThreads, (int)q[kTileSmem], s>>>(tkeys, tpay, o, partials, tile_start,
                                                         work, header, slot, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || q[kCombineMax] == 0) return static_cast<int>(err);
  combine_kernel<<<(int)q[kCombineGrid], kThreads, 0, s>>>(partials, o, tile_start, combine,
                                                           slot, header, p);
  return static_cast<int>(cudaGetLastError());
}
