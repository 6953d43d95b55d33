// What the two table-gradient scatter kernels (onehot_scatter.cu,
// segmented_scatter.cu) share: warp-level aggregation of records, and the
// device guard of their launch functions.
//
// Lanes of a warp whose records land on the same table entry find each other
// with __match_any_sync and sum their payloads in registers, so the group
// issues one atomic where it would issue one per lane.  The hash-grid records
// are laid out (level, corner, point), and neighbouring points share a cell
// on the coarse levels, so a warp often holds runs of equal keys there.
#pragma once

#include <cuda_runtime.h>

// Makes `device` current for a launch and gives the caller's back after.
struct DeviceGuard {
  int prev = -1;
  explicit DeviceGuard(int device) {
    if (cudaGetDevice(&prev) != cudaSuccess || prev == device) {
      prev = -1;
    } else {
      cudaSetDevice(device);
    }
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

namespace warp_aggregate {

constexpr unsigned kFull = 0xffffffffu;

// Sum of x over the lanes of `peers` (a __match_any_sync group holding this
// lane), returned to the group's lowest lane; the other lanes get partial
// sums.  A tree over the group's ranks: in each round every lane adds the
// value of the next lane of the group still in play, and the lanes whose
// rank has the round's bit set drop out.  At most five rounds; none when no
// lane of the warp has a peer.  Every lane of the warp must call it.
__device__ __forceinline__ float group_sum(unsigned peers, float x) {
  const unsigned lane = threadIdx.x & 31u;
  unsigned rank = __popc(peers & ((1u << lane) - 1u));
  peers &= ~((2u << lane) - 1u);               // the group's lanes above this one
  while (__any_sync(kFull, peers)) {
    const int next = __ffs(peers);             // 1 + the next lane in play, or 0
    const float t = __shfl_sync(kFull, x, next ? next - 1 : (int)lane);
    if (next) x += t;
    peers &= ~__ballot_sync(kFull, rank & 1u);
    rank >>= 1;
  }
  return x;
}

// Whether this lane is its group's lowest lane (the one holding the sum).
__device__ __forceinline__ bool group_leader(unsigned peers) {
  return (threadIdx.x & 31u) == (unsigned)(__ffs(peers) - 1);
}

// Whether some lane of the warp holds the same valid slot (>= 0) as the lane
// below it: a run of equal keys, as the (level, corner, point) layout gives
// on coarse levels.  A cheap test before __match_any_sync, which costs
// more than it saves when keys are spread (the one-hot kernel then adds
// lane by lane); a warp whose equal keys are not neighbours is then not
// aggregated, which changes only the order of the float32 sums.
__device__ __forceinline__ bool any_run(int slot) {
  const int below = __shfl_up_sync(kFull, slot, 1);
  return __any_sync(kFull, (threadIdx.x & 31u) != 0 && slot >= 0 && below == slot);
}

}  // namespace warp_aggregate
