// Stable radix ranks over a small id domain, for NVIDIA Hopper (sm_90a).
//
// Replaces spark_rapids_tpu/ops/pallas_kernels.py:radix_ranks, the TPU
// kernel behind every exchange's partition step:
// shuffle/partitioning.py:slice_into_partitions -> ops/sorting.py:
// partition_permutation -> radix_partition_permutation.
//
// What it computes: for int32 ids of length cap and a domain of num_lanes
// (at most 4,096), ranks[i] = #{j < i : ids[j] == ids[i]} and counts[l] =
// #{i : ids[i] == l}. Ids outside [0, num_lanes) get rank 0 and are not
// counted.
//
// What bounds it: bytes. Each row reads its 4-byte id and writes its 4-byte
// rank once: 8 * cap bytes over the card's memory rate (the counts and the
// per-block scratch are small beside them).
//
// What the design does about it: the TPU kernel walked its grid in order and
// carried the per-lane running counts from one step to the next in a block
// revisited every step. Hopper's blocks run in no order, so three kernels
// take the place of that carry, one tile of `tile` rows (a multiple of
// 1,024) per block:
//  1. radix_hist_kernel: each block counts its tile's ids per lane in a
//     shared-memory histogram (at most 16 KB). Within a warp,
//     __match_any_sync groups the lanes holding the same id and only the
//     lowest of them adds the group's size, so a domain of a few lanes does
//     not serialise 32 atomics on one address. The block writes its
//     histogram to its row of the (blocks, num_lanes) scratch;
//  2. radix_scan_kernel: one block per lane scans that lane's column of the
//     scratch in block order (warp shuffles, then the warps' totals), 256
//     blocks at a time, turning each count into the block's base (an
//     exclusive scan) and leaving the lane's total in counts;
//  3. radix_rank_kernel: one warp per tile loads its bases into shared
//     memory and walks the tile 32 rows at a time, in order, with the ids of
//     32 such steps loaded ahead into registers so that their loads overlap.
//     Within a step, __match_any_sync finds the lanes holding the same id,
//     and a row's rank is its id's running count plus the number of those
//     lanes below it (__popc of the peer mask under the lane mask); the
//     lowest of them then advances the running count by the group's size.
//     One warp per tile keeps the order within the tile without any
//     block-wide barrier.
//
// C interface for ctypes: every pointer and the stream are void*. The caller
// allocates the (ceil(cap / tile), num_lanes) int32 scratch and passes a
// tile that is a multiple of 1,024. The function returns the first launch
// error, else cudaGetLastError() after the last launch. The caller names the
// device, because this library's CUDA runtime keeps its own current device.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// rows a lane of the rank kernel loads ahead: one per step of 32 rows
constexpr int kAhead = 32;

__global__ void radix_hist_kernel(const int32_t* __restrict__ ids, int64_t cap,
                                  int num_lanes, int64_t tile,
                                  int32_t* __restrict__ block_counts) {
  extern __shared__ int32_t hist[];
  for (int l = threadIdx.x; l < num_lanes; l += blockDim.x) hist[l] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int64_t lo = (int64_t)blockIdx.x * tile;
  const int64_t hi = lo + tile < cap ? lo + tile : cap;
  // s is the same for the whole warp, so every lane reaches the match
  for (int64_t s = lo + (threadIdx.x - lane); s < hi; s += blockDim.x) {
    const int64_t i = s + lane;
    const int32_t id = i < hi ? __ldg(ids + i) : -1;
    // one unsigned compare drops negative ids and ids >= num_lanes
    const bool inside = i < hi && (uint32_t)id < (uint32_t)num_lanes;
    const unsigned peers = __match_any_sync(kFull, inside ? id : -1);
    if (inside && (peers & below) == 0u) atomicAdd(hist + id, __popc(peers));
  }
  __syncthreads();
  int32_t* mine = block_counts + (int64_t)blockIdx.x * num_lanes;
  for (int l = threadIdx.x; l < num_lanes; l += blockDim.x) mine[l] = hist[l];
}

__global__ void radix_scan_kernel(int32_t* __restrict__ block_counts,
                                  int64_t nblocks, int num_lanes,
                                  int32_t* __restrict__ counts) {
  __shared__ int32_t warp_sums[32];
  __shared__ int32_t carry;
  const int l = blockIdx.x;  // one block per lane
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int64_t b0 = 0; b0 < nblocks; b0 += blockDim.x) {
    const int64_t b = b0 + threadIdx.x;
    int32_t* p = block_counts + b * num_lanes + l;
    const int32_t c = b < nblocks ? *p : 0;
    int32_t x = c;  // inclusive scan within the warp
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the warps' totals
      int32_t w = lane < nwarps ? warp_sums[lane] : 0;
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t y = __shfl_up_sync(kFull, w, o);
        if (lane >= o) w += y;
      }
      if (lane < nwarps) warp_sums[lane] = w;
    }
    __syncthreads();
    if (b < nblocks)
      *p = carry + (warp > 0 ? warp_sums[warp - 1] : 0) + x - c;
    __syncthreads();
    if (threadIdx.x == 0) carry += warp_sums[nwarps - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) counts[l] = carry;
}

__global__ void radix_rank_kernel(const int32_t* __restrict__ ids, int64_t cap,
                                  int num_lanes, int64_t tile,
                                  const int32_t* __restrict__ block_base,
                                  int32_t* __restrict__ ranks) {
  extern __shared__ int32_t run[];
  const int lane = threadIdx.x;  // blockDim.x == 32: one warp per tile
  const int32_t* base = block_base + (int64_t)blockIdx.x * num_lanes;
  for (int l = lane; l < num_lanes; l += 32) run[l] = base[l];
  __syncwarp();
  const unsigned below = (1u << lane) - 1u;
  const int64_t lo = (int64_t)blockIdx.x * tile;
  const int64_t hi = lo + tile < cap ? lo + tile : cap;
  for (int64_t c0 = lo; c0 < hi; c0 += 32 * kAhead) {
    int32_t ahead[kAhead];
#pragma unroll
    for (int st = 0; st < kAhead; ++st) {
      const int64_t i = c0 + st * 32 + lane;
      ahead[st] = i < hi ? __ldg(ids + i) : -1;
    }
#pragma unroll
    for (int st = 0; st < kAhead; ++st) {
      const int64_t i = c0 + st * 32 + lane;
      const int32_t id = ahead[st];
      const bool inside = i < hi && (uint32_t)id < (uint32_t)num_lanes;
      // every lane takes part; rows outside the domain (and lanes past the
      // end) share the key -1, which no id inside it equals, and touch no
      // running count
      const unsigned peers = __match_any_sync(kFull, inside ? id : -1);
      int32_t r = 0;
      if (inside) r = run[id] + __popc(peers & below);
      __syncwarp();
      if (inside && (peers & below) == 0u) run[id] += __popc(peers);
      __syncwarp();
      if (i < hi) ranks[i] = r;
    }
  }
}

}  // namespace

extern "C" int radix_ranks_launch(int device, const void* ids, long long cap,
                                  int num_lanes, long long tile, void* scratch,
                                  void* ranks, void* counts, void* stream) {
  // cudaGetDevice reads this runtime's own state; set only on a change
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return (int)set;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const long long nblocks = (cap + tile - 1) / tile;
  const size_t shared = (size_t)num_lanes * sizeof(int32_t);
  radix_hist_kernel<<<(unsigned)nblocks, 256, shared, s>>>(
      (const int32_t*)ids, (int64_t)cap, num_lanes, (int64_t)tile,
      (int32_t*)scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  radix_scan_kernel<<<(unsigned)num_lanes, 256, 0, s>>>(
      (int32_t*)scratch, (int64_t)nblocks, num_lanes, (int32_t*)counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  radix_rank_kernel<<<(unsigned)nblocks, 32, shared, s>>>(
      (const int32_t*)ids, (int64_t)cap, num_lanes, (int64_t)tile,
      (const int32_t*)scratch, (int32_t*)ranks);
  return (int)cudaGetLastError();
}
