// Stable radix ranks and the partition permutation over a small id domain,
// for NVIDIA Hopper (sm_90a).
//
// Replaces spark_rapids_tpu/ops/pallas_kernels.py:radix_ranks, the TPU
// kernel behind every exchange's partition step
// (shuffle/partitioning.py:slice_into_partitions -> ops/sorting.py:
// partition_permutation) and behind the hash join's build, together with the
// reference's radix_partition_permutation, which wraps it in an exclusive
// scan and a scatter.
//
// What it computes: for int32 ids of length cap and a domain of num_lanes
// (at most 4,096),
//   ranks[i]  = #{j < i : ids[j] == ids[i]}, counts[l] = #{i : ids[i] == l}
// (ids outside [0, num_lanes) get rank 0 and are not counted), or, in the
// permutation mode,
//   perm[offset[ids[i]] + ranks[i]] = i  (int64), offset the exclusive scan
//   of counts,
// which is torch.argsort(ids, stable=True) when every id lies inside the
// domain. Rows outside it write no slot: the permutation is defined only for
// ids inside the domain (the partition step gives its padding a lane).
//
// What bounds it: bytes. Ranks read 4 B and write 4 B a row; the permutation
// reads 4 B and writes 8 B a row: 3.75 us per 2^20 rows at 3.35 TB/s. The
// per-block counts (blocks x lanes int32) are scratch that stays in L2.
//
// What the design does about it: the TPU kernel walked its grid in order and
// carried per-lane running counts from step to step. Hopper's blocks run in no
// order, so three kernels take the place of that carry, and the tile no longer
// grows with the domain: a block of 8 warps owns 256 * steps rows, each warp
// 32 * steps of them, where steps is 16 (4,096-row tiles) unless that leaves
// fewer than 256 blocks, and is then halved down to 1 (the wrapper picks it).
// 2^20 rows are 256 blocks whatever the lane count; (16,384 rows, 4,096
// lanes) are 64 blocks whose warps walk 32 rows each.
//  1. radix_count_kernel: each block counts its tile per lane in one
//     shared-memory histogram (at most 16 KB) and writes it to its row of
//     the (blocks, lanes) scratch. Within a warp, the lanes holding one id
//     find each other (same_key: one __ballot_sync per bit of the key, ANDed:
//     13 at 4,096 lanes, 4 at 9; on the card it beat __match_any_sync, whose
//     cost grows with the distinct ids in the warp) and only the lowest of
//     them adds the group's size, so a domain of a few lanes does not
//     serialise 32 atomics on one address.
//  2. radix_scan_kernel: the per-lane exclusive scan over the blocks. A block
//     owns 32 consecutive lanes (one a thread of each warp, so every scratch
//     read is one 128-byte line) and its 8 warps split the blocks into 8
//     runs: each warp sums its run, the warps' sums give each run its start,
//     and each warp walks its run again, leaving each block's base in place
//     and the lane's total in counts. ceil(lanes / 32) blocks, each thread
//     reading at most blocks / 8 rows, 16 loads in flight at a time.
//  3. radix_rank_kernel: each warp counts its own rows again in its own
//     shared-memory histogram of 16-bit counts (two to a 32-bit word, added
//     with 32-bit shared atomics, since two leaders of one step may share a
//     word; a block counts at most 4,096 rows a lane, so no half carries into
//     the other). A per-lane exclusive scan over the 8 warps turns the counts
//     into each warp's start within the block; the block's base per lane sits
//     beside them in 32-bit words, plus, for the permutation, the lane's
//     offset, which the block scans from the lane totals itself (16 lanes a
//     thread), so no torch op and no fourth kernel runs between the ids and
//     the permutation. Each warp then ranks its rows in order with the ids it
//     loaded ahead into registers: same_key finds the lanes holding the same
//     id, a row's rank is base + its warp's running count + the peers below
//     it, and the lowest peer advances the running count. Shared memory:
//     8 * ceil(lanes / 2) * 4 + lanes * 4 bytes, 80 KB at 4,096 lanes, so
//     two blocks fit an SM; above 48 KB it is granted through
//     cudaFuncSetAttribute.
//
// C interface for ctypes: every pointer and the stream are void*. The caller
// picks steps (1..16) and allocates the int32 scratch of ceil(cap / (256 *
// steps)) * lanes + lanes words: the per-block counts, then the lane totals
// of the permutation. counts may be null (the permutation keeps its totals
// in the scratch); exactly one of ranks and perm is not null. The function
// returns the first launch error, else cudaGetLastError() after the last
// launch. The caller names the device, because this library's CUDA runtime
// keeps its own current device.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSteps = 16;  // the most steps of 32 rows a warp walks
constexpr int kRun = 16;  // scratch rows a scan thread loads ahead
constexpr int kMaxLanes = 4096;
constexpr int kLanesPerThread = kMaxLanes / kThreads;  // of the offset scan

// the lanes of the warp whose key equals this lane's: the AND, over the
// key's bits, of the lanes that agree with it on that bit (one ballot a
// bit). Every lane of the warp calls it with the same bits.
__device__ __forceinline__ unsigned same_key(uint32_t key, int bits) {
  unsigned peers = kFull;
  for (int b = 0; b < bits; ++b) {
    const bool on = (key >> b) & 1u;
    const unsigned ones = __ballot_sync(kFull, on);
    peers &= on ? ones : ~ones;
  }
  return peers;
}

__global__ void __launch_bounds__(kThreads)
    radix_count_kernel(const int32_t* __restrict__ ids, int64_t cap,
                       int num_lanes, int bits, int steps,
                       int32_t* __restrict__ block_counts) {
  extern __shared__ int32_t hist[];
  for (int l = threadIdx.x; l < num_lanes; l += kThreads) hist[l] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int64_t row0 =
      (int64_t)blockIdx.x * kThreads * steps + (threadIdx.x - lane);
#pragma unroll 4
  for (int st = 0; st < steps; ++st) {
    const int64_t i = row0 + (int64_t)st * kThreads + lane;
    const int32_t id = i < cap ? __ldg(ids + i) : -1;
    // one unsigned compare drops negative ids and ids >= num_lanes
    const bool inside = i < cap && (uint32_t)id < (uint32_t)num_lanes;
    const unsigned peers = same_key(inside ? id : num_lanes, bits);
    if (inside && (peers & below) == 0u) atomicAdd(hist + id, __popc(peers));
  }
  __syncthreads();
  int32_t* mine = block_counts + (int64_t)blockIdx.x * num_lanes;
  for (int l = threadIdx.x; l < num_lanes; l += kThreads) mine[l] = hist[l];
}

// exclusive scan of one value a thread over the block; every thread calls it
__device__ __forceinline__ int32_t block_exclusive_scan(int32_t x,
                                                        int32_t* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int32_t w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  return (warp > 0 ? warp_sums[warp - 1] : 0) + incl - x;
}

__global__ void __launch_bounds__(kThreads)
    radix_scan_kernel(int32_t* __restrict__ block_counts, int nblocks,
                      int num_lanes, int32_t* __restrict__ counts) {
  __shared__ int32_t part[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int l = blockIdx.x * 32 + lane;
  const bool live = l < num_lanes;
  const int per = (nblocks + kWarps - 1) / kWarps;
  const int b0 = warp * per;
  const int b1 = b0 + per < nblocks ? b0 + per : nblocks;
  // both walks over the run load kRun rows ahead into registers, so that
  // their loads are in flight together
  int32_t s = 0;
  if (live) {
    for (int c0 = b0; c0 < b1; c0 += kRun) {
      int32_t v[kRun];
#pragma unroll
      for (int k = 0; k < kRun; ++k)
        v[k] = c0 + k < b1 ? block_counts[(int64_t)(c0 + k) * num_lanes + l]
                           : 0;
#pragma unroll
      for (int k = 0; k < kRun; ++k) s += v[k];
    }
  }
  part[warp][lane] = s;
  __syncthreads();
  int32_t run = 0;
  for (int w = 0; w < warp; ++w) run += part[w][lane];
  if (live) {
    for (int c0 = b0; c0 < b1; c0 += kRun) {
      int32_t v[kRun];
#pragma unroll
      for (int k = 0; k < kRun; ++k)
        v[k] = c0 + k < b1 ? block_counts[(int64_t)(c0 + k) * num_lanes + l]
                           : 0;
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        if (c0 + k < b1)
          block_counts[(int64_t)(c0 + k) * num_lanes + l] = run;
        run += v[k];
      }
    }
    // runs past nblocks are empty, so the last warp ends at the total
    if (warp == kWarps - 1) counts[l] = run;
  }
}

__device__ __forceinline__ int32_t half_of(uint32_t word, int32_t id) {
  return (int32_t)((word >> ((id & 1) * 16)) & 0xFFFFu);
}

__global__ void __launch_bounds__(kThreads)
    radix_rank_kernel(const int32_t* __restrict__ ids, int64_t cap,
                      int num_lanes, int bits, int steps,
                      const int32_t* __restrict__ block_base,
                      const int32_t* __restrict__ counts,
                      int32_t* __restrict__ ranks,
                      int64_t* __restrict__ perm) {
  extern __shared__ uint32_t smem[];
  __shared__ int32_t warp_sums[kWarps];
  const int words = (num_lanes + 1) >> 1;  // two 16-bit counts a word
  uint32_t* hist = smem;                   // [kWarps][words]
  int32_t* base = (int32_t*)(smem + kWarps * words);  // [num_lanes]
  for (int q = threadIdx.x; q < kWarps * words; q += kThreads) hist[q] = 0u;
  const int32_t* bb = block_base + (int64_t)blockIdx.x * num_lanes;
  if (perm == nullptr) {
    for (int l = threadIdx.x; l < num_lanes; l += kThreads) base[l] = bb[l];
  } else {
    // the lane offsets, the exclusive scan of the lane totals, each thread
    // owning 16 consecutive lanes loaded together
    const int l0 = threadIdx.x * kLanesPerThread;
    int32_t c[kLanesPerThread];
    int32_t mine = 0;
#pragma unroll
    for (int k = 0; k < kLanesPerThread; ++k) {
      c[k] = l0 + k < num_lanes ? counts[l0 + k] : 0;
      mine += c[k];
    }
    int32_t at = block_exclusive_scan(mine, warp_sums);
#pragma unroll
    for (int k = 0; k < kLanesPerThread; ++k) {
      if (l0 + k < num_lanes) base[l0 + k] = bb[l0 + k] + at;
      at += c[k];
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  uint32_t* mine = hist + warp * words;
  const int64_t row0 = ((int64_t)blockIdx.x * kWarps + warp) * steps * 32;
  int32_t ahead[kSteps];
#pragma unroll
  for (int st = 0; st < kSteps; ++st) {
    const int64_t i = row0 + st * 32 + lane;
    ahead[st] = st < steps && i < cap ? __ldg(ids + i) : -1;
  }
  // count this warp's rows; rows outside the domain (and past cap) share the
  // key num_lanes, which no id inside it equals
#pragma unroll
  for (int st = 0; st < kSteps; ++st) {
    if (st >= steps) break;  // the same for the whole warp
    const int64_t i = row0 + st * 32 + lane;
    const int32_t id = ahead[st];
    const bool inside = i < cap && (uint32_t)id < (uint32_t)num_lanes;
    const unsigned peers = same_key(inside ? id : num_lanes, bits);
    if (inside && (peers & below) == 0u)
      atomicAdd(mine + (id >> 1), (uint32_t)__popc(peers) << ((id & 1) * 16));
  }
  __syncthreads();
  // per lane pair, the exclusive scan over the warps: each warp's start
  for (int q = threadIdx.x; q < words; q += kThreads) {
    uint32_t run = 0u;
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t c = hist[w * words + q];
      hist[w * words + q] = run;
      run += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int st = 0; st < kSteps; ++st) {
    if (st >= steps) break;  // the same for the whole warp
    const int64_t i = row0 + st * 32 + lane;
    const int32_t id = ahead[st];
    const bool inside = i < cap && (uint32_t)id < (uint32_t)num_lanes;
    const unsigned peers = same_key(inside ? id : num_lanes, bits);
    int32_t r = 0;
    if (inside)
      r = base[id] + half_of(mine[id >> 1], id) + __popc(peers & below);
    __syncwarp();
    if (inside && (peers & below) == 0u)
      atomicAdd(mine + (id >> 1), (uint32_t)__popc(peers) << ((id & 1) * 16));
    __syncwarp();
    if (perm != nullptr) {
      if (inside) perm[r] = i;
    } else if (i < cap) {
      ranks[i] = r;
    }
  }
}

}  // namespace

extern "C" int radix_launch(int device, const void* ids, long long cap,
                            int num_lanes, int steps, void* scratch,
                            void* counts, void* ranks, void* perm,
                            void* stream) {
  // cudaGetDevice reads this runtime's own state; set only on a change
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return (int)set;
  }
  if ((ranks == nullptr) == (perm == nullptr) || num_lanes < 1 ||
      num_lanes > kMaxLanes || cap < 1 || steps < 1 || steps > kSteps)
    return (int)cudaErrorInvalidValue;
  // key bits: ids inside the domain and the key num_lanes of rows outside
  int bits = 0;
  while ((num_lanes >> bits) != 0) ++bits;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long tile = (long long)kThreads * steps;
  const long long nblocks = (cap + tile - 1) / tile;
  int32_t* block_counts = (int32_t*)scratch;
  int32_t* totals = counts != nullptr ? (int32_t*)counts
                                      : block_counts + nblocks * num_lanes;

  radix_count_kernel<<<(unsigned)nblocks, kThreads,
                       (size_t)num_lanes * sizeof(int32_t), s>>>(
      (const int32_t*)ids, (int64_t)cap, num_lanes, bits, steps,
      block_counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  radix_scan_kernel<<<(unsigned)((num_lanes + 31) / 32), kThreads, 0, s>>>(
      block_counts, (int)nblocks, num_lanes, totals);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t shared = (size_t)kWarps * ((num_lanes + 1) / 2) * 4 +
                        (size_t)num_lanes * 4;
  if (shared > 48 * 1024) {
    err = cudaFuncSetAttribute(radix_rank_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  radix_rank_kernel<<<(unsigned)nblocks, kThreads, shared, s>>>(
      (const int32_t*)ids, (int64_t)cap, num_lanes, bits, steps,
      block_counts, totals, (int32_t*)ranks, (int64_t*)perm);
  return (int)cudaGetLastError();
}
