// Hash-table join build and probe over unique fixed-point keys, for NVIDIA
// Hopper (sm_90a).
//
// Replaces spark_rapids_tpu/ops/pallas_kernels.py:hash_join_build and
// hash_join_probe (_hash_probe_kernel), the table of the broadcast hash
// join's "pallas_hash" mode: exec/joins.py:_JoinCore takes it for a unique
// build key whose range is too sparse for the direct-address table, with a
// build of at most 16,384 rows.
//
// The table: num_buckets = 2^h_bits buckets of 8 slots. A key's bucket is
// the top h_bits bits of key * 0x9E3779B97F4A7C15 (mod 2^64, the Fibonacci
// hash); bucket b owns the slots [8*b, 8*b + 8).
//
// ---- Build ----------------------------------------------------------------
//
// What it computes, bit for bit as the reference (which ranks each bucket's
// keys with its radix kernel and scatters them): slot s of a bucket holds
// its eligible row of rank s in ascending row order, with that row's key;
// an empty slot holds key int64 min and row -1. A bucket of more than 8
// eligible rows holds its 7 lowest rows in slots 0-6 and its highest in
// slot 7 (the reference's last write to the clamped rank). ok is false when
// a bucket holds more than 8 eligible rows, or when two slots of a bucket
// hold one key other than int64 min (a duplicate key); the caller then
// discards the table.
//
// What bounds it: bytes, 9 a key in (key and eligibility) and 12 a slot out,
// under a microsecond at 16,384 keys, so in practice the launch latency. The
// reference's route was a radix pass (three launches on the card) and about
// 15 small torch ops around it; this is one launcher call of three device
// ops:
// 1. a memset of the per-bucket counts;
// 2. hash_join_insert_kernel, one thread per key: an eligible key claims a
//    position in its bucket with atomicAdd on the bucket's count and, while
//    the claim is below 8, writes its row to the bucket's 8 staging words.
//    Claims arrive in no order, so the staging is unordered;
// 3. hash_join_finalize_kernel, one warp per bucket. A bucket of at most 8
//    rows: lane t < count holds staged row t, its slot is the number of
//    staged rows below it (8 shuffles; rows are distinct), and lane s < 8
//    takes the row of slot s. An overfull bucket (ok is false already) scans
//    the keys for its members, 32 rows a step with a ballot: upwards until
//    it has its 7 lowest rows (lane s takes the s-th member),
//    downwards until it finds its highest. Only refused builds pay for that.
//    Lane s < 8 then writes slot s, and the 28 key pairs of the bucket are
//    compared with shuffles; a duplicate or an overfull bucket clears ok,
//    which the insert kernel set.
//
// ---- Probe ----------------------------------------------------------------
//
// What it computes: for each int64 stream key k, its bucket is the top h_bits
// bits of k * 0x9E3779B97F4A7C15 (mod 2^64, the Fibonacci hash); the bucket
// owns the 8 slots [8*bucket, 8*bucket + 8) of the table. The output is the
// build row of the highest slot whose key equals k and whose row is >= 0, or
// -1, and whether one was found (the last qualifying slot wins, as in the TPU
// kernel's loop; a unique build has at most one). A slot is occupied when its
// row is >= 0, so an empty slot (key int64 min, row -1) never matches, not
// even a stream key of int64 min; an occupied slot holding int64 min does.
// Validity and liveness of stream rows are the caller's mask.
//
// What bounds it: bytes. Each stream row reads its 8-byte key once and
// writes a 4-byte row and a 1-byte flag; the table (8 * H slots of 8 + 4
// bytes, at most 384 KB at H = 4,096) is read once: n*13 + 96*H bytes over
// the card's memory rate.
//
// What held the first design back: it gave each stream row one thread, which
// read its bucket's 8 keys and 8 rows with six 16-byte loads. Each such warp
// load touches 32 different buckets, so the L1 serves it as about 32
// requests ("wavefronts"): about six per row, hits or misses, which at 2^20
// rows over 132 SMs is the ~23 us it took, five times its bytes bound. Where
// the table lives did not matter (a 12 KB table was barely faster).
//
// The design: a warp probes cooperatively. It loads 32 stream keys with one
// coalesced load and hands them out by __shfl_sync to groups of 4 lanes, one
// key a group a step (4 steps for the warp's 32 keys). A lane of a group
// reads two consecutive slot keys of that key's bucket in one 16-byte load,
// so one warp load touches 8 bucket lines, not 32: about one L1 request a
// row. Only a lane whose slot key equals the stream key reads that slot's
// row, so a miss reads no row. A ballot gives every lane the group's
// qualifying slots; the lane that owns the key takes the highest one's row
// with one shuffle, so pos (int32) and found (bool) are stored coalesced.
// The steps run in phases (every step's shuffles, then every step's slot-key
// loads, then its row loads, then its ballots), so that a phase's loads are
// in flight together: with one step after another a warp waited out each
// step's two dependent loads, which made small batches slower than the
// first design. The grid is the SM count times the blocks an SM holds (from
// the occupancy calculator), and a grid-stride loop takes the rest. Groups
// of 8 lanes, more keys a lane in flight and a shared-memory table were
// measured against it and lost (PERF.md section 6). It is about 1.6-1.9x
// faster than the first design at 2^20 rows; what remains is not requests
// alone.
//
// C interface for ctypes: every pointer and the stream are void*. The caller
// passes 16-byte aligned tables and h_bits in [7, 12], and each function
// returns cudaGetLastError() after its launches. The caller names the
// device, because this library's CUDA runtime keeps its own current device.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kSlots = 8;
constexpr uint64_t kFibonacci = 0x9E3779B97F4A7C15ull;
constexpr long long kEmpty = (long long)0x8000000000000000ull;  // int64 min
constexpr unsigned kFull = 0xFFFFFFFFu;

// unsigned arithmetic: the product wraps mod 2^64 and the shift is logical,
// as the TPU kernel's shift_right_logical
__device__ __forceinline__ uint32_t bucket_of(long long key, int h_bits) {
  return (uint32_t)(((uint64_t)key * kFibonacci) >> (64 - h_bits));
}

__global__ void hash_join_insert_kernel(const long long* __restrict__ keys,
                                        const uint8_t* __restrict__ eligible,
                                        int64_t n, int h_bits,
                                        int32_t* __restrict__ counts,
                                        int32_t* __restrict__ staging,
                                        bool* __restrict__ ok) {
  if (blockIdx.x == 0 && threadIdx.x == 0) *ok = true;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (!__ldg(eligible + i)) continue;
    const uint32_t b = bucket_of(__ldg(keys + i), h_bits);
    const int32_t claim = atomicAdd(counts + b, 1);
    if (claim < kSlots) staging[b * kSlots + claim] = (int32_t)i;
  }
}

__global__ void hash_join_finalize_kernel(
    const long long* __restrict__ keys, const uint8_t* __restrict__ eligible,
    int64_t n, int h_bits, int num_buckets,
    const int32_t* __restrict__ counts, const int32_t* __restrict__ staging,
    long long* __restrict__ table_keys, int32_t* __restrict__ table_rows,
    bool* __restrict__ ok) {
  // blockDim is a multiple of 32, so a warp leaves or stays as a whole
  const int b = (int)(((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  if (b >= num_buckets) return;
  const int lane = threadIdx.x & 31;
  const int count = counts[b];
  int32_t row = -1;  // lane s < 8: the row of slot s
  if (count <= kSlots) {
    const int32_t mine = lane < count ? staging[b * kSlots + lane] : 0;
    int slot = 0;
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int32_t other = __shfl_sync(kFull, mine, t);
      slot += t < count && other < mine;
    }
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int32_t rt = __shfl_sync(kFull, mine, t);
      const int st = __shfl_sync(kFull, slot, t);
      if (t < count && st == lane) row = rt;
    }
  } else {
    // the 7 lowest members, in row order, 32 rows a step
    int found = 0;
    for (int64_t base = 0; base < n && found < kSlots - 1; base += 32) {
      const int64_t i = base + lane;
      const bool member = i < n && __ldg(eligible + i) &&
                          bucket_of(__ldg(keys + i), h_bits) == (uint32_t)b;
      const unsigned bal = __ballot_sync(kFull, member);
      const int want = lane - found;  // lane s takes member s overall
      if (lane < kSlots - 1 && want >= 0 && want < __popc(bal)) {
        unsigned rest = bal;
        for (int t = 0; t < want; ++t) rest &= rest - 1;  // drop lower ones
        row = (int32_t)(base + __ffs(rest) - 1);
      }
      found += __popc(bal);
    }
    // the highest member, 32 rows a step from the top
    for (int64_t top = n; top > 0; top -= 32) {
      const int64_t i = top - 32 + lane;
      const bool member = i >= 0 && __ldg(eligible + i) &&
                          bucket_of(__ldg(keys + i), h_bits) == (uint32_t)b;
      const unsigned bal = __ballot_sync(kFull, member);
      if (bal) {
        if (lane == kSlots - 1) row = (int32_t)(top - 32 + 31 - __clz(bal));
        break;
      }
    }
  }
  const long long key = row >= 0 ? __ldg(keys + row) : kEmpty;
  bool dup = false;
#pragma unroll
  for (int t = 1; t < kSlots; ++t) {
    const long long kt = __shfl_sync(kFull, key, t);
    dup |= lane < t && kt == key && key != kEmpty;
  }
  if (lane < kSlots) {
    table_keys[b * kSlots + lane] = key;
    table_rows[b * kSlots + lane] = row;
  }
  if (__any_sync(kFull, dup) || count > kSlots) {
    if (lane == 0) *ok = false;
  }
}

constexpr int kProbeThreads = 256;

// four lanes a key, two slots a lane: a warp probes 8 keys a step and its 32
// keys in 4 steps
__global__ void __launch_bounds__(kProbeThreads)
    hash_join_probe_kernel(const long long* __restrict__ table_keys,
                           const int32_t* __restrict__ table_rows,
                           const long long* __restrict__ stream, int64_t n,
                           int h_bits, int32_t* __restrict__ pos,
                           bool* __restrict__ found) {
  const int lane = threadIdx.x & 31;
  const int group = lane >> 2;       // this lane probes key step * 8 + group
  const int slot0 = (lane & 3) * 2;  // ... at slots slot0 and slot0 + 1
  // this lane's own key is probed by group lane % 8 in step lane / 8
  const int owner = lane & 7;
  const int owner_step = lane >> 3;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t base = warp * 32; base < n; base += warps * 32) {
    const int64_t i = base + lane;
    const long long mine = i < n ? __ldg(stream + i) : 0;  // the tail probes 0
    // the 4 steps go in phases, so that each phase's loads are in flight
    // together: the keys and slots of every step, then every step's slot
    // keys, then the rows of matching slots, then the ballots
    long long key[4];
    int slot[4];  // < 8 * 4,096
#pragma unroll
    for (int step = 0; step < 4; ++step) {
      key[step] = __shfl_sync(kFull, mine, step * 8 + group);
      slot[step] = (int)bucket_of(key[step], h_bits) * kSlots + slot0;
    }
    longlong2 tk[4];
#pragma unroll
    for (int step = 0; step < 4; ++step)
      tk[step] =
          __ldg(reinterpret_cast<const longlong2*>(table_keys + slot[step]));
    // the row of this lane's higher qualifying slot, or -1: only a slot
    // whose key matches has its row read
    int32_t row[4];
#pragma unroll
    for (int step = 0; step < 4; ++step) {
      const int32_t r0 = tk[step].x == key[step]
                             ? __ldg(table_rows + slot[step]) : -1;
      const int32_t r1 = tk[step].y == key[step]
                             ? __ldg(table_rows + slot[step] + 1) : -1;
      row[step] = r1 >= 0 ? r1 : (r0 >= 0 ? r0 : -1);
    }
    int32_t got = -1;
#pragma unroll
    for (int step = 0; step < 4; ++step) {
      // lanes of a group hold ascending slots: the group's highest lane
      // with a qualifying slot holds the highest qualifying slot
      const unsigned hits =
          (__ballot_sync(kFull, row[step] >= 0) >> (owner * 4)) & 0xFu;
      const int winner = hits ? owner * 4 + 31 - __clz(hits) : lane;
      const int32_t won = __shfl_sync(kFull, row[step], winner);
      if (owner_step == step && hits) got = won;
    }
    if (i < n) {
      pos[i] = got;
      found[i] = got >= 0;
    }
  }
}

// cudaGetDevice reads this runtime's own state; set only on a change
int select_device(int device) {
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return (int)set;
  }
  return 0;
}

// blocks of hash_join_probe_kernel that fill the card: the SM count times
// the blocks an SM holds at its register use, read once (the cards of one
// host are of one model). Returns a CUDA error, or 0 and the count.
int probe_grid_cap(int device, long long* blocks) {
  static std::atomic<int> cap{0};
  int c = cap.load(std::memory_order_relaxed);
  if (c == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, hash_join_probe_kernel, kProbeThreads, 0);
    if (err != cudaSuccess) return (int)err;
    c = sms * (per_sm > 0 ? per_sm : 1);
    cap.store(c, std::memory_order_relaxed);
  }
  *blocks = c;
  return 0;
}

}  // namespace

extern "C" int hash_join_probe_launch(int device, const void* table_keys,
                                      const void* table_rows,
                                      const void* stream_keys, long long n,
                                      int h_bits, void* pos, void* found,
                                      void* stream) {
  long long cap = 0;
  int err = select_device(device);
  if (err == 0) err = probe_grid_cap(device, &cap);
  if (err != 0) return err;
  // one warp takes 32 keys a loop step
  long long blocks = (n + kProbeThreads - 1) / kProbeThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > cap) blocks = cap;
  hash_join_probe_kernel<<<(unsigned)blocks, kProbeThreads, 0,
                           (cudaStream_t)stream>>>(
      (const long long*)table_keys, (const int32_t*)table_rows,
      (const long long*)stream_keys, (int64_t)n, h_bits, (int32_t*)pos,
      (bool*)found);
  return (int)cudaGetLastError();
}

extern "C" int hash_join_build_launch(int device, const void* keys,
                                      const void* eligible, long long n,
                                      int h_bits, void* counts, void* staging,
                                      void* table_keys, void* table_rows,
                                      void* ok, void* stream) {
  const int set = select_device(device);
  if (set != 0) return set;
  const cudaStream_t s = (cudaStream_t)stream;
  const int num_buckets = 1 << h_bits;
  const cudaError_t zero =
      cudaMemsetAsync(counts, 0, (size_t)num_buckets * sizeof(int32_t), s);
  if (zero != cudaSuccess) return (int)zero;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 8) blocks = 132 * 8;
  hash_join_insert_kernel<<<(unsigned)blocks, threads, 0, s>>>(
      (const long long*)keys, (const uint8_t*)eligible, (int64_t)n, h_bits,
      (int32_t*)counts, (int32_t*)staging, (bool*)ok);
  // one warp a bucket, 8 warps a block: num_buckets / 8 blocks (>= 16)
  hash_join_finalize_kernel<<<(unsigned)(num_buckets / 8), threads, 0, s>>>(
      (const long long*)keys, (const uint8_t*)eligible, (int64_t)n, h_bits,
      num_buckets, (const int32_t*)counts, (const int32_t*)staging,
      (long long*)table_keys, (int32_t*)table_rows, (bool*)ok);
  return (int)cudaGetLastError();
}
