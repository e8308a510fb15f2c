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
// build row of the slot whose key equals k, or -1, and whether one was found.
// A slot is occupied when its row is >= 0, so an empty slot (key int64 min,
// row -1) never matches, not even a stream key of int64 min. Validity and
// liveness of stream rows are the caller's mask.
//
// What bounds it: bytes. Each stream row reads its 8-byte key once and
// writes a 4-byte row and a 1-byte flag; the table (8 * H slots of 8 + 4
// bytes, at most 384 KB at H = 4,096) is read once: n*13 + 96*H bytes over
// the card's memory rate.
//
// What the design does about it: the TPU kernel kept the whole table in VMEM
// and unrolled the slot loop over static columns, because a per-row gather
// was the only dynamic access it could afford. On Hopper one thread takes
// one stream row: its key load is coalesced, and its bucket's 8 keys are one
// aligned 64-byte line (four 16-byte loads) and its 8 rows one 32-byte
// sector (two 16-byte loads), read through the read-only cache. The table is
// at most 384 KB, so after the first touches it is served from the 50 MB L2;
// staging it in shared memory is left for a later version. The 8 compares
// are unrolled and branch-free; the last matching slot wins, as in the TPU
// kernel's loop (a unique build has at most one).
//
// C interface for ctypes: every pointer and the stream are void*. The caller
// passes 16-byte aligned tables and h_bits in [7, 12], and each function
// returns cudaGetLastError() after its launches. The caller names the
// device, because this library's CUDA runtime keeps its own current device.

#include <cuda_runtime.h>
#include <stdint.h>

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

__global__ void hash_join_probe_kernel(const int64_t* __restrict__ table_keys,
                                       const int32_t* __restrict__ table_rows,
                                       const int64_t* __restrict__ stream,
                                       int64_t n, int h_bits,
                                       int32_t* __restrict__ pos,
                                       bool* __restrict__ found) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t key = __ldg(stream + i);
    const uint64_t bucket = bucket_of(key, h_bits);
    const longlong2* k2 =
        reinterpret_cast<const longlong2*>(table_keys + bucket * kSlots);
    const int4* r4 = reinterpret_cast<const int4*>(table_rows + bucket * kSlots);
    const longlong2 ka = __ldg(k2), kb = __ldg(k2 + 1), kc = __ldg(k2 + 2),
                    kd = __ldg(k2 + 3);
    const int4 ra = __ldg(r4), rb = __ldg(r4 + 1);
    const long long keys[kSlots] = {ka.x, ka.y, kb.x, kb.y,
                                    kc.x, kc.y, kd.x, kd.y};
    const int32_t rows[kSlots] = {ra.x, ra.y, ra.z, ra.w,
                                  rb.x, rb.y, rb.z, rb.w};
    int32_t p = -1;
    bool f = false;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const bool hit = keys[s] == key && rows[s] >= 0;
      p = hit ? rows[s] : p;
      f = f || hit;
    }
    pos[i] = p;
    found[i] = f;
  }
}

}  // namespace

extern "C" int hash_join_probe_launch(int device, const void* table_keys,
                                      const void* table_rows,
                                      const void* stream_keys, long long n,
                                      int h_bits, void* pos, void* found,
                                      void* stream) {
  // cudaGetDevice reads this runtime's own state; set only on a change
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return (int)set;
  }
  const int threads = 256;
  // eight blocks of 256 threads per SM of an H100 (132 SMs) fill the card;
  // past that the grid-stride loop takes the rest
  long long blocks = (n + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 8) blocks = 132 * 8;
  hash_join_probe_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
      (const int64_t*)table_keys, (const int32_t*)table_rows,
      (const int64_t*)stream_keys, (int64_t)n, h_bits, (int32_t*)pos,
      (bool*)found);
  return (int)cudaGetLastError();
}

extern "C" int hash_join_build_launch(int device, const void* keys,
                                      const void* eligible, long long n,
                                      int h_bits, void* counts, void* staging,
                                      void* table_keys, void* table_rows,
                                      void* ok, void* stream) {
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return (int)set;
  }
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
