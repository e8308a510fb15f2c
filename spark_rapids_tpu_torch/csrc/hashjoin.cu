// Hash-table join probe over unique fixed-point keys, for NVIDIA Hopper
// (sm_90a).
//
// Replaces spark_rapids_tpu/ops/pallas_kernels.py:hash_join_probe
// (_hash_probe_kernel), the probe of the broadcast hash join's "pallas_hash"
// mode: exec/joins.py:_JoinCore takes it for a unique build key whose range is
// too sparse for the direct-address table, with a build of at most 16,384
// rows. The table comes from ops/cuda_kernels.py:hash_join_build (plain torch
// around the radix_ranks kernel, as the reference builds it).
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
// passes 16-byte aligned tables and h_bits in [7, 12], and the function
// returns cudaGetLastError() after the launch. The caller names the device,
// because this library's CUDA runtime keeps its own current device.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 8;
constexpr uint64_t kFibonacci = 0x9E3779B97F4A7C15ull;

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
    // unsigned arithmetic: the product wraps mod 2^64 and the shift is
    // logical, as the TPU kernel's shift_right_logical
    const uint64_t bucket = ((uint64_t)key * kFibonacci) >> (64 - h_bits);
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
