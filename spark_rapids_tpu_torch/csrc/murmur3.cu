// Spark's Murmur3_x86_32.hashUnsafeBytes per row, for NVIDIA Hopper (sm_90a).
//
// Replaces spark_rapids_tpu/ops/pallas_kernels.py:murmur3_words, the TPU
// kernel behind every string key of a hash exchange:
// shuffle/partitioning.py:murmur3_row_hash -> ops/hashing.py:hash_string_words.
//
// What it computes: for each row i, starting from seed[i] (or one scalar
// seed), mix the row's min(len/4, W) whole little-endian words, then each of
// its len%4 tail bytes as a signed Java byte, taken from word len/4 (read as
// 0 when that is past the row: a row of exactly 4W bytes has no tail word),
// then fmix with the length. len/4 and len%4 are floor division and the
// non-negative remainder, as the reference computes them.
//
// What bounds it: bytes. A row reads W words, its length and its seed and
// writes one hash: (4W + 12) bytes, against a few dozen integer operations,
// so the least time is (4W + 12) * n bytes over the card's memory rate.
//
// What the design does about it: the TPU kernel unrolled W columns and
// picked the tail word with W static selects, because a per-row gather does
// not vectorise on the TPU's vector unit. On Hopper each thread takes one
// row, loops over its own whole words and reads its tail word directly;
// neighbouring threads read neighbouring rows, so for W = 1 (the common
// one-word flags and codes) the loads coalesce fully. All arithmetic is in
// uint32_t, whose overflow wraps by definition (int32 overflow would not).
//
// C interface for ctypes: every pointer and the stream are void*; seeds may
// be null, and then every row starts from `seed`. The function returns
// cudaGetLastError() after the launch. The caller names the device, because
// this library's CUDA runtime keeps its own current device.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kC1 = 0xcc9e2d51u;
constexpr uint32_t kC2 = 0x1b873593u;
constexpr uint32_t kM5 = 0xe6546b64u;
constexpr uint32_t kFx1 = 0x85ebca6bu;
constexpr uint32_t kFx2 = 0xc2b2ae35u;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mix_k1(uint32_t k1) {
  return rotl32(k1 * kC1, 15) * kC2;
}

__device__ __forceinline__ uint32_t mix_h1(uint32_t h1, uint32_t k1) {
  return rotl32(h1 ^ k1, 13) * 5u + kM5;
}

__device__ __forceinline__ uint32_t fmix(uint32_t h1, uint32_t length) {
  h1 ^= length;
  h1 ^= h1 >> 16;
  h1 *= kFx1;
  h1 ^= h1 >> 13;
  h1 *= kFx2;
  h1 ^= h1 >> 16;
  return h1;
}

__global__ void murmur3_words_kernel(const int32_t* __restrict__ words,
                                     const int32_t* __restrict__ lengths,
                                     const int32_t* __restrict__ seeds,
                                     int32_t seed, int64_t n, int W,
                                     int32_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int32_t len = __ldg(lengths + i);
    uint32_t h1 = (uint32_t)(seeds != nullptr ? __ldg(seeds + i) : seed);
    // an arithmetic shift and a mask: floor division and the non-negative
    // remainder, also for a negative length
    const int32_t n_words = len >> 2;
    const int32_t n_tail = len & 3;
    const int32_t* row = words + i * (int64_t)W;
    const int32_t whole = n_words < W ? n_words : W;
    for (int32_t j = 0; j < whole; ++j)
      h1 = mix_h1(h1, mix_k1((uint32_t)__ldg(row + j)));
    const uint32_t tail =
        (n_words >= 0 && n_words < W) ? (uint32_t)__ldg(row + n_words) : 0u;
    for (int32_t t = 0; t < n_tail; ++t) {
      const uint32_t b = (tail >> (8 * t)) & 0xFFu;
      // (uint32_t)(int32_t)(int8_t)b, the signed Java byte, without an
      // implementation-defined narrowing: flip the sign bit, subtract 128
      const uint32_t sbyte = (uint32_t)((int32_t)(b ^ 0x80u) - 0x80);
      h1 = mix_h1(h1, mix_k1(sbyte));
    }
    out[i] = (int32_t)fmix(h1, (uint32_t)len);
  }
}

}  // namespace

extern "C" int murmur3_words_launch(int device, const void* words,
                                    const void* lengths, const void* seeds,
                                    int seed, long long n, int W, void* out,
                                    void* stream) {
  // cudaGetDevice reads this runtime's own state; set only on a change
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return (int)set;
  }
  const int threads = 256;
  // sixteen blocks of 256 threads per SM of an H100 (132 SMs) fill it; a
  // longer input walks the grid-stride loop
  long long blocks = (n + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;
  murmur3_words_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)words, (const int32_t*)lengths, (const int32_t*)seeds,
      (int32_t)seed, (int64_t)n, W, (int32_t*)out);
  return (int)cudaGetLastError();
}
