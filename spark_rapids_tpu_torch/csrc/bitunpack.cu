// Parquet bit-unpack for NVIDIA Hopper (sm_90a).
//
// Replaces spark_rapids_tpu/ops/pallas_kernels.py:bitunpack128, the TPU kernel
// that unpacks the bit-packed dictionary indices of every RLE_DICTIONARY data
// page the parquet scan decodes (ops/parquet_decode.py calls it).
//
// What it computes: out[i] = bits [i*bw, (i+1)*bw) of the little-endian packed
// word stream for i < n, and 0 for n <= i < capacity; 1 <= bw <= 32. Words past
// the end of the buffer read as 0. A buffer longer than the values need is
// never read past what they need, which is the Pallas kernel's truncation rule.
//
// What bounds it: bytes. It does one shift, one or two loads and one mask per
// value, so it moves n*bw/8 bytes in and 4*capacity bytes out and does almost
// no arithmetic. The least time is that byte count over the card's memory rate.
//
// What the design does about it: one thread per output value, so a warp's
// stores are 128 contiguous bytes and fully coalesced. A warp's loads cover
// 32*bw contiguous bits, so up to 32/bw neighbouring threads read the same word;
// those repeats hit L1 and each packed byte comes from device memory once. No
// shared-memory staging: a value needs at most two adjacent words, and the
// read-only cache already serves them. The TPU kernel unrolled 128 static
// columns per row of 4*bw words because Mosaic lowers gathers badly; Hopper
// does per-thread addressing natively, so none of that blocking carries over.
//
// C interface for ctypes: every pointer and the stream are void*, and the
// function returns cudaGetLastError() after the launch. The caller names the
// device, because this library's CUDA runtime keeps its own current device.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void bitunpack_kernel(const uint32_t* __restrict__ words,
                                 int64_t n_words, int bw, int64_t n,
                                 int64_t capacity, int32_t* __restrict__ out) {
  // shifting a 32-bit value by 32 is undefined: build the full mask directly
  const uint32_t mask = bw == 32 ? 0xFFFFFFFFu : ((1u << bw) - 1u);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < capacity; i += stride) {
    uint32_t v = 0u;
    if (i < n) {
      const int64_t off = i * (int64_t)bw;
      const int64_t w0 = off >> 5;
      const uint32_t sh = (uint32_t)(off & 31);
      const uint32_t lo = w0 < n_words ? __ldg(words + w0) : 0u;
      v = lo >> sh;
      // spans two words only when sh + bw > 32, so sh >= 1 and the left
      // shift below is by 1..31; at bw == 32 a value never spans
      if (sh + (uint32_t)bw > 32u) {
        const uint32_t hi = w0 + 1 < n_words ? __ldg(words + w0 + 1) : 0u;
        v |= hi << (32u - sh);
      }
      v &= mask;
    }
    out[i] = (int32_t)v;
  }
}

}  // namespace

extern "C" int bitunpack128_launch(int device, const void* words,
                                   long long n_words, int bit_width,
                                   long long n, long long capacity, void* out,
                                   void* stream) {
  // cudaGetDevice reads this runtime's own state; set only on a change
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return (int)set;
  }
  const int threads = 256;
  long long blocks = (capacity + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride covers the rest
  bitunpack_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (int64_t)n_words, bit_width, (int64_t)n,
      (int64_t)capacity, (int32_t*)out);
  return (int)cudaGetLastError();
}
