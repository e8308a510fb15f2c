// Per-code bucket sums in float32 for NVIDIA Hopper (sm_90a).
//
// Replaces spark_rapids_tpu/ops/pallas_kernels.py:onehot_sum_f32, the TPU
// kernel behind the dense group-by's count-like reductions (rows per group,
// per-batch counts, the non-null counts of sum and avg), which
// ops/grouping.py:dense_group_sum sends there.
//
// What it computes: out[d] = sum of vals[i] over the rows i with codes[i] == d,
// for 0 <= d < n_domain, in float32. Rows whose code lies outside
// [0, n_domain) are dropped. Counts of 0/1 values are exact below 2^24 rows.
//
// What bounds it: bytes. Each row is one 4-byte code and one 4-byte value read
// once and one add, so the least time is 8*n bytes over the card's memory rate
// (the n_domain*4 output bytes are noise).
//
// What the design does about it: the TPU kernel built each (rows, 128) one-hot
// tile in VMEM and fed the matrix unit, so a row streamed once per 128 domain
// lanes. Hopper needs no one-hot at all: each block keeps a histogram of
// n_domain floats in shared memory, walks its rows with a grid-stride loop
// (coalesced 4-byte loads, each row read once) and adds each row's value to
// its bucket with a shared-memory atomic. At the end each block adds its
// histogram into the output with one global atomic per bucket, so device
// memory sees n_domain atomics per block instead of one per row. The launch
// zeroes the output on the stream first. Sums of values that are not whole
// numbers depend on the order of the atomics, which changes from run to run.
//
// C interface for ctypes: every pointer and the stream are void*, and the
// function returns cudaGetLastError() after the launch. The caller names the
// device, because this library's CUDA runtime keeps its own current device.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void onehot_sum_kernel(const float* __restrict__ vals,
                                  const int32_t* __restrict__ codes, int64_t n,
                                  int n_domain, float* __restrict__ out) {
  extern __shared__ float hist[];
  for (int d = threadIdx.x; d < n_domain; d += blockDim.x) hist[d] = 0.0f;
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int32_t c = __ldg(codes + i);
    // one unsigned compare drops negative codes and codes >= n_domain
    if ((uint32_t)c < (uint32_t)n_domain) atomicAdd(hist + c, __ldg(vals + i));
  }
  __syncthreads();
  for (int d = threadIdx.x; d < n_domain; d += blockDim.x)
    atomicAdd(out + d, hist[d]);
}

}  // namespace

extern "C" int onehot_sum_f32_launch(int device, const void* vals,
                                     const void* codes, long long n,
                                     int n_domain, void* out, void* stream) {
  // cudaGetDevice reads this runtime's own state; set only on a change
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return (int)set;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t zero =
      cudaMemsetAsync(out, 0, (size_t)n_domain * sizeof(float), s);
  if (zero != cudaSuccess) return (int)zero;
  const int threads = 256;
  // four blocks per SM of an H100 (132 SMs) fill the card; more would only
  // add flush atomics
  long long blocks = (n + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 4) blocks = 132 * 4;
  onehot_sum_kernel<<<(unsigned)blocks, threads,
                      (size_t)n_domain * sizeof(float), s>>>(
      (const float*)vals, (const int32_t*)codes, (int64_t)n, n_domain,
      (float*)out);
  return (int)cudaGetLastError();
}
