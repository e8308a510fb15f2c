// Per-code bucket sums of several requests in one launch, in float32, for
// NVIDIA Hopper (sm_90a).
//
// Replaces spark_rapids_tpu/ops/pallas_kernels.py:onehot_sum_f32, the TPU
// kernel behind the dense group-by's count-like reductions (rows per group,
// per-batch counts, the non-null counts of sum and avg). On the TPU each of
// them was its own kernel call; ops/grouping.py:resolve_dense_group_sums
// sends all of one aggregate batch's count-like requests here together.
//
// What it computes: for k requests, each a value column of type bool, int32,
// int64 or float32, or no column (every row counts 1), and an optional bool
// mask, over a batch's int32 codes shared by all of them,
//   out[j, d] = sum of (float)vals_j[i] over the rows i with codes[i] == d
//               and mask_j[i],
// for 0 <= d < n_domain, in float32. Rows whose code lies outside
// [0, n_domain) are dropped; the dense aggregate gives the rows that are
// not live such a code, so the kernel reads no liveness. Sums of 0/1 values
// are exact below 2^24 rows: every partial sum is a whole number below
// 2^24, which float32 holds. onehot_sum_f32 is the one-request call, with
// no mask.
//
// What bounds it: bytes. Each row's code (4 B) is read once, and each
// request's mask (1 B) and value (1-8 B) once; a request whose value is its
// own mask passes no mask and reads 1 B a row, and the rows per group (no
// value column, no mask) read nothing but the codes. The k * n_domain * 4
// output bytes are noise.
//
// What the design does about it (variants measured on an H100; verdicts
// in PERF.md, PR 5):
// - One launch per batch, not per request: the codes are read once for
//   all k requests, values are read in their own type (no
//   cast or masking pass over n rows before the launch), and the request
//   descriptors travel in the kernel's by-value parameter struct (no copy
//   to the card). At most kMaxRequests (16) requests a launch; the wrapper
//   splits a longer list into launches of 16.
// - No two lanes of a warp add to one shared word in one atomic. At small
//   domains (n_domain <= kLaneWords / 32, so 384 buckets) each bucket of
//   each request has 32 shared words, one per lane: lane l adds to word
//   [request][code][l]. PR 1's kernel had one shared word per bucket, and
//   at q1's shape (12 codes, 4 live) a warp's 32 lanes landed on 2-4 words,
//   so each atomic replayed 8-16 times; one word per bucket was several
//   times slower here too. The adds are still shared-memory atomics,
//   because the warps of a block share the lane words, but each warp's
//   atomic touches 32 distinct words in 32 distinct banks. A private column
//   per thread with plain adds (no atomics, 128 threads a block) was
//   slower: its columns cost more to zero and sum than the atomics. At
//   larger domains (up to 12,288) collisions in a warp are rare, and one
//   shared word per bucket keeps the histogram in the block's 48 KB.
// - A bool request or a row count adds 1 with an integer atomic, which the
//   shared-memory unit does natively; a float add is a compare-and-swap
//   loop there. Other types add their value as float32.
// - When the requests' histograms do not fit the 48 KB together, gridDim.y
//   splits the requests into groups that do, and each group reads the codes
//   again (from L2).
// - From 4,096 rows each thread takes 4 consecutive rows a step: one
//   16-byte load of codes, one 4-byte load of each mask, a 4-, 16- or
//   32-byte load of each value column, when every pointer is
//   aligned for it (the launcher checks; otherwise one row a step). Below
//   4,096 rows one row a thread spreads a small batch over more threads.
//   Loading several requests before their adds did not help. Rows whose
//   value is 0 or whose mask is false add nothing.
// - At the end each block sums its 32 lane words per bucket (rotated, so
//   that the threads of a warp read 32 distinct banks) and adds each
//   non-zero bucket into the output with one global atomic. The launch
//   zeroes the output first: one memset a launch. A small input (the 8-row
//   merges) runs one block. Sums of values that are not whole numbers
//   depend on the order of the atomics, which changes from run to run.
//
// C interface for ctypes: every pointer and the stream are void*, the
// requests come as three host arrays of k entries, and the function returns
// cudaGetLastError() after the launch. The caller names the device, because
// this library's CUDA runtime keeps its own current device.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRequests = 16;
// shared words of one block's histograms: 48 KB, the default a block gets
constexpr int kLaneWords = 12288;
constexpr int kThreads = 256;
// rows from which a thread takes 4 a step
constexpr long long kQuadRows = 4096;

// kOne: no value column, every row counts 1 (the rows per group)
enum ValueType : int {
  kBool = 0, kInt32 = 1, kInt64 = 2, kFloat32 = 3, kOne = 4
};

struct Request {
  const void* vals;     // null for kOne
  const uint8_t* mask;  // null: every row
  int type;             // a ValueType
};

struct Batch {
  Request req[kMaxRequests];
};

// the values of rows [row, row + R) of one request as float32; R is 4 (one
// vector load, aligned by the launcher's check) or 1
template <int R>
__device__ __forceinline__ void load_vals(const Request& r, int64_t row,
                                          float (&v)[R]) {
  if (r.type == kOne) {
#pragma unroll
    for (int s = 0; s < R; ++s) v[s] = 1.0f;
  } else if constexpr (R == 4) {
    switch (r.type) {
      case kBool: {
        const uchar4 b = __ldg(reinterpret_cast<const uchar4*>(
            static_cast<const uint8_t*>(r.vals) + row));
        v[0] = b.x != 0; v[1] = b.y != 0; v[2] = b.z != 0; v[3] = b.w != 0;
        break;
      }
      case kInt32: {
        const int4 q = __ldg(reinterpret_cast<const int4*>(
            static_cast<const int32_t*>(r.vals) + row));
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
        break;
      }
      case kInt64: {
        const longlong2* p = reinterpret_cast<const longlong2*>(
            static_cast<const int64_t*>(r.vals) + row);
        const longlong2 a = __ldg(p), b = __ldg(p + 1);
        v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
        break;
      }
      default: {
        const float4 f = __ldg(reinterpret_cast<const float4*>(
            static_cast<const float*>(r.vals) + row));
        v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
      }
    }
  } else {
    switch (r.type) {
      case kBool:
        v[0] = __ldg(static_cast<const uint8_t*>(r.vals) + row) != 0;
        break;
      case kInt32:
        v[0] = __ldg(static_cast<const int32_t*>(r.vals) + row);
        break;
      case kInt64:
        v[0] = __ldg(static_cast<const long long*>(r.vals) + row);
        break;
      default:
        v[0] = __ldg(static_cast<const float*>(r.vals) + row);
    }
  }
}

// R bytes of a bool column at row (4: one aligned 4-byte load), or all true
// for a null column
template <int R>
__device__ __forceinline__ void load_flags(const uint8_t* p, int64_t row,
                                           bool (&f)[R]) {
  if (p == nullptr) {
#pragma unroll
    for (int s = 0; s < R; ++s) f[s] = true;
  } else if constexpr (R == 4) {
    const uchar4 b = __ldg(reinterpret_cast<const uchar4*>(p + row));
    f[0] = b.x != 0; f[1] = b.y != 0; f[2] = b.z != 0; f[3] = b.w != 0;
  } else {
    f[0] = __ldg(p + row) != 0;
  }
}

// adds rows [row, row + R) of requests [j0, j1) into the block's histograms
template <int R, bool kLanes>
__device__ __forceinline__ void add_rows(const Batch& b,
                                         const int32_t* __restrict__ codes,
                                         int64_t row, int n_domain, int j0,
                                         int j1, float* hist, int lane) {
  int c[R];
  if constexpr (R == 4) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(codes + row));
    c[0] = q.x; c[1] = q.y; c[2] = q.z; c[3] = q.w;
  } else {
    c[0] = __ldg(codes + row);
  }
  bool any = false;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    // one unsigned compare drops negative codes and codes >= n_domain
    if ((uint32_t)c[s] >= (uint32_t)n_domain) c[s] = -1;
    any |= c[s] >= 0;
  }
  if (!any) return;
  for (int j = j0; j < j1; ++j) {
    const Request& r = b.req[j];
    bool m[R];
    float v[R];
    load_flags<R>(r.mask, row, m);
    load_vals<R>(r, row, v);
    const int base = (j - j0) * n_domain;
    const bool counts = r.type == kBool || r.type == kOne;
#pragma unroll
    for (int s = 0; s < R; ++s) {
      if (c[s] >= 0 && m[s] && v[s] != 0.0f) {
        float* w = kLanes ? hist + ((base + c[s]) << 5) + lane
                          : hist + base + c[s];
        if (counts)
          atomicAdd(reinterpret_cast<unsigned*>(w), 1u);
        else
          atomicAdd(w, v[s]);
      }
    }
  }
}

template <bool kLanes>
__global__ void __launch_bounds__(kThreads)
    onehot_sums_kernel(const __grid_constant__ Batch b, int k,
                       int per_group, const int32_t* __restrict__ codes,
                       int64_t n,
                       int n_domain, int vec, float* __restrict__ out) {
  extern __shared__ float hist[];
  const int j0 = blockIdx.y * per_group;
  const int j1 = min(k, j0 + per_group);
  const int pairs = (j1 - j0) * n_domain;
  const int words = kLanes ? pairs << 5 : pairs;
  for (int w = threadIdx.x; w < words; w += blockDim.x) hist[w] = 0.0f;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t done = 0;
  if (vec) {
    const int64_t quads = n >> 2;
    for (int64_t q = first; q < quads; q += stride)
      add_rows<4, kLanes>(b, codes, q << 2, n_domain, j0, j1, hist, lane);
    done = quads << 2;
  }
  for (int64_t i = done + first; i < n; i += stride)
    add_rows<1, kLanes>(b, codes, i, n_domain, j0, j1, hist, lane);
  __syncthreads();
  const unsigned* tally = reinterpret_cast<const unsigned*>(hist);
  for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
    const int type = b.req[j0 + p / n_domain].type;
    const bool counts = type == kBool || type == kOne;
    float s;
    if (kLanes) {
      // word (p, (l + p) % 32): the threads of a warp read 32 banks
      if (counts) {
        unsigned t = 0;
#pragma unroll 8
        for (int l = 0; l < 32; ++l) t += tally[(p << 5) + ((l + p) & 31)];
        s = (float)t;
      } else {
        s = 0.0f;
#pragma unroll 8
        for (int l = 0; l < 32; ++l) s += hist[(p << 5) + ((l + p) & 31)];
      }
    } else {
      s = counts ? (float)tally[p] : hist[p];
    }
    if (s != 0.0f) atomicAdd(out + (int64_t)j0 * n_domain + p, s);
  }
}

bool aligned(const void* p, size_t bytes) {
  return p == nullptr || ((uintptr_t)p % bytes) == 0;
}

}  // namespace

extern "C" int onehot_sums_launch(int device, const void* codes,
                                  long long n, int n_domain,
                                  int k, const void* const* vals,
                                  const void* const* masks, const int* types,
                                  void* out, void* stream) {
  if (k < 1 || k > kMaxRequests || n_domain < 1 || n_domain > kLaneWords)
    return (int)cudaErrorInvalidValue;
  // cudaGetDevice reads this runtime's own state; set only on a change
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return (int)set;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  Batch b = {};
  // the 16-byte row quads need every column aligned to 4 of its elements
  bool vec = n >= kQuadRows && aligned(codes, 16);
  for (int j = 0; j < k; ++j) {
    static const size_t kSize[] = {1, 4, 8, 4, 1};
    // only a row count has no value column (an empty one may be null)
    if (types[j] < kBool || types[j] > kOne ||
        (n > 0 && vals[j] == nullptr && types[j] != kOne))
      return (int)cudaErrorInvalidValue;
    b.req[j].vals = vals[j];
    b.req[j].mask = static_cast<const uint8_t*>(masks[j]);
    b.req[j].type = types[j];
    vec = vec && aligned(vals[j], 4 * kSize[types[j]]) &&
          aligned(masks[j], 4);
  }
  const cudaError_t zero =
      cudaMemsetAsync(out, 0, (size_t)k * n_domain * sizeof(float), s);
  if (zero != cudaSuccess) return (int)zero;
  // lane words at small domains, one word a bucket above; as many requests
  // a block as its 48 KB holds, the rest in further rows of the grid
  const bool lanes = n_domain <= kLaneWords / 32;
  const int per_bucket = lanes ? 32 : 1;
  int per_group = kLaneWords / (n_domain * per_bucket);
  if (per_group > k) per_group = k;
  const int groups = (k + per_group - 1) / per_group;
  const size_t smem = (size_t)per_group * n_domain * per_bucket * sizeof(float);
  // one block per 1,024 rows, at most four per SM of an H100 (132 SMs)
  // over all groups: more would only add flush atomics
  long long blocks = (n + 4 * kThreads - 1) / (4 * kThreads);
  const long long most = (132 * 4 + groups - 1) / groups;
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;
  const dim3 grid((unsigned)blocks, (unsigned)groups);
  if (lanes)
    onehot_sums_kernel<true><<<grid, kThreads, smem, s>>>(
        b, k, per_group, (const int32_t*)codes, (int64_t)n, n_domain,
        vec ? 1 : 0, (float*)out);
  else
    onehot_sums_kernel<false><<<grid, kThreads, smem, s>>>(
        b, k, per_group, (const int32_t*)codes, (int64_t)n, n_domain,
        vec ? 1 : 0, (float*)out);
  return (int)cudaGetLastError();
}
