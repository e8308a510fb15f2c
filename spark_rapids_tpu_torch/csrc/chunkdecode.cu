// Fused parquet dictionary-chunk decode for NVIDIA Hopper (sm_90a).
//
// Replaces spark_rapids_tpu/ops/pallas_kernels.py:bitunpack128, the TPU kernel
// that unpacks the bit-packed dictionary indices of every RLE_DICTIONARY data
// page the parquet scan decodes, together with the per-page device work the
// reference runs around it (io/parquet_native.py:chunk_to_device): the
// dictionary gather, the spread of present values over the null layout, the
// concatenation of the pages and the canonical nulls.
//
// What it computes: one column chunk of P pages, in one launch. Page p holds
// rows [row_off, row_off + row_count) of the chunk; its n_present dictionary
// indices are bit_width bits each (1..32; 32 is the identity, which carries
// indices the host decoded from RLE runs) in words [word_off, word_off +
// n_words) of the chunk's word stream, little-endian, reading 0 past its
// n_words. For row j < n_rows of page p:
//   valid = has_nulls ? defs[j] : 1
//   rank  = has_nulls ? (present rows of the chunk before j) - present_before
//                     : j - row_off
//   idx   = rank < n_present ? bits [rank * bw, (rank + 1) * bw) : 0
//   value = valid ? dict[clamp((int32)idx, 0, nd - 1)] (0 when nd == 0)
//                 : default
// and rows n_rows <= j < capacity take the default and are not valid. With no
// dictionary the value is idx itself (int32): that is bitunpack128, a chunk of
// one page whose rows are all valid. Values are 1, 2, 4 or 8 bytes, copied as
// raw bits, so the dictionary arrives already in the column's type.
//
// What bounds it: bytes. Each row reads bw/8 packed bytes (plus one def byte
// when the chunk has nulls) and writes its value and its validity byte; the
// dictionary and the page table are read once (they stay in L1 and L2). The
// least time is (packed + defs + dictionary + (value size + 1) * capacity)
// bytes over the card's memory rate.
//
// What the design does about it:
//  - one launch per chunk instead of one per page plus ~10 small torch ops
//    and two host-to-device copies per page: the host packs every page's
//    index words, the page table, the def levels (only when some page has
//    nulls) and the dictionary into one buffer that crosses once;
//  - a chunk without nulls (every TPC-H column) needs no scan: a row's rank
//    is its place in its page. A block decodes 512 rows, 2 a thread (rows
//    t and t + 256) with their loads in flight together, over a grid of
//    capacity / 512 blocks, enough to hide each row's chain of
//    dependent loads (page, words, dictionary entry). Thread 0 finds the
//    page of the block's first row by binary search over the page table
//    (read through the read-only cache), and each row walks on from it.
//    Stores of values and validity are coalesced;
//  - with nulls, a block owns a tile of 4,096 consecutive rows (256
//    threads, 16 rows each; thread t decodes rows t, t + 256, ...), and the
//    present rank of a row in a page with nulls is a block scan: each
//    thread counts the def bytes of its 16 rows (kept in shared memory), a
//    warp-shuffle scan gives each thread its base, and a row adds the set
//    bytes before it among its owner's 16 (two 64-bit popcounts). The
//    tile's own base is present_before of the page holding the tile's first
//    row plus the def bytes of that page before the tile, summed by the
//    block; every TPC-H column has no nulls and skips all of this;
//  - the unpack is the arithmetic of the single-page kernel it replaces
//    (one or two 32-bit words, a shift and a mask), so a warp's 32 rows read
//    32 * bw contiguous bits.
//
// C interface for ctypes: every pointer and the stream are void*, and the
// function returns cudaGetLastError() after the launch. A null page table
// means one page given by value (rows 0..row_count, words from 0, no nulls
// unless has_nulls). The caller names the device, because this library's
// CUDA runtime keeps its own current device.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kRowsPerThread = 16;
constexpr int kTile = kThreads * kRowsPerThread;  // rows a block owns
constexpr int kWarps = kThreads / 32;
constexpr int kFlatRows = 2 * kThreads;  // rows a block owns without nulls

// one page of the chunk: eight int32, in the order ops/cuda_kernels.py
// (PAGE_FIELDS) packs them; 32 bytes, two 16-byte loads
struct __align__(16) Page {
  int32_t row_off, row_count, word_off, n_words, bit_width, n_present,
      present_before, has_nulls;
};

struct Args {
  const Page* pages;  // null: the single page `one`
  int num_pages;
  Page one;
  const uint32_t* words;
  const uint8_t* defs;  // 0/1 per chunk row; null when no page has nulls
  const void* dict;     // null: the value is the unpacked index
  int32_t nd;
  int64_t n_rows, capacity;
  uint64_t default_bits;
  void* values;
  uint8_t* valid;  // null: validity is not written
};

template <int B> struct Bits;
template <> struct Bits<1> { using T = uint8_t; };
template <> struct Bits<2> { using T = uint16_t; };
template <> struct Bits<4> { using T = uint32_t; };
template <> struct Bits<8> { using T = unsigned long long; };

__device__ __forceinline__ Page page_at(const Args& a, int p) {
  return a.pages == nullptr ? a.one : a.pages[p];
}

// the last page whose first row is <= j
__device__ __forceinline__ int find_page(const Args& a, int64_t j) {
  if (a.pages == nullptr) return 0;
  int lo = 0, hi = a.num_pages - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(&a.pages[mid].row_off) <= j) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ uint32_t unpack(const uint32_t* __restrict__ w,
                                           int32_t n_words, int bw,
                                           int64_t i) {
  // shifting a 32-bit value by 32 is undefined: build the full mask directly
  const uint32_t mask = bw >= 32 ? 0xFFFFFFFFu : ((1u << bw) - 1u);
  const int64_t off = i * (int64_t)bw;
  const int64_t w0 = off >> 5;
  const uint32_t sh = (uint32_t)(off & 31);
  uint32_t v = w0 < n_words ? __ldg(w + w0) >> sh : 0u;
  // spans two words only when sh + bw > 32, so sh >= 1 and the left shift
  // below is by 1..31; at bw == 32 a value never spans
  if (sh + (uint32_t)bw > 32u) {
    const uint32_t hi = w0 + 1 < n_words ? __ldg(w + w0 + 1) : 0u;
    v |= hi << (32u - sh);
  }
  return v & mask;
}

// exclusive scan of one value a thread over the block; *total gets the sum.
// Every thread of the block must call it.
__device__ __forceinline__ int32_t block_exclusive_scan(int32_t x,
                                                        int32_t* warp_sums,
                                                        int32_t* total) {
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
  const int32_t excl = (warp > 0 ? warp_sums[warp - 1] : 0) + incl - x;
  *total = warp_sums[kWarps - 1];
  __syncthreads();  // warp_sums is free again
  return excl;
}

// the value of a row of page pg with present rank `rank`, valid or not
template <int VB, typename T>
__device__ __forceinline__ T row_value(const Args& a, const Page& pg,
                                       int64_t rank, bool ok) {
  if (!ok) return (T)a.default_bits;
  const uint32_t idx =
      rank < pg.n_present
          ? unpack(a.words + pg.word_off, pg.n_words, pg.bit_width, rank)
          : 0u;
  if (VB == 0) return (T)idx;
  if (a.nd <= 0) return (T)0;
  int32_t c = (int32_t)idx;  // signed, as the reference clamps
  c = c < 0 ? 0 : (c >= a.nd ? a.nd - 1 : c);
  return __ldg((const T*)a.dict + c);
}

// VB: value bytes (1, 2, 4, 8), or 0 for the unpacked index as int32
template <int VB>
__global__ void __launch_bounds__(kThreads) chunk_decode_kernel(Args a) {
  using T = typename Bits<VB == 0 ? 4 : VB>::T;
  __shared__ __align__(16) uint8_t tile_defs[kTile];
  __shared__ int32_t thread_base[kThreads];
  __shared__ int32_t warp_sums[kWarps];
  const int t = threadIdx.x;
  T* __restrict__ out = (T*)a.values;
  if (a.defs == nullptr) {
    // no nulls: a row's rank is its place in its page, so every row stands
    // alone. A block decodes 512 rows, 2 a thread (t and t + 256), their
    // loads in flight together; thread 0 finds the page of the block's first
    // row once, and each row walks on from it (rarely more than a step)
    __shared__ int first_page;
    for (int64_t b0 = (int64_t)blockIdx.x * kFlatRows; b0 < a.capacity;
         b0 += (int64_t)gridDim.x * kFlatRows) {
      if (t == 0) first_page = find_page(a, b0 < a.n_rows ? b0 : 0);
      __syncthreads();
      const int p0 = first_page;
#pragma unroll
      for (int k = 0; k < kFlatRows / kThreads; ++k) {
        const int64_t j = b0 + k * kThreads + t;
        if (j >= a.capacity) break;
        bool ok = false;
        T v = (T)a.default_bits;
        if (j < a.n_rows) {
          int p = p0;
          while (p + 1 < a.num_pages && __ldg(&a.pages[p + 1].row_off) <= j)
            ++p;
          const Page pg = page_at(a, p);
          ok = j < (int64_t)pg.row_off + pg.row_count;
          v = row_value<VB, T>(a, pg, j - pg.row_off, ok);
        }
        out[j] = v;
        if (a.valid != nullptr) a.valid[j] = ok ? 1 : 0;
      }
      __syncthreads();  // first_page is rewritten by the next block row
    }
    return;
  }
  for (int64_t t0 = (int64_t)blockIdx.x * kTile; t0 < a.capacity;
       t0 += (int64_t)gridDim.x * kTile) {
    // the same for the whole block, so every thread reaches the barriers
    const bool scan = t0 < a.n_rows;
    if (scan) {
      // present rows of the chunk before the tile: those of the pages before
      // the page holding row t0, and that page's own before t0
      const Page p0 = page_at(a, find_page(a, t0));
      int32_t c = 0;
      for (int64_t j = (int64_t)p0.row_off + t; j < t0; j += kThreads)
        c += a.defs[j];
      int32_t before_tile;
      block_exclusive_scan(c, warp_sums, &before_tile);
      before_tile += p0.present_before;
      // this thread's 16 rows: their def bytes into shared memory, and
      // their count into the block scan
      int32_t mine = 0;
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) {
        const int64_t j = t0 + t * kRowsPerThread + k;
        const uint8_t d = j < a.n_rows ? a.defs[j] : (uint8_t)0;
        tile_defs[t * kRowsPerThread + k] = d;
        mine += d;
      }
      int32_t unused;
      thread_base[t] =
          before_tile + block_exclusive_scan(mine, warp_sums, &unused);
      __syncthreads();
    }
#pragma unroll 4
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int r = k * kThreads + t;
      const int64_t j = t0 + r;
      if (j >= a.capacity) break;
      T v = (T)a.default_bits;
      bool ok = false;
      if (j < a.n_rows) {
        const Page pg = page_at(a, find_page(a, j));
        const bool in_page = j < (int64_t)pg.row_off + pg.row_count;
        int64_t rank = j - pg.row_off;
        ok = in_page;
        if (pg.has_nulls) {
          ok = in_page && tile_defs[r] != 0;
          // set def bytes before row r among its owner's 16
          const int o = r / kRowsPerThread, q = r % kRowsPerThread;
          const unsigned long long* d8 =
              (const unsigned long long*)(tile_defs + o * kRowsPerThread);
          const unsigned long long lo_mask =
              q >= 8 ? ~0ull : ((1ull << (8 * q)) - 1ull);
          const unsigned long long hi_mask =
              q <= 8 ? 0ull : ((1ull << (8 * (q - 8))) - 1ull);
          rank = (int64_t)thread_base[o] + __popcll(d8[0] & lo_mask) +
                 __popcll(d8[1] & hi_mask) - pg.present_before;
        }
        v = row_value<VB, T>(a, pg, rank, ok);
      }
      out[j] = v;
      if (a.valid != nullptr) a.valid[j] = ok ? 1 : 0;
    }
    if (scan) __syncthreads();  // tile_defs is rewritten by the next tile
  }
}

}  // namespace

extern "C" int chunk_decode_launch(
    int device, const void* pages, int num_pages, int one_row_count,
    int one_n_words, int one_bit_width, int one_n_present, int one_has_nulls,
    const void* words, const void* defs, const void* dict, int nd,
    long long n_rows, long long capacity, int value_bytes,
    unsigned long long default_bits, void* values, void* valid,
    void* stream) {
  // cudaGetDevice reads this runtime's own state; set only on a change
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return (int)set;
  }
  Args a;
  a.pages = (const Page*)pages;
  a.num_pages = pages == nullptr ? 1 : num_pages;
  a.one = Page{0, one_row_count, 0, one_n_words, one_bit_width,
               one_n_present, 0, one_has_nulls};
  a.words = (const uint32_t*)words;
  a.defs = (const uint8_t*)defs;
  a.dict = dict;
  a.nd = nd;
  a.n_rows = n_rows;
  a.capacity = capacity;
  a.default_bits = default_bits;
  a.values = values;
  a.valid = (uint8_t*)valid;
  // a tile of 4,096 rows a block with def levels, else 512
  const long long per_block = defs != nullptr ? kTile : kFlatRows;
  long long blocks = (capacity + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;  // the loops cover more
  const cudaStream_t s = (cudaStream_t)stream;
  switch (value_bytes) {
    case 0: chunk_decode_kernel<0><<<(unsigned)blocks, kThreads, 0, s>>>(a);
      break;
    case 1: chunk_decode_kernel<1><<<(unsigned)blocks, kThreads, 0, s>>>(a);
      break;
    case 2: chunk_decode_kernel<2><<<(unsigned)blocks, kThreads, 0, s>>>(a);
      break;
    case 4: chunk_decode_kernel<4><<<(unsigned)blocks, kThreads, 0, s>>>(a);
      break;
    case 8: chunk_decode_kernel<8><<<(unsigned)blocks, kThreads, 0, s>>>(a);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
