// B1: the fused R-TBS tick's payload pass, a two-source row gather.
//
// Replaces src/repro/kernels/tbs_step/kernel.py::apply (its pallas_call at
// :109). On the TPU the row selection was a one-hot matmul on the MXU per
// 128-row block. Here it is what it really is: a copy of rows, for every
// item leaf of the tick at once,
//
//     out[t, i] = items[t, src[t, i]]          if src[t, i] <  cap
//               = batch[t, src[t, i] - cap]    otherwise,
//
// with src clamped into range as the JAX reference clamps its gathers.
//
// Bound: device-memory bytes. Each output row is read once from one of the
// two sources and written once; src is read once for all leaves. There is
// no arithmetic. On the main tick (x f32[2^20, 2], y f32[2^20]) that is
// 2 x 2^20 x 12 + 4 x 2^20 bytes = 29.4 MB, 8.8 us at 3.35 TB/s. The output
// is a new buffer (the caller keeps the old state), so every row is read
// and written: the only gain is to reach the bandwidth.
// Design: one launch for up to MAX_LEAVES leaves, passed by value as a
// kernel parameter (no table on the device, no copy to it). Leaves are raw
// bytes [rows, row_bytes] (any dtype, bit-exact by construction) copied in
// words of V = 16, 8, 4, 2 or 1 bytes, the widest dividing the row and the
// leaf's pointers. A row of one word of at most 8 bytes (the main path's x
// and y) goes by rows: a warp takes 32 x ROWS consecutive rows, lane l the
// rows l + 32 k, reads their src entries once for every such leaf and
// issues a leaf's ROWS gathers before it stores any. Every src load and row
// store is then a whole line across the warp, and so is each gather where
// the map keeps rows in place (~94 % of a main tick's). At most 32
// registers a thread: 2,048 threads an SM, so the main tick's 2^20 rows are
// one wave, and the latency of src -> gather -> store is paid about once.
// Every other row (16-byte words, several words, naive Bayes' 400 bytes)
// goes by words: a range of blocks of its own, WORDS words a thread over
// the flattened (row, word) space, so a row is a span of threads and its
// read and write are coalesced. The grid's y dimension is the reservoir
// index T (1 on the single-reservoir path; the trials of a batched state).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEAVES = 8;        // _common.MAX_LEAVES
constexpr int ROWS = 4;              // rows a lane, for one-word rows of <= 8 bytes
constexpr int WORDS = 4;             // words a thread, for every other row
constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 8;        // 2,048 threads an SM: at most 32 registers

struct Leaf {
  const unsigned char* items;        // [T, cap, row_bytes]
  const unsigned char* batch;        // [T, bcap, row_bytes]
  unsigned char* out;                // [T, rows, row_bytes]
  long long row_bytes;
  long long first_block, blocks;     // a flat leaf's range of x blocks
  int vec;
};

// a one-word row of at most 8 bytes goes by rows; any other by words
__host__ __device__ __forceinline__ bool by_rows(long long row_bytes, int vec) {
  return row_bytes == vec && vec <= 8;
}

struct Table {
  Leaf leaf[MAX_LEAVES];
  long long row_blocks;              // x blocks [0, row_blocks): the leaves by rows
  int n;
};

// a row's clamped source: >= 0 an items row, < 0 the batch row ~e
__device__ __forceinline__ int resolve(long long j, long long cap, long long bcap) {
  if (j < cap) return (int)(j < 0 ? 0 : j);
  j -= cap;
  return ~(int)(j >= bcap ? bcap - 1 : j);
}

// a one-word-row leaf's rows of this lane: row0 + 32 k for k < ROWS
template <typename V>
__device__ __forceinline__ void by_row(const Leaf& L, long long t, long long cap,
                                       long long bcap, long long rows, long long row0,
                                       const int (&e)[ROWS]) {
  const V* it = reinterpret_cast<const V*>(L.items) + t * cap;
  const V* bt = reinterpret_cast<const V*>(L.batch) + t * bcap;
  V* o = reinterpret_cast<V*>(L.out) + t * rows;
  V v[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k)
    if (row0 + 32 * k < rows) v[k] = e[k] >= 0 ? __ldg(it + e[k]) : __ldg(bt + ~e[k]);
#pragma unroll
  for (int k = 0; k < ROWS; ++k)
    if (row0 + 32 * k < rows) o[row0 + 32 * k] = v[k];
}

// block blk of a leaf's range by words: WORDS words a thread, THREADS apart
template <typename V>
__device__ __forceinline__ void by_word(const Leaf& L, long long blk, long long t,
                                        const int32_t* __restrict__ src, long long cap,
                                        long long bcap, long long rows) {
  const long long W = L.row_bytes / (long long)sizeof(V);
  const V* it = reinterpret_cast<const V*>(L.items) + t * cap * W;
  const V* bt = reinterpret_cast<const V*>(L.batch) + t * bcap * W;
  V* o = reinterpret_cast<V*>(L.out) + t * rows * W;
  const int32_t* s = src + t * rows;
  const long long total = rows * W;
  const long long base = blk * (THREADS * WORDS) + threadIdx.x;
  V v[WORDS];
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    const long long i = base + (long long)k * THREADS;
    if (i < total) {
      const long long r = i / W;
      const long long w = i - r * W;
      const int e = resolve(__ldg(s + r), cap, bcap);
      v[k] = e >= 0 ? __ldg(it + (long long)e * W + w) : __ldg(bt + (long long)(~e) * W + w);
    }
  }
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    const long long i = base + (long long)k * THREADS;
    if (i < total) o[i] = v[k];
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
tbs_step_apply_kernel(const __grid_constant__ Table tab, const int32_t* __restrict__ src,
                      long long cap, long long bcap, long long rows) {
  const long long t = blockIdx.y;
  const long long blk = blockIdx.x;
  if (blk < tab.row_blocks) {
    // a warp takes 32 ROWS consecutive rows, lane l the rows l + 32 k: every
    // load of src and store of a row is coalesced across the warp, and so
    // is each gather where the map keeps rows in place
    const long long row0 =
        ((blk * THREADS + threadIdx.x) >> 5) * (32LL * ROWS) + (threadIdx.x & 31);
    if (row0 >= rows) return;
    const int32_t* s = src + t * rows;
    int e[ROWS];
#pragma unroll
    for (int k = 0; k < ROWS; ++k)
      e[k] = row0 + 32 * k < rows ? resolve(__ldg(s + row0 + 32 * k), cap, bcap) : 0;
    for (int l = 0; l < tab.n; ++l) {
      const Leaf& L = tab.leaf[l];
      if (!by_rows(L.row_bytes, L.vec)) continue;
      switch (L.vec) {
        case 8: by_row<uint2>(L, t, cap, bcap, rows, row0, e); break;
        case 4: by_row<uint32_t>(L, t, cap, bcap, rows, row0, e); break;
        case 2: by_row<uint16_t>(L, t, cap, bcap, rows, row0, e); break;
        default: by_row<uint8_t>(L, t, cap, bcap, rows, row0, e); break;
      }
    }
    return;
  }
  for (int l = 0; l < tab.n; ++l) {
    const Leaf& L = tab.leaf[l];
    if (by_rows(L.row_bytes, L.vec) || blk < L.first_block ||
        blk >= L.first_block + L.blocks)
      continue;
    const long long b = blk - L.first_block;
    switch (L.vec) {
      case 16: by_word<uint4>(L, b, t, src, cap, bcap, rows); break;
      case 8: by_word<uint2>(L, b, t, src, cap, bcap, rows); break;
      case 4: by_word<uint32_t>(L, b, t, src, cap, bcap, rows); break;
      case 2: by_word<uint16_t>(L, b, t, src, cap, bcap, rows); break;
      default: by_word<uint8_t>(L, b, t, src, cap, bcap, rows); break;
    }
    return;
  }
}

}  // namespace

// n <= MAX_LEAVES leaves: items[l] [T, cap, row_bytes[l]], batch[l]
// [T, bcap, row_bytes[l]], out[l] [T, rows, row_bytes[l]], each contiguous
// raw bytes with row_bytes[l] > 0; vec[l] the copy width in bytes, dividing
// row_bytes[l] and the leaf's three pointers. src [T, rows] int32 is shared
// by every leaf. T <= 65535. One launch.
extern "C" int tbs_step_apply(int n, const void* const* items, const void* const* batch,
                              void* const* out, const long long* row_bytes, const int* vec,
                              const void* src, long long T, long long cap, long long bcap,
                              long long rows, void* stream) {
  if (n <= 0 || n > MAX_LEAVES || T > 65535) return (int)cudaErrorInvalidValue;
  if (T <= 0 || rows <= 0) return (int)cudaGetLastError();
  Table tab{};
  tab.n = n;
  bool any_rows = false;
  for (int l = 0; l < n; ++l) {
    if (row_bytes[l] <= 0) return (int)cudaErrorInvalidValue;
    tab.leaf[l].items = static_cast<const unsigned char*>(items[l]);
    tab.leaf[l].batch = static_cast<const unsigned char*>(batch[l]);
    tab.leaf[l].out = static_cast<unsigned char*>(out[l]);
    tab.leaf[l].row_bytes = row_bytes[l];
    tab.leaf[l].vec = vec[l];
    any_rows |= by_rows(row_bytes[l], vec[l]);
  }
  const long long per_rows = (long long)THREADS * ROWS, per_words = (long long)THREADS * WORDS;
  tab.row_blocks = any_rows ? (rows + per_rows - 1) / per_rows : 0;
  long long next = tab.row_blocks;
  for (int l = 0; l < n; ++l) {
    if (by_rows(row_bytes[l], vec[l])) continue;
    const long long words = rows * (row_bytes[l] / vec[l]);
    tab.leaf[l].first_block = next;
    tab.leaf[l].blocks = (words + per_words - 1) / per_words;
    next += tab.leaf[l].blocks;
  }
  if (next > INT_MAX) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)next, (unsigned)T);
  tbs_step_apply_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      tab, static_cast<const int32_t*>(src), cap, bcap, rows);
  return (int)cudaGetLastError();
}
