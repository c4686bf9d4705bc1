// B2: stable compaction of a sample's kept rows to the buffer head, for
// every item leaf of the sample in one launch.
//
// Replaces src/repro/kernels/reservoir_compact/kernel.py::compact (its
// pallas_call at :58). On the TPU one sequential grid carried the running
// offset in scratch from block to block and placed rows by a one-hot
// matmul. Here, for up to MAX_LEAVES leaves against one mask [cap]:
//
//     out[l][rank(r)] = items[l][r]   for each kept row r (mask[r] != 0),
//     out[l][j]       = 0             for j in [count, cap),
//     count           = the kept rows, an int32 left on the device,
//
// with rank(r) the kept rows before r. Rows are raw bytes (any dtype,
// bit-exact by construction).
//
// Bound: device-memory bytes. The mask is read once for all leaves; each
// leaf's rows are read once and its output written once. At the main
// path's shape (cap ~2^20, x f32[., 2] + y f32[.]) that is
// 2 x 12 x cap + cap = 26.2 MB, 7.8 us at 3.35 TB/s. There is no
// arithmetic to speak of.
// Design: one cooperative launch on a resident grid (SMs x blocks an SM,
// asked once a device), each CTA owning one contiguous span of R x THREADS
// rows, taken in chunks of at most RC rows a thread, with one grid-wide
// barrier between two phases:
//
//   1. each thread reads the mask bytes of its RC contiguous rows of the
//      chunk in one load, the CTA scans the threads' counts, and each row's
//      rank within the chunk (-1: dropped) goes to shared memory; the CTA
//      publishes its span's count;
//   -- grid barrier (cooperative_groups::this_grid().sync()): the launch
//      is refused, not hung, when the grid is not co-resident, and the
//      refusal returns through this file's C entry;
//   2. the CTA sums the span counts from L2, a thread a count: the total
//      (CTA 0 writes it as the count) and the counts before this span.
//      Each CTA copies its kept rows to offset + rank, a thread a word of
//      the flattened (row, word) space (naive Bayes' 400-byte rows: 25
//      16-byte words; a one-word row such as x's or y's: a thread a row),
//      so that a warp's reads are whole lines and its packed writes nearly
//      so; only kept rows are read. Then the CTAs zero every leaf's
//      [count, cap) bytes in 16-byte stores, in pieces of ZERO_PIECE bytes
//      claimed one at a time from a counter: a CTA that finishes its rows
//      early takes more of them. With equal shares fixed in advance the
//      CTAs ended far apart (on 400-byte rows those alone on an SM long
//      before those that share one), and the last of them ran on a card
//      mostly idle.
//
// The leaves' pointers, row bytes and copy widths reach the kernel by
// value, as a __grid_constant__ parameter (no table on the device). The
// only scratch is the span counts, an int32 a CTA, and the piece counter,
// which CTA 0 sets to 0 before the barrier: each is written before it is
// read in the same launch, so nothing needs a reset launch. A single-pass
// decoupled look-back scan was weighed: it gives each CTA its offset
// without a barrier, but not the total, and the zero tail [count, cap)
// cannot be written without it, so it would need a barrier or a second
// launch all the same.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_LEAVES = 8;               // _common.MAX_LEAVES
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MIN_BLOCKS = 2;               // resident blocks an SM: at most 64 registers
constexpr int RC = 8;                       // rows a thread in one chunk
constexpr int CHUNK = RC * THREADS;         // 4,096 rows
constexpr int UG = 4;                       // words a thread in flight
constexpr long long ZERO_PIECE = 32 * 1024; // bytes of the zero tail a claim
constexpr long long MAX_ROW_WORDS = 1LL << 19;  // kernel.MAX_ROW_WORDS: CHUNK rows' words fit 32 bits
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;

struct Leaf {
  const unsigned char* items;               // [cap, row_bytes]
  unsigned char* out;                       // [cap, row_bytes]
  long long row_bytes;
  int vec;                                  // copy word: divides row_bytes and both pointers
};

struct Table {
  Leaf leaf[MAX_LEAVES];
  int n;
};

struct Shared {
  int16_t rank[CHUNK];                      // a chunk row's rank among its kept rows, -1 dropped
  int wsum[WARPS];
  unsigned long long wsum64[WARPS];
  int piece;                                // the zero tail's piece claimed last
};

// the exclusive prefix of v over the CTA's threads; *all = the sum
__device__ __forceinline__ int block_scan(int v, Shared& sh, int* all) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh.wsum[warp] = x;
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int t = sh.wsum[w];
    before += w < warp ? t : 0;
    total += t;
  }
  __syncthreads();                          // wsum is reused
  *all = total;
  return before + x - v;
}

// the sum of v over the CTA's threads, in every thread
__device__ __forceinline__ unsigned long long block_sum(unsigned long long v, Shared& sh) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  if ((threadIdx.x & 31) == 0) sh.wsum64[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned long long s = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += sh.wsum64[w];
  return s;
}

// the chunk of kn <= RC rows a thread from row0: thread t reads the mask of
// rows row0 + t kn + j (j < kn) in one load where it can, and sh.rank gets
// each row's rank in the chunk; returns the chunk's kept rows
__device__ int chunk_ranks(const uint8_t* __restrict__ mask, int row0, int cap, int kn,
                           Shared& sh) {
  const int t0 = threadIdx.x * kn;
  const long long r0 = (long long)row0 + t0;
  unsigned bits = 0;
  if (kn == RC && r0 + RC <= cap && (reinterpret_cast<uintptr_t>(mask + r0) & 7) == 0) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(mask + r0));
    const unsigned a = __vcmpne4(v.x, 0u), b = __vcmpne4(v.y, 0u);
    bits = (a & 1u) | ((a >> 7) & 2u) | ((a >> 14) & 4u) | ((a >> 21) & 8u) |
           ((b & 1u) << 4) | ((b >> 3) & 32u) | ((b >> 10) & 64u) | ((b >> 17) & 128u);
  } else {
    for (int j = 0; j < kn; ++j)
      if (r0 + j < cap && __ldg(mask + r0 + j) != 0) bits |= 1u << j;
  }
  int kept = 0;
  int r = block_scan(__popc(bits), sh, &kept);
  for (int j = 0; j < kn; ++j) sh.rank[t0 + j] = (bits >> j) & 1u ? (int16_t)r++ : (int16_t)-1;
  __syncthreads();                          // ranks are read by other threads
  return kept;
}

// a leaf's kept rows of the chunk, over the chunk's words: word idx of the
// flattened (row, word) space is thread idx % THREADS's, UG words a thread
// in flight, so that a warp reads and writes whole runs of words across
// row boundaries (kept neighbours land side by side); a row of one word is
// a thread's, rows interleaved across the threads. Rows and counts fit 32
// bits (cap < 2^31), and so do the chunk's words (row words below
// MAX_ROW_WORDS); addresses are 64.
template <typename V>
__device__ __forceinline__ void copy_words(const Leaf& L, int row0, int nrows, int off,
                                           const Shared& sh) {
  const unsigned W = (unsigned)(L.row_bytes / (long long)sizeof(V));
  const unsigned words = (unsigned)nrows * W;
  const V* __restrict__ it = reinterpret_cast<const V*>(L.items);
  V* __restrict__ o = reinterpret_cast<V*>(L.out);
  for (unsigned b = 0; b < words; b += THREADS * UG) {
    long long src[UG], dst[UG];
#pragma unroll
    for (int u = 0; u < UG; ++u) {
      const unsigned idx = b + u * THREADS + threadIdx.x;
      const unsigned r = idx / W;
      const int k = idx < words ? sh.rank[r] : -1;
      src[u] = (long long)(row0 + (int)r) * W + (idx - r * W);
      dst[u] = k >= 0 ? (long long)(off + k) * W + (idx - r * W) : -1;
    }
    V v[UG];
#pragma unroll
    for (int u = 0; u < UG; ++u)
      if (dst[u] >= 0) v[u] = __ldg(it + src[u]);
#pragma unroll
    for (int u = 0; u < UG; ++u)
      if (dst[u] >= 0) o[dst[u]] = v[u];
  }
}

// this CTA's share of bytes [lo, hi) of a leaf's output set to zero
__device__ __forceinline__ void zero_bytes(unsigned char* out, long long lo, long long hi) {
  if (hi <= lo) return;
  const long long mis = (long long)(reinterpret_cast<uintptr_t>(out + lo) & 15u);
  const long long head = min(hi - lo, (16 - mis) & 15);
  if (threadIdx.x < head) out[lo + threadIdx.x] = 0;
  const long long m0 = lo + head;
  const long long nw = (hi - m0) >> 4;
  uint4* p = reinterpret_cast<uint4*>(out + m0);
  for (long long i = threadIdx.x; i < nw; i += THREADS) p[i] = make_uint4(0u, 0u, 0u, 0u);
  const long long t0 = m0 + (nw << 4);
  if (threadIdx.x < hi - t0) out[t0 + threadIdx.x] = 0;
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
reservoir_compact_kernel(const __grid_constant__ Table tab, const uint8_t* __restrict__ mask,
                         int* __restrict__ count, int* __restrict__ span_counts,
                         int* __restrict__ next_piece, int cap, int R) {
  __shared__ Shared sh;
  const int s0 = blockIdx.x * R * THREADS;  // < cap < 2^31
  const int nch = (R + RC - 1) / RC;

  // phase 1: the span's count; the last chunk's ranks stay in shared memory
  int span_count = 0, ctot = 0;
  for (int c = 0; c < nch; ++c) {
    ctot = chunk_ranks(mask, s0 + c * CHUNK, cap, min(R - c * RC, RC), sh);
    span_count += ctot;
  }
  if (threadIdx.x == 0) __stcg(span_counts + blockIdx.x, span_count);
  if (blockIdx.x == 0 && threadIdx.x == 0) *next_piece = 0;   // claimed after the barrier

  cg::this_grid().sync();

  // phase 2: the span counts from L2, a thread a count, summed as
  // total << 32 | (the counts of the spans before this one): both < 2^31
  unsigned long long part = 0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += THREADS) {
    const unsigned v = (unsigned)__ldcg(span_counts + b);
    part += ((unsigned long long)v << 32) | (b < (int)blockIdx.x ? v : 0u);
  }
  const unsigned long long sums = block_sum(part, sh);
  const int total = (int)(sums >> 32);
  if (blockIdx.x == 0 && threadIdx.x == 0) *count = total;

  // the kept rows, chunk by chunk from the last (its ranks already in
  // shared memory) down
  int end = (int)(unsigned)sums + span_count;
  for (int c = nch - 1; c >= 0; --c) {
    const int kn = min(R - c * RC, RC);
    const int row0 = s0 + c * CHUNK;
    if (c != nch - 1) {
      __syncthreads();                      // the copy of chunk c + 1 read the ranks
      ctot = chunk_ranks(mask, row0, cap, kn, sh);
    }
    const int off = end - ctot;
    end = off;
    const int rows = max(0, min(kn * THREADS, cap - row0));
    for (int l = 0; l < tab.n; ++l) {
      const Leaf& L = tab.leaf[l];
      switch (L.vec) {
        case 16: copy_words<uint4>(L, row0, rows, off, sh); break;
        case 8: copy_words<uint2>(L, row0, rows, off, sh); break;
        case 4: copy_words<uint32_t>(L, row0, rows, off, sh); break;
        case 2: copy_words<uint16_t>(L, row0, rows, off, sh); break;
        default: copy_words<uint8_t>(L, row0, rows, off, sh); break;
      }
    }
  }

  // every leaf's [count, cap) bytes, piece by piece as claimed: piece p is
  // the p-th ZERO_PIECE bytes of the leaves' tails laid end to end; thread
  // 0 claims the next piece while the CTA zeroes this one
  if (threadIdx.x == 0) sh.piece = atomicAdd(next_piece, 1);
  __syncthreads();
  for (long long p = sh.piece;;) {
    __syncthreads();                        // every thread has read sh.piece
    int l = 0;
    long long lo = 0, hi = 0;
    for (; l < tab.n; ++l) {
      const long long a = total * tab.leaf[l].row_bytes, b = cap * tab.leaf[l].row_bytes;
      const long long n = (b - a + ZERO_PIECE - 1) / ZERO_PIECE;
      if (p < n) {
        lo = a + p * ZERO_PIECE;
        hi = min(b, lo + ZERO_PIECE);
        break;
      }
      p -= n;
    }
    if (l == tab.n) break;
    int next = 0;
    if (threadIdx.x == 0) next = atomicAdd(next_piece, 1);
    zero_bytes(tab.leaf[l].out, lo, hi);
    if (threadIdx.x == 0) sh.piece = next;
    __syncthreads();
    p = sh.piece;
  }
}

std::atomic<int> g_resident[MAX_DEVICES];

// the resident blocks of the kernel on the current device (SMs x blocks an
// SM), asked once a device
cudaError_t resident_blocks(long long* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  int n = g_resident[dev].load(std::memory_order_relaxed);
  if (n <= 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, reservoir_compact_kernel,
                                                          THREADS, 0);
    if (err != cudaSuccess) return err;
    if (per_sm <= 0) return cudaErrorCooperativeLaunchTooLarge;
    n = sms * per_sm;
    g_resident[dev].store(n, std::memory_order_relaxed);
  }
  *out = n;
  return cudaSuccess;
}

}  // namespace

// The length of the scratch that reservoir_compact needs on the current
// device: an int32 for each CTA of the resident grid and the piece counter.
extern "C" int reservoir_compact_scratch(long long* out) {
  const cudaError_t err = resident_blocks(out);
  *out += 1;
  return (int)err;
}

// 0 <= n <= MAX_LEAVES leaves: items[l], out[l] [cap, row_bytes[l]],
// contiguous raw bytes with row_bytes[l] > 0, vec[l] a copy width in bytes
// dividing row_bytes[l] and both pointers, row_bytes[l] / vec[l] below
// MAX_ROW_WORDS; mask [cap] bytes (0 = dropped);
// count a device int32; scratch int32 [scratch_len], scratch_len at least
// reservoir_compact_scratch's, and a stream's launches in order (the
// scratch is written and read within a launch). 0 < cap < 2^31. One
// cooperative launch (n = 0 writes the count alone).
extern "C" int reservoir_compact(int n, const void* const* items, void* const* out,
                                 const long long* row_bytes, const int* vec, const void* mask,
                                 void* count, void* scratch, long long scratch_len, long long cap,
                                 void* stream) {
  if (n < 0 || n > MAX_LEAVES || cap <= 0 || cap > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  long long resident = 0;
  cudaError_t err = resident_blocks(&resident);
  if (err != cudaSuccess) return (int)err;
  // R rows a thread: the fewest that cover cap with the resident grid
  const long long per_pass = resident * THREADS;
  int R = (int)((cap + per_pass - 1) / per_pass);
  const long long span = (long long)R * THREADS;
  const unsigned blocks = (unsigned)((cap + span - 1) / span);
  if ((long long)blocks + 1 > scratch_len) return (int)cudaErrorInvalidValue;
  Table tab{};
  tab.n = n;
  for (int l = 0; l < n; ++l) {
    if (row_bytes[l] <= 0 || vec[l] <= 0 || row_bytes[l] % vec[l] ||
        row_bytes[l] / vec[l] >= MAX_ROW_WORDS)
      return (int)cudaErrorInvalidValue;
    Leaf& L = tab.leaf[l];
    L.items = static_cast<const unsigned char*>(items[l]);
    L.out = static_cast<unsigned char*>(out[l]);
    L.row_bytes = row_bytes[l];
    L.vec = vec[l];
  }
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  int* cnt = static_cast<int*>(count);
  int* sc = static_cast<int*>(scratch);
  int* next = sc + blocks;
  int cap32 = (int)cap;
  void* args[] = {&tab, &m, &cnt, &sc, &next, &cap32, &R};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(reservoir_compact_kernel),
                                    dim3(blocks), dim3(THREADS), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
