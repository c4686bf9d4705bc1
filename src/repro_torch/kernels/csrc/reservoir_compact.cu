// B2: stable compaction of a reservoir's kept rows to the buffer head.
//
// Replaces src/repro/kernels/reservoir_compact/kernel.py::compact. On the
// TPU one sequential grid carried the running offset in scratch and placed
// rows by a one-hot matmul. Hopper's blocks run in parallel and in no order,
// so the offset becomes a scan across blocks, in three launches:
//
//   1. rc_count   one 1024-row block per CTA counts its kept rows
//                 (__syncthreads_count);
//   2. rc_scan    one CTA scans the per-block counts into block offsets and
//                 writes the total, which stays on the device as the int32
//                 count;
//   3. rc_scatter each CTA rescans its 1024 mask bits (warp ballots plus a
//                 shuffle scan of the 32 warp sums), then copies its kept
//                 rows to offset + rank and zeroes its rows at or past the
//                 count.
//
// Bound: device-memory bytes (the mask read twice, the rows read once, the
// output written once); the scan itself is a few KiB. The copy treats rows
// as raw bytes in words of V = 16, 8, 4, 2 or 1 bytes, block-cooperatively
// over the (row, word) space, so it is bit-exact for every dtype. At
// cap = 2^20 the middle scan sees 1024 block counts: one CTA suffices there.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int BLK = 1024;

__global__ void rc_count(const uint8_t* __restrict__ mask, long long cap,
                         int* __restrict__ block_counts) {
  const long long r = (long long)blockIdx.x * BLK + threadIdx.x;
  const int keep = (r < cap) && mask[r] != 0;
  const int c = __syncthreads_count(keep);
  if (threadIdx.x == 0) block_counts[blockIdx.x] = c;
}

__global__ void rc_scan(const int* __restrict__ block_counts, int nb,
                        int* __restrict__ offsets, int* __restrict__ total) {
  __shared__ int s[BLK];
  __shared__ int carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < nb; base += BLK) {
    const int i = base + threadIdx.x;
    const int v = i < nb ? block_counts[i] : 0;
    s[threadIdx.x] = v;
    __syncthreads();
    for (int off = 1; off < BLK; off <<= 1) {   // Hillis-Steele inclusive scan
      const int x = threadIdx.x >= off ? s[threadIdx.x - off] : 0;
      __syncthreads();
      s[threadIdx.x] += x;
      __syncthreads();
    }
    if (i < nb) offsets[i] = carry + s[threadIdx.x] - v;
    __syncthreads();
    if (threadIdx.x == BLK - 1) carry += s[BLK - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) *total = carry;
}

template <typename V>
__global__ void rc_scatter(const V* __restrict__ items,
                           const uint8_t* __restrict__ mask,
                           const int* __restrict__ offsets,
                           const int* __restrict__ total, V* __restrict__ out,
                           long long cap, long long words) {
  __shared__ int dest[BLK];
  __shared__ int warp_excl[BLK / 32];
  const long long base = (long long)blockIdx.x * BLK;
  const long long r = base + threadIdx.x;
  const int keep = (r < cap) && mask[r] != 0;
  const unsigned lane = threadIdx.x & 31u, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, keep);
  const int rank_in_warp = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) warp_excl[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    const int orig = warp_excl[lane];
    int v = orig;
    for (int off = 1; off < 32; off <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, v, off);
      if ((int)lane >= off) v += x;
    }
    warp_excl[lane] = v - orig;
  }
  __syncthreads();
  dest[threadIdx.x] =
      keep ? offsets[blockIdx.x] + warp_excl[warp] + rank_in_warp : -1;
  const long long count = *total;
  __syncthreads();
  const long long nrows = (cap - base) < BLK ? (cap - base) : BLK;
  const V zero{};
  for (long long idx = threadIdx.x; idx < nrows * words; idx += BLK) {
    const long long rr = idx / words;
    const long long w = idx - rr * words;
    const long long g = base + rr;
    const int d = dest[rr];
    if (d >= 0) out[(long long)d * words + w] = items[g * words + w];
    if (g >= count) out[g * words + w] = zero;
  }
}

template <typename V>
static void launch_scatter(const void* items, const void* mask,
                           const int* offsets, const int* total, void* out,
                           long long cap, long long row_bytes, int nb,
                           cudaStream_t st) {
  rc_scatter<V><<<nb, BLK, 0, st>>>(
      static_cast<const V*>(items), static_cast<const uint8_t*>(mask), offsets,
      total, static_cast<V*>(out), cap, row_bytes / (long long)sizeof(V));
}

// items [cap, row_bytes], mask [cap] (bytes 0/1) -> out [cap, row_bytes],
// count [1] int32. scratch is int32 [2 * ceil(cap / 1024)].
extern "C" int reservoir_compact(const void* items, const void* mask,
                                 void* out, void* count, void* scratch,
                                 long long cap, long long row_bytes, int vec,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cap > 0) {
    const int nb = (int)((cap + BLK - 1) / BLK);
    int* counts = static_cast<int*>(scratch);
    int* offsets = counts + nb;
    int* total = static_cast<int*>(count);
    const uint8_t* m = static_cast<const uint8_t*>(mask);
    rc_count<<<nb, BLK, 0, st>>>(m, cap, counts);
    rc_scan<<<1, BLK, 0, st>>>(counts, nb, offsets, total);
    switch (vec) {
      case 16: launch_scatter<uint4>(items, mask, offsets, total, out, cap, row_bytes, nb, st); break;
      case 8: launch_scatter<uint2>(items, mask, offsets, total, out, cap, row_bytes, nb, st); break;
      case 4: launch_scatter<uint32_t>(items, mask, offsets, total, out, cap, row_bytes, nb, st); break;
      case 2: launch_scatter<uint16_t>(items, mask, offsets, total, out, cap, row_bytes, nb, st); break;
      default: launch_scatter<uint8_t>(items, mask, offsets, total, out, cap, row_bytes, nb, st); break;
    }
  }
  return (int)cudaGetLastError();
}
