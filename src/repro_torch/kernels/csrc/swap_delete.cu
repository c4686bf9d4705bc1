// H1: the delete-complement loop of the R-TBS downsample map.
//
// Not a TPU kernel: on the TPU this loop is the lax.fori_loop of
// src/repro/core/latent.py::_downsample_map_small, whose trip count is known
// only on the device. Iteration i deletes a uniform slot v_i of the current
// prefix [0, m), m = k - i, by moving the entry at m - 1 into it:
//
//     src[v_i] = src[m - 1],   v_i = bits[i] mod max(m, 1),
//
// and each iteration reads what the one before wrote. Run as eager torch ops
// this is one launch per iteration (hundreds of thousands a tick at
// bcap = 65,536); reading the trip count to the host instead costs a sync
// every tick. So the loop runs here, in one thread per row of the leading
// trial dimension, reading trips, k and the bits from device memory; the
// writes happen in exactly the JAX order.
//
// Bound: latency. The chain of dependent loads and stores is serial by
// construction (one L2 round trip per iteration), so the time grows with the
// trip count, not with bytes; the caller gates the trip count to 0 whenever
// the branch that uses the result is not taken.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void swap_delete_kernel(long long* __restrict__ src,
                                   const long long* __restrict__ trips,
                                   const long long* __restrict__ k,
                                   const long long* __restrict__ bits,
                                   long long T, long long L,
                                   long long bits_stride, long long D) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  long long* s = src + t * L;
  const long long* b = bits + t * bits_stride;
  const long long n = trips[t];
  const long long kk = k[t];
  for (long long i = 0; i < n; ++i) {
    const long long m = kk - i;
    const long long mm = m > 1 ? m : 1;
    const long long v = b[i < D - 1 ? i : D - 1] % mm;
    long long from = m - 1;
    from = from < 0 ? 0 : (from > L - 1 ? L - 1 : from);
    if (v < L) s[v] = s[from];   // JAX drops an out-of-range update
  }
}

// src [T, L] int64, updated in place; trips, k [T] int64; bits [T, >= D]
// int64 words in [0, 2^32) with row stride bits_stride.
extern "C" int swap_delete(void* src, const void* trips, const void* k,
                           const void* bits, long long T, long long L,
                           long long bits_stride, long long D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T > 0 && L > 0 && D > 0) {
    const int threads = 128;
    const unsigned blocks = (unsigned)((T + threads - 1) / threads);
    swap_delete_kernel<<<blocks, threads, 0, st>>>(
        static_cast<long long*>(src), static_cast<const long long*>(trips),
        static_cast<const long long*>(k), static_cast<const long long*>(bits),
        T, L, bits_stride, D);
  }
  return (int)cudaGetLastError();
}
