// B1: the fused R-TBS tick's payload pass, a two-source row gather.
//
// Replaces src/repro/kernels/tbs_step/kernel.py::apply (and, with T > 1,
// ::apply_banked). On the TPU the row selection was a one-hot matmul on the
// MXU per 128-row block. Here it is what it really is: a copy of rows,
//
//     out[t, i] = items[t, src[t, i]]          if src[t, i] <  cap
//               = batch[t, src[t, i] - cap]    otherwise,
//
// with src clamped into range as the JAX reference clamps its gathers.
//
// Bound: device-memory bytes. Each output row is read once from one of the
// two sources and written once; src is read once. There is no arithmetic.
// Design: every leaf is passed as raw bytes [rows, row_bytes] (any dtype,
// bit-exact by construction) and copied in words of V = 16, 8, 4, 2 or 1
// bytes, the widest that divides the row and the pointers. Threads walk the
// flattened (row, word) space, so neighbouring threads touch neighbouring
// words: output writes are coalesced, and a wide row's read is too; a narrow
// row's read is a scattered gather, which the map makes unavoidable. Each
// thread reads its own src entry through the read-only cache. The grid's y
// dimension is the leading reservoir index T (1 on the single-reservoir
// path, the touched keys of a bank later). The output is a new buffer: src
// permutes reservoir rows, so an in-place write would clobber a row before
// it is read.
#include <cuda_runtime.h>
#include <stdint.h>

template <typename V>
__global__ void tbs_step_apply_kernel(const V* __restrict__ items,
                                      const V* __restrict__ batch,
                                      const int32_t* __restrict__ src,
                                      V* __restrict__ out,
                                      long long cap, long long bcap,
                                      long long rows, long long words) {
  const long long t = blockIdx.y;
  const V* it = items + t * cap * words;
  const V* bt = batch + t * bcap * words;
  const int32_t* s = src + t * rows;
  V* o = out + t * rows * words;
  const long long total = rows * words;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long r = i / words;
    const long long w = i - r * words;
    long long j = __ldg(s + r);
    const V* from;
    if (j < cap) {
      j = j < 0 ? 0 : j;
      from = it + j * words;
    } else {
      j -= cap;
      j = j >= bcap ? bcap - 1 : j;
      from = bt + j * words;
    }
    o[i] = from[w];
  }
}

template <typename V>
static void launch(const void* items, const void* batch, const void* src,
                   void* out, long long T, long long cap, long long bcap,
                   long long rows, long long row_bytes, cudaStream_t stream) {
  const long long words = row_bytes / (long long)sizeof(V);
  const long long total = rows * words;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;   // grid-stride beyond this
  dim3 grid((unsigned)blocks, (unsigned)T);
  tbs_step_apply_kernel<V><<<grid, threads, 0, stream>>>(
      static_cast<const V*>(items), static_cast<const V*>(batch),
      static_cast<const int32_t*>(src), static_cast<V*>(out), cap, bcap, rows,
      words);
}

// items [T, cap, row_bytes], batch [T, bcap, row_bytes], src [T, rows] int32
// -> out [T, rows, row_bytes]. vec is the copy width in bytes; it divides
// row_bytes and the three base pointers. T <= 65535.
extern "C" int tbs_step_apply(const void* items, const void* batch,
                              const void* src, void* out, long long T,
                              long long cap, long long bcap, long long rows,
                              long long row_bytes, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T > 0 && rows > 0 && row_bytes > 0) {
    switch (vec) {
      case 16: launch<uint4>(items, batch, src, out, T, cap, bcap, rows, row_bytes, st); break;
      case 8: launch<uint2>(items, batch, src, out, T, cap, bcap, rows, row_bytes, st); break;
      case 4: launch<uint32_t>(items, batch, src, out, T, cap, bcap, rows, row_bytes, st); break;
      case 2: launch<uint16_t>(items, batch, src, out, T, cap, bcap, rows, row_bytes, st); break;
      default: launch<uint8_t>(items, batch, src, out, T, cap, bcap, rows, row_bytes, st); break;
    }
  }
  return (int)cudaGetLastError();
}
