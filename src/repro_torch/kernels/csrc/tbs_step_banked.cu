// B3: the keyed bank's payload pass, fused and in place.
//
// Replaces src/repro/kernels/tbs_step/kernel.py::apply_banked together with
// what surrounds it in src/repro/bank/bank.py (the gather of the touched
// keys' reservoirs, the scatter of the result back with mode="drop") and
// src/repro/bank/routing.py::subbatches (the per-key sub-batch built through
// the sort order and the segment starts). For each touched row t < ntouched
// of key = touched[t], every slot i of that key's reservoir becomes
//
//     bank[key, src[t, i]]                                 if src[t, i] < cap
//     payload[order[clip(starts[t] + j, 0, b - 1)]]        otherwise,
//         with j = clip(src[t, i] - cap, 0, bcap - 1),
//
// and src[t, i] < 0 reads slot 0: the clamps of the JAX gathers. Rows
// t >= ntouched (the sentinel key K) and keys outside [0, K) do no work,
// which is the scatter's drop.
//
// Bound: device-memory bytes. Per touched key its cap source rows are read
// and its cap rows written, its src row read once; each batch row that lands
// is read once with its order entry. There is no arithmetic.
// Design: one CTA per touched row, over a grid-stride loop on a 1-D grid
// (the row count b may pass 65,535). The CTA stages the key's cap x B bytes
// in dynamic shared memory, synchronises, and writes the cap output rows back
// over the same bank rows: the map permutes a key's own rows, so staging is
// what makes the in-place write safe, and touched keys are distinct, so no
// two CTAs touch one row. Reads and writes of the key's rows are contiguous
// and coalesced; a batch row is a gather the routing makes unavoidable.
// Rows are raw bytes (any dtype, bit-exact) copied in words of V = 16, 8, 4,
// 2 or 1 bytes, the widest dividing the row and the base pointers. The
// touched count stays on the device: the kernel reads it, the host never
// does. The whole of the bank is never read.
#include <cuda_runtime.h>
#include <stdint.h>

template <typename V>
__global__ void tbs_step_banked_kernel(V* __restrict__ bank,
                                       const V* __restrict__ payload,
                                       const int32_t* __restrict__ order,
                                       const int32_t* __restrict__ starts,
                                       const int32_t* __restrict__ touched,
                                       const int32_t* __restrict__ ntouched,
                                       const int32_t* __restrict__ src,
                                       long long K, long long cap,
                                       long long bcap, long long b,
                                       long long words) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* stage = reinterpret_cast<V*>(smem_raw);
  long long nt = __ldg(ntouched);
  nt = nt > b ? b : nt;
  const long long total = cap * words;
  for (long long t = blockIdx.x; t < nt; t += gridDim.x) {
    const long long key = __ldg(touched + t);
    if (key < 0 || key >= K) continue;        // uniform across the CTA
    V* rows = bank + key * total;
    for (long long i = threadIdx.x; i < total; i += blockDim.x) stage[i] = rows[i];
    __syncthreads();
    const int32_t* s = src + t * cap;
    const long long st = __ldg(starts + t);
    for (long long i = threadIdx.x; i < total; i += blockDim.x) {
      const long long r = i / words;
      const long long w = i - r * words;
      long long j = __ldg(s + r);
      V v;
      if (j < cap) {
        j = j < 0 ? 0 : j;
        v = stage[j * words + w];
      } else {
        j -= cap;
        j = j >= bcap ? bcap - 1 : j;
        long long p = st + j;
        p = p < 0 ? 0 : (p >= b ? b - 1 : p);
        const long long row = __ldg(order + p);
        v = payload[row * words + w];
      }
      rows[i] = v;
    }
    __syncthreads();                          // stage is reused by the next t
  }
}

template <typename V>
static int launch(void* bank, const void* payload, const void* order,
                  const void* starts, const void* touched,
                  const void* ntouched, const void* src, long long K,
                  long long cap, long long bcap, long long b,
                  long long row_bytes, cudaStream_t stream) {
  const long long words = row_bytes / (long long)sizeof(V);
  const long long total = cap * words;
  const size_t smem = (size_t)total * sizeof(V);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(tbs_step_banked_kernel<V>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  long long threads = (total + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  const long long blocks = b < 16384 ? b : 16384;   // grid-stride beyond this
  tbs_step_banked_kernel<V><<<(unsigned)blocks, (unsigned)threads, smem, stream>>>(
      static_cast<V*>(bank), static_cast<const V*>(payload),
      static_cast<const int32_t*>(order), static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(touched),
      static_cast<const int32_t*>(ntouched),
      static_cast<const int32_t*>(src), K, cap, bcap, b, words);
  return (int)cudaGetLastError();
}

// bank [K, cap, row_bytes] (updated in place), payload [b, row_bytes];
// order, starts, touched [b] int32; ntouched a device int32; src [b, cap]
// int32. vec is the copy width in bytes; it divides row_bytes and the bank
// and payload pointers. cap * row_bytes must fit one CTA's shared memory
// (tbs_step_banked_smem_limit).
extern "C" int tbs_step_banked(void* bank, const void* payload,
                               const void* order, const void* starts,
                               const void* touched, const void* ntouched,
                               const void* src, long long K, long long cap,
                               long long bcap, long long b,
                               long long row_bytes, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || cap <= 0 || row_bytes <= 0) return (int)cudaGetLastError();
  switch (vec) {
    case 16: return launch<uint4>(bank, payload, order, starts, touched, ntouched, src, K, cap, bcap, b, row_bytes, st);
    case 8: return launch<uint2>(bank, payload, order, starts, touched, ntouched, src, K, cap, bcap, b, row_bytes, st);
    case 4: return launch<uint32_t>(bank, payload, order, starts, touched, ntouched, src, K, cap, bcap, b, row_bytes, st);
    case 2: return launch<uint16_t>(bank, payload, order, starts, touched, ntouched, src, K, cap, bcap, b, row_bytes, st);
    default: return launch<uint8_t>(bank, payload, order, starts, touched, ntouched, src, K, cap, bcap, b, row_bytes, st);
  }
}

// The most dynamic shared memory one CTA may opt into on the device.
extern "C" int tbs_step_banked_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}
