// H1: the delete-complement map of the R-TBS downsample.
//
// Not a TPU kernel: on the TPU this is the lax.fori_loop of
// src/repro/core/latent.py::_downsample_map_small (lines 180-189), whose
// trip count is known only on the device. Starting from the identity map
// s[q] = q of a row of length L, iteration i < trips deletes a uniform slot
// v_i of the current prefix [0, m), m = k - i, by moving the entry at
// f_i = m - 1 into it:
//
//     s[v_i] = s[clamp(f_i, 0, L - 1)],   v_i = bits[min(i, D - 1)] mod max(m, 1),
//
// an update being dropped where v_i >= L (JAX drops an out-of-range
// scatter). Iterations with m <= 0 are no-ops, so a row runs
// n = clamp(min(trips, k), 0) steps.
//
// The loop reads what the step before wrote, but the map it computes is not
// serial. Where k <= L, v_j <= k - 1 - j, so slot f_i is never written after
// step i, and the value step i moves is the value of the last step before it
// that wrote into f_i (a step with v == f writes its slot into itself and
// counts as no writer), or f_i itself where none did. So the steps form a
// forest whose parent pointers point to earlier steps: a step's value is f
// of its root, and the final map is s[q] = f_root(w(q)) for the last writer
// w(q) of slot q, or q where no step wrote it. Two routes, chosen on the
// host from L and D alone (kernels/swap_delete/ops.py::route):
//
//   forest (large rows, the main path's L = 2^20 and D = 65,536), three
//   launches in stream order, so the trip count is read only on the device:
//     swap_delete_init_kernel  sets a row's int32 scratch to -1: last[L]
//                              (each slot's last writer) and memo[D];
//     swap_delete_last_kernel  one thread a step: atomicMax(last[v_i], i)
//                              where v_i != f_i;
//     swap_delete_map_kernel   one thread a slot: s[q] = q, or for a written
//                              slot f of the root of its last writer, found
//                              by walking parent pointers last[f_j]. Each
//                              walker publishes how far it got in memo[],
//                              and a walker that reaches a published step
//                              jumps on from there: pointer jumping without
//                              rounds. With the sampler's uniform bits the
//                              chains are at most 2 deep at these shapes.
//     A row with k > L (where f is clamped and the forest argument fails)
//     or more steps than D runs the serial loop instead, in one CTA of the
//     map kernel, after that CTA has written the row's identity.
//
//   rows (the keyed bank: 65,536 rows of L = 65 or 97, D = 32), one
//     launch: swap_delete_rows_kernel gives each warp 8 rows, one lane
//     each; the warp builds their identity maps in shared memory and draws
//     their victims with coalesced loads, each lane runs its row's n <= D
//     dependent steps there, and the warp writes the rows out coalesced.
//
// Bound: bytes. The function writes the 8-byte map and reads each step's
// bits word: 8 L + 8 n bytes a row. The forest route also sets and reads
// back 4 L bytes of scratch (L2-resident at L = 2^20) and pays three
// launches; the rows route moves just the map and the bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // forest kernels' CTA
constexpr int kRowWarps = 4;       // rows kernel: warps a CTA

// torch's remainder b mod m for m >= 1: JAX's uint32 % uint32 where both
// fit in 32 bits, as the callers' bits (words in [0, 2^32)) always do
__device__ __forceinline__ long long rem(long long b, long long m) {
  if ((unsigned long long)b <= 0xffffffffull && m <= 0xffffffffll)
    return (long long)((unsigned)b % (unsigned)m);
  const long long r = b % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ long long steps(const long long* trips,
                                           const long long* k, long long t,
                                           long long D) {
  const long long tr = trips[t], kk = k[t];
  const long long n = tr < kk ? tr : kk;
  return (D > 0 && n > 0) ? n : 0;
}

__device__ __forceinline__ long long victim(const long long* b, long long i,
                                            long long k, long long D) {
  const long long m = k - i;
  return rem(b[i < D - 1 ? i : D - 1], m > 1 ? m : 1);
}

// the forest needs k <= L and at most D steps (the memo has D entries)
__device__ __forceinline__ bool serial_row(long long n, long long k,
                                           long long L, long long D) {
  return n > 0 && (k > L || n > D);
}

// the loop as JAX writes it, on one row already set to the identity
__device__ void serial_steps(long long* s, const long long* b, long long n,
                             long long k, long long L, long long D) {
  for (long long i = 0; i < n; ++i) {
    const long long m = k - i;
    const long long v = victim(b, i, k, D);
    long long from = m - 1;
    from = from < 0 ? 0 : (from > L - 1 ? L - 1 : from);
    if (v < L) s[v] = s[from];
  }
}

}  // namespace

// ---- forest route ---------------------------------------------------------
// ws: int32 [T, R], R = Lp + Dp (both multiples of 4): last[Lp], memo[Dp]
__global__ void swap_delete_init_kernel(int* __restrict__ ws,
                                        const long long* __restrict__ trips,
                                        const long long* __restrict__ k,
                                        long long T, long long L, long long R,
                                        long long D) {
  const long long nvec = T * (R / 4);
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < nvec;
       e += (long long)gridDim.x * blockDim.x) {
    const long long t = e / (R / 4);
    const long long n = steps(trips, k, t, D);
    if (n == 0 || serial_row(n, k[t], L, D)) continue;
    reinterpret_cast<int4*>(ws)[e] = make_int4(-1, -1, -1, -1);
  }
}

__global__ void swap_delete_last_kernel(int* __restrict__ ws,
                                        const long long* __restrict__ trips,
                                        const long long* __restrict__ k,
                                        const long long* __restrict__ bits,
                                        long long T, long long L, long long R,
                                        long long bits_stride, long long D) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < T * D;
       e += (long long)gridDim.x * blockDim.x) {
    const long long t = e / D, i = e - t * D;
    const long long n = steps(trips, k, t, D);
    const long long kk = k[t];
    if (i >= n || serial_row(n, kk, L, D)) continue;
    const long long v = victim(bits + t * bits_stride, i, kk, D);
    if (v != kk - 1 - i) atomicMax(ws + t * R + v, (int)i);
  }
}

// the root of step i's chain; last[] is final, memo[j] holds -1, a step
// above j on its chain published by j's own walker, or j once j is a root
__device__ __forceinline__ int root_of(const int* __restrict__ last,
                                       int* memo, int i, long long k) {
  int j = i;
  for (;;) {
    int p = __ldcg(memo + j);
    if (p < 0) {
      p = last[k - 1 - j];   // the last writer of f_j: j's parent
      if (p < 0) break;      // none: j is the root
    } else if (p == j) {
      break;
    }
    j = p;
    __stcg(memo + i, j);
  }
  __stcg(memo + i, j);
  return j;
}

__global__ void swap_delete_map_kernel(long long* __restrict__ out, int* ws,
                                       const long long* __restrict__ trips,
                                       const long long* __restrict__ k,
                                       const long long* __restrict__ bits,
                                       long long L, long long R, long long Lp,
                                       long long bits_stride, long long D,
                                       long long blocks_per_row) {
  const long long t = blockIdx.x / blocks_per_row;
  const long long c = blockIdx.x - t * blocks_per_row;
  const long long n = steps(trips, k, t, D);
  const long long kk = k[t];
  long long* s = out + t * L;
  if (serial_row(n, kk, L, D)) {   // uniform across the CTA
    if (c != 0) return;
    for (long long q = threadIdx.x; q < L; q += blockDim.x) s[q] = q;
    __syncthreads();
    if (threadIdx.x == 0) serial_steps(s, bits + t * bits_stride, n, kk, L, D);
    return;
  }
  const long long q = c * blockDim.x + threadIdx.x;
  if (q >= L) return;
  long long val = q;
  if (n > 0 && q < kk) {
    const int* last = ws + t * R;
    const int w = last[q];
    if (w >= 0) val = kk - 1 - root_of(last, ws + t * R + Lp, w, kk);
  }
  s[q] = val;
}

// ---- rows route -----------------------------------------------------------
// one thread a row, a warp kWarpRows consecutive rows, whose maps are
// contiguous in out. Shared memory per warp: the rows' step counts and k
// (2 x kWarpRows int64), their maps (kWarpRows x L int16) and the victims of
// their first min(n, D) steps (kWarpRows x D int16, -1 where v >= L). The
// warp walks the rows' victims and maps as flat arrays, so its loads of the
// bits and stores of the map are coalesced and its lanes stay busy; a lane's
// bits words are all requested before the identity is built, so one memory
// latency covers them. Only the dependent steps run one lane a row. Few rows
// a warp keep each warp's path short: the live rows' warps then spread over
// every SM and hide each other's latencies.
constexpr int kWarpRows = 8;
constexpr int kWords = kWarpRows;   // words a lane has in flight: all of them where D <= 32

__global__ void swap_delete_rows_kernel(long long* __restrict__ out,
                                        const long long* __restrict__ trips,
                                        const long long* __restrict__ k,
                                        const long long* __restrict__ bits,
                                        long long T, long long L_,
                                        long long bits_stride, long long D_) {
  extern __shared__ long long smem_ll[];
  const int L = (int)L_, D = (int)D_;         // L + D <= 376
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long t0 = ((long long)blockIdx.x * kRowWarps + warp) * kWarpRows;
  if (t0 >= T) return;                        // uniform across the warp
  const int rows = (int)(T - t0 < kWarpRows ? T - t0 : kWarpRows);
  const long long t = t0 + lane;
  const long long n = lane < rows ? steps(trips, k, t, D) : 0;
  const long long kk = lane < rows ? k[t] : 0;
  long long* o = out + t0 * L;
  const int total = rows * L;
  if (!__any_sync(0xffffffffu, n > 0)) {      // identity rows only
    for (int e = lane, q = lane; e < total; e += 32, q += 32) {
      while (q >= L) q -= L;
      o[e] = q;
    }
    return;
  }
  long long* ns = smem_ll + warp * (2 * kWarpRows + kWarpRows * (L + D) / 4);
  long long* ks = ns + kWarpRows;
  short* s = reinterpret_cast<short*>(ks + kWarpRows);
  short* vic = s + kWarpRows * L;
  if (lane < kWarpRows) {
    ns[lane] = n;
    ks[lane] = kk;
  }
  __syncwarp();
  const int nv = rows * D;                    // the warp's victim slots
  long long w[kWords];
  auto load = [&](int base) {                 // the words of slots base + 32 j
    int r = base / D, i = base - r * D;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const bool ok = base + 32 * j < nv && i < ns[r];
      w[j] = ok ? bits[(t0 + r) * bits_stride + i] : 0;
      for (i += 32; i >= D; i -= D) ++r;
    }
  };
  auto draw = [&](int base) {
    int r = base / D, i = base - r * D;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const int e = base + 32 * j;
      if (e < nv && i < ns[r]) {
        const long long m = ks[r] - i;
        const long long v = rem(w[j], m > 1 ? m : 1);
        vic[e] = v < L ? (short)v : (short)-1;
      }
      for (i += 32; i >= D; i -= D) ++r;
    }
  };
  load(lane);
  for (int e = lane, q = lane; e < total; e += 32, q += 32) {   // meanwhile
    while (q >= L) q -= L;
    s[e] = (short)q;
  }
  draw(lane);
  for (int base = lane + 32 * kWords; base < nv; base += 32 * kWords) {
    load(base);
    draw(base);
  }
  __syncwarp();
  short* sr = s + lane * L;
  for (long long i = 0; i < n; ++i) {         // n = 0 on lanes past the rows
    int v;
    if (i < D) {
      v = vic[lane * D + (int)i];
    } else {
      const long long x = victim(bits + t * bits_stride, i, kk, D);
      v = x < L ? (int)x : -1;
    }
    const long long f = kk - 1 - i;
    const int from = f < 0 ? 0 : (f > L - 1 ? L - 1 : (int)f);
    if (v >= 0) sr[v] = sr[from];
  }
  __syncwarp();
  for (int e = lane; e < total; e += 32) o[e] = s[e];
}

static unsigned grid_for(long long work, int threads) {
  long long b = (work + threads - 1) / threads;
  const long long cap = 1ll << 20;   // grid-stride loops cover the rest
  return (unsigned)(b < 1 ? 1 : (b > cap ? cap : b));
}

// out [T, L] int64, written whole; ws int32 [T, R] scratch, R = Lp + Dp with
// Lp = L and Dp = D rounded up to multiples of 4; trips, k [T] int64; bits
// [T, >= D] int64 words with row stride bits_stride.
extern "C" int swap_delete_forest(void* out, void* ws, const void* trips,
                                  const void* k, const void* bits, long long T,
                                  long long L, long long Lp, long long R,
                                  long long bits_stride, long long D,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T <= 0 || L <= 0) return (int)cudaGetLastError();
  long long* o = static_cast<long long*>(out);
  int* w = static_cast<int*>(ws);
  const long long* tr = static_cast<const long long*>(trips);
  const long long* kk = static_cast<const long long*>(k);
  const long long* b = static_cast<const long long*>(bits);
  if (D > 0) {
    swap_delete_init_kernel<<<grid_for(T * (R / 4), kThreads), kThreads, 0, st>>>(
        w, tr, kk, T, L, R, D);
    swap_delete_last_kernel<<<grid_for(T * D, kThreads), kThreads, 0, st>>>(
        w, tr, kk, b, T, L, R, bits_stride, D);
  }
  const long long bpr = (L + kThreads - 1) / kThreads;
  if (T * bpr > 0x7fffffffll) return (int)cudaErrorInvalidConfiguration;
  swap_delete_map_kernel<<<(unsigned)(T * bpr), kThreads, 0, st>>>(
      o, w, tr, kk, b, L, R, Lp, bits_stride, D, bpr);
  return (int)cudaGetLastError();
}

// the rows route; kRowWarps * kWarpRows * (16 + 2 (L + D)) bytes of shared
// memory a CTA: within 48 KB for L + D <= 760
extern "C" int swap_delete_rows(void* out, const void* trips, const void* k,
                                const void* bits, long long T, long long L,
                                long long bits_stride, long long D,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T <= 0 || L <= 0) return (int)cudaGetLastError();
  const long long Dv = D > 0 ? D : 0;
  const size_t smem = (size_t)kRowWarps * kWarpRows * (16 + 2 * (L + Dv));
  const long long rows = (long long)kRowWarps * kWarpRows;
  const long long blocks = (T + rows - 1) / rows;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidConfiguration;
  swap_delete_rows_kernel<<<(unsigned)blocks, 32 * kRowWarps, smem, st>>>(
      static_cast<long long*>(out), static_cast<const long long*>(trips),
      static_cast<const long long*>(k), static_cast<const long long*>(bits), T,
      L, bits_stride, Dv);
  return (int)cudaGetLastError();
}
