// B3: the keyed bank's payload pass, fused and in place.
//
// Replaces src/repro/kernels/tbs_step/kernel.py::apply_banked (its
// pallas_call at :81) together with what surrounds it in
// src/repro/bank/bank.py (the gather of the touched keys' reservoirs, the
// scatter of the result back with mode="drop") and
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
// which is the scatter's drop. Every item leaf of the bank moves in the
// same launch.
//
// Bound: device-memory bytes. Per touched key its touched, starts and src
// entries are read once for all leaves; per leaf, a slot is written only if
// its row changes (src >= cap, or a clamped src that is not the slot
// itself), each distinct source row is read once, and each landing batch
// row is read once with its order entry (ref.banked_write_mask). On the
// bank tick (K = 2^20, cap 65, b = 65,536) that is ~4.7 % of the touched
// slots: ~6 MB, 1.8 us at 3.35 TB/s. There is no arithmetic.
// Design: one launch for up to MAX_LEAVES leaves, passed by value as a
// kernel parameter. A group of 16 lanes takes a touched row, over a
// grid-stride loop of a resident grid (its size asked once a device), so
// there is no tail wave. The kernel reads the routing's int64 arrays and
// the tick map's int32 src as they are (a cast would be a kernel of its
// own), and the touched count stays on the device: the kernel reads it,
// the host never does. Each lane loads its ceil(cap / 16) src entries, a coalesced
// read of the key's src row, and a group loads its first row's entries
// before the count arrives and its next row's while the current one moves.
// Each slot is resolved once for all leaves: kept, a slot of the key, or a
// payload row through order. Then for every copy word of every leaf (U
// words at a time: the bank's x and y rows are three 4-byte words, one
// phase): each moved slot of the group reads its source word into
// registers, the group syncs (__syncwarp), and each moved slot writes.
// The map permutes the key's own rows, so reading before any write is what
// makes the in-place write safe; distinct words never alias and touched
// keys are distinct, so no other group touches the key's rows, and no block
// barrier or shared-memory copy of the reservoir is needed. Slots that keep
// their row are neither read nor written. At most 64 registers a thread
// (fewer spill and lose more than the residency they buy): 8,448 groups on
// 132 SMs, so the bank tick's ~17,200 rows take three rounds. Past its
// launch the time goes to the ~30 scattered 32-byte sectors a row touches
// (its src row, its order entries, each moved slot's words read and
// written), which is ~16 MB a tick against the bound's 6. Caps past
// WARP_CAP take a CTA a key, with the key's rows staged in shared memory
// (the same read-all / barrier / write-moved order; cap * row bytes must
// fit one CTA's shared memory). Rows are raw bytes (any dtype, bit-exact)
// copied in words of 16, 4 or 1 bytes, the widest dividing every leaf's row
// and pointers.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int MAX_LEAVES = 8;        // _common.MAX_LEAVES
constexpr int WARP_CAP = 128;        // kernel.WARP_CAP: 16 lanes x 8 slots
constexpr int G = 16;                // lanes a touched row
constexpr int MAX_DEVICES = 64;
constexpr int THREADS = 256;

struct Leaf {
  unsigned char* bank;               // [K, cap, words] (updated in place)
  const unsigned char* payload;      // [b, words]
  long long words;                   // copy words a row
  long long first;                   // the leaf's first word in the table's order
};

struct Table {
  Leaf leaf[MAX_LEAVES];
  long long words;                   // over all leaves
  int n;
};

// U words of the table a phase: one 16-byte word, three 4-byte words (the
// x + y rows of the bank's items), four bytes
template <typename V> struct Unroll {
  static constexpr int U = sizeof(V) >= 16 ? 1 : (sizeof(V) == 4 ? 3 : 4);
};

constexpr int MIN_BLOCKS = 4;        // resident blocks an SM: at most 64 registers

template <typename V, int M>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
tbs_step_banked_kernel(const __grid_constant__ Table tab, const int64_t* __restrict__ order,
                       const int64_t* __restrict__ starts, const int64_t* __restrict__ touched,
                       const int64_t* __restrict__ ntouched, const int32_t* __restrict__ src,
                       long long K, long long cap, long long bcap, long long b) {
  constexpr int U = Unroll<V>::U;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);
  const unsigned mask = ((1u << G) - 1u) << (lane & G);   // this group's half of the warp
  // rows, keys, starts and slots fit 32 bits (b, K < 2^31); addresses are 64
  const int groups = gridDim.x * (THREADS / G);
  const int ncap = (int)cap, nb = (int)b;
  int t = blockIdx.x * (THREADS / G) + threadIdx.x / G;
  // a routed row's key, sub-batch start and src entries, loaded a row
  // ahead: the first row's before the count arrives (t < b keeps every
  // load in bounds), the next row's while this one moves
  int key = 0, st = 0;
  int from[M];
  auto load = [&](int tt, int& k, int& s0, int (&j)[M]) {
    k = (int)__ldg(touched + tt);
    s0 = (int)__ldg(starts + tt);
    const int32_t* s = src + (long long)tt * ncap;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int i = sub + G * m;
      j[m] = i < ncap ? __ldg(s + i) : -1;
    }
  };
  if (t < nb) load(t, key, st, from);
  long long nt64 = __ldg(ntouched);
  const int nt = (int)(nt64 > b ? b : (nt64 < 0 ? 0 : nt64));
  for (; t < nt; t += groups) {
    int key_n = 0, st_n = 0;
    int from_n[M];
    if (t + groups < nt) load(t + groups, key_n, st_n, from_n);
    if (key >= 0 && key < K) {                  // uniform across the group
      // slot sub + G m: -1 keeps its row, >= 0 takes that slot of the key,
      // <= -2 takes payload row -2 - from
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int i = sub + G * m;
        const int j = from[m];
        int f = -1;
        if (j < ncap) {
          const int jj = j < 0 ? 0 : j;
          if (jj != i) f = jj;
        } else {
          const long long q = j - cap >= bcap ? bcap - 1 : j - cap;
          const long long p = st + q < 0 ? 0 : (st + q >= b ? b - 1 : st + q);
          f = -2 - (int)__ldg(order + p);
        }
        from[m] = i < ncap ? f : -1;
      }
      int l = 0;
      for (long long g0 = 0; g0 < tab.words; g0 += U) {
        V v[U][M];
        const int l0 = l;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const long long g = g0 + u;
          if (g < tab.words) {
            while (g >= tab.leaf[l].first + tab.leaf[l].words) ++l;
            const Leaf& L = tab.leaf[l];
            // plain loads: the kernel writes these rows too
            const V* rows = reinterpret_cast<const V*>(L.bank) +
                            (long long)key * ncap * L.words + (g - L.first);
            const V* pay = reinterpret_cast<const V*>(L.payload) + (g - L.first);
#pragma unroll
            for (int m = 0; m < M; ++m) {
              if (from[m] >= 0)
                v[u][m] = rows[(long long)from[m] * L.words];
              else if (from[m] < -1)
                v[u][m] = __ldg(pay + (long long)(-2 - from[m]) * L.words);
            }
          }
        }
        __syncwarp(mask);                        // every read before any write
        l = l0;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const long long g = g0 + u;
          if (g < tab.words) {
            while (g >= tab.leaf[l].first + tab.leaf[l].words) ++l;
            const Leaf& L = tab.leaf[l];
            V* rows = reinterpret_cast<V*>(L.bank) + (long long)key * ncap * L.words +
                      (g - L.first);
#pragma unroll
            for (int m = 0; m < M; ++m)
              if (from[m] != -1) rows[(long long)(sub + G * m) * L.words] = v[u][m];
          }
        }
      }
    }
    key = key_n;
    st = st_n;
#pragma unroll
    for (int m = 0; m < M; ++m) from[m] = from_n[m];
  }
}

// caps past WARP_CAP: a CTA a touched row, the key's rows staged per leaf
template <typename V>
__global__ void __launch_bounds__(THREADS)
tbs_step_banked_staged_kernel(const __grid_constant__ Table tab,
                              const int64_t* __restrict__ order,
                              const int64_t* __restrict__ starts,
                              const int64_t* __restrict__ touched,
                              const int64_t* __restrict__ ntouched,
                              const int32_t* __restrict__ src, long long K, long long cap,
                              long long bcap, long long b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* stage = reinterpret_cast<V*>(smem_raw);
  long long nt = __ldg(ntouched);
  nt = nt > b ? b : nt;
  for (long long t = blockIdx.x; t < nt; t += gridDim.x) {
    const long long key = __ldg(touched + t);
    if (key < 0 || key >= K) continue;          // uniform across the CTA
    const int32_t* s = src + t * cap;
    const long long st = __ldg(starts + t);
    for (int l = 0; l < tab.n; ++l) {
      const Leaf& L = tab.leaf[l];
      const long long W = L.words;
      const long long total = cap * W;
      V* rows = reinterpret_cast<V*>(L.bank) + key * total;
      const V* pay = reinterpret_cast<const V*>(L.payload);
      for (long long i = threadIdx.x; i < total; i += blockDim.x) stage[i] = rows[i];
      __syncthreads();
      for (long long i = threadIdx.x; i < total; i += blockDim.x) {
        const long long r = i / W;
        const long long w = i - r * W;
        long long j = __ldg(s + r);
        V v;
        if (j < cap) {
          j = j < 0 ? 0 : j;
          if (j == r) continue;                 // the slot keeps its row
          v = stage[j * W + w];
        } else {
          j -= cap;
          j = j >= bcap ? bcap - 1 : j;
          long long p = st + j;
          p = p < 0 ? 0 : (p >= b ? b - 1 : p);
          v = __ldg(pay + (long long)__ldg(order + p) * W + w);
        }
        rows[i] = v;
      }
      __syncthreads();                          // stage is reused by the next leaf or t
    }
  }
}

struct Args {
  const int64_t *order, *starts, *touched, *ntouched;
  const int32_t* src;
  long long K, cap, bcap, b;
  cudaStream_t stream;
};

// the resident blocks of kern on the current device: SMs x blocks an SM,
// asked once a device and kernel instance (each instance has its own cache)
template <typename K>
cudaError_t resident_blocks(K kern, std::atomic<int> (&cache)[MAX_DEVICES], long long* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  int n = cache[dev].load(std::memory_order_relaxed);
  if (n <= 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, 0);
    if (err != cudaSuccess) return err;
    n = sms * (per_sm > 0 ? per_sm : 1);
    cache[dev].store(n, std::memory_order_relaxed);
  }
  *out = n;
  return cudaSuccess;
}

template <typename V, int M>
int launch_groups(const Table& tab, const Args& a) {
  auto kern = tbs_step_banked_kernel<V, M>;
  static std::atomic<int> cache[MAX_DEVICES];
  long long resident = 0;
  const cudaError_t err = resident_blocks(kern, cache, &resident);
  if (err != cudaSuccess) return (int)err;
  // a group a routed row at most, and no more blocks than stay resident
  const long long per_block = THREADS / G;
  long long blocks = (a.b + per_block - 1) / per_block;
  blocks = blocks < resident ? blocks : resident;
  kern<<<(unsigned)blocks, THREADS, 0, a.stream>>>(tab, a.order, a.starts, a.touched,
                                                  a.ntouched, a.src, a.K, a.cap, a.bcap, a.b);
  return (int)cudaGetLastError();
}

template <typename V>
int launch_staged(const Table& tab, const Args& a, long long max_row_bytes) {
  const size_t smem = (size_t)(a.cap * max_row_bytes);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(tbs_step_banked_staged_kernel<V>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = a.b < 16384 ? a.b : 16384;   // grid-stride beyond this
  tbs_step_banked_staged_kernel<V><<<(unsigned)blocks, THREADS, smem, a.stream>>>(
      tab, a.order, a.starts, a.touched, a.ntouched, a.src, a.K, a.cap, a.bcap, a.b);
  return (int)cudaGetLastError();
}

template <typename V>
int launch(const Table& tab, const Args& a, long long max_row_bytes) {
  if (a.cap <= WARP_CAP) {
    switch ((a.cap + G - 1) / G) {
      case 1: return launch_groups<V, 1>(tab, a);
      case 2: return launch_groups<V, 2>(tab, a);
      case 3: return launch_groups<V, 3>(tab, a);
      case 4: return launch_groups<V, 4>(tab, a);
      case 5: return launch_groups<V, 5>(tab, a);
      case 6: return launch_groups<V, 6>(tab, a);
      case 7: return launch_groups<V, 7>(tab, a);
      default: return launch_groups<V, 8>(tab, a);
    }
  }
  return launch_staged<V>(tab, a, max_row_bytes);
}

}  // namespace

// n <= MAX_LEAVES leaves: bank[l] [K, cap, row_bytes[l]] (updated in
// place), payload[l] [b, row_bytes[l]], contiguous raw bytes with
// row_bytes[l] > 0; vec[l] a copy width in bytes dividing row_bytes[l] and
// the leaf's two pointers. The leaves move in one word of 16, 4 or 1 bytes,
// the widest that every vec[l] allows. order, starts, touched [b] int64 (the
// routing's own index type); ntouched a device int64; src [b, cap] int32.
// Past WARP_CAP, cap times the widest row must fit one CTA's shared memory
// (tbs_step_banked_smem_limit). One launch.
extern "C" int tbs_step_banked(int n, void* const* bank, const void* const* payload,
                               const long long* row_bytes, const int* vec, const void* order,
                               const void* starts, const void* touched,
                               const void* ntouched, const void* src, long long K,
                               long long cap, long long bcap, long long b, void* stream) {
  if (n <= 0 || n > MAX_LEAVES) return (int)cudaErrorInvalidValue;
  if (b <= 0 || cap <= 0) return (int)cudaGetLastError();
  int word = 16;
  for (int l = 0; l < n; ++l) word = vec[l] < word ? vec[l] : word;
  word = word >= 16 ? 16 : (word >= 4 ? 4 : 1);
  Table tab{};
  tab.n = n;
  long long first = 0, widest = 0;
  for (int l = 0; l < n; ++l) {
    if (row_bytes[l] <= 0 || row_bytes[l] % word) return (int)cudaErrorInvalidValue;
    tab.leaf[l].bank = static_cast<unsigned char*>(bank[l]);
    tab.leaf[l].payload = static_cast<const unsigned char*>(payload[l]);
    tab.leaf[l].words = row_bytes[l] / word;
    tab.leaf[l].first = first;
    first += tab.leaf[l].words;
    widest = row_bytes[l] > widest ? row_bytes[l] : widest;
  }
  tab.words = first;
  const Args a{static_cast<const int64_t*>(order), static_cast<const int64_t*>(starts),
               static_cast<const int64_t*>(touched), static_cast<const int64_t*>(ntouched),
               static_cast<const int32_t*>(src), K, cap, bcap, b,
               static_cast<cudaStream_t>(stream)};
  switch (word) {
    case 16: return launch<uint4>(tab, a, widest);
    case 4: return launch<uint32_t>(tab, a, widest);
    default: return launch<uint8_t>(tab, a, widest);
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
