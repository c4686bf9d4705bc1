// H2 and H3: the random-variate draws of the paper's other schemes.
//
// Neither replaces a TPU kernel. On the TPU both are XLA loops whose trip
// count is known only on the device: H2 is jax.random.binomial (the
// rejection and inversion loops of jax/_src/random.py that
// src/repro/core/rng.py:20 `binomial` calls: T-TBS's m ~ Bin(|S|, p) and
// k ~ Bin(B, q), Alg. 1 lines 6 and 8), and H3 is the lax.fori_loop of
// src/repro/core/rng.py:42 `hypergeometric` (B-RS's M ~ HyperGeo(C, B, W),
// Alg. 5 line 5). Run eagerly in PyTorch each is a loop of small launches
// steered by the host, which would have to read a value back every trip.
// Here each row runs its loop to the end on the device, so a tick never
// syncs to the host.
//
//   H2 binomial_kernel, one thread a row: row t draws Bin(count[t], p[t])
//     from its key keys[t] = (k0, k1), with JAX's algorithm: q = min(p, 1 - p), inversion
//     (a sum of geometric gaps, one uniform a trip) where count * q <= 10,
//     BTRS (transformed rejection with squeeze, two uniforms a trip) where
//     not, the result reflected to count - x where p >= 0.5. Trip i takes
//     Philox block (i, 0, 0, DRAW) of the row's key: inversion its word 0,
//     BTRS its words 0 and 1. p = 0, p = 1 and count <= 0 are answered
//     explicitly (0, count, 0; JAX's results), so a lost sign of zero can
//     never turn p = 1's inversion, which JAX ends only through
//     log1p(-0.0) = -0.0, into an endless loop. A NaN p gives -1.
//   H3 hypergeometric_kernel, one CTA a row: row t draws HyperGeo(k, a, b)
//     by inverse transform from its operand uniform u[t]: a sequential f32
//     cdf over the pmf-ratio recurrence from lo = max(0, k - b), stopping
//     at the first trip whose cdf reaches u (JAX's loop never changes its
//     value after that trip) or past hi = min(a, k), and at most `trips`
//     trips (JAX's max_support + 1); hi where the cdf never reached u.
//
// The plain versions (kernels/variates/ref.py) repeat every f32 operation
// in the same order. The kernels' own arithmetic is written with the _rn
// intrinsics, which the compiler never contracts into fused multiply-adds,
// so each operation rounds once as PyTorch's elementwise ops do (the one
// fused multiply-add, in log Gamma, is explicit on both sides). The
// transcendental functions are the CUDA math library's (no fast math):
// logf, log1pf and expf, which PyTorch's own CUDA log, log1p and exp call,
// and, inside log Gamma (XLA's Lanczos formula), log and log1p in f64. So
// on the card a kernel and its plain version agree bit for bit.
//
// Bound. Neither bytes nor operations bound either kernel on this card
// (chip_smoke.py reports the byte and operation bounds beside them):
//   H2 is a serial loop in one thread a row, and at a T-TBS tick's two rows
//     of one or two trips its time is the launch.
//   H3 at a saturated B-RS tick runs ~61,700 trips of one row. Of a trip's
//     work only two f32 adds depend on the trip before: logp += log(ratio)
//     and cdf += exp(logp). The ratio depends only on the trip's s, and
//     exp(logp) only on that trip's logp. So the bound is the ordered
//     chain of dependent adds, about 4 cycles a trip (PERF.md calls it the
//     chain floor), not the ~300-cycle trip of a thread that does it all.
//     The design, one CTA a row: trips go in blocks of kBlock. Six
//     producer warps evaluate, 32 trips to an instruction, the log-ratios
//     of block j + 1 and the exps of block j - 1. Warp 0 runs the logp
//     chain of block j and warp 1 the cdf chain of block j - 2, so the
//     two chains run side by side on two schedulers. Each stage ends in one
//     __syncthreads_or() of the cdf warp's stop, so every warp leaves after
//     the same barrier and an exit can never strand a warp at one. Why two chain warps: a warp
//     issues shared-memory accesses far more slowly than dependent adds,
//     and one warp that read both chains' terms and wrote both chains'
//     values a trip at a time ran well above the chain floor. Here every
//     lane of a chain warp carries the same sum from broadcast float4
//     reads (one read per 4 trips), and lane i keeps the chain's value at
//     trip i of each 32 with a bitwise select (one LOP3 a trip, no
//     predicate). The logp warp then writes 32 values in one warp-wide
//     store, and each lane of the cdf warp tests its own trip for the
//     serial loop's stop; one warp reduction a block finds the first.
//     Those stores and tests run inside the next chunk's loop body, where
//     the adds hide them. The start value's nine log Gamma calls run on
//     nine lanes at once. Every add keeps the serial loop's order and
//     every libm call is the same, so the draw is the serial loop's bit
//     for bit; terms evaluated past the exit are thrown away. Rows of many
//     trips fill the card with CTAs.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 128;     // H2: a thread a row

// H3: a CTA a row. Warp 0 runs the logp chain, warp 1 the cdf chain, and
// the other warps are producers (the block size and the producers were
// chosen by timing 256 to 1024 trips and 2 to 6 producer warps).
constexpr int kProducerWarps = 6;
constexpr int kRowThreads = 32 * (2 + kProducerWarps);
constexpr int kProducers = 32 * kProducerWarps;
constexpr int kBlock = 1024;      // trips a block (kernels/variates/kernel.py H3_BLOCK)
constexpr int kChunk = 32;        // a chain warp's unit: one trip a lane
constexpr int kRatioSlots = 2;    // log-ratios: written at stage j - 1, read at j
constexpr int kProbSlots = 4;     // logp, then exp in place: written at j, read at j + 2
constexpr int kAhead = 3;         // float4 reads in flight on a chain

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// JAX's Stirling-series tail table (f32 values of its double constants)
__constant__ float kTail[10] = {
    0x1.4c071cp-4f, 0x1.52a9bap-5f, 0x1.c579a2p-6f, 0x1.54a266p-6f, 0x1.10b4e6p-6f,
    0x1.c6b168p-7f, 0x1.85d4d6p-7f, 0x1.552806p-7f, 0x1.2f4872p-7f, 0x1.10f9d4p-7f};

// jax/_src/random.py::_stirling_approx_tail: the table for k <= 9, else
// the series at k clamped into [0, 9] (JAX evaluates it on the clamped k)
__device__ __forceinline__ float stirling_tail(float k) {
  const float kc = fminf(fmaxf(k, 0.0f), 9.0f);
  const float kp1 = add(kc, 1.0f);
  const float kp1sq = mul(kp1, kp1);
  const float approx =
      dvd(sub(0x1.555556p-4f, dvd(sub(0x1.6c16c2p-9f, dvd(0x1.a01a02p-11f, kp1sq)), kp1sq)),
          kp1);
  return k <= 9.0f ? kTail[(int)floorf(kc)] : approx;
}

// inversion: count the geometric gaps until their sum passes n
__device__ float binomial_inversion(float n, float q, uint32_t k0, uint32_t k1) {
  const float l1mq = log1pf(-q);
  float num_geom = 0.0f, geom_sum = 0.0f;
  for (uint32_t i = 0; geom_sum <= n; ++i) {
    num_geom = add(num_geom, 1.0f);
    const float u = philox::uniform(philox::block(i, 0, 0, philox::DRAW, k0, k1).w[0]);
    geom_sum = add(geom_sum, ceilf(dvd(logf(u), l1mq)));
  }
  return sub(num_geom, 1.0f);
}

// BTRS (Hormann 1993) with JAX's constants and operation order
__device__ float binomial_btrs(float n, float q, uint32_t k0, uint32_t k1) {
  const float stddev = __fsqrt_rn(mul(mul(n, q), sub(1.0f, q)));
  const float b = add(0x1.266666p+0f, mul(0x1.43d70ap+1f, stddev));
  const float a = add(add(-0x1.6594b0p-4f, mul(0x1.9652bep-6f, b)), mul(0x1.47ae14p-7f, q));
  const float c = add(mul(n, q), 0.5f);
  const float v_r = sub(0x1.d70a3ep-1f, dvd(0x1.0cccccp+2f, b));
  const float r = dvd(q, sub(1.0f, q));
  const float alpha = mul(add(0x1.6a3d70p+1f, dvd(0x1.466666p+2f, b)), stddev);
  const float m = floorf(mul(add(n, 1.0f), q));
  const float nm1 = add(sub(n, m), 1.0f);
  // the terms of the bound that do not depend on the trip
  const float t_m = mul(add(m, 0.5f), logf(dvd(add(m, 1.0f), mul(r, nm1))));
  const float st_m = stirling_tail(m), st_nm = stirling_tail(sub(n, m));
  for (uint32_t i = 0;; ++i) {
    const philox::Block w = philox::block(i, 0, 0, philox::DRAW, k0, k1);
    const float u = sub(philox::uniform(w.w[0]), 0.5f);
    float v = philox::uniform(w.w[1]);
    const float us = sub(0.5f, fabsf(u));
    const bool accept1 = (us >= 0x1.1eb852p-4f) && (v <= v_r);
    const float k = floorf(add(mul(add(dvd(mul(2.0f, a), us), b), u), c));
    const bool reject = (k < 0.0f) || (k > n);
    v = logf(dvd(mul(v, alpha), add(dvd(a, mul(us, us)), b)));
    const float nk1 = add(sub(n, k), 1.0f);
    float ub = add(t_m, mul(add(n, 1.0f), logf(dvd(nm1, nk1))));
    ub = add(ub, mul(add(k, 0.5f), logf(dvd(mul(r, nk1), add(k, 1.0f)))));
    ub = add(ub, st_m);
    ub = add(ub, st_nm);
    ub = sub(ub, stirling_tail(k));
    ub = sub(ub, stirling_tail(sub(n, k)));
    if (accept1 || (!reject && v <= ub)) return k;
  }
}

__global__ void binomial_kernel(long long* __restrict__ out, const long long* __restrict__ keys,
                                const long long* __restrict__ count,
                                const float* __restrict__ p, long long T) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const float pf = p[t];
  const long long cnt = count[t];
  if (isnan(pf)) {
    out[t] = -1;
    return;
  }
  const float pc = fminf(fmaxf(pf, 0.0f), 1.0f);
  if (cnt <= 0 || pc == 0.0f) {
    out[t] = 0;
    return;
  }
  if (pc == 1.0f) {
    out[t] = cnt;
    return;
  }
  const uint32_t k0 = (uint32_t)keys[2 * t], k1 = (uint32_t)keys[2 * t + 1];
  const float n = (float)cnt;
  const bool lt = pc < 0.5f;
  const float q = lt ? pc : sub(1.0f, pc);
  const float s = mul(n, q) <= 10.0f ? binomial_inversion(n, q, k0, k1)
                                     : binomial_btrs(n, q, k0, k1);
  out[t] = (long long)(lt ? s : sub(n, s));
}

// log Gamma(x) for x >= 0.5 as XLA computes lax.lgamma: its Lanczos
// approximation (g = 7) in its f32 operation order, with the multiply-add
// XLA:CPU contracts kept as one fused rounding, and its two logarithms
// evaluated in f64 and rounded to f32 (so the card and the CPU agree:
// kernels/variates/ref.py lgamma is the same function in PyTorch)
__constant__ float kLanczos[8] = {0x1.52429cp+9f,  -0x1.3ac8e8p+10f, 0x1.81a966p+9f,
                                  -0x1.613ae6p+7f, 0x1.903c28p+3f,   -0x1.1bcb2ap-3f,
                                  0x1.4f0514p-17f, 0x1.435508p-23f};

__device__ float lgamma_xla(float x) {
  const float z = sub(x, 1.0f);
  const float t = add(z, 7.5f);
  const float log_t = add((float)log1p((double)mul(z, 0x1.111112p-3f)), 0x1.01e858p+1f);
  const float w = __fmaf_rn(sub(add(z, 0.5f), dvd(t, log_t)), log_t, 0x1.d67f1cp-1f);
  float a = add(dvd(kLanczos[0], add(z, 1.0f)), 1.0f);
#pragma unroll
  for (int i = 1; i < 8; ++i) a = add(a, dvd(kLanczos[i], add(z, (float)(i + 1))));
  return add(w, (float)log((double)a));
}

// the trips of block j that the stages evaluate: those below n, rounded
// up to a whole chunk (the terms past n are evaluated and never read)
__device__ __forceinline__ int block_len(long long n, long long j) {
  const long long r = j < 0 ? 0 : n - j * kBlock;
  if (r <= 0) return 0;
  return r >= kBlock ? kBlock : (int)((r + kChunk - 1) / kChunk * kChunk);
}

// log of the pmf ratio p(s + 1) / p(s) at trip g, s = lo + g, formed as
// the serial loop forms it (log 1 where num or den is not positive)
__device__ __forceinline__ float log_ratio(float lo, float a, float k, float bk, long long g) {
  const float s = add(lo, (float)g);
  const float num = mul(sub(a, s), sub(k, s));
  const float den = mul(add(s, 1.0f), add(add(bk, s), 1.0f));
  return logf((num > 0.0f && den > 0.0f) ? dvd(num, den) : 1.0f);
}

// An ordered chain over the first `len` trips of a slot (len a
// multiple of kChunk): run += slot[i] in order, every lane of the warp
// carrying the same sum from broadcast float4 reads, which run kAhead
// float4s ahead of the adds and never past `len`. Lane i keeps the
// chain's value at trip i of each chunk of 32 (before its add where
// `before`, after it where not) and hands it to done(valid, c, value)
// for the chunk at trip c. A lane keeps its value with its one-hot masks own[i]
// (all ones at its own trip i, else zero): value |= bits(run) & own[i],
// one LOP3 a trip over four accumulators. The masks come from shared
// memory, so the compiler cannot turn them back into a compare and a
// predicated select at every trip. done runs for each chunk inside the
// next chunk's loop body, with `valid` false on the first, so that its
// work (a store, a stop test) is scheduled among that chunk's adds and
// the chain never waits for it; the last chunk's runs after the loop.
template <bool before, class Done>
__device__ __forceinline__ void chain(const float* slot, int len, const unsigned (&own)[kChunk],
                                      float& run, Done&& done) {
  if (len <= 0) return;
  const float4* in = reinterpret_cast<const float4*>(slot);
  const int nv = len / 4;
  float4 x[kAhead];
#pragma unroll
  for (int r = 0; r < kAhead; ++r) x[r] = in[min(r, nv - 1)];
  unsigned last = 0u;                 // the value of the chunk before
  for (int v = 0; v < nv; v += kChunk / 4) {
    done(v > 0, 4 * v - kChunk, __uint_as_float(last));
    unsigned mine[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int q = 0; q < kChunk / 4; ++q) {
      const float4 xn = in[min(v + q + kAhead, nv - 1)];
      const float y[4] = {x[0].x, x[0].y, x[0].z, x[0].w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (before) mine[r] |= __float_as_uint(run) & own[4 * q + r];
        run = add(run, y[r]);
        if (!before) mine[r] |= __float_as_uint(run) & own[4 * q + r];
      }
#pragma unroll
      for (int r = 0; r + 1 < kAhead; ++r) x[r] = x[r + 1];
      x[kAhead - 1] = xn;
    }
    last = (mine[0] | mine[1]) | (mine[2] | mine[3]);
  }
  done(true, len - kChunk, __uint_as_float(last));
}

// Stage t (t = -1, 0, 1, ...) of a row. Block j's log-ratios live in slot
// j % kRatioSlots of `ratio`, its logps and then their exps in slot
// j % kProbSlots of `prob`:
//   warp 0     the logp chain over block t: reads its log-ratios, writes
//              the logp each trip starts from (one warp-wide store a
//              chunk); at t = -1 the start value's log Gamma terms;
//   warp 1     the cdf chain over block t - 2: reads its exps; each lane
//              tests its own trip of each chunk for the serial loop's stop
//              (past n, past hi, or a cdf that reached u), and the block's
//              first stop, by one warp reduction, writes the draw and ends
//              the row at the stage's closing __syncthreads_or();
//   producers  the log-ratios of block t + 1 and the exps of block t - 1
//              (its logps, in place).
// The slots a stage touches are distinct, and no warp writes what another
// reads in the same stage.
__global__ void __launch_bounds__(kRowThreads)
hypergeometric_kernel(long long* __restrict__ out, const float* __restrict__ u,
                      const long long* __restrict__ kk, const long long* __restrict__ aa,
                      const long long* __restrict__ bb, long long trips) {
  __shared__ __align__(16) float ratio[kRatioSlots][kBlock];
  __shared__ __align__(16) float prob[kProbSlots][kBlock];
  __shared__ float lg[9];
  __shared__ unsigned eye[2 * kChunk];   // lane l's mask for trip i: eye[kChunk + i - l]
  const long long row = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float k = (float)kk[row], a = (float)aa[row], b = (float)bb[row], ut = u[row];
  const float lo = fmaxf(0.0f, sub(k, b));
  const float hi = fminf(a, k);
  const float bk = sub(b, k);
  // n: the trips that can matter, at most `trips` and, where lo + g is
  // exact (hi below 2^24), none past hi. The stop test still checks
  // s <= hi itself, as the serial loop does.
  long long n = trips;
  if (hi < 16777216.0f) n = min(n, (long long)sub(hi, lo) + 1);
  if (n <= 0) {                       // the first trip is already past hi
    if (tid == 0) out[row] = (long long)hi;
    return;
  }
  const long long nb = (n + kBlock - 1) / kBlock;
  if (tid < 2 * kChunk) eye[tid] = tid == kChunk ? ~0u : 0u;
  __syncthreads();
  unsigned own[kChunk];               // the chain warps' one-hot masks
  if (warp < 2) {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) own[i] = eye[kChunk + i - lane];
  }

  float run = 0.0f;                   // warp 0: logp; warp 1: cdf
  for (long long t = -1;; ++t) {
    int stop = 0;                     // warp 1 lane 0: this stage wrote the draw
    if (warp == 0) {
      if (t < 0) {
        // the start value log C(a, lo) + log C(b, k - lo) - log C(a + b, k),
        // log C(n, m) = lgamma(n + 1) - lgamma(m + 1) - lgamma(n - m + 1)
        // (ref.py log_comb): its nine log Gamma terms, one a lane
        const float x = sub(k, lo), ab = add(a, b);
        const float arg[9] = {a, lo, sub(a, lo), b, x, sub(b, x), ab, k, sub(ab, k)};
        float v = 0.0f;
#pragma unroll
        for (int i = 0; i < 9; ++i) v = lane == i ? arg[i] : v;
        if (lane < 9) lg[lane] = lgamma_xla(add(v, 1.0f));
      } else {
        if (t == 0) {
          float lc[3];
#pragma unroll
          for (int i = 0; i < 3; ++i) lc[i] = sub(sub(lg[3 * i], lg[3 * i + 1]), lg[3 * i + 2]);
          run = sub(add(lc[0], lc[1]), lc[2]);
        }
        float* lp = prob[t & (kProbSlots - 1)];
        chain<true>(ratio[t & (kRatioSlots - 1)], block_len(n, t), own, run,
                    [&](bool valid, int c, float logp) {
          if (valid) lp[c + lane] = logp;   // the logp trip c + lane starts from
        });
      }
    } else if (warp == 1) {
      const long long j = t - 2;
      if (j >= 0 && j < nb) {
        // the serial loop's stop at trip g: past n, past hi, or a cdf that
        // reached u. The chain runs the whole block; each lane notes the
        // first chunk where its own trip stops, and the least such trip,
        // one warp reduction a block, ends the row.
        // The test is written without short-circuits, so that it compiles
        // to predicated code the chain's adds can hide.
        int first = -1;
        const long long g0 = j * kBlock + lane;
        chain<false>(prob[j & (kProbSlots - 1)], block_len(n, j), own, run,
                     [&](bool valid, int c, float cdf) {
          const long long g = g0 + c;
          const bool st = (g >= n) | !(add(lo, (float)g) <= hi) | (cdf >= ut);
          first = (first < 0) & valid & st ? c : first;
        });
        const int f = __reduce_min_sync(0xffffffffu, first < 0 ? kBlock : first + lane);
        if (f < kBlock || j == nb - 1) {   // block nb - 1 ends at trip n: hi
          if (lane == 0) {
            const long long g = j * kBlock + f;
            const float s = add(lo, (float)g);
            out[row] = (long long)(f < kBlock && g < n && s <= hi ? s : hi);
            stop = 1;
          }
        }
      }
    } else {
      const int p = tid - 64;
      const int nl = block_len(n, t + 1), ne = block_len(n, t - 1);
      float* lr = ratio[(t + 1) & (kRatioSlots - 1)];
      float* ex = prob[(t - 1) & (kProbSlots - 1)];
      const long long g0 = (t + 1) * kBlock;
#pragma unroll
      for (int m = 0; m < (kBlock + kProducers - 1) / kProducers; ++m) {
        const int i = p + m * kProducers;
        if (i < nl) lr[i] = log_ratio(lo, a, k, bk, g0 + i);
        if (i < ne) ex[i] = expf(ex[i]);
      }
    }
    if (__syncthreads_or(stop)) break;   // every warp leaves after the same barrier
  }
}

unsigned blocks(long long T) { return (unsigned)((T + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int variates_binomial(void* out, const void* keys, const void* count, const void* p,
                                 long long T, void* stream) {
  if (T > 0)
    binomial_kernel<<<blocks(T), kThreads, 0, (cudaStream_t)stream>>>(
        (long long*)out, (const long long*)keys, (const long long*)count, (const float*)p, T);
  return (int)cudaGetLastError();
}

extern "C" int variates_hypergeometric(void* out, const void* u, const void* k, const void* a,
                                       const void* b, long long trips, long long T,
                                       void* stream) {
  if (T > 0x7fffffffLL) return (int)cudaErrorInvalidValue;   // a CTA a row
  if (T > 0)
    hypergeometric_kernel<<<(unsigned)T, kRowThreads, 0, (cudaStream_t)stream>>>(
        (long long*)out, (const float*)u, (const long long*)k, (const long long*)a,
        (const long long*)b, trips);
  return (int)cudaGetLastError();
}
