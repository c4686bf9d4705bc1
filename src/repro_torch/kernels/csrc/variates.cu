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
// Here each row is one thread that runs its loop to the end on the device,
// so a tick never syncs to the host.
//
//   H2 binomial_kernel: row t draws Bin(count[t], p[t]) from its key
//     keys[t] = (k0, k1), with JAX's algorithm: q = min(p, 1 - p), inversion
//     (a sum of geometric gaps, one uniform a trip) where count * q <= 10,
//     BTRS (transformed rejection with squeeze, two uniforms a trip) where
//     not, the result reflected to count - x where p >= 0.5. Trip i takes
//     Philox block (i, 0, 0, DRAW) of the row's key: inversion its word 0,
//     BTRS its words 0 and 1. p = 0, p = 1 and count <= 0 are answered
//     explicitly (0, count, 0; JAX's results), so a lost sign of zero can
//     never turn p = 1's inversion, which JAX ends only through
//     log1p(-0.0) = -0.0, into an endless loop. A NaN p gives -1.
//   H3 hypergeometric_kernel: row t draws HyperGeo(k, a, b) by inverse
//     transform from its operand uniform u[t]: a sequential f32 cdf over
//     the pmf-ratio recurrence from lo = max(0, k - b), stopping at the
//     first trip whose cdf reaches u (JAX's loop never changes its value
//     after that trip) or past hi = min(a, k), and at most `trips` trips
//     (JAX's max_support + 1); hi where the cdf never reached u.
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
// Bound: each is a serial loop in one thread a row, so neither bytes nor
// operations bound it on this card: its time is the dependent chain of one
// row's trips. The byte bound (the operands read once and the result
// written once) is what chip_smoke.py reports beside it. H3 at the main
// B-RS tick runs ~61,700 trips in one thread; a parallel design (lanes
// that evaluate the pmf terms ahead of one serial accumulation) is later
// work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 128;

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

__device__ __forceinline__ float log_comb(float n, float k) {
  return sub(sub(lgamma_xla(add(n, 1.0f)), lgamma_xla(add(k, 1.0f))),
             lgamma_xla(add(sub(n, k), 1.0f)));
}

__global__ void hypergeometric_kernel(long long* __restrict__ out, const float* __restrict__ u,
                                      const long long* __restrict__ kk,
                                      const long long* __restrict__ aa,
                                      const long long* __restrict__ bb, long long trips,
                                      long long T) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const float k = (float)kk[t], a = (float)aa[t], b = (float)bb[t], ut = u[t];
  const float lo = fmaxf(0.0f, sub(k, b));
  const float hi = fminf(a, k);
  float logp = sub(add(log_comb(a, lo), log_comb(b, sub(k, lo))), log_comb(add(a, b), k));
  float cdf = 0.0f, val = -1.0f;
  const float bk = sub(b, k);
  for (long long i = 0; i < trips; ++i) {
    const float s = add(lo, (float)i);
    if (!(s <= hi)) break;            // past the support: nothing changes any more
    cdf = add(cdf, expf(logp));
    if (cdf >= ut) {
      val = s;
      break;
    }
    const float num = mul(sub(a, s), sub(k, s));
    const float den = mul(add(s, 1.0f), add(add(bk, s), 1.0f));
    const float ratio = (num > 0.0f && den > 0.0f) ? dvd(num, den) : 1.0f;
    logp = add(logp, logf(ratio));
  }
  out[t] = (long long)(val < 0.0f ? hi : val);
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
  if (T > 0)
    hypergeometric_kernel<<<blocks(T), kThreads, 0, (cudaStream_t)stream>>>(
        (long long*)out, (const float*)u, (const long long*)k, (const long long*)a,
        (const long long*)b, trips, T);
  return (int)cudaGetLastError();
}
