// B5's bf16 route: the Mamba2 SSD chunked scan on Hopper's tensor cores
// (wgmma), fed by a TMA ring in shared memory. The f32 route stays on the
// CUDA cores (ssd_scan.cu); the wrapper picks the route by dtype.
//
// Replaces src/repro/kernels/ssd_scan/kernel.py::ssd_scan_bhsp (its
// ops.ssd_scan wrapper) for bfloat16 inputs. The function: for each (batch
// b, head h) with A = a[h] and group g = h / (H / G), over chunks of Q
// tokens, with dt, B, C, x the chunk's rows and cl_i = sum_{k <= i} dt_k A:
//
//     y_i   = sum_{j <= i} (C_i . B_j) exp(cl_i - cl_j) dt_j x_j
//             + exp(cl_i) C_i . state
//     state = exp(cl_(Q-1)) state + sum_j exp(cl_(Q-1) - cl_j) dt_j B_j^T x_j
//
// state [N, P] f32 starts at init (or zeros) and is carried from chunk to
// chunk; y is cast to bf16 once, the final state is written in f32. Products
// take bf16 operands and f32 sums; three roundings to bf16 are the design's
// own: the decayed scores S, w_j x_j (w_j = exp(cl_(Q-1) - cl_j) dt_j), and
// y. The chunk's snapshot of the state, the inter-chunk term's operand, is
// split into two bf16 (hi + lo, off by ~2^-16 of the state): the state is of
// low rank after a chunk's decay, so C_i . state cancels as C_i . B_j does,
// and one bf16 snapshot's rounding, not cancelling with it, put single rows
// 2.3e-2 of their norm off the f32 recurrence.
//
// Bound: bytes. At the serving prefill's shape (x bf16 [4, 32768, 32, 64],
// B and C bf16 [4, 32768, 1, 128], Q 256) the function must move 1.162 GB
// (0.347 ms at 3.35 TB/s) and needs 211 GFLOP with C B^T once a group
// (0.213 ms at the bf16 tensor cores' 989 TFLOP/s). This kernel computes
// C B^T once a head and the inter-chunk term twice (hi and lo): 464 GFLOP of
// wgmma, 0.47 ms at that rate.
//
// Design. One CTA of three warpgroups per (head, batch) walks the chunks in
// order, the state never leaving the SM:
//   * warpgroup 2, the producer, gives up registers (setmaxnreg.dec) and one
//     of its threads issues every TMA load: per chunk, tiles t < nt =
//     ceil(Q / 64) of 64 rows, each a stage of the ring (C, B and x of rows
//     s0 + 64 t ..), each stage reused once its "empty" mbarrier has an
//     arrival from each of the 8 consumer warps;
//   * warpgroups 0 and 1, the consumers (setmaxnreg.inc), share the chunk's
//     query tiles causally balanced (nt 4: {0, 3} and {1, 2}, five tile
//     pairs each). Per query tile I: y = C_I (hi + lo)^T (wgmma, both
//     K-major, K = N), its rows scaled by exp(cl_i); then for each key tile
//     J <= I: S = C_I B_J^T (wgmma m64n64k16, 4 k-steps a box of N), the decay
//     and dt applied in f32, S rounded to bf16 in place (the accumulator
//     layout of each 16 keys is wgmma's register A layout) and y += S x_J
//     (wgmma, x MN-major). On the diagonal tile the factor is
//     exp(cl_i - cl_j) dt_j on j <= i and 0 above (a select, never a
//     product: the upper triangle's exp overflows); below it, it is
//     exp(cl_i - r_J) * (exp(r_J - cl_j) dt_j) with r_J the cl of tile J's
//     last row, both factors <= 1: two exps a row per tile instead of one
//     an element, the key factors made once a chunk.
//   * The state: warpgroup w holds state^T [P x 64] for N columns 64 w .. in
//     f32 registers for the whole walk (the accumulator of
//     state^T += (w x_J)^T B_J: A = x_J transposed by ldmatrix, scaled by w
//     and rounded to bf16, B = B_J read MN-major). A key tile's update runs
//     right after its last use by the warpgroup's last query tile, so its
//     stage is released early and the next chunk's tiles stream in.
//   * Per chunk the consumers meet at three named barriers: the snapshot
//     (state^T as bf16 hi and lo, the 128-byte swizzle written by hand,
//     fenced to the async proxy) and cl, dt, w and the key factors (one row
//     a thread, dt prefetched a chunk ahead) are made between them.
// Shared memory at N 128, P 64: four stages of 40 KB (C and B 16 KB each,
// x 8 KB), the 32 KB snapshot, 4 KB of per-row vectors and 1 KB of
// alignment slack: 197 KB of the 227 a CTA may have. A whole chunk is four
// stages: a tile's stage takes the next chunk's tile as soon as both
// warpgroups have released it, so the next chunk streams in while this one
// finishes. C and B load as boxes of 64 N columns with the 128-byte swizzle
// (N <= 64: one box), x as boxes of 32 P columns with the 64-byte swizzle
// (NP = P rounded up to 32); columns past N or P arrive as TMA's zeros, so
// the products over N run whole boxes (a branch around a wgmma would
// serialize them). A tile of a ragged chunk (Q not a multiple of 64) runs
// into the next chunk's rows: those keys get w = 0 and fall outside j <= i,
// and those y rows are not written. x, B and C are read through their own
// strides (views of the conv output); dt through its strides by plain loads
// (a stride of H floats a token, which a TMA box cannot take).
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int TILE = 64;           // rows of a C, B or x tile
constexpr int QMAX = 256;          // the longest chunk: 4 tiles, one row a consumer thread
constexpr int THREADS = 384;       // two consumer warpgroups and the producer
constexpr int CONSUMERS = 256;
constexpr int CONSUMER_WARPS = 8;
constexpr int BAR_CHUNK = 1;       // the consumers' named barrier
constexpr float LOG2E = 1.4426950408889634f;

// NBX: 64-column boxes of N (1 or 2); NP: P rounded up to 32 (32 or 64)
template <int NBX, int NP>
struct Cfg {
  static constexpr int CB_BYTES = TILE * NBX * 128;   // a C or B tile
  static constexpr int X_BYTES = TILE * NP * 2;        // an x tile
  static constexpr int STAGE_BYTES = 2 * CB_BYTES + X_BYTES;
  static constexpr int SNAP_BYTES = TILE * NBX * 128;  // state^T [64 rows of P][N] bf16
  static constexpr int VEC_BYTES = (4 * QMAX + 8) * 4; // cl, dt, w, key factors; warp sums
  static constexpr int BAR_BYTES = 256;
  static constexpr int FIXED = 1024 + 2 * SNAP_BYTES + VEC_BYTES + BAR_BYTES;
  static constexpr int FIT = (227 * 1024 - FIXED) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int SMEM = FIXED + STAGES * STAGE_BYTES;
  static_assert(STAGES >= QMAX / TILE, "a whole chunk's tiles must fit the ring");
  static_assert(2 * STAGES * 8 <= BAR_BYTES, "mbarriers");
};

struct Params {
  const float* dt;     // [B, S, H] through its strides
  const float* a;      // [H]
  const float* init;   // [B, H, N, P] contiguous, or null (zeros)
  __nv_bfloat16* y;    // [B, S, H, P] contiguous
  float* state;        // [B, H, N, P] contiguous
  int S, H, G, N, P, Q;
  long long dsb, dss, dsh;
};

// y (+)= A B: N = 32 or 64 columns, both operands K-major in shared memory
__device__ __forceinline__ void mma_ss(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  mma_m64n32k16_ss(d, a, b, acc);
}
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  mma_m64n64k16_ss(d, a, b, acc);
}

// two floats as bf16x2 hi and the bf16x2 of what hi misses, lo
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(a, b);
  const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  lo = pack_bf16(a - h.x, b - h.y);
}

// a bf16x2 of two keys, each times its w, rounded back to bf16x2
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float lo, float hi) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return pack_bf16(f.x * lo, f.y * hi);
}

// A = (w x_J)^T for the state's update, from registers: x_J transposed by
// ldmatrix (rows p; 16 keys a k-step), each key times its w (wj: the
// tile's) and rounded to bf16. Rows p >= NP are zeros.
template <int NP>
__device__ __forceinline__ void load_wx(uint32_t (&xa)[4][4], const uint8_t* xj,
                                        const float* wj, int warp, int lane) {
  const int cq = 2 * (lane % 4);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (warp * 16 < NP) {
      // lanes 8m .. 8m + 7: the rows (keys) of matrix m, 8 p columns each
      const int m = lane / 8;
      const int key = kk * 16 + (m >> 1) * 8 + lane % 8;
      const int pc = warp * 16 + (m & 1) * 8;
      ldmatrix_x4_trans(xa[kk], xj + (pc / 32) * TILE * 64 + key * 64 +
                                    ((((pc % 32) / 8) ^ ((key >> 1) & 3)) << 4));
      const float2 w0 = *reinterpret_cast<const float2*>(wj + kk * 16 + cq);
      const float2 w8 = *reinterpret_cast<const float2*>(wj + kk * 16 + cq + 8);
      xa[kk][0] = scale_bf16x2(xa[kk][0], w0.x, w0.y);
      xa[kk][1] = scale_bf16x2(xa[kk][1], w0.x, w0.y);
      xa[kk][2] = scale_bf16x2(xa[kk][2], w8.x, w8.y);
      xa[kk][3] = scale_bf16x2(xa[kk][3], w8.x, w8.y);
    } else {
      xa[kk][0] = xa[kk][1] = xa[kk][2] = xa[kk][3] = 0u;
    }
  }
}

// state^T += (w x_J)^T B_J over warpgroup wg's 64 N columns (the
// accumulator st); B is B_J's box wg read MN-major. Issued inside the
// caller's wgmma group.
__device__ __forceinline__ void state_mma(float (&st)[32], const uint32_t (&xa)[4][4],
                                          const uint8_t* bj, int wg) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    RS<64>::mma(st, xa[kk],
                smem_desc(bj + wg * TILE * 128 + kk * 16 * 128, TILE * 128, 1024, SW128));
}

// S = C_I B_J^T into sc (one wgmma group, committed), K = the boxes of N
template <int NBX>
__device__ __forceinline__ void scores_mma(float (&sc)[32], const uint8_t* ci, const uint8_t* bj) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NBX * 4; ++kk)
    mma_m64n64k16_ss(sc, smem_desc(ci + (kk / 4) * TILE * 128 + (kk % 4) * 32, 16, 1024, SW128),
                     smem_desc(bj + (kk / 4) * TILE * 128 + (kk % 4) * 32, 16, 1024, SW128),
                     kk > 0);
  wgmma_commit();
}

// this warp's arrival on a stage's "empty" mbarrier, once its reads are done
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

template <int NBX, int NP>
__global__ void __launch_bounds__(THREADS, 1)
ssd_scan_tc_kernel(const __grid_constant__ CUtensorMap tc, const __grid_constant__ CUtensorMap tb,
                   const __grid_constant__ CUtensorMap tx, const Params p) {
  using C = Cfg<NBX, NP>;
  extern __shared__ uint8_t smem_raw[];
  // every tile starts on a 1024-byte boundary, where the swizzle patterns repeat
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem;
  uint8_t* snap = ring + C::STAGES * C::STAGE_BYTES;   // hi, then lo
  float* cl = reinterpret_cast<float*>(snap + 2 * C::SNAP_BYTES);
  float* dts = cl + QMAX;
  float* ws = dts + QMAX;
  float* ek = ws + QMAX;      // exp(r_J - cl_j) dt_j: the key factors below the diagonal
  float* wsum = ek + QMAX;
  uint64_t* full = reinterpret_cast<uint64_t*>(wsum + 8);
  uint64_t* empty = full + C::STAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (p.H / p.G);
  const int Q = p.Q;
  const int nt = (Q + TILE - 1) / TILE;
  const int nchunks = p.S / Q;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      int k = 0;   // tiles issued so far
      for (int c = 0; c < nchunks; ++c) {
        for (int t = 0; t < nt; ++t, ++k) {
          const int s = k % C::STAGES;
          const uint32_t ph = (k / C::STAGES) & 1;
          const int row = c * Q + t * TILE;
          uint8_t* cs = ring + s * C::STAGE_BYTES;
          mbar_wait(empty + s, ph ^ 1);   // a fresh stage passes at once
          mbar_expect_tx(full + s, C::STAGE_BYTES);
          for (int cb = 0; cb < NBX; ++cb) {
            tma_load_4d(cs + cb * TILE * 128, &tc, full + s, cb * 64, row, g, b);
            tma_load_4d(cs + C::CB_BYTES + cb * TILE * 128, &tb, full + s, cb * 64, row, g, b);
          }
          for (int xb = 0; xb < NP / 32; ++xb)
            tma_load_4d(cs + 2 * C::CB_BYTES + xb * TILE * 64, &tx, full + s, xb * 32, row, h, b);
        }
      }
    }
  } else {
    // ---- consumers ----
    setmaxnreg_inc<240>();
    const int ct = threadIdx.x;                  // 0 .. 255: the scan's row
    const int t = ct % 128, warp = t / 32, lane = t % 32;
    const int rw = warp * 16 + lane / 4;         // this thread's rows of a tile: rw, rw + 8
    const int cq = 2 * (lane % 4);               // its columns in each 8: cq, cq + 1
    const bool half = wg < NBX;                  // the warpgroup holds N columns 64 wg ..
    const long long sbase = ((long long)b * p.H + h) * p.N * p.P;

    // the query tiles of this warpgroup, in order (t0, then t1)
    int t0 = -1, t1 = -1;
    if (nt == 4) {
      t0 = wg ? 1 : 0;
      t1 = wg ? 2 : 3;
    } else if (nt == 3) {
      if (wg) {
        t0 = 0;
        t1 = 1;
      } else {
        t0 = 2;
      }
    } else if (nt == 2) {
      t0 = wg ? 0 : 1;
    } else if (wg == 0) {
      t0 = 0;
    }
    const int ilast = t1 >= 0 ? t1 : t0;

    // state^T of this warpgroup's N columns: st[4c + 2i + j] is p = rw + 8i,
    // n = 64 wg + 8c + cq + j
    float st[32];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int pp = rw + 8 * i, nn = 64 * wg + 8 * c + cq + j;
          st[4 * c + 2 * i + j] = (p.init && half && pp < p.P && nn < p.N)
                                      ? p.init[sbase + (long long)nn * p.P + pp]
                                      : 0.f;
        }
      }
    }

    const float A = p.a[h];
    const float* dtp = p.dt + b * p.dsb + h * p.dsh;
    float dnext = ct < Q ? dtp[(long long)ct * p.dss] : 0.f;

    for (int c = 0; c < nchunks; ++c) {
      const int s0 = c * Q;
      const int kbase = c * nt;   // ring index of the chunk's tile 0
      named_barrier_sync(BAR_CHUNK, CONSUMERS);   // the last chunk's reads are done

      // the snapshot: state^T as bf16 hi + lo, K-major (N contiguous), 128-byte swizzle
      if (half) {
        uint8_t* box = snap + wg * TILE * 128;
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int pp = rw + 8 * i;
            uint32_t* at =
                reinterpret_cast<uint32_t*>(box + pp * 128 + ((cc ^ (pp & 7)) << 4) + 2 * cq);
            split_bf16x2(st[4 * cc + 2 * i], st[4 * cc + 2 * i + 1], at[0],
                         at[C::SNAP_BYTES / 4]);
          }
        }
      }
      fence_proxy_async();

      // dt, and cl = the inclusive cumsum of dt * A over the chunk
      const float d = dnext;
      if (c + 1 < nchunks) dnext = ct < Q ? dtp[(long long)(s0 + Q + ct) * p.dss] : 0.f;
      float v = d * A;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      if (lane == 31) wsum[ct / 32] = v;
      named_barrier_sync(BAR_CHUNK, CONSUMERS);
      // total: cl_(Q-1) (rows past Q add 0); last: r_J, the cl of the last
      // row of this thread's tile, summed in the order that row's thread sums it
      float before = 0.f, total = 0.f, last = 0.f;
#pragma unroll
      for (int w8 = 0; w8 < CONSUMER_WARPS; ++w8) {
        const float s = wsum[w8];
        if (w8 < ct / 32) before += s;
        if (w8 == (ct / 64) * 2 + 1) last = total + s;
        total += s;
      }
      v += before;
      cl[ct] = v;
      dts[ct] = d;
      ws[ct] = ct < Q ? ex2((total - v) * LOG2E) * d : 0.f;
      ek[ct] = ex2((last - v) * LOG2E) * d;
      const float decay = ex2(total * LOG2E);
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] *= decay;
      named_barrier_sync(BAR_CHUNK, CONSUMERS);   // cl, dt, w and the snapshot are written

      // Per query tile I: y = the inter-chunk term (issued with the first
      // pair's S), then per key tile J <= I the pair's products, each wgmma
      // group waited for before the next. (Batching a pair's y += S x_J and
      // update with the next pair's S, to wait once a pair, ran slower on
      // the H100.)
      for (int q = 0; q < 2; ++q) {
        const int I = q == 0 ? t0 : t1;
        if (I < 0) break;
        const bool last = I == ilast;
        const uint8_t* ci = ring + ((kbase + I) % C::STAGES) * C::STAGE_BYTES;
        mbar_wait(full + (kbase + I) % C::STAGES, ((kbase + I) / C::STAGES) & 1);
        mbar_wait(full + kbase % C::STAGES, (kbase / C::STAGES) & 1);

        // y = C_I . state (the snapshot, hi + lo), and S = C_I B_0^T
        float y[NP / 2], sc[32];
        wgmma_fence();
#pragma unroll
        for (int part = 0; part < 2; ++part) {
#pragma unroll
          for (int kk = 0; kk < NBX * 4; ++kk)
            mma_ss(y, smem_desc(ci + (kk / 4) * TILE * 128 + (kk % 4) * 32, 16, 1024, SW128),
                   smem_desc(snap + part * C::SNAP_BYTES + (kk / 4) * TILE * 128 + (kk % 4) * 32,
                             16, 1024, SW128),
                   part + kk > 0);
        }
        wgmma_commit();
        scores_mma<NBX>(sc, ci, ring + (kbase % C::STAGES) * C::STAGE_BYTES + C::CB_BYTES);
        wgmma_wait<1>();
#pragma unroll
        for (int i = 0; i < NP / 2; ++i) fence_operand(y[i]);
        // y_i = exp(cl_i) C_i . state
        const float cli[2] = {cl[I * TILE + rw], cl[I * TILE + rw + 8]};
        const float ei[2] = {ex2(cli[0] * LOG2E), ex2(cli[1] * LOG2E)};
#pragma unroll
        for (int cc = 0; cc < NP / 8; ++cc) {
          y[4 * cc + 0] *= ei[0];
          y[4 * cc + 1] *= ei[0];
          y[4 * cc + 2] *= ei[1];
          y[4 * cc + 3] *= ei[1];
        }

        for (int J = 0; J <= I; ++J) {
          const int sj = (kbase + J) % C::STAGES;
          const uint8_t* bj = ring + sj * C::STAGE_BYTES + C::CB_BYTES;
          const uint8_t* xj = bj + C::CB_BYTES;
          if (J > 0) {
            mbar_wait(full + sj, ((kbase + J) / C::STAGES) & 1);
            scores_mma<NBX>(sc, ci, bj);
          }
          wgmma_wait<0>();
#pragma unroll
          for (int i = 0; i < 32; ++i) fence_operand(sc[i]);
          if (J == I) {
#pragma unroll
            for (int cc = 0; cc < 8; ++cc) {
#pragma unroll
              for (int jj = 0; jj < 2; ++jj) {
                const int kc = 8 * cc + cq + jj;
                const float clj = cl[J * TILE + kc], dj = dts[J * TILE + kc];
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                  float& v = sc[4 * cc + 2 * i + jj];
                  v = kc <= rw + 8 * i ? v * ex2((cli[i] - clj) * LOG2E) * dj : 0.f;
                }
              }
            }
          } else {
            const float rj = cl[J * TILE + TILE - 1];
            const float er[2] = {ex2((cli[0] - rj) * LOG2E), ex2((cli[1] - rj) * LOG2E)};
#pragma unroll
            for (int cc = 0; cc < 8; ++cc) {
              const float2 e = *reinterpret_cast<const float2*>(ek + J * TILE + 8 * cc + cq);
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                sc[4 * cc + 2 * i] *= er[i] * e.x;
                sc[4 * cc + 2 * i + 1] *= er[i] * e.y;
              }
            }
          }
          uint32_t pa[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
            pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
            pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
            pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
          }
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            RS<NP>::mma(y, pa[kk], smem_desc(xj + kk * 16 * 64, TILE * 64, 512, SW64));
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int i = 0; i < NP / 2; ++i) fence_operand(y[i]);
          if (last) {
            if (half) {
              uint32_t xa[4][4];
              load_wx<NP>(xa, xj, ws + J * TILE, warp, lane);
              wgmma_fence();
              state_mma(st, xa, bj, wg);
              wgmma_commit();
              wgmma_wait<0>();
#pragma unroll
              for (int i = 0; i < 32; ++i) fence_operand(st[i]);
            }
            release(empty + sj, lane);
          }
        }
        // the y rows of the chunk, bf16
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = I * TILE + rw + 8 * i;
          if (r < Q) {
            __nv_bfloat16* yr = p.y + (((long long)b * p.S + s0 + r) * p.H + h) * p.P;
#pragma unroll
            for (int cc = 0; cc < NP / 8; ++cc) {
              if (8 * cc < p.P)
                *reinterpret_cast<__nv_bfloat162*>(yr + 8 * cc + cq) =
                    __floats2bfloat162_rn(y[4 * cc + 2 * i], y[4 * cc + 2 * i + 1]);
            }
          }
        }
      }

      // the key tiles past the last query tile: their update only
      for (int J = ilast + 1; J < nt; ++J) {
        const int sj = (kbase + J) % C::STAGES;
        const uint8_t* bj = ring + sj * C::STAGE_BYTES + C::CB_BYTES;
        mbar_wait(full + sj, ((kbase + J) / C::STAGES) & 1);
        if (half) {
          uint32_t xa[4][4];
          load_wx<NP>(xa, bj + C::CB_BYTES, ws + J * TILE, warp, lane);
          wgmma_fence();
          state_mma(st, xa, bj, wg);
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int i = 0; i < 32; ++i) fence_operand(st[i]);
        }
        release(empty + sj, lane);
      }
    }

    // the final state, f32 [N, P]
    if (half) {
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int pp = rw + 8 * i, nn = 64 * wg + 8 * cc + cq + j;
            if (pp < p.P && nn < p.N)
              p.state[sbase + (long long)nn * p.P + pp] = st[4 * cc + 2 * i + j];
          }
        }
      }
    }
  }
}

// ---- host side ----------------------------------------------------------------
template <int NBX, int NP>
cudaError_t launch(const CUtensorMap& tc, const CUtensorMap& tb, const CUtensorMap& tx,
                   const Params& p, int B, cudaStream_t stream) {
  const int smem = Cfg<NBX, NP>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_tc_kernel<NBX, NP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ssd_scan_tc_kernel<NBX, NP><<<dim3(p.H, B), THREADS, smem, stream>>>(tc, tb, tx, p);
  return cudaGetLastError();
}

}  // namespace

// x [B, S, H, P] and B, C [B, S, G, N], all bfloat16, through their
// (b, s, h|g) strides in elements with a unit stride in the last dim; dt
// [B, S, H] f32 through its strides; a [H] f32; init [B, H, N, P] f32
// contiguous or null; y [B, S, H, P] bf16 and state [B, H, N, P] f32
// contiguous. Needs 1 <= Q <= 256 dividing S, N and P multiples of 8 in
// [8, 128] and [8, 64], H % G == 0, B <= 65,535, and 16-byte-aligned bases
// and strides whose bytes are multiples of 16 (TMA's rules); the wrapper
// checks. Returns a cudaError_t or one of hopper.cuh's TC_NO_ENCODER /
// TC_ENCODE codes.
extern "C" int ssd_scan_tc_fwd(const void* x, const void* dt, const void* a, const void* bm,
                               const void* cm, const void* init, void* y, void* state, int B,
                               int S, int H, int G, int N, int P, int Q, long long xsb,
                               long long xss, long long xsh, long long dsb, long long dss,
                               long long dsh, long long bsb, long long bss, long long bsg,
                               long long csb, long long css, long long csg, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (Q < 1 || Q > QMAX || S % Q || N < 8 || N > 128 || N % 8 || P < 8 || P > 64 || P % 8 ||
      G < 1 || H % G)
    return static_cast<int>(cudaErrorInvalidValue);
  hopper::EncodeTiled enc = hopper::encode_tiled();
  if (enc == nullptr) return hopper::TC_NO_ENCODER;
  // C and B in boxes of 64 N columns (128-byte rows), x in boxes of 32 P columns
  CUtensorMap tc, tb, tx;
  CUresult r = hopper::make_map(enc, &tc, cm, N, S, G, B, css, csg, csb, 64, TILE,
                                CU_TENSOR_MAP_SWIZZLE_128B);
  if (r == CUDA_SUCCESS)
    r = hopper::make_map(enc, &tb, bm, N, S, G, B, bss, bsg, bsb, 64, TILE,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  if (r == CUDA_SUCCESS)
    r = hopper::make_map(enc, &tx, x, P, S, H, B, xss, xsh, xsb, 32, TILE,
                         CU_TENSOR_MAP_SWIZZLE_64B);
  if (r != CUDA_SUCCESS) return hopper::TC_ENCODE + static_cast<int>(r);

  const Params p{static_cast<const float*>(dt), static_cast<const float*>(a),
                 static_cast<const float*>(init), static_cast<__nv_bfloat16*>(y),
                 static_cast<float*>(state), S, H, G, N, P, Q, dsb, dss, dsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (N > 64)
    err = P > 32 ? launch<2, 64>(tc, tb, tx, p, B, st) : launch<2, 32>(tc, tb, tx, p, B, st);
  else
    err = P > 32 ? launch<1, 64>(tc, tb, tx, p, B, st) : launch<1, 32>(tc, tb, tx, p, B, st);
  return static_cast<int>(err);
}
