// B4's bf16 route: flash attention on Hopper's tensor cores (wgmma), fed by a
// TMA ring in shared memory. The f32 route stays on the CUDA cores
// (flash_attention.cu); the wrapper picks the route by dtype.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_bhsd
// (its ops.flash_attention wrapper) for bfloat16 inputs. The function:
//
//     o[b, s, h] = sum_t softmax_t(q[b, s, h] . k[b, t, h / G] * hd^-1/2) v[b, t, h / G]
//
// over the keys t the masks keep: t <= s when causal, t > s - window when
// window > 0 (positions count from 0 in both sequences). Scores, the running
// max m and sum l, and the accumulator are f32; the probabilities are rounded
// to bf16 for the product with v (as the plain version rounds them); the
// output is acc / max(l, 1e-30) in bf16. A row that keeps no key is 0.
//
// Bound: operations. At the serving prefill's shape (q bf16 [8, 2048, 32,
// 160], k and v [8, 2048, 8, 160], causal) the two products need
// 4 * hd * B * H * S (S + 1) / 2 = 343.7 GFLOP against 420 MB of q, k, v and
// o: 0.35 ms at the tensor cores' bf16 rate, 0.13 ms at the memory's.
// The CUDA-core kernel's ceiling was the 67 TFLOP/s of f32 FMAs; this one's is
// the 989 TFLOP/s of bf16 wgmma.
//
// Design. One CTA of three warpgroups per (q tile of 128 rows, q head, batch),
// q tiles issued heaviest first under the causal mask:
//   * warpgroup 2, the producer, gives up registers (setmaxnreg.dec) and one
//     of its threads issues every TMA load: the q tile once, then key tiles
//     of 64 keys (k and v, each with its own "full" mbarrier) into a ring of
//     STAGES slots, each slot reused once its "empty" mbarrier has an arrival
//     from each of the 8 consumer warps;
//   * warpgroups 0 and 1, the consumers, take more registers
//     (setmaxnreg.inc) and own 64 q rows each. Per key tile: S = Q K^T by
//     wgmma m64n64k16 from shared memory (hd / 16 k-steps, f32 in 32
//     registers a thread); the masks only on tiles that cross the causal
//     diagonal, the window edge or the end of the keys; the online softmax
//     in registers (a row lives in one quad of threads: two shuffles for its
//     max); P rounded to bf16 in place, since the accumulator layout of each
//     16 keys is wgmma's register A layout; O += P V by wgmma m64nNPk16 with
//     A from registers and V from shared memory (NP = hd rounded up to 32,
//     NP / 2 f32 registers a thread).
// Shared-memory layouts, written by TMA and read by wgmma through
// descriptors: q and k tiles are K-major with the 128-byte swizzle, loaded as
// boxes of 64 head-dim columns; a head dim that is not a multiple of 64
// (160 = 64 + 64 + 32) gets a last box whose columns past hd are TMA's zero
// fill, and only the hd / 16 k-steps that hold data are issued, so QK^T does
// no padded work. v is MN-major (its head dim contiguous, the product's
// reduction over keys outermost) with the 64-byte swizzle in boxes of 32
// columns, so that every NP (a multiple of 32) spans whole swizzle atoms; the
// descriptor's transpose bit tells wgmma. Rows past S or T arrive as zeros
// and are masked (keys) or not stored (rows), so ragged shapes read nothing
// past a tensor. The tensor maps are built per call over q, k and v's own
// [B, S|T, H|KV, hd] strides, so views of a fused projection are read in
// place. Key tiles wholly outside a warpgroup's masks are not computed
// (tiles outside the whole CTA's are not loaded).
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;              // q rows per CTA: 64 per consumer warpgroup
constexpr int BN = 64;               // keys per tile
constexpr int THREADS = 384;         // two consumer warpgroups and the producer
constexpr int CONSUMER_WARPS = 8;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int NP>
struct Cfg {
  static constexpr int NB = (NP + 63) / 64;   // 64-column boxes of q and k
  static constexpr int NV = NP / 32;          // 32-column boxes of v
  static constexpr int KSTEPS = NP / 16;      // QK^T k-steps (cols >= hd are zeros)
  static constexpr int Q_BYTES = BM * NB * 128;
  static constexpr int K_BYTES = BN * NB * 128;
  static constexpr int V_BYTES = BN * NP * 2;
  static constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
  static constexpr int BAR_BYTES = 256;
  static constexpr int STAGES =
      1024 + Q_BYTES + 3 * STAGE_BYTES + BAR_BYTES <= 227 * 1024 ? 3 : 2;
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE_BYTES + BAR_BYTES;
  static_assert(SMEM <= 227 * 1024, "shared memory");
};

struct Params {
  __nv_bfloat16* o;   // [B, S, H, hd] contiguous
  int S, T, H, KV, hd, causal, window;
  float scale_log2;   // hd^-1/2 * log2(e)
};

template <int NP>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = Cfg<NP>;
  extern __shared__ uint8_t smem_raw[];
  // every tile starts on a 1024-byte boundary, where the swizzle patterns repeat
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;
  uint8_t* ring = smem + C::Q_BYTES;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(ring + C::STAGES * C::STAGE_BYTES);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + C::STAGES;
  uint64_t* empty = full_v + C::STAGES;

  const int nqt = (p.S + BM - 1) / BM;
  const int q0 = (nqt - 1 - static_cast<int>(blockIdx.x)) * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);

  // the key tiles the CTA visits: [kbeg, kend) in steps of BN
  int kbeg = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  kbeg = kbeg / BN * BN;
  const int kend = p.causal ? min(p.T, min(q0 + BM, p.S)) : p.T;
  const int ntiles = kend > kbeg ? (kend - kbeg + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
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
      mbar_expect_tx(bar_q, C::Q_BYTES);
      for (int cb = 0; cb < C::NB; ++cb)
        tma_load_4d(qs + cb * BM * 128, &tq, bar_q, cb * 64, q0, h, b);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % C::STAGES;
        const uint32_t ph = (j / C::STAGES) & 1;
        const int k0 = kbeg + j * BN;
        uint8_t* ks = ring + s * C::STAGE_BYTES;
        uint8_t* vs = ks + C::K_BYTES;
        mbar_wait(empty + s, ph ^ 1);   // a fresh slot passes at once
        mbar_expect_tx(full_k + s, C::K_BYTES);
        for (int cb = 0; cb < C::NB; ++cb)
          tma_load_4d(ks + cb * BN * 128, &tk, full_k + s, cb * 64, k0, kvh, b);
        mbar_expect_tx(full_v + s, C::V_BYTES);
        for (int vb = 0; vb < C::NV; ++vb)
          tma_load_4d(vs + vb * BN * 64, &tv, full_v + s, vb * 32, k0, kvh, b);
      }
    }
  } else {
    // ---- consumers ----
    setmaxnreg_inc<240>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int rlo = q0 + wg * 64;                 // the warpgroup's first row
    const int r0 = rlo + warp * 16 + lane / 4;    // this thread's rows: r0, r0 + 8
    const int cq = 2 * (lane % 4);                // its columns in each 8: cq, cq + 1
    // the warpgroup's keys: [kb, ke)
    const int kb = p.window > 0 ? max(0, rlo - p.window + 1) : 0;
    const int ke = rlo >= p.S ? 0 : (p.causal ? min(p.T, min(rlo + 64, p.S)) : p.T);

    float o[NP / 2];
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
    const uint8_t* qwg = qs + wg * 64 * 128;

    mbar_wait(bar_q, 0);
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % C::STAGES;
      const uint32_t ph = (j / C::STAGES) & 1;
      const int k0 = kbeg + j * BN;
      const uint8_t* ks = ring + s * C::STAGE_BYTES;
      const uint8_t* vs = ks + C::K_BYTES;
      // wait for the tile even when skipping it, so that this warp's arrival
      // on `empty` counts toward this use of the slot and no earlier one
      mbar_wait(full_k + s, ph);
      mbar_wait(full_v + s, ph);
      if (k0 < ke && k0 + BN > kb) {
        float sc[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < C::KSTEPS; ++kk) {
          const uint64_t da = smem_desc(qwg + (kk / 4) * BM * 128 + (kk % 4) * 32, 16, 1024, SW128);
          const uint64_t db = smem_desc(ks + (kk / 4) * BN * 128 + (kk % 4) * 32, 16, 1024, SW128);
          mma_m64n64k16_ss(sc, da, db, kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 32; ++i) fence_operand(sc[i]);

        const bool edge = k0 + BN > p.T || (p.causal && k0 + BN - 1 > rlo) ||
                          (p.window > 0 && k0 < rlo + 64 - p.window);
        if (edge) {
#pragma unroll
          for (int c = 0; c < 8; ++c) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
#pragma unroll
              for (int jj = 0; jj < 2; ++jj) {
                const int kpos = k0 + 8 * c + cq + jj, row = r0 + 8 * i;
                const bool keep = kpos < p.T && (!p.causal || kpos <= row) &&
                                  (p.window <= 0 || kpos > row - p.window);
                if (!keep) sc[4 * c + 2 * i + jj] = NEG;
              }
            }
          }
        }
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int c = 0; c < 8; ++c) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
            mx[i] = fmaxf(mx[i], fmaxf(sc[4 * c + 2 * i], sc[4 * c + 2 * i + 1]));
        }
        float corr[2], mb[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          corr[i] = ex2((m[i] - mx[i]) * p.scale_log2);
          m[i] = mx[i];
          // a row that has kept no key yet: its masked scores still give 0
          mb[i] = (mx[i] == NEG ? 0.f : mx[i]) * p.scale_log2;
        }
#pragma unroll
        for (int c = 0; c < 8; ++c) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const float e = ex2(fmaf(sc[4 * c + 2 * i + jj], p.scale_log2, -mb[i]));
              sc[4 * c + 2 * i + jj] = e;
              rs[i] += e;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
#pragma unroll
        for (int c = 0; c < NP / 8; ++c) {
          o[4 * c + 0] *= corr[0];
          o[4 * c + 1] *= corr[0];
          o[4 * c + 2] *= corr[1];
          o[4 * c + 3] *= corr[1];
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
          RS<NP>::mma(o, pa[kk], smem_desc(vs + kk * 16 * 64, BN * 64, 512, SW64));
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < NP / 2; ++i) fence_operand(o[i]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
    }

    // ---- epilogue: O / max(l, 1e-30) in bf16, plain stores ----
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const int row = r0 + 8 * i;
      if (row < p.S) {
        const float inv = 1.f / fmaxf(l[i], 1e-30f);
        __nv_bfloat16* orow = p.o + ((static_cast<long long>(b) * p.S + row) * p.H + h) * p.hd;
#pragma unroll
        for (int c = 0; c < NP / 8; ++c) {
          if (8 * c < p.hd)
            *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c + cq) =
                __floats2bfloat162_rn(o[4 * c + 2 * i] * inv, o[4 * c + 2 * i + 1] * inv);
        }
      }
    }
  }
}

// ---- host side ----------------------------------------------------------------
template <int NP>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                   const Params& p, int B, cudaStream_t stream) {
  const int smem = Cfg<NP>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_tc_kernel<NP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.S + BM - 1) / BM, p.H, B);
  flash_attention_tc_kernel<NP><<<grid, THREADS, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace

// q [B, S, H, hd], k and v [B, T, KV, hd], all bfloat16, through their
// (b, s, h) strides in elements with a unit stride in the head dim; o
// [B, S, H, hd] contiguous. Needs 8 <= hd <= 256 a multiple of 8, H % KV == 0,
// H and B at most 65,535, 16-byte-aligned bases and strides whose bytes are
// multiples of 16 (TMA's rules); the wrapper checks. Returns a cudaError_t or
// one of hopper.cuh's TC_NO_ENCODER / TC_ENCODE codes.
extern "C" int flash_attention_tc_fwd(const void* q, const void* k, const void* v, void* o,
                                      int B, int S, int Tk, int H, int KV, int hd,
                                      long long qsb, long long qss, long long qsh,
                                      long long ksb, long long kss, long long ksh,
                                      long long vsb, long long vss, long long vsh, int causal,
                                      int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  hopper::EncodeTiled enc = hopper::encode_tiled();
  if (enc == nullptr) return hopper::TC_NO_ENCODER;
  const int NP = (hd + 31) / 32 * 32;
  // q and k in boxes of 64 columns (128-byte rows), v in boxes of 32 (64-byte rows)
  CUtensorMap tq, tk, tv;
  CUresult r = hopper::make_map(enc, &tq, q, hd, S, H, B, qss, qsh, qsb, 64, BM,
                                CU_TENSOR_MAP_SWIZZLE_128B);
  if (r == CUDA_SUCCESS)
    r = hopper::make_map(enc, &tk, k, hd, Tk, KV, B, kss, ksh, ksb, 64, BN,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  if (r == CUDA_SUCCESS)
    r = hopper::make_map(enc, &tv, v, hd, Tk, KV, B, vss, vsh, vsb, 32, BN,
                         CU_TENSOR_MAP_SWIZZLE_64B);
  if (r != CUDA_SUCCESS) return hopper::TC_ENCODE + static_cast<int>(r);

  const Params p{static_cast<__nv_bfloat16*>(o), S, Tk, H, KV, hd, causal, window,
                 scale * LOG2E};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (NP / 32) {
    case 1: err = launch<32>(tq, tk, tv, p, B, st); break;
    case 2: err = launch<64>(tq, tk, tv, p, B, st); break;
    case 3: err = launch<96>(tq, tk, tv, p, B, st); break;
    case 4: err = launch<128>(tq, tk, tv, p, B, st); break;
    case 5: err = launch<160>(tq, tk, tv, p, B, st); break;
    case 6: err = launch<192>(tq, tk, tv, p, B, st); break;
    case 7: err = launch<224>(tq, tk, tv, p, B, st); break;
    case 8: err = launch<256>(tq, tk, tv, p, B, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
