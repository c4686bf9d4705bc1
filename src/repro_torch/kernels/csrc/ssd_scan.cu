// B5: the Mamba2 SSD chunked scan, the prefill's sequence mixer, on the CUDA
// cores: B5's f32 route. bf16 calls go to the tensor-core kernel
// (ssd_scan_tc.cu).
//
// Replaces src/repro/kernels/ssd_scan/kernel.py::ssd_scan_bhsp (its
// ops.ssd_scan wrapper). The function, not its blocks: for each (batch b,
// head h) with A = a[h] and group g = h / (H / G), over chunks of Q tokens,
// with dt, B, C, x the chunk's rows and cl_i = sum_{k <= i} dt_k A (f32):
//
//     y_i   = sum_{j <= i} (C_i . B_j) exp(cl_i - cl_j) dt_j x_j
//             + exp(cl_i) C_i . state
//     state = exp(cl_(Q-1)) state + sum_j exp(cl_(Q-1) - cl_j) dt_j B_j^T x_j
//
// state [N, P] f32 starts at init (or zeros) and is carried from chunk to
// chunk; y and the final state are written in f32.
// The upper triangle (j > i) is never computed into a product: there
// exp(cl_i - cl_j) is exp of a positive number and overflows to inf over a
// chunk of the model's decay, so it is selected away, never multiplied by 0.
//
// Bound: operations. At the f32 shape of chip_smoke.py's recurrence check
// (x [1, 512, 8, 64], B and C [1, 512, 2, 128], Q 256) the function needs
// 0.235 GFLOP, 3.5 us at the f32 CUDA cores' 67 TFLOP/s, against 3.4 MB
// (1.0 us at 3.35 TB/s). Its tolerance against the recurrence (1e-3) rules
// out bf16 or TF32 operands, so f32 stays on the CUDA cores.
//
// Design (right and simple first): one CTA of 256 threads per (head, batch) walks the chunks in order,
// as the TPU grid (BH, nc) does, with the [N, P] state in shared memory
// (N padded to 128, P to 64). Per chunk: dt and cl by a block scan; then for
// each query tile of 64 rows, the causal key tiles J <= I: the 64 x 64
// scores C_I B_J^T by a 4 x 4 register tile a thread, decay and dt applied
// and the upper triangle selected to 0, staged transposed in shared memory,
// then y_I += S_IJ x_J by another 4 x 4 tile a thread; then the inter-chunk
// term from the state and the y rows written. A barrier separates the last
// read of the state from its update, which each thread does for its 8 x 4
// slice of [N, P] over the chunk's key tiles. The [Q, Q] score block (256 KB
// in f32 at Q 256) is never materialized: only one 64 x 64 tile pair. All
// arithmetic is f32 FMA and expf on the CUDA cores. x, B, C and dt are read
// through their strides in the model layout ([B, S, H, P], [B, S, G, N],
// [B, S, H]; the last dim of x, B, C unit stride), so the wrapper makes no
// transposed copies; y is a new contiguous [B, S, H, P]. One CTA a (b, h).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;           // rows of a query or key tile
constexpr int NMAX = 128;          // state size N, padded
constexpr int PMAX = 64;           // head dim P, padded
constexpr int QMAX = 256;          // chunk length (== THREADS: one row a thread in the scan)
constexpr int LDT = TILE + 4;      // row stride of the transposed [n][row] tiles
constexpr int SMEM_FLOATS = NMAX * PMAX + 2 * QMAX + 2 * NMAX * LDT + 2 * TILE * PMAX;
// the thread tiles cover 64 rows x 64 columns (4 x 4 each) and 128 x 64 of
// the state (8 x 4 each) with 16 x 16 threads; the scan takes one row a thread
static_assert(THREADS == 256 && TILE == 64 && PMAX == 64 && NMAX == 128 && QMAX == THREADS,
              "tile shapes");

struct Args {
  const float* x;
  const float* dt;
  const float* a;
  const float* bm;
  const float* cm;
  const float* init;   // [B, H, N, P] or null (zeros)
  float* y;            // [B, S, H, P] contiguous
  float* state;        // [B, H, N, P] contiguous
  int S, H, G, N, P, Q;
  long long xsb, xss, xsh;   // strides in elements; p has unit stride
  long long dsb, dss, dsh;
  long long bsb, bss, bsg;   // n has unit stride
  long long csb, css, csg;
};

// rows [row0, row0 + rows) of src (row stride rs, n unit stride) into
// dst[n][r] (row stride LDT), zeros past rows and N
__device__ __forceinline__ void stage_transposed(float* dst, const float* src, long long rs,
                                                 int row0, int rows, int N) {
  for (int e = threadIdx.x; e < TILE * NMAX; e += THREADS) {
    const int r = e / NMAX, n = e - r * NMAX;
    dst[n * LDT + r] =
        (r < rows && n < N) ? src[(long long)(row0 + r) * rs + n] : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS, 1) ssd_scan_kernel(Args p) {
  extern __shared__ float4 smem4[];
  __shared__ float wsum[THREADS / 32];
  float* st = reinterpret_cast<float*>(smem4);   // [NMAX][PMAX] the carried state
  float* cl = st + NMAX * PMAX;                  // [QMAX] cumulative dt * A
  float* dts = cl + QMAX;                        // [QMAX] dt
  float* ct = dts + QMAX;                        // [NMAX][LDT] C of the query tile
  float* bt = ct + NMAX * LDT;                   // [NMAX][LDT] B of the key tile;
                                                 // [TILE][NMAX] in the state update
  float* xs = bt + NMAX * LDT;                   // [TILE][PMAX] x (w-scaled in the update)
  float* ss = xs + TILE * PMAX;                  // [TILE][TILE] scores, [j][i]

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (p.H / p.G);
  const int tid = threadIdx.x;
  const int N = p.N, P = p.P, Q = p.Q;
  const float A = p.a[h];
  const float* x = p.x + b * p.xsb + h * p.xsh;
  const float* dt = p.dt + b * p.dsb + h * p.dsh;
  const float* bg = p.bm + b * p.bsb + g * p.bsg;
  const float* cg = p.cm + b * p.csb + g * p.csg;
  float* y = p.y + ((long long)b * p.S * p.H + h) * P;
  const long long yrs = (long long)p.H * P;
  const long long sbase = ((long long)b * p.H + h) * N * P;

  for (int e = tid; e < NMAX * PMAX; e += THREADS) {
    const int n = e / PMAX, q = e - n * PMAX;
    st[e] = (p.init && n < N && q < P) ? p.init[sbase + n * P + q] : 0.f;
  }

  const int lane = tid & 31, warp = tid >> 5;
  const int r4 = (tid / 16) * 4;    // y tile: query rows
  const int c4 = (tid % 16) * 4;    // y tile and state slice: P columns
  const int si4 = (tid % 16) * 4;   // score tile: query rows
  const int sj4 = (tid / 16) * 4;   // score tile: key rows
  const int n8 = (tid / 16) * 8;    // state slice: N rows
  const int ntiles = (Q + TILE - 1) / TILE;

  for (int c = 0; c < p.S / Q; ++c) {
    const int s0 = c * Q;
    __syncthreads();   // the previous chunk's state update and cl reads are done

    // dt and cl = inclusive cumsum of dt * A over the chunk (one row a thread)
    {
      const float d = tid < Q ? dt[(long long)(s0 + tid) * p.dss] : 0.f;
      float v = d * A;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      if (lane == 31) wsum[warp] = v;
      __syncthreads();
      for (int w = 0; w < warp; ++w) v += wsum[w];
      cl[tid] = v;
      dts[tid] = d;
    }

    for (int it = 0; it < ntiles; ++it) {
      const int i0 = it * TILE;
      __syncthreads();   // cl and dts written; ct, bt, xs, ss free
      stage_transposed(ct, cg, p.css, s0 + i0, min(TILE, Q - i0), N);
      float acc[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;

      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * TILE;
        const int jrows = min(TILE, Q - j0);
        stage_transposed(bt, bg, p.bss, s0 + j0, jrows, N);
        for (int e = tid; e < TILE * PMAX; e += THREADS) {
          const int r = e / PMAX, q = e - r * PMAX;
          xs[e] = (r < jrows && q < P) ? x[(long long)(s0 + j0 + r) * p.xss + q] : 0.f;
        }
        __syncthreads();

        // scores C_I B_J^T: rows si4.., keys sj4..
        float s[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) s[u][v] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          const float4 cv = *reinterpret_cast<const float4*>(ct + n * LDT + si4);
          const float4 bv = *reinterpret_cast<const float4*>(bt + n * LDT + sj4);
          const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
          const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) s[u][v] = fmaf(cr[u], br[v], s[u][v]);
        }
        // decay and dt on j <= i, 0 elsewhere (a select); stored as ss[j][i]
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int j = j0 + sj4 + v;
          float o[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = i0 + si4 + u;
            o[u] = (j <= i && i < Q) ? s[u][v] * expf(cl[i] - cl[j]) * dts[j] : 0.f;
          }
          *reinterpret_cast<float4*>(ss + (sj4 + v) * TILE + si4) =
              make_float4(o[0], o[1], o[2], o[3]);
        }
        __syncthreads();

        // y_I += S_IJ x_J: rows r4.., columns c4..
        const int jend = jt == it ? min(TILE, Q - j0) : TILE;
#pragma unroll 4
        for (int j = 0; j < jend; ++j) {
          const float4 sv = *reinterpret_cast<const float4*>(ss + j * TILE + r4);
          const float4 xv = *reinterpret_cast<const float4*>(xs + j * PMAX + c4);
          const float sr[4] = {sv.x, sv.y, sv.z, sv.w};
          const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(sr[u], xr[v], acc[u][v]);
        }
        __syncthreads();   // bt, xs and ss are restaged by the next key tile
      }

      // inter-chunk term: y_i += exp(cl_i) C_i . state, then y written
      float t[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) t[u][v] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float4 cv = *reinterpret_cast<const float4*>(ct + n * LDT + r4);
        const float4 sv = *reinterpret_cast<const float4*>(st + n * PMAX + c4);
        const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
        const float sr[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) t[u][v] = fmaf(cr[u], sr[v], t[u][v]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + r4 + u;
        if (i >= Q) continue;
        const float e = expf(cl[i]);
        float* yr = y + (long long)(s0 + i) * yrs;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          if (c4 + v < P) yr[c4 + v] = fmaf(e, t[u][v], acc[u][v]);
        }
      }
    }
    __syncthreads();   // every read of the state and of ct is done

    // state = exp(cl_last) state + sum_j B_j^T (w_j x_j), w_j = exp(cl_last - cl_j) dt_j;
    // each thread updates rows n8..n8+7, columns c4..c4+3
    const float clq = cl[Q - 1];
    const float dq = expf(clq);
    float su[8][4];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(st + (n8 + k) * PMAX + c4);
      su[k][0] = v.x * dq;
      su[k][1] = v.y * dq;
      su[k][2] = v.z * dq;
      su[k][3] = v.w * dq;
    }
    float* bs = bt;   // [TILE][NMAX]
    for (int jt = 0; jt < ntiles; ++jt) {
      const int j0 = jt * TILE;
      const int jrows = min(TILE, Q - j0);
      for (int e = tid; e < TILE * NMAX; e += THREADS) {
        const int r = e / NMAX, n = e - r * NMAX;
        bs[e] = (r < jrows && n < N) ? bg[(long long)(s0 + j0 + r) * p.bss + n] : 0.f;
      }
      for (int e = tid; e < TILE * PMAX; e += THREADS) {
        const int r = e / PMAX, q = e - r * PMAX;
        xs[e] = (r < jrows && q < P)
                    ? expf(clq - cl[j0 + r]) * dts[j0 + r] *
                          x[(long long)(s0 + j0 + r) * p.xss + q]
                    : 0.f;
      }
      __syncthreads();
#pragma unroll 2
      for (int j = 0; j < jrows; ++j) {
        const float4 b0 = *reinterpret_cast<const float4*>(bs + j * NMAX + n8);
        const float4 b1 = *reinterpret_cast<const float4*>(bs + j * NMAX + n8 + 4);
        const float4 xv = *reinterpret_cast<const float4*>(xs + j * PMAX + c4);
        const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int k = 0; k < 8; ++k)
#pragma unroll
          for (int v = 0; v < 4; ++v) su[k][v] = fmaf(br[k], xr[v], su[k][v]);
      }
      __syncthreads();   // bs and xs are restaged by the next key tile
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      *reinterpret_cast<float4*>(st + (n8 + k) * PMAX + c4) =
          make_float4(su[k][0], su[k][1], su[k][2], su[k][3]);
    }
  }

  __syncthreads();
  for (int e = tid; e < N * P; e += THREADS) {
    const int n = e / P, q = e - n * P;
    p.state[sbase + e] = st[n * PMAX + q];
  }
}

}  // namespace

// All float32: x [B, S, H, P] and B, C [B, S, G, N] through their (b, s, h|g)
// strides in elements, unit stride in the last dim; dt [B, S, H] through its
// strides; a [H]; init [B, H, N, P] contiguous or null; y [B, S, H, P] and
// state [B, H, N, P] contiguous. Needs 1 <= Q <= 256 dividing S, N <= 128,
// P <= 64, H % G == 0, B <= 65,535; the wrapper checks.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* a, const void* bm,
                            const void* cm, const void* init, void* y, void* state,
                            int B, int S, int H, int G, int N, int P, int Q,
                            long long xsb, long long xss, long long xsh, long long dsb,
                            long long dss, long long dsh, long long bsb, long long bss,
                            long long bsg, long long csb, long long css, long long csg,
                            void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (Q < 1 || Q > QMAX || S % Q || N < 1 || N > NMAX || P < 1 || P > PMAX || G < 1 ||
      H % G)
    return (int)cudaErrorInvalidValue;
  Args args{static_cast<const float*>(x), static_cast<const float*>(dt),
            static_cast<const float*>(a), static_cast<const float*>(bm),
            static_cast<const float*>(cm), static_cast<const float*>(init),
            static_cast<float*>(y), static_cast<float*>(state),
            S, H, G, N, P, Q, xsb, xss, xsh, dsb, dss, dsh, bsb, bss, bsg, csb, css, csg};
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<<<dim3(H, B), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}
