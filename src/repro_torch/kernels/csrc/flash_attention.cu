// B4: flash attention, the prefill's (and the training forward's) full
// self-attention, by online softmax, on the CUDA cores: B4's f32 route. bf16
// calls go to the tensor-core kernel (flash_attention_tc.cu).
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_bhsd
// (its ops.flash_attention wrapper). The function, not its blocks:
//
//     o[b, s, h] = sum_t softmax_t(q[b, s, h] . k[b, t, h / G] * hd^-1/2) v[b, t, h / G]
//
// over the keys t the masks keep: t <= s when causal, t > s - window when
// window > 0 (positions count from 0 within the sequence, as the TPU kernel
// counts them). Scores, the running max m and sum l, and the accumulator are
// f32; the output is acc / max(l, 1e-30). q heads of one kv group are
// adjacent (h / G is the kv head), as in the JAX layout.
//
// Bound: operations. At the f32 prefill of chip_smoke.py's parity check
// (q [2, 256, 32, 160], k and v [2, 256, 8, 160], causal) the two products
// need 4 * hd * B * H * S (S + 1) / 2 = 1.35 GFLOP: 20 us at the f32 CUDA
// cores' 67 TFLOP/s, against 26 MB of q, k, v and o (8 us at 3.35 TB/s).
//
// Design (right and simple first): one CTA of 256 threads per (q tile of 32
// rows, head, batch), two CTAs resident per SM. Eight threads share a q row:
// thread j of the row holds dims c*32 + 4j .. 4j+3 of
// q and of the accumulator in registers, for the c < HP/32 chunks of the head
// dim padded to HP, a multiple of 32 (zeros past hd). Per step a tile of 32
// keys and its values are staged in shared memory (2 * 32 * HP * 4 bytes:
// 40 KB at hd 160, 64 KB at hd 256, dynamic shared memory); each thread
// reads its dims as float4, which the eight threads of a row read as one
// conflict-free 128-byte line and the four rows of a warp share as a
// broadcast. A score is the eight partial dots summed by a
// butterfly of shuffles, so every thread of the row holds the same 32 scores,
// max, sum and correction. All arithmetic is f32 on the CUDA cores, so f32
// inputs get full f32 and no TF32. Key tiles wholly outside the causal and
// window masks are never loaded: the CTA walks only keys
// [max(0, q0 - window + 1), last row + 1).
// q tiles are issued heaviest first under the causal mask. q, k and v are
// read through their strides in the [B, S, H, hd] layout (last dim unit
// stride), so the wrapper makes no transposed copies; o is a new contiguous
// [B, S, H, hd] tensor.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TPR = 8;               // threads per q row
constexpr int BQ = 32;               // q rows per CTA
constexpr int BK = 32;               // keys per shared-memory tile
constexpr int THREADS = BQ * TPR;    // 256
constexpr float NEG = -1e30f;

struct Strides {
  long long b, s, h;   // elements; the head dim has unit stride
};

// NC = HP / 32 chunks of the padded head dim. Two CTAs per SM: registers are
// capped at 128 a thread (left alone, the compiler takes 123-187 and one CTA
// of 8 warps fills an SM); the widest heads spill a few bytes.
template <int NC>
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, int S, int Tk,
                       int H, int KV, int hd, Strides qs, Strides ks, Strides vs,
                       int causal, int window, float scale) {
  constexpr int HP = NC * 32;
  extern __shared__ float4 smem4[];
  float* ksm = reinterpret_cast<float*>(smem4);   // [BK][HP]
  float* vsm = ksm + BK * HP;                     // [BK][HP]

  const int nqt = (S + BQ - 1) / BQ;
  const int q0 = (nqt - 1 - (int)blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int r = tid / TPR, j = tid % TPR;
  const int qpos = q0 + r;
  const bool live = qpos < S;

  float qr[NC][4], acc[NC][4];
  const float* qrow = q + b * qs.b + (long long)(live ? qpos : 0) * qs.s + h * qs.h;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = c * 32 + 4 * j + e;
      qr[c][e] = (live && d < hd) ? qrow[d] : 0.f;
      acc[c][e] = 0.f;
    }
  }
  float m = NEG, l = 0.f;

  int kbeg = window > 0 ? max(0, q0 - window + 1) : 0;
  int kend = causal ? min(Tk, min(q0 + BQ, S)) : Tk;
  kbeg = (kbeg / BK) * BK;

  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    __syncthreads();   // every thread is done with the previous tile
    for (int i = tid; i < BK * HP; i += THREADS) {
      const int row = i / HP, d = i - row * HP;
      const int t = k0 + row;
      const bool ok = t < Tk && d < hd;
      ksm[i] = ok ? kb[(long long)t * ks.s + d] : 0.f;
      vsm[i] = ok ? vb[(long long)t * vs.s + d] : 0.f;
    }
    __syncthreads();

    float s[BK];
    unsigned keep = 0u;
    float mt = NEG;
#pragma unroll
    for (int jj = 0; jj < BK; ++jj) {
      const float4* kr = reinterpret_cast<const float4*>(ksm + jj * HP) + j;
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 kk = kr[c * TPR];
        part = fmaf(qr[c][0], kk.x, part);
        part = fmaf(qr[c][1], kk.y, part);
        part = fmaf(qr[c][2], kk.z, part);
        part = fmaf(qr[c][3], kk.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      part += __shfl_xor_sync(0xffffffffu, part, 4);
      const int kpos = k0 + jj;
      const bool ok = kpos < Tk && (!causal || kpos <= qpos) &&
                      (window <= 0 || kpos > qpos - window);
      s[jj] = ok ? part * scale : NEG;
      keep |= ok ? (1u << jj) : 0u;
      mt = fmaxf(mt, s[jj]);
    }
    const float mnew = fmaxf(m, mt);
    const float corr = expf(m - mnew);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] *= corr;
    }
    float lsum = 0.f;
#pragma unroll
    for (int jj = 0; jj < BK; ++jj) {
      const float p = (keep >> jj) & 1u ? expf(s[jj] - mnew) : 0.f;
      lsum += p;
      const float4* vr = reinterpret_cast<const float4*>(vsm + jj * HP) + j;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv = vr[c * TPR];
        acc[c][0] = fmaf(p, vv.x, acc[c][0]);
        acc[c][1] = fmaf(p, vv.y, acc[c][1]);
        acc[c][2] = fmaf(p, vv.z, acc[c][2]);
        acc[c][3] = fmaf(p, vv.w, acc[c][3]);
      }
    }
    l = l * corr + lsum;
    m = mnew;
  }

  if (live) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float* orow = o + (((long long)b * S + qpos) * H + h) * hd;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = c * 32 + 4 * j + e;
        if (d < hd) orow[d] = acc[c][e] * inv;
      }
    }
  }
}

template <int NC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int S, int Tk, int H, int KV, int hd, Strides qs, Strides ks,
                   Strides vs, int causal, int window, float scale,
                   cudaStream_t stream) {
  const int smem = 2 * BK * NC * 32 * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_attention_kernel<NC><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, Tk, H, KV, hd, qs, ks, vs,
      causal, window, scale);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int B,
                     int S, int Tk, int H, int KV, int hd, Strides qs, Strides ks,
                     Strides vs, int causal, int window, float scale,
                     cudaStream_t st) {
  switch ((hd + 31) / 32) {
    case 1: return launch<1>(q, k, v, o, B, S, Tk, H, KV, hd, qs, ks, vs, causal, window, scale, st);
    case 2: return launch<2>(q, k, v, o, B, S, Tk, H, KV, hd, qs, ks, vs, causal, window, scale, st);
    case 3: return launch<3>(q, k, v, o, B, S, Tk, H, KV, hd, qs, ks, vs, causal, window, scale, st);
    case 4: return launch<4>(q, k, v, o, B, S, Tk, H, KV, hd, qs, ks, vs, causal, window, scale, st);
    case 5: return launch<5>(q, k, v, o, B, S, Tk, H, KV, hd, qs, ks, vs, causal, window, scale, st);
    case 6: return launch<6>(q, k, v, o, B, S, Tk, H, KV, hd, qs, ks, vs, causal, window, scale, st);
    case 7: return launch<7>(q, k, v, o, B, S, Tk, H, KV, hd, qs, ks, vs, causal, window, scale, st);
    case 8: return launch<8>(q, k, v, o, B, S, Tk, H, KV, hd, qs, ks, vs, causal, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, S, H, hd], k and v [B, T, KV, hd] through their (b, s, h) strides in
// elements, unit stride in the head dim; o [B, S, H, hd] contiguous; all
// float32. Needs 8 <= hd <= 256, H % KV == 0, H and B at most 65,535; the
// wrapper checks.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int S, int Tk, int H,
                                   int KV, int hd, long long qsb, long long qss,
                                   long long qsh, long long ksb, long long kss,
                                   long long ksh, long long vsb, long long vss,
                                   long long vsh, int causal, int window,
                                   float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  return (int)dispatch(q, k, v, o, B, S, Tk, H, KV, hd, qs, ks, vs, causal, window, scale,
                       st);
}
