// The whole HistoryEncoder forward in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel rift_tpu/ops/history.py:history_encoder_pallas
// (body _history_kernel). Same contract: x [N, 20, 9] f32 -> the last
// token [N, 128] f32, through
//   1. the conv tokenizer (k=3, SAME) to width 32;
//   2. three levels of two pre-LN LocalBlocks (T/D/H = 20/32/2, 10/64/4,
//      5/128/8; band+RPB bias of windows 3/3/5; tanh-GELU MLP of ratio 3),
//      a level LayerNorm after each, and between levels a stride-2 conv
//      (flax SAME: pad (0, 1)) doubling the width, then a LayerNorm;
//   3. lateral k=3 convs of the three level outputs to width 128, the FPN
//      top-down fusion (lat[i-1] += resize(lat[i]), jax.image.resize
//      linear semantics) and the final k=3 conv, of which only the last
//      token is kept.
// LN: eps 1e-5, population variance. Everything in f32.
//
// What bounds it on the H100: operations. At the planner's N = 1536
// history rows the six blocks do ~9.1 GFLOP and the rest ~0.6 GFLOP,
// against ~1.3 MB of input and output and ~2.5 MB of weights: 0.145 ms at
// 67 TFLOP/s in f32, against ~1 us at 3.35 TB/s. The design keeps every
// intermediate out of device memory: one block of 256 threads takes G
// whole sequences; their residual stream, LN output, [T, 3D] qkv / MLP
// hidden scratch and the three level outputs sit in shared memory (odd row
// strides), and only x and the last token touch device memory. The
// weights stream from global memory and stay L2-resident across blocks.
// The band+RPB bias is built from the raw [H, 2w-1] tables inside the
// attention. Because only the last token is read, the FPN is computed
// only where that token depends on it: the final conv reads lat0 rows
// 18-19, which read lat1 rows 8-9, which read lat2 rows 3-4; so the level
// outputs are kept (and normalised) at rows 17-19, 7-9 and 2-4 only. The
// TPU kernel's padding of N to 128 is not carried over: the last block
// masks its ragged tail. wgmma/TMA tiling is later work.

#include <cuda_runtime.h>

#include "history_common.cuh"

namespace {

using history::kBlockWeights;
using history::kRT;

constexpr int kThreads = 256;
constexpr int kLevels = 3;
constexpr int kT0 = 20;     // tokens at level 0; 10 and 5 below
constexpr int kCin = 9;     // input channels
constexpr int kD0 = 32;     // width at level 0; 64 and 128 below
constexpr int kOut = 128;   // lateral and output width
constexpr int kKeep = 3;    // level-output rows kept per sequence
constexpr int kLat = 2;     // lateral rows kept per sequence
// weight pointers in rift_tpu/ops/history.py:weight_order, then the six
// blk{i}_rpb tables
constexpr int kConv0 = 0;
constexpr int kBlk = 2;
constexpr int kLevelLn = kBlk + 6 * kBlockWeights;  // 74
constexpr int kDown = kLevelLn + 2 * kLevels;       // 80
constexpr int kLatW = kDown + 4 * (kLevels - 1);    // 88
constexpr int kFpn = kLatW + 2 * kLevels;           // 94
constexpr int kRpb = kFpn + 2;                      // 96
constexpr int kNumParams = kRpb + 6;                // 102

__constant__ int kHeads[kLevels] = {2, 4, 8};
__constant__ int kWindows[kLevels] = {3, 3, 5};

struct EncoderParams {
  const float* w[kNumParams];
  // the FPN resize weights the kept rows need: up[lv][i][s] is
  // resize_matrix(T_{lv+1}, T_lv)[kept row i of lat lv, kept row s of
  // lat lv+1]; every other entry of those rows is 0 (checked by the
  // wrapper)
  float up[kLevels - 1][kLat][kLat];
};

// Per-sequence shared-memory floats of each buffer: the widest level of
// the residual stream / LN output (rows x (D + 1)), of the qkv / MLP
// scratch (rows x (3D + 1)), and the kept level outputs.
constexpr int kStream = kT0 * (kD0 + 1);      // 660 >= 10*65, 5*129
constexpr int kWide = kT0 * (3 * kD0 + 1);    // 1940 >= 10*193, 5*385
constexpr int kOuts = kKeep * ((kD0 + 1) + (2 * kD0 + 1) + (4 * kD0 + 1));

// out[r, j] = b[j] + sum_tap in[t*stride + tap - pad_l, :] . W[tap, :, j]
// over the rows r of nseq sequences of T_out rows (T_out % kRT == 0), with
// zero rows outside 0 .. T_in-1; in rows have stride ldi, out rows ldo.
// W is [3, K, N] row-major. Each thread owns one column and kRT rows.
__device__ void conv3(const float* in, int ldi, int T_in, int K,
                      const float* __restrict__ W,
                      const float* __restrict__ b, int N, float* out,
                      int ldo, int nseq, int T_out, int stride, int pad_l) {
  const int groups = nseq * T_out / kRT;
  for (int item = threadIdx.x; item < groups * N; item += blockDim.x) {
    const int g = item / N;
    const int j = item - g * N;
    const int r0 = g * kRT;
    const int seq = r0 / T_out;
    const int t0 = r0 - seq * T_out;
    float acc[kRT];
#pragma unroll
    for (int i = 0; i < kRT; ++i) acc[i] = 0.f;
    for (int tap = 0; tap < 3; ++tap) {
      const float* a[kRT];
      float on[kRT];
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
        const int ti = (t0 + i) * stride + tap - pad_l;
        const bool ok = ti >= 0 && ti < T_in;
        a[i] = in + (seq * T_in + (ok ? ti : 0)) * ldi;
        on[i] = ok ? 1.f : 0.f;
      }
      const float* Wt = W + (long long)tap * K * N + j;
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const float w = __ldg(Wt + (long long)k * N);
#pragma unroll
        for (int i = 0; i < kRT; ++i) acc[i] += on[i] * a[i][k] * w;
      }
    }
    const float bj = __ldg(b + j);
#pragma unroll
    for (int i = 0; i < kRT; ++i) out[(r0 + i) * ldo + j] = acc[i] + bj;
  }
}

// The k=3 stride-1 SAME conv at rows t_first .. t_first+m-1 of each of
// nseq sequences of T rows, from inputs of which only rows in_base ..
// in_base+in_rows-1 are stored (per sequence, stride ldi; rows outside
// 0 .. T-1 are zero and never read outside the stored ones). One thread
// per output element. out rows (stride ldo): seq * m + i.
__device__ void conv3_rows(const float* in, int ldi, int in_base,
                           int in_rows, int T, int K,
                           const float* __restrict__ W,
                           const float* __restrict__ b, int N, float* out,
                           int ldo, int nseq, int t_first, int m) {
  for (int item = threadIdx.x; item < nseq * m * N; item += blockDim.x) {
    const int r = item / N;
    const int j = item - r * N;
    const int seq = r / m;
    const int t = t_first + (r - seq * m);
    float acc = 0.f;
    for (int tap = 0; tap < 3; ++tap) {
      const int ti = t + tap - 1;
      if (ti < 0 || ti >= T) continue;
      const float* a = in + (seq * in_rows + ti - in_base) * ldi;
      const float* Wt = W + (long long)tap * K * N + j;
#pragma unroll 4
      for (int k = 0; k < K; ++k) acc += a[k] * __ldg(Wt + (long long)k * N);
    }
    out[r * ldo + j] = acc + __ldg(b + j);
  }
}

__global__ void __launch_bounds__(kThreads)
    encoder_kernel(const float* __restrict__ x, float* __restrict__ out,
                   int N, int G, EncoderParams p) {
  extern __shared__ float smem[];
  const int seq0 = blockIdx.x * G;
  const int nseq = min(G, N - seq0);
  float* xs = smem;               // residual stream
  float* hs = xs + G * kStream;   // LN / attention output, downsample out
  float* wide = hs + G * kStream; // input, qkv / MLP hidden, laterals
  float* outs[kLevels];           // kept level outputs
  outs[0] = wide + G * kWide;
  outs[1] = outs[0] + G * kKeep * (kD0 + 1);
  outs[2] = outs[1] + G * kKeep * (2 * kD0 + 1);

  // the input, then the conv tokenizer
  const int ldx = kCin + 1;
  const float* xb = x + (long long)seq0 * kT0 * kCin;
  for (int i = threadIdx.x; i < nseq * kT0 * kCin; i += blockDim.x) {
    const int r = i / kCin;
    wide[r * ldx + (i - r * kCin)] = xb[i];
  }
  __syncthreads();
  conv3(wide, ldx, kT0, kCin, p.w[kConv0], p.w[kConv0 + 1], kD0, xs,
        kD0 + 1, nseq, kT0, 1, 1);
  __syncthreads();

  int T = kT0, D = kD0;
  for (int lv = 0; lv < kLevels; ++lv) {
    const int ld = D + 1;
    for (int i = 0; i < 2; ++i) {
      const int blk = 2 * lv + i;
      history::local_block(
          xs, hs, wide, ld, 3 * D + 1, nseq, T, D, kHeads[lv],
          p.w + kBlk + blk * kBlockWeights,
          history::BandRpbBias{p.w[kRpb + blk], T, kWindows[lv]});
    }
    // the level output, at the rows the FPN reads
    history::layer_norm(xs, ld, T, T - kKeep, kKeep, outs[lv], ld,
                        nseq * kKeep, D, p.w[kLevelLn + 2 * lv],
                        p.w[kLevelLn + 2 * lv + 1]);
    if (lv < kLevels - 1) {
      const float* const* dw = p.w + kDown + 4 * lv;
      const int T2 = T / 2, D2 = 2 * D;
      conv3(xs, ld, T, D, dw[0], dw[1], D2, hs, D2 + 1, nseq, T2, 2, 0);
      __syncthreads();
      history::layer_norm(hs, D2 + 1, T2, 0, T2, xs, D2 + 1, nseq * T2, D2,
                          dw[2], dw[3]);
      T = T2;
      D = D2;
    }
    __syncthreads();
  }

  // laterals at the kept rows: lat[lv] rows T_lv - 2 .. T_lv - 1
  float* lat[kLevels];
  const int ldl = kOut + 1;
  for (int lv = 0; lv < kLevels; ++lv) {
    lat[lv] = wide + lv * G * kLat * ldl;
    const int Tl = kT0 >> lv, Dl = kD0 << lv;
    conv3_rows(outs[lv], Dl + 1, Tl - kKeep, kKeep, Tl, Dl,
               p.w[kLatW + 2 * lv], p.w[kLatW + 2 * lv + 1], kOut, lat[lv],
               ldl, nseq, Tl - kLat, kLat);
  }
  __syncthreads();
  // top-down fusion: lat[lv] += resize(lat[lv + 1])
  for (int lv = kLevels - 2; lv >= 0; --lv) {
    for (int item = threadIdx.x; item < nseq * kLat * kOut;
         item += blockDim.x) {
      const int r = item / kOut;
      const int j = item - r * kOut;
      const int seq = r / kLat;
      const int i = r - seq * kLat;
      const float* src = lat[lv + 1] + seq * kLat * ldl + j;
      lat[lv][r * ldl + j] +=
          p.up[lv][i][0] * src[0] + p.up[lv][i][1] * src[ldl];
    }
    __syncthreads();
  }
  // the final conv at the last token, straight to device memory
  conv3_rows(lat[0], ldl, kT0 - kLat, kLat, kT0, kOut, p.w[kFpn],
             p.w[kFpn + 1], kOut, out + (long long)seq0 * kOut, kOut, nseq,
             kT0 - 1, 1);
}

}  // namespace

// Shared memory one block of G sequences needs, in bytes.
extern "C" long long rift_history_encoder_smem_bytes(int G) {
  return (long long)G * (2 * kStream + kWide + kOuts) * sizeof(float);
}

// x: [N, 20, 9] f32 contiguous; out: [N, 128] f32. params: the 102 weight
// pointers (weight_order, then blk0..5_rpb); up: the 8 FPN resize weights
// (up[lv][i][s], row-major). G sequences per block. Returns
// cudaGetLastError().
extern "C" int rift_history_encoder_fwd(const void* x, void* out,
                                        const void* const* params,
                                        const float* up, int N, int G,
                                        void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  if (G < 1) return (int)cudaErrorInvalidValue;
  EncoderParams p;
  for (int i = 0; i < kNumParams; ++i) p.w[i] = (const float*)params[i];
  for (int i = 0; i < (kLevels - 1) * kLat * kLat; ++i)
    (&p.up[0][0][0])[i] = up[i];
  const long long smem = rift_history_encoder_smem_bytes(G);
  cudaError_t err = cudaFuncSetAttribute(
      encoder_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + G - 1) / G;
  encoder_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, N, G, p);
  return (int)cudaGetLastError();
}
