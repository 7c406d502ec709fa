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
// history rows the work the last token needs is ~9.2 GFLOP against ~1.3 MB
// of input and output and ~2.4 MB of weights; the products must hold f32
// accuracy, and the fastest arithmetic that does is 3xTF32 on the tensor
// cores (tf32x3.cuh: 165 TFLOP/s dense), 0.056 ms. What bounds this
// kernel in practice is issue and latency around the tensor cores: each
// warp splits its A and B fragments into TF32 halves in registers and
// waits on short mma chains, and the LayerNorms, the attention and the
// staging barriers take about a fifth of the time (PERF.md §6).
//
// The design: a persistent grid of one 512-thread block per SM; block b
// takes an even share of the N sequences and walks it in chunks of up to
// twelve (N = 1536: 128 blocks of one chunk, one wave). Twelve sequences
// give 240, 120 and 60 rows at the three levels: 15, 8 and 4 whole m16
// tiles (94% full). A chunk's residual stream and the [rows, 3D] buffer
// that holds in turn the LN output, qkv, the attention output (written
// over q: each (row, head) reads only its own q), the MLP hidden, the
// downsample output and the laterals sit in shared memory (row strides
// = 4 mod 32), with the kept level outputs; only x and the last token
// touch device memory. Every product (the blocks' four, the downsamples,
// the laterals, the final conv; a convolution is a product over the three
// taps' rows) runs on the tensor cores in 3xTF32 (mma.sync m16n8k8), its
// weights staged through a ring of four K-slices in shared memory
// (cp.async, two in flight) that all sixteen warps share, so a weight
// byte crosses L2 once per chunk. The warps split a level's m16 tiles and
// the columns between them, a warp's pairs of n8 tiles run as interleaved
// chains, and each 16 deep of K is summed from zero and added in f32.
// Each output is written once its product's K loop has ended on every
// warp, so a product may overwrite its own input. The conv tokenizer
// (K = 27), the LayerNorms (float4 rows, several rows a warp), the banded
// attention (float4 rows of head dim 16; the band+RPB bias built from the
// raw [H, 2w-1] tables) and the FPN's resize run on the CUDA cores.
// Because only the last token is read, the FPN is computed only where
// that token depends on it: the final conv reads lat0 rows 18-19, which
// read lat1 rows 8-9, which read lat2 rows 3-4; so the level outputs are
// kept (and normalised) at rows 17-19, 7-9 and 2-4 only. The TPU kernel's
// padding of N to 128 is not carried over: a block's chunks cover exactly
// its sequences. The product, the LayerNorm, the attention and the
// LocalBlock are history_common.cuh's, shared with the stage kernel
// (history_stage.cu), which takes them with a dense bias.
// ptxas -v (sm_90a, CUDA 12.8): 128 registers, 136-byte stack frame, 140
// bytes of spill stores and 272 of spill loads; 215,776 bytes of dynamic
// shared memory.

#include <cuda_runtime.h>

#include "history_common.cuh"

namespace {

using history::kBlockWeights;
using history::kStage;
using history::kStages;
using history::kThreads;
using history::kWarps;
using history::layer_norm4;
using history::local_block;
using history::product;

constexpr int kG = 12;      // sequences per chunk
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

// Shared-memory floats: the residual stream and the wide buffer at their
// widest level (rows x (D + 4), rows x (3D + 4)), the kept level outputs,
// the ring of weight K-slices and one zero chunk (the convolutions' pads).
constexpr int kStream = kG * kT0 * (kD0 + 4);    // 8640 >= 120*68, 60*132
constexpr int kWide = kG * kT0 * (3 * kD0 + 4);  // 24000 >= 120*196, 60*388
constexpr int kOuts = kG * kKeep * ((kD0 + 4) + (2 * kD0 + 4) + (4 * kD0 + 4));
constexpr int kLdLat = kOut + 4;
constexpr int kFloats = kStream + kWide + kOuts + kStages * kStage + 8;

// The A operand of a k=3 convolution (W [3, D, N] read as [3D, N]):
// output row r = seq * m + i is position t = t0 + i * stride of its
// sequence, and reads input position t + tap - pad at columns k0 - tap*D;
// positions outside 0 .. T-1 read the zero chunk. The input holds
// positions base .. base + rows - 1 of each sequence (stride ld).
struct ConvRows {
  const float* in;
  int ld, D, T, base, rows, m, t0, stride, pad;
  const float* zero;
  __device__ const float* operator()(int r, int k0) const {
    const int seq = r / m;
    const int tap = k0 / D;
    const int ti = t0 + (r - seq * m) * stride + tap - pad;
    if (ti < 0 || ti >= T) return zero;
    return in + (seq * rows + ti - base) * ld + k0 - tap * D;
  }
};

// The encoder over sequences seq0 .. seq0 + nseq - 1 (nseq <= kG).
__device__ void encode_chunk(const float* __restrict__ x,
                             float* __restrict__ out, long long seq0,
                             int nseq, const EncoderParams& p, float* xs,
                             float* wide, float* const* outs, float* wbuf,
                             const float* zero) {
  // the input, then the conv tokenizer on the CUDA cores (K = 27)
  const int ldx = kCin + 1;
  const float* xb = x + seq0 * kT0 * kCin;
  for (int i = threadIdx.x; i < nseq * kT0 * kCin; i += blockDim.x) {
    const int r = i / kCin;
    wide[r * ldx + (i - r * kCin)] = xb[i];
  }
  __syncthreads();
  {
    const float* W0 = p.w[kConv0];
    const float* b0 = p.w[kConv0 + 1];
    for (int i = threadIdx.x; i < nseq * kT0 * kD0; i += blockDim.x) {
      const int r = i / kD0;
      const int j = i - r * kD0;
      const int tt = r % kT0;
      float acc = __ldg(b0 + j);
      for (int tap = 0; tap < 3; ++tap) {
        const int ti = tt + tap - 1;
        if (ti < 0 || ti >= kT0) continue;
        const float* a = wide + (r + tap - 1) * ldx;
        for (int k = 0; k < kCin; ++k)
          acc += a[k] * __ldg(W0 + (tap * kCin + k) * kD0 + j);
      }
      xs[r * (kD0 + 4) + j] = acc;
    }
  }
  __syncthreads();

  int T = kT0, D = kD0;
  for (int lv = 0; lv < kLevels; ++lv) {
    const int ld = D + 4;
    const int mw = kWarps >> lv;  // 16, 8, 4 >= the level's 15, 8, 4 m16 tiles
    for (int i = 0; i < 2; ++i) {
      const int blk = 2 * lv + i;
      local_block(xs, wide, nseq, T, D, kHeads[lv], mw,
                  p.w + kBlk + blk * kBlockWeights,
                  history::BandRpbBias{p.w[kRpb + blk], T, kWindows[lv]},
                  wbuf);
    }
    // the level output, at the rows the FPN reads
    layer_norm4(xs, ld, T, T - kKeep, kKeep, outs[lv], ld,
                        nseq * kKeep, D, p.w[kLevelLn + 2 * lv],
                        p.w[kLevelLn + 2 * lv + 1]);
    if (lv < kLevels - 1) {
      // the stride-2 conv (pad (0, 1)) into wide, then its LN into xs
      const float* const* dw = p.w + kDown + 4 * lv;
      const int T2 = T / 2, D2 = 2 * D, ld2 = D2 + 4;
      const ConvRows a{xs, ld, D, T, 0, T, T2, 0, 2, 0, zero};
      const float* db = dw[1];
      product(a, nseq * T2, 3 * D, dw[0], D2, mw >> 1, wbuf,
              [=](int r, int c, float v) { wide[r * ld2 + c] = v + __ldg(db + c); });
      __syncthreads();
      layer_norm4(wide, ld2, T2, 0, T2, xs, ld2, nseq * T2, D2, dw[2],
                          dw[3]);
      T = T2;
      D = D2;
    }
    __syncthreads();
  }

  // laterals at the kept rows: lat[lv] rows T_lv - 2 .. T_lv - 1
  float* lat[kLevels];
  for (int lv = 0; lv < kLevels; ++lv) {
    lat[lv] = wide + lv * kG * kLat * kLdLat;
    const int Tl = kT0 >> lv, Dl = kD0 << lv;
    const ConvRows a{outs[lv], Dl + 4, Dl, Tl, Tl - kKeep, kKeep,
                     kLat, Tl - kLat, 1, 1, zero};
    float* l = lat[lv];
    const float* lb = p.w[kLatW + 2 * lv + 1];
    product(a, nseq * kLat, 3 * Dl, p.w[kLatW + 2 * lv], kOut, 2, wbuf,
            [=](int r, int c, float v) { l[r * kLdLat + c] = v + __ldg(lb + c); });
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
      const float* src = lat[lv + 1] + seq * kLat * kLdLat + j;
      lat[lv][r * kLdLat + j] +=
          p.up[lv][i][0] * src[0] + p.up[lv][i][1] * src[kLdLat];
    }
    __syncthreads();
  }
  // the final conv at the last token, straight to device memory
  const ConvRows a{lat[0], kLdLat, kOut, kT0, kT0 - kLat, kLat,
                   1, kT0 - 1, 1, 1, zero};
  float* ob = out + seq0 * kOut;
  const float* fb = p.w[kFpn + 1];
  product(a, nseq, 3 * kOut, p.w[kFpn], kOut, 2, wbuf,
          [=](int r, int c, float v) { ob[r * kOut + c] = v + __ldg(fb + c); });
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
    encoder_kernel(const float* __restrict__ x, float* __restrict__ out,
                   int N, EncoderParams p) {
  extern __shared__ float smem[];
  float* xs = smem;            // residual stream
  float* wide = xs + kStream;  // input, LN out, qkv, MLP hidden, laterals
  float* outs[kLevels];        // kept level outputs
  outs[0] = wide + kWide;
  outs[1] = outs[0] + kG * kKeep * (kD0 + 4);
  outs[2] = outs[1] + kG * kKeep * (2 * kD0 + 4);
  float* wbuf = outs[2] + kG * kKeep * (4 * kD0 + 4);
  float* zero = wbuf + kStages * kStage;
  if (threadIdx.x < 8) zero[threadIdx.x] = 0.f;
  __syncthreads();

  // this block's even share of the sequences, in chunks of at most kG
  const long long begin = (long long)blockIdx.x * N / gridDim.x;
  const int count = (int)((long long)(blockIdx.x + 1) * N / gridDim.x - begin);
  const int chunks = (count + kG - 1) / kG;
  for (int c = 0; c < chunks; ++c) {
    const int s0 = c * count / chunks;
    const int s1 = (c + 1) * count / chunks;
    encode_chunk(x, out, begin + s0, s1 - s0, p, xs, wide, outs, wbuf, zero);
  }
}

constexpr int kSmemBytes = kFloats * sizeof(float);

}  // namespace

// x: [N, 20, 9] f32 contiguous; out: [N, 128] f32. params: the 102 weight
// pointers (weight_order, then blk0..5_rpb); up: the 8 FPN resize weights
// (up[lv][i][s], row-major). Returns cudaGetLastError().
extern "C" int rift_history_encoder_fwd(const void* x, void* out,
                                        const void* const* params,
                                        const float* up, int N, void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  EncoderParams p;
  for (int i = 0; i < kNumParams; ++i) p.w[i] = (const float*)params[i];
  for (int i = 0; i < (kLevels - 1) * kLat * kLat; ++i)
    (&p.up[0][0][0])[i] = up[i];
  cudaError_t err = cudaFuncSetAttribute(
      encoder_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  // one block per resident slot, at most one per chunk of kG sequences;
  // the slots of each device counted once
  static int slots[64] = {};
  int device = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if (device >= 64) return (int)cudaErrorInvalidDevice;
  if (slots[device] == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, encoder_kernel, kThreads, kSmemBytes)) != cudaSuccess)
      return (int)err;
    slots[device] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long chunks = (N + kG - 1) / kG;
  const int blocks = (int)(chunks < slots[device] ? chunks : slots[device]);
  encoder_kernel<<<blocks, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, N, p);
  return (int)cudaGetLastError();
}
