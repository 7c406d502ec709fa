// One HistoryEncoder level: two pre-LN LocalBlocks fused, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel rift_tpu/ops/history.py:local_stage_pallas (body
// _stage_kernel). Same contract: x [N, T, D] f32 and, for each of the two
// blocks, LN -> qkv -> per-head softmax(q.k^T/sqrt(Dh) + bias[h]) v -> out
// projection -> +residual -> LN -> mlp1 (3D) -> tanh GELU -> mlp2 ->
// +residual, with a dense additive bias [H, T, T] per block. LN: eps 1e-5,
// population variance. Everything in f32, whatever the model's compute
// type. The shapes it takes are those of the shared block routines
// (history_common.cuh): head dim 16, D = 16, 32, 64 or 128, T <= 20; the
// model's levels are T/D/H = 20/32/2, 10/64/4 and 5/128/8.
//
// What bounds it on the H100: operations. At one act call's N = 1536
// history rows the three levels do 8.9 GFLOP against ~25 MB moved (x in
// and out once per level, 1.7 MB of weights); the products must hold f32
// accuracy, and the fastest arithmetic that does is 3xTF32 on the tensor
// cores (tf32x3.cuh: 165 TFLOP/s dense), 0.054 ms, against 7.5 us for the
// bytes.
//
// The design is the whole encoder's (history_encoder.cu), on the same
// block routines: a persistent grid of one 512-thread block per SM; block
// b takes an even share of the N sequences and walks it in chunks of at
// most G whole sequences, G * T <= chunk_rows(D) (256, 128 and 64 rows at
// D = 32, 64 and 128). The wrapper takes the most that fit: G = 12 at each
// of the model's levels, 240, 120 and 60 rows, 15, 8 and 4 m16 tiles
// (fewer sequences ran slower). A chunk's residual stream (rows x (D + 4))
// and one [rows, 3D + 4] buffer, which holds in turn the LN output, qkv,
// the attention output (over q) and the MLP hidden, sit in shared memory
// beside the ring of weight K-slices; x is read once and the output
// written once, and nothing else of the level touches device memory.
// Every product runs on the tensor cores in 3xTF32 (mma.sync m16n8k8),
// its weights staged by cp.async through the ring that all sixteen warps
// share, so a weight byte crosses L2 once per chunk; the warps split the
// chunk's m16 tiles mw ways (the least power of two >= the tiles, and at
// least 4, so that a column pass stays at most 192 wide) and the columns
// between them. The LayerNorms and the attention (one thread per (row,
// head), the bias read through the read-only cache) run on the CUDA cores.
// ptxas -v (sm_90a, CUDA 12.8): 125 registers, no stack frame or spills;
// at most 190,464 bytes of dynamic shared memory (D = 32, 256 rows).

#include <cuda_runtime.h>

#include "history_common.cuh"

namespace {

using history::kBlockWeights;
using history::kHeadDim;
using history::kMaxT;
using history::kStage;
using history::kStages;
using history::kThreads;
using history::kWarps;

struct StageParams {
  const float* w[2 * kBlockWeights];
  const float* bias[2];  // [H, T, T] per block
};

__global__ void __launch_bounds__(kThreads, 1)
    stage_kernel(const float* __restrict__ x, float* __restrict__ out, int N,
                 int T, int D, int H, int G, int mw, StageParams p) {
  extern __shared__ float smem[];
  const int ld = D + 4;
  float* xs = smem;                            // residual stream
  float* wide = xs + G * T * ld;               // LN out, qkv, MLP hidden
  float* wbuf = wide + G * T * (3 * D + 4);    // weight ring

  // this block's even share of the sequences, in chunks of at most G
  const long long begin = (long long)blockIdx.x * N / gridDim.x;
  const int count = (int)((long long)(blockIdx.x + 1) * N / gridDim.x - begin);
  const int chunks = (count + G - 1) / G;
  for (int c = 0; c < chunks; ++c) {
    const long long s0 = begin + (long long)c * count / chunks;
    const int nseq = (int)(begin + (long long)(c + 1) * count / chunks - s0);
    const int R = nseq * T;
    const float* xb = x + s0 * T * D;
    for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
      const int r = i / D;
      xs[r * ld + (i - r * D)] = xb[i];
    }
    __syncthreads();
    for (int blk = 0; blk < 2; ++blk)
      history::local_block(xs, wide, nseq, T, D, H, mw,
                           p.w + blk * kBlockWeights,
                           history::DenseBias{p.bias[blk], T}, wbuf);
    float* ob = out + s0 * T * D;
    for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
      const int r = i / D;
      ob[i] = xs[r * ld + (i - r * D)];
    }
    __syncthreads();
  }
}

}  // namespace

// The most rows a chunk may hold at width D.
extern "C" int rift_history_stage_chunk_rows(int D) {
  return history::chunk_rows(D);
}

// x, out: [N, T, D] f32 contiguous; params: 24 weight pointers (block 0,
// then block 1, in the order of StageParams) and the two [H, T, T] biases.
// Chunks of at most G sequences. Shapes: 1 <= T <= 20, D = 16 H and D =
// 16, 32, 64 or 128, G * T <= chunk_rows(D). Returns
// cudaErrorInvalidValue for another shape, else cudaGetLastError().
extern "C" int rift_history_stage_fwd(const void* x, void* out,
                                      const void* const* params, int N, int T,
                                      int D, int H, int G, void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  if (T < 1 || T > kMaxT || H < 1 || D != kHeadDim * H ||
      (D != 16 && D != 32 && D != 64 && D != 128) || G < 1 ||
      G * T > history::chunk_rows(D))
    return (int)cudaErrorInvalidValue;
  StageParams p;
  for (int i = 0; i < 2 * kBlockWeights; ++i) p.w[i] = (const float*)params[i];
  p.bias[0] = (const float*)params[2 * kBlockWeights];
  p.bias[1] = (const float*)params[2 * kBlockWeights + 1];
  // at most 47,616 floats (D = 32, 256 rows), within one block's 232,448 B
  const int smem = (G * T * (4 * D + 8) + kStages * kStage) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int mw = 4;
  while (16 * mw < G * T) mw *= 2;
  // one block per SM, at most one per chunk; each device's SMs counted once
  static int sms[64] = {};
  int device = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if (device >= 64) return (int)cudaErrorInvalidDevice;
  if (sms[device] == 0 &&
      (err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return (int)err;
  const long long chunks = (N + (long long)G - 1) / G;
  const int blocks = (int)(chunks < sms[device] ? chunks : sms[device]);
  stage_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, N, T, D, H, G, mw, p);
  return (int)cudaGetLastError();
}
