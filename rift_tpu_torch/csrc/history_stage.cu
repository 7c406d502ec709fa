// One HistoryEncoder level: two pre-LN LocalBlocks fused, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel rift_tpu/ops/history.py:local_stage_pallas (body
// _stage_kernel). Same contract: x [N, T, D] f32 and, for each of the two
// blocks, LN -> qkv -> per-head softmax(q.k^T/sqrt(Dh) + bias[h]) v -> out
// projection -> +residual -> LN -> mlp1 (3D) -> tanh GELU -> mlp2 ->
// +residual. bias [H, T, T] is the band (0 / -1e9) plus the natten
// relative-position bias (band_rpb_bias). LN: eps 1e-5, population
// variance. Everything in f32, whatever the model's compute type.
//
// What bounds it on the H100: operations. At the planner's shapes (N = 1536
// history rows; T x D = 20x32, 10x64, 5x128, head dim 16) one act call does
// ~9.1 GFLOP over the three launches against ~24 MB moved (x in and out
// once per level, 1.7 MB of weights): 0.136 ms at 67 TFLOP/s in f32 against
// 7 us at 3.35 TB/s. The design keeps every intermediate of the level out
// of device memory: one block takes G whole sequences, their G*T rows of
// the residual stream, the LN output and the [G*T, 3D] qkv / MLP hidden
// scratch sit in shared memory (rows padded to an odd stride), and only x
// and the output touch device memory. The weights (1.3 MB at the last
// level) do not fit shared memory; they stream from global memory, where
// they stay L2-resident across blocks. Each thread of a matrix product
// owns one output column and RT rows, so a weight read feeds RT FMAs and
// a warp's 32 threads read 32 consecutive weights while the activation is
// a shared-memory broadcast. Attention runs one thread per (row, head):
// T <= 20 logits in registers. wgmma/TMA tiling is later work.

#include <cuda_runtime.h>

#include "history_common.cuh"

namespace {

using history::kBlockWeights;
using history::kMaxT;
using history::kRT;

constexpr int kThreads = 256;

struct StageParams {
  const float* w[2 * kBlockWeights];
  const float* bias[2];  // [H, T, T] per block
};

__global__ void __launch_bounds__(kThreads)
    stage_kernel(const float* __restrict__ x, float* __restrict__ out, int N,
                 int T, int D, int H, int G, StageParams p) {
  extern __shared__ float smem[];
  const int ld = D + 1;       // residual stream and LN / attention output
  const int ldw = 3 * D + 1;  // qkv, then the MLP hidden
  const int seq0 = blockIdx.x * G;
  const int nseq = min(G, N - seq0);
  const int R = nseq * T;
  float* xs = smem;
  float* hs = xs + G * T * ld;
  float* wide = hs + G * T * ld;

  const float* xb = x + (long long)seq0 * T * D;
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int r = i / D;
    xs[r * ld + (i - r * D)] = xb[i];
  }
  __syncthreads();

  for (int blk = 0; blk < 2; ++blk)
    history::local_block(xs, hs, wide, ld, ldw, nseq, T, D, H,
                         p.w + blk * kBlockWeights,
                         history::DenseBias{p.bias[blk], T});

  float* ob = out + (long long)seq0 * T * D;
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int r = i / D;
    ob[i] = xs[r * ld + (i - r * D)];
  }
}

}  // namespace

// Shared memory one block of G sequences needs, in bytes.
extern "C" long long rift_history_stage_smem_bytes(int T, int D, int G) {
  return (long long)G * T * (2 * (D + 1) + 3 * D + 1) * sizeof(float);
}

// x, out: [N, T, D] f32 contiguous; params: 24 weight pointers (block 0,
// then block 1, in the order of StageParams) and the two [H, T, T] biases.
// G sequences per block. Returns cudaGetLastError().
extern "C" int rift_history_stage_fwd(const void* x, void* out,
                                      const void* const* params, int N, int T,
                                      int D, int H, int G, void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  if (T < 1 || T > kMaxT || T % kRT != 0 || H < 1 || D % H != 0 ||
      D % 32 != 0 || G < 1)
    return (int)cudaErrorInvalidValue;
  StageParams p;
  for (int i = 0; i < 2 * kBlockWeights; ++i) p.w[i] = (const float*)params[i];
  p.bias[0] = (const float*)params[2 * kBlockWeights];
  p.bias[1] = (const float*)params[2 * kBlockWeights + 1];
  const long long smem = rift_history_stage_smem_bytes(T, D, G);
  cudaError_t err = cudaFuncSetAttribute(
      stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + G - 1) / G;
  stage_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, N, T, D, H, G, p);
  return (int)cudaGetLastError();
}
