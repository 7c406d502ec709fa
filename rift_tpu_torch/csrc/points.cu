// Fused masked PointNet (Pluto's PointsEncoder) forward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel rift_tpu/ops/points.py:points_encoder_pallas
// (body _points_kernel). Per row of P points with C channels:
//   h1 = relu(LN(x @ w1 + b1))                 [P, 128]
//   h2 = h1 @ w2 + b2, masked to -1e9          [P, 256]
//   pooled = max_P(h2)                         [256]
//   h3 = relu(LN(h2 @ w3[:256] + pooled @ w3[256:] + b3))   [P, 256]
//   out = max_P(masked(h3 @ w4 + b4)), 0 where no point is valid
// has_ln = 0 drops both LayerNorms (the BN-folded variant).
//
// What bounds it on the H100: operations. A row of 120 points does ~16M
// multiply-adds against ~3 KB of input, and the f32 FMA rate (67 TFLOP/s
// outside the tensor cores) is the ceiling; the weights (0.8 MB) stay in
// L2. The design keeps the whole per-row pipeline on chip: one block of
// 256 threads per row, with the row's h2 in dynamic shared memory (P x 1 KB,
// 120 KB at P = 120, past the 48 KB static limit, hence the
// cudaFuncSetAttribute below). Points go through in tiles of 8: thread t
// owns output column t and reads each weight element once per tile, so L2
// traffic is an eighth of a point-at-a-time loop. Masked points are
// dropped up front (a compacted index list): they can only enter the two
// max-pools as -1e9, which the pools' starting value reproduces exactly.
// Tensor cores are left for a later version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8;  // points per tile == warps per block
constexpr int kH1 = 128;
constexpr int kH2 = 256;

// In-place LayerNorm (population variance, eps 1e-5) + ReLU over one
// point's n features, by one warp; without LN, ReLU only.
__device__ __forceinline__ void norm_relu(float* h, int n, const float* s,
                                          const float* b, int has_ln,
                                          int lane) {
  if (has_ln) {
    float sum = 0.f;
    for (int i = lane; i < n; i += 32) sum += h[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float mu = sum / n;
    float sq = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float d = h[i] - mu;
      sq += d * d;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sq += __shfl_xor_sync(0xffffffffu, sq, off);
    const float r = rsqrtf(sq / n + 1e-5f);
    for (int i = lane; i < n; i += 32)
      h[i] = fmaxf((h[i] - mu) * r * s[i] + b[i], 0.f);
  } else {
    for (int i = lane; i < n; i += 32) h[i] = fmaxf(h[i], 0.f);
  }
}

__global__ void __launch_bounds__(kThreads)
    points_kernel(const float* __restrict__ x,
                  const unsigned char* __restrict__ mask,
                  const float* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ ln1s,
                  const float* __restrict__ ln1b,
                  const float* __restrict__ w2, const float* __restrict__ b2,
                  const float* __restrict__ w3, const float* __restrict__ b3,
                  const float* __restrict__ ln2s,
                  const float* __restrict__ ln2b,
                  const float* __restrict__ w4, const float* __restrict__ b4,
                  float* __restrict__ out, int P, int C, int OUT,
                  int has_ln) {
  extern __shared__ float smem[];
  float* h2s = smem;                  // [P][kH2], compacted valid points
  float* xs = h2s + P * kH2;          // [P][C]
  float* tile = xs + P * C;           // [kTile][kH2]
  float* pooled = tile + kTile * kH2;  // [kH2]
  int* vidx = (int*)(pooled + kH2);   // [P] valid point indices
  __shared__ int n_valid;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const float* xr = x + (long long)row * P * C;
  const unsigned char* mr = mask + (long long)row * P;
  for (int i = tid; i < P * C; i += kThreads) xs[i] = xr[i];
  if (tid == 0) {
    int n = 0;
    for (int p = 0; p < P; ++p)
      if (mr[p]) vidx[n++] = p;
    n_valid = n;
  }
  __syncthreads();
  const int nv = n_valid;
  // masked points enter both max-pools as -1e9
  const float pool_floor = nv < P ? -1e9f : -INFINITY;

  // ---- phase A: h1, h2 and the first max-pool; thread t owns column t
  float pool_t = pool_floor;
  for (int t0 = 0; t0 < nv; t0 += kTile) {
    const int np = min(kTile, nv - t0);
    if (tid < kH1) {
      for (int p = 0; p < np; ++p) {
        const float* xp = xs + vidx[t0 + p] * C;
        float acc = 0.f;
        for (int c = 0; c < C; ++c) acc += xp[c] * w1[c * kH1 + tid];
        tile[p * kH2 + tid] = acc + b1[tid];
      }
    }
    __syncthreads();
    if (warp < np) norm_relu(tile + warp * kH2, kH1, ln1s, ln1b, has_ln, lane);
    __syncthreads();
    float acc[kTile];
#pragma unroll
    for (int p = 0; p < kTile; ++p) acc[p] = 0.f;
    for (int kk = 0; kk < kH1; ++kk) {
      const float w = w2[kk * kH2 + tid];
#pragma unroll
      for (int p = 0; p < kTile; ++p) acc[p] += tile[p * kH2 + kk] * w;
    }
    for (int p = 0; p < np; ++p) {
      const float h = acc[p] + b2[tid];
      h2s[(t0 + p) * kH2 + tid] = h;
      pool_t = fmaxf(pool_t, h);
    }
    __syncthreads();
  }
  pooled[tid] = pool_t;
  __syncthreads();

  // ---- phase B: the pooled half of the concat matmul, once per row
  float g = 0.f;
  for (int kk = 0; kk < kH2; ++kk) g += pooled[kk] * w3[(kH2 + kk) * kH2 + tid];

  // ---- phase C: h3, h4 and the second max-pool
  float out_t = pool_floor;
  for (int t0 = 0; t0 < nv; t0 += kTile) {
    const int np = min(kTile, nv - t0);
    float acc[kTile];
#pragma unroll
    for (int p = 0; p < kTile; ++p) acc[p] = 0.f;
    for (int kk = 0; kk < kH2; ++kk) {
      const float w = w3[kk * kH2 + tid];
#pragma unroll
      for (int p = 0; p < kTile; ++p)
        acc[p] += h2s[(t0 + min(p, np - 1)) * kH2 + kk] * w;
    }
    for (int p = 0; p < np; ++p) tile[p * kH2 + tid] = acc[p] + g + b3[tid];
    __syncthreads();
    if (warp < np) norm_relu(tile + warp * kH2, kH2, ln2s, ln2b, has_ln, lane);
    __syncthreads();
    if (tid < OUT) {
#pragma unroll
      for (int p = 0; p < kTile; ++p) acc[p] = 0.f;
      for (int kk = 0; kk < kH2; ++kk) {
        const float w = w4[kk * OUT + tid];
#pragma unroll
        for (int p = 0; p < kTile; ++p) acc[p] += tile[p * kH2 + kk] * w;
      }
      for (int p = 0; p < np; ++p) out_t = fmaxf(out_t, acc[p] + b4[tid]);
    }
    __syncthreads();
  }
  if (tid < OUT) out[(long long)row * OUT + tid] = nv > 0 ? out_t : 0.f;
}

}  // namespace

extern "C" long long rift_points_smem_bytes(int P, int C) {
  return (long long)(P * kH2 + P * C + kTile * kH2 + kH2) * sizeof(float) +
         (long long)P * sizeof(int);
}

// All pointers f32 and contiguous except mask (bool bytes). w1 [C,128],
// w2 [128,256], w3 [512,256], w4 [256,OUT] (row-major [in, out]); out
// [N, OUT]. Returns cudaGetLastError().
extern "C" int rift_points_fwd(const void* x, const void* mask, const void* w1,
                               const void* b1, const void* ln1s,
                               const void* ln1b, const void* w2, const void* b2,
                               const void* w3, const void* b3,
                               const void* ln2s, const void* ln2b,
                               const void* w4, const void* b4, void* out,
                               int N, int P, int C, int OUT, int has_ln,
                               void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  if (P < 1 || C < 1 || OUT < 1 || OUT > kThreads)
    return (int)cudaErrorInvalidValue;
  const long long smem = rift_points_smem_bytes(P, C);
  cudaError_t err = cudaFuncSetAttribute(
      points_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  points_kernel<<<N, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const unsigned char*)mask, (const float*)w1,
      (const float*)b1, (const float*)ln1s, (const float*)ln1b,
      (const float*)w2, (const float*)b2, (const float*)w3, (const float*)b3,
      (const float*)ln2s, (const float*)ln2b, (const float*)w4,
      (const float*)b4, (float*)out, P, C, OUT, has_ln);
  return (int)cudaGetLastError();
}
