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
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRT = 5;     // rows per thread in the products; T % 5 == 0
constexpr int kMaxT = 20;  // tokens per sequence the attention registers hold
constexpr int kWeights = 12;  // per block: ln1 s/b, qkv w/b, out w/b, ln2 s/b,
                              // mlp1 w/b, mlp2 w/b

struct StageParams {
  const float* w[2 * kWeights];
  const float* bias[2];  // [H, T, T] per block
};

enum Epilogue { kStore = 0, kAddResidual = 1, kGelu = 2 };

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// out[r, j] (op)= in[r, :] . W[:, j] + b[j] for r < R, j < N; in rows have
// stride ldi, out rows ldo (shared memory); W is [K, N] row-major (global).
template <int EPI>
__device__ void linear(const float* in, int ldi, int K,
                       const float* __restrict__ W,
                       const float* __restrict__ b, int N, float* out,
                       int ldo, int R) {
  const int groups = R / kRT;
  for (int item = threadIdx.x; item < groups * N; item += blockDim.x) {
    const int g = item / N;
    const int j = item - g * N;
    const float* a = in + g * kRT * ldi;
    float acc[kRT];
#pragma unroll
    for (int i = 0; i < kRT; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float w = __ldg(W + (long long)k * N + j);
#pragma unroll
      for (int i = 0; i < kRT; ++i) acc[i] += a[i * ldi + k] * w;
    }
    const float bj = __ldg(b + j);
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      float* o = out + (g * kRT + i) * ldo + j;
      const float v = acc[i] + bj;
      if (EPI == kAddResidual) {
        *o += v;
      } else if (EPI == kGelu) {
        *o = gelu_tanh(v);
      } else {
        *o = v;
      }
    }
  }
}

// y[r, :] = LN(x[r, :]) * s + b, one warp per row
__device__ void layer_norm(const float* x, int ldx, float* y, int ldy, int R,
                           int D, const float* __restrict__ s,
                           const float* __restrict__ b) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int r = warp; r < R; r += warps) {
    const float* xr = x + r * ldx;
    float sum = 0.f;
    for (int d = lane; d < D; d += 32) sum += xr[d];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float mu = sum / D;
    float sq = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float c = xr[d] - mu;
      sq += c * c;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sq += __shfl_xor_sync(0xffffffffu, sq, off);
    const float inv = rsqrtf(sq / D + 1e-5f);
    for (int d = lane; d < D; d += 32)
      y[r * ldy + d] = (xr[d] - mu) * inv * __ldg(s + d) + __ldg(b + d);
  }
}

// o[r, h*Dh:(h+1)*Dh] = softmax_j(q_r . k_j * scale + bias[h, t, j]) v_j
// within each sequence; qkv rows hold [q | k | v] (stride ldq).
__device__ void attention(const float* qkv, int ldq, float* o, int ldo,
                          int nseq, int T, int D, int H,
                          const float* __restrict__ bias) {
  const int Dh = D / H;
  const float scale = rsqrtf((float)Dh);
  for (int item = threadIdx.x; item < nseq * T * H; item += blockDim.x) {
    const int r = item / H;  // heads fastest: neighbours share a row
    const int h = item - r * H;
    const int t = r % T;
    const int r0 = r - t;  // the sequence's first row
    const float* q = qkv + r * ldq + h * Dh;
    const float* brow = bias + ((long long)h * T + t) * T;
    float l[kMaxT];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxT; ++j) {
      if (j < T) {
        const float* kj = qkv + (r0 + j) * ldq + D + h * Dh;
        float acc = 0.f;
        for (int d = 0; d < Dh; ++d) acc += q[d] * kj[d];
        l[j] = acc * scale + __ldg(brow + j);
        m = fmaxf(m, l[j]);
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxT; ++j) {
      if (j < T) {
        l[j] = expf(l[j] - m);
        sum += l[j];
      }
    }
    const float inv = 1.0f / sum;
    for (int d = 0; d < Dh; ++d) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxT; ++j) {
        if (j < T) acc += l[j] * qkv[(r0 + j) * ldq + 2 * D + h * Dh + d];
      }
      o[r * ldo + h * Dh + d] = acc * inv;
    }
  }
}

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

  for (int blk = 0; blk < 2; ++blk) {
    const float* const* w = p.w + blk * kWeights;
    layer_norm(xs, ld, hs, ld, R, D, w[0], w[1]);
    __syncthreads();
    linear<kStore>(hs, ld, D, w[2], w[3], 3 * D, wide, ldw, R);
    __syncthreads();
    attention(wide, ldw, hs, ld, nseq, T, D, H, p.bias[blk]);
    __syncthreads();
    linear<kAddResidual>(hs, ld, D, w[4], w[5], D, xs, ld, R);
    __syncthreads();
    layer_norm(xs, ld, hs, ld, R, D, w[6], w[7]);
    __syncthreads();
    linear<kGelu>(hs, ld, D, w[8], w[9], 3 * D, wide, ldw, R);
    __syncthreads();
    linear<kAddResidual>(wide, ldw, 3 * D, w[10], w[11], D, xs, ld, R);
    __syncthreads();
  }

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
  for (int i = 0; i < 2 * kWeights; ++i) p.w[i] = (const float*)params[i];
  p.bias[0] = (const float*)params[2 * kWeights];
  p.bias[1] = (const float*)params[2 * kWeights + 1];
  const long long smem = rift_history_stage_smem_bytes(T, D, G);
  cudaError_t err = cudaFuncSetAttribute(
      stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + G - 1) / G;
  stage_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, N, T, D, H, G, p);
  return (int)cudaGetLastError();
}
