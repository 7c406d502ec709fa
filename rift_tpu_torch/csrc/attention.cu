// Fused multi-head attention for short sequences, for Hopper (sm_90a).
//
// Replaces the TPU kernel rift_tpu/ops/attention.py:fused_attention_pallas
// (body _attn_kernel). Same contract: packed q [B,Tq,D], k/v [B,Tk,D] with
// the head split inside, an additive f32 bias [H,Tq,Tk] shared by the batch
// and an additive f32 key pad [B,Tk] (0 or -1e9, never -inf: a fully
// masked row gets uniform weights, not NaN). Logits and softmax in f32; the
// weights are rounded to the input type before the AV product, which
// accumulates in f32.
//
// What bounds it on the H100: bytes. At the planner's shapes (T = 1..97
// tokens, head dim 16 or 32) a head does ~T^2*Dh*4 flops per ~3*T*Dh*2
// bytes, far below the ~295 flop/byte ridge, and the attention's real cost
// on the card is the launch and the tail of many tiny blocks. The design
// answers with one read of q/k/v and one write of out: one block per
// (batch row, head) stages that head's K and V in shared memory (at most
// 128 x 32 f32 each, 33 KB together, padded to an odd stride so the 32
// lanes hit 32 banks); each warp takes one query row at a time, spreads the
// Tk logits over its lanes, reduces max and sum with __shfl_xor_sync, and
// writes the row's Dh outputs from one lane each. No logits or weights
// touch device memory. Tensor cores (wgmma/mma) are left for a later
// version: at Dh <= 32 and Tk <= 128 the f32 FMA loop is not the limit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxTk = 128;
constexpr int kMaxDh = 32;
constexpr int kWarps = 4;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const float* __restrict__ kpad, T* __restrict__ out,
                     int Tq, int Tk, int D, int H, long long sq, long long sk,
                     long long sv, float scale) {
  __shared__ float ks[kMaxTk * (kMaxDh + 1)];
  __shared__ float vs[kMaxTk * (kMaxDh + 1)];
  __shared__ float qs[kWarps][kMaxDh];
  __shared__ float ws[kWarps][kMaxTk];

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int Dh = D / H;
  const int ld = Dh + 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // rows are `s*` elements apart; a batch row is T rows
  const T* kb = k + (long long)b * Tk * sk + h * Dh;
  const T* vb = v + (long long)b * Tk * sv + h * Dh;
  for (int i = threadIdx.x; i < Tk * Dh; i += blockDim.x) {
    const int j = i / Dh, d = i - j * Dh;
    ks[j * ld + d] = to_f(kb[j * sk + d]);
    vs[j * ld + d] = to_f(vb[j * sv + d]);
  }
  __syncthreads();

  const float* kp = kpad + (long long)b * Tk;
  for (int i = warp; i < Tq; i += kWarps) {
    const T* qrow = q + ((long long)b * Tq + i) * sq + h * Dh;
    if (lane < Dh) qs[warp][lane] = to_f(qrow[lane]);
    __syncwarp();

    const float* brow = bias + ((long long)h * Tq + i) * Tk;
    float e[kMaxTk / 32];
    float m = -INFINITY;
#pragma unroll
    for (int c = 0; c < kMaxTk / 32; ++c) {
      const int j = lane + 32 * c;
      float l = -INFINITY;
      if (j < Tk) {
        float acc = 0.f;
        for (int d = 0; d < Dh; ++d) acc += qs[warp][d] * ks[j * ld + d];
        l = acc * scale + brow[j] + kp[j];
      }
      e[c] = l;
      m = fmaxf(m, l);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxTk / 32; ++c) {
      const int j = lane + 32 * c;
      e[c] = j < Tk ? expf(e[c] - m) : 0.f;
      s += e[c];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
#pragma unroll
    for (int c = 0; c < kMaxTk / 32; ++c) {
      const int j = lane + 32 * c;
      // weights rounded to the input type before AV, as the TPU kernel does
      if (j < Tk) ws[warp][j] = to_f(from_f<T>(e[c] / s));
    }
    __syncwarp();

    if (lane < Dh) {
      float acc = 0.f;
      for (int j = 0; j < Tk; ++j) acc += ws[warp][j] * vs[j * ld + lane];
      out[((long long)b * Tq + i) * D + h * Dh + lane] = from_f<T>(acc);
    }
    __syncwarp();
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. s* are the row strides (elements) of
// q, k, v; out is contiguous [B, Tq, D]. Returns cudaGetLastError().
extern "C" int rift_attention_fwd(int dtype, const void* q, const void* k,
                                  const void* v, const void* bias,
                                  const void* kpad, void* out, int B, int Tq,
                                  int Tk, int D, int H, long long sq,
                                  long long sk, long long sv, void* stream) {
  if (B <= 0 || Tq <= 0) return (int)cudaSuccess;
  if (Tk < 1 || Tk > kMaxTk || H < 1 || D % H != 0 || D / H > kMaxDh)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B, H);
  const dim3 block(kWarps * 32);
  const float scale = 1.0f / sqrtf((float)(D / H));
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    attention_kernel<float><<<grid, block, 0, st>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const float*)bias, (const float*)kpad, (float*)out, Tq, Tk, D, H, sq,
        sk, sv, scale);
  } else if (dtype == 1) {
    attention_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (const float*)bias, (const float*)kpad,
        (__nv_bfloat16*)out, Tq, Tk, D, H, sq, sk, sv, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
