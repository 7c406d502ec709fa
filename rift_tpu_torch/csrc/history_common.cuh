// Block-level pieces of the HistoryEncoder kernels (history_stage.cu,
// history_encoder.cu), for Hopper (sm_90a).
//
// Every routine works on rows held in shared memory by one thread block:
// a row is one token of one sequence, rows of a sequence are contiguous,
// and each buffer has its own (odd) row stride so that threads reading
// one column of neighbouring rows hit distinct banks. Weights stream from
// global memory through the read-only path and stay L2-resident across
// blocks. Callers synchronise the block between routines.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace history {

constexpr int kRT = 5;     // rows per thread in the products; T % 5 == 0
constexpr int kMaxT = 20;  // tokens per sequence the attention registers hold
constexpr int kBlockWeights = 12;  // per LocalBlock: ln1 s/b, qkv w/b, out
                                   // w/b, ln2 s/b, mlp1 w/b, mlp2 w/b

enum Epilogue { kStore = 0, kAddResidual = 1, kGelu = 2 };

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// out[r, j] (op)= in[r, :] . W[:, j] + b[j] for r < R, j < N; in rows have
// stride ldi, out rows ldo (shared memory); W is [K, N] row-major (global).
// Each thread owns one column j and kRT consecutive rows, so a weight read
// feeds kRT multiply-adds and a warp reads 32 consecutive weights.
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

// y[r, :] = LN(x[src(r), :]) * s + b for r < R, one warp per row, where
// src(r) = (r / m) * T + t0 + r % m: the rows t0 .. t0+m-1 of each
// sequence of T rows (m = T, t0 = 0: every row).
__device__ void layer_norm(const float* x, int ldx, int T, int t0, int m,
                           float* y, int ldy, int R, int D,
                           const float* __restrict__ s,
                           const float* __restrict__ b) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int r = warp; r < R; r += warps) {
    const int seq = r / m;
    const float* xr = x + (seq * T + t0 + (r - seq * m)) * ldx;
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

// The attention bias of a stage launch: a dense [H, T, T] array.
struct DenseBias {
  const float* bias;
  int T;
  __device__ float operator()(int h, int t, int j) const {
    return __ldg(bias + ((long long)h * T + t) * T + j);
  }
};

// The band-plus-RPB bias built from the raw relative-position table
// rpb [H, 2w-1] (rift_tpu/ops/history.py:band_rpb_bias): a query t sees the
// min(w, T) keys of its clamped neighbourhood (0, else -1e9), plus
// rpb[h, clamp(j - t + w - 1, 0, 2w - 2)].
struct BandRpbBias {
  const float* rpb;
  int T;
  int window;
  __device__ float operator()(int h, int t, int j) const {
    const int w = min(window, T);
    const int start = min(max(t - (w - 1) / 2, 0), T - w);
    const float band = (j >= start && j < start + w) ? 0.f : -1e9f;
    const int rel = min(max(j - t + window - 1, 0), 2 * window - 2);
    return band + __ldg(rpb + h * (2 * window - 1) + rel);
  }
};

// o[r, h*Dh:(h+1)*Dh] = softmax_j(q_r . k_j * scale + bias(h, t, j)) v_j
// within each sequence; qkv rows hold [q | k | v] (stride ldq). One thread
// per (row, head): the T <= kMaxT logits stay in registers.
template <class Bias>
__device__ void attention(const float* qkv, int ldq, float* o, int ldo,
                          int nseq, int T, int D, int H, Bias bias) {
  const int Dh = D / H;
  const float scale = rsqrtf((float)Dh);
  for (int item = threadIdx.x; item < nseq * T * H; item += blockDim.x) {
    const int r = item / H;  // heads fastest: neighbours share a row
    const int h = item - r * H;
    const int t = r % T;
    const int r0 = r - t;  // the sequence's first row
    const float* q = qkv + r * ldq + h * Dh;
    float l[kMaxT];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxT; ++j) {
      if (j < T) {
        const float* kj = qkv + (r0 + j) * ldq + D + h * Dh;
        float acc = 0.f;
        for (int d = 0; d < Dh; ++d) acc += q[d] * kj[d];
        l[j] = acc * scale + bias(h, t, j);
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

// One pre-LN LocalBlock over the R = nseq * T rows of xs (stride ld), in
// place: x += attn(LN1(x)); x += mlp2(gelu(mlp1(LN2(x)))). hs (stride ld)
// and wide (stride ldw >= 3D) are scratch. w: the block's kBlockWeights
// weights. Ends synchronised.
template <class Bias>
__device__ void local_block(float* xs, float* hs, float* wide, int ld,
                            int ldw, int nseq, int T, int D, int H,
                            const float* const* w, Bias bias) {
  const int R = nseq * T;
  layer_norm(xs, ld, T, 0, T, hs, ld, R, D, w[0], w[1]);
  __syncthreads();
  linear<kStore>(hs, ld, D, w[2], w[3], 3 * D, wide, ldw, R);
  __syncthreads();
  attention(wide, ldw, hs, ld, nseq, T, D, H, bias);
  __syncthreads();
  linear<kAddResidual>(hs, ld, D, w[4], w[5], D, xs, ld, R);
  __syncthreads();
  layer_norm(xs, ld, T, 0, T, hs, ld, R, D, w[6], w[7]);
  __syncthreads();
  linear<kGelu>(hs, ld, D, w[8], w[9], 3 * D, wide, ldw, R);
  __syncthreads();
  linear<kAddResidual>(wide, ldw, 3 * D, w[10], w[11], D, xs, ld, R);
  __syncthreads();
}

}  // namespace history
