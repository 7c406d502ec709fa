// Block-level pieces of the HistoryEncoder kernels (history_stage.cu,
// history_encoder.cu), for Hopper (sm_90a): one set of routines for both.
//
// Every routine is run by one 512-thread block (kThreads) on rows held in
// shared memory: a row is one token of one sequence, rows of a sequence
// are contiguous, and each buffer has its own row stride, a multiple of 4
// so that rows read as float4 (D + 4 and 3D + 4: 4 mod 32 at D = 32, 64
// and 128, so that the fragment loads of neighbouring rows hit distinct
// banks). Every matrix product runs on the tensor cores in 3xTF32
// (tf32x3.cuh), its weights staged from device memory through a ring of
// K-slices in shared memory that all sixteen warps share. The LayerNorms
// and the attention run on the CUDA cores. The block's caller
// synchronises it between routines.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "tf32x3.cuh"

namespace history {
namespace {

constexpr int kThreads = 512;  // the block every routine here is run by
constexpr int kWarps = kThreads / 32;
constexpr int kMaxT = 20;  // tokens per sequence the attention registers hold
constexpr int kHeadDim = 16;  // the attention's head dim (float4 x 4)
constexpr int kBlockWeights = 12;  // per LocalBlock: ln1 s/b, qkv w/b, out
                                   // w/b, ln2 s/b, mlp1 w/b, mlp2 w/b
constexpr int kNT = 6;        // n8 tiles a warp holds at once
constexpr int kStage = 3200;  // floats of a ring stage: 16 rows of up to
                              // 192 columns
constexpr int kAhead = 2;     // K-slices in flight beyond the one in use
constexpr int kStages = kAhead + 2;

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
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

// Rows of a product's A operand: a(r, k0) points at A[r][k0 .. k0+7].
struct Rows {
  const float* a;
  int ld;
  __device__ const float* operator()(int r, int k0) const {
    return a + r * ld + k0;
  }
};

// out[r, c] = sum_k A(r, k) W[k, c] for r < M, c < N, handed to
// epi(r, c, value) once every warp's K loop has ended. W [K, N] row-major
// (device memory, N % 16 == 0, K % 16 == 0) streams through wbuf, a ring
// of kStages K-slices (as many rows as fit, a multiple of 16; a pass is
// at most 192 columns wide) with kAhead in flight, shared by the block's
// warps.
// The warps split the m16 tiles mw ways (mw >= the tiles) and the n8
// tiles kWarps / mw ways; a warp holds at most kNT n8 tiles at once, so
// wider products run in column passes, right to left: a pass writes its
// columns only after its K loop, and A may be the columns left of them (a
// product may overwrite its own input). Products in 3xTF32; each warp
// sums 16 deep of K from zero and adds it to its accumulator in f32 (the
// tensor cores truncate each result, which over a long chain into one
// accumulator would bias the sum). Rows past M in the last m16 tile read
// row M - 1 and are discarded. Starts and ends synchronised.
template <class ARow, class Epi>
__device__ void product(ARow arow, int M, int K,
                        const float* __restrict__ W, int N, int mw,
                        float* wbuf, Epi epi) {
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int nw = kWarps / mw;
  const int mi = warp % mw, ni = warp / mw;
  const int nt = (N / 8 + nw - 1) / nw;  // n8 tiles per warp: 12, 4 or 2
  const int ra = min(16 * mi + g, M - 1), rb = min(16 * mi + g + 8, M - 1);
  for (int q = (nt - 1) / kNT; q >= 0; --q) {
    // even but at D = 16, where a pair's second tile may lie past the
    // warp's: it reads columns below ldb and is discarded
    const int ntq = min(kNT, nt - q * kNT);
    const int c0 = 8 * q * kNT * nw;         // the pass's columns
    const int cols = min(8 * ntq * nw, N - c0);
    const int j0 = ni * ntq;                 // the warp's, from c0
    const bool active = 16 * mi < M && 8 * j0 < cols;
    const int ldb = cols + 8;  // = 8 or 24 mod 32: B fragments hit 32 banks
    // K-slice rows: the largest 16 * 2^i that fits and divides K
    int ks = 16;
    while (2 * ks * ldb <= kStage && K % (2 * ks) == 0) ks *= 2;
    float acc[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

    const int slices = K / ks;
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (i < slices) tc::stage(wbuf + i * kStage, ldb, W, N, i * ks, ks, c0, cols);
      tc::cp_commit();
    }
    for (int s = 0; s < slices; ++s) {
      // slice s + kAhead into the stage last read at s - 2 (every warp has
      // passed s - 1's barrier since)
      if (s + kAhead < slices)
        tc::stage(wbuf + (s + kAhead) % kStages * kStage, ldb, W, N,
                  (s + kAhead) * ks, ks, c0, cols);
      tc::cp_commit();
      tc::cp_wait<kAhead>();
      __syncthreads();
      if (active) {
        const float* B = wbuf + s % kStages * kStage;
        for (int kk = 0; kk < ks; kk += 16) {
          uint32_t ahi[2][4], alo[2][4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float* pa = arow(ra, s * ks + kk + 8 * h);
            const float* pb = arow(rb, s * ks + kk + 8 * h);
            tc::split(pa[t], ahi[h][0], alo[h][0]);
            tc::split(pb[t], ahi[h][1], alo[h][1]);
            tc::split(pa[t + 4], ahi[h][2], alo[h][2]);
            tc::split(pb[t + 4], ahi[h][3], alo[h][3]);
          }
          // two n8 tiles at a time, their mma chains interleaved; each 16
          // deep of K summed from zero
#pragma unroll
          for (int j = 0; j < kNT; j += 2) {
            if (j < ntq && 8 * (j0 + j) < cols) {
              float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                uint32_t bhi0[2], blo0[2], bhi1[2], blo1[2];
                tc::load_b(B, ldb, kk + 8 * h, 8 * (j0 + j), bhi0, blo0);
                tc::load_b(B, ldb, kk + 8 * h, 8 * (j0 + j + 1), bhi1, blo1);
                tc::mma(d0, alo[h], bhi0);
                tc::mma(d1, alo[h], bhi1);
                tc::mma(d0, ahi[h], blo0);
                tc::mma(d1, ahi[h], blo1);
                tc::mma(d0, ahi[h], bhi0);
                tc::mma(d1, ahi[h], bhi1);
              }
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                acc[j][i] += d0[i];
                acc[j + 1][i] += d1[i];
              }
            }
          }
        }
      }
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (j < ntq && 8 * (j0 + j) < cols) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = 16 * mi + g + (i >> 1) * 8;
            if (r < M) epi(r, c0 + 8 * (j0 + j) + 2 * t + (i & 1), acc[j][i]);
          }
        }
      }
    }
  }
}

// y[r, :] = LN(x[src(r), :]) * s + b for r < R, where src(r) = (r / m) *
// T + t0 + r % m: the rows t0 .. t0+m-1 of each sequence of T rows. D / 4
// lanes take a row (D = 16, 32, 64, 128), a float4 each, so a warp
// normalises 8, 4, 2 or 1 rows at once; row strides are multiples of 4.
__device__ void layer_norm4(const float* x, int ldx, int T, int t0, int m,
                            float* y, int ldy, int R, int D,
                            const float* __restrict__ s,
                            const float* __restrict__ b) {
  const int L = D / 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane / L, li = lane - sub * L;
  const int per = 32 / L;
  for (int r0 = warp * per; r0 < R; r0 += kWarps * per) {
    const int r = r0 + sub;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < R) {
      const int seq = r / m;
      v = reinterpret_cast<const float4*>(
          x + (seq * T + t0 + r - seq * m) * ldx)[li];
    }
    float sum = (v.x + v.y) + (v.z + v.w);
    for (int off = L / 2; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float mu = sum / D;
    const float dx = v.x - mu, dy = v.y - mu, dz = v.z - mu, dw = v.w - mu;
    float sq = (dx * dx + dy * dy) + (dz * dz + dw * dw);
    for (int off = L / 2; off > 0; off >>= 1)
      sq += __shfl_xor_sync(0xffffffffu, sq, off);
    const float inv = rsqrtf(sq / D + 1e-5f);
    if (r < R) {
      const int c = 4 * li;
      reinterpret_cast<float4*>(y + r * ldy)[li] = make_float4(
          dx * inv * __ldg(s + c) + __ldg(b + c),
          dy * inv * __ldg(s + c + 1) + __ldg(b + c + 1),
          dz * inv * __ldg(s + c + 2) + __ldg(b + c + 2),
          dw * inv * __ldg(s + c + 3) + __ldg(b + c + 3));
    }
  }
}

// o[r, h*16 .. h*16+15] = softmax_j(q_r . k_j / 4 + bias(h, t, j)) v_j
// within each sequence (head dim kHeadDim = 16), written over q: the qkv
// rows (stride ldq, a multiple of 4) hold [q | k | v]. One thread per
// (row, head), its q, the T <= kMaxT logits and its output in registers,
// the keys and values read as float4.
template <class Bias>
__device__ void attention16(float* qkv, int ldq, int nseq, int T, int D,
                            int H, Bias bias) {
  for (int item = threadIdx.x; item < nseq * T * H; item += blockDim.x) {
    const int r = item / H;  // heads fastest: neighbours share a row
    const int h = item - r * H;
    const int t = r % T;
    const int r0 = r - t;  // the sequence's first row
    float4* qp = reinterpret_cast<float4*>(qkv + r * ldq + h * 16);
    const float4 q0 = qp[0], q1 = qp[1], q2 = qp[2], q3 = qp[3];
    float l[kMaxT];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxT; ++j) {
      if (j < T) {
        const float4* kp =
            reinterpret_cast<const float4*>(qkv + (r0 + j) * ldq + D + h * 16);
        const float4 k0 = kp[0], k1 = kp[1], k2 = kp[2], k3 = kp[3];
        float acc = q0.x * k0.x + q0.y * k0.y + q0.z * k0.z + q0.w * k0.w;
        acc += q1.x * k1.x + q1.y * k1.y + q1.z * k1.z + q1.w * k1.w;
        acc += q2.x * k2.x + q2.y * k2.y + q2.z * k2.z + q2.w * k2.w;
        acc += q3.x * k3.x + q3.y * k3.y + q3.z * k3.z + q3.w * k3.w;
        l[j] = acc * 0.25f + bias(h, t, j);
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
    float4 o[4] = {};
#pragma unroll
    for (int j = 0; j < kMaxT; ++j) {
      if (j < T) {
        const float4* vp = reinterpret_cast<const float4*>(
            qkv + (r0 + j) * ldq + 2 * D + h * 16);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float4 v = vp[c];
          o[c].x += l[j] * v.x;
          o[c].y += l[j] * v.y;
          o[c].z += l[j] * v.z;
          o[c].w += l[j] * v.w;
        }
      }
    }
    const float inv = 1.0f / sum;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      qp[c] = make_float4(o[c].x * inv, o[c].y * inv, o[c].z * inv,
                          o[c].w * inv);
  }
}

// The most rows a chunk may hold at width D: one m16 tile per warp of
// those that split the tiles, kWarps / nw, where nw warps side by side
// span a column pass at least D wide (local_block).
__host__ __device__ inline int chunk_rows(int D) {
  int nw = 1;
  while (8 * kNT * nw < D) nw *= 2;
  return 16 * (kWarps / nw);
}

// One pre-LN LocalBlock over the R = nseq * T rows of xs (stride D + 4),
// in place: x += attn(LN1(x)); x += mlp2(gelu(mlp1(LN2(x)))), with wide
// (stride 3D + 4) as the LN output, qkv, attention output (over q) and
// MLP hidden. w: the block's kBlockWeights weights; bias(h, t, j) the
// attention's additive bias. The products split the m16 tiles mw ways,
// and a column pass (8 kNT columns a warp, kWarps / mw warps side by
// side) must be at least D wide: the qkv and mlp1 products read the LN
// output in wide's first D columns and write over them, which only their
// last pass may do (chunk_rows). Ends synchronised.
template <class Bias>
__device__ void local_block(float* xs, float* wide, int nseq, int T, int D,
                            int H, int mw, const float* const* w, Bias bias,
                            float* wbuf) {
  const int R = nseq * T, ld = D + 4, ldw = 3 * D + 4;
  const Rows a{wide, ldw};
  layer_norm4(xs, ld, T, 0, T, wide, ldw, R, D, w[0], w[1]);
  __syncthreads();
  const float* qkv_b = w[3];
  product(a, R, D, w[2], 3 * D, mw, wbuf, [=](int r, int c, float v) {
    wide[r * ldw + c] = v + __ldg(qkv_b + c);
  });
  __syncthreads();
  attention16(wide, ldw, nseq, T, D, H, bias);
  __syncthreads();
  const float* out_b = w[5];
  product(a, R, D, w[4], D, mw, wbuf, [=](int r, int c, float v) {
    xs[r * ld + c] += v + __ldg(out_b + c);
  });
  __syncthreads();
  layer_norm4(xs, ld, T, 0, T, wide, ldw, R, D, w[6], w[7]);
  __syncthreads();
  const float* mlp1_b = w[9];
  product(a, R, D, w[8], 3 * D, mw, wbuf, [=](int r, int c, float v) {
    wide[r * ldw + c] = gelu_tanh(v + __ldg(mlp1_b + c));
  });
  __syncthreads();
  const float* mlp2_b = w[11];
  product(a, R, 3 * D, w[10], D, mw, wbuf, [=](int r, int c, float v) {
    xs[r * ld + c] += v + __ldg(mlp2_b + c);
  });
  __syncthreads();
}

}  // namespace
}  // namespace history
