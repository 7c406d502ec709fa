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
// its sequences.
// ptxas -v (sm_90a, CUDA 12.8): 128 registers, 136-byte stack frame, 140
// bytes of spill stores and 272 of spill loads; 215,776 bytes of dynamic
// shared memory.

#include <cuda_runtime.h>

#include "history_common.cuh"
#include "tf32x3.cuh"

namespace {

using history::kBlockWeights;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kG = 12;      // sequences per chunk
constexpr int kLevels = 3;
constexpr int kT0 = 20;     // tokens at level 0; 10 and 5 below
constexpr int kCin = 9;     // input channels
constexpr int kD0 = 32;     // width at level 0; 64 and 128 below
constexpr int kOut = 128;   // lateral and output width
constexpr int kKeep = 3;    // level-output rows kept per sequence
constexpr int kLat = 2;     // lateral rows kept per sequence
constexpr int kNT = 6;      // n8 tiles a warp holds at once
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
constexpr int kStage = 3200;  // 16 rows of up to 192 columns
constexpr int kAhead = 2;     // K-slices in flight beyond the one in use
constexpr int kStages = kAhead + 2;
constexpr int kLdLat = kOut + 4;
constexpr int kFloats = kStream + kWide + kOuts + kStages * kStage + 8;

// Rows of a product's A operand: a(r, k0) points at A[r][k0 .. k0+7].
struct Rows {
  const float* a;
  int ld;
  __device__ const float* operator()(int r, int k0) const {
    return a + r * ld + k0;
  }
};

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
    const int ntq = min(kNT, nt - q * kNT);  // even
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
// lanes take a row (D = 32, 64, 128), a float4 each, so a warp normalises
// 4, 2 or 1 rows at once; row strides are multiples of 4.
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
// within each sequence (head dim 16 at every level), written over q: the
// qkv rows (stride ldq, a multiple of 4) hold [q | k | v]. One thread per
// (row, head), its q, the T <= kMaxT logits and its output in registers,
// the keys and values read as float4.
__device__ void attention16(float* qkv, int ldq, int nseq, int T, int D,
                            int H, history::BandRpbBias bias) {
  for (int item = threadIdx.x; item < nseq * T * H; item += blockDim.x) {
    const int r = item / H;  // heads fastest: neighbours share a row
    const int h = item - r * H;
    const int t = r % T;
    const int r0 = r - t;  // the sequence's first row
    float4* qp = reinterpret_cast<float4*>(qkv + r * ldq + h * 16);
    const float4 q0 = qp[0], q1 = qp[1], q2 = qp[2], q3 = qp[3];
    float l[history::kMaxT];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < history::kMaxT; ++j) {
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
    for (int j = 0; j < history::kMaxT; ++j) {
      if (j < T) {
        l[j] = expf(l[j] - m);
        sum += l[j];
      }
    }
    float4 o[4] = {};
#pragma unroll
    for (int j = 0; j < history::kMaxT; ++j) {
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

// One pre-LN LocalBlock over the R = nseq * T rows of xs (stride D + 4),
// in place: x += attn(LN1(x)); x += mlp2(gelu(mlp1(LN2(x)))), with wide
// (stride 3D + 4) as the LN output, qkv, attention output (over q) and
// MLP hidden. w: the block's kBlockWeights weights. Ends synchronised.
__device__ void local_block(float* xs, float* wide, int nseq, int T, int D,
                            int H, int mw, const float* const* w,
                            history::BandRpbBias bias, float* wbuf) {
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
    wide[r * ldw + c] = history::gelu_tanh(v + __ldg(mlp1_b + c));
  });
  __syncthreads();
  const float* mlp2_b = w[11];
  product(a, R, 3 * D, w[10], D, mw, wbuf, [=](int r, int c, float v) {
    xs[r * ld + c] += v + __ldg(mlp2_b + c);
  });
  __syncthreads();
}

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
