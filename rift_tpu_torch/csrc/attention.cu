// Fused multi-head attention for short sequences, for Hopper (sm_90a), on
// the tensor cores.
//
// Replaces the TPU kernel rift_tpu/ops/attention.py:fused_attention_pallas
// (body _attn_kernel). Same contract: packed q [B,Tq,D], k/v [B,Tk,D] with
// row strides (slices of one packed projection need no copy) and the head
// split inside, an additive f32 bias [H,Tq,Tk] shared by the batch and an
// additive f32 key pad [B,Tk] (0 or -1e9, never -inf: a fully masked row
// gets uniform weights, not NaN). Logits and softmax in f32; the weights are
// normalised, then rounded to the input type before the AV product, which
// accumulates in f32. 1 <= Tk <= 128, Dh = D/H <= 64.
//
// What bounds it on the H100. At the planner's shapes (T = 1..97 tokens,
// Dh 16 or 32; PlanT's 19 tokens at Dh 64 or 32) a head does
// ~4*Tq*Tk*Dh flops per ~(2*Tq + 2*Tk)*Dh*2 bytes, well below the ~295
// flop/byte ridge: the bound is bytes, and what keeps a kernel from it is
// latency and issue (the first version, scalar f32 FMA chains with one
// warp per query row, ran at 20x its byte bound). So the
// arithmetic goes to the tensor cores in warp-sized tiles that keep every
// intermediate in registers:
//
// - A warp owns a 16-row query tile of one (batch row, head). QK^T and PV
//   are mma.sync products: in bf16, m16n8k16 with f32 accumulation
//   (products of bf16 values are exact in f32, so this is the reference's
//   arithmetic in another summation order); in f32, m16n8k8 3xTF32
//   (csrc/tf32x3.cuh: hi/lo split, three products, each 8-deep slice summed
//   from zero and added in f32), which keeps f32 accuracy.
// - The scores stay in registers: Tk <= 128 keys are at most 16 n8 tiles,
//   64 f32 a thread. Scale, bias and key pad are added in the fragment
//   layout, keys >= Tk get -inf; row max and sum are two quad shuffles.
//   exp is one ex2.approx of (l - max) log2 e, and each row is normalised
//   by one reciprocal (IEEE division per weight was the largest single
//   cost of the first tensor-core version), then rounded: the reference's
//   order, not flash attention's deferred normalisation. The rounded row
//   is reused in registers as the A operand of PV: in bf16 the C layout of
//   two adjacent n8 tiles is the A layout of a k16 slice; in f32 the keys
//   of each 8-deep slice are taken in the order (2t, 2t+1) -> (t, t+4),
//   which makes the C layout the A layout, and V's rows are read in the
//   same order.
// - Head dims up to 32 and from 33 to 64 are two instantiations (the
//   template's DP). At Dh 64 a warp holds 8 n8 tiles of output, 32 f32 a
//   thread, beside the 64 of the scores at Tk = 128; in f32 Q's split
//   3xTF32 fragments of all 8 k8 slices would add 64 more, so the f32
//   QK^T loop runs slice by slice, each slice's fragment loaded from shared
//   memory once for all keys (each score sums its slices in order).
// - K and V of a (batch row, head) are staged once in shared memory with
//   16-byte cp.async copies (a bf16 head row of 32 is 64 bytes, four
//   copies; of 64, eight), rows padded by 16 bytes so that ldmatrix and
//   the fragment loads hit 32 banks; ldmatrix.trans serves V. Rows from Tk
//   up to the next multiple of 16 are zero-filled by the copies: a zero
//   weight times stale shared memory could be NaN. Each warp stages its
//   own query tile the same way. The copies run in flat loops decoded by
//   shifts and one multiply-high division by H.
// - Work per block follows Tq: ceil(Tq/16) warps (at most 8, looping over
//   tiles beyond) share one (batch row, head); for Tq <= 16 (the ego state,
//   r2r and m2m attentions) four (batch row, head) units share a block, one
//   warp each, and sequences of <= 4 tokens (r2r) go four to a warp's 16
//   rows, each slot masked to its own keys (never slower than a warp each,
//   from 144 to 3072 batch rows). The grid is persistent: each
//   block starts the copies of its next task before it computes the
//   current one (two buffers), so the load of one task hides behind the
//   arithmetic of another. The number of 16-key tiles is a template
//   parameter, so the score array is unrolled into registers.
//
// What it reaches (NVIDIA H100 80GB HBM3 at 700 W; tools/kernel_ab.py
// against the first version, in turns on one card): one act call's 17
// launches in bf16, replayed from a CUDA graph (device time), 0.23 ms
// against 1.25 ms, 3.7x the byte bound of 0.063 ms; a fit step's 17
// (batch 256) 0.28 ms against 1.87. Launched from Python the 17 take 0.5-
// 1.3 ms, against 1.27 for the first version: the wrapper's host cost per
// call (~25-70 us) now exceeds the kernel's 5-22 us. At head dim 64
// (PlanT_medium's ego: 64 rows of 19 tokens, D 512, 8 heads, f32) a launch
// takes 12 us of device time, 4.0x its byte bound, against SDPA's 34 us.
// PERF.md section 6 keeps the numbers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int kMaxTk = 128;
constexpr int kMaxDh = 64;
constexpr int kMaxWarps = 8;     // warps sharing one (batch row, head)
constexpr int kBlockWarps = 4;   // warps per block when Tq <= 16
constexpr int kSmemTarget = 64 * 1024;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte copy to shared memory; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a.b: mma.sync m16n8k16, bf16 operands, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x, ~2 ulp; results below 2^-126 flush to 0 (weights that small do not
// move an f32 sum of weights near 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ void store2(float* p, float a, float b, bool both, bool pair) {
  if (both && pair) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    if (both) p[1] = b;
  }
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b, bool both,
                                       bool pair) {
  if (both && pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16(a);
    if (both) p[1] = __float2bfloat16(b);
  }
}

// Shared-memory geometry of one element type: head rows padded to DhP, a
// power of two (bf16: 16, 32 or 64 for the k16 slices; f32: 8, 16, 32 or
// 64) and a row stride of DhP plus 16 bytes, a multiple of 16 bytes whose
// 4-word shift per row keeps ldmatrix's 8 rows and the f32 fragment loads
// on 32 distinct banks.
template <typename T>
struct Geo {
  static constexpr int kVec = 16 / (int)sizeof(T);  // elements per 16-byte copy
  __host__ __device__ static int dh_pad(int Dh) {
    return Dh <= 8 && sizeof(T) == 4 ? 8 : Dh <= 16 ? 16 : Dh <= 32 ? 32 : 64;
  }
  __host__ __device__ static int ld(int Dh) { return dh_pad(Dh) + kVec; }
};

__device__ __forceinline__ void cp4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// n / d for 0 <= n < 2^31 by a multiply-high and a shift (d fixed per
// launch: the divisor of a problem index by the number of heads)
struct FastDiv {
  unsigned mul, shr;
  int d;
  void init(int divisor) {
    d = divisor;
    int lg = 0;
    while ((1 << lg) < d) ++lg;  // ceil(log2 d)
    mul = d == 1 ? 0u : (unsigned)(((1ull << (31 + lg)) + d - 1) / d);
    shr = d == 1 ? 0u : (unsigned)(lg - 1);
  }
  __device__ __forceinline__ int operator()(int n) const {
    return d == 1 ? n : (int)(__umulhi((unsigned)n, mul) >> shr);
  }
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  const float* kpad;
  void* out;
  int B, Tq, Tk, D, H;
  long long sq, sk, sv;
  float scale;
  int upb;    // units per block (a unit: PK problems, or one with gw warps)
  int gw;     // warps per unit
  int tasks;  // blocks' worth of units: ceil(units / upb)
  bool vec;   // 16-byte copies allowed (alignment and strides)
  int cl;     // log2 of the copies per padded head row
  FastDiv by_h;
};

// One warp's 16-row tile. PK = 1: query rows i0 .. i0+15 of problem p0
// against its KT x 16 keys. PK > 1: PK problems p0 .. p0+PK-1 side by side
// in slots of Z = 16/PK query rows and Z keys (Tq, Tk <= Z), a slot's rows
// masked to its own keys. DP (32 or 64) bounds the padded head dim DhP.
// Writes the rows that exist.
template <typename T, int KT, int PK, int DP>
__device__ __forceinline__ void attend_tile(const Args& a, const T* qs, const T* ks,
                                            const T* vs, const float* kp, int ld, int i0,
                                            int p0) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int Z = 16 / PK;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int Dh = a.D / a.H;
  const int DhP = min(Geo<T>::dh_pad(Dh), DP);  // DP bounds it for the compiler
  const int P = a.B * a.H;

  // ---- S = Q K^T in the C layout: s[jt][n] is the n8 tile of keys
  // jt*16 + 8n .. +7; s[..][e] at row g + 8(e/2), key 2t + e%2 of the tile
  float s[KT][2][4];
#pragma unroll
  for (int jt = 0; jt < KT; ++jt)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jt][n][e] = 0.f;

  if constexpr (kBf16) {
    const int DK = DhP / 16;  // k16 slices of the head dimension
    uint32_t qa[DP / 16][4];
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      if (kk < DK) ldsm_x4(qa[kk], qs + (lane & 15) * ld + kk * 16 + ((lane >> 4) << 3));
#pragma unroll
    for (int jt = 0; jt < KT; ++jt)
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        if (kk >= DK) continue;
        // matrices: keys +0..7 / +8..15 (lane >> 4), columns +0 / +8
        uint32_t kb[4];
        ldsm_x4(kb, ks + (jt * 16 + (lane & 7) + ((lane >> 4) << 3)) * ld + kk * 16 +
                        (((lane >> 3) & 1) << 3));
        mma_bf16(s[jt][0], qa[kk], kb[0], kb[1]);
        mma_bf16(s[jt][1], qa[kk], kb[2], kb[3]);
      }
  } else {
    // slice by slice, one split Q fragment at a time: each score sums its
    // k8 slices in order, each slice's product from zero
    const int NK = DhP / 8;  // k8 slices of the head dimension
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      if (kk >= NK) continue;
      uint32_t qh[4], ql[4];
      tc::load_a(qs, ld, 0, kk * 8, qh, ql);
#pragma unroll
      for (int jt = 0; jt < KT; ++jt)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          // B[k][key] = K[key][k]: b0 (k = t, key g), b1 (k = t + 4, key g)
          const float* kr = ks + (jt * 16 + n * 8 + g) * ld + kk * 8 + t;
          uint32_t bh[2], bl[2];
          tc::split(kr[0], bh[0], bl[0]);
          tc::split(kr[4], bh[1], bl[1]);
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          tc::mma3(d, qh, ql, bh, bl);
#pragma unroll
          for (int e = 0; e < 4; ++e) s[jt][n][e] += d[e];
        }
    }
  }

  // ---- this thread's rows g and g + 8: their problem, query row, bias
  // row (rows past Tq read the last row's) and output row
  int slot[2];
  bool live[2];
  const float* brow[2];
  T* orow[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = g + 8 * hr;
    slot[hr] = PK > 1 ? r / Z : 0;
    const int i = PK > 1 ? r % Z : i0 + r;
    const int p = min(p0 + slot[hr], P - 1);
    live[hr] = p0 + slot[hr] < P && i < a.Tq;
    const int b = a.by_h(p), h = p - b * a.H;
    brow[hr] = a.bias + ((long long)h * a.Tq + min(i, a.Tq - 1)) * a.Tk;
    orow[hr] = (T*)a.out + ((long long)b * a.Tq + i) * a.D + h * Dh;
  }

  // ---- logits and softmax in f32 (exp as exp2 of the scaled difference)
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int jt = 0; jt < KT; ++jt)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = jt * 16 + n * 8 + 2 * t + (e & 1);
        const int j = PK > 1 ? c % Z : c;
        const bool valid = j < a.Tk && (PK == 1 || c / Z == slot[e >> 1]);
        const float l = valid ? s[jt][n][e] * a.scale + brow[e >> 1][j] + kp[c] : -INFINITY;
        s[jt][n][e] = l;
        mx[e >> 1] = fmaxf(mx[e >> 1], l);
      }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
    if (mx[hr] == -INFINITY) mx[hr] = 0.f;  // a row of a missing problem
  }
  constexpr float kLog2e = 1.4426950408889634f;
  const float mxl[2] = {mx[0] * kLog2e, mx[1] * kLog2e};
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int jt = 0; jt < KT; ++jt)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // exp(l - max) = 2^(l log2 e - max log2 e); exp(-inf) = 0
        const float x = ex2(fmaf(s[jt][n][e], kLog2e, -mxl[e >> 1]));
        s[jt][n][e] = x;
        sum[e >> 1] += x;
      }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 1);
    sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 2);
    sum[hr] = sum[hr] > 0.f ? 1.0f / sum[hr] : 0.f;
  }
#pragma unroll
  for (int jt = 0; jt < KT; ++jt)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jt][n][e] *= sum[e >> 1];

  // ---- O = W V, the weights reused in registers as the A operand;
  // o[nd] is the n8 tile of head columns 8nd .. 8nd+7
  float o[DP / 8][4];
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
  const int ND = DhP / 8;

  if constexpr (kBf16) {
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      // rounded to bf16 here, after the normalisation
      const uint32_t w[4] = {pack_bf16(s[kk][0][0], s[kk][0][1]),
                             pack_bf16(s[kk][0][2], s[kk][0][3]),
                             pack_bf16(s[kk][1][0], s[kk][1][1]),
                             pack_bf16(s[kk][1][2], s[kk][1][3])};
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        if (2 * dp >= ND) continue;
        // matrices: keys +0..7 / +8..15 (bit 3 of lane), columns +0 / +8
        uint32_t vb[4];
        ldsm_x4_trans(vb, vs + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld +
                              dp * 16 + ((lane >> 4) << 3));
        mma_bf16(o[2 * dp], w, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], w, vb[2], vb[3]);
      }
    }
  } else {
#pragma unroll
    for (int jt = 0; jt < KT; ++jt)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        // keys 8c + 2t and 8c + 2t + 1 of the slice as its k = t and t + 4
        const int c = 2 * jt + n;
        uint32_t wh[4], wl[4];
        tc::split(s[jt][n][0], wh[0], wl[0]);
        tc::split(s[jt][n][2], wh[1], wl[1]);
        tc::split(s[jt][n][1], wh[2], wl[2]);
        tc::split(s[jt][n][3], wh[3], wl[3]);
        const float* vr = vs + (8 * c + 2 * t) * ld + g;
#pragma unroll
        for (int nd = 0; nd < DP / 8; ++nd) {
          if (nd >= ND) continue;
          uint32_t bh[2], bl[2];
          tc::split(vr[nd * 8], bh[0], bl[0]);
          tc::split(vr[ld + nd * 8], bh[1], bl[1]);
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          tc::mma3(d, wh, wl, bh, bl);
#pragma unroll
          for (int e = 0; e < 4; ++e) o[nd][e] += d[e];
        }
      }
  }

  const bool pair = (Dh & 1) == 0;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (!live[hr]) continue;
#pragma unroll
    for (int nd = 0; nd < DP / 8; ++nd) {
      const int d = nd * 8 + 2 * t;
      if (nd < ND && d < Dh)
        store2(orow[hr] + d, o[nd][2 * hr], o[nd][2 * hr + 1], d + 1 < Dh, pair);
    }
  }
}

// Start the copies of one warp's query tile into qs: PK slots of 16/PK
// rows (problems p .. p+PK-1, rows row0 .. of each) x 2^cl copies a row,
// by the warp. Missing rows and problems are zero-filled.
template <typename T, int PK>
__device__ __forceinline__ void stage_queries(const Args& a, T* qs, int ld, int p, int row0) {
  constexpr int ZQ = 16 / PK;
  const int Dh = a.D / a.H, P = a.B * a.H;
  const int cw = a.vec ? Geo<T>::kVec : 1;  // elements per copy
  const T* q = (const T*)a.q;
  for (int i = threadIdx.x & 31; i < (PK * ZQ) << a.cl; i += 32) {
    const int rr = i >> a.cl, sl = rr / ZQ, r = rr - sl * ZQ;
    const int c = (i & ((1 << a.cl) - 1)) * cw, row = row0 + r;
    const bool ok = p + sl < P && row < a.Tq && c < Dh;
    const int b = ok ? a.by_h(p + sl) : 0, h = ok ? p + sl - b * a.H : 0;
    const T* src = q + ((long long)b * a.Tq + row) * a.sq + h * Dh + c;
    T* dst = qs + (sl * ZQ + r) * ld + c;
    if (a.vec)
      cp16(dst, ok ? src : q, ok ? 16 : 0);
    else
      *dst = ok ? *src : zero<T>();
  }
}

// Start the copies of one task (upb units) into one buffer: K, V and the
// key pad of each unit's problems by the whole block, each warp's first
// query tile by the warp, in flat loops over 16-byte chunks. Missing rows
// and problems are zero-filled.
template <typename T, int KT, int PK>
__device__ __forceinline__ void issue(const Args& a, int task, unsigned char* buf, int ld) {
  constexpr int TkP = KT * 16;
  constexpr int ZK = PK > 1 ? 16 / PK : TkP;  // keys per problem slot
  constexpr int E = Geo<T>::kVec;
  const int Dh = a.D / a.H;
  const int P = a.B * a.H;
  const int p0 = task * a.upb * PK;  // the task's first problem
  T* kv = reinterpret_cast<T*>(buf);
  float* kps = reinterpret_cast<float*>(kv + a.upb * 2 * TkP * ld);
  T* qs = reinterpret_cast<T*>(kps + a.upb * TkP);
  const T* k = (const T*)a.k;
  const T* v = (const T*)a.v;
  // K and V: (slot, matrix) pairs x ZK rows x 2^cl copies a row; a slot
  // us = u*PK + sl
  const int cw = a.vec ? E : 1;  // elements per copy
  const int cmask = (1 << a.cl) - 1;
  for (int i = threadIdx.x; i < (a.upb * PK * 2 * ZK) << a.cl; i += blockDim.x) {
    const int rr = i >> a.cl, sm = rr / ZK, r = rr - sm * ZK, c = (i & cmask) * cw;
    const int us = sm >> 1, p = p0 + us;
    const bool ok = p < P && r < a.Tk && c < Dh;
    const int b = ok ? a.by_h(p) : 0, h = ok ? p - b * a.H : 0;
    const long long stride = (sm & 1) ? a.sv : a.sk;
    const T* src = ((sm & 1) ? v : k) + ((long long)b * a.Tk + r) * stride + h * Dh + c;
    T* dst = kv + ((us / PK) * 2 + (sm & 1)) * TkP * ld + ((us % PK) * ZK + r) * ld + c;
    if (a.vec)
      cp16(dst, ok ? src : k, ok ? 16 : 0);
    else
      *dst = ok ? *src : zero<T>();
  }
  for (int i = threadIdx.x; i < a.upb * PK * ZK; i += blockDim.x) {
    const int us = i / ZK, j = i - us * ZK, p = p0 + us;
    const bool ok = p < P && j < a.Tk;
    const float* src = a.kpad + (ok ? (long long)a.by_h(p) * a.Tk + j : 0);
    cp4(kps + (us / PK) * TkP + (us % PK) * ZK + j, src, ok ? 4 : 0);
  }
  const int warp = threadIdx.x >> 5;
  const int u = warp / a.gw, wi = warp - u * a.gw;
  stage_queries<T, PK>(a, qs + warp * 16 * ld, ld, p0 + u * PK, wi * 16);
}

// A persistent grid: block x takes tasks x, x + gridDim.x, ..., and starts
// the copies of its next task before it computes the current one (two
// buffers). A task is `upb` units; a unit is one problem (b, h) = p / H,
// p % H shared by `gw` warps, or PK problems in one warp's slots.
template <typename T, int KT, int PK, int DP>
__device__ __forceinline__ void attention_body(const Args& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int TkP = KT * 16;
  const int ld = min(Geo<T>::dh_pad(a.D / a.H), DP) + Geo<T>::kVec;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  // per buffer: K, V [upb][2][TkP][ld], key pad [upb][TkP], queries [warps][16][ld]
  const int kv_n = a.upb * 2 * TkP * ld, kp_n = a.upb * TkP, q_n = warps * 16 * ld;
  const int buf_bytes = (kv_n + q_n) * (int)sizeof(T) + kp_n * (int)sizeof(float);
  const int P = a.B * a.H;
  const int u = warp / a.gw, wi = warp - u * a.gw;

  int task = blockIdx.x, buf = 0;
  if (task < a.tasks) issue<T, KT, PK>(a, task, smem, ld);
  cp_commit();
  for (; task < a.tasks; task += gridDim.x, buf ^= 1) {
    const int next = task + gridDim.x;
    if (next < a.tasks) issue<T, KT, PK>(a, next, smem + (buf ^ 1) * buf_bytes, ld);
    cp_commit();
    cp_wait<1>();  // this task's copies have landed
    __syncthreads();
    const int p0 = (task * a.upb + u) * PK;
    if (p0 < P) {
      const T* ks = reinterpret_cast<const T*>(smem + buf * buf_bytes) + u * 2 * TkP * ld;
      const float* kp =
          reinterpret_cast<const float*>(smem + buf * buf_bytes + kv_n * sizeof(T)) + u * TkP;
      T* q_s = reinterpret_cast<T*>(smem + buf * buf_bytes + kv_n * sizeof(T) +
                                    kp_n * sizeof(float)) + warp * 16 * ld;
      for (int i0 = wi * 16; i0 < a.Tq; i0 += a.gw * 16) {
        if (i0 != wi * 16) {  // the next query tile of a long sequence (Tq > 16 * gw)
          __syncwarp();
          stage_queries<T, PK>(a, q_s, ld, p0, i0);
          cp_commit();
          cp_wait<0>();
          __syncwarp();
        }
        attend_tile<T, KT, PK, DP>(a, q_s, ks, ks + TkP * ld, kp, ld, i0, p0);
      }
    }
    __syncthreads();  // the buffer is free for the task after next
  }
}

template <typename T, int KT, int PK>
__global__ void __launch_bounds__(kMaxWarps * 32) attention_kernel(const Args a) {
  attention_body<T, KT, PK, 32>(a);
}

// Head dims 33..64. With the default bounds ptxas holds some tile counts
// to 128 registers a thread (two blocks of 8 warps an SM) and spills; one
// block an SM lets them take what they need.
template <typename T, int KT, int PK>
__global__ void __launch_bounds__(kMaxWarps * 32, 1) attention_kernel_dh64(const Args a) {
  attention_body<T, KT, PK, 64>(a);
}

template <typename T, int KT, int PK, int DP>
inline auto kernel_of() {
  if constexpr (DP > 32)
    return attention_kernel_dh64<T, KT, PK>;
  else
    return attention_kernel<T, KT, PK>;
}

// Shared memory per block follows Dh and Tk: at Dh 64 in f32 and Tk = 128
// a unit's K and V take 2 x 128 x 272 bytes, so a block above 48 KB opts
// in (at most 2 x (70144 + 34816) bytes, Tq > 112, within the 227 KB).
template <typename T, int KT, int PK, int DP>
int launch(Args a, cudaStream_t st) {
  constexpr int TkP = KT * 16;
  const int Dh = a.D / a.H;
  const int ld = Geo<T>::ld(Dh);
  a.gw = PK > 1 ? 1 : min((a.Tq + 15) / 16, kMaxWarps);
  a.upb = a.gw >= kBlockWarps ? 1 : kBlockWarps / a.gw;
  auto smem_bytes = [&](int upb) {
    return 2 * ((size_t)upb * (2 * TkP * ld * sizeof(T) + TkP * sizeof(float)) +
                (size_t)upb * a.gw * 16 * ld * sizeof(T));
  };
  while (a.upb > 1 && smem_bytes(a.upb) > (size_t)kSmemTarget) a.upb /= 2;
  const size_t smem = smem_bytes(a.upb);
  const int threads = a.upb * a.gw * 32;
  const int units = (a.B * a.H + PK - 1) / PK;
  a.tasks = (units + a.upb - 1) / a.upb;
  constexpr int E = Geo<T>::kVec;
  a.vec = Dh % E == 0 && a.sq % E == 0 && a.sk % E == 0 && a.sv % E == 0 &&
          (((uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v) & 15) == 0;
  a.scale = 1.0f / sqrtf((float)Dh);
  a.cl = 0;
  while ((a.vec ? E : 1) << a.cl < Geo<T>::dh_pad(Dh)) ++a.cl;
  a.by_h.init(a.H);

  // per instantiation and device: the shared memory opted into, the SM
  // count, and the blocks per SM of the last configuration
  struct Cache {
    size_t smem_set = 48 * 1024, occ_smem = 0;
    int sms = 0, occ_threads = 0, occ_blocks = 0;
  };
  static Cache caches[kMaxDevices];
  auto kernel = kernel_of<T, KT, PK, DP>();
  int dev = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  Cache& c = caches[dev];
  if (c.sms == 0 &&
      (e = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if (smem > c.smem_set) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    c.smem_set = smem;
  }
  if (threads != c.occ_threads || smem != c.occ_smem) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.occ_blocks, kernel, threads, smem);
    if (e != cudaSuccess) return (int)e;
    c.occ_threads = threads;
    c.occ_smem = smem;
  }
  const int grid = min(a.tasks, max(1, c.occ_blocks) * c.sms);
  kernel<<<grid, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int dispatch_dp(const Args& a, cudaStream_t st) {
  // sequences of <= 4 tokens go four to a warp's 16 rows
  if (a.Tq <= 4 && a.Tk <= 4) return launch<T, 1, 4, DP>(a, st);
  switch ((a.Tk + 15) / 16) {
#define RIFT_ATTN_KT(n) \
  case n:               \
    return launch<T, n, 1, DP>(a, st);
    RIFT_ATTN_KT(1)
    RIFT_ATTN_KT(2)
    RIFT_ATTN_KT(3)
    RIFT_ATTN_KT(4)
    RIFT_ATTN_KT(5)
    RIFT_ATTN_KT(6)
    RIFT_ATTN_KT(7)
    RIFT_ATTN_KT(8)
#undef RIFT_ATTN_KT
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch(const Args& a, cudaStream_t st) {
  return a.D / a.H <= 32 ? dispatch_dp<T, 32>(a, st) : dispatch_dp<T, 64>(a, st);
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
  Args a{q, k, v, (const float*)bias, (const float*)kpad, out, B, Tq, Tk, D, H, sq, sk, sv};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(a, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, st);
  return (int)cudaErrorInvalidValue;
}
