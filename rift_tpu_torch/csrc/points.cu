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
// What bounds it on the H100: operations. A point costs ~131K
// multiply-adds (C*128 + 128*256 + 256*256 + 256*OUT) against 4*C bytes of
// input; the products must hold f32 accuracy, and the fastest arithmetic
// that does is 3xTF32 on the tensor cores (tf32x3.cuh: 165 TFLOP/s dense).
// The weights (0.8 MB) are read from L2 once per tile.
//
// The design: a block takes a tile of whole rows, rows_per_tile =
// min(16, 128 / P) of them (one row of 120 reference-line points, six map
// rows of 20), and packs their valid points into one M tile of up to 128
// (the compaction happens on the device; masked points can only enter the
// two max-pools as -1e9, which the pools' starting value reproduces
// exactly). The activations live in one [128, 256] f32 buffer in shared
// memory. Every product runs on the tensor cores in 3xTF32:
//   - h1 (K = C, padded to a multiple of 8): mma.sync m16n8k8, each of
//     the eight warps 16 points x 128 columns, LN+ReLU on the registers;
//   - h2, h3 = h2 @ w3[:256] and h4: wgmma m64n64k8, each of the two
//     warpgroups 64 points x every column, A split into TF32 halves in
//     registers, B from shared memory;
//   - the pooled half of the concatenated product (w3[256:], once per
//     row): mma.sync over the tile's 16 pooled rows, where a 64-row wgmma
//     would be three-quarters empty.
// Each weight comes through shared memory a 16-row K-slice at a time,
// loaded by the whole block one slice ahead into registers and split once
// into hi and lo planes in wgmma's K-major layout, so a weight byte
// crosses L2 once per tile. Each K-slice is summed from zero and added to
// the accumulators in f32: the tensor cores truncate each result, which
// over a long chain into one large accumulator biases the sum toward zero
// (without the LayerNorms the outputs reach ~10^3). A product's output
// overwrites its warp's own rows of the buffer once its K loop has ended,
// so h1, h2, h3 and h4 share it. The LayerNorm of h3 runs on the
// registers (a quad of lanes holds a row's columns); both max-pools are
// segmented reductions over the tile's rows. A warpgroup whose 64 points
// are all past the tile's valid ones skips the products.
// ptxas -v (sm_90a, CUDA 12.8): 254 registers, no stack frame, no spills;
// 202,712 bytes of dynamic shared memory (one block per SM).

#include <cuda_runtime.h>
#include <math.h>

#include "tf32x3.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kM = 128;        // points per tile: 2 warpgroups x 64
constexpr int kMaxRows = 16;   // rows per tile
constexpr int kMaxC = 32;      // input channels
constexpr int kH1 = 128;
constexpr int kH2 = 256;
constexpr int kKS = 16;        // K-slice of a staged weight
constexpr int kUnits = kH2 / 64;  // 64-column units of a full-width product
constexpr int kLdH = kH2 + 4;  // activation row stride (= 4 mod 32: the A
                               // fragments hit 32 distinct banks)
constexpr int kLdP = kH2 + 4;  // pooled rows and their product
// a staged K-slice of a weight, split: [hi | lo] planes of kKS x 256 tf32
// in wgmma's K-major core-matrix layout (tf32x3.cuh): column group q, K
// group c at q * kSbo + c * kLbo bytes
constexpr int kLbo = 128;
constexpr int kSbo = (kKS / 4) * kLbo;
constexpr int kPlane = kH2 * kKS;  // floats

// floats of shared memory, then the int arrays
constexpr int kOffW = kM * kLdH;
constexpr int kOffPool = kOffW + 2 * kPlane;
constexpr int kOffG = kOffPool + kMaxRows * kLdP;  // G, and x before it
constexpr int kFloats = kOffG + (kMaxRows * kLdP > kM * (kMaxC + 4)
                                     ? kMaxRows * kLdP
                                     : kM * (kMaxC + 4));
constexpr int kLdW1 = kH1 + 8;  // w1 staged in the planes (= 8 mod 32)
constexpr int kInts = 2 * kM + 3 * kMaxRows + 1 + kM / 32 + kM + 1;
constexpr int kSmemBytes = kFloats * sizeof(float) + kInts * sizeof(int);

// The weight rows k0 .. k0 + kKS - 1 of W [K, N] (device memory) at column
// n = threadIdx.x (< 256), zero past ncols: one thread per column.
__device__ __forceinline__ void load_slice(float (&v)[kKS],
                                           const float* __restrict__ W,
                                           int N, int ncols, int k0) {
  const int n = threadIdx.x;
#pragma unroll
  for (int k = 0; k < kKS; ++k)
    v[k] = n < ncols ? __ldg(W + (long long)(k0 + k) * N + n) : 0.f;
}

// Splits a loaded slice column into the hi and lo planes.
__device__ __forceinline__ void store_slice(const float (&v)[kKS],
                                            float* planes) {
  const int n = threadIdx.x;
  uint32_t* hi = reinterpret_cast<uint32_t*>(planes);
  uint32_t* lo = hi + kPlane;
  const int base = (n >> 3) * (kSbo / 4) + (n & 7) * 4;
#pragma unroll
  for (int c = 0; c < kKS / 4; ++c) {
    uint4 h, l;
    tc::split(v[4 * c], h.x, l.x);
    tc::split(v[4 * c + 1], h.y, l.y);
    tc::split(v[4 * c + 2], h.z, l.z);
    tc::split(v[4 * c + 3], h.w, l.w);
    *reinterpret_cast<uint4*>(hi + base + c * (kLbo / 4)) = h;
    *reinterpret_cast<uint4*>(lo + base + c * (kLbo / 4)) = l;
  }
}

// acc[i] += A[rows, :K] . W[:K, 64 (u0 + i) .. + 63] for units u0 + i <
// u1 (i < kUnits), on the tensor cores in 3xTF32: the calling warpgroup's
// 64 rows, the warp's 16 of them from m0w (rows at or past arows read as
// zero). W [K, N] row-major in device memory comes through the planes a
// K-slice at a time, columns 0 .. ncols-1 (zero past them), loaded by the
// whole block one slice ahead and split once; every warp must call
// (active is per warpgroup; K % kKS == 0). Each unit's K-slice is summed
// from zero (the tensor cores truncate each result, which over a long
// chain into one large accumulator would bias the sum toward zero) and
// then added to acc in f32. Starts and ends with a block barrier.
__device__ void product(float (&acc)[kUnits][32], const float* A, int lda,
                        int m0w, int arows, bool active,
                        const float* __restrict__ W, int N, int K,
                        int ncols, int u0, int u1, float* planes) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < kUnits; ++i)
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[i][x] = 0.f;
  const int slices = K / kKS;
  float v[kKS];
  load_slice(v, W, N, ncols, 0);
  const float* ra = A + (m0w + g) * lda + t;
  const float* rb = ra + 8 * lda;
  const bool oka = m0w + g < arows, okb = m0w + g + 8 < arows;
  for (int s = 0; s < slices; ++s) {
    __syncthreads();  // every warpgroup is done with the planes
    store_slice(v, planes);
    tc::fence_async_smem();
    __syncthreads();
    if (s + 1 < slices) load_slice(v, W, N, ncols, (s + 1) * kKS);
    if (active) {
      uint32_t ahi[kKS / 8][4], alo[kKS / 8][4];
#pragma unroll
      for (int h = 0; h < kKS / 8; ++h) {
        const int k = s * kKS + 8 * h;
        tc::split(oka ? ra[k] : 0.f, ahi[h][0], alo[h][0]);
        tc::split(okb ? rb[k] : 0.f, ahi[h][1], alo[h][1]);
        tc::split(oka ? ra[k + 4] : 0.f, ahi[h][2], alo[h][2]);
        tc::split(okb ? rb[k + 4] : 0.f, ahi[h][3], alo[h][3]);
      }
#pragma unroll
      for (int i = 0; i < kUnits; ++i) {
        if (u0 + i < u1) {
          const float* hi = planes + (u0 + i) * 8 * (kSbo / 4);
          const float* lo = hi + kPlane;
          float d[32];
          tc::fence_regs(d);
          tc::wg_fence();
#pragma unroll
          for (int h = 0; h < kKS / 8; ++h) {
            const uint64_t bh = tc::smem_desc(hi + h * 2 * (kLbo / 4), kLbo, kSbo);
            const uint64_t bl = tc::smem_desc(lo + h * 2 * (kLbo / 4), kLbo, kSbo);
            tc::wgmma64(d, alo[h], bh, h);
            tc::wgmma64(d, ahi[h], bl, 1);
            tc::wgmma64(d, ahi[h], bh, 1);
          }
          tc::wg_commit();
          tc::wg_wait<0>();
          tc::fence_regs(d);
#pragma unroll
          for (int x = 0; x < 32; ++x) acc[i][x] += d[x];
        }
      }
    }
  }
  __syncthreads();
}

// acc[j] += P[0 .. 15, :K] . W[:K, 32w + 8j .. 32w + 8j + 7] for j < 4,
// w the calling warp (eight warps: 256 columns), on the tensor cores in
// 3xTF32 (mma.sync m16n8k8: 16 rows, where a warpgroup's wgmma would take
// 64). P (shared memory, row stride lda) holds 16 rows; W [K, 256] comes
// through the planes as in product(), its fragments read there already
// split. Each K-slice summed from zero, then added in f32. Starts and
// ends with a block barrier.
__device__ void rows16_product(float (&acc)[4][4], const float* P, int lda,
                               const float* __restrict__ W, int K,
                               float* planes) {
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const uint32_t* hi = reinterpret_cast<const uint32_t*>(planes);
  const uint32_t* lo = hi + kPlane;
  const int slices = K / kKS;
  float v[kKS];
  load_slice(v, W, kH2, kH2, 0);
  for (int s = 0; s < slices; ++s) {
    __syncthreads();
    store_slice(v, planes);
    __syncthreads();
    if (s + 1 < slices) load_slice(v, W, kH2, kH2, (s + 1) * kKS);
    uint32_t ahi[2][4], alo[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      tc::load_a(P, lda, 0, s * kKS + 8 * h, ahi[h], alo[h]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // B[k][n] at (n / 8) * kSbo + (k / 4) * kLbo + (n % 8) * 16 + (k % 4) * 4
      // bytes; this lane's k = 8h + t (+ 4), n = 32 warp + 8j + g
      const int base = (4 * warp + j) * (kSbo / 4) + g * 4 + t;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = base + 2 * h * (kLbo / 4);
        const uint32_t bhi[2] = {hi[o], hi[o + kLbo / 4]};
        const uint32_t blo[2] = {lo[o], lo[o + kLbo / 4]};
        tc::mma3(d, ahi[h], alo[h], bhi, blo);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] += d[i];
    }
  }
  __syncthreads();
}

// Sum over the four lanes of a quad (the lanes that hold one C row).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__global__ void __launch_bounds__(kThreads, 1)
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
                  float* __restrict__ out, int N, int P, int C, int OUT,
                  int rows_per_tile, int has_ln) {
  extern __shared__ float smem[];
  float* H = smem;                   // [kM][kLdH] h1 (cols 128..), h2, h3, out
  float* planes = smem + kOffW;      // a weight K-slice, split
  float* pooled = smem + kOffPool;   // [kMaxRows][kLdP]
  float* G = smem + kOffG;           // [kMaxRows][kLdP] pooled @ w3[256:] + b3
  float* xs = G;                     // [kM][C], before G
  int* prow = (int*)(smem + kFloats);  // tile row of each packed point
  int* pidx = prow + kM;               // its index within the row
  int* rstart = pidx + kM;             // first packed point of each row
  int* rcount = rstart + kMaxRows;     // valid points of each row
  int* rfull = rcount + kMaxRows;      // every point of the row valid
  int* nvalid = rfull + kMaxRows;
  int* wcount = nvalid + 1;            // valid points per warp of 32
  int* excl = wcount + kM / 32;        // [kM + 1] exclusive prefix sums

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * rows_per_tile;
  const int nrows = min(rows_per_tile, N - row0);

  // ---- pack the tile's valid points (nrows * P <= kM, the rows'
  // masks contiguous): a ballot prefix sum over the first four warps
  const int total = nrows * P;
  const bool v = tid < total && mask[(long long)row0 * P + tid] != 0;
  const unsigned bal = __ballot_sync(0xffffffffu, v);
  if (lane == 0 && warp < kM / 32) wcount[warp] = __popc(bal);
  __syncthreads();
  if (tid < total) {
    int pos = __popc(bal & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) pos += wcount[w];
    excl[tid] = pos;
    if (v) {
      prow[pos] = tid / P;
      pidx[pos] = tid - (tid / P) * P;
    }
  }
  if (tid == 0) {
    int n = 0;
    for (int w = 0; w < kM / 32; ++w) n += wcount[w];
    excl[total] = n;
    *nvalid = n;
  }
  __syncthreads();
  if (tid < nrows) {
    rstart[tid] = excl[tid * P];
    rcount[tid] = excl[(tid + 1) * P] - rstart[tid];
    rfull[tid] = rcount[tid] == P;
  }
  __syncthreads();
  const int nv = *nvalid;
  // x, K padded to Kp (a multiple of 8) with zeros, rows past nv zero;
  // w1 likewise into the planes
  const int Kp = (C + 7) & ~7;
  const int ldx = Kp + 4;  // = 4 mod 32 for Kp = 32; the A fragments
                           // hit 32 banks at every Kp
  for (int i = tid; i < kM * Kp; i += kThreads) {
    const int p = i / Kp;
    const int c = i - p * Kp;
    xs[p * ldx + c] = p < nv && c < C
        ? x[((long long)(row0 + prow[p]) * P + pidx[p]) * C + c] : 0.f;
  }
  for (int i = tid; i < Kp * kH1; i += kThreads) {
    const int c = i / kH1;
    const int j = i - c * kH1;
    planes[c * kLdW1 + j] = c < C ? __ldg(w1 + i) : 0.f;
  }
  __syncthreads();

  // ---- h1 = relu(LN(x @ w1 + b1)) into columns 128.. of H: warp w's 16
  // rows, all 128 columns, on the tensor cores (mma.sync, K = Kp <= 32:
  // one chain per tile); the LayerNorm on the registers
  float* h1 = H + kH1;
  {
    float h[kH1 / 8][4];
#pragma unroll
    for (int j = 0; j < kH1 / 8; ++j) h[j][0] = h[j][1] = h[j][2] = h[j][3] = 0.f;
    for (int k = 0; k < Kp; k += 8) {
      uint32_t ahi[4], alo[4];
      tc::load_a(xs, ldx, 16 * warp, k, ahi, alo);
#pragma unroll
      for (int j = 0; j < kH1 / 8; ++j) {
        uint32_t bhi[2], blo[2];
        tc::load_b(planes, kLdW1, k, 8 * j, bhi, blo);
        tc::mma3(h[j], ahi, alo, bhi, blo);
      }
    }
    float sa = 0.f, sb = 0.f;  // the lane's rows g and g + 8
#pragma unroll
    for (int j = 0; j < kH1 / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        h[j][i] += __ldg(b1 + 8 * j + 2 * t + (i & 1));
        if (i < 2) sa += h[j][i]; else sb += h[j][i];
      }
    if (has_ln) {
      const float mua = quad_sum(sa) / kH1, mub = quad_sum(sb) / kH1;
      float qa = 0.f, qb = 0.f;
#pragma unroll
      for (int j = 0; j < kH1 / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float dv = h[j][i] - (i < 2 ? mua : mub);
          if (i < 2) qa += dv * dv; else qb += dv * dv;
        }
      const float ia = rsqrtf(quad_sum(qa) / kH1 + 1e-5f);
      const float ib = rsqrtf(quad_sum(qb) / kH1 + 1e-5f);
#pragma unroll
      for (int j = 0; j < kH1 / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = 8 * j + 2 * t + (i & 1);
          h[j][i] = (h[j][i] - (i < 2 ? mua : mub)) * (i < 2 ? ia : ib) *
                        __ldg(ln1s + c) + __ldg(ln1b + c);
        }
    }
#pragma unroll
    for (int j = 0; j < kH1 / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        h1[(16 * warp + g + (i >> 1) * 8) * kLdH + 8 * j + 2 * t + (i & 1)] =
            fmaxf(h[j][i], 0.f);
  }

  // warpgroup wg owns rows 64 wg .. 64 wg + 63, its warp wq 16 of them,
  // in every product of all 256 columns (the four 64-column units)
  const int wg = warp >> 2, wq = warp & 3;
  const int m0w = 64 * wg + 16 * wq;
  const bool active = 64 * wg < nv;
  float acc[kUnits][32];
  // the (row, column) of acc[u][4j + i]
  auto row_of = [&](int i) { return m0w + g + (i >> 1) * 8; };
  auto col_of = [&](int u, int x) { return 64 * u + 8 * (x >> 2) + 2 * t + (x & 1); };

  // ---- h2 = h1 @ w2 + b2 (each warp writes only its own rows)
  product(acc, h1, kLdH, m0w, nv, active, w2, kH2, kH1, kH2, 0, kUnits, planes);
  if (active) {
#pragma unroll
    for (int u = 0; u < kUnits; ++u)
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int c = col_of(u, x);
        H[row_of(x & 3) * kLdH + c] = acc[u][x] + __ldg(b2 + c);
      }
  }
  __syncthreads();

  // ---- the first max-pool, per row (rows past nrows: 0)
  for (int i = tid; i < kMaxRows * kH2; i += kThreads) {
    const int r = i / kH2;
    const int j = i - r * kH2;
    float m = 0.f;
    if (r < nrows) {
      m = rfull[r] ? -INFINITY : -1e9f;
      for (int p = rstart[r]; p < rstart[r] + rcount[r]; ++p)
        m = fmaxf(m, H[p * kLdH + j]);
    }
    pooled[r * kLdP + j] = m;
  }

  // ---- G = pooled @ w3[256:] + b3 over the 16 pooled rows: warp w
  // takes columns 32w .. 32w + 31
  {
    float gacc[4][4];
    rows16_product(gacc, pooled, kLdP, w3 + kH2 * kH2, kH2, planes);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 32 * warp + 8 * j + 2 * t + (i & 1);
        G[(g + (i >> 1) * 8) * kLdP + c] = gacc[j][i] + __ldg(b3 + c);
      }
  }
  __syncthreads();

  // ---- h3 = relu(LN(h2 @ w3[:256] + G[row])): the LayerNorm on the
  // registers, a row's statistics summed over a quad of lanes
  product(acc, H, kLdH, m0w, nv, active, w3, kH2, kH2, kH2, 0, kUnits, planes);
  if (active) {
    float sa = 0.f, sb = 0.f;  // the lane's two rows: g and g + 8
    const int ra = row_of(0), rb = row_of(2);
    const float* ga = G + (ra < nv ? prow[ra] : 0) * kLdP;
    const float* gb = G + (rb < nv ? prow[rb] : 0) * kLdP;
#pragma unroll
    for (int u = 0; u < kUnits; ++u)
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const bool low = (x & 2) == 0;
        acc[u][x] += (low ? ga : gb)[col_of(u, x)];
        if (low) sa += acc[u][x]; else sb += acc[u][x];
      }
    if (has_ln) {
      const float mua = quad_sum(sa) / kH2, mub = quad_sum(sb) / kH2;
      float qa = 0.f, qb = 0.f;
#pragma unroll
      for (int u = 0; u < kUnits; ++u)
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const float dv = acc[u][x] - ((x & 2) == 0 ? mua : mub);
          if ((x & 2) == 0) qa += dv * dv; else qb += dv * dv;
        }
      const float ia = rsqrtf(quad_sum(qa) / kH2 + 1e-5f);
      const float ib = rsqrtf(quad_sum(qb) / kH2 + 1e-5f);
#pragma unroll
      for (int u = 0; u < kUnits; ++u)
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const int c = col_of(u, x);
          const bool low = (x & 2) == 0;
          acc[u][x] = (acc[u][x] - (low ? mua : mub)) * (low ? ia : ib) *
                          __ldg(ln2s + c) + __ldg(ln2b + c);
        }
    }
#pragma unroll
    for (int u = 0; u < kUnits; ++u)
#pragma unroll
      for (int x = 0; x < 32; ++x)
        H[row_of(x & 3) * kLdH + col_of(u, x)] = fmaxf(acc[u][x], 0.f);
  }

  // ---- h4 = h3 @ w4 + b4, OUT columns
  product(acc, H, kLdH, m0w, nv, active, w4, OUT, kH2, OUT, 0,
          (OUT + 63) / 64, planes);
  if (active) {
#pragma unroll
    for (int u = 0; u < kUnits; ++u)
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int c = col_of(u, x);
        if (c < OUT) H[row_of(x & 3) * kLdH + c] = acc[u][x] + __ldg(b4 + c);
      }
  }
  __syncthreads();

  // ---- the second max-pool, straight to device memory
  for (int i = tid; i < nrows * OUT; i += kThreads) {
    const int r = i / OUT;
    const int j = i - r * OUT;
    float m = rfull[r] ? -INFINITY : -1e9f;
    for (int p = rstart[r]; p < rstart[r] + rcount[r]; ++p)
      m = fmaxf(m, H[p * kLdH + j]);
    out[(long long)(row0 + r) * OUT + j] = rcount[r] > 0 ? m : 0.f;
  }
}

}  // namespace

// All pointers f32 and contiguous except mask (bool bytes). w1 [C,128],
// w2 [128,256], w3 [512,256], w4 [256,OUT] (row-major [in, out]); out
// [N, OUT]; P <= 128, C <= 32. Returns cudaGetLastError().
extern "C" int rift_points_fwd(const void* x, const void* mask, const void* w1,
                               const void* b1, const void* ln1s,
                               const void* ln1b, const void* w2, const void* b2,
                               const void* w3, const void* b3,
                               const void* ln2s, const void* ln2b,
                               const void* w4, const void* b4, void* out,
                               int N, int P, int C, int OUT, int has_ln,
                               void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  if (P < 1 || P > kM || C < 1 || C > kMaxC || OUT < 1 || OUT > kH2)
    return (int)cudaErrorInvalidValue;
  const int rows_per_tile = kM / P < kMaxRows ? kM / P : kMaxRows;
  cudaError_t err = cudaFuncSetAttribute(
      points_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (N + rows_per_tile - 1) / rows_per_tile;
  points_kernel<<<tiles, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const float*)x, (const unsigned char*)mask, (const float*)w1,
      (const float*)b1, (const float*)ln1s, (const float*)ln1b,
      (const float*)w2, (const float*)b2, (const float*)w3, (const float*)b3,
      (const float*)ln2s, (const float*)ln2b, (const float*)w4,
      (const float*)b4, (float*)out, N, P, C, OUT, rows_per_tile, has_ln);
  return (int)cudaGetLastError();
}
