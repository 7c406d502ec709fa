// Candidate-vs-reference-line matrices of the GRPO evaluator, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel rift_tpu/ops/refline.py:refline_matrices_pallas
// (body _refline_kernel). For each (CBV, reference line) pair b and each of
// its MT candidate points i (cand_pos [BR,MT,2], cand_heading [BR,MT]):
// the nearest valid point j of the pair's line (ref_pos [BR,Nr,2],
// ref_heading [BR,Nr], ref_valid [BR,Nr] bytes) by squared distance, first
// index on ties; a line with no valid point gives j = 0, as an argmin over
// all-inf does. Outputs
//   dis[b,i] = -(rel x tangent), rel = c - r_j, tangent = (cos, sin)(h_j)
//   ang[b,i] = atan2(sin, cos)(cand_heading - h_j)
// and, when idx is not null, idx[b,i] = j. Distances are direct differences,
// as the TPU kernel's; the plain version (ops/refline.py) keeps the JAX
// package's |c|^2 + |r|^2 - 2 c.r expansion, so near-equal distances may
// resolve to the other point there. The file builds with -fmad=false
// (ops/build.py), so each product and sum rounds as a tensor op would.
//
// What bounds it on the H100: operations. At BR = 768 pairs, MT = 480,
// Nr = 120 the search is at most 44M point pairs of ~5 flops (3.3 us at
// the 67 TFLOP/s f32 rate; about half the line points are padding on the
// main path's lines) against ~8.6 MB of inputs and outputs (2.6 us). So
// the design spends as few instructions per point pair as it can:
//   - one block per pair compacts the line's valid points into shared
//     memory, in ascending order with their original indices (a warp
//     ballot and a popcount prefix over each 32 flags), so the search
//     visits only valid points and has no branch;
//   - each thread holds kPer candidate points in registers (a tile of
//     kThreads * kPer = 480, the main path's MT; other MT take more tiles
//     and mask the tail) and compares every staged point, read once as a
//     shared-memory broadcast, with all of them;
//   - a candidate keeps the first compacted index among equal distances,
//     which is the lowest original index. One that finds no distance below
//     inf (an all-padding line) takes j = 0, read from the uncompacted line.
// Every floating-point operation and its order are those of the one-point-
// a-thread kernel it replaces, so the outputs are bit-identical to it.
// Nothing but the inputs and the outputs touches device memory. Other
// tilings (96 x 5, 128 x 4, 480 x 1, a pair's points over three blocks)
// and loading the candidates before the line measured no faster (PERF.md).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 160;  // 5 warps
constexpr int kPer = 3;        // candidate points per thread
constexpr int kTile = kThreads * kPer;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxNr = 2048;  // 32 KB of shared memory

__global__ void __launch_bounds__(kThreads)
    refline_kernel(const float* __restrict__ cand_pos,
                   const float* __restrict__ cand_heading,
                   const float* __restrict__ ref_pos,
                   const float* __restrict__ ref_heading,
                   const unsigned char* __restrict__ ref_valid,
                   float* __restrict__ dis, float* __restrict__ ang,
                   int* __restrict__ idx, int MT, int Nr) {
  // the valid points: (x, y, heading, original index as float bits)
  extern __shared__ float4 pts[];
  __shared__ int counts[kWarps];

  const long long b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int nv = 0;
  for (int j0 = 0; j0 < Nr; j0 += kThreads) {
    const int j = j0 + tid;
    const bool ok = j < Nr && ref_valid[b * Nr + j];
    const unsigned m = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) counts[warp] = __popc(m);
    __syncthreads();
    int at = nv + __popc(m & ((1u << lane) - 1u));
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) at += counts[w];
      nv += counts[w];
    }
    if (ok)
      pts[at] = make_float4(ref_pos[(b * Nr + j) * 2], ref_pos[(b * Nr + j) * 2 + 1],
                            ref_heading[b * Nr + j], __int_as_float(j));
    __syncthreads();
  }

  for (int i0 = 0; i0 < MT; i0 += kTile) {
    // this thread's candidate points of the tile (the last one past MT)
    float cx[kPer], cy[kPer], best[kPer];
    int kb[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const long long o = b * MT + min(i0 + q * kThreads + tid, MT - 1);
      cx[q] = cand_pos[o * 2];
      cy[q] = cand_pos[o * 2 + 1];
      best[q] = INFINITY;
      kb[q] = -1;
    }
#pragma unroll 4
    for (int s = 0; s < nv; ++s) {
      const float4 r = pts[s];
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const float dx = cx[q] - r.x, dy = cy[q] - r.y;
        const float d = dx * dx + dy * dy;
        if (d < best[q]) {
          best[q] = d;
          kb[q] = s;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = i0 + q * kThreads + tid;
      if (i >= MT) continue;
      const long long o = b * MT + i;
      float rx, ry, h;
      int j;
      if (kb[q] >= 0) {
        const float4 r = pts[kb[q]];
        rx = r.x, ry = r.y, h = r.z, j = __float_as_int(r.w);
      } else {
        rx = ref_pos[b * Nr * 2], ry = ref_pos[b * Nr * 2 + 1], h = ref_heading[b * Nr], j = 0;
      }
      const float tx = cosf(h), ty = sinf(h);
      const float relx = cx[q] - rx, rely = cy[q] - ry;
      dis[o] = -(relx * ty - rely * tx);
      const float da = cand_heading[o] - h;
      ang[o] = atan2f(sinf(da), cosf(da));
      if (idx) idx[o] = j;
    }
  }
}

}  // namespace

// cand_pos [BR,MT,2], cand_heading [BR,MT], ref_pos [BR,Nr,2], ref_heading
// [BR,Nr] f32 and ref_valid [BR,Nr] bool bytes, all contiguous; dis, ang
// [BR,MT] f32; idx [BR,MT] int32 or null. Returns cudaGetLastError().
extern "C" int rift_refline_fwd(const void* cand_pos, const void* cand_heading,
                                const void* ref_pos, const void* ref_heading,
                                const void* ref_valid, void* dis, void* ang,
                                void* idx, int BR, int MT, int Nr,
                                void* stream) {
  if (BR <= 0 || MT <= 0) return (int)cudaSuccess;
  if (Nr < 1 || Nr > kMaxNr) return (int)cudaErrorInvalidValue;
  const int smem = Nr * (int)sizeof(float4);
  refline_kernel<<<BR, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)cand_pos, (const float*)cand_heading,
      (const float*)ref_pos, (const float*)ref_heading,
      (const unsigned char*)ref_valid, (float*)dis, (float*)ang, (int*)idx, MT,
      Nr);
  return (int)cudaGetLastError();
}
