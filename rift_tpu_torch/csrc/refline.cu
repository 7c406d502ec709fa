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
// Nr = 120 the search is 44M point pairs of ~5 flops (3.3 us at the 67
// TFLOP/s f32 rate) against ~8.6 MB of inputs and outputs (2.6 us). One
// block per pair stages the line (x, y, heading, valid) in shared memory,
// where every lane of a warp reads the same point (a broadcast); each
// thread owns candidate points i = tid, tid + 128, ... and keeps its best
// distance in registers. Nothing but the inputs and the outputs touches
// device memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxNr = 2048;  // 26 KB of shared memory

__global__ void __launch_bounds__(kThreads)
    refline_kernel(const float* __restrict__ cand_pos,
                   const float* __restrict__ cand_heading,
                   const float* __restrict__ ref_pos,
                   const float* __restrict__ ref_heading,
                   const unsigned char* __restrict__ ref_valid,
                   float* __restrict__ dis, float* __restrict__ ang,
                   int* __restrict__ idx, int MT, int Nr) {
  extern __shared__ float smem[];
  float* rx = smem;
  float* ry = rx + Nr;
  float* rh = ry + Nr;
  unsigned char* rv = (unsigned char*)(rh + Nr);

  const long long b = blockIdx.x;
  for (int j = threadIdx.x; j < Nr; j += kThreads) {
    rx[j] = ref_pos[(b * Nr + j) * 2];
    ry[j] = ref_pos[(b * Nr + j) * 2 + 1];
    rh[j] = ref_heading[b * Nr + j];
    rv[j] = ref_valid[b * Nr + j];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < MT; i += kThreads) {
    const long long o = b * MT + i;
    const float cx = cand_pos[o * 2], cy = cand_pos[o * 2 + 1];
    float best = INFINITY;
    int jb = 0;
    for (int j = 0; j < Nr; ++j) {
      if (!rv[j]) continue;
      const float dx = cx - rx[j], dy = cy - ry[j];
      const float d = dx * dx + dy * dy;
      if (d < best) {
        best = d;
        jb = j;
      }
    }
    const float h = rh[jb];
    const float tx = cosf(h), ty = sinf(h);
    const float relx = cx - rx[jb], rely = cy - ry[jb];
    dis[o] = -(relx * ty - rely * tx);
    const float da = cand_heading[o] - h;
    ang[o] = atan2f(sinf(da), cosf(da));
    if (idx) idx[o] = jb;
  }
}

}  // namespace

extern "C" long long rift_refline_smem_bytes(int Nr) {
  return (long long)Nr * (3 * sizeof(float) + 1);
}

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
  const int smem = (int)rift_refline_smem_bytes(Nr);
  refline_kernel<<<BR, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)cand_pos, (const float*)cand_heading,
      (const float*)ref_pos, (const float*)ref_heading,
      (const unsigned char*)ref_valid, (float*)dis, (float*)ang, (int*)idx, MT,
      Nr);
  return (int)cudaGetLastError();
}
