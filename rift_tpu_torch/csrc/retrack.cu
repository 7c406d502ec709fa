// Closed-loop re-tracking of GRPO candidate trajectories, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel rift_tpu/ops/retrack.py:retrack_rollout_pallas
// (body _retrack_kernel). Each of G candidates is a path of T world-frame
// points (ref_pos [G,T,2]) followed from (ref_pos[g,0], h0[g], v0[g]),
// the path's start, initial heading and speed, for T-1 steps
// of 0.1 s by the shared tracker and bicycle model, as the plain version
// (ops/retrack.py:retrack_rollout_ref, the JAX package's lax.scan) does:
//   - aim points at closest+9/19/29 (clamped to T-1), rotated into the
//     vehicle frame; desired speed = their mean segment length; the aim is
//     the first of the two nearer points whose distance is closest to
//     clip(0.5 v + 2.5, 5, 8) (first index on ties);
//   - speed and turn PIDs over a zero-prefilled window of 20 (integral =
//     window mean, derivative = error - previous error); steering from
//     atan2 of the vehicle-frame aim point, in degrees / 90;
//   - the World-on-Rails bicycle step with the brake and throttle speed
//     polynomials;
//   - the closest path point re-found as the first argmin of the squared
//     distance.
// Outputs: center [G,T,2], heading [G,T], speed [G,T], row 0 the start.
// The tracker and model constants come from the Python modules at launch
// (struct Consts), so the kernel and the plain version share one source.
// The file builds with -fmad=false (ops/build.py) so that products and
// sums round as the plain version's separate tensor ops do.
//
// What bounds it on the H100: bytes, 3.0 MB in and 5.9 MB out at G = 9216,
// T = 40 (2.7 us at 3.35 TB/s); its arithmetic, ~50 flops per path point
// searched, is below that. In practice it is latency: 39 dependent steps,
// each a 40-point search, per thread. One thread per candidate keeps the
// position, heading, speed, closest index and both PID windows in
// registers (the windows are shift registers with constant indices). A
// block is one warp: 9216 candidates make 288 blocks, spread over all 132
// SMs (blocks of 128 would fill only 72 of them). The block's paths are
// staged in shared memory transposed to [T][32], so a lane reading its own
// path point at any index hits its own bank; outputs are staged the same
// way and written back coalesced.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 32;
constexpr int kWindow = 20;  // sim/pid.py PID_WINDOW
constexpr int kMaxT = 256;
constexpr float kRad2Deg = 57.29577951308232f;

// the order of ops/retrack.py:_constants
enum {
  kDt, kSpeedKp, kSpeedKi, kSpeedKd, kTurnKp, kTurnKi, kTurnKd, kMaxThrottle,
  kBrakeSpeed, kBrakeRatio, kClipDelta, kAimAlpha, kAimBeta, kMinAim, kMaxAim,
  kSlipK, kRearWb, kSteerGain, kThrottleMin, kBrake0,
  kThrottle0 = kBrake0 + 7, kNumConsts = kThrottle0 + 8
};

struct Consts {
  float c[kNumConsts];
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// One PID update on a shift-register window w[0..kWindow-1] (newest last):
// kp * e + ki * mean(window) + kd * (e - previous e).
__device__ __forceinline__ float pid(float (&w)[kWindow], float e, float kp,
                                     float ki, float kd) {
  const float prev = w[kWindow - 1];
#pragma unroll
  for (int i = 0; i < kWindow - 1; ++i) w[i] = w[i + 1];
  w[kWindow - 1] = e;
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kWindow; ++i) sum += w[i];
  return kp * e + ki * (sum / (float)kWindow) + kd * (e - prev);
}

__global__ void __launch_bounds__(kThreads)
    retrack_kernel(const float* __restrict__ ref_pos,
                   const float* __restrict__ h0,
                   const float* __restrict__ v0, float* __restrict__ out_pos,
                   float* __restrict__ out_heading,
                   float* __restrict__ out_speed, int G, int T, Consts k) {
  extern __shared__ float smem[];
  float* sx = smem;  // [T][kThreads] path x
  float* sy = sx + T * kThreads;
  float* ox = sy + T * kThreads;  // [T][kThreads] outputs
  float* oy = ox + T * kThreads;
  float* oh = oy + T * kThreads;
  float* ov = oh + T * kThreads;

  const int g0 = blockIdx.x * kThreads;
  const int n = min(kThreads, G - g0);
  const int lane = threadIdx.x;
  const float* src = ref_pos + (long long)g0 * T * 2;
  for (int i = lane; i < n * T * 2; i += kThreads) {
    const int g = i / (2 * T), r = i - g * 2 * T, t = r >> 1;
    ((r & 1) ? sy : sx)[t * kThreads + g] = src[i];
  }
  __syncthreads();

  if (lane < n) {
    const float* c = k.c;
    float px = sx[lane], py = sy[lane];
    float hd = h0[g0 + lane];
    float v = v0[g0 + lane];
    ox[lane] = px;
    oy[lane] = py;
    oh[lane] = hd;
    ov[lane] = v;
    float ws[kWindow], wt[kWindow];
#pragma unroll
    for (int i = 0; i < kWindow; ++i) ws[i] = wt[i] = 0.f;
    int closest = 0;

    for (int t = 0; t < T - 1; ++t) {
      // the resampled local waypoints: path points closest+9/19/29 in the
      // vehicle frame (rotation by -heading)
      const float ch = cosf(-hd), sh = sinf(-hd);
      float x[3], y[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int i = min(closest + 9 + 10 * j, T - 1);
        const float rx = sx[i * kThreads + lane] - px;
        const float ry = sy[i * kThreads + lane] - py;
        x[j] = rx * ch - ry * sh;
        y[j] = rx * sh + ry * ch;
      }
      const float e1x = x[1] - x[0], e1y = y[1] - y[0];
      const float e2x = x[2] - x[1], e2y = y[2] - y[1];
      const float desired =
          (sqrtf(e1x * e1x + e1y * e1y) + sqrtf(e2x * e2x + e2y * e2y)) / 2.f;
      const float aim = clampf(c[kAimAlpha] * v + c[kAimBeta], c[kMinAim], c[kMaxAim]);
      const float n0 = sqrtf(x[0] * x[0] + y[0] * y[0]);
      const float n1 = sqrtf(x[1] * x[1] + y[1] * y[1]);
      const bool use1 = fabsf(n1 - aim) < fabsf(n0 - aim);
      const float ax = use1 ? x[1] : x[0], ay = use1 ? y[1] : y[0];

      const bool brake = desired < c[kBrakeSpeed] ||
                         v / fmaxf(desired, 1e-4f) > c[kBrakeRatio];
      const float delta = clampf(desired - v, 0.f, c[kClipDelta]);
      float throttle = pid(ws, delta, c[kSpeedKp], c[kSpeedKi], c[kSpeedKd]);
      throttle = brake ? 0.f : clampf(throttle, 0.f, c[kMaxThrottle]);
      float angle = atan2f(ay, ax) * kRad2Deg / 90.f;
      if (v < 0.01f || brake) angle = 0.f;
      const float steer =
          clampf(pid(wt, angle, c[kTurnKp], c[kTurnKi], c[kTurnKd]), -1.f, 1.f);

      // bicycle step (sim/dynamics.py:bicycle_step)
      const float slip = atanf(c[kSlipK] * tanf(c[kSteerGain] * steer));
      const float npx = px + v * cosf(hd + slip) * c[kDt];
      const float npy = py + v * sinf(hd + slip) * c[kDt];
      hd = hd + (v / c[kRearWb]) * sinf(slip) * c[kDt];
      const float vk = v * 3.6f;
      float p = vk, vb = 0.f;
#pragma unroll
      for (int i = 0; i < 7; ++i) {
        vb += p * c[kBrake0 + i];
        p *= vk;
      }
      const float tt = throttle;
      const float f[8] = {vk,      vk * vk,      tt,           tt * tt,
                          vk * tt, vk * tt * tt, vk * vk * tt, vk * vk * tt * tt};
      float vt = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) vt += f[i] * c[kThrottle0 + i];
      float vn = brake ? vb : vk;
      if (!brake && throttle >= c[kThrottleMin]) vn = vt;
      v = fmaxf(vn / 3.6f, 0.f);
      px = npx;
      py = npy;

      // closest path point, first argmin
      float best = INFINITY;
      closest = 0;
      for (int i = 0; i < T; ++i) {
        const float dx = sx[i * kThreads + lane] - px;
        const float dy = sy[i * kThreads + lane] - py;
        const float d = dx * dx + dy * dy;
        if (d < best) {
          best = d;
          closest = i;
        }
      }
      const int o = (t + 1) * kThreads + lane;
      ox[o] = px;
      oy[o] = py;
      oh[o] = hd;
      ov[o] = v;
    }
  }
  __syncthreads();

  float* dst = out_pos + (long long)g0 * T * 2;
  for (int i = lane; i < n * T * 2; i += kThreads) {
    const int g = i / (2 * T), r = i - g * 2 * T, t = r >> 1;
    dst[i] = ((r & 1) ? oy : ox)[t * kThreads + g];
  }
  for (int i = lane; i < n * T; i += kThreads) {
    const int g = i / T, t = i - g * T;
    out_heading[(long long)g0 * T + i] = oh[t * kThreads + g];
    out_speed[(long long)g0 * T + i] = ov[t * kThreads + g];
  }
}

}  // namespace

extern "C" int rift_retrack_num_consts() { return kNumConsts; }

// ref_pos [G,T,2], h0 [G], v0 [G] f32 contiguous; outputs
// center [G,T,2], heading [G,T], speed [G,T]. consts: host array of
// rift_retrack_num_consts() floats. Returns cudaGetLastError().
extern "C" int rift_retrack_fwd(const void* ref_pos, const void* h0,
                                const void* v0, void* out_pos,
                                void* out_heading, void* out_speed, int G,
                                int T, const float* consts, int n_consts,
                                void* stream) {
  if (G <= 0) return (int)cudaSuccess;
  if (T < 1 || T > kMaxT || n_consts != kNumConsts)
    return (int)cudaErrorInvalidValue;
  Consts k;
  for (int i = 0; i < kNumConsts; ++i) k.c[i] = consts[i];
  const int smem = 6 * T * kThreads * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      retrack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (G + kThreads - 1) / kThreads;
  retrack_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)ref_pos, (const float*)h0, (const float*)v0,
      (float*)out_pos, (float*)out_heading, (float*)out_speed, G, T, k);
  return (int)cudaGetLastError();
}
