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
// searched, is below that. In practice it is latency: each candidate is a
// chain of 39 dependent steps, each a closest-point search and a run of
// accurate trig calls, divisions and square roots whose branches to their
// slow paths keep the compiler from overlapping them. So the design puts
// two lanes on each candidate and shortens each step's chain:
//   - a pair of lanes of a warp follows one candidate: 9216 candidates make
//     576 warps. Both lanes run the tracker and the bicycle step;
//   - each lane keeps its half of the path (the even or the odd points) in
//     registers for paths of up to kRegT points, the main path's T, so the
//     search reads no memory and is unrolled; longer paths read the halves
//     from shared memory. A shuffle keeps the lexicographically smaller
//     (distance, index) pair: the first index among equal distances, as
//     the serial search's `d < best`. A lane that finds no distance below
//     inf reports (inf, 0), so a path of all-inf or NaN distances gives 0;
//   - where a step has two independent calls of one function, each lane
//     makes one and a shuffle swaps the results: the square roots of the
//     two segment lengths and of the two aim distances, the two PID
//     updates (the even lane keeps the speed PID's window, the odd lane the
//     turn PID's), and sincosf of the heading plus slip and of the slip;
//     the rotation into the vehicle frame takes sincosf of -heading.
// Every floating-point operation and its order are those of the serial
// kernel (sincosf gives sinf's and cosf's bits), so the outputs are
// bit-identical to it. Four lanes measured no faster and eight slower
// (PERF.md): past the search, a wider group only adds warps that repeat
// the same chain. A
// block is kCands candidates; their paths are staged in shared memory
// transposed to [T][kCands], where the aim lookups at closest+9/19/29 hit
// one bank per candidate; outputs are staged the same way and written back
// coalesced. A pair past G (the block's ragged tail) follows the block's
// last candidate, so that both lanes reach every shuffle, and its outputs
// are not copied out.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kLanes = 2;    // lanes per candidate
constexpr int kCands = 32;   // candidates per block
constexpr int kThreads = kCands * kLanes;
constexpr int kRegT = 40;    // paths this long keep their points in registers
constexpr int kPts = kRegT / kLanes;  // path points per lane in registers
constexpr int kWindow = 20;  // sim/pid.py PID_WINDOW
constexpr int kMaxT = 256;
constexpr int kMaxDevices = 64;
constexpr float kRad2Deg = 57.29577951308232f;
static_assert(kRegT % kLanes == 0 && 32 % kLanes == 0, "lane groups tile the warp and the path");

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

// the pair's other lane's value of x
__device__ __forceinline__ float swap(float x) {
  return __shfl_xor_sync(0xffffffffu, x, 1, kLanes);
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

// kInRegs: T <= kRegT, each lane's half of the path in registers;
// otherwise the search reads the halves from shared memory.
template <bool kInRegs>
__global__ void __launch_bounds__(kThreads)
    retrack_kernel(const float* __restrict__ ref_pos,
                   const float* __restrict__ h0,
                   const float* __restrict__ v0, float* __restrict__ out_pos,
                   float* __restrict__ out_heading,
                   float* __restrict__ out_speed, int G, int T, Consts k) {
  extern __shared__ float smem[];
  float* sx = smem;  // [T][kCands] path x
  float* sy = sx + T * kCands;
  float* ox = sy + T * kCands;  // [T][kCands] outputs
  float* oy = ox + T * kCands;
  float* oh = oy + T * kCands;
  float* ov = oh + T * kCands;

  const int g0 = blockIdx.x * kCands;
  const int n = min(kCands, G - g0);
  const int tid = threadIdx.x;
  // candidate c of the block (column cc of the staged paths) and lane sub
  // of its pair
  const int c = tid / kLanes, sub = tid % kLanes;
  const bool odd = sub & 1;
  const int cc = min(c, n - 1);
  float hd = h0[g0 + cc];
  float v = v0[g0 + cc];
  const float* src = ref_pos + (long long)g0 * T * 2;
  for (int i = tid; i < n * T * 2; i += kThreads) {
    const int g = i / (2 * T), r = i - g * 2 * T, t = r >> 1;
    ((r & 1) ? sy : sx)[t * kCands + g] = src[i];
  }
  __syncthreads();

  const float* kc = k.c;
  float px = sx[cc], py = sy[cc];
  ox[c] = px;
  oy[c] = py;
  oh[c] = hd;
  ov[c] = v;
  // this lane's share of the path; NaN past T, which no search picks
  float qx[kInRegs ? kPts : 1], qy[kInRegs ? kPts : 1];
  if constexpr (kInRegs) {
#pragma unroll
    for (int p = 0; p < kPts; ++p) {
      const int i = sub + kLanes * p;
      qx[p] = i < T ? sx[i * kCands + cc] : NAN;
      qy[p] = i < T ? sy[i * kCands + cc] : NAN;
    }
  }
  // this lane's PID window: the speed PID's on the even lane, the turn
  // PID's on the odd one
  float w[kWindow];
#pragma unroll
  for (int i = 0; i < kWindow; ++i) w[i] = 0.f;
  int closest = 0;

  for (int t = 0; t < T - 1; ++t) {
    // the resampled local waypoints: path points closest+9/19/29 in the
    // vehicle frame (rotation by -heading)
    float ch, sh;
    sincosf(-hd, &sh, &ch);
    float x[3], y[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int i = min(closest + 9 + 10 * j, T - 1);
      const float rx = sx[i * kCands + cc] - px;
      const float ry = sy[i * kCands + cc] - py;
      x[j] = rx * ch - ry * sh;
      y[j] = rx * sh + ry * ch;
    }
    const float e1x = x[1] - x[0], e1y = y[1] - y[0];
    const float e2x = x[2] - x[1], e2y = y[2] - y[1];
    // the two segment lengths and the two aim distances, one of each a lane
    const float ra = sqrtf(odd ? e2x * e2x + e2y * e2y : e1x * e1x + e1y * e1y);
    const float rb = sqrtf(odd ? x[1] * x[1] + y[1] * y[1] : x[0] * x[0] + y[0] * y[0]);
    const float oa = swap(ra), ob = swap(rb);
    const float desired = ((odd ? oa : ra) + (odd ? ra : oa)) / 2.f;
    const float n0 = odd ? ob : rb, n1 = odd ? rb : ob;
    const float aim = clampf(kc[kAimAlpha] * v + kc[kAimBeta], kc[kMinAim], kc[kMaxAim]);
    const bool use1 = fabsf(n1 - aim) < fabsf(n0 - aim);
    const float ax = use1 ? x[1] : x[0], ay = use1 ? y[1] : y[0];

    const bool brake = desired < kc[kBrakeSpeed] ||
                       v / fmaxf(desired, 1e-4f) > kc[kBrakeRatio];
    const float delta = clampf(desired - v, 0.f, kc[kClipDelta]);
    float angle = atan2f(ay, ax) * kRad2Deg / 90.f;
    if (v < 0.01f || brake) angle = 0.f;
    // the speed PID on the even lane, the turn PID on the odd one
    const float out = pid(w, odd ? angle : delta, odd ? kc[kTurnKp] : kc[kSpeedKp],
                          odd ? kc[kTurnKi] : kc[kSpeedKi], odd ? kc[kTurnKd] : kc[kSpeedKd]);
    const float other = swap(out);
    const float throttle = brake ? 0.f : clampf(odd ? other : out, 0.f, kc[kMaxThrottle]);
    const float steer = clampf(odd ? out : other, -1.f, 1.f);

    // bicycle step (sim/dynamics.py:bicycle_step)
    const float slip = atanf(kc[kSlipK] * tanf(kc[kSteerGain] * steer));
    // sincosf of heading + slip on the even lane, of slip on the odd one
    float s1, c1;
    sincosf(odd ? slip : hd + slip, &s1, &c1);
    const float s2 = swap(s1), c2 = swap(c1);
    const float cg = odd ? c2 : c1, sg = odd ? s2 : s1, ss = odd ? s1 : s2;
    const float npx = px + v * cg * kc[kDt];
    const float npy = py + v * sg * kc[kDt];
    hd = hd + (v / kc[kRearWb]) * ss * kc[kDt];
    const float vk = v * 3.6f;
    float p = vk, vb = 0.f;
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      vb += p * kc[kBrake0 + i];
      p *= vk;
    }
    const float tt = throttle;
    const float f[8] = {vk,      vk * vk,      tt,           tt * tt,
                        vk * tt, vk * tt * tt, vk * vk * tt, vk * vk * tt * tt};
    float vt = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) vt += f[i] * kc[kThrottle0 + i];
    float vn = brake ? vb : vk;
    if (!brake && throttle >= kc[kThrottleMin]) vn = vt;
    v = fmaxf(vn / 3.6f, 0.f);
    px = npx;
    py = npy;

    // closest path point, first argmin: this lane's share, then the pair's
    float best = INFINITY;
    closest = 0;
    if constexpr (kInRegs) {
#pragma unroll
      for (int q = 0; q < kPts; ++q) {
        const float dx = qx[q] - px, dy = qy[q] - py;
        const float d = dx * dx + dy * dy;
        if (d < best) {
          best = d;
          closest = sub + kLanes * q;
        }
      }
    } else {
      for (int i = sub; i < T; i += kLanes) {
        const float dx = sx[i * kCands + cc] - px;
        const float dy = sy[i * kCands + cc] - py;
        const float d = dx * dx + dy * dy;
        if (d < best) {
          best = d;
          closest = i;
        }
      }
    }
#pragma unroll
    for (int off = 1; off < kLanes; off <<= 1) {
      const float bo = __shfl_xor_sync(0xffffffffu, best, off, kLanes);
      const int co = __shfl_xor_sync(0xffffffffu, closest, off, kLanes);
      if (bo < best || (bo == best && co < closest)) {
        best = bo;
        closest = co;
      }
    }
    const int o = (t + 1) * kCands + c;
    ox[o] = px;
    oy[o] = py;
    oh[o] = hd;
    ov[o] = v;
  }
  __syncthreads();

  float* dst = out_pos + (long long)g0 * T * 2;
  for (int i = tid; i < n * T * 2; i += kThreads) {
    const int g = i / (2 * T), r = i - g * 2 * T, t = r >> 1;
    dst[i] = ((r & 1) ? oy : ox)[t * kCands + g];
  }
  for (int i = tid; i < n * T; i += kThreads) {
    const int g = i / T, t = i - g * T;
    out_heading[(long long)g0 * T + i] = oh[t * kCands + g];
    out_speed[(long long)g0 * T + i] = ov[t * kCands + g];
  }
}

}  // namespace

// ref_pos [G,T,2], h0 [G], v0 [G] f32 contiguous; outputs
// center [G,T,2], heading [G,T], speed [G,T]. consts: host array of
// kNumConsts floats. Returns cudaGetLastError().
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
  const int smem = 6 * T * kCands * (int)sizeof(float);
  const int blocks = (G + kCands - 1) / kCands;
  const auto launch = [&](auto kernel) {
    kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)ref_pos, (const float*)h0, (const float*)v0,
        (float*)out_pos, (float*)out_heading, (float*)out_speed, G, T, k);
  };
  if (T <= kRegT) {
    launch(retrack_kernel<true>);
  } else {
    // the longest paths need more than the default 48 KB: opted into once
    // per device, for the largest T
    static bool opted[kMaxDevices];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (!opted[dev]) {
      err = cudaFuncSetAttribute(retrack_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 6 * kMaxT * kCands * (int)sizeof(float));
      if (err != cudaSuccess) return (int)err;
      opted[dev] = true;
    }
    launch(retrack_kernel<false>);
  }
  return (int)cudaGetLastError();
}
