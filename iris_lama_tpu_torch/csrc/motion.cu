// PFSlam2D's motion step: the K odometry packets queued since the last
// update applied to every particle, in queue order, in one launch.
//
// For each packet j (x, y, cos, sin) and particle i, with standard normal
// draws eps[j, i, 0:3], the reference's drawFromMotion
// (pf_slam2d.cpp:365-391) as algos/pf_slam2d.py:draw_from_motion computes
// it in float32:
//
//   drot  = atan2(sin, cos)
//   sig_x = stt |dx| + str |drot| + sxy |dy|
//   sig_y = stt |dy| + str |drot| + sxy |dx|
//   sig_r = srr |drot| + srt sqrt(dx dx + dy dy)
//   x = dx + eps0 sig_x   y = dy + eps1 sig_y   yaw = drot + eps2 sig_r
//   yaw = remainder(yaw, 2 pi); yaw > pi -> yaw - 2 pi
//   pose = pose * se2(x, y, yaw)                       (lie.se2_compose)
//
// poses [n, 4] -> out [n, 4] (x, y, cos, sin), all float32 and contiguous;
// packets [k, 4], eps [k, n, 3].
//
// Replaces no TPU kernel: the JAX package runs draw_from_motion once a
// packet inside its jitted update, where XLA fuses it. The eager port paid
// ~55 elementwise launches and two pageable copies a packet (~21 packets
// an update behind the PF's 0.5 m gate). Bound on the H100: launch latency
// by its work. One call moves 32 n bytes of poses in and out and
// (12 n + 16) k bytes of draws and packets (K = 21, N = 30: 8.9 KB, ~3 ns
// at 3.35 TB/s) and does ~150 operations a packet and particle with
// atan2f, cosf and sinf (~95 k operations, ~1.4 ns); an empty kernel of
// the same launch shape takes 0.83 us. Design: one thread a particle
// (blocks of 128, so N = 30 and the sharded configurations' N = 512
// alike), which loads its pose once, runs the K packets' chain in
// registers and writes the pose once; every thread computes the packet's
// own terms (drot and the sigmas) itself, as cheap as a broadcast through
// shared memory. At N = 30 one warp walks the K packets in turn, so the
// call takes ~0.6 us a packet (12.7 us at K = 21, PERF.md): spreading the
// packets' terms over threads would cut that, but the card idles through
// most of a PF update, so the launches and copies this kernel removes are
// what the update waited on. Each line of the chain rounds as
// the eager op does (the file builds with -fmad=false, so no product is
// contracted into an FMA), and the remainder is torch.remainder's float
// rule (fmod, then + b where the signs differ and the result is non-zero),
// so the kernel gives draw_from_motion's poses bit for bit.

#include <cuda_runtime.h>

namespace {

struct Sigmas {
  float stt, str, srr, srt, sxy, pi, two_pi;
};

__device__ __forceinline__ float remainder_f(float a, float b) {
  float mod = fmodf(a, b);
  if (mod != 0.0f && ((b < 0.0f) != (mod < 0.0f))) mod += b;
  return mod;
}

__global__ void motion_kernel(const float* __restrict__ poses,
                              const float* __restrict__ packets,
                              const float* __restrict__ eps, int k, int n,
                              Sigmas s, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float px = poses[4 * i], py = poses[4 * i + 1];
  float pc = poses[4 * i + 2], ps = poses[4 * i + 3];
  for (int j = 0; j < k; ++j) {
    const float dx = packets[4 * j], dy = packets[4 * j + 1];
    const float drot = atan2f(packets[4 * j + 3], packets[4 * j + 2]);
    const float adx = fabsf(dx), ady = fabsf(dy), adr = fabsf(drot);
    const float sig_x = s.stt * adx + s.str * adr + s.sxy * ady;
    const float sig_y = s.stt * ady + s.str * adr + s.sxy * adx;
    const float sig_r = s.srr * adr + s.srt * sqrtf(dx * dx + dy * dy);
    const float* e = eps + 3 * ((long long)j * n + i);
    const float x = dx + e[0] * sig_x;
    const float y = dy + e[1] * sig_y;
    float yaw = remainder_f(drot + e[2] * sig_r, s.two_pi);
    if (yaw > s.pi) yaw = yaw - s.two_pi;
    const float c = cosf(yaw), sn = sinf(yaw);
    const float tx = px + pc * x - ps * y;
    const float ty = py + ps * x + pc * y;
    const float nc = pc * c - ps * sn;
    const float ns = ps * c + pc * sn;
    px = tx;
    py = ty;
    pc = nc;
    ps = ns;
  }
  out[4 * i] = px;
  out[4 * i + 1] = py;
  out[4 * i + 2] = pc;
  out[4 * i + 3] = ps;
}

}  // namespace

// stt, str, srr, srt, sxy, pi, two_pi: the float32 constants of
// draw_from_motion (sxy = 0.3 stt rounded once).
extern "C" int motion_apply(const float* poses, const float* packets,
                            const float* eps, int k, int n, float stt,
                            float str, float srr, float srt, float sxy,
                            float pi, float two_pi, float* out,
                            void* stream) {
  if (n > 0) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    const Sigmas s{stt, str, srr, srt, sxy, pi, two_pi};
    motion_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        poses, packets, eps, k, n, s, out);
  }
  return (int)cudaGetLastError();
}
