// K7: the WLS filter's left-right gather, confidence and right-hand sides.
//
// Replaces stereo_depth_ruler_tpu/ops/wls_pallas.py:_shift_gather_kernel
// (launched by shift_gather_pallas) together with the elementwise code
// around it in wls_disparity_filter_pallas. On the TPU a per-lane gather
// at a variable distance had to be built from log2(D) conditional rolls of
// a (K, D, W) broadcast; here a thread simply loads the one element it
// needs. One thread per pixel, grid.z over frames:
//   s = x - rint(x - dl)            (round half to even, the jnp form)
//   dr = disp_right[y, x - s]       if 0 <= s <= max_s and x - s >= 0,
//        fill                       otherwise
//   conf = dl >= 0 && dr >= 0 && |dr - dl| <= lrc_thresh
//   rhs[0] = conf * max(dl, 0), rhs[1] = conf
// Exact float operations (__fsub_rn, rintf, __fmul_rn), so it matches the
// plain version (ops/wls.py:shift_gather_conf) bit for bit.
//
// What bounds it on the H100: device-memory bytes, 16 B per pixel (dl and
// dr in, two planes out); the gathered load hits the row just read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void shift_gather_conf_kernel(const float* __restrict__ dl,
                                         const float* __restrict__ dr,
                                         float* __restrict__ rhs, int W,
                                         int n, int max_s, float lrc,
                                         float fill) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t b = blockIdx.z;
  const int x = i % W;
  const float d = dl[b * n + i];
  const float fx = (float)x;
  const int s = (int)__fsub_rn(fx, rintf(__fsub_rn(fx, d)));
  float v = fill;
  if (s >= 0 && s <= max_s && x - s >= 0) v = dr[b * n + i - s];
  const bool conf = d >= 0.0f && v >= 0.0f && fabsf(__fsub_rn(v, d)) <= lrc;
  const float c = conf ? 1.0f : 0.0f;
  rhs[2 * b * n + i] = __fmul_rn(c, fmaxf(d, 0.0f));
  rhs[(2 * b + 1) * n + i] = c;
}

}  // namespace

// dl, dr: (B, H, W) float32; rhs: (B, 2, H, W) float32 out.
extern "C" int sdr_shift_gather_conf(const float* dl, const float* dr,
                                     float* rhs, int B, int H, int W,
                                     int max_s, float lrc, float fill,
                                     void* stream) {
  if (B < 1 || H < 1 || W < 1 || B > 65535 ||
      (long long)H * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int n = H * W;
  const dim3 grid((n + THREADS - 1) / THREADS, 1, B);
  shift_gather_conf_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      dl, dr, rhs, W, n, max_s, lrc, fill);
  return (int)cudaGetLastError();
}
