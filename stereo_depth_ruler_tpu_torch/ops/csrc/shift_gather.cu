// K7: the WLS filter's left-right gather, confidence and right-hand sides.
//
// Replaces stereo_depth_ruler_tpu/ops/wls_pallas.py:_shift_gather_kernel
// (launched by shift_gather_pallas) together with the elementwise code
// around it in wls_disparity_filter_pallas. On the TPU a per-lane gather
// at a variable distance had to be built from log2(D) conditional rolls of
// a (K, D, W) broadcast; here the gather reads a staged row. Per pixel:
//   s = x - rint(x - dl)            (round half to even, the jnp form)
//   dr = disp_right[y, x - s]       if 0 <= s <= max_s and x - s >= 0,
//        fill                       otherwise
//   conf = dl >= 0 && dr >= 0 && |dr - dl| <= lrc_thresh
//   rhs[0] = conf * max(dl, 0), rhs[1] = conf
// Exact float operations (__fsub_rn, rintf, __fmul_rn), so it matches the
// plain version (ops/wls.py:shift_gather_conf) bit for bit.
//
// Design: a block per image row and frame (grid (H, B): no division). The
// block stages the row of disp_right in shared memory (16-byte loads), so
// the gather, which stays inside the row (0 <= x - s <= x), reads shared
// memory; then a thread takes 4 consecutive pixels: one 16-byte load of
// dl and one 16-byte store to each output plane. A row whose width is not
// a multiple of 4 is not 16-byte aligned, so such a frame takes the same
// design with scalar loads and stores.
//
// What bounds it on the H100: device-memory bytes, 16 B per pixel (dl and
// dr in, two planes out).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ void pixel(const float* dr_s, float d, int x,
                                      int max_s, float lrc, float fill,
                                      float* r0, float* r1) {
  const float fx = (float)x;
  const int s = (int)__fsub_rn(fx, rintf(__fsub_rn(fx, d)));
  float v = fill;
  if (s >= 0 && s <= max_s && x - s >= 0) v = dr_s[x - s];
  const bool conf = d >= 0.0f && v >= 0.0f && fabsf(__fsub_rn(v, d)) <= lrc;
  const float c = conf ? 1.0f : 0.0f;
  *r0 = __fmul_rn(c, fmaxf(d, 0.0f));
  *r1 = c;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
shift_gather_conf_kernel(const float* __restrict__ dl,
                         const float* __restrict__ dr,
                         float* __restrict__ rhs, int H, int W, int max_s,
                         float lrc, float fill) {
  extern __shared__ __align__(16) float dr_s[];   // [W]
  const int y = blockIdx.x, b = blockIdx.y;
  const size_t n = (size_t)H * W;
  const size_t row = (size_t)b * n + (size_t)y * W;
  const float* dlr = dl + row;
  float* o0 = rhs + 2 * (size_t)b * n + (size_t)y * W;   // plane 0
  float* o1 = o0 + n;                                     // plane 1
  if (VEC) {
    const int W4 = W >> 2;
    for (int i = threadIdx.x; i < W4; i += THREADS)
      ((float4*)dr_s)[i] = ((const float4*)(dr + row))[i];
    __syncthreads();
    for (int i = threadIdx.x; i < W4; i += THREADS) {
      const float4 d = ((const float4*)dlr)[i];
      const int x = 4 * i;
      float4 a, c;
      pixel(dr_s, d.x, x, max_s, lrc, fill, &a.x, &c.x);
      pixel(dr_s, d.y, x + 1, max_s, lrc, fill, &a.y, &c.y);
      pixel(dr_s, d.z, x + 2, max_s, lrc, fill, &a.z, &c.z);
      pixel(dr_s, d.w, x + 3, max_s, lrc, fill, &a.w, &c.w);
      ((float4*)o0)[i] = a;
      ((float4*)o1)[i] = c;
    }
  } else {
    for (int x = threadIdx.x; x < W; x += THREADS) dr_s[x] = dr[row + x];
    __syncthreads();
    for (int x = threadIdx.x; x < W; x += THREADS)
      pixel(dr_s, dlr[x], x, max_s, lrc, fill, o0 + x, o1 + x);
  }
}

}  // namespace

// dl, dr: (B, H, W) float32; rhs: (B, 2, H, W) float32 out. W up to the
// card's shared memory per block (4 B a column).
extern "C" int sdr_shift_gather_conf(const float* dl, const float* dr,
                                     float* rhs, int B, int H, int W,
                                     int max_s, float lrc, float fill,
                                     void* stream) {
  if (B < 1 || H < 1 || W < 1 || B > 65535 ||
      (long long)H * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)W;
  const bool vec = W % 4 == 0 && ((uintptr_t)dl & 15) == 0 &&
                   ((uintptr_t)dr & 15) == 0 && ((uintptr_t)rhs & 15) == 0;
  auto kern = vec ? shift_gather_conf_kernel<true>
                  : shift_gather_conf_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(H, B), THREADS, smem, (cudaStream_t)stream>>>(
      dl, dr, rhs, H, W, max_s, lrc, fill);
  return (int)cudaGetLastError();
}
