// K3: winner-take-all, uniqueness, subpixel and the left-right check.
//
// Replaces stereo_depth_ruler_tpu/ops/sgbm_pallas.py:_wta_body (inside
// _up_wta_kernel, launched by up_wta_pallas) and its XLA fallback
// _lr_finalize. Semantics are those of ops/sgbm.py: wta, then lr_check,
// then disp where valid else -1.0.
//
// Design: one block per image row (b, y). Warps loop over the row's
// columns; for column x a warp reads the D path sums (lane l holds
// d = l*VPL .. l*VPL+VPL-1) and takes
//   - the packed key min(S*PK + d) with one __reduce_min_sync, so ties go
//     to the smallest d and one reduce gives both s0 and d*;
//   - the uniqueness test as the exact integer comparison
//     100 * min_{|d-d*|>1} S < (100 + u) * s0;
//   - the parabolic subpixel offset with IEEE round-to-nearest intrinsics
//     (no FMA contraction) and quantize_16 with rintf (half to even).
// Each column's winner is scattered as atomicMin of its packed key into a
// shared-memory row disp2p[x - d* - md] (OpenCV's internal right-view
// disparity; atomicMin of an integer is order-independent, so the result is
// deterministic). After a barrier, every thread checks its columns against
// disp2p at x - round(disp) and writes the final row.
//
// Mirror mode (_wta_body's mirror_lr) serves the shared-cost pair's right
// matcher, whose volume is in un-mirrored orientation: its partner view
// lies at x + d. Frames from index mirror_from on flip three things: the
// no-partner test (x + d* + md > W - 1), the scatter target x + d* + md and
// the check column x + round(disp). The result equals the plain mode on the
// W-flipped volume, flipped back, so one launch covers the left and the
// right matcher's path sums.
//
// What bounds it on the H100: device-memory bytes, one read of the int32
// volume (4 B per element) per frame; the row state lives in 12 B per
// column of shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BIGS = 1 << 29;   // above any path sum (<= ~70000)
constexpr int BIGP = 1 << 30;   // "no winner landed" in disp2p
constexpr int THREADS = 256;

template <int VPL>
__global__ void wta_lr_kernel(const int32_t* __restrict__ S,
                              float* __restrict__ out, int H, int W, int D,
                              int md, int uniq, int quant16, int disp12,
                              int apply_lr, int mirror_from, int pk_bits) {
  extern __shared__ int smem[];
  float* disp_s = reinterpret_cast<float*>(smem);  // [W]
  int* valid_s = smem + W;                          // [W]
  int* d2p_s = smem + 2 * W;                        // [W]
  const int PK = 1 << pk_bits;
  const size_t row = blockIdx.x;
  const int32_t* Srow = S + row * W * D;
  const bool mirror = (int)(row / H) >= mirror_from;

  for (int x = threadIdx.x; x < W; x += blockDim.x) d2p_s[x] = BIGP;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int d0 = lane * VPL;
  for (int x = threadIdx.x >> 5; x < W; x += blockDim.x >> 5) {
    const int32_t* sx = Srow + (size_t)x * D;
    int s[VPL];
    int key = 0x7fffffff;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      s[k] = (d0 + k < D) ? sx[d0 + k] : BIGS;
      if (d0 + k < D) key = min(key, s[k] * PK + d0 + k);
    }
    key = __reduce_min_sync(0xffffffffu, key);
    const int dstar = key & (PK - 1);
    const int s0 = key >> pk_bits;

    int valid = 1;
    if (uniq > 0) {
      int mt = BIGS;
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        const int d = d0 + k;
        if (d < D && abs(d - dstar) > 1) mt = min(mt, s[k]);
      }
      mt = __reduce_min_sync(0xffffffffu, mt);
      if (100LL * mt < (long long)(100 + uniq) * s0) valid = 0;
    }

    float off = 0.0f;
    if (dstar > 0 && dstar < D - 1) {
      const float fs0 = (float)s0;
      const float fsm = (float)sx[dstar - 1];
      const float fsp = (float)sx[dstar + 1];
      const float denom =
          fmaxf(__fsub_rn(__fadd_rn(fsm, fsp), __fmul_rn(2.0f, fs0)), 1e-6f);
      off = __fdiv_rn(__fsub_rn(fsm, fsp), __fmul_rn(2.0f, denom));
      off = fminf(fmaxf(off, -0.5f), 0.5f);
    }
    float disp = __fadd_rn(__fadd_rn((float)dstar, off), (float)md);
    if (quant16) disp = __fdiv_rn(rintf(__fmul_rn(disp, 16.0f)), 16.0f);
    // the partner column in the other view; none outside the image
    const int xr = mirror ? x + dstar + md : x - dstar - md;
    if (xr < 0 || xr > W - 1) valid = 0;

    if (lane == 0) {
      disp_s[x] = disp;
      valid_s[x] = valid;
      if (xr >= 0 && xr < W) atomicMin(&d2p_s[xr], key + md);  // s0*PK+d*+md
    }
  }
  __syncthreads();

  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    const float disp = disp_s[x];
    int valid = valid_s[x];
    if (valid && apply_lr && disp12 >= 0) {
      const int rd = __float2int_rn(disp);
      const int xr = mirror ? x + rd : x - rd;
      if (xr >= 0 && xr < W) {
        const int p = d2p_s[xr];
        const float d2 = p < BIGP ? (float)(p & (PK - 1)) : -1.0f;
        if (!(d2 >= 0.0f && fabsf(__fsub_rn(d2, disp)) <= (float)disp12))
          valid = 0;
      }
    }
    out[row * W + x] = valid ? disp : -1.0f;
  }
}

template <int VPL>
cudaError_t launch(const int32_t* S, float* out, int B, int H, int W, int D,
                   int md, int uniq, int quant16, int disp12, int apply_lr,
                   int mirror_from, int pk_bits, cudaStream_t stream) {
  const size_t smem = 3 * sizeof(int) * (size_t)W;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  wta_lr_kernel<VPL><<<B * H, THREADS, smem, stream>>>(
      S, out, H, W, D, md, uniq, quant16, disp12, apply_lr, mirror_from,
      pk_bits);
  return cudaGetLastError();
}

}  // namespace

// S: (B, H, W, D) int32 path sums; out: (B, H, W) float32 disparity with
// -1.0 where invalid; frames b >= mirror_from in mirror mode. md >= 0; D a
// multiple of 16, at most 256; W <= 4096.
extern "C" int sdr_wta_lr(const int32_t* S, float* out, int B, int H, int W,
                          int D, int md, int uniq, int quant16, int disp12,
                          int apply_lr, int mirror_from, void* stream) {
  if (D < 16 || D > 256 || D % 16 || md < 0) return (int)cudaErrorInvalidValue;
  int pk_bits = 0;
  while ((1 << pk_bits) <= D + md) ++pk_bits;  // PK = 1 << bit_length(D+md)
  cudaStream_t s = (cudaStream_t)stream;
#define SDR_WTA(V)                                                          \
  case V:                                                                   \
    return (int)launch<V>(S, out, B, H, W, D, md, uniq, quant16, disp12,    \
                          apply_lr, mirror_from, pk_bits, s);
  switch ((D + 31) / 32) {
    SDR_WTA(1) SDR_WTA(2) SDR_WTA(3) SDR_WTA(4)
    SDR_WTA(5) SDR_WTA(6) SDR_WTA(7) SDR_WTA(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SDR_WTA
}

// Message for an error code returned by the entries above.
extern "C" const char* sdr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
