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
// column of shared memory (past 4096 columns, 48 KB, the opt-in kind).
//
// The three-input entry (wta_lr3_kernel) replaces _wta_lr_kernel (launched
// by wta_lr_pallas): it reads the staged chain's three int16 partial path
// sums (down-going, up-going, horizontal), adds them in registers to the
// int32 sum and runs the same body, so each volume is read once (6 B per
// element) and the 8-path sum never reaches device memory. It has no
// mirror mode, as the TPU kernel has none. It is a second kernel beside
// wta_lr_kernel, which stays the code it was.

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
  if (smem > 48 * 1024) {   // past 4096 columns: the opt-in shared memory
    const cudaError_t e = cudaFuncSetAttribute(
        wta_lr_kernel<VPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  wta_lr_kernel<VPL><<<B * H, THREADS, smem, stream>>>(
      S, out, H, W, D, md, uniq, quant16, disp12, apply_lr, mirror_from,
      pk_bits);
  return cudaGetLastError();
}

template <int VPL>
__global__ void wta_lr3_kernel(const int16_t* __restrict__ Sd,
                               const int16_t* __restrict__ Su,
                               const int16_t* __restrict__ Sh,
                               float* __restrict__ out, int W, int D, int md,
                               int uniq, int quant16, int disp12,
                               int apply_lr, int pk_bits) {
  extern __shared__ int smem[];
  float* disp_s = reinterpret_cast<float*>(smem);  // [W]
  int* valid_s = smem + W;                          // [W]
  int* d2p_s = smem + 2 * W;                        // [W]
  const int PK = 1 << pk_bits;
  const size_t row = blockIdx.x;
  const size_t row0 = row * W * D;

  for (int x = threadIdx.x; x < W; x += blockDim.x) d2p_s[x] = BIGP;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int d0 = lane * VPL;
  for (int x = threadIdx.x >> 5; x < W; x += blockDim.x >> 5) {
    const size_t sx = row0 + (size_t)x * D;
    int s[VPL];
    int key = 0x7fffffff;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      s[k] = (d0 + k < D) ? (int)Sd[sx + d0 + k] + (int)Su[sx + d0 + k] +
                                (int)Sh[sx + d0 + k]
                          : BIGS;
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
      const size_t im = sx + dstar - 1, ip = sx + dstar + 1;
      const float fsm = (float)((int)Sd[im] + (int)Su[im] + (int)Sh[im]);
      const float fsp = (float)((int)Sd[ip] + (int)Su[ip] + (int)Sh[ip]);
      const float denom =
          fmaxf(__fsub_rn(__fadd_rn(fsm, fsp), __fmul_rn(2.0f, fs0)), 1e-6f);
      off = __fdiv_rn(__fsub_rn(fsm, fsp), __fmul_rn(2.0f, denom));
      off = fminf(fmaxf(off, -0.5f), 0.5f);
    }
    float disp = __fadd_rn(__fadd_rn((float)dstar, off), (float)md);
    if (quant16) disp = __fdiv_rn(rintf(__fmul_rn(disp, 16.0f)), 16.0f);
    // the partner column in the other view; none outside the image
    const int xr = x - dstar - md;
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
      const int xr = x - rd;
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
cudaError_t launch3(const int16_t* Sd, const int16_t* Su, const int16_t* Sh,
                    float* out, int B, int H, int W, int D, int md, int uniq,
                    int quant16, int disp12, int apply_lr, int pk_bits,
                    cudaStream_t stream) {
  const size_t smem = 3 * sizeof(int) * (size_t)W;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wta_lr3_kernel<VPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  wta_lr3_kernel<VPL><<<B * H, THREADS, smem, stream>>>(
      Sd, Su, Sh, out, W, D, md, uniq, quant16, disp12, apply_lr, pk_bits);
  return cudaGetLastError();
}

}  // namespace

// S: (B, H, W, D) int32 path sums; out: (B, H, W) float32 disparity with
// -1.0 where invalid; frames b >= mirror_from in mirror mode. md >= 0; D a
// multiple of 16, at most 256; 12 * W bytes of shared memory a block (W up
// to 19370 on an H100's 227 KB).
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

// Sd, Su, Sh: (B, H, W, D) int16 partial path sums whose sum is the volume
// of sdr_wta_lr; out as there, no mirror mode.
extern "C" int sdr_wta_lr3(const int16_t* Sd, const int16_t* Su,
                           const int16_t* Sh, float* out, int B, int H, int W,
                           int D, int md, int uniq, int quant16, int disp12,
                           int apply_lr, void* stream) {
  if (D < 16 || D > 256 || D % 16 || md < 0) return (int)cudaErrorInvalidValue;
  int pk_bits = 0;
  while ((1 << pk_bits) <= D + md) ++pk_bits;
  cudaStream_t s = (cudaStream_t)stream;
#define SDR_WTA3(V)                                                         \
  case V:                                                                   \
    return (int)launch3<V>(Sd, Su, Sh, out, B, H, W, D, md, uniq, quant16,  \
                           disp12, apply_lr, pk_bits, s);
  switch ((D + 31) / 32) {
    SDR_WTA3(1) SDR_WTA3(2) SDR_WTA3(3) SDR_WTA3(4)
    SDR_WTA3(5) SDR_WTA3(6) SDR_WTA3(7) SDR_WTA3(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SDR_WTA3
}

// Message for an error code returned by the entries above.
extern "C" const char* sdr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
