// K1: Birchfield–Tomasi matching cost with a block x block box sum.
//
// Replaces stereo_depth_ruler_tpu/ops/sgbm_pallas.py:_cost_box_kernel
// (launched by build_cost_volume_pallas). Output is the (B, H, W, D) int16
// volume box_filter_volume(bt_cost_volume(lt, rt)) of ops/sgbm.py, with D
// contiguous: one 256-byte row per pixel at D = 128.
//
// What bounds it on the H100: integer and shared-memory instruction issue.
// A naive form evaluates BT block^2 = 25 times per output. Here a block owns
// one image row y, a tile of TX columns and all D disparities (one thread
// per d). It stages the block rows it needs, as doubled (value, min, max)
// BT terms, in shared memory, then each thread evaluates BT once per
// (row, column) of the padded tile and slides the horizontal window in
// registers: block * (TX + block - 1) / TX BT evaluations per output
// (5.6 at block 5) instead of 25. The only device-memory traffic is the
// int16 store, coalesced across the D threads of a block.
//
// All values are exact small integers (Sobel output <= 2 * 63, BT <= 252,
// box sum <= 6300), so int32 arithmetic reproduces the float32 plain version
// bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;  // output columns per block

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// Doubled BT terms of pixel (row, c): 2v, 2*min(v, vm, vp), 2*max(...),
// where vm, vp are the half-sample means with the left/right neighbour
// (the neighbour clamps at the border, so vm = v at c = 0).
__device__ __forceinline__ void bt_terms(const float* row, int c, int W,
                                         short* v2, short* mn2, short* mx2) {
  const int v = (int)row[c];
  const int vl = (int)row[clampi(c - 1, 0, W - 1)];
  const int vr = (int)row[clampi(c + 1, 0, W - 1)];
  const int a = 2 * v, m = v + vl, p = v + vr;
  *v2 = (short)a;
  *mn2 = (short)min(min(m, p), a);
  *mx2 = (short)max(max(m, p), a);
}

template <int BLOCK>
__global__ void cost_box_kernel(const float* __restrict__ lt,
                                const float* __restrict__ rt,
                                int16_t* __restrict__ out, int H, int W,
                                int D, int md) {
  constexpr int R0 = BLOCK / 2;        // window rows/cols -R0 .. BLOCK-1-R0
  constexpr int NJ = TX + BLOCK - 1;   // BT columns per staged row
  const int b = blockIdx.z, y = blockIdx.y, x0 = blockIdx.x * TX;
  const int NR = NJ + D - 1;           // right-view columns per staged row

  extern __shared__ short smem[];
  short* lv2 = smem;                   // [BLOCK][NJ] x 3
  short* lmn = lv2 + BLOCK * NJ;
  short* lmx = lmn + BLOCK * NJ;
  short* rv2 = lmx + BLOCK * NJ;       // [BLOCK][NR] x 3
  short* rmn = rv2 + BLOCK * NR;
  short* rmx = rmn + BLOCK * NR;

  const float* lt_b = lt + (size_t)b * H * W;
  const float* rt_b = rt + (size_t)b * H * W;
  // column j of the padded tile is image column xc(j) = clamp(x0-R0+j);
  // right column u = xc - d - md is staged at u - ubase
  const int xc0 = clampi(x0 - R0, 0, W - 1);
  const int ubase = xc0 - (D - 1) - md;

  for (int i = threadIdx.x; i < BLOCK * NJ; i += blockDim.x) {
    const int r = i / NJ, j = i % NJ;
    const float* row = lt_b + (size_t)clampi(y - R0 + r, 0, H - 1) * W;
    bt_terms(row, clampi(x0 - R0 + j, 0, W - 1), W, &lv2[i], &lmn[i],
             &lmx[i]);
  }
  for (int i = threadIdx.x; i < BLOCK * NR; i += blockDim.x) {
    const int r = i / NR, k = i % NR;
    const float* row = rt_b + (size_t)clampi(y - R0 + r, 0, H - 1) * W;
    bt_terms(row, clampi(ubase + k, 0, W - 1), W, &rv2[i], &rmn[i], &rmx[i]);
  }
  __syncthreads();

  const int d = threadIdx.x;
  if (d >= D) return;
  int acc[TX];
#pragma unroll
  for (int i = 0; i < TX; ++i) acc[i] = 0;

  for (int r = 0; r < BLOCK; ++r) {
    int bt[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int li = r * NJ + j;
      const int xc = clampi(x0 - R0 + j, 0, W - 1);
      const int ri = r * NR + (xc - d - md - ubase);
      const int lv = lv2[li], rv = rv2[ri];
      const int c_lr = max(0, max(lv - rmx[ri], rmn[ri] - lv));
      const int c_rl = max(0, max(rv - lmx[li], lmn[li] - rv));
      bt[j] = min(c_lr, c_rl);
    }
#pragma unroll
    for (int i = 0; i < TX; ++i) {
#pragma unroll
      for (int k = 0; k < BLOCK; ++k) acc[i] += bt[i + k];
    }
  }

  int16_t* o = out + (((size_t)b * H + y) * W + x0) * D + d;
#pragma unroll
  for (int i = 0; i < TX; ++i) {
    if (x0 + i < W) o[(size_t)i * D] = (int16_t)acc[i];
  }
}

template <int BLOCK>
cudaError_t launch(const float* lt, const float* rt, int16_t* out, int B,
                   int H, int W, int D, int md, cudaStream_t stream) {
  const int NJ = TX + BLOCK - 1;
  const size_t smem = sizeof(short) * 3 * BLOCK * (NJ + NJ + D - 1);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  dim3 grid((W + TX - 1) / TX, H, B);
  cost_box_kernel<BLOCK><<<grid, D, smem, stream>>>(lt, rt, out, H, W, D,
                                                    md);
  return cudaGetLastError();
}

}  // namespace

// lt, rt: (B, H, W) float32 Sobel-clipped images (exact integers).
// out: (B, H, W, D) int16. block must be odd, 1..11; 1 <= D <= 1024.
extern "C" int sdr_cost_box(const float* lt, const float* rt, int16_t* out,
                            int B, int H, int W, int D, int md, int block,
                            void* stream) {
  if (D < 1 || D > 1024 || md < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (block) {
    case 1: return (int)launch<1>(lt, rt, out, B, H, W, D, md, s);
    case 3: return (int)launch<3>(lt, rt, out, B, H, W, D, md, s);
    case 5: return (int)launch<5>(lt, rt, out, B, H, W, D, md, s);
    case 7: return (int)launch<7>(lt, rt, out, B, H, W, D, md, s);
    case 9: return (int)launch<9>(lt, rt, out, B, H, W, D, md, s);
    case 11: return (int)launch<11>(lt, rt, out, B, H, W, D, md, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
