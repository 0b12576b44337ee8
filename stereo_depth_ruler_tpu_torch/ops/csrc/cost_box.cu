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
// Pair mode (emit_sheared plus sgbm_pair_pallas's band fix-up) writes a
// (2B, H, W, D) volume: C_L in frames [0, B), and in frames [B, 2B) C_R,
// the right matcher's volume in un-mirrored orientation (cost_volume_pair
// in ops/sgbm.py). BT is symmetric in its two pixels, so wherever no box
// window reaches a border column (x >= r and x + d + md + r <= W - 1) C_R
// is C_L sheared: C_R(y, x, d) = C_L(y, x + d + md, d). A tile block stores
// those C_R values too. Written straight from registers the shear store
// would stride by D - 1 elements across a warp, so the block first puts
// its TX x D values in shared memory and then writes each C_R column's run
// of <= TX disparities with consecutive threads. The other C_R elements
// (the left r columns and the right band where x + d + md + r > W - 1) are
// built directly by extra band blocks of the same launch, with the two
// images' roles swapped (own pixel in rt, partner in lt at x + d + md);
// each element has exactly one writer.
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

// cost_pair_kernel's cost build, cost_box_kernel's with the roles set by
// SGN: acc[i] = box sum over the block x block window around (y, x0 + i)
// of BT(own[xc], partner[xc + SGN * (d + md)]), window columns xc and
// partner columns clamped to the image, for the thread's d. SGN = -1 builds
// C_L (own lt, partner rt); SGN = +1 builds C_R directly (own rt, partner
// lt).
template <int BLOCK, int SGN>
__device__ __forceinline__ void box_cost(const float* __restrict__ own,
                                         const float* __restrict__ par,
                                         int H, int W, int D, int md, int y,
                                         int x0, int* acc) {
  extern __shared__ short smem[];
  constexpr int R0 = BLOCK / 2;        // window rows/cols -R0 .. BLOCK-1-R0
  constexpr int NJ = TX + BLOCK - 1;   // own columns per staged row
  const int NR = NJ + D - 1;           // partner columns per staged row
  short* ov2 = smem;                   // [BLOCK][NJ] x 3
  short* omn = ov2 + BLOCK * NJ;
  short* omx = omn + BLOCK * NJ;
  short* pv2 = omx + BLOCK * NJ;       // [BLOCK][NR] x 3
  short* pmn = pv2 + BLOCK * NR;
  short* pmx = pmn + BLOCK * NR;

  // own column j of the padded tile is image column xc(j) = clamp(x0-R0+j);
  // partner column u = xc + SGN * (d + md) is staged at u - pbase
  const int xc0 = clampi(x0 - R0, 0, W - 1);
  const int pbase = SGN < 0 ? xc0 - (D - 1) - md : xc0 + md;

  for (int i = threadIdx.x; i < BLOCK * NJ; i += blockDim.x) {
    const int r = i / NJ, j = i % NJ;
    const float* row = own + (size_t)clampi(y - R0 + r, 0, H - 1) * W;
    bt_terms(row, clampi(x0 - R0 + j, 0, W - 1), W, &ov2[i], &omn[i],
             &omx[i]);
  }
  for (int i = threadIdx.x; i < BLOCK * NR; i += blockDim.x) {
    const int r = i / NR, k = i % NR;
    const float* row = par + (size_t)clampi(y - R0 + r, 0, H - 1) * W;
    bt_terms(row, clampi(pbase + k, 0, W - 1), W, &pv2[i], &pmn[i], &pmx[i]);
  }
  __syncthreads();

  const int d = threadIdx.x;
#pragma unroll
  for (int i = 0; i < TX; ++i) acc[i] = 0;

  for (int r = 0; r < BLOCK; ++r) {
    int bt[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int oi = r * NJ + j;
      const int xc = clampi(x0 - R0 + j, 0, W - 1);
      const int pi = r * NR + (SGN < 0 ? xc - d - md - pbase
                                        : xc + d + md - pbase);
      const int ov = ov2[oi], pv = pv2[pi];
      const int c_op = max(0, max(ov - pmx[pi], pmn[pi] - ov));
      const int c_po = max(0, max(pv - omx[oi], omn[oi] - pv));
      bt[j] = min(c_op, c_po);
    }
#pragma unroll
    for (int i = 0; i < TX; ++i) {
#pragma unroll
      for (int k = 0; k < BLOCK; ++k) acc[i] += bt[i + k];
    }
  }
}

// Pair mode. Launched with D threads per block, grid (n_main + n_band, H,
// B): blocks bx < n_main own C_L tile x0 = bx * TX and its sheared C_R
// values; the n_band others build C_R band tiles, with R0 > 0 the first
// the left tile (columns < R0), the rest tiling the right band from column
// cb. It repeats cost_box_kernel's cost build through box_cost rather than
// sharing one body with it: every way of sharing that was timed cost the
// single-volume kernel registers or time (up to 128 registers instead of
// 99 and 19 % more time at 8x720x1280x128), so that kernel stays as it is.
template <int BLOCK>
__global__ void cost_pair_kernel(const float* __restrict__ lt,
                                 const float* __restrict__ rt,
                                 int16_t* __restrict__ out, int B, int H,
                                 int W, int D, int md, int n_main, int cb) {
  constexpr int R0 = BLOCK / 2;
  constexpr int NJ = TX + BLOCK - 1;
  extern __shared__ short smem[];
  const int b = blockIdx.z, y = blockIdx.y, bx = blockIdx.x, d = threadIdx.x;
  const size_t frame = (size_t)H * W * D;
  const float* lt_b = lt + (size_t)b * H * W;
  const float* rt_b = rt + (size_t)b * H * W;
  int acc[TX];

  if (bx >= n_main) {  // a C_R band tile, built directly
    const int k = bx - n_main;
    const bool left_tile = R0 > 0 && k == 0;
    const int x0 = left_tile ? 0 : cb + (k - (R0 > 0)) * TX;
    box_cost<BLOCK, +1>(rt_b, lt_b, H, W, D, md, y, x0, acc);
    int16_t* o = out + (B + b) * frame + (size_t)y * W * D + d;
#pragma unroll
    for (int i = 0; i < TX; ++i) {
      const int c = x0 + i;
      const bool band = left_tile ? c < R0
                                  : (c >= R0 && c + d + md + R0 > W - 1);
      if (c < W && band) o[(size_t)c * D] = (int16_t)acc[i];
    }
    return;
  }

  const int x0 = bx * TX;
  box_cost<BLOCK, -1>(lt_b, rt_b, H, W, D, md, y, x0, acc);
  int16_t* o = out + b * frame + ((size_t)y * W + x0) * D + d;
#pragma unroll
  for (int i = 0; i < TX; ++i) {
    if (x0 + i < W) o[(size_t)i * D] = (int16_t)acc[i];
  }

  // the shear: stage[t][d] = C_L(y, x0 + t, d) = C_R(y, x0 + t - d - md, d)
  const int DP = D + 1;  // odd row pitch: a C_R column's run reads
                         // conflict-free along the diagonal
  short* stage = smem + 3 * BLOCK * (2 * NJ + D - 1);
#pragma unroll
  for (int i = 0; i < TX; ++i) stage[i * DP + d] = (short)acc[i];
  __syncthreads();
  // C_R column c = x0 - md - (D - 1) + kc holds d = D - 1 - kc + t for the
  // tile's t in [0, TX): consecutive threads store consecutive d
  int16_t* oR = out + (B + b) * frame + (size_t)y * W * D;
  for (int idx = threadIdx.x; idx < (D + TX - 1) * TX; idx += blockDim.x) {
    const int kc = idx / TX, t = idx % TX;
    const int dd = D - 1 - kc + t;
    const int xl = x0 + t, c = xl - dd - md;
    if (dd >= 0 && dd < D && c >= R0 && xl + R0 <= W - 1)
      oR[(size_t)c * D + dd] = stage[t * DP + dd];
  }
}

template <int BLOCK>
cudaError_t launch(const float* lt, const float* rt, int16_t* out, int B,
                   int H, int W, int D, int md, int pair,
                   cudaStream_t stream) {
  constexpr int R0 = BLOCK / 2;
  const int NJ = TX + BLOCK - 1;
  const size_t smem = sizeof(short) * (3 * BLOCK * (NJ + NJ + D - 1) +
                                       (pair ? TX * (D + 1) : 0));
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const int n_main = (W + TX - 1) / TX;
  // right band: columns c where some d gives c + d + md + R0 > W - 1
  const int cb = max(0, W - D - md - R0 + 1);
  const int n_band = pair ? (R0 > 0) + (W - cb + TX - 1) / TX : 0;
  dim3 grid(n_main + n_band, H, B);
  if (pair)
    cost_pair_kernel<BLOCK><<<grid, D, smem, stream>>>(lt, rt, out, B, H, W,
                                                       D, md, n_main, cb);
  else
    cost_box_kernel<BLOCK><<<grid, D, smem, stream>>>(lt, rt, out, H, W, D,
                                                      md);
  return cudaGetLastError();
}

}  // namespace

// lt, rt: (B, H, W) float32 Sobel-clipped images (exact integers).
// out: (B, H, W, D) int16, or with pair != 0 (2B, H, W, D): C_L then C_R.
// block must be odd, 1..11; 1 <= D <= 1024.
extern "C" int sdr_cost_box(const float* lt, const float* rt, int16_t* out,
                            int B, int H, int W, int D, int md, int block,
                            int pair, void* stream) {
  if (D < 1 || D > 1024 || md < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (block) {
    case 1: return (int)launch<1>(lt, rt, out, B, H, W, D, md, pair, s);
    case 3: return (int)launch<3>(lt, rt, out, B, H, W, D, md, pair, s);
    case 5: return (int)launch<5>(lt, rt, out, B, H, W, D, md, pair, s);
    case 7: return (int)launch<7>(lt, rt, out, B, H, W, D, md, pair, s);
    case 9: return (int)launch<9>(lt, rt, out, B, H, W, D, md, pair, s);
    case 11: return (int)launch<11>(lt, rt, out, B, H, W, D, md, pair, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
