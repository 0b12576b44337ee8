// Fused cost build + down-going SGM passes.
//
// Replaces stereo_depth_ruler_tpu/ops/sgbm_pallas.py:_cost_down_kernel
// (launched by build_cost_down_pallas). From the two Sobel-clipped images
// it writes, in one kernel, the (B, H, W, D) int16 cost volume C (equal to
// cost_box.cu's) and the int16 sum S_down3 of the down-going paths over
// it: (1, 0), and with 8 paths also (1, 1) and (1, -1), each
//
//   L(p, d) = C(p, d) + min(L(p-r, d), L(p-r, d+-1) + P1, minL + P2) - minL
//
// with a zero predecessor outside the image, as ops/sgbm.py:cost_down. The
// cost volume is never read back from device memory.
//
// Design. The diagonals couple the columns: row y of the three paths needs
// row y - 1 of the neighbouring columns, so no block can run down a column
// strip alone. The kernel is a cooperative launch: a block owns one frame's
// strip of TXW columns, all blocks step through the rows together, and one
// grid barrier per row separates row y - 1's L from row y's readers. The
// three L rows of each frame live in a small device-memory scratch
// (2 x 3 x W x D int16 per frame, double-buffered by the row's parity),
// which stays in L2. Per row a block
//   1. slides its box sums V (shared memory, TXW x D int16) one row down:
//      it adds the raw BT costs of image row y + r and subtracts those of
//      row y - r - 1 (rows clamped), each staged once per row as a
//      (TXW + block - 1) x D tile from which every (x, d) sums its block
//      columns; a row costs 2 BT evaluations per output, whatever the block
//      size, instead of the block rows a recompute would need;
//   2. runs the 1 or 3 path updates, one warp per column as sgm_pass.cu
//      (lane l holds D/32 disparities, minL is one __reduce_min_sync), and
//      stores C, the sum and the new L rows.
// The host side picks the strip width so that all blocks of as many frames
// as possible are resident at once (the occupancy query decides), and runs
// the batch in several launches if they are not.
//
// What bounds it on the H100: the row-to-row dependency. The bytes are the
// two int16 stores (4 B per element); each of the H row steps pays a grid
// barrier and a few block barriers, and the L rows cross L2 once per row.
//
// All values are exact small integers, so int32 arithmetic reproduces the
// float32 plain version bit for bit. The caller keeps 3 * (cmax + P2)
// within int16.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BIG = 1 << 29;   // above any path value
constexpr int THREADS = 512;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// Doubled BT terms of pixel (row, c), as in cost_box.cu: 2v and twice the
// min and max of v and its half-sample means with both neighbours.
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

struct Tile {
  short* V;     // [TXW][D] box sums of the current row
  short* bt;    // [NJ][D] raw BT costs of one image row
  short* lv2;   // [NJ] x 3 left terms
  short* lmn;
  short* lmx;
  short* rv2;   // [NR] x 3 right terms
  short* rmn;
  short* rmx;
};

// V += sign * (horizontal block sums of the BT costs of image row r) for
// the strip starting at column x0.
__device__ void accumulate_row(const Tile& t, const float* lrow,
                               const float* rrow, int W, int D, int md,
                               int block, int x0, int TXW, int sign) {
  const int R0 = block / 2;
  const int NJ = TXW + block - 1, NR = NJ + D - 1;
  // tile column j is image column xc(j) = clamp(x0 - R0 + j); the right
  // column u = xc - d - md is staged at u - ubase
  const int xc0 = clampi(x0 - R0, 0, W - 1);
  const int ubase = xc0 - (D - 1) - md;
  for (int i = threadIdx.x; i < NJ; i += THREADS)
    bt_terms(lrow, clampi(x0 - R0 + i, 0, W - 1), W, &t.lv2[i], &t.lmn[i],
             &t.lmx[i]);
  for (int i = threadIdx.x; i < NR; i += THREADS)
    bt_terms(rrow, clampi(ubase + i, 0, W - 1), W, &t.rv2[i], &t.rmn[i],
             &t.rmx[i]);
  __syncthreads();
  for (int i = threadIdx.x; i < NJ * D; i += THREADS) {
    const int j = i / D, d = i - j * D;
    const int xc = clampi(x0 - R0 + j, 0, W - 1);
    const int ri = xc - d - md - ubase;
    const int lv = t.lv2[j], rv = t.rv2[ri];
    const int c_lr = max(0, max(lv - t.rmx[ri], t.rmn[ri] - lv));
    const int c_rl = max(0, max(rv - t.lmx[j], t.lmn[j] - rv));
    t.bt[i] = (short)min(c_lr, c_rl);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TXW * D; i += THREADS) {
    int sum = 0;
    for (int k = 0; k < block; ++k) sum += t.bt[i + k * D];
    t.V[i] = (short)(t.V[i] + sign * sum);
  }
  __syncthreads();
}

// Grid: n_frames * strips blocks of THREADS threads, launched cooperatively.
// Lbuf: [2][3][B][W][D] int16, the L rows of the previous and the current
// image row.
template <int VPL>
__global__ void __launch_bounds__(THREADS)
cost_down_kernel(const float* __restrict__ lt, const float* __restrict__ rt,
                 int16_t* __restrict__ C, int16_t* __restrict__ S3,
                 int16_t* Lbuf, int b0, int B, int H, int W, int D, int md,
                 int block, int P1, int P2, int ndir, int strips, int TXW) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ short smem[];
  const int R0 = block / 2;
  const int NJ = TXW + block - 1, NR = NJ + D - 1;
  Tile t;
  t.V = smem;
  t.bt = t.V + TXW * D;
  t.lv2 = t.bt + NJ * D;
  t.lmn = t.lv2 + NJ;
  t.lmx = t.lmn + NJ;
  t.rv2 = t.lmx + NJ;
  t.rmn = t.rv2 + NR;
  t.rmx = t.rmn + NR;

  const int b = b0 + blockIdx.x / strips;
  const int x0 = (blockIdx.x % strips) * TXW;
  const float* lt_b = lt + (size_t)b * H * W;
  const float* rt_b = rt + (size_t)b * H * W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d0 = lane * VPL;
  const size_t lrow = (size_t)W * D;          // one L row of one frame
  const size_t lframe = (size_t)B * lrow;     // one direction, all frames

  for (int i = threadIdx.x; i < TXW * D; i += THREADS) t.V[i] = 0;
  __syncthreads();

  for (int y = 0; y < H; ++y) {
    if (y == 0) {
      for (int k = 0; k < block; ++k) {
        const size_t r = (size_t)clampi(k - R0, 0, H - 1) * W;
        accumulate_row(t, lt_b + r, rt_b + r, W, D, md, block, x0, TXW, 1);
      }
    } else {
      const size_t r_in = (size_t)min(y + R0, H - 1) * W;
      const size_t r_out = (size_t)max(y - R0 - 1, 0) * W;
      accumulate_row(t, lt_b + r_in, rt_b + r_in, W, D, md, block, x0, TXW,
                     1);
      accumulate_row(t, lt_b + r_out, rt_b + r_out, W, D, md, block, x0, TXW,
                     -1);
    }

    int16_t* Lcur = Lbuf + (size_t)(y & 1) * 3 * lframe + (size_t)b * lrow;
    const int16_t* Lold =
        Lbuf + (size_t)((y & 1) ^ 1) * 3 * lframe + (size_t)b * lrow;
    for (int xl = warp; xl < TXW; xl += THREADS / 32) {
      const int x = x0 + xl;
      if (x >= W) break;  // whole warp leaves together
      int c[VPL], s3[VPL];
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        c[k] = (d0 + k < D) ? (int)t.V[xl * D + d0 + k] : 0;
        s3[k] = 0;
      }
      for (int dir = 0; dir < ndir; ++dir) {
        // predecessor column: x for (1, 0), x - 1 for (1, 1), x + 1 for
        // (1, -1); outside the image the path starts here with L = C
        const int xp = x + (dir == 0 ? 0 : (dir == 1 ? -1 : 1));
        int L[VPL];
        if (y == 0 || xp < 0 || xp >= W) {
#pragma unroll
          for (int k = 0; k < VPL; ++k) L[k] = (d0 + k < D) ? c[k] : BIG;
        } else {
          const int16_t* pl = Lold + dir * lframe + (size_t)xp * D + d0;
          int prev[VPL];
#pragma unroll
          for (int k = 0; k < VPL; ++k)
            prev[k] = (d0 + k < D) ? (int)__ldcg(pl + k) : BIG;  // L2, not L1
          int m = prev[0];
#pragma unroll
          for (int k = 1; k < VPL; ++k) m = min(m, prev[k]);
          const int minL = __reduce_min_sync(0xffffffffu, m);
          int lm1 = __shfl_up_sync(0xffffffffu, prev[VPL - 1], 1);
          int lp1 = __shfl_down_sync(0xffffffffu, prev[0], 1);
          if (lane == 0) lm1 = BIG;
          if (lane == 31) lp1 = BIG;
#pragma unroll
          for (int k = 0; k < VPL; ++k) {
            const int a = (k == 0) ? lm1 : prev[k > 0 ? k - 1 : 0];
            const int z = (k == VPL - 1) ? lp1 : prev[k < VPL - 1 ? k + 1 : k];
            const int best = min(min(prev[k], minL + P2), min(a, z) + P1);
            L[k] = (d0 + k < D) ? c[k] + best - minL : BIG;
          }
        }
        int16_t* pc = Lcur + dir * lframe + (size_t)x * D + d0;
#pragma unroll
        for (int k = 0; k < VPL; ++k) {
          if (d0 + k < D) {
            pc[k] = (int16_t)L[k];
            s3[k] += L[k];
          }
        }
      }
      const size_t cell = (((size_t)b * H + y) * W + x) * D + d0;
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        if (d0 + k < D) {
          C[cell + k] = (int16_t)c[k];
          S3[cell + k] = (int16_t)s3[k];
        }
      }
    }
    // row y's L is complete everywhere before any block reads it, and V is
    // free for the next row
    if (y + 1 < H) grid.sync();
  }
}

size_t smem_bytes(int TXW, int D, int block) {
  const size_t NJ = TXW + block - 1, NR = NJ + D - 1;
  return sizeof(short) * ((size_t)TXW * D + NJ * D + 3 * NJ + 3 * NR);
}

template <int VPL>
cudaError_t launch(const float* lt, const float* rt, int16_t* C, int16_t* S3,
                   int16_t* Lbuf, int B, int H, int W, int D, int md,
                   int block, int P1, int P2, int ndir, cudaStream_t stream) {
  int dev = 0, sms = 0, coop = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (!coop) return cudaErrorNotSupported;
  auto kern = cost_down_kernel<VPL>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           max_smem);
  if (e != cudaSuccess) return e;

  for (int b0 = 0; b0 < B;) {
    // the most frames whose strips are all resident at once: try 4 down to
    // 1 blocks per SM, and for each the frames left, halved until the
    // strips fit shared memory and the occupancy query admits the grid
    int n_frames = 0, strips = 0, TXW = 0;
    size_t smem = 0;
    for (int per_sm = 4; per_sm >= 1 && !n_frames; --per_sm) {
      const int n_blocks = per_sm * sms;
      for (int nf = min(B - b0, n_blocks); nf >= 1; nf /= 2) {
        int st = min(n_blocks / nf, W);
        const int txw = (W + st - 1) / st;
        st = (W + txw - 1) / txw;
        const size_t sm = smem_bytes(txw, D, block);
        if (sm > (size_t)max_smem) continue;
        int occ = 0;
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, THREADS,
                                                          sm);
        if (e != cudaSuccess) return e;
        if ((long long)occ * sms >= (long long)nf * st) {
          n_frames = nf; strips = st; TXW = txw; smem = sm;
          break;
        }
      }
    }
    if (!n_frames) return cudaErrorInvalidConfiguration;
    void* args[] = {&lt, &rt, &C, &S3, &Lbuf, &b0, &B, &H, &W, &D, &md,
                    &block, &P1, &P2, &ndir, &strips, &TXW};
    e = cudaLaunchCooperativeKernel((void*)kern, dim3(n_frames * strips),
                                    dim3(THREADS), args, smem, stream);
    if (e != cudaSuccess) return e;
    b0 += n_frames;
  }
  return cudaGetLastError();
}

}  // namespace

// lt, rt: (B, H, W) float32 Sobel-clipped images (exact integers). C, S3:
// (B, H, W, D) int16 outputs. Lbuf: 2 * 3 * B * W * D int16 of scratch.
// ndir: 3 (the vertical path and both diagonals) or 1. block odd, 1..11;
// D a multiple of 16, at most 256; md >= 0.
extern "C" int sdr_cost_down(const float* lt, const float* rt, int16_t* C,
                             int16_t* S3, int16_t* Lbuf, int B, int H, int W,
                             int D, int md, int block, int P1, int P2,
                             int ndir, void* stream) {
  if (D < 16 || D > 256 || D % 16 || md < 0 || block < 1 || block > 11 ||
      block % 2 == 0 || (ndir != 1 && ndir != 3) || B < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define SDR_CD(V)                                                            \
  case V:                                                                    \
    return (int)launch<V>(lt, rt, C, S3, Lbuf, B, H, W, D, md, block, P1,   \
                          P2, ndir, s);
  switch ((D + 31) / 32) {
    SDR_CD(1) SDR_CD(2) SDR_CD(3) SDR_CD(4)
    SDR_CD(5) SDR_CD(6) SDR_CD(7) SDR_CD(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SDR_CD
}
