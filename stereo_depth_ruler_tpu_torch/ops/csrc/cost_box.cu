// K1: Birchfield–Tomasi matching cost with a block x block box sum.
//
// Replaces stereo_depth_ruler_tpu/ops/sgbm_pallas.py:_cost_box_kernel
// (launched by build_cost_volume_pallas). Output is the (B, H, W, D) int16
// volume box_filter_volume(bt_cost_volume(lt, rt)) of ops/sgbm.py, with D
// contiguous: one 256-byte row per pixel at D = 128.
//
// What bounds it on the H100. Its only device-memory traffic is the int16
// store (2 B per output: 0.58 ms at 8 x 720 x 1280 x 128 at 3.35 TB/s); the
// BT evaluations and the box sums are integer and shared-memory work, and
// that work is what the design cuts. A naive form evaluates BT block^2 =
// 25 times per output, a block per image row (the pair kernel's cost
// build) block x (TX + block - 1) / TX = 5.6 times. cost_box_kernel
// walks a column tile down a strip of rows: per image row it stages that
// row's doubled BT terms once, evaluates BT once per tile column, (TXB +
// block - 1) / TXB = 1.25 times per output at block 5, slides the
// horizontal sum across the tile, and keeps the last block horizontal-sum
// rows in a shared-memory ring, so the vertical sum is one add and one
// subtract per output in registers. Two disparities share each 32-bit
// operation (16-bit halves, biased so that no half carries into the
// other), each shared-memory load, ring access and store; 16 columns per
// block keep the registers low enough for more blocks per SM. Of the
// variants compared on the card (one disparity per thread, 16-byte or
// packed-byte right terms, 32 columns per block), this was the fastest.
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
// box sum <= 121 * 252 = 30492 < 32767), so integer arithmetic reproduces
// the float32 plain version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;  // output columns per block of the pair kernel

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

// The single-volume kernel below holds two disparities per thread in the
// 16-bit halves of one 32-bit word. Every value of a half is biased by 256
// (BIAS2) where a difference could go negative, so plain 32-bit adds and
// subtracts never carry or borrow across the halves, and max / min are the
// H100's two-lane 16-bit integer instructions.
constexpr int TXB = 16;                  // output columns per block
constexpr unsigned BIAS2 = 0x01000100u;  // 256 in both halves

__device__ __forceinline__ unsigned max2(unsigned a, unsigned b) {
  unsigned r;
  asm("max.u16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ unsigned min2(unsigned a, unsigned b) {
  unsigned r;
  asm("min.u16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// bt_terms as unsigned ints (each at most 252)
__device__ __forceinline__ void bt_terms3(const float* row, int c, int W,
                                          unsigned* v2, unsigned* mn2,
                                          unsigned* mx2) {
  short v, mn, mx;
  bt_terms(row, c, W, &v, &mn, &mx);
  *v2 = (unsigned)v;
  *mn2 = (unsigned)mn;
  *mx2 = (unsigned)mx;
}

// The single-volume cost: a block owns TXB columns x all D disparities
// (thread t holds d = 2t in the low and 2t + 1 in the high half) x a strip
// of SH output rows [y0, y1), and walks down it one image row per step. A
// step stages the new row's BT terms once (double-buffered, one barrier
// per step), each thread evaluates BT for its two d on the TXB + BLOCK - 1
// tile columns and slides the horizontal box sum h across them, and a ring
// of the last BLOCK h rows (shared memory, each thread its own word
// column) gives the vertical sum in registers:
//   V(y) = V(y - 1) + h(clamp(y + r)) - h(clamp(y - r - 1)).
// Clamped rows make the window a multiset that changes by one row in and
// one out per step, so the sums stay exact; a strip warms up on its first
// BLOCK - 1 (clamped) rows, with a ring of zero (biased) rows.
//
// Staging: left column j (image column clamp(x0 - R0 + j)) is one 16-byte
// word, (L + 256, L, LMX, LMN + 256) with each term in both halves, read by
// all threads at once. Right term k is image column clamp(ubase + k); the
// thread's pair for tile column j is k0 = j + D - 1 - 2t (low half, d = 2t)
// and k0 - 1 (high half), staged as (RV, RV + 256, RMX, RMN + 256) in qo
// for odd k0 and in qe for even k0, so that a warp reads 32 consecutive
// 16-byte words. That is the clamped partner of the clamped column
// wherever x0 - R0 + j <= W - 1; columns j > jW repeat column W - 1 and
// take its cost.
template <int BLOCK>
__global__ void __launch_bounds__(128)
cost_box_kernel(const float* __restrict__ lt, const float* __restrict__ rt,
                int16_t* __restrict__ out, int H, int W, int D, int md,
                int SH) {
  constexpr int R0 = BLOCK / 2;        // window rows/cols -R0 .. BLOCK-1-R0
  constexpr int NJ = TXB + BLOCK - 1;  // BT columns per staged row
  const int NR = NJ + D - 1;           // right-view columns per staged row
  const int NP = NR / 2 + 1;           // right pairs of each parity
  const int NT = NJ + 2 * NP;          // 16-byte words of a staged row
  extern __shared__ uint4 smem16[];
  unsigned* ring = (unsigned*)(smem16 + 2 * NT);     // [BLOCK][TXB][D / 2]
  const int b = blockIdx.z, x0 = blockIdx.x * TXB, t = threadIdx.x;
  const int T = blockDim.x;            // D / 2
  const int y0 = blockIdx.y * SH, y1 = min(y0 + SH, H);
  const float* lt_b = lt + (size_t)b * H * W;
  const float* rt_b = rt + (size_t)b * H * W;
  const int ubase = x0 - R0 - (D - 1) - md;
  const int jW = W - 1 - (x0 - R0);
  const unsigned h0 = (unsigned)(BLOCK * 256) * 0x10001u;   // biased zero

  for (int i = 0; i < BLOCK * TXB; ++i) ring[i * T + t] = h0;
  unsigned V[TXB];
#pragma unroll
  for (int i = 0; i < TXB; ++i) V[i] = 0;

  int slot = 0;
  const int steps = (y1 - y0) + BLOCK - 1;
  for (int s = 0; s < steps; ++s) {
    const size_t row = (size_t)clampi(y0 - R0 + s, 0, H - 1) * W;
    uint4* tl = smem16 + (s & 1) * NT;
    uint4* qo = tl + NJ;   // qo[m]: low half term 2m + 1, high half 2m
    uint4* qe = qo + NP;   // qe[m]: low half term 2m, high half 2m - 1
    for (int i = t; i < NJ; i += T) {
      unsigned v, mn, mx;
      bt_terms3(lt_b + row, clampi(x0 - R0 + i, 0, W - 1), W, &v, &mn, &mx);
      const unsigned L = v * 0x10001u;
      tl[i] = make_uint4(L + BIAS2, L, mx * 0x10001u, mn * 0x10001u + BIAS2);
    }
    for (int m = t; m < NP; m += T) {
      unsigned va, mna, mxa, vb, mnb, mxb, vc, mnc, mxc;  // 2m-1, 2m, 2m+1
      bt_terms3(rt_b + row, clampi(ubase + 2 * m - 1, 0, W - 1), W, &va, &mna,
                &mxa);
      bt_terms3(rt_b + row, clampi(ubase + 2 * m, 0, W - 1), W, &vb, &mnb,
                &mxb);
      bt_terms3(rt_b + row, clampi(ubase + 2 * m + 1, 0, W - 1), W, &vc,
                &mnc, &mxc);
      unsigned RV = vc | (vb << 16);
      qo[m] = make_uint4(RV, RV + BIAS2, mxc | (mxb << 16),
                         (mnc | (mnb << 16)) + BIAS2);
      RV = vb | (va << 16);
      qe[m] = make_uint4(RV, RV + BIAS2, mxb | (mxa << 16),
                         (mnb | (mna << 16)) + BIAS2);
    }
    __syncthreads();

    // bt = 256 + min(max(0, lv - rmx, rmn - lv), max(0, rv - lmx, lmn - rv))
    const int kb = D - 1 - 2 * t;
    unsigned bt[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int k0 = kb + j;
      const uint4 r = ((j + D - 1) & 1) ? qo[(k0 - 1) >> 1] : qe[k0 >> 1];
      const uint4 l = tl[j];
      const unsigned c_lr = max2(max2(l.x - r.z, r.w - l.y), BIAS2);
      const unsigned c_rl = max2(max2(r.y - l.z, l.w - r.x), BIAS2);
      bt[j] = min2(c_lr, c_rl);
    }
    if (jW < NJ - 1) {   // the image's right edge cuts this tile
#pragma unroll
      for (int j = 1; j < NJ; ++j) bt[j] = j > jW ? bt[j - 1] : bt[j];
    }
    // h is biased by BLOCK * 256 per half, as the ring; V is not
    unsigned* rs = ring + slot * TXB * T + t;
    unsigned h = 0;
#pragma unroll
    for (int k = 0; k < BLOCK; ++k) h += bt[k];
#pragma unroll
    for (int i = 0; i < TXB; ++i) {
      if (i > 0) h = h + bt[i + BLOCK - 1] - bt[i - 1];
      const unsigned old = rs[i * T];
      rs[i * T] = h;
      V[i] = V[i] + h - old;
    }
    slot = slot + 1 == BLOCK ? 0 : slot + 1;

    if (s >= BLOCK - 1) {
      const int y = y0 + s - (BLOCK - 1);
      unsigned* o = (unsigned*)(out + (((size_t)b * H + y) * W + x0) * D) + t;
#pragma unroll
      for (int i = 0; i < TXB; ++i) {
        if (x0 + i < W) o[(size_t)i * T] = V[i];
      }
    }
  }
}

// cost_pair_kernel's cost build, a block per image row, the roles set by
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
// cb. Its cost build (box_cost) is the first single-volume kernel's, one
// block per image row; it shares no body with cost_box_kernel: every way
// of sharing that was timed cost one of the two kernels registers or time.
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
cudaError_t launch_pair(const float* lt, const float* rt, int16_t* out, int B,
                        int H, int W, int D, int md, cudaStream_t stream) {
  constexpr int R0 = BLOCK / 2;
  const int NJ = TX + BLOCK - 1;
  const size_t smem =
      sizeof(short) * (3 * BLOCK * (NJ + NJ + D - 1) + TX * (D + 1));
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const int n_main = (W + TX - 1) / TX;
  // right band: columns c where some d gives c + d + md + R0 > W - 1
  const int cb = max(0, W - D - md - R0 + 1);
  const int n_band = (R0 > 0) + (W - cb + TX - 1) / TX;
  dim3 grid(n_main + n_band, H, B);
  cost_pair_kernel<BLOCK><<<grid, D, smem, stream>>>(lt, rt, out, B, H, W, D,
                                                     md, n_main, cb);
  return cudaGetLastError();
}

// Strips of at most STRIP rows: at 720 rows 12 strips of 60, so one frame
// gives 80 x 12 blocks at 1280 columns (the 132 SMs fill at batch 1) and a
// strip's warm-up adds (BLOCK - 1) / 60 of a row step per output row.
constexpr int STRIP = 64;

template <int BLOCK>
cudaError_t launch_box(const float* lt, const float* rt, int16_t* out, int B,
                       int H, int W, int D, int md, cudaStream_t stream) {
  const int NJ = TXB + BLOCK - 1, NR = NJ + D - 1, NP = NR / 2 + 1;
  const size_t smem = sizeof(uint4) * 2 * (NJ + 2 * NP) +
                      sizeof(unsigned) * (size_t)BLOCK * TXB * (D / 2);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cost_box_kernel<BLOCK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int strips0 = (H + STRIP - 1) / STRIP;
  const int SH = (H + strips0 - 1) / strips0;
  dim3 grid((W + TXB - 1) / TXB, (H + SH - 1) / SH, B);
  cost_box_kernel<BLOCK><<<grid, D / 2, smem, stream>>>(lt, rt, out, H, W, D,
                                                        md, SH);
  return cudaGetLastError();
}

template <int BLOCK>
cudaError_t launch(const float* lt, const float* rt, int16_t* out, int B,
                   int H, int W, int D, int md, int pair,
                   cudaStream_t stream) {
  return pair ? launch_pair<BLOCK>(lt, rt, out, B, H, W, D, md, stream)
              : launch_box<BLOCK>(lt, rt, out, B, H, W, D, md, stream);
}

}  // namespace

// lt, rt: (B, H, W) float32 Sobel-clipped images (exact integers).
// out: (B, H, W, D) int16, or with pair != 0 (2B, H, W, D): C_L then C_R.
// block must be odd, 1..11; 1 <= D <= 1024 (the single volume: D even,
// at most 256).
extern "C" int sdr_cost_box(const float* lt, const float* rt, int16_t* out,
                            int B, int H, int W, int D, int md, int block,
                            int pair, void* stream) {
  if (D < 1 || D > (pair ? 1024 : 256) || (!pair && D % 2) || md < 0 ||
      B < 1 || H < 1 || W < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
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
