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
// 25 times per output, a block per image row block x (32 + block - 1) /
// 32 = 5.6 times. cost_box_kernel walks a column tile down a strip of
// rows: per image row it stages that row's doubled BT terms once,
// evaluates BT once per tile column, (TXB + block - 1) / TXB = 1.25 times
// per output at block 5, slides the horizontal sum across the tile, and
// keeps the last block horizontal-sum rows in a shared-memory ring, so the
// vertical sum is one add and one subtract per output in registers. Two
// disparities share each 32-bit operation (16-bit halves, biased so that
// no half carries into the other), each shared-memory load, ring access
// and store; 16 columns per block keep the registers low enough for more
// blocks per SM. Of the variants compared on the card (one disparity per
// thread, 16-byte or packed-byte right terms, 32 columns per block), this
// was the fastest.
//
// Pair mode replaces sgbm_pallas.py:emit_sheared and sgbm_pair_pallas's
// band fix-up. It writes a (2B, H, W, D) volume: C_L in frames [0, B), and
// in frames [B, 2B) C_R, the right matcher's volume in un-mirrored
// orientation (cost_volume_pair in ops/sgbm.py). Its bound is the two
// volumes' stores (1.14 ms at 8 x 720 x 1280 x 128). BT is symmetric in its
// two pixels, so wherever no box window reaches a border column (x >= r
// and x + d + md + r <= W - 1) C_R is C_L sheared: C_R(y, x, d) = C_L(y, x
// + d + md, d), and the TPU kernel shears C_L into C_R. Here
// cost_pair_strip_kernel builds C_R directly with cost_box_kernel's strip
// walk, own pixel in rt and partner in lt at x + d + md, in blocks beside
// the C_L blocks of the same launch: both volumes leave as whole coalesced
// words, each element with exactly one writer, and the pair costs two
// single volumes. A form that sheared C_L's values into C_R through shared
// memory (the runs of <= 16 disparities of each C_R column leaving with
// consecutive threads, C_R built directly only in the border bands) was
// timed on the card and was slower at every block and shape tried: the
// partial runs of 16-bit stores and a second barrier per row cost more
// than building C_R again (PERF.md §6). It is a kernel of its own, not
// a mode of cost_box_kernel: a body shared by two modes cost the single
// volume registers and time whenever that was tried.
//
// All values are exact small integers (Sobel output <= 2 * 63, BT <= 252,
// box sum <= 121 * 252 = 30492 < 32767), so integer arithmetic reproduces
// the float32 plain version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {


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
constexpr int TXB = 16;       // output columns per block
constexpr int TXP_PAIR = 16;  // output columns per block of the pair kernel
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

// A staged partner word: terms (lo, hi) in the halves, (RV, RV + 256, RMX,
// RMN + 256), as cost_box_kernel stages its right-view pairs.
__device__ __forceinline__ uint4 pair_word(unsigned v_lo, unsigned mn_lo,
                                           unsigned mx_lo, unsigned v_hi,
                                           unsigned mn_hi, unsigned mx_hi) {
  const unsigned RV = v_lo | (v_hi << 16);
  return make_uint4(RV, RV + BIAS2, mx_lo | (mx_hi << 16),
                    (mn_lo | (mn_hi << 16)) + BIAS2);
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

// The pair kernel: cost_box_kernel's walk down a strip of rows (one BT row
// staged per step, a sliding horizontal sum, a ring of BLOCK horizontal-sum
// rows, two disparities per 32-bit word), with two kinds of block in one
// launch: blocks bx < n_main own C_L tile x0 = bx * TXP, the others C_R
// tile x0 = (bx - n_main) * TXP, own pixel in rt and partner in lt at x + d
// + md. Both store whole words as cost_box_kernel does. The two are
// compile-time instances of one body (CR), so neither carries the other's
// selects in its registers.
//
// Partner terms: term k is image column clamp(pbase + k). A C_L block
// (pbase = x0 - R0 - (D - 1) - md) pairs tile column j with k0 = j + D - 1
// - 2t in the low half and k0 - 1 in the high, as cost_box_kernel; a C_R
// block (pbase = x0 - R0 + md) with k = j + 2t in the low half and k + 1
// in the high. Either way the word for an even j sits at pe[j / 2] and for
// an odd j at po[(j - 1) / 2], so that a warp reads 32 consecutive 16-byte
// words. Clamped columns: a C_L tile cut by the image's right edge repeats
// column W - 1's cost (as cost_box_kernel), a C_R tile cut by the left
// edge repeats column 0's (there the own column clamps and the partner,
// at d + md, does not).
template <int BLOCK, int TXP, bool CR>
__device__ __forceinline__ void pair_strip(const float* __restrict__ lt,
                                           const float* __restrict__ rt,
                                           int16_t* __restrict__ out, int B,
                                           int H, int W, int D, int md,
                                           int SH, int x0) {
  constexpr int R0 = BLOCK / 2;
  constexpr int NJ = TXP + BLOCK - 1;
  const int NR = NJ + D - 1;
  const int NP = NR / 2 + 1;
  const int NT = NJ + 2 * NP;
  extern __shared__ uint4 smem16[];
  const int T = blockDim.x;  // D / 2
  unsigned* ring = (unsigned*)(smem16 + 2 * NT);  // [BLOCK][TXP][T]
  const int b = blockIdx.z, t = threadIdx.x;
  const int y0 = blockIdx.y * SH, y1 = min(y0 + SH, H);
  const float* own = (CR ? rt : lt) + (size_t)b * H * W;
  const float* par = (CR ? lt : rt) + (size_t)b * H * W;
  const int pbase = CR ? x0 - R0 + md : x0 - R0 - (D - 1) - md;
  const int jW = W - 1 - (x0 - R0);  // C_L tiles: last unclamped column
  const int jL = R0 - x0;            // C_R tiles: first unclamped column
  const unsigned h0 = (unsigned)(BLOCK * 256) * 0x10001u;  // biased zero

  for (int i = 0; i < BLOCK * TXP; ++i) ring[i * T + t] = h0;
  unsigned V[TXP];
#pragma unroll
  for (int i = 0; i < TXP; ++i) V[i] = 0;

  int slot = 0;
  const int steps = (y1 - y0) + BLOCK - 1;
  for (int s = 0; s < steps; ++s) {
    const size_t row = (size_t)clampi(y0 - R0 + s, 0, H - 1) * W;
    uint4* tl = smem16 + (s & 1) * NT;
    uint4* qo = tl + NJ;
    uint4* qe = qo + NP;
    for (int i = t; i < NJ; i += T) {
      unsigned v, mn, mx;
      bt_terms3(own + row, clampi(x0 - R0 + i, 0, W - 1), W, &v, &mn, &mx);
      const unsigned L = v * 0x10001u;
      tl[i] = make_uint4(L + BIAS2, L, mx * 0x10001u, mn * 0x10001u + BIAS2);
    }
    for (int m = t; m < NP; m += T) {
      // terms k1 .. k1 + 2; C_L: qo[m] = (2m + 1, 2m), qe[m] = (2m, 2m - 1);
      // C_R: qe[m] = (2m, 2m + 1), qo[m] = (2m + 1, 2m + 2), (low, high)
      const int k1 = CR ? 2 * m : 2 * m - 1;
      unsigned v0, mn0, mx0, v1, mn1, mx1, v2, mn2, mx2;
      bt_terms3(par + row, clampi(pbase + k1, 0, W - 1), W, &v0, &mn0, &mx0);
      bt_terms3(par + row, clampi(pbase + k1 + 1, 0, W - 1), W, &v1, &mn1,
                &mx1);
      bt_terms3(par + row, clampi(pbase + k1 + 2, 0, W - 1), W, &v2, &mn2,
                &mx2);
      qo[m] = CR ? pair_word(v1, mn1, mx1, v2, mn2, mx2)
                   : pair_word(v2, mn2, mx2, v1, mn1, mx1);
      qe[m] = CR ? pair_word(v0, mn0, mx0, v1, mn1, mx1)
                   : pair_word(v1, mn1, mx1, v0, mn0, mx0);
    }
    __syncthreads();

    const uint4* pe = CR ? qe + t : qo + (T - 1 - t);
    const uint4* po = CR ? qo + t : qe + (T - t);
    unsigned bt[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const uint4 r = (j & 1) ? po[(j - 1) >> 1] : pe[j >> 1];
      const uint4 l = tl[j];
      const unsigned c_lr = max2(max2(l.x - r.z, r.w - l.y), BIAS2);
      const unsigned c_rl = max2(max2(r.y - l.z, l.w - r.x), BIAS2);
      bt[j] = min2(c_lr, c_rl);
    }
    if (!CR && jW < NJ - 1) {
#pragma unroll
      for (int j = 1; j < NJ; ++j) bt[j] = j > jW ? bt[j - 1] : bt[j];
    }
    if (CR && jL > 0) {
#pragma unroll
      for (int j = NJ - 2; j >= 0; --j) bt[j] = j < jL ? bt[j + 1] : bt[j];
    }
    unsigned* rs = ring + slot * TXP * T + t;
    unsigned h = 0;
#pragma unroll
    for (int k = 0; k < BLOCK; ++k) h += bt[k];
#pragma unroll
    for (int i = 0; i < TXP; ++i) {
      if (i > 0) h = h + bt[i + BLOCK - 1] - bt[i - 1];
      const unsigned old = rs[i * T];
      rs[i * T] = h;
      V[i] = V[i] + h - old;
    }
    slot = slot + 1 == BLOCK ? 0 : slot + 1;
    if (s < BLOCK - 1) continue;

    const int y = y0 + s - (BLOCK - 1);
    unsigned* o = (unsigned*)(out + ((((size_t)(CR ? B : 0) + b) * H +
                                      y) * W + x0) * D) + t;
#pragma unroll
    for (int i = 0; i < TXP; ++i) {
      if (x0 + i < W) o[(size_t)i * T] = V[i];
    }
  }
}

template <int BLOCK, int TXP>
__global__ void __launch_bounds__(128)
cost_pair_strip_kernel(const float* __restrict__ lt,
                       const float* __restrict__ rt,
                       int16_t* __restrict__ out, int B, int H, int W, int D,
                       int md, int SH, int n_main) {
  const int bx = blockIdx.x;
  if (bx < n_main)
    pair_strip<BLOCK, TXP, false>(lt, rt, out, B, H, W, D, md, SH, bx * TXP);
  else
    pair_strip<BLOCK, TXP, true>(lt, rt, out, B, H, W, D, md, SH,
                                 (bx - n_main) * TXP);
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

template <int BLOCK, int TXP>
cudaError_t launch_pair(const float* lt, const float* rt, int16_t* out, int B,
                        int H, int W, int D, int md, cudaStream_t stream) {
  const int NJ = TXP + BLOCK - 1, NR = NJ + D - 1, NP = NR / 2 + 1;
  const size_t smem = sizeof(uint4) * 2 * (NJ + 2 * NP) +
                      sizeof(unsigned) * (size_t)BLOCK * TXP * (D / 2);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cost_pair_strip_kernel<BLOCK, TXP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int strips0 = (H + STRIP - 1) / STRIP;
  const int SH = (H + strips0 - 1) / strips0;
  const int n_main = (W + TXP - 1) / TXP;
  dim3 grid(2 * n_main, (H + SH - 1) / SH, B);
  cost_pair_strip_kernel<BLOCK, TXP><<<grid, D / 2, smem, stream>>>(
      lt, rt, out, B, H, W, D, md, SH, n_main);
  return cudaGetLastError();
}

template <int BLOCK>
cudaError_t launch(const float* lt, const float* rt, int16_t* out, int B,
                   int H, int W, int D, int md, int pair,
                   cudaStream_t stream) {
  return pair ? launch_pair<BLOCK, TXP_PAIR>(lt, rt, out, B, H, W, D, md,
                                             stream)
              : launch_box<BLOCK>(lt, rt, out, B, H, W, D, md, stream);
}

}  // namespace

// lt, rt: (B, H, W) float32 Sobel-clipped images (exact integers).
// out: (B, H, W, D) int16, or with pair != 0 (2B, H, W, D): C_L then C_R.
// block must be odd, 1..11; D even, 2 <= D <= 256.
extern "C" int sdr_cost_box(const float* lt, const float* rt, int16_t* out,
                            int B, int H, int W, int D, int md, int block,
                            int pair, void* stream) {
  if (D < 2 || D > 256 || D % 2 || md < 0 ||
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
