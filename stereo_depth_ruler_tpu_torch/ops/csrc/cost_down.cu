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
// Design. A block owns one frame's strip of TXW = 16 columns and
// walks down it one image row per step, two block barriers per step:
//   1. staging: the step's raw pixel row (only the columns the strip's BT
//      terms read) is loaded into registers a step ahead and stored to
//      shared memory a step later, so no global load is on the row's
//      path; the doubled BT terms are staged from it;
//   2. cost, as cost_box.cu's cost_box_kernel: a thread holds two
//      disparities (16-bit halves of a 32-bit word, biased by 256 so that
//      no half carries) for TXB = 8 columns, evaluates BT once per tile
//      column (1.5 times per output), slides the horizontal box sum, and a
//      ring of the last BLOCK horizontal-sum rows in shared memory gives
//      the vertical sum V in registers. C goes to device memory and to a
//      shared-memory row;
//   3. paths: a warp per column, always the same columns, runs the three
//      updates side by side on words of two disparities (max / min / add
//      on both halves; minL is one __reduce_min_sync, d +- 1 a shuffle and
//      a byte permute). The vertical path's L stays in the warp's
//      registers; the diagonals' L rows stay in shared memory, in place,
//      indexed by diagonal line. Nothing of L touches device memory but
//      the strip's two edge columns.
// No grid barrier. The diagonals couple neighbouring strips only through
// their edge columns: a strip writes its first column's (1, -1) row and its
// last column's (1, 1) row to a small device-memory exchange, each 64-bit
// word two values and the row they belong to, so a reader spins on the
// words themselves (no fence, no flag). Those two columns are computed
// first in every row and the words are loaded before the cost half, so a
// neighbour's edge is a row old when it is needed. The launch is
// cooperative only so that every block of a launch is resident (a block
// never waits on one that is not); frames that are not all resident at
// once go in several launches (8 frames of 720 x 1280 at a time on the
// H100), with 8 warps per block where all frames fit and 4 where more do.
// A strip of 32 columns, which admits a frame or two more per launch, was
// slower per frame at every batch measured.
//
// What bounds it on the H100: the row-to-row dependency and the integer
// work. The bytes are the two int16 stores (4 B per element: 1.14 ms at
// 8 x 720 x 1280 x 128); per row a block pays two barriers and a chain of
// dependent shared-memory loads, reductions and shuffles per column, so
// the time per row falls with more blocks per SM (registers are capped at
// MAX_REGS so that five 128-thread blocks fit, at the price of a few dozen
// bytes of spill in some instances; chip_smoke.py's build phase logs them)
// but not to the bytes.
//
// All values are exact small integers, so integer arithmetic reproduces
// the float32 plain version bit for bit. The caller keeps 3 * (cmax + P2)
// within int16.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned BIG2 = 0x7fff7fffu;   // above any path value, both halves
constexpr int MAX_THREADS = 256;
constexpr int MAX_REGS = 96;             // 5 blocks of 128 threads per SM
constexpr int RPT = 2;                   // raw pixels per thread and step
constexpr int TXB = 8;                   // columns per cost thread
constexpr int TXW = 16;                  // columns of a strip
constexpr int KMAX = 4;                  // columns per warp, at most
constexpr unsigned BIAS2 = 0x01000100u;  // 256 in both halves

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

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

// NWD 32-bit words at p (4 * NWD-byte aligned, shared memory)
template <int NWD>
__device__ __forceinline__ void load_words(const unsigned* p, unsigned* w) {
  if constexpr (NWD == 1) {
    w[0] = *p;
  } else if constexpr (NWD == 2) {
    const uint2 u = *(const uint2*)p;
    w[0] = u.x; w[1] = u.y;
  } else {
    const uint4 u = *(const uint4*)p;
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  }
}

template <int NWD>
__device__ __forceinline__ void store_words(unsigned* p, const unsigned* w) {
  if constexpr (NWD == 1) {
    *p = w[0];
  } else if constexpr (NWD == 2) {
    *(uint2*)p = make_uint2(w[0], w[1]);
  } else {
    *(uint4*)p = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The edge exchange: a word of two L values and the row tag it belongs to
// in one 64-bit word, so a word is whole or not there: no fence and no
// flag. Volatile accesses, so a waiting lane rereads device memory.
template <int NWD>
__device__ __forceinline__ void put_edge(unsigned long long* p,
                                         const unsigned* w, unsigned tag) {
#pragma unroll
  for (int k = 0; k < NWD; ++k)
    asm volatile("st.volatile.global.u64 [%0], %1;"
                 :: "l"(p + k),
                    "l"((unsigned long long)tag << 32 | w[k]) : "memory");
}

// Loads the NWD words of an edge at once (each 64-bit element whole).
template <int NWD>
__device__ __forceinline__ void load_edge(const unsigned long long* p,
                                          unsigned long long* v) {
  if constexpr (NWD == 1) {
    asm volatile("ld.volatile.global.u64 %0, [%1];"
                 : "=l"(v[0]) : "l"(p) : "memory");
  } else {
#pragma unroll
    for (int k = 0; k < NWD; k += 2)
      asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];"
                   : "=l"(v[k]), "=l"(v[k + 1]) : "l"(p + k) : "memory");
  }
}

// The words of an edge with this tag: from v (loaded earlier), reloaded
// until every word carries the tag.
template <int NWD>
__device__ __forceinline__ void get_edge(const unsigned long long* p,
                                         unsigned long long* v, unsigned* w,
                                         unsigned tag) {
  while (true) {
    bool ok = true;
#pragma unroll
    for (int k = 0; k < NWD; ++k) ok &= (unsigned)(v[k] >> 32) == tag;
    if (ok) break;
    load_edge<NWD>(p, v);
  }
#pragma unroll
  for (int k = 0; k < NWD; ++k) w[k] = (unsigned)v[k];
}

// Shared memory of a block: the staged BT terms of a row, its raw pixels,
// the C row, the diagonals' L rows and the ring of horizontal sums.
__host__ __device__ inline int raw_floats(int NT) { return NT + 8; }

size_t smem_bytes(int D, int block) {
  const int NJS = TXW + block - 1, NR = NJS + D - 1, NP = NR / 2 + 1;
  const int NT = NJS + 2 * NP;
  return (size_t)NT * 16 + (size_t)raw_floats(NT) * 4 +
         (size_t)TXW * D * 2 * (1 + block) + (size_t)(TXW + 1) * D * 4;
}

// Grid: n_frames * strips blocks (frames b0 ..), launched cooperatively.
// edge: (B, strips, 3 slots, 2 sides, D / 2) 64-bit words, zeroed; side 0
// the strip's first column's (1, -1) L row, side 1 its last column's
// (1, 1) row; row y's in slot y % 3 with tag y + 1 (a strip runs at most
// a row ahead of a neighbour's read, so three slots never collide).
template <int BLOCK, int NWD>
__global__ void __maxnreg__(MAX_REGS)
cost_down_kernel(const float* __restrict__ lt, const float* __restrict__ rt,
                 int16_t* __restrict__ C, int16_t* __restrict__ S3,
                 unsigned long long* edge, int b0, int H, int W, int D,
                 int md, int P1, int P2, int ndir, int strips) {
  constexpr int R0 = BLOCK / 2;           // window rows/cols -R0 .. R0
  constexpr int NJ = TXB + BLOCK - 1;     // BT columns per cost thread
  const int T = D / 2;                    // cost threads per column group
  const int NJS = TXW + BLOCK - 1;        // staged left columns
  const int NR = NJS + D - 1;             // staged right columns
  const int NP = NR / 2 + 1;              // right pairs of each parity
  const int NT = NJS + 2 * NP;            // 16-byte words of a staged row
  const int NRAW = raw_floats(NT);
  extern __shared__ uint4 smem16[];
  float* raw = (float*)(smem16 + NT);                 // [NRAW]
  unsigned* crow = (unsigned*)(raw + NRAW);           // [TXW][D / 2]
  // the diagonals' L rows in place, by line: (1, 1) at slot (x - y) mod M,
  // (1, -1) at (x + y) mod M, M = TXW + 1 (a column's predecessor on its
  // line held that slot, and no other column reads it)
  const int M = TXW + 1;
  unsigned* L12 = crow + (size_t)TXW * T;    // [dir 1, 2][M][D / 2]

  const int b = b0 + blockIdx.x / strips, s = blockIdx.x % strips;
  const int x0 = s * TXW;
  const float* lt_b = lt + (size_t)b * H * W;
  const float* rt_b = rt + (size_t)b * H * W;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int grp = tid / T, t = tid - grp * T;
  const bool coster = grp < TXW / TXB;
  const int gx = grp * TXB;               // the group's first strip column
  const int ubase = x0 - R0 - (D - 1) - md;
  const int jW = W - 1 - (x0 - R0);       // columns j > jW repeat W - 1
  const unsigned h0 = (unsigned)(BLOCK * 256) * 0x10001u;   // biased zero
  const int lane = tid & 31, warp = tid >> 5, NW = nth >> 5;
  const bool act = lane * NWD < T;        // the lane holds disparities
  const size_t eframe = (size_t)b * strips;

  // the raw pixels a staged row needs: left columns [lo_l, lo_l + nl),
  // right columns [lo_r, lo_r + nr), the clamped columns and their
  // clamped neighbours, so no index in the row is clamped twice
  const int lo_l = max(x0 - R0 - 1, 0), hi_l = min(x0 - R0 + NJS, W - 1);
  const int lo_r = clampi(ubase - 2, 0, W - 1);
  const int hi_r = clampi(ubase + 2 * NP, 0, W - 1);
  const int nl = hi_l - lo_l + 1, nr = hi_r - lo_r + 1, nrw = nl + nr;
  const int steps = H + BLOCK - 1;

  // the raw row of step st (image row clamp(st - R0)) into registers;
  // stored to shared memory a step later
  float pre[RPT];
  auto fetch = [&](int st) {
    const int n = st < steps ? nrw : 0;
    const size_t row = (size_t)clampi(st - R0, 0, H - 1) * W;
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int k = tid + q * nth;
      if (k < n)
        pre[q] = k < nl ? lt_b[row + lo_l + k] : rt_b[row + lo_r + k - nl];
    }
  };
  auto store = [&](int st) {
    const int n = st < steps ? nrw : 0;
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int k = tid + q * nth;
      if (k < n) raw[k] = pre[q];
    }
  };
  // doubled BT terms of image column c from a raw row segment
  auto terms = [&](const float* seg, int lo, int c, unsigned* v2,
                   unsigned* mn2, unsigned* mx2) {
    const int v = (int)seg[c - lo];
    const int vl = (int)seg[clampi(c - 1, 0, W - 1) - lo];
    const int vr = (int)seg[clampi(c + 1, 0, W - 1) - lo];
    const int a = 2 * v, m = v + vl, p = v + vr;
    *v2 = (unsigned)a;
    *mn2 = (unsigned)min(min(m, p), a);
    *mx2 = (unsigned)max(max(m, p), a);
  };

  // the last BLOCK rows of horizontal sums, [BLOCK][TXW][D / 2], biased
  // zeros while the window fills
  unsigned* ring = L12 + (size_t)2 * M * T;
  for (int i = tid; i < BLOCK * TXW * T; i += nth) ring[i] = h0;
  unsigned V[TXB];
#pragma unroll
  for (int i = 0; i < TXB; ++i) V[i] = 0;
  int slot = 0;
  // the vertical path's L of the warp's columns (always the same ones)
  unsigned L0[KMAX][NWD];
  fetch(0);
  store(0);
  fetch(1);
  __syncthreads();

  for (int st = 0; st < steps; ++st) {
    // stage the BT terms of the step's row from its raw pixels
    {
      const float* rl = raw;
      const float* rr = rl + nl;
      uint4* tl = smem16;
      uint4* qo = tl + NJS;   // qo[m]: low half term 2m + 1, high half 2m
      uint4* qe = qo + NP;    // qe[m]: low half term 2m, high half 2m - 1
      for (int i = tid; i < NJS; i += nth) {
        unsigned v, mn, mx;
        terms(rl, lo_l, clampi(x0 - R0 + i, 0, W - 1), &v, &mn, &mx);
        const unsigned L = v * 0x10001u;
        tl[i] = make_uint4(L + BIAS2, L, mx * 0x10001u, mn * 0x10001u + BIAS2);
      }
      for (int m = tid; m < NP; m += nth) {
        unsigned va, mna, mxa, vb, mnb, mxb, vc, mnc, mxc;  // 2m-1, 2m, 2m+1
        terms(rr, lo_r, clampi(ubase + 2 * m - 1, 0, W - 1), &va, &mna, &mxa);
        terms(rr, lo_r, clampi(ubase + 2 * m, 0, W - 1), &vb, &mnb, &mxb);
        terms(rr, lo_r, clampi(ubase + 2 * m + 1, 0, W - 1), &vc, &mnc, &mxc);
        unsigned RV = vc | (vb << 16);
        qo[m] = make_uint4(RV, RV + BIAS2, mxc | (mxb << 16),
                           (mnc | (mnb << 16)) + BIAS2);
        RV = vb | (va << 16);
        qe[m] = make_uint4(RV, RV + BIAS2, mxb | (mxa << 16),
                           (mnb | (mna << 16)) + BIAS2);
      }
    }
    __syncthreads();

    // the next step's raw row to shared memory (its readers are done),
    // and the loads of the one after that in flight
    store(st + 1);
    fetch(st + 2);

    const int y = st - (BLOCK - 1);       // the output row, if >= 0
    // the neighbours' edges of row y - 1 that the first column of warp 0
    // and of the last warp read, loaded now and checked there
    const unsigned long long* eptr = nullptr;
    unsigned long long ev[NWD];
    if (y >= 1 && ndir == 3 && act) {
      if (warp == 0 && s > 0)
        eptr = edge + ((eframe + s - 1) * 6 + ((y - 1) % 3) * 2 + 1) * T;
      else if (warp == NW - 1 && s + 1 < strips && x0 + TXW < W)
        eptr = edge + ((eframe + s + 1) * 6 + ((y - 1) % 3) * 2) * T;
      if (eptr) {
        eptr += lane * NWD;
        load_edge<NWD>(eptr, ev);
      }
    }
    if (coster) {
      // bt = 256 + min(max(0, lv - rmx, rmn - lv), max(0, rv - lmx, lmn - rv))
      const int kb = D - 1 - 2 * t;
      {
        const uint4* tl = smem16;
        const uint4* qo = tl + NJS;
        const uint4* qe = qo + NP;
        unsigned bt[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int J = gx + j;
          const int k0 = kb + J;
          const uint4 q = ((J + D - 1) & 1) ? qo[(k0 - 1) >> 1] : qe[k0 >> 1];
          const uint4 l = tl[J];
          const unsigned c_lr = max2(max2(l.x - q.z, q.w - l.y), BIAS2);
          const unsigned c_rl = max2(max2(q.y - l.z, l.w - q.x), BIAS2);
          bt[j] = min2(c_lr, c_rl);
        }
        if (jW < gx + NJ - 1) {   // the image's right edge cuts the group
#pragma unroll
          for (int j = 1; j < NJ; ++j) bt[j] = gx + j > jW ? bt[j - 1] : bt[j];
        }
        // h is biased by BLOCK * 256 per half, as the ring; V is not: the
        // entering row adds, the row it replaces in the ring subtracts
        unsigned* rs = ring + ((size_t)slot * TXW + gx) * T + t;
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
      }
      if (y >= 0) {
        unsigned* o =
            (unsigned*)(C + (((size_t)b * H + y) * W + x0 + gx) * D) + t;
#pragma unroll
        for (int i = 0; i < TXB; ++i) {
          crow[(gx + i) * T + t] = V[i];
          if (x0 + gx + i < W) o[(size_t)i * T] = V[i];
        }
      }
    }
    slot = slot + 1 == BLOCK ? 0 : slot + 1;
    __syncthreads();
    if (y < 0) continue;

    // the path updates of row y, a warp per column, the three directions
    // side by side: (1, 0) from column x, (1, 1) from x - 1, (1, -1) from
    // x + 1; outside the image a path starts here with L = C. Words hold
    // two disparities (values < 2^15, BIG2 beyond D), so max / min / add
    // work on both halves at once without carries. The first and the last
    // column come first (warp 0 and the last warp): their edges are
    // published early in the row, a row before a neighbour reads them.
    const int ym = y % M;
    const unsigned tag_in = (unsigned)y;          // row y - 1's edges
    const unsigned tag_out = (unsigned)y + 1;     // row y's
    const int K = TXW / NW;
#pragma unroll
    for (int kk = 0; kk < KMAX; ++kk) {
      if (kk >= K) break;
      const int xl = (warp == NW - 1 ? K - 1 - kk : kk) * NW + warp;
      const int x = x0 + xl;
      if (xl >= TXW || x >= W) continue;          // whole warp together
      const size_t wo = (size_t)xl * T + lane * NWD;
      int s1 = xl - ym, s2 = xl + ym;   // the diagonals' slots
      s1 += s1 < 0 ? M : 0;
      s2 -= s2 >= M ? M : 0;
      unsigned* l1 = L12 + (size_t)s1 * T + lane * NWD;
      unsigned* l2 = L12 + (size_t)(M + s2) * T + lane * NWD;
      unsigned cw[NWD], pw[3][NWD], Lw[3][NWD];
      bool start[3];
      if (act) {
        load_words<NWD>(crow + wo, cw);
      } else {
#pragma unroll
        for (int j = 0; j < NWD; ++j) cw[j] = 0;
      }
#pragma unroll
      for (int dir = 0; dir < 3; ++dir) {
        const int xp = x + (dir == 0 ? 0 : (dir == 1 ? -1 : 1));
        start[dir] = y == 0 || xp < 0 || xp >= W || dir >= ndir;
        const int xpl = xp - x0;
        if (start[dir] || !act) {
#pragma unroll
          for (int j = 0; j < NWD; ++j) pw[dir][j] = BIG2;
        } else if (xpl < 0 || xpl >= TXW) {
          // a neighbouring strip's edge column of row y - 1 (eptr)
          get_edge<NWD>(eptr, ev, pw[dir], tag_in);
        } else {
          if (dir == 0) {
#pragma unroll
            for (int j = 0; j < NWD; ++j) pw[0][j] = L0[kk][j];
          } else {
            load_words<NWD>(dir == 1 ? l1 : l2, pw[dir]);
          }
        }
      }
      int minL[3];
#pragma unroll
      for (int dir = 0; dir < 3; ++dir) {
        unsigned m = pw[dir][0];
#pragma unroll
        for (int j = 1; j < NWD; ++j) m = min2(m, pw[dir][j]);
        minL[dir] = __reduce_min_sync(0xffffffffu, min(m & 0xffffu, m >> 16));
      }
      unsigned up[3], dn[3];
#pragma unroll
      for (int dir = 0; dir < 3; ++dir) {
        up[dir] = __shfl_up_sync(0xffffffffu, pw[dir][NWD - 1], 1);
        dn[dir] = __shfl_down_sync(0xffffffffu, pw[dir][0], 1);
        if (lane == 0) up[dir] = BIG2;
        if (lane == 31) dn[dir] = BIG2;
      }
      unsigned s3[NWD];
#pragma unroll
      for (int j = 0; j < NWD; ++j) s3[j] = 0;
      const unsigned p1 = (unsigned)P1 * 0x10001u;
#pragma unroll
      for (int dir = 0; dir < 3; ++dir) {
        const unsigned ml = (unsigned)minL[dir] * 0x10001u;
        const unsigned mp = (unsigned)(minL[dir] + P2) * 0x10001u;
#pragma unroll
        for (int j = 0; j < NWD; ++j) {
          // d - 1 and d + 1 of both halves
          const unsigned a =
              __byte_perm(j == 0 ? up[dir] : pw[dir][j > 0 ? j - 1 : 0],
                          pw[dir][j], 0x5432);
          const unsigned z = __byte_perm(
              pw[dir][j], j == NWD - 1 ? dn[dir] : pw[dir][j < NWD - 1 ? j + 1 : j],
              0x5432);
          const unsigned best = min2(min2(pw[dir][j], mp), min2(a, z) + p1);
          Lw[dir][j] = start[dir] ? cw[j] : cw[j] + best - ml;
          s3[j] += dir < ndir ? Lw[dir][j] : 0u;
        }
      }
      if (act) {
#pragma unroll
        for (int j = 0; j < NWD; ++j) L0[kk][j] = Lw[0][j];
        if (ndir == 3) {
          store_words<NWD>(l1, Lw[1]);
          store_words<NWD>(l2, Lw[2]);
          // the edges the neighbouring strips read at row y + 1
          unsigned long long* e =
              edge + ((eframe + s) * 6 + (y % 3) * 2) * T + lane * NWD;
          if (xl == 0 && s > 0) put_edge<NWD>(e, Lw[2], tag_out);
          if (xl == TXW - 1 && s + 1 < strips)
            put_edge<NWD>(e + T, Lw[1], tag_out);
        }
        store_words<NWD>((unsigned*)(S3 + (((size_t)b * H + y) * W + x) * D) +
                             lane * NWD, s3);
      }
    }
  }
}

template <int BLOCK, int NWD>
cudaError_t launch(const float* lt, const float* rt, int16_t* C, int16_t* S3,
                   unsigned long long* edge, int B, int H, int W, int D, int md,
                   int P1, int P2, int ndir, cudaStream_t stream) {
  int dev = 0, sms = 0, coop = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (!coop) return cudaErrorNotSupported;
  auto kern = cost_down_kernel<BLOCK, NWD>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           max_smem);
  if (e != cudaSuccess) return e;

  // 8 warps per block where the blocks of all frames are resident at once
  // (fewer columns per warp), else 4 if more frames are; the frames in as
  // many launches as residency needs
  const int NJS = TXW + BLOCK - 1, NR = NJS + D - 1, NP = NR / 2 + 1;
  const int raw = NJS + 2 * NP + 5;   // raw pixels of a row
  const int need = max(TXW / TXB * (D / 2), (raw + RPT - 1) / RPT);
  const size_t smem = smem_bytes(D, BLOCK);
  if (smem > (size_t)max_smem) return cudaErrorInvalidConfiguration;
  const int strips = (W + TXW - 1) / TXW;
  int threads = 0, per_launch = 0;
  for (int nt = MAX_THREADS; nt >= TXW / KMAX * 32 && nt >= need; nt /= 2) {
    int occ = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, nt, smem);
    if (e != cudaSuccess) return e;
    const int nf = min(B, occ * sms / strips);
    if (nf > per_launch) threads = nt, per_launch = nf;
    if (nf == B) break;
  }
  if (per_launch < 1) return cudaErrorInvalidConfiguration;
  for (int b0 = 0; b0 < B; b0 += per_launch) {
    const int nf = min(per_launch, B - b0);
    void* args[] = {&lt, &rt, &C, &S3, &edge, &b0, &H, &W, &D, &md,
                    &P1, &P2, &ndir, (void*)&strips};
    e = cudaLaunchCooperativeKernel((void*)kern, dim3(nf * strips),
                                    dim3(threads), args, smem, stream);
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}

template <int BLOCK>
cudaError_t launch_vpl(const float* lt, const float* rt, int16_t* C,
                       int16_t* S3, unsigned long long* edge, int B,
                       int H, int W,
                       int D, int md, int P1, int P2, int ndir,
                       cudaStream_t s) {
  // words of two disparities per lane: D <= 64 in 1, <= 128 in 2, else 4
  if (D <= 64)
    return launch<BLOCK, 1>(lt, rt, C, S3, edge, B, H, W, D, md, P1, P2,
                            ndir, s);
  if (D <= 128)
    return launch<BLOCK, 2>(lt, rt, C, S3, edge, B, H, W, D, md, P1, P2,
                            ndir, s);
  return launch<BLOCK, 4>(lt, rt, C, S3, edge, B, H, W, D, md, P1, P2, ndir,
                          s);
}

}  // namespace

// int16 entries of zeroed scratch that sdr_cost_down needs: the edge
// exchange.
extern "C" long long sdr_cost_down_scratch_size(int B, int W, int D) {
  if (B < 1 || W < 1 || D < 1) return -1;
  const long long strips = (W + TXW - 1) / TXW;
  return (long long)B * strips * 6 * D * 2;
}

// lt, rt: (B, H, W) float32 Sobel-clipped images (exact integers). C, S3:
// (B, H, W, D) int16 outputs. scratch: sdr_cost_down_scratch_size(B, W, D)
// int16, zeroed. ndir: 3 (the vertical path and both diagonals) or 1.
// block odd, 1..11; D a multiple of 16, at most 256; md >= 0; P1, P2 in
// [0, 32767].
extern "C" int sdr_cost_down(const float* lt, const float* rt, int16_t* C,
                             int16_t* S3, int16_t* scratch, int B, int H,
                             int W, int D, int md, int block, int P1, int P2,
                             int ndir, void* stream) {
  if (D < 16 || D > 256 || D % 16 || md < 0 || block < 1 || block > 11 ||
      block % 2 == 0 || (ndir != 1 && ndir != 3) || B < 1 || H < 1 ||
      W < 1 || P1 < 0 || P1 > 32767 || P2 < 0 || P2 > 32767)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  auto* edge = (unsigned long long*)scratch;
  switch (block) {
    case 1: return (int)launch_vpl<1>(lt, rt, C, S3, edge, B, H, W, D, md,
                                      P1, P2, ndir, s);
    case 3: return (int)launch_vpl<3>(lt, rt, C, S3, edge, B, H, W, D, md,
                                      P1, P2, ndir, s);
    case 5: return (int)launch_vpl<5>(lt, rt, C, S3, edge, B, H, W, D, md,
                                      P1, P2, ndir, s);
    case 7: return (int)launch_vpl<7>(lt, rt, C, S3, edge, B, H, W, D, md,
                                      P1, P2, ndir, s);
    case 9: return (int)launch_vpl<9>(lt, rt, C, S3, edge, B, H, W, D, md,
                                      P1, P2, ndir, s);
    default: return (int)launch_vpl<11>(lt, rt, C, S3, edge, B, H, W, D, md,
                                        P1, P2, ndir, s);
  }
}
