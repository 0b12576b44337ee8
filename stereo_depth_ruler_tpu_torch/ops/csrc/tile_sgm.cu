// K9: the tile matcher on int16 partial path sums, in three sweeps.
//
// Replaces stereo_depth_ruler_tpu/ops/sgbm_pallas.py:sgbm_tile_pallas on
// its biased route (_wta_bias not None): the down-going and horizontal
// paths summed into one int16 volume S_dh shifted by a bias
// (directional_pass_pallas with acc and out_offset = -bias), then the
// up-going paths fused with the WTA (_up_wta_kernel with sd_offset = bias),
// so the 8-path sum never reaches device memory. Every path is
//
//   L(p, d) = C(p, d) + min(L(p-r, d), L(p-r, d+-1) + P1, minL + P2) - minL
//
// with a zero predecessor outside the slab (L = C at a line's first cell),
// as ops/sgbm.py:directional_pass. The slab C is (M, W, D) int16, M =
// top_halo + R rows, R = local + bottom_halo the body rows.
//
//   1. tile_sweep_kernel<UP = false> (sdr_tile_down): the vertical path,
//      and with 8 paths both diagonals, over all M rows; writes S_dh =
//      L_down - bias for the R body rows (the top halo is warm-up only);
//   2. tile_horiz_kernel (sdr_tile_horiz): both horizontal paths of each
//      body row added into S_dh;
//   3. tile_sweep_kernel<UP = true> (sdr_tile_up_wta): the up-going paths
//      from the slab's last row up to the first body row; each row's S =
//      S_dh + bias + L_up goes to the WTA in registers (K3's body: packed
//      key reduce, exact integer uniqueness, IEEE subpixel, rintf for
//      quantize_16) for the local rows; writes the disparity before the LR
//      check, -1.0 where invalid;
//   4. tile_lr_kernel (sdr_tile_lr): the LR check. Its right-view
//      disparity is the per-row winner scatter of wta_lr.cu, which crosses
//      strips: the up sweep scatters each column's packed winner key
//      (s0 * PK + d* + md) by atomicMin into a per-row int32 buffer
//      (device memory, set to 0x7f7f7f7f first: "no winner"), which is
//      order-independent and so exact; this pass reads it after the sweep.
//
// The sweeps (1, 3). One frame gives a row of ~1280 columns, too few for
// a row-parallel design to fill the card, so a block owns a strip of sw =
// ceil(W / multiprocessors) columns (one strip a multiprocessor, 10 at
// 1280 columns) and walks its rows, one block barrier a row. A path warp
// holds a column's D disparities in words of two (16-bit halves, 2 * NWD
// a lane): its three paths' steps are min.u16x2 / add / subtract on both
// halves without carries, minL one __reduce_min_sync, d +- 1 a shuffle
// and a byte permute, half the instructions of one disparity a register
// (a row is bound by the issue of these steps and their dependent chain,
// not by bytes). The strip's C rows (and S_dh rows for the up sweep)
// arrive in shared memory by cp.async three rows ahead; the L rows live
// in shared memory (every L stays below 2^15 on a biased route), the
// diagonals' double-buffered by row parity. In the up sweep the path
// warps write each row's 8-path sums to shared memory and WTA warps of
// their own reduce them a row later, which takes the WTA off the paths'
// chain. The diagonals couple neighbouring strips through their edge
// columns, exchanged as in cost_down.cu: 64-bit words of a word of two
// values and its row tag in device memory, a reader spinning on the tags;
// an edge column publishes the path its neighbour reads first (it needs
// only the strip's own row before) and reads the neighbour's last, all
// its words loaded together at the start, so the L2 round trip overlaps
// the column's work. The launch is cooperative only so that every strip
// is resident.
//
// The horizontal sweep (2). Two warps per body row, one walking x up and
// one down, each from its end of the row to the middle; a block barrier;
// then each on to the other end. Every cell is read-modified-written once
// by each walk, in two phases the barrier orders, so S_dh needs no atomics.
// A walk stages chunks of C and S_dh (contiguous in the row) into its own
// shared memory by cp.async three chunks ahead: one load at a time per
// step, even prefetched in registers, kept too few bytes in flight.
//
// What bounds it on the H100: the sweeps' row-to-row chain at one frame
// a launch (issue of the path steps on ~10 columns a multiprocessor, and
// the edge exchange), and the horizontal sweep's bytes (C twice, S_dh
// read and written twice: 12 B per element). In all: C read 4 times,
// S_dh written 3 times and read 3 times.
//
// All values are exact small integers (the caller keeps S_dh within int16
// by the bias it chooses), the WTA's float operations are K3's, so the
// result equals ops/sgbm.py:sgbm_tile bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BIG = 1 << 29;          // above any path value
constexpr int SWMAX = 32;             // columns of a strip, at most
constexpr int NBUF = 4;               // staged rows: NBUF - 1 ahead
constexpr int NOWIN = 0x7f7f7f7f;     // "no winner landed" (memset 0x7f)
constexpr int HROWS = 2;              // body rows per horizontal block
constexpr int HST = 4;                // horizontal chunks staged per walk
constexpr int HCHB = 2048;            // bytes of C (and of S) in a chunk
constexpr unsigned FULL = 0xffffffffu;

// VPL int16 values at p[d0 ..] (16-bit lanes of 32-bit words; 16-byte
// aligned rows) into ints, ``fill`` beyond D.
template <int VPL>
__device__ __forceinline__ void ld16(const int16_t* p, int d0, int D, int fill,
                                     int* v) {
  if constexpr (VPL == 2 || VPL == 4 || VPL == 8) {
    if (d0 + VPL <= D) {
      unsigned w[VPL / 2];
      if constexpr (VPL == 8) {
        const uint4 u = *(const uint4*)(p + d0);
        w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
      } else if constexpr (VPL == 4) {
        const uint2 u = *(const uint2*)(p + d0);
        w[0] = u.x; w[1] = u.y;
      } else {
        w[0] = *(const unsigned*)(p + d0);
      }
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        const unsigned x = w[k >> 1];
        v[k] = (k & 1) ? ((int)x >> 16) : ((int)(x << 16) >> 16);
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < VPL; ++k) v[k] = d0 + k < D ? (int)p[d0 + k] : fill;
}

template <int VPL>
__device__ __forceinline__ void st16(int16_t* p, int d0, int D, const int* v) {
  if constexpr (VPL == 2 || VPL == 4 || VPL == 8) {
    if (d0 + VPL <= D) {
      unsigned w[VPL / 2];
#pragma unroll
      for (int k = 0; k < VPL; k += 2)
        w[k >> 1] = ((unsigned)v[k] & 0xffffu) | ((unsigned)v[k + 1] << 16);
      if constexpr (VPL == 8) {
        *(uint4*)(p + d0) = make_uint4(w[0], w[1], w[2], w[3]);
      } else if constexpr (VPL == 4) {
        *(uint2*)(p + d0) = make_uint2(w[0], w[1]);
      } else {
        *(unsigned*)(p + d0) = w[0];
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < VPL; ++k)
    if (d0 + k < D) p[d0 + k] = (int16_t)v[k];
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the newest N complete
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One path step of a warp's column: prev (BIG beyond D) and c -> L.
template <int VPL>
__device__ __forceinline__ void dp_step(const int* prev, const int* c, int P1,
                                        int P2, int d0, int D, int lane,
                                        int* L) {
  int m = prev[0];
#pragma unroll
  for (int k = 1; k < VPL; ++k) m = min(m, prev[k]);
  const int minL = __reduce_min_sync(FULL, m);
  int lm1 = __shfl_up_sync(FULL, prev[VPL - 1], 1);
  int lp1 = __shfl_down_sync(FULL, prev[0], 1);
  if (lane == 0) lm1 = BIG;
  if (lane == 31) lp1 = BIG;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int a = k == 0 ? lm1 : prev[k > 0 ? k - 1 : 0];
    const int z = k == VPL - 1 ? lp1 : prev[k < VPL - 1 ? k + 1 : k];
    const int best = min(min(prev[k], minL + P2), min(a, z) + P1);
    L[k] = d0 + k < D ? c[k] + best - minL : BIG;
  }
}

constexpr unsigned BIG2 = 0x7fff7fffu;   // above any path value, both halves

__device__ __forceinline__ unsigned min2(unsigned a, unsigned b) {
  unsigned r;
  asm("min.u16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// NWD 32-bit words at p (4 * NWD-byte aligned)
template <int NWD>
__device__ __forceinline__ void ldw(const void* p, unsigned* w) {
  if constexpr (NWD == 1) {
    w[0] = *(const unsigned*)p;
  } else if constexpr (NWD == 2) {
    const uint2 u = *(const uint2*)p;
    w[0] = u.x; w[1] = u.y;
  } else {
    const uint4 u = *(const uint4*)p;
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  }
}

template <int NWD>
__device__ __forceinline__ void stw(void* p, const unsigned* w) {
  if constexpr (NWD == 1) {
    *(unsigned*)p = w[0];
  } else if constexpr (NWD == 2) {
    *(uint2*)p = make_uint2(w[0], w[1]);
  } else {
    *(uint4*)p = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// dp_step on words of two disparities (16-bit halves, values below 2^15,
// BIG2 beyond D): min / add / subtract act on both halves without
// carries; d - 1 and d + 1 are a shuffle and a byte permute.
template <int NWD>
__device__ __forceinline__ void dp_step2(const unsigned* pw, const unsigned* cw,
                                         unsigned p1, int P2, int lane,
                                         bool act, unsigned* Lw) {
  unsigned m = pw[0];
#pragma unroll
  for (int j = 1; j < NWD; ++j) m = min2(m, pw[j]);
  const int minL = __reduce_min_sync(FULL, (int)min(m & 0xffffu, m >> 16));
  unsigned up = __shfl_up_sync(FULL, pw[NWD - 1], 1);
  unsigned dn = __shfl_down_sync(FULL, pw[0], 1);
  if (lane == 0) up = BIG2;
  if (lane == 31) dn = BIG2;
  const unsigned ml = (unsigned)minL * 0x10001u;
  const unsigned mp = (unsigned)(minL + P2) * 0x10001u;
#pragma unroll
  for (int j = 0; j < NWD; ++j) {
    const unsigned a =
        __byte_perm(j == 0 ? up : pw[j > 0 ? j - 1 : 0], pw[j], 0x5432);
    const unsigned z = __byte_perm(
        pw[j], j == NWD - 1 ? dn : pw[j < NWD - 1 ? j + 1 : j], 0x5432);
    const unsigned best = min2(min2(pw[j], mp), min2(a, z) + p1);
    Lw[j] = act ? cw[j] + best - ml : BIG2;
  }
}

// The edge exchange: a word of two L values and its step tag in one
// 64-bit word, so a word is whole or not there (no fence, no flag);
// relaxed at GPU scope, so a waiting lane rereads the L2.
template <int NWD>
__device__ __forceinline__ void put_edge(unsigned long long* p,
                                         const unsigned* w, unsigned tag) {
#pragma unroll
  for (int k = 0; k < NWD; ++k)
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p + k),
                 "l"((unsigned long long)tag << 32 | w[k])
                 : "memory");
}

// Issues the loads of an edge's NWD words at once (no wait).
template <int NWD>
__device__ __forceinline__ void load_edge(const unsigned long long* p,
                                          unsigned long long* v) {
#pragma unroll
  for (int k = 0; k < NWD; ++k)
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
                 : "=l"(v[k]) : "l"(p + k) : "memory");
}

// The edge's words with this tag: from v (loaded earlier), all words
// reloaded together until every one carries the tag.
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

// v[i] for a warp-uniform i (registers need a static index)
template <int VPL>
__device__ __forceinline__ int pick(const int* v, int i) {
  int r = v[0];
#pragma unroll
  for (int k = 1; k < VPL; ++k) r = k == i ? v[k] : r;
  return r;
}


// The WTA of pixel (y, x) from its path sums S (VPL a lane): wta_lr.cu's
// body. Writes the disparity before the LR check (-1.0 where invalid)
// and, with lr, scatters the winner's packed key into the row's d2p.
template <int VPL>
__device__ __forceinline__ void wta_pixel(const int* S_in, int x, int y, int W,
                                          int D, int d0, int lane, int md,
                                          int uniq, int quant16, int lr,
                                          int pk_bits, float* out,
                                          int* d2p) {
  const int PK = 1 << pk_bits;
  int tot[VPL];
  int key = 0x7fffffff;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    tot[k] = d0 + k < D ? S_in[k] : BIG;
    if (d0 + k < D) key = min(key, tot[k] * PK + d0 + k);
  }
  key = __reduce_min_sync(FULL, key);
  const int dstar = key & (PK - 1);
  const int s0 = key >> pk_bits;
  int valid = 1;
  if (uniq > 0) {
    int mt = BIG;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int d = d0 + k;
      if (d < D && abs(d - dstar) > 1) mt = min(mt, tot[k]);
    }
    mt = __reduce_min_sync(FULL, mt);
    if (100LL * mt < (long long)(100 + uniq) * s0) valid = 0;
  }
  float off = 0.0f;
  if (dstar > 0 && dstar < D - 1) {
    const int dm = dstar - 1, dp = dstar + 1;
    const int vm = __shfl_sync(FULL, pick<VPL>(tot, dm % VPL), dm / VPL);
    const int vp = __shfl_sync(FULL, pick<VPL>(tot, dp % VPL), dp / VPL);
    const float fs0 = (float)s0, fsm = (float)vm, fsp = (float)vp;
    const float denom =
        fmaxf(__fsub_rn(__fadd_rn(fsm, fsp), __fmul_rn(2.0f, fs0)), 1e-6f);
    off = __fdiv_rn(__fsub_rn(fsm, fsp), __fmul_rn(2.0f, denom));
    off = fminf(fmaxf(off, -0.5f), 0.5f);
  }
  float disp = __fadd_rn(__fadd_rn((float)dstar, off), (float)md);
  if (quant16) disp = __fdiv_rn(rintf(__fmul_rn(disp, 16.0f)), 16.0f);
  const int xr = x - dstar - md;   // the partner column
  if (xr < 0 || xr > W - 1) valid = 0;
  if (lane == 0) {
    out[(size_t)y * W + x] = valid ? disp : -1.0f;
    if (lr && xr >= 0 && xr < W) atomicMin(&d2p[(size_t)y * W + xr], key + md);
  }
}

// Shared memory of a sweep block of sw columns: the staged C rows, the up
// sweep's staged S_dh rows, the vertical L row, the diagonals' L rows (two
// parities each) and the up sweep's path sums (int32, two parities).
size_t sweep_smem(int D, bool up, int sw) {
  return (size_t)D * sizeof(int16_t) * sw * (NBUF * (up ? 2 : 1) + 1 + 4) +
         (up ? (size_t)D * sizeof(int) * sw * 2 : 0);
}

// One sweep over n rows of a strip of sw columns per block (grid: strips,
// one a multiprocessor). Down: rows 0 .. n-1 of C (n = M), writing S_dh =
// L - bias to rows y - top >= 0 of S. Up: rows n-1 .. 0 of the body C and
// S_dh (n = R), the WTA of rows y < local into out and (lr) the winner
// scatter into d2p.
//
// A path warp takes a column's three paths (dir 0 from column x, 1 from
// x - 1, 2 from x + 1) on words of two disparities, 2 * NWD a lane. The
// up sweep's path warps write each row's sums S = S_dh + bias + L_up to
// shared memory, and WTA warps of their own reduce them a step later, so
// the WTA is off the path warps' chain.
//
// Strips exchange their edge columns' diagonal paths: edge: zeroed,
// (strips, 4 slots, 2 sides, D / 2) 64-bit words of a word and its step
// tag (t + 1): side 0 the first column's dir-2 L, side 1 the last
// column's dir-1 L, step t's in slot t % 4. An edge column first computes
// and publishes the path its neighbour reads (from the strip's own row
// before), then its vertical path, and last the path that reads the
// neighbour's edge (loaded at the task's start), so the exchange's round
// trip overlaps the column's work. A strip that writes step q has seen its
// neighbour's step q - 2, so the neighbour has read the strip's steps up
// to q - 4: four slots never collide.
template <int NWD, bool UP>
__global__ void __launch_bounds__(768) tile_sweep_kernel(
    const int16_t* __restrict__ C, int16_t* __restrict__ S,
    float* __restrict__ out, int* __restrict__ d2p, unsigned long long* edge,
    int n, int W, int D, int top, int local, int bias, int P1, int P2,
    int ndir, int strips, int sw, int md, int uniq, int quant16, int lr,
    int pk_bits) {
  constexpr int VPL = 2 * NWD;                       // disparities a lane
  extern __shared__ __align__(16) unsigned char smem[];
  const int SD = sw * D;
  int16_t* cbuf = (int16_t*)smem;                    // [NBUF][sw][D]
  int16_t* sbuf = cbuf + NBUF * SD;                  // up: [NBUF][sw][D]
  int16_t* Lv = sbuf + (UP ? NBUF * SD : 0);         // [sw][D]
  int16_t* L1 = Lv + SD;                             // [2][sw][D]
  int16_t* L2 = L1 + 2 * SD;                         // [2][sw][D]
  int* sS = (int*)(L2 + 2 * SD);                     // up: [2][sw][D]
  const int s = blockIdx.x, x0 = s * sw;
  const int ncol = min(sw, W - x0);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  // the path warps, then (up) the WTA warps
  const int NW = min(sw, 16), NWT = (nth >> 5) - NW;
  const int d0 = lane * VPL;
  const bool act = d0 < D;
  const int ED = D / 2;                              // words of an edge
  const size_t rowel = (size_t)W * D;
  const int nchunk = ncol * D / 8;   // 16-byte chunks of the strip's row
  const unsigned p1 = (unsigned)P1 * 0x10001u;

  auto stage = [&](int t) {
    if (t < n) {
      const int y = UP ? n - 1 - t : t;
      const size_t g = (size_t)y * rowel + (size_t)x0 * D;
      int16_t* cb = cbuf + (t % NBUF) * SD;
      for (int i = tid; i < nchunk; i += nth) cp_async16(cb + 8 * i, C + g + 8 * i);
      if (UP) {
        int16_t* sb = sbuf + (t % NBUF) * SD;
        for (int i = tid; i < nchunk; i += nth)
          cp_async16(sb + 8 * i, S + g + 8 * i);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < NBUF - 1; ++t) stage(t);

  for (int t = 0; t < n + (UP ? 1 : 0); ++t) {
    cp_async_wait<NBUF - 2>();
    __syncthreads();
    stage(t + NBUF - 1);
    if (warp >= NW) {
      // the WTA of the step before, from its path sums in sS
      const int yw = n - t;
      if (t > 0 && yw < local)
        for (int xl = warp - NW; xl < ncol; xl += NWT)
          wta_pixel<VPL>(sS + ((t - 1) & 1) * SD + xl * D + d0, x0 + xl, yw,
                         W, D, d0, lane, md, uniq, quant16, lr, pk_bits, out,
                         d2p);
      continue;
    }
    if (t == n) break;
    const int y = UP ? n - 1 - t : t;
    const int16_t* cb = cbuf + (t % NBUF) * SD;
    const int par = t & 1, slot = t % 4, pslot = (t + 3) % 4;
    const unsigned tag_in = (unsigned)t, tag_out = (unsigned)t + 1;
    const bool emit = UP ? y < local : y >= top;
    for (int xl = warp; xl < ncol; xl += NW) {
      const int x = x0 + xl;
      unsigned cw[NWD], Lu[NWD], La[NWD], Lb[NWD];   // dirs 0, 1, 2
      // an edge column's neighbour words, loaded first and checked where
      // they are read
      const unsigned long long* ep =
          (xl == 0 ? edge + ((size_t)((s - 1) * 4 + pslot) * 2 + 1) * ED
                   : edge + ((size_t)((s + 1) * 4 + pslot) * 2) * ED) +
          lane * NWD;
      unsigned long long ew[NWD];
      if (act && ndir == 3 && t > 0 &&
          ((xl == 0 && x > 0) || (xl == ncol - 1 && x < W - 1)))
        load_edge<NWD>(ep, ew);
      if (act) {
        ldw<NWD>(cb + xl * D + d0, cw);
      } else {
#pragma unroll
        for (int j = 0; j < NWD; ++j) cw[j] = 0;
      }
      // one path at (y, x)
      auto path = [&](const int dir, unsigned* L) {
        const bool start = t == 0 || (dir == 1 && x == 0) ||
                           (dir == 2 && x == W - 1);
        if (start) {
#pragma unroll
          for (int j = 0; j < NWD; ++j) L[j] = act ? cw[j] : BIG2;
          return;
        }
        unsigned pw[NWD];
        if (!act) {
#pragma unroll
          for (int j = 0; j < NWD; ++j) pw[j] = BIG2;
        } else if (dir == 0) {
          ldw<NWD>(Lv + xl * D + d0, pw);
        } else if ((dir == 1 && xl == 0) || (dir == 2 && xl == ncol - 1)) {
          get_edge<NWD>(ep, ew, pw, tag_in);
        } else {
          ldw<NWD>((dir == 1 ? L1 + (par ^ 1) * SD + (xl - 1) * D
                             : L2 + (par ^ 1) * SD + (xl + 1) * D) + d0,
                   pw);
        }
        dp_step2<NWD>(pw, cw, p1, P2, lane, act, L);
      };
      // an edge column first runs the path its neighbour reads
      unsigned long long* mine =
          edge + ((size_t)(s * 4 + slot) * 2) * ED + lane * NWD;
      if (ndir == 1) {
        path(0, Lu);
      } else if (xl == 0 && s > 0) {
        path(2, Lb);
        if (act) put_edge<NWD>(mine, Lb, tag_out);
        path(0, Lu);
        path(1, La);
      } else if (xl == ncol - 1 && s + 1 < strips) {
        path(1, La);
        if (act) put_edge<NWD>(mine + ED, La, tag_out);
        path(0, Lu);
        path(2, Lb);
      } else {
        path(0, Lu);
        path(1, La);
        path(2, Lb);
      }
      // the rest touches no other lane: lanes beyond D skip it
      if (!act) continue;
      stw<NWD>(Lv + xl * D + d0, Lu);
      unsigned tw[NWD];   // the sum, below 2^16 in each half
#pragma unroll
      for (int j = 0; j < NWD; ++j) tw[j] = Lu[j];
      if (ndir == 3) {
        stw<NWD>(L1 + par * SD + xl * D + d0, La);
        stw<NWD>(L2 + par * SD + xl * D + d0, Lb);
#pragma unroll
        for (int j = 0; j < NWD; ++j) tw[j] += La[j] + Lb[j];
      }
      if (!emit) continue;
      int tot[VPL];
#pragma unroll
      for (int j = 0; j < NWD; ++j) {
        tot[2 * j] = (int)(tw[j] & 0xffffu);
        tot[2 * j + 1] = (int)(tw[j] >> 16);
      }
      if (!UP) {
#pragma unroll
        for (int k = 0; k < VPL; ++k) tot[k] -= bias;
        st16<VPL>(S + (size_t)(y - top) * rowel + (size_t)x * D, d0, D, tot);
        continue;
      }
      // S = S_dh + bias + L_up for the WTA warps
      int sd[VPL];
      ld16<VPL>(sbuf + (t % NBUF) * SD + xl * D, d0, D, 0, sd);
      int* sr = sS + par * SD + xl * D + d0;
#pragma unroll
      for (int k = 0; k < VPL; ++k) sr[k] = tot[k] + sd[k] + bias;
    }
  }
}

// The LR check of the local rows, after the up sweep: a pixel whose
// disparity is valid (>= 0: md >= 0) keeps it where the winner scattered to
// x - rint(disp) agrees within disp12.
__global__ void tile_lr_kernel(float* __restrict__ out,
                               const int* __restrict__ d2p, int n, int W,
                               int disp12, int pk_bits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float disp = out[i];
  if (disp < 0.0f) return;
  const int y = i / W, x = i - y * W;
  const int xr = x - __float2int_rn(disp);
  if (xr < 0 || xr >= W) return;
  const int p = d2p[(size_t)y * W + xr];
  const float d2 = p != NOWIN ? (float)(p & ((1 << pk_bits) - 1)) : -1.0f;
  if (!(d2 >= 0.0f && fabsf(__fsub_rn(d2, disp)) <= (float)disp12))
    out[i] = -1.0f;
}

// One walk of a horizontal path over n cells of a row from x, step +-1,
// adding L into S; L carries the path between calls (``fresh``: the walk's
// first cell starts it). The warp stages chunks of HCH cells of C and S
// (contiguous, 16-byte copies by cp.async) HST - 1 chunks ahead in its own
// shared memory, ring (HST, 2, HCH * D).
template <int VPL>
__device__ __forceinline__ void walk(const int16_t* Cr, int16_t* Sr,
                                     int16_t* ring, int x, int n, int step,
                                     int D, int HCH, int d0, int lane, int P1,
                                     int P2, bool fresh, int* L) {
  const int CH = HCH * D;
  auto lowest = [&](int k, int cnt) {
    return step > 0 ? x + k * HCH : x - k * HCH - cnt + 1;
  };
  auto stage = [&](int k) {
    if (k * HCH < n) {
      const int cnt = min(HCH, n - k * HCH);
      const size_t g = (size_t)lowest(k, cnt) * D;
      int16_t* cb = ring + (k % HST) * 2 * CH;
      for (int q = lane; q < cnt * D / 8; q += 32) {
        cp_async16(cb + 8 * q, Cr + g + 8 * q);
        cp_async16(cb + CH + 8 * q, Sr + g + 8 * q);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < HST - 1; ++k) stage(k);
  const int nk = (n + HCH - 1) / HCH;
  for (int k = 0; k < nk; ++k) {
    cp_async_wait<HST - 2>();
    __syncwarp();
    stage(k + HST - 1);
    const int cnt = min(HCH, n - k * HCH);
    const int xa = lowest(k, cnt);
    const int16_t* cb = ring + (k % HST) * 2 * CH;
    for (int j = 0; j < cnt; ++j) {
      const int xx = x + (k * HCH + j) * step, li = xx - xa;
      int c[VPL], sv[VPL];
      ld16<VPL>(cb + li * D, d0, D, 0, c);
      ld16<VPL>(cb + CH + li * D, d0, D, 0, sv);
      if (fresh && k == 0 && j == 0) {
#pragma unroll
        for (int q = 0; q < VPL; ++q) L[q] = d0 + q < D ? c[q] : BIG;
      } else {
        int p[VPL];
#pragma unroll
        for (int q = 0; q < VPL; ++q) p[q] = L[q];
        dp_step<VPL>(p, c, P1, P2, d0, D, lane, L);
      }
#pragma unroll
      for (int q = 0; q < VPL; ++q) sv[q] += L[q];
      st16<VPL>(Sr + (size_t)xx * D, d0, D, sv);
    }
    __syncwarp();
  }
}

// Both horizontal paths of R body rows added into S (grid: R / HROWS
// blocks of two warps a row). Phase 0: the forward warp walks [0, h), the
// backward one [h, W) from W - 1; phase 1 each the other half.
template <int VPL>
__global__ void __launch_bounds__(HROWS * 64)
tile_horiz_kernel(const int16_t* __restrict__ C, int16_t* __restrict__ S,
                  int R, int W, int D, int P1, int P2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * HROWS + (warp >> 1);
  const bool bwd = warp & 1, live = row < R;
  const int d0 = lane * VPL, h = W / 2, HCH = HCHB / (2 * D);
  int16_t* ring = (int16_t*)smem + (size_t)warp * HST * 2 * HCH * D;
  const int16_t* Cr = C + (size_t)row * W * D;
  int16_t* Sr = S + (size_t)row * W * D;
  int L[VPL];
  if (live) {
    if (bwd)
      walk<VPL>(Cr, Sr, ring, W - 1, W - h, -1, D, HCH, d0, lane, P1, P2,
                true, L);
    else
      walk<VPL>(Cr, Sr, ring, 0, h, 1, D, HCH, d0, lane, P1, P2, true, L);
  }
  __syncthreads();
  if (live) {
    if (bwd)
      walk<VPL>(Cr, Sr, ring, h - 1, h, -1, D, HCH, d0, lane, P1, P2, false,
                L);
    else
      walk<VPL>(Cr, Sr, ring, h, W - h, 1, D, HCH, d0, lane, P1, P2, h == 0,
                L);
  }
}

template <int NWD, bool UP>
cudaError_t launch_sweep(const int16_t* C, int16_t* S, float* out, int* d2p,
                         unsigned long long* edge, int n, int W, int D,
                         int top, int local, int bias, int P1, int P2,
                         int ndir, int md, int uniq, int quant16, int lr,
                         int pk_bits, cudaStream_t stream) {
  int dev = 0, sms = 0, coop = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (!coop) return cudaErrorNotSupported;
  auto kern = tile_sweep_kernel<NWD, UP>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           max_smem);
  if (e != cudaSuccess) return e;
  // a strip a multiprocessor, at least 2 and at most SWMAX columns wide
  int sw = max(2, (W + sms - 1) / sms);
  if (sw > SWMAX) return cudaErrorInvalidValue;
  int strips = (W + sw - 1) / sw;
  // a path warp a column up to 16, a WTA warp a column (up to 10) or two
  const int nw = min(sw, 16);
  const int threads = 32 * (nw + (UP ? (nw <= 10 ? nw : (nw + 1) / 2) : 0));
  const size_t smem = sweep_smem(D, UP, sw);
  if (smem > (size_t)max_smem) return cudaErrorInvalidConfiguration;
  void* args[] = {(void*)&C, (void*)&S, (void*)&out, (void*)&d2p,
                  (void*)&edge, &n, &W, &D, &top, &local, &bias, &P1, &P2,
                  &ndir, &strips, &sw, &md, &uniq, &quant16, &lr, &pk_bits};
  e = cudaLaunchCooperativeKernel((void*)kern, dim3(strips), dim3(threads),
                                  args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool UP>
cudaError_t sweep_vpl(const int16_t* C, int16_t* S, float* out, int* d2p,
                      unsigned long long* edge, int n, int W, int D, int top,
                      int local, int bias, int P1, int P2, int ndir, int md,
                      int uniq, int quant16, int lr, int pk_bits,
                      cudaStream_t s) {
  // words of two disparities a lane: D <= 64 in 1, <= 128 in 2, else 4
  if (D <= 64)
    return launch_sweep<1, UP>(C, S, out, d2p, edge, n, W, D, top, local,
                               bias, P1, P2, ndir, md, uniq, quant16, lr,
                               pk_bits, s);
  if (D <= 128)
    return launch_sweep<2, UP>(C, S, out, d2p, edge, n, W, D, top, local,
                               bias, P1, P2, ndir, md, uniq, quant16, lr,
                               pk_bits, s);
  return launch_sweep<4, UP>(C, S, out, d2p, edge, n, W, D, top, local, bias,
                             P1, P2, ndir, md, uniq, quant16, lr, pk_bits, s);
}

bool bad_args(int W, int D, int P1, int P2, int ndir) {
  return W < 1 || D < 16 || D > 256 || D % 16 || P1 < 0 || P1 > 32767 ||
         P2 < 0 || P2 > 32767 || (ndir != 1 && ndir != 3);
}

}  // namespace

// int16 entries of zeroed scratch that one sweep (sdr_tile_down or
// sdr_tile_up_wta) needs: the edge exchange.
extern "C" long long sdr_tile_scratch_size(int W, int D) {
  if (W < 1 || D < 1) return -1;
  const long long strips = (W + 1) / 2;   // strips of 2 columns or more
  return strips * 8 * (D / 2) * 4;
}

// C: (M, W, D) int16 slab; S: (M - top, W, D) int16 out, the down-going
// paths' sum (ndir 3: vertical and both diagonals; 1: vertical) minus bias
// on the body rows. scratch: sdr_tile_scratch_size(W, D) int16, zeroed.
// The caller keeps every S_dh value within int16.
extern "C" int sdr_tile_down(const int16_t* C, int16_t* S, int16_t* scratch,
                             int M, int W, int D, int top, int bias, int P1,
                             int P2, int ndir, void* stream) {
  if (bad_args(W, D, P1, P2, ndir) || top < 0 || M <= top)
    return (int)cudaErrorInvalidValue;
  return (int)sweep_vpl<false>(C, S, nullptr, nullptr,
                               (unsigned long long*)scratch, M, W, D, top, 0,
                               bias, P1, P2, ndir, 0, 0, 0, 0, 1,
                               (cudaStream_t)stream);
}

// C, S: (R, W, D) int16 body rows of the slab and S_dh; both horizontal
// paths added into S in place.
extern "C" int sdr_tile_horiz(const int16_t* C, int16_t* S, int R, int W,
                              int D, int P1, int P2, void* stream) {
  if (bad_args(W, D, P1, P2, 1) || R < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((R + HROWS - 1) / HROWS), block(HROWS * 64);
  const int smem = HROWS * 2 * HST * 2 * HCHB;   // a ring per warp
  cudaStream_t s = (cudaStream_t)stream;
#define SDR_HORIZ(V)                                                         \
  case V: {                                                                  \
    const cudaError_t e = cudaFuncSetAttribute(                              \
        tile_horiz_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,   \
        smem);                                                               \
    if (e != cudaSuccess) return (int)e;                                     \
    tile_horiz_kernel<V><<<grid, block, smem, s>>>(C, S, R, W, D, P1, P2);   \
    break;                                                                   \
  }
  switch ((D + 31) / 32) {
    SDR_HORIZ(1) SDR_HORIZ(2) SDR_HORIZ(3) SDR_HORIZ(4)
    SDR_HORIZ(5) SDR_HORIZ(6) SDR_HORIZ(7) SDR_HORIZ(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SDR_HORIZ
  return (int)cudaGetLastError();
}

// C, S: (R, W, D) int16 body rows and S_dh; out: (local, W) float32, the
// disparity before the LR check (-1.0 where invalid); d2p: (local, W)
// int32, the per-row winner scatter, written when lr (set to "no winner"
// here first). scratch as sdr_tile_down's. md >= 0.
extern "C" int sdr_tile_up_wta(const int16_t* C, const int16_t* S, float* out,
                               int* d2p, int16_t* scratch, int R, int W,
                               int D, int local, int bias, int P1, int P2,
                               int ndir, int md, int uniq, int quant16,
                               int lr, void* stream) {
  if (bad_args(W, D, P1, P2, ndir) || R < 1 || local < 1 || local > R ||
      md < 0)
    return (int)cudaErrorInvalidValue;
  int pk_bits = 0;
  while ((1 << pk_bits) <= D + md) ++pk_bits;  // PK = 1 << bit_length(D+md)
  cudaStream_t s = (cudaStream_t)stream;
  if (lr) {
    const cudaError_t e =
        cudaMemsetAsync(d2p, 0x7f, sizeof(int) * (size_t)local * W, s);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)sweep_vpl<true>(C, (int16_t*)S, out, d2p,
                              (unsigned long long*)scratch, R, W, D, 0, local,
                              bias, P1, P2, ndir, md, uniq, quant16, lr,
                              pk_bits, s);
}

// out, d2p: sdr_tile_up_wta's (local, W) outputs; the LR check in place.
extern "C" int sdr_tile_lr(float* out, const int* d2p, int local, int W,
                           int D, int md, int disp12, void* stream) {
  if (local < 1 || W < 1 || md < 0 || disp12 < 0)
    return (int)cudaErrorInvalidValue;
  int pk_bits = 0;
  while ((1 << pk_bits) <= D + md) ++pk_bits;
  const int n = local * W, threads = 256;
  tile_lr_kernel<<<(n + threads - 1) / threads, threads, 0,
                   (cudaStream_t)stream>>>(out, d2p, n, W, disp12, pk_bits);
  return (int)cudaGetLastError();
}
