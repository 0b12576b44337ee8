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
//   1. tile_sweep_kernel<UP = false> (sdr_agg_down): the vertical path,
//      and with 8 paths both diagonals, over all M rows; writes S_dh =
//      L_down - bias for the R body rows (the top halo is warm-up only);
//   2. tile_horiz_kernel (sdr_agg_horiz): both horizontal paths of each
//      body row added into S_dh;
//   3. tile_sweep_kernel<UP = true> (sdr_agg_up_wta): the up-going paths
//      from the slab's last row up to the first body row; each row's S =
//      S_dh + bias + L_up goes to the WTA in registers (K3's body: packed
//      key reduce, exact integer uniqueness, IEEE subpixel, rintf for
//      quantize_16) for the local rows; writes the disparity before the LR
//      check, -1.0 where invalid;
//   4. tile_lr_kernel (sdr_agg_lr): the LR check. Its right-view
//      disparity is the per-row winner scatter of wta_lr.cu, which crosses
//      strips: the up sweep scatters each column's packed winner key
//      (s0 * PK + d* + md) by atomicMin into a per-row int32 buffer
//      (device memory, set to 0x7f7f7f7f first: "no winner"), which is
//      order-independent and so exact; this pass reads it after the sweep.
//
// The sweeps (1, 3). One frame gives a row of ~1280 columns, too few for
// a row-parallel design to fill the card, so a block owns a strip of sw =
// ceil(W / multiprocessors) columns (one strip a multiprocessor, 10 at
// 1280 columns) and walks its rows, one block barrier a row. Every strip
// of a frame is resident at once, so a frame is at most SWMAX columns a
// multiprocessor wide (4224 on the H100's 132); ops/sgbm_cuda.py sends a
// wider one to K2 + K3 before any launch (sweep_max_width). A path warp
// holds a column's D disparities in words of two (16-bit halves, 2 * NWD
// a lane): its three paths' steps are min.u16x2 / add / subtract on both
// halves without carries, minL one __reduce_min_sync, d +- 1 a shuffle
// and a byte permute, half the instructions of one disparity a register
// (a row is bound by the issue of these steps and their dependent chain,
// not by bytes). The strip's C rows (and S_dh rows for the up sweep)
// arrive in shared memory by cp.async three rows ahead; the L rows live
// in shared memory (every L stays below 2^15 on a biased route), the
// diagonals' double-buffered by row parity. The diagonals couple
// neighbouring strips through their edge columns, exchanged as in
// cost_down.cu: 64-bit words of a word of two values and its row tag in
// device memory, a reader spinning on the tags; an edge column publishes
// the path its neighbour reads first (it needs only the strip's own row
// before) and reads the neighbour's last, all its words loaded together
// at the start, so the L2 round trip overlaps the column's work. The
// launch is cooperative only so that every strip is resident.
//
// The up sweep's WTA. A pixel's WTA is two warp reductions (the packed
// key's minimum, the uniqueness test's), two shuffles for S at d* +- 1,
// then a chain of IEEE float steps, a store and an atomicMin: about as
// many instructions as the pixel's three path steps. Run whole on the
// path warps, a pixel a row, it doubled the up sweep's instructions a
// column-row and put its float chain on every row's path. It is split in
// two (wta_reduce, wta_tail below): the reductions stay with the pixel;
// the rest runs for TAIL = 32 rows of a column at once, a lane a row, from
// (key, vm, vp) kept in shared memory, so the float chain, the store and
// the scatter cost one warp instruction for 32 pixels and leave the row
// chain. What bounds the up sweep then is the issue of the path steps and
// of the reductions (about 1 instruction a cycle a multiprocessor), not
// bytes. Two launch plans (up_plan below). Inline: the path warps run
// wta_reduce after their column's paths. The ring: WTA warps of their
// own, one a column, take each row from the path warps through RING slots
// of the L rows in shared memory handed over by mbarriers (full: the
// path warps' row is in its slot; empty: the WTA warps are done with it),
// so the path warps meet at a barrier of their own (bar.sync 1) and wait
// on the WTA only where it is RING rows behind. The ring pays where few
// columns share a multiprocessor (one frame of 720x1280x128: 0.76 against
// the inline plan's 0.92 ms); from two frames of 10-column strips its WTA
// warps and their S_dh staging cost more issue than they take off the
// chain (1.65 against 1.27 ms at 2 frames), so the inline plan runs
// there. Up / down per launch on the H100 at 720x1280x128: 1.19 at one
// frame, 1.60 at 2 frames, 1.64 at 16 frames (the WTA whole on the path
// warps: 1.23, 1.64, 1.66; PERF.md).
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
//
// The entries (sdr_agg_*) take B frames: K9 passes its one slab, the
// matcher's batch route (ops/sgbm_cuda.py:aggregate_wta) a whole (B, H,
// W, D) batch of frames, which it runs as the
// JAX package's main path runs _fused_aggregate_wta
// (stereo_depth_ruler_tpu/ops/sgbm_pallas.py: directional_pass_pallas
// _dir_pass_kernel for hf, hb and down with out_offset = -bias, then
// up_wta_pallas / _up_wta_kernel + _wta_body): a frame is a slab with no
// halo. A strip never crosses a frame. The sweeps' grid is (strips, G)
// with G frame slots: the block (s, g) walks strip s of frames g, g + G,
// ... one after the other, with each frame's edge exchange in a scratch
// region of its own, so neighbouring strips meet only inside a frame and
// every block they wait on is resident. G is as many frames as the card
// holds at once (the launch's occupancy times the multiprocessors over
// the strips, at most B): per column the up sweep keeps ~3.7 KB of shared
// memory at D = 128 (staged C and S_dh rows, L rows, the WTA tails), so
// not all of a batch's B * W columns fit at once, and the frames go in
// waves.
// A multiprocessor then runs G strips side by side, G times the columns of
// one frame a launch, which hides the row chain's latency that bounds the
// one-frame sweeps. The horizontal sweep walks R = B * H rows. A frame
// from mirror_from on is a right matcher's volume in un-mirrored
// orientation (the shared pair): its WTA and LR flip the no-partner test,
// the scatter target x + d* + md and the check column x + round(disp), as
// wta_lr.cu's mirror mode and _fused_aggregate_wta_pair's do. What bounds
// the route: the bytes above, 20 B per element (C read 4 times, S_dh
// written 3 times and read 3 times), and the sweeps' issue.

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
constexpr int TAIL = 32;           // rows whose WTA tails run at once

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


// The WTA of a pixel from its path sums S (VPL a lane): wta_lr.cu's body
// in two parts. wta_reduce runs the warp's reductions over the pixel's D
// sums: the packed key's minimum (d* and s0), the uniqueness test, and S
// at d* - 1 and d* + 1, where d* has both neighbours (else S at 0); each
// comes out warp-uniform, as (key, vm, vp), vm as ~vm where the test fails
// (S >= 0). wta_tail takes those of one pixel a lane: the IEEE subpixel
// step, rintf for quantize_16, the partner's column; it writes the
// disparity before the LR check (-1.0 where invalid) and, with lr,
// scatters the winner's packed key into the row's d2p. A warp keeps its
// column's (key, vm, vp) of 32 rows in shared memory (TAIL) and runs their
// tails at once, a lane a row, so the tail's float chain and stores leave
// the row-to-row chain. One exact rewrite: the quantize_16 division by 16
// is a multiplication by 0.0625.
template <int VPL>
__device__ __forceinline__ int3 wta_reduce(const int* S_in, int D, int d0,
                                           int uniq, int pk_bits) {
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
  bool valid = true;
  if (uniq > 0) {
    int mt = BIG;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int d = d0 + k;
      if (d < D && abs(d - dstar) > 1) mt = min(mt, tot[k]);
    }
    mt = __reduce_min_sync(FULL, mt);
    if (100LL * mt < (long long)(100 + uniq) * s0) valid = false;
  }
  const bool inner = dstar > 0 && dstar < D - 1;
  const int dm = inner ? dstar - 1 : 0, dp = inner ? dstar + 1 : 0;
  const int vm = __shfl_sync(FULL, pick<VPL>(tot, dm % VPL), dm / VPL);
  const int vp = __shfl_sync(FULL, pick<VPL>(tot, dp % VPL), dp / VPL);
  return make_int3(key, valid ? vm : ~vm, vp);
}

__device__ __forceinline__ void wta_tail(int key, int vme, int vp, int x,
                                         int y, int W, int D, int md,
                                         int quant16, int lr, int pk_bits,
                                         bool mirror, float* out, int* d2p) {
  const int dstar = key & ((1 << pk_bits) - 1);
  const int s0 = key >> pk_bits;
  bool valid = vme >= 0;
  float off = 0.0f;
  if (dstar > 0 && dstar < D - 1) {
    const float fs0 = (float)s0, fsm = (float)(valid ? vme : ~vme),
                fsp = (float)vp;
    const float denom =
        fmaxf(__fsub_rn(__fadd_rn(fsm, fsp), __fmul_rn(2.0f, fs0)), 1e-6f);
    off = __fdiv_rn(__fsub_rn(fsm, fsp), __fmul_rn(2.0f, denom));
    off = fminf(fmaxf(off, -0.5f), 0.5f);
  }
  float disp = __fadd_rn(__fadd_rn((float)dstar, off), (float)md);
  if (quant16) disp = __fmul_rn(rintf(__fmul_rn(disp, 16.0f)), 0.0625f);
  // the partner column (mirror: a right matcher's, at x + d)
  const int xr = mirror ? x + dstar + md : x - dstar - md;
  if (xr < 0 || xr > W - 1) valid = false;
  out[(size_t)y * W + x] = valid ? disp : -1.0f;
  if (lr && xr >= 0 && xr < W) atomicMin(&d2p[(size_t)y * W + xr], key + md);
}

// A pixel's (key, vm, vp) into slot j of its column's TAIL rows in sl
// ([3][TAIL] ints), by lanes 0-2.
__device__ __forceinline__ void keep_tail(int* sl, int j, int lane, int3 r) {
  if (lane < 3) sl[lane * TAIL + j] = lane == 0 ? r.x : lane == 1 ? r.y : r.z;
}

// The tails of slots 0 .. last of sl, lane j the pixel (y0 - j, x) (the up
// sweep's rows, a slot a row), where that row is below local.
__device__ __forceinline__ void run_tails(const int* sl, int last, int lane,
                                          int x, int y0, int local, int W,
                                          int D, int md, int quant16, int lr,
                                          int pk_bits, bool mirror,
                                          float* out, int* d2p) {
  __syncwarp();
  const int y = y0 - lane;
  if (lane <= last && y < local)
    wta_tail(sl[lane], sl[TAIL + lane], sl[2 * TAIL + lane], x, y, W, D, md,
             quant16, lr, pk_bits, mirror, out, d2p);
  __syncwarp();
}

// The sweeps' launch plans (the kernel's PLAN): the down sweep; the up
// sweep with the WTA inline on the path warps; with WTA warps of their own
// fed through a ring of row slots (RING).
constexpr int PLAN_DOWN = 0, PLAN_INLINE = 1, PLAN_RING = 2;
constexpr int RING = 2;   // the ring's row slots: the WTA up to a row behind
constexpr int SBUF = 3;   // S_dh rows the ring's WTA warps stage: 2 ahead

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// until the phase of this parity has completed
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Shared memory of a sweep block of sw columns: the staged C rows, the up
// sweep's staged S_dh rows (the ring: SBUF), the vertical L row and the
// diagonals' L rows (two parities each; the ring: RING slots each); the up
// sweep's WTA tails, TAIL rows of (key, vm, vp) a column; the ring's 2 *
// RING mbarriers, 8-byte aligned.
size_t sweep_smem(int D, int plan, int sw) {
  const size_t row = (size_t)D * sizeof(int16_t) * sw;
  const size_t tails = (size_t)sw * 3 * TAIL * sizeof(int);
  switch (plan) {
    case PLAN_DOWN: return row * (NBUF + 1 + 4);
    case PLAN_INLINE: return row * (2 * NBUF + 1 + 4) + tails;
    default:
      return row * (NBUF + SBUF + 3 * RING) + tails + 8 +
             2 * RING * sizeof(long long);
  }
}

// One sweep over n rows of a strip of sw columns per block, in each of nfr
// frames (grid: strips, frame slots; the block (s, g) takes frames g, g +
// gridDim.y, ...). Down: rows 0 .. n-1 of C (n = M), writing S_dh = L -
// bias to rows y - top >= 0 of S. Up: rows n-1 .. 0 of the body C and S_dh
// (n = R), the WTA of rows y < local into out and (lr) the winner scatter
// into d2p. A frame's C has n rows, its S n - top (down) or n (up), its out
// and d2p local rows; frames from mirror_from on are in mirror mode.
//
// NW path warps each take a column's three paths at a time (dir 0 from
// column x, 1 from x - 1, 2 from x + 1) on words of two disparities, 2 *
// NWD a lane; the warps after them are WTA warps. PLAN_INLINE: the path
// warps run wta_reduce on the sums in registers. PLAN_RING: the path warps
// only write the L rows, into slot q % RING of a ring (q counts the
// block's rows over its frames), meet at a barrier of their own (bar.sync
// 1) and hand each row on by an mbarrier (full); the WTA warps stage their
// own columns' S_dh rows, build S = S_dh + bias + L_up from the slot and
// hand it back (empty), so a path warp waits on the WTA only where it is
// RING rows behind. Either keeps each column's WTA tails in shared memory
// and runs them every TAIL rows.
//
// Strips exchange their edge columns' diagonal paths: edge: zeroed,
// (frames, strips, 4 slots, 2 sides, D / 2) 64-bit words of a word and its
// step tag (t + 1): side 0 the first column's dir-2 L, side 1 the last
// column's dir-1 L, step t's in slot t % 4. An edge column first computes
// and publishes the path its neighbour reads (from the strip's own row
// before), then its vertical path, and last the path that reads the
// neighbour's edge (loaded at the task's start), so the exchange's round
// trip overlaps the column's work. A strip that writes step q has seen its
// neighbour's step q - 2, so the neighbour has read the strip's steps up
// to q - 4: four slots never collide. Each frame has its own words, so a
// tag never meets a word of another frame.
template <int NWD, int PLAN>
__global__ void __launch_bounds__(768) tile_sweep_kernel(
    const int16_t* __restrict__ C, int16_t* __restrict__ S,
    float* __restrict__ out, int* __restrict__ d2p, unsigned long long* edge,
    int nfr, int n, int W, int D, int top, int local, int bias, int P1,
    int P2, int ndir, int strips, int sw, int md, int uniq, int quant16,
    int lr, int pk_bits, int mirror_from, int NW) {
  constexpr bool UP = PLAN != PLAN_DOWN, RG = PLAN == PLAN_RING;
  constexpr int VPL = 2 * NWD;                       // disparities a lane
  constexpr int SB = RG ? SBUF : UP ? NBUF : 0;      // staged S_dh rows
  constexpr int VS = RG ? RING : 1, LS = RG ? RING : 2;   // L row slots
  extern __shared__ __align__(16) unsigned char smem[];
  const int SD = sw * D;
  int16_t* cbuf = (int16_t*)smem;                    // [NBUF][sw][D]
  int16_t* sbuf = cbuf + NBUF * SD;                  // up: [SB][sw][D]
  int16_t* Lv = sbuf + SB * SD;                      // [VS][sw][D]
  int16_t* L1 = Lv + VS * SD;                        // [LS][sw][D]
  int16_t* L2 = L1 + LS * SD;                        // [LS][sw][D]
  // up: [sw][3][TAIL], the WTA tails of each column's rows
  int* tails = (int*)(L2 + LS * SD);
  // ring: full[RING], then empty[RING], 8-byte aligned
  const unsigned full = (smem_addr(tails + sw * 3 * TAIL) + 7) & ~7u,
                 empty = full + 8 * RING;
  const int s = blockIdx.x, x0 = s * sw;
  const int ncol = min(sw, W - x0);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  // the path warps, then (up) the WTA warps
  const int NWT = (nth >> 5) - NW;
  const int d0 = lane * VPL;
  const bool act = d0 < D;
  const int ED = D / 2;                              // words of an edge
  const size_t rowel = (size_t)W * D;
  const int nchunk = ncol * D / 8;   // 16-byte chunks of the strip's row
  const unsigned p1 = (unsigned)P1 * 0x10001u;
  // the threads that stage C rows and meet at each row's barrier
  const int npt = RG ? 32 * NW : nth;
  auto sync_rows = [&]() {
    if constexpr (RG)
      asm volatile("bar.sync 1, %0;" ::"r"(npt) : "memory");
    else
      __syncthreads();
  };

  if constexpr (RG) {
    if (tid == 0) {
      for (int k = 0; k < RING; ++k) {
        mbar_init(full + 8 * k, NW);
        mbar_init(empty + 8 * k, NWT);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (warp >= NW) {
      // the ring's WTA warps: warp w takes columns w, w + NWT, ... of each
      // row, its own columns' S_dh rows staged SBUF - 1 ahead
      const int w = warp - NW;
      for (int f = blockIdx.y, fi = 0; f < nfr; f += gridDim.y, ++fi) {
        const int16_t* Sf = S + (size_t)f * n * rowel + (size_t)x0 * D;
        const size_t of = (size_t)f * local * W;
        const bool mirror = f >= mirror_from;
        auto stage_s = [&](int u) {
          if (u < n) {
            const int16_t* g = Sf + (size_t)(n - 1 - u) * rowel;
            int16_t* sb = sbuf + (u % SBUF) * SD;
            for (int xl = w; xl < ncol; xl += NWT)
              for (int i = lane; i < D / 8; i += 32)
                cp_async16(sb + xl * D + 8 * i, g + xl * D + 8 * i);
          }
          cp_async_commit();
        };
#pragma unroll
        for (int u = 0; u < SBUF - 1; ++u) stage_s(u);
        for (int u = 0; u < n; ++u) {
          cp_async_wait<SBUF - 2>();
          __syncwarp();
          stage_s(u + SBUF - 1);
          const int q = fi * n + u, k = q % RING, y = n - 1 - u;
          mbar_wait(full + 8 * k, (q / RING) & 1);
          if (y < local)
            for (int xl = w; xl < ncol; xl += NWT) {
              int sv[VPL];   // S = S_dh + bias + L_up
              ld16<VPL>(sbuf + (u % SBUF) * SD + xl * D, d0, D, 0, sv);
              unsigned tw[NWD] = {};   // L_up, below 2^16 in each half
              if (act) {
                const int o = k * SD + xl * D + d0;
                ldw<NWD>(Lv + o, tw);
                if (ndir == 3) {
                  unsigned a[NWD], b[NWD];
                  ldw<NWD>(L1 + o, a);
                  ldw<NWD>(L2 + o, b);
#pragma unroll
                  for (int j = 0; j < NWD; ++j) tw[j] += a[j] + b[j];
                }
              }
#pragma unroll
              for (int j = 0; j < NWD; ++j) {
                sv[2 * j] += (int)(tw[j] & 0xffffu) + bias;
                sv[2 * j + 1] += (int)(tw[j] >> 16) + bias;
              }
              int* sl = tails + xl * 3 * TAIL;
              keep_tail(sl, u % TAIL, lane,
                        wta_reduce<VPL>(sv, D, d0, uniq, pk_bits));
              if (u % TAIL == TAIL - 1 || u == n - 1)
                run_tails(sl, u % TAIL, lane, x0 + xl, y + u % TAIL, local,
                          W, D, md, quant16, lr, pk_bits, mirror, out + of,
                          d2p + of);
            }
          // the slot's reads are done: hand it back
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + 8 * k);
        }
      }
      return;
    }
  }

  for (int f = blockIdx.y, fi = 0; f < nfr; f += gridDim.y, ++fi) {
    const int16_t* Cf = C + (size_t)f * n * rowel;
    int16_t* Sf = S + (size_t)f * (UP ? n : n - top) * rowel;
    const size_t of = (size_t)f * local * W;   // the frame's out and d2p
    unsigned long long* edgef = edge + (size_t)f * strips * 8 * ED;
    const bool mirror = f >= mirror_from;
    // the frame before is done with every buffer
    sync_rows();

    auto stage = [&](int t) {
      if (t < n) {
        const int y = UP ? n - 1 - t : t;
        const size_t g = (size_t)y * rowel + (size_t)x0 * D;
        int16_t* cb = cbuf + (t % NBUF) * SD;
        for (int i = tid; i < nchunk; i += npt)
          cp_async16(cb + 8 * i, Cf + g + 8 * i);
        if (UP && !RG) {
          int16_t* sb = sbuf + (t % NBUF) * SD;
          for (int i = tid; i < nchunk; i += nth)
            cp_async16(sb + 8 * i, Sf + g + 8 * i);
        }
      }
      cp_async_commit();
    };
#pragma unroll
    for (int t = 0; t < NBUF - 1; ++t) stage(t);

    for (int t = 0; t < n; ++t) {
      cp_async_wait<NBUF - 2>();
      sync_rows();
      stage(t + NBUF - 1);
      const int y = UP ? n - 1 - t : t;
      const int16_t* cb = cbuf + (t % NBUF) * SD;
      // the L rows' slots: this row's (par) and the row before's (prv)
      const int q = fi * n + t;
      const int par = RG ? q % RING : t & 1;
      const int prv = RG ? (q + RING - 1) % RING : par ^ 1;
      const int vs = RG ? par : 0, vp = RG ? prv : 0;
      const int slot = t % 4, pslot = (t + 3) % 4;
      const unsigned tag_in = (unsigned)t, tag_out = (unsigned)t + 1;
      const bool emit = UP ? y < local : y >= top;
      // ring: the WTA warps are done with the slot's row before
      if constexpr (RG) mbar_wait(empty + 8 * par, ((q / RING) & 1) ^ 1);
      for (int xl = warp; xl < ncol; xl += NW) {
        const int x = x0 + xl;
        unsigned cw[NWD], Lu[NWD], La[NWD], Lb[NWD];   // dirs 0, 1, 2
        // an edge column's neighbour words, loaded first and checked where
        // they are read
        const unsigned long long* ep =
            (xl == 0 ? edgef + ((size_t)((s - 1) * 4 + pslot) * 2 + 1) * ED
                     : edgef + ((size_t)((s + 1) * 4 + pslot) * 2) * ED) +
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
            ldw<NWD>(Lv + vp * SD + xl * D + d0, pw);
          } else if ((dir == 1 && xl == 0) || (dir == 2 && xl == ncol - 1)) {
            get_edge<NWD>(ep, ew, pw, tag_in);
          } else {
            ldw<NWD>((dir == 1 ? L1 + prv * SD + (xl - 1) * D
                               : L2 + prv * SD + (xl + 1) * D) + d0,
                     pw);
          }
          dp_step2<NWD>(pw, cw, p1, P2, lane, act, L);
        };
        // an edge column first runs the path its neighbour reads
        unsigned long long* mine =
            edgef + ((size_t)(s * 4 + slot) * 2) * ED + lane * NWD;
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
        if constexpr (PLAN != PLAN_INLINE) {
          // the rest touches no other lane: lanes beyond D skip it
          if (!act) continue;
          stw<NWD>(Lv + vs * SD + xl * D + d0, Lu);
          if constexpr (RG) {
            // the ring's WTA warps sum the L rows themselves
            if (ndir == 3) {
              stw<NWD>(L1 + par * SD + xl * D + d0, La);
              stw<NWD>(L2 + par * SD + xl * D + d0, Lb);
            }
            continue;
          }
          // the down sweep: S_dh = L_down - bias
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
#pragma unroll
          for (int k = 0; k < VPL; ++k) tot[k] -= bias;
          st16<VPL>(Sf + (size_t)(y - top) * rowel + (size_t)x * D, d0, D,
                    tot);
        } else {
          // the up sweep's WTA here, on every lane: lanes beyond D skip
          // only the stores
          unsigned tw[NWD] = {};   // the sum, below 2^16 in each half
          if (act) {
            stw<NWD>(Lv + xl * D + d0, Lu);
#pragma unroll
            for (int j = 0; j < NWD; ++j) tw[j] = Lu[j];
            if (ndir == 3) {
              stw<NWD>(L1 + par * SD + xl * D + d0, La);
              stw<NWD>(L2 + par * SD + xl * D + d0, Lb);
#pragma unroll
              for (int j = 0; j < NWD; ++j) tw[j] += La[j] + Lb[j];
            }
          }
          if (!emit) continue;
          int sv[VPL];   // S = S_dh + bias + L_up
          ld16<VPL>(sbuf + (t % NBUF) * SD + xl * D, d0, D, 0, sv);
#pragma unroll
          for (int j = 0; j < NWD; ++j) {
            sv[2 * j] += (int)(tw[j] & 0xffffu) + bias;
            sv[2 * j + 1] += (int)(tw[j] >> 16) + bias;
          }
          int* sl = tails + xl * 3 * TAIL;
          keep_tail(sl, t % TAIL, lane,
                    wta_reduce<VPL>(sv, D, d0, uniq, pk_bits));
          if (t % TAIL == TAIL - 1 || t == n - 1)
            run_tails(sl, t % TAIL, lane, x, y + t % TAIL, local, W, D, md,
                      quant16, lr, pk_bits, mirror, out + of, d2p + of);
        }
      }
      if constexpr (RG) {
        // the row's L is in its slot: hand it to the WTA warps
        __syncwarp();
        if (lane == 0) mbar_arrive(full + 8 * par);
      }
    }
  }
}

// The LR check of the local rows, after the up sweep: a pixel whose
// disparity is valid (>= 0: md >= 0) keeps it where the winner scattered to
// x - rint(disp) (x + rint(disp) in a mirrored frame) agrees within disp12.
// out and d2p hold n / W rows; rows from mrow on (the first mirrored
// frame's first row) are mirrored.
__global__ void tile_lr_kernel(float* __restrict__ out,
                               const int* __restrict__ d2p, int n, int W,
                               int mrow, int disp12, int pk_bits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float disp = out[i];
  if (disp < 0.0f) return;
  const int y = i / W, x = i - y * W;
  const int rd = __float2int_rn(disp);
  const int xr = y >= mrow ? x + rd : x - rd;
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

// The sweeps' strips: sw = ceil(W / multiprocessors) columns, at least 2.
cudaError_t strip_plan(int W, int* sms, int* sw, int* strips) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  *sw = max(2, (W + *sms - 1) / *sms);
  if (*sw > SWMAX) return cudaErrorInvalidValue;
  *strips = (W + *sw - 1) / *sw;
  return cudaSuccess;
}

// The sweeps' launch plan, one for the batch route and K9's slabs, from
// the frames at once, the strip width and the occupancy the card reports.
// Columns a path warp: two with 4 frames or more (the up sweep at D <=
// 128), else one. The up sweep's WTA (up_plan): through the ring where at
// most 10 columns share a multiprocessor (the frames at once times the
// strip width) or one frame is swept, else inline on the path warps.
// tools/agg_route_ab.py --plans times every choice at each side of these
// thresholds on the card (PERF.md).
int columns_a_warp(bool up, int nwd, int nfr) {
  return nfr >= 4 && (!up || nwd <= 2) ? 2 : 1;
}

int up_plan(int nfr, int sw) {
  return nfr == 1 || nfr * sw <= 10 ? PLAN_RING : PLAN_INLINE;
}

// A sweep's launch: its plan, path and WTA warps, threads, shared memory,
// blocks resident on a multiprocessor, frame slots and waves (0: it does
// not launch), and its strips (sw columns each).
struct SweepPlan {
  int plan, nw, nwt, threads, per_sm, slots, waves;
  size_t smem;
  int sw, strips;
};

struct Strips {
  int nfr, D, sw, strips, sms, max_smem;
};

template <int NWD, int PLAN>
cudaError_t fit(const Strips& g, int nw, int nwt, SweepPlan* p) {
  auto kern = tile_sweep_kernel<NWD, PLAN>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, g.max_smem);
  if (e != cudaSuccess) return e;
  *p = SweepPlan{PLAN, nw, nwt, 32 * (nw + nwt), 0, 0, 0,
                 sweep_smem(g.D, PLAN, g.sw), g.sw, g.strips};
  if (p->smem > (size_t)g.max_smem) return cudaSuccess;
  // as many frames at once as stay resident beside each other
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p->per_sm, kern,
                                                    p->threads, p->smem);
  if (e != cudaSuccess) return e;
  const int slots = min(g.nfr, p->per_sm * g.sms / g.strips);
  if (slots < 1) return cudaSuccess;
  // the frames in waves of equal size
  p->waves = (g.nfr + slots - 1) / slots;
  p->slots = (g.nfr + p->waves - 1) / p->waves;
  return cudaSuccess;
}

// The plan of a sweep over nfr frames W wide: the up sweep's from up_plan,
// or the one given (force: PLAN_INLINE or PLAN_RING, the ring then kept
// where it takes more waves).
template <int NWD>
cudaError_t plan_sweep(bool up, int force, int nfr, int W, int D,
                       SweepPlan* p) {
  Strips g{nfr, D, 0, 0, 0, 0};
  int dev = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&g.max_smem,
                         cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (!coop) return cudaErrorNotSupported;
  e = strip_plan(W, &g.sms, &g.sw, &g.strips);
  if (e != cudaSuccess) return e;
  // path warps of columns_a_warp columns each (16 columns at once at most)
  const int nc = min(g.sw, 16), cw = columns_a_warp(up, NWD, nfr);
  const int nw = (nc + cw - 1) / cw;
  if (!up) return fit<NWD, PLAN_DOWN>(g, nw, 0, p);
  const int plan = force ? force : up_plan(nfr, g.sw);
  e = fit<NWD, PLAN_INLINE>(g, nw, 0, p);
  if (e != cudaSuccess || plan == PLAN_INLINE) return e;
  // the ring: a WTA warp a column, fewer where more would put the frames
  // in more waves than the inline plan, which runs where even one would
  const int waves = p->waves;
  for (int nwt = min(nc, 24 - nw); nwt >= 1; --nwt) {   // 768 threads
    SweepPlan r{};
    e = fit<NWD, PLAN_RING>(g, nw, nwt, &r);
    if (e != cudaSuccess) return e;
    if ((r.waves > 0 && (waves == 0 || r.waves <= waves)) ||
        (force && nwt == 1)) {
      *p = r;
      break;
    }
  }
  return cudaSuccess;
}

template <int NWD, int PLAN>
cudaError_t launch_sweep(const SweepPlan& p, const int16_t* C, int16_t* S,
                         float* out, int* d2p, unsigned long long* edge,
                         int nfr, int n, int W, int D, int top, int local,
                         int bias, int P1, int P2, int ndir, int md,
                         int uniq, int quant16, int lr, int pk_bits,
                         int mirror_from, cudaStream_t stream) {
  int nw = p.nw, sw = p.sw, strips = p.strips;   // kernel arguments
  void* args[] = {(void*)&C, (void*)&S, (void*)&out, (void*)&d2p,
                  (void*)&edge, &nfr, &n, &W, &D, &top, &local, &bias, &P1,
                  &P2, &ndir, &strips, &sw, &md, &uniq, &quant16, &lr,
                  &pk_bits, &mirror_from, &nw};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (void*)tile_sweep_kernel<NWD, PLAN>, dim3(strips, p.slots),
      dim3(p.threads), args, p.smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// One sweep: down, or up with the WTA (the plan launched into *plan).
template <bool UP>
cudaError_t sweep_vpl(const int16_t* C, int16_t* S, float* out, int* d2p,
                      unsigned long long* edge, int nfr, int n, int W, int D,
                      int top, int local, int bias, int P1, int P2, int ndir,
                      int md, int uniq, int quant16, int lr, int pk_bits,
                      int mirror_from, int* plan, cudaStream_t s) {
  SweepPlan p{};
  // words of two disparities a lane: D <= 64 in 1, <= 128 in 2, else 4
  const cudaError_t e = D <= 64    ? plan_sweep<1>(UP, 0, nfr, W, D, &p)
                        : D <= 128 ? plan_sweep<2>(UP, 0, nfr, W, D, &p)
                                   : plan_sweep<4>(UP, 0, nfr, W, D, &p);
  if (e != cudaSuccess) return e;
  // no block fits a multiprocessor (shared memory past the card's), or
  // not one frame's strips fit the card at once
  if (p.waves == 0)
    return p.per_sm == 0 ? cudaErrorInvalidConfiguration
                         : cudaErrorCooperativeLaunchTooLarge;
  if (plan) *plan = p.plan;
#define SDR_SWEEP(NWD, PLAN)                                                \
  launch_sweep<NWD, PLAN>(p, C, S, out, d2p, edge, nfr, n, W, D, top,       \
                          local, bias, P1, P2, ndir, md, uniq, quant16, lr, \
                          pk_bits, mirror_from, s)
#define SDR_PLANS(NWD)                                                      \
  switch (p.plan) {                                                         \
    case PLAN_DOWN: return SDR_SWEEP(NWD, PLAN_DOWN);                       \
    case PLAN_INLINE: return SDR_SWEEP(NWD, PLAN_INLINE);                   \
    default: return SDR_SWEEP(NWD, PLAN_RING);                              \
  }
  if (D <= 64) SDR_PLANS(1)
  if (D <= 128) SDR_PLANS(2)
  SDR_PLANS(4)
#undef SDR_PLANS
#undef SDR_SWEEP
}

bool bad_args(int W, int D, int P1, int P2, int ndir) {
  return W < 1 || D < 16 || D > 256 || D % 16 || P1 < 0 || P1 > 32767 ||
         P2 < 0 || P2 > 32767 || (ndir != 1 && ndir != 3);
}

int pack_bits(int D, int md) {   // PK = 1 << bit_length(D + md)
  int b = 0;
  while ((1 << b) <= D + md) ++b;
  return b;
}

cudaError_t horiz(const int16_t* C, int16_t* S, int R, int W, int D, int P1,
                  int P2, cudaStream_t s) {
  const dim3 grid((R + HROWS - 1) / HROWS), block(HROWS * 64);
  const int smem = HROWS * 2 * HST * 2 * HCHB;   // a ring per warp
#define SDR_HORIZ(V)                                                         \
  case V: {                                                                  \
    const cudaError_t e = cudaFuncSetAttribute(                              \
        tile_horiz_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,   \
        smem);                                                               \
    if (e != cudaSuccess) return e;                                          \
    tile_horiz_kernel<V><<<grid, block, smem, s>>>(C, S, R, W, D, P1, P2);   \
    break;                                                                   \
  }
  switch ((D + 31) / 32) {
    SDR_HORIZ(1) SDR_HORIZ(2) SDR_HORIZ(3) SDR_HORIZ(4)
    SDR_HORIZ(5) SDR_HORIZ(6) SDR_HORIZ(7) SDR_HORIZ(8)
    default: return cudaErrorInvalidValue;
  }
#undef SDR_HORIZ
  return cudaGetLastError();
}

// The up sweep with the WTA over nfr frames of R body rows, the winner
// scatter set to "no winner" first.
cudaError_t up_wta(const int16_t* C, const int16_t* S, float* out, int* d2p,
                   int16_t* scratch, int nfr, int R, int W, int D, int local,
                   int bias, int P1, int P2, int ndir, int md, int uniq,
                   int quant16, int lr, int mirror_from, int* plan,
                   cudaStream_t s) {
  if (lr) {
    const cudaError_t e = cudaMemsetAsync(
        d2p, 0x7f, sizeof(int) * (size_t)nfr * local * W, s);
    if (e != cudaSuccess) return e;
  }
  return sweep_vpl<true>(C, (int16_t*)S, out, d2p,
                         (unsigned long long*)scratch, nfr, R, W, D, 0, local,
                         bias, P1, P2, ndir, md, uniq, quant16, lr,
                         pack_bits(D, md), mirror_from, plan, s);
}

cudaError_t lr_pass(float* out, const int* d2p, int nfr, int local, int W,
                    int D, int md, int disp12, int mirror_from,
                    cudaStream_t s) {
  const int n = nfr * local * W, threads = 256;
  tile_lr_kernel<<<(n + threads - 1) / threads, threads, 0, s>>>(
      out, d2p, n, W, mirror_from * local, disp12, pack_bits(D, md));
  return cudaGetLastError();
}

}  // namespace

// int16 entries of zeroed scratch that one sweep over B frames (B = 1: a
// tile's slab) needs: a frame's edge exchange each; -1 for bad arguments or
// where the device cannot be read.
extern "C" long long sdr_agg_scratch_size(int B, int W, int D) {
  int sms = 0, sw = 0, strips = 0;
  if (B < 1 || W < 1 || D < 1 || strip_plan(W, &sms, &sw, &strips))
    return -1;
  return (long long)B * strips * 8 * (D / 2) * 4;
}

// C: (B, H, W, D) int16 cost volume (a tile's slab: B = 1); S: (B, H -
// top, W, D) int16 out, S_dh = the down-going paths' sum (ndir 3: vertical
// and both diagonals; 1: vertical) over all H rows minus bias, on the rows
// below each frame's first top (a tile's top halo, warm-up only).
// scratch: sdr_agg_scratch_size(B, W, D) int16, zeroed. The caller keeps
// every S_dh value within int16.
extern "C" int sdr_agg_down(const int16_t* C, int16_t* S, int16_t* scratch,
                            int B, int H, int W, int D, int top, int bias,
                            int P1, int P2, int ndir, void* stream) {
  if (bad_args(W, D, P1, P2, ndir) || B < 1 || top < 0 || H <= top)
    return (int)cudaErrorInvalidValue;
  return (int)sweep_vpl<false>(C, S, nullptr, nullptr,
                               (unsigned long long*)scratch, B, H, W, D, top,
                               0, bias, P1, P2, ndir, 0, 0, 0, 0, 1, B,
                               nullptr, (cudaStream_t)stream);
}

// C, S: (R, W, D) int16 cost rows and S_dh; both horizontal paths added
// into S in place. A (B, H, W, D) batch is R = B * H rows.
extern "C" int sdr_agg_horiz(const int16_t* C, int16_t* S, int R, int W,
                             int D, int P1, int P2, void* stream) {
  if (bad_args(W, D, P1, P2, 1) || R < 1) return (int)cudaErrorInvalidValue;
  return (int)horiz(C, S, R, W, D, P1, P2, (cudaStream_t)stream);
}

// C, S: (B, H, W, D) int16 cost volume (a tile's body rows: B = 1) and
// S_dh; out: (B, local, W) float32, the disparity of each frame's first
// local rows before the LR check (-1.0 where invalid); d2p: (B, local, W)
// int32 winner scatter, written when lr (set to "no winner" here first).
// Frames b >= mirror_from in mirror mode. scratch as sdr_agg_down's.
// md >= 0. *plan: the launch plan that ran (PLAN_INLINE or PLAN_RING).
extern "C" int sdr_agg_up_wta(const int16_t* C, const int16_t* S, float* out,
                              int* d2p, int16_t* scratch, int B, int H,
                              int W, int D, int local, int bias, int P1,
                              int P2, int ndir, int md, int uniq,
                              int quant16, int lr, int mirror_from,
                              int* plan, void* stream) {
  if (bad_args(W, D, P1, P2, ndir) || B < 1 || local < 1 || local > H ||
      md < 0 || mirror_from < 0 || mirror_from > B)
    return (int)cudaErrorInvalidValue;
  return (int)up_wta(C, S, out, d2p, scratch, B, H, W, D, local, bias, P1,
                     P2, ndir, md, uniq, quant16, lr, mirror_from, plan,
                     (cudaStream_t)stream);
}

// The launch plan of a sweep over B frames W x D (up: the up sweep with
// the WTA; plan 0 the one its launch takes, else PLAN_INLINE or
// PLAN_RING), launching nothing: info[0..7] = plan, path warps, WTA
// warps, threads, shared memory bytes, blocks resident a multiprocessor,
// frame slots, waves (0: it cannot launch).
extern "C" int sdr_sweep_plan(int up, int plan, int B, int W, int D,
                              int* info) {
  if (bad_args(W, D, 0, 0, 1) || B < 1 || plan < 0 || plan > PLAN_RING ||
      (plan && !up))
    return (int)cudaErrorInvalidValue;
  SweepPlan p{};
  const cudaError_t e =
      D <= 64    ? plan_sweep<1>(up, plan, B, W, D, &p)
      : D <= 128 ? plan_sweep<2>(up, plan, B, W, D, &p)
                 : plan_sweep<4>(up, plan, B, W, D, &p);
  const int v[8] = {p.plan,   p.nw,    p.nwt,   p.threads,
                    (int)p.smem, p.per_sm, p.slots, p.waves};
  for (int i = 0; i < 8; ++i) info[i] = v[i];
  return (int)e;
}

// out, d2p: sdr_agg_up_wta's (B, local, W) outputs, H = local; the LR
// check in place.
extern "C" int sdr_agg_lr(float* out, const int* d2p, int B, int H, int W,
                          int D, int md, int disp12, int mirror_from,
                          void* stream) {
  if (B < 1 || H < 1 || W < 1 || md < 0 || disp12 < 0 || mirror_from < 0 ||
      mirror_from > B)
    return (int)cudaErrorInvalidValue;
  return (int)lr_pass(out, d2p, B, H, W, D, md, disp12, mirror_from,
                      (cudaStream_t)stream);
}
