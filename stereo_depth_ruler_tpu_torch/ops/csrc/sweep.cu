// The sweep kernel: rounds of segmented row and column sweeps over linked
// runs, in two modes.
//
// Replaces two TPU kernels that iterate the same rounds:
// - labels mode: stereo_depth_ruler_tpu/ops/sgbm_pallas.py:
//   _speckle_labels_kernel (launched by _speckle_labels_batched) with its
//   round cap max_iters. Two pixels link when both are valid (disp >= 0)
//   and |d - d'| <= max_diff; the value starts as the flat index (H*W for
//   an invalid pixel) and a run takes its min;
// - propagate mode: sgbm_pallas.py:_propagate_keep_kernel (launched by
//   _propagate_keep_batched). Two pixels link when their labels are equal
//   and not the sentinel H*W; the value starts as the seed and a run takes
//   its max.
// A round sweeps rows forward, rows backward, columns forward, columns
// backward, and a capped result depends on that order. A forward sweep
// gives each element the min (max) of its run up to it, the backward sweep
// then the min of the whole run, so a round is "each row run takes its
// reduction, then each column run takes its own". min and max are
// associative and commutative, so any split of a run into pieces gives the
// run's exact reduction, and the kernel splits runs freely.
//
// What bounds it on the H100: the function reads 4 B/px (disp) and writes
// 4 B/px (labels), or reads 8 and writes 4 (propagate); a round can do no
// better than read and write each value once per pass. The TPU builds each
// sweep from log-doubling rolls; the first port re-read both link inputs
// in each of a round's four sweeps (~32 B/px a round) and walked each
// column with one thread, H dependent steps of device-memory latency. Here:
//   - sweep_init computes the links once: a byte per pixel (bit LEFT:
//     linked to x - 1, bit UP: linked to y - 1), with the start values, so
//     a pass reads 4 + 1 B and writes 4 B per pixel (18 B/px a round);
//   - sweep_rows: a warp per row, staged in shared memory with coalesced
//     loads; each lane reduces a contiguous span of S (odd, so the lanes'
//     spans sit in distinct banks) serially, a segmented warp scan combines
//     the spans' carries forward, a second one backward, and a backward
//     walk writes each run's reduction; coalesced stores;
//   - sweep_cols: a block owns TW adjacent columns of one frame, whole, in
//     shared memory (TW = 32 where H * 32 columns fit in half an SM's
//     shared memory, so two blocks fit: H <= 668; else 16, 8, ...: 16 at
//     720 and 8 at 1440 rows). Its threads cut each column into 32 chunks
//     of rows: each walks its chunk down, reading the value and the link
//     from device memory once (threads of one chunk read neighbouring
//     columns: coalesced), a warp per column scans the chunks' carries
//     with shuffles, and each thread walks its chunk up and writes the
//     run reductions once.
// A frame changed in a pass iff some linked pair of neighbours differed
// (only then is a run not constant), which each walk tests as it reads.
// Every frame has a flag per round: set when the round changed a value. A
// frame whose last round changed nothing is a fixed point and skips the
// later rounds. Flags live in three rotating (B) buffers: round r reads
// r % 3, sets (r + 1) % 3 and its row pass clears (r + 2) % 3 for the next
// round, so a round is two launches and no memset. With max_iters > 0 the
// host launches exactly that many rounds and never waits; with max_iters
// == 0 it reads the flags after each round and stops when no frame changed
// (convergence).

#include <cuda_runtime.h>
#include <stdint.h>

#include <vector>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_SIDE = 32768;   // the largest H and W
constexpr int SMEM_MAX = 232448;  // shared memory one block may use
constexpr int NCH = 32;           // row chunks per column in sweep_cols
constexpr int ROW_SMEM = 48 * 1024;  // sweep_rows' shared memory per block
constexpr uint8_t LEFT = 1, UP = 2;  // the link bits

struct Min {
  static __device__ __forceinline__ int op(int a, int b) { return min(a, b); }
};
struct Max {
  static __device__ __forceinline__ int op(int a, int b) { return max(a, b); }
};

// The two modes: what links two pixels and the start value.
struct Labels {
  using Op = Min;
  const float* disp;
  float max_diff;
  int n;
  __device__ __forceinline__ bool link(size_t i, size_t j) const {
    // pixel i links to its neighbour j
    const float d = disp[i], e = disp[j];
    return d >= 0.0f && e >= 0.0f && fabsf(__fsub_rn(d, e)) <= max_diff;
  }
  __device__ __forceinline__ int init(size_t i, int k) const {
    return disp[i] >= 0.0f ? k : n;
  }
};

struct Propagate {
  using Op = Max;
  const int* labels;
  const int* seed;
  int n;
  __device__ __forceinline__ bool link(size_t i, size_t j) const {
    const int l = labels[i];
    return l != n && l == labels[j];
  }
  __device__ __forceinline__ int init(size_t i, int) const { return seed[i]; }
};

// Start values and link bytes; every frame takes part in the first round
// (flags[0][b] = 1) and nothing has changed in it yet (flags[1][b] = 0).
template <class M>
__global__ void sweep_init(M m, int* __restrict__ val,
                           uint8_t* __restrict__ link, int* __restrict__ flags,
                           int B, int W) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;  // index in the frame
  const int b = blockIdx.y;
  if (k == 0) {
    flags[b] = 1;
    flags[B + b] = 0;
  }
  if (k >= m.n) return;
  const size_t i = (size_t)b * m.n + k;
  uint8_t l = 0;
  if (k % W > 0 && m.link(i, i - 1)) l |= LEFT;
  if (k >= W && m.link(i, i - W)) l |= UP;
  val[i] = m.init(i, k);
  link[i] = l;
}

// The carries of a warp's 32 pieces of a line, piece i = lane i in order:
// tv, the reduction of the piece's last segment; hd_raw, the reduction of
// its first segment without what comes from the left; full, the piece is
// one segment; la, it links to the piece before; lb, the piece after links
// to it. Returns the left carry cin (valid where la) and the right carry
// cout (valid where lb): the reduction of the run ending at the piece's
// first element, and the whole run's reduction at the next piece's first.
template <class Op>
__device__ __forceinline__ void scan_pieces(int lane, int tv, int hd_raw,
                                            bool full, bool la, bool lb,
                                            int* cin, int* cout) {
  int P = tv;
  bool c = full && la;
  for (int o = 1; o < 32; o <<= 1) {
    const int pv = __shfl_up_sync(FULL, P, o);
    const bool pc = __shfl_up_sync(FULL, c, o);
    if (lane >= o && c) P = Op::op(P, pv);
    c = c && lane >= o && pc;
  }
  *cin = __shfl_up_sync(FULL, P, 1);
  // the first segment's whole reduction, unless it runs on to the right
  int R = la ? Op::op(*cin, hd_raw) : hd_raw;
  c = full && lb;
  for (int o = 1; o < 32; o <<= 1) {
    const int nv = __shfl_down_sync(FULL, R, o);
    const bool nc = __shfl_down_sync(FULL, c, o);
    if (lane + o < 32 && c) R = nv;
    c = c && lane + o < 32 && nc;
  }
  *cout = __shfl_down_sync(FULL, R, 1);
}

// One warp per row: the row and its link bytes go to shared memory, lane
// i walks the span [i S, i S + S) forward (the segmented prefix without
// carries, in place), the warp scans the carries, the lane walks back
// writing each run's reduction, and the row goes back out.
template <class Op>
__global__ void sweep_rows(int* __restrict__ val,
                           const uint8_t* __restrict__ link,
                           const int* __restrict__ in_flag,
                           int* __restrict__ out_flag,
                           int* __restrict__ clear_flag, int H, int W,
                           int S) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int b = blockIdx.y;
  if (blockIdx.x == 0 && threadIdx.x == 0) clear_flag[b] = 0;
  const int y = blockIdx.x * nw + warp;
  if (y >= H || !in_flag[b]) return;  // the same for the whole warp
  const size_t row = ((size_t)b * H + y) * W;
  int* sv = smem + warp * 32 * S;
  uint8_t* sl = (uint8_t*)(smem + nw * 32 * S) + warp * 32 * S;
  for (int x = lane; x < W; x += 32) {
    sv[x] = val[row + x];
    sl[x] = link[row + x];
  }
  __syncwarp();
  const int a = min(lane * S, W), e = min(a + S, W);
  const bool has = a < e;
  const bool la = has && (sl[a] & LEFT);
  const bool lb = has && e < W && (sl[e] & LEFT);
  int f = has ? sv[a] : 0;
  const int vlast = has ? sv[e - 1] : 0;
  const int vprev = __shfl_up_sync(FULL, vlast, 1);  // original sv[a - 1]
  bool changed = la && f != vprev;
  bool full = true;
  int hb = e;  // end of the first segment
  int vp = f;
  for (int x = a + 1; x < e; ++x) {
    const int v = sv[x];
    if (sl[x] & LEFT) {
      changed |= v != vp;
      f = Op::op(f, v);
    } else {
      f = v;
      if (full) hb = x;
      full = false;
    }
    sv[x] = f;
    vp = v;
  }
  int cin, cout;
  scan_pieces<Op>(lane, f, has ? sv[hb - 1] : 0, has && full, la, lb, &cin,
                  &cout);
  if (has) {
    int o = lb ? cout : (la && e == hb) ? Op::op(cin, sv[e - 1]) : sv[e - 1];
    sv[e - 1] = o;
    for (int x = e - 2; x >= a; --x) {
      if (!(sl[x + 1] & LEFT)) o = (la && x < hb) ? Op::op(cin, sv[x]) : sv[x];
      sv[x] = o;
    }
  }
  __syncwarp();
  for (int x = lane; x < W; x += 32) val[row + x] = sv[x];
  if (__any_sync(FULL, changed) && lane == 0) out_flag[b] = 1;
}

// A block per TW columns of a frame, 32 * TW threads: thread (c, q) =
// (tid % TW, tid / TW) owns rows [q CS, q CS + CS) of column c. The walk
// down reads the values and links from device memory and keeps the
// segmented prefix (column-major, odd pitch Hp) and the links (row-major)
// in shared memory; warp w scans column w's 32 chunks; the walk up writes
// each run's reduction to device memory.
template <class Op>
__global__ void sweep_cols(int* __restrict__ val,
                           const uint8_t* __restrict__ link,
                           const int* __restrict__ in_flag,
                           int* __restrict__ out_flag, int H, int W, int TW,
                           int CS) {
  extern __shared__ int smem[];
  const int b = blockIdx.y;
  if (!in_flag[b]) return;  // the same for the whole block
  const int t = threadIdx.x, c = t % TW, q = t / TW;
  const int Hp = H | 1;
  int* col = smem + c * Hp;                    // [TW][Hp] prefixes
  int* s_tv = smem + TW * Hp;                  // [NCH][TW]: tv, then cin
  int* s_hd = s_tv + NCH * TW;                 // [NCH][TW]: hd_raw, then cout
  uint8_t* s_fl = (uint8_t*)(s_hd + NCH * TW);  // [NCH][TW]: la | full << 1
  uint8_t* sl = s_fl + NCH * TW;               // [H][TW] links
  const int x = blockIdx.x * TW + c;
  const int a = min(q * CS, H), e = min(a + CS, H);
  const bool has = x < W && a < e;
  const size_t base = (size_t)b * H * W + x;
  bool changed = false, full = true, la = false;
  int hb = e, f = 0;
  if (has) {
    const uint8_t l0 = link[base + (size_t)a * W];
    la = l0 & UP;  // never set on row 0
    f = val[base + (size_t)a * W];
    if (la) changed = f != val[base + (size_t)(a - 1) * W];
    sl[a * TW + c] = l0;
    col[a] = f;
    int vp = f;
#pragma unroll 4
    for (int y = a + 1; y < e; ++y) {
      const size_t i = base + (size_t)y * W;
      const int v = val[i];
      const uint8_t l = link[i];
      sl[y * TW + c] = l;
      if (l & UP) {
        changed |= v != vp;
        f = Op::op(f, v);
      } else {
        f = v;
        if (full) hb = y;
        full = false;
      }
      col[y] = f;
      vp = v;
    }
  }
  s_tv[q * TW + c] = f;
  s_hd[q * TW + c] = has ? col[hb - 1] : 0;
  s_fl[q * TW + c] = (uint8_t)((has && la) | ((has && full) << 1));
  __syncthreads();
  {
    const int w = t >> 5, lane = t & 31;  // w < TW: column w, chunk lane
    const int k = lane * TW + w;
    const uint8_t fl = s_fl[k];
    const bool lb = __shfl_down_sync(FULL, fl & 1, 1) && lane < 31;
    int cin, cout;
    scan_pieces<Op>(lane, s_tv[k], s_hd[k], fl & 2, fl & 1, lb, &cin,
                    &cout);
    s_tv[k] = cin;
    s_hd[k] = cout;
  }
  __syncthreads();
  if (has) {
    const int cin = s_tv[q * TW + c], cout = s_hd[q * TW + c];
    const bool lb = e < H && (sl[e * TW + c] & UP);
    int o = lb ? cout : (la && e == hb) ? Op::op(cin, col[e - 1]) : col[e - 1];
    val[base + (size_t)(e - 1) * W] = o;
    for (int y = e - 2; y >= a; --y) {
      if (!(sl[(y + 1) * TW + c] & UP))
        o = (la && y < hb) ? Op::op(cin, col[y]) : col[y];
      val[base + (size_t)y * W] = o;
    }
  }
  if (__syncthreads_or(changed) && t == 0) out_flag[b] = 1;
}

size_t cols_smem(int H, int TW) {
  return (size_t)TW * ((H | 1) * 4 + NCH * 9 + H);
}

template <class M>
int run_rounds(M m, int* val, uint8_t* link, int* flags, int B, int H, int W,
               int max_iters, cudaStream_t s) {
  using Op = typename M::Op;
  // rows: spans of S (odd) per lane, as many warps per block as fit in
  // ROW_SMEM (at least one)
  const int S = ((W + 31) / 32) | 1;
  const int row_bytes = 32 * S * 5;
  const int nw = max(1, min(8, ROW_SMEM / row_bytes));
  const size_t smem_r = (size_t)nw * row_bytes;
  // columns: the widest tile of at most 32 columns (and not much wider
  // than the image) that fits twice in an SM, else once
  int TW = 32;
  while (TW > 1 && (TW / 2 >= W || cols_smem(H, TW) > SMEM_MAX / 2)) TW /= 2;
  const size_t smem_c = cols_smem(H, TW);
  const int CS = (H + NCH - 1) / NCH;
  cudaError_t e = cudaSuccess;
  if (smem_r > 48 * 1024)
    e = cudaFuncSetAttribute(sweep_rows<Op>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_r);
  if (e == cudaSuccess && smem_c > 48 * 1024)
    e = cudaFuncSetAttribute(sweep_cols<Op>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_c);
  if (e != cudaSuccess) return (int)e;
  sweep_init<<<dim3((m.n + 255) / 256, B), 256, 0, s>>>(m, val, link, flags,
                                                        B, W);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  std::vector<int> host(B);
  for (int r = 0; max_iters == 0 || r < max_iters; ++r) {
    int* in_flag = flags + (r % 3) * B;
    int* out_flag = flags + ((r + 1) % 3) * B;
    int* clear_flag = flags + ((r + 2) % 3) * B;
    sweep_rows<Op><<<dim3((H + nw - 1) / nw, B), 32 * nw, smem_r, s>>>(
        val, link, in_flag, out_flag, clear_flag, H, W, S);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    sweep_cols<Op><<<dim3((W + TW - 1) / TW, B), 32 * TW, smem_c, s>>>(
        val, link, in_flag, out_flag, H, W, TW, CS);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (max_iters == 0) {
      e = cudaMemcpyAsync(host.data(), out_flag, sizeof(int) * B,
                          cudaMemcpyDeviceToHost, s);
      if (e == cudaSuccess) e = cudaStreamSynchronize(s);
      if (e != cudaSuccess) return (int)e;
      bool any = false;
      for (int fl : host) any |= fl != 0;
      if (!any) break;
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Labels mode (seed null): a = (B, H, W) float32 disparity, invalid < 0.
// Propagate mode: a = (B, H, W) int32 labels, seed = (B, H, W) int32.
// out: (B, H, W) int32; link: (B, H, W) uint8 scratch; flags: 3 B int32
// scratch. H, W <= 32768. max_iters 0 runs to convergence (and waits on the
// stream once per round), > 0 caps the rounds.
extern "C" int sdr_sweep(const void* a, const int* seed, int* out,
                         uint8_t* link, int* flags, int B, int H, int W,
                         float max_diff, int max_iters, void* stream) {
  if (B < 1 || H < 1 || W < 1 || B > 65535 || max_iters < 0 ||
      H > MAX_SIDE || W > MAX_SIDE)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n = H * W;
  if (seed == nullptr)
    return run_rounds(Labels{(const float*)a, max_diff, n}, out, link, flags,
                      B, H, W, max_iters, s);
  return run_rounds(Propagate{(const int*)a, seed, n}, out, link, flags, B, H,
                    W, max_iters, s);
}
