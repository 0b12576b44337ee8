// The sorted-run kernel: scans over each frame's sorted int32 keys, in three
// modes.
//
// Replaces three TPU kernels of stereo_depth_ruler_tpu/ops/sort_tpu.py:
// - sizes: _sizes_scan_kernel (launched by _counts_batched), the length of
//   the run of equal keys at each sorted position;
// - keep: _keep_scan_kernel (launched by _speckle_keep_batched), run length
//   > max_size;
// - roots: _large_roots_kernel (launched by large_run_roots), per row of L
//   sorted positions the values of the runs that start there and are longer
//   than max_size, descending, then -1.
// The TPU finds run bounds with log-depth doubling scans of rolls and then
// unpermutes with a second bitonic sort of (source index, result). Here the
// size, or the keep byte, goes straight to its source index (out[sidx[i]],
// targets outside [0, n_out) dropped): the store is the unpermute.
//
// Sizes and keep (runs_sizes), a tiled run scan with constant work per
// position. A block owns a tile of TILE sorted positions, a warp PASSES x 32
// consecutive ones, and in pass j lane l holds position base + 32 j + l, so
// every load, and the stores of a run, are warp-contiguous. A run head is a
// position whose key differs from the one before (position 0 and every
// position past the frame are heads); one ballot per pass marks them, and
// lane j keeps pass j's ballot (a warp-uniform value held once, not in every
// lane's registers). A position's run starts at the last head at or before
// it and ends at the first head after it: inside a pass from the ballot,
// across passes from a max-scan and a min-scan of the lanes' head positions,
// across warps from one shared-memory word per warp. Only the tile's first
// and last run can cross its edges, and only they need a global start or
// end: warp 0 searches for the start of the run that holds the tile's first
// position and the last warp for the end of the run that holds its last
// position, each once per tile and outward from the edge (run_first,
// run_end), so a short crossing run costs one round of loads and the 127 K
// INF pads of a packed 720p frame five. One launch and no per-tile summary
// pass: the searches' few dependent loads overlap the tile's own loads (at
// 32 registers eight blocks share an SM), where a summary pass would read
// the keys twice. 8 passes (a tile of 2048) ran faster on the H100 than 16
// or 32 (tools/sorted_runs_probe.py --passes).
//
// Roots (runs_roots): a warp per row of L positions, walked from the row's
// end back to its start in windows of WINDOW positions. Each window's keys
// and the max_size keys past it are staged once into the warp's shared
// memory by cp.async (16-byte copies where the window is aligned); every key
// of the row is read from device memory once (a max_size above AHEAD reads
// its one key ahead from device memory, at run starts only). A lane takes 4
// positions a step from one 16-byte shared-memory read. A position is a
// large start when its key differs from the previous one (position 0
// against 2^30 - 1, as the TPU scan reads it) and the key max_size places on
// is the same (past the frame: no match); a step with none costs one vote.
// Walking backwards, the j-th large start met is the row's j-th largest
// value, so it goes to slot j without a counting pass; -1 fills the slots
// left.
//
// What bounds it on the H100: device-memory bytes, 12 B per position for
// sizes (keys and source indices in, an int out) and 9 B for keep; 4 B per
// position for roots.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PASSES = 8;                    // passes of 32 positions a warp
constexpr int TILE = THREADS * PASSES;       // sorted positions a block
constexpr int WINDOW = 1024;                 // positions a roots warp stages
constexpr int AHEAD = 256;                   // largest staged max_size
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NONE = 0xffffffffu;       // no head in a warp
constexpr int INF = 1 << 30;                 // the pad value of the packed blocks

enum Mode { SIZES = 0, KEEP = 1, ROOTS = 2 };

// Warp-wide searches over sorted keys, where the positions that hold one key
// form one range. first_in: the first position in (lo, hi] whose key is
// `key` (equal) or is not (!equal), given that hi qualifies and the
// qualifying positions are a suffix of the range. Each step reads 32 keys
// evenly spread over the bracket, one per lane, and cuts it 32-fold.
__device__ long long first_in(const int* k, long long lo, long long hi,
                              int key, bool equal, int lane) {
  while (hi - lo > 1) {
    const long long step = (hi - lo + 31) / 32;
    const long long q = min(lo + (lane + 1) * step, hi);  // lane 31: hi
    const unsigned bal = __ballot_sync(FULL, (k[q] == key) == equal);
    const int f = __ffs(bal) - 1;
    const long long nlo = f > 0 ? __shfl_sync(FULL, q, f - 1) : lo;
    hi = __shfl_sync(FULL, q, f);
    lo = nlo;
  }
  return hi;
}

// The first position of the run that holds position i > 0. Lane l reads the
// key 2^l positions back (clamped to 0) and lane 31 position 0, which
// brackets the run's start within a factor of two; first_in closes the
// bracket.
__device__ unsigned run_first(const int* k, unsigned i, int lane) {
  const int key = k[i];
  const long long q =
      lane == 31 ? 0 : max((long long)i - (1ll << lane), 0ll);
  const unsigned bal = __ballot_sync(FULL, k[q] != key);
  if (!(bal >> 31)) return 0;  // the run reaches the frame's start
  const int l = __ffs(bal) - 1;
  const long long hi = l == 0 ? (long long)i : __shfl_sync(FULL, q, l - 1);
  return (unsigned)first_in(k, __shfl_sync(FULL, q, l), hi, key, true, lane);
}

// One past the last position of the run that holds position i < n - 1 (n if
// it reaches the frame's end), the mirror image of run_first.
__device__ unsigned run_end(const int* k, unsigned i, unsigned n, int lane) {
  const int key = k[i];
  const long long q = lane == 31 ? (long long)n - 1
                                 : min((long long)i + (1ll << lane),
                                       (long long)n - 1);
  const unsigned bal = __ballot_sync(FULL, k[q] != key);
  if (!(bal >> 31)) return n;
  const int l = __ffs(bal) - 1;
  const long long lo = l == 0 ? (long long)i : __shfl_sync(FULL, q, l - 1);
  return (unsigned)first_in(k, lo, __shfl_sync(FULL, q, l), key, false,
                            lane);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
    runs_sizes(const int* __restrict__ skey, const int* __restrict__ sidx,
               void* __restrict__ out, int N, int n_out, int max_size) {
  __shared__ unsigned first_head[WARPS];  // NONE if the warp has no head
  __shared__ unsigned last_head[WARPS];   // the position + 1, 0 for none
  __shared__ unsigned edge[2];  // start of the tile's first run, end of its last
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const size_t b = blockIdx.y;
  const unsigned n = N;
  const int* k = skey + b * N;
  const int* src = sidx ? sidx + b * N : nullptr;
  const unsigned t0 = blockIdx.x * TILE;
  const unsigned base = t0 + w * 32 * PASSES;
  int key[PASSES];
#pragma unroll
  for (int j = 0; j < PASSES; ++j) {
    const unsigned p = base + 32 * j + lane;
    key[j] = p < n ? k[p] : 0;
  }
  const int before = lane == 0 && base > 0 && base <= n ? k[base - 1] : 0;
  // the tile's edges, searched outward while its loads are in flight
  if (w == 0) {
    const unsigned s = t0 == 0 ? 0 : run_first(k, t0, lane);
    if (lane == 0) edge[0] = s;
  }
  if (w == WARPS - 1) {
    const unsigned e = (unsigned long long)t0 + TILE >= n
                           ? n
                           : run_end(k, t0 + TILE - 1, n, lane);
    if (lane == 0) edge[1] = e;
  }
  // pass j's head ballot goes to lane j (a warp-uniform value kept once)
  unsigned mine = 0;
#pragma unroll
  for (int j = 0; j < PASSES; ++j) {
    const unsigned p = base + 32 * j + lane;
    int prev = __shfl_up_sync(FULL, key[j], 1);
    const int carry = j == 0 ? before : __shfl_sync(FULL, key[j - 1], 31);
    if (lane == 0) prev = carry;
    const unsigned bal =
        __ballot_sync(FULL, p >= n || p == 0 || key[j] != prev);
    if (lane == j) mine = bal;
  }
  int dst[PASSES];
#pragma unroll
  for (int j = 0; j < PASSES; ++j) {
    const unsigned p = base + 32 * j + lane;
    dst[j] = p >= n ? -1 : src ? src[p] : (int)p;
  }
  // lane j: the last head of passes <= j (+ 1, 0 for none) and the first
  // head of passes >= j (NONE for none), by warp scans over the lanes
  const unsigned p0 = base + 32 * lane;
  unsigned last = mine ? p0 + 32 - __clz(mine) : 0;
  unsigned first = mine ? p0 + __ffs(mine) - 1 : NONE;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned l = __shfl_up_sync(FULL, last, d);
    const unsigned f = __shfl_down_sync(FULL, first, d);
    if (lane >= d) last = max(last, l);
    if (lane + d < 32) first = min(first, f);
  }
  if (lane == 31) last_head[w] = last;
  if (lane == 0) first_head[w] = first;
  __syncthreads();
  // the last head before the warp, and the first head after it
  unsigned start = edge[0], end = edge[1];
  for (int v = 0; v < w; ++v)
    if (last_head[v]) start = last_head[v] - 1;
  for (int v = WARPS - 1; v > w; --v)
    if (first_head[v] != NONE) end = first_head[v];
  const unsigned upto = (2u << lane) - 1u;  // lanes 0..lane
#pragma unroll
  for (int j = 0; j < PASSES; ++j) {
    const unsigned pj = base + 32 * j;
    const unsigned bal = __shfl_sync(FULL, mine, j);
    const unsigned lb = j > 0 ? __shfl_sync(FULL, last, j - 1) : 0;
    const unsigned fa = j + 1 < 32 ? __shfl_sync(FULL, first, j + 1) : NONE;
    const unsigned at = bal & upto, after = bal & ~upto;
    const unsigned first_pos =
        at ? pj + 31 - __clz(at) : lb ? lb - 1 : start;
    const unsigned end_pos =
        after ? pj + __ffs(after) - 1 : fa != NONE ? fa : end;
    if (dst[j] < 0 || dst[j] >= n_out) continue;  // also past the frame
    const unsigned size = end_pos - first_pos;
    if (MODE == SIZES)
      ((int*)out)[b * n_out + dst[j]] = (int)size;
    else
      ((uint8_t*)out)[b * n_out + dst[j]] = size > (unsigned)max_size;
  }
}

__device__ __forceinline__ void cp_async4(int* smem, const int* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async16(int* smem, const int* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__global__ void __launch_bounds__(THREADS)
    runs_roots(const int* __restrict__ skey, int* __restrict__ out, int N,
               int L, int max_size, int slots) {
  // a warp's stage: s[4 + x] holds position ws + x of its window (16-byte
  // aligned groups of 4), s[3] the key before the window
  __shared__ __align__(16) int stage[WARPS][4 + WINDOW + AHEAD];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int rows = N / L;
  const int r = blockIdx.x * WARPS + w;
  if (r >= rows) return;  // the same for the whole warp; no block barrier
  const size_t b = blockIdx.y;
  const int* k = skey + b * N;
  int* o = out + (b * rows + r) * (size_t)slots;
  int* s = stage[w];
  const bool staged = max_size <= AHEAD;  // the key max_size ahead
  const int row0 = r * L, reach = N - max_size;  // f + max_size < N
  int seen = 0;  // large starts met so far, from the row's end
  for (int we = row0 + L; we > row0; we -= WINDOW) {
    const int ws = max(we - WINDOW, row0);
    const int len = we - ws;
    const int cnt =
        staged ? (int)min((long long)len + max_size, (long long)N - ws) : len;
    if (lane == 0) s[3] = ws > 0 ? k[ws - 1] : INF - 1;  // TPU: 2^30 - 1
    const int* g = k + ws;
    int x = 0;
    if (((uintptr_t)g & 15) == 0)
      for (x = 4 * lane; x + 4 <= cnt; x += 128) cp_async16(s + 4 + x, g + x);
    for (x = (((uintptr_t)g & 15) == 0 ? cnt & ~3 : 0) + lane; x < cnt;
         x += 32)
      cp_async4(s + 4 + x, g + x);
    cp_async_wait_all();
    __syncwarp();
    // chunks of 128 positions, 4 a lane, from the window's end back
    for (int c = (len - 1) & ~127; c >= 0; c -= 128) {
      const int x0 = c + 4 * lane;
      const int4 v = *(const int4*)(s + 4 + x0);
      const int e[4] = {v.x, v.y, v.z, v.w};
      int prev = __shfl_up_sync(FULL, v.w, 1);
      if (lane == 0) prev = s[3 + c];
      unsigned m = 0;  // the lane's large starts, bit q for position x0 + q
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int x = x0 + q;
        if (x < len && e[q] != (q ? e[q - 1] : prev) && ws + x < reach &&
            e[q] == (staged ? s[4 + x + max_size] : g[x + max_size]))
          m |= 1u << q;
      }
      if (!__any_sync(FULL, m)) continue;
      // slot: seen + the large starts of higher lanes + of this lane's
      // higher positions
      const unsigned above = ~((2u << lane) - 1u);
      int higher = 0, total = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned bal = __ballot_sync(FULL, m >> q & 1);
        higher += __popc(bal & above);
        total += __popc(bal);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int slot = seen + higher + __popc(m >> (q + 1));
        if (m >> q & 1 && slot < slots) o[slot] = e[q];
      }
      seen += total;
    }
    __syncwarp();  // before the next window overwrites the stage
  }
  for (int t = seen + lane; t < slots; t += 32) o[t] = -1;
}

}  // namespace

// skey: (B, N) int32, each frame sorted ascending. Sizes (mode 0) and keep
// (mode 1): sidx (B, N) int32 source indices or null (identity); out (B,
// n_out) int32 sizes or uint8 keep bytes. Roots (mode 2): sidx null, N a
// multiple of L, out (B, N / L, slots) int32.
extern "C" int sdr_sorted_runs(const int* skey, const int* sidx, void* out,
                               int B, int N, int n_out, int mode,
                               int max_size, int L, int slots, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || max_size < 0 || mode < SIZES ||
      mode > ROOTS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == ROOTS) {
    if (L < 1 || N % L || slots < 1 || sidx) return (int)cudaErrorInvalidValue;
    const int rows = N / L;
    runs_roots<<<dim3((rows + WARPS - 1) / WARPS, B), THREADS, 0, s>>>(
        skey, (int*)out, N, L, max_size, slots);
  } else {
    if (n_out < 1) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)(((long long)N + TILE - 1) / TILE), B);
    if (mode == SIZES)
      runs_sizes<SIZES><<<grid, THREADS, 0, s>>>(skey, sidx, out, N, n_out,
                                                 max_size);
    else
      runs_sizes<KEEP><<<grid, THREADS, 0, s>>>(skey, sidx, out, N, n_out,
                                                max_size);
  }
  return (int)cudaGetLastError();
}
