// The radix sort: a stable LSD radix sort of int32 keys, key-only or with
// int32 values, one sort per frame of a batch.
//
// Replaces the TPU's bitonic sorts in stereo_depth_ruler_tpu/ops/sort_tpu.py:
// _sort_chunk_single_kernel (key-only, launched by _bitonic_sort_single),
// _sort_chunk_kernel (key/value, _bitonic_sort_staged) and _fused_sort_kernel
// (one launch, keys or pairs, _bitonic_sort_fused). A bitonic network does
// n log^2 n compare-exchanges from whole-array rolls because the TPU has no
// fast scatter; the GPU has one, so this is counting passes of 8-bit
// digits over keys in [0, 2^31): 4 passes.
//
// Design (one sweep per digit, with decoupled look-back):
//   1. radix_histogram reads the keys once and counts all passes' digits
//      per frame (a thread walks consecutive keys and adds a run of equal
//      digits with one shared atomic, so the long runs of equal labels cost
//      one atomic per run, not per key);
//   2. radix_plan turns each frame's histograms into exclusive digit
//      offsets and marks a pass active unless every frame has all its keys
//      in one bucket: an inactive pass is the identity and is skipped (its
//      kernel returns at once; the buffers are routed on the device so that
//      the last active pass writes the output; with no active pass the last
//      pass kernel copies the input);
//   3. radix_pass, per digit: a block takes the next tile of TILE keys of
//      one frame (tile ids from an atomic counter, so a tile only waits for
//      tiles that already run), ranks its keys in registers (per warp
//      __match_any_sync on the digit, a warp-private count per digit in
//      shared memory, one scan over the warps and one over the digits),
//      publishes its per-digit counts, puts keys (and values) into shared
//      memory in digit order, finds the counts of the frame's earlier tiles
//      by looking back over their published status words (flag + count in
//      one 32-bit word: aggregate, or inclusive prefix), and writes the
//      tile out as contiguous runs per digit, neighbouring threads on
//      neighbouring destinations.
// Ranks follow input order (warp-striped loads ranked lane by lane, warps
// in order, tiles in order), so every pass is stable and so is the sort:
// equal keys keep their values in input order, as torch.sort(stable=True).
// The input is never written.
//
// What bounds it on the H100: device-memory bytes and the ranking. The
// function must read and write each key once (8 B per key, 16 B per pair);
// this design reads every key once for the histograms and then, per active
// pass, reads and writes it once (4 + 8 P B per key, 4 + 16 P B per pair,
// P the active passes) plus 2 x 4 B of status per digit and tile; the
// ranking's match and the shared-memory scatter are the rest. 11-bit
// digits (three passes) were about 3x slower at 16 x 2^20 keys on the
// H100: 2,048 buckets to rank, scan and look back over per tile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;               // keys per thread and tile
constexpr int TILE = THREADS * ITEMS;   // keys per tile
constexpr int HIST_KEYS = 64;           // consecutive keys per histogram thread
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned AGG = 1u << 30;      // status: the tile's own count
constexpr unsigned PREFIX = 1u << 31;   // status: the inclusive prefix
constexpr unsigned COUNT = AGG - 1;

constexpr int BITS = 8;                 // digit width
constexpr int DIGITS = 1 << BITS;
constexpr int PASSES = (31 + BITS - 1) / BITS;
static_assert(DIGITS == THREADS, "one digit per thread");

int tiles_of(int N) { return (N + TILE - 1) / TILE; }

__device__ __forceinline__ int digit_of(int key, int pass) {
  return (int)(((unsigned)key >> (pass * BITS)) & ((1u << BITS) - 1));
}

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// Exclusive scan of one int per thread over the block; returns the
// thread's prefix. ws: WARPS ints of shared memory.
__device__ __forceinline__ int block_exclusive_scan(int x, int* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) ws[warp] = inc;
  __syncthreads();
  int before = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) before += w < warp ? ws[w] : 0;
  __syncthreads();   // ws is free again
  return before + inc - x;
}

// hist: (B, PASSES, DIGITS) int32, zeroed; grid (ceil(N / chunk), B).
__global__ void __launch_bounds__(THREADS)
radix_histogram(const int* __restrict__ keys, int* hist, int N) {
  __shared__ int count[PASSES * DIGITS];
  for (int i = threadIdx.x; i < PASSES * DIGITS; i += THREADS)
    count[i] = 0;
  __syncthreads();
  const size_t b = blockIdx.y;
  const int* k = keys + b * N;
  const int i0 = (blockIdx.x * THREADS + threadIdx.x) * HIST_KEYS;
  const int i1 = min(i0 + HIST_KEYS, N);
  int cur[PASSES], run[PASSES];
#pragma unroll
  for (int p = 0; p < PASSES; ++p) cur[p] = -1, run[p] = 0;
  for (int i = i0; i < i1; ++i) {
    const int key = __ldg(k + i);
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int d = digit_of(key, p);
      if (d != cur[p]) {
        if (run[p]) atomicAdd(&count[p * DIGITS + cur[p]], run[p]);
        cur[p] = d;
        run[p] = 0;
      }
      ++run[p];
    }
  }
#pragma unroll
  for (int p = 0; p < PASSES; ++p)
    if (run[p]) atomicAdd(&count[p * DIGITS + cur[p]], run[p]);
  __syncthreads();
  int* h = hist + b * PASSES * DIGITS;
  for (int i = threadIdx.x; i < PASSES * DIGITS; i += THREADS)
    if (count[i]) atomicAdd(&h[i], count[i]);
}

// hist -> exclusive digit offsets in place; active[pass] = 1 where some
// frame has keys in two buckets. Grid (PASSES, B).
__global__ void __launch_bounds__(THREADS)
radix_plan(int* hist, int* active) {
  __shared__ int ws[WARPS];
  int* h = hist + ((size_t)blockIdx.y * PASSES + blockIdx.x) * DIGITS +
           threadIdx.x;
  const int c = *h;
  *h = block_exclusive_scan(c, ws);
  const int some = __syncthreads_count(c > 0);
  if (threadIdx.x == 0 && some > 1) active[blockIdx.x] = 1;
}

// One digit pass. Grid: B * tiles blocks. base: the plan's offsets;
// counter: PASSES tile counters; status: (PASSES, B, tiles, DIGITS); all
// zeroed before the sort.
__global__ void __launch_bounds__(THREADS)
radix_pass(const int* __restrict__ kin, const int* __restrict__ vin,
           int* kout, int* vout, int* ktmp, int* vtmp,
           const int* __restrict__ base, const int* active, unsigned* counter,
           unsigned* status, int B, int N, int tiles, int pass) {
  // routing: the j-th of k active passes reads what the one before wrote
  // (the input for j = 0) and writes the output when k - 1 - j is even
  int k = 0, j = 0;
#pragma unroll
  for (int q = 0; q < PASSES; ++q) {
    const int a = active[q];
    k += a;
    j += q < pass ? a : 0;
  }
  const bool pairs = vin != nullptr;
  if (!active[pass]) {
    if (pass == PASSES - 1 && k == 0) {   // nothing to sort: copy
      const size_t off = (size_t)blockIdx.x / tiles * N;
      const int t = blockIdx.x % tiles;
      const int n = min(TILE, N - t * TILE);
      for (int i = threadIdx.x; i < n; i += THREADS) {
        const size_t at = off + (size_t)t * TILE + i;
        kout[at] = kin[at];
        if (pairs) vout[at] = vin[at];
      }
    }
    return;
  }
  const int* ks = j == 0 ? kin : ((k - j) % 2 == 0 ? kout : ktmp);
  const int* vs = j == 0 ? vin : ((k - j) % 2 == 0 ? vout : vtmp);
  int* kd = (k - 1 - j) % 2 == 0 ? kout : ktmp;
  int* vd = (k - 1 - j) % 2 == 0 ? vout : vtmp;

  extern __shared__ int smem[];
  int* skey = smem;                                   // [TILE]
  int* sval = skey + TILE;                            // [TILE]
  int* tstart = sval + TILE;                          // [DIGITS]
  int* gdst = tstart + DIGITS;                        // [DIGITS]
  int* ws = gdst + DIGITS;                            // [WARPS + 1]
  unsigned short* whist = (unsigned short*)(ws + WARPS + 1);  // [WARPS][DIGITS]

  if (threadIdx.x == 0) ws[WARPS] = (int)atomicAdd(&counter[pass], 1u);
  for (int i = threadIdx.x; i < WARPS * DIGITS / 2; i += THREADS)
    ((unsigned*)whist)[i] = 0;
  __syncthreads();
  const int g = ws[WARPS];
  const int b = g / tiles, t = g % tiles;
  const size_t fo = (size_t)b * N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt_mask = (1u << lane) - 1;
  const int seg = t * TILE + warp * 32 * ITEMS;   // the warp's keys

  // rank: item jj of the lane is key seg + 32 jj + lane; pos = its rank
  // among the warp's keys of equal digit
  int key[ITEMS], pos[ITEMS];
#pragma unroll
  for (int jj = 0; jj < ITEMS; ++jj) {
    const int i = seg + 32 * jj + lane;
    key[jj] = i < N ? ks[fo + i] : 0;
  }
  unsigned short* wh = whist + warp * DIGITS;
#pragma unroll
  for (int jj = 0; jj < ITEMS; ++jj) {
    const bool in = seg + 32 * jj + lane < N;
    const int d = in ? digit_of(key[jj], pass) : DIGITS;
    const unsigned peers = __match_any_sync(FULL, d);
    const int leader = 31 - __clz(peers);
    int c = 0;
    if (in && lane == leader) {
      c = wh[d];
      wh[d] = (unsigned short)(c + __popc(peers));
    }
    c = __shfl_sync(FULL, c, leader);
    pos[jj] = c + __popc(peers & lt_mask);
    __syncwarp();
  }
  __syncthreads();

  // the thread's digit td: the warps' exclusive offsets, the tile's
  // count, published
  unsigned* st = status + (((size_t)pass * B + b) * tiles + t) * DIGITS;
  const int td = threadIdx.x;
  int cnt = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int c = whist[w * DIGITS + td];
    whist[w * DIGITS + td] = (unsigned short)cnt;
    cnt += c;
  }
  st_relaxed(st + td, (t == 0 ? PREFIX : AGG) | (unsigned)cnt);
  tstart[td] = block_exclusive_scan(cnt, ws);
  __syncthreads();

  // the tile in digit order in shared memory
#pragma unroll
  for (int jj = 0; jj < ITEMS; ++jj) {
    const int i = seg + 32 * jj + lane;
    if (i < N) {
      const int d = digit_of(key[jj], pass);
      pos[jj] += tstart[d] + whist[warp * DIGITS + d];
      skey[pos[jj]] = key[jj];
    }
  }
  if (pairs) {
#pragma unroll
    for (int jj = 0; jj < ITEMS; ++jj) {
      const int i = seg + 32 * jj + lane;
      if (i < N) sval[pos[jj]] = vs[fo + i];
    }
  }

  // look back over the frame's earlier tiles for the digit's offset
  unsigned excl = 0;
  if (t > 0) {
    const unsigned* sp = st + td;
    for (int pt = t - 1; pt >= 0; --pt) {
      sp -= DIGITS;
      unsigned s;
      do {
        s = ld_relaxed(sp);
      } while (!(s & (AGG | PREFIX)));
      excl += s & COUNT;
      if (s & PREFIX) break;
    }
    st_relaxed(st + td, PREFIX | (excl + (unsigned)cnt));
  }
  gdst[td] = base[((size_t)b * PASSES + pass) * DIGITS + td] + (int)excl -
             tstart[td];
  __syncthreads();

  // runs of equal digits to consecutive places
  const int n = min(TILE, N - t * TILE);
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int kk = skey[i];
    const size_t at = fo + (size_t)(gdst[digit_of(kk, pass)] + i);
    kd[at] = kk;
    if (pairs) vd[at] = sval[i];
  }
}

// dynamic shared memory of radix_pass: under the 48 KB default
constexpr size_t PASS_SMEM = sizeof(int) * (2 * TILE + 2 * DIGITS + WARPS + 1) +
                             sizeof(unsigned short) * WARPS * DIGITS;
static_assert(PASS_SMEM <= 48 * 1024, "radix_pass shared memory");

// int32 entries of scratch: hist, active, counters, status
size_t scratch_entries(int B, int N) {
  return (size_t)B * PASSES * DIGITS + 2 * PASSES +
         (size_t)PASSES * B * tiles_of(N) * DIGITS;
}

cudaError_t sort(const int* kin, const int* vin, int* kout, int* vout,
                 int* ktmp, int* vtmp, int* scratch, int B, int N,
                 cudaStream_t s) {
  const int tiles = tiles_of(N);
  int* hist = scratch;
  int* active = hist + (size_t)B * PASSES * DIGITS;
  unsigned* counter = (unsigned*)(active + PASSES);
  unsigned* status = counter + PASSES;
  const int chunk = THREADS * HIST_KEYS;
  radix_histogram<<<dim3((N + chunk - 1) / chunk, B), THREADS, 0, s>>>(
      kin, hist, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  radix_plan<<<dim3(PASSES, B), THREADS, 0, s>>>(hist, active);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  for (int pass = 0; pass < PASSES; ++pass) {
    radix_pass<<<B * tiles, THREADS, PASS_SMEM, s>>>(
        kin, vin, kout, vout, ktmp, vtmp, hist, active, counter, status, B,
        N, tiles, pass);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}

}  // namespace

// int32 entries of zeroed scratch that sdr_radix_sort needs at B frames of
// N keys; -1 for bad arguments.
extern "C" long long sdr_radix_scratch_size(int B, int N) {
  if (B < 1 || N < 1) return -1;
  return (long long)scratch_entries(B, N);
}

// key_in (and val_in): (B, N) int32, keys in [0, 2^31); key_out (val_out):
// (B, N) sorted; key_tmp (val_tmp): (B, N) scratch; scratch:
// sdr_radix_scratch_size(B, N) int32, zeroed. val_in, val_out and val_tmp
// are all null for a key-only sort.
extern "C" int sdr_radix_sort(const int* key_in, const int* val_in,
                              int* key_out, int* val_out, int* key_tmp,
                              int* val_tmp, int* scratch, int B, int N,
                              void* stream) {
  if (B < 1 || B > 65535 || N < 1 || N >= (int)AGG ||
      (long long)B * tiles_of(N) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if ((val_in == nullptr) != (val_out == nullptr) ||
      (val_in == nullptr) != (val_tmp == nullptr))
    return (int)cudaErrorInvalidValue;
  return (int)sort(key_in, val_in, key_out, val_out, key_tmp, val_tmp,
                   scratch, B, N, (cudaStream_t)stream);
}
