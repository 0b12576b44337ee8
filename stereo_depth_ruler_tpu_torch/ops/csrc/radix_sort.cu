// The radix sort: a stable LSD radix sort of int32 keys, key-only or with
// int32 values, one sort per frame of a batch.
//
// Replaces the TPU's bitonic sorts in stereo_depth_ruler_tpu/ops/sort_tpu.py:
// _sort_chunk_single_kernel (key-only, launched by _bitonic_sort_single),
// _sort_chunk_kernel (key/value, _bitonic_sort_staged) and _fused_sort_kernel
// (one launch, keys or pairs, _bitonic_sort_fused). A bitonic network does
// n log^2 n compare-exchanges from whole-array rolls because the TPU has no
// fast scatter; the GPU has one, so this is four counting passes of 8-bit
// digits over keys in [0, 2^31). Each pass, for every frame (grid.y):
//   1. radix_histogram: each tile of TILE keys counts its digits in shared
//      memory (one atomicAdd per distinct digit in a warp) and writes them
//      digit-major, hist[d][tile];
//   2. radix_scan: one block per frame turns hist into exclusive offsets;
//      digit-major order makes offset(d, tile) = #keys with a smaller digit
//      + #keys with digit d in earlier tiles;
//   3. radix_scatter: each tile ranks its keys among equal digits in input
//      order (per round of 256 keys: __match_any_sync within a warp, then a
//      per-digit scan over the warps in shared memory) and writes each key
//      (and value) to offset + rank.
// The ranks follow input order, so every pass is stable and so is the sort:
// equal keys keep their values in input order, as torch.sort(stable=True).
// Passes ping-pong between the output and a scratch buffer: in -> tmp ->
// out -> tmp -> out; the input is not written.
//
// What bounds it on the H100: device-memory bytes. The function must read
// and write each key once (8 B per key, 16 B per pair); the four passes
// read each key twice and write it once (24 B per key and pass, 48 B per
// pair), and the scatter's writes land in 256 streams per tile. Skipping
// digits that are the same for every key (the top byte of labels below
// 2^24), and a one-sweep design, are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 8;                // keys per thread and tile
constexpr int TILE = THREADS * ITEMS;   // keys per tile
constexpr int RADIX = 256;              // 8-bit digits
constexpr int SCAN_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;
static_assert(THREADS == RADIX, "radix_scatter gives one thread per digit");

int tiles_of(int N) { return (N + TILE - 1) / TILE; }

__device__ __forceinline__ int digit_of(int key, int shift) {
  return (int)(((unsigned)key >> shift) & 0xffu);
}

__global__ void radix_histogram(const int* __restrict__ keys, int* hist,
                                int N, int tiles, int shift) {
  __shared__ int count[RADIX];
  const int t = blockIdx.x;
  const size_t b = blockIdx.y;
  count[threadIdx.x] = 0;
  __syncthreads();
  const int* k = keys + b * N;
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < ITEMS; ++j) {
    const int i = t * TILE + j * THREADS + threadIdx.x;
    const int d = i < N ? digit_of(k[i], shift) : -1;
    const unsigned peers = __match_any_sync(FULL, d);
    if (d >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(&count[d], __popc(peers));
  }
  __syncthreads();
  const size_t at = (b * RADIX + threadIdx.x) * tiles + t;  // [b][digit][t]
  hist[at] = count[threadIdx.x];
}

__global__ void radix_scan(int* hist, int M) {
  __shared__ int warp_sums[SCAN_THREADS / 32];
  int* h = hist + (size_t)blockIdx.x * M;
  const int per = (M + SCAN_THREADS - 1) / SCAN_THREADS;
  const int lo = min((int)threadIdx.x * per, M);
  const int hi = min(lo + per, M);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += h[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = sum;  // inclusive scan over the warp
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  int run = x - sum + (warp ? warp_sums[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int c = h[i];
    h[i] = run;
    run += c;
  }
}

__global__ void radix_scatter(const int* __restrict__ kin,
                              const int* __restrict__ vin,
                              int* __restrict__ kout, int* __restrict__ vout,
                              const int* __restrict__ hist, int N, int tiles,
                              int shift) {
  __shared__ int offset[RADIX];          // next free place per digit
  __shared__ int wcount[WARPS][RADIX];   // per warp: count, then its offset
  const int t = blockIdx.x;
  const size_t b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  offset[threadIdx.x] = hist[(b * RADIX + threadIdx.x) * tiles + t];
  for (int w = 0; w < WARPS; ++w) wcount[w][threadIdx.x] = 0;
  const int* k = kin + b * N;
  const unsigned below_mask = (1u << lane) - 1;
  for (int j = 0; j < ITEMS; ++j) {
    const int i = t * TILE + j * THREADS + threadIdx.x;
    const bool in = i < N;
    const int key = in ? k[i] : 0;
    const int d = in ? digit_of(key, shift) : -1;
    const unsigned peers = __match_any_sync(FULL, d);
    const int below = __popc(peers & below_mask);  // equal digits before me
    __syncthreads();  // offset and wcount are settled
    if (in && below == 0) wcount[warp][d] = __popc(peers);
    __syncthreads();
    {
      // thread = digit: the warps' offsets in warp order; entries with no
      // key stay 0 for the next round
      int run = offset[threadIdx.x];
      for (int w = 0; w < WARPS; ++w) {
        const int c = wcount[w][threadIdx.x];
        if (c) wcount[w][threadIdx.x] = run;
        run += c;
      }
      offset[threadIdx.x] = run;
    }
    __syncthreads();
    if (in) {
      const size_t dst = b * N + wcount[warp][d] + below;
      kout[dst] = key;
      if (vin) vout[dst] = vin[b * N + i];
    }
    __syncwarp();
    if (in && below == 0) wcount[warp][d] = 0;  // after every peer read it
  }
}

}  // namespace

// int32 entries of histogram scratch per frame that sdr_radix_sort needs.
extern "C" int sdr_radix_hist_size(int N) {
  return N < 1 ? 0 : RADIX * tiles_of(N);
}

// key_in (and val_in): (B, N) int32, keys in [0, 2^31); key_out (val_out):
// (B, N) sorted; key_tmp (val_tmp): (B, N) scratch; hist: (B,
// sdr_radix_hist_size(N)) scratch. val_in, val_out and val_tmp are all null
// for a key-only sort.
extern "C" int sdr_radix_sort(const int* key_in, const int* val_in,
                              int* key_out, int* val_out, int* key_tmp,
                              int* val_tmp, int* hist, int B, int N,
                              void* stream) {
  if (B < 1 || B > 65535 || N < 1) return (int)cudaErrorInvalidValue;
  if ((val_in == nullptr) != (val_out == nullptr) ||
      (val_in == nullptr) != (val_tmp == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = tiles_of(N);
  const dim3 grid(tiles, B);
  const int* ks = key_in;
  const int* vs = val_in;
  for (int pass = 0; pass < 4; ++pass) {
    int* kd = pass % 2 ? key_out : key_tmp;
    int* vd = pass % 2 ? val_out : val_tmp;
    radix_histogram<<<grid, THREADS, 0, s>>>(ks, hist, N, tiles, 8 * pass);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    radix_scan<<<B, SCAN_THREADS, 0, s>>>(hist, RADIX * tiles);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    radix_scatter<<<grid, THREADS, 0, s>>>(ks, vs, kd, vd, hist, N, tiles,
                                           8 * pass);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ks = kd;
    vs = vd;
  }
  return (int)cudaGetLastError();
}
