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
// unpermutes with a second bitonic sort of (source index, result). Here a
// thread finds its position's run by a binary search of the sorted frame
// (skipped where a neighbour already differs) and writes the size, or the
// keep byte, straight to its source index (out[sidx[i]], targets past the
// output dropped): the store is the unpermute. Roots: one warp per row; a
// position is a large start when its key differs from the previous one
// (position 0 against 2^30 - 1, as the TPU scan reads it) and the key
// max_size places on is the same (past the frame: no match). The warp
// counts the row's large starts, then writes them from the last slot down.
//
// What bounds it on the H100: device-memory bytes, 12 B per position for
// sizes (keys and source indices in, an int out) and 9 B for keep; the
// binary searches' reads of the frame hit L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = THREADS / 32;  // rows per block in runs_roots
constexpr unsigned FULL = 0xffffffffu;
constexpr int INF = 1 << 30;        // the pad value of the packed blocks

enum Mode { SIZES = 0, KEEP = 1, ROOTS = 2 };

// first index in [lo, hi) whose key is >= key (or > key with upper)
__device__ __forceinline__ int bound(const int* k, int lo, int hi, int key,
                                     bool upper) {
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    const int v = k[mid];
    if (v < key || (upper && v == key))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void runs_sizes(const int* __restrict__ skey,
                           const int* __restrict__ sidx, void* out, int N,
                           int n_out, int mode, int max_size) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const size_t b = blockIdx.y;
  const int* k = skey + b * N;
  const int key = k[i];
  const int first = i > 0 && k[i - 1] == key ? bound(k, 0, i, key, false) : i;
  const int end =
      i + 1 < N && k[i + 1] == key ? bound(k, i + 1, N, key, true) : i + 1;
  const int size = end - first;
  const int dst = sidx ? sidx[b * N + i] : i;
  if (dst < 0 || dst >= n_out) return;
  if (mode == SIZES)
    ((int*)out)[b * n_out + dst] = size;
  else
    ((uint8_t*)out)[b * n_out + dst] = size > max_size;
}

__device__ __forceinline__ bool large_start(const int* k, int f, int N,
                                            int max_size) {
  const int key = k[f];
  const bool start = key != (f > 0 ? k[f - 1] : INF - 1);
  return start && (long long)f + max_size < N && k[f + max_size] == key;
}

__global__ void runs_roots(const int* __restrict__ skey, int* __restrict__ out,
                           int N, int L, int max_size, int slots) {
  const int lane = threadIdx.x & 31;
  const int rows = N / L;
  const int r = blockIdx.x * ROWS + (threadIdx.x >> 5);
  if (r >= rows) return;  // the same for the whole warp
  const size_t b = blockIdx.y;
  const int* k = skey + b * N;
  int* o = out + (b * rows + r) * (size_t)slots;
  int count = 0;
  for (int x0 = 0; x0 < L; x0 += 32) {
    const int x = x0 + lane;
    const bool large = x < L && large_start(k, r * L + x, N, max_size);
    count += __popc(__ballot_sync(FULL, large));
  }
  // starts come in ascending order; the j-th goes to slot count - 1 - j
  int seen = 0;
  for (int x0 = 0; x0 < L; x0 += 32) {
    const int x = x0 + lane;
    const bool large = x < L && large_start(k, r * L + x, N, max_size);
    const unsigned bal = __ballot_sync(FULL, large);
    const int slot = count - 1 - seen - __popc(bal & ((1u << lane) - 1));
    if (large && slot < slots) o[slot] = k[r * L + x];
    seen += __popc(bal);
  }
  for (int s = count + lane; s < slots; s += 32) o[s] = -1;
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
    runs_roots<<<dim3((rows + ROWS - 1) / ROWS, B), THREADS, 0, s>>>(
        skey, (int*)out, N, L, max_size, slots);
  } else {
    if (n_out < 1) return (int)cudaErrorInvalidValue;
    runs_sizes<<<dim3((N + THREADS - 1) / THREADS, B), THREADS, 0, s>>>(
        skey, sidx, out, N, n_out, mode, max_size);
  }
  return (int)cudaGetLastError();
}
