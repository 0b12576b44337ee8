// K4 + K5: the speckle filter — connected-component labels, then the keep
// pass that drops components of at most max_size pixels.
//
// K4 replaces stereo_depth_ruler_tpu/ops/sgbm_pallas.py:_speckle_labels_kernel
// (launched by _speckle_labels_batched). The TPU kernel iterates row and
// column segmented-min sweeps until no label changes: data-dependent rounds,
// each a full pass over the map. Here it is union-find, with grid.z over
// frames (two pixels link when both are valid, disp >= 0, and
// |d - d'| <= max_diff):
//   1. rows: one warp per row labels every valid pixel with the flat index
//      of the start of its horizontal run (a ballot of the run breaks per
//      32 pixels), an invalid pixel with H*W. A run is then a tree of
//      depth one and no horizontal link needs an atomic;
//   2. merge: one thread per pixel; a pixel linked to its upper neighbour
//      unites the two trees, unless its left neighbour has the same links
//      (then that pixel's union already joined them). A union hooks the larger root
//      under the smaller with atomicMin and retries while another thread
//      got there first (Playne & Hawick's lock-free union), so a parent is
//      always a smaller index of the same component;
//   3. compress: one thread per pixel takes its root.
// The root of a component is then its smallest flat index whatever the
// order of the atomics: the TPU kernel's labels exactly, with no cap on
// the rounds (a serpentine needs no more work than a blob).
//
// K5 replaces the keep half of the TPU path: the key-only bitonic sort
// (sort_tpu.py:_sort_chunk_single_kernel), the large-run roots
// (sort_tpu.py:_large_roots_kernel) and the OR-propagation
// (sgbm_pallas.py:_propagate_keep_kernel), which together build the mask
// "component size > max_size". Here: an int32 histogram of the labels
// (warp-aggregated atomicAdd, one per distinct label in a warp), then
// out = size[label] > max_size ? disp : -1. Integer atomics: deterministic.
//
// What bounds them on the H100: device-memory bytes, 8 B/px for K4 (disp
// in, labels out) and 12 B/px for K5 (disp and labels in, disp out); the
// union-find's pointer chasing and the histogram's atomics run in L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

constexpr int ROWS = THREADS / 32;  // rows per block in labels_rows

__device__ __forceinline__ bool linked(float v, float u, float max_diff) {
  return u >= 0.0f && fabsf(__fsub_rn(v, u)) <= max_diff;
}

__global__ void labels_rows(const float* __restrict__ disp, int* lab, int H,
                            int W, float max_diff) {
  const int lane = threadIdx.x & 31;
  const int y = blockIdx.x * ROWS + (threadIdx.x >> 5);
  if (y >= H) return;  // y is the same for the whole warp
  const int n = H * W;
  const size_t off = (size_t)blockIdx.z * n + (size_t)y * W;
  const float* d = disp + off;
  int* L = lab + off;
  int carry = 0;  // run start of the previous chunk's last pixel
  for (int x0 = 0; x0 < W; x0 += 32) {
    const int x = x0 + lane;
    const float v = x < W ? d[x] : -1.0f;
    const bool valid = v >= 0.0f;
    const bool link = valid && x > 0 && linked(v, d[x - 1], max_diff);
    // bit j: pixel x0 + j starts a run (or is invalid, or past the row)
    const unsigned brk = __ballot_sync(0xffffffffu, !link);
    const unsigned upto = brk & (0xffffffffu >> (31 - lane));
    const int start = upto ? x0 + 31 - __clz(upto) : carry;
    if (x < W) L[x] = valid ? y * W + start : n;
    carry = __shfl_sync(0xffffffffu, start, 31);
  }
}

// Parents only ever decrease and stay inside the component, so the walk
// ends; volatile reads see other threads' hooks.
__device__ __forceinline__ int find_root(const volatile int* L, int x) {
  int p = L[x];
  while (p != x) {
    x = p;
    p = L[x];
  }
  return x;
}

__device__ void unite(volatile int* L, int a, int b) {
  while (true) {
    a = find_root(L, a);
    b = find_root(L, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin((int*)&L[b], a);
    if (old == b) return;  // b was a root and now hangs under a
    b = old;               // b had been hooked meanwhile: unite a with that
  }
}

__global__ void labels_merge(const float* __restrict__ disp, int* lab, int W,
                             int n, float max_diff) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < W || i >= n) return;
  const size_t off = (size_t)blockIdx.z * n;
  const float* d = disp + off;
  volatile int* L = lab + off;
  const float v = d[i];
  if (!(v >= 0.0f) || !linked(v, d[i - W], max_diff)) return;
  if (i % W > 0 && linked(v, d[i - 1], max_diff)) {
    // left neighbour in this run, upper-left in the upper run, and linked
    // to each other: the left neighbour's union covers this link
    const float ul = d[i - W - 1];
    if (linked(d[i - W], ul, max_diff) && linked(d[i - 1], ul, max_diff))
      return;
  }
  unite(L, i, i - W);
}

__global__ void labels_compress(int* lab, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  volatile int* L = lab + (size_t)blockIdx.z * n;
  if (L[i] == n) return;  // invalid
  L[i] = find_root(L, i);
}

__global__ void keep_histogram(const int* __restrict__ lab, int* sizes,
                               int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t b = blockIdx.z;
  int l = i < n ? lab[b * n + i] : -1;
  if (l == n) l = -1;  // invalid pixels are not counted
  // all 32 lanes take part (THREADS is a multiple of 32, no early exit)
  const unsigned peers = __match_any_sync(0xffffffffu, l);
  if (l >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&sizes[b * (n + 1) + l], __popc(peers));
}

__global__ void keep_apply(const float* __restrict__ disp,
                           const int* __restrict__ lab,
                           const int* __restrict__ sizes,
                           float* __restrict__ out, int n, int max_size) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t b = blockIdx.z;
  const int l = lab[b * n + i];
  const bool keep = l < n && sizes[b * (n + 1) + l] > max_size;
  out[b * n + i] = keep ? disp[b * n + i] : -1.0f;
}

bool bad_shape(int B, int H, int W) {
  return B < 1 || H < 1 || W < 1 || B > 65535 ||
         (long long)H * W >= (1LL << 31) - 1;
}

}  // namespace

// disp: (B, H, W) float32, invalid < 0; labels: (B, H, W) int32 out.
extern "C" int sdr_speckle_labels(const float* disp, int* labels, int B,
                                  int H, int W, float max_diff,
                                  void* stream) {
  if (bad_shape(B, H, W)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n = H * W;
  const dim3 grid((n + THREADS - 1) / THREADS, 1, B);
  labels_rows<<<dim3((H + ROWS - 1) / ROWS, 1, B), THREADS, 0, s>>>(
      disp, labels, H, W, max_diff);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  labels_merge<<<grid, THREADS, 0, s>>>(disp, labels, W, n, max_diff);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  labels_compress<<<grid, THREADS, 0, s>>>(labels, n);
  return (int)cudaGetLastError();
}

// disp, labels: (B, H, W); sizes: (B, H*W + 1) int32 scratch (zeroed here);
// out: (B, H, W) float32, disp where the component is larger than max_size.
extern "C" int sdr_speckle_keep(const float* disp, const int* labels,
                                int* sizes, float* out, int B, int H, int W,
                                int max_size, void* stream) {
  if (bad_shape(B, H, W)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n = H * W;
  cudaError_t e = cudaMemsetAsync(sizes, 0, sizeof(int) * (size_t)B * (n + 1),
                                  s);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n + THREADS - 1) / THREADS, 1, B);
  keep_histogram<<<grid, THREADS, 0, s>>>(labels, sizes, n);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  keep_apply<<<grid, THREADS, 0, s>>>(disp, labels, sizes, out, n, max_size);
  return (int)cudaGetLastError();
}
