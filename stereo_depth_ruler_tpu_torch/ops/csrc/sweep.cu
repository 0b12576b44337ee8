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
// reduction, then each column run takes its own". The TPU builds each
// sweep from log-doubling rolls; here
//   - sweep_rows: one warp per row, a segmented scan per 32 pixels
//     (shuffles, run breaks where a pixel does not link to its neighbour)
//     with a carry across the chunks, forward and then backward;
//   - sweep_cols: one thread per column walks down and back up, so a warp
//     reads 32 neighbouring columns of a row at a time (coalesced).
// Every frame has a flag per round: set when the round changed a value.
// A frame whose last round changed nothing is a fixed point and skips the
// later rounds. With max_iters > 0 the host launches exactly that many
// rounds and never waits; with max_iters == 0 it reads the flags after
// each round and stops when no frame changed (convergence).
//
// What bounds it on the H100: per round each pixel's value is read and
// written twice and its link inputs read twice, about 32 B/px in L2 or
// device memory, against 8 B/px (disp in, labels out) or 12 B/px (labels
// and seed in, bits out) for the function as a whole; the column pass
// walks H rows serially per thread. A capped call at max_iters = 3 does
// three rounds; a converged serpentine needs ~H / 4.

#include <cuda_runtime.h>
#include <stdint.h>

#include <vector>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = THREADS / 32;  // rows per block in sweep_rows
constexpr unsigned FULL = 0xffffffffu;

// The two modes: what links two pixels, how a run reduces, the initial value.
struct Labels {
  const float* disp;
  float max_diff;
  int n;
  static __device__ __forceinline__ int op(int a, int b) { return min(a, b); }
  __device__ __forceinline__ bool link(size_t i, size_t j) const {
    // pixel i links to its neighbour j
    const float d = disp[i], e = disp[j];
    return d >= 0.0f && e >= 0.0f && fabsf(__fsub_rn(d, e)) <= max_diff;
  }
  __device__ __forceinline__ int init(size_t frame, int i) const {
    return disp[frame * n + i] >= 0.0f ? i : n;
  }
};

struct Propagate {
  const int* labels;
  const int* seed;
  int n;
  static __device__ __forceinline__ int op(int a, int b) { return max(a, b); }
  __device__ __forceinline__ bool link(size_t i, size_t j) const {
    const int l = labels[i];
    return l != n && l == labels[j];
  }
  __device__ __forceinline__ int init(size_t frame, int i) const {
    return seed[frame * n + i];
  }
};

template <class M>
__global__ void sweep_init(M m, int* __restrict__ val, int* flags) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t b = blockIdx.y;
  if (i == 0) flags[b] = 1;  // every frame takes part in the first round
  if (i < m.n) val[b * m.n + i] = m.init(b, i);
}

template <class M>
__global__ void sweep_rows(M m, int* val, const int* __restrict__ in_flag,
                           int* out_flag, int H, int W) {
  const int lane = threadIdx.x & 31;
  const int y = blockIdx.x * ROWS + (threadIdx.x >> 5);
  const size_t b = blockIdx.y;
  if (y >= H || !in_flag[b]) return;  // the same for the whole warp
  const size_t row = b * m.n + (size_t)y * W;
  int* v = val + row;
  bool changed = false;
  // forward: each pixel takes the reduction of its run up to it
  int carry = 0;
  for (int x0 = 0; x0 < W; x0 += 32) {
    const int x = x0 + lane;
    const bool in = x < W;
    const bool link = in && x > 0 && m.link(row + x, row + x - 1);
    const int old = in ? v[x] : 0;
    int cur = (lane == 0 && link) ? M::op(old, carry) : old;
    bool c = link && lane > 0;  // linked to the previous lane
    for (int o = 1; o < 32; o <<= 1) {
      const int pv = __shfl_up_sync(FULL, cur, o);
      const bool pc = __shfl_up_sync(FULL, c, o);
      if (lane >= o && c) cur = M::op(cur, pv);
      c = c && lane >= o && pc;
    }
    if (in) {
      v[x] = cur;
      changed |= cur != old;
    }
    carry = __shfl_sync(FULL, cur, 31);
  }
  // backward: each pixel takes the reduction of its run from it to the end,
  // which is now the whole run's
  for (int x0 = (W - 1) / 32 * 32; x0 >= 0; x0 -= 32) {
    const int x = x0 + lane;
    const bool in = x < W;
    const bool link = in && x + 1 < W && m.link(row + x + 1, row + x);
    const int old = in ? v[x] : 0;
    int cur = (lane == 31 && link) ? M::op(old, carry) : old;
    bool c = link && lane < 31;  // linked to the next lane
    for (int o = 1; o < 32; o <<= 1) {
      const int nv = __shfl_down_sync(FULL, cur, o);
      const bool nc = __shfl_down_sync(FULL, c, o);
      if (lane + o < 32 && c) cur = M::op(cur, nv);
      c = c && lane + o < 32 && nc;
    }
    if (in) {
      v[x] = cur;
      changed |= cur != old;
    }
    carry = __shfl_sync(FULL, cur, 0);
  }
  if (__any_sync(FULL, changed) && lane == 0) out_flag[b] = 1;
}

template <class M>
__global__ void sweep_cols(M m, int* val, const int* __restrict__ in_flag,
                           int* out_flag, int H, int W) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t b = blockIdx.y;
  if (!in_flag[b]) return;  // the same for the whole block
  bool changed = false;
  if (x < W) {
    const size_t col = b * m.n + x;
    int* v = val + col;
    int run = v[0];
    for (int y = 1; y < H; ++y) {
      const size_t i = (size_t)y * W;
      const int old = v[i];
      run = m.link(col + i, col + i - W) ? M::op(run, old) : old;
      v[i] = run;
      changed |= run != old;
    }
    // v[(H-1) W] holds its run's reduction already
    for (int y = H - 2; y >= 0; --y) {
      const size_t i = (size_t)y * W;
      const int old = v[i];
      run = m.link(col + i + W, col + i) ? M::op(run, old) : old;
      v[i] = run;
      changed |= run != old;
    }
  }
  if (__any_sync(FULL, changed) && (threadIdx.x & 31) == 0) out_flag[b] = 1;
}

template <class M>
int run_rounds(M m, int* val, int* flags, int B, int H, int W, int max_iters,
               cudaStream_t s) {
  int* in_flag = flags;
  int* out_flag = flags + B;
  sweep_init<<<dim3((m.n + THREADS - 1) / THREADS, B), THREADS, 0, s>>>(
      m, val, in_flag);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  std::vector<int> host(B);
  for (int r = 0; max_iters == 0 || r < max_iters; ++r) {
    e = cudaMemsetAsync(out_flag, 0, sizeof(int) * B, s);
    if (e != cudaSuccess) return (int)e;
    sweep_rows<<<dim3((H + ROWS - 1) / ROWS, B), THREADS, 0, s>>>(
        m, val, in_flag, out_flag, H, W);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    sweep_cols<<<dim3((W + THREADS - 1) / THREADS, B), THREADS, 0, s>>>(
        m, val, in_flag, out_flag, H, W);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (max_iters == 0) {
      e = cudaMemcpyAsync(host.data(), out_flag, sizeof(int) * B,
                          cudaMemcpyDeviceToHost, s);
      if (e == cudaSuccess) e = cudaStreamSynchronize(s);
      if (e != cudaSuccess) return (int)e;
      bool any = false;
      for (int f : host) any |= f != 0;
      if (!any) break;
    }
    int* t = in_flag;
    in_flag = out_flag;
    out_flag = t;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Labels mode (seed null): a = (B, H, W) float32 disparity, invalid < 0.
// Propagate mode: a = (B, H, W) int32 labels, seed = (B, H, W) int32.
// out: (B, H, W) int32; flags: 2 B int32 scratch. max_iters 0 runs to
// convergence (and waits on the stream once per round), > 0 caps the rounds.
extern "C" int sdr_sweep(const void* a, const int* seed, int* out, int* flags,
                         int B, int H, int W, float max_diff, int max_iters,
                         void* stream) {
  if (B < 1 || H < 1 || W < 1 || B > 65535 || max_iters < 0 ||
      (long long)H * W >= (1LL << 31) - 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n = H * W;
  if (seed == nullptr)
    return run_rounds(Labels{(const float*)a, max_diff, n}, out, flags, B, H,
                      W, max_iters, s);
  return run_rounds(Propagate{(const int*)a, seed, n}, out, flags, B, H, W,
                    max_iters, s);
}
