// K2: one semi-global matching scan along direction (dy, dx).
//
// Replaces stereo_depth_ruler_tpu/ops/sgbm_pallas.py:_dir_pass_kernel
// (launched by directional_pass_pallas) and the bottom-up half of
// _up_wta_kernel. One launch per direction; the 8 launches of the
// 8-path matcher add their L into one int32 volume S:
//
//   L(p, d) = C(p, d) + min(L(p-r, d), L(p-r, d+-1) + P1, minL + P2) - minL
//
// with minL = min_d L(p-r, d) and a zero predecessor at the image border
// (so L = C at a line's first cell), as ops/sgbm.py:directional_pass.
//
// Design: one warp per scan line (a row for horizontal paths, a column for
// vertical ones; a diagonal line starts at the border cell whose
// predecessor lies outside the image). Lane l holds the VPL = ceil(D/32)
// disparities l*VPL .. l*VPL+VPL-1 in registers, so minL is one
// __reduce_min_sync and the d-1 / d+1 neighbours across lanes are one
// __shfl_up_sync / __shfl_down_sync each. Lines are disjoint within a pass,
// so the S update is a plain read-add-write without atomics, and integer
// sums make the result independent of the order of the 8 passes.
//
// What bounds it on the H100: device-memory bytes. Each pass reads C
// (2 B per element) and reads and writes S (8 B per element; the first
// pass only writes it). The step-to-step dependency through L is short
// (a reduce and two shuffles); the next cell's C and S are loaded before
// the current cell is reduced, so the loads overlap the dependent chain.
// Lines per launch: B*H (horizontal), B*W (vertical), B*(W+H-1) (diagonal).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BIG = 1 << 29;          // above any path value (<= ~9000)
constexpr int WARPS_PER_BLOCK = 4;

template <int VPL, bool ACC>
__global__ void sgm_pass_kernel(const int16_t* __restrict__ C,
                                int32_t* __restrict__ S, int H, int W, int D,
                                int dy, int dx, int P1, int P2, int n_lines) {
  const int lane = threadIdx.x & 31;
  const int line = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (line >= n_lines) return;  // whole warp leaves together
  const int b = blockIdx.y;

  // first cell of the line
  const int ys = dy > 0 ? 0 : H - 1, xs = dx > 0 ? 0 : W - 1;
  int y, x;
  if (dy == 0) {
    y = line; x = xs;
  } else if (dx == 0 || line < W) {
    y = ys; x = line;
  } else {
    y = (dy > 0) ? line - W + 1 : line - W; x = xs;
  }

  const int d0 = lane * VPL;
  const size_t plane = (size_t)b * H * W;
  int c[VPL], s[VPL], L[VPL];

  size_t cell = (plane + (size_t)y * W + x) * D + d0;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const bool ok = d0 + k < D;
    c[k] = ok ? (int)C[cell + k] : 0;
    s[k] = (ACC && ok) ? S[cell + k] : 0;
    L[k] = ok ? c[k] : BIG;          // border: zero predecessor, L = C
  }

  while (true) {
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      if (d0 + k < D) S[cell + k] = ACC ? s[k] + L[k] : L[k];
    }
    y += dy;
    x += dx;
    if (y < 0 || y >= H || x < 0 || x >= W) break;
    cell = (plane + (size_t)y * W + x) * D + d0;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const bool ok = d0 + k < D;
      c[k] = ok ? (int)C[cell + k] : 0;
      s[k] = (ACC && ok) ? S[cell + k] : 0;
    }
    int m = L[0];
#pragma unroll
    for (int k = 1; k < VPL; ++k) m = min(m, L[k]);
    const int minL = __reduce_min_sync(0xffffffffu, m);
    int lm1 = __shfl_up_sync(0xffffffffu, L[VPL - 1], 1);
    int lp1 = __shfl_down_sync(0xffffffffu, L[0], 1);
    if (lane == 0) lm1 = BIG;
    if (lane == 31) lp1 = BIG;
    int prev[VPL];
#pragma unroll
    for (int k = 0; k < VPL; ++k) prev[k] = L[k];
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int a = (k == 0) ? lm1 : prev[k > 0 ? k - 1 : 0];
      const int z = (k == VPL - 1) ? lp1 : prev[k < VPL - 1 ? k + 1 : k];
      const int best = min(min(prev[k], minL + P2), min(a, z) + P1);
      L[k] = (d0 + k < D) ? c[k] + best - minL : BIG;
    }
  }
}

template <int VPL>
cudaError_t launch(const int16_t* C, int32_t* S, int B, int H, int W, int D,
                   int dy, int dx, int P1, int P2, int acc,
                   cudaStream_t stream) {
  const int n_lines = dy == 0 ? H : (dx == 0 ? W : W + H - 1);
  dim3 grid((n_lines + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK, B);
  dim3 block(32 * WARPS_PER_BLOCK);
  if (acc)
    sgm_pass_kernel<VPL, true><<<grid, block, 0, stream>>>(
        C, S, H, W, D, dy, dx, P1, P2, n_lines);
  else
    sgm_pass_kernel<VPL, false><<<grid, block, 0, stream>>>(
        C, S, H, W, D, dy, dx, P1, P2, n_lines);
  return cudaGetLastError();
}

}  // namespace

// C: (B, H, W, D) int16 cost; S: (B, H, W, D) int32, S = L (acc = 0) or
// S += L (acc = 1). dy, dx in {-1, 0, 1}, not both 0; D a multiple of 16,
// at most 256.
extern "C" int sdr_sgm_pass(const int16_t* C, int32_t* S, int B, int H,
                            int W, int D, int dy, int dx, int P1, int P2,
                            int acc, void* stream) {
  if (D < 16 || D > 256 || D % 16 || dy < -1 || dy > 1 || dx < -1 ||
      dx > 1 || (dy == 0 && dx == 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((D + 31) / 32) {
    case 1: return (int)launch<1>(C, S, B, H, W, D, dy, dx, P1, P2, acc, s);
    case 2: return (int)launch<2>(C, S, B, H, W, D, dy, dx, P1, P2, acc, s);
    case 3: return (int)launch<3>(C, S, B, H, W, D, dy, dx, P1, P2, acc, s);
    case 4: return (int)launch<4>(C, S, B, H, W, D, dy, dx, P1, P2, acc, s);
    case 5: return (int)launch<5>(C, S, B, H, W, D, dy, dx, P1, P2, acc, s);
    case 6: return (int)launch<6>(C, S, B, H, W, D, dy, dx, P1, P2, acc, s);
    case 7: return (int)launch<7>(C, S, B, H, W, D, dy, dx, P1, P2, acc, s);
    case 8: return (int)launch<8>(C, S, B, H, W, D, dy, dx, P1, P2, acc, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
