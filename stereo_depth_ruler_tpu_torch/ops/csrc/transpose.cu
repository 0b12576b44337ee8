// The three volume transposes, on elements of 2 or 4 bytes.
//
// Replaces stereo_depth_ruler_tpu/ops/sgbm_pallas.py:_transpose_kernel
// (launched by transpose_vol_pallas, (A, D, B) -> (B, D, A)),
// _transpose_leading_kernel (transpose_leading_pallas, (A, B, W) ->
// (B, A, W)) and _transpose_dhw_kernel (transpose_dhw_to_wdh_pallas,
// (D, H, W) -> (W, D, H)). They move bits: an element is an unsigned
// integer of its size, so bfloat16 and float16 volumes pass through
// exactly, and no extent needs to divide a tile.
//
// What bounds them on the H100: device-memory bytes, one read and one
// write of the volume. The first and the third swap the fastest axis with
// a slower one for every index of the middle axis, so both are one batched
// tile transpose (tile_transpose_kernel) with two stride sets: a block
// reads a TILE x TILE tile with its rows along the input's fastest axis,
// keeps it in shared memory with a padded pitch (the column reads fall on
// distinct banks), and writes it with its rows along the output's fastest
// axis, so that both sides move full lines: TILE is 64 for 2-byte
// elements and 32 for 4-byte ones, 128 bytes a row either way. The second
// keeps the fastest axis: it is a copy of whole rows and needs no tile
// (row_permute_kernel), in the widest vectors, up to 16 bytes, that the
// row length and the pointers allow.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 8;  // thread rows per block; a tile takes TILE / ROWS

// out[batch * out_bs + c * out_rs + r] = in[batch * in_bs + r * in_rs + c]
// for r < R, c < Cn, batch = blockIdx.z.
template <typename T, int TILE>
__global__ void tile_transpose_kernel(const T* __restrict__ in,
                                      T* __restrict__ out, int R, int Cn,
                                      size_t in_rs, size_t in_bs,
                                      size_t out_rs, size_t out_bs) {
  constexpr int PITCH = TILE + 4 / sizeof(T);  // an odd number of words
  __shared__ T tile[TILE * PITCH];
  const size_t batch = blockIdx.z;
  const int r0 = blockIdx.y * TILE, c0 = blockIdx.x * TILE;
  const int tx = threadIdx.x;
  const T* src = in + batch * in_bs;
  T* dst = out + batch * out_bs;
  for (int i = threadIdx.y; i < TILE; i += ROWS) {
    const int r = r0 + i, c = c0 + tx;
    if (r < R && c < Cn) tile[i * PITCH + tx] = src[(size_t)r * in_rs + c];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < TILE; i += ROWS) {
    const int c = c0 + i, r = r0 + tx;
    if (r < R && c < Cn) dst[(size_t)c * out_rs + r] = tile[tx * PITCH + i];
  }
}

template <typename T, int TILE>
cudaError_t launch_tile(const void* in, void* out, int R, int Cn, int batches,
                        size_t in_rs, size_t in_bs, size_t out_rs,
                        size_t out_bs, cudaStream_t stream) {
  dim3 grid((Cn + TILE - 1) / TILE, (R + TILE - 1) / TILE, batches);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  tile_transpose_kernel<T, TILE><<<grid, dim3(TILE, ROWS), 0, stream>>>(
      (const T*)in, (T*)out, R, Cn, in_rs, in_bs, out_rs, out_bs);
  return cudaGetLastError();
}

cudaError_t tile_transpose(const void* in, void* out, int esize, int R,
                           int Cn, int batches, size_t in_rs, size_t in_bs,
                           size_t out_rs, size_t out_bs,
                           cudaStream_t stream) {
  if (R < 1 || Cn < 1 || batches < 1) return cudaErrorInvalidValue;
  if (esize == 2)
    return launch_tile<uint16_t, 64>(in, out, R, Cn, batches, in_rs, in_bs,
                                     out_rs, out_bs, stream);
  if (esize == 4)
    return launch_tile<uint32_t, 32>(in, out, R, Cn, batches, in_rs, in_bs,
                                     out_rs, out_bs, stream);
  return cudaErrorInvalidValue;
}

// out[(b * A + a) * n + i] = in[(a * B + b) * n + i], rows of n vectors V.
template <typename V>
__global__ void row_permute_kernel(const V* __restrict__ in,
                                   V* __restrict__ out, int A, int B, int n) {
  const int a = blockIdx.y, b = blockIdx.x;
  const V* src = in + ((size_t)a * B + b) * n;
  V* dst = out + ((size_t)b * A + a) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

template <typename V>
cudaError_t launch_rows(const void* in, void* out, int A, int B,
                        size_t row_bytes, cudaStream_t stream) {
  const int n = (int)(row_bytes / sizeof(V));
  int threads = 32;
  while (threads < n && threads < 256) threads *= 2;
  row_permute_kernel<V><<<dim3(B, A), threads, 0, stream>>>(
      (const V*)in, (V*)out, A, B, n);
  return cudaGetLastError();
}

}  // namespace

// in: (A, D, B) -> out: (B, D, A), elements of esize 2 or 4 bytes.
extern "C" int sdr_transpose_vol(const void* in, void* out, int A, int D,
                                 int B, int esize, void* stream) {
  return (int)tile_transpose(in, out, esize, A, B, D, (size_t)D * B, B,
                             (size_t)D * A, A, (cudaStream_t)stream);
}

// in: (D, H, W) -> out: (W, D, H), elements of esize 2 or 4 bytes.
extern "C" int sdr_transpose_dhw(const void* in, void* out, int D, int H,
                                 int W, int esize, void* stream) {
  return (int)tile_transpose(in, out, esize, H, W, D, W, (size_t)H * W,
                             (size_t)D * H, H, (cudaStream_t)stream);
}

// in: (A, B, W) -> out: (B, A, W), elements of esize 2 or 4 bytes.
extern "C" int sdr_transpose_leading(const void* in, void* out, int A, int B,
                                     int W, int esize, void* stream) {
  if (A < 1 || B < 1 || W < 1 || A > 65535 || (esize != 2 && esize != 4))
    return (int)cudaErrorInvalidValue;
  const size_t row_bytes = (size_t)W * esize;
  const uintptr_t bits = (uintptr_t)in | (uintptr_t)out | row_bytes;
  cudaStream_t s = (cudaStream_t)stream;
  if (bits % 16 == 0) return (int)launch_rows<uint4>(in, out, A, B, row_bytes, s);
  if (bits % 8 == 0) return (int)launch_rows<uint2>(in, out, A, B, row_bytes, s);
  if (bits % 4 == 0)
    return (int)launch_rows<uint32_t>(in, out, A, B, row_bytes, s);
  return (int)launch_rows<uint16_t>(in, out, A, B, row_bytes, s);
}
