// K4 + K5: the speckle filter — connected-component labels, then the keep
// pass that drops components of at most max_size pixels.
//
// K4 replaces stereo_depth_ruler_tpu/ops/sgbm_pallas.py:_speckle_labels_kernel
// (launched by _speckle_labels_batched). The TPU kernel iterates row and
// column segmented-min sweeps until no label changes: data-dependent rounds,
// each a full pass over the map. Here it is union-find in three launches,
// grid.z over frames (two pixels link when both are valid, disp >= 0, and
// |d - d'| <= max_diff):
//   1. tiles: a block owns a tile of TH x TW pixels and loads its
//      disparities into shared memory (16-byte loads where the rows allow).
//      A warp per tile row, 4 pixels a lane, labels every horizontal run
//      with its first pixel (a ballot of the lanes that hold a run start;
//      a run is a tree of depth one, so no horizontal link needs an
//      atomic) and notes the vertical links that the link on their left
//      does not already cover. The lanes unite those in shared memory, and
//      each pixel's label is written once, 16 bytes a lane: the flat index
//      of its tile-local root (H*W for an invalid pixel). Every pixel then
//      points at the root of its piece of the tile, and a piece's root at
//      itself;
//   2. borders: one thread per pixel of a tile's top row (its link to the
//      pixel above) and left column (its link to the pixel on the left)
//      unites the two pieces' trees in device memory, unless a link beside
//      it covers it;
//   3. resolve: each pixel takes the root of its piece's tree, 4 a thread.
// A union hooks the larger root under the smaller with atomicCAS and
// retries from the new roots while another thread got there first (the
// lock-free union of Playne & Hawick, with ECL-CC's CAS hooking and path
// halving), so a parent is always a smaller index of the same component.
// The root of a component is then its smallest flat index whatever the
// order of the atomics: the TPU kernel's labels exactly, with no cap on the
// rounds.
//
// K5 replaces the keep half of the TPU path: the key-only bitonic sort
// (sort_tpu.py:_sort_chunk_single_kernel), the large-run roots
// (sort_tpu.py:_large_roots_kernel) and the OR-propagation
// (sgbm_pallas.py:_propagate_keep_kernel), which together build the mask
// "component size > max_size". Here an int32 histogram of the labels over
// H*W + 1 slots a frame, in three launches, with no memset of it:
//   1. count: a block counts chunks of CHUNK labels, one after another, in
//      a shared-memory hash table (a thread's runs of equal labels go in as
//      one, those that go on in the neighbouring lanes summed over the
//      warp), clears the histogram slot of each distinct label, and writes
//      the chunk's (label, count) list into the chunk's own slots of the
//      output, or marks the chunk as overflowing when the list does not
//      fit; the next chunk's labels are in flight meanwhile;
//   2. add: a warp per chunk adds the list into the histogram (atomicAdd),
//      or counts an overflowing chunk's labels again itself;
//   3. apply: out = size[label] > max_size ? disp : -1, overwriting the
//      lists.
// A slot is cleared in launch 1 and added to in launch 2, so only the slots
// that labels name are touched. Integer atomics: deterministic.
//
// What bounds them on the H100: device-memory bytes, 8 B/px for K4 (disp
// in, labels out) and 12 B/px for K5 (disp and labels in, disp out). Each
// moves about 16 B/px: K4's resolve reads the labels again and writes the
// changed ones, K5's count reads the labels. The unions' pointer chasing
// and the histogram's atomics run in shared memory or L2. K4's tile launch
// is bound by its phases' latency and instructions (load, runs, unions,
// roots, between barriers), not by its bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

constexpr int TH = 32;    // K4 tile rows
constexpr int TW = 128;   // K4 tile columns: 4 a lane
constexpr int TILE = TH * TW;
static_assert(TH % (THREADS / 32) == 0 && TH <= 8 * (THREADS / 32),
              "a warp owns at most 8 rows of a tile (32 bits of links)");
constexpr int NONE = 0x7fffffff;  // tile-local label of an invalid pixel

constexpr int CHUNK = 8 * THREADS;  // labels per K5 count block
constexpr int LOG_SLOTS = 11;       // its hash table
constexpr int SLOTS = 1 << LOG_SLOTS;
constexpr int EMPTY = -1;
static_assert(SLOTS >= CHUNK, "a chunk's distinct labels fit the table");

__device__ __forceinline__ bool linked(float v, float u, float max_diff) {
  return u >= 0.0f && fabsf(__fsub_rn(v, u)) <= max_diff;
}

// A parent is always a smaller index of the same component (a pixel starts
// at its run's first pixel; a root is hooked only under a smaller root;
// compression points a node at an ancestor), so a node p is a root exactly
// when L[p] is not below p, and a walk ends. Plain loads: a value read late
// or from a stale cache line is still an ancestor, which is all a walk
// needs, and volatile loads of device memory are slow.

// The resolve's walk, after the last union: the forest no longer changes
// but for pixels taking their roots.
__device__ __forceinline__ int find_root(const int* L, int x) {
  int p = L[x];
  while (p != x) {
    x = p;
    p = L[x];
  }
  return x;
}

// A label load of the unions: from L2 in device memory (ld.global.cg, past
// the SM's own cache, so that the walks see other blocks' compression and
// stay short), plain in shared memory.
template <bool Global>
__device__ __forceinline__ int load(const int* p) {
  if constexpr (Global) return __ldcg(p);
  return *p;
}

// The unions' walk, pointing each node it passes at its grandparent (path
// halving, as ECL-CC's intermediate pointer jumping): a plain store of an
// ancestor, which other threads' walks and hooks tolerate. Only while
// labels are not final: a resolve must not move another pixel's label.
template <bool Global>
__device__ __forceinline__ int find_compress(int* L, int x) {
  int p = load<Global>(L + x);
  if (p == x) return x;
  for (int next; p > (next = load<Global>(L + p)); x = p, p = next)
    L[x] = next;
  return p;
}

// Hooks the larger root under the smaller with atomicCAS, retrying from
// the new roots while another thread got there first, so only roots are
// ever hooked (Playne & Hawick's lock-free union, ECL-CC's CAS hooking).
// The CAS reads the truth; the larger of the two roots falls with every
// retry, so the loop ends.
template <bool Global>
__device__ __forceinline__ void unite(int* L, int a, int b) {
  a = find_compress<Global>(L, a);
  b = find_compress<Global>(L, b);
  while (a != b) {
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicCAS(&L[b], b, a);
    if (old == b) return;  // b was a root and now hangs under a
    b = find_compress<Global>(L, old);  // b was hooked meanwhile
    a = find_compress<Global>(L, a);
  }
}

// A vertical link (v at i, u above it) that the link on its left already
// covers: the left neighbour is in v's run, the upper-left one in u's, and
// the two are linked, so uniting the left pair joined these runs too.
__device__ __forceinline__ bool covered(float v, float u, float l, float ul,
                                        float max_diff) {
  return linked(v, l, max_diff) && linked(u, ul, max_diff) &&
         linked(l, ul, max_diff);
}

// Grid (tiles_x * tiles_y, 1, B); a warp per tile row, 4 pixels a lane.
// Within a tile the local index ty*TW + tx orders the pixels as the flat
// index (y0 + ty)*W + x0 + tx does: both are row-major in (ty, tx), since a
// tile row holds at most TW pixels and, where the frame clips the tile, at
// most W - x0 <= W. So the smallest local index of a piece, its tile-local
// root, is also the smallest flat index of the piece, and the unions of
// launch 2 see the same order.
__global__ void __launch_bounds__(THREADS)
labels_tiles(const float* __restrict__ disp, int* __restrict__ lab, int H,
             int W, int tiles_x, float max_diff, bool vec) {
  __shared__ __align__(16) float ds[TILE];
  __shared__ __align__(16) int ls[TILE];
  constexpr int ROWS = TH / (THREADS / 32);  // rows a warp owns
  const int x0 = (int)(blockIdx.x % tiles_x) * TW;
  const int y0 = (int)(blockIdx.x / tiles_x) * TH;
  const int tw = min(TW, W - x0), th = min(TH, H - y0);
  const int n = H * W;
  const size_t origin = (size_t)blockIdx.z * n + (size_t)y0 * W + x0;
  const float* d = disp + origin;
  for (int k = threadIdx.x; k < th * (TW / 4); k += THREADS) {
    const int ty = k / (TW / 4), tx = k % (TW / 4) * 4;
    const float* row = d + (size_t)ty * W + tx;
    float4 v = make_float4(-1.0f, -1.0f, -1.0f, -1.0f);
    if (tx < tw) {
      if (vec) {  // W % 4 == 0, disp and labels 16-byte aligned: tw % 4 == 0
        v = __ldg((const float4*)row);
      } else {
        v.x = __ldg(row);
        if (tx + 1 < tw) v.y = __ldg(row + 1);
        if (tx + 2 < tw) v.z = __ldg(row + 2);
        if (tx + 3 < tw) v.w = __ldg(row + 3);
      }
    }
    *(float4*)&ds[ty * TW + tx] = v;
  }
  __syncthreads();

  // row runs: a pixel's label is its run's first pixel. Each lane also
  // notes its vertical links that the link on their left does not cover
  // (bit 4k + j of todo: pixel px + j of the warp's row k): the left
  // neighbour is in its run, the upper-left one in the upper pixel's, and
  // the two are linked, so uniting the left pair joins these runs too. In
  // the first column the left neighbour lies in another tile, and nothing
  // there counts as covered.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, px = 4 * lane;
  unsigned todo = 0;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int ty = warp + k * (THREADS / 32);
    if (ty >= th) break;
    const int i = ty * TW + px;
    const float4 v4 = *(const float4*)&ds[i];
    const float4 u4 = ty > 0 ? *(const float4*)&ds[i - TW]
                             : make_float4(-1.0f, -1.0f, -1.0f, -1.0f);
    const float v[4] = {v4.x, v4.y, v4.z, v4.w};
    const float u[4] = {u4.x, u4.y, u4.z, u4.w};
    const float vl = __shfl_up_sync(FULL, v[3], 1);
    const float ul = __shfl_up_sync(FULL, u[3], 1);
    bool left[4], up[4];
    int last = -1;  // the lane's last pixel that starts a run
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool valid = v[j] >= 0.0f;
      left[j] = valid && (j > 0 || lane > 0) &&
                linked(v[j], j > 0 ? v[j - 1] : vl, max_diff);
      up[j] = valid && linked(v[j], u[j], max_diff);
      if (!left[j]) last = j;
    }
    const bool up_left3 = __shfl_up_sync(FULL, up[3], 1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool cov = left[j] && (j > 0 ? up[j - 1] : up_left3) &&
                       linked(u[j], j > 0 ? u[j - 1] : ul, max_diff);
      todo |= (unsigned)(up[j] && !cov) << (4 * k + j);
    }
    // a lane whose pixels all continue a run takes its start from the
    // nearest lane below that holds a run start (lane 0 always does)
    const unsigned starts = __ballot_sync(FULL, last >= 0);
    const unsigned below = starts & ((1u << lane) - 1);
    int start = __shfl_sync(FULL, px + last, below ? 31 - __clz(below) : 0);
    int l4[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!left[j]) start = px + j;
      l4[j] = v[j] >= 0.0f ? ty * TW + start : NONE;
    }
    *(int4*)&ls[i] = make_int4(l4[0], l4[1], l4[2], l4[3]);
  }
  __syncthreads();

  // the vertical links inside the tile; a lane runs its own, so the warp
  // waits for as many unions as its busiest lane has
  for (; todo; todo &= todo - 1) {
    const int b = __ffs(todo) - 1;
    const int i = (warp + (b >> 2) * (THREADS / 32)) * TW + px + (b & 3);
    unite<false>(ls, i, i - TW);
  }
  __syncthreads();

  // each pixel's tile-local root as a flat index, written once
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int ty = warp + k * (THREADS / 32);
    if (ty >= th) break;
    const int4 l4 = *(const int4*)&ls[ty * TW + px];
    const int l[4] = {l4.x, l4.y, l4.z, l4.w};
    int r[4], prev = NONE, root = n;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (l[j] != prev && l[j] != NONE) {
        const int f = find_compress<false>(ls, l[j]);
        root = (y0 + f / TW) * W + x0 + f % TW;
      }
      prev = l[j];
      r[j] = l[j] == NONE ? n : root;
    }
    int* L = lab + origin + (size_t)ty * W + px;
    if (vec && px < tw) {
      *(int4*)L = make_int4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (px + j < tw) L[j] = r[j];
    }
  }
}

// Grid (ceil(links / THREADS), 1, B): the top rows of the tile rows 1..,
// then the left columns of the tile columns 1..
__global__ void labels_borders(const float* __restrict__ disp, int* lab,
                               int H, int W, int tiles_x, int tiles_y,
                               float max_diff) {
  const long long j = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long n_top = (long long)(tiles_y - 1) * W;
  if (j >= n_top + (long long)(tiles_x - 1) * H) return;
  const size_t frame = (size_t)blockIdx.z * H * W;
  const float* d = disp + frame;
  int i, o;  // the pixel and its neighbour across the border
  if (j < n_top) {
    const int x = (int)(j % W);
    i = (int)(j / W + 1) * TH * W + x;
    o = i - W;
    const float v = d[i];
    if (!(v >= 0.0f) || !linked(v, d[o], max_diff)) return;
    // the link on the left is a border link too, of this tile or the
    // one on the left, so the skip is sound along the whole row
    if (x > 0 && covered(v, d[o], d[i - 1], d[o - 1], max_diff)) return;
  } else {
    const long long k = j - n_top;
    const int y = (int)(k % H);
    i = y * W + (int)(k / H + 1) * TW;
    o = i - 1;
    const float v = d[i];
    if (!(v >= 0.0f) || !linked(v, d[o], max_diff)) return;
    // below a tile's top row, the border link above and the two tile
    // links between cover this one (never on a top row, whose links the
    // skip above relies on)
    if (y % TH != 0 && covered(v, d[o], d[i - W], d[o - W], max_diff))
      return;
  }
  unite<true>(lab + frame, i, o);
}

// Each pixel's final label, four a thread where the rows allow (their
// walks then overlap); only the owner writes a pixel, so the walks do not
// compress.
__global__ void labels_resolve(int* lab, int n, bool vec) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  int* L = lab + (size_t)blockIdx.z * n;
  if (vec) {
    if (t >= n / 4) return;
    const int4 l = ((const int4*)L)[t];
    int4 r;  // a label equal to its left neighbour's has the same root
    r.x = l.x == n ? n : find_root(L, l.x);
    r.y = l.y == l.x ? r.x : l.y == n ? n : find_root(L, l.y);
    r.z = l.z == l.y ? r.y : l.z == n ? n : find_root(L, l.z);
    r.w = l.w == l.z ? r.z : l.w == n ? n : find_root(L, l.w);
    if (r.x != l.x || r.y != l.y || r.z != l.z || r.w != l.w)
      ((int4*)L)[t] = r;
    return;
  }
  if (t >= n) return;
  const int l = L[t];
  if (l == n) return;  // invalid
  const int r = find_root(L, l);
  if (r != l) L[t] = r;
}

// Adds c to key's count in a shared-memory hash table with linear probing
// (a new key always finds a free slot: a chunk has at most CHUNK <= SLOTS
// distinct labels); a key's first insert notes its slot in `used`.
__device__ __forceinline__ void table_add(int* keys, int* counts, int* used,
                                          int* n_used, int key, int c) {
  unsigned h = ((unsigned)key * 2654435761u) >> (32 - LOG_SLOTS);
  while (true) {
    int k = keys[h];
    if (k == EMPTY) {
      k = atomicCAS(&keys[h], EMPTY, key);
      if (k == EMPTY) {
        used[atomicAdd(n_used, 1)] = h;
        k = key;
      }
    }
    if (k == key) {
      atomicAdd(&counts[h], c);
      return;
    }
    h = (h + 1) & (SLOTS - 1);
  }
}

// A thread's 8 labels of a chunk (n past the frame's end).
__device__ __forceinline__ void load8(const int* L, int chunk, int n,
                                      bool vec, int* l8) {
  const int p0 = chunk * CHUNK + threadIdx.x * 8;
  if (vec && p0 + 8 <= n) {  // n % 4 == 0 and labels 16-byte aligned
    const int4 u = __ldg((const int4*)(L + p0));
    const int4 w = __ldg((const int4*)(L + p0 + 4));
    l8[0] = u.x, l8[1] = u.y, l8[2] = u.z, l8[3] = u.w;
    l8[4] = w.x, l8[5] = w.y, l8[6] = w.z, l8[7] = w.w;
  } else {
    for (int j = 0; j < 8; ++j) l8[j] = p0 + j < n ? __ldg(L + p0 + j) : n;
  }
}

// Grid (blocks per frame, 1, B); a block counts the chunks blockIdx.x,
// blockIdx.x + gridDim.x, ... of its frame. The table is cleared once and
// then slot by slot as its entries go out. lists: the output buffer; a
// chunk's m slots take its list's length (-1: overflow) and (label, count)
// pairs.
__global__ void __launch_bounds__(THREADS)
keep_count(const int* __restrict__ lab, int* __restrict__ sizes,
           int* __restrict__ lists, int n, int chunks, bool vec) {
  __shared__ int keys[SLOTS];
  __shared__ int counts[SLOTS];
  __shared__ int used[CHUNK];
  __shared__ int n_used;
  for (int k = threadIdx.x; k < SLOTS; k += THREADS) {
    keys[k] = EMPTY;
    counts[k] = 0;
  }
  if (threadIdx.x == 0) n_used = 0;
  const size_t b = blockIdx.z;
  int* S = sizes + b * (n + 1);
  // 8 consecutive labels a thread; label n (invalid) is not counted. The
  // next chunk's are in flight while this one is counted.
  int l8[8], next[8];
  if ((int)blockIdx.x < chunks) load8(lab + b * n, blockIdx.x, n, vec, l8);
  for (int chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x) {
    const int c0 = chunk * CHUNK, m = min(CHUNK, n - c0);
    if (chunk + (int)gridDim.x < chunks)
      load8(lab + b * n, chunk + gridDim.x, n, vec, next);
    __syncthreads();  // the table is clear and n_used is 0
    // the runs of equal labels among the 8: a middle run goes in alone;
    // the first and the last may go on in the neighbouring lanes, so they
    // go in summed over the lanes of the warp that hold the same label
    int first = n, n_first = 0, run = n, cnt = 0;
    for (int j = 0; j < 8; ++j) {
      if (l8[j] == run) {
        ++cnt;
        continue;
      }
      if (cnt > 0 && n_first == 0) {
        first = run;
        n_first = cnt;
      } else if (cnt > 0 && run != n) {
        table_add(keys, counts, used, &n_used, run, cnt);
      }
      run = l8[j];
      cnt = 1;
    }
    // the first runs where some lane has two runs or more, then the last
    const int first_pass = __any_sync(FULL, n_first > 0) ? 0 : 1;
    for (int pass = first_pass; pass < 2; ++pass) {
      const int key = pass ? run : first, c = pass ? cnt : n_first;
      const unsigned peers = __match_any_sync(FULL, key);
      const int total = (int)__reduce_add_sync(peers, (unsigned)c);
      if (key != n && (threadIdx.x & 31) == __ffs(peers) - 1)
        table_add(keys, counts, used, &n_used, key, total);
    }
    __syncthreads();

    int* list = lists + b * n + c0;
    const int len = n_used, cap = (m - 1) / 2;
    for (int j = threadIdx.x; j < len; j += THREADS) {
      const int h = used[j], key = keys[h];
      S[key] = 0;
      if (len <= cap) {
        list[1 + 2 * j] = key;
        list[2 + 2 * j] = counts[h];
      }
      keys[h] = EMPTY;
      counts[h] = 0;
    }
    if (threadIdx.x == 0) list[0] = len <= cap ? len : -1;
    __syncthreads();  // every thread has read n_used
    if (threadIdx.x == 0) n_used = 0;
    for (int j = 0; j < 8; ++j) l8[j] = next[j];
  }
}

// Grid (ceil(chunks / warps per block), 1, B): a warp per chunk.
__global__ void keep_add(const int* __restrict__ lab, int* sizes,
                         const int* __restrict__ lists, int n, int chunks) {
  const int chunk = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (chunk >= chunks) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const size_t b = blockIdx.z;
  const int c0 = chunk * CHUNK, m = min(CHUNK, n - c0);
  int* S = sizes + b * (n + 1);
  const int* list = lists + b * n + c0;
  const int len = list[0];
  if (len >= 0) {
    for (int j = lane; j < len; j += 32)
      atomicAdd(&S[list[1 + 2 * j]], list[2 + 2 * j]);
    return;
  }
  // overflow: a warp-aggregated atomic per distinct label of 32 (every
  // lane takes part: CHUNK is a multiple of 32)
  const int* L = lab + b * n + c0;
  for (int p = lane; p < CHUNK; p += 32) {
    int l = p < m ? L[p] : n;
    if (l == n) l = -1;
    const unsigned peers = __match_any_sync(FULL, l);
    if (l >= 0 && lane == __ffs(peers) - 1) atomicAdd(&S[l], __popc(peers));
  }
}

__global__ void keep_apply(const float* __restrict__ disp,
                           const int* __restrict__ lab,
                           const int* __restrict__ sizes,
                           float* __restrict__ out, int n, int max_size,
                           bool vec) {
  const size_t b = blockIdx.z;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const int* S = sizes + b * (n + 1);
  if (vec) {  // four pixels a thread
    if (i >= n / 4) return;
    const int4 l = __ldg((const int4*)(lab + b * n) + i);
    const float4 d = __ldg((const float4*)(disp + b * n) + i);
    float4 o;
    o.x = l.x < n && __ldg(S + l.x) > max_size ? d.x : -1.0f;
    o.y = l.y < n && __ldg(S + l.y) > max_size ? d.y : -1.0f;
    o.z = l.z < n && __ldg(S + l.z) > max_size ? d.z : -1.0f;
    o.w = l.w < n && __ldg(S + l.w) > max_size ? d.w : -1.0f;
    ((float4*)(out + b * n))[i] = o;
    return;
  }
  if (i >= n) return;
  const int l = lab[b * n + i];
  const bool keep = l < n && __ldg(S + l) > max_size;
  out[b * n + i] = keep ? disp[b * n + i] : -1.0f;
}

bool bad_shape(int B, int H, int W) {
  return B < 1 || H < 1 || W < 1 || B > 65535 ||
         (long long)H * W >= (1LL << 31) - 1;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

int blocks(long long work, int per_block) {
  return (int)((work + per_block - 1) / per_block);
}

// K4's launches first..last (0 tiles, 1 borders, 2 resolve).
int labels_parts(const float* disp, int* labels, int B, int H, int W,
                 float max_diff, int first, int last, cudaStream_t s) {
  if (bad_shape(B, H, W) || first < 0 || last > 2 || first > last)
    return (int)cudaErrorInvalidValue;
  const int n = H * W;
  const int tiles_x = blocks(W, TW), tiles_y = blocks(H, TH);
  const bool rvec = n % 4 == 0 && aligned16(labels);
  const bool vec = W % 4 == 0 && aligned16(disp) && aligned16(labels);
  const long long links =
      (long long)(tiles_y - 1) * W + (long long)(tiles_x - 1) * H;
  for (int part = first; part <= last; ++part) {
    if (part == 0)
      labels_tiles<<<dim3(tiles_x * tiles_y, 1, B), THREADS, 0, s>>>(
          disp, labels, H, W, tiles_x, max_diff, vec);
    else if (part == 1 && links > 0)
      labels_borders<<<dim3(blocks(links, THREADS), 1, B), THREADS, 0, s>>>(
          disp, labels, H, W, tiles_x, tiles_y, max_diff);
    else if (part == 2)
      labels_resolve<<<dim3(blocks(rvec ? n / 4 : n, THREADS), 1, B),
                       THREADS, 0, s>>>(labels, n, rvec);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// K5's launches first..last (0 count, 1 add, 2 apply).
int keep_parts(const float* disp, const int* labels, int* sizes, float* out,
               int B, int H, int W, int max_size, int first, int last,
               cudaStream_t s) {
  if (bad_shape(B, H, W) || first < 0 || last > 2 || first > last)
    return (int)cudaErrorInvalidValue;
  const int n = H * W, chunks = blocks(n, CHUNK);
  const bool vec = n % 4 == 0 && aligned16(disp) && aligned16(labels) &&
                   aligned16(out);
  int* lists = (int*)out;
  // about four waves of count blocks in all (8 fit on an SM), so that each
  // clears its table once for a few chunks
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int per_frame = min(chunks, blocks(32LL * sms, B));
  for (int part = first; part <= last; ++part) {
    if (part == 0)
      keep_count<<<dim3(per_frame, 1, B), THREADS, 0, s>>>(
          labels, sizes, lists, n, chunks, vec);
    else if (part == 1)
      keep_add<<<dim3(blocks(chunks, THREADS / 32), 1, B), THREADS, 0, s>>>(
          labels, sizes, lists, n, chunks);
    else
      keep_apply<<<dim3(blocks(vec ? n / 4 : n, THREADS), 1, B), THREADS, 0,
                   s>>>(disp, labels, sizes, out, n, max_size, vec);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// disp: (B, H, W) float32, invalid < 0; labels: (B, H, W) int32 out.
extern "C" int sdr_speckle_labels(const float* disp, int* labels, int B,
                                  int H, int W, float max_diff,
                                  void* stream) {
  return labels_parts(disp, labels, B, H, W, max_diff, 0, 2,
                      (cudaStream_t)stream);
}

// disp, labels: (B, H, W); sizes: (B, H*W + 1) int32 scratch, any content;
// out: (B, H, W) float32, disp where the component is larger than max_size.
extern "C" int sdr_speckle_keep(const float* disp, const int* labels,
                                int* sizes, float* out, int B, int H, int W,
                                int max_size, void* stream) {
  return keep_parts(disp, labels, sizes, out, B, H, W, max_size, 0, 2,
                    (cudaStream_t)stream);
}

// One launch of each, for a timing split with events between them.
extern "C" int sdr_speckle_labels_part(const float* disp, int* labels, int B,
                                       int H, int W, float max_diff, int part,
                                       void* stream) {
  return labels_parts(disp, labels, B, H, W, max_diff, part, part,
                      (cudaStream_t)stream);
}

extern "C" int sdr_speckle_keep_part(const float* disp, const int* labels,
                                     int* sizes, float* out, int B, int H,
                                     int W, int max_size, int part,
                                     void* stream) {
  return keep_parts(disp, labels, sizes, out, B, H, W, max_size, part, part,
                    (cudaStream_t)stream);
}
