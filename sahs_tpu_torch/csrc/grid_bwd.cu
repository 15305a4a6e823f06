// K4, K9 and K10: dGrid, the gradient of the trilinear spatial-embedding
// sample with respect to the (C, D, H, W) grid; K10 also the coordinates'.
//
// Replaces, in sahs_tpu/ops/pallas/grid_bwd.py:
// - K4 grid_dg_slab_packed (:211, pallas_call at :327): the fused train
//   path's dGrid, once a step over the sorted fine points with the coarse
//   cotangents as a second input, each point's cell given as its
//   corner-table row (from K1);
// - K9 grid_dg_slab (:103, pallas_call at :191): the autograd fallback's
//   dGrid from raw coordinates and one cotangent; the cell is formed here
//   with sahs::cell_row, ops/grid._cell_geometry's exact expression;
// - K10 grid_bwd_fused (:343, pallas_call at :415): the backward of
//   ops/grid.grid_sample_3d, dG and the coordinates' cotangent dcoords from
//   the corner rows vals (P, 8C) that the forward gathered.
// All three compute
//     dG[c, z, y, x] = sum_p w_corner(p) * g[p, c]
// over the 8 corners of each point's cell that lie inside the grid (zeros
// padding; a point outside the band adds nothing). K4 takes g = gse + gse2.
// K10 in bf16 rounds the axis weights, g, Az Ay and Ax g to bf16 before
// their float32 product (grid_bwd.py:375-384), and its dcoords are gated by
// the whole cell's band and scaled by (n - 1) / 2 (grid_bwd.py:392-413).
// The TPU kernels contracted dense one-hot axis weights on the MXU, z-slab
// by z-slab, because Mosaic has no scatter.
//
// Bound on the H100: bytes. The routine must read each point's coordinates
// and cotangent once and write the grid once: at a step's 262,144 fine
// points (C = 32, 32^3 grid) ~40 MB (K4's addend ~33 MB more), ~0.012-0.023
// ms at 3.35 TB/s; K10 also reads vals (8C bf16 a point), ~0.26 GB at the
// per-point step's 393,216 points, ~0.08 ms.
//
// Design. Adding each point's 8 corners to the grid with float atomics
// (8 P C of them, resolved in L2) is what a scatter waits on, and the sum's
// order changes from run to run. Here the points are binned by cell and
// each voxel is summed in one place, in a fixed order:
//   1. dg_cells_kernel reads each point's coordinates once and forms its
//      key: its cell (a row of the (D+1)(H+1)(W+1) corner table) or, out of
//      the band, `ncells` ("none"). It counts the points of each cell (P
//      integer atomics, one per group of equal keys in a warp), the first
//      radix digit's histogram of its 2048-point tile and every pass's
//      digit totals.
//   2. A stable LSD radix sort of the keys, 8 bits a pass (two passes for
//      35,937 cells), orders the point indices by cell and, within a cell,
//      by index: dg_hist_kernel (a later pass's tile histograms),
//      dg_tile_offsets_kernel (a block a digit scans that digit's counts
//      over the tiles, from the totals' scan: each tile's digit offsets,
//      in work linear in the tiles) and dg_scatter_kernel, which ranks its
//      tile's keys in order, each warp 32 at a time with __match_any_sync,
//      warps in order.
//   3. dg_cell_sums_kernel and dg_cell_offsets_kernel turn the counts into
//      each cell's segment and its chunks of CHUNK points (two launches of
//      2048-cell tiles); dg_chunk_kernel gives each chunk a warp, which
//      sums the chunk's points in index order into the 8 corners' partial
//      sums (LP lanes a point, 16-byte loads of g where C allows, 32 / LP
//      points at a time, added across lanes in a fixed tree);
//      dg_voxel_kernel writes each voxel once, summing the partials of the
//      <= 8 cells whose corner it is, eight threads a voxel, in a fixed
//      order of corners and chunks.
// No float atomics, no zero fill of the grid, the same bits on every run,
// and a hot cell is split into chunks instead of serialising one warp.
// K10's dcoords (dg_dcoords_kernel) take eight threads a point, one a
// corner: each its corner's dot product of vals and g, 16 bytes a load,
// times its weight products; the eight add the three sums.
#include <stdint.h>

#include "mlp.cuh"

namespace {

constexpr int RADIX = 256;                          // 8-bit digits
constexpr int MAX_PASSES = 4;                       // 32-bit keys at most
constexpr int SORT_THREADS = 256;                   // eight warps
constexpr int SORT_ROUNDS = 8;                      // rounds of 32 keys a warp
constexpr int WARP_KEYS = SORT_ROUNDS * 32;         // 256
constexpr int SORT_TILE = SORT_THREADS * SORT_ROUNDS;   // 2048 keys a block
constexpr int CELL_ITEMS = 8;                       // cells a thread of a scan
constexpr int CELL_TILE = SORT_THREADS * CELL_ITEMS;    // 2048 cells a block
constexpr int CHUNK = 32;                           // points a phase-3 warp sums
static_assert(SORT_THREADS == RADIX, "a thread a digit");

// What the wrappers size their scratch by (sahs_grid_scratch): keys and
// point indices twice (the sort's two buffers), the tiles' digit
// histograms, the cells' counts and each pass's digit totals (zeroed
// together), the segments' and the chunks' offsets, the cell tiles' sums,
// each chunk's cell; and the chunks' partial sums, 8 corners x C floats
// each.
long long tiles(long long P) { return (P + SORT_TILE - 1) / SORT_TILE; }
long long cell_tiles(int ncells) { return (ncells + CELL_TILE - 1) / CELL_TILE; }
long long max_chunks(long long P, int ncells) {
  return (P + CHUNK - 1) / CHUNK + (P < ncells ? P : ncells);
}
long long scratch_ints(long long P, int ncells) {
  return 4 * P + RADIX * tiles(P) + ncells + MAX_PASSES * RADIX +
         2 * ((long long)ncells + 1) + 2 * cell_tiles(ncells) + max_chunks(P, ncells);
}

// 0, or cudaErrorInvalidValue for a shape the routine does not take; the
// cells' count in *ncells.
int shape_error(long long P, int C, int D, int H, int W, int* ncells) {
  const long long ncl = (long long)(D + 1) * (H + 1) * (W + 1);
  if (P < 0 || P > INT32_MAX || C <= 0 || D <= 0 || H <= 0 || W <= 0 ||
      ncl >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  *ncells = (int)ncl;
  return 0;
}

// The cell and its fractions of the point at x (sahs::cell_index, the
// exact expression of ops/grid._cell_geometry): fr per axis (x, y, z), and
// whether the floor lies in [-1, n - 1] on every axis.
__device__ __forceinline__ bool cell_fracs(const float* x, int D, int H, int W,
                                           float fr[3]) {
  const int dims[3] = {W, H, D};
  bool ok = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float i = sahs::cell_index(x[a], dims[a]);
    const float i0 = floorf(i);
    fr[a] = __fsub_rn(i, i0);
    ok = ok && (i0 >= -1.0f) && (i0 <= (float)(dims[a] - 1));
  }
  return ok;
}

__device__ __forceinline__ int point_key(const float* x, const int* rows,
                                         long long p, int D, int H, int W,
                                         int ncells) {
  float fr[3];
  if (!cell_fracs(x, D, H, W, fr)) return ncells;
  const int row = rows != nullptr ? rows[p] : sahs::cell_row(x, D, H, W);
  return (row >= 0 && row < ncells) ? row : ncells;
}

// Phase 1: keys, counts, the first digit's histogram of the tile
// (block-major: hist[tile][digit]) and every pass's digit totals.
__global__ void dg_cells_kernel(const float* __restrict__ x,
                                const int* __restrict__ rows, long long P,
                                int PW, int D, int H, int W, int ncells,
                                int passes, int* __restrict__ keys,
                                int* __restrict__ count, int* __restrict__ hist,
                                int* __restrict__ totals) {
  __shared__ int h[MAX_PASSES][RADIX];
  for (int q = 0; q < passes; ++q) h[q][threadIdx.x] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * SORT_TILE;
  for (int r = 0; r < SORT_ROUNDS; ++r) {
    const long long p = base + r * SORT_THREADS + threadIdx.x;
    const int key = p < P ? point_key(x + p * PW, rows, p, D, H, W, ncells) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    if (key >= 0) {
      keys[p] = key;
      for (int q = 0; q < passes; ++q) atomicAdd(&h[q][(key >> (8 * q)) & (RADIX - 1)], 1);
      if (key < ncells && (int)(threadIdx.x % 32) == __ffs(peers) - 1)
        atomicAdd(count + key, __popc(peers));
    }
  }
  __syncthreads();
  hist[(long long)blockIdx.x * RADIX + threadIdx.x] = h[0][threadIdx.x];
  for (int q = 0; q < passes; ++q)
    if (h[q][threadIdx.x] != 0) atomicAdd(totals + q * RADIX + threadIdx.x, h[q][threadIdx.x]);
}

// A later pass's digit histogram of the tile.
__global__ void dg_hist_kernel(const int* __restrict__ keys, long long P,
                               int shift, int* __restrict__ hist) {
  __shared__ int h[RADIX];
  h[threadIdx.x] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * SORT_TILE;
  for (int r = 0; r < SORT_ROUNDS; ++r) {
    const long long i = base + r * SORT_THREADS + threadIdx.x;
    if (i < P) atomicAdd(&h[(keys[i] >> shift) & (RADIX - 1)], 1);
  }
  __syncthreads();
  hist[(long long)blockIdx.x * RADIX + threadIdx.x] = h[threadIdx.x];
}

// Exclusive prefix sum of v over the block, in thread order; *total gets
// the block's sum. Every thread of the block calls it.
__device__ int block_scan(int v, int* ws, int* total) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int nw = blockDim.x / 32;
  int s = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += t;
  }
  if (lane == 31) ws[w] = s;
  __syncthreads();
  if (w == 0) {
    int u = lane < nw ? ws[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, u, o);
      if (lane >= o) u += t;
    }
    ws[lane] = u;
  }
  __syncthreads();
  const int before = (w > 0 ? ws[w - 1] : 0) + s - v;
  *total = ws[nw - 1];
  __syncthreads();
  return before;
}

// A pass's digit offsets, in place: hist[tile][digit], the tiles' counts,
// becomes where each tile's first key of each digit goes, the keys of
// smaller digits (the pass's totals, scanned) plus those of the same digit
// in earlier tiles. Block d scans digit d's column, SORT_THREADS tiles at
// a time: each count is read and written once.
__global__ void dg_tile_offsets_kernel(int* __restrict__ hist, long long nb,
                                       const int* __restrict__ totals) {
  __shared__ int ws[32];
  __shared__ int start;
  const int d = blockIdx.x;
  int all;
  const int before = block_scan(totals[threadIdx.x], ws, &all);   // thread t: digit t
  if ((int)threadIdx.x == d) start = before;
  __syncthreads();
  int carry = start;
  for (long long b0 = 0; b0 < nb; b0 += SORT_THREADS) {
    const long long b = b0 + threadIdx.x;
    const int c = b < nb ? hist[b * RADIX + d] : 0;
    int tile_sum;
    const int ex = block_scan(c, ws, &tile_sum);
    if (b < nb) hist[b * RADIX + d] = carry + ex;
    carry += tile_sum;
  }
}

// The cells' counts in tiles of CELL_TILE: thread t takes the CELL_ITEMS
// cells from tile + CELL_ITEMS t. dg_cell_sums_kernel writes each tile's
// points and chunks; dg_cell_offsets_kernel each cell's segment offset and
// chunk offset (sums over the cells before it) and, for each of its
// chunks, the cell (chunk_cell), and the totals at index ncells.
__global__ void dg_cell_sums_kernel(const int* __restrict__ count, int ncells,
                                    int* __restrict__ sums) {
  __shared__ int ws[32];
  const int c0 = blockIdx.x * CELL_TILE + threadIdx.x * CELL_ITEMS;
  int n = 0, nch = 0;
#pragma unroll
  for (int k = 0; k < CELL_ITEMS; ++k) {
    const int v = c0 + k < ncells ? count[c0 + k] : 0;
    n += v;
    nch += (v + CHUNK - 1) / CHUNK;
  }
  int tn, tch;
  block_scan(n, ws, &tn);
  block_scan(nch, ws, &tch);
  if (threadIdx.x == 0) {
    sums[2 * blockIdx.x] = tn;
    sums[2 * blockIdx.x + 1] = tch;
  }
}

__global__ void dg_cell_offsets_kernel(const int* __restrict__ count, int ncells,
                                       const int* __restrict__ sums,
                                       int* __restrict__ off,
                                       int* __restrict__ chunk_off,
                                       int* __restrict__ chunk_cell) {
  __shared__ int ws[32];
  int mine = 0, mine2 = 0;                  // the earlier tiles, a share a thread
  for (int b = threadIdx.x; b < (int)blockIdx.x; b += blockDim.x) {
    mine += sums[2 * b];
    mine2 += sums[2 * b + 1];
  }
  int carry, carry2;
  block_scan(mine, ws, &carry);
  block_scan(mine2, ws, &carry2);
  const int c0 = blockIdx.x * CELL_TILE + threadIdx.x * CELL_ITEMS;
  int v[CELL_ITEMS], n = 0, nch = 0;
#pragma unroll
  for (int k = 0; k < CELL_ITEMS; ++k) {
    v[k] = c0 + k < ncells ? count[c0 + k] : 0;
    n += v[k];
    nch += (v[k] + CHUNK - 1) / CHUNK;
  }
  int tn, tch;
  int run = carry + block_scan(n, ws, &tn);
  int run2 = carry2 + block_scan(nch, ws, &tch);
#pragma unroll
  for (int k = 0; k < CELL_ITEMS; ++k) {
    const int c = c0 + k;
    if (c < ncells) {
      off[c] = run;
      chunk_off[c] = run2;
    }
    const int m = (v[k] + CHUNK - 1) / CHUNK;
    for (int i = 0; i < m; ++i) chunk_cell[run2 + i] = c;
    run += v[k];
    run2 += m;
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
    off[ncells] = carry + tn;
    chunk_off[ncells] = carry2 + tch;
  }
}

// One stable pass of the sort: keys_in / vals_in (null: the identity) to
// their places by the digit at `shift`, from the tile's digit offsets
// (offs[tile][digit], dg_tile_offsets_kernel). Warp w ranks the keys
// [tile + 256 w, tile + 256 (w + 1)) in order, 32 at a time; warps then
// take their bases in warp order.
__global__ void dg_scatter_kernel(const int* __restrict__ keys_in,
                                  const int* __restrict__ vals_in, long long P,
                                  int shift, const int* __restrict__ offs,
                                  int* __restrict__ keys_out,
                                  int* __restrict__ vals_out) {
  __shared__ int wc[SORT_THREADS / 32][RADIX];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < (SORT_THREADS / 32) * RADIX; i += SORT_THREADS)
    (&wc[0][0])[i] = 0;
  const int start = offs[(long long)blockIdx.x * RADIX + threadIdx.x];   // thread d: digit d
  __syncthreads();                      // every warp's counts zeroed
  const long long base = (long long)blockIdx.x * SORT_TILE + (long long)w * WARP_KEYS;
  const unsigned below = (1u << lane) - 1u;
  int key[SORT_ROUNDS], val[SORT_ROUNDS], rank[SORT_ROUNDS];
#pragma unroll
  for (int r = 0; r < SORT_ROUNDS; ++r) {
    const long long i = base + r * 32 + lane;
    const bool in = i < P;
    key[r] = in ? keys_in[i] : 0;
    val[r] = in ? (vals_in != nullptr ? vals_in[i] : (int)i) : 0;
    const int d = in ? (key[r] >> shift) & (RADIX - 1) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int prior = in ? wc[w][d] : 0;
    __syncwarp();
    if (in && lane == __ffs(peers) - 1) wc[w][d] += __popc(peers);
    __syncwarp();
    rank[r] = prior + __popc(peers & below);
  }
  __syncthreads();
  {
    const int d = threadIdx.x;
    int run = start;
    for (int v = 0; v < SORT_THREADS / 32; ++v) {
      const int c = wc[v][d];
      wc[v][d] = run;
      run += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < SORT_ROUNDS; ++r) {
    if (base + r * 32 + lane >= P) continue;
    const int pos = wc[w][(key[r] >> shift) & (RADIX - 1)] + rank[r];
    if (keys_out != nullptr) keys_out[pos] = key[r];
    vals_out[pos] = val[r];
  }
}

// VEC values to float32 from p: 16-byte loads where VEC allows (float x4,
// bf16 x8; p then 16-byte aligned), one value otherwise.
template <int VEC>
__device__ __forceinline__ void load_f(const float* p, float* v) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int q = 0; q < VEC; q += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + q);
      v[q] = a.x; v[q + 1] = a.y; v[q + 2] = a.z; v[q + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < VEC; ++q) v[q] = p[q];
  }
}
template <int VEC>
__device__ __forceinline__ void load_f(const __nv_bfloat16* p, float* v) {
  if constexpr (VEC == 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(b[q]);
      v[2 * q] = f.x;
      v[2 * q + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < VEC; ++q) v[q] = __bfloat162float(p[q]);
  }
}
template <int VEC>
__device__ __forceinline__ void store_f(float* p, const float* v) {
  if constexpr (VEC == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
#pragma unroll
    for (int q = 0; q < VEC; ++q) p[q] = v[q];
}

// How the corner weights and products round: K4 and K9 (w = wz wy wx, then
// w g), K10 in float32 (wz wy, then (wz wy)(wx g)), K10 in bf16 (the same
// with the axis weights, g, wz wy and wx g rounded to bf16).
enum WMode { W_DG = 0, W_FUSED = 1, W_FUSED_BF16 = 2 };

template <int MODE>
__device__ __forceinline__ float rnd(float v) {
  return MODE == W_FUSED_BF16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// lanes a point: a power of two covering C / VEC channels, at most 32
__host__ __device__ __forceinline__ int lanes_per_point(int C, int vec) {
  const int need = (C + vec - 1) / vec;
  int lp = 1;
  while (lp < need && lp < 32) lp <<= 1;
  return lp;
}

// Phase 3a: warp j sums chunk j (CHUNK points of one cell's segment, in
// index order) into partial[j][s][c] for the cell's 8 corners s.
template <int MODE, int VEC>
__global__ void dg_chunk_kernel(const float* __restrict__ x, int PW,
                                const float* __restrict__ g,
                                const float* __restrict__ g2, int C, int D,
                                int H, int W, const int* __restrict__ order,
                                const int* __restrict__ off,
                                const int* __restrict__ chunk_off,
                                const int* __restrict__ chunk_cell, int ncells,
                                long long warps, float* __restrict__ partial) {
  const long long j = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (j >= warps || j >= chunk_off[ncells]) return;
  const int lo = chunk_cell[j];
  const int start = off[lo] + (int)(j - chunk_off[lo]) * CHUNK;
  const int end = min(start + CHUNK, off[lo + 1]);
  static_assert(CHUNK == 32, "a chunk's indices are a warp's lanes");
  const int LP = lanes_per_point(C, VEC), G = 32 / LP;
  const int gi = lane / LP, sub = lane % LP, n = end - start;
  // the chunk's point indices, one a lane, handed round by shuffles
  const int mine = lane < n ? order[start + lane] : 0;
  for (int cb = 0; cb < C; cb += LP * VEC) {
    const int ch = cb + sub * VEC;
    const bool act = ch < C;
    float acc[8][VEC];
#pragma unroll
    for (int s = 0; s < 8; ++s)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[s][e] = 0.0f;
#pragma unroll 2
    for (int i0 = 0; i0 < n; i0 += G) {
      // a lane group past the chunk's end reads its first point and adds 0
      const int li = i0 + gi;
      const bool live = li < n;
      const long long p = __shfl_sync(0xffffffffu, mine, live ? li : 0);
      float fr[3];
      cell_fracs(x + p * PW, D, H, W, fr);
      float gv[VEC] = {};
      if (act && live) {
        load_f<VEC>(g + p * C + ch, gv);
        if (g2 != nullptr) {
          float hv[VEC];
          load_f<VEC>(g2 + p * C + ch, hv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) gv[e] = __fadd_rn(gv[e], hv[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) gv[e] = rnd<MODE>(gv[e]);
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const int dz = (s >> 2) & 1, dy = (s >> 1) & 1, dx = s & 1;
        const float wz = rnd<MODE>(dz ? fr[2] : __fsub_rn(1.0f, fr[2]));
        const float wy = rnd<MODE>(dy ? fr[1] : __fsub_rn(1.0f, fr[1]));
        const float wx = rnd<MODE>(dx ? fr[0] : __fsub_rn(1.0f, fr[0]));
        const float wzy = rnd<MODE>(__fmul_rn(wz, wy));
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float t = MODE == W_DG
              ? __fmul_rn(__fmul_rn(wzy, wx), gv[e])
              : __fmul_rn(wzy, rnd<MODE>(__fmul_rn(wx, gv[e])));
          acc[s][e] = __fadd_rn(acc[s][e], t);
        }
      }
    }
    for (int o = LP; o < 32; o <<= 1)
#pragma unroll
      for (int s = 0; s < 8; ++s)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[s][e] = __fadd_rn(acc[s][e], __shfl_xor_sync(0xffffffffu, acc[s][e], o));
    if (!act) continue;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      if (s % G != gi) continue;
      store_f<VEC>(partial + (j * 8 + s) * C + ch, acc[s]);
    }
  }
}

// Phase 3b: each voxel's VEC channels, written once. Eight threads, lanes
// 8k .. 8k + 7 of a warp, take one (voxel, channels) pair, thread s the
// cell whose corner s the voxel is: it sums that cell's chunk partials
// (eight running sums over its chunks in turn, then added in a fixed
// tree), and the eight corners' sums are added in a fixed tree of
// shuffles. A cell of thousands of points (at a step's fine level, a
// cell holds up to ~3,000) thus costs an eighth of its chunks in turn.
template <int VEC>
__global__ void dg_voxel_kernel(const float* __restrict__ partial,
                                const int* __restrict__ chunk_off, int C, int D,
                                int H, int W, float* __restrict__ dg) {
  const int per = C / VEC;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int s = (int)(t & 7);
  const long long q = t >> 3;                   // (voxel, channel group)
  const long long v = q / per;
  const bool in = v < (long long)D * H * W;
  const int ch = (int)(q % per) * VEC;
  float sum[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) sum[e] = 0.0f;
  if (in) {
    const int vx = (int)(v % W), vy = (int)((v / W) % H), vz = (int)(v / ((long long)W * H));
    const int dz = (s >> 2) & 1, dy = (s >> 1) & 1, dx = s & 1;
    const int cell = ((vz + 1 - dz) * (H + 1) + (vy + 1 - dy)) * (W + 1) + (vx + 1 - dx);
    const int j1 = chunk_off[cell + 1];
    float acc[8][VEC];
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[u][e] = 0.0f;
    int j = chunk_off[cell];
    for (; j + 8 <= j1; j += 8) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        float a[VEC];
        load_f<VEC>(partial + ((long long)(j + u) * 8 + s) * C + ch, a);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[u][e] = __fadd_rn(acc[u][e], a[e]);
      }
    }
    for (; j < j1; ++j) {
      float a[VEC];
      load_f<VEC>(partial + ((long long)j * 8 + s) * C + ch, a);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[0][e] = __fadd_rn(acc[0][e], a[e]);
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      sum[e] = __fadd_rn(__fadd_rn(__fadd_rn(acc[0][e], acc[1][e]), __fadd_rn(acc[2][e], acc[3][e])),
                         __fadd_rn(__fadd_rn(acc[4][e], acc[5][e]), __fadd_rn(acc[6][e], acc[7][e])));
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      sum[e] = __fadd_rn(sum[e], __shfl_xor_sync(0xffffffffu, sum[e], o));
  if (in && s == 0) store_f<VEC>(dg + v * C + ch, sum);
}

// K10's dcoords: eight threads a point, lanes 8k .. 8k + 7 of a warp,
// thread s its corner s: <g, V_s> over the C channels, VEC values a load
// (16 bytes where C allows), times the corner's weight products; the
// eight threads' three sums are then added in a fixed tree of shuffles.
template <typename T, int VEC>
__global__ void dg_dcoords_kernel(const float* __restrict__ x, int PW,
                                  const float* __restrict__ g,
                                  const T* __restrict__ vals, long long P,
                                  int C, int D, int H, int W,
                                  float* __restrict__ dc) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int s = (int)(t & 7);
  const long long p = t >> 3;
  const bool in = p < P;
  const long long q = in ? p : P - 1;     // past the end: read the last point
  float fr[3];
  const bool ok = cell_fracs(x + q * PW, D, H, W, fr);
  const float* gp = g + q * C;
  const T* vp = vals + (q * 8 + s) * C;
  float dot = 0.0f;
#pragma unroll 4
  for (int c = 0; c < C; c += VEC) {
    float v[VEC], gq[VEC];
    load_f<VEC>(vp + c, v);
    load_f<VEC>(gp + c, gq);
#pragma unroll
    for (int e = 0; e < VEC; ++e) dot = fmaf(gq[e], v[e], dot);
  }
  const int dz = (s >> 2) & 1, dy = (s >> 1) & 1, dx = s & 1;
  const float wz = dz ? fr[2] : 1.0f - fr[2];
  const float wy = dy ? fr[1] : 1.0f - fr[1];
  const float wx = dx ? fr[0] : 1.0f - fr[0];
  float dfx = (dx ? 1.0f : -1.0f) * wz * wy * dot;
  float dfy = (dy ? 1.0f : -1.0f) * wz * wx * dot;
  float dfz = (dz ? 1.0f : -1.0f) * wy * wx * dot;
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) {
    dfx += __shfl_xor_sync(0xffffffffu, dfx, o);
    dfy += __shfl_xor_sync(0xffffffffu, dfy, o);
    dfz += __shfl_xor_sync(0xffffffffu, dfz, o);
  }
  if (in && s < 3) {
    const float d = s == 0 ? dfx : s == 1 ? dfy : dfz;
    dc[p * 3 + s] = ok ? d * (0.5f * ((s == 0 ? W : s == 1 ? H : D) - 1)) : 0.0f;
  }
}

bool aligned16(const void* p) { return p == nullptr || (uintptr_t)p % 16 == 0; }

#define SAHS_LAUNCHED()                             \
  do {                                              \
    const cudaError_t e_ = cudaGetLastError();      \
    if (e_ != cudaSuccess) return (int)e_;          \
  } while (0)

// The routine: phases 1-3 for the points at x (cells from rows, or from x
// where rows is null), cotangent g (+ g2), written to dg (D, H, W, C).
int binned_dg(const float* x, const int* rows, const float* g, const float* g2,
              long long P, int PW, int C, int D, int H, int W, int mode,
              int* ints, long long n_ints, float* partial, long long n_floats,
              float* dg, cudaStream_t st) {
  int ncells = 0;
  if (PW < 3 || shape_error(P, C, D, H, W, &ncells) != 0) return (int)cudaErrorInvalidValue;
  if (n_ints < scratch_ints(P, ncells) || n_floats < max_chunks(P, ncells) * 8 * C)
    return (int)cudaErrorInvalidValue;
  const long long nb = tiles(P);
  int* keys0 = ints;
  int* keys1 = keys0 + P;
  int* vals0 = keys1 + P;
  int* vals1 = vals0 + P;
  int* hist = vals1 + P;
  int* count = hist + RADIX * nb;
  int* totals = count + ncells;
  int* off = totals + MAX_PASSES * RADIX;
  int* chunk_off = off + ncells + 1;
  int* sums = chunk_off + ncells + 1;
  int* chunk_cell = sums + 2 * cell_tiles(ncells);
  const cudaError_t zeroed = cudaMemsetAsync(
      count, 0, sizeof(int) * ((size_t)ncells + MAX_PASSES * RADIX), st);
  if (zeroed != cudaSuccess) return (int)zeroed;
  int bits = 0;
  while ((1LL << bits) <= ncells) ++bits;      // keys are 0 .. ncells
  const int passes = (bits + 7) / 8;
  const int* order = nullptr;
  if (P > 0) {
    dg_cells_kernel<<<(unsigned)nb, SORT_THREADS, 0, st>>>(
        x, rows, P, PW, D, H, W, ncells, passes, keys0, count, hist, totals);
    SAHS_LAUNCHED();
    const int* kin = keys0;
    int* kout = keys1;
    const int* vin = nullptr;
    int* vout = vals0;
    for (int q = 0; q < passes; ++q) {
      if (q > 0) {
        dg_hist_kernel<<<(unsigned)nb, SORT_THREADS, 0, st>>>(kin, P, 8 * q, hist);
        SAHS_LAUNCHED();
      }
      dg_tile_offsets_kernel<<<RADIX, SORT_THREADS, 0, st>>>(hist, nb, totals + q * RADIX);
      SAHS_LAUNCHED();
      dg_scatter_kernel<<<(unsigned)nb, SORT_THREADS, 0, st>>>(
          kin, vin, P, 8 * q, hist, q + 1 == passes ? nullptr : kout, vout);
      SAHS_LAUNCHED();
      kin = kout;
      kout = kin == keys0 ? keys1 : keys0;
      vin = vout;
      vout = vout == vals0 ? vals1 : vals0;
    }
    order = vin;
  }
  const unsigned ctiles = (unsigned)cell_tiles(ncells);
  dg_cell_sums_kernel<<<ctiles, SORT_THREADS, 0, st>>>(count, ncells, sums);
  SAHS_LAUNCHED();
  dg_cell_offsets_kernel<<<ctiles, SORT_THREADS, 0, st>>>(count, ncells, sums, off,
                                                          chunk_off, chunk_cell);
  SAHS_LAUNCHED();
  const bool vec = C % 4 == 0 && aligned16(g) && aligned16(g2) && aligned16(dg);
  const long long warps = max_chunks(P, ncells);
  if (warps > 0) {
    const unsigned blocks = (unsigned)((warps * 32 + 255) / 256);
#define SAHS_CHUNK(M, V)                                                       \
  dg_chunk_kernel<M, V><<<blocks, 256, 0, st>>>(x, PW, g, g2, C, D, H, W,      \
                                                order, off, chunk_off,         \
                                                chunk_cell, ncells, warps,     \
                                                partial)
    if (mode == W_DG) { if (vec) SAHS_CHUNK(W_DG, 4); else SAHS_CHUNK(W_DG, 1); }
    else if (mode == W_FUSED) { if (vec) SAHS_CHUNK(W_FUSED, 4); else SAHS_CHUNK(W_FUSED, 1); }
    else { if (vec) SAHS_CHUNK(W_FUSED_BF16, 4); else SAHS_CHUNK(W_FUSED_BF16, 1); }
#undef SAHS_CHUNK
    SAHS_LAUNCHED();
  }
  const long long threads = (long long)D * H * W * (vec ? C / 4 : C) * 8;
  const unsigned vblocks = (unsigned)((threads + 255) / 256);
  if (vec)
    dg_voxel_kernel<4><<<vblocks, 256, 0, st>>>(partial, chunk_off, C, D, H, W, dg);
  else
    dg_voxel_kernel<1><<<vblocks, 256, 0, st>>>(partial, chunk_off, C, D, H, W, dg);
  SAHS_LAUNCHED();
  return 0;
}

}  // namespace

// The scratch the wrappers allocate (ops/kernels/grid_bwd._scratch) for P
// points, C channels and a (D, H, W) grid: sizes[0] int32s, sizes[1]
// float32s.
extern "C" int sahs_grid_scratch(long long P, int C, int D, int H, int W,
                                 void* sizes) {
  int ncells = 0;
  const int rc = shape_error(P, C, D, H, W, &ncells);
  if (rc != 0) return rc;
  long long* out = (long long*)sizes;
  out[0] = scratch_ints(P, ncells);
  out[1] = max_chunks(P, ncells) * 8 * C;
  return 0;
}

// K4: rows from K1, with the coarse-in-fine addend gse2 (or null). ints and
// partial are the wrapper's scratch (n_ints int32, n_floats float32).
extern "C" int sahs_grid_dg(const void* pts, const void* rows, const void* gse,
                            const void* gse2, long long P, int PW, int C, int D,
                            int H, int W, void* ints, long long n_ints,
                            void* partial, long long n_floats, void* dg,
                            void* stream) {
  if (rows == nullptr) return (int)cudaErrorInvalidValue;
  return binned_dg((const float*)pts, (const int*)rows, (const float*)gse,
                   (const float*)gse2, P, PW, C, D, H, W, W_DG, (int*)ints,
                   n_ints, (float*)partial, n_floats, (float*)dg,
                   reinterpret_cast<cudaStream_t>(stream));
}

// K9: the cell of each point from its coordinates, one cotangent.
extern "C" int sahs_grid_dg_coords(const void* pts, const void* g, long long P,
                                   int PW, int C, int D, int H, int W,
                                   void* ints, long long n_ints, void* partial,
                                   long long n_floats, void* dg, void* stream) {
  return binned_dg((const float*)pts, nullptr, (const float*)g, nullptr, P, PW,
                   C, D, H, W, W_DG, (int*)ints, n_ints, (float*)partial,
                   n_floats, (float*)dg, reinterpret_cast<cudaStream_t>(stream));
}

// K10: dG (D, H, W, C) and dcoords (P, 3) from coords (P, PW), g (P, C) and
// the forward's corner rows vals (P, 8C), bf16 when bf16 != 0.
extern "C" int sahs_grid_bwd_fused(const void* coords, const void* g,
                                   const void* vals, long long P, int PW,
                                   int C, int D, int H, int W, int bf16,
                                   void* ints, long long n_ints, void* partial,
                                   long long n_floats, void* dg, void* dc,
                                   void* stream) {
  auto st = reinterpret_cast<cudaStream_t>(stream);
  auto x = (const float*)coords;
  auto gf = (const float*)g;
  const int rc = binned_dg(x, nullptr, gf, nullptr, P, PW, C, D, H, W,
                           bf16 ? W_FUSED_BF16 : W_FUSED, (int*)ints, n_ints,
                           (float*)partial, n_floats, (float*)dg, st);
  if (rc != 0 || P == 0) return rc;
  const unsigned blocks = (unsigned)((P * 8 + 255) / 256);
  const bool vec = aligned16(g) && aligned16(vals);
  float* out = (float*)dc;
  if (bf16) {
    auto v = (const __nv_bfloat16*)vals;
    if (vec && C % 8 == 0)
      dg_dcoords_kernel<__nv_bfloat16, 8><<<blocks, 256, 0, st>>>(x, PW, gf, v, P, C, D, H, W, out);
    else
      dg_dcoords_kernel<__nv_bfloat16, 1><<<blocks, 256, 0, st>>>(x, PW, gf, v, P, C, D, H, W, out);
  } else {
    auto v = (const float*)vals;
    if (vec && C % 4 == 0)
      dg_dcoords_kernel<float, 4><<<blocks, 256, 0, st>>>(x, PW, gf, v, P, C, D, H, W, out);
    else
      dg_dcoords_kernel<float, 1><<<blocks, 256, 0, st>>>(x, PW, gf, v, P, C, D, H, W, out);
  }
  SAHS_LAUNCHED();
  return 0;
}
