// dW of the bf16 level backward (K2, K6, K8, K12: launches 4-6 of
// level_train.cu) and of the deformation nets' (K3: deform_pair_vjp.cu, K14:
// skip_mlp.cu, after skip_bw.cuh's tile) on wgmma, from the two stashes of
// the backward tile.
//
// What it computes: for every product of the train plan (the level's, the
// pair's, one net's; field_mlp.TrainPlan's prods)
// dW[k][n] = sum_p bf16(a[p][k]) bf16(gz[p][n]) with float32 sums (the JAX
// package's _mmT), and for every layer
// db[n] = sum_p gz[p][n] in unrounded float32. The activation stash holds
// bf16 a, the gz stash bf16 gz (the product rounds it anyway); db comes from
// the per-tile column sums of the float32 gz that the backward tile forms
// in its epilogues (bsum, a tile's row laid out as the forward bias blob).
// Deterministic: every sum runs in a fixed order, so repeats are bit-equal.
//
// Design. A stash block of a tile (a slot's rows, each the tile's 64 points,
// 128 bytes) is a K-major wgmma operand as it lies: with M = k rows (A, the
// activation slot), N = the gz rows (B, the gz slot) and K = points, both
// operands are K-major, and TMA copies them into the 128-byte swizzle with
// no transpose. A block is two consumer warpgroups and a producer warp; it
// owns one item of the work list ([product, k0, n0, rows]: 128 k rows, a
// warpgroup's 64 each, by at most 128 gz columns) over one chunk of point
// tiles, and for each tile the producer copies both warpgroups' A blocks and
// the shared gz rows into a ring stage (32 KB; rows of A past K and of gz
// past N are other slots' finite values, or zeros past the stash, and meet
// only output rows and columns that are not written). Each k16 step is
// summed from zero in the tensor core and added to the float32 sums with
// round-to-nearest (wgmma.cuh's PROMOTE 1). The grid is items x chunks with
// the items fastest, so the blocks that read one tile's slots (an
// activation slot serves every n range of its products, a gz slot every k
// range) run together and read it from L2: device-memory reads approach one
// per stash byte. A chunk's sums go to its partial buffer; bias_dw_kernel
// sums bsum's rows over the same chunks, and train.cuh's dw_reduce adds the
// chunks in order.
//
// Replaces the dW half of the TPU kernels of K2, K6, K8 and K12 (which sum
// dW across their sequential grid in VMEM; level_train.cu's head names
// them). Bound on the H100: bytes. At a step's fine level (262,144 points)
// the stashes hold 1.82 GB of activations and 1.76 GB of gz, read once:
// 1.07 ms at 3.35 TB/s; the products (0.74 M multiply-adds a point) 0.39 ms
// at the bf16 peak. Measured on an H100 (PERF.md §6, tools/level_ab.py in
// turns with the warp-level tensor-core dW it replaced): 1.76 ms there (7.24), its loads 6.56 GB
// through L2, so at most 5.9 GB from device memory; 150 registers, no
// spill.
#pragma once

#include "train.cuh"
#include "wgmma.cuh"

namespace ldw {

constexpr int WG = 2;                                // consumer warpgroups
constexpr int THREADS = WG * wg::THREADS + 32;       // and the producer warp
constexpr int TP = wg::ROWS;                         // points of a stash tile
constexpr int KW = 64;                               // k rows of a warpgroup
constexpr int NW = 128;                              // gz columns of an item, at most
constexpr int GBOX = 8;                              // gz rows of a TMA box
constexpr int A_BYTES = KW * 128;                    // a warpgroup's A block
constexpr int STAGE = WG * A_BYTES + NW * 128;       // a ring stage: A, A, gz
constexpr int RING = 6;
constexpr int SMEM = RING * STAGE + 16 * RING + 1024;
constexpr int ITEM_INTS = 4;                         // [product, k0, n0, rows]

__global__ void __launch_bounds__(THREADS, 1)
level_dw_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap gmap,
                long long act_stride, long long gz_stride, int n_tiles, int tiles_per_chunk,
                const int* __restrict__ prods, const int* __restrict__ items,
                float* __restrict__ part, int out_len) {
  extern __shared__ __align__(1024) unsigned char dw_smem[];
  unsigned char* base = dw_smem + ((1024 - (wg::smem_u32(dw_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + RING * STAGE);
  uint64_t* empty = full + RING;
  const int* it = items + ITEM_INTS * blockIdx.x;
  const int* pr = prods + 6 * it[0];
  const int a_off = pr[0], K = pr[1], g_off = pr[2], N = pr[3], out_off = pr[4];
  const int k0 = it[1], n0 = it[2], rows = it[3];
  const int chunk = blockIdx.y;
  const int tile0 = chunk * tiles_per_chunk;
  const int tile1 = min(n_tiles, tile0 + tiles_per_chunk);
  const int tid = threadIdx.x, g = wg::warpgroup(), lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < RING; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], 4 * WG);  // lane 0 of every consumer warp
    }
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (g == WG) {  // the producer warp: one thread copies every stage
    if (lane == 0) {
      const int na = k0 + KW < K ? 2 : 1;  // warpgroups with rows of A
      const uint32_t bytes = na * A_BYTES + rows * 128;
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = tile0; tile < tile1; ++tile) {
        wg::mbar_wait(&empty[stage], phase ^ 1u);
        wg::mbar_expect(&full[stage], bytes);
        unsigned char* dst = base + stage * STAGE;
        const long long arow = ((long long)tile * act_stride + a_off) / TP + k0;
        for (int w = 0; w < na; ++w)
          wg::tma_load(dst + w * A_BYTES, &amap, &full[stage], 0, (int)(arow + w * KW));
        const long long grow = ((long long)tile * gz_stride + g_off) / TP + n0;
        for (int r = 0; r < rows; r += GBOX)
          wg::tma_load(dst + WG * A_BYTES + r * 128, &gmap, &full[stage], 0, (int)(grow + r));
        if (++stage == RING) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }

  // a consumer warpgroup: k rows k0 + 64 g .. of the item
  float d[NW / 2], p[NW / 2];
#pragma unroll
  for (int e = 0; e < NW / 2; ++e) d[e] = 0.0f;
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = tile0; tile < tile1; ++tile) {
    wg::mbar_wait(&full[stage], phase);
    const uint32_t a = wg::smem_u32(base + stage * STAGE + g * A_BYTES);
    const uint32_t b = wg::smem_u32(base + stage * STAGE + WG * A_BYTES);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wg::fence_operand(p);
      wg::fence();
      wg::mma<NW, 0>(p, wg::k_desc(a, j), wg::k_desc(b, j), 0);
      wg::commit();
      wg::wait<0>();
      wg::fence_operand(p);
#pragma unroll
      for (int e = 0; e < NW / 2; ++e) d[e] = __fadd_rn(d[e], p[e]);
    }
    wg::mbar_arrive(&empty[stage], lane == 0);
    if (++stage == RING) {
      stage = 0;
      phase ^= 1u;
    }
  }
  // d[4 j + 2 i + c] = D[16 w + l / 4 + 8 i][8 j + 2 (l % 4) + c]: dW's row
  // k0 + 64 g + that, column n0 + that (N and n0 even, so pairs)
  const int t = tid % wg::THREADS, l = t % 32;
  const int m0 = k0 + KW * g + 16 * (t / 32) + l / 4;
  float* out = part + (long long)chunk * out_len + out_off;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int n = 8 * j + 2 * (l % 4);
    if (n >= rows) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = m0 + 8 * i;
      if (k < K)
        *reinterpret_cast<float2*>(out + (long long)k * N + n0 + n) =
            make_float2(d[4 * j + 2 * i], d[4 * j + 2 * i + 1]);
    }
  }
}

// db's chunk partials: the rows of bsum (a tile's column sums of gz, the
// forward bias blob's layout, b_len floats) over each chunk's tiles, in
// order, into the chunk's partial buffer past the weights (w_len).
__global__ void bias_dw_kernel(const float* __restrict__ bsum, int b_len, int n_tiles,
                               int tiles_per_chunk, float* __restrict__ part, int w_len,
                               int out_len) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b_len) return;
  const int chunk = blockIdx.y;
  const int tile0 = chunk * tiles_per_chunk;
  const int tile1 = min(n_tiles, tile0 + tiles_per_chunk);
  float s = 0.0f;
  for (int tile = tile0; tile < tile1; ++tile) s += bsum[(long long)tile * b_len + i];
  part[(long long)chunk * out_len + w_len + i] = s;
}

// The three launches of the level's dW on `stream`: the products
// (n_items items of the work list), db's chunk partials, and dw_reduce's
// sum of the chunks in order. acts and gzs are the bf16 stashes (n_tiles
// blocks of act_stride and gz_stride elements), bsum (n_tiles, b_len).
inline int launch_level_dw(const __nv_bfloat16* acts, const __nv_bfloat16* gzs, const float* bsum,
                           long long act_stride, long long gz_stride, int n_tiles,
                           const int* prods, const int* items, int n_items, int chunks,
                           float* part, float* out, int out_len, int b_len,
                           cudaStream_t stream) {
  if (act_stride % TP || gz_stride % TP || b_len * (long long)TP != gz_stride)
    return (int)cudaErrorInvalidValue;
  CUtensorMap amap, gmap;
  int err = wg::make_map(&amap, acts, n_tiles * act_stride / TP, TP, 2 * TP, KW);
  if (!err) err = wg::make_map(&gmap, gzs, n_tiles * gz_stride / TP, TP, 2 * TP, GBOX);
  if (!err) err = sahs::set_smem(level_dw_kernel, SMEM);
  if (err) return err;
  const int per = (n_tiles + chunks - 1) / chunks;
  level_dw_kernel<<<dim3(n_items, chunks), THREADS, SMEM, stream>>>(
      amap, gmap, act_stride, gz_stride, n_tiles, per, prods, items, part, out_len);
  if ((err = (int)cudaGetLastError())) return err;
  bias_dw_kernel<<<dim3((b_len + 255) / 256, chunks), 256, 0, stream>>>(
      bsum, b_len, n_tiles, per, part, out_len - b_len, out_len);
  if ((err = (int)cudaGetLastError())) return err;
  sahs::dw_reduce<<<(out_len + 255) / 256, 256, 0, stream>>>(part, chunks, out_len, out);
  return (int)cudaGetLastError();
}

}  // namespace ldw
