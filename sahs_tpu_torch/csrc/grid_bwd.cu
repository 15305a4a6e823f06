// K4: dGrid, the gradient of the trilinear spatial-embedding sample with
// respect to the (C, D, H, W) grid.
//
// Replaces sahs_tpu/ops/pallas/grid_bwd.py:grid_dg_slab_packed (:211,
// pallas_call at :327), which the fused train path runs once a step over
// the sorted fine points with the coarse cotangents as a second input:
//     dG[c, z, y, x] = sum_p w_corner(p) * (gse[p, c] + gse2[p, c])
// over the 8 corners of each point's cell, zeros padding. The TPU kernel
// contracted dense one-hot axis weights on the MXU, z-slab by z-slab,
// because Mosaic has no scatter; here each point's 8 corners are added with
// atomicAdd. The cell is the point's corner-table row (the table has a
// one-cell padding border), mapped back to grid voxels; corners on the
// border are outside the grid and dropped. The corner weights use
// ops/grid._cell_geometry's exact float expression, as the forward does.
//
// Design: one warp per point, lane = channel, so the 32 lanes add to 32
// neighbouring floats of a (D, H, W, C) accumulator (one 128-byte line);
// the wrapper returns its (C, D, H, W) view. Atomics sum in an order that
// changes from run to run.
//
// Bound on the H100: bytes. It reads 4 + 2 C floats a point and writes the
// 4 MB grid: ~72 MB at 262,144 points, ~0.02 ms at 3.35 TB/s; the 67 M
// atomics, resolved in L2, are what it actually waits on.
#include "mlp.cuh"

namespace {

__global__ void grid_dg_kernel(const float* __restrict__ pts,
                               const int* __restrict__ rows,
                               const float* __restrict__ gse,
                               const float* __restrict__ gse2, long long P,
                               int PW, int C, int D, int H, int W,
                               float* __restrict__ dg) {
  const long long p = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (p >= P) return;
  const float* x = pts + p * PW;
  const int dims[3] = {W, H, D};
  float fr[3];
  bool ok = true;
  for (int ax = 0; ax < 3; ++ax) {
    const float i = sahs::cell_index(x[ax], dims[ax]);
    const float i0 = floorf(i);
    fr[ax] = __fsub_rn(i, i0);
    ok = ok && (i0 >= -1.0f) && (i0 <= (float)(dims[ax] - 1));
  }
  if (!ok) return;
  const int row = rows[p];
  const int bx = row % (W + 1);
  const int by = (row / (W + 1)) % (H + 1);
  const int bz = row / ((W + 1) * (H + 1));
  for (int s = 0; s < 8; ++s) {
    const int dz = (s >> 2) & 1, dy = (s >> 1) & 1, dx = s & 1;
    const int vz = bz + dz - 1, vy = by + dy - 1, vx = bx + dx - 1;
    if (vz < 0 || vz >= D || vy < 0 || vy >= H || vx < 0 || vx >= W) continue;
    const float wz = dz ? fr[2] : __fsub_rn(1.0f, fr[2]);
    const float wy = dy ? fr[1] : __fsub_rn(1.0f, fr[1]);
    const float wx = dx ? fr[0] : __fsub_rn(1.0f, fr[0]);
    const float w = __fmul_rn(__fmul_rn(wz, wy), wx);
    float* cell = dg + (((long long)vz * H + vy) * W + vx) * C;
    for (int c = lane; c < C; c += 32) {
      float g = gse[p * C + c];
      if (gse2 != nullptr) g = __fadd_rn(g, gse2[p * C + c]);
      atomicAdd(cell + c, __fmul_rn(w, g));
    }
  }
}

}  // namespace

extern "C" int sahs_grid_dg(const void* pts, const void* rows, const void* gse,
                            const void* gse2, long long P, int PW, int C, int D,
                            int H, int W, void* dg, void* stream) {
  if (P <= 0) return 0;
  const int threads = 256;
  const long long blocks = (P * 32 + threads - 1) / threads;
  grid_dg_kernel<<<(unsigned)blocks, threads, 0,
                   reinterpret_cast<cudaStream_t>(stream)>>>(
      (const float*)pts, (const int*)rows, (const float*)gse,
      (const float*)gse2, P, PW, C, D, H, W, (float*)dg);
  return (int)cudaGetLastError();
}
