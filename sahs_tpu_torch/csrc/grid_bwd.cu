// K4, K9 and K10: dGrid, the gradient of the trilinear spatial-embedding
// sample with respect to the (C, D, H, W) grid; K10 also the coordinates'.
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
//
// K9 replaces sahs_tpu/ops/pallas/grid_bwd.py:grid_dg_slab (:103,
// pallas_call at :191), the autograd fallback's dGrid: the backward of the
// grid-coupled level ops (field_grid.py:168, :249) over sample-major points.
// It gets raw coordinates and one cotangent, no rows: each thread forms its
// point's cell with the exact expression of ops/grid._cell_geometry
// (sahs::cell_row, no FMA contraction), so the cell is the one the forward
// interpolated in. The same kernel, the same bound.
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
  const int row = rows != nullptr ? rows[p] : sahs::cell_row(x, D, H, W);
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

int launch(const float* pts, const int* rows, const float* gse,
           const float* gse2, long long P, int PW, int C, int D, int H, int W,
           float* dg, void* stream) {
  if (P <= 0) return 0;
  const int threads = 256;
  const long long blocks = (P * 32 + threads - 1) / threads;
  grid_dg_kernel<<<(unsigned)blocks, threads, 0,
                   reinterpret_cast<cudaStream_t>(stream)>>>(
      pts, rows, gse, gse2, P, PW, C, D, H, W, dg);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// K10 replaces sahs_tpu/ops/pallas/grid_bwd.py:grid_bwd_fused (:343,
// pallas_call at :415): the backward of ops/grid.grid_sample_3d, as the
// per-point branch and the plain path run it. From the coordinates, the
// cotangent g (P, C) of the sampled features and the corner rows vals
// (P, 8C) the forward gathered, one pass gives
//   dG[c, z, y, x] = sum_p (Az Ay)[p, z, y] * (Ax g)[p, x, c]
// over each point's corners inside the grid (a corner outside adds
// nothing), and dcoords (P, 3) from analytic corner differences of vals,
// gated by the whole cell's band and scaled by (n - 1) / 2 per axis
// (grid_bwd.py:392-413). In bf16 mode the axis weights and g are rounded to
// bf16, and so is each of the two products Az Ay and Ax g, before their
// float32 product (grid_bwd.py:375-384); vals are then bf16. In f32 mode the
// math is exact float32. The TPU kernel contracted dense one-hot axis
// weights on the MXU because Mosaic has no scatter; here, as for K4, one
// warp takes a point, lane = channel, and adds its 8 corners with atomicAdd.
// The TPU's restriction to the 32-channel 32^3 grid (its VMEM) is gone.
//
// Bound on the H100: bytes. A point reads its 3 coordinates, g (C floats)
// and vals (8C bf16) and writes 3 floats, with the 4 MB grid written once:
// ~0.26 GB at 393,216 points, ~0.08 ms at 3.35 TB/s.
template <typename T>
__global__ void grid_bwd_fused_kernel(const float* __restrict__ coords,
                                      const float* __restrict__ g,
                                      const T* __restrict__ vals, long long P,
                                      int PW, int C, int D, int H, int W,
                                      float* __restrict__ dg,
                                      float* __restrict__ dc) {
  const long long p = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (p >= P) return;
  const bool bf = sizeof(T) == 2;
  const float* x = coords + p * PW;
  const int dims[3] = {W, H, D};
  float fr[3], i0[3];
  bool ok = true;
  for (int ax = 0; ax < 3; ++ax) {
    const float i = sahs::cell_index(x[ax], dims[ax]);
    i0[ax] = floorf(i);
    fr[ax] = __fsub_rn(i, i0[ax]);
    ok = ok && (i0[ax] >= -1.0f) && (i0[ax] <= (float)(dims[ax] - 1));
  }
  const float* gp = g + p * C;
  const T* vp = vals + p * 8 * C;
  // dcoords: gv[s] = <g, V_s>, reduced over the warp
  float dfx = 0.0f, dfy = 0.0f, dfz = 0.0f;
  for (int s = 0; s < 8; ++s) {
    float gv = 0.0f;
    for (int c = lane; c < C; c += 32) gv += gp[c] * sahs::to_f(vp[s * C + c]);
    for (int off = 16; off > 0; off /= 2) gv += __shfl_xor_sync(0xffffffffu, gv, off);
    const int dz = (s >> 2) & 1, dy = (s >> 1) & 1, dx = s & 1;
    const float wz = dz ? fr[2] : 1.0f - fr[2];
    const float wy = dy ? fr[1] : 1.0f - fr[1];
    const float wx = dx ? fr[0] : 1.0f - fr[0];
    dfx += (dx ? 1.0f : -1.0f) * wz * wy * gv;
    dfy += (dy ? 1.0f : -1.0f) * wz * wx * gv;
    dfz += (dz ? 1.0f : -1.0f) * wy * wx * gv;
  }
  if (lane == 0) {
    const float okf = ok ? 1.0f : 0.0f;
    dc[p * 3 + 0] = dfx * okf * (0.5f * (W - 1));
    dc[p * 3 + 1] = dfy * okf * (0.5f * (H - 1));
    dc[p * 3 + 2] = dfz * okf * (0.5f * (D - 1));
  }
  // dG: a point outside the band has no corner inside the grid
  if (!ok) return;
  auto rnd = [bf](float v) {
    return bf ? __bfloat162float(__float2bfloat16_rn(v)) : v;
  };
  for (int s = 0; s < 8; ++s) {
    const int dz = (s >> 2) & 1, dy = (s >> 1) & 1, dx = s & 1;
    const int vz = (int)i0[2] + dz, vy = (int)i0[1] + dy, vx = (int)i0[0] + dx;
    if (vz < 0 || vz >= D || vy < 0 || vy >= H || vx < 0 || vx >= W) continue;
    const float wz = rnd(dz ? fr[2] : __fsub_rn(1.0f, fr[2]));
    const float wy = rnd(dy ? fr[1] : __fsub_rn(1.0f, fr[1]));
    const float wx = rnd(dx ? fr[0] : __fsub_rn(1.0f, fr[0]));
    const float wzy = rnd(__fmul_rn(wz, wy));
    float* cell = dg + (((long long)vz * H + vy) * W + vx) * C;
    for (int c = lane; c < C; c += 32)
      atomicAdd(cell + c, __fmul_rn(wzy, rnd(__fmul_rn(wx, rnd(gp[c])))));
  }
}

// K4: rows from K1, with the coarse-in-fine addend gse2 (or null).
extern "C" int sahs_grid_dg(const void* pts, const void* rows, const void* gse,
                            const void* gse2, long long P, int PW, int C, int D,
                            int H, int W, void* dg, void* stream) {
  if (rows == nullptr) return (int)cudaErrorInvalidValue;
  return launch((const float*)pts, (const int*)rows, (const float*)gse,
                (const float*)gse2, P, PW, C, D, H, W, (float*)dg, stream);
}

// K9: the cell of each point from its coordinates, one cotangent.
extern "C" int sahs_grid_dg_coords(const void* pts, const void* g, long long P,
                                   int PW, int C, int D, int H, int W,
                                   void* dg, void* stream) {
  return launch((const float*)pts, nullptr, (const float*)g, nullptr, P, PW,
                C, D, H, W, (float*)dg, stream);
}

// K10: dG (D, H, W, C) and dcoords (P, 3) from coords (P, PW), g (P, C) and
// the forward's corner rows vals (P, 8C), bf16 when bf16 != 0.
extern "C" int sahs_grid_bwd_fused(const void* coords, const void* g,
                                   const void* vals, long long P, int PW,
                                   int C, int D, int H, int W, int bf16,
                                   void* dg, void* dc, void* stream) {
  if (P <= 0) return 0;
  if (PW < 3) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (P * 32 + threads - 1) / threads;
  auto s = reinterpret_cast<cudaStream_t>(stream);
  auto c = (const float*)coords;
  auto gf = (const float*)g;
  if (bf16)
    grid_bwd_fused_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, s>>>(
        c, gf, (const __nv_bfloat16*)vals, P, PW, C, D, H, W, (float*)dg,
        (float*)dc);
  else
    grid_bwd_fused_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
        c, gf, (const float*)vals, P, PW, C, D, H, W, (float*)dg, (float*)dc);
  return (int)cudaGetLastError();
}
