// Shared device code for the backward kernels (K2 level_train, K3
// deform_pair_vjp): the device-memory stash of a tile's activations and
// cotangents, the activation-derivative step, and the split-K reduction
// of dW over all points.
//
// The stash. A backward needs every layer's input for its dW, and a tile's
// worth of them does not fit in shared memory next to the weights' reads
// (the NeRF trunk alone is 8 x 256 values a point). So the per-point
// kernels write each layer's input activation (compute dtype) and each
// layer's pre-activation cotangent gz (float32) to two tile-blocked
// buffers in device memory: tile b's block starts at b * stride, and in it
// a slot of K rows is k-major, row k holding the tile's TP points. The
// slot offsets come from the host (field_mlp.TrainPlan), so the kernels and
// the dW products agree on the layout.
//
// The reduction. dW[k][n] = sum_p A[p][k] gz[p][n] over ~10^5 points for
// ~0.7 M weights: blocks run in no order, so instead of atomics each block
// owns one 64 x 64 tile of one product (work list) over one chunk of point
// tiles, and writes it to its chunk's partial buffer; a second launch sums
// the partials in chunk order. The result is deterministic. A is read in
// the compute dtype and gz is rounded to it for the product (the mm
// semantics of the JAX package's _mmT), products summed in float32; a bias
// row takes A = 1 and the unrounded float32 gz.
#pragma once

#include "mlp.cuh"

namespace sahs {

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// Copy `rows` k-major rows of a shared-memory tile to its stash slot.
template <typename T>
__device__ void store_rows(const T* src, T* dst, int rows, int TP) {
  for (int i = threadIdx.x; i < rows * TP; i += blockDim.x) dst[i] = src[i];
}

// gz = ga * act'(y), y the layer's output read back from the stash (the
// derivative from the output, as field_mlp.py:77-88). Writes gz in float32
// to its stash slot and in the compute dtype to shared memory for the next
// transposed product. Callers __syncthreads() before reading gz_smem.
template <typename T>
__device__ void dact_step(const float* ga, const T* y, int act, int rows,
                          int TP, float* gz_glob, T* gz_smem) {
  for (int i = threadIdx.x; i < rows * TP; i += blockDim.x) {
    float d = 1.0f;
    if (act != ACT_LINEAR) {
      const float yv = to_f(y[i]);
      if (act == ACT_RELU) d = yv > 0.0f ? 1.0f : 0.0f;
      else if (act == ACT_LEAKY) d = yv > 0.0f ? 1.0f : 0.01f;
      else d = 1.0f - yv * yv;
    }
    const float g = ga[i] * d;
    gz_glob[i] = g;
    gz_smem[i] = from_f<T>(g);
  }
}

constexpr int DW_TILE = 64;
constexpr int DW_MAX_TP = 32;
constexpr int DW_ROW = DW_TILE + 4;   // [t][k] rows, 16-byte aligned

// One block, 256 threads, one 64 x 64 tile: thread (ty, tx) owns rows
// ty*4.. and columns tx*4.. . The tiles sit point-major in shared memory,
// so each point costs a thread one 16-byte read of A and one of gz for its
// 16 FMAs.
template <typename T>
__global__ void __launch_bounds__(256)
dw_kernel(const T* __restrict__ acts, const float* __restrict__ gzs,
          long long act_stride, long long gz_stride, int n_tiles, int TP,
          const int* __restrict__ prods, const int* __restrict__ work,
          int tiles_per_chunk, float* __restrict__ part, int out_len) {
  __shared__ __align__(16) float As[DW_MAX_TP][DW_ROW];
  __shared__ __align__(16) float Gs[DW_MAX_TP][DW_ROW];
  const int* wk = work + 3 * blockIdx.x;
  const int* pr = prods + 6 * wk[0];
  const int a_off = pr[0], K = pr[1], g_off = pr[2], N = pr[3];
  const int out_off = pr[4], is_bias = pr[5];
  const int k0 = wk[1], n0 = wk[2];
  const int kr = min(DW_TILE, K - k0), nr = min(DW_TILE, N - n0);
  const int chunk = blockIdx.y;
  const int tile0 = chunk * tiles_per_chunk;
  const int tile1 = min(n_tiles, tile0 + tiles_per_chunk);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  // each tile's TP-term sums are formed apart and then added to the
  // running sums, which keeps the float32 rounding of a long chunk small
  for (int tile = tile0; tile < tile1; ++tile) {
    const T* A = acts + tile * act_stride + a_off + (long long)k0 * TP;
    const float* G = gzs + tile * gz_stride + g_off + (long long)n0 * TP;
    for (int i = threadIdx.x; i < DW_TILE * TP; i += blockDim.x) {
      const int r = i / TP, t = i % TP;
      As[t][r] = is_bias ? 1.0f : (r < kr ? to_f(A[r * TP + t]) : 0.0f);
      const float g = r < nr ? G[r * TP + t] : 0.0f;
      Gs[t][r] = is_bias ? g : round_to<T>(g);
    }
    __syncthreads();
    float part_t[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part_t[i][j] = 0.0f;
    for (int t = 0; t < TP; ++t) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[t][ty * 4]);
      const float4 g4 = *reinterpret_cast<const float4*>(&Gs[t][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float g[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part_t[i][j] = fmaf(a[i], g[j], part_t[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part_t[i][j];
    __syncthreads();
  }
  float* out = part + (long long)chunk * out_len + out_off;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = ty * 4 + i, n = tx * 4 + j;
      if (k < kr && n < nr) out[(long long)(k0 + k) * N + n0 + n] = acc[i][j];
    }
}

__global__ void dw_reduce(const float* __restrict__ part, int chunks,
                          int out_len, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= out_len) return;
  float s = 0.0f;
  for (int c = 0; c < chunks; ++c) s += part[(long long)c * out_len + i];
  out[i] = s;
}

// Both launches of the reduction, on `stream`.
template <typename T>
int launch_dw(const T* acts, const float* gzs, long long act_stride,
              long long gz_stride, int n_tiles, int TP, const int* prods,
              const int* work, int n_work, int chunks, float* part, float* out,
              int out_len, cudaStream_t stream) {
  if (TP > DW_MAX_TP) return (int)cudaErrorInvalidValue;
  const int per = (n_tiles + chunks - 1) / chunks;
  dw_kernel<T><<<dim3(n_work, chunks), 256, 0, stream>>>(
      acts, gzs, act_stride, gz_stride, n_tiles, TP, prods, work, per, part,
      out_len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dw_reduce<<<(out_len + 255) / 256, 256, 0, stream>>>(part, chunks, out_len,
                                                      out);
  return (int)cudaGetLastError();
}

// Set a kernel's dynamic shared memory limit and check the launch fits.
template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace sahs
