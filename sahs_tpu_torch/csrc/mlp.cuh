// Shared device code for the field kernels: one MLP layer over a tile of
// points held in shared memory, and the in-kernel positional encoding.
//
// Activations live in shared memory k-major: X[k * TP + t] is input
// feature k of tile point t (TP points per tile). A layer computes
//     Y[n][t] = act( sum_k X1[k][t] W1[k][n] (+ sum_k X2[k][t] W2[k][n]) + b[n] )
// with W read from global memory (the weight blobs, L2-resident) as
// row-major [k][N] with N padded to a multiple of 8. Storage type T is the
// compute dtype (float or bf16): operands are T, products accumulate in
// float32, the bias is float32. This is the matmul semantics of the JAX
// package's _mm (field_mlp.py:91-96).
//
// Each thread owns a 4-point x 8-output register tile (32 accumulators):
// per k it reads 4 activations (one vector load from shared memory) and 8
// weights (one or two 16-byte loads), then does 32 FMAs. This is a plain
// SIMT GEMM on the CUDA cores; the tensor cores (wgmma) are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define SAHS_HALF_PI_F 1.57079637f  // float32(pi / 2), as the JAX PE tables

namespace sahs {

// Matches field_mlp.BlobBuilder: 7 int32 per layer.
struct LayerDesc {
  int w1, k1, w2, k2, n, b, act;
};

__device__ __forceinline__ LayerDesc load_desc(const int* meta, int i) {
  const int* m = meta + 7 * i;
  LayerDesc d;
  d.w1 = m[0]; d.k1 = m[1]; d.w2 = m[2]; d.k2 = m[3];
  d.n = m[4]; d.b = m[5]; d.act = m[6];
  return d;
}

enum { ACT_LINEAR = 0, ACT_RELU = 1, ACT_LEAKY = 2, ACT_TANH = 3 };

__device__ __forceinline__ float apply_act(float v, int act) {
  switch (act) {
    case ACT_RELU: return fmaxf(v, 0.0f);
    case ACT_LEAKY: return v >= 0.0f ? v : 0.01f * v;
    case ACT_TANH: return tanhf(v);
    default: return v;
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 4 consecutive activations (16 bytes of float, 8 bytes of bf16).
__device__ __forceinline__ void load4(const float* p, float a[4]) {
  float4 v = *reinterpret_cast<const float4*>(p);
  a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float a[4]) {
  uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  float2 f0 = __bfloat1622float2(h[0]);
  float2 f1 = __bfloat1622float2(h[1]);
  a[0] = f0.x; a[1] = f0.y; a[2] = f1.x; a[3] = f1.y;
}

// 8 consecutive weights from global memory, read-only path.
__device__ __forceinline__ void load8(const float* p, float w[8]) {
  float4 v0 = __ldg(reinterpret_cast<const float4*>(p));
  float4 v1 = __ldg(reinterpret_cast<const float4*>(p) + 1);
  w[0] = v0.x; w[1] = v0.y; w[2] = v0.z; w[3] = v0.w;
  w[4] = v1.x; w[5] = v1.y; w[6] = v1.z; w[7] = v1.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float w[8]) {
  uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    w[2 * i] = f.x; w[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  __nv_bfloat162 h[2];
  h[0] = __floats2bfloat162_rn(v[0], v[1]);
  h[1] = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<uint2*>(h);
}

template <typename T>
__device__ __forceinline__ void accumulate(float acc[4][8], const T* X, int K,
                                           const T* W, int N, int t0, int n0,
                                           int TP) {
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float a[4], w[8];
    load4(X + k * TP + t0, a);
    load8(W + (size_t)k * N + n0, w);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
  }
}

// One layer over the tile. X2 may be null (no second input). bias_override,
// when given, replaces the blob bias (a per-block bias in shared memory).
// The result goes to Y (type T, k-major) or, when Yf is given, to Yf in
// float32. Callers __syncthreads() before reading Y.
template <typename T>
__device__ void mlp_layer(const LayerDesc& d, const T* __restrict__ wblob,
                          const float* __restrict__ bblob, const T* X1,
                          const T* X2, const float* bias_override, T* Y,
                          float* Yf, int TP) {
  const int tgroups = TP / 4;
  const int n_tiles = tgroups * (d.n / 8);
  const float* bias = bias_override ? bias_override : bblob + d.b;
  for (int mt = threadIdx.x; mt < n_tiles; mt += blockDim.x) {
    const int t0 = (mt % tgroups) * 4;
    const int n0 = (mt / tgroups) * 8;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    accumulate(acc, X1, d.k1, wblob + d.w1, d.n, t0, n0, TP);
    if (X2 != nullptr && d.w2 >= 0)
      accumulate(acc, X2, d.k2, wblob + d.w2, d.n, t0, n0, TP);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float bj = bias[n0 + j];
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = apply_act(acc[i][j] + bj, d.act);
      if (Yf != nullptr)
        store4(Yf + (n0 + j) * TP + t0, v);
      else
        store4(Y + (n0 + j) * TP + t0, v);
    }
  }
}

// Positional encoding of one coordinate group, for one point, written
// k-major into X starting at row `row0`: [x (dim) ; sin(f0 x) ; cos(f0 x) ;
// sin(f1 x) ; ...] with f_j = 2^j (log sampling). cos is sin(x f + pi/2)
// as in the JAX kernels' tables; x*f is exact (f a power of two) and sinf
// is the accurate float32 sine (no fast-math intrinsics).
template <typename T>
__device__ __forceinline__ void pe_group(const float* x, int dim, int nfreq,
                                         T* X, int row0, int t, int TP) {
  int row = row0;
  for (int d = 0; d < dim; ++d) X[(row++) * TP + t] = from_f<T>(x[d]);
  for (int f = 0; f < nfreq; ++f) {
    const float fr = ldexpf(1.0f, f);
    for (int d = 0; d < dim; ++d)
      X[(row++) * TP + t] = from_f<T>(sinf(__fmul_rn(x[d], fr)));
    for (int d = 0; d < dim; ++d)
      X[(row++) * TP + t] =
          from_f<T>(sinf(__fadd_rn(__fmul_rn(x[d], fr), SAHS_HALF_PI_F)));
  }
}

// Columns [0, dim) of the rows of a per-point input src (row stride
// `stride`) for the tile's points [base, base + tp), in the compute dtype
// T (round to nearest from float32, as the JAX callers cast the input
// before their kernels), written k-major into X (row stride ld) from row
// row0; zeros past the last point. The whole block takes part, neighbouring
// threads reading neighbouring columns of a point's row.
template <typename T, typename S>
__device__ __forceinline__ void point_rows(const S* src, long long stride,
                                           long long base, long long P, int dim,
                                           T* X, int row0, int tp, int ld) {
  for (int i = threadIdx.x; i < dim * tp; i += blockDim.x) {
    const int t = i / dim, r = i - t * dim;
    const long long p = base + t;
    X[(row0 + r) * ld + t] = from_f<T>(p < P ? to_f(src[p * stride + r]) : 0.0f);
  }
}

// PE backward of one coordinate group of one point: the cotangents of its
// encoding rows G[row0 ..] (pe_group's layout, row stride TP) added into
// gx[0 .. dim), d(sin t)/dx = cos(t) f with t formed as pe_group forms it.
__device__ __forceinline__ void pe_group_bwd(const float* x, int dim, int nfreq,
                                             const float* G, int row0, int t,
                                             int TP, float* gx) {
  int row = row0;
  for (int d = 0; d < dim; ++d) gx[d] += G[(row++) * TP + t];
  for (int f = 0; f < nfreq; ++f) {
    const float fr = ldexpf(1.0f, f);
    for (int d = 0; d < dim; ++d) {
      const float t_ = __fmul_rn(x[d], fr);
      gx[d] += G[(row++) * TP + t] * cosf(t_) * fr;
    }
    for (int d = 0; d < dim; ++d) {
      const float t_ = __fadd_rn(__fmul_rn(x[d], fr), SAHS_HALF_PI_F);
      gx[d] += G[(row++) * TP + t] * cosf(t_) * fr;
    }
  }
}

// Base cell of the corner-packed table (ops/grid._cell_geometry), with the
// JAX package's float expression and no contraction:
//   i = ((c + 1) * 0.5) * (n - 1); i0 = floor(i); base = clip(i0 + 1, 0, n)
__device__ __forceinline__ float cell_index(float c, int n) {
  return __fmul_rn(__fmul_rn(__fadd_rn(c, 1.0f), 0.5f), (float)(n - 1));
}

__device__ __forceinline__ int cell_row(const float* c, int D, int H, int W) {
  const int dims[3] = {W, H, D};
  int base[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float i0 = floorf(cell_index(c[a], dims[a]));
    base[a] = (int)fminf(fmaxf(i0 + 1.0f, 0.0f), (float)dims[a]);
  }
  return (base[2] * (H + 1) + base[1]) * (W + 1) + base[0];
}

// Where a kernel's raw points come from: a (P, 3) float32 array, or, with
// pts null, the rays (o (R, 3), d (R, 3), z (R, S)) they lie on, point
// r * S + s at o[r] + d[r] z[r, s]. The rays' positions are rounded as
// K15 (build_pts.cu) rounds them, the product and then the sum, never one
// FMA, so that a kernel reading the rays sees K15's points bit for bit.
struct PointSrc {
  const float* pts;
  const float* ro;
  const float* rd;
  const float* z;
  int S;
  __device__ __forceinline__ void load(long long p, float x[3]) const {
    if (pts != nullptr) {
      x[0] = pts[p * 3 + 0]; x[1] = pts[p * 3 + 1]; x[2] = pts[p * 3 + 2];
      return;
    }
    const long long r = p / S;
    const float zi = z[p];
#pragma unroll
    for (int c = 0; c < 3; ++c) x[c] = __fadd_rn(ro[r * 3 + c], __fmul_rn(rd[r * 3 + c], zi));
  }
};

}  // namespace sahs
