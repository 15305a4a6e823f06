// Tensor-core device code for the one bf16 backward left on mma.sync, K2's
// pair= form (level_train.cu's bwd_tc_fold_kernel, which runs the level's
// tile here and the deformation pair's tile of pair_bwd.cuh through
// skip_tc.cuh): one MLP layer over a 64-point tile, and the split-K dW
// reduction over their stashes (stash_dw_kernel).
//
// The layer product. mlp_layer's contract (mlp.cuh) for bf16 operands:
//     Y[n][t] = act( sum_k X1[k][t] W1[k][n] (+ sum_k X2[k][t] W2[k][n]) + b[n] )
// with f32 sums, the f32 bias and the activation in the epilogue, and the
// result to shared memory in bf16 or f32. The tile's activations sit in
// shared memory k-major with a padded row stride (TC_LD, 144 bytes: eight
// consecutive rows fall on eight different 16-byte bank groups, so the
// ldmatrix reads are conflict-free). Each product is
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 with M = points, N = outputs,
// K = input features: A (points x k) comes from the k-major activations
// and B (k x outputs) from the row-major weights, both by
// ldmatrix.trans. The weights are staged in K-slices of 16 rows through a
// two-buffer ring in shared memory, filled by cp.async: slice s + 1 is in
// flight while slice s is multiplied. K is zero-padded to a multiple of 16
// on both sides: the staged weight rows past K are zero-filled by the copy
// (cp.async with a source size of 0), and the caller keeps the matching
// activation rows zero. The eight warps split the tile as 2 groups of 32
// points x 4 groups of WN outputs, UPW such groups a warp (tc_product_wn);
// the level backward takes WN = 32, UPW = 2 (tc_product: up to 8 groups
// of 32 outputs, two a warp), the deformation nets WN = 32 or 16, UPW = 1.
//
// The dW reduction (stash_dw_kernel: the level and the pair of K2's pair=
// form). dW[k][n] = sum_p A[p][k] gz[p][n] over all points, as
// train.cuh's dw_kernel (work list, 64 x 64 output tiles, split-K chunks of
// point tiles summed by dw_reduce in chunk order, so the result is
// deterministic), with the product on mma.sync: A is the stashed bf16
// activation and gz is rounded to bf16 as it is staged (the JAX package's
// _mmT semantics), sums in f32. A bias row takes the unrounded f32 gz,
// summed off the tensor cores.
//
// Every other bf16 tile runs on wgmma: the level's (level_train.cu: the
// forward fw::, the backward bw::), the deformation nets' (skip_wg.cuh's
// forward, K1 and K13; skip_bw.cuh's backward, K3 and K14), with
// wgmma.cuh, and their dW level_dw.cuh. The fold keeps these tiles, which
// reach the tensor cores with per-warp fragments and no descriptors or
// swizzles, until it moves onto the wgmma tiles too.
#pragma once

#include "train.cuh"

namespace sahs {

typedef __nv_bfloat16 bf16;

constexpr int TC_TP = 64;            // points a tile
constexpr int TC_LD = TC_TP + 8;     // bf16 row stride in shared memory
constexpr int TC_LDF = TC_TP + 4;    // f32 row stride in shared memory
constexpr int TC_THREADS = 256;      // eight warps
constexpr int TC_KS = 16;            // rows of a staged weight slice
constexpr int TC_MG = TC_TP / 32;    // groups of 32 points
constexpr int TC_UPW = 2;            // output groups of 32 a warp
constexpr int TC_NMAX = TC_UPW * (TC_THREADS / 32 / TC_MG) * 32;   // 256

__host__ __device__ __forceinline__ int pad16(int n) { return (n + 15) / 16 * 16; }

// bytes of the weight ring for outputs up to nmax wide, slices of ks rows
__host__ __device__ __forceinline__ int ring_bytes(int nmax, int ks = TC_KS) {
  return 2 * ks * (nmax + 8) * 2;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_t(unsigned r[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// d += a b, one m16n8k16 bf16 product. The 16 products of a k-step are
// summed in the tensor core from zero and then added to d in float32 with
// round-to-nearest: the tensor core's own accumulation truncates, and
// carried over a whole K it leaves the sums further from the JAX
// package's float32 semantics (_mm) than their order alone would.
__device__ __forceinline__ void mma16816(float d[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  float p[4];
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(p[0]), "=f"(p[1]), "=f"(p[2]), "=f"(p[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f), "f"(0.0f), "f"(0.0f), "f"(0.0f));
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] = __fadd_rn(d[e], p[e]);
}

// 16 bytes global -> shared, zero-filled past `bytes` (0 or 16)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One input of a product: weights (k rows x N, row-major, global) and the
// activations (k rows, TC_LD stride, shared); x null for no input.
struct Operand {
  const bf16* w;
  int k;
  const bf16* x;
};

// acc = X1^T W1 (+ X2^T W2) over the tile, then epi(t, n, value) once for
// every point t < TC_TP and output n < N. N is a multiple of 8, at most
// UPW * TC_NG * WN. The warp layout: TC_MG groups of 32 points times TC_NG
// output groups of WN columns (32 or 16), UPW such groups a warp, strided
// by TC_NG * WN. The weights are staged KS rows at a time (a multiple of
// 16: one barrier pair per KS rows), so each input's K is zero-padded to
// a multiple of KS and the caller keeps those activation rows zero. All
// TC_THREADS threads call it; the ring (ring_bytes(N, KS)) is free again
// when it returns, and callers __syncthreads() before reading what epi
// wrote.
constexpr int TC_NG = TC_THREADS / 32 / TC_MG;   // output groups a pass (4)

template <int WN, int UPW, int KS, class Epi>
__device__ void tc_product_wn(Operand o1, Operand o2, int N, bf16* ring,
                              const Epi& epi) {
  static_assert(WN == 16 || WN == 32, "a warp's output group is 16 or 32 wide");
  static_assert(KS % 16 == 0, "a staged slice is whole k-steps of 16");
  constexpr int NB = WN / 8;   // 8-wide output blocks of a group
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mat = lane >> 3, r8 = lane & 7;
  const int mg = warp % TC_MG, ng0 = warp / TC_MG;
  const int RS = N + 8;
  const int s1 = (o1.k + KS - 1) / KS;
  const int ns = s1 + (o2.x != nullptr ? (o2.k + KS - 1) / KS : 0);
  float acc[UPW][2][NB][4];
#pragma unroll
  for (int u = 0; u < UPW; ++u)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][i][j][e] = 0.0f;

  auto stage = [&](int s) {
    const bool first = s < s1;
    const bf16* W = first ? o1.w : o2.w;
    const int K = first ? o1.k : o2.k;
    const int k0 = (first ? s : s - s1) * KS;
    bf16* dst = ring + (s & 1) * KS * RS;
    const int cpr = N >> 3;
    for (int i = threadIdx.x; i < KS * cpr; i += blockDim.x) {
      const int r = i / cpr, c = i - r * cpr;
      const bool ok = k0 + r < K;
      cp_async16(dst + r * RS + c * 8, W + (size_t)(ok ? k0 + r : 0) * N + c * 8,
                 ok ? 16 : 0);
    }
    cp_async_commit();
  };

  stage(0);
  for (int s = 0; s < ns; ++s) {
    if (s + 1 < ns) {
      stage(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* X = s < s1 ? o1.x : o2.x;
    const int kk = (s < s1 ? s : s - s1) * KS;
    const bf16* Wt = ring + (s & 1) * KS * RS;
#pragma unroll
    for (int kq = 0; kq < KS; kq += 16) {
      unsigned a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4_t(a[i], X + (kk + kq + r8 + ((mat >> 1) << 3)) * TC_LD + mg * 32 +
                            i * 16 + ((mat & 1) << 3));
#pragma unroll
      for (int u = 0; u < UPW; ++u) {
        const int n0 = (ng0 + u * TC_NG) * WN;
#pragma unroll
        for (int pr = 0; pr < NB / 2; ++pr) {
          const int nb = n0 + pr * 16;
          const bf16* wr = Wt + (kq + r8 + ((mat & 1) << 3)) * RS + nb;
          if (nb + 8 < N) {
            unsigned b[4];
            ldsm_x4_t(b, wr + ((mat >> 1) << 3));
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              mma16816(acc[u][i][2 * pr], a[i], b[0], b[1]);
              mma16816(acc[u][i][2 * pr + 1], a[i], b[2], b[3]);
            }
          } else if (nb < N) {
            unsigned b[2];
            ldsm_x2_t(b, wr);
#pragma unroll
            for (int i = 0; i < 2; ++i) mma16816(acc[u][i][2 * pr], a[i], b[0], b[1]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int tq = lane >> 2, nq = 2 * (lane & 3);
#pragma unroll
  for (int u = 0; u < UPW; ++u) {
    const int n0 = (ng0 + u * TC_NG) * WN;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int n = n0 + j * 8 + nq;
      if (n0 + j * 8 >= N) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = mg * 32 + i * 16 + tq;
        epi(t, n, acc[u][i][j][0]);
        epi(t, n + 1, acc[u][i][j][1]);
        epi(t + 8, n, acc[u][i][j][2]);
        epi(t + 8, n + 1, acc[u][i][j][3]);
      }
    }
  }
}

// The level backward's layout: 32-wide output groups, two a warp, so N up
// to TC_NMAX (256).
template <class Epi>
__device__ __forceinline__ void tc_product(Operand o1, Operand o2, int N,
                                           bf16* ring, const Epi& epi) {
  tc_product_wn<32, TC_UPW, TC_KS>(o1, o2, N, ring, epi);
}

// Y[n][t] = act(v + b[n]) in bf16 (TC_LD stride)
struct StoreAct {
  bf16* y;
  const float* b;
  int act;
  __device__ void operator()(int t, int n, float v) const {
    y[n * TC_LD + t] = __float2bfloat16_rn(apply_act(v + b[n], act));
  }
};

// Y[n][t] (+)= act(v + b[n]) in f32 (TC_LDF stride); b null for no bias
struct StoreF32 {
  float* y;
  const float* b;
  int act;
  bool add;
  __device__ void operator()(int t, int n, float v) const {
    float* o = y + n * TC_LDF + t;
    const float r = apply_act(b != nullptr ? v + b[n] : v, act);
    *o = add ? *o + r : r;
  }
};

// The backward's epilogue (dact_step of train.cuh on the product's f32
// result): gz = ga * act'(y), y the layer's output read back from the stash
// (TC_TP stride; null for a linear layer), to the gz stash in f32 (TC_TP
// stride) and to shared memory in bf16 (TC_LD stride). With rx given, the
// rank-1 term round_bf16(rx[t]) * rw[n] is added to ga first: a product
// input of one row, summed off the tensor cores.
struct DactStore {
  const bf16* y;
  int act;
  float* gz;
  bf16* g;
  const float* rx;
  const bf16* rw;
  __device__ void operator()(int t, int n, float v) const {
    if (rx != nullptr)
      v = fmaf(round_to<bf16>(rx[t]), __bfloat162float(rw[n]), v);
    float d = 1.0f;
    if (act != ACT_LINEAR) {
      const float yv = __bfloat162float(y[n * TC_TP + t]);
      if (act == ACT_RELU) d = yv > 0.0f ? 1.0f : 0.0f;
      else if (act == ACT_LEAKY) d = yv > 0.0f ? 1.0f : 0.01f;
      else d = 1.0f - yv * yv;
    }
    const float gv = v * d;
    gz[n * TC_TP + t] = gv;
    g[n * TC_LD + t] = __float2bfloat16_rn(gv);
  }
};

// Copy `rows` rows of a shared tile (TC_LD stride) to a stash slot (TC_TP
// stride), 16 bytes a thread.
__device__ __forceinline__ void stash_rows(const bf16* src, bf16* dst, int rows) {
  for (int i = threadIdx.x; i < rows * (TC_TP / 8); i += blockDim.x) {
    const int r = i / (TC_TP / 8), c = i % (TC_TP / 8);
    *reinterpret_cast<uint4*>(dst + r * TC_TP + c * 8) =
        *reinterpret_cast<const uint4*>(src + r * TC_LD + c * 8);
  }
}

// Zero rows [r0, r1) of a shared tile (TC_LD stride).
__device__ __forceinline__ void zero_rows(bf16* x, int r0, int r1) {
  for (int i = threadIdx.x; i < (r1 - r0) * TC_TP; i += blockDim.x)
    x[(r0 + i / TC_TP) * TC_LD + i % TC_TP] = __float2bfloat16_rn(0.0f);
}

// ---------------------------------------------------------------------------
// dW on the tensor cores
// ---------------------------------------------------------------------------
constexpr int LDW_THREADS = 128;   // four warps, 2 x 2 over the 64 x 64 tile

// One block, one 64 x 64 tile of one product (work list as dw_kernel's),
// over one chunk of 64-point tiles. M = k, N = n, K = points: A[k][p] is
// the stash slot's rows (points contiguous), B[p][n] the gz slot's rows,
// both read by ldmatrix without transposition. Warp (wm, wn) owns k rows
// wm*32.. and n columns wn*32.. .
__global__ void __launch_bounds__(LDW_THREADS, 4)
stash_dw_kernel(const bf16* __restrict__ acts, const float* __restrict__ gzs,
                long long act_stride, long long gz_stride, int n_tiles,
                const int* __restrict__ prods, const int* __restrict__ work,
                int tiles_per_chunk, float* __restrict__ part, int out_len) {
  __shared__ __align__(16) bf16 As[DW_TILE * TC_LD];
  __shared__ __align__(16) bf16 Gs[DW_TILE * TC_LD];
  const int* wk = work + 3 * blockIdx.x;
  const int* pr = prods + 6 * wk[0];
  const int a_off = pr[0], K = pr[1], g_off = pr[2], N = pr[3];
  const int out_off = pr[4], is_bias = pr[5];
  const int k0 = wk[1], n0 = wk[2];
  const int kr = min(DW_TILE, K - k0), nr = min(DW_TILE, N - n0);
  const int chunk = blockIdx.y;
  const int tile0 = chunk * tiles_per_chunk;
  const int tile1 = min(n_tiles, tile0 + tiles_per_chunk);
  float* out = part + (long long)chunk * out_len + out_off;
  const int tid = threadIdx.x;
  if (is_bias) {
    // A = 1: the column sums of the unrounded gz, a tile's sum apart
    if (tid < nr) {
      float s = 0.0f;
      for (int tile = tile0; tile < tile1; ++tile) {
        const float* g = gzs + tile * gz_stride + g_off + (long long)(n0 + tid) * TC_TP;
        float st = 0.0f;
        for (int t = 0; t < TC_TP; ++t) st += g[t];
        s += st;
      }
      out[n0 + tid] = s;
    }
    return;
  }
  const int warp = tid >> 5, lane = tid & 31;
  const int mat = lane >> 3, r8 = lane & 7;
  const int wm = warp & 1, wn = warp >> 1;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  for (int tile = tile0; tile < tile1; ++tile) {
    const bf16* A = acts + tile * act_stride + a_off + (long long)k0 * TC_TP;
    const float* G = gzs + tile * gz_stride + g_off + (long long)n0 * TC_TP;
    for (int i = tid; i < DW_TILE * (TC_TP / 8); i += LDW_THREADS) {
      const int r = i / (TC_TP / 8), c = i % (TC_TP / 8);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < kr) v = __ldg(reinterpret_cast<const uint4*>(A + r * TC_TP + c * 8));
      *reinterpret_cast<uint4*>(As + r * TC_LD + c * 8) = v;
    }
    for (int i = tid; i < DW_TILE * (TC_TP / 4); i += LDW_THREADS) {
      const int r = i / (TC_TP / 4), c = i % (TC_TP / 4);
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r < nr) v = __ldg(reinterpret_cast<const float4*>(G + r * TC_TP + c * 4));
      __nv_bfloat162 h[2];
      h[0] = __floats2bfloat162_rn(v.x, v.y);
      h[1] = __floats2bfloat162_rn(v.z, v.w);
      *reinterpret_cast<uint2*>(Gs + r * TC_LD + c * 4) = *reinterpret_cast<uint2*>(h);
    }
    __syncthreads();
    // each 16-point sum is formed apart and then added to the running sums
#pragma unroll
    for (int kk = 0; kk < TC_TP; kk += 16) {
      unsigned a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(a[i], As + (wm * 32 + i * 16 + r8 + ((mat & 1) << 3)) * TC_LD +
                          kk + ((mat >> 1) << 3));
#pragma unroll
      for (int p2 = 0; p2 < 2; ++p2) {
        unsigned b[4];
        ldsm_x4(b, Gs + (wn * 32 + p2 * 16 + r8 + ((mat >> 1) << 3)) * TC_LD +
                       kk + ((mat & 1) << 3));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma16816(acc[i][2 * p2], a[i], b[0], b[1]);
          mma16816(acc[i][2 * p2 + 1], a[i], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }
  const int kq = lane >> 2, nq = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = wm * 32 + i * 16 + kq + (e >> 1) * 8;
        const int n = wn * 32 + j * 8 + nq + (e & 1);
        if (k < kr && n < nr) out[(long long)(k0 + k) * N + n0 + n] = acc[i][j][e];
      }
}

// Both launches of the tensor-core reduction, on `stream`; the partials
// are summed by train.cuh's dw_reduce in chunk order.
inline int launch_stash_dw(const bf16* acts, const float* gzs,
                           long long act_stride, long long gz_stride,
                           int n_tiles, const int* prods, const int* work,
                           int n_work, int chunks, float* part, float* out,
                           int out_len, cudaStream_t stream) {
  const int per = (n_tiles + chunks - 1) / chunks;
  stash_dw_kernel<<<dim3(n_work, chunks), LDW_THREADS, 0, stream>>>(
      acts, gzs, act_stride, gz_stride, n_tiles, prods, work, per, part,
      out_len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dw_reduce<<<(out_len + 255) / 256, 256, 0, stream>>>(part, chunks, out_len,
                                                      out);
  return (int)cudaGetLastError();
}

}  // namespace sahs
