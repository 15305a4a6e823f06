// The deformation pair's backward on mma.sync: one skip MLP over a 64-point
// tile on mma.cuh's products, forward with the stash, then backward
// (skip_net_tc), for the pair tile that K2's pair= form runs inside its
// fold (pair_bwd.cuh's pair_bwd_tc_tile, level_train.cu's
// bwd_tc_fold_kernel), its only user. bf16 K3 and K14 run skip_bw.cuh's
// tile on wgmma, and the forwards K1 and K13 skip_wg.cuh's, with the same
// semantics (each k16 step summed from zero, added in float32).
//
// A deformation net is a ReLU trunk of L layers H wide (the warp field's
// 6 x 128, the hyper sheet's 6 x 64) whose layer `skip` takes [h ; pe],
// and a head of at most 8 outputs padded to 8 columns (tanh for the warp
// field, linear for the hyper sheet). skip_trunk_tc takes the tile's
// encoding already in shared memory (its rows past pe_dim zero, for the K
// padding) and runs the trunk forward, each layer's output to the
// activation stash. skip_net_tc then
//   1. runs skip_trunk_tc;
//   2. runs the head, whose epilogue forms the head's cotangent in float32
//      as the SIMT kernels do: gz = (g + g2) act'(y), zero on the padded
//      columns and past the last point, to the gz stash and, in bf16, to
//      shared memory;
//   3. goes back through the trunk with transposed weights, each product's
//      epilogue applying the ReLU's derivative from the stashed output and
//      writing gz to the gz stash (f32) and to shared memory (bf16) for the
//      next product (mma.cuh's DactStore), so no f32 tile is kept.
// dW is then mma.cuh's stash_dw_kernel over the two stashes.
//
// The warp layout follows N. tc_product's fixed layout (two 32-wide output
// groups a warp, strided by 128) would leave every warp's second group
// empty at N = 128 and four of the eight warps without outputs at N = 64.
// So a product at N = 128 (the warp field's layers) takes 32-wide groups,
// one a warp: each warp 32 points x 32 outputs; a product at N <= 64 (the
// hyper sheet's layers, the heads, the product back to the encoding) takes
// 16-wide groups: each warp 32 points x 16 outputs. All eight warps hold
// outputs at either width. The weights are staged SKIP_KS rows at a time
// (mma.cuh's ring; one barrier pair per slice), so every K is padded to
// a multiple of SKIP_KS: the trunks' widths are multiples
// of SKIP_KS (the wrappers check), the encoding's and the head cotangent's
// padding rows are zero.
#pragma once

#include "mma.cuh"

namespace sahs {

constexpr int SKIP_HMAX = 128;   // widest trunk, and widest product N
constexpr int SKIP_KS = 32;      // weight rows a staged slice

__host__ __device__ __forceinline__ int pad_ks(int n) {
  return (n + SKIP_KS - 1) / SKIP_KS * SKIP_KS;
}

// One product at the warp layout its N asks for (N <= SKIP_HMAX), the
// weights staged SKIP_KS rows a slice.
template <class Epi>
__device__ __forceinline__ void skip_product(Operand o1, Operand o2, int N,
                                             bf16* ring, const Epi& epi) {
  if (N > 64)
    tc_product_wn<32, 1, SKIP_KS>(o1, o2, N, ring, epi);
  else
    tc_product_wn<16, 1, SKIP_KS>(o1, o2, N, ring, epi);
}

// The head's epilogue: y = act(v + b[n]) as mlp_layer forms it, then the
// cotangent gz = gv act'(y) with gv = g[p][col0 + n] (+ g2, added with
// round-to-nearest), zero for n >= ncol and p >= P; gz to the stash slot
// (f32, TC_TP stride) and to G (bf16, TC_LD stride).
struct HeadGz {
  const float* b;
  int act;
  const float* g;
  const float* g2;
  int gw, col0, ncol;
  long long base, P;
  float* gz;
  bf16* G;
  long long gbase;      // g's and g2's first row is point gbase's (0: all P)
  __device__ void operator()(int t, int n, float v) const {
    const float y = apply_act(v + b[n], act);
    const long long p = base + t;
    float gv = 0.0f;
    if (n < ncol && p < P) {
      gv = g[(p - gbase) * gw + col0 + n];
      if (g2 != nullptr) gv = __fadd_rn(gv, g2[(p - gbase) * gw + col0 + n]);
    }
    const float gzv = act == ACT_TANH ? gv * (1.0f - y * y) : gv;
    gz[n * TC_TP + t] = gzv;
    G[n * TC_LD + t] = __float2bfloat16_rn(gzv);
  }
};

// Where one net's layers, slots and cotangent are.
struct SkipNet {
  const int* meta;      // forward layer descriptors
  int first;            // the net's layer 0 in meta (its head at first + L)
  const int* metaT;     // transposed layers
  int tfirst;           // the net's head^T in metaT; layer l's at tfirst + L - l
  int L, skip;
  int aslot;            // the activation slot of h_0 (the encoding's is 0)
  const float* g;       // (P, gw) cotangent of the packed output
  const float* g2;      // (P, gw) addend, or null
  int gw, col0, ncol;   // the net's columns of g: [col0, col0 + ncol)
  long long gbase = 0;  // g's and g2's first row is point gbase's (a tile's
                        // cotangent in shared memory; 0: they hold all P)
};

// The trunk of one net over the tile: layer l's output to hA for even l,
// hB for odd l, and to the activation stash (act_off[s.aslot + l]).
// Returns the tile holding h_{L-1} (hA or hB); the other is free then.
// Ends with a __syncthreads().
__device__ __forceinline__ bf16* skip_trunk_tc(const SkipNet& s, const bf16* wblob,
                                               const float* bblob, const bf16* pe,
                                               bf16* hA, bf16* hB, bf16* ring,
                                               bf16* acts, const int* act_off) {
  const Operand none = {nullptr, 0, nullptr};
  bf16* h = nullptr;
  for (int l = 0; l < s.L; ++l) {
    const LayerDesc d = load_desc(s.meta, s.first + l);
    bf16* y = h == hA ? hB : hA;
    skip_product(Operand{wblob + d.w1, d.k1, h != nullptr ? h : pe},
                 d.w2 >= 0 ? Operand{wblob + d.w2, d.k2, pe} : none, d.n, ring,
                 StoreAct{y, bblob + d.b, d.act});
    __syncthreads();
    stash_rows(y, acts + act_off[s.aslot + l], d.n);
    h = y;
  }
  return h;
}

// One net over the tile: forward, head cotangent, backward (see the top of
// this file). hA, hB: SKIP_HMAX-row tiles (TC_LD stride). Ends with a
// __syncthreads().
__device__ void skip_net_tc(const SkipNet& s, const bf16* wblob, const float* bblob,
                            const bf16* wT, const bf16* pe, bf16* hA, bf16* hB, bf16* ring,
                            bf16* acts, const int* act_off, float* gzs, const int* gz_off,
                            long long base, long long P) {
  const Operand none = {nullptr, 0, nullptr};
  const bf16* src = skip_trunk_tc(s, wblob, bblob, pe, hA, hB, ring, acts, act_off);
  // the head's gz in the free tile, its rows past the head's padded width
  // zero for head^T's K padding
  const LayerDesc head = load_desc(s.meta, s.first + s.L);
  bf16* X = src == hA ? hB : hA;
  zero_rows(X, head.n, pad_ks(head.n));
  skip_product(Operand{wblob + head.w1, head.k1, src}, none, head.n, ring,
               HeadGz{bblob + head.b, head.act, s.g, s.g2, s.gw, s.col0, s.ncol,
                      base, P, gzs + gz_off[s.first + s.L], X, s.gbase});
  __syncthreads();
  // ga_l = gz_{l+1} W_{l+1}^T (head^T for l = L - 1), gz_l = ga_l relu'(h_l)
  for (int l = s.L - 1; l >= 0; --l) {
    const LayerDesc d = load_desc(s.meta, s.first + l);
    const LayerDesc t = load_desc(s.metaT, s.tfirst + s.L - 1 - l);
    bf16* Y = X == hA ? hB : hA;
    skip_product(Operand{wT + t.w1, t.k1, X}, none, t.n, ring,
                 DactStore{acts + act_off[s.aslot + l], d.act,
                           gzs + gz_off[s.first + l], Y, nullptr, nullptr});
    __syncthreads();
    X = Y;
  }
}

// Shared memory of the pair tile, in bytes (every offset a multiple of
// 16): the encoding [pad_ks(pe_dim)], hA and hB of SKIP_HMAX rows, then the
// weight ring of SKIP_KS-row slices for outputs up to SKIP_HMAX wide.
struct SkipLayout {
  int pe, ha, hb, ring, bytes;
  __host__ __device__ explicit SkipLayout(int pe_dim) {
    const int n_pe = (pe_dim + 7) / 8 * 8;
    const int h = SKIP_HMAX * TC_LD * 2;
    pe = 0;
    ha = pe + pad_ks(pe_dim) * TC_LD * 2;
    hb = ha + h;
    ring = hb + h;
    bytes = ring + ring_bytes(n_pe > SKIP_HMAX ? n_pe : SKIP_HMAX, SKIP_KS);
  }
};

// The tile's encoding: rows [pe_dim, pad_ks(pe_dim)) zero, then per point
// pe_group's rows of its raw coordinates (zeros past the last point).
__device__ __forceinline__ void skip_pe_tile(const PointSrc& src, long long base,
                                             long long P, int n_freq, bf16* pe) {
  const int pe_dim = 3 + 6 * n_freq;
  zero_rows(pe, pe_dim, pad_ks(pe_dim));
  const int t = threadIdx.x;
  if (t < TC_TP) {
    const long long p = base + t;
    float x[3] = {0.0f, 0.0f, 0.0f};
    if (p < P) src.load(p, x);
    pe_group<bf16>(x, 3, n_freq, pe, 0, t, TC_LD);
  }
}

}  // namespace sahs
