// The deformation pair's backward over one tile of points, float32 K3's
// tile (deform_pair_vjp.cu): pair_bwd_tile on PAIR_TP-point tiles with
// mlp.cuh's SIMT products, the bit-exact oracle of the plain version. bf16
// K3 runs skip_bw.cuh's tile on wgmma.
//
// One tile recomputes the shared positional encoding of its raw points and
// both trunks (the forward of K1), writing each layer's input to a
// device-memory stash, then takes the packed cotangent g (+ the addend g2)
// back through each head and trunk with transposed weights, writing each
// layer's gz to a second stash (train.cuh); the split-K reduction over the
// two stashes then gives dW and db. With gx given, each net also takes its
// cotangent back to the shared encoding, and one PE backward per point
// gives the cotangent of the raw points (deform_pair_vjp.cu's note).
//
// The points come from a PointSrc (mlp.cuh): K3's (P, 3) array, or the
// rays (o, d, z) of K3's rays= form, rounded as K15.
#pragma once

#include "train.cuh"

namespace sahs {

constexpr int PAIR_TP = 32;          // points a float32 tile
constexpr int PAIR_HMAX = 128;       // widest trunk of the float32 tile

struct PairBwd {
  PointSrc src;          // the raw points, or the rays they lie on
  const float* g;        // (P, gw) with gw = 3 + ho
  const float* g2;       // (P, gw) or null
  float* gx;             // (P, 3), or null: no cotangent of the points
  const void* w;         // forward blob (K1's), compute dtype
  const float* b;
  const int* meta;
  const void* wT;        // transposed blob: per net head, layers L-1 .. 1;
                         // with gx, then per net its layer back to the PE
  const float* bT;
  const int* metaT;
  const int* slots;      // act slot offsets [n_act], then gz slot offsets
  void* acts;            // activation stash, compute dtype
  float* gzs;            // cotangent stash
  long long P, act_stride, gz_stride;
  int n_warp, n_hyper, warp_skip, hyper_skip, n_freq, ho, n_act;
};

// Shared memory of the float32 tile: the encoding, four activation tiles,
// an f32 product tile and the heads' outputs; with gx also the skip layer's
// gz and the sum of the nets' PE cotangents.
template <typename T>
__host__ __device__ __forceinline__ size_t pair_bwd_smem(int n_freq, bool gx) {
  const int pe_dim = 3 + 6 * n_freq;
  size_t smem = (size_t)(pe_dim + 4 * PAIR_HMAX) * PAIR_TP * sizeof(T) +
                (size_t)(PAIR_HMAX + 8) * PAIR_TP * sizeof(float);
  if (gx)   // gS and gpe
    smem += (size_t)PAIR_HMAX * PAIR_TP * sizeof(T) +
            (size_t)(pe_dim + 7) / 8 * 8 * PAIR_TP * sizeof(float);
  return smem;
}

// The float32 tile `tile` of PAIR_TP points; all threads of the block.
template <typename T>
__device__ __forceinline__ void pair_bwd_tile(const PairBwd& a, unsigned char* smem_raw,
                                              long long tile) {
  constexpr int TP = PAIR_TP;
  const int pe_dim = 3 + 6 * a.n_freq;
  const int hmax = PAIR_HMAX;
  T* pe = reinterpret_cast<T*>(smem_raw);
  T* hA = pe + pe_dim * TP;
  T* hB = hA + hmax * TP;
  T* gA = hB + hmax * TP;
  T* gB = gA + hmax * TP;
  float* fout = reinterpret_cast<float*>(gB + hmax * TP);   // [hmax][TP]
  float* y = fout + hmax * TP;                              // [8][TP]
  // with gx: the skip layer's gz, and the sum of the nets' PE cotangents
  T* gS = reinterpret_cast<T*>(y + 8 * TP);                 // [hmax][TP]
  float* gpe = reinterpret_cast<float*>(gS + hmax * TP);    // [pad8(pe_dim)][TP]
  const T* wblob = reinterpret_cast<const T*>(a.w);
  const T* wT = reinterpret_cast<const T*>(a.wT);
  const long long base = tile * TP;
  T* acts = reinterpret_cast<T*>(a.acts) + tile * a.act_stride;
  float* gzs = a.gzs + tile * a.gz_stride;
  const int* act_off = a.slots;
  const int* gz_off = a.slots + a.n_act;
  const int tid = threadIdx.x;
  const int gw = 3 + a.ho;

  if (tid < TP) {
    const long long p = base + tid;
    float x[3] = {0.0f, 0.0f, 0.0f};
    if (p < a.P) a.src.load(p, x);
    pe_group<T>(x, 3, a.n_freq, pe, 0, tid, TP);
  }
  __syncthreads();
  store_rows<T>(pe, acts + act_off[0], pe_dim, TP);

  for (int net = 0; net < 2; ++net) {
    const int L = net == 0 ? a.n_warp : a.n_hyper;
    const int first = net == 0 ? 0 : a.n_warp + 1;      // forward layer index
    const int aslot = net == 0 ? 1 : 1 + a.n_warp;      // act slot of h_0
    const int boff = net == 0 ? 0 : a.n_warp;           // transposed layers
    const int col0 = net == 0 ? 0 : 3;
    const int ncol = net == 0 ? 3 : a.ho;
    // forward, stashing every layer's output (the next layer's input)
    const T* src = pe;
    T* dst = hA;
    for (int l = 0; l < L; ++l) {
      const LayerDesc d = load_desc(a.meta, first + l);
      mlp_layer<T>(d, wblob, a.b, src, d.w2 >= 0 ? pe : nullptr, nullptr, dst,
                   nullptr, TP);
      __syncthreads();
      store_rows<T>(dst, acts + act_off[aslot + l], d.n, TP);
      src = dst;
      dst = dst == hA ? hB : hA;
    }
    const LayerDesc head = load_desc(a.meta, first + L);
    mlp_layer<T>(head, wblob, a.b, src, nullptr, nullptr, nullptr, y, TP);
    __syncthreads();
    // head: gz = (g + g2) * act'(y) over the padded head width
    for (int i = tid; i < head.n * TP; i += blockDim.x) {
      const int j = i / TP, t = i % TP;
      const long long p = base + t;
      float gv = 0.0f;
      if (j < ncol && p < a.P) {
        gv = a.g[p * gw + col0 + j];
        if (a.g2 != nullptr) gv = __fadd_rn(gv, a.g2[p * gw + col0 + j]);
      }
      const float yv = y[i];
      const float gz = head.act == ACT_TANH ? gv * (1.0f - yv * yv) : gv;
      gzs[gz_off[first + L] + i] = gz;
      gA[i] = from_f<T>(gz);
    }
    __syncthreads();
    mlp_layer<T>(load_desc(a.metaT, boff), wT, a.bT, gA, nullptr, nullptr, nullptr,
                 fout, TP);
    __syncthreads();
    const int skip = net == 0 ? a.warp_skip : a.hyper_skip;
    const bool skip_fires = skip > 0 && skip < L;
    for (int l = L - 1; l >= 0; --l) {
      const LayerDesc d = load_desc(a.meta, first + l);
      dact_step<T>(fout, acts + act_off[aslot + l], d.act, d.n, TP,
                   gzs + gz_off[first + l], gB);
      __syncthreads();
      if (a.gx != nullptr && skip_fires && l == skip)
        for (int i = tid; i < d.n * TP; i += blockDim.x) gS[i] = gB[i];
      if (l > 0) {
        mlp_layer<T>(load_desc(a.metaT, boff + L - l), wT, a.bT, gB, nullptr,
                     nullptr, nullptr, fout, TP);
        __syncthreads();
      }
    }
    if (a.gx == nullptr) continue;
    // back to the encoding: gz_0 W_0^T (+ gz_skip W_skip,pe^T), summed
    // over the two nets in float32
    const LayerDesc dpe = load_desc(a.metaT, a.n_warp + a.n_hyper + net);
    mlp_layer<T>(dpe, wT, a.bT, gB, skip_fires ? gS : nullptr, nullptr, nullptr,
                 fout, TP);
    __syncthreads();
    for (int i = tid; i < dpe.n * TP; i += blockDim.x)
      gpe[i] = net == 0 ? fout[i] : gpe[i] + fout[i];
    __syncthreads();
  }
  if (a.gx == nullptr) return;
  // the one PE backward, then the residual of the warped coordinates
  if (tid < TP) {
    const long long p = base + tid;
    if (p < a.P) {
      float x[3];
      a.src.load(p, x);
      float gx[3] = {0.0f, 0.0f, 0.0f};
      pe_group_bwd(x, 3, a.n_freq, gpe, 0, tid, TP, gx);
      for (int c = 0; c < 3; ++c) {
        float gv = a.g[p * gw + c];
        if (a.g2 != nullptr) gv = __fadd_rn(gv, a.g2[p * gw + c]);
        a.gx[p * 3 + c] = gx[c] + gv;
      }
    }
  }
}

}  // namespace sahs
