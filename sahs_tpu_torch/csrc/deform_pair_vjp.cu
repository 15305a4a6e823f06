// K3: the deformation pair's backward.
//
// Replaces sahs_tpu/ops/pallas/field_mlp.py:deform_pair_vjp (:1098,
// pallas_call at :1233): from the raw fine points (P, 3) and the packed
// cotangent g (+ the coarse-slot addend g2) (P, 3 + ambient), the dW and
// db of the warp trunk (6x128 ReLU, skip at 4) and tanh head and of the
// hyper trunk (6x64 ReLU, skip at 4) and linear head, conditioning folded.
// The fused train path asks for nothing more (need_gx=False,
// train/fused.py:433-436). With gx given (need_gx, field_mlp.py:1089-1094)
// each net also takes its cotangent back to the shared encoding (layer 0
// and the skip layer's pe rows, one two-input product, as K14), the two
// are summed in float32 (warp + hyper), and one PE backward per point
// gives gx (P, 3) = pe_bwd(x, gpe_warp + gpe_hyper) + (g + g2)[:, :3], the
// last term the residual of the warped coordinates x + warp(x).
//
// Design: per tile, one block recomputes the shared positional encoding
// and both trunks (the forward of K1), writing each layer's input to a
// device-memory stash, then backpropagates g + g2 through each head and
// trunk with transposed weights, writing each layer's gz to a second stash
// (train.cuh). A split-K reduction over the stashes gives dW and db, in a
// fixed order. All launches come from one call.
//
// Bound on the H100: about 3 x 0.125 M multiply-adds a point (forward,
// backward chain, dW) against ~40 bytes of input, so operations bound it:
// ~0.2 TFLOP at 262,144 fine points, ~0.2 ms at the 989 TFLOP/s bf16 peak.
//
// Two instantiations. float32 runs pair_vjp_kernel on 32-point tiles with
// mlp.cuh's SIMT products and train.cuh's dw_kernel. bf16 runs
// pair_vjp_tc_kernel on 64-point tiles: one encoding tile, then
// skip_tc.cuh's skip_net_tc for the warp net and then the hyper net, each
// product on the tensor cores (mma.sync m16n8k16, at the warp layout its
// width asks for), and dW on mma.cuh's level_dw_kernel.
#include "skip_tc.cuh"

namespace {

constexpr int TP = 32;
constexpr int THREADS = 256;

struct VjpArgs {
  const float* pts;      // (P, 3)
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

template <typename T>
__global__ void __launch_bounds__(THREADS) pair_vjp_kernel(VjpArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pe_dim = 3 + 6 * a.n_freq;
  const int hmax = 128;
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
  const long long tile = blockIdx.x;
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
    if (p < a.P) {
      x[0] = a.pts[p * 3 + 0]; x[1] = a.pts[p * 3 + 1]; x[2] = a.pts[p * 3 + 2];
    }
    sahs::pe_group<T>(x, 3, a.n_freq, pe, 0, tid, TP);
  }
  __syncthreads();
  sahs::store_rows<T>(pe, acts + act_off[0], pe_dim, TP);

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
      const sahs::LayerDesc d = sahs::load_desc(a.meta, first + l);
      sahs::mlp_layer<T>(d, wblob, a.b, src, d.w2 >= 0 ? pe : nullptr,
                         nullptr, dst, nullptr, TP);
      __syncthreads();
      sahs::store_rows<T>(dst, acts + act_off[aslot + l], d.n, TP);
      src = dst;
      dst = dst == hA ? hB : hA;
    }
    const sahs::LayerDesc head = sahs::load_desc(a.meta, first + L);
    sahs::mlp_layer<T>(head, wblob, a.b, src, nullptr, nullptr, nullptr, y, TP);
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
      const float gz = head.act == sahs::ACT_TANH ? gv * (1.0f - yv * yv) : gv;
      gzs[gz_off[first + L] + i] = gz;
      gA[i] = sahs::from_f<T>(gz);
    }
    __syncthreads();
    sahs::mlp_layer<T>(sahs::load_desc(a.metaT, boff), wT, a.bT, gA, nullptr,
                       nullptr, nullptr, fout, TP);
    __syncthreads();
    const int skip = net == 0 ? a.warp_skip : a.hyper_skip;
    const bool skip_fires = skip > 0 && skip < L;
    for (int l = L - 1; l >= 0; --l) {
      const sahs::LayerDesc d = sahs::load_desc(a.meta, first + l);
      sahs::dact_step<T>(fout, acts + act_off[aslot + l], d.act, d.n, TP,
                         gzs + gz_off[first + l], gB);
      __syncthreads();
      if (a.gx != nullptr && skip_fires && l == skip)
        for (int i = tid; i < d.n * TP; i += blockDim.x) gS[i] = gB[i];
      if (l > 0) {
        sahs::mlp_layer<T>(sahs::load_desc(a.metaT, boff + L - l), wT, a.bT,
                           gB, nullptr, nullptr, nullptr, fout, TP);
        __syncthreads();
      }
    }
    if (a.gx == nullptr) continue;
    // back to the encoding: gz_0 W_0^T (+ gz_skip W_skip,pe^T), summed
    // over the two nets in float32
    const sahs::LayerDesc dpe = sahs::load_desc(a.metaT, a.n_warp + a.n_hyper + net);
    sahs::mlp_layer<T>(dpe, wT, a.bT, gB, skip_fires ? gS : nullptr, nullptr,
                       nullptr, fout, TP);
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
      const float x[3] = {a.pts[p * 3 + 0], a.pts[p * 3 + 1], a.pts[p * 3 + 2]};
      float gx[3] = {0.0f, 0.0f, 0.0f};
      sahs::pe_group_bwd(x, 3, a.n_freq, gpe, 0, tid, TP, gx);
      for (int c = 0; c < 3; ++c) {
        float gv = a.g[p * gw + c];
        if (a.g2 != nullptr) gv = __fadd_rn(gv, a.g2[p * gw + c]);
        a.gx[p * 3 + c] = gx[c] + gv;
      }
    }
  }
}

template <typename T>
int launch(const VjpArgs& a, int n_work, int chunks, int out_len,
           const int* prods, const int* work, float* part, float* out,
           cudaStream_t stream) {
  const int pe_dim = 3 + 6 * a.n_freq;
  size_t smem = (size_t)(pe_dim + 4 * 128) * TP * sizeof(T) +
                (size_t)(128 + 8) * TP * sizeof(float);
  if (a.gx != nullptr)   // gS and gpe
    smem += (size_t)128 * TP * sizeof(T) + (size_t)(pe_dim + 7) / 8 * 8 * TP * sizeof(float);
  int err = sahs::set_smem(pair_vjp_kernel<T>, smem);
  if (err) return err;
  const long long n_tiles = (a.P + TP - 1) / TP;
  pair_vjp_kernel<T><<<(unsigned)n_tiles, THREADS, smem, stream>>>(a);
  err = (int)cudaGetLastError();
  if (err) return err;
  return sahs::launch_dw<T>(reinterpret_cast<const T*>(a.acts), a.gzs,
                            a.act_stride, a.gz_stride, (int)n_tiles, TP,
                            prods, work, n_work, chunks, part, out, out_len,
                            stream);
}

// ---------------------------------------------------------------------------
// bf16: 64-point tiles on the tensor cores (skip_tc.cuh, mma.cuh)
// ---------------------------------------------------------------------------
using sahs::bf16;

__global__ void __launch_bounds__(sahs::TC_THREADS, 2) pair_vjp_tc_kernel(VjpArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pe_dim = 3 + 6 * a.n_freq;
  const bool to_pe = a.gx != nullptr;
  const sahs::SkipLayout ly(pe_dim, to_pe, sahs::SKIP_KS, to_pe);
  bf16* pe = reinterpret_cast<bf16*>(smem_raw + ly.pe);
  bf16* hA = reinterpret_cast<bf16*>(smem_raw + ly.ha);
  bf16* hB = reinterpret_cast<bf16*>(smem_raw + ly.hb);
  bf16* gS = to_pe ? reinterpret_cast<bf16*>(smem_raw + ly.gs) : nullptr;
  float* gpe = to_pe ? reinterpret_cast<float*>(smem_raw + ly.gp) : nullptr;
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + ly.ring);
  const bf16* wblob = reinterpret_cast<const bf16*>(a.w);
  const bf16* wT = reinterpret_cast<const bf16*>(a.wT);
  const long long tile = blockIdx.x, base = tile * sahs::TC_TP;
  bf16* acts = reinterpret_cast<bf16*>(a.acts) + tile * a.act_stride;
  float* gzs = a.gzs + tile * a.gz_stride;
  const int* act_off = a.slots;
  const int* gz_off = a.slots + a.n_act;

  sahs::skip_pe_tile(a.pts, base, a.P, a.n_freq, pe);
  __syncthreads();
  sahs::stash_rows(pe, acts + act_off[0], pe_dim);
  const int gw = 3 + a.ho;
  const sahs::SkipNet warp = {a.meta, 0, a.metaT, 0, a.n_warp, a.warp_skip, 1,
                              a.g, a.g2, gw, 0, 3};
  const sahs::SkipNet hyper = {a.meta, a.n_warp + 1, a.metaT, a.n_warp,
                               a.n_hyper, a.hyper_skip, 1 + a.n_warp,
                               a.g, a.g2, gw, 3, a.ho};
  const sahs::Operand none = {nullptr, 0, nullptr};
  for (int net = 0; net < 2; ++net) {
    const sahs::SkipNet& s = net == 0 ? warp : hyper;
    const bf16* g0 = sahs::skip_net_tc(s, wblob, a.b, wT, pe, hA, hB, gS, ring,
                                       acts, act_off, gzs, gz_off, base, a.P);
    if (!to_pe) continue;
    // back to the encoding, one two-input product (as K14's), its f32
    // result added to the warp net's in gpe: gpe_warp + gpe_hyper
    const bool skip_fires = s.skip > 0 && s.skip < s.L;
    const sahs::LayerDesc d = sahs::load_desc(a.metaT, a.n_warp + a.n_hyper + net);
    sahs::skip_product(sahs::Operand{wT + d.w1, d.k1, g0},
                       skip_fires ? sahs::Operand{wT + d.w2, d.k2, gS} : none, d.n,
                       ring, sahs::StoreF32{gpe, nullptr, sahs::ACT_LINEAR, net == 1});
    __syncthreads();
  }
  if (!to_pe) return;
  // the one PE backward, then the residual of the warped coordinates
  const int tid = threadIdx.x;
  const long long p = base + tid;
  if (tid < sahs::TC_TP && p < a.P) {
    const float x[3] = {a.pts[p * 3 + 0], a.pts[p * 3 + 1], a.pts[p * 3 + 2]};
    float gx[3] = {0.0f, 0.0f, 0.0f};
    sahs::pe_group_bwd(x, 3, a.n_freq, gpe, 0, tid, sahs::TC_LDF, gx);
    for (int c = 0; c < 3; ++c) {
      float gv = a.g[p * gw + c];
      if (a.g2 != nullptr) gv = __fadd_rn(gv, a.g2[p * gw + c]);
      a.gx[p * 3 + c] = gx[c] + gv;
    }
  }
}

int launch_tc(const VjpArgs& a, int n_work, int chunks, int out_len,
              const int* prods, const int* work, float* part, float* out,
              cudaStream_t stream) {
  const bool to_pe = a.gx != nullptr;
  const sahs::SkipLayout ly(3 + 6 * a.n_freq, to_pe, sahs::SKIP_KS, to_pe);
  int err = sahs::set_smem(pair_vjp_tc_kernel, ly.bytes);
  if (err) return err;
  const long long n_tiles = (a.P + sahs::TC_TP - 1) / sahs::TC_TP;
  pair_vjp_tc_kernel<<<(unsigned)n_tiles, sahs::TC_THREADS, ly.bytes, stream>>>(a);
  err = (int)cudaGetLastError();
  if (err) return err;
  return sahs::launch_level_dw(reinterpret_cast<const bf16*>(a.acts), a.gzs,
                               a.act_stride, a.gz_stride, (int)n_tiles, prods,
                               work, n_work, chunks, part, out, out_len, stream);
}

}  // namespace

extern "C" int sahs_deform_pair_vjp(
    const void* pts, long long P, const void* g, const void* g2, void* gx,
    const void* w, const void* b, const void* meta, const void* wT,
    const void* bT, const void* metaT, int n_warp, int n_hyper, int warp_skip,
    int hyper_skip, int n_freq, int ho, int bf16, const void* slots,
    void* acts, void* gzs, int n_act, int act_stride, int gz_stride,
    int n_work, int chunks, int out_len, const void* prods, const void* work,
    void* part, void* out, void* stream) {
  if (P <= 0) return 0;
  if (3 + 6 * n_freq > sahs::SKIP_HMAX) return (int)cudaErrorInvalidValue;
  VjpArgs a;
  a.pts = (const float*)pts; a.g = (const float*)g; a.g2 = (const float*)g2;
  a.gx = (float*)gx;
  a.w = w; a.b = (const float*)b; a.meta = (const int*)meta;
  a.wT = wT; a.bT = (const float*)bT; a.metaT = (const int*)metaT;
  a.slots = (const int*)slots; a.acts = acts; a.gzs = (float*)gzs;
  a.P = P; a.act_stride = act_stride; a.gz_stride = gz_stride;
  a.n_warp = n_warp; a.n_hyper = n_hyper; a.warp_skip = warp_skip;
  a.hyper_skip = hyper_skip; a.n_freq = n_freq; a.ho = ho;
  a.n_act = n_act;
  auto s = reinterpret_cast<cudaStream_t>(stream);
  auto pr = (const int*)prods;
  auto wk = (const int*)work;
  if (bf16)
    return launch_tc(a, n_work, chunks, out_len, pr, wk, (float*)part,
                     (float*)out, s);
  return launch<float>(a, n_work, chunks, out_len, pr, wk, (float*)part,
                       (float*)out, s);
}
