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
// width asks for), and dW on mma.cuh's stash_dw_kernel. Each kernel is one
// tile routine of pair_bwd.cuh, which K2's pair= form also runs.
//
// The rays= form (field_mlp.py:1108-1130, :1181-1192; JAX's SAHS_PAIR_RAYS
// fused step) reads the rays (o (R, 3), d (R, 3), z (R, S)) in place of the
// points and builds each tile's positions as K15 does, __fadd_rn(o,
// __fmul_rn(d, z)), so that its dW is, bit for bit, K3's on K15's points:
// the same kernels, another PointSrc (mlp.cuh).
#include "pair_bwd.cuh"

namespace {

// The arguments are read in place (__grid_constant__): the tile routines
// take them by reference, which would otherwise copy them to local memory.
template <typename T>
__global__ void __launch_bounds__(256) pair_vjp_kernel(const __grid_constant__ sahs::PairBwd a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  sahs::pair_bwd_tile<T>(a, a.g, 0, smem_raw, blockIdx.x);
}

template <typename T>
int launch(const sahs::PairBwd& a, int n_work, int chunks, int out_len,
           const int* prods, const int* work, float* part, float* out,
           cudaStream_t stream) {
  const size_t smem = sahs::pair_bwd_smem<T>(a.n_freq, a.gx != nullptr);
  int err = sahs::set_smem(pair_vjp_kernel<T>, smem);
  if (err) return err;
  const long long n_tiles = (a.P + sahs::PAIR_TP - 1) / sahs::PAIR_TP;
  pair_vjp_kernel<T><<<(unsigned)n_tiles, 256, smem, stream>>>(a);
  err = (int)cudaGetLastError();
  if (err) return err;
  return sahs::pair_dw<T>(a, (int)n_tiles, prods, work, n_work, chunks, part, out,
                          out_len, stream);
}

// ---------------------------------------------------------------------------
// bf16: 64-point tiles on the tensor cores (skip_tc.cuh, mma.cuh)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(sahs::TC_THREADS, 2)
pair_vjp_tc_kernel(const __grid_constant__ sahs::PairBwd a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  sahs::pair_bwd_tc_tile(a, a.g, 0, smem_raw, blockIdx.x);
}

int launch_tc(const sahs::PairBwd& a, int n_work, int chunks, int out_len,
              const int* prods, const int* work, float* part, float* out,
              cudaStream_t stream) {
  const sahs::SkipLayout ly = sahs::pair_bwd_tc_layout(a.n_freq, a.gx != nullptr);
  int err = sahs::set_smem(pair_vjp_tc_kernel, ly.bytes);
  if (err) return err;
  const long long n_tiles = (a.P + sahs::TC_TP - 1) / sahs::TC_TP;
  pair_vjp_tc_kernel<<<(unsigned)n_tiles, sahs::TC_THREADS, ly.bytes, stream>>>(a);
  err = (int)cudaGetLastError();
  if (err) return err;
  return sahs::pair_dw<sahs::bf16>(a, (int)n_tiles, prods, work, n_work, chunks,
                                   part, out, out_len, stream);
}

int vjp_call(const sahs::PointSrc& src, long long P, const void* g, const void* g2,
             void* gx, const void* w, const void* b, const void* meta, const void* wT,
             const void* bT, const void* metaT, int n_warp, int n_hyper,
             int warp_skip, int hyper_skip, int n_freq, int ho, int bf16,
             const void* slots, void* acts, void* gzs, int n_act, int act_stride,
             int gz_stride, int n_work, int chunks, int out_len, const void* prods,
             const void* work, void* part, void* out, void* stream) {
  if (P <= 0) return 0;
  if (3 + 6 * n_freq > sahs::SKIP_HMAX) return (int)cudaErrorInvalidValue;
  sahs::PairBwd a;
  a.src = src;
  a.g = (const float*)g; a.g2 = (const float*)g2; a.gx = (float*)gx;
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

}  // namespace

extern "C" int sahs_deform_pair_vjp(
    const void* pts, long long P, const void* g, const void* g2, void* gx,
    const void* w, const void* b, const void* meta, const void* wT,
    const void* bT, const void* metaT, int n_warp, int n_hyper, int warp_skip,
    int hyper_skip, int n_freq, int ho, int bf16, const void* slots,
    void* acts, void* gzs, int n_act, int act_stride, int gz_stride,
    int n_work, int chunks, int out_len, const void* prods, const void* work,
    void* part, void* out, void* stream) {
  const sahs::PointSrc src = {(const float*)pts, nullptr, nullptr, nullptr, 1};
  return vjp_call(src, P, g, g2, gx, w, b, meta, wT, bT, metaT, n_warp, n_hyper,
                  warp_skip, hyper_skip, n_freq, ho, bf16, slots, acts, gzs, n_act,
                  act_stride, gz_stride, n_work, chunks, out_len, prods, work, part,
                  out, stream);
}

// The rays= form: the points of R rays of S samples, o (R, 3), d (R, 3),
// z (R, S) float32; the rest as sahs_deform_pair_vjp.
extern "C" int sahs_deform_pair_vjp_rays(
    const void* ro, const void* rd, const void* z, long long R, int S,
    const void* g, const void* g2, void* gx,
    const void* w, const void* b, const void* meta, const void* wT,
    const void* bT, const void* metaT, int n_warp, int n_hyper, int warp_skip,
    int hyper_skip, int n_freq, int ho, int bf16, const void* slots,
    void* acts, void* gzs, int n_act, int act_stride, int gz_stride,
    int n_work, int chunks, int out_len, const void* prods, const void* work,
    void* part, void* out, void* stream) {
  if (S <= 0 || ro == nullptr || rd == nullptr || z == nullptr)
    return (int)cudaErrorInvalidValue;
  const sahs::PointSrc src = {nullptr, (const float*)ro, (const float*)rd,
                              (const float*)z, S};
  return vjp_call(src, R * S, g, g2, gx, w, b, meta, wT, bT, metaT, n_warp, n_hyper,
                  warp_skip, hyper_skip, n_freq, ho, bf16, slots, acts, gzs, n_act,
                  act_stride, gz_stride, n_work, chunks, out_len, prods, work, part,
                  out, stream);
}
