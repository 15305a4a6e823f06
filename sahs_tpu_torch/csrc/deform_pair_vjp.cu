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
// trunk with transposed weights, writing each layer's gz to a second stash.
// A reduction over the stashes gives dW and db, in a fixed order. All
// launches come from one call.
//
// Bound on the H100: about 3 x 0.125 M multiply-adds a point (forward,
// backward chain, dW) against ~40 bytes of input, so operations bound it:
// ~0.2 TFLOP at 262,144 fine points, ~0.19 ms at the 989 TFLOP/s bf16 peak.
//
// Two instantiations. float32 runs pair_vjp_kernel on 32-point tiles with
// mlp.cuh's SIMT products (pair_bwd.cuh's pair_bwd_tile, the bit-exact
// oracle of the plain version) and train.cuh's dw_kernel. bf16 runs
// pair_bwd_wg_kernel, the deformation nets' backward tile on wgmma
// (skip_bw.cuh, the design is there: persistent blocks of two 64-point
// warpgroups, the weights streamed by TMA, the warp net and then the hyper
// net, bf16 stashes and the tiles' column sums of gz), and dW on
// level_dw.cuh's level_dw_kernel, bias_dw_kernel and dw_reduce, as the
// level backward's. The warp-level tensor-core kernel it replaces
// (pair_vjp_tc_kernel and its dW) read 4.70 ms a call at a step's fine
// points on an H100 (PERF.md section 6). K2's pair= form (level_train.py)
// runs K2 and then this file's rays= call on K2's gx.
//
// The rays= form (field_mlp.py:1108-1130, :1181-1192; JAX's SAHS_PAIR_RAYS
// fused step) reads the rays (o (R, 3), d (R, 3), z (R, S)) in place of the
// points and builds each tile's positions as K15 does, __fadd_rn(o,
// __fmul_rn(d, z)), so that its dW is, bit for bit, K3's on K15's points:
// the same kernels, another PointSrc (mlp.cuh).
#include "level_dw.cuh"
#include "pair_bwd.cuh"
#include "skip_bw.cuh"

namespace {

// The arguments are read in place (__grid_constant__): the tile routines
// take them by reference, which would otherwise copy them to local memory.
template <typename T>
__global__ void __launch_bounds__(256) pair_vjp_kernel(const __grid_constant__ sahs::PairBwd a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  sahs::pair_bwd_tile<T>(a, smem_raw, blockIdx.x);
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
  return sahs::launch_dw<T>(reinterpret_cast<const T*>(a.acts), a.gzs, a.act_stride,
                            a.gz_stride, (int)n_tiles, sahs::PAIR_TP, prods, work, n_work,
                            chunks, part, out, out_len, stream);
}

// ---------------------------------------------------------------------------
// bf16: the backward tile on wgmma (skip_bw.cuh) and the dW of level_dw.cuh
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(sb::THREADS, 1)
pair_bwd_wg_kernel(const __grid_constant__ sb::Args a) {
  extern __shared__ __align__(1024) unsigned char sb_smem[];
  sb::tile(a, sb_smem);
}

// The wgmma launches: the tile's Args from the plan's host tables (descs,
// descs_t of n_t layers, act_off), the stage blobs wf and wb, the bf16
// stashes and bsum; then the dW over n_items work items.
struct WgCall {
  const void *wf, *wb, *descs, *descs_t, *act_off, *items;
  long long wf_bytes, wb_bytes;
  int n_t, n_items;
  void* bsum;
};

int launch_wg(const sahs::PointSrc& src, long long P, const float* g, const float* g2,
              float* gx, const float* b, int n_warp, int n_hyper, int warp_skip,
              int hyper_skip, int n_freq, int ho, void* acts, void* gzs, long long act_stride,
              long long gz_stride, int chunks, int out_len, const int* prods, float* part,
              float* out, const WgCall& w, cudaStream_t stream) {
  if (w.descs == nullptr || w.descs_t == nullptr || w.act_off == nullptr ||
      (gx != nullptr && w.n_t < n_warp + n_hyper + 2))
    return (int)cudaErrorInvalidValue;
  sb::Args a = sb::args_of((const int*)w.descs, (const int*)w.descs_t, w.n_t,
                           (const int*)w.act_off, 2, n_warp, n_hyper);
  a.pts = src;
  a.wf = w.wf; a.wf_bytes = w.wf_bytes; a.wb = w.wb; a.wb_bytes = w.wb_bytes;
  a.b = b; a.g = g; a.g2 = g2; a.gx = gx;
  a.acts = (sb::bf16*)acts; a.gzs = (sb::bf16*)gzs; a.bsum = (float*)w.bsum;
  a.P = P; a.act_stride = act_stride; a.gz_stride = gz_stride;
  a.skip[0] = warp_skip; a.skip[1] = hyper_skip;
  a.gw = 3 + ho; a.col0[0] = 0; a.col0[1] = 3; a.ncol[0] = 3; a.ncol[1] = ho;
  a.pe_dim = 3 + 6 * n_freq; a.n_freq = n_freq; a.residual = 1;
  int err = sb::launch(pair_bwd_wg_kernel, a, stream);
  if (err) return err;
  const int n_tiles = (int)((P + sb::TP - 1) / sb::TP);
  return ldw::launch_level_dw(a.acts, a.gzs, a.bsum, act_stride, gz_stride, n_tiles, prods,
                              (const int*)w.items, w.n_items, chunks, part, out, out_len,
                              a.b_len, stream);
}

int vjp_call(const sahs::PointSrc& src, long long P, const void* g, const void* g2,
             void* gx, const void* w, const void* b, const void* meta, const void* wT,
             const void* bT, const void* metaT, int n_warp, int n_hyper,
             int warp_skip, int hyper_skip, int n_freq, int ho, int bf16,
             const void* slots, void* acts, void* gzs, int n_act, int act_stride,
             int gz_stride, int n_work, int chunks, int out_len, const void* prods,
             const void* work, void* part, void* out, const WgCall& wc, void* stream) {
  if (P <= 0) return 0;
  if (3 + 6 * n_freq > sahs::PAIR_HMAX) return (int)cudaErrorInvalidValue;
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
    return launch_wg(src, P, a.g, a.g2, a.gx, a.b, n_warp, n_hyper, warp_skip, hyper_skip,
                     n_freq, ho, acts, gzs, act_stride, gz_stride, chunks, out_len, pr,
                     (float*)part, (float*)out, wc, s);
  return launch<float>(a, n_work, chunks, out_len, pr, wk, (float*)part,
                       (float*)out, s);
}

}  // namespace

// bf16 also takes the tile's stage blobs (wf, wb and their bytes), the
// plan's host tables (descs, descs_t of n_t layers, act_off), the tiles'
// column sums bsum and the dW's work items; float32 reads none of them.
extern "C" int sahs_deform_pair_vjp(
    const void* pts, long long P, const void* g, const void* g2, void* gx,
    const void* w, const void* b, const void* meta, const void* wT,
    const void* bT, const void* metaT, int n_warp, int n_hyper, int warp_skip,
    int hyper_skip, int n_freq, int ho, int bf16, const void* slots,
    void* acts, void* gzs, int n_act, int act_stride, int gz_stride,
    int n_work, int chunks, int out_len, const void* prods, const void* work,
    void* part, void* out, const void* wf, long long wf_bytes, const void* wb,
    long long wb_bytes, const void* descs, const void* descs_t, int n_t, const void* act_off,
    void* bsum, const void* items, int n_items, void* stream) {
  const sahs::PointSrc src = {(const float*)pts, nullptr, nullptr, nullptr, 1};
  return vjp_call(src, P, g, g2, gx, w, b, meta, wT, bT, metaT, n_warp, n_hyper,
                  warp_skip, hyper_skip, n_freq, ho, bf16, slots, acts, gzs, n_act,
                  act_stride, gz_stride, n_work, chunks, out_len, prods, work, part,
                  out, WgCall{wf, wb, descs, descs_t, act_off, items, wf_bytes, wb_bytes, n_t,
                              n_items, bsum},
                  stream);
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
    void* part, void* out, const void* wf, long long wf_bytes, const void* wb,
    long long wb_bytes, const void* descs, const void* descs_t, int n_t, const void* act_off,
    void* bsum, const void* items, int n_items, void* stream) {
  if (S <= 0 || ro == nullptr || rd == nullptr || z == nullptr)
    return (int)cudaErrorInvalidValue;
  const sahs::PointSrc src = {nullptr, (const float*)ro, (const float*)rd,
                              (const float*)z, S};
  return vjp_call(src, R * S, g, g2, gx, w, b, meta, wT, bT, metaT, n_warp, n_hyper,
                  warp_skip, hyper_skip, n_freq, ho, bf16, slots, acts, gzs, n_act,
                  act_stride, gz_stride, n_work, chunks, out_len, prods, work, part,
                  out, WgCall{wf, wb, descs, descs_t, act_off, items, wf_bytes, wb_bytes, n_t,
                              n_items, bsum},
                  stream);
}
