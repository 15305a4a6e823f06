// K1: the warp + hyper-sheet deformation pair, forward.
//
// Replaces sahs_tpu/ops/pallas/field_mlp.py:deform_pair_forward (:868,
// pallas_call at :1022). Both MLPs run on one in-kernel positional encoding
// of the raw point (10 frequencies, 63 values): the warp trunk (6x128 ReLU,
// skip at layer 4, tanh head of 3) and the hyper trunk (6x64 ReLU, skip at
// 4, linear head of 2), the per-frame conditioning already folded into the
// input and skip biases. Output per point: [x + warp(x) | ambient], and
// the corner-table row of the warped point, computed with the
// exact float expression of ops/grid._cell_geometry so that it is
// bit-identical to a row computed from the output coordinates. A model
// without the grid passes no rows buffer and gets no rows (JAX's
// emit_rows=None).
//
// Bound on the H100: about 0.25 MFLOP per point against 20 bytes moved, so
// the kernel is bound by operations (about 13 TFLOP per 512x512 frame:
// ~13 ms at the 989 TFLOP/s bf16 tensor-core peak; 1.08 ms at a frame's
// fine chunk of 4.19 M points).
//
// Two instantiations, no switch: the dtype picks one. float32 runs
// deform_pair_kernel, 64-point tiles with mlp.cuh's SIMT products, the
// bit-exact oracle of the plain version. bf16 runs deform_pair_tc_kernel
// on the tensor cores: skip_tc.cuh's trunk (skip_trunk_tc without the
// stash, at SKIP_KS, the slice depth of K3's skip_net_tc) once for each
// net over one encoding tile, each head's y = act(v + b) in f32 in its
// product's epilogue (as bf16 K13's), so K1's output is, product for
// product, the forward that K3 recomputes from the same blob. Every row of
// an mma.sync tile is its point's alone: a point's output does not depend
// on its neighbours or its place in a tile (the fused step's coarse-in-fine
// scatter needs that). Shared memory SkipLayout(63, false): the encoding,
// two activation tiles and the weight ring, 63,488 B, two 256-thread
// blocks an SM; ptxas: 125 registers, 32 B stack frame, no spills.
// Measured on an H100 (PERF.md §6, tools/level_ab.py): 12.3-12.4 ms at a
// frame's fine chunk (46.6 on the CUDA cores; its library call 92.8),
// 86 TFLOP/s, 8.7 % of the bound. What holds it: the mma.sync products
// with a barrier pair a staged slice, as K13's; wgmma is the next step.
//
// The rays= form (field_mlp.py:882-885, :915, :949-953; JAX's
// SAHS_PAIR_RAYS fused step) reads the rays (o (R, 3), d (R, 3), z (R, S))
// in place of the points: a tile of 64 points covers one ray at S = 64,
// half of one at S = 128. Each position is built where the points were
// read, as K15 builds it, __fadd_rn(o, __fmul_rn(d, z)) (mlp.cuh's
// PointSrc), so the form's output and rows equal K1's on K15's points bit
// for bit, in both instantiations.
#include "skip_tc.cuh"

namespace {

constexpr int TP = 64;        // points per block
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
deform_pair_kernel(const sahs::PointSrc src, long long P,
                   const T* __restrict__ wblob,
                   const float* __restrict__ bblob,
                   const int* __restrict__ meta, int n_warp, int n_hyper,
                   int hid_w, int hid_h, int wo_dim, int ho_dim, int n_freq,
                   float* __restrict__ out, int* __restrict__ rows, int gD,
                   int gH, int gW) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pe_dim = 3 + 6 * n_freq;
  const int hmax = hid_w > hid_h ? hid_w : hid_h;
  T* pe = reinterpret_cast<T*>(smem_raw);
  T* hA = pe + pe_dim * TP;
  T* hB = hA + hmax * TP;
  float* yw = reinterpret_cast<float*>(hB + hmax * TP);   // [8][TP]
  float* yh = yw + 8 * TP;                                // [8][TP]

  const long long base = (long long)blockIdx.x * TP;
  const int tid = threadIdx.x;

  // positional encoding of the tile's raw points (zero for the ragged tail)
  if (tid < TP) {
    const long long p = base + tid;
    float x[3] = {0.0f, 0.0f, 0.0f};
    if (p < P) src.load(p, x);
    sahs::pe_group<T>(x, 3, n_freq, pe, 0, tid, TP);
  }
  __syncthreads();

  // two trunks on the shared encoding
  for (int net = 0; net < 2; ++net) {
    const int first = net == 0 ? 0 : n_warp + 1;
    const int n_layers = net == 0 ? n_warp : n_hyper;
    const T* src = pe;
    T* dst = hA;
    for (int l = 0; l < n_layers; ++l) {
      const sahs::LayerDesc d = sahs::load_desc(meta, first + l);
      sahs::mlp_layer<T>(d, wblob, bblob, src, d.w2 >= 0 ? pe : nullptr,
                         nullptr, dst, nullptr, TP);
      __syncthreads();
      src = dst;
      dst = dst == hA ? hB : hA;
    }
    const sahs::LayerDesc head = sahs::load_desc(meta, first + n_layers);
    sahs::mlp_layer<T>(head, wblob, bblob, src, nullptr, nullptr, nullptr,
                       net == 0 ? yw : yh, TP);
    __syncthreads();
  }

  if (tid < TP) {
    const long long p = base + tid;
    if (p < P) {
      const int od = wo_dim + ho_dim;
      float x[3], w[3];
      src.load(p, x);
      for (int c = 0; c < wo_dim; ++c) {
        w[c] = __fadd_rn(x[c], yw[c * TP + tid]);
        out[p * od + c] = w[c];
      }
      for (int c = 0; c < ho_dim; ++c) out[p * od + wo_dim + c] = yh[c * TP + tid];
      if (rows != nullptr) rows[p] = sahs::cell_row(w, gD, gH, gW);
    }
  }
}

template <typename T>
size_t smem_bytes(int n_freq, int hmax) {
  return (size_t)(3 + 6 * n_freq + 2 * hmax) * TP * sizeof(T) +
         16 * TP * sizeof(float);
}

template <typename T>
int launch(const sahs::PointSrc& pts, long long P, const void* w, const float* b,
           const int* meta, int n_warp, int n_hyper, int hid_w, int hid_h,
           int wo_dim, int ho_dim, int n_freq, float* out, int* rows, int gD,
           int gH, int gW, cudaStream_t stream) {
  const int hmax = hid_w > hid_h ? hid_w : hid_h;
  const size_t smem = smem_bytes<T>(n_freq, hmax);
  cudaError_t err = cudaFuncSetAttribute(
      deform_pair_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (P + TP - 1) / TP;
  deform_pair_kernel<T><<<(unsigned)blocks, THREADS, smem, stream>>>(
      pts, P, reinterpret_cast<const T*>(w), b, meta, n_warp, n_hyper, hid_w,
      hid_h, wo_dim, ho_dim, n_freq, out, rows, gD, gH, gW);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: 64-point tiles on the tensor cores (skip_tc.cuh, mma.cuh)
// ---------------------------------------------------------------------------
using sahs::bf16;
using sahs::TC_LDF;
using sahs::TC_TP;

struct PairArgs {
  sahs::PointSrc pts;    // (P, 3), or the rays
  const bf16* w;         // K1's blob: warp trunk, head, hyper trunk, head
  const float* b;
  const int* meta;
  float* out;            // (P, 3 + ho)
  int* rows;             // (P,) or null (no grid)
  long long P;
  int n_warp, n_hyper, ho, n_freq, gD, gH, gW;
};

// One net's head over the tile, y = act(v + b) in f32 (the SIMT head's
// expression), into the tile the trunk left free; returns it ([8][TC_LDF]).
__device__ __forceinline__ const float* pair_head(const PairArgs& a, int layer,
                                                  const bf16* h, bf16* hA,
                                                  bf16* hB, bf16* ring) {
  float* Y = reinterpret_cast<float*>(h == hA ? hB : hA);
  const sahs::LayerDesc head = sahs::load_desc(a.meta, layer);
  const sahs::Operand none = {nullptr, 0, nullptr};
  sahs::skip_product(sahs::Operand{a.w + head.w1, head.k1, h}, none, head.n, ring,
                     sahs::StoreF32{Y, a.b + head.b, head.act, false});
  __syncthreads();
  return Y;
}

// One tile: the encoding once; the warp trunk and its tanh head; x + warp
// (round to nearest), the warped point's corner row and the three warped
// columns stored before the hyper trunk takes hA and hB again; then the
// hyper trunk, its linear head and the ambient columns. Every product is
// K3's forward (skip_trunk_tc at SKIP_KS, the same blob), so K1's output
// is the forward that K3 recomputes, product for product.
__global__ void __launch_bounds__(sahs::TC_THREADS, 2)
deform_pair_tc_kernel(PairArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const sahs::SkipLayout ly(3 + 6 * a.n_freq, false);
  bf16* pe = reinterpret_cast<bf16*>(smem_raw + ly.pe);
  bf16* hA = reinterpret_cast<bf16*>(smem_raw + ly.ha);
  bf16* hB = reinterpret_cast<bf16*>(smem_raw + ly.hb);
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + ly.ring);
  const long long base = (long long)blockIdx.x * TC_TP;
  const int tid = threadIdx.x, od = 3 + a.ho;

  sahs::skip_pe_tile(a.pts, base, a.P, a.n_freq, pe);
  __syncthreads();
  const sahs::SkipNet warp = {a.meta, 0, nullptr, 0, a.n_warp, 0, 0, nullptr,
                              nullptr, 0, 0, 0};
  const bf16* h = sahs::skip_trunk_tc<false, sahs::SKIP_KS>(
      warp, a.w, a.b, pe, hA, hB, ring, nullptr, nullptr);
  const float* Y = pair_head(a, a.n_warp, h, hA, hB, ring);
  if (tid < TC_TP && base + tid < a.P) {
    const long long p = base + tid;
    float x[3];
    a.pts.load(p, x);
    for (int c = 0; c < 3; ++c) {
      x[c] = __fadd_rn(x[c], Y[c * TC_LDF + tid]);
      a.out[p * od + c] = x[c];
    }
    if (a.rows != nullptr) a.rows[p] = sahs::cell_row(x, a.gD, a.gH, a.gW);
  }
  __syncthreads();
  const sahs::SkipNet hyper = {a.meta, a.n_warp + 1, nullptr, 0, a.n_hyper, 0, 0,
                               nullptr, nullptr, 0, 0, 0};
  h = sahs::skip_trunk_tc<false, sahs::SKIP_KS>(hyper, a.w, a.b, pe, hA, hB, ring,
                                               nullptr, nullptr);
  Y = pair_head(a, a.n_warp + 1 + a.n_hyper, h, hA, hB, ring);
  for (int i = tid; i < TC_TP * a.ho; i += blockDim.x) {
    const int t = i / a.ho, c = i - t * a.ho;
    const long long p = base + t;
    if (p < a.P) a.out[p * od + 3 + c] = Y[c * TC_LDF + t];
  }
}

int launch_tc(const PairArgs& a, int hid_w, int hid_h, cudaStream_t stream) {
  if (hid_w % sahs::SKIP_KS || hid_h % sahs::SKIP_KS || hid_w > sahs::SKIP_HMAX ||
      hid_h > sahs::SKIP_HMAX || a.ho > 8 || 3 + 6 * a.n_freq > sahs::SKIP_HMAX)
    return (int)cudaErrorInvalidValue;
  const sahs::SkipLayout ly(3 + 6 * a.n_freq, false);
  const int err = sahs::set_smem(deform_pair_tc_kernel, ly.bytes);
  if (err) return err;
  const long long n_tiles = (a.P + TC_TP - 1) / TC_TP;
  deform_pair_tc_kernel<<<(unsigned)n_tiles, sahs::TC_THREADS, ly.bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// One K1 call on the points of `src`.
int forward_call(const sahs::PointSrc& src, long long P, const void* w, const void* b,
                 const void* meta, int n_warp, int n_hyper, int hid_w, int hid_h,
                 int wo_dim, int ho_dim, int n_freq, int bf16, void* out, void* rows,
                 int gD, int gH, int gW, void* stream) {
  if (P <= 0) return 0;
  auto s = reinterpret_cast<cudaStream_t>(stream);
  auto bb = reinterpret_cast<const float*>(b);
  auto m = reinterpret_cast<const int*>(meta);
  auto o = reinterpret_cast<float*>(out);
  auto r = reinterpret_cast<int*>(rows);
  if (bf16) {
    if (wo_dim != 3) return (int)cudaErrorInvalidValue;
    const PairArgs a = {src, reinterpret_cast<const sahs::bf16*>(w), bb, m, o, r, P,
                        n_warp, n_hyper, ho_dim, n_freq, gD, gH, gW};
    return launch_tc(a, hid_w, hid_h, s);
  }
  return launch<float>(src, P, w, bb, m, n_warp, n_hyper, hid_w, hid_h, wo_dim,
                       ho_dim, n_freq, o, r, gD, gH, gW, s);
}

}  // namespace

extern "C" int sahs_deform_pair_forward(
    const void* pts, long long P, const void* w, const void* b,
    const void* meta, int n_warp, int n_hyper, int hid_w, int hid_h,
    int wo_dim, int ho_dim, int n_freq, int bf16, void* out, void* rows,
    int gD, int gH, int gW, void* stream) {
  const sahs::PointSrc src = {reinterpret_cast<const float*>(pts), nullptr, nullptr,
                              nullptr, 1};
  return forward_call(src, P, w, b, meta, n_warp, n_hyper, hid_w, hid_h, wo_dim,
                      ho_dim, n_freq, bf16, out, rows, gD, gH, gW, stream);
}

// The rays= form: the points of R rays of S samples, o (R, 3), d (R, 3),
// z (R, S) float32; the rest as sahs_deform_pair_forward.
extern "C" int sahs_deform_pair_forward_rays(
    const void* ro, const void* rd, const void* z, long long R, int S,
    const void* w, const void* b, const void* meta, int n_warp, int n_hyper,
    int hid_w, int hid_h, int wo_dim, int ho_dim, int n_freq, int bf16, void* out,
    void* rows, int gD, int gH, int gW, void* stream) {
  if (S <= 0 || ro == nullptr || rd == nullptr || z == nullptr)
    return (int)cudaErrorInvalidValue;
  const sahs::PointSrc src = {nullptr, reinterpret_cast<const float*>(ro),
                              reinterpret_cast<const float*>(rd),
                              reinterpret_cast<const float*>(z), S};
  return forward_call(src, R * S, w, b, meta, n_warp, n_hyper, hid_w, hid_h, wo_dim,
                      ho_dim, n_freq, bf16, out, rows, gD, gH, gW, stream);
}
