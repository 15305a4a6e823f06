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
// bit-exact oracle of the plain version. bf16 runs deform_pair_wg_kernel,
// skip_wg.cuh's tile on wgmma (the design and bound are there): the warp
// net and then the hyper net over one encoding tile, each head's y =
// act(v + b) in f32, the weights streamed as the stages of
// field_mlp.stage_blob from the pair's blob. A point's output does not
// depend on its neighbours or its place in a tile (the fused step's
// coarse-in-fine scatter needs that). Each k16 step is summed from zero
// and added in f32, the semantics of the products that K3 recomputes
// from the same blob. The warp-level tensor-core kernel it replaces read
// 12.3-12.4 ms at a frame's fine chunk on an H100 (PERF.md §6); the
// tile's readings are in PERF.md §6 (tools/level_ab.py --serve-only).
//
// The rays= form (field_mlp.py:882-885, :915, :949-953; JAX's
// SAHS_PAIR_RAYS fused step) reads the rays (o (R, 3), d (R, 3), z (R, S))
// in place of the points: a tile of 64 points covers one ray at S = 64,
// half of one at S = 128. Each position is built where the points were
// read, as K15 builds it, __fadd_rn(o, __fmul_rn(d, z)) (mlp.cuh's
// PointSrc), so the form's output and rows equal K1's on K15's points bit
// for bit, in both instantiations.
#include "skip_wg.cuh"

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

// bf16: skip_wg.cuh's tile on wgmma, both nets on one encoding
__global__ void __launch_bounds__(sk::THREADS, 1)
deform_pair_wg_kernel(const __grid_constant__ sk::Args a) {
  extern __shared__ __align__(1024) unsigned char sk_smem[];
  sk::tile(a, sk_smem);
}

// One K1 call on the points of `src`. bf16 reads the weight stages
// (`stages`, stage_bytes) and the blob's layer table (`descs`, host
// memory) in place of the blob and its device descriptors.
int forward_call(const sahs::PointSrc& src, long long P, const void* w, const void* b,
                 const void* meta, int n_warp, int n_hyper, int hid_w, int hid_h,
                 int wo_dim, int ho_dim, int n_freq, int bf16, void* out, void* rows,
                 int gD, int gH, int gW, const void* stages, long long stage_bytes,
                 const void* descs, void* stream) {
  if (P <= 0) return 0;
  auto s = reinterpret_cast<cudaStream_t>(stream);
  auto bb = reinterpret_cast<const float*>(b);
  auto m = reinterpret_cast<const int*>(meta);
  auto o = reinterpret_cast<float*>(out);
  auto r = reinterpret_cast<int*>(rows);
  if (bf16) {
    if (wo_dim != 3 || descs == nullptr) return (int)cudaErrorInvalidValue;
    sk::Args a = sk::args_of(reinterpret_cast<const int*>(descs), 2, n_warp, n_hyper);
    a.pts = src;
    a.wg = stages;
    a.wg_bytes = stage_bytes;
    a.b = bb;
    a.out = o;
    a.rows = r;
    a.P = P;
    a.pe_dim = 3 + 6 * n_freq;
    a.n_freq = n_freq;
    a.od = 3 + ho_dim;
    a.gD = gD;
    a.gH = gH;
    a.gW = gW;
    return sk::launch(deform_pair_wg_kernel, a, s);
  }
  return launch<float>(src, P, w, bb, m, n_warp, n_hyper, hid_w, hid_h, wo_dim,
                       ho_dim, n_freq, o, r, gD, gH, gW, s);
}

}  // namespace

extern "C" int sahs_deform_pair_forward(
    const void* pts, long long P, const void* w, const void* b,
    const void* meta, int n_warp, int n_hyper, int hid_w, int hid_h,
    int wo_dim, int ho_dim, int n_freq, int bf16, void* out, void* rows,
    int gD, int gH, int gW, const void* stages, long long stage_bytes,
    const void* descs, void* stream) {
  const sahs::PointSrc src = {reinterpret_cast<const float*>(pts), nullptr, nullptr,
                              nullptr, 1};
  return forward_call(src, P, w, b, meta, n_warp, n_hyper, hid_w, hid_h, wo_dim,
                      ho_dim, n_freq, bf16, out, rows, gD, gH, gW, stages, stage_bytes,
                      descs, stream);
}

// The rays= form: the points of R rays of S samples, o (R, 3), d (R, 3),
// z (R, S) float32; the rest as sahs_deform_pair_forward.
extern "C" int sahs_deform_pair_forward_rays(
    const void* ro, const void* rd, const void* z, long long R, int S,
    const void* w, const void* b, const void* meta, int n_warp, int n_hyper,
    int hid_w, int hid_h, int wo_dim, int ho_dim, int n_freq, int bf16, void* out,
    void* rows, int gD, int gH, int gW, const void* stages, long long stage_bytes,
    const void* descs, void* stream) {
  if (S <= 0 || ro == nullptr || rd == nullptr || z == nullptr)
    return (int)cudaErrorInvalidValue;
  const sahs::PointSrc src = {nullptr, reinterpret_cast<const float*>(ro),
                              reinterpret_cast<const float*>(rd),
                              reinterpret_cast<const float*>(z), S};
  return forward_call(src, R * S, w, b, meta, n_warp, n_hyper, hid_w, hid_h, wo_dim,
                      ho_dim, n_freq, bf16, out, rows, gD, gH, gW, stages, stage_bytes,
                      descs, stream);
}
