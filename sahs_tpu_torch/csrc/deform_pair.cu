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
// ~13 ms at the 989 TFLOP/s bf16 tensor-core peak). This first version
// runs the matmuls on the CUDA cores (mlp.cuh); the design keeps every
// activation of a 64-point tile in shared memory and reads the ~0.1 MB of
// weights from L2, so device memory sees only the points in and the
// results out. Moving the layer products to wgmma is the next step.
#include "mlp.cuh"

namespace {

constexpr int TP = 64;        // points per block
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
deform_pair_kernel(const float* __restrict__ pts, long long P,
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
    if (p < P) {
      x[0] = pts[p * 3 + 0]; x[1] = pts[p * 3 + 1]; x[2] = pts[p * 3 + 2];
    }
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
      float w[3];
      for (int c = 0; c < wo_dim; ++c) {
        w[c] = __fadd_rn(pts[p * 3 + c], yw[c * TP + tid]);
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
int launch(const float* pts, long long P, const void* w, const float* b,
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

}  // namespace

extern "C" int sahs_deform_pair_forward(
    const void* pts, long long P, const void* w, const void* b,
    const void* meta, int n_warp, int n_hyper, int hid_w, int hid_h,
    int wo_dim, int ho_dim, int n_freq, int bf16, void* out, void* rows,
    int gD, int gH, int gW, void* stream) {
  if (P <= 0) return 0;
  auto s = reinterpret_cast<cudaStream_t>(stream);
  auto x = reinterpret_cast<const float*>(pts);
  auto bb = reinterpret_cast<const float*>(b);
  auto m = reinterpret_cast<const int*>(meta);
  auto o = reinterpret_cast<float*>(out);
  auto r = reinterpret_cast<int*>(rows);
  if (bf16)
    return launch<__nv_bfloat16>(x, P, w, bb, m, n_warp, n_hyper, hid_w,
                                 hid_h, wo_dim, ho_dim, n_freq, o, r, gD, gH,
                                 gW, s);
  return launch<float>(x, P, w, bb, m, n_warp, n_hyper, hid_w, hid_h, wo_dim,
                       ho_dim, n_freq, o, r, gD, gH, gW, s);
}
