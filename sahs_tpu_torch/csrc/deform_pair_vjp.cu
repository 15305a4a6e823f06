// K3: the deformation pair's backward (dW and db only).
//
// Replaces sahs_tpu/ops/pallas/field_mlp.py:deform_pair_vjp (:1098,
// pallas_call at :1233) with need_gx=False, the fused train path's form
// (train/fused.py:433-436): from the raw fine points (P, 3) and the packed
// cotangent g (+ the coarse-slot addend g2) (P, 3 + ambient), the dW and
// db of the warp trunk (6x128 ReLU, skip at 4) and tanh head and of the
// hyper trunk (6x64 ReLU, skip at 4) and linear head, conditioning folded.
//
// Design: per 32-point tile, one block recomputes the shared positional
// encoding and both trunks (the forward of K1), writing each layer's input
// to a device-memory stash, then backpropagates g + g2 through each head
// and trunk with transposed weights (mlp.cuh's layer product on a
// transposed-weight blob), writing each layer's gz to a second stash
// (train.cuh). A split-K reduction over the stashes gives dW and db, in a
// fixed order. All launches come from one call.
//
// Bound on the H100: about 3 x 0.125 M multiply-adds a point (forward,
// backward chain, dW) against ~40 bytes of input, so operations bound it:
// ~0.2 TFLOP at 262,144 fine points, ~0.2 ms at the 989 TFLOP/s bf16 peak.
// This first version runs on the CUDA cores, and the stash costs ~1 KB of
// device traffic a point.
#include "train.cuh"

namespace {

constexpr int TP = 32;
constexpr int THREADS = 256;

struct VjpArgs {
  const float* pts;      // (P, 3)
  const float* g;        // (P, gw) with gw = 3 + ho
  const float* g2;       // (P, gw) or null
  const void* w;         // forward blob (K1's), compute dtype
  const float* b;
  const int* meta;
  const void* wT;        // transposed blob: per net head, layers L-1 .. 1
  const float* bT;
  const int* metaT;
  const int* slots;      // act slot offsets [n_act], then gz slot offsets
  void* acts;            // activation stash, compute dtype
  float* gzs;            // cotangent stash
  long long P, act_stride, gz_stride;
  int n_warp, n_hyper, n_freq, ho, n_act;
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
    for (int l = L - 1; l >= 0; --l) {
      const sahs::LayerDesc d = sahs::load_desc(a.meta, first + l);
      sahs::dact_step<T>(fout, acts + act_off[aslot + l], d.act, d.n, TP,
                         gzs + gz_off[first + l], gB);
      __syncthreads();
      if (l > 0) {
        sahs::mlp_layer<T>(sahs::load_desc(a.metaT, boff + L - l), wT, a.bT,
                           gB, nullptr, nullptr, nullptr, fout, TP);
        __syncthreads();
      }
    }
  }
}

template <typename T>
int launch(const VjpArgs& a, int n_work, int chunks, int out_len,
           const int* prods, const int* work, float* part, float* out,
           cudaStream_t stream) {
  const int pe_dim = 3 + 6 * a.n_freq;
  const size_t smem = (size_t)(pe_dim + 4 * 128) * TP * sizeof(T) +
                      (size_t)(128 + 8) * TP * sizeof(float);
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

}  // namespace

extern "C" int sahs_deform_pair_vjp(
    const void* pts, long long P, const void* g, const void* g2,
    const void* w, const void* b, const void* meta, const void* wT,
    const void* bT, const void* metaT, int n_warp, int n_hyper, int warp_skip,
    int hyper_skip, int n_freq, int ho, int bf16, const void* slots,
    void* acts, void* gzs, int n_act, int act_stride, int gz_stride,
    int n_work, int chunks, int out_len, const void* prods, const void* work,
    void* part, void* out, void* stream) {
  if (P <= 0) return 0;
  (void)warp_skip; (void)hyper_skip;   // the skip layers carry w2 in `meta`
  VjpArgs a;
  a.pts = (const float*)pts; a.g = (const float*)g; a.g2 = (const float*)g2;
  a.w = w; a.b = (const float*)b; a.meta = (const int*)meta;
  a.wT = wT; a.bT = (const float*)bT; a.metaT = (const int*)metaT;
  a.slots = (const int*)slots; a.acts = acts; a.gzs = (float*)gzs;
  a.P = P; a.act_stride = act_stride; a.gz_stride = gz_stride;
  a.n_warp = n_warp; a.n_hyper = n_hyper; a.n_freq = n_freq; a.ho = ho;
  a.n_act = n_act;
  auto s = reinterpret_cast<cudaStream_t>(stream);
  auto pr = (const int*)prods;
  auto wk = (const int*)work;
  if (bf16)
    return launch<__nv_bfloat16>(a, n_work, chunks, out_len, pr, wk,
                                 (float*)part, (float*)out, s);
  return launch<float>(a, n_work, chunks, out_len, pr, wk, (float*)part,
                       (float*)out, s);
}
