// K13 and K14: one deformation MLP on its own, forward and backward.
//
// K13 replaces sahs_tpu/ops/pallas/field_mlp.py:skip_mlp_forward (:345,
// pallas_call at :372). In the raw-coordinate form (pe_spec given) the
// positional encoding of the raw point (10 frequencies, 63 values) is
// computed in the kernel; in the pre-encoded form (pe_spec None, enc_dim >
// 0) the tile reads the given encoding (P, enc_dim) in the compute dtype,
// as JAX casts it before its kernel (field_mlp.py:354-356). Then the trunk (the warp field's 6x128 ReLU or the hyper sheet's 6x64,
// skip layer at 4 taking [h ; pe]), the per-frame conditioning already
// folded into the input and skip biases, then the head and its activation
// (tanh for the warp field's 3 outputs, linear for the hyper sheet's
// ambient coordinates). Output (P, out) float32.
//
// K14 replaces field_mlp.py:skip_mlp_vjp (:516, pallas_call at :571): per
// tile one block recomputes the encoding and the trunk, writing each
// layer's input to a device-memory stash, takes the cotangent g back
// through the head and the trunk with transposed weights, writing each
// layer's gz to a second stash (train.cuh); a split-K reduction over the
// stashes gives every dW and db in a fixed order. When asked, the block
// also takes the cotangent back to the encoding (layer 0 and the skip
// layer's pe rows, one two-input product) and through the PE's backward to
// the raw coordinates: d(sin t)/dx = cos(t) f, with t formed exactly as in
// the forward; in the pre-encoded form that product's result is gx, the
// cotangent of the encoding (P, enc_dim) float32.
//
// Bound on the H100: the warp field is ~98,000 multiply-adds a point in the
// forward against ~24 bytes moved, so operations bound both kernels: 0.83
// TFLOP at a 512x512 frame's 4.2 M fine points, ~0.84 ms at the 989
// TFLOP/s bf16 peak; the backward is about three times the forward.
//
// Routes. K13 in float32 runs skip_mlp_kernel (64-point tiles, mlp.cuh's
// SIMT products), the bit-exact oracle of the plain version; in bf16
// skip_wg_kernel, skip_wg.cuh's tile on wgmma with one net (the design is
// there; the tile K1 runs with two), on the raw points or the given
// encoding, the weights streamed as the stages of field_mlp.stage_blob.
// The warp-level tensor-core kernel it replaces read 8.30-8.38 ms (warp net) and
// 4.21-4.24 ms (hyper) at a frame's fine chunk on an H100 (PERF.md §6);
// the tile's readings are in PERF.md §6 (tools/level_ab.py --skip-only).
// K14 in float32 runs skip_vjp_kernel on 32-point tiles
// with mlp.cuh's SIMT products and train.cuh's dw_kernel; in bf16
// skip_bwd_wg_kernel, the deformation nets' backward tile on wgmma with
// one net (skip_bw.cuh, the tile K3 runs with two), and dW on
// level_dw.cuh's level_dw_kernel, bias_dw_kernel and dw_reduce. The
// warp-level tensor-core kernels it replaces (skip_vjp_tc_kernel and its
// dW) read 3.34 ms (warp net) and 1.75 ms (hyper) a call at a
// step's 262,144 fine points on an H100 (PERF.md section 6).
#include "level_dw.cuh"
#include "skip_bw.cuh"
#include "skip_wg.cuh"

namespace {

constexpr int TP = 64;        // points per block of K13 in float32
constexpr int TP_BWD = 32;    // points per block of K14 in float32
constexpr int THREADS = 256;
constexpr int HMAX = 128;     // widest trunk and widest PE (padded) taken

// K13 in float32
__global__ void __launch_bounds__(THREADS)
skip_mlp_kernel(const float* __restrict__ pts, long long P,
                const float* __restrict__ wblob, const float* __restrict__ bblob,
                const int* __restrict__ meta, int n_layers, int hid,
                int out_dim, int n_freq, int enc_dim, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pe_dim = enc_dim > 0 ? enc_dim : 3 + 6 * n_freq;
  float* pe = reinterpret_cast<float*>(smem_raw);
  float* hA = pe + pe_dim * TP;
  float* hB = hA + hid * TP;
  float* y = reinterpret_cast<float*>(hB + hid * TP);    // [8][TP]

  const long long base = (long long)blockIdx.x * TP;
  const int tid = threadIdx.x;
  if (enc_dim > 0) {
    sahs::point_rows<float>(pts, enc_dim, base, P, enc_dim, pe, 0, TP, TP);
  } else if (tid < TP) {
    const long long p = base + tid;
    float x[3] = {0.0f, 0.0f, 0.0f};
    if (p < P) {
      x[0] = pts[p * 3 + 0]; x[1] = pts[p * 3 + 1]; x[2] = pts[p * 3 + 2];
    }
    sahs::pe_group<float>(x, 3, n_freq, pe, 0, tid, TP);
  }
  __syncthreads();

  const float* src = pe;
  float* dst = hA;
  for (int l = 0; l < n_layers; ++l) {
    const sahs::LayerDesc d = sahs::load_desc(meta, l);
    sahs::mlp_layer<float>(d, wblob, bblob, src, d.w2 >= 0 ? pe : nullptr,
                           nullptr, dst, nullptr, TP);
    __syncthreads();
    src = dst;
    dst = dst == hA ? hB : hA;
  }
  sahs::mlp_layer<float>(sahs::load_desc(meta, n_layers), wblob, bblob, src,
                         nullptr, nullptr, nullptr, y, TP);
  __syncthreads();

  for (int i = tid; i < TP * out_dim; i += blockDim.x) {
    const int t = i / out_dim, c = i % out_dim;
    const long long p = base + t;
    if (p < P) out[p * out_dim + c] = y[c * TP + t];
  }
}

struct VjpArgs {
  const void* pts;       // (P, 3) float32, or (P, enc_dim) in the compute dtype
  const float* g;        // (P, out_dim)
  const void* w;         // forward blob (K13's), compute dtype
  const float* b;
  const int* meta;
  const void* wT;        // transposed blob: head, layers L-1 .. 1, to-PE
  const float* bT;
  const int* metaT;
  const int* slots;      // act slot offsets [n_act], then gz slot offsets
  void* acts;            // activation stash, compute dtype
  float* gzs;            // cotangent stash
  float* gx;             // (P, 3) or (P, enc_dim), or null
  long long P, act_stride, gz_stride;
  int n_layers, skip, n_freq, enc_dim, out_dim, n_act;
  // the width of the net's input: the encoding formed here, or the given one
  __host__ __device__ int pe_dim() const { return enc_dim > 0 ? enc_dim : 3 + 6 * n_freq; }
};

template <typename T>
__global__ void __launch_bounds__(THREADS) skip_vjp_kernel(VjpArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int TB = TP_BWD;
  const int pe_dim = a.pe_dim();
  const float* pts = reinterpret_cast<const float*>(a.pts);
  T* pe = reinterpret_cast<T*>(smem_raw);
  T* hA = pe + pe_dim * TB;
  T* hB = hA + HMAX * TB;
  T* gA = hB + HMAX * TB;
  T* gB = gA + HMAX * TB;
  T* gS = gB + HMAX * TB;                                   // the skip layer's gz
  float* fout = reinterpret_cast<float*>(gS + HMAX * TB);   // [HMAX][TB]
  float* y = fout + HMAX * TB;                              // [8][TB]
  const T* wblob = reinterpret_cast<const T*>(a.w);
  const T* wT = reinterpret_cast<const T*>(a.wT);
  const long long tile = blockIdx.x;
  const long long base = tile * TB;
  T* acts = reinterpret_cast<T*>(a.acts) + tile * a.act_stride;
  float* gzs = a.gzs + tile * a.gz_stride;
  const int* act_off = a.slots;
  const int* gz_off = a.slots + a.n_act;
  const int tid = threadIdx.x;
  const int L = a.n_layers;

  if (a.enc_dim > 0) {
    sahs::point_rows<T>(reinterpret_cast<const T*>(a.pts), a.enc_dim, base, a.P,
                        pe_dim, pe, 0, TB, TB);
  } else if (tid < TB) {
    const long long p = base + tid;
    float x[3] = {0.0f, 0.0f, 0.0f};
    if (p < a.P) {
      x[0] = pts[p * 3 + 0]; x[1] = pts[p * 3 + 1]; x[2] = pts[p * 3 + 2];
    }
    sahs::pe_group<T>(x, 3, a.n_freq, pe, 0, tid, TB);
  }
  __syncthreads();
  sahs::store_rows<T>(pe, acts + act_off[0], pe_dim, TB);

  // forward, stashing every layer's output (the next layer's input)
  const T* src = pe;
  T* dst = hA;
  for (int l = 0; l < L; ++l) {
    const sahs::LayerDesc d = sahs::load_desc(a.meta, l);
    sahs::mlp_layer<T>(d, wblob, a.b, src, d.w2 >= 0 ? pe : nullptr, nullptr,
                       dst, nullptr, TB);
    __syncthreads();
    sahs::store_rows<T>(dst, acts + act_off[1 + l], d.n, TB);
    src = dst;
    dst = dst == hA ? hB : hA;
  }
  const sahs::LayerDesc head = sahs::load_desc(a.meta, L);
  sahs::mlp_layer<T>(head, wblob, a.b, src, nullptr, nullptr, nullptr, y, TB);
  __syncthreads();
  // head: gz = g * act'(y) over the padded head width
  for (int i = tid; i < head.n * TB; i += blockDim.x) {
    const int j = i / TB, t = i % TB;
    const long long p = base + t;
    const float gv = (j < a.out_dim && p < a.P) ? a.g[p * a.out_dim + j] : 0.0f;
    const float yv = y[i];
    const float gz = head.act == sahs::ACT_TANH ? gv * (1.0f - yv * yv) : gv;
    gzs[gz_off[L] + i] = gz;
    gA[i] = sahs::from_f<T>(gz);
  }
  __syncthreads();
  sahs::mlp_layer<T>(sahs::load_desc(a.metaT, 0), wT, a.bT, gA, nullptr,
                     nullptr, nullptr, fout, TB);
  __syncthreads();
  const bool skip_fires = a.skip > 0 && a.skip < L;
  for (int l = L - 1; l >= 0; --l) {
    const sahs::LayerDesc d = sahs::load_desc(a.meta, l);
    sahs::dact_step<T>(fout, acts + act_off[1 + l], d.act, d.n, TB,
                       gzs + gz_off[l], gB);
    __syncthreads();
    if (a.gx != nullptr && skip_fires && l == a.skip)
      for (int i = tid; i < d.n * TB; i += blockDim.x) gS[i] = gB[i];
    if (l > 0) {
      sahs::mlp_layer<T>(sahs::load_desc(a.metaT, L - l), wT, a.bT, gB,
                         nullptr, nullptr, nullptr, fout, TB);
      __syncthreads();
    }
  }
  if (a.gx == nullptr) return;

  // back to the encoding: gz_0 W_0^T (+ gz_skip W_skip,pe^T), in float32
  sahs::mlp_layer<T>(sahs::load_desc(a.metaT, L), wT, a.bT, gB,
                     skip_fires ? gS : nullptr, nullptr, nullptr, fout, TB);
  __syncthreads();
  if (a.enc_dim > 0) {   // a given encoding: its cotangent is the result
    for (int i = tid; i < pe_dim * TB; i += blockDim.x) {
      const int t = i / pe_dim, r = i - t * pe_dim;
      const long long p = base + t;
      if (p < a.P) a.gx[p * pe_dim + r] = fout[r * TB + t];
    }
    return;
  }
  // and through the PE: gx[d] = g_x[d] + sum_f f (g_sin cos(x f) +
  // g_cos cos(x f + pi/2)), the angles exactly as pe_group forms them
  if (tid < TB) {
    const long long p = base + tid;
    if (p < a.P) {
      float x[3], acc[3];
      for (int d = 0; d < 3; ++d) {
        x[d] = pts[p * 3 + d];
        acc[d] = fout[d * TB + tid];
      }
      int row = 3;
      for (int f = 0; f < a.n_freq; ++f) {
        const float fr = ldexpf(1.0f, f);
        for (int d = 0; d < 3; ++d) {
          const float t = __fmul_rn(x[d], fr);
          acc[d] += fout[(row + d) * TB + tid] * cosf(t) * fr;
          acc[d] += fout[(row + 3 + d) * TB + tid] *
                    cosf(__fadd_rn(t, SAHS_HALF_PI_F)) * fr;
        }
        row += 6;
      }
      for (int d = 0; d < 3; ++d) a.gx[p * 3 + d] = acc[d];
    }
  }
}

int launch_forward(const float* pts, long long P, const float* w,
                   const float* b, const int* meta, int n_layers, int hid,
                   int out_dim, int n_freq, int enc_dim, float* out,
                   cudaStream_t stream) {
  const int pe_dim = enc_dim > 0 ? enc_dim : 3 + 6 * n_freq;
  const size_t smem = (size_t)(pe_dim + 2 * hid) * TP * sizeof(float) +
                      8 * TP * sizeof(float);
  int err = sahs::set_smem(skip_mlp_kernel, smem);
  if (err) return err;
  const long long blocks = (P + TP - 1) / TP;
  skip_mlp_kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
      pts, P, w, b, meta, n_layers, hid, out_dim, n_freq, enc_dim, out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_vjp(const VjpArgs& a, int n_work, int chunks, int out_len,
               const int* prods, const int* work, float* part, float* out,
               cudaStream_t stream) {
  const int pe_dim = a.pe_dim();
  const size_t smem = (size_t)(pe_dim + 5 * HMAX) * TP_BWD * sizeof(T) +
                      (size_t)(HMAX + 8) * TP_BWD * sizeof(float);
  int err = sahs::set_smem(skip_vjp_kernel<T>, smem);
  if (err) return err;
  const long long n_tiles = (a.P + TP_BWD - 1) / TP_BWD;
  skip_vjp_kernel<T><<<(unsigned)n_tiles, THREADS, smem, stream>>>(a);
  err = (int)cudaGetLastError();
  if (err) return err;
  return sahs::launch_dw<T>(reinterpret_cast<const T*>(a.acts), a.gzs,
                            a.act_stride, a.gz_stride, (int)n_tiles, TP_BWD,
                            prods, work, n_work, chunks, part, out, out_len,
                            stream);
}

// ---------------------------------------------------------------------------
// K13 in bf16: skip_wg.cuh's tile on wgmma, one net
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(sk::THREADS, 1)
skip_wg_kernel(const __grid_constant__ sk::Args a) {
  extern __shared__ __align__(1024) unsigned char sk_smem[];
  sk::tile(a, sk_smem);
}

// ---------------------------------------------------------------------------
// K14 in bf16: skip_bw.cuh's tile on wgmma, one net, and level_dw.cuh's dW
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(sb::THREADS, 1)
skip_bwd_wg_kernel(const __grid_constant__ sb::Args a) {
  extern __shared__ __align__(1024) unsigned char sb_smem[];
  sb::tile(a, sb_smem);
}

}  // namespace

// bf16 reads the weight stages (`stages`, stage_bytes) and the blob's
// layer table (`descs`, host memory) in place of the blob and its device
// descriptors.
extern "C" int sahs_skip_mlp_forward(const void* pts, long long P,
                                     const void* w, const void* b,
                                     const void* meta, int n_layers, int hid,
                                     int out_dim, int n_freq, int enc_dim,
                                     int bf16, void* out, const void* stages,
                                     long long stage_bytes, const void* descs,
                                     void* stream) {
  if (P <= 0) return 0;
  if (hid > HMAX || out_dim > 8 || enc_dim < 0 || enc_dim > HMAX)
    return (int)cudaErrorInvalidValue;
  auto s = reinterpret_cast<cudaStream_t>(stream);
  auto bb = reinterpret_cast<const float*>(b);
  auto m = reinterpret_cast<const int*>(meta);
  auto o = reinterpret_cast<float*>(out);
  if (bf16) {
    if (descs == nullptr) return (int)cudaErrorInvalidValue;
    sk::Args a = sk::args_of(reinterpret_cast<const int*>(descs), 1, n_layers, 0);
    a.pts = sahs::PointSrc{enc_dim > 0 ? nullptr : reinterpret_cast<const float*>(pts),
                           nullptr, nullptr, nullptr, 1};
    a.enc = enc_dim > 0 ? reinterpret_cast<const sb::bf16*>(pts) : nullptr;
    a.wg = stages;
    a.wg_bytes = stage_bytes;
    a.b = bb;
    a.out = o;
    a.P = P;
    a.pe_dim = enc_dim > 0 ? enc_dim : 3 + 6 * n_freq;
    a.n_freq = n_freq;
    a.od = out_dim;
    return sk::launch(skip_wg_kernel, a, s);
  }
  return launch_forward(reinterpret_cast<const float*>(pts), P,
                        reinterpret_cast<const float*>(w), bb, m, n_layers, hid,
                        out_dim, n_freq, enc_dim, o, s);
}

extern "C" int sahs_skip_mlp_vjp(
    const void* pts, long long P, const void* g, const void* w,
    const void* b, const void* meta, const void* wT, const void* bT,
    const void* metaT, int n_layers, int skip, int n_freq, int enc_dim,
    int out_dim, int bf16, const void* slots, void* acts, void* gzs, void* gx, int n_act,
    int act_stride, int gz_stride, int n_work, int chunks, int out_len,
    const void* prods, const void* work, void* part, void* out, const void* wf,
    long long wf_bytes, const void* wb, long long wb_bytes, const void* descs,
    const void* descs_t, int n_t, const void* act_off, void* bsum, const void* items,
    int n_items, void* stream) {
  if (P <= 0) return 0;
  if (out_dim > 8 || enc_dim < 0 || (enc_dim > 0 ? enc_dim : 3 + 6 * n_freq) > HMAX)
    return (int)cudaErrorInvalidValue;
  VjpArgs a;
  a.pts = pts; a.g = (const float*)g;
  a.w = w; a.b = (const float*)b; a.meta = (const int*)meta;
  a.wT = wT; a.bT = (const float*)bT; a.metaT = (const int*)metaT;
  a.slots = (const int*)slots; a.acts = acts; a.gzs = (float*)gzs;
  a.gx = (float*)gx;
  a.P = P; a.act_stride = act_stride; a.gz_stride = gz_stride;
  a.n_layers = n_layers; a.skip = skip; a.n_freq = n_freq; a.enc_dim = enc_dim;
  a.out_dim = out_dim; a.n_act = n_act;
  auto s = reinterpret_cast<cudaStream_t>(stream);
  auto pr = (const int*)prods;
  auto wk = (const int*)work;
  if (bf16) {
    if (descs == nullptr || descs_t == nullptr || act_off == nullptr ||
        (gx != nullptr && n_t < n_layers + 1))
      return (int)cudaErrorInvalidValue;
    sb::Args t = sb::args_of((const int*)descs, (const int*)descs_t, n_t, (const int*)act_off,
                             1, n_layers, 0);
    t.pts = sahs::PointSrc{enc_dim > 0 ? nullptr : (const float*)pts, nullptr, nullptr,
                           nullptr, 1};
    t.enc = enc_dim > 0 ? (const sb::bf16*)pts : nullptr;
    t.wf = wf; t.wf_bytes = wf_bytes; t.wb = wb; t.wb_bytes = wb_bytes;
    t.b = a.b; t.g = a.g; t.gx = a.gx;
    t.acts = (sb::bf16*)acts; t.gzs = (sb::bf16*)gzs; t.bsum = (float*)bsum;
    t.P = P; t.act_stride = act_stride; t.gz_stride = gz_stride;
    t.skip[0] = skip; t.gw = out_dim; t.ncol[0] = out_dim;
    t.pe_dim = a.pe_dim(); t.n_freq = n_freq;
    int err = sb::launch(skip_bwd_wg_kernel, t, s);
    if (err) return err;
    return ldw::launch_level_dw(t.acts, t.gzs, t.bsum, act_stride, gz_stride,
                                (int)((P + sb::TP - 1) / sb::TP), pr, (const int*)items,
                                n_items, chunks, (float*)part, (float*)out, out_len, t.b_len, s);
  }
  return launch_vjp<float>(a, n_work, chunks, out_len, pr, wk, (float*)part,
                           (float*)out, s);
}
