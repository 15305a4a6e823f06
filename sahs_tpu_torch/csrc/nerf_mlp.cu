// K11: the NeRF MLP on per-point inputs, forward.
//
// Replaces sahs_tpu/ops/pallas/field_mlp.py:nerf_mlp_forward_fused (:3204,
// pallas_call at :3246), the field of the per-point branch: the JAX package
// takes it when a level's sample count does not tile its level kernels
// (nerface.py:442-460), e.g. 64 + 128 = 192 samples. Per point:
//   - PE of the packed point [warped xyz (10 freq) | ambient (4 freq)], 81
//     values, and of the point's raw direction (4 freq, 27 values), with
//     the accurate sinf of an exact x * 2^k (mlp.cuh);
//   - the 32-channel spatial embedding, read as given (the grid sample ran
//     before, ops/grid.grid_sample_3d) and rounded to the compute dtype;
//   - the NeRF MLP: 8x256 leaky trunk (skip at layer 3, conditioning
//     folded into biases), feat and alpha heads, a 4x128 direction branch
//     whose first layer reads [feat | pe(dir) | se] (field_mlp.py:1525),
//     and a 4x128 seg branch to 12 logits.
// In the pre-encoded form (pe_spec / extra_pe_spec None, field_mlp.py:
// 3220-3223; ENC_PTS, ENC_EXTRA) the tile reads the point's encoding
// (P, 81) and [pe(dir) | se] (P, 59) as given, in the compute dtype, and
// forms no PE.
// Output raw (P, 16) [rgb3 | seg12 | sigma1], the layout of
// fields.nerf_mlp_apply. The math is K7's (csrc/nerf_level.cu, RAW) but for
// the direction term, which K7 forms once per ray.
//
// Design: one block per 64-point tile, P any size (the last tile masked):
// no 1024-point tiles holding every weight and no 128-lane padding, as the
// TPU needed. Activations ping-pong through shared memory (2 x 256 x 64
// values); weights are read from L2 in the layer order of
// nerf_level.point_layers, the forward blob of csrc/level_train.cu.
// Device memory sees the points (5 floats), the extra input (35) and the
// output (16).
//
// Bound on the H100: about 1.47 MFLOP per point against ~224 bytes, so
// operations bound it: a frame's fine chunk of 6.29 M points (32,768 rays x
// 192) is 9.3 TFLOP, ~9.4 ms at the 989 TFLOP/s bf16 peak. This kernel runs
// the layer products on the CUDA cores (mlp.cuh) and serves float32 only
// (~22 TFLOP/s in bf16 when it served that too: 427 ms at the frame chunk).
// In bf16, K11 runs on the tensor cores: level_train.cu:field_tc_kernel,
// 103.8 ms at the frame chunk on an H100 (PERF.md).
#include "mlp.cuh"

namespace {

constexpr int TP = 64;
constexpr int THREADS = 256;

// Pre-encoded inputs (pe_spec / extra_pe_spec None), bits of Args::enc:
// the point's encoding (P, PW) in place of the packed point, and [pe(dir)
// | se] (P, C) in place of the extra input (no direction PE, ndp 0).
enum { ENC_PTS = 1, ENC_EXTRA = 2 };

struct Args {
  const float* pts;     // (P, PW) packed [warped xyz | ambient], or its encoding
  const float* extra;   // (P, 3 + C) [raw dir | spatial embedding], or (P, C)
  const void* w;        // weight blob, compute dtype
  const float* b;       // bias blob
  const int* meta;      // layer descriptors
  float* out;           // (P, 16)
  long long P;
  int PW, L, H, B, C, amb, nf_xyz, nf_amb, nf_dir, enc;
  __host__ __device__ int kx() const {
    return (enc & ENC_PTS) ? PW : 3 + 6 * nf_xyz + amb * (1 + 2 * nf_amb);
  }
  __host__ __device__ int ndp() const { return (enc & ENC_EXTRA) ? 0 : 3 + 6 * nf_dir; }
};

template <typename T>
size_t smem_bytes(const Args& a) {
  const int kx = a.kx(), ndp = a.ndp();
  return (size_t)(kx + ndp + a.C + 2 * a.H) * TP * sizeof(T) +
         (size_t)(8 + 16 + 8) * TP * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) nerf_mlp_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kx = a.kx(), ndp = a.ndp(), C = a.C, L = a.L, EW = 3 + a.C;
  T* xin = reinterpret_cast<T*>(smem_raw);
  T* din = xin + kx * TP;                 // [pe(dir) ; se]
  T* hA = din + (ndp + C) * TP;
  T* hB = hA + a.H * TP;
  float* rgbY = reinterpret_cast<float*>(hB + a.H * TP);   // [8][TP]
  float* segY = rgbY + 8 * TP;                              // [16][TP]
  float* alphaY = segY + 16 * TP;                           // [8][TP]
  const T* wblob = reinterpret_cast<const T*>(a.w);
  const long long base = (long long)blockIdx.x * TP;
  const int tid = threadIdx.x;

  const bool xenc = a.enc & ENC_PTS, eenc = a.enc & ENC_EXTRA;
  if (tid < TP) {
    const long long p = base + tid;
    float x[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    float d[3] = {0, 0, 0};
    if (p < a.P && !xenc)
      for (int c = 0; c < a.PW; ++c) x[c] = a.pts[p * a.PW + c];
    if (p < a.P && !eenc)
      for (int c = 0; c < 3; ++c) d[c] = a.extra[p * EW + c];
    if (!xenc) {
      sahs::pe_group<T>(x, 3, a.nf_xyz, xin, 0, tid, TP);
      if (a.amb > 0)
        sahs::pe_group<T>(x + 3, a.amb, a.nf_amb, xin, 3 + 6 * a.nf_xyz, tid, TP);
    }
    if (!eenc) sahs::pe_group<T>(d, 3, a.nf_dir, din, 0, tid, TP);
  }
  if (xenc)   // the point's encoding, given in the compute dtype
    sahs::point_rows<T>(reinterpret_cast<const T*>(a.pts), kx, base, a.P, kx, xin,
                        0, TP, TP);
  if (eenc)   // [pe(dir) | se], given in the compute dtype
    sahs::point_rows<T>(reinterpret_cast<const T*>(a.extra), C, base, a.P, C, din,
                        0, TP, TP);
  else        // the spatial embedding, channel-fastest reads of the extra rows
    sahs::point_rows<T>(a.extra + 3, EW, base, a.P, C, din, ndp, TP, TP);
  __syncthreads();

  // trunk
  const T* src = xin;
  T* dst = hA;
  for (int l = 0; l < L; ++l) {
    const sahs::LayerDesc d = sahs::load_desc(a.meta, l);
    sahs::mlp_layer<T>(d, wblob, a.b, src, d.w2 >= 0 ? xin : nullptr, nullptr,
                       dst, nullptr, TP);
    __syncthreads();
    src = dst;
    dst = dst == hA ? hB : hA;
  }
  T* hl = const_cast<T*>(src);   // last trunk activation, free after feat
  T* feat = dst;
  T* b0 = hl;
  T* b1 = hl + a.B * TP;
  sahs::mlp_layer<T>(sahs::load_desc(a.meta, L), wblob, a.b, hl, nullptr,
                     nullptr, feat, nullptr, TP);
  __syncthreads();
  sahs::mlp_layer<T>(sahs::load_desc(a.meta, L + 1), wblob, a.b, feat, nullptr,
                     nullptr, nullptr, alphaY, TP);
  // direction branch: [feat | pe(dir) | se] -> 4 x B -> rgb
  sahs::mlp_layer<T>(sahs::load_desc(a.meta, L + 2), wblob, a.b, feat, din,
                     nullptr, b0, nullptr, TP);
  __syncthreads();
  for (int k = 1; k <= 3; ++k) {
    sahs::mlp_layer<T>(sahs::load_desc(a.meta, L + 2 + k), wblob, a.b,
                       k % 2 ? b0 : b1, nullptr, nullptr, k % 2 ? b1 : b0,
                       nullptr, TP);
    __syncthreads();
  }
  sahs::mlp_layer<T>(sahs::load_desc(a.meta, L + 6), wblob, a.b, b1, nullptr,
                     nullptr, nullptr, rgbY, TP);
  __syncthreads();
  // seg branch: feat -> 4 x B -> 12 logits
  sahs::mlp_layer<T>(sahs::load_desc(a.meta, L + 7), wblob, a.b, feat, nullptr,
                     nullptr, b0, nullptr, TP);
  __syncthreads();
  for (int k = 1; k <= 3; ++k) {
    sahs::mlp_layer<T>(sahs::load_desc(a.meta, L + 7 + k), wblob, a.b,
                       k % 2 ? b0 : b1, nullptr, nullptr, k % 2 ? b1 : b0,
                       nullptr, TP);
    __syncthreads();
  }
  sahs::mlp_layer<T>(sahs::load_desc(a.meta, L + 11), wblob, a.b, b1, nullptr,
                     nullptr, nullptr, segY, TP);
  __syncthreads();
  for (int i = tid; i < 16 * TP; i += blockDim.x) {
    const int t = i / 16, c = i % 16;
    const long long p = base + t;
    if (p >= a.P) continue;
    a.out[p * 16 + c] = c < 3 ? rgbY[c * TP + t]
                      : c < 15 ? segY[(c - 3) * TP + t] : alphaY[t];
  }
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(a);
  cudaError_t err = cudaFuncSetAttribute(
      nerf_mlp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (a.P + TP - 1) / TP;
  nerf_mlp_kernel<T><<<(unsigned)blocks, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sahs_nerf_mlp_forward(
    const void* pts, const void* extra, const void* w, const void* b,
    const void* meta, void* out, long long P, int PW, int n_trunk, int hidden,
    int branch, int C, int amb, int nf_xyz, int nf_amb, int nf_dir, int enc,
    void* stream) {
  if (P <= 0) return 0;
  if (enc < 0 || enc > (ENC_PTS | ENC_EXTRA) || 2 * branch > hidden ||
      (!(enc & ENC_PTS) && (PW < 3 || PW > 8 || amb != PW - 3)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.pts = (const float*)pts; a.extra = (const float*)extra;
  a.w = w; a.b = (const float*)b; a.meta = (const int*)meta;
  a.out = (float*)out; a.P = P; a.PW = PW; a.L = n_trunk; a.H = hidden;
  a.B = branch; a.C = C; a.amb = amb; a.nf_xyz = nf_xyz; a.nf_amb = nf_amb;
  a.nf_dir = nf_dir; a.enc = enc;
  return launch<float>(a, reinterpret_cast<cudaStream_t>(stream));
}
