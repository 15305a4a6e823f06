// K5: one NeRF level, forward, with the trilinear spatial embedding and
// the volume compositing inside the kernel; and K7, the same field without
// the compositing.
//
// Replaces sahs_tpu/ops/pallas/field_mlp.py:nerf_level_forward (:2681,
// pallas_call at :2761), in its corner_interp form as
// sahs_tpu/ops/pallas/field_grid.py:nerf_render_level_grid drives it. Per ray:
//   - PE of the packed point [warped xyz (10 freq) | ambient (4 freq)], 81
//     values, and of the raw (un-normalised) ray direction (4 freq, 27);
//   - the 8 corner rows of the corner-packed grid table, gathered INSIDE
//     the kernel by row index (the TPU gathered in XLA because Mosaic could
//     not), and the trilinear weights from the exact cell expression of
//     ops/grid._cell_geometry, giving the 32-channel spatial embedding;
//   - the NeRF MLP: 8x256 leaky trunk (skip at layer 3, conditioning
//     folded into biases), feat and alpha heads, a 4x128 direction branch
//     to rgb (the per-ray direction term computed once per ray), a 4x128
//     seg branch to 12 logits;
//   - compositing (field_mlp.py:2498-2577): sigma = relu(raw + noise) with
//     1e-6 on the last sample, the transmittance exp(-sigma*dist) kept
//     explicit (never 1 - alpha + 1e-10, which is NaN at alpha = 1),
//     T = exp(exclusive cumsum of log(t + 1e-10)), and with a background
//     prior the last sample's 15 channels replaced by the prior and the seg
//     channels softmaxed; without one, sigmoid on every channel.
// Outputs rgb_map (R, 16) and weights (R, S), as field_mlp.py:2688 returns.
//
// A model without the spatial-embedding grid runs the grid-free form
// (field_mlp.py:nerf_render_level :3187, se=None): C = 0, no table and no
// rows, so no cell geometry and no gather; the direction branch's first
// layer reads [feat | pe(dir)] (its se block has no rows). The form on a
// per-point spatial embedding (se (P, C), JAX's non-corner_interp form,
// field_mlp.py:1997-2032) reads each point's se row, rounded to the
// compute dtype as JAX casts it, in place of the gather.
//
// K7 replaces field_mlp.py:nerf_rayd_forward (:1973, pallas_call at :2040)
// in its corner_interp form, the raw field of the deformation-reuse path
// (fuse_composite off): the same kernel, instantiated with RAW, writes
// each point's raw (P, 16) [rgb3 | seg12 | sigma1] to device memory and
// stops before the compositing.
//
// This file holds the float32 instantiations only, the bit-exact oracle
// of the plain versions (1e-4 absolute). In bf16 both run on the tensor
// cores in level_train.cu: K7 as field_tc_kernel, K5 as field_tc_kernel's
// raw field into a float32 scratch and then composite_fwd_kernel, the
// forward half of K2's and K6's compositing, per ray
// (sahs_nerf_level_tc): on an H100 70.1 ms at a frame's fine chunk of
// 4.19 M points against 285 ms in this kernel (PERF.md §6).
//
// Design: one block per ray, its S samples processed in 64-point tiles
// whose activations ping-pong through shared memory (2 x 256 x 64 values);
// the ~0.6 M trunk and branch weights are read from L2, the corner table
// stays L2-resident, and the per-sample raw outputs of the ray stay in
// shared memory until the block composites them. Device memory sees only
// the points, rows, z, and the per-ray outputs. The layer products run on
// the CUDA cores (mlp.cuh).
//
// Bound on the H100: about 1.47 MFLOP per point against ~30 bytes of
// input, so the kernel is bound by operations (a fine chunk of 4.19 M
// points is 6.2 TFLOP: ~6 ms at the 989 TFLOP/s bf16 peak, ~92 ms at the
// 67 TFLOP/s float32 peak outside the tensor cores).
#include "mlp.cuh"

namespace {

constexpr int TP = 64;        // points per MLP tile
constexpr int THREADS = 256;

struct LevelArgs {
  const float* pts;     // (R*S, PW) packed [warped xyz | ambient]
  const int* rows;      // (R*S,) corner-table rows; null when C = 0
  const void* table;    // (rows, 8*C) corner table, compute dtype; null when C = 0
  const float* dirs;    // (R, 3)
  const float* se;      // (R*S, C) per-point spatial embedding, or null
  const float* z;       // (R, S)
  const float* bg;      // (R, 15) or null
  const float* noise;   // (R, S) or null
  const void* w;        // weight blob, compute dtype
  const float* b;       // bias blob
  const int* meta;      // layer descriptors
  float* rgb_map;       // (R, 16)
  float* weights;       // (R, S)
  float* raw_out;       // (R*S, 16) for K7, else null
  long long R;
  int S, PW, n_trunk, hidden, branch, C, amb, nf_xyz, nf_amb, nf_dir;
  int gD, gH, gW;
};

template <typename T>
struct Smem {
  T *xin, *se, *hA, *hB;
  float *cw, *heads, *dpe, *dbias, *raw, *comp;
  int* rowv;
};

template <typename T>
__device__ __host__ size_t carve(const LevelArgs& a, unsigned char* base,
                                 Smem<T>* s) {
  const int kx = 3 + 6 * a.nf_xyz + a.amb * (1 + 2 * a.nf_amb);
  size_t off = 0;
  auto take = [&](size_t bytes) {
    unsigned char* p = base + off;
    off += (bytes + 15) / 16 * 16;
    return p;
  };
  T* xin = (T*)take((size_t)kx * TP * sizeof(T));
  T* se = (T*)take((size_t)a.C * TP * sizeof(T));
  T* hA = (T*)take((size_t)a.hidden * TP * sizeof(T));
  T* hB = (T*)take((size_t)a.hidden * TP * sizeof(T));
  float* cw = (float*)take(8 * TP * sizeof(float));
  float* heads = (float*)take(32 * TP * sizeof(float));
  float* dpe = (float*)take(32 * sizeof(float));
  float* dbias = (float*)take((size_t)a.branch * sizeof(float));
  float* raw = (float*)take((size_t)a.S * 16 * sizeof(float));
  float* comp = (float*)take((size_t)a.S * 4 * sizeof(float));
  int* rowv = (int*)take(TP * sizeof(int));
  if (s != nullptr) *s = Smem<T>{xin, se, hA, hB, cw, heads, dpe, dbias,
                                 raw, comp, rowv};
  return off;
}

// RAW: K7, the raw field out and no compositing (a separate instantiation,
// so that K5's code is what it was without the option).
template <typename T, bool RAW>
__global__ void __launch_bounds__(THREADS) nerf_level_kernel(LevelArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T> sm;
  carve<T>(a, smem_raw, &sm);
  const T* wblob = reinterpret_cast<const T*>(a.w);
  const T* table = reinterpret_cast<const T*>(a.table);
  const long long r = blockIdx.x;
  const int tid = threadIdx.x;
  const int S = a.S, L = a.n_trunk, C = a.C;
  const int kx_xyz = 3 + 6 * a.nf_xyz;

  // per-ray direction term of the dir branch's first layer:
  // dbias = bd0 + pe(dir) @ Wd0[dir rows]
  if (tid == 0) {
    float d[3] = {a.dirs[r * 3 + 0], a.dirs[r * 3 + 1], a.dirs[r * 3 + 2]};
    float tmp[32];
    int k = 0;
    for (int c = 0; c < 3; ++c) tmp[k++] = d[c];
    for (int f = 0; f < a.nf_dir; ++f) {
      const float fr = ldexpf(1.0f, f);
      for (int c = 0; c < 3; ++c) tmp[k++] = sinf(__fmul_rn(d[c], fr));
      for (int c = 0; c < 3; ++c)
        tmp[k++] = sinf(__fadd_rn(__fmul_rn(d[c], fr), SAHS_HALF_PI_F));
    }
    for (int i = 0; i < k; ++i) sm.dpe[i] = sahs::to_f(sahs::from_f<T>(tmp[i]));
  }
  __syncthreads();
  {
    const sahs::LayerDesc d0 = sahs::load_desc(a.meta, L + 2);
    const sahs::LayerDesc dd = sahs::load_desc(a.meta, L + 3);
    for (int n = tid; n < a.branch; n += blockDim.x) {
      float acc = 0.0f;
      for (int k = 0; k < dd.k1; ++k)
        acc = fmaf(sm.dpe[k], sahs::to_f(wblob[dd.w1 + k * dd.n + n]), acc);
      sm.dbias[n] = acc + a.b[d0.b + n];
    }
  }

  for (int s0 = 0; s0 < S; s0 += TP) {
    // point geometry: PE rows, trilinear weights, table rows
    if (tid < TP) {
      const int s = s0 + tid;
      const bool valid = s < S;
      const long long p = r * S + s;
      float x[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (valid)
        for (int c = 0; c < a.PW; ++c) x[c] = a.pts[p * a.PW + c];
      sahs::pe_group<T>(x, 3, a.nf_xyz, sm.xin, 0, tid, TP);
      if (a.amb > 0) sahs::pe_group<T>(x + 3, a.amb, a.nf_amb, sm.xin, kx_xyz, tid, TP);
      if (C > 0 && a.se == nullptr) {   // a corner gather: the cell geometry
        const int dims[3] = {a.gW, a.gH, a.gD};
        float fr[3];
        bool ok = true;
        for (int ax = 0; ax < 3; ++ax) {
          const float i = sahs::cell_index(x[ax], dims[ax]);
          const float i0 = floorf(i);
          fr[ax] = __fsub_rn(i, i0);
          ok = ok && (i0 >= -1.0f) && (i0 <= (float)(dims[ax] - 1));
        }
        const float okf = ok ? 1.0f : 0.0f;
        for (int dz = 0; dz < 2; ++dz) {
          const float wz = dz ? fr[2] : __fsub_rn(1.0f, fr[2]);
          for (int dy = 0; dy < 2; ++dy) {
            const float wy = dy ? fr[1] : __fsub_rn(1.0f, fr[1]);
            for (int dx = 0; dx < 2; ++dx) {
              const float wx = dx ? fr[0] : __fsub_rn(1.0f, fr[0]);
              sm.cw[(dz * 4 + dy * 2 + dx) * TP + tid] =
                  __fmul_rn(__fmul_rn(__fmul_rn(wz, wy), wx), okf);
            }
          }
        }
        sm.rowv[tid] = valid ? a.rows[p] : 0;
      }
    }
    if (a.se != nullptr)   // the spatial embedding given per point
      sahs::point_rows<T>(a.se, C, r * S + s0, r * S + S, C, sm.se, 0, TP, TP);
    __syncthreads();
    // spatial embedding from the gathered corner rows
    for (int idx = tid; a.se == nullptr && idx < C * TP; idx += blockDim.x) {
      const int t = idx / C, c = idx % C;
      const T* row = table + (size_t)sm.rowv[t] * 8 * C;
      float acc = 0.0f;
      for (int s8 = 0; s8 < 8; ++s8) {
        const float v = __fmul_rn(sahs::to_f(row[s8 * C + c]), sm.cw[s8 * TP + t]);
        acc = s8 == 0 ? v : __fadd_rn(acc, v);
      }
      sm.se[c * TP + t] = sahs::from_f<T>(acc);
    }
    __syncthreads();

    // trunk
    const T* src = sm.xin;
    T* dst = sm.hA;
    for (int l = 0; l < L; ++l) {
      const sahs::LayerDesc d = sahs::load_desc(a.meta, l);
      sahs::mlp_layer<T>(d, wblob, a.b, src, d.w2 >= 0 ? sm.xin : nullptr,
                         nullptr, dst, nullptr, TP);
      __syncthreads();
      src = dst;
      dst = dst == sm.hA ? sm.hB : sm.hA;
    }
    T* hl = const_cast<T*>(src);   // last trunk activation, free after feat
    T* feat = dst;
    T* b0 = hl;
    T* b1 = hl + a.branch * TP;
    float* rgbY = sm.heads;            // [8][TP]
    float* segY = sm.heads + 8 * TP;   // [16][TP]
    float* alphaY = sm.heads + 24 * TP;
    sahs::mlp_layer<T>(sahs::load_desc(a.meta, L), wblob, a.b, hl, nullptr,
                       nullptr, feat, nullptr, TP);
    __syncthreads();
    sahs::mlp_layer<T>(sahs::load_desc(a.meta, L + 1), wblob, a.b, feat,
                       nullptr, nullptr, nullptr, alphaY, TP);
    // direction branch: [feat | pe(dir) | se] -> 4 x branch -> rgb
    sahs::mlp_layer<T>(sahs::load_desc(a.meta, L + 2), wblob, a.b, feat,
                       sm.se, sm.dbias, b0, nullptr, TP);
    __syncthreads();
    for (int l = 0; l < 3; ++l) {
      sahs::mlp_layer<T>(sahs::load_desc(a.meta, L + 4 + l), wblob, a.b,
                         l % 2 ? b1 : b0, nullptr, nullptr, l % 2 ? b0 : b1,
                         nullptr, TP);
      __syncthreads();
    }
    sahs::mlp_layer<T>(sahs::load_desc(a.meta, L + 7), wblob, a.b, b1,
                       nullptr, nullptr, nullptr, rgbY, TP);
    __syncthreads();
    // seg branch: feat -> 4 x branch -> 12 logits
    sahs::mlp_layer<T>(sahs::load_desc(a.meta, L + 8), wblob, a.b, feat,
                       nullptr, nullptr, b0, nullptr, TP);
    __syncthreads();
    for (int l = 0; l < 3; ++l) {
      sahs::mlp_layer<T>(sahs::load_desc(a.meta, L + 9 + l), wblob, a.b,
                         l % 2 ? b1 : b0, nullptr, nullptr, l % 2 ? b0 : b1,
                         nullptr, TP);
      __syncthreads();
    }
    sahs::mlp_layer<T>(sahs::load_desc(a.meta, L + 12), wblob, a.b, b1,
                       nullptr, nullptr, nullptr, segY, TP);
    __syncthreads();
    if (tid < TP && s0 + tid < S) {
      float* o = RAW ? a.raw_out + (r * S + s0 + tid) * 16
                     : sm.raw + (s0 + tid) * 16;
      for (int c = 0; c < 3; ++c) o[c] = rgbY[c * TP + tid];
      for (int c = 0; c < 12; ++c) o[3 + c] = segY[c * TP + tid];
      o[15] = alphaY[tid];
    }
    __syncthreads();
  }
  if (RAW) return;   // K7: the raw field only

  // compositing
  float* tt = sm.comp;
  float* lt = sm.comp + S;
  float* al = sm.comp + 2 * S;
  float* wt = sm.comp + 3 * S;
  const float d0 = a.dirs[r * 3 + 0], d1 = a.dirs[r * 3 + 1], d2 = a.dirs[r * 3 + 2];
  const float rdn = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                                    __fmul_rn(d2, d2)));
  const float* zr = a.z + r * S;
  for (int s = tid; s < S; s += blockDim.x) {
    float sr = sm.raw[s * 16 + 15];
    if (a.noise != nullptr) sr = __fadd_rn(sr, a.noise[r * S + s]);
    const float sigma = __fadd_rn(fmaxf(sr, 0.0f), s == S - 1 ? 1e-6f : 0.0f);
    const float dz = s < S - 1 ? __fsub_rn(zr[s + 1], zr[s]) : 1e10f;
    const float t = expf(__fmul_rn(-sigma, __fmul_rn(dz, rdn)));
    tt[s] = t;
    al[s] = __fsub_rn(1.0f, t);
    lt[s] = logf(__fadd_rn(t, 1e-10f));
  }
  __syncthreads();
  if (tid == 0) {
    float cum = 0.0f;
    for (int s = 0; s < S; ++s) {
      const float v = lt[s];
      lt[s] = cum;
      cum = __fadd_rn(cum, v);
    }
  }
  __syncthreads();
  const bool has_bg = a.bg != nullptr;
  for (int s = tid; s < S; s += blockDim.x) {
    const float w = __fmul_rn(al[s], expf(lt[s]));
    wt[s] = w;
    a.weights[r * S + s] = w;
    float* o = sm.raw + s * 16;
    if (has_bg && s == S - 1) {
      for (int c = 0; c < 15; ++c) o[c] = a.bg[r * 15 + c];
    } else {
      for (int c = 0; c < 3; ++c) o[c] = 1.0f / (1.0f + expf(-o[c]));
      if (has_bg) {
        float mx = o[3];
        for (int c = 4; c < 15; ++c) mx = fmaxf(mx, o[c]);
        float e[12], sum = 0.0f;
        for (int c = 0; c < 12; ++c) {
          e[c] = expf(__fsub_rn(o[3 + c], mx));
          sum = __fadd_rn(sum, e[c]);
        }
        for (int c = 0; c < 12; ++c) o[3 + c] = __fdiv_rn(e[c], sum);
      } else {
        for (int c = 3; c < 15; ++c) o[c] = 1.0f / (1.0f + expf(-o[c]));
      }
    }
    o[15] = 0.0f;
  }
  __syncthreads();
  for (int c = tid; c < 16; c += blockDim.x) {
    float acc = 0.0f;
    for (int s = 0; s < S; ++s)
      acc = __fadd_rn(acc, __fmul_rn(wt[s], sm.raw[s * 16 + c]));
    a.rgb_map[r * 16 + c] = acc;
  }
}

template <typename T, bool RAW>
int launch(const LevelArgs& a, cudaStream_t stream) {
  const size_t smem = carve<T>(a, nullptr, nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      nerf_level_kernel<T, RAW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  nerf_level_kernel<T, RAW><<<(unsigned)a.R, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

LevelArgs make_args(const void* pts, const void* rows, const void* table,
                    const void* dirs, const void* se, const void* w, const void* b,
                    const void* meta, long long R, int S, int PW, int n_trunk,
                    int hidden, int branch, int C, int amb, int nf_xyz,
                    int nf_amb, int nf_dir, int gD, int gH, int gW) {
  LevelArgs a = {};
  a.pts = (const float*)pts; a.rows = (const int*)rows; a.table = table;
  a.dirs = (const float*)dirs; a.se = (const float*)se;
  a.w = w; a.b = (const float*)b; a.meta = (const int*)meta;
  a.R = R; a.S = S; a.PW = PW; a.n_trunk = n_trunk; a.hidden = hidden;
  a.branch = branch; a.C = C; a.amb = amb; a.nf_xyz = nf_xyz;
  a.nf_amb = nf_amb; a.nf_dir = nf_dir; a.gD = gD; a.gH = gH; a.gW = gW;
  return a;
}

}  // namespace

extern "C" int sahs_nerf_level_forward(
    const void* pts, const void* rows, const void* table, const void* dirs,
    const void* se, const void* z, const void* bg, const void* noise, const void* w,
    const void* b, const void* meta, void* rgb_map, void* weights,
    long long R, int S, int PW, int n_trunk, int hidden, int branch, int C,
    int amb, int nf_xyz, int nf_amb, int nf_dir, int gD, int gH, int gW,
    void* stream) {
  if (R <= 0) return 0;
  LevelArgs a = make_args(pts, rows, table, dirs, se, w, b, meta, R, S, PW,
                          n_trunk, hidden, branch, C, amb, nf_xyz, nf_amb,
                          nf_dir, gD, gH, gW);
  a.z = (const float*)z;
  a.bg = (const float*)bg; a.noise = (const float*)noise;
  a.rgb_map = (float*)rgb_map; a.weights = (float*)weights;
  return launch<float, false>(a, reinterpret_cast<cudaStream_t>(stream));
}

extern "C" int sahs_nerf_rayd_forward(
    const void* pts, const void* rows, const void* table, const void* dirs,
    const void* se, const void* w, const void* b, const void* meta, void* raw, long long R,
    int S, int PW, int n_trunk, int hidden, int branch, int C, int amb,
    int nf_xyz, int nf_amb, int nf_dir, int gD, int gH, int gW,
    void* stream) {
  if (R <= 0) return 0;
  if (raw == nullptr) return (int)cudaErrorInvalidValue;
  LevelArgs a = make_args(pts, rows, table, dirs, se, w, b, meta, R, S, PW,
                          n_trunk, hidden, branch, C, amb, nf_xyz, nf_amb,
                          nf_dir, gD, gH, gW);
  a.raw_out = (float*)raw;
  return launch<float, true>(a, reinterpret_cast<cudaStream_t>(stream));
}
