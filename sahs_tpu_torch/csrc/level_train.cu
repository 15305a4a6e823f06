// K2, K6 and K8: one NeRF level's backward, as three modes of one kernel
// set.
//
// K2 replaces sahs_tpu/ops/pallas/level_train.py:nerf_level_train (:55,
// pallas_call at :306) in its corner_interp form: the forward, the loss
// cotangents formed in the kernel and the full backward, from one call.
// Inputs: K1's packed points (P, 3 + ambient) and corner-table rows, the
// corner table, the raw ray directions, z, the background prior and sigma
// noise (optional), the target (R, 15) and the per-ray loss weights (R, 2).
// Outputs: rgb_map (R, 16), weights (R, S), gx (P, 3 + ambient) (PE
// backward plus the trilinear dCoords on xyz), gse (P, C) (the cotangent of
// the sampled spatial embedding, for K4), g_bg (R, 16) and dW/db of every
// layer.
//
// K6 (MODE_VJP) replaces sahs_tpu/ops/pallas/field_mlp.py:nerf_level_vjp
// (:2951, pallas_call at :3091), the backward of K5 that the autograd
// fallback runs: the same launches, with the per-ray cotangents g_rgb
// (R, 16) and g_w (R, S) read in place of the loss cotangents. g_bg is the
// last sample's channel cotangent, w_last * g_rgb.
//
// K8 (MODE_RAW) replaces field_mlp.py:nerf_rayd_vjp (:2059, pallas_call at
// :2269), the backward of K7 (the raw field, no compositing): the cotangent
// of raw (P, 16) is given, so the compositing launch is skipped and the
// per-tile backward reads it directly.
//
// K12 (MODE_PTS) replaces field_mlp.py:nerf_mlp_vjp (:1546, pallas_call at
// :1686), the backward of K11 (csrc/nerf_mlp.cu) on the per-point branch:
// K8's launches, but each point brings its own extra input (P, 3 + C)
// [raw dir | spatial embedding] instead of a ray's direction and a corner
// gather, and the per-tile backward ends with gextra (P, 3 + C), the
// cotangent of that input (the direction's through its PE backward, as the
// JAX kernel computes it), in place of gse and the corner dCoords.
//
// In bf16 the same file also holds K7's and K11's forward
// (field_tc_kernel, `sahs_nerf_field_tc`): launch 1's tile routine on
// wgmma, fw::tile, with its stash writes compiled out (see below); and
// K5's (`sahs_nerf_level_tc`): field_tc_kernel's raw field into a float32
// scratch, then composite_fwd_kernel, the forward half of launch 2 (one
// routine, composite_fwd, for both), per ray (see launch_level_tc).
//
// A model without the spatial-embedding grid runs the grid-free form of
// the three ray modes (field_mlp.py:nerf_level_vjp / nerf_rayd_vjp and
// level_train.py with se=None): C = 0, no table and no rows, so launch 1
// gathers nothing, and launch 3 writes no gse and adds no trilinear
// dCoords (gx is the PE backward alone). The ray modes also take JAX's
// per-point spatial embedding (se (P, C), the non-corner_interp form,
// field_mlp.py:2130-2142, level_train.py:62): launch 1 reads each point's
// row rounded to the compute dtype in place of the gather, and launch 3
// writes gse (P, C) and adds no dCoords. MODE_PTS also takes the
// pre-encoded inputs of field_mlp.py:nerf_mlp_vjp (ENC_PTS, ENC_EXTRA: the
// encodings in the compute dtype, no PE; gx and gextra the encodings'
// cotangents).
//
// Why not one pass, as on the TPU: a backward needs all 8 trunk layers,
// the heads and the PE of every point, 3.5 K values a point, while a block
// has 227 KB of shared memory. And dW is a reduction over all points,
// which Hopper's unordered blocks cannot carry from one grid step to the
// next. So one call makes five launches (four for K8 and K12):
//   1. per tile: PE (accurate sinf, no fast math), the trilinear
//      sample with _cell_geometry's exact float expression from the 8
//      corner rows gathered in the kernel, the MLP; every layer's
//      input goes to a device-memory stash (train.cuh), raw (P, 16) out;
//   2. per ray: compositing with the transmittance exp(-sigma dist) kept
//      explicit and sigma[:, -1] += 1e-6, the cotangents of rgb_map and
//      the weights (K2: the loss's, level_train.py:26-32 and :179-204; K6:
//      the given g_rgb, g_w), and the compositing backward with the reverse
//      exclusive scan (field_mlp.py:2580-2623); with a background the
//      raw-background last sample gets no rgb/seg gradient (not_last);
//   3. per tile: the head, branch and trunk backward with transposed
//      weights, each layer's gz to a second stash, then per point the PE
//      backward and the corner dCoords (field_mlp.py:1824-1843);
//   4-5. the dW reduction over both stashes (bf16: level_dw.cuh, float32:
//      train.cuh), summed in a fixed order.
//
// Bound on the H100: about 3 x 0.74 M multiply-adds a point (forward,
// backward chain, dW) against ~60 bytes of input, so operations bound it:
// 0.58 / 1.16 TFLOP at 131,072 / 262,144 points, 0.6 / 1.2 ms at the
// 989 TFLOP/s bf16 peak; K12 at a per-point step's 393,216 points (2048
// rays x 192) 1.7 TFLOP, 1.8 ms. Apart, the dW reads the stashes (13.6 KB
// a point in bf16: 3.6 GB at 262,144 points, 1.07 ms at 3.35 TB/s).
//
// Two instantiations. float32 runs launches 1 and 3 as fwd_kernel and
// bwd_kernel on 32-point tiles with mlp.cuh's SIMT products, and dW with
// train.cuh's dw_kernel (exact float32; its gates allow no TF32). bf16
// runs them on 64-point tiles and wgmma (wgmma.cuh: persistent blocks, two
// consumer warpgroups, a producer warp streaming weight stages laid out
// ahead of time through a TMA ring): launch 1 as fwd_tc_kernel (fw::
// below), launch 3 as bwd_tc_kernel (bw:: below: the transposed layers'
// stages, and each chunk's stashed outputs copied by TMA into the same
// ring for the activation's derivative), and dW as level_dw.cuh's
// level_dw_kernel (each stash block read once from device memory; db from
// the per-tile column sums of gz that launch 3 forms). The gz stash is
// bf16 (the dW rounds gz anyway). Each backward product's epilogue applies
// the activation's derivative and writes gz to its stash slot and to
// shared memory for the next product, so no float32 tile of ga is kept;
// the alpha head's one-row cotangent enters gfeat as a rank-1 term of that
// epilogue; the skip layer's share of the PE cotangent is taken as soon as
// gz_skip exists, and [pe(dir) | se]'s cotangent is used per point (gse,
// the corner dCoords, K12's gextra) right after its product.
//
// K2's pair= form (level_train.py:58-78, :232-246, JAX's SAHS_PAIR_FOLD
// fused step) is not a kernel of this file: the wrapper (level_train.py)
// runs this library's K2 call, with gx written to a float32 scratch, and
// then K3's rays= call (deform_pair_vjp.cu) on that gx. On the TPU the
// fold kept gx in VMEM; here the level's backward tile and the pair's are
// persistent blocks with up to 227 KB of shared memory each, rings and
// layouts of their own, and gx at a step's fine level (262,144 x 5 x 4 B =
// 5.2 MB) is ~1.6 us each way at 3.35 TB/s and sits in the 50 MB L2, so
// one kernel for both would save microseconds against milliseconds of
// products.
#include "level_dw.cuh"
#include "wgmma.cuh"

namespace {

constexpr int TP = 32;
constexpr int THREADS = 256;
constexpr int CTHREADS = 128;
enum { MODE_LOSS = 0, MODE_VJP = 1, MODE_RAW = 2, MODE_PTS = 3 };
// MODE_PTS's pre-encoded inputs (field_mlp.py:nerf_mlp_forward_fused and
// nerf_mlp_vjp with pe_spec / extra_pe_spec None), bits of Args::enc
enum { ENC_PTS = 1, ENC_EXTRA = 2 };

struct Args {
  const float* pts;     // (P, PW)
  const int* rows;      // (P,), null in MODE_PTS and when C = 0
  const void* table;    // corner table, compute dtype; null in MODE_PTS and when C = 0
  const float* dirs;    // (R, 3); null in MODE_PTS
  const float* extra;   // (P, 3 + C), MODE_PTS; with ENC_EXTRA (P, C), compute dtype
  float* gextra;        // (P, 3 + C), MODE_PTS; with ENC_EXTRA (P, C)
  const float* se;      // (P, C) per-point spatial embedding, or null (ray modes)
  const float* z;       // (R, S)
  const float* bg;      // (R, 15) or null
  const float* noise;   // (R, S) or null
  const float* tgt;     // (R, 15), MODE_LOSS
  const float* lw;      // (R, 2), MODE_LOSS
  const float* g_rgb;   // (R, 16), MODE_VJP
  const float* g_w;     // (R, S), MODE_VJP
  const void* w; const float* b; const int* meta;      // forward layers
  const void* wT; const float* bT; const int* metaT;   // transposed layers
  float* rgb_map;       // (R, 16)
  float* weights;       // (R, S)
  float* gx;            // (P, PW)
  float* gse;           // (P, C)
  float* g_bg;          // (R, 16)
  float* raw;           // (P, 16) scratch, or null (MODE_RAW)
  float* graw;          // (P, 16): launch 2's, or the given cotangent (MODE_RAW)
  void* acts; float* gzs; const int* slots;
  long long R, P, act_stride, gz_stride;
  int S, PW, L, skip, H, B, C, amb, nf_xyz, nf_amb, nf_dir, gD, gH, gW;
  int n_act, mode;
  int enc;              // ENC_* bits, MODE_PTS only
  int kx, ndp;          // rows of the point encoding and of pe(dir) (set_widths)
  float bg_sup;
  const void* wg;       // bf16 forward: the weight stages (nerf_level.wgmma_blob)
  long long wg_bytes;
  const void* wgb;      // bf16 backward: the transposed layers' stages (level_train.backward_stages)
  long long wgb_bytes;
  float* bsum;          // bf16 backward: each tile's column sums of gz (n_tiles, gz_stride / 64)
};

// The encodings' widths: the point's PE (kx), or with ENC_PTS the given
// encoding's PW columns; the direction's PE (ndp), none with ENC_EXTRA, whose
// C columns are all of [pe(dir) | se].
void set_widths(Args& a) {
  a.kx = (a.enc & ENC_PTS) ? a.PW : 3 + 6 * a.nf_xyz + a.amb * (1 + 2 * a.nf_amb);
  a.ndp = (a.enc & ENC_EXTRA) ? 0 : 3 + 6 * a.nf_dir;
}
__device__ __forceinline__ int kx_of(const Args& a) { return a.kx; }
__device__ __forceinline__ int ndp_of(const Args& a) { return a.ndp; }
__host__ __device__ __forceinline__ int pad8(int n) { return (n + 7) / 8 * 8; }

// cell fractions and the zeros-padding predicate (ops/grid._cell_geometry)
__device__ __forceinline__ float cell_fracs(const float* x, const Args& a,
                                            float fr[3]) {
  const int dims[3] = {a.gW, a.gH, a.gD};
  bool ok = true;
  for (int ax = 0; ax < 3; ++ax) {
    const float i = sahs::cell_index(x[ax], dims[ax]);
    const float i0 = floorf(i);
    fr[ax] = __fsub_rn(i, i0);
    ok = ok && (i0 >= -1.0f) && (i0 <= (float)(dims[ax] - 1));
  }
  return ok ? 1.0f : 0.0f;
}

// ---------------------------------------------------------------------------
// 1. forward per tile
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS) fwd_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kx = kx_of(a), ndp = ndp_of(a), C = a.C, L = a.L;
  T* xin = reinterpret_cast<T*>(smem_raw);
  T* din = xin + kx * TP;                 // [pe(dir) ; se]
  T* hA = din + (ndp + C) * TP;
  T* hB = hA + a.H * TP;
  float* cw = reinterpret_cast<float*>(hB + a.H * TP);   // [8][TP]
  float* rgbY = cw + 8 * TP;                              // [8][TP]
  float* segY = rgbY + 8 * TP;                            // [16][TP]
  float* alphaY = segY + 16 * TP;                         // [8][TP]
  int* rowv = reinterpret_cast<int*>(alphaY + 8 * TP);
  const T* wblob = reinterpret_cast<const T*>(a.w);
  const T* table = reinterpret_cast<const T*>(a.table);
  const long long tile = blockIdx.x, base = tile * TP;
  T* acts = reinterpret_cast<T*>(a.acts) + tile * a.act_stride;
  const int* act_off = a.slots;
  const int tid = threadIdx.x;

  const bool per_point = a.mode == MODE_PTS;
  const bool xenc = a.enc & ENC_PTS, eenc = a.enc & ENC_EXTRA;
  if (tid < TP) {
    const long long p = base + tid;
    const bool valid = p < a.P;
    float x[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    float d[3] = {0, 0, 0};
    if (valid && !xenc)
      for (int c = 0; c < a.PW; ++c) x[c] = a.pts[p * a.PW + c];
    if (valid && !eenc) {
      const float* dsrc = per_point ? a.extra + p * (3 + C) : a.dirs + p / a.S * 3;
      for (int c = 0; c < 3; ++c) d[c] = dsrc[c];
    }
    if (!xenc) {
      sahs::pe_group<T>(x, 3, a.nf_xyz, xin, 0, tid, TP);
      if (a.amb > 0)
        sahs::pe_group<T>(x + 3, a.amb, a.nf_amb, xin, 3 + 6 * a.nf_xyz, tid, TP);
    }
    if (!eenc) sahs::pe_group<T>(d, 3, a.nf_dir, din, 0, tid, TP);
  }
  if (xenc)   // K12 pre-encoded: the point's encoding is given
    sahs::point_rows<T>(reinterpret_cast<const T*>(a.pts), kx, base, a.P, kx, xin,
                        0, TP, TP);
  if (per_point && eenc) {   // [pe(dir) | se] given, in the compute dtype
    sahs::point_rows<T>(reinterpret_cast<const T*>(a.extra), C, base, a.P, C, din,
                        0, TP, TP);
  } else if (per_point) {
    // K12: the spatial embedding is given, channel-fastest reads
    sahs::point_rows<T>(a.extra + 3, 3 + C, base, a.P, C, din, ndp, TP, TP);
  } else if (a.se != nullptr) {
    // the ray modes on a per-point spatial embedding
    sahs::point_rows<T>(a.se, C, base, a.P, C, din, ndp, TP, TP);
  } else if (tid < TP && C > 0) {
    const long long p = base + tid;
    const bool valid = p < a.P;
    float x[3] = {0, 0, 0};
    if (valid)
      for (int c = 0; c < 3; ++c) x[c] = a.pts[p * a.PW + c];
    float fr[3];
    const float okf = cell_fracs(x, a, fr);
    for (int dz = 0; dz < 2; ++dz) {
      const float wz = dz ? fr[2] : __fsub_rn(1.0f, fr[2]);
      for (int dy = 0; dy < 2; ++dy) {
        const float wy = dy ? fr[1] : __fsub_rn(1.0f, fr[1]);
        for (int dx = 0; dx < 2; ++dx) {
          const float wx = dx ? fr[0] : __fsub_rn(1.0f, fr[0]);
          cw[(dz * 4 + dy * 2 + dx) * TP + tid] =
              __fmul_rn(__fmul_rn(__fmul_rn(wz, wy), wx), okf);
        }
      }
    }
    rowv[tid] = valid ? a.rows[p] : 0;
  }
  __syncthreads();
  if (!per_point && a.se == nullptr && C > 0) {
    for (int idx = tid; idx < C * TP; idx += blockDim.x) {
      const int t = idx / C, c = idx % C;
      const T* row = table + (size_t)rowv[t] * 8 * C;
      float acc = 0.0f;
      for (int s8 = 0; s8 < 8; ++s8) {
        const float v = __fmul_rn(sahs::to_f(row[s8 * C + c]), cw[s8 * TP + t]);
        acc = s8 == 0 ? v : __fadd_rn(acc, v);
      }
      din[(ndp + c) * TP + t] = sahs::from_f<T>(acc);
    }
    __syncthreads();
  }
  sahs::store_rows<T>(xin, acts + act_off[0], kx, TP);
  sahs::store_rows<T>(din, acts + act_off[L + 2], ndp + C, TP);

  const T* src = xin;
  T* dst = hA;
  for (int l = 0; l < L; ++l) {
    const sahs::LayerDesc d = sahs::load_desc(a.meta, l);
    sahs::mlp_layer<T>(d, wblob, a.b, src, d.w2 >= 0 ? xin : nullptr, nullptr,
                       dst, nullptr, TP);
    __syncthreads();
    sahs::store_rows<T>(dst, acts + act_off[1 + l], a.H, TP);
    src = dst;
    dst = dst == hA ? hB : hA;
  }
  T* hl = const_cast<T*>(src);
  T* feat = dst;
  T* b0 = hl;
  T* b1 = hl + a.B * TP;
  sahs::mlp_layer<T>(sahs::load_desc(a.meta, L), wblob, a.b, hl, nullptr,
                     nullptr, feat, nullptr, TP);
  __syncthreads();
  sahs::store_rows<T>(feat, acts + act_off[L + 1], a.H, TP);
  sahs::mlp_layer<T>(sahs::load_desc(a.meta, L + 1), wblob, a.b, feat, nullptr,
                     nullptr, nullptr, alphaY, TP);
  // direction branch: [feat | pe(dir) | se] -> 4 x B -> rgb
  sahs::mlp_layer<T>(sahs::load_desc(a.meta, L + 2), wblob, a.b, feat, din,
                     nullptr, b0, nullptr, TP);
  __syncthreads();
  sahs::store_rows<T>(b0, acts + act_off[L + 3], a.B, TP);
  for (int k = 1; k <= 3; ++k) {
    T* in = k % 2 ? b0 : b1;
    T* out = k % 2 ? b1 : b0;
    sahs::mlp_layer<T>(sahs::load_desc(a.meta, L + 2 + k), wblob, a.b, in,
                       nullptr, nullptr, out, nullptr, TP);
    __syncthreads();
    sahs::store_rows<T>(out, acts + act_off[L + 3 + k], a.B, TP);
  }
  sahs::mlp_layer<T>(sahs::load_desc(a.meta, L + 6), wblob, a.b, b1, nullptr,
                     nullptr, nullptr, rgbY, TP);
  __syncthreads();
  // seg branch: feat -> 4 x B -> 12 logits
  sahs::mlp_layer<T>(sahs::load_desc(a.meta, L + 7), wblob, a.b, feat, nullptr,
                     nullptr, b0, nullptr, TP);
  __syncthreads();
  sahs::store_rows<T>(b0, acts + act_off[L + 7], a.B, TP);
  for (int k = 1; k <= 3; ++k) {
    T* in = k % 2 ? b0 : b1;
    T* out = k % 2 ? b1 : b0;
    sahs::mlp_layer<T>(sahs::load_desc(a.meta, L + 7 + k), wblob, a.b, in,
                       nullptr, nullptr, out, nullptr, TP);
    __syncthreads();
    sahs::store_rows<T>(out, acts + act_off[L + 7 + k], a.B, TP);
  }
  sahs::mlp_layer<T>(sahs::load_desc(a.meta, L + 11), wblob, a.b, b1, nullptr,
                     nullptr, nullptr, segY, TP);
  __syncthreads();
  if (a.raw == nullptr) return;
  for (int i = tid; i < 16 * TP; i += blockDim.x) {
    const int t = i / 16, c = i % 16;
    const long long p = base + t;
    if (p >= a.P) continue;
    const float v = c < 3 ? rgbY[c * TP + t]
                  : c < 15 ? segY[(c - 3) * TP + t] : alphaY[t];
    a.raw[p * 16 + c] = v;
  }
}

// ---------------------------------------------------------------------------
// 2. compositing, loss cotangents, compositing backward, per ray
// ---------------------------------------------------------------------------

// Per-ray floats of the compositing's shared memory: the forward's
// channels [S][16], sig, tt, al, dist, cum and wt (COMPOSITE_FWD_FLOATS a
// sample); the backward's gwt and gcum after them (COMPOSITE_FLOATS).
constexpr int COMPOSITE_FWD_FLOATS = 22;
constexpr int COMPOSITE_FLOATS = 24;

// The forward of one ray's compositing (field_mlp.py:2498-2577), shared by
// K2's and K6's composite_kernel and bf16 K5's composite_fwd_kernel: from
// the ray's raw field a.raw[r*S .. (r+1)*S) the channels (sigmoid rgb;
// softmax seg with a background prior, sigmoid without; the last sample's
// 15 channels the prior itself with one), sig = raw sigma (+ noise), the
// transmittance tt = exp(-sigma dist) kept explicit with sigma[S-1] +=
// 1e-6, al = 1 - tt, the exclusive scan of log(tt + 1e-10) turned into T
// (cum), the weights wt = al T, and rgb_map = sum_s wt ch, written to
// a.weights, a.rgb_map and, when given, rm[16]. Ends with a __syncthreads().
__device__ __forceinline__ void composite_fwd(const Args& a, float* smem,
                                              float* rm) {
  const int S = a.S;
  float* ch = smem;            // [S][16]
  float* sig = ch + S * 16;
  float* tt = sig + S;
  float* al = tt + S;
  float* dist = al + S;
  float* cum = dist + S;       // exclusive scan of log t, then T
  float* wt = cum + S;
  const long long r = blockIdx.x;
  const int tid = threadIdx.x;
  const bool has_bg = a.bg != nullptr;
  const float d0 = a.dirs[r * 3 + 0], d1 = a.dirs[r * 3 + 1], d2 = a.dirs[r * 3 + 2];
  const float rdn = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                                    __fmul_rn(d2, d2)));
  const float* zr = a.z + r * S;
  const float* raw = a.raw + r * S * 16;
  for (int s = tid; s < S; s += blockDim.x) {
    float sr = raw[s * 16 + 15];
    if (a.noise != nullptr) sr = __fadd_rn(sr, a.noise[r * S + s]);
    sig[s] = sr;
    const float sigma = __fadd_rn(fmaxf(sr, 0.0f), s == S - 1 ? 1e-6f : 0.0f);
    const float dz = s < S - 1 ? __fsub_rn(zr[s + 1], zr[s]) : 1e10f;
    dist[s] = __fmul_rn(dz, rdn);
    const float t = expf(__fmul_rn(-sigma, dist[s]));
    tt[s] = t;
    al[s] = __fsub_rn(1.0f, t);
    cum[s] = logf(__fadd_rn(t, 1e-10f));
    float* o = ch + s * 16;
    const float* ri = raw + s * 16;
    if (has_bg && s == S - 1) {
      for (int c = 0; c < 15; ++c) o[c] = a.bg[r * 15 + c];
    } else {
      for (int c = 0; c < 3; ++c) o[c] = 1.0f / (1.0f + expf(-ri[c]));
      if (has_bg) {
        float mx = ri[3];
        for (int c = 4; c < 15; ++c) mx = fmaxf(mx, ri[c]);
        float e[12], sum = 0.0f;
        for (int c = 0; c < 12; ++c) {
          e[c] = expf(__fsub_rn(ri[3 + c], mx));
          sum = __fadd_rn(sum, e[c]);
        }
        for (int c = 0; c < 12; ++c) o[3 + c] = __fdiv_rn(e[c], sum);
      } else {
        for (int c = 3; c < 15; ++c) o[c] = 1.0f / (1.0f + expf(-ri[c]));
      }
    }
    o[15] = 0.0f;
  }
  __syncthreads();
  if (tid == 0) {
    float c = 0.0f;
    for (int s = 0; s < S; ++s) {
      const float v = cum[s];
      cum[s] = c;
      c = __fadd_rn(c, v);
    }
  }
  __syncthreads();
  for (int s = tid; s < S; s += blockDim.x) {
    cum[s] = expf(cum[s]);                      // T
    wt[s] = __fmul_rn(al[s], cum[s]);
    a.weights[r * S + s] = wt[s];
  }
  __syncthreads();
  if (tid < 16) {
    float acc = 0.0f;
    for (int s = 0; s < S; ++s) acc = __fadd_rn(acc, __fmul_rn(wt[s], ch[s * 16 + tid]));
    if (rm != nullptr) rm[tid] = acc;
    a.rgb_map[r * 16 + tid] = acc;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(CTHREADS) composite_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int S = a.S;
  float* ch = reinterpret_cast<float*>(smem_raw);   // composite_fwd's layout
  float* sig = ch + S * 16;
  float* tt = sig + S;
  float* al = tt + S;
  float* dist = al + S;
  float* cum = dist + S;
  float* wt = cum + S;
  float* gwt = wt + S;
  float* gcum = gwt + S;       // T * g_T, then its reverse exclusive scan
  __shared__ float rm[16], grg[16], gw_last;
  const long long r = blockIdx.x;
  const int tid = threadIdx.x;
  const bool has_bg = a.bg != nullptr;
  composite_fwd(a, ch, rm);
  const bool given = a.mode == MODE_VJP;
  const float* tg = given ? nullptr : a.tgt + r * 15;
  const bool sup = !given && has_bg && a.bg_sup > 0.0f;
  if (tid < 16) {
    const int c = tid;
    float g = 0.0f;
    if (given) g = a.g_rgb[r * 16 + c];
    else if (c < 3) g = a.lw[r * 2] * 2.0f * (rm[c] - tg[c]);
    else if (c < 15) g = a.lw[r * 2 + 1] * (-tg[c] / (rm[c] + 1e-10f));
    grg[c] = g;
    if (has_bg && c < 15) {
      float gb = wt[S - 1] * g;
      if (sup && c < 3) gb += a.bg_sup * wt[S - 1] * 2.0f * (a.bg[r * 15 + c] - tg[c]);
      a.g_bg[r * 16 + c] = gb;
    } else if (has_bg) {
      a.g_bg[r * 16 + c] = 0.0f;
    }
  }
  if (tid == 0) {
    float e = 0.0f;
    if (sup)
      for (int c = 0; c < 3; ++c) {
        const float d = a.bg[r * 15 + c] - tg[c];
        e += d * d;
      }
    gw_last = sup ? a.bg_sup * e : 0.0f;
  }
  __syncthreads();
  for (int s = tid; s < S; s += blockDim.x) {
    float cg = 0.0f;
    for (int c = 0; c < 16; ++c) cg += ch[s * 16 + c] * grg[c];
    const float gw = given ? a.g_w[r * S + s] : (s == S - 1 ? gw_last : 0.0f);
    const float g = gw + cg;
    gwt[s] = g;
    gcum[s] = cum[s] * (g * al[s]);
  }
  __syncthreads();
  if (tid == 0) {
    float c = 0.0f;
    for (int s = S - 1; s >= 0; --s) {
      const float v = gcum[s];
      gcum[s] = c;
      c = __fadd_rn(c, v);
    }
  }
  __syncthreads();
  for (int s = tid; s < S; s += blockDim.x) {
    const float g_alpha = gwt[s] * cum[s] - gcum[s] / (tt[s] + 1e-10f);
    const float g_sig = sig[s] > 0.0f ? g_alpha * tt[s] * dist[s] : 0.0f;
    const float nl = (has_bg && s == S - 1) ? 0.0f : 1.0f;
    const float* o = ch + s * 16;
    float* gr = a.graw + (r * S + s) * 16;
    for (int c = 0; c < 3; ++c)
      gr[c] = wt[s] * grg[c] * o[c] * (1.0f - o[c]) * nl;
    if (has_bg) {
      float dot = 0.0f;
      for (int c = 0; c < 12; ++c) dot += wt[s] * grg[3 + c] * o[3 + c];
      for (int c = 0; c < 12; ++c)
        gr[3 + c] = o[3 + c] * (wt[s] * grg[3 + c] - dot) * nl;
    } else {
      for (int c = 0; c < 12; ++c)
        gr[3 + c] = wt[s] * grg[3 + c] * o[3 + c] * (1.0f - o[3 + c]);
    }
    gr[15] = g_sig;
  }
}

// bf16 K5's second launch: the compositing forward alone, one block a ray,
// from the raw field that field_tc_kernel left in a.raw (the same routine
// as K2's and K6's first half, so the same arithmetic).
__global__ void __launch_bounds__(CTHREADS) composite_fwd_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  composite_fwd(a, reinterpret_cast<float*>(smem_raw), nullptr);
}

// ---------------------------------------------------------------------------
// 3. backward per tile
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS) bwd_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kx = kx_of(a), ndp = ndp_of(a), C = a.C, L = a.L, H = a.H, B = a.B;
  // gz buffers: gA the trunk's (and the rgb head's), gB the branches'
  T* gA = reinterpret_cast<T*>(smem_raw);
  T* gB = gA + H * TP;
  T* gskip = gB + B * TP;
  T* gd0a = gskip + H * TP;               // [gz_d0 (B) ; gz_alpha (8)]
  T* gs0 = gd0a + (B + 8) * TP;
  // transposed-product outputs span their padded widths (multiples of 8);
  // the last product, to the PE, reuses fout (launch checks pad8(kx) <= H)
  float* fout = reinterpret_cast<float*>(gs0 + B * TP);   // [H][TP]
  float* gxpe = fout;                                     // [pad8(kx)][TP]
  float* gdin = fout + H * TP;                            // [pad8(ndp + C)][TP]
  const T* wT = reinterpret_cast<const T*>(a.wT);
  const T* table = reinterpret_cast<const T*>(a.table);
  const long long tile = blockIdx.x, base = tile * TP;
  const T* acts = reinterpret_cast<const T*>(a.acts) + tile * a.act_stride;
  float* gzs = a.gzs + tile * a.gz_stride;
  const int* act_off = a.slots;
  const int* gz_off = a.slots + a.n_act;
  const int tid = threadIdx.x;
  auto bdesc = [&](int i) { return sahs::load_desc(a.metaT, i); };

  // head cotangents from the compositing backward: rgb (8 rows), seg (16),
  // alpha (8), each zero past its real width
  for (int i = tid; i < 32 * TP; i += blockDim.x) {
    const int j = i / TP, t = i % TP;
    const long long p = base + t;
    int c, slot, row;
    if (j < 8) { c = j < 3 ? j : -1; slot = L + 6; row = j; }
    else if (j < 24) { c = j - 8 < 12 ? 3 + j - 8 : -1; slot = L + 11; row = j - 8; }
    else { c = j == 24 ? 15 : -1; slot = L + 1; row = j - 24; }
    const float g = (c >= 0 && p < a.P) ? a.graw[p * 16 + c] : 0.0f;
    gzs[gz_off[slot] + row * TP + t] = g;
    if (j < 8) gA[row * TP + t] = sahs::from_f<T>(g);
    else if (j < 24) gB[row * TP + t] = sahs::from_f<T>(g);
    else gd0a[(B + row) * TP + t] = sahs::from_f<T>(g);
  }
  __syncthreads();
  // seg branch first (its head input sits in gB): segout^T, seg3..1
  sahs::mlp_layer<T>(bdesc(5), wT, a.bT, gB, nullptr, nullptr, nullptr, fout, TP);
  __syncthreads();
  for (int k = 3; k >= 0; --k) {
    T* dst = k == 0 ? gs0 : gB;
    sahs::dact_step<T>(fout, acts + act_off[L + 7 + k], sahs::ACT_LEAKY, B, TP,
                       gzs + gz_off[L + 7 + k], dst);
    __syncthreads();
    if (k > 0) {
      sahs::mlp_layer<T>(bdesc(9 - k), wT, a.bT, gB, nullptr, nullptr, nullptr,
                         fout, TP);
      __syncthreads();
    }
  }
  // direction branch: rgb^T, dir3..1, then dir0's [pe(dir) | se] block
  sahs::mlp_layer<T>(bdesc(0), wT, a.bT, gA, nullptr, nullptr, nullptr, fout, TP);
  __syncthreads();
  for (int k = 3; k >= 0; --k) {
    T* dst = k == 0 ? gd0a : gB;
    sahs::dact_step<T>(fout, acts + act_off[L + 3 + k], sahs::ACT_LEAKY, B, TP,
                       gzs + gz_off[L + 2 + k], dst);
    __syncthreads();
    if (k > 0) {
      sahs::mlp_layer<T>(bdesc(4 - k), wT, a.bT, gB, nullptr, nullptr, nullptr,
                         fout, TP);
      __syncthreads();
    }
  }
  sahs::mlp_layer<T>(bdesc(4), wT, a.bT, gd0a, nullptr, nullptr, nullptr, gdin, TP);
  // gfeat = gz_s0 Ws0^T + [gz_d0 ; gz_alpha] [Wd0f ; Wa]^T, feat linear
  sahs::mlp_layer<T>(bdesc(9), wT, a.bT, gs0, gd0a, nullptr, nullptr, fout, TP);
  __syncthreads();
  sahs::dact_step<T>(fout, acts + act_off[L + 1], sahs::ACT_LINEAR, H, TP,
                     gzs + gz_off[L], gA);
  __syncthreads();
  sahs::mlp_layer<T>(bdesc(10), wT, a.bT, gA, nullptr, nullptr, nullptr, fout, TP);
  __syncthreads();
  // trunk: each product has read gA before the next dact_step writes it
  T* g0 = gA;
  for (int l = L - 1; l >= 0; --l) {
    T* dst = (l == a.skip && l > 0) ? gskip : gA;
    sahs::dact_step<T>(fout, acts + act_off[1 + l], sahs::ACT_LEAKY, H, TP,
                       gzs + gz_off[l], dst);
    __syncthreads();
    if (l > 0) {
      sahs::mlp_layer<T>(bdesc(11 + (L - 1 - l)), wT, a.bT, dst, nullptr,
                         nullptr, nullptr, fout, TP);
      __syncthreads();
    } else {
      g0 = dst;
    }
  }
  // d(pe) = gz_0 W0^T + gz_skip Wskip_x^T
  const sahs::LayerDesc dpe = bdesc(10 + L);
  sahs::mlp_layer<T>(dpe, wT, a.bT, g0, dpe.w2 >= 0 ? gskip : nullptr, nullptr,
                     nullptr, gxpe, TP);
  __syncthreads();

  // per point: PE backward, corner dCoords (or K12's gextra), outputs
  float gxo[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  auto put_gx = [&](long long p) {
    for (int c = 0; c < a.PW; ++c) a.gx[p * a.PW + c] = gxo[c];
  };
  if (tid < TP) {
    const long long p = base + tid;
    if (p < a.P && (a.enc & ENC_PTS)) {   // the given encoding's cotangent
      for (int c = 0; c < kx; ++c) a.gx[p * kx + c] = gxpe[c * TP + tid];
    }
    if (p < a.P) {
      float x[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (!(a.enc & ENC_PTS)) {
        for (int c = 0; c < a.PW; ++c) x[c] = a.pts[p * a.PW + c];
        sahs::pe_group_bwd(x, 3, a.nf_xyz, gxpe, 0, tid, TP, gxo);
        sahs::pe_group_bwd(x + 3, a.amb, a.nf_amb, gxpe, 3 + 6 * a.nf_xyz, tid,
                           TP, gxo + 3);
      }
      if (a.mode == MODE_PTS) {
        if (a.enc & ENC_EXTRA) {   // the given [pe(dir) | se]'s cotangent
          for (int c = 0; c < C; ++c) a.gextra[p * C + c] = gdin[c * TP + tid];
        } else {
          // K12: gextra = [the direction's, through its PE | gse]
          const float* e = a.extra + p * (3 + C);
          float ge[3] = {0, 0, 0};
          sahs::pe_group_bwd(e, 3, a.nf_dir, gdin, 0, tid, TP, ge);
          float* go = a.gextra + p * (3 + C);
          for (int c = 0; c < 3; ++c) go[c] = ge[c];
          for (int c = 0; c < C; ++c) go[3 + c] = gdin[(ndp + c) * TP + tid];
        }
        if (!(a.enc & ENC_PTS)) put_gx(p);
      } else if (C == 0 || a.se != nullptr) {   // no trilinear sample: no dCoords
        put_gx(p);
        for (int c = 0; c < C; ++c) a.gse[p * C + c] = gdin[(ndp + c) * TP + tid];
      } else {
      float fr[3];
      const float okf = cell_fracs(x, a, fr);
      const T* crow = table + (size_t)a.rows[p] * 8 * C;
      const float* gs = gdin + ndp * TP + tid;
      float dfx = 0.0f, dfy = 0.0f, dfz = 0.0f;
      for (int s = 0; s < 8; ++s) {
        const int dz = (s >> 2) & 1, dy = (s >> 1) & 1, dx = s & 1;
        float gv = 0.0f;
        for (int c = 0; c < C; ++c) gv += gs[c * TP] * sahs::to_f(crow[s * C + c]);
        const float wz = dz ? fr[2] : 1.0f - fr[2];
        const float wy = dy ? fr[1] : 1.0f - fr[1];
        const float wx = dx ? fr[0] : 1.0f - fr[0];
        dfx += (dx ? 1.0f : -1.0f) * wz * wy * gv;
        dfy += (dy ? 1.0f : -1.0f) * wz * wx * gv;
        dfz += (dz ? 1.0f : -1.0f) * wy * wx * gv;
      }
      gxo[0] += dfx * okf * (0.5f * (a.gW - 1));
      gxo[1] += dfy * okf * (0.5f * (a.gH - 1));
      gxo[2] += dfz * okf * (0.5f * (a.gD - 1));
      put_gx(p);
      for (int c = 0; c < C; ++c) a.gse[p * C + c] = gs[c * TP];
      }
    }
  }
}

template <typename T>
size_t fwd_smem(const Args& a, int kx, int ndp) {
  return (size_t)(kx + ndp + a.C + 2 * a.H) * TP * sizeof(T) +
         (size_t)(8 + 8 + 16 + 8) * TP * sizeof(float) + TP * sizeof(int) + 64;
}

// float32 at the flagship's widths: 156,736 B, one block an SM
template <typename T>
size_t bwd_smem(const Args& a, int ndp) {
  return (size_t)(2 * a.H + 3 * a.B + 8) * TP * sizeof(T) +
         (size_t)(a.H + pad8(ndp + a.C)) * TP * sizeof(float) + 64;
}

template <typename T>
int launch(const Args& a, int n_work, int chunks, int out_len,
           const int* prods, const int* work, float* part, float* out,
           cudaStream_t stream) {
  const int kx = a.kx, ndp = a.ndp;
  const long long n_tiles = (a.P + TP - 1) / TP;
  if (pad8(kx) > a.H || a.B > a.H || a.B < 16) return (int)cudaErrorInvalidValue;
  const size_t sf = fwd_smem<T>(a, kx, ndp);
  const size_t sb = bwd_smem<T>(a, ndp);
  const size_t sc = (size_t)a.S * COMPOSITE_FLOATS * sizeof(float);
  int err = sahs::set_smem(fwd_kernel<T>, sf);
  if (!err) err = sahs::set_smem(bwd_kernel<T>, sb);
  if (!err) err = sahs::set_smem(composite_kernel, sc);
  if (err) return err;
  fwd_kernel<T><<<(unsigned)n_tiles, THREADS, sf, stream>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  if (a.mode == MODE_LOSS || a.mode == MODE_VJP) {
    composite_kernel<<<(unsigned)a.R, CTHREADS, sc, stream>>>(a);
    if ((err = (int)cudaGetLastError())) return err;
  }
  bwd_kernel<T><<<(unsigned)n_tiles, THREADS, sb, stream>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  return sahs::launch_dw<T>(reinterpret_cast<const T*>(a.acts), a.gzs,
                            a.act_stride, a.gz_stride, (int)n_tiles, TP,
                            prods, work, n_work, chunks, part, out, out_len,
                            stream);
}

// ---------------------------------------------------------------------------
// bf16: the same launches on the tensor cores, 64-point tiles: the forward
// and backward tiles on wgmma (wgmma.cuh), the dW on wgmma (level_dw.cuh)
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int TC_TP = 64;            // points a tile (a warpgroup's product rows, a stash block)
constexpr int TC_LDF = TC_TP + 4;    // row stride of a float32 tile in shared memory
static_assert(TC_TP == wg::ROWS, "a tile is one warpgroup product's rows");

__host__ __device__ __forceinline__ int imax(int x, int y) { return x > y ? x : y; }

// ---------------------------------------------------------------------------
// 1. forward per 64-point tile in bf16, on wgmma: field_tc_kernel (K5's raw
// field, K7, K11) and fwd_tc_kernel (launch 1 of K2, K6, K8, K12)
// ---------------------------------------------------------------------------
// What the tile computes: per point its inputs (the PE with the accurate
// sinf; the 8-corner trilinear sample with _cell_geometry's expression, a
// per-point se, C = 0, or MODE_PTS's [dir | se], each optionally given
// pre-encoded), the trunk with the skip input, feat, the alpha head, the
// direction branch [feat | pe(dir) | se] -> 4 x B -> rgb and the seg branch
// 4 x B -> 12; raw (P, 16) out when a.raw is given and, with STASH, every
// layer's bf16 input to the stash of the backward (slots as before).
//
// Design (csrc/wgmma.cuh). Persistent blocks, one an SM, of two consumer
// warpgroups and a producer warp. A warpgroup owns a 64-point tile (the
// stash's unit stays the 64-point tile, TC_TP) and runs every layer as
// wgmma.m64nNk16 products, A (the tile's activations, K-major, 128-byte
// swizzle) and B (the weights) both from shared memory. The weights stream
// through a ring of stages in shared memory: a stage is one 64-k block of
// one chunk of a layer's outputs (N <= 128 rows of 128 bytes, K-major and
// swizzled, laid out ahead of time by nerf_level.wgmma_blob in the order
// the tile runs them), copied by one TMA bulk copy; both warpgroups read
// each stage, so every weight byte read from L2 serves 128 points. Outputs
// of 256 columns (the trunk, feat) are two chunks of 128, so the float32
// sums of a chunk fit the registers twice over (PROMOTE below). The
// epilogue adds the bias, applies the activation and rounds to bf16 from
// the accumulator registers (the stash rows from there too, two points a
// 4-byte store) and stores the next layer's A: the first chunk of two into
// the other of two column-0-127 regions, the rest in place once every
// warp's products are done. The heads (N = 8, 16) write raw in f32.
// K is zero-padded to whole 64-k blocks: the stages' rows past K are zero
// and the tile's columns past K are zeroed, so a block's four k-steps need
// no branch. The front half (PE, the corner gather, per-point rows) writes
// straight into the swizzled A tiles; rows past P are zeros and nothing is
// written past P. The roles branch on wg::warpgroup() (uniform across a
// warp) and the arrivals are predicated, so ptxas keeps the wgmma
// pipelined (a divergent role branch serialises them: ptxas's C7520).
//
// Accumulation (PROMOTE, fw::field_product): FIELD_PROMOTE is the one
// the kernels run (PERF.md §6 has each candidate's distance from exact
// sums and time). The ring and its stages are wgmma.cuh's, shared with the
// deformation nets' tile (skip_wg.cuh); the products the kernels run are
// fw::field_product's, the candidates' wgmma.cuh's product.
//
// Bound on the H100: ~0.74 M multiply-adds a point against ~30 (K7) to
// ~224 (K11) bytes, so operations: K5 at a frame's fine chunk (4.19 M
// points) 6.2 ms, K11 at its 6.29 M 9.4 ms, K7 at a step's fine level
// (262,144) 0.39 ms at the 989 TFLOP/s bf16 peak. The weights (1.53 MB at
// the flagship's widths) are read from L2 once per 128 points, ~31 bytes a
// clock an SM at the tensor cores' rate, near what L2 gives.
namespace fw {

// ptxas gives a block of more than two warpgroups (288 threads count as
// three) at most 168 registers a thread; the sums of one 128-wide chunk,
// its partials and the epilogue fit them without a spill
constexpr int WG = 2;                                // consumer warpgroups
constexpr int THREADS = WG * wg::THREADS + 32;       // and the producer warp
using wg::KB;                                         // k rows of a weight stage
using wg::NC;                                         // output columns of a chunk
using wg::SLOT;                                       // bytes of a ring slot
using wg::ASrc;
using wg::Ring;
using wg::sts32;
constexpr int RING_MAX = 6;
constexpr int SMEM_MAX = 232448;                     // a block's dynamic shared memory
enum { SRC_NONE = 0, SRC_X, SRC_D, SRC_H, SRC_B };
enum { OUT_H = 0, OUT_B, OUT_ALPHA, OUT_RGB, OUT_SEG };

__host__ __device__ __forceinline__ int cdiv(int x, int y) { return (x + y - 1) / y; }

// One product of the tile (a layer of the forward blob): its inputs s1
// (k1 columns) and s2 (k2 columns, or none), n outputs, where they go, the
// activation (leaky ReLU or linear) and the stash slot of the output.
struct Prod {
  int s1, k1, s2, k2, n, out, leaky, slot;
};

// The products in the order the tile runs them and the weight stages
// hold them (nerf_level.point_layers' order): the trunk (the skip layer's
// second input the PE), feat, alpha, dir0 (feat and [pe(dir) | se]),
// dir1-3, rgb, seg0-3, the seg head.
__host__ __device__ __forceinline__ int n_prods(const Args& a) { return a.L + 12; }
__host__ __device__ __forceinline__ Prod prod_of(const Args& a, int q) {
  const int L = a.L, H = a.H, B = a.B, kd = a.ndp + a.C;
  if (q < L) {
    const bool skip = q == a.skip && q > 0;
    return Prod{q == 0 ? SRC_X : SRC_H, q == 0 ? a.kx : H, skip ? SRC_X : SRC_NONE,
                skip ? a.kx : 0, H, OUT_H, 1, 1 + q};
  }
  const int r = q - L;
  if (r == 0) return Prod{SRC_H, H, SRC_NONE, 0, H, OUT_H, 0, L + 1};       // feat
  if (r == 1) return Prod{SRC_H, H, SRC_NONE, 0, 8, OUT_ALPHA, 0, -1};      // alpha
  if (r == 2) return Prod{SRC_H, H, SRC_D, kd, B, OUT_B, 1, L + 3};         // dir0
  if (r < 6) return Prod{SRC_B, B, SRC_NONE, 0, B, OUT_B, 1, L + 1 + r};    // dir1-3
  if (r == 6) return Prod{SRC_B, B, SRC_NONE, 0, 8, OUT_RGB, 0, -1};        // rgb
  if (r == 7) return Prod{SRC_H, H, SRC_NONE, 0, B, OUT_B, 1, L + 7};       // seg0
  if (r < 11) return Prod{SRC_B, B, SRC_NONE, 0, B, OUT_B, 1, L + r};       // seg1-3
  return Prod{SRC_B, B, SRC_NONE, 0, 16, OUT_SEG, 0, -1};                   // seg head
}

__host__ __device__ __forceinline__ bool is_head(int out) { return out >= OUT_ALPHA; }
// chunks of a product's outputs: a head is one chunk of n (8 or 16); other
// outputs, n rounded up to 64, chunks of NC (the last may be 64)
__host__ __device__ __forceinline__ int n_chunks(const Prod& p) {
  return is_head(p.out) ? 1 : cdiv(p.n, NC);
}
__host__ __device__ __forceinline__ int chunk_cols(const Prod& p, int c) {
  if (is_head(p.out)) return p.n;
  const int w = cdiv(p.n, KB) * KB - c * NC;
  return w < NC ? w : NC;
}
__host__ __device__ __forceinline__ int k_blocks(int k) { return cdiv(k, KB); }

// Bytes of the weight stages of one tile: a stage per chunk, input and
// 64-k block, chunk_cols rows of 128 bytes.
inline long long blob_bytes(const Args& a) {
  long long s = 0;
  for (int q = 0; q < n_prods(a); ++q) {
    const Prod p = prod_of(a, q);
    for (int c = 0; c < n_chunks(p); ++c)
      s += 128LL * chunk_cols(p, c) * (k_blocks(p.k1) + k_blocks(p.k2));
  }
  return s;
}

// The forward blob's biases, every layer's n (padded) in the products'
// order (nerf_level.point_layers): (L + 1) H + 8 B + 32 floats.
__host__ __device__ __forceinline__ int bias_floats(const Args& a) {
  return (a.L + 1) * a.H + 8 * a.B + 32;
}

// Shared memory, from a 1,024-byte-aligned base: the ring of `ring` slots,
// then each warpgroup's regions of 64-column blocks (wg::BLOCK, 64 points x
// 128 bytes): x [xb] (the PE; the branches' activations after the trunk),
// d [db] ([pe(dir) | se]), h0 [2 x h0] (the hidden columns 0-127, in turns;
// the corner weights and rows during the front half) and h1 [h1] (columns
// 128 on); then the biases and the stash slots' offsets (read in every
// epilogue: from device memory each read would wait on L2, since shared
// memory leaves L1 little room), the barriers, and the slack that aligns
// the base.
struct Layout {
  int xb, db, h0, h1, per_wg, ring, bias, slots, bar, bytes;
  __host__ __device__ explicit Layout(const Args& a) {
    xb = imax(cdiv(a.kx, KB), cdiv(a.B, KB));
    db = imax(cdiv(a.ndp + a.C, KB), 1);
    const int hb = cdiv(a.H, KB);
    h0 = hb < 2 ? hb : 2;
    h1 = hb - h0;
    per_wg = (xb + db + 2 * h0 + h1) * wg::BLOCK;
    const int params = (bias_floats(a) + a.L + 12 + 3) / 4 * 16;
    const int fixed = WG * per_wg + params + 16 * RING_MAX + 1024;
    ring = (SMEM_MAX - fixed) / SLOT;
    if (ring > RING_MAX) ring = RING_MAX;
    bias = ring * SLOT + WG * per_wg;
    slots = bias + 4 * bias_floats(a);
    bar = bias + params;
    bytes = bar + 16 * RING_MAX + 1024;
  }
};

// d = A1 W1 (+ A2 W2) over one chunk of N outputs, one ring stage a 64-k
// block; called by the whole warpgroup. PROMOTE 1, what the kernels run,
// gives wgmma.cuh's product<N, 1>'s sums bit for bit: the same products
// (m64n64k16 pieces, or the head's width), each k16 step summed in the
// tensor core from zero and added to the float32 sums with round to
// nearest in k order. Only what waits on what differs. A chunk of 128
// outputs runs each k16 step as two 64-column halves into two
// accumulators in turn, one half in flight while the other's adds run,
// across the chunk's stages too (product<N, 1> drains both halves at the
// end of every stage); a chunk of 64 outputs does the same with whole
// steps. Every path reaches a stage loop's head with the same products in
// flight (the first stage peeled), so ptxas keeps the wgmma pipelined (a
// head reached with other groups in flight on other paths serialises
// them, C7514). A head (8 or 16 outputs) issues a stage's four k16 steps
// into four accumulators, waits once and adds them in order (product<N, 1>
// waits for each step before the next). Holding more live values (a chunk
// of 128 as full-width steps, two in flight; three or four halves in
// flight) needs ~190 registers a thread: ptxas spills them, also in a
// 384-thread block whose consumers take 232 registers (setmaxnreg), and
// the tile reads 1.7-5x slower (PERF.md §6, PR 27). The candidates
// (PROMOTE 0, 2, 4; tools/field_forms.py) run product.
template <int N, int PROMOTE>
__device__ __forceinline__ void field_product(float (&d)[N / 2], const ASrc& s1, const ASrc& s2,
                                              Ring& rg, int lane) {
  if constexpr (PROMOTE != 1) {
    wg::product<N, PROMOTE>(d, s1, s2, rg, lane);
    return;
  }
  constexpr int R = N / 2;
#pragma unroll
  for (int e = 0; e < R; ++e) d[e] = 0.0f;
  auto add = [&](float (&p)[R]) {
    wg::fence_operand(p);
#pragma unroll
    for (int e = 0; e < R; ++e) d[e] = __fadd_rn(d[e], p[e]);
  };
  const int nb = s1.nb + s2.nb;
  if constexpr (N <= 16) {
    float p[4][R];
    for (int b = 0; b < nb; ++b) {
      const uint32_t ab = b < s1.nb ? wg::a_block(s1, b) : wg::a_block(s2, b - s1.nb);
      wg::mbar_wait(&rg.full[rg.stage], rg.phase);
      const uint32_t wb = wg::smem_u32(rg.slots + rg.stage * SLOT);
#pragma unroll
      for (int j = 0; j < 4; ++j) wg::fence_operand(p[j]);
      wg::fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) wg::mma<N, 0>(p[j], wg::k_desc(ab, j), wg::k_desc(wb, j), 0);
      wg::commit();
      wg::wait<0>();
#pragma unroll
      for (int j = 0; j < 4; ++j) add(p[j]);
      wg::mbar_arrive(&rg.empty[rg.stage], lane == 0);
      rg.next();
    }
  } else if constexpr (N == NC) {
    constexpr int H = R / 2, NH = N / 2;   // a half: N / 2 columns
    float pa[H], pb[H];
    uint32_t ab, wb;
    auto stage = [&](int b) {
      ab = b < s1.nb ? wg::a_block(s1, b) : wg::a_block(s2, b - s1.nb);
      wg::mbar_wait(&rg.full[rg.stage], rg.phase);
      wb = wg::smem_u32(rg.slots + rg.stage * SLOT);
    };
    auto issue = [&](float (&p)[H], int j, int half) {
      wg::fence_operand(p);
      wg::fence();
      wg::mma<NH, 0>(p, wg::k_desc(ab, j), wg::k_desc(wb + half * NH * 128, j), 0);
      wg::commit();
    };
    auto addh = [&](float (&p)[H], int off) {
      wg::fence_operand(p);
#pragma unroll
      for (int e = 0; e < H; ++e) d[off + e] = __fadd_rn(d[off + e], p[e]);
    };
    // k16 steps 1-3 of a stage whose step 0's halves A and B are in flight
    // (wait<1>: every half but the newest is done); ends with step 3's
    // halves in flight
    auto steps = [&]() {
#pragma unroll
      for (int j = 1; j < 4; ++j) {
        wg::wait<1>(); addh(pa, 0); issue(pa, j, 0);
        wg::wait<1>(); addh(pb, H); issue(pb, j, 1);
      }
    };
    stage(0);
    issue(pa, 0, 0);
    issue(pb, 0, 1);
    for (int b = 0; b + 1 < nb; ++b) {
      steps();
      const int done = rg.stage;
      rg.next();
      stage(b + 1);
      wg::wait<1>(); addh(pa, 0); issue(pa, 0, 0);
      wg::wait<1>(); addh(pb, H);
      wg::mbar_arrive(&rg.empty[done], lane == 0);
      issue(pb, 0, 1);
    }
    steps();
    wg::wait<1>(); addh(pa, 0);
    wg::wait<0>(); addh(pb, H);
    wg::mbar_arrive(&rg.empty[rg.stage], lane == 0);
    rg.next();
  } else {
    static_assert(N == KB, "a chunk is 64 or 128 outputs");
    float p0[R], p1[R];
    uint32_t ab, wb;
    auto stage = [&](int b) {  // the stage of 64-k block b, once its weights are in
      ab = b < s1.nb ? wg::a_block(s1, b) : wg::a_block(s2, b - s1.nb);
      wg::mbar_wait(&rg.full[rg.stage], rg.phase);
      wb = wg::smem_u32(rg.slots + rg.stage * SLOT);
    };
    auto issue = [&](float (&p)[R], int j) {
      wg::fence_operand(p);
      wg::fence();
      wg::mma<N, 0>(p, wg::k_desc(ab, j), wg::k_desc(wb, j), 0);
      wg::commit();
    };
    // k16 steps 1-3 of a stage whose step 0 is in flight in p0; ends with
    // step 3 in flight in p1 (wait<1>: every step but the newest is done)
    auto steps = [&]() {
      issue(p1, 1);
      wg::wait<1>();
      add(p0);
      issue(p0, 2);
      wg::wait<1>();
      add(p1);
      issue(p1, 3);
      wg::wait<1>();
      add(p0);
    };
    stage(0);
    issue(p0, 0);
    for (int b = 0; b + 1 < nb; ++b) {
      steps();
      const int done = rg.stage;
      rg.next();
      stage(b + 1);
      issue(p0, 0);
      wg::wait<1>();
      add(p1);
      wg::mbar_arrive(&rg.empty[done], lane == 0);
    }
    steps();
    wg::wait<0>();
    add(p1);
    wg::mbar_arrive(&rg.empty[rg.stage], lane == 0);
    rg.next();
  }
}

__device__ __forceinline__ void put(unsigned char* X, int t, int col, float v) {
  *reinterpret_cast<bf16*>(X + wg::sw128(wg::ROWS, t, col)) = __float2bfloat16_rn(v);
}
__device__ __forceinline__ uint32_t get2(const unsigned char* X, int t, int col) {
  return *reinterpret_cast<const unsigned short*>(X + wg::sw128(wg::ROWS, t, col));
}

// The packed word h (columns n, n + 1 of point r) into the stash slot st (a
// row of TC_TP points per column): lanes l and l ^ 4 hold neighbouring
// points (`odd`: r is the second), so each keeps one column of the two and
// stores both points' values at once.
__device__ __forceinline__ void stash_pair(uint32_t h, bf16* st, int n, int r, bool odd, bool ok) {
  const uint32_t lo = h & 0xffffu, hi = h >> 16;
  const uint32_t got = (uint32_t)__shfl_xor_sync(0xffffffffu, (int)(odd ? lo : hi), 4);
  const uint32_t w = odd ? (got | (hi << 16)) : (lo | (got << 16));
  if (ok) *reinterpret_cast<uint32_t*>(st + (size_t)(odd ? n + 1 : n) * TC_TP + (odd ? r - 1 : r)) = w;
}

// act(d + b) in bf16, packed two columns a word into h (output columns
// col0 .. col0 + N - 1; with GUARD, zero from n_real on), and with `st`
// given into the stash slot (a row of TC_TP points per output column):
// lanes l and l ^ 4 hold neighbouring points, so each keeps one column of
// the two and stores both points' values at once. LEAKY: leaky ReLU as
// fmaxf(v, 0.01 v), the same value as mlp.cuh's select for every v (and
// -0, NaN); else linear. Only two warps a scheduler run an epilogue, so its
// instruction count is its time: the activation and the guard are compile-
// time.
template <int N, bool LEAKY, bool GUARD>
__device__ __forceinline__ void pack_chunk(const float (&d)[N / 2], uint32_t (&h)[N / 4],
                                           int col0, int n_real, const float* bias, bf16* st,
                                           int t) {
  const int l = t % 32, q = l % 4;
  const int r0 = 16 * (t / 32) + l / 4;
  const bool odd = (l >> 2) & 1;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int n = col0 + 8 * j + 2 * q;
    const bool ok = !GUARD || n < n_real;  // n_real even: n + 1 with n
    const float2 b = ok ? *reinterpret_cast<const float2*>(bias + n) : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float v0 = d[4 * j + 2 * i] + b.x, v1 = d[4 * j + 2 * i + 1] + b.y;
      if (LEAKY) {
        v0 = fmaxf(v0, 0.01f * v0);
        v1 = fmaxf(v1, 0.01f * v1);
      }
      const __nv_bfloat162 hv = __floats2bfloat162_rn(ok ? v0 : 0.0f, ok ? v1 : 0.0f);
      h[2 * j + i] = *reinterpret_cast<const uint32_t*>(&hv);
      if (st != nullptr) stash_pair(h[2 * j + i], st, n, r0 + 8 * i, odd, ok);
    }
  }
}

template <int N>
__device__ __forceinline__ void pack_chunk_as(const float (&d)[N / 2], uint32_t (&h)[N / 4],
                                              int col0, int n_real, const float* bias,
                                              bool leaky, bf16* st, int t) {
  const bool guard = col0 + N > n_real;
  if (leaky && !guard) pack_chunk<N, true, false>(d, h, col0, n_real, bias, st, t);
  else if (leaky) pack_chunk<N, true, true>(d, h, col0, n_real, bias, st, t);
  else if (!guard) pack_chunk<N, false, false>(d, h, col0, n_real, bias, st, t);
  else pack_chunk<N, false, true>(d, h, col0, n_real, bias, st, t);
}

// The packed words of pack_chunk into columns [0, N) of the K-major region
// at shared address `dst` (row r0's 16-byte chunk c at c ^ (r0 % 8)).
template <int N>
__device__ __forceinline__ void put_chunk(const uint32_t (&h)[N / 4], uint32_t dst, int t) {
  const int l = t % 32, q = l % 4;
  const int r0 = 16 * (t / 32) + l / 4, sw = r0 & 7;
  const uint32_t row = dst + r0 * 128 + 4 * q;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      sts32(row + i * 1024 + (j >> 3) * wg::BLOCK + (((j & 7) ^ sw) << 4), h[2 * j + i]);
}

// A head's f32 outputs d + b to raw (P, 16): alpha to channel 15, rgb to
// 0-2, the seg logits to 3-14.
template <int N>
__device__ __forceinline__ void store_raw(const float (&d)[N / 2], int out, const float* bias,
                                          float* raw, long long base, long long P, int t) {
  const int l = t % 32, q = l % 4;
  const int r0 = 16 * (t / 32) + l / 4;
  const int n_real = out == OUT_ALPHA ? 1 : out == OUT_RGB ? 3 : 12;
  const int ch0 = out == OUT_ALPHA ? 15 : out == OUT_RGB ? 0 : 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int n = 8 * j + 2 * q + c;
        const long long p = base + r0 + 8 * i;
        if (n < n_real && p < P) raw[p * 16 + ch0 + n] = d[4 * j + 2 * i + c] + bias[n];
      }
}

// Positional encoding of one coordinate group of point t (DIM
// coordinates, x[0 .. DIM)) into columns col0 .. of the K-major region X
// (mlp.cuh:pe_group's values and order). DIM is known at compile time, so
// x stays in registers.
template <int DIM>
__device__ __forceinline__ void pe_sw(const float* x, int nfreq, unsigned char* X, int col0,
                                      int t) {
  int col = col0;
#pragma unroll
  for (int d = 0; d < DIM; ++d) put(X, t, col++, x[d]);
  for (int f = 0; f < nfreq; ++f) {
    const float fr = ldexpf(1.0f, f);
#pragma unroll
    for (int d = 0; d < DIM; ++d) put(X, t, col++, sinf(__fmul_rn(x[d], fr)));
#pragma unroll
    for (int d = 0; d < DIM; ++d)
      put(X, t, col++, sinf(__fadd_rn(__fmul_rn(x[d], fr), SAHS_HALF_PI_F)));
  }
}

// Columns [0, dim) of the tile points' rows of src (row stride `stride`),
// rounded to bf16, into columns col0 .. of X (mlp.cuh:point_rows' values);
// zeros past P; neighbouring threads read neighbouring columns.
template <typename S>
__device__ __forceinline__ void rows_sw(const S* src, long long stride, long long base,
                                        long long P, int dim, unsigned char* X, int col0,
                                        int t) {
  for (int i = t; i < dim * TC_TP; i += wg::THREADS) {
    const int pt = i / dim, r = i - pt * dim;
    const long long p = base + pt;
    put(X, pt, col0 + r, p < P ? sahs::to_f(src[p * stride + r]) : 0.0f);
  }
}

__device__ __forceinline__ void zero_cols(unsigned char* X, int c0, int c1, int t) {
  for (int i = t; i < (c1 - c0) * TC_TP; i += wg::THREADS) put(X, i % TC_TP, c0 + i / TC_TP, 0.0f);
}

// Columns [0, n) of a region to rows [0, n) of a stash slot, 8 points (16
// bytes) a thread, lanes on neighbouring columns (their reads fall on
// different banks).
__device__ __forceinline__ void stash_region(const unsigned char* X, int n, bf16* st, int t) {
  const int n32 = (n + 31) / 32 * 32;
  for (int i = t; i < n32 * (TC_TP / 8); i += wg::THREADS) {
    const int col = i % n32, g = i / n32;
    if (col >= n) continue;
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = get2(X, 8 * g + 2 * k, col) | (get2(X, 8 * g + 2 * k + 1, col) << 16);
    *reinterpret_cast<uint4*>(st + (size_t)col * TC_TP + 8 * g) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The tile's inputs into x (the point's encoding) and d ([pe(dir) | se]),
// their K padding zeroed; `scratch` holds the corner weights and rows.
// Ends with the regions visible to wgmma.
__device__ __forceinline__ void front_half(const Args& a, const Layout& ly, unsigned char* X,
                                           unsigned char* D, unsigned char* scratch,
                                           long long base, int t, int bar) {
  const int kx = a.kx, ndp = a.ndp, C = a.C, kd = ndp + C;
  wg::bar_sync(bar, wg::THREADS);  // the last tile's products are done with every region
  zero_cols(X, kx, ly.xb * KB, t);
  zero_cols(D, kd, ly.db * KB, t);
  const bool per_point = a.mode == MODE_PTS;
  const bool xenc = a.enc & ENC_PTS, eenc = a.enc & ENC_EXTRA;
  const int pt = t % TC_TP;
  const long long p = base + pt;
  const bool valid = p < a.P;
  if (t < TC_TP) {
    if (!xenc) {
      float x[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) x[c] = valid && c < a.PW ? a.pts[p * a.PW + c] : 0.0f;
      pe_sw<3>(x, a.nf_xyz, X, 0, pt);
      const int c0 = 3 + 6 * a.nf_xyz;
      switch (a.amb) {  // PW <= 8
        case 1: pe_sw<1>(x + 3, a.nf_amb, X, c0, pt); break;
        case 2: pe_sw<2>(x + 3, a.nf_amb, X, c0, pt); break;
        case 3: pe_sw<3>(x + 3, a.nf_amb, X, c0, pt); break;
        case 4: pe_sw<4>(x + 3, a.nf_amb, X, c0, pt); break;
        case 5: pe_sw<5>(x + 3, a.nf_amb, X, c0, pt); break;
        default: break;
      }
    }
  } else if (!eenc) {
    float d[3] = {0, 0, 0};
    if (valid) {
      const float* dsrc = per_point ? a.extra + p * (3 + C) : a.dirs + p / a.S * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) d[c] = dsrc[c];
    }
    pe_sw<3>(d, a.nf_dir, D, 0, pt);
  }
  if (xenc)  // K11/K12 pre-encoded: the point's bf16 encoding is given
    rows_sw(reinterpret_cast<const bf16*>(a.pts), kx, base, a.P, kx, X, 0, t);
  if (per_point && eenc) {  // [pe(dir) | se] given in bf16
    rows_sw(reinterpret_cast<const bf16*>(a.extra), C, base, a.P, C, D, 0, t);
  } else if (per_point) {
    rows_sw(a.extra + 3, 3 + C, base, a.P, C, D, ndp, t);
  } else if (a.se != nullptr) {
    // the ray forms on a per-point spatial embedding, rounded to bf16 here
    rows_sw(a.se, C, base, a.P, C, D, ndp, t);
  } else if (C > 0) {
    float* cw = reinterpret_cast<float*>(scratch);  // [8][TC_TP]
    int* rowv = reinterpret_cast<int*>(cw + 8 * TC_TP);
    if (t < TC_TP) {
      float x[3] = {0, 0, 0};
      if (valid) {
#pragma unroll
        for (int c = 0; c < 3; ++c) x[c] = a.pts[p * a.PW + c];
      }
      float fr[3];
      const float okf = cell_fracs(x, a, fr);
      for (int dz = 0; dz < 2; ++dz) {
        const float wz = dz ? fr[2] : __fsub_rn(1.0f, fr[2]);
        for (int dy = 0; dy < 2; ++dy) {
          const float wy = dy ? fr[1] : __fsub_rn(1.0f, fr[1]);
          for (int dx = 0; dx < 2; ++dx) {
            const float wx = dx ? fr[0] : __fsub_rn(1.0f, fr[0]);
            cw[(dz * 4 + dy * 2 + dx) * TC_TP + pt] =
                __fmul_rn(__fmul_rn(__fmul_rn(wz, wy), wx), okf);
          }
        }
      }
      rowv[pt] = valid ? a.rows[p] : 0;
    }
    wg::bar_sync(bar, wg::THREADS);
    const bf16* table = reinterpret_cast<const bf16*>(a.table);
#pragma unroll 4
    for (int idx = t; idx < C * TC_TP; idx += wg::THREADS) {
      const int q = idx / C, c = idx % C;
      const bf16* row = table + (size_t)rowv[q] * 8 * C;
      float acc = 0.0f;
      for (int s8 = 0; s8 < 8; ++s8) {
        const float v = __fmul_rn(__bfloat162float(row[s8 * C + c]), cw[s8 * TC_TP + q]);
        acc = s8 == 0 ? v : __fadd_rn(acc, v);
      }
      put(D, q, ndp + c, acc);
    }
  }
  wg::fence_async();
  wg::bar_sync(bar, wg::THREADS);
}

template <bool STASH, int PROMOTE>
__device__ __forceinline__ void tile(const Args& a, unsigned char* smem) {
  const Layout ly(a);
  unsigned char* base = smem + ((1024 - (wg::smem_u32(smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + ly.bar);
  uint64_t* empty = full + RING_MAX;
  const int tid = threadIdx.x, g = wg::warpgroup(), lane = tid % 32;
  const long long n_tiles = (a.P + TC_TP - 1) / TC_TP;
  const long long pairs = (n_tiles + WG - 1) / WG;
  float* bias_s = reinterpret_cast<float*>(base + ly.bias);
  int* slots_s = reinterpret_cast<int*>(base + ly.slots);
  for (int i = tid; i < bias_floats(a); i += blockDim.x) bias_s[i] = a.b[i];
  if (STASH)
    for (int i = tid; i < a.L + 12; i += blockDim.x) slots_s[i] = a.slots[i];
  if (tid == 0) {
    for (int s = 0; s < ly.ring; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], 4 * WG);  // lane 0 of every consumer warp
    }
    wg::mbar_fence_init();
  }
  __syncthreads();
  Ring rg{base, full, empty, ly.ring, 0, 0u};

  if (g == WG) {  // the producer warp: one thread issues every weight stage
    if (lane == 0) {
      const unsigned char* src0 = reinterpret_cast<const unsigned char*>(a.wg);
      for (long long pr = blockIdx.x; pr < pairs; pr += gridDim.x) {
        const unsigned char* src = src0;
        for (int q = 0; q < n_prods(a); ++q) {
          const Prod p = prod_of(a, q);
          const int ns = k_blocks(p.k1) + k_blocks(p.k2);
          for (int c = 0; c < n_chunks(p); ++c) {
            const uint32_t bytes = 128u * chunk_cols(p, c);
            for (int s = 0; s < ns; ++s) {
              rg.push(src, bytes);
              src += bytes;
            }
          }
        }
      }
    }
    return;
  }

  // a consumer warpgroup
  const int t = tid % wg::THREADS, bar = 1 + g;
  unsigned char* X = base + ly.ring * SLOT + g * ly.per_wg;
  unsigned char* D = X + ly.xb * wg::BLOCK;
  unsigned char* const H0a = D + ly.db * wg::BLOCK;
  unsigned char* const H0b = H0a + ly.h0 * wg::BLOCK;
  unsigned char* const H1 = H0b + ly.h0 * wg::BLOCK;
  const int kd = a.ndp + a.C;
  bool cur = false;  // H0b (else H0a) holds the hidden columns 0-127
  for (long long pr = blockIdx.x; pr < pairs; pr += gridDim.x) {
    const long long ti = pr * WG + g, pbase = ti * TC_TP;
    // a warpgroup past the last tile runs on zeros and writes nothing
    bf16* acts = (STASH && ti < n_tiles)
                     ? reinterpret_cast<bf16*>(a.acts) + ti * a.act_stride : nullptr;
    front_half(a, ly, X, D, cur ? H0b : H0a, pbase, t, bar);
    if (acts != nullptr) {
      stash_region(X, a.kx, acts + slots_s[0], t);
      stash_region(D, kd, acts + slots_s[a.L + 2], t);
    }
    const float* bias = bias_s;  // each product's biases follow the last one's
    for (int q = 0; q < n_prods(a); ++q) {
      const Prod p = prod_of(a, q);
      auto src = [&](int kind, int k) {
        const uint32_t x = wg::smem_u32(X), dd = wg::smem_u32(D);
        const uint32_t h0 = wg::smem_u32(cur ? H0b : H0a), h1 = wg::smem_u32(H1);
        const uint32_t lo = kind == SRC_D ? dd : kind == SRC_H ? h0 : x;
        const uint32_t hi = kind == SRC_H ? h1 : lo + 2 * wg::BLOCK;
        return ASrc{lo, hi, kind == SRC_NONE ? 0 : k_blocks(k)};
      };
      const ASrc s1 = src(p.s1, p.k1), s2 = src(p.s2, p.k2);
      if (p.out == OUT_SEG) {
        float d[8];
        field_product<16, PROMOTE>(d, s1, s2, rg, lane);
        if (a.raw != nullptr) store_raw<16>(d, p.out, bias, a.raw, pbase, a.P, t);
      } else if (is_head(p.out)) {
        float d[4];
        field_product<8, PROMOTE>(d, s1, s2, rg, lane);
        if (a.raw != nullptr) store_raw<8>(d, p.out, bias, a.raw, pbase, a.P, t);
      } else {
        bf16* st = acts != nullptr ? acts + slots_s[p.slot] : nullptr;
        for (int c = 0; c < n_chunks(p); ++c) {
          // the first chunk of a hidden layer goes to the other region; the
          // rest overwrite what every warp's products read
          const uint32_t dst = wg::smem_u32(p.out == OUT_B ? X : c > 0 ? H1 : cur ? H0a : H0b);
          const bool in_place = !(p.out == OUT_H && c == 0);
          uint32_t h[NC / 4];
          if (chunk_cols(p, c) == NC) {
            float d[NC / 2];
            field_product<NC, PROMOTE>(d, s1, s2, rg, lane);
            pack_chunk_as<NC>(d, h, c * NC, p.n, bias, p.leaky, st, t);
            if (in_place) wg::bar_sync(bar, wg::THREADS);
            put_chunk<NC>(h, dst, t);
          } else {
            uint32_t(&hk)[KB / 4] = reinterpret_cast<uint32_t(&)[KB / 4]>(h);
            float d[KB / 2];
            field_product<KB, PROMOTE>(d, s1, s2, rg, lane);
            pack_chunk_as<KB>(d, hk, c * NC, p.n, bias, p.leaky, st, t);
            if (in_place) wg::bar_sync(bar, wg::THREADS);
            put_chunk<KB>(hk, dst, t);
          }
        }
        if (p.out == OUT_H) cur = !cur;
        wg::fence_async();
        wg::bar_sync(bar, wg::THREADS);
      }
      bias += p.n;
    }
  }
}

}  // namespace fw

// The accumulation form the kernels run (fw::product's PROMOTE): k16 steps
// summed in the tensor core before each float32 add, 0 for the whole K.
// Measured on an H100 (PERF.md §6; tools/field_forms.py, the card suite):
// K5's field at a frame's fine chunk 16.1 ms carried over K, 18.7 every 4
// steps, 21.1 every 2, 23.9 every step (pipelined in two halves); all keep
// the exact-sum rule on the K7 draws of tools/field_forms, but the card
// suite's gates fail 17 times carried, 4 times every 4 steps and 3 times
// every 2 (cases without a background: K5's rgb 4.6x and 6.9x, K2's gse
// 10.8x the plain version's distance from exact sums), so the kernels run
// every step apart (wgmma.cuh's PROMOTE 1).
// The candidates stay instantiated for field_tc_kernel (sahs_nerf_field_tc's
// `promote`) so that the smoke run and tools/field_forms print them.
constexpr int FIELD_PROMOTE = 1;

// launch 1 of the backward: the forward tile with the stash
__global__ void __launch_bounds__(fw::THREADS, 1) fwd_tc_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(1024) unsigned char fw_smem[];
  fw::tile<true, FIELD_PROMOTE>(a, fw_smem);
}

// K7 and K11 in bf16, and K5's raw field: the forward tile alone, raw (P,
// 16) out.
//
// Replaces sahs_tpu/ops/pallas/field_mlp.py:nerf_rayd_forward (:1973,
// pallas_call at :2040; K7, the reuse path's raw field) and
// nerf_mlp_forward_fused (:3204, pallas_call at :3246; K11, the per-point
// branch's field) in bf16; float32 keeps their SIMT kernels (nerf_level.cu
// RAW, nerf_mlp.cu). Weights: the stages of nerf_level.wgmma_blob, laid out
// from the forward blob that K8 and K12 read (nerf_level.point_blob), so a
// forward and its backward read the same bytes. Design, bound and
// accumulation: fw above. ptxas: fwd_tc_kernel 155 registers,
// field_tc_kernel<1> 154 (of the 168 that 288 threads allow), no spill, a
// 32-byte stack frame (sinf's reduction of huge angles), no C7520 or C7514
// (the carried candidate <0> 168, 4 B spilled), 227,632 B of dynamic
// shared memory at the flagship's widths (a 4-stage ring). Measured on an
// H100 (PERF.md §6, tools/level_ab.py in turns with the parent's
// wgmma.cuh products): K5 at a frame's fine chunk 22.7 ms (23.9), K7 at a
// step's fine level 1.55 (1.60), K11 at the per-point frame's chunk 32.4
// (34.0), ~250-290 TFLOP/s, 25-29 % of the bound; launch 1 of K2 2.29 ms at
// a step's fine level (2.34). What holds it: each k16 step's float32 adds
// (the field alone: 22.3 ms every step, 15.9 carried over K, 18.6 every 4
// steps) and, in an earlier build with a heavier epilogue, cutting the
// epilogue out read 7.5 ms and the front half (PE, corner gather) 4 ms
// less. A 384-thread block whose producer warpgroup gives its registers to
// the consumers (setmaxnreg 40 / 232) did not help: every product form
// that needed the registers spilled, and the two-halves form read ~2 %
// slower in it than in this block.
template <int PROMOTE>
__global__ void __launch_bounds__(fw::THREADS, 1) field_tc_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(1024) unsigned char fw_smem[];
  fw::tile<false, PROMOTE>(a, fw_smem);
}

// ---------------------------------------------------------------------------
// 3. backward per 64-point tile in bf16, on wgmma: bwd_tc_kernel (launch 3
// of K2, K6, K8, K12)
// ---------------------------------------------------------------------------
// What the tile computes (as the float32 bwd_tile, with bf16 products and
// float32 sums): from the heads' cotangents (graw's channels: rgb 0-2, seg
// 3-14, alpha 15) the transposed products of the direction branch (rgb^T,
// dir3^T .. dir1^T), dir0's [pe(dir) | se] block, used at once per point
// (gse and the corner dCoords from _cell_geometry's exact expression, or
// K12's gextra through the direction's PE backward, or the given
// encodings' cotangents), the seg branch (the seg head^T, seg3^T ..
// seg1^T), gfeat = gz_s0 Ws0^T + gz_d0 Wd0f^T + the alpha head's rank-1
// term round_bf16(gz_alpha) Wa^T in the epilogue (feat is linear), feat^T
// and the trunk L-1 .. 1, the skip layer's input rows taking the PE
// cotangent as soon as gz_skip exists and trunk[0]^T adding to it, and the
// PE backward with the accurate sinf (no fast math). Each product's
// epilogue applies the activation's derivative, gz = ga * leaky'(y) with y
// the layer's stashed output, and writes gz in bf16 to the gz stash (the
// dW rounds it anyway) and to the next product's A tile, and the float32
// gz's column sums over the tile's points (db's per-tile partials, bsum).
//
// Design (wgmma.cuh, as fw::tile). Persistent blocks, one an SM, of two
// consumer warpgroups and a producer warp; a warpgroup owns a 64-point tile
// (the stashes' unit, TC_TP) and runs every transposed layer as
// wgmma.m64nNk16 products, A (the tile's gz, K-major, 128-byte swizzle)
// and B (the transposed weights) from shared memory. The weights stream
// through the ring as stages laid out ahead of time in the order the tile
// runs its products (level_train.backward_stages, from the plan's
// transposed blob); outputs of 256 columns are two chunks of 128. The
// stashed outputs y that an epilogue's derivative reads ride the same ring:
// after a chunk's weight stages the producer copies each warpgroup's y rows
// (the chunk's 128 columns x 64 points, a TMA box of the activation stash
// in the 128-byte swizzle) into a slot of its own, so the epilogue reads y
// from shared memory, never element by element from device memory. The
// gz of a layer goes to the other of two column-0-127 regions (R0, R1) and,
// from column 128 on, in place (R2) once every warp's products are done;
// the branches run in R0/R1 and keep gz_d0 in R2 until gfeat. The column
// sums fold the tile's 64 points in registers (a butterfly over the 8
// lanes of a column, then the 4 warps in order), so they are deterministic.
// Replaces the backward half of the TPU kernels of K2, K6, K8 and K12 (the
// head of this file names them), with the dW in level_dw.cuh. Bound on the
// H100: operations, ~0.74 M multiply-adds a point (K2's launch 3 at a
// step's fine level 0.39 ms at the 989 TFLOP/s bf16 peak); the gz stash it
// writes (1.76 GB there) ~0.53 ms at 3.35 TB/s. Measured on an H100
// (PERF.md §6, tools/level_ab.py in turns with the warp-level tensor-core
// tile it replaced): K2's
// launch 3 at a step's fine level 4.34 ms (6.47), 9 % of the bound; ptxas
// 168 registers (the cap of a 288-thread block), 340 bytes spilled.
namespace bw {

using fw::cdiv;
using fw::k_blocks;
using wg::KB;
using wg::NC;
using wg::SLOT;
using wg::ASrc;
using wg::Ring;
using wg::product;

constexpr int WG = 2;                                // consumer warpgroups
constexpr int THREADS = WG * wg::THREADS + 32;       // and the producer warp
constexpr int RING_MAX = 8;
constexpr int SMEM_MAX = 232448;                     // a block's dynamic shared memory
constexpr int PROMOTE = 1;                           // every k16 step apart, as fw::
constexpr uint32_t YBYTES = NC * 128;                // a y stage: 128 columns x 64 points
// a product's regions: R0, R1, R2 of the warpgroup; RH the hidden gz
// (columns 0-127 in R0 or R1, in turns, 128 on in R2)
enum { R0 = 0, R1, R2, RH };
enum { OUT_GZ = 0, OUT_F, OUT_FADD };

struct Prod {
  int k1, k2, n;   // the inputs' K (k2 0: one input) and the outputs (padded to 8)
  int s1, s2;      // the inputs' regions
  int out, dst;    // OUT_*; for OUT_GZ the region of the first chunk
  int y, gz;       // the activation slot of the derivative (-1: linear) and the gz slot
  int rank1;       // the alpha head's rank-1 term (gfeat)
};

__host__ __device__ __forceinline__ bool has_skip(const Args& a) {
  return a.skip > 0 && a.skip < a.L;
}
__host__ __device__ __forceinline__ int n_prods(const Args& a) {
  return a.L + 11 + (has_skip(a) ? 1 : 0);
}

// The products in the order the tile runs them and its weight stages hold
// them (level_train.backward_order): rgb^T, dir3^T .. dir1^T (transposed
// layers 0-3), dir0's [pe(dir) | se] block (4), the seg head^T, seg3^T ..
// seg1^T (5-8), gfeat (9: seg0^T on gz_s0 and dir0's feat block^T on
// gz_d0), feat^T (10), the trunk L-1 .. 1 (11 ..) with the PE layer's
// second input (the skip layer's input rows) before trunk[skip]^T, and the
// PE layer's first (trunk[0]^T).
__host__ __device__ __forceinline__ Prod prod_of(const Args& a, int q) {
  const int L = a.L, H = a.H, B = a.B;
  const int nx = pad8(a.kx), nd = pad8(a.ndp + a.C);
  if (q < 4)  // gz_d3 .. gz_d0, the last kept in R2
    return Prod{q == 0 ? 3 : B, 0, B, q % 2 ? R1 : R0, -1, OUT_GZ,
                q == 3 ? R2 : q % 2 ? R0 : R1, L + 6 - q, L + 5 - q, 0};
  if (q == 4) return Prod{B, 0, nd, R2, -1, OUT_F, 0, -1, -1, 0};
  if (q < 9) {  // gz_s3 .. gz_s0, the last in R0
    const int r = q - 5;
    return Prod{r == 0 ? 12 : B, 0, B, r % 2 ? R1 : R0, -1, OUT_GZ, r % 2 ? R0 : R1,
                L + 10 - r, L + 10 - r, 0};
  }
  if (q == 9) return Prod{B, B, H, R0, R2, OUT_GZ, R1, -1, L, 1};
  if (q == 10) return Prod{H, 0, H, RH, -1, OUT_GZ, RH, L, L - 1, 0};
  const int j = q - 11, fs = has_skip(a) ? L - 1 - a.skip : -1;
  if (j == fs) return Prod{H, 0, nx, RH, -1, OUT_F, 0, -1, -1, 0};
  if (j == L - 1 + (fs >= 0 ? 1 : 0))
    return Prod{H, 0, nx, RH, -1, fs >= 0 ? OUT_FADD : OUT_F, 0, -1, -1, 0};
  const int l = L - 1 - j + (fs >= 0 && j > fs ? 1 : 0);
  return Prod{H, 0, H, RH, -1, OUT_GZ, RH, l, l - 1, 0};
}

// chunks of n outputs: n rounded up to 64, chunks of NC (the last may be 64)
__host__ __device__ __forceinline__ int n_chunks(int n) { return cdiv(n, NC); }
__host__ __device__ __forceinline__ int chunk_cols(int n, int c) {
  const int w = cdiv(n, KB) * KB - c * NC;
  return w < NC ? w : NC;
}

// Bytes of the weight stages of one tile: a stage per chunk, input and
// 64-k block, chunk_cols rows of 128 bytes.
inline long long blob_bytes(const Args& a) {
  long long s = 0;
  for (int q = 0; q < n_prods(a); ++q) {
    const Prod p = prod_of(a, q);
    for (int c = 0; c < n_chunks(p.n); ++c)
      s += 128LL * chunk_cols(p.n, c) * (k_blocks(p.k1) + k_blocks(p.k2));
  }
  return s;
}

// Shared memory, from a 1,024-byte-aligned base: the ring of `ring` slots,
// then each warpgroup's regions of 64-column blocks (wg::BLOCK): R0 and R1
// [r01] and R2 [r2]; its float32 F [nf rows x TC_LDF] (the [pe(dir) | se]
// cotangent, then the PE's), the column sums [2 x 4 warps x NC], gz_alpha
// [TC_TP] and the corner dCoords [3 x TC_TP], padded to 1,024 bytes; then
// the alpha head's row of gfeat (H bf16) and the stash slots' offsets, the
// barriers, and the slack that aligns the base.
struct Layout {
  int r01, r2, nf, f, per_wg, ring, alpha, slots, bar, bytes;
  __host__ __device__ explicit Layout(const Args& a) {
    const int hb = cdiv(a.H, KB), bb = cdiv(a.B, KB), h0 = hb < 2 ? hb : 2;
    r01 = imax(h0, bb);
    r2 = imax(hb - h0, bb);
    nf = imax(pad8(a.kx), pad8(a.ndp + a.C));
    f = (2 * r01 + r2) * wg::BLOCK;
    per_wg = (f + nf * TC_LDF * 4 + (2 * 4 * NC + 4 * TC_TP) * 4 + 1023) / 1024 * 1024;
    const int params = (2 * a.H + 4 * (a.n_act + a.L + 12) + 15) / 16 * 16;
    const int fixed = WG * per_wg + params + 16 * RING_MAX + 1024;
    ring = (SMEM_MAX - fixed) / SLOT;
    if (ring > RING_MAX) ring = RING_MAX;
    alpha = ring * SLOT + WG * per_wg;
    slots = alpha + 2 * a.H;
    bar = alpha + params;
    bytes = bar + 16 * RING_MAX + 1024;
  }
};

// The epilogue of a gz product: v = d (+ round_bf16(rx[point]) rw[n], the
// rank-1 term) (* leaky'(y), y the stashed output in the y stage Y: column
// n's 64 points a 128-byte row, swizzled), zero from n_real on, as the
// float32 tile's dact_step (train.cuh) forms it: gz packed two columns a word into h, and the
// float32 gz's sums over this thread's two points of each column into s
// (s[2 j + c], column 8 j + 2 (l % 4) + c).
template <int N, bool LEAKY, bool RANK1>
__device__ __forceinline__ void dact_chunk(const float (&d)[N / 2], uint32_t (&h)[N / 4],
                                           float (&s)[N / 4], int col0, int n_real,
                                           const unsigned char* Y, const float* rx,
                                           const bf16* rw, int t) {
  const int l = t % 32, q = l % 4;
  const int r0 = 16 * (t / 32) + l / 4;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int nl = 8 * j + 2 * q;
    const bool ok = col0 + nl < n_real;  // n_real even: nl + 1 with nl
    float2 w = make_float2(0.0f, 0.0f);
    if (RANK1) w = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(rw + col0 + nl));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      float v0 = d[4 * j + 2 * i], v1 = d[4 * j + 2 * i + 1];
      if (RANK1) {
        const float x = __bfloat162float(__float2bfloat16_rn(rx[r]));
        v0 = fmaf(x, w.x, v0);
        v1 = fmaf(x, w.y, v1);
      }
      if (LEAKY) {
        const float y0 = __bfloat162float(*reinterpret_cast<const bf16*>(Y + wg::sw128(wg::ROWS, nl, r)));
        const float y1 = __bfloat162float(*reinterpret_cast<const bf16*>(Y + wg::sw128(wg::ROWS, nl + 1, r)));
        v0 = v0 * (y0 > 0.0f ? 1.0f : 0.01f);
        v1 = v1 * (y1 > 0.0f ? 1.0f : 0.01f);
      }
      if (!ok) {
        v0 = 0.0f;
        v1 = 0.0f;
      }
      s[2 * j] = i == 0 ? v0 : s[2 * j] + v0;
      s[2 * j + 1] = i == 0 ? v1 : s[2 * j + 1] + v1;
      const __nv_bfloat162 hv = __floats2bfloat162_rn(v0, v1);
      h[2 * j + i] = *reinterpret_cast<const uint32_t*>(&hv);
    }
  }
}

// h into the gz stash slot st (row col0 + the chunk's column, a row of TC_TP
// points each)
template <int N>
__device__ __forceinline__ void stash_chunk(const uint32_t (&h)[N / 4], bf16* st, int col0,
                                            int n_real, int t) {
  const int l = t % 32, q = l % 4;
  const int r0 = 16 * (t / 32) + l / 4;
  const bool odd = (l >> 2) & 1;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = col0 + 8 * j + 2 * q;
      fw::stash_pair(h[2 * j + i], st, n, r0 + 8 * i, odd, n < n_real);
    }
}

using wg::col_sums;

// A float32 product's outputs into F (n rows x TC_LDF), columns col0 ..
// below n_real, added to what F holds with `add`.
template <int N>
__device__ __forceinline__ void store_f(const float (&d)[N / 2], float* F, int col0, int n_real,
                                        bool add, int t) {
  const int l = t % 32, q = l % 4;
  const int r0 = 16 * (t / 32) + l / 4;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int n = col0 + 8 * j + 2 * q + c;
        if (n < n_real) {
          float* o = F + n * TC_LDF + r0 + 8 * i;
          *o = add ? *o + d[4 * j + 2 * i + c] : d[4 * j + 2 * i + c];
        }
      }
}

// A head's gz (graw's channels ch0 .. ch0 + n_real - 1) as the K-major A
// tile X, columns 0-63, zero past n_real and past P.
__device__ __forceinline__ void head_tile(const Args& a, unsigned char* X, int ch0, int n_real,
                                          long long pbase, int t) {
  for (int i = t; i < KB * TC_TP; i += wg::THREADS) {
    const int col = i / TC_TP, pt = i % TC_TP;
    const long long p = pbase + pt;
    fw::put(X, pt, col, col < n_real && p < a.P ? a.graw[p * 16 + ch0 + col] : 0.0f);
  }
}

// The heads' gz from graw (rgb 8 rows, seg 16, alpha 8 in the stash, zero
// past 3, 12, 1): to the gz stash in bf16, their column sums to bsum (each
// a sum over the tile's points in order), alpha's f32 gz to rx.
__device__ __forceinline__ void heads(const Args& a, bf16* gzt, float* bst, float* rx,
                                      const int* slots, long long pbase, int t) {
  const int L = a.L;
  auto head = [&](int j, int& slot, int& row) {
    if (j < 8) { slot = L + 6; row = j; return j < 3 ? j : -1; }
    if (j < 24) { slot = L + 11; row = j - 8; return row < 12 ? 3 + row : -1; }
    slot = L + 1; row = j - 24;
    return row == 0 ? 15 : -1;
  };
  for (int i = t; i < 32 * TC_TP; i += wg::THREADS) {
    const int j = i / TC_TP, pt = i % TC_TP;
    const long long p = pbase + pt;
    int slot, row;
    const int c = head(j, slot, row);
    const float g = (c >= 0 && p < a.P) ? a.graw[p * 16 + c] : 0.0f;
    if (gzt != nullptr) gzt[slots[a.n_act + slot] + row * TC_TP + pt] = __float2bfloat16_rn(g);
    if (j == 24) rx[pt] = g;
  }
  if (bst != nullptr && t < 32) {
    int slot, row;
    const int c = head(t, slot, row);
    float s = 0.0f;
    for (int pt = 0; pt < TC_TP; ++pt) {
      const long long p = pbase + pt;
      s += (c >= 0 && p < a.P) ? a.graw[p * 16 + c] : 0.0f;
    }
    bst[slots[a.n_act + slot] / TC_TP + row] = s;
  }
}

// After dir0's [pe(dir) | se] product, per point (t < TC_TP): K12's gextra
// (the direction's through its PE backward, and gse; or the given
// encoding's), or gse, with the corner dCoords into gco [3][TC_TP].
__device__ __forceinline__ void dir_points(const Args& a, const float* F, float* gco,
                                           long long pbase, int t) {
  const int ndp = a.ndp, C = a.C;
  const long long p = pbase + t;
  if (t >= TC_TP || p >= a.P) return;
  if (a.mode == MODE_PTS && (a.enc & ENC_EXTRA)) {
    for (int c = 0; c < C; ++c) a.gextra[p * C + c] = F[c * TC_LDF + t];
  } else if (a.mode == MODE_PTS) {
    const float* e = a.extra + p * (3 + C);
    float ge[3] = {0, 0, 0};
    sahs::pe_group_bwd(e, 3, a.nf_dir, F, 0, t, TC_LDF, ge);
    float* go = a.gextra + p * (3 + C);
    for (int c = 0; c < 3; ++c) go[c] = ge[c];
    for (int c = 0; c < C; ++c) go[3 + c] = F[(ndp + c) * TC_LDF + t];
  } else if (a.se != nullptr) {
    for (int c = 0; c < C; ++c) a.gse[p * C + c] = F[(ndp + c) * TC_LDF + t];
  } else if (C > 0) {
    float x[3];
    for (int c = 0; c < 3; ++c) x[c] = a.pts[p * a.PW + c];
    float fr[3];
    const float okf = cell_fracs(x, a, fr);
    const bf16* crow = reinterpret_cast<const bf16*>(a.table) + (size_t)a.rows[p] * 8 * C;
    const float* gs = F + ndp * TC_LDF + t;
    float dfx = 0.0f, dfy = 0.0f, dfz = 0.0f;
    for (int s = 0; s < 8; ++s) {
      const int dz = (s >> 2) & 1, dy = (s >> 1) & 1, dx = s & 1;
      float gv = 0.0f;
      for (int c = 0; c < C; ++c) gv += gs[c * TC_LDF] * __bfloat162float(crow[s * C + c]);
      const float wz = dz ? fr[2] : 1.0f - fr[2];
      const float wy = dy ? fr[1] : 1.0f - fr[1];
      const float wx = dx ? fr[0] : 1.0f - fr[0];
      dfx += (dx ? 1.0f : -1.0f) * wz * wy * gv;
      dfy += (dy ? 1.0f : -1.0f) * wz * wx * gv;
      dfz += (dz ? 1.0f : -1.0f) * wy * wx * gv;
    }
    gco[t] = dfx * okf * (0.5f * (a.gW - 1));
    gco[TC_TP + t] = dfy * okf * (0.5f * (a.gH - 1));
    gco[2 * TC_TP + t] = dfz * okf * (0.5f * (a.gD - 1));
    for (int c = 0; c < C; ++c) a.gse[p * C + c] = gs[c * TC_LDF];
  }
}

// At the end, per point (t < TC_TP): the PE backward plus the corner
// dCoords to gx, or the given encoding's cotangent.
__device__ __forceinline__ void pe_points(const Args& a, const float* F, const float* gco,
                                          long long pbase, int t) {
  const long long p = pbase + t;
  if (t >= TC_TP || p >= a.P) return;
  if (a.enc & ENC_PTS) {
    for (int c = 0; c < a.kx; ++c) a.gx[p * a.kx + c] = F[c * TC_LDF + t];
    return;
  }
  float x[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int c = 0; c < a.PW; ++c) x[c] = a.pts[p * a.PW + c];
  float gxo[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  sahs::pe_group_bwd(x, 3, a.nf_xyz, F, 0, t, TC_LDF, gxo);
  sahs::pe_group_bwd(x + 3, a.amb, a.nf_amb, F, 3 + 6 * a.nf_xyz, t, TC_LDF, gxo + 3);
  for (int c = 0; c < 3; ++c) gxo[c] += gco[c * TC_TP + t];
  for (int c = 0; c < a.PW; ++c) a.gx[p * a.PW + c] = gxo[c];
}

// One N-wide chunk of a gz product, after its products: the derivative
// from the y stage Y (null for a linear layer), the stash, the column sums
// into cs [4 warps][NC], then (every warp's products done) the chunk into
// the A tile at `dst` and the sums of the 4 warps, in order, to bs.
template <int N>
__device__ __forceinline__ void gz_chunk(const float (&d)[N / 2], const Prod& p, int col0,
                                         const unsigned char* Y, const float* rx,
                                         const bf16* rw, bf16* st, float* cs, float* bs,
                                         uint32_t dst, int bar, int t) {
  uint32_t h[N / 4];
  float s[N / 4];
  if (p.rank1) dact_chunk<N, false, true>(d, h, s, col0, p.n, Y, rx, rw, t);
  else if (Y != nullptr) dact_chunk<N, true, false>(d, h, s, col0, p.n, Y, rx, rw, t);
  else dact_chunk<N, false, false>(d, h, s, col0, p.n, Y, rx, rw, t);
  col_sums<N>(s, cs + (t / 32) * NC, t);
  if (st != nullptr) stash_chunk<N>(h, st, col0, p.n, t);
  wg::bar_sync(bar, wg::THREADS);
  fw::put_chunk<N>(h, dst, t);
  if (bs != nullptr && t < N && col0 + t < p.n)
    bs[col0 + t] = ((cs[t] + cs[NC + t]) + cs[2 * NC + t]) + cs[3 * NC + t];
}

__device__ __forceinline__ void tile(const Args& a, const CUtensorMap* ymap, unsigned char* smem) {
  const Layout ly(a);
  unsigned char* base = smem + ((1024 - (wg::smem_u32(smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + ly.bar);
  uint64_t* empty = full + RING_MAX;
  const int tid = threadIdx.x, g = wg::warpgroup(), lane = tid % 32;
  const long long n_tiles = (a.P + TC_TP - 1) / TC_TP;
  const long long pairs = (n_tiles + WG - 1) / WG;
  bf16* alpha_s = reinterpret_cast<bf16*>(base + ly.alpha);
  int* slots_s = reinterpret_cast<int*>(base + ly.slots);
  {
    // gfeat's second input is [dir0's feat block ; alpha]: its last row,
    // the alpha head's, is the epilogue's rank-1 term
    const sahs::LayerDesc d9 = sahs::load_desc(a.metaT, 9);
    const bf16* wa = reinterpret_cast<const bf16*>(a.wT) + d9.w2 + (size_t)a.B * d9.n;
    for (int i = tid; i < a.H; i += blockDim.x) alpha_s[i] = wa[i];
    for (int i = tid; i < a.n_act + a.L + 12; i += blockDim.x) slots_s[i] = a.slots[i];
  }
  if (tid == 0) {
    for (int s = 0; s < ly.ring; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], 4 * WG);  // lane 0 of every consumer warp
    }
    wg::mbar_fence_init();
  }
  __syncthreads();
  Ring rg{base, full, empty, ly.ring, 0, 0u};

  if (g == WG) {  // the producer warp: one thread copies every stage
    if (lane == 0) {
      for (long long pr = blockIdx.x; pr < pairs; pr += gridDim.x) {
        const unsigned char* src = reinterpret_cast<const unsigned char*>(a.wgb);
        for (int q = 0; q < n_prods(a); ++q) {
          const Prod p = prod_of(a, q);
          const int ns = k_blocks(p.k1) + k_blocks(p.k2);
          for (int c = 0; c < n_chunks(p.n); ++c) {
            const uint32_t bytes = 128u * chunk_cols(p.n, c);
            for (int s = 0; s < ns; ++s) {
              rg.push(src, bytes);
              src += bytes;
            }
            if (p.y < 0) continue;
            for (int w = 0; w < WG; ++w) {  // each warpgroup's y rows (past the last tile: any tile's)
              const long long ti = pr * WG + w < n_tiles ? pr * WG + w : n_tiles - 1;
              const long long row = (ti * a.act_stride + slots_s[p.y]) / TC_TP + c * NC;
              rg.push_map(ymap, 0, (int)row, YBYTES);
            }
          }
        }
      }
    }
    return;
  }

  // a consumer warpgroup
  const int t = tid % wg::THREADS, bar = 1 + g;
  unsigned char* const RB = base + ly.ring * SLOT + g * ly.per_wg;
  auto region = [&](int r) { return RB + (r == R0 ? 0 : r == R1 ? ly.r01 : 2 * ly.r01) * wg::BLOCK; };
  float* F = reinterpret_cast<float*>(RB + ly.f);
  float* cs0 = F + ly.nf * TC_LDF;   // the column sums, two sets in turns
  float* rx = cs0 + 2 * 4 * NC;      // gz_alpha in f32
  float* gco = rx + TC_TP;           // the corner dCoords
  const int b_len = (int)(a.gz_stride / TC_TP);
  int par = 0;
  for (long long pr = blockIdx.x; pr < pairs; pr += gridDim.x) {
    const long long ti = pr * WG + g, pbase = ti * TC_TP;
    // a warpgroup past the last tile runs on zeros and writes nothing
    const bool live = ti < n_tiles;
    bf16* gzt = live ? reinterpret_cast<bf16*>(a.gzs) + ti * a.gz_stride : nullptr;
    float* bst = live ? a.bsum + ti * b_len : nullptr;
    wg::bar_sync(bar, wg::THREADS);  // the last tile is done with every region
    heads(a, gzt, bst, rx, slots_s, pbase, t);
    head_tile(a, region(R0), 0, 3, pbase, t);
    for (int i = t; i < 3 * TC_TP; i += wg::THREADS) gco[i] = 0.0f;
    wg::fence_async();
    wg::bar_sync(bar, wg::THREADS);
    int hcur = R1;  // the region of the hidden gz's columns 0-127 (gfeat's first chunk: R1)
    for (int q = 0; q < n_prods(a); ++q) {
      const Prod p = prod_of(a, q);
      if (q == 5) {  // the seg head's gz into R0 (free since dir2^T)
        head_tile(a, region(R0), 3, 12, pbase, t);
        wg::fence_async();
        wg::bar_sync(bar, wg::THREADS);
      }
      auto src = [&](int r, int k) {
        if (r < 0) return ASrc{0u, 0u, 0};
        const uint32_t lo = wg::smem_u32(region(r == RH ? hcur : r));
        return ASrc{lo, r == RH ? wg::smem_u32(region(R2)) : lo + 2 * wg::BLOCK, k_blocks(k)};
      };
      const ASrc s1 = src(p.s1, p.k1), s2 = src(p.s2, p.k2);
      const int other = hcur == R0 ? R1 : R0;
      for (int c = 0; c < n_chunks(p.n); ++c) {
        const int col0 = c * NC;
        if (p.out != OUT_GZ) {
          if (chunk_cols(p.n, c) == NC) {
            float d[NC / 2];
            product<NC, PROMOTE>(d, s1, s2, rg, lane);
            store_f<NC>(d, F, col0, p.n, p.out == OUT_FADD, t);
          } else {
            float d[KB / 2];
            product<KB, PROMOTE>(d, s1, s2, rg, lane);
            store_f<KB>(d, F, col0, p.n, p.out == OUT_FADD, t);
          }
          continue;
        }
        float d[NC / 2];
        if (chunk_cols(p.n, c) == NC) product<NC, PROMOTE>(d, s1, s2, rg, lane);
        else product<KB, PROMOTE>(reinterpret_cast<float(&)[KB / 2]>(d), s1, s2, rg, lane);
        const uint32_t dst = wg::smem_u32(region(c > 0 ? R2 : p.dst == RH ? other : p.dst));
        // the stash slot's rows and the bias sums (stash_chunk's columns count from 0)
        bf16* st = gzt != nullptr ? gzt + slots_s[a.n_act + p.gz] : nullptr;
        float* bs = bst != nullptr ? bst + slots_s[a.n_act + p.gz] / TC_TP : nullptr;
        float* cs = cs0 + par * 4 * NC;
        par ^= 1;
        // the two y stages follow the chunk's weight stages: wg 0's, then wg 1's
        const unsigned char* Y = nullptr;
        int y0 = 0, y1 = 0;
        if (p.y >= 0) {
          y0 = rg.stage;
          const uint32_t ph0 = rg.phase;
          rg.next();
          y1 = rg.stage;
          const uint32_t ph1 = rg.phase;
          rg.next();
          // both: a warp arrives on both once read, so neither may be a
          // slot that the producer has not yet filled for this chunk
          wg::mbar_wait(&full[y0], ph0);
          wg::mbar_wait(&full[y1], ph1);
          Y = base + (g == 0 ? y0 : y1) * SLOT;
        }
        if (chunk_cols(p.n, c) == NC)
          gz_chunk<NC>(d, p, col0, Y, rx, alpha_s, st, cs, bs, dst, bar, t);
        else
          gz_chunk<KB>(reinterpret_cast<float(&)[KB / 2]>(d), p, col0, Y, rx, alpha_s, st, cs, bs,
                       dst, bar, t);
        if (p.y >= 0) {  // after this warp's reads of its y stage (gz_chunk's barrier)
          wg::mbar_arrive(&empty[y0], lane == 0);
          wg::mbar_arrive(&empty[y1], lane == 0);
        }
      }
      if (p.out == OUT_GZ && p.dst == RH) hcur = other;
      wg::fence_async();
      wg::bar_sync(bar, wg::THREADS);
      if (q == 4) dir_points(a, F, gco, pbase, t);
    }
    pe_points(a, F, gco, pbase, t);
  }
}

}  // namespace bw

// launch 3 of the backward in bf16 (bw::tile); ymap: the activation stash's
// boxes of 128 rows (a slot's columns) x 64 points, 128-byte swizzle
__global__ void __launch_bounds__(bw::THREADS, 1)
bwd_tc_kernel(const __grid_constant__ Args a, const __grid_constant__ CUtensorMap ymap) {
  extern __shared__ __align__(1024) unsigned char bw_smem[];
  bw::tile(a, &ymap, bw_smem);
}

// The forward tile's launch (fw::tile): persistent blocks, one an SM, two
// 64-point tiles a block at a time. Refuses widths the tile does not take
// and a weight blob that is not the tile's stages.
template <class K>
int launch_fwd(K kernel, const Args& a, cudaStream_t stream) {
  const fw::Layout ly(a);
  if (a.H % 16 || a.B % 16 || a.B < 16 || a.B > fw::NC || a.H > 2 * fw::NC || ly.ring < 2 ||
      a.wg == nullptr || a.wg_bytes != fw::blob_bytes(a))
    return (int)cudaErrorInvalidValue;
  int err = sahs::set_smem(kernel, ly.bytes);
  int dev = 0, sms = 0;
  if (!err) err = (int)cudaGetDevice(&dev);
  if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return err;
  const long long pairs = ((a.P + TC_TP - 1) / TC_TP + fw::WG - 1) / fw::WG;
  kernel<<<(unsigned)(pairs < sms ? pairs : sms), fw::THREADS, ly.bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// Whether the backward tile (bw::tile) takes these widths and its stage blob.
bool bwd_ok(const Args& a) {
  return a.H % 16 == 0 && a.B % 16 == 0 && a.B >= 16 && a.B <= fw::NC && a.H <= 2 * fw::NC &&
         bw::Layout(a).ring >= 2 && a.wgb != nullptr && a.wgb_bytes == bw::blob_bytes(a) &&
         a.bsum != nullptr && a.act_stride % TC_TP == 0 && a.gz_stride % TC_TP == 0;
}

// The backward tile's launch: persistent blocks, one an SM, two 64-point
// tiles a block at a time; the map of the activation stash from which the
// producer copies the y stages.
int launch_bwd(const Args& a, cudaStream_t stream) {
  const bw::Layout ly(a);
  const long long n_tiles = (a.P + TC_TP - 1) / TC_TP;
  CUtensorMap ymap;
  int err = wg::make_map(&ymap, a.acts, n_tiles * a.act_stride / TC_TP, TC_TP, 2 * TC_TP, wg::NC);
  if (!err) err = sahs::set_smem(bwd_tc_kernel, ly.bytes);
  int dev = 0, sms = 0;
  if (!err) err = (int)cudaGetDevice(&dev);
  if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return err;
  const long long pairs = (n_tiles + bw::WG - 1) / bw::WG;
  bwd_tc_kernel<<<(unsigned)(pairs < sms ? pairs : sms), bw::THREADS, ly.bytes, stream>>>(a, ymap);
  return (int)cudaGetLastError();
}

// bf16: launch 1 (fwd_tc_kernel), 2 (the compositing, ray modes), 3
// (bwd_tc_kernel) and the dW of level_dw.cuh over `chunks` chunks of tiles
// (`items`, n_items rows of its work list).
int launch_tc(const Args& a, int chunks, int out_len, const int* prods, float* part,
              float* out, const int* items, int n_items, cudaStream_t stream) {
  const long long n_tiles = (a.P + TC_TP - 1) / TC_TP;
  const size_t sc = (size_t)a.S * COMPOSITE_FLOATS * sizeof(float);
  if (!bwd_ok(a) || items == nullptr || n_items <= 0) return (int)cudaErrorInvalidValue;
  int err = sahs::set_smem(composite_kernel, sc);
  if (!err) err = launch_fwd(fwd_tc_kernel, a, stream);
  if (err) return err;
  if (a.mode == MODE_LOSS || a.mode == MODE_VJP) {
    composite_kernel<<<(unsigned)a.R, CTHREADS, sc, stream>>>(a);
    if ((err = (int)cudaGetLastError())) return err;
  }
  if ((err = launch_bwd(a, stream))) return err;
  return ldw::launch_level_dw(reinterpret_cast<const bf16*>(a.acts),
                              reinterpret_cast<const bf16*>(a.gzs), a.bsum, a.act_stride,
                              a.gz_stride, (int)n_tiles, prods, items, n_items, chunks, part,
                              out, out_len, (int)(a.gz_stride / TC_TP), stream);
}

// K7 / K11 in bf16: one launch of the forward tile without the stash, in
// the accumulation form `promote` (FIELD_PROMOTE, or a candidate)
int launch_field(const Args& a, int promote, cudaStream_t stream) {
  switch (promote) {
    case 0: return launch_fwd(field_tc_kernel<0>, a, stream);
    case 1: return launch_fwd(field_tc_kernel<1>, a, stream);
    case 2: return launch_fwd(field_tc_kernel<2>, a, stream);
    case 4: return launch_fwd(field_tc_kernel<4>, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K5 in bf16: the raw field into the scratch a.raw (launch_field), then
// the compositing forward per ray.
//
// Replaces sahs_tpu/ops/pallas/field_mlp.py:nerf_level_forward (:2681,
// pallas_call at :2761) in bf16; float32 keeps nerf_level.cu's SIMT
// kernel. Why two launches: the tile's shared memory holds its weight ring
// and two warpgroups' activations (up to 227 KB), not a 128-sample ray's
// raw, while the scratch round trip is R*S*64 B written and as many read
// (0.27 GB each way at a frame's fine chunk, ~0.16 ms for both at 3.35
// TB/s). Bound on the H100: ~0.74 M multiply-adds a point, operations: 6.2
// ms at a frame's fine chunk (4.19 M points).
int launch_level_tc(const Args& a, cudaStream_t stream) {
  const size_t sc = (size_t)a.S * COMPOSITE_FWD_FLOATS * sizeof(float);
  int err = sahs::set_smem(composite_fwd_kernel, sc);
  if (!err) err = launch_field(a, FIELD_PROMOTE, stream);
  if (err) return err;
  composite_fwd_kernel<<<(unsigned)a.R, CTHREADS, sc, stream>>>(a);
  return (int)cudaGetLastError();
}

// The arguments of a bf16 field launch (K7, K11 and K5's first launch):
// rays (dirs (R, 3), rows and table, or a per-point se (P, C), or C = 0)
// or, with `extra` (P, 3 + C) given and S = 1, points (with `enc`, ENC_*
// bits, pre-encoded); the weight stages `wg` (wg_bytes) and the biases of
// the forward blob (b, meta). False when they do not fit the kernel.
bool field_args(Args* a, const void* pts, const void* rows, const void* table,
                const void* dirs, const void* extra, const void* se,
                const void* w, const void* b, const void* meta, void* raw,
                long long R, int S, int PW, int L, int skip, int H, int B, int C,
                int amb, int nf_xyz, int nf_amb, int nf_dir, int gD, int gH, int gW,
                int enc, const void* wg, long long wg_bytes) {
  const bool per_point = extra != nullptr;
  if (raw == nullptr || S < 1 || enc < 0 || enc > (ENC_PTS | ENC_EXTRA) ||
      (enc != 0 && (!per_point || se != nullptr)) ||
      (!(enc & ENC_PTS) && (PW < 3 || PW > 8 || amb != PW - 3)) ||
      (per_point && (S != 1 || se != nullptr)) ||
      (!per_point && (dirs == nullptr ||
                      (C > 0 && se == nullptr &&
                       (rows == nullptr || table == nullptr)))))
    return false;
  *a = Args{};
  a->pts = (const float*)pts; a->rows = (const int*)rows; a->table = table;
  a->dirs = (const float*)dirs; a->extra = (const float*)extra;
  a->se = (const float*)se; a->enc = enc;
  a->mode = per_point ? MODE_PTS : MODE_RAW;
  a->w = w; a->b = (const float*)b; a->meta = (const int*)meta;
  a->raw = (float*)raw;
  a->wg = wg; a->wg_bytes = wg_bytes; a->skip = skip;
  a->R = R; a->P = R * S; a->S = S; a->PW = PW; a->L = L; a->H = H; a->B = B;
  a->C = C; a->amb = amb; a->nf_xyz = nf_xyz; a->nf_amb = nf_amb;
  a->nf_dir = nf_dir; a->gD = gD; a->gH = gH; a->gW = gW;
  set_widths(*a);
  return true;
}

}  // namespace

// The bf16 raw field (P, 16) on the tensor cores: K7 (rays: pts (R*S, PW),
// dirs (R, 3), rows and table, or se (P, C), or C = 0) or, with `extra`
// (P, 3 + C) given and S = 1, K11 (per point; `enc`: ENC_PTS, pts is the
// bf16 point encoding (P, PW); ENC_EXTRA, extra is the bf16 [pe(dir) | se]
// (P, C)). Weights: the stages `wg` (wg_bytes) of nerf_level.wgmma_blob and
// the biases of the forward blob of the level backward
// (nerf_level.point_layers: b, meta). `promote`: the accumulation form, -1
// for FIELD_PROMOTE, or a candidate (0, 1, 2, 4; fw::product).
extern "C" int sahs_nerf_field_tc(
    const void* pts, const void* rows, const void* table, const void* dirs,
    const void* extra, const void* se, const void* w, const void* b,
    const void* meta, void* raw, long long R, int S, int PW, int L, int skip, int H,
    int B, int C, int amb, int nf_xyz, int nf_amb, int nf_dir, int gD, int gH,
    int gW, int enc, const void* wg, long long wg_bytes, int promote, void* stream) {
  if (R <= 0) return 0;
  Args a;
  if (!field_args(&a, pts, rows, table, dirs, extra, se, w, b, meta, raw, R, S,
                  PW, L, skip, H, B, C, amb, nf_xyz, nf_amb, nf_dir, gD, gH, gW, enc,
                  wg, wg_bytes))
    return (int)cudaErrorInvalidValue;
  return launch_field(a, promote < 0 ? FIELD_PROMOTE : promote,
                      reinterpret_cast<cudaStream_t>(stream));
}

// K5 in bf16, one call of two launches: K7's raw field of the rays (the
// spatial embedding from rows and table, or se (P, C), or C = 0) into
// `raw` (R*S, 16), a float32 scratch, then the compositing forward per ray
// with z (R, S), the background prior bg (R, 15) and the sigma noise (R,
// S) (either may be null), rgb_map (R, 16) and weights (R, S) out.
extern "C" int sahs_nerf_level_tc(
    const void* pts, const void* rows, const void* table, const void* dirs,
    const void* se, const void* z, const void* bg, const void* noise, const void* w,
    const void* b, const void* meta, void* raw, void* rgb_map, void* weights,
    long long R, int S, int PW, int L, int skip, int H, int B, int C, int amb,
    int nf_xyz, int nf_amb, int nf_dir, int gD, int gH, int gW, const void* wg,
    long long wg_bytes, void* stream) {
  if (R <= 0) return 0;
  Args a;
  if (z == nullptr || rgb_map == nullptr || weights == nullptr ||
      !field_args(&a, pts, rows, table, dirs, nullptr, se, w, b, meta, raw, R, S,
                  PW, L, skip, H, B, C, amb, nf_xyz, nf_amb, nf_dir, gD, gH, gW, 0,
                  wg, wg_bytes))
    return (int)cudaErrorInvalidValue;
  a.z = (const float*)z; a.bg = (const float*)bg; a.noise = (const float*)noise;
  a.rgb_map = (float*)rgb_map; a.weights = (float*)weights;
  return launch_level_tc(a, reinterpret_cast<cudaStream_t>(stream));
}

// The accumulation form the bf16 forward tile runs (FIELD_PROMOTE).
extern "C" int sahs_field_promote() { return FIELD_PROMOTE; }

// K2, K6, K8 or K12 (mode) in one call. In bf16 gzs is the bf16 gz stash,
// wgb (wgb_bytes) the backward tile's stages (level_train.backward_stages),
// bsum (n_tiles x gz_stride / 64 floats) the tiles' column sums of gz, and
// items (n_items x 4 ints) the work list of level_dw.cuh's dW over `chunks`
// chunks of tiles (level_train.dw_items); in float32 those are null and gzs
// is the float32 gz stash of dw_kernel, over the plan's `work`.
extern "C" int sahs_level_train(
    const void* pts, const void* rows, const void* table, const void* dirs,
    const void* z, const void* bg, const void* noise, const void* tgt,
    const void* lw, const void* g_rgb, const void* g_w, const void* extra,
    void* gextra, const void* se, int enc, int mode, const void* w, const void* b, const void* meta,
    const void* wT, const void* bT, const void* metaT, void* rgb_map,
    void* weights, void* gx, void* gse, void* g_bg, void* raw, void* graw,
    void* acts, void* gzs, const void* slots, long long R, int S, int PW,
    int L, int skip, int H, int B, int C, int amb, int nf_xyz, int nf_amb,
    int nf_dir, int gD, int gH, int gW, int bf16, int n_act, int act_stride,
    int gz_stride, int n_work, int chunks, int out_len, float bg_sup,
    const void* prods, const void* work, void* part, void* out, const void* wg,
    long long wg_bytes, const void* wgb, long long wgb_bytes, void* bsum, const void* items,
    int n_items, void* stream) {
  if (R <= 0) return 0;
  if (mode < MODE_LOSS || mode > MODE_PTS) return (int)cudaErrorInvalidValue;
  if ((mode == MODE_LOSS && (tgt == nullptr || lw == nullptr || raw == nullptr)) ||
      (mode == MODE_VJP && (g_rgb == nullptr || g_w == nullptr || raw == nullptr)) ||
      (mode == MODE_RAW && graw == nullptr) ||
      (mode == MODE_PTS && (graw == nullptr || extra == nullptr ||
                            gextra == nullptr || S != 1 || se != nullptr)) ||
      enc < 0 || enc > (ENC_PTS | ENC_EXTRA) || (enc != 0 && mode != MODE_PTS) ||
      (!(enc & ENC_PTS) && (PW < 3 || PW > 8)) ||
      (mode != MODE_PTS &&
       (dirs == nullptr ||
        (C > 0 && (gse == nullptr ||
                   (se == nullptr && (rows == nullptr || table == nullptr)))))))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.pts = (const float*)pts; a.rows = (const int*)rows; a.table = table;
  a.dirs = (const float*)dirs; a.z = (const float*)z;
  a.extra = (const float*)extra; a.gextra = (float*)gextra;
  a.se = (const float*)se; a.enc = enc;
  a.bg = (const float*)bg; a.noise = (const float*)noise;
  a.tgt = (const float*)tgt; a.lw = (const float*)lw;
  a.g_rgb = (const float*)g_rgb; a.g_w = (const float*)g_w; a.mode = mode;
  a.w = w; a.b = (const float*)b; a.meta = (const int*)meta;
  a.wT = wT; a.bT = (const float*)bT; a.metaT = (const int*)metaT;
  a.rgb_map = (float*)rgb_map; a.weights = (float*)weights;
  a.gx = (float*)gx; a.gse = (float*)gse; a.g_bg = (float*)g_bg;
  a.raw = (float*)raw; a.graw = (float*)graw;
  a.acts = acts; a.gzs = (float*)gzs; a.slots = (const int*)slots;
  a.R = R; a.P = R * S; a.act_stride = act_stride; a.gz_stride = gz_stride;
  a.S = S; a.PW = PW; a.L = L; a.skip = skip; a.H = H; a.B = B; a.C = C;
  a.amb = amb; a.nf_xyz = nf_xyz; a.nf_amb = nf_amb; a.nf_dir = nf_dir;
  a.gD = gD; a.gH = gH; a.gW = gW; a.n_act = n_act; a.bg_sup = bg_sup;
  a.wg = wg; a.wg_bytes = wg_bytes;
  a.wgb = wgb; a.wgb_bytes = wgb_bytes; a.bsum = (float*)bsum;
  set_widths(a);
  auto s = reinterpret_cast<cudaStream_t>(stream);
  auto pr = (const int*)prods;
  if (bf16)
    return launch_tc(a, chunks, out_len, pr, (float*)part, (float*)out, (const int*)items,
                     n_items, s);
  return launch<float>(a, n_work, chunks, out_len, pr, (const int*)work, (float*)part,
                       (float*)out, s);
}
