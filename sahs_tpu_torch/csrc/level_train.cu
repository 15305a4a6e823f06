// K2: one NeRF level for training: forward, in-kernel loss cotangents and
// the full backward, from one call.
//
// Replaces sahs_tpu/ops/pallas/level_train.py:nerf_level_train (:55,
// pallas_call at :306) in its corner_interp form. Inputs: K1's packed
// points (P, 3 + ambient) and corner-table rows, the corner table, the raw
// ray directions, z, the background prior and sigma noise (optional), the
// target (R, 15) and the per-ray loss weights (R, 2). Outputs: rgb_map
// (R, 16), weights (R, S), gx (P, 3 + ambient) (PE backward plus the
// trilinear dCoords on xyz), gse (P, C) (the cotangent of the sampled
// spatial embedding, for K4), g_bg (R, 16) and dW/db of every layer.
//
// Why not one pass, as on the TPU: a backward needs all 8 trunk layers,
// the heads and the PE of every point, 3.5 K values a point, while a block
// has 227 KB of shared memory. And dW is a reduction over all points,
// which Hopper's unordered blocks cannot carry from one grid step to the
// next. So one call makes five launches:
//   1. per 32-point tile: PE (accurate sinf, no fast math), the trilinear
//      sample with _cell_geometry's exact float expression from the 8
//      corner rows gathered in the kernel, the MLP (mlp.cuh); every layer's
//      input goes to a device-memory stash (train.cuh), raw (P, 16) out;
//   2. per ray: compositing with the transmittance exp(-sigma dist) kept
//      explicit and sigma[:, -1] += 1e-6, the loss cotangents of
//      level_train.py:26-32 and :179-204, and the compositing backward
//      with the reverse exclusive scan (field_mlp.py:2580-2623); the
//      raw-background last sample gets no rgb/seg gradient;
//   3. per tile: the head, branch and trunk backward with transposed
//      weights, each layer's gz to a second stash, then per point the PE
//      backward and the corner dCoords (field_mlp.py:1824-1843);
//   4-5. the split-K dW reduction over both stashes (train.cuh), summed in
//      a fixed order.
//
// Bound on the H100: about 3 x 0.74 M multiply-adds a point (forward,
// backward chain, dW) against ~60 bytes of input, so operations bound it:
// 0.58 / 1.16 TFLOP at 131,072 / 262,144 points, 0.6 / 1.2 ms at the
// 989 TFLOP/s bf16 peak. This first version runs the products on the CUDA
// cores, and the stash costs ~20 KB of device traffic a point; moving the
// products to wgmma and the stash into a recompute are the next steps.
#include "train.cuh"

namespace {

constexpr int TP = 32;
constexpr int THREADS = 256;
constexpr int CTHREADS = 128;

struct Args {
  const float* pts;     // (P, PW)
  const int* rows;      // (P,)
  const void* table;    // corner table, compute dtype
  const float* dirs;    // (R, 3)
  const float* z;       // (R, S)
  const float* bg;      // (R, 15) or null
  const float* noise;   // (R, S) or null
  const float* tgt;     // (R, 15)
  const float* lw;      // (R, 2)
  const void* w; const float* b; const int* meta;      // forward layers
  const void* wT; const float* bT; const int* metaT;   // transposed layers
  float* rgb_map;       // (R, 16)
  float* weights;       // (R, S)
  float* gx;            // (P, PW)
  float* gse;           // (P, C)
  float* g_bg;          // (R, 16)
  float* raw;           // (P, 16) scratch
  float* graw;          // (P, 16) scratch
  void* acts; float* gzs; const int* slots;
  long long R, P, act_stride, gz_stride;
  int S, PW, L, skip, H, B, C, amb, nf_xyz, nf_amb, nf_dir, gD, gH, gW;
  int n_act;
  float bg_sup;
};

__device__ __forceinline__ int kx_of(const Args& a) {
  return 3 + 6 * a.nf_xyz + a.amb * (1 + 2 * a.nf_amb);
}
__device__ __forceinline__ int ndp_of(const Args& a) { return 3 + 6 * a.nf_dir; }
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

  if (tid < TP) {
    const long long p = base + tid;
    const bool valid = p < a.P;
    float x[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    float d[3] = {0, 0, 0};
    if (valid) {
      for (int c = 0; c < a.PW; ++c) x[c] = a.pts[p * a.PW + c];
      const long long r = p / a.S;
      for (int c = 0; c < 3; ++c) d[c] = a.dirs[r * 3 + c];
    }
    sahs::pe_group<T>(x, 3, a.nf_xyz, xin, 0, tid, TP);
    if (a.amb > 0)
      sahs::pe_group<T>(x + 3, a.amb, a.nf_amb, xin, 3 + 6 * a.nf_xyz, tid, TP);
    sahs::pe_group<T>(d, 3, a.nf_dir, din, 0, tid, TP);
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
__global__ void __launch_bounds__(CTHREADS) composite_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int S = a.S;
  float* ch = reinterpret_cast<float*>(smem_raw);   // [S][16]
  float* sig = ch + S * 16;
  float* tt = sig + S;
  float* al = tt + S;
  float* dist = al + S;
  float* cum = dist + S;       // exclusive scan of log t, then T
  float* wt = cum + S;
  float* gwt = wt + S;
  float* gcum = gwt + S;       // T * g_T, then its reverse exclusive scan
  __shared__ float rm[16], grg[16], gw_last;
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
    rm[tid] = acc;
    a.rgb_map[r * 16 + tid] = acc;
  }
  __syncthreads();
  const float* tg = a.tgt + r * 15;
  const bool sup = has_bg && a.bg_sup > 0.0f;
  if (tid < 16) {
    const int c = tid;
    float g = 0.0f;
    if (c < 3) g = a.lw[r * 2] * 2.0f * (rm[c] - tg[c]);
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
    const float g = (s == S - 1 ? gw_last : 0.0f) + cg;
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

  // per point: PE backward, corner dCoords, outputs
  if (tid < TP) {
    const long long p = base + tid;
    if (p < a.P) {
      float x[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      for (int c = 0; c < a.PW; ++c) x[c] = a.pts[p * a.PW + c];
      float gxo[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      const int groups[2][3] = {{0, 3, a.nf_xyz}, {3, a.amb, a.nf_amb}};
      int row = 0;
      for (int gi = 0; gi < 2; ++gi) {
        const int c0 = groups[gi][0], dim = groups[gi][1], nf = groups[gi][2];
        for (int d = 0; d < dim; ++d) gxo[c0 + d] += gxpe[(row++) * TP + tid];
        for (int f = 0; f < nf; ++f) {
          const float fr = ldexpf(1.0f, f);
          for (int d = 0; d < dim; ++d) {
            const float t = __fmul_rn(x[c0 + d], fr);
            gxo[c0 + d] += gxpe[(row++) * TP + tid] * cosf(t) * fr;
          }
          for (int d = 0; d < dim; ++d) {
            const float t = __fadd_rn(__fmul_rn(x[c0 + d], fr), SAHS_HALF_PI_F);
            gxo[c0 + d] += gxpe[(row++) * TP + tid] * cosf(t) * fr;
          }
        }
      }
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
      for (int c = 0; c < a.PW; ++c) a.gx[p * a.PW + c] = gxo[c];
      for (int c = 0; c < C; ++c) a.gse[p * C + c] = gs[c * TP];
    }
  }
}

template <typename T>
size_t fwd_smem(const Args& a, int kx, int ndp) {
  return (size_t)(kx + ndp + a.C + 2 * a.H) * TP * sizeof(T) +
         (size_t)(8 + 8 + 16 + 8) * TP * sizeof(float) + TP * sizeof(int) + 64;
}

// bf16 flagship: 99 KB, two blocks an SM
template <typename T>
size_t bwd_smem(const Args& a, int ndp) {
  return (size_t)(2 * a.H + 3 * a.B + 8) * TP * sizeof(T) +
         (size_t)(a.H + pad8(ndp + a.C)) * TP * sizeof(float) + 64;
}

template <typename T>
int launch(const Args& a, int n_work, int chunks, int out_len,
           const int* prods, const int* work, float* part, float* out,
           cudaStream_t stream) {
  const int kx = 3 + 6 * a.nf_xyz + a.amb * (1 + 2 * a.nf_amb);
  const int ndp = 3 + 6 * a.nf_dir;
  const long long n_tiles = (a.P + TP - 1) / TP;
  if (pad8(kx) > a.H || a.B > a.H || a.B < 16) return (int)cudaErrorInvalidValue;
  const size_t sf = fwd_smem<T>(a, kx, ndp), sb = bwd_smem<T>(a, ndp);
  const size_t sc = (size_t)a.S * 24 * sizeof(float);
  int err = sahs::set_smem(fwd_kernel<T>, sf);
  if (!err) err = sahs::set_smem(bwd_kernel<T>, sb);
  if (!err) err = sahs::set_smem(composite_kernel, sc);
  if (err) return err;
  fwd_kernel<T><<<(unsigned)n_tiles, THREADS, sf, stream>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  composite_kernel<<<(unsigned)a.R, CTHREADS, sc, stream>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  bwd_kernel<T><<<(unsigned)n_tiles, THREADS, sb, stream>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  return sahs::launch_dw<T>(reinterpret_cast<const T*>(a.acts), a.gzs,
                            a.act_stride, a.gz_stride, (int)n_tiles, TP,
                            prods, work, n_work, chunks, part, out, out_len,
                            stream);
}

}  // namespace

extern "C" int sahs_level_train(
    const void* pts, const void* rows, const void* table, const void* dirs,
    const void* z, const void* bg, const void* noise, const void* tgt,
    const void* lw, const void* w, const void* b, const void* meta,
    const void* wT, const void* bT, const void* metaT, void* rgb_map,
    void* weights, void* gx, void* gse, void* g_bg, void* raw, void* graw,
    void* acts, void* gzs, const void* slots, long long R, int S, int PW,
    int L, int skip, int H, int B, int C, int amb, int nf_xyz, int nf_amb,
    int nf_dir, int gD, int gH, int gW, int bf16, int n_act, int act_stride,
    int gz_stride, int n_work, int chunks, int out_len, float bg_sup,
    const void* prods, const void* work, void* part, void* out, void* stream) {
  if (R <= 0) return 0;
  Args a;
  a.pts = (const float*)pts; a.rows = (const int*)rows; a.table = table;
  a.dirs = (const float*)dirs; a.z = (const float*)z;
  a.bg = (const float*)bg; a.noise = (const float*)noise;
  a.tgt = (const float*)tgt; a.lw = (const float*)lw;
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
  auto s = reinterpret_cast<cudaStream_t>(stream);
  auto pr = (const int*)prods;
  auto wk = (const int*)work;
  if (bf16)
    return launch<__nv_bfloat16>(a, n_work, chunks, out_len, pr, wk,
                                 (float*)part, (float*)out, s);
  return launch<float>(a, n_work, chunks, out_len, pr, wk, (float*)part,
                       (float*)out, s);
}
