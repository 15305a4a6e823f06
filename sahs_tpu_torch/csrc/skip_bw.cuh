// The deformation nets' backward tile on wgmma: bf16 K3 (deform_pair_vjp.cu,
// pair_bwd_wg_kernel: the warp and the hyper net on one encoding) and bf16
// K14 (skip_mlp.cu, skip_bwd_wg_kernel: one net, on the raw points or on a
// given encoding). Their dW is level_dw.cuh's, over the two stashes this
// tile writes.
//
// What the tile computes, per point and net: the forward of K1 / K13
// (skip_wg.cuh: the encoding, the trunk of L ReLU layers, the head y =
// act(v + b) in float32), each layer's input to the activation stash; the
// head's cotangent gz = (g + g2) act'(y) in float32 (g + g2 added with
// round-to-nearest; act' = 1 - y^2 for the tanh warp head, 1 for the linear
// hyper head; zero on the padded columns and past P); then back through
// the transposed layers, gz_l = (gz_{l+1} W_{l+1}^T) relu'(h_l), each gz to
// the gz stash in bf16 and its column sums over the tile's points (the
// float32 gz, in a fixed order) to bsum for db. With gx, each net's
// cotangent goes back to the encoding (layer 0 and the skip layer's pe
// rows, one two-input product), the nets' float32 results are summed warp
// first, then hyper, and one PE backward per point (mlp.cuh:pe_group_bwd,
// the angles as the forward forms them) gives gx, plus K3's residual
// (g + g2)[:, :3]; on a given encoding that product's result is gx.
//
// Design (as skip_wg.cuh's sk::tile, which it extends). Persistent blocks,
// one an SM, of two consumer warpgroups (a 64-point tile each: a stash
// block) and a producer warp whose one thread streams the weight stages
// through wgmma.cuh's ring: per net the forward layers' stages
// (field_mlp.stage_blob of the plan's forward blob, as K1's), then the
// transposed layers' in the order the tile runs them (head^T, trunk L-1 ..
// 1, [the layer back to the encoding]; skip_mlp.backward_stage_order),
// each one 64-k block of a layer's outputs, zero past K. Every product is
// wgmma.m64nNk16 at N = 128 (the warp net), 64 (the hyper net, the
// encoding's cotangent) or 8 (the heads), each k16 step summed from zero
// and added in float32 (PROMOTE 1), so the recomputed forward is K1's and
// K13's, value for value. A forward epilogue writes relu(v + b) in bf16 to
// the next product's A tile and keeps relu'(h) as one bit per accumulator
// register in shared memory: the backward epilogue of the same layer runs
// at the same N, so the same thread holds the same (point, column) and
// reads its own bits back. No activation returns from device memory: a
// tile's warp-net stash alone is ~98 KB, the bits are 1 KB a layer. A
// backward epilogue writes gz in bf16 to the next product's A tile and
// sums its columns (wgmma.cuh's col_sums: the thread's two points, then
// the column's 8 lanes by butterfly, then the 4 warps in order) into bsum;
// no float32 gz tile is kept. The stashes take each finished A tile (the
// encoding, each h, each gz) after the epilogue's barrier: ldmatrix.trans
// reads 8 columns x 32 points of the swizzled tile (conflict-free), a 4 x 4
// exchange among a column's four lanes gives each lane 8 consecutive
// points, and each lane stores 16 bytes, so a warp writes whole 32-byte
// sectors (the epilogue's own 4-byte scatter of two points a word read 2x
// slower and spilled under the register cap). Hidden regions take turns
// (Ha, Hb; the skip layer's gz in gS while gx needs it), and no epilogue
// writes where its product reads.
// The roles branch on wg::warpgroup() and the ring's arrivals are
// predicated, so ptxas keeps the wgmma pipelined (no C7520).
//
// Bound on the H100: operations. K3 at a step's 262,144 fine points is
// about 3 x 0.125 M multiply-adds a point (the forward, the transposed
// chain, the dW), 0.19 ms at the 989 TFLOP/s bf16 peak; this tile does two
// thirds of them. Its stashes hold 0.637 GB of activations and 0.612 GB of
// gz (bf16), written once here and read once by the dW: 0.37 ms each way
// at 3.35 TB/s. The tile's times are in PERF.md section 6.
#pragma once

#include "skip_wg.cuh"

namespace sb {

using bf16 = __nv_bfloat16;
using sahs::LayerDesc;
using wg::ASrc;
using wg::KB;
using wg::SLOT;

constexpr int WG = 2;                                // consumer warpgroups
constexpr int THREADS = WG * wg::THREADS + 32;       // and the producer warp
constexpr int TP = wg::ROWS;                         // points a tile (a stash block)
constexpr int HMAX = sk::HMAX;                       // widest trunk and encoding
constexpr int HEAD = sk::HEAD;                       // a head's padded width
constexpr int LAYERS_MAX = sk::LAYERS_MAX;           // forward (and transposed) layers
constexpr int RING_MAX = 8;
constexpr int SMEM_MAX = 232448;                     // a block's dynamic shared memory
constexpr int PROMOTE = sk::PROMOTE;                 // every k16 step, as K1 and K13
constexpr int LDF = TP + 4;                          // row stride of the f32 tile F

using sk::cdiv;

struct Args {
  sahs::PointSrc pts;    // the raw points (P, 3) or the rays; unread with enc
  const bf16* enc;       // a given encoding (P, pe_dim) (K14 pre-encoded), or null
  const void* wf;        // the forward layers' stages (field_mlp.stage_blob)
  long long wf_bytes;
  const void* wb;        // the transposed layers' stages (skip_mlp.backward_stages)
  long long wb_bytes;
  const float* b;        // the forward bias blob, b_len floats
  const float* g;        // (P, gw) cotangent of the output
  const float* g2;       // (P, gw) addend, or null
  float* gx;             // (P, 3), or (P, pe_dim) on a given encoding, or null
  bf16* acts;            // activation stash, act_stride a tile
  bf16* gzs;             // gz stash, gz_stride a tile (a layer's slot at its bias offset x TP)
  float* bsum;           // (tiles, b_len) column sums of gz
  long long P, act_stride, gz_stride;
  int nets;              // 1 (K14) or 2 (K3: the warp net, then the hyper net)
  int L[2], skip[2];     // trunk layers and skip layer of each net
  int gw, col0[2], ncol[2];   // g's width and each net's columns of it
  int pe_dim, n_freq, b_len;
  int residual;          // K3: gx += (g + g2)[:, :3]
  int act_off[LAYERS_MAX];     // activation slots: the encoding, each net's h_0 ..
  LayerDesc layer[LAYERS_MAX]; // forward layers: each net's trunk, then its head
  LayerDesc tl[LAYERS_MAX];    // transposed: each net's head^T, trunk L-1 .. 1; then,
                               // with gx, each net's layer back to the encoding
};

__host__ __device__ __forceinline__ int first(const Args& a, int net) {
  return net == 0 ? 0 : a.L[0] + 1;
}
__host__ __device__ __forceinline__ int n_layers(const Args& a) {
  return a.L[0] + 1 + (a.nets > 1 ? a.L[1] + 1 : 0);
}
__host__ __device__ __forceinline__ int n_tl(const Args& a) {
  return a.L[0] + (a.nets > 1 ? a.L[1] : 0) + (a.gx != nullptr ? a.nets : 0);
}
__host__ __device__ __forceinline__ bool fires(const Args& a, int net) {
  return a.skip[net] > 0 && a.skip[net] < a.L[net];
}
// the transposed layer of the net's backward product q: head^T (q = 0),
// trunk (L - q)^T, and with gx (q = L) the layer back to the encoding
__host__ __device__ __forceinline__ int tl_of(const Args& a, int net, int q) {
  if (q < a.L[net]) return (net == 0 ? 0 : a.L[0]) + q;
  return a.L[0] + (a.nets > 1 ? a.L[1] : 0) + net;
}
__host__ __device__ __forceinline__ int n_bwd(const Args& a, int net) {
  return a.L[net] + (a.gx != nullptr ? 1 : 0);
}
__host__ __device__ __forceinline__ int stages(const LayerDesc& d) {
  return cdiv(d.k1, KB) + (d.w2 >= 0 ? cdiv(d.k2, KB) : 0);
}
__host__ __device__ __forceinline__ int rows64(int n) { return cdiv(n, KB) * KB; }
// rows of forward layer i's stages: a head's padded width, else its width
// rounded up to a whole 64-column block (sk::stage_rows)
__host__ __device__ __forceinline__ int fwd_rows(const Args& a, int i) {
  const bool head = i == a.L[0] || (a.nets > 1 && i == a.L[0] + 1 + a.L[1]);
  return head ? a.layer[i].n : rows64(a.layer[i].n);
}

// Bytes of the two stage blobs of one tile.
inline long long fwd_bytes(const Args& a) {
  long long s = 0;
  for (int i = 0; i < n_layers(a); ++i) s += 128LL * fwd_rows(a, i) * stages(a.layer[i]);
  return s;
}
inline long long bwd_bytes(const Args& a) {
  long long s = 0;
  for (int net = 0; net < a.nets; ++net)
    for (int q = 0; q < n_bwd(a, net); ++q) {
      const LayerDesc& d = a.tl[tl_of(a, net, q)];
      s += 128LL * rows64(d.n) * stages(d);
    }
  return s;
}

// Trunk layers of the widest net (the derivative bits' slots).
__host__ __device__ __forceinline__ int l_max(const Args& a) {
  return a.nets > 1 && a.L[1] > a.L[0] ? a.L[1] : a.L[0];
}

// Shared memory, from a 1,024-byte-aligned base: the ring of `ring` slots,
// then each warpgroup's regions: the encoding E [eb blocks of wg::BLOCK,
// 64 points x 128 bytes], the hidden tiles Ha and Hb [hb blocks each] and,
// with gx, the skip layer's gz gS [hb] and the encoding's cotangent F
// (f32, pad8(pe_dim) rows of LDF); the derivative bits [l_max layers][2
// words][128 threads], two sets of the 4 warps' column sums [2][4][NC],
// the raw points [TP][3], padded to 1,024 bytes; then the biases, the
// barriers, and the slack that aligns the base.
struct Layout {
  int eb, hb, gs, f, mk, cs, xs, per_wg, ring, bias, bar, bytes;
  __host__ __device__ explicit Layout(const Args& a) {
    eb = cdiv(a.pe_dim, KB);
    int h = 0;
    for (int net = 0; net < a.nets; ++net)
      for (int l = 0; l < a.L[net]; ++l)
        if (a.layer[first(a, net) + l].n > h) h = a.layer[first(a, net) + l].n;
    hb = cdiv(h, KB);
    const bool to_pe = a.gx != nullptr;
    gs = (eb + 2 * hb) * wg::BLOCK;
    f = gs + (to_pe ? hb * wg::BLOCK : 0);
    mk = f + (to_pe ? (a.pe_dim + 7) / 8 * 8 * LDF * 4 : 0);
    cs = mk + l_max(a) * 2 * wg::THREADS * 4;
    xs = cs + 2 * 4 * wg::NC * 4;
    per_wg = cdiv(xs + TP * 3 * 4, 1024) * 1024;
    const int params = cdiv(a.b_len, 4) * 16;
    const int fixed = WG * per_wg + params + 16 * RING_MAX + 1024;
    ring = (SMEM_MAX - fixed) / SLOT;
    if (ring > RING_MAX) ring = RING_MAX;
    bias = ring * SLOT + WG * per_wg;
    bar = bias + params;
    bytes = bar + 16 * RING_MAX + 1024;
  }
};

// Columns [0, n) of the K-major 64-point tile at shared address X (the
// 128-byte swizzle, 64-column blocks) into the stash slot st, a row of TP
// points per column. A warp takes units of 8 columns x 32 points:
// ldmatrix.x4.trans gives lane l, for each of the unit's four 8-point
// groups m, the word of column l / 4 at points 8 m + 2 (l % 4), + 1; a
// 4 x 4 exchange among a column's four lanes (q = l % 4) gives lane q the
// words of points 8 q .. 8 q + 7, which it stores as 16 bytes.
__device__ __forceinline__ void stash_tile(uint32_t X, bf16* st, int n, int t) {
  const int w = t / 32, l = t % 32, q = l % 4, j = l / 4;
  const int units = cdiv(n, 8) * 2;
  for (int u = w; u < units; u += 4) {
    const int c0 = 8 * (u >> 1), p0 = 32 * (u & 1);
    uint32_t d[4];
    const uint32_t row = X + wg::sw128(TP, p0 + l, c0);  // lane l: point p0 + l
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
                 : "r"(row));
#pragma unroll
    for (int b = 1; b < 4; b <<= 1) {
      const bool up = (q & b) != 0;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if (m & b) continue;
        const uint32_t send = up ? d[m] : d[m | b];
        const uint32_t got = (uint32_t)__shfl_xor_sync(0xffffffffu, (int)send, b);
        if (up) d[m] = got;
        else d[m | b] = got;
      }
    }
    if (c0 + j < n)
      *reinterpret_cast<uint4*>(st + (c0 + j) * TP + p0 + 8 * q) =
          make_uint4(d[0], d[1], d[2], d[3]);
  }
}

// Thread t's register e of an N-wide product (wgmma.cuh: d[4 j + 2 i + c] =
// D[r0 + 8 i][8 j + 2 q + c]) and its bf16 word (columns 8 j + 2 q, + 1 of
// row r0 + 8 i) at shared address `row` + this offset in a K-major tile
// (row = dst + r0 * 128 + 4 q).
__device__ __forceinline__ uint32_t word_at(int j, int i, int sw) {
  return i * 1024 + (j >> 3) * wg::BLOCK + (((j & 7) ^ sw) << 4);
}

// A hidden layer's forward epilogue: relu(d + b) in bf16 (skip_wg.cuh's
// store_hidden, value for value) into columns [0, N) of the A tile at
// `dst` (with GUARD zero from n on); relu'(h), one bit a register, into
// the thread's words mk[w * 128 + t].
template <int N, bool GUARD>
__device__ __forceinline__ void fwd_epilogue(const float (&d)[N / 2], uint32_t dst,
                                             const float* bias, int n, uint32_t* mk, int t) {
  const int l = t % 32, q = l % 4;
  const int r0 = 16 * (t / 32) + l / 4, sw = r0 & 7;
  const uint32_t row = dst + r0 * 128 + 4 * q;
  uint32_t m[N / 64];
#pragma unroll
  for (int w = 0; w < N / 64; ++w) m[w] = 0u;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = 8 * j + 2 * q;
    const bool ok = !GUARD || col < n;  // n even: col + 1 with col
    const float2 b = ok ? *reinterpret_cast<const float2*>(bias + col) : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = 4 * j + 2 * i;
      const float u0 = d[e] + b.x, u1 = d[e + 1] + b.y;
      const __nv_bfloat162 hv = __floats2bfloat162_rn(ok ? fmaxf(u0, 0.0f) : 0.0f,
                                                      ok ? fmaxf(u1, 0.0f) : 0.0f);
      const uint32_t h = *reinterpret_cast<const uint32_t*>(&hv);
      wg::sts32(row + word_at(j, i, sw), h);
      m[e >> 5] |= ((ok && u0 > 0.0f) ? 1u : 0u) << (e & 31);
      m[e >> 5] |= ((ok && u1 > 0.0f) ? 2u : 0u) << (e & 31);
    }
  }
#pragma unroll
  for (int w = 0; w < N / 64; ++w) mk[w * wg::THREADS + t] = m[w];
}

template <int N>
__device__ __forceinline__ void fwd_layer(const ASrc& s1, const ASrc& s2, wg::Ring& rg,
                                          uint32_t dst, const float* bias, int n, uint32_t* mk,
                                          int lane, int t) {
  float d[N / 2];
  wg::product<N, PROMOTE>(d, s1, s2, rg, lane);
  if (n % N) fwd_epilogue<N, true>(d, dst, bias, n, mk, t);
  else fwd_epilogue<N, false>(d, dst, bias, n, mk, t);
}

// A transposed layer's epilogue: gz = d relu'(h) (the forward's bits),
// zero from n on with GUARD, in bf16 into the A tile at `dst`; the float32
// gz's sums over the warp's 16 points of each column into cs[col].
template <int N, bool GUARD>
__device__ __forceinline__ void bwd_epilogue(const float (&d)[N / 2], uint32_t dst,
                                             const uint32_t* mk, int n, float* cs, int t) {
  const int l = t % 32, q = l % 4;
  const int r0 = 16 * (t / 32) + l / 4, sw = r0 & 7;
  const uint32_t row = dst + r0 * 128 + 4 * q;
  uint32_t m[N / 64];
#pragma unroll
  for (int w = 0; w < N / 64; ++w) m[w] = mk[w * wg::THREADS + t];
  float s[N / 4];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = 8 * j + 2 * q;
    const bool ok = !GUARD || col < n;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = 4 * j + 2 * i;
      const float v0 = ok && ((m[e >> 5] >> (e & 31)) & 1u) ? d[e] : 0.0f;
      const float v1 = ok && ((m[e >> 5] >> (e & 31)) & 2u) ? d[e + 1] : 0.0f;
      s[2 * j] = i == 0 ? v0 : s[2 * j] + v0;
      s[2 * j + 1] = i == 0 ? v1 : s[2 * j + 1] + v1;
      const __nv_bfloat162 hv = __floats2bfloat162_rn(v0, v1);
      const uint32_t h = *reinterpret_cast<const uint32_t*>(&hv);
      wg::sts32(row + word_at(j, i, sw), h);
    }
  }
  wg::col_sums<N>(s, cs + (t / 32) * wg::NC, t);
}

template <int N>
__device__ __forceinline__ void bwd_layer(const ASrc& s1, wg::Ring& rg, uint32_t dst,
                                          const uint32_t* mk, int n, float* cs, int lane, int t) {
  float d[N / 2];
  const ASrc none = {0u, 0u, 0};
  wg::product<N, PROMOTE>(d, s1, none, rg, lane);
  if (n % N) bwd_epilogue<N, true>(d, dst, mk, n, cs, t);
  else bwd_epilogue<N, false>(d, dst, mk, n, cs, t);
}

__device__ __forceinline__ void sts_zero16(uint32_t addr) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n" ::"r"(addr), "r"(0));
}

// A head: y = act(v + b) (sk::head_layer's), its cotangent gz = (g + g2)
// act'(y) in f32 (columns n < ncol of the net's g, points below P, else 0)
// into columns 0-7 of the A tile at `dst` (columns 8-63 zero: head^T's K
// padding), and its column sums into cs.
__device__ __forceinline__ void head_gz(const Args& a, int net, const ASrc& s1, wg::Ring& rg,
                                        uint32_t dst, const float* bias, int act, float* cs,
                                        long long pbase, int lane, int t) {
  float d[HEAD / 2];
  const ASrc none = {0u, 0u, 0};
  wg::product<HEAD, PROMOTE>(d, s1, none, rg, lane);
  const int l = t % 32, q = l % 4;
  const int r0 = 16 * (t / 32) + l / 4, sw = r0 & 7;
  const uint32_t row = dst + r0 * 128 + 4 * q;
  const int ncol = a.ncol[net];
  const float* g = a.g + a.col0[net];
  const float* g2 = a.g2 != nullptr ? a.g2 + a.col0[net] : nullptr;
  float s[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long p = pbase + r0 + 8 * i;
    float gz[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int n = 2 * q + c;
      const float y = sahs::apply_act(d[2 * i + c] + bias[n], act);
      float gv = 0.0f;
      if (n < ncol && p < a.P) {
        gv = g[p * a.gw + n];
        if (g2 != nullptr) gv = __fadd_rn(gv, g2[p * a.gw + n]);
      }
      gz[c] = act == sahs::ACT_TANH ? gv * (1.0f - y * y) : gv;
      s[c] = i == 0 ? gz[c] : s[c] + gz[c];
    }
    const __nv_bfloat162 hv = __floats2bfloat162_rn(gz[0], gz[1]);
    const uint32_t h = *reinterpret_cast<const uint32_t*>(&hv);
    wg::sts32(row + word_at(0, i, sw), h);
    // chunks 1-7 of the row (columns 8-63): chunk 1 + q and, but for q = 3, 5 + q
    const uint32_t r = dst + (r0 + 8 * i) * 128;
    sts_zero16(r + (((1 + q) ^ sw) << 4));
    if (q < 3) sts_zero16(r + (((5 + q) ^ sw) << 4));
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    float v = s[c];
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    if (l < 4) cs[(t / 32) * wg::NC + 2 * q + c] = v;
  }
}

// A tile's column sums of a layer's gz (the 4 warps' in order) into bs
// (its row of bsum from the layer's bias offset).
__device__ __forceinline__ void put_sums(const float* cs, float* bs, int n, int t) {
  if (t < n)
    bs[t] = ((cs[t] + cs[wg::NC + t]) + cs[2 * wg::NC + t]) + cs[3 * wg::NC + t];
}

// The layer back to the encoding: its f32 outputs (columns below n) into F
// [n][LDF], added to what F holds with `add` (the hyper net after the warp
// net's).
template <int N>
__device__ __forceinline__ void pe_layer(const ASrc& s1, const ASrc& s2, wg::Ring& rg, float* F,
                                         int n, bool add, int lane, int t) {
  float d[N / 2];
  wg::product<N, PROMOTE>(d, s1, s2, rg, lane);
  const int l = t % 32, q = l % 4;
  const int r0 = 16 * (t / 32) + l / 4;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * q + c;
        if (col < n) {
          float* o = F + col * LDF + r0 + 8 * i;
          *o = add ? *o + d[4 * j + 2 * i + c] : d[4 * j + 2 * i + c];
        }
      }
}

// The tile's rows of gx below P from F: on a given encoding F's rows, else
// the PE backward of the raw point (Xs) plus, for K3, (g + g2)[:, :3].
__device__ __forceinline__ void store_gx(const Args& a, const float* F, const float* Xs,
                                         long long pbase, int t) {
  const long long n = a.P - pbase < TP ? a.P - pbase : TP;
  if (a.enc != nullptr) {
    const int dim = a.pe_dim;
    for (int i = t; i < n * dim; i += wg::THREADS)
      a.gx[pbase * dim + i] = F[(i % dim) * LDF + i / dim];
    return;
  }
  if (t >= n) return;
  const long long p = pbase + t;
  const float x[3] = {Xs[t * 3], Xs[t * 3 + 1], Xs[t * 3 + 2]};
  float gx[3] = {0.0f, 0.0f, 0.0f};
  sahs::pe_group_bwd(x, 3, a.n_freq, F, 0, t, LDF, gx);
  for (int c = 0; c < 3; ++c) {
    float v = gx[c];
    if (a.residual) {
      float gv = a.g[p * a.gw + c];
      if (a.g2 != nullptr) gv = __fadd_rn(gv, a.g2[p * a.gw + c]);
      v += gv;
    }
    a.gx[p * 3 + c] = v;
  }
}

__device__ __forceinline__ void tile(const Args& a, unsigned char* smem) {
  const Layout ly(a);
  unsigned char* base = smem + ((1024 - (wg::smem_u32(smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + ly.bar);
  uint64_t* empty = full + RING_MAX;
  const int tid = threadIdx.x, g = wg::warpgroup(), lane = tid % 32;
  const long long n_tiles = (a.P + TP - 1) / TP;
  const long long pairs = (n_tiles + WG - 1) / WG;
  float* bias_s = reinterpret_cast<float*>(base + ly.bias);
  for (int i = tid; i < a.b_len; i += blockDim.x) bias_s[i] = a.b[i];
  if (tid == 0) {
    for (int s = 0; s < ly.ring; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], 4 * WG);  // lane 0 of every consumer warp
    }
    wg::mbar_fence_init();
  }
  __syncthreads();
  wg::Ring rg{base, full, empty, ly.ring, 0, 0u};

  if (g == WG) {  // the producer warp: one thread issues every weight stage
    if (lane == 0) {
      for (long long pr = blockIdx.x; pr < pairs; pr += gridDim.x) {
        const unsigned char* f = reinterpret_cast<const unsigned char*>(a.wf);
        const unsigned char* b = reinterpret_cast<const unsigned char*>(a.wb);
        for (int net = 0; net < a.nets; ++net) {
          for (int i = first(a, net); i <= first(a, net) + a.L[net]; ++i) {
            const uint32_t bytes = 128u * fwd_rows(a, i);
            for (int s = stages(a.layer[i]); s > 0; --s) {
              rg.push(f, bytes);
              f += bytes;
            }
          }
          for (int q = 0; q < n_bwd(a, net); ++q) {
            const LayerDesc& d = a.tl[tl_of(a, net, q)];
            const uint32_t bytes = 128u * rows64(d.n);
            for (int s = stages(d); s > 0; --s) {
              rg.push(b, bytes);
              b += bytes;
            }
          }
        }
      }
    }
    return;
  }

  // a consumer warpgroup
  const int t = tid % wg::THREADS, bar = 1 + g;
  unsigned char* E = base + ly.ring * SLOT + g * ly.per_wg;
  float* F = reinterpret_cast<float*>(E + ly.f);
  uint32_t* MK = reinterpret_cast<uint32_t*>(E + ly.mk);
  float* CS = reinterpret_cast<float*>(E + ly.cs);
  float* Xs = reinterpret_cast<float*>(E + ly.xs);
  for (int i = t; i < (ly.eb * KB - a.pe_dim) * TP; i += wg::THREADS)
    sk::put(E, i % TP, a.pe_dim + i / TP, 0.0f);  // the K padding of the encoding
  const uint32_t e = wg::smem_u32(E);
  const uint32_t ha = e + ly.eb * wg::BLOCK, hb = ha + ly.hb * wg::BLOCK;
  const uint32_t gs = e + ly.gs;
  auto region = [](uint32_t at, int k) { return ASrc{at, at + 2 * wg::BLOCK, cdiv(k, KB)}; };
  const ASrc none = {0u, 0u, 0};
  int par = 0;
  for (long long pr = blockIdx.x; pr < pairs; pr += gridDim.x) {
    // a warpgroup past the last tile runs on zeros and writes nothing
    const long long ti = pr * WG + g, pbase = ti * TP;
    const bool live = ti < n_tiles;
    bf16* acts = a.acts + ti * a.act_stride;
    bf16* gzt = a.gzs + ti * a.gz_stride;
    float* bst = a.bsum + ti * a.b_len;
    sk::front_half(a, E, Xs, pbase, t, bar);
    if (live) stash_tile(e, acts + a.act_off[0], a.pe_dim, t);
    int slot = 1;  // the activation slot of this net's h_0
    for (int net = 0; net < a.nets; ++net) {
      const int f0 = first(a, net), L = a.L[net];
      // forward: h_l into Hb for even l, Ha for odd l, and to the stash
      bool in_b = false;  // Hb (else Ha) holds the last hidden output
      for (int l = 0; l < L; ++l) {
        const LayerDesc& d = a.layer[f0 + l];
        const ASrc s1 = l == 0 ? region(e, d.k1) : region(in_b ? hb : ha, d.k1);
        const ASrc s2 = d.w2 >= 0 ? region(e, d.k2) : none;
        const uint32_t dst = in_b ? ha : hb;
        uint32_t* mk = MK + l * 2 * wg::THREADS;
        if (d.n > KB) fwd_layer<2 * KB>(s1, s2, rg, dst, bias_s + d.b, d.n, mk, lane, t);
        else fwd_layer<KB>(s1, s2, rg, dst, bias_s + d.b, d.n, mk, lane, t);
        in_b = !in_b;
        wg::fence_async();
        wg::bar_sync(bar, wg::THREADS);
        if (live) stash_tile(dst, acts + a.act_off[slot + l], d.n, t);
      }
      slot += L;
      // the head and its cotangent, into the free hidden tile
      const LayerDesc& hd = a.layer[f0 + L];
      uint32_t cur = in_b ? ha : hb;
      {
        float* cs = CS + par * 4 * wg::NC;
        head_gz(a, net, region(in_b ? hb : ha, hd.k1), rg, cur, bias_s + hd.b, hd.act, cs,
                pbase, lane, t);
        wg::fence_async();
        wg::bar_sync(bar, wg::THREADS);
        if (live) {
          put_sums(cs, bst + hd.b, hd.n, t);
          stash_tile(cur, gzt + (long long)hd.b * TP, hd.n, t);
        }
        par ^= 1;
      }
      // back through head^T, trunk L-1 .. 1: gz_l for l = L-1 .. 0; with gx
      // the skip layer's gz into gS, kept for the encoding's product
      const bool keep = a.gx != nullptr && fires(a, net);
      for (int q = 0; q < L; ++q) {
        const int l = L - 1 - q;
        const LayerDesc& td = a.tl[tl_of(a, net, q)];
        const LayerDesc& fd = a.layer[f0 + l];
        const uint32_t dst = keep && l == a.skip[net] ? gs : cur == ha ? hb : ha;
        float* cs = CS + par * 4 * wg::NC;
        const uint32_t* mk = MK + l * 2 * wg::THREADS;
        if (td.n > KB) bwd_layer<2 * KB>(region(cur, td.k1), rg, dst, mk, fd.n, cs, lane, t);
        else bwd_layer<KB>(region(cur, td.k1), rg, dst, mk, fd.n, cs, lane, t);
        wg::fence_async();
        wg::bar_sync(bar, wg::THREADS);
        if (live) {
          put_sums(cs, bst + fd.b, fd.n, t);
          stash_tile(dst, gzt + (long long)fd.b * TP, fd.n, t);
        }
        par ^= 1;
        cur = dst;
      }
      if (a.gx == nullptr) continue;
      // back to the encoding: gz_0 W_0^T + gz_skip W_skip,pe^T
      const LayerDesc& pd = a.tl[tl_of(a, net, L)];
      const ASrc s2 = fires(a, net) ? region(gs, pd.k2) : none;
      if (pd.n > KB) pe_layer<2 * KB>(region(cur, pd.k1), s2, rg, F, pd.n, net > 0, lane, t);
      else pe_layer<KB>(region(cur, pd.k1), s2, rg, F, pd.n, net > 0, lane, t);
      wg::bar_sync(bar, wg::THREADS);
    }
    if (a.gx != nullptr && live) store_gx(a, F, Xs, pbase, t);
  }
}

// The host side: refuses what the tile does not take (widths, layer
// tables that do not chain, a layout without a ring of two stages) and
// stage blobs that are not the tile's; persistent blocks, one an SM.
inline bool takes(const Args& a) {
  if (a.nets < 1 || a.nets > 2 || a.L[0] < 1 || (a.nets > 1 && a.L[1] < 1) ||
      n_layers(a) > LAYERS_MAX || n_tl(a) > LAYERS_MAX || a.pe_dim < 1 || a.pe_dim > HMAX ||
      Layout(a).ring < 2)
    return false;
  for (int net = 0; net < a.nets; ++net) {
    const int f0 = first(a, net), L = a.L[net];
    for (int l = 0; l <= L; ++l) {
      const LayerDesc& d = a.layer[f0 + l];
      if (d.k1 > HMAX || d.k2 > HMAX || (d.w2 >= 0) != (d.k2 > 0)) return false;
      if (l == L ? d.n != HEAD : (d.n % 8 || d.n > HMAX || d.act != sahs::ACT_RELU))
        return false;
    }
    // the transposed layers chain: head^T and trunk (L - q)^T give layer
    // L - 1 - q's outputs from the layer above's
    for (int q = 0; q < L; ++q) {
      const LayerDesc& td = a.tl[tl_of(a, net, q)];
      if (td.n != a.layer[f0 + L - 1 - q].n || td.k1 > (q == 0 ? HEAD : HMAX) || td.w2 >= 0)
        return false;
    }
    if (a.gx != nullptr) {
      const LayerDesc& pd = a.tl[tl_of(a, net, L)];
      if (pd.n != (a.pe_dim + 7) / 8 * 8 || pd.k1 > HMAX || (pd.w2 >= 0) != fires(a, net))
        return false;
    }
  }
  return true;
}

template <class K>
int launch(K kernel, const Args& a, cudaStream_t stream) {
  const Layout ly(a);
  if (!takes(a) || a.wf == nullptr || a.wb == nullptr || a.wf_bytes != fwd_bytes(a) ||
      a.wb_bytes != bwd_bytes(a) || a.b_len * (long long)TP != a.gz_stride)
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      ly.bytes);
  int dev = 0, sms = 0;
  if (!err) err = (int)cudaGetDevice(&dev);
  if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return err;
  const long long pairs = ((a.P + TP - 1) / TP + WG - 1) / WG;
  kernel<<<(unsigned)(pairs < sms ? pairs : sms), THREADS, ly.bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// The Args of a launch from the plan's host tables: the forward layers
// (descs, 7 ints a layer), the n_t transposed layers (descs_t) and the
// activation slots' offsets (act_off, one a slot); the caller fills the
// rest. A launch that asks for gx needs the transposed blob that ends with
// the layers back to the encoding (n_t = L0 + L1 + nets).
inline Args args_of(const int* descs, const int* descs_t, int n_t, const int* act_off,
                    int nets, int L0, int L1) {
  Args a = {};
  a.nets = nets;
  a.L[0] = L0;
  a.L[1] = nets > 1 ? L1 : 0;
  const int nl = n_layers(a);
  for (int i = 0; i < nl && i < LAYERS_MAX; ++i) {
    const int* m = descs + 7 * i;
    a.layer[i] = LayerDesc{m[0], m[1], m[2], m[3], m[4], m[5], m[6]};
  }
  for (int i = 0; i < n_t && i < LAYERS_MAX; ++i) {
    const int* m = descs_t + 7 * i;
    a.tl[i] = LayerDesc{m[0], m[1], m[2], m[3], m[4], m[5], m[6]};
  }
  for (int i = 0; i < 1 + L0 + a.L[1] && i < LAYERS_MAX; ++i) a.act_off[i] = act_off[i];
  a.b_len = nl > 0 && nl <= LAYERS_MAX ? a.layer[nl - 1].b + a.layer[nl - 1].n : 0;
  return a;
}

}  // namespace sb
