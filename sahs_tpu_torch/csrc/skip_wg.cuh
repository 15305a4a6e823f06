// The deformation nets' forward tile on wgmma: bf16 K1 (deform_pair.cu,
// deform_pair_wg_kernel: the warp and the hyper net on one encoding) and
// bf16 K13 (skip_mlp.cu, skip_wg_kernel: one net, on the raw points or on
// a given encoding).
//
// What the tile computes, per point: the encoding, each net's trunk of L
// ReLU layers (the layer `skip` takes [h ; pe]: two inputs) and its head
// y = act(v + b) in float32 (mlp.cuh's apply_act: tanhf for the warp
// field, linear for the hyper sheet). The encoding is mlp.cuh:pe_group's,
// value for value (the accurate sinf at 2^f x and 2^f x + pi/2), or the
// given bf16 encoding. K1 stores [x + y_warp (round to nearest) | y_hyper]
// and, with a grid, the warped point's corner row (mlp.cuh:cell_row); K13
// stores y. Every product is a bf16 product with float32 sums, each k16
// step summed from zero and added in float32 (PROMOTE 1, wgmma.cuh's
// accumulation), so a point's output depends on its own row alone, not on its
// neighbours or its place in a tile.
//
// Design (wgmma.cuh, as level_train.cu's fw::tile). Persistent blocks, one
// an SM, of two consumer warpgroups and a producer warp. A warpgroup owns a
// 64-point tile and runs every layer as wgmma.m64nNk16 products at N = 128
// (a trunk up to 128 wide: the warp field), 64 (up to 64: the hyper sheet)
// and 8 (the heads), A (the tile's activations: K-major, 128-byte swizzle)
// and B (the weights) from shared memory. The weights stream through a ring
// of stages (wgmma.cuh's Ring): a stage is one 64-k block of a layer's
// outputs (its width rounded up to 64, or the head's 8) laid out ahead of
// time by field_mlp.stage_blob in the order the tile runs its products;
// both warpgroups read each stage, so every weight byte read from L2 serves
// 128 points. K is zero-padded to whole 64-k blocks: the stages' rows past
// K are zero and the encoding's columns past its width are zeroed once, so
// a block's four k-steps need no branch (the 63-wide encoding is one
// block). The front half spreads the encoding over the warpgroup's 128
// threads (two a point, alternate frequencies) and writes it straight into
// the swizzled A tile. A hidden layer's epilogue adds the bias from shared
// memory, applies the ReLU and rounds to bf16 from the accumulator
// registers into the other of two hidden tiles (a trunk is one chunk, so no
// layer writes where its product reads); a head's writes act(v + b) in f32
// to shared memory, and the tile's rows go out once both nets are done,
// consecutive words (coalesced), nothing past P. The layer table is a
// kernel parameter (uniform loads), the roles branch on wg::warpgroup()
// and the arrivals are predicated, so ptxas keeps the wgmma pipelined.
//
// Bound on the H100: K1 ~127,000 multiply-adds a point (warp 98,432, hyper
// 28,672) against 36 bytes (12 in, 20 out, a 4-byte row), so operations:
// 1.08 ms at a frame's fine chunk (4.19 M points) at the 989 TFLOP/s bf16
// peak; K13's warp net 0.83 ms there, its hyper net 0.24. The weights (251
// KB of stages for K1) are read from L2 once per 128 points. Measured on an
// H100 (PERF.md §6, tools/level_ab.py, in turns with the warp-level
// tensor-core kernels it replaced): K1 5.8-5.9 ms at the fine chunk (12.3), 181-183 TFLOP/s,
// 18 % of the bound; K13 warp 4.1-4.3 (8.4), hyper 2.4-2.5 (4.4). ptxas:
// 148 registers, no spill, a 32-byte stack frame (sinf's reduction of huge
// angles). What holds it: each k16 step's float32 adds (summed across a
// 64-k stage, PROMOTE 4, it read 15 % faster; carried over the whole K 27 %,
// and missed a card gate) and the front half (12 % of K1's call, 29 % of
// the hyper net's).
#pragma once

#include "mlp.cuh"
#include "wgmma.cuh"

namespace sk {

using bf16 = __nv_bfloat16;
using wg::KB;
using wg::SLOT;

constexpr int WG = 2;                                // consumer warpgroups
constexpr int THREADS = WG * wg::THREADS + 32;       // and the producer warp
constexpr int TP = wg::ROWS;                         // points a tile
constexpr int HMAX = 128;                            // widest trunk and encoding
constexpr int HEAD = 8;                              // a head's padded width
constexpr int LAYERS_MAX = 16;                       // layers of a launch (K1: 2 (L + 1))
constexpr int RING_MAX = 8;
constexpr int SMEM_MAX = 232448;                     // a block's dynamic shared memory
constexpr int PROMOTE = 1;                           // wgmma.cuh's product: every k16 step,
                                                     // as K3 recomputes it (PERF.md §6)

__host__ __device__ __forceinline__ int cdiv(int x, int y) { return (x + y - 1) / y; }

struct Args {
  sahs::PointSrc pts;    // the raw points (P, 3) or the rays; unread with enc
  const bf16* enc;       // a given encoding (P, pe_dim) (K13 pre-encoded), or null
  const void* wg;        // the weight stages (field_mlp.stage_blob)
  long long wg_bytes;
  const float* b;        // the bias blob, b_len floats
  float* out;            // (P, od) float32
  int* rows;             // (P,) corner rows (K1 with a grid), or null
  long long P;
  int nets;              // 1 (K13: out = y) or 2 (K1: out = [x + y_0[:3] | y_1])
  int L[2];              // trunk layers of each net; net 0's layers first
  int pe_dim, n_freq, od, b_len, gD, gH, gW;
  sahs::LayerDesc layer[LAYERS_MAX];   // the blob's layers (field_mlp.BlobBuilder)
};

__host__ __device__ __forceinline__ int n_layers(const Args& a) {
  return a.L[0] + 1 + (a.nets > 1 ? a.L[1] + 1 : 0);
}
__host__ __device__ __forceinline__ bool is_head(const Args& a, int i) {
  return i == a.L[0] || i == a.L[0] + 1 + a.L[1];
}
// rows of layer i's stage: a head's padded width, else its width rounded
// up to a whole 64-column block
__host__ __device__ __forceinline__ int stage_rows(const Args& a, int i) {
  return is_head(a, i) ? a.layer[i].n : cdiv(a.layer[i].n, KB) * KB;
}
__host__ __device__ __forceinline__ int stage_count(const sahs::LayerDesc& d) {
  return cdiv(d.k1, KB) + (d.w2 >= 0 ? cdiv(d.k2, KB) : 0);
}

// Bytes of the weight stages of one tile: a stage per layer, input and
// 64-k block, stage_rows rows of 128 bytes.
inline long long blob_bytes(const Args& a) {
  long long s = 0;
  for (int i = 0; i < n_layers(a); ++i) s += 128LL * stage_rows(a, i) * stage_count(a.layer[i]);
  return s;
}

// Shared memory, from a 1,024-byte-aligned base: the ring of `ring` slots,
// then each warpgroup's regions: the encoding E [eb blocks of wg::BLOCK,
// 64 points x 128 bytes], the hidden tiles Ha and Hb [hb blocks each], the
// raw points (f32 [TP][3]) and each net's head outputs (f32 [TP][HEAD]),
// padded to 1,024 bytes; then the biases, the barriers, and the slack that
// aligns the base.
struct Layout {
  int eb, hb, per_wg, xs, ys, ring, bias, bar, bytes;
  __host__ __device__ explicit Layout(const Args& a) {
    eb = cdiv(a.pe_dim, KB);
    int h = 0;
    for (int i = 0; i < n_layers(a); ++i)
      if (!is_head(a, i) && a.layer[i].n > h) h = a.layer[i].n;
    hb = cdiv(h, KB);
    xs = (eb + 2 * hb) * wg::BLOCK;
    ys = xs + TP * 3 * 4;
    per_wg = cdiv(ys + 2 * TP * HEAD * 4, 1024) * 1024;
    const int params = cdiv(a.b_len, 4) * 16;
    const int fixed = WG * per_wg + params + 16 * RING_MAX + 1024;
    ring = (SMEM_MAX - fixed) / SLOT;
    if (ring > RING_MAX) ring = RING_MAX;
    bias = ring * SLOT + WG * per_wg;
    bar = bias + params;
    bytes = bar + 16 * RING_MAX + 1024;
  }
};

__device__ __forceinline__ void put(unsigned char* X, int t, int col, float v) {
  *reinterpret_cast<bf16*>(X + wg::sw128(wg::ROWS, t, col)) = __float2bfloat16_rn(v);
}

// The tile's input into E (its columns [0, pe_dim)) and, for K1's
// output, the raw points into Xs. Called by the whole warpgroup; begins
// with the barrier that frees the last tile's regions and ends with E
// visible to wgmma. A: Args, or the backward tile's (skip_bw.cuh), whose
// fields of these names mean the same.
template <class A>
__device__ __forceinline__ void front_half(const A& a, unsigned char* E, float* Xs,
                                           long long base, int t, int bar) {
  wg::bar_sync(bar, wg::THREADS);
  if (a.enc != nullptr) {  // K13 pre-encoded: the rows of the given encoding
    const int dim = a.pe_dim;
    const unsigned short* src = reinterpret_cast<const unsigned short*>(a.enc);
    for (int i = t; i < dim * TP; i += wg::THREADS) {
      const int pt = i / dim, c = i - pt * dim;
      const long long p = base + pt;
      *reinterpret_cast<unsigned short*>(E + wg::sw128(wg::ROWS, pt, c)) =
          p < a.P ? src[p * dim + c] : (unsigned short)0;
    }
  } else {
    // two threads a point: the first writes x, each takes every other
    // frequency, with pe_group's expressions and columns
    const int pt = t % TP, half = t / TP;
    const long long p = base + pt;
    float x[3] = {0.0f, 0.0f, 0.0f};
    if (p < a.P) a.pts.load(p, x);
    if (half == 0) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        put(E, pt, d, x[d]);
        Xs[pt * 3 + d] = x[d];
      }
    }
    for (int f = half; f < a.n_freq; f += 2) {
      const float fr = ldexpf(1.0f, f);
      const int col = 3 + 6 * f;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float xf = __fmul_rn(x[d], fr);
        put(E, pt, col + d, sinf(xf));
        put(E, pt, col + 3 + d, sinf(__fadd_rn(xf, SAHS_HALF_PI_F)));
      }
    }
  }
  wg::fence_async();
  wg::bar_sync(bar, wg::THREADS);
}

// A hidden layer's epilogue: relu(d + b) in bf16 into columns [0, N) of
// the K-major tile at shared address `dst` (with GUARD zero from n on);
// thread t holds D[r0 + 8 i][8 j + 2 q + c] in d[4 j + 2 i + c]
// (wgmma.cuh), stored two columns a 4-byte word.
template <int N, bool GUARD>
__device__ __forceinline__ void store_hidden(const float (&d)[N / 2], uint32_t dst,
                                             const float* bias, int n, int t) {
  const int l = t % 32, q = l % 4;
  const int r0 = 16 * (t / 32) + l / 4, sw = r0 & 7;
  const uint32_t row = dst + r0 * 128 + 4 * q;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = 8 * j + 2 * q;
    const bool ok = !GUARD || col < n;  // n even: col + 1 with col
    const float2 b = ok ? *reinterpret_cast<const float2*>(bias + col) : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float v0 = fmaxf(d[4 * j + 2 * i] + b.x, 0.0f);
      const float v1 = fmaxf(d[4 * j + 2 * i + 1] + b.y, 0.0f);
      const __nv_bfloat162 hv = __floats2bfloat162_rn(ok ? v0 : 0.0f, ok ? v1 : 0.0f);
      wg::sts32(row + i * 1024 + (j >> 3) * wg::BLOCK + (((j & 7) ^ sw) << 4),
                *reinterpret_cast<const uint32_t*>(&hv));
    }
  }
}

template <int N>
__device__ __forceinline__ void hidden_layer(const wg::ASrc& s1, const wg::ASrc& s2,
                                             wg::Ring& rg, uint32_t dst, const float* bias,
                                             int n, int lane, int t) {
  float d[N / 2];
  wg::product<N, PROMOTE>(d, s1, s2, rg, lane);
  if (n % N) store_hidden<N, true>(d, dst, bias, n, t);
  else store_hidden<N, false>(d, dst, bias, n, t);
}

// A head: y = act(v + b) in f32 to Y [TP][HEAD].
__device__ __forceinline__ void head_layer(const wg::ASrc& s1, wg::Ring& rg, float* Y,
                                           const float* bias, int act, int lane, int t) {
  float d[HEAD / 2];
  const wg::ASrc none = {0u, 0u, 0};
  wg::product<HEAD, PROMOTE>(d, s1, none, rg, lane);
  const int l = t % 32, q = l % 4;
  const int r0 = 16 * (t / 32) + l / 4;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    *reinterpret_cast<float2*>(Y + (r0 + 8 * i) * HEAD + 2 * q) =
        make_float2(sahs::apply_act(d[2 * i] + bias[2 * q], act),
                    sahs::apply_act(d[2 * i + 1] + bias[2 * q + 1], act));
}

// The tile's rows below P: K1's [x + y_0[:3] | y_1[:od - 3]] and corner
// rows, or K13's y_0[:od], as consecutive words of out.
__device__ __forceinline__ void store_out(const Args& a, const float* Xs, const float* Y,
                                          long long base, int t) {
  const int od = a.od;
  const long long n = a.P - base < TP ? a.P - base : TP;
  float* out = a.out + base * od;
  if (a.nets == 1) {
    for (int i = t; i < n * od; i += wg::THREADS) out[i] = Y[(i / od) * HEAD + i % od];
    return;
  }
  const float* Y1 = Y + TP * HEAD;
  for (int i = t; i < n * od; i += wg::THREADS) {
    const int pt = i / od, c = i - pt * od;
    out[i] = c < 3 ? __fadd_rn(Xs[pt * 3 + c], Y[pt * HEAD + c]) : Y1[pt * HEAD + c - 3];
  }
  if (a.rows != nullptr && t < n) {
    float w[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) w[c] = __fadd_rn(Xs[t * 3 + c], Y[t * HEAD + c]);
    a.rows[base + t] = sahs::cell_row(w, a.gD, a.gH, a.gW);
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
  const int nl = n_layers(a);
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
        const unsigned char* src = reinterpret_cast<const unsigned char*>(a.wg);
        for (int i = 0; i < nl; ++i) {
          const uint32_t bytes = 128u * stage_rows(a, i);
          for (int s = stage_count(a.layer[i]); s > 0; --s) {
            rg.push(src, bytes);
            src += bytes;
          }
        }
      }
    }
    return;
  }

  // a consumer warpgroup
  const int t = tid % wg::THREADS, bar = 1 + g;
  unsigned char* E = base + ly.ring * SLOT + g * ly.per_wg;
  unsigned char* Ha = E + ly.eb * wg::BLOCK;
  unsigned char* Hb = Ha + ly.hb * wg::BLOCK;
  float* Xs = reinterpret_cast<float*>(E + ly.xs);
  float* Ys = reinterpret_cast<float*>(E + ly.ys);
  for (int i = t; i < (ly.eb * KB - a.pe_dim) * TP; i += wg::THREADS)
    put(E, i % TP, a.pe_dim + i / TP, 0.0f);  // the K padding of the encoding
  const uint32_t e = wg::smem_u32(E), ha = wg::smem_u32(Ha), hb = wg::smem_u32(Hb);
  auto region = [](uint32_t at, int k) { return wg::ASrc{at, at + 2 * wg::BLOCK, cdiv(k, KB)}; };
  const wg::ASrc none = {0u, 0u, 0};
  for (long long pr = blockIdx.x; pr < pairs; pr += gridDim.x) {
    // a warpgroup past the last tile runs on zeros and writes nothing
    const long long pbase = (pr * WG + g) * TP;
    front_half(a, E, Xs, pbase, t, bar);
    int i = 0;
    bool in_b = false;  // Hb (else Ha) holds the last hidden output (the
                        // hyper net's first layer writes the other tile
                        // than the one the warp head reads)
    for (int net = 0; net < a.nets; ++net) {
      for (int l = 0; l < a.L[net]; ++l, ++i) {
        const sahs::LayerDesc& d = a.layer[i];
        const wg::ASrc s1 = l == 0 ? region(e, d.k1) : region(in_b ? hb : ha, d.k1);
        const wg::ASrc s2 = d.w2 >= 0 ? region(e, d.k2) : none;
        const uint32_t dst = in_b ? ha : hb;
        if (d.n > KB) hidden_layer<2 * KB>(s1, s2, rg, dst, bias_s + d.b, d.n, lane, t);
        else hidden_layer<KB>(s1, s2, rg, dst, bias_s + d.b, d.n, lane, t);
        in_b = !in_b;
        wg::fence_async();
        wg::bar_sync(bar, wg::THREADS);
      }
      const sahs::LayerDesc& d = a.layer[i++];
      head_layer(region(in_b ? hb : ha, d.k1), rg, Ys + net * TP * HEAD, bias_s + d.b,
                 d.act, lane, t);
    }
    wg::bar_sync(bar, wg::THREADS);
    if (pbase < a.P) store_out(a, Xs, Ys, pbase, t);
  }
}

// The host side of a launch: refuses widths the tile does not take and a
// weight blob that is not the tile's stages; persistent blocks, one an SM.
inline bool takes(const Args& a) {
  if (a.nets < 1 || a.nets > 2 || a.L[0] < 1 || (a.nets > 1 && a.L[1] < 1) ||
      n_layers(a) > LAYERS_MAX || a.pe_dim < 1 || a.pe_dim > HMAX || a.od < 1)
    return false;
  for (int i = 0; i < n_layers(a); ++i) {
    const sahs::LayerDesc& d = a.layer[i];
    if (d.k1 > HMAX || d.k2 > HMAX || (d.w2 >= 0) != (d.k2 > 0)) return false;
    if (is_head(a, i) ? d.n != HEAD
                      : (d.n % 32 || d.n > HMAX || d.act != sahs::ACT_RELU))
      return false;
  }
  return true;
}

template <class K>
int launch(K kernel, const Args& a, cudaStream_t stream) {
  const Layout ly(a);
  if (!takes(a) || ly.ring < 2 || a.wg == nullptr || a.wg_bytes != blob_bytes(a))
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

// The Args of a launch from the blob's layer table (n_layers descriptors
// of 7 ints, host memory); the caller fills the rest.
inline Args args_of(const int* descs, int nets, int L0, int L1) {
  Args a = {};
  a.nets = nets;
  a.L[0] = L0;
  a.L[1] = nets > 1 ? L1 : 0;
  const int nl = n_layers(a);
  for (int i = 0; i < nl && i < LAYERS_MAX; ++i) {
    const int* m = descs + 7 * i;
    a.layer[i] = sahs::LayerDesc{m[0], m[1], m[2], m[3], m[4], m[5], m[6]};
  }
  a.b_len = nl > 0 && nl <= LAYERS_MAX ? a.layer[nl - 1].b + a.layer[nl - 1].n : 0;
  return a;
}

}  // namespace sk
