// X1, X2, X3: the kernels of the gather experiments, on the H100.
//
// X1 replaces tools/exp_gather.py:make_chain (:52, pallas_call at :63): a
// bare chain h <- bf16(relu(h @ W)), n_layers times with the same (H, H)
// bf16 weight W, float32 accumulation, over (P, H) bf16 rows; out[p] is the
// float32 sum of row p's last activation. It is the NeRF trunk's layer
// product with nothing else in the kernel (H = 256 or 512). Bound:
// operations, 2 P H^2 n (0.28 ms at 8 x 256 over 262,144 rows at the 989
// TFLOP/s bf16 peak); the bytes in and out are 1/2000 of it.
// Design (wgmma.cuh): persistent blocks, one an SM, of two consumer
// warpgroups and one producer warp. A warpgroup owns a 64-row tile and
// runs each layer as H / 16 wgmma.m64n256k16 products, A (the tile's
// activations) and B (W, MN-major, no transpose) both from shared memory;
// the ReLU, the bf16 rounding and the store back into the tile, in the
// swizzled layout the next layer's A descriptor reads, run in the epilogue
// from the accumulator registers; the last layer sums its rows there. The
// producer warp stages every tile by TMA (rows past P arrive as zeros and
// are not written) when its warpgroup has freed the buffer; the other
// warpgroup's products cover the wait.
//   - H = 256: W (128 KB) is loaded once and stays; the tiles (2 x 32 KB)
//     are overwritten in place after the layer's products; 192 KB.
//   - H = 512: W (512 KB) cannot stay. The output is two N = 256 halves;
//     the 64-row x 256-column halves of the activations alternate between
//     the tile's first four 64-column blocks and a second buffer (lo), so
//     the first half's result is stored while the second half's products
//     still read the input, and the second half's result overwrites the
//     tile's last four blocks once its products are done. W streams through
//     a 4-stage TMA ring of 16 k rows x 256 columns (8 KB), both warpgroups
//     reading each stage, so every W byte read from L2 serves 128 rows:
//     W 32 KB + tiles 2 x 64 KB + lo 2 x 32 KB = 224 KB of the 227 KB.
// The roles branch on wg::warpgroup() (uniform across a warp) and the
// barrier arrivals between products are predicated: a divergent branch
// made ptxas serialise every wgmma (warning C7520), and X1 took 1.19-1.27x
// the time (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md).
//
// X2 replaces make_dg (:78, pallas_call at :91): within each 1024-row
// tile of h (P, L), n_gathers gathers g[r, c] = h[idx[r, c], c] summed in
// float32, idx <- (idx + 7) mod 1024 after each, and out[r] the row sum.
// Bound: bytes, the entries of h the gathers touch, idx once, and out
// (0.066 ms at L = 128, one gather, float32: 63 % of h is touched).
// Design: a gather reaches anywhere in its tile, so a stage holds all 1024
// rows of a group of columns: 64 bytes of h a row (16 float32 or 32 bf16
// columns), 64 KB. One persistent block an SM walks its tiles' groups
// through a ring of 3 such stages in shared memory (192 KB), filled by TMA
// (a 2-D map, four 256-row boxes a stage), so the next groups' bytes are
// in flight while one group is gathered; a __syncthreads frees a stage for
// its next load. idx is read once, so it bypasses shared memory: the lanes
// that use a row's indices load them from device memory (64 bytes a row,
// one request a warp) for 32 rows at a time.
// The stage keeps h row-major, 16 words a row, so the word (row j, column
// word c) lies in bank 16 (j mod 2) + c. A warp takes one row at a time:
// lane (q, c), q < 2, gathers column word c for the gathers k = q, q + 2,
// ... (j + 7 k is odd for one q and even for the other: the 32 lanes hit
// 32 banks); with one gather lane (q, c) takes row r + q. Each lane sums
// its gathers of 32 rows in registers, and a butterfly of 31 shuffles (15
// for two rows a step) leaves lane l the sum of one row; the rows' sums
// over the groups stay in registers until the tile ends. Every sum runs in
// a fixed order. Measured on an H100 (PERF.md): a first design, 32-byte rows
// with idx staged beside them by TMA, read 1.02-1.17x this one's time, and
// with the boxes' L2 misses promoted to 256-byte lines 1.26-1.38x its own
// time at 128 (the promoted lines of 132 SMs' tiles overflow the 50 MB L2
// before the next groups use them).
//
// X3 replaces make_chunk (:106, pallas_call at :122): out[r] =
// sum_c tab[idx[r, c], c] over the (N, L) table, which arrives as
// (N / 1024, 1024, L); an idx outside [0, N) contributes 0, as the TPU
// kernel's chunk select gives it. The TPU kernel kept the table in VMEM and
// selected among 32 chunked in-tile gathers; here the table (8-16 MB) stays
// L2-resident and each warp gathers a row's values from it directly, then
// reduces them by shuffles. Bound: bytes, 4 P L + N L (dtype) + 4 P
// (0.045 ms at L = 128 in float32).
//
// The TPU's chunk-select loop, 128-lane pads and scan/eps anti-hoisting do
// not carry over: the caller adds eps to the input before the launch.
#include "mlp.cuh"
#include "wgmma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 1024;     // X2's gather tile

// X2
constexpr int DG_WORDS = 16;                  // 4-byte words of h a row of a stage
constexpr int DG_PHASES = 32 / DG_WORDS;      // lanes on one column word
constexpr int DG_BOX = 256;                   // rows of one TMA box
// an L2 miss of a box fetches the 128-byte line: the next group reads the
// rest of it
constexpr CUtensorMapL2promotion DG_PROMOTION = CU_TENSOR_MAP_L2_PROMOTION_L2_128B;
constexpr int DG_BATCHES = TILE / (THREADS / 32) / 32;  // 32-row batches a warp a stage

template <typename T>
struct DgPlan {
  static constexpr int COLS = DG_WORDS * 4 / (int)sizeof(T);  // columns a stage
  static constexpr int STAGE_B = TILE * DG_WORDS * 4;         // h: 64 KB
  static constexpr int STAGES = 3;
  // + the barriers, + the slack that aligns the base to 128 bytes
  static constexpr int BYTES = STAGES * STAGE_B + 8 * STAGES + 128;
};

// X1
constexpr int CH = 256;                             // output columns a product
constexpr int X1_WG = 2;                            // consumer warpgroups
constexpr int X1_THREADS = X1_WG * wg::THREADS + 32;  // and the producer warp
constexpr int RING_K = 16;                          // k rows a W stage (H = 512)
constexpr int RING = 4;                             // W stages

template <int H>
struct ChainPlan {
  static constexpr bool RESIDENT = H <= CH;         // W stays in shared memory
  static constexpr int NCH = H / CH;                // output halves of 256
  static constexpr int TILE_B = wg::ROWS * H * 2;   // a warpgroup's activations
  static constexpr int W_B = RESIDENT ? H * H * 2 : RING * RING_K * CH * 2;
  static constexpr int LO_B = NCH > 1 ? wg::ROWS * CH * 2 : 0;
  static constexpr int STAGE_B = RING_K * CH * 2;   // a W stage (H = 512)
  // + barriers, + the slack that aligns the base to 1,024 bytes
  static constexpr int BYTES = W_B + X1_WG * (TILE_B + LO_B) + 8 * (2 * RING + 2 * X1_WG) + 1024;
};

struct Relu {
  __device__ __forceinline__ float operator()(float v) const { return fmaxf(v, 0.0f); }
};

template <int H>
__global__ void __launch_bounds__(X1_THREADS, 1)
chain_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
             long long P, int n_layers, float* __restrict__ out) {
  using C = ChainPlan<H>;
  extern __shared__ __align__(1024) unsigned char x1_smem[];
  unsigned char* w = x1_smem + ((1024 - (wg::smem_u32(x1_smem) & 1023)) & 1023);
  unsigned char* tiles = w + C::W_B;                   // [X1_WG][TILE_B]
  unsigned char* los = tiles + X1_WG * C::TILE_B;      // [X1_WG][LO_B]
  uint64_t* full = reinterpret_cast<uint64_t*>(los + X1_WG * C::LO_B);  // [RING]
  uint64_t* empty = full + RING;                       // [RING]
  uint64_t* afull = empty + RING;                      // [X1_WG]
  uint64_t* aempty = afull + X1_WG;                    // [X1_WG]
  const int tid = threadIdx.x, g = wg::warpgroup();
  const long long n_tiles = (P + wg::ROWS - 1) / wg::ROWS;
  const long long pairs = (n_tiles + X1_WG - 1) / X1_WG;
  if (tid == 0) {
    for (int s = 0; s < RING; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], 4 * X1_WG);             // every consumer warp
    }
    for (int q = 0; q < X1_WG; ++q) {
      wg::mbar_init(&afull[q], 1);
      wg::mbar_init(&aempty[q], 4);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (g == X1_WG) {  // the producer warp: every TMA load
    if (tid % 32 == 0) {
      if constexpr (C::RESIDENT) {
        wg::mbar_expect(&full[0], H * H * 2);
        for (int nb = 0; nb < H / 64; ++nb) wg::tma_load(w + nb * H * 128, &tw, &full[0], nb * 64, 0);
      }
      int stage = 0;
      uint32_t phase = 0;
      int it = 0;
      for (long long pr = blockIdx.x; pr < pairs; pr += gridDim.x, ++it) {
        for (int q = 0; q < X1_WG; ++q) {
          // a warpgroup past the last tile repeats it (its sums are not stored)
          const long long tile = min(pr * X1_WG + q, n_tiles - 1);
          wg::mbar_wait(&aempty[q], (it & 1) ^ 1);
          wg::mbar_expect(&afull[q], C::TILE_B);
          for (int kb = 0; kb < H / 64; ++kb)
            wg::tma_load(tiles + q * C::TILE_B + kb * wg::BLOCK, &tx, &afull[q], kb * 64,
                         (int)(tile * wg::ROWS));
        }
        if constexpr (!C::RESIDENT) {
          for (int layer = 0; layer < n_layers; ++layer)
            for (int c = 0; c < C::NCH; ++c)
              for (int ks = 0; ks < H / RING_K; ++ks) {
                wg::mbar_wait(&empty[stage], phase ^ 1);
                wg::mbar_expect(&full[stage], C::STAGE_B);
                unsigned char* dst = w + stage * C::STAGE_B;
                for (int nb = 0; nb < CH / 64; ++nb)
                  wg::tma_load(dst + nb * RING_K * 128, &tw, &full[stage], c * CH + nb * 64,
                               ks * RING_K);
                if (++stage == RING) { stage = 0; phase ^= 1; }
              }
        }
      }
    }
    return;
  }

  // a consumer warpgroup
  const int t = tid % wg::THREADS, lane = t % 32;
  unsigned char* tile = tiles + g * C::TILE_B;
  unsigned char* lo = los + g * C::LO_B;
  const uint32_t w_s = wg::smem_u32(w);
  if constexpr (C::RESIDENT) wg::mbar_wait(&full[0], 0);
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  int it = 0;
  float d[CH / 2];
  for (long long pr = blockIdx.x; pr < pairs; pr += gridDim.x, ++it) {
    const long long tile_i = pr * X1_WG + g;
    wg::mbar_wait(&afull[g], it & 1);
    float s0 = 0.0f, s1 = 0.0f;  // the sums of rows r0 and r0 + 8
    for (int layer = 0; layer < n_layers; ++layer) {
      const bool last = layer == n_layers - 1;
      // columns 0-255 of this layer's input, and where its output's go
      unsigned char* in_lo = (C::NCH > 1 && (layer & 1)) ? lo : tile;
      unsigned char* out_lo = (C::NCH > 1 && !(layer & 1)) ? lo : tile;
      for (int c = 0; c < C::NCH; ++c) {
        wg::fence_operand(d);
        wg::fence();
#pragma unroll 4
        for (int ks = 0; ks < H / 16; ++ks) {
          const uint64_t da = wg::a_desc(wg::smem_u32(ks < CH / 16 ? in_lo : tile), ks);
          if constexpr (C::RESIDENT) {
            wg::mma<CH, 1>(d, da, wg::b_desc(w_s, ks, H * 128), ks > 0);
          } else {
            wg::mbar_wait(&full[stage], phase);
            wg::fence();
            wg::mma<CH, 1>(d, da, wg::b_desc(w_s + stage * C::STAGE_B, 0, RING_K * 128), ks > 0);
            wg::commit();
            wg::wait<1>();  // the previous stage's product is done
            wg::mbar_arrive(&empty[prev], ks > 0 && lane == 0);
            prev = stage;
            if (++stage == RING) { stage = 0; phase ^= 1; }
          }
        }
        if constexpr (C::RESIDENT) wg::commit();
        wg::wait<0>();
        wg::fence_operand(d);
        if constexpr (!C::RESIDENT) wg::mbar_arrive(&empty[prev], lane == 0);
        if (last) {
#pragma unroll
          for (int j = 0; j < CH / 8; ++j) {
            s0 += __bfloat162float(__float2bfloat16_rn(Relu()(d[4 * j])));
            s0 += __bfloat162float(__float2bfloat16_rn(Relu()(d[4 * j + 1])));
            s1 += __bfloat162float(__float2bfloat16_rn(Relu()(d[4 * j + 2])));
            s1 += __bfloat162float(__float2bfloat16_rn(Relu()(d[4 * j + 3])));
          }
        } else {
          // the last half overwrites what every warp's products read
          if (c == C::NCH - 1) wg::bar_sync(1 + g, wg::THREADS);
          wg::store_acc<CH>(d, c == 0 ? out_lo : tile, c * CH, Relu());
        }
      }
      if (!last) {
        wg::fence_async();
        wg::bar_sync(1 + g, wg::THREADS);
      }
    }
    wg::mbar_arrive(&aempty[g], lane == 0);  // the tile may be loaded again
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    if (lane % 4 == 0 && tile_i < n_tiles) {
      const long long row = tile_i * wg::ROWS + 16 * (t / 32) + lane / 4;
      if (row < P) out[row] = s0;
      if (row + 8 < P) out[row + 8] = s1;
    }
  }
}

template <int H>
int launch_chain(const CUtensorMap& tx, const CUtensorMap& tw, long long P, int n_layers,
                 float* out, cudaStream_t stream) {
  int err = (int)cudaFuncSetAttribute(chain_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      ChainPlan<H>::BYTES);
  int dev = 0, sms = 0;
  if (!err) err = (int)cudaGetDevice(&dev);
  if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return err;
  const long long pairs = ((P + wg::ROWS - 1) / wg::ROWS + X1_WG - 1) / X1_WG;
  chain_kernel<H><<<(unsigned)(pairs < sms ? pairs : sms), X1_THREADS, ChainPlan<H>::BYTES,
                    stream>>>(tx, tw, P, n_layers, out);
  return (int)cudaGetLastError();
}

// value of column 2 c + HI of the bf16 word w, or the float32 word w
template <typename T, int HI>
__device__ __forceinline__ float dg_val(uint32_t w) {
  if constexpr (sizeof(T) == 4) return __uint_as_float(w);
  else return __uint_as_float(HI ? (w & 0xffff0000u) : (w << 16));
}

// One level of the butterfly below: lanes l and l ^ O exchange halves,
// and each keeps the sum of the half its bit O selects (O a compile-time
// constant at every level, so v stays in registers).
template <int O, int S>
__device__ __forceinline__ void dg_fold(float (&v)[S], int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int k = 0; k < O; ++k) {
    const float send = up ? v[k] : v[k + O];
    const float keep = up ? v[k + O] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
  if constexpr (O > 1) dg_fold<O / 2, S>(v, lane);
}

// sum over the warp's lanes of v[k], k < S, for the S = 32 / RPS steps of
// a batch: lane l ends with step l % S's (lanes l and l ^ o, o < S, are
// summed; with RPS = 4 the lanes of one q). Fixed order.
template <int S>
__device__ __forceinline__ float dg_transpose_sum(float (&v)[S], int lane) {
  dg_fold<S / 2, S>(v, lane);
  return v[0];
}

// RPS rows a warp step: 1 (the lanes of a column word split the gathers,
// n_gathers >= DG_PHASES) or DG_PHASES (a lane a row, all the gathers)
template <typename T, int RPS>
__global__ void __launch_bounds__(THREADS, 1)
dg_kernel(const __grid_constant__ CUtensorMap tx, const int* __restrict__ idx,
          int n_tiles, int L, int n_gathers, float* __restrict__ out) {
  using C = DgPlan<T>;
  constexpr int S = 32 / RPS;
  extern __shared__ __align__(128) unsigned char x2_smem[];
  unsigned char* ring = x2_smem + ((128 - (wg::smem_u32(x2_smem) & 127)) & 127);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::STAGES * C::STAGE_B);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q = lane / DG_WORDS, c = lane % DG_WORDS;
  const int groups = L / C::COLS;
  const int my_tiles = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int units = my_tiles * groups;       // (tile, column group), tile-major
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) wg::mbar_init(&full[s], 1);
    wg::mbar_fence_init();
  }
  __syncthreads();
  auto issue = [&](int u) {                  // thread 0: unit u into its stage
    unsigned char* st = ring + (u % C::STAGES) * C::STAGE_B;
    uint64_t* bar = &full[u % C::STAGES];
    const int row0 = ((int)blockIdx.x + (u / groups) * (int)gridDim.x) * TILE;
    const int col0 = (u % groups) * C::COLS;
    wg::mbar_expect(bar, C::STAGE_B);
#pragma unroll
    for (int b = 0; b < TILE / DG_BOX; ++b) {
      wg::tma_load(st + b * DG_BOX * DG_WORDS * 4, &tx, bar, col0, row0 + b * DG_BOX);
    }
  };
  if (tid == 0)
    for (int u = 0; u < C::STAGES && u < units; ++u) issue(u);

  // the gathers k = first, first + step, ... of a lane
  const int first = RPS == 1 ? q : 0, step = RPS == 1 ? DG_PHASES : 1;
  float rowsum[DG_BATCHES];
#pragma unroll
  for (int b = 0; b < DG_BATCHES; ++b) rowsum[b] = 0.0f;
  for (int u = 0; u < units; ++u) {
    const int s = u % C::STAGES;
    wg::mbar_wait(&full[s], (uint32_t)(u / C::STAGES) & 1u);
    const uint32_t* xw = reinterpret_cast<const uint32_t*>(ring + s * C::STAGE_B);
    const int* ix = idx + (((long long)blockIdx.x + (u / groups) * (long long)gridDim.x) * TILE) * L
                    + (u % groups) * C::COLS;
#pragma unroll
    for (int b = 0; b < DG_BATCHES; ++b) {
      const int r0 = warp * (TILE / (THREADS / 32)) + b * 32 + (RPS == 1 ? 0 : q);
      float v[S];
      int ja[S], jb[S];
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const int r = r0 + k * RPS;
        v[k] = 0.0f;
        if constexpr (sizeof(T) == 4) {
          ja[k] = ix[(long long)r * L + c];
        } else {
          const int2 j2 = *reinterpret_cast<const int2*>(ix + (long long)r * L + 2 * c);
          ja[k] = j2.x;
          jb[k] = j2.y;
        }
      }
      for (int g = first; g < n_gathers; g += step) {
#pragma unroll
        for (int k = 0; k < S; ++k) {
          v[k] += dg_val<T, 0>(xw[((ja[k] + 7 * g) & (TILE - 1)) * DG_WORDS + c]);
          if constexpr (sizeof(T) == 2)
            v[k] += dg_val<T, 1>(xw[((jb[k] + 7 * g) & (TILE - 1)) * DG_WORDS + c]);
        }
      }
      rowsum[b] += dg_transpose_sum<S>(v, lane);
    }
    __syncthreads();                          // every warp is done with stage s
    if (tid == 0 && u + C::STAGES < units) issue(u + C::STAGES);
    if ((u + 1) % groups == 0) {              // the tile's last group: its row sums
      const long long row0 = ((long long)blockIdx.x + (u / groups) * (long long)gridDim.x) * TILE;
      const int l = RPS == 1 ? lane : (lane % S) * RPS + lane / S;
#pragma unroll
      for (int b = 0; b < DG_BATCHES; ++b) {
        out[row0 + warp * (TILE / (THREADS / 32)) + b * 32 + l] = rowsum[b];
        rowsum[b] = 0.0f;
      }
    }
  }
}

template <typename T>
int launch_dg(const CUtensorMap& tx, const int* idx, int n_tiles, int L, int n_gathers,
              float* out, cudaStream_t stream) {
  int err = (int)cudaFuncSetAttribute(dg_kernel<T, 1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      DgPlan<T>::BYTES);
  if (!err)
    err = (int)cudaFuncSetAttribute(dg_kernel<T, DG_PHASES>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, DgPlan<T>::BYTES);
  int dev = 0, sms = 0;
  if (!err) err = (int)cudaGetDevice(&dev);
  if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return err;
  const unsigned blocks = (unsigned)(n_tiles < sms ? n_tiles : sms);
  if (n_gathers >= DG_PHASES)
    dg_kernel<T, 1><<<blocks, THREADS, DgPlan<T>::BYTES, stream>>>(tx, idx, n_tiles, L, n_gathers,
                                                                   out);
  else
    dg_kernel<T, DG_PHASES><<<blocks, THREADS, DgPlan<T>::BYTES, stream>>>(tx, idx, n_tiles, L,
                                                                           n_gathers, out);
  return (int)cudaGetLastError();
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
chunk_kernel(const T* __restrict__ tab, long long N, const int* __restrict__ idx,
             long long P, int L, float* __restrict__ out) {
  const long long row = (long long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= P) return;
  float acc = 0.0f;
  for (int c = lane; c < L; c += 32) {
    const int j = idx[row * L + c];
    if (j >= 0 && j < N) acc += sahs::to_f(tab[(long long)j * L + c]);
  }
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[row] = acc;
}

}  // namespace

// X1: zero_bias is kept in the signature and not read (the chain has no
// bias); H is 256 or 512.
extern "C" int sahs_exp_chain(const void* x, long long P, int H, const void* w,
                              const void* zero_bias, int n_layers, void* out,
                              void* stream) {
  (void)zero_bias;
  if (P <= 0) return 0;
  if ((H != 256 && H != 512) || n_layers < 1) return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  int err = wg::make_map(&tx, x, P, H, 2LL * H, wg::ROWS);
  if (!err) err = wg::make_map(&tw, w, H, H, 2LL * H, H <= CH ? H : RING_K);
  if (err) return err;
  auto s = reinterpret_cast<cudaStream_t>(stream);
  float* o = reinterpret_cast<float*>(out);
  return H == 256 ? launch_chain<256>(tx, tw, P, n_layers, o, s)
                  : launch_chain<512>(tx, tw, P, n_layers, o, s);
}

// X2: x and idx 16-byte aligned, P a multiple of 1024 below 2^31 (TMA's
// coordinates), L a multiple of a stage's columns (16 float32, 32 bf16)
extern "C" int sahs_exp_dg(const void* x, const void* idx, long long P, int L,
                           int n_gathers, int bf16, void* out, void* stream) {
  if (P <= 0) return 0;
  const int esize = bf16 ? 2 : 4, cols = DG_WORDS * 4 / esize;
  if (P % TILE || P >= (1LL << 31) || L % cols || L <= 0 || n_gathers < 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx;
  int err = wg::make_map_of(&tx, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                            x, P, L, (long long)L * esize, cols, DG_BOX, CU_TENSOR_MAP_SWIZZLE_NONE,
                            DG_PROMOTION);
  if (err) return err;
  auto s = reinterpret_cast<cudaStream_t>(stream);
  float* o = reinterpret_cast<float*>(out);
  const int* ix = reinterpret_cast<const int*>(idx);
  const int n_tiles = (int)(P / TILE);
  return bf16 ? launch_dg<__nv_bfloat16>(tx, ix, n_tiles, L, n_gathers, o, s)
              : launch_dg<float>(tx, ix, n_tiles, L, n_gathers, o, s);
}

extern "C" int sahs_exp_chunk(const void* tab, long long N, const void* idx,
                              long long P, int L, int bf16, void* out,
                              void* stream) {
  if (P <= 0) return 0;
  if (L <= 0) return (int)cudaErrorInvalidValue;
  auto s = reinterpret_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((P + THREADS / 32 - 1) / (THREADS / 32));
  const int* ix = reinterpret_cast<const int*>(idx);
  float* o = reinterpret_cast<float*>(out);
  if (bf16)
    chunk_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(
        reinterpret_cast<const __nv_bfloat16*>(tab), N, ix, P, L, o);
  else
    chunk_kernel<float><<<blocks, THREADS, 0, s>>>(
        reinterpret_cast<const float*>(tab), N, ix, P, L, o);
  return (int)cudaGetLastError();
}
