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
// Design: one block per tile. A float32 (1024, 256) tile is 1 MB, far over
// a block's 227 KB of shared memory, and read from L2 every gather would
// cost a 32-byte sector per 4-byte value, with 256 tiles' worth (up to
// 268 MB) in flight against a 50 MB L2. So the block walks the tile in
// slabs of 16 columns: it stages the slab in shared memory as float32,
// column-major with a row stride of 1025 (a warp's gathers from one column
// land on random banks, and its staging stores on distinct ones), then each
// (row, column) pair runs its n gathers from shared memory; the 16 column
// sums of a row are reduced by shuffles and added to the row's sum in a
// fixed order. Device memory sees h and idx once and out. Bound: bytes,
// P L (4 + dtype bytes) + 4 P (0.080 ms at L = 128 in float32).
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
constexpr int CW = 16;         // X2's slab width (columns)

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
dg_kernel(const T* __restrict__ x, const int* __restrict__ idx, int L,
          int n_gathers, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* slab = reinterpret_cast<float*>(smem_raw);   // [CW][TILE + 1]
  float* rowsum = slab + CW * (TILE + 1);              // [TILE]
  const long long base = (long long)blockIdx.x * TILE;
  const int tid = threadIdx.x;
  for (int r = tid; r < TILE; r += blockDim.x) rowsum[r] = 0.0f;
  for (int c0 = 0; c0 < L; c0 += CW) {
    __syncthreads();
    for (int i = tid; i < TILE * CW; i += blockDim.x) {
      const int r = i / CW, c = i % CW;
      slab[c * (TILE + 1) + r] = sahs::to_f(x[(base + r) * L + c0 + c]);
    }
    __syncthreads();
    // blockDim is a multiple of CW: a thread keeps its column, and the CW
    // lanes of one row are one half warp
    for (int i = tid; i < TILE * CW; i += blockDim.x) {
      const int r = i / CW, c = i % CW;
      const float* col = slab + c * (TILE + 1);
      int j = idx[(base + r) * L + c0 + c] & (TILE - 1);
      float acc = 0.0f;
      for (int n = 0; n < n_gathers; ++n) {
        acc += col[j];
        j = (j + 7) & (TILE - 1);
      }
      for (int off = CW / 2; off > 0; off >>= 1)
        acc += __shfl_down_sync(0xffffffffu, acc, off, CW);
      if (c == 0) rowsum[r] += acc;
    }
  }
  __syncthreads();
  for (int r = tid; r < TILE; r += blockDim.x) out[base + r] = rowsum[r];
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

extern "C" int sahs_exp_dg(const void* x, const void* idx, long long P, int L,
                           int n_gathers, int bf16, void* out, void* stream) {
  if (P <= 0) return 0;
  if (P % TILE || L % CW || L <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)CW * (TILE + 1) + TILE) * sizeof(float);
  auto s = reinterpret_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)(P / TILE);
  const int* ix = reinterpret_cast<const int*>(idx);
  float* o = reinterpret_cast<float*>(out);
  int err;
  if (bf16) {
    err = (int)cudaFuncSetAttribute(dg_kernel<__nv_bfloat16>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem);
    if (err) return err;
    dg_kernel<__nv_bfloat16><<<blocks, THREADS, smem, s>>>(
        reinterpret_cast<const __nv_bfloat16*>(x), ix, L, n_gathers, o);
  } else {
    err = (int)cudaFuncSetAttribute(dg_kernel<float>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem);
    if (err) return err;
    dg_kernel<float><<<blocks, THREADS, smem, s>>>(
        reinterpret_cast<const float*>(x), ix, L, n_gathers, o);
  }
  return (int)cudaGetLastError();
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
