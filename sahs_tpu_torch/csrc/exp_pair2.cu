// X4, X5, X6: the kernels of the two-points-a-row experiment, on the H100.
//
// Each computes 6 layers of h <- bf16(tanh(h @ W_i)), float32 accumulation.
// The question they answer on this card: does a 64-wide layer chain lose
// its rate against a 128-wide one (two 64-wide nets paired into one
// product, as K1 pairs the warp and hyper nets)?
//
// X4 replaces tools/exp_pair2.py:narrow_call (:56, pallas_call at :66): the
// chain at width 64 on x[:, :64] of a (P, 128) input, written to a (P, 128)
// output whose right half is zero. Bound: bytes, the 2 P 64 bytes of
// x[:, :64] it reads and the 2 P 128 of its output (0.030 ms at 262,144
// rows).
// X5 replaces paired_call (:79, pallas_call at :89): the chain at width 128
// on (P / 2, 128) rows with dense (128, 128) weights; the kernel assumes no
// block-diagonal structure. Bound: operations, 2 (P / 2) 128^2 6 (0.026 ms).
// X6 replaces reshape_call (:102, pallas_call at :118): X5 whose rows are
// [x[2r, :64] | x[2r + 1, :64]] of the (P, 128) input. The TPU kernel built
// them by a reshape or by strided slices; both give these rows, so one form
// serves both modes here. Bound: X5's operations (0.026 ms); the bytes,
// x[:, :64] read and the (P / 2, 128) output written, take 0.020 ms.
//
// Design (wgmma.cuh): persistent blocks, one an SM; each warpgroup owns its
// own 64-row tiles and runs a layer as H / 16 wgmma.m64nHk16 products, A
// (the tile) and B (W_i, MN-major) from shared memory, tanh, the bf16
// rounding and the store back into the tile (the next layer's A) in the
// epilogue. The six weights stay in shared memory, loaded once by TMA. A
// warpgroup's tiles arrive by TMA (rows past the end as zeros) and leave
// by TMA stores (rows past the end not written); X6's rows are paired by
// the load itself: x seen as (P / 2, 256) rows, the boxes at columns 0
// and 128. X4's right half is stored from a block of zeros.
//   - X4 (H = 64): W 48 KB; four warpgroups with two tile buffers each
//     (8 KB): the next tile loads while this one is multiplied; 120 KB.
//   - X5, X6 (H = 128): W 192 KB; two warpgroups with one 16 KB buffer
//     each (224 KB): a warpgroup waits for its next tile while the other
//     computes. Streaming the weights by layer would free room for more
//     buffers at the cost of 192 KB read from L2 a tile.
// The tanh of every epilogue (100 M a call at X5's size) costs about as
// much as the products: tanhf read X5 0.14 ms, tanh.approx.f32 (one SFU
// operation, ~2^-11 relative) 0.07 ms but missed the 1e-3 L2 gate against
// the plain version (1.2e-3), so the kernels take the form below (one SFU
// operation and FMAs, 0.10 ms; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md).
#include "wgmma.cuh"

namespace {

constexpr int IN_W = 128;      // the input's and the output's row width
enum { ROWS = 0, PAIRED = 1 };

// tanh(x) = sign(x) (1 - e) / (1 + e), e = 2^(-2 |x| log2(e)) by
// ex2.approx (one SFU operation), 1 / (1 + e) on (1, 2] by a linear
// start within 1/17 and three Newton steps: a few 1e-7 from tanh.
struct Tanh {
  __device__ __forceinline__ float operator()(float x) const {
    float e;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(fabsf(x) * -2.88539008f));
    const float d = 1.0f + e;
    float r = fmaf(-0.470588235f, d, 1.41176471f);
#pragma unroll
    for (int i = 0; i < 3; ++i) r = fmaf(r, fmaf(-d, r, 1.0f), r);
    return copysignf(fmaf(-e, r, r), x);
  }
};

template <int H>
struct PairPlan {
  static constexpr int WG = H == 64 ? 4 : 2;     // warpgroups, each its own tiles
  static constexpr int NBUF = H == 64 ? 2 : 1;   // tile buffers a warpgroup
  static constexpr int TILE_B = wg::ROWS * H * 2;
  static constexpr int ZERO_B = H < IN_W ? wg::BLOCK : 0;
  // + barriers, + the slack that aligns the base to 1,024 bytes
  static int bytes(int n_layers) {
    return n_layers * H * H * 2 + WG * NBUF * TILE_B + ZERO_B + 8 * (1 + WG * NBUF) + 1024;
  }
};

// R output rows of H columns; tx's boxes of a tile at columns cb * col_step
template <int H>
__global__ void __launch_bounds__(PairPlan<H>::WG * wg::THREADS, 1)
tanh_chain_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                  const __grid_constant__ CUtensorMap tout, long long R, int col_step,
                  int n_layers) {
  using C = PairPlan<H>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* w = smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* bufs = w + n_layers * H * H * 2;          // [WG][NBUF][TILE_B]
  unsigned char* zero = bufs + C::WG * C::NBUF * C::TILE_B;
  uint64_t* wbar = reinterpret_cast<uint64_t*>(zero + C::ZERO_B);
  uint64_t* full = wbar + 1;                                // [WG][NBUF]
  const int tid = threadIdx.x, g = wg::warpgroup(), t = tid % wg::THREADS;
  const long long n_tiles = (R + wg::ROWS - 1) / wg::ROWS;
  const long long step = (long long)C::WG * gridDim.x;
  if (tid == 0) {
    wg::mbar_init(wbar, 1);
    for (int i = 0; i < C::WG * C::NBUF; ++i) wg::mbar_init(&full[i], 1);
    wg::mbar_fence_init();
  }
  for (int i = tid; i < C::ZERO_B / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(zero)[i] = make_uint4(0, 0, 0, 0);
  wg::fence_async();
  __syncthreads();
  if (tid == 0) {
    wg::mbar_expect(wbar, n_layers * H * H * 2);
    for (int l = 0; l < n_layers; ++l)
      for (int nb = 0; nb < H / 64; ++nb)
        wg::tma_load(w + (l * (H / 64) + nb) * H * 128, &tw, wbar, nb * 64, l * H);
  }
  unsigned char* mine = bufs + g * C::NBUF * C::TILE_B;
  uint64_t* my_full = full + g * C::NBUF;
  auto load = [&](long long tile, int b) {  // by the warpgroup's thread 0
    wg::mbar_expect(&my_full[b], C::TILE_B);
    for (int cb = 0; cb < H / 64; ++cb)
      wg::tma_load(mine + b * C::TILE_B + cb * wg::BLOCK, &tx, &my_full[b], cb * col_step,
                   (int)(tile * wg::ROWS));
  };
  const long long first = (long long)blockIdx.x * C::WG + g;
  if (t == 0)
    for (int b = 0; b < C::NBUF; ++b)
      if (first + b * step < n_tiles) load(first + b * step, b);
  wg::mbar_wait(wbar, 0);
  const uint32_t w_s = wg::smem_u32(w);
  float d[H / 2];
  int i = 0;
  for (long long tile = first; tile < n_tiles; tile += step, ++i) {
    const int b = i % C::NBUF;
    unsigned char* buf = mine + b * C::TILE_B;
    const uint32_t buf_s = wg::smem_u32(buf);
    wg::mbar_wait(&my_full[b], (i / C::NBUF) & 1);
    for (int layer = 0; layer < n_layers; ++layer) {
      wg::fence_operand(d);
      wg::fence();
#pragma unroll
      for (int ks = 0; ks < H / 16; ++ks)
        wg::mma<H, 1>(d, wg::a_desc(buf_s, ks), wg::b_desc(w_s + layer * H * H * 2, ks, H * 128),
                      ks > 0);
      wg::commit();
      wg::wait<0>();
      wg::fence_operand(d);
      wg::bar_sync(1 + g, wg::THREADS);  // every warp's products are done
      wg::store_acc<H>(d, buf, 0, Tanh());
      wg::fence_async();
      wg::bar_sync(1 + g, wg::THREADS);
    }
    if (t == 0) {
      for (int cb = 0; cb < H / 64; ++cb)
        wg::tma_store(&tout, buf + cb * wg::BLOCK, cb * 64, (int)(tile * wg::ROWS));
      if constexpr (C::ZERO_B > 0) wg::tma_store(&tout, zero, H, (int)(tile * wg::ROWS));
      wg::tma_store_commit();
      wg::tma_store_wait_read();
      const long long next = tile + C::NBUF * step;
      if (next < n_tiles) load(next, b);
    }
  }
  if (t == 0) wg::tma_store_wait();
}

template <int H>
int launch_tanh_chain(const CUtensorMap& tx, const CUtensorMap& tw, const CUtensorMap& tout,
                      long long R, int col_step, int n_layers, cudaStream_t stream) {
  using C = PairPlan<H>;
  const int bytes = C::bytes(n_layers);
  int dev = 0, sms = 0, cap = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!err) err = (int)cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (!err && bytes > cap) err = (int)cudaErrorInvalidValue;
  if (!err)
    err = (int)cudaFuncSetAttribute(tanh_chain_kernel<H>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err) return err;
  const long long blocks = ((R + wg::ROWS - 1) / wg::ROWS + C::WG - 1) / C::WG;
  tanh_chain_kernel<H><<<(unsigned)(blocks < sms ? blocks : sms), C::WG * wg::THREADS, bytes,
                         stream>>>(tx, tw, tout, R, col_step, n_layers);
  return (int)cudaGetLastError();
}

}  // namespace

// X4 (mode ROWS, H = 64, out_w = 128), X5 (ROWS, 128, 128) and X6 (PAIRED,
// 128, 128): R output rows from x, n_layers (H, H) weights stacked in w.
// zero_bias is kept in the signature and not read (the chain has no bias).
extern "C" int sahs_exp_tanh_chain(const void* x, long long R, int mode, int H,
                                   const void* w, const void* zero_bias,
                                   int n_layers, void* out, int out_w,
                                   void* stream) {
  (void)zero_bias;
  if (R <= 0) return 0;
  if ((H != 64 && H != IN_W) || out_w != IN_W || (mode == PAIRED && H != IN_W) || n_layers < 1)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw, tout;
  // PAIRED: x seen as (R, 256), row r = [x[2r] | x[2r + 1]]
  int err = mode == PAIRED ? wg::make_map(&tx, x, R, 2 * IN_W, 4LL * IN_W, wg::ROWS)
                           : wg::make_map(&tx, x, R, IN_W, 2LL * IN_W, wg::ROWS);
  if (!err) err = wg::make_map(&tw, w, (long long)n_layers * H, H, 2LL * H, H);
  if (!err) err = wg::make_map(&tout, out, R, out_w, 2LL * out_w, wg::ROWS);
  if (err) return err;
  auto s = reinterpret_cast<cudaStream_t>(stream);
  const int col_step = mode == PAIRED ? IN_W : 64;
  return H == 64 ? launch_tanh_chain<64>(tx, tw, tout, R, col_step, n_layers, s)
                 : launch_tanh_chain<128>(tx, tw, tout, R, col_step, n_layers, s);
}
