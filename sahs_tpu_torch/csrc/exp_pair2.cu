// X4, X5, X6: the kernels of the two-points-a-row experiment, on the H100.
//
// Each computes 6 layers of h <- bf16(tanh(h @ W_i)), float32 accumulation,
// with the layer product of the field kernels (mlp.cuh: mlp_layer, SIMT
// register tiles, weights from L2, 64-row tiles k-major in shared memory).
// The question they answer on this card: do 64-wide products lose their
// rate against 128-wide ones (K14 reads 6.5 TFLOP/s on the 6 x 64 hyper net,
// 10.0 on the 6 x 128 warp net)?
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
// formed in the kernel as [x[2r, :64] | x[2r + 1, :64]] from the (P, 128)
// input. The TPU kernel built them by a reshape or by strided slices; both
// give these rows, so one form serves both modes here. Bound: X5's
// operations (0.026 ms); the bytes, x[:, :64] read and the (P / 2, 128)
// output written, take 0.020 ms.
//
// Design: one block per 64 output rows; the rows are loaded transposed
// into shared memory, run through the 6 layers, and stored; device memory
// sees the input once and the output once.
#include "mlp.cuh"

namespace {

constexpr int TP = 64;
constexpr int THREADS = 256;
constexpr int IN_W = 128;      // the input's row width
enum { ROWS = 0, PAIRED = 1 };

// rows: R output rows. ROWS: row r is x[r, :H]; PAIRED (H = 128): row r is
// [x[2r, :64] | x[2r + 1, :64]]. The output rows are out_w wide, zero past H.
__global__ void __launch_bounds__(THREADS)
tanh_chain_kernel(const __nv_bfloat16* __restrict__ x, long long R, int mode,
                  int H, const __nv_bfloat16* __restrict__ w,
                  const float* __restrict__ zero_bias, int n_layers,
                  __nv_bfloat16* __restrict__ out, int out_w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* hA = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* hB = hA + H * TP;
  const long long base = (long long)blockIdx.x * TP;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  for (int i = threadIdx.x; i < TP * H; i += blockDim.x) {
    const int t = i / H, k = i % H;
    const long long r = base + t;
    __nv_bfloat16 v = zero;
    if (r < R)
      v = mode == PAIRED ? x[(2 * r + k / 64) * IN_W + k % 64] : x[r * IN_W + k];
    hA[k * TP + t] = v;
  }
  __syncthreads();
  const __nv_bfloat16* h = sahs::chain_layers<__nv_bfloat16>(
      w, H * H, H, n_layers, sahs::ACT_TANH, zero_bias, hA, hB, TP);
  for (int i = threadIdx.x; i < TP * out_w; i += blockDim.x) {
    const int t = i / out_w, k = i % out_w;
    const long long r = base + t;
    if (r < R) out[r * out_w + k] = k < H ? h[k * TP + t] : zero;
  }
}

}  // namespace

// X4 (mode ROWS, H = 64, out_w = 128), X5 (ROWS, 128, 128) and X6 (PAIRED,
// 128, 128): R output rows from x, n_layers (H, H) weights stacked in w.
extern "C" int sahs_exp_tanh_chain(const void* x, long long R, int mode, int H,
                                   const void* w, const void* zero_bias,
                                   int n_layers, void* out, int out_w,
                                   void* stream) {
  if (R <= 0) return 0;
  if (H % 8 || H <= 0 || H > IN_W || out_w < H || (mode == PAIRED && H != IN_W))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * H * TP * sizeof(__nv_bfloat16);
  tanh_chain_kernel<<<(unsigned)((R + TP - 1) / TP), THREADS, smem,
                      reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const __nv_bfloat16*>(x), R, mode, H,
      reinterpret_cast<const __nv_bfloat16*>(w),
      reinterpret_cast<const float*>(zero_bias), n_layers,
      reinterpret_cast<__nv_bfloat16*>(out), out_w);
  return (int)cudaGetLastError();
}
