// X1, X2, X3: the kernels of the gather experiments, on the H100.
//
// X1 replaces tools/exp_gather.py:make_chain (:52, pallas_call at :63): a
// bare chain h <- bf16(relu(h @ W)), n_layers times with the same (H, H)
// bf16 weight W, float32 accumulation, over (P, H) bf16 rows; out[p] is the
// float32 sum of row p's last activation. It measures what the layer
// product of the field kernels reaches when nothing else is in the kernel,
// so it is built from that product itself (mlp.cuh: mlp_layer, a 4-point x
// 8-output register tile a thread on the CUDA cores, weights read from L2,
// 64-point tiles k-major in shared memory). Bound: operations, 2 P H^2 n
// (0.28 ms at 8 x 256 over 262,144 rows at the 989 TFLOP/s bf16 peak).
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

namespace {

constexpr int TP = 64;         // rows per X1 tile
constexpr int THREADS = 256;
constexpr int TILE = 1024;     // X2's gather tile
constexpr int CW = 16;         // X2's slab width (columns)

__global__ void __launch_bounds__(THREADS)
chain_kernel(const __nv_bfloat16* __restrict__ x, long long P, int H,
             const __nv_bfloat16* __restrict__ w, const float* __restrict__ zero_bias,
             int n_layers, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* hA = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* hB = hA + H * TP;
  const long long base = (long long)blockIdx.x * TP;
  for (int i = threadIdx.x; i < TP * H; i += blockDim.x) {
    const int t = i / H, k = i % H;
    const long long p = base + t;
    hA[k * TP + t] = p < P ? x[p * H + k] : __float2bfloat16_rn(0.0f);
  }
  __syncthreads();
  const __nv_bfloat16* h = sahs::chain_layers<__nv_bfloat16>(
      w, 0, H, n_layers, sahs::ACT_RELU, zero_bias, hA, hB, TP);
  if (threadIdx.x < TP) {
    const long long p = base + threadIdx.x;
    if (p < P) {
      float s = 0.0f;
      for (int k = 0; k < H; ++k) s += sahs::to_f(h[k * TP + threadIdx.x]);
      out[p] = s;
    }
  }
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

extern "C" int sahs_exp_chain(const void* x, long long P, int H, const void* w,
                              const void* zero_bias, int n_layers, void* out,
                              void* stream) {
  if (P <= 0) return 0;
  if (H % 8 || H <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * H * TP * sizeof(__nv_bfloat16);
  int err = (int)cudaFuncSetAttribute(chain_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem);
  if (err) return err;
  chain_kernel<<<(unsigned)((P + TP - 1) / TP), THREADS, smem,
                 reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const __nv_bfloat16*>(x), P, H,
      reinterpret_cast<const __nv_bfloat16*>(w),
      reinterpret_cast<const float*>(zero_bias), n_layers,
      reinterpret_cast<float*>(out));
  return (int)cudaGetLastError();
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
