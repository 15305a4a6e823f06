// K15: the sample positions of a ray bundle, o + d z, ray-major.
//
// Replaces sahs_tpu/ops/pallas/field_mlp.py:build_pts (:814, pallas_call at
// :839), the fused train step's position builder (train/fused.py). Out
// (R * S, 3) float32: point r * S + s is ro[r] + rd[r] * z[r, s].
//
// Its whole contract is the rounding: the multiply and the add are rounded
// one at a time (__fmul_rn, then __fadd_rn; the explicit intrinsics forbid
// contraction into an FMA), so every position equals, bit for bit, PyTorch's
// eager ro + rd * z, which rounds the product before the sum. The fused
// step relies on it: the coarse points must reappear bit for bit among the
// sorted fine points, whichever of the two built them.
//
// Bound on the H100: bytes. One thread per point reads its z (4 bytes) and
// its ray's o and d (24 bytes, from L1/L2 after the first of the ray's
// points) and writes 12 bytes: ~4.2 MB at a train step's 262,144 fine
// points, ~1.3 us at 3.35 TB/s, well under the launch's own latency.
// Measured on an H100 (PERF.md, tools/level_ab.py, torch.profiler): 1.55,
// 2.29 and 2.84 us of device time at 2048 rays x 64, 128 and 192, below
// torch.addcmul's 2.5, 3.5 and 4.6; a thread per output float (coalesced
// stores, 32-bit indices) read 2.2, 3.3 and 4.4. A call's time is the
// wrapper's host path (ops/kernels/points.py), not the kernel.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
build_pts_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                 const float* __restrict__ z, long long R, int S,
                 float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= R * S) return;
  const long long r = i / S;
  const float zi = z[i];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    out[i * 3 + c] = __fadd_rn(ro[r * 3 + c], __fmul_rn(rd[r * 3 + c], zi));
}

}  // namespace

extern "C" int sahs_build_pts(const void* ro, const void* rd, const void* z,
                              long long R, int S, void* out, void* stream) {
  if (R <= 0 || S <= 0) return 0;
  const long long blocks = (R * S + THREADS - 1) / THREADS;
  build_pts_kernel<<<(unsigned)blocks, THREADS, 0,
                     reinterpret_cast<cudaStream_t>(stream)>>>(
      (const float*)ro, (const float*)rd, (const float*)z, R, S, (float*)out);
  return (int)cudaGetLastError();
}
