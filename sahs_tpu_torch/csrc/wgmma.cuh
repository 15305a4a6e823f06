// Hopper (sm_90a) building blocks: warpgroup products (wgmma) from
// shared-memory descriptors, mbarriers, TMA tile copies between device
// memory and shared memory, and TMA bulk copies of contiguous bytes. Used
// by the tools' chain kernels (X1 in exp_gather.cu, X4-X6 in exp_pair2.cu),
// for its TMA ring alone by X2's in-tile gathers (exp_gather.cu), and by
// the tiles of the system's paths, which share the weight ring, the
// products and the epilogue helpers below: the NeRF field's forward
// (level_train.cu: field_tc_kernel, K5/K7/K11, and fwd_tc_kernel, launch 1
// of K2/K6/K8/K12) and backward (bwd_tc_kernel, launch 3), the deformation
// nets' forward (skip_wg.cuh: K1 and K13) and backward (skip_bw.cuh: K3 and
// K14), and their dW (level_dw.cuh). No kernel of the port has another
// path to the tensor cores.
//
// The layout. Every bf16 operand in shared memory is in the 128-byte
// swizzle (CU_TENSOR_MAP_SWIZZLE_128B, descriptor layout type 1): rows of
// 128 bytes (64 bf16), 8 rows an atom of 1024 bytes, and within a row the
// 16-byte chunk c of row r stored at chunk c ^ (r % 8), the row counted
// from a 1024-byte-aligned base (the kernels align their shared memory so).
// TMA writes and reads this layout itself; threads use ``sw128``.
//   - A (the activations, M = 64 rows x K): K-major. K is cut into blocks
//     of 64 columns, each 64 rows x 128 bytes (8,192 bytes); the k-step kk
//     (16 columns) starts at block kk / 4, byte (kk % 4) * 32 of each row
//     (``a_desc``; stride between 8-row groups 1,024 bytes).
//   - B MN-major (the weights W[k][n], as they lie in device memory), so
//     the product reads W without a transpose (the transpose flag of
//     wgmma). N is cut into blocks of 64 columns; a block holds its k rows
//     one after another, 128 bytes each, and the blocks are ``nblock``
//     bytes apart (``b_desc``: the leading byte offset is that stride,
//     the stride byte offset the 1,024 bytes of 8 k rows).
//   - B K-major (W transposed, N rows of 64 k a block, as A; ``k_desc``,
//     transpose flag 0): the layout of a weight stage laid out ahead of
//     time, any N that is a multiple of 8.
//
// The product. ``mma<N>`` issues one wgmma.m64nNk16 (bf16 in, f32 sums in
// registers): thread t of the warpgroup (warp w = t / 32, lane l) holds
// d[4 j + 2 i + c] = D[16 w + l / 4 + 8 i][8 j + 2 (l % 4) + c]. A K-loop
// issues K / 16 of them and then commit / wait; ``store_acc`` writes
// act(d) back as bf16 into a K-major tile (the next layer's A), 4 bytes a
// thread at a time and free of bank conflicts (the 8 rows a warp writes at
// once fall on 8 different chunks). Shared memory written by threads must
// be fenced to the async proxy (``fence_async``) and the warpgroup
// synchronised before a wgmma or a TMA store reads it.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wg {

constexpr int ROWS = 64;           // rows of one warpgroup product
constexpr int THREADS = 128;       // threads of a warpgroup
constexpr int BLOCK = 64 * 128;    // bytes of a 64-row x 64-column block

// this thread's warpgroup, as a value the compiler knows is the same
// across the warp (a role branch on it is not divergent, and the wgmma
// after it are not serialised)
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, (int)threadIdx.x / THREADS, 0);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of (row, col) in a K-major swizzled tile of `rows` rows
__device__ __forceinline__ uint32_t sw128(int rows, int row, int col) {
  return (col >> 6) * rows * 128 + row * 128 + ((((col >> 3) & 7) ^ (row & 7)) << 4) +
         (col & 7) * 2;
}

__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// A of k-step kk from a K-major 64-row tile at shared address `tile`
__device__ __forceinline__ uint64_t a_desc(uint32_t tile, int kk) {
  return desc(tile + (kk >> 2) * BLOCK + (kk & 3) * 32, 16, 1024);
}

// B of k-step kk from MN-major weights at shared address `w` (k row 0 of
// N block 0), N blocks `nblock` bytes apart
__device__ __forceinline__ uint64_t b_desc(uint32_t w, int kk, uint32_t nblock) {
  return desc(w + kk * 16 * 128, nblock, 1024);
}

// A K-major operand of k-step j (of 4) of one 64-column block at shared
// address `blk` (A, or a K-major B of any multiple of 8 rows)
__device__ __forceinline__ uint64_t k_desc(uint32_t blk, int j) {
  return desc(blk + j * 32, 16, 1024);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of the accumulators across a
// wgmma batch (which would serialise it)
template <int R>
__device__ __forceinline__ void fence_operand(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// generic-proxy writes to shared memory, visible to wgmma and TMA
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// named barrier over `threads` threads (id 1-15; 0 is __syncthreads)
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- one k16 step of a warpgroup product (generated: the operand lists
// name every accumulator register) ----
template <int TRANS_B>
__device__ __forceinline__ void mma_n8(float (&d)[4], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3},"
      " %4, %5, p, 1, 1, 0, %7;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void mma_n16(float (&d)[8], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7},"
      " %8, %9, p, 1, 1, 0, %11;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void mma_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void mma_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void mma_n256(float (&d)[128], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

// d (+)= A B over one k16 step: N = 8, 16, 64, 128 or 256; TRANS_B 1 for
// MN-major B; accumulate 0 overwrites d
template <int N, int TRANS_B>
__device__ __forceinline__ void mma(float (&d)[N / 2], uint64_t da, uint64_t db, int accumulate) {
  if constexpr (N == 8) mma_n8<TRANS_B>(d, da, db, accumulate);
  else if constexpr (N == 16) mma_n16<TRANS_B>(d, da, db, accumulate);
  else if constexpr (N == 64) mma_n64<TRANS_B>(d, da, db, accumulate);
  else if constexpr (N == 128) mma_n128<TRANS_B>(d, da, db, accumulate);
  else mma_n256<TRANS_B>(d, da, db, accumulate);
}

// act(d) as bf16 into the K-major 64-row tile at `tile`, columns col0 ..
// col0 + N - 1 (col0 a multiple of 64); called by the whole warpgroup
template <int N, class Act>
__device__ __forceinline__ void store_acc(const float (&d)[N / 2], unsigned char* tile,
                                          int col0, Act act) {
  const int t = threadIdx.x % THREADS, l = t % 32;
  const int r0 = 16 * (t / 32) + l / 4;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const __nv_bfloat162 v =
          __floats2bfloat162_rn(act(d[4 * j + 2 * i]), act(d[4 * j + 2 * i + 1]));
      *reinterpret_cast<__nv_bfloat162*>(tile + sw128(ROWS, r0 + 8 * i, col0 + 8 * j + 2 * (l % 4))) = v;
    }
  }
}

// ---- mbarriers ----
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// after the inits, before any thread or TMA uses the barriers
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival where `pred` holds (predicated: no branch between products)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(smem_u32(bar)),
      "r"((int)pred)
      : "memory");
}
// one arrival that also expects `bytes` from TMA copies
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// waits until the phase of parity `parity` has completed (a fresh barrier
// counts its phase before the first, parity 1, as completed); a wait past
// ~2^34 cycles (seconds) traps, so a lost arrival fails the launch in
// place of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  }
}

// ---- TMA (2-D tensor maps, 128-byte swizzle) ----
// box at (c0 = column, c1 = row) of `map` into shared `dst`, completing
// on `bar`; rows and columns outside the tensor arrive as zeros
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
// `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte
// aligned) from device memory `src` into shared `dst`, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// shared `src` to the box at (c0, c1) of `map`; the part of the box
// outside the tensor is not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the committed stores have finished reading shared memory
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// the committed stores are complete
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---- weight stages through a ring (level_train.cu's fw::tile and bw::tile,
// skip_wg.cuh's sk::tile) ----
// A stage is one 64-k block of one chunk of a layer's outputs (at most NC
// rows of 128 bytes, K-major in the 128-byte swizzle), laid out ahead of
// time in the order a tile runs its products; one producer thread copies
// each into the next free slot of the ring (Ring::push), every consumer
// warp frees it (lane 0 arrives on `empty`). ``product`` runs one chunk's
// products, A from the warpgroup's tiles in shared memory.
//
// Accumulation (PROMOTE): the tensor core's sum truncates, and carried
// over a whole K it leaves the sums further from the JAX package's float32
// semantics (_mm) than their order alone would. PROMOTE s sums s k16 steps
// in the tensor core from zero, then adds them to the float32 sums with
// round-to-nearest (s = 1, every k16 step apart, is what the path's tiles
// run); PROMOTE 0 carries the sum over the whole K in the tensor core.
constexpr int KB = 64;             // k rows of a weight stage
constexpr int NC = 128;            // output columns of a chunk, at most
constexpr int SLOT = NC * 128;     // bytes of a ring slot

struct Ring {
  unsigned char* slots;
  uint64_t* full;
  uint64_t* empty;
  int n, stage;
  uint32_t phase;
  __device__ __forceinline__ void next() {
    if (++stage == n) {
      stage = 0;
      phase ^= 1u;
    }
  }
  // the producer's side: `bytes` from device memory `src` into the next
  // slot once the consumers have freed it
  __device__ __forceinline__ void push(const void* src, uint32_t bytes) {
    mbar_wait(&empty[stage], phase ^ 1u);
    mbar_expect(&full[stage], bytes);
    bulk_load(slots + stage * SLOT, src, bytes, &full[stage]);
    next();
  }
  // the box at (c0, c1) of `map` (`bytes` of it) into the next slot
  __device__ __forceinline__ void push_map(const CUtensorMap* map, int c0, int c1, uint32_t bytes) {
    mbar_wait(&empty[stage], phase ^ 1u);
    mbar_expect(&full[stage], bytes);
    tma_load(slots + stage * SLOT, map, &full[stage], c0, c1);
    next();
  }
};

// An input's 64-column blocks in shared memory: blocks 0-1 from lo, 2 on
// from hi, nb of them.
struct ASrc {
  uint32_t lo, hi;
  int nb;
};
__device__ __forceinline__ uint32_t a_block(const ASrc& s, int kb) {
  return kb < 2 ? s.lo + kb * wg::BLOCK : s.hi + (kb - 2) * wg::BLOCK;
}

// d = A1 W1 (+ A2 W2) over one N-wide chunk of outputs, one ring stage a
// 64-k block. Called by the whole warpgroup.
template <int N, int PROMOTE>
__device__ __forceinline__ void product(float (&d)[N / 2], const ASrc& s1, const ASrc& s2,
                                        Ring& rg, int lane) {
  constexpr int R = N / 2;
  float p[PROMOTE > 1 || (PROMOTE == 1 && N != 2 * KB) ? R : 1];
  if constexpr (PROMOTE != 0) {
#pragma unroll
    for (int e = 0; e < R; ++e) d[e] = 0.0f;
  }
  int prev = 0;
  bool first = true;
  const int nb = s1.nb + s2.nb;
  for (int b = 0; b < nb; ++b) {
    const uint32_t ab = b < s1.nb ? a_block(s1, b) : a_block(s2, b - s1.nb);
    wg::mbar_wait(&rg.full[rg.stage], rg.phase);
    const uint32_t wb = wg::smem_u32(rg.slots + rg.stage * SLOT);
    if constexpr (PROMOTE == 1 && N == 2 * KB) {
      // each k16 step apart, in two 64-column halves: one half's float32
      // adds run while the other half's product is in flight (the order
      // of the groups: A0 B0 A1 B1 ...; wait<1> leaves the newest pending)
      float pa[KB / 2], pb[KB / 2];
      wg::fence_operand(pa);
      wg::fence_operand(pb);
      wg::fence();
      wg::mma<KB, 0>(pa, wg::k_desc(ab, 0), wg::k_desc(wb, 0), 0);
      wg::commit();
      wg::mma<KB, 0>(pb, wg::k_desc(ab, 0), wg::k_desc(wb + KB * 128, 0), 0);
      wg::commit();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wg::wait<1>();
        wg::fence_operand(pa);
#pragma unroll
        for (int e = 0; e < KB / 2; ++e) d[e] = __fadd_rn(d[e], pa[e]);
        if (j < 3) {
          wg::fence();
          wg::mma<KB, 0>(pa, wg::k_desc(ab, j + 1), wg::k_desc(wb, j + 1), 0);
          wg::commit();
          wg::wait<1>();
        } else {
          wg::wait<0>();
        }
        wg::fence_operand(pb);
#pragma unroll
        for (int e = 0; e < KB / 2; ++e) d[KB / 2 + e] = __fadd_rn(d[KB / 2 + e], pb[e]);
        if (j < 3) {
          wg::fence();
          wg::mma<KB, 0>(pb, wg::k_desc(ab, j + 1), wg::k_desc(wb + KB * 128, j + 1), 0);
          wg::commit();
        }
      }
      wg::mbar_arrive(&rg.empty[rg.stage], lane == 0);
    } else if constexpr (PROMOTE == 0) {
      wg::fence_operand(d);
      wg::fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wg::mma<N, 0>(d, wg::k_desc(ab, j), wg::k_desc(wb, j), !(first && j == 0));
      wg::commit();
      wg::wait<1>();  // the previous stage's products are done
      wg::fence_operand(d);
      wg::mbar_arrive(&rg.empty[prev], !first && lane == 0);
    } else {
#pragma unroll
      for (int j0 = 0; j0 < 4; j0 += PROMOTE) {
        wg::fence_operand(p);
        wg::fence();
#pragma unroll
        for (int j = j0; j < j0 + PROMOTE; ++j)
          wg::mma<N, 0>(p, wg::k_desc(ab, j), wg::k_desc(wb, j), j > j0);
        wg::commit();
        wg::wait<0>();
        wg::fence_operand(p);
#pragma unroll
        for (int e = 0; e < R; ++e) d[e] = __fadd_rn(d[e], p[e]);
      }
      wg::mbar_arrive(&rg.empty[rg.stage], lane == 0);
    }
    prev = rg.stage;
    rg.next();
    first = false;
  }
  if constexpr (PROMOTE == 0) {
    wg::wait<0>();
    wg::fence_operand(d);
    wg::mbar_arrive(&rg.empty[prev], lane == 0);
  }
}

// A 4-byte shared-memory store. No memory clobber: the epilogue's bias reads
// must not wait behind each store; the fences and barriers after the
// epilogue order the stores for their readers.
__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v));
}

// ---- the column sums of a gz epilogue (level_train.cu's bw::, skip_bw.cuh's
// sb::) ----
// One step of the column sums' butterfly: lanes l and l ^ b each keep half
// of their HALF * 2 sums and add the other lane's copy of that half.
template <int HALF, int M>
__device__ __forceinline__ void fold_half(float (&s)[M], int b, int l) {
  const bool up = (l & b) != 0;
#pragma unroll
  for (int k = 0; k < HALF; ++k) {
    const float send = up ? s[k] : s[k + HALF];
    const float keep = up ? s[k + HALF] : s[k];
    s[k] = keep + __shfl_xor_sync(0xffffffffu, send, b);
  }
}

// The warp's sums over its 16 points of each of the chunk's N columns into
// cs[col], from each lane's sums of its two points (s; N >= 32): a
// column's 8 lanes (l / 4) halve their sums three times; lane l then
// holds the M / 8 sums of list positions o = k + (l & 16 ? M/2) + (l & 8 ?
// M/4) + (l & 4 ? M/8), o = 2 j + c for column 8 j + 2 (l % 4) + c.
template <int N>
__device__ __forceinline__ void col_sums(float (&s)[N / 4], float* cs, int t) {
  constexpr int M = N / 4;
  const int l = t % 32, q = l % 4;
  fold_half<M / 2>(s, 16, l);
  fold_half<M / 4>(s, 8, l);
  fold_half<M / 8>(s, 4, l);
  const int o0 = (l & 16 ? M / 2 : 0) + (l & 8 ? M / 4 : 0) + (l & 4 ? M / 8 : 0);
#pragma unroll
  for (int k = 0; k < M / 8; ++k) {
    const int o = o0 + k;
    cs[8 * (o / 2) + 2 * q + (o % 2)] = s[k];
  }
}

// ---- host: tensor maps ----
// The driver's encoder, taken through the runtime (no link to libcuda).
inline PFN_cuTensorMapEncodeTiled_v12000 encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A 2-D tensor of `dtype` (rows x cols, rows `row_bytes` apart) cut into
// boxes of box_rows x box_cols, written to shared memory in `swizzle`'s
// layout; a box's L2 misses fetch `promotion`'s line from device memory.
// Returns 0 or a cudaError_t.
inline int make_map_of(CUtensorMap* map, CUtensorMapDataType dtype, const void* base,
                       long long rows, long long cols, long long row_bytes, int box_cols,
                       int box_rows, CUtensorMapSwizzle swizzle,
                       CUtensorMapL2promotion promotion = CU_TENSOR_MAP_L2_PROMOTION_L2_256B) {
  PFN_cuTensorMapEncodeTiled_v12000 enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = enc(map, dtype, 2, const_cast<void*>(base), dims, strides, box, step,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, promotion,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A 2-D bf16 tensor (rows x cols, rows `row_bytes` apart) cut into boxes
// of box_rows x 64 columns (128 bytes, the swizzle's width).
inline int make_map(CUtensorMap* map, const void* base, long long rows, long long cols,
                    long long row_bytes, int box_rows) {
  return make_map_of(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, rows, cols, row_bytes, 64,
                     box_rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace wg
