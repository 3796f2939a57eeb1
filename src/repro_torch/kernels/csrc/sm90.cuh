// Hopper (sm_90a) building blocks in inline PTX: mbarriers, TMA tensor
// loads and reduce-adds, cp.async, ldmatrix, the 128-byte swizzle, wgmma
// shared-memory descriptors and the bf16 wgmma: both operands from shared
// memory (N 32, 64, 128, either one transposed: `wgmma_ss_t`), or A from
// registers (N 64, 128). Included by the kernel sources under csrc/;
// a change here rebuilds every source that includes it (the build key
// hashes the local headers a source includes).
#pragma once

#include <cuda.h>  // CUtensorMap (the type only: nothing links libcuda)
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to wait for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Spins until the phase of parity `parity` has completed. A fresh barrier
// is in phase 0, so waiting on parity 1 returns at once. A wait of more
// than about ten seconds (2^34 cycles) can only be a lost arrival: it
// traps, so the launch fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 34)) __trap();
  }
}

// Barrier `id` (1..15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ---- TMA ------------------------------------------------------------------

// Copies the box at coordinates (c0, c1, c2, c3) (innermost first) of a 4-d
// tensor map into shared memory; completion is counted on `bar`. Elements
// outside the tensor are written as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Adds the box at `src` in shared memory into the tensor of `map` at
// coordinates (c0, c1, c2, c3), element by element in L2 (the map's type:
// float32 here); elements outside the tensor are dropped. The source must
// be visible to the async proxy (fence_proxy_async, then a barrier).
__device__ __forceinline__ void tma_reduce_add_4d(const CUtensorMap* map,
                                                  const void* src, int c0,
                                                  int c1, int c2, int c3) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// Closes this thread's bulk operations issued so far into a group.
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until every group of this thread has read its shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Waits until every group of this thread is complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---- cp.async, ldmatrix, proxy fence --------------------------------------

// 16 bytes global -> shared, asynchronously; `valid` false writes zeros
// (src-size 0: nothing is read, `src` need only be a mapped address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Makes this thread's shared-memory writes (stores, cp.async) visible to
// the async proxy (wgmma operands); then a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Four 8x8 b16 matrices, transposed: lane L gives the address of row L % 8
// of matrix L / 8; r[m] of thread t holds row t / 4, columns 2 (t % 4) and
// 2 (t % 4) + 1 of matrix m's transpose (low half the lower column).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row))
               : "memory");
}

// Byte offset of 16-byte piece `piece` (0..7) of row `row` in a tile of
// 128-byte rows stored with the 128-byte swizzle (TMA's SWIZZLE_128B,
// what desc_b128 describes), from a 1024-byte-aligned base.
__device__ __forceinline__ uint32_t swz128(int row, int piece) {
  return static_cast<uint32_t>(row) * 128u + static_cast<uint32_t>((piece ^ (row & 7)) * 16);
}

// ---- wgmma ----------------------------------------------------------------

// 2^x, flushing subnormal results to zero (one MUFU.EX2; relative error
// about 2^-22).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Shared-memory matrix descriptor for a 128-byte-swizzled operand whose
// 8-row x 128-byte swizzle atoms start on 1024-byte boundaries (so the
// base offset field is 0). Offsets in bytes.
__device__ __forceinline__ uint64_t desc_b128(uint32_t smem_addr,
                                              uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);  // layout: 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pins registers that an in-flight wgmma reads or writes: the compiler may
// not move their other uses across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

#define SM90_ACC16(d)                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define SM90_ACC32(d)                                                       \
  SM90_ACC16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),        \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
      "+f"(d[30]), "+f"(d[31])
#define SM90_ACC64(d)                                                       \
  SM90_ACC32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),        \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),      \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),      \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),      \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),      \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),      \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define SM90_D16                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define SM90_D32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define SM90_D64                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "      \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "  \
  "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "  \
  "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "  \
  "%57, %58, %59, %60, %61, %62, %63}"

// D (64 x N, f32) (+)= A (64 x 16) . B (16 x N), bf16 inputs, both operands
// in shared memory, N in {32, 64, 128}; scale_d = 0 overwrites D.
// Accumulator layout (thread t of the warpgroup, warp w = t / 32, lane
// l = t % 32): d[i] is row 16 w + l / 4 + 8 ((i / 2) % 2), column
// 8 (i / 4) + 2 (l % 4) + i % 2 (N / 2 registers). TA = 0: A is K-major (a
// row's 16 K values contiguous); TA = 1: A is M-major (its 64 M values
// contiguous: the transpose bit). TB the same for B (TB = 1: N-major, as
// the rs_tb forms read B). A K-major operand's descriptor has SBO the
// stride between 8-row groups; an MN-major one that of the rs_tb forms:
// SBO the stride between 8-row groups along K, LBO the stride between
// 64-column atoms along M or N. At N = 128 A is read from shared memory
// half as often per flop as at N = 64.
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss_t(float (&d)[N / 2], uint64_t desc_a,
                                           uint64_t desc_b, int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "N of wgmma_ss_t");
  if constexpr (N == 32)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " SM90_D16
        ", %16, %17, p, 1, 1, %19, %20;\n}\n"
        : SM90_ACC16(d)
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA), "n"(TB));
  else if constexpr (N == 64)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
        ", %32, %33, p, 1, 1, %35, %36;\n}\n"
        : SM90_ACC32(d)
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA), "n"(TB));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_D64
        ", %64, %65, p, 1, 1, %67, %68;\n}\n"
        : SM90_ACC64(d)
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA), "n"(TB));
}

// D (64 x 64, f32) += A (64 x 16, bf16 in registers) . B (16 x 64, bf16),
// B in shared memory N-major (its 64 columns contiguous: the transpose
// bit). A's fragment (warp w holds rows 16 w .. 16 w + 15): a[0] = row
// l / 4, columns 2 (l % 4) + {0, 1}; a[1] the same columns of row l / 4 + 8;
// a[2], a[3] the same rows at columns 8 + 2 (l % 4) + {0, 1}. The low half
// of each register is the lower column.
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32],
                                                      const uint32_t (&a)[4],
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SM90_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// The same with N = 128: B spans two 64-column swizzle atoms (the stride
// between them is the leading byte offset).
__device__ __forceinline__ void wgmma_m64n128k16_rs_tb(float (&d)[64],
                                                       const uint32_t (&a)[4],
                                                       uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : SM90_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#undef SM90_ACC64
#undef SM90_ACC32
#undef SM90_ACC16
#undef SM90_D16
#undef SM90_D32
#undef SM90_D64

}  // namespace sm90
