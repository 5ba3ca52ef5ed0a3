// Hopper (sm_90a) building blocks for warp-specialised kernels: mbarriers,
// TMA tile loads, 128-byte-swizzle wgmma descriptors and products, the
// warpgroup register hand-off (setmaxnreg), named barriers and stmatrix.
//
// The pattern they serve: one producer warp keeps a ring of tiles in
// flight with TMA, each stage guarded by a "full" mbarrier (the copy's
// bytes and the producer's arrivals) and an "empty" one (the consumers'
// arrivals); consumer warpgroups run wgmma on the tiles that have landed.
//
// Layouts (PTX ISA, "Matrix Descriptor" and the canonical wgmma layouts):
// a tile of rows of 64 bf16 (128 bytes), loaded by TMA with
// CU_TENSOR_MAP_SWIZZLE_128B into a 1024-byte-aligned buffer, is read by
// wgmma through a 128B-swizzle descriptor with a stride byte offset (SBO)
// of 1024 (8 rows). Read K-major (the row is the reduction dim), each
// 16-wide k-step starts 32 bytes further into the row; read MN-major (the
// row is the M or N dim, transpose bit set), each k-step starts 16 rows
// (2048 bytes) further down. An MN-major operand wider than 64 is a row
// of 64-column swizzle atoms (each its K rows x 128 bytes, as a TMA box
// (64, K rows, atoms) lays them out), and the leading byte offset (LBO)
// steps from one atom to the next: kernel F's (K, N) weight slabs.
#pragma once

#include <cuda.h>  // CUtensorMap; the driver's encoder is looked up at run time
#include <cudaTypedefs.h>

#include "common.cuh"

namespace gar {
namespace sm90 {

// ---- mbarriers (shared::cta, 64-bit)

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible before any thread (or the TMA
// unit) uses them; follow with a block-wide barrier.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// One arrival that also raises the phase's expected transaction bytes.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of the given parity has completed (acquire: the
// writes released by its arrivals, and the TMA bytes, are visible). A wait
// that never ends (a broken pipeline) traps after ~2^26 tries instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0, tries = 0;
  while (!done) {
    if (++tries == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// ---- cp.async: 4 bytes of global memory into shared memory without a
// register (zero-filled where !valid); commit, then wait before a barrier
// hands them over

__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---- programmatic dependent launch

// Wait until the grids this one depends on have completed and their writes
// are visible; a no-op for a grid launched without
// cudaLaunchAttributeProgrammaticStreamSerialization. Work before it may
// only touch memory that those grids do not write.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// ---- cluster barrier, split: arrive now, wait later (every thread of
// every CTA of the cluster, warps converged)

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {  // release: this CTA's stores before it
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// ---- TMA

// A 4D tile (dims innermost first, as the map was encoded) into shared
// memory; completes on `bar` with the box's bytes (out-of-range elements
// are zero-filled and still counted).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// An L2 cache policy for the hinted copies below: evict_first for data read
// once (a weight stream, so it does not push out what is read again),
// evict_last for data read again soon.
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// tma_load_4d with an L2 cache policy.
__device__ __forceinline__ void tma_load_4d_hint(void* dst, const CUtensorMap* map, uint64_t* bar,
                                                 int c0, int c1, int c2, int c3, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1, {%3, %4, %5, %6}], [%2], %7;\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "l"(policy)
      : "memory");
}

// `bytes` (a multiple of 16; both addresses 16-byte aligned) of global
// memory into shared memory by the TMA unit, without a tensor map;
// completes on `bar` with its bytes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Add a 4D tile of shared memory into global memory (fp32 add, done in the
// L2 by the TMA unit; elements outside the tensor are skipped). Completes
// in this thread's bulk group: commit it, then wait before reusing the tile.
__device__ __forceinline__ void tma_reduce_add_4d(const CUtensorMap* map, const void* src,
                                                  int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Store a 4D tile of shared memory into global memory (elements outside
// the tensor are skipped). Completes in this thread's bulk group.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Wait until at most N of this thread's bulk groups are still in flight.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Generic-proxy shared-memory writes (st.shared, stmatrix) made visible to
// the async proxy (wgmma, TMA) before a barrier hands them over.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- warpgroups

template <int R>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Named barrier `id` (not 0: __syncthreads) over `threads` threads.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// 2^x by the SFU (ex2.approx.ftz: ~2 ulp; 2^-inf = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Four 8x8 b16 matrices, each thread holding mma fragment (row lane / 4,
// cols 2 (lane % 4), +1) of matrix i in r[i], stored transposed: matrix
// i's column j becomes the 16-byte memory row whose address lane 8 i + j
// gives.
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// ---- wgmma

// 128B-swizzle shared-memory matrix descriptor: start address, LBO and SBO
// in 16-byte units, layout type 1 (128B swizzle), base offset 0 (tiles are
// 1024-byte aligned).
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tell the compiler these registers change here: keeps it from moving
// their reads above a wgmma_wait, or their writes below a wgmma issue.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define GAR_ACC8(d, o)                                                                     \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]),          \
      "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])

// D(64 x 64, fp32) (+)= A(64 x 16) B(16 x 64), both bf16 from shared memory.
// TA / TB: 1 reads that operand MN-major. Accumulator layout: warp w of
// the warpgroup, lane (g, t) = (lane / 4, lane % 4) holds d[j*4 + r*2 + c]
// = D[16 w + g + 8 r][8 j + 2 t + c].
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : GAR_ACC8(d, 0), GAR_ACC8(d, 8), GAR_ACC8(d, 16), GAR_ACC8(d, 24)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

// D(64 x 64) += A(64 x 16, registers) B(16 x 64, shared memory). A is the
// mma.m16n8k16 A fragment of the warp's 16 rows: a[0] (g, 2t..2t+1),
// a[1] (g + 8, 2t..), a[2] (g, 2t + 8..), a[3] (g + 8, 2t + 8..).
template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : GAR_ACC8(d, 0), GAR_ACC8(d, 8), GAR_ACC8(d, 16), GAR_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
}

// D(64 x 128) += A(64 x 16, registers) B(16 x 128, shared memory), A as
// wgmma_m64n64k16_rs takes it; d[j*4 + r*2 + c] = D[16 w + g + 8 r][8 j + 2 t + c].
template <int TB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : GAR_ACC8(d, 0), GAR_ACC8(d, 8), GAR_ACC8(d, 16), GAR_ACC8(d, 24), GAR_ACC8(d, 32),
        GAR_ACC8(d, 40), GAR_ACC8(d, 48), GAR_ACC8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
}

// D(64 x 96) += A(64 x 16, registers) B(16 x 96, shared memory), A as
// wgmma_m64n64k16_rs takes it; d[j*4 + r*2 + c] = D[16 w + g + 8 r][8 j + 2 t + c].
template <int TB>
__device__ __forceinline__ void wgmma_m64n96k16_rs(float (&d)[48], const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
      : GAR_ACC8(d, 0), GAR_ACC8(d, 8), GAR_ACC8(d, 16), GAR_ACC8(d, 24), GAR_ACC8(d, 32),
        GAR_ACC8(d, 40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
}

// D(64 x 32, fp32) (+)= A(64 x 16) B(16 x 32), both from shared memory.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : GAR_ACC8(d, 0), GAR_ACC8(d, 8)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

// D(64 x 16, fp32) (+)= A(64 x 16) B(16 x 16), both from shared memory.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n16k16_ss(float (&d)[8], uint64_t a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : GAR_ACC8(d, 0)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

// D(64 x 128, fp32) (+)= A(64 x 16) B(16 x 128), both from shared memory;
// d[j*4 + r*2 + c] = D[16 w + g + 8 r][8 j + 2 t + c], j < 16.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t a, uint64_t b,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : GAR_ACC8(d, 0), GAR_ACC8(d, 8), GAR_ACC8(d, 16), GAR_ACC8(d, 24), GAR_ACC8(d, 32),
        GAR_ACC8(d, 40), GAR_ACC8(d, 48), GAR_ACC8(d, 56)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

#undef GAR_ACC8

}  // namespace sm90

// A 4D tensor map (dims innermost first, byte strides of dims 1-3, box in
// elements), 128-byte swizzle, encoded on the host through the driver's
// entry point (no -lcuda). Returns 0, or a negative code when the driver
// refuses (TMA needs a 16-byte aligned base and strides that are multiples
// of 16 bytes; the strides need not grow with the dim).
inline int encode_4d(CUtensorMap* map, const void* base, CUtensorMapDataType dtype,
                     const cuuint64_t (&dims)[4], const cuuint64_t (&strides)[3],
                     const cuuint32_t (&box)[4]) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess || fn == nullptr)
      return -1;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, dtype, 4, const_cast<void*>(base), dims, strides, box, unit,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : -1000 - static_cast<int>(res);
}

inline int encode_4d(CUtensorMap* map, const void* base, bool fp32, const cuuint64_t (&dims)[4],
                     const cuuint64_t (&strides)[3], const cuuint32_t (&box)[4]) {
  return encode_4d(map, base,
                   fp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, dims,
                   strides, box);
}

// The map of a stacked (layers, rows, cols) weight of 1-byte (int8) or
// 2-byte (bf16) elements as (cols, rows, layers, 1), boxes of (box_cols,
// box_rows, 1, 1), 128-byte swizzle: the layer is a coordinate, so one map
// serves every layer, and rows or columns past the weight land as zeros.
// Encoded once per (base, shape, element size, box) and cached (the mega
// step asks for its four weights' maps 16 times a step; encoding costs the
// host microseconds); a map depends on nothing else, so a later tensor at a
// reused address finds a map that is right for it.
inline int stacked_weight_map(CUtensorMap* map, const void* base, int elem_bytes, int layers,
                              int rows, int cols, int box_cols, int box_rows) {
  struct Entry {
    const void* base;
    int key[6];
    CUtensorMap map;
  };
  constexpr int kEntries = 32;
  static Entry cache[kEntries];
  static int used = 0, next = 0;
  const int key[6] = {elem_bytes, layers, rows, cols, box_cols, box_rows};
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    bool same = e.base == base;
    for (int k = 0; k < 6 && same; ++k) same = e.key[k] == key[k];
    if (same) {
      *map = e.map;
      return 0;
    }
  }
  const cuuint64_t row = static_cast<cuuint64_t>(cols) * elem_bytes;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(layers), 1};
  const cuuint64_t strides[3] = {row, row * rows, row * rows * layers};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows),
                             1, 1};
  Entry& e = cache[next];
  const CUtensorMapDataType dtype =
      elem_bytes == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (const int err = encode_4d(&e.map, base, dtype, dims, strides, box)) return err;
  e.base = base;
  for (int k = 0; k < 6; ++k) e.key[k] = key[k];
  next = (next + 1) % kEntries;
  used = used < kEntries ? used + 1 : kEntries;
  *map = e.map;
  return 0;
}

// A (batch, rows, heads, cols) operand (bf16, or an fp32 workspace) with
// element strides (sb, ss, sh) as a 4D TMA map (cols, rows, heads, batch),
// boxes of (128 bytes of columns, box_rows, 1, 1): a row wider than 128
// bytes takes one box per 128 bytes, and a box's columns past `cols` land
// as zeros.
inline int encode_rows(CUtensorMap* map, const void* base, bool fp32, int rows, int heads,
                       int batch, long long sb, long long ss, long long sh, int box_rows,
                       int cols = 64) {
  const cuuint64_t elem = fp32 ? 4 : 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * elem,
                                 static_cast<cuuint64_t>(sh) * elem,
                                 static_cast<cuuint64_t>(sb) * elem};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(128 / elem),
                             static_cast<cuuint32_t>(box_rows), 1, 1};
  return encode_4d(map, base, fp32, dims, strides, box);
}

}  // namespace gar
