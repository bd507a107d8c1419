// Hopper building blocks: mbarriers, TMA tile loads through a CUtensorMap,
// bf16 warpgroup products
// (`wgmma.mma_async`) on 128-byte-swizzled shared-memory tiles, and the
// cluster's own exchange: stores into another block's shared memory that
// complete on that block's mbarrier (`st.async`). Used by the train step's
// product (train_step.cuh) and the latent stage (latent_stage.cu).
//
// Operand tiles. A tile is 64 lines of 128 bytes (64 bf16 values), line l
// at byte 128 l, its 16-byte chunk c stored at chunk c ^ (l % 8): the
// 128-byte swizzle, on a 1024-byte-aligned base. A line is a row of 64 k's
// for a K-major operand and 64 consecutive rows (m or n) at one k for an
// MN-major one; `wg_desc` describes either to `wgmma` (the transpose flag
// of `wgmma_m64n32k16` says which for A; B is K-major).
//
// Tensor maps. `cuTensorMapEncodeTiled` is not in the runtime library; it is
// taken through `cudaGetDriverEntryPoint`, so nothing beyond the runtime is
// linked. `wg_map` encodes a map of an f32 matrix (64 x 64 boxes by default,
// zero fill outside the bounds), `wg_map_bf16` one of a bf16 matrix read as
// 3-D boxes of several 128-byte-swizzled k64 tiles; both count the encode
// (`map_encodes`). They keep nothing: the train step encodes every map of
// its products once, when the step is planned (`StepPlan` in
// train_step.cuh), the stage when it is bound, and both launch from what
// they encoded.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the function comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace fdh {

constexpr long long kWaitCycles = 1LL << 31;  // ~1 s: a lost copy traps, never hangs
constexpr int kBox = 64;                      // f32 tile of a TMA load: 64 x 64

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed; trap (a launch
// error the host sees at its next synchronise) if it never does.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long t0 = 0;
  for (long long spins = 0;; ++spins) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == 0) t0 = clock64();
    else if (clock64() - t0 > kWaitCycles) __trap();
  }
}

// The shared::cluster address of offset `addr` (a shared::cta address) in
// the block of cluster rank `rank`.
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// One arrival on the mbarrier at the shared::cluster address `bar` (this
// block's or another's). Without a cluster-scope release: the arrivals
// stand for reads that are already complete (a wgmma-group waited for),
// and a cluster-scope fence on each cost ~1 us.
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// 16 (8) bytes into the shared::cluster address `dst`, completing their
// bytes on the mbarrier at the shared::cluster address `bar` of the same
// block.
__device__ __forceinline__ void st_async(uint32_t dst, uint4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(dst),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async(uint32_t dst, float2 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n" ::"r"(
          dst),
      "f"(v.x), "f"(v.y), "r"(bar)
      : "memory");
}

// Cluster barrier in two halves: arrive early, wait (acquire) later. The
// arrival is relaxed: what it publishes (mbarrier initialisations) is
// released by fence_barrier_init.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Order this thread's generic-proxy accesses of shared memory before later
// async-proxy ones (a TMA refill of a slot it read, a wgmma of a tile it
// wrote).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `count` threads (whole warps) meet at named barrier `id` (0 is __syncthreads').
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"((uint64_t)map) : "memory");
}

// The box of `map` at (c0 inner, c1 outer) into shared memory at `dst`;
// completes on `bar` with the box's bytes (elements outside the bounds are
// zeros and count too).
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// The box of a 3-D `map` at (c0, c1, c2), as tma_load_2d.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// The box of `map` at (c0 inner, c1 outer) from shared memory at `src`, into
// device memory (elements outside the bounds are not written); one bulk
// group of this thread.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, int c0, int c1,
                                             uint32_t src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n" ::"l"(
          (uint64_t)map),
      "r"(c0), "r"(c1), "r"(src)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// This thread's bulk stores have read their shared memory (it may be rewritten).
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// The descriptor of a swizzled operand tile starting at shared address
// `addr`: 8-line groups 1024 bytes apart (the stride byte offset), the
// leading byte offset unused (a K-major line holds the whole k16 step; an
// MN-major tile is one 64-wide line across), 128-byte swizzle.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// All but the most recent wgmma-group done.
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// d (64 x 32, f32) += A (64 x 16) B (16 x 32), bf16 operands in shared
// memory, B K-major. kTA: A is MN-major (1) or K-major (0). Thread (warp w
// of the warpgroup, lane 4g + t) holds d[4j + 2h + e] = D[16w + g + 8h][8j +
// 2t + e].
template <int kTA>
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(kTA));
}

// d (64 x N, f32) += A (64 x 16) B (16 x N), N in {8, 16, 24, 32, 64, 128}: as
// wgmma_m64n32k16, the thread's d[4j + 2h + e] = D[16w + g + 8h][8j + 2t + e]
// for j < N / 8.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  template <int kTA>
  static __device__ __forceinline__ void run(float (&d)[4], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %6, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "%4, %5, p, 1, 1, %7, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(1), "n"(kTA));
  }
};

template <>
struct Wgmma<16> {
  template <int kTA>
  static __device__ __forceinline__ void run(float (&d)[8], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, %11, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(1), "n"(kTA));
  }
};

template <>
struct Wgmma<24> {
  template <int kTA>
  static __device__ __forceinline__ void run(float (&d)[12], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %14, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
        "%12, %13, p, 1, 1, %15, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "l"(da), "l"(db), "r"(1), "n"(kTA));
  }
};

template <>
struct Wgmma<32> {
  template <int kTA>
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, %19, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(1), "n"(kTA));
  }
};

template <>
struct Wgmma<64> {
  template <int kTA>
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1), "n"(kTA));
  }
};

template <>
struct Wgmma<128> {
  template <int kTA>
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1), "n"(kTA));
  }
};

// ---------------------------------------------------------------------------
// Host: tensor maps of f32 and bf16 matrices.

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (e == cudaSuccess && found == cudaDriverEntryPointSuccess) ? (EncodeTiled)p : nullptr;
  }();
  return fn;
}

// Calls of cuTensorMapEncodeTiled by this library (each library that
// includes this header counts its own).
static std::atomic<long long> encodes{0};

inline long long map_encodes() { return encodes.load(std::memory_order_relaxed); }

// A map of the f32 matrix at `base`, `outer` lines of `inner` elements, line
// stride `ld` elements, moved in boxes of (box_inner, box_outer) elements,
// laid out in shared memory with the 128-byte swizzle or without. False
// where the encode refuses it (base not 16-byte aligned, ld * 4 not a
// multiple of 16).
inline bool wg_map(CUtensorMap* map, const float* base, uint64_t inner, uint64_t outer,
                   uint64_t ld, uint32_t box_inner = kBox, uint32_t box_outer = kBox,
                   bool swizzle = false) {
  const EncodeTiled encode = encode_tiled();
  if (!encode || !base || inner < 1 || outer < 1 || ld < inner) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {ld * sizeof(float)};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  encodes.fetch_add(1, std::memory_order_relaxed);
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)base, dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// A map of the (rows, k) bf16 matrix at `base` (row stride `ld` elements)
// as 3-D: (64 k's, rows, k / 64 k-tiles), k-tile t of row r at byte 2 ld r +
// 128 t; read in boxes of (64, box_rows, box_tiles) that land in shared
// memory as box_tiles tiles of box_rows lines of 128 bytes, each line
// 128-byte swizzled: one request brings box_tiles k64 steps of box_rows
// weight rows. Zeros outside the bounds. False where the encode refuses it
// (base not 16-byte aligned, ld * 2 not a multiple of 16, a box dimension
// above 256).
inline bool wg_map_bf16(CUtensorMap* map, const void* base, uint64_t rows, uint64_t k,
                        uint64_t ld, uint32_t box_rows, uint32_t box_tiles) {
  const EncodeTiled encode = encode_tiled();
  if (!encode || !base || rows < 1 || k < 64 || k % 64 || ld < k) return false;
  const cuuint64_t dims[3] = {64, rows, k / 64};
  const cuuint64_t strides[2] = {ld * 2, 128};
  const cuuint32_t box[3] = {64, box_rows, box_tiles};
  const cuuint32_t elem[3] = {1, 1, 1};
  encodes.fetch_add(1, std::memory_order_relaxed);
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, (void*)base, dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace fdh
