// Hopper (sm_90a) building blocks of the port's kernels that stream tiles
// with the Tensor Memory Accelerator (quant_matmul_a8.cu,
// flash_attention_bwd.cu):
// * device: shared-memory addresses, mbarriers, TMA tensor and bulk copies,
//   stores into another block's shared memory of the cluster, proxy fences,
//   named barriers, and wgmma (shared-memory matrix descriptors, fences,
//   commit / wait, and the m64nNk16 products with fp32 accumulators, A from
//   shared memory or from registers);
// * host: cuTensorMapEncodeTiled, looked up at run time, behind a bounded
//   cache keyed by everything a map depends on.
// Each .cu file is its own library, so everything here has internal linkage.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <mutex>
#include <unordered_map>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---------------------------------------------------------------------------
// mbarriers (shared memory, this block)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count));
}
// the barriers' initialisation made visible to the async proxy and the
// cluster; then a block-wide barrier before their first use
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// writes of this thread to shared memory (st.shared) made visible to the
// async proxy (wgmma operands, TMA) of this block; then a barrier before
// another thread's wgmma reads them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` (1..15; 0 is __syncthreads) over `threads` threads, a
// multiple of 32
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// clusters
// ---------------------------------------------------------------------------

// the shared::cluster address of a variable of this block's shared memory
// in block `rank` of the cluster
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}

// stores into another block's shared memory, counted (bytes) on that
// block's mbarrier: nothing waits here, the receiver waits on its barrier
__device__ __forceinline__ void st_async(uint32_t addr, float v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n" :: "r"(addr), "f"(v), "r"(bar) : "memory");
}
__device__ __forceinline__ void st_async(uint32_t addr, uint4 v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n"
      :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------------------
// TMA: tensor boxes and bulk copies into this block's shared memory,
// completion counted (bytes) on bar
// ---------------------------------------------------------------------------

// the box of a 2-D map at (column x, row y); dst 128-byte aligned (1024 for
// a 128-byte swizzle)
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x),
         "r"(y), "r"(smem_addr(bar))
      : "memory");
}
// the box of a 4-D map at coordinates (c0 innermost, .., c3)
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(bar))
      : "memory");
}
// `bytes` (a multiple of 16) contiguous bytes from src (16-byte aligned)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// the box of a 4-D map at (c0, .., c3) += this block's shared memory at src
// (fp32 add, done by the TMA unit; elements past the edges are skipped),
// tracked as a bulk group of this thread
__device__ __forceinline__ void tma_reduce_add_4d(const CUtensorMap* map,
                                                  const void* src, int c0,
                                                  int c1, int c2, int c3) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}
// until at most N of this thread's bulk groups are incomplete
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// wgmma: one warpgroup (4 consecutive warps, the first a multiple of 4)
// computes D (64 x N, fp32, in registers) += A (64 x 16) B (16 x N)
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor (PTX ISA, "Matrix Descriptor Format"):
// start address, leading and stride byte offsets (16-byte units), base
// offset 0 (every tile starts on a 1024-byte boundary), and the swizzle of
// the rows: SW 128, 64 or 32 bytes, as the TMA map that wrote them.
// K-major (the reduction dim contiguous, rows of SW bytes): SBO = 8 rows;
// a k16 step inside a row advances the start by 32 bytes. MN-major (M / N
// contiguous in rows of SW bytes, one row per k): LBO = the stride of the
// next SW-byte column panel, SBO = 8 rows; a k16 step advances 16 rows.
template <int SW>
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  static_assert(SW == 128 || SW == 64 || SW == 32, "swizzle");
  constexpr uint64_t layout = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4)
         | (uint64_t)((lbo >> 4) & 0x3FFF) << 16
         | (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
}

// before the first wgmma, and after other instructions wrote its
// accumulator or A registers
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Registers a wgmma reads or writes asynchronously, pinned at this point
// for the compiler: after a wait, accumulators are read only from here on
// and A fragments are not reused before.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int R, int C>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) asm volatile("" : "+r"(a[i][j]) :: "memory");
}

// Wgmma<T, N>::ss<TA, TB>(d, desc_a, desc_b, acc): A and B from shared
// memory, TA / TB = 1 for an MN-major operand; ::rs<TB>(d, a, desc_b, acc):
// A from registers (the m16n8k16 A fragment of the warp's 16 rows). d holds
// N / 2 floats: element i is row 16 * warp + lane / 4 + 8 * (i % 4 / 2),
// column 8 * (i / 4) + 2 * (lane % 4) + i % 2. acc = 0 overwrites d.
template <typename T, int N> struct Wgmma;

#define DSTT_WG_R8 "{" "%0, %1, %2, %3" "}"
#define DSTT_WG_R16 "{" "%0, %1, %2, %3, %4, %5, %6, %7" "}"
#define DSTT_WG_R32 "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
    "%12, %13, %14, %15" "}"
#define DSTT_WG_R64 "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
    "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "      \
    "%25, %26, %27, %28, %29, %30, %31" "}"
#define DSTT_WG_R128 "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
    "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "       \
    "%25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "       \
    "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, "       \
    "%51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" "}"
#define DSTT_WG_O8(d) "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
#define DSTT_WG_O16(d) DSTT_WG_O8(d), DSTT_WG_O8((d + 4))
#define DSTT_WG_O32(d) DSTT_WG_O16(d), DSTT_WG_O16((d + 8))
#define DSTT_WG_O64(d) DSTT_WG_O32(d), DSTT_WG_O32((d + 16))
#define DSTT_WG_O128(d) DSTT_WG_O64(d), DSTT_WG_O64((d + 32))
// the operands after the N / 2 accumulators: ss (desc_a, desc_b, acc, TA,
// TB), rs (a0..a3, desc_b, acc, TB)
#define DSTT_WG_SS8 "setp.ne.b32 p, %6, 0;\n", " %4, %5, p, 1, 1, %7, %8;\n"
#define DSTT_WG_SS16 "setp.ne.b32 p, %10, 0;\n", " %8, %9, p, 1, 1, %11, %12;\n"
#define DSTT_WG_SS32 "setp.ne.b32 p, %18, 0;\n", \
    " %16, %17, p, 1, 1, %19, %20;\n"
#define DSTT_WG_SS64 "setp.ne.b32 p, %34, 0;\n", \
    " %32, %33, p, 1, 1, %35, %36;\n"
#define DSTT_WG_SS128 "setp.ne.b32 p, %66, 0;\n", \
    " %64, %65, p, 1, 1, %67, %68;\n"
#define DSTT_WG_RS8 "setp.ne.b32 p, %9, 0;\n", \
    " {%4, %5, %6, %7}, %8, p, 1, 1, %10;\n"
#define DSTT_WG_RS16 "setp.ne.b32 p, %13, 0;\n", \
    " {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n"
#define DSTT_WG_RS32 "setp.ne.b32 p, %21, 0;\n", \
    " {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
#define DSTT_WG_RS64 "setp.ne.b32 p, %37, 0;\n", \
    " {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
#define DSTT_WG_RS128 "setp.ne.b32 p, %69, 0;\n", \
    " {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
#define DSTT_WG_PICK0(a, b) a
#define DSTT_WG_PICK1(a, b) b
#define DSTT_WG_FIRST(x) DSTT_WG_PICK0 x
#define DSTT_WG_SECOND(x) DSTT_WG_PICK1 x

#define DSTT_WGMMA(TY, PTX, N)                                                \
  template <> struct Wgmma<TY, N> {                                           \
    template <int TA, int TB>                                                 \
    static __device__ __forceinline__ void ss(float (&d)[N / 2], uint64_t da, \
                                              uint64_t db, int acc) {         \
      asm volatile(                                                           \
          "{\n.reg .pred p;\n" DSTT_WG_FIRST((DSTT_WG_SS##N))                 \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." PTX "." PTX " "   \
          DSTT_WG_R##N "," DSTT_WG_SECOND((DSTT_WG_SS##N)) "}\n"              \
          : DSTT_WG_O##N(d)                                                   \
          : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));                    \
    }                                                                         \
    template <int TB>                                                         \
    static __device__ __forceinline__ void rs(float (&d)[N / 2],              \
                                              const uint32_t (&a)[4],         \
                                              uint64_t db, int acc) {         \
      asm volatile(                                                           \
          "{\n.reg .pred p;\n" DSTT_WG_FIRST((DSTT_WG_RS##N))                 \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." PTX "." PTX " "   \
          DSTT_WG_R##N "," DSTT_WG_SECOND((DSTT_WG_RS##N)) "}\n"              \
          : DSTT_WG_O##N(d)                                                   \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc),    \
            "n"(TB));                                                         \
    }                                                                         \
  };

DSTT_WGMMA(__nv_bfloat16, "bf16", 8)
DSTT_WGMMA(__nv_bfloat16, "bf16", 16)
DSTT_WGMMA(__nv_bfloat16, "bf16", 32)
DSTT_WGMMA(__nv_bfloat16, "bf16", 64)
DSTT_WGMMA(__nv_bfloat16, "bf16", 128)
DSTT_WGMMA(__half, "f16", 8)
DSTT_WGMMA(__half, "f16", 16)
DSTT_WGMMA(__half, "f16", 32)
DSTT_WGMMA(__half, "f16", 64)
DSTT_WGMMA(__half, "f16", 128)

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// everything a map is encoded from, zero-padded so that it compares and
// hashes as bytes
struct MapKey {
  const void* base;
  cuuint64_t dims[5], strides[4];
  cuuint32_t box[5];
  int type, rank, swizzle, l2;
  bool operator==(const MapKey& o) const {
    return std::memcmp(this, &o, sizeof(MapKey)) == 0;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    const unsigned char* p = reinterpret_cast<const unsigned char*>(&k);
    uint64_t h = 1469598103934665603ull;             // FNV-1a
    for (size_t i = 0; i < sizeof(MapKey); ++i)
      h = (h ^ p[i]) * 1099511628211ull;
    return (size_t)h;
  }
};

// The tensor map of a `rank`-D tensor at `base`: dims innermost first,
// strides in bytes of dims 1 .. rank - 1, boxes of `box` elements (unit
// element strides), zeros read past the edges. A map depends only on those
// and on type, swizzle and L2 promotion, so it is built once per distinct
// key; the cache is emptied when it reaches kMaxMaps entries (a training
// loop calls again with the same addresses, but not forever).
inline cudaError_t tensor_map(CUtensorMap* map, CUtensorMapDataType type,
                              int rank, const void* base,
                              const cuuint64_t* dims,
                              const cuuint64_t* strides, const cuuint32_t* box,
                              CUtensorMapSwizzle swizzle,
                              CUtensorMapL2promotion l2) {
  constexpr size_t kMaxMaps = 1024;
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> maps;
  static EncodeTiled encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<EncodeTiled>(fn);
  }();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (rank < 1 || rank > 5) return cudaErrorInvalidValue;
  MapKey key;
  std::memset(&key, 0, sizeof(key));
  key.base = base;
  key.type = (int)type;
  key.rank = rank;
  key.swizzle = (int)swizzle;
  key.l2 = (int)l2;
  for (int i = 0; i < rank; ++i) {
    key.dims[i] = dims[i];
    key.box[i] = box[i];
    if (i > 0) key.strides[i - 1] = strides[i - 1];
  }
  std::lock_guard<std::mutex> lock(mu);
  auto it = maps.find(key);
  if (it == maps.end()) {
    CUtensorMap m;
    const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
    if (encode(&m, type, (cuuint32_t)rank, const_cast<void*>(base),
               key.dims, key.strides, key.box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, l2,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
    if (maps.size() >= kMaxMaps) maps.clear();
    it = maps.emplace(key, m).first;
  }
  *map = it->second;
  return cudaSuccess;
}

}  // namespace
