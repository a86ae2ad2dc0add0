// Device helpers shared by the attention kernels of deepspeed_tpu_torch
// (paged_attention.cu, flash_attention.cu, decode_attention.cu; the
// weight-only quantized GEMM, quant_matmul.cu, takes its conversions and
// mma.sync wrappers): type conversion, warp reductions, vector row loads,
// and the mma.sync / ldmatrix wrappers of the 16-bit tensor-core paths. Each .cu file is its
// own library, so everything here has internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// *p through the read-only data path (global memory), or a plain load
// (shared memory)
template <bool kGlobal, typename V>
__device__ __forceinline__ V load_vec(const V* p) {
  if constexpr (kGlobal) return __ldg(p);
  else return *p;
}

// NI consecutive elements of a K/V/q row starting at `src` (this lane's
// dims d0 .. d0 + NI - 1), widened to fp32; `src` in global memory, or in
// shared memory with kGlobal false. `vec`: the lanes of a key tile the row
// exactly, so the lane's slice is one aligned vector of NI * sizeof(T)
// bytes and is read as such; otherwise element by element, dims >= D read
// as 0.
template <typename T, int NI, bool kGlobal = true>
__device__ __forceinline__ void load_slice(const T* __restrict__ src, int d0,
                                           int D, bool vec,
                                           float (&dst)[NI]) {
  constexpr int BYTES = NI * (int)sizeof(T);
  if (vec && BYTES >= 4) {
    if constexpr (BYTES % 16 == 0) {
      constexpr int PER = 16 / (int)sizeof(T);
#pragma unroll
      for (int c = 0; c < BYTES / 16; ++c) {
        const uint4 raw =
            load_vec<kGlobal>(reinterpret_cast<const uint4*>(src + d0) + c);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < PER; ++j) dst[c * PER + j] = to_f(e[j]);
      }
    } else if constexpr (BYTES == 8) {
      const uint2 raw =
          load_vec<kGlobal>(reinterpret_cast<const uint2*>(src + d0));
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < NI; ++j) dst[j] = to_f(e[j]);
    } else if constexpr (BYTES == 4) {
      const unsigned raw =
          load_vec<kGlobal>(reinterpret_cast<const unsigned*>(src + d0));
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < NI; ++j) dst[j] = to_f(e[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < NI; ++j)
      dst[j] = d0 + j < D ? to_f(src[d0 + j]) : 0.f;
  }
}

// Sum over the SUB lanes of a sub-warp (SUB a power of two <= 32).
template <int SUB>
__device__ __forceinline__ float sub_sum(float v) {
#pragma unroll
  for (int o = SUB / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// mma.sync m16n8k16 with fp32 accumulation, and packing two fp32 values
// into one register of the 16-bit operand type.
template <typename T> struct Mma;
template <> struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};
template <> struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

}  // namespace
