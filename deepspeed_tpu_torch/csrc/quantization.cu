// Per-group symmetric absmax quantization for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/quantization.py quantize_symmetric ->
//   _quant_sym_kernel (pallas_call at :44).
//
// What it computes: x flat (n,) in fp32, bf16 or fp16, cut into groups of
// group_size consecutive elements; per group, in fp32,
//   scale = absmax == 0 ? 1 : absmax / qmax,    qmax = 2^(bits-1) - 1
//   q     = clip(round_half_even(x / scale), -qmax - 1, qmax)
// q is int8 (int4 held unpacked in int8, in [-8, 7]) and one fp32 scale per
// group is written (the TPU kernel wrote a (groups, group_size) broadcast of
// it and padded to 8 groups a block; neither is needed here). Both divisions
// are IEEE round-to-nearest (__fdiv_rn; the library is built without
// --use_fast_math) and the rounding is rintf, so q and the scales equal the
// plain version's bit for bit.
//
// Bound on the H100: bytes. Each element is read once (2 or 4 bytes) and
// its q written once (1 byte), plus 4 bytes of scale a group: at OPT-1.3B's
// 1.316 B bf16 parameters in groups of 128, 3.99 GB, 1.19 ms at 3.35 TB/s.
// Design: SUB lanes of a warp per group (SUB = the group's 16-byte chunks,
// at most 32), 16-byte loads when the group and the pointer allow them,
// scalar otherwise. Pass 1 takes the absmax by a shuffle over the SUB lanes;
// pass 2 reads the group again (an L1 hit: the warp has just read it) and
// writes q as V-byte words.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <int V>
struct alignas(V) QPack {
  int8_t v[V];
};

template <typename T, int V, int SUB>
__global__ void __launch_bounds__(kThreads)
quant_sym_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                 float* __restrict__ scales, int64_t groups, int group_size,
                 float qmax) {
  constexpr int PER_BLOCK = kThreads / SUB;
  const int sub = threadIdx.x % SUB;
  const int64_t g = (int64_t)blockIdx.x * PER_BLOCK + threadIdx.x / SUB;
  const bool live = g < groups;  // every lane takes part in the shuffles
  const int chunks = group_size / V;
  const T* xg = x + (live ? g : 0) * group_size;

  float amax = 0.f;
  if (live)
    for (int c = sub; c < chunks; c += SUB) {
      const Pack<T, V> p = *reinterpret_cast<const Pack<T, V>*>(xg + c * V);
#pragma unroll
      for (int j = 0; j < V; ++j) amax = fmaxf(amax, fabsf(to_f(p.v[j])));
    }
#pragma unroll
  for (int o = SUB / 2; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (!live) return;
  const float scale = amax == 0.f ? 1.f : __fdiv_rn(amax, qmax);
  if (sub == 0) scales[g] = scale;
  int8_t* qg = q + g * group_size;
  for (int c = sub; c < chunks; c += SUB) {
    const Pack<T, V> p = *reinterpret_cast<const Pack<T, V>*>(xg + c * V);
    QPack<V> out;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float r = rintf(__fdiv_rn(to_f(p.v[j]), scale));
      out.v[j] = (int8_t)(int)fminf(fmaxf(r, -qmax - 1.f), qmax);
    }
    *reinterpret_cast<QPack<V>*>(qg + c * V) = out;
  }
}

template <typename T, int V>
void launch_v(const void* x, int8_t* q, float* scales, int64_t groups,
              int group_size, float qmax, cudaStream_t st) {
  const int chunks = group_size / V;
  int sub = 1;
  while (sub < 32 && sub * 2 <= chunks) sub *= 2;
  const int64_t per_block = kThreads / sub;
  const dim3 grid((unsigned)((groups + per_block - 1) / per_block));
#define DSTT_QUANT(SUB)                                                    \
  quant_sym_kernel<T, V, SUB><<<grid, kThreads, 0, st>>>(                  \
      (const T*)x, q, scales, groups, group_size, qmax)
  switch (sub) {
    case 1: DSTT_QUANT(1); break;
    case 2: DSTT_QUANT(2); break;
    case 4: DSTT_QUANT(4); break;
    case 8: DSTT_QUANT(8); break;
    case 16: DSTT_QUANT(16); break;
    default: DSTT_QUANT(32); break;
  }
#undef DSTT_QUANT
}

template <typename T>
void launch(const void* x, int8_t* q, float* scales, int64_t groups,
            int group_size, float qmax, int vec, cudaStream_t st) {
  if (vec)
    launch_v<T, 16 / (int)sizeof(T)>(x, q, scales, groups, group_size, qmax, st);
  else
    launch_v<T, 1>(x, q, scales, groups, group_size, qmax, st);
}

}  // namespace

// x: (groups * group_size,) of dtype 0 = float32, 1 = bfloat16, 2 = float16;
// q: int8 of the same length; scales: (groups,) float32. vec = 1 only when
// group_size % (16 / itemsize) == 0 and x is 16-byte aligned (the wrapper
// checks; q is a fresh allocation). bits is 4 or 8. Returns
// cudaGetLastError() after the launch.
extern "C" int dstt_quantize_symmetric(const void* x, int8_t* q,
                                       float* scales, int64_t groups,
                                       int group_size, int bits, int dtype,
                                       int vec, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float qmax = (float)((1 << (bits - 1)) - 1);
  if (groups > 0) {
    if (dtype == 0)
      launch<float>(x, q, scales, groups, group_size, qmax, vec, st);
    else if (dtype == 1)
      launch<__nv_bfloat16>(x, q, scales, groups, group_size, qmax, vec, st);
    else
      launch<__half>(x, q, scales, groups, group_size, qmax, vec, st);
  }
  return (int)cudaGetLastError();
}
