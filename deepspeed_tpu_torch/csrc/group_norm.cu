// GroupNorm over NHWC tokens for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/spatial.py fused_group_norm -> _gn_kernel
//   (pallas_call at :101).
//
// What it computes: x (B, HW, C) in fp32, bf16 or fp16, C = G * cg; for
// each (batch b, group g) the mean and variance over the HW x cg elements
// of channels [g * cg, (g + 1) * cg), in fp32; then per element
//   y = (x - mean) * rsqrt(var + eps) * scale[c] + bias[c]
// in x's dtype (scale / bias fp32 or x's dtype). The statistics are not the
// TPU kernel's one-pass sum(x^2) / n - mean^2, which cancels (and goes
// negative, NaN after rsqrt) when |mean| >> std: each lane keeps a Welford
// state (count, mean, M2) that takes a vector's own mean and M2 at a time,
// and states are merged by Chan's formula. The states are of x - shift, the
// shift being the group's first element of the batch row, and the output is
// ((x - shift) - mean) * rstd: at 300 + 0.01 N(0, 1) an fp32 mean of x
// itself would be off by ulps of 300, i.e. 0.3% of the std each, where the
// shifted one is exact to ulps of 0.01.
//
// Bound on the H100: bytes. x is read once and y written once, ~3 flops an
// element: at the SD v1.5 VAE mid block (B 4, HW 4096, C 512, bf16) 16.8 MB,
// 10.0 us at 3.35 TB/s. Design, two launches:
//   1. gn_stats_kernel: one warp per (b, chunk of RC rows, g) unit writes
//      that unit's shifted (mean, M2) to a (B, G, chunks) scratch the wrapper
//      allocates. Lanes walk the unit's (row, vector) items, a vector being
//      V channels of one group (V = 16 bytes' worth, cut down until it
//      divides cg), then merge by a shuffle butterfly.
//   2. gn_apply_kernel: one block per (RA rows, b). Its warps first merge
//      the chunks' states of each group of b (lanes over chunks, then a
//      butterfly) into mean and rstd in shared memory, then the block
//      normalises its rows with V-wide loads and stores.
// x is read twice (the second read often from the 50 MB L2) and written
// once. Neither launch depends on the order in which blocks run.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroups = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half(x); }

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// Chan's merge of (nb, mb, m2b) into (n, m, m2).
__device__ __forceinline__ void merge(float& n, float& m, float& m2, float nb,
                                      float mb, float m2b) {
  const float nt = n + nb;
  if (nt == 0.f) return;
  const float d = mb - m, w = nb / nt;
  m = m + d * w;
  m2 = m2 + m2b + d * d * n * w;
  n = nt;
}

__device__ __forceinline__ void warp_merge(float& n, float& m, float& m2) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float nb = __shfl_xor_sync(0xffffffffu, n, o);
    const float mb = __shfl_xor_sync(0xffffffffu, m, o);
    const float m2b = __shfl_xor_sync(0xffffffffu, m2, o);
    merge(n, m, m2, nb, mb, m2b);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const T* __restrict__ x, float2* __restrict__ part, int B,
                int HW, int C, int G, int RC, int chunks) {
  const int lane = threadIdx.x & 31;
  const int64_t unit = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (unit >= (int64_t)B * chunks * G) return;  // warp-uniform
  const int g = (int)(unit % G);
  const int chunk = (int)((unit / G) % chunks);
  const int b = (int)(unit / ((int64_t)G * chunks));
  const int cg = C / G, nvg = cg / V;
  const int r0 = chunk * RC, rows = min(RC, HW - r0);
  const T* xb = x + ((int64_t)b * HW + r0) * C + g * cg;
  const float shift = to_f(x[(int64_t)b * HW * C + g * cg]);

  float n = 0.f, m = 0.f, m2 = 0.f;
  for (int e = lane; e < rows * nvg; e += 32) {
    const int r = e / nvg, j = e - r * nvg;
    const Pack<T, V> p =
        *reinterpret_cast<const Pack<T, V>*>(xb + (int64_t)r * C + j * V);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) s += to_f(p.v[i]) - shift;
    const float mv = s / (float)V;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float d = (to_f(p.v[i]) - shift) - mv;
      q += d * d;
    }
    merge(n, m, m2, (float)V, mv, q);
  }
  warp_merge(n, m, m2);
  if (lane == 0) part[((int64_t)b * G + g) * chunks + chunk] = make_float2(m, m2);
}

template <typename T, typename S, int V>
__global__ void __launch_bounds__(kThreads)
gn_apply_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                const S* __restrict__ bias, T* __restrict__ y,
                const float2* __restrict__ part, int HW, int C, int G, int RC,
                int chunks, int RA, float eps) {
  __shared__ float shift_s[kMaxGroups], mean_s[kMaxGroups], rstd_s[kMaxGroups];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cg = C / G;
  for (int g = warp; g < G; g += kWarps) {
    float n = 0.f, m = 0.f, m2 = 0.f;
    const float2* pg = part + ((int64_t)b * G + g) * chunks;
    for (int c = lane; c < chunks; c += 32) {
      const float2 st = pg[c];
      merge(n, m, m2, (float)(min(RC, HW - c * RC) * cg), st.x, st.y);
    }
    warp_merge(n, m, m2);
    if (lane == 0) {
      shift_s[g] = to_f(x[(int64_t)b * HW * C + g * cg]);
      mean_s[g] = m;
      rstd_s[g] = rsqrtf(m2 / n + eps);
    }
  }
  __syncthreads();

  const int ncv = C / V;
  const int r0 = blockIdx.x * RA, rows = min(RA, HW - r0);
  const int64_t base = ((int64_t)b * HW + r0) * C;
  for (int e = threadIdx.x; e < rows * ncv; e += kThreads) {
    const int r = e / ncv, cv = e - r * ncv, c0 = cv * V, g = c0 / cg;
    const int64_t off = base + (int64_t)r * C + c0;
    const Pack<T, V> p = *reinterpret_cast<const Pack<T, V>*>(x + off);
    const Pack<S, V> sc = *reinterpret_cast<const Pack<S, V>*>(scale + c0);
    const Pack<S, V> bi = *reinterpret_cast<const Pack<S, V>*>(bias + c0);
    const float shift = shift_s[g], mean = mean_s[g], rstd = rstd_s[g];
    Pack<T, V> out;
#pragma unroll
    for (int i = 0; i < V; ++i)
      out.v[i] = from_f<T>(((to_f(p.v[i]) - shift) - mean) * rstd *
                               to_f(sc.v[i]) +
                           to_f(bi.v[i]));
    *reinterpret_cast<Pack<T, V>*>(y + off) = out;
  }
}

template <typename T, typename S, int V>
void launch_v(const void* x, const void* scale, const void* bias, void* y,
              float2* part, int B, int HW, int C, int G, int RC, int chunks,
              int RA, float eps, cudaStream_t st) {
  const int64_t units = (int64_t)B * chunks * G;
  gn_stats_kernel<T, V><<<(unsigned)((units + kWarps - 1) / kWarps), kThreads,
                          0, st>>>((const T*)x, part, B, HW, C, G, RC, chunks);
  const dim3 grid((unsigned)((HW + RA - 1) / RA), (unsigned)B);
  gn_apply_kernel<T, S, V><<<grid, kThreads, 0, st>>>(
      (const T*)x, (const S*)scale, (const S*)bias, (T*)y, part, HW, C, G, RC,
      chunks, RA, eps);
}

template <typename T, typename S>
void launch_s(const void* x, const void* scale, const void* bias, void* y,
              float2* part, int B, int HW, int C, int G, int RC, int chunks,
              int RA, float eps, int vec, cudaStream_t st) {
  if (vec == 8)
    launch_v<T, S, 8>(x, scale, bias, y, part, B, HW, C, G, RC, chunks, RA, eps, st);
  else if (vec == 4)
    launch_v<T, S, 4>(x, scale, bias, y, part, B, HW, C, G, RC, chunks, RA, eps, st);
  else if (vec == 2)
    launch_v<T, S, 2>(x, scale, bias, y, part, B, HW, C, G, RC, chunks, RA, eps, st);
  else
    launch_v<T, S, 1>(x, scale, bias, y, part, B, HW, C, G, RC, chunks, RA, eps, st);
}

template <typename T>
void launch(const void* x, const void* scale, const void* bias, void* y,
            float2* part, int B, int HW, int C, int G, int RC, int chunks,
            int RA, float eps, int vec, int affine_f32, cudaStream_t st) {
  if (affine_f32)
    launch_s<T, float>(x, scale, bias, y, part, B, HW, C, G, RC, chunks, RA,
                       eps, vec, st);
  else
    launch_s<T, T>(x, scale, bias, y, part, B, HW, C, G, RC, chunks, RA, eps,
                   vec, st);
}

}  // namespace

// x, y: (B, HW, C) of dtype 0 = float32, 1 = bfloat16, 2 = float16; scale,
// bias: (C,) float32 when affine_f32, else x's dtype; part: (B, G, chunks)
// float2 scratch, chunks = ceil(HW / RC); RA rows per normalising block.
// vec is the elements per access: it divides C / G, vec * itemsize <= 16
// (fp32 x: vec <= 4) and every pointer is aligned to vec elements (the
// wrapper checks); G <= 128. Returns cudaGetLastError() after the launches.
extern "C" int dstt_group_norm_fwd(const void* x, const void* scale,
                                   const void* bias, void* y, void* part,
                                   int B, int HW, int C, int G, int RC,
                                   int RA, float eps, int dtype, int vec,
                                   int affine_f32, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B > 0 && HW > 0 && C > 0) {
    const int chunks = (HW + RC - 1) / RC;
    float2* p = (float2*)part;
    if (dtype == 0)
      launch<float>(x, scale, bias, y, p, B, HW, C, G, RC, chunks, RA, eps,
                    vec, affine_f32, st);
    else if (dtype == 1)
      launch<__nv_bfloat16>(x, scale, bias, y, p, B, HW, C, G, RC, chunks, RA,
                            eps, vec, affine_f32, st);
    else
      launch<__half>(x, scale, bias, y, p, B, HW, C, G, RC, chunks, RA, eps,
                     vec, affine_f32, st);
  }
  return (int)cudaGetLastError();
}
