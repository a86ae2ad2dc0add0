// Fused Adam / AdamW step over flat buffers for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/fused_adam.py fused_adam_flat -> _adam_kernel
//   (pallas_call at :72).
//
// What it computes, per element of the flat fp32 master params p, the
// gradient g (fp32, bf16 or fp16) and the fp32 moments m, v, in place:
//   g  = g * grad_scale                   (optional device scalar: the
//                                          clip coefficient / loss unscale)
//   g += wd * p                           (Adam mode with weight decay)
//   m  = b1 * m + (1 - b1) * g,  v = b2 * v + (1 - b2) * g * g
//   u  = (m / bc1) / (sqrt(v / bc2) + eps)   (bc = 1 without correction)
//   u += wd * p                           (AdamW mode with weight decay)
//   p  = p - lr * u,  and p16 = p rounded to bf16 / fp16 when given
// The whole update is skipped, writing nothing, when the optional device
// flag ``skip`` is set (an fp16 overflow), so the host never reads it.
// lr and the bias corrections are host floats of the host step count.
//
// Bound on the H100: bytes. Each element reads p, m, v (12 bytes) and g
// and writes p, m, v (12 bytes) plus the 16-bit copy: 28 bytes with bf16
// grads and a bf16 copy, 37 GB for OPT-1.3B's 1.3 B parameters, ~11 ms at
// 3.35 TB/s; ~12 flops per element are noise. Design: one launch for the
// whole model (every parameter is a view of one flat buffer), a grid-stride
// loop over 4-element chunks with 16-byte loads of p / m / v and 8- or
// 16-byte loads of g, each byte read once; a scalar tail and a scalar path
// for unaligned buffers.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half(x); }

struct Hyper {
  float lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2;
  int adam_w;
};

__device__ __forceinline__ void adam_elem(float& p, float g, float& m,
                                          float& v, const Hyper& h) {
  if (h.wd != 0.f && !h.adam_w) g = g + h.wd * p;
  m = h.b1 * m + h.omb1 * g;
  v = h.b2 * v + h.omb2 * g * g;
  float u = (m / h.bc1) / (sqrtf(v / h.bc2) + h.eps);
  if (h.wd != 0.f && h.adam_w) u = u + h.wd * p;
  p = p - h.lr * u;
}

// 4 consecutive gradient elements widened to fp32
__device__ __forceinline__ void load4(const float* g, float (&out)[4]) {
  const float4 r = __ldg(reinterpret_cast<const float4*>(g));
  out[0] = r.x; out[1] = r.y; out[2] = r.z; out[3] = r.w;
}
template <typename G>
__device__ __forceinline__ void load4(const G* g, float (&out)[4]) {
  const uint2 r = __ldg(reinterpret_cast<const uint2*>(g));
  const G* e = reinterpret_cast<const G*>(&r);
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = to_f(e[j]);
}

// two fp32 values rounded into one register of the 16-bit copy type
template <typename C> __device__ __forceinline__ uint32_t pack2(float a, float b);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float a, float b) {
  __half2 v = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename C>
__device__ __forceinline__ void store4(C* dst, const float (&p)[4]) {
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(pack2<C>(p[0], p[1]), pack2<C>(p[2], p[3]));
}

// grid-stride over 4-element chunks (vec) or single elements; the skip flag
// and the gradient multiplier are read once per thread
template <typename G, typename C>
__global__ void __launch_bounds__(kThreads)
adam_kernel(float* __restrict__ p, const G* __restrict__ g,
            float* __restrict__ m, float* __restrict__ v, C* __restrict__ p16,
            int64_t n, Hyper h, const float* __restrict__ grad_scale,
            const unsigned char* __restrict__ skip, int vec) {
  if (skip != nullptr && *skip) return;
  const float gs = grad_scale != nullptr ? *grad_scale : 1.f;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t chunks = n / 4;
    for (int64_t c = first; c < chunks; c += stride) {
      const int64_t i = c * 4;
      float gg[4];
      load4(g + i, gg);
      float4 pv = *reinterpret_cast<const float4*>(p + i);
      float4 mv = *reinterpret_cast<const float4*>(m + i);
      float4 vv = *reinterpret_cast<const float4*>(v + i);
      float pp[4] = {pv.x, pv.y, pv.z, pv.w};
      float mm[4] = {mv.x, mv.y, mv.z, mv.w};
      float ww[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) adam_elem(pp[j], gg[j] * gs, mm[j], ww[j], h);
      *reinterpret_cast<float4*>(p + i) = make_float4(pp[0], pp[1], pp[2], pp[3]);
      *reinterpret_cast<float4*>(m + i) = make_float4(mm[0], mm[1], mm[2], mm[3]);
      *reinterpret_cast<float4*>(v + i) = make_float4(ww[0], ww[1], ww[2], ww[3]);
      if (p16 != nullptr) store4(p16 + i, pp);
    }
    done = chunks * 4;
  }
  for (int64_t i = done + first; i < n; i += stride) {
    float pp = p[i], mm = m[i], ww = v[i];
    adam_elem(pp, to_f(g[i]) * gs, mm, ww, h);
    p[i] = pp;
    m[i] = mm;
    v[i] = ww;
    if (p16 != nullptr) p16[i] = from_f<C>(pp);
  }
}

template <typename G>
void launch_g(cudaStream_t st, float* p, const void* g, float* m, float* v,
              void* p16, int copy_dtype, int64_t n, const Hyper& h,
              const float* gscale, const unsigned char* skip, int vec) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t work = vec ? (n + 3) / 4 : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * 8;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  if (copy_dtype == 2)
    adam_kernel<G, __half><<<(unsigned)blocks, kThreads, 0, st>>>(
        p, (const G*)g, m, v, (__half*)p16, n, h, gscale, skip, vec);
  else
    adam_kernel<G, __nv_bfloat16><<<(unsigned)blocks, kThreads, 0, st>>>(
        p, (const G*)g, m, v, (__nv_bfloat16*)p16, n, h, gscale, skip, vec);
}

}  // namespace

// The wrapper (ops/fused_adam.py) checks devices, dtypes, sizes and
// alignment. p / m / v: (n,) fp32; g: (n,) of grad_dtype (0 = float32,
// 1 = bfloat16, 2 = float16); p16: (n,) of copy_dtype (1 bf16, 2 fp16) or
// null; grad_scale: one fp32 or null; skip: one byte or null. vec: every
// buffer is aligned for 4-element vectors. bc1 / bc2: the bias corrections
// 1 - b^t (1 when off). Returns cudaGetLastError() after the launch.
extern "C" int dstt_fused_adam(float* p, const void* g, float* m, float* v,
                               void* p16, int64_t n, float lr, float b1,
                               float omb1, float b2, float omb2, float eps,
                               float wd, float bc1, float bc2, int adam_w,
                               const float* grad_scale,
                               const unsigned char* skip, int grad_dtype,
                               int copy_dtype, int vec, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Hyper h{lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2, adam_w};
  if (n > 0) {
    if (grad_dtype == 0)
      launch_g<float>(st, p, g, m, v, p16, copy_dtype, n, h, grad_scale,
                      skip, vec);
    else if (grad_dtype == 1)
      launch_g<__nv_bfloat16>(st, p, g, m, v, p16, copy_dtype, n, h,
                              grad_scale, skip, vec);
    else
      launch_g<__half>(st, p, g, m, v, p16, copy_dtype, n, h, grad_scale,
                       skip, vec);
  }
  return (int)cudaGetLastError();
}
