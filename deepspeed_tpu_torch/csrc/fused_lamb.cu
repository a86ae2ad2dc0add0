// LAMB phase 1 over flat buffers for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/fused_lamb.py fused_lamb_flat ->
//   _lamb_phase1_kernel (pallas_call at :82).
//
// What it computes, per element of the flat fp32 params p (the master
// copy), the gradient g (fp32, bf16 or fp16) and the fp32 moments m, v:
//   g = g * grad_scale                     (optional device scalar: the clip
//                                           coefficient / loss unscale)
//   m = b1 * m + (1 - b1) * g,  v = b2 * v + (1 - b2) * g * g   (in place)
//   u = (m / bc1) / (sqrt(v / bc2) + eps) + wd * p   (bc = 1 without
//                                           correction; wd term when wd != 0)
// and writes u, plus one partial sum of p^2 and of u^2 for each block of the
// plan. The plan cuts the buffer into blocks of at most 8192 elements that
// never straddle a segment (a leaf of the optimizer's tree; JAX's blocks of
// 8192 over one tensor are the one-segment case), so each segment's two
// norms are exact sums of its blocks' partials. Phase 2 (the segment sums,
// the trust ratio ||p|| / ||u|| set to 1 where a norm is 0 and clamped, and
// p -= lr * ratio * u) is plain torch in ops/fused_lamb.py, as JAX computes
// it in jnp outside Pallas (fused_lamb.py:97-105). When the optional device
// flag ``skip`` is set (an fp16 overflow), m and v are left as they are and
// u and the partials are written as 0, so phase 2 changes nothing either.
//
// Bound on the H100: bytes. Each element reads p, m, v (12 bytes) and g and
// writes m, v, u (12 bytes): 26 bytes with bf16 grads, 34 GB for
// OPT-1.3B's 1.3 B parameters, ~10 ms at 3.35 TB/s; ~16 flops per element
// are noise. Design: one launch for the whole model, one block of 256
// threads per plan block, 16-byte loads of p / m / v and 8- or 16-byte loads
// of g where the block starts 4-element aligned (a scalar loop otherwise and
// for the tail), each byte read once; the block's two sums reduced by warp
// shuffles and shared memory, in a fixed order.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd, bc1, bc2;
};

// one element: new m, v (in place) and the update u; accumulates p^2, u^2
__device__ __forceinline__ float lamb_elem(float p, float g, float& m,
                                           float& v, const Hyper& h,
                                           float& sp, float& su) {
  m = h.b1 * m + h.omb1 * g;
  v = h.b2 * v + h.omb2 * g * g;
  float u = (m / h.bc1) / (sqrtf(v / h.bc2) + h.eps);
  if (h.wd != 0.f) u = u + h.wd * p;
  sp += p * p;
  su += u * u;
  return u;
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

template <typename G>
__global__ void __launch_bounds__(kThreads)
lamb_phase1_kernel(const float* __restrict__ p, const G* __restrict__ g,
                   float* __restrict__ m, float* __restrict__ v,
                   float* __restrict__ u, const int64_t* __restrict__ bstart,
                   const int* __restrict__ blen, float2* __restrict__ partials,
                   Hyper h, const float* __restrict__ grad_scale,
                   const unsigned char* __restrict__ skip, int vec) {
  __shared__ float red[kThreads / 32][2];
  const int64_t start = bstart[blockIdx.x];
  const int len = blen[blockIdx.x];
  float sp = 0.f, su = 0.f;
  if (skip != nullptr && *skip) {
    for (int i = threadIdx.x; i < len; i += kThreads) u[start + i] = 0.f;
  } else {
    const float gs = grad_scale != nullptr ? *grad_scale : 1.f;
    int done = 0;
    if (vec && (start & 3) == 0) {
      const int chunks = len / 4;
      for (int c = threadIdx.x; c < chunks; c += kThreads) {
        const int64_t i = start + (int64_t)c * 4;
        float gg[4];
        load4(g + i, gg);
        const float4 pv = __ldg(reinterpret_cast<const float4*>(p + i));
        const float4 mv = *reinterpret_cast<const float4*>(m + i);
        const float4 vv = *reinterpret_cast<const float4*>(v + i);
        const float pp[4] = {pv.x, pv.y, pv.z, pv.w};
        float mm[4] = {mv.x, mv.y, mv.z, mv.w};
        float ww[4] = {vv.x, vv.y, vv.z, vv.w};
        float uu[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          uu[j] = lamb_elem(pp[j], gg[j] * gs, mm[j], ww[j], h, sp, su);
        *reinterpret_cast<float4*>(m + i) = make_float4(mm[0], mm[1], mm[2], mm[3]);
        *reinterpret_cast<float4*>(v + i) = make_float4(ww[0], ww[1], ww[2], ww[3]);
        *reinterpret_cast<float4*>(u + i) = make_float4(uu[0], uu[1], uu[2], uu[3]);
      }
      done = chunks * 4;
    }
    for (int i = done + threadIdx.x; i < len; i += kThreads) {
      const int64_t e = start + i;
      float mm = m[e], ww = v[e];
      u[e] = lamb_elem(p[e], to_f(g[e]) * gs, mm, ww, h, sp, su);
      m[e] = mm;
      v[e] = ww;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sp += __shfl_xor_sync(0xffffffffu, sp, o);
    su += __shfl_xor_sync(0xffffffffu, su, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[warp][0] = sp;
    red[warp][1] = su;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      a += red[w][0];
      b += red[w][1];
    }
    partials[blockIdx.x] = make_float2(a, b);
  }
}

}  // namespace

// The wrapper (ops/fused_lamb.py) checks devices, dtypes, sizes and
// alignment. p / m / v / u: flat fp32; g: flat of grad_dtype (0 = float32,
// 1 = bfloat16, 2 = float16); bstart (nblocks,) int64 and blen (nblocks,)
// int32: the plan's blocks, each of at most 8192 elements; partials
// (nblocks, 2) fp32; grad_scale: one fp32 or null; skip: one byte or null.
// vec: every buffer is aligned for 4-element vectors. bc1 / bc2: the bias
// corrections 1 - b^t (1 when off). Returns cudaGetLastError() after the
// launch.
extern "C" int dstt_lamb_phase1(const float* p, const void* g, float* m,
                                float* v, float* u, const int64_t* bstart,
                                const int* blen, float* partials,
                                int nblocks, float b1, float omb1, float b2,
                                float omb2, float eps, float wd, float bc1,
                                float bc2, const float* grad_scale,
                                const unsigned char* skip, int grad_dtype,
                                int vec, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Hyper h{b1, omb1, b2, omb2, eps, wd, bc1, bc2};
  float2* part = reinterpret_cast<float2*>(partials);
  if (nblocks > 0) {
    if (grad_dtype == 0)
      lamb_phase1_kernel<float><<<nblocks, kThreads, 0, st>>>(
          p, (const float*)g, m, v, u, bstart, blen, part, h, grad_scale,
          skip, vec);
    else if (grad_dtype == 1)
      lamb_phase1_kernel<__nv_bfloat16><<<nblocks, kThreads, 0, st>>>(
          p, (const __nv_bfloat16*)g, m, v, u, bstart, blen, part, h,
          grad_scale, skip, vec);
    else
      lamb_phase1_kernel<__half><<<nblocks, kThreads, 0, st>>>(
          p, (const __half*)g, m, v, u, bstart, blen, part, h, grad_scale,
          skip, vec);
  }
  return (int)cudaGetLastError();
}
