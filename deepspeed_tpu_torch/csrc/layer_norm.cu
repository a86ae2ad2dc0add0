// Fused LayerNorm / RMSNorm forward for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/normalization.py::fused_layer_norm, the Pallas
// kernels _ln_kernel / _ln_kernel_nobias (pallas_call at normalization.py:59).
// y = norm(x) * scale (+ bias) row by row, statistics in fp32 with a two-pass
// variance (the mean, then the centred sum of squares, as jnp.var; a
// one-pass E[x^2] - mean^2 would cancel), output in the input's type; rms=1
// is RMSNorm (no mean, no bias). Any row count (no padding to the TPU
// kernel's 128-row blocks).
//
// Bound on the H100: memory. Each row is read and written once and does
// O(H) flops, so the least time is (2 * rows * H + H [+ H]) * itemsize bytes
// over 3.35 TB/s: 0.020 ms at 4096 x 4096 bf16. At the decode step's 8 rows
// (128 KB) that is 0.04 us, and the time is the chain of dependent steps
// from launch to store, not bytes.
//
// ln_rows_kernel<T, RMS, BIAS, VPT>: the row in registers, read once. A row
// belongs to a group of `tpr` threads (a multiple of 32); thread t of the
// group holds the row's 16-byte vectors t, t + tpr, ..., at most VPT of them
// (the ragged tail predicated off), so each load instruction of a warp covers
// 512 contiguous bytes. Each thread issues its scale / bias loads and its
// first row's x loads at the top, before any arithmetic, so the scale / bias
// round trip (cold in L2 on the decode path, after the weights of a forward
// streamed through it) overlaps x's instead of following two reductions.
// The mean and the centred sum of squares come from the registers, and y is
// written from them: memory sees one read of the row. A block holds `rpb`
// row groups; group g walks the rows blockIdx.x * rpb + g, then + gridDim.x *
// rpb, ..., keeping scale and bias in registers and loading its next row's x
// before reducing the current one. ops/normalization.py::ln_plan picks VPT,
// tpr, rpb and the grid on the host from shapes only (from trial timings on
// the H100): up to 4 blocks an SM of rows, a block a row on up to 256
// threads with the fewest vectors that cover it (the decode step's 8 rows
// of 4096: 256 threads of 2 vectors in 16 bits); more rows: 4 vectors a
// thread, blocks of at least 128 threads, 4 blocks an SM walking the rows.
//
// Trouble spots:
// 1. Register budget. A thread holds at most 8 vectors each of scale, bias,
//    x and the next row's x (128 registers of data with a bias). VPT 8
//    launches at most 256 threads a block (its launch bounds leave 255
//    registers a thread), VPT 1-4 up to 512 (128 registers). So a row of up
//    to 2048 vectors (H 16384 in 16 bits, 8192 in fp32) fits one group; a
//    longer row takes ln_scalar_kernel. No instantiation spills (ptxas -v).
// 2. The fixed-order sum. A thread sums its values in vector, then element
//    order; a warp sums by an xor butterfly (16, 8, 4, 2, 1), which leaves
//    the same bits in every lane (a + b == b + a); a group of several warps
//    adds the warps' totals, written to shared memory, in warp order after a
//    named barrier of its own (bar.sync 1 + g, tpr). No atomics: two calls
//    give equal bits, and the bits do not depend on the grid size.
// 3. Views. The 16-byte route needs H % (16 / itemsize) == 0 and x, scale,
//    bias and y 16-byte aligned; the wrapper sends every other call to
//    ln_scalar_kernel (one 256-thread block a row, scalar loads, three passes
//    over the row whose second and third hit L1).
// 4. Autograd. The wrapper launches this forward under autograd too, one
//    launch a call; the backward is plain torch (JAX's is jnp).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScalarThreads = 256;
constexpr int kMaxWarps = 16;   // warps of one row group (512 threads)
constexpr int kMaxGroups = 16;  // row groups of one block (512 / 32)

// threads a block of ln_rows_kernel<..., VPT> may have (its launch bounds)
template <int VPT>
struct RowsThreads {
  static constexpr int value = VPT >= 8 ? 256 : 512;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half(x); }

// Sum over a row group of wpr warps; every thread of the group gets the same
// bits. `part` is the group's row of warp totals in one of two buffers that
// its reductions take in turn: a total written for reduction n + 2 follows
// the barrier of reduction n + 1, which every thread of the group reaches
// only after reading the totals of reduction n.
__device__ __forceinline__ float group_sum(float v, float* part, int wpr,
                                           int warp, int barrier, int tpr) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (wpr == 1) return v;
  if ((threadIdx.x & 31) == 0) part[warp] = v;
  asm volatile("bar.sync %0, %1;" ::"r"(barrier), "r"(tpr) : "memory");
  float p[kMaxWarps];  // every load issued before the first add
#pragma unroll
  for (int w = 0; w < kMaxWarps; ++w) p[w] = w < wpr ? part[w] : 0.f;
  float s = p[0];
#pragma unroll
  for (int w = 1; w < kMaxWarps; ++w)
    if (w < wpr) s += p[w];
  return s;
}

// Thread t's vectors t, t + tpr, ... of the row at p (those below nv), when
// `live`: predicated loads, not a branch, so that the compiler issues them
// beside the others (a branch around them cost 0.1-0.2 us at 8 rows).
template <int VPT, typename T>
__device__ __forceinline__ void load_row(uint4 (&v)[VPT], const T* p, int t,
                                         int tpr, int nv, bool live) {
#pragma unroll
  for (int k = 0; k < VPT; ++k)
    if (live && t + k * tpr < nv)
      v[k] = reinterpret_cast<const uint4*>(p)[t + k * tpr];
}

template <typename T, bool RMS, bool BIAS, int VPT>
__global__ void __launch_bounds__(RowsThreads<VPT>::value)
ln_rows_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               const T* __restrict__ bias, T* __restrict__ y, int64_t rows,
               int H, float eps, int tpr, int rpb) {
  constexpr int V = 16 / (int)sizeof(T);  // elements of a 16-byte vector
  __shared__ float part[2][kMaxGroups][kMaxWarps];
  const int g = rpb == 1 ? 0 : threadIdx.x / tpr;  // no division a row a block
  const int t = threadIdx.x - g * tpr;
  const int wpr = tpr >> 5, warp = t >> 5;
  const int nv = H / V;
  const int64_t step = (int64_t)gridDim.x * rpb;
  int64_t row = (int64_t)blockIdx.x * rpb + g;

  uint4 sv[VPT] = {}, bv[VPT] = {}, xn[VPT] = {};
  load_row(sv, scale, t, tpr, nv, true);
  load_row(bv, bias, t, tpr, nv, BIAS);
  load_row(xn, x + row * H, t, tpr, nv, row < rows);
  int turn = 0;
  for (; row < rows; row += step) {
    uint4 xv[VPT];
#pragma unroll
    for (int k = 0; k < VPT; ++k) xv[k] = xn[k];
    // the group's next row is read while this one is reduced
    load_row(xn, x + (row + step) * H, t, tpr, nv, row + step < rows);
    float mean = 0.f;
    if (!RMS) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        if (t + k * tpr < nv) {
          const T* e = reinterpret_cast<const T*>(&xv[k]);
#pragma unroll
          for (int j = 0; j < V; ++j) s += to_f(e[j]);
        }
      }
      mean = group_sum(s, part[turn][g], wpr, warp, 1 + g, tpr) / (float)H;
      turn ^= 1;
    }
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      if (t + k * tpr < nv) {
        const T* e = reinterpret_cast<const T*>(&xv[k]);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float c = to_f(e[j]) - mean;
          ss += c * c;
        }
      }
    }
    const float rstd = rsqrtf(
        group_sum(ss, part[turn][g], wpr, warp, 1 + g, tpr) / (float)H + eps);
    turn ^= 1;
    uint4* yr = reinterpret_cast<uint4*>(y + row * H);
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = t + k * tpr;
      if (i < nv) {
        const T* e = reinterpret_cast<const T*>(&xv[k]);
        const T* sc = reinterpret_cast<const T*>(&sv[k]);
        const T* bi = reinterpret_cast<const T*>(&bv[k]);
        uint4 out;
        T* o = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float v = (to_f(e[j]) - mean) * rstd * to_f(sc[j]);
          if (BIAS) v += to_f(bi[j]);
          o[j] = from_f<T>(v);
        }
        yr[i] = out;
      }
    }
  }
}

// Sum over the block; every thread gets the total. `sh` holds 33 floats.
__device__ float block_sum(float v, float* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? sh[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) sh[32] = v;
  }
  __syncthreads();
  const float total = sh[32];
  __syncthreads();  // sh is reused by the next reduction
  return total;
}

template <typename T, bool RMS, bool BIAS>
__global__ void __launch_bounds__(kScalarThreads)
ln_scalar_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                 const T* __restrict__ bias, T* __restrict__ y, int H,
                 float eps) {
  __shared__ float sh[33];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * H;
  T* yr = y + row * H;

  float mean = 0.f;
  if (!RMS) {
    float s = 0.f;
    for (int i = threadIdx.x; i < H; i += blockDim.x) s += to_f(xr[i]);
    mean = block_sum(s, sh) / (float)H;
  }
  float ss = 0.f;
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    const float c = to_f(xr[i]) - mean;
    ss += c * c;
  }
  const float rstd = rsqrtf(block_sum(ss, sh) / (float)H + eps);
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    float v = (to_f(xr[i]) - mean) * rstd * to_f(scale[i]);
    if (BIAS) v += to_f(bias[i]);
    yr[i] = from_f<T>(v);
  }
}

// The plan ln_rows_kernel<..., vectors> can run: tpr a multiple of 32 of at
// most kMaxWarps warps, the block within its launch bounds and kMaxGroups
// groups (named barriers 1 + g <= 15 for groups of several warps), and the
// group's slots covering the row.
bool rows_plan_ok(int64_t rows, int H, int V, int vectors, int tpr, int rpb,
                  int blocks) {
  const int limit = vectors >= 8 ? RowsThreads<8>::value : RowsThreads<1>::value;
  return H > 0 && H % V == 0 && tpr > 0 && tpr % 32 == 0 &&
         tpr <= 32 * kMaxWarps && rpb > 0 && rpb <= kMaxGroups &&
         (tpr == 32 || rpb <= 15) && tpr * rpb <= limit && blocks > 0 &&
         rows > 0 && (int64_t)tpr * vectors * V >= H;
}

template <typename T, bool RMS, bool BIAS>
int launch_mode(const void* x, const void* scale, const void* bias, void* y,
                int64_t rows, int H, float eps, int vectors, int tpr, int rpb,
                int blocks, cudaStream_t st) {
  const T *xp = (const T*)x, *sp = (const T*)scale, *bp = (const T*)bias;
  T* yp = (T*)y;
  if (vectors == 0) {
    ln_scalar_kernel<T, RMS, BIAS>
        <<<(unsigned)rows, kScalarThreads, 0, st>>>(xp, sp, bp, yp, H, eps);
    return (int)cudaGetLastError();
  }
  if (!rows_plan_ok(rows, H, 16 / (int)sizeof(T), vectors, tpr, rpb, blocks))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks), block((unsigned)(tpr * rpb));
  switch (vectors) {
    case 1:
      ln_rows_kernel<T, RMS, BIAS, 1><<<grid, block, 0, st>>>(
          xp, sp, bp, yp, rows, H, eps, tpr, rpb);
      break;
    case 2:
      ln_rows_kernel<T, RMS, BIAS, 2><<<grid, block, 0, st>>>(
          xp, sp, bp, yp, rows, H, eps, tpr, rpb);
      break;
    case 4:
      ln_rows_kernel<T, RMS, BIAS, 4><<<grid, block, 0, st>>>(
          xp, sp, bp, yp, rows, H, eps, tpr, rpb);
      break;
    case 8:
      ln_rows_kernel<T, RMS, BIAS, 8><<<grid, block, 0, st>>>(
          xp, sp, bp, yp, rows, H, eps, tpr, rpb);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* scale, const void* bias, void* y,
           int64_t rows, int H, float eps, int rms, int vectors, int tpr,
           int rpb, int blocks, cudaStream_t st) {
  if (rms)
    return launch_mode<T, true, false>(x, scale, bias, y, rows, H, eps,
                                       vectors, tpr, rpb, blocks, st);
  if (bias)
    return launch_mode<T, false, true>(x, scale, bias, y, rows, H, eps,
                                       vectors, tpr, rpb, blocks, st);
  return launch_mode<T, false, false>(x, scale, bias, y, rows, H, eps,
                                      vectors, tpr, rpb, blocks, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. bias may be null (ignored
// when rms). vectors = 0 runs ln_scalar_kernel (any H, any alignment);
// vectors in {1, 2, 4, 8} runs ln_rows_kernel with tpr threads a row, rpb
// rows a block and `blocks` blocks (ops/normalization.py::ln_plan), only
// when H % (16 / itemsize) == 0 and x, scale, bias and y are 16-byte aligned
// (the wrapper checks). Returns cudaErrorInvalidValue for a plan the kernel
// cannot run, else cudaGetLastError() after the launch.
extern "C" int dstt_layer_norm_fwd(const void* x, const void* scale,
                                   const void* bias, void* y, int64_t rows,
                                   int H, float eps, int rms, int dtype,
                                   int vectors, int tpr, int rpb, int blocks,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rows <= 0) return (int)cudaGetLastError();
  if (dtype == 0)
    return launch<float>(x, scale, bias, y, rows, H, eps, rms, vectors, tpr,
                         rpb, blocks, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, scale, bias, y, rows, H, eps, rms,
                                 vectors, tpr, rpb, blocks, st);
  return launch<__half>(x, scale, bias, y, rows, H, eps, rms, vectors, tpr,
                        rpb, blocks, st);
}
