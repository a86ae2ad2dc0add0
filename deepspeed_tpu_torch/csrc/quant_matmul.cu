// Quantized decode GEMMs for Hopper (sm_90a): weight-only int8 / int4 and
// W8A8 / W4A8, one kernel template for all four.
//
// Replaces (deepspeed_tpu/ops/quant_matmul.py):
//   int8_matmul    -> _kernel     (pallas_call at :79)
//   int8_a8_matmul -> _kernel_a8  (pallas_call at :167)
//   int4_a8_matmul -> _kernel4_a8 (pallas_call at :250)
//   int4_matmul    -> _kernel4    (pallas_call at :394)
//
// What they compute: x (M <= 8, K) float32 or bfloat16 times a quantized
// weight, out (M, N) in x's dtype.
// * int8: q8 (K, N) int8, s (1, N) fp32. Weight-only: fp32 products x * q8
//   summed in fp32, the per-channel s applied to the sum. W8A8: each row of
//   x is quantized first (absmax / 127, rint -- round half to even --, clip
//   to +-127, all in IEEE fp32 as quantize_activation_rows does), then
//   s8 x s8 -> s32 with __dp4a, out = acc.f32 * sx * s.
// * int4: q4 (K/2, N) uint8, logical rows [0, K/2) in the low nibble and
//   [K/2, K) in the high nibble, value ((nibble ^ 8) - 8); s (G, N) fp32 per
//   group of gs = K / G logical rows. Weight-only: fp32 products; with G == 1
//   the scale applies to the sum, with G > 1 to each weight (as the plain
//   version's dense dequant does). W4A8: nibbles sign-extended to s8 bytes
//   and __dp4a with the quantized x; G == 1: out = (acc.f32 * s) * sx; G > 1:
//   each 4-row integer partial is scaled by its group's s in fp32, summed,
//   then times sx.
//
// Bound on the H100. Bytes: the weight, once (K N or K N / 2 bytes; 45 MB
// for llama-7b's w_up in int8, 13.5 us at 3.35 TB/s). Operations: at M = 8
// every weight byte feeds 8 multiply-adds (16 for an int4 byte), so the
// weight-only kernels need ~80% of the CUDA cores' fp32 FMA rate just to
// keep pace with HBM: they are bound by operations, not bytes. The tensor
// cores (mma.sync on bf16 after an in-register convert, or s8 m16n8k32) are
// the lever for a later change.
//
// Design (a first cut that is right): one block of 256 threads per 32
// output columns (grid N / 32: 128 blocks at N 4096, 1000 at 32000). Each
// thread owns 16 columns and reads them as one 16-byte vector per weight
// row; the 128 threads along K each take a contiguous run of 4-row units,
// which takes the place of the Pallas grid's sequential K axis, and keep
// M x 16 accumulators in registers (fp32, or s32 for the a8 kernels). int8
// bytes become floats exactly by a byte permute into the mantissa of 2^23
// and one subtraction. For int4 each logical row is a nibble plane of a
// packed row, so a thread of the low plane and one of the high plane read
// the same bytes (the second read hits L2) and the code is the int8 loop
// with an unpack. A thread's run stays in one group except at a group
// boundary, where it reloads its 16 group scales. The partial sums meet by
// warp shuffles and a small shared-memory pass, in a fixed order. The a8
// kernels quantize x inside every block (the absmax of the (M, K)
// activation is recomputed per block; x stays in L2) into M x K bytes of
// shared memory, so a W8A8 site is one launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTX = 2;                 // threads along N, 16 columns each
constexpr int kTY = kThreads / kTX;    // threads along K
constexpr int kCols = 16 * kTX;        // output columns of a block

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x[k .. k + 3] of one row as floats (k % 4 == 0, rows 16-byte aligned)
__device__ __forceinline__ void load_x4(const float* p, float (&v)[4]) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void load_x4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = __bfloat162float(e[i]);
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// 4 unsigned bytes u_i -> floats u_i - offset, exactly: byte i goes into the
// low mantissa bits of 2^23 (0x4B000000), and `bias` = 2^23 + offset.
__device__ __forceinline__ void bytes_to_f4(uint32_t u, float bias,
                                            float (&f)[4]) {
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - bias;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - bias;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - bias;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - bias;
}

// 4 rows' words (4 columns each) -> 4 column words (4 rows each): byte r of
// col[c] is byte c of w[r]
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4],
                                           uint32_t (&col)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t1 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t2 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  col[0] = __byte_perm(t0, t1, 0x5410);
  col[1] = __byte_perm(t0, t1, 0x7632);
  col[2] = __byte_perm(t2, t3, 0x5410);
  col[3] = __byte_perm(t2, t3, 0x7632);
}

__device__ __forceinline__ uint32_t to_bits(int v) { return (uint32_t)v; }
__device__ __forceinline__ uint32_t to_bits(float v) { return __float_as_uint(v); }
template <typename A> __device__ __forceinline__ A from_bits(uint32_t b);
template <> __device__ __forceinline__ int from_bits<int>(uint32_t b) { return (int)b; }
template <> __device__ __forceinline__ float from_bits<float>(uint32_t b) {
  return __uint_as_float(b);
}

// grid (N / kCols), block kThreads; dynamic shared memory M * K bytes for
// the a8 kernels. gs: logical rows per scale group (K when G == 1).
template <typename T, int MAXM, bool A8, bool INT4, bool GROUPED>
__global__ void __launch_bounds__(kThreads, 1)
quant_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
                    const float* __restrict__ s, T* __restrict__ out, int M,
                    int K, int N, int gs) {
  using Acc = typename std::conditional<A8 && !GROUPED, int, float>::type;
  extern __shared__ __align__(16) uint32_t xq_s[];   // a8: (M, K / 4) words
  __shared__ uint32_t red[kWarps][kTX][MAXM * 16];
  __shared__ float amax_s[kWarps][MAXM];
  __shared__ float sx_s[MAXM];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = lane & 1, ty = warp * (32 / kTX) + (lane >> 1);
  const int n = blockIdx.x * kCols + tx * 16;   // this thread's 16 columns
  const int K2 = INT4 ? K / 2 : K;              // weight rows in memory
  const int KW = K / 4;                         // 4-row units

  if constexpr (A8) {
    // row absmax over all of x, then sx = absmax / 127 (1 for a zero row);
    // x comes from L2, so four loads of 4 elements each are kept in flight
    float am[MAXM];
#pragma unroll
    for (int m = 0; m < MAXM; ++m) {
      am[m] = 0.f;
      if (m < M) {
#pragma unroll 4
        for (int i = tid; i < KW; i += kThreads) {
          float v[4];
          load_x4(x + (int64_t)m * K + 4 * i, v);
          am[m] = fmaxf(am[m], fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])),
                                     fmaxf(fabsf(v[2]), fabsf(v[3]))));
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        am[m] = fmaxf(am[m], __shfl_xor_sync(0xffffffffu, am[m], o));
    }
    if (lane == 0) {
#pragma unroll
      for (int m = 0; m < MAXM; ++m) amax_s[warp][m] = am[m];
    }
    __syncthreads();
    if (tid < MAXM) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a = fmaxf(a, amax_s[w][tid]);
      sx_s[tid] = a == 0.f ? 1.f : __fdiv_rn(a, 127.f);
    }
    __syncthreads();
    // xq = clip(rint(x / sx), -127, 127), four per word, byte j = row k + j
#pragma unroll 4
    for (int i = tid; i < M * KW; i += kThreads) {
      const int m = i / KW, k = (i - m * KW) * 4;
      float v[4];
      load_x4(x + (int64_t)m * K + k, v);
      const float sxm = sx_s[m];
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float r = fminf(fmaxf(rintf(__fdiv_rn(v[j], sxm)), -127.f), 127.f);
        word |= ((uint32_t)(int)r & 0xFFu) << (8 * j);
      }
      xq_s[i] = word;
    }
    __syncthreads();
  }

  Acc acc[MAXM][16];
#pragma unroll
  for (int m = 0; m < MAXM; ++m)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[m][c] = 0;

  const int per = (KW + kTY - 1) / kTY;
  const int u0 = ty * per, u1 = min(KW, u0 + per);
  float sg[16];                 // GROUPED: the current group's scales
  int g_cur = -1;
  for (int u = u0; u < u1; ++u) {
    const int kk = 4 * u;                       // logical row
    const bool hi = INT4 && kk >= K2;           // high nibble plane
    const int pr = hi ? kk - K2 : kk;           // row in memory
    uint4 rows[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      rows[r] = __ldg(reinterpret_cast<const uint4*>(q + (int64_t)(pr + r) * N + n));
    if constexpr (GROUPED) {
      const int g = kk / gs;
      if (g != g_cur) {
        g_cur = g;
        const float4* sp = reinterpret_cast<const float4*>(s + (int64_t)g * N + n);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 v = __ldg(sp + i);
          sg[4 * i] = v.x; sg[4 * i + 1] = v.y;
          sg[4 * i + 2] = v.z; sg[4 * i + 3] = v.w;
        }
      }
    }
    if constexpr (A8) {
      int xw[MAXM];
#pragma unroll
      for (int m = 0; m < MAXM; ++m) xw[m] = m < M ? (int)xq_s[m * KW + u] : 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t w[4], col[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint32_t raw = word_of(rows[r], j);
          if constexpr (INT4) {
            const uint32_t nib = (hi ? raw >> 4 : raw) & 0x0F0F0F0Fu;
            w[r] = __vsub4(nib ^ 0x08080808u, 0x08080808u);   // s8 bytes
          } else {
            w[r] = raw;
          }
        }
        transpose4(w, col);
#pragma unroll
        for (int m = 0; m < MAXM; ++m)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if constexpr (GROUPED) {
              const int p = __dp4a((int)col[c], xw[m], 0);
              acc[m][4 * j + c] = fmaf((float)p, sg[4 * j + c], acc[m][4 * j + c]);
            } else {
              acc[m][4 * j + c] = __dp4a((int)col[c], xw[m], acc[m][4 * j + c]);
            }
          }
      }
    } else {
      float xv[MAXM][4];
#pragma unroll
      for (int m = 0; m < MAXM; ++m) {
        if (m < M) {
          load_x4(x + (int64_t)m * K + kk, xv[m]);
        } else {
#pragma unroll
          for (int r = 0; r < 4; ++r) xv[m][r] = 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t raw = word_of(rows[r], j);
          float f[4];
          if constexpr (INT4) {
            const uint32_t nib = (hi ? raw >> 4 : raw) & 0x0F0F0F0Fu;
            bytes_to_f4(nib ^ 0x08080808u, 8388616.f, f);      // 2^23 + 8
          } else {
            bytes_to_f4(raw ^ 0x80808080u, 8388736.f, f);      // 2^23 + 128
          }
          if constexpr (GROUPED) {
#pragma unroll
            for (int c = 0; c < 4; ++c) f[c] *= sg[4 * j + c];
          }
#pragma unroll
          for (int m = 0; m < MAXM; ++m)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[m][4 * j + c] = fmaf(xv[m][r], f[c], acc[m][4 * j + c]);
        }
    }
  }

  // sum over the 16 K-threads of the warp (xor offsets keep tx), then over
  // the warps through shared memory, in a fixed order
#pragma unroll
  for (int m = 0; m < MAXM; ++m)
#pragma unroll
    for (int c = 0; c < 16; ++c)
#pragma unroll
      for (int o = 16; o >= kTX; o >>= 1)
        acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], o);
  if (lane < kTX) {
#pragma unroll
    for (int m = 0; m < MAXM; ++m)
#pragma unroll
      for (int c = 0; c < 16; ++c) red[warp][tx][m * 16 + c] = to_bits(acc[m][c]);
  }
  __syncthreads();
  for (int i = tid; i < M * kCols; i += kThreads) {
    const int m = i / kCols, col = i % kCols, t = col / 16, c = col % 16;
    Acc tot = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) tot += from_bits<Acc>(red[w][t][m * 16 + c]);
    const int nn = blockIdx.x * kCols + col;
    float o;
    if constexpr (A8 && !GROUPED) {
      o = INT4 ? ((float)tot * s[nn]) * sx_s[m] : (float)tot * sx_s[m] * s[nn];
    } else if constexpr (A8) {
      o = tot * sx_s[m];
    } else if constexpr (GROUPED) {
      o = tot;
    } else {
      o = tot * s[nn];
    }
    out[(int64_t)m * N + nn] = from_f<T>(o);
  }
}

template <typename T, int MAXM, bool A8, bool INT4, bool GROUPED>
cudaError_t launch(const void* x, const void* q, const float* s, void* out,
                   int M, int K, int N, int gs, cudaStream_t st) {
  auto kern = quant_matmul_kernel<T, MAXM, A8, INT4, GROUPED>;
  const int smem = A8 ? M * K : 0;
  static int smem_set = 48 * 1024;   // per instantiation
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  kern<<<N / kCols, kThreads, smem, st>>>((const T*)x, (const uint8_t*)q, s,
                                          (T*)out, M, K, N, gs);
  return cudaGetLastError();
}

template <typename T, bool A8, bool INT4, bool GROUPED>
cudaError_t launch_m(const void* x, const void* q, const float* s, void* out,
                     int M, int K, int N, int gs, cudaStream_t st) {
  if (M <= 1) return launch<T, 1, A8, INT4, GROUPED>(x, q, s, out, M, K, N, gs, st);
  if (M <= 2) return launch<T, 2, A8, INT4, GROUPED>(x, q, s, out, M, K, N, gs, st);
  if (M <= 4) return launch<T, 4, A8, INT4, GROUPED>(x, q, s, out, M, K, N, gs, st);
  return launch<T, 8, A8, INT4, GROUPED>(x, q, s, out, M, K, N, gs, st);
}

template <typename T>
cudaError_t launch_t(const void* x, const void* q, const float* s, void* out,
                     int M, int K, int N, int G, bool int4, bool a8,
                     cudaStream_t st) {
  const int gs = K / G;
  if (!int4)
    return a8 ? launch_m<T, true, false, false>(x, q, s, out, M, K, N, gs, st)
              : launch_m<T, false, false, false>(x, q, s, out, M, K, N, gs, st);
  if (G == 1)
    return a8 ? launch_m<T, true, true, false>(x, q, s, out, M, K, N, gs, st)
              : launch_m<T, false, true, false>(x, q, s, out, M, K, N, gs, st);
  return a8 ? launch_m<T, true, true, true>(x, q, s, out, M, K, N, gs, st)
            : launch_m<T, false, true, true>(x, q, s, out, M, K, N, gs, st);
}

}  // namespace

// The wrappers (ops/quant_matmul.py) check every shape, dtype, alignment and
// contiguity; this entry point assumes 1 <= M <= 8, K % 8 == 0, N % 32 == 0,
// G dividing K with groups of a multiple of 4 rows inside one nibble plane,
// M * K bytes of shared memory available for the a8 kernels, and 16-byte
// aligned operands. x (M, K), out (M, N) of dtype 0 = float32,
// 1 = bfloat16; q (K, N) int8 or (K / 2, N) packed uint8 (int4 = 1); s (G,
// N) fp32 (G == 1 for int8). Returns the CUDA error of the launch.
extern "C" int dstt_quant_matmul(const void* x, const void* q, const float* s,
                                 void* out, int M, int K, int N, int G,
                                 int int4, int a8, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  if (dtype == 0)
    return (int)launch_t<float>(x, q, s, out, M, K, N, G, int4 != 0, a8 != 0, st);
  return (int)launch_t<__nv_bfloat16>(x, q, s, out, M, K, N, G, int4 != 0, a8 != 0, st);
}
