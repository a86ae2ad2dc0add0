// Weight-only quantized decode GEMMs for Hopper (sm_90a): int8 and int4,
// one kernel template for both (W8A8 / W4A8 are quant_matmul_a8.cu).
//
// Replaces (deepspeed_tpu/ops/quant_matmul.py):
//   int8_matmul    -> _kernel     (pallas_call at :79)
//   int4_matmul    -> _kernel4    (pallas_call at :394)
//
// What they compute: x (M <= 8, K) float32 or bfloat16 times a quantized
// weight, out (M, N) in x's dtype.
// * int8: q8 (K, N) int8, s (1, N) fp32: fp32 products x * q8 summed in
//   fp32, the per-channel s applied to the sum.
// * int4: q4 (K/2, N) uint8, logical rows [0, K/2) in the low nibble and
//   [K/2, K) in the high nibble, value ((nibble ^ 8) - 8); s (G, N) fp32 per
//   group of gs = K / G logical rows: fp32 products; with G == 1 the scale
//   applies to the sum, with G > 1 to each weight (as the plain version's
//   dense dequant does).
//
// Bound on the H100. Bytes: the weight, once (K N or K N / 2 bytes; 45 MB
// for llama-7b's w_up in int8, 13.5 us at 3.35 TB/s). Operations: at M = 8
// every weight byte feeds 8 multiply-adds (16 for an int4 byte), so the
// weight-only kernels need ~80% of the CUDA cores' fp32 FMA rate just to
// keep pace with HBM: they are bound by operations, not bytes. The tensor
// cores (mma.sync on bf16 after an in-register convert) are the lever for a
// later change.
//
// Design (a first cut that is right): one block of 256 threads per 32
// output columns (grid N / 32: 128 blocks at N 4096, 1000 at 32000). Each
// thread owns 16 columns and reads them as one 16-byte vector per weight
// row; the 128 threads along K each take a contiguous run of 4-row units,
// which takes the place of the Pallas grid's sequential K axis, and keep
// M x 16 accumulators in registers (fp32). int8
// bytes become floats exactly by a byte permute into the mantissa of 2^23
// and one subtraction. For int4 each logical row is a nibble plane of a
// packed row, so a thread of the low plane and one of the high plane read
// the same bytes (the second read hits L2) and the code is the int8 loop
// with an unpack. A thread's run stays in one group except at a group
// boundary, where it reloads its 16 group scales. The partial sums meet by
// warp shuffles and a small shared-memory pass, in a fixed order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// grid (N / kCols), block kThreads. gs: logical rows per scale group (K
// when G == 1).
template <typename T, int MAXM, bool INT4, bool GROUPED>
__global__ void __launch_bounds__(kThreads, 1)
quant_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
                    const float* __restrict__ s, T* __restrict__ out, int M,
                    int K, int N, int gs) {
  __shared__ float red[kWarps][kTX][MAXM * 16];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = lane & 1, ty = warp * (32 / kTX) + (lane >> 1);
  const int n = blockIdx.x * kCols + tx * 16;   // this thread's 16 columns
  const int K2 = INT4 ? K / 2 : K;              // weight rows in memory
  const int KW = K / 4;                         // 4-row units

  float acc[MAXM][16];
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
      for (int c = 0; c < 16; ++c) red[warp][tx][m * 16 + c] = acc[m][c];
  }
  __syncthreads();
  for (int i = tid; i < M * kCols; i += kThreads) {
    const int m = i / kCols, col = i % kCols, t = col / 16, c = col % 16;
    float tot = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) tot += red[w][t][m * 16 + c];
    const int nn = blockIdx.x * kCols + col;
    const float o = GROUPED ? tot : tot * s[nn];
    out[(int64_t)m * N + nn] = from_f<T>(o);
  }
}

template <typename T, int MAXM, bool INT4, bool GROUPED>
cudaError_t launch(const void* x, const void* q, const float* s, void* out,
                   int M, int K, int N, int gs, cudaStream_t st) {
  quant_matmul_kernel<T, MAXM, INT4, GROUPED><<<N / kCols, kThreads, 0, st>>>(
      (const T*)x, (const uint8_t*)q, s, (T*)out, M, K, N, gs);
  return cudaGetLastError();
}

template <typename T, bool INT4, bool GROUPED>
cudaError_t launch_m(const void* x, const void* q, const float* s, void* out,
                     int M, int K, int N, int gs, cudaStream_t st) {
  if (M <= 1) return launch<T, 1, INT4, GROUPED>(x, q, s, out, M, K, N, gs, st);
  if (M <= 2) return launch<T, 2, INT4, GROUPED>(x, q, s, out, M, K, N, gs, st);
  if (M <= 4) return launch<T, 4, INT4, GROUPED>(x, q, s, out, M, K, N, gs, st);
  return launch<T, 8, INT4, GROUPED>(x, q, s, out, M, K, N, gs, st);
}

template <typename T>
cudaError_t launch_t(const void* x, const void* q, const float* s, void* out,
                     int M, int K, int N, int G, bool int4, cudaStream_t st) {
  const int gs = K / G;
  if (!int4) return launch_m<T, false, false>(x, q, s, out, M, K, N, gs, st);
  if (G == 1) return launch_m<T, true, false>(x, q, s, out, M, K, N, gs, st);
  return launch_m<T, true, true>(x, q, s, out, M, K, N, gs, st);
}

}  // namespace

// The wrappers (ops/quant_matmul.py) check every shape, dtype, alignment and
// contiguity; this entry point assumes 1 <= M <= 8, K % 8 == 0, N % 32 == 0,
// G dividing K with groups of a multiple of 4 rows inside one nibble plane,
// and 16-byte aligned operands. x (M, K), out (M, N) of dtype 0 = float32,
// 1 = bfloat16; q (K, N) int8 or (K / 2, N) packed uint8 (int4 = 1); s (G,
// N) fp32 (G == 1 for int8). Returns the CUDA error of the launch.
extern "C" int dstt_quant_matmul(const void* x, const void* q, const float* s,
                                 void* out, int M, int K, int N, int G,
                                 int int4, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  if (dtype == 0)
    return (int)launch_t<float>(x, q, s, out, M, K, N, G, int4 != 0, st);
  return (int)launch_t<__nv_bfloat16>(x, q, s, out, M, K, N, G, int4 != 0, st);
}
