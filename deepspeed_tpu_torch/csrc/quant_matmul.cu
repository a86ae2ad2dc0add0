// Weight-only quantized decode GEMMs for Hopper (sm_90a): int8 and int4
// (W8A8 / W4A8 are quant_matmul_a8.cu).
//
// Replaces (deepspeed_tpu/ops/quant_matmul.py):
//   int8_matmul    -> _kernel     (pallas_call at :79)
//   int4_matmul    -> _kernel4    (pallas_call at :394)
//
// What they compute: x (M <= 8, K) float32, bfloat16 or float16 times a
// quantized weight, out (M, N) in x's dtype.
// * int8: q8 (K, N) int8, s (1, N) fp32: out = (sum_k x * q8) * s, products
//   and sums in fp32.
// * int4: q4 (K/2, N) uint8, logical rows [0, K/2) in the low nibble and
//   [K/2, K) in the high nibble, value ((nibble ^ 8) - 8); s (G, N) fp32 per
//   group of gs = K / G logical rows: with G == 1 the scale applies to the
//   sum; with G > 1 each group's fp32 partial is scaled, the two nibble
//   planes apart, and the scaled partials summed (JAX's
//   acc += pl_lo * s_lo + pl_hi * s_hi).
//
// Bound on the H100: the weight's bytes, once (K N or K N / 2; 45 MB for
// llama-7b's w_up in int8, 13.5 us at 3.35 TB/s). Every weight element
// feeds M <= 8 products, far under the tensor cores' rate, but on the CUDA
// cores (fp32 FMAs after a convert) those products alone need ~80% of the
// fp32 FMA rate to keep pace with HBM.
//
// Two kernels, chosen by x's dtype (ops/quant_matmul.py):
//
// quant_matmul_tc_kernel: bfloat16 and float16 x, on the tensor cores.
// * mma.sync m16n8k16 (bf16 or f16, fp32 accumulators) with the weight as A
//   (16 output columns x 16 k) and x as B (16 k x 8 tokens; tokens M..7
//   zero). int8 and int4 values are exact in both 16-bit types, and with a
//   16-bit x every product is exact in fp32: JAX's kernel arithmetic, up to
//   the order of the fp32 sums.
// * Fragments without a transpose through shared memory. Lane (g = lane /
//   4, t = lane % 4) of a consumer warp reads one 16-byte vector, columns
//   16g .. 16g + 15 of the tile, of each of the 4 weight rows 4t .. 4t + 3
//   of its 16-row unit. k is permuted the same way in A and B: mma k-slots
//   2t, 2t + 1 hold rows 4t, 4t + 1 and k-slots 2t + 8, 2t + 9 rows 4t + 2,
//   4t + 3, so that B's fragment for lane (g, t) is x[token g][4t .. 4t + 3],
//   one 8-byte load. In mma f (f = 0..7), A's row g is column 16g + 2f and
//   A's row g + 8 column 16g + 2f + 1: its A registers pair one byte of two
//   rows (one byte permute each), D's c0, c1 are column 16g + 2f, tokens 2t,
//   2t + 1, and c2, c3 column 16g + 2f + 1.
// * Exact conversion in registers, two 16-bit values an op:
//   - fp16, int8: 0x64 over the byte (sign flipped) is 1024 + (v + 128);
//     one subtraction of 1152.
//   - bf16, int8: bf16 has 7 mantissa bits, so 0x43 over the low 7 bits
//     is 128 + (v & 127), and the subtrahend is 128 or 256 by the sign bit
//     (0x4300 | (byte & 0x80): bit 7 is the exponent's lowest).
//   - int4: 0x43 (bf16) or 0x64 (fp16) over (nibble ^ 8), minus 136 or
//     1032, as Marlin does; the high plane shifts the bytes by 4 first.
//   So ~2 ops a weight element for bf16 int8, 1.5 for fp16 int8 and int4.
// * HBM through a TMA ring: a producer warp streams the block's weight, one
//   box of kRows = 64 rows x kCols = 128 bytes a stage from a map cached per
//   weight, with the stage's x (8 tokens x kRows, one box a nibble plane,
//   128-byte swizzle) into a ring of stages in shared memory, completion
//   counted on the stage's mbarrier; four consumer warps take 16 rows each,
//   read their fragments and release the stage on its "empty" barrier. TMA
//   zero-fills rows past K (a partial last stage), columns past N (a partial
//   last tile) and tokens past M. int4 reads each packed byte once and feeds
//   both planes from it: the low plane's B from x at k, the high plane's
//   from x at xh + k, where xh = K/2 (the wrapper passes x with its high
//   plane moved to a multiple of 8 elements when K/2 is not one: a TMA box
//   starts on 16 bytes). The low plane's B is zeroed past K/2, where its
//   box reads other x against zero-filled weight rows.
// * The card is filled by a K split: a thread block cluster of 1..8 blocks
//   shares a column tile, each block a contiguous range of stages (a block
//   whose range is empty, because K is small, still pushes zeros). Each
//   consumer warp pushes its fp32 partials by st.async to the block that
//   owns their columns (kCols / cluster each), which sums them in (rank,
//   warp) order, scales and writes them: no atomics, no memset, the same
//   bits every call. The plan (cluster, stages) comes from the host
//   (ops/quant_matmul.py::tc_plan).
// * Grouped int4 scales the fp32 partial of each 16-row unit of a plane by
//   its group's scales and adds it into the lane's total (JAX's kernel
//   scales the partial of each k tile the same way). The lane follows each
//   plane's group by a cursor (no division) and loads a group's scales (16
//   columns) when the group changes, before it waits for the stage. With
//   groups of a multiple of 16 rows (JAX's kernel gate takes multiples of
//   128) a unit lies in one group. Otherwise (groups of a multiple of 4
//   rows; a lane's 4 rows lie in one group) a unit that crosses a group
//   edge runs once per group with B zeroed in the lanes of the other
//   groups.
// * Why so (PERF.md, Findings): tiles of 256 columns (two warps
//   across, 32-row stages) were no faster at any llama-7b site and slower
//   at three; the L2 promotion of the weight's boxes moved nothing; a grid
//   of more than one wave of resident blocks cost more than a smaller K
//   split; grouped int4 at two blocks an SM (no spill) ran slower than at
//   three with a few spilled registers.
//
// quant_matmul_kernel: float32 x, on the CUDA cores (the 2-layer fp32
// end-to-end checks use it). One block of 256 threads per 32 output
// columns; each thread owns 16 columns, reads them as one 16-byte vector
// per weight row, takes a contiguous run of 4-row units along K and keeps
// M x 16 fp32 accumulators; int8 bytes become floats exactly by a byte
// permute into the mantissa of 2^23 and one subtraction; int4 reads each
// logical row from its nibble plane. The partial sums meet by warp shuffles
// and a small shared-memory pass, in a fixed order.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

// word j of a 16-byte vector (j known at compile time)
__device__ __forceinline__ uint32_t word_of(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// ---------------------------------------------------------------------------
// quant_matmul_kernel: float32 x on the CUDA cores
// ---------------------------------------------------------------------------

namespace cc {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTX = 2;                 // threads along N, 16 columns each
constexpr int kTY = kThreads / kTX;    // threads along K
constexpr int kCols = 16 * kTX;        // output columns of a block

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
template <int MAXM, bool INT4, bool GROUPED>
__global__ void __launch_bounds__(kThreads, 1)
quant_matmul_kernel(const float* __restrict__ x, const uint8_t* __restrict__ q,
                    const float* __restrict__ s, float* __restrict__ out,
                    int M, int K, int N, int gs) {
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
        const float4 f = __ldg(reinterpret_cast<const float4*>(
            x + (int64_t)m * K + kk));
        xv[m][0] = f.x; xv[m][1] = f.y; xv[m][2] = f.z; xv[m][3] = f.w;
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
    out[(int64_t)m * N + nn] = GROUPED ? tot : tot * s[nn];
  }
}

template <int MAXM, bool INT4, bool GROUPED>
cudaError_t launch(const void* x, const void* q, const float* s, void* out,
                   int M, int K, int N, int gs, cudaStream_t st) {
  quant_matmul_kernel<MAXM, INT4, GROUPED><<<N / kCols, kThreads, 0, st>>>(
      (const float*)x, (const uint8_t*)q, s, (float*)out, M, K, N, gs);
  return cudaGetLastError();
}

template <bool INT4, bool GROUPED>
cudaError_t launch_m(const void* x, const void* q, const float* s, void* out,
                     int M, int K, int N, int gs, cudaStream_t st) {
  if (M <= 1) return launch<1, INT4, GROUPED>(x, q, s, out, M, K, N, gs, st);
  if (M <= 2) return launch<2, INT4, GROUPED>(x, q, s, out, M, K, N, gs, st);
  if (M <= 4) return launch<4, INT4, GROUPED>(x, q, s, out, M, K, N, gs, st);
  return launch<8, INT4, GROUPED>(x, q, s, out, M, K, N, gs, st);
}

}  // namespace cc

// ---------------------------------------------------------------------------
// quant_matmul_tc_kernel: 16-bit x on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kConsumers = 4;                     // consumer warps
constexpr int kThreads = 32 * (kConsumers + 1);   // and a producer warp
constexpr int kCols = 128;             // columns of a tile: 8 lanes x 16 B
constexpr int kRows = 16 * kConsumers; // weight rows of a stage, 16 a warp
constexpr int kMaxM = 8;               // tokens: the mma's n8
constexpr int kXSpan = 2 * kRows;      // bytes of a token's x in a stage
constexpr int kWBytes = kRows * kCols;            // a stage's weight box
constexpr int kXBytes = kMaxM * kXSpan;           // its x box (a plane)
constexpr int kMaxStages = 8;
constexpr int kMaxCluster = 8;

// How the scales apply: one per column (int8, and int4 with one group)
// on the sum; int4 groups of a multiple of 16 rows, so that each 16-row
// unit lies in one group; int4 groups of a multiple of 4 rows.
enum Scales { kColumn, kUnitGroups, kQuadGroups };

// a ring stage: the weight box, then the x box of each plane (each on a
// multiple of 1024 bytes, where the 128-byte swizzle's pattern starts)
__host__ __device__ constexpr int stage_bytes(bool int4) {
  return kWBytes + (int4 ? 2 : 1) * kXBytes;
}
static_assert(kWBytes % 1024 == 0 && kXBytes % 1024 == 0, "stage");

// dynamic shared memory: 1024 bytes of room to align the ring, the ring,
// then the partials pushed here, [kConsumers * cluster sources][M][kCols /
// cluster] fp32
__host__ __device__ constexpr int smem_bytes(int stages, bool int4, int M) {
  return 1024 + stages * stage_bytes(int4) + kConsumers * M * kCols * 4;
}

// byte j of a and byte j of b in bytes 0 and 2 (1 and 3: copies)
__device__ __forceinline__ uint32_t pick(uint32_t a, uint32_t b, int j) {
  return __byte_perm(a, b, j | (j << 4) | ((j + 4) << 8) | ((j + 4) << 12));
}

// The packed bytes of mma f's A registers from the lane's 4 rows w[r]
// (columns 16g .. 16g + 15): p[0] column 2f of rows 0, 1; p[1] column
// 2f + 1 of rows 0, 1; p[2], p[3] the same of rows 2, 3.
__device__ __forceinline__ void pairs(const uint4 (&w)[4], int f,
                                      uint32_t (&p)[4]) {
  const int c = f >> 1, j = 2 * (f & 1);
  p[0] = pick(word_of(w[0], c), word_of(w[1], c), j);
  p[1] = pick(word_of(w[0], c), word_of(w[1], c), j + 1);
  p[2] = pick(word_of(w[2], c), word_of(w[3], c), j);
  p[3] = pick(word_of(w[2], c), word_of(w[3], c), j + 1);
}

// int8 (bytes 0 and 2 of p) and int4 (bits 0-3 and 16-19) values -> two
// values of T, exactly (see the header)
template <typename T> struct Cvt;
template <> struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t sub2(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static __device__ __forceinline__ uint32_t i8(uint32_t p) {
    return sub2((p & 0x007F007Fu) | 0x43004300u,
                (p & 0x00800080u) | 0x43004300u);
  }
  static __device__ __forceinline__ uint32_t i4(uint32_t p) {
    return sub2((p & 0x000F000Fu) ^ 0x43084308u, 0x43084308u);
  }
};
template <> struct Cvt<__half> {
  static __device__ __forceinline__ uint32_t sub2(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static __device__ __forceinline__ uint32_t i8(uint32_t p) {
    return sub2((p & 0x00FF00FFu) ^ 0x64806480u, 0x64806480u);
  }
  static __device__ __forceinline__ uint32_t i4(uint32_t p) {
    return sub2((p & 0x000F000Fu) ^ 0x64086408u, 0x64086408u);
  }
};

// the 8 mma's of a unit on one set of A fragments: acc += A B
template <typename T>
__device__ __forceinline__ void mma_unit(float (&acc)[8][4],
                                         const uint32_t (&a)[8][4],
                                         uint32_t b0, uint32_t b1) {
#pragma unroll
  for (int f = 0; f < 8; ++f) Mma<T>::run(acc[f], a[f], b0, b1);
}

// The scale group of a growing row of one nibble plane, without a division
// after the first; rows past the plane's end (zero weight) count to its
// last group `last`.
struct Cursor {
  int g, end;                 // the row's group and its first row past it
  __device__ __forceinline__ void start(int row, int gs) {
    g = row / gs;
    end = (g + 1) * gs;
  }
  __device__ __forceinline__ int at(int row, int gs, int last) {
    while (row >= end) {
      ++g;
      end += gs;
    }
    return min(g, last);
  }
};

// s[grp][col .. col + 15] (zeros for a lane whose 16 columns lie past N)
__device__ __forceinline__ void load_scales(const float* __restrict__ s,
                                            int grp, int N, int col,
                                            float (&sc)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (col < N)
      v = __ldg(reinterpret_cast<const float4*>(s + (int64_t)grp * N + col) +
                i);
    sc[4 * i] = v.x; sc[4 * i + 1] = v.y;
    sc[4 * i + 2] = v.z; sc[4 * i + 3] = v.w;
  }
}

// tot += part x (the scales of its columns)
__device__ __forceinline__ void add_scaled(float (&tot)[8][4],
                                           const float (&part)[8][4],
                                           const float (&sc)[16]) {
#pragma unroll
  for (int f = 0; f < 8; ++f) {
    tot[f][0] += part[f][0] * sc[2 * f];
    tot[f][1] += part[f][1] * sc[2 * f];
    tot[f][2] += part[f][2] * sc[2 * f + 1];
    tot[f][3] += part[f][3] * sc[2 * f + 1];
  }
}

// One plane of an int4 unit that lies in one group: its fp32 partial
// times the group's scales sc goes into tot.
template <typename T>
__device__ __forceinline__ void unit_scaled(float (&tot)[8][4],
                                            const uint32_t (&a)[8][4],
                                            uint2 b, const float (&sc)[16]) {
  float part[8][4];
#pragma unroll
  for (int f = 0; f < 8; ++f)
#pragma unroll
    for (int i = 0; i < 4; ++i) part[f][i] = 0.f;
  mma_unit<T>(part, a, b.x, b.y);
  add_scaled(tot, part, sc);
}

// One plane of a grouped int4 unit: the unit's rows lie in groups g0 ..
// g1, the lane's 4 rows in group `mine`; one pass a group, with B zeroed
// in the lanes of the other groups: the fp32 partial of the pass times
// the group's scales goes into tot. sc holds g0's scales.
template <typename T>
__device__ __forceinline__ void grouped_plane(float (&tot)[8][4],
                                              const uint32_t (&a)[8][4],
                                              uint2 b, int g0, int g1,
                                              int mine, const float (&sc)[16],
                                              const float* __restrict__ s,
                                              int N, int col) {
  for (int g = g0; g <= g1; ++g) {
    float part[8][4];
#pragma unroll
    for (int f = 0; f < 8; ++f)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[f][i] = 0.f;
    const bool in = mine == g;
    mma_unit<T>(part, a, in ? b.x : 0u, in ? b.y : 0u);
    if (g == g0) {
      add_scaled(tot, part, sc);
    } else {
      float other[16];
      load_scales(s, g, N, col, other);
      add_scaled(tot, part, other);
    }
  }
}

// grid (ceil(N / kCols) * cluster) in clusters of `cluster` blocks along x,
// block kThreads: kConsumers consumer warps and a producer warp; dynamic
// shared memory smem_bytes(stages, INT4, M). wmap: the (rows, N) uint8
// weight in boxes of kRows x kCols; xmap: x (M, K) in boxes of kMaxM x
// kRows elements with a 128-byte swizzle (int4: (M, 2 xh), the low plane
// at column 0 and the high plane at xh). gs: logical rows per scale group
// (K when G == 1).
template <typename T, bool INT4, Scales SC>
__global__ void __launch_bounds__(kThreads, SC == kQuadGroups ? 2 : 3)
quant_matmul_tc_kernel(const __grid_constant__ CUtensorMap wmap,
                       const __grid_constant__ CUtensorMap xmap,
                       const float* __restrict__ s, T* __restrict__ out,
                       int M, int K, int N, int gs, int xh, int stages) {
  constexpr int kStage = stage_bytes(INT4);
  extern __shared__ __align__(16) uint8_t smem[];   // see smem_bytes
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  // complete when every block of the cluster has pushed its partials here
  __shared__ __align__(8) uint64_t red_bar;

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int share = kCols / C;                 // columns this block writes
  const int col_tile = (blockIdx.x / C) * kCols;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  const int K2 = INT4 ? K / 2 : K;             // weight rows in memory
  const int steps = (K2 + kRows - 1) / kRows;
  const int s0 = rank * steps / C, s1 = (rank + 1) * steps / C;
  const int nsteps = s1 - s0;
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023));
  float* red = reinterpret_cast<float*>(ring + stages * kStage);

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers);
    }
    mbar_init(&red_bar, 1);
    fence_barrier_init();
    mbar_expect_tx(&red_bar, kConsumers * M * kCols * 4);
  }
  // every block of the cluster must be running, its barriers initialised,
  // before another stores to its shared memory: arrive now, wait before
  // the first remote store
  __syncwarp();
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  __syncthreads();   // the barriers are initialised

  if (warp == kConsumers) {
    // the producer's lane 0: stage i holds weight rows kRows (s0 + i) ..
    // +kRows-1 of the tile's columns and x at the same k (int4: of both
    // planes), once every consumer warp has released the slot
    if (lane == 0) {
      int slot = 0, phase = 0;
      for (int i = 0; i < nsteps; ++i) {
        if (i >= stages) mbar_wait(&empty[slot], phase ^ 1);
        uint8_t* st = ring + slot * kStage;
        const int row = kRows * (s0 + i);
        mbar_expect_tx(&full[slot], kStage);
        tma_load_2d(st, &wmap, col_tile, row, &full[slot]);
        tma_load_2d(st + kWBytes, &xmap, row, 0, &full[slot]);
        if constexpr (INT4)
          tma_load_2d(st + kWBytes + kXBytes, &xmap, xh + row, 0,
                      &full[slot]);
        if (++slot == stages) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    __syncwarp();
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  } else {
    // res: the lane's sums, columns col + 2f (res[f][0..1]) and col + 2f +
    // 1 (res[f][2..3]), tokens 2t, 2t + 1
    float res[8][4];
#pragma unroll
    for (int f = 0; f < 8; ++f)
#pragma unroll
      for (int i = 0; i < 4; ++i) res[f][i] = 0.f;
    const int col = col_tile + 16 * g;
    const int wofs = (16 * warp + 4 * t) * kCols + 16 * g;
    const int xofs = kWBytes + swizzle_offset(g * kXSpan + 32 * warp + 8 * t,
                                              kXSpan);
    const int row_start = kRows * s0 + 16 * warp;  // the warp's first row
    // grouped int4: each plane's groups (of the unit's first row, its last
    // row, the lane's rows) and, for unit groups, the scales of the
    // current group a plane
    const int glo = SC == kColumn ? 0 : K2 / gs - 1;
    const int ghi = SC == kColumn ? 0 : K / gs - 1;
    Cursor lo0, lo1, lom, hi0, hi1, him;
    float sl[16], sh[16];
    int cur_lo = -1, cur_hi = -1;
    if constexpr (SC != kColumn) {
      lo0.start(row_start, gs);
      hi0.start(K2 + row_start, gs);
    }
    if constexpr (SC == kQuadGroups) {
      lo1.start(row_start + 15, gs);
      lom.start(row_start + 4 * t, gs);
      hi1.start(K2 + row_start + 15, gs);
      him.start(K2 + row_start + 4 * t, gs);
    }
    int slot = 0, phase = 0;
    for (int i = 0; i < nsteps; ++i) {
      const int row0 = row_start + kRows * i;     // the unit's first row
      int gl0 = 0, gh0 = 0;
      if constexpr (SC != kColumn) {
        // the scales load while the stage arrives
        gl0 = lo0.at(row0, gs, glo);
        gh0 = hi0.at(K2 + row0, gs, ghi);
        if (gl0 != cur_lo) {
          load_scales(s, gl0, N, col, sl);
          cur_lo = gl0;
        }
        if (gh0 != cur_hi) {
          load_scales(s, gh0, N, col, sh);
          cur_hi = gh0;
        }
      }
      mbar_wait(&full[slot], phase);
      const uint8_t* st = ring + slot * kStage;
      uint4 w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        w[r] = *reinterpret_cast<const uint4*>(st + wofs + r * kCols);
      uint2 bl = *reinterpret_cast<const uint2*>(st + xofs);
      uint2 bh = make_uint2(0u, 0u);
      if constexpr (INT4)
        bh = *reinterpret_cast<const uint2*>(st + xofs + kXBytes);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
      if (++slot == stages) {
        slot = 0;
        phase ^= 1;
      }
      if constexpr (!INT4) {
        uint32_t a[8][4];
#pragma unroll
        for (int f = 0; f < 8; ++f) {
          uint32_t p[4];
          pairs(w, f, p);
#pragma unroll
          for (int k = 0; k < 4; ++k) a[f][k] = Cvt<T>::i8(p[k]);
        }
        mma_unit<T>(res, a, bl.x, bl.y);
      } else {
        // the planes one after the other: the low nibbles, then the high
        if (row0 + 4 * t >= K2) bl = make_uint2(0u, 0u);
#pragma unroll
        for (int hp = 0; hp < 2; ++hp) {
          uint32_t a[8][4];
#pragma unroll
          for (int f = 0; f < 8; ++f) {
            uint32_t p[4];
            pairs(w, f, p);
#pragma unroll
            for (int k = 0; k < 4; ++k)
              a[f][k] = Cvt<T>::i4(p[k] >> (4 * hp));
          }
          const uint2 b = hp ? bh : bl;
          if constexpr (SC == kColumn) {
            mma_unit<T>(res, a, b.x, b.y);
          } else if constexpr (SC == kUnitGroups) {
            unit_scaled<T>(res, a, b, hp ? sh : sl);
          } else if (hp == 0) {
            grouped_plane<T>(res, a, b, gl0, lo1.at(row0 + 15, gs, glo),
                             lom.at(row0 + 4 * t, gs, glo), sl, s, N, col);
          } else {
            grouped_plane<T>(res, a, b, gh0, hi1.at(K2 + row0 + 15, gs, ghi),
                             him.at(K2 + row0 + 4 * t, gs, ghi), sh, s, N,
                             col);
          }
        }
      }
    }

    // push the lane's partials of tokens 2t, 2t + 1 (< M) to the block that
    // owns their 16 columns
    __syncwarp();
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    const int owner = 16 * g / share;
    const uint32_t bar = cluster_addr(&red_bar, owner);
    const int src = rank * kConsumers + warp;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int tk = 2 * t + u;
      if (tk >= M) continue;
      const uint32_t dst = cluster_addr(
          &red[(src * M + tk) * share + 16 * g % share], owner);
#pragma unroll
      for (int v = 0; v < 4; ++v)
        st_async(dst + 16 * v,
                 make_uint4(__float_as_uint(res[2 * v][u]),
                            __float_as_uint(res[2 * v][2 + u]),
                            __float_as_uint(res[2 * v + 1][u]),
                            __float_as_uint(res[2 * v + 1][2 + u])),
                 bar);
    }
  }
  // no block leaves the cluster before every block has issued its pushes
  __syncwarp();
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  mbar_wait(&red_bar, 0);

  // this block's share of the tile: sum over the sources in a fixed order,
  // scale, write
  const int nsrc = kConsumers * C;
  for (int o = tid; o < M * share; o += kThreads) {
    const int m = o / share, c = o - m * share;
    const int n = col_tile + rank * share + c;
    if (n >= N) continue;
    float tot = 0.f;
    for (int r = 0; r < nsrc; ++r) tot += red[(r * M + m) * share + c];
    if constexpr (SC == kColumn) tot *= s[n];
    out[(int64_t)m * N + n] = from_f<T>(tot);
  }
  __syncwarp();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <typename T, bool INT4, Scales SC>
cudaError_t launch(const void* x, const void* q, const float* s, void* out,
                   int M, int K, int N, int gs, int xh, int cluster,
                   int stages, cudaStream_t st) {
  auto kern = quant_matmul_tc_kernel<T, INT4, SC>;
  const int rows = INT4 ? K / 2 : K;
  CUtensorMap wmap, xmap;
  {
    const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)N};
    const cuuint32_t box[2] = {(cuuint32_t)kCols, (cuuint32_t)kRows};
    cudaError_t e = tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, q,
                               dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE,
                               CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
    if (e != cudaSuccess) return e;
  }
  {
    const int width = INT4 ? 2 * xh : K;         // x's row, elements
    const cuuint64_t dims[2] = {(cuuint64_t)width, (cuuint64_t)M};
    const cuuint64_t strides[1] = {(cuuint64_t)width * 2};
    const cuuint32_t box[2] = {(cuuint32_t)kRows, (cuuint32_t)kMaxM};
    cudaError_t e = tensor_map(&xmap, map_type<T>(), 2, x, dims, strides, box,
                               CU_TENSOR_MAP_SWIZZLE_128B,
                               CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
    if (e != cudaSuccess) return e;
  }
  const int smem = smem_bytes(stages, INT4, M);
  static int smem_set = 0;   // per instantiation: opt in above 48 KB
  if (smem > smem_set) {
    const int most = smem_bytes(kMaxStages, INT4, kMaxM);
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return e;
    smem_set = most;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kCols - 1) / kCols * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, wmap, xmap, s, (T*)out, M,
                                     K, N, gs, xh, stages);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* x, const void* q, const float* s, void* out,
                     int M, int K, int N, int G, bool int4, int xh,
                     int cluster, int stages, cudaStream_t st) {
  const int gs = K / G;
  if (!int4)
    return launch<T, false, kColumn>(x, q, s, out, M, K, N, gs, xh, cluster,
                                     stages, st);
  if (G == 1)
    return launch<T, true, kColumn>(x, q, s, out, M, K, N, gs, xh, cluster,
                                    stages, st);
  if (gs % 16 == 0)
    return launch<T, true, kUnitGroups>(x, q, s, out, M, K, N, gs, xh,
                                        cluster, stages, st);
  return launch<T, true, kQuadGroups>(x, q, s, out, M, K, N, gs, xh, cluster,
                                      stages, st);
}

}  // namespace tc

}  // namespace

// The wrappers (ops/quant_matmul.py) check every shape, dtype, alignment and
// contiguity; both entry points assume 1 <= M <= 8, K % 8 == 0, N % 32 ==
// 0, G dividing K with groups of a multiple of 4 rows inside one nibble
// plane, and 16-byte aligned operands. x (M, K), out (M, N); q (K, N) int8
// or (K / 2, N) packed uint8 (int4 = 1); s (G, N) fp32 (G == 1 for int8).
// Each returns the CUDA error of the launch.

// float32 x (dtype 0; any other dtype is refused): quant_matmul_kernel.
extern "C" int dstt_quant_matmul(const void* x, const void* q, const float* s,
                                 void* out, int M, int K, int N, int G,
                                 int int4, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  const int gs = K / G;
  if (!int4)
    return (int)cc::launch_m<false, false>(x, q, s, out, M, K, N, gs, st);
  if (G == 1)
    return (int)cc::launch_m<true, false>(x, q, s, out, M, K, N, gs, st);
  return (int)cc::launch_m<true, true>(x, q, s, out, M, K, N, gs, st);
}

// bfloat16 (dtype 1) or float16 (dtype 2) x: quant_matmul_tc_kernel with
// the host's plan, a cluster of 1, 2, 4 or 8 blocks a column tile and 1..8
// ring stages. int4: x is (M, 2 xh) with the high plane at column xh >= K
// / 2, a multiple of 8 (xh == K / 2 when that is one); xh is not read for
// int8.
extern "C" int dstt_quant_matmul_tc(const void* x, const void* q,
                                    const float* s, void* out, int M, int K,
                                    int N, int G, int int4, int dtype,
                                    int xh, int cluster, int stages,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((cluster & (cluster - 1)) || cluster < 1 || cluster > tc::kMaxCluster ||
      stages < 1 || stages > tc::kMaxStages ||
      (int4 && (xh % 8 || xh < K / 2)))
    return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  if (dtype == 1)
    return (int)tc::launch_t<__nv_bfloat16>(x, q, s, out, M, K, N, G,
                                            int4 != 0, xh, cluster, stages,
                                            st);
  if (dtype == 2)
    return (int)tc::launch_t<__half>(x, q, s, out, M, K, N, G, int4 != 0, xh,
                                     cluster, stages, st);
  return (int)cudaErrorInvalidValue;
}
