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
// negative, NaN after rsqrt) when |mean| >> std, but two-pass ones (a mean,
// then the centred sum of squares M2) over parts of the batch row, merged by
// Chan's formula. They are of x - shift, the shift being the group's first
// element of the batch row, and the output is ((x - shift) - mean) * rstd:
// at 300 + 0.01 N(0, 1) an fp32 mean of x itself would be off by ulps of
// 300, i.e. 0.3% of the std each, where the shifted one is exact to ulps of
// 0.01.
//
// Bound on the H100: bytes. x is read once and y written once, ~3 flops an
// element: at the SD v1.5 VAE mid block (B 4, HW 4096, C 512, bf16) 16.8 MB
// each way, 10.0 us at 3.35 TB/s. ops/spatial.py::gn_plan picks one of two
// routes on the host, from shapes and pointer alignment:
//
// Resident (gn_resident_kernel, one launch): when each batch row's rows,
// split over sms / B blocks, fit a block's shared memory (GN_SMEM_BYTES in
// ops/spatial.py; the VAE mid block in 16 bits: 33 blocks a row of 125 rows,
// 125 KB) and every pointer is 16-byte aligned. The activation stays on
// chip between the statistics and the normalisation, so HBM sees one read
// and one write:
//   1. A block loads its contiguous run of rows into dynamic shared memory
//      by up to kChunks (2) 1-D bulk copies, each with its own mbarrier, so
//      the first pass starts on the first half while the second lands (at
//      the VAE mid block 8 copies ran 0.0168 ms, 4 0.0160, 2 0.0157-0.0159,
//      1 0.0160-0.0161: trial builds on the H100, PERF.md).
//   2. Thread t holds the channels of vector t % (C / V) of rows t / (C / V),
//      + lanes, ... (`lanes` rows a step; a thread's channels lie in one
//      group, since V divides cg), so it keeps one sum and holds its scale
//      and bias in registers. Two passes over shared memory give the block's
//      mean of x - shift, then its M2, of each group: fp32 thread sums in
//      row then element order, then per group the threads' partials in (row
//      lane, vector) order, lane l of a warp taking l, l + 32, ..., and an
//      xor butterfly. The second pass sums (x - c)^2 about c = shift + mean
//      rounded once (one subtraction an element) and takes out n e^2 for
//      c's rounding e (TwoSum). No division in the inner loops. The block
//      writes its (mean, M2) of each group to `part` (B, G, blocks).
//   3. The blocks of a batch row meet at a barrier: an arrival counter that
//      each block raises by its share of kEpoch (2^20; the shares of a
//      launch sum to it whatever the block count) with a release reduction
//      after a CTA barrier, and polls with ld.acquire until it reaches the
//      multiple of kEpoch after the one it read at the start. It is never
//      reset, so it holds between launches of any block count and across
//      CUDA-graph replays. The counters
//      are a __device__ array (zeroed when the module loads), a row of
//      kMaxRows for each of kSlots streams (the wrapper gives each stream
//      its own, so calls on two streams never share one). The launch is
//      cooperative (cudaLaunchAttributeCooperative), so all blocks are
//      resident or the launch fails with an error: the wait cannot deadlock.
//      A wait past kBarrierTimeoutNs traps rather than hanging the card.
//   4. Every block of row b merges all of b's partials by Chan's formula in
//      block order (the weights n_j / N_j and N_{j-1} n_j / N_j from the
//      plan's counts, computed before the barrier; in fp64 when y is fp32,
//      whose rounding is finer than an fp32 chain's drift), so every block
//      and every call gets the same bits; rstd = rsqrt(M2 / n + eps).
//   5. It normalises its run from shared memory as (x - c) a + (bias - e a),
//      a = rstd scale, c = shift + mean rounded once and e its rounding
//      (one subtraction and one FMA an element), and writes y with V-wide
//      stores, 16-bit pairs rounded by one conversion: the only HBM write.
//
// Streaming (two launches; over-capacity shapes, fp32 at the VAE mid block,
// views not 16-byte aligned, rows not a multiple of 16 bytes):
//   1. gn_stats_kernel: one warp per (b, chunk of RC rows, g) unit writes
//      that unit's shifted (mean, M2) to a (B, G, chunks) scratch the wrapper
//      allocates. Lanes walk the unit's (row, vector) items, a vector being
//      V channels of one group (V = 16 bytes' worth, cut down until it
//      divides cg), then merge by a shuffle butterfly.
//   2. gn_apply_kernel: one block per (RA rows, b). Its warps first merge
//      the chunks' states of each group of b (lanes over chunks, then a
//      butterfly) into mean and rstd in shared memory, then the block
//      normalises its rows with V-wide loads and stores.
//   x is read twice (the second read often from the 50 MB L2) and written
//   once. Neither launch depends on the order in which blocks run.

#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// The resident route
// ---------------------------------------------------------------------------

constexpr int kResThreads = 1024;  // gn_resident_kernel's launch bounds
constexpr int kChunks = 2;         // bulk copies (one mbarrier each) a block
constexpr int kScratch = 4096;     // floats: thread partials, merge tiles
constexpr int kMergeTile = 256;    // the most blocks a merge tile covers
constexpr int kSlots = 128;        // arrival counters: streams ...
constexpr int kMaxRows = 256;      // ... x batch rows
constexpr unsigned kEpoch = 1u << 20;  // a launch's arrivals, in shares
constexpr unsigned long long kBarrierTimeoutNs = 10000000000ull;  // 10 s

__device__ unsigned int g_arrivals[kSlots * kMaxRows];

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void red_release_add(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// out[g] = (the sum over the block's threads of group g of v) / n: red[t] =
// v (0 from threads past the live ones); warp w takes groups w, w + warps,
// ...: lane l sums the group's partials l, l + 32, ... of its lanes * vpg
// (partial p: row lane p / vpg, vector p % vpg of the group), then an xor
// butterfly (the same bits in every lane).
__device__ __forceinline__ void group_totals(float v, float* red, float* out,
                                             int G, int lanes, int vpg,
                                             int ncv, float n) {
  red[threadIdx.x] = v;
  __syncthreads();
  const int lane = threadIdx.x & 31, P = lanes * vpg;
  for (int g = threadIdx.x >> 5; g < G; g += blockDim.x >> 5) {
    float s = 0.f;
    for (int p = lane; p < P; p += 32) {
      const int l = p / vpg;
      s += red[l * ncv + g * vpg + (p - l * vpg)];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) out[g] = s / n;
  }
  __syncthreads();
}

// s = fl(a + b) and its rounding error e = (a + b) - s, exactly (Knuth)
__device__ __forceinline__ float two_sum(float a, float b, float& e) {
  const float s = __fadd_rn(a, b), bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
  return s;
}

// Chan's weights of blocks t0 .. t0 + tn - 1 of a batch row split into
// blocks of RB rows: w = n_j / N_j and c = N_{j - 1} n_j / N_j, n_j the
// block's elements of a group, N_j those of blocks 0 .. j
template <typename A>
__device__ __forceinline__ void merge_weights(A* w_s, A* c_s, int t0, int tn,
                                              int HW, int RB, int cg) {
  for (int i = threadIdx.x; i < tn; i += blockDim.x) {
    const int jj = t0 + i;
    const A w = (A)(min(RB, HW - jj * RB) * cg) /
                (A)(min(HW, (jj + 1) * RB) * cg);
    w_s[i] = w;
    c_s[i] = (A)(jj * RB * cg) * w;
  }
}

// V floats rounded to T, two at a time (one conversion) where T is 16 bits
template <typename T, int V>
__device__ __forceinline__ Pack<T, V> pack(const float (&f)[V]) {
  Pack<T, V> out;
  if constexpr (V % 2 == 0 && std::is_same_v<T, __nv_bfloat16>) {
#pragma unroll
    for (int i = 0; i < V; i += 2)
      *reinterpret_cast<__nv_bfloat162*>(&out.v[i]) =
          __floats2bfloat162_rn(f[i], f[i + 1]);
  } else if constexpr (V % 2 == 0 && std::is_same_v<T, __half>) {
#pragma unroll
    for (int i = 0; i < V; i += 2)
      *reinterpret_cast<__half2*>(&out.v[i]) =
          __floats2half2_rn(f[i], f[i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) out.v[i] = from_f<T>(f[i]);
  }
  return out;
}

// Block (j, b) of a (blocks, B) grid of `threads` >= lanes * C / V threads
// normalises rows [j RB, min((j + 1) RB, HW)) of batch row b; `slot` picks
// the stream's row of arrival counters.
template <typename T, typename S, int V>
__global__ void __launch_bounds__(kResThreads, 1)
gn_resident_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                   const S* __restrict__ bias, T* __restrict__ y,
                   float2* __restrict__ part, int slot, int HW, int C,
                   int G, int RB, int lanes, float eps) {
  // the merge's arithmetic: fp64 for fp32 y, whose rounding is finer than
  // an fp32 chain's drift over up to 64 blocks (a few ulps of the mean and
  // of M2); fp32 for 16-bit y (+0.5 us at the VAE mid block in fp64)
  using A = std::conditional_t<std::is_same_v<T, float>, double, float>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  __shared__ __align__(16) float scratch[kScratch];
  __shared__ float shift_s[kMaxGroups], mean_s[kMaxGroups], m2_s[kMaxGroups],
      err_s[kMaxGroups];
  __shared__ A w_s[kMergeTile], c_s[kMergeTile];
  __shared__ __align__(8) uint64_t bar[kChunks];

  const int nb = gridDim.x, j = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int cg = C / G, vpg = cg / V, ncv = C / V;
  const int rows = min(RB, HW - j * RB);
  // rows of a bulk copy: a multiple of lanes, at most kChunks copies
  const int crows = lanes * ((rows + lanes * kChunks - 1) / (lanes * kChunks));
  const int chunks = (rows + crows - 1) / crows;
  const T* xb = x + ((int64_t)b * HW + (int64_t)j * RB) * C;
  T* yb = y + ((int64_t)b * HW + (int64_t)j * RB) * C;

  // the arrival counter stood at a multiple of kEpoch before this launch
  // and cannot reach the next before this block arrives
  unsigned* ctr = g_arrivals + slot * kMaxRows + b;
  unsigned epoch = 0;
  if (tid == 0) {
    epoch = ld_relaxed(ctr) & ~(kEpoch - 1u);
    for (int k = 0; k < chunks; ++k) mbar_init(&bar[k], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int k = 0; k < chunks; ++k) {
      const uint32_t bytes =
          (uint32_t)(min(crows, rows - k * crows) * C) * sizeof(T);
      mbar_expect_tx(&bar[k], bytes);
      bulk_load(xs + k * crows * C, xb + (int64_t)k * crows * C, bytes,
                &bar[k]);
    }
  if (tid < G) shift_s[tid] = to_f(x[(int64_t)b * HW * C + tid * cg]);
  const bool live = tid < lanes * ncv;
  const int cv = tid % ncv, lr = tid / ncv, g = cv / vpg;
  float sc[V], bi[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    sc[i] = to_f(scale[cv * V + i]);
    bi[i] = to_f(bias[cv * V + i]);
  }
  __syncthreads();
  const float shift = shift_s[g];

  // the block's mean of each group, chunk by chunk as the copies land
  float s = 0.f;
  for (int k = 0; k < chunks; ++k) {
    mbar_wait(&bar[k], 0);
    const int end = min(rows, (k + 1) * crows);
    if (live)
      for (int r = k * crows + lr; r < end; r += lanes) {
        const Pack<T, V> p =
            *reinterpret_cast<const Pack<T, V>*>(xs + r * C + cv * V);
#pragma unroll
        for (int i = 0; i < V; ++i) s += to_f(p.v[i]) - shift;
      }
  }
  group_totals(s, scratch, mean_s, G, lanes, vpg, ncv, (float)(rows * cg));

  // its centred sum of squares, about c = shift + mean rounded once: d = x
  // - c is one subtraction, and sum (x - c)^2 = M2 + n e^2 for the
  // rounding e of c (TwoSum; the cross term vanishes), taken out after
  float e;
  const float c = two_sum(shift, mean_s[g], e);
  float q = 0.f;
  if (live)
    for (int r = lr; r < rows; r += lanes) {
      const Pack<T, V> p =
          *reinterpret_cast<const Pack<T, V>*>(xs + r * C + cv * V);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = to_f(p.v[i]) - c;
        q += d * d;
      }
    }
  group_totals(q, scratch, m2_s, G, lanes, vpg, ncv, 1.f);
  if (tid < G) {
    float eg;
    two_sum(shift_s[tid], mean_s[tid], eg);
    part[((int64_t)b * G + tid) * nb + j] = make_float2(
        mean_s[tid], m2_s[tid] - (float)(rows * cg) * eg * eg);
  }
  // the merge weights of the first tile of blocks (below), from the plan
  const int tile = min(kMergeTile, kScratch / 2 / G);
  merge_weights(w_s, c_s, 0, min(tile, nb), HW, RB, cg);

  // the barrier of batch row b's blocks: each adds its share of kEpoch
  // (release: the block's partials, ordered before by the CTA barrier, are
  // visible to whoever acquires the sum), so the counter moves by kEpoch a
  // launch whatever the block count; then it polls (acquire) until the
  // counter reaches the next multiple
  __syncthreads();
  if (tid == 0) {
    red_release_add(ctr, (unsigned)(((j + 1ull) * kEpoch) / nb -
                                    ((unsigned long long)j * kEpoch) / nb));
    const unsigned long long t0 = global_ns();
    while (ld_acquire(ctr) - epoch < kEpoch)
      if (global_ns() - t0 > kBarrierTimeoutNs) __trap();
  }
  __syncthreads();

  // Chan's merge of the row's partials in block order, a tile of blocks at
  // a time: thread g < G merges group g
  float2* stage = reinterpret_cast<float2*>(scratch);
  A m = 0, m2 = 0;
  for (int t0 = 0; t0 < nb; t0 += tile) {
    const int tn = min(tile, nb - t0);
    if (t0 > 0) merge_weights(w_s, c_s, t0, tn, HW, RB, cg);
    for (int k = tid; k < G * tn; k += blockDim.x) {
      const int gg = k / tn;
      stage[k] = __ldcg(part + ((int64_t)b * G + gg) * nb + t0 + k - gg * tn);
    }
    __syncthreads();
    if (tid < G) {
#pragma unroll 4
      for (int i = 0; i < tn; ++i) {
        const float2 pb = stage[tid * tn + i];
        const A d = pb.x - m;
        m = m + d * w_s[i];
        m2 = m2 + pb.y + d * d * c_s[i];
      }
    }
    __syncthreads();
  }
  // the row's centre c = shift + mean rounded to fp32 once (mean_s), its
  // rounding e (err_s), and rstd (m2_s; correctly rounded for fp32 y)
  if (tid < G) {
    if constexpr (std::is_same_v<A, double>) {
      const double cd = shift_s[tid] + m;
      mean_s[tid] = (float)cd;
      err_s[tid] = (float)(cd - (double)(float)cd);
      m2_s[tid] = (float)(1.0 / sqrt(m2 / (double)(HW * cg) + (double)eps));
    } else {
      float eg;
      mean_s[tid] = two_sum(shift_s[tid], m, eg);
      err_s[tid] = eg;
      m2_s[tid] = rsqrtf(m2 / (float)(HW * cg) + eps);
    }
  }
  __syncthreads();

  // normalise the run from shared memory; y's only write:
  // ((x - shift) - mean) rstd scale + bias = (x - c) a + (bias - e a), a =
  // rstd scale: a subtraction and an FMA an element
  const float cn = mean_s[g], rstd = m2_s[g];
  e = err_s[g];
  float mul[V], add[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    mul[i] = rstd * sc[i];
    add[i] = bi[i] - e * mul[i];
  }
  if (live)
    for (int r = lr; r < rows; r += lanes) {
      const Pack<T, V> p =
          *reinterpret_cast<const Pack<T, V>*>(xs + r * C + cv * V);
      float f[V];
#pragma unroll
      for (int i = 0; i < V; ++i) f[i] = (to_f(p.v[i]) - cn) * mul[i] + add[i];
      *reinterpret_cast<Pack<T, V>*>(yb + (int64_t)r * C + cv * V) =
          pack<T, V>(f);
    }
}

template <typename T, typename S, int V>
cudaError_t launch_streaming(const void* x, const void* scale,
                             const void* bias, void* y, float2* part, int B,
                             int HW, int C, int G, int RC, int RA, float eps,
                             cudaStream_t st) {
  const int chunks = (HW + RC - 1) / RC;
  const int64_t units = (int64_t)B * chunks * G;
  gn_stats_kernel<T, V><<<(unsigned)((units + kWarps - 1) / kWarps), kThreads,
                          0, st>>>((const T*)x, part, B, HW, C, G, RC, chunks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((HW + RA - 1) / RA), (unsigned)B);
  gn_apply_kernel<T, S, V><<<grid, kThreads, 0, st>>>(
      (const T*)x, (const S*)scale, (const S*)bias, (T*)y, part, HW, C, G, RC,
      chunks, RA, eps);
  return cudaGetLastError();
}

template <typename T, typename S, int V>
cudaError_t launch_resident(const void* x, const void* scale,
                            const void* bias, void* y, float2* part, int slot,
                            int B, int HW, int C, int G, int RB, int blocks,
                            int lanes, int threads, float eps,
                            cudaStream_t st) {
  if (slot < 0 || slot >= kSlots || B > kMaxRows || threads > kResThreads ||
      threads < lanes * (C / V))
    return cudaErrorInvalidValue;
  const auto kern = gn_resident_kernel<T, S, V>;
  const int smem = RB * C * (int)sizeof(T);
  // per instantiation: opt in to the block's dynamic shared memory (its
  // static 22 KB count against the default 48 KB too)
  static int smem_set = -1;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, (unsigned)B);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, kern, (const T*)x, (const S*)scale,
                         (const S*)bias, (T*)y, part, slot, HW, C, G, RB,
                         lanes, eps);
  return e != cudaSuccess ? e : cudaGetLastError();
}

struct Args {
  const void *x, *scale, *bias;
  void* y;
  float2* part;
  int B, HW, C, G, resident, rows, blocks, lanes, threads, slot, RC;
  float eps;
  cudaStream_t st;
};

template <typename T, typename S, int V>
cudaError_t launch_v(const Args& a) {
  if (a.resident)
    return launch_resident<T, S, V>(a.x, a.scale, a.bias, a.y, a.part,
                                    a.slot, a.B, a.HW, a.C, a.G, a.rows,
                                    a.blocks, a.lanes, a.threads, a.eps,
                                    a.st);
  return launch_streaming<T, S, V>(a.x, a.scale, a.bias, a.y, a.part, a.B,
                                   a.HW, a.C, a.G, a.RC, a.rows, a.eps, a.st);
}

template <typename T, typename S>
cudaError_t launch_s(const Args& a, int vec) {
  if (vec == 8) return launch_v<T, S, 8>(a);
  if (vec == 4) return launch_v<T, S, 4>(a);
  if (vec == 2) return launch_v<T, S, 2>(a);
  return launch_v<T, S, 1>(a);
}

template <typename T>
cudaError_t launch(const Args& a, int vec, int affine_f32) {
  return affine_f32 ? launch_s<T, float>(a, vec) : launch_s<T, T>(a, vec);
}

}  // namespace

// x, y: (B, HW, C) of dtype 0 = float32, 1 = bfloat16, 2 = float16; scale,
// bias: (C,) float32 when affine_f32, else x's dtype. vec is the elements
// per access: it divides C / G, vec * itemsize <= 16 (fp32 x: vec <= 4) and
// every pointer is aligned to vec elements (the wrapper checks); G <= 128.
// resident = 1 (ops/spatial.py::gn_plan): gn_resident_kernel on a (blocks,
// B) grid of `threads` threads, `rows` rows a block, `lanes` rows a step;
// part: (B, G, blocks) float2 scratch; slot < kSlots the stream's row of
// arrival counters; x and y 16-byte aligned and C * itemsize a multiple of
// 16. resident = 0: gn_stats_kernel over units of RC rows, part (B, G,
// ceil(HW / RC)), then gn_apply_kernel, `rows` rows a block. Returns the
// first CUDA error of the launches.
extern "C" int dstt_group_norm_fwd(const void* x, const void* scale,
                                   const void* bias, void* y, void* part,
                                   int B, int HW, int C, int G, int resident,
                                   int rows, int blocks, int lanes,
                                   int threads, int slot, int RC, float eps,
                                   int dtype, int vec, int affine_f32,
                                   void* stream) {
  if (B <= 0 || HW <= 0 || C <= 0) return (int)cudaGetLastError();
  const Args a{x,      scale,  bias,  y,     (float2*)part, B,  HW,
               C,      G,      resident, rows, blocks, lanes, threads,
               slot,   RC,     eps,   (cudaStream_t)stream};
  cudaError_t e;
  if (dtype == 0)
    e = launch<float>(a, vec, affine_f32);
  else if (dtype == 1)
    e = launch<__nv_bfloat16>(a, vec, affine_f32);
  else
    e = launch<__half>(a, vec, affine_f32);
  return (int)e;
}
