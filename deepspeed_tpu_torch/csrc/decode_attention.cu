// One-query (decode) attention over a dense KV cache for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/decode_attention.py decode_attention ->
//   _kernel (pallas_call at :161).
//
// What it computes (decode_attention.py:186-209): q (B, N, D) -- one new
// token per row; caches (B, T, K, D); query head n reads KV head n / G
// (G = N / K). Key column j of row b is live when j < kv_len and
// valid[b, j] != 0 (the engine's validity mask is causality and padding in
// one; kv_len is an upper bound the caller knows, every column past it is
// invalid by construction). Score s = (q * scale) . k in fp32 plus
// slope[n] * key_positions[b, j] (alibi; the column j when no positions are
// given); online softmax in fp32; o = sum p v / l, or 0 for a row with no
// live key. A dead key is selected out (p = 0 and its V row skipped by a
// predicate), never multiplied, so a stale arena slot (even NaN) cannot
// reach the output.
//
// Bound on the H100: memory. The least time is the bytes of the live K and
// V rows (live columns x K x D x 2 x itemsize) plus q, out and the mask
// columns read, over 3.35 TB/s; the operations (4 x N x D per live key) are
// ~1 us of fp32 FMAs at llama-7b's decode. At that shape (B 8, T 1024, 32
// heads of 128, rows of 64..1000 keys with holes; ~50 MB of live K / V)
// the bound is ~0.015 ms. A TMA box moves all 32 rows of a live tile, dead
// ones too (PERF.md: the kernel moves its bytes at ~75% of HBM's rate).
//
// Design: decode_split_kernel, one launch a call (flash-decoding).
// * Split-KV: the columns below kv_len are cut into `splits` chunks of
//   `chunk` columns (a multiple of the 32-key tile; the wrapper picks both,
//   and the ring's stages, from B, K and kv_len: up to 8 splits, the grid
//   within ~4 blocks an SM, a 2-stage ring at 16-bit D 128 -- on the H100
//   more blocks an SM hid the latency better than more stages, and more
//   splits than that cost more in each block's fixed start and merge than
//   they gained). Block (split, row, KV head) serves that head's G query
//   heads over its chunk, so each K / V row is read once for all G heads
//   (GQA-native, no head repeat).
// * The `splits` blocks of a (row, KV head) form a thread-block cluster.
//   Each block merges its own partial softmax state (m, l, acc per query
//   head) and pushes it into block 0's shared memory (st.async, counted in
//   bytes on an mbarrier there); block 0 merges the splits in rank order
//   and writes o. No scratch, no counter, no second launch, and the same
//   bits on every call. A split with no live key carries l = 0, m = -1e30
//   and acc = 0 and adds nothing; a row whose splits are all empty gives 0.
// * A producer warp reads its chunk's valid words (8 tiles of 32 columns
//   in flight a lane), skips every tile with no live column, and streams
//   each live tile's 32 K rows and 32 V rows into a ring of `stages` stages
//   in shared memory: two TMA boxes (D, 1 head, 32 columns, 1 row) from
//   4-D tensor maps over (B, T, K, D), completion counted in bytes on the
//   stage's "full" mbarrier, with the tile's live bits and key positions
//   beside the stage; an end marker (live bits 0) follows the last tile.
//   Rows whose bytes are not a multiple of 16 (no tensor map takes them)
//   are copied by the producer's lanes with plain loads, live rows only.
// * Four consumer warps compute on the CUDA cores in fp32 (G <= 8 query
//   rows a KV head is far too little work for wgmma's 64-row tiles): a
//   sub-warp of SUB lanes holds one key, each lane NI dims of it (16 lanes
//   x 8 dims = 16 bytes a lane for 16-bit rows of D 128: a warp reads two
//   rows, 512 contiguous bytes, with no bank conflict), scores by
//   sub-warp shuffles, exp2 by ex2.approx; each sub-warp keeps its own
//   online softmax over its keys of every tile and releases the stage on
//   its "empty" mbarrier. The block merges the sub-warps' states through
//   shared memory (the drained ring) in a fixed order.

#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kTile = 32;                 // keys of a stage: one a lane
constexpr int kConsumerWarps = 4;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // and a producer warp
constexpr int kMaxStages = 8;
constexpr int kMaxSplits = 8;             // a portable cluster
constexpr int kMaxGroup = 8;              // query heads per KV head
constexpr int kReadAhead = 8;             // tiles of valid words in flight

struct DecodeArgs {
  const void* q;
  const void* kc;        // the caches, read by the plain-load route
  const void* vc;
  const int* valid;      // (B, T)
  const float* alibi;    // (N,) or null
  const float* kpos;     // (B, T) or null
  void* out;
  int T, N, K, D, kv_len;
  int splits, chunk, stages;
  int tile_bytes;        // one K (V) tile in shared memory, 128-aligned
  int region_bytes;      // the ring, or the block merge once it is drained
  int tma;               // rows by TMA (else plain loads)
  float scale;
};

// grid (splits * B * K) in clusters of `splits` along x, block kThreads;
// dynamic shared memory: 128 bytes of alignment slack, region_bytes, then
// (splits > 1) the cluster's partials o[splits][G][D], m[splits][G],
// l[splits][G]. SUB lanes hold one key, NI dims each; MAXG >= G.
template <typename T, int NI, int SUB, int MAXG>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const DecodeArgs a) {
  constexpr int NSW = kConsumerWarps * (32 / SUB);   // sub-warps of a block
  constexpr int KG = kTile / NSW;       // keys of a tile a sub-warp takes
  constexpr int KB = KG < 4 ? KG : 4;   // keys an online-softmax step takes
  constexpr int DW = NI * SUB;          // dims a sub-warp holds
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  __shared__ __align__(8) uint64_t merge_bar;   // block 0: partials in
  __shared__ uint32_t live_s[kMaxStages];       // 0: end marker
  __shared__ float kp_s[kMaxStages][kTile];     // alibi key positions
  __shared__ float bm_m[NSW][MAXG], bm_l[NSW][MAXG];

  const int S = a.splits, D = a.D, K = a.K, G = a.N / a.K;
  const int split = blockIdx.x % S, pair = blockIdx.x / S;
  const int row = pair / K, kh = pair % K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(a.kv_len, a.T);
  const int c0 = split * a.chunk, c1 = min(c0 + a.chunk, len);
  const int ntiles = c1 > c0 ? (c1 - c0 + kTile - 1) / kTile : 0;
  uint8_t* region = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  float* part_o = reinterpret_cast<float*>(region + a.region_bytes);
  float* part_m = part_o + S * G * D;
  float* part_l = part_m + S * G;

  if (tid == 0) {
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    mbar_init(&merge_bar, 1);
    fence_barrier_init();
    if (S > 1 && split == 0)
      mbar_expect_tx(&merge_bar, (uint32_t)((S - 1) * G * (D + 2) * 4));
  }
  // block 0's barrier is initialised before another block pushes to it:
  // every block arrives now and waits before its first push
  __syncwarp();
  if (S > 1)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---------------- producer warp ----------------
    const int* vrow = a.valid + (int64_t)row * a.T;
    const float* prow =
        a.kpos != nullptr ? a.kpos + (int64_t)row * a.T : nullptr;
    const bool bias = a.alibi != nullptr;
    const size_t isz = sizeof(T);
    int slot = 0, issued = 0;
    uint32_t phase = 0;
    auto claim = [&]() {   // the next stage, once its consumers are done
      if (issued >= a.stages) mbar_wait(&empty[slot], phase ^ 1);
    };
    auto advance = [&]() {
      ++issued;
      if (++slot == a.stages) {
        slot = 0;
        phase ^= 1;
      }
    };
    for (int t0 = 0; t0 < ntiles; t0 += kReadAhead) {
      int v[kReadAhead];
      float kp[kReadAhead];
#pragma unroll
      for (int u = 0; u < kReadAhead; ++u) {
        const int col = c0 + (t0 + u) * kTile + lane;
        const bool in = t0 + u < ntiles && col < c1;
        v[u] = in ? __ldg(vrow + col) : 0;
        kp[u] = (in && bias) ? (prow != nullptr ? __ldg(prow + col)
                                                : (float)col)
                             : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kReadAhead; ++u) {
        const uint32_t live = __ballot_sync(0xffffffffu, v[u] != 0);
        if (live == 0) continue;          // warp-uniform: skip a dead tile
        const int col0 = c0 + (t0 + u) * kTile;
        claim();
        kp_s[slot][lane] = kp[u];
        if (lane == 0) live_s[slot] = live;
        T* ks = reinterpret_cast<T*>(region + (size_t)slot * 2 * a.tile_bytes);
        T* vs = reinterpret_cast<T*>(region + (size_t)slot * 2 * a.tile_bytes
                                     + a.tile_bytes);
        if (!a.tma) {
          // plain loads of the live rows (dead rows keep stale bytes; the
          // consumers select them out)
          const T* kb = static_cast<const T*>(a.kc)
                        + (((int64_t)row * a.T + col0) * K + kh) * D;
          const T* vb = static_cast<const T*>(a.vc)
                        + (((int64_t)row * a.T + col0) * K + kh) * D;
          for (int j = 0; j < kTile; ++j) {
            if (!((live >> j) & 1u)) continue;
            const int64_t o = (int64_t)j * K * D;
            for (int d = lane; d < D; d += 32) {
              ks[j * D + d] = kb[o + d];
              vs[j * D + d] = vb[o + d];
            }
          }
        }
        __syncwarp();   // the lanes' stage writes, ordered before the arrive
        if (lane == 0) {
          if (a.tma) {
            mbar_expect_tx(&full[slot], (uint32_t)(2 * kTile * D * isz));
            tma_load_4d(ks, &kmap, 0, kh, col0, row, &full[slot]);
            tma_load_4d(vs, &vmap, 0, kh, col0, row, &full[slot]);
          } else {
            mbar_arrive(&full[slot]);
          }
        }
        advance();
      }
    }
    claim();
    if (lane == 0) {
      live_s[slot] = 0;                   // end marker
      mbar_arrive(&full[slot]);
    }
    __syncwarp();
    if (S > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    return;
  }

  // ---------------- consumer warps ----------------
  const int sw = warp * (32 / SUB) + lane / SUB;      // this lane's sub-warp
  const int d0 = (lane % SUB) * NI;  // this lane's dims d0 .. d0 + NI - 1
  const bool vec = D == DW;
  float qr[MAXG][NI], acc[MAXG][NI], m[MAXG], l[MAXG], slope[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    const bool gv = g < G;
    if (gv)
      load_slice<T, NI>(static_cast<const T*>(a.q)
                            + ((int64_t)row * a.N + kh * G + g) * D,
                        d0, D, vec, qr[g]);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      qr[g][i] = gv ? qr[g][i] * a.scale : 0.f;
      acc[g][i] = 0.f;
    }
    m[g] = kNegInf;
    l[g] = 0.f;
    slope[g] = (gv && a.alibi != nullptr) ? a.alibi[kh * G + g] : 0.f;
  }

  int slot = 0;
  uint32_t phase = 0;
  for (;;) {
    mbar_wait(&full[slot], phase);
    const uint32_t live = live_s[slot];
    if (live == 0) break;
    const T* ks = reinterpret_cast<const T*>(
        region + (size_t)slot * 2 * a.tile_bytes);
    const T* vs = reinterpret_cast<const T*>(
        region + (size_t)slot * 2 * a.tile_bytes + a.tile_bytes);
    // this sub-warp's keys of the tile: sw, sw + NSW, ...
#pragma unroll
    for (int u0 = 0; u0 < KG; u0 += KB) {
      float s[MAXG][KB];
      bool lv[KB];
#pragma unroll
      for (int u = 0; u < KB; ++u) {
        const int j = sw + NSW * (u0 + u);
        lv[u] = (live >> j) & 1u;
        float kr[NI];
        load_slice<T, NI, false>(ks + j * D, d0, D, vec, kr);
        const float kp = kp_s[slot][j];
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g >= G) break;
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < NI; ++i) dot = fmaf(qr[g][i], kr[i], dot);
          dot = sub_sum<SUB>(dot) + slope[g] * kp;
          s[g][u] = lv[u] ? dot : kNegInf;
        }
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) break;
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < KB; ++u) mx = fmaxf(mx, s[g][u]);
        const float corr = fast_exp2((m[g] - mx) * kLog2e);
        float psum = 0.f;
#pragma unroll
        for (int u = 0; u < KB; ++u) {
          s[g][u] = lv[u] ? fast_exp2((s[g][u] - mx) * kLog2e) : 0.f;
          psum += s[g][u];
        }
        l[g] = l[g] * corr + psum;
        m[g] = mx;
#pragma unroll
        for (int i = 0; i < NI; ++i) acc[g][i] *= corr;
      }
#pragma unroll
      for (int u = 0; u < KB; ++u) {
        const int j = sw + NSW * (u0 + u);
        float vr[NI];
        load_slice<T, NI, false>(vs + j * D, d0, D, vec, vr);
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g >= G) break;
#pragma unroll
          for (int i = 0; i < NI; ++i)
            acc[g][i] = lv[u] ? fmaf(s[g][u], vr[i], acc[g][i]) : acc[g][i];
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
    if (++slot == a.stages) {
      slot = 0;
      phase ^= 1;
    }
  }

  // merge the sub-warps' states through the drained ring, sub-warp order
  float* bm_acc = reinterpret_cast<float*>(region);   // [NSW][G][DW]
  named_barrier(1, kConsumers);   // every consumer is done with the ring
  if (lane % SUB == 0) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      bm_m[sw][g] = m[g];
      bm_l[sw][g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int i = 0; i < NI; ++i)
      bm_acc[(sw * G + g) * DW + d0 + i] = acc[g][i];
  }
  named_barrier(1, kConsumers);
  __syncwarp();
  if (S > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  T* out = static_cast<T*>(a.out) + ((int64_t)row * a.N + kh * G) * D;
  const uint32_t bar0 = S > 1 ? cluster_addr(&merge_bar, 0) : 0u;
  for (int o = tid; o < G * D; o += kConsumers) {
    const int g = o / D, d = o - g * D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < NSW; ++w) M = fmaxf(M, bm_m[w][g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < NSW; ++w) {
      const float e = fast_exp2((bm_m[w][g] - M) * kLog2e);
      L += bm_l[w][g] * e;
      O += bm_acc[(w * G + g) * DW + d] * e;
    }
    if (S == 1) {
      out[o] = from_f<T>(L > 0.f ? O / L : 0.f);
    } else if (split == 0) {
      part_o[o] = O;
      if (d == 0) {
        part_m[g] = M;
        part_l[g] = L;
      }
    } else {
      st_async(cluster_addr(&part_o[split * G * D + o], 0), O, bar0);
      if (d == 0) {
        st_async(cluster_addr(&part_m[split * G + g], 0), M, bar0);
        st_async(cluster_addr(&part_l[split * G + g], 0), L, bar0);
      }
    }
  }
  if (S == 1 || split != 0) return;

  // block 0: the splits' states in rank order
  named_barrier(1, kConsumers);   // this block's own partial is written
  mbar_wait(&merge_bar, 0);       // and every other block's has arrived
  for (int o = tid; o < G * D; o += kConsumers) {
    const int g = o / D;
    float M = kNegInf;
    for (int r = 0; r < S; ++r) M = fmaxf(M, part_m[r * G + g]);
    float L = 0.f, O = 0.f;
    for (int r = 0; r < S; ++r) {
      const float e = fast_exp2((part_m[r * G + g] - M) * kLog2e);
      L += part_l[r * G + g] * e;
      O += part_o[r * G * D + o] * e;
    }
    out[o] = from_f<T>(L > 0.f ? O / L : 0.f);
  }
}

// The 4-D map of a (B, T, K, D) cache in boxes of (D, 1, kTile, 1): one KV
// head's rows of kTile columns, dense in shared memory (no swizzle), zeros
// past T; from the cache of tensor_map (the decode loop calls each layer's
// arena again every step).
template <typename T>
cudaError_t row_map(CUtensorMap* map, const void* p, int B, int Tk, int K,
                    int D) {
  const cuuint64_t isz = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)K, (cuuint64_t)Tk,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {D * isz, (cuuint64_t)K * D * isz,
                                 (cuuint64_t)Tk * K * D * isz};
  const cuuint32_t box[4] = {(cuuint32_t)D, 1, (cuuint32_t)kTile, 1};
  return tensor_map(map, map_type<T>(), 4, p, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_NONE,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
}

template <typename T, int NI, int SUB, int MAXG>
cudaError_t launch(DecodeArgs a, int B, cudaStream_t st) {
  constexpr int NSW = kConsumerWarps * (32 / SUB);
  constexpr int DW = NI * SUB;
  auto kern = decode_split_kernel<T, NI, SUB, MAXG>;
  const int G = a.N / a.K;
  CUtensorMap km, vm;
  std::memset(&km, 0, sizeof(km));
  std::memset(&vm, 0, sizeof(vm));
  a.tma = (a.D * (int)sizeof(T)) % 16 == 0;
  if (a.tma) {
    cudaError_t e = row_map<T>(&km, a.kc, B, a.T, a.K, a.D);
    if (e == cudaSuccess) e = row_map<T>(&vm, a.vc, B, a.T, a.K, a.D);
    if (e != cudaSuccess) return e;
  }
  a.tile_bytes = (kTile * a.D * (int)sizeof(T) + 127) & ~127;
  const int ring = a.stages * 2 * a.tile_bytes;
  const int merge = NSW * G * DW * 4;
  a.region_bytes = ring > merge ? ring : merge;
  const int smem = 128 + a.region_bytes
                   + (a.splits > 1 ? a.splits * G * (a.D + 2) * 4 : 0);
  static int smem_set = 48 * 1024;   // per instantiation: opt in above it
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.splits * B * a.K));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.splits > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, km, vm, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// MAXG 1, 4 or 8 (G 2 takes 4: three instantiations a row layout keep the
// source's build time down)
template <typename T, int NI, int SUB>
cudaError_t launch_g(const DecodeArgs& a, int B, cudaStream_t st) {
  const int G = a.N / a.K;
  if (G <= 1) return launch<T, NI, SUB, 1>(a, B, st);
  if (G <= 4) return launch<T, NI, SUB, 4>(a, B, st);
  return launch<T, NI, SUB, 8>(a, B, st);
}

template <typename T>
cudaError_t launch_d(const DecodeArgs& a, int B, cudaStream_t st) {
  const int D = a.D;
  if constexpr (sizeof(T) == 2) {
    // 16-byte vectors per lane: 8 dims, 16 (or 8) lanes per key
    if (D == 128) return launch_g<T, 8, 16>(a, B, st);
    if (D == 64) return launch_g<T, 8, 8>(a, B, st);
  }
  if (D <= 32) return launch_g<T, 1, 32>(a, B, st);
  if (D <= 64) return launch_g<T, 2, 32>(a, B, st);
  if (D <= 128) return launch_g<T, 4, 32>(a, B, st);
  return launch_g<T, 8, 32>(a, B, st);
}

}  // namespace

// The wrapper (ops/decode_attention.py) checks every shape, dtype,
// alignment and contiguity and picks the split (decode_split_plan); this
// entry point assumes N % K == 0, N / K <= 8, D <= 256, 16-byte aligned q /
// caches, 1 <= splits <= 8, chunk a positive multiple of 32 with splits x
// chunk >= kv_len, and 2 <= stages <= 8. dtype: 0 = float32, 1 = bfloat16,
// 2 = float16. valid: (B, T) int32; alibi: (N,) fp32 or null; kpos: (B, T)
// fp32 or null. Returns the CUDA error of the launch.
extern "C" int dstt_decode_attention(const void* q, const void* kc,
                                     const void* vc, const int* valid,
                                     const float* alibi, const float* kpos,
                                     void* out, int B, int T, int N, int K,
                                     int D, int kv_len, float scale,
                                     int dtype, int splits, int chunk,
                                     int stages, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || K <= 0) return (int)cudaGetLastError();
  if (splits < 1 || splits > kMaxSplits || chunk < kTile || chunk % kTile
      || (int64_t)splits * chunk < kv_len || stages < 2
      || stages > kMaxStages || N % K || N / K > kMaxGroup || D < 1
      || D > 256)
    return (int)cudaErrorInvalidValue;
  DecodeArgs a = {};
  a.q = q;
  a.kc = kc;
  a.vc = vc;
  a.valid = valid;
  a.alibi = alibi;
  a.kpos = kpos;
  a.out = out;
  a.T = T;
  a.N = N;
  a.K = K;
  a.D = D;
  a.kv_len = kv_len;
  a.splits = splits;
  a.chunk = chunk;
  a.stages = stages;
  a.scale = scale;
  if (dtype == 0) return (int)launch_d<float>(a, B, st);
  if (dtype == 1) return (int)launch_d<__nv_bfloat16>(a, B, st);
  return (int)launch_d<__half>(a, B, st);
}
