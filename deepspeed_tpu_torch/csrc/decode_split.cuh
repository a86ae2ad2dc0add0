// The split-KV decode step for Hopper (sm_90a), shared by
// decode_attention.cu (decode_split_kernel: a dense (B, T, K, D) cache)
// and paged_attention.cu (paged_split_kernel: KV pages reached through a
// block table). Each kernel keeps its own producer warp (which keys a stage
// holds and how they are fetched); what is shared here:
// * the block: four consumer warps and one producer warp; the `splits`
//   blocks of one (row, KV head) form a thread-block cluster;
// * the ring: `stages` stages in dynamic shared memory, each one 32-key K
//   tile and one V tile (tile_bytes each), a "full" mbarrier (the
//   producer's arrive, plus the TMA bytes) and an "empty" one (one arrive a
//   consumer warp); beside each stage its live bits (bit j: key j counts; 0
//   ends the stream) and its keys' alibi positions;
// * the consumer warps (consume): q in registers, a sub-warp of SUB lanes a
//   key (NI dims a lane), an online softmax in fp32 per sub-warp with
//   ex2.approx, a dead key selected out (p = 0 and its V row skipped by a
//   predicate, never multiplied: a stale slot, even NaN, cannot reach the
//   output);
// * the merge: the sub-warps' states through the drained ring in sub-warp
//   order, then each block's (m, l, acc) pushed into block 0's shared
//   memory by st.async (counted in bytes on an mbarrier there) and merged
//   there in rank order: no atomics, no scratch, the same bits every call;
// * the launch: a cluster of `splits` blocks through cudaLaunchKernelEx,
//   and the choice of (NI, SUB, MAXG) from (type, D, G).

#pragma once

#include "attention_common.cuh"
#include "hopper.cuh"

namespace {
namespace split_kv {

constexpr int kTile = 32;                 // keys of a stage: one a lane
constexpr int kConsumerWarps = 4;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // and a producer warp
constexpr int kMaxStages = 8;
constexpr int kMaxSplits = 8;             // a portable cluster
constexpr int kMaxGroup = 8;              // query heads per KV head

// static shared memory of a block; SUB lanes hold a key, MAXG >= G
template <int SUB, int MAXG>
struct Smem {
  static constexpr int kSubWarps = kConsumerWarps * (32 / SUB);
  uint64_t full[kMaxStages], empty[kMaxStages];
  uint64_t merge_bar;                     // block 0: partials in
  uint32_t live[kMaxStages];              // 0: end marker
  float kpos[kMaxStages][kTile];          // alibi key positions
  float bm_m[kSubWarps][MAXG], bm_l[kSubWarps][MAXG];
};

// dynamic shared memory: 128 bytes of alignment slack, the ring (or the
// block merge once it is drained, region_bytes), then (splits > 1) the
// cluster's partials o[splits][G][D], m[splits][G], l[splits][G]
struct Layout {
  uint8_t* region;
  float* part_o;
  float* part_m;
  float* part_l;
};

__device__ __forceinline__ Layout layout(uint8_t* raw, int region_bytes,
                                         int S, int G, int D) {
  Layout L;
  L.region = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 127) & ~uintptr_t(127));
  L.part_o = reinterpret_cast<float*>(L.region + region_bytes);
  L.part_m = L.part_o + S * G * D;
  L.part_l = L.part_m + S * G;
  return L;
}

// the dynamic shared memory a launch asks for
inline int smem_bytes(int region_bytes, int S, int G, int D) {
  return 128 + region_bytes + (S > 1 ? S * G * (D + 2) * 4 : 0);
}

// The barriers initialised; block 0's merge barrier expects the other
// blocks' partials. Block 0's barrier is initialised before another block
// pushes to it: every block arrives at the cluster barrier now and waits
// before its first push (finish / consume).
template <class Sm>
__device__ __forceinline__ void start(Sm& sm, int stages, int S, int split,
                                      int G, int D) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&sm.full[i], 1);
      mbar_init(&sm.empty[i], kConsumerWarps);
    }
    mbar_init(&sm.merge_bar, 1);
    fence_barrier_init();
    if (S > 1 && split == 0)
      mbar_expect_tx(&sm.merge_bar, (uint32_t)((S - 1) * G * (D + 2) * 4));
  }
  __syncwarp();
  if (S > 1)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  __syncthreads();
}

// The producer warp's walk over the ring: claim the next stage (once its
// consumers are done with it), fill it, arrive on full[slot] (or let the
// TMA bytes complete it), advance; finish() sends the end marker.
struct Producer {
  uint64_t* full;
  uint64_t* empty;
  uint32_t* live;
  int stages;
  int slot = 0, issued = 0;
  uint32_t phase = 0;

  __device__ __forceinline__ void claim() {
    if (issued >= stages) mbar_wait(&empty[slot], phase ^ 1);
  }
  __device__ __forceinline__ void advance() {
    ++issued;
    if (++slot == stages) {
      slot = 0;
      phase ^= 1;
    }
  }
  __device__ __forceinline__ void finish(int lane, int S) {
    claim();
    if (lane == 0) {
      live[slot] = 0;                     // end marker
      mbar_arrive(&full[slot]);
    }
    __syncwarp();
    if (S > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  }
};

// The consumer warps of a block: the stream of stages until the end
// marker, then the sub-warp merge and the cluster merge; block 0 (or the
// only block) writes o. q: the G query rows of this KV head (D each);
// alibi: their G slopes, or null; out: their G output rows.
template <typename T, int NI, int SUB, int MAXG, class Sm>
__device__ __forceinline__ void consume(Sm& sm, const Layout& lay,
                                        int stages, int tile_bytes,
                                        const T* __restrict__ q,
                                        const float* __restrict__ alibi,
                                        float scale, int G, int D, int S,
                                        int split, T* __restrict__ out) {
  constexpr int NSW = kConsumerWarps * (32 / SUB);   // sub-warps of a block
  constexpr int KG = kTile / NSW;       // keys of a tile a sub-warp takes
  constexpr int KB = KG < 4 ? KG : 4;   // keys an online-softmax step takes
  constexpr int DW = NI * SUB;          // dims a sub-warp holds
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint8_t* region = lay.region;
  float* part_o = lay.part_o;
  float* part_m = lay.part_m;
  float* part_l = lay.part_l;

  const int sw = warp * (32 / SUB) + lane / SUB;      // this lane's sub-warp
  const int d0 = (lane % SUB) * NI;  // this lane's dims d0 .. d0 + NI - 1
  const bool vec = D == DW;
  float qr[MAXG][NI], acc[MAXG][NI], m[MAXG], l[MAXG], slope[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    const bool gv = g < G;
    if (gv) load_slice<T, NI>(q + (int64_t)g * D, d0, D, vec, qr[g]);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      qr[g][i] = gv ? qr[g][i] * scale : 0.f;
      acc[g][i] = 0.f;
    }
    m[g] = kNegInf;
    l[g] = 0.f;
    slope[g] = (gv && alibi != nullptr) ? alibi[g] : 0.f;
  }

  int slot = 0;
  uint32_t phase = 0;
  for (;;) {
    mbar_wait(&sm.full[slot], phase);
    const uint32_t live = sm.live[slot];
    if (live == 0) break;
    const T* ks = reinterpret_cast<const T*>(
        region + (size_t)slot * 2 * tile_bytes);
    const T* vs = reinterpret_cast<const T*>(
        region + (size_t)slot * 2 * tile_bytes + tile_bytes);
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
        const float kp = sm.kpos[slot][j];
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
    if (lane == 0) mbar_arrive(&sm.empty[slot]);
    if (++slot == stages) {
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
      sm.bm_m[sw][g] = m[g];
      sm.bm_l[sw][g] = l[g];
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
  const uint32_t bar0 = S > 1 ? cluster_addr(&sm.merge_bar, 0) : 0u;
  for (int o = tid; o < G * D; o += kConsumers) {
    const int g = o / D, d = o - g * D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < NSW; ++w) M = fmaxf(M, sm.bm_m[w][g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < NSW; ++w) {
      const float e = fast_exp2((sm.bm_m[w][g] - M) * kLog2e);
      L += sm.bm_l[w][g] * e;
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
  mbar_wait(&sm.merge_bar, 0);    // and every other block's has arrived
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

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// Bytes of the region: the ring of `stages` K / V tile pairs, or the
// sub-warps' merge, whichever is larger (NSW sub-warps of DW dims).
inline int region_bytes(int stages, int tile_bytes, int NSW, int G,
                        int DW) {
  const int ring = stages * 2 * tile_bytes;
  const int merge = NSW * G * DW * 4;
  return ring > merge ? ring : merge;
}

// `kern` on `blocks` blocks of kThreads in clusters of `splits` along x
// (no cluster when splits is 1), with `smem` bytes of dynamic shared memory
// (opted in above 48 KB once per kernel: `smem_set` is the kernel's own).
template <typename Kern, typename Args>
cudaError_t launch(Kern kern, int& smem_set, int blocks, int splits,
                   int smem, cudaStream_t st, const CUtensorMap& km,
                   const CUtensorMap& vm, const Args& a) {
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, km, vm, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// Launch<T, NI, SUB, MAXG>::run(args...) for the consumer layout of (T, D)
// and the group size G: MAXG 1, 4 or 8 (G 2 takes 4: three instantiations
// a row layout keep the sources' build time down); 16-bit rows of D 128 /
// 64 as one 16-byte vector a lane (16 / 8 lanes a key), else 32 lanes a
// key with D / 32 dims each.
template <template <typename, int, int, int> class Launch, typename T,
          int NI, int SUB, typename... A>
cudaError_t by_group(int G, A... args) {
  if (G <= 1) return Launch<T, NI, SUB, 1>::run(args...);
  if (G <= 4) return Launch<T, NI, SUB, 4>::run(args...);
  return Launch<T, NI, SUB, 8>::run(args...);
}

template <template <typename, int, int, int> class Launch, typename T,
          typename... A>
cudaError_t dispatch(int D, int G, A... args) {
  if constexpr (sizeof(T) == 2) {
    if (D == 128) return by_group<Launch, T, 8, 16>(G, args...);
    if (D == 64) return by_group<Launch, T, 8, 8>(G, args...);
  }
  if (D <= 32) return by_group<Launch, T, 1, 32>(G, args...);
  if (D <= 64) return by_group<Launch, T, 2, 32>(G, args...);
  if (D <= 128) return by_group<Launch, T, 4, 32>(G, args...);
  return by_group<Launch, T, 8, 32>(G, args...);
}

}  // namespace split_kv
}  // namespace
