// Paged attention over the serving arena for Hopper (sm_90a): one-query
// decode and chunked prefill, reading K/V through a block table.
//
// Replaces: deepspeed_tpu/ops/paged_decode_attention.py
//   * paged_decode_attention / _decode_kernel (pallas_call at :171)
//   * paged_prefill_attention / _prefill_kernel (pallas_call at :294)
//
// Layout (shared with models/transformer.py): pools (NB, BS, K, D), block 0
// is scratch; the token at absolute position p of a row sits in block
// table[row, p / BS] at offset p % BS, so a key's column is its position and
// causality over true positions is the whole validity story. Query head n
// reads KV head n / G (G = N / K). Scores are (q * scale) . k in fp32 plus
// alibi slope[n] * column; softmax is online in fp32; the output is acc / l,
// or 0 for a row with no visible key (a decode row of length 0, a prefill
// pad query).
//
// Non-finite residue: scratch block 0 and recycled pages may hold NaN. A key
// past a query's position gets probability 0 by a select (never by adding a
// mask), and its v row is never multiplied in (select again: 0 * NaN = NaN).
//
// Bound on the H100:
//   * decode is memory-bound: the least time is the bytes of the resident
//     K and V (sum over rows of len * K * D * 2 * itemsize) plus q, out and
//     the table entries read, over 3.35 TB/s; the operations (4 N D a live
//     key) are a few microseconds of fp32 FMAs at llama-7b's serve step.
//     Design: paged_split_kernel, one launch a call (flash-decoding over
//     pages; the consumer warps, the merge and the launch are the dense
//     decode kernel's, csrc/decode_split.cuh).
//     - Split-KV: the blocks of a (row, KV head) are a thread-block cluster
//       of `splits` (a power of two up to 8, chosen on the host from R, K,
//       D, the table's capacity and the SM count only: the grid within ~4
//       blocks an SM). The row's pages are divided among its splits on the
//       device, from lengths[row], in near-equal runs of whole units: a
//       unit is one page when a page holds 32 rows or more, else the
//       32 / BS pages that fill one 32-key stage. The wrapper never reads
//       lengths on the host (the serve loop calls it once a layer).
//     - A producer warp reads its run's table entries 32 at a time (one
//       a lane) and streams each stage into a ring: per page of the stage
//       a TMA box (D, 1 head, min(BS, 32) rows, 1 page) of K and one of V
//       from 4-D tensor maps over the layer's pools (D, K, BS, NB) at
//       (0, head, first row, table entry), completion counted in bytes on
//       the stage's "full" mbarrier, with the stage's live bits (its first
//       `n` rows, n = min(rows of the stage, len - first column)) and its
//       keys' columns beside it; an end marker follows the last stage.
//       Only pages below ceil(len / BS) are dereferenced: table entries
//       past them (0 = scratch, or stale) are never read. Rows that no
//       tensor map takes (bytes not a multiple of 16, or a box of several
//       pages not a multiple of 128 bytes) are copied by the producer's
//       lanes with plain loads, live rows only.
//     - Four consumer warps on the CUDA cores in fp32 (G <= 8 query rows a
//       KV head is far too little for wgmma's 64-row tiles): 16 lanes x 8
//       dims a key for 16-bit D 128, an online softmax per sub-warp; a dead
//       key (the tail of the last page) is selected out. The sub-warps
//       merge through the drained ring, the splits in block 0 by st.async,
//       in a fixed order: the same bits on every call.
//     Trouble spots: a tensor map per layer pool (from the bounded cache of
//     hopper.cuh: the serve loop reuses 2 x layers of them); a TMA box
//     starts on 128 bytes of shared memory; a split's fixed cost (start,
//     the first table read and TMA round trip, the cluster exchange) is
//     what a short row pays, so the split stays within ~4 blocks an SM.
//   * chunked prefill: the least time is the larger of its bytes (K+V up
//     to the chunk's last position, q, out) over 3.35 TB/s and its 4 * N * D
//     operations per visible (query, key) pair over the bf16 tensor-core
//     peak; at llama-7b's serve chunk (B 1, C 256, 32 heads of 128, start
//     256: 512 keys) the bytes bound it, 0.0038 ms.
//     Design, bf16 / fp16 with D in {16, 32, 64, 128}:
//     paged_prefill_tma_kernel, the flash forward's block (flash_attention.cu)
//     over the block table. A block of 384 threads: one producer warp (its
//     warpgroup gives its registers away, setmaxnreg 40 / 232) and two
//     consumer warpgroups that run wgmma.
//     - Work tiles: `rows` chunk queries of one query head (64 or 128, from
//       paged_prefill_plan on the host, shapes only): 128 rows give a
//       warpgroup 64 each, both over every key tile (the flash forward's
//       split); 64 rows give both warpgroups the same rows, warpgroup w the
//       key tiles i = w, w + 2, ..., merged at the end in shared memory in
//       that fixed order (two calls give equal bits). The plan takes 64
//       when twice the 128-row tiles still fit one block an SM: serve's
//       chunk (B 1, C 256, 32 heads) has 64 tiles of 128 rows on 132 SMs,
//       so it runs 128 blocks of 64 rows instead. The grid is (q tiles,
//       N, B), the latest (heaviest) q tiles first.
//     - Each block reads start[b] and n_valid[b] on the device (the wrapper
//       never does: the serve loop calls it once a layer) and walks the key
//       tiles of 128 columns below kend = min(start + its last valid row +
//       1, MAXB * BS); a tile with no valid row (kend 0) stores zeros and
//       exits.
//     - The producer warp loads the work tile's Q once by TMA (a 4-D map
//       over (D, N, C, B), 64-row boxes a panel), then streams each key
//       tile through a ring of stages (3 at D 128, 4 below: 224 KB of
//       shared memory at D 128) on mbarriers: lane j reads the table entry
//       of box j of the tile and issues one TMA box a panel of K and of V,
//       `box_rows` rows of one KV head of that page (box_rows = gcd(BS,
//       128), a multiple of 8) from 4-D maps over the layer's pools (D, K,
//       BS, NB) with the panel's swizzle (128 B at 64 columns). A box of a
//       multiple of 8 rows is whole swizzle atoms, so pages land in the
//       layout the wgmma descriptors read; lane 0 arrives with the bytes of
//       the boxes that hold a written key.
//     - Consumers: S = Q K^T by wgmma SS, an exp2 softmax in the
//       accumulator's layout (a tile whose pairs are all visible takes one
//       FFMA and one ex2 an element; others select the invisible ones to
//       -inf), O += P V by wgmma RS; then the epilogue writes o = O / l (0
//       for a key-less row) by TMA store from the Q tile's shared memory.
//     Trouble spots, resolved:
//     1. NaN residue (scratch page 0, stale table entries, the tail of the
//        last page): K residue is selected out of S, never masked by an
//        add (the visibility of row c is column <= min(start + c, kend -
//        1), and nothing for a pad row c >= n_valid); V rows of the last
//        key tile past kend are zeroed in shared memory before P V (0 *
//        NaN = NaN); boxes and table entries at or past kend are never
//        read, so no page at or past ceil(kend / BS) is dereferenced.
//     2. Page sizes: BS a multiple of 8 goes by TMA in boxes of gcd(BS,
//        128) rows (8 at BS 24, 16 at BS 16, 128 at BS 256); pages of any
//        other size are copied by the producer warp's lanes with plain
//        16-byte loads of the written rows, written at their swizzled
//        offsets (swizzle_offset), then fence.proxy.async before the
//        stage's arrive.
//     3. Registers and memory: D 128 holds one 128-row Q buffer and 3
//        stages (1024 + 32 KB + 3 x 64 KB); the 64-row merge goes through
//        the stage of warpgroup 1's last tile, which no later tile reuses.
//        Consumers stay within 232 registers (ptxas -v).
//     4. Shared file: #2's maps (no swizzle, whole rows) and these (panels,
//        swizzled) are other keys of hopper.cuh's map cache; #2's code is
//        untouched.
//     5. Ragged batches: each block reads its own row's start and
//        n_valid; any start works (the boxes follow the table column by
//        column); a GQA query head reads KV head n / G through the maps.
//     fp32 (and 16-bit D outside {16, 32, 64, 128}): paged_prefill_kernel,
//     16 rows per block on the fp32 CUDA cores (one warp-shuffle reduction
//     per (query, key) pair), which keeps fp32 within 2e-5 of the plain
//     version.

#include "decode_split.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// ---------------------------------------------------------------------------
// decode: paged_split_kernel
// ---------------------------------------------------------------------------
namespace sk = split_kv;

struct PagedArgs {
  const void* q;
  const void* kp;        // the pools, read by the plain-load route
  const void* vp;
  const int* bt;         // (R, MAXB)
  const int* lengths;    // (R,)
  const float* alibi;    // (N,) or null
  void* out;
  int N, K, D, BS, MAXB;
  int splits, stages;
  int unit_pages;        // pages of a unit: 32 / BS below 32 rows, else 1
  int box_rows;          // rows of a TMA box (and of a page's share of a
                         // stage): min(BS, 32)
  int tile_bytes;        // one K (V) tile in shared memory, 128-aligned
  int region_bytes;      // the ring, or the block merge once it is drained
  int tma;               // pages by TMA (else plain loads)
  float scale;
};

// The pages [p0, p1) of split `split` of a row of `len` keys: the row's
// units (unit_pages pages each, the last one cut at the row's last page)
// in runs of ceil(units / splits), split i taking the i-th run.
// ops/paged_decode_attention.py split_pages repeats this arithmetic.
__device__ __forceinline__ void split_pages(int len, int BS, int UP,
                                            int splits, int split, int& p0,
                                            int& p1) {
  const int npages = (len + BS - 1) / BS;
  const int units = (npages + UP - 1) / UP;
  const int per = (units + splits - 1) / splits;
  const int u0 = min(split * per, units);
  p0 = min(u0 * UP, npages);
  p1 = min(min(u0 + per, units) * UP, npages);
}

// grid (splits * R * K) in clusters of `splits` along x, block
// sk::kThreads; shared memory as decode_split.cuh lays it out. SUB lanes
// hold one key, NI dims each; MAXG >= G.
template <typename T, int NI, int SUB, int MAXG>
__global__ void __launch_bounds__(sk::kThreads)
paged_split_kernel(const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const PagedArgs a) {
  constexpr int kTile = sk::kTile;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) sk::Smem<SUB, MAXG> sm;

  const int S = a.splits, D = a.D, K = a.K, BS = a.BS, G = a.N / a.K;
  const int split = blockIdx.x % S, pair = blockIdx.x / S;
  const int row = pair / K, kh = pair % K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const sk::Layout lay = sk::layout(smem_raw, a.region_bytes, S, G, D);
  sk::start(sm, a.stages, S, split, G, D);

  if (warp == sk::kConsumerWarps) {
    // ---------------- producer warp ----------------
    const int len = max(0, min(__ldg(a.lengths + row), a.MAXB * BS));
    const int UP = a.unit_pages, BR = a.box_rows;
    int p0, p1;
    split_pages(len, BS, UP, S, split, p0, p1);
    const int* tab = a.bt + (int64_t)row * a.MAXB;
    const T* kpool = static_cast<const T*>(a.kp);
    const T* vpool = static_cast<const T*>(a.vp);
    const bool bias = a.alibi != nullptr;
    const int stage_rows = UP * BS;        // BS >= 32: a page's rows
    const int batch = (32 / UP) * UP;      // pages of one table read
    const uint32_t box_bytes = (uint32_t)(BR * D * (int)sizeof(T));
    sk::Producer ring{sm.full, sm.empty, sm.live, a.stages};
    for (int pb = p0; pb < p1; pb += batch) {
      const int pe = min(pb + batch, p1);
      // the table entries of pages pb .. pe - 1, one a lane
      const int page = pb + lane < pe ? __ldg(tab + pb + lane) : 0;
      for (int pu = pb; pu < pe; pu += UP) {
        const int nb = min(UP, pe - pu);   // pages of this unit
        // a unit is one stage, or (BS > 32) one stage a 32-row tile
        for (int r0 = 0; r0 < stage_rows; r0 += kTile) {
          const int col0 = pu * BS + r0;
          const int n = min(min(stage_rows - r0, kTile), len - col0);
          if (n <= 0) break;               // past the row's last key
          ring.claim();
          const int slot = ring.slot;
          sm.kpos[slot][lane] = bias ? (float)(col0 + lane) : 0.f;
          if (lane == 0)
            sm.live[slot] = n >= kTile ? 0xffffffffu : (1u << n) - 1u;
          T* ks = reinterpret_cast<T*>(lay.region
                                       + (size_t)slot * 2 * a.tile_bytes);
          T* vs = reinterpret_cast<T*>(lay.region
                                       + (size_t)slot * 2 * a.tile_bytes
                                       + a.tile_bytes);
          if (!a.tma) {
            // plain loads of the live rows (the rest keep stale bytes; the
            // consumers select them out)
            for (int j = 0; j < n; ++j) {
              const int pg = __shfl_sync(0xffffffffu, page,
                                         pu - pb + j / BR);
              const int64_t o =
                  (((int64_t)pg * BS + r0 + j % BR) * K + kh) * D;
              for (int d = lane; d < D; d += 32) {
                ks[j * D + d] = kpool[o + d];
                vs[j * D + d] = vpool[o + d];
              }
            }
          }
          __syncwarp();  // the lanes' stage writes, ordered before the arrive
          if (a.tma) {
            if (lane == 0)
              mbar_expect_tx(&sm.full[slot], 2u * (uint32_t)nb * box_bytes);
            __syncwarp();
            // lane i < nb: the box of the unit's page i
            const int pg = __shfl_sync(0xffffffffu, page,
                                       pu - pb + min(lane, nb - 1));
            if (lane < nb) {
              tma_load_4d(ks + lane * BR * D, &kmap, 0, kh, r0, pg,
                          &sm.full[slot]);
              tma_load_4d(vs + lane * BR * D, &vmap, 0, kh, r0, pg,
                          &sm.full[slot]);
            }
          } else if (lane == 0) {
            mbar_arrive(&sm.full[slot]);
          }
          ring.advance();
        }
      }
    }
    ring.finish(lane, S);
    return;
  }

  const int64_t head = (int64_t)row * a.N + kh * G;   // first query head
  sk::consume<T, NI, SUB, MAXG>(
      sm, lay, a.stages, a.tile_bytes, static_cast<const T*>(a.q) + head * D,
      a.alibi != nullptr ? a.alibi + kh * G : nullptr, a.scale, G, D, S,
      split, static_cast<T*>(a.out) + head * D);
}

// ---------------------------------------------------------------------------
// chunked prefill: grid (B * K, ceil(G * C / 16)), block 128 threads. Block
// rows r = g * C + c of KV head kh; query (b, c) of head kh * G + g sits at
// position start[b] + c when c < n_valid[b], else it is a pad (no keys).
// ---------------------------------------------------------------------------
template <typename T, int NI>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                     const T* __restrict__ vp, const int* __restrict__ bt,
                     const int* __restrict__ start,
                     const int* __restrict__ n_valid,
                     const float* __restrict__ alibi, T* __restrict__ out,
                     int C, int N, int K, int D, int BS, int MAXB,
                     float scale) {
  constexpr int RPW = 4;                  // query rows per warp
  constexpr int QT = RPW * kWarps;        // query rows per block
  constexpr int KT = NI <= 4 ? 32 : 16;   // keys per shared-memory tile
  constexpr int DM = NI * 32;
  constexpr int CH = 16 / (int)sizeof(T);  // elements per 16-byte load
  __shared__ __align__(16) float ks[KT][DM];
  __shared__ __align__(16) float vs[KT][DM];
  __shared__ int64_t koff[KT];

  const int b = blockIdx.x / K, kh = blockIdx.x % K;
  const int G = N / K, GC = G * C;
  const int st = start[b], nv = n_valid[b];
  const int* tab = bt + (int64_t)b * MAXB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile0 = blockIdx.y * QT;

  // the block's last visible key position (every thread computes it)
  int maxq = -1;
  for (int rr = 0; rr < QT; ++rr) {
    const int r = tile0 + rr;
    if (r < GC && r % C < nv) maxq = max(maxq, st + r % C);
  }
  maxq = min(maxq, MAXB * BS - 1);

  float qr[RPW][NI], acc[RPW][NI], m[RPW], l[RPW], slope[RPW];
  int qpos[RPW];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = tile0 + warp * RPW + rr;
    const int g = r / C, c = r % C;
    const bool live = r < GC && c < nv;
    qpos[rr] = live ? st + c : -1;
    const int64_t qo = (((int64_t)b * C + c) * N + kh * G + g) * D;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      qr[rr][i] = (live && d < D) ? to_f(q[qo + d]) * scale : 0.f;
      acc[rr][i] = 0.f;
    }
    m[rr] = kNegInf;
    l[rr] = 0.f;
    slope[rr] = (r < GC && alibi != nullptr) ? alibi[kh * G + g] : 0.f;
  }

  for (int t0 = 0; t0 <= maxq; t0 += KT) {
    __syncthreads();  // the previous tile is consumed
    if (threadIdx.x < KT) {
      const int col = t0 + threadIdx.x;
      koff[threadIdx.x] =
          col <= maxq
              ? (((int64_t)tab[col / BS] * BS + col % BS) * K + kh) * D
              : -1;
    }
    __syncthreads();
    if (D % CH == 0) {
      // 16-byte vectors: CH elements per thread per step
      for (int e = threadIdx.x; e < KT * (DM / CH); e += kThreads) {
        const int j = e / (DM / CH), d = (e % (DM / CH)) * CH;
        const int64_t o = koff[j];
        float kf[CH], vf[CH];
        if (o >= 0 && d < D) {
          const uint4 rk = __ldg(reinterpret_cast<const uint4*>(kp + o + d));
          const uint4 rv = __ldg(reinterpret_cast<const uint4*>(vp + o + d));
          const T* ek = reinterpret_cast<const T*>(&rk);
          const T* ev = reinterpret_cast<const T*>(&rv);
#pragma unroll
          for (int c = 0; c < CH; ++c) {
            kf[c] = to_f(ek[c]);
            vf[c] = to_f(ev[c]);
          }
        } else {
#pragma unroll
          for (int c = 0; c < CH; ++c) kf[c] = vf[c] = 0.f;
        }
#pragma unroll
        for (int c = 0; c < CH; c += 4) {
          *reinterpret_cast<float4*>(&ks[j][d + c]) =
              make_float4(kf[c], kf[c + 1], kf[c + 2], kf[c + 3]);
          *reinterpret_cast<float4*>(&vs[j][d + c]) =
              make_float4(vf[c], vf[c + 1], vf[c + 2], vf[c + 3]);
        }
      }
    } else {
      for (int e = threadIdx.x; e < KT * DM; e += kThreads) {
        const int j = e / DM, d = e % DM;
        const int64_t o = koff[j];
        const bool ok = o >= 0 && d < D;
        ks[j][d] = ok ? to_f(kp[o + d]) : 0.f;
        vs[j][d] = ok ? to_f(vp[o + d]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int qp = qpos[rr];
      if (qp < t0) continue;  // warp-uniform: no visible key in this tile
      float s[KT];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < NI; ++i) dot += qr[rr][i] * ks[j][lane + 32 * i];
        dot = warp_sum(dot) + slope[rr] * (float)(t0 + j);
        s[j] = (t0 + j <= qp) ? dot : kNegInf;
        mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m[rr], mx);
      const float corr = expf(m[rr] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        s[j] = (t0 + j <= qp) ? expf(s[j] - m_new) : 0.f;
        psum += s[j];
      }
      l[rr] = l[rr] * corr + psum;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        float a = acc[rr][i] * corr;
#pragma unroll
        for (int j = 0; j < KT; ++j)
          if (t0 + j <= qp) a += s[j] * vs[j][lane + 32 * i];
        acc[rr][i] = a;
      }
      m[rr] = m_new;
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = tile0 + warp * RPW + rr;
    if (r >= GC) continue;
    const int g = r / C, c = r % C;
    const int64_t oo = (((int64_t)b * C + c) * N + kh * G + g) * D;
    const float inv = l[rr] > 0.f ? 1.f / l[rr] : 0.f;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (d < D) out[oo + d] = from_f<T>(acc[rr][i] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// chunked prefill on the tensor cores: paged_prefill_tma_kernel (bf16 /
// fp16, D in {16, 32, 64, 128}); see the note at the top
// ---------------------------------------------------------------------------
__device__ __forceinline__ float neg_infinity() {
  return -__int_as_float(0x7f800000);
}

namespace pf {

constexpr int kKeys = 128;                   // keys of a stage (a key tile)
constexpr int kConsumers = 256;              // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;   // and a producer warpgroup
// registers a thread after setmaxnreg: 2 x 128 x 232 + 128 x 40 <= 64 K
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;

template <int D>
struct Cfg {
  static constexpr int P = D < 64 ? D : 64;    // columns of a panel
  static constexpr int SW = 2 * P;             // bytes of a panel row
  static constexpr int NP = D / P;             // panels
  static constexpr int QT = 128;               // rows of the Q buffer
  static constexpr int STAGES = D == 128 ? 3 : 4;
  static constexpr int QB = QT * D * 2;        // bytes of the Q buffer
  static constexpr int KVB = kKeys * D * 2;    // bytes of a stage's K (V)
  // the Q buffer and the stages' K and V tiles (1024-byte multiples), and
  // room to align the base to 1024
  static constexpr int SMEM = 1024 + QB + STAGES * 2 * KVB;
};

struct Args {
  const void* kp;        // the pools, read by the plain-load route
  const void* vp;
  const int* bt;         // (B, MAXB)
  const int* start;      // (B,)
  const int* n_valid;    // (B,)
  const float* alibi;    // (N,) or null
  int C, N, K, BS, MAXB;
  int rows;              // query rows of a work tile: 128 or 64
  int box_rows;          // rows of a K / V box, 0: plain loads
  float scale;
};

// The key columns [0, kend) that q tile qt (rows c0 .. c0 + rows - 1 of
// the chunk) of a row at `start` with `nv` valid queries sees: up to its
// last valid query's position, within the table's T columns.
// ops/paged_decode_attention.py prefill_keys repeats this arithmetic.
__device__ __forceinline__ int tile_keys(int start, int nv, int C, int rows,
                                         int qt, int T) {
  const int c0 = qt * rows;
  const int last = min(c0 + rows, min(max(nv, 0), C)) - 1;
  return last < c0 ? 0 : max(0, min(start + last + 1, T));
}

}  // namespace pf

// Grid (ceil(C / rows), N, B), the latest q tiles first; block pf::kThreads,
// dynamic shared memory pf::Cfg<D>::SMEM. Maps: q and out (D, N, C, B) in
// boxes of (P, 1, 64, 1); k and v the pools (D, K, BS, NB) in boxes of
// (P, 1, box_rows, 1) (unused with box_rows 0); all four head_map's.
template <typename T, int D>
__global__ void __launch_bounds__(pf::kThreads, 1)
paged_prefill_tma_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap omap,
                         const pf::Args a) {
  using C = pf::Cfg<D>;
  constexpr int P = C::P, SW = C::SW, QT = C::QT, ST = C::STAGES;
  constexpr int KT = pf::kKeys;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[ST], empty[ST];
  uint8_t* qbuf = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* kvs = qbuf + C::QB;   // stage s: K at kvs + s 2 KVB, then V

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the warpgroup as a value the compiler sees is warp-uniform (one lane's,
  // shuffled): wgmma under a branch it cannot prove uniform is serialized
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int qt = (int)(gridDim.x - 1 - blockIdx.x);
  const int n = blockIdx.y, b = blockIdx.z;
  const int G = a.N / a.K, kh = n / G;
  const int c0 = qt * a.rows;
  const bool split = a.rows == 64;   // both warpgroups on the same rows
  // the row's start and valid queries, and the tile's keys: the same in
  // every lane (shuffled, so the compiler sees uniform loop bounds)
  const int st = __shfl_sync(0xffffffffu, __ldg(a.start + b), 0);
  const int nv = __shfl_sync(
      0xffffffffu, min(max(__ldg(a.n_valid + b), 0), a.C), 0);
  const int kend = pf::tile_keys(st, nv, a.C, a.rows, qt, a.MAXB * a.BS);
  const int nt = (kend + KT - 1) / KT;   // key tiles

  if (tid == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      // a stage is released by every consumer warp that reads it
      mbar_init(&empty[s], (split ? 128 : pf::kConsumers) / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == pf::kConsumers / 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(pf::kProducerRegs));
    if (warp != pf::kConsumers / 32 || nt == 0) return;
    if (lane == 0) {
      // 64-row boxes that hold a row before C (the second half of a
      // ragged last 128-row tile may lie wholly past C: never loaded nor
      // stored)
      const int qh = min(a.rows / 64, (a.C - c0 + 63) / 64);
      mbar_expect_tx(&q_full, C::NP * qh * 64 * SW);
      for (int p = 0; p < C::NP; ++p)
        for (int h = 0; h < qh; ++h)
          tma_load_4d(qbuf + p * QT * SW + h * 64 * SW, &qmap, p * P, n,
                      c0 + 64 * h, b, &q_full);
    }
    const int* tab = a.bt + (int64_t)b * a.MAXB;
    const int BS = a.BS, br = a.box_rows;
    for (int i = 0; i < nt; ++i) {
      const int s = i % ST, t0 = i * KT;
      if (i >= ST) mbar_wait(&empty[s], (i / ST - 1) & 1);
      uint8_t* kd = kvs + s * 2 * C::KVB;
      if (br > 0) {
        // lane j: box j of the tile (columns t0 + j br ..), one page's
        // rows; only boxes that hold a written key are read
        const int live = min(KT / br, (kend - t0 + br - 1) / br);
        const int col = t0 + lane * br;
        const int page = lane < live ? __ldg(tab + col / BS) : 0;
        if (lane == 0)
          mbar_expect_tx(&full[s], 2u * (uint32_t)(live * C::NP * br * SW));
        __syncwarp();
        if (lane < live) {
          for (int p = 0; p < C::NP; ++p) {
            tma_load_4d(kd + p * KT * SW + lane * br * SW, &kmap, p * P, kh,
                        col % BS, page, &full[s]);
            tma_load_4d(kd + C::KVB + p * KT * SW + lane * br * SW, &vmap,
                        p * P, kh, col % BS, page, &full[s]);
          }
        }
      } else {
        // pages no map takes: the written rows by plain 16-byte loads, at
        // the offsets the panels' swizzle gives them
        const T* kpool = static_cast<const T*>(a.kp);
        const T* vpool = static_cast<const T*>(a.vp);
        constexpr int CPR = D / 8, CPP = SW / 16;   // chunks a row, a panel
        const int nrows = min(KT, kend - t0);
        for (int e = lane; e < nrows * CPR; e += 32) {
          const int r = e / CPR, c = e % CPR, cl = t0 + r;
          const int64_t o =
              (((int64_t)__ldg(tab + cl / BS) * BS + cl % BS) * a.K + kh) *
                  D + c * 8;
          const int sa = (c / CPP) * KT * SW +
                         swizzle_offset(r * SW + (c % CPP) * 16, SW);
          *reinterpret_cast<uint4*>(kd + sa) =
              __ldg(reinterpret_cast<const uint4*>(kpool + o));
          *reinterpret_cast<uint4*>(kd + C::KVB + sa) =
              __ldg(reinterpret_cast<const uint4*>(vpool + o));
        }
        fence_proxy_async();   // the rows, visible to wgmma
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[s]);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(pf::kConsumerRegs));

  const int ctid = tid & 127, wi = warp & 3, g = lane >> 2, t = lane & 3;
  const int rl0 = split ? 0 : 64 * wg;   // the warpgroup's first Q row
  const int wrow0 = c0 + rl0;            // ... as a chunk query
  const float scale2 = a.scale * kLog2e;
  const float slope2 = a.alibi != nullptr ? a.alibi[n] * kLog2e : 0.f;
  // full tiles may take the max of the raw scores
  const bool plain = a.alibi == nullptr && a.scale > 0.f;
  // every row of the warpgroup a valid query
  const bool rows_valid = wrow0 + 64 <= nv;
  // the last key column each of this thread's two rows sees (-1: a pad row)
  int lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wrow0 + 16 * wi + g + 8 * h;
    lim[h] = r < nv ? min(st + r, kend - 1) : -1;
  }
  const int first = split ? wg : 0, step = split ? 2 : 1;

  float o[D / 2], m[2], l[2], s[KT / 2];
  uint32_t pa[KT / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  m[0] = m[1] = neg_infinity();
  l[0] = l[1] = 0.f;

  // K-major descriptor of k16 step kk of a tile of `rows` rows, from row r0
  auto kdesc = [&](const uint8_t* tile, int rows, int r0, int kk) {
    return wgmma_desc<SW>(tile + (kk * 16 / P) * rows * SW + r0 * SW +
                              (kk * 16 % P) * 2,
                          16, 8 * SW);
  };

  if (first < nt) mbar_wait(&q_full, 0);
  for (int i = first; i < nt; i += step) {
    const int sg = i % ST, t0 = i * KT;
    mbar_wait(&full[sg], (i / ST) & 1);
    const uint8_t* kt = kvs + sg * 2 * C::KVB;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<T, KT>::template ss<0, 0>(s, kdesc(qbuf, QT, rl0, kk),
                                      kdesc(kt, KT, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    if (t0 + KT > kend) {
      // the last key tile: V rows of columns >= kend to zero (boxes not
      // loaded, or the last page's unwritten tail: 0 * NaN = NaN), by the
      // warpgroups that read the stage (split: this one, all rows; else
      // each its half), 16 bytes a thread (the swizzle permutes bytes
      // within a row)
      uint8_t* vt = kvs + sg * 2 * C::KVB + C::KVB;
      constexpr int CH = SW / 16;   // 16-byte chunks of a panel row
      const int r0 = split ? 0 : wg * (KT / 2), nr = split ? KT : KT / 2;
      const int dead = max(0, kend - t0 - r0);   // rows of r0.. to keep
      for (int e = dead * C::NP * CH + ctid; e < nr * C::NP * CH; e += 128) {
        const int r = r0 + e / (C::NP * CH), c = e % (C::NP * CH);
        *reinterpret_cast<uint4*>(vt + (c / CH) * KT * SW + r * SW +
                                  (c % CH) * 16) = make_uint4(0u, 0u, 0u, 0u);
      }
      fence_proxy_async();
      if (split) named_barrier(2 + wg, 128);
      else named_barrier(1, pf::kConsumers);
    }

    // s -> p = 2^(s scale log2 e + slope log2 e column - m); m, l updated;
    // corr the factor of O. Element e of s: row h = e / 2 % 2, column 8
    // (e / 4) + 2 t + e % 2 of the tile.
    float corr[2], mx[2] = {neg_infinity(), neg_infinity()};
    const bool whole = __shfl_sync(
        0xffffffffu, (int)(plain && rows_valid && t0 + KT <= kend &&
                           t0 + KT - 1 <= st + wrow0), 0) != 0;
    if (whole) {
#pragma unroll
      for (int e = 0; e < KT / 2; ++e)
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float mn = fmaxf(m[h], mx[h] * scale2);
        corr[h] = fast_exp2(m[h] - mn);
        m[h] = mn;
      }
#pragma unroll
      for (int e = 0; e < KT / 2; ++e)
        s[e] = fast_exp2(fmaf(s[e], scale2, -m[(e >> 1) & 1]));
    } else {
      // column 2 t + c of the tile is visible to row h iff c <= lr[h];
      // the others are selected to -inf (their K rows may be anything)
      int lr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) lr[h] = lim[h] - t0 - 2 * t;
      const float sb = slope2 * (float)(t0 + 2 * t);
#pragma unroll
      for (int e = 0; e < KT / 2; ++e) {
        const int h = (e >> 1) & 1, c = 8 * (e >> 2) + (e & 1);
        s[e] = c <= lr[h] ? fmaf(s[e], scale2, fmaf(slope2, (float)c, sb))
                          : neg_infinity();
        mx[h] = fmaxf(mx[h], s[e]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float mn = fmaxf(m[h], mx[h]);
        // a row that has seen no key yet: subtract 0, so -inf - (-inf)
        // never makes NaN (2^-inf = 0)
        const float mu = mn == neg_infinity() ? 0.f : mn;
        corr[h] = fast_exp2(m[h] - mu);
        m[h] = mn;
        mx[h] = mu;
      }
#pragma unroll
      for (int e = 0; e < KT / 2; ++e) s[e] = fast_exp2(s[e] - mx[(e >> 1) & 1]);
    }
    float rs[2] = {0.f, 0.f};  // this thread's columns; quad sums at the end
#pragma unroll
    for (int e = 0; e < KT / 2; ++e) rs[(e >> 1) & 1] += s[e];
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + rs[h];
#pragma unroll
    for (int i2 = 0; i2 < D / 2; ++i2) o[i2] *= corr[(i2 >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pa[kk][j] = Mma<T>::pack(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);

    // O += P V (V MN-major through the transpose bit)
    const uint8_t* vt = kt + C::KVB;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
      Wgmma<T, D>::template rs<1>(
          o, pa[kk], wgmma_desc<SW>(vt + kk * 16 * SW, KT * SW, 8 * SW), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    if (lane == 0) mbar_arrive(&empty[sg]);
  }

  if (split) {
    // warpgroup 1's (m, l, O) into the stage of its last key tile (no
    // later tile reuses it), merged by warpgroup 0: the same rows in the
    // same register layout, so thread ctid reads what thread ctid wrote
    if (nt < 2) {
      if (wg == 1) return;           // it took no key tile
    } else {
      float* mb = reinterpret_cast<float*>(
          kvs + ((nt - 1) % 2 == 1 ? nt - 1 : nt - 2) % ST * 2 * C::KVB);
      if (wg == 1) {
#pragma unroll
        for (int i2 = 0; i2 < D / 2; ++i2) mb[i2 * 128 + ctid] = o[i2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mb[(D / 2 + h) * 128 + ctid] = m[h];
          mb[(D / 2 + 2 + h) * 128 + ctid] = l[h];
        }
      }
      named_barrier(6, pf::kConsumers);
      if (wg == 1) return;
      float f0[2], f1[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m1 = mb[(D / 2 + h) * 128 + ctid];
        const float mn = fmaxf(m[h], m1);
        const float mu = mn == neg_infinity() ? 0.f : mn;
        f0[h] = fast_exp2(m[h] - mu);
        f1[h] = fast_exp2(m1 - mu);
        l[h] = l[h] * f0[h] + mb[(D / 2 + 2 + h) * 128 + ctid] * f1[h];
        m[h] = mn;
      }
#pragma unroll
      for (int i2 = 0; i2 < D / 2; ++i2)
        o[i2] = o[i2] * f0[(i2 >> 1) & 1] +
                mb[i2 * 128 + ctid] * f1[(i2 >> 1) & 1];
    }
  }

  // o = O / l in the input type, into this warpgroup's rows of the Q tile
  // (every S product that reads them is done), swizzled as the output's
  // map; then one TMA store a panel
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = l[h] > 0.f ? 1.f / l[h] : 0.f;
  }
#pragma unroll
  for (int i2 = 0; i2 < D / 2; i2 += 2) {
    const int h = (i2 >> 1) & 1, r = rl0 + 16 * wi + g + 8 * h;
    const int col = 8 * (i2 >> 2) + 2 * t;
    const int ad = r * SW + (col % P) * 2;
    *reinterpret_cast<uint32_t*>(qbuf + (col / P) * QT * SW +
                                 swizzle_offset(ad, SW)) =
        Mma<T>::pack(o[i2] * inv[h], o[i2 + 1] * inv[h]);
  }
  fence_proxy_async();
  named_barrier(4 + wg, 128);
  if (ctid == 0 && wrow0 < a.C) {
    for (int p = 0; p < C::NP; ++p)
      tma_store_4d(&omap, qbuf + p * QT * SW + rl0 * SW, p * P, n, wrow0, b);
    bulk_commit();
    bulk_wait<0>();
  }
}

// The 4-D map of a (NB, BS, K, D) pool in boxes of (D, 1, min(BS, 32), 1):
// one KV head's rows of a page, dense in shared memory (no swizzle), zeros
// past the page's last row; from the cache of tensor_map (the serve loop
// calls each layer's pools again every step).
template <typename T>
cudaError_t pool_map(CUtensorMap* map, const void* p, int NB, int BS, int K,
                     int D, int box_rows) {
  const cuuint64_t isz = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)K, (cuuint64_t)BS,
                              (cuuint64_t)NB};
  const cuuint64_t strides[3] = {D * isz, (cuuint64_t)K * D * isz,
                                 (cuuint64_t)BS * K * D * isz};
  const cuuint32_t box[4] = {(cuuint32_t)D, 1, (cuuint32_t)box_rows, 1};
  return tensor_map(map, map_type<T>(), 4, p, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_NONE,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
}

template <typename T, int NI, int SUB, int MAXG>
struct PagedLaunch {
  static cudaError_t run(PagedArgs a, int R, int NB, cudaStream_t st) {
    constexpr int NSW = sk::kConsumerWarps * (32 / SUB);
    static int smem_set = 48 * 1024;   // per instantiation: opt in above it
    const int G = a.N / a.K, isz = (int)sizeof(T);
    CUtensorMap km, vm;
    std::memset(&km, 0, sizeof(km));
    std::memset(&vm, 0, sizeof(vm));
    // a box lands on 128 bytes of shared memory: the second page of a
    // stage too
    a.tma = (a.D * isz) % 16 == 0
            && (a.unit_pages == 1 || (a.box_rows * a.D * isz) % 128 == 0);
    if (a.tma) {
      cudaError_t e = pool_map<T>(&km, a.kp, NB, a.BS, a.K, a.D,
                                  a.box_rows);
      if (e == cudaSuccess)
        e = pool_map<T>(&vm, a.vp, NB, a.BS, a.K, a.D, a.box_rows);
      if (e != cudaSuccess) return e;
    }
    a.tile_bytes = (sk::kTile * a.D * isz + 127) & ~127;
    a.region_bytes = sk::region_bytes(a.stages, a.tile_bytes, NSW, G,
                                      NI * SUB);
    return sk::launch(paged_split_kernel<T, NI, SUB, MAXG>, smem_set,
                      a.splits * R * a.K, a.splits,
                      sk::smem_bytes(a.region_bytes, a.splits, G, a.D), st,
                      km, vm, a);
  }
};

// The prefill kernel's launch (16-bit, D in {16, 32, 64, 128}): q and out
// maps in 64-row boxes of P columns, and with box_rows > 0 the pools' maps
// (head_map over (NB, BS, K, D): one panel of box_rows rows of one KV head
// of a page a box, swizzled as the wgmma descriptors read it; other keys of
// the map cache than pool_map's).
template <typename T, int D>
cudaError_t prefill_tma(cudaStream_t st, const void* q, void* out,
                        const pf::Args& a, int B, int NB) {
  using C = pf::Cfg<D>;
  CUtensorMap qm, om, km, vm;
  std::memset(&km, 0, sizeof(km));
  std::memset(&vm, 0, sizeof(vm));
  cudaError_t e = head_map<T>(&qm, q, B, a.C, a.N, D, C::P, 64);
  if (e == cudaSuccess) e = head_map<T>(&om, out, B, a.C, a.N, D, C::P, 64);
  if (e == cudaSuccess && a.box_rows > 0)
    e = head_map<T>(&km, a.kp, NB, a.BS, a.K, D, C::P, a.box_rows);
  if (e == cudaSuccess && a.box_rows > 0)
    e = head_map<T>(&vm, a.vp, NB, a.BS, a.K, D, C::P, a.box_rows);
  if (e != cudaSuccess) return e;
  auto kern = paged_prefill_tma_kernel<T, D>;
  static bool smem_set = false;   // per instantiation: above 48 KB, opt in
  if (!smem_set) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const dim3 grid((unsigned)((a.C + a.rows - 1) / a.rows), (unsigned)a.N,
                  (unsigned)B);
  kern<<<grid, pf::kThreads, C::SMEM, st>>>(qm, km, vm, om, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t prefill_d(cudaStream_t st, const void* q, const void* kp,
                      const void* vp, const int* bt, const int* start,
                      const int* n_valid, const float* alibi, void* out,
                      int B, int C, int N, int K, int D, int BS, int MAXB,
                      int NB, float scale, int rows, int box_rows) {
  if constexpr (sizeof(T) == 2) {
    if (D == 16 || D == 32 || D == 64 || D == 128) {
      if ((rows != 64 && rows != 128) || box_rows < 0 ||
          (box_rows > 0 && (box_rows % 8 || BS % box_rows ||
                            pf::kKeys % box_rows)))
        return cudaErrorInvalidValue;
      const pf::Args a = {kp, vp, bt, start, n_valid, alibi, C, N, K, BS,
                          MAXB, rows, box_rows, scale};
      if (D == 16) return prefill_tma<T, 16>(st, q, out, a, B, NB);
      if (D == 32) return prefill_tma<T, 32>(st, q, out, a, B, NB);
      if (D == 64) return prefill_tma<T, 64>(st, q, out, a, B, NB);
      return prefill_tma<T, 128>(st, q, out, a, B, NB);
    }
  }
  const dim3 grid((unsigned)(B * K), (unsigned)(((N / K) * C + 15) / 16));
#define DSTT_PREFILL(NI)                                                   \
  paged_prefill_kernel<T, NI><<<grid, kThreads, 0, st>>>(                  \
      (const T*)q, (const T*)kp, (const T*)vp, bt, start, n_valid, alibi, \
      (T*)out, C, N, K, D, BS, MAXB, scale)
  if (D <= 32) DSTT_PREFILL(1);
  else if (D <= 64) DSTT_PREFILL(2);
  else if (D <= 128) DSTT_PREFILL(4);
  else DSTT_PREFILL(8);
#undef DSTT_PREFILL
  return cudaGetLastError();
}

}  // namespace

// The wrapper (ops/paged_decode_attention.py) checks every shape, dtype,
// alignment and contiguity; these entry points assume N % K == 0, N / K <=
// 8, D <= 256, 16-byte aligned q / pools. dtype: 0 = float32, 1 =
// bfloat16, 2 = float16. alibi: (N,) fp32 or null. Both return the CUDA
// error of the launch.

// decode: NB pool blocks; splits (1, 2, 4 or 8) and stages (2..8) from
// paged_split_plan
extern "C" int dstt_paged_decode(const void* q, const void* kp,
                                 const void* vp, const int* bt,
                                 const int* lengths, const float* alibi,
                                 void* out, int R, int N, int K, int D,
                                 int BS, int MAXB, int NB, float scale,
                                 int dtype, int splits, int stages,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (R <= 0 || K <= 0) return (int)cudaGetLastError();
  if (splits < 1 || splits > sk::kMaxSplits || (splits & (splits - 1))
      || stages < 2 || stages > sk::kMaxStages || N % K
      || N / K > sk::kMaxGroup || D < 1 || D > 256 || BS < 1 || MAXB < 0
      || NB < 1)
    return (int)cudaErrorInvalidValue;
  PagedArgs a = {};
  a.q = q;
  a.kp = kp;
  a.vp = vp;
  a.bt = bt;
  a.lengths = lengths;
  a.alibi = alibi;
  a.out = out;
  a.N = N;
  a.K = K;
  a.D = D;
  a.BS = BS;
  a.MAXB = MAXB;
  a.splits = splits;
  a.stages = stages;
  a.unit_pages = BS < sk::kTile ? sk::kTile / BS : 1;
  a.box_rows = BS < sk::kTile ? BS : sk::kTile;
  a.scale = scale;
  const int G = N / K;
  if (dtype == 0)
    return (int)sk::dispatch<PagedLaunch, float>(D, G, a, R, NB, st);
  if (dtype == 1)
    return (int)sk::dispatch<PagedLaunch, __nv_bfloat16>(D, G, a, R, NB, st);
  return (int)sk::dispatch<PagedLaunch, __half>(D, G, a, R, NB, st);
}

// prefill: NB pool blocks; rows (64 or 128) and box_rows (0: plain loads)
// from paged_prefill_plan, read by the 16-bit D 16 / 32 / 64 / 128 route
extern "C" int dstt_paged_prefill(const void* q, const void* kp,
                                  const void* vp, const int* bt,
                                  const int* start, const int* n_valid,
                                  const float* alibi, void* out, int B,
                                  int C, int N, int K, int D, int BS,
                                  int MAXB, int NB, float scale, int dtype,
                                  int rows, int box_rows, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || C <= 0) return (int)cudaGetLastError();
  if (K <= 0 || N % K || N / K > sk::kMaxGroup || D < 1 || D > 256 ||
      BS < 1 || MAXB < 0 || NB < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (dtype == 0)
    e = prefill_d<float>(st, q, kp, vp, bt, start, n_valid, alibi, out, B, C, N, K, D, BS, MAXB, NB, scale, rows, box_rows);
  else if (dtype == 1)
    e = prefill_d<__nv_bfloat16>(st, q, kp, vp, bt, start, n_valid, alibi, out, B, C, N, K, D, BS, MAXB, NB, scale, rows, box_rows);
  else
    e = prefill_d<__half>(st, q, kp, vp, bt, start, n_valid, alibi, out, B, C, N, K, D, BS, MAXB, NB, scale, rows, box_rows);
  return (int)e;
}
