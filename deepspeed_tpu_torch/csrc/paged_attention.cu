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
//     flops per visible (query, key) pair over the bf16 tensor-core peak;
//     at C = 256 with up to 768 keys of context the bytes bound it. Design,
//     bf16/fp16 with D in {16, 32, 64, 128}: mma.sync m16n8k16 tiles (see
//     paged_prefill_mma_kernel), one block per (batch row, KV head, 64 of
//     the G * C query rows), K/V tiles of 64 keys staged once in shared
//     memory for 64 query rows, only tiles up to the block's last visible
//     position visited. fp32 (and other D): the same blocking with 16 rows
//     per block on the fp32 CUDA cores (one warp-shuffle reduction per
//     (query, key) pair), which keeps fp32 within 2e-5 of the plain
//     version. wgmma / TMA pipelines are for a later change.

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
// chunked prefill on the tensor cores (bf16 / fp16, D in {16, 32, 64, 128}):
// grid (B * K, ceil(G * C / 64)), block 4 warps, each warp 16 query rows.
// S = Q K^T and O += P V are mma.sync m16n8k16 with fp32 accumulation; K/V
// tiles of 64 keys are staged in shared memory (rows padded by 8 elements so
// ldmatrix is conflict-free), Q fragments come straight from global memory,
// the online softmax runs on the S fragments in fp32, and P is rounded to
// the input type for the P V product (as the plain version rounds p).
// Keys past the block's last visible position are staged as zeros, and a
// key past a query's position gets p = 0 by select: the only v rows a
// product touches are written positions or zeros.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_prefill_mma_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                         const T* __restrict__ vp, const int* __restrict__ bt,
                         const int* __restrict__ start,
                         const int* __restrict__ n_valid,
                         const float* __restrict__ alibi, T* __restrict__ out,
                         int C, int N, int K, int BS, int MAXB, float scale) {
  constexpr int KT = 64;          // keys per shared-memory tile
  constexpr int QT = 16 * kWarps; // query rows per block
  constexpr int DP = D + 8;       // padded row: conflict-free ldmatrix
  constexpr int NT = KT / 8;      // 8-key tiles of S
  constexpr int DT = D / 8;       // 8-dim tiles of O
  constexpr int KD = D / 16;      // 16-dim steps of Q K^T
  constexpr int CH = 8;           // 16-bit elements per 16-byte load
  __shared__ __align__(16) T ks[KT][DP];
  __shared__ __align__(16) T vs[KT][DP];
  __shared__ int64_t koff[KT];

  const int b = blockIdx.x / K, kh = blockIdx.x % K;
  const int G = N / K, GC = G * C;
  const int st = start[b], nv = n_valid[b];
  const int* tab = bt + (int64_t)b * MAXB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int tile0 = blockIdx.y * QT;

  int maxq = -1;  // the block's last visible key position
  for (int rr = 0; rr < QT; ++rr) {
    const int r = tile0 + rr;
    if (r < GC && r % C < nv) maxq = max(maxq, st + r % C);
  }
  maxq = min(maxq, MAXB * BS - 1);

  // this thread's two query rows: grp and grp + 8 of the warp's 16
  int qpos[2];
  bool rv[2];
  int64_t qo[2];
  float slope[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = tile0 + warp * 16 + grp + 8 * h;
    const int g = r / C, c = r % C;
    rv[h] = r < GC;
    qpos[h] = (rv[h] && c < nv) ? st + c : -1;
    qo[h] = rv[h] ? (((int64_t)b * C + c) * N + kh * G + g) * D : 0;
    slope[h] = (rv[h] && alibi != nullptr) ? alibi[kh * G + g] : 0.f;
  }
  int wmax = max(qpos[0], qpos[1]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    wmax = max(wmax, __shfl_xor_sync(0xffffffffu, wmax, o));

  uint32_t qa[KD][4];  // A fragments of Q (row grp / grp + 8, dims tig * 2)
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int h = j & 1, d = kk * 16 + tig * 2 + (j >> 1) * 8;
      qa[kk][j] = rv[h] ? *reinterpret_cast<const uint32_t*>(q + qo[h] + d)
                        : 0u;
    }

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

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
    for (int e = threadIdx.x; e < KT * (D / CH); e += kThreads) {
      const int j = e / (D / CH), d = (e % (D / CH)) * CH;
      const int64_t off = koff[j];
      uint4 rk = make_uint4(0u, 0u, 0u, 0u), rvv = rk;
      if (off >= 0) {
        rk = __ldg(reinterpret_cast<const uint4*>(kp + off + d));
        rvv = __ldg(reinterpret_cast<const uint4*>(vp + off + d));
      }
      *reinterpret_cast<uint4*>(&ks[j][d]) = rk;
      *reinterpret_cast<uint4*>(&vs[j][d]) = rvv;
    }
    __syncthreads();
    if (wmax < t0) continue;  // warp-uniform: no visible key in this tile

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, &ks[(np * 2 + (mi >> 1)) * 8 + mr][kk * 16 + (mi & 1) * 8]);
        Mma<T>::run(s[np * 2], qa[kk], kb[0], kb[1]);
        Mma<T>::run(s[np * 2 + 1], qa[kk], kb[2], kb[3]);
      }

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int h = j >> 1, col = t0 + nt * 8 + tig * 2 + (j & 1);
        const float v = col <= qpos[h]
                            ? s[nt][j] * scale + slope[h] * (float)col
                            : kNegInf;
        s[nt][j] = v;
        mx[h] = fmaxf(mx[h], v);
      }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int h = j >> 1, col = t0 + nt * 8 + tig * 2 + (j & 1);
        const float p = col <= qpos[h] ? expf(s[nt][j] - m[h]) : 0.f;
        s[nt][j] = p;
        psum[h] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 1);
      psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 2);
      l[h] = l[h] * corr[h] + psum[h];
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= corr[0];
      o[dt][1] *= corr[0];
      o[dt][2] *= corr[1];
      o[dt][3] *= corr[1];
    }
#pragma unroll
    for (int k2 = 0; k2 < KT / 16; ++k2) {
      const uint32_t pa[4] = {
          Mma<T>::pack(s[2 * k2][0], s[2 * k2][1]),
          Mma<T>::pack(s[2 * k2][2], s[2 * k2][3]),
          Mma<T>::pack(s[2 * k2 + 1][0], s[2 * k2 + 1][1]),
          Mma<T>::pack(s[2 * k2 + 1][2], s[2 * k2 + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vb[4];
        ldsm_x4_t(vb, &vs[k2 * 16 + (mi & 1) * 8 + mr][(dp * 2 + (mi >> 1)) * 8]);
        Mma<T>::run(o[dp * 2], pa, vb[0], vb[1]);
        Mma<T>::run(o[dp * 2 + 1], pa, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!rv[h]) continue;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(out + qo[h] + dt * 8 + tig * 2) =
          Mma<T>::pack(o[dt][2 * h] * inv, o[dt][2 * h + 1] * inv);
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

template <typename T>
void prefill_d(dim3 grid, cudaStream_t st, const void* q, const void* kp,
               const void* vp, const int* bt, const int* start,
               const int* n_valid, const float* alibi, void* out, int C,
               int N, int K, int D, int BS, int MAXB, float scale) {
#define DSTT_PREFILL(NI)                                                   \
  paged_prefill_kernel<T, NI><<<grid, kThreads, 0, st>>>(                  \
      (const T*)q, (const T*)kp, (const T*)vp, bt, start, n_valid, alibi, \
      (T*)out, C, N, K, D, BS, MAXB, scale)
  if constexpr (sizeof(T) == 2) {
    if (D == 16 || D == 32 || D == 64 || D == 128) {
      const dim3 mgrid(grid.x, (unsigned)(((N / K) * C + 16 * kWarps - 1)
                                          / (16 * kWarps)));
#define DSTT_PREFILL_MMA(DD)                                                \
  paged_prefill_mma_kernel<T, DD><<<mgrid, kThreads, 0, st>>>(             \
      (const T*)q, (const T*)kp, (const T*)vp, bt, start, n_valid, alibi, \
      (T*)out, C, N, K, BS, MAXB, scale)
      if (D == 16) DSTT_PREFILL_MMA(16);
      else if (D == 32) DSTT_PREFILL_MMA(32);
      else if (D == 64) DSTT_PREFILL_MMA(64);
      else DSTT_PREFILL_MMA(128);
#undef DSTT_PREFILL_MMA
      return;
    }
  }
  if (D <= 32) DSTT_PREFILL(1);
  else if (D <= 64) DSTT_PREFILL(2);
  else if (D <= 128) DSTT_PREFILL(4);
  else DSTT_PREFILL(8);
#undef DSTT_PREFILL
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

extern "C" int dstt_paged_prefill(const void* q, const void* kp,
                                  const void* vp, const int* bt,
                                  const int* start, const int* n_valid,
                                  const float* alibi, void* out, int B,
                                  int C, int N, int K, int D, int BS,
                                  int MAXB, float scale, int dtype,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B > 0 && C > 0) {
    const int GC = (N / K) * C;
    dim3 grid((unsigned)(B * K), (unsigned)((GC + 15) / 16));
    if (dtype == 0)
      prefill_d<float>(grid, st, q, kp, vp, bt, start, n_valid, alibi, out, C, N, K, D, BS, MAXB, scale);
    else if (dtype == 1)
      prefill_d<__nv_bfloat16>(grid, st, q, kp, vp, bt, start, n_valid, alibi, out, C, N, K, D, BS, MAXB, scale);
    else
      prefill_d<__half>(grid, st, q, kp, vp, bt, start, n_valid, alibi, out, C, N, K, D, BS, MAXB, scale);
  }
  return (int)cudaGetLastError();
}
