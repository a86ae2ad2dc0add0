// Flash-attention forward for Hopper (sm_90a) over dense q / k / v.
//
// Replaces: deepspeed_tpu/ops/flash_attention.py flash_attention -> _fwd /
//   _fwd_kernel (pallas_call at :135), forward only; flash_attention_bwd.cu
//   reads the lse written here.
//
// What it computes (the Pallas kernel's convention, flash_attention.py:75-96):
// q (B, S, N, D), k / v (B, T, K, D), query head n reads KV head n / G
// (G = N / K, no head repeat). Query row i sees key column j when j < T,
// mask[b, j] != 0 (mask optional, (B, T) key padding) and, if causal,
// j <= i: 0-based, NOT end-aligned, so a static prefill of S queries over a
// T_max arena is exact. Score s = (q . k) * scale + slope[n] * j in fp32
// (alibi optional); online softmax in fp32; o = sum_j p_j v_j / l and
// lse = m + log l ((B, N, S) fp32, optional). A row with no visible key
// writes o = 0 and lse = -inf. Masked keys are SELECTED out (p = 0 by a
// predicate) and their V rows are zeroed before any product, so a stale or
// non-finite arena slot never reaches the output (0 * NaN); the ragged S
// and T edges are masked here, nothing is padded.
//
// Bound on the H100: the larger of its bytes (q, o, and K / V of the key
// columns some query sees, over 3.35 TB/s) and its 4 D operations per
// visible (query, key) pair and head over the bf16 tensor-core peak (989
// TFLOP/s). At the three paths' shapes:
// * train (OPT-1.3B: B 4, S = T 1024, 32 heads of 64, causal): 67.2 M
//   visible pairs, 1.72e10 operations (17.4 us) and 67 MB of q, k, v, o
//   (20.0 us): 0.020 ms, bytes;
// * generate's static prefill (llama-7b: 8 rows of 64..500 tokens, S 512
//   over a 1024-column arena, 32 heads of 128, causal): 0.029 ms, bytes;
// * the SD v1.5 VAE mid block (B 4, S = T 4096, one head of 512,
//   non-causal): 1.37e11 operations, 0.139 ms, operations.
//
// Design, bf16 / fp16 with D in {16, 32, 64, 128} or 256 < D <= 512 with D
// % 8 == 0: flash_fwd_tma_kernel, after FA3's forward. A block of 384
// threads: two consumer warpgroups (the wgmma M of 64 rows each) and a
// producer warpgroup whose registers go to them (setmaxnreg 40 / 232).
// * One producer warp reads the key-padding mask of each key tile (a
//   ballot a 32 keys: the tile's live bits, key < the work tile's last
//   visible column and mask != 0), skips a tile no query of the work tile
//   sees, and one lane issues TMA: the work tile's Q once, then each live
//   key tile's K and V through a ring of STAGES stages counted on mbarriers
//   (full: bytes arrived, with the tile's first key and live bits beside
//   the stage; empty: every consumer warp done), then an end marker.
// * Tiles sit in shared memory in panels of P = min(D, 64) columns, each
//   row one swizzle span (2 P bytes, 128 B at P 64), as the 4-D TMA maps
//   over (B, S | T, N | K, D) write them and the wgmma descriptors read them:
//   the GQA head, the batch stride and the ragged S and T edges (zeros
//   loaded past them) come from the maps.
// * Per key tile: S = Q K^T by wgmma SS (both K-major) in fp32; the softmax
//   in the accumulator's layout (two rows a thread, quad shuffles for the
//   row max, the row sum kept per thread until the end), p = 2^(s * scale *
//   log2 e - m) by ex2.approx, alibi's slope folded in with log2 e;
//   predicates (live bit, causal) only on tiles that hold a dead key or
//   straddle the warpgroup's diagonal, full tiles take one FFMA and one ex2
//   an element; O += P V by wgmma RS (P packed in registers into the 16-bit
//   A fragment, V MN-major through the transpose bit); then the stage is
//   released. On a tile with a dead key the consumers first zero its V rows
//   in shared memory (fence.proxy.async, a named barrier of both
//   warpgroups).
// * Epilogue: o = O / l (0 for a key-less row) in the input type into the
//   Q tile's shared memory, swizzled as the output's TMA map, and one TMA
//   store a panel (rows past S and columns past D are not written); lse =
//   (m + log2 l) ln 2, -inf for a key-less row.
// * D <= 128: work tiles of 128 query rows, 64 a warpgroup, each over all of
//   D; key tiles of 128. D <= 64: persistent, one block an SM over pairs of
//   work tiles of one head (q tiles nqt - 1 and 0, nqt - 2 and 1, ...: equal
//   causal work a pair, and the blocks in flight share few heads' K / V in
//   L2), two Q buffers, 4 stages. D 128 (224 KB: one Q buffer, 3 stages):
//   one block a work tile, q tiles of a head consecutive and the heaviest
//   first.
// * 256 < D <= 512: one block a work tile of 64 rows, Q loaded once (8
//   panels, 64 KB); O split by columns, each warpgroup 64 x 256 fp32 in
//   registers (128 a thread); each takes the partial S over its own 256 dims
//   and the two partials meet in shared memory (double buffered, one named
//   barrier a tile): a + b == b + a, so both hold the same S, max, sum and P
//   bit for bit, and neither waits for the other's softmax, where one
//   warpgroup computing all of S and sharing P would do twice the other's
//   products. Key tiles of 32 through 2 stages (Q 64 KB + 2 x 64 KB of K / V
//   + 32 KB of partials). Columns past D load as zeros (panels wholly past D
//   are zeroed once) and are not stored.
// What still holds them back (H100 80GB HBM3, 700 W; PERF.md): at the
// train shape (~0.067 ms, ~35 key tiles of a block an SM) a key tile takes
// ~2 us where its products need ~0.56: its softmax's 16 K ex2, at the SM's 16
// a clock, take as long as the products, beside the bf16 packs, the maxima
// and sums, and the diagonal tile takes the predicated path. FA3's
// intra-warpgroup overlap of softmax and products, its pingpong schedule of
// the two warpgroups, and a head-grouped work order (L2) were each built and
// timed at the train shape and moved nothing. At D 512 each 64-row q tile
// reads all of K and V again (8 MB a batch row at the VAE shape, ~2.1 GB
// from L2 a call): a cluster multicast of K / V would halve it.
//
// fp32, and 16-bit D outside those sets: flash_fwd_kernel, 16 query rows
// per block (8 at D > 256) on the CUDA cores (a warp-shuffle reduction per
// (query, key) pair, 8-32 key tiles staged in shared memory), which keeps
// fp32 within 2e-5 of the plain version; also every dtype when T = 0.

#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float neg_infinity() { return -__int_as_float(0x7f800000); }

// ---------------------------------------------------------------------------
// TMA + wgmma path (16-bit): D the dims staged, kWide for 256 < D <= 512
// (staged as 512, zeros past the real D)
// ---------------------------------------------------------------------------

constexpr int kConsumers = 256;                   // two consumer warpgroups
constexpr int kFwdThreads = kConsumers + 128;     // and a producer warpgroup
// registers a thread after setmaxnreg: 2 x 128 x 232 + 128 x 40 <= 64 K
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;

template <int D_, bool kWide>
struct Fwd {
  static constexpr int D = D_;
  static constexpr int P = D < 64 ? D : 64;        // columns of a panel
  static constexpr int SW = 2 * P;                 // bytes of a panel row
  static constexpr int NP = D / P;                 // panels
  static constexpr int QT = kWide ? 64 : 128;      // query rows of a work tile
  static constexpr int KT = kWide ? 32 : 128;      // keys of a key tile
  // one block an SM walking work tiles (a second Q buffer: the next work
  // tile's Q loads while this one runs), or one block a work tile
  static constexpr bool kPersistent = !kWide && D <= 64;
  static constexpr int QBUF = kPersistent ? 2 : 1; // Q tiles in shared memory
  static constexpr int STAGES = kWide ? 2 : D == 128 ? 3 : 4;  // K / V ring
  static constexpr int WD = kWide ? D / 2 : D;     // dims of a warpgroup's S, O
  static constexpr int ON = WD < 128 ? WD : 128;   // O columns of one PV wgmma
  static constexpr int NO = WD / ON;               // PV wgmmas a k16 step
  static constexpr int QB = QT * D * 2;            // bytes of a Q tile
  static constexpr int KVB = KT * D * 2;           // bytes of a K (V) tile
  static constexpr int XF = kWide ? 64 * KT : 0;   // floats of an S partial
  // the Q tiles, the stages' K and V tiles (all 1024-byte multiples), two
  // S partials of each warpgroup, and room to align the base to 1024
  static constexpr int SMEM =
      1024 + QBUF * QB + STAGES * 2 * KVB + 4 * XF * 4;
};

template <int KT>
struct TileFlags {
  int t0;                    // the key tile's first key; -1: end of work tile
  uint32_t live[KT / 32];    // bit c: key t0 + c may be seen
};

// A work tile: a q tile of one head and batch row.
struct Work {
  int q0, n, b;
};
// Work tile w of the persistent route: head by head, so the blocks in
// flight share the K / V of few heads in L2, and within a head in the order
// nqt - 1, 0, nqt - 2, 1, ...: a block takes two work tiles at a time, a
// heavy and a light one of equal causal work.
__device__ __forceinline__ Work work_tile(int w, int nqt, int QT, int N) {
  const int hb = w / nqt, p = w % nqt;
  const int qt = p % 2 == 0 ? nqt - 1 - p / 2 : p / 2;
  return {qt * QT, hb % N, hb / N};
}

// Grid: with kPersistent min(pairs of work tiles, SMs) (block u takes pairs
// u, u + gridDim.x, ...), else (q tiles, N, B), one block a work tile and
// the heaviest causal q tiles first; block kFwdThreads, dynamic shared
// memory Fwd::SMEM. Maps (head_map, panels of P columns): q and out
// (D, N, S, B) in boxes of (P, 1, 64, 1), k and v (D, K, T, B) in boxes of
// (P, 1, KT, 1); Dr: the real head_dim.
template <typename T, int D, bool kWide>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_tma_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap omap,
                     const int* __restrict__ mask,
                     const float* __restrict__ alibi, float* __restrict__ lse,
                     int B, int S, int Tk, int N, int K, int Dr, int causal,
                     float scale) {
  using C = Fwd<D, kWide>;
  constexpr int P = C::P, SW = C::SW, QT = C::QT, KT = C::KT;
  constexpr int ST = C::STAGES, QBUF = C::QBUF;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full[QBUF], q_empty[QBUF], full[ST],
      empty[ST];
  __shared__ TileFlags<KT> flags[ST];
  uint8_t* qbuf = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* kvs = qbuf + QBUF * C::QB;  // stage st: K at kvs + st 2 KVB, then V
  float* xs = reinterpret_cast<float*>(kvs + ST * 2 * C::KVB);

  const int G = N / K;
  const int nqt = (S + QT - 1) / QT, total = nqt * N * B;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the warpgroup as a value the compiler sees is warp-uniform (one lane's,
  // shuffled): wgmma under a branch it cannot prove uniform is serialized
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int np = kWide ? (Dr + P - 1) / P : C::NP;   // panels TMA loads
  // the block's work tile, without kPersistent
  const Work own = {(int)(gridDim.x - 1 - blockIdx.x) * QT, (int)blockIdx.y,
                    (int)blockIdx.z};

  if (tid == 0) {
    for (int i = 0; i < QBUF; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], kConsumers / 128);
    }
    for (int st = 0; st < ST; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumers / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers / 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (warp != kConsumers / 32) return;
    int it = 0;   // ring position, across work tiles
    auto produce = [&](const Work wk, int wt) {
      // its KV head, once: a division in the lane-0 branch below is not
      // hoisted and would lengthen each key tile's TMA issue
      const int kh = wk.n / G;
      // keys the work tile may see: causal rows stop at its last row
      const int kend = causal ? min(Tk, min(wk.q0 + QT, S)) : Tk;
      if (lane == 0) {
        const int qb = wt % QBUF;
        if (wt >= QBUF) mbar_wait(&q_empty[qb], (wt / QBUF - 1) & 1);
        // 64-row boxes that hold a row before S (the second warpgroup's
        // rows of a ragged last q tile may all be past S: never loaded
        // nor stored)
        const int qh = min(QT / 64, (S - wk.q0 + 63) / 64);
        mbar_expect_tx(&q_full[qb], np * qh * 64 * SW);
        uint8_t* qs = qbuf + qb * C::QB;
        for (int p = 0; p < np; ++p)
          for (int h = 0; h < qh; ++h)
            tma_load_4d(qs + p * QT * SW + h * 64 * SW, &qmap, p * P, wk.n,
                        wk.q0 + 64 * h, wk.b, &q_full[qb]);
      }
      for (int t0 = 0;; t0 += KT) {
        uint32_t live[KT / 32], any = 0;
        if (t0 < kend) {
#pragma unroll
          for (int w2 = 0; w2 < KT / 32; ++w2) {
            const int col = t0 + 32 * w2 + lane;
            live[w2] = __ballot_sync(
                0xffffffffu,
                col < kend && (mask == nullptr ||
                               mask[(int64_t)wk.b * Tk + col] != 0));
            any |= live[w2];
          }
          // warp-uniform: no query of the work tile sees this key tile
          if (any == 0) continue;
        }
        if (lane == 0) {
          const int st = it % ST;
          if (it >= ST) mbar_wait(&empty[st], (it / ST - 1) & 1);
          if (t0 < kend) {
            flags[st].t0 = t0;
#pragma unroll
            for (int w2 = 0; w2 < KT / 32; ++w2) flags[st].live[w2] = live[w2];
            mbar_expect_tx(&full[st], 2 * np * KT * SW);
            uint8_t* kd = kvs + st * 2 * C::KVB;
            for (int p = 0; p < np; ++p) {
              tma_load_4d(kd + p * KT * SW, &kmap, p * P, kh, t0, wk.b,
                          &full[st]);
              tma_load_4d(kd + C::KVB + p * KT * SW, &vmap, p * P, kh,
                          t0, wk.b, &full[st]);
            }
          } else {            // the end of the work tile's key tiles
            flags[st].t0 = -1;
            mbar_arrive(&full[st]);
          }
        }
        __syncwarp();
        ++it;
        if (t0 >= kend) break;
      }
    };
    if constexpr (C::kPersistent) {
      int wt = 0;
      for (int u = blockIdx.x; 2 * u < total; u += gridDim.x)
        for (int w = 2 * u; w < 2 * u + 2 && w < total; ++w)
          produce(work_tile(w, nqt, QT, N), wt++);
    } else {
      produce(own, 0);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));

  const int ctid = tid & 127, wi = warp & 3, g = lane >> 2, t = lane & 3;
  const int rl0 = kWide ? 0 : 64 * wg;     // the warpgroup's first row
  const int kfirst = kWide ? wg * (C::WD / 16) : 0;  // its first k16 step of S
  const int ocol0 = kWide ? wg * C::WD : 0;          // its first O column
  const float scale2 = scale * kLog2e;
  // full tiles may take the max of the raw scores
  const bool plain = alibi == nullptr && scale > 0.f;

  if (kWide && np < C::NP) {
    // panels wholly past D: zeros, once (TMA never writes them)
    for (int e = tid; e < (C::NP - np) * QT * SW / 16; e += kConsumers)
      reinterpret_cast<uint4*>(qbuf + np * QT * SW)[e] =
          make_uint4(0u, 0u, 0u, 0u);
    for (int st = 0; st < 2 * ST; ++st)
      for (int e = tid; e < (C::NP - np) * KT * SW / 16; e += kConsumers)
        reinterpret_cast<uint4*>(kvs + st * C::KVB + np * KT * SW)[e] =
            make_uint4(0u, 0u, 0u, 0u);
    fence_proxy_async();
    named_barrier(1, kConsumers);
  }

  float o[C::NO][C::ON / 2];
  float m[2], l[2];
  float s[KT / 2];
  uint32_t pa[KT / 16][4];
  const uint8_t* qs = qbuf;
  int row[2], wrow0 = 0;
  float slope2 = 0.f;

  // key tile it's first key (-1: end of the work tile), once its stage has
  // arrived
  auto fetch = [&](int it) {
    const int st = it % ST;
    mbar_wait(&full[st], (it / ST) & 1);
    return __shfl_sync(0xffffffffu, flags[st].t0, 0);
  };
  // K-major descriptor of k16 step kk of a tile of `rows` rows, from row r0
  auto kdesc = [&](const uint8_t* tile, int rows, int r0, int kk) {
    return wgmma_desc<SW>(tile + (kk * 16 / P) * rows * SW + r0 * SW +
                              (kk * 16 % P) * 2,
                          16, 8 * SW);
  };
  auto issue_s = [&](int it) {
    const uint8_t* kt = kvs + (it % ST) * 2 * C::KVB;
#pragma unroll
    for (int kk = 0; kk < C::WD / 16; ++kk)
      Wgmma<T, KT>::template ss<0, 0>(s, kdesc(qs, QT, rl0, kfirst + kk),
                                      kdesc(kt, KT, 0, kfirst + kk), kk > 0);
    wgmma_commit();
  };
  auto issue_pv = [&](int it) {
    const uint8_t* vt = kvs + (it % ST) * 2 * C::KVB + C::KVB;
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
      for (int c = 0; c < C::NO; ++c) {
        const int col = ocol0 + c * C::ON;
        Wgmma<T, C::ON>::template rs<1>(
            o[c], pa[kk],
            wgmma_desc<SW>(vt + (col / P) * KT * SW + kk * 16 * SW, KT * SW,
                           8 * SW),
            1);
      }
    wgmma_commit();
  };
  auto fence_o = [&]() {
#pragma unroll
    for (int c = 0; c < C::NO; ++c) fence_regs(o[c]);
  };
  auto release = [&](int it) {
    if (lane == 0) mbar_arrive(&empty[it % ST]);
  };
  // a key tile with a dead key: its V rows to zero (this warpgroup's half
  // of the rows, 16 bytes a thread; the swizzle permutes bytes within a row)
  auto prep_v = [&](int it) {
    const TileFlags<KT>& f = flags[it % ST];
    uint32_t all = ~0u;
#pragma unroll
    for (int w = 0; w < KT / 32; ++w) all &= f.live[w];
    if (__shfl_sync(0xffffffffu, (int)(all != ~0u), 0)) {
      uint8_t* vt = kvs + (it % ST) * 2 * C::KVB + C::KVB;
      constexpr int CH = SW / 16;  // 16-byte chunks of a panel row
      for (int e = ctid; e < KT / 2 * C::NP * CH; e += 128) {
        const int r = wg * (KT / 2) + e / (C::NP * CH), c = e % (C::NP * CH);
        if (!((f.live[r >> 5] >> (r & 31)) & 1u))
          *reinterpret_cast<uint4*>(vt + (c / CH) * KT * SW + r * SW +
                                    (c % CH) * 16) = make_uint4(0u, 0u, 0u, 0u);
      }
      fence_proxy_async();
      named_barrier(1, kConsumers);
    }
  };
  // the other warpgroup's partial S added to this one's (kWide); x counts
  // the exchanges, so each buffer is written again only after a barrier
  // that follows the other warpgroup's read of it
  auto exchange = [&](int x) {
    float* mine = xs + ((x & 1) * 2 + wg) * C::XF;
    const float* other = xs + ((x & 1) * 2 + (wg ^ 1)) * C::XF;
#pragma unroll
    for (int e = 0; e < KT / 2; e += 4)
      *reinterpret_cast<float4*>(mine + e * 128 + ctid * 4) =
          make_float4(s[e], s[e + 1], s[e + 2], s[e + 3]);
    named_barrier(2, kConsumers);
#pragma unroll
    for (int e = 0; e < KT / 2; e += 4) {
      const float4 x = *reinterpret_cast<const float4*>(other + e * 128 +
                                                        ctid * 4);
      s[e] += x.x;
      s[e + 1] += x.y;
      s[e + 2] += x.z;
      s[e + 3] += x.w;
    }
  };
  // s: scores of the key tile at t0 -> p = 2^(x - m) with x = s * scale *
  // log2 e + slope * log2 e * j (-inf where the pair is not visible); m, l
  // updated; corr: the factor of O. Element e of s: row h = e / 2 % 2,
  // column 8 (e / 4) + 2 t + e % 2 of the tile.
  auto softmax = [&](int it, int t0, float (&corr)[2]) {
    const uint32_t* lw = flags[it % ST].live;
    uint32_t all = ~0u;
#pragma unroll
    for (int w = 0; w < KT / 32; ++w) all &= lw[w];
    const bool whole =
        __shfl_sync(0xffffffffu, (int)(plain && all == ~0u &&
                                       (!causal || t0 + KT - 1 <= wrow0)),
                    0) != 0;
    float mx[2] = {neg_infinity(), neg_infinity()};
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
      uint32_t lt[KT / 32];
#pragma unroll
      for (int w = 0; w < KT / 32; ++w) lt[w] = lw[w] >> (2 * t);
      // column 2 t + c0 is visible to row h iff its live bit is set and
      // c0 <= lim[h]
      int lim[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        lim[h] = causal ? row[h] - t0 - 2 * t : KT;
      const float sb = slope2 * (float)(t0 + 2 * t);
#pragma unroll
      for (int e = 0; e < KT / 2; ++e) {
        const int h = (e >> 1) & 1, c0 = 8 * (e >> 2) + (e & 1);
        const bool vis = ((lt[c0 >> 5] >> (c0 & 31)) & 1u) && c0 <= lim[h];
        s[e] = vis ? fmaf(s[e], scale2, fmaf(slope2, (float)c0, sb))
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
    float rs[2] = {0.f, 0.f};  // this thread's columns; the quad sums at the end
#pragma unroll
    for (int e = 0; e < KT / 2; ++e) rs[(e >> 1) & 1] += s[e];
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + rs[h];
  };

  int it = 0;   // ring position, as the producer's
  auto consume = [&](const Work wk, int wt) {
    wrow0 = wk.q0 + rl0;
    row[0] = wrow0 + 16 * wi + g;
    row[1] = row[0] + 8;
    slope2 = alibi != nullptr ? alibi[wk.n] * kLog2e : 0.f;
#pragma unroll
    for (int c = 0; c < C::NO; ++c)
#pragma unroll
      for (int i = 0; i < C::ON / 2; ++i) o[c][i] = 0.f;
    m[0] = m[1] = neg_infinity();
    l[0] = l[1] = 0.f;
    const int qb = wt % QBUF;
    qs = qbuf + qb * C::QB;
    mbar_wait(&q_full[qb], (wt / QBUF) & 1);

    for (;; ++it) {
      const int t0 = fetch(it);
      if (t0 < 0) break;
      wgmma_fence();
      issue_s(it);
      wgmma_wait<0>();
      fence_regs(s);
      prep_v(it);
      if constexpr (kWide) exchange(it - wt);  // key tiles so far
      float corr[2];
      softmax(it, t0, corr);
#pragma unroll
      for (int c = 0; c < C::NO; ++c)
#pragma unroll
        for (int i = 0; i < C::ON / 2; ++i) o[c][i] *= corr[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pa[kk][j] = Mma<T>::pack(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
      wgmma_fence();
      issue_pv(it);
      wgmma_wait<0>();
      fence_o();
      fence_regs(pa);
      release(it);
    }
    release(it++);  // the end marker's stage

    // o = O / l in the input type, into this warpgroup's part of the Q tile
    // (its rows, or with kWide its panels: the S products that read them
    // are done), swizzled as the output's map; then one TMA store a panel
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      inv[h] = l[h] > 0.f ? 1.f / l[h] : 0.f;
    }
    uint8_t* os = qbuf + qb * C::QB;
#pragma unroll
    for (int c = 0; c < C::NO; ++c)
#pragma unroll
      for (int i = 0; i < C::ON / 2; i += 2) {
        const int h = (i >> 1) & 1, r = rl0 + 16 * wi + g + 8 * h;
        const int col = ocol0 + c * C::ON + 8 * (i >> 2) + 2 * t;
        const int a = r * SW + (col % P) * 2;
        *reinterpret_cast<uint32_t*>(os + (col / P) * QT * SW +
                                     swizzle_offset(a, SW)) =
            Mma<T>::pack(o[c][i] * inv[h], o[c][i + 1] * inv[h]);
      }
    fence_proxy_async();
    named_barrier(3 + wg, 128);
    if (ctid == 0) {
      if (wrow0 < S) {
        for (int p = ocol0 / P; p < (ocol0 + C::WD) / P && p < np; ++p)
          tma_store_4d(&omap, os + p * QT * SW + rl0 * SW, p * P, wk.n,
                       wrow0, wk.b);
        bulk_commit();
        bulk_wait_read<0>();  // the tile's shared memory is free again
      }
      mbar_arrive(&q_empty[qb]);
    }
    if (lse != nullptr && t == 0 && (!kWide || wg == 0)) {
      constexpr float kLn2 = 0.6931471805599453f;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (row[h] < S)
          lse[((int64_t)wk.b * N + wk.n) * S + row[h]] =
              l[h] > 0.f ? (m[h] + log2f(l[h])) * kLn2 : neg_infinity();
    }
  };
  if constexpr (C::kPersistent) {
    int wt = 0;
    for (int u = blockIdx.x; 2 * u < total; u += gridDim.x)
      for (int w = 2 * u; w < 2 * u + 2 && w < total; ++w)
        consume(work_tile(w, nqt, QT, N), wt++);
  } else {
    consume(own, 0);
  }
  if (ctid == 0) bulk_wait<0>();  // every store written
}

template <typename T, int D, bool kWide>
cudaError_t flash_tma(cudaStream_t st, const void* q, const void* k,
                      const void* v, const int* mask, const float* alibi,
                      void* out, float* lse, int B, int S, int Tk, int N,
                      int K, int Dr, int causal, float scale) {
  using C = Fwd<D, kWide>;
  CUtensorMap qm, km, vm, om;
  cudaError_t e = head_map<T>(&qm, q, B, S, N, Dr, C::P, 64);
  if (e == cudaSuccess) e = head_map<T>(&om, out, B, S, N, Dr, C::P, 64);
  if (e == cudaSuccess) e = head_map<T>(&km, k, B, Tk, K, Dr, C::P, C::KT);
  if (e == cudaSuccess) e = head_map<T>(&vm, v, B, Tk, K, Dr, C::P, C::KT);
  if (e != cudaSuccess) return e;
  auto kern = flash_fwd_tma_kernel<T, D, kWide>;
  static bool smem_set = false;   // per instantiation: above 48 KB, opt in
  if (!smem_set) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const int nqt = (S + C::QT - 1) / C::QT;
  dim3 grid((unsigned)nqt, (unsigned)N, (unsigned)B);
  if constexpr (C::kPersistent) {
    int dev = 0, sms = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    const int64_t pairs = ((int64_t)nqt * N * B + 1) / 2;
    grid = dim3((unsigned)(pairs < sms ? pairs : sms));
  }
  kern<<<grid, kFwdThreads, C::SMEM, st>>>(
      qm, km, vm, om, mask, alibi, lse, B, S, Tk, N, K, Dr, causal, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// CUDA-core path (fp32, and 16-bit rows of other D): grid (ceil(S / rows),
// N, B), block 4 warps of 4 query rows (2 at NI 16, D > 256); lane i holds
// dims i, i + 32, ...
// ---------------------------------------------------------------------------
template <int NI>
__host__ __device__ constexpr int fwd_rows() {
  return (NI >= 16 ? 2 : 4) * kWarps;
}

template <typename T, int NI>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ mask,
                 const float* __restrict__ alibi, T* __restrict__ out,
                 float* __restrict__ lse, int S, int Tk, int N, int K, int D,
                 int causal, float scale) {
  constexpr int QT = fwd_rows<NI>();      // query rows per block
  constexpr int RPW = QT / kWarps;        // query rows per warp
  // keys per shared-memory tile (K and V tiles within 48 KB)
  constexpr int KT = NI <= 4 ? 32 : NI <= 8 ? 16 : 8;
  constexpr int DM = NI * 32;
  __shared__ float ks[KT][DM];
  __shared__ float vs[KT][DM];
  __shared__ int kval[KT];

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int n = blockIdx.y, b = blockIdx.z;
  const int kh = n / (N / K);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = qt * QT;
  const int kend = causal ? min(Tk, min(q0 + QT, S)) : Tk;
  const float slope = alibi != nullptr ? alibi[n] : 0.f;
  const T* kb0 = k + ((int64_t)b * Tk * K + kh) * D;
  const T* vb0 = v + ((int64_t)b * Tk * K + kh) * D;

  float qr[RPW][NI], acc[RPW][NI], m[RPW], l[RPW];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = q0 + warp * RPW + rr;
    const int64_t qo = (((int64_t)b * S + r) * N + n) * D;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      qr[rr][i] = (r < S && d < D) ? to_f(q[qo + d]) * scale : 0.f;
      acc[rr][i] = 0.f;
    }
    m[rr] = kNegInf;
    l[rr] = 0.f;
  }

  for (int t0 = 0; t0 < kend; t0 += KT) {
    __syncthreads();  // the previous tile is consumed
    int live = 0;
    if (threadIdx.x < KT) {
      const int col = t0 + threadIdx.x;
      live = col < kend && (mask == nullptr || mask[(int64_t)b * Tk + col] != 0);
      kval[threadIdx.x] = live;
    }
    if (!__syncthreads_or(live)) continue;  // block-uniform: all keys masked
    for (int e = threadIdx.x; e < KT * DM; e += kThreads) {
      const int j = e / DM, d = e % DM;
      const bool ok = kval[j] && d < D;
      const int64_t off = (int64_t)(t0 + j) * K * D + d;
      ks[j][d] = ok ? to_f(kb0[off]) : 0.f;
      vs[j][d] = ok ? to_f(vb0[off]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = q0 + warp * RPW + rr;
      if (r >= S || (causal && r < t0)) continue;  // warp-uniform
      float s[KT];
      bool vis[KT];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < NI; ++i) dot += qr[rr][i] * ks[j][lane + 32 * i];
        dot = warp_sum(dot) + slope * (float)(t0 + j);
        vis[j] = kval[j] && (!causal || t0 + j <= r);
        s[j] = vis[j] ? dot : kNegInf;
        mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m[rr], mx);
      const float corr = expf(m[rr] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        s[j] = vis[j] ? expf(s[j] - m_new) : 0.f;
        psum += s[j];
      }
      l[rr] = l[rr] * corr + psum;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        float a = acc[rr][i] * corr;
#pragma unroll
        for (int j = 0; j < KT; ++j)
          if (vis[j]) a += s[j] * vs[j][lane + 32 * i];
        acc[rr][i] = a;
      }
      m[rr] = m_new;
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = q0 + warp * RPW + rr;
    if (r >= S) continue;
    const int64_t oo = (((int64_t)b * S + r) * N + n) * D;
    const float inv = l[rr] > 0.f ? 1.f / l[rr] : 0.f;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (d < D) out[oo + d] = from_f<T>(acc[rr][i] * inv);
    }
    if (lse != nullptr && lane == 0)
      lse[((int64_t)b * N + n) * S + r] =
          l[rr] > 0.f ? m[rr] + logf(l[rr]) : neg_infinity();
  }
}

template <typename T>
cudaError_t flash_d(cudaStream_t st, const void* q, const void* k,
                    const void* v, const int* mask, const float* alibi,
                    void* out, float* lse, int B, int S, int Tk, int N, int K,
                    int D, int causal, float scale) {
  if constexpr (sizeof(T) == 2) {
    if (Tk > 0) {
#define DSTT_FLASH_TMA(DD, WIDE)                                             \
  return flash_tma<T, DD, WIDE>(st, q, k, v, mask, alibi, out, lse, B, S,   \
                                Tk, N, K, D, causal, scale)
      if (D == 16) DSTT_FLASH_TMA(16, false);
      if (D == 32) DSTT_FLASH_TMA(32, false);
      if (D == 64) DSTT_FLASH_TMA(64, false);
      if (D == 128) DSTT_FLASH_TMA(128, false);
      if (D > 256 && D % 8 == 0) DSTT_FLASH_TMA(512, true);
#undef DSTT_FLASH_TMA
    }
  }
#define DSTT_FLASH(NI)                                                      \
  flash_fwd_kernel<T, NI><<<dim3((unsigned)((S + fwd_rows<NI>() - 1) /     \
                                            fwd_rows<NI>()),                \
                                 (unsigned)N, (unsigned)B),                 \
                            kThreads, 0, st>>>(                             \
      (const T*)q, (const T*)k, (const T*)v, mask, alibi, (T*)out, lse, S, \
      Tk, N, K, D, causal, scale)
  if (D <= 32) DSTT_FLASH(1);
  else if (D <= 64) DSTT_FLASH(2);
  else if (D <= 128) DSTT_FLASH(4);
  else if (D <= 256) DSTT_FLASH(8);
  else DSTT_FLASH(16);
#undef DSTT_FLASH
  return cudaGetLastError();
}

}  // namespace

// The wrapper (ops/flash_attention.py) checks every shape, dtype, alignment
// and contiguity; this entry point assumes N % K == 0, D <= 512 and
// 16-byte aligned q / k / v. dtype: 0 = float32, 1 = bfloat16, 2 =
// float16. mask: (B, T) int32 or null; alibi: (N,) fp32 or null; lse: (B,
// N, S) fp32 or null. Returns the first CUDA error of the launch (tensor
// maps included).
extern "C" int dstt_flash_fwd(const void* q, const void* k, const void* v,
                              const int* mask, const float* alibi, void* out,
                              float* lse, int B, int S, int T, int N, int K,
                              int D, int causal, float scale, int dtype,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || S <= 0 || N <= 0) return (int)cudaGetLastError();
  cudaError_t e;
  if (dtype == 0)
    e = flash_d<float>(st, q, k, v, mask, alibi, out, lse, B, S, T, N, K, D, causal, scale);
  else if (dtype == 1)
    e = flash_d<__nv_bfloat16>(st, q, k, v, mask, alibi, out, lse, B, S, T, N, K, D, causal, scale);
  else
    e = flash_d<__half>(st, q, k, v, mask, alibi, out, lse, B, S, T, N, K, D, causal, scale);
  return (int)e;
}
