// Block-sparse flash attention for Hopper (sm_90a): the forward, and the
// backward (dq, dk and dv in one call) over a tile plan.
//
// Replaces: deepspeed_tpu/ops/block_sparse_attention.py _sparse_fwd ->
//   _fwd_kernel (pallas_call at :196), and _sparse_bwd -> _bwd_dq_kernel
//   (pallas_call at :325) and _bwd_dkv_kernel (pallas_call at :360), which
//   the backward's fused pass replaces together.
//
// What it computes (the Pallas kernels' semantics): q / k / v / dout
// (B, S, N, D) in the model's layout, read through their strides (JAX
// transposes to (B, N, S, D) first), S a multiple of 128. The plan lists,
// per (head n, 128-row q-tile i), kcount[n][i] active k-tiles kidx[n][i][a]
// and the id mid[n][i][a] of each tile's token mask in a table of unique
// 128 x 128 masks (uint8, q-major: masks[m][row][col]); and the transposed
// lists qcount_t / qidx_t / mid_t (q-tiles per k-tile, pointing at the SAME
// q-major masks). Query row r sees key c when the tile's mask has
// (r % 128, c % 128) and, if causal, c <= r (on every visited tile).
//   forward:  s = (q . k) * scale in fp32, online softmax; o = sum p v / l,
//             lse = m + log l; a row that sees no key writes o = 0 and
//             lse = -inf (JAX: 0 and NEG_INF).
//   backward: from the forward's lse and delta = rowsum(dout * o),
//             p = visible ? exp(s - lse) : 0, ds = visible ? p (dout . v -
//             delta) : 0; dq = scale * sum ds k, dk = scale * sum ds^T q,
//             dv = sum p^T dout.
// p and ds are SELECTED to 0 where a pair is invisible (a key-less row has
// lse = -inf, where exp(s - lse) would be inf), so such a row contributes
// nothing anywhere and gets zero gradients. A block walks its list's true
// length: JAX's padded slots (k-tile 0 with the all-zero mask) add
// exp(-inf) = 0 there and are never visited here. There is no grid-step
// ceiling (JAX's MAX_GRID_STEPS is a limit of the TPU's scalar memory):
// each block reads its own list.
//
// Bounds on the H100 at the sparse_train shape (B 2, S 2048, 32 heads of
// 64, bf16) under DeepSpeed's Fixed layout (block 16, 4 local blocks, 1
// global, unidirectional: every causal 128-tile is active, 136 of 256 a
// head, but only 3.68e7 of the 1.43e8 pairs of those tiles are visible):
// the forward 4 D operations per visible pair; the backward 10 D (S^T,
// dP^T, dV, dK, dQ: five products of 2 D), 2.35e10 operations, 23.8 us at
// the bf16 tensor-core peak, against the bytes of q, k, v, o, dout and lse
// read once and dq, dk, dv written once, 134.7 MB, 40.2 us at 3.35 TB/s:
// bytes bound (chip_smoke.py's sparse cases count both from the plan).
//
// Forward, bf16 / fp16 with D in {16, 32, 64, 128}: sparse_fwd_tma_kernel,
// the flash forward's block (flash_attention.cu) over packed key groups.
// Under Fixed an off-diagonal tile holds 32 live keys of 128, so a kernel
// that visits whole tiles computes products and exp for 3.9x the visible
// pairs, and at D 64 a key tile's softmax sets the pace. So the host packs
// (TilePlan.stage_plan, once per plan): for each (head, q-tile) its list
// walked in order, each 16-key group of a tile that some row of the q-tile
// sees, 8 groups to a 128-key stage (Fixed at S 2048: 52 stages a head
// where 136 tiles were, 1.48x the visible pairs), with per slot the group's
// first key, mask id, column offset and a flag per 64-row half (0 no row
// sees it, 1 all pairs visible, 2 partial).
// * A producer warp (setmaxnreg 40 / 232) loads the work tile's Q once by
//   TMA, then for each stage lane l < 8 reads slot l, writes it into the
//   stage's work item and issues one TMA box of 16 keys a panel of K and of
//   V into rows 16 l..16 l + 15 of the stage (a 16-row box of SW-byte rows
//   is whole swizzle atoms, so packed rows keep the layout the wgmma
//   descriptors read); lane 0 arrives with the stage's bytes, and an end
//   item follows the last stage. Under causality a group past every row of
//   the tile is not loaded.
// * Two consumer warpgroups of 64 rows: S = Q K^T over the stage's 128
//   packed keys by wgmma SS; while it runs, each slot's visibility for the
//   thread's elements, from the flags, the query-major mask words rowbits
//   (partial slots only) and the slot's absolute keys (c <= row, only where
//   the slot straddles the warpgroup's diagonal); then an exp2 softmax in
//   the accumulator's layout (a stage whose 8 slots are all visible takes
//   one FFMA and one ex2 an element, others select invisible pairs to
//   -inf and skip the ex2 of slots no row sees), O += P V by wgmma RS. A
//   stage that no row of a warpgroup sees is skipped by it (uniformly).
// * A slot left empty in a stage's tail is never loaded; the V ring is
//   zeroed once, so it holds zeros or V rows loaded before, and p is
//   selected to 0 there.
// * Epilogue as the flash forward's: o = O / l by TMA store from the Q
//   tile's shared memory, lse = (m + log2 l) ln 2, o = 0 and lse = -inf for
//   a key-less row (every row of a q-tile whose list is empty).
// * D <= 64: persistent, one block an SM over the work tiles (q-tiles in
//   qorder, the heaviest first, each over every head and batch row), two Q
//   buffers, 4 stages; D 128 (224 KB: one Q buffer, 3 stages): one block a
//   work tile on a (N, B, q-tiles) grid, the heaviest q-tiles first.
// What holds it back (H100 80GB HBM3, 700 W; PERF.md): at the sparse_train
// shape under Fixed it takes ~0.070 ms (one block a work tile at D 64:
// 0.083), ~2.8 us a stage where the flash forward spends ~1.7 us a key
// tile at the same shape; where it goes is not located (the card's machine
// has no stall profiler). Trial builds of a fast softmax path that also
// takes stages with dead slots, and of a packing with the diagonal tile's
// groups first, each ran slower.
//
// Backward, bf16 / fp16 with D in {16, 32, 64, 128}: three launches, the
// design of the flash backward (flash_attention_bwd.cu), walking the
// plan's transposed lists.
// 1. flash_bwd_prologue_kernel (attention_bwd.cuh): delta (fp32) and
//    lse * log2(e) of every query row into 64-row stats tiles, and the fp32
//    dq accumulator (B, S, N, D) zeroed: one pass over o and dout, where
//    plain torch took four launches through fp32 copies.
// 2. sparse_bwd_kernel, KV-outer, one pass: grid (N, B, key tiles), the
//    key tile slowest and in the plan's order of falling list length
//    (korder), so the heaviest lists are dispatched first. Two consumer
//    warpgroups own 64 keys each and keep their dK / dV accumulators in
//    registers; one thread of a producer warpgroup (setmaxnreg 24 / 240)
//    issues TMA: the block's K and V tiles once, then for each q-tile of
//    the transposed list (qidx_t[n][j][0 .. qcount_t)) and each 64-row half
//    of it, Q, dO and the half's stats through a ring of kStages stages on
//    mbarriers. A half whose two mask quadrants are empty, or that lies
//    wholly above the causal diagonal, is never loaded. The producer
//    writes each half's work item (first row, mask id, the warpgroups'
//    flags) into its stage before the stage's barrier completes, and an
//    end item after the last, so the consumers read their walk from the
//    ring and not from the lists. Per half, each consumer warpgroup whose
//    keys see one of its rows:
//    * S^T = K Q^T and dP^T = V dO^T by wgmma SS (m64n64k16, K-major); for
//      D <= 64 issued while the previous half's dV, dK and dQ products run;
//    * P^T = exp2(s * scale * log2e - lse * log2e) and dS^T = P^T (dP^T -
//      delta) in fp32 registers;
//    * dV += P^T dO and dK += dS^T Q by wgmma RS from the packed registers;
//    * dS^T into swizzled shared memory.
//    A warpgroup whose 64 keys see none of the half's rows (an empty
//    quadrant, or every key past the half's last row) skips those
//    products, warpgroup-uniformly, and writes zeros for its dS^T rows.
//    Then both take dQ_part = dS K over the 128 keys, each for half of D,
//    and add it into the accumulator by TMA tensor reduce-add.
//    Masks: the host derives once per plan and device (TilePlan.
//    device_arrays) a flag per 64 x 64 quadrant of every mask (0 empty, 1
//    full, 2 partial) and, for partial quadrants, a key-major bit table:
//    bits[m][key][half] holds the 64 query rows of the half as one 64-bit
//    word, since the rows of S^T are keys. A thread loads its two keys'
//    words once a half, with no staging; predicates (mask bit, causality)
//    run only on partial quadrants and on quadrants that straddle the
//    diagonal, where p and ds are selected to 0.
// 3. flash_bwd_epilogue_kernel: dq = scale * accumulator, in the input
//    type.
// dk and dv are written once per key by their block, so they repeat bit
// for bit; dq's fp32 sums land in the order the reductions arrive, which
// may change from run to run (a few fp32 ulps before its one rounding).
// What still holds the pass back (not measured: the card's machine has no
// profiler of stalls): under Fixed, off-diagonal tiles hold 32 live keys
// of 128, so the pass does 3.9x the products of the visible pairs; the
// dQ parts of every half go through L2 as fp32 reductions; and at D 128
// shared memory holds no third stage of the ring.
//
// fp32, and 16-bit D outside {16, 32, 64, 128}: the same lists on the CUDA
// cores (16 rows or keys per block, one lane per dims d, d + 32, ...), the
// forward directly, the backward after the prologue's delta (B, N, S);
// fp32 stays within 2e-5 of the plain version.

#include "attention_bwd.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = kKeys;          // plan tile edge
constexpr int kTileElems = kTile * kTile;

__device__ __forceinline__ float neg_infinity() { return -__int_as_float(0x7f800000); }

// ---------------------------------------------------------------------------
// forward, TMA + wgmma path (16-bit, D in {16, 32, 64, 128}); see the note
// above
// ---------------------------------------------------------------------------

constexpr int kGroup = 16;                // keys of a packed group
constexpr int kSlots = kKeys / kGroup;    // groups of a stage
// registers a thread after setmaxnreg: 2 x 128 x 232 + 128 x 40 <= 64 K
constexpr int kFwdConsumerRegs = 232;
constexpr int kFwdProducerRegs = 40;

template <int D>
struct SpFwd {
  static constexpr int P = D < 64 ? D : 64;   // columns of a panel
  static constexpr int SW = 2 * P;            // bytes of a panel row
  static constexpr int NP = D / P;            // panels
  // one block an SM walking work tiles, with a second Q buffer (the next
  // tile's Q loads while this one runs), where shared memory holds it
  static constexpr bool kPersistent = D <= 64;
  static constexpr int QBUF = kPersistent ? 2 : 1;
  static constexpr int STAGES = D == 128 ? 3 : 4;   // K / V ring
  static constexpr int QB = kKeys * D * 2;          // bytes of a Q tile
  static constexpr int KVB = kKeys * D * 2;         // bytes of a stage's K (V)
  static constexpr int GB = kGroup * SW;            // a group's box in a panel
  // the Q tiles, the stages' K and V (all 1024-byte multiples), and room to
  // align the base to 1024
  static constexpr int SMEM = 1024 + QBUF * QB + STAGES * 2 * KVB;
};

// A work tile: 128 query rows (from i0) of head n, batch row b.
struct SpWork {
  int i0, n, b;
};
// Work tile w of the persistent route: the q-tiles in qorder (heaviest
// first), each over every (head, batch row); block u takes w = u, u +
// gridDim.x, ...
__device__ __forceinline__ SpWork sp_work(int w, const int* qorder, int N,
                                          int B) {
  const int r = w / (N * B), nb = w % (N * B);
  return {qorder[r] * kKeys, nb % N, nb / N};
}

// Grid: persistent min(work tiles, SMs), else (N, B, S / 128) with the
// q-tile qorder[blockIdx.z]; block kFusedThreads, dynamic shared memory
// SpFwd<D>::SMEM. Maps (head_map, panels of P columns): q and out (D, N, S,
// B) in boxes of (P, 1, 64, 1), k and v in boxes of (P, 1, kGroup, 1).
// slots (N, S / 128, SMAX, kSlots) int4: per slot (first key or -1, mask
// id, column offset in its tile, flags: bits 2 h..2 h + 1 of half h, 0 no
// row sees the group, 1 all pairs visible, 2 partial); scount (N, S / 128):
// stages a list; rowbits (U, 128, 2): bit c of rowbits[m][r][h] is mask m's
// (r, 64 h + c).
template <typename T, int D>
__global__ void __launch_bounds__(kFusedThreads, 1)
sparse_fwd_tma_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap omap,
                      const int4* __restrict__ slots,
                      const int* __restrict__ scount,
                      const unsigned long long* __restrict__ rowbits,
                      const int* __restrict__ qorder, float* __restrict__ lse,
                      int B, int S, int N, int SMAX, int causal,
                      float scale) {
  using C = SpFwd<D>;
  constexpr int P = C::P, SW = C::SW, ST = C::STAGES, QBUF = C::QBUF;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full[QBUF], q_empty[QBUF], full[ST],
      empty[ST];
  // each stage's work item: its slots; bit h of wstate: a row of half h
  // sees a key of the stage (-1: the end of the work tile)
  __shared__ int4 work[ST][kSlots];
  __shared__ int wstate[ST];
  uint8_t* qbuf = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* kvs = qbuf + QBUF * C::QB;  // stage st: K at kvs + st 2 KVB, then V

  const int nq = S / kKeys, total = nq * N * B;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the warpgroup as a value the compiler sees is warp-uniform (one lane's,
  // shuffled): wgmma under a branch it cannot prove uniform is serialized
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const SpWork own = {qorder[blockIdx.z] * kKeys, (int)blockIdx.x,
                      (int)blockIdx.y};

  // The V ring zeroed once: a slot left empty in a stage is never loaded,
  // so its rows hold zeros or V rows this block loaded before (finite
  // wherever the plain version is finite), which p = 0 multiplies.
  for (int e = tid; e < ST * C::KVB / 16; e += kFusedThreads)
    reinterpret_cast<uint4*>(kvs + (e / (C::KVB / 16)) * 2 * C::KVB +
                             C::KVB)[e % (C::KVB / 16)] =
        make_uint4(0u, 0u, 0u, 0u);
  fence_proxy_async();
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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kFwdProducerRegs));
    if (warp != kConsumers / 32) return;
    // one warp: lane 0 the Q tile and the stage's arrival, lane l < kSlots
    // slot l of each stage (its work item entry and its K / V boxes)
    int it = 0;   // ring position, across work tiles
    auto produce = [&](const SpWork wk, int wt) {
      if (lane == 0) {
        const int qb = wt % QBUF;
        if (wt >= QBUF) mbar_wait(&q_empty[qb], (wt / QBUF - 1) & 1);
        mbar_expect_tx(&q_full[qb], C::QB);
        uint8_t* qs = qbuf + qb * C::QB;
        for (int p = 0; p < C::NP; ++p)
          for (int h = 0; h < 2; ++h)
            tma_load_4d(qs + p * kKeys * SW + h * 64 * SW, &qmap, p * P, wk.n,
                        wk.i0 + 64 * h, wk.b, &q_full[qb]);
      }
      const int list = wk.n * nq + wk.i0 / kKeys;
      const int cnt = scount[list];
      const int4* sl = slots + (int64_t)list * SMAX * kSlots;
      for (int s = 0; s <= cnt; ++s) {
        const int st = it % ST;
        if (it >= ST) mbar_wait(&empty[st], (it / ST - 1) & 1);
        ++it;
        if (s == cnt) {   // the end of the work tile
          if (lane == 0) {
            wstate[st] = -1;
            mbar_arrive(&full[st]);
          }
          break;
        }
        int4 e = make_int4(-1, 0, 0, 0);
        int halves = 0;
        if (lane < kSlots) {
          e = __ldg(sl + s * kSlots + lane);
          // under causality a group past every row of the tile is not loaded
          if (causal && e.x > wk.i0 + kKeys - 1) e.x = -1;
          work[st][lane] = e;
          for (int h = 0; h < 2; ++h)
            if (e.x >= 0 && ((e.w >> (2 * h)) & 3) &&
                (!causal || e.x <= wk.i0 + 64 * h + 63))
              halves |= 1 << h;
        }
        const int loaded = __popc(__ballot_sync(0xffffffffu, e.x >= 0));
        halves = (int)__reduce_or_sync(0xffffffffu, (unsigned)halves);
        __syncwarp();   // the entries are written before the stage arrives
        if (lane == 0) {
          wstate[st] = halves;
          mbar_expect_tx(&full[st], loaded * 2 * C::NP * C::GB);
        }
        __syncwarp();
        if (e.x >= 0) {
          uint8_t* kd = kvs + st * 2 * C::KVB + lane * C::GB;
          for (int p = 0; p < C::NP; ++p) {
            tma_load_4d(kd + p * kKeys * SW, &kmap, p * P, wk.n, e.x, wk.b,
                        &full[st]);
            tma_load_4d(kd + C::KVB + p * kKeys * SW, &vmap, p * P, wk.n, e.x,
                        wk.b, &full[st]);
          }
        }
      }
    };
    if constexpr (C::kPersistent) {
      int wt = 0;
      for (int w = blockIdx.x; w < total; w += gridDim.x)
        produce(sp_work(w, qorder, N, B), wt++);
    } else {
      produce(own, 0);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(kFwdConsumerRegs));

  const int ctid = tid & 127, wi = warp & 3, g = lane >> 2, t = lane & 3;
  const int rl0 = 64 * wg;   // the warpgroup's first row of the tile
  const float scale2 = scale * kLog2e;
  // a stage whose pairs are all visible may take the max of the raw scores
  const bool plain = scale > 0.f;
  float o[D / 2], m[2], l[2], s[kKeys / 2];
  uint32_t pa[kKeys / 16][4];

  // K-major descriptor of k16 step kk of a 128-row tile, from row r0
  auto kdesc = [&](const uint8_t* tile, int r0, int kk) {
    return wgmma_desc<SW>(tile + (kk * 16 / P) * kKeys * SW + r0 * SW +
                              (kk * 16 % P) * 2,
                          16, 8 * SW);
  };
  auto release = [&](int it) {
    if (lane == 0) mbar_arrive(&empty[it % ST]);
  };

  int it = 0;   // ring position, as the producer's
  auto consume = [&](const SpWork wk, int wt) {
    const int wrow0 = wk.i0 + rl0;
    int row[2];   // this thread's two rows, absolute
    row[0] = wrow0 + 16 * wi + g;
    row[1] = row[0] + 8;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = neg_infinity();
    l[0] = l[1] = 0.f;
    const int qb = wt % QBUF;
    const uint8_t* qs = qbuf + qb * C::QB;
    mbar_wait(&q_full[qb], (wt / QBUF) & 1);

    for (;; ++it) {
      const int st = it % ST;
      mbar_wait(&full[st], (it / ST) & 1);
      const int state = __shfl_sync(0xffffffffu, wstate[st], 0);
      if (state < 0) break;
      if (!((state >> wg) & 1)) {   // no row of this warpgroup sees a key
        release(it);
        continue;
      }
      const uint8_t* kt = kvs + st * 2 * C::KVB;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<T, kKeys>::template ss<0, 0>(s, kdesc(qs, rl0, kk),
                                           kdesc(kt, 0, kk), kk > 0);
      wgmma_commit();

      // while S runs: the visibility of this thread's elements. Element e
      // of s is row h = e / 2 % 2, column 8 (e / 4) + 2 t + e % 2 of the
      // stage: slot e / 8, column cc = 8 (e / 4 % 2) + 2 t + e % 2 of the
      // slot's group; bit e % 32 of vis[e / 32] says it is visible.
      uint32_t vis[2] = {0u, 0u};
      int lives = 0, wholes = 0;   // slots: a pair visible / all visible
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const int4 e = work[st][j];
        const int fl = (e.w >> (2 * wg)) & 3;
        if (e.x < 0 || fl == 0 || (causal && e.x > wrow0 + 63)) continue;
        lives |= 1 << j;
        uint32_t bits = 0xFFu;
        if (fl == 1 && (!causal || e.x + kGroup - 1 <= wrow0)) {
          wholes |= 1 << j;
        } else {
          bits = 0u;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // bits 0, 1, 8, 9: columns 2 t, 2 t + 1, 8 + 2 t, 9 + 2 t
            uint32_t w = 0xFFFFu;
            if (fl == 2)
              w = (uint32_t)(__ldg(rowbits + ((int64_t)e.y * kKeys + row[h] -
                                              wk.i0) * 2 + (e.z >> 6)) >>
                             (e.z & 63));
            w >>= 2 * t;
            if (causal) {   // key e.x + cc <= row
              const int lim = row[h] - e.x - 2 * t;
              w &= (lim >= 0 ? 1u : 0u) | (lim >= 1 ? 2u : 0u) |
                   (lim >= 8 ? 0x100u : 0u) | (lim >= 9 ? 0x200u : 0u);
            }
            bits |= ((w & 1u) | ((w >> 1) & 1u) << 1 | ((w >> 8) & 1u) << 4 |
                     ((w >> 9) & 1u) << 5) << (2 * h);
          }
        }
        vis[j >> 2] |= bits << (8 * (j & 3));
      }
      wgmma_wait<0>();
      fence_regs(s);

      // s -> p = 2^(s scale log2 e - m); m, l updated, corr the factor of O
      float corr[2], mx[2] = {neg_infinity(), neg_infinity()};
      if (__shfl_sync(0xffffffffu, (int)(plain && wholes == (1 << kSlots) - 1),
                      0)) {
#pragma unroll
        for (int e = 0; e < kKeys / 2; ++e)
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
        for (int e = 0; e < kKeys / 2; ++e)
          s[e] = fast_exp2(fmaf(s[e], scale2, -m[(e >> 1) & 1]));
      } else {
        // invisible pairs selected to -inf (never multiplied: a slot that
        // was not loaded may hold anything in K)
#pragma unroll
        for (int e = 0; e < kKeys / 2; ++e) {
          s[e] = (vis[e >> 5] >> (e & 31)) & 1u ? s[e] * scale2
                                                : neg_infinity();
          mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
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
        // p = 0 without an ex2 on a slot no row of the warpgroup sees
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
          const bool on = (lives >> j) & 1;
#pragma unroll
          for (int e = 8 * j; e < 8 * j + 8; ++e)
            s[e] = on ? fast_exp2(s[e] - mx[(e >> 1) & 1]) : 0.f;
        }
      }
      float rs[2] = {0.f, 0.f};  // this thread's columns; quad sums at the end
#pragma unroll
      for (int e = 0; e < kKeys / 2; ++e) rs[(e >> 1) & 1] += s[e];
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + rs[h];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pa[kk][j] = Mma<T>::pack(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);

      // O += P V (V MN-major through the transpose bit)
      const uint8_t* vt = kt + C::KVB;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        Wgmma<T, D>::template rs<1>(
            o, pa[kk], wgmma_desc<SW>(vt + kk * 16 * SW, kKeys * SW, 8 * SW),
            1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      release(it);
    }
    release(it++);  // the end item's stage

    // o = O / l in the input type, into this warpgroup's rows of the Q tile
    // (its S products are done), swizzled as the output's map; then one TMA
    // store a panel
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      inv[h] = l[h] > 0.f ? 1.f / l[h] : 0.f;
    }
    uint8_t* os = qbuf + qb * C::QB;
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int h = (i >> 1) & 1, r = rl0 + 16 * wi + g + 8 * h;
      const int col = 8 * (i >> 2) + 2 * t;
      const int a = r * SW + (col % P) * 2;
      *reinterpret_cast<uint32_t*>(os + (col / P) * kKeys * SW +
                                   swizzle_offset(a, SW)) =
          Mma<T>::pack(o[i] * inv[h], o[i + 1] * inv[h]);
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (ctid == 0) {
      for (int p = 0; p < C::NP; ++p)
        tma_store_4d(&omap, os + p * kKeys * SW + rl0 * SW, p * P, wk.n,
                     wrow0, wk.b);
      bulk_commit();
      bulk_wait_read<0>();  // the tile's shared memory is free again
      mbar_arrive(&q_empty[qb]);
    }
    if (t == 0) {
      constexpr float kLn2 = 0.6931471805599453f;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        lse[((int64_t)wk.b * N + wk.n) * S + row[h]] =
            l[h] > 0.f ? (m[h] + log2f(l[h])) * kLn2 : neg_infinity();
    }
  };
  if constexpr (C::kPersistent) {
    int wt = 0;
    for (int w = blockIdx.x; w < total; w += gridDim.x)
      consume(sp_work(w, qorder, N, B), wt++);
  } else {
    consume(own, 0);
  }
  if (ctid == 0) bulk_wait<0>();  // every store written
}

// ---------------------------------------------------------------------------
// forward, CUDA-core path (fp32, and 16-bit rows of other D): grid (S / 16,
// N, B), 4 warps of 4 query rows; lane i holds dims i, i + 32, ...
// ---------------------------------------------------------------------------
template <typename T, int NI>
__global__ void __launch_bounds__(kThreads)
sparse_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ kidx,
                  const int* __restrict__ mid, const int* __restrict__ kcount,
                  const uint8_t* __restrict__ masks,
                  const uint8_t* __restrict__ quad, T* __restrict__ out,
                  float* __restrict__ lse, int S, int N, int D, int A,
                  int causal, float scale) {
  constexpr int RPW = 4;                  // query rows per warp
  constexpr int QT = RPW * kWarps;        // query rows per block
  constexpr int KT = NI <= 4 ? 32 : 16;   // keys per staged sub-tile
  constexpr int DM = NI * 32;
  __shared__ float ks[KT][DM];
  __shared__ float vs[KT][DM];

  const int nq = S / kTile;
  const int n = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * QT, it = q0 / kTile;
  const int64_t rs = (int64_t)N * D;
  const int64_t hb = ((int64_t)b * S * N + n) * D;

  float qr[RPW][NI], acc[RPW][NI], m[RPW], l[RPW];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = q0 + warp * RPW + rr;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      qr[rr][i] = d < D ? to_f(q[hb + r * rs + d]) * scale : 0.f;
      acc[rr][i] = 0.f;
    }
    m[rr] = kNegInf;
    l[rr] = 0.f;
  }

  const int list = n * nq + it;
  const int cnt = kcount[list];
  for (int a = 0; a < cnt; ++a) {
    const int j = kidx[list * A + a];
    const uint8_t* mt = masks + (int64_t)mid[list * A + a] * kTileElems;
    const uint8_t* qd = quad + mid[list * A + a] * 4 + ((q0 & (kTile - 1)) >> 6) * 2;
    for (int t0 = j * kTile; t0 < (j + 1) * kTile; t0 += KT) {
      // block-uniform: an empty mask quadrant, or keys past every row
      if (!qd[(t0 & (kTile - 1)) >> 6] || (causal && t0 > q0 + QT - 1)) continue;
      __syncthreads();  // the previous sub-tile is consumed
      for (int e = threadIdx.x; e < KT * DM; e += kThreads) {
        const int jr = e / DM, d = e % DM;
        const int64_t off = hb + (t0 + jr) * rs + d;
        ks[jr][d] = d < D ? to_f(k[off]) : 0.f;
        vs[jr][d] = d < D ? to_f(v[off]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const int r = q0 + warp * RPW + rr;
        if (causal && r < t0) continue;  // warp-uniform
        const uint8_t* mrow = mt + (r & (kTile - 1)) * kTile + (t0 & (kTile - 1));
        float s[KT];
        bool vis[KT];
        float mx = kNegInf;
#pragma unroll
        for (int jj = 0; jj < KT; ++jj) {
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < NI; ++i) dot += qr[rr][i] * ks[jj][lane + 32 * i];
          dot = warp_sum(dot);
          vis[jj] = mrow[jj] && (!causal || t0 + jj <= r);
          s[jj] = vis[jj] ? dot : kNegInf;
          mx = fmaxf(mx, s[jj]);
        }
        const float m_new = fmaxf(m[rr], mx);
        const float corr = expf(m[rr] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int jj = 0; jj < KT; ++jj) {
          s[jj] = vis[jj] ? expf(s[jj] - m_new) : 0.f;
          psum += s[jj];
        }
        l[rr] = l[rr] * corr + psum;
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          float x = acc[rr][i] * corr;
#pragma unroll
          for (int jj = 0; jj < KT; ++jj)
            if (vis[jj]) x += s[jj] * vs[jj][lane + 32 * i];
          acc[rr][i] = x;
        }
        m[rr] = m_new;
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = q0 + warp * RPW + rr;
    const float inv = l[rr] > 0.f ? 1.f / l[rr] : 0.f;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (d < D) out[hb + r * rs + d] = from_f<T>(acc[rr][i] * inv);
    }
    if (lane == 0)
      lse[((int64_t)b * N + n) * S + r] =
          l[rr] > 0.f ? m[rr] + logf(l[rr]) : neg_infinity();
  }
}

// ---------------------------------------------------------------------------
// backward, the fused pass (16-bit, D in {16, 32, 64, 128}); see the note
// above. Block shape and shared-memory plan: attention_bwd.cuh (Tiles<D>).
// ---------------------------------------------------------------------------

constexpr int kQuadEmpty = 0, kQuadFull = 1;   // else partial: see quad

// work item flags, per consumer warpgroup w: its keys see a row of the
// half; every pair of its quadrant is visible; its quadrant is partial
// (the mask words are read)
constexpr int kLive = 1, kWhole = 4, kPartial = 16;

// grid (N, B, S / 128), block kFusedThreads, dynamic shared memory
// Tiles<D>::SMEM. Maps (TMA, tiles of Tiles<D>::P columns): q / dout / k /
// v (D, N, S, B) in boxes of (P, 1, kRows, 1) (q, dout) and (P, 1, kKeys,
// 1) (k, v); amap: the fp32 dq accumulator (D, N, S, B), zeroed, in boxes
// of (DQN, 1, kRows, 1). stats: the prologue's tiles. qidx / mid / qcount:
// the transposed lists (width At); quad (U, 2, 2): the quadrants' flags;
// bits (U, 128 keys, 2 halves): 64 query rows a word; korder: the key
// tiles in dispatch order.
template <typename T, int D>
__global__ void __launch_bounds__(kFusedThreads, 1)
sparse_bwd_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __grid_constant__ CUtensorMap omap,
                  const __grid_constant__ CUtensorMap amap,
                  const float* __restrict__ stats,
                  const int* __restrict__ qidx, const int* __restrict__ mid,
                  const int* __restrict__ qcount,
                  const uint8_t* __restrict__ quad,
                  const unsigned long long* __restrict__ bits,
                  const int* __restrict__ korder, T* __restrict__ dk,
                  T* __restrict__ dv, int S, int N, int At, int causal,
                  float scale) {
  using C = Tiles<D>;
  constexpr int P = C::P, SW = C::SW;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t kv_bar, full[kStages], empty[kStages];
  // each stage's work item: first query row (-1: the end), mask id, flags
  __shared__ int4 work[kStages];
  uint8_t* ks = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* vs = ks + C::KV;
  uint8_t* qs = vs + C::KV;                  // stage st at qs + st * QO
  uint8_t* os = qs + kStages * C::QO;        // dO, likewise
  uint8_t* dss = os + kStages * C::QO;       // dS^T buffers
  uint8_t* dqs = dss + 2 * C::DS;            // dQ buffers [wg][2][DQC]
  float* sts = reinterpret_cast<float*>(dqs + 4 * C::DQC * C::DQB);  // stats

  const int n = blockIdx.x, b = blockIdx.y;
  const int nk = S / kKeys, nqt = S / kRows;
  const int jt = korder[blockIdx.z];
  const int k0 = jt * kKeys;
  const int list = n * nk + jt;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the warpgroup and the list's length as values the compiler sees are
  // warp-uniform (one lane's, shuffled): wgmma under a branch it cannot
  // prove uniform is serialized
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const bool producer = wg == kConsumers / 128;
  const int cnt = __shfl_sync(0xffffffffu, qcount[list], 0);
  const int wi = warp & 3, g = lane >> 2, t = lane & 3;

  if (tid == 0) {
    mbar_init(&kv_bar, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumers / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (producer) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (tid == kConsumers && cnt > 0) {
      mbar_expect_tx(&kv_bar, 2 * C::KV);
      for (int p = 0; p < D / P; ++p) {
        tma_load_4d(ks + p * kKeys * SW, &kmap, p * P, n, k0, b, &kv_bar);
        tma_load_4d(vs + p * kKeys * SW, &vmap, p * P, n, k0, b, &kv_bar);
      }
      int it = 0;
      for (int a = 0; a < cnt; ++a) {
        const int qi = qidx[list * At + a], mk = mid[list * At + a];
        for (int h = 0; h < 2; ++h) {
          const int i0 = qi * kKeys + h * kRows;
          int flags = 0;
          for (int w = 0; w < 2; ++w) {
            const int fl = quad[mk * 4 + h * 2 + w];
            const int kw = k0 + 64 * w;   // the warpgroup's first key
            if (fl != kQuadEmpty && (!causal || kw <= i0 + kRows - 1))
              flags |= kLive << w;
            if (fl == kQuadFull && (!causal || kw + 63 <= i0))
              flags |= kWhole << w;
            if (fl != kQuadEmpty && fl != kQuadFull) flags |= kPartial << w;
          }
          if (!(flags & 3 * kLive)) continue;   // no key sees a row
          const int st = it % kStages;
          if (it >= kStages) mbar_wait(&empty[st], (it / kStages - 1) & 1);
          work[st] = make_int4(i0, mk, flags, 0);
          mbar_expect_tx(&full[st], C::STAGE);   // releases the item
          for (int p = 0; p < D / P; ++p) {
            tma_load_4d(qs + st * C::QO + p * kRows * SW, &qmap, p * P, n,
                        i0, b, &full[st]);
            tma_load_4d(os + st * C::QO + p * kRows * SW, &omap, p * P, n,
                        i0, b, &full[st]);
          }
          bulk_load(sts + st * kStat,
                    stats + (((int64_t)b * N + n) * nqt + i0 / kRows) * kStat,
                    kStat * 4, &full[st]);
          ++it;
        }
      }
      const int st = it % kStages;
      if (it >= kStages) mbar_wait(&empty[st], (it / kStages - 1) & 1);
      work[st] = make_int4(-1, 0, 0, 0);
      mbar_arrive(&full[st]);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));

  // this thread's two keys: rows g and g + 8 of its warp's 16, tile-local
  int kl[2], key[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kl[r] = 64 * wg + 16 * wi + g + 8 * r;
    key[r] = k0 + kl[r];
  }
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  if (cnt > 0) {
    const float scale2 = scale * kLog2e;
    mbar_wait(&kv_bar, 0);

    // S^T / dP^T of the next half are issued before the wait for this
    // half's dV, dK and dQ products (D <= 64: registers allow both), so the
    // tensor cores run them while this half's dQ part goes out
    constexpr bool kAhead = D <= 64;
    float s[32], dp[32];
    // K-major descriptor of k16 step kk of a tile of `rows` rows (panels of
    // P columns), from row r0
    auto kdesc = [&](const uint8_t* tile, int rows, int r0, int kk) {
      return wgmma_desc<SW>(tile + (kk * 16 / P) * rows * SW + r0 * SW +
                                (kk * 16 % P) * 2,
                            16, 8 * SW);
    };
    // the work item of half `it`, once its stage has arrived (lane 0's
    // copy: warp-uniform for the compiler)
    auto fetch = [&](int it) {
      const int st = it % kStages;
      mbar_wait(&full[st], (it / kStages) & 1);
      const int4 w = work[st];
      return make_int4(__shfl_sync(0xffffffffu, w.x, 0),
                       __shfl_sync(0xffffffffu, w.y, 0),
                       __shfl_sync(0xffffffffu, w.z, 0), 0);
    };
    // S^T = K Q^T, dP^T = V dO^T of half `it` (64 keys x 64 queries each),
    // two commit groups
    auto issue_sdp = [&](int it) {
      const int st = it % kStages;
      const uint8_t* qst = qs + st * C::QO;
      const uint8_t* ost = os + st * C::QO;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<T, 64>::template ss<0, 0>(s, kdesc(ks, kKeys, 64 * wg, kk),
                                        kdesc(qst, kRows, 0, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<T, 64>::template ss<0, 0>(dp, kdesc(vs, kKeys, 64 * wg, kk),
                                        kdesc(ost, kRows, 0, kk), kk > 0);
      wgmma_commit();
    };
    int4 cur = fetch(0);
    if (cur.x >= 0 && (cur.z & (kLive << wg))) issue_sdp(0);
    for (int it = 0; cur.x >= 0; ++it) {
      const int st = it % kStages;
      const int i0 = cur.x, mk = cur.y;
      const bool mine = (cur.z & (kLive << wg)) != 0;
      const uint8_t* qst = qs + st * C::QO;
      const uint8_t* ost = os + st * C::QO;
      const float* ls = sts + st * kStat;   // lse * log2(e)
      const float* dl = ls + kRows;         // delta
      uint8_t* dsb = dss + (it & 1) * C::DS;
      uint32_t pa[4][4], da[4][4];
      // this thread's keys' visible rows of the half (read while S^T / dP^T
      // run), shifted so that bit 8 j + q is column 8 j + 2 t + q of the
      // accumulator
      unsigned long long mw[2] = {~0ull, ~0ull};
      if (mine && (cur.z & (kPartial << wg))) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          mw[r] = __ldg(bits + ((int64_t)mk * kKeys + kl[r]) * 2 +
                        ((i0 / kRows) & 1)) >> (2 * t);
      }
      // this half's S^T / dP^T are in (if issued): waited on every path,
      // or the compiler serializes every wgmma (ptxas C7515)
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      if (mine) {
        const bool whole = (cur.z & (kWhole << wg)) != 0;
        // P^T and dS^T = P^T (dP^T - delta), one pair of columns at a
        // time, packed to 16 bits as the A fragments of dV / dK's products;
        // p and ds selected to 0 where the pair is invisible (tested only
        // where the quadrant is not whole: uniform over the warpgroup)
#pragma unroll
        for (int e = 0; e < 32; e += 2) {
          const int r = (e >> 1) & 1, c8 = 8 * (e >> 2), col = c8 + 2 * t;
          const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
          const float2 d2 = *reinterpret_cast<const float2*>(dl + col);
          float p0 = fast_exp2(fmaf(s[e], scale2, -l2.x));
          float p1 = fast_exp2(fmaf(s[e + 1], scale2, -l2.y));
          float ds0 = p0 * (dp[e] - d2.x), ds1 = p1 * (dp[e + 1] - d2.y);
          if (!whole) {
            const int i = i0 + col;
            const bool v0 = ((mw[r] >> c8) & 1ull) && (!causal || key[r] <= i);
            const bool v1 =
                ((mw[r] >> (c8 + 1)) & 1ull) && (!causal || key[r] <= i + 1);
            p0 = v0 ? p0 : 0.f;
            ds0 = v0 ? ds0 : 0.f;
            p1 = v1 ? p1 : 0.f;
            ds1 = v1 ? ds1 : 0.f;
          }
          pa[e >> 3][(e >> 1) & 3] = Mma<T>::pack(p0, p1);
          da[e >> 3][(e >> 1) & 3] = Mma<T>::pack(ds0, ds1);
        }

        // dV += P^T dO, dK += dS^T Q (k16 steps over the half's queries)
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Wgmma<T, D>::template rs<1>(
              dva, pa[kk],
              wgmma_desc<SW>(ost + kk * 16 * SW, kRows * SW, 8 * SW), 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Wgmma<T, D>::template rs<1>(
              dka, da[kk],
              wgmma_desc<SW>(qst + kk * 16 * SW, kRows * SW, 8 * SW), 1);
        wgmma_commit();

        // dS^T into this half's buffer: key row kr, 128-byte rows, 16-byte
        // chunk j of a row at j ^ (kr % 8)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<uint32_t*>(dsb + kl[r] * 128 +
                                         ((j ^ (kl[r] & 7)) << 4) + 4 * t) =
                da[j >> 1][(j & 1) * 2 + r];
        }
      } else {
        // no key of this warpgroup sees the half: its dS^T rows are zero
        uint4* z = reinterpret_cast<uint4*>(dsb + 64 * wg * 128);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          z[(tid & 127) + 128 * j] = make_uint4(0u, 0u, 0u, 0u);
      }
      fence_proxy_async();
      // this warpgroup's dQ buffer of half it - 2 has been read out
      if ((tid & 127) == 0) bulk_wait_read<1>();
      named_barrier(1, kConsumers);   // both halves of dS^T are in

      // dQ_part (64 queries x this warpgroup's D / 2) = dS K
      float dqa[C::DQC][C::DQN / 2];
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < C::DQC; ++c) {
        const int c0 = wg * (D / 2) + c * C::DQN;
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk)
          Wgmma<T, C::DQN>::template ss<1, 1>(
              dqa[c], wgmma_desc<128>(dsb + kk * 16 * 128, 16, 8 * 128),
              wgmma_desc<SW>(ks + (c0 / P) * kKeys * SW + kk * 16 * SW +
                                 (c0 % P) * 2,
                             kKeys * SW, 8 * SW),
              kk > 0);
      }
      wgmma_commit();
      int4 nxt = make_int4(-1, 0, 0, 0);
      bool ahead = false;
      if (kAhead) {
        nxt = fetch(it + 1);
        ahead = nxt.x >= 0 && (nxt.z & (kLive << wg));
        if (ahead) issue_sdp(it + 1);
      }
      if (ahead) wgmma_wait<2>();
      else wgmma_wait<0>();
      // every product reading this stage is done
      fence_regs(dka);
      fence_regs(dva);
      fence_regs(pa);
      fence_regs(da);
#pragma unroll
      for (int c = 0; c < C::DQC; ++c) fence_regs(dqa[c]);
      if (lane == 0) mbar_arrive(&empty[st]);
      // into the fp32 accumulator: each chunk (64 rows x DQN columns) into
      // this half's buffer, rows of DQN * 4 bytes swizzled as its TMA map,
      // then one TMA reduce-add a chunk
      constexpr int RB = C::DQN * 4, MASK = RB / 16 - 1;
      uint8_t* qb = dqs + (wg * 2 + (it & 1)) * C::DQC * C::DQB;
#pragma unroll
      for (int c = 0; c < C::DQC; ++c)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int j = 0; j < C::DQN / 8; ++j) {
            const int a = (16 * wi + g + 8 * r) * RB + (8 * j + 2 * t) * 4;
            *reinterpret_cast<float2*>(qb + c * C::DQB +
                                       (a ^ (((a >> 7) & MASK) << 4))) =
                make_float2(dqa[c][4 * j + 2 * r], dqa[c][4 * j + 2 * r + 1]);
          }
      fence_proxy_async();
      named_barrier(2 + wg, 128);
      if ((tid & 127) == 0) {
#pragma unroll
        for (int c = 0; c < C::DQC; ++c)
          tma_reduce_add_4d(&amap, qb + c * C::DQB, wg * (D / 2) + c * C::DQN,
                            n, i0, b);
        bulk_commit();
      }
      if (!kAhead) {
        nxt = fetch(it + 1);
        if (nxt.x >= 0 && (nxt.z & (kLive << wg))) issue_sdp(it + 1);
      }
      cur = nxt;
    }
  }
  // nothing in flight past here, and the dQ reductions complete before the
  // block's shared memory goes
  wgmma_wait<0>();
  if ((tid & 127) == 0) bulk_wait<0>();
  fence_regs(dka);
  fence_regs(dva);

  const int64_t rs = (int64_t)N * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t ko = ((int64_t)b * S + key[r]) * rs + (int64_t)n * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      store_pair(dk + ko + 8 * j, dka[4 * j + 2 * r] * scale,
                 dka[4 * j + 2 * r + 1] * scale);
      store_pair(dv + ko + 8 * j, dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// dq, CUDA-core path: grid (S / 16, N, B), 4 warps of 4 query rows
// ---------------------------------------------------------------------------
template <typename T, int NI>
__global__ void __launch_bounds__(kThreads)
sparse_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const int* __restrict__ kidx, const int* __restrict__ mid,
                 const int* __restrict__ kcount,
                 const uint8_t* __restrict__ masks,
                 const uint8_t* __restrict__ quad, T* __restrict__ dq, int S,
                 int N, int D, int A, int causal, float scale) {
  constexpr int RPW = 4;
  constexpr int QT = RPW * kWarps;
  constexpr int KT = NI <= 4 ? 32 : 16;
  constexpr int DM = NI * 32;
  __shared__ float ks[KT][DM];
  __shared__ float vs[KT][DM];

  const int nq = S / kTile;
  const int n = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * QT, it = q0 / kTile;
  const int64_t rs = (int64_t)N * D;
  const int64_t hb = ((int64_t)b * S * N + n) * D;

  float qr[RPW][NI], dr[RPW][NI], acc[RPW][NI], lr[RPW], dl[RPW];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = q0 + warp * RPW + rr;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      qr[rr][i] = d < D ? to_f(q[hb + r * rs + d]) * scale : 0.f;
      dr[rr][i] = d < D ? to_f(dout[hb + r * rs + d]) : 0.f;
      acc[rr][i] = 0.f;
    }
    const int64_t lo = ((int64_t)b * N + n) * S + r;
    lr[rr] = lse[lo];
    dl[rr] = delta[lo];
  }

  const int list = n * nq + it;
  const int cnt = kcount[list];
  for (int a = 0; a < cnt; ++a) {
    const int j = kidx[list * A + a];
    const uint8_t* mt = masks + (int64_t)mid[list * A + a] * kTileElems;
    const uint8_t* qd = quad + mid[list * A + a] * 4 + ((q0 & (kTile - 1)) >> 6) * 2;
    for (int t0 = j * kTile; t0 < (j + 1) * kTile; t0 += KT) {
      if (!qd[(t0 & (kTile - 1)) >> 6] || (causal && t0 > q0 + QT - 1)) continue;
      __syncthreads();
      for (int e = threadIdx.x; e < KT * DM; e += kThreads) {
        const int jr = e / DM, d = e % DM;
        const int64_t off = hb + (t0 + jr) * rs + d;
        ks[jr][d] = d < D ? to_f(k[off]) : 0.f;
        vs[jr][d] = d < D ? to_f(v[off]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const int r = q0 + warp * RPW + rr;
        if (causal && r < t0) continue;  // warp-uniform
        const uint8_t* mrow = mt + (r & (kTile - 1)) * kTile + (t0 & (kTile - 1));
        for (int jj = 0; jj < KT; ++jj) {
          float dot = 0.f, dpv = 0.f;
#pragma unroll
          for (int i = 0; i < NI; ++i) {
            dot += qr[rr][i] * ks[jj][lane + 32 * i];
            dpv += dr[rr][i] * vs[jj][lane + 32 * i];
          }
          dot = warp_sum(dot);
          dpv = warp_sum(dpv);
          const bool on = mrow[jj] && (!causal || t0 + jj <= r);
          const float ds = on ? expf(dot - lr[rr]) * (dpv - dl[rr]) : 0.f;
#pragma unroll
          for (int i = 0; i < NI; ++i) acc[rr][i] += ds * ks[jj][lane + 32 * i];
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = q0 + warp * RPW + rr;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (d < D) dq[hb + r * rs + d] = from_f<T>(acc[rr][i] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// dk / dv, CUDA-core path: grid (S / 16, N, B), 4 warps of 4 keys; query
// sub-tiles of QT rows staged as fp32
// ---------------------------------------------------------------------------
template <typename T, int NI>
__global__ void __launch_bounds__(kThreads)
sparse_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const int* __restrict__ qidx, const int* __restrict__ mid,
                  const int* __restrict__ qcount,
                  const uint8_t* __restrict__ masks,
                  const uint8_t* __restrict__ quad, T* __restrict__ dk,
                  T* __restrict__ dv, int S, int N, int D, int At, int causal,
                  float scale) {
  constexpr int KPW = 4;
  constexpr int KB = KPW * kWarps;
  constexpr int QT = NI <= 4 ? 32 : 16;
  constexpr int DM = NI * 32;
  __shared__ float qs[QT][DM];
  __shared__ float os[QT][DM];
  __shared__ float ls[QT], dls[QT];

  const int nk = S / kTile;
  const int n = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = blockIdx.x * KB, jt = k0 / kTile;
  const int64_t rs = (int64_t)N * D;
  const int64_t hb = ((int64_t)b * S * N + n) * D;
  const int64_t lbase = ((int64_t)b * N + n) * S;

  int key[KPW];
  float kr[KPW][NI], vr[KPW][NI], dka[KPW][NI], dva[KPW][NI];
#pragma unroll
  for (int rr = 0; rr < KPW; ++rr) {
    key[rr] = k0 + warp * KPW + rr;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      kr[rr][i] = d < D ? to_f(k[hb + key[rr] * rs + d]) : 0.f;
      vr[rr][i] = d < D ? to_f(v[hb + key[rr] * rs + d]) : 0.f;
      dka[rr][i] = dva[rr][i] = 0.f;
    }
  }

  const int list = n * nk + jt;
  const int cnt = qcount[list];
  for (int a = 0; a < cnt; ++a) {
    const int qi = qidx[list * At + a];
    const uint8_t* mt = masks + (int64_t)mid[list * At + a] * kTileElems;
    const uint8_t* qd = quad + mid[list * At + a] * 4 + ((k0 & (kTile - 1)) >> 6);
    for (int i0 = qi * kTile; i0 < (qi + 1) * kTile; i0 += QT) {
      if (!qd[((i0 & (kTile - 1)) >> 6) * 2] ||
          (causal && i0 + QT - 1 < k0)) continue;  // block-uniform
      __syncthreads();
      for (int e = threadIdx.x; e < QT * DM; e += kThreads) {
        const int r = e / DM, d = e % DM;
        const int64_t off = hb + (i0 + r) * rs + d;
        qs[r][d] = d < D ? to_f(q[off]) : 0.f;
        os[r][d] = d < D ? to_f(dout[off]) : 0.f;
      }
      if (threadIdx.x < QT) {
        ls[threadIdx.x] = lse[lbase + i0 + threadIdx.x];
        dls[threadIdx.x] = delta[lbase + i0 + threadIdx.x];
      }
      __syncthreads();
#pragma unroll
      for (int rr = 0; rr < KPW; ++rr) {
        // warp-uniform: no query of the sub-tile sees this key
        if (causal && i0 + QT - 1 < key[rr]) continue;
        // the q-major mask: row = query, column = this key
        const uint8_t* mcol = mt + (i0 & (kTile - 1)) * kTile + (key[rr] & (kTile - 1));
        for (int c = 0; c < QT; ++c) {
          float dot = 0.f, dpv = 0.f;
#pragma unroll
          for (int i = 0; i < NI; ++i) {
            dot += qs[c][lane + 32 * i] * kr[rr][i];
            dpv += os[c][lane + 32 * i] * vr[rr][i];
          }
          dot = warp_sum(dot);
          dpv = warp_sum(dpv);
          const bool on = mcol[c * kTile] && (!causal || key[rr] <= i0 + c);
          const float p = on ? expf(dot * scale - ls[c]) : 0.f;
          const float ds = p * (dpv - dls[c]);
#pragma unroll
          for (int i2 = 0; i2 < NI; ++i2) {
            dva[rr][i2] += p * os[c][lane + 32 * i2];
            dka[rr][i2] += ds * qs[c][lane + 32 * i2];
          }
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < KPW; ++rr) {
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (d < D) {
        dk[hb + key[rr] * rs + d] = from_f<T>(dka[rr][i] * scale);
        dv[hb + key[rr] * rs + d] = from_f<T>(dva[rr][i]);
      }
    }
  }
}

struct Plan {
  const int *idx, *mid, *count;
  const uint8_t *masks, *quad;
};

bool mma_dim(int D) { return D == 16 || D == 32 || D == 64 || D == 128; }

// the forward's packed stages (TilePlan.stage_plan) and query-major mask
// words, and the q-tiles in dispatch order
struct Stages {
  const int4* slots;
  const int* scount;
  const unsigned long long* rowbits;
  const int* qorder;
  int smax;
};

template <typename T, int D>
cudaError_t fwd_tma(cudaStream_t st, const void* q, const void* k,
                    const void* v, const Stages& g, void* out, float* lse,
                    int B, int S, int N, int causal, float scale) {
  using C = SpFwd<D>;
  CUtensorMap qm, km, vm, om;
  cudaError_t e = head_map<T>(&qm, q, B, S, N, D, C::P, 64);
  if (e == cudaSuccess) e = head_map<T>(&om, out, B, S, N, D, C::P, 64);
  if (e == cudaSuccess) e = head_map<T>(&km, k, B, S, N, D, C::P, kGroup);
  if (e == cudaSuccess) e = head_map<T>(&vm, v, B, S, N, D, C::P, kGroup);
  if (e != cudaSuccess) return e;
  auto kern = sparse_fwd_tma_kernel<T, D>;
  static bool smem_set = false;   // per instantiation: above 48 KB, opt in
  if (!smem_set) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  dim3 grid((unsigned)N, (unsigned)B, (unsigned)(S / kKeys));
  if constexpr (C::kPersistent) {
    int dev = 0, sms = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    const int64_t tiles = (int64_t)(S / kKeys) * N * B;
    grid = dim3((unsigned)(tiles < sms ? tiles : sms));
  }
  kern<<<grid, kFusedThreads, C::SMEM, st>>>(
      qm, km, vm, om, g.slots, g.scount, g.rowbits, g.qorder, lse, B, S, N,
      g.smax, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_d(cudaStream_t st, const void* q, const void* k,
                  const void* v, const Plan& p, const Stages& g, void* out,
                  float* lse, int B, int S, int N, int D, int A, int causal,
                  float scale) {
  if constexpr (sizeof(T) == 2) {
    if (D == 16) return fwd_tma<T, 16>(st, q, k, v, g, out, lse, B, S, N, causal, scale);
    if (D == 32) return fwd_tma<T, 32>(st, q, k, v, g, out, lse, B, S, N, causal, scale);
    if (D == 64) return fwd_tma<T, 64>(st, q, k, v, g, out, lse, B, S, N, causal, scale);
    if (D == 128) return fwd_tma<T, 128>(st, q, k, v, g, out, lse, B, S, N, causal, scale);
  }
  const dim3 grid((unsigned)(S / 16), (unsigned)N, (unsigned)B);
#define DSTT_SP_FWD(NI)                                                       \
  sparse_fwd_kernel<T, NI><<<grid, kThreads, 0, st>>>(                        \
      (const T*)q, (const T*)k, (const T*)v, p.idx, p.mid, p.count, p.masks, \
      p.quad, (T*)out, lse, S, N, D, A, causal, scale)
  if (D <= 32) DSTT_SP_FWD(1);
  else if (D <= 64) DSTT_SP_FWD(2);
  else if (D <= 128) DSTT_SP_FWD(4);
  else DSTT_SP_FWD(8);
#undef DSTT_SP_FWD
  return cudaGetLastError();
}

struct Bwd {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  Plan fw, tr;   // the lists and the transposed lists
  const unsigned long long* bits;
  const int* korder;
  void *dq, *dk, *dv;
  float* ws;
  int B, S, N, D, A, At, causal;
  float scale;
};

// ws: the (B, S, N, D) fp32 dq accumulator, then the (B, N, S / 64, 2, 64)
// stats tiles
template <typename T, int D>
cudaError_t fused(cudaStream_t st, const Bwd& a) {
  using C = Tiles<D>;
  const int64_t rows = (int64_t)a.B * a.S * a.N;
  float* acc = a.ws;
  float* stats = acc + rows * D;
  constexpr int L = D / 8;
  flash_bwd_prologue_kernel<T, L>
      <<<(unsigned)((rows * L + 255) / 256), 256, 0, st>>>(
          (const T*)a.o, (const T*)a.dout, a.lse, stats, acc, rows, a.S, a.N,
          D, a.S / kRows);
  CUtensorMap qm, km, vm, om, am;
  constexpr int P = C::P;
  cudaError_t e = head_map<T>(&qm, a.q, a.B, a.S, a.N, D, P, kRows);
  if (e == cudaSuccess) e = head_map<T>(&om, a.dout, a.B, a.S, a.N, D, P, kRows);
  if (e == cudaSuccess) e = head_map<T>(&km, a.k, a.B, a.S, a.N, D, P, kKeys);
  if (e == cudaSuccess) e = head_map<T>(&vm, a.v, a.B, a.S, a.N, D, P, kKeys);
  if (e == cudaSuccess) e = dq_acc_map(&am, acc, a.B, a.S, a.N, D, C::DQN);
  if (e != cudaSuccess) return e;
  auto kern = sparse_bwd_kernel<T, D>;
  static bool smem_set = false;   // per instantiation: above 48 KB, opt in
  if (!smem_set) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const dim3 grid((unsigned)a.N, (unsigned)a.B, (unsigned)(a.S / kKeys));
  kern<<<grid, kFusedThreads, C::SMEM, st>>>(
      qm, km, vm, om, am, stats, a.tr.idx, a.tr.mid, a.tr.count, a.tr.quad,
      a.bits, a.korder, (T*)a.dk, (T*)a.dv, a.S, a.N, a.At, a.causal,
      a.scale);
  const int64_t n8 = rows * D / 8;
  flash_bwd_epilogue_kernel<T><<<(unsigned)((n8 + 255) / 256), 256, 0, st>>>(
      acc, (T*)a.dq, n8, a.scale);
  return cudaGetLastError();
}

// ws: delta (B, N, S) fp32
template <typename T>
cudaError_t core(cudaStream_t st, const Bwd& a) {
  const int64_t rows = (int64_t)a.B * a.S * a.N;
  float* delta = a.ws;
  flash_bwd_prologue_kernel<T, 0><<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      (const T*)a.o, (const T*)a.dout, a.lse, delta, nullptr, rows, a.S, a.N,
      a.D, 0);
  const dim3 grid((unsigned)(a.S / 16), (unsigned)a.N, (unsigned)a.B);
#define DSTT_SP_DQ(NI)                                                        \
  sparse_dq_kernel<T, NI><<<grid, kThreads, 0, st>>>(                         \
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,   \
      delta, a.fw.idx, a.fw.mid, a.fw.count, a.fw.masks, a.fw.quad,           \
      (T*)a.dq, a.S, a.N, a.D, a.A, a.causal, a.scale)
  if (a.D <= 32) DSTT_SP_DQ(1);
  else if (a.D <= 64) DSTT_SP_DQ(2);
  else if (a.D <= 128) DSTT_SP_DQ(4);
  else DSTT_SP_DQ(8);
#undef DSTT_SP_DQ
#define DSTT_SP_DKV(NI)                                                       \
  sparse_dkv_kernel<T, NI><<<grid, kThreads, 0, st>>>(                        \
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,   \
      delta, a.tr.idx, a.tr.mid, a.tr.count, a.tr.masks, a.tr.quad,           \
      (T*)a.dk, (T*)a.dv, a.S, a.N, a.D, a.At, a.causal, a.scale)
  if (a.D <= 32) DSTT_SP_DKV(1);
  else if (a.D <= 64) DSTT_SP_DKV(2);
  else if (a.D <= 128) DSTT_SP_DKV(4);
  else DSTT_SP_DKV(8);
#undef DSTT_SP_DKV
  return cudaGetLastError();
}

template <typename T>
cudaError_t fused_d(cudaStream_t st, const Bwd& a) {
  if (a.D == 16) return fused<T, 16>(st, a);
  if (a.D == 32) return fused<T, 32>(st, a);
  if (a.D == 64) return fused<T, 64>(st, a);
  return fused<T, 128>(st, a);
}

}  // namespace

// The wrappers (ops/block_sparse_attention.py) check every shape, dtype,
// alignment and contiguity and size the workspace; these entry points
// assume S % 128 == 0, D a multiple of 8 and at most 256, and a plan built
// for (N, S). dtype: 0 = float32, 1 = bfloat16, 2 = float16. kidx / mid /
// qidx_t / mid_t: (N, S / 128, width) int32 (width A, or At for the
// transposed lists); kcount / qcount_t: (N, S / 128) int32; masks: (U, 128,
// 128) uint8; quad: (U, 2, 2) uint8, each 64 x 64 quadrant 0 empty, 1 full,
// 2 partial; bits (U, 128, 2) uint64: bit r of bits[m][c][h] is masks[m][64
// h + r][c]; korder (S / 128) int32: the key tiles by falling list length;
// the forward's slots (N, S / 128, smax, 8, 4) int32 and scount (N, S /
// 128) int32 (TilePlan.stage_plan), rowbits (U, 128, 2) uint64: bit c of
// rowbits[m][r][h] is masks[m][r][64 h + c]; qorder (S / 128) int32: the
// q-tiles by falling stage count. lse: (B, N, S) fp32. Each returns the
// first CUDA error of its launches (tensor maps included).
extern "C" int dstt_sparse_fwd(const void* q, const void* k, const void* v,
                               const int* kidx, const int* mid,
                               const int* kcount, const uint8_t* masks,
                               const uint8_t* quad, const int* slots,
                               const int* scount,
                               const unsigned long long* rowbits,
                               const int* qorder, void* out, float* lse,
                               int B, int S, int N, int D, int A, int smax,
                               int causal, float scale, int dtype,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Plan p{kidx, mid, kcount, masks, quad};
  const Stages g{reinterpret_cast<const int4*>(slots), scount, rowbits,
                 qorder, smax};
  if (B <= 0 || S <= 0 || N <= 0) return (int)cudaGetLastError();
  cudaError_t e;
  if (dtype == 0)
    e = fwd_d<float>(st, q, k, v, p, g, out, lse, B, S, N, D, A, causal, scale);
  else if (dtype == 1)
    e = fwd_d<__nv_bfloat16>(st, q, k, v, p, g, out, lse, B, S, N, D, A, causal, scale);
  else
    e = fwd_d<__half>(st, q, k, v, p, g, out, lse, B, S, N, D, A, causal, scale);
  return (int)e;
}

// dq, dk and dv from the forward's lse and o. workspace (fp32): B S N D +
// B N (S / 64) 128 floats (the fused pass, 16-bit D in {16, 32, 64, 128};
// the CUDA-core kernels use the first B N S for delta).
extern "C" int dstt_sparse_bwd(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const float* lse, const int* kidx,
                               const int* mid, const int* kcount,
                               const int* qidx_t, const int* mid_t,
                               const int* qcount_t, const uint8_t* masks,
                               const uint8_t* quad,
                               const unsigned long long* bits,
                               const int* korder, void* dq, void* dk,
                               void* dv, void* workspace, int B, int S,
                               int N, int D, int A, int At, int causal,
                               float scale, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Bwd a{q, k, v, o, dout, lse,
              Plan{kidx, mid, kcount, masks, quad},
              Plan{qidx_t, mid_t, qcount_t, masks, quad},
              bits, korder, dq, dk, dv, (float*)workspace,
              B, S, N, D, A, At, causal, scale};
  if (B <= 0 || S <= 0 || N <= 0) return (int)cudaGetLastError();
  cudaError_t e;
  if (dtype == 0) e = core<float>(st, a);
  else if (!mma_dim(D))
    e = dtype == 1 ? core<__nv_bfloat16>(st, a) : core<__half>(st, a);
  else
    e = dtype == 1 ? fused_d<__nv_bfloat16>(st, a) : fused_d<__half>(st, a);
  return (int)e;
}
