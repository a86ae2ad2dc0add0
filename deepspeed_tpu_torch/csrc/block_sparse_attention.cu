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
// Forward, bf16 / fp16 with D in {16, 32, 64, 128}: the flash kernels'
// mma.sync m16n8k16 blocking with fp32 accumulation: one block per (64
// query rows, head, batch row), 4 warps of 16 rows, K / V sub-tiles of 64
// keys staged in shared memory with the matching 64-row slice of the
// tile's mask. A 64 x 64 quadrant whose mask is all zero and a sub-tile
// wholly above the causal diagonal are skipped block-uniformly.
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

// mask bytes of rows [r0, r0 + ROWS) and columns [c0, c0 + COLS) of one
// 128 x 128 mask into shared rows of MP bytes (16-byte copies)
template <int ROWS, int COLS, int MP>
__device__ __forceinline__ void stage_mask(uint8_t (*dst)[MP],
                                           const uint8_t* __restrict__ mask,
                                           int r0, int c0) {
  for (int e = threadIdx.x; e < ROWS * (COLS / 16); e += kThreads) {
    const int r = e / (COLS / 16), c = (e % (COLS / 16)) * 16;
    *reinterpret_cast<uint4*>(&dst[r][c]) = __ldg(
        reinterpret_cast<const uint4*>(mask + (r0 + r) * kTile + c0 + c));
  }
}

// ---------------------------------------------------------------------------
// forward, tensor-core path: grid (S / 64, N, B), 4 warps of 16 query rows
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
sparse_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ kidx,
                      const int* __restrict__ mid,
                      const int* __restrict__ kcount,
                      const uint8_t* __restrict__ masks,
                      const uint8_t* __restrict__ quad, T* __restrict__ out,
                      float* __restrict__ lse, int S, int N, int A,
                      int causal, float scale) {
  constexpr int KT = 64;          // keys per sub-tile
  constexpr int QT = 16 * kWarps; // query rows per block
  constexpr int DP = D + 8;       // padded row: conflict-free ldmatrix
  constexpr int MP = KT + 16;     // padded mask row (bytes)
  constexpr int NT = KT / 8;
  constexpr int DT = D / 8;
  constexpr int KD = D / 16;
  constexpr int CH = 8;           // 16-bit elements per 16-byte load
  __shared__ __align__(16) T ks[KT][DP];
  __shared__ __align__(16) T vs[KT][DP];
  __shared__ __align__(16) uint8_t ms[QT][MP];

  const int nq = S / kTile;
  const int it = blockIdx.x >> 1, qh = blockIdx.x & 1;  // q-tile, its half
  const int n = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * QT;
  const int wlast = q0 + warp * 16 + 15;   // the warp's last row
  const int64_t rs = (int64_t)N * D;       // row stride
  const int64_t hb = ((int64_t)b * S * N + n) * D;  // (b, row 0, head n)

  int row[2], rl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rl[h] = warp * 16 + grp + 8 * h;
    row[h] = q0 + rl[h];
  }
  uint32_t qa[KD][4];  // A fragments of Q (row grp / grp + 8, dims tig * 2)
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int h = j & 1, d = kk * 16 + tig * 2 + (j >> 1) * 8;
      qa[kk][j] = *reinterpret_cast<const uint32_t*>(q + hb + row[h] * rs + d);
    }

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const int list = n * nq + it;
  const int cnt = kcount[list];
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row
  for (int a = 0; a < cnt; ++a) {
    const int j = kidx[list * A + a];
    const int mk = mid[list * A + a];
    for (int kh = 0; kh < kTile / KT; ++kh) {
      const int t0 = j * kTile + kh * KT;
      // block-uniform: the quadrant's mask is empty, or every key is past
      // every row of the block
      if (!quad[mk * 4 + qh * 2 + kh] || (causal && t0 > q0 + QT - 1)) continue;
      __syncthreads();  // the previous sub-tile is consumed
      for (int e = threadIdx.x; e < KT * (D / CH); e += kThreads) {
        const int jr = e / (D / CH), d = (e % (D / CH)) * CH;
        const int64_t off = hb + (t0 + jr) * rs + d;
        *reinterpret_cast<uint4*>(&ks[jr][d]) =
            __ldg(reinterpret_cast<const uint4*>(k + off));
        *reinterpret_cast<uint4*>(&vs[jr][d]) =
            __ldg(reinterpret_cast<const uint4*>(v + off));
      }
      stage_mask<QT, KT, MP>(ms, masks + (int64_t)mk * kTileElems, qh * QT,
                             kh * KT);
      __syncthreads();
      if (causal && t0 > wlast) continue;  // warp-uniform

      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t kb[4];
          ldsm_x4(kb, &ks[(np * 2 + (mi >> 1)) * 8 + mr][kk * 16 + (mi & 1) * 8]);
          Mma<T>::run(s[np * 2], qa[kk], kb[0], kb[1]);
          Mma<T>::run(s[np * 2 + 1], qa[kk], kb[2], kb[3]);
        }

      uint32_t vis = 0;  // bit nt * 4 + j: the pair is visible
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int h = jj >> 1, c = nt * 8 + tig * 2 + (jj & 1);
          const bool on = ms[rl[h]][c] && (!causal || t0 + c <= row[h]);
          vis |= (uint32_t)on << (nt * 4 + jj);
          const float x = on ? s[nt][jj] * scale : kNegInf;
          s[nt][jj] = x;
          mx[h] = fmaxf(mx[h], x);
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
        for (int jj = 0; jj < 4; ++jj) {
          const int h = jj >> 1;
          const float p = (vis >> (nt * 4 + jj)) & 1u ? expf(s[nt][jj] - m[h]) : 0.f;
          s[nt][jj] = p;
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
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      store_pair(out + hb + row[h] * rs + dt * 8 + tig * 2, o[dt][2 * h] * inv,
                 o[dt][2 * h + 1] * inv);
    if (tig == 0)
      lse[((int64_t)b * N + n) * S + row[h]] =
          l[h] > 0.f ? m[h] + logf(l[h]) : neg_infinity();
  }
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

template <typename T>
void fwd_d(cudaStream_t st, const void* q, const void* k, const void* v,
           const Plan& p, void* out, float* lse, int B, int S, int N, int D,
           int A, int causal, float scale) {
  if constexpr (sizeof(T) == 2) {
    if (mma_dim(D)) {
      const dim3 grid((unsigned)(S / 64), (unsigned)N, (unsigned)B);
#define DSTT_SP_FWD_MMA(DD)                                                   \
  sparse_fwd_mma_kernel<T, DD><<<grid, kThreads, 0, st>>>(                    \
      (const T*)q, (const T*)k, (const T*)v, p.idx, p.mid, p.count, p.masks, \
      p.quad, (T*)out, lse, S, N, A, causal, scale)
      if (D == 16) DSTT_SP_FWD_MMA(16);
      else if (D == 32) DSTT_SP_FWD_MMA(32);
      else if (D == 64) DSTT_SP_FWD_MMA(64);
      else DSTT_SP_FWD_MMA(128);
#undef DSTT_SP_FWD_MMA
      return;
    }
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
// h + r][c]; korder (S / 128) int32: the key tiles by falling list length.
// lse: (B, N, S) fp32. Each returns the first CUDA error of its launches
// (tensor maps included).
extern "C" int dstt_sparse_fwd(const void* q, const void* k, const void* v,
                               const int* kidx, const int* mid,
                               const int* kcount, const uint8_t* masks,
                               const uint8_t* quad, void* out, float* lse,
                               int B, int S, int N, int D, int A, int causal,
                               float scale, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Plan p{kidx, mid, kcount, masks, quad};
  if (B > 0 && S > 0 && N > 0) {
    if (dtype == 0)
      fwd_d<float>(st, q, k, v, p, out, lse, B, S, N, D, A, causal, scale);
    else if (dtype == 1)
      fwd_d<__nv_bfloat16>(st, q, k, v, p, out, lse, B, S, N, D, A, causal, scale);
    else
      fwd_d<__half>(st, q, k, v, p, out, lse, B, S, N, D, A, causal, scale);
  }
  return (int)cudaGetLastError();
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
