// Flash-attention backward for Hopper (sm_90a): dq, dk and dv in one call.
//
// Replaces: deepspeed_tpu/ops/flash_attention.py _bwd -> _bwd_dq_kernel
//   (pallas_call at :286) and _bwd_dkv_kernel (pallas_call at :311).
//
// What it computes (the FA2 recompute backward of flash_attention.cu's
// forward, same conventions): q / o / dout (B, S, N, D), k / v (B, T, K, D),
// query head n reads KV head n / G (G = N / K). Query row i sees key j when
// j < T, mask[b, j] != 0 (mask optional) and, if causal, j <= i (0-based).
// From the forward's lse (B, N, S) fp32 and delta_i = rowsum(dout_i * o_i):
//   p_ij  = visible ? exp(scale * q_i . k_j + slope[n] * j - lse_i) : 0
//   ds_ij = visible ? p_ij * (dout_i . v_j - delta_i) : 0
//   dq_i  = scale * sum_j ds_ij k_j
//   dk_j  = scale * sum_{i, n in group} ds_ij q_i,  dv_j = sum_{i, n} p_ij dout_i
// p and ds are SELECTED to 0 on an invisible pair (a row that sees no key has
// lse = -inf, where exp(s - lse) would be inf), and masked keys' K / V rows
// are zeroed before any product, so a stale or non-finite value never
// reaches an output (0 * NaN). dk / dv of a masked key are exactly 0.
//
// Bound on the H100: 10 D operations per visible pair (S^T, dP^T, dV, dK,
// dQ: five products of 2 D) and the bytes of q, k, v, o, dout and lse read
// once and dq, dk, dv written once. At OPT-1.3B's training shape (B 4, S = T
// 1024, 32 heads of 64, causal, bf16: 67.2 M visible pairs) 4.30e10
// operations, 43.5 us at the bf16 tensor-core peak, and ~135 MB, 40 us at
// 3.35 TB/s.
//
// Design, bf16 / fp16 with D in {16, 32, 64, 128}: three launches.
// 1. flash_bwd_prologue_kernel (attention_bwd.cuh, shared with the
//    block-sparse backward): delta (fp32) and lse * log2(e) of every
//    query row, into (B, N, ceil(S / 64), 2, 64) tiles of 64 rows that one
//    bulk copy brings, and the row of the fp32 dq accumulator (B, S, N, D)
//    zeroed. One pass over o and dout: the plain-torch delta it replaces
//    took four launches and ~270 MB.
// 2. flash_bwd_kernel, KV-outer, one pass (FA2 / FA3's backward): grid (KV
//    heads, batch, key tiles of 128), the key tile slowest, so the heaviest
//    causal tiles (the first: they see every later query) are dispatched
//    first. Two consumer warpgroups own 64 keys each (the wgmma M) and keep
//    their dK / dV accumulators in registers the whole time; one thread of
//    a producer warpgroup, whose registers go to the consumers (setmaxnreg
//    24 / 240), issues TMA: the block's K and V tiles once, then for each of
//    the G query heads of the KV head and each 64-row query tile from the
//    causal start, Q, dO and the tile's lse / delta through a ring of
//    kStages stages counted on mbarriers (full: bytes arrived; empty: every
//    consumer warp done). Tiles are stored in panels of at most 64 columns,
//    each row one swizzle span (128 B for D >= 64, else 2 D bytes), as the
//    TMA map's swizzle writes them and the wgmma descriptors read them.
//    Per tile:
//    * S^T = K Q^T and dP^T = V dO^T: wgmma m64n64k16, A and B K-major in
//      shared memory; for D <= 64 issued while the previous tile's dV, dK
//      and dQ products still run.
//    * P^T = exp2(s * scale * log2e + slope * j * log2e - lse * log2e)
//      (ex2.approx) and dS^T = P^T (dP^T - delta) in fp32 registers;
//      predicates only on tiles that straddle the diagonal, hold a masked
//      key or reach the ragged edge, where p and ds are selected to 0.
//    * dV += P^T dO and dK += dS^T Q: wgmma m64nDk16 with A from registers
//      (the fp32 accumulator layout packs into the 16-bit A fragment) and B
//      MN-major in shared memory (the transpose bit).
//    * dS^T to shared memory (one of two buffers, 128-byte swizzle), a
//      barrier of the two warpgroups, then dQ_part = dS K over the 128 keys:
//      each warpgroup takes half of D, A = dS MN-major, B = K MN-major. Its
//      part goes to shared memory (one of two buffers a warpgroup) and one
//      TMA tensor reduce-add a 64 x 32 box puts it into the accumulator (in
//      L2: with 128-key tiles ~151 MB of fp32 reductions at the training
//      shape into 33.5 MB that the 50 MB L2 holds), where 16-byte atomics
//      from every thread were slower.
//    Masked keys' K / V rows are zeroed in shared memory when they arrive
//    (TMA cannot skip rows; rows past T arrive as zeros).
//    Branches a thread takes alone (its lane, its row), between two wgmma
//    pipelines, make the compiler serialize every wgmma (ptxas C7518): the
//    warpgroup index and the tile-wide flags are shuffled from one lane,
//    and every product has retired before the per-thread dK / dV stores.
// 3. flash_bwd_epilogue_kernel: dq = scale * accumulator, in the input type.
// dk and dv are written once per key by their block, so they are identical
// from run to run; dq's fp32 sums are taken in the order the reductions
// land, which may change from run to run (a few fp32 ulps of the sum before
// its one rounding to the input type).
// fp32, and 16-bit D outside {16, 32, 64, 128}: the prologue writes delta
// (B, N, S), then the CUDA-core kernels below (16 query rows or keys per
// block, one lane per dims d, d + 32, ..., warp-shuffle dot products),
// which keep fp32 within 2e-5 of the plain version.

#include "attention_bwd.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// ---------------------------------------------------------------------------
// the fused pass (16-bit, D in {16, 32, 64, 128}); see the note above. Its
// block shape and shared-memory plan (Tiles<D>) are in attention_bwd.cuh.
// ---------------------------------------------------------------------------

// grid (K, B, ceil(T / kKeys)), block kFusedThreads, dynamic shared memory
// Tiles<D>::SMEM. Maps (TMA, tiles of Tiles<D>::P columns): q / dout (D, N,
// S, B) in boxes of (P, 1, kRows, 1), k / v (D, K, T, B) in boxes of (P, 1,
// kKeys, 1); amap: the fp32 dq accumulator (D, N, S, B), zeroed, in boxes
// of (DQN, 1, kRows, 1). stats: the prologue's tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kFusedThreads, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap omap,
                 const __grid_constant__ CUtensorMap amap,
                 const float* __restrict__ stats,
                 const int* __restrict__ mask,
                 const float* __restrict__ alibi, T* __restrict__ dk,
                 T* __restrict__ dv, int S, int Tk, int N, int K, int causal,
                 float scale) {
  using C = Tiles<D>;
  constexpr int P = C::P, SW = C::SW;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t kv_bar, full[kStages], empty[kStages];
  uint8_t* ks = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* vs = ks + C::KV;
  uint8_t* qs = vs + C::KV;                  // stage st at qs + st * QO
  uint8_t* os = qs + kStages * C::QO;        // dO, likewise
  uint8_t* dss = os + kStages * C::QO;       // dS^T buffers
  uint8_t* dqs = dss + 2 * C::DS;            // dQ buffers [wg][2][DQC]
  float* sts = reinterpret_cast<float*>(dqs + 4 * C::DQC * C::DQB);  // stats

  const int kh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kKeys;
  const int G = N / K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the warpgroup as a value the compiler sees is warp-uniform (one lane's,
  // shuffled): wgmma under a branch it cannot prove uniform is serialized
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const bool producer = wg == kConsumers / 128;
  const int wi = warp & 3, g = lane >> 2, t = lane & 3;
  const int nqt = (S + kRows - 1) / kRows;
  const int qt0 = causal ? k0 / kRows : 0;

  // this thread's two keys: rows g and g + 8 of its warp's 16
  int key[2];
  bool live[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key[r] = k0 + 64 * wg + 16 * wi + g + 8 * r;
    live[r] = !producer && key[r] < Tk &&
              (mask == nullptr || mask[(int64_t)b * Tk + key[r]] != 0);
  }
  if (tid == 0) {
    mbar_init(&kv_bar, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumers / 32);
    }
    fence_barrier_init();
  }
  // block-uniform: a tile with no live key, or no query to see it, only
  // writes zeros
  const bool any_live = __syncthreads_or(live[0] || live[1]);
  const bool all_live = __syncthreads_and(producer || (live[0] && live[1]));
  const bool work =
      __shfl_sync(0xffffffffu, (int)(any_live && qt0 < nqt), 0) != 0;

  if (producer) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (tid == kConsumers && work) {
      mbar_expect_tx(&kv_bar, 2 * C::KV);
      for (int p = 0; p < D / P; ++p) {
        tma_load_4d(ks + p * kKeys * SW, &kmap, p * P, kh, k0, b, &kv_bar);
        tma_load_4d(vs + p * kKeys * SW, &vmap, p * P, kh, k0, b, &kv_bar);
      }
      int it = 0;
      for (int hg = 0; hg < G; ++hg) {
        const int n = kh * G + hg;
        for (int qt = qt0; qt < nqt; ++qt, ++it) {
          const int st = it % kStages;
          if (it >= kStages) mbar_wait(&empty[st], (it / kStages - 1) & 1);
          mbar_expect_tx(&full[st], C::STAGE);
          for (int p = 0; p < D / P; ++p) {
            tma_load_4d(qs + st * C::QO + p * kRows * SW, &qmap, p * P, n,
                        qt * kRows, b, &full[st]);
            tma_load_4d(os + st * C::QO + p * kRows * SW, &omap, p * P, n,
                        qt * kRows, b, &full[st]);
          }
          bulk_load(sts + st * kStat,
                    stats + (((int64_t)b * N + n) * nqt + qt) * kStat,
                    kStat * 4, &full[st]);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  if (work) {
    const float scale2 = scale * kLog2e;
    mbar_wait(&kv_bar, 0);
    if (!all_live && mask != nullptr) {
      // this warpgroup's masked keys: their K / V rows to zero, 16 bytes a
      // thread (the swizzle permutes bytes within a row only)
      for (int e = tid & 127; e < 64 * (D / 8); e += 128) {
        const int r = 64 * wg + e / (D / 8), c = e % (D / 8), j = k0 + r;
        if (j < Tk && mask[(int64_t)b * Tk + j] == 0) {
          const int off =
              (c / (P / 8)) * kKeys * SW + r * SW + (c % (P / 8)) * 16;
          *reinterpret_cast<uint4*>(ks + off) = make_uint4(0u, 0u, 0u, 0u);
          *reinterpret_cast<uint4*>(vs + off) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      fence_proxy_async();
      named_barrier(2 + wg, 128);
    }

    // tile it: query head kh * G + it / ntq, query tile qt0 + it % ntq.
    // S^T / dP^T of tile it + 1 are issued before the wait for tile it's
    // dV, dK and dQ products (D <= 64: registers allow both), so the tensor
    // cores run them while this tile's dQ part goes out.
    constexpr bool kAhead = D <= 64;
    const int ntq = nqt - qt0, total = G * ntq;
    float s[32], dp[32];
    // K-major descriptor of k16 step kk of a tile of `rows` rows (panels of
    // P columns), from row r0
    auto kdesc = [&](const uint8_t* tile, int rows, int r0, int kk) {
      return wgmma_desc<SW>(tile + (kk * 16 / P) * rows * SW + r0 * SW +
                                (kk * 16 % P) * 2,
                            16, 8 * SW);
    };
    // S^T = K Q^T, dP^T = V dO^T of tile `it` (64 keys x 64 queries each),
    // two commit groups
    auto issue_sdp = [&](int it) {
      const int st = it % kStages;
      const uint8_t* qst = qs + st * C::QO;
      const uint8_t* ost = os + st * C::QO;
      mbar_wait(&full[st], (it / kStages) & 1);
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
    if (total > 0) issue_sdp(0);
    for (int it = 0; it < total; ++it) {
      const int st = it % kStages;
      const int n = kh * G + it / ntq, i0 = (qt0 + it % ntq) * kRows;
      const uint8_t* qst = qs + st * C::QO;
      const uint8_t* ost = os + st * C::QO;
      const float* ls = sts + st * kStat;   // lse * log2(e)
      const float* dl = ls + kRows;         // delta
      const float slope = alibi != nullptr ? alibi[n] * kLog2e : 0.f;
      const float kb[2] = {slope * (float)key[0], slope * (float)key[1]};

      // P^T and dS^T = P^T (dP^T - delta), one pair of columns at a time,
      // packed to 16 bits as the A fragments of dV / dK's products; p and ds
      // selected to 0 where the pair is invisible (tested only on tiles that
      // are not whole: uniform over the warpgroup)
      const bool whole =
          __shfl_sync(0xffffffffu, (int)(all_live && i0 + kRows <= S &&
                                         (!causal || k0 + 64 * wg + 63 <= i0)),
                      0) != 0;
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int r = (e >> 1) & 1, col = 8 * (e >> 2) + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
        const float2 d2 = *reinterpret_cast<const float2*>(dl + col);
        float p0 = fast_exp2(fmaf(s[e], scale2, kb[r] - l2.x));
        float p1 = fast_exp2(fmaf(s[e + 1], scale2, kb[r] - l2.y));
        float ds0 = p0 * (dp[e] - d2.x), ds1 = p1 * (dp[e + 1] - d2.y);
        if (!whole) {
          const int i = i0 + col;
          const bool v0 = live[r] && i < S && (!causal || key[r] <= i);
          const bool v1 = live[r] && i + 1 < S && (!causal || key[r] <= i + 1);
          p0 = v0 ? p0 : 0.f;
          ds0 = v0 ? ds0 : 0.f;
          p1 = v1 ? p1 : 0.f;
          ds1 = v1 ? ds1 : 0.f;
        }
        pa[e >> 3][(e >> 1) & 3] = Mma<T>::pack(p0, p1);
        da[e >> 3][(e >> 1) & 3] = Mma<T>::pack(ds0, ds1);
      }

      // dV += P^T dO, dK += dS^T Q (k16 steps over the tile's queries)
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

      // dS^T into this tile's buffer: key row kr, 128-byte rows, 16-byte
      // chunk j of a row at j ^ (kr % 8)
      uint8_t* dsb = dss + (it & 1) * C::DS;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kr = 64 * wg + 16 * wi + g + 8 * r;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(dsb + kr * 128 + ((j ^ (kr & 7)) << 4) +
                                       4 * t) = da[j >> 1][(j & 1) * 2 + r];
      }
      fence_proxy_async();
      // this warpgroup's dQ buffer of tile it - 2 has been read out
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
      const bool more = it + 1 < total;
      if (kAhead && more) {
        issue_sdp(it + 1);
        wgmma_wait<2>();
      } else {
        wgmma_wait<0>();
      }
      // every product reading this stage is done
      fence_regs(dka);
      fence_regs(dva);
      fence_regs(pa);
      fence_regs(da);
#pragma unroll
      for (int c = 0; c < C::DQC; ++c) fence_regs(dqa[c]);
      if (lane == 0) mbar_arrive(&empty[st]);
      // into the fp32 accumulator: each chunk (64 rows x DQN columns) into
      // this tile's buffer, rows of DQN * 4 bytes swizzled as its TMA map,
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
      if (!kAhead && more) issue_sdp(it + 1);
    }
  }
  // nothing in flight past here (the stores below branch per thread), and
  // the dQ reductions complete before the block's shared memory goes
  wgmma_wait<0>();
  if ((tid & 127) == 0) bulk_wait<0>();
  fence_regs(dka);
  fence_regs(dva);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= Tk) continue;
    const int64_t ko = (((int64_t)b * Tk + key[r]) * K + kh) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      store_pair(dk + ko + 8 * j, dka[4 * j + 2 * r] * scale,
                 dka[4 * j + 2 * r + 1] * scale);
      store_pair(dv + ko + 8 * j, dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// dq, CUDA-core path (fp32, and 16-bit rows of other D): grid (ceil(S / 16),
// N, B), 4 warps of 4 query rows; lane i holds dims i, i + 32, ...
// ---------------------------------------------------------------------------
template <typename T, int NI>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ mask,
                    const float* __restrict__ alibi, T* __restrict__ dq,
                    int S, int Tk, int N, int K, int D, int causal,
                    float scale) {
  constexpr int RPW = 4;
  constexpr int QT = RPW * kWarps;
  constexpr int KT = NI <= 4 ? 32 : 16;
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

  float qr[RPW][NI], dr[RPW][NI], acc[RPW][NI], lr[RPW], dl[RPW];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = q0 + warp * RPW + rr;
    const int64_t qo = (((int64_t)b * S + r) * N + n) * D;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      const bool ok = r < S && d < D;
      qr[rr][i] = ok ? to_f(q[qo + d]) : 0.f;
      dr[rr][i] = ok ? to_f(dout[qo + d]) : 0.f;
      acc[rr][i] = 0.f;
    }
    const int64_t lo = ((int64_t)b * N + n) * S + r;
    lr[rr] = r < S ? lse[lo] : 0.f;
    dl[rr] = r < S ? delta[lo] : 0.f;
  }

  for (int t0 = 0; t0 < kend; t0 += KT) {
    __syncthreads();
    int live = 0;
    if (threadIdx.x < KT) {
      const int col = t0 + threadIdx.x;
      live = col < kend &&
             (mask == nullptr || mask[(int64_t)b * Tk + col] != 0);
      kval[threadIdx.x] = live;
    }
    if (!__syncthreads_or(live)) continue;
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
      for (int j = 0; j < KT; ++j) {
        float dot = 0.f, dpv = 0.f;
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          dot += qr[rr][i] * ks[j][lane + 32 * i];
          dpv += dr[rr][i] * vs[j][lane + 32 * i];
        }
        dot = warp_sum(dot);
        dpv = warp_sum(dpv);
        const int col = t0 + j;
        const bool vis = kval[j] && (!causal || col <= r);
        const float p = vis ? expf(dot * scale + slope * (float)col - lr[rr])
                            : 0.f;
        const float ds = p * (dpv - dl[rr]);
#pragma unroll
        for (int i = 0; i < NI; ++i) acc[rr][i] += ds * ks[j][lane + 32 * i];
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = q0 + warp * RPW + rr;
    if (r >= S) continue;
    const int64_t qo = (((int64_t)b * S + r) * N + n) * D;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (d < D) dq[qo + d] = from_f<T>(acc[rr][i] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// dk / dv, CUDA-core path: grid (ceil(T / 16), K, B), 4 warps of 4 keys;
// query tiles of QT staged as fp32 over the G query heads of the KV head.
// ---------------------------------------------------------------------------
template <typename T, int NI>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ mask,
                     const float* __restrict__ alibi, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int Tk, int N, int K, int D,
                     int causal, float scale) {
  constexpr int KPW = 4;
  constexpr int KB = KPW * kWarps;
  constexpr int QT = NI <= 4 ? 32 : 16;
  constexpr int DM = NI * 32;
  __shared__ float qs[QT][DM];
  __shared__ float os[QT][DM];
  __shared__ float ls[QT], dls[QT];

  const int kh = blockIdx.y, b = blockIdx.z;
  const int G = N / K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = blockIdx.x * KB;

  int key[KPW];
  bool kv[KPW];
  float kr[KPW][NI], vr[KPW][NI], dka[KPW][NI], dva[KPW][NI];
  bool any = false;
#pragma unroll
  for (int rr = 0; rr < KPW; ++rr) {
    key[rr] = k0 + warp * KPW + rr;
    kv[rr] = key[rr] < Tk &&
             (mask == nullptr || mask[(int64_t)b * Tk + key[rr]] != 0);
    any = any || kv[rr];
    const int64_t ko = (((int64_t)b * Tk + key[rr]) * K + kh) * D;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      const bool ok = kv[rr] && d < D;
      kr[rr][i] = ok ? to_f(k[ko + d]) : 0.f;
      vr[rr][i] = ok ? to_f(v[ko + d]) : 0.f;
      dka[rr][i] = dva[rr][i] = 0.f;
    }
  }

  if (__syncthreads_or(any)) {  // block-uniform
    const int qstart = causal ? (k0 / QT) * QT : 0;
    for (int hg = 0; hg < G; ++hg) {
      const int n = kh * G + hg;
      const float slope = alibi != nullptr ? alibi[n] : 0.f;
      const int64_t lbase = ((int64_t)b * N + n) * S;
      for (int i0 = qstart; i0 < S; i0 += QT) {
        __syncthreads();
        for (int e = threadIdx.x; e < QT * DM; e += kThreads) {
          const int r = e / DM, d = e % DM, i = i0 + r;
          const bool ok = i < S && d < D;
          const int64_t off = (((int64_t)b * S + i) * N + n) * D + d;
          qs[r][d] = ok ? to_f(q[off]) : 0.f;
          os[r][d] = ok ? to_f(dout[off]) : 0.f;
        }
        if (threadIdx.x < QT) {
          const int i = i0 + threadIdx.x;
          ls[threadIdx.x] = i < S ? lse[lbase + i] : 0.f;
          dls[threadIdx.x] = i < S ? delta[lbase + i] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int rr = 0; rr < KPW; ++rr) {
          // warp-uniform: the key is dead or no query of the tile sees it
          if (!kv[rr] || (causal && i0 + QT - 1 < key[rr])) continue;
          for (int c = 0; c < QT; ++c) {
            float dot = 0.f, dpv = 0.f;
#pragma unroll
            for (int i = 0; i < NI; ++i) {
              dot += qs[c][lane + 32 * i] * kr[rr][i];
              dpv += os[c][lane + 32 * i] * vr[rr][i];
            }
            dot = warp_sum(dot);
            dpv = warp_sum(dpv);
            const int i = i0 + c;
            const bool vis = i < S && (!causal || key[rr] <= i);
            const float p = vis ? expf(dot * scale +
                                       slope * (float)key[rr] - ls[c])
                                : 0.f;
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
  }

#pragma unroll
  for (int rr = 0; rr < KPW; ++rr) {
    if (key[rr] >= Tk) continue;
    const int64_t ko = (((int64_t)b * Tk + key[rr]) * K + kh) * D;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (d < D) {
        dk[ko + d] = from_f<T>(dka[rr][i] * scale);
        dv[ko + d] = from_f<T>(dva[rr][i]);
      }
    }
  }
}


struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  const int* mask;
  const float* alibi;
  void *dq, *dk, *dv;
  float* ws;
  int B, S, T, N, K, D, causal;
  float scale;
};

bool fused_dim(int D) { return D == 16 || D == 32 || D == 64 || D == 128; }

// ws: the (B, S, N, D) fp32 dq accumulator, then the (B, N, ceil(S / 64),
// 2, 64) stats tiles
template <typename T, int D>
cudaError_t fused(cudaStream_t st, const Args& a) {
  using C = Tiles<D>;
  const int nqt = (a.S + kRows - 1) / kRows;
  const int64_t rows = (int64_t)a.B * a.S * a.N;
  float* acc = a.ws;
  float* stats = acc + rows * D;
  if (rows > 0) {
    constexpr int L = D / 8;
    flash_bwd_prologue_kernel<T, L>
        <<<(unsigned)((rows * L + 255) / 256), 256, 0, st>>>(
            (const T*)a.o, (const T*)a.dout, a.lse, stats, acc, rows, a.S,
            a.N, D, nqt);
  }
  CUtensorMap qm, km, vm, om, am;
  constexpr int P = C::P;
  cudaError_t e = head_map<T>(&qm, a.q, a.B, a.S, a.N, D, P, kRows);
  if (e == cudaSuccess) e = head_map<T>(&om, a.dout, a.B, a.S, a.N, D, P, kRows);
  if (e == cudaSuccess) e = head_map<T>(&km, a.k, a.B, a.T, a.K, D, P, kKeys);
  if (e == cudaSuccess) e = head_map<T>(&vm, a.v, a.B, a.T, a.K, D, P, kKeys);
  if (e == cudaSuccess) e = dq_acc_map(&am, acc, a.B, a.S, a.N, D, C::DQN);
  if (e != cudaSuccess) return e;
  auto kern = flash_bwd_kernel<T, D>;
  static bool smem_set = false;   // per instantiation: above 48 KB, opt in
  if (!smem_set) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const dim3 grid((unsigned)a.K, (unsigned)a.B,
                  (unsigned)((a.T + kKeys - 1) / kKeys));
  kern<<<grid, kFusedThreads, C::SMEM, st>>>(
      qm, km, vm, om, am, stats, a.mask, a.alibi, (T*)a.dk, (T*)a.dv, a.S,
      a.T, a.N, a.K, a.causal, a.scale);
  if (rows > 0) {
    const int64_t n8 = rows * D / 8;
    flash_bwd_epilogue_kernel<T><<<(unsigned)((n8 + 255) / 256), 256, 0, st>>>(
        acc, (T*)a.dq, n8, a.scale);
  }
  return cudaGetLastError();
}

// ws: delta (B, N, S) fp32
template <typename T>
cudaError_t core(cudaStream_t st, const Args& a) {
  const int64_t rows = (int64_t)a.B * a.S * a.N;
  float* delta = a.ws;
  if (rows > 0) {
    flash_bwd_prologue_kernel<T, 0>
        <<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
            (const T*)a.o, (const T*)a.dout, a.lse, delta, nullptr, rows,
            a.S, a.N, a.D, 0);
    const dim3 grid((unsigned)((a.S + 15) / 16), (unsigned)a.N, (unsigned)a.B);
#define DSTT_DQ(NI)                                                            \
  flash_bwd_dq_kernel<T, NI><<<grid, kThreads, 0, st>>>(                       \
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,    \
      delta, a.mask, a.alibi, (T*)a.dq, a.S, a.T, a.N, a.K, a.D, a.causal,     \
      a.scale)
    if (a.D <= 32) DSTT_DQ(1);
    else if (a.D <= 64) DSTT_DQ(2);
    else if (a.D <= 128) DSTT_DQ(4);
    else DSTT_DQ(8);
#undef DSTT_DQ
  }
  const dim3 grid((unsigned)((a.T + 15) / 16), (unsigned)a.K, (unsigned)a.B);
#define DSTT_DKV(NI)                                                           \
  flash_bwd_dkv_kernel<T, NI><<<grid, kThreads, 0, st>>>(                      \
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,    \
      delta, a.mask, a.alibi, (T*)a.dk, (T*)a.dv, a.S, a.T, a.N, a.K, a.D,     \
      a.causal, a.scale)
  if (a.D <= 32) DSTT_DKV(1);
  else if (a.D <= 64) DSTT_DKV(2);
  else if (a.D <= 128) DSTT_DKV(4);
  else DSTT_DKV(8);
#undef DSTT_DKV
  return cudaGetLastError();
}

template <typename T>
cudaError_t fused_d(cudaStream_t st, const Args& a) {
  if (a.D == 16) return fused<T, 16>(st, a);
  if (a.D == 32) return fused<T, 32>(st, a);
  if (a.D == 64) return fused<T, 64>(st, a);
  return fused<T, 128>(st, a);
}

}  // namespace

// The wrapper (ops/flash_attention.py) checks every shape, dtype, alignment
// and contiguity and sizes the workspace; this entry point assumes N % K ==
// 0, D <= 256 and 16-byte aligned rows. dtype: 0 = float32, 1 = bfloat16, 2
// = float16. q / o / dout / dq (B, S, N, D), k / v / dk / dv (B, T, K, D);
// lse (B, N, S) fp32 from the forward; mask (B, T) int32 or null; alibi
// (N,) fp32 or null. workspace (fp32): B S N D + B N ceil(S / 64) 128
// floats (the fused pass, 16-bit D in {16, 32, 64, 128}; the CUDA-core
// kernels use the first B N S).
// Returns the first CUDA error of the launches (tensor maps included).
extern "C" int dstt_flash_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const float* lse, const int* mask,
                              const float* alibi, void* dq, void* dk,
                              void* dv, void* workspace, int B, int S, int T,
                              int N, int K, int D, int causal, float scale,
                              int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Args a{q, k, v, o, dout, lse, mask, alibi, dq, dk, dv,
               (float*)workspace, B, S, T, N, K, D, causal, scale};
  if (B <= 0 || T <= 0 || K <= 0) return (int)cudaGetLastError();
  cudaError_t e;
  if (dtype == 0) e = core<float>(st, a);
  else if (!fused_dim(D))
    e = dtype == 1 ? core<__nv_bfloat16>(st, a) : core<__half>(st, a);
  else
    e = dtype == 1 ? fused_d<__nv_bfloat16>(st, a) : fused_d<__half>(st, a);
  return (int)e;
}
