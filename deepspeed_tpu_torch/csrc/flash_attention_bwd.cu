// Flash-attention backward for Hopper (sm_90a): dq, and dk / dv.
//
// Replaces: deepspeed_tpu/ops/flash_attention.py _bwd -> _bwd_dq_kernel
//   (pallas_call at :286) and _bwd_dkv_kernel (pallas_call at :311).
//
// What it computes (the FA2 recompute backward of flash_attention.cu's
// forward, same conventions): q / dout (B, S, N, D), k / v (B, T, K, D),
// query head n reads KV head n / G (G = N / K). Query row i sees key j when
// j < T, mask[b, j] != 0 (mask optional) and, if causal, j <= i (0-based).
// From the forward's lse (B, N, S) and delta = rowsum(dout * o) (B, N, S),
// both fp32:
//   p_ij  = visible ? exp(scale * q_i . k_j + slope[n] * j - lse_i) : 0
//   ds_ij = p_ij * (dout_i . v_j - delta_i)
//   dq_i  = scale * sum_j ds_ij k_j
//   dk_j  = scale * sum_{i, n in group} ds_ij q_i,  dv_j = sum_{i, n} p_ij dout_i
// p is SELECTED to 0 for an invisible pair (a row that sees no key has
// lse = -inf, where exp(s - lse) would be inf), and masked keys are staged
// as zeros, so a stale or non-finite value never reaches an output. dk / dv
// of a masked key are 0. GQA: the dkv block of a KV head loops over its G
// query heads itself, so every dk / dv row is written by one block and no
// atomics or partial buffers are needed.
//
// Bound on the H100: at the training shape of OPT-1.3B (B 4, S = T 1024, 32
// heads of 64, causal, bf16) each kernel reads q, k, v, dout and writes its
// outputs (~84 MB, ~25 us at 3.35 TB/s); dq does 6 * D operations per
// visible pair (S, dP, dQ) and dkv 8 * D (S, dP, dV, dK), 26 and 34 us at
// the bf16 tensor-core peak. Design, bf16 / fp16 with D in {16, 32, 64,
// 128}: the forward's mma.sync m16n8k16 blocking with fp32 accumulation.
// flash_bwd_dq_mma_kernel: one block per (64 query rows, head, batch row),
// 4 warps of 16 rows; Q and dO fragments in registers, K / V tiles staged in
// shared memory (padded rows, ldmatrix), S = Q K^T and dP = dO V^T, then
// dQ += dS K with K read transposed. flash_bwd_dkv_mma_kernel: one block per
// (64 keys, KV head, batch row), 4 warps of 16 keys; K and V fragments in
// registers, Q / dO tiles staged, S^T = K Q^T and dP^T = V dO^T, then
// dV += P^T dO and dK += dS^T Q. Causal tiles wholly above the diagonal are
// skipped, and key tiles whose keys are all masked. fp32 and other D: the
// same blocking on the CUDA cores (16 rows or keys per block, one lane per
// dims d, d + 32, ..., warp-shuffle dot products), which keeps fp32 within
// 2e-5 of the plain version. wgmma / TMA pipelines are for later changes.

#include "attention_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// 16-bit element pairs of the mma accumulators, scaled, into one register
template <typename T>
__device__ __forceinline__ void store_pair(T* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = Mma<T>::pack(a, b);
}

// ---------------------------------------------------------------------------
// dq, tensor-core path: grid (ceil(S / 64), N, B), 4 warps of 16 query rows;
// key tiles of KT (64 for D <= 64, 32 for D 128: fewer live registers).
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ mask,
                        const float* __restrict__ alibi, T* __restrict__ dq,
                        int S, int Tk, int N, int K, int causal,
                        float scale) {
  constexpr int KT = D <= 64 ? 64 : 32;
  constexpr int QT = 16 * kWarps;
  constexpr int DP = D + 8;        // padded row: conflict-free ldmatrix
  constexpr int NT = KT / 8;       // 8-key tiles of S
  constexpr int DT = D / 8;        // 8-dim tiles of dQ
  constexpr int KD = D / 16;       // 16-dim steps of Q K^T
  constexpr int CH = 8;            // 16-bit elements per 16-byte load
  __shared__ __align__(16) T ks[KT][DP];
  __shared__ __align__(16) T vs[KT][DP];
  __shared__ int kval[KT];

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int n = blockIdx.y, b = blockIdx.z;
  const int kh = n / (N / K);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int q0 = qt * QT;
  const int kend = causal ? min(Tk, min(q0 + QT, S)) : Tk;
  const int wlast = min(q0 + warp * 16 + 15, S - 1);
  const float slope = alibi != nullptr ? alibi[n] : 0.f;
  const T* kb0 = k + ((int64_t)b * Tk * K + kh) * D;
  const T* vb0 = v + ((int64_t)b * Tk * K + kh) * D;

  int row[2];
  bool rv[2];
  int64_t qo[2];
  float lrow[2], drow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = q0 + warp * 16 + grp + 8 * h;
    rv[h] = row[h] < S;
    qo[h] = rv[h] ? (((int64_t)b * S + row[h]) * N + n) * D : 0;
    const int64_t lo = ((int64_t)b * N + n) * S + row[h];
    lrow[h] = rv[h] ? lse[lo] : 0.f;
    drow[h] = rv[h] ? delta[lo] : 0.f;
  }

  // A fragments of Q and dO (row grp / grp + 8, dims tig * 2)
  uint32_t qa[KD][4], da[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int h = j & 1, d = kk * 16 + tig * 2 + (j >> 1) * 8;
      qa[kk][j] = rv[h] ? *reinterpret_cast<const uint32_t*>(q + qo[h] + d)
                        : 0u;
      da[kk][j] = rv[h] ? *reinterpret_cast<const uint32_t*>(dout + qo[h] + d)
                        : 0u;
    }

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row
  for (int t0 = 0; t0 < kend; t0 += KT) {
    __syncthreads();  // the previous tile is consumed
    int live = 0;
    if (threadIdx.x < KT) {
      const int col = t0 + threadIdx.x;
      live = col < kend &&
             (mask == nullptr || mask[(int64_t)b * Tk + col] != 0);
      kval[threadIdx.x] = live;
    }
    if (!__syncthreads_or(live)) continue;  // block-uniform: all masked
    for (int e = threadIdx.x; e < KT * (D / CH); e += kThreads) {
      const int j = e / (D / CH), d = (e % (D / CH)) * CH;
      uint4 rk = make_uint4(0u, 0u, 0u, 0u), rvv = rk;
      if (kval[j]) {
        const int64_t off = (int64_t)(t0 + j) * K * D + d;
        rk = __ldg(reinterpret_cast<const uint4*>(kb0 + off));
        rvv = __ldg(reinterpret_cast<const uint4*>(vb0 + off));
      }
      *reinterpret_cast<uint4*>(&ks[j][d]) = rk;
      *reinterpret_cast<uint4*>(&vs[j][d]) = rvv;
    }
    __syncthreads();
    // warp-uniform: no row of this warp sees a key of this tile
    if (q0 + warp * 16 >= S || (causal && t0 > wlast)) continue;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = dp[nt][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kb[4], vb[4];
        const int r = (np * 2 + (mi >> 1)) * 8 + mr, c = kk * 16 + (mi & 1) * 8;
        ldsm_x4(kb, &ks[r][c]);
        Mma<T>::run(s[np * 2], qa[kk], kb[0], kb[1]);
        Mma<T>::run(s[np * 2 + 1], qa[kk], kb[2], kb[3]);
        ldsm_x4(vb, &vs[r][c]);
        Mma<T>::run(dp[np * 2], da[kk], vb[0], vb[1]);
        Mma<T>::run(dp[np * 2 + 1], da[kk], vb[2], vb[3]);
      }
    // ds = p * (dp - delta), p selected to 0 where the pair is invisible
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int h = j >> 1, c = nt * 8 + tig * 2 + (j & 1), col = t0 + c;
        const bool vis = rv[h] && kval[c] && (!causal || col <= row[h]);
        const float p = vis ? expf(s[nt][j] * scale + slope * (float)col -
                                   lrow[h])
                            : 0.f;
        s[nt][j] = p * (dp[nt][j] - drow[h]);
      }
    // dQ += dS K
#pragma unroll
    for (int k2 = 0; k2 < KT / 16; ++k2) {
      const uint32_t sa[4] = {
          Mma<T>::pack(s[2 * k2][0], s[2 * k2][1]),
          Mma<T>::pack(s[2 * k2][2], s[2 * k2][3]),
          Mma<T>::pack(s[2 * k2 + 1][0], s[2 * k2 + 1][1]),
          Mma<T>::pack(s[2 * k2 + 1][2], s[2 * k2 + 1][3])};
#pragma unroll
      for (int dp2 = 0; dp2 < DT / 2; ++dp2) {
        uint32_t kb[4];
        ldsm_x4_t(kb, &ks[k2 * 16 + (mi & 1) * 8 + mr][(dp2 * 2 + (mi >> 1)) * 8]);
        Mma<T>::run(acc[dp2 * 2], sa, kb[0], kb[1]);
        Mma<T>::run(acc[dp2 * 2 + 1], sa, kb[2], kb[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!rv[h]) continue;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      store_pair(dq + qo[h] + dt * 8 + tig * 2, acc[dt][2 * h] * scale,
                 acc[dt][2 * h + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// dk / dv, tensor-core path: grid (ceil(T / 64), K, B), 4 warps of 16 keys;
// query tiles of QT (64 for D <= 64, 32 for D 128) over the G query heads of
// the KV head.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ mask,
                         const float* __restrict__ alibi, T* __restrict__ dk,
                         T* __restrict__ dv, int S, int Tk, int N, int K,
                         int causal, float scale) {
  constexpr int QT = D <= 64 ? 64 : 32;
  constexpr int KB = 16 * kWarps;  // keys per block
  constexpr int DP = D + 8;
  constexpr int NT = QT / 8;       // 8-query tiles of S^T
  constexpr int DT = D / 8;
  constexpr int KD = D / 16;
  constexpr int CH = 8;
  __shared__ __align__(16) T qs[QT][DP];
  __shared__ __align__(16) T os[QT][DP];
  __shared__ float ls[QT], dls[QT];

  const int kh = blockIdx.y, b = blockIdx.z;
  const int G = N / K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int k0 = blockIdx.x * KB;
  const int wfirst = k0 + warp * 16;

  int key[2];
  bool kv[2];
  int64_t ko[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    key[h] = wfirst + grp + 8 * h;
    kv[h] = key[h] < Tk &&
            (mask == nullptr || mask[(int64_t)b * Tk + key[h]] != 0);
    ko[h] = key[h] < Tk ? (((int64_t)b * Tk + key[h]) * K + kh) * D : 0;
  }
  // A fragments of K and V (key rows grp / grp + 8); masked keys read as 0
  uint32_t ka[KD][4], va[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int h = j & 1, d = kk * 16 + tig * 2 + (j >> 1) * 8;
      ka[kk][j] = kv[h] ? *reinterpret_cast<const uint32_t*>(k + ko[h] + d)
                        : 0u;
      va[kk][j] = kv[h] ? *reinterpret_cast<const uint32_t*>(v + ko[h] + d)
                        : 0u;
    }
  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int j = 0; j < 4; ++j) dka[dt][j] = dva[dt][j] = 0.f;

  const bool warp_live = __any_sync(0xffffffffu, kv[0] || kv[1]);
  const int mi = lane >> 3, mr = lane & 7;
  // block-uniform: a key tile with no live key writes zeros
  if (__syncthreads_or(kv[0] || kv[1])) {
    const int qstart = causal ? (k0 / QT) * QT : 0;
    for (int hg = 0; hg < G; ++hg) {
      const int n = kh * G + hg;
      const float slope = alibi != nullptr ? alibi[n] : 0.f;
      const int64_t lbase = ((int64_t)b * N + n) * S;
      for (int i0 = qstart; i0 < S; i0 += QT) {
        __syncthreads();  // the previous tile is consumed
        for (int e = threadIdx.x; e < QT * (D / CH); e += kThreads) {
          const int r = e / (D / CH), d = (e % (D / CH)) * CH, i = i0 + r;
          uint4 rq = make_uint4(0u, 0u, 0u, 0u), ro = rq;
          if (i < S) {
            const int64_t off = (((int64_t)b * S + i) * N + n) * D + d;
            rq = __ldg(reinterpret_cast<const uint4*>(q + off));
            ro = __ldg(reinterpret_cast<const uint4*>(dout + off));
          }
          *reinterpret_cast<uint4*>(&qs[r][d]) = rq;
          *reinterpret_cast<uint4*>(&os[r][d]) = ro;
        }
        if (threadIdx.x < QT) {
          const int i = i0 + threadIdx.x;
          ls[threadIdx.x] = i < S ? lse[lbase + i] : 0.f;
          dls[threadIdx.x] = i < S ? delta[lbase + i] : 0.f;
        }
        __syncthreads();
        // warp-uniform: no key of this warp is seen by a query of the tile
        if (!warp_live || (causal && i0 + QT - 1 < wfirst)) continue;

        float st[NT][4], dpt[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) st[nt][j] = dpt[nt][j] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t qb[4], ob[4];
            const int r = (np * 2 + (mi >> 1)) * 8 + mr, c = kk * 16 + (mi & 1) * 8;
            ldsm_x4(qb, &qs[r][c]);
            Mma<T>::run(st[np * 2], ka[kk], qb[0], qb[1]);
            Mma<T>::run(st[np * 2 + 1], ka[kk], qb[2], qb[3]);
            ldsm_x4(ob, &os[r][c]);
            Mma<T>::run(dpt[np * 2], va[kk], ob[0], ob[1]);
            Mma<T>::run(dpt[np * 2 + 1], va[kk], ob[2], ob[3]);
          }
        // P^T (into st) and dS^T (into dpt); rows are keys, columns queries
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int h = j >> 1, c = nt * 8 + tig * 2 + (j & 1), i = i0 + c;
            const bool vis = kv[h] && i < S && (!causal || key[h] <= i);
            const float p = vis ? expf(st[nt][j] * scale +
                                       slope * (float)key[h] - ls[c])
                                : 0.f;
            st[nt][j] = p;
            dpt[nt][j] = p * (dpt[nt][j] - dls[c]);
          }
        // dV += P^T dO, dK += dS^T Q
#pragma unroll
        for (int k2 = 0; k2 < QT / 16; ++k2) {
          const uint32_t pa[4] = {
              Mma<T>::pack(st[2 * k2][0], st[2 * k2][1]),
              Mma<T>::pack(st[2 * k2][2], st[2 * k2][3]),
              Mma<T>::pack(st[2 * k2 + 1][0], st[2 * k2 + 1][1]),
              Mma<T>::pack(st[2 * k2 + 1][2], st[2 * k2 + 1][3])};
          const uint32_t sa[4] = {
              Mma<T>::pack(dpt[2 * k2][0], dpt[2 * k2][1]),
              Mma<T>::pack(dpt[2 * k2][2], dpt[2 * k2][3]),
              Mma<T>::pack(dpt[2 * k2 + 1][0], dpt[2 * k2 + 1][1]),
              Mma<T>::pack(dpt[2 * k2 + 1][2], dpt[2 * k2 + 1][3])};
#pragma unroll
          for (int dp2 = 0; dp2 < DT / 2; ++dp2) {
            const int r = k2 * 16 + (mi & 1) * 8 + mr, c = (dp2 * 2 + (mi >> 1)) * 8;
            uint32_t ob[4], qb[4];
            ldsm_x4_t(ob, &os[r][c]);
            Mma<T>::run(dva[dp2 * 2], pa, ob[0], ob[1]);
            Mma<T>::run(dva[dp2 * 2 + 1], pa, ob[2], ob[3]);
            ldsm_x4_t(qb, &qs[r][c]);
            Mma<T>::run(dka[dp2 * 2], sa, qb[0], qb[1]);
            Mma<T>::run(dka[dp2 * 2 + 1], sa, qb[2], qb[3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= Tk) continue;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      store_pair(dk + ko[h] + dt * 8 + tig * 2, dka[dt][2 * h] * scale,
                 dka[dt][2 * h + 1] * scale);
      store_pair(dv + ko[h] + dt * 8 + tig * 2, dva[dt][2 * h],
                 dva[dt][2 * h + 1]);
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
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const int* mask;
  const float* alibi;
  int B, S, T, N, K, D, causal;
  float scale;
};

bool mma_dim(int D) { return D == 16 || D == 32 || D == 64 || D == 128; }

template <typename T>
void dq_d(cudaStream_t st, const Args& a, void* dq) {
  if constexpr (sizeof(T) == 2) {
    if (mma_dim(a.D)) {
      const dim3 grid((unsigned)((a.S + 63) / 64), (unsigned)a.N, (unsigned)a.B);
#define DSTT_DQ_MMA(DD)                                                        \
  flash_bwd_dq_mma_kernel<T, DD><<<grid, kThreads, 0, st>>>(                   \
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,    \
      a.delta, a.mask, a.alibi, (T*)dq, a.S, a.T, a.N, a.K, a.causal, a.scale)
      if (a.D == 16) DSTT_DQ_MMA(16);
      else if (a.D == 32) DSTT_DQ_MMA(32);
      else if (a.D == 64) DSTT_DQ_MMA(64);
      else DSTT_DQ_MMA(128);
#undef DSTT_DQ_MMA
      return;
    }
  }
  const dim3 grid((unsigned)((a.S + 15) / 16), (unsigned)a.N, (unsigned)a.B);
#define DSTT_DQ(NI)                                                            \
  flash_bwd_dq_kernel<T, NI><<<grid, kThreads, 0, st>>>(                       \
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,    \
      a.delta, a.mask, a.alibi, (T*)dq, a.S, a.T, a.N, a.K, a.D, a.causal,     \
      a.scale)
  if (a.D <= 32) DSTT_DQ(1);
  else if (a.D <= 64) DSTT_DQ(2);
  else if (a.D <= 128) DSTT_DQ(4);
  else DSTT_DQ(8);
#undef DSTT_DQ
}

template <typename T>
void dkv_d(cudaStream_t st, const Args& a, void* dk, void* dv) {
  if constexpr (sizeof(T) == 2) {
    if (mma_dim(a.D)) {
      const dim3 grid((unsigned)((a.T + 63) / 64), (unsigned)a.K, (unsigned)a.B);
#define DSTT_DKV_MMA(DD)                                                       \
  flash_bwd_dkv_mma_kernel<T, DD><<<grid, kThreads, 0, st>>>(                  \
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,    \
      a.delta, a.mask, a.alibi, (T*)dk, (T*)dv, a.S, a.T, a.N, a.K, a.causal,  \
      a.scale)
      if (a.D == 16) DSTT_DKV_MMA(16);
      else if (a.D == 32) DSTT_DKV_MMA(32);
      else if (a.D == 64) DSTT_DKV_MMA(64);
      else DSTT_DKV_MMA(128);
#undef DSTT_DKV_MMA
      return;
    }
  }
  const dim3 grid((unsigned)((a.T + 15) / 16), (unsigned)a.K, (unsigned)a.B);
#define DSTT_DKV(NI)                                                           \
  flash_bwd_dkv_kernel<T, NI><<<grid, kThreads, 0, st>>>(                      \
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,    \
      a.delta, a.mask, a.alibi, (T*)dk, (T*)dv, a.S, a.T, a.N, a.K, a.D,       \
      a.causal, a.scale)
  if (a.D <= 32) DSTT_DKV(1);
  else if (a.D <= 64) DSTT_DKV(2);
  else if (a.D <= 128) DSTT_DKV(4);
  else DSTT_DKV(8);
#undef DSTT_DKV
}

}  // namespace

// The wrapper (ops/flash_attention.py) checks every shape, dtype, alignment
// and contiguity; these entry points assume N % K == 0 and D <= 256.
// dtype: 0 = float32, 1 = bfloat16, 2 = float16. lse / delta: (B, N, S)
// fp32; mask: (B, T) int32 or null; alibi: (N,) fp32 or null. Each returns
// cudaGetLastError() after its launch.
extern "C" int dstt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, const int* mask,
                                 const float* alibi, void* dq, int B, int S,
                                 int T, int N, int K, int D, int causal,
                                 float scale, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Args a{q, k, v, dout, lse, delta, mask, alibi, B, S, T, N, K, D,
               causal, scale};
  if (B > 0 && S > 0 && N > 0) {
    if (dtype == 0) dq_d<float>(st, a, dq);
    else if (dtype == 1) dq_d<__nv_bfloat16>(st, a, dq);
    else dq_d<__half>(st, a, dq);
  }
  return (int)cudaGetLastError();
}

extern "C" int dstt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, const int* mask,
                                  const float* alibi, void* dk, void* dv,
                                  int B, int S, int T, int N, int K, int D,
                                  int causal, float scale, int dtype,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Args a{q, k, v, dout, lse, delta, mask, alibi, B, S, T, N, K, D,
               causal, scale};
  if (B > 0 && T > 0 && K > 0) {
    if (dtype == 0) dkv_d<float>(st, a, dk, dv);
    else if (dtype == 1) dkv_d<__nv_bfloat16>(st, a, dk, dv);
    else dkv_d<__half>(st, a, dk, dv);
  }
  return (int)cudaGetLastError();
}
