// Block-sparse flash attention for Hopper (sm_90a): forward, dq, and dk / dv
// over a tile plan.
//
// Replaces: deepspeed_tpu/ops/block_sparse_attention.py _sparse_fwd ->
//   _fwd_kernel (pallas_call at :196), and _sparse_bwd -> _bwd_dq_kernel
//   (pallas_call at :325) and _bwd_dkv_kernel (pallas_call at :360).
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
//   forward: s = (q . k) * scale in fp32, online softmax; o = sum p v / l,
//            lse = m + log l; a row that sees no key writes o = 0 and
//            lse = -inf (JAX: 0 and NEG_INF).
//   dq:      p = visible ? exp(s - lse) : 0, ds = p (dout . v - delta),
//            dq = scale * sum ds k.
//   dkv:     dv = sum p^T dout, dk = scale * sum ds^T q over the q-tiles
//            of the transposed list.
// p is SELECTED to 0 where a pair is invisible (a key-less row has
// lse = -inf, where exp(s - lse) would be inf), so such a row contributes
// nothing anywhere. A block walks its list's true length: JAX's padded
// slots (k-tile 0 with the all-zero mask) add exp(-inf) = 0 there and are
// never visited here. There is no grid-step ceiling (JAX's MAX_GRID_STEPS
// is a limit of the TPU's scalar memory): each block reads its own list.
//
// Bound on the H100: at the path's shape (B 2, S 2048, 32 heads of 64,
// bf16) the operations of the active tiles: 4 * D per (query, key) pair of
// an active tile in the forward, 6 * D in dq and 8 * D in dkv, over the
// bf16 tensor-core peak (989 TFLOP/s). DeepSpeed's Fixed layout (block 16)
// makes every causal 128-tile active, so its bound is causal attention's;
// a sliding window skips ~88% of the tiles. Design, bf16 / fp16 with D in
// {16, 32, 64, 128}: the flash kernels' mma.sync m16n8k16 blocking with fp32
// accumulation (csrc/flash_attention*.cu). Forward and dq: one block per
// (64 query rows, head, batch row), 4 warps of 16 rows, K / V sub-tiles of
// 64 (dq with D 128: 32) keys staged in shared memory with the matching
// 64-row slice of the tile's mask; dkv: one block per (64 keys, head, batch
// row), Q / dO sub-tiles staged with their mask slice. A 64 x 64 quadrant
// whose mask is all zero (a per-mask table built on the host) and a
// sub-tile wholly above the causal diagonal are skipped block-uniformly,
// warps wholly above the diagonal skip their products. fp32 and other D:
// the same lists on the CUDA cores (16 rows or keys per block, one lane per
// dims d, d + 32, ...), which keeps fp32 within 2e-5 of the plain version.
// wgmma / TMA, tiles finer than 128 and a fused dq + dkv pass are later
// work.

#include "attention_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 128;            // plan tile edge
constexpr int kTileElems = kTile * kTile;

__device__ __forceinline__ float neg_infinity() { return -__int_as_float(0x7f800000); }

// 16-bit element pairs of the mma accumulators into one register
template <typename T>
__device__ __forceinline__ void store_pair(T* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = Mma<T>::pack(a, b);
}

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
// dq, tensor-core path: grid (S / 64, N, B), 4 warps of 16 query rows; key
// sub-tiles of KT (64 for D <= 64, 32 for D 128: fewer live registers)
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
sparse_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ kidx, const int* __restrict__ mid,
                     const int* __restrict__ kcount,
                     const uint8_t* __restrict__ masks,
                     const uint8_t* __restrict__ quad, T* __restrict__ dq,
                     int S, int N, int A, int causal, float scale) {
  constexpr int KT = D <= 64 ? 64 : 32;
  constexpr int QT = 16 * kWarps;
  constexpr int DP = D + 8;
  constexpr int MP = KT + 16;
  constexpr int NT = KT / 8;
  constexpr int DT = D / 8;
  constexpr int KD = D / 16;
  constexpr int CH = 8;
  __shared__ __align__(16) T ks[KT][DP];
  __shared__ __align__(16) T vs[KT][DP];
  __shared__ __align__(16) uint8_t ms[QT][MP];

  const int nq = S / kTile;
  const int it = blockIdx.x >> 1, qh = blockIdx.x & 1;
  const int n = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * QT;
  const int wlast = q0 + warp * 16 + 15;
  const int64_t rs = (int64_t)N * D;
  const int64_t hb = ((int64_t)b * S * N + n) * D;

  int row[2], rl[2];
  float lrow[2], drow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rl[h] = warp * 16 + grp + 8 * h;
    row[h] = q0 + rl[h];
    const int64_t lo = ((int64_t)b * N + n) * S + row[h];
    lrow[h] = lse[lo];
    drow[h] = delta[lo];
  }
  uint32_t qa[KD][4], da[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int h = j & 1, d = kk * 16 + tig * 2 + (j >> 1) * 8;
      const int64_t off = hb + row[h] * rs + d;
      qa[kk][j] = *reinterpret_cast<const uint32_t*>(q + off);
      da[kk][j] = *reinterpret_cast<const uint32_t*>(dout + off);
    }
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  const int list = n * nq + it;
  const int cnt = kcount[list];
  const int mi = lane >> 3, mr = lane & 7;
  for (int a = 0; a < cnt; ++a) {
    const int j = kidx[list * A + a];
    const int mk = mid[list * A + a];
    for (int sub = 0; sub < kTile / KT; ++sub) {
      const int t0 = j * kTile + sub * KT;
      if (!quad[mk * 4 + qh * 2 + (sub * KT) / 64] ||
          (causal && t0 > q0 + QT - 1)) continue;  // block-uniform
      __syncthreads();
      for (int e = threadIdx.x; e < KT * (D / CH); e += kThreads) {
        const int jr = e / (D / CH), d = (e % (D / CH)) * CH;
        const int64_t off = hb + (t0 + jr) * rs + d;
        *reinterpret_cast<uint4*>(&ks[jr][d]) =
            __ldg(reinterpret_cast<const uint4*>(k + off));
        *reinterpret_cast<uint4*>(&vs[jr][d]) =
            __ldg(reinterpret_cast<const uint4*>(v + off));
      }
      stage_mask<QT, KT, MP>(ms, masks + (int64_t)mk * kTileElems, qh * QT,
                             sub * KT);
      __syncthreads();
      if (causal && t0 > wlast) continue;  // warp-uniform

      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[nt][jj] = dp[nt][jj] = 0.f;
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
        for (int jj = 0; jj < 4; ++jj) {
          const int h = jj >> 1, c = nt * 8 + tig * 2 + (jj & 1);
          const bool on = ms[rl[h]][c] && (!causal || t0 + c <= row[h]);
          const float p = on ? expf(s[nt][jj] * scale - lrow[h]) : 0.f;
          s[nt][jj] = p * (dp[nt][jj] - drow[h]);
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
  }

#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      store_pair(dq + hb + row[h] * rs + dt * 8 + tig * 2,
                 acc[dt][2 * h] * scale, acc[dt][2 * h + 1] * scale);
}

// ---------------------------------------------------------------------------
// dk / dv, tensor-core path: grid (S / 64, N, B), 4 warps of 16 keys; query
// sub-tiles of QT (64 for D <= 64, 32 for D 128) of the transposed list's
// q-tiles
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
sparse_dkv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ qidx, const int* __restrict__ mid,
                      const int* __restrict__ qcount,
                      const uint8_t* __restrict__ masks,
                      const uint8_t* __restrict__ quad, T* __restrict__ dk,
                      T* __restrict__ dv, int S, int N, int At, int causal,
                      float scale) {
  constexpr int QT = D <= 64 ? 64 : 32;
  constexpr int KB = 16 * kWarps;  // keys per block
  constexpr int DP = D + 8;
  constexpr int MP = KB + 16;
  constexpr int NT = QT / 8;       // 8-query tiles of S^T
  constexpr int DT = D / 8;
  constexpr int KD = D / 16;
  constexpr int CH = 8;
  __shared__ __align__(16) T qs[QT][DP];
  __shared__ __align__(16) T os[QT][DP];
  __shared__ float ls[QT], dls[QT];
  __shared__ __align__(16) uint8_t ms[QT][MP];

  const int nk = S / kTile;
  const int jt = blockIdx.x >> 1, kh = blockIdx.x & 1;  // k-tile, its half
  const int n = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int k0 = blockIdx.x * KB;
  const int wfirst = k0 + warp * 16;
  const int64_t rs = (int64_t)N * D;
  const int64_t hb = ((int64_t)b * S * N + n) * D;
  const int64_t lbase = ((int64_t)b * N + n) * S;

  int key[2], kl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    kl[h] = warp * 16 + grp + 8 * h;
    key[h] = k0 + kl[h];
  }
  // A fragments of K and V (key rows grp / grp + 8)
  uint32_t ka[KD][4], va[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int h = j & 1, d = kk * 16 + tig * 2 + (j >> 1) * 8;
      const int64_t off = hb + key[h] * rs + d;
      ka[kk][j] = *reinterpret_cast<const uint32_t*>(k + off);
      va[kk][j] = *reinterpret_cast<const uint32_t*>(v + off);
    }
  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int j = 0; j < 4; ++j) dka[dt][j] = dva[dt][j] = 0.f;

  const int list = n * nk + jt;
  const int cnt = qcount[list];
  const int mi = lane >> 3, mr = lane & 7;
  for (int a = 0; a < cnt; ++a) {
    const int qi = qidx[list * At + a];
    const int mk = mid[list * At + a];  // the q-major tile mask
    for (int sub = 0; sub < kTile / QT; ++sub) {
      const int i0 = qi * kTile + sub * QT;
      // block-uniform: an empty mask quadrant, or every query of the
      // sub-tile before every key of the block
      if (!quad[mk * 4 + ((sub * QT) / 64) * 2 + kh] ||
          (causal && i0 + QT - 1 < k0)) continue;
      __syncthreads();
      for (int e = threadIdx.x; e < QT * (D / CH); e += kThreads) {
        const int r = e / (D / CH), d = (e % (D / CH)) * CH;
        const int64_t off = hb + (i0 + r) * rs + d;
        *reinterpret_cast<uint4*>(&qs[r][d]) =
            __ldg(reinterpret_cast<const uint4*>(q + off));
        *reinterpret_cast<uint4*>(&os[r][d]) =
            __ldg(reinterpret_cast<const uint4*>(dout + off));
      }
      if (threadIdx.x < QT) {
        ls[threadIdx.x] = lse[lbase + i0 + threadIdx.x];
        dls[threadIdx.x] = delta[lbase + i0 + threadIdx.x];
      }
      // rows: the sub-tile's queries; columns: this block's 64 keys
      stage_mask<QT, KB, MP>(ms, masks + (int64_t)mk * kTileElems, sub * QT,
                             kh * KB);
      __syncthreads();
      if (causal && i0 + QT - 1 < wfirst) continue;  // warp-uniform

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
      // P^T (into st) and dS^T (into dpt); rows are keys, columns queries;
      // the mask is read q-major: ms[query][key]
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int h = j >> 1, c = nt * 8 + tig * 2 + (j & 1);
          const bool on = ms[c][kl[h]] && (!causal || key[h] <= i0 + c);
          const float p = on ? expf(st[nt][j] * scale - ls[c]) : 0.f;
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

#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int64_t off = hb + key[h] * rs + dt * 8 + tig * 2;
      store_pair(dk + off, dka[dt][2 * h] * scale, dka[dt][2 * h + 1] * scale);
      store_pair(dv + off, dva[dt][2 * h], dva[dt][2 * h + 1]);
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
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, S, N, D, A, causal;
  float scale;
};

template <typename T>
void dq_d(cudaStream_t st, const Bwd& a, const Plan& p, void* dq) {
  if constexpr (sizeof(T) == 2) {
    if (mma_dim(a.D)) {
      const dim3 grid((unsigned)(a.S / 64), (unsigned)a.N, (unsigned)a.B);
#define DSTT_SP_DQ_MMA(DD)                                                    \
  sparse_dq_mma_kernel<T, DD><<<grid, kThreads, 0, st>>>(                     \
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,   \
      a.delta, p.idx, p.mid, p.count, p.masks, p.quad, (T*)dq, a.S, a.N, a.A, \
      a.causal, a.scale)
      if (a.D == 16) DSTT_SP_DQ_MMA(16);
      else if (a.D == 32) DSTT_SP_DQ_MMA(32);
      else if (a.D == 64) DSTT_SP_DQ_MMA(64);
      else DSTT_SP_DQ_MMA(128);
#undef DSTT_SP_DQ_MMA
      return;
    }
  }
  const dim3 grid((unsigned)(a.S / 16), (unsigned)a.N, (unsigned)a.B);
#define DSTT_SP_DQ(NI)                                                        \
  sparse_dq_kernel<T, NI><<<grid, kThreads, 0, st>>>(                         \
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,   \
      a.delta, p.idx, p.mid, p.count, p.masks, p.quad, (T*)dq, a.S, a.N, a.D, \
      a.A, a.causal, a.scale)
  if (a.D <= 32) DSTT_SP_DQ(1);
  else if (a.D <= 64) DSTT_SP_DQ(2);
  else if (a.D <= 128) DSTT_SP_DQ(4);
  else DSTT_SP_DQ(8);
#undef DSTT_SP_DQ
}

template <typename T>
void dkv_d(cudaStream_t st, const Bwd& a, const Plan& p, void* dk, void* dv) {
  if constexpr (sizeof(T) == 2) {
    if (mma_dim(a.D)) {
      const dim3 grid((unsigned)(a.S / 64), (unsigned)a.N, (unsigned)a.B);
#define DSTT_SP_DKV_MMA(DD)                                                   \
  sparse_dkv_mma_kernel<T, DD><<<grid, kThreads, 0, st>>>(                    \
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,   \
      a.delta, p.idx, p.mid, p.count, p.masks, p.quad, (T*)dk, (T*)dv, a.S,   \
      a.N, a.A, a.causal, a.scale)
      if (a.D == 16) DSTT_SP_DKV_MMA(16);
      else if (a.D == 32) DSTT_SP_DKV_MMA(32);
      else if (a.D == 64) DSTT_SP_DKV_MMA(64);
      else DSTT_SP_DKV_MMA(128);
#undef DSTT_SP_DKV_MMA
      return;
    }
  }
  const dim3 grid((unsigned)(a.S / 16), (unsigned)a.N, (unsigned)a.B);
#define DSTT_SP_DKV(NI)                                                       \
  sparse_dkv_kernel<T, NI><<<grid, kThreads, 0, st>>>(                        \
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,   \
      a.delta, p.idx, p.mid, p.count, p.masks, p.quad, (T*)dk, (T*)dv, a.S,   \
      a.N, a.D, a.A, a.causal, a.scale)
  if (a.D <= 32) DSTT_SP_DKV(1);
  else if (a.D <= 64) DSTT_SP_DKV(2);
  else if (a.D <= 128) DSTT_SP_DKV(4);
  else DSTT_SP_DKV(8);
#undef DSTT_SP_DKV
}

}  // namespace

// The wrapper (ops/block_sparse_attention.py) checks every shape, dtype,
// alignment and contiguity; these entry points assume S % 128 == 0, D a
// multiple of 8 and at most 256, and a plan built for (N, S). dtype:
// 0 = float32, 1 = bfloat16, 2 = float16. idx / mid: (N, S / 128, width)
// int32 (width = A, or At for the transposed lists); count: (N, S / 128)
// int32; masks: (U, 128, 128) uint8; quad: (U, 2, 2) uint8. lse / delta:
// (B, N, S) fp32. Each returns cudaGetLastError() after its launch.
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

extern "C" int dstt_sparse_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, const int* kidx,
                                  const int* mid, const int* kcount,
                                  const uint8_t* masks, const uint8_t* quad,
                                  void* dq, int B, int S, int N, int D, int A,
                                  int causal, float scale, int dtype,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Bwd a{q, k, v, dout, lse, delta, B, S, N, D, A, causal, scale};
  const Plan p{kidx, mid, kcount, masks, quad};
  if (B > 0 && S > 0 && N > 0) {
    if (dtype == 0) dq_d<float>(st, a, p, dq);
    else if (dtype == 1) dq_d<__nv_bfloat16>(st, a, p, dq);
    else dq_d<__half>(st, a, p, dq);
  }
  return (int)cudaGetLastError();
}

extern "C" int dstt_sparse_bwd_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse,
                                   const float* delta, const int* qidx_t,
                                   const int* mid_t, const int* qcount_t,
                                   const uint8_t* masks, const uint8_t* quad,
                                   void* dk, void* dv, int B, int S, int N,
                                   int D, int At, int causal, float scale,
                                   int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Bwd a{q, k, v, dout, lse, delta, B, S, N, D, At, causal, scale};
  const Plan p{qidx_t, mid_t, qcount_t, masks, quad};
  if (B > 0 && S > 0 && N > 0) {
    if (dtype == 0) dkv_d<float>(st, a, p, dk, dv);
    else if (dtype == 1) dkv_d<__nv_bfloat16>(st, a, p, dk, dv);
    else dkv_d<__half>(st, a, p, dk, dv);
  }
  return (int)cudaGetLastError();
}
