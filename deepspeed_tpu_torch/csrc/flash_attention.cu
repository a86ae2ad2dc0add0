// Flash-attention forward for Hopper (sm_90a) over dense q / k / v.
//
// Replaces: deepspeed_tpu/ops/flash_attention.py flash_attention -> _fwd /
//   _fwd_kernel (pallas_call at :135), forward only; the backward (:286,
//   :311) belongs to the training slice and will read the lse written here.
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
// predicate) and their k / v rows are staged as zeros, so a stale or
// non-finite arena slot never reaches the output; the ragged S and T edges
// are masked here, nothing is padded.
//
// Bound on the H100: the larger of its bytes (q, o, and K / V of the key
// columns some query sees, over 3.35 TB/s) and its 4 * D operations per
// visible (query, key) pair and head over the bf16 tensor-core peak (989
// TFLOP/s). At the static prefill of llama-7b (S 512, T 1024, 8 rows of
// 64..500 tokens, 32 heads) both are tens of microseconds, the bytes a
// little larger. Design, bf16 / fp16 with D in {16, 32, 64, 128}:
// flash_fwd_mma_kernel, one block per (q tile of 64 rows, query head, batch
// row), 4 warps of 16 query rows; S = Q K^T and O += P V on mma.sync
// m16n8k16 tiles with fp32 accumulation; K / V tiles of 64 keys staged in
// shared memory (rows padded by 8 elements so ldmatrix is conflict-free),
// Q fragments straight from global memory; only key tiles up to the q
// tile's causal diagonal are visited, a tile whose keys are all masked is
// skipped, and the q tiles with the most work are scheduled first. fp32 and
// other D: flash_fwd_kernel, the same blocking with 16 query rows per block
// on the CUDA cores (a warp-shuffle reduction per (query, key) pair), which
// keeps fp32 within 2e-5 of the plain version. wgmma / TMA pipelines and
// split-K are for later changes.
//
// Head dims above 256 (the SD v1.5 VAE mid block's single head of D 512,
// non-causal over 4096 tokens; bound 0.139 ms at B 4 on the tensor cores):
// the kernel above keeps a warp's O accumulator (16 rows x D) and its Q
// fragments in registers, 256 + 128 a lane at D 512, over the 255 limit,
// and its 64-key K / V tiles would need 130 KB of shared memory. So
// flash_fwd_wide_kernel (bf16 / fp16, 256 < D <= 512, D % 8 == 0) splits
// O's D across the block's warps instead of its rows: one block of 8 warps
// per (q tile of 32 rows, query head, batch row) stages Q (32 x 512), a K
// and a V tile of 32 keys and the tile's P (32 x 32) in ~102 KB of dynamic
// shared memory (two blocks an SM). Each warp computes one 16 x 8 tile of
// S = Q K^T over all of D (ldmatrix of Q and K, mma.sync); the row maxima
// and sums of the four key slices meet in shared memory, where one thread
// a row keeps the running max, sum and correction; P goes to shared memory
// as the input type; then each warp updates its 64 columns of O for all 32
// rows (2 x 8 m16n8 tiles, 64 fp32 registers a lane) from P and V. fp32,
// and 16-bit dims that are not a multiple of 8, run the CUDA-core kernel
// with 16 dims a lane, 2 rows a warp and 8-key tiles (32 KB of static
// shared memory). The backward kernels stop at D 256.

#include "attention_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float neg_infinity() { return -__int_as_float(0x7f800000); }

// ---------------------------------------------------------------------------
// tensor-core path: grid (ceil(S / 64), N, B), block 4 warps.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ mask,
                     const float* __restrict__ alibi, T* __restrict__ out,
                     float* __restrict__ lse, int S, int Tk, int N, int K,
                     int causal, float scale) {
  constexpr int KT = 64;          // keys per shared-memory tile
  constexpr int QT = 16 * kWarps; // query rows per block
  constexpr int DP = D + 8;       // padded row: conflict-free ldmatrix
  constexpr int NT = KT / 8;      // 8-key tiles of S
  constexpr int DT = D / 8;       // 8-dim tiles of O
  constexpr int KD = D / 16;      // 16-dim steps of Q K^T
  constexpr int CH = 8;           // 16-bit elements per 16-byte load
  __shared__ __align__(16) T ks[KT][DP];
  __shared__ __align__(16) T vs[KT][DP];
  __shared__ int kval[KT];

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int n = blockIdx.y, b = blockIdx.z;
  const int kh = n / (N / K);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int q0 = qt * QT;
  // keys the block may see: causal rows stop at the tile's last row
  const int kend = causal ? min(Tk, min(q0 + QT, S)) : Tk;
  const int wlast = min(q0 + warp * 16 + 15, S - 1);  // the warp's last row
  const float slope = alibi != nullptr ? alibi[n] : 0.f;
  const T* kb0 = k + ((int64_t)b * Tk * K + kh) * D;
  const T* vb0 = v + ((int64_t)b * Tk * K + kh) * D;

  // this thread's two query rows: grp and grp + 8 of the warp's 16
  int row[2];
  bool rv[2];
  int64_t qo[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = q0 + warp * 16 + grp + 8 * h;
    rv[h] = row[h] < S;
    qo[h] = rv[h] ? (((int64_t)b * S + row[h]) * N + n) * D : 0;
  }

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

  for (int t0 = 0; t0 < kend; t0 += KT) {
    __syncthreads();  // the previous tile is consumed
    int live = 0;
    if (threadIdx.x < KT) {
      const int col = t0 + threadIdx.x;
      live = col < kend && (mask == nullptr || mask[(int64_t)b * Tk + col] != 0);
      kval[threadIdx.x] = live;
    }
    if (!__syncthreads_or(live)) continue;  // block-uniform: all keys masked
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

    // vis: the key is live and, if causal, not past the row
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int h = j >> 1, c = nt * 8 + tig * 2 + (j & 1), col = t0 + c;
        const bool vis = rv[h] && kval[c] && (!causal || col <= row[h]);
        const float x = vis ? s[nt][j] * scale + slope * (float)col : kNegInf;
        s[nt][j] = x;
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
      for (int j = 0; j < 4; ++j) {
        const int h = j >> 1, c = nt * 8 + tig * 2 + (j & 1), col = t0 + c;
        const bool vis = rv[h] && kval[c] && (!causal || col <= row[h]);
        const float p = vis ? expf(s[nt][j] - m[h]) : 0.f;
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
    if (lse != nullptr && tig == 0)
      lse[((int64_t)b * N + n) * S + row[h]] =
          l[h] > 0.f ? m[h] + logf(l[h]) : neg_infinity();
  }
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

// ---------------------------------------------------------------------------
// wide tensor-core path (bf16 / fp16, 256 < D <= 512, D % 8 == 0): grid
// (ceil(S / 32), N, B), block 8 warps, dynamic shared memory.
// ---------------------------------------------------------------------------
constexpr int kWideWarps = 8;
constexpr int kWideThreads = kWideWarps * 32;
constexpr int kWideD = 512;           // head dims staged (zeros past D)
constexpr int kWideQT = 32;           // query rows per block
constexpr int kWideKT = 32;           // keys per tile
constexpr int kWideOD = kWideD / kWideWarps;  // O columns per warp

template <typename T>
struct WideSmem {
  T qs[kWideQT][kWideD + 8];          // rows padded: conflict-free ldmatrix
  T ks[kWideKT][kWideD + 8];
  T vs[kWideKT][kWideD + 8];
  T ps[kWideQT][kWideKT + 8];         // P of the tile, the input type
  float pmax[kWideKT / 8][kWideQT];   // per key slice: row max, row sum
  float psum[kWideKT / 8][kWideQT];
  float m[kWideQT], l[kWideQT], corr[kWideQT];  // running row state
  int kval[kWideKT];
};

template <typename T>
__global__ void __launch_bounds__(kWideThreads, 2)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ mask,
                      const float* __restrict__ alibi, T* __restrict__ out,
                      float* __restrict__ lse, int S, int Tk, int N, int K,
                      int D, int causal, float scale) {
  constexpr int QT = kWideQT, KT = kWideKT, DM = kWideD;
  constexpr int CH = 8;               // 16-bit elements per 16-byte load
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WideSmem<T>& sm = *reinterpret_cast<WideSmem<T>*>(smem_raw);

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int n = blockIdx.y, b = blockIdx.z;
  const int kh = n / (N / K);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;    // ldmatrix: matrix, row
  const int q0 = qt * QT;
  const int kend = causal ? min(Tk, min(q0 + QT, S)) : Tk;
  const float slope = alibi != nullptr ? alibi[n] : 0.f;
  const T* kb0 = k + ((int64_t)b * Tk * K + kh) * D;
  const T* vb0 = v + ((int64_t)b * Tk * K + kh) * D;
  const int KD = (D + 15) / 16;               // 16-dim steps of Q K^T

  for (int e = threadIdx.x; e < QT * (DM / CH); e += kWideThreads) {
    const int r = e / (DM / CH), d = (e % (DM / CH)) * CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < S && d < D)
      val = __ldg(reinterpret_cast<const uint4*>(
          q + (((int64_t)b * S + q0 + r) * N + n) * D + d));
    *reinterpret_cast<uint4*>(&sm.qs[r][d]) = val;
  }
  if (threadIdx.x < QT) {
    sm.m[threadIdx.x] = kNegInf;
    sm.l[threadIdx.x] = 0.f;
  }

  // this warp's tile of S: rows srt * 16 + (grp, grp + 8), keys skt * 8 +
  // tig * 2 + (0, 1); its slice of O: columns od0 .. od0 + 63, all rows
  const int srt = warp & 1, skt = warp >> 1;
  const int od0 = warp * kWideOD;
  const bool o_live = od0 < D;  // warp-uniform
  int srow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) srow[h] = srt * 16 + grp + 8 * h;
  float o[2][kWideOD / 8][4];
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int dt = 0; dt < kWideOD / 8; ++dt)
      o[rt][dt][0] = o[rt][dt][1] = o[rt][dt][2] = o[rt][dt][3] = 0.f;

  for (int t0 = 0; t0 < kend; t0 += KT) {
    __syncthreads();  // the previous tile is consumed (Q staged, first time)
    int live = 0;
    if (threadIdx.x < KT) {
      const int col = t0 + threadIdx.x;
      live = col < kend && (mask == nullptr || mask[(int64_t)b * Tk + col] != 0);
      sm.kval[threadIdx.x] = live;
    }
    if (!__syncthreads_or(live)) continue;  // block-uniform: all keys masked
    for (int e = threadIdx.x; e < KT * (DM / CH); e += kWideThreads) {
      const int j = e / (DM / CH), d = (e % (DM / CH)) * CH;
      uint4 rk = make_uint4(0u, 0u, 0u, 0u), rvv = rk;
      if (sm.kval[j] && d < D) {
        const int64_t off = (int64_t)(t0 + j) * K * D + d;
        rk = __ldg(reinterpret_cast<const uint4*>(kb0 + off));
        rvv = __ldg(reinterpret_cast<const uint4*>(vb0 + off));
      }
      *reinterpret_cast<uint4*>(&sm.ks[j][d]) = rk;
      *reinterpret_cast<uint4*>(&sm.vs[j][d]) = rvv;
    }
    __syncthreads();

    // S tile over all of D, two 16-dim steps per K ldmatrix
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int kk = 0; kk < KD; kk += 2) {
      uint32_t kb[4], qa[4];
      ldsm_x4(kb, &sm.ks[skt * 8 + mr][kk * 16 + mi * 8]);
      ldsm_x4(qa, &sm.qs[srt * 16 + (mi & 1) * 8 + mr][kk * 16 + (mi >> 1) * 8]);
      Mma<T>::run(s, qa, kb[0], kb[1]);
      if (kk + 1 < KD) {
        ldsm_x4(qa, &sm.qs[srt * 16 + (mi & 1) * 8 + mr]
                          [(kk + 1) * 16 + (mi >> 1) * 8]);
        Mma<T>::run(s, qa, kb[2], kb[3]);
      }
    }
    bool vis[4];
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int h = j >> 1, c = skt * 8 + tig * 2 + (j & 1), col = t0 + c;
      const int row = q0 + srow[h];
      vis[j] = row < S && sm.kval[c] && (!causal || col <= row);
      s[j] = vis[j] ? s[j] * scale + slope * (float)col : kNegInf;
      mx[h] = fmaxf(mx[h], s[j]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      if (tig == 0) sm.pmax[skt][srow[h]] = mx[h];
    }
    __syncthreads();
    // P = exp(S - m_new) with the row's max over the whole key tile
    float psum[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = srow[h];
      float m_new = sm.m[r];
#pragma unroll
      for (int sl = 0; sl < KT / 8; ++sl) m_new = fmaxf(m_new, sm.pmax[sl][r]);
      const float p0 = vis[2 * h] ? expf(s[2 * h] - m_new) : 0.f;
      const float p1 = vis[2 * h + 1] ? expf(s[2 * h + 1] - m_new) : 0.f;
      *reinterpret_cast<uint32_t*>(&sm.ps[r][skt * 8 + tig * 2]) =
          Mma<T>::pack(p0, p1);
      psum[h] = p0 + p1;
      psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 1);
      psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 2);
      if (tig == 0) sm.psum[skt][r] = psum[h];
    }
    __syncthreads();
    if (threadIdx.x < QT) {
      const int r = threadIdx.x;
      const float m_old = sm.m[r];
      float m_new = m_old, add = 0.f;
#pragma unroll
      for (int sl = 0; sl < KT / 8; ++sl) {
        m_new = fmaxf(m_new, sm.pmax[sl][r]);
        add += sm.psum[sl][r];
      }
      const float c = expf(m_old - m_new);
      sm.l[r] = sm.l[r] * c + add;
      sm.m[r] = m_new;
      sm.corr[r] = c;
    }
    __syncthreads();

    if (o_live) {
#pragma unroll
      for (int rt = 0; rt < 2; ++rt) {
        const float c0 = sm.corr[rt * 16 + grp], c1 = sm.corr[rt * 16 + grp + 8];
#pragma unroll
        for (int dt = 0; dt < kWideOD / 8; ++dt) {
          o[rt][dt][0] *= c0;
          o[rt][dt][1] *= c0;
          o[rt][dt][2] *= c1;
          o[rt][dt][3] *= c1;
        }
      }
#pragma unroll
      for (int k2 = 0; k2 < KT / 16; ++k2) {
        uint32_t pa[2][4];
#pragma unroll
        for (int rt = 0; rt < 2; ++rt)
          ldsm_x4(pa[rt], &sm.ps[rt * 16 + (mi & 1) * 8 + mr][k2 * 16 + (mi >> 1) * 8]);
#pragma unroll
        for (int dp = 0; dp < kWideOD / 16; ++dp) {
          uint32_t vb[4];
          ldsm_x4_t(vb, &sm.vs[k2 * 16 + (mi & 1) * 8 + mr]
                              [od0 + (dp * 2 + (mi >> 1)) * 8]);
#pragma unroll
          for (int rt = 0; rt < 2; ++rt) {
            Mma<T>::run(o[rt][dp * 2], pa[rt], vb[0], vb[1]);
            Mma<T>::run(o[rt][dp * 2 + 1], pa[rt], vb[2], vb[3]);
          }
        }
      }
    }
  }
  __syncthreads();  // the last tile's l

  if (o_live) {
#pragma unroll
    for (int rt = 0; rt < 2; ++rt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rt * 16 + grp + 8 * h, row = q0 + r;
        if (row >= S) continue;
        const float l = sm.l[r];
        const float inv = l > 0.f ? 1.f / l : 0.f;
        T* orow = out + (((int64_t)b * S + row) * N + n) * D;
#pragma unroll
        for (int dt = 0; dt < kWideOD / 8; ++dt) {
          const int d = od0 + dt * 8 + tig * 2;
          if (d < D)
            *reinterpret_cast<uint32_t*>(orow + d) =
                Mma<T>::pack(o[rt][dt][2 * h] * inv, o[rt][dt][2 * h + 1] * inv);
        }
      }
  }
  if (lse != nullptr && threadIdx.x < QT && q0 + (int)threadIdx.x < S) {
    const float l = sm.l[threadIdx.x];
    lse[((int64_t)b * N + n) * S + q0 + threadIdx.x] =
        l > 0.f ? sm.m[threadIdx.x] + logf(l) : neg_infinity();
  }
}

template <typename T>
void flash_wide(cudaStream_t st, const void* q, const void* k, const void* v,
                const int* mask, const float* alibi, void* out, float* lse,
                int B, int S, int Tk, int N, int K, int D, int causal,
                float scale) {
  constexpr int smem = (int)sizeof(WideSmem<T>);
  static bool attr_set = false;  // once per type and process
  if (!attr_set) {
    cudaFuncSetAttribute(flash_fwd_wide_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    attr_set = true;
  }
  const dim3 grid((unsigned)((S + kWideQT - 1) / kWideQT), (unsigned)N,
                  (unsigned)B);
  flash_fwd_wide_kernel<T><<<grid, kWideThreads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, mask, alibi, (T*)out, lse, S, Tk,
      N, K, D, causal, scale);
}

template <typename T>
void flash_d(cudaStream_t st, const void* q, const void* k, const void* v,
             const int* mask, const float* alibi, void* out, float* lse,
             int B, int S, int Tk, int N, int K, int D, int causal,
             float scale) {
  if constexpr (sizeof(T) == 2) {
    if (D == 16 || D == 32 || D == 64 || D == 128) {
      const dim3 grid((unsigned)((S + 63) / 64), (unsigned)N, (unsigned)B);
#define DSTT_FLASH_MMA(DD)                                                  \
  flash_fwd_mma_kernel<T, DD><<<grid, kThreads, 0, st>>>(                   \
      (const T*)q, (const T*)k, (const T*)v, mask, alibi, (T*)out, lse, S, \
      Tk, N, K, causal, scale)
      if (D == 16) DSTT_FLASH_MMA(16);
      else if (D == 32) DSTT_FLASH_MMA(32);
      else if (D == 64) DSTT_FLASH_MMA(64);
      else DSTT_FLASH_MMA(128);
#undef DSTT_FLASH_MMA
      return;
    }
    if (D > 256 && D % 8 == 0) {
      flash_wide<T>(st, q, k, v, mask, alibi, out, lse, B, S, Tk, N, K, D,
                    causal, scale);
      return;
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
}

}  // namespace

// The wrapper (ops/flash_attention.py) checks every shape, dtype, alignment
// and contiguity; this entry point assumes N % K == 0 and D <= 512.
// dtype: 0 = float32, 1 = bfloat16, 2 = float16. mask: (B, T) int32 or null;
// alibi: (N,) fp32 or null; lse: (B, N, S) fp32 or null. Returns
// cudaGetLastError() after the launch.
extern "C" int dstt_flash_fwd(const void* q, const void* k, const void* v,
                              const int* mask, const float* alibi, void* out,
                              float* lse, int B, int S, int T, int N, int K,
                              int D, int causal, float scale, int dtype,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B > 0 && S > 0 && N > 0) {
    if (dtype == 0)
      flash_d<float>(st, q, k, v, mask, alibi, out, lse, B, S, T, N, K, D, causal, scale);
    else if (dtype == 1)
      flash_d<__nv_bfloat16>(st, q, k, v, mask, alibi, out, lse, B, S, T, N, K, D, causal, scale);
    else
      flash_d<__half>(st, q, k, v, mask, alibi, out, lse, B, S, T, N, K, D, causal, scale);
  }
  return (int)cudaGetLastError();
}
