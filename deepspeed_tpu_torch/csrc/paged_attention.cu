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
//     K and V (sum over rows of len * K * D * 2 * itemsize) over 3.35 TB/s.
//     Design: one block per (row, KV head) serving that head's G query
//     heads, so each K/V row is read once for all G heads (GQA-native). The
//     block walks only pages 0 .. ceil(len / BS) - 1 with 8 warps. A key
//     is held by a sub-warp of lanes, each lane reading its slice of the
//     row as one vector: 16 lanes x 8 dims (16 bytes) for 16-bit rows of
//     D = 128, so one warp load covers two keys; 32 lanes x D / 32 dims
//     otherwise. (Per-lane 2-byte loads made bf16 decode 4x slower than
//     fp32 on the H100; 8-byte loads 2.4x.) Each sub-warp keeps 8 keys of
//     K and V loads in flight and its own online softmax; the block merges
//     the sub-warps' (max, sum, acc) through shared memory at the end.
//     Splitting a long row across blocks (flash-decoding) is left to a
//     later change.
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

#include "attention_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// ---------------------------------------------------------------------------
// decode: grid (R * K), block 256 threads. A key is held by a sub-warp of
// SUB lanes, NI dims each (SUB = 16, NI = 8 for 16-bit rows of D = 128: a
// 16-byte vector per lane, two keys per warp load); MAXG >= G query heads
// per KV head. Every sub-warp runs its own online softmax over its keys;
// the block merges them at the end.
// ---------------------------------------------------------------------------
constexpr int kDecWarps = 8;

template <typename T, int NI, int SUB, int MAXG>
__global__ void __launch_bounds__(kDecWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ bt,
                    const int* __restrict__ lengths,
                    const float* __restrict__ alibi, T* __restrict__ out,
                    int N, int K, int D, int BS, int MAXB, float scale) {
  constexpr int KG = (NI <= 4 || MAXG == 1) ? 8 : 4;  // keys per sub-warp step
  constexpr int NSW = kDecWarps * (32 / SUB);         // sub-warps per block
  constexpr int DW = NI * SUB;                        // dims a sub-warp holds
  __shared__ float sm_m[NSW][MAXG];
  __shared__ float sm_l[NSW][MAXG];
  __shared__ float sm_acc[NSW][DW];

  const int row = blockIdx.x / K, kh = blockIdx.x % K;
  const int G = N / K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sw = warp * (32 / SUB) + lane / SUB;      // this lane's sub-warp
  const int d0 = (lane % SUB) * NI;  // this lane's dims d0 .. d0 + NI - 1
  const bool vec = D == DW;
  const int len = min(lengths[row], MAXB * BS);
  const int* tab = bt + (int64_t)row * MAXB;

  float qr[MAXG][NI], acc[MAXG][NI], m[MAXG], l[MAXG], slope[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    const bool gv = g < G;
    if (gv) load_slice<T, NI>(q + ((int64_t)row * N + kh * G + g) * D, d0, D,
                              vec, qr[g]);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      qr[g][i] = gv ? qr[g][i] * scale : 0.f;
      acc[g][i] = 0.f;
    }
    m[g] = kNegInf;
    l[g] = 0.f;
    slope[g] = (gv && alibi != nullptr) ? alibi[kh * G + g] : 0.f;
  }

  // the loop bound is warp-uniform (sub_sum shuffles need the full warp);
  // a sub-warp past the row's end masks its keys instead
  for (int wbase = warp * (32 / SUB) * KG; wbase < len;
       wbase += NSW * KG) {
    const int base = wbase + (lane / SUB) * KG;
    float kr[KG][NI], vr[KG][NI];
#pragma unroll
    for (int j = 0; j < KG; ++j) {
      const int col = base + j;
      if (col < len) {
        const int64_t o =
            (((int64_t)tab[col / BS] * BS + col % BS) * K + kh) * D;
        load_slice<T, NI>(kp + o, d0, D, vec, kr[j]);
        load_slice<T, NI>(vp + o, d0, D, vec, vr[j]);
      } else {
#pragma unroll
        for (int i = 0; i < NI; ++i) kr[j][i] = vr[j][i] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      float s[KG];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < KG; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < NI; ++i) dot += qr[g][i] * kr[j][i];
        dot = sub_sum<SUB>(dot) + slope[g] * (float)(base + j);
        s[j] = (base + j < len) ? dot : kNegInf;
        mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m[g], mx);
      const float corr = expf(m[g] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < KG; ++j) {
        s[j] = (base + j < len) ? expf(s[j] - m_new) : 0.f;
        psum += s[j];
      }
      l[g] = l[g] * corr + psum;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        float a = acc[g][i] * corr;
#pragma unroll
        for (int j = 0; j < KG; ++j)
          if (base + j < len) a += s[j] * vr[j][i];
        acc[g][i] = a;
      }
      m[g] = m_new;
    }
  }

  // merge the sub-warps' partial softmax states, one query head at a time
  if (lane % SUB == 0) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      sm_m[sw][g] = m[g];
      sm_l[sw][g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;  // block-uniform
    __syncthreads();    // the previous head's sm_acc reads are done
#pragma unroll
    for (int i = 0; i < NI; ++i) sm_acc[sw][d0 + i] = acc[g][i];
    __syncthreads();
    for (int d = threadIdx.x; d < D; d += kDecWarps * 32) {
      float M = kNegInf;
#pragma unroll
      for (int w = 0; w < NSW; ++w) M = fmaxf(M, sm_m[w][g]);
      float L = 0.f, O = 0.f;
#pragma unroll
      for (int w = 0; w < NSW; ++w) {
        const float e = expf(sm_m[w][g] - M);
        L += sm_l[w][g] * e;
        O += sm_acc[w][d] * e;
      }
      out[((int64_t)row * N + kh * G + g) * D + d] =
          from_f<T>(L > 0.f ? O / L : 0.f);
    }
  }
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

template <typename T, int NI, int SUB>
void decode_g(int G, dim3 grid, cudaStream_t st, const void* q,
              const void* kp, const void* vp, const int* bt,
              const int* lengths, const float* alibi, void* out, int N,
              int K, int D, int BS, int MAXB, float scale) {
#define DSTT_DECODE(MG)                                                     \
  paged_decode_kernel<T, NI, SUB, MG><<<grid, kDecWarps * 32, 0, st>>>(     \
      (const T*)q, (const T*)kp, (const T*)vp, bt, lengths, alibi, (T*)out, \
      N, K, D, BS, MAXB, scale)
  if (G <= 1) DSTT_DECODE(1);
  else if (G <= 2) DSTT_DECODE(2);
  else if (G <= 4) DSTT_DECODE(4);
  else DSTT_DECODE(8);
#undef DSTT_DECODE
}

template <typename T>
void decode_d(int G, dim3 grid, cudaStream_t st, const void* q,
              const void* kp, const void* vp, const int* bt,
              const int* lengths, const float* alibi, void* out, int N,
              int K, int D, int BS, int MAXB, float scale) {
  if constexpr (sizeof(T) == 2) {
    // 16-byte vectors per lane: 8 dims, 16 (or 8) lanes per key
    if (D == 128) {
      decode_g<T, 8, 16>(G, grid, st, q, kp, vp, bt, lengths, alibi, out, N, K, D, BS, MAXB, scale);
      return;
    }
    if (D == 64) {
      decode_g<T, 8, 8>(G, grid, st, q, kp, vp, bt, lengths, alibi, out, N, K, D, BS, MAXB, scale);
      return;
    }
  }
  if (D <= 32)
    decode_g<T, 1, 32>(G, grid, st, q, kp, vp, bt, lengths, alibi, out, N, K, D, BS, MAXB, scale);
  else if (D <= 64)
    decode_g<T, 2, 32>(G, grid, st, q, kp, vp, bt, lengths, alibi, out, N, K, D, BS, MAXB, scale);
  else if (D <= 128)
    decode_g<T, 4, 32>(G, grid, st, q, kp, vp, bt, lengths, alibi, out, N, K, D, BS, MAXB, scale);
  else
    decode_g<T, 8, 32>(G, grid, st, q, kp, vp, bt, lengths, alibi, out, N, K, D, BS, MAXB, scale);
}

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

// The wrapper (ops/paged_decode_attention.py) checks every shape, dtype and
// contiguity; these entry points assume N % K == 0, N / K <= 8, D <= 256.
// dtype: 0 = float32, 1 = bfloat16, 2 = float16. alibi: (N,) fp32 or null.
// Both return cudaGetLastError() after the launch.

extern "C" int dstt_paged_decode(const void* q, const void* kp,
                                 const void* vp, const int* bt,
                                 const int* lengths, const float* alibi,
                                 void* out, int R, int N, int K, int D,
                                 int BS, int MAXB, float scale, int dtype,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (R > 0) {
    dim3 grid((unsigned)(R * K));
    const int G = N / K;
    if (dtype == 0)
      decode_d<float>(G, grid, st, q, kp, vp, bt, lengths, alibi, out, N, K, D, BS, MAXB, scale);
    else if (dtype == 1)
      decode_d<__nv_bfloat16>(G, grid, st, q, kp, vp, bt, lengths, alibi, out, N, K, D, BS, MAXB, scale);
    else
      decode_d<__half>(G, grid, st, q, kp, vp, bt, lengths, alibi, out, N, K, D, BS, MAXB, scale);
  }
  return (int)cudaGetLastError();
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
