// One-query (decode) attention over a dense KV cache for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/decode_attention.py decode_attention ->
//   _kernel (pallas_call at :161).
//
// What it computes (decode_attention.py:186-209): q (B, N, D) -- one new
// token per row; caches (B, T, K, D); query head n reads KV head n / G
// (G = N / K). Key column j of row b is live when j < kv_len and
// valid[b, j] != 0 (the engine's validity mask is causality and padding in
// one; kv_len is an upper bound the caller knows, every column past it is
// invalid by construction). Score s = (q * scale) . k in fp32 plus
// slope[n] * key_positions[b, j] (alibi; the column j when no positions are
// given); online softmax in fp32; o = sum p v / l, or 0 for a row with no
// live key. A dead key is selected out and its k / v row is never read, so
// stale arena slots cannot reach the output.
//
// Bound on the H100: memory. The least time is the bytes of the live K and
// V rows (live columns x K x D x 2 x itemsize) plus q, out and the mask
// columns read, over 3.35 TB/s; the operations (4 x N x D per live key) are
// far below the tensor-core peak. Design, as paged_decode_kernel in
// paged_attention.cu: one block per (row, KV head) serving that head's G
// query heads, so each K / V row is read once for all G heads (GQA-native,
// no head repeat). The block walks only columns < kv_len with 8 warps; a
// key is held by a sub-warp of lanes, each lane reading its slice of the
// row as one vector (16 lanes x 8 dims = 16 bytes each for 16-bit rows of
// D = 128, two keys per warp load; 32 lanes x D / 32 dims otherwise). Each
// sub-warp keeps 4-8 keys of K and V loads in flight and its own online
// softmax; the block merges the sub-warps' (max, sum, acc) through shared
// memory. Splitting a long row across blocks (flash-decoding) is left to a
// later change.

#include "attention_common.cuh"

namespace {

constexpr int kDecWarps = 8;

// grid (B * K), block 256 threads. SUB lanes hold one key, NI dims each;
// MAXG >= G query heads per KV head.
template <typename T, int NI, int SUB, int MAXG>
__global__ void __launch_bounds__(kDecWarps * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, const int* __restrict__ valid,
              const float* __restrict__ alibi,
              const float* __restrict__ kpos, T* __restrict__ out, int Tk,
              int N, int K, int D, int kv_len, float scale) {
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
  const int len = min(kv_len, Tk);
  const int* vrow = valid + (int64_t)row * Tk;
  const float* prow = kpos != nullptr ? kpos + (int64_t)row * Tk : nullptr;
  const T* kb0 = kc + ((int64_t)row * Tk * K + kh) * D;
  const T* vb0 = vc + ((int64_t)row * Tk * K + kh) * D;

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
    float kr[KG][NI], vr[KG][NI], kp[KG];
    bool live[KG];
#pragma unroll
    for (int j = 0; j < KG; ++j) {
      const int col = base + j;
      live[j] = col < len && vrow[col] != 0;
      kp[j] = live[j] ? (prow != nullptr ? prow[col] : (float)col) : 0.f;
      if (live[j]) {
        const int64_t o = (int64_t)col * K * D;
        load_slice<T, NI>(kb0 + o, d0, D, vec, kr[j]);
        load_slice<T, NI>(vb0 + o, d0, D, vec, vr[j]);
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
        dot = sub_sum<SUB>(dot) + slope[g] * kp[j];
        s[j] = live[j] ? dot : kNegInf;
        mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m[g], mx);
      const float corr = expf(m[g] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < KG; ++j) {
        s[j] = live[j] ? expf(s[j] - m_new) : 0.f;
        psum += s[j];
      }
      l[g] = l[g] * corr + psum;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        float a = acc[g][i] * corr;
#pragma unroll
        for (int j = 0; j < KG; ++j)
          if (live[j]) a += s[j] * vr[j][i];
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

template <typename T, int NI, int SUB>
void decode_g(int G, dim3 grid, cudaStream_t st, const void* q,
              const void* kc, const void* vc, const int* valid,
              const float* alibi, const float* kpos, void* out, int Tk,
              int N, int K, int D, int kv_len, float scale) {
#define DSTT_DECODE(MG)                                                      \
  decode_kernel<T, NI, SUB, MG><<<grid, kDecWarps * 32, 0, st>>>(            \
      (const T*)q, (const T*)kc, (const T*)vc, valid, alibi, kpos, (T*)out, \
      Tk, N, K, D, kv_len, scale)
  if (G <= 1) DSTT_DECODE(1);
  else if (G <= 2) DSTT_DECODE(2);
  else if (G <= 4) DSTT_DECODE(4);
  else DSTT_DECODE(8);
#undef DSTT_DECODE
}

template <typename T>
void decode_d(int G, dim3 grid, cudaStream_t st, const void* q,
              const void* kc, const void* vc, const int* valid,
              const float* alibi, const float* kpos, void* out, int Tk,
              int N, int K, int D, int kv_len, float scale) {
  if constexpr (sizeof(T) == 2) {
    // 16-byte vectors per lane: 8 dims, 16 (or 8) lanes per key
    if (D == 128) {
      decode_g<T, 8, 16>(G, grid, st, q, kc, vc, valid, alibi, kpos, out, Tk, N, K, D, kv_len, scale);
      return;
    }
    if (D == 64) {
      decode_g<T, 8, 8>(G, grid, st, q, kc, vc, valid, alibi, kpos, out, Tk, N, K, D, kv_len, scale);
      return;
    }
  }
  if (D <= 32)
    decode_g<T, 1, 32>(G, grid, st, q, kc, vc, valid, alibi, kpos, out, Tk, N, K, D, kv_len, scale);
  else if (D <= 64)
    decode_g<T, 2, 32>(G, grid, st, q, kc, vc, valid, alibi, kpos, out, Tk, N, K, D, kv_len, scale);
  else if (D <= 128)
    decode_g<T, 4, 32>(G, grid, st, q, kc, vc, valid, alibi, kpos, out, Tk, N, K, D, kv_len, scale);
  else
    decode_g<T, 8, 32>(G, grid, st, q, kc, vc, valid, alibi, kpos, out, Tk, N, K, D, kv_len, scale);
}

}  // namespace

// The wrapper (ops/decode_attention.py) checks every shape, dtype,
// alignment and contiguity; this entry point assumes N % K == 0,
// N / K <= 8, D <= 256. dtype: 0 = float32, 1 = bfloat16, 2 = float16.
// valid: (B, T) int32; alibi: (N,) fp32 or null; kpos: (B, T) fp32 or null.
// Returns cudaGetLastError() after the launch.
extern "C" int dstt_decode_attention(const void* q, const void* kc,
                                     const void* vc, const int* valid,
                                     const float* alibi, const float* kpos,
                                     void* out, int B, int T, int N, int K,
                                     int D, int kv_len, float scale,
                                     int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B > 0 && K > 0) {
    dim3 grid((unsigned)(B * K));
    const int G = N / K;
    if (dtype == 0)
      decode_d<float>(G, grid, st, q, kc, vc, valid, alibi, kpos, out, T, N, K, D, kv_len, scale);
    else if (dtype == 1)
      decode_d<__nv_bfloat16>(G, grid, st, q, kc, vc, valid, alibi, kpos, out, T, N, K, D, kv_len, scale);
    else
      decode_d<__half>(G, grid, st, q, kc, vc, valid, alibi, kpos, out, T, N, K, D, kv_len, scale);
  }
  return (int)cudaGetLastError();
}
