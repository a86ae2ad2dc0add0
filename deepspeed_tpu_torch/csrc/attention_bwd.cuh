// Pieces shared by the two fused attention backward passes for Hopper
// (flash_attention_bwd.cu, block_sparse_attention.cu): their block shape
// and shared-memory plan, the prologue that computes delta and the
// per-tile stats, the epilogue that scales the fp32 dq accumulator into
// the input type, and the tensor map through which the fused passes add dq
// parts into that accumulator. Each .cu file is its own library, so
// everything here has internal linkage.

#pragma once

#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kRows = 64;           // query rows of a fused pass's tile
constexpr int kStat = 2 * kRows;    // a tile's stats: lse * log2(e), delta

// The fused passes' block: two consumer warpgroups of 64 keys each and a
// producer warpgroup, over a tile of 128 keys
constexpr int kKeys = 128;          // keys of a fused block, 64 a warpgroup
constexpr int kStages = 2;          // Q / dO / stats tiles in the ring
constexpr int kConsumers = 256;     // two consumer warpgroups
constexpr int kFusedThreads = kConsumers + 128;  // and a producer warpgroup
// registers a thread after setmaxnreg: 2 x 128 x 240 + 128 x 24 <= 64 K
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;

template <int D>
struct Tiles {
  static constexpr int P = D < 64 ? D : 64;       // columns of a panel
  static constexpr int SW = 2 * P;                // bytes of a panel row
  static constexpr int KV = kKeys * D * 2;        // bytes of the K (V) tile
  static constexpr int QO = kRows * D * 2;        // bytes of a Q (dO) tile
  static constexpr int DS = kKeys * kRows * 2;    // bytes of a dS^T buffer
  static constexpr int DQN = D <= 64 ? D / 2 : 32;   // dQ columns a wgmma
  static constexpr int DQC = D / 2 / DQN;            // dQ chunks a warpgroup
  static constexpr int DQB = kRows * DQN * 4;        // bytes of a dQ chunk
  static constexpr int STAGE = 2 * QO + kStat * 4;   // bytes a stage brings
  // K, V, the stages' Q and dO tiles, two dS^T buffers, two dQ buffers of
  // each warpgroup (all 1024-byte multiples), the stages' stats, and room
  // to align the base to 1024
  static constexpr int SMEM = 1024 + 2 * KV + kStages * 2 * QO + 2 * DS +
                              4 * DQC * DQB + kStages * kStat * 4;
};

// 16-bit element pairs of the mma accumulators into one register
template <typename T>
__device__ __forceinline__ void store_pair(T* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = Mma<T>::pack(a, b);
}

// ---------------------------------------------------------------------------
// prologue: delta_i = rowsum(dout_i * o_i) in fp32 for every (b, i, n) row.
// L > 0 (the fused route, 16-bit, D = 8 L): L lanes a row, 16 bytes each;
// delta and lse * log2(e) go to the (B, N, nqt, 2, 64) stats tiles and the
// row of the dq accumulator is zeroed. L == 0: a warp a row, element by
// element; delta to (B, N, S).
// ---------------------------------------------------------------------------
template <typename T, int L>
__global__ void __launch_bounds__(256)
flash_bwd_prologue_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          float* __restrict__ out, float* __restrict__ dq_acc,
                          int64_t rows, int S, int N, int D, int nqt) {
  constexpr int SUB = L > 0 ? L : 32;
  const int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / SUB;
  const int l = threadIdx.x % SUB;
  float acc = 0.f;
  if (row < rows) {
    const T* orow = o + row * D;
    const T* drow = dout + row * D;
    if constexpr (L > 0) {
      constexpr int E = 16 / (int)sizeof(T);
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(orow) + l);
      const uint4 c = __ldg(reinterpret_cast<const uint4*>(drow) + l);
      const T* ae = reinterpret_cast<const T*>(&a);
      const T* ce = reinterpret_cast<const T*>(&c);
#pragma unroll
      for (int e = 0; e < E; ++e) acc += to_f(ae[e]) * to_f(ce[e]);
      float4* z = reinterpret_cast<float4*>(dq_acc + row * D) + l * (E / 4);
#pragma unroll
      for (int e = 0; e < E / 4; ++e) z[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (int d = l; d < D; d += 32) acc += to_f(orow[d]) * to_f(drow[d]);
    }
  }
  acc = sub_sum<SUB>(acc);
  if (row < rows && l == 0) {
    const int n = (int)(row % N);
    const int64_t bi = row / N;
    const int i = (int)(bi % S), b = (int)(bi / S);
    const int64_t bn = (int64_t)b * N + n;
    if constexpr (L > 0) {
      float* tile = out + (bn * nqt + i / kRows) * kStat;
      tile[i % kRows] = lse[bn * S + i] * kLog2e;
      tile[kRows + i % kRows] = acc;
    } else {
      out[bn * S + i] = acc;
    }
  }
}

// epilogue: dq = scale * accumulator, 8 elements a thread (n8 of them)
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_epilogue_kernel(const float* __restrict__ acc, T* __restrict__ dq,
                          int64_t n8, float scale) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  const float4 a = reinterpret_cast<const float4*>(acc)[2 * i];
  const float4 c = reinterpret_cast<const float4*>(acc)[2 * i + 1];
  uint4 r;
  r.x = Mma<T>::pack(a.x * scale, a.y * scale);
  r.y = Mma<T>::pack(a.z * scale, a.w * scale);
  r.z = Mma<T>::pack(c.x * scale, c.y * scale);
  r.w = Mma<T>::pack(c.z * scale, c.w * scale);
  reinterpret_cast<uint4*>(dq)[i] = r;
}

// The 4-D map of the fp32 dq accumulator (B, S, N, D) in boxes of (DQN, 1,
// kRows, 1), DQN in {8, 16, 32} columns, each box row one swizzle span of
// 4 DQN bytes: the target of the fused passes' TMA reduce-adds
inline cudaError_t dq_acc_map(CUtensorMap* map, float* acc, int B, int S,
                              int N, int D, int DQN) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 4, (cuuint64_t)N * D * 4,
                                 (cuuint64_t)S * N * D * 4};
  const cuuint32_t box[4] = {(cuuint32_t)DQN, 1, (cuuint32_t)kRows, 1};
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, acc, dims,
                    strides, box,
                    DQN == 32 ? CU_TENSOR_MAP_SWIZZLE_128B
                    : DQN == 16 ? CU_TENSOR_MAP_SWIZZLE_64B
                                : CU_TENSOR_MAP_SWIZZLE_32B,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
}

}  // namespace
