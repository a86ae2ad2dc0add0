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
// live key. A dead key is selected out (p = 0 and its V row skipped by a
// predicate), never multiplied, so a stale arena slot (even NaN) cannot
// reach the output.
//
// Bound on the H100: memory. The least time is the bytes of the live K and
// V rows (live columns x K x D x 2 x itemsize) plus q, out and the mask
// columns read, over 3.35 TB/s; the operations (4 x N x D per live key) are
// ~1 us of fp32 FMAs at llama-7b's decode. At that shape (B 8, T 1024, 32
// heads of 128, rows of 64..1000 keys with holes; ~50 MB of live K / V)
// the bound is ~0.015 ms. A TMA box moves all 32 rows of a live tile, dead
// ones too (PERF.md: the kernel moves its bytes at ~75% of HBM's rate).
//
// Design: decode_split_kernel, one launch a call (flash-decoding). The
// consumer warps, the merge and the cluster launch below are shared with
// the paged decode kernel (csrc/decode_split.cuh); the producer is this
// file's.
// * Split-KV: the columns below kv_len are cut into `splits` chunks of
//   `chunk` columns (a multiple of the 32-key tile; the wrapper picks both,
//   and the ring's stages, from B, K and kv_len: up to 8 splits, the grid
//   within ~4 blocks an SM, a 2-stage ring at 16-bit D 128 -- on the H100
//   more blocks an SM hid the latency better than more stages, and more
//   splits than that cost more in each block's fixed start and merge than
//   they gained). Block (split, row, KV head) serves that head's G query
//   heads over its chunk, so each K / V row is read once for all G heads
//   (GQA-native, no head repeat).
// * The `splits` blocks of a (row, KV head) form a thread-block cluster.
//   Each block merges its own partial softmax state (m, l, acc per query
//   head) and pushes it into block 0's shared memory (st.async, counted in
//   bytes on an mbarrier there); block 0 merges the splits in rank order
//   and writes o. No scratch, no counter, no second launch, and the same
//   bits on every call. A split with no live key carries l = 0, m = -1e30
//   and acc = 0 and adds nothing; a row whose splits are all empty gives 0.
// * A producer warp reads its chunk's valid words (8 tiles of 32 columns
//   in flight a lane), skips every tile with no live column, and streams
//   each live tile's 32 K rows and 32 V rows into a ring of `stages` stages
//   in shared memory: two TMA boxes (D, 1 head, 32 columns, 1 row) from
//   4-D tensor maps over (B, T, K, D), completion counted in bytes on the
//   stage's "full" mbarrier, with the tile's live bits and key positions
//   beside the stage; an end marker (live bits 0) follows the last tile.
//   Rows whose bytes are not a multiple of 16 (no tensor map takes them)
//   are copied by the producer's lanes with plain loads, live rows only.
// * Four consumer warps compute on the CUDA cores in fp32 (G <= 8 query
//   rows a KV head is far too little work for wgmma's 64-row tiles): a
//   sub-warp of SUB lanes holds one key, each lane NI dims of it (16 lanes
//   x 8 dims = 16 bytes a lane for 16-bit rows of D 128: a warp reads two
//   rows, 512 contiguous bytes, with no bank conflict), scores by
//   sub-warp shuffles, exp2 by ex2.approx; each sub-warp keeps its own
//   online softmax over its keys of every tile and releases the stage on
//   its "empty" mbarrier. The block merges the sub-warps' states through
//   shared memory (the drained ring) in a fixed order.

#include "decode_split.cuh"

namespace {

namespace sk = split_kv;
using sk::kTile;
constexpr int kReadAhead = 8;             // tiles of valid words in flight

struct DecodeArgs {
  const void* q;
  const void* kc;        // the caches, read by the plain-load route
  const void* vc;
  const int* valid;      // (B, T)
  const float* alibi;    // (N,) or null
  const float* kpos;     // (B, T) or null
  void* out;
  int T, N, K, D, kv_len;
  int splits, chunk, stages;
  int tile_bytes;        // one K (V) tile in shared memory, 128-aligned
  int region_bytes;      // the ring, or the block merge once it is drained
  int tma;               // rows by TMA (else plain loads)
  float scale;
};

// grid (splits * B * K) in clusters of `splits` along x, block
// sk::kThreads; shared memory as decode_split.cuh lays it out. SUB lanes
// hold one key, NI dims each; MAXG >= G.
template <typename T, int NI, int SUB, int MAXG>
__global__ void __launch_bounds__(sk::kThreads)
decode_split_kernel(const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const DecodeArgs a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) sk::Smem<SUB, MAXG> sm;

  const int S = a.splits, D = a.D, K = a.K, G = a.N / a.K;
  const int split = blockIdx.x % S, pair = blockIdx.x / S;
  const int row = pair / K, kh = pair % K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const sk::Layout lay = sk::layout(smem_raw, a.region_bytes, S, G, D);
  sk::start(sm, a.stages, S, split, G, D);

  if (warp == sk::kConsumerWarps) {
    // ---------------- producer warp ----------------
    const int len = min(a.kv_len, a.T);
    const int c0 = split * a.chunk, c1 = min(c0 + a.chunk, len);
    const int ntiles = c1 > c0 ? (c1 - c0 + kTile - 1) / kTile : 0;
    const int* vrow = a.valid + (int64_t)row * a.T;
    const float* prow =
        a.kpos != nullptr ? a.kpos + (int64_t)row * a.T : nullptr;
    const bool bias = a.alibi != nullptr;
    const size_t isz = sizeof(T);
    sk::Producer ring{sm.full, sm.empty, sm.live, a.stages};
    for (int t0 = 0; t0 < ntiles; t0 += kReadAhead) {
      int v[kReadAhead];
      float kp[kReadAhead];
#pragma unroll
      for (int u = 0; u < kReadAhead; ++u) {
        const int col = c0 + (t0 + u) * kTile + lane;
        const bool in = t0 + u < ntiles && col < c1;
        v[u] = in ? __ldg(vrow + col) : 0;
        kp[u] = (in && bias) ? (prow != nullptr ? __ldg(prow + col)
                                                : (float)col)
                             : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kReadAhead; ++u) {
        const uint32_t live = __ballot_sync(0xffffffffu, v[u] != 0);
        if (live == 0) continue;          // warp-uniform: skip a dead tile
        const int col0 = c0 + (t0 + u) * kTile;
        ring.claim();
        const int slot = ring.slot;
        sm.kpos[slot][lane] = kp[u];
        if (lane == 0) sm.live[slot] = live;
        T* ks = reinterpret_cast<T*>(lay.region
                                     + (size_t)slot * 2 * a.tile_bytes);
        T* vs = reinterpret_cast<T*>(lay.region
                                     + (size_t)slot * 2 * a.tile_bytes
                                     + a.tile_bytes);
        if (!a.tma) {
          // plain loads of the live rows (dead rows keep stale bytes; the
          // consumers select them out)
          const T* kb = static_cast<const T*>(a.kc)
                        + (((int64_t)row * a.T + col0) * K + kh) * D;
          const T* vb = static_cast<const T*>(a.vc)
                        + (((int64_t)row * a.T + col0) * K + kh) * D;
          for (int j = 0; j < kTile; ++j) {
            if (!((live >> j) & 1u)) continue;
            const int64_t o = (int64_t)j * K * D;
            for (int d = lane; d < D; d += 32) {
              ks[j * D + d] = kb[o + d];
              vs[j * D + d] = vb[o + d];
            }
          }
        }
        __syncwarp();   // the lanes' stage writes, ordered before the arrive
        if (lane == 0) {
          if (a.tma) {
            mbar_expect_tx(&sm.full[slot], (uint32_t)(2 * kTile * D * isz));
            tma_load_4d(ks, &kmap, 0, kh, col0, row, &sm.full[slot]);
            tma_load_4d(vs, &vmap, 0, kh, col0, row, &sm.full[slot]);
          } else {
            mbar_arrive(&sm.full[slot]);
          }
        }
        ring.advance();
      }
    }
    ring.finish(lane, S);
    return;
  }

  const int64_t head = (int64_t)row * a.N + kh * G;   // first query head
  sk::consume<T, NI, SUB, MAXG>(
      sm, lay, a.stages, a.tile_bytes, static_cast<const T*>(a.q) + head * D,
      a.alibi != nullptr ? a.alibi + kh * G : nullptr, a.scale, G, D, S,
      split, static_cast<T*>(a.out) + head * D);
}

// The 4-D map of a (B, T, K, D) cache in boxes of (D, 1, kTile, 1): one KV
// head's rows of kTile columns, dense in shared memory (no swizzle), zeros
// past T; from the cache of tensor_map (the decode loop calls each layer's
// arena again every step).
template <typename T>
cudaError_t row_map(CUtensorMap* map, const void* p, int B, int Tk, int K,
                    int D) {
  const cuuint64_t isz = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)K, (cuuint64_t)Tk,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {D * isz, (cuuint64_t)K * D * isz,
                                 (cuuint64_t)Tk * K * D * isz};
  const cuuint32_t box[4] = {(cuuint32_t)D, 1, (cuuint32_t)kTile, 1};
  return tensor_map(map, map_type<T>(), 4, p, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_NONE,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
}

template <typename T, int NI, int SUB, int MAXG>
struct Launch {
  static cudaError_t run(DecodeArgs a, int B, cudaStream_t st) {
    constexpr int NSW = sk::kConsumerWarps * (32 / SUB);
    static int smem_set = 48 * 1024;   // per instantiation: opt in above it
    const int G = a.N / a.K;
    CUtensorMap km, vm;
    std::memset(&km, 0, sizeof(km));
    std::memset(&vm, 0, sizeof(vm));
    a.tma = (a.D * (int)sizeof(T)) % 16 == 0;
    if (a.tma) {
      cudaError_t e = row_map<T>(&km, a.kc, B, a.T, a.K, a.D);
      if (e == cudaSuccess) e = row_map<T>(&vm, a.vc, B, a.T, a.K, a.D);
      if (e != cudaSuccess) return e;
    }
    a.tile_bytes = (kTile * a.D * (int)sizeof(T) + 127) & ~127;
    a.region_bytes = sk::region_bytes(a.stages, a.tile_bytes, NSW, G,
                                      NI * SUB);
    return sk::launch(decode_split_kernel<T, NI, SUB, MAXG>, smem_set,
                      a.splits * B * a.K, a.splits,
                      sk::smem_bytes(a.region_bytes, a.splits, G, a.D), st,
                      km, vm, a);
  }
};

}  // namespace

// The wrapper (ops/decode_attention.py) checks every shape, dtype,
// alignment and contiguity and picks the split (decode_split_plan); this
// entry point assumes N % K == 0, N / K <= 8, D <= 256, 16-byte aligned q /
// caches, 1 <= splits <= 8, chunk a positive multiple of 32 with splits x
// chunk >= kv_len, and 2 <= stages <= 8. dtype: 0 = float32, 1 = bfloat16,
// 2 = float16. valid: (B, T) int32; alibi: (N,) fp32 or null; kpos: (B, T)
// fp32 or null. Returns the CUDA error of the launch.
extern "C" int dstt_decode_attention(const void* q, const void* kc,
                                     const void* vc, const int* valid,
                                     const float* alibi, const float* kpos,
                                     void* out, int B, int T, int N, int K,
                                     int D, int kv_len, float scale,
                                     int dtype, int splits, int chunk,
                                     int stages, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || K <= 0) return (int)cudaGetLastError();
  if (splits < 1 || splits > sk::kMaxSplits || chunk < kTile
      || chunk % kTile || (int64_t)splits * chunk < kv_len || stages < 2
      || stages > sk::kMaxStages || N % K || N / K > sk::kMaxGroup || D < 1
      || D > 256)
    return (int)cudaErrorInvalidValue;
  DecodeArgs a = {};
  a.q = q;
  a.kc = kc;
  a.vc = vc;
  a.valid = valid;
  a.alibi = alibi;
  a.kpos = kpos;
  a.out = out;
  a.T = T;
  a.N = N;
  a.K = K;
  a.D = D;
  a.kv_len = kv_len;
  a.splits = splits;
  a.chunk = chunk;
  a.stages = stages;
  a.scale = scale;
  const int G = N / K;
  if (dtype == 0) return (int)sk::dispatch<Launch, float>(D, G, a, B, st);
  if (dtype == 1)
    return (int)sk::dispatch<Launch, __nv_bfloat16>(D, G, a, B, st);
  return (int)sk::dispatch<Launch, __half>(D, G, a, B, st);
}
