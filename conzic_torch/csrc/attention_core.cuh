// Device functions shared by the port's attention kernels: the masked
// softmax of one query row (one definition of the masking rule, as
// masked_softmax_core is for the Pallas kernels it replaces) and the tiled
// product the fused kernels use for their projections.
#pragma once

#include <math.h>
#include <stddef.h>

#include "common.cuh"

namespace conzic {

constexpr int kMaxKeys = 128;  // keys one query row can attend
constexpr int kKeysPerLane = kMaxKeys / 32;
constexpr float kNegInf = -1e9f;

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// The masking rule of every attention kernel of the port. Key j is kept iff
// j < len and j <= reach; a kept logit is the dot product times scale, a
// masked one is REPLACED by -1e9.
__device__ __forceinline__ float masked_logit(float dot, int j, int len,
                                              int reach, float scale) {
  return (j < len && j <= reach) ? dot * scale : kNegInf;
}

// One warp, one query row of one head. qrow: D floats; ks: that head's keys
// as fp32 rows of stride ld (all in shared memory). Logits by masked_logit;
// logits and softmax in fp32. Writes the Sk weights, rounded to the value
// type T, to ww[0..Sk). The caller orders its own writes of qrow before the
// call and its reads of ww after it (__syncwarp).
template <typename T>
__device__ __forceinline__ void softmax_weights(const float* qrow,
                                                const float* ks, int ld,
                                                float* ww, int Sk, int D,
                                                int len, int reach,
                                                float scale, int lane) {
  float logit[kKeysPerLane];
  float m = -INFINITY;
#pragma unroll
  for (int t = 0; t < kKeysPerLane; ++t) {
    const int j = lane + t * 32;
    float l = -INFINITY;  // not a key: outside the softmax entirely
    if (j < Sk) {
      const float* kr = ks + j * ld;
      float acc = 0.f;
      for (int d = 0; d < D; ++d) acc += qrow[d] * kr[d];
      l = masked_logit(acc, j, len, reach, scale);
    }
    logit[t] = l;
    m = fmaxf(m, l);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float sum = 0.f;
#pragma unroll
  for (int t = 0; t < kKeysPerLane; ++t) {
    const int j = lane + t * 32;
    const float p = j < Sk ? expf(logit[t] - m) : 0.f;
    logit[t] = p;
    sum += p;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
  for (int t = 0; t < kKeysPerLane; ++t) {
    const int j = lane + t * 32;
    if (j < Sk) ww[j] = round_to<T>(logit[t] / sum);
  }
}

// Feature d of the weighted sum of one head's values (fp32 rows of stride
// ld in shared memory), accumulated in fp32.
__device__ __forceinline__ float weighted_sum(const float* ww,
                                              const float* vs, int ld, int Sk,
                                              int d) {
  float acc = 0.f;
  for (int j = 0; j < Sk; ++j) acc += ww[j] * vs[j * ld + d];
  return acc;
}

// A parameter vector that is fp32 or bf16, read as fp32.
__device__ __forceinline__ float load_param(const void* p, int i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// The tiled product of the fused kernels, for a block of kTileThreads
// threads. One call adds to acc[rr] the dot products
//   sum_k A[r0 + rg * 4 + rr][k] * W[e0 + el][k],   rr = 0..3,
// for the thread's row group rg = threadIdx.x / 64 and column
// el = threadIdx.x % 64: a 16 x 64 output tile over all K inputs. A is
// (rows, K) with row stride lda, W is (w_rows, K) with row stride ldw, the
// layout of a PyTorch Linear weight, so both operands are contiguous along
// the reduction. Rows and columns past the edges read as 0. Tiles of A and
// W are staged as fp32 in shared memory (as: kTileRows x kLdA floats,
// 16-byte aligned; ws: kTileCols x kLdW floats) and the sum runs in fp32 in
// the order of k. Every thread of the block must make the call. What the
// block wrote to A before the call must already be ordered by a barrier: the
// first tile is loaded before the call's own first barrier.
constexpr int kTileThreads = 256;
constexpr int kTileRows = 16;
constexpr int kTileCols = 64;
constexpr int kTileK = 64;
constexpr int kLdA = kTileK + 4;  // rows stay 16-byte aligned
constexpr int kLdW = kTileK + 1;  // a warp's 32 columns hit 32 banks
constexpr int kTileFloats = kTileRows * kLdA + kTileCols * kLdW;

constexpr int kWPerThread = kTileCols * kTileK / kTileThreads;
constexpr int kAPerThread = kTileRows * kTileK / kTileThreads;

// A thread's share of the tiles of A and W at inputs k0 .. k0 + kTileK, from
// device memory (or wherever A and W lie) into registers. All loads are
// issued before any is used, so their latencies overlap.
template <typename TA, typename TW>
__device__ __forceinline__ void load_tiles(const TA* A, int lda, int rows,
                                           int r0, const TW* W, int ldw,
                                           int w_rows, int e0, int K, int k0,
                                           float (&wv)[kWPerThread],
                                           float (&av)[kAPerThread]) {
  const int k = k0 + (threadIdx.x & (kTileK - 1));
  const int row = threadIdx.x / kTileK;  // advances by 4 per step
#pragma unroll
  for (int j = 0; j < kWPerThread; ++j) {
    const int e = e0 + row + j * (kTileThreads / kTileK);
    wv[j] = (e < w_rows && k < K)
                ? to_float(W[static_cast<size_t>(e) * ldw + k])
                : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kAPerThread; ++j) {
    const int r = r0 + row + j * (kTileThreads / kTileK);
    av[j] = (r < rows && k < K)
                ? to_float(A[static_cast<size_t>(r) * lda + k])
                : 0.f;
  }
}

template <typename TA, typename TW>
__device__ __forceinline__ void product_tile(const TA* A, int lda, int rows,
                                             int r0, const TW* W, int ldw,
                                             int w_rows, int e0, int K,
                                             float* as, float* ws,
                                             float (&acc)[4]) {
  static_assert(kTileK == 64 && kTileThreads == 256, "thread mapping");
  const int t = threadIdx.x;
  const int kl_mine = t & (kTileK - 1);
  const int row_mine = t / kTileK;
  const float* wr = ws + (t & 63) * kLdW;
  const float* ar = as + (t >> 6) * 4 * kLdA;
  float wv[kWPerThread];
  float av[kAPerThread];
  load_tiles(A, lda, rows, r0, W, ldw, w_rows, e0, K, 0, wv, av);
  for (int k0 = 0; k0 < K; k0 += kTileK) {
    __syncthreads();  // the previous tile has been read
#pragma unroll
    for (int j = 0; j < kWPerThread; ++j)
      ws[(row_mine + j * (kTileThreads / kTileK)) * kLdW + kl_mine] = wv[j];
#pragma unroll
    for (int j = 0; j < kAPerThread; ++j)
      as[(row_mine + j * (kTileThreads / kTileK)) * kLdA + kl_mine] = av[j];
    __syncthreads();
    // the next tile's loads fly while this one is multiplied
    if (k0 + kTileK < K)
      load_tiles(A, lda, rows, r0, W, ldw, w_rows, e0, K, k0 + kTileK, wv,
                 av);
#pragma unroll 4
    for (int kl = 0; kl < kTileK; kl += 4) {
      const float w0 = wr[kl];
      const float w1 = wr[kl + 1];
      const float w2 = wr[kl + 2];
      const float w3 = wr[kl + 3];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const float4 a =
            *reinterpret_cast<const float4*>(ar + rr * kLdA + kl);
        acc[rr] = fmaf(a.x, w0, acc[rr]);
        acc[rr] = fmaf(a.y, w1, acc[rr]);
        acc[rr] = fmaf(a.z, w2, acc[rr]);
        acc[rr] = fmaf(a.w, w3, acc[rr]);
      }
    }
  }
}

}  // namespace conzic
