// One whole attention block (q/k/v projections, masked attention, output
// projection, residual add) in one launch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel conzic_tpu/ops/fused_attn_block.py (_kernel,
// reached through fused_attention_block). Same contract and the same
// rounding points: q, k, v = round(x @ W^T + b) with an fp32 product and an
// fp32 bias add, rounded to x's type; the masked softmax core of
// masked_attention.cu with lens (null = S) and the causal flag; the context
// rounded to x's type; out = round(ctx @ Wo^T + bo) + residual, the last add
// in x's type. Rows past lens are computed like any other row.
//
// The four weights arrive as PyTorch Linears hold them, (E_out, E_in): both
// operands of every product are contiguous along the reduction, and head h
// of a projection is rows h * D .. (h + 1) * D of its weight.
//
// Bound: operations at the widths of the engine (BERT rows N = 32, S = 15,
// E = 768: 2.3 GFLOP against 6.9 MB; vision rows S = 50: 7.5 GFLOP), a few
// microseconds either way at the card's peak rates.
//
// Design (first, simple version): one block of 256 threads per row n, three
// stages separated by barriers. The TPU kernel keeps the four (E, E) weights
// in its 128 MB of fast memory; an SM has 227 KB, so here the weights stream
// through L2 in 64 x 64 tiles (the next tile's loads in flight while the
// current one is multiplied) and only one head's q, k and v (S x D each, as
// fp32) live in shared memory.
//   1. per head: project q, k, v of that head from x (read from device
//      memory, L2-resident after the first head) into shared memory;
//   2. per head: the 8 warps take query rows as masked_attention.cu does and
//      write that head's context, in x's type, to the block's own slice of a
//      scratch buffer the wrapper allocates (S x E per row; it stays in L2);
//   3. project the context with Wo in 16 x 64 tiles, add bias, round, add the
//      residual and write the output.
// All four products are scalar fp32 fused multiply-adds in this kernel's
// body, not tensor-core instructions, and a BERT call fills only 32 of the
// 132 SMs, so the kernel is far from its bound.

#include <stdint.h>

#include "attention_core.cuh"

namespace {

using conzic::kMaxKeys;
using conzic::kTileCols;
using conzic::kTileFloats;
using conzic::kTileRows;
using conzic::kTileThreads;

constexpr int kWarps = kTileThreads / 32;

struct Weights {
  const void* w[4];  // query, key, value, out: (E, E) in x's type
  const void* b[4];  // their biases: (E,) fp32 or bf16
};

template <typename T>
__global__ void __launch_bounds__(kTileThreads)
    attention_block_kernel(const T* __restrict__ x, const T* __restrict__ res,
                           Weights p, int b_bf16,
                           const int* __restrict__ lens, T* ctx,
                           T* __restrict__ out, int S, int E, int H,
                           int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int D = E / H;
  const int ld = D + 1;
  float* as = smem;                         // product tiles
  float* ws = as + kTileRows * conzic::kLdA;
  float* qkv = smem + kTileFloats;          // [3][S][ld]: one head's q, k, v
  float* wts = qkv + 3 * S * ld;            // [kWarps][kMaxKeys]
  const float* qs = qkv;
  const float* ks = qkv + S * ld;
  const float* vs = qkv + 2 * S * ld;
  const int n = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int el = threadIdx.x & 63;
  const int rg = threadIdx.x >> 6;
  const int len = lens ? lens[n] : S;
  const T* xn = x + static_cast<size_t>(n) * S * E;
  T* cn = ctx + static_cast<size_t>(n) * S * E;
  float* ww = wts + warp * kMaxKeys;

  for (int h = 0; h < H; ++h) {
    for (int which = 0; which < 3; ++which) {
      const T* w = static_cast<const T*>(p.w[which]) +
                   static_cast<size_t>(h) * D * E;
      float* dst = qkv + which * S * ld;
      for (int r0 = 0; r0 < S; r0 += kTileRows) {
        for (int e0 = 0; e0 < D; e0 += kTileCols) {
          const int e = e0 + el;
          const float b =
              e < D ? conzic::load_param(p.b[which], h * D + e, b_bf16) : 0.f;
          float acc[4] = {b, b, b, b};
          // its first barrier also ends the previous head's attention
          conzic::product_tile(xn, E, S, r0, w, E, D, e0, E, as, ws, acc);
          if (e < D) {
#pragma unroll
            for (int rr = 0; rr < 4; ++rr) {
              const int r = r0 + rg * 4 + rr;
              if (r < S) dst[r * ld + e] = conzic::round_to<T>(acc[rr]);
            }
          }
        }
      }
    }
    __syncthreads();
    for (int r = warp; r < S; r += kWarps) {
      conzic::softmax_weights<T>(qs + r * ld, ks, ld, ww, S, D, len,
                                 causal ? r : S, scale, lane);
      __syncwarp();
      for (int d = lane; d < D; d += 32)
        cn[static_cast<size_t>(r) * E + h * D + d] =
            conzic::from_float<T>(conzic::weighted_sum(ww, vs, ld, S, d));
      __syncwarp();  // ww is rewritten by the warp's next row
    }
  }

  __syncthreads();  // the block reads back the context it wrote
  const T* wo = static_cast<const T*>(p.w[3]);
  for (int r0 = 0; r0 < S; r0 += kTileRows) {
    for (int e0 = 0; e0 < E; e0 += kTileCols) {
      const int e = e0 + el;
      const float b = e < E ? conzic::load_param(p.b[3], e, b_bf16) : 0.f;
      float acc[4] = {b, b, b, b};
      conzic::product_tile(cn, E, S, r0, wo, E, E, e0, E, as, ws, acc);
      if (e < E) {
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int r = r0 + rg * 4 + rr;
          if (r < S) {
            const size_t g = (static_cast<size_t>(n) * S + r) * E + e;
            out[g] = conzic::from_float<T>(conzic::round_to<T>(acc[rr]) +
                                           conzic::to_float(res[g]));
          }
        }
      }
    }
  }
}

size_t shared_bytes(int S, int D) {
  return sizeof(float) * (kTileFloats + 3 * static_cast<size_t>(S) * (D + 1) +
                          kWarps * kMaxKeys);
}

template <typename T>
int launch(const void* x, const void* res, const Weights& p, int b_bf16,
           const int* lens, void* ctx, void* out, int N, int S, int E, int H,
           int causal, float scale, cudaStream_t stream) {
  const size_t smem = shared_bytes(S, E / H);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  attention_block_kernel<T><<<N, kTileThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), p, b_bf16, lens,
      static_cast<T*>(ctx), static_cast<T*>(out), S, E, H, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Longest row and widest head the kernel takes.
CONZIC_EXPORT int conzic_attention_block_max_keys() { return kMaxKeys; }
CONZIC_EXPORT int conzic_attention_block_max_head_dim() { return 128; }

// x, res, ctx (scratch), out: (N, S, E); wq, wk, wv, wo: (E, E) as a Linear
// holds them; all contiguous, one type (fp32, or bf16 when bf16 != 0).
// bq, bk, bv, bo: (E,) fp32, or bf16 when b_bf16 != 0. lens: (N,) int32 or
// null (= S). E must be H times the head width. Returns the cudaError_t of
// the launch.
CONZIC_EXPORT int conzic_attention_block(
    const void* x, const void* res, const void* wq, const void* bq,
    const void* wk, const void* bk, const void* wv, const void* bv,
    const void* wo, const void* bo, const int* lens, void* ctx, void* out,
    int N, int S, int E, int H, int causal, float scale, int bf16, int b_bf16,
    void* stream) {
  if (N <= 0 || S <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Weights p = {{wq, wk, wv, wo}, {bq, bk, bv, bo}};
  if (bf16) {
    return launch<__nv_bfloat16>(x, res, p, b_bf16, lens, ctx, out, N, S, E,
                                 H, causal, scale, s);
  }
  return launch<float>(x, res, p, b_bf16, lens, ctx, out, N, S, E, H, causal,
                       scale, s);
}
