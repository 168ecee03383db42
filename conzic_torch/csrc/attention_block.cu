// One whole attention block (q/k/v projections, masked attention, output
// projection, residual add) in one call, for Hopper (sm_90a).
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
// Two versions, chosen in conzic_attention_block from the type and the shape
// alone:
//
// bf16 with D and E multiples of 16 (and a shape whose tiles fit an SM's
// shared memory): two kernels on the tensor cores, launched back to back on
// the caller's stream by the one exported function (attention_mma.cuh says
// which machine operations and why). The work is cut by what is independent, not
// by row n.
//   attention_block_qkv_kernel, a block per (group of G rows n, head h),
//   G * S about 64 rows: the group's x, (G * S, E), is contiguous in device
//   memory; its tiles and those of head h's 3 * D rows of Wq, Wk, Wv (one
//   64 x 192 product at D = 64) stream together through a ring of stages,
//   so a weight crosses from L2 to an SM N / G times and not N times; q, k,
//   v of the head get their fp32 bias, are rounded and stay in shared
//   memory as bf16; then a warp per (n, 16-row tile) runs the masked
//   softmax core and writes the context, rounded, to the wrapper's
//   (N, S, E) scratch.
//   attention_block_out_kernel, a block per 64 rows of the flattened
//   (N * S, E) context and a share of the output's columns (64 x 128 tiles
//   where that gives enough blocks to fill the card, else 64 x 64):
//   ctx @ Wo^T through the same ring, the bias added in fp32, rounded, the
//   residual added in bf16.
// The output projection needs every head's context of its rows, so the two
// stages are separated by the grid: the launch boundary orders the scratch.
// What bounds it now: the way from L2 into an SM. A block of the first
// kernel takes in 37 KB a tile step (x and three weights) and its products
// wait for them; probe_rates.cu measures what such a ring takes in with
// nothing else going on. At BERT rows both kernels are one wave of 96
// blocks on 132 SMs, each a chain of 12 tile steps behind its first copies.
//
// Everything else (fp32, which must stay exact fp32 and never TF32, and
// bf16 at other widths): attention_block_kernel, the scalar version. One
// block of 256 threads per row n, three stages separated by barriers, the
// weights streaming through L2 in 64 x 64 tiles and one head's q, k and v
// (S x D each, as fp32) in shared memory:
//   1. per head: project q, k, v of that head from x into shared memory;
//   2. per head: the 8 warps take query rows as masked_attention.cu does and
//      write that head's context, in x's type, to the block's own slice of
//      the scratch buffer;
//   3. project the context with Wo in 16 x 64 tiles, add bias, round, add the
//      residual and write the output.
// Its products are scalar fp32 fused multiply-adds (product_tile,
// attention_core.cuh).

#include <stdint.h>

#include <algorithm>

#include "attention_mma.cuh"

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
    const cudaError_t e =
        conzic::mma::allow_shared(attention_block_kernel<T>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  attention_block_kernel<T><<<N, kTileThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), p, b_bf16, lens,
      static_cast<T*>(ctx), static_cast<T*>(out), S, E, H, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the tensor-core version
// ---------------------------------------------------------------------------

namespace tc = conzic::mma;
using tc::bf16;

// Rows a block of the first kernel gathers: G = kGroupRows / S rows n. At
// BERT rows 48 reads the same (132 blocks and not 96, each with as many tile
// steps), 32 and 128 read slower.
constexpr int kGroupRows = 64;
// The first kernel's tile is 64 x 192: at D = 64, the head width of all three
// towers, a head's q, k and v are one tile, and x is multiplied once.
constexpr int kQkvNTiles = 6;
// Ring stages of the first kernel, at most: 4 and 5 read the same at the
// engine's shapes, 2 slower.
constexpr int kQkvStages = 3;
constexpr int kMinStages = 3;  // a smaller group rather than a shorter ring
// The second kernel's ring leaves room for two blocks on an SM.
constexpr size_t kOutRingBytes = 110 * 1024;
constexpr int kOutBlocks = 132;  // blocks the second kernel tries to reach

template <int kKeyTiles>
__global__ void __launch_bounds__(tc::kThreads, 1)
    attention_block_qkv_kernel(const bf16* __restrict__ x, Weights p,
                               int b_bf16, const int* __restrict__ lens,
                               bf16* __restrict__ ctx, int N, int S, int E,
                               int H, int G, int stages, int causal,
                               float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int D = E / H;
  const int ldh = D + tc::kPad;
  const int GS = G * S;
  bf16* zero = reinterpret_cast<bf16*>(smem_raw);
  bf16* qkv = zero + tc::kZeroElems;  // [q, k, v][G * S][ldh], one head
  bf16* ring = qkv + 3 * GS * ldh;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * G;
  const int h = blockIdx.y;
  const int ng = min(G, N - n0);
  const int rows = ng * S;

  if (threadIdx.x < tc::kZeroElems / 2)
    reinterpret_cast<uint32_t*>(zero)[threadIdx.x] = 0u;

  // the head's q, k and v as one product: column n of 3 D is feature n % D
  // of projection n / D
  const bf16* wq = static_cast<const bf16*>(p.w[0]);
  const bf16* wk = static_cast<const bf16*>(p.w[1]);
  const bf16* wv = static_cast<const bf16*>(p.w[2]);
  tc::project<kQkvNTiles, true, 1>(
      nullptr, 0, x + static_cast<size_t>(n0) * S * E, E, rows, E, 0, 3 * D,
      ring, stages,
      [&](int n) {
        const int which = (n >= D) + (n >= 2 * D);
        const bf16* w = which == 0 ? wq : which == 1 ? wk : wv;
        return w + static_cast<size_t>(h * D + n - which * D) * E;
      },
      [&](int n) {
        const int which = (n >= D) + (n >= 2 * D);
        const void* b = which == 0 ? p.b[0] : which == 1 ? p.b[1] : p.b[2];
        return conzic::load_param(b, h * D + n - which * D, b_bf16);
      },
      [&](int m, int n, float v0, float v1) {
        const int which = (n >= D) + (n >= 2 * D);
        if (m < rows)
          tc::store_bf16x2(qkv + (which * GS + m) * ldh + n - which * D, v0,
                           v1);
      });

  const int m_tiles = (S + 15) / 16;
  for (int u = warp; u < ng * m_tiles; u += tc::kWarps) {
    const int i = u / m_tiles;
    const int r0 = (u % m_tiles) * 16;
    bf16* dst = ctx + (static_cast<size_t>(n0 + i) * S + r0) * E + h * D;
    tc::attend_tile<kKeyTiles>(
        qkv + (i * S + r0) * ldh, ldh, min(16, S - r0),
        qkv + (GS + i * S) * ldh, qkv + (2 * GS + i * S) * ldh, ldh, S, D,
        lens ? lens[n0 + i] : S, causal != 0, r0, scale, zero, lane,
        [&](int r, int d, float v0, float v1) {
          tc::store_bf16x2(dst + static_cast<size_t>(r) * E + d, v0, v1);
        });
  }
}

template <int kNTiles>
__global__ void __launch_bounds__(tc::kThreads)
    attention_block_out_kernel(const bf16* __restrict__ ctx,
                               const bf16* __restrict__ res,
                               const bf16* __restrict__ wo,
                               const void* __restrict__ bo, int b_bf16,
                               bf16* __restrict__ out, int NS, int E,
                               int cols_per_block, int stages) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  const int m0 = blockIdx.x * tc::kTileM;
  const int rows = min(tc::kTileM, NS - m0);
  const int col_begin = blockIdx.y * cols_per_block;

  tc::project<kNTiles, true, 1>(
      nullptr, 0, ctx + static_cast<size_t>(m0) * E, E, rows, E, col_begin,
      min(E, col_begin + cols_per_block), ring, stages,
      [&](int e) { return wo + static_cast<size_t>(e) * E; },
      [&](int e) { return conzic::load_param(bo, e, b_bf16); },
      [&](int m, int e, float v0, float v1) {
        if (m < rows) {
          const size_t at = static_cast<size_t>(m0 + m) * E + e;
          const __nv_bfloat162 r =
              *reinterpret_cast<const __nv_bfloat162*>(res + at);
          // two roundings: after the bias, after the residual
          tc::store_bf16x2(out + at,
                           conzic::round_to<bf16>(v0) + __low2float(r),
                           conzic::round_to<bf16>(v1) + __high2float(r));
        }
      });
}

// Shared memory of the first kernel for groups of G rows n, without its
// ring.
size_t qkv_fixed_bytes(int G, int S, int D) {
  return sizeof(bf16) * (tc::kZeroElems +
                         3 * static_cast<size_t>(G) * S * (D + tc::kPad));
}

int qkv_stages(int G, int S, int D) {
  const size_t fixed = qkv_fixed_bytes(G, S, D);
  if (fixed > tc::kMaxShared) return 0;
  return std::min(kQkvStages,
                  tc::stages_that_fit(tc::kMaxShared - fixed, kQkvNTiles,
                                      true));
}

// Rows n per block of the first tensor-core kernel, or 0 where the shape is
// not theirs: D or E not a multiple of 16, or tiles too large for an SM.
int mma_group(int S, int E, int H) {
  const int D = E / H;
  if (D % 16 || E % 16) return 0;
  int G = std::max(1, kGroupRows / S);
  while (G > 1 && qkv_stages(G, S, D) < kMinStages) --G;
  return qkv_stages(G, S, D) >= 2 ? G : 0;
}

template <int kNTiles>
int launch_out(const void* ctx, const void* res, const Weights& p, int b_bf16,
               void* out, int NS, int E, int want_split,
               cudaStream_t stream) {
  constexpr int kTileN = tc::tile_n(kNTiles);
  const int stages = tc::stages_that_fit(kOutRingBytes, kNTiles, true);
  const size_t smem = sizeof(bf16) * stages * tc::stage_elems(kNTiles, true);
  const cudaError_t e =
      tc::allow_shared(attention_block_out_kernel<kNTiles>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int chunks = (E + kTileN - 1) / kTileN;
  const int split = std::max(1, std::min(chunks, want_split));
  const int chunks_per_block = (chunks + split - 1) / split;
  attention_block_out_kernel<kNTiles>
      <<<dim3((NS + tc::kTileM - 1) / tc::kTileM,
              (chunks + chunks_per_block - 1) / chunks_per_block),
         tc::kThreads, smem, stream>>>(
          static_cast<const bf16*>(ctx), static_cast<const bf16*>(res),
          static_cast<const bf16*>(p.w[3]), p.b[3], b_bf16,
          static_cast<bf16*>(out), NS, E, chunks_per_block * kTileN, stages);
  return static_cast<int>(cudaGetLastError());
}

template <int kKeyTiles>
int launch_mma(const void* x, const void* res, const Weights& p, int b_bf16,
               const int* lens, void* ctx, void* out, int N, int S, int E,
               int H, int G, int causal, float scale, cudaStream_t stream) {
  const int stages = qkv_stages(G, S, E / H);
  const size_t smem_qkv =
      qkv_fixed_bytes(G, S, E / H) +
      sizeof(bf16) * stages * tc::stage_elems(kQkvNTiles, true);
  cudaError_t e =
      tc::allow_shared(attention_block_qkv_kernel<kKeyTiles>, smem_qkv);
  if (e != cudaSuccess) return static_cast<int>(e);

  attention_block_qkv_kernel<kKeyTiles>
      <<<dim3((N + G - 1) / G, H), tc::kThreads, smem_qkv, stream>>>(
          static_cast<const bf16*>(x), p, b_bf16, lens,
          static_cast<bf16*>(ctx), N, S, E, H, G, stages, causal, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  // 64 x 128 output tiles where they are enough blocks to fill the card,
  // else 64 x 64; where the row tiles alone are not enough blocks, the
  // output's columns are shared out among blocks of one row tile
  const int row_tiles = (N * S + tc::kTileM - 1) / tc::kTileM;
  const int want = (kOutBlocks + row_tiles - 1) / row_tiles;
  const bool wide = row_tiles * std::min(want, (E + 127) / 128) >=
                    kOutBlocks;
  return wide ? launch_out<4>(ctx, res, p, b_bf16, out, N * S, E, want, stream)
              : launch_out<2>(ctx, res, p, b_bf16, out, N * S, E, want,
                              stream);
}

}  // namespace

// Longest row and widest head the kernel takes.
CONZIC_EXPORT int conzic_attention_block_max_keys() { return kMaxKeys; }
CONZIC_EXPORT int conzic_attention_block_max_head_dim() { return 128; }

// x, res, ctx (scratch), out: (N, S, E); wq, wk, wv, wo: (E, E) as a Linear
// holds them; all contiguous, one type (fp32, or bf16 when bf16 != 0).
// bq, bk, bv, bo: (E,) fp32, or bf16 when b_bf16 != 0. lens: (N,) int32 or
// null (= S). E must be H times the head width. Returns the cudaError_t of
// the launch. bf16 takes the two tensor-core kernels where mma_group gives
// them a group, else the scalar kernel; fp32 always the scalar.
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
    const int G = mma_group(S, E, H);
    if (G > 0) {
      auto* launch_tiles = launch_mma<8>;
      switch (tc::key_tiles_for(S)) {
        case 1: launch_tiles = launch_mma<1>; break;
        case 2: launch_tiles = launch_mma<2>; break;
        case 4: launch_tiles = launch_mma<4>; break;
      }
      return launch_tiles(x, res, p, b_bf16, lens, ctx, out, N, S, E, H, G,
                          causal, scale, s);
    }
    return launch<__nv_bfloat16>(x, res, p, b_bf16, lens, ctx, out, N, S, E,
                                 H, causal, scale, s);
  }
  return launch<float>(x, res, p, b_bf16, lens, ctx, out, N, S, E, H, causal,
                       scale, s);
}
