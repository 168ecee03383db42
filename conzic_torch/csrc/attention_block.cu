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
// E = 768: 2.3 GFLOP against 6.9 MB; vision rows S = 50: 7.5 GFLOP; the
// text tower's full-row chunk N = 800, S = 24, E = 512: 40.3 GFLOP), a few
// microseconds at BERT rows and 41 us at the text chunk at the card's bf16
// peak (989 TFLOP/s).
//
// Two versions, chosen in conzic_attention_block from the type and the shape
// alone:
//
// bf16 with a head width D of 16, 32 or 64, E a multiple of 16 and S <=
// 128: two kernels on Hopper's warpgroup products (wgmma) fed by the Tensor
// Memory Accelerator (hopper_gemm.cuh), launched back to back on the
// caller's stream by the one exported function.
//   attention_block_qkv_kernel, a block per (group of whole sequences, head
//   h): 64 rows of the flattened (N * S, E) input (128, with two consumer
//   warpgroups, where a sequence is longer than 64 rows or where 128-row
//   groups still make two blocks an SM). A producer warp streams the
//   group's x and the head's D rows of Wq, Wk and Wv through a ring of TMA
//   stages kept by mbarriers; each consumer warpgroup multiplies its 64
//   rows by all three at once, one 64 x 3D accumulator (3D = 192 at D =
//   64: a head's q, k and v are one product and x is read once). The fp32
//   biases are added, q, k and v rounded to bf16 into padded rows where
//   the ring was, and a warp per (sequence, 16-row tile) runs the masked
//   softmax core (attend_tile, mma.sync) and writes the context, rounded,
//   to the wrapper's (N, S, E) scratch. Rows and utilisation: BERT rows G
//   = 4 sequences, 60 of 64 rows, 8 x 12 = 96 blocks (one wave); vision
//   rows one sequence of 50 of 64 rows, 32 x 12 = 384 blocks; the text
//   chunk two warpgroups, 5 sequences, 120 of 128 rows, 160 x 8 = 1,280
//   blocks. A ring stage leaves room for a second block on an SM, whose
//   products overlap this one's epilogue and attention.
//   attention_block_out_kernel, a block per output tile of the flattened
//   context: ctx @ Wo^T through the same kind of ring, the bias added in
//   fp32, rounded, the residual added, rounded. Tiles of 64 x 64 (BERT: 96
//   blocks), 64 x 128 (vision: 150) or 128 x 128 (the text chunk: 600).
// The output projection needs every head's context of its rows, so the two
// stages are separated by the grid: the launch boundary orders the scratch.
// A fused version (the context kept on chip) was not built. Neither kernel
// uses setmaxnreg: with it and a lone producer warp, ptxas sizes every
// thread for whole warpgroups (up to 255 registers at 160 threads), which
// leaves one block an SM where two fit, and the consumers need no more
// than the launch bound gives them (hopper_gemm.cuh, consumer_registers).
// The version before this design (mma.sync fed by cp.async, each block
// waiting on its own copies) read 0.0316, 0.0828 and 0.4533 ms at BERT
// rows, vision rows and the text chunk, against 0.0158, 0.0351 and 0.1795
// now (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py --trees ... --kernels).
// What bounds it now (NVIDIA H100 80GB HBM3, 700 W; kernels/ablate.py
// --kernel attention_block): at BERT rows the two launches, 0.0079
// and 0.0078 ms of 0.0157, each one short wave (the library's five calls
// take 0.030). At the text chunk the first kernel, 0.112 of 0.176 ms (the
// second 0.058): its blocks take in 410 MB from L2 (each (group, head)
// block reads its x tile and the head's three weight slices), about
// 112,000 clocks of every SM at the 27.7 bytes a clock an SM takes in from
// L2 when all pull at once (probe_rates.cu), and its attention, 0.036 ms,
// runs after its product and overlaps only the other resident block's.
// Vision rows: 0.022 + 0.012 ms.
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
#include "hopper_gemm.cuh"

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

namespace hp = conzic::hopper;
namespace tc = conzic::mma;
using hp::bf16;

constexpr int kRows = 64;  // rows of a wgmma tile: one consumer warpgroup's
constexpr int kMaxStages = 4;
// Shared memory of a block that leaves room for a second one on its SM,
// whose mainloop then overlaps this one's epilogue and attention.
constexpr size_t kTwoPerSm = 113 * 1024;
// Bytes before the ring: room to align it to 1,024 bytes, the barriers
// (full[kMaxStages], empty[kMaxStages]) and the 16-byte chunk of zeros.
constexpr size_t kHead = 2048;

__device__ __forceinline__ unsigned char* aligned_base(unsigned char* raw) {
  return raw + ((hp::kAtomBytes - (hp::smem_u32(raw) & 1023)) & 1023);
}

struct QkvMaps {
  CUtensorMap x;     // (N * S, E), boxes of kWG * 64 rows
  CUtensorMap w[3];  // Wq, Wk, Wv (E, E), boxes of D rows: one head
};

// The first kernel: a block per (group of G rows n, head h), kWG * 64 rows
// of the flattened (N * S, E) input (G = kWG * 64 / S sequences, whole). The
// producer warp streams the group's x and head h's D rows of Wq, Wk and Wv
// through a ring of `stages` by TMA; consumer warpgroup g multiplies rows
// 64 g .. 64 g + 63 by all three at once (a 64 x 3D wgmma accumulator:
// column c is feature c % D of projection c / D). Then the consumers add
// the fp32 biases, round q, k and v to bf16 into padded rows where the ring
// was, and a warp per (sequence, 16-row tile) runs the masked softmax core
// and writes the context, rounded, to the (N, S, E) scratch.
template <int kWG, int kD, int kKeyTiles>
__global__ void __launch_bounds__(kWG * 128 + 32, 1)
    attention_block_qkv_kernel(const __grid_constant__ QkvMaps maps,
                               Weights p, int b_bf16,
                               const int* __restrict__ lens,
                               bf16* __restrict__ ctx, int N, int S, int E,
                               int G, int stages, int causal, float scale) {
  constexpr int kN = 3 * kD;  // a head's q, k and v: one product
  constexpr int kConsumers = kWG * 128;
  constexpr int kABytes = kWG * kRows * hp::kRowBytes;
  constexpr int kStageBytes = kABytes + kN * hp::kRowBytes;
  constexpr int kRowsAlloc = kWG * kRows;
  constexpr int kLd = kD + tc::kPad;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned_base(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + kMaxStages;
  bf16* zero = reinterpret_cast<bf16*>(base + 512);
  unsigned char* ring = base + 1024;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * G;
  const int h = blockIdx.y;
  const int ng = min(G, N - n0);
  const int k_tiles = (E + hp::kTileK - 1) / hp::kTileK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      hp::bar_init(&full[i], 1);
      hp::bar_init(&empty[i], kWG * 4);
    }
    hp::fence_barrier_init();
  }
  if (threadIdx.x < tc::kZeroElems / 2)
    reinterpret_cast<uint32_t*>(zero)[threadIdx.x] = 0u;
  __syncthreads();

  if (warp == kWG * 4) {  // the producer
    if (lane == 0) {
      int st = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < k_tiles; ++kt) {
        hp::bar_wait(&empty[st], phase ^ 1);
        hp::bar_expect(&full[st], kStageBytes);
        unsigned char* at = ring + st * kStageBytes;
        hp::tma_load(at, &maps.x, &full[st], kt * hp::kTileK, n0 * S);
#pragma unroll
        for (int w = 0; w < 3; ++w)
          hp::tma_load(at + kABytes + w * kD * hp::kRowBytes, &maps.w[w],
                       &full[st], kt * hp::kTileK, h * kD);
        if (++st == stages) {
          st = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;
  float acc[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
  const uint64_t a_desc = hp::tile_desc(ring + wg * kRows * hp::kRowBytes);
  const uint64_t b_desc = hp::tile_desc(ring + kABytes);
  int st = 0, prev = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < k_tiles; ++kt) {
    hp::bar_wait(&full[st], phase);
    const uint64_t at = (st * kStageBytes) >> 4;
    hp::hold(acc);
    hp::wgmma_tile<kN>(acc, a_desc + at, b_desc + at, kt > 0);
    hp::wgmma_wait<1>();  // the previous stage's products are done
    hp::hold(acc);
    if (kt > 0 && lane == 0) hp::bar_arrive(&empty[prev]);
    prev = st;
    if (++st == stages) {
      st = 0;
      phase ^= 1;
    }
  }
  hp::wgmma_wait<0>();
  hp::hold(acc);
  hp::sync_consumers(kConsumers);  // no warpgroup reads the ring any more

  // q, k, v: [3][kRowsAlloc][kLd] over the ring, rows of the group only
  bf16* qkv = reinterpret_cast<bf16*>(ring);
  const int rows = ng * S;
  const int m = wg * kRows + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    const int which = 8 * j / kD;
    const int c = 8 * j - which * kD + 2 * (lane & 3);
    const float b0 = conzic::load_param(p.b[which], h * kD + c, b_bf16);
    const float b1 = conzic::load_param(p.b[which], h * kD + c + 1, b_bf16);
    bf16* dst = qkv + (which * kRowsAlloc + m) * kLd + c;
    if (m < rows) tc::store_bf16x2(dst, acc[4 * j] + b0, acc[4 * j + 1] + b1);
    if (m + 8 < rows)
      tc::store_bf16x2(dst + 8 * kLd, acc[4 * j + 2] + b0,
                       acc[4 * j + 3] + b1);
  }
  hp::sync_consumers(kConsumers);

  const int m_tiles = (S + 15) / 16;
  for (int u = warp; u < ng * m_tiles; u += kWG * 4) {
    const int i = u / m_tiles;
    const int r0 = (u % m_tiles) * 16;
    bf16* dst = ctx + (static_cast<size_t>(n0 + i) * S + r0) * E + h * kD;
    tc::attend_tile<kKeyTiles>(
        qkv + (i * S + r0) * kLd, kLd, min(16, S - r0),
        qkv + (kRowsAlloc + i * S) * kLd, qkv + (2 * kRowsAlloc + i * S) * kLd,
        kLd, S, kD, lens ? lens[n0 + i] : S, causal != 0, r0, scale, zero,
        lane, [&](int r, int d, float v0, float v1) {
          tc::store_bf16x2(dst + static_cast<size_t>(r) * E + d, v0, v1);
        });
  }
}

// The second kernel: a block per kWG * 64 rows and kBN columns of the
// output, ctx @ Wo^T through the same kind of ring, then the fp32 bias,
// one rounding, the residual added and the sum rounded.
template <int kWG, int kBN>
__global__ void __launch_bounds__(kWG * 128 + 32, 1)
    attention_block_out_kernel(const __grid_constant__ CUtensorMap ctx_map,
                               const __grid_constant__ CUtensorMap wo_map,
                               const bf16* __restrict__ res,
                               const void* __restrict__ bo, int b_bf16,
                               bf16* __restrict__ out, int NS, int E,
                               int stages) {
  constexpr int kABytes = kWG * kRows * hp::kRowBytes;
  constexpr int kStageBytes = kABytes + kBN * hp::kRowBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned_base(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + kMaxStages;
  unsigned char* ring = base + 1024;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * kWG * kRows;
  const int c0 = blockIdx.y * kBN;
  const int k_tiles = (E + hp::kTileK - 1) / hp::kTileK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      hp::bar_init(&full[i], 1);
      hp::bar_init(&empty[i], kWG * 4);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kWG * 4) {  // the producer
    if (lane == 0) {
      int st = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < k_tiles; ++kt) {
        hp::bar_wait(&empty[st], phase ^ 1);
        hp::bar_expect(&full[st], kStageBytes);
        unsigned char* at = ring + st * kStageBytes;
        hp::tma_load(at, &ctx_map, &full[st], kt * hp::kTileK, m0);
        hp::tma_load(at + kABytes, &wo_map, &full[st], kt * hp::kTileK, c0);
        if (++st == stages) {
          st = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;
  float acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
  const uint64_t a_desc = hp::tile_desc(ring + wg * kRows * hp::kRowBytes);
  const uint64_t b_desc = hp::tile_desc(ring + kABytes);
  int st = 0, prev = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < k_tiles; ++kt) {
    hp::bar_wait(&full[st], phase);
    const uint64_t at = (st * kStageBytes) >> 4;
    hp::hold(acc);
    hp::wgmma_tile<kBN>(acc, a_desc + at, b_desc + at, kt > 0);
    hp::wgmma_wait<1>();
    hp::hold(acc);
    if (kt > 0 && lane == 0) hp::bar_arrive(&empty[prev]);
    prev = st;
    if (++st == stages) {
      st = 0;
      phase ^= 1;
    }
  }
  hp::wgmma_wait<0>();
  hp::hold(acc);

  const int m = m0 + wg * kRows + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int c = c0 + 8 * j + 2 * (lane & 3);
    if (c >= E) continue;
    const float b0 = conzic::load_param(bo, c, b_bf16);
    const float b1 = conzic::load_param(bo, c + 1, b_bf16);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m + 8 * half;
      if (r >= NS) continue;
      const size_t at = static_cast<size_t>(r) * E + c;
      const __nv_bfloat162 rv =
          *reinterpret_cast<const __nv_bfloat162*>(res + at);
      // two roundings: after the bias, after the residual
      tc::store_bf16x2(
          out + at,
          conzic::round_to<bf16>(acc[4 * j + 2 * half] + b0) + __low2float(rv),
          conzic::round_to<bf16>(acc[4 * j + 2 * half + 1] + b1) +
              __high2float(rv));
    }
  }
}

// How the two tensor-core kernels lay a shape out.
struct MmaPlan {
  int wg;      // first kernel: consumer warpgroups, 64 rows each
  int G;       // first kernel: rows n a block
  int stages;  // first kernel's ring
  size_t smem;
  int out_wg, out_bn, out_stages;  // second kernel's tile and ring
  size_t out_smem;
};

// D, the head width, must be 16, 32 or 64 (a head's q, k and v are one
// wgmma of 3 D <= 256 columns), E a multiple of 16, S <= 128 (two
// warpgroups' rows), and every tensor 16-byte aligned; returns wg == 0
// where they are not.
MmaPlan mma_plan(int N, int S, int E, int H, int sms) {
  MmaPlan plan = {};
  const int D = E / H;
  if ((D != 16 && D != 32 && D != 64) || E % 16 || S > 2 * kRows)
    return plan;
  const int NS = N * S;
  // two warpgroups where a sequence needs them, or where they still give
  // two blocks an SM: a weight tile then serves twice the rows
  const int G2 = 2 * kRows / S;
  const int blocks2 = (N + G2 - 1) / G2 * H;
  plan.wg = S > kRows || blocks2 >= 2 * sms ? 2 : 1;
  plan.G = plan.wg * kRows / S;
  const size_t stage = (plan.wg * kRows + 3 * D) * hp::kRowBytes;
  const size_t staging =
      3 * static_cast<size_t>(plan.wg) * kRows * (D + tc::kPad) * sizeof(bf16);
  int stages = static_cast<int>((kTwoPerSm - kHead) / stage);
  stages = std::max(stages, static_cast<int>((staging + stage - 1) / stage));
  plan.stages = std::max(2, std::min(kMaxStages, stages));
  plan.smem = kHead + plan.stages * stage;
  // the output: 128 x 128 tiles where they fill the card twice, 64 x 128
  // where they fill it once, else 64 x 64
  const int tiles128 = (NS + 127) / 128 * ((E + 127) / 128);
  const int tiles64 = (NS + 63) / 64 * ((E + 127) / 128);
  plan.out_wg = tiles128 >= 2 * sms ? 2 : 1;
  plan.out_bn = plan.out_wg == 2 || tiles64 >= sms ? 128 : 64;
  const size_t out_stage =
      (plan.out_wg * kRows + plan.out_bn) * hp::kRowBytes;
  plan.out_stages = std::max(
      2, std::min(kMaxStages,
                  static_cast<int>((kTwoPerSm - kHead) / out_stage)));
  plan.out_smem = kHead + plan.out_stages * out_stage;
  return plan;
}

template <int kWG, int kD, int kKeyTiles>
int launch_qkv(const QkvMaps& maps, const Weights& p, int b_bf16,
               const int* lens, void* ctx, int N, int S, int E, int H,
               const MmaPlan& plan, int causal, float scale,
               cudaStream_t stream) {
  auto* kernel = attention_block_qkv_kernel<kWG, kD, kKeyTiles>;
  const cudaError_t e = tc::allow_shared(kernel, plan.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3((N + plan.G - 1) / plan.G, H), kWG * 128 + 32, plan.smem,
           stream>>>(maps, p, b_bf16, lens, static_cast<bf16*>(ctx), N, S, E,
                     plan.G, plan.stages, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int kWG, int kD>
int launch_qkv_keys(int key_tiles, const QkvMaps& maps, const Weights& p,
                    int b_bf16, const int* lens, void* ctx, int N, int S,
                    int E, int H, const MmaPlan& plan, int causal,
                    float scale, cudaStream_t stream) {
  auto* go = launch_qkv<kWG, kD, 8>;
  switch (key_tiles) {
    case 1: go = launch_qkv<kWG, kD, 1>; break;
    case 2: go = launch_qkv<kWG, kD, 2>; break;
    case 4: go = launch_qkv<kWG, kD, 4>; break;
  }
  return go(maps, p, b_bf16, lens, ctx, N, S, E, H, plan, causal, scale,
            stream);
}

template <int kWG>
int launch_qkv_width(int D, int key_tiles, const QkvMaps& maps,
                     const Weights& p, int b_bf16, const int* lens, void* ctx,
                     int N, int S, int E, int H, const MmaPlan& plan,
                     int causal, float scale, cudaStream_t stream) {
  auto* go = launch_qkv_keys<kWG, 64>;
  if (D == 16) go = launch_qkv_keys<kWG, 16>;
  if (D == 32) go = launch_qkv_keys<kWG, 32>;
  return go(key_tiles, maps, p, b_bf16, lens, ctx, N, S, E, H, plan, causal,
            scale, stream);
}

template <int kWG, int kBN>
int launch_out(const CUtensorMap& ctx_map, const CUtensorMap& wo_map,
               const void* res, const void* bo, int b_bf16, void* out, int NS,
               int E, const MmaPlan& plan, cudaStream_t stream) {
  auto* kernel = attention_block_out_kernel<kWG, kBN>;
  const cudaError_t e = tc::allow_shared(kernel, plan.out_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3((NS + kWG * kRows - 1) / (kWG * kRows), (E + kBN - 1) / kBN),
           kWG * 128 + 32, plan.out_smem, stream>>>(
      ctx_map, wo_map, static_cast<const bf16*>(res), bo, b_bf16,
      static_cast<bf16*>(out), NS, E, plan.out_stages);
  return static_cast<int>(cudaGetLastError());
}

int launch_mma(const void* x, const void* res, const Weights& p, int b_bf16,
               const int* lens, void* ctx, void* out, int N, int S, int E,
               int H, const MmaPlan& plan, int causal, float scale,
               cudaStream_t stream) {
  const int D = E / H;
  const uint64_t NS = static_cast<uint64_t>(N) * S;
  QkvMaps maps;
  cudaError_t e = hp::tensor_map(&maps.x, x, NS, E, E, plan.wg * kRows);
  for (int w = 0; w < 3 && e == cudaSuccess; ++w)
    e = hp::tensor_map(&maps.w[w], p.w[w], E, E, E, D);
  CUtensorMap ctx_map, wo_map;
  if (e == cudaSuccess)
    e = hp::tensor_map(&ctx_map, ctx, NS, E, E, plan.out_wg * kRows);
  if (e == cudaSuccess)
    e = hp::tensor_map(&wo_map, p.w[3], E, E, E, plan.out_bn);
  if (e != cudaSuccess) return static_cast<int>(e);

  const int key_tiles = tc::key_tiles_for(S);
  int code = plan.wg == 2
                 ? launch_qkv_width<2>(D, key_tiles, maps, p, b_bf16, lens,
                                       ctx, N, S, E, H, plan, causal, scale,
                                       stream)
                 : launch_qkv_width<1>(D, key_tiles, maps, p, b_bf16, lens,
                                       ctx, N, S, E, H, plan, causal, scale,
                                       stream);
  if (code != 0) return code;
  if (plan.out_wg == 2)
    return launch_out<2, 128>(ctx_map, wo_map, res, p.b[3], b_bf16, out,
                              static_cast<int>(NS), E, plan, stream);
  if (plan.out_bn == 128)
    return launch_out<1, 128>(ctx_map, wo_map, res, p.b[3], b_bf16, out,
                              static_cast<int>(NS), E, plan, stream);
  return launch_out<1, 64>(ctx_map, wo_map, res, p.b[3], b_bf16, out,
                           static_cast<int>(NS), E, plan, stream);
}

// SMs of the device the calling thread has current, 0 with the error set.
int sm_count(cudaError_t* error) {
  int device = 0, sms = 0;
  *error = cudaGetDevice(&device);
  if (*error == cudaSuccess)
    *error = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device);
  return sms;
}

}  // namespace

// Longest row and widest head the kernel takes.
CONZIC_EXPORT int conzic_attention_block_max_keys() { return kMaxKeys; }
CONZIC_EXPORT int conzic_attention_block_max_head_dim() { return 128; }

// x, res, ctx (scratch), out: (N, S, E); wq, wk, wv, wo: (E, E) as a Linear
// holds them; all contiguous, one type (fp32, or bf16 when bf16 != 0).
// bq, bk, bv, bo: (E,) fp32, or bf16 when b_bf16 != 0. lens: (N,) int32 or
// null (= S). E must be H times the head width. Returns the cudaError_t of
// the launch. bf16 takes the two tensor-core kernels where mma_plan gives
// them a layout and every tensor is 16-byte aligned, else the scalar
// kernel; fp32 always the scalar.
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
    cudaError_t e;
    const int sms = sm_count(&e);
    if (e != cudaSuccess) return static_cast<int>(e);
    const MmaPlan plan = mma_plan(N, S, E, H, sms);
    bool aligned = hp::aligned16(x) && hp::aligned16(ctx);
    for (const void* w : p.w) aligned = aligned && hp::aligned16(w);
    if (plan.wg > 0 && aligned)
      return launch_mma(x, res, p, b_bf16, lens, ctx, out, N, S, E, H, plan,
                        causal, scale, s);
    return launch<__nv_bfloat16>(x, res, p, b_bf16, lens, ctx, out, N, S, E,
                                 H, causal, scale, s);
  }
  return launch<float>(x, res, p, b_bf16, lens, ctx, out, N, S, E, H, causal,
                       scale, s);
}
