// Masked multi-head attention followed by the output projection, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel conzic_tpu/ops/fused_attention.py
// (_kernel_with_out, reached through fused_attention_with_out). Same
// contract: the masked softmax core of masked_attention.cu (rectangular
// causal mask, key padding by lens, masked logits replaced by -1e9, fp32
// softmax, weights rounded to the value type), the context rounded to the
// value type, then y = bo + ctx @ Wo^T accumulated in fp32 over all H * D
// inputs and rounded once to q's type. The residual is NOT added. The TPU
// kernel's per-head slices of Wo were a workaround for a reshape its
// compiler refuses; here the context of all heads is one (Sq, H * D) matrix.
//
// Wo arrives as a PyTorch Linear holds it, (E, H * D), so a row of it is
// contiguous along the reduction and is read as it lies.
//
// Bound: bytes. At the main path's text-tower chunk (N = 800, Sq = 16,
// Sk = 24, H = 8, D = 64, E = 512, bf16) the function moves 66 MB of
// q/k/v/out/Wo (about 20 us at 3.35 TB/s) and does 7.3 GFLOP (about 7 us at
// the bf16 tensor-core peak).
//
// Two kernels, chosen in conzic_attention_with_out from the type and the
// shape alone:
//
// bf16 with D and E multiples of 16 (and a shape whose tiles fit an SM's
// shared memory): attention_with_out_mma_kernel, on the tensor cores
// (attention_mma.cuh says which machine operations and why). A block owns G
// neighbouring rows n, up to 128 query rows, so Wo crosses from L2 to an SM
// N / G times and not N times; G is the smallest that needs no more waves
// of blocks over the card's SMs than the largest would (7 at the main
// shape: 115 blocks on 132 SMs). Everything lies in shared memory as bf16,
// which is exact: the contract rounds q, k, v and the context to bf16
// anyway. One row n's q, K and V are each contiguous in device memory and
// are copied in a row n at a time: into two K/V buffers where they fit
// beside the group's q, the next row's copies in flight while this one is
// attended, else into one. A warp takes one (head, 16-row tile) at a time:
// logits, the softmax on the accumulator fragment, the weighted sum, and
// writes the context over the very q tile it has just consumed, so the
// group's context needs no room of its own. Then the block multiplies its
// (G * Sq, H * D) context by Wo in 64 x 128 output tiles, two row tiles
// against each tile of Wo, adds the bias in fp32 and rounds once. What
// bounds it now: the ways into an SM, one after the other. While a block
// attends, its q, K and V come from device memory and its tensor cores
// mostly wait; while it projects, Wo's tiles come from L2 (N / G times
// 2 E H D bytes in all) and device memory is idle. One block of 8 warps
// fills an SM's shared memory, so no second block's copies overlap this
// one's products; probe_rates.cu measures what a ring takes in from L2 with
// nothing else going on.
//
// Everything else (fp32, which must stay exact fp32 and never TF32, and
// bf16 at other widths): attention_with_out_kernel, the scalar version. One
// block of 256 threads per row n. Head by head the block stages K and V in
// shared memory as fp32 and its 8 warps take query rows, exactly as
// masked_attention.cu does, but the context goes to shared memory. Then the
// block multiplies the (Sq, H * D) context by Wo in 16 x 64 output tiles
// with scalar fp32 fused multiply-adds (product_tile, attention_core.cuh).

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

template <typename T>
__global__ void __launch_bounds__(kTileThreads)
    attention_with_out_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v,
                              const int* __restrict__ lens,
                              const T* __restrict__ wo, const void* bo,
                              int bo_bf16, T* __restrict__ out, int Sq, int Sk,
                              int H, int D, int E, int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ld = D + 1;
  const int HD = H * D;
  float* as = smem;                         // product tiles
  float* ws = as + kTileRows * conzic::kLdA;
  float* ks = smem + kTileFloats;           // [Sk][ld]
  float* vs = ks + Sk * ld;                 // [Sk][ld]
  float* qs = vs + Sk * ld;                 // [kWarps][D]
  float* wts = qs + kWarps * D;             // [kWarps][kMaxKeys]
  float* cs = wts + kWarps * kMaxKeys;      // [Sq][HD] context, all heads
  const int n = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int len = lens ? lens[n] : Sk;
  const int offset = Sk - Sq;
  float* qw = qs + warp * D;
  float* ww = wts + warp * kMaxKeys;

  for (int h = 0; h < H; ++h) {
    __syncthreads();  // the previous head's K and V have been read
    for (int i = threadIdx.x; i < Sk * D; i += kTileThreads) {
      const int j = i / D;
      const int d = i - j * D;
      const size_t g = ((static_cast<size_t>(n) * Sk + j) * H + h) * D + d;
      ks[j * ld + d] = conzic::to_float(k[g]);
      vs[j * ld + d] = conzic::to_float(v[g]);
    }
    __syncthreads();
    for (int r = warp; r < Sq; r += kWarps) {
      const size_t base = ((static_cast<size_t>(n) * Sq + r) * H + h) * D;
      for (int d = lane; d < D; d += 32) qw[d] = conzic::to_float(q[base + d]);
      __syncwarp();
      conzic::softmax_weights<T>(qw, ks, ld, ww, Sk, D, len,
                                 causal ? r + offset : Sk, scale, lane);
      __syncwarp();
      for (int d = lane; d < D; d += 32)
        cs[r * HD + h * D + d] =
            conzic::round_to<T>(conzic::weighted_sum(ww, vs, ld, Sk, d));
      __syncwarp();  // qw / ww are rewritten by the warp's next row
    }
  }

  __syncthreads();  // the context of every head is written
  const int el = threadIdx.x & 63;
  const int rg = threadIdx.x >> 6;
  for (int r0 = 0; r0 < Sq; r0 += kTileRows) {
    for (int e0 = 0; e0 < E; e0 += kTileCols) {
      const int e = e0 + el;
      const float b = e < E ? conzic::load_param(bo, e, bo_bf16) : 0.f;
      float acc[4] = {b, b, b, b};
      conzic::product_tile(cs, HD, Sq, r0, wo, HD, E, e0, HD, as, ws, acc);
      if (e < E) {
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int r = r0 + rg * 4 + rr;
          if (r < Sq)
            out[(static_cast<size_t>(n) * Sq + r) * E + e] =
                conzic::from_float<T>(acc[rr]);
        }
      }
    }
  }
}

size_t shared_bytes(int Sq, int Sk, int H, int D) {
  return sizeof(float) *
         (kTileFloats + 2 * static_cast<size_t>(Sk) * (D + 1) + kWarps * D +
          kWarps * kMaxKeys + static_cast<size_t>(Sq) * H * D);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lens,
           const void* wo, const void* bo, int bo_bf16, void* out, int N,
           int Sq, int Sk, int H, int D, int E, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem = shared_bytes(Sq, Sk, H, D);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        conzic::mma::allow_shared(attention_with_out_kernel<T>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  attention_with_out_kernel<T><<<N, kTileThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lens, static_cast<const T*>(wo), bo, bo_bf16,
      static_cast<T*>(out), Sq, Sk, H, D, E, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the tensor-core version
// ---------------------------------------------------------------------------

namespace tc = conzic::mma;
using tc::bf16;

// Query rows a block gathers at most: G <= kGroupRows / Sq rows n, two row
// tiles of the projection, which then share every tile of Wo.
constexpr int kGroupRows = 128;
constexpr int kMaxGroup = 8;
constexpr int kOutNTiles = 4;  // output tiles of 64 x 128
// A shorter ring rather than a smaller group: at the main shape 7 rows n a
// block with one K/V buffer and a ring of two read 0.087 ms, 4 rows n with
// two buffers and a ring of three 0.094 to 0.100 (H100, chip_smoke.py).
constexpr int kMinStages = 2;

template <int kKeyTiles>
__global__ void __launch_bounds__(tc::kThreads, 1)
    attention_with_out_mma_kernel(const bf16* __restrict__ q,
                                  const bf16* __restrict__ k,
                                  const bf16* __restrict__ v,
                                  const int* __restrict__ lens,
                                  const bf16* __restrict__ wo,
                                  const void* __restrict__ bo, int bo_bf16,
                                  bf16* __restrict__ out, int N, int Sq,
                                  int Sk, int H, int D, int E, int G,
                                  int kv_buffers, int stages, int causal,
                                  float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int HD = H * D;
  const int ld = HD + tc::kPad;
  bf16* zero = reinterpret_cast<bf16*>(smem_raw);
  bf16* qc = zero + tc::kZeroElems;  // [G * Sq, up to 32][ld]: q, then ctx
  bf16* kv = qc + (G * Sq + 31) / 32 * 32 * ld;
  bf16* ring = kv + kv_buffers * 2 * Sk * ld;  // kv: [buffers][k, v][Sk][ld]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * G;
  const int ng = min(G, N - n0);
  const int rows = ng * Sq;

  if (threadIdx.x < tc::kZeroElems / 2)
    reinterpret_cast<uint32_t*>(zero)[threadIdx.x] = 0u;
  // q, K and V of row n0 + i: each is contiguous in device memory
  auto load_n = [&](int i) {
    const size_t n = n0 + i;
    tc::copy_rows_async(qc + i * Sq * ld, ld, q + n * Sq * HD, HD, Sq, HD);
    bf16* dst = kv + (kv_buffers == 2 ? i & 1 : 0) * 2 * Sk * ld;
    tc::copy_rows_async(dst, ld, k + n * Sk * HD, HD, Sk, HD);
    tc::copy_rows_async(dst + Sk * ld, ld, v + n * Sk * HD, HD, Sk, HD);
  };
  load_n(0);

  const int m_tiles = (Sq + 15) / 16;
  for (int i = 0; i < ng; ++i) {
    tc::cp_async_commit();  // row i's copies
    if (kv_buffers == 2) {  // the next row's fly while this one is attended
      if (i + 1 < ng) load_n(i + 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = kv + (kv_buffers == 2 ? i & 1 : 0) * 2 * Sk * ld;
    const bf16* vs = ks + Sk * ld;
    const int len = lens ? lens[n0 + i] : Sk;
    for (int u = warp; u < H * m_tiles; u += tc::kWarps) {
      const int h = u % H;
      const int r0 = (u / H) * 16;
      bf16* tile = qc + (i * Sq + r0) * ld + h * D;
      tc::attend_tile<kKeyTiles>(
          tile, ld, min(16, Sq - r0), ks + h * D, vs + h * D, ld, Sk, D, len,
          causal != 0, r0 + Sk - Sq, scale, zero, lane,
          [&](int r, int d, float v0, float v1) {
            tc::store_bf16x2(tile + r * ld + d, v0, v1);
          });
    }
    __syncthreads();  // K and V have been read: their buffer is free
    if (kv_buffers == 1 && i + 1 < ng) load_n(i + 1);
  }

  tc::project<kOutNTiles, false, 2>(
      qc, ld, nullptr, 0, rows, HD, 0, E, ring, stages,
      [&](int e) { return wo + static_cast<size_t>(e) * HD; },
      [&](int e) { return conzic::load_param(bo, e, bo_bf16); },
      [&](int m, int e, float v0, float v1) {  // one rounding
        if (m < rows)
          tc::store_bf16x2(out + (static_cast<size_t>(n0) * Sq + m) * E + e,
                           v0, v1);
      });
}

// How the tensor-core kernel lays a shape out, or G == 0 where the shape is
// not its own: D or E not a multiple of 16, or tiles too large for an SM.
struct MmaPlan {
  int G;           // rows n per block
  int kv_buffers;  // 2: the next row's K and V are copied during a row's work
  int stages;      // of the ring of Wo's tiles
  size_t smem;
};

MmaPlan mma_plan(int N, int Sq, int Sk, int H, int D, int E, int sms) {
  MmaPlan plan = {0, 0, 0, 0};
  if (D % 16 || E % 16) return plan;
  const size_t ld = H * D + tc::kPad;
  // the largest group, then the smallest one that needs no more waves of
  // blocks over the card's SMs than it: more blocks, each with less to do
  const int g_max = std::max(1, std::min(kMaxGroup, kGroupRows / Sq));
  const int waves = ((N + g_max - 1) / g_max + sms - 1) / sms;
  for (int G = (N + waves * sms - 1) / (waves * sms); G >= 1; --G) {
    const size_t q_rows = static_cast<size_t>(G * Sq + 31) / 32 * 32;
    for (int buffers = 2; buffers >= 1; --buffers) {
      const size_t fixed =
          sizeof(bf16) * (tc::kZeroElems + q_rows * ld + buffers * 2 * Sk * ld);
      if (fixed > tc::kMaxShared) continue;
      const int stages =
          tc::stages_that_fit(tc::kMaxShared - fixed, kOutNTiles, false);
      if (stages >= kMinStages || (buffers == 1 && G == 1 && stages >= 2)) {
        plan = {G, buffers, stages,
                fixed + sizeof(bf16) * stages *
                            tc::stage_elems(kOutNTiles, false)};
        return plan;
      }
    }
  }
  return plan;
}

template <int kKeyTiles>
int launch_mma(const void* q, const void* k, const void* v, const int* lens,
               const void* wo, const void* bo, int bo_bf16, void* out, int N,
               int Sq, int Sk, int H, int D, int E, const MmaPlan& plan,
               int causal, float scale, cudaStream_t stream) {
  const cudaError_t e =
      tc::allow_shared(attention_with_out_mma_kernel<kKeyTiles>, plan.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  attention_with_out_mma_kernel<kKeyTiles>
      <<<(N + plan.G - 1) / plan.G, tc::kThreads, plan.smem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), lens, static_cast<const bf16*>(wo), bo,
          bo_bf16, static_cast<bf16*>(out), N, Sq, Sk, H, D, E, plan.G,
          plan.kv_buffers, plan.stages, causal, scale);
  return static_cast<int>(cudaGetLastError());
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

// Largest key count and head width the kernels take. A shape whose context
// (Sq x H * D floats) does not fit the scalar kernel's shared memory beside
// its tiles is refused at the launch (cudaErrorInvalidValue).
CONZIC_EXPORT int conzic_attention_with_out_max_keys() { return kMaxKeys; }
CONZIC_EXPORT int conzic_attention_with_out_max_head_dim() { return 128; }

// q: (N, Sq, H, D); k, v: (N, Sk, H, D); wo: (E, H * D); out: (N, Sq, E); all
// contiguous, one type (fp32, or bf16 when bf16 != 0). bo: (E,) fp32, or
// bf16 when bo_bf16 != 0. lens: (N,) int32 or null (= Sk). Returns the
// cudaError_t of the launch. bf16 takes the tensor-core kernel where
// mma_plan gives it a group, else the scalar kernel; fp32 always the scalar.
CONZIC_EXPORT int conzic_attention_with_out(
    const void* q, const void* k, const void* v, const int* lens,
    const void* wo, const void* bo, void* out, int N, int Sq, int Sk, int H,
    int D, int E, int causal, float scale, int bf16, int bo_bf16,
    void* stream) {
  if (N <= 0 || Sq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    cudaError_t e;
    const int sms = sm_count(&e);
    if (e != cudaSuccess) return static_cast<int>(e);
    const MmaPlan plan = mma_plan(N, Sq, Sk, H, D, E, sms);
    if (plan.G > 0) {
      auto* launch_tiles = launch_mma<8>;
      switch (tc::key_tiles_for(Sk)) {
        case 1: launch_tiles = launch_mma<1>; break;
        case 2: launch_tiles = launch_mma<2>; break;
        case 4: launch_tiles = launch_mma<4>; break;
      }
      return launch_tiles(q, k, v, lens, wo, bo, bo_bf16, out, N, Sq, Sk, H, D,
                          E, plan, causal, scale, s);
    }
    return launch<__nv_bfloat16>(q, k, v, lens, wo, bo, bo_bf16, out, N, Sq,
                                 Sk, H, D, E, causal, scale, s);
  }
  return launch<float>(q, k, v, lens, wo, bo, bo_bf16, out, N, Sq, Sk, H, D,
                       E, causal, scale, s);
}
