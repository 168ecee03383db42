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
// Design (first, simple version): one block of 256 threads per row n. Head
// by head the block stages K and V in shared memory as fp32 and its 8 warps
// take query rows, exactly as masked_attention.cu does, but the context goes
// to shared memory instead of device memory. Then the block multiplies the
// (Sq, H * D) context by Wo in 16 x 64 output tiles: tiles of Wo come
// through L2 (0.5 MB in bf16, shared by every block) into shared memory, the
// next tile's loads in flight while the current one is multiplied, and each
// thread keeps 4 rows of one column in registers. The product is scalar
// fp32 fused multiply-adds, not tensor-core instructions, so the kernel is
// far from its bound; q/k/v are read once and only y is written.

#include <stdint.h>

#include "attention_core.cuh"

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
    const cudaError_t e = cudaFuncSetAttribute(
        attention_with_out_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  attention_with_out_kernel<T><<<N, kTileThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lens, static_cast<const T*>(wo), bo, bo_bf16,
      static_cast<T*>(out), Sq, Sk, H, D, E, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Largest key count and head width the kernel takes. A shape whose context
// (Sq x H * D floats) does not fit a block's shared memory beside the tiles
// is refused at the launch, with cudaFuncSetAttribute's error.
CONZIC_EXPORT int conzic_attention_with_out_max_keys() { return kMaxKeys; }
CONZIC_EXPORT int conzic_attention_with_out_max_head_dim() { return 128; }

// q: (N, Sq, H, D); k, v: (N, Sk, H, D); wo: (E, H * D); out: (N, Sq, E); all
// contiguous, one type (fp32, or bf16 when bf16 != 0). bo: (E,) fp32, or
// bf16 when bo_bf16 != 0. lens: (N,) int32 or null (= Sk). Returns the
// cudaError_t of the launch.
CONZIC_EXPORT int conzic_attention_with_out(
    const void* q, const void* k, const void* v, const int* lens,
    const void* wo, const void* bo, void* out, int N, int Sq, int Sk, int H,
    int D, int E, int causal, float scale, int bf16, int bo_bf16,
    void* stream) {
  if (N <= 0 || Sq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16>(q, k, v, lens, wo, bo, bo_bf16, out, N, Sq,
                                 Sk, H, D, E, causal, scale, s);
  }
  return launch<float>(q, k, v, lens, wo, bo, bo_bf16, out, N, Sq, Sk, H, D,
                       E, causal, scale, s);
}
