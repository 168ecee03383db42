// The library route's attention in one pass, for Hopper (sm_90a), where a
// row's keys fit on chip: q (N, Sq, H, D), k and v (N, Sk, H, D), bf16, with
// Sq <= Sk <= 128 and D <= 128 a multiple of 8; optional key lengths and a
// (rectangular) causal rule.
//
// Replaces no Pallas kernel. The reference's "xla" attention
// (conzic_tpu/ops/attention.py:153, dot_product_attention) is einsums, an
// additive fp32 bias and a softmax, which XLA compiles into a few fusions.
// PyTorch runs the same formula as a dozen passes (fp32 copies of q and k,
// the einsums' permuted copies, an fp32 product for the logits, the scale,
// the bias, the softmax's max, subtraction, exp, sum and division, the cast
// of the weights, the value product and its output copy), which move some
// ten times the bytes of q, k, v and the output. This kernel reads q, k and
// v once and writes the output once.
//
// Arithmetic, in the reference's order of rounding: the logits are the
// products of the bf16 values summed in fp32 (on the tensor cores), times
// scale (D^-0.5 in fp32), plus the reference's additive bias, which is built
// here from the key lengths and the causal rule: -1e9 at keys j >= lens[n],
// plus -1e9 at j > i + (Sk - Sq) when causal (a key masked twice gets -2e9,
// as there); the bias is added, not put in the logit's place. The softmax
// is exp(x - max) divided by its sum, in fp32, with the accurate expf (not
// __expf) and an IEEE division; the weights are rounded to bf16 and
// multiplied with v on the tensor cores in fp32; the output is rounded once
// to bf16. No online softmax: a whole row of at most 128 logits stays in
// the registers of four lanes, so every logit meets the row's one maximum.
//
// Bound: bytes. A call moves 2 (2 Sq + 2 Sk) H D bytes per row n, and makes
// 4 Sq Sk D operations per head: at SigLIP so400m's text layer (Sq = Sk =
// 64, D = 72) about 8 operations a byte, against the ~295 at which the
// H100's tensor cores would limit. The text chunk's call (800 rows x 64
// positions x 16 heads of 72) moves 471.9 MB: 140.9 us at 3.35 TB/s.
//
// Design: one block per (row n, head h), one warp per 16 query rows (the
// pooled layer's single query row takes one warp). The block copies its
// head's q, k and v rows (D contiguous values each, H D apart) into shared
// memory by cp.async, 16 bytes a thread, neighbouring threads on
// neighbouring bytes, q and k as one group and v as a second, so the logits
// start while v is in flight; blocks of neighbouring heads run side by side
// and share the 32-byte sectors where their rows meet. Each warp takes its
// 16-row tile through mma.sync m16n8k16 (attention_mma.cuh: ldmatrix from
// shared memory, the weights handed from the logits' accumulators straight
// into the A fragments of the value product), writes its bf16 output over
// its own q rows, and copies them out 16 bytes a lane. A shared-memory row
// is D values rounded up to an odd number of 16-byte chunks (72 stays 72, 64
// becomes 72), so the eight rows an ldmatrix reads fall into eight different
// bank groups. Query rows and keys past the data and features past D are
// read as one 16-byte chunk of zeros, so the products are exact: D = 72
// contracts over 80 features, 8 of them zero. At ~28 KB of shared memory
// and 128 threads (SigLIP's text layer) an SM holds several blocks, whose
// copies overlap the others' arithmetic.

#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

namespace tc = conzic::mma;
using bf16 = __nv_bfloat16;

constexpr int kMaxWarps = conzic::kMaxKeys / 16;
constexpr int kMaxHeadDim = 128;
constexpr size_t kDefaultShared = 48 * 1024;  // without the attribute

// Shared-memory row stride in bf16 values: an odd number of 16-byte chunks.
__host__ __device__ inline int row_stride(int D) { return ((D / 8) | 1) * 8; }

inline size_t shared_bytes(int Sq, int Sk, int D) {
  return (tc::kZeroElems + static_cast<size_t>(Sq + 2 * Sk) * row_stride(D)) *
         sizeof(bf16);
}

// rows x (D / 8) chunks of 16 bytes from src (rows H D values apart) to dst
// (rows ld apart), spread over the block's threads.
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src,
                                          int rows, int chunks, int64_t src_ld,
                                          int ld) {
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks;
    const int c = (i - r * chunks) * 8;
    tc::cp_async16(dst + r * ld + c, src + r * src_ld + c);
  }
}

template <int kKeyTiles>
__global__ void __launch_bounds__(kMaxWarps * 32)
    dot_product_attention_kernel(const bf16* __restrict__ q,
                                 const bf16* __restrict__ k,
                                 const bf16* __restrict__ v,
                                 const int* __restrict__ lens,
                                 bf16* __restrict__ out, int H, int Sq, int Sk,
                                 int D, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* zero = reinterpret_cast<bf16*>(smem);
  const int ld = row_stride(D);
  bf16* qs = zero + tc::kZeroElems;
  bf16* ks = qs + Sq * ld;
  bf16* vs = ks + Sk * ld;

  const int n = blockIdx.x / H;
  const int h = blockIdx.x - n * H;
  const int chunks = D / 8;
  const int64_t src_ld = static_cast<int64_t>(H) * D;
  const int64_t q_at = (static_cast<int64_t>(n) * Sq * H + h) * D;
  const int64_t kv_at = (static_cast<int64_t>(n) * Sk * H + h) * D;
  if (threadIdx.x < 4) reinterpret_cast<uint32_t*>(zero)[threadIdx.x] = 0u;
  copy_rows(qs, q + q_at, Sq, chunks, src_ld, ld);
  copy_rows(ks, k + kv_at, Sk, chunks, src_ld, ld);
  tc::cp_async_commit();
  copy_rows(vs, v + kv_at, Sk, chunks, src_ld, ld);
  tc::cp_async_commit();
  const int len = lens != nullptr ? lens[n] : Sk;
  tc::cp_async_wait<1>();
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * 16;
  const int q_rows = min(16, Sq - row0);
  const int g = lane >> 2;
  const int t = lane & 3;
  bf16* qw = qs + row0 * ld;

  // logits: this warp's q rows (16 x D) times k^T, 16 features a step
  float s[2 * kKeyTiles][4];
#pragma unroll
  for (int nt = 0; nt < 2 * kKeyTiles; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
  const int q_row = lane & 15;
  const int q_col = (lane >> 4) << 3;
  const int k_row = (lane & 7) + ((lane >> 4) << 3);
  const int k_col = ((lane >> 3) & 1) << 3;
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t a[4];
    const int qc = kk + q_col;
    tc::ldmatrix_x4(a, q_row < q_rows && qc < D ? qw + q_row * ld + qc : zero);
#pragma unroll
    for (int kt = 0; kt < kKeyTiles; ++kt) {
      const int j = kt * 16 + k_row;
      const int kc = kk + k_col;
      uint32_t b[4];
      tc::ldmatrix_x4(b, j < Sk && kc < D ? ks + j * ld + kc : zero);
      tc::mma_bf16(s[2 * kt], a, b[0], b[1]);
      tc::mma_bf16(s[2 * kt + 1], a, b[2], b[3]);
    }
  }

  // scale, bias and softmax on the accumulator fragment: this lane holds
  // rows g and g + 8, keys 8 nt + 2 t (+ 1); a row's other keys are with
  // the three other lanes of its quad. Keys past Sk are no keys: outside
  // the softmax entirely.
  const int shift = Sk - Sq;
  float row_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < 2 * kKeyTiles; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = nt * 8 + 2 * t + (i & 1);
      const int row = row0 + g + ((i >> 1) << 3);
      float l = -INFINITY;
      if (j < Sk) {
        float bias = j >= len ? conzic::kNegInf : 0.f;
        if (causal && j > row + shift) bias = __fadd_rn(bias, conzic::kNegInf);
        l = __fadd_rn(__fmul_rn(s[nt][i], scale), bias);
      }
      s[nt][i] = l;
      row_max[i >> 1] = fmaxf(row_max[i >> 1], l);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_max[r] = fmaxf(row_max[r], __shfl_xor_sync(0xffffffffu, row_max[r], 1));
    row_max[r] = fmaxf(row_max[r], __shfl_xor_sync(0xffffffffu, row_max[r], 2));
  }
  float row_sum[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < 2 * kKeyTiles; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = nt * 8 + 2 * t + (i & 1);
      const float p = j < Sk ? expf(__fsub_rn(s[nt][i], row_max[i >> 1])) : 0.f;
      s[nt][i] = p;
      row_sum[i >> 1] = __fadd_rn(row_sum[i >> 1], p);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_sum[r] = __fadd_rn(row_sum[r],
                           __shfl_xor_sync(0xffffffffu, row_sum[r], 1));
    row_sum[r] = __fadd_rn(row_sum[r],
                           __shfl_xor_sync(0xffffffffu, row_sum[r], 2));
  }
  // the weights, rounded to bf16: two neighbouring 8-key accumulator tiles
  // are one 16-key A fragment
  uint32_t w[kKeyTiles][4];
#pragma unroll
  for (int kt = 0; kt < kKeyTiles; ++kt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float(&sv)[4] = s[2 * kt + half];
      w[kt][2 * half] = tc::pack_bf16(__fdiv_rn(sv[0], row_sum[0]),
                                      __fdiv_rn(sv[1], row_sum[0]));
      w[kt][2 * half + 1] = tc::pack_bf16(__fdiv_rn(sv[2], row_sum[1]),
                                          __fdiv_rn(sv[3], row_sum[1]));
    }
  }

  // weights (16 x keys) times v (keys x D), 16 features a step; v lies with
  // the keys along its rows, so its fragments are loaded transposed. The
  // bf16 sums go over this warp's q rows, which no lane reads any more.
  tc::cp_async_wait<0>();
  __syncthreads();
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int v_col = (lane >> 4) << 3;
  for (int d0 = 0; d0 < D; d0 += 16) {
    float o[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kt = 0; kt < kKeyTiles; ++kt) {
      const int j = kt * 16 + v_row;
      const int c = d0 + v_col;
      uint32_t b[4];
      tc::ldmatrix_x4_trans(b, j < Sk && c < D ? vs + j * ld + c : zero);
      tc::mma_bf16(o[0], w[kt], b[0], b[1]);
      tc::mma_bf16(o[1], w[kt], b[2], b[3]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int d = d0 + nt * 8 + 2 * t;
      if (d >= D) continue;
      if (g < q_rows) tc::store_bf16x2(qw + g * ld + d, o[nt][0], o[nt][1]);
      if (g + 8 < q_rows)
        tc::store_bf16x2(qw + (g + 8) * ld + d, o[nt][2], o[nt][3]);
    }
  }
  __syncwarp();
  bf16* og = out + q_at + row0 * src_ld;
  for (int i = lane; i < q_rows * chunks; i += 32) {
    const int r = i / chunks;
    const int c = (i - r * chunks) * 8;
    *reinterpret_cast<uint4*>(og + r * src_ld + c) =
        *reinterpret_cast<const uint4*>(qw + r * ld + c);
  }
}

template <int kKeyTiles>
int launch(const void* q, const void* k, const void* v, const int* lens,
           void* out, int N, int H, int Sq, int Sk, int D, int causal,
           float scale, cudaStream_t stream) {
  auto* kernel = dot_product_attention_kernel<kKeyTiles>;
  const size_t smem = shared_bytes(Sq, Sk, D);
  if (smem > kDefaultShared) {
    const cudaError_t e = tc::allow_shared(kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int warps = (Sq + 15) / 16;
  kernel<<<static_cast<unsigned>(N) * H, warps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), lens, static_cast<bf16*>(out), H, Sq, Sk,
      D, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: (N, Sq, H, D); k, v: (N, Sk, H, D); all bf16, contiguous and
// 16-byte aligned, with 1 <= Sq <= Sk <= 128 and D <= 128 a multiple of 8.
// lens: (N,) int32 key lengths, or null (no key-length mask). scale: the
// logits' factor, D^-0.5 in fp32. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a shape the kernel does not take).
CONZIC_EXPORT int conzic_dot_product_attention(
    const void* q, const void* k, const void* v, const int* lens, void* out,
    int N, int H, int Sq, int Sk, int D, int causal, float scale,
    void* stream) {
  if (Sq < 1 || Sq > Sk || Sk > conzic::kMaxKeys || D < 8 ||
      D > kMaxHeadDim || D % 8 || H < 1 || N < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* launch_tiles = launch<8>;
  switch (tc::key_tiles_for(Sk)) {
    case 1: launch_tiles = launch<1>; break;
    case 2: launch_tiles = launch<2>; break;
    case 4: launch_tiles = launch<4>; break;
  }
  return launch_tiles(q, k, v, lens, out, N, H, Sq, Sk, D, causal, scale, s);
}
