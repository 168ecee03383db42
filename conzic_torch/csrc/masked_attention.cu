// Masked multi-head attention, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel conzic_tpu/ops/fused_attention.py (_kernel
// with masked_softmax_core, reached through fused_masked_attention). Same
// contract: q (N, Sq, H, D), k/v (N, Sk, H, D) with Sk >= Sq, optional key
// lengths lens (N,); rectangular causal mask col <= row + (Sk - Sq) when
// causal; key padding col < lens[n]; masked logits REPLACED by -1e9; logits
// and softmax in fp32 with scale D^-0.5; the weights rounded to the value
// type before the weighted sum (as `.astype(v.dtype)` there); output in the
// input type. Query rows past lens are computed like any other row.
//
// Bound: bytes. The sequences are short (Sk <= 77 on every path of the
// engine), so a head's logits are Sq x Sk dot products of length D: at the
// main path's text-tower chunk (N = 800, Sq = 16, Sk = 24, H = 8, D = 64,
// bf16) the call does 0.63 GFLOP against 65.5 MB of q/k/v/out, about 10
// flop/byte, far below the ~295 where the H100's arithmetic would limit.
// Its floor is the 65.5 MB at 3.35 TB/s, about 20 us.
//
// Design (first, simple version): one block per (n, head). The block stages
// that head's K and V in shared memory as fp32 (rows padded to D + 1 floats,
// so a warp reading one feature of 32 different keys hits 32 banks), then
// each warp takes query rows: a lane computes the logits of keys lane,
// lane + 32, ... , the warp reduces max and sum with shuffles, writes the
// weights to shared memory, and each lane accumulates output features lane,
// lane + 32, ... . q/k/v are read from device memory once. The later redesign
// reads the shared prompt prefix K/V at image-batch width inside the kernel
// instead of the broadcast + concat the caller does now.

#include <stdint.h>

#include "attention_core.cuh"

namespace {

using conzic::kMaxKeys;

constexpr int kWarps = 4;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    masked_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ lens, T* __restrict__ out,
                            int Sq, int Sk, int H, int D, int causal,
                            float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* ks = smem;                // [Sk][ld]
  float* vs = ks + Sk * ld;        // [Sk][ld]
  float* qs = vs + Sk * ld;        // [kWarps][D]
  float* ws = qs + kWarps * D;     // [kWarps][kMaxKeys]
  const int n = blockIdx.x / H;
  const int h = blockIdx.x - n * H;

  for (int i = threadIdx.x; i < Sk * D; i += blockDim.x) {
    const int j = i / D;
    const int d = i - j * D;
    const size_t g = ((static_cast<size_t>(n) * Sk + j) * H + h) * D + d;
    ks[j * ld + d] = conzic::to_float(k[g]);
    vs[j * ld + d] = conzic::to_float(v[g]);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int len = lens ? lens[n] : Sk;
  const int offset = Sk - Sq;
  float* qw = qs + warp * D;
  float* ww = ws + warp * kMaxKeys;

  for (int r = warp; r < Sq; r += kWarps) {
    const size_t base = ((static_cast<size_t>(n) * Sq + r) * H + h) * D;
    for (int d = lane; d < D; d += 32) qw[d] = conzic::to_float(q[base + d]);
    __syncwarp();

    conzic::softmax_weights<T>(qw, ks, ld, ww, Sk, D, len,
                               causal ? r + offset : Sk, scale, lane);
    __syncwarp();

    for (int d = lane; d < D; d += 32)
      out[base + d] =
          conzic::from_float<T>(conzic::weighted_sum(ww, vs, ld, Sk, d));
    __syncwarp();  // qw / ww are rewritten by the warp's next row
  }
}

size_t shared_bytes(int Sk, int D) {
  return sizeof(float) *
         (2 * static_cast<size_t>(Sk) * (D + 1) + kWarps * D +
          kWarps * kMaxKeys);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lens,
           void* out, int N, int Sq, int Sk, int H, int D, int causal,
           float scale, cudaStream_t stream) {
  const size_t smem = shared_bytes(Sk, D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        masked_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  masked_attention_kernel<T><<<N * H, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lens, static_cast<T*>(out), Sq, Sk, H, D,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Largest key count and head width the kernel takes.
CONZIC_EXPORT int conzic_masked_attention_max_keys() { return kMaxKeys; }
CONZIC_EXPORT int conzic_masked_attention_max_head_dim() { return 128; }

// q, out: (N, Sq, H, D); k, v: (N, Sk, H, D); all contiguous, one type
// (fp32, or bf16 when bf16 != 0). lens: (N,) int32 or null (= Sk). Returns
// the cudaError_t of the launch.
CONZIC_EXPORT int conzic_masked_attention(const void* q, const void* k,
                                          const void* v, const int* lens,
                                          void* out, int N, int Sq, int Sk,
                                          int H, int D, int causal,
                                          float scale, int bf16,
                                          void* stream) {
  if (N <= 0 || Sq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16>(q, k, v, lens, out, N, Sq, Sk, H, D, causal,
                                 scale, s);
  }
  return launch<float>(q, k, v, lens, out, N, Sq, Sk, H, D, causal, scale,
                       s);
}
