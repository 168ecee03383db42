// LayerNorm over the last axis, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel conzic_tpu/ops/fused_ln.py (_kernel, reached
// through fused_layer_norm / _fused_ln_forward). Same contract: fp32
// statistics with the one-pass variance max(E[x^2] - mean^2, 0) (not
// Welford), then rsqrt(var + eps), scale and bias; output in the input type.
//
// Bound: bytes. The function reads each input element once and writes each
// output element once, and does a handful of flops per element, far below the
// ~295 flop/byte where the H100's arithmetic would limit. A text-tower chunk
// of the main path (800 candidate rows x 16 suffix tokens x 512 features,
// bf16) moves 2 x 13.1 MB: about 7.8 us at 3.35 TB/s.
//
// Design: one warp per row. Each lane loads its share of the row with 16-byte
// vector loads and keeps it in registers, so the row leaves device memory
// once; the two fp32 sums are reduced with warp shuffles; the normalised row
// goes back with 16-byte stores. Rows up to 32 x kMaxVecPerLane vectors wide
// (2048 bf16 or 1024 fp32 features) are taken; the wrapper refuses wider ones.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxVecPerLane = 8;

template <typename T, typename P>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    layer_norm_kernel(const T* __restrict__ x, const P* __restrict__ scale,
                      const P* __restrict__ bias, T* __restrict__ y,
                      int64_t rows, int features, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform across the warp: one row per warp
  const int nvec = features / kVec;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * features);
  uint4* yr = reinterpret_cast<uint4*>(y + row * features);

  float v[kMaxVecPerLane][kVec];
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecPerLane; ++i) {
    const int vi = lane + i * 32;
    if (vi < nvec) {
      const uint4 raw = xr[vi];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        v[i][j] = conzic::to_float(e[j]);
        s += v[i][j];
        s2 += v[i][j] * v[i][j];
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  const float mean = s / features;
  const float var = fmaxf(s2 / features - mean * mean, 0.f);
  const float r = rsqrtf(var + eps);
#pragma unroll
  for (int i = 0; i < kMaxVecPerLane; ++i) {
    const int vi = lane + i * 32;
    if (vi < nvec) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int f = vi * kVec + j;
        const float yn = (v[i][j] - mean) * r;
        e[j] = conzic::from_float<T>(yn * conzic::to_float(scale[f]) +
                                     conzic::to_float(bias[f]));
      }
      yr[vi] = raw;
    }
  }
}

template <typename T, typename P>
void launch(const void* x, const void* scale, const void* bias, void* y,
            int64_t rows, int features, float eps, cudaStream_t stream) {
  const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  layer_norm_kernel<T, P><<<static_cast<unsigned>(blocks),
                            kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const P*>(scale),
      static_cast<const P*>(bias), static_cast<T*>(y), rows, features, eps);
}

}  // namespace

// Widest row (in elements) the kernel takes for a given element size.
CONZIC_EXPORT int conzic_layer_norm_max_features(int elem_bytes) {
  return 32 * kMaxVecPerLane * (16 / elem_bytes);
}

// x, y: (rows, features) contiguous, 16-byte aligned, fp32 or bf16 (x_bf16);
// scale, bias: (features,) fp32 or bf16 (p_bf16). Returns the cudaError_t of
// the launch.
CONZIC_EXPORT int conzic_layer_norm(const void* x, const void* scale,
                                    const void* bias, void* y, long long rows,
                                    int features, float eps, int x_bf16,
                                    int p_bf16, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && p_bf16) {
    launch<__nv_bfloat16, __nv_bfloat16>(x, scale, bias, y, rows, features,
                                         eps, s);
  } else if (x_bf16) {
    launch<__nv_bfloat16, float>(x, scale, bias, y, rows, features, eps, s);
  } else if (p_bf16) {
    launch<float, __nv_bfloat16>(x, scale, bias, y, rows, features, eps, s);
  } else {
    launch<float, float>(x, scale, bias, y, rows, features, eps, s);
  }
  return static_cast<int>(cudaGetLastError());
}
