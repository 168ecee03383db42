// CLIP's activation, quick_gelu: y = x * sigmoid(1.702 x), for Hopper
// (sm_90a), over a contiguous tensor of any size in bf16 or fp32.
//
// Replaces no Pallas kernel. The reference writes x * jax.nn.sigmoid(1.702 x)
// (conzic_tpu/models/layers.py:25) and XLA fuses it into the pass around it.
// PyTorch runs the same expression as three kernels (the scale, the sigmoid,
// the product), which between them move the MLP's hidden tensor five times;
// this kernel reads it once and writes it once.
//
// Arithmetic: each value is computed in fp32 from the stored input, with the
// constant 1.702f, the accurate expf (not __expf) and an IEEE division, as
// PyTorch's own kernels compute x * torch.sigmoid(1.702 * x) in fp32, and is
// rounded once to the stored type. In fp32 the result equals that expression
// bit for bit; in bf16 it is the fp32 result rounded once, where the three
// library kernels round three times.
//
// Bound: bytes. About 5 operations a value against 4 bytes a value moved in
// bf16 (8 in fp32), far below the ~295 operations a byte at which the H100's
// arithmetic would limit. The text tower's hidden tensor of one row chunk
// (800 rows x 28 positions x 2,048 features in bf16, 91.75 MB) moves 2 x
// 91.75 MB: 54.77 us at 3.35 TB/s.
//
// Design: one 16-byte vector (8 bf16 or 4 fp32 values) a thread, loaded,
// computed in registers and stored with 16-byte accesses, on a grid of one
// thread a vector: at 2,048 resident threads an SM, every SM keeps 32 KB of
// loads in flight. Measured on the H100 at the text chunks' shapes, more
// vectors a thread (2, 4 or 8) or a grid-stride loop over a grid capped at
// the card's resident blocks ran 1 to 13% slower; this form runs at 87 to
// 89% of the bytes bound, as fast as a device-to-device copy of the tensor.
// Values past the last whole vector are taken one a thread by the threads
// past the vectors. Both pointers must be 16-byte aligned (the wrapper
// refuses any other x; its output is a fresh allocation).

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float quick_gelu_value(float v) {
  const float s = 1.f / (1.f + expf(-(1.702f * v)));
  return v * s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    quick_gelu_kernel(const T* __restrict__ x, T* __restrict__ y,
                      int64_t nvec, int64_t n) {
  constexpr int kVec = 16 / sizeof(T);
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < nvec) {
    uint4 raw = __ldg(reinterpret_cast<const uint4*>(x) + i);
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      e[j] = conzic::from_float<T>(quick_gelu_value(conzic::to_float(e[j])));
    }
    reinterpret_cast<uint4*>(y)[i] = raw;
    return;
  }
  const int64_t k = nvec * kVec + (i - nvec);
  if (k < n) {
    y[k] = conzic::from_float<T>(quick_gelu_value(conzic::to_float(x[k])));
  }
}

template <typename T>
void launch(const void* x, void* y, int64_t n, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int64_t nvec = n / kVec;
  const int64_t threads = nvec + (n - nvec * kVec);
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  quick_gelu_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                         stream>>>(static_cast<const T*>(x),
                                   static_cast<T*>(y), nvec, n);
}

}  // namespace

// x, y: n contiguous values, fp32 or bf16 (bf16), each 16-byte aligned.
// Returns the cudaError_t of the launch.
CONZIC_EXPORT int conzic_quick_gelu(const void* x, void* y, long long n,
                                    int bf16, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch<__nv_bfloat16>(x, y, n, s);
  } else {
    launch<float>(x, y, n, s);
  }
  return static_cast<int>(cudaGetLastError());
}
