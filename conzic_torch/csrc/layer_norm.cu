// LayerNorm over the last axis, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel conzic_tpu/ops/fused_ln.py (_kernel, reached
// through fused_layer_norm / _fused_ln_forward). Same contract: fp32
// statistics with the one-pass variance max(E[x^2] - mean^2, 0) (not
// Welford), then rsqrt(var + eps), scale and bias; output in the input type;
// fp32 parameters stay fp32.
//
// Bound: bytes. The function reads each input element once and writes each
// output element once, and does a handful of flops per element, far below the
// ~295 flop/byte where the H100's arithmetic would limit. A chunk of
// SigLIP so400m's text tower (51,200 rows x 1,152 features, bf16) moves
// 2 x 118 MB: about 70 us at 3.35 TB/s.
//
// Design: a warp walks rows with a stride loop, one row at a time.
//  - Scale and bias are read once a warp, with 8- to 16-byte vector loads,
//    and held in registers as fp32 for every row the warp takes: a row's
//    parameters cost no load.
//  - Rows stream through a per-warp ring of kStages row slots in shared
//    memory: cp.async copies the next kStages - 1 rows while the warp
//    reduces and stores the current one, so loads stay in flight. Each lane
//    copies and reads back only its own 16-byte vectors (vector l + 32 i of
//    the row), which needs no barrier and meets no bank conflict.
//  - A lane holds kVecs vectors of a row, a compile-time instance picked
//    from the row's width alone (the widest rows, 2,048 bf16 or 1,024 fp32,
//    take 8), so registers and the ring are sized to the row.
//  - The grid holds as many blocks as the card keeps resident at once, or
//    fewer when there are fewer rows than warps; the rows of two warps
//    differ in number by at most one.
// A lane sums its elements in the same order as a warp-a-row kernel does and
// the warp reduces with the same shuffles, so the output does not depend on
// the grid.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; CUDA graphs over four inputs in
// turn, so that little of a call's input is in L2; PERF.md section 6, row
// 1): so400m's 51,200 x 1,152 bf16 rows with fp32 parameters take 0.0869 ms,
// 81% of their 0.0704 ms bound, where a device copy of the same bytes
// reaches 89%; l14's 22,400 x 768 text chunk 79% (the copy 83%). Over the
// so400m cell's traced request the calls read 80.5% of the bound.

#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxVecPerLane = 8;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Returns once at most kPending of this thread's newest groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Row slots a warp's ring holds: three rows ahead of the current one for
// rows of up to 32 x 4 vectors, two up to 32 x 6, one beyond.
__host__ __device__ constexpr int stages_for(int vecs) {
  return vecs <= 4 ? 4 : (vecs <= 6 ? 3 : 2);
}

// The kN parameters from src as fp32: 16-byte loads (8 bytes for four bf16)
// where the tensors are aligned to them, else one element at a time.
template <typename P, int kN>
__device__ __forceinline__ void load_params(float (&dst)[kN],
                                            const P* __restrict__ src,
                                            bool vectors) {
  constexpr int kBytes = kN * static_cast<int>(sizeof(P));
  if (!vectors) {
#pragma unroll
    for (int j = 0; j < kN; ++j) dst[j] = conzic::to_float(src[j]);
  } else if constexpr (kBytes >= 16) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(P));
#pragma unroll
    for (int k = 0; k < kBytes / 16; ++k) {
      const uint4 raw = reinterpret_cast<const uint4*>(src)[k];
      const P* e = reinterpret_cast<const P*>(&raw);
#pragma unroll
      for (int j = 0; j < kPer; ++j) dst[k * kPer + j] = conzic::to_float(e[j]);
    }
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(src);
    const P* e = reinterpret_cast<const P*>(&raw);
#pragma unroll
    for (int j = 0; j < kN; ++j) dst[j] = conzic::to_float(e[j]);
  }
}

template <typename T, typename P, int kVecs>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    layer_norm_kernel(const T* __restrict__ x, const P* __restrict__ scale,
                      const P* __restrict__ bias, T* __restrict__ y,
                      int64_t rows, int features, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kStages = stages_for(kVecs);
  __shared__ uint4 ring[kWarpsPerBlock][kStages][kVecs * 32];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  if (first >= rows) return;  // uniform across the warp; no block barrier
  const int nvec = features / kVec;
  uint4(*slots)[kVecs * 32] = ring[warp];

  // one commit group a row, empty past the last row, so that the count of
  // groups in flight is the same at every wait
  auto fetch = [&](int64_t row, int slot) {
    if (row < rows) {
      const uint4* src = reinterpret_cast<const uint4*>(x + row * features);
#pragma unroll
      for (int i = 0; i < kVecs; ++i) {
        const int vi = lane + i * 32;
        if (vi < nvec) cp_async16(&slots[slot][vi], src + vi);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch(first + s * stride, s);

  const int align = kVec * static_cast<int>(sizeof(P)) >= 16 ? 16 : 8;
  const bool vectors =
      ((reinterpret_cast<uintptr_t>(scale) | reinterpret_cast<uintptr_t>(bias)) %
       align) == 0;
  float sc[kVecs][kVec], bi[kVecs][kVec];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int vi = lane + i * 32;
    if (vi < nvec) {
      load_params<P, kVec>(sc[i], scale + vi * kVec, vectors);
      load_params<P, kVec>(bi[i], bias + vi * kVec, vectors);
    }
  }

  int slot = 0;
  for (int64_t row = first; row < rows; row += stride) {
    cp_async_wait<kStages - 2>();  // this row's group has landed
    uint4 raw[kVecs];
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int vi = lane + i * 32;
      if (vi < nvec) raw[i] = slots[slot][vi];
    }
    // the slot read one row ago takes the row kStages - 1 ahead
    fetch(row + (kStages - 1) * stride, slot == 0 ? kStages - 1 : slot - 1);

    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      if (lane + i * 32 < nvec) {
        const T* e = reinterpret_cast<const T*>(&raw[i]);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float v = conzic::to_float(e[j]);
          s += v;
          s2 += v * v;
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
    uint4* yr = reinterpret_cast<uint4*>(y + row * features);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int vi = lane + i * 32;
      if (vi < nvec) {
        const T* e = reinterpret_cast<const T*>(&raw[i]);
        uint4 out;
        T* o = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float yn = (conzic::to_float(e[j]) - mean) * r;
          o[j] = conzic::from_float<T>(yn * sc[i][j] + bi[i][j]);
        }
        yr[vi] = out;
      }
    }
    slot = slot + 1 == kStages ? 0 : slot + 1;
  }
  cp_async_wait<0>();  // no copy outlives the block's shared memory
}

// How a call runs: the instance (16-byte vectors a lane holds), the grid,
// and the rows the busiest warp takes.
struct Plan {
  int vecs = 0;
  int blocks = 0;
  int rows_per_warp = 0;
};

// The instance a row of `features` elements of `elem` bytes takes: the
// vectors a lane holds, rounded up to one of the compiled counts.
int vecs_for(int features, int elem) {
  const int per_lane = (features / (16 / elem) + 31) / 32;
  return per_lane <= 6 ? std::max(per_lane, 1) : kMaxVecPerLane;
}

template <typename T, typename P, int kVecs>
cudaError_t plan_instance(int64_t rows, Plan* plan) {
  // blocks of this instance an SM holds at once, from its registers and
  // ring; computed once a process (the cards of a machine are alike)
  static const int resident = [] {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, layer_norm_kernel<T, P, kVecs>, kWarpsPerBlock * 32, 0) !=
        cudaSuccess)
      return 0;
    return n;
  }();
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  if (resident <= 0) return cudaErrorInvalidConfiguration;
  // one resident wave, or one row a warp when there are fewer rows: more
  // warps in flight beat an even last round (measured at the cells' chunks)
  const int64_t wanted = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  plan->vecs = kVecs;
  plan->blocks = static_cast<int>(
      std::min<int64_t>(wanted, static_cast<int64_t>(sms) * resident));
  const int64_t warps = static_cast<int64_t>(plan->blocks) * kWarpsPerBlock;
  plan->rows_per_warp = static_cast<int>((rows + warps - 1) / warps);
  return cudaSuccess;
}

// Plans the call and, when `launch` is set, launches it.
template <typename T, typename P, int kVecs>
cudaError_t run_instance(const void* x, const void* scale, const void* bias,
                         void* y, int64_t rows, int features, float eps,
                         cudaStream_t stream, bool launch, Plan* plan) {
  cudaError_t e = plan_instance<T, P, kVecs>(rows, plan);
  if (e != cudaSuccess || !launch) return e;
  layer_norm_kernel<T, P, kVecs><<<plan->blocks, kWarpsPerBlock * 32, 0,
                                   stream>>>(
      static_cast<const T*>(x), static_cast<const P*>(scale),
      static_cast<const P*>(bias), static_cast<T*>(y), rows, features, eps);
  return cudaGetLastError();
}

template <typename T, typename P>
cudaError_t run(const void* x, const void* scale, const void* bias, void* y,
                int64_t rows, int features, float eps, cudaStream_t stream,
                bool launch, Plan* plan) {
#define CONZIC_LN_CASE(n)                                                   \
  case n:                                                                   \
    return run_instance<T, P, n>(x, scale, bias, y, rows, features, eps,    \
                                 stream, launch, plan);
  switch (vecs_for(features, sizeof(T))) {
    CONZIC_LN_CASE(1)
    CONZIC_LN_CASE(2)
    CONZIC_LN_CASE(3)
    CONZIC_LN_CASE(4)
    CONZIC_LN_CASE(5)
    CONZIC_LN_CASE(6)
    default:
      return run_instance<T, P, kMaxVecPerLane>(
          x, scale, bias, y, rows, features, eps, stream, launch, plan);
  }
#undef CONZIC_LN_CASE
}

cudaError_t dispatch(const void* x, const void* scale, const void* bias,
                     void* y, int64_t rows, int features, float eps,
                     int x_bf16, int p_bf16, cudaStream_t stream, bool launch,
                     Plan* plan) {
  using bf16 = __nv_bfloat16;
  if (x_bf16 && p_bf16)
    return run<bf16, bf16>(x, scale, bias, y, rows, features, eps, stream,
                           launch, plan);
  if (x_bf16)
    return run<bf16, float>(x, scale, bias, y, rows, features, eps, stream,
                            launch, plan);
  if (p_bf16)
    return run<float, bf16>(x, scale, bias, y, rows, features, eps, stream,
                            launch, plan);
  return run<float, float>(x, scale, bias, y, rows, features, eps, stream,
                           launch, plan);
}

}  // namespace

// Widest row (in elements) the kernel takes for a given element size.
CONZIC_EXPORT int conzic_layer_norm_max_features(int elem_bytes) {
  return 32 * kMaxVecPerLane * (16 / elem_bytes);
}

// How conzic_layer_norm runs a call of `rows` x `features`: plan[0] the
// 16-byte vectors a lane holds (the instance), plan[1] the blocks of
// 32 x 4 threads, plan[2] the rows the busiest warp takes. Launches nothing.
// Returns a cudaError_t.
CONZIC_EXPORT int conzic_layer_norm_plan(long long rows, int features,
                                         int x_bf16, int p_bf16, int* plan) {
  Plan p;
  const cudaError_t e =
      rows <= 0 ? cudaSuccess
                : dispatch(nullptr, nullptr, nullptr, nullptr, rows, features,
                           0.f, x_bf16, p_bf16, nullptr, false, &p);
  plan[0] = p.vecs;
  plan[1] = p.blocks;
  plan[2] = p.rows_per_warp;
  return static_cast<int>(e);
}

// x, y: (rows, features) contiguous, 16-byte aligned, fp32 or bf16 (x_bf16);
// scale, bias: (features,) fp32 or bf16 (p_bf16). Returns the cudaError_t of
// the launch.
CONZIC_EXPORT int conzic_layer_norm(const void* x, const void* scale,
                                    const void* bias, void* y, long long rows,
                                    int features, float eps, int x_bf16,
                                    int p_bf16, void* stream) {
  if (rows <= 0) return 0;
  Plan p;
  return static_cast<int>(dispatch(x, scale, bias, y, rows, features, eps,
                                   x_bf16, p_bf16,
                                   static_cast<cudaStream_t>(stream), true,
                                   &p));
}
