// Two rates of the card that the tensor-core kernels' designs rest on,
// measured with nothing else going on (a program of its own, built and run
// by conzic_torch/kernels/probe.py; no kernel of the port includes it):
//   1. how often a warp can start an mma.sync.m16n8k16 (bf16, fp32 sums), with
//      1, 4, 8 and 16 warps on an SM;
//   2. how many bytes a clock an SM takes in from L2 through a ring of
//      cp.async stages as attention_mma.cuh builds it (256 threads, 16 bytes
//      a copy, rows of 128 bytes padded to 144 in shared memory), with every
//      SM copying at once, and no product to wait for.
#include <cstdint>
#include <cstdio>

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int kAccs = 8;  // independent accumulators: no mma waits for one

__global__ void mma_rate(float* out, long long* clocks, int iters) {
  float c[kAccs][4] = {};
  const uint32_t a[4] = {threadIdx.x, 2, 3, 4};
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < kAccs; ++j) mma_bf16(c[j], a, i, j);
  }
  const long long t1 = clock64();
  float s = 0.f;
  for (int j = 0; j < kAccs; ++j)
    for (int q = 0; q < 4; ++q) s += c[j][q];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) clocks[0] = t1 - t0;
}

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

constexpr int kRowStride = 1536;  // bytes between rows: a 768-wide weight

// Every block copies `steps` tiles of `rows` x 128 bytes; block b starts at
// its own place in the buffer, so the blocks do not all ask for one line.
template <int kStages>
__global__ void __launch_bounds__(256, 1)
    copy_rate(const char* g, size_t g_bytes, int rows, int steps,
              long long* clocks) {
  extern __shared__ __align__(128) char ring[];
  const int tile = rows * 144;
  auto load = [&](int step) {
    size_t base = (static_cast<size_t>(blockIdx.x * 3 + 1) * rows * kRowStride +
                   static_cast<size_t>(step) * 128) %
                  (g_bytes - static_cast<size_t>(rows) * kRowStride - 4096);
    base &= ~static_cast<size_t>(127);
    char* dst = ring + (step % kStages) * tile;
    for (int i = threadIdx.x; i < rows * 8; i += 256) {
      const int r = i >> 3, c = (i & 7) * 16;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       shared_address(dst + r * 144 + c)),
                   "l"(g + base + static_cast<size_t>(r) * kRowStride + c)
                   : "memory");
    }
  };
  for (int s = 0; s < kStages - 1; ++s) {
    load(s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  const long long t0 = clock64();
  for (int step = 0; step < steps; ++step) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    __syncthreads();
    load(step + kStages - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  const long long t1 = clock64();
  if (threadIdx.x == 0 && blockIdx.x == 0) clocks[0] = t1 - t0;
}

template <int kStages>
void run_copy(const char* g, size_t g_bytes, int sms, int rows,
              long long* clocks) {
  const int steps = 400;
  const int smem = kStages * rows * 144;
  cudaFuncSetAttribute(copy_rate<kStages>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  copy_rate<kStages><<<sms, 256, smem>>>(g, g_bytes, rows, steps, clocks);
  long long h = 0;
  cudaMemcpy(&h, clocks, sizeof(h), cudaMemcpyDeviceToHost);
  printf("copy %d stages of %d KB: %.0f clocks a tile, %.1f bytes a clock an "
         "SM, %.2f KB a clock over %d SMs\n",
         kStages, rows * 128 / 1024, h / static_cast<double>(steps),
         rows * 128.0 * steps / h, rows * 128.0 * steps / h * sms / 1024,
         sms);
}

}  // namespace

int main() {
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  const int sms = prop.multiProcessorCount;
  printf("%s, %d SMs\n", prop.name, sms);
  float* out;
  long long* clocks;
  cudaMalloc(&out, 1 << 22);
  cudaMalloc(&clocks, 64);
  for (int warps : {1, 4, 8, 16}) {
    const int iters = 1000;
    mma_rate<<<sms, warps * 32>>>(out, clocks, iters);
    long long h = 0;
    cudaMemcpy(&h, clocks, sizeof(h), cudaMemcpyDeviceToHost);
    const double per_warp = h / static_cast<double>(iters * kAccs);
    printf("mma %2d warps an SM: %.2f clocks an mma a warp, %.2f a scheduler\n",
           warps, per_warp, per_warp / ((warps + 3) / 4));
  }
  const size_t g_bytes = 8 << 20;  // stays in L2
  char* g;
  cudaMalloc(&g, g_bytes);
  cudaMemset(g, 1, g_bytes);
  for (int rows : {128, 256}) {
    run_copy<3>(g, g_bytes, sms, rows, clocks);
    run_copy<6>(g, g_bytes, sms, rows, clocks);
  }
  const cudaError_t e = cudaDeviceSynchronize();
  printf("%s\n", cudaGetErrorString(e));
  return e == cudaSuccess ? 0 : 1;
}
