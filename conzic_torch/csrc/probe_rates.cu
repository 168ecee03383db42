// The rates of the card that the tensor-core kernels' designs rest on,
// measured with nothing else going on (a program of its own, built and run
// by conzic_torch/kernels/probe.py; no kernel of the port includes it):
//   1. how often a warp can start an mma.sync.m16n8k16 (bf16, fp32 sums), with
//      1, 4, 8 and 16 warps on an SM (the attention's softmax core);
//   2. how many bytes a clock an SM takes in from L2 through a ring of
//      cp.async stages (256 threads, 16 bytes a copy, rows of 128 bytes
//      padded to 144 in shared memory), with every SM copying at once, and
//      no product to wait for (masked_attention.cu's copies);
//   3. how often a warpgroup can start a wgmma.m64n192k16 and a
//      wgmma.m64n256k16 (bf16, fp32 sums, both operands from shared memory,
//      hopper_gemm.cuh), one and two warpgroups on an SM (the two fused
//      kernels' projections);
//   4. how many bytes a clock an SM takes in from L2 through a ring of TMA
//      loads of 32 KB boxes (256 rows x 128 bytes, 128-byte swizzle, four
//      stages, one producer thread, mbarriers), every SM at once: alone,
//      and in clusters of two blocks where each block loads half of every
//      box and multicasts it to both (L2 then serves each byte once for two
//      SMs).
#include <cstdint>
#include <cstdio>

#include <cuda_runtime.h>

#include "hopper_gemm.cuh"

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

namespace hp = conzic::hopper;

// 3. wgmma: kIters groups of four k16 steps on one accumulator, two groups
// in flight, on a 64 x 64 A tile and a kN x 64 B tile of zeros.
template <int kN>
__global__ void __launch_bounds__(256, 1)
    wgmma_rate(float* out, long long* clocks, int iters) {
  extern __shared__ unsigned char raw[];
  unsigned char* base = raw + ((1024 - (hp::smem_u32(raw) & 1023)) & 1023);
  for (int i = threadIdx.x; i < (64 + kN) * 32; i += blockDim.x)
    reinterpret_cast<uint32_t*>(base)[i] = 0u;
  __syncthreads();
  hp::fence_async_shared();
  float acc[kN / 2];
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
  const uint64_t a = hp::tile_desc(base);
  const uint64_t b = hp::tile_desc(base + 64 * hp::kRowBytes);
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    hp::hold(acc);
    hp::wgmma_tile<kN>(acc, a, b, true);
    hp::wgmma_wait<1>();
    hp::hold(acc);
  }
  hp::wgmma_wait<0>();
  hp::hold(acc);
  const long long t1 = clock64();
  float s = 0.f;
  for (int i = 0; i < kN / 2; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) clocks[0] = t1 - t0;
}

template <int kN>
void run_wgmma(int sms, float* out, long long* clocks) {
  const int iters = 2000;
  const int smem = 1024 + (64 + kN) * hp::kRowBytes;
  cudaFuncSetAttribute(wgmma_rate<kN>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  for (int groups : {1, 2}) {
    wgmma_rate<kN><<<sms, 128 * groups, smem>>>(out, clocks, iters);
    long long h = 0;
    cudaMemcpy(&h, clocks, sizeof(h), cudaMemcpyDeviceToHost);
    const double per = h / (iters * 4.0);  // clocks a wgmma, one group's
    printf("wgmma m64n%dk16, %d warpgroup(s) an SM: %.1f clocks a wgmma a "
           "warpgroup, %.0f dense FLOP a clock an SM\n",
           kN, groups, per, 2.0 * 64 * kN * 16 * groups / per);
  }
}

// 4. TMA ring: a producer thread and a consumer warp a block; the consumer
// frees each stage as soon as it has landed. kCluster blocks of a cluster
// each load 256 / kCluster rows of every box and multicast them to all.
constexpr int kRingStages = 4;
constexpr int kBoxRows = 256;
constexpr int kBoxBytes = kBoxRows * hp::kRowBytes;

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int kCluster>
__global__ void __launch_bounds__(64, 1)
    tma_rate(const __grid_constant__ CUtensorMap map, int steps,
             long long* clocks) {
  extern __shared__ unsigned char raw[];
  unsigned char* base = raw + ((1024 - (hp::smem_u32(raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + kRingStages;
  unsigned char* ring = base + 1024;
  uint32_t rank = 0;
  if (kCluster > 1) asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRingStages; ++i) {
      hp::bar_init(&full[i], 1);
      hp::bar_init(&empty[i], kCluster);
    }
    hp::fence_barrier_init();
  }
  if (kCluster > 1) cluster_sync(); else __syncthreads();
  const int cluster = blockIdx.x / kCluster;
  constexpr int kPart = kBoxRows / kCluster;
  if (threadIdx.x == 0) {  // the producer
    int st = 0;
    uint32_t phase = 0;
    for (int t = 0; t < steps; ++t) {
      hp::bar_wait(&empty[st], phase ^ 1);
      hp::bar_expect(&full[st], kBoxBytes);
      const int col = (cluster * 7 + t) % 16 * 64;
      const int row = (cluster * 3 + t) % 16 * kBoxRows + rank * kPart;
      unsigned char* dst = ring + st * kBoxBytes + rank * kPart * hp::kRowBytes;
      if (kCluster == 1) {
        hp::tma_load(dst, &map, &full[st], col, row);
      } else {
        const uint16_t mask = (1u << kCluster) - 1;
        asm volatile(
            "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
            "complete_tx::bytes.multicast::cluster [%0], [%1, {%3, %4}], "
            "[%2], %5;\n" ::"r"(hp::smem_u32(dst)),
            "l"(reinterpret_cast<uint64_t>(&map)),
            "r"(hp::smem_u32(&full[st])), "r"(col), "r"(row), "h"(mask)
            : "memory");
      }
      if (++st == kRingStages) {
        st = 0;
        phase ^= 1;
      }
    }
  } else if (threadIdx.x == 32) {  // the consumer: frees what has landed
    int st = 0;
    uint32_t phase = 0;
    const long long t0 = clock64();
    for (int t = 0; t < steps; ++t) {
      hp::bar_wait(&full[st], phase);
      for (uint32_t peer = 0; peer < kCluster; ++peer) {
        // this block's and every other block's producer wait for it
        uint32_t remote;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                     : "=r"(remote)
                     : "r"(hp::smem_u32(&empty[st])), "r"(peer));
        asm volatile(
            "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
            ::"r"(remote) : "memory");
      }
      if (++st == kRingStages) {
        st = 0;
        phase ^= 1;
      }
    }
    const long long t1 = clock64();
    if (blockIdx.x == 0) clocks[0] = t1 - t0;
  }
  if (kCluster > 1) cluster_sync();
}

template <int kCluster>
void run_tma(const CUtensorMap& map, int sms, long long* clocks) {
  const int steps = 2000;
  const int smem = 1024 + 1024 + kRingStages * kBoxBytes;
  auto* kernel = tma_rate<kCluster>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sms / kCluster * kCluster);
  cfg.blockDim = dim3(64);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, map, steps, clocks);
  long long h = 0;
  cudaMemcpy(&h, clocks, sizeof(h), cudaMemcpyDeviceToHost);
  const double in = static_cast<double>(kBoxBytes) * steps / h;
  printf("tma ring of %d x 32 KB, %s: %.1f bytes a clock into an SM, %.1f "
         "from L2 an SM (%s)\n",
         kRingStages,
         kCluster == 1 ? "each block alone" : "2-block multicast", in,
         in / kCluster, cudaGetErrorString(e));
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
  run_wgmma<192>(sms, out, clocks);
  run_wgmma<256>(sms, out, clocks);
  // the 8 MB buffer as a (4096, 1024) bf16 matrix, read in boxes of 256
  // rows, or of 128 where two blocks share each box
  CUtensorMap whole, half;
  cudaError_t me = hp::tensor_map(&whole, g, 4096, 1024, 1024, kBoxRows);
  if (me == cudaSuccess)
    me = hp::tensor_map(&half, g, 4096, 1024, 1024, kBoxRows / 2);
  if (me != cudaSuccess) {
    printf("tensor map: %s\n", cudaGetErrorString(me));
    return 1;
  }
  run_tma<1>(whole, sms, clocks);
  run_tma<2>(half, sms, clocks);
  const cudaError_t e = cudaDeviceSynchronize();
  printf("%s\n", cudaGetErrorString(e));
  return e == cudaSuccess ? 0 : 1;
}
