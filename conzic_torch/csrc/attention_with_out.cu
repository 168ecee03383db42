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
// The prefix form. As in masked_attention.cu, the keys of row n may be the
// prompt prefix of its image followed by its own: pk, pv (B, P, H, D) and
// k, v (N, Ss, H, D) with N = B * G, keys concat(pk[n / G], k[n]), Sk = P +
// Ss; lens and the causal rule count over the logical Sk. The caller then
// neither broadcasts the prefix to all N rows nor concatenates it.
//
// Bound: bytes. At the main path's text-tower chunk (N = 800, Sq = 16,
// P = 8, Ss = 16, H = 8, D = 64, E = 512, bf16) the prefix form moves 53 MB
// (q 13.1, suffix K/V 26.2, the prefix once per image 0.5, out 13.1, Wo
// 0.5): 0.0159 ms at 3.35 TB/s; the concatenated form 66 MB, 0.0197 ms.
// The products are 7.3 GFLOP, 0.007 ms at the bf16 tensor-core peak.
//
// Two kernels, chosen in conzic_attention_with_out from the type and the
// shape alone:
//
// bf16 with a head width D of 16, 32 or 64, E a multiple of 16, at most 64
// query rows a row n and 16-byte aligned tensors:
// attention_with_out_mma_kernel (below): the attention on mma.sync, the
// output projection on Hopper's warpgroup products (wgmma) fed by the
// Tensor Memory Accelerator through mbarrier rings (hopper_gemm.cuh), a
// persistent block an SM. What bounds it, on an NVIDIA H100 80GB HBM3 at
// 700 W (kernels/ablate.py --kernel attention_with_out): the loads,
// and the attention beside them. A group of 64 query rows needs all of Wo
// (512 KB at E = 512) from L2, because its accumulator, 64 x 512 fp32, is
// all that two warpgroups' registers hold; over the 200 groups of the main
// shape that is 105 MB from L2, and an SM takes in at most 27.7 bytes a
// clock from L2 when every SM pulls at once (probe_rates.cu). The Wo loads
// alone take 0.030 ms and all the loads 0.040 ms, against 0.072 ms for the
// kernel: the attention (a warp a 16-row tile, latency-bound at two warps
// a scheduler) overlaps the loads only in part. The 200 groups are 1.5
// waves of 132 blocks, so the busiest SMs carry 16 units and the others 8.
// A 2-block multicast of each Wo tile would halve the L2 reads, but the
// probe measures a multicast ring taking in 19.1 bytes a clock into an SM,
// not 27.7, so it was not built. The version before this design
// (mma.sync fed by cp.async, the concatenated prefix only, attention and
// projection one after the other in a block) read 0.0866 ms at the main
// shape (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py --trees ...
// --kernels).
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
#include "hopper_gemm.cuh"

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
                              const T* __restrict__ pk,
                              const T* __restrict__ pv,
                              const int* __restrict__ lens,
                              const T* __restrict__ wo, const void* bo,
                              int bo_bf16, T* __restrict__ out, int Sq, int Ss,
                              int P, int G, int H, int D, int E, int causal,
                              float scale) {
  extern __shared__ __align__(16) float smem[];
  const int Sk = P + Ss;
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
    // key j: row j of the image's prefix for j < P, else row j - P of the
    // row's own keys
    for (int i = threadIdx.x; i < Sk * D; i += kTileThreads) {
      const int j = i / D;
      const int d = i - j * D;
      const bool pre = j < P;
      const size_t g =
          pre ? ((static_cast<size_t>(n / G) * P + j) * H + h) * D + d
              : ((static_cast<size_t>(n) * Ss + j - P) * H + h) * D + d;
      ks[j * ld + d] = conzic::to_float((pre ? pk : k)[g]);
      vs[j * ld + d] = conzic::to_float((pre ? pv : v)[g]);
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
int launch(const void* q, const void* k, const void* v, const void* pk,
           const void* pv, const int* lens, const void* wo, const void* bo,
           int bo_bf16, void* out, int N, int Sq, int Ss, int P, int G, int H,
           int D, int E, int causal, float scale, cudaStream_t stream) {
  const size_t smem = shared_bytes(Sq, P + Ss, H, D);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        conzic::mma::allow_shared(attention_with_out_kernel<T>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  attention_with_out_kernel<T><<<N, kTileThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(pk),
      static_cast<const T*>(pv), lens, static_cast<const T*>(wo), bo, bo_bf16,
      static_cast<T*>(out), Sq, Ss, P, G, H, D, E, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the tensor-core version
// ---------------------------------------------------------------------------

namespace hp = conzic::hopper;
namespace tc = conzic::mma;
using hp::bf16;

constexpr int kRows = 64;        // query rows of a group: one wgmma tile
constexpr int kKvRows = 128;     // rows of a group's K (and V) slot, at most
constexpr int kOutCols = 256;    // output columns of a consumer warpgroup
constexpr int kPassCols = 2 * kOutCols;  // of a pass over the heads
constexpr int kConsumers = 256;  // two warpgroups; then the producers'
constexpr int kThreads = kConsumers + 128;
// Units the attention runs ahead of the products (kernels/ablate.py
// --kernel attention_with_out measures 1 against 2).
constexpr int kLookAhead = 2;
constexpr int kQStages = 4;  // q / context tiles: attended, multiplied
constexpr int kMaxKvStages = 3;
constexpr int kWStages = 2;
constexpr int kWSlotBytes = kOutCols * hp::kRowBytes;  // a wgmma's B tile
constexpr int kQBytes = kRows * hp::kRowBytes;
constexpr size_t kHead = 2048;  // alignment slack, barriers, zero chunk

struct Maps {
  CUtensorMap q;       // (N * Sq, H * D), boxes of R * Sq rows
  CUtensorMap k, v;    // (N * Ss, H * D), boxes of R * Ss rows
  CUtensorMap pk, pv;  // (B * P, H * D), boxes of P rows (P > 0)
  CUtensorMap wo;      // (E, H * D), boxes of min(E, 256) rows
};

// Where a group's tiles lie in shared memory, the same on the host and in
// the kernel.
struct Plan {
  int R;          // rows n a group (R * Sq <= 64 query rows)
  int images;     // prefix images a group can touch (0 without a prefix)
  int k_rows;     // rows of a K slot, a multiple of 8
  int p_rows;     // rows of one image's prefix slot, a multiple of 8
  int kv_bytes;   // one K/V stage: k, v, pk, pv
  int kv_stages;  // 2 or 3
  int w_box;      // rows of a box of Wo
  size_t smem;
};

__device__ __forceinline__ unsigned char* aligned_base(unsigned char* raw) {
  return raw + ((hp::kAtomBytes - (hp::smem_u32(raw) & 1023)) & 1023);
}

// A persistent block (one an SM) walks the groups of R rows n, R * Sq query
// rows each (4 rows n at Sq = 16: one wgmma tile). A unit of work is
// (group, pass, chunk): a chunk is 64 of the H * D context columns (64 / D
// heads), a pass 512 of the E output columns; a block's units are numbered
// 0, 1, ... in that order, and every ring slot and barrier phase follows
// from a unit's number. Two producer threads of the producer warpgroup
// bring a unit's tiles by TMA, 128-byte swizzled: one the group's q (one
// box: the rows are neighbours in device memory) into a ring of kQStages,
// and its rows' own K and V and each prefix image's K and V, once for the
// group, into a ring of kv_stages; the other Wo's 64 columns of the chunk,
// one 256-row box for each consumer warpgroup, into a ring of two. The two
// consumer warpgroups attend alternate units, warpgroup u % 2 unit u, each
// running one unit ahead of the products: a warp per (row n, 16-row tile,
// head) runs the masked softmax core (attend_tile_at of attention_mma.cuh,
// mma.sync), key j < P from the prefix slot of the row's image, the rest
// from the row's own, and writes the context over the q tile it has just
// read; the K/V slot then goes back at once. The context tile is then, as
// it lies, the A operand of a 64 x 256 x 64 wgmma of each warpgroup
// against its Wo tile, accumulated in registers over the pass's chunks.
// After a pass's last chunk each warpgroup adds the fp32 bias to its 256
// columns, rounds once and stores.
template <int kKeyTiles>
__global__ void __launch_bounds__(kThreads, 1)
    attention_with_out_mma_kernel(const __grid_constant__ Maps maps,
                                  const Plan plan,
                                  const int* __restrict__ lens,
                                  const void* __restrict__ bo, int bo_bf16,
                                  bf16* __restrict__ out, int N, int Sq,
                                  int Ss, int P, int G, int H, int D, int E,
                                  int causal, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned_base(smem_raw);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty_q = full_q + kQStages;
  uint64_t* ctx_done = empty_q + kQStages;  // the context of a q slot
  uint64_t* full_kv = ctx_done + kQStages;
  uint64_t* empty_kv = full_kv + kMaxKvStages;
  uint64_t* full_w = empty_kv + kMaxKvStages;
  uint64_t* empty_w = full_w + kWStages;
  bf16* zero = reinterpret_cast<bf16*>(base + 512);
  unsigned char* q_ring = base + 1024;
  unsigned char* kv_ring = q_ring + kQStages * kQBytes;
  unsigned char* w_ring = kv_ring + plan.kv_stages * plan.kv_bytes;
  constexpr int w_bytes = 2 * kWSlotBytes;  // a Wo stage
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int R = plan.R;
  const int HD = H * D;
  const int chunks = (HD + hp::kTileK - 1) / hp::kTileK;
  const int passes = (E + kPassCols - 1) / kPassCols;
  const int groups = (N + R - 1) / R;
  const int units = (groups - static_cast<int>(blockIdx.x) +
                     static_cast<int>(gridDim.x) - 1) /
                    static_cast<int>(gridDim.x) * passes * chunks;
  const int heads = hp::kTileK / D;  // a chunk's
  const int k_bytes = plan.k_rows * hp::kRowBytes;
  const int p_bytes = plan.images * plan.p_rows * hp::kRowBytes;
  struct Unit {
    int g, pass, c;
  };
  auto unit = [&](int x) {
    const int per_group = passes * chunks;
    const int local = x / per_group;
    const int r = x - local * per_group;
    return Unit{static_cast<int>(blockIdx.x) + local * static_cast<int>(
                                                   gridDim.x),
                r / chunks, r % chunks};
  };
  // the first and last prefix image of group g's rows
  auto first_image = [&](int g) { return P ? g * R / G : 0; };
  auto last_image = [&](int g) {
    return P ? (min(g * R + R, N) - 1) / G : -1;
  };
  // 256-column tiles of pass `pass` that hold output columns: 1 or 2
  auto w_tiles = [&](int pass) {
    return min(2, (E - pass * kPassCols + kOutCols - 1) / kOutCols);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < kQStages; ++i) {
      hp::bar_init(&full_q[i], 1);
      hp::bar_init(&empty_q[i], kConsumers / 32);
      hp::bar_init(&ctx_done[i], 4);  // the attending warpgroup's warps
    }
    for (int i = 0; i < plan.kv_stages; ++i) {
      hp::bar_init(&full_kv[i], 1);
      hp::bar_init(&empty_kv[i], 4);
    }
    for (int i = 0; i < kWStages; ++i) {
      hp::bar_init(&full_w[i], 1);
      hp::bar_init(&empty_w[i], kConsumers / 32);
    }
    hp::fence_barrier_init();
  }
  if (threadIdx.x < tc::kZeroElems / 2)
    reinterpret_cast<uint32_t*>(zero)[threadIdx.x] = 0u;
  __syncthreads();

  if (warp >= kConsumers / 32) {  // the producer warpgroup: two threads
    hp::producer_registers();
    if (lane != 0) return;
    if (warp == kConsumers / 32) {  // q, then K / V and the prefixes
      for (int x = 0; x < units; ++x) {
        const Unit u = unit(x);
        const int col = u.c * hp::kTileK;
        const int sq = x % kQStages;
        hp::bar_wait(&empty_q[sq], ((x / kQStages) & 1) ^ 1);
        hp::bar_expect(&full_q[sq], R * Sq * hp::kRowBytes);
        hp::tma_load(q_ring + sq * kQBytes, &maps.q, &full_q[sq], col,
                     u.g * R * Sq);
        const int b0 = first_image(u.g), b1 = last_image(u.g);
        const int skv = x % plan.kv_stages;
        hp::bar_wait(&empty_kv[skv], ((x / plan.kv_stages) & 1) ^ 1);
        hp::bar_expect(&full_kv[skv],
                       (2 * R * Ss + 2 * (b1 - b0 + 1) * P) * hp::kRowBytes);
        unsigned char* st = kv_ring + skv * plan.kv_bytes;
        hp::tma_load(st, &maps.k, &full_kv[skv], col, u.g * R * Ss);
        hp::tma_load(st + k_bytes, &maps.v, &full_kv[skv], col, u.g * R * Ss);
        for (int b = b0; b <= b1; ++b) {
          unsigned char* pre = st + 2 * k_bytes +
                               (b - b0) * plan.p_rows * hp::kRowBytes;
          hp::tma_load(pre, &maps.pk, &full_kv[skv], col, b * P);
          hp::tma_load(pre + p_bytes, &maps.pv, &full_kv[skv], col, b * P);
        }
      }
    } else if (warp == kConsumers / 32 + 1) {  // Wo
      for (int x = 0; x < units; ++x) {
        const Unit u = unit(x);
        const int nw = w_tiles(u.pass);
        const int sw = x % kWStages;
        hp::bar_wait(&empty_w[sw], ((x / kWStages) & 1) ^ 1);
        hp::bar_expect(&full_w[sw], nw * plan.w_box * hp::kRowBytes);
        for (int t = 0; t < nw; ++t)
          hp::tma_load(w_ring + sw * w_bytes + t * kWSlotBytes, &maps.wo,
                       &full_w[sw], u.c * hp::kTileK,
                       u.pass * kPassCols + t * kOutCols);
      }
    }
    return;
  }

  // the accumulator (128 registers) stays live through the attention
  hp::consumer_registers();
  const int wg = warp >> 2;
  const int m_tiles = (Sq + 15) / 16;
  const int items = R * m_tiles * heads;
  const int Sk = P + Ss;

  // this warpgroup's attention of unit x: the context over its q tile
  auto attend = [&](int x) {
    const Unit u = unit(x);
    const int n0 = u.g * R;
    const int b0 = first_image(u.g);
    const int sq = x % kQStages;
    const int skv = x % plan.kv_stages;
    hp::bar_wait(&full_q[sq], (x / kQStages) & 1);
    hp::bar_wait(&full_kv[skv], (x / plan.kv_stages) & 1);
    bf16* qs = reinterpret_cast<bf16*>(q_ring + sq * kQBytes);
    const bf16* ks = reinterpret_cast<const bf16*>(kv_ring +
                                                   skv * plan.kv_bytes);
    const bf16* vs = ks + k_bytes / 2;
    const bf16* pks = vs + k_bytes / 2;
    const bf16* pvs = pks + p_bytes / 2;
    for (int it = warp & 3; it < items; it += 4) {
      const int i = it / (m_tiles * heads);
      const int r0 = it / heads % m_tiles * 16;
      const int hl = it % heads;
      const int n = n0 + i;
      if (n >= N || u.c * heads + hl >= H) continue;
      const int q0 = i * Sq + r0;
      const int k0 = i * Ss - P;
      const int p0 = P ? (n / G - b0) * plan.p_rows : 0;
      const int h0 = hl * D;
      tc::attend_tile_at<kKeyTiles>(
          [&](int r, int col) { return hp::swizzled(qs, q0 + r, h0 + col); },
          min(16, Sq - r0),
          [&](int j, int col) {
            return j < P ? hp::swizzled(pks, p0 + j, h0 + col)
                         : hp::swizzled(ks, k0 + j, h0 + col);
          },
          [&](int j, int col) {
            return j < P ? hp::swizzled(pvs, p0 + j, h0 + col)
                         : hp::swizzled(vs, k0 + j, h0 + col);
          },
          Sk, D, lens ? lens[n] : Sk, causal != 0, r0 + Sk - Sq, scale, zero,
          lane, [&](int r, int d, float v0, float v1) {
            tc::store_bf16x2(hp::swizzled(qs, q0 + r, h0 + d), v0, v1);
          });
    }
    // the context is a wgmma operand: visible to the async proxy before
    // this warp says it is done; the K/V slot is free
    hp::fence_async_shared();
    __syncwarp();
    if (lane == 0) {
      hp::bar_arrive(&ctx_done[sq]);
      hp::bar_arrive(&empty_kv[skv]);
    }
  };
  // unit x's q slot and Wo stage go back once both warpgroups' products of
  // it are done
  auto release = [&](int x) {
    if (lane == 0) {
      hp::bar_arrive(&empty_q[x % kQStages]);
      hp::bar_arrive(&empty_w[x % kWStages]);
    }
  };

  float acc[kOutCols / 2];
#pragma unroll
  for (int i = 0; i < kOutCols / 2; ++i) acc[i] = 0.f;
  // rows of the group, columns of the warpgroup: bias, one rounding
  auto store_pass = [&](const Unit& u) {
    const int n0 = u.g * R;
    const int m = (warp & 3) * 16 + (lane >> 2);
    const int c0 = u.pass * kPassCols + wg * kOutCols;
#pragma unroll
    for (int j = 0; j < kOutCols / 8; ++j) {
      const int col = c0 + 8 * j + 2 * (lane & 3);
      if (col >= E) continue;
      const float b0v = conzic::load_param(bo, col, bo_bf16);
      const float b1v = conzic::load_param(bo, col + 1, bo_bf16);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m + 8 * half;
        if (r >= R * Sq || n0 * Sq + r >= N * Sq) continue;
        tc::store_bf16x2(out + (static_cast<size_t>(n0) * Sq + r) * E + col,
                         acc[4 * j + 2 * half] + b0v,
                         acc[4 * j + 2 * half + 1] + b1v);
      }
    }
  };

  int ahead = wg;         // the next unit this warpgroup attends
  bool pending = false;   // unit x - 1 waits for its product to finish
  // Each iteration first hands the previous unit's stages back and issues
  // unit x's product, then attends this warpgroup's units up to x +
  // kLookAhead: the two warpgroups attend alternate units side by side,
  // while the products run and the next Wo tiles fly. A q slot lives from
  // its attention to its product: kQStages >= kLookAhead + 2.
  for (; ahead < kLookAhead && ahead < units; ahead += 2) attend(ahead);
  for (int x = 0; x < units; ++x) {
    const Unit u = unit(x);
    const int nw = w_tiles(u.pass);
    hp::bar_wait(&ctx_done[x % kQStages], (x / kQStages) & 1);
    hp::wgmma_wait<0>();  // the previous unit's product is done
    hp::hold(acc);
    if (pending) release(x - 1);
    const int sw = x % kWStages;
    hp::bar_wait(&full_w[sw], (x / kWStages) & 1);
    // both warpgroups multiply, also one whose Wo tile lies past E (its
    // slot then holds older bytes, and its columns are never stored): a
    // product under a branch would be serialised by ptxas
    hp::hold(acc);
    hp::wgmma_tile<kOutCols>(
        acc, hp::tile_desc(q_ring + (x % kQStages) * kQBytes),
        hp::tile_desc(w_ring + sw * w_bytes + wg * kWSlotBytes), u.c > 0);
    pending = true;
    if (u.c + 1 == chunks) {  // the pass's last chunk: its output
      hp::wgmma_wait<0>();
      hp::hold(acc);
      release(x);
      pending = false;
      if (wg < nw) store_pass(u);
    }
    for (; ahead <= x + kLookAhead && ahead < units; ahead += 2)
      attend(ahead);
  }
}

// The layout of a shape, or R == 0 where the kernel does not take it: D
// not 16, 32 or 64 (a chunk of 64 context columns holds whole heads), E not
// a multiple of 16, more than 64 query rows, or tiles too large for an SM.
// R is the most rows n whose query rows fill at most one wgmma tile and
// whose K/V slots (at most kKvRows rows each) leave room for two K/V
// stages; three where they fit.
Plan mma_plan(int Sq, int Ss, int P, int G, int E, int D) {
  if ((D != 16 && D != 32 && D != 64) || E % 16 || Sq > kRows) return {};
  const size_t fixed = kHead + kQStages * static_cast<size_t>(kQBytes) +
                       kWStages * 2 * static_cast<size_t>(kWSlotBytes);
  for (int R = std::max(1, std::min(kRows / Sq, kKvRows / Ss)); R >= 1;
       --R) {
    Plan plan = {};
    plan.R = R;
    plan.images = P ? std::min(R, (R + G - 2) / G + 1) : 0;
    plan.k_rows = (R * Ss + 7) / 8 * 8;
    plan.p_rows = (P + 7) / 8 * 8;
    plan.kv_bytes =
        2 * (plan.k_rows + plan.images * plan.p_rows) * hp::kRowBytes;
    plan.w_box = std::min(E, kOutCols);
    for (int stages = kMaxKvStages; stages >= 2; --stages) {
      const size_t smem = fixed + stages * static_cast<size_t>(plan.kv_bytes);
      if (smem <= tc::kMaxShared) {
        plan.kv_stages = stages;
        plan.smem = smem;
        return plan;
      }
    }
  }
  return {};
}

template <int kKeyTiles>
int launch_mma(const Maps& maps, const Plan& plan, const int* lens,
               const void* bo, int bo_bf16, void* out, int N, int Sq, int Ss,
               int P, int G, int H, int D, int E, int sms, int causal,
               float scale, cudaStream_t stream) {
  auto* kernel = attention_with_out_mma_kernel<kKeyTiles>;
  const cudaError_t e = tc::allow_shared(kernel, plan.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int groups = (N + plan.R - 1) / plan.R;
  kernel<<<std::min(groups, sms), kThreads, plan.smem, stream>>>(
      maps, plan, lens, bo, bo_bf16, static_cast<bf16*>(out), N, Sq, Ss, P,
      G, H, D, E, causal, scale);
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

// Largest key count (P + Ss) and head width the kernels take. A shape whose
// context (Sq x H * D floats) does not fit the scalar kernel's shared
// memory beside its tiles is refused at the launch (cudaErrorInvalidValue).
CONZIC_EXPORT int conzic_attention_with_out_max_keys() { return kMaxKeys; }
CONZIC_EXPORT int conzic_attention_with_out_max_head_dim() { return 128; }

// q: (N, Sq, H, D); k, v: (N, Ss, H, D); pk, pv: (N / G, P, H, D), or null
// with P = 0; wo: (E, H * D); out: (N, Sq, E); all contiguous, one type
// (fp32, or bf16 when bf16 != 0). The keys of row n are concat(pk[n / G],
// k[n]), Sk = P + Ss. bo: (E,) fp32, or bf16 when bo_bf16 != 0. lens: (N,)
// int32 or null (= Sk). Returns the cudaError_t of the launch. bf16 takes
// the tensor-core kernel where mma_plan gives it a layout and every tensor
// is 16-byte aligned, else the scalar kernel; fp32 always the scalar.
CONZIC_EXPORT int conzic_attention_with_out(
    const void* q, const void* k, const void* v, const void* pk,
    const void* pv, const int* lens, const void* wo, const void* bo,
    void* out, int N, int Sq, int Ss, int P, int G, int H, int D, int E,
    int causal, float scale, int bf16, int bo_bf16, void* stream) {
  if (N <= 0 || Sq <= 0) return 0;
  if (P == 0) G = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16)
    return launch<float>(q, k, v, pk, pv, lens, wo, bo, bo_bf16, out, N, Sq,
                         Ss, P, G, H, D, E, causal, scale, s);
  const Plan plan = mma_plan(Sq, Ss, P, G, E, D);
  const bool aligned = hp::aligned16(q) && hp::aligned16(k) &&
                       hp::aligned16(v) && hp::aligned16(wo) &&
                       (P == 0 || (hp::aligned16(pk) && hp::aligned16(pv)));
  if (plan.R == 0 || !aligned)
    return launch<__nv_bfloat16>(q, k, v, pk, pv, lens, wo, bo, bo_bf16, out,
                                 N, Sq, Ss, P, G, H, D, E, causal, scale, s);
  cudaError_t e;
  const int sms = sm_count(&e);
  if (e != cudaSuccess) return static_cast<int>(e);
  const uint64_t HD = static_cast<uint64_t>(H) * D;
  Maps maps;
  const int R = plan.R;
  e = hp::tensor_map(&maps.q, q, static_cast<uint64_t>(N) * Sq, HD, HD,
                     R * Sq);
  if (e == cudaSuccess)
    e = hp::tensor_map(&maps.k, k, static_cast<uint64_t>(N) * Ss, HD, HD,
                       R * Ss);
  if (e == cudaSuccess)
    e = hp::tensor_map(&maps.v, v, static_cast<uint64_t>(N) * Ss, HD, HD,
                       R * Ss);
  if (e == cudaSuccess && P > 0)
    e = hp::tensor_map(&maps.pk, pk, static_cast<uint64_t>(N / G) * P, HD, HD,
                       P);
  if (e == cudaSuccess && P > 0)
    e = hp::tensor_map(&maps.pv, pv, static_cast<uint64_t>(N / G) * P, HD, HD,
                       P);
  if (e == cudaSuccess)
    e = hp::tensor_map(&maps.wo, wo, E, HD, HD, plan.w_box);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto* go = launch_mma<8>;
  switch (tc::key_tiles_for(P + Ss)) {
    case 1: go = launch_mma<1>; break;
    case 2: go = launch_mma<2>; break;
    case 4: go = launch_mma<4>; break;
  }
  return go(maps, plan, lens, bo, bo_bf16, out, N, Sq, Ss, P, G, H, D, E, sms,
            causal, scale, s);
}
