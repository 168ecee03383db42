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
// The shared prefix at image width. Optionally the keys of row n are the
// prompt prefix of its image followed by its own: pk, pv (B, P, H, D) and
// k, v (N, Ss, H, D) with N = B * G, row n of image n / G, so that the
// logical keys are concat(pk[n / G], k[n]) and Sk = P + Ss. The caller then
// neither broadcasts the prefix to all N rows nor concatenates it (the idea
// of two_block_prefix_attention in conzic_tpu/ops/attention.py, inside the
// kernel). lens and the causal rule count over the logical Sk.
//
// Bound: bytes. The sequences are short (Sk <= 77 on every path of the
// engine), so a head's logits are Sq x Sk dot products of length D: at the
// main path's text-tower chunk (N = 800, Sq = 16, P = 8, Ss = 16, H = 8,
// D = 64, bf16) the call does 0.63 GFLOP (under 1 us at the bf16
// tensor-core peak) against 13.1 MB of q, 26.2 MB of suffix k and v, 13.1 MB
// of output and 0.5 MB of prefix read once per image: 52.9 MB, about 16 us
// at 3.35 TB/s.
//
// Two kernels, chosen in conzic_masked_attention by type and shape alone:
//
// bf16 with D a multiple of 16 (and 16-byte aligned tensors):
// masked_attention_mma_kernel, on the tensor cores (attend_tile_rows of
// attention_mma.cuh: mma.sync m16n8k16 fed by ldmatrix). A unit of work is
// one row n and a group of hg neighbouring heads; its q, k and v are hg * D
// contiguous values a sequence row in device memory, copied by 16-byte
// cp.async into padded bf16 tiles, and the image's prefix K/V likewise. A
// block takes a contiguous range of units (head group major, row n minor,
// so neighbouring units share an image) and runs them through a ring of two
// stages: the next unit's copies fly while one is attended and written out.
// Both ways of overlapping are used. The ring is what lets the prefix of an
// image be copied once for all of a block's units of that image (a block of
// one unit would copy it once a row); several resident blocks an SM keep
// more copies in flight than one ring can. hg is the largest divisor of H
// that still gives each SM kUnitsPerSm units: 4 of 8 heads at the text
// chunks (1,600 units of 24 KB of q/k/v, three blocks of 4 warps an SM, 67.7
// KB of shared memory each), 1 head at the prompt prefix, BERT and vision.
// Blocks are one wave, as many as fit the card at once, with unit counts
// within one of each other. The prefix has a buffer per ring stage, picked
// by the count of prefix changes since the block's first unit, so a buffer
// is refilled only once no unit in the ring still reads it. A warp takes one
// (head, 16-row tile) at a time: a lane whose key j < P hands ldmatrix a row
// of the staged prefix, the others a row of the unit's own keys. The context
// is written over the q tile just consumed, then the whole unit goes to
// device memory with 16-byte stores.
//
// Everything else (fp32, which must stay exact fp32 and never TF32, and
// bf16 at other widths): masked_attention_kernel, scalar. One block per
// (n, head) stages that head's K and V in shared memory as fp32 (rows
// padded to D + 1 floats, so a warp reading one feature of 32 keys hits 32
// banks), 4 values a load where D allows it, key j < P from the image's
// prefix; then each warp takes query rows: a lane computes the logits of
// keys lane, lane + 32, ..., the warp reduces max and sum with shuffles,
// and each lane accumulates output features lane, lane + 32, ... .

#include <stdint.h>

#include <algorithm>

#include "attention_mma.cuh"

namespace {

using conzic::kMaxKeys;
namespace tc = conzic::mma;
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// The scalar kernel
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;

// kVec values of T, read with one load, as floats.
__device__ __forceinline__ void to_floats(float v, float (&f)[1]) { f[0] = v; }
__device__ __forceinline__ void to_floats(bf16 v, float (&f)[1]) {
  f[0] = __bfloat162float(v);
}
__device__ __forceinline__ void to_floats(float4 v, float (&f)[4]) {
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void to_floats(uint2 v, float (&f)[4]) {
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v.y));
  f[0] = lo.x;
  f[1] = lo.y;
  f[2] = hi.x;
  f[3] = hi.y;
}
template <typename T, int kVec>
struct VecOf;
template <>
struct VecOf<float, 1> { using type = float; };
template <>
struct VecOf<float, 4> { using type = float4; };
template <>
struct VecOf<bf16, 1> { using type = bf16; };
template <>
struct VecOf<bf16, 4> { using type = uint2; };

template <typename T, int kVec>
__global__ void __launch_bounds__(kWarps * 32)
    masked_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ pk,
                            const T* __restrict__ pv,
                            const int* __restrict__ lens, T* __restrict__ out,
                            int Sq, int Ss, int P, int G, int H, int D,
                            int causal, float scale) {
  using Vec = typename VecOf<T, kVec>::type;
  extern __shared__ float smem[];
  const int Sk = P + Ss;
  const int ld = D + 1;
  float* ks = smem;                // [Sk][ld]
  float* vs = ks + Sk * ld;        // [Sk][ld]
  float* qs = vs + Sk * ld;        // [kWarps][D]
  float* ws = qs + kWarps * D;     // [kWarps][kMaxKeys]
  const int n = blockIdx.x / H;
  const int h = blockIdx.x - n * H;
  const size_t HD = static_cast<size_t>(H) * D;

  // key j: row j of the image's prefix for j < P, else row j - P of the
  // row's own keys. A thread steps through (key, vector) pairs with two
  // additions, its first pair and its step divided out once.
  const size_t own = (static_cast<size_t>(n) * Ss * H + h) * D;
  const size_t pre = P ? (static_cast<size_t>(n / G) * P * H + h) * D : 0;
  const int vecs = D / kVec;
  const int dj = blockDim.x / vecs;
  const int dc = blockDim.x - dj * vecs;
  for (int j = threadIdx.x / vecs, c = threadIdx.x - j * vecs; j < Sk;) {
    const size_t at = (j < P ? pre + j * HD : own + (j - P) * HD) + c * kVec;
    float kf[kVec], vf[kVec];
    to_floats(*reinterpret_cast<const Vec*>((j < P ? pk : k) + at), kf);
    to_floats(*reinterpret_cast<const Vec*>((j < P ? pv : v) + at), vf);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      ks[j * ld + c * kVec + e] = kf[e];
      vs[j * ld + c * kVec + e] = vf[e];
    }
    c += dc;
    j += dj;
    if (c >= vecs) {
      c -= vecs;
      ++j;
    }
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int kVec>
int launch_scalar(const void* q, const void* k, const void* v, const void* pk,
                  const void* pv, const int* lens, void* out, int N, int Sq,
                  int Ss, int P, int G, int H, int D, int causal, float scale,
                  cudaStream_t stream) {
  const size_t smem = shared_bytes(P + Ss, D);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        tc::allow_shared(masked_attention_kernel<T, kVec>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  masked_attention_kernel<T, kVec><<<N * H, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(pk),
      static_cast<const T*>(pv), lens, static_cast<T*>(out), Sq, Ss, P, G, H,
      D, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// 4 values a load where every row start is 16-byte aligned (fp32) or 8-byte
// aligned (bf16): D a multiple of 4 and aligned tensors.
template <typename T>
int launch(const void* q, const void* k, const void* v, const void* pk,
           const void* pv, const int* lens, void* out, int N, int Sq, int Ss,
           int P, int G, int H, int D, int causal, float scale,
           cudaStream_t stream) {
  const uintptr_t mask = 4 * sizeof(T) - 1;
  const bool vec = D % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v) |
                     reinterpret_cast<uintptr_t>(pk) |
                     reinterpret_cast<uintptr_t>(pv)) & mask) == 0;
  auto* go = vec ? launch_scalar<T, 4> : launch_scalar<T, 1>;
  return go(q, k, v, pk, pv, lens, out, N, Sq, Ss, P, G, H, D, causal, scale,
            stream);
}

// ---------------------------------------------------------------------------
// The tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 8;
// Two ring stages: one unit's copies in flight while one is attended. Three
// were slower at the text chunks (fewer blocks fit an SM), and so were head
// groups that give each SM one unit where eight are to be had (H100; PERF.md).
constexpr int kStages = 2;
constexpr int kUnitsPerSm = 8;

template <int kKeyTiles>
__global__ void __launch_bounds__(kMmaWarps * 32, kKeyTiles >= 8 ? 1 : 2)
    masked_attention_mma_kernel(const bf16* __restrict__ q,
                                const bf16* __restrict__ k,
                                const bf16* __restrict__ v,
                                const bf16* __restrict__ pk,
                                const bf16* __restrict__ pv,
                                const int* __restrict__ lens,
                                bf16* __restrict__ out, int N, int Sq, int Ss,
                                int P, int G, int H, int D, int hg,
                                int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int W = hg * D;  // columns of a unit's tiles
  const int ld = W + tc::kPad;
  const size_t HD = static_cast<size_t>(H) * D;
  const int Sk = P + Ss;
  const int stage_elems = (Sq + 2 * Ss) * ld;  // [q][k][v] of one unit
  const int prefix_elems = 2 * P * ld;         // [pk][pv] of one image
  bf16* zero = reinterpret_cast<bf16*>(smem_raw);
  bf16* stage0 = zero + tc::kZeroElems;
  bf16* prefix0 = stage0 + kStages * stage_elems;
  // the block's share of the U units, within one of every other block's
  const long U = static_cast<long>(N) * (H / hg);
  const int u_begin = static_cast<int>(U * blockIdx.x / gridDim.x);
  const int u_end = static_cast<int>(U * (blockIdx.x + 1) / gridDim.x);
  const int B = N / G;
  // the prefix a unit reads, numbered so that neighbouring units give equal
  // or consecutive numbers
  auto prefix_of = [&](int u) {
    const int grp = u / N;
    return grp * B + (u - grp * N) / G;
  };
  const int prefix_first = prefix_of(u_begin);

  // A thread copies 16-byte chunks (r, c), (r, c) + its step, ... of a tile
  // of W columns: its first chunk and its step divided out once.
  const int cpr = W >> 3;  // chunks a row
  const int r_first = threadIdx.x / cpr;
  const int c_first = threadIdx.x - r_first * cpr;
  const int dr = blockDim.x / cpr;
  const int dc = blockDim.x - dr * cpr;
  auto copy_in = [&](bf16* dst, const bf16* src, int rows) {
    for (int r = r_first, c = c_first; r < rows;) {
      tc::cp_async16(dst + r * ld + c * 8, src + r * HD + c * 8);
      c += dc;
      r += dr;
      if (c >= cpr) {
        c -= cpr;
        ++r;
      }
    }
  };
  auto load_unit = [&](int u) {
    const int grp = u / N;
    const int n = u - grp * N;
    const size_t col = static_cast<size_t>(grp) * W;
    bf16* st = stage0 + (u - u_begin) % kStages * stage_elems;
    copy_in(st, q + n * Sq * HD + col, Sq);
    copy_in(st + Sq * ld, k + n * Ss * HD + col, Ss);
    copy_in(st + (Sq + Ss) * ld, v + n * Ss * HD + col, Ss);
    if (P > 0 && (u == u_begin || prefix_of(u) != prefix_of(u - 1))) {
      bf16* ps = prefix0 + (prefix_of(u) - prefix_first) % kStages *
                               prefix_elems;
      const size_t b = n / G;
      copy_in(ps, pk + b * P * HD + col, P);
      copy_in(ps + P * ld, pv + b * P * HD + col, P);
    }
  };

  if (threadIdx.x < tc::kZeroElems / 2)
    reinterpret_cast<uint32_t*>(zero)[threadIdx.x] = 0u;
  for (int i = 0; i < kStages - 1; ++i) {
    if (u_begin + i < u_end) load_unit(u_begin + i);
    tc::cp_async_commit();
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int items = hg * ((Sq + 15) / 16);  // (head, 16-row tile) pairs
  for (int u = u_begin; u < u_end; ++u) {
    tc::cp_async_wait<kStages - 2>();  // this thread's share of unit u
    // everyone's share is in, and the previous unit's stage has been
    // written out: it takes the copies of the unit kStages - 1 ahead
    __syncthreads();
    if (u + kStages - 1 < u_end) load_unit(u + kStages - 1);
    tc::cp_async_commit();

    const int grp = u / N;
    const int n = u - grp * N;
    bf16* st = stage0 + (u - u_begin) % kStages * stage_elems;
    const bf16* ks = st + Sq * ld;
    const bf16* vs = ks + Ss * ld;
    const bf16* pks =
        prefix0 + (prefix_of(u) - prefix_first) % kStages * prefix_elems;
    const bf16* pvs = pks + P * ld;
    const int len = lens ? lens[n] : Sk;
    for (int it = warp; it < items; it += warps) {
      const int hl = it % hg;
      const int r0 = it / hg * 16;
      bf16* tile = st + r0 * ld + hl * D;
      const int h_at = hl * D;
      tc::attend_tile_rows<kKeyTiles>(
          tile, ld, min(16, Sq - r0),
          [&](int j) {
            return (j < P ? pks + j * ld : ks + (j - P) * ld) + h_at;
          },
          [&](int j) {
            return (j < P ? pvs + j * ld : vs + (j - P) * ld) + h_at;
          },
          Sk, D, len, causal != 0, r0 + Sk - Sq, scale, zero, lane,
          [&](int r, int d, float v0, float v1) {
            tc::store_bf16x2(tile + r * ld + d, v0, v1);
          });
    }
    __syncthreads();  // the unit's context lies where its q was

    bf16* o = out + n * Sq * HD + static_cast<size_t>(grp) * W;
    for (int r = r_first, c = c_first; r < Sq;) {
      *reinterpret_cast<uint4*>(o + r * HD + c * 8) =
          *reinterpret_cast<const uint4*>(st + r * ld + c * 8);
      c += dc;
      r += dr;
      if (c >= cpr) {
        c -= cpr;
        ++r;
      }
    }
  }
  tc::cp_async_wait<0>();
}

size_t mma_shared_bytes(int Sq, int Ss, int P, int hg, int D) {
  return sizeof(bf16) *
         (tc::kZeroElems + static_cast<size_t>(kStages) *
                               (Sq + 2 * Ss + 2 * P) * (hg * D + tc::kPad));
}

// How the tensor-core kernel lays a shape out; hg == 0 where it cannot.
struct MmaPlan {
  int hg;  // heads a unit
  int warps;
  size_t smem;
};

MmaPlan mma_plan(int N, int Sq, int Ss, int P, int H, int D, int sms) {
  MmaPlan plan = {0, 0, 0};
  if (D % 16) return plan;
  // the largest head group that gives every SM kUnitsPerSm units, else the
  // smallest that fits
  for (int hg = H; hg >= 1; --hg) {
    if (H % hg || mma_shared_bytes(Sq, Ss, P, hg, D) > tc::kMaxShared)
      continue;
    plan.hg = hg;
    if (static_cast<long>(N) * (H / hg) >= static_cast<long>(sms) * kUnitsPerSm)
      break;
  }
  if (plan.hg == 0) return plan;
  plan.warps = std::min(kMmaWarps, plan.hg * ((Sq + 15) / 16));
  plan.smem = mma_shared_bytes(Sq, Ss, P, plan.hg, D);
  return plan;
}

template <int kKeyTiles>
int launch_mma(const void* q, const void* k, const void* v, const void* pk,
               const void* pv, const int* lens, void* out, int N, int Sq,
               int Ss, int P, int G, int H, int D, const MmaPlan& plan,
               int sms, int causal, float scale, cudaStream_t stream) {
  auto* kernel = masked_attention_mma_kernel<kKeyTiles>;
  cudaError_t e = tc::allow_shared(kernel, plan.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int resident = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, kernel, plan.warps * 32, plan.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // one wave: as many blocks as the card holds at once, each a contiguous
  // range of units, their lengths within one of each other
  const long units = static_cast<long>(N) * (H / plan.hg);
  const int blocks = static_cast<int>(
      std::min(units, static_cast<long>(sms) * std::max(resident, 1)));
  kernel<<<blocks, plan.warps * 32, plan.smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(pk),
      static_cast<const bf16*>(pv), lens, static_cast<bf16*>(out), N, Sq, Ss,
      P, G, H, D, plan.hg, causal, scale);
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

// Largest key count (P + Ss) and head width the kernels take.
CONZIC_EXPORT int conzic_masked_attention_max_keys() { return kMaxKeys; }
CONZIC_EXPORT int conzic_masked_attention_max_head_dim() { return 128; }

// q, out: (N, Sq, H, D); k, v: (N, Ss, H, D); pk, pv: (N / G, P, H, D), or
// null with P = 0; all contiguous, one type (fp32, or bf16 when bf16 != 0).
// The keys of row n are concat(pk[n / G], k[n]). lens: (N,) int32 or null
// (= P + Ss). Returns the cudaError_t of the launch. bf16 takes the
// tensor-core kernel where D is a multiple of 16 and every tensor is 16-byte
// aligned, else the scalar kernel; fp32 always the scalar.
CONZIC_EXPORT int conzic_masked_attention(
    const void* q, const void* k, const void* v, const void* pk,
    const void* pv, const int* lens, void* out, int N, int Sq, int Ss, int P,
    int G, int H, int D, int causal, float scale, int bf16, void* stream) {
  if (N <= 0 || Sq <= 0) return 0;
  if (P == 0) G = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16)
    return launch<float>(q, k, v, pk, pv, lens, out, N, Sq, Ss, P, G, H, D,
                         causal, scale, s);
  const bool aligned = aligned16(q) && aligned16(k) && aligned16(v) &&
                       aligned16(out) && (P == 0 || (aligned16(pk) &&
                                                     aligned16(pv)));
  if (aligned) {
    cudaError_t e;
    const int sms = sm_count(&e);
    if (e != cudaSuccess) return static_cast<int>(e);
    const MmaPlan plan = mma_plan(N, Sq, Ss, P, H, D, sms);
    if (plan.hg > 0) {
      auto* launch_tiles = launch_mma<8>;
      switch (tc::key_tiles_for(P + Ss)) {
        case 1: launch_tiles = launch_mma<1>; break;
        case 2: launch_tiles = launch_mma<2>; break;
        case 4: launch_tiles = launch_mma<4>; break;
      }
      return launch_tiles(q, k, v, pk, pv, lens, out, N, Sq, Ss, P, G, H, D,
                          plan, sms, causal, scale, s);
    }
  }
  return launch<__nv_bfloat16>(q, k, v, pk, pv, lens, out, N, Sq, Ss, P, G,
                               H, D, causal, scale, s);
}
