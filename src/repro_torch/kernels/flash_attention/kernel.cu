// Online-softmax causal attention over absolute positions, hand-written
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::_flash_kernel /
//   flash_attention_pallas (wrapper ops.py::flash_attention_tpu).
//
//   q (B, Sq, H, Dh), k / v (B, C, Hkv, Dh), all f32 or all bf16; out
//   (B, Sq, H, Dh) in their type.  Arithmetic is f32 throughout, as the
//   reference's: bf16 values are read as they are (half the bytes of a
//   KV cache), every product of two of them is exact in f32, and the
//   output is rounded to bf16 once, at the store.
//   A key is valid for a query when kpos <= qpos and, with window > 0,
//   qpos - kpos < window.  Positions are (b, Sq) and (b, C) with b in
//   {1, B}: a stride of 0 shares one row over the batch (the same
//   normalisation as repro/models/attention.py), so per-lane positions
//   need no other kernel.  Empty cache slots carry EMPTY_POS = 2^30 and
//   mask themselves out.  GQA maps query head h to KV head h / (H/Hkv)
//   without copying K or V.  Dh is any value in 1..128, zero-padded to
//   DP = 32 * ceil(Dh / 32) in registers and shared memory.
//
// Guards kept from the reference: the running max is clamped at
// NEG_INF/2 before exponentiation and the denominator is floored at
// 1e-30, so a fully masked query row returns 0, not NaN.
//
// The wrapper (ops.py::flash_geometry) picks one of four forms by Sq
// and dtype, and sizes each launch.
//
// f32 prefill form (Sq > 16).  Bound by the products.  A block takes 64
// queries of one (b, h), four warps of 16 rows; K/V tiles of 32 keys
// arrive by cp.async into the second of two shared-memory buffers while
// the first is in use, so each (b, h) streams its K/V into shared memory
// once per 64 queries.  S = Q.K^T and O += P.V run on tensor cores in
// 3xTF32 (../tf32_mma.cuh), mma.sync m16n8k8: S stays in the mma's
// accumulator registers, where the online softmax runs (row max and sum
// over the 4 lanes of a quad), and P feeds the P.V product from the same
// registers without a shuffle, by pairing the accumulator's columns
// (2t, 2t+1) with the A operand's k indices (t, t+4) and reading V's
// rows in the same order.  wgmma would need P in shared memory or in its
// own register layout and 64-row tiles per warpgroup; at the slice's
// Sq = 128 that is two tiles per head.  A tile is skipped, from the
// positions and not the indices, when its smallest key position is above
// every query position of the block or, with window > 0, every key lies
// outside the window of every query: EMPTY_POS slots and the causal
// upper half cost nothing.
//
// f32 decode form (Sq <= 16).  Bound by reading the cache.  A block
// serves one query of one (b, h); its 8 warps x 4 lane groups of 8 lanes
// split the keys (key c goes to warp (c / 4) mod 8, lane group c mod 4),
// a group reads a key with 16-byte loads (4 floats a lane, DP / 32
// loads) and skips the loads of masked keys.  The 32 partial (m, l, acc)
// meet in shared memory and merge in a fixed order.
//
// bf16 prefill form (flash_prefill_bf16_kernel).  At phi3's prefill
// (B = 4, Sq = 128, C = 160, H = 32, Dh = 96) the card's bound is the
// bytes (0.0038 ms at 3.35 TB/s) against 0.0006 ms of bf16 tensor work,
// so what sets the pace is how operands reach the tensor cores, not the
// products.  The design:
//   * bf16 tensor cores: mma.sync m16n8k16 bf16 with f32 accumulation.
//     S = Q.K^T is one product (a product of two bf16 values is exact in
//     f32: the same sum as the reference's, in another order).  O += P.V
//     splits the f32 P into three bf16 pieces, hi = rn(P), mid = rn(P -
//     hi), lo = P - hi - mid (exact: 3 x 8 significant bits cover f32's
//     24), and runs three products, the small ones first.  Two pieces
//     keep 16 bits of P and miss the 2e-5 (1 + |y|) bound at phi3's
//     prefill with V x 16 (tests/test_torch_kernels.py).  Two adjacent
//     n8 key tiles of S's accumulator are exactly one k16 A fragment, so
//     P never leaves the registers.  mma.sync and not wgmma: a block's
//     64 rows are one warpgroup's m64, but P would have to be rebuilt in
//     wgmma's register layout and V read through descriptors, for
//     products that are not the bound here.
//   * Operands by ldmatrix: K and V tiles of 32 keys arrive by 16-byte
//     cp.async in a 3-stage ring (two tiles in flight while one is in
//     use), bf16 rows at a pitch of DP + 8 values (an odd number of 16
//     bytes, so ldmatrix's eight row reads hit eight distinct bank
//     groups).  K's B fragments come from ldmatrix.x4, V's from
//     ldmatrix.x4.trans; Q is staged once with 16-byte copies and kept
//     as k16 A fragments; O is staged through the same shared memory and
//     written with 16-byte stores.  Rows not on 16 bytes (Dh % 8 != 0)
//     take per-value loads and stores.
//   * Geometry: a warp owns 16 query rows, a block 4 warps (64 queries).
//     At Dh = 96 that is 168 registers a thread and, by CUDA's occupancy
//     calculator, 3 blocks a SM, so phi3's 256-block grid is one wave; 2
//     warps a block measured slower at B = 4 and at the per-lane B = 1
//     prefill.  Tile skipping as in the f32 form, from a mask of 32 tiles
//     built by one position load a lane and tile.
//
// bf16 decode form (flash_decode_bf16_kernel).  Bound by reading the
// cache (0.0023 ms at phi3's decode, B = 4, C = 160, H = 32, Dh = 96), and
// at 128 blocks on 132 SMs by its latency: the f32 form makes ~3
// dependent trips to memory a block.  The design:
//   * A block serves one query of one KV head and up to 8 of its G query
//     heads, so K and V are read once for all of them: its 32 lane groups
//     of 8 lanes split into G' = min(G, 8) sets, one a head.
//   * The whole slab in flight: group u of a head takes keys u + gph t;
//     each lane copies its own 4 values of each K and V row by 8-byte
//     cp.async into shared memory (and later reads only those, so no
//     barrier stands between copies and math), 3 rounds of 2 keys a group
//     issued before the first wait: at G' = 1 up to 192 keys, phi3's whole
//     slab (C = 160); a round's dots run together, then one online-softmax
//     update.  Keys no query of the block can see (EMPTY_POS, or
//     past its position) are not read.  A cache of more than 192 keys is
//     split over a cluster of up to 8 blocks along C (the budget: 192
//     keys a block, 72 KB of K/V at Dh = 96; a 2-way split of phi3's
//     decode measured slower); a block with more keys than
//     its rounds refills each round as it is used.  The cluster's partial
//     (m, l, acc) merge through distributed shared memory in rank order.
//   * Arithmetic: f32 FMAs on bf16 values unpacked by shift and mask,
//     the row dot over a group's 8 lanes by shuffles.  The partials
//     merge in a fixed order: a warp's 4 groups (one head: a head gets a
//     multiple of 4 groups) by shuffles, then the head's warps, each
//     partial's factor exp(m_i - m) computed once.
//   * What bounds it here (flash_stages.py): an empty launch of this
//     geometry is ~2.6 us of phi3's ~7 us, the position loads and the
//     copies (two dependent trips) ~2.5 us, the math and the merge ~2 us.
//
// No atomics and fixed reduction orders: two calls give bit-identical
// results.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

#include "../tf32_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int EMPTY_POS = 1 << 30;
constexpr int PF_QB = 64;       // prefill: queries a block (4 warps x 16)
constexpr int PF_KT = 32;       // prefill: keys a tile
constexpr int DEC_WARPS = 8;    // decode: warps a block
constexpr int DEC_PARTS = DEC_WARPS * 4;
constexpr int FORM_DECODE = 0, FORM_PREFILL = 1, FORM_PREFILL_BF16 = 2,
              FORM_DECODE_BF16 = 3;
constexpr int BP_WARPS = 4;        // bf16 prefill: warps a block
constexpr int BP_KT = 32;          // bf16 prefill: keys a tile
constexpr int BP_STAGES = 3;       // bf16 prefill: tiles in the K/V ring
constexpr int BD_WARPS = 8;        // bf16 decode: warps a block
constexpr int BD_GROUPS = BD_WARPS * 4;  // its lane groups of 8 lanes
constexpr int BD_HEADS = 8;        // bf16 decode: query heads a block
constexpr int BD_MAX_SPLIT = 8;    // bf16 decode: blocks a cluster
constexpr int BD_ROUND = 2;        // bf16 decode: keys a group a round
constexpr int BD_ROUNDS = 3;       // bf16 decode: rounds in flight

__device__ __forceinline__ bool key_valid(int kpos, int qpos, int window) {
  return kpos <= qpos && (window <= 0 || qpos - kpos < window);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }

// ---------------------------------------------------------------- prefill

template <int DC, typename T>
__global__ void __launch_bounds__(128)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const int32_t* __restrict__ q_pos,
                     const int32_t* __restrict__ k_pos,
                     T* __restrict__ out, int Sq, int C, int H, int Hkv,
                     int Dh, int q_pos_stride, int k_pos_stride, int window,
                     float scale) {
  constexpr int VW = 16 / sizeof(T);  // elements a 16-byte copy
  constexpr int DP = 32 * DC, LD = DP + 4, KT = PF_KT;
  constexpr int K8 = DP / 8;          // k steps of Q.K^T, n tiles of P.V
  constexpr int TS = KT * LD;         // one K or V tile
  extern __shared__ float4 smem4[];
  T* ks = reinterpret_cast<T*>(smem4);           // [2][KT][LD]
  T* vs = ks + 2 * TS;                           // [2][KT][LD]
  int* kp = reinterpret_cast<int*>(vs + 2 * TS); // [2][KT]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * PF_QB;
  const int ra = q0 + warp * 16 + gq, rb = ra + 8;
  const int32_t* qp_row = q_pos + (size_t)b * q_pos_stride;
  const int32_t* kp_row = k_pos + (size_t)b * k_pos_stride;
  // A row past Sq gets a position no key is valid for.
  const int qpa = ra < Sq ? qp_row[ra] : INT32_MIN;
  const int qpb = rb < Sq ? qp_row[rb] : INT32_MIN;

  // The block's smallest and largest query position (rows < Sq).
  int qmin = INT32_MAX, qmax = INT32_MIN;
  for (int r = lane; r < PF_QB; r += 32) {
    if (q0 + r < Sq) {
      int p = qp_row[q0 + r];
      qmin = min(qmin, p);
      qmax = max(qmax, p);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, o));
    qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, o));
  }
  const int n_tiles = (C + KT - 1) / KT;
  // First tile >= t that some key of some query of the block needs;
  // every warp finds the same answer.
  auto next_tile = [&](int t) {
    for (; t < n_tiles; ++t) {
      int c = t * KT + lane;
      int p = c < C ? kp_row[c] : EMPTY_POS;
      bool need = p <= qmax && (window <= 0 || qmin - p < window);
      if (__any_sync(0xffffffffu, need)) break;
    }
    return t;
  };

  // Q fragments (raw f32, split per use): rows ra / rb, dims k8*8 + tq
  // and + 4, zero past Sq and Dh.
  float qa[K8][4];
  {
    const T* qra = q + (((size_t)b * Sq + ra) * H + h) * Dh;
    const T* qrb = q + (((size_t)b * Sq + rb) * H + h) * Dh;
#pragma unroll
    for (int k8 = 0; k8 < K8; ++k8) {
      int d0 = k8 * 8 + tq, d1 = d0 + 4;
      qa[k8][0] = ra < Sq && d0 < Dh ? to_f(qra[d0]) : 0.0f;
      qa[k8][1] = rb < Sq && d0 < Dh ? to_f(qrb[d0]) : 0.0f;
      qa[k8][2] = ra < Sq && d1 < Dh ? to_f(qra[d1]) : 0.0f;
      qa[k8][3] = rb < Sq && d1 < Dh ? to_f(qrb[d1]) : 0.0f;
    }
  }

  const bool vec = Dh % VW == 0 && aligned16(k) && aligned16(v);
  auto load_tile = [&](int t, int buf) {
    T* kd = ks + buf * TS;
    T* vd = vs + buf * TS;
    if (vec) {
#pragma unroll
      for (int it = 0; it < KT * DP / VW / 128; ++it) {
        int e = tid + it * 128;
        int r = e / (DP / VW), d = VW * (e % (DP / VW));
        int c = t * KT + r;
        bool ok = c < C && d < Dh;
        size_t off = (((size_t)b * C + c) * Hkv + hk) * Dh + d;
        tf32::cp_async16(kd + r * LD + d, ok ? k + off : k, ok ? 16 : 0);
        tf32::cp_async16(vd + r * LD + d, ok ? v + off : v, ok ? 16 : 0);
      }
    } else {
#pragma unroll 4
      for (int it = 0; it < KT * DP / 128; ++it) {
        int e = tid + it * 128;
        int r = e / DP, d = e % DP;
        int c = t * KT + r;
        bool ok = c < C && d < Dh;
        size_t off = (((size_t)b * C + c) * Hkv + hk) * Dh + d;
        tf32::cp_async4(kd + r * LD + d, ok ? k + off : k, ok ? 4 : 0);
        tf32::cp_async4(vd + r * LD + d, ok ? v + off : v, ok ? 4 : 0);
      }
    }
    if (tid < KT) {
      int c = t * KT + tid;
      kp[buf * KT + tid] = c < C ? kp_row[c] : EMPTY_POS;
    }
  };

  float oacc[K8][4];
#pragma unroll
  for (int n = 0; n < K8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.0f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.0f, l_b = 0.0f;

  int cur = next_tile(0), buf = 0;
  if (cur < n_tiles) load_tile(cur, 0);
  tf32::cp_async_commit();
  while (cur < n_tiles) {
    const int nxt = next_tile(cur + 1);
    if (nxt < n_tiles) load_tile(nxt, buf ^ 1);
    tf32::cp_async_commit();
    tf32::cp_async_wait<1>();
    __syncthreads();

    const T* kb = ks + buf * TS;
    const T* vb = vs + buf * TS;
    const int* kpb = kp + buf * KT;
    // S = Q K^T for 16 rows x 32 keys a warp.
    float s[4][4];
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nj][e] = 0.0f;
#pragma unroll
    for (int k8 = 0; k8 < K8; ++k8) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) tf32::split(qa[k8][e], ah[e], al[e]);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const T* kr = kb + (nj * 8 + gq) * LD + k8 * 8 + tq;
        uint32_t bh[2], bl[2];
        tf32::split(to_f(kr[0]), bh[0], bl[0]);
        tf32::split(to_f(kr[4]), bh[1], bl[1]);
        tf32::mma3(s[nj], ah, al, bh, bl);
      }
    }
    // Mask, scale and the online softmax of rows ra (e = 0, 1) and rb.
    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int kpos = kpb[nj * 8 + 2 * tq + (e & 1)];
        bool ok = key_valid(kpos, e < 2 ? qpa : qpb, window);
        s[nj][e] = ok ? s[nj][e] * scale : NEG_INF;
        if (e < 2) mx_a = fmaxf(mx_a, s[nj][e]);
        else mx_b = fmaxf(mx_b, s[nj][e]);
      }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float ms_a = fmaxf(mn_a, NEG_INF / 2), ms_b = fmaxf(mn_b, NEG_INF / 2);
    const float corr_a = expf(fminf(m_a - ms_a, 0.0f));
    const float corr_b = expf(fminf(m_b - ms_b, 0.0f));
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = expf(s[nj][e] - (e < 2 ? ms_a : ms_b));
        s[nj][e] = p;
        if (e < 2) sum_a += p;
        else sum_b += p;
      }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, o);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, o);
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int n = 0; n < K8; ++n) {
      oacc[n][0] *= corr_a;
      oacc[n][1] *= corr_a;
      oacc[n][2] *= corr_b;
      oacc[n][3] *= corr_b;
    }
    // O += P V: keys 8kk + 2t and 8kk + 2t + 1 are the A operand's k
    // indices t and t + 4, and V's rows are read in that order.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ah[4], al[4];
      tf32::split(s[kk][0], ah[0], al[0]);
      tf32::split(s[kk][2], ah[1], al[1]);
      tf32::split(s[kk][1], ah[2], al[2]);
      tf32::split(s[kk][3], ah[3], al[3]);
      const T* vr = vb + (kk * 8 + 2 * tq) * LD + gq;
#pragma unroll
      for (int n = 0; n < K8; ++n) {
        uint32_t bh[2], bl[2];
        tf32::split(to_f(vr[n * 8]), bh[0], bl[0]);
        tf32::split(to_f(vr[LD + n * 8]), bh[1], bl[1]);
        tf32::mma3(oacc[n], ah, al, bh, bl);
      }
    }
    __syncthreads();
    cur = nxt;
    buf ^= 1;
  }

  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int n = 0; n < K8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int r = e < 2 ? ra : rb;
      int d = n * 8 + 2 * tq + (e & 1);
      if (r < Sq && d < Dh)
        out[(((size_t)b * Sq + r) * H + h) * Dh + d] =
            from_f<T>(oacc[n][e] / (e < 2 ? den_a : den_b));
    }
}

// ----------------------------------------------------------------- decode

// Four values of a row as floats: one 16-byte (f32) or 8-byte (bf16)
// load where ``vec``, else one load a value.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(raw.x << 16),
                     __uint_as_float(raw.x & 0xFFFF0000u),
                     __uint_as_float(raw.y << 16),
                     __uint_as_float(raw.y & 0xFFFF0000u));
}

template <int DC, typename T>
__device__ __forceinline__ void load_row(float (&dst)[DC][4],
                                         const T* row, int j, int Dh,
                                         bool vec, bool ok) {
#pragma unroll
  for (int i = 0; i < DC; ++i) {
    int d = 4 * (j + 8 * i);
    if (vec) {
      float4 t = ok && d < Dh ? load4(row + d)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      dst[i][0] = t.x;
      dst[i][1] = t.y;
      dst[i][2] = t.z;
      dst[i][3] = t.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[i][e] = ok && d + e < Dh ? to_f(row[d + e]) : 0.0f;
    }
  }
}

template <int DC, typename T>
__global__ void __launch_bounds__(DEC_WARPS * 32)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const int32_t* __restrict__ q_pos,
                    const int32_t* __restrict__ k_pos,
                    T* __restrict__ out, int Sq, int C, int H, int Hkv,
                    int Dh, int q_pos_stride, int k_pos_stride, int window,
                    float scale) {
  constexpr int DP = 32 * DC;
  __shared__ float pacc[DEC_PARTS][DP];
  __shared__ float pm[DEC_PARTS], pl[DEC_PARTS];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = lane / 8, j = lane % 8;
  const int part = warp * 4 + grp;
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int qpos = q_pos[(size_t)b * q_pos_stride + s];
  const int32_t* kp_row = k_pos + (size_t)b * k_pos_stride;
  // 16 (f32) or 8 (bf16) bytes a load: 4 values, aligned.
  const uintptr_t am = 4 * sizeof(T) - 1;
  const bool vec = Dh % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) |
                     reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) & am) == 0;

  float qv[DC][4];
  load_row<DC, T>(qv, q + (((size_t)b * Sq + s) * H + h) * Dh, j, Dh, vec,
                  true);
  float m = NEG_INF, l = 0.0f;
  float acc[DC][4];
#pragma unroll
  for (int i = 0; i < DC; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;

  // Keys c = 4 * (warp + 8 * it) + grp, two rounds in flight; the loop
  // runs on the warp's base key, so all 32 lanes take every shuffle.
  for (int c0 = 4 * warp; c0 < C; c0 += 2 * 4 * DEC_WARPS) {
    int cs[2] = {c0 + grp, c0 + grp + 4 * DEC_WARPS};
    bool ok[2];
    float kv[2][DC][4], vv[2][DC][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      int c = cs[u];
      ok[u] = c < C && key_valid(kp_row[c], qpos, window);
      size_t off = (((size_t)b * C + c) * Hkv + hk) * Dh;
      load_row<DC, T>(kv[u], k + off, j, Dh, vec, ok[u]);
      load_row<DC, T>(vv[u], v + off, j, Dh, vec, ok[u]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float dot = 0.0f;
#pragma unroll
      for (int i = 0; i < DC; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) dot = fmaf(qv[i][e], kv[u][i][e], dot);
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (!ok[u]) continue;      // a masked key changes nothing
      float sc = dot * scale;
      float m_new = fmaxf(m, sc);
      float m_safe = fmaxf(m_new, NEG_INF / 2);
      float p = expf(sc - m_safe);
      float corr = expf(fminf(m - m_safe, 0.0f));
      l = l * corr + p;
      m = m_new;
#pragma unroll
      for (int i = 0; i < DC; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][e] = fmaf(p, vv[u][i][e], acc[i][e] * corr);
    }
  }

#pragma unroll
  for (int i = 0; i < DC; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) pacc[part][4 * (j + 8 * i) + e] = acc[i][e];
  if (j == 0) {
    pm[part] = fmaxf(m, NEG_INF / 2);
    pl[part] = l;
  }
  __syncthreads();
  // Merge the partials in order 0 .. DEC_PARTS - 1.
  float ms = NEG_INF / 2;
  for (int i = 0; i < DEC_PARTS; ++i) ms = fmaxf(ms, pm[i]);
  for (int d = tid; d < Dh; d += DEC_WARPS * 32) {
    float L = 0.0f, o = 0.0f;
    for (int i = 0; i < DEC_PARTS; ++i) {
      float f = expf(pm[i] - ms);
      L += pl[i] * f;
      o += pacc[i][d] * f;
    }
    out[(((size_t)b * Sq + s) * H + h) * Dh + d] =
        from_f<T>(o / fmaxf(L, 1e-30f));
  }
}

// ----------------------------------------------------------- bf16 forms

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give matrix i's row addresses,
// register i holds matrix i (row lane / 4, columns 2 (lane % 4), +1), or
// with .trans the transposed element pair.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a * b for one m16n8k16 tile: bf16 operands, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) rounded to a bf16 pair, x in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 p = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&p);
}

// x = hi + mid + lo and y likewise, each piece a bf16 (the pairs packed):
// each step keeps the rounding's remainder, which f32 holds exactly, and
// the last remainder has at most 8 significant bits, so lo rounds nothing.
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  hi = pack_bf16(x, y);
  x -= __uint_as_float(hi << 16);
  y -= __uint_as_float(hi & 0xFFFF0000u);
  mid = pack_bf16(x, y);
  x -= __uint_as_float(mid << 16);
  y -= __uint_as_float(mid & 0xFFFF0000u);
  lo = pack_bf16(x, y);
}

// One block: 16 * BP_WARPS queries of one (b, h), warps of 16 rows.
template <int DC>
__global__ void __launch_bounds__(BP_WARPS * 32)
flash_prefill_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const int32_t* __restrict__ q_pos,
                          const int32_t* __restrict__ k_pos,
                          bf16* __restrict__ out, int Sq, int C, int H,
                          int Hkv, int Dh, int q_pos_stride,
                          int k_pos_stride, int window, float scale) {
  constexpr int QB = 16 * BP_WARPS, NT = 32 * BP_WARPS, KT = BP_KT;
  constexpr int NS = BP_STAGES;
  constexpr int DP = 32 * DC, LD = DP + 8;
  constexpr int CH = DP / 8;           // 16-byte pieces a padded row
  constexpr int K16 = DP / 16;         // k steps of Q.K^T
  constexpr int N8 = DP / 8;           // n tiles of P.V
  constexpr int TS = KT * LD;          // one K or V tile
  static_assert((KT * CH) % NT == 0, "a tile is whole 16-byte rounds");
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);      // [QB][LD]: Q, then O
  bf16* ks = qs + QB * LD;                        // [NS][KT][LD]
  bf16* vs = ks + NS * TS;                        // [NS][KT][LD]
  int* kp = reinterpret_cast<int*>(vs + NS * TS); // [NS][KT]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * QB;
  const int ra = q0 + warp * 16 + gq, rb = ra + 8;
  const int32_t* qp_row = q_pos + (size_t)b * q_pos_stride;
  const int32_t* kp_row = k_pos + (size_t)b * k_pos_stride;
  // A row past Sq gets a position no key is valid for.
  const int qpa = ra < Sq ? qp_row[ra] : INT32_MIN;
  const int qpb = rb < Sq ? qp_row[rb] : INT32_MIN;

  // The block's smallest and largest query position (rows < Sq).
  int qmin = INT32_MAX, qmax = INT32_MIN;
  for (int r = lane; r < QB; r += 32) {
    if (q0 + r < Sq) {
      int p = qp_row[q0 + r];
      qmin = min(qmin, p);
      qmax = max(qmax, p);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, o));
    qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, o));
  }
  const int n_tiles = (C + KT - 1) / KT;
  // Bit i of ``need``: some key of tile tb + i is needed by some query of
  // the block.  A lane loads one position a tile for 32 tiles at once
  // (KT = 32 keys a tile), so a step of the loop below waits on no load.
  static_assert(KT == 32, "one key a lane a tile");
  unsigned need = 0;
  int tb = -32;
  // First tile >= t that some key of some query of the block needs;
  // every warp finds the same answer.
  auto next_tile = [&](int t) {
    while (t < n_tiles) {
      if (t >= tb + 32) {
        tb = t & ~31;
        int p[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int c = (tb + i) * KT + lane;
          p[i] = c < C ? kp_row[c] : EMPTY_POS;
        }
        need = 0;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const bool nd = p[i] <= qmax && (window <= 0 || qmin - p[i] < window);
          need |= (__any_sync(0xffffffffu, nd) ? 1u : 0u) << i;
        }
      }
      const unsigned rest = need >> (t - tb);
      if (rest) return min(t + __ffs(rest) - 1, n_tiles);
      t = tb + 32;
    }
    return n_tiles;
  };

  // 16-byte copies where every row starts on 16 bytes.
  const bool vec = Dh % 8 == 0 && aligned16(q) && aligned16(k) &&
                   aligned16(v) && aligned16(out);
  // Q rows q0.., zero past Sq and Dh.
  if (vec) {
    for (int e = tid; e < QB * CH; e += NT) {
      int r = e / CH, d = 8 * (e % CH);
      bool ok = q0 + r < Sq && d < Dh;
      size_t off = ok ? (((size_t)b * Sq + q0 + r) * H + h) * Dh + d : 0;
      tf32::cp_async16(qs + r * LD + d, q + off, ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < QB * DP; e += NT) {
      int r = e / DP, d = e % DP;
      bool ok = q0 + r < Sq && d < Dh;
      qs[r * LD + d] = ok ? q[(((size_t)b * Sq + q0 + r) * H + h) * Dh + d]
                          : __float2bfloat16_rn(0.0f);
    }
  }
  tf32::cp_async_commit();

  auto load_tile = [&](int t, int st) {
    bf16* kd = ks + st * TS;
    bf16* vd = vs + st * TS;
    if (vec) {
#pragma unroll
      for (int it = 0; it < KT * CH / NT; ++it) {
        int e = tid + it * NT;
        int r = e / CH, d = 8 * (e % CH);
        int c = t * KT + r;
        bool ok = c < C && d < Dh;
        size_t off = ok ? (((size_t)b * C + c) * Hkv + hk) * Dh + d : 0;
        tf32::cp_async16(kd + r * LD + d, k + off, ok ? 16 : 0);
        tf32::cp_async16(vd + r * LD + d, v + off, ok ? 16 : 0);
      }
    } else {
      // Plain loads, visible to the block after the __syncthreads that
      // precedes the tile's use.
      for (int e = tid; e < KT * DP; e += NT) {
        int r = e / DP, d = e % DP;
        int c = t * KT + r;
        bool ok = c < C && d < Dh;
        size_t off = ok ? (((size_t)b * C + c) * Hkv + hk) * Dh + d : 0;
        kd[r * LD + d] = ok ? k[off] : __float2bfloat16_rn(0.0f);
        vd[r * LD + d] = ok ? v[off] : __float2bfloat16_rn(0.0f);
      }
    }
    if (tid < KT) {
      int c = t * KT + tid;
      kp[st * KT + tid] = c < C ? kp_row[c] : EMPTY_POS;
    }
  };

  float oacc[N8][4];
#pragma unroll
  for (int n = 0; n < N8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.0f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.0f, l_b = 0.0f;

  // Two tiles in flight before the first use; then one more a step.
  int cur = next_tile(0);
  int nxt = cur < n_tiles ? next_tile(cur + 1) : n_tiles;
  if (cur < n_tiles) load_tile(cur, 0);
  tf32::cp_async_commit();
  if (nxt < n_tiles) load_tile(nxt, 1);
  tf32::cp_async_commit();
  tf32::cp_async_wait<2>();           // Q has landed
  __syncthreads();
  // Q's A fragments: matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15).
  uint32_t qf[K16][4];
  {
    const bf16* a = qs + (warp * 16 + lane % 8 + 8 * (lane / 8 % 2)) * LD +
                    8 * (lane / 16);
#pragma unroll
    for (int kk = 0; kk < K16; ++kk) ldsm_x4(qf[kk], a + 16 * kk);
  }
  // Lane addresses of the K (keys x k) and V (keys x n) ldmatrix reads.
  const int k_off = (lane % 8 + 8 * (lane / 16)) * LD + 8 * (lane / 8 % 2);
  const int v_off = (lane % 8 + 8 * (lane / 8 % 2)) * LD + 8 * (lane / 16);

  int st = 0;
  while (cur < n_tiles) {
    const int nx2 = nxt < n_tiles ? next_tile(nxt + 1) : n_tiles;
    if (nx2 < n_tiles) load_tile(nx2, (st + 2) % NS);
    tf32::cp_async_commit();
    tf32::cp_async_wait<2>();
    __syncthreads();

    const bf16* kb = ks + st * TS;
    const bf16* vb = vs + st * TS;
    const int* kpb = kp + st * KT;
    // S = Q K^T for 16 rows x 32 keys a warp: x4 reads give the B
    // fragments of two n8 key tiles.
    float s[4][4];
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nj][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < K16; ++kk)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t bk[4];
        ldsm_x4(bk, kb + k_off + 16 * p * LD + 16 * kk);
        mma_bf16(s[2 * p], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * p + 1], qf[kk], bk[2], bk[3]);
      }
    // Mask, scale and the online softmax of rows ra (e = 0, 1) and rb.
    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int kpos = kpb[nj * 8 + 2 * tq + (e & 1)];
        bool ok = key_valid(kpos, e < 2 ? qpa : qpb, window);
        s[nj][e] = ok ? s[nj][e] * scale : NEG_INF;
        if (e < 2) mx_a = fmaxf(mx_a, s[nj][e]);
        else mx_b = fmaxf(mx_b, s[nj][e]);
      }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float ms_a = fmaxf(mn_a, NEG_INF / 2), ms_b = fmaxf(mn_b, NEG_INF / 2);
    const float corr_a = expf(fminf(m_a - ms_a, 0.0f));
    const float corr_b = expf(fminf(m_b - ms_b, 0.0f));
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = expf(s[nj][e] - (e < 2 ? ms_a : ms_b));
        s[nj][e] = p;
        if (e < 2) sum_a += p;
        else sum_b += p;
      }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, o);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, o);
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int n = 0; n < N8; ++n) {
      oacc[n][0] *= corr_a;
      oacc[n][1] *= corr_a;
      oacc[n][2] *= corr_b;
      oacc[n][3] *= corr_b;
    }
    // O += P V over two k16 steps: key tiles 2kk and 2kk + 1 of S are
    // the A fragment's k 0-7 and 8-15; P in three bf16 pieces, the small
    // products first.
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t ph[4], pm[4], pl[4];
      split3(s[2 * kk][0], s[2 * kk][1], ph[0], pm[0], pl[0]);
      split3(s[2 * kk][2], s[2 * kk][3], ph[1], pm[1], pl[1]);
      split3(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pm[2], pl[2]);
      split3(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pm[3], pl[3]);
#pragma unroll
      for (int j = 0; j < N8 / 2; ++j) {
        uint32_t bv[4];
        ldsm_x4_t(bv, vb + v_off + 16 * kk * LD + 16 * j);
        mma_bf16(oacc[2 * j], pl, bv[0], bv[1]);
        mma_bf16(oacc[2 * j + 1], pl, bv[2], bv[3]);
        mma_bf16(oacc[2 * j], pm, bv[0], bv[1]);
        mma_bf16(oacc[2 * j + 1], pm, bv[2], bv[3]);
        mma_bf16(oacc[2 * j], ph, bv[0], bv[1]);
        mma_bf16(oacc[2 * j + 1], ph, bv[2], bv[3]);
      }
    }
    __syncthreads();
    cur = nxt;
    nxt = nx2;
    st = (st + 1) % NS;
  }

  // O through the warp's own 16 rows of qs, rounded to bf16 once.
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  __syncwarp();
  bf16* oa = qs + (warp * 16 + gq) * LD + 2 * tq;
#pragma unroll
  for (int n = 0; n < N8; ++n) {
    *reinterpret_cast<uint32_t*>(oa + 8 * n) =
        pack_bf16(oacc[n][0] / den_a, oacc[n][1] / den_a);
    *reinterpret_cast<uint32_t*>(oa + 8 * LD + 8 * n) =
        pack_bf16(oacc[n][2] / den_b, oacc[n][3] / den_b);
  }
  __syncwarp();
  const int r0 = q0 + warp * 16;
  if (vec) {
    for (int e = lane; e < 16 * CH; e += 32) {
      int r = e / CH, d = 8 * (e % CH);
      if (r0 + r < Sq && d < Dh)
        *reinterpret_cast<uint4*>(out + (((size_t)b * Sq + r0 + r) * H + h) *
                                            Dh + d) =
            *reinterpret_cast<const uint4*>(qs + (warp * 16 + r) * LD + d);
    }
  } else {
    for (int e = lane; e < 16 * DP; e += 32) {
      int r = e / DP, d = e % DP;
      if (r0 + r < Sq && d < Dh)
        out[(((size_t)b * Sq + r0 + r) * H + h) * Dh + d] =
            qs[(warp * 16 + r) * LD + d];
    }
  }
}

// Row pitch of the bf16 decode form's staging rows, in bf16 values: DP,
// or DP + 32 where DP * 2 bytes is a multiple of 128 (so that the two
// groups of a half-warp read 64-byte pieces 64 bytes apart in the banks).
__host__ __device__ constexpr int decode_bf16_pitch(int dc) {
  return 32 * dc + (dc % 2 ? 0 : 32);
}

// Shared memory of the bf16 decode form, in bytes (ops.py mirrors it):
// the warps' partials [BD_WARPS][DP] and their m and l; the block's
// merged (m, l) and acc [BD_HEADS][DP]; the cluster merge's factors and
// maxima; then the staging: BD_ROUNDS rounds of BD_ROUND keys a group, K
// and V.
__host__ __device__ constexpr int decode_bf16_smem(int dc) {
  return 4 * (BD_WARPS * 32 * dc + 2 * BD_WARPS + 2 * BD_HEADS +
              BD_HEADS * 32 * dc + BD_MAX_SPLIT * BD_HEADS + BD_HEADS) +
         BD_ROUNDS * BD_ROUND * BD_GROUPS * decode_bf16_pitch(dc) * 2 * 2;
}

// cp.async of 8 bytes (zero-filled past src_bytes).
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

// One block (a cluster rank along x): one query s of one KV head, up to
// BD_HEADS of its query heads (head chunk hc), keys [rank * kpr,
// (rank + 1) * kpr).  Group u of a head takes keys k0 + u + gph t, in
// rounds of BD_ROUND; a lane copies, and later reads, only its own 4
// values of each row, so no barrier stands between the copies and the
// math.
template <int DC>
__global__ void __launch_bounds__(BD_WARPS * 32)
flash_decode_bf16_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const int32_t* __restrict__ q_pos,
                         const int32_t* __restrict__ k_pos,
                         bf16* __restrict__ out, int Sq, int C, int H,
                         int Hkv, int Dh, int q_pos_stride,
                         int k_pos_stride, int window, float scale, int kpr,
                         int gb) {
  constexpr int DP = 32 * DC, NT = BD_WARPS * 32, R = BD_ROUND;
  constexpr int RP = decode_bf16_pitch(DC);
  constexpr int RS = R * BD_GROUPS * RP;           // one round, K or V
  extern __shared__ float4 smem4[];
  float* pacc = reinterpret_cast<float*>(smem4);  // [BD_WARPS][DP]
  float* pm = pacc + BD_WARPS * DP;                // [BD_WARPS]
  float* pl = pm + BD_WARPS;
  float* bm = pl + BD_WARPS;                       // [BD_HEADS]
  float* bl = bm + BD_HEADS;
  float* bacc = bl + BD_HEADS;                     // [BD_HEADS][DP]
  float* rf = bacc + BD_HEADS * DP;                // [BD_MAX_SPLIT][BD_HEADS]
  float* rM = rf + BD_MAX_SPLIT * BD_HEADS;        // [BD_HEADS]
  // [BD_ROUNDS][R][BD_GROUPS][RP] each
  bf16* kst = reinterpret_cast<bf16*>(rM + BD_HEADS);
  bf16* vst = kst + BD_ROUNDS * RS;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = warp * 4 + lane / 8, j8 = lane % 8;
  const int rank = blockIdx.x, split = gridDim.x;
  const int G = H / Hkv, n_hc = (G + gb - 1) / gb;
  const int hc = blockIdx.y % n_hc, sk = blockIdx.y / n_hc;
  const int hk = sk % Hkv, s = sk / Hkv, b = blockIdx.z;
  const int h0 = hk * G + hc * gb, nh = min(gb, G - hc * gb);
  // Lane groups a head, a multiple of 4: a warp's groups share a head.
  const int gph = 4 * (BD_GROUPS / (4 * gb));
  const int head = grp / gph, u = grp % gph;
  const bool active = head < nh;
  const int qpos = q_pos[(size_t)b * q_pos_stride + s];
  const int32_t* kp_row = k_pos + (size_t)b * k_pos_stride;
  const int k0 = min(rank * kpr, C), k1 = min(k0 + kpr, C);
  // This group's keys: k0 + u + gph t for t < nk.
  const int nk = active && k0 + u < k1 ? (k1 - k0 - u + gph - 1) / gph : 0;
  // The block's rounds (the most any group has), warp-uniform.
  const int n_rounds = ((k1 - k0 + gph - 1) / gph + R - 1) / R;
  // 8-byte copies where every row's 4-value pieces sit on 8 bytes.
  const bool vec = Dh % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) & 7) == 0;

  // This group's query head, its 4 dims j8 + 8i a lane (loaded first:
  // nothing it waits on stands before it).
  const bool vq = Dh % 4 == 0 && (reinterpret_cast<uintptr_t>(q) & 7) == 0;
  float qv[DC][4];
  load_row<DC, bf16>(qv, q + (((size_t)b * Sq + s) * H + h0 +
                              (active ? head : 0)) * Dh,
                     j8, Dh, vq, active);

  // Round r's rows of this lane's pieces into buffer r % BD_ROUNDS: no
  // copy for a key the query cannot see, zeros past Dh; one group.  Bit
  // sb R + t of ``okm`` says whether key t of the round in buffer sb is
  // seen.
  unsigned okm = 0;
  auto issue = [&](int r) {
    const int sb = r % BD_ROUNDS;
    int okr[R];
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int tt = r * R + t;
      okr[t] = tt < nk && key_valid(kp_row[k0 + u + gph * tt], qpos, window);
    }
    okm &= ~(((1u << R) - 1) << (sb * R));
#pragma unroll
    for (int t = 0; t < R; ++t) okm |= (unsigned)okr[t] << (sb * R + t);
#pragma unroll
    for (int t = 0; t < R; ++t) {
      if (!okr[t]) continue;
      const size_t row =
          (((size_t)b * C + k0 + u + gph * (r * R + t)) * Hkv + hk) * Dh;
      bf16* kd = kst + sb * RS + (t * BD_GROUPS + grp) * RP;
      bf16* vd = vst + sb * RS + (t * BD_GROUPS + grp) * RP;
#pragma unroll
      for (int i = 0; i < DC; ++i) {
        const int d = 4 * (j8 + 8 * i);
        if (vec) {
          const bool in = d < Dh;
          cp_async8(kd + d, in ? k + row + d : k, in ? 8 : 0);
          cp_async8(vd + d, in ? v + row + d : v, in ? 8 : 0);
        } else {
#pragma unroll 1
          for (int e = d; e < d + 4; ++e) {
            kd[e] = e < Dh ? k[row + e] : __float2bfloat16_rn(0.0f);
            vd[e] = e < Dh ? v[row + e] : __float2bfloat16_rn(0.0f);
          }
        }
      }
    }
    tf32::cp_async_commit();
  };
  // BD_ROUNDS rounds (a group's keys up to BD_ROUNDS x BD_ROUND: phi3's
  // whole slab) in flight before the first wait.
#pragma unroll
  for (int r = 0; r < BD_ROUNDS; ++r) issue(r);

  float m = NEG_INF, l = 0.0f;
  float acc[DC][4];
#pragma unroll
  for (int i = 0; i < DC; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;

  // Round r as it lands, the next in flight: the round's R dots (their
  // shuffles interleaved), then one online-softmax update.
#pragma unroll 1
  for (int r = 0; r < n_rounds; ++r) {
    tf32::cp_async_wait<BD_ROUNDS - 1>();  // round r has landed
    __syncwarp();
    const int sb = r % BD_ROUNDS;
    float sc[R], vv[R][DC][4];
#pragma unroll
    for (int x = 0; x < R; ++x) {
      const bool ok = (okm >> (sb * R + x)) & 1;
      const bf16* kd = kst + sb * RS + (x * BD_GROUPS + grp) * RP;
      const bf16* vd = vst + sb * RS + (x * BD_GROUPS + grp) * RP;
      float d0 = 0.0f, d1 = 0.0f;      // two chains of FMAs
#pragma unroll
      for (int i = 0; i < DC; ++i) {
        const int d = 4 * (j8 + 8 * i);
        float4 kt = ok ? load4(kd + d) : make_float4(0.f, 0.f, 0.f, 0.f);
        float4 vt = ok ? load4(vd + d) : make_float4(0.f, 0.f, 0.f, 0.f);
        d0 = fmaf(qv[i][0], kt.x, d0);
        d1 = fmaf(qv[i][1], kt.y, d1);
        d0 = fmaf(qv[i][2], kt.z, d0);
        d1 = fmaf(qv[i][3], kt.w, d1);
        vv[x][i][0] = vt.x; vv[x][i][1] = vt.y;
        vv[x][i][2] = vt.z; vv[x][i][3] = vt.w;
      }
      sc[x] = d0 + d1;
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
#pragma unroll
      for (int x = 0; x < R; ++x)
        sc[x] += __shfl_xor_sync(0xffffffffu, sc[x], o);
    // A masked key scores NEG_INF: p = 0, so it changes nothing.
    float m_new = m;
#pragma unroll
    for (int x = 0; x < R; ++x) {
      sc[x] = (okm >> (sb * R + x)) & 1 ? sc[x] * scale : NEG_INF;
      m_new = fmaxf(m_new, sc[x]);
    }
    const float m_safe = fmaxf(m_new, NEG_INF / 2);
    const float corr = expf(fminf(m - m_safe, 0.0f));
    float p[R];
    l *= corr;
#pragma unroll
    for (int x = 0; x < R; ++x) {
      p[x] = expf(sc[x] - m_safe);
      l += p[x];
    }
    m = m_new;
#pragma unroll
    for (int i = 0; i < DC; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float a = acc[i][e] * corr;
#pragma unroll
        for (int x = 0; x < R; ++x) a = fmaf(p[x], vv[x][i][e], a);
        acc[i][e] = a;
      }
    __syncwarp();
    if (r + BD_ROUNDS < n_rounds) issue(r + BD_ROUNDS);
    else tf32::cp_async_commit();
  }

  // The warp's 4 groups (one head) merge by shuffles, then the warps of
  // a head in warp order: a partial's factor exp(m_i - m) once.
#pragma unroll
  for (int o = 8; o < 32; o <<= 1) {
    const float ma = fmaxf(m, NEG_INF / 2);
    const float mb = fmaxf(__shfl_xor_sync(0xffffffffu, m, o), NEG_INF / 2);
    const float lb = __shfl_xor_sync(0xffffffffu, l, o);
    const float mx = fmaxf(ma, mb);
    const float fa = expf(ma - mx), fb = expf(mb - mx);
    l = l * fa + lb * fb;
#pragma unroll
    for (int i = 0; i < DC; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[i][e] = fmaf(__shfl_xor_sync(0xffffffffu, acc[i][e], o), fb,
                         acc[i][e] * fa);
    m = mx;
  }
  if (lane < 8) {
#pragma unroll
    for (int i = 0; i < DC; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) pacc[warp * DP + 4 * (j8 + 8 * i) + e] = acc[i][e];
    if (lane == 0) {
      pm[warp] = m;
      pl[warp] = l;
    }
  }
  __syncthreads();
  const int wph = gph / 4;                 // warps a head
  for (int e = tid; e < nh * Dh; e += NT) {
    const int hh = e / Dh, d = e % Dh, w0 = hh * wph;
    float ms = NEG_INF / 2;
#pragma unroll
    for (int w = 0; w < BD_WARPS; ++w)
      if (w >= w0 && w < w0 + wph) ms = fmaxf(ms, pm[w]);
    float L = 0.0f, o = 0.0f;
#pragma unroll
    for (int w = 0; w < BD_WARPS; ++w) {
      if (w >= w0 && w < w0 + wph) {
        const float f = expf(pm[w] - ms);
        L += pl[w] * f;
        o += pacc[w * DP + d] * f;
      }
    }
    if (split == 1) {
      out[(((size_t)b * Sq + s) * H + h0 + hh) * Dh + d] =
          __float2bfloat16_rn(o / fmaxf(L, 1e-30f));
    } else {
      bacc[hh * DP + d] = o;
      if (d == 0) {
        bl[hh] = L;
        bm[hh] = ms;
      }
    }
  }
  if (split == 1) return;

  // The cluster's ranks merge in rank order, in rank 0, through DSMEM.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (rank == 0) {
    if (tid < nh) {
      float M = NEG_INF / 2;
#pragma unroll
      for (int r = 0; r < BD_MAX_SPLIT; ++r)
        if (r < split) M = fmaxf(M, *cluster.map_shared_rank(bm + tid, r));
      rM[tid] = M;
    }
    __syncthreads();
    if (tid < nh * split) {
      const int hh = tid % nh, r = tid / nh;
      rf[r * BD_HEADS + hh] = expf(*cluster.map_shared_rank(bm + hh, r) - rM[hh]);
    }
    __syncthreads();
    for (int e = tid; e < nh * Dh; e += NT) {
      const int hh = e / Dh, d = e % Dh;
      float L = 0.0f, o = 0.0f;
#pragma unroll
      for (int r = 0; r < BD_MAX_SPLIT; ++r) {
        if (r < split) {
          const float f = rf[r * BD_HEADS + hh];
          L += *cluster.map_shared_rank(bl + hh, r) * f;
          o += *cluster.map_shared_rank(bacc + hh * DP + d, r) * f;
        }
      }
      out[(((size_t)b * Sq + s) * H + h0 + hh) * Dh + d] =
          __float2bfloat16_rn(o / fmaxf(L, 1e-30f));
    }
  }
  cluster.sync();                      // no block leaves while rank 0 reads
}

template <auto Kernel>
cudaError_t set_smem_once(int bytes) {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done = true;
  return err;
}

template <int DC, typename T>
cudaError_t launch(int form, int gx, const void* q, const void* k,
                   const void* v, const int32_t* q_pos,
                   const int32_t* k_pos, void* out, int B, int Sq, int C,
                   int H, int Hkv, int Dh, int qs, int kps, int window,
                   float scale, cudaStream_t stream) {
  dim3 grid(gx, H, B);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  if (form == 0) {
    flash_decode_kernel<DC, T><<<grid, DEC_WARPS * 32, 0, stream>>>(
        qt, kt, vt, q_pos, k_pos, ot, Sq, C, H, Hkv, Dh, qs, kps, window,
        scale);
  } else {
    constexpr int LD = 32 * DC + 4;
    const int smem = 4 * PF_KT * LD * (int)sizeof(T) + 2 * PF_KT * 4;
    cudaError_t err = set_smem_once<flash_prefill_kernel<DC, T>>(smem);
    if (err != cudaSuccess) return err;
    flash_prefill_kernel<DC, T><<<grid, 128, smem, stream>>>(
        qt, kt, vt, q_pos, k_pos, ot, Sq, C, H, Hkv, Dh, qs, kps, window,
        scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dc(int form, int gx, const void* q, const void* k,
                      const void* v, const int32_t* q_pos,
                      const int32_t* k_pos, void* out, int B, int Sq, int C,
                      int H, int Hkv, int Dh, int qs, int kps, int window,
                      float scale, cudaStream_t s) {
  switch ((Dh + 31) / 32) {
    case 1: return launch<1, T>(form, gx, q, k, v, q_pos, k_pos, out, B, Sq, C, H, Hkv, Dh, qs, kps, window, scale, s);
    case 2: return launch<2, T>(form, gx, q, k, v, q_pos, k_pos, out, B, Sq, C, H, Hkv, Dh, qs, kps, window, scale, s);
    case 3: return launch<3, T>(form, gx, q, k, v, q_pos, k_pos, out, B, Sq, C, H, Hkv, Dh, qs, kps, window, scale, s);
    default: return launch<4, T>(form, gx, q, k, v, q_pos, k_pos, out, B, Sq, C, H, Hkv, Dh, qs, kps, window, scale, s);
  }
}

// One launch's geometry, field for field as ops.py::flash_geometry.
struct Geom {
  int form, gx, gy, gz, threads, smem, kpr, heads;
};

// The kernel a geometry launches at DP = 32 dc, and its bf16 index (0-7)
// for the once-only shared-memory attribute, or -1 for an f32 form.
const void* kernel_of(const Geom& g, int dc, int* slot) {
#define FL_DC(K) (dc == 1 ? (const void*)K<1> : dc == 2 ? (const void*)K<2> \
                  : dc == 3 ? (const void*)K<3> : (const void*)K<4>)
  *slot = -1;
  switch (g.form) {
    case FORM_DECODE:
      return dc == 1 ? (const void*)flash_decode_kernel<1, float>
           : dc == 2 ? (const void*)flash_decode_kernel<2, float>
           : dc == 3 ? (const void*)flash_decode_kernel<3, float>
                     : (const void*)flash_decode_kernel<4, float>;
    case FORM_PREFILL:
      return dc == 1 ? (const void*)flash_prefill_kernel<1, float>
           : dc == 2 ? (const void*)flash_prefill_kernel<2, float>
           : dc == 3 ? (const void*)flash_prefill_kernel<3, float>
                     : (const void*)flash_prefill_kernel<4, float>;
    case FORM_PREFILL_BF16:
      *slot = dc - 1;
      return FL_DC(flash_prefill_bf16_kernel);
    case FORM_DECODE_BF16:
      *slot = 4 + dc - 1;
      return FL_DC(flash_decode_bf16_kernel);
    default:
      return nullptr;
  }
#undef FL_DC
}

// Shared memory a bf16 geometry needs, or -1 where its fields do not fit
// the kernels (a wrapper bug: the launch is refused).
int bf16_smem_needed(const Geom& g, int dc) {
  const int ld = 32 * dc + 8;
  if (g.form == FORM_PREFILL_BF16) {
    if (g.threads != BP_WARPS * 32) return -1;
    return (16 * BP_WARPS * ld + 2 * BP_STAGES * BP_KT * ld) * 2 +
           BP_STAGES * BP_KT * 4;
  }
  if (g.threads != BD_WARPS * 32 || g.gx < 1 || g.gx > BD_MAX_SPLIT ||
      g.heads < 1 || g.heads > BD_HEADS || g.kpr < 0)
    return -1;
  return decode_bf16_smem(dc);
}

cudaLaunchConfig_t config_of(const Geom& g, cudaStream_t s,
                             cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.gx, g.gy, g.gz);
  cfg.blockDim = dim3(g.threads);
  cfg.dynamicSmemBytes = g.form >= FORM_PREFILL_BF16 ? g.smem : 0;
  cfg.stream = s;
  if (g.form == FORM_DECODE_BF16 && g.gx > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = g.gx;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return cfg;
}

cudaError_t allow_smem(const void* fn, int slot) {
  static bool done[8] = {};
  if (slot < 0 || done[slot]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  if (err == cudaSuccess) done[slot] = true;
  return err;
}

}  // namespace

// One launch with ``geom`` (ops.py::flash_geometry: form 0 f32 decode,
// 1 f32 prefill, 2 bf16 prefill, 3 bf16 decode); q, k, v and out are
// f32 for forms 0-1 and bf16 for 2-3.  Returns cudaErrorInvalidValue for
// Dh outside 1..128, H not a multiple of Hkv (the wrapper checks both
// first) or a geometry the kernels do not take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const int32_t* q_pos,
                                      const int32_t* k_pos, void* out,
                                      int B, int Sq, int C, int H, int Hkv,
                                      int Dh, int q_pos_stride,
                                      int k_pos_stride, int window,
                                      float scale, const int* geom,
                                      void* stream_ptr) {
  cudaStream_t s = (cudaStream_t)stream_ptr;
  Geom g;
  memcpy(&g, geom, sizeof(Geom));
  if (Dh < 1 || Dh > 128 || Hkv < 1 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (g.form == FORM_DECODE || g.form == FORM_PREFILL)
    return (int)launch_dc<float>(g.form, g.gx, q, k, v, q_pos, k_pos, out, B, Sq, C, H, Hkv, Dh, q_pos_stride, k_pos_stride, window, scale, s);
  const int dc = (Dh + 31) / 32;
  int slot;
  const void* fn = kernel_of(g, dc, &slot);
  const int need = fn ? bf16_smem_needed(g, dc) : -1;
  if (need < 0 || g.smem < need) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(fn, slot);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config_of(g, s, attr);
  void* args[] = {&q, &k, &v, &q_pos, &k_pos, &out, &Sq, &C, &H, &Hkv,
                  &Dh, &q_pos_stride, &k_pos_stride, &window, &scale,
                  &g.kpr, &g.heads};
  err = cudaLaunchKernelExC(&cfg, fn, args);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The occupancy of the kernel a launch with ``geom`` runs at head size
// ``Dh``, from the CUDA runtime's occupancy calculator: out[0] resident
// blocks a SM, out[1] for a cluster launch the clusters the card holds
// at once (else 0).
extern "C" int flash_occupancy(const int* geom, int Dh, int* out) {
  Geom g;
  memcpy(&g, geom, sizeof(Geom));
  if (Dh < 1 || Dh > 128) return (int)cudaErrorInvalidValue;
  int slot;
  const void* fn = kernel_of(g, (Dh + 31) / 32, &slot);
  if (!fn) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(fn, slot);
  const int smem = g.form == FORM_PREFILL
                       ? 4 * PF_KT * (32 * ((Dh + 31) / 32) + 4) * 4 + 2 * PF_KT * 4
                       : g.form == FORM_DECODE ? 0 : g.smem;
  if (g.form == FORM_PREFILL && err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fn, g.threads, smem);
  out[1] = 0;
  if (err == cudaSuccess && g.form == FORM_DECODE_BF16 && g.gx > 1) {
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = config_of(g, 0, attr);
    err = cudaOccupancyMaxActiveClusters(&out[1], fn, &cfg);
  }
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}
