// Online-softmax causal attention over absolute positions, hand-written
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::_flash_kernel /
//   flash_attention_pallas (wrapper ops.py::flash_attention_tpu).
//
//   q (B, Sq, H, Dh), k / v (B, C, Hkv, Dh), all f32 or all bf16; out
//   (B, Sq, H, Dh) in their type.  Arithmetic is f32 throughout: bf16
//   values are loaded as they are (half the bytes of a KV cache) and
//   widened exactly, the output rounded to bf16 at the store.
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
// The wrapper (ops.py::flash_geometry) picks one of two forms by Sq.
//
// Prefill form (Sq > 16).  Bound by the products.  A block takes 64
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
// Decode form (Sq <= 16).  Bound by reading the cache.  A block serves
// one query of one (b, h); its 8 warps x 4 lane groups of 8 lanes split
// the keys (key c goes to warp (c / 4) mod 8, lane group c mod 4), a group
// reads a key with 16-byte loads (4 floats a lane, DP / 32 loads) and
// skips the loads of masked keys.  The 32 partial (m, l, acc) meet in
// shared memory and merge in a fixed order.
//
// bf16 operands.  A bf16 value is exact in TF32 (8 significant bits
// against 11), so its lo part is 0: Q.K^T takes one product a tile
// instead of three, and P.V two (P is f32), each the same sum as the
// f32 path's 3xTF32 on the same values.  Tiles stay bf16 in shared
// memory and are widened when read.
//
// No atomics and fixed reduction orders: two calls give bit-identical
// results.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../tf32_mma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int EMPTY_POS = 1 << 30;
constexpr int PF_QB = 64;       // prefill: queries a block (4 warps x 16)
constexpr int PF_KT = 32;       // prefill: keys a tile
constexpr int DEC_WARPS = 8;    // decode: warps a block
constexpr int DEC_PARTS = DEC_WARPS * 4;

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
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

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
  constexpr bool BF = sizeof(T) == 2;
  constexpr int VW = 16 / sizeof(T);  // elements a 16-byte copy
  constexpr int DP = 32 * DC, LD = DP + (BF ? 8 : 4), KT = PF_KT;
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
    } else if (BF) {
      // Rows of bf16 not on 16 bytes: plain loads (visible to the
      // block after the __syncthreads that precedes the tile's use).
      for (int e = tid; e < KT * DP; e += 128) {
        int r = e / DP, d = e % DP;
        int c = t * KT + r;
        bool ok = c < C && d < Dh;
        size_t off = (((size_t)b * C + c) * Hkv + hk) * Dh + d;
        kd[r * LD + d] = ok ? k[off] : from_f<T>(0.0f);
        vd[r * LD + d] = ok ? v[off] : from_f<T>(0.0f);
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
        if (BF)
          tf32::mma(s[nj], ah, bh);      // al = bl = 0
        else
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
        if (BF) {                        // bl = 0
          tf32::mma(oacc[n], al, bh);
          tf32::mma(oacc[n], ah, bh);
        } else {
          tf32::mma3(oacc[n], ah, al, bh, bl);
        }
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
    constexpr int LD = 32 * DC + (sizeof(T) == 2 ? 8 : 4);
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

}  // namespace

// form 0 (decode, grid x = Sq) or 1 (prefill, grid x = query blocks of
// 64), as ops.py::flash_geometry picks; q, k, v and out are f32, or bf16
// with ``bf16`` set.  Returns cudaErrorInvalidValue for Dh outside
// 1..128 or H not a multiple of Hkv (the wrapper checks both first).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const int32_t* q_pos,
                                      const int32_t* k_pos, void* out,
                                      int B, int Sq, int C, int H, int Hkv,
                                      int Dh, int q_pos_stride,
                                      int k_pos_stride, int window,
                                      float scale, int form, int gx,
                                      int bf16, void* stream_ptr) {
  cudaStream_t s = (cudaStream_t)stream_ptr;
  if (Dh < 1 || Dh > 128 || Hkv < 1 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  return (int)(bf16 ? launch_dc<__nv_bfloat16>(form, gx, q, k, v, q_pos, k_pos, out, B, Sq, C, H, Hkv, Dh, q_pos_stride, k_pos_stride, window, scale, s)
                    : launch_dc<float>(form, gx, q, k, v, q_pos, k_pos, out, B, Sq, C, H, Hkv, Dh, q_pos_stride, k_pos_stride, window, scale, s));
}
