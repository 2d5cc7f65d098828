// Online-softmax causal attention over absolute positions, hand-written
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::_flash_kernel /
//   flash_attention_pallas (wrapper ops.py::flash_attention_tpu).
//
//   q (B, Sq, H, Dh), k / v (B, C, Hkv, Dh), all f32; out (B, Sq, H, Dh).
//   A key is valid for a query when kpos <= qpos and, with window > 0,
//   qpos - kpos < window.  Positions are (b, Sq) and (b, C) with b in
//   {1, B}: a stride of 0 shares one row over the batch (the same
//   normalisation as repro/models/attention.py), so per-lane positions
//   need no other kernel.  Empty cache slots carry EMPTY_POS = 2^30 and
//   mask themselves out.  GQA maps query head h to KV head h / (H/Hkv)
//   without copying K or V.
//
// Guards kept from the reference: the running max is clamped at
// NEG_INF/2 before exponentiation and the denominator is floored at
// 1e-30, so a fully masked query row returns 0, not NaN.
//
// Design.  One block serves QB = 8 queries of one (batch, head), one warp
// a query.  Keys stream through shared memory in tiles of 32: lane L
// computes the score of key L of the tile (a full Dh-long dot product
// against the query, read as a broadcast), the warp reduces the tile's
// max and sum with shuffles, and then every lane updates the output
// dims it owns (d = lane + 32 j) with the 32 probabilities, broadcast by
// shuffle.  The K tile rows are padded to Dh + 1 floats so that 32
// lanes reading 32 rows hit 32 banks.  Dh may be any value up to 128;
// phi3-mini's 96 is three dims a lane.
//
// What bounds it.  At decode (Sq = 1) every K/V element is used once:
// the kernel is bound by reading the cache (memory).  At the slice's
// prefill (Sq = 128 against a short cache) it is bound by its scalar f32
// FMAs and shuffles; a tensor-core version is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QB = 8;      // queries (warps) per block
constexpr int KT = 32;     // keys per shared-memory tile
constexpr float NEG_INF = -1e30f;

template <int DC>  // dims per lane: Dh <= 32 * DC
__global__ void flash_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const int32_t* __restrict__ q_pos,
                             const int32_t* __restrict__ k_pos,
                             float* __restrict__ out, int Sq, int C, int H,
                             int Hkv, int Dh, int q_pos_stride,
                             int k_pos_stride, int window, float scale) {
  constexpr int DMAX = 32 * DC;
  __shared__ float q_s[QB][DMAX];
  __shared__ float k_s[KT][DMAX + 1];
  __shared__ float v_s[KT][DMAX];
  __shared__ int kp_s[KT];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int qi = blockIdx.x * QB + warp;
  const bool active = qi < Sq;

  for (int e = threadIdx.x; e < QB * DMAX; e += blockDim.x) {
    int r = e / DMAX, d = e % DMAX;
    int s = blockIdx.x * QB + r;
    q_s[r][d] = (s < Sq && d < Dh)
                    ? q[(((size_t)b * Sq + s) * H + h) * Dh + d]
                    : 0.0f;
  }
  const int qpos = active ? q_pos[(size_t)b * q_pos_stride + qi] : 0;

  float m = NEG_INF, l = 0.0f;
  float acc[DC];
#pragma unroll
  for (int j = 0; j < DC; ++j) acc[j] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += KT) {
    __syncthreads();
    for (int e = threadIdx.x; e < KT * DMAX; e += blockDim.x) {
      int r = e / DMAX, d = e % DMAX;
      int c = c0 + r;
      bool ok = c < C && d < Dh;
      size_t off = (((size_t)b * C + c) * Hkv + hk) * Dh + d;
      k_s[r][d] = ok ? k[off] : 0.0f;
      v_s[r][d] = ok ? v[off] : 0.0f;
    }
    if (threadIdx.x < KT) {
      int c = c0 + threadIdx.x;
      kp_s[threadIdx.x] =
          c < C ? k_pos[(size_t)b * k_pos_stride + c] : (1 << 30);
    }
    __syncthreads();
    if (!active) continue;

    // Score of key `lane` of this tile.
    float dot = 0.0f;
    for (int d = 0; d < Dh; ++d) dot = fmaf(q_s[warp][d], k_s[lane][d], dot);
    int kpos = kp_s[lane];
    bool valid = (c0 + lane < C) && kpos <= qpos;
    if (window > 0) valid = valid && (qpos - kpos) < window;
    float s = valid ? dot * scale : NEG_INF;

    float m_cur = s;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, o));
    float m_new = fmaxf(m, m_cur);
    float m_safe = fmaxf(m_new, NEG_INF / 2);
    float p = expf(s - m_safe);
    float corr = expf(fminf(m - m_safe, 0.0f));
    float p_sum = p;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      p_sum += __shfl_xor_sync(0xffffffffu, p_sum, o);
    m = m_new;
    l = l * corr + p_sum;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[j] *= corr;
    for (int key = 0; key < KT; ++key) {
      float pk = __shfl_sync(0xffffffffu, p, key);
#pragma unroll
      for (int j = 0; j < DC; ++j)
        acc[j] = fmaf(pk, v_s[key][lane + 32 * j], acc[j]);
    }
  }

  if (!active) return;
  float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int j = 0; j < DC; ++j) {
    int d = lane + 32 * j;
    if (d < Dh) out[(((size_t)b * Sq + qi) * H + h) * Dh + d] = acc[j] / denom;
  }
}

template <int DC>
void launch(const float* q, const float* k, const float* v,
            const int32_t* q_pos, const int32_t* k_pos, float* out, int B,
            int Sq, int C, int H, int Hkv, int Dh, int q_pos_stride,
            int k_pos_stride, int window, float scale, cudaStream_t stream) {
  dim3 grid((Sq + QB - 1) / QB, H, B);
  flash_kernel<DC><<<grid, QB * 32, 0, stream>>>(
      q, k, v, q_pos, k_pos, out, Sq, C, H, Hkv, Dh, q_pos_stride,
      k_pos_stride, window, scale);
}

}  // namespace

// Returns cudaErrorInvalidValue for Dh outside 1..128 or H not a
// multiple of Hkv (the wrapper checks both first).
extern "C" int flash_attention_launch(const float* q, const float* k,
                                      const float* v, const int32_t* q_pos,
                                      const int32_t* k_pos, float* out,
                                      int B, int Sq, int C, int H, int Hkv,
                                      int Dh, int q_pos_stride,
                                      int k_pos_stride, int window,
                                      float scale, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (Dh < 1 || Dh > 128 || Hkv < 1 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  int dc = (Dh + 31) / 32;
  if (dc == 1)
    launch<1>(q, k, v, q_pos, k_pos, out, B, Sq, C, H, Hkv, Dh, q_pos_stride,
              k_pos_stride, window, scale, stream);
  else if (dc == 2)
    launch<2>(q, k, v, q_pos, k_pos, out, B, Sq, C, H, Hkv, Dh, q_pos_stride,
              k_pos_stride, window, scale, stream);
  else if (dc == 3)
    launch<3>(q, k, v, q_pos, k_pos, out, B, Sq, C, H, Hkv, Dh, q_pos_stride,
              k_pos_stride, window, scale, stream);
  else
    launch<4>(q, k, v, q_pos, k_pos, out, B, Sq, C, H, Hkv, Dh, q_pos_stride,
              k_pos_stride, window, scale, stream);
  return (int)cudaGetLastError();
}
