// The sequential sLSTM scan, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/slstm_scan/kernel.py::_slstm_kernel /
//   slstm_scan_pallas.
//
// For gx (B, T, H, 4Dh), recurrent weights R (H, Dh, 4Dh) and initial
// state h0, c0 (B, H, Dh), all f32, per step t and head h, with the
// gate columns split as [i | f | z | o]:
//   pre = gx[:, t, h] + h_{t-1} @ R[h]
//   c_t = sigmoid(f) c_{t-1} + sigmoid(i) tanh(z)
//   h_t = sigmoid(o) tanh(c_t)
// writing hs[:, t, h] = h_t, and hT, cT after the last step.  Any T >= 1
// runs in one launch; the state is never padded.
//
// What bounds it.  The T steps depend on each other, so the card can
// never run faster than T times the latency of one step.  At xlstm-1.3b
// widths (Dh = 512) one head's R is 4 MB: more than a block's 227 KB of
// shared memory and more than a cluster of 8 blocks holds, so R cannot
// stay on chip as it does in VMEM on the TPU.  All four heads' 16.8 MB
// do stay in the 50 MB L2, and every step streams its head's R from
// there: a step is bound by the L2 bandwidth of the SMs that read it.
//
// Design.  The recurrence is block-diagonal, so heads (and batch lanes)
// are independent.  Each head is one thread block cluster of CLUSTER
// blocks on CLUSTER SMs; block `rank` owns the hidden dims
// [d0, d0 + nd) and computes their four gate columns d, Dh+d, 2Dh+d,
// 3Dh+d for every batch lane, so it updates c[:, d] in place with no
// exchange.  It streams only its 4*nd columns of R[h] (512 KB at
// Dh = 512) each step.  The new h of its dims is stored into the
// shared memory of every block of the cluster (distributed shared
// memory), into the second of two h buffers, and one cluster barrier a
// step publishes it.  Inside a block, a thread owns 4 adjacent columns
// of one gate (one 16-byte load of R per k) and a slice of the k range;
// the k slices' partial sums meet in shared memory in a fixed order,
// so the result is deterministic.  Lanes go 4 at a time (one 16-byte
// shared load of h per k).  The kernel takes Dh a multiple of 4 up to
// 4 * 16 * CLUSTER = 512.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;             // blocks per head
constexpr int GROUPS = 16;             // 4-column groups per gate a block
constexpr int MAX_PER = 4 * GROUPS;    // hidden dims a block owns
constexpr int COLS = 4 * GROUPS;       // column groups of a block
constexpr int KP = 8;                  // slices of the k range
constexpr int THREADS = COLS * KP;     // 512
constexpr int LANES = 4;               // batch lanes per pass over R

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
slstm_kernel(const float* __restrict__ gx, const float* __restrict__ r,
             const float* __restrict__ h0, const float* __restrict__ c0,
             float* __restrict__ hs, float* __restrict__ hT,
             float* __restrict__ cT, int B, int T, int H, int Dh, int per) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int head = blockIdx.x / CLUSTER;
  const int d0 = min(Dh, rank * per);
  const int nd = min(Dh, d0 + per) - d0;   // a multiple of 4
  const int G = 4 * Dh;
  const int Bp = (B + LANES - 1) / LANES * LANES;

  extern __shared__ __align__(16) float smem[];
  float* hbuf = smem;                        // [2][Dh][Bp]
  float* part = hbuf + 2 * Dh * Bp;          // [KP][LANES][4][per]
  float* c_s = part + KP * LANES * 4 * per;  // [Bp][per]

  const int tid = threadIdx.x;
  for (int i = tid; i < 2 * Dh * Bp; i += THREADS) hbuf[i] = 0.0f;
  __syncthreads();
  for (int i = tid; i < B * Dh; i += THREADS) {
    const int b = i / Dh, d = i % Dh;
    hbuf[d * Bp + b] = h0[((size_t)b * H + head) * Dh + d];
  }
  for (int i = tid; i < B * nd; i += THREADS) {
    const int b = i / nd, e = i % nd;
    c_s[b * per + e] = c0[((size_t)b * H + head) * Dh + d0 + e];
  }
  // Every block of the cluster runs and has its buffers initialised
  // before any block stores into another's shared memory.
  cluster.sync();

  const int kp = tid / COLS;
  const int q = (tid % COLS) / GROUPS;       // gate
  const int dl = 4 * (tid % GROUPS);         // first of 4 local dims
  const bool live = dl < nd;
  const int kper = (Dh + KP - 1) / KP;
  const int k0 = min(Dh, kp * kper), k1 = min(Dh, k0 + kper);
  const float* rcol = r + (size_t)head * Dh * G + q * Dh + d0 + dl;

  for (int t = 0; t < T; ++t) {
    const float* hcur = hbuf + (t & 1) * Dh * Bp;
    const int nxt = ((t + 1) & 1) * Dh * Bp;
    for (int b0 = 0; b0 < Bp; b0 += LANES) {
      if (live) {
        float acc[LANES][4] = {};
#pragma unroll 8
        for (int k = k0; k < k1; ++k) {
          const float4 w = __ldg(reinterpret_cast<const float4*>(
              rcol + (size_t)k * G));
          const float4 hv =
              *reinterpret_cast<const float4*>(hcur + k * Bp + b0);
          const float hl[LANES] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
          for (int j = 0; j < LANES; ++j) {
            acc[j][0] = fmaf(hl[j], w.x, acc[j][0]);
            acc[j][1] = fmaf(hl[j], w.y, acc[j][1]);
            acc[j][2] = fmaf(hl[j], w.z, acc[j][2]);
            acc[j][3] = fmaf(hl[j], w.w, acc[j][3]);
          }
        }
#pragma unroll
        for (int j = 0; j < LANES; ++j)
          *reinterpret_cast<float4*>(
              part + ((kp * LANES + j) * 4 + q) * per + dl) =
              make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
      }
      __syncthreads();
      for (int i = tid; i < LANES * nd; i += THREADS) {
        const int j = i / nd, e = i % nd;
        const int b = b0 + j;
        if (b >= B) continue;
        const float* g_t = gx + (((size_t)b * T + t) * H + head) * G + d0 + e;
        float pre[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float s = 0.0f;
          for (int p = 0; p < KP; ++p)
            s += part[((p * LANES + j) * 4 + g) * per + e];
          pre[g] = g_t[g * Dh] + s;
        }
        float c = c_s[b * per + e];
        c = sigmoid_f(pre[1]) * c + sigmoid_f(pre[0]) * tanhf(pre[2]);
        const float h = sigmoid_f(pre[3]) * tanhf(c);
        c_s[b * per + e] = c;
        const int d = d0 + e;
        const size_t o = ((size_t)b * H + head) * Dh + d;
        hs[(((size_t)b * T + t) * H + head) * Dh + d] = h;
        if (t == T - 1) {
          hT[o] = h;
          cT[o] = c;
        }
        for (int rr = 0; rr < CLUSTER; ++rr)
          cluster.map_shared_rank(hbuf, rr)[nxt + d * Bp + b] = h;
      }
      __syncthreads();
    }
    // Publishes this step's h to every block; the two h buffers make one
    // barrier a step enough (a buffer is rewritten only after the step
    // that read it has passed the next barrier everywhere).
    cluster.sync();
  }
}

}  // namespace

extern "C" int slstm_scan_launch(const float* gx, const float* r,
                                 const float* h0, const float* c0,
                                 float* hs, float* hT, float* cT, int B,
                                 int T, int H, int Dh, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (Dh % 4 || Dh > CLUSTER * MAX_PER || B < 1 || T < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  const int per = ((Dh + CLUSTER - 1) / CLUSTER + 3) / 4 * 4;
  const int Bp = (B + LANES - 1) / LANES * LANES;
  const size_t smem =
      sizeof(float) * ((size_t)2 * Dh * Bp + KP * LANES * 4 * per +
                       (size_t)Bp * per);
  static size_t smem_allowed = 48 * 1024;   // raised once, not per call
  if (smem > smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        slstm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  slstm_kernel<<<H * CLUSTER, THREADS, smem, stream>>>(
      gx, r, h0, c0, hs, hT, cT, B, T, H, Dh, per);
  return (int)cudaGetLastError();
}
