// The sequential sLSTM scan, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/slstm_scan/kernel.py::_slstm_kernel /
//   slstm_scan_pallas.
//
// For gx (B, T, H, 4Dh), recurrent weights R (H, Dh, 4Dh) and initial
// state h0, c0 (B, H, Dh), per step t and head h, with the gate columns
// split as [i | f | z | o]:
//   pre = gx[:, t, h] + h_{t-1} @ R[h]
//   c_t = sigmoid(f) c_{t-1} + sigmoid(i) tanh(z)
//   h_t = sigmoid(o) tanh(c_t)
// writing hs[:, t, h] = h_t, and hT, cT after the last step.  Any T >= 1
// runs in one launch; the state is never padded.  gx, R and the state
// (h0, c0 and the outputs hs, hT, cT) are each f32 or bf16 (``flags``):
// bf16 operands are loaded as they are and widened exactly, all
// arithmetic and the carried state are f32, and bf16 outputs are rounded
// at the store (the reference's Pallas kernel upcasts the same way).  A
// bf16 R is staged as bf16 (half the shared memory a row, so more rows
// stay on chip) and widened when read.
//
// What bounds it.  The T steps depend on each other, so the card can
// never run faster than T times the latency of one step, and a step is
// ~B * 4 Dh^2 f32 multiply-adds a head (1M at xlstm-1.3b's Dh = 512,
// B = 4).  One head's R is 4 MB at Dh = 512: the TPU keeps it in VMEM;
// streamed from L2 every step (the previous design, 8-block clusters on
// 32 SMs) a step took ~8 us.
//
// Design: R stays on chip for all T steps.  Each (head, group of up to
// 8 batch lanes) is one cluster of CLUSTER = 16 blocks on 16 SMs, a
// non-portable cluster size (launched with cudaLaunchKernelEx and a
// cluster-dimension attribute).  Block `rank` owns the hidden dims
// [d0, d0 + per), per = 32 at Dh = 512, and their four gate columns, so
// it updates c[:, d] in place with no exchange.  Its slice of R[h] is
// Dh rows x 4 per columns (256 KB at Dh = 512), loaded once at launch
// (the shared rows as one 2-D TMA box a (slice, gate), 64 requests a
// block: per-thread loads, or one bulk copy a 128-byte row piece, load
// far slower a SM; the register rows by plain loads beside them):
// the k range is cut into KS = 16 slices, one a warp; of each slice's
// rows the first reg_rows (<= RR = 10) sit in registers (a thread holds
// 4 adjacent columns of its rows as float4s, 40 registers), the next
// sm_rows in shared memory (22 at Dh = 512, B <= 4: 176 KB), and any
// rest is read from L2 each step (only where the lanes' h buffers leave
// too little shared memory: B > 4 at Dh = 512).  ops.py's
// slstm_geometry computes the split.  A step is then paced by the
// products and the shared loads that feed them: a thread does 4 lanes
// x 4 columns per row of its slice from registers or one conflict-free
// 16-byte shared load, against a broadcast 16-byte load of the 4 lanes'
// h (each shared byte of R feeds one FMA, the two pipes' balance).  The 16 slices' partial sums meet in shared
// memory in a fixed order (deterministic results), gx is added, and
// 4 * per threads apply the gates.  A dim's 4 lanes of new h go out as
// one 16-byte st.async into the second of two h buffers of every block
// of the cluster (distributed shared memory), each counted on that
// block's mbarrier for the buffer: a block starts step t + 1 when the
// Dh x 4 lanes of step t have arrived, with no cluster-wide barrier.
// Two buffers are enough: a block can send step t + 1's h into a
// buffer only after it has received step t's h from everyone, which
// each block sends after its last read of that buffer.  gx of the next
// pass is loaded before the wait.  The kernel takes Dh a multiple of 4
// up to 4 * 8 * CLUSTER = 512 and any B (clusters of 8 lanes).  This is
// the general form: f32 R always, and a bf16 R where the two forms
// below refuse the shape.
//
// The scan form (slstm_tc_kernel: bf16 R, Dh = 512, any T, lanes in
// clusters of 4).  With a bf16 R the general form's products run on the
// f32 FMA pipe, each weight widened at every load, and are bound by
// issue.  Here the products run on the tensor cores and R never leaves
// registers: one cluster of 16 blocks a (head, group of 4 lanes), block
// rank owning dims [32 rank, 32 rank + 32) and their 128 gate columns
// (as above), its 512 x 128 slice of R staged once through shared
// memory into mma.sync m16n8k16 A fragments (16 warps = 8 m-tiles of 16
// columns x 2 k halves, 16 fragments = 64 registers a thread), exact,
// never widened.  h is carried in f32 and sent as three bf16 pieces, hi
// = bf16(h), mid = bf16(h - hi), lo = bf16(h - hi - mid), whose sum is
// h exactly (24 significant bits = 3 x 8; for |h| >= 2^-110, below
// which the lost bits are under bf16's subnormal step 2^-133): each
// product of a weight and a piece is exact and the tensor cores sum them
// in f32.  The pieces x lanes sit on N (n = 2 lane: hi, 2 lane + 1: mid
// in n-tile 0; n = 8 + 2 lane: lo in n-tile 1, its neighbour 0), so an
// accumulator thread holds all three pieces of one lane and sums them
// itself.  A step's h buffer is Dh rows of 32 bytes (the row of dim k:
// [hi mid] x 4 lanes, then [lo 0] x 4 lanes, the two 16-byte halves
// swapped in every other group of 4 rows so that ldmatrix's 8-row reads
// hit distinct bank groups), read by one ldmatrix.x4.trans a k-tile.
// Exchange per rank: the gate thread of (dim, lane) splits its h, the
// dim's four lanes gather their two 16-byte halves by shuffles, and each
// half goes out by st.async to every block of the cluster, counted on
// that block's mbarrier for the sending rank (16 a buffer): a warp runs
// rank s's two k-tiles as soon as rank s's h has landed, so the products
// overlap the exchange (waiting for all 8 ranks of a warp at once, then
// all products, measured slower).  Sums in a fixed order (results
// bit-identical from call to call): per k half the tensor cores' sums
// over its k-tiles, even and odd k-tiles apart, then even + odd, then
// hi + (mid + lo), then half 0 + half 1, then gx.  gx is staged
// TC_RING - 2 steps ahead through a cp.async ring by warps 4-7, not the
// gate warps.  The gates use __expf and __fdividef (errors near 1e-7,
// against 1e-5).  What bounds it: the latency of a step (on the H100
// ~1.9 us: the ranks' h landing over ~1 us while the products run at
// mma.sync's rate, 128 m16n8k16 a sub-partition a step, then the gates
// and the sends; slstm_stages.py splits it), not its operations (0.10
// us of tensor work at the bf16 peak).  An alternative tried on the
// card: wgmma m64n16k16 from the same fragments (no faster), f32 h sent
// and split once a block (half the bytes, no faster), the rows sent by
// bulk copies (slower).
//
// The decode form (slstm_decode_kernel: bf16 R, T = 1, Dh a multiple of
// 16 up to 512, B <= 8).  At T = 1 there is no recurrence: pre = gx +
// h0 @ R, then the gates, and what bounds it is reading R once (8.4 MB
// at xlstm-1.3b's shape).  A cluster of `split` blocks a (head, 16
// dims) splits k (split 2 at Dh = 512: 256 blocks of 256 threads); a
// thread holds 8 columns of one gate (two threads a 32-byte sector) of
// up to 8 rows, all its 16-byte loads in flight at once, and sums 4
// lanes a pass on the FMA pipe in f32.  The k sub-slices meet in shared
// memory in order, each rank's sums go to rank 0 over distributed shared
// memory, where they meet in rank order, then gx; rank 0 applies the
// gates.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 16;            // blocks per (head, lane group)
constexpr int COLG = 32;               // 4-column groups a block
constexpr int MAX_PER = COLG;          // hidden dims a block owns
constexpr int KS = 16;                 // slices of the k range, a warp each
constexpr int THREADS = COLG * KS;     // 512
constexpr int LANES = 4;               // batch lanes a pass over R
constexpr int MAX_LANES = 8;           // batch lanes a cluster
constexpr int RR = 10;                 // rows of R a thread holds in registers
constexpr int SMEM_MAX = 232448;       // shared memory a block can use
constexpr int H0_LOADS = CLUSTER * MAX_PER * MAX_LANES / THREADS;  // h0 a thread

// The launch geometry, computed by ops.py's slstm_geometry (same order).
struct Geom {
  int per, kper, reg_rows, sm_rows, lanes, lanes_p, groups, smem;
};

// flags: which operands are bf16.
constexpr int GX_BF16 = 1, R_BF16 = 2, STATE_BF16 = 4;

__device__ __forceinline__ float ld_val(const void* p, size_t i, bool bf) {
  return bf ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
            : reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st_val(void* p, size_t i, float v, bool bf) {
  if (bf)
    reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    reinterpret_cast<float*>(p)[i] = v;
}

__device__ __forceinline__ float4 widen4(uint2 raw) {
  return make_float4(__uint_as_float(raw.x << 16),
                     __uint_as_float(raw.x & 0xFFFF0000u),
                     __uint_as_float(raw.y << 16),
                     __uint_as_float(raw.y & 0xFFFF0000u));
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Shared-memory addresses, mbarriers and st.async (PTX, sm_90).
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The same shared-memory location in block ``rank`` of the cluster.
__device__ __forceinline__ unsigned map_rank(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
}

// One arrival that also expects ``bytes`` of st.async data this phase.
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// 16 bytes into another block's shared memory, counted on its mbarrier.
__device__ __forceinline__ void st_async4(unsigned addr, float4 v,
                                          unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
      "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float4 ld_keep(const float* p) {
  float4 v;
  asm volatile("ld.global.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ float4 ld_keep(const __nv_bfloat16* p) {
  uint2 v;
  asm volatile("ld.global.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "l"(p));
  return widen4(v);
}

// Four adjacent values of R as floats: from shared memory, and from L2.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  return widen4(*reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ldg4(const __nv_bfloat16* p) {
  return widen4(__ldg(reinterpret_cast<const uint2*>(p)));
}

__device__ __forceinline__ void fma4x4(float (&acc)[LANES][4], float4 h,
                                       float4 w) {
  const float hl[LANES] = {h.x, h.y, h.z, h.w};
#pragma unroll
  for (int j = 0; j < LANES; ++j) {
    acc[j][0] = fmaf(hl[j], w.x, acc[j][0]);
    acc[j][1] = fmaf(hl[j], w.y, acc[j][1]);
    acc[j][2] = fmaf(hl[j], w.z, acc[j][2]);
    acc[j][3] = fmaf(hl[j], w.w, acc[j][3]);
  }
}

template <typename TR>
__global__ void __launch_bounds__(THREADS, 1)
slstm_kernel(const void* __restrict__ gx, const TR* __restrict__ r,
             const void* __restrict__ h0, const void* __restrict__ c0,
             void* __restrict__ hs, void* __restrict__ hT,
             void* __restrict__ cT, int B, int T, int H, int Dh, Geom g,
             int flags, const __grid_constant__ CUtensorMap rmap) {
  const bool gbf = flags & GX_BF16, sbf = flags & STATE_BF16;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / CLUSTER;
  const int head = cid % H;
  const int bbase = (cid / H) * g.lanes;     // first batch lane
  const int nb = min(g.lanes, B - bbase);    // live lanes
  const int Bp = g.lanes_p;                  // a multiple of LANES
  const int per = g.per;
  const int d0 = min(Dh, rank * per);
  const int nd = min(Dh, d0 + per) - d0;     // a multiple of 4
  const int G = 4 * Dh;
  const int ncols = 4 * per;
  const int sm_rows = g.sm_rows;

  extern __shared__ __align__(128) float smem[];
  // A TMA box's rows, padded to 128 bytes (a box lands 128-aligned).
  constexpr int BOX_ALIGN = 128 / (int)sizeof(TR);
  const int box = (sm_rows * per + BOX_ALIGN - 1) / BOX_ALIGN * BOX_ALIGN;
  TR* r_s = reinterpret_cast<TR*>(smem);      // [KS][4][box]
  float* hbuf = reinterpret_cast<float*>(r_s + KS * 4 * box);  // [2][Dh][Bp]
  float* part = hbuf + 2 * Dh * Bp;           // [KS][LANES][ncols]
  float* c_s = part + KS * LANES * ncols;     // [per][Bp]
  // mbar[j] counts the bytes of h arriving in buffer j each step.
  const unsigned mbar = smem_u32(c_s + per * Bp);   // h buffers' [2]
  const unsigned stage_bar = mbar + 16;              // R's bulk copies

  const int tid = threadIdx.x;
  const TR* rhead = r + (size_t)head * Dh * G;

  // This thread's k slice (its warp) and 4 columns of one gate.
  const int ks = tid / COLG;
  const int cgp = tid % COLG;
  const int q = (4 * cgp) / per;             // gate
  const int dl = (4 * cgp) % per;            // first of 4 local dims
  const bool live = cgp < per && dl < nd;
  const int k0 = min(Dh, ks * g.kper), k1 = min(Dh, k0 + g.kper);
  const int nreg = min(g.reg_rows, k1 - k0);
  const int nsm = min(sm_rows, k1 - k0 - nreg);
  const TR* rcol = rhead + q * Dh + d0 + dl;

  // Coherent loads: a read-only (ld.global.nc) load may be re-issued
  // by the compiler inside the step loop instead of being kept.
  float4 rreg[RR];
#pragma unroll
  for (int i = 0; i < RR; ++i)
    rreg[i] = (live && i < nreg) ? ld_keep(rcol + (size_t)(k0 + i) * G)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);

  // h0 into buffer 0 (all of a thread's loads in flight together), zeros
  // in padded lanes and buffer 1.
  {
    float hv[H0_LOADS];
#pragma unroll
    for (int u = 0; u < H0_LOADS; ++u) {
      const int i = tid + u * THREADS, b = i % Bp;
      hv[u] = (i < Dh * Bp && b < nb)
                  ? ld_val(h0, ((size_t)(bbase + b) * H + head) * Dh + i / Bp,
                           sbf)
                  : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < H0_LOADS; ++u) {
      const int i = tid + u * THREADS;
      if (i < Dh * Bp) hbuf[i] = hv[u];
    }
    for (int i = Dh * Bp + tid; i < 2 * Dh * Bp; i += THREADS) hbuf[i] = 0.0f;
  }
  for (int i = tid; i < per * Bp; i += THREADS) {
    const int b = i % Bp, e = i / Bp;
    c_s[i] = (e < nd && b < nb)
                 ? ld_val(c0, ((size_t)(bbase + b) * H + head) * Dh + d0 + e,
                          sbf)
                 : 0.0f;
  }
  // Each step's h: Dh dims x 16 bytes (4 lanes) a pass with live lanes.
  const unsigned fill_bytes = 16u * Dh * ((nb + LANES - 1) / LANES);
  if (tid == 0) {
    mbar_init(mbar);
    mbar_init(mbar + 8);
    mbar_init(stage_bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(mbar + 8, fill_bytes);         // step 0 fills buffer 1
    if (T > 1) mbar_expect(mbar, fill_bytes);  // step 1 fills buffer 0
    // Every block loads KS x 4 boxes of sm_rows x per floats (rows or
    // columns past R's edge arrive as zeros; past the block's slice they
    // are loaded and never used).
    mbar_expect(stage_bar,
                (unsigned)sizeof(TR) * 4u * KS * sm_rows * per);
  }
  __syncthreads();
  // R's shared rows: one 2-D TMA box per (slice, gate), sm_rows rows of
  // per floats from row head * Dh + k0s + (the slice's register rows),
  // column q * Dh + d0, counted on stage_bar.
  if (tid < 4 * KS && sm_rows > 0) {
    const int s = tid / 4, q = tid % 4;
    const int k0s = min(Dh, s * g.kper), k1s = min(Dh, k0s + g.kper);
    const int y = head * Dh + k0s + min(g.reg_rows, k1s - k0s);
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
            smem_u32(r_s + (size_t)tid * box)),
        "l"(reinterpret_cast<unsigned long long>(&rmap)), "r"(q * Dh + d0),
        "r"(y), "r"(stage_bar)
        : "memory");
  }
  // Every block of the cluster runs and has its buffers and barriers
  // initialised before any block stores into another's shared memory:
  // arrive here, wait just before this block's first store (the latency
  // of both waits, this and the staging's, runs under step 0's first
  // products).
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");

  // Reduction thread: lane rj of the pass, local column rc.
  const bool red = tid < LANES * ncols;
  const int rc = tid % ncols, rj = tid / ncols;
  const bool red_live = red && rc % per < nd;
  const size_t gx_col = (size_t)head * G + (rc / per) * Dh + d0 + rc % per;
  // Gate thread: local dim ge, lane gj (a warp: 8 dims x 4 lanes); the
  // dim's 4 lanes are neighbouring threads.
  const int ge = tid / LANES, gj = tid % LANES;
  const bool gate = ge < nd;

  auto gx_at = [&](int t, int b0) -> float {
    const int b = b0 + rj;
    return (red_live && b < nb)
               ? ld_val(gx, ((size_t)(bbase + b) * T + t) * H * G + gx_col,
                        gbf)
               : 0.0f;
  };
  float gxv = gx_at(0, 0);

  for (int t = 0; t < T; ++t) {
    const float* hcur = hbuf + (t & 1) * Dh * Bp;
    const int nxt = ((t + 1) & 1) * Dh * Bp;
    if (t > 0) {
      // Step t-1's h from all blocks (its fill (t-1)/2 of buffer t&1).
      // Nobody writes this buffer again before this block's own h of
      // step t has arrived everywhere, i.e. after every thread here has
      // passed this wait.
      mbar_wait(mbar + 8 * (t & 1), ((t - 1) >> 1) & 1);
      if (tid == 0 && t + 1 < T) mbar_expect(mbar + 8 * (t & 1), fill_bytes);
    }
    for (int b0 = 0; b0 < Bp; b0 += LANES) {
      if (live) {
        float acc[LANES][4] = {};
        // Register rows without branches, so their h loads issue ahead:
        // past the slice's register rows rreg is 0 and the row index is
        // kept inside hbuf.
#pragma unroll
        for (int i = 0; i < RR; ++i)
          fma4x4(acc,
                 *reinterpret_cast<const float4*>(
                     hcur + min(k0 + i, Dh - 1) * Bp + b0),
                 rreg[i]);
        if (t == 0 && b0 == 0) mbar_wait(stage_bar, 0);   // R's boxes
        // Shared rows, the next row's loads issued before this row's
        // products (the one load past the last row stays in shared
        // memory and is not used).
        const TR* rs = r_s + (size_t)(4 * ks + q) * box + dl;
        const float* hk = hcur + (k0 + nreg) * Bp + b0;
        float4 hn = *reinterpret_cast<const float4*>(hk);
        float4 wn = ld4(rs);
#pragma unroll 2
        for (int j = 0; j < nsm; ++j) {
          const float4 hv = hn, w = wn;
          hn = *reinterpret_cast<const float4*>(hk + (j + 1) * Bp);
          wn = ld4(rs + (j + 1) * per);
          fma4x4(acc, hv, w);
        }
#pragma unroll 8
        for (int k = k0 + nreg + nsm; k < k1; ++k)
          fma4x4(acc, *reinterpret_cast<const float4*>(hcur + k * Bp + b0),
                 ldg4(rcol + (size_t)k * G));
#pragma unroll
        for (int j = 0; j < LANES; ++j)
          *reinterpret_cast<float4*>(part + (ks * LANES + j) * ncols +
                                     4 * cgp) =
              make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
      }
      __syncthreads();
      if (red) {
        // Slices in order 0..KS-1; the sum lands in slice 0's slot,
        // which only this thread reads.
        float s = 0.0f;
#pragma unroll
        for (int p = 0; p < KS; ++p) s += part[(p * LANES + rj) * ncols + rc];
        part[rj * ncols + rc] = gxv + s;
      }
      __syncthreads();
      const int b = b0 + gj;
      float h = 0.0f;
      if (gate && b < nb) {
        const float* pre = part + gj * ncols + ge;
        float c = c_s[ge * Bp + b];
        c = sigmoid_f(pre[per]) * c + sigmoid_f(pre[0]) * tanhf(pre[2 * per]);
        h = sigmoid_f(pre[3 * per]) * tanhf(c);
        c_s[ge * Bp + b] = c;
        const int d = d0 + ge;
        const size_t bh = ((size_t)(bbase + b) * H + head) * Dh + d;
        st_val(hs, ((size_t)(bbase + b) * T + t) * H * Dh + (size_t)head * Dh + d,
               h, sbf);
        if (t == T - 1) {
          st_val(hT, bh, h, sbf);
          st_val(cT, bh, c, sbf);
        }
      }
      if (t == 0 && b0 == 0)
        asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
      // The dim's 4 lanes (padded lanes 0) go out as one 16-byte store
      // into each block's next h buffer, counted on its mbarrier.
      const float4 h4 = make_float4(h, __shfl_down_sync(0xffffffffu, h, 1),
                                    __shfl_down_sync(0xffffffffu, h, 2),
                                    __shfl_down_sync(0xffffffffu, h, 3));
      if (gate && gj == 0 && b0 < nb) {
        const unsigned dst = smem_u32(hbuf + nxt + (d0 + ge) * Bp + b0);
        const unsigned bar = mbar + 8 * ((t + 1) & 1);
#pragma unroll
        for (int rr = 0; rr < CLUSTER; ++rr)
          st_async4(map_rank(dst, rr), h4, map_rank(bar, rr));
      }
      if (b0 + LANES < Bp)
        gxv = gx_at(t, b0 + LANES);
      else if (t + 1 < T)
        gxv = gx_at(t + 1, 0);
      __syncthreads();                   // part is rewritten next pass
    }
  }
  // Every block's last h has arrived here before this block leaves (no
  // store may target the shared memory of a block that has exited).
  mbar_wait(mbar + 8 * (T & 1), ((T - 1) >> 1) & 1);
}

// ---- The scan form: bf16 R in registers as mma.sync fragments --------

constexpr int TC_DH = 512;                  // the head dim the form takes
constexpr int TC_PER = TC_DH / CLUSTER;     // 32 dims a block
constexpr int TC_COLS = 4 * TC_PER;         // 128 gate columns a block
constexpr int TC_MT = TC_COLS / 16;         // 8 m-tiles of 16 columns
constexpr int TC_KH = 2;                    // k halves
constexpr int TC_THREADS = 32 * TC_MT * TC_KH;  // 512: a warp a (m-tile, half)
constexpr int TC_KT = TC_DH / 16 / TC_KH;   // 16 k-tiles (fragments) a warp
constexpr int TC_LANES = 4;                 // batch lanes a cluster
constexpr int TC_PITCH = TC_COLS + 8;       // bf16 a staged row of R
constexpr int TC_RING = 8;                  // gx ring slots (steps)
constexpr int TC_ROW = 32;                  // bytes of a dim's h pieces
constexpr int TC_SRC_BYTES = TC_PER * TC_ROW;   // a rank's h a step
constexpr int TC_R_BYTES = TC_DH * TC_PITCH * 2;
constexpr int TC_H_BYTES = TC_DH * TC_ROW;      // one h buffer
constexpr int TC_PART = TC_KH * TC_COLS * TC_LANES;  // floats a step

// The scan form's launch: lane groups (clusters a head), shared memory.
struct TcGeom {
  int groups, smem;
};

// Shared memory of the scan form: R's staged rows, two h buffers, two
// steps' partial sums, the gx ring, 2 x CLUSTER mbarriers.
__host__ __device__ constexpr int tc_smem(int gx_bytes) {
  return TC_R_BYTES + 2 * TC_H_BYTES + 2 * TC_PART * 4 +
         TC_RING * TC_LANES * 4 * TC_PER * gx_bytes + 2 * CLUSTER * 8;
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices, transposed: lanes 8i..8i+7 give matrix i's row
// addresses; register i holds its elements (2 (lane % 4), lane / 4) and
// (2 (lane % 4) + 1, lane / 4), the first in the low half.
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a * b for one m16n8k16 tile: bf16 operands, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// h as three bf16 pieces hi + mid + lo (exact for |h| >= 2^-110): w0 =
// hi | mid << 16, w1 = lo (its high half 0).
__device__ __forceinline__ void split3(float h, unsigned& w0, unsigned& w1) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(h);
  const float r1 = h - __bfloat162float(hi);
  const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
  const float r2 = r1 - __bfloat162float(mid);
  const __nv_bfloat16 lo = __float2bfloat16_rn(r2);
  w0 = (unsigned)__bfloat16_as_ushort(hi) |
       ((unsigned)__bfloat16_as_ushort(mid) << 16);
  w1 = (unsigned)__bfloat16_as_ushort(lo);
}

// 16 bytes into another block's shared memory, counted on its mbarrier.
__device__ __forceinline__ void st_async16(unsigned addr, uint4 v,
                                           unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

// Fast gates: expf through ex2.approx, the divisions approximate (the
// errors stay near 1e-7, far inside the 1e-5 bound).
__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}
__device__ __forceinline__ float tanh_fast(float x) {
  return 1.0f - __fdividef(2.0f, 1.0f + __expf(2.0f * x));
}

// Byte offset of dim k's 16-byte half ``half`` in an h buffer: the halves
// swap in every other group of 4 rows (conflict-free ldmatrix reads).
__device__ __forceinline__ unsigned tc_hrow(int k, int half) {
  return (unsigned)(k * TC_ROW + ((half ^ ((k >> 2) & 1)) << 4));
}

__global__ void __launch_bounds__(TC_THREADS, 1)
slstm_tc_kernel(const void* __restrict__ gx,
                const __nv_bfloat16* __restrict__ r,
                const void* __restrict__ h0, const void* __restrict__ c0,
                void* __restrict__ hs, void* __restrict__ hT,
                void* __restrict__ cT, int B, int T, int H, int flags) {
  const bool gbf = flags & GX_BF16, sbf = flags & STATE_BF16;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / CLUSTER;
  const int head = cid % H;
  const int bbase = (cid / H) * TC_LANES;   // first batch lane
  const int nb = min(TC_LANES, B - bbase);  // live lanes
  const int d0 = rank * TC_PER;
  constexpr int G = 4 * TC_DH;
  const int gxb = gbf ? 2 : 4;

  extern __shared__ __align__(128) unsigned char tc_smem_raw[];
  unsigned char* r_s = tc_smem_raw;                   // [DH][PITCH] bf16
  unsigned char* hbuf = r_s + TC_R_BYTES;             // [2][DH][ROW]
  float* part = reinterpret_cast<float*>(hbuf + 2 * TC_H_BYTES);  // [2][PART]
  unsigned char* gxr = reinterpret_cast<unsigned char*>(part + 2 * TC_PART);
  const int gx_row = TC_PER * gxb;            // bytes of a (lane, gate) row
  const unsigned bars =                        // [2][CLUSTER] mbarriers
      smem_u32(gxr + TC_RING * TC_LANES * 4 * gx_row);
  const unsigned hb0 = smem_u32(hbuf);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int mt = warp % TC_MT, kh = warp / TC_MT;

  // Buffer j's barrier for source rank s counts that rank's h of each
  // step that fills buffer j: h_0 fills buffer 1, h_1 buffer 0, ...
  if (tid == 0) {
    for (int i = 0; i < 2 * CLUSTER; ++i) mbar_init(bars + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < CLUSTER; ++s) {
      mbar_expect(bars + 8 * (CLUSTER + s), TC_SRC_BYTES);   // h_0
      if (T > 1) mbar_expect(bars + 8 * s, TC_SRC_BYTES);   // h_1
    }
  }
  // R's slice (all Dh rows, the block's 4 x 32 columns) in 16-byte copies.
  for (int i = 0; i < TC_DH * 16 / TC_THREADS; ++i) {
    const int c = tid + i * TC_THREADS;
    const int k = c >> 4, q = (c >> 2) & 3, p = c & 3;
    cp_async16(smem_u32(r_s + 2 * (k * TC_PITCH + q * TC_PER + 8 * p)),
               r + ((size_t)head * TC_DH + k) * G + q * TC_DH + d0 + 8 * p);
  }
  cp_async_commit();
  // gx of step ts into ring slot ts % TC_RING: thread GX_T0 + i, i <
  // nchunk, copies one 16-byte piece of a (lane, gate) row of the block's
  // 32 dims (warps 4-7: not the gate warps).
  const int cpr = gx_row / 16, nchunk = TC_LANES * 4 * cpr;
  constexpr int GX_T0 = TC_PER * TC_LANES;
  auto issue_gx = [&](int ts) {
    const int i = tid - GX_T0;
    if (i >= 0 && i < nchunk && ts < T) {
      const int b = i / (4 * cpr), q = (i / cpr) & 3, p = i % cpr;
      if (b < nb)
        cp_async16(
            smem_u32(gxr + ((ts % TC_RING) * TC_LANES * 4 + b * 4 + q) * gx_row +
                     16 * p),
            static_cast<const unsigned char*>(gx) +
                ((((size_t)(bbase + b) * T + ts) * H + head) * G + q * TC_DH +
                 d0) * gxb + 16 * p);
    }
    cp_async_commit();
  };
  for (int ts = 0; ts < TC_RING - 2; ++ts) issue_gx(ts);
  // h0 as pieces into buffer 0: thread k writes dim k's row.
  {
    const int k = tid;
    unsigned w0[TC_LANES], w1[TC_LANES];
#pragma unroll
    for (int b = 0; b < TC_LANES; ++b)
      split3(b < nb ? ld_val(h0, ((size_t)(bbase + b) * H + head) * TC_DH + k,
                             sbf)
                    : 0.0f,
             w0[b], w1[b]);
    *reinterpret_cast<uint4*>(hbuf + tc_hrow(k, 0)) =
        make_uint4(w0[0], w0[1], w0[2], w0[3]);
    *reinterpret_cast<uint4*>(hbuf + tc_hrow(k, 1)) =
        make_uint4(w1[0], w1[1], w1[2], w1[3]);
  }
  // Gate thread: local dim ge, lane gj (a dim's 4 lanes are neighbouring
  // threads); its c stays in a register for all T steps.
  const bool gate = tid < TC_PER * TC_LANES;
  const int ge = tid >> 2, gj = tid & 3;
  const bool glive = gate && gj < nb;
  float c = glive ? ld_val(c0, ((size_t)(bbase + gj) * H + head) * TC_DH + d0 + ge,
                           sbf)
                  : 0.0f;
  cp_async_wait<TC_RING - 2>();          // R's rows (gx may still fly)
  __syncthreads();
  // Every block has its barriers initialised before any block stores
  // into another's shared memory: arrive here, wait before the first
  // store (after step 0's products).
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");

  // The warp's A fragments: m-tile mt, k-tiles kh * TC_KT + kt.  Matrix
  // i = lane / 8 of a k-tile: k rows 8 (i / 2) + lane % 8, columns
  // 16 mt + 8 (i % 2).
  unsigned a[TC_KT][4];
  {
    const int i = lane >> 3;
    const unsigned base = smem_u32(
        r_s + 2 * ((kh * TC_KT * 16 + (i >> 1) * 8 + (lane & 7)) * TC_PITCH +
                   mt * 16 + (i & 1) * 8));
#pragma unroll
    for (int kt = 0; kt < TC_KT; ++kt)
      ldsm_x4_t(a[kt], base + 2 * kt * 16 * TC_PITCH);
  }
  // This lane's ldmatrix row of an h buffer's k-tile: matrix i = lane / 8
  // is (k rows 8 (i % 2) + lane % 8, n half i / 2).
  const int bk = ((lane >> 3) & 1) * 8 + (lane & 7), bn = lane >> 4;

  for (int t = 0; t < T; ++t) {
    const unsigned hb = hb0 + (t & 1) * TC_H_BYTES;
    // Step t + TC_RING - 2's gx into the slot of step t - 2, read before
    // step t - 1's barrier.
    issue_gx(t + TC_RING - 2);
    float acc[2][2][4] = {};            // [k-tile parity][n-tile][4]
#pragma unroll
    for (int s8 = 0; s8 < CLUSTER / TC_KH; ++s8) {
      const int s = kh * (CLUSTER / TC_KH) + s8;   // source rank
      if (t > 0) {
        // Rank s's h_{t-1} (its fill (t-1)/2 of buffer t&1).  Nobody
        // writes this buffer again before this block's own h_t has
        // arrived everywhere, i.e. after every warp here has passed this
        // wait; then one waiter re-arms it for h_{t+1}.
        const unsigned bar = bars + 8 * ((t & 1) * CLUSTER + s);
        mbar_wait(bar, ((t - 1) >> 1) & 1);
        if (mt == 0 && lane == 0 && t + 1 < T) mbar_expect(bar, TC_SRC_BYTES);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int kt = 2 * s8 + u;
        const int k = (kh * TC_KT + kt) * 16 + bk;
        unsigned b[4];
        ldsm_x4_t(b, hb + tc_hrow(k, bn));
        mma_bf16(acc[u][0], a[kt], b[0], b[1]);
        mma_bf16(acc[u][1], a[kt], b[2], b[3]);
      }
    }
    // Accumulator rows g and g + 8 (columns 16 mt + g, + 8), lane tq:
    // n 2 tq (hi) and 2 tq + 1 (mid) of n-tile 0, 2 tq (lo) of n-tile 1.
    {
      float* pw = part + (t & 1) * TC_PART + kh * TC_COLS * TC_LANES;
      const int g = lane >> 2, tq = lane & 3;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float hi = acc[0][0][2 * e] + acc[1][0][2 * e];
        const float mid = acc[0][0][2 * e + 1] + acc[1][0][2 * e + 1];
        const float lo = acc[0][1][2 * e] + acc[1][1][2 * e];
        pw[(mt * 16 + g + 8 * e) * TC_LANES + tq] = hi + (mid + lo);
      }
    }
    cp_async_wait<TC_RING - 2>();        // this thread's gx of step t
    __syncthreads();
    float h = 0.0f;
    if (glive) {
      const float* p0 = part + (t & 1) * TC_PART + ge * TC_LANES + gj;
      const unsigned char* gr =
          gxr + ((t % TC_RING) * TC_LANES * 4 + gj * 4) * gx_row;
      float pre[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        pre[q] = (p0[q * TC_PER * TC_LANES] +
                  p0[TC_COLS * TC_LANES + q * TC_PER * TC_LANES]) +
                 ld_val(gr + q * gx_row, ge, gbf);
      c = sigmoid_fast(pre[1]) * c + sigmoid_fast(pre[0]) * tanh_fast(pre[2]);
      h = sigmoid_fast(pre[3]) * tanh_fast(c);
      const int d = d0 + ge;
      const size_t bh = ((size_t)(bbase + gj) * H + head) * TC_DH + d;
      st_val(hs, ((size_t)(bbase + gj) * T + t) * H * TC_DH +
                     (size_t)head * TC_DH + d, h, sbf);
      if (t == T - 1) {
        st_val(hT, bh, h, sbf);
        st_val(cT, bh, c, sbf);
      }
    }
    if (t == 0)
      asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    if (gate) {
      // The dim's row: [hi | mid << 16] x 4 lanes, then [lo] x 4 lanes
      // (padded lanes 0).  Lanes gj 0, 1 send the first half, 2, 3 the
      // second, each to 8 of the 16 blocks.
      unsigned w0, w1;
      split3(h, w0, w1);
      unsigned x[4], y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[j] = __shfl_sync(0xffffffffu, w0, j, 4);
        y[j] = __shfl_sync(0xffffffffu, w1, j, 4);
      }
      const int half = gj >> 1;
      const uint4 v = half ? make_uint4(y[0], y[1], y[2], y[3])
                           : make_uint4(x[0], x[1], x[2], x[3]);
      const unsigned dst =
          hb0 + ((t + 1) & 1) * TC_H_BYTES + tc_hrow(d0 + ge, half);
      const unsigned bar = bars + 8 * (((t + 1) & 1) * CLUSTER + rank);
      const int r0 = (gj & 1) * (CLUSTER / 2);
#pragma unroll
      for (int rr = r0; rr < r0 + CLUSTER / 2; ++rr)
        st_async16(map_rank(dst, rr), v, map_rank(bar, rr));
    }
  }
  // Every rank's last h has arrived here before this block leaves (no
  // store may target the shared memory of a block that has exited).
  if (tid < CLUSTER)
    mbar_wait(bars + 8 * ((T & 1) * CLUSTER + tid), ((T - 1) >> 1) & 1);
}

// ---- The decode form (T = 1): R streamed once, k split over a cluster -

constexpr int DC_DIMS = 16;            // hidden dims a cluster
constexpr int DC_COLS = 4 * DC_DIMS;   // 64 gate columns
constexpr int DC_MAX_KS = 64;          // k sub-slices a block (a power of 2)
constexpr int DC_MAX_THREADS = 4 * 2 * DC_MAX_KS;  // gate x half x sub-slice
constexpr int DC_MAX_RPT = 8;          // rows of R a thread
constexpr int DC_MAX_SPLIT = 4;        // blocks a cluster
constexpr int DC_LANES = 8;            // batch lanes (passes of 4)
constexpr int DC_RED = LANES * DC_COLS + 4;  // floats a sub-slice's sums

// The decode form's launch (ops.py's decode_geometry, same order): a
// cluster of ``split`` blocks of 8 ks threads, kr = ks rpt rows a block.
struct DcGeom {
  int split, ks, kr, rpt, passes, smem;
};

// Shared memory of the decode form: the rank's h0 rows, the sub-slices'
// sums, and in rank 0 every rank's sums (DC_MAX_SPLIT slots).
__host__ __device__ constexpr int dc_smem(int ks, int kr, int passes) {
  return 4 * (kr * LANES * passes + ks * DC_RED +
              DC_MAX_SPLIT * passes * LANES * DC_COLS);
}

__device__ __forceinline__ void widen8(uint4 raw, float (&w)[8]) {
  const unsigned v[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[2 * i] = __uint_as_float(v[i] << 16);
    w[2 * i + 1] = __uint_as_float(v[i] & 0xFFFF0000u);
  }
}

__global__ void __launch_bounds__(DC_MAX_THREADS)
slstm_decode_kernel(const void* __restrict__ gx,
                    const __nv_bfloat16* __restrict__ r,
                    const void* __restrict__ h0, const void* __restrict__ c0,
                    void* __restrict__ hs, void* __restrict__ hT,
                    void* __restrict__ cT, int B, int H, int Dh, DcGeom g,
                    int flags) {
  const bool gbf = flags & GX_BF16, sbf = flags & STATE_BF16;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / g.split;
  const int ntile = Dh / DC_DIMS;
  const int head = cid / ntile, d0 = (cid % ntile) * DC_DIMS;
  const int k0 = rank * g.kr, k1 = min(Dh, k0 + g.kr);
  const int G = 4 * Dh;
  const int LP = LANES * g.passes;
  const int n_out = g.passes * LANES * DC_COLS;    // a rank's sums

  extern __shared__ __align__(16) float dc_smem_raw[];
  float* hsl = dc_smem_raw;                  // [kr][LP] h0 rows
  float* red = hsl + g.kr * LP;              // [ks][DC_RED]
  float* recv = red + g.ks * DC_RED;         // rank 0: [split][n_out]
  const int nthreads = 8 * g.ks;

  const int tid = threadIdx.x;
  // Every block of the cluster runs before any stores into rank 0.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  // Thread (gate q, column half ch, sub-slice ks): rows k0 + ks + g.ks i
  // of 8 columns of gate q, all loads in flight.
  const int q = tid / (2 * g.ks), ch = tid & 1, ks = (tid >> 1) % g.ks;
  uint4 w[DC_MAX_RPT];
  const __nv_bfloat16* rp =
      r + (size_t)head * Dh * G + q * Dh + d0 + 8 * ch;
#pragma unroll
  for (int i = 0; i < DC_MAX_RPT; ++i) {
    const int k = k0 + ks + g.ks * i;
    w[i] = (i < g.rpt && k < k1)
               ? __ldg(reinterpret_cast<const uint4*>(rp + (size_t)k * G))
               : make_uint4(0u, 0u, 0u, 0u);
  }
  // Rank 0's gate thread (pass gp, dim ge, lane gb) loads its gx and c.
  const int gp = tid / (LANES * DC_DIMS), ge = (tid / LANES) % DC_DIMS;
  const int gb = LANES * gp + tid % LANES;
  const bool glive = rank == 0 && gp < g.passes && gb < B;
  float gxv[4] = {0.f, 0.f, 0.f, 0.f}, c = 0.0f;
  if (glive) {
#pragma unroll
    for (int qq = 0; qq < 4; ++qq)
      gxv[qq] = ld_val(gx, ((size_t)gb * H + head) * G + qq * Dh + d0 + ge, gbf);
    c = ld_val(c0, ((size_t)gb * H + head) * Dh + d0 + ge, sbf);
  }
  // h0's rows of this rank, all of a thread's loads in flight together.
  {
    constexpr int NH = DC_MAX_RPT * DC_LANES / 8;  // kr LP / (8 ks)
    float hv[NH];
#pragma unroll
    for (int u = 0; u < NH; ++u) {
      const int i = tid + u * nthreads, k = k0 + i / LP, b = i % LP;
      hv[u] = (i < g.kr * LP && k < k1 && b < B)
                  ? ld_val(h0, ((size_t)b * H + head) * Dh + k, sbf)
                  : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < NH; ++u) {
      const int i = tid + u * nthreads;
      if (i < g.kr * LP) hsl[i] = hv[u];
    }
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  const unsigned dst0 = map_rank(smem_u32(recv + rank * n_out), 0);
  for (int p = 0; p < g.passes; ++p) {
    float acc[LANES][8] = {};
#pragma unroll
    for (int i = 0; i < DC_MAX_RPT; ++i) {
      if (i < g.rpt) {
        const float4 hv = *reinterpret_cast<const float4*>(
            hsl + (ks + g.ks * i) * LP + LANES * p);
        const float hl[LANES] = {hv.x, hv.y, hv.z, hv.w};
        float wf[8];
        widen8(w[i], wf);
#pragma unroll
        for (int b = 0; b < LANES; ++b)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[b][e] = fmaf(hl[b], wf[e], acc[b][e]);
      }
    }
    // The sub-slices' sums meet in shared memory, summed in order, and
    // go to rank 0's slot for this rank.
#pragma unroll
    for (int b = 0; b < LANES; ++b) {
      float* dst = red + ks * DC_RED + b * DC_COLS + q * DC_DIMS + 8 * ch;
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(acc[b][4], acc[b][5], acc[b][6], acc[b][7]);
    }
    __syncthreads();
    for (int o = tid; o < LANES * DC_COLS; o += nthreads) {
      float s = 0.0f;
#pragma unroll 16
      for (int u = 0; u < g.ks; ++u) s += red[u * DC_RED + o];
      const unsigned a = dst0 + 4u * (p * LANES * DC_COLS + o);
      asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(a), "f"(s)
                   : "memory");
    }
    if (p + 1 < g.passes) __syncthreads();   // red is rewritten next pass
  }
  // The ranks' sums meet in rank 0, in rank order, then gx.
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  if (rank != 0) return;
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  if (glive) {
    const int o0 = (gp * LANES + gb % LANES) * DC_COLS + ge;
    float pre[4];
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      float s = 0.0f;
#pragma unroll
      for (int rr = 0; rr < DC_MAX_SPLIT; ++rr)
        if (rr < g.split) s += recv[rr * n_out + o0 + qq * DC_DIMS];
      pre[qq] = s + gxv[qq];
    }
    c = sigmoid_fast(pre[1]) * c + sigmoid_fast(pre[0]) * tanh_fast(pre[2]);
    const float h = sigmoid_fast(pre[3]) * tanh_fast(c);
    const size_t bh = ((size_t)gb * H + head) * Dh + d0 + ge;
    st_val(hs, bh, h, sbf);              // hs (B, 1, H, Dh)
    st_val(hT, bh, h, sbf);
    st_val(cT, bh, c, sbf);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found at run time (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) != cudaSuccess)
      return (EncodeTiled) nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// R (H Dh rows of 4 Dh values, f32 or bf16) as a 2-D tensor, boxes of
// sm_rows x per.
bool r_tensor_map(CUtensorMap* map, const void* r, bool bf, int H, int Dh,
                  const Geom& g) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)4 * Dh, (cuuint64_t)H * Dh};
  const cuuint64_t strides[1] = {(cuuint64_t)(bf ? 8 : 16) * Dh};
  const cuuint32_t box[2] = {(cuuint32_t)g.per,
                             (cuuint32_t)(g.sm_rows > 0 ? g.sm_rows : 1)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map,
            bf ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
               : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            2, const_cast<void*>(r), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TR>
cudaError_t set_attributes() {
  static cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        slstm_kernel<TR>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(slstm_kernel<TR>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                SMEM_MAX);
  }();
  return err;
}

cudaLaunchConfig_t config(int clusters, int smem, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * CLUSTER, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CLUSTER;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename TR>
cudaError_t launch_scan(const void* gx, const void* r, const void* h0,
                        const void* c0, void* hs, void* hT, void* cT, int B,
                        int T, int H, int Dh, const Geom& g, int flags,
                        cudaStream_t stream) {
  cudaError_t err = set_attributes<TR>();
  if (err != cudaSuccess) return err;
  CUtensorMap rmap;
  if (!r_tensor_map(&rmap, r, sizeof(TR) == 2, H, Dh, g))
    return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config(H * g.groups, g.smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, slstm_kernel<TR>, gx,
                           static_cast<const TR*>(r), h0, c0, hs, hT, cT, B,
                           T, H, Dh, g, flags, rmap);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The scan form: one cluster of CLUSTER blocks a (head, lane group).
cudaError_t launch_tc(const void* gx, const void* r, const void* h0,
                      const void* c0, void* hs, void* hT, void* cT, int B,
                      int T, int H, const TcGeom& g, int flags,
                      cudaStream_t stream) {
  static const cudaError_t attr_err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        slstm_tc_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(slstm_tc_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                SMEM_MAX);
  }();
  if (attr_err != cudaSuccess) return attr_err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config(H * g.groups, g.smem, stream, &attr);
  cfg.blockDim = dim3(TC_THREADS, 1, 1);
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, slstm_tc_kernel, gx, static_cast<const __nv_bfloat16*>(r), h0,
      c0, hs, hT, cT, B, T, H, flags);
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaLaunchConfig_t dc_config(const DcGeom& g, int clusters,
                             cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * g.split, 1, 1);
  cfg.blockDim = dim3(8 * g.ks, 1, 1);
  cfg.dynamicSmemBytes = (size_t)g.smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = g.split;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The decode form: one cluster of g.split blocks a (head, 16 dims).
cudaError_t launch_dc(const void* gx, const void* r, const void* h0,
                      const void* c0, void* hs, void* hT, void* cT, int B,
                      int H, int Dh, const DcGeom& g, int flags,
                      cudaStream_t stream) {
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      slstm_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_MAX);
  if (attr_err != cudaSuccess) return attr_err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = dc_config(g, H * (Dh / DC_DIMS), stream, &attr);
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, slstm_decode_kernel, gx, static_cast<const __nv_bfloat16*>(r),
      h0, c0, hs, hT, cT, B, H, Dh, g, flags);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// The forms (ops.py's FORMS): the general form, the scan form, the
// decode form.
constexpr int FORM_GENERAL = 0, FORM_SCAN = 1, FORM_DECODE = 2;

// ``form`` picks the kernel and the meaning of ``geom``: for the general
// form the fields of Geom, in order (ops.py's slstm_geometry); for the
// scan form those of TcGeom (scan_geometry), for the decode form those of
// DcGeom (decode_geometry).  ``flags``: GX_BF16 | R_BF16 | STATE_BF16
// for the bf16 operands (the state's type is also the outputs').
extern "C" int slstm_scan_launch(const void* gx, const void* r,
                                 const void* h0, const void* c0,
                                 void* hs, void* hT, void* cT, int B,
                                 int T, int H, int Dh, int form,
                                 const int* geom, int flags,
                                 void* stream_ptr) {
  cudaStream_t s = (cudaStream_t)stream_ptr;
  if (B < 1 || T < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (form == FORM_SCAN) {
    const TcGeom g = {geom[0], geom[1]};
    if (Dh != TC_DH || !(flags & R_BF16) || g.groups * TC_LANES < B ||
        g.smem != tc_smem(flags & GX_BF16 ? 2 : 4) || g.smem > SMEM_MAX)
      return (int)cudaErrorInvalidValue;
    return (int)launch_tc(gx, r, h0, c0, hs, hT, cT, B, T, H, g, flags, s);
  }
  if (form == FORM_DECODE) {
    const DcGeom g = {geom[0], geom[1], geom[2], geom[3], geom[4], geom[5]};
    if (T != 1 || !(flags & R_BF16) || Dh % DC_DIMS || Dh < DC_DIMS ||
        g.split < 1 || g.split > DC_MAX_SPLIT || g.ks < 16 ||
        g.ks > DC_MAX_KS || (g.ks & (g.ks - 1)) || g.rpt * g.ks != g.kr ||
        g.rpt < 1 || g.rpt > DC_MAX_RPT || g.split * g.kr < Dh ||
        B > DC_LANES || g.passes * LANES < B ||
        g.passes * LANES > DC_LANES || g.smem != dc_smem(g.ks, g.kr, g.passes) ||
        g.smem > SMEM_MAX)
      return (int)cudaErrorInvalidValue;
    return (int)launch_dc(gx, r, h0, c0, hs, hT, cT, B, H, Dh, g, flags, s);
  }
  if (form != FORM_GENERAL) return (int)cudaErrorInvalidValue;
  Geom g = {geom[0], geom[1], geom[2], geom[3],
            geom[4], geom[5], geom[6], geom[7]};
  if (Dh % 4 || Dh < 4 || Dh > CLUSTER * MAX_PER ||
      g.per > MAX_PER || g.per * CLUSTER < Dh || g.per % 4 ||
      g.kper * KS < Dh || g.reg_rows > RR || g.lanes > MAX_LANES ||
      g.lanes_p % LANES || g.lanes_p < g.lanes ||
      g.groups * g.lanes < B || g.smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  return (int)(flags & R_BF16
                   ? launch_scan<__nv_bfloat16>(gx, r, h0, c0, hs, hT, cT, B,
                                                T, H, Dh, g, flags, s)
                   : launch_scan<float>(gx, r, h0, c0, hs, hT, cT, B, T, H,
                                        Dh, g, flags, s));
}

// How many clusters of a launch of ``form`` with geometry ``geom`` and
// operand types ``flags`` the card holds at once
// (cudaOccupancyMaxActiveClusters): the kernel, block size, cluster size
// and shared memory of that form and R type.
extern "C" int slstm_scan_max_clusters(int form, const int* geom, int flags,
                                       int* out) {
  cudaLaunchAttribute attr;
  cudaError_t err;
  if (form == FORM_SCAN) {
    err = cudaFuncSetAttribute(
        slstm_tc_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(slstm_tc_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = config(1, geom[1], 0, &attr);
    cfg.blockDim = dim3(TC_THREADS, 1, 1);
    return (int)cudaOccupancyMaxActiveClusters(out, slstm_tc_kernel, &cfg);
  }
  if (form == FORM_DECODE) {
    const DcGeom g = {geom[0], geom[1], geom[2], geom[3], geom[4], geom[5]};
    err = cudaFuncSetAttribute(slstm_decode_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = dc_config(g, 1, 0, &attr);
    return (int)cudaOccupancyMaxActiveClusters(out, slstm_decode_kernel,
                                               &cfg);
  }
  if (form != FORM_GENERAL) return (int)cudaErrorInvalidValue;
  const int smem = geom[7];
  if (flags & R_BF16) {
    err = set_attributes<__nv_bfloat16>();
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = config(1, smem, 0, &attr);
    return (int)cudaOccupancyMaxActiveClusters(
        out, slstm_kernel<__nv_bfloat16>, &cfg);
  }
  err = set_attributes<float>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = config(1, smem, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(out, slstm_kernel<float>, &cfg);
}
