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
// up to 4 * 8 * CLUSTER = 512 and any B (clusters of 8 lanes).
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

}  // namespace

// ``geom``: the fields of Geom, in order (ops.py's slstm_geometry);
// ``flags``: GX_BF16 | R_BF16 | STATE_BF16 for the bf16 operands (the
// state's type is also the outputs').
extern "C" int slstm_scan_launch(const void* gx, const void* r,
                                 const void* h0, const void* c0,
                                 void* hs, void* hT, void* cT, int B,
                                 int T, int H, int Dh, const int* geom,
                                 int flags, void* stream_ptr) {
  Geom g = {geom[0], geom[1], geom[2], geom[3],
            geom[4], geom[5], geom[6], geom[7]};
  if (Dh % 4 || Dh < 4 || Dh > CLUSTER * MAX_PER || B < 1 || T < 1 ||
      H < 1 || g.per > MAX_PER || g.per * CLUSTER < Dh || g.per % 4 ||
      g.kper * KS < Dh || g.reg_rows > RR || g.lanes > MAX_LANES ||
      g.lanes_p % LANES || g.lanes_p < g.lanes ||
      g.groups * g.lanes < B || g.smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream_ptr;
  return (int)(flags & R_BF16
                   ? launch_scan<__nv_bfloat16>(gx, r, h0, c0, hs, hT, cT, B,
                                                T, H, Dh, g, flags, s)
                   : launch_scan<float>(gx, r, h0, c0, hs, hT, cT, B, T, H,
                                        Dh, g, flags, s));
}

// How many clusters of the scan can be resident at once with ``smem``
// bytes of shared memory a block (cudaOccupancyMaxActiveClusters).
extern "C" int slstm_scan_max_clusters(int smem, int* out) {
  cudaError_t err = set_attributes<float>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config(1, smem, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(out, slstm_kernel<float>, &cfg);
}
