// Fused bit-sliced CIM matmul under parasitic-resistance distortion
// (paper Eq 17), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/cim_mvm/kernel.py::_cim_mvm_kernel / cim_mvm_pallas.
//
//   y = x @ W'          x (M, I) f32, W' (I, N) expanded on the fly
//   W'[i,n] = sign * scale * [ (1 + eta * p) * M0 + eta * M1 ]
//   M0 = |code| * 2^-K
//   M1 = sum_k bit_k * 2^-(k+1) * col(n, k),  col = (n mod wpt) * K + k,
//        mirrored to cols-1-col under reversed dataflow
//   p  = pos[i, n / wpt]
//
// The weights travel from device memory once, as int16 codes plus the
// int32 row-position table (2 + 4/wpt bytes a weight); no W' and no bit
// plane ever exists in device memory.  The TPU kernel accumulates its
// output block across a sequential grid axis over I; Hopper runs blocks
// in parallel and in no order, so every reduction over I here is inside
// a block or a cluster, in a fixed order, with no atomics: two calls
// give bit-identical results.  The wrapper (ops.py) picks one of two
// forms by the number of rows M and computes the launch geometry.
//
// Decode form (M <= 16).  Bound by device memory in principle (each
// weight serves M rows only, 2.5 bytes for 2M flops), by the expansion's
// ALU work in practice (~2.3x the byte bound at M = 4, PERF.md).  A
// thread owns 8 consecutive columns and reads them with one 16-byte code
// load and one pos load a row of I (wpt = 8: one pos covers the 8
// columns), the next four rows' loads issued before this four's math.
// The M rows of x sit in shared memory, read as broadcasts; the M x 8
// sums stay in registers.  Each weight is expanded once, in registers:
// 1 + eta*p once a row, M0 exactly on the FP32 pipe (magic-number
// conversion), eta*M1 from a per-(slot, magnitude) table in shared
// memory built with the same rounded operations, so W' is bit-identical
// to the plain version's.  The 256 threads of a block split their I
// slice into KS interleaved slices; a cluster of 8 blocks splits I
// eight ways; the slices meet in shared memory and the 8 blocks through
// distributed shared memory, each sum in a fixed order, so no partial
// ever goes to device memory and no second kernel runs.
//
// Prefill form (M > 16).  Bound by the products and by the expansion:
// tensor cores in 3xTF32 (../tf32_mma.cuh), wgmma m64n128k8.  The
// product runs transposed, y^T = W'^T x^T, so that W'^T is wgmma's A
// operand and goes from the codes straight into registers, expanded
// exactly (the eta*M1 table again) and split into TF32 hi and lo; x is
// the B operand, split once a block into shared memory in wgmma's
// K-major core-matrix layout.  A block covers 128 columns of W' by 128
// rows of x, so a weight is expanded M / 128 times; slabs of x, codes
// and pos stream in by cp.async two slabs ahead.  wgmma runs
// asynchronously, so the expansion of a k step and the conversion of
// the next slab's x overlap the products of the step before.  Measured
// on the H100 (PERF.md): ~200 registers a thread leave one block (8
// warps) a SM, and that ALU work, not the tensor cores, sets the pace.
//
// Nonideal-device operands (the reference applies them in its fused XLA
// path only, src/repro/kernels/cim_mvm/xla.py::cim_mvm_xla; here both
// forms take them, so nothing falls back to a plain path):
//   W' = sign*scale*[(1 + eta*p)*M0 + eta*M1] * gain + nz * eps(i, n)
// * gain (I_pad, N_pad) f32 is read beside the codes (the decode form
//   loads it with the codes, the prefill form stages it in its ring when
//   shared memory allows, else reads it from L2); it multiplies W' after
//   the expansion, as the reference does.
// * col_pos (Ti, Tn, cols) int32 moves bit k of weight n to the physical
//   bitline col_pos[ti, tn, col(n, k)]: M1 * 2^K = sum_k b_k col_pos_k
//   2^(K-1-k), an exact integer below cols * 2^K, so W' stays bit-identical
//   to the plain version.  The eta*M1 table assumes the fixed layout and
//   is not used; the tiles a block touches are loaded into shared memory
//   (the decode form once, the prefill form a slab at a time, in its
//   ring) in dataflow order, so a weight's K entries are contiguous and
//   (K = 8) come in two 16-byte loads.
// * Read noise: eps(i, n) is a standard normal from a counter-based
//   Philox4x32-10 written into the kernel (key = (read_seed, noise_tag),
//   counter = (i, n >> 2, 0, 0); Box-Muller on the top 24 bits of words
//   0, 1 and of words 2, 3 gives four normals, one a column n & 3), a
//   function of (read_seed, tag, i, n) alone: every row of x sees the
//   same W' in one read, whatever M, form or block shape.
//   nz = (sigma_read * agg) * scale with agg = sqrt((1 - 4^-K) / 3).  No
//   eps tensor exists in device memory.  The plain version (ref.py)
//   computes the same Philox words in int64 arithmetic, so the uniforms
//   are bit-identical; the normal differs by the last bits of log / cos.
// x may be f32 or bf16 (read directly, exact in f32); y is f32.
//
// Rounding.  M0 and M1 are exact (integers times 2^-K); the rest of the
// expansion uses __fmul_rn / __fadd_rn so that nvcc cannot contract it
// into FMAs: W' is rounded op by op in the same order as the reference's
// XLA expression and the plain version.  No fast-math division is used.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

#include "../tf32_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int CLUSTER = 8;     // decode: blocks splitting I
constexpr int DEC_RM = 4;      // decode: output rows per reduction round
constexpr int PF_BM = 128;     // prefill: rows of x a block
constexpr int PF_BN = 128;     // prefill: columns a block
constexpr int PF_BK = 32;      // prefill: rows of I a step
constexpr int PF_STAGES = 3;   // prefill: ring of staged slabs
constexpr int PF_GLD = PF_BN + 8;  // prefill: staged gain row (floats)
// Geom.ext bits: which nonideal operands the call carries.
constexpr int EXT_GAIN = 1, EXT_COLP = 2, EXT_NOISE = 4;
constexpr int EXT_GAIN_STAGED = 8;  // prefill: gain staged in the ring

// Launch geometry, computed by ops.py::cim_geometry (same order).
struct Geom {
  int form, M, I, N, n_pad, n_tiles, wpt, n_bits, cols, reversed, fast,
      tile, rps, gx, gy, smem, off_t, off_p, mt, xbf16, ext, rows, n_ti,
      cp_ti, cp_tn;
};

// The nonideal operands: gain (strided like the codes) or null, col_pos
// (n_ti, n_tiles, cols) or null, the read noise's Philox key and its
// amplitude sigma_read * agg before the scale (0: no noise).
struct Ext {
  const float* gain;
  const int32_t* colp;
  uint32_t seed, tag;
  float nsig;
};

__device__ __forceinline__ float load_x(const void* x, size_t i, int bf) {
  return bf ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(x)[i])
            : reinterpret_cast<const float*>(x)[i];
}

// M1 * 2^K as an exact integer, without a loop over the K bit planes.
//
// M1 = sum_k b_k 2^-(k+1) col(k) with col(k) = c0 + k (forward dataflow,
// c0 = slot * K) or c0 - k (reversed, c0 = cols - 1 - slot * K), where
// b_k is bit K-1-k of mag.  In units of 2^-K:
//   M1 * 2^K = c0 * mag +- G,  G = sum_k k b_k 2^(K-1-k)
//            = (K-1) * mag - sum_j j bit_j(mag) 2^j,
// and sum_j j bit_j 2^j = sum_t 2^t (mag & MASK_t), MASK_t selecting the
// bit positions j whose bit t is set (K <= 16).  Everything is an exact
// integer below 2^24 (the wrapper checks cols * 2^K < 2^24), so M0 and
// M1 are exact floats, bit-identical to the reference's K-step sum.
// ``c0`` is (n mod wpt) * K for output column n.
__device__ __forceinline__ int m1_int(int mag, int c0, int n_bits, int cols,
                                      int reversed) {
  int wsum = (mag & 0xAAAA) + 2 * (mag & 0xCCCC) + 4 * (mag & 0xF0F0) +
             8 * (mag & 0xFF00);
  int g = (n_bits - 1) * mag - wsum;
  return reversed ? (cols - 1 - c0) * mag - g : c0 * mag + g;
}

// W'[i,n] from one code and its row factor ``row`` = 1 + eta*p;
// ``unit`` is 2^-K.
__device__ __forceinline__ float expand_row(
    int code, float row, int c0, float unit, float scale, float eta,
    int n_bits, int cols, int reversed) {
  int mag = code < 0 ? -code : code;
  float sgn_scale = code < 0 ? -scale : scale;
  float m0 = __fmul_rn((float)mag, unit);
  float m1 = __fmul_rn((float)m1_int(mag, c0, n_bits, cols, reversed), unit);
  float mag_eff = __fadd_rn(__fmul_rn(row, m0), __fmul_rn(eta, m1));
  return __fmul_rn(sgn_scale, mag_eff);
}

__device__ __forceinline__ float row_factor(int p, float eta) {
  return __fadd_rn(1.0f, __fmul_rn(eta, (float)p));
}

// A tile's row of col_pos entries in shared memory: cols rounded up to 4,
// plus 4, so rows start on 16 bytes (two 16-byte loads fetch a weight's 8
// entries) and the lanes of a warp reading neighbouring tiles spread over
// the banks.
__device__ __forceinline__ int cps_stride(const Geom& g) {
  return ((g.cols + 3) & ~3) + 4;
}

// M1 * 2^K under a column permutation: ``cp`` holds the physical bitline
// of the weight's K bit columns in dataflow order (16-byte aligned), and
// M1 * 2^K = sum_k b_k cp[k] 2^(K-1-k) = sum_k cp[k] (mag & 2^(K-1-k)),
// an exact integer below cols * 2^K.
__device__ __forceinline__ int m1_colp(int mag, const int* cp, int n_bits) {
  if (n_bits == 8) {
    const int4 a = *reinterpret_cast<const int4*>(cp);
    const int4 b = *reinterpret_cast<const int4*>(cp + 4);
    return a.x * (mag & 128) + a.y * (mag & 64) + a.z * (mag & 32) +
           a.w * (mag & 16) + b.x * (mag & 8) + b.y * (mag & 4) +
           b.z * (mag & 2) + b.w * (mag & 1);
  }
  int m1 = 0;
  for (int k = 0; k < n_bits; ++k) m1 += cp[k] * (mag & (1 << (n_bits - 1 - k)));
  return m1;
}

// W'[i,n] under a column permutation; ``row`` is 1 + eta*p.
__device__ __forceinline__ float expand_colp(int code, float row,
                                             const int* cp, float unit,
                                             float scale, float eta,
                                             int n_bits) {
  int mag = code < 0 ? -code : code;
  float sgn_scale = code < 0 ? -scale : scale;
  const int m1 = m1_colp(mag, cp, n_bits);
  float m0 = __fmul_rn((float)mag, unit);
  float mag_eff = __fadd_rn(__fmul_rn(row, m0),
                            __fmul_rn(eta, __fmul_rn((float)m1, unit)));
  return __fmul_rn(sgn_scale, mag_eff);
}

// Two standard normals from two 32-bit words: Box-Muller on their top 24
// bits (u1 in (0, 1), so the log is finite), r cos(2 pi u2) and
// r sin(2 pi u2).
__device__ __forceinline__ void box_muller(uint32_t a, uint32_t b,
                                           float& z0, float& z1) {
  const float u1 = ((float)(a >> 8) + 0.5f) * 5.9604644775390625e-08f;
  const float u2 = ((float)(b >> 8) + 0.5f) * 5.9604644775390625e-08f;
  const float r = sqrtf(-2.0f * logf(u1));
  float s, c;
  sincospif(2.0f * u2, &s, &c);
  z0 = r * c;
  z1 = r * s;
}

// Four standard normals from one Philox4x32-10 call at key (k0, k1) and
// counter (c0, c1, 0, 0): words 0, 1 give z[0], z[1] and words 2, 3 give
// z[2], z[3].  The read noise of weight (i, n) is z[n & 3] at counter
// (i, n >> 2): four neighbouring columns share a call.
__device__ __forceinline__ void philox_normal4(uint32_t k0, uint32_t k1,
                                               uint32_t c0, uint32_t c1,
                                               float (&z)[4]) {
  uint32_t c2 = 0, c3 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  box_muller(c0, c1, z[0], z[1]);
  box_muller(c2, c3, z[2], z[3]);
}

// eps(i, n) alone (a thread that needs one weight of a group of four).
__device__ __forceinline__ float read_normal(const Ext& e, int i, int n) {
  float z[4];
  philox_normal4(e.seed, e.tag, (uint32_t)i, (uint32_t)n >> 2, z);
  const int q = n & 3;
  return q == 0 ? z[0] : q == 1 ? z[1] : q == 2 ? z[2] : z[3];
}

// Gain and read noise on one expanded weight W'[i][n], in the
// reference's order: W' * gain, then + nz * eps(i, n).
__device__ __forceinline__ float apply_ext(float w, float gain, int ext,
                                           const Ext& e, float nz, int i,
                                           int n) {
  if (ext & EXT_GAIN) w = __fmul_rn(w, gain);
  if (ext & EXT_NOISE) w = __fadd_rn(w, __fmul_rn(nz, read_normal(e, i, n)));
  return w;
}

// col_pos tiles [ti0, ti0 + cp_ti) x [tn0, tn0 + cp_tn) into shared
// memory as cps[(a * cp_tn + b) * cps_stride + slot * K + k] =
// col_pos[ti0 + a][tn0 + b][col(slot, k)] (mirrored under reversed
// dataflow), zeros past the grid.  ``async`` issues cp.async copies (the
// caller commits).
__device__ __forceinline__ void load_colp(int* cps, const int32_t* colp,
                                          const Geom& g, int ti0, int tn0,
                                          bool async) {
  const int n = g.cp_ti * g.cp_tn * g.cols;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int c = e % g.cols, t = e / g.cols;
    const int ti = ti0 + t / g.cp_tn, tn = tn0 + t % g.cp_tn;
    const bool ok = ti < g.n_ti && tn < g.n_tiles;
    const int32_t* src =
        colp + ((size_t)ti * g.n_tiles + tn) * g.cols +
        (g.reversed ? g.cols - 1 - c : c);
    int* dst = cps + t * cps_stride(g) + c;
    if (async)
      tf32::cp_async4(dst, ok ? src : colp, ok ? 4 : 0);
    else
      *dst = ok ? src[0] : 0;
  }
}

// The eta*M1 table: for each slot (n mod wpt) a row of 2^K floats, entry
// mag holding eta * M1(mag), computed with the same rounded operations
// as expand_row.
__device__ void build_table(float* table, int wpt, int n_bits, int cols,
                            int reversed, float eta, float unit) {
  const int n_mag = 1 << n_bits;
  for (int e = threadIdx.x; e < wpt * n_mag; e += blockDim.x) {
    int slot = e >> n_bits, mag = e & (n_mag - 1);
    table[e] = __fmul_rn(
        eta, __fmul_rn((float)m1_int(mag, slot * n_bits, n_bits, cols,
                                     reversed), unit));
  }
}

// Slot ``slot``'s table row, indexed by the magnitude.
__device__ __forceinline__ const float* table_row(const float* table,
                                                  int slot, int n_bits) {
  return table + (slot << n_bits);
}

// The same W' from the row factor 1 + eta*p, the slot's table row and
// the code: M0 = mag * 2^-K through the bits of 2^23 + mag (exact for
// mag < 2^23, one FFMA instead of an int->float conversion), and the
// sign applied by flipping the sign bit (round-to-nearest is symmetric,
// so -scale * m == -(scale * m) bit for bit).
__device__ __forceinline__ float expand_fast(int code, float row,
                                             const float* tab_row,
                                             float unit, float scale) {
  int mag = abs(code);
  float m0 = __fmaf_rn(__int_as_float(0x4B000000 | mag), unit,
                       -8388608.0f * unit);
  float mag_eff = __fadd_rn(__fmul_rn(row, m0), tab_row[mag]);
  return __int_as_float(__float_as_int(__fmul_rn(scale, mag_eff)) ^
                        (code & 0x80000000));
}

// ---------------------------------------------------------------- decode

// Block: 8G columns (G threads of 8), KS = 256 / G slices of the
// block's I range; cluster rank r owns rows [r*rps, min((r+1)*rps, I)),
// slice s the rows k0 + s + KS*j.  MT: M rounded up to a power of two.
// EXT: the nonideal operands (gain, col_pos, read noise) as Geom.ext
// says; the ideal instantiations carry none of their code.
template <int MT, bool FAST, bool EXT>
__global__ void __cluster_dims__(1, CLUSTER, 1) __launch_bounds__(THREADS)
cim_decode_kernel(const void* __restrict__ x,
                  const int16_t* __restrict__ codes,
                  const int32_t* __restrict__ pos,
                  const float* __restrict__ scale_ptr,
                  float* __restrict__ out, Geom g, float eta, Ext e) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* xs = smem;                 // [rows][MT], later the reduction
  float* table = smem + g.off_t;    // [wpt][2^K] eta * M1   (FAST, no colp)
  int* cps = reinterpret_cast<int*>(smem + g.off_t);  // col_pos tiles
  float* part = smem + g.off_p;     // [MT][8G] the block's sums
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();

  const int G = g.tile, KS = THREADS / G, W = 8 * G;
  const int tid = threadIdx.x;
  const int gi_col = tid % G, sl = tid / G;
  const int n0 = blockIdx.x * W + 8 * gi_col;
  const int k0 = rank * g.rps;
  const int k1 = min(k0 + g.rps, g.I);
  const int rows = max(k1 - k0, 0);
  const float scale = *scale_ptr;
  const float unit = ldexpf(1.0f, -g.n_bits);
  const int ext = EXT ? g.ext : 0;
  const bool colp = ext & EXT_COLP;
  const float nz = __fmul_rn(e.nsig, scale);
  const int ti0 = k0 / max(g.rows, 1), tn0 = blockIdx.x * W / g.wpt;

  // x slab, transposed to [row][m]: coalesced reads along I.
  for (int q = tid; q < MT * rows; q += THREADS) {
    int m = q / rows, r = q % rows;
    xs[r * MT + m] =
        m < g.M ? load_x(x, (size_t)m * g.I + k0 + r, g.xbf16) : 0.0f;
  }
  if (colp)
    load_colp(cps, e.colp, g, ti0, tn0, false);
  else if (FAST)
    build_table(table, g.wpt, g.n_bits, g.cols, g.reversed, eta, unit);
  __syncthreads();

  float acc[MT][8];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = 0.0f;

  if (FAST) {
    // n_pad % 8 == 0 and wpt % 8 == 0: the 8 columns share one pos and
    // their slots are slot0 .. slot0 + 7.
    const bool col_ok = n0 < g.n_pad;
    const int slot0 = n0 % g.wpt;
    const int tile_n = n0 / g.wpt;
    // Four rows a step, the next step's loads issued before this step's
    // arithmetic, so a thread keeps 8 rows of loads in flight.
    int4 cv[4];
    int pv[4];
    float4 gv[EXT ? 4 : 1][2];
    auto load4 = [&](int i, int4 (&c)[4], int (&p)[4],
                     float4 (&gg)[EXT ? 4 : 1][2]) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        int ii = i + u * KS;
        bool ok = col_ok && ii < k1;
        c[u] = ok ? __ldg(reinterpret_cast<const int4*>(
                        codes + (size_t)ii * g.n_pad + n0))
                  : make_int4(0, 0, 0, 0);
        p[u] = ok ? __ldg(pos + (size_t)ii * g.n_tiles + tile_n) : 0;
        if constexpr (EXT) {
          const float4* gp = reinterpret_cast<const float4*>(
              e.gain + (size_t)ii * g.n_pad + n0);
          bool gok = ok && (ext & EXT_GAIN);
          gg[u][0] = gok ? __ldg(gp) : make_float4(1.f, 1.f, 1.f, 1.f);
          gg[u][1] = gok ? __ldg(gp + 1) : make_float4(1.f, 1.f, 1.f, 1.f);
        }
      }
    };
    load4(k0 + sl, cv, pv, gv);
    // A thread past n_pad has nothing to add (and no col_pos tile).
    for (int i = col_ok ? k0 + sl : k1; i < k1; i += 4 * KS) {
      int4 ncv[4];
      int npv[4];
      float4 ngv[EXT ? 4 : 1][2];
      load4(i + 4 * KS, ncv, npv, ngv);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        int ii = i + u * KS;
        if (ii >= k1) break;
        float row = row_factor(pv[u], eta);
        const int words[4] = {cv[u].x, cv[u].y, cv[u].z, cv[u].w};
        float w[8];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          int lo = (int)(int16_t)(words[q] & 0xFFFF);
          int hi = words[q] >> 16;
          if (EXT && colp) {
            const int* cp = cps + ((ii / g.rows - ti0) * g.cp_tn +
                                   (tile_n - tn0)) * cps_stride(g) +
                            (slot0 + 2 * q) * g.n_bits;
            w[2 * q] = expand_colp(lo, row, cp, unit, scale, eta, g.n_bits);
            w[2 * q + 1] = expand_colp(hi, row, cp + g.n_bits, unit, scale,
                                       eta, g.n_bits);
          } else {
            w[2 * q] = expand_fast(
                lo, row, table_row(table, slot0 + 2 * q, g.n_bits), unit,
                scale);
            w[2 * q + 1] = expand_fast(
                hi, row, table_row(table, slot0 + 2 * q + 1, g.n_bits), unit,
                scale);
          }
        }
        if constexpr (EXT) {
          const float gw[8] = {gv[u][0].x, gv[u][0].y, gv[u][0].z,
                               gv[u][0].w, gv[u][1].x, gv[u][1].y,
                               gv[u][1].z, gv[u][1].w};
          // The thread's 8 columns are two groups of four: two Philox
          // calls give their noise.
          float z[2][4];
          if (ext & EXT_NOISE) {
            philox_normal4(e.seed, e.tag, (uint32_t)ii, (uint32_t)n0 >> 2,
                           z[0]);
            philox_normal4(e.seed, e.tag, (uint32_t)ii,
                           ((uint32_t)n0 >> 2) + 1, z[1]);
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (ext & EXT_GAIN) w[j] = __fmul_rn(w[j], gw[j]);
            if (ext & EXT_NOISE)
              w[j] = __fadd_rn(w[j], __fmul_rn(nz, z[j / 4][j % 4]));
          }
        }
        const float* xr = xs + (ii - k0) * MT;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          float xv = xr[m];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(xv, w[j], acc[m][j]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        cv[u] = ncv[u];
        pv[u] = npv[u];
        if constexpr (EXT) {
          gv[u][0] = ngv[u][0];
          gv[u][1] = ngv[u][1];
        }
      }
    }
  } else {
    // Any wpt and n_pad: one code and one pos a column.
    int c0[8], tn[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c0[j] = ((n0 + j) % g.wpt) * g.n_bits;
      tn[j] = (n0 + j) / g.wpt;
    }
    for (int i = k0 + sl; i < k1; i += KS) {
      float w[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        bool ok = n0 + j < g.n_pad;
        int code = ok ? codes[(size_t)i * g.n_pad + n0 + j] : 0;
        int p = ok ? pos[(size_t)i * g.n_tiles + tn[j]] : 0;
        if (EXT && colp) {
          const int* cp = cps + ((i / g.rows - ti0) * g.cp_tn +
                                 (tn[j] - tn0)) * cps_stride(g) + c0[j];
          w[j] = ok ? expand_colp(code, row_factor(p, eta), cp, unit, scale,
                                  eta, g.n_bits)
                    : 0.0f;
        } else {
          w[j] = expand_row(code, row_factor(p, eta), c0[j], unit, scale, eta,
                            g.n_bits, g.cols, g.reversed);
        }
        if (EXT && ok) {
          float gn = (ext & EXT_GAIN)
                         ? e.gain[(size_t)i * g.n_pad + n0 + j] : 1.0f;
          w[j] = apply_ext(w[j], gn, ext, e, nz, i, n0 + j);
        }
      }
      const float* xr = xs + (i - k0) * MT;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float xv = xr[m];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(xv, w[j], acc[m][j]);
      }
    }
  }

  // The KS slices of the block, summed in slice order, DEC_RM output
  // rows a round, through the (now free) x slab.
  float* red = xs;
#pragma unroll
  for (int m0 = 0; m0 < MT; m0 += DEC_RM) {
    if (m0 >= g.M) break;
    __syncthreads();
#pragma unroll
    for (int r = 0; r < DEC_RM && r < MT; ++r) {
      float4* dst = reinterpret_cast<float4*>(
          red + (sl * DEC_RM + r) * W + 8 * gi_col);
      dst[0] = make_float4(acc[m0 + r][0], acc[m0 + r][1], acc[m0 + r][2],
                           acc[m0 + r][3]);
      dst[1] = make_float4(acc[m0 + r][4], acc[m0 + r][5], acc[m0 + r][6],
                           acc[m0 + r][7]);
    }
    __syncthreads();
    for (int q = tid; q < DEC_RM * W; q += THREADS) {
      int r = q / W, c = q % W;
      if (m0 + r >= MT) continue;
      float s = 0.0f;
      for (int k = 0; k < KS; ++k) s += red[(k * DEC_RM + r) * W + c];
      part[(m0 + r) * W + c] = s;
    }
  }

  // The cluster's 8 blocks, summed in rank order; block r writes the
  // elements q = r*256 + tid (mod 8*256) of the M x 8G tile.
  cluster.sync();
  for (int q = rank * THREADS + tid; q < g.M * W; q += CLUSTER * THREADS) {
    int m = q / W, c = q % W;
    int n = blockIdx.x * W + c;
    if (n >= g.N) continue;
    float s = *cluster.map_shared_rank(part + q, 0);
#pragma unroll
    for (int k = 1; k < CLUSTER; ++k) s += *cluster.map_shared_rank(part + q, k);
    out[(size_t)m * g.N + n] = s;
  }
  cluster.sync();   // no block leaves while another reads its part
}

// --------------------------------------------------------------- prefill

// The product runs transposed, y^T = W'^T x^T: W'^T is wgmma's A operand
// and is expanded straight into registers, x is the B operand in shared
// memory.  Block: 128 columns of W' (two warpgroups of 64) by 128 rows
// of x, all of the block's part of I in slabs of BK = 32 rows.  Shared
// memory holds x's TF32 hi and lo parts in wgmma's K-major core-matrix
// layout (two buffers), the rows' factors 1 + eta*p (two buffers), and
// a ring of PF_STAGES staged raw slabs (x, codes, pos) that cp.async
// fills ahead; after the ring, the eta*M1 table (FAST, no col_pos) or a
// ring of the slabs' col_pos tiles, then (EXT_GAIN_STAGED) a ring of the
// slabs' gain.  A k step of 8: expand the thread's 4 weights of W'^T,
// split them, issue 3 wgmma, and convert a piece of the next slab's x
// while the previous step's products run.  bf16 x is staged as bf16 and
// widened (exactly) when it is split.
//
// The tensor core adds products into its f32 accumulator with
// truncation, not rounding: summed over all of I in the accumulator,
// that bias grows with I and misses the 1e-5 bound at phi3's widths.
// So each slab's products start from zero (the first wgmma of a slab
// overwrites d), and d is added to the running sums with
// round-to-nearest adds.
template <bool FAST, bool EXT>
__global__ void __launch_bounds__(THREADS, 1)
cim_prefill_kernel(const void* __restrict__ x,
                   const int16_t* __restrict__ codes,
                   const int32_t* __restrict__ pos,
                   const float* __restrict__ scale_ptr,
                   float* __restrict__ out, Geom g, float eta, Ext e) {
  constexpr int BM = PF_BM, BN = PF_BN, BK = PF_BK;
  constexpr int SBO = BK / 4 * 128;            // bytes between 8-row groups
  constexpr int PART = BM * BK;                // floats of x's hi or lo part
  constexpr int XLD = BK + 4;                  // staged x row (floats)
  constexpr int XLDB = BK + 8;                 // staged bf16 x row
  constexpr int CLD = BN + 8;                  // staged codes row (int16)
  constexpr int TILES = BN / 8;                // pos entries a row (wpt 8)
  constexpr int ST = BM * XLD * 4 + BK * CLD * 2 + BK * TILES * 4;
  extern __shared__ float4 smem4[];
  float* px = reinterpret_cast<float*>(smem4);  // [2 buf][hi, lo][PART]
  float* rowf = px + 4 * PART;                  // [2 buf][BK][TILES]
  char* ring = reinterpret_cast<char*>(rowf + 2 * BK * TILES);
  float* table = reinterpret_cast<float*>(ring + PF_STAGES * ST);
  int* cring = reinterpret_cast<int*>(table);   // [STAGES][cp_ti*cp_tn*cols]
  float* gring = reinterpret_cast<float*>(
      reinterpret_cast<char*>(smem4) + g.off_p);  // [STAGES][BK][PF_GLD]
  auto xst_of = [&](int kt) {
    return reinterpret_cast<float*>(ring + (kt % PF_STAGES) * ST);
  };
  auto cst_of = [&](int kt) {
    return reinterpret_cast<int16_t*>(xst_of(kt) + BM * XLD);
  };
  auto pst_of = [&](int kt) {
    return reinterpret_cast<int*>(cst_of(kt) + BK * CLD);
  };
  const int cp_n = g.cp_ti * g.cp_tn * cps_stride(g);
  auto cps_of = [&](int kt) { return cring + (kt % PF_STAGES) * cp_n; };
  auto gst_of = [&](int kt) { return gring + (kt % PF_STAGES) * BK * PF_GLD; };
  // Float offset of (row, k) in a core-matrix part.
  auto core = [](int r, int k) {
    return (r >> 3) * (SBO / 4) + (k >> 2) * 32 + (r & 7) * 4 + (k & 3);
  };

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wg = warp / 4, gq = lane / 4, tq = lane % 4;
  const int n_base = blockIdx.x * BN, m_base = blockIdx.y * BM;
  // The thread's two columns of W' (its A-fragment rows).
  const int c_lo = wg * 64 + (warp % 4) * 16 + gq, c_hi = c_lo + 8;
  const float scale = *scale_ptr;
  const float unit = ldexpf(1.0f, -g.n_bits);
  const int n_steps = (g.I + BK - 1) / BK;
  const int ext = EXT ? g.ext : 0;
  const bool colp = ext & EXT_COLP;
  const float nz = __fmul_rn(e.nsig, scale);
  const int tn0 = n_base / g.wpt;
  const bool xbf = g.xbf16;
  const bool xvec = xbf ? (g.I % 8 == 0) &&
                              ((reinterpret_cast<uintptr_t>(x) & 15) == 0)
                        : (g.I % 4 == 0) &&
                              ((reinterpret_cast<uintptr_t>(x) & 15) == 0);
  const float* xf = reinterpret_cast<const float*>(x);
  const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(x);

  // Slab kt's raw x, codes, pos (and col_pos tiles, gain) into its ring
  // slot: one commit group, empty past the last slab.
  auto stage = [&](int kt) {
    if (kt < n_steps) {
      const int k0 = kt * BK;
      float* xst = xst_of(kt);
      __nv_bfloat16* xsb = reinterpret_cast<__nv_bfloat16*>(xst);
      if (xbf && xvec) {
#pragma unroll
        for (int it = 0; it < BM * BK / 8 / THREADS; ++it) {
          int q = tid + it * THREADS;
          int r = q / (BK / 8), c = 8 * (q % (BK / 8));
          int gm = m_base + r, gi = k0 + c;
          bool ok = gm < g.M && gi < g.I;
          tf32::cp_async16(xsb + r * XLDB + c,
                           ok ? xb + (size_t)gm * g.I + gi : xb, ok ? 16 : 0);
        }
      } else if (xbf) {
        for (int it = 0; it < BM * BK / THREADS; ++it) {
          int q = tid + it * THREADS;
          int r = q / BK, c = q % BK;
          int gm = m_base + r, gi = k0 + c;
          xsb[r * XLDB + c] = gm < g.M && gi < g.I
                                  ? xb[(size_t)gm * g.I + gi]
                                  : __float2bfloat16_rn(0.0f);
        }
      } else if (xvec) {
#pragma unroll
        for (int it = 0; it < BM * BK / 4 / THREADS; ++it) {
          int q = tid + it * THREADS;
          int r = q / (BK / 4), c = 4 * (q % (BK / 4));
          int gm = m_base + r, gi = k0 + c;
          bool ok = gm < g.M && gi < g.I;
          tf32::cp_async16(xst + r * XLD + c,
                           ok ? xf + (size_t)gm * g.I + gi : xf, ok ? 16 : 0);
        }
      } else {
#pragma unroll 4
        for (int it = 0; it < BM * BK / THREADS; ++it) {
          int q = tid + it * THREADS;
          int r = q / BK, c = q % BK;
          int gm = m_base + r, gi = k0 + c;
          bool ok = gm < g.M && gi < g.I;
          tf32::cp_async4(xst + r * XLD + c,
                          ok ? xf + (size_t)gm * g.I + gi : xf, ok ? 4 : 0);
        }
      }
      if (FAST) {
        int16_t* cst = cst_of(kt);
        int* pst = pst_of(kt);
#pragma unroll
        for (int it = 0; it < BK * TILES / THREADS; ++it) {
          int q = tid + it * THREADS;
          int r = q / TILES, tile = q % TILES;
          int gi = k0 + r, gn = n_base + 8 * tile;
          bool ok = gi < g.I && gn < g.n_pad;
          tf32::cp_async16(cst + r * CLD + 8 * tile,
                           ok ? codes + (size_t)gi * g.n_pad + gn : codes,
                           ok ? 16 : 0);
          tf32::cp_async4(
              pst + q, ok ? pos + (size_t)gi * g.n_tiles + gn / g.wpt : pos,
              ok ? 4 : 0);
        }
      }
      if (EXT && colp) load_colp(cps_of(kt), e.colp, g, k0 / g.rows, tn0, true);
      if (EXT && (ext & EXT_GAIN_STAGED)) {
        float* gst = gst_of(kt);
#pragma unroll
        for (int it = 0; it < BK * BN / 4 / THREADS; ++it) {
          int q = tid + it * THREADS;
          int r = q / (BN / 4), c = 4 * (q % (BN / 4));
          int gi = k0 + r, gn = n_base + c;
          bool ok = gi < g.I && gn < g.n_pad;
          tf32::cp_async16(gst + r * PF_GLD + c,
                           ok ? e.gain + (size_t)gi * g.n_pad + gn : e.gain,
                           ok ? 16 : 0);
        }
      }
    }
    tf32::cp_async_commit();
  };

  // Piece ``it`` (of 4) of slab kt's x as hi / lo parts of buffer
  // ``buf``: 4 values of one row, one 16-byte core-matrix row each; and,
  // for it < 2, 256 of the slab's 512 row factors.
  auto convert = [&](int kt, int buf, int it) {
    const float* xst = xst_of(kt);
    float* xh = px + buf * 2 * PART;
    int q = tid + it * THREADS;
    int r = q % BM, kc = q / BM;
    float4 v;
    if (xbf) {
      const uint2 raw = *reinterpret_cast<const uint2*>(
          reinterpret_cast<const __nv_bfloat16*>(xst) + r * XLDB + 4 * kc);
      v = make_float4(__uint_as_float(raw.x << 16),
                      __uint_as_float(raw.x & 0xFFFF0000u),
                      __uint_as_float(raw.y << 16),
                      __uint_as_float(raw.y & 0xFFFF0000u));
    } else {
      v = *reinterpret_cast<const float4*>(xst + r * XLD + 4 * kc);
    }
    uint4 hi, lo;
    tf32::split(v.x, hi.x, lo.x);
    tf32::split(v.y, hi.y, lo.y);
    tf32::split(v.z, hi.z, lo.z);
    tf32::split(v.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(xh + core(r, 4 * kc)) = hi;
    *reinterpret_cast<uint4*>(xh + PART + core(r, 4 * kc)) = lo;
    if (FAST && it < BK * TILES / THREADS) {
      rowf[buf * BK * TILES + q] =
          row_factor(pst_of(kt)[q], eta);
    }
  };

  // The thread's A fragment of k step k8 of slab kt: W'[k][c] for
  // (c, k) = (c_lo, t), (c_hi, t), (c_lo, t + 4), (c_hi, t + 4).
  auto expand_a = [&](int kt, int k8, uint32_t (&ah)[4], uint32_t (&al)[4]) {
    float w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = q % 2 ? c_hi : c_lo, k = k8 * 8 + tq + 4 * (q / 2);
      const int gn = n_base + c, gi = kt * BK + k;
      const bool ok = gi < g.I && gn < g.n_pad;
      int code;
      float row;
      if constexpr (FAST) {
        code = cst_of(kt)[k * CLD + c];
        row = rowf[(kt & 1) * BK * TILES + k * TILES + c / 8];
      } else {
        code = ok ? codes[(size_t)gi * g.n_pad + gn] : 0;
        int p = ok ? pos[(size_t)gi * g.n_tiles + gn / g.wpt] : 0;
        row = row_factor(p, eta);
      }
      if (EXT && colp) {
        const int* cp = cps_of(kt) +
                        ((gi / g.rows - (kt * BK) / g.rows) * g.cp_tn +
                         (gn / g.wpt - tn0)) * cps_stride(g) +
                        (gn % g.wpt) * g.n_bits;
        w[q] = ok ? expand_colp(code, row, cp, unit, scale, eta, g.n_bits)
                  : 0.0f;
      } else if constexpr (FAST) {
        w[q] = expand_fast(code, row, table_row(table, gn % g.wpt, g.n_bits),
                           unit, scale);
      } else {
        w[q] = expand_row(code, row, (gn % g.wpt) * g.n_bits, unit, scale,
                          eta, g.n_bits, g.cols, g.reversed);
      }
      if (EXT && ok) {
        float gn_v = 1.0f;
        if (ext & EXT_GAIN_STAGED)
          gn_v = gst_of(kt)[k * PF_GLD + c];
        else if (ext & EXT_GAIN)
          gn_v = e.gain[(size_t)gi * g.n_pad + gn];
        w[q] = apply_ext(w[q], gn_v, ext, e, nz, gi, gn);
      }
      tf32::split(w[q], ah[q], al[q]);
    }
  };

  if (FAST && !colp)   // the col_pos ring takes the table's place
    build_table(table, g.wpt, g.n_bits, g.cols, g.reversed, eta, unit);
  // Slab kt + PF_STAGES - 1 is staged while slab kt runs.
  for (int kt = 0; kt < PF_STAGES - 1; ++kt) stage(kt);
  tf32::cp_async_wait<PF_STAGES - 2>();
  __syncthreads();                  // the table and slab 0's staging
#pragma unroll
  for (int it = 0; it < 4; ++it) convert(0, 0, it);
  tf32::cp_async_wait<PF_STAGES - 3>();
  tf32::fence_proxy_async();
  __syncthreads();

  float acc[64], d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = d[i] = 0.0f;
  uint32_t ah[2][4], al[2][4];

  for (int kt = 0; kt < n_steps; ++kt) {
    const int buf = kt & 1;
    const bool more = kt + 1 < n_steps;
    stage(kt + PF_STAGES - 1);
    const float* xh = px + buf * 2 * PART;
#pragma unroll
    for (int k8 = 0; k8 < BK / 8; ++k8) {
      expand_a(kt, k8, ah[k8 % 2], al[k8 % 2]);
      tf32::wg_fence();
      tf32::wg_fence_operand(d);
      const uint64_t b_hi = tf32::wg_desc(xh + 64 * k8, SBO);
      const uint64_t b_lo = tf32::wg_desc(xh + PART + 64 * k8, SBO);
      tf32::wgmma_m64n128k8_rs(d, al[k8 % 2], b_hi, k8 > 0);
      tf32::wgmma_m64n128k8_rs(d, ah[k8 % 2], b_lo, 1);
      tf32::wgmma_m64n128k8_rs(d, ah[k8 % 2], b_hi, 1);
      tf32::wg_commit();
      if (more) convert(kt + 1, buf ^ 1, k8);
      tf32::wg_wait<1>();           // step k8 - 1 is done with its A
    }
    tf32::wg_wait<0>();
    tf32::wg_fence_operand(d);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], d[i]);
    tf32::cp_async_wait<PF_STAGES - 3>();   // slab kt + 2 has landed
    tf32::fence_proxy_async();
    __syncthreads();
  }

  // d[4j + q] is D[c][m]: W' column c_lo (q < 2) or c_hi, x row
  // 8j + 2t + q % 2.
  auto store = [&](int i, float v) {
    int gn = n_base + (i % 4 < 2 ? c_lo : c_hi);
    int gm = m_base + 8 * (i / 4) + 2 * tq + (i % 2);
    if (gm < g.M && gn < g.N) out[(size_t)gm * g.N + gn] = v;
  };
#pragma unroll
  for (int i = 0; i < 64; ++i) store(i, acc[i]);
}

// Set a kernel's dynamic shared-memory limit once, then launch.
template <auto Kernel>
cudaError_t launch(const Geom& g, const void* x, const int16_t* codes,
                   const int32_t* pos, const float* scale, float* out,
                   float eta, const Ext& e, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  Kernel<<<dim3(g.gx, g.gy), THREADS, g.smem, stream>>>(x, codes, pos, scale,
                                                        out, g, eta, e);
  return cudaGetLastError();
}

template <bool FAST, bool EXT>
cudaError_t launch_decode(const Geom& g, const void* x,
                          const int16_t* codes, const int32_t* pos,
                          const float* scale, float* out, float eta,
                          const Ext& e, cudaStream_t s) {
  switch (g.mt) {
    case 1: return launch<cim_decode_kernel<1, FAST, EXT>>(g, x, codes, pos, scale, out, eta, e, s);
    case 2: return launch<cim_decode_kernel<2, FAST, EXT>>(g, x, codes, pos, scale, out, eta, e, s);
    case 4: return launch<cim_decode_kernel<4, FAST, EXT>>(g, x, codes, pos, scale, out, eta, e, s);
    case 8: return launch<cim_decode_kernel<8, FAST, EXT>>(g, x, codes, pos, scale, out, eta, e, s);
    case 16: return launch<cim_decode_kernel<16, FAST, EXT>>(g, x, codes, pos, scale, out, eta, e, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool EXT>
cudaError_t launch_form(const Geom& g, const void* x, const int16_t* codes,
                        const int32_t* pos, const float* scale, float* out,
                        float eta, const Ext& e, cudaStream_t s) {
  if (g.form == 0) {
    return g.fast ? launch_decode<true, EXT>(g, x, codes, pos, scale, out, eta, e, s)
                  : launch_decode<false, EXT>(g, x, codes, pos, scale, out, eta, e, s);
  }
  return g.fast
      ? launch<cim_prefill_kernel<true, EXT>>(g, x, codes, pos, scale, out, eta, e, s)
      : launch<cim_prefill_kernel<false, EXT>>(g, x, codes, pos, scale, out, eta, e, s);
}

}  // namespace

// ``geom`` holds the Geom fields in order (ops.py::cim_geometry); x is
// f32 or (geom xbf16) bf16.  ``gain`` / ``colp`` may be null, and
// ``nsig`` = sigma_read * agg is 0 without read noise (Geom.ext says
// which operands the call carries).  Returns cudaGetLastError() of the
// launch, or cudaErrorInvalidValue for a geometry no kernel takes.
extern "C" int cim_mvm_launch(const void* x, const int16_t* codes,
                              const int32_t* pos, const float* scale,
                              float* out, const int* geom, float eta,
                              const float* gain, const int32_t* colp,
                              unsigned seed, unsigned tag, float nsig,
                              void* stream_ptr) {
  Geom g;
  static_assert(sizeof(Geom) == 25 * sizeof(int), "Geom is 25 ints");
  memcpy(&g, geom, sizeof(Geom));
  const Ext e = {gain, colp, seed, tag, nsig};
  cudaStream_t s = (cudaStream_t)stream_ptr;
  if (((g.ext & EXT_GAIN) && !gain) || ((g.ext & EXT_COLP) && !colp) ||
      ((g.ext & EXT_COLP) && g.rows < 1) ||
      ((g.ext & EXT_GAIN_STAGED) && !(g.form == 1 && g.fast)))
    return (int)cudaErrorInvalidValue;
  if (g.form == 0) {
    if (g.gy != CLUSTER || THREADS % g.tile) return (int)cudaErrorInvalidValue;
  } else if (g.tile != PF_BN) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = g.ext ? launch_form<true>(g, x, codes, pos, scale, out, eta, e, s)
                          : launch_form<false>(g, x, codes, pos, scale, out, eta, e, s);
  return (int)err;
}
