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
// Nonideal devices (the reference applies their operands in its fused
// XLA path only, src/repro/kernels/cim_mvm/xla.py::cim_mvm_xla):
//   W_eff = W'(col_pos) * gain + nz * eps(i, n)
// * The deterministic part, Wg = W'(col_pos) * gain, is folded once a
//   deployment by the fold kernel below (cim_fold_kernel, at deploy):
//   with an f32 gain it costs the same 4 bytes a weight that the gain
//   alone would, and it takes the expansion and the col_pos moment off
//   every read.  col_pos (Ti, Tn, cols) int32 moves bit k of weight n to
//   the physical bitline col_pos[ti, tn, col(n, k)]: M1 * 2^K = sum_k b_k
//   col_pos_k 2^(K-1-k), an exact integer below cols * 2^K, and the rest
//   of the expansion is the ideal forms' rounded operations, so Wg is
//   bit-identical to the plain version's W' * gain.
// * Read noise is the only part that depends on the read: eps(i, n) is a
//   standard normal from a counter-based Philox4x32-10 written into the
//   kernel (key = (read_seed, noise_tag), counter = (i, n >> 2, 0, 0);
//   Box-Muller on the top 24 bits of words 0, 1 and of words 2, 3 gives
//   four normals, one a column n & 3), a function of (read_seed, tag, i,
//   n) alone: every row of x sees the same W_eff in one read, whatever M,
//   form or block shape.  nz = (sigma_read * agg) * scale with agg =
//   sqrt((1 - 4^-K) / 3).  No eps tensor exists in device memory.  The
//   plain version (ref.py) computes the same Philox words in int64
//   arithmetic, so the uniforms are bit-identical; the normal differs by
//   the last bits of log / cos (here the SFU's __logf and __sincosf).
// * Two forms read Wg (f32, rows of ``ld`` floats, ld a multiple of 8):
//   the folded decode form (M <= 16) keeps the decode form's layout and
//   cluster reduction, a thread's 8 columns in two 16-byte loads a row
//   and their noise in two Philox calls a row; the folded prefill form
//   stages BK x BN slabs of Wg by cp.async beside x and adds the noise in
//   one cooperative pass a slab (one Philox call for four consecutive
//   columns of a slab row, four a thread a slab), overlapped with the
//   products of the slab before.  With bf16 x the TF32 lo part of x is
//   exactly zero, so that product is skipped: two wgmma a k step.  The
//   batched folded decode form (a group of members in one launch) stages
//   Wg slabs the same way and runs its product on mma.sync tensor cores.
//
// Grouped ideal forms (an MoE expert bank, below): the counterpart of
// jax.vmap(cim_mvm) over the expert axis.  Each expert's rows of a
// compact, expert-sorted x go through that expert's W', expanded from its
// codes and pos; an expert without rows reads nothing.  A streaming
// decode form (a cluster splits I, W' in registers) for a few rows an
// expert, a tensor-core prefill form (mma.sync 3xTF32) for many, and a
// general CUDA-core form for the ragged spec.  A bank on imperfect
// devices is folded at deploy, one Wg an expert, and read by the grouped
// folded forms, each expert's read noise at its own tag: the same
// streaming decode form over Wg with the noise drawn in registers, the
// same tensor-core prefill form over staged Wg slabs with the noise
// added to each slab once, and the first, general form (the general
// form's blocks over Wg slabs) where those refuse the shape.
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
#include <type_traits>

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
constexpr int PF_WLD = PF_BN + 8;  // folded prefill: a staged row of Wg
constexpr int FOLD_COLS = 256;     // fold: columns a block (32 threads of 8)
constexpr int BT_BN = 128;     // batched: columns a work item
constexpr int BT_BK = 32;      // batched: rows of I a slab
constexpr int BT_STAGES = 4;   // batched: ring of staged slabs
constexpr int BT_BLOCKS = 2;   // batched: blocks a SM it is built for
constexpr int BT_WLD = BT_BN + 8;  // batched: a staged row of Wg (floats)
constexpr int BT_XLD = BT_BK + 4;  // batched: a staged or split row of x
constexpr int GR_BM = 32;      // grouped general: rows of an expert a block
constexpr int GR_BN = 128;     // grouped general: columns a block
constexpr int GR_BK = 32;      // grouped general: rows of I a slab
constexpr int GD_BN = 128;     // grouped decode: columns a block
constexpr int GD_BK = 16;      // grouped decode: rows of I a slab (a row a thread)
constexpr int GD_STAGES = 8;   // grouped decode: a thread's ring of staged rows
constexpr int GD_RB = 4;       // grouped decode: rows of an expert a pass
constexpr int GD_BLOCKS = 3;   // grouped decode: blocks a SM it is built for
constexpr int GP_BN = 128;     // grouped prefill: columns a block
constexpr int GP_BK = 32;      // grouped prefill: rows of I a slab
constexpr int GP_STAGES = 4;   // grouped prefill: ring of staged slabs
constexpr int GP_NT = 16;      // grouped prefill: 8-row tiles of x a pass
constexpr int GP_KS = 2;       // grouped prefill: k steps a rounding group
constexpr int GFD_STAGES = 4;  // grouped folded decode: a thread's ring of staged rows
constexpr int GFD_BLOCKS = 3;  // grouped folded decode: blocks a SM it is built for
constexpr int GFP_STAGES = 4;  // grouped folded prefill: ring of staged slabs
constexpr int GFP_WLD = GP_BN + 8;   // grouped folded prefill: a staged Wg row, f32 x
constexpr int GFP_WLDB = GP_BN + 4;  // the same with bf16 x
// Geom.form: the ideal decode and prefill forms, the folded ones, the fold,
// the batched folded decode form, the grouped forms (general, decode,
// prefill), the grouped folded forms (general, decode, prefill).
constexpr int FORM_DECODE = 0, FORM_PREFILL = 1, FORM_DECODE_FOLDED = 2,
              FORM_PREFILL_FOLDED = 3, FORM_FOLD = 4,
              FORM_DECODE_BATCHED = 5, FORM_GROUPED = 6,
              FORM_GROUPED_DECODE = 7, FORM_GROUPED_PREFILL = 8,
              FORM_GROUPED_FOLDED = 9, FORM_GROUPED_FOLDED_DECODE = 10,
              FORM_GROUPED_FOLDED_PREFILL = 11;

// Launch geometry, computed by ops.py::cim_geometry / fold_geometry /
// batched_geometry / grouped_geometry (same order).  ``gz``: the folded
// prefill form's split of I (a cluster of gz blocks), the batched form's
// members, the grouped forms' expert slots, 1 elsewhere; the grouped
// forms' ``M`` is the most rows an expert computes (the capacity) and
// ``experts`` the experts of the bank (0 elsewhere); the grouped decode
// form's ``gy`` blocks are a cluster that splits I; the batched form's
// ``gx`` blocks are persistent, in clusters of ``gy`` that split I;
// ``ld``: the row stride of Wg (folded forms and the fold); ``noise``: the
// read draws noise; ``rows``, ``n_ti``, ``cp_ti``, ``cp_tn``: the fold's
// col_pos tiles.
struct Geom {
  int form, M, I, N, n_pad, n_tiles, wpt, n_bits, cols, reversed, fast,
      tile, rps, gx, gy, gz, smem, off_t, off_p, mt, xbf16, ld, noise, rows,
      n_ti, cp_ti, cp_tn, experts;
};

// The read noise: Philox4x32-10's round keys for key (read_seed, tag),
// k0[r] = read_seed + r * 0x9E3779B9 and k1[r] = tag + r * 0xBB67AE85
// (mod 2^32), made once a launch on the host so that a round reads them
// as kernel parameters, and the amplitude sigma_read * agg before the
// scale.
constexpr int PHILOX_ROUNDS = 10;
struct Noise {
  uint32_t k0[PHILOX_ROUNDS], k1[PHILOX_ROUNDS];
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

// ------------------------------------------------------------ the fold

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

// col_pos tiles [ti0, ti0 + cp_ti) x [tn0, tn0 + cp_tn) into shared
// memory as cps[(a * cp_tn + b) * cps_stride + slot * K + k] =
// col_pos[ti0 + a][tn0 + b][col(slot, k)] (mirrored under reversed
// dataflow), zeros past the grid.
__device__ __forceinline__ void load_colp(int* cps, const int32_t* colp,
                                          const Geom& g, int ti0, int tn0) {
  const int n = g.cp_ti * g.cp_tn * g.cols;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int c = e % g.cols, t = e / g.cols;
    const int ti = ti0 + t / g.cp_tn, tn = tn0 + t % g.cp_tn;
    const bool ok = ti < g.n_ti && tn < g.n_tiles;
    cps[t * cps_stride(g) + c] =
        ok ? colp[((size_t)ti * g.n_tiles + tn) * g.cols +
                  (g.reversed ? g.cols - 1 - c : c)]
           : 0;
  }
}

// Wg = W'(col_pos) * gain, (I_pad, ld) f32 with zero columns past n_pad,
// once a deployment.  Geom: I = I_pad, rps rows a block, FOLD_COLS
// columns a block; thread t owns the 8 columns 8 (t % 32) of the block
// and the rows t / 32 + 8 j.  FAST (wpt % 8 == 0, n_pad % 8 == 0, codes
// and gain on 16 bytes): 16-byte code and gain loads, one pos a row, the
// eta*M1 table (without col_pos).  COLP: the block's col_pos tiles in
// shared memory.  Bound by bytes: 2 (codes) + 4/wpt (pos) + 4 (gain) read
// and 4 written a weight.
template <bool FAST, bool COLP>
__global__ void __launch_bounds__(THREADS)
cim_fold_kernel(const int16_t* __restrict__ codes,
                const int32_t* __restrict__ pos,
                const float* __restrict__ scale_ptr,
                const float* __restrict__ gain,
                const int32_t* __restrict__ colp, float* __restrict__ wf,
                Geom g, float eta) {
  extern __shared__ float4 smem4[];
  float* table = reinterpret_cast<float*>(smem4);     // FAST, no col_pos
  int* cps = reinterpret_cast<int*>(smem4);           // COLP
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * FOLD_COLS + 8 * (tid % 32);
  const int k0 = blockIdx.y * g.rps, k1 = min(k0 + g.rps, g.I);
  const float scale = *scale_ptr;
  const float unit = ldexpf(1.0f, -g.n_bits);
  const int ti0 = COLP ? k0 / g.rows : 0;
  const int tn0 = blockIdx.x * FOLD_COLS / g.wpt;
  if (COLP)
    load_colp(cps, colp, g, ti0, tn0);
  else if (FAST)
    build_table(table, g.wpt, g.n_bits, g.cols, g.reversed, eta, unit);
  __syncthreads();
  if (n0 >= g.ld) return;
  const int stride = cps_stride(g);
  for (int i = k0 + tid / 32; i < k1; i += THREADS / 32) {
    float w[8];
    if (FAST) {
      const int4 cv = __ldg(reinterpret_cast<const int4*>(
          codes + (size_t)i * g.n_pad + n0));
      const int slot0 = n0 % g.wpt, tile = n0 / g.wpt;
      const float row = row_factor(__ldg(pos + (size_t)i * g.n_tiles + tile),
                                   eta);
      const int words[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int lo = (int)(int16_t)(words[q] & 0xFFFF), hi = words[q] >> 16;
        if (COLP) {
          const int* cp = cps + ((i / g.rows - ti0) * g.cp_tn + (tile - tn0)) *
                                    stride + (slot0 + 2 * q) * g.n_bits;
          w[2 * q] = expand_colp(lo, row, cp, unit, scale, eta, g.n_bits);
          w[2 * q + 1] =
              expand_colp(hi, row, cp + g.n_bits, unit, scale, eta, g.n_bits);
        } else {
          w[2 * q] = expand_fast(lo, row, table_row(table, slot0 + 2 * q,
                                                    g.n_bits), unit, scale);
          w[2 * q + 1] = expand_fast(
              hi, row, table_row(table, slot0 + 2 * q + 1, g.n_bits), unit,
              scale);
        }
      }
      if (gain) {
        const float4* gp =
            reinterpret_cast<const float4*>(gain + (size_t)i * g.n_pad + n0);
        const float4 a = __ldg(gp), b = __ldg(gp + 1);
        const float gv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) w[j] = __fmul_rn(w[j], gv[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + j;
        w[j] = 0.0f;
        if (n >= g.n_pad) continue;
        const int code = codes[(size_t)i * g.n_pad + n];
        const int tn = n / g.wpt, slot = n % g.wpt;
        const float row = row_factor(pos[(size_t)i * g.n_tiles + tn], eta);
        if (COLP) {
          const int* cp = cps + ((i / g.rows - ti0) * g.cp_tn + (tn - tn0)) *
                                    stride + slot * g.n_bits;
          w[j] = expand_colp(code, row, cp, unit, scale, eta, g.n_bits);
        } else {
          w[j] = expand_row(code, row, slot * g.n_bits, unit, scale, eta,
                            g.n_bits, g.cols, g.reversed);
        }
        if (gain) w[j] = __fmul_rn(w[j], gain[(size_t)i * g.n_pad + n]);
      }
    }
    float4* dst = reinterpret_cast<float4*>(wf + (size_t)i * g.ld + n0);
    dst[0] = make_float4(w[0], w[1], w[2], w[3]);
    dst[1] = make_float4(w[4], w[5], w[6], w[7]);
  }
}

// ------------------------------------------------------------ read noise

// Two standard normals from two 32-bit words: Box-Muller on their top 24
// bits (u1 in (0, 1), so the log is finite and -2 ln u1 > 0), r cos(2 pi
// u2) and r sin(2 pi u2).  u = (m + 1/2) 2^-24 for m = w >> 8 (rounded
// as the plain version rounds m + 1/2) is one FMA, m 2^-24 + 2^-25:
// scaling by 2^-24 commutes with rounding.  u1 rounds to exactly 1 for m
// = 2^24 - 1 (one word in 2^24), so t = -2 ln u1 may be 0: r = t
// rsqrt(max(t, FLT_MIN)) is 0 there, where t rsqrt(t) would be 0 * inf.
// The SFU's __logf, rsqrtf and __sincosf: 2 pi (u2 - 1/2) lies in (-pi,
// pi), where __sincosf is accurate to 2^-21.4, and cos(2 pi u2) = -cos(2
// pi (u2 - 1/2)) (u2 - 1/2 is exact).  u1 >= 2^-25 and the rsqrt's
// argument >= FLT_MIN are normal, so lg2.approx.ftz and rsqrt.approx.ftz
// give what __logf (lg2 * ln 2) and rsqrtf give without their subnormal
// handling, and -2 (lg2 * ln 2) is one multiply by -2 fl(ln 2) (exact;
// scaling by 2 commutes with rounding): the same normals, bit for bit,
// seven instructions fewer.
__device__ __forceinline__ void box_muller(uint32_t a, uint32_t b,
                                           float& z0, float& z1) {
  const float u1 = __fmaf_rn((float)(a >> 8), 5.9604644775390625e-08f,
                             2.98023223876953125e-08f);
  const float u2 = __fmaf_rn((float)(b >> 8), 5.9604644775390625e-08f,
                             2.98023223876953125e-08f);
  float lg, rs;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(lg) : "f"(u1));
  const float t = fmaxf(lg * -1.38629436492919921875f, 0.0f);
  asm("rsqrt.approx.ftz.f32 %0, %1;"
      : "=f"(rs)
      : "f"(fmaxf(t, 1.17549435e-38f)));
  const float r = t * rs;
  float s, c;
  __sincosf(6.28318530717958648f * (u2 - 0.5f), &s, &c);
  z0 = -r * c;
  z1 = -r * s;
}

// Four standard normals from one Philox4x32-10 call at the key of ``e``
// and counter (c0, c1, 0, 0): words 0, 1 give z[0], z[1] and words 2, 3
// give z[2], z[3].  The read noise of weight (i, n) is z[n & 3] at
// counter (i, n >> 2): four neighbouring columns share a call.
__device__ __forceinline__ void philox_normal4(const Noise& e, uint32_t c0,
                                               uint32_t c1, float (&z)[4]) {
  uint32_t c2 = 0, c3 = 0;
#pragma unroll
  for (int r = 0; r < PHILOX_ROUNDS; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ e.k0[r];
    c1 = lo1;
    c2 = hi0 ^ c3 ^ e.k1[r];
    c3 = lo0;
  }
  box_muller(c0, c1, z[0], z[1]);
  box_muller(c2, c3, z[2], z[3]);
}

// The same four normals at key (read_seed, tag): the first word's round
// keys from ``e``, the second's tag + r * 0xBB67AE85 (the batched form's
// per-member tag).
__device__ __forceinline__ void philox_normal4_tag(const Noise& e,
                                                   uint32_t tag, uint32_t c0,
                                                   uint32_t c1,
                                                   float (&z)[4]) {
  uint32_t c2 = 0, c3 = 0;
#pragma unroll
  for (int r = 0; r < PHILOX_ROUNDS; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ e.k0[r];
    c1 = lo1;
    c2 = hi0 ^ c3 ^ (tag + (uint32_t)r * 0xBB67AE85u);
    c3 = lo0;
  }
  box_muller(c0, c1, z[0], z[1]);
  box_muller(c2, c3, z[2], z[3]);
}

// w[j] + nz * z[j], the plain version's order (W_eff = Wg + nz * eps).
__device__ __forceinline__ float4 add_noise(float4 w, float nz,
                                            const float (&z)[4]) {
  return make_float4(__fadd_rn(w.x, __fmul_rn(nz, z[0])),
                     __fadd_rn(w.y, __fmul_rn(nz, z[1])),
                     __fadd_rn(w.z, __fmul_rn(nz, z[2])),
                     __fadd_rn(w.w, __fmul_rn(nz, z[3])));
}

// ---------------------------------------------------------------- decode

// The folded decode form's reduction: the KS slices of a block summed in
// slice order (DEC_RM output rows a round, through the x slab ``red``)
// into ``part`` [MT][W], then the cluster's 8 blocks summed in rank order
// into ``out``; block r writes the elements q = r*256 + tid (mod 8*256)
// of the M x W tile.  The ideal decode kernel keeps the same steps (and
// the x slab's load below) inline: through these helpers it measured ~2%
// slower at M = 4 on the H100 (PERF.md).
template <int MT>
__device__ __forceinline__ void decode_reduce(float (&acc)[MT][8],
                                              float* red, float* part,
                                              float* __restrict__ out,
                                              const Geom& g, int W, int KS,
                                              int sl, int gi_col) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), tid = threadIdx.x;
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

// The x slab of rank r's rows [k0, k0 + rows), transposed to [row][m]:
// coalesced reads along I.
template <int MT>
__device__ __forceinline__ void decode_load_x(float* xs, const void* x,
                                              const Geom& g, int k0,
                                              int rows) {
  for (int q = threadIdx.x; q < MT * rows; q += THREADS) {
    int m = q / rows, r = q % rows;
    xs[r * MT + m] =
        m < g.M ? load_x(x, (size_t)m * g.I + k0 + r, g.xbf16) : 0.0f;
  }
}

// Block: 8G columns (G threads of 8), KS = 256 / G slices of the
// block's I range; cluster rank r owns rows [r*rps, min((r+1)*rps, I)),
// slice s the rows k0 + s + KS*j.  MT: M rounded up to a power of two.
template <int MT, bool FAST>
__global__ void __cluster_dims__(1, CLUSTER, 1) __launch_bounds__(THREADS)
cim_decode_kernel(const void* __restrict__ x,
                  const int16_t* __restrict__ codes,
                  const int32_t* __restrict__ pos,
                  const float* __restrict__ scale_ptr,
                  float* __restrict__ out, Geom g, float eta) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* xs = smem;                 // [rows][MT], later the reduction
  float* table = smem + g.off_t;    // [wpt][2^K] eta * M1   (FAST)
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

  // x slab, transposed to [row][m]: coalesced reads along I.
  for (int q = tid; q < MT * rows; q += THREADS) {
    int m = q / rows, r = q % rows;
    xs[r * MT + m] =
        m < g.M ? load_x(x, (size_t)m * g.I + k0 + r, g.xbf16) : 0.0f;
  }
  if (FAST)
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
    auto load4 = [&](int i, int4 (&c)[4], int (&p)[4]) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        int ii = i + u * KS;
        bool ok = col_ok && ii < k1;
        c[u] = ok ? __ldg(reinterpret_cast<const int4*>(
                        codes + (size_t)ii * g.n_pad + n0))
                  : make_int4(0, 0, 0, 0);
        p[u] = ok ? __ldg(pos + (size_t)ii * g.n_tiles + tile_n) : 0;
      }
    };
    load4(k0 + sl, cv, pv);
    // A thread past n_pad has nothing to add.
    for (int i = col_ok ? k0 + sl : k1; i < k1; i += 4 * KS) {
      int4 ncv[4];
      int npv[4];
      load4(i + 4 * KS, ncv, npv);
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
          w[2 * q] = expand_fast(lo, row,
                                 table_row(table, slot0 + 2 * q, g.n_bits),
                                 unit, scale);
          w[2 * q + 1] = expand_fast(
              hi, row, table_row(table, slot0 + 2 * q + 1, g.n_bits), unit,
              scale);
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
        w[j] = expand_row(code, row_factor(p, eta), c0[j], unit, scale, eta,
                          g.n_bits, g.cols, g.reversed);
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

// The folded decode form: the decode form's blocks, slices and cluster
// reduction over Wg (rows of ld floats) instead of the codes.  A thread
// reads its 8 columns in two 16-byte loads a row, U = 2 rows a step with
// the next step's loads issued before this step's arithmetic, and (NOISE)
// draws their noise in two Philox calls a row (on the H100, 2 rows a
// step with no branch in it beat 4 rows: PERF.md).  Bound by
// bytes: 4 a weight, against 2.5 for the codes and pos of the ideal form
// plus 4 for a gain and 0.5 for col_pos that the unfolded operands would
// cost.  At most 128 registers for MT <= 8, so that two blocks fit on an
// SM.
template <int MT, bool NOISE>
__global__ void __cluster_dims__(1, CLUSTER, 1)
__launch_bounds__(THREADS, MT <= 8 ? 2 : 1)
cim_decode_folded_kernel(const void* __restrict__ x,
                         const float* __restrict__ wf,
                         const float* __restrict__ scale_ptr,
                         float* __restrict__ out, Geom g, Noise e) {
  constexpr int U = 2;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* xs = smem;                 // [rows][MT], later the reduction
  float* part = smem + g.off_p;     // [MT][8G] the block's sums
  const int rank = (int)cg::this_cluster().block_rank();

  const int G = g.tile, KS = THREADS / G, W = 8 * G;
  const int tid = threadIdx.x;
  const int gi_col = tid % G, sl = tid / G;
  const int n0 = blockIdx.x * W + 8 * gi_col;
  const int k0 = rank * g.rps;
  const int k1 = min(k0 + g.rps, g.I);
  const int rows = max(k1 - k0, 0);
  const float nz = __fmul_rn(e.nsig, *scale_ptr);

  decode_load_x<MT>(xs, x, g, k0, rows);
  __syncthreads();

  float acc[MT][8];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = 0.0f;

  // ld % 8 == 0: a thread's 8 columns are all in or all past the rows.
  const bool col_ok = n0 < g.ld;
  float4 wv[U][2];
  auto load = [&](int i, float4 (&w)[U][2]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int ii = i + u * KS;
      const float4* p =
          reinterpret_cast<const float4*>(wf + (size_t)ii * g.ld + n0);
      const bool ok = ii < k1;
      w[u][0] = ok ? __ldg(p) : make_float4(0.f, 0.f, 0.f, 0.f);
      w[u][1] = ok ? __ldg(p + 1) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  if (col_ok) load(k0 + sl, wv);
  for (int i = col_ok ? k0 + sl : k1; i < k1; i += U * KS) {
    float4 nw[U][2];
    load(i + U * KS, nw);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      // A row past the rank's adds zeros (no branch: the U rows' noise
      // draws interleave).
      const int ii = i + u * KS;
      const bool ok = ii < k1;
      float4 a = wv[u][0], b = wv[u][1];
      if constexpr (NOISE) {
        float z[4];
        philox_normal4(e, (uint32_t)ii, (uint32_t)n0 >> 2, z);
        a = add_noise(a, nz, z);
        philox_normal4(e, (uint32_t)ii, ((uint32_t)n0 >> 2) + 1, z);
        b = add_noise(b, nz, z);
        if (!ok) a = b = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      const float w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      const float* xr = xs + (ok ? ii - k0 : 0) * MT;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xv = xr[m];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(xv, w[j], acc[m][j]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      wv[u][0] = nw[u][0];
      wv[u][1] = nw[u][1];
    }
  }
  decode_reduce<MT>(acc, xs, part, out, g, W, KS, sl, gi_col);
}

// The batched folded decode form: one launch reads a whole group of
// members of a stacked folded deployment (the port's counterpart of the
// reference's jax.vmap(cim_mvm) over a stacked group, which the health
// controller's probe rounds run, src/repro/health/controller.py).
// Member z reads repeat reps[z] of the stack (rows of ld floats, wstride
// floats a repeat) with scale scale[reps[z]] and read-noise tag tags[z]
// (the tags need not be consecutive), x and y slab z of (G, M, I) and
// (G, M, N).  The Philox key's second word is the member's: k1 of round
// r is tag + r * 0xBB67AE85, an add a round, so no key table is held.
//
// Bound by bytes: 4 a weight of every member (3.24 GB at phi3's largest
// probe group, G = 32 members of 3072x8192, 0.97 ms at 3.35 TB/s).  The
// read noise costs ~26 SASS instructions a weight and the product 16
// FMAs a weight on the f32 pipe, so the design keeps the product off it
// and many bytes in flight without registers:
// * Persistent blocks over work items (member, BT_BN columns): block c
//   of the gx / gy clusters takes items c, c + gx / gy, ...  (member-
//   major, so neighbouring blocks share a member's x in L2), each over
//   all of I.  Where members x column tiles would leave SMs idle, a
//   cluster of gy blocks splits the slabs of I (rank r the slabs [s r /
//   gy, s (r + 1) / gy) of s) and merges its sums through distributed
//   shared memory, each output summed over the ranks in order.
// * A ring of BT_STAGES staged slabs (BT_BK rows of Wg by BT_BN columns,
//   and x's BT_BK columns), filled by 16-byte cp.async: the block walks
//   the flat sequence of its items' slabs, so the ring keeps loading
//   across an item's epilogue, and two to three slabs (35-52 KB a block,
//   two blocks a SM) are in flight without holding registers.
// * Noise on the staged slab: in the phase that runs slab q's products,
//   slab q + 1's noise is added in place, a thread four neighbouring
//   columns of one row from one Philox call at counter (i, n >> 2), in
//   the plain version's order (add_noise); x's slab is split into TF32
//   hi and lo parts (rows past M zero) in the same pass.
// * The product on tensor cores: mma.sync m16n8k8 TF32, x (16 rows, M of
//   them live) the A operand by ldmatrix from the split parts, the noisy
//   Wg the B operand split into hi and lo as it is read; 3xTF32 for f32
//   x, two products for bf16 x (its lo part is exactly zero).  Warp w
//   owns columns 16w .. 16w + 15 of the item: two m16n8 tiles.  As in
//   the prefill forms, each slab's products start from zero and are
//   added to the running sums with round-to-nearest adds (the tensor
//   core truncates as it accumulates).
// Every sum runs in a fixed order and nothing is atomic, so two calls
// give bit-identical results; rows past M and columns past N are never
// written.  Measured on the H100 (PERF.md, row 1f): without noise it
// reads at ~85% of the memory rate; with noise the loop's ~690
// instructions a thread a slab (the read noise ~60% of them) bound it
// at ~1.9x its byte bound: neither a deeper ring, three blocks a SM nor
// the product on wgmma moved it.
constexpr int BT_SMEM_X = 16 * BT_XLD;   // floats of a staged or split x
constexpr int BT_SMEM_W = BT_BK * BT_WLD;  // floats of a staged Wg slab

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((uint32_t)__cvta_generic_to_shared(p))
      : "memory");
}

// cvt.rna.tf32.f32 of a finite a by integer ops (round half away from
// zero at bit 13), without the conversion's non-finite checks.
__device__ __forceinline__ uint32_t rna_finite(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
}

// Wg's B-operand parts: hi = rna(a), lo = a - hi (exact) handed to the
// tensor core raw: it keeps lo's top bits (|lo| <= 2^-11 |a|), so the
// product misses a * b by at most 2^-21 |a b|, and lo's sign follows a's
// residue, so no bias.
__device__ __forceinline__ void split_b(float a, uint32_t& hi,
                                        uint32_t& lo) {
  hi = rna_finite(a);
  lo = __float_as_uint(a - __uint_as_float(hi));
}

template <bool NOISE, bool XBF>
__global__ void __launch_bounds__(THREADS, BT_BLOCKS)
cim_decode_batched_kernel(const void* __restrict__ x_all,
                          const float* __restrict__ wf_all,
                          long long wstride,
                          const float* __restrict__ scale_all,
                          const int32_t* __restrict__ reps,
                          const int32_t* __restrict__ tags,
                          float* __restrict__ out_all, Geom g, Noise e) {
  constexpr int BN = BT_BN, BK = BT_BK, WLD = BT_WLD, XLD = BT_XLD;
  constexpr int ST = BT_SMEM_W + BT_SMEM_X;    // floats of a ring stage
  constexpr int xes = XBF ? 2 : 4;             // bytes a value of x
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* xsp = ring + BT_STAGES * ST;     // [2 buf][hi, lo][16][XLD]
  float* part = xsp + 4 * BT_SMEM_X;      // [16][BN] (a split of I)

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int S = g.gy;
  const int rank = S > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int c0 = blockIdx.x / S, nc = gridDim.x / S;
  const int n_tiles = (g.N + BN - 1) / BN, n_items = g.gz * n_tiles;
  const int n_slabs = (g.I + BK - 1) / BK;
  const int s0 = n_slabs * rank / S, ns = n_slabs * (rank + 1) / S - s0;
  const int items = c0 < n_items ? (n_items - c0 + nc - 1) / nc : 0;
  const int Q = ns > 0 ? items * ns : 0;
  const bool xvec = g.I % (16 / xes) == 0 &&
                    (reinterpret_cast<uintptr_t>(x_all) & 15) == 0;

  // Wg rows and columns of this thread's staging: rows wr + 8 it, the 4
  // columns from wc; its 16 bytes of x's staging (vector rows), if any.
  const int wr = tid / (BN / 4), wc = 4 * (tid % (BN / 4));
  constexpr int CH = BK * xes / 16;       // 16-byte pieces of an x row
  const int xsm = tid / CH, xsc = (tid % CH) * (16 / xes);
  const bool xs_on = xvec && xsm < g.M;

  // A place in the block's sequence of slabs: slab s of item w (member
  // z, repeat rep, first column nb), first row of I k0, and this thread's
  // first Wg and x source of the slab; a division and the member's loads
  // an item only.
  struct Cursor {
    int q, s, w, z, nb, k0;
    const float* src;
    const char* xsrc;
    uint32_t tag;
    float nz;
  };
  const char* x_bytes = reinterpret_cast<const char*>(x_all);
  auto locate = [&](Cursor& c) {
    c.z = c.w / n_tiles;
    c.nb = (c.w - c.z * n_tiles) * BN;
    c.k0 = s0 * BK;
    if (c.w >= n_items) return;
    const int rep = __ldg(reps + c.z);
    c.src = wf_all + (size_t)rep * wstride + (size_t)(c.k0 + wr) * g.ld +
            c.nb + wc;
    c.xsrc = x_bytes +
             (((size_t)c.z * g.M + xsm) * g.I + c.k0 + xsc) * xes;
    if constexpr (NOISE) {
      c.tag = (uint32_t)__ldg(tags + c.z);
      c.nz = __fmul_rn(e.nsig, __ldg(scale_all + rep));
    }
  };
  const size_t slab_ld = (size_t)BK * g.ld;
  auto step = [&](Cursor& c) {
    ++c.q;
    c.k0 += BK;
    c.src += slab_ld;
    c.xsrc += BK * xes;
    if (++c.s == ns) {
      c.s = 0;
      c.w += nc;
      locate(c);
    }
  };
  Cursor cs = {0, 0, c0, 0, 0, 0, wf_all, x_bytes, 0u, 0.0f};
  locate(cs);                              // the next slab staged
  Cursor cp = cs, cm = cs;                 // the next prepared, multiplied
  auto stage_of = [&](int q) { return ring + (q % BT_STAGES) * ST; };

  // The slab at ``cs`` into its ring slot: Wg rows past I and columns past
  // ld as zeros (stored, visible after the barrier that precedes their
  // use), x's M rows; one commit group, empty past the last slab.
  const size_t ld8 = (size_t)8 * g.ld;
  auto stage = [&]() {
    if (cs.q < Q) {
      float* ws = stage_of(cs.q);
      const int rows = cs.nb + wc < g.ld ? g.I - cs.k0 - wr : 0;
      const float* src = cs.src;
#pragma unroll
      for (int it = 0; it < BK * BN / 4 / THREADS; ++it) {
        float* dst = ws + (wr + 8 * it) * WLD + wc;
        if (8 * it < rows)
          tf32::cp_async16(dst, src, 16);
        else
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
        src += ld8;
      }
      char* xst = reinterpret_cast<char*>(ws + BT_SMEM_W);
      if (xs_on) {
        const bool ok = cs.k0 + xsc < g.I;
        tf32::cp_async16(xst + xsm * XLD * 4 + xsc * xes,
                         ok ? cs.xsrc : x_bytes, ok ? 16 : 0);
      } else if (!xvec) {
        const char* xg = x_bytes + (size_t)cs.z * g.M * g.I * xes;
        for (int qq = tid; qq < g.M * BK; qq += THREADS) {
          const int m = qq / BK, c = qq % BK;
          const bool ok = cs.k0 + c < g.I;
          const size_t at = (size_t)m * g.I + cs.k0 + c;
          if constexpr (XBF) {    // rows of odd length: plain loads
            reinterpret_cast<__nv_bfloat16*>(xst + m * XLD * 4)[c] =
                ok ? reinterpret_cast<const __nv_bfloat16*>(xg)[at]
                   : __float2bfloat16_rn(0.0f);
          } else {
            tf32::cp_async4(xst + (m * XLD + c) * 4, ok ? xg + at * 4 : xg,
                            ok ? 4 : 0);
          }
        }
      }
    }
    tf32::cp_async_commit();
    step(cs);
  };

  // The slab at ``cp``, landed: its x split into TF32 hi / lo parts of
  // buffer q & 1 (two values a thread; rows past M zero; bf16 x: hi
  // only, exact) and (NOISE) its member's noise added to its Wg in place.
  const int xm = tid / (BK / 2), xc = 2 * (tid % (BK / 2));
  auto prepare = [&]() {
    float* ws = stage_of(cp.q);
    float* xh = xsp + (cp.q & 1) * 2 * BT_SMEM_X;
    const char* xst =
        reinterpret_cast<const char*>(ws + BT_SMEM_W) + xm * XLD * 4;
    float2 v = make_float2(0.f, 0.f);
    if (xm < g.M) {
      if constexpr (XBF) {
        const uint32_t raw = *reinterpret_cast<const uint32_t*>(xst + xc * 2);
        v = make_float2(__uint_as_float(raw << 16),
                        __uint_as_float(raw & 0xFFFF0000u));
      } else {
        v = *reinterpret_cast<const float2*>(xst + xc * 4);
      }
    }
    uint2 hi, lo;
    tf32::split(v.x, hi.x, lo.x);
    tf32::split(v.y, hi.y, lo.y);
    *reinterpret_cast<uint2*>(xh + xm * XLD + xc) = hi;
    if constexpr (!XBF)
      *reinterpret_cast<uint2*>(xh + BT_SMEM_X + xm * XLD + xc) = lo;
    if constexpr (NOISE) {
      // Rows past I draw too (no branch between the draws): their Wg and
      // x are zero.
#pragma unroll
      for (int it = 0; it < BK * BN / 4 / THREADS; ++it) {
        float zz[4];
        philox_normal4_tag(e, cp.tag, (uint32_t)(cp.k0 + wr + 8 * it),
                           (uint32_t)(cp.nb + wc) >> 2, zz);
        float4* p = reinterpret_cast<float4*>(ws + (wr + 8 * it) * WLD + wc);
        *p = add_noise(*p, cp.nz, zz);
      }
    }
    step(cp);
  };

  // The slab at ``cm``'s products added to d: 4 k steps of 8, each an A
  // fragment of x by ldmatrix and the warp's two B fragments of Wg; the
  // even and odd k steps in two accumulators (two shorter chains of
  // dependent mma), added at the end.
  const int a_off = (lane % 8 + 8 * (lane / 8 % 2)) * XLD + 4 * (lane / 16);
  const int b_off = tq * WLD + 16 * warp + gq;
  auto product = [&](float (&d)[2][4]) {
    float d2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const float* ws = stage_of(cm.q) + b_off;
    const float* xh = xsp + (cm.q & 1) * 2 * BT_SMEM_X + a_off;
#pragma unroll
    for (int k8 = 0; k8 < BK / 8; ++k8) {
      uint32_t ah[4], al[4];
      ldsm_x4(ah, xh + 8 * k8);
      if constexpr (!XBF) ldsm_x4(al, xh + BT_SMEM_X + 8 * k8);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float* wp = ws + 8 * k8 * WLD + 8 * j;
        uint32_t bh[2], bl[2];
        split_b(wp[0], bh[0], bl[0]);
        split_b(wp[4 * WLD], bh[1], bl[1]);
        float (&dd)[4] = k8 & 1 ? d2[j] : d[j];
        tf32::mma(dd, ah, bl);
        if constexpr (!XBF) tf32::mma(dd, al, bh);
        tf32::mma(dd, ah, bh);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) d[j][u] = __fadd_rn(d[j][u], d2[j][u]);
  };

  // The item at ``cm``'s sums: stored (a cluster of 1), or merged over
  // the cluster's ranks in order, rank r adding the elements r * 256 +
  // tid (mod gy * 256) of the 16 x BN tile.  acc[j][u] is row gq + 8 (u /
  // 2), column 16 warp + 8 j + 2 tq + u % 2 of the tile.
  auto finish = [&](const float (&acc)[2][4]) {
    float* out = out_all + (size_t)cm.z * g.M * g.N;
    if (S == 1) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int m = gq + 8 * (u / 2);
          const int n = cm.nb + 16 * warp + 8 * j + 2 * tq + u % 2;
          if (m < g.M && n < g.N) out[(size_t)m * g.N + n] = acc[j][u];
        }
      return;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        part[(gq + 8 * (u / 2)) * BN + 16 * warp + 8 * j + 2 * tq + u % 2] =
            acc[j][u];
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    for (int q = rank * THREADS + tid; q < 16 * BN; q += S * THREADS) {
      const int m = q / BN, n = cm.nb + q % BN;
      if (m >= g.M || n >= g.N) continue;
      float v = *cluster.map_shared_rank(part + q, 0);
      for (int r = 1; r < S; ++r) v += *cluster.map_shared_rank(part + q, r);
      out[(size_t)m * g.N + n] = v;
    }
    cluster.sync();   // no block reuses its part while another reads it
  };

  for (int q = 0; q < BT_STAGES - 1; ++q) stage();
  tf32::cp_async_wait<BT_STAGES - 2>();
  __syncthreads();                        // slab 0 has landed
  if (Q > 0) prepare();
  tf32::cp_async_wait<BT_STAGES - 3>();   // slab 1 has landed
  __syncthreads();

  float acc[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[j][u] = 0.0f;
  for (int q = 0; q < Q; ++q) {
    stage();                              // into slab q - 1's slot
    float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    product(d);
    // No branch between the products and the next slab's noise, so the
    // two interleave: past the last slab, prepare works on a free ring
    // slot and x buffer that no product reads.
    prepare();
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[j][u] = __fadd_rn(acc[j][u], d[j][u]);
    if (cm.s == ns - 1) {
      finish(acc);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[j][u] = 0.0f;
    }
    step(cm);
    tf32::cp_async_wait<BT_STAGES - 3>();   // slab q + 2 has landed
    __syncthreads();
  }
  tf32::cp_async_wait<0>();
}

// --------------------------------------------------------------- grouped

// The grouped forms: the counterpart of the reference's jax.vmap(cim_mvm)
// over the expert axis of an MoE bank (src/repro/models/moe.py::
// _expert_mm over kernel.py::cim_mvm_pallas).  A deployment stacked over
// E experts (codes (E, I_pad, N_pad), pos (E, I_pad, N_tiles), scale (E,))
// and x (A, I) sorted by expert: expert e owns the rows [offsets[e],
// min(offsets[e+1], offsets[e] + cap)) of x and y (cap = geom M), and y
// rows = x rows @ W'_e.  The offsets stay on the device (no host sync for
// the routing's counts); the grid comes from the host-known cap and the
// assignments, and a block reads its expert from the offsets and returns
// before it reads a weight if it has none, so an expert no token chose
// reads none of its weights.  Every sum runs in a fixed order and nothing
// is atomic: two calls give bit-identical results.  ops.py::
// grouped_geometry picks the form from cap:
//
// * the decode form (cap <= GROUPED_DECODE_MAX_CAP; a few rows an
//   expert): bound by bytes, 2.5 a weight of every hit expert (qwen2-moe's
//   decode gate call, 16 rows on 14 experts of 2048x1408: 101 MB, 0.030
//   ms at 3.35 TB/s).  Replaces the general form on the 16-byte path,
//   whose blocks (32 rows of an expert by 128 columns, all of I) left
//   ~1.2 a SM busy at decode with one 32-row slab in flight each, and
//   expanded each slab into shared memory for the one warp with rows.
//   Measured on the H100 (PERF.md): ~53% of that bound, with ~100 KB in
//   flight a SM; cutting a fifth of the expansion's instructions did not
//   move it.
// * the prefill form (larger cap; ~34 rows an expert at qwen2-moe's
//   prefill): bound by bytes once the products run on tensor cores
//   (0.135 ms for all 60 experts at 3.35 TB/s, against 0.048 ms of TF32
//   products and 0.18 ms of CUDA-core f32 FMAs).  Measured: ~35% of it,
//   bound by instruction issue at 16 warps a SM (PERF.md splits it: the
//   expansion ~30% of the time, the products ~20%, the staging, waits
//   and adds the rest).
// * the general form (cim_grouped_kernel: any wpt, unaligned codes),
//   the first, CUDA-core form of this bank matmul, kept for the ragged
//   spec.
//
// Slots.  Grid z counts expert slots, min(E, A): slot z computes the
// z-th expert, in ascending order, that has a row, so the launch does not
// carry a block for each of the E experts when few are hit.  Each warp
// finds it from the offsets with two ballots a 32 experts, no barrier.
__device__ __forceinline__ int slot_expert(const int32_t* __restrict__ offsets,
                                           int experts, int cap, int z,
                                           int& a0, int& rows) {
  const int lane = threadIdx.x % 32;
  for (int base = 0; base < experts; base += 32) {
    const int e = base + lane;
    int a = 0, n = 0;
    if (e < experts) {
      a = __ldg(offsets + e);
      n = min(__ldg(offsets + e + 1) - a, cap);
    }
    const unsigned has = __ballot_sync(0xFFFFFFFFu, n > 0);
    const int cnt = __popc(has);
    if (z < cnt) {
      const bool me = n > 0 && __popc(has & ((1u << lane) - 1u)) == z;
      const int src = __ffs(__ballot_sync(0xFFFFFFFFu, me)) - 1;
      a0 = __shfl_sync(0xFFFFFFFFu, a, src);
      rows = __shfl_sync(0xFFFFFFFFu, n, src);
      return base + src;
    }
    z -= cnt;
  }
  return -1;
}

// One code of a packed 32-bit pair: the low (q even) or high int16.
__device__ __forceinline__ int code_of(uint32_t pair, int q) {
  return q & 1 ? (int)pair >> 16 : (int)(int16_t)(pair & 0xFFFFu);
}

// The decode form.  A cluster of gy blocks splits the n_slabs slabs of I
// (GD_BK rows each) of one (expert, 128-column) item, rank r the slabs
// [n_slabs r / gy, n_slabs (r + 1) / gy), so qwen2-moe's ~154 items at
// decode run ~1,200 blocks, ~9 a SM.  No W' ever goes to shared memory:
// thread t owns the 8 columns 8 (t % 16) of the item and the rows t / 16,
// t / 16 + 16, ... of its rank, and expands its 8 weights of a row in
// registers from one 16-byte code load and one pos word (one row factor
// for the 8; the eta*M1 table, so W' is bit-identical to the plain
// version's), then FMAs them against the expert's rows of x, staged once
// a pass in shared memory and read as broadcasts.  Its codes and pos
// stream through a ring of GD_STAGES rows in shared memory that the
// thread fills itself by cp.async and reads back itself, so the stream
// has no barrier and GD_STAGES - 1 rows stay in flight a thread (35 KB a
// block, three blocks a SM) without registers.  An expert's row count is
// block-uniform but known only on the device: a pass takes up to GD_RB
// rows in registers, R = 1, 2 or 4 of them (compile-time accumulators),
// and an expert with more rows takes more passes.  A pass sums its 16
// row slices in slice order through shared memory, then the cluster's
// ranks in rank order through distributed shared memory.
constexpr int GD_COLS = GD_BN / 8;        // threads across an item's columns
constexpr int GD_SLICES = THREADS / GD_COLS;   // row slices of a block

template <int R>
__device__ __forceinline__ void grouped_decode_pass(
    const int16_t* __restrict__ ce, const int32_t* __restrict__ pe,
    char* ring, const float* table, const float* xs, float* part,
    float* __restrict__ out, const Geom& g, int nb, int k_lo, int k_hi,
    int row0, int rc, float scale, float eta) {
  const int tid = threadIdx.x, sl = tid / GD_COLS;
  const int n0 = nb + 8 * (tid % GD_COLS);
  const bool col_ok = n0 < g.n_pad;
  const float unit = ldexpf(1.0f, -g.n_bits);
  const float* tab[8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
    tab[q] = table_row(table, n0 % g.wpt + q, g.n_bits);
  // The thread's ring: GD_STAGES slots of its 16 code bytes and its pos
  // word, [slot][thread].
  int4* rcode = reinterpret_cast<int4*>(ring);
  int* rpos = reinterpret_cast<int*>(ring + GD_STAGES * THREADS * 16);
  const int nj = col_ok && k_lo + sl < k_hi
                     ? (k_hi - k_lo - sl + GD_SLICES - 1) / GD_SLICES
                     : 0;
  // Row j of the thread (i = k_lo + sl + 16 j) into slot j % GD_STAGES;
  // one commit group, empty past its last row.
  auto issue = [&](int j) {
    if (j < nj) {
      const int i = k_lo + sl + GD_SLICES * j, s = j % GD_STAGES;
      tf32::cp_async16(rcode + s * THREADS + tid,
                       ce + (size_t)i * g.n_pad + n0, 16);
      tf32::cp_async4(rpos + s * THREADS + tid,
                      pe + (size_t)i * g.n_tiles + n0 / g.wpt, 4);
    }
    tf32::cp_async_commit();
  };

  float acc[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = 0.0f;

#pragma unroll
  for (int j = 0; j < GD_STAGES - 1; ++j) issue(j);
  for (int j = 0; j < nj; ++j) {
    tf32::cp_async_wait<GD_STAGES - 2>();   // row j has landed
    issue(j + GD_STAGES - 1);               // into row j - 1's slot
    const int s = j % GD_STAGES;
    const int4 cv = rcode[s * THREADS + tid];
    const float rf = row_factor(rpos[s * THREADS + tid], eta);
    const uint32_t pair[4] = {(uint32_t)cv.x, (uint32_t)cv.y,
                              (uint32_t)cv.z, (uint32_t)cv.w};
    float w[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      w[q] = expand_fast(code_of(pair[q / 2], q), rf, tab[q], unit, scale);
    const float* xr = xs + (sl + GD_SLICES * j) * GD_RB;
    float xv[R];
    if constexpr (R == GD_RB) {
      const float4 v = *reinterpret_cast<const float4*>(xr);
      xv[0] = v.x, xv[1] = v.y, xv[2] = v.z, xv[3] = v.w;
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) xv[r] = xr[r];
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(xv[r], w[q], acc[r][q]);
  }

  // The slices' sums through the ring (every thread is past its stream),
  // [slice][R][GD_BN], added in slice order into ``part`` [R][GD_BN];
  // then the ranks' parts added in rank order, rank r the elements r *
  // 256 + tid (mod gy * 256).
  tf32::cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float4* dst = reinterpret_cast<float4*>(red + (sl * R + r) * GD_BN +
                                            n0 - nb);
    dst[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    dst[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
  }
  __syncthreads();
  for (int q = tid; q < R * GD_BN; q += THREADS) {
    float v = red[q];
#pragma unroll
    for (int k = 1; k < GD_SLICES; ++k) v += red[k * R * GD_BN + q];
    part[q] = v;
  }
  const int S = g.gy;
  if (S == 1) {
    __syncthreads();
    for (int q = tid; q < rc * GD_BN; q += THREADS) {
      const int n = nb + q % GD_BN;
      if (n < g.N) out[(size_t)(row0 + q / GD_BN) * g.N + n] = part[q];
    }
    __syncthreads();   // no pass reuses part or the ring while it is read
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  cluster.sync();
  for (int q = rank * THREADS + tid; q < rc * GD_BN; q += S * THREADS) {
    const int n = nb + q % GD_BN;
    if (n >= g.N) continue;
    float v = *cluster.map_shared_rank(part + q, 0);
    for (int r = 1; r < S; ++r) v += *cluster.map_shared_rank(part + q, r);
    out[(size_t)(row0 + q / GD_BN) * g.N + n] = v;
  }
  cluster.sync();      // no block reuses its part while another reads it
}

// Grid (gx column tiles, gy ranks, gz expert slots) in clusters of (1,
// gy, 1); shared memory: the threads' rings (later the slices' sums), the
// eta*M1 table at off_t, the x slab [rps][GD_RB] at off_p (the rank's
// rows of I, transposed), the part [GD_RB][GD_BN] after it.
__global__ void __launch_bounds__(THREADS, GD_BLOCKS)
cim_grouped_decode_kernel(const void* __restrict__ x,
                          const int16_t* __restrict__ codes,
                          const int32_t* __restrict__ pos,
                          const float* __restrict__ scale_ptr,
                          const int32_t* __restrict__ offsets,
                          float* __restrict__ out, long long cstride,
                          long long pstride, Geom g, float eta) {
  int a0 = 0, rows = 0;
  const int e = slot_expert(offsets, g.experts, g.M, blockIdx.z, a0, rows);
  if (e < 0) return;                     // block-uniform: no row, no read
  extern __shared__ float4 smem4[];
  char* ring = reinterpret_cast<char*>(smem4);
  float* smem = reinterpret_cast<float*>(smem4);
  float* table = smem + g.off_t;
  float* xs = smem + g.off_p;
  float* part = xs + g.rps * GD_RB;
  const int n_slabs = (g.I + GD_BK - 1) / GD_BK;
  const int rank = blockIdx.y, S = g.gy;
  const int k_lo = n_slabs * rank / S * GD_BK;
  const int k_hi = min(n_slabs * (rank + 1) / S * GD_BK, g.I);
  const int span = k_hi - k_lo;
  const int nb = blockIdx.x * GD_BN;
  const int16_t* ce = codes + (size_t)e * cstride;
  const int32_t* pe = pos + (size_t)e * pstride;
  const float scale = scale_ptr[e];
  build_table(table, g.wpt, g.n_bits, g.cols, g.reversed, eta,
              ldexpf(1.0f, -g.n_bits));
  for (int c0 = 0; c0 < rows; c0 += GD_RB) {
    const int rc = min(GD_RB, rows - c0);
    // The pass's rows of x over the rank's rows of I, transposed to
    // [i][row]: coalesced reads along I; zeros past rc.
    for (int q = threadIdx.x; q < GD_RB * span; q += THREADS) {
      const int m = q / span, ii = q % span;
      xs[ii * GD_RB + m] =
          m < rc ? load_x(x, (size_t)(a0 + c0 + m) * g.I + k_lo + ii,
                          g.xbf16)
                 : 0.0f;
    }
    __syncthreads();                     // x and the table are in place
    const int row0 = a0 + c0;
    if (rc > 2)
      grouped_decode_pass<4>(ce, pe, ring, table, xs, part, out, g, nb, k_lo,
                             k_hi, row0, rc, scale, eta);
    else if (rc > 1)
      grouped_decode_pass<2>(ce, pe, ring, table, xs, part, out, g, nb, k_lo,
                             k_hi, row0, rc, scale, eta);
    else
      grouped_decode_pass<1>(ce, pe, ring, table, xs, part, out, g, nb, k_lo,
                             k_hi, row0, rc, scale, eta);
  }
}

// The prefill form.  The product runs transposed, y^T = W'^T x^T, on
// mma.sync m16n8k8 TF32 tensor cores (../tf32_mma.cuh): W'^T is the A
// operand, expanded straight into registers from the staged codes and
// pos (the eta*M1 table: bit-identical W') and split into TF32 hi and lo;
// x^T is the B operand, 8 rows of x a tile, read by ldmatrix straight
// from the staged raw x.  mma.sync, not wgmma: an expert's row count is
// known only on the device and small (~34 at qwen2-moe's prefill), and
// mma.sync's 8-row tiles take it in 16-row steps with B read as it was
// staged, where wgmma would want x re-laid in its core-matrix layout and
// a fixed N (N = 128 at ~34 rows would run ~4x the products); the form is
// bound by the expansion's instructions, not by the tensor cores
// (PERF.md).  bf16 x is exact in TF32 (its lo part is zero): two products
// a product; f32 x three, split in registers.
//
// Block: one expert's 128 columns (8 warps of 16; lane (gq, tq) of warp w
// the two adjacent columns 16w + 2gq and 16w + 2gq + 1 as A-fragment rows
// gq and gq + 8, so one 4-byte code load and one row factor serve two
// weights and each weight is expanded by one thread) by all of its rows
// up to GP_NT * 8 = 128 in one pass, so W' is expanded once an (expert,
// column tile) at qwen2-moe's capacity; an expert with more rows (cap >
// 128) takes more passes.  A pass is specialised at run time by its pairs
// of 8-row tiles, 1, 2, 3, 4 or 8 (up to 16, 32, 48, 64 or 128 rows).  I
// runs in slabs of GP_BK rows through a ring
// of GP_STAGES (codes, pos, raw x) slabs filled by cp.async, GP_STAGES -
// 1 in flight, one barrier a slab; a slab row's 16 pos words come in
// four 16-byte pieces where wpt is 8, into rows of GP_PLD words (the
// lanes of a k step read four rows: no bank conflict).  Where the host
// knows the rows could fill only a few experts (a prefill whose x holds
// 128 rows: one expert at the capacity), a cluster of gy blocks splits
// the slabs of I, rank r the slabs [s r / gy, s (r + 1) / gy), and the
// ranks' sums meet through distributed shared memory, each block adding
// 64 / gy of a thread's 64 outputs over the ranks in order (as the folded
// prefill form does).  The k order inside a k step is free
// as long as A and B agree: with bf16 x, k step rows 2tq and 2tq + 1 are
// the fragments' k = tq and tq + 4, so one ldmatrix word (two bf16 of a
// row of x) gives both B values by a shift and a mask; with f32 x, rows
// tq and tq + 4, as the tensor core's layout has them.  As in the other
// tensor-core forms, the tensor core truncates as it accumulates, so each
// rounding group's products (GP_KS k steps of 8) start from zero and are
// added to the running sums with round-to-nearest adds; the group's A
// fragments stay in registers while the tiles, two at a time, run over
// them.
constexpr int GP_TILES = GP_BN / 8;    // pos words a staged slab row
constexpr int GP_PLD = GP_TILES + 4;   // a staged pos row (words)
constexpr int GP_CLD = GP_BN + 8;      // a staged codes row (int16)
constexpr int GP_XLD = GP_BK + 4;      // a staged f32 x row (floats)
constexpr int GP_XLDB = GP_BK + 8;     // a staged bf16 x row
constexpr int GP_ROWS = GP_NT * 8;     // rows of x a pass

template <bool XBF>
struct GpLayout {
  static constexpr int CODES = GP_BK * GP_CLD * 2;          // bytes
  static constexpr int POS = GP_BK * GP_PLD * 4;
  static constexpr int XROW = XBF ? GP_XLDB * 2 : GP_XLD * 4;
  static constexpr int STAGE = CODES + POS + GP_ROWS * XROW;
  // A split's partial sums, [4 GP_NT][THREADS], in the ring.
  static_assert(GP_STAGES * STAGE >= 4 * GP_NT * THREADS * 4,
                "the ring holds a split's sums");
};

static_assert(GP_KS == 2, "a bf16 ldmatrix word holds two k steps");

template <bool XBF>
__global__ void __launch_bounds__(THREADS, XBF ? 2 : 1)
cim_grouped_prefill_kernel(const void* __restrict__ x,
                           const int16_t* __restrict__ codes,
                           const int32_t* __restrict__ pos,
                           const float* __restrict__ scale_ptr,
                           const int32_t* __restrict__ offsets,
                           float* __restrict__ out, long long cstride,
                           long long pstride, Geom g, float eta) {
  using L = GpLayout<XBF>;
  constexpr int xes = XBF ? 2 : 4;             // bytes a value of x
  int a0 = 0, rows = 0;
  const int e = slot_expert(offsets, g.experts, g.M, blockIdx.z, a0, rows);
  if (e < 0) return;                     // block-uniform: no row, no read
  extern __shared__ float4 smem4[];
  char* ring = reinterpret_cast<char*>(smem4);
  float* table = reinterpret_cast<float*>(ring + GP_STAGES * L::STAGE);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int nb = blockIdx.x * GP_BN;
  const int c0 = 16 * warp + 2 * gq;     // the thread's columns c0, c0 + 1
  const int16_t* ce = codes + (size_t)e * cstride;
  const int32_t* pe = pos + (size_t)e * pstride;
  const float scale = scale_ptr[e];
  const float unit = ldexpf(1.0f, -g.n_bits);
  const float* tab0 = table_row(table, (nb + c0) % g.wpt, g.n_bits);
  const float* tab1 = table_row(table, (nb + c0) % g.wpt + 1, g.n_bits);
  const int n_slabs = (g.I + GP_BK - 1) / GP_BK;
  const int S = g.gy, rank = blockIdx.y;
  const int kt0 = n_slabs * rank / S, n_steps = n_slabs * (rank + 1) / S;
  const bool xvec = g.I % (16 / xes) == 0 &&
                    (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool pos16 = g.wpt == 8 && g.n_tiles % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(pe) & 15) == 0;
  const char* xb = reinterpret_cast<const char*>(x);
  // The fragments' k rows of a k step, and this lane's ldmatrix row
  // address in a tile pair (matrix j = lane / 8; bf16: tile j % 2 at k
  // step j / 2; f32: tile j / 2 at k offset 4 (j % 2)).
  const int kr0 = XBF ? 2 * tq : tq, kr1 = XBF ? 2 * tq + 1 : tq + 4;
  const int b_off =
      XBF ? ((lane / 8 % 2) * 8 + lane % 8) * L::XROW + 16 * (lane / 16)
          : ((lane / 16) * 8 + lane % 8) * L::XROW + 16 * (lane / 8 % 2);

  build_table(table, g.wpt, g.n_bits, g.cols, g.reversed, eta, unit);

  // A pass over rows [m0, m0 + rc) of the expert, NP pairs of 8-row tiles
  // (NP a compile-time 1, 2, 3, 4 or 8: no branch between the pairs, so
  // their products interleave).
  auto pass = [&](auto np_c, int m0) {
    constexpr int NP = decltype(np_c)::value;
    const int rc = min(GP_ROWS, rows - m0);
    const int nt = 2 * NP;
    const char* xrow = xb + (size_t)(a0 + m0) * g.I * xes;

    // Slab kt's codes, pos and the pass's rows of x into its ring slot;
    // zeros past I and n_pad (rows of x past rc are left as they are:
    // they reach only outputs that are never stored).  One commit group,
    // empty past the last slab.
    auto stage = [&](int kt) {
      if (kt < n_steps) {
        char* st = ring + (kt % GP_STAGES) * L::STAGE;
        int16_t* cst = reinterpret_cast<int16_t*>(st);
        int32_t* pst = reinterpret_cast<int32_t*>(st + L::CODES);
        char* xst = st + L::CODES + L::POS;
        const int k0 = kt * GP_BK;
#pragma unroll
        for (int it = 0; it < GP_BK * GP_TILES / THREADS; ++it) {
          const int q = tid + it * THREADS, r = q / GP_TILES,
                    c8 = q % GP_TILES;
          const int i = k0 + r, n = nb + 8 * c8;
          const bool ok = i < g.I && n < g.n_pad;
          tf32::cp_async16(cst + r * GP_CLD + 8 * c8,
                           ok ? ce + (size_t)i * g.n_pad + n : ce,
                           ok ? 16 : 0);
          if (!pos16)
            tf32::cp_async4(pst + r * GP_PLD + c8,
                            ok ? pe + (size_t)i * g.n_tiles + n / g.wpt : pe,
                            ok ? 4 : 0);
        }
        if (pos16 && tid < GP_BK * GP_TILES / 4) {
          // Four words a piece, zeros past the row's n_tiles words.
          const int r = tid / (GP_TILES / 4), t4 = 4 * (tid % (GP_TILES / 4));
          const int i = k0 + r, t = nb / 8 + t4;
          const int words = i < g.I ? min(4, max(g.n_tiles - t, 0)) : 0;
          tf32::cp_async16(pst + r * GP_PLD + t4,
                           words ? pe + (size_t)i * g.n_tiles + t : pe,
                           4 * words);
        }
        if (xvec) {
          constexpr int CH = GP_BK * xes / 16;     // 16-byte pieces a row
          for (int q = tid; q < rc * CH; q += THREADS) {
            const int m = q / CH, c = (q % CH) * (16 / xes);
            const bool ok = k0 + c < g.I;
            tf32::cp_async16(xst + m * L::XROW + c * xes,
                             ok ? xrow + ((size_t)m * g.I + k0 + c) * xes
                                : xb,
                             ok ? 16 : 0);
          }
        } else {
          for (int q = tid; q < rc * GP_BK; q += THREADS) {
            const int m = q / GP_BK, c = q % GP_BK;
            const bool ok = k0 + c < g.I;
            const size_t at = (size_t)m * g.I + k0 + c;
            if constexpr (XBF) {      // rows of odd length: plain loads
              reinterpret_cast<__nv_bfloat16*>(xst + m * L::XROW)[c] =
                  ok ? reinterpret_cast<const __nv_bfloat16*>(xrow)[at]
                     : __float2bfloat16_rn(0.0f);
            } else {
              tf32::cp_async4(xst + m * L::XROW + c * 4,
                              ok ? xrow + at * 4 : xb, ok ? 4 : 0);
            }
          }
        }
      }
      tf32::cp_async_commit();
    };

    // The thread's A fragment of k step ks of the slab at ``st``:
    // W'[k][c] for (c, k) = (c0, kr0), (c0 + 1, kr0), (c0, kr1), (c0 + 1,
    // kr1), the k rows of the step.
    auto expand = [&](const char* st, int ks, uint32_t (&ah)[4],
                      uint32_t (&al)[4]) {
      const int16_t* cst = reinterpret_cast<const int16_t*>(st);
      const int32_t* pst = reinterpret_cast<const int32_t*>(st + L::CODES);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 8 * ks + (h ? kr1 : kr0);
        const uint32_t pair =
            *reinterpret_cast<const uint32_t*>(cst + k * GP_CLD + c0);
        const float rf = row_factor(pst[k * GP_PLD + c0 / 8], eta);
        split_b(expand_fast(code_of(pair, 0), rf, tab0, unit, scale),
                ah[2 * h], al[2 * h]);
        split_b(expand_fast(code_of(pair, 1), rf, tab1, unit, scale),
                ah[2 * h + 1], al[2 * h + 1]);
      }
    };

    float acc[2 * NP][4];
#pragma unroll
    for (int t = 0; t < 2 * NP; ++t)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[t][u] = 0.0f;

    for (int kt = kt0; kt < kt0 + GP_STAGES - 1; ++kt) stage(kt);
    for (int kt = kt0; kt < n_steps; ++kt) {
      tf32::cp_async_wait<GP_STAGES - 2>();   // slab kt has landed
      __syncthreads();                        // and slab kt - 1 is done
      stage(kt + GP_STAGES - 1);              // into slab kt - 1's slot
      const char* st = ring + (kt % GP_STAGES) * L::STAGE;
      const char* xh = st + L::CODES + L::POS + b_off;
#pragma unroll
      for (int k0 = 0; k0 < GP_BK / 8; k0 += GP_KS) {
        uint32_t ah[GP_KS][4], al[GP_KS][4];
#pragma unroll
        for (int kk = 0; kk < GP_KS; ++kk) expand(st, k0 + kk, ah[kk], al[kk]);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
          const char* bp = xh + 16 * p * L::XROW;
          if constexpr (XBF) {
            // Tiles 2p, 2p + 1 at k steps k0, k0 + 1: b0 and b1 of each
            // from one word (its two bf16, widened exactly).
            uint32_t r[4];
            ldsm_x4(r, reinterpret_cast<const float*>(bp + 16 * k0));
#pragma unroll
            for (int kk = 0; kk < GP_KS; ++kk) {
              const uint32_t w0 = r[2 * kk], w1 = r[2 * kk + 1];
              const uint32_t b0[2] = {w0 << 16, w0 & 0xFFFF0000u};
              const uint32_t b1[2] = {w1 << 16, w1 & 0xFFFF0000u};
              tf32::mma(d0, al[kk], b0);
              tf32::mma(d1, al[kk], b1);
              tf32::mma(d0, ah[kk], b0);
              tf32::mma(d1, ah[kk], b1);
            }
          } else {
#pragma unroll
            for (int kk = 0; kk < GP_KS; ++kk) {
              uint32_t r[4];
              ldsm_x4(r, reinterpret_cast<const float*>(
                             bp + 32 * (k0 + kk)));
              uint32_t bh0[2], bl0[2], bh1[2], bl1[2];
              split_b(__uint_as_float(r[0]), bh0[0], bl0[0]);
              split_b(__uint_as_float(r[1]), bh0[1], bl0[1]);
              split_b(__uint_as_float(r[2]), bh1[0], bl1[0]);
              split_b(__uint_as_float(r[3]), bh1[1], bl1[1]);
              tf32::mma(d0, ah[kk], bl0);
              tf32::mma(d1, ah[kk], bl1);
              tf32::mma(d0, al[kk], bh0);
              tf32::mma(d1, al[kk], bh1);
              tf32::mma(d0, ah[kk], bh0);
              tf32::mma(d1, ah[kk], bh1);
            }
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc[2 * p][u] = __fadd_rn(acc[2 * p][u], d0[u]);
            acc[2 * p + 1][u] = __fadd_rn(acc[2 * p + 1][u], d1[u]);
          }
        }
      }
    }
    tf32::cp_async_wait<0>();
    __syncthreads();             // a next pass restages only after this one

    // acc[t][u] is D[c][m]: column c0 (u < 2) or c0 + 1, row 8t + 2tq + u
    // % 2 of the pass.
    auto store = [&](int i, float v) {
      const int m = 8 * (i / 4) + 2 * tq + i % 2, n = nb + c0 + i % 4 / 2;
      if (m < rc && n < g.N) out[(size_t)(a0 + m0 + m) * g.N + n] = v;
    };
    if (S == 1) {
#pragma unroll
      for (int t = 0; t < 2 * NP; ++t)
#pragma unroll
        for (int u = 0; u < 4; ++u) store(4 * t + u, acc[t][u]);
      return;
    }
    // The split's partial sums, [4 GP_NT][THREADS] in the (now free) ring;
    // rank r adds outputs [r * 64 / S, (r + 1) * 64 / S) of each thread
    // over the ranks 0 .. S-1 in order.
    cg::cluster_group cluster = cg::this_cluster();
    float* part = reinterpret_cast<float*>(ring);
#pragma unroll
    for (int t = 0; t < 2 * NP; ++t)
#pragma unroll
      for (int u = 0; u < 4; ++u) part[(4 * t + u) * THREADS + tid] = acc[t][u];
    cluster.sync();
    const int share = 4 * GP_NT / S;
    for (int i = rank * share; i < min((rank + 1) * share, 4 * nt); ++i) {
      float v = *cluster.map_shared_rank(part + i * THREADS + tid, 0);
      for (int r = 1; r < S; ++r)
        v += *cluster.map_shared_rank(part + i * THREADS + tid, r);
      store(i, v);
    }
    cluster.sync();   // no block restages or leaves while another reads
  };
  for (int m0 = 0; m0 < rows; m0 += GP_ROWS) {
    switch ((min(GP_ROWS, rows - m0) + 15) / 16) {
      case 1: pass(std::integral_constant<int, 1>{}, m0); break;
      case 2: pass(std::integral_constant<int, 2>{}, m0); break;
      case 3: pass(std::integral_constant<int, 3>{}, m0); break;
      case 4: pass(std::integral_constant<int, 4>{}, m0); break;
      default: pass(std::integral_constant<int, 8>{}, m0); break;
    }
  }
}

// The general form (any wpt and n_pad, codes on any alignment: the
// ragged spec), the simple form the other two replace on the 16-byte
// path: a block BM rows of one expert by BN
// columns, I in slabs of BK rows; a slab of W' (BK x BN) expanded once a
// block into shared memory with expand_row, beside the slab of x
// transposed to [k][m]; the next slab's codes, pos and x loaded into
// registers while this slab's products run (CUDA-core f32 FMAs, the rows
// of I in ascending order, a 4 x 4 tile a thread).  Grid (N / BN, cap /
// BM, E); a warp whose rows lie past the expert's last row skips the
// products.
__global__ void __launch_bounds__(THREADS)
cim_grouped_kernel(const void* __restrict__ x,
                   const int16_t* __restrict__ codes,
                   const int32_t* __restrict__ pos,
                   const float* __restrict__ scale_ptr,
                   const int32_t* __restrict__ offsets,
                   float* __restrict__ out, long long cstride,
                   long long pstride, Geom g, float eta) {
  const int e = blockIdx.z;
  const int a0 = offsets[e];
  const int a1 = min(offsets[e + 1], a0 + g.M);
  const int r0 = a0 + blockIdx.y * GR_BM;
  if (r0 >= a1) return;                  // block-uniform: no row, no read
  const int mrows = min(GR_BM, a1 - r0);

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* xs = smem;                      // [BK][BM] x, transposed
  float* ws = xs + GR_BK * GR_BM;        // [BK][BN] W'
  const int16_t* ce = codes + (size_t)e * cstride;
  const int32_t* pe = pos + (size_t)e * pstride;
  const float scale = scale_ptr[e];
  const float unit = ldexpf(1.0f, -g.n_bits);
  const int tid = threadIdx.x;
  const int nb = blockIdx.x * GR_BN;
  // Expansion: 8 columns dc.. of the block, slab rows dr and dr + 16.
  const int dc = (tid % 16) * 8, dr = tid / 16;
  const int n0 = nb + dc;
  // x: row xm of the block, slab columns xk .. xk + 3.
  const int xm = tid % GR_BM, xk = (tid / GR_BM) * 4;
  // Products: rows pr .. pr + 3 (one warp a row quad), columns pc .. +3.
  const int pc = (tid % 32) * 4, pr = (tid / 32) * 4;
  const bool active = pr < mrows;

  float xv[4];
  auto load_xs = [&](int k0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + xk + j;
      xv[j] = xm < mrows && k < g.I
                  ? load_x(x, (size_t)(r0 + xm) * g.I + k, g.xbf16)
                  : 0.0f;
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  load_xs(0);
  for (int k0 = 0; k0 < g.I; k0 += GR_BK) {
    __syncthreads();                     // the last slab's products done
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int row = dr + 16 * u, i = k0 + row;
      float w[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + j;
        const bool ok = n < g.n_pad && i < g.I;
        const int code = ok ? ce[(size_t)i * g.n_pad + n] : 0;
        const int p = ok ? pe[(size_t)i * g.n_tiles + n / g.wpt] : 0;
        w[j] = expand_row(code, row_factor(p, eta), (n % g.wpt) * g.n_bits,
                          unit, scale, eta, g.n_bits, g.cols, g.reversed);
      }
      float4* dst = reinterpret_cast<float4*>(ws + row * GR_BN + dc);
      dst[0] = make_float4(w[0], w[1], w[2], w[3]);
      dst[1] = make_float4(w[4], w[5], w[6], w[7]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) xs[(xk + j) * GR_BM + xm] = xv[j];
    __syncthreads();
    if (k0 + GR_BK < g.I) load_xs(k0 + GR_BK);
    if (active) {
#pragma unroll 8
      for (int k = 0; k < GR_BK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(xs + k * GR_BM + pr);
        const float4 b = *reinterpret_cast<const float4*>(ws + k * GR_BN + pc);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (pr + i >= mrows) break;
    float* yr = out + (size_t)(r0 + pr + i) * g.N;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (nb + pc + j < g.N) yr[nb + pc + j] = acc[i][j];
  }
}

// The grouped folded general form (an expert bank on imperfect devices,
// folded at deploy; the first form of this read, kept for shapes the
// decode and prefill forms below refuse and as their yardstick): the
// general form's blocks, products and order, the slab
// of W' taken from expert e's fold (wf + e * wstride, rows of g.ld
// floats) instead of expanded from codes.  With NOISE the read's noise
// is added to the staged slab: eps at key (read_seed, tags[e]) and
// counter (i, n >> 2), i the row of I and n the column of the bank (the
// plain version's read_noise), one Philox call for four consecutive
// columns, amplitude nsig * scale[e].  Blocks of one expert at other row
// tiles draw the same noise: it is a function of (seed, tag, i, n)
// alone.  Grid (N / BN, cap / BM, slots): slot z computes the z-th expert
// that has a row (slot_expert).  The next slab's Wg and x are loaded into
// registers while this slab's products run.
template <bool NOISE, bool XBF>
__global__ void __launch_bounds__(THREADS)
cim_grouped_folded_kernel(const void* __restrict__ x,
                          const float* __restrict__ wf, long long wstride,
                          const float* __restrict__ scale_ptr,
                          const int32_t* __restrict__ tags,
                          const int32_t* __restrict__ offsets,
                          float* __restrict__ out, Geom g, Noise ns) {
  int a0 = 0, rows = 0;
  const int e = slot_expert(offsets, g.experts, g.M, blockIdx.z, a0, rows);
  const int r0 = a0 + blockIdx.y * GR_BM;
  if (e < 0 || r0 >= a0 + rows) return;  // block-uniform: no row, no read
  const int mrows = min(GR_BM, a0 + rows - r0);

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* xs = smem;                      // [BK][BM] x, transposed
  float* ws = xs + GR_BK * GR_BM;        // [BK][BN] W_eff
  const float* we = wf + (size_t)e * wstride;
  const int tid = threadIdx.x;
  const int nb = blockIdx.x * GR_BN;
  // Staging: 8 columns dc.. of the block, slab rows dr and dr + 16.
  const int dc = (tid % 16) * 8, dr = tid / 16;
  const int n0 = nb + dc;
  const bool col_ok = n0 < g.ld;
  // x: row xm of the block, slab columns xk .. xk + 3.
  const int xm = tid % GR_BM, xk = (tid / GR_BM) * 4;
  // Products: rows pr .. pr + 3 (one warp a row quad), columns pc .. +3.
  const int pc = (tid % 32) * 4, pr = (tid / 32) * 4;
  const bool active = pr < mrows;
  float nz = 0.0f;
  uint32_t tag = 0;
  if constexpr (NOISE) {
    nz = __fmul_rn(ns.nsig, scale_ptr[e]);
    tag = (uint32_t)tags[e];
  }

  float xv[4];
  float4 wv[2][2];
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + xk + j;
      xv[j] = xm < mrows && k < g.I
                  ? load_x(x, (size_t)(r0 + xm) * g.I + k, XBF)
                  : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = k0 + dr + 16 * u;
      const float4* src =
          reinterpret_cast<const float4*>(we + (size_t)i * g.ld + n0);
      const bool ok = col_ok && i < g.I;
      wv[u][0] = ok ? __ldg(src) : make_float4(0.f, 0.f, 0.f, 0.f);
      wv[u][1] = ok ? __ldg(src + 1) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  load(0);
  for (int k0 = 0; k0 < g.I; k0 += GR_BK) {
    __syncthreads();                     // the last slab's products done
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int row = dr + 16 * u, i = k0 + row;
      float4 a = wv[u][0], b = wv[u][1];
      if constexpr (NOISE) {
        if (col_ok && i < g.I) {
          float z[4];
          philox_normal4_tag(ns, tag, (uint32_t)i, (uint32_t)n0 >> 2, z);
          a = add_noise(a, nz, z);
          philox_normal4_tag(ns, tag, (uint32_t)i, (uint32_t)(n0 + 4) >> 2,
                             z);
          b = add_noise(b, nz, z);
        }
      }
      float4* dst = reinterpret_cast<float4*>(ws + row * GR_BN + dc);
      dst[0] = a;
      dst[1] = b;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) xs[(xk + j) * GR_BM + xm] = xv[j];
    __syncthreads();
    if (k0 + GR_BK < g.I) load(k0 + GR_BK);
    if (active) {
#pragma unroll 8
      for (int k = 0; k < GR_BK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(xs + k * GR_BM + pr);
        const float4 b = *reinterpret_cast<const float4*>(ws + k * GR_BN + pc);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (pr + i >= mrows) break;
    float* yr = out + (size_t)(r0 + pr + i) * g.N;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (nb + pc + j < g.N) yr[nb + pc + j] = acc[i][j];
  }
}

// The grouped folded decode form (cap <= GROUPED_FOLDED_DECODE_MAX_CAP in
// ops.py; a few rows an expert): the grouped decode form's design
// (cim_grouped_decode_kernel) over the fold.  Bound by bytes, 4 a weight
// of every hit expert's fold (qwen2-moe's decode gate call, 16 rows on 13
// experts of 2048x1408: 150 MB, 0.045 ms at 3.35 TB/s); the first form
// (cim_grouped_folded_kernel) ran ~one block a SM there, each streaming a
// 1 MB fold a 32-row slab at a time through registers, two barriers a
// slab: bound by latency.  Here a cluster of gy blocks splits the slabs of
// I (GD_BK rows each) of one (expert, 128-column) item, rank r the slabs
// [s r / gy, s (r + 1) / gy).  Thread t owns the two 4-column pieces
// from 4 (t % 16) and 64 + 4 (t % 16) of the item and the rows t / 16 +
// 16 j of its rank, so each 16-byte cp.async of a warp reads 256
// contiguous bytes of a row (cp.async bypasses L1: with a thread's 8
// neighbouring columns each instruction would take half of every 32-byte
// sector, and the sector would cross from L2 twice); a row's two pieces
// stream through a ring of GFD_STAGES rows in shared memory that the
// thread fills by cp.async and reads back itself (no barrier in the
// stream, GFD_STAGES - 1 rows in flight a thread without registers).
// With NOISE the row's noise is drawn in registers: one Philox call a
// piece, at counter (i, n >> 2) of the piece's first column n, every
// normal used, each weight's noise once a pass, added in the plain
// version's order (add_noise).  CUDA-core FMAs take
// the 8 weights against the pass's rows of x, staged once a pass in
// shared memory and read as broadcasts.  A pass takes up to GD_RB rows of
// the expert, R = 1, 2 or 4 in registers; an expert with more rows takes
// more passes and draws its noise again.  The sums: the 16 row slices in
// slice order through shared memory, then the ranks in rank order through
// distributed shared memory, so two calls give bit-identical results.
// Measured on the H100 (PERF.md, row 1h): ~63% of the byte bound with
// noise at qwen2-moe's decode gate call; a split of 4 (ops.py) on a
// 4-row ring at 3 blocks a SM came within ~4% of the best split, ring and
// occupancy in every noisy case swept.
constexpr int GFD_RING = GFD_STAGES * THREADS * 32;   // bytes of the rings
static_assert(GFD_RING >= GD_SLICES * GD_RB * GD_BN * 4,
              "the rings hold the slices' sums");

template <int R, bool NOISE>
__device__ __forceinline__ void grouped_folded_decode_pass(
    const float* __restrict__ we, float4* ring, const float* xs, float* part,
    float* __restrict__ out, const Geom& g, int nb, int k_lo, int k_hi,
    int row0, int rc, uint32_t tag, float nz, const Noise& ns) {
  const int tid = threadIdx.x, sl = tid / GD_COLS;
  // The thread's pieces: columns c0 .. c0 + 3 and c1 .. c1 + 3 of the
  // item; the second past ld (a ragged last tile) reads zeros, no noise.
  const int c0 = 4 * (tid % GD_COLS), c1 = GD_BN / 2 + c0;
  const bool on1 = nb + c1 < g.ld;
  const int nj = nb + c0 < g.ld && k_lo + sl < k_hi
                     ? (k_hi - k_lo - sl + GD_SLICES - 1) / GD_SLICES
                     : 0;
  // Row j of the thread (i = k_lo + sl + 16 j) into slot j % GFD_STAGES of
  // its ring ([slot][piece][thread] float4s); one commit group, empty
  // past its last row.
  const float* src = we + (size_t)(k_lo + sl) * g.ld + nb + c0;
  const size_t row_step = (size_t)GD_SLICES * g.ld;
  auto issue = [&](int j) {
    if (j < nj) {
      float4* dst = ring + (j % GFD_STAGES) * 2 * THREADS + tid;
      const float* s = src + j * row_step;
      tf32::cp_async16(dst, s, 16);
      tf32::cp_async16(dst + THREADS, on1 ? s + GD_BN / 2 : s, on1 ? 16 : 0);
    }
    tf32::cp_async_commit();
  };

  float acc[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = 0.0f;

#pragma unroll
  for (int j = 0; j < GFD_STAGES - 1; ++j) issue(j);
  for (int j = 0; j < nj; ++j) {
    tf32::cp_async_wait<GFD_STAGES - 2>();   // row j has landed
    issue(j + GFD_STAGES - 1);               // into row j - 1's slot
    const float4* slot = ring + (j % GFD_STAGES) * 2 * THREADS + tid;
    float4 a = slot[0], b = slot[THREADS];
    if constexpr (NOISE) {
      const uint32_t i = (uint32_t)(k_lo + sl + GD_SLICES * j);
      float z[4];
      philox_normal4_tag(ns, tag, i, (uint32_t)(nb + c0) >> 2, z);
      a = add_noise(a, nz, z);
      if (on1) {
        philox_normal4_tag(ns, tag, i, (uint32_t)(nb + c1) >> 2, z);
        b = add_noise(b, nz, z);
      }
    }
    const float w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    const float* xr = xs + (sl + GD_SLICES * j) * GD_RB;
    float xv[R];
    if constexpr (R == GD_RB) {
      const float4 v = *reinterpret_cast<const float4*>(xr);
      xv[0] = v.x, xv[1] = v.y, xv[2] = v.z, xv[3] = v.w;
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) xv[r] = xr[r];
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(xv[r], w[q], acc[r][q]);
  }

  // The slices' sums through the rings (every thread is past its stream),
  // [slice][R][GD_BN], added in slice order into ``part`` [R][GD_BN]; then
  // the ranks' parts added in rank order, rank r the elements r * 256 +
  // tid (mod gy * 256).
  tf32::cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float* row = red + (sl * R + r) * GD_BN;
    *reinterpret_cast<float4*>(row + c0) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    *reinterpret_cast<float4*>(row + c1) =
        make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
  }
  __syncthreads();
  for (int q = tid; q < R * GD_BN; q += THREADS) {
    float v = red[q];
#pragma unroll
    for (int k = 1; k < GD_SLICES; ++k) v += red[k * R * GD_BN + q];
    part[q] = v;
  }
  const int S = g.gy;
  if (S == 1) {
    __syncthreads();
    for (int q = tid; q < rc * GD_BN; q += THREADS) {
      const int n = nb + q % GD_BN;
      if (n < g.N) out[(size_t)(row0 + q / GD_BN) * g.N + n] = part[q];
    }
    __syncthreads();   // no pass reuses part or the rings while it is read
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  cluster.sync();
  for (int q = rank * THREADS + tid; q < rc * GD_BN; q += S * THREADS) {
    const int n = nb + q % GD_BN;
    if (n >= g.N) continue;
    float v = *cluster.map_shared_rank(part + q, 0);
    for (int r = 1; r < S; ++r) v += *cluster.map_shared_rank(part + q, r);
    out[(size_t)(row0 + q / GD_BN) * g.N + n] = v;
  }
  cluster.sync();      // no block reuses its part while another reads it
}

// Grid (gx column tiles, gy ranks, gz expert slots) in clusters of (1,
// gy, 1); shared memory: the threads' rings (later the slices' sums), the
// x slab [rps][GD_RB] at off_p (the rank's rows of I, transposed), the
// part [GD_RB][GD_BN] after it.
template <bool NOISE, bool XBF>
__global__ void __launch_bounds__(THREADS, GFD_BLOCKS)
cim_grouped_folded_decode_kernel(const void* __restrict__ x,
                                 const float* __restrict__ wf,
                                 long long wstride,
                                 const float* __restrict__ scale_ptr,
                                 const int32_t* __restrict__ tags,
                                 const int32_t* __restrict__ offsets,
                                 float* __restrict__ out, Geom g, Noise ns) {
  int a0 = 0, rows = 0;
  const int e = slot_expert(offsets, g.experts, g.M, blockIdx.z, a0, rows);
  if (e < 0) return;                     // block-uniform: no row, no read
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4) + g.off_p;
  float* part = xs + g.rps * GD_RB;
  const int n_slabs = (g.I + GD_BK - 1) / GD_BK;
  const int rank = blockIdx.y, S = g.gy;
  const int k_lo = n_slabs * rank / S * GD_BK;
  const int k_hi = min(n_slabs * (rank + 1) / S * GD_BK, g.I);
  const int span = k_hi - k_lo;
  const int nb = blockIdx.x * GD_BN;
  const float* we = wf + (size_t)e * wstride;
  float nz = 0.0f;
  uint32_t tag = 0;
  if constexpr (NOISE) {
    nz = __fmul_rn(ns.nsig, scale_ptr[e]);
    tag = (uint32_t)tags[e];
  }
  for (int c0 = 0; c0 < rows; c0 += GD_RB) {
    const int rc = min(GD_RB, rows - c0);
    // The pass's rows of x over the rank's rows of I, transposed to
    // [i][row]: coalesced reads along I; zeros past rc.
    for (int q = threadIdx.x; q < GD_RB * span; q += THREADS) {
      const int m = q / span, ii = q % span;
      xs[ii * GD_RB + m] =
          m < rc ? load_x(x, (size_t)(a0 + c0 + m) * g.I + k_lo + ii, XBF)
                 : 0.0f;
    }
    __syncthreads();                     // x is in place
    const int row0 = a0 + c0;
    if (rc > 2)
      grouped_folded_decode_pass<4, NOISE>(we, smem4, xs, part, out, g, nb,
                                           k_lo, k_hi, row0, rc, tag, nz, ns);
    else if (rc > 1)
      grouped_folded_decode_pass<2, NOISE>(we, smem4, xs, part, out, g, nb,
                                           k_lo, k_hi, row0, rc, tag, nz, ns);
    else
      grouped_folded_decode_pass<1, NOISE>(we, smem4, xs, part, out, g, nb,
                                           k_lo, k_hi, row0, rc, tag, nz, ns);
  }
}

// The grouped folded prefill form (larger cap; ~34 rows an expert at
// qwen2-moe's prefill): the grouped prefill form's design
// (cim_grouped_prefill_kernel) over the fold.  Bound by bytes once the
// products run on tensor cores and the noise is drawn once a weight
// (qwen2-moe's prefill gate call, 60 experts: 0.21 ms of bytes at 3.35
// TB/s, against 0.048 ms of TF32 products and 0.058 ms of noise on the
// f32 pipe); the first form read an expert's fold and drew its noise once
// for every 32-row tile of its rows, with CUDA-core FMAs.  A block takes
// one (expert, 128-column) item and all of the expert's rows, up to
// GP_ROWS a pass (so at qwen2-moe's capacity the fold is read and its
// noise drawn once a call); I runs in GP_BK-row slabs through a ring of
// GFP_STAGES (Wg slab, raw x) stages filled by 16-byte cp.async.  With
// NOISE each slab, once landed, gets the read's noise in place, in the
// plain version's order (add_noise): a thread four neighbouring columns
// of a row from one Philox call at counter (i, n >> 2), four rows a slab,
// while the products of the slab before run (one barrier a slab); only
// then are its A fragments read.  The products run transposed, y^T = Wg^T
// x^T, on mma.sync m16n8k8: lane (gq, tq) of warp w reads columns 16w +
// 2gq and 16w + 2gq + 1 of the k step's rows kr0 and kr1 as one float2
// each (rows of GFP_WLD floats with f32 x, GFP_WLDB with bf16 x: the k
// rows of a step fall on distinct banks) and splits them into TF32 hi and
// lo (split_b); x^T is read by ldmatrix from the staged raw x, with the
// grouped prefill form's k order, tile pairs, rounding groups and split
// of I over a cluster (where few experts can be hit).  bf16 x is exact in
// TF32: two products a product; f32 x three.  Measured on the H100
// (PERF.md, row 1h): ~74% of the byte bound without noise, ~43% with it
// at qwen2-moe's prefill gate call, where the noise's instructions bound
// it.
template <bool XBF>
struct GfpLayout {
  static constexpr int WLD = XBF ? GFP_WLDB : GFP_WLD;     // floats
  static constexpr int WS = GP_BK * WLD * 4;                // bytes
  static constexpr int XROW = XBF ? GP_XLDB * 2 : GP_XLD * 4;
  static constexpr int STAGE = WS + GP_ROWS * XROW;
  // A split's partial sums, [4 GP_NT][THREADS], in the ring.
  static_assert(GFP_STAGES * STAGE >= 4 * GP_NT * THREADS * 4,
                "the ring holds a split's sums");
  static_assert(WS % 16 == 0 && XROW % 16 == 0, "16-byte rows");
};

template <bool NOISE, bool XBF>
__global__ void __launch_bounds__(THREADS, XBF ? 2 : 1)
cim_grouped_folded_prefill_kernel(const void* __restrict__ x,
                                  const float* __restrict__ wf,
                                  long long wstride,
                                  const float* __restrict__ scale_ptr,
                                  const int32_t* __restrict__ tags,
                                  const int32_t* __restrict__ offsets,
                                  float* __restrict__ out, Geom g, Noise ns) {
  using L = GfpLayout<XBF>;
  constexpr int xes = XBF ? 2 : 4;             // bytes a value of x
  constexpr int WLD = L::WLD;
  int a0 = 0, rows = 0;
  const int e = slot_expert(offsets, g.experts, g.M, blockIdx.z, a0, rows);
  if (e < 0) return;                     // block-uniform: no row, no read
  extern __shared__ float4 smem4[];
  char* ring = reinterpret_cast<char*>(smem4);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int nb = blockIdx.x * GP_BN;
  const int c0 = 16 * warp + 2 * gq;     // the thread's columns c0, c0 + 1
  const float* we = wf + (size_t)e * wstride;
  const int n_slabs = (g.I + GP_BK - 1) / GP_BK;
  const int S = g.gy, rank = blockIdx.y;
  const int kt0 = n_slabs * rank / S, n_steps = n_slabs * (rank + 1) / S;
  const bool xvec = g.I % (16 / xes) == 0 &&
                    (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const char* xb = reinterpret_cast<const char*>(x);
  // The thread's staging and noise: slab rows wr + 8 it, the four
  // columns from wc (a whole row a warp).
  const int wr = tid / (GP_BN / 4), wc = 4 * (tid % (GP_BN / 4));
  const bool wcol = nb + wc < g.ld;
  float nz = 0.0f;
  uint32_t tag = 0;
  if constexpr (NOISE) {
    nz = __fmul_rn(ns.nsig, scale_ptr[e]);
    tag = (uint32_t)tags[e];
  }
  // The fragments' k rows of a k step, and this lane's ldmatrix row
  // address in a tile pair (matrix j = lane / 8; bf16: tile j % 2 at k
  // step j / 2; f32: tile j / 2 at k offset 4 (j % 2)).
  const int kr0 = XBF ? 2 * tq : tq, kr1 = XBF ? 2 * tq + 1 : tq + 4;
  const int b_off =
      XBF ? ((lane / 8 % 2) * 8 + lane % 8) * L::XROW + 16 * (lane / 16)
          : ((lane / 16) * 8 + lane % 8) * L::XROW + 16 * (lane / 8 % 2);

  // Slab kt's noise, added in place to its landed Wg (rows of I and
  // columns of the fold only).
  auto noise = [&](int kt) {
    float* ws = reinterpret_cast<float*>(ring + (kt % GFP_STAGES) * L::STAGE);
    const int i0 = kt * GP_BK + wr;
#pragma unroll
    for (int it = 0; it < GP_BK * GP_BN / 4 / THREADS; ++it) {
      if (wcol && i0 + 8 * it < g.I) {
        float z[4];
        philox_normal4_tag(ns, tag, (uint32_t)(i0 + 8 * it),
                           (uint32_t)(nb + wc) >> 2, z);
        float4* p = reinterpret_cast<float4*>(ws + (wr + 8 * it) * WLD + wc);
        *p = add_noise(*p, nz, z);
      }
    }
  };

  // A pass over rows [m0, m0 + rc) of the expert, NP pairs of 8-row tiles
  // (NP a compile-time 1, 2, 3, 4 or 8: no branch between the pairs, so
  // their products interleave).
  auto pass = [&](auto np_c, int m0) {
    constexpr int NP = decltype(np_c)::value;
    const int rc = min(GP_ROWS, rows - m0);
    const int nt = 2 * NP;
    const char* xrow = xb + (size_t)(a0 + m0) * g.I * xes;

    // Slab kt's Wg and the pass's rows of x into its ring slot; zeros
    // past I and ld (rows of x past rc are left as they are: they reach
    // only outputs that are never stored).  One commit group, empty past
    // the last slab.
    auto stage = [&](int kt) {
      if (kt < n_steps) {
        char* st = ring + (kt % GFP_STAGES) * L::STAGE;
        float* ws = reinterpret_cast<float*>(st);
        char* xst = st + L::WS;
        const int k0 = kt * GP_BK;
        const float* src = we + (size_t)(k0 + wr) * g.ld + nb + wc;
#pragma unroll
        for (int it = 0; it < GP_BK * GP_BN / 4 / THREADS; ++it) {
          const bool ok = wcol && k0 + wr + 8 * it < g.I;
          tf32::cp_async16(ws + (wr + 8 * it) * WLD + wc,
                           ok ? src + (size_t)8 * it * g.ld : we,
                           ok ? 16 : 0);
        }
        if (xvec) {
          constexpr int CH = GP_BK * xes / 16;     // 16-byte pieces a row
          for (int q = tid; q < rc * CH; q += THREADS) {
            const int m = q / CH, c = (q % CH) * (16 / xes);
            const bool ok = k0 + c < g.I;
            tf32::cp_async16(xst + m * L::XROW + c * xes,
                             ok ? xrow + ((size_t)m * g.I + k0 + c) * xes
                                : xb,
                             ok ? 16 : 0);
          }
        } else {
          for (int q = tid; q < rc * GP_BK; q += THREADS) {
            const int m = q / GP_BK, c = q % GP_BK;
            const bool ok = k0 + c < g.I;
            const size_t at = (size_t)m * g.I + k0 + c;
            if constexpr (XBF) {      // rows of odd length: plain loads
              reinterpret_cast<__nv_bfloat16*>(xst + m * L::XROW)[c] =
                  ok ? reinterpret_cast<const __nv_bfloat16*>(xrow)[at]
                     : __float2bfloat16_rn(0.0f);
            } else {
              tf32::cp_async4(xst + m * L::XROW + c * 4,
                              ok ? xrow + at * 4 : xb, ok ? 4 : 0);
            }
          }
        }
      }
      tf32::cp_async_commit();
    };

    float acc[2 * NP][4];
#pragma unroll
    for (int t = 0; t < 2 * NP; ++t)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[t][u] = 0.0f;

    for (int kt = kt0; kt < kt0 + GFP_STAGES - 1; ++kt) stage(kt);
    tf32::cp_async_wait<GFP_STAGES - 2>();
    __syncthreads();                           // slab kt0 has landed
    if (NOISE && kt0 < n_steps) noise(kt0);
    tf32::cp_async_wait<GFP_STAGES - 3>();
    __syncthreads();              // slab kt0 + 1 has landed, kt0's noise in
    for (int kt = kt0; kt < n_steps; ++kt) {
      stage(kt + GFP_STAGES - 1);              // into slab kt - 1's slot
      const char* st = ring + (kt % GFP_STAGES) * L::STAGE;
      const float* wa = reinterpret_cast<const float*>(st) + c0;
      const char* xh = st + L::WS + b_off;
#pragma unroll
      for (int k0 = 0; k0 < GP_BK / 8; k0 += GP_KS) {
        // The group's A fragments: W[k][c] for (c, k) = (c0, kr0), (c0 +
        // 1, kr0), (c0, kr1), (c0 + 1, kr1) of each k step.
        uint32_t ah[GP_KS][4], al[GP_KS][4];
#pragma unroll
        for (int kk = 0; kk < GP_KS; ++kk) {
          const int k = 8 * (k0 + kk);
          const float2 v0 =
              *reinterpret_cast<const float2*>(wa + (k + kr0) * WLD);
          const float2 v1 =
              *reinterpret_cast<const float2*>(wa + (k + kr1) * WLD);
          split_b(v0.x, ah[kk][0], al[kk][0]);
          split_b(v0.y, ah[kk][1], al[kk][1]);
          split_b(v1.x, ah[kk][2], al[kk][2]);
          split_b(v1.y, ah[kk][3], al[kk][3]);
        }
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
          const char* bp = xh + 16 * p * L::XROW;
          if constexpr (XBF) {
            // Tiles 2p, 2p + 1 at k steps k0, k0 + 1: b0 and b1 of each
            // from one word (its two bf16, widened exactly).
            uint32_t r[4];
            ldsm_x4(r, reinterpret_cast<const float*>(bp + 16 * k0));
#pragma unroll
            for (int kk = 0; kk < GP_KS; ++kk) {
              const uint32_t w0 = r[2 * kk], w1 = r[2 * kk + 1];
              const uint32_t b0[2] = {w0 << 16, w0 & 0xFFFF0000u};
              const uint32_t b1[2] = {w1 << 16, w1 & 0xFFFF0000u};
              tf32::mma(d0, al[kk], b0);
              tf32::mma(d1, al[kk], b1);
              tf32::mma(d0, ah[kk], b0);
              tf32::mma(d1, ah[kk], b1);
            }
          } else {
#pragma unroll
            for (int kk = 0; kk < GP_KS; ++kk) {
              uint32_t r[4];
              ldsm_x4(r, reinterpret_cast<const float*>(
                             bp + 32 * (k0 + kk)));
              uint32_t bh0[2], bl0[2], bh1[2], bl1[2];
              split_b(__uint_as_float(r[0]), bh0[0], bl0[0]);
              split_b(__uint_as_float(r[1]), bh0[1], bl0[1]);
              split_b(__uint_as_float(r[2]), bh1[0], bl1[0]);
              split_b(__uint_as_float(r[3]), bh1[1], bl1[1]);
              tf32::mma(d0, ah[kk], bl0);
              tf32::mma(d1, ah[kk], bl1);
              tf32::mma(d0, al[kk], bh0);
              tf32::mma(d1, al[kk], bh1);
              tf32::mma(d0, ah[kk], bh0);
              tf32::mma(d1, ah[kk], bh1);
            }
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc[2 * p][u] = __fadd_rn(acc[2 * p][u], d0[u]);
            acc[2 * p + 1][u] = __fadd_rn(acc[2 * p + 1][u], d1[u]);
          }
        }
      }
      // The next slab's noise while other warps run this slab's products:
      // its slot is neither staged into nor read this step.
      if (NOISE && kt + 1 < n_steps) noise(kt + 1);
      tf32::cp_async_wait<GFP_STAGES - 3>();   // slab kt + 2 has landed
      __syncthreads();                         // and kt + 1's noise is in
    }
    tf32::cp_async_wait<0>();
    __syncthreads();             // a next pass restages only after this one

    // acc[t][u] is D[c][m]: column c0 (u < 2) or c0 + 1, row 8t + 2tq + u
    // % 2 of the pass.
    auto store = [&](int i, float v) {
      const int m = 8 * (i / 4) + 2 * tq + i % 2, n = nb + c0 + i % 4 / 2;
      if (m < rc && n < g.N) out[(size_t)(a0 + m0 + m) * g.N + n] = v;
    };
    if (S == 1) {
#pragma unroll
      for (int t = 0; t < 2 * NP; ++t)
#pragma unroll
        for (int u = 0; u < 4; ++u) store(4 * t + u, acc[t][u]);
      return;
    }
    // The split's partial sums, [4 GP_NT][THREADS] in the (now free) ring;
    // rank r adds outputs [r * 64 / S, (r + 1) * 64 / S) of each thread
    // over the ranks 0 .. S-1 in order.
    cg::cluster_group cluster = cg::this_cluster();
    float* part = reinterpret_cast<float*>(ring);
#pragma unroll
    for (int t = 0; t < 2 * NP; ++t)
#pragma unroll
      for (int u = 0; u < 4; ++u) part[(4 * t + u) * THREADS + tid] = acc[t][u];
    cluster.sync();
    const int share = 4 * GP_NT / S;
    for (int i = rank * share; i < min((rank + 1) * share, 4 * nt); ++i) {
      float v = *cluster.map_shared_rank(part + i * THREADS + tid, 0);
      for (int r = 1; r < S; ++r)
        v += *cluster.map_shared_rank(part + i * THREADS + tid, r);
      store(i, v);
    }
    cluster.sync();   // no block restages or leaves while another reads
  };
  for (int m0 = 0; m0 < rows; m0 += GP_ROWS) {
    switch ((min(GP_ROWS, rows - m0) + 15) / 16) {
      case 1: pass(std::integral_constant<int, 1>{}, m0); break;
      case 2: pass(std::integral_constant<int, 2>{}, m0); break;
      case 3: pass(std::integral_constant<int, 3>{}, m0); break;
      case 4: pass(std::integral_constant<int, 4>{}, m0); break;
      default: pass(std::integral_constant<int, 8>{}, m0); break;
    }
  }
}

// --------------------------------------------------------------- prefill

// Both prefill forms: x (the B operand) in shared memory as TF32 hi and
// lo parts in wgmma's K-major core-matrix layout (two buffers), and a
// ring of PF_STAGES staged raw slabs that cp.async fills two slabs ahead.
constexpr int SBO = PF_BK / 4 * 128;   // bytes between 8-row groups
constexpr int PART = PF_BM * PF_BK;    // floats of x's hi or lo part
constexpr int XLD = PF_BK + 4;         // staged x row (floats)
constexpr int XLDB = PF_BK + 8;        // staged bf16 x row

// The product runs transposed, y^T = W'^T x^T: W'^T is wgmma's A operand
// and is expanded straight into registers, x is the B operand in shared
// memory.  Block: 128 columns of W' (two warpgroups of 64) by 128 rows
// of x, all of the block's part of I in slabs of BK = 32 rows.  Shared
// memory holds x's TF32 hi and lo parts (two buffers), the rows' factors
// 1 + eta*p (two buffers), and a ring of PF_STAGES staged raw slabs (x,
// codes, pos) that cp.async fills ahead; after the ring, the eta*M1 table
// (FAST).  A k step of 8: expand the thread's 4 weights of W'^T, split
// them, issue 3 wgmma, and convert a piece of the next slab's x while the
// previous step's products run.  bf16 x is staged as bf16 and widened
// (exactly) when it is split.
//
// The tensor core adds products into its f32 accumulator with
// truncation, not rounding: summed over all of I in the accumulator,
// that bias grows with I and misses the 1e-5 bound at phi3's widths.
// So each slab's products start from zero (the first wgmma of a slab
// overwrites d), and d is added to the running sums with
// round-to-nearest adds.
template <bool FAST>
__global__ void __launch_bounds__(THREADS, 1)
cim_prefill_kernel(const void* __restrict__ x,
                   const int16_t* __restrict__ codes,
                   const int32_t* __restrict__ pos,
                   const float* __restrict__ scale_ptr,
                   float* __restrict__ out, Geom g, float eta) {
  constexpr int BM = PF_BM, BN = PF_BN, BK = PF_BK;
  constexpr int CLD = BN + 8;                  // staged codes row (int16)
  constexpr int TILES = BN / 8;                // pos entries a row (wpt 8)
  constexpr int ST = BM * XLD * 4 + BK * CLD * 2 + BK * TILES * 4;
  extern __shared__ float4 smem4[];
  float* px = reinterpret_cast<float*>(smem4);  // [2 buf][hi, lo][PART]
  float* rowf = px + 4 * PART;                  // [2 buf][BK][TILES]
  char* ring = reinterpret_cast<char*>(rowf + 2 * BK * TILES);
  float* table = reinterpret_cast<float*>(ring + PF_STAGES * ST);
  auto xst_of = [&](int kt) {
    return reinterpret_cast<float*>(ring + (kt % PF_STAGES) * ST);
  };
  auto cst_of = [&](int kt) {
    return reinterpret_cast<int16_t*>(xst_of(kt) + BM * XLD);
  };
  auto pst_of = [&](int kt) {
    return reinterpret_cast<int*>(cst_of(kt) + BK * CLD);
  };
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
  const bool xbf = g.xbf16;
  const bool xvec = xbf ? (g.I % 8 == 0) &&
                              ((reinterpret_cast<uintptr_t>(x) & 15) == 0)
                        : (g.I % 4 == 0) &&
                              ((reinterpret_cast<uintptr_t>(x) & 15) == 0);
  const float* xf = reinterpret_cast<const float*>(x);
  const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(x);

  // Slab kt's raw x, codes and pos into its ring slot: one commit group,
  // empty past the last slab.
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
      if constexpr (FAST) {
        w[q] = expand_fast(code, row, table_row(table, gn % g.wpt, g.n_bits),
                           unit, scale);
      } else {
        w[q] = expand_row(code, row, (gn % g.wpt) * g.n_bits, unit, scale,
                          eta, g.n_bits, g.cols, g.reversed);
      }
      tf32::split(w[q], ah[q], al[q]);
    }
  };

  if (FAST)
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

// The folded prefill form: the prefill form's blocks, x parts and
// per-slab rounding over Wg.  The ring holds slabs of x and of Wg (BK
// rows of PF_WLD floats, 16-byte cp.async); while the products of slab
// kt run, each k step converts a piece of slab kt + 1's x and (NOISE)
// adds a piece of its noise in place, one Philox call a thread for four
// consecutive columns of one slab row (1024 calls a slab); the A
// fragments are then four shared loads and splits a k step.  bf16 x
// (g.xbf16) has no lo part: two wgmma a k step.  Rows past I and
// columns past n_pad stage as zeros; the noise on them meets zero x or
// lands in discarded outputs.  Where the (gx, gy) grid would leave SMs
// idle (few rows of x, or N = 3072), a cluster of S = gz blocks (z) splits
// the slabs of I S ways; their sums meet through distributed shared
// memory, each block adding 64 / S of a thread's 64 outputs over the
// ranks in order (a fixed order: two calls stay bit-identical).
template <bool NOISE>
__global__ void __launch_bounds__(THREADS, 1)
cim_prefill_folded_kernel(const void* __restrict__ x,
                          const float* __restrict__ wf,
                          const float* __restrict__ scale_ptr,
                          float* __restrict__ out, Geom g, Noise e) {
  constexpr int BM = PF_BM, BN = PF_BN, BK = PF_BK;
  constexpr int ST = BM * XLD * 4 + BK * PF_WLD * 4;
  extern __shared__ float4 smem4[];
  float* px = reinterpret_cast<float*>(smem4);  // [2 buf][hi, lo][PART]
  char* ring = reinterpret_cast<char*>(px + 4 * PART);
  auto xst_of = [&](int kt) {
    return reinterpret_cast<float*>(ring + (kt % PF_STAGES) * ST);
  };
  auto wst_of = [&](int kt) { return xst_of(kt) + BM * XLD; };
  auto core = [](int r, int k) {
    return (r >> 3) * (SBO / 4) + (k >> 2) * 32 + (r & 7) * 4 + (k & 3);
  };

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wg = warp / 4, gq = lane / 4, tq = lane % 4;
  const int n_base = blockIdx.x * BN, m_base = blockIdx.y * BM;
  const int c_lo = wg * 64 + (warp % 4) * 16 + gq, c_hi = c_lo + 8;
  const int n_steps = (g.I + BK - 1) / BK;
  const bool xbf = g.xbf16;
  const bool xvec = xbf ? (g.I % 8 == 0) &&
                              ((reinterpret_cast<uintptr_t>(x) & 15) == 0)
                        : (g.I % 4 == 0) &&
                              ((reinterpret_cast<uintptr_t>(x) & 15) == 0);
  const float* xf = reinterpret_cast<const float*>(x);
  const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(x);
  const float nz = __fmul_rn(e.nsig, *scale_ptr);
  // This block's slabs [kt0, kt1) of the split.
  const int S = g.gz, z = blockIdx.z;
  const int kt0 = n_steps * z / S, kt1 = n_steps * (z + 1) / S;

  // Slab kt's raw x and Wg into its ring slot: one commit group, empty
  // past the block's last slab.
  auto stage = [&](int kt) {
    if (kt < kt1) {
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
      float* wst = wst_of(kt);
#pragma unroll
      for (int it = 0; it < BK * BN / 4 / THREADS; ++it) {
        const int q = tid + it * THREADS;
        const int r = q / (BN / 4), c = 4 * (q % (BN / 4));
        const int gi = k0 + r, gn = n_base + c;
        const bool ok = gi < g.I && gn < g.ld;
        tf32::cp_async16(wst + r * PF_WLD + c,
                         ok ? wf + (size_t)gi * g.ld + gn : wf, ok ? 16 : 0);
      }
    }
    tf32::cp_async_commit();
  };

  // Piece ``it`` (of 4) of slab kt: 4 values of one row of its x into
  // buffer ``buf`` as TF32 hi / lo parts (bf16 x: hi only, its lo part is
  // exactly zero), and (NOISE) the noise of the four columns 4 (q % 32)
  // of its Wg row q / 32, added in place.
  auto prepare = [&](int kt, int buf, int it) {
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
    if (!xbf) *reinterpret_cast<uint4*>(xh + PART + core(r, 4 * kc)) = lo;
    if constexpr (NOISE) {
      const int wr = q / (BN / 4), c = 4 * (q % (BN / 4));
      float z[4];
      philox_normal4(e, (uint32_t)(kt * BK + wr), (uint32_t)(n_base + c) >> 2,
                     z);
      float4* p = reinterpret_cast<float4*>(wst_of(kt) + wr * PF_WLD + c);
      *p = add_noise(*p, nz, z);
    }
  };

  // The thread's A fragment of k step k8 of slab kt: Wg[k][c] for (c, k)
  // = (c_lo, t), (c_hi, t), (c_lo, t + 4), (c_hi, t + 4), split.
  auto load_a = [&](int kt, int k8, uint32_t (&ah)[4], uint32_t (&al)[4]) {
    const float* wst = wst_of(kt);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = q % 2 ? c_hi : c_lo, k = k8 * 8 + tq + 4 * (q / 2);
      tf32::split(wst[k * PF_WLD + c], ah[q], al[q]);
    }
  };

  for (int kt = kt0; kt < kt0 + PF_STAGES - 1; ++kt) stage(kt);
  tf32::cp_async_wait<PF_STAGES - 2>();
  __syncthreads();
#pragma unroll
  for (int it = 0; it < 4; ++it) prepare(kt0, kt0 & 1, it);
  tf32::cp_async_wait<PF_STAGES - 3>();
  tf32::fence_proxy_async();
  __syncthreads();

  float acc[64], d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = d[i] = 0.0f;
  uint32_t ah[2][4], al[2][4];

  for (int kt = kt0; kt < kt1; ++kt) {
    const int buf = kt & 1;
    const bool more = kt + 1 < kt1;
    stage(kt + PF_STAGES - 1);
    const float* xh = px + buf * 2 * PART;
#pragma unroll
    for (int k8 = 0; k8 < BK / 8; ++k8) {
      load_a(kt, k8, ah[k8 % 2], al[k8 % 2]);
      tf32::wg_fence();
      tf32::wg_fence_operand(d);
      const uint64_t b_hi = tf32::wg_desc(xh + 64 * k8, SBO);
      tf32::wgmma_m64n128k8_rs(d, al[k8 % 2], b_hi, k8 > 0);
      if (!xbf) {
        const uint64_t b_lo = tf32::wg_desc(xh + PART + 64 * k8, SBO);
        tf32::wgmma_m64n128k8_rs(d, ah[k8 % 2], b_lo, 1);
      }
      tf32::wgmma_m64n128k8_rs(d, ah[k8 % 2], b_hi, 1);
      tf32::wg_commit();
      if (more) prepare(kt + 1, buf ^ 1, k8);
      tf32::wg_wait<1>();
    }
    tf32::wg_wait<0>();
    tf32::wg_fence_operand(d);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], d[i]);
    tf32::cp_async_wait<PF_STAGES - 3>();
    tf32::fence_proxy_async();
    __syncthreads();
  }
  // acc[4j + q] is D[c][m]: W' column c_lo (q < 2) or c_hi, x row
  // 8j + 2t + q % 2.
  auto store = [&](int i, float v) {
    int gn = n_base + (i % 4 < 2 ? c_lo : c_hi);
    int gm = m_base + 8 * (i / 4) + 2 * tq + (i % 2);
    if (gm < g.M && gn < g.N) out[(size_t)gm * g.N + gn] = v;
  };
  if (S == 1) {
#pragma unroll
    for (int i = 0; i < 64; ++i) store(i, acc[i]);
    return;
  }
  // The split's partial sums, [64][THREADS] in the (now free) x parts;
  // rank z adds outputs [z * 64 / S, (z + 1) * 64 / S) of each thread
  // over the ranks 0 .. S-1 in order.
  cg::cluster_group cluster = cg::this_cluster();
  float* part = px;
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i * THREADS + tid] = acc[i];
  cluster.sync();
  const int share = 64 / S;
  for (int i = z * share; i < (z + 1) * share; ++i) {
    float v = *cluster.map_shared_rank(part + i * THREADS + tid, 0);
    for (int r = 1; r < S; ++r)
      v += *cluster.map_shared_rank(part + i * THREADS + tid, r);
    store(i, v);
  }
  cluster.sync();   // no block leaves while another reads its part
}

// Set a kernel's dynamic shared-memory limit once, then launch ``grid``
// blocks of THREADS in clusters of ``cluster`` blocks (a plain launch for
// a cluster of 1: the kernel's own __cluster_dims__, if any).
template <auto Kernel, typename... Args>
cudaError_t launch_grid(dim3 grid, dim3 cluster, int smem,
                        cudaStream_t stream, Args... args) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  if (cluster.x * cluster.y * cluster.z == 1) {
    Kernel<<<grid, THREADS, smem, stream>>>(args...);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster.x;
  attr[0].val.clusterDim.y = cluster.y;
  attr[0].val.clusterDim.z = cluster.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, Kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// (g.gx, g.gy, g.gz) blocks.
template <auto Kernel, typename... Args>
cudaError_t launch(const Geom& g, cudaStream_t stream, Args... args) {
  return launch_grid<Kernel>(dim3(g.gx, g.gy, g.gz), dim3(1, 1, 1), g.smem,
                             stream, args...);
}

// The same in clusters of (1, 1, g.gz) blocks.
template <auto Kernel, typename... Args>
cudaError_t launch_split(const Geom& g, cudaStream_t stream, Args... args) {
  return launch_grid<Kernel>(dim3(g.gx, g.gy, g.gz), dim3(1, 1, g.gz),
                             g.smem, stream, args...);
}

// The runtime's occupancy calculator for Kernel at g's shared memory:
// out[0] resident blocks a SM; out[1] for a launch of ``grid`` in
// clusters of ``cluster`` blocks (``fixed``: the kernel's own
// __cluster_dims__) the clusters the card holds at once, else 0.
template <auto Kernel>
cudaError_t occupancy(const Geom& g, dim3 grid, dim3 cluster, bool fixed,
                      int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], Kernel,
                                                        THREADS, g.smem);
  out[1] = 0;
  if (err != cudaSuccess || cluster.x * cluster.y * cluster.z <= 1)
    return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = g.smem;
  cudaLaunchAttribute attr[1];
  if (!fixed) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster.x;
    attr[0].val.clusterDim.y = cluster.y;
    attr[0].val.clusterDim.z = cluster.z;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return cudaOccupancyMaxActiveClusters(&out[1], Kernel, &cfg);
}

// Occupancy at g's own grid: unclustered, or in clusters of (1, 1, g.gz).
template <auto Kernel>
cudaError_t occupancy(const Geom& g, int split, int* out) {
  return occupancy<Kernel>(g, dim3(g.gx, g.gy, g.gz), dim3(1, 1, split),
                           false, out);
}

// The decode forms' fixed clusters of (1, CLUSTER, 1).
template <auto Kernel>
cudaError_t occupancy_fixed(const Geom& g, int* out) {
  return occupancy<Kernel>(g, dim3(g.gx, g.gy, g.gz), dim3(1, CLUSTER, 1),
                           true, out);
}

// The batched form: (gx, 1, 1) persistent blocks in clusters of (gy, 1,
// 1); template instance (NOISE, x bf16).
template <bool NOISE, bool XBF>
cudaError_t launch_batched(const Geom& g, const void* x, const float* wf,
                           long long wstride, const float* scale,
                           const int32_t* reps, const int32_t* tags,
                           float* out, const Noise& e, cudaStream_t s) {
  return launch_grid<cim_decode_batched_kernel<NOISE, XBF>>(
      dim3(g.gx), dim3(g.gy), g.smem, s, x, wf, wstride, scale, reps, tags,
      out, g, e);
}

template <bool NOISE, bool XBF>
cudaError_t occupancy_batched(const Geom& g, int* out) {
  return occupancy<cim_decode_batched_kernel<NOISE, XBF>>(
      g, dim3(g.gx), dim3(g.gy), false, out);
}

// The grouped folded forms (geom form 9, 10 or 11), template instance
// (NOISE, x bf16): the general form on its own grid, the decode and
// prefill forms in clusters of (1, gy, 1).
template <bool NOISE, bool XBF>
cudaError_t launch_grouped_folded(const Geom& g, const void* x,
                                  const float* wf, long long wstride,
                                  const float* scale, const int32_t* tags,
                                  const int32_t* offsets, float* out,
                                  const Noise& e, cudaStream_t s) {
  const dim3 grid(g.gx, g.gy, g.gz), cluster(1, g.gy, 1);
  switch (g.form) {
    case FORM_GROUPED_FOLDED:
      return launch<cim_grouped_folded_kernel<NOISE, XBF>>(
          g, s, x, wf, wstride, scale, tags, offsets, out, g, e);
    case FORM_GROUPED_FOLDED_DECODE:
      return launch_grid<cim_grouped_folded_decode_kernel<NOISE, XBF>>(
          grid, cluster, g.smem, s, x, wf, wstride, scale, tags, offsets,
          out, g, e);
    case FORM_GROUPED_FOLDED_PREFILL:
      return launch_grid<cim_grouped_folded_prefill_kernel<NOISE, XBF>>(
          grid, cluster, g.smem, s, x, wf, wstride, scale, tags, offsets,
          out, g, e);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool NOISE, bool XBF>
cudaError_t occupancy_grouped_folded(const Geom& g, int* out) {
  const dim3 grid(g.gx, g.gy, g.gz), cluster(1, g.gy, 1);
  switch (g.form) {
    case FORM_GROUPED_FOLDED:
      return occupancy<cim_grouped_folded_kernel<NOISE, XBF>>(g, 1, out);
    case FORM_GROUPED_FOLDED_DECODE:
      return occupancy<cim_grouped_folded_decode_kernel<NOISE, XBF>>(
          g, grid, cluster, false, out);
    case FORM_GROUPED_FOLDED_PREFILL:
      return occupancy<cim_grouped_folded_prefill_kernel<NOISE, XBF>>(
          g, grid, cluster, false, out);
    default:
      return cudaErrorInvalidValue;
  }
}

// The decode forms' occupancy: B is FAST (ideal) or NOISE (folded).
template <bool B>
cudaError_t occupancy_decode(const Geom& g, bool folded, int* out) {
  switch (g.mt) {
    case 1: return folded ? occupancy_fixed<cim_decode_folded_kernel<1, B>>(g, out)
                          : occupancy_fixed<cim_decode_kernel<1, B>>(g, out);
    case 2: return folded ? occupancy_fixed<cim_decode_folded_kernel<2, B>>(g, out)
                          : occupancy_fixed<cim_decode_kernel<2, B>>(g, out);
    case 4: return folded ? occupancy_fixed<cim_decode_folded_kernel<4, B>>(g, out)
                          : occupancy_fixed<cim_decode_kernel<4, B>>(g, out);
    case 8: return folded ? occupancy_fixed<cim_decode_folded_kernel<8, B>>(g, out)
                          : occupancy_fixed<cim_decode_kernel<8, B>>(g, out);
    case 16: return folded ? occupancy_fixed<cim_decode_folded_kernel<16, B>>(g, out)
                           : occupancy_fixed<cim_decode_kernel<16, B>>(g, out);
    default: return cudaErrorInvalidValue;
  }
}

template <bool FAST>
cudaError_t launch_decode(const Geom& g, const void* x, const int16_t* codes,
                          const int32_t* pos, const float* scale, float* out,
                          float eta, cudaStream_t s) {
  switch (g.mt) {
    case 1: return launch<cim_decode_kernel<1, FAST>>(g, s, x, codes, pos, scale, out, g, eta);
    case 2: return launch<cim_decode_kernel<2, FAST>>(g, s, x, codes, pos, scale, out, g, eta);
    case 4: return launch<cim_decode_kernel<4, FAST>>(g, s, x, codes, pos, scale, out, g, eta);
    case 8: return launch<cim_decode_kernel<8, FAST>>(g, s, x, codes, pos, scale, out, g, eta);
    case 16: return launch<cim_decode_kernel<16, FAST>>(g, s, x, codes, pos, scale, out, g, eta);
    default: return cudaErrorInvalidValue;
  }
}

template <bool NOISE>
cudaError_t launch_decode_folded(const Geom& g, const void* x, const float* wf,
                                 const float* scale, float* out,
                                 const Noise& e, cudaStream_t s) {
  switch (g.mt) {
    case 1: return launch<cim_decode_folded_kernel<1, NOISE>>(g, s, x, wf, scale, out, g, e);
    case 2: return launch<cim_decode_folded_kernel<2, NOISE>>(g, s, x, wf, scale, out, g, e);
    case 4: return launch<cim_decode_folded_kernel<4, NOISE>>(g, s, x, wf, scale, out, g, e);
    case 8: return launch<cim_decode_folded_kernel<8, NOISE>>(g, s, x, wf, scale, out, g, e);
    case 16: return launch<cim_decode_folded_kernel<16, NOISE>>(g, s, x, wf, scale, out, g, e);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// ``geom`` holds the Geom fields in order (ops.py::cim_geometry); x is
// f32 or (geom xbf16) bf16.  The ideal forms read codes, pos and scale;
// the folded forms (geom form 2, 3) read ``wf`` (rows of geom ld floats)
// and the scale, and with geom noise draw read noise at key (seed, tag)
// and amplitude nsig * scale.  Returns cudaGetLastError() of the launch,
// or cudaErrorInvalidValue for a geometry no kernel takes.
extern "C" int cim_mvm_launch(const void* x, const int16_t* codes,
                              const int32_t* pos, const float* scale,
                              float* out, const int* geom, float eta,
                              const float* wf, unsigned seed, unsigned tag,
                              float nsig, void* stream_ptr) {
  Geom g;
  static_assert(sizeof(Geom) == 28 * sizeof(int), "Geom is 28 ints");
  memcpy(&g, geom, sizeof(Geom));
  Noise e;
  for (int r = 0; r < PHILOX_ROUNDS; ++r) {
    e.k0[r] = seed + (uint32_t)r * 0x9E3779B9u;
    e.k1[r] = tag + (uint32_t)r * 0xBB67AE85u;
  }
  e.nsig = nsig;
  cudaStream_t s = (cudaStream_t)stream_ptr;
  const bool folded = g.form == FORM_DECODE_FOLDED ||
                      g.form == FORM_PREFILL_FOLDED;
  if (folded && (!wf || g.ld % 8 || (reinterpret_cast<uintptr_t>(wf) & 15)))
    return (int)cudaErrorInvalidValue;
  if (g.form == FORM_DECODE || g.form == FORM_DECODE_FOLDED) {
    if (g.gy != CLUSTER || THREADS % g.tile) return (int)cudaErrorInvalidValue;
  } else if (g.tile != PF_BN) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err;
  switch (g.form) {
    case FORM_DECODE:
      err = g.fast ? launch_decode<true>(g, x, codes, pos, scale, out, eta, s)
                   : launch_decode<false>(g, x, codes, pos, scale, out, eta, s);
      break;
    case FORM_PREFILL:
      err = g.fast ? launch<cim_prefill_kernel<true>>(g, s, x, codes, pos, scale, out, g, eta)
                   : launch<cim_prefill_kernel<false>>(g, s, x, codes, pos, scale, out, g, eta);
      break;
    case FORM_DECODE_FOLDED:
      err = g.noise ? launch_decode_folded<true>(g, x, wf, scale, out, e, s)
                    : launch_decode_folded<false>(g, x, wf, scale, out, e, s);
      break;
    case FORM_PREFILL_FOLDED:
      if (g.gz < 1 || g.gz > CLUSTER || 64 % g.gz)
        return (int)cudaErrorInvalidValue;
      err = g.noise ? launch_split<cim_prefill_folded_kernel<true>>(g, s, x, wf, scale, out, g, e)
                    : launch_split<cim_prefill_folded_kernel<false>>(g, s, x, wf, scale, out, g, e);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return (int)err;
}

// The batched folded decode form (geom form 5, ops.py::batched_geometry):
// member z of geom gz reads x slab z of (gz, M, I) (f32, or bf16 with geom
// xbf16), repeat reps[z] of ``wf`` (wstride floats a repeat, rows of geom
// ld floats) with scale scale[reps[z]], draws (with geom noise) read
// noise at key (seed, tags[z]) and amplitude nsig * scale, and writes y
// slab z of (gz, M, N).
extern "C" int cim_mvm_batched_launch(const void* x, const float* wf,
                                      long long wstride, const float* scale,
                                      const int32_t* reps,
                                      const int32_t* tags, float* out,
                                      const int* geom, unsigned seed,
                                      float nsig, void* stream_ptr) {
  Geom g;
  memcpy(&g, geom, sizeof(Geom));
  Noise e;
  for (int r = 0; r < PHILOX_ROUNDS; ++r) {
    e.k0[r] = seed + (uint32_t)r * 0x9E3779B9u;
    e.k1[r] = 0;
  }
  e.nsig = nsig;
  if (g.form != FORM_DECODE_BATCHED || g.tile != BT_BN || g.M < 1 ||
      g.M > 16 || g.I < 1 || g.gy < 1 || g.gy > CLUSTER || g.gx < g.gy ||
      g.gx % g.gy || g.gz < 1 || !wf || !reps || (g.noise && !tags) ||
      g.ld % 8 || wstride % 4 || (reinterpret_cast<uintptr_t>(wf) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream_ptr;
  cudaError_t err;
  if (g.noise)
    err = g.xbf16 ? launch_batched<true, true>(g, x, wf, wstride, scale, reps, tags, out, e, s)
                  : launch_batched<true, false>(g, x, wf, wstride, scale, reps, tags, out, e, s);
  else
    err = g.xbf16 ? launch_batched<false, true>(g, x, wf, wstride, scale, reps, tags, out, e, s)
                  : launch_batched<false, false>(g, x, wf, wstride, scale, reps, tags, out, e, s);
  return (int)err;
}

// The grouped ideal forms (geom form 6, 7 or 8, ops.py::grouped_geometry):
// expert e of the geom ``experts`` reads its codes at codes + e * cstride,
// its pos at pos + e * pstride and scale[e], and computes the rows
// [offsets[e], min(offsets[e + 1], offsets[e] + geom M)) of y (A, geom N)
// from those rows of x (A, geom I; f32, or bf16 with geom xbf16).  The
// decode and prefill forms take the 16-byte path only (codes on 16 bytes,
// wpt and n_pad multiples of 8, the eta*M1 table); the general form any.
extern "C" int cim_mvm_grouped_launch(const void* x, const int16_t* codes,
                                      const int32_t* pos, const float* scale,
                                      const int32_t* offsets, float* out,
                                      long long cstride, long long pstride,
                                      const int* geom, float eta,
                                      void* stream_ptr) {
  Geom g;
  memcpy(&g, geom, sizeof(Geom));
  if (g.M < 1 || g.I < 1 || g.gz < 1 || g.experts < 1 || !offsets)
    return (int)cudaErrorInvalidValue;
  const bool fast_ok = g.fast && !(reinterpret_cast<uintptr_t>(codes) & 15) &&
                       cstride % 8 == 0 && g.n_pad % 8 == 0 && g.wpt % 8 == 0;
  cudaStream_t s = (cudaStream_t)stream_ptr;
  cudaError_t err;
  switch (g.form) {
    case FORM_GROUPED:
      if (g.tile != GR_BN || g.gz != g.experts)
        return (int)cudaErrorInvalidValue;
      err = launch<cim_grouped_kernel>(g, s, x, codes, pos, scale, offsets,
                                       out, cstride, pstride, g, eta);
      break;
    case FORM_GROUPED_DECODE:
      if (!fast_ok || g.tile != GD_BN || g.gy < 1 || g.gy > CLUSTER ||
          g.mt != GD_RB)
        return (int)cudaErrorInvalidValue;
      err = launch_grid<cim_grouped_decode_kernel>(
          dim3(g.gx, g.gy, g.gz), dim3(1, g.gy, 1), g.smem, s, x, codes, pos,
          scale, offsets, out, cstride, pstride, g, eta);
      break;
    case FORM_GROUPED_PREFILL:
      if (!fast_ok || g.tile != GP_BN || g.gy < 1 || g.gy > CLUSTER ||
          (4 * GP_NT) % g.gy)
        return (int)cudaErrorInvalidValue;
      err = g.xbf16
                ? launch_grid<cim_grouped_prefill_kernel<true>>(
                      dim3(g.gx, g.gy, g.gz), dim3(1, g.gy, 1), g.smem, s, x,
                      codes, pos, scale, offsets, out, cstride, pstride, g,
                      eta)
                : launch_grid<cim_grouped_prefill_kernel<false>>(
                      dim3(g.gx, g.gy, g.gz), dim3(1, g.gy, 1), g.smem, s, x,
                      codes, pos, scale, offsets, out, cstride, pstride, g,
                      eta);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return (int)err;
}

// The grouped folded forms (geom form 9, 10 or 11, ops.py::
// grouped_folded_geometry: general, decode, prefill): expert e of the geom
// ``experts`` reads its Wg at wf + e * wstride (rows of geom ld floats)
// and scale[e], draws (with geom noise) read noise at key (seed, tags[e])
// and amplitude nsig * scale[e], and computes the rows [offsets[e],
// min(offsets[e + 1], offsets[e] + geom M)) of y (A, geom N) from those
// rows of x (A, geom I; f32, or bf16 with geom xbf16).
extern "C" int cim_mvm_grouped_folded_launch(
    const void* x, const float* wf, long long wstride, const float* scale,
    const int32_t* tags, const int32_t* offsets, float* out, const int* geom,
    unsigned seed, float nsig, void* stream_ptr) {
  Geom g;
  memcpy(&g, geom, sizeof(Geom));
  Noise e;
  for (int r = 0; r < PHILOX_ROUNDS; ++r) {
    e.k0[r] = seed + (uint32_t)r * 0x9E3779B9u;
    e.k1[r] = 0;
  }
  e.nsig = nsig;
  if (g.M < 1 || g.I < 1 || g.gz < 1 || g.experts < 1 || !offsets || !wf ||
      !scale || (g.noise && !tags) || g.ld % 8 || wstride % 4 ||
      (reinterpret_cast<uintptr_t>(wf) & 15))
    return (int)cudaErrorInvalidValue;
  switch (g.form) {
    case FORM_GROUPED_FOLDED:
      if (g.tile != GR_BN) return (int)cudaErrorInvalidValue;
      break;
    case FORM_GROUPED_FOLDED_DECODE:
      if (g.tile != GD_BN || g.gy < 1 || g.gy > CLUSTER || g.mt != GD_RB ||
          4 * g.off_p < GFD_RING)
        return (int)cudaErrorInvalidValue;
      break;
    case FORM_GROUPED_FOLDED_PREFILL:
      if (g.tile != GP_BN || g.gy < 1 || g.gy > CLUSTER ||
          (4 * GP_NT) % g.gy)
        return (int)cudaErrorInvalidValue;
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream_ptr;
  cudaError_t err;
  if (g.noise)
    err = g.xbf16 ? launch_grouped_folded<true, true>(g, x, wf, wstride, scale, tags, offsets, out, e, s)
                  : launch_grouped_folded<true, false>(g, x, wf, wstride, scale, tags, offsets, out, e, s);
  else
    err = g.xbf16 ? launch_grouped_folded<false, true>(g, x, wf, wstride, scale, tags, offsets, out, e, s)
                  : launch_grouped_folded<false, false>(g, x, wf, wstride, scale, tags, offsets, out, e, s);
  return (int)err;
}

// Wg = W'(col_pos) * gain into ``wf`` (geom I = I_pad rows of geom ld
// floats), once a deployment: ``gain`` and ``colp`` may be null.
// Geometry from ops.py::fold_geometry (geom form 4).
extern "C" int cim_fold_launch(const int16_t* codes, const int32_t* pos,
                               const float* scale, const float* gain,
                               const int32_t* colp, float* wf,
                               const int* geom, float eta, void* stream_ptr) {
  Geom g;
  memcpy(&g, geom, sizeof(Geom));
  cudaStream_t s = (cudaStream_t)stream_ptr;
  if (g.form != FORM_FOLD || g.ld % 8 || (colp && g.rows < 1) ||
      (reinterpret_cast<uintptr_t>(wf) & 15))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (g.fast)
    err = colp ? launch<cim_fold_kernel<true, true>>(g, s, codes, pos, scale, gain, colp, wf, g, eta)
               : launch<cim_fold_kernel<true, false>>(g, s, codes, pos, scale, gain, colp, wf, g, eta);
  else
    err = colp ? launch<cim_fold_kernel<false, true>>(g, s, codes, pos, scale, gain, colp, wf, g, eta)
               : launch<cim_fold_kernel<false, false>>(g, s, codes, pos, scale, gain, colp, wf, g, eta);
  return (int)err;
}

// The occupancy of the kernel that a launch with ``geom`` runs (any form;
// the fold's col_pos instantiation where geom rows > 0), from the CUDA
// runtime's occupancy calculator: out[0] resident blocks a SM, out[1] clusters the card holds
// at once for a cluster launch (the decode forms, a split folded
// prefill, the grouped decode and prefill forms), else 0.  A failed query leaves no error behind for the next
// launch's cudaGetLastError().
extern "C" int cim_occupancy(const int* geom, int* out) {
  Geom g;
  memcpy(&g, geom, sizeof(Geom));
  cudaError_t err;
  switch (g.form) {
    case FORM_DECODE:
      err = g.fast ? occupancy_decode<true>(g, false, out)
                   : occupancy_decode<false>(g, false, out);
      break;
    case FORM_PREFILL:
      err = g.fast ? occupancy<cim_prefill_kernel<true>>(g, 1, out)
                   : occupancy<cim_prefill_kernel<false>>(g, 1, out);
      break;
    case FORM_DECODE_FOLDED:
      err = g.noise ? occupancy_decode<true>(g, true, out)
                    : occupancy_decode<false>(g, true, out);
      break;
    case FORM_PREFILL_FOLDED:
      err = g.noise ? occupancy<cim_prefill_folded_kernel<true>>(g, g.gz, out)
                    : occupancy<cim_prefill_folded_kernel<false>>(g, g.gz, out);
      break;
    case FORM_DECODE_BATCHED:
      err = g.noise ? (g.xbf16 ? occupancy_batched<true, true>(g, out)
                               : occupancy_batched<true, false>(g, out))
                    : (g.xbf16 ? occupancy_batched<false, true>(g, out)
                               : occupancy_batched<false, false>(g, out));
      break;
    case FORM_GROUPED:
      err = occupancy<cim_grouped_kernel>(g, 1, out);
      break;
    case FORM_GROUPED_DECODE:
      err = occupancy<cim_grouped_decode_kernel>(
          g, dim3(g.gx, g.gy, g.gz), dim3(1, g.gy, 1), false, out);
      break;
    case FORM_GROUPED_PREFILL:
      err = g.xbf16 ? occupancy<cim_grouped_prefill_kernel<true>>(
                          g, dim3(g.gx, g.gy, g.gz), dim3(1, g.gy, 1), false,
                          out)
                    : occupancy<cim_grouped_prefill_kernel<false>>(
                          g, dim3(g.gx, g.gy, g.gz), dim3(1, g.gy, 1), false,
                          out);
      break;
    case FORM_GROUPED_FOLDED:
    case FORM_GROUPED_FOLDED_DECODE:
    case FORM_GROUPED_FOLDED_PREFILL:
      err = g.noise ? (g.xbf16 ? occupancy_grouped_folded<true, true>(g, out)
                               : occupancy_grouped_folded<true, false>(g, out))
                    : (g.xbf16 ? occupancy_grouped_folded<false, true>(g, out)
                               : occupancy_grouped_folded<false, false>(g, out));
      break;
    case FORM_FOLD:
      if (g.fast)
        err = g.rows ? occupancy<cim_fold_kernel<true, true>>(g, 1, out)
                     : occupancy<cim_fold_kernel<true, false>>(g, 1, out);
      else
        err = g.rows ? occupancy<cim_fold_kernel<false, true>>(g, 1, out)
                     : occupancy<cim_fold_kernel<false, false>>(g, 1, out);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}
