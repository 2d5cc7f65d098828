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
// plane ever exists in device memory.
//
// Design.  The TPU kernel accumulates its output block across a
// sequential grid axis over I.  Hopper runs blocks in parallel and in
// no order, so here one block owns one (BM x BN) output tile and loops
// over its slice of I itself.  Each step stages a BK-row slab of x (f32)
// and of the codes, expands the codes to W' in shared memory with the
// formula above, and accumulates x * W' in f32 FMAs (no TF32, no tensor
// cores).  Where the (M, N) grid alone would leave SMs idle (decode, M
// <= 8), the I range is split over gridDim.z: each split writes its
// partial tile to a scratch buffer and a second kernel sums the splits
// in a fixed order, so results do not depend on scheduling.
//
// What bounds it.  At decode (M <= 8) each weight is used by M rows only:
// the kernel streams ~2.5 bytes a weight for 2*M flops, far below the
// card's ~20 flop/byte balance point, so it is bound by device memory
// (the whole model's codes are ~7.2 GB a token at phi3-mini width).  At
// prefill (M = B*S in the hundreds) the f32 FMAs and the expansion bound
// it; a tensor-core (wgmma) version is later work.
//
// Rounding.  M0 and M1 are exact (integers times 2^-K); the rest of the
// expansion uses __fmul_rn / __fadd_rn so that nvcc cannot contract it
// into FMAs: W' is rounded op by op in the same order as the reference's
// XLA expression and the plain version.  No fast-math division is used.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// W'[i,n] from one code, without a loop over the K bit planes.
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
//
// ``c0`` is (n mod wpt) * K for output column n and ``unit`` is 2^-K;
// both are per-thread constants of the kernel below.
__device__ __forceinline__ float expand_weight(
    int code, int p, int c0, float unit, float scale, float eta,
    int n_bits, int cols, int reversed) {
  int mag = code < 0 ? -code : code;
  float sgn_scale = code < 0 ? -scale : scale;
  int wsum = (mag & 0xAAAA) + 2 * (mag & 0xCCCC) + 4 * (mag & 0xF0F0) +
             8 * (mag & 0xFF00);
  int g = (n_bits - 1) * mag - wsum;
  int m1_int = reversed ? (cols - 1 - c0) * mag - g : c0 * mag + g;
  float m0 = __fmul_rn((float)mag, unit);
  float m1 = __fmul_rn((float)m1_int, unit);
  float row = __fadd_rn(1.0f, __fmul_rn(eta, (float)p));
  float mag_eff = __fadd_rn(__fmul_rn(row, m0), __fmul_rn(eta, m1));
  return __fmul_rn(sgn_scale, mag_eff);
}

// BM x BN output tile per block, BK rows of I per step, each thread
// owns TM x TN outputs spread with strides (BM/TM, BN/TN) so that shared
// memory reads are conflict-free or broadcast.
template <int BM, int BN, int BK, int TM, int TN>
__global__ void cim_mvm_kernel(
    const float* __restrict__ x, const int16_t* __restrict__ codes,
    const int32_t* __restrict__ pos, const float* __restrict__ scale_ptr,
    float* __restrict__ out, int M, int I, int N, int n_pad, int n_tiles,
    int i_pad, int k_per_split, float eta, int n_bits, int wpt, int cols,
    int reversed) {
  constexpr int TX = BN / TN;
  constexpr int TY = BM / TM;
  constexpr int NT = TX * TY;
  __shared__ float xs[BK][BM];
  __shared__ float ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int m_base = blockIdx.y * BM;
  const int n_base = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(k_begin + k_per_split, i_pad);
  const float scale = *scale_ptr;
  const float unit = ldexpf(1.0f, -n_bits);
  // Every W' element a thread expands lies in one column of the tile
  // (NT is a multiple of BN), so its column constants are computed once.
  static_assert(NT % BN == 0, "a thread's W' elements share one column");
  const int gn = n_base + tid % BN;
  const int c0 = (gn % wpt) * n_bits;
  const int tile_n = gn / wpt;
  const bool col_ok = gn < n_pad;

  float acc[TM][TN];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < TN; ++b) acc[a][b] = 0.0f;

  static_assert((BM * BK) % NT == 0 && (BK * BN) % NT == 0,
                "tile loads must divide evenly over the block");
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    // Fixed trip counts, unrolled: every thread issues all its loads of
    // the step before the first use, instead of one load-use round trip
    // per element.
#pragma unroll
    for (int it = 0; it < BM * BK / NT; ++it) {
      int e = tid + it * NT;
      int r = e / BK, c = e % BK;
      int gm = m_base + r, gi = k0 + c;
      xs[c][r] = (gm < M && gi < I && gi < k_end) ? x[(size_t)gm * I + gi]
                                                   : 0.0f;
    }
    int16_t code[BK * BN / NT];
    int32_t p[BK * BN / NT];
#pragma unroll
    for (int it = 0; it < BK * BN / NT; ++it) {
      int gi = k0 + tid / BN + it * (NT / BN);
      bool ok = col_ok && gi < k_end;
      code[it] = ok ? codes[(size_t)gi * n_pad + gn] : (int16_t)0;
      p[it] = ok ? pos[(size_t)gi * n_tiles + tile_n] : 0;
    }
#pragma unroll
    for (int it = 0; it < BK * BN / NT; ++it) {
      ws[tid / BN + it * (NT / BN)][tid % BN] = expand_weight(
          code[it], p[it], c0, unit, scale, eta, n_bits, cols, reversed);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int a = 0; a < TM; ++a) av[a] = xs[kk][ty + a * TY];
#pragma unroll
      for (int b = 0; b < TN; ++b) bv[b] = ws[kk][tx + b * TX];
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int b = 0; b < TN; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
    __syncthreads();
  }

  float* dst = out + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int a = 0; a < TM; ++a) {
    int gm = m_base + ty + a * TY;
    if (gm >= M) continue;
#pragma unroll
    for (int b = 0; b < TN; ++b) {
      int gn = n_base + tx + b * TX;
      if (gn < N) dst[(size_t)gm * N + gn] = acc[a][b];
    }
  }
}

// out[j] = sum over splits s (in order) of partial[s, j].
__global__ void sum_splits_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, int splits,
                                  size_t count) {
  size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= count) return;
  float s = 0.0f;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * count + j];
  out[j] = s;
}

template <int BM, int BN, int BK, int TM, int TN>
void launch_tile(const float* x, const int16_t* codes, const int32_t* pos,
                 const float* scale, float* dst, int M, int I, int N,
                 int n_pad, int n_tiles, int i_pad, int splits,
                 int k_per_split, float eta, int n_bits, int wpt, int cols,
                 int reversed, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  dim3 block((BM / TM) * (BN / TN));
  cim_mvm_kernel<BM, BN, BK, TM, TN><<<grid, block, 0, stream>>>(
      x, codes, pos, scale, dst, M, I, N, n_pad, n_tiles, i_pad,
      k_per_split, eta, n_bits, wpt, cols, reversed);
}

}  // namespace

// Tile configurations, mirrored by repro_torch/kernels/cim_mvm/ops.py:
//   small_m = 1 (M <= 16): BM 8,  BN 64, BK 64, 1 x 2 outputs a thread
//   small_m = 0          : BM 64, BN 64, BK 16, 4 x 4 outputs a thread
// ``partial`` holds splits * M * N floats when splits > 1 (else unused).
extern "C" int cim_mvm_launch(const float* x, const int16_t* codes,
                              const int32_t* pos, const float* scale,
                              float* out, float* partial, int M, int I,
                              int N, int i_pad, int n_pad, int n_tiles,
                              int splits, int k_per_split, float eta,
                              int n_bits, int wpt, int cols, int reversed,
                              int small_m, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  float* dst = splits > 1 ? partial : out;
  if (small_m) {
    launch_tile<8, 64, 64, 1, 2>(x, codes, pos, scale, dst, M, I, N, n_pad,
                                 n_tiles, i_pad, splits, k_per_split, eta,
                                 n_bits, wpt, cols, reversed, stream);
  } else {
    launch_tile<64, 64, 16, 4, 4>(x, codes, pos, scale, dst, M, I, N, n_pad,
                                  n_tiles, i_pad, splits, k_per_split, eta,
                                  n_bits, wpt, cols, reversed, stream);
  }
  if (splits > 1) {
    size_t count = (size_t)M * N;
    int threads = 256;
    unsigned blocks = (unsigned)((count + threads - 1) / threads);
    sum_splits_kernel<<<blocks, threads, 0, stream>>>(partial, out, splits,
                                                      count);
  }
  return (int)cudaGetLastError();
}
