// Per-tile Manhattan row scores, row counts and NF — the MDM planning
// reduction — hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/manhattan_score/kernel.py::_score_kernel /
//   manhattan_score_pallas.
//
// For tile masks m (T, R, C) uint8, any nonzero byte counting as 1, in
// one pass:
//   scores[t, j] = sum_k m[t,j,k] * (1 + c(k))        (paper step-2 score)
//   counts[t, j] = sum_k m[t,j,k]                     (row density)
//   nf[t]        = unit * sum_{j,k} m[t,j,k] * (p(t,j) + c(k))    (Eq 16)
// with c(k) = k, or C-1-k when ``reverse`` is set (reversed dataflow:
// the tile is scored in its mirrored column layout without writing the
// mirror out), and p(t,j) = j, or row_position[t, j] when a row
// placement is given (the NF of the placed tile without writing the
// permuted masks out).  The port's planner runs it twice or three times
// per matrix: NF before on the raw masks, the sort keys on the oriented
// masks, NF after with the planned row positions.
//
// All sums are integers and are accumulated as integers; the only float
// rounding is the final (float) conversion and the one multiply by the
// f32 ``unit``.  While a tile's distance sum stays below 2^24 (a 64x64
// tile reaches 258,048) the results are bit-identical to the
// reference's f32 reductions in any order.
//
// What bounds it: one byte read per cell for three integer
// multiply-adds, so device memory (4,096 bytes a 64x64 tile in, 516
// out).  The card needs ~3 MB in flight to cover HBM's latency, ~25 KB
// a SM.
//
// Vector form (C in {16, 32, 64, 128, 256}, masks on 16 bytes): one
// warp a tile, 8 warps a block.  A lane loads 16 bytes of one row at a
// time, and all its loads of a tile (8 of them at 64x64: the whole
// 4 KB tile a warp, and the row positions of its rows where a placement
// is given) are issued before any is reduced; with ~32 warps
// resident a SM that is ~128 KB in flight, five times what HBM needs,
// so occupancy, not a software pipeline, covers the latency.  Each
// 4-byte word is normalised with __vcmpne4 (& 0x01010101) and reduced
// with two __dp4a: against 0x01010101 for the count and against the
// packed column indices (c, c+1, c+2, c+3) for the column sum, so a
// lane does 8 SIMD instructions for 16 cells.  The reversed layout uses
// s_rev = n (C - 1) - s, exact in integers.  A row's C/16 lanes are
// neighbours and reduce in log2(C/16) shuffle steps (2 at C = 64); the
// row's leader writes score and count, so the leaders of one load
// instruction write 4 * 32/(C/16) contiguous bytes (whole 32-byte
// sectors at C <= 64).  Packed indices must fit a byte: C <= 256.
//
// Byte form (any other shape, or masks not on 16 bytes): one block of
// 128 threads a tile, a warp a row at a time, lanes reading the row's
// bytes with stride 32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int VEC_THREADS = 256;       // 8 warps, one tile each
constexpr int VEC_WARPS = VEC_THREADS / 32;
constexpr int VEC_LOADS = 8;           // 16-byte loads in flight a lane
constexpr int BYTE_THREADS = 128;
constexpr int BYTE_WARPS = BYTE_THREADS / 32;

__global__ void __launch_bounds__(VEC_THREADS)
score_vec_kernel(const uint4* __restrict__ masks,
                 const int32_t* __restrict__ row_position,
                 float* __restrict__ scores, float* __restrict__ counts,
                 float* __restrict__ nf, int T, int R, int C, int reverse,
                 float nf_unit) {
  const int lane = threadIdx.x % 32;
  const size_t t = (size_t)blockIdx.x * VEC_WARPS + threadIdx.x / 32;
  if (t >= (size_t)T) return;            // the whole warp leaves
  const int cpr = C / 16;                // lanes a row: 1, 2, 4, 8, 16
  const int chunks = R * cpr;
  const uint4* tile = masks + t * chunks;

  long long dist = 0;
  for (int base = 0; base < chunks; base += 32 * VEC_LOADS) {
    uint4 v[VEC_LOADS];
    int pos[VEC_LOADS];                  // the leaders' row positions
#pragma unroll
    for (int i = 0; i < VEC_LOADS; ++i) {
      const int q = base + 32 * i + lane;
      v[i] = q < chunks ? __ldg(tile + q) : make_uint4(0, 0, 0, 0);
      pos[i] = (row_position && q < chunks && lane % cpr == 0)
                   ? __ldg(row_position + t * R + q / cpr)
                   : q / cpr;
    }
#pragma unroll
    for (int i = 0; i < VEC_LOADS; ++i) {
      const int q = base + 32 * i + lane;
      const unsigned c0 = 16u * (unsigned)(q % cpr);
      const unsigned w[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
      unsigned n = 0, s = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const unsigned b = __vcmpne4(w[k], 0u) & 0x01010101u;
        // Byte e of the word is column c0 + 4k + e (little endian).
        const unsigned idx = (c0 + 4u * k) * 0x01010101u + 0x03020100u;
        n = __dp4a(b, 0x01010101u, n);
        s = __dp4a(b, idx, s);
      }
      // A row's lanes are an aligned group of cpr (cpr divides 32).
      for (int o = 1; o < cpr; o <<= 1) {
        n += __shfl_xor_sync(0xffffffffu, n, o);
        s += __shfl_xor_sync(0xffffffffu, s, o);
      }
      if (q < chunks && lane % cpr == 0) {
        const int j = q / cpr;
        if (reverse) s = n * (unsigned)(C - 1) - s;
        const size_t o = t * R + j;
        scores[o] = (float)(n + s);
        counts[o] = (float)n;
        dist += (long long)pos[i] * n + s;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    dist += __shfl_xor_sync(0xffffffffu, dist, o);
  if (lane == 0) nf[t] = __fmul_rn(nf_unit, (float)dist);
}

__global__ void score_byte_kernel(const uint8_t* __restrict__ masks,
                                  const int32_t* __restrict__ row_position,
                                  float* __restrict__ scores,
                                  float* __restrict__ counts,
                                  float* __restrict__ nf, int R, int C,
                                  int reverse, float nf_unit) {
  __shared__ long long dist_s[BYTE_WARPS];
  const size_t t = blockIdx.x;
  const uint8_t* tile = masks + t * (size_t)R * C;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  long long dist = 0;
  for (int j = warp; j < R; j += BYTE_WARPS) {
    const uint8_t* row = tile + (size_t)j * C;
    int n = 0, s = 0;
    for (int k = lane; k < C; k += 32) {
      int a = row[k] != 0;
      int col = reverse ? (C - 1 - k) : k;
      n += a;
      s += a * col;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      n += __shfl_xor_sync(0xffffffffu, n, o);
      s += __shfl_xor_sync(0xffffffffu, s, o);
    }
    if (lane == 0) {
      int p = row_position ? row_position[t * R + j] : j;
      scores[t * R + j] = (float)(n + s);
      counts[t * R + j] = (float)n;
      dist += (long long)p * n + s;
    }
  }
  if (lane == 0) dist_s[warp] = dist;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long total = 0;
    for (int w = 0; w < BYTE_WARPS; ++w) total += dist_s[w];
    nf[t] = __fmul_rn(nf_unit, (float)total);
  }
}

}  // namespace

// ``form`` 1: the vector form (the caller checks C and alignment, see
// ops.py's score_form); 0: the byte form.  ``row_position`` may be null
// (identity placement).
extern "C" int manhattan_score_launch(const uint8_t* masks,
                                      const int32_t* row_position,
                                      float* scores, float* counts,
                                      float* nf, int T, int R, int C,
                                      int reverse, float nf_unit, int form,
                                      void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (T <= 0) return (int)cudaGetLastError();
  if (form == 1) {
    if (C < 16 || C % 16 || C > 256 || 32 % (C / 16) ||
        (uintptr_t)masks % 16)
      return (int)cudaErrorInvalidValue;
    score_vec_kernel<<<(T + VEC_WARPS - 1) / VEC_WARPS, VEC_THREADS, 0,
                       stream>>>(reinterpret_cast<const uint4*>(masks),
                                 row_position, scores, counts, nf, T, R, C,
                                 reverse, nf_unit);
  } else {
    score_byte_kernel<<<T, BYTE_THREADS, 0, stream>>>(
        masks, row_position, scores, counts, nf, R, C, reverse, nf_unit);
  }
  return (int)cudaGetLastError();
}
