// Per-tile Manhattan row scores, row counts and NF — the MDM planning
// reduction — hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/manhattan_score/kernel.py::_score_kernel /
//   manhattan_score_pallas.
//
// For tile masks m (T, R, C) uint8, in one pass:
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
// Design.  One block of 128 threads per tile; each warp takes rows
// j = warp, warp + 4, ...; lanes read the row's bytes with stride 32 and
// reduce count and score with shuffles; the distance sum is reduced over
// the block through shared memory.  What bounds it: one byte read per
// cell for three integer multiply-adds, so device memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

__global__ void score_kernel(const uint8_t* __restrict__ masks,
                             const int32_t* __restrict__ row_position,
                             float* __restrict__ scores,
                             float* __restrict__ counts,
                             float* __restrict__ nf, int R, int C,
                             int reverse, float nf_unit) {
  __shared__ long long dist_s[WARPS];
  const size_t t = blockIdx.x;
  const uint8_t* tile = masks + t * (size_t)R * C;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  long long dist = 0;
  for (int j = warp; j < R; j += WARPS) {
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
    for (int w = 0; w < WARPS; ++w) total += dist_s[w];
    nf[t] = __fmul_rn(nf_unit, (float)total);
  }
}

}  // namespace

// ``row_position`` may be null (identity placement).
extern "C" int manhattan_score_launch(const uint8_t* masks,
                                      const int32_t* row_position,
                                      float* scores, float* counts,
                                      float* nf, int T, int R, int C,
                                      int reverse, float nf_unit,
                                      void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (T > 0)
    score_kernel<<<T, THREADS, 0, stream>>>(masks, row_position, scores,
                                            counts, nf, R, C, reverse,
                                            nf_unit);
  return (int)cudaGetLastError();
}
