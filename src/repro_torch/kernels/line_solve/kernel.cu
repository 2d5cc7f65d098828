// The crossbar solver's line preconditioner, z = M^-1 r, hand-written
// for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the counterpart of the two batched
// jax.lax.linalg.tridiagonal_solve calls of the reference's
// preconditioner, src/repro/crossbar/batched.py:312-317
// (_line_preconditioner, chain_impl="lax").  PyTorch has no batched
// tridiagonal solver, and a Thomas sweep written as torch ops costs
// 2 (J + K) dependent steps of several launches each per application.
//
// For T tiles of J x K nodes, M = blockdiag(wordline chains along k,
// bitline chains along j), each chain a symmetric tridiagonal system:
//   wordline j:  diag cw (1 + [k < K-1]) + g[j,k], off-diagonals -cw
//   bitline  k:  diag cw (1 + [j < J-1]) + g[j,k], off-diagonals -cw
// r and z are (T, 2, J, K) (plane 0 the wordline nodes, plane 1 the
// bitline nodes), g is (T, J, K).  Each chain is solved by the Thomas
// algorithm in the reference's order (plain version: ref.py):
//   denom_i = d_i - lo_i c_(i-1),  c_i = hi_i / denom_i,
//   y_i = (r_i - lo_i y_(i-1)) / denom_i,  z_i = y_i - c_i z_(i+1);
// the chains are strictly diagonally dominant, so no pivoting is needed.
//
// What bounds it: device memory.  Each tile's r (two planes), g and z
// (two planes) cross once, 5 T J K words, against ~11 operations a node;
// the sweeps are sequential along a chain, so their latency is hidden by
// running many chains at once.
//
// Design (simple first): one block a tile, 256 threads.  g and r's
// wordline plane are staged in shared memory by cp.async (every thread
// keeps its copies in flight at once; rows padded to an odd pitch, so a
// warp's threads walking their own rows hit distinct banks); thread j
// sweeps wordline j, keeping c in a third plane and y, then z, in place
// of r; the z plane goes back coalesced, the bitline plane of r takes
// its place and thread k sweeps bitline k the same way.  The Thomas
// factor comes from g and cw on the fly: no factor plane is read from or
// written to device memory.  Every step rounds as the plain version
// does (separate IEEE multiplies, subtractions and divisions, no fused
// multiply-add), so the two agree bit for bit.  Three planes of shared
// memory: 97.5 KB at 64x64 in f64, two blocks a SM.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ double rmul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float rmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double radd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float radd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double rsub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float rsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double rdiv(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float rdiv(float a, float b) { return __fdiv_rn(a, b); }

// One family's chains: ``n_chains`` chains of ``len`` nodes; node i of
// chain c sits at [c * cs + i * is] in the staged planes (g: gs, r/z:
// rs, factor: fs).  ``r`` is overwritten with z.
template <typename T>
__device__ __forceinline__ void sweep(const T* __restrict__ gs,
                                      T* __restrict__ rs,
                                      T* __restrict__ fs, int n_chains,
                                      int len, int cs, int is, T cw) {
  const int c = threadIdx.x;
  if (c >= n_chains) return;
  const T* g = gs + c * cs;
  T* r = rs + c * cs;
  T* f = fs + c * cs;
  T c_prev = T(0), y_prev = T(0);
#pragma unroll 4
  for (int i = 0; i < len; ++i) {
    const T lo = i > 0 ? -cw : T(0);
    const T hi = i < len - 1 ? -cw : T(0);
    const T d = radd(rmul(cw, T(i < len - 1 ? 2 : 1)), g[i * is]);
    const T denom = rsub(d, rmul(lo, c_prev));
    c_prev = rdiv(hi, denom);
    y_prev = rdiv(rsub(r[i * is], rmul(lo, y_prev)), denom);
    f[i * is] = c_prev;
    r[i * is] = y_prev;
  }
  T z = y_prev;
#pragma unroll 4
  for (int i = len - 2; i >= 0; --i) {
    z = rsub(r[i * is], rmul(f[i * is], z));
    r[i * is] = z;
  }
}

// Stage one (J, K) plane from device memory into a padded plane:
// cp.async of one word an element, all of a thread's copies in flight.
template <typename T>
__device__ __forceinline__ void load_plane(T* s, const T* __restrict__ src,
                                           int J, int K, int pitch) {
  for (int i = threadIdx.x; i < J * K; i += THREADS) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(
        s + (i / K) * pitch + i % K);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
                 "l"(src + i), "n"(sizeof(T)));
  }
}

__device__ __forceinline__ void wait_loads() {
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ void store_plane(T* __restrict__ dst,
                                            const T* s, int J, int K,
                                            int pitch) {
  for (int i = threadIdx.x; i < J * K; i += THREADS)
    dst[i] = s[(i / K) * pitch + i % K];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
line_solve_kernel(const T* __restrict__ g, const T* __restrict__ r,
                  T* __restrict__ z, int J, int K, int pitch, T cw) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* gs = reinterpret_cast<T*>(smem);
  T* rs = gs + J * pitch;
  T* fs = rs + J * pitch;
  const long long t = blockIdx.x;
  const long long JK = (long long)J * K;
  const T* rt = r + 2 * t * JK;
  T* zt = z + 2 * t * JK;

  load_plane(gs, g + t * JK, J, K, pitch);
  load_plane(rs, rt, J, K, pitch);
  wait_loads();
  // Wordlines: chain j along k (contiguous in a row).
  sweep(gs, rs, fs, J, K, pitch, 1, cw);
  __syncthreads();
  store_plane(zt, rs, J, K, pitch);
  __syncthreads();
  load_plane(rs, rt + JK, J, K, pitch);
  wait_loads();
  // Bitlines: chain k along j (a column, stride pitch).
  sweep(gs, rs, fs, K, J, 1, pitch, cw);
  __syncthreads();
  store_plane(zt + JK, rs, J, K, pitch);
}

int pitch_of(int K) { return K | 1; }

template <typename T>
size_t smem_bytes(int J, int K) {
  return 3 * (size_t)J * pitch_of(K) * sizeof(T);
}

template <typename T>
cudaError_t launch(const void* g, const void* r, void* z, long long T_,
                   int J, int K, double cw, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(J, K);
  cudaError_t err = cudaFuncSetAttribute(
      line_solve_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  line_solve_kernel<T><<<(unsigned)T_, THREADS, smem, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(r),
      static_cast<T*>(z), J, K, pitch_of(K), (T)cw);
  return cudaGetLastError();
}

template <typename T>
cudaError_t occupancy(int J, int K, int* out) {
  const size_t smem = smem_bytes<T>(J, K);
  cudaError_t err = cudaFuncSetAttribute(
      line_solve_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, line_solve_kernel<T>, THREADS, smem);
  out[1] = (int)smem;
  out[2] = THREADS;
  return err;
}

}  // namespace

// g (T, J, K), r and z (T, 2, J, K), contiguous, of one dtype: f64 when
// ``f64`` is 1, else f32.  1 <= J, K <= 256; the three staged planes
// must fit in a block's shared memory (the wrapper checks,
// line_solve_smem).
extern "C" int line_solve_launch(const void* g, const void* r, void* z,
                                 long long T, int J, int K, double cw,
                                 int f64, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (J < 1 || K < 1 || J > THREADS || K > THREADS || T < 0 ||
      T > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaSuccess;
  return (int)(f64 ? launch<double>(g, r, z, T, J, K, cw, stream)
                   : launch<float>(g, r, z, T, J, K, cw, stream));
}

// Shared memory a block takes at (J, K) in bytes.
extern "C" long long line_solve_smem(int J, int K, int f64) {
  return (long long)(f64 ? smem_bytes<double>(J, K)
                         : smem_bytes<float>(J, K));
}

// out[0]: resident blocks a SM at (J, K), from the CUDA runtime's
// occupancy calculator; out[1]: shared memory a block; out[2]: threads a
// block.  A failed query leaves no error behind for the next launch.
extern "C" int line_solve_occupancy(int J, int K, int f64, int* out) {
  cudaError_t err = f64 ? occupancy<double>(J, K, out)
                        : occupancy<float>(J, K, out);
  cudaGetLastError();
  return (int)err;
}
