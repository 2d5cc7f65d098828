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
// Every step rounds as the plain version does (separate IEEE multiplies,
// subtractions and divisions, no fused multiply-add, no reciprocal), so
// the two agree bit for bit.  The Thomas factor comes from g and cw on
// the fly: no factor plane is read from or written to device memory.
//
// What bounds it: device memory.  Each tile's r (two planes), g and z
// (two planes) cross once, 5 T J K words, against ~11 operations a node.
// A chain is a sequential recurrence with two divisions a step, so the
// sweeps are latency-bound: the design keeps as many chains in flight
// as an SM holds and overlaps the copies with them.
//
// Two forms (the wrapper, ops.py::geometry, picks one from the shape;
// the launch takes its geometry as the Geom struct below):
//
// * fast (a tile's planes fit in shared memory): persistent blocks, each
//   walking tiles blockIdx.x, + gridDim.x, ...  A block holds `stages`
//   slots of three planes (g, r's wordline plane, r's bitline plane),
//   rows padded to `pitch` (odd by default: a warp's threads walking
//   their own rows hit distinct banks), filled by cp.async (one word a
//   copy at an odd pitch, 16 bytes where the pitch allows).  With two
//   slots (where they leave as many blocks a SM as one) the next tile's
//   planes are in flight while the current one sweeps; with one, the
//   SM's other blocks overlap a block's copies.  Both families sweep at
//   once, in their own warps: thread j of the first ceil(J/32) warps
//   walks wordline j along its row, thread k of the next ceil(K/32)
//   warps walks bitline k down its column; they share the staged g.  y
//   replaces r in place.  For a square tile whose side is a compiled
//   length L (32 and 64; 128 in f32), the factor c lives in registers
//   (a fully unrolled sweep, one call site for both families: two
//   copies of its code overflow the instruction cache); otherwise in
//   two more planes.  The bitline z leaves straight from the back sweep
//   (a warp's threads write consecutive addresses); the wordline z goes
//   back from shared memory with 16-byte stores where K allows.
// * stream (the rest: every crossbar up to 256x256 in f64 and f32):
//   the bitline family reads g and r from device memory down its
//   columns (coalesced) and keeps c in a scratch tensor and y in place
//   of z; the wordline family, the transposed case, stages `chunk`
//   columns of every row of g and r at a time through a two-slot
//   cp.async ring, keeps c and y in scratch laid out column-major (so
//   a warp's stores are coalesced), and sends z back through the ring
//   a chunk at a time.  The two families run independently (the
//   wordline warps synchronise on their own named barrier).  The
//   wrapper allocates the scratch, 3 J K words a block.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 512;   // 8 warps a family at J = K = 256

// The launch geometry, in the order of ops.py's GEOM_FIELDS.
struct Geom {
  int f64, form, reg_len, stages, pitch, vec_load, vec_store, threads,
      smem, chunk, grid;
};
constexpr int FAST = 0, STREAM = 1;

__device__ __forceinline__ double rmul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float rmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double radd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float radd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double rsub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float rsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double rdiv(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float rdiv(float a, float b) { return __fdiv_rn(a, b); }

template <typename T>
constexpr int VEC = 16 / (int)sizeof(T);   // elements of a 16-byte copy

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(BYTES));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A barrier of the first `n` threads (whole warps) of the block.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// (j, u) of flat index e over rows of `cu` units, advanced by a fixed
// stride without a division a step.
struct Walk {
  int j, u, dj, du, cu;
  __device__ Walk(int e, int stride, int cu_)
      : j(e / cu_), u(e % cu_), dj(stride / cu_), du(stride % cu_),
        cu(cu_) {}
  __device__ void next() {
    u += du;
    j += dj;
    if (u >= cu) {
      u -= cu;
      ++j;
    }
  }
};

// Copy a (rows, cols) block, row stride `ld` in device memory, into
// shared memory at row stride `pitch`: units of V elements (cols, ld
// and pitch multiples of V, bases 16-byte aligned, when V > 1), a
// warp's threads on consecutive units.
template <typename T, int V>
__device__ __forceinline__ void copy_in(T* s, int pitch, const T* src,
                                        int ld, int rows, int cols,
                                        int tid, int nthr) {
  const int cu = cols / V, n = rows * cu;
  Walk w(tid, nthr, cu);
  for (int e = tid; e < n; e += nthr, w.next())
    cp_async<V * (int)sizeof(T)>(s + w.j * pitch + w.u * V,
                                 src + (long long)w.j * ld + w.u * V);
}

__device__ __forceinline__ void st_vec(double* p, const double* s) {
  *reinterpret_cast<double2*>(p) = make_double2(s[0], s[1]);
}
__device__ __forceinline__ void st_vec(float* p, const float* s) {
  *reinterpret_cast<float4*>(p) = make_float4(s[0], s[1], s[2], s[3]);
}

// The reverse of copy_in, with plain (V = 1) or 16-byte stores.
template <typename T, int V>
__device__ __forceinline__ void copy_out(T* dst, int ld, const T* s,
                                         int pitch, int rows, int cols,
                                         int tid, int nthr) {
  const int cu = cols / V, n = rows * cu;
  Walk w(tid, nthr, cu);
  for (int e = tid; e < n; e += nthr, w.next()) {
    T* p = dst + (long long)w.j * ld + w.u * V;
    const T* q = s + w.j * pitch + w.u * V;
    if constexpr (V == 1)
      *p = *q;
    else
      st_vec(p, q);
  }
}

// One forward Thomas step at node i of a chain of `len` nodes, exactly
// as the plain version rounds it.
template <typename T>
__device__ __forceinline__ void thomas_step(int i, int len, T cw, T gi,
                                            T ri, T& c_prev, T& y_prev) {
  const T lo = i > 0 ? -cw : T(0);
  const T hi = i < len - 1 ? -cw : T(0);
  const T d = radd(rmul(cw, T(i < len - 1 ? 2 : 1)), gi);
  const T denom = rsub(d, rmul(lo, c_prev));
  c_prev = rdiv(hi, denom);
  y_prev = rdiv(rsub(ri, rmul(lo, y_prev)), denom);
}

// One chain of a compile-time length L >= 2: node i at g[i * gs] and
// r[i * rs] (shared memory), y in place of r, z to z[i * zs], the factor
// c in registers (a fully unrolled sweep).  A batch of BATCH nodes is
// loaded before its steps and stored after them (z may alias r: the
// wordline's z replaces its y in place).
constexpr int BATCH = 8;

template <typename T, int L>
__device__ __forceinline__ void sweep_reg(const T* __restrict__ g, int gs,
                                          T* r, int rs, T cw, T* z, int zs) {
  T c[L];
  T c_prev = T(0), y_prev = T(0);
#pragma unroll
  for (int i0 = 0; i0 < L; i0 += BATCH) {
    T gb[BATCH], rb[BATCH];
#pragma unroll
    for (int q = 0; q < BATCH && i0 + q < L; ++q) {
      gb[q] = g[(i0 + q) * gs];
      rb[q] = r[(i0 + q) * rs];
    }
#pragma unroll
    for (int q = 0; q < BATCH && i0 + q < L; ++q) {
      thomas_step(i0 + q, L, cw, gb[q], rb[q], c_prev, y_prev);
      c[i0 + q] = c_prev;
      r[(i0 + q) * rs] = y_prev;
    }
  }
  T zv = y_prev;
  z[(L - 1) * zs] = zv;
#pragma unroll
  for (int i0 = L - 2; i0 >= 0; i0 -= BATCH) {
    T yb[BATCH];
#pragma unroll
    for (int q = 0; q < BATCH && i0 - q >= 0; ++q) yb[q] = r[(i0 - q) * rs];
#pragma unroll
    for (int q = 0; q < BATCH && i0 - q >= 0; ++q) {
      zv = rsub(yb[q], rmul(c[i0 - q], zv));
      z[(i0 - q) * zs] = zv;
    }
  }
}

// One chain of any length, c in the shared factor plane f (stride rs).
template <typename T>
__device__ __forceinline__ void sweep_plane(const T* __restrict__ g, int gs,
                                            T* r, int rs, T* f, int len,
                                            T cw, T* z, int zs) {
  T c_prev = T(0), y_prev = T(0);
#pragma unroll 4
  for (int i = 0; i < len; ++i) {
    thomas_step(i, len, cw, g[i * gs], r[i * rs], c_prev, y_prev);
    f[i * rs] = c_prev;
    r[i * rs] = y_prev;
  }
  T zv = y_prev;
  z[(len - 1) * zs] = zv;
#pragma unroll 4
  for (int i = len - 2; i >= 0; --i) {
    zv = rsub(r[i * rs], rmul(f[i * rs], zv));
    z[i * zs] = zv;
  }
}

// Stage tile t's g and both r planes (3 planes of J rows at `pitch`).
template <typename T>
__device__ __forceinline__ void load_tile(T* s, int plane, const T* gt,
                                          const T* rt, int J, int K,
                                          int pitch, int vec, int tid,
                                          int nthr) {
  if (vec > 1) {
    copy_in<T, VEC<T>>(s, pitch, gt, K, J, K, tid, nthr);
    copy_in<T, VEC<T>>(s + plane, pitch, rt, K, 2 * J, K, tid, nthr);
  } else {
    copy_in<T, 1>(s, pitch, gt, K, J, K, tid, nthr);
    copy_in<T, 1>(s + plane, pitch, rt, K, 2 * J, K, tid, nthr);
  }
}

template <typename T, int L>
__global__ void __launch_bounds__(L ? 2 * L : MAX_THREADS)
line_fast_kernel(const T* __restrict__ g, const T* __restrict__ r,
                 T* __restrict__ z, T* __restrict__ scratch,
                 long long n_tiles, int J, int K, Geom geo, T cw) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pitch = geo.pitch, plane = J * pitch, stages = geo.stages;
  T* base = reinterpret_cast<T*>(smem);
  const long long JK = (long long)J * K, step = gridDim.x;
  const int tid = threadIdx.x, nthr = blockDim.x;
  // This thread's chain: wordline j = tid along row j of a plane, or
  // (from the next whole warp on) bitline k down column k.
  const int wj = (J + 31) & ~31;
  const bool wl = tid < wj;
  const int ch = wl ? tid : tid - wj;
  const bool active = ch < (wl ? J : K);
  const int len = wl ? K : J, stride = wl ? 1 : pitch;
  const int first = wl ? ch * pitch : ch;
  // The factor planes (L == 0), after the slots: W, then B.
  T* f = base + (3 * stages + (wl ? 0 : 1)) * plane + first;
  long long tile = blockIdx.x;
  for (int s = 0; s < stages; ++s) {
    const long long t = tile + s * step;
    if (t < n_tiles)
      load_tile(base + 3 * s * plane, plane, g + t * JK, r + 2 * t * JK, J,
                K, pitch, geo.vec_load, tid, nthr);
    cp_commit();
  }
  for (int n = 0; tile < n_tiles; ++n, tile += step) {
    T* gs = base + 3 * (n % stages) * plane;
    T* rw = gs + plane;
    if (stages > 1)
      cp_wait<1>();
    else
      cp_wait<0>();
    __syncthreads();
    T* zt = z + 2 * tile * JK;
    // The wordline's z replaces its y; the bitline's goes straight to
    // device memory (a warp's threads on consecutive addresses).
    T* rp = rw + (wl ? 0 : plane) + first;
    if constexpr (L > 0) {
      // One call site for both families: the unrolled sweep's code
      // exists once (twice overflows the instruction cache).
      if (active)
        sweep_reg<T, L>(gs + first, stride, rp, stride, cw,
                        wl ? rp : zt + JK + ch, wl ? stride : K);
    } else if (active && wl) {
      sweep_plane(gs + first, 1, rp, 1, f, len, cw, rp, 1);
    } else if (active) {
      sweep_plane(gs + first, pitch, rp, pitch, f, len, cw, zt + JK + ch,
                  K);
    }
    __syncthreads();
    if (geo.vec_store > 1)
      copy_out<T, VEC<T>>(zt, K, rw, pitch, J, K, tid, nthr);
    else
      copy_out<T, 1>(zt, K, rw, pitch, J, K, tid, nthr);
    __syncthreads();                    // the slot is free
    const long long t = tile + stages * step;
    if (t < n_tiles)
      load_tile(gs, plane, g + t * JK, r + 2 * t * JK, J, K, pitch,
                geo.vec_load, tid, nthr);
    cp_commit();
  }
}

// The stream form's wordline warps (threads 0..wj-1): chunks of `chunk`
// columns of g and r's wordline plane pass through a two-slot ring; c
// and y go to column-major scratch (cW, yW), z back through the ring.
template <typename T>
__device__ __forceinline__ void stream_wordlines(
    T* ring, const T* g, const T* r, T* z, T* scr, long long n_tiles,
    int J, int K, int chunk, T cw, int wj) {
  const int cp = chunk + 1, sp = J * cp, j = threadIdx.x;
  const int nch = (K + chunk - 1) / chunk;
  const long long JK = (long long)J * K;
  T* cW = scr;
  T* yW = scr + JK;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const T* gt = g + tile * JK;
    const T* rt = r + 2 * tile * JK;
    T* zt = z + 2 * tile * JK;
    for (int s = 0; s < 2; ++s) {
      if (s < nch) {
        const int i0 = s * chunk, w = min(chunk, K - i0);
        copy_in<T, 1>(ring + 2 * s * sp, cp, gt + i0, K, J, w, j, wj);
        copy_in<T, 1>(ring + (2 * s + 1) * sp, cp, rt + i0, K, J, w, j, wj);
      }
      cp_commit();
    }
    T c_prev = T(0), y_prev = T(0);
    for (int n = 0; n < nch; ++n) {
      cp_wait<1>();
      bar_sync(1, wj);
      const T* gs = ring + 2 * (n & 1) * sp;
      const T* rs = gs + sp;
      const int i0 = n * chunk, i1 = min(K, i0 + chunk);
      if (j < J) {
        for (int i = i0; i < i1; ++i) {
          thomas_step(i, K, cw, gs[j * cp + i - i0], rs[j * cp + i - i0],
                      c_prev, y_prev);
          cW[(long long)i * J + j] = c_prev;
          yW[(long long)i * J + j] = y_prev;
        }
      }
      bar_sync(1, wj);                  // the slot is free
      if (n + 2 < nch) {
        const int i2 = (n + 2) * chunk, w = min(chunk, K - i2);
        T* s = ring + 2 * (n & 1) * sp;
        copy_in<T, 1>(s, cp, gt + i2, K, J, w, j, wj);
        copy_in<T, 1>(s + sp, cp, rt + i2, K, J, w, j, wj);
      }
      cp_commit();
    }
    cp_wait<0>();
    T zv = y_prev;
    for (int n = nch - 1; n >= 0; --n) {
      T* out = ring + (n & 1) * sp;
      const int i0 = n * chunk, i1 = min(K, i0 + chunk);
      if (j < J) {
        for (int i = i1 - 1; i >= i0; --i) {
          if (i < K - 1)
            zv = rsub(yW[(long long)i * J + j],
                      rmul(cW[(long long)i * J + j], zv));
          out[j * cp + i - i0] = zv;
        }
      }
      bar_sync(1, wj);
      copy_out<T, 1>(zt + i0, K, out, cp, J, i1 - i0, j, wj);
    }
    bar_sync(1, wj);                    // the ring is free for the next tile
  }
}

// The stream form's bitline thread k: straight from device memory; the
// back sweep loads c and y a batch ahead (they come from L2).
constexpr int STREAM_BACK = 8;

template <typename T>
__device__ __forceinline__ void stream_bitline(const T* __restrict__ g,
                                               const T* __restrict__ r, T* z,
                                               T* scr, long long n_tiles,
                                               int J, int K, int k, T cw) {
  const long long JK = (long long)J * K;
  T* cB = scr + 2 * JK + k;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const T* gt = g + tile * JK + k;
    const T* rt = r + (2 * tile + 1) * JK + k;
    T* zt = z + (2 * tile + 1) * JK + k;
    T c_prev = T(0), y_prev = T(0);
#pragma unroll 4
    for (int i = 0; i < J; ++i) {
      thomas_step(i, J, cw, gt[i * K], rt[i * K], c_prev, y_prev);
      cB[i * K] = c_prev;
      zt[i * K] = y_prev;
    }
    T zv = y_prev;
    for (int i0 = J - 2; i0 >= 0; i0 -= STREAM_BACK) {
      T cb[STREAM_BACK], yb[STREAM_BACK];
#pragma unroll
      for (int q = 0; q < STREAM_BACK; ++q)
        if (i0 - q >= 0) {
          cb[q] = cB[(i0 - q) * K];
          yb[q] = zt[(i0 - q) * K];
        }
#pragma unroll
      for (int q = 0; q < STREAM_BACK; ++q)
        if (i0 - q >= 0) {
          zv = rsub(yb[q], rmul(cb[q], zv));
          zt[(i0 - q) * K] = zv;
        }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
line_stream_kernel(const T* __restrict__ g, const T* __restrict__ r,
                   T* __restrict__ z, T* __restrict__ scratch,
                   long long n_tiles, int J, int K, Geom geo, T cw) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int wj = (J + 31) & ~31;
  T* scr = scratch + (long long)blockIdx.x * 3 * J * K;
  if ((int)threadIdx.x < wj) {
    stream_wordlines(reinterpret_cast<T*>(smem), g, r, z, scr, n_tiles, J,
                     K, geo.chunk, cw, wj);
  } else {
    const int k = threadIdx.x - wj;
    if (k < K) stream_bitline(g, r, z, scr, n_tiles, J, K, k, cw);
  }
}

template <typename T>
using KernelFn = void (*)(const T*, const T*, T*, T*, long long, int, int,
                          Geom, T);

template <typename T>
KernelFn<T> pick(const Geom& geo) {
  if (geo.form == STREAM) return line_stream_kernel<T>;
  if (geo.form != FAST) return nullptr;
  switch (geo.reg_len) {
    case 0: return line_fast_kernel<T, 0>;
    case 32: return line_fast_kernel<T, 32>;
    case 64: return line_fast_kernel<T, 64>;
    case 128:
      if constexpr (sizeof(T) == 4) return line_fast_kernel<T, 128>;
      return nullptr;
    default: return nullptr;
  }
}

// The launch's shared memory, threads and layout, checked against the
// geometry the wrapper computed (ops.py::line_geometry).
template <typename T>
bool valid(const Geom& geo, int J, int K) {
  if (J < 1 || K < 1 || J > 256 || K > 256) return false;
  if (geo.threads != 32 * ((J + 31) / 32 + (K + 31) / 32)) return false;
  if (geo.grid < 1) return false;
  const long long word = sizeof(T);
  long long smem;
  if (geo.form == FAST) {
    if (geo.stages < 1 || geo.stages > 2 || geo.pitch < K) return false;
    if (geo.reg_len && (J != geo.reg_len || K != geo.reg_len)) return false;
    const bool vec_ok = K % VEC<T> == 0;
    if (geo.vec_load != 1 && !(geo.vec_load == VEC<T> && vec_ok &&
                               geo.pitch % VEC<T> == 0))
      return false;
    if (geo.vec_store != 1 && !(geo.vec_store == VEC<T> && vec_ok))
      return false;
    smem = (3LL * geo.stages + (geo.reg_len ? 0 : 2)) * J * geo.pitch * word;
  } else if (geo.form == STREAM) {
    if (geo.chunk < 1) return false;
    smem = 4LL * J * (geo.chunk + 1) * word;
  } else {
    return false;
  }
  return smem == geo.smem && smem <= 232448;
}

template <typename T>
cudaError_t launch(const void* g, const void* r, void* z, void* scratch,
                   long long T_, int J, int K, double cw, const Geom& geo,
                   cudaStream_t stream) {
  KernelFn<T> kern = pick<T>(geo);
  if (!kern || !valid<T>(geo, J, K) || (geo.form == STREAM && !scratch))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.smem);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)geo.grid, geo.threads, geo.smem, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(r), static_cast<T*>(z),
      static_cast<T*>(scratch), T_, J, K, geo, (T)cw);
  return cudaGetLastError();
}

template <typename T>
cudaError_t occupancy(const Geom& geo, int* out) {
  KernelFn<T> kern = pick<T>(geo);
  if (!kern) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kern,
                                                        geo.threads,
                                                        geo.smem);
  return err;
}

}  // namespace

// g (T, J, K), r and z (T, 2, J, K), contiguous, of one dtype (f64 when
// geom's f64 is 1, else f32); 1 <= J, K <= 256.  `geom` is the int array
// of the Geom struct; the stream form takes a scratch tensor of 3 J K
// words a block (grid blocks).  A geometry that does not match the
// shape is refused with cudaErrorInvalidValue.
extern "C" int line_solve_launch(const void* g, const void* r, void* z,
                                 void* scratch, long long T, int J, int K,
                                 double cw, const int* geom,
                                 void* stream_ptr) {
  const Geom geo = *reinterpret_cast<const Geom*>(geom);
  if (T < 0) return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaSuccess;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  return (int)(geo.f64 ? launch<double>(g, r, z, scratch, T, J, K, cw, geo,
                                        stream)
                       : launch<float>(g, r, z, scratch, T, J, K, cw, geo,
                                       stream));
}

// out[0]: resident blocks a SM of the launch `geom` describes, from the
// CUDA runtime's occupancy calculator.  A failed query leaves no error
// behind for the next launch.
extern "C" int line_solve_occupancy(const int* geom, int* out) {
  const Geom geo = *reinterpret_cast<const Geom*>(geom);
  cudaError_t err = geo.f64 ? occupancy<double>(geo, out)
                            : occupancy<float>(geo, out);
  cudaGetLastError();
  return (int)err;
}
