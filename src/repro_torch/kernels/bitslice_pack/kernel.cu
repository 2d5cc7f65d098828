// Bit-plane packing of quantisation codes — the crossbar programming
// image — hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/bitslice_pack/kernel.py::_pack_kernel /
//   bitslice_pack_pallas.
//
// For n signed integer codes (int16 or int32) and K bit planes:
//   out[i, k] = (|code[i]| >> (K - 1 - k)) & 1      (most significant first)
// and under reversed dataflow the planes are mirrored along k:
//   out[i, k] = (|code[i]| >> k) & 1.
//
// What bounds it: a pure streaming pass, 2 or 4 bytes read and K bytes
// written a code, so device memory.  Design: one thread a code in a
// grid-stride loop; at K = 8 (the paper's crossbars) a code's eight
// planes are assembled in two registers and written with one 8-byte
// store, so a warp writes 256 contiguous bytes; other K write byte by
// byte.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename CodeT>
__device__ __forceinline__ uint32_t magnitude(CodeT c) {
  const int v = (int)c;
  return (uint32_t)(v < 0 ? -v : v);
}

template <typename CodeT>
__global__ void pack8_kernel(const CodeT* __restrict__ codes,
                             uint2* __restrict__ out, long long n,
                             int reversed) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < n;
       i += stride) {
    const uint32_t c = magnitude(codes[i]);
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      lo |= ((c >> (reversed ? k : 7 - k)) & 1u) << (8 * k);
      hi |= ((c >> (reversed ? k + 4 : 3 - k)) & 1u) << (8 * k);
    }
    out[i] = make_uint2(lo, hi);
  }
}

template <typename CodeT>
__global__ void pack_kernel(const CodeT* __restrict__ codes,
                            uint8_t* __restrict__ out, long long n, int K,
                            int reversed) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < n;
       i += stride) {
    const uint32_t c = magnitude(codes[i]);
    uint8_t* o = out + i * K;
    for (int k = 0; k < K; ++k)
      o[k] = (uint8_t)((c >> (reversed ? k : K - 1 - k)) & 1u);
  }
}

template <typename CodeT>
void launch(const void* codes, uint8_t* out, long long n, int K,
            int reversed, cudaStream_t stream) {
  const long long want = (n + THREADS - 1) / THREADS;
  const int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
  const CodeT* c = static_cast<const CodeT*>(codes);
  if (K == 8)
    pack8_kernel<CodeT><<<blocks, THREADS, 0, stream>>>(
        c, reinterpret_cast<uint2*>(out), n, reversed);
  else
    pack_kernel<CodeT><<<blocks, THREADS, 0, stream>>>(c, out, n, K,
                                                       reversed);
}

}  // namespace

// ``code_bytes`` is 2 (int16 codes) or 4 (int32); 1 <= K <= 31; ``out``
// is 8-byte aligned.
extern "C" int bitslice_pack_launch(const void* codes, int code_bytes,
                                    uint8_t* out, long long n, int K,
                                    int reversed, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (K < 1 || K > 31 || (code_bytes != 2 && code_bytes != 4))
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    if (code_bytes == 2)
      launch<int16_t>(codes, out, n, K, reversed, stream);
    else
      launch<int32_t>(codes, out, n, K, reversed, stream);
  }
  return (int)cudaGetLastError();
}
