// Host C++ stand-in for <cuda_runtime.h>, so that a kernel source of the
// port compiles with g++ and runs on the CPU (tests/test_torch_traverse_host.py).
//
// A kernel launch `k<<<grid, threads, smem, stream>>>(args)` must first be
// rewritten to `vkrt_launch(k, grid, threads, smem, stream)(args)`; it then
// runs grid * threads blocks of one thread each, one after another, so that
// a block's cooperative shared-memory load still fills its table. A warp is
// one lane: __ballot_sync gives bit 0, __shfl_sync and the reductions give
// the lane's own value, atomics are plain read-modify-writes. Static
// __shared__ arrays become function statics; `extern __shared__` must be
// rewritten to a pointer to vkrt_dynamic_shared. Each float intrinsic with
// an explicit rounding is one IEEE single operation (compile with
// -ffp-contract=off, so that no product is fused into an add).
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

struct float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) { return float4{x, y, z, w}; }

struct vkrt_dim3 {
  unsigned x, y, z;
};
static vkrt_dim3 threadIdx, blockIdx, blockDim, gridDim;
static float vkrt_dynamic_shared[1 << 15];

typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };

// Resident blocks an SM and SMs of the stand-in device: small, so that a
// persistent grid is a few hundred one-thread blocks.
constexpr int kVkrtHostBlocksPerSm = 2, kVkrtHostSms = 1;

inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = kVkrtHostSms;
  return cudaSuccess;
}
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = kVkrtHostBlocksPerSm;
  return cudaSuccess;
}
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  memset(p, v, n);
  return cudaSuccess;
}

inline void __syncthreads() {}
inline unsigned __ballot_sync(unsigned, bool p) { return p ? 1u : 0u; }
template <class T>
inline T __shfl_sync(unsigned, T v, int, int = 32) { return v; }
inline int __reduce_max_sync(unsigned, int v) { return v; }
inline int atomicAdd(int* p, int v) {
  const int old = *p;
  *p = old + v;
  return old;
}
inline int atomicMax(int* p, int v) {
  const int old = *p;
  *p = std::max(old, v);
  return old;
}
inline int __popc(unsigned v) { return __builtin_popcount(v); }
using std::max;
using std::min;

inline float __int_as_float(int v) {
  float f;
  memcpy(&f, &v, sizeof f);
  return f;
}
#define VKRT_ROUNDED(name, op)                              \
  inline float name(float a, float b) {                     \
    volatile float r = a op b;                              \
    return r;                                               \
  }
VKRT_ROUNDED(__fadd_rn, +)
VKRT_ROUNDED(__fsub_rn, -)
VKRT_ROUNDED(__fmul_rn, *)
VKRT_ROUNDED(__fdiv_rn, /)
#undef VKRT_ROUNDED

// `vkrt_launch(k, grid, threads, smem, stream)(args...)`: every thread of
// the grid as a block of one.
template <class F>
struct VkrtLaunch {
  F k;
  unsigned grid, threads;
  template <class... A>
  void operator()(A... a) const {
    const unsigned n = grid * threads;
    gridDim = vkrt_dim3{n, 1, 1};
    blockDim = vkrt_dim3{1, 1, 1};
    threadIdx = vkrt_dim3{0, 0, 0};
    for (unsigned b = 0; b < n; ++b) {
      blockIdx = vkrt_dim3{b, 0, 0};
      k(a...);
    }
  }
};
template <class F>
VkrtLaunch<F> vkrt_launch(F k, unsigned grid, unsigned threads, size_t = 0, cudaStream_t = 0) {
  return VkrtLaunch<F>{k, grid, threads};
}
