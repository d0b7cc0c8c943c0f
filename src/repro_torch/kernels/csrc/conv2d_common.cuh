// Pieces shared by the conv kernels of conv2d_fwd.cu (K1) and
// conv2d_bwd.cu (K2, K3), and by the SSD scan ssd_fwd.cu (K5): fp32 <->
// storage-type conversion, cp.async copies into shared memory, and the
// fixed-order sum of split-K workspace slices.
//
// Each library compiles its own copy (the header is included, not
// linked); each names its own sum kernel around split_sum below, so a
// profiler trace tells K1's sums from K2's and K3's.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int REDUCE_THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous (L2 only: each byte is staged
// once); zero-filled when !ok, and src is then not read.  Both addresses
// 16-byte aligned.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

// One element into an fp32 shared slot: an asynchronous 4-byte copy for
// fp32, zero-filled when !ok; bf16 is loaded, widened and stored at once
// (cp.async cannot convert).
__device__ __forceinline__ void copy1(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void copy1(float* dst, const __nv_bfloat16* src, bool ok) {
  *dst = ok ? __bfloat162float(*src) : 0.0f;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// out[e] = T(sum over splits z = 0, 1, ... of ws[z * MN + e]), in that
// order: no atomics, so a rerun gives the same bits.
template <typename T>
__device__ __forceinline__ void split_sum(const float* __restrict__ ws, T* __restrict__ out,
                                          long long MN, int splits) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < MN; e += stride) {
    float s = 0.0f;
    for (int z = 0; z < splits; ++z) s += ws[z * MN + e];
    out[e] = from_f32<T>(s);
  }
}

// blocks of REDUCE_THREADS for a split_sum kernel over MN elements
inline unsigned split_sum_blocks(long long MN) {
  const long long blocks = (MN + REDUCE_THREADS - 1) / REDUCE_THREADS;
  return (unsigned)(blocks < 4096 ? blocks : 4096);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

}  // namespace
