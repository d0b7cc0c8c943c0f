// SAME-padded, stride-1 2-D convolution forward for Hopper (sm_90a):
// NHWC x HWIO -> NHWC, fp32 accumulation.
//
// Replaces the Pallas TPU kernel repro/kernels/conv2d.py::conv2d_pallas
// (body _conv2d_kernel, driver _direct_conv).  The TPU kernel tiles the
// grid over (batch image, 128-wide Cout tile) and runs one
// (H*W, Cin) x (Cin, Cout-tile) MXU matmul per tap from a pre-padded
// copy of the input held whole in VMEM.  A Hopper SM has far less fast
// memory, so this kernel is an implicit GEMM instead:
//
//   M = B*H*W output pixels, N = Cout, K = kh*kw*Cin.
//
// An HWIO weight is already the row-major (K, N) matrix, with K in the
// same (i, j, c) order as the numpy backend's im2col.  The A operand is
// never materialised: each block gathers its (BM x BK) slab of im2col
// rows straight from NHWC x, applying the SAME zero padding on the fly
// (no padded copy of x), into shared memory beside the (BK x BN) slab of
// w.  Each of the 256 threads then owns a 4x4 register tile of the
// 64x64 output tile and accumulates with IEEE fp32 FMA (no TF32).
// Ragged M, N and K edges are masked with zeros.
//
// What bounds it: at the paper's C2 layer (Cin = 500, Cout up to 1500,
// 16x16 images) the GEMM does 2*M*N*K operations on few bytes, so the
// fp32 CUDA-core rate bounds it; at C1 (Cin = 3) K is 75 and the kernel
// is small enough that launch and the gather dominate.  This first
// version is plain and right: no tensor cores (the reference is fp32),
// no cp.async/TMA pipelining, no wgmma.  Those are later work.
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface, bound through ctypes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;        // output pixels per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 16;        // reduction slab per shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads, each a 4 x 4 tile
constexpr int APAD = 4;       // shared-memory row pad against bank conflicts

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv2d_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  T* __restrict__ y, int B, int H, int W, int Cin, int Cout,
                  int KH, int KW) {
  __shared__ float As[BK][BM + APAD];
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long HW = (long long)H * W;
  const long long M = (long long)B * HW;
  const int K = KH * KW * Cin;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int ph = KH / 2;
  const int pw = KW / 2;

  // A-slab loader: each thread fills one K column (adjacent threads walk
  // adjacent channels, i.e. adjacent addresses of NHWC x) for 4 rows.
  const int a_k = tid % BK;
  const int a_row = tid / BK;  // 0..15; rows a_row + 16 r
  long long a_base[4];         // offset of pixel (b, 0, 0, 0) in x
  int a_oh[4], a_ow[4];
  bool a_ok[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long m = m0 + a_row + 16 * r;
    a_ok[r] = m < M;
    const long long b = a_ok[r] ? m / HW : 0;
    const long long rem = a_ok[r] ? m - b * HW : 0;
    a_oh[r] = (int)(rem / W);
    a_ow[r] = (int)(rem - (long long)a_oh[r] * W);
    a_base[r] = b * HW * Cin;
  }
  // B-slab loader: adjacent threads walk adjacent output channels.
  const int b_n = tid % BN;
  const int b_k = tid / BN;  // 0..3; rows b_k + 4 r

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    const int k = k0 + a_k;
    const bool k_ok = k < K;
    int di = 0, dj = 0, c = 0;
    if (k_ok) {
      const int tap = k / Cin;
      c = k - tap * Cin;
      di = tap / KW;
      dj = tap - di * KW;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float v = 0.0f;
      const int ih = a_oh[r] + di - ph;
      const int iw = a_ow[r] + dj - pw;
      if (k_ok && a_ok[r] && ih >= 0 && ih < H && iw >= 0 && iw < W) {
        v = to_f32(x[a_base[r] + ((long long)ih * W + iw) * Cin + c]);
      }
      As[a_k][a_row + 16 * r] = v;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int kk = k0 + b_k + 4 * r;
      const int n = n0 + b_n;
      Bs[b_k + 4 * r][b_n] =
          (kk < K && n < Cout) ? to_f32(w[(long long)kk * Cout + n]) : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < Cout) y[m * Cout + n] = from_f32<T>(acc[i][j]);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and y share it).  Returns the
// cudaError_t of the launch (0 on success); the caller raises on non-zero.
extern "C" int conv2d_fwd_launch(const void* x, const void* w, void* y, int B,
                                 int H, int W, int Cin, int Cout, int KH,
                                 int KW, int dtype, void* stream) {
  const long long M = (long long)B * H * W;
  if (M <= 0 || Cout <= 0) return (int)cudaErrorInvalidValue;
  const long long grid_m = (M + BM - 1) / BM;
  const long long grid_n = (Cout + BN - 1) / BN;
  if (grid_m > 2147483647LL || grid_n > 65535LL)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)grid_m, (unsigned)grid_n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    conv2d_fwd_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), B, H, W, Cin, Cout, KH, KW);
  } else if (dtype == 1) {
    conv2d_fwd_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(y),
        B, H, W, Cin, Cout, KH, KW);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* conv2d_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
