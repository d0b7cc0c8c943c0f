// Backward of the SAME-padded, stride-1 2-D convolution for Hopper
// (sm_90a): dX (K2) and dW (K3) of conv2d_fwd.cu's NHWC x HWIO conv,
// fp32 accumulation, fp32 or bf16 inputs.
//
// K2, conv2d_dx_kernel, replaces repro/kernels/conv2d.py::
// conv2d_dx_pallas: there dX is the forward Pallas kernel run on g
// against a flipped, channel-swapped copy of w under the complementary
// pad.  Here it is an implicit GEMM of its own:
//
//   M = B*H*W input pixels, N = Cin, K = kh*kw*Cout,
//   A[m, (i,j,co)] = g[b, h + i - qh, w + j - qw, co]   (qh = kh-1-kh/2)
//   B[(i,j,co), ci] = w[kh-1-i, kw-1-j, ci, co]
//
// A is gathered from NHWC g with the complementary zero pad applied on
// the fly, as conv2d_fwd.cu gathers x.  B is read IN PLACE from the
// HWIO weight: no flipped, transposed copy (75 MB per call at the
// paper's C2 layer).  In HWIO the contiguous axis co lies on K here, not
// on N, so the B slab is staged with adjacent threads walking co
// (coalesced global loads) and stored transposed into shared memory.
//
// K3, conv2d_dw_kernel, replaces conv2d.py::conv2d_dw_pallas (body
// _conv2d_dw_kernel), which accumulates per-tap window(x)^T @ g into the
// output block across a sequential batch grid axis.  Hopper blocks run
// in parallel and in no order, so K3 is a GEMM that contracts pixels:
//
//   M = kh*kw*Cin, N = Cout, K = B*H*W pixels,
//   A[(i,j,ci), p] = x[b, h + i - ph, w + j - pw, ci],  B[p, co] = g[p, co]
//
// Its (M, N) output is the HWIO dW as it lies.  At the paper's C1 layer
// (M = 75) there are too few output tiles to fill 132 SMs, so the pixel
// axis is split into chunks (blockIdx.z), each written to its own slice
// of an fp32 workspace, and conv2d_dw_reduce_kernel then sums the slices
// in a fixed order.  No float atomics: two runs on the same inputs give
// a bit-identical dW, which the batch-axis partition's exact sum of
// per-device dW relies on.
//
// What bounds them: each does the forward's 2*B*H*W*kh*kw*Cin*Cout
// operations on few bytes at C2, so the fp32 CUDA-core rate bounds them
// (TF32 is ruled out by the fp32 tolerance).  Like conv2d_fwd.cu this is
// a plain, right first version: 64x64 output tiles, 16-deep slabs in
// shared memory, a 4x4 register tile per thread, IEEE fp32 FMA, ragged
// M, N and K edges masked with zeros.  No cp.async/TMA or wgmma yet.
// Their reductions are long (37,500 terms for dX at C2, 8,192 pixels for
// dW of a 32-image batch), so each thread sums FOLD slabs (256 terms)
// into a partial tile before adding it to its total: a two-level fp32
// sum whose rounding error stays well inside the fp32 tolerance.
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface, bound through ctypes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;        // output rows per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 16;        // reduction slab per shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads, each a 4 x 4 tile
constexpr int APAD = 4;       // shared-memory row pad against bank conflicts
constexpr int FOLD = 16;      // slabs summed in a partial before folding
constexpr int REDUCE_THREADS = 256;

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

__device__ __forceinline__ void zero(float t[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) t[i][j] = 0.0f;
}

// acc += part; part = 0
__device__ __forceinline__ void fold(float acc[4][4], float part[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[i][j] += part[i][j];
      part[i][j] = 0.0f;
    }
}

// acc += As^T-slab x Bs-slab: thread (ty, tx) owns rows ty + 16 i and
// columns tx + 16 j of the block's 64 x 64 tile.
template <int LDA, int LDB>
__device__ __forceinline__ void mma_slab(const float (*As)[LDA],
                                         const float (*Bs)[LDB], int ty,
                                         int tx, float acc[4][4]) {
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
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv2d_dx_kernel(const T* __restrict__ g, const T* __restrict__ w,
                 T* __restrict__ dx, int B, int H, int W, int Cin, int Cout,
                 int KH, int KW) {
  __shared__ float As[BK][BM + APAD];
  __shared__ float Bs[BK][BN + 1];  // +1: the transposed stores spread banks

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long HW = (long long)H * W;
  const long long M = (long long)B * HW;
  const int K = KH * KW * Cout;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int qh = KH - 1 - KH / 2;  // the complementary pad
  const int qw = KW - 1 - KW / 2;

  // A-slab loader: each thread fills one K column (adjacent threads walk
  // adjacent output channels co, adjacent addresses of NHWC g) for 4 rows.
  const int a_k = tid % BK;
  const int a_row = tid / BK;  // 0..15; rows a_row + 16 r
  long long a_base[4];         // offset of pixel (b, 0, 0, 0) in g
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
    a_base[r] = b * HW * Cout;
  }
  // B-slab loader: adjacent threads walk co (the contiguous HWIO axis,
  // here on K) for 4 input channels each; stored transposed.
  const int b_k = tid % BK;
  const int b_n = tid / BK;  // 0..15; columns b_n + 16 r

  float acc[4][4], part[4][4];
  zero(acc);
  zero(part);
  int slab = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    const int k = k0 + a_k;
    const bool k_ok = k < K;
    int di = 0, dj = 0, co = 0;
    if (k_ok) {
      const int tap = k / Cout;
      co = k - tap * Cout;
      di = tap / KW;
      dj = tap - di * KW;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float v = 0.0f;
      const int ih = a_oh[r] + di - qh;
      const int iw = a_ow[r] + dj - qw;
      if (k_ok && a_ok[r] && ih >= 0 && ih < H && iw >= 0 && iw < W) {
        v = to_f32(g[a_base[r] + ((long long)ih * W + iw) * Cout + co]);
      }
      As[a_k][a_row + 16 * r] = v;
    }

    const int kb = k0 + b_k;
    const bool kb_ok = kb < K;
    long long w_off = 0;  // offset of w[kh-1-i, kw-1-j, 0, co]
    if (kb_ok) {
      const int tap = kb / Cout;
      const int cob = kb - tap * Cout;
      const int dib = tap / KW;
      const int djb = tap - dib * KW;
      w_off = (long long)((KH - 1 - dib) * KW + (KW - 1 - djb)) * Cin * Cout +
              cob;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = n0 + b_n + 16 * r;
      Bs[b_k][b_n + 16 * r] =
          (kb_ok && n < Cin) ? to_f32(w[w_off + (long long)n * Cout]) : 0.0f;
    }
    __syncthreads();
    mma_slab<BM + APAD, BN + 1>(As, Bs, ty, tx, part);
    __syncthreads();
    if (++slab == FOLD) {
      fold(acc, part);
      slab = 0;
    }
  }
  fold(acc, part);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < Cin) dx[m * Cin + n] = from_f32<T>(acc[i][j]);
    }
  }
}

// One pixel chunk [blockIdx.z * chunk, +chunk) of dW, written to
// out + blockIdx.z * M * Cout (the workspace slice, or dW itself when
// there is one chunk).
template <typename T>
__global__ void __launch_bounds__(THREADS)
conv2d_dw_kernel(const T* __restrict__ x, const T* __restrict__ g,
                 float* __restrict__ out, int B, int H, int W, int Cin,
                 int Cout, int KH, int KW, long long chunk) {
  __shared__ float As[BK][BM + APAD];  // As[pixel][row of dW]
  __shared__ float Bs[BK][BN];         // Bs[pixel][co]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long HW = (long long)H * W;
  const long long P = (long long)B * HW;
  const int M = KH * KW * Cin;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const long long p_begin = (long long)blockIdx.z * chunk;
  const long long p_end = p_begin + chunk < P ? p_begin + chunk : P;
  const int ph = KH / 2;
  const int pw = KW / 2;
  out += (long long)blockIdx.z * M * Cout;

  // A-slab loader: each thread owns one dW row (tap i, j and channel ci,
  // decoded once; adjacent threads walk adjacent ci, adjacent addresses
  // of NHWC x) and gathers it at 4 pixels of each slab.
  const int a_m = tid % BM;
  const int a_p = tid / BM;  // 0..3; pixels a_p + 4 q
  const int row = m0 + a_m;
  const bool row_ok = row < M;
  int di = 0, dj = 0, ci = 0;
  if (row_ok) {
    const int tap = row / Cin;
    ci = row - tap * Cin;
    di = tap / KW;
    dj = tap - di * KW;
  }
  // B-slab loader: adjacent threads walk adjacent output channels.
  const int b_n = tid % BN;
  const int b_p = tid / BN;  // 0..3; pixels b_p + 4 q

  float acc[4][4], part[4][4];
  zero(acc);
  zero(part);
  int slab = 0;

  for (long long p0 = p_begin; p0 < p_end; p0 += BK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long p = p0 + a_p + 4 * q;
      float v = 0.0f;
      if (row_ok && p < p_end) {
        const long long b = p / HW;
        const long long rem = p - b * HW;
        const int oh = (int)(rem / W);
        const int ow = (int)(rem - (long long)oh * W);
        const int ih = oh + di - ph;
        const int iw = ow + dj - pw;
        if (ih >= 0 && ih < H && iw >= 0 && iw < W) {
          v = to_f32(x[((b * H + ih) * W + iw) * Cin + ci]);
        }
      }
      As[a_p + 4 * q][a_m] = v;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long p = p0 + b_p + 4 * q;
      const int n = n0 + b_n;
      Bs[b_p + 4 * q][b_n] =
          (p < p_end && n < Cout) ? to_f32(g[p * Cout + n]) : 0.0f;
    }
    __syncthreads();
    mma_slab<BM + APAD, BN>(As, Bs, ty, tx, part);
    __syncthreads();
    if (++slab == FOLD) {
      fold(acc, part);
      slab = 0;
    }
  }
  fold(acc, part);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < Cout) out[(long long)m * Cout + n] = acc[i][j];
    }
  }
}

// dw[e] = sum over chunks z = 0, 1, ... of ws[z * MN + e], in that order.
__global__ void __launch_bounds__(REDUCE_THREADS)
conv2d_dw_reduce_kernel(const float* __restrict__ ws, float* __restrict__ dw,
                        long long MN, int splits) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < MN;
       e += stride) {
    float s = 0.0f;
    for (int z = 0; z < splits; ++z) s += ws[z * MN + e];
    dw[e] = s;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (g, w and dx share it).  Returns the
// cudaError_t of the launch (0 on success); the caller raises on non-zero.
extern "C" int conv2d_dx_launch(const void* g, const void* w, void* dx, int B,
                                int H, int W, int Cin, int Cout, int KH,
                                int KW, int dtype, void* stream) {
  const long long M = (long long)B * H * W;
  if (M <= 0 || Cin <= 0 || Cout <= 0) return (int)cudaErrorInvalidValue;
  const long long grid_m = (M + BM - 1) / BM;
  const long long grid_n = (Cin + BN - 1) / BN;
  if (grid_m > 2147483647LL || grid_n > 65535LL)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)grid_m, (unsigned)grid_n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    conv2d_dx_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(w),
        static_cast<float*>(dx), B, H, W, Cin, Cout, KH, KW);
  } else if (dtype == 1) {
    conv2d_dx_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g),
        static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(dx),
        B, H, W, Cin, Cout, KH, KW);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16 (x and g share it); dw is float32.
// The pixel axis is cut into `splits` chunks of `chunk` pixels.  With one
// chunk the GEMM writes dw directly and ws may be null; otherwise ws holds
// splits * kh*kw*Cin*Cout floats and a second kernel sums it into dw.
extern "C" int conv2d_dw_launch(const void* x, const void* g, void* dw,
                                void* ws, int B, int H, int W, int Cin,
                                int Cout, int KH, int KW, int splits,
                                long long chunk, int dtype, void* stream) {
  const long long P = (long long)B * H * W;
  const long long M = (long long)KH * KW * Cin;
  if (P <= 0 || M <= 0 || Cout <= 0 || splits <= 0 || chunk <= 0 ||
      (long long)(splits - 1) * chunk >= P || (long long)splits * chunk < P ||
      (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long grid_m = (M + BM - 1) / BM;
  const long long grid_n = (Cout + BN - 1) / BN;
  if (grid_m > 2147483647LL || grid_n > 65535LL || splits > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)grid_m, (unsigned)grid_n, (unsigned)splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = splits > 1 ? static_cast<float*>(ws) : static_cast<float*>(dw);
  if (dtype == 0) {
    conv2d_dw_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), out, B, H,
        W, Cin, Cout, KH, KW, chunk);
  } else if (dtype == 1) {
    conv2d_dw_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(g), out, B, H, W, Cin, Cout, KH, KW,
        chunk);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long MN = M * Cout;
  long long blocks = (MN + REDUCE_THREADS - 1) / REDUCE_THREADS;
  if (blocks > 4096) blocks = 4096;
  conv2d_dw_reduce_kernel<<<(unsigned)blocks, REDUCE_THREADS, 0, s>>>(
      static_cast<const float*>(ws), static_cast<float*>(dw), MN, splits);
  return (int)cudaGetLastError();
}

extern "C" const char* conv2d_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
