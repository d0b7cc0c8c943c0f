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
//   M = B*H*W output pixels, N = Cout, K = kh*kw*Cin,
//   A[m, (i,j,c)] = x[b, h + i - ph, w + j - pw, c],  B[(i,j,c), n] = w[i, j, c, n].
//
// An HWIO weight is already the row-major (K, N) matrix, read in place.
// A is never materialised: each block gathers its slabs of im2col rows
// straight from NHWC x, with the SAME zero padding applied on the fly.
//
// What bounds it: 2*B*H*W*kh*kw*Cin*Cout operations on few bytes, IEEE
// fp32 FMA on the CUDA cores (the reference multiplies fp32 with fp32
// accumulation, which rules out TF32), so the 67 TFLOP/s fp32 rate: 0.17
// to 0.40 ms for the paper's C2 layer on a serving or training shard.  At
// C1 (Cin = 3, K = 75) writing y bounds it.  The design feeds the FMA
// pipes:
// - Tiles.  128 pixels x 128 output channels per block (128 x 64 when
//   Cout <= 64); 256 threads as 16 x 16, each an 8 x 8 patch read from
//   shared memory as float4s: 64 FMAs per 16 shared loads.
// - The K loop walks the flat (tap, channel) index in 8-deep slabs.  A
//   thread copies the same 4 pixels in every slab (decoded once), and the
//   tap and channel of its slab position advance by 8 with no division,
//   so the pad test and the pixel shift are computed once per slab and
//   pixel, not per element.  With Cin a multiple of 8 a slab lies in one
//   tap; at Cin = 500 one may straddle two, each thread's product in one
//   of them.  At Cin = 3 the flat walk packs 8 products of up to 3 taps
//   into a slab: no padding per tap (K = 75 takes 10 slabs, not 25).
// - Staging.  x and w slabs go through a 3-stage ring in shared memory,
//   filled by cp.async, the zero-fill form for the pad and the ragged M,
//   N and K edges.  x's products arrive pixel-major (a pixel's channels
//   are contiguous) but the math reads 4 adjacent pixels of one product
//   as a float4, so x is copied 4 bytes at a time into product-major rows
//   (8 adjacent threads still read a pixel's 32 contiguous bytes); a
//   16-byte copy cannot transpose, and reading pixel-major rows instead
//   took more registers than the 8 x 8 patch leaves (ptxas spilled).  w is
//   copied 16 bytes at a time where its base is 16-byte aligned and Cout a
//   multiple of 4 floats, 4 bytes otherwise (Cout 363 on the training
//   path).  The copy of slab s + 2 is issued right after the one barrier
//   of slab s, before its math.  bf16 inputs are loaded and widened to
//   fp32 as they are staged (cp.async cannot convert).
// - Split of the taps.  Where the output tiles leave the card's block
//   slots idle (a serving shard of the C2 layer has 1,024 pixels: 32
//   tiles on 132 SMs), kernels/conv2d.py::fwd_plan cuts the taps into runs
//   (blockIdx.z), each written to its own fp32 slice of a workspace, and
//   conv2d_fwd_reduce_kernel sums the slices in a fixed order into y in
//   x's dtype.  No float atomics: a rerun gives the same bits.
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface, bound through ctypes.
#include "conv2d_common.cuh"

namespace {

constexpr int BM = 128;       // output pixels per block
constexpr int BK = 8;         // products (flat (tap, channel) indices) per slab
constexpr int STAGES = 3;     // slabs in the cp.async ring
constexpr int THREADS = 256;  // 16 x 16 threads, each an 8 x (NT / 16) patch
constexpr int LDA = BM + 4;   // As row (one product, 128 pixels) + pad: the copies spread banks

// A flat index k = tap * C + c over (tap = di * KW + dj, channel c),
// walked forward without divisions: step(n) moves it n places on.
struct TapWalk {
  int tap, di, dj, c;
  __device__ __forceinline__ void start(int k, int C, int KW) {
    tap = k / C;
    c = k - tap * C;
    di = tap / KW;
    dj = tap - di * KW;
  }
  __device__ __forceinline__ void step(int n, int C, int KW) {
    c += n;
    while (c >= C) {
      c -= C;
      ++tap;
      if (++dj == KW) {
        dj = 0;
        ++di;
      }
    }
  }
};

// One split (blockIdx.z: taps [z * taps_per_split, ...)) of a BM x NT
// tile of y, written to y in T (one split) or to its fp32 slice of ws.
// VB: w copied 16 bytes at a time (Cout % 4 == 0, w 16-byte aligned,
// fp32), else element by element.  Two blocks an SM in fp32 (128
// registers); bf16's loads are widened in registers, which at 128 would
// spill, so bf16 (off the main path) runs one block an SM.
template <typename T, int NT, bool VB>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 4 ? 2 : 1)
conv2d_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                  float* __restrict__ ws, int B, int H, int W, int Cin, int Cout, int KH,
                  int KW, int taps_per_split) {
  constexpr int TN = NT / 16;  // columns per thread
  constexpr int LDB = NT + 4;
  __shared__ __align__(16) float As[STAGES][BK][LDA];  // As[product][pixel]
  __shared__ __align__(16) float Bs[STAGES][BK][LDB];  // Bs[product][channel]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int HW = H * W;
  const int M = B * HW;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * NT;
  const int t0 = blockIdx.z * taps_per_split;
  const int t1 = min(t0 + taps_per_split, KH * KW);
  const int k_begin = t0 * Cin;
  const int k_end = t1 * Cin;
  const int ph = KH / 2;
  const int pw = KW / 2;
  const int n_slabs = (k_end - k_begin + BK - 1) / BK;

  // A loader: product a_k of each slab for pixels a_m + 32 r, copied
  // element by element into the pixel-contiguous rows of As (8 adjacent
  // threads read a pixel's 8 adjacent products: 32 coalesced bytes).
  // Each pixel is decoded once; one out of range gets a row no tap
  // reaches, so the pad test masks it too.
  const int a_k = tid & 7;
  const int a_m = m0 + (tid >> 3);
  int a_oh[4], a_ow[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = a_m + 32 * r;
    const int rem = m % HW;
    a_oh[r] = m < M ? rem / W : -(1 << 20);
    a_ow[r] = rem % W;
  }
  TapWalk ka;  // the thread's product in the slab being copied
  ka.start(k_begin + a_k, Cin, KW);

  // B loader: product row tid / 32 of each slab; channels (tid % 32) * 4
  // (16-byte copies) or tid % 32 + 32 r
  const int b_k = tid >> 5;
  const int b_n = VB ? (tid & 31) * 4 : tid & 31;
  int b_kk = k_begin + b_k;

  auto load_slab = [&](int st) {
    const int sh = (ka.di - ph) * W + (ka.dj - pw);  // the tap's pixel shift
    const bool k_ok = ka.tap < t1;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const bool ok = k_ok && (unsigned)(a_oh[r] + ka.di - ph) < (unsigned)H &&
                      (unsigned)(a_ow[r] + ka.dj - pw) < (unsigned)W;
      copy1(&As[st][a_k][(tid >> 3) + 32 * r],
            ok ? x + (long long)(a_m + 32 * r + sh) * Cin + ka.c : x, ok);
    }
    ka.step(BK, Cin, KW);
    const bool kb = b_kk < k_end;
    const T* b_row = w + (long long)b_kk * Cout + n0 + b_n;
    if constexpr (VB) {
      if (NT == 128 || b_n < NT) {
        const bool ok = kb && n0 + b_n < Cout;
        cp_async16(&Bs[st][b_k][b_n], ok ? b_row : w, ok);
      }
    } else {
#pragma unroll
      for (int r = 0; r < NT / 32; ++r) {
        const bool ok = kb && n0 + b_n + 32 * r < Cout;
        copy1(&Bs[st][b_k][b_n + 32 * r], ok ? b_row + 32 * r : w, ok);
      }
    }
    b_kk += BK;
  };

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_slabs) load_slab(s);
    cp_async_commit();
  }
  int st = 0;  // the stage of slab sl
  for (int sl = 0; sl < n_slabs; ++sl) {
    cp_async_wait<STAGES - 2>();  // slab sl has landed (this thread's copies)
    __syncthreads();              // ... everyone's; and slab sl - 1 is read
    if (sl + STAGES - 1 < n_slabs) load_slab(st == 0 ? STAGES - 1 : st - 1);
    cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], bv[TN];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[st][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[st][kk][64 + ty * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
#pragma unroll
      for (int jj = 0; jj < TN / 4; ++jj) {
        const float4 b4 = *reinterpret_cast<const float4*>(&Bs[st][kk][64 * jj + tx * 4]);
        bv[4 * jj] = b4.x; bv[4 * jj + 1] = b4.y; bv[4 * jj + 2] = b4.z; bv[4 * jj + 3] = b4.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    st = st == STAGES - 1 ? 0 : st + 1;
  }

  float* wsp = ws ? ws + (long long)blockIdx.z * M * Cout : nullptr;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i / 4) * 64 + ty * 4 + (i % 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + (j / 4) * 64 + tx * 4 + (j % 4);
      if (n >= Cout) continue;
      const long long e = (long long)m * Cout + n;
      if (wsp)
        wsp[e] = acc[i][j];
      else
        y[e] = from_f32<T>(acc[i][j]);
    }
  }
}

// y[e] = T(sum over the tap splits of ws), in split order
template <typename T>
__global__ void __launch_bounds__(REDUCE_THREADS)
conv2d_fwd_reduce_kernel(const float* __restrict__ ws, T* __restrict__ y, long long MN,
                         int splits) {
  split_sum<T>(ws, y, MN, splits);
}

template <typename T, int NT>
void launch_tile(bool vb, dim3 grid, cudaStream_t s, const T* x, const T* w, T* y, float* ws,
                 int B, int H, int W, int Cin, int Cout, int KH, int KW, int tps) {
  auto kern = conv2d_fwd_kernel<T, NT, false>;
  if constexpr (sizeof(T) == 4) {
    if (vb) kern = conv2d_fwd_kernel<T, NT, true>;
  }
  kern<<<grid, THREADS, 0, s>>>(x, w, y, ws, B, H, W, Cin, Cout, KH, KW, tps);
}

template <typename T>
int launch_fwd(const void* x, const void* w, void* y, void* ws, int B, int H, int W, int Cin,
               int Cout, int KH, int KW, int bn, int splits, int tps, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
  float* wsp = splits > 1 ? static_cast<float*>(ws) : nullptr;
  const long long M = (long long)B * H * W;
  const long long grid_m = (M + BM - 1) / BM;
  const long long grid_n = (Cout + bn - 1) / bn;
  if (grid_m > 2147483647LL || grid_n > 65535LL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)grid_m, (unsigned)grid_n, (unsigned)splits);
  // 16-byte copies of w need 16-byte aligned rows: an aligned base and
  // Cout a multiple of 4 floats (bf16 is always widened element by element)
  const bool vb = sizeof(T) == 4 && Cout % 4 == 0 && aligned16(w);
  if (bn == 64)
    launch_tile<T, 64>(vb, grid, s, xp, wp, yp, wsp, B, H, W, Cin, Cout, KH, KW, tps);
  else
    launch_tile<T, 128>(vb, grid, s, xp, wp, yp, wsp, B, H, W, Cin, Cout, KH, KW, tps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long MN = M * Cout;
  conv2d_fwd_reduce_kernel<T><<<split_sum_blocks(MN), REDUCE_THREADS, 0, s>>>(wsp, yp, MN,
                                                                             splits);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and y share it).  The plan
// (kernels/conv2d.py::fwd_plan): bn, the N tile (64 or 128); the taps cut
// into `splits` runs of `taps_per_split`.  With one split the kernel
// writes y directly and ws may be null; otherwise ws holds splits *
// B*H*W*Cout floats and a second kernel sums it into y in a fixed order.
// Returns the cudaError_t of the launches (0 on success); the caller
// raises on non-zero.
extern "C" int conv2d_fwd_launch(const void* x, const void* w, void* y, void* ws, int B, int H,
                                 int W, int Cin, int Cout, int KH, int KW, int bn, int splits,
                                 int taps_per_split, int dtype, void* stream) {
  const long long M = (long long)B * H * W;
  const int taps = KH * KW;
  // pixel and product indices are ints: M + 2^20 and K + 64 must fit
  if (M <= 0 || Cin <= 0 || Cout <= 0 || KH <= 0 || KW <= 0 ||
      M > 2147483647LL - (1 << 21) || (long long)taps * Cin > 2147483647LL - 64 ||
      !(bn == 64 || bn == 128) || splits <= 0 || taps_per_split <= 0 ||
      (long long)(splits - 1) * taps_per_split >= taps ||
      (long long)splits * taps_per_split < taps || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (splits > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<float>(x, w, y, ws, B, H, W, Cin, Cout, KH, KW, bn, splits,
                             taps_per_split, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(x, w, y, ws, B, H, W, Cin, Cout, KH, KW, bn, splits,
                                     taps_per_split, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* conv2d_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
