// Flash attention forward for Hopper (sm_90a): online softmax over KV
// tiles, causal and sliding-window masks on absolute positions, GQA by
// index, fp32 running max / denominator / accumulator.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attn.py::
// flash_attention_pallas (body _flash_kernel).  The TPU kernel walks a
// grid (batch*heads, q tiles, kv tiles) with the kv axis innermost and
// carries m, l and acc in VMEM scratch from one grid step to the next.
// Hopper blocks run in no order, so here one block owns one
// (batch*head, 64-row q tile) and walks its kv tiles in a loop, with the
// running statistics in registers.  It computes what _flash_kernel
// computes:
//
//   s = (q . k) * D^-1/2, masked to -1e30 where the key lies past T, or
//       after the query (causal), or window or more positions before it;
//   queries are right-aligned: query i sits at position T - S + i;
//   m, l, acc updated per kv tile; out = acc / max(l, 1e-30) in q's dtype.
//
// A masked score contributes exactly 0 to l and acc.  The Pallas
// recurrence instead adds exp(0) terms for a row whose first visited
// tile is fully masked and erases them with alpha = 0 at the first live
// tile; the results agree, and this kernel never relies on the erasure.
// Kv tiles with no live pair for the q tile are not visited (the range
// [k_lo, k_hi] below), so under a window of W the work is O(S*W).
//
// Layout: q is (B, H, S, D) and k, v are (B, KV, T, D), addressed
// through the caller's element strides (the last axis contiguous), so
// the model's (B, S, H, D) projections come in as transposed views
// without a copy; the output is written through strides as well.  Query
// head h reads kv head h / (H / KV), the head order of the JAX package's
// _split_gqa; k and v are never repeated in memory.
//
// What bounds it: 4*D operations per live (query, key) pair against a
// few bytes per row, so operations.  This first version multiplies in
// IEEE fp32 on the CUDA cores (bf16 inputs are loaded as fp32): the
// reference's fp32 parity rules out TF32 tensor cores, and bf16 mma is
// later work.  Its bound is therefore the fp32 rate (67 TFLOP/s), 15x
// below the bf16 tensor-core bound.  256 threads each own a 4 x 4 tile
// of the 64 x 64 score tile and a 4 x (D/16) tile of the accumulator;
// row max and row sum reduce across the 16 lanes that share a row with
// warp shuffles.  Q, K, V and P tiles sit in dynamic shared memory
// (66 KB at D = 64).
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface, bound through ctypes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 64;       // keys per kv tile
constexpr int THREADS = 256;  // 16 x 16 threads, each 4 rows x 4 columns
constexpr float NEG_INF = -1e30f;

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

// floats of dynamic shared memory: Q and K tiles with a +1 row pad
// (threads of a warp read 16 different K rows at one column), V, P.
template <int DP>
constexpr int smem_floats() {
  return BQ * (DP + 1) + BKV * (DP + 1) + BKV * DP + BQ * (BKV + 1);
}

// Loads rows [r0, r0 + 64) of one head of a (.., rows, D) operand into a
// 64 x ld fp32 tile; rows past n_rows and columns past D read as 0.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long row_stride, int r0,
                                          int n_rows, int D) {
  for (int idx = threadIdx.x; idx < 64 * DP; idx += THREADS) {
    const int r = idx / DP;
    const int d = idx - r * DP;
    float val = 0.0f;
    if (r0 + r < n_rows && d < D) val = to_f32(src[(long long)(r0 + r) * row_stride + d]);
    dst[r * ld + d] = val;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int H,
                      int KV, int S, int Tk, int D, long long qsb,
                      long long qsh, long long qss, long long ksb,
                      long long ksh, long long kss, long long vsb,
                      long long vsh, long long vss, long long osb,
                      long long osh, long long oss, float scale, int causal,
                      int window) {
  constexpr int DJ = DP / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * (DP + 1);
  float* Vs = Ks + BKV * (DP + 1);
  float* Ps = Vs + BKV * DP;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * BQ;
  const int q_offset = Tk - S;

  const T* qp = q + b * qsb + h * qsh;
  const T* kp = k + b * ksb + kvh * ksh;
  const T* vp = v + b * vsb + kvh * vsh;

  // the kv range holding a live pair for some valid row of this tile
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + BQ, S) - 1;
  int k_hi = Tk - 1;
  if (causal) k_hi = min(k_hi, q_last);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q_first - window + 1);

  load_tile<T, DP>(Qs, DP + 1, qp, qss, q0, S, D);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = (k_lo / BKV) * BKV; k0 <= k_hi; k0 += BKV) {
    load_tile<T, DP>(Ks, DP + 1, kp, kss, k0, Tk, D);
    load_tile<T, DP>(Vs, DP, vp, vss, k0, Tk, D);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * (DP + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * (DP + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + ty + 16 * i;
      bool live[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        live[j] = kpos < Tk && (!causal || qpos >= kpos) &&
                  (window <= 0 || qpos - kpos < window);
        sc[i][j] = live[j] ? sc[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
      // the 16 lanes sharing row ty + 16 i are one half of a warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = live[j] ? expf(sc[i][j] - m_new) : 0.0f;
        rs += p;
        Ps[(ty + 16 * i) * (BKV + 1) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BKV; ++kk) {
      float pa[4], vb[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[(ty + 16 * i) * (BKV + 1) + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vb[j] = Vs[kk * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pa[i], vb[j], acc[i][j]);
    }
    __syncthreads();  // the next tile overwrites Ks, Vs and Ps
  }

  T* op = o + b * osb + h * osh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= S) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) op[(long long)s * oss + d] = from_f32<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KV, int S, int Tk, int D, const long long* st, int causal,
           int window, cudaStream_t stream) {
  const int smem = smem_floats<DP>() * (int)sizeof(float);
  auto kern = flash_attn_fwd_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((S + BQ - 1) / BQ), (unsigned)(B * H));
  const float scale = (float)(1.0 / sqrt((double)D));
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KV, S, Tk, D, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int H, int KV, int S, int Tk, int D, const long long* st,
             int causal, int window, cudaStream_t stream) {
  if (D <= 16)
    return launch<T, 16>(q, k, v, o, B, H, KV, S, Tk, D, st, causal, window, stream);
  if (D <= 32)
    return launch<T, 32>(q, k, v, o, B, H, KV, S, Tk, D, st, causal, window, stream);
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, B, H, KV, S, Tk, D, st, causal, window, stream);
  return launch<T, 128>(q, k, v, o, B, H, KV, S, Tk, D, st, causal, window, stream);
}

}  // namespace

// q (B,H,S,D), k/v (B,KV,T,D), o (B,H,S,D), each addressed through its
// (batch, head, row) element strides with the D axis contiguous.
// window <= 0 means no window.  dtype: 0 = float32, 1 = bfloat16 (all
// four share it).  Returns the cudaError_t of the launch (0 on success);
// the caller raises on non-zero.
extern "C" int flash_attn_fwd_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
    int S, int Tk, int D, long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, long long osb, long long osh, long long oss, int causal,
    int window, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || S <= 0 || Tk < S ||
      D <= 0 || D > 128 || (long long)B * H > 65535LL)
    return (int)cudaErrorInvalidValue;
  const long long st[12] = {qsb, qsh, qss, ksb, ksh, kss,
                            vsb, vsh, vss, osb, osh, oss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, B, H, KV, S, Tk, D, st, causal, window, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, H, KV, S, Tk, D, st, causal,
                                   window, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attn_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
