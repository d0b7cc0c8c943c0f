// Mamba-2 SSD (state-space duality) chunked scan, forward, for Hopper
// (sm_90a): per (batch, head), the chunks in order with an fp32
// (P x N) state carried from one chunk to the next.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd.py::ssd_pallas (body
// _ssd_kernel).  The TPU kernel walks a grid (batch*heads, chunks) with
// the chunk axis sequential and keeps the state in VMEM scratch; each
// step holds a whole chunk, including its L x L fp32 score matrix
// (256 KB at L = 256), in VMEM.  A Hopper block has at most 227 KB of
// shared memory, and its blocks run in no order, so here one block owns
// one (batch, head) and loops over the chunks itself, and every L x L
// product is cut into 64 x 64 tiles.  Per chunk of L steps starting at
// t0 (a ragged last chunk is masked: its missing steps read dt = 0,
// which leaves the state as it is):
//
//   cum   = inclusive cumsum of dt*a over the chunk (a block scan, fp32)
//   y[t]  = sum_{u<=t} (C_t . B_u) exp(cum_t - cum_u) dt_u x_u    (intra)
//         + exp(cum_t) (C_t . S_prev)                              (inter)
//   S_new = exp(cum_L) S_prev + sum_u exp(cum_L - cum_u) dt_u x_u B_u^T
//
// For each 64-row tile of the chunk's rows the block computes the
// 64 x 64 score tiles of the columns u <= t only (the causal triangle:
// columns past the tile's last row are all zero and skipped), scales
// them by the decay, and accumulates scores x (dt x) into registers.
// What _ssd_kernel returns is y; this kernel also writes the final state
// (B, H, P, N) in fp32, which the model's prefill stores in its decode
// cache (the JAX package takes it from _ssd_chunked on the same path).
//
// Layout: x (B, S, H, P), dt (B, S, H) and B, C (B, S, G, N) are read
// through the caller's element strides (last axis contiguous); head h
// reads group h / (H / G), so the groups are never expanded in memory.
// y is written (B, S, H, P) contiguous in x's dtype.
//
// What bounds it: about 2*L*(L/2)*(N + P) operations per chunk for the
// intra term against (P + 2N + 1) values read per step, so operations on
// the CUDA cores (IEEE fp32 FMA, the reference's precision).  One block
// per (batch, head) loops over the chunks in order; at hymba's
// B*H = 200 that is about 1.5 blocks per SM, one wave.  A chunk-parallel
// two-pass design is later work.
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface, bound through ctypes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TR = 64;        // chunk rows per tile
constexpr int TU = 64;        // chunk columns per tile
constexpr int THREADS = 256;  // 16 x 16 threads, each 4 rows x (PP/16) columns
constexpr int WARPS = THREADS / 32;
// bytes of dynamic shared memory a block may use: the 227 KB a block
// may opt into, less room for the static warp totals
constexpr int MAX_SMEM = 232448 - 1024;

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

// floats of dynamic shared memory: cum (L), the state and its update
// (P x (N+1) each), the C row tile and B column tile (64 x (N+1)), the
// dt*x column tile (64 x PP) and the score tile (64 x 65).
__host__ __device__ inline long long smem_floats(int L, int P, int N, int PP) {
  return (long long)L + 2LL * P * (N + 1) + (long long)(TR + TU) * (N + 1) +
         (long long)TU * PP + (long long)TR * (TU + 1);
}

template <typename T, int PP>
__global__ void __launch_bounds__(THREADS)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const T* __restrict__ bm,
               const T* __restrict__ cm, T* __restrict__ y,
               float* __restrict__ state_out, int S, int H, int G, int P,
               int N, int L, long long xsb, long long xss, long long xsh,
               long long dsb, long long dss, long long dsh, long long bsb,
               long long bss, long long bsg, long long csb, long long css,
               long long csg) {
  constexpr int PJ = PP / 16;  // y columns per thread
  extern __shared__ float smem[];
  const int NP = N + 1;
  float* cum = smem;
  float* St = cum + L;       // state entering the chunk, [p][n]
  float* Sn = St + P * NP;   // state leaving it
  float* Cs = Sn + P * NP;   // [row][n]
  float* Bs = Cs + TR * NP;  // [col][n]
  float* Xs = Bs + TU * NP;  // [col][p] = dt_u x_u
  float* Gs = Xs + TU * PP;  // [row][col]
  __shared__ float warp_tot[WARPS];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int g = h / (H / G);
  const float a_h = a[h];

  const T* xp = x + b * xsb + h * xsh;
  const float* dp = dt + b * dsb + h * dsh;
  const T* bp = bm + b * bsb + g * bsg;
  const T* cp = cm + b * csb + g * csg;
  T* yp = y + ((long long)b * S * H + h) * P;  // (B,S,H,P) contiguous

  for (int e = tid; e < P * NP; e += THREADS) St[e] = 0.0f;

  for (int t0 = 0; t0 < S; t0 += L) {
    const int Lv = min(L, S - t0);

    // -- cum: inclusive block scan of dt*a, 256 steps at a time --------
    __syncthreads();
    float carry = 0.0f;
    for (int seg = 0; seg < L; seg += THREADS) {
      const int u = seg + tid;
      float v = u < Lv ? dp[(long long)(t0 + u) * dss] * a_h : 0.0f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float n = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += n;
      }
      if (lane == 31) warp_tot[warp] = v;
      __syncthreads();
      float before = carry, all = carry;
      for (int w = 0; w < WARPS; ++w) {
        if (w < warp) before += warp_tot[w];
        all += warp_tot[w];
      }
      if (u < L) cum[u] = v + before;
      __syncthreads();
      carry = all;
    }

    // -- y, 64 rows at a time ---------------------------------------------
    for (int r0 = 0; r0 < Lv; r0 += TR) {
      for (int idx = tid; idx < TR * N; idx += THREADS) {
        const int r = idx / N;
        const int n = idx - r * N;
        Cs[r * NP + n] = r0 + r < Lv ? to_f32(cp[(long long)(t0 + r0 + r) * css + n]) : 0.0f;
      }
      __syncthreads();

      float acc[4][PJ];
      // inter-chunk: exp(cum_t) (C_t . S_prev)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = r0 + ty + 16 * i;
        const float et = t < L ? expf(cum[t]) : 0.0f;
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const int p = tx + 16 * j;
          float dot = 0.0f;
          if (p < P)
            for (int n = 0; n < N; ++n)
              dot = fmaf(Cs[(ty + 16 * i) * NP + n], St[p * NP + n], dot);
          acc[i][j] = et * dot;
        }
      }

      // intra-chunk: the column tiles u0 <= the tile's last row
      for (int u0 = 0; u0 < min(r0 + TR, Lv); u0 += TU) {
        for (int idx = tid; idx < TU * N; idx += THREADS) {
          const int c = idx / N;
          const int n = idx - c * N;
          Bs[c * NP + n] = u0 + c < Lv ? to_f32(bp[(long long)(t0 + u0 + c) * bss + n]) : 0.0f;
        }
        for (int idx = tid; idx < TU * PP; idx += THREADS) {
          const int c = idx / PP;
          const int p = idx - c * PP;
          float val = 0.0f;
          if (u0 + c < Lv && p < P) {
            const long long t = t0 + u0 + c;
            val = to_f32(xp[t * xss + p]) * dp[t * dss];
          }
          Xs[c * PP + p] = val;
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int tt = ty + 16 * i;
          const int t = r0 + tt;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int uu = tx + 16 * j;
            const int u = u0 + uu;
            float dot = 0.0f;
            for (int n = 0; n < N; ++n)
              dot = fmaf(Cs[tt * NP + n], Bs[uu * NP + n], dot);
            const bool live = u <= t && t < Lv && u < Lv;
            Gs[tt * (TU + 1) + uu] = live ? dot * expf(cum[t] - cum[u]) : 0.0f;
          }
        }
        __syncthreads();
#pragma unroll 8
        for (int c = 0; c < TU; ++c) {
          float ga[4], xb[PJ];
#pragma unroll
          for (int i = 0; i < 4; ++i) ga[i] = Gs[(ty + 16 * i) * (TU + 1) + c];
#pragma unroll
          for (int j = 0; j < PJ; ++j) xb[j] = Xs[c * PP + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(ga[i], xb[j], acc[i][j]);
        }
        __syncthreads();  // the next column tile overwrites Bs, Xs and Gs
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = r0 + ty + 16 * i;
        if (t >= Lv) continue;
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const int p = tx + 16 * j;
          if (p < P) yp[(long long)(t0 + t) * H * P + p] = from_f32<T>(acc[i][j]);
        }
      }
      __syncthreads();  // the next row tile overwrites Cs
    }

    // -- state: S = exp(total) S_prev + sum_u exp(total - cum_u) dt_u x_u B_u^T
    const float total = cum[L - 1];
    const float et = expf(total);
    for (int e = tid; e < P * N; e += THREADS) {
      const int p = e / N;
      const int n = e - p * N;
      Sn[p * NP + n] = St[p * NP + n] * et;
    }
    for (int u0 = 0; u0 < Lv; u0 += TU) {
      for (int idx = tid; idx < TU * N; idx += THREADS) {
        const int c = idx / N;
        const int n = idx - c * N;
        Bs[c * NP + n] = u0 + c < Lv ? to_f32(bp[(long long)(t0 + u0 + c) * bss + n]) : 0.0f;
      }
      for (int idx = tid; idx < TU * PP; idx += THREADS) {
        const int c = idx / PP;
        const int p = idx - c * PP;
        float val = 0.0f;
        if (u0 + c < Lv && p < P) {
          const long long t = t0 + u0 + c;
          val = to_f32(xp[t * xss + p]) * dp[t * dss] * expf(total - cum[u0 + c]);
        }
        Xs[c * PP + p] = val;
      }
      __syncthreads();
      for (int e = tid; e < P * N; e += THREADS) {
        const int p = e / N;
        const int n = e - p * N;
        float sum = 0.0f;
        for (int c = 0; c < TU; ++c) sum = fmaf(Xs[c * PP + p], Bs[c * NP + n], sum);
        Sn[p * NP + n] += sum;
      }
      __syncthreads();
    }
    for (int e = tid; e < P * NP; e += THREADS) St[e] = Sn[e];
  }
  __syncthreads();

  float* so = state_out + ((long long)b * H + h) * P * N;
  for (int e = tid; e < P * N; e += THREADS) {
    const int p = e / N;
    const int n = e - p * N;
    so[e] = St[p * NP + n];
  }
}

int padded_p(int P) { return P <= 16 ? 16 : P <= 32 ? 32 : P <= 64 ? 64 : 128; }

template <typename T, int PP>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, void* y, void* state, int B, int S, int H, int G,
           int P, int N, int L, const long long* st, cudaStream_t stream) {
  const long long smem = smem_floats(L, P, N, PP) * (long long)sizeof(float);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kern = ssd_fwd_kernel<T, PP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)(B * H), THREADS, (size_t)smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<T*>(y),
      static_cast<float*>(state), S, H, G, P, N, L, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_p(const void* x, const void* dt, const void* a, const void* bm,
             const void* cm, void* y, void* state, int B, int S, int H, int G,
             int P, int N, int L, const long long* st, cudaStream_t stream) {
  switch (padded_p(P)) {
    case 16:
      return launch<T, 16>(x, dt, a, bm, cm, y, state, B, S, H, G, P, N, L, st, stream);
    case 32:
      return launch<T, 32>(x, dt, a, bm, cm, y, state, B, S, H, G, P, N, L, st, stream);
    case 64:
      return launch<T, 64>(x, dt, a, bm, cm, y, state, B, S, H, G, P, N, L, st, stream);
    default:
      return launch<T, 128>(x, dt, a, bm, cm, y, state, B, S, H, G, P, N, L, st, stream);
  }
}

}  // namespace

// Bytes of dynamic shared memory one block needs for a chunk of L steps,
// head_dim P and state size N; the wrapper refuses shapes above the
// 227 KB a block may use.
extern "C" long long ssd_fwd_smem_bytes(int L, int P, int N) {
  return smem_floats(L, P, N, padded_p(P)) * (long long)sizeof(float);
}

// x (B,S,H,P), dt (B,S,H) float32, a (H,) float32, bm/cm (B,S,G,N), each
// addressed through its (batch, step, head-or-group) element strides
// with the last axis contiguous (st: x's three, dt's three, bm's three,
// cm's three); y (B,S,H,P) contiguous in x's dtype; state (B,H,P,N)
// float32 contiguous.  L: the chunk, 1 <= L <= S.  dtype: 0 = float32,
// 1 = bfloat16 (x, bm, cm and y share it).  Returns the cudaError_t of
// the launch (0 on success); the caller raises on non-zero.
extern "C" int ssd_fwd_launch(const void* x, const void* dt, const void* a,
                              const void* bm, const void* cm, void* y,
                              void* state, int B, int S, int H, int G, int P,
                              int N, int L, long long xsb, long long xss,
                              long long xsh, long long dsb, long long dss,
                              long long dsh, long long bsb, long long bss,
                              long long bsg, long long csb, long long css,
                              long long csg, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 ||
      P > 128 || N <= 0 || L <= 0 || L > S || (long long)B * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const long long st[12] = {xsb, xss, xsh, dsb, dss, dsh,
                            bsb, bss, bsg, csb, css, csg};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_p<float>(x, dt, a, bm, cm, y, state, B, S, H, G, P, N, L, st, s);
  if (dtype == 1)
    return launch_p<__nv_bfloat16>(x, dt, a, bm, cm, y, state, B, S, H, G, P, N,
                                   L, st, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ssd_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
