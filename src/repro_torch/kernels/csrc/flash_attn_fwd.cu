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
//   queries are right-aligned: query i sits at position T - S + i (with
//       neither mask S may exceed T: the offset is then negative, and
//       no score reads it);
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
// Two kernels, chosen by dtype alone:
//
// bf16 (flash_attn_fwd_kernel_bf16_mma, the model's prefill path).  What
// bounds it: 4*D operations per live (query, key) pair against a few
// bytes per row, so the bf16 tensor-core rate (989 TFLOP/s): 0.0407 ms
// per layer at hymba-1.5b's prefill (B 4, 25 q over 5 kv heads, S = T =
// 2048, D 64, window 1024).  The design: a block of 4 warps owns a
// (batch*head, 64-row q tile); each warp owns 16 query rows and keeps
// their Q fragments in registers for the whole kv loop (ldmatrix, once).
// S = Q K^T runs on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
// accumulate); the mask and the online softmax work on the accumulator
// fragments in registers, a row's max reducing over the 4 lanes of a
// quad with __shfl_xor_sync.  P never goes to shared memory: the S
// fragments are repacked in registers as the A operand of P V, V is
// read with ldmatrix.trans, and O accumulates in fp32 registers.  P is
// split into P_hi = bf16(P) and P_lo = bf16(P - P_hi), and O += P_hi V +
// P_lo V, so about 16 bits of P survive and the output stays within one
// bf16 rounding of the fp32 reference (1.5x the tensor-core work of a
// plain bf16 P V).  K and V tiles are double-buffered in shared memory
// and filled with 16-byte cp.async copies: the copy of tile j+1 is
// issued right after the one barrier of tile j, before its math.  Where
// a base pointer or a stride is not 16-byte aligned, or D is not a
// multiple of 8, the same kernel fills the same layout with scalar
// loads.  Shared-memory rows are padded by 16 bytes so that ldmatrix's
// 8 row reads hit 8 distinct bank groups (46 KB per block at D 64).
//
// fp32 (flash_attn_fwd_kernel, lm_check's path).  The reference's fp32
// parity rules out TF32, so this one multiplies in IEEE fp32 on the
// CUDA cores and is bound by the fp32 rate (67 TFLOP/s).  256 threads
// each own a 4 x 4 tile of the 64 x 64 score tile and a 4 x (D/16) tile
// of the accumulator; row max and row sum reduce across the 16 lanes
// that share a row with warp shuffles.  Q, K, V and P tiles sit in
// dynamic shared memory (66 KB at D = 64).
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

// floats of dynamic shared memory: Q and K tiles with a +1 row pad
// (threads of a warp read 16 different K rows at one column), V, P.
template <int DP>
constexpr int smem_floats() {
  return BQ * (DP + 1) + BKV * (DP + 1) + BKV * DP + BQ * (BKV + 1);
}

// Loads rows [r0, r0 + 64) of one head of a (.., rows, D) operand into a
// 64 x ld fp32 tile; rows past n_rows and columns past D read as 0.
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          long long row_stride, int r0,
                                          int n_rows, int D) {
  for (int idx = threadIdx.x; idx < 64 * DP; idx += THREADS) {
    const int r = idx / DP;
    const int d = idx - r * DP;
    float val = 0.0f;
    if (r0 + r < n_rows && d < D) val = src[(long long)(r0 + r) * row_stride + d];
    dst[r * ld + d] = val;
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, int H,
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

  const float* qp = q + b * qsb + h * qsh;
  const float* kp = k + b * ksb + kvh * ksh;
  const float* vp = v + b * vsb + kvh * vsh;

  // the kv range holding a live pair for some valid row of this tile
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + BQ, S) - 1;
  int k_hi = Tk - 1;
  if (causal) k_hi = min(k_hi, q_last);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q_first - window + 1);

  load_tile<DP>(Qs, DP + 1, qp, qss, q0, S, D);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = (k_lo / BKV) * BKV; k0 <= k_hi; k0 += BKV) {
    load_tile<DP>(Ks, DP + 1, kp, kss, k0, Tk, D);
    load_tile<DP>(Vs, DP, vp, vss, k0, Tk, D);
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

  float* op = o + b * osb + h * osh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= S) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) op[(long long)s * oss + d] = acc[i][j] * inv;
    }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KV, int S, int Tk, int D, const long long* st, int causal,
           int window, cudaStream_t stream) {
  const int smem = smem_floats<DP>() * (int)sizeof(float);
  auto kern = flash_attn_fwd_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((S + BQ - 1) / BQ), (unsigned)(B * H));
  const float scale = (float)(1.0 / sqrt((double)D));
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, KV, S, Tk, D, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], scale, causal, window);
  return (int)cudaGetLastError();
}

int launch_fp32(const void* q, const void* k, const void* v, void* o, int B,
                int H, int KV, int S, int Tk, int D, const long long* st,
                int causal, int window, cudaStream_t stream) {
  if (D <= 16)
    return launch<16>(q, k, v, o, B, H, KV, S, Tk, D, st, causal, window, stream);
  if (D <= 32)
    return launch<32>(q, k, v, o, B, H, KV, S, Tk, D, st, causal, window, stream);
  if (D <= 64)
    return launch<64>(q, k, v, o, B, H, KV, S, Tk, D, st, causal, window, stream);
  return launch<128>(q, k, v, o, B, H, KV, S, Tk, D, st, causal, window, stream);
}

// -- bf16: mma.sync on the tensor cores ---------------------------------------

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int MBQ = 16 * MMA_WARPS;  // query rows per block, 16 per warp
constexpr int MBKV = 64;             // keys per kv tile
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

// bytes of dynamic shared memory: the Q tile and two K and two V tiles,
// each row DP bf16 plus a 16-byte pad
template <int DP>
constexpr int mma_smem_bytes() {
  return (MBQ + 4 * MBKV) * (DP + 8) * (int)sizeof(bf16);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !ok (src is
// then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) -> one register of two bf16, lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// P's two bf16 parts for one A-operand register: hi = bf16(p), lo =
// bf16(p - hi)
__device__ __forceinline__ void split_bf16(float p0, float p1, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(p0 - hf.x, p1 - hf.y);
}

// Rows [r0, r0 + 64) of one head of a (.., rows, D) bf16 operand into a
// 64 x (DP + 8) shared tile; rows past n_rows and columns past D read as
// 0.  vec: 16-byte cp.async copies (aligned base and stride, D % 8 ==
// 0); otherwise scalar loads into the same layout.
template <int DP>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long rs,
                                          int r0, int n_rows, int D, bool vec) {
  constexpr int LD = DP + 8;
  if (vec) {
    constexpr int CH = DP / 8;  // 16-byte chunks per row
    for (int idx = threadIdx.x; idx < 64 * CH; idx += MMA_THREADS) {
      const int r = idx / CH;
      const int c = (idx - r * CH) * 8;
      const bool ok = r0 + r < n_rows && c < D;
      cp_async16(dst + r * LD + c, ok ? src + (long long)(r0 + r) * rs + c : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < 64 * DP; idx += MMA_THREADS) {
      const int r = idx / DP;
      const int c = idx - r * DP;
      bf16 val = __float2bfloat16(0.0f);
      if (r0 + r < n_rows && c < D) val = src[(long long)(r0 + r) * rs + c];
      dst[r * LD + c] = val;
    }
  }
}

// Masks and exponentiates one 16 x 64 score tile of a warp in place
// (scores in log2 units), updating the row max m, the lane's share of
// the row sum l and rescaling the accumulator.  MASKED: some pair of
// this tile may be dead, so each is tested; a dead pair gets p = 0.
template <bool MASKED, int ND>
__device__ __forceinline__ void online_softmax(float s[8][4], float m[2], float l[2],
                                               float o[ND][4], int k0, int t,
                                               int row0, int Tk, int causal,
                                               int window) {
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASKED) {
        const int kpos = k0 + j * 8 + 2 * t + (e & 1);
        const int qpos = row0 + (e >> 1) * 8;
        const bool live = kpos < Tk && (!causal || qpos >= kpos) &&
                          (window <= 0 || qpos - kpos < window);
        if (!live) s[j][e] = NEG_INF;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  float alpha[2], m_new[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    m_new[r] = fmaxf(m[r], mx[r]);
    alpha[r] = exp2f(m[r] - m_new[r]);
    m[r] = m_new[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float p = exp2f(s[j][e] - m_new[r]);
      if (MASKED && s[j][e] == NEG_INF) p = 0.0f;
      s[j][e] = p;
      l[r] += p;
    }
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }
}

template <int DP>
__global__ void __launch_bounds__(MMA_THREADS)
flash_attn_fwd_kernel_bf16_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, bf16* __restrict__ o, int H,
                               int KV, int S, int Tk, int D, long long qsb,
                               long long qsh, long long qss, long long ksb,
                               long long ksh, long long kss, long long vsb,
                               long long vsh, long long vss, long long osb,
                               long long osh, long long oss, float scale_log2,
                               int causal, int window, int vec) {
  constexpr int LD = DP + 8;
  constexpr int KD = DP / 16;  // k-steps of Q K^T
  constexpr int ND = DP / 8;   // 8-column blocks of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + MBQ * LD;   // two buffers
  bf16* Vs = Ks + 2 * MBKV * LD;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // the fragment's row group
  const int t = lane & 3;   // the lane within the quad
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * MBQ;
  const int q_offset = Tk - S;

  const bf16* qp = q + b * qsb + h * qsh;
  const bf16* kp = k + b * ksb + kvh * ksh;
  const bf16* vp = v + b * vsb + kvh * vsh;

  // the kv range holding a live pair for some valid row of this tile
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + MBQ, S) - 1;
  int k_hi = Tk - 1;
  if (causal) k_hi = min(k_hi, q_last);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q_first - window + 1);
  const int k_begin = (k_lo / MBKV) * MBKV;

  load_rows<DP>(Qs, qp, qss, q0, S, D, vec);
  load_rows<DP>(Ks, kp, kss, k_begin, Tk, D, vec);
  load_rows<DP>(Vs, vp, vss, k_begin, Tk, D, vec);
  cp_async_commit();

  unsigned qf[KD][4];
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.0f, 0.0f};
  const int row0 = q_offset + q0 + warp * 16 + g;  // position of row g

  int buf = 0;
  for (int k0 = k_begin; k0 <= k_hi; k0 += MBKV, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // tile k0 has landed; every warp is done with tile k0 - 64
    if (k0 == k_begin) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        ldmatrix_x4(qf[kd], Qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                kd * 16 + (lane >> 4) * 8);
    }
    if (k0 + MBKV <= k_hi) {
      load_rows<DP>(Ks + (buf ^ 1) * MBKV * LD, kp, kss, k0 + MBKV, Tk, D, vec);
      load_rows<DP>(Vs + (buf ^ 1) * MBKV * LD, vp, vss, k0 + MBKV, Tk, D, vec);
      cp_async_commit();
    }
    const bf16* Kb = Ks + buf * MBKV * LD;
    const bf16* Vb = Vs + buf * MBKV * LD;

    // S = Q K^T: 8 blocks of 8 keys, each 4 fp32 per lane
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned kf[4];
        ldmatrix_x4(kf, Kb + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kd * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[kd], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[kd], kf[2], kf[3]);
      }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;

    const bool full = k0 + MBKV <= Tk && (!causal || k0 + MBKV - 1 <= q_first) &&
                      (window <= 0 || q_last - k0 < window);
    if (full)
      online_softmax<false, ND>(s, m, l, acc, k0, t, row0, Tk, causal, window);
    else
      online_softmax<true, ND>(s, m, l, acc, k0, t, row0, Tk, causal, window);

    // O += P_hi V + P_lo V, 16 keys per k-step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        unsigned vf[4];
        ldmatrix_x4_trans(vf, Vb + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                  dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], ph, vf[0], vf[1]);
        mma_bf16(acc[2 * dp], pl, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], ph, vf[2], vf[3]);
        mma_bf16(acc[2 * dp + 1], pl, vf[2], vf[3]);
      }
    }
  }

  bf16* op = o + b * osb + h * osh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int srow = q0 + warp * 16 + g + 8 * r;
    if (srow >= S) continue;
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = n * 8 + 2 * t + e;
        if (d < D) op[(long long)srow * oss + d] = __float2bfloat16(acc[n][2 * r + e] * inv);
      }
  }
}

template <int DP>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B, int H,
               int KV, int S, int Tk, int D, const long long* st, int causal,
               int window, int vec, cudaStream_t stream) {
  const int smem = mma_smem_bytes<DP>();
  auto kern = flash_attn_fwd_kernel_bf16_mma<DP>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((S + MBQ - 1) / MBQ), (unsigned)(B * H));
  const float scale_log2 = (float)(LOG2E / sqrt((double)D));
  kern<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), H, KV, S, Tk, D, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      scale_log2, causal, window, vec);
  return (int)cudaGetLastError();
}

// The bf16 path: cp.async copies where every base pointer is 16-byte
// aligned, every input stride a multiple of 8 elements and D a multiple
// of 8; scalar loads otherwise.
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int H,
                int KV, int S, int Tk, int D, const long long* st, int causal,
                int window, cudaStream_t stream) {
  bool vec = D % 8 == 0 && reinterpret_cast<size_t>(q) % 16 == 0 &&
             reinterpret_cast<size_t>(k) % 16 == 0 &&
             reinterpret_cast<size_t>(v) % 16 == 0;
  for (int i = 0; i < 9; ++i) vec = vec && st[i] % 8 == 0;
  const int vi = vec ? 1 : 0;
  if (D <= 16)
    return launch_mma<16>(q, k, v, o, B, H, KV, S, Tk, D, st, causal, window, vi, stream);
  if (D <= 32)
    return launch_mma<32>(q, k, v, o, B, H, KV, S, Tk, D, st, causal, window, vi, stream);
  if (D <= 64)
    return launch_mma<64>(q, k, v, o, B, H, KV, S, Tk, D, st, causal, window, vi, stream);
  return launch_mma<128>(q, k, v, o, B, H, KV, S, Tk, D, st, causal, window, vi, stream);
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
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || S <= 0 || Tk <= 0 ||
      (Tk < S && (causal || window > 0)) || D <= 0 || D > 128 ||
      (long long)B * H > 65535LL)
    return (int)cudaErrorInvalidValue;
  const long long st[12] = {qsb, qsh, qss, ksb, ksh, kss,
                            vsb, vsh, vss, osb, osh, oss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fp32(q, k, v, o, B, H, KV, S, Tk, D, st, causal, window, s);
  if (dtype == 1)
    return launch_bf16(q, k, v, o, B, H, KV, S, Tk, D, st, causal, window, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attn_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
