// Mamba-2 SSD (state-space duality) chunked scan, forward, for Hopper
// (sm_90a), every tile of the sequence at once.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd.py::ssd_pallas (body
// _ssd_kernel).  The TPU kernel walks a grid (batch*heads, chunks) with
// the chunk axis sequential and keeps the (P x N) state in VMEM scratch;
// each step holds a whole chunk, its L x L fp32 score matrix included,
// in VMEM.  Hopper blocks run in parallel and in no order, so no state
// can be carried from one block to the next.  What a stretch of steps
// needs from the ones before it is small: the state entering it.  So the
// scan cuts each chunk into tiles of 64 steps and runs in three kernels:
//
// 1. ssd_fwd_kernel: each tile's local state and total log-decay,
//    every tile at once,
//      dS_k = sum_u exp(total_k - cum_u) dt_u x_u B_u^T    (P x N, fp32)
//    with cum the tile's inclusive cumsum of dt*a and total_k its last
//    value: a small GEMM (N x 64) x (64 x P), into an fp32 workspace.
// 2. ssd_prefix_kernel, grid (B*H): the tiles in order, S <- exp(total_k)
//    S + dS_k, writing the state entering each tile (8 chunks of 4 tiles,
//    32 P x N states at hymba's prefill) and the final state, which the
//    model's prefill keeps for decode.
// 3. ssd_out_kernel: each tile's 64 rows of
//      y[t] = exp(cum_t) (C_t . S_in)                             (inter)
//           + sum_{u<=t in the tile} (C_t . B_u) exp(cum_t - cum_u) dt_u x_u
//    with S_in the state entering the tile.
//
// The same function as the reference's chunks of L: a chunk's intra term
// over its earlier tiles equals their carried state's inter term, so only
// the causal triangle's diagonal 64 x 64 tiles are multiplied out, half
// the operations of a whole chunk's triangle at L = 256 (and the
// decays, differences within 64 steps, lose fewer digits).  Tiles never
// cross a chunk's boundary.  Each pass names its kernel, so a profiler
// trace attributes all three to K5; pass 1 is the one launch counted per
// call.  No float atomics and fixed summation orders: a rerun gives the
// same bits.
//
// What bounds it: per tile, 64*65/2 * 2(N + P) operations for the
// intra term and 4*64*P*N for the state and the inter term, against
// x, B, C, dt read once and y written once: at hymba's widths (P 64,
// N 16, B and C shared by 50 heads) about 18 operations a byte in fp32,
// just below the card's 20 (67 TFLOP/s over 3.35 TB/s), so bytes.  The
// math is IEEE fp32 FMA on the CUDA cores, the reference's precision:
// the model casts x, B and C to fp32 before the scan, as the JAX package
// does, so the main path is fp32.  bf16 inputs are widened to fp32 as
// they are staged and take the same kernels.  The design:
// - Parallelism.  6,400 tiles in passes 1 and 3 at hymba's prefill (B
//   4, H 50, S 2048), against 200 blocks when one block walked the chunks
//   of one (batch, head) in order.  A tile is little work (1,536 FMAs a
//   thread in pass 3), so a block per tile waited on its own copies: one
//   resident wave of blocks walks the tiles instead (tile blockIdx.x, +
//   gridDim.x, ...; the heads of a step range side by side), each
//   staging its next tile while it computes this one.
// - Staging.  dt, x, B, C and the state entering the tile go through
//   shared memory by cp.async: 16-byte copies where the base is 16-byte
//   aligned and the row and its strides are multiples of 4 floats (the
//   model's contiguous fp32 copies, and its strided slices of the
//   in-projection in fp32), 4-byte copies otherwise (dt, strided by H,
//   always); the zero-fill form for padded columns and ragged rows.  bf16
//   elements are loaded one by one and stored widened.  Two stages where
//   shared memory holds them (hymba's widths; not at P 64, N 128), else
//   one.
// - The math.  Each of 256 threads owns a 4-row patch of the tile's
//   64 x P output (64 FMAs per 4 shared loads at P = 64); the decayed
//   score tile goes through shared memory (a row pitch of 66 floats: its
//   transposed stores hit 32 banks); dt_u is folded into the score, so x
//   is staged as it lies.  Pass 1 gives each thread a 4 x 4 patch of dS
//   and splits the tile's 64 steps over the threads left over (4 groups
//   at N 16, P 64), summed in a fixed order.
// - Ragged chunks.  A ragged last chunk's missing steps read dt = 0 and
//   its empty tiles write a zero state, which leave the state as it is
//   (the reference pads them the same way).
//
// Layout: x (B, S, H, P), dt (B, S, H) and B, C (B, S, G, N) are read
// through the caller's element strides (last axis contiguous); head h
// reads group h / (H / G), so the groups are never expanded in memory.
// y is written (B, S, H, P) contiguous in x's dtype.
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface, bound through ctypes.
#include "conv2d_common.cuh"

namespace {

constexpr int TILE = 64;      // chunk rows (steps) per tile, and columns
constexpr int THREADS = 256;  // passes 1-3: 16 x 16 threads, each 4 rows x (PP/16) columns
constexpr int LDG = TILE + 2;  // score tile pitch: transposed stores hit 32 banks
constexpr int PREFIX_BATCH = 8;  // pass 2: tiles whose loads are in flight together
// bytes of dynamic shared memory a block may use: the 227 KB a block
// may opt into, less the 1 KB the runtime reserves
constexpr int MAX_SMEM = 232448 - 1024;

int round4(int v) { return (v + 3) / 4 * 4; }

// shared-memory row pitch of the B and C tiles: N padded to 4 floats,
// plus 4 (16 rows of a 128-bit load spread over the banks)
__host__ __device__ inline int ldn(int NPAD) { return NPAD + 4; }

// 4 x 4 output patches of pass 1's dS (NPAD x PP), and the groups of
// threads its steps are split over (at least one)
__host__ __device__ inline int ds_patches(int NPAD, int PP) { return (NPAD / 4) * (PP / 4); }
__host__ __device__ inline int ds_groups(int NPAD, int PP) {
  const int k = THREADS / ds_patches(NPAD, PP);
  return k > 0 ? k : 1;
}

// Everything the kernels read and write, and the shapes; strides are
// element strides of (batch, step, head-or-group).  The workspace holds
// each tile's local state ds and the state entering it sat ([bh][k][n][p]
// each, N x P floats a tile) and each tile's total log-decay tot.
template <typename T>
struct SsdArgs {
  const T* x;
  const float* dt;
  const float* a;
  const T* bm;
  const T* cm;
  T* y;
  float* state;
  float* ds;
  float* sat;
  float* tot;
  int B, S, H, G, P, N, L;
  int RT;     // 64-step tiles of a chunk
  int tiles;  // tiles of a (batch, head): chunks * RT
  long long xsb, xss, xsh, dsb, dss, dsh, bsb, bss, bsg, csb, css, csg;
  int vec_x, vec_b, vec_c, vec_s;
};

// Tile `id` of the grid-stride walk: the heads of a step range first
// (id = k * B*H + bh), so blocks working side by side read side by side.
// t0 is the tile's first step, n its valid steps (none in a ragged last
// chunk's tail tiles).
struct TileRef {
  int bh, k, b, h, g, t0, n;
  template <typename T>
  __device__ __forceinline__ TileRef(const SsdArgs<T>& A, int id) {
    const int BH = A.B * A.H;
    k = id / BH;
    bh = id - k * BH;
    b = bh / A.H;
    h = bh - b * A.H;
    g = h / (A.H / A.G);
    const int c = k / A.RT;
    const int r0 = (k - c * A.RT) * TILE;
    t0 = c * A.L + r0;
    n = max(0, min(min(TILE, A.L - r0), A.S - t0));
  }
};

// floats of dynamic shared memory of pass 1: cum and the step weights,
// the groups' partial dS, then `stages` of (dt, B tile, x tile)
__host__ __device__ inline int state_stage_floats(int NPAD, int PP) {
  return TILE + TILE * (ldn(NPAD) + PP);
}
__host__ __device__ inline long long state_floats(int NPAD, int PP, int stages) {
  return 2LL * TILE + (long long)ds_groups(NPAD, PP) * NPAD * PP +
         (long long)stages * state_stage_floats(NPAD, PP);
}

// floats of dynamic shared memory of pass 3: cum and dt, the score tile,
// then `stages` of (dt, C, B and x tiles, the state entering the tile)
__host__ __device__ inline int out_stage_floats(int NPAD, int PP) {
  return TILE + 2 * TILE * ldn(NPAD) + TILE * PP + NPAD * PP;
}
__host__ __device__ inline long long out_floats(int NPAD, int PP, int stages) {
  return 2LL * TILE + (long long)TILE * LDG + (long long)stages * out_stage_floats(NPAD, PP);
}

// `rows` rows of shared memory at pitch ld: row r from src + r * rs,
// `cols` columns zero-padded to `cpad`; rows >= nrows read as zeros.
// vec: 16-byte copies (fp32, src 16-byte aligned, cols and rs multiples
// of 4); otherwise element by element.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* src, long long rs,
                                           int rows, int nrows, int cols, int cpad, bool vec) {
  if constexpr (sizeof(T) == 4) {
    if (vec) {
      const int q = cpad / 4;
      for (int idx = threadIdx.x; idx < rows * q; idx += blockDim.x) {
        const int r = idx / q;
        const int c = (idx - r * q) * 4;
        const bool ok = r < nrows && c < cols;
        cp_async16(dst + r * ld + c, ok ? reinterpret_cast<const float*>(src) + r * rs + c
                                        : reinterpret_cast<const float*>(src),
                   ok);
      }
      return;
    }
  }
  for (int idx = threadIdx.x; idx < rows * cpad; idx += blockDim.x) {
    const int r = idx / cpad;
    const int c = idx - r * cpad;
    const bool ok = r < nrows && c < cols;
    copy1(dst + r * ld + c, ok ? src + r * rs + c : src, ok);
  }
}

// four consecutive staged floats
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// A tile's dt (stride dss), 0 past its n valid steps
__device__ __forceinline__ void stage_dt(float* dst, const float* src, long long dss, int n) {
  const int u = threadIdx.x;
  if (u < TILE) copy1(dst + u, u < n ? src + u * dss : src, u < n);
}

// A tile's cum[u] = sum_{v<=u} dt_v a for its 64 steps from its staged
// dt (two warps' inclusive scans, the second then offset by the first's
// total), and dts[u] = dt_u.  Ends with a barrier.
__device__ __forceinline__ void tile_scan(const float* dtr, float a_h, float* cum, float* dts) {
  const int u = threadIdx.x;
  if (u < TILE) {
    const float d = dtr[u];
    float v = d * a_h;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, v, off);
      if (u % 32 >= off) v += o;
    }
    cum[u] = v;
    dts[u] = d;
  }
  __syncthreads();
  if (u >= 32 && u < TILE) cum[u] += cum[31];
  __syncthreads();
}

// Pass 1: each block walks tiles blockIdx.x, + gridDim.x, ... (one
// resident wave, the copies of the next STG - 1 tiles in flight during a
// tile's math).  For each: the tile's local state dS [n][p] (N x P
// floats) into ds and its total log-decay into tot; an empty tile writes
// zeros, which leave the state as it is.
template <typename T, int PP, int STG>
__global__ void __launch_bounds__(THREADS, 2)
ssd_fwd_kernel(const SsdArgs<T> A) {
  const int NPAD = (A.N + 3) / 4 * 4;
  const int LDB = ldn(NPAD);
  const int PN = A.P * A.N;
  const int total_tiles = A.B * A.H * A.tiles;
  const int patches = ds_patches(NPAD, PP);
  const int groups = ds_groups(NPAD, PP);
  const int SZ = state_stage_floats(NPAD, PP);
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) float smem[];
  float* cum = smem;
  float* wts = cum + TILE;
  float* part = wts + TILE;  // [groups][NPAD][PP], each entry written once
  float* stg = part + groups * NPAD * PP;  // STG x (dt [TILE], B [TILE][LDB], x [TILE][PP])
  auto parts = [&](int j, float*& dtr, float*& Bs, float*& Xs) {
    dtr = stg + (j % STG) * SZ;
    Bs = dtr + TILE;
    Xs = Bs + TILE * LDB;
  };

  auto stage = [&](int j) {
    const int id = blockIdx.x + j * gridDim.x;
    if (id >= total_tiles) return;
    const TileRef t(A, id);
    if (t.n == 0) return;
    float *dtr, *Bs, *Xs;
    parts(j, dtr, Bs, Xs);
    stage_dt(dtr, A.dt + t.b * A.dsb + t.h * A.dsh + (long long)t.t0 * A.dss, A.dss, t.n);
    stage_rows(Bs, LDB, A.bm + t.b * A.bsb + t.g * A.bsg + (long long)t.t0 * A.bss, A.bss,
               TILE, t.n, A.N, NPAD, A.vec_b);
    stage_rows(Xs, PP, A.x + t.b * A.xsb + t.h * A.xsh + (long long)t.t0 * A.xss, A.xss,
               TILE, t.n, A.P, PP, A.vec_x);
  };
#pragma unroll
  for (int j = 0; j < STG - 1; ++j) {
    stage(j);
    cp_async_commit();
  }
  // this thread's patches: a group of steps kk, 4 x 4 patches of dS
  const int kk = patches <= THREADS ? tid / patches : 0;
  for (int j = 0; blockIdx.x + j * gridDim.x < total_tiles; ++j) {
    stage(j + STG - 1);
    cp_async_commit();
    cp_async_wait<STG - 1>();  // tile j has landed (this thread's copies)
    __syncthreads();           // ... everyone's
    const TileRef t(A, blockIdx.x + j * gridDim.x);
    float* out = A.ds + ((long long)t.bh * A.tiles + t.k) * PN;
    float* tot = A.tot + (long long)t.bh * A.tiles + t.k;
    if (t.n == 0) {
      for (int e = tid; e < PN; e += THREADS) out[e] = 0.0f;
      if (tid == 0) *tot = 0.0f;
    } else {
      float *dtr, *Bs, *Xs;
      parts(j, dtr, Bs, Xs);
      tile_scan(dtr, A.a[t.h], cum, wts);
      const float total = cum[t.n - 1];
      // the step weights exp(total - cum_u) dt_u (0 past the valid steps)
      if (tid < TILE) wts[tid] = expf(total - cum[tid]) * wts[tid];
      __syncthreads();
      if (kk < groups) {
        for (int pt = patches <= THREADS ? tid - kk * patches : tid; pt < patches;
             pt += patches <= THREADS ? patches : THREADS) {
          const int nq = pt / (PP / 4);
          const int pq = pt - nq * (PP / 4);
          float acc[4][4] = {};
          for (int u = kk; u < TILE; u += groups) {
            const float4 bv = load4(Bs + u * LDB + nq * 4);
            const float4 xv = load4(Xs + u * PP + pq * 4);
            const float w = wts[u];
            const float bb[4] = {bv.x * w, bv.y * w, bv.z * w, bv.w * w};
            const float xx[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(bb[i], xx[jj], acc[i][jj]);
          }
          float* dst = part + ((long long)kk * NPAD + nq * 4) * PP + pq * 4;
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) dst[i * PP + jj] = acc[i][jj];
        }
      }
      __syncthreads();
      for (int e = tid; e < PN; e += THREADS) {
        const int n = e / A.P;
        const int p = e - n * A.P;
        float sum = 0.0f;
        for (int q = 0; q < groups; ++q) sum += part[((long long)q * NPAD + n) * PP + p];
        out[e] = sum;
      }
      if (tid == 0) *tot = total;
    }
    __syncthreads();  // every thread is done with stage j % STG, cum and part
  }
}

// Pass 2: one (batch, head) per block, its tiles in order: the state
// entering tile k, sat[k] = S, then S <- exp(tot_k) S + dS_k; the last S
// is the final state, written (B, H, P, N).
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_prefix_kernel(const SsdArgs<T> A) {
  const int bh = blockIdx.x;
  const long long PN = (long long)A.P * A.N;
  const int tiles = A.tiles;
  const float* dp = A.ds + (long long)bh * tiles * PN;
  const float* tp = A.tot + (long long)bh * tiles;
  float* sp = A.sat + (long long)bh * tiles * PN;
  for (int e = threadIdx.x; e < PN; e += THREADS) {
    float s = 0.0f;
    // PREFIX_BATCH tiles' loads issued together, then their dependent FMAs
    for (int k0 = 0; k0 < tiles; k0 += PREFIX_BATCH) {
      float d[PREFIX_BATCH], f[PREFIX_BATCH];
#pragma unroll
      for (int j = 0; j < PREFIX_BATCH; ++j) {
        const bool ok = k0 + j < tiles;
        d[j] = ok ? dp[(k0 + j) * PN + e] : 0.0f;
        f[j] = ok ? tp[k0 + j] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < PREFIX_BATCH; ++j) {
        if (k0 + j < tiles) {
          sp[(k0 + j) * PN + e] = s;
          s = s * expf(f[j]) + d[j];
        }
      }
    }
    const int n = e / A.P;
    A.state[bh * PN + (long long)(e - n * A.P) * A.N + n] = s;
  }
}

// Pass 3: each block walks tiles blockIdx.x, + gridDim.x, ... as pass 1
// does.  For each: its y, the inter term from the state entering the
// tile plus the intra term of the tile's causal triangle.
template <typename T, int PP, int STG>
__global__ void __launch_bounds__(THREADS, 2)
ssd_out_kernel(const SsdArgs<T> A) {
  constexpr int PJ = PP / 16;  // y columns per thread
  const int NPAD = (A.N + 3) / 4 * 4;
  const int LDN = ldn(NPAD);
  const int total_tiles = A.B * A.H * A.tiles;
  const int SZ = out_stage_floats(NPAD, PP);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  extern __shared__ __align__(16) float smem[];
  float* cum = smem;
  float* dts = cum + TILE;
  float* Gs = dts + TILE;          // [TILE (u)][LDG (t)]
  float* stg = Gs + TILE * LDG;    // STG x (dt, C, B, x, S_in)

  auto stage = [&](int j) {
    const int id = blockIdx.x + j * gridDim.x;
    if (id >= total_tiles) return;
    const TileRef t(A, id);
    if (t.n == 0) return;
    float* dtr = stg + (j % STG) * SZ;
    float* Cs = dtr + TILE;
    float* Bs = Cs + TILE * LDN;
    float* Xs = Bs + TILE * LDN;
    float* Sp = Xs + TILE * PP;
    stage_dt(dtr, A.dt + t.b * A.dsb + t.h * A.dsh + (long long)t.t0 * A.dss, A.dss, t.n);
    stage_rows(Cs, LDN, A.cm + t.b * A.csb + t.g * A.csg + (long long)t.t0 * A.css, A.css,
               TILE, t.n, A.N, NPAD, A.vec_c);
    stage_rows(Bs, LDN, A.bm + t.b * A.bsb + t.g * A.bsg + (long long)t.t0 * A.bss, A.bss,
               TILE, t.n, A.N, NPAD, A.vec_b);
    stage_rows(Xs, PP, A.x + t.b * A.xsb + t.h * A.xsh + (long long)t.t0 * A.xss, A.xss,
               TILE, t.n, A.P, PP, A.vec_x);
    // the state entering the tile, [n][p] rows of P floats
    stage_rows(Sp, PP, A.sat + ((long long)t.bh * A.tiles + t.k) * A.P * A.N, (long long)A.P,
               NPAD, A.N, A.P, PP, A.vec_s);
  };
#pragma unroll
  for (int j = 0; j < STG - 1; ++j) {
    stage(j);
    cp_async_commit();
  }
  for (int j = 0; blockIdx.x + j * gridDim.x < total_tiles; ++j) {
    stage(j + STG - 1);
    cp_async_commit();
    cp_async_wait<STG - 1>();  // tile j has landed (this thread's copies)
    __syncthreads();           // ... everyone's
    const TileRef t(A, blockIdx.x + j * gridDim.x);
    if (t.n > 0) {
      const float* dtr = stg + (j % STG) * SZ;
      const float* Cs = dtr + TILE;
      const float* Bs = Cs + TILE * LDN;
      const float* Xs = Bs + TILE * LDN;
      const float* Sp = Xs + TILE * PP;
      tile_scan(dtr, A.a[t.h], cum, dts);

      // inter: exp(cum_t) (C_t . S_in), rows ty * 4 + i, columns tx * PJ + jj
      float acc[4][PJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < PJ; ++jj) acc[i][jj] = 0.0f;
      for (int n = 0; n < A.N; ++n) {
        float cv[4], sv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty * 4 + i) * LDN + n];
#pragma unroll
        for (int jj = 0; jj < PJ; ++jj) sv[jj] = Sp[n * PP + tx * PJ + jj];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < PJ; ++jj) acc[i][jj] = fmaf(cv[i], sv[jj], acc[i][jj]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float et = expf(cum[ty * 4 + i]);
#pragma unroll
        for (int jj = 0; jj < PJ; ++jj) acc[i][jj] *= et;
      }

      // the decayed scores G[t][u] = (C_t . B_u) exp(cum_t - cum_u) dt_u
      // for u <= t, stored transposed, rows ty + 16 i and columns tx + 16 jj
      {
        float gv[4][4] = {};
        for (int n4 = 0; n4 < NPAD; n4 += 4) {
          float4 bq[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            bq[jj] = *reinterpret_cast<const float4*>(Bs + (tx + 16 * jj) * LDN + n4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 cq = *reinterpret_cast<const float4*>(Cs + (ty + 16 * i) * LDN + n4);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              float v = gv[i][jj];
              v = fmaf(cq.x, bq[jj].x, v);
              v = fmaf(cq.y, bq[jj].y, v);
              v = fmaf(cq.z, bq[jj].z, v);
              gv[i][jj] = fmaf(cq.w, bq[jj].w, v);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int tt = ty + 16 * i;
          const float ct = cum[tt];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int u = tx + 16 * jj;
            Gs[u * LDG + tt] = u <= tt ? gv[i][jj] * expf(ct - cum[u]) * dts[u] : 0.0f;
          }
        }
      }
      __syncthreads();
      // intra: acc += G^T-tile x (x tile)
#pragma unroll 4
      for (int u = 0; u < TILE; ++u) {
        const float2 g01 = *reinterpret_cast<const float2*>(Gs + u * LDG + ty * 4);
        const float2 g23 = *reinterpret_cast<const float2*>(Gs + u * LDG + ty * 4 + 2);
        const float gg[4] = {g01.x, g01.y, g23.x, g23.y};
        float xv[PJ];
        if constexpr (PJ % 4 == 0) {
#pragma unroll
          for (int q = 0; q < PJ / 4; ++q) {
            const float4 v = *reinterpret_cast<const float4*>(Xs + u * PP + tx * PJ + 4 * q);
            xv[4 * q] = v.x;
            xv[4 * q + 1] = v.y;
            xv[4 * q + 2] = v.z;
            xv[4 * q + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int jj = 0; jj < PJ; ++jj) xv[jj] = Xs[u * PP + tx * PJ + jj];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < PJ; ++jj) acc[i][jj] = fmaf(gg[i], xv[jj], acc[i][jj]);
      }

      T* yp = A.y + ((long long)t.b * A.S + t.t0) * A.H * A.P + (long long)t.h * A.P;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tt = ty * 4 + i;
        if (tt >= t.n) continue;
#pragma unroll
        for (int jj = 0; jj < PJ; ++jj) {
          const int p = tx * PJ + jj;
          if (p < A.P) yp[(long long)tt * A.H * A.P + p] = from_f32<T>(acc[i][jj]);
        }
      }
    }
    __syncthreads();  // every thread is done with stage j % STG, cum and Gs
  }
}

int padded_p(int P) { return P <= 16 ? 16 : P <= 32 ? 32 : P <= 64 ? 64 : 128; }

// 16-byte copies of an fp32 operand: its base 16-byte aligned, its row
// (`cols` floats) and its three strides multiples of 4
bool vec_ok(const void* p, int cols, const long long* st3) {
  return aligned16(p) && cols % 4 == 0 && st3[0] % 4 == 0 && st3[1] % 4 == 0 && st3[2] % 4 == 0;
}

// bytes of dynamic shared memory of passes 1 and 3 with `stages` stages
long long state_smem(int N, int PP, int stages) {
  return state_floats(round4(N), PP, stages) * (long long)sizeof(float);
}
long long out_smem(int N, int PP, int stages) {
  return out_floats(round4(N), PP, stages) * (long long)sizeof(float);
}

long long smem_bytes(int P, int N) {
  const int PP = padded_p(P);
  const long long s1 = state_smem(N, PP, 1), s3 = out_smem(N, PP, 1);
  return s1 > s3 ? s1 : s3;
}

// One resident wave of a tile-walking kernel: the blocks an SM holds
// times the SMs, at most `work` blocks
template <typename K>
cudaError_t one_wave(K kern, int threads, long long smem, long long work, unsigned* grid) {
  int dev = 0, sms = 0, per = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, threads, (size_t)smem);
  if (err != cudaSuccess) return err;
  if (per < 1) return cudaErrorInvalidConfiguration;
  const long long n = (long long)per * sms;
  *grid = (unsigned)(n < work ? n : work);
  return cudaSuccess;
}

// Passes 1 and 3 with two stages of staging where they fit, else one
template <typename T, int PP>
int launch(const SsdArgs<T>& A, cudaStream_t stream) {
  const long long work = (long long)A.B * A.H * A.tiles;
  const bool deep1 = state_smem(A.N, PP, 2) <= MAX_SMEM;
  const bool deep3 = out_smem(A.N, PP, 2) <= MAX_SMEM;
  const long long s1 = state_smem(A.N, PP, deep1 ? 2 : 1);
  const long long s3 = out_smem(A.N, PP, deep3 ? 2 : 1);
  if (s1 > MAX_SMEM || s3 > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto k1 = deep1 ? ssd_fwd_kernel<T, PP, 2> : ssd_fwd_kernel<T, PP, 1>;
  auto k3 = deep3 ? ssd_out_kernel<T, PP, 2> : ssd_out_kernel<T, PP, 1>;
  cudaError_t err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s3);
  if (err != cudaSuccess) return (int)err;
  unsigned g1 = 0, g3 = 0;
  err = one_wave(k1, THREADS, s1, work, &g1);
  if (err == cudaSuccess) err = one_wave(k3, THREADS, s3, work, &g3);
  if (err != cudaSuccess) return (int)err;
  k1<<<g1, THREADS, (size_t)s1, stream>>>(A);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_prefix_kernel<T><<<(unsigned)(A.B * A.H), THREADS, 0, stream>>>(A);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k3<<<g3, THREADS, (size_t)s3, stream>>>(A);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(const void* x, const void* dt, const void* a, const void* bm, const void* cm,
             void* y, void* state, void* ws, int B, int S, int H, int G, int P, int N, int L,
             int row_tiles, int tiles, const long long* st, cudaStream_t stream) {
  SsdArgs<T> A;
  A.x = static_cast<const T*>(x);
  A.dt = static_cast<const float*>(dt);
  A.a = static_cast<const float*>(a);
  A.bm = static_cast<const T*>(bm);
  A.cm = static_cast<const T*>(cm);
  A.y = static_cast<T*>(y);
  A.state = static_cast<float*>(state);
  A.B = B, A.S = S, A.H = H, A.G = G, A.P = P, A.N = N, A.L = L;
  A.RT = row_tiles;
  A.tiles = tiles;
  const long long states = (long long)B * H * A.tiles * P * N;
  A.ds = static_cast<float*>(ws);
  A.sat = A.ds + states;
  A.tot = A.sat + states;
  A.xsb = st[0], A.xss = st[1], A.xsh = st[2];
  A.dsb = st[3], A.dss = st[4], A.dsh = st[5];
  A.bsb = st[6], A.bss = st[7], A.bsg = st[8];
  A.csb = st[9], A.css = st[10], A.csg = st[11];
  // 16-byte copies of 4 floats (bf16 is staged element by element)
  const bool f32 = sizeof(T) == 4;
  A.vec_x = f32 && vec_ok(x, P, st);
  A.vec_b = f32 && vec_ok(bm, N, st + 6);
  A.vec_c = f32 && vec_ok(cm, N, st + 9);
  A.vec_s = P % 4 == 0 && aligned16(ws);
  switch (padded_p(P)) {
    case 16:
      return launch<T, 16>(A, stream);
    case 32:
      return launch<T, 32>(A, stream);
    case 64:
      return launch<T, 64>(A, stream);
    default:
      return launch<T, 128>(A, stream);
  }
}

}  // namespace

// Bytes of dynamic shared memory the larger of the tile kernels needs
// for head_dim P and state size N; the wrapper refuses shapes above the
// 227 KB a block may use.
extern "C" long long ssd_fwd_smem_bytes(int P, int N) { return smem_bytes(P, N); }

// x (B,S,H,P), dt (B,S,H) float32, a (H,) float32, bm/cm (B,S,G,N), each
// addressed through its (batch, step, head-or-group) element strides
// with the last axis contiguous (st: x's three, dt's three, bm's three,
// cm's three); y (B,S,H,P) contiguous in x's dtype; state (B,H,P,N)
// float32 contiguous.  L: the chunk, 1 <= L <= S; the wrapper's plan
// (kernels/ssd.py::ssd_plan) gives row_tiles = ceil(L / 64), the tiles
// of a chunk, and tiles = ceil(S / L) * row_tiles, those of a (batch,
// head); ws: B*H*tiles*(2*P*N + 1) floats of workspace.  dtype: 0 =
// float32, 1 = bfloat16 (x, bm, cm and y share it).  Returns the
// cudaError_t of the launches (0 on success); the caller raises on
// non-zero.
extern "C" int ssd_fwd_launch(const void* x, const void* dt, const void* a, const void* bm,
                              const void* cm, void* y, void* state, void* ws, int B, int S,
                              int H, int G, int P, int N, int L, int row_tiles, int tiles,
                              long long xsb, long long xss,
                              long long xsh, long long dsb, long long dss, long long dsh,
                              long long bsb, long long bss, long long bsg, long long csb,
                              long long css, long long csg, int dtype, void* stream) {
  // the plan's tiles must cover the chunk and the steps; tile indices
  // are ints: every (batch, head)'s tiles, and a wave past them, must fit
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 || P > 128 || N <= 0 ||
      L <= 0 || L > S || row_tiles <= 0 || (long long)row_tiles * TILE < L ||
      tiles < row_tiles || tiles % row_tiles != 0 || (long long)(tiles / row_tiles) * L < S ||
      (long long)B * H * tiles > (1LL << 30) || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long st[12] = {xsb, xss, xsh, dsb, dss, dsh, bsb, bss, bsg, csb, css, csg};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_t<float>(x, dt, a, bm, cm, y, state, ws, B, S, H, G, P, N, L, row_tiles,
                           tiles, st, s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(x, dt, a, bm, cm, y, state, ws, B, S, H, G, P, N, L,
                                   row_tiles, tiles, st, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ssd_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
