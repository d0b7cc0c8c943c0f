// Backward of the SAME-padded, stride-1 2-D convolution for Hopper
// (sm_90a): dX (K2) and dW (K3) of conv2d_fwd.cu's NHWC x HWIO conv,
// fp32 accumulation, fp32 or bf16 inputs.
//
// K2, conv2d_dx_kernel (and _small_cin), replaces repro/kernels/conv2d.py::
// conv2d_dx_pallas: there dX is the forward Pallas kernel run on g
// against a flipped, channel-swapped copy of w under the complementary
// pad.  Here it is an implicit GEMM of its own:
//
//   M = B*H*W input pixels, N = Cin, K = kh*kw*Cout,
//   A[m, (i,j,co)] = g[b, h + i - qh, w + j - qw, co]   (qh = kh-1-kh/2)
//   B[(i,j,co), ci] = w[kh-1-i, kw-1-j, ci, co]
//
// A is gathered from NHWC g with the complementary zero pad applied on
// the fly; a tap (i, j) is one shift of the flat pixel index, so the pad
// test and the shift are computed once per tap, not per element.  B is
// read IN PLACE from the HWIO weight: no flipped, transposed copy (75 MB
// per call at the paper's C2 layer).
//
// What bounds it: the forward's 2*B*H*W*kh*kw*Cin*Cout operations on few
// bytes, IEEE fp32 FMA on the CUDA cores (the fp32 tolerance rules out
// TF32), so the 67 TFLOP/s fp32 rate.  The design feeds the FMA pipes:
// - Tiled variant (Cin > 16): 128 x 128 tiles (128 x 64 for Cin <= 64),
//   each of 256 threads an 8 x 8 patch read as float4s (64 FMAs per 16
//   shared loads); the K loop runs tap-major with 8-deep Cout slabs,
//   staged through K1/K3's 3-stage cp.async ring, one barrier per slab.
//   Both operands are contiguous along K (g's and w's output channel)
//   and the math reads them product-major, so both are copied 4 bytes at
//   a time (as K1 copies x), the zero-fill form for padded taps and
//   ragged edges: no slab passes through registers (a register prefetch
//   spilled at 128 registers); each thread sums
//   DX_FOLD slabs (256 terms) in registers before folding them into its
//   running total, a two-level fp32 sum for reductions up to 37,500
//   terms; the totals live in shared memory, so two blocks fit an SM.
// - Small-Cin variant (Cin <= 16; C1's Cin is 3): the N tile is Cin
//   rounded up to 4, 8 or 16, not 64, so at most a quarter of the
//   columns are padding at Cin = 3; each thread holds a segment of 8
//   pixels of one image row (4 at 16 channels) x the padded channels in
//   registers, and walks a kernel row's taps with a sliding window of g,
//   one new pixel per tap; w is staged in shared memory per slab.
// - Split-K: where the output tiles leave the card's block slots idle
//   (the training path's microbatches), the taps are cut into runs, each
//   written to its own fp32 slice of a workspace, and
//   conv2d_dx_reduce_kernel sums the slices in a fixed order and writes
//   dX in g's dtype.  No float atomics: reruns give bit-identical dX.
//   kernels/conv2d.py::dx_plan picks the variant, the tile and the splits
//   from the shapes and the SM count alone.
//
// K3, conv2d_dw_kernel, replaces conv2d.py::conv2d_dw_pallas (body
// _conv2d_dw_kernel), which accumulates per-tap window(x)^T @ g into the
// output block across a sequential batch grid axis.  Hopper blocks run
// in parallel and in no order, so K3 is a GEMM that contracts pixels:
//
//   M = kh*kw*Cin, N = Cout, K = B*H*W pixels,
//   A[(i,j,ci), p] = x[b, h + i - ph, w + j - pw, ci],  B[p, co] = g[p, co]
//
// Its (M, N) output is the HWIO dW as it lies.  What bounds it: the same
// operation count as the forward, IEEE fp32 FMA, so the 67 TFLOP/s fp32
// rate (4.585 ms for the C2 layer at batch 32).  Both operands are rows
// of NHWC tensors read pixel by pixel: a pixel's x row, shifted by a tap,
// holds a run of dW rows (contiguous in ci) and its g row all of dW's
// columns.  So a slab of 8 pixels lands in shared memory in the layout
// the math reads, with no transpose.  The design:
// - Tiles.  128 dW rows x 128 output channels per block (128 x 64 when
//   Cout <= 64); 256 threads, each an 8 x 8 patch read as float4s (64
//   FMAs per 16 shared loads).
// - Index math per block and per slab.  Each thread copies the same dW
//   rows in every slab (4 rows at Cin % 4 == 0, else 4 scattered rows),
//   so their taps and channels are decoded once per block (a row group of
//   4 never straddles two taps when Cin % 4 == 0); its pixel in the slab
//   advances by 8 with no division.  The pad test is one compare pair per
//   (row tap, pixel).
// - Staging.  A 3-stage ring of x and g slabs in shared memory, filled by
//   cp.async: 16-byte copies where the base is 16-byte aligned and the
//   row (Cin for x, Cout for g) a multiple of 4 floats, 4-byte copies
//   otherwise (the training path's Cout 363, 459, 507), and the zero-fill
//   form for padded taps and ragged pixel, row and channel edges.  bf16
//   inputs are loaded and widened as they are staged.
// - Two-level fp32 sum.  Each thread sums DW_FOLD slabs (256 pixels) in
//   registers, then folds them into its running total, which lives in its
//   own column of dynamic shared memory, so two blocks fit an SM.
// - Split of the pixel axis (blockIdx.z).  kernels/conv2d.py::dw_plan
//   picks the split that minimises (waves of blocks over the resident
//   block slots) x (pixels per chunk), in whole slabs, the fp32 workspace
//   capped, from the shapes and the SM count alone.  At the paper's C1
//   layer (M = 75: one row tile, 41% of it padding) the split is what
//   fills the card.  Each chunk writes its own workspace slice and
//   conv2d_dw_reduce_kernel sums the slices in a fixed order.  No float
//   atomics: two runs on the same inputs give a bit-identical dW, which
//   the batch-axis partition's exact sum of per-device dW relies on.
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface, bound through ctypes.
#include "conv2d_common.cuh"

namespace {

// -- K2: dX -------------------------------------------------------------------

constexpr int DX_BM = 128;     // tiled variant: pixels per block
constexpr int DX_BK = 8;       // tiled variant: output channels per slab
constexpr int DX_STAGES = 3;   // tiled variant: slabs in the cp.async ring
constexpr int DX_THREADS = 256;
constexpr int DX_FOLD = 32;    // slabs (256 terms) summed in a partial before folding
constexpr int SC_CO = 4;       // small-Cin variant: output channels per thread per slab
constexpr int SC_TAPS = 25;    // small-Cin variant: taps of w staged in shared memory at once

// Tiled variant (Cin > 16): a DX_BM x NT tile of dX per block, 256
// threads as 16 x 16, each an 8 x (NT / 16) patch read from shared
// memory as float4s.  The K loop runs tap-major, taps [t0, t1) of this
// split (blockIdx.z) outer and Cout in 8-deep slabs inner: the pad test
// and the pixel shift are computed once per tap.  Slabs go through a
// DX_STAGES ring in shared memory, filled by cp.async (4-byte copies:
// both operands are contiguous along K, the output channel, and the
// math reads them product-major), the zero-fill form for padded taps and
// ragged edges; the copy of slab s + 2 is issued right after the one
// barrier of slab s.  Each thread sums DX_FOLD slabs in registers and
// folds them into its total in shared memory.  Writes dX in T (one
// split) or its fp32 slice of the workspace.  Two blocks an SM in fp32
// (128 registers); bf16's loads are widened in registers, so bf16 (off
// the main path) runs one block an SM, as K1's does.
template <typename T, int NT>
__global__ void __launch_bounds__(DX_THREADS, sizeof(T) == 4 ? 2 : 1)
conv2d_dx_kernel(const T* __restrict__ g, const T* __restrict__ w, T* __restrict__ dx,
                 float* __restrict__ ws, int B, int H, int W, int Cin, int Cout, int KH,
                 int KW, int taps_per_split) {
  constexpr int TN = NT / 16;      // columns per thread
  constexpr int BR = NT / 32;      // B-slab columns copied per thread
  constexpr int LDA = DX_BM + 4;   // row pads: the transposing copies spread banks
  constexpr int LDB = NT + 4;
  __shared__ __align__(16) float As[DX_STAGES][DX_BK][LDA];  // As[channel][pixel]
  __shared__ __align__(16) float Bs[DX_STAGES][DX_BK][LDB];  // Bs[channel][ci]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int HW = H * W;
  const int M = B * HW;
  const int m0 = blockIdx.x * DX_BM;
  const int n0 = blockIdx.y * NT;
  const int t0 = blockIdx.z * taps_per_split;
  const int t1 = min(t0 + taps_per_split, KH * KW);
  const int qh = KH - 1 - KH / 2;  // the complementary pad
  const int qw = KW - 1 - KW / 2;
  const int n_slabs = (t1 - t0) * ((Cout + DX_BK - 1) / DX_BK);

  // A copier: 8 adjacent threads copy 8 adjacent output channels
  // (adjacent addresses of NHWC g) of pixels a_m + 32 r; each pixel is
  // decoded once, one out of range gets a row no tap reaches, so the pad
  // test masks it too
  const int a_k = tid % DX_BK;
  const int a_m = m0 + tid / DX_BK;
  int a_oh[4], a_ow[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = a_m + 32 * r;
    const int rem = m % HW;
    a_oh[r] = m < M ? rem / W : -(1 << 20);
    a_ow[r] = rem % W;
  }
  // B copier: 8 adjacent threads copy 8 adjacent co (the contiguous HWIO
  // axis) of input channels b_n + 32 r
  const int b_n = tid / DX_BK;

  // the slab being copied: tap (di, dj), channels [lco, lco + 8)
  int di = t0 / KW, dj = t0 - (t0 / KW) * KW, lco = 0;
  auto load_slab = [&](int st) {
    const int sh = (di - qh) * W + (dj - qw);  // the tap's pixel shift
    const bool ka = lco + a_k < Cout;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const bool ok = ka && (unsigned)(a_oh[r] + di - qh) < (unsigned)H &&
                      (unsigned)(a_ow[r] + dj - qw) < (unsigned)W;
      copy1(&As[st][a_k][tid / DX_BK + 32 * r],
            ok ? g + (long long)(a_m + 32 * r + sh) * Cout + lco + a_k : g, ok);
    }
    // w[kh-1-di, kw-1-dj, n, lco + a_k]
    const T* w_row = w + ((long long)((KH - 1 - di) * KW + (KW - 1 - dj)) * Cin + n0 + b_n) *
                             Cout + lco + a_k;
#pragma unroll
    for (int r = 0; r < BR; ++r) {
      const bool ok = ka && n0 + b_n + 32 * r < Cin;
      copy1(&Bs[st][a_k][b_n + 32 * r], ok ? w_row + (long long)32 * r * Cout : w, ok);
    }
    lco += DX_BK;
    if (lco >= Cout) {
      lco = 0;
      if (++dj == KW) {
        dj = 0;
        ++di;
      }
    }
  };

  // the thread's running total, in its own column of dynamic shared
  // memory (8 * TN floats, DX_THREADS apart): out of the registers, so
  // that two blocks fit on an SM
  extern __shared__ float total[];
  float part[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      part[i][j] = 0.0f;
      total[(i * TN + j) * DX_THREADS + tid] = 0.0f;
    }

#pragma unroll
  for (int s = 0; s < DX_STAGES - 1; ++s) {
    if (s < n_slabs) load_slab(s);
    cp_async_commit();
  }
  int st = 0;  // the stage of slab sl
  int folded = 0;
  for (int sl = 0; sl < n_slabs; ++sl) {
    cp_async_wait<DX_STAGES - 2>();  // slab sl has landed (this thread's copies)
    __syncthreads();                 // ... everyone's; and slab sl - 1 is read
    if (sl + DX_STAGES - 1 < n_slabs) load_slab(st == 0 ? DX_STAGES - 1 : st - 1);
    cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < DX_BK; ++kk) {
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
        for (int j = 0; j < TN; ++j) part[i][j] = fmaf(a[i], bv[j], part[i][j]);
    }
    st = st == DX_STAGES - 1 ? 0 : st + 1;
    if (++folded == DX_FOLD) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          total[(i * TN + j) * DX_THREADS + tid] += part[i][j];
          part[i][j] = 0.0f;
        }
      folded = 0;
    }
  }

  float* wsp = ws ? ws + (long long)blockIdx.z * M * Cin : nullptr;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i / 4) * 64 + ty * 4 + (i % 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + (j / 4) * 64 + tx * 4 + (j % 4);
      if (n >= Cin) continue;
      const float val = total[(i * TN + j) * DX_THREADS + tid] + part[i][j];
      const long long e = (long long)m * Cin + n;
      if (wsp)
        wsp[e] = val;
      else
        dx[e] = from_f32<T>(val);
    }
  }
}

// Small-Cin variant (Cin <= NP, NP of 4, 8 or 16): the N tile is Cin
// rounded up to NP.  256 threads as 16 pixel groups x 16 channel lanes.
// A pixel group is a segment of TM pixels of one image row (rows are cut
// into ceil(W / TM) segments); a thread holds TM pixels x NP input
// channels in registers and, for each slab of 64 output channels, sums
// its 4 channels (lane + 16 c) over the taps of this split (blockIdx.y).
// Along a kernel row the taps (i, j) and (i, j + 1) read the segment's g
// shifted by one pixel, so the thread keeps a sliding window of TM pixels
// x 4 channels in registers: one new pixel (4 loads) per tap instead of
// TM, with the pad applied as the pixel is loaded.  g is read straight
// into registers (16 lanes, 16 adjacent channels of one pixel: 64
// coalesced bytes); w is staged in shared memory for SC_TAPS taps of the
// slab at a time, a lane's NP channels of one output channel read as
// float4s (not NP strided loads, 2-byte ones for bf16).  At the end the
// 16 channel lanes of a
// pixel group, one half-warp, sum their partials with a butterfly of
// shuffles (a fixed order: every lane ends with the same bits).
template <typename T, int NP>
__global__ void __launch_bounds__(DX_THREADS, NP == 4 ? 2 : 1)
conv2d_dx_kernel_small_cin(const T* __restrict__ g, const T* __restrict__ w,
                           T* __restrict__ dx, float* __restrict__ ws, int B, int H,
                           int W, int Cin, int Cout, int KH, int KW, int taps_per_split) {
  constexpr int TM = NP == 16 ? 4 : 8;  // pixels per segment
  const int tid = threadIdx.x;
  const int kl = tid % 16;  // channel lane
  const int pg = tid / 16;  // pixel group
  const int nseg = (W + TM - 1) / TM;
  const long long rows = (long long)B * H;
  const long long M = rows * W;
  const long long seg = (long long)blockIdx.x * 16 + pg;
  const bool seg_ok = seg < rows * nseg;
  const long long row = seg_ok ? seg / nseg : 0;  // b * H + oh
  const int ow0 = seg_ok ? (int)(seg - row * nseg) * TM : 0;
  const int oh = (int)(row % H);
  const int t0 = blockIdx.y * taps_per_split;
  const int t1 = min(t0 + taps_per_split, KH * KW);
  const int qh = KH - 1 - KH / 2;
  const int qw = KW - 1 - KW / 2;
  const long long wtap = (long long)Cin * Cout;  // one tap of w

  float acc[TM][NP];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < NP; ++c) acc[i][c] = 0.0f;

  // w[kh-1-i, kw-1-j, ci, co0 + col] of up to SC_TAPS taps, at
  // wsm[(tap - c0) * 64 + col][ci]: a lane reads its NP channels as float4s
  extern __shared__ __align__(16) float wsm[];
  for (int co0 = 0; co0 < Cout; co0 += 16 * SC_CO) {
    bool co_ok[SC_CO];
#pragma unroll
    for (int c = 0; c < SC_CO; ++c) co_ok[c] = co0 + kl + 16 * c < Cout;
    for (int c0 = t0; c0 < t1; c0 += SC_TAPS) {
      const int c1 = min(c0 + SC_TAPS, t1);
      __syncthreads();  // every thread is done with the last chunk's w
      for (int tap = c0; tap < c1; ++tap) {
        const int wi = tap / KW;
        const T* wt = w + (long long)((KH - 1 - wi) * KW + (KW - 1 - (tap - wi * KW))) * wtap + co0;
        for (int e = tid; e < 64 * NP; e += DX_THREADS) {
          const int col = e % 64;  // adjacent threads, adjacent co: coalesced
          const int ci = e / 64;
          wsm[((tap - c0) * 64 + col) * NP + ci] =
              (ci < Cin && co0 + col < Cout) ? to_f32(wt[(long long)ci * Cout + col]) : 0.0f;
        }
      }
      __syncthreads();
      int di = c0 / KW;
      int dj = c0 - di * KW;
      for (int tap = c0; tap < c1; ++di, dj = 0) {
        const int dj_end = min(KW, dj + (c1 - tap));  // this row's taps: [dj, dj_end)
        tap += dj_end - dj;
        const int ih = oh + di - qh;
        const bool row_ok = seg_ok && (unsigned)ih < (unsigned)H;
        // g[b, ih, 0, co0 + kl]: only dereferenced where row_ok
        const T* src = g + (row_ok ? (row + di - qh) * W * Cout : 0) + co0 + kl;
        float win[TM][SC_CO];  // g at pixels ow0 + i + j - qw of row ih
        auto load = [&](int slot, int iw) {
          const bool ok = row_ok && (unsigned)iw < (unsigned)W;
          const T* p = src + (long long)iw * Cout;
#pragma unroll
          for (int c = 0; c < SC_CO; ++c)
            win[slot][c] = (ok && co_ok[c]) ? to_f32(p[16 * c]) : 0.0f;
        };
#pragma unroll
        for (int i = 0; i < TM - 1; ++i) load(i, ow0 + i + dj - qw);
        for (int j = dj; j < dj_end; ++j) {
          load(TM - 1, ow0 + TM - 1 + j - qw);
          const float* wrow = wsm + ((di * KW + j - c0) * 64 + kl) * NP;
          float wv[SC_CO][NP];
#pragma unroll
          for (int c = 0; c < SC_CO; ++c)
#pragma unroll
            for (int q = 0; q < NP / 4; ++q) {
              const float4 f = *reinterpret_cast<const float4*>(wrow + 16 * c * NP + 4 * q);
              wv[c][4 * q] = f.x;
              wv[c][4 * q + 1] = f.y;
              wv[c][4 * q + 2] = f.z;
              wv[c][4 * q + 3] = f.w;
            }
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int c = 0; c < SC_CO; ++c)
#pragma unroll
              for (int ci = 0; ci < NP; ++ci) acc[i][ci] = fmaf(win[i][c], wv[c][ci], acc[i][ci]);
#pragma unroll
          for (int i = 0; i < TM - 1; ++i)
#pragma unroll
            for (int c = 0; c < SC_CO; ++c) win[i][c] = win[i + 1][c];
        }
      }
    }
  }

  float* wsp = ws ? ws + (long long)blockIdx.y * M * Cin : nullptr;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int ci = 0; ci < NP; ++ci) {
      float v = acc[i][ci];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      acc[i][ci] = v;
    }
  // lane kl writes elements e = kl, kl + 16, ... of the TM x NP patch
  const long long m0 = row * W + ow0;
#pragma unroll
  for (int e = 0; e < TM * NP; ++e) {
    if ((e & 15) != kl) continue;
    const int i = e / NP;
    const int ci = e % NP;
    if (!seg_ok || ow0 + i >= W || ci >= Cin) continue;
    const long long m = m0 + i;
    if (wsp)
      wsp[m * Cin + ci] = acc[i][ci];
    else
      dx[m * Cin + ci] = from_f32<T>(acc[i][ci]);
  }
}

// dx[e] = T(sum over the tap splits of ws), in split order
template <typename T>
__global__ void __launch_bounds__(REDUCE_THREADS)
conv2d_dx_reduce_kernel(const float* __restrict__ ws, T* __restrict__ dx, long long MN,
                        int splits) {
  split_sum<T>(ws, dx, MN, splits);
}

template <typename T>
int launch_dx(const void* g, const void* w, void* dx, void* ws, int B, int H, int W,
              int Cin, int Cout, int KH, int KW, int bn, int splits, int tps,
              cudaStream_t s) {
  const T* gp = static_cast<const T*>(g);
  const T* wp = static_cast<const T*>(w);
  T* dxp = static_cast<T*>(dx);
  float* wsp = splits > 1 ? static_cast<float*>(ws) : nullptr;
  const long long M = (long long)B * H * W;
  if (bn <= 16) {
    const int seg = bn == 16 ? 4 : 8;  // the kernel's TM: pixels per row segment
    const long long segs = (long long)B * H * ((W + seg - 1) / seg);
    const long long grid_m = (segs + 15) / 16;
    if (grid_m > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
    const dim3 grid((unsigned)grid_m, (unsigned)splits);
    // w staged for up to SC_TAPS taps x 64 output channels x bn
    const int w_bytes = (tps < SC_TAPS ? tps : SC_TAPS) * 64 * bn * (int)sizeof(float);
    auto kern = bn == 4 ? conv2d_dx_kernel_small_cin<T, 4>
                : bn == 8 ? conv2d_dx_kernel_small_cin<T, 8>
                          : conv2d_dx_kernel_small_cin<T, 16>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, w_bytes);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, DX_THREADS, w_bytes, s>>>(gp, wp, dxp, wsp, B, H, W, Cin, Cout, KH, KW, tps);
  } else {
    const long long grid_m = (M + DX_BM - 1) / DX_BM;
    const long long grid_n = (Cin + bn - 1) / bn;
    if (grid_m > 2147483647LL || grid_n > 65535LL)
      return (int)cudaErrorInvalidConfiguration;
    const dim3 grid((unsigned)grid_m, (unsigned)grid_n, (unsigned)splits);
    // the threads' totals: 8 x bn/16 floats each
    const int total_bytes = 8 * (bn / 16) * DX_THREADS * (int)sizeof(float);
    auto kern = bn == 64 ? conv2d_dx_kernel<T, 64> : conv2d_dx_kernel<T, 128>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, total_bytes);
    if (err != cudaSuccess) return (int)err;
    // no carveout hint: the default L1/shared split leaves more L1 for
    // g's rows, which 25 taps reread (the shared-memory-side hint ran
    // slower on the card)
    kern<<<grid, DX_THREADS, total_bytes, s>>>(gp, wp, dxp, wsp, B, H, W, Cin, Cout, KH, KW,
                                               tps);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long MN = M * Cin;
  conv2d_dx_reduce_kernel<T><<<split_sum_blocks(MN), REDUCE_THREADS, 0, s>>>(wsp, dxp, MN,
                                                                           splits);
  return (int)cudaGetLastError();
}

// -- K3: dW -------------------------------------------------------------------

constexpr int DW_BM = 128;     // dW rows ((tap, ci) pairs) per block
constexpr int DW_BK = 8;       // pixels per slab
constexpr int DW_STAGES = 3;   // slabs in the cp.async ring
constexpr int DW_THREADS = 256;
constexpr int DW_FOLD = 32;    // slabs (256 pixels) summed in registers before folding

// bytes of dynamic shared memory: the ring of A and B slabs, then the
// threads' running totals (8 x NT/16 floats each)
template <int NT>
constexpr int dw_smem_bytes() {
  return (DW_STAGES * DW_BK * (DW_BM + NT) + 8 * (NT / 16) * DW_THREADS) * (int)sizeof(float);
}

// One pixel chunk [blockIdx.z * chunk, +chunk) of a DW_BM x NT tile of
// dW, written to out + blockIdx.z * M * Cout (the workspace slice, or dW
// itself when there is one chunk).  VA: x copied 16 bytes at a time (Cin
// % 4 == 0, x 16-byte aligned, fp32), else element by element; VB: the
// same for g (Cout % 4 == 0).
template <typename T, int NT, bool VA, bool VB>
__global__ void __launch_bounds__(DW_THREADS, 2)
conv2d_dw_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ out,
                 int B, int H, int W, int Cin, int Cout, int KH, int KW, long long chunk) {
  constexpr int TN = NT / 16;     // columns per thread
  constexpr int AR = VA ? 1 : 4;  // row groups each thread copies per slab
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                               // [stage][pixel][dW row]
  float* Bs = As + DW_STAGES * DW_BK * DW_BM;     // [stage][pixel][channel]
  float* total = Bs + DW_STAGES * DW_BK * NT;     // [8 * TN][DW_THREADS]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int HW = H * W;
  const long long P = (long long)B * HW;
  const int M = KH * KW * Cin;
  const int m0 = blockIdx.x * DW_BM;
  const int n0 = blockIdx.y * NT;
  const long long p_begin = (long long)blockIdx.z * chunk;
  const long long p_end = p_begin + chunk < P ? p_begin + chunk : P;
  const int n_slabs = (int)((p_end - p_begin + DW_BK - 1) / DW_BK);
  out += (long long)blockIdx.z * M * Cout;

  // every copy of this thread is of pixel tid / 32 of the slab: p, at
  // (oh, ow) of its image, walked 8 pixels on per slab
  const int s_px = tid >> 5;
  long long p = p_begin + s_px;
  int oh, ow;
  {
    const int rem = (int)(p % HW);
    oh = rem / W;
    ow = rem - oh * W;
  }
  // A loader: dW rows a_row (4 of them from there at Cin % 4 == 0, one
  // tap) or a_row + 32 r, each row's tap shift and channel decoded once
  const int a_row = VA ? (tid & 31) * 4 : tid & 31;
  int a_off[AR], a_dh[AR], a_dw[AR];
  bool a_ok[AR];
#pragma unroll
  for (int r = 0; r < AR; ++r) {
    const int row = m0 + a_row + 32 * r;
    a_ok[r] = row < M;
    const int tap = a_ok[r] ? row / Cin : 0;
    const int ci = a_ok[r] ? row - tap * Cin : 0;
    const int di = tap / KW;
    a_dh[r] = di - KH / 2;
    a_dw[r] = tap - di * KW - KW / 2;
    a_off[r] = (a_dh[r] * W + a_dw[r]) * Cin + ci;  // x offset from pixel p's row
  }
  // B loader: channels b_n (4 of them from there) or b_n + 32 r
  const int b_n = VB ? (tid & 31) * 4 : tid & 31;

  auto load_slab = [&](int st) {
    const bool p_ok = p < p_end;
    float* as = As + (st * DW_BK + s_px) * DW_BM + a_row;
#pragma unroll
    for (int r = 0; r < AR; ++r) {
      const bool ok = p_ok && a_ok[r] && (unsigned)(oh + a_dh[r]) < (unsigned)H &&
                      (unsigned)(ow + a_dw[r]) < (unsigned)W;
      const T* src = ok ? x + p * Cin + a_off[r] : x;
      if constexpr (VA)
        cp_async16(as, src, ok);
      else
        copy1(as + 32 * r, src, ok);
    }
    float* bs = Bs + (st * DW_BK + s_px) * NT + b_n;
    const T* grow = g + p * Cout + n0 + b_n;
    if constexpr (VB) {
      if (NT == 128 || b_n < NT) {
        const bool ok = p_ok && n0 + b_n < Cout;
        cp_async16(bs, ok ? grow : g, ok);
      }
    } else {
#pragma unroll
      for (int r = 0; r < NT / 32; ++r) {
        const bool ok = p_ok && n0 + b_n + 32 * r < Cout;
        copy1(bs + 32 * r, ok ? grow + 32 * r : g, ok);
      }
    }
    p += DW_BK;
    ow += DW_BK;
    while (ow >= W) {
      ow -= W;
      if (++oh == H) oh = 0;
    }
  };

  float part[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      part[i][j] = 0.0f;
      total[(i * TN + j) * DW_THREADS + tid] = 0.0f;
    }

#pragma unroll
  for (int s = 0; s < DW_STAGES - 1; ++s) {
    if (s < n_slabs) load_slab(s);
    cp_async_commit();
  }
  int st = 0;  // the stage of slab sl
  int folded = 0;
  for (int sl = 0; sl < n_slabs; ++sl) {
    cp_async_wait<DW_STAGES - 2>();  // slab sl has landed (this thread's copies)
    __syncthreads();                 // ... everyone's; and slab sl - 1 is read
    if (sl + DW_STAGES - 1 < n_slabs) load_slab(st == 0 ? DW_STAGES - 1 : st - 1);
    cp_async_commit();
    const float* as = As + st * DW_BK * DW_BM;
    const float* bs = Bs + st * DW_BK * NT;
#pragma unroll
    for (int kk = 0; kk < DW_BK; ++kk) {
      float a[8], bv[TN];
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * DW_BM + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(as + kk * DW_BM + 64 + ty * 4);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
#pragma unroll
      for (int jj = 0; jj < TN / 4; ++jj) {
        const float4 b4 = *reinterpret_cast<const float4*>(bs + kk * NT + 64 * jj + tx * 4);
        bv[4 * jj] = b4.x; bv[4 * jj + 1] = b4.y; bv[4 * jj + 2] = b4.z; bv[4 * jj + 3] = b4.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) part[i][j] = fmaf(a[i], bv[j], part[i][j]);
    }
    st = st == DW_STAGES - 1 ? 0 : st + 1;
    if (++folded == DW_FOLD) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          total[(i * TN + j) * DW_THREADS + tid] += part[i][j];
          part[i][j] = 0.0f;
        }
      folded = 0;
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i / 4) * 64 + ty * 4 + (i % 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + (j / 4) * 64 + tx * 4 + (j % 4);
      if (n < Cout)
        out[(long long)m * Cout + n] = total[(i * TN + j) * DW_THREADS + tid] + part[i][j];
    }
  }
}

// dw[e] = sum over the pixel chunks of ws, in chunk order
__global__ void __launch_bounds__(REDUCE_THREADS)
conv2d_dw_reduce_kernel(const float* __restrict__ ws, float* __restrict__ dw, long long MN,
                        int splits) {
  split_sum<float>(ws, dw, MN, splits);
}

template <typename T, int NT>
cudaError_t launch_dw_tile(bool va, bool vb, dim3 grid, cudaStream_t s, const T* x,
                           const T* g, float* out, int B, int H, int W, int Cin, int Cout,
                           int KH, int KW, long long chunk) {
  auto kern = conv2d_dw_kernel<T, NT, false, false>;
  if constexpr (sizeof(T) == 4) {
    if (va && vb)
      kern = conv2d_dw_kernel<T, NT, true, true>;
    else if (va)
      kern = conv2d_dw_kernel<T, NT, true, false>;
    else if (vb)
      kern = conv2d_dw_kernel<T, NT, false, true>;
  }
  constexpr int bytes = dw_smem_bytes<NT>();
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  // ask for the shared-memory side of the L1 split, so two blocks fit
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kern<<<grid, DW_THREADS, bytes, s>>>(x, g, out, B, H, W, Cin, Cout, KH, KW, chunk);
  return cudaGetLastError();
}

template <typename T>
int launch_dw(const void* x, const void* g, void* dw, void* ws, int B, int H, int W, int Cin,
              int Cout, int KH, int KW, int bn, int splits, long long chunk, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(g);
  float* out = splits > 1 ? static_cast<float*>(ws) : static_cast<float*>(dw);
  const long long M = (long long)KH * KW * Cin;
  const long long grid_m = (M + DW_BM - 1) / DW_BM;
  const long long grid_n = (Cout + bn - 1) / bn;
  if (grid_m > 2147483647LL || grid_n > 65535LL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)grid_m, (unsigned)grid_n, (unsigned)splits);
  // 16-byte copies need 16-byte aligned rows: an aligned base and a row
  // of a multiple of 4 floats (bf16 is always widened element by element)
  const bool va = sizeof(T) == 4 && Cin % 4 == 0 && aligned16(x);
  const bool vb = sizeof(T) == 4 && Cout % 4 == 0 && aligned16(g);
  cudaError_t err =
      bn == 64 ? launch_dw_tile<T, 64>(va, vb, grid, s, xp, gp, out, B, H, W, Cin, Cout, KH,
                                       KW, chunk)
               : launch_dw_tile<T, 128>(va, vb, grid, s, xp, gp, out, B, H, W, Cin, Cout, KH,
                                        KW, chunk);
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long MN = M * Cout;
  conv2d_dw_reduce_kernel<<<split_sum_blocks(MN), REDUCE_THREADS, 0, s>>>(
      static_cast<const float*>(ws), static_cast<float*>(dw), MN, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (g, w and dx share it).  The plan
// (kernels/conv2d.py::dx_plan): bn, the N tile, picks the variant (4, 8
// or 16: small-Cin, Cin <= bn; 64 or 128: tiled); the taps are cut into
// `splits` runs of `taps_per_split`.  With one split the GEMM writes dx
// directly and ws may be null; otherwise ws holds splits * B*H*W*Cin
// floats and a second kernel sums it into dx in a fixed order.  Returns
// the cudaError_t of the launches (0 on success); the caller raises on
// non-zero.
extern "C" int conv2d_dx_launch(const void* g, const void* w, void* dx, void* ws,
                                int B, int H, int W, int Cin, int Cout, int KH, int KW,
                                int bn, int splits, int taps_per_split, int dtype,
                                void* stream) {
  const long long M = (long long)B * H * W;
  const int taps = KH * KW;
  const bool small = bn == 4 || bn == 8 || bn == 16;
  // the tiled variant's pixel indices are ints: M + 2^20 must fit
  if (M <= 0 || Cin <= 0 || Cout <= 0 || KH <= 0 || KW <= 0 ||
      (long long)H * W > 2147483647LL || !(small || bn == 64 || bn == 128) ||
      (!small && M > 2147483647LL - (1 << 21)) ||
      (small && Cin > bn) || splits <= 0 || taps_per_split <= 0 ||
      (long long)(splits - 1) * taps_per_split >= taps ||
      (long long)splits * taps_per_split < taps || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (splits > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dx<float>(g, w, dx, ws, B, H, W, Cin, Cout, KH, KW, bn, splits,
                            taps_per_split, s);
  if (dtype == 1)
    return launch_dx<__nv_bfloat16>(g, w, dx, ws, B, H, W, Cin, Cout, KH, KW, bn, splits,
                                    taps_per_split, s);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16 (x and g share it); dw is float32.
// The plan (kernels/conv2d.py::dw_plan): bn, the N tile (64 or 128); the
// pixel axis cut into `splits` chunks of `chunk` pixels.  With one chunk
// the kernel writes dw directly and ws may be null; otherwise ws holds
// splits * kh*kw*Cin*Cout floats and a second kernel sums it into dw in a
// fixed order.  Returns the cudaError_t of the launches (0 on success);
// the caller raises on non-zero.
extern "C" int conv2d_dw_launch(const void* x, const void* g, void* dw, void* ws, int B, int H,
                                int W, int Cin, int Cout, int KH, int KW, int bn, int splits,
                                long long chunk, int dtype, void* stream) {
  const long long P = (long long)B * H * W;
  const long long M = (long long)KH * KW * Cin;
  if (P <= 0 || M <= 0 || Cout <= 0 || KH <= 0 || KW <= 0 || M > 2147483647LL ||
      (long long)H * W > 2147483647LL || !(bn == 64 || bn == 128) || splits <= 0 ||
      chunk <= 0 || (long long)(splits - 1) * chunk >= P || (long long)splits * chunk < P ||
      (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (splits > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dw<float>(x, g, dw, ws, B, H, W, Cin, Cout, KH, KW, bn, splits, chunk, s);
  if (dtype == 1)
    return launch_dw<__nv_bfloat16>(x, g, dw, ws, B, H, W, Cin, Cout, KH, KW, bn, splits,
                                    chunk, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* conv2d_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
