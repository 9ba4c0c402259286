// Fused training-mode ConvLayer (3x3 conv + BatchNorm statistics + LeakyReLU
// backward sums), for Hopper.
//
// Replaces the TPU kernels of pacingpseudo_tpu/ops/pallas/fused_convbn.py:
//   conv3x3_kernel<T, kVec, false> + reduce_rows_kernel  <-  _conv_stats_kernel   (:127)
//   bn_sums_kernel<T, VEC> (one launch)                  <-  _bn_sums_kernel      (:160)
//   conv3x3_kernel<T, kVec, true>                         <-  _conv_pad_out_kernel (:201)
// conv3x3_kernel is the "simple" route of ops/fused_convbn.py's conv_plan():
// float32, Cin = 1, and shapes that csrc/conv_wgmma.cu's rectangle tiles do
// not cover exactly.  Every other bfloat16 conv takes conv_wgmma.cu, whose
// per-M-tile partial rows reduce_rows_kernel adds (fused_convbn_reduce_rows).
//
// Layout (the JAX package's): activations NHWC on padded canvases
// (N, H+2, W+2, C) in the compute dtype T (bfloat16 or float32), contiguous;
// weights (9, Cin, Cout) in T, tap t = 3*dh + dw; statistics float32.
//
// conv3x3_kernel: an implicit GEMM, M = output pixels, N = Cout,
// K = 9*Cin, A[m, k] = xp[pixel m shifted by tap k / Cin, channel k % Cin].
// At the train step's shapes the forward conv (kernel 3) and the input-
// gradient conv (kernel 5) each do 2*9*Cin*Cout operations per pixel; with
// Cin >= 32 that is above the card's balance point (about 295 bf16 tensor-
// core operations a byte), so the bound is the tensor cores, and below it
// (Cin = 1, the first layer) the bytes.  Design: one 128 x 64 output tile
// per block of 8 warps; 32-deep K tiles go through shared memory, fetched
// into registers one tile ahead so the global loads overlap the products.
// The loads' latency, not the tensor cores, holds this design: the bf16
// kernels are held to 128 registers so that two blocks share an SM.
// bfloat16 multiplies on the tensor cores (wmma m16n16k16, float32
// accumulation), float32 by FMA (each thread an 8 x 4 sub-tile).  Where
// Cin is a multiple of 32 a K tile lies inside one tap, and each thread
// reads 16-byte vectors along the contiguous channels; otherwise (Cin = 1
// and the tests' small widths) each element is predicated on its own.
// Rows outside the image read zeros.  The epilogue goes through shared
// memory: kernel 3 adds the bias to the float32 accumulator, stores y in T,
// and sums y and y^2 of the float32 values (before the cast, as the TPU
// kernel does) over the block's rows into one row of partials per block;
// kernel 5 runs over every pixel of the PADDED output canvas, so the zero
// border is written by the same coalesced stores (border rows read zeros).
// No wgmma, TMA or deeper pipeline: the wgmma route (conv_wgmma.cu) has those.
//
// bn_sums_kernel: per channel sum(g') and sum(g' * xhat) with
// g' = gz * LReLU'(yn), yn = xhat * gamma + beta, xhat = (y - mean) * rstd.
// It reads y and the centre of the padded cotangent once each, a handful of
// float32 operations per element, so it is bound by device-memory bytes
// (0.4808 ms over the train step's 18 fused layers on an H100).  Its first
// design (a grid-stride walk over pixels, a 64-bit division per pixel, one
// 16-byte load pair in flight a thread, a second launch to reduce) took
// 2.5x that.  This one: the launch's plan (ops/fused_convbn.py
// bn_sums_plan) gives each block whole output rows, which it walks with
// pointer increments and no division, four 16-byte load pairs in flight a
// thread; the fixed-order reduction runs in the same launch, by the last
// block to finish (an integer ticket, no float atomics).
//
// The TPU kernels carried their sums across a sequential grid.  Hopper
// blocks run in no order: every sum is per-block partial rows added in a
// fixed order in double precision, by reduce_rows_kernel (conv_stats, a
// second launch) or by the last block (bn_sums).  No float atomics: the
// statistics are the same from run to run.
//
// Plain C interface, loaded with ctypes (pacingpseudo_torch/ops/_build.py).
// Every entry point returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;          // output pixels per block
constexpr int kBN = 64;           // output channels per block
constexpr int kBK = 32;           // K per shared-memory tile
constexpr int kThreads = 256;
constexpr int kCPad = kBN + 4;    // float row of the epilogue tile
constexpr int kSmemBytes = kBM * kCPad * 4;
constexpr int kEpiRows = kThreads / kBN;   // 4 row groups in the epilogue

template <typename T> struct Tile;

template <> struct Tile<__nv_bfloat16> {
  static constexpr int kAPad = kBK + 8;   // wmma: ldm a multiple of 8
  static constexpr int kBPad = kBN + 8;
};
template <> struct Tile<float> {
  static constexpr int kAPad = kBK + 4;   // 16-byte aligned rows
  static constexpr int kBPad = kBN;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <typename T> __device__ __forceinline__ T zero_of() { return from_f<T>(0.f); }

// A 3x3 stride-1 convolution over a padded canvas as an implicit GEMM.
//   kPadOut = false (kernel 3): out = y (N, H, W, cout) = conv + bias; one
//     row of 2*cout partial sums [sum y, sum y^2] per blockIdx.x.
//   kPadOut = true (kernel 5): out = (N, H+2, W+2, cout), conv in the centre
//     and zeros on the border; no bias, no sums.
template <typename T, bool kVec, bool kPadOut>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 2 : 1) conv3x3_kernel(
    const T* __restrict__ xp, const T* __restrict__ w,
    const float* __restrict__ bias, T* __restrict__ out,
    float* __restrict__ partials, int n_img, int h, int wd, int cin, int cout) {
  constexpr int kAPad = Tile<T>::kAPad;
  constexpr int kBPad = Tile<T>::kBPad;
  constexpr int kVecElems = 16 / sizeof(T);
  constexpr int kAVecs = kBM * kBK / kVecElems / kThreads;   // 16-byte A loads a thread
  constexpr int kAElems = kBM * kBK / kThreads;              // predicated A loads a thread
  constexpr int kBElems = kBK * kBN / kThreads;

  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  __shared__ long long row_base[kBM];
  __shared__ float red[2][kEpiRows][kBN];
  T* As = reinterpret_cast<T*>(smem);                       // [kBM][kAPad]
  T* Bs = As + kBM * kAPad;                                 // [kBK][kBPad]
  float* Cs = reinterpret_cast<float*>(smem);               // [kBM][kCPad], after the loop

  const int tid = threadIdx.x;
  const int hp = h + 2, wp = wd + 2;
  const long long m_total =
      kPadOut ? (long long)n_img * hp * wp : (long long)n_img * h * wd;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int K = 9 * cin;

  // Element offset of each tile row's 3x3 window origin in xp; -1 where the
  // row reads zeros (past the last pixel, or a border pixel of kernel 5).
  if (tid < kBM) {
    const long long m = m0 + tid;
    long long base = -1;
    if (m < m_total) {
      if (kPadOut) {
        const long long img = m / ((long long)hp * wp);
        const int rem = (int)(m - img * hp * wp);
        const int ph = rem / wp, pw = rem - (rem / wp) * wp;
        if (ph >= 1 && ph <= h && pw >= 1 && pw <= wd)
          base = ((img * hp + (ph - 1)) * wp + (pw - 1)) * cin;
      } else {
        const long long img = m / ((long long)h * wd);
        const int rem = (int)(m - img * h * wd);
        const int oh = rem / wd, ow = rem - (rem / wd) * wd;
        base = ((img * hp + oh) * wp + ow) * cin;
      }
    }
    row_base[tid] = base;
  }
  __syncthreads();

  uint4 a_vec[kVec ? kAVecs : 1];
  T a_sc[kVec ? 1 : kAElems];
  T b_sc[kBElems];

  auto load_tile = [&](int k0) {
    if constexpr (kVec) {
      // The 32 K values of this tile are channels ci0..ci0+31 of one tap.
      const int tap = k0 / cin;
      const long long koff = (long long)((tap / 3) * wp + tap % 3) * cin + (k0 - tap * cin);
      constexpr int kPerRow = kBK / kVecElems;
#pragma unroll
      for (int i = 0; i < kAVecs; ++i) {
        const int idx = tid + i * kThreads;
        const int r = idx / kPerRow, c = idx % kPerRow;
        const long long base = row_base[r];
        a_vec[i] = base >= 0
            ? *reinterpret_cast<const uint4*>(xp + base + koff + c * kVecElems)
            : make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kAElems; ++i) {
        const int idx = tid + i * kThreads;
        const int r = idx / kBK, k = k0 + idx % kBK;
        const long long base = row_base[r];
        T v = zero_of<T>();
        if (base >= 0 && k < K) {
          const int tap = k / cin;
          v = xp[base + (long long)((tap / 3) * wp + tap % 3) * cin + (k - tap * cin)];
        }
        a_sc[i] = v;
      }
    }
#pragma unroll
    for (int i = 0; i < kBElems; ++i) {
      const int idx = tid + i * kThreads;
      const int k = k0 + idx / kBN, n = n0 + idx % kBN;
      b_sc[i] = (k < K && n < cout) ? w[(long long)k * cout + n] : zero_of<T>();
    }
  };

  auto store_tile = [&]() {
    if constexpr (kVec) {
      constexpr int kPerRow = kBK / kVecElems;
#pragma unroll
      for (int i = 0; i < kAVecs; ++i) {
        const int idx = tid + i * kThreads;
        const int r = idx / kPerRow, c = idx % kPerRow;
        *reinterpret_cast<uint4*>(As + r * kAPad + c * kVecElems) = a_vec[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < kAElems; ++i) {
        const int idx = tid + i * kThreads;
        As[(idx / kBK) * kAPad + idx % kBK] = a_sc[i];
      }
    }
#pragma unroll
    for (int i = 0; i < kBElems; ++i) {
      const int idx = tid + i * kThreads;
      Bs[(idx / kBN) * kBPad + idx % kBN] = b_sc[i];
    }
  };

  const int n_ktiles = (K + kBK - 1) / kBK;
  const int warp = tid / 32;

  if constexpr (sizeof(T) == 2) {
    // bfloat16: 8 warps as 4 (M) x 2 (N), each a 32 x 32 block of four
    // 16 x 16 accumulator fragments.
    using namespace nvcuda;
    const int wm = warp % 4, wn = warp / 4;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    load_tile(0);
    for (int kt = 0; kt < n_ktiles; ++kt) {
      store_tile();
      __syncthreads();
      if (kt + 1 < n_ktiles) load_tile((kt + 1) * kBK);
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * kAPad + kk, kAPad);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], Bs + kk * kBPad + wn * 32 + j * 16, kBPad);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * kCPad + wn * 32 + j * 16,
                                acc[i][j], kCPad, wmma::mem_row_major);
  } else {
    // float32: thread (tr, tc) owns rows tr + 16i (i < 8), columns tc + 16j
    // (j < 4); within a warp the A reads are two broadcasts.
    const int tr = tid / 16, tc = tid % 16;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    load_tile(0);
    for (int kt = 0; kt < n_ktiles; ++kt) {
      store_tile();
      __syncthreads();
      if (kt + 1 < n_ktiles) load_tile((kt + 1) * kBK);
#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk) {
        float a[8], b[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = to_f(As[(tr + 16 * i) * kAPad + kk]);
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = to_f(Bs[kk * kBPad + tc + 16 * j]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Cs[(tr + 16 * i) * kCPad + tc + 16 * j] = acc[i][j];
  }
  __syncthreads();

  // Epilogue: thread (rg, c) stores column c of rows rg, rg + 4, ...; a
  // warp writes 32 neighbouring channels of one pixel.
  const int c = tid % kBN, rg = tid / kBN;
  const int n = n0 + c;
  const bool col_ok = n < cout;
  const float b = (!kPadOut && col_ok) ? bias[n] : 0.f;
  float s1 = 0.f, s2 = 0.f;
  for (int r = rg; r < kBM; r += kEpiRows) {
    const long long m = m0 + r;
    if (m >= m_total) break;
    const float v = Cs[r * kCPad + c] + b;
    if (col_ok) out[m * cout + n] = from_f<T>(v);
    if (!kPadOut) {
      s1 += v;
      s2 += v * v;
    }
  }
  if constexpr (!kPadOut) {
    red[0][rg][c] = s1;
    red[1][rg][c] = s2;
    __syncthreads();
    if (rg == 0 && col_ok) {
      float t1 = 0.f, t2 = 0.f;
#pragma unroll
      for (int g = 0; g < kEpiRows; ++g) {
        t1 += red[0][g][c];
        t2 += red[1][g][c];
      }
      float* row = partials + (long long)blockIdx.x * 2 * cout;
      row[n] = t1;
      row[cout + n] = t2;
    }
  }
}

// Kernel 4.  One launch: a row walk, per-block partial rows, and the fixed-
// order sum of those rows by whichever block of a channel chunk ends last.
//
// Block (bx, by) = (channel vectors, pixel lanes); blockIdx.y picks the
// chunk of bx channel vectors, blockIdx.x the rows [r0, r0 + rows_per_block)
// of the (n*h) output rows (img, oh).  Those rows are one contiguous run of
// pixels of y, and of the centre of gzp apart from a 2-pixel gap between
// rows and 2*(w+2) more between images.  Thread (x, y) owns channel vector
// cv = blockIdx.y*bx + x (aux in registers) and walks the run's pixels
// y, y + by, ... by pointer increments, four pixels (four 16-byte load
// pairs) in flight.  Per-thread sums in float, then a fixed tree over the
// pixel lanes in shared memory, one row [sum g' (co), sum g'*xhat (co)] of
// partials per blockIdx.x (the chunk's columns), then a ticket: the block
// that draws the chunk's last ticket adds the chunk's partial rows in row
// order in double precision, writes out and resets the chunk's counter.
constexpr int kBnUnroll = 4;
constexpr int kBnBatch = 16;    // partial rows loaded at once by the last block
constexpr int kBnBlocksPerSm = 2;    // ops/fused_convbn.py BN_SUMS_BLOCKS_PER_SM

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kBnBlocksPerSm) bn_sums_kernel(
    const T* __restrict__ y, const T* __restrict__ gzp, const float* __restrict__ aux,
    float* partials, unsigned* counters, float* __restrict__ out,
    int n_img, int h, int wd, int co, int rows_per_block, float slope) {
  __shared__ float red[2][VEC][kThreads];
  __shared__ double fin[kThreads];
  __shared__ bool last;
  const int bx = blockDim.x, by = blockDim.y;
  const int t = threadIdx.y * bx + threadIdx.x;
  const int cv = blockIdx.y * bx + threadIdx.x;
  const bool active = (cv + 1) * VEC <= co;
  const int c0 = cv * VEC;
  float mean[VEC], rstd[VEC], gamma[VEC], beta[VEC], s1[VEC], s2[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    mean[v] = active ? aux[c0 + v] : 0.f;
    rstd[v] = active ? aux[co + c0 + v] : 0.f;
    gamma[v] = active ? aux[2 * co + c0 + v] : 0.f;
    beta[v] = active ? aux[3 * co + c0 + v] : 0.f;
    s1[v] = 0.f;
    s2[v] = 0.f;
  }

  // The block's pixels [p, p_end) of y; q is the same pixel of gzp.  The
  // one division below is per thread, not per pixel.
  const long long rows = (long long)n_img * h;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  const long long p_end = r1 * wd;
  long long p = r0 * wd + threadIdx.y;
  const long long img = p / ((long long)h * wd);
  int oh = (int)((p / wd) % h), ow = (int)(p % wd);
  long long q = p + img * (2LL * h + 2LL * wd + 4) + 2LL * oh + wd + 3;
  const int gap_img = 2 * (wd + 2);
  auto advance = [&]() {
    p += by;
    q += by;
    ow += by;
    while (ow >= wd) {
      ow -= wd;
      q += 2;
      if (++oh == h) {
        oh = 0;
        q += gap_img;
      }
    }
  };

  while (active && p < p_end) {
    float yv[kBnUnroll][VEC], gv[kBnUnroll][VEC];
    bool ok[kBnUnroll];
#pragma unroll
    for (int u = 0; u < kBnUnroll; ++u) {
      ok[u] = p < p_end;
      const T* py = y + p * co + c0;
      const T* pg = gzp + q * co + c0;
      if constexpr (VEC * sizeof(T) == 16) {
        uint4 ry = make_uint4(0u, 0u, 0u, 0u), rg = ry;
        if (ok[u]) {
          ry = __ldcs(reinterpret_cast<const uint4*>(py));
          rg = __ldcs(reinterpret_cast<const uint4*>(pg));
        }
        const T* ty = reinterpret_cast<const T*>(&ry);
        const T* tg = reinterpret_cast<const T*>(&rg);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          yv[u][v] = to_f(ty[v]);
          gv[u][v] = to_f(tg[v]);
        }
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          yv[u][v] = ok[u] ? to_f(py[v]) : 0.f;
          gv[u][v] = ok[u] ? to_f(pg[v]) : 0.f;
        }
      }
      advance();
    }
    // Each product and sum rounded on its own (no FMA contraction), as the
    // plain version's separate elementwise ops round: the LeakyReLU branch
    // taken at yn ~ 0 is then the same in both.
#pragma unroll
    for (int u = 0; u < kBnUnroll; ++u) {
      if (!ok[u]) continue;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float xhat = __fmul_rn(__fsub_rn(yv[u][v], mean[v]), rstd[v]);
        const float yn = __fadd_rn(__fmul_rn(xhat, gamma[v]), beta[v]);
        const float g = __fmul_rn(gv[u][v], yn >= 0.f ? 1.f : slope);
        s1[v] = __fadd_rn(s1[v], g);
        s2[v] = __fadd_rn(s2[v], __fmul_rn(g, xhat));
      }
    }
  }

  // A fixed tree over the pixel lanes: lane ty adds lane ty + s.
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    red[0][v][t] = s1[v];
    red[1][v][t] = s2[v];
  }
  int span = 1;
  while (span < by) span <<= 1;
  for (int s = span >> 1; s > 0; s >>= 1) {
    __syncthreads();
    if ((int)threadIdx.y < s && (int)threadIdx.y + s < by) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        red[0][v][t] += red[0][v][t + s * bx];
        red[1][v][t] += red[1][v][t + s * bx];
      }
    }
  }
  __syncthreads();
  if (threadIdx.y == 0 && active) {
    float* row = partials + (long long)blockIdx.x * 2 * co;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      row[c0 + v] = red[0][v][t];
      row[co + c0 + v] = red[1][v][t];
    }
    __threadfence();
  }
  __syncthreads();
  if (t == 0) last = atomicAdd(counters + blockIdx.y, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  // The chunk's last block: its 2*nch columns over gridDim.x rows, rows in
  // order, in double; g row groups of the columns, then the groups in order.
  __threadfence();
  const int ch0 = blockIdx.y * bx * VEC;
  const int nch = co - ch0 < bx * VEC ? co - ch0 : bx * VEC;
  const int ncols = 2 * nch;
  const int groups = bx * by / ncols;   // >= 1: the entry checks 2*bx*vec <= 256
  const int col = t % ncols, grp = t / ncols;
  const int c = col < nch ? ch0 + col : co + ch0 + col - nch;
  if (grp < groups) {
    // kBnBatch rows' loads in flight at once, added in row order.
    const int nrows = (int)gridDim.x;
    double acc = 0.0;
    for (int r = grp; r < nrows; r += kBnBatch * groups) {
      float v[kBnBatch];
#pragma unroll
      for (int b = 0; b < kBnBatch; ++b) {
        const int rb = r + b * groups;
        v[b] = rb < nrows ? __ldcg(partials + (long long)rb * 2 * co + c) : 0.f;
      }
#pragma unroll
      for (int b = 0; b < kBnBatch; ++b)
        if (r + b * groups < nrows) acc += (double)v[b];
    }
    fin[t] = acc;
  }
  __syncthreads();
  if (t < ncols) {
    double acc = 0.0;
    for (int g2 = 0; g2 < groups; ++g2) acc += fin[g2 * ncols + t];
    out[c] = (float)acc;
  }
  if (t == 0) counters[blockIdx.y] = 0u;
}

constexpr int kRedX = 32, kRedY = 16;

// out[c] = sum over r of partials[r][c], rows in a fixed order, in double.
__global__ void __launch_bounds__(kRedX * kRedY) reduce_rows_kernel(
    const float* __restrict__ partials, int rows, int cols, float* __restrict__ out) {
  __shared__ double sm[kRedY][kRedX];
  const int col = blockIdx.x * kRedX + threadIdx.x;
  double acc = 0.0;
  if (col < cols)
    for (int r = threadIdx.y; r < rows; r += kRedY) acc += partials[(long long)r * cols + col];
  sm[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && col < cols) {
    double s = 0.0;
#pragma unroll
    for (int g = 0; g < kRedY; ++g) s += sm[g][threadIdx.x];
    out[col] = (float)s;
  }
}

// The conv GEMM of kernel 3 (kPadOut false) or kernel 5 (true); returns
// cudaGetLastError() after the launch.
template <typename T, bool kPadOut>
cudaError_t launch_conv(const void* xp, const void* w, const void* bias, void* out,
                        void* partials, int n, int h, int wd, int cin, int cout,
                        cudaStream_t st, unsigned* grid_x) {
  const long long m_total =
      kPadOut ? (long long)n * (h + 2) * (wd + 2) : (long long)n * h * wd;
  const dim3 grid((unsigned)((m_total + kBM - 1) / kBM), (unsigned)((cout + kBN - 1) / kBN));
  *grid_x = grid.x;
  const T* x = static_cast<const T*>(xp);
  const T* wt = static_cast<const T*>(w);
  const float* b = static_cast<const float*>(bias);
  T* o = static_cast<T*>(out);
  float* p = static_cast<float*>(partials);
  if (cin % kBK == 0)
    conv3x3_kernel<T, true, kPadOut><<<grid, kThreads, 0, st>>>(x, wt, b, o, p, n, h, wd, cin, cout);
  else
    conv3x3_kernel<T, false, kPadOut><<<grid, kThreads, 0, st>>>(x, wt, b, o, p, n, h, wd, cin, cout);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel 3.  dtype 0 = float32, 1 = bfloat16.  xp (n, h+2, w+2, cin),
// w (9, cin, cout), bias (cout,) float32 -> y (n, h, w, cout) and
// sums (2, cout) float32 = [sum y, sum y^2]; partials holds `rows` =
// ceil(n*h*w / 128) rows of 2*cout floats (cudaErrorInvalidValue for any
// other count).
int fused_convbn_conv_stats(const void* xp, const void* w, const void* bias, void* y,
                            void* partials, void* sums, int dtype, int n, int h, int wd,
                            int cin, int cout, int rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((long long)rows != ((long long)n * h * wd + kBM - 1) / kBM) return (int)cudaErrorInvalidValue;
  unsigned grid_x = 0;
  cudaError_t err;
  if (dtype == 1)
    err = launch_conv<__nv_bfloat16, false>(xp, w, bias, y, partials, n, h, wd, cin, cout, st,
                                            &grid_x);
  else if (dtype == 0)
    err = launch_conv<float, false>(xp, w, bias, y, partials, n, h, wd, cin, cout, st, &grid_x);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  reduce_rows_kernel<<<(2 * cout + kRedX - 1) / kRedX, dim3(kRedX, kRedY), 0, st>>>(
      static_cast<const float*>(partials), rows, 2 * cout, static_cast<float*>(sums));
  return (int)cudaGetLastError();
}

// out (cols,) float32 = the sum of the (rows, cols) float32 partials, rows in
// a fixed order: the second half of conv_stats on the wgmma route.
int fused_convbn_reduce_rows(const void* partials, int rows, int cols, void* out, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  reduce_rows_kernel<<<(cols + kRedX - 1) / kRedX, dim3(kRedX, kRedY), 0,
                       static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(partials),
                                                            rows, cols, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// Kernel 5.  dyp (n, h+2, w+2, cin), w (9, cin, cout) -> dxp
// (n, h+2, w+2, cout) with a zero border.
int fused_convbn_conv_pad_out(const void* dyp, const void* w, void* dxp, int dtype, int n,
                              int h, int wd, int cin, int cout, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned rows = 0;
  if (dtype == 1)
    return (int)launch_conv<__nv_bfloat16, true>(dyp, w, nullptr, dxp, nullptr, n, h, wd, cin,
                                                 cout, st, &rows);
  if (dtype == 0)
    return (int)launch_conv<float, true>(dyp, w, nullptr, dxp, nullptr, n, h, wd, cin, cout, st,
                                         &rows);
  return (int)cudaErrorInvalidValue;
}

// Kernel 4, one launch.  y (n, h, w, co), gzp (n, h+2, w+2, co), aux (4, co)
// float32 -> out (2, co) float32 = [sum g', sum g' * xhat].  The plan
// (ops/fused_convbn.py bn_sums_plan): vec channels a thread (16 bytes, or 1),
// bx channel vectors and 256 / bx pixel lanes a block, grid (grid_x,
// grid_y) with grid_y = ceil(co / vec / bx) chunks of channels and
// rows_per_block rows of the n*h a blockIdx.x.  partials holds grid_x rows of
// 2*co floats; counters holds grid_y zeros (left zero again).  Any other
// plan is cudaErrorInvalidValue.
int fused_convbn_bn_sums(const void* y, const void* gzp, const void* aux, void* partials,
                         void* counters, int n_counters, void* out, int dtype, int n, int h,
                         int wd, int co, float slope, int vec, int bx, int grid_x, int grid_y,
                         int rows_per_block, void* stream) {
  const int full = dtype == 1 ? 8 : 4;
  const long long rows = (long long)n * h;
  if ((dtype != 0 && dtype != 1) || n <= 0 || h <= 0 || wd <= 0 || co <= 0 ||
      !(vec == full || vec == 1) || co % vec || (vec == 1 && co % full == 0) || bx <= 0 ||
      bx > kThreads || grid_y != (co / vec + bx - 1) / bx || grid_y > n_counters ||
      rows_per_block <= 0 || grid_x <= 0 ||
      (long long)grid_x * rows_per_block < rows ||
      (long long)(grid_x - 1) * rows_per_block >= rows || 2 * bx * vec > kThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_x, grid_y), block(bx, kThreads / bx);
  const float* a = static_cast<const float*>(aux);
  float* p = static_cast<float*>(partials);
  unsigned* cnt = static_cast<unsigned*>(counters);
  float* o = static_cast<float*>(out);
  if (dtype == 1) {
    using T = __nv_bfloat16;
    const T* ty = static_cast<const T*>(y);
    const T* tg = static_cast<const T*>(gzp);
    if (vec == 8)
      bn_sums_kernel<T, 8><<<grid, block, 0, st>>>(ty, tg, a, p, cnt, o, n, h, wd, co,
                                                   rows_per_block, slope);
    else
      bn_sums_kernel<T, 1><<<grid, block, 0, st>>>(ty, tg, a, p, cnt, o, n, h, wd, co,
                                                   rows_per_block, slope);
  } else {
    const float* ty = static_cast<const float*>(y);
    const float* tg = static_cast<const float*>(gzp);
    if (vec == 4)
      bn_sums_kernel<float, 4><<<grid, block, 0, st>>>(ty, tg, a, p, cnt, o, n, h, wd, co,
                                                       rows_per_block, slope);
    else
      bn_sums_kernel<float, 1><<<grid, block, 0, st>>>(ty, tg, a, p, cnt, o, n, h, wd, co,
                                                       rows_per_block, slope);
  }
  return (int)cudaGetLastError();
}

const char* fused_convbn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
