// Fused training-mode ConvLayer (3x3 conv + BatchNorm statistics + LeakyReLU
// backward sums), for Hopper.
//
// Replaces the TPU kernels of pacingpseudo_tpu/ops/pallas/fused_convbn.py:
//   conv3x3_kernel<T, kVec, false> + reduce_rows_kernel  <-  _conv_stats_kernel   (:127)
//   bn_sums_kernel<T, VEC>          + reduce_rows_kernel  <-  _bn_sums_kernel      (:160)
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
// float32 operations per element, so it is bound by device-memory bytes.
// Design: each thread owns one 16-byte vector of channels and walks pixels
// with a grid stride, so every load is a coalesced 16-byte load; per-block
// partial rows as for kernel 3.
//
// The TPU kernels carried their sums across a sequential grid.  Hopper
// blocks run in no order, so every sum is two launches: per-block partial
// rows, then reduce_rows_kernel adds the rows in a fixed order in double
// precision.  No float atomics: the statistics are the same from run to run.
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

// Backward pass A: per block, one row [sum g' (co), sum g'*xhat (co)] of
// partials.  Thread (x, y) owns channels [VEC*cv, VEC*cv + VEC) with
// cv = blockIdx.y * blockDim.x + x, and pixels y, y + blockDim.y, ... of
// the block's grid-stride walk.  aux = [mean, rstd, gamma, beta] (4, co).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) bn_sums_kernel(
    const T* __restrict__ y, const T* __restrict__ gzp,
    const float* __restrict__ aux, float* __restrict__ partials,
    long long npix, int h, int wd, int co, float slope) {
  __shared__ float red[2][kThreads * VEC];
  const int cv = blockIdx.y * blockDim.x + threadIdx.x;
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
  const long long hw = (long long)h * wd;
  const long long step = (long long)gridDim.x * blockDim.y;
  for (long long p = (long long)blockIdx.x * blockDim.y + threadIdx.y; active && p < npix;
       p += step) {
    const long long img = p / hw;
    const int rem = (int)(p - img * hw);
    const int oh = rem / wd, ow = rem - (rem / wd) * wd;
    const long long goff = ((img * (h + 2) + oh + 1) * (wd + 2) + ow + 1) * co + c0;
    float yv[VEC], gv[VEC];
    if constexpr (VEC * sizeof(T) == 16) {
      const uint4 ry = *reinterpret_cast<const uint4*>(y + p * co + c0);
      const uint4 rg = *reinterpret_cast<const uint4*>(gzp + goff);
      const T* ty = reinterpret_cast<const T*>(&ry);
      const T* tg = reinterpret_cast<const T*>(&rg);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        yv[v] = to_f(ty[v]);
        gv[v] = to_f(tg[v]);
      }
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        yv[v] = to_f(y[p * co + c0 + v]);
        gv[v] = to_f(gzp[goff + v]);
      }
    }
    // Each product and sum rounded on its own (no FMA contraction), as the
    // plain version's separate elementwise ops round: the LeakyReLU branch
    // taken at yn ~ 0 is then the same in both.
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const float xhat = __fmul_rn(__fsub_rn(yv[v], mean[v]), rstd[v]);
      const float yn = __fadd_rn(__fmul_rn(xhat, gamma[v]), beta[v]);
      const float g = __fmul_rn(gv[v], yn >= 0.f ? 1.f : slope);
      s1[v] += g;
      s2[v] += __fmul_rn(g, xhat);
    }
  }
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    red[0][t * VEC + v] = s1[v];
    red[1][t * VEC + v] = s2[v];
  }
  __syncthreads();
  if (threadIdx.y == 0 && active) {
    float* row = partials + (long long)blockIdx.x * 2 * co;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      float t1 = 0.f, t2 = 0.f;
      for (int g = 0; g < (int)blockDim.y; ++g) {
        t1 += red[0][(g * blockDim.x + threadIdx.x) * VEC + v];
        t2 += red[1][(g * blockDim.x + threadIdx.x) * VEC + v];
      }
      row[c0 + v] = t1;
      row[co + c0 + v] = t2;
    }
  }
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

// bn_sums_kernel's launch: one 16-byte vector of channels a thread where co
// allows it (else one channel), up to 32 vectors across a block and the
// rest of its 256 threads along the pixels; enough blocks along the pixels
// to keep kBnBlocksPerSm blocks on every SM.
constexpr int kBnBlocksPerSm = 4;
struct BnGeometry {
  int vec, bx, by, grid_x;
};

BnGeometry bn_geometry(int dtype, long long npix, int co, int sm_count) {
  BnGeometry g;
  g.vec = 16 / (dtype == 1 ? 2 : 4);
  if (co % g.vec) g.vec = 1;
  g.bx = co / g.vec < 32 ? co / g.vec : 32;
  g.by = kThreads / g.bx;
  const long long blocks = (npix + g.by - 1) / g.by;
  const long long cap = (long long)kBnBlocksPerSm * (sm_count > 0 ? sm_count : 1);
  g.grid_x = (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
  return g;
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

// Kernel 4.  y (n, h, w, co), gzp (n, h+2, w+2, co), aux (4, co) float32
// -> out (2, co) float32 = [sum g', sum g' * xhat]; partials holds
// fused_convbn_bn_sums_rows(...) rows of 2*co floats.
int fused_convbn_bn_sums(const void* y, const void* gzp, const void* aux, void* partials,
                         void* out, int dtype, int n, int h, int wd, int co, float slope,
                         int sm_count, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const long long npix = (long long)n * h * wd;
  const BnGeometry g = bn_geometry(dtype, npix, co, sm_count);
  const dim3 grid(g.grid_x, (co / g.vec + g.bx - 1) / g.bx);
  const dim3 block(g.bx, g.by);
  const float* a = static_cast<const float*>(aux);
  float* p = static_cast<float*>(partials);
  if (dtype == 1 && g.vec == 8) {
    using T = __nv_bfloat16;
    bn_sums_kernel<T, 8><<<grid, block, 0, st>>>(static_cast<const T*>(y), static_cast<const T*>(gzp),
                                                 a, p, npix, h, wd, co, slope);
  } else if (dtype == 1) {
    using T = __nv_bfloat16;
    bn_sums_kernel<T, 1><<<grid, block, 0, st>>>(static_cast<const T*>(y), static_cast<const T*>(gzp),
                                                 a, p, npix, h, wd, co, slope);
  } else if (g.vec == 4) {
    bn_sums_kernel<float, 4><<<grid, block, 0, st>>>(static_cast<const float*>(y),
                                                     static_cast<const float*>(gzp), a, p, npix,
                                                     h, wd, co, slope);
  } else {
    bn_sums_kernel<float, 1><<<grid, block, 0, st>>>(static_cast<const float*>(y),
                                                     static_cast<const float*>(gzp), a, p, npix,
                                                     h, wd, co, slope);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_rows_kernel<<<(2 * co + kRedX - 1) / kRedX, dim3(kRedX, kRedY), 0, st>>>(
      p, g.grid_x, 2 * co, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// Rows of partials that fused_convbn_bn_sums writes for these arguments.
int fused_convbn_bn_sums_rows(int dtype, int n, int h, int wd, int co, int sm_count) {
  return bn_geometry(dtype, (long long)n * h * wd, co, sm_count).grid_x;
}

const char* fused_convbn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
