// Fused pce / entropy / soft-CE loss of the pacing objective, for Hopper.
//
// Replaces the TPU kernels of pacingpseudo_tpu/ops/pallas/fused_loss.py:
//   fwd_kernel  <-  _fwd_kernel  (:60)
//   bwd_kernel  <-  _bwd_kernel  (:96)
//
// Both passes read the weak and the strong logit fields once (NCHW, f32,
// each (H, W) class plane contiguous), the int64 scribble target and the
// f32 valid mask; the backward also writes the two gradient fields.  There
// are a handful of flops per byte, so both are bound by device-memory
// bytes: at the CHAOS step (12 x 5 x 256 x 256) the forward moves 40.9 MB
// and the backward 72.4 MB, about 12 and 22 us at 3.35 TB/s.
//
// Design.  C = 2..5 is a template parameter, so the class loops unroll
// and everything stays in registers; neighbouring threads take
// neighbouring pixels, so every class-plane load is coalesced without a
// transpose.  The TPU kernel carried its sums across a sequential grid in
// SMEM; Hopper blocks run in no order, so the forward writes one row of
// partial sums per block and the block that ends last adds the rows in a
// fixed order in double precision and forms the three losses on the
// device, in the same launch (see fwd_kernel).  No float atomics: the
// result is the same from run to run.  The backward takes one pixel per
// thread in a grid-stride loop and reads its three scale factors from
// device memory, so the step needs no host sync.
//
// Plain C interface, loaded with ctypes (pacingpseudo_torch/ops/_build.py).
// Every entry point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 5;     // pce_sum, pce_cnt, ent_sum, sce_sum, mask_sum
constexpr int kOut = 11;     // sums, 3 losses, 3 denominators
constexpr float kEps = 1e-8f;

// Softmax and log-softmax over the C logits ``x``, in the TPU kernel's
// order: max, exp(x - max), log of the sum.
template <int C>
__device__ __forceinline__ void softmax_terms(const float* x, float* p, float* lp) {
  float m = x[0];
#pragma unroll
  for (int k = 1; k < C; ++k) m = fmaxf(m, x[k]);
  float denom = 0.f;
#pragma unroll
  for (int k = 0; k < C; ++k) denom += expf(x[k] - m);
  const float log_denom = logf(denom);
#pragma unroll
  for (int k = 0; k < C; ++k) {
    lp[k] = x[k] - m - log_denom;
    p[k] = expf(lp[k]);
  }
}

// The same over the C logits at ``base`` (class stride s_c): the backward's.
template <int C>
__device__ __forceinline__ void softmax_terms(const float* __restrict__ base,
                                              long long s_c, float* p,
                                              float* lp) {
  float x[C];
#pragma unroll
  for (int k = 0; k < C; ++k) x[k] = base[k * s_c];
  softmax_terms<C>(x, p, lp);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Forward, one launch.  Block (bx, img) takes the pixels [bx*chunk,
// min((bx+1)*chunk, hw)) of image img: a contiguous run inside one class
// plane, so a pixel's offset is base + pix, with no division.  Thread t
// takes the run's groups of VEC pixels t, t + kThreads, ..., a batch of
// kFwdUnroll groups at a time; with VEC = 4 a group is one float4 per
// class plane and stream, two longlong2 of the target and one float4 of
// the mask (16-byte loads; ops/fused_loss.py::fused_loss_plan picks VEC = 4
// only where hw % 4 == 0 and the planes are 16-byte aligned, VEC = 1
// elsewhere).  The constants are the fastest of the variants
// scripts/fused_loss_fwd_ab.py times (one group a pass at three blocks an
// SM, 80 registers): the loads alone take 96% of the kernel's time there,
// and more loads in flight or fewer exponentials buy nothing.  Per-thread
// sums in float, warp shuffles and shared memory give the block's row of
// kSums partials; then a ticket: the block that draws the last one adds
// the rows in row order in double, writes out and resets the counter.  No
// float atomics: the result is the same bit for bit from run to run,
// whichever block ends last.
constexpr int kFwdUnroll = 1;          // ops/fused_loss.py FWD_UNROLL
constexpr int kFwdBlocksPerSm = 3;     // ops/fused_loss.py FWD_BLOCKS_PER_SM

template <int C, int VEC>
struct FwdBatch {
  float xw[kFwdUnroll][C][VEC], xs[kFwdUnroll][C][VEC], mk[kFwdUnroll][VEC];
  long long t[kFwdUnroll][VEC];
  bool ok[kFwdUnroll];
};

template <int C, int VEC>
__device__ __forceinline__ void fwd_load(FwdBatch<C, VEC>& b, int g, int groups,
                                         const float* bw, const float* bs,
                                         const int64_t* bt, const float* bm,
                                         long long s_c) {
#pragma unroll
  for (int u = 0; u < kFwdUnroll; ++u) {
    const int gu = g + u * kThreads;
    b.ok[u] = gu < groups;
    const int pix = (b.ok[u] ? gu : 0) * VEC;
    if constexpr (VEC == 4) {
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(bw + k * s_c + pix));
        const float4 y = __ldg(reinterpret_cast<const float4*>(bs + k * s_c + pix));
        b.xw[u][k][0] = x.x; b.xw[u][k][1] = x.y; b.xw[u][k][2] = x.z; b.xw[u][k][3] = x.w;
        b.xs[u][k][0] = y.x; b.xs[u][k][1] = y.y; b.xs[u][k][2] = y.z; b.xs[u][k][3] = y.w;
      }
      const longlong2 t0 = __ldg(reinterpret_cast<const longlong2*>(bt + pix));
      const longlong2 t1 = __ldg(reinterpret_cast<const longlong2*>(bt + pix + 2));
      b.t[u][0] = t0.x; b.t[u][1] = t0.y; b.t[u][2] = t1.x; b.t[u][3] = t1.y;
      const float4 m = __ldg(reinterpret_cast<const float4*>(bm + pix));
      b.mk[u][0] = m.x; b.mk[u][1] = m.y; b.mk[u][2] = m.z; b.mk[u][3] = m.w;
    } else {
#pragma unroll
      for (int k = 0; k < C; ++k) {
        b.xw[u][k][0] = __ldg(bw + k * s_c + pix);
        b.xs[u][k][0] = __ldg(bs + k * s_c + pix);
      }
      b.t[u][0] = __ldg(reinterpret_cast<const long long*>(bt) + pix);
      b.mk[u][0] = __ldg(bm + pix);
    }
  }
}

template <int C, int VEC>
__device__ __forceinline__ void fwd_accumulate(const FwdBatch<C, VEC>& b, int ignore,
                                               float* acc) {
#pragma unroll
  for (int u = 0; u < kFwdUnroll; ++u) {
    if (!b.ok[u]) continue;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      float x[C], pw[C], lpw[C], ps[C], lps[C];
#pragma unroll
      for (int k = 0; k < C; ++k) x[k] = b.xw[u][k][v];
      softmax_terms<C>(x, pw, lpw);
#pragma unroll
      for (int k = 0; k < C; ++k) x[k] = b.xs[u][k][v];
      softmax_terms<C>(x, ps, lps);
      const long long t = b.t[u][v];
      const float mk = b.mk[u][v];
      float nll = 0.f, ent = 0.f, sce = 0.f;
#pragma unroll
      for (int k = 0; k < C; ++k) {
        if (t == k) nll -= lpw[k];
        ent -= pw[k] * lpw[k];
        sce -= pw[k] * lps[k];
      }
      const float valid = (t != ignore) ? 1.f : 0.f;
      acc[0] += nll * valid;
      acc[1] += valid;
      acc[2] += ent * mk;
      acc[3] += sce * mk;
      acc[4] += mk;
    }
  }
}

template <int C, int VEC>
__global__ void __launch_bounds__(kThreads, kFwdBlocksPerSm) fwd_kernel(
    const float* __restrict__ lw, const float* __restrict__ ls,
    const int64_t* __restrict__ tgt, const float* __restrict__ mask, int hw,
    long long s_n, long long s_c, int chunk, int ignore, float* partials,
    unsigned* counter, float* __restrict__ out) {
  const long long img = blockIdx.y;
  const int p0 = blockIdx.x * chunk;
  const int p1 = p0 + chunk < hw ? p0 + chunk : hw;
  const int groups = (p1 - p0) / VEC;   // the entry checks chunk % VEC == 0, hw % VEC == 0
  const float* bw = lw + img * s_n + p0;
  const float* bs = ls + img * s_n + p0;
  const int64_t* bt = tgt + img * hw + p0;
  const float* bm = mask + img * hw + p0;
  constexpr int kStride = kFwdUnroll * kThreads;

  float acc[kSums] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int g = threadIdx.x; g < groups; g += kStride) {
    FwdBatch<C, VEC> cur;
    fwd_load<C, VEC>(cur, g, groups, bw, bs, bt, bm, s_c);
    fwd_accumulate<C, VEC>(cur, ignore, acc);
  }

  // The block's row: warps, then warp 0 over the warps' sums in order.
  __shared__ float warp_rows[kSums][kWarps];
  __shared__ double fin[kSums][kWarps];
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < kSums; ++s) {
    const float v = warp_sum(acc[s]);
    if (lane == 0) warp_rows[s][warp] = v;
  }
  __syncthreads();
  const unsigned rows = gridDim.x * gridDim.y;
  if (warp == 0) {
    float row[kSums];
#pragma unroll
    for (int s = 0; s < kSums; ++s) row[s] = warp_sum(lane < kWarps ? warp_rows[s][lane] : 0.f);
    if (lane == 0) {
      float* dst = partials + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * kSums;
#pragma unroll
      for (int s = 0; s < kSums; ++s) dst[s] = row[s];
      __threadfence();
      last = atomicAdd(counter, 1u) == rows - 1;
    }
  }
  __syncthreads();
  if (!last) return;

  // The last block: thread t adds rows t, t + kThreads, ... in order, in
  // double; then a fixed tree over the lanes and the warps.
  __threadfence();
  double sum[kSums] = {0.0, 0.0, 0.0, 0.0, 0.0};
  for (unsigned r = threadIdx.x; r < rows; r += kThreads) {
#pragma unroll
    for (int s = 0; s < kSums; ++s) sum[s] += (double)__ldcg(partials + (long long)r * kSums + s);
  }
#pragma unroll
  for (int s = 0; s < kSums; ++s) {
    const double v = warp_sum(sum[s]);
    if (lane == 0) fin[s][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sums[kSums];
#pragma unroll
    for (int s = 0; s < kSums; ++s) {
      double v = 0.0;
      for (int w = 0; w < kWarps; ++w) v += fin[s][w];
      sums[s] = (float)v;
      out[s] = sums[s];
    }
    const float cnt = fmaxf(sums[1], kEps);
    const float msum = fmaxf(sums[4], kEps);
    out[5] = sums[0] / cnt;
    out[6] = sums[2] / msum;
    out[7] = sums[3] / msum;
    out[8] = cnt;
    out[9] = msum;
    out[10] = msum;
    *counter = 0u;
  }
}

template <int VEC>
int launch_fwd(int c, dim3 grid, cudaStream_t st, const float* lw, const float* ls,
               const int64_t* tgt, const float* mask, int hw, long long s_n,
               long long s_c, int chunk, int ignore, float* partials,
               unsigned* counter, float* out) {
  switch (c) {
    case 2: fwd_kernel<2, VEC><<<grid, kThreads, 0, st>>>(lw, ls, tgt, mask, hw, s_n, s_c, chunk, ignore, partials, counter, out); break;
    case 3: fwd_kernel<3, VEC><<<grid, kThreads, 0, st>>>(lw, ls, tgt, mask, hw, s_n, s_c, chunk, ignore, partials, counter, out); break;
    case 4: fwd_kernel<4, VEC><<<grid, kThreads, 0, st>>>(lw, ls, tgt, mask, hw, s_n, s_c, chunk, ignore, partials, counter, out); break;
    case 5: fwd_kernel<5, VEC><<<grid, kThreads, 0, st>>>(lw, ls, tgt, mask, hw, s_n, s_c, chunk, ignore, partials, counter, out); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Analytic gradients of  g_pce*pce + g_ent*ent + g_sce*sce  for both
// streams; scal = [g_pce/cnt, g_ent/msum, g_sce/msum] on the device.
// The teacher (weak softmax) is not detached.  dlw and dls are contiguous
// (N, C, H, W).
template <int C>
__global__ void __launch_bounds__(kThreads) bwd_kernel(
    const float* __restrict__ lw, const float* __restrict__ ls,
    const int64_t* __restrict__ tgt, const float* __restrict__ mask,
    const float* __restrict__ scal, long long npix, int hw, long long s_n,
    long long s_c, int ignore, float* __restrict__ dlw,
    float* __restrict__ dls) {
  const float g_pce = scal[0];
  const float g_ent = scal[1];
  const float g_sce = scal[2];
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < npix;
       i += step) {
    const long long n = i / hw;
    const long long pix = i - n * hw;
    const long long off = n * s_n + pix;
    const long long out_off = n * (long long)C * hw + pix;
    float pw[C], lpw[C], ps[C], lps[C];
    softmax_terms<C>(lw + off, s_c, pw, lpw);
    softmax_terms<C>(ls + off, s_c, ps, lps);
    const long long t = tgt[i];
    const float mk = mask[i];
    const float valid = (t != ignore) ? 1.f : 0.f;
    float ent_pix = 0.f, sce_pix = 0.f;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      ent_pix -= pw[k] * lpw[k];
      sce_pix -= pw[k] * lps[k];
    }
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const float sel = (t == k) ? 1.f : 0.f;
      const float d_pce = (pw[k] - sel) * valid * g_pce;
      const float d_ent = -pw[k] * (lpw[k] + ent_pix) * mk * g_ent;
      const float d_sce_w = -pw[k] * (lps[k] + sce_pix) * mk * g_sce;
      dlw[out_off + (long long)k * hw] = d_pce + d_ent + d_sce_w;
      dls[out_off + (long long)k * hw] = (ps[k] - pw[k]) * mk * g_sce;
    }
  }
}

}  // namespace

#define DISPATCH_C(c, KERNEL, GRID, STREAM, ...)                     \
  switch (c) {                                                       \
    case 2: KERNEL<2><<<GRID, kThreads, 0, STREAM>>>(__VA_ARGS__); break; \
    case 3: KERNEL<3><<<GRID, kThreads, 0, STREAM>>>(__VA_ARGS__); break; \
    case 4: KERNEL<4><<<GRID, kThreads, 0, STREAM>>>(__VA_ARGS__); break; \
    case 5: KERNEL<5><<<GRID, kThreads, 0, STREAM>>>(__VA_ARGS__); break; \
    default: return (int)cudaErrorInvalidValue;                      \
  }

extern "C" {

// Forward, one launch on the plan of ops/fused_loss.py::fused_loss_plan:
// a (grid_x, n) grid, ``chunk`` pixels of one image a block, VEC = ``vec``.
// ``partials`` holds grid_x * n rows of 5 floats; ``counter`` is one
// unsigned, zero before the launch and zero again after it.  Refuses any
// plan that does not cover each image's hw pixels exactly or whose vector
// loads would be unaligned.
int fused_loss_fwd(const void* lw, const void* ls, const void* tgt,
                   const void* mask, void* partials, void* counter, void* out,
                   int c, int n, int hw, long long s_n, long long s_c,
                   int ignore, int vec, int chunk, int grid_x, void* stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (n <= 0 || n > 65535 || hw <= 0 || !(vec == 1 || vec == 4) ||
      chunk <= 0 || chunk % vec || hw % vec || grid_x <= 0 ||
      (long long)grid_x * chunk < hw || (long long)(grid_x - 1) * chunk >= hw ||
      (vec == 4 && (s_n % 4 || s_c % 4 || !aligned(lw) || !aligned(ls) ||
                    !aligned(tgt) || !aligned(mask))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_x, n);
  const float* w = static_cast<const float*>(lw);
  const float* s = static_cast<const float*>(ls);
  const int64_t* t = static_cast<const int64_t*>(tgt);
  const float* m = static_cast<const float*>(mask);
  float* p = static_cast<float*>(partials);
  unsigned* cnt = static_cast<unsigned*>(counter);
  float* o = static_cast<float*>(out);
  return vec == 4 ? launch_fwd<4>(c, grid, st, w, s, t, m, hw, s_n, s_c, chunk, ignore, p, cnt, o)
                  : launch_fwd<1>(c, grid, st, w, s, t, m, hw, s_n, s_c, chunk, ignore, p, cnt, o);
}

int fused_loss_bwd(const void* lw, const void* ls, const void* tgt,
                   const void* mask, const void* scal, void* dlw, void* dls,
                   int c, long long npix, int hw, long long s_n, long long s_c,
                   int ignore, int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DISPATCH_C(c, bwd_kernel, grid, st,
             static_cast<const float*>(lw), static_cast<const float*>(ls),
             static_cast<const int64_t*>(tgt), static_cast<const float*>(mask),
             static_cast<const float*>(scal), npix, hw, s_n, s_c, ignore,
             static_cast<float*>(dlw), static_cast<float*>(dls));
  return (int)cudaGetLastError();
}

int fused_loss_out_size() { return kOut; }

const char* fused_loss_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
