// Fused pce / entropy / soft-CE loss of the pacing objective, for Hopper.
//
// Replaces the TPU kernels of pacingpseudo_tpu/ops/pallas/fused_loss.py:
//   fwd_partials_kernel + fwd_finalize_kernel  <-  _fwd_kernel  (:60)
//   bwd_kernel                                 <-  _bwd_kernel  (:96)
//
// Both passes read the weak and the strong logit fields once (NCHW, f32,
// each (H, W) class plane contiguous), the int64 scribble target and the
// f32 valid mask; the backward also writes the two gradient fields.  There
// are a handful of flops per byte, so both are bound by device-memory
// bytes: at the CHAOS step (12 x 5 x 256 x 256) the forward moves 40.9 MB
// and the backward 72.4 MB, about 12 and 22 us at 3.35 TB/s.
//
// Design.  One thread per pixel in a grid-stride loop: it loads the C
// logits of each stream (C = 2..5, a template parameter, so the loops
// unroll and everything stays in registers), forms both softmaxes and
// keeps the five partial sums.  Neighbouring threads take neighbouring
// pixels, so every class-plane load is coalesced without a transpose.
// The TPU kernel carried its sums across a sequential grid in SMEM; Hopper
// blocks run in no order, so the forward reduces in two stages instead:
// warp shuffles and shared memory give one row of partials per block, and
// a one-block kernel adds the rows in a fixed order in double precision
// and forms the three losses on the device.  No float atomics: the result
// is the same from run to run.  The backward reads its three scale factors
// from device memory, so the step needs no host sync.
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

// Softmax and log-softmax over the C logits at ``base`` (class stride s_c),
// in the TPU kernel's order: max, exp(x - max), log of the sum.
template <int C>
__device__ __forceinline__ void softmax_terms(const float* __restrict__ base,
                                              long long s_c, float* p,
                                              float* lp) {
  float x[C];
#pragma unroll
  for (int k = 0; k < C; ++k) x[k] = base[k * s_c];
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// One row of kSums partial sums per block.
template <int C>
__global__ void __launch_bounds__(kThreads) fwd_partials_kernel(
    const float* __restrict__ lw, const float* __restrict__ ls,
    const int64_t* __restrict__ tgt, const float* __restrict__ mask,
    long long npix, int hw, long long s_n, long long s_c, int ignore,
    float* __restrict__ partials) {
  float acc[kSums] = {0.f, 0.f, 0.f, 0.f, 0.f};
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < npix;
       i += step) {
    const long long n = i / hw;
    const long long off = n * s_n + (i - n * hw);
    float pw[C], lpw[C], ps[C], lps[C];
    softmax_terms<C>(lw + off, s_c, pw, lpw);
    softmax_terms<C>(ls + off, s_c, ps, lps);
    const long long t = tgt[i];
    const float mk = mask[i];
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

  __shared__ float warp_rows[kSums][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < kSums; ++s) {
    const float v = warp_sum(acc[s]);
    if (lane == 0) warp_rows[s][warp] = v;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int s = 0; s < kSums; ++s) {
      const float v = warp_sum(lane < kWarps ? warp_rows[s][lane] : 0.f);
      if (lane == 0) partials[(long long)blockIdx.x * kSums + s] = v;
    }
  }
}

// Adds the per-block rows in a fixed order and forms the losses:
// out = [pce_sum, pce_cnt, ent_sum, sce_sum, mask_sum,
//        pce, ent, sce, max(cnt, eps), max(msum, eps), max(msum, eps)].
__global__ void __launch_bounds__(kThreads) fwd_finalize_kernel(
    const float* __restrict__ partials, int rows, float* __restrict__ out) {
  __shared__ double sm[kSums][kThreads];
  double acc[kSums] = {0.0, 0.0, 0.0, 0.0, 0.0};
  for (int r = threadIdx.x; r < rows; r += kThreads) {
#pragma unroll
    for (int s = 0; s < kSums; ++s) acc[s] += partials[(long long)r * kSums + s];
  }
#pragma unroll
  for (int s = 0; s < kSums; ++s) sm[s][threadIdx.x] = acc[s];
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
#pragma unroll
      for (int s = 0; s < kSums; ++s) sm[s][threadIdx.x] += sm[s][threadIdx.x + stride];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    float sums[kSums];
#pragma unroll
    for (int s = 0; s < kSums; ++s) {
      sums[s] = (float)sm[s][0];
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
  }
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

// Forward: ``grid`` blocks write ``partials`` (grid x 5 floats), then one
// block writes the 11 floats of ``out``.
int fused_loss_fwd(const void* lw, const void* ls, const void* tgt,
                   const void* mask, void* partials, void* out, int c,
                   long long npix, int hw, long long s_n, long long s_c,
                   int ignore, int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DISPATCH_C(c, fwd_partials_kernel, grid, st,
             static_cast<const float*>(lw), static_cast<const float*>(ls),
             static_cast<const int64_t*>(tgt), static_cast<const float*>(mask),
             npix, hw, s_n, s_c, ignore, static_cast<float*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fwd_finalize_kernel<<<1, kThreads, 0, st>>>(
      static_cast<const float*>(partials), grid, static_cast<float*>(out));
  return (int)cudaGetLastError();
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
