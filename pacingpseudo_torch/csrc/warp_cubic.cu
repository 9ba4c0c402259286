// Direct-read cubic warp, for Hopper: the whole fused cubic warp of the
// augmentation in one launch.
//
// Replaces the TPU kernel of pacingpseudo_tpu/ops/pallas/warp_table.py:
//   warp_cubic_kernel  <-  _kernel  (:32, called by build_warp_table at :69)
// together with everything that follows the table in
// ops/warp.py::fused_warp_sample_cubic: the row gather, the Keys weights,
// the live-range masks and their renormalisation, the 16 tap terms, the
// clip and the two 4-tap class votes.
//
// Why the planes and not a table.  On the TPU the 24-lane table exists so
// that one row gather feeds a pixel's whole cubic tap from VMEM.  On the
// card it is a detour: 8 times the bytes of the planes it is built from,
// written and read again, and the arithmetic after the gather is some 370
// separate elementwise launches.  The three planes of a batch (12 x 256 x
// 256 float32, 9.4 MB) sit in the 50 MB L2, and neighbouring output pixels
// read neighbouring source pixels, so each thread reads its 16 image taps
// and 8 class taps straight from the planes through L1 (__ldg).
//
// Bound: device-memory bytes.  The three (N, H, W) planes and the (N, h, w)
// coordinates sy, sx are read once, the image and two class maps written
// once: 8 float32 values a pixel at H = h, W = w, 25.2 MB at 12 x 256 x 256,
// about 7.5 us at 3.35 TB/s.  The arithmetic (some 290 float32 operations a
// pixel, compares included) takes about 3.4 us at 67 TFLOP/s.
//
// Design: one thread per output pixel, grid (pixels / 256, N), so the
// sample index needs no division; coalesced loads of sy, sx and stores of
// the three outputs.  The taps sit at the table's wrapped indices
// ((y0-1+r) mod H, (x0-1+c) mod W) and the 2x2 corners of (y0, x0) mod H,
// W: every zero-weight product multiplies the same finite value as on the
// table route.  Arithmetic in the plain version's order of operations
// (ops/warp.py cubic_taps_and_votes), each product and sum rounded on its
// own (__fmul_rn, __fadd_rn, an IEEE division), so the result equals the
// table route bit for bit.  The per-sample clip range [lo, hi] of the live
// region comes in as two arrays (two PyTorch reductions before the launch).
//
// Plain C interface, loaded with ctypes (pacingpseudo_torch/ops/_build.py).
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// v mod n for any v and n >= 1 (the plain version's remainder); the
// division runs only for the taps that cross the canvas edge.
__device__ __forceinline__ int wrap(int v, int n) {
  if (v < 0 || v >= n) {
    v %= n;
    if (v < 0) v += n;
  }
  return v;
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// Keys' weights as ops/warp.py _keys_cubic_weights forms them: a2 = a + 2
// and a3 = a + 3 as the host rounds them to float.
__device__ __forceinline__ float w_near(float s, float a2, float a3) {
  const float s2 = mul(s, s);
  return add(sub(mul(a2, mul(s2, s)), mul(a3, s2)), 1.f);
}
__device__ __forceinline__ float w_far(float s, float a) {
  const float s2 = mul(s, s);
  return mul(a, sub(add(sub(mul(s2, s), mul(5.f, s2)), mul(8.f, s)), 4.f));
}

// The four weights at offsets -1..2, each times its live-range mask.
__device__ __forceinline__ void cubic_weights(float f, int i0, int bound, float a, float a2,
                                              float a3, float (&wt)[4]) {
  wt[0] = w_far(add(f, 1.f), a);
  wt[1] = w_near(f, a2, a3);
  wt[2] = w_near(sub(1.f, f), a2, a3);
  wt[3] = w_far(sub(2.f, f), a);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = i0 - 1 + k;
    wt[k] = mul(wt[k], (i >= 0 && i <= bound - 1) ? 1.f : 0.f);
  }
}

// Strict '>' over the classes: a tie keeps the lower class.
__device__ __forceinline__ int vote(const float (&val)[4], const float (&wt)[4], int num_values) {
  float best = 0.f;
  int cls = 0;
  for (int v = 0; v < num_values; ++v) {
    const float fv = (float)v;
    float s = mul(wt[0], val[0] == fv ? 1.f : 0.f);
#pragma unroll
    for (int k = 1; k < 4; ++k) s = add(s, mul(wt[k], val[k] == fv ? 1.f : 0.f));
    if (v == 0 || s > best) {
      best = s;
      cls = v;
    }
  }
  return cls;
}

__global__ void __launch_bounds__(kThreads) warp_cubic_kernel(
    const float* __restrict__ img, const float* __restrict__ lab,
    const float* __restrict__ scb, const float* __restrict__ sy_in,
    const float* __restrict__ sx_in, const float* __restrict__ bound_h,
    const float* __restrict__ bound_w, const float* __restrict__ lo_in,
    const float* __restrict__ hi_in, float* __restrict__ img_out, int* __restrict__ lab_out,
    int* __restrict__ scb_out, int hs, int ws, int h, int w, int num_values, float a,
    float a2, float a3) {
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= h * w) return;
  const int n = blockIdx.y;
  const long long o = (long long)n * h * w + pix;
  const long long plane = (long long)n * hs * ws;
  const float bh = __ldg(bound_h + n), bw = __ldg(bound_w + n);
  const int bh_i = (int)bh, bw_i = (int)bw;

  // The clamped anchor (ops/warp.py _anchor).
  const float sy = fminf(fmaxf(__ldg(sy_in + o), 0.f), sub(bh, 1.f));
  const float sx = fminf(fmaxf(__ldg(sx_in + o), 0.f), sub(bw, 1.f));
  const int y0 = (int)floorf(sy), x0 = (int)floorf(sx);
  const float fy = sub(sy, (float)y0), fx = sub(sx, (float)x0);

  // Image: 16 taps, masked and renormalised Keys weights.
  float wy[4], wx[4];
  cubic_weights(fy, y0, bh_i, a, a2, a3, wy);
  cubic_weights(fx, x0, bw_i, a, a2, a3, wx);
  const float ny = add(add(add(wy[0], wy[1]), wy[2]), wy[3]);
  const float nx = add(add(add(wx[0], wx[1]), wx[2]), wx[3]);
  int cols[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) cols[c] = wrap(x0 - 1 + c, ws);
  float acc = 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float* row = img + plane + (long long)wrap(y0 - 1 + r, hs) * ws;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float term = mul(mul(wy[r], wx[c]), __ldg(row + cols[c]));
      acc = (r == 0 && c == 0) ? term : add(acc, term);
    }
  }
  acc = __fdiv_rn(acc, mul(ny, nx));
  img_out[o] = fmaxf(fminf(acc, __ldg(hi_in + n)), __ldg(lo_in + n));

  // Labels and scribbles: the bilinear vote over the 2x2 corners.
  const float gy = sub(1.f, fy), gx = sub(1.f, fx);
  const float wb[4] = {mul(gy, gx), mul(gy, fx), mul(fy, gx), mul(fy, fx)};
  const long long r0 = plane + (long long)wrap(y0, hs) * ws;
  const long long r1 = plane + (long long)wrap(y0 + 1, hs) * ws;
  const int c0 = wrap(x0, ws), c1 = wrap(x0 + 1, ws);
  const float lv[4] = {__ldg(lab + r0 + c0), __ldg(lab + r0 + c1), __ldg(lab + r1 + c0),
                       __ldg(lab + r1 + c1)};
  const float sv[4] = {__ldg(scb + r0 + c0), __ldg(scb + r0 + c1), __ldg(scb + r1 + c0),
                       __ldg(scb + r1 + c1)};
  lab_out[o] = vote(lv, wb, num_values);
  scb_out[o] = vote(sv, wb, num_values);
}

}  // namespace

extern "C" {

// img, lab, scb: contiguous (n, hs, ws) float32 canvases; sy, sx: (n, h, w)
// float32 source coordinates; bound_h, bound_w, lo, hi: (n,) float32 live
// extents and clip range -> img_out (n, h, w) float32, lab_out, scb_out
// (n, h, w) int32.  a2 = a + 2 and a3 = a + 3 as the host rounds them.
int warp_cubic(const void* img, const void* lab, const void* scb, const void* sy,
               const void* sx, const void* bound_h, const void* bound_w, const void* lo,
               const void* hi, void* img_out, void* lab_out, void* scb_out, int n, int hs,
               int ws, int h, int w, int num_values, float a, float a2, float a3,
               void* stream) {
  if (n <= 0 || n > 65535 || hs <= 0 || ws <= 0 || h <= 0 || w <= 0 || num_values <= 0 ||
      (long long)h * w > 2147483647LL - kThreads)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((h * w + kThreads - 1) / kThreads), (unsigned)n);
  warp_cubic_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(lab),
      static_cast<const float*>(scb), static_cast<const float*>(sy),
      static_cast<const float*>(sx), static_cast<const float*>(bound_h),
      static_cast<const float*>(bound_w), static_cast<const float*>(lo),
      static_cast<const float*>(hi), static_cast<float*>(img_out),
      static_cast<int*>(lab_out), static_cast<int*>(scb_out), hs, ws, h, w, num_values, a,
      a2, a3);
  return (int)cudaGetLastError();
}

const char* warp_cubic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
