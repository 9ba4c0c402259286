// Gather table of the fused cubic warp, for Hopper.
//
// Replaces the TPU kernel of pacingpseudo_tpu/ops/pallas/warp_table.py:
//   warp_table_kernel  <-  _kernel  (:32, called by build_warp_table at :69)
//
// For every pixel (y, x) of every sample the table holds one row of 24
// floats (96 bytes), which the warp later fetches with ONE row gather:
//   lanes  0..15: image[(y-1+r) % H, (x-1+c) % W], r, c in 0..3, lane 4r+c
//   lanes 16..19: label    at (y, x), (y, x+1), (y+1, x), (y+1, x+1), wrapped
//   lanes 20..23: scribble at the same four corners
// It is a pure copy, so the result equals the plain version (rolled planes
// stacked, ops/warp_table.py) bit for bit.
//
// Bound: device-memory bytes.  The three (N, H, W) f32 planes are read once
// and the table, 8 times their size, is written once; there is no
// arithmetic beyond index wrapping.  At the CHAOS step (12 x 256 x 256) that
// is 9.4 MB in and 75.5 MB out, about 25 us at 3.35 TB/s.
//
// Design.  The TPU kernel ran one program per image row and built the 24
// lanes with lane rolls and a transpose in VMEM.  Here the grid is flat over
// the OUTPUT: one thread per 16-byte quad of the table (6 quads per row:
// the four image rows of the 4x4 neighbourhood, the label corners, the
// scribble corners), so consecutive threads store consecutive float4s and
// every store is fully coalesced.  The wrapped source reads of neighbouring
// threads fall into the same few image rows and are served by L1/L2 through
// the read-only path.  One launch builds the table of the whole batch.
//
// Plain C interface, loaded with ctypes (pacingpseudo_torch/ops/_build.py).
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 24;
constexpr int kQuads = kLanes / 4;   // float4 stores per table row

// v mod n for v in [-1, n + 2] and any n >= 1.
__device__ __forceinline__ int wrap(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

__global__ void __launch_bounds__(kThreads) warp_table_kernel(
    const float* __restrict__ img, const float* __restrict__ lab,
    const float* __restrict__ scb, float4* __restrict__ out, long long quads,
    int h, int w) {
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (q >= quads) return;
  const int part = (int)(q % kQuads);
  const long long pix = q / kQuads;          // n * H * W + y * W + x
  const int x = (int)(pix % w);
  const long long row = pix / w;             // n * H + y
  const int y = (int)(row % h);
  const long long plane = (row / h) * (long long)h * w;

  float4 v;
  if (part < 4) {
    // Image row y - 1 + part of the 4x4 neighbourhood, columns x - 1 .. x + 2.
    const float* src = img + plane + (long long)wrap(y - 1 + part, h) * w;
    v.x = __ldg(src + wrap(x - 1, w));
    v.y = __ldg(src + x);
    v.z = __ldg(src + wrap(x + 1, w));
    v.w = __ldg(src + wrap(x + 2, w));
  } else {
    // The 2x2 corners (0,0), (0,1), (1,0), (1,1) of the label or scribble.
    const float* base = (part == 4 ? lab : scb) + plane;
    const float* r0 = base + (long long)y * w;
    const float* r1 = base + (long long)wrap(y + 1, h) * w;
    const int x1 = wrap(x + 1, w);
    v.x = __ldg(r0 + x);
    v.y = __ldg(r0 + x1);
    v.z = __ldg(r1 + x);
    v.w = __ldg(r1 + x1);
  }
  out[q] = v;
}

}  // namespace

extern "C" {

// ``img``, ``lab``, ``scb``: contiguous (n, h, w) f32.  ``out``: contiguous
// (n, h * w, 24) f32, 16-byte aligned.
int warp_table_build(const void* img, const void* lab, const void* scb,
                     void* out, int n, int h, int w, void* stream) {
  const long long quads = (long long)n * h * w * kQuads;
  if (quads <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (quads + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  warp_table_kernel<<<(unsigned)blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(lab),
      static_cast<const float*>(scb), static_cast<float4*>(out), quads, h, w);
  return (int)cudaGetLastError();
}

int warp_table_lanes() { return kLanes; }

const char* warp_table_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
