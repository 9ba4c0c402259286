// The fused ConvLayer's two convolutions in bfloat16, redesigned for Hopper:
// wgmma on the tensor cores, TMA loads into a ring of shared-memory stages.
//
// Replaces, on the route that ops/fused_convbn.py's conv_plan() calls "wgmma",
// the TPU kernels of pacingpseudo_tpu/ops/pallas/fused_convbn.py:
//   conv_stats   (pad_out = 0)  <-  _conv_stats_kernel   (:127)
//   conv_pad_out (pad_out = 1)  <-  _conv_pad_out_kernel (:201)
// The "simple" route (float32, Cin = 1, shapes the tiles do not cover
// exactly) stays conv3x3_kernel of csrc/fused_convbn.cu.
//
// One implicit GEMM for both.  M = the output pixels of the image's interior
// (never the border), N = the output channels, K = 9 x the input canvas's
// channels, one tap per K tile.  At the train step's shapes it does
// 2*9*Cin*Cout operations a pixel; from Cin = 64 at 128x128 on that is above
// the card's balance point, so the bound is the tensor cores; the 256x256
// layers (Cin 32, 96) and the Cin 32 / 64 layers at 128x128 are bound by
// their bytes.  Design, for both bounds:
//  * An M tile is a rectangle of box_h rows by box_w columns of one image
//    (box_h * box_w = 128).  A's K tile for tap (dh, dw) and channel block c0
//    is one TMA box {BK, box_w, box_h, 1} of the padded input canvas
//    (C, W+2, H+2, N) at (c0, w0+dw, h0+dh, img): a shifted window that never
//    leaves the canvas, so the loop has no address or predicate arithmetic.
//  * B is the weights as a K-major (N, 9*Cin) matrix (the wrapper transposes
//    the (9, Cin, Cout) weights), one TMA box {BK, BN} a K tile.  A and B are
//    K-major with rows of BK bfloat16: BK = 64 (128-byte rows, 128-byte
//    swizzle) or BK = 32 (64-byte rows, 64-byte swizzle), and the wgmma
//    descriptors name the same swizzle.
//  * One producer warpgroup (one thread issues the TMA loads) fills a ring
//    of 3-6 stages guarded by full/empty mbarriers; two consumer warpgroups
//    each run wgmma m64nBNk16 on 64 of the tile's 128 rows, float32
//    accumulators in registers.  BN is fitted to the layer (32, 64, 96,
//    128 or 256), so no N tile is half idle.  Up to BN = 96 two blocks share
//    an SM; above, one block.  setmaxnreg moves registers from the producer
//    to the consumers.  Each consumer keeps one K tile's
//    products in flight while it waits for the next tile.
//  * Epilogue from the accumulator fragments.  conv_stats adds the bias,
//    forms sum y and sum y^2 from the float32 values (before the bf16 cast,
//    as the TPU kernel does) by warp shuffles and then shared memory, and
//    writes one row of partials per M TILE (not per block), in a fixed
//    order; reduce_rows_kernel (fused_convbn.cu) adds the rows.  Both kernels
//    stage the bf16 tile in shared memory of its own (not the ring, which
//    the producer is refilling) and store it with coalesced 16-byte stores;
//    conv_pad_out
//    writes its centre at (+1, +1) of dxp, and the tiles that own an image's
//    first or last row or column also write that stretch of the zero border
//    (corners belong to the top and bottom rows' owners), in the same launch.
//  * A persistent grid (plan's `grid` blocks, at most blocks_per_sm x SMs)
//    walks the output tiles, so the producer loads the next tile while the
//    consumers store this one.
//
// Plain C interface, loaded with ctypes (pacingpseudo_torch/ops/_build.py).
// The TMA descriptors are encoded on the host at each call by
// cuTensorMapEncodeTiled, looked up at run time through the runtime's entry
// point query, so the library needs no -lcuda.  The entry point validates the plan it is
// given and returns cudaErrorInvalidValue for any plan it does not take.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;           // output pixels a tile: 2 consumer warpgroups x 64 rows
constexpr int kConsumers = 256;    // threads of the two consumer warpgroups
constexpr int kThreads = 384;      // + the producer warpgroup
constexpr int kSmemLimit = 232448; // dynamic shared memory a block may use
constexpr int kSmemTwoBlocks = 115712;   // each of two blocks on one SM (228 KB - 2 x 1 KB) / 2
constexpr int kMinStages = 3, kMaxStages = 6;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Returns once the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile in shared memory whose rows are
// kRowBytes (128: 128-byte swizzle, 64: 64-byte swizzle) as TMA wrote them:
// start address, leading byte offset (unused for a swizzled K-major tile),
// stride byte offset = one 8-row group, layout type.  A K step of 16
// bfloat16 within the row advances the start address by 32 bytes.
template <int kRowBytes>
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  uint64_t d = (smem_u32(p) & 0x3FFFFu) >> 4;
  d |= uint64_t(1) << 16;
  d |= uint64_t((8 * kRowBytes) >> 4) << 32;
  d |= uint64_t(kRowBytes == 128 ? 1 : 2) << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kInFlight>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kInFlight) : "memory");
}
// Keeps the compiler from touching an accumulator register across the
// asynchronous products.
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// D (64 x BN, float32, in registers) = A (64 x 16) B (16 x BN) + (scale_d ?
// D : 0), A and B bfloat16 K-major in shared memory.  Thread t of the
// warpgroup holds d[4j + 2i + c] = D[16 (t / 32) + (t % 32) / 4 + 8i][8j +
// 2 (t % 4) + c].
template <int BN>
__device__ __forceinline__ void wgmma_bf16(float (&d)[BN / 2], uint64_t da, uint64_t db,
                                           int scale_d);

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<96>(float (&d)[48], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<256>(float (&d)[128], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

struct ConvParams {
  int n, h, wd, cin, cout, box_w, box_h, stages, pad_out;
  const float* bias;      // (cout,) float32; conv_stats only
  __nv_bfloat16* out;     // y (n, h, wd, cout) or dxp (n, h+2, wd+2, cout)
  float* partials;        // (M tiles, 2*cout) float32; conv_stats only
};

template <int BN, int BK>
__host__ __device__ constexpr int stage_bytes() { return (kBM + BN) * BK * 2; }

// Blocks an SM holds.  Up to BN = 96 the consumers need few registers
// (16-48 accumulators), so two blocks share an SM and one's epilogue
// overlaps the other's products; wider tiles take one block.  Either way
// setmaxnreg moves registers from the producer to the consumers: of 168 a
// thread (one block) to 40 and 232, of 80 (two blocks) to 24 and 104.
template <int BN>
__host__ __device__ constexpr int blocks_per_sm() { return BN <= 96 ? 2 : 1; }

// Floats of the statistics' reduction rows, [2][8 warps][BN] (conv_stats
// only).
template <int BN>
__host__ __device__ constexpr int red_floats(int pad_out) { return pad_out ? 0 : 16 * BN; }

// Dynamic shared memory of a launch: the ring, the staged bf16 output tile,
// the reduction rows, the 2 * stages barriers, and room to align the ring to
// 1024 bytes (the 128-byte swizzle's period).
template <int BN, int BK>
int smem_bytes(int stages, int pad_out) {
  return stages * stage_bytes<BN, BK>() + kBM * BN * 2 + red_floats<BN>(pad_out) * 4 +
         16 * stages + 1024;
}

// Element offset of (row, 8-column chunk) in the staged [kBM][BN] bf16
// output tile; the chunk is XOR-swizzled by the row (within aligned groups
// of 8 chunks, or of 4 where BN / 8 is not a multiple of 8) so that the
// fragment stores of 8 rows fall in different banks.
template <int BN>
__device__ __forceinline__ int staged(int row, int chunk) {
  constexpr int kMask = (BN / 8) % 8 == 0 ? 7 : 3;
  return row * BN + ((chunk ^ (row & kMask)) << 3);
}

// A persistent grid: block b takes tiles b, b + gridDim.x, ...; tile t is M
// tile t % m_tiles of N tile t / m_tiles, so the blocks in flight share an
// N tile and neighbouring M tiles (and their halos) in L2.  The producer
// runs on into the next tile's K tiles while the consumers store this one.
template <int BN, int BK>
__global__ void __launch_bounds__(kThreads, blocks_per_sm<BN>()) conv_wgmma_kernel(
    const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap b_map,
    const ConvParams p) {
  constexpr int kRowBytes = BK * 2;
  constexpr int kABytes = kBM * kRowBytes;
  constexpr int kStageBytes = stage_bytes<BN, BK>();
  constexpr int kFrag = BN / 2;
  constexpr int kVecs = BN / 8;     // 16-byte vectors in a pixel's BN channels

  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(ring + p.stages * kStageBytes);
  float* red = reinterpret_cast<float*>(tile + kBM * BN);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + red_floats<BN>(p.pad_out));
  uint64_t* empty = full + p.stages;

  const int tid = threadIdx.x;
  const int tiles_w = p.wd / p.box_w;
  const int tiles_img = tiles_w * (p.h / p.box_h);
  const int m_tiles = p.n * tiles_img;
  const int n_tiles = m_tiles * (p.cout / BN);
  const int cblocks = p.cin / BK;
  const int n_k = 9 * cblocks;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // Producer warpgroup: one thread keeps the ring full, across tiles.
    if constexpr (blocks_per_sm<BN>() == 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    else
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == kConsumers) {
      int g = 0;   // K tiles loaded by this block so far
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int m = t % m_tiles, img = m / tiles_img, rem = m % tiles_img;
        const int h0 = (rem / tiles_w) * p.box_h, w0 = (rem % tiles_w) * p.box_w;
        const int n0 = (t / m_tiles) * BN;
        for (int kt = 0; kt < n_k; ++kt, ++g) {
          const int s = g % p.stages;
          const int round = g / p.stages;
          if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
          unsigned char* a = ring + s * kStageBytes;
          const int tap = kt / cblocks;
          mbar_expect_tx(&full[s], kStageBytes);
          tma_load_4d(a, &a_map, &full[s], (kt - tap * cblocks) * BK, w0 + tap % 3,
                      h0 + tap / 3, img);
          tma_load_2d(a + kABytes, &b_map, &full[s], kt * BK, n0);
        }
      }
    }
  } else {
    if constexpr (blocks_per_sm<BN>() == 1)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    else
      asm volatile("setmaxnreg.inc.sync.aligned.u32 104;\n");
    const int wg = tid / 128, warp = tid / 32, lane = tid & 31;
    const int row = wg * 64 + (warp & 3) * 16 + lane / 4;   // and row + 8
    int g = 0;   // K tiles consumed by this block so far
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      // No zeroing: the tile's first product overwrites the accumulators
      // (scale_d 0), so no other instruction defines them while products
      // are in flight.
      float acc[kFrag];
      for (int kt = 0; kt < n_k; ++kt, ++g) {
        const int s = g % p.stages;
        mbar_wait(&full[s], (g / p.stages) & 1);
        const unsigned char* a = ring + s * kStageBytes + wg * 64 * kRowBytes;
        const unsigned char* b = ring + s * kStageBytes + kABytes;
#pragma unroll
        for (int i = 0; i < kFrag; ++i) fence_operand(acc[i]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_bf16<BN>(acc, smem_desc<kRowBytes>(a + kk * 32),
                         smem_desc<kRowBytes>(b + kk * 32), kt > 0 || kk > 0);
        wgmma_commit();
        // Keep this K tile's products in flight; once the previous tile's
        // are done, its stage goes back to the producer.
        wgmma_wait<1>();
#pragma unroll
        for (int i = 0; i < kFrag; ++i) fence_operand(acc[i]);
        if (kt > 0 && lane == 0) mbar_arrive(&empty[(g - 1) % p.stages]);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kFrag; ++i) fence_operand(acc[i]);
      if (lane == 0) mbar_arrive(&empty[(g - 1) % p.stages]);

      // Epilogue, once the previous tile's stores have read the staged tile
      // and the statistics rows.
      const int m = t % m_tiles, img = m / tiles_img, rem = m % tiles_img;
      const int h0 = (rem / tiles_w) * p.box_h, w0 = (rem % tiles_w) * p.box_w;
      const int n0 = (t / m_tiles) * BN;
      const int hp = p.pad_out ? p.h + 2 : p.h, wp = p.pad_out ? p.wd + 2 : p.wd;
      const int off = p.pad_out ? 1 : 0;
      // The output pixel of tile row r.
      auto pixel = [&](int r) {
        return ((long long)img * hp + h0 + r / p.box_w + off) * wp + w0 + r % p.box_w + off;
      };
      consumers_sync();
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + 2 * (lane & 3);
        const float b0 = p.pad_out ? 0.f : p.bias[n0 + col];
        const float b1 = p.pad_out ? 0.f : p.bias[n0 + col + 1];
        const float v00 = acc[4 * j] + b0, v01 = acc[4 * j + 1] + b1;
        const float v10 = acc[4 * j + 2] + b0, v11 = acc[4 * j + 3] + b1;
        *reinterpret_cast<__nv_bfloat162*>(tile + staged<BN>(row, j) + 2 * (lane & 3)) =
            __floats2bfloat162_rn(v00, v01);
        *reinterpret_cast<__nv_bfloat162*>(tile + staged<BN>(row + 8, j) + 2 * (lane & 3)) =
            __floats2bfloat162_rn(v10, v11);
        if (!p.pad_out) {
          // Column sums over the warp's 16 rows: the thread's two rows,
          // then the 8 lanes that share lane % 4.
          float s[4] = {v00 + v10, v01 + v11, v00 * v00 + v10 * v10, v01 * v01 + v11 * v11};
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int off = 4; off < 32; off *= 2) s[q] += __shfl_xor_sync(0xffffffffu, s[q], off);
          if (lane < 4) {
            red[warp * BN + col] = s[0];
            red[warp * BN + col + 1] = s[1];
            red[(8 + warp) * BN + col] = s[2];
            red[(8 + warp) * BN + col + 1] = s[3];
          }
        }
        // Keeps the compiler from hoisting every column's bias load (BN of
        // them) above the first stores: registers stay for the accumulators.
        asm volatile("" ::: "memory");
      }
      consumers_sync();

      for (int i = tid; i < kBM * kVecs; i += kConsumers) {
        const int r = i / kVecs, q = i - (i / kVecs) * kVecs;
        *reinterpret_cast<uint4*>(p.out + pixel(r) * p.cout + n0 + 8 * q) =
            *reinterpret_cast<const uint4*>(tile + staged<BN>(r, q));
      }
      if (p.pad_out) {
        // The zero border next to this tile: the top (bottom) row over the
        // tile's columns if it owns the image's first (last) row, with the
        // corners where it also owns the first (last) column; the left
        // (right) column over the tile's rows if it owns the first (last)
        // column.
        const bool first_w = w0 == 0, last_w = w0 + p.box_w == p.wd;
        const int wlo = first_w ? 0 : w0 + 1, whi = last_w ? p.wd + 1 : w0 + p.box_w;
        const int n_top = h0 == 0 ? whi - wlo + 1 : 0;
        const int n_bot = h0 + p.box_h == p.h ? whi - wlo + 1 : 0;
        const int n_left = first_w ? p.box_h : 0, n_right = last_w ? p.box_h : 0;
        const int n_px = n_top + n_bot + n_left + n_right;
        for (int i = tid; i < n_px * kVecs; i += kConsumers) {
          int e = i / kVecs, hh, ww;
          const int q = i - e * kVecs;
          if (e < n_top) {
            hh = 0, ww = wlo + e;
          } else if ((e -= n_top) < n_bot) {
            hh = p.h + 1, ww = wlo + e;
          } else if ((e -= n_bot) < n_left) {
            hh = h0 + 1 + e, ww = 0;
          } else {
            hh = h0 + 1 + (e - n_left), ww = p.wd + 1;
          }
          const long long px = ((long long)img * hp + hh) * wp + ww;
          *reinterpret_cast<uint4*>(p.out + px * p.cout + n0 + 8 * q) = make_uint4(0u, 0u, 0u, 0u);
        }
      } else if (tid < BN) {
        // One row of partials per M tile, the 8 warps added in a fixed
        // order: the same sums however the tiles were scheduled.
        float t1 = 0.f, t2 = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          t1 += red[w * BN + tid];
          t2 += red[(8 + w) * BN + tid];
        }
        float* prow = p.partials + (long long)m * 2 * p.cout;
        prow[n0 + tid] = t1;
        prow[p.cout + n0 + tid] = t2;
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A bfloat16 tensor map with box `box` over `dims` (innermost first),
// `strides` in bytes for dims 1.., swizzled to rows of box[0] elements.
bool encode(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      box[0] * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides,
            box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, int BK>
cudaError_t launch(const void* x, const void* wk, const ConvParams& p, int grid,
                   cudaStream_t st) {
  const int limit = blocks_per_sm<BN>() == 2 ? kSmemTwoBlocks : kSmemLimit;
  if (smem_bytes<BN, BK>(p.stages, p.pad_out) > limit) return cudaErrorInvalidValue;
  const cuuint64_t es = 2;   // bytes of a bfloat16
  CUtensorMap a_map, b_map;
  const cuuint64_t a_dims[4] = {(cuuint64_t)p.cin, (cuuint64_t)p.wd + 2, (cuuint64_t)p.h + 2,
                                (cuuint64_t)p.n};
  const cuuint64_t a_strides[3] = {es * p.cin, es * p.cin * (p.wd + 2),
                                   es * p.cin * (p.wd + 2) * (p.h + 2)};
  const cuuint32_t a_box[4] = {BK, (cuuint32_t)p.box_w, (cuuint32_t)p.box_h, 1};
  const cuuint64_t b_dims[2] = {(cuuint64_t)9 * p.cin, (cuuint64_t)p.cout};
  const cuuint64_t b_strides[1] = {es * 9 * p.cin};
  const cuuint32_t b_box[2] = {BK, BN};
  if (!encode(&a_map, x, 4, a_dims, a_strides, a_box) ||
      !encode(&b_map, wk, 2, b_dims, b_strides, b_box))
    return cudaErrorInvalidValue;
  static bool attribute_set = false;
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_wgmma_kernel<BN, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  conv_wgmma_kernel<BN, BK><<<grid, kThreads, smem_bytes<BN, BK>(p.stages, p.pad_out), st>>>(
      a_map, b_map, p);
  return cudaGetLastError();
}

template <int BK>
cudaError_t launch_bn(int bn, const void* x, const void* wk, const ConvParams& p, int grid,
                      cudaStream_t st) {
  switch (bn) {
    case 32: return launch<32, BK>(x, wk, p, grid, st);
    case 64: return launch<64, BK>(x, wk, p, grid, st);
    case 96: return launch<96, BK>(x, wk, p, grid, st);
    case 128: return launch<128, BK>(x, wk, p, grid, st);
    case 256: return launch<256, BK>(x, wk, p, grid, st);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

extern "C" {

// One launch of the plan (bn, bk, box_w, box_h, stages, rows, grid) that
// ops/fused_convbn.py's conv_plan() made: `grid` blocks walk the rows x
// cout / bn output tiles.  x: the padded input canvas
// (n, h+2, wd+2, cin) bfloat16; wk: the weights K-major, (cout, 9*cin)
// bfloat16 with column t*cin + c for tap t = 3*dh + dw.
//   pad_out = 0 (conv_stats): out = y (n, h, wd, cout), bias (cout,)
//     float32, partials (rows, 2*cout) float32, one row per M tile;
//   pad_out = 1 (conv_pad_out): out = dxp (n, h+2, wd+2, cout) with a zero
//     border; bias and partials unused.
// Returns cudaErrorInvalidValue, launching nothing, for a plan it does not
// take; else cudaGetLastError() after the launch.
int conv_wgmma(const void* x, const void* wk, const void* bias, void* out, void* partials,
               int n, int h, int wd, int cin, int cout, int pad_out, int bn, int bk, int box_w,
               int box_h, int stages, int rows, int grid, void* stream) {
  const bool ok =
      n > 0 && box_w > 0 && box_h > 0 && box_w * box_h == kBM && h % box_h == 0 &&
      wd % box_w == 0 && (bk == 32 || bk == 64) && cin > 0 && cin % bk == 0 && bn > 0 &&
      cout % bn == 0 && stages >= kMinStages && stages <= kMaxStages &&
      (long long)rows == (long long)n * (h / box_h) * (wd / box_w) && grid > 0 &&
      (long long)grid <= (long long)rows * (cout / bn) && (pad_out == 0 || pad_out == 1) &&
      aligned16(x) && aligned16(wk) && aligned16(out) &&
      (pad_out == 1 || (bias != nullptr && partials != nullptr));
  if (!ok) return (int)cudaErrorInvalidValue;
  ConvParams p{n, h, wd, cin, cout, box_w, box_h, stages, pad_out,
               static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out),
               static_cast<float*>(partials)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bk == 64 ? launch_bn<64>(bn, x, wk, p, grid, st)
                        : launch_bn<32>(bn, x, wk, p, grid, st));
}

}  // extern "C"
