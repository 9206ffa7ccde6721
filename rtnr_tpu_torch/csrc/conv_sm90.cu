// K3's exact bf16 mode for Hopper: an implicit-GEMM 3x3 conv on TMA and wgmma,
// with the 2x2 max-pool and the 1x1 head fused into its epilogue.
//
// Replaces rtnr_tpu/ops/conv_phase.py::_conv_phase_kernel (wrapper
// conv3x3_phase) in its exact bf16 mode: a 3x3 stride-1 same conv over the
// virtual channel concat of one or two NHWC bf16 inputs, then bias and ReLU
// in f32 and one bf16 rounding. The fused options of the TPU kernel
// (conv_phase.py:81-82) are here too: `pooled` receives the 2x2/2 max-pool of
// the bf16 output; `hout` receives the 1x1 head (OC <= 8 outputs, f32 sums of
// the bf16 conv output, bias, bf16) and the conv output itself is not
// written. K10 (rtnr_tpu/ops/conv_pallas.py::_conv_kernel) has the same
// numerics and takes this kernel through the same route (ops/conv.py).
// It takes C0, C1 and F multiples of 64; everything else (the 5-channel input
// conv, the int8 modes, narrow nets) stays on conv.cu's gemm.
//
// Bound on this card: operations. The full-width net at 1088x1920 is 2.94
// TFLOP of 3x3 conv a frame, 2.97 ms at the H100 SXM's 989 TFLOP/s dense
// bf16; the largest activation (1088x1920x64 bf16, 267 MB) moves in ~0.08 ms.
// conv.cu's wmma kernel (mma.sync, one shared buffer, gathered A rows) ran at
// ~10% of that peak. Only wgmma reaches the tensor cores' full rate, so:
//
// - GEMM view: M = output pixels, N = F, K = 9 * (C0 + C1) in (tap, input,
//   channel) order. A block's output tile is a pixel rectangle of 8 rows x 16
//   columns (the 128 GEMM rows) by BN channels (64 where F is not a multiple
//   of 128, else 128).
// - A by TMA, padding for free: each pipeline stage is one (dx, input,
//   64-channel chunk): one 3D tiled TMA load of the box (64 c, 16 x, 10 y)
//   from that input's tensor map (dims {C, W, H}) at (c0, x0 + dx - 1,
//   y0 - 1), the tile's rows and the halo row above and below. Coordinates
//   outside the image (negative ones included) read zeros, so the conv's zero
//   padding and the ragged edge of the 68x120 bottleneck cost no
//   instructions. With CU_TENSOR_MAP_SWIZZLE_128B the pixel rows of 128 bytes
//   land as wgmma's K-major, 128B-swizzled A operand, and the three taps
//   (dy, dx) of the stage read it at row offsets 0, 16 and 32 (2 KB steps,
//   so every operand stays 1024-byte aligned). One box serving three taps
//   cuts the A traffic through L2 from 9 to 3.75 tile loads a chunk: with a
//   box per tap the kernel ran at 8-10 TB/s of L2 reads. Two inputs are two
//   tensor maps: the stages walk input 0's chunks, then input 1's, for each
//   dx, so no concat is built.
// - B by TMA from a K-major (F, K) copy of the weights that prepare_conv3x3
//   makes once (Conv3x3Weights.wmat_t), three boxes a stage (one per dy):
//   the (64 k x BN n) box is then laid
//   out exactly as A is (128-byte K rows, 128B swizzle), one descriptor form
//   serves both operands and no transpose bit is needed. The (K, F) row-major
//   wmat read as an MN-major B would need a 64-column box per 128 bytes of N
//   and the MN-major descriptor strides; the copy costs ~60 MB of device
//   memory for the full-width net. The weight row of channel c of input i
//   at tap t is t*(C0+C1) + (i ? C0 : 0) + c, as in conv.cu.
// - Pipeline: a ring of STAGES (A 20 KB + 3 x B BN x 128 B) buffers in
//   dynamic shared memory with full and empty mbarriers. Warpgroup 0 is the
//   producer: one thread issues the TMA loads (expect_tx is the full boxes,
//   even where a box is partly out of bounds). Warpgroups 1 and 2 are the
//   consumers: each runs wgmma m64nBNk16 on its 64 rows (twelve a stage: 3
//   taps x 4 k16 steps) with one group left in flight, and releases a stage
//   when the group that read it has retired. setmaxnreg is not used: at
//   BN = 128 one block of 384 threads holds an SM and every thread may keep
//   168 registers, more than a consumer needs; at BN = 64 two blocks share an
//   SM under __launch_bounds__(384, 2).
// - Short K loops: a 64-channel conv has 3 stages a tile, so the grid is
//   persistent (one or two blocks an SM, from the occupancy query) and walks
//   tiles; the producer runs ahead into the next tile while the consumers
//   finish the epilogue of this one.
// - Epilogue, per 64-channel block of the tile: bias in f32, ReLU, one bf16
//   rounding, staged in shared memory (8 KB a consumer; 16-byte chunks
//   XOR-swizzled by row, so the fragment writes are free of bank conflicts),
//   then 16-byte coalesced stores masked at the ragged edge. With `pool`, the
//   8x16 tile (origin on even rows and columns) holds whole 2x2 windows and
//   each consumer writes its 2x8 pooled pixels from the staged bf16 values:
//   bf16 rounding is monotone, so this equals the max-pool of the output bit
//   for bit. With `head` (BN == F: one tile holds every channel) two threads
//   a pixel sum half of each block's channels in f32, one 16-byte row of the
//   zero-padded (F, 8) head kernel a channel.
// - Determinism: no split-K and no atomics; a call gives the same bits every
//   time.
// - Tensor maps: the host encodes them per call (activations are new tensors
//   each call) with cuTensorMapEncodeTiled, fetched once through the runtime's
//   cudaGetDriverEntryPointByVersion (cudaGetDriverEntryPoint before CUDA
//   12.5), so the library links no -lcuda; they are passed as
//   __grid_constant__ kernel parameters. TMA needs a 16-byte-aligned base and
//   16-byte-multiple strides: C % 64 == 0 gives the strides, the wrapper
//   checks the alignment.
//
// conv3x3_up_wgmma is K3's fused-ConvTranspose mode (conv3x3_phase with
// up_kernel=, conv_phase.py:276-315, :720-780): input 1 is the decoder's
// half-resolution deep tensor and the conv reads [skip, up] with up = bf16(
// flax ConvTranspose 2x2/s2 of deep + bias), the up pixels past the image
// being the conv's zero padding. It runs the full-width U-Net's decoder
// levels 2 and 3 (skip 128 + up 128 -> 128 from 256 deep channels; 64 + 64
// -> 64 from 128), where JAX's fuse_up_ok fuses, and takes C_up == F in
// {64, 128}, so one tile (BN == F) holds every channel and computes its up
// values once. Bound: operations, 342 GFLOP a level (308 of conv, 34 of
// ConvTranspose) against ~0.27 GB moved: 0.346 ms at 989 TFLOP/s; the
// unfused pair writes and reads the up tensor (267 MB at updc3) besides.
// - Per tile, first a small implicit GEMM: the tile's up halo (10 x 18 up
//   pixels, rows y0-1 .. y0+8, columns x0-1 .. x0+16) comes from 6 x 10 =
//   60 deep pixels, one TMA box (64 c, 10 x, 6 y) a 64-channel chunk of
//   C_deep that fills 60 rows of an m64 wgmma. B is the K-major (4 C_up,
//   C_deep) copy of the flipped up kernel (ConvT2x2Weights.wmat_t), one
//   (64 k, 256 n) box a stage: 4 subpixels x 64 up channels. Consumer cw
//   takes subpixel row dy = cw (n 128, both dx). Its epilogue adds the bias,
//   rounds to bf16, writes zeros for up pixels outside [0,H) x [0,W) (the
//   ragged edges included), and puts each value at its place in a shared
//   up tile of 18-pixel rows (23 KB a 64-channel chunk, 16-byte chunks
//   XOR-swizzled by pixel).
// - Then the conv: the skip input's stages exactly as conv3x3_wgmma's; the
//   up tile's stages load only the three dy taps' weights, and take A from
//   registers (wgmma's RS form), ldmatrix'd from the up tile at the tap's
//   pixel shift. A TMA box or a wgmma descriptor would need each dx shift
//   of one pixel (128 bytes) on a 1024-byte swizzle boundary, three copies
//   of the tile: 120 KB at F = 128, more than the ring leaves.
// - Two 256-thread barriers a tile order the two consumers' up-tile writes
//   against their reads. The up GEMM and the RS stages wait for their wgmma
//   group before the next (the A registers are read asynchronously); the
//   skip stages keep one group in flight, as conv3x3_wgmma does.
// - Shared memory: a ring of 4 stages at F = 64 and 2 at F = 128 (an up
//   GEMM stage is 8 KB of deep box + 32 KB of weights, within a conv
//   stage), the up tile, the epilogue staging: 215 KB / 197 KB, one block
//   an SM; its own occupancy query.
// - It sums the up GEMM in another order than conv.cu's gemm<1,0> (K4), so
//   it is not bit-equal to the unfused card pair; no split-K and no
//   atomics, so a call gives the same bits every time.
//
// convt2x2_wgmma is K4's exact bf16 mode (rtnr_tpu/ops/conv_phase.py::
// _convt_phase_kernel, wrapper convt2x2_phase, conv_phase.py:1051-1320): a
// GEMM with M = H*W input pixels, N = 4F, K = C, bf16 operands and f32 sums,
// then y = acc + bias[f] in f32 (no ReLU), one bf16 rounding, written to
// output pixel (2y+dy, 2x+dx): conv.cu's gemm<1,0>, whose 128x64 blocks
// re-read A once per 64-column block, overlapped nothing in their 2-16 K
// steps and scattered one bf16 a thread.
// - Bound on this card, 0.2489 ms over the full-width net's four calls
//   (68x120x1024 -> 512, 136x240x512 -> 256, 272x480x256 -> 128,
//   544x960x128 -> 64): bytes at up2 and up3 (up3 moves 401 MB: 134 MB in,
//   267 MB out), operations at up0 and up1.
// - The structure of conv_i8_sm90.cu's convt2x2_i8_wgmma on bf16 wgmma
//   m64n256k16. A by TMA: a 2D map over the (H*W, C) view, boxes of (64
//   channels = 128 bytes, 128 pixels) with the 128B swizzle, each k16 step 32
//   bytes on. B by TMA from the K-major (4F, C) copy the fused kernel above
//   reads (ConvT2x2Weights.wmat_t): row (u*4 + dy*2 + dx)*64 + j holds
//   kernel[1-dy, 1-dx, :, 64u + j], so a 256-column N tile is one 64-channel
//   chunk u of all four subpixels, and 64 of its columns are the 128
//   contiguous bytes of one output pixel at channel 64u.
// - Tiles 128 x 256, N fastest, persistent grid: at up3 (4F = 256) A comes
//   from device memory once; elsewhere the N tiles of one M tile run side by
//   side and A comes from L2. B stays resident where the ring holds it (the
//   producer skips the B box of a stage that already holds it: up3, K = 128,
//   two stages a tile in a ring of four).
// - m64n256 f32 accumulators are 128 registers a consumer thread:
//   setmaxnreg 40 / 232 (sm90.cuh), and the host refuses a launch that does
//   not give 168 registers a thread (check_regs).
// - Epilogue, one subpixel (64 columns) at a time: bias in f32, one bf16
//   rounding, staged as conv3x3_wgmma stages (8 KB a consumer, 16-byte
//   chunks XOR-swizzled by row), then 16-byte stores; the ragged M (8160 at
//   up0) is masked and TMA zero-fills the rows past the end. Ring of 4
//   stages of 48 KB and the staging: 208 KB, one block an SM.
// - f32 sums in the tensor cores' order: within 2 bf16 ulp of the f32 twin,
//   not bit-equal to gemm<1,0>; no split-K and no atomics, so a call gives
//   the same bits every time.
// - Measured (chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W): 0.4234
//   ms over the four calls against 1.9378 for gemm<1,0>; up3 at 1.42x and
//   up2 at 1.82x their bytes bound, the epilogue not overlapping the MMAs.
//
// Every entry returns a cudaError_t (0 on success): cudaErrorInvalidValue
// for shapes it does not take or a tensor map that does not encode, else
// cudaGetLastError() after the launch.

#include "sm90.cuh"

#define TILE_Y 8
#define TILE_X 16
#define BK 64                      // channels of a K step: 64 bf16, 128 bytes
#define ROW_BYTES (TILE_X * BK * 2)  // one image row of the box: 2 KB
#define A_BYTES ((TILE_Y + 2) * ROW_BYTES)  // the halo box: 10 rows, 20 KB
#define STG_BYTES (64 * 64 * 2)    // a consumer's staged 64 x 64 bf16 block
#define NTHREADS 384               // producer warpgroup + two consumer warpgroups

template <int BN> struct Cfg;
template <> struct Cfg<64> { enum { STAGES = 2, MINB = 2 }; };
template <> struct Cfg<128> { enum { STAGES = 3, MINB = 1 }; };

template <int BN> struct Layout {
  enum {
    STAGES = Cfg<BN>::STAGES,
    B_BYTES = BN * BK * 2,
    STAGE_BYTES = A_BYTES + 3 * B_BYTES,  // the halo box and the three dy taps' weights
    BAR_OFF = STAGES * STAGE_BYTES + 2 * STG_BYTES,
    SMEM = BAR_OFF + 2 * STAGES * 8,
  };
};

struct Sm90Args {
  int C0, C1, H, W, F;
  int relu, OC;
  const float* bias;  // (F,) f32 values of the bf16 bias
  bf16* out;          // (H, W, F), or null with the head
  bf16* pooled;       // (H/2, W/2, F) or null
  const bf16* hk8;    // (F, 8) head kernel, zero past OC, or null
  const float* hb;    // (OC,) head bias
  bf16* hout;         // (H, W, OC) or null
};

// the fused-ConvTranspose kernel: the deep box, the up weights, the up tile
#define UP_DX 10                              // deep columns of a tile's up halo
#define UP_DY 6                               // deep rows
#define DEEP_BYTES (UP_DX * UP_DY * BK * 2)   // the deep box of a 64-channel chunk: 7,680
#define DEEP_SLOT 8192                        // ... padded to the m64 operand
#define UPB_BYTES (256 * BK * 2)              // 4 subpixels x 64 up channels x 64 k: 32 KB
#define UT_W 18                               // up tile columns x0-1 .. x0+16
#define UT_H 10                               // up tile rows y0-1 .. y0+8
#define UT_CHUNK (UT_W * UT_H * BK * 2)       // the up tile, a 64-channel chunk: 23,040

template <int BN> struct UpCfg;
template <> struct UpCfg<64> { enum { STAGES = 4 }; };
template <> struct UpCfg<128> { enum { STAGES = 2 }; };

template <int BN> struct UpLayout {
  enum {
    STAGES = UpCfg<BN>::STAGES,
    STAGE_BYTES = Layout<BN>::STAGE_BYTES,  // a conv stage, or the deep box + up weights
    UT_OFF = STAGES * STAGE_BYTES,
    STG_OFF = UT_OFF + (BN / 64) * UT_CHUNK,  // C_up == F == BN
    BAR_OFF = STG_OFF + 2 * STG_BYTES,
    SMEM = BAR_OFF + 2 * STAGES * 8,
  };
};
static_assert(DEEP_SLOT + UPB_BYTES <= Layout<64>::STAGE_BYTES, "an up GEMM stage fits a stage");
static_assert(UpLayout<64>::SMEM <= 232448 && UpLayout<128>::SMEM <= 232448, "shared memory");

struct UpArgs {
  int Cs, Cd, H, W;    // skip and deep channels; the output's (even) H and W
  int relu;
  const float* bias;   // (F,) conv bias, f32 values of bf16
  const float* ubias;  // (F,) up bias, f32 values of bf16
  bf16* out;           // (H, W, F)
};

// K4 bf16
#define CT_BM 128                           // input pixels of a tile (GEMM rows)
#define CT_BN 256                           // GEMM columns of a tile: 4 subpixels x 64 channels
#define CT_A_BYTES (CT_BM * BK * 2)         // 16 KB
#define CT_B_BYTES (CT_BN * BK * 2)         // 32 KB
#define CT_STAGES 4
#define CT_STAGE_BYTES (CT_A_BYTES + CT_B_BYTES)
#define CT_BAR_OFF (CT_STAGES * CT_STAGE_BYTES + 2 * STG_BYTES)
#define CT_SMEM (CT_BAR_OFF + 2 * CT_STAGES * 8)
static_assert(CT_SMEM <= 232448 && CT_STAGE_BYTES % 1024 == 0, "shared memory");

struct ConvTArgs {
  int M, C, W, F;     // input pixels, channels, input width, output channels
  const float* bias;  // (F,) f32 values of the bf16 bias
  bf16* out;          // (2H, 2W, F)
};

// ------------------------------------------------------------ bf16 wgmma (the PTX wrappers
// shared with conv_i8_sm90.cu are in sm90.cuh)

// D(64 x N, f32) += A(64 x 16, bf16, K-major smem) * B(16 x N, bf16, K-major smem)
template <int N> __device__ __forceinline__ void wgmma(float* d, uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma<64>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<128>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<256>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// D(64 x N, f32) += A(64 x 16, bf16, registers) * B(16 x N, bf16, K-major smem):
// warp w holds rows 16w..16w+15 of A as mma.m16n8k16 does (ldmatrix.x4 order)
template <int N> __device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 64-channel block nb of a consumer's accumulator: bias (channels of
// `bias`), ReLU, one bf16 rounding, staged as 64 rows of 128 bytes
__device__ __forceinline__ void stage_block(const float* acc, int nb, const float* bias, int relu,
                                            unsigned char* stg, int warp, int lane) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = 8 * i + 2 * (lane & 3);
    const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + (lane >> 2) + 8 * h;
      float v0 = acc[32 * nb + 4 * i + 2 * h] + b0;
      float v1 = acc[32 * nb + 4 * i + 2 * h + 1] + b1;
      if (relu) {
        v0 = fmaxf(v0, 0.0f);
        v1 = fmaxf(v1, 0.0f);
      }
      *reinterpret_cast<__nv_bfloat162*>(stg + stg_off(r, i) + 4 * (lane & 3)) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

// ------------------------------------------------------------ the kernel

template <int BN>
__global__ void __launch_bounds__(NTHREADS, Cfg<BN>::MINB)
    conv3x3_wgmma(const __grid_constant__ CUtensorMap map_x0,
                  const __grid_constant__ CUtensorMap map_x1,
                  const __grid_constant__ CUtensorMap map_w, const Sm90Args a) {
  typedef Layout<BN> L;
  constexpr int STAGES = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t full0 = base + L::BAR_OFF;       // full[s] = full0 + 8s
  const uint32_t empty0 = full0 + 8 * STAGES;     // empty[s] = empty0 + 8s

  if (threadIdx.x == 0) {
    if (base & 1023) __trap();  // the 128B swizzle needs 1024-byte aligned tiles
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the producer's expect_tx arrival
      mbar_init(empty0 + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int TX = (a.W + TILE_X - 1) / TILE_X;
  const int TY = (a.H + TILE_Y - 1) / TILE_Y;
  const int NT = a.F / BN;
  const int ntiles = TX * TY * NT;
  const int ct = a.C0 + a.C1;
  const int wg = threadIdx.x >> 7;

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full
    if (threadIdx.x != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int n0 = (tile % NT) * BN;
      const int pt = tile / NT;
      const int x0 = (pt % TX) * TILE_X, y0 = (pt / TX) * TILE_Y;
      for (int dx = 0; dx < 3; ++dx) {
        for (int inp = 0; inp < 2; ++inp) {
          const int C = inp ? a.C1 : a.C0;
          const CUtensorMap* map = inp ? &map_x1 : &map_x0;
          const int kb = dx * ct + (inp ? a.C0 : 0);  // weight row of tap (0, dx)
          for (int c = 0; c < C; c += BK) {
            const uint32_t full = full0 + 8 * stage;
            mbar_wait(empty0 + 8 * stage, phase ^ 1);
            mbar_expect_tx(full, L::STAGE_BYTES);
            const uint32_t sa = base + stage * L::STAGE_BYTES;
            // image rows y0-1 .. y0+8 at columns x0+dx-1 .., then tap (dy, dx)'s weights
            tma_load_3d(sa, map, full, c, x0 + dx - 1, y0 - 1);
#pragma unroll
            for (int dy = 0; dy < 3; ++dy)
              tma_load_2d(sa + A_BYTES + dy * L::B_BYTES, &map_w, full, kb + 3 * dy * ct + c, n0);
            if (++stage == STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns rows 64*cw..64*cw+63 of the tile
    // (image rows y0 + 4*cw .. y0 + 4*cw + 3)
    const int cw = wg - 1;
    const int t = threadIdx.x & 127;
    const int warp = t >> 5, lane = t & 31;
    unsigned char* stg = smem + STAGES * L::STAGE_BYTES + cw * STG_BYTES;
    const int nk = 3 * ct / BK;  // stages a tile: (dx, input, 64-channel chunk)
    float acc[BN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int n0 = (tile % NT) * BN;
      const int pt = tile / NT;
      const int x0 = (pt % TX) * TILE_X, y0 = (pt / TX) * TILE_Y;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      int prev = 0;
      for (int ks = 0; ks < nk; ++ks) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t sa = base + stage * L::STAGE_BYTES;
        fence_acc<BN / 2>(acc);
        __syncwarp();  // the .aligned wgmma instructions need the whole warp
        wg_fence();
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          // tap (dy, dx) reads box rows dy + 4*cw .. dy + 4*cw + 3
          const uint64_t da = sw128_desc(sa + (dy + 4 * cw) * ROW_BYTES);
          const uint64_t db = sw128_desc(sa + A_BYTES + dy * L::B_BYTES);
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) wgmma<BN>(acc, da + 2 * kk, db + 2 * kk);
        }
        wg_commit();
        fence_acc<BN / 2>(acc);
        wg_wait<1>();  // the previous step's group has retired: its stage is free
        fence_acc<BN / 2>(acc);
        if (ks > 0 && t == 0) mbar_arrive(empty0 + 8 * prev);
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wg_wait<0>();
      fence_acc<BN / 2>(acc);
      if (t == 0) mbar_arrive(empty0 + 8 * prev);

      // ---- epilogue, one 64-channel block at a time: bias, ReLU, bf16,
      // staged in shared memory, then stored, pooled or fed to the head
      const int yb = y0 + 4 * cw;  // first image row of this warpgroup's band
      const int p = t >> 1, half = t & 1;  // the head: two threads a pixel
      float hacc[8];
#pragma unroll
      for (int o = 0; o < 8; ++o) hacc[o] = 0.0f;
#pragma unroll
      for (int nb = 0; nb < BN / 64; ++nb) {
        const int nc = n0 + 64 * nb;  // first channel of the block
        named_bar(1 + cw);  // every thread is done reading the staged block
        stage_block(acc, nb, a.bias + nc, a.relu, stg, warp, lane);
        named_bar(1 + cw);
        if (a.out) store_block(stg, a.out, a.H, a.W, a.F, yb, x0, nc, t);
        if (a.pooled) pool_block(stg, a.pooled, a.H, a.W, a.F, yb, x0, nc, t);
        if (a.hout) {
          // BN == F here: each thread of a pair sums 4 of the block's 8
          // chunks, one 16-byte head row a channel
          for (int ch = 4 * half; ch < 4 * half + 4; ++ch) {
            const uint4 v8 = *reinterpret_cast<const uint4*>(stg + stg_off(p, ch));
            const bf16* v = reinterpret_cast<const bf16*>(&v8);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const uint4 w8 =
                  __ldg(reinterpret_cast<const uint4*>(a.hk8) + 64 * nb + ch * 8 + e);
              const bf16* w = reinterpret_cast<const bf16*>(&w8);
              const float xv = __bfloat162float(v[e]);
#pragma unroll
              for (int o = 0; o < 8; ++o) hacc[o] += xv * __bfloat162float(w[o]);
            }
          }
        }
      }
      if (a.hout) {
#pragma unroll
        for (int o = 0; o < 8; ++o) hacc[o] += __shfl_xor_sync(0xffffffffu, hacc[o], 1);
        const int y = yb + (p >> 4), x = x0 + (p & 15);
        if (half == 0 && y < a.H && x < a.W) {
#pragma unroll
          for (int o = 0; o < 8; ++o)
            if (o < a.OC)
              a.hout[((size_t)y * a.W + x) * a.OC + o] = __float2bfloat16_rn(hacc[o] + a.hb[o]);
        }
      }
    }
  }
}

// ------------------------------------------------------------ the fused-ConvTranspose kernel

template <int BN>
__global__ void __launch_bounds__(NTHREADS, 1)
    conv3x3_up_wgmma(const __grid_constant__ CUtensorMap map_skip,
                     const __grid_constant__ CUtensorMap map_deep,
                     const __grid_constant__ CUtensorMap map_wup,
                     const __grid_constant__ CUtensorMap map_w, const UpArgs a) {
  typedef UpLayout<BN> L;
  constexpr int STAGES = L::STAGES;
  constexpr int B_BYTES = Layout<BN>::B_BYTES;
  constexpr int NU = BN / 64;  // 64-channel chunks of the up tile
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t full0 = base + L::BAR_OFF;
  const uint32_t empty0 = full0 + 8 * STAGES;

  if (threadIdx.x == 0) {
    if (base & 1023) __trap();
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int TX = (a.W + TILE_X - 1) / TILE_X;
  const int TY = (a.H + TILE_Y - 1) / TILE_Y;
  const int ntiles = TX * TY;
  const int ct = a.Cs + BN;  // the conv's input channels: skip, then up (C_up == F == BN)
  const int nkd = a.Cd / BK, nkc = a.Cs / BK;
  const int wg = threadIdx.x >> 7;

  if (wg == 0) {
    // ---- producer. A tile's stages: NU * nkd up GEMM stages (u, deep
    // chunk), 3 * nkc skip stages (dx, chunk), 3 * NU up tile stages (dx, u)
    if (threadIdx.x != 0) return;
    const int n_up = NU * nkd, n_skip = 3 * nkc;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int x0 = (tile % TX) * TILE_X, y0 = (tile / TX) * TILE_Y;
      for (int ks = 0; ks < n_up + n_skip + 3 * NU; ++ks) {
        const uint32_t full = full0 + 8 * stage;
        const uint32_t sa = base + stage * L::STAGE_BYTES;
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        if (ks < n_up) {
          const int u = ks / nkd, c = (ks % nkd) * BK;
          mbar_expect_tx(full, DEEP_BYTES + UPB_BYTES);
          // deep rows y0/2-1 .. y0/2+4, columns x0/2-1 .. x0/2+8 (zeros outside)
          tma_load_3d(sa, &map_deep, full, c, x0 / 2 - 1, y0 / 2 - 1);
          tma_load_2d(sa + DEEP_SLOT, &map_wup, full, c, 256 * u);
        } else {
          int dx, k0;  // the stage's weight rows: tap (dy, dx) at (3dy + dx) * ct + k0
          if (ks < n_up + n_skip) {
            dx = (ks - n_up) / nkc;
            k0 = ((ks - n_up) % nkc) * BK;
            mbar_expect_tx(full, A_BYTES + 3 * B_BYTES);
            tma_load_3d(sa, &map_skip, full, k0, x0 + dx - 1, y0 - 1);
          } else {
            dx = (ks - n_up - n_skip) / NU;
            k0 = a.Cs + 64 * ((ks - n_up - n_skip) % NU);
            mbar_expect_tx(full, 3 * B_BYTES);
          }
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
            tma_load_2d(sa + A_BYTES + dy * B_BYTES, &map_w, full, (3 * dy + dx) * ct + k0, 0);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    const int cw = wg - 1;
    const int t = threadIdx.x & 127;
    const int warp = t >> 5, lane = t & 31;
    unsigned char* stg = smem + L::STG_OFF + cw * STG_BYTES;
    unsigned char* ut = smem + L::UT_OFF;
    // this lane's ldmatrix row: pixel column lcol of the warp's 16, 16-byte
    // chunk lhalf of each k16 step
    const int lcol = (lane & 7) + 8 * ((lane >> 3) & 1), lhalf = lane >> 4;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int x0 = (tile % TX) * TILE_X, y0 = (tile / TX) * TILE_Y;

      // ---- 1. the up GEMM, a 64-channel chunk u of C_up at a time: rows =
      // the 6 x 10 deep pixels (60 of the m64), columns = subpixels (cw, 0)
      // and (cw, 1), 64 channels each
#pragma unroll 1
      for (int u = 0; u < NU; ++u) {
        float uacc[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) uacc[i] = 0.0f;
        for (int kc = 0; kc < nkd; ++kc) {
          mbar_wait(full0 + 8 * stage, phase);
          const uint32_t sa = base + stage * L::STAGE_BYTES;
          fence_acc<64>(uacc);
          __syncwarp();
          wg_fence();
          const uint64_t da = sw128_desc(sa);
          const uint64_t db = sw128_desc(sa + DEEP_SLOT + cw * (UPB_BYTES / 2));
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) wgmma<128>(uacc, da + 2 * kk, db + 2 * kk);
          wg_commit();
          fence_acc<64>(uacc);
          wg_wait<0>();
          fence_acc<64>(uacc);
          if (t == 0) mbar_arrive(empty0 + 8 * stage);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
        // the other consumer is done reading the previous tile's up values
        if (u == 0) consumers_bar();
        // bias, one bf16 rounding, zeros outside the image, into the up tile
        unsigned char* utu = ut + u * UT_CHUNK;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int j = 8 * (i & 7) + 2 * (lane & 3);  // up channel within the chunk
          const float b0 = a.ubias[64 * u + j], b1 = a.ubias[64 * u + j + 1];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = warp * 16 + (lane >> 2) + 8 * h;  // deep pixel of the halo
            const int ur = 2 * (m / UP_DX) + cw - 1;        // up tile row and column
            const int uc = 2 * (m % UP_DX) + (i >> 3) - 1;
            if (m < UP_DX * UP_DY && ur >= 0 && ur < UT_H && uc >= 0 && uc < UT_W) {
              const int uy = y0 - 1 + ur, ux = x0 - 1 + uc;
              const bool in = uy >= 0 && uy < a.H && ux >= 0 && ux < a.W;
              const float v0 = in ? uacc[4 * i + 2 * h] + b0 : 0.0f;
              const float v1 = in ? uacc[4 * i + 2 * h + 1] + b1 : 0.0f;
              const int p = ur * UT_W + uc;
              *reinterpret_cast<__nv_bfloat162*>(utu + p * 128 + (((i & 7) ^ (p & 7)) << 4) +
                                                 4 * (lane & 3)) = __floats2bfloat162_rn(v0, v1);
            }
          }
        }
      }

      // ---- 2. the skip input, A by TMA as in conv3x3_wgmma
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      int prev = 0;
      for (int ks = 0; ks < 3 * nkc; ++ks) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t sa = base + stage * L::STAGE_BYTES;
        fence_acc<BN / 2>(acc);
        __syncwarp();
        wg_fence();
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const uint64_t da = sw128_desc(sa + (dy + 4 * cw) * ROW_BYTES);
          const uint64_t db = sw128_desc(sa + A_BYTES + dy * B_BYTES);
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) wgmma<BN>(acc, da + 2 * kk, db + 2 * kk);
        }
        wg_commit();
        fence_acc<BN / 2>(acc);
        wg_wait<1>();
        fence_acc<BN / 2>(acc);
        if (ks > 0 && t == 0) mbar_arrive(empty0 + 8 * prev);
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wg_wait<0>();
      fence_acc<BN / 2>(acc);
      if (t == 0) mbar_arrive(empty0 + 8 * prev);

      // ---- 3. the up tile, A from registers at the tap's shift; every up
      // value of the tile is written once both consumers pass the barrier
      consumers_bar();
      for (int s = 0; s < 3 * NU; ++s) {
        const int dx = s / NU;
        const uint32_t utu = base + L::UT_OFF + (s % NU) * UT_CHUNK;
        uint32_t af[3][BK / 16][4];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          // output row 4cw + warp at tap dy reads up tile row 4cw + warp + dy
          const int p = (4 * cw + warp + dy) * UT_W + lcol + dx;
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            ldmatrix_x4(af[dy][kk], utu + p * 128 + (((2 * kk + lhalf) ^ (p & 7)) << 4));
        }
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t sa = base + stage * L::STAGE_BYTES;
        fence_acc<BN / 2>(acc);
        __syncwarp();
        wg_fence();
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const uint64_t db = sw128_desc(sa + A_BYTES + dy * B_BYTES);
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<BN>(acc, af[dy][kk], db + 2 * kk);
        }
        wg_commit();
        fence_acc<BN / 2>(acc);
        wg_wait<0>();
        fence_acc<BN / 2>(acc);
        if (t == 0) mbar_arrive(empty0 + 8 * stage);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }

      // ---- epilogue: bias, ReLU, bf16, staged, stored
      const int yb = y0 + 4 * cw;
#pragma unroll
      for (int nb = 0; nb < NU; ++nb) {
        named_bar(1 + cw);
        stage_block(acc, nb, a.bias + 64 * nb, a.relu, stg, warp, lane);
        named_bar(1 + cw);
        store_block(stg, a.out, a.H, a.W, BN, yb, x0, 64 * nb, t);
      }
    }
  }
}

// ------------------------------------------------------------ K4 bf16

__global__ void __launch_bounds__(NTHREADS, 1)
    convt2x2_wgmma(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b, const ConvTArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t full0 = base + CT_BAR_OFF;
  const uint32_t empty0 = full0 + 8 * CT_STAGES;

  if (threadIdx.x == 0) {
    if (base & 1023) __trap();
    for (int s = 0; s < CT_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int NT = 4 * a.F / CT_BN;
  const int ntiles = ((a.M + CT_BM - 1) / CT_BM) * NT;
  const int nk = a.C / BK;
  const int wg = threadIdx.x >> 7;

  if (wg == 0) {
    setmaxnreg_dec40();
    if (threadIdx.x == 0) {
      int bkey[CT_STAGES];  // the (N tile, K step) whose B box each stage buffer holds
#pragma unroll
      for (int s = 0; s < CT_STAGES; ++s) bkey[s] = -1;
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int nt = tile % NT;
        const int m0 = (tile / NT) * CT_BM;
        for (int ks = 0; ks < nk; ++ks) {
          const uint32_t full = full0 + 8 * stage;
          const uint32_t sa = base + stage * CT_STAGE_BYTES;
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const int key = nt * nk + ks;
          int held = 0;
#pragma unroll
          for (int s = 0; s < CT_STAGES; ++s)
            if (s == stage) held = bkey[s] == key;
          mbar_expect_tx(full, CT_A_BYTES + (held ? 0 : CT_B_BYTES));
          tma_load_2d(sa, &map_a, full, ks * BK, m0);
          if (!held) {
            tma_load_2d(sa + CT_A_BYTES, &map_b, full, ks * BK, nt * CT_BN);
#pragma unroll
            for (int s = 0; s < CT_STAGES; ++s)
              if (s == stage) bkey[s] = key;
          }
          if (++stage == CT_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    setmaxnreg_inc232();
    const int cw = wg - 1;
    const int t = threadIdx.x & 127;
    const int warp = t >> 5, lane = t & 31;
    unsigned char* stg = smem + CT_STAGES * CT_STAGE_BYTES + cw * STG_BYTES;
    float acc[CT_BN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int u = tile % NT;  // the tile's 64-channel chunk of F
      const int m0 = (tile / NT) * CT_BM;
#pragma unroll
      for (int i = 0; i < CT_BN / 2; ++i) acc[i] = 0.0f;
      int prev = 0;
      for (int ks = 0; ks < nk; ++ks) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t sa = base + stage * CT_STAGE_BYTES;
        fence_acc<CT_BN / 2>(acc);
        __syncwarp();
        wg_fence();
        const uint64_t da = sw128_desc(sa + cw * 64 * BK * 2);  // rows 64cw.. of the A box
        const uint64_t db = sw128_desc(sa + CT_A_BYTES);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) wgmma<CT_BN>(acc, da + 2 * kk, db + 2 * kk);
        wg_commit();
        fence_acc<CT_BN / 2>(acc);
        wg_wait<1>();  // the previous step's group has retired: its stage is free
        fence_acc<CT_BN / 2>(acc);
        if (ks > 0 && t == 0) mbar_arrive(empty0 + 8 * prev);
        prev = stage;
        if (++stage == CT_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wg_wait<0>();
      fence_acc<CT_BN / 2>(acc);
      if (t == 0) mbar_arrive(empty0 + 8 * prev);

      // ---- epilogue, one subpixel (dy, dx) = 64 columns at a time: bias,
      // bf16, staged, then the 128 bytes of each output pixel at channel 64u
#pragma unroll
      for (int sub = 0; sub < 4; ++sub) {
        const int dy = sub >> 1, dx = sub & 1;
        named_bar(1 + cw);  // every thread is done reading the staged block
        stage_block(acc, sub, a.bias + 64 * u, 0, stg, warp, lane);
        named_bar(1 + cw);
        for (int idx = t; idx < 64 * 8; idx += 128) {
          const int r = idx >> 3, ch = idx & 7;
          const int m = m0 + 64 * cw + r;
          if (m < a.M) {
            const int y = m / a.W, x = m - y * a.W;
            *reinterpret_cast<uint4*>(a.out + ((size_t)(2 * y + dy) * (2 * a.W) + 2 * x + dx) *
                                                  a.F + 64 * u + ch * 8) =
                *reinterpret_cast<const uint4*>(stg + stg_off(r, ch));
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------ host side

// (H, W, C) bf16 activation, box (64 c, bx x, by y); by default a tile's
// rows and their halo (16 x, 10 y)
static bool encode_act(EncodeTiled enc, CUtensorMap* m, const void* x, int C, int H, int W,
                       int bx = TILE_X, int by = TILE_Y + 2) {
  const int dims[3] = {C, W, H}, box[3] = {BK, bx, by};
  return encode_map(enc, m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 3, x, dims, box,
                    CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
}

// (F, K) K-major bf16 weights, box (64 k, BN n)
static bool encode_w(EncodeTiled enc, CUtensorMap* m, const void* wt, int K, int F, int BN) {
  const int dims[2] = {K, F}, box[2] = {BK, BN};
  return encode_map(enc, m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 2, wt, dims, box,
                    CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
}

template <int BN>
static int launch(const CUtensorMap& m0, const CUtensorMap& m1, const CUtensorMap& mw,
                  const Sm90Args& a, cudaStream_t s) {
  constexpr int smem = Layout<BN>::SMEM;
  static int grid_max = 0;  // resident blocks on the card
  if (grid_max == 0) {
    const int e = query_grid(conv3x3_wgmma<BN>, NTHREADS, smem, &grid_max);
    if (e) return e;
  }
  const int ntiles = ((a.W + TILE_X - 1) / TILE_X) * ((a.H + TILE_Y - 1) / TILE_Y) * (a.F / BN);
  if (ntiles == 0) return (int)cudaGetLastError();
  conv3x3_wgmma<BN><<<ntiles < grid_max ? ntiles : grid_max, NTHREADS, smem, s>>>(m0, m1, mw, a);
  return (int)cudaGetLastError();
}

template <int BN>
static int launch_up(const CUtensorMap& ms, const CUtensorMap& md, const CUtensorMap& mu,
                     const CUtensorMap& mw, const UpArgs& a, cudaStream_t s) {
  constexpr int smem = UpLayout<BN>::SMEM;
  static int grid_max = 0;  // resident blocks on the card, this kernel's own
  if (grid_max == 0) {
    const int e = query_grid(conv3x3_up_wgmma<BN>, NTHREADS, smem, &grid_max);
    if (e) return e;
  }
  const int ntiles = ((a.W + TILE_X - 1) / TILE_X) * ((a.H + TILE_Y - 1) / TILE_Y);
  conv3x3_up_wgmma<BN><<<ntiles < grid_max ? ntiles : grid_max, NTHREADS, smem, s>>>(ms, md, mu,
                                                                                     mw, a);
  return (int)cudaGetLastError();
}

// x0, x1: (H, W, C0), (H, W, C1) bf16 (x1 null when C1 = 0); wt: (F, K) bf16,
// K = 9*(C0+C1); bias (F,) f32. Outputs: out (H, W, F) or null with the head;
// pooled (H/2, W/2, F) or null; hout (H, W, OC) with hk8 (F, 8: the head
// kernel zero-padded past OC <= 8), hb (OC,), or null.
extern "C" int rtnr_conv3x3_wgmma(const void* x0, const void* x1, int C0, int C1, int H, int W,
                                  const void* wt, const void* bias, void* out, void* pooled,
                                  const void* hk8, const void* hb, int OC, void* hout, int F,
                                  int relu, void* stream) {
  const int BN = F % 128 == 0 ? 128 : 64;
  const bool head = hout != nullptr;
  if (C0 <= 0 || C0 % BK || C1 < 0 || C1 % BK || F <= 0 || F % 64 || H <= 0 || W <= 0 ||
      (C1 > 0 && !x1) || (head && (F != BN || OC < 1 || OC > 8 || out || pooled)) ||
      (!head && !out) || (pooled && (H % 2 || W % 2)))
    return (int)cudaErrorInvalidValue;
  EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorInvalidValue;
  CUtensorMap m0, m1, mw;
  if (!encode_act(enc, &m0, x0, C0, H, W) ||
      !encode_act(enc, &m1, C1 ? x1 : x0, C1 ? C1 : C0, H, W) ||
      !encode_w(enc, &mw, wt, 9 * (C0 + C1), F, BN))
    return (int)cudaErrorInvalidValue;
  Sm90Args a;
  a.C0 = C0;
  a.C1 = C1;
  a.H = H;
  a.W = W;
  a.F = F;
  a.relu = relu;
  a.OC = OC;
  a.bias = (const float*)bias;
  a.out = (bf16*)out;
  a.pooled = (bf16*)pooled;
  a.hk8 = (const bf16*)hk8;
  a.hb = (const float*)hb;
  a.hout = (bf16*)hout;
  cudaStream_t s = (cudaStream_t)stream;
  return BN == 128 ? launch<128>(m0, m1, mw, a, s) : launch<64>(m0, m1, mw, a, s);
}

// The fused-ConvTranspose mode. skip (H, W, Cs) and deep (H/2, W/2, Cd)
// bf16, H and W even; wup_t (4F, Cd) bf16 (ConvT2x2Weights.wmat_t), ubias
// (F,) f32; wt (F, 9*(Cs+F)) bf16 (the conv over [skip, up], C_up == F),
// bias (F,) f32; out (H, W, F) bf16. F is 64 or 128; Cs, Cd multiples of 64.
extern "C" int rtnr_conv3x3_up_wgmma(const void* skip, const void* deep, int Cs, int Cd, int H,
                                     int W, const void* wup_t, const void* ubias, const void* wt,
                                     const void* bias, void* out, int F, int relu, void* stream) {
  if (Cs <= 0 || Cs % BK || Cd <= 0 || Cd % BK || (F != 64 && F != 128) || H <= 0 || W <= 0 ||
      H % 2 || W % 2 || !skip || !deep || !out)
    return (int)cudaErrorInvalidValue;
  EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorInvalidValue;
  CUtensorMap ms, md, mu, mw;
  if (!encode_act(enc, &ms, skip, Cs, H, W) ||
      !encode_act(enc, &md, deep, Cd, H / 2, W / 2, UP_DX, UP_DY) ||
      !encode_w(enc, &mu, wup_t, Cd, 4 * F, 256) || !encode_w(enc, &mw, wt, 9 * (Cs + F), F, F))
    return (int)cudaErrorInvalidValue;
  UpArgs a;
  a.Cs = Cs;
  a.Cd = Cd;
  a.H = H;
  a.W = W;
  a.relu = relu;
  a.bias = (const float*)bias;
  a.ubias = (const float*)ubias;
  a.out = (bf16*)out;
  cudaStream_t s = (cudaStream_t)stream;
  return F == 128 ? launch_up<128>(ms, md, mu, mw, a, s) : launch_up<64>(ms, md, mu, mw, a, s);
}

// K4 bf16. x: (H, W, C) bf16; wt: (4F, C) bf16, row (u*4 + dy*2 + dx)*64 + j
// the flipped kernel's column 64u + j of subpixel (dy, dx)
// (ConvT2x2Weights.wmat_t); bias (F,) f32; out (2H, 2W, F) bf16. C and F
// multiples of 64.
extern "C" int rtnr_convt2x2_wgmma(const void* x, int C, int H, int W, const void* wt,
                                   const void* bias, void* out, int F, void* stream) {
  if (C <= 0 || C % BK || F <= 0 || F % 64 || H <= 0 || W <= 0 || !x || !wt || !bias || !out)
    return (int)cudaErrorInvalidValue;
  EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  const int M = H * W;
  const int da[2] = {C, M}, abox[2] = {BK, CT_BM};
  if (!encode_map(enc, &ma, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 2, x, da, abox,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B) ||
      !encode_w(enc, &mb, wt, C, 4 * F, CT_BN))
    return (int)cudaErrorInvalidValue;
  ConvTArgs a;
  a.M = M;
  a.C = C;
  a.W = W;
  a.F = F;
  a.bias = (const float*)bias;
  a.out = (bf16*)out;
  static int grid_max = 0;  // resident blocks on the card
  if (grid_max == 0) {
    int err = check_regs(convt2x2_wgmma);
    if (!err) err = query_grid(convt2x2_wgmma, NTHREADS, CT_SMEM, &grid_max);
    if (err) return err;
  }
  const int ntiles = ((M + CT_BM - 1) / CT_BM) * (4 * F / CT_BN);
  convt2x2_wgmma<<<ntiles < grid_max ? ntiles : grid_max, NTHREADS, CT_SMEM,
                   (cudaStream_t)stream>>>(ma, mb, a);
  return (int)cudaGetLastError();
}
