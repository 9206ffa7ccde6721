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
// {64, 128}, so one tile holds every channel and computes its up values once.
// Bound: operations, 342 GFLOP a level (308 of conv, 34 of ConvTranspose)
// against ~0.27 GB moved: 0.346 ms at 989 TFLOP/s. The first design (8x16
// tiles) lost to the card's K4 + K3 pair: each tile recomputed a 10x18
// up halo from 60 deep rows for 32 interior ones, its up GEMM and its
// register-A stages waited on every wgmma group, two 256-thread barriers
// ordered each tile, its ring held 2 stages at F = 128, and every tile
// streamed the conv's and the up kernel's weights whole from L2 (1,012 KiB a
// 128-pixel tile at level 2). This design:
// - Tiles of 16 rows x 16 columns, twice the pixels per weight byte: 341 KiB
//   (level 3) and 1,148 KiB (level 2) through L2 a 256-pixel tile, against
//   566 and 2,024 before. Consumer warpgroup cw owns rows 8cw .. 8cw+7 as two
//   m64 blocks of 8 x 8 pixels (mb: columns 8mb .. 8mb+7), all F channels.
// - Each consumer computes the up values of its own band: up rows 8cw-1 ..
//   8cw+8 and columns -1 .. 16 (10 x 18) from the 6 x 10 deep pixels at rows
//   4cw .. 4cw+5 of a (64 c, 10 x, 10 y) deep box, one m64 (60 rows used)
//   against 256 columns of the K-major (4 C_up, C_deep) up kernel
//   (ConvT2x2Weights.wmat_t: 4 subpixels x 64 up channels): one m64n256
//   accumulator holds a 64-channel chunk of the band, and the halo costs the
//   same 2x of the ConvTranspose's work as before. The band's up tile is the
//   consumer's own (23,040 bytes a chunk, 128B-swizzled by absolute address):
//   no barrier joins the consumers; a 128-thread barrier before and one after
//   its write order it against the consumer's own reads.
// - Every stage reads A from shared memory (no register-A form): the up
//   stages start their descriptor at the tap's pixel shift inside the up
//   tile (a 128B-swizzled K-major operand may start at any 128-byte row: the
//   swizzle follows the address), with an 8-row group stride of 18 pixels;
//   the skip stages read the halo box at a stride of 16 pixels. Register-A
//   fragments made ptxas serialize every wgmma of the kernel (their
//   registers are redefined while groups are in flight) or ran out of
//   registers: ptxas builds a 384-thread block within 168 registers a
//   thread. The producer / consumer split (setmaxnreg 40 / 232) stays:
//   without it the consumers spill at F = 128 and level 3 runs slower.
// - Two rings: A slots of 36 KB (the skip halo box (64 c, 16 x, 18 y), or an
//   up-kernel box (64 k, 256 n)) and B slots of 16 KB (one tap row dy's
//   weights (64 k, F n), or the deep box). An up GEMM stage (up chunk, deep
//   chunk) takes one of each, a skip stage (dx, chunk) an A slot and three
//   B slots, an up stage (dx, up chunk) three B slots. One wgmma group a tap
//   row, each keeping the one before it in flight (wait_group 1), so that
//   the consumers hold two B slots and the producer fills the rest: 2 A + 6
//   B at F = 64 (219,264 bytes), 2 A + 4 B at F = 128 (231,520).
// - Epilogue: bias, ReLU, one bf16 rounding, staged in the consumer's up
//   tile (free after its last up stage) with the output map's 128B swizzle,
//   then one TMA store a block of 8 x 8 pixels x 64 channels, which clips the
//   ragged edge; the next tile's up epilogue waits until the stores have
//   read the staging.
// - Summation order: the up GEMM adds its k16 steps as convt2x2_wgmma does
//   (deep chunks, then k16 steps, on m64n256k16), and the conv walks its K
//   as conv3x3_wgmma walks [skip, up]: for each dx the skip chunks, then the
//   up chunks, each tap row dy's k16 steps in turn, on m64nFk16. The output
//   equals the card's unfused K4 + K3 pair bit for bit (the card tests gate
//   it); no split-K and no atomics, so a call gives the same bits every time.
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

// the fused-ConvTranspose kernel: tiles of UT_Y x TILE_X output pixels
#define UT_Y 16                                  // output rows of a tile, 8 a consumer
#define UA_BYTES ((UT_Y + 2) * ROW_BYTES)        // an A slot: the skip halo box, 36 KB
#define UB_BYTES 16384                           // a B slot: one dy's weights or a deep box
#define DEEP_X 10                                // the deep box: 10 x 10 pixels, rows 4cw ..
#define DEEP_Y 10                                //   4cw+5 are consumer cw's 6 x 10
#define DEEP_BYTES (DEEP_X * DEEP_Y * BK * 2)    // 12,800
#define DEEP_CW (4 * DEEP_X * BK * 2)            // consumer cw's rows start 5,120 cw bytes in
#define WUP_BYTES (256 * BK * 2)                 // 4 subpixels x 64 up channels x 64 k: 32 KB
#define UT_W 18                                  // a consumer's up tile: columns x0-1 .. x0+16,
#define UT_H 10                                  //   rows of its band and the halo
#define UT_CHUNK (UT_W * UT_H * BK * 2)          // a 64-channel chunk of it: 23,040

template <int BN> struct UpCfg;
template <> struct UpCfg<64> { enum { SA = 2, SB = 6 }; };
template <> struct UpCfg<128> { enum { SA = 2, SB = 4 }; };

template <int BN> struct UpLayout {
  enum {
    SA = UpCfg<BN>::SA,
    SB = UpCfg<BN>::SB,
    B_OFF = SA * UA_BYTES,
    UT_OFF = B_OFF + SB * UB_BYTES,
    // a consumer's up tile (C_up == F == BN), 1 KB aligned: after the tile's
    // last up stage it stages the output for the TMA store
    UT_CON = ((BN / 64) * UT_CHUNK + 1023) / 1024 * 1024,
    BAR_OFF = UT_OFF + 2 * UT_CON,
    SMEM = BAR_OFF + 2 * (SA + SB) * 8,
  };
};
static_assert(WUP_BYTES <= UA_BYTES && DEEP_CW + 64 * BK * 2 <= UB_BYTES &&
                  128 * BK * 2 <= UB_BYTES && UA_BYTES % 1024 == 0 && DEEP_CW % 1024 == 0,
              "slots");
static_assert(UpLayout<64>::SMEM <= 232448 && UpLayout<128>::SMEM <= 232448, "shared memory");
static_assert(2 * 64 * 128 <= UpLayout<64>::UT_CON && 4 * 64 * 128 <= UpLayout<128>::UT_CON,
              "the output staging fits the up tile");

struct UpArgs {
  int Cs, Cd, H, W;    // skip and deep channels; the output's (even) H and W
  int relu;
  const float* bias;   // (F,) conv bias, f32 values of bf16
  const float* ubias;  // (F,) up bias, f32 values of bf16
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

// a 4-byte shared-memory store (where ok, with no branch)
__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v, bool ok = true) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n @q st.shared.b32 [%0], %1;\n}" ::"r"(addr),
      "r"(v), "r"((int)ok)
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the TMA store of a staged box, its bulk group, and the wait until the
// stores have read shared memory
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// a ring of slots: the next slot and the parity of its next fill
struct Ring {
  int i;
  uint32_t ph;
};

// wait for the next slot of ring r (bar0: its barriers; flip 1 for the
// producer's wait on the empty barriers) and step the ring on
template <int N>
__device__ __forceinline__ int ring_take(uint32_t bar0, Ring& r, uint32_t flip) {
  const int s = r.i;
  mbar_wait(bar0 + 8 * s, r.ph ^ flip);
  if (++r.i == N) {
    r.i = 0;
    r.ph ^= 1;
  }
  return s;
}

// the slots of the last committed wgmma group, released once it retires:
// A slot a (-1: none) and nb B slots from b on in ring order
struct Pending {
  int a, b, nb;
};

template <int SB>
__device__ __forceinline__ void release(Pending& p, uint32_t emptyA, uint32_t emptyB, int t) {
  if (t == 0) {
    if (p.a >= 0) mbar_arrive(emptyA + 8 * p.a);
    for (int j = 0, s = p.b; j < p.nb; ++j, s = s + 1 == SB ? 0 : s + 1)
      mbar_arrive(emptyB + 8 * s);
  }
  p.a = -1;
  p.nb = 0;
}

// after committing a group that holds slots (a, b, nb): wait for the group
// before it, release that group's slots, and hold these
template <int R, int SB>
__device__ __forceinline__ void retire_prev(float* acc, Pending& p, int a, int b, int nb,
                                            uint32_t emptyA, uint32_t emptyB, int t) {
  fence_acc<R>(acc);
  wg_wait<1>();
  fence_acc<R>(acc);
  release<SB>(p, emptyA, emptyB, t);
  p.a = a;
  p.b = b;
  p.nb = nb;
}

template <int R, int SB>
__device__ __forceinline__ void retire_all(float* acc, Pending& p, uint32_t emptyA,
                                           uint32_t emptyB, int t) {
  fence_acc<R>(acc);
  wg_wait<0>();
  fence_acc<R>(acc);
  release<SB>(p, emptyA, emptyB, t);
}

// sw128_desc with another stride between 8-row groups (sbo bytes); the
// start may be any 128-byte row, the swizzle follows the absolute address
__device__ __forceinline__ uint64_t sw128_desc_sbo(uint32_t saddr, uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(sbo >> 4) << 32) |
         ((uint64_t)1 << 62);
}

template <int BN>
__global__ void __launch_bounds__(NTHREADS, 1)
    conv3x3_up_wgmma(const __grid_constant__ CUtensorMap map_skip,
                     const __grid_constant__ CUtensorMap map_deep,
                     const __grid_constant__ CUtensorMap map_wup,
                     const __grid_constant__ CUtensorMap map_w,
                     const __grid_constant__ CUtensorMap map_out, const UpArgs a) {
  typedef UpLayout<BN> L;
  constexpr int SA = L::SA, SB = L::SB;
  constexpr int NU = BN / 64;      // 64-channel chunks of the up channels
  constexpr int WB = BN * BK * 2;  // one tap row's weight box (64 k, BN n)
  constexpr int NACC = BN / 2;     // an m64 block's accumulator registers
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t fullA = base + L::BAR_OFF, emptyA = fullA + 8 * SA;
  const uint32_t fullB = emptyA + 8 * SA, emptyB = fullB + 8 * SB;

  if (threadIdx.x == 0) {
    if (base & 1023) __trap();
    for (int s = 0; s < SA; ++s) {
      mbar_init(fullA + 8 * s, 1);   // the producer's expect_tx arrival
      mbar_init(emptyA + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    for (int s = 0; s < SB; ++s) {
      mbar_init(fullB + 8 * s, 1);
      mbar_init(emptyB + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int TX = (a.W + TILE_X - 1) / TILE_X;
  const int ntiles = TX * ((a.H + UT_Y - 1) / UT_Y);
  const int ct = a.Cs + BN;  // the conv's input channels: skip, then up (C_up == F == BN)
  const int nkd = a.Cd / BK, nkc = a.Cs / BK;
  const int wg = threadIdx.x >> 7;

  if (wg == 0) {
    // ---- producer. A tile's stages: NU * nkd up GEMM stages (u, deep
    // chunk: the up kernel's box into an A slot, the deep box into a B slot),
    // then for each dx nkc skip stages (the halo box into an A slot, the tap
    // rows' weights into three B slots) and NU up stages (three B slots)
    setmaxnreg_dec40();
    if (threadIdx.x != 0) return;
    Ring ra = {0, 0}, rb = {0, 0};
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int x0 = (tile % TX) * TILE_X, y0 = (tile / TX) * UT_Y;
      for (int u = 0; u < NU; ++u) {
        for (int kc = 0; kc < nkd; ++kc) {
          int s = ring_take<SA>(emptyA, ra, 1);
          mbar_expect_tx(fullA + 8 * s, WUP_BYTES);
          tma_load_2d(base + s * UA_BYTES, &map_wup, fullA + 8 * s, kc * BK, 256 * u);
          s = ring_take<SB>(emptyB, rb, 1);
          mbar_expect_tx(fullB + 8 * s, DEEP_BYTES);
          // deep rows y0/2-1 .. y0/2+8, columns x0/2-1 .. x0/2+8 (zeros outside)
          tma_load_3d(base + L::B_OFF + s * UB_BYTES, &map_deep, fullB + 8 * s, kc * BK,
                      x0 / 2 - 1, y0 / 2 - 1);
        }
      }
      for (int dx = 0; dx < 3; ++dx) {
        for (int j = 0; j < nkc + NU; ++j) {
          int k0;  // the stage's weight rows: tap (dy, dx) at (3dy + dx) * ct + k0
          if (j < nkc) {
            k0 = j * BK;
            const int s = ring_take<SA>(emptyA, ra, 1);
            mbar_expect_tx(fullA + 8 * s, UA_BYTES);
            // image rows y0-1 .. y0+16 at columns x0+dx-1 ..
            tma_load_3d(base + s * UA_BYTES, &map_skip, fullA + 8 * s, k0, x0 + dx - 1, y0 - 1);
          } else {
            k0 = a.Cs + (j - nkc) * BK;
          }
          for (int dy = 0; dy < 3; ++dy) {
            const int s = ring_take<SB>(emptyB, rb, 1);
            mbar_expect_tx(fullB + 8 * s, WB);
            tma_load_2d(base + L::B_OFF + s * UB_BYTES, &map_w, fullB + 8 * s,
                        (3 * dy + dx) * ct + k0, 0);
          }
        }
      }
    }
  } else {
    setmaxnreg_inc232();
    const int cw = wg - 1;
    const int t = threadIdx.x & 127;
    const int warp = t >> 5, lane = t & 31;
    // this consumer's up tile: rows 8cw-1 .. 8cw+8 of the tile, columns -1 .. 16
    const uint32_t ut_s = base + L::UT_OFF + cw * L::UT_CON;
    Ring ra = {0, 0}, rb = {0, 0};
    Pending pend = {-1, 0, 0};
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int x0 = (tile % TX) * TILE_X, y0 = (tile / TX) * UT_Y;

      // ---- 1. the band's up values, a 64-channel chunk u at a time: rows =
      // the 6 x 10 deep pixels (60 of the m64), columns = 4 subpixels x 64
#pragma unroll 1
      for (int u = 0; u < NU; ++u) {
        float uacc[128];
#pragma unroll
        for (int i = 0; i < 128; ++i) uacc[i] = 0.0f;
        for (int kc = 0; kc < nkd; ++kc) {
          const int sa = ring_take<SA>(fullA, ra, 0);
          const int sb = ring_take<SB>(fullB, rb, 0);
          fence_acc<128>(uacc);
          __syncwarp();  // the .aligned wgmma instructions need the whole warp
          wg_fence();
          const uint64_t da = sw128_desc(base + L::B_OFF + sb * UB_BYTES + cw * DEEP_CW);
          const uint64_t db = sw128_desc(base + sa * UA_BYTES);
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) wgmma<256>(uacc, da + 2 * kk, db + 2 * kk);
          wg_commit();
          retire_prev<128, SB>(uacc, pend, sa, sb, 1, emptyA, emptyB, t);
        }
        retire_all<128, SB>(uacc, pend, emptyA, emptyB, t);
        // every warp of this consumer is done reading the previous tile's up
        // values, and its TMA stores have read the staged output
        if (u == 0) {
          if (t == 0) bulk_wait_read();
          named_bar(1 + cw);
        }
        // bias, one bf16 rounding, zeros outside the image, into the up tile:
        // each (row half h, subpixel) gives the thread one up pixel p, whose
        // stores are predicated on p lying in the tile
#pragma unroll
        for (int hs = 0; hs < 8; ++hs) {
          const int h = hs >> 2, sy = (hs >> 1) & 1, sx = hs & 1;
          const int m = warp * 16 + (lane >> 2) + 8 * h;  // deep pixel of the band's box
          const int ur = 2 * (m / DEEP_X) + sy - 1;       // up tile row and column
          const int uc = 2 * (m % DEEP_X) + sx - 1;
          const bool ok = m < 6 * DEEP_X && ur >= 0 && ur < UT_H && uc >= 0 && uc < UT_W;
          const int uy = y0 + 8 * cw - 1 + ur, ux = x0 - 1 + uc;
          const bool in = uy >= 0 && uy < a.H && ux >= 0 && ux < a.W;
          const int p = ok ? ur * UT_W + uc : 0;
          const uint32_t row = ut_s + u * UT_CHUNK + p * 128 + 4 * (lane & 3);
          // the 128B swizzle of the absolute row (wgmma reads by address)
          const int sw = (p + u * (UT_CHUNK >> 7)) & 7;
#pragma unroll
          for (int ch = 0; ch < 8; ++ch) {
            const int i = 8 * (2 * sy + sx) + ch;  // column block: subpixel, 8 channels
            const float2 ub =
                __ldg(reinterpret_cast<const float2*>(a.ubias + 64 * u + 8 * ch + 2 * (lane & 3)));
            const float v0 = in ? uacc[4 * i + 2 * h] + ub.x : 0.0f;
            const float v1 = in ? uacc[4 * i + 2 * h + 1] + ub.y : 0.0f;
            st_shared(row + ((ch ^ sw) << 4), pack_bf16(v0, v1), ok);
          }
        }
      }
      fence_proxy_async();  // the up tile's values, visible to wgmma's operand reads
      named_bar(1 + cw);    // the band's up values are written

      // ---- 2. the conv: m64 block mb is the 8 x 8 pixels at rows 8cw ..
      // 8cw+7, columns 8mb .. 8mb+7. For each dx the skip stages (A: the halo
      // box, 16-pixel rows), then the up stages (A: the up tile, 18-pixel rows,
      // started at the tap's pixel shift), one wgmma group a tap row, so that
      // a group and the one before it hold two B slots and the producer has
      // the rest to fill
      float acc[2 * NACC];
#pragma unroll
      for (int i = 0; i < 2 * NACC; ++i) acc[i] = 0.0f;
#pragma unroll 1
      for (int dx = 0; dx < 3; ++dx) {
#pragma unroll 1
        for (int j = 0; j < nkc + NU; ++j) {
          const bool skip = j < nkc;
          const int sa = skip ? ring_take<SA>(fullA, ra, 0) : -1;
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const int sb = ring_take<SB>(fullB, rb, 0);
            fence_acc<2 * NACC>(acc);
            __syncwarp();
            wg_fence();
            const uint64_t db = sw128_desc(base + L::B_OFF + sb * UB_BYTES);
#pragma unroll
            for (int mb = 0; mb < 2; ++mb) {
              // output pixel (r, c) of the block at tap (dy, dx): box row
              // 8cw + r + dy, column 8mb + c (the box starts at dx - 1); up
              // tile row r + dy, column 8mb + c + dx
              const uint64_t da =
                  skip ? sw128_desc_sbo(base + sa * UA_BYTES +
                                            ((8 * cw + dy) * TILE_X + 8 * mb) * 128,
                                        TILE_X * 128)
                       : sw128_desc_sbo(ut_s + (j - nkc) * UT_CHUNK +
                                            (dy * UT_W + 8 * mb + dx) * 128,
                                        UT_W * 128);
#pragma unroll
              for (int kk = 0; kk < BK / 16; ++kk)
                wgmma<BN>(acc + mb * NACC, da + 2 * kk, db + 2 * kk);
            }
            wg_commit();
            // the A slot goes with the stage's last group
            retire_prev<2 * NACC, SB>(acc, pend, dy == 2 ? sa : -1, sb, 1, emptyA, emptyB, t);
          }
        }
      }
      retire_all<2 * NACC, SB>(acc, pend, emptyA, emptyB, t);

      // ---- epilogue: bias, ReLU, one bf16 rounding, staged in this
      // consumer's up tile (an 8 x 8-pixel block x 64 channels at a time, the
      // 128B swizzle of the output map), then one TMA store a block (it clips
      // the ragged edge); the next tile's up epilogue waits until the stores
      // have read it
      named_bar(1 + cw);  // every warp's wgmma reads of the up tile are done
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int nb = 0; nb < NU; ++nb) {
          const uint32_t stg = ut_s + (mb * NU + nb) * (64 * 128);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int col = 64 * nb + 8 * i + 2 * (lane & 3);
            const float2 bb = __ldg(reinterpret_cast<const float2*>(a.bias + col));
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = warp * 16 + (lane >> 2) + 8 * h;  // pixel (r / 8, r % 8)
              float v0 = acc[mb * NACC + 32 * nb + 4 * i + 2 * h] + bb.x;
              float v1 = acc[mb * NACC + 32 * nb + 4 * i + 2 * h + 1] + bb.y;
              if (a.relu) {
                v0 = fmaxf(v0, 0.0f);
                v1 = fmaxf(v1, 0.0f);
              }
              st_shared(stg + stg_off(r, i) + 4 * (lane & 3), pack_bf16(v0, v1));
            }
          }
        }
      fence_proxy_async();  // the staged values, visible to the TMA unit
      named_bar(1 + cw);
      if (t == 0) {
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
#pragma unroll
          for (int nb = 0; nb < NU; ++nb)
            tma_store_3d(&map_out, ut_s + (mb * NU + nb) * (64 * 128), 64 * nb, x0 + 8 * mb,
                         y0 + 8 * cw);
        bulk_commit();
      }
    }
    if (t == 0) bulk_wait_read();  // the block's shared memory outlives its stores' reads
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
                     const CUtensorMap& mw, const CUtensorMap& mo, const UpArgs& a,
                     cudaStream_t s) {
  constexpr int smem = UpLayout<BN>::SMEM;
  static int grid_max = 0;  // resident blocks on the card, this kernel's own
  if (grid_max == 0) {
    int e = check_regs(conv3x3_up_wgmma<BN>);
    if (!e) e = query_grid(conv3x3_up_wgmma<BN>, NTHREADS, smem, &grid_max);
    if (e) return e;
  }
  const int ntiles = ((a.W + TILE_X - 1) / TILE_X) * ((a.H + UT_Y - 1) / UT_Y);
  conv3x3_up_wgmma<BN><<<ntiles < grid_max ? ntiles : grid_max, NTHREADS, smem, s>>>(
      ms, md, mu, mw, mo, a);
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
  CUtensorMap ms, md, mu, mw, mo;
  if (!encode_act(enc, &ms, skip, Cs, H, W, TILE_X, UT_Y + 2) ||
      !encode_act(enc, &md, deep, Cd, H / 2, W / 2, DEEP_X, DEEP_Y) ||
      !encode_w(enc, &mu, wup_t, Cd, 4 * F, 256) || !encode_w(enc, &mw, wt, 9 * (Cs + F), F, F) ||
      !encode_act(enc, &mo, out, F, H, W, 8, 8))  // the stores: 64 c, 8 x, 8 y
    return (int)cudaErrorInvalidValue;
  UpArgs a;
  a.Cs = Cs;
  a.Cd = Cd;
  a.H = H;
  a.W = W;
  a.relu = relu;
  a.bias = (const float*)bias;
  a.ubias = (const float*)ubias;
  cudaStream_t s = (cudaStream_t)stream;
  return F == 128 ? launch_up<128>(ms, md, mu, mw, mo, a, s)
                  : launch_up<64>(ms, md, mu, mw, mo, a, s);
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
