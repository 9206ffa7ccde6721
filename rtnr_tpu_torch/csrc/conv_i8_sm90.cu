// The int8 modes of K3 and K4 that the full-width U-Net runs, for Hopper: s8
// wgmma (.s32.s8.s8, k32) fed by TMA. Built as its own library
// (conv_i8_sm90); the shared PTX and host helpers are in sm90.cuh.
//
// Numerics are those of conv.cu's gemm<0,2>, gemm<0,1> and gemm<1,1>, bit for bit:
// exact i32 sums (127^2 x 9216 < 2^31), and every float multiply and add of
// the quantiser and the epilogues written with __fmul_rn / __fadd_rn, which
// nvcc never contracts into an FMA; i32 -> f32 with __int2float_rn.
//
// ---- conv3x3_dyn_wgmma: K3's dyn mode
//
// Replaces rtnr_tpu/ops/conv_phase.py::_conv_phase_kernel with quant="dyn"
// (conv_phase.py:317-337, 428-443). bf16 inputs (one or two, the virtual
// channel concat) are quantised to int8 per output pixel: amax = max |x|
// over the pixel's 3x3 receptive field and all channels, rinv = 127/amax (0
// where amax = 0), q = clip(rint(x * rinv), -127, 127); i32 sums with the
// per-output-channel int8 weights; y = f32(acc) * (scale[f] * (amax *
// f32(1/127))) + bias[f], ReLU, bf16, and an optional fused 2x2 max-pool.
// The grouping by output pixel (not by lane as on the TPU) is conv.cu's.
//
// Bound on this card: operations. The full-width net's ten dyn calls are
// 1.6172 TOP, 0.8172 ms at the H100 SXM's 1,979 TOP/s dense int8; their
// bf16 inputs are 476 MB, read once in ~0.14 ms.
// - Scales in two steps: pixel_amax reads each input once with 16-byte
//   loads (8 lanes a pixel, |x| as bf16 bits without the sign, whose order
//   is that of the values) and writes the per-pixel max; each consumer
//   thread then takes the 3x3 max over that map for its two fragment rows
//   in its tile's prologue. max is exact, so this equals the one-pass
//   receptive-field max (conv.cu's dyn_scales, dyn_scales_plain) bit for bit.
// - GEMM view as conv_sm90.cu's: 8 x 16 pixel tiles, K = 9*(C0+C1) in
//   (tap, input, channel) order; a stage is (dx, input, 64-channel chunk):
//   one TMA halo box (64 c, 16 x, 10 y) of bf16, 128B swizzle, zero padding
//   from TMA's out-of-bounds fill, serving the three dy taps.
// - The quantised A cannot come from memory: the same input pixel
//   quantises with each of its nine neighbours' factors. Each consumer
//   thread quantises in registers the 16 values of its wgmma A fragment a
//   k32 step (rows l/4 and l/4 + 8 of its warp's 16, k bytes 4(l%4).. and
//   16 + 4(l%4)..: one 8-byte ld.shared of 4 bf16 at the swizzled address a
//   register) with its rows' rinv, and issues wgmma m64n256k32 in RS form,
//   B by TMA from the K-major (F, K) int8 copy (Conv3x3Weights.wmat_t),
//   three (64 k, 256 n) boxes a stage with the 64B swizzle (64-byte rows).
//   The rows of a thread's A fragment are the rows of its accumulator, so
//   the same two factors dequantise its outputs.
// - rint, clamp and pack: clip(rint(v), -127, 127) = rint(clip(v, -127,
//   127)) (rint is monotone, the bounds are integers); v + 1.5 * 2^23 rounds
//   to nearest even and leaves the code in the low byte; byte_perm packs
//   four. About 6 instructions a value.
// - N tile = 256 channels (every dyn call has F in {256, 512, 1024}). A
//   64-channel stage of a tile is 128 x 256 x 192 MACs: ~1,536 cycles of
//   the SM's ~4,096 int8 MACs a cycle. Its quantiser issues 24,576 values x
//   ~6 instructions over 4 sub-partitions: ~1,150 cycles a sub-partition.
//   At 128 channels the MMA halves and the quantiser becomes the bound.
// - One wgmma group stays in flight: the A fragments are double-buffered,
//   step k+1 quantised while group k runs; a buffer is rewritten only after
//   the group that read it has retired (wait_group 1). The full-width net's
//   ten dyn calls take 2.004 ms of kernel time so on an NVIDIA H100 80GB
//   HBM3 at 700 W (41% of the int8 peak); two groups in flight over three
//   buffers (wait_group 2, the previous stage released a step later) took
//   2.126 ms on the same card type.
// - m64n256 s32 accumulators are 128 registers a consumer thread: the
//   producer warpgroup drops to 40 registers and the consumers take 232
//   (setmaxnreg). Ring of 3 stages (20 KB box + 48 KB weights), 220 KB of
//   shared memory, one block an SM, persistent grid.
// - Epilogue as conv_sm90.cu's: a 64-channel block at a time staged in
//   shared memory, 16-byte stores masked at the ragged edge (68 x 120:
//   68 % 8 = 4, 120 % 16 = 8), the 2x2 pool of the bf16 output fused.
//
// ---- convt2x2_i8_wgmma: K4's static mode
//
// Replaces rtnr_tpu/ops/conv_phase.py::_convt_phase_kernel with
// quant="static" (conv_phase.py:1051-1320, wrapper convt2x2_phase). A GEMM:
// M = H*W input pixels, N = 4F columns in (dy, dx, f) order, K = C, int8
// codes and per-output-channel int8 weights of flax's flipped kernel, i32
// sums; y = f32(acc) * scale[f] + bias[f]; codes clip(rint(y), -127, 127)
// written to output pixel (2y+dy, 2x+dx). Every full-width call writes int8.
//
// Bound on this card, 0.1244 ms over the four calls: bytes at up2 (272x480x
// 256 -> 128) and up3 (544x960x128 -> 64), operations at up0 and up1. conv.cu
// re-read A once per 64-column block and wrote one byte a thread through a
// scatter; here:
// - A by TMA: a 2D map over the (H*W, C) codes, boxes of (128 k, 128 pixels)
//   with the 128B swizzle: wgmma's K-major s8 A, each k32 step 32 bytes on.
// - B by TMA from a K-major (4F, C) int8 copy (ConvT2x2Weights.wmat_t) in
//   the GEMM's column order, (128 k, 256 n) boxes: Hopper's 8-bit wgmma
//   takes both operands K-major only. An N tile of 256 columns lies inside
//   one output sub-row dy (or is all of N where 4F = 256, as at up3).
// - Tiles 128 x 256, N fastest, persistent grid: the N tiles of one M tile
//   run side by side, so A comes from device memory once (up3: NT = 1). B
//   stays resident: the producer skips the B box of a stage whose buffer
//   already holds it (up3, up2 and up1 load each once a block).
// - Epilogue: the codes staged in shared memory in column order (16-byte
//   chunks XOR-swizzled by row), then 16-byte stores: 16 columns are 16
//   contiguous bytes of one output pixel, and a pixel's chunks cover its 2F
//   bytes of output row 2y+dy per dy. Ragged M (8160 at up0) is masked;
//   TMA zero-fills the rows past the end.
// - Ring of 4 stages of 48 KB, 32 KB of staging: 224 KB, one block an SM.
//
// ---- conv3x3_static_wgmma: K3's static mode
//
// Replaces rtnr_tpu/ops/conv_phase.py::_conv_phase_kernel with
// quant="static" (conv_phase.py:338-345, 390-427; weights :864-868,
// 913-936): conv.cu's AK 1. int8 codes in (one input or two, the virtual
// channel concat; a second input's scale ratio is already in its weight
// slice, so the kernel does not rescale), i32 sums over 9*(C0+C1), y =
// f32(acc) * scale[f] + bias[f], ReLU; out either the codes clip(rint(y),
// 0 or -127, 127) or bf16 (the head conv). Fused options as conv_sm90.cu's:
// the 2x2 max-pool of the output (max of codes is exact) and the 1x1 head on
// the bf16 output (OC <= 8, f32 sums, HeadWeights.hk8; the conv output is
// then not written).
//
// Bound on this card: operations. The full-width net's 17 static calls are
// 2.95 TOP, 1.4911 ms at 1,979 TOP/s. conv.cu's gemm<0,1> (wmma mma.sync
// 16x16x16, one shared buffer, A gathered element by element, a scalar
// scatter epilogue) ran them at 113 TOP/s. Here the static codes need no
// quantiser, so the operands go from TMA straight to SS-form s8 wgmma, on
// conv_sm90.cu's skeleton:
// - The pixels (wgmma's B) by TMA halo boxes of int8: a stage is one (dx,
//   input, 64-channel chunk), one box (64 c = 64 bytes, 16 x, 18 y) at (c0,
//   x0 + dx - 1, y0 - 1) with the 64B swizzle (8-row atoms of 512 bytes),
//   zero padding from TMA's out-of-bounds fill. A box row of 16 pixels is 1
//   KB, so the three dy taps' operands start on atom boundaries; a one-pixel
//   dx shift (64 bytes) would not, hence a box per dx. Descriptors of layout
//   type 2 (SBO 512), two k32 steps a chunk.
// - The weights (wgmma's A) by TMA from the K-major (F, 9*(C0+C1)) int8
//   copy (Conv3x3Weights.wmat_t, the dyn copy's row map t*(C0+C1) + (C0 if
//   input 1) + c): three (64 k, 64 f) boxes a stage, 64B swizzle. Hopper's
//   8-bit wgmma takes both operands K-major only.
// - Swapped operands: A = the tile's 64 output channels' weights, B = its
//   256 pixels (16 image rows x 16 columns), m64n256k32. SS-form wgmma reads
//   both operands from shared memory for every instruction, (64 + N) x 32
//   bytes a k32 step for 64 N 32 MACs: an m64n64 tile (64 pixels by 64
//   channels) would need 128 bytes a cycle at the int8 rate, all the SM's
//   shared-memory bandwidth; n256 needs 80. The accumulator is channels by
//   pixels (128 s32 registers a thread, setmaxnreg 40 / 232), and the
//   epilogue stages it transposed, a byte (or a bf16) a store.
// - Ping-pong: a tile is 16 x 16 pixels by 64 channels and the two consumer
//   warpgroups take the block's tiles in turn, each with its own stages
//   (the producer fills the ring tile after tile; a consumer steps over the
//   other's). A consumer issues its MMAs only in its turn (two mbarriers
//   pass the turn after its last group retires), so one consumer's
//   epilogue runs under the other's MMAs: at 64 input channels a tile has
//   three stages, and its epilogue (4 blocks of 64 pixels) is as long as
//   its MMAs. Ring of 6 stages (18 KB box + 12 KB weights), 196 KB.
// - Measured against the forms this file had first (chip_smoke.py, in
//   turns, on an NVIDIA H100 80GB HBM3 at 700 W, ms a call): the two
//   consumers on one tile, as swapped 64-channel tiles of 32 x 16 pixels,
//   swapped 128-channel tiles (the consumers on its channel halves) and
//   unswapped 256-channel tiles of 8 x 16 pixels, the best picked per F,
//   summed to 2.7200 ms over the full-width net's 17 calls; this form sums
//   to 2.4999 and wins at 15 of the 17 (down0/conv1, 1088x1920x64 -> 64:
//   0.2063 against 0.2218; updc1/conv0, 272x480x(256+256) -> 256: 0.1889
//   against 0.2076; bottleneck/conv1, 68x120x1024 -> 1024: 0.1258 against
//   0.1455). It loses 0.012 ms at updc3/conv0 (1088x1920x(64+64) -> 64: the
//   18-row box of a 16-row tile carries 12.5% halo, the 34-row box of a
//   32-row one 6%) and 0.010 at updc0/conv0 (136x240x(512+512) -> 512).
// - The fused head needs every channel of a pixel in one consumer: F = 64
//   only (the net's head conv); a head at F > 64 stays on conv.cu.
// - Epilogue per 64-pixel, 64-channel block, staged in shared memory and
//   stored 16 bytes at a time, masked at the ragged edge (68 x 120: 68 % 16
//   = 4, 120 % 16 = 8): codes as 64-byte rows (16-byte chunks XOR-swizzled
//   by row pair), the pool from the staged codes (__vmaxs4), bf16 as
//   conv_sm90.cu stages it, the head from the staged bf16 values on
//   mma.sync m16n8k16 (a scalar loop with a head-kernel load a product cost
//   the head conv 0.42 ms against 0.25). The code is clip(rint(y), lo, 127)
//   with the ReLU folded into lo and one __float2int_rn (round half to even,
//   as rintf): the C = 64 calls took 17% longer with rintf, fmaxf, fminf.
//
// Every kernel: no split-K and no atomics, so a call gives the same bits
// every time; mbar_wait traps on a stuck pipeline. Every entry returns a
// cudaError_t (0 on success): cudaErrorInvalidValue for shapes it does not
// take or a tensor map that does not encode, else cudaGetLastError().

#include "sm90.cuh"

#define NTHREADS 384  // producer warpgroup + two consumer warpgroups
#define BN 256        // output channels (K3 dyn) or GEMM columns (K4) of a tile
#define INV127 ((float)(1.0 / 127.0))

// K3 dyn
#define TILE_Y 8
#define TILE_X 16
#define DBK 64                                     // channels of a stage: 64 bf16, 128 bytes
#define ROW_BYTES (TILE_X * DBK * 2)               // one image row of the box: 2 KB
#define A_BYTES ((TILE_Y + 2) * ROW_BYTES)         // the halo box: 20 KB
#define DB_BYTES (BN * DBK)                        // one dy tap's weights: 16 KB
#define DSTAGES 3
#define DSTAGE_BYTES (A_BYTES + 3 * DB_BYTES)      // 68 KB
#define STG_BYTES (64 * 64 * 2)                    // a consumer's staged 64 x 64 bf16 block
#define DBAR_OFF (DSTAGES * DSTAGE_BYTES + 2 * STG_BYTES)
#define DSMEM (DBAR_OFF + 2 * DSTAGES * 8)

// K4 static
#define TBM 128                                    // GEMM rows of a tile
#define TBK 128                                    // K bytes of a stage
#define TA_BYTES (TBM * TBK)                       // 16 KB
#define TB_BYTES (BN * TBK)                        // 32 KB
#define TSTAGES 4
#define TSTAGE_BYTES (TA_BYTES + TB_BYTES)
#define TSTG_BYTES (64 * BN)                       // a consumer's staged 64 x 256 codes
#define TBAR_OFF (TSTAGES * TSTAGE_BYTES + 2 * TSTG_BYTES)
#define TSMEM (TBAR_OFF + 2 * TSTAGES * 8)

static_assert(DSMEM <= 232448 && TSMEM <= 232448, "shared memory");

// K3 static: tiles of 16 x 16 pixels by 64 channels, one a consumer
#define SBK 64                                     // channels of a stage: 64 int8, 64 bytes
#define S_ROW_BYTES (TILE_X * SBK)                 // one image row of the box: 1 KB
#define S_TY 16                                    // image rows of a tile
#define SA_BYTES ((S_TY + 2) * S_ROW_BYTES)        // the halo box: 18 KB
#define SB_BYTES (64 * SBK)                        // one dy tap's weights: 4 KB
#define SSTAGES 6
#define SSTAGE_BYTES (SA_BYTES + 3 * SB_BYTES)     // 30 KB
#define SBAR_OFF (SSTAGES * SSTAGE_BYTES + 2 * STG_BYTES)
#define SSMEM (SBAR_OFF + 2 * SSTAGES * 8 + 16)    // + the two turn barriers
static_assert(SSMEM <= 232448 && SSTAGE_BYTES % 1024 == 0, "shared memory");
static_assert(DSTAGE_BYTES % 1024 == 0 && A_BYTES % 1024 == 0 && TSTAGE_BYTES % 1024 == 0,
              "swizzled tiles stay 1024-byte aligned");

struct DynArgs {
  int C0, C1, H, W, F, relu;
  const float* amax;   // (H*W,) per-pixel max |x| (pixel_amax)
  const float* scale;  // (F,) weight dequantisation scale
  const float* bias;   // (F,) f32 values of the bf16 bias
  bf16* out;           // (H, W, F)
  bf16* pooled;        // (H/2, W/2, F) or null
};

struct ConvTArgs {
  int M, C, W, F;      // input pixels, channels, input width, output channels
  const float* scale;  // (F,)
  const float* bias;   // (F,)
  signed char* out;    // (2H, 2W, F) codes
};

struct StaticArgs {
  int C0, C1, H, W, F, relu, out_i8, OC;
  const float* scale;  // (F,) weight x input / output scale (prepare_conv3x3)
  const float* bias;   // (F,) f32 values of the bf16 bias
  void* out;           // (H, W, F) codes or bf16, or null with the head
  void* pooled;        // (H/2, W/2, F) of the same type, or null
  const bf16* hk8;     // (F, 8) head kernel, zero past OC, or null
  const float* hb;     // (OC,) head bias
  bf16* hout;          // (H, W, OC) or null
};

// ------------------------------------------------------------ s8 wgmma

// D(64 x 256, s32) += A(64 x 32, s8, K-major smem) * B(32 x 256, s8, K-major smem)
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
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
      "}, %128, %129, p;\n}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// D(64 x 256, s32) += A(64 x 32, s8, registers) * B(32 x 256, s8, K-major smem):
// warp w holds rows 16w..16w+15 of A, register j of lane l the 4 k bytes
// 4(l%4) + 16(j/2) .. +3 of row 16w + l/4 + 8(j%2), as mma.m16n8k32 does
__device__ __forceinline__ void wgmma_s8_rs(int* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
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
      "}, {%128, %129, %130, %131}, %132, p;\n}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// keep a register fragment alive (and unmoved) until this point: an RS
// wgmma reads its A registers after the instruction has issued
__device__ __forceinline__ void fence_frag(uint32_t* a) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// clip(rint(v * inv), -127, 127) as the low byte of a float
__device__ __forceinline__ uint32_t qbyte(float v, float inv) {
  const float c = fminf(fmaxf(__fmul_rn(v, inv), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(c, 12582912.0f));  // 1.5 * 2^23: rounds to nearest even
}

// four bf16 (x.lo, x.hi, y.lo, y.hi) quantised and packed, the first in the low byte
__device__ __forceinline__ uint32_t quant4(uint2 v, float inv) {
  const uint32_t b0 = qbyte(__uint_as_float(v.x << 16), inv);
  const uint32_t b1 = qbyte(__uint_as_float(v.x & 0xffff0000u), inv);
  const uint32_t b2 = qbyte(__uint_as_float(v.y << 16), inv);
  const uint32_t b3 = qbyte(__uint_as_float(v.y & 0xffff0000u), inv);
  return __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040), 0x5410);
}

// ------------------------------------------------------------ K3 dyn

// per pixel, max |x| over the channels of both inputs: 8 lanes a pixel, 32
// pixels a block of 256 threads
__global__ void __launch_bounds__(256) pixel_amax(const bf16* __restrict__ x0,
                                                  const bf16* __restrict__ x1, int C0, int C1,
                                                  int M, float* __restrict__ amax) {
  const int m = blockIdx.x * 32 + (threadIdx.x >> 3);
  const int l8 = threadIdx.x & 7;
  uint32_t mx = 0;  // two packed bf16 magnitudes; non-negative bf16 order as their bits
  if (m < M) {
    for (int i = 0; i < 2; ++i) {
      const int C = i ? C1 : C0;
      const uint4* p = reinterpret_cast<const uint4*>((i ? x1 : x0) + (size_t)m * C);
      for (int c = l8; c < C / 8; c += 8) {
        const uint4 v = __ldg(p + c);
        mx = __vmaxu2(mx, __vmaxu2(__vmaxu2(v.x & 0x7fff7fffu, v.y & 0x7fff7fffu),
                                   __vmaxu2(v.z & 0x7fff7fffu, v.w & 0x7fff7fffu)));
      }
    }
  }
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) mx = __vmaxu2(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (m < M && l8 == 0) amax[m] = __uint_as_float(max(mx & 0xffffu, mx >> 16) << 16);
}

// 64-channel block nb of a consumer's accumulator: dequantise with the
// rows' factors, bias, ReLU, one bf16 rounding, staged as 64 rows of 128 bytes
__device__ __forceinline__ void stage_dyn(const int* acc, int nb, const float* scale,
                                          const float* bias, const float* rsc, int relu,
                                          unsigned char* stg, int warp, int lane) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = 8 * i + 2 * (lane & 3);
    const float s0 = scale[col], s1 = scale[col + 1], b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + (lane >> 2) + 8 * h;
      float v0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[32 * nb + 4 * i + 2 * h]),
                                     __fmul_rn(s0, rsc[h])), b0);
      float v1 = __fadd_rn(__fmul_rn(__int2float_rn(acc[32 * nb + 4 * i + 2 * h + 1]),
                                     __fmul_rn(s1, rsc[h])), b1);
      if (relu) {
        v0 = fmaxf(v0, 0.0f);
        v1 = fmaxf(v1, 0.0f);
      }
      *reinterpret_cast<__nv_bfloat162*>(stg + stg_off(r, i) + 4 * (lane & 3)) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
    conv3x3_dyn_wgmma(const __grid_constant__ CUtensorMap map_x0,
                      const __grid_constant__ CUtensorMap map_x1,
                      const __grid_constant__ CUtensorMap map_w, const DynArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t full0 = base + DBAR_OFF;      // full[s] = full0 + 8s
  const uint32_t empty0 = full0 + 8 * DSTAGES;  // empty[s] = empty0 + 8s

  if (threadIdx.x == 0) {
    if (base & 1023) __trap();  // the swizzles need 1024-byte aligned tiles
    for (int s = 0; s < DSTAGES; ++s) {
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
    setmaxnreg_dec40();
    if (threadIdx.x == 0) {
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
            for (int c = 0; c < C; c += DBK) {
              const uint32_t full = full0 + 8 * stage;
              mbar_wait(empty0 + 8 * stage, phase ^ 1);
              mbar_expect_tx(full, DSTAGE_BYTES);
              const uint32_t sa = base + stage * DSTAGE_BYTES;
              tma_load_3d(sa, map, full, c, x0 + dx - 1, y0 - 1);
#pragma unroll
              for (int dy = 0; dy < 3; ++dy)
                tma_load_2d(sa + A_BYTES + dy * DB_BYTES, &map_w, full, kb + 3 * dy * ct + c, n0);
              if (++stage == DSTAGES) {
                stage = 0;
                phase ^= 1;
              }
            }
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns rows 64cw..64cw+63 of the tile (image
    // rows y0 + 4cw .. +3); lane l of warp w holds the A and accumulator rows
    // 16w + g and 16w + g + 8 (g = l/4): pixel columns x0 + g and x0 + g + 8
    setmaxnreg_inc232();
    const int cw = wg - 1;
    const int t = threadIdx.x & 127;
    const int warp = t >> 5, lane = t & 31;
    const int g = lane >> 2, q = lane & 3;
    unsigned char* stg = smem + DSTAGES * DSTAGE_BYTES + cw * STG_BYTES;
    const int nk = 3 * ct / DBK;  // stages a tile
    // byte offsets in a box row of this lane's 8-byte pieces: k32 step s,
    // half u, at box row p (p & 7 == g): chunk 4s + 2u + q/2, XOR g
    int off[2][2];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int u = 0; u < 2; ++u) off[s][u] = (((4 * s + 2 * u + (q >> 1)) ^ g) << 4) + 8 * (q & 1);
    int acc[BN / 2];
    uint32_t af[2][4];
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int n0 = (tile % NT) * BN;
      const int pt = tile / NT;
      const int x0 = (pt % TX) * TILE_X, y0 = (pt / TX) * TILE_Y;
      const int yr = y0 + 4 * cw + warp;  // this warp's image row
      // the rows' factors: the 3x3 max of the per-pixel maxima
      float rinv[2], rsc[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int xr = x0 + g + 8 * h;
        float am = 0.0f;
        if (yr < a.H && xr < a.W) {
#pragma unroll
          for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
            for (int dx = -1; dx <= 1; ++dx) {
              const int yy = yr + dy, xx = xr + dx;
              if (yy >= 0 && yy < a.H && xx >= 0 && xx < a.W)
                am = fmaxf(am, __ldg(a.amax + (size_t)yy * a.W + xx));
            }
        }
        rinv[h] = am > 0.0f ? __fdiv_rn(127.0f, am) : 0.0f;
        rsc[h] = __fmul_rn(am, INV127);
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      int prev = 0;
      for (int ks = 0; ks < nk; ++ks) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t sa = base + stage * DSTAGE_BYTES;
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const int dy = j >> 1, s = j & 1;
          uint32_t* fr = af[j & 1];
          if (ks > 0 || j > 0) {
            // the group before last (which read fr) has retired ...
            fence_acc<BN / 2>(acc);
            wg_wait<1>();
            fence_acc<BN / 2>(acc);
            fence_frag(fr);
            // ... and at j == 1 every group of the previous stage
            if (j == 1 && ks > 0 && t == 0) mbar_arrive(empty0 + 8 * prev);
          }
          // box row p of fragment row g, 8 box rows on for row g + 8
          const unsigned char* row =
              smem + stage * DSTAGE_BYTES + ((dy + 4 * cw + warp) * TILE_X + g) * 128;
          fr[0] = quant4(*reinterpret_cast<const uint2*>(row + off[s][0]), rinv[0]);
          fr[1] = quant4(*reinterpret_cast<const uint2*>(row + 1024 + off[s][0]), rinv[1]);
          fr[2] = quant4(*reinterpret_cast<const uint2*>(row + off[s][1]), rinv[0]);
          fr[3] = quant4(*reinterpret_cast<const uint2*>(row + 1024 + off[s][1]), rinv[1]);
          fence_acc<BN / 2>(acc);
          __syncwarp();  // the .aligned wgmma instructions need the whole warp
          wg_fence();
          wgmma_s8_rs(acc, fr, sw64_desc(sa + A_BYTES + dy * DB_BYTES) + 2 * s);
          wg_commit();
        }
        prev = stage;
        if (++stage == DSTAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      fence_acc<BN / 2>(acc);
      wg_wait<0>();
      fence_acc<BN / 2>(acc);
      fence_frag(af[0]);
      fence_frag(af[1]);
      if (t == 0) mbar_arrive(empty0 + 8 * prev);

      // ---- epilogue, one 64-channel block at a time
      const int yb = y0 + 4 * cw;
#pragma unroll
      for (int nb = 0; nb < BN / 64; ++nb) {
        const int nc = n0 + 64 * nb;
        named_bar(1 + cw);  // every thread is done reading the staged block
        stage_dyn(acc, nb, a.scale + nc, a.bias + nc, rsc, a.relu, stg, warp, lane);
        named_bar(1 + cw);
        store_block(stg, a.out, a.H, a.W, a.F, yb, x0, nc, t);
        if (a.pooled) pool_block(stg, a.pooled, a.H, a.W, a.F, yb, x0, nc, t);
      }
    }
  }
}

// ------------------------------------------------------------ K4 static

__device__ __forceinline__ uint32_t code8(int acc, float s, float b) {
  const float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), s), b);
  return (uint32_t)(int)fminf(fmaxf(rintf(y), -127.0f), 127.0f) & 0xffu;
}

// byte offset of 16-byte chunk `ch` (0..15) of staged row `r` (256 codes)
__device__ __forceinline__ int tstg_off(int r, int ch) { return r * 256 + ((ch ^ (r & 15)) << 4); }

__global__ void __launch_bounds__(NTHREADS, 1)
    convt2x2_i8_wgmma(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b, const ConvTArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t full0 = base + TBAR_OFF;
  const uint32_t empty0 = full0 + 8 * TSTAGES;

  if (threadIdx.x == 0) {
    if (base & 1023) __trap();
    for (int s = 0; s < TSTAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int NT = 4 * a.F / BN;
  const int ntiles = ((a.M + TBM - 1) / TBM) * NT;
  const int nk = (a.C + TBK - 1) / TBK;
  const int wg = threadIdx.x >> 7;

  if (wg == 0) {
    setmaxnreg_dec40();
    if (threadIdx.x == 0) {
      int bkey[TSTAGES];  // the (N tile, K step) whose B box each stage buffer holds
#pragma unroll
      for (int s = 0; s < TSTAGES; ++s) bkey[s] = -1;
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int nt = tile % NT;
        const int m0 = (tile / NT) * TBM;
        for (int ks = 0; ks < nk; ++ks) {
          const uint32_t full = full0 + 8 * stage;
          const uint32_t sa = base + stage * TSTAGE_BYTES;
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const int key = nt * nk + ks;
          int held = 0;
#pragma unroll
          for (int s = 0; s < TSTAGES; ++s)
            if (s == stage) held = bkey[s] == key;
          mbar_expect_tx(full, TA_BYTES + (held ? 0 : TB_BYTES));
          tma_load_2d(sa, &map_a, full, ks * TBK, m0);
          if (!held) {
            tma_load_2d(sa + TA_BYTES, &map_b, full, ks * TBK, nt * BN);
#pragma unroll
            for (int s = 0; s < TSTAGES; ++s)
              if (s == stage) bkey[s] = key;
          }
          if (++stage == TSTAGES) {
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
    unsigned char* stg = smem + TSTAGES * TSTAGE_BYTES + cw * TSTG_BYTES;
    int acc[BN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int n0 = (tile % NT) * BN;
      const int m0 = (tile / NT) * TBM;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      int prev = 0;
      for (int ks = 0; ks < nk; ++ks) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t sa = base + stage * TSTAGE_BYTES;
        fence_acc<BN / 2>(acc);
        __syncwarp();
        wg_fence();
        const uint64_t da = sw128_desc(sa + cw * 64 * TBK);  // rows 64cw.. of the A box
        const uint64_t db = sw128_desc(sa + TA_BYTES);
#pragma unroll
        for (int kk = 0; kk < TBK / 32; ++kk) wgmma_s8(acc, da + 2 * kk, db + 2 * kk);
        wg_commit();
        fence_acc<BN / 2>(acc);
        wg_wait<1>();  // the previous step's group has retired: its stage is free
        fence_acc<BN / 2>(acc);
        if (ks > 0 && t == 0) mbar_arrive(empty0 + 8 * prev);
        prev = stage;
        if (++stage == TSTAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wg_wait<0>();
      fence_acc<BN / 2>(acc);
      if (t == 0) mbar_arrive(empty0 + 8 * prev);

      // ---- epilogue: codes staged in column order, then 16-byte stores
      named_bar(1 + cw);  // the previous tile's stores have read the staging
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int col = 8 * i + 2 * (lane & 3);
        const int f = (n0 + col) % a.F;  // F % 64 == 0: f + 1 is the next column's channel
        const float s0 = __ldg(a.scale + f), s1 = __ldg(a.scale + f + 1);
        const float b0 = __ldg(a.bias + f), b1 = __ldg(a.bias + f + 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = warp * 16 + (lane >> 2) + 8 * h;
          const uint32_t v = code8(acc[4 * i + 2 * h], s0, b0) |
                             (code8(acc[4 * i + 2 * h + 1], s1, b1) << 8);
          *reinterpret_cast<unsigned short*>(stg + tstg_off(r, i >> 1) + 8 * (i & 1) +
                                             2 * (lane & 3)) = (unsigned short)v;
        }
      }
      named_bar(1 + cw);
      // 16 columns (a chunk) are 16 contiguous output bytes: column n is
      // channel n % F of subpixel n / F = (dy, dx)
      const int ch = t & 15;
      const int n = n0 + 16 * ch;
      const int sub = n / a.F, f = n - sub * a.F;
      const int dy = sub >> 1, dx = sub & 1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = (t >> 4) + 8 * j;
        const int m = m0 + 64 * cw + r;
        if (m < a.M) {
          const int y = m / a.W, x = m - y * a.W;
          *reinterpret_cast<uint4*>(a.out + ((size_t)(2 * y + dy) * (2 * a.W) + 2 * x + dx) *
                                                a.F + f) =
              *reinterpret_cast<const uint4*>(stg + tstg_off(r, ch));
        }
      }
    }
  }
}

// ------------------------------------------------------------ K3 static

// byte offset of 16-byte chunk `ch` (0..3) of staged row `r` (64 codes)
__device__ __forceinline__ int qstg_off(int r, int ch) { return r * 64 + ((ch ^ ((r >> 1) & 3)) << 4); }

__device__ __forceinline__ float static_y(int acc, float s, float b, int relu) {
  const float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), s), b);
  return relu ? fmaxf(y, 0.0f) : y;
}

// the code clip(rint(max(y, 0) if relu else y), lo, 127) with lo = 0 under
// ReLU, else -127: rint is monotone and rint(0) = 0, so the ReLU is the
// lower clip, and __float2int_rn rounds half to even as rintf does
__device__ __forceinline__ int static_code(int acc, float s, float b, int lo) {
  return min(max(__float2int_rn(__fadd_rn(__fmul_rn(__int2float_rn(acc), s), b)), lo), 127);
}

// a staged block of codes (64 pixels: 4 rows x 16 columns from (yb, x0),
// 64 channels from nc) to out (H, W, F): 16-byte stores masked at the edge
__device__ __forceinline__ void store_block_i8(const unsigned char* stg, signed char* out, int H,
                                               int W, int F, int yb, int x0, int nc, int t) {
  for (int idx = t; idx < 64 * 4; idx += 128) {
    const int r = idx >> 2, ch = idx & 3;
    const int y = yb + (r >> 4), x = x0 + (r & 15);
    if (y < H && x < W)
      *reinterpret_cast<uint4*>(out + ((size_t)y * W + x) * F + nc + ch * 16) =
          *reinterpret_cast<const uint4*>(stg + qstg_off(r, ch));
  }
}

__device__ __forceinline__ uint4 vmax16(uint4 a, uint4 b) {
  return make_uint4(__vmaxs4(a.x, b.x), __vmaxs4(a.y, b.y), __vmaxs4(a.z, b.z),
                    __vmaxs4(a.w, b.w));
}

// the 2x2/2 max-pool of the same block (yb, x0 even): 2 x 8 pooled pixels x
// 4 chunks, one a thread of the first 64
__device__ __forceinline__ void pool_block_i8(const unsigned char* stg, signed char* pooled,
                                              int H, int W, int F, int yb, int x0, int nc,
                                              int t) {
  if (t >= 64) return;
  const int hp = H / 2, wp = W / 2;
  const int q = t >> 2, ch = t & 3;
  const int j = q >> 3, i = q & 7;
  const int py = yb / 2 + j, px = x0 / 2 + i;
  if (py < hp && px < wp) {
    const int r = 32 * j + 2 * i;  // staged row of pixel (2j, 2i) of the band
    const uint4 v = vmax16(vmax16(*reinterpret_cast<const uint4*>(stg + qstg_off(r, ch)),
                                  *reinterpret_cast<const uint4*>(stg + qstg_off(r + 1, ch))),
                           vmax16(*reinterpret_cast<const uint4*>(stg + qstg_off(r + 16, ch)),
                                  *reinterpret_cast<const uint4*>(stg + qstg_off(r + 17, ch))));
    *reinterpret_cast<uint4*>(pooled + ((size_t)py * wp + px) * F + nc + ch * 16) = v;
  }
}

// pixel block b (64 pixels) of a consumer's accumulator (rows = channels
// f0 = 16*warp + lane/4 and f0 + 8, columns = pixels) as codes, staged as 64
// rows of 64 bytes, 16-byte chunks XOR-swizzled by row pair (a byte a store)
__device__ __forceinline__ void stage_swap_i8(const int* acc, int b, const float* scale,
                                              const float* bias, int relu, unsigned char* stg,
                                              int warp, int lane) {
  const int lo = relu ? 0 : -127;
  const int f0 = 16 * warp + (lane >> 2), q = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = f0 + 8 * h;
    const float s = __ldg(scale + f), bb = __ldg(bias + f);
    unsigned char* col = stg + (f & 15);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 8 * i + 2 * q + e;  // pixel of the block
        col[qstg_off(r, f >> 4)] =
            (unsigned char)(static_code(acc[32 * b + 4 * i + 2 * h + e], s, bb, lo) & 0xff);
      }
    }
  }
}

// the same in bf16 (the head conv), staged as conv_sm90.cu stages it
__device__ __forceinline__ void stage_swap_bf16(const int* acc, int b, const float* scale,
                                                const float* bias, int relu, unsigned char* stg,
                                                int warp, int lane) {
  const int f0 = 16 * warp + (lane >> 2), q = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = f0 + 8 * h;
    const float s = __ldg(scale + f), bb = __ldg(bias + f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 8 * i + 2 * q + e;
        *reinterpret_cast<bf16*>(stg + stg_off(r, f >> 3) + 2 * (f & 7)) =
            __float2bfloat16_rn(static_y(acc[32 * b + 4 * i + 2 * h + e], s, bb, relu));
      }
    }
  }
}

// the fused 1x1 head on a staged bf16 block (64 pixels x the 64 channels of
// F = 64): warp w's 16 pixels x the 8 head columns, mma.sync m16n8k16 over
// the channels (A by ldmatrix from the staged rows, B = the (64, 8) head
// kernel), f32 sums into hc
__device__ __forceinline__ void head_mma(const unsigned char* stg, const bf16* hk8, int warp,
                                         int lane, float* hc) {
  const unsigned short* hk = reinterpret_cast<const unsigned short*>(hk8);
  const int g = lane >> 2, q = lane & 3;
  const int row = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);  // this lane's ldmatrix row
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(stg);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, sbase + stg_off(row, 2 * kk + (lane >> 4)));
    const int k = 16 * kk + 2 * q;
    const uint32_t b0 = (uint32_t)__ldg(hk + k * 8 + g) | ((uint32_t)__ldg(hk + (k + 1) * 8 + g) << 16);
    const uint32_t b1 =
        (uint32_t)__ldg(hk + (k + 8) * 8 + g) | ((uint32_t)__ldg(hk + (k + 9) * 8 + g) << 16);
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(hc[0]), "+f"(hc[1]), "+f"(hc[2]), "+f"(hc[3])
        : "r"(af[0]), "r"(af[1]), "r"(af[2]), "r"(af[3]), "r"(b0), "r"(b1));
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
    conv3x3_static_wgmma(const __grid_constant__ CUtensorMap map_x0,
                         const __grid_constant__ CUtensorMap map_x1,
                         const __grid_constant__ CUtensorMap map_w, const StaticArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t full0 = base + SBAR_OFF;
  const uint32_t empty0 = full0 + 8 * SSTAGES;
  const uint32_t turn0 = empty0 + 8 * SSTAGES;  // turn[c] = turn0 + 8c

  if (threadIdx.x == 0) {
    if (base & 1023) __trap();
    for (int s = 0; s < SSTAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the producer's expect_tx arrival
      mbar_init(empty0 + 8 * s, 1);  // the consumer whose tile the stage holds
    }
    mbar_init(turn0, 1);
    mbar_init(turn0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_arrive(turn0);  // consumer 0 takes the first turn
  }
  __syncthreads();

  const int TX = (a.W + TILE_X - 1) / TILE_X;
  const int TYN = (a.H + S_TY - 1) / S_TY;
  const int NT = a.F / 64;
  const int ntiles = TX * TYN * NT;
  const int ct = a.C0 + a.C1;
  const int nk = 3 * ct / SBK;  // stages a tile: (dx, input, 64-channel chunk)
  const int wg = threadIdx.x >> 7;

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full, tile after tile
    setmaxnreg_dec40();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int n0 = (tile % NT) * 64;
        const int pt = tile / NT;
        const int x0 = (pt % TX) * TILE_X, y0 = (pt / TX) * S_TY;
        for (int dx = 0; dx < 3; ++dx) {
          for (int inp = 0; inp < 2; ++inp) {
            const int C = inp ? a.C1 : a.C0;
            const CUtensorMap* map = inp ? &map_x1 : &map_x0;
            const int kb = dx * ct + (inp ? a.C0 : 0);  // weight row of tap (0, dx)
            for (int c = 0; c < C; c += SBK) {
              const uint32_t full = full0 + 8 * stage;
              mbar_wait(empty0 + 8 * stage, phase ^ 1);
              mbar_expect_tx(full, SSTAGE_BYTES);
              const uint32_t sa = base + stage * SSTAGE_BYTES;
              // image rows y0-1 .. y0+16 at columns x0+dx-1 .., then tap (dy, dx)'s weights
              tma_load_3d(sa, map, full, c, x0 + dx - 1, y0 - 1);
#pragma unroll
              for (int dy = 0; dy < 3; ++dy)
                tma_load_2d(sa + SA_BYTES + dy * SB_BYTES, &map_w, full, kb + 3 * dy * ct + c, n0);
              if (++stage == SSTAGES) {
                stage = 0;
                phase ^= 1;
              }
            }
          }
        }
      }
    }
  } else {
    // ---- consumers, ping-pong: consumer cw takes the block's tiles k with
    // k % 2 == cw, steps over the other's stages, and runs its MMAs only in
    // its turn, so that one consumer's epilogue runs under the other's MMAs
    setmaxnreg_inc232();
    const int cw = wg - 1;
    const int t = threadIdx.x & 127;
    const int warp = t >> 5, lane = t & 31;
    unsigned char* stg = smem + SSTAGES * SSTAGE_BYTES + cw * STG_BYTES;
    int acc[128];
    int stage = 0;
    uint32_t phase = 0, tph = 0;
    for (int tile = blockIdx.x, k = 0; tile < ntiles; tile += gridDim.x, ++k) {
      if ((k & 1) != cw) {
        const int s2 = stage + nk;
        phase ^= (s2 / SSTAGES) & 1;
        stage = s2 % SSTAGES;
        continue;
      }
      const int n0 = (tile % NT) * 64;
      const int pt = tile / NT;
      const int x0 = (pt % TX) * TILE_X, y0 = (pt / TX) * S_TY;
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0;
      mbar_wait(turn0 + 8 * cw, tph);  // the other consumer's MMAs are done
      tph ^= 1;
      int prev = 0;
      for (int ks = 0; ks < nk; ++ks) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t sa = base + stage * SSTAGE_BYTES;
        fence_acc<128>(acc);
        __syncwarp();  // the .aligned wgmma instructions need the whole warp
        wg_fence();
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          // A = the 64 channels' weights of tap (dy, dx), B = the 256 pixels of
          // box rows dy .. dy + 15 (the tile's rows shifted by the tap)
          const uint64_t dw = sw64_desc(sa + SA_BYTES + dy * SB_BYTES);
          const uint64_t dp = sw64_desc(sa + dy * S_ROW_BYTES);
#pragma unroll
          for (int kk = 0; kk < SBK / 32; ++kk) wgmma_s8(acc, dw + 2 * kk, dp + 2 * kk);
        }
        wg_commit();
        fence_acc<128>(acc);
        wg_wait<1>();  // the previous step's group has retired: its stage is free
        fence_acc<128>(acc);
        if (ks > 0 && t == 0) mbar_arrive(empty0 + 8 * prev);
        prev = stage;
        if (++stage == SSTAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wg_wait<0>();
      fence_acc<128>(acc);
      if (t == 0) {
        mbar_arrive(empty0 + 8 * prev);
        mbar_arrive(turn0 + 8 * (cw ^ 1));  // the other consumer's turn
      }

      // ---- epilogue, per block of 64 pixels (4 image rows), staged in
      // shared memory, then stored, pooled or fed to the head
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int yb = y0 + 4 * b;  // first image row of the block
        named_bar(1 + cw);          // every thread is done reading the staged block
        if (a.out_i8)
          stage_swap_i8(acc, b, a.scale + n0, a.bias + n0, a.relu, stg, warp, lane);
        else
          stage_swap_bf16(acc, b, a.scale + n0, a.bias + n0, a.relu, stg, warp, lane);
        named_bar(1 + cw);
        if (a.out_i8) {
          if (a.out) store_block_i8(stg, (signed char*)a.out, a.H, a.W, a.F, yb, x0, n0, t);
          if (a.pooled)
            pool_block_i8(stg, (signed char*)a.pooled, a.H, a.W, a.F, yb, x0, n0, t);
        } else {
          if (a.out) store_block(stg, (bf16*)a.out, a.H, a.W, a.F, yb, x0, n0, t);
          if (a.pooled) pool_block(stg, (bf16*)a.pooled, a.H, a.W, a.F, yb, x0, n0, t);
        }
        if (a.hout) {
          // F == 64: the block holds every channel. Rows g, g + 8 of the
          // warp's 16 pixels (image row yb + warp), head columns 2q, 2q + 1
          float hc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          head_mma(stg, a.hk8, warp, lane, hc);
          const int g = lane >> 2, q = lane & 3;
          const int y = yb + warp;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = x0 + g + 8 * (e >> 1), o = 2 * q + (e & 1);
            if (o < a.OC && y < a.H && x < a.W)
              a.hout[((size_t)y * a.W + x) * a.OC + o] = __float2bfloat16_rn(hc[e] + a.hb[o]);
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------ host side

// x0, x1: (H, W, C0), (H, W, C1) bf16 (x1 null when C1 = 0); wt: (F, K) int8,
// K = 9*(C0+C1) in (tap, input, channel) order; scale, bias (F,) f32; amax:
// (H*W,) f32 scratch; out (H, W, F) bf16; pooled (H/2, W/2, F) or null. C0,
// C1 multiples of 64, F of 256.
extern "C" int rtnr_conv3x3_dyn_wgmma(const void* x0, const void* x1, int C0, int C1, int H,
                                      int W, const void* wt, const void* scale, const void* bias,
                                      void* amax, void* out, void* pooled, int F, int relu,
                                      void* stream) {
  if (C0 <= 0 || C0 % DBK || C1 < 0 || C1 % DBK || F <= 0 || F % BN || H <= 0 || W <= 0 ||
      (C1 > 0 && !x1) || !x0 || !wt || !amax || !out || (pooled && (H % 2 || W % 2)))
    return (int)cudaErrorInvalidValue;
  EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorInvalidValue;
  CUtensorMap m0, m1, mw;
  const int d0[3] = {C0, W, H}, d1[3] = {C1 ? C1 : C0, W, H}, abox[3] = {DBK, TILE_X, TILE_Y + 2};
  const int dw[2] = {9 * (C0 + C1), F}, wbox[2] = {DBK, BN};
  if (!encode_map(enc, &m0, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 3, x0, d0, abox,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B) ||
      !encode_map(enc, &m1, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 3, C1 ? x1 : x0, d1, abox,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B) ||
      !encode_map(enc, &mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 2, wt, dw, wbox,
                  CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int M = H * W;
  pixel_amax<<<(M + 31) / 32, 256, 0, s>>>((const bf16*)x0, (const bf16*)x1, C0, C1, M,
                                           (float*)amax);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  DynArgs a;
  a.C0 = C0;
  a.C1 = C1;
  a.H = H;
  a.W = W;
  a.F = F;
  a.relu = relu;
  a.amax = (const float*)amax;
  a.scale = (const float*)scale;
  a.bias = (const float*)bias;
  a.out = (bf16*)out;
  a.pooled = (bf16*)pooled;
  static int grid_max = 0;  // resident blocks on the card
  if (grid_max == 0) {
    int err = check_regs(conv3x3_dyn_wgmma);
    if (!err) err = query_grid(conv3x3_dyn_wgmma, NTHREADS, DSMEM, &grid_max);
    if (err) return err;
  }
  const int ntiles = ((W + TILE_X - 1) / TILE_X) * ((H + TILE_Y - 1) / TILE_Y) * (F / BN);
  conv3x3_dyn_wgmma<<<ntiles < grid_max ? ntiles : grid_max, NTHREADS, DSMEM, s>>>(m0, m1, mw, a);
  return (int)cudaGetLastError();
}

// x: (H, W, C) int8 codes; wt: (4F, C) int8, row (dy*2+dx)*F + f the
// flipped kernel's column; scale, bias (F,) f32; out (2H, 2W, F) int8
// codes. C multiple of 64, F of 64.
extern "C" int rtnr_convt2x2_i8_wgmma(const void* x, int C, int H, int W, const void* wt,
                                      const void* scale, const void* bias, void* out, int F,
                                      void* stream) {
  if (C <= 0 || C % 64 || F <= 0 || F % 64 || H <= 0 || W <= 0 || !x || !wt || !out)
    return (int)cudaErrorInvalidValue;
  EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  const int M = H * W;
  const int da[2] = {C, M}, abox[2] = {TBK, TBM}, db[2] = {C, 4 * F}, bbox[2] = {TBK, BN};
  if (!encode_map(enc, &ma, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 2, x, da, abox,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B) ||
      !encode_map(enc, &mb, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 2, wt, db, bbox,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B))
    return (int)cudaErrorInvalidValue;
  ConvTArgs a;
  a.M = M;
  a.C = C;
  a.W = W;
  a.F = F;
  a.scale = (const float*)scale;
  a.bias = (const float*)bias;
  a.out = (signed char*)out;
  static int grid_max = 0;
  if (grid_max == 0) {
    int err = check_regs(convt2x2_i8_wgmma);
    if (!err) err = query_grid(convt2x2_i8_wgmma, NTHREADS, TSMEM, &grid_max);
    if (err) return err;
  }
  const int ntiles = ((M + TBM - 1) / TBM) * (4 * F / BN);
  convt2x2_i8_wgmma<<<ntiles < grid_max ? ntiles : grid_max, NTHREADS, TSMEM,
                      (cudaStream_t)stream>>>(ma, mb, a);
  return (int)cudaGetLastError();
}

// K3 static. x0, x1: (H, W, C0), (H, W, C1) int8 codes (x1 null when C1 =
// 0); wt: (F, K) int8, K = 9*(C0+C1) in (tap, input, channel) order; scale,
// bias (F,) f32. Outputs: out (H, W, F) codes (out_i8) or bf16, or null with
// the head; pooled (H/2, W/2, F) of out's type or null; hout (H, W, OC) bf16
// with hk8 (64, 8: the head kernel zero-padded past OC <= 8), hb (OC,), or
// null. C0, C1 and F multiples of 64; the head takes F = 64.
extern "C" int rtnr_conv3x3_static_wgmma(const void* x0, const void* x1, int C0, int C1, int H,
                                         int W, const void* wt, const void* scale,
                                         const void* bias, void* out, void* pooled, int out_i8,
                                         const void* hk8, const void* hb, int OC, void* hout,
                                         int F, int relu, void* stream) {
  const bool head = hout != nullptr;
  if (C0 <= 0 || C0 % SBK || C1 < 0 || C1 % SBK || F <= 0 || F % 64 || H <= 0 || W <= 0 ||
      !x0 || (C1 > 0 && !x1) || !wt || !scale || !bias ||
      (head && (F != 64 || OC < 1 || OC > 8 || out || pooled || out_i8 || !hk8 || !hb)) ||
      (!head && !out) || (pooled && (H % 2 || W % 2)))
    return (int)cudaErrorInvalidValue;
  EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorInvalidValue;
  CUtensorMap m0, m1, mw;
  const int d0[3] = {C0, W, H}, d1[3] = {C1 ? C1 : C0, W, H}, abox[3] = {SBK, TILE_X, S_TY + 2};
  const int dw[2] = {9 * (C0 + C1), F}, wbox[2] = {SBK, 64};
  if (!encode_map(enc, &m0, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 3, x0, d0, abox,
                  CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B) ||
      !encode_map(enc, &m1, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 3, C1 ? x1 : x0, d1, abox,
                  CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B) ||
      !encode_map(enc, &mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 2, wt, dw, wbox,
                  CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B))
    return (int)cudaErrorInvalidValue;
  StaticArgs a;
  a.C0 = C0;
  a.C1 = C1;
  a.H = H;
  a.W = W;
  a.F = F;
  a.relu = relu;
  a.out_i8 = out_i8;
  a.OC = OC;
  a.scale = (const float*)scale;
  a.bias = (const float*)bias;
  a.out = out;
  a.pooled = pooled;
  a.hk8 = (const bf16*)hk8;
  a.hb = (const float*)hb;
  a.hout = (bf16*)hout;
  static int grid_max = 0;  // resident blocks on the card
  if (grid_max == 0) {
    int err = check_regs(conv3x3_static_wgmma);
    if (!err) err = query_grid(conv3x3_static_wgmma, NTHREADS, SSMEM, &grid_max);
    if (err) return err;
  }
  const int ntiles = ((W + TILE_X - 1) / TILE_X) * ((H + S_TY - 1) / S_TY) * (F / 64);
  conv3x3_static_wgmma<<<ntiles < grid_max ? ntiles : grid_max, NTHREADS, SSMEM,
                         (cudaStream_t)stream>>>(m0, m1, mw, a);
  return (int)cudaGetLastError();
}
