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
// Every entry returns a cudaError_t (0 on success): cudaErrorInvalidValue
// for shapes it does not take or a tensor map that does not encode, else
// cudaGetLastError() after the launch.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

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

// ------------------------------------------------------------ PTX wrappers

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n .reg .b64 state;\n mbarrier.arrive.shared::cta.b64 state, [%0];\n}" ::"r"(bar)
      : "memory");
}

// returns once the phase of parity `parity` of the barrier has completed; a
// pipeline that is stuck (no legitimate wait lasts a second) traps, so the
// launch fails with an error instead of holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, spins = 0;
  do {
    if (++spins == (1u << 26)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void named_bar(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte rows and
// the 128B swizzle: start address >> 4, LBO 1 (unused for this layout), SBO
// 1024 bytes (8 rows), layout type 1 (SWIZZLE_128B). Advancing K by 16
// elements (32 bytes) adds 2 to the start address field.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions
template <int R>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

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

// byte offset of 16-byte chunk `ch` (0..7) of staged row `r` (rows of 64 bf16)
__device__ __forceinline__ int stg_off(int r, int ch) { return r * 128 + ((ch ^ (r & 7)) << 4); }

__device__ __forceinline__ uint32_t bmax2(uint32_t a, uint32_t b) {
  // exact: each lane of the result is one of the bf16 inputs
  const __nv_bfloat162 m = __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&m);
}

__device__ __forceinline__ uint4 bmax8(uint4 a, uint4 b) {
  return make_uint4(bmax2(a.x, b.x), bmax2(a.y, b.y), bmax2(a.z, b.z), bmax2(a.w, b.w));
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
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int col = 8 * i + 2 * (lane & 3);
          const float b0 = a.bias[nc + col], b1 = a.bias[nc + col + 1];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = warp * 16 + (lane >> 2) + 8 * h;
            float v0 = acc[32 * nb + 4 * i + 2 * h] + b0;
            float v1 = acc[32 * nb + 4 * i + 2 * h + 1] + b1;
            if (a.relu) {
              v0 = fmaxf(v0, 0.0f);
              v1 = fmaxf(v1, 0.0f);
            }
            *reinterpret_cast<__nv_bfloat162*>(stg + stg_off(r, i) + 4 * (lane & 3)) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
        named_bar(1 + cw);
        if (a.out) {
          for (int idx = t; idx < 64 * 8; idx += 128) {
            const int r = idx >> 3, ch = idx & 7;
            const int y = yb + (r >> 4), x = x0 + (r & 15);
            if (y < a.H && x < a.W)
              *reinterpret_cast<uint4*>(a.out + ((size_t)y * a.W + x) * a.F + nc + ch * 8) =
                  *reinterpret_cast<const uint4*>(stg + stg_off(r, ch));
          }
        }
        if (a.pooled) {
          const int hp = a.H / 2, wp = a.W / 2;
          {
            const int q = t >> 3, ch = t & 7;  // 16 pooled pixels x 8 chunks
            const int j = q >> 3, i = q & 7;
            const int py = yb / 2 + j, px = x0 / 2 + i;
            if (py < hp && px < wp) {
              const int r = 32 * j + 2 * i;  // staged row of pixel (2j, 2i) of the band
              const uint4 v = bmax8(bmax8(*reinterpret_cast<const uint4*>(stg + stg_off(r, ch)),
                                          *reinterpret_cast<const uint4*>(stg + stg_off(r + 1, ch))),
                                    bmax8(*reinterpret_cast<const uint4*>(stg + stg_off(r + 16, ch)),
                                          *reinterpret_cast<const uint4*>(stg + stg_off(r + 17, ch))));
              *reinterpret_cast<uint4*>(a.pooled + ((size_t)py * wp + px) * a.F + nc + ch * 8) = v;
            }
          }
        }
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

// ------------------------------------------------------------ host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn) return fn;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                   cudaEnableDefault, &q);
#else
  cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
  if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
  fn = reinterpret_cast<EncodeTiled>(p);
  return fn;
}

// (H, W, C) bf16 activation, box (64 c, 16 x, 10 y): a tile's rows and their halo
static bool encode_act(EncodeTiled enc, CUtensorMap* m, const void* x, int C, int H, int W) {
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2};
  const cuuint32_t box[3] = {BK, TILE_X, TILE_Y + 2};
  const cuuint32_t es[3] = {1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims, strides, box, es,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// (F, K) K-major bf16 weights, box (64 k, BN n)
static bool encode_w(EncodeTiled enc, CUtensorMap* m, const void* wt, int K, int F, int BN) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)F};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {BK, (cuuint32_t)BN};
  const cuuint32_t es[2] = {1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(wt), dims, strides, box, es,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
static int launch(const CUtensorMap& m0, const CUtensorMap& m1, const CUtensorMap& mw,
                  const Sm90Args& a, cudaStream_t s) {
  constexpr int smem = Layout<BN>::SMEM;
  static int grid_max = 0;  // resident blocks on the card, from the occupancy query
  if (grid_max == 0) {
    cudaError_t e = cudaFuncSetAttribute(conv3x3_wgmma<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    int dev = 0, nsm = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv3x3_wgmma<BN>, NTHREADS,
                                                           smem)) != cudaSuccess)
      return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    grid_max = nsm * per_sm;
  }
  const int ntiles = ((a.W + TILE_X - 1) / TILE_X) * ((a.H + TILE_Y - 1) / TILE_Y) * (a.F / BN);
  if (ntiles == 0) return (int)cudaGetLastError();
  conv3x3_wgmma<BN><<<ntiles < grid_max ? ntiles : grid_max, NTHREADS, smem, s>>>(m0, m1, mw, a);
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
