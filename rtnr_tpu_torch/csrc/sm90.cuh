// Hopper building blocks shared by conv_sm90.cu and conv_i8_sm90.cu: mbarrier
// and TMA wrappers, wgmma descriptors and fences, the producer / consumer
// register split, the staged 16-byte epilogue stores and 2x2 pool of an
// 8x16-pixel tile, and the host's tensor-map encoder, register check and
// occupancy query. Each source that includes it builds into its
// own library (_build.SOURCES); nothing here is a kernel.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

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

// one warpgroup (128 threads)
__device__ __forceinline__ void named_bar(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte rows and
// the 128B swizzle: start address >> 4, LBO 1 (unused for this layout), SBO
// 1024 bytes (8 rows), layout type 1 (SWIZZLE_128B). Advancing K by 32 bytes
// (16 bf16 or 32 int8) adds 2 to the start address field.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// the same for 64-byte rows and the 64B swizzle: SBO 512 bytes (8 rows),
// layout type 2 (SWIZZLE_64B); a 32-byte K step also adds 2
__device__ __forceinline__ uint64_t sw64_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(512 >> 4) << 32) |
         ((uint64_t)2 << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// the register split of a 384-thread block whose consumers hold m64n256
// accumulators (128 registers a thread): the producer warpgroup drops to 40,
// the two consumer warpgroups rise to 232
__device__ __forceinline__ void setmaxnreg_dec40() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
}
__device__ __forceinline__ void setmaxnreg_inc232() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
}

// four 8x8 bf16 matrices from shared memory; lane i gives row i % 8 of matrix i / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t saddr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr)
               : "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions
template <int R>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_acc(int* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// ------------------------------------------------------------ staged epilogue of an 8x16 tile

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

// a warpgroup's staged block (64 pixels: 4 image rows x 16 columns, 64
// bf16 channels) to channels nc.. of out (H, W, F), rows yb.., columns
// x0..: 16-byte coalesced stores masked at the ragged edge
__device__ __forceinline__ void store_block(const unsigned char* stg, bf16* out, int H, int W,
                                            int F, int yb, int x0, int nc, int t) {
  for (int idx = t; idx < 64 * 8; idx += 128) {
    const int r = idx >> 3, ch = idx & 7;
    const int y = yb + (r >> 4), x = x0 + (r & 15);
    if (y < H && x < W)
      *reinterpret_cast<uint4*>(out + ((size_t)y * W + x) * F + nc + ch * 8) =
          *reinterpret_cast<const uint4*>(stg + stg_off(r, ch));
  }
}

// the 2x2/2 max-pool of the same staged block (yb, x0 even) into channels
// nc.. of pooled (H/2, W/2, F): 2x8 pooled pixels x 8 chunks, one a thread.
// bf16 rounding is monotone, so this is the max-pool of the output bit for bit
__device__ __forceinline__ void pool_block(const unsigned char* stg, bf16* pooled, int H, int W,
                                           int F, int yb, int x0, int nc, int t) {
  const int hp = H / 2, wp = W / 2;
  const int q = t >> 3, ch = t & 7;
  const int j = q >> 3, i = q & 7;
  const int py = yb / 2 + j, px = x0 / 2 + i;
  if (py < hp && px < wp) {
    const int r = 32 * j + 2 * i;  // staged row of pixel (2j, 2i) of the band
    const uint4 v = bmax8(bmax8(*reinterpret_cast<const uint4*>(stg + stg_off(r, ch)),
                                *reinterpret_cast<const uint4*>(stg + stg_off(r + 1, ch))),
                          bmax8(*reinterpret_cast<const uint4*>(stg + stg_off(r + 16, ch)),
                                *reinterpret_cast<const uint4*>(stg + stg_off(r + 17, ch))));
    *reinterpret_cast<uint4*>(pooled + ((size_t)py * wp + px) * F + nc + ch * 8) = v;
  }
}

// ------------------------------------------------------------ host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry-point query, so
// that the library links no -lcuda
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

// a packed tensor of `rank` (2 or 3) dims, innermost first, elements of
// `esize` bytes; boxes of `box`, swizzled; coordinates outside read zeros
static bool encode_map(EncodeTiled enc, CUtensorMap* m, CUtensorMapDataType type, int esize,
                       int rank, const void* base, const int* dims, const int* box,
                       CUtensorMapSwizzle swizzle, CUtensorMapL2promotion l2) {
  cuuint64_t d[3], strides[2];
  cuuint32_t b[3], es[3] = {1, 1, 1};
  cuuint64_t stride = (cuuint64_t)esize;
  for (int i = 0; i < rank; ++i) {
    d[i] = (cuuint64_t)dims[i];
    b[i] = (cuuint32_t)box[i];
    if (i > 0) strides[i - 1] = stride;
    stride *= d[i];
  }
  return enc(m, type, (cuuint32_t)rank, const_cast<void*>(base), d, strides, b, es,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, l2, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// setmaxnreg.inc blocks until the block's pool holds the registers it asks
// for: a launch of 384 threads must give each the 168 that 40 for the
// producer and 232 for the consumers add up to, or the consumers would wait
// for ever. Refuse the launch instead.
template <typename Kern>
static int check_regs(Kern kernel) {
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return (int)e;
  return fa.numRegs * 384 >= 128 * 40 + 256 * 232 ? 0 : (int)cudaErrorInvalidConfiguration;
}

// resident blocks of `kernel` on the card (SMs x blocks an SM, from the
// occupancy query) into *grid, after allowing it `smem` bytes
template <typename Kern>
static int query_grid(Kern kernel, int threads, int smem, int* grid) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, nsm = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *grid = nsm * per_sm;
  return 0;
}
