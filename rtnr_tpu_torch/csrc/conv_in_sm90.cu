// The U-Net's input conv for Hopper: a 3x3 conv of 1..8 bf16 channels to 64,
// bias and ReLU, writing bf16 or int8 codes.
//
// Replaces rtnr_tpu/ops/conv_phase.py::_conv_phase_kernel (wrapper
// conv3x3_phase, pallas_call at :1018) in its exact mode at the net's first
// layer, down0/conv0: 5 stored channels of the rendered frame (rgb, depth,
// mask) padded to 8 by to_phase (:46-57) against zero weight rows
// (:842-845), f32 sums of bf16 products, bias and ReLU in f32, then one bf16
// rounding; or, in the static net (rtnr_tpu/models/unet.py:622-630), the
// codes clip(rint(y), 0 or -127, 127) at out_scale, 1/out_scale being
// folded into the bf16 weights and bias (:851-856; prepare_conv3x3 does the
// same). conv.cu's gemm<0,0> ran this conv before at ~10% of HBM rate: with
// C = 5 its A loader gathers 2-byte scalars through integer divisions, its
// K loop (two steps) overlaps nothing, and its epilogue stores one element
// a thread at a time.
//
// Bound on this card: bytes. At 1088x1920 (M pixels) the conv reads 2*M*C
// bytes and writes 2*M*64 (bf16 out: 288 MB, 0.086 ms at 3.35 TB/s) or
// M*64 (int8 out: 155 MB, 0.046 ms); its 12 GFLOP (K = 45 of 48 columns)
// are ~42 FLOP a byte, far below the ~295 at which the tensor cores would
// bound it. What bounds the kernel in practice is the instructions it
// issues per output byte (timed on the card with parts switched off, the
// halo loads, the A gather and MMAs, and the epilogue with its stores took
// their sum, not their maximum), so the design spends as few instructions
// a tile as it can:
//
// - Tiles of TP = 128 pixels along one image row (15 a row at W = 1920; the
//   last tile of a row is ragged where W % TP != 0), walked by a persistent
//   grid (blocks resident on every SM, from the occupancy query) in row
//   order, so the three blocks that read one input row run close in time
//   and find it in L2. A block steps its tile coordinates without dividing.
// - The tile's input halo, 3 rows x (TP + 2) pixels x C bf16 (3.9 KB at
//   C = 5), is copied into shared memory one tile ahead (double-buffered)
//   with 16-byte cp.async, which costs one instruction a chunk. A C-channel
//   pixel is 2C bytes, so a row segment seldom starts on a 16-byte
//   boundary: each row copies the 16-byte-aligned span that covers it, and
//   its reads start `lead` bytes in. Rows outside the image and bytes
//   outside the tensor are zero-filled by cp.async's source size.
// - A, in registers (wgmma's RS form), gathered from the halo: row = pixel,
//   column k = (tap, channel) in wmat's order, k = tap*C + c. The four k a
//   lane holds in a k16 step are fixed by its lane, so their byte offsets
//   are a table made once: an element costs one 2-byte shared load on a
//   tile inside the image whose three rows share one lead (every tile but
//   the two edge tiles of a row at W = 1920, where W*C % 8 == 0). Other
//   tiles take each row's lead and zero the halo columns outside the image
//   (which hold the neighbouring rows' pixels). k = 9C reads a region of
//   bf16 ones and k > 9C one of zeros.
// - B, the weights, in shared memory once per block as wgmma's K-major,
//   128B-swizzled operand (rows of 64 k), with the bias, whose values are
//   bf16, as row 9C: the bias enters the f32 sums exactly (1.0 x bias) and
//   the epilogue adds nothing. The columns are permuted (out_channel) so
//   that a lane's accumulators are 16 consecutive channels (int8) or two
//   runs of 8 (bf16) of its pixels.
// - The products: wgmma m64n64k16, A from registers, one warpgroup per 64
//   pixels, KS = 3 k16 steps at C = 5, the first with no accumulator
//   input. At 42 FLOP a byte the tensor cores are idle most of the time;
//   wgmma keeps B out of the registers and out of the load path, where
//   mma.sync needed it loaded per tile.
// - Epilogue in registers: ReLU as one fmaxf, one bf16 rounding; for int8
//   out the clip in f32 and the rounding by adding 1.5 * 2^23, whose low
//   byte is then the code (round half to even, as rintf, on the FP32 pipe
//   instead of the slower conversion unit). Each lane stores its pixels'
//   channels straight from registers, 16 bytes at a time: int8, a warp's
//   store covers 8 whole pixels (512 contiguous bytes); bf16, a half of
//   each of 8 pixels (whole 32-byte sectors). Masked past the image's edge.
// - Determinism: no atomics, no split-K; a call gives the same bits every
//   time.
//
// Every entry returns cudaGetLastError().

#include "sm90.cuh"

#define TP 128                 // pixels of a tile, along one image row
#define NWARPS (TP / 16)       // 16 pixels a warp
#define NTHREADS (NWARPS * 32)
#define NF 64                  // output channels

template <int C>
struct Geo {
  static constexpr int K = 9 * C;           // k = 9C is the bias row (below)
  static constexpr int KS = (K + 16) / 16;  // k16 steps over k <= 9C
  static constexpr int KP = (KS + 3) / 4;   // B panels of 64 k (128-byte rows, 64 rows of n)
  static constexpr int L = (TP + 2) * C;    // elements of a halo row
  // 16-byte chunks that cover a halo row at any lead (0..7 elements)
  static constexpr int NCH = (L + 14) / 8;
  static constexpr int ROWB = NCH * 16;      // bytes of a halo row in shared memory
  static constexpr int ZB = 16 * C + 32;     // bytes of a constant region (reads reach 14 + 16C + 2)
  static constexpr int ZOFF = 3 * ROWB;      // zeros: A at k > 9C
  static constexpr int OOFF = ZOFF + ZB;     // bf16 ones: A at k = 9C
  static constexpr int BUF = OOFF + ZB;      // bytes of one halo buffer
};

// the output channel of GEMM column n = 8nb + 2t + e (the accumulator a lane
// t holds): for int8 out 16t + 2nb + e, so a lane holds 16 consecutive
// channels of its pixels (one 16-byte store a pixel); for bf16 out 8t + 2nb
// + e below nb = 4 and 32 + 8t + 2(nb - 4) + e from it (two 16-byte stores,
// each with its neighbours a contiguous half of the pixel's 128 bytes)
template <bool I8>
__device__ __forceinline__ int out_channel(int n) {
  const int nb = n >> 3, t = (n >> 1) & 3, e = n & 1;
  if (I8) return 16 * t + 2 * nb + e;
  return (nb < 4 ? 8 * t + 2 * nb : 32 + 8 * t + 2 * (nb - 4)) + e;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// order this thread's generic shared-memory writes before the async proxy's
// reads (wgmma's B operand); a barrier follows
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// d (64x64 f32, the warpgroup's accumulators) = a (64x16 bf16 from
// registers, 16 rows a warp) x b (16x64 bf16 in shared memory, descriptor
// db), plus d where acc is non-zero
__device__ __forceinline__ void wgmma_rs64(float* d, const uint32_t* a, uint64_t db, int acc) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// the halo of the tile at (y, x0) into buf: row r (image row y + r - 1) as
// NCH 16-byte chunks from the 16-byte boundary at or before its first
// element (index (yy*W + x0 - 1)*C, negative before the tensor); zeros for
// rows outside the image and bytes outside the tensor (total elements)
template <int C>
__device__ __forceinline__ void load_halo(uint32_t buf, const bf16* __restrict__ x, int H, int W,
                                          int total, int y, int x0, int tid) {
  typedef Geo<C> G;
  for (int i = tid; i < 3 * G::NCH; i += NTHREADS) {
    const int r = i / G::NCH, j = i - r * G::NCH;
    const int yy = y + r - 1;
    const int e = (((yy * W + x0 - 1) * C) & ~7) + 8 * j;
    const bool in = yy >= 0 && yy < H && e >= 0 && e < total;
    cp_async16(buf + r * G::ROWB + j * 16, in ? x + e : x, in ? min(16, 2 * (total - e)) : 0);
  }
}

// this lane's A fragments of the tile from the halo buffer hb: the element
// of k = 16kk + 2t + 8pair + e at byte offset off[4kk + 2pair + e] (past the
// rows' lead) for fragment row g, 16C bytes on for row g + 8. FAST (an
// interior tile whose three rows share one lead l0, in bytes): one 2-byte
// load. Else each row's own lead and zeros for the halo columns outside the
// image (vm0 / vm1, bit dx: column p + dx inside it, for the lane's pixel p
// of row g / g + 8); (dy, dx) are recomputed from k
template <int C, bool FAST>
__device__ __forceinline__ void build_a(uint32_t (&a)[Geo<C>::KS][4], const unsigned char* hb,
                                        const int (&off)[Geo<C>::KS * 4], int t, int l0, int l1,
                                        int l2, int vm0, int vm1) {
#pragma unroll
  for (int kk = 0; kk < Geo<C>::KS; ++kk)
#pragma unroll
    for (int pair = 0; pair < 2; ++pair)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = off[kk * 4 + pair * 2 + e] + h * 16 * C;
          if (FAST) {
            v[e] = *reinterpret_cast<const unsigned short*>(hb + l0 + o);
          } else {
            const int k = kk * 16 + 2 * t + 8 * pair + e;
            const int tap = k / C, dy = tap / 3, dx = tap - 3 * dy;
            const int lb = k >= Geo<C>::K || dy == 0 ? l0 : (dy == 1 ? l1 : l2);
            v[e] = k >= Geo<C>::K || ((h ? vm1 : vm0) >> dx) & 1
                       ? *reinterpret_cast<const unsigned short*>(hb + lb + o)
                       : 0u;
          }
        }
        // (row g, k 2t..), (row g+8, k 2t..), (row g, k 2t+8..), (row g+8, k 2t+8..)
        a[kk][pair * 2 + h] = v[0] | (v[1] << 16);
      }
}

template <int C, bool I8>
__global__ void __launch_bounds__(NTHREADS, 2)
    conv3x3_in(const bf16* __restrict__ x, int H, int W, const bf16* __restrict__ wmat, int Kp,
               const float* __restrict__ bias, void* __restrict__ out, int relu) {
  typedef Geo<C> G;
  constexpr int KS = G::KS;
  __shared__ __align__(1024) unsigned char bsm[G::KP * NF * 128];
  __shared__ __align__(16) unsigned char halo[2 * G::BUF];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ntx = (W + TP - 1) / TP;
  const int ntiles = H * ntx;
  const int total = H * W * C;
  const uint32_t hbase = (uint32_t)__cvta_generic_to_shared(halo);
  // tiles run in row order, tile = y * ntx + x / TP; a block walks them
  // gridDim.x at a time, (gy, gx) rows and tiles on
  const int gy = gridDim.x / ntx, gx = gridDim.x - gy * ntx;
  int tile = blockIdx.x;
  int y = tile / ntx, xt = tile - y * ntx;
  if (tile < ntiles) load_halo<C>(hbase, x, H, W, total, y, xt * TP, tid);
  cp_async_commit();
  // the constant regions of both buffers, which no copy writes
  for (int i = tid; i < 2 * 2 * G::ZB / 4; i += NTHREADS) {
    const int b = i / (2 * G::ZB / 4), w = i - b * (2 * G::ZB / 4);
    *reinterpret_cast<uint32_t*>(halo + b * G::BUF + G::ZOFF + 4 * w) =
        w < G::ZB / 4 ? 0u : 0x3F803F80u;
  }
  // B, the K-major weights in GEMM column order: panel k / 64, row n (output
  // channel out_channel(n)), k % 64 at 16-byte chunk (k % 64) / 8
  // XOR-swizzled by n % 8 (wgmma's 128B swizzle); row 9C the bias (bf16
  // values), zero past it
  const unsigned short* wb = reinterpret_cast<const unsigned short*>(wmat);
  for (int i = tid; i < G::KP * NF * 64; i += NTHREADS) {
    const int k = i / NF, n = i % NF;
    const int kq = k & 63;
    const int ch = out_channel<I8>(n);
    unsigned short v = 0;
    if (k < G::K && k < Kp) v = wb[k * NF + ch];
    if (k == G::K) v = __bfloat16_as_ushort(__float2bfloat16_rn(bias[ch]));
    *reinterpret_cast<unsigned short*>(bsm + (k >> 6) * NF * 128 + n * 128 +
                                       (((kq >> 3) ^ (n & 7)) << 4) + (kq & 7) * 2) = v;
  }
  fence_proxy_async();

  // this lane's A elements: tap (dy, dx) and channel c of k at row dy, halo
  // position (p0 + dx)*C + c, p0 = its pixel of fragment row g; k = 9C the
  // ones, k > 9C the zeros
  const int p0 = warp * 16 + g;
  int off[KS * 4];
#pragma unroll
  for (int s = 0; s < KS * 4; ++s) {
    const int k = (s >> 2) * 16 + 2 * t + ((s >> 1) & 1) * 8 + (s & 1);
    const int tap = k / C, c = k - tap * C;
    const int dy = tap / 3, dx = tap - dy * 3;
    off[s] = k < G::K ? dy * G::ROWB + ((p0 + dx) * C + c) * 2 : (k == G::K ? G::OOFF : G::ZOFF);
  }
  const uint32_t bbase = (uint32_t)__cvta_generic_to_shared(bsm);
  // the lower clip: ReLU, or -127 for int8 codes, or none for bf16 (a NaN:
  // fmaxf returns the other operand, NaN or not)
  const float lo = relu ? 0.0f : (I8 ? -127.0f : __int_as_float(0x7fffffff));

  for (int it = 0; tile < ntiles; ++it) {
    const int x0 = xt * TP;
    cp_async_wait_all();
    __syncthreads();  // this tile's halo landed; every warp is done with the other buffer
    const int ny = y + gy + (xt + gx >= ntx), nxt = xt + gx - (xt + gx >= ntx ? ntx : 0);
    if (tile + gridDim.x < ntiles)
      load_halo<C>(hbase + ((it + 1) & 1) * G::BUF, x, H, W, total, ny, nxt * TP, tid);
    cp_async_commit();

    int l[3];  // each row's lead in bytes
#pragma unroll
    for (int r = 0; r < 3; ++r) l[r] = (((y + r - 1) * W + x0 - 1) * C & 7) * 2;
    const unsigned char* hb = halo + (it & 1) * G::BUF;
    uint32_t a[KS][4];
    if (x0 >= 1 && x0 + TP < W && l[0] == l[1] && l[1] == l[2]) {
      build_a<C, true>(a, hb, off, t, l[0], 0, 0, 0, 0);
    } else {
      int vm[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        vm[h] = 0;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int xx = x0 - 1 + p0 + 8 * h + dx;
          vm[h] |= (xx >= 0 && xx < W) << dx;
        }
      }
      build_a<C, false>(a, hb, off, t, l[0], l[1], l[2], vm[0], vm[1]);
    }
    // the warpgroup's 64 pixels x 64 GEMM columns, bias included: KS wgmma,
    // A from registers
    float acc[32];
    fence_acc<32>(acc);
    __syncwarp();
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs64(acc, a[kk], sw128_desc(bbase + (kk >> 2) * NF * 128) + 2 * (kk & 3), kk);
    wg_commit();
    fence_acc<32>(acc);
    wg_wait<0>();
    fence_acc<32>(acc);

    // epilogue: fragment rows g and g + 8 (pixels p0, p0 + 8), GEMM columns
    // 8nb + 2t, +1 (channels out_channel), straight from registers to memory
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (x0 + p0 + 8 * h >= W) continue;
      const size_t pix = (size_t)y * W + x0 + p0 + 8 * h;
      uint32_t w[8];  // int8: the codes of channel pairs; bf16: 8 bf16x2 words
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const float v0 = fmaxf(acc[nb * 4 + 2 * h], lo);
        const float v1 = fmaxf(acc[nb * 4 + 2 * h + 1], lo);
        if constexpr (I8) {
          // clip, then round half to even by adding 1.5 * 2^23: the sum's low
          // byte is the code (rint and clip commute at integer bounds)
          const uint32_t q0 = __float_as_uint(__fadd_rn(fminf(v0, 127.0f), 12582912.0f));
          const uint32_t q1 = __float_as_uint(__fadd_rn(fminf(v1, 127.0f), 12582912.0f));
          w[nb] = __byte_perm(q0, q1, 0x0040);  // codes of channels 16t + 2nb, +1
        } else {
          const __nv_bfloat162 p = __floats2bfloat162_rn(v0, v1);
          w[nb] = *reinterpret_cast<const uint32_t*>(&p);
        }
      }
      if constexpr (I8) {
        *reinterpret_cast<uint4*>(static_cast<signed char*>(out) + pix * NF + 16 * t) =
            make_uint4(__byte_perm(w[0], w[1], 0x5410), __byte_perm(w[2], w[3], 0x5410),
                       __byte_perm(w[4], w[5], 0x5410), __byte_perm(w[6], w[7], 0x5410));
      } else {
        bf16* o = static_cast<bf16*>(out) + pix * NF + 8 * t;
        *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
        *reinterpret_cast<uint4*>(o + 32) = make_uint4(w[4], w[5], w[6], w[7]);
      }
    }
    tile += gridDim.x;
    y = ny;
    xt = nxt;
  }
  cp_async_wait_all();
}

template <int C, bool I8>
static int launch(const void* x, int H, int W, const void* wmat, int Kp, const void* bias,
                  void* out, int relu, cudaStream_t s) {
  static int grid = 0;  // resident blocks on the card
  if (grid == 0) {
    const int e = query_grid(conv3x3_in<C, I8>, NTHREADS, 0, &grid);
    if (e) return e;
  }
  const int ntiles = H * ((W + TP - 1) / TP);
  conv3x3_in<C, I8><<<ntiles < grid ? ntiles : grid, NTHREADS, 0, s>>>(
      (const bf16*)x, H, W, (const bf16*)wmat, Kp, (const float*)bias, out, relu);
  return (int)cudaGetLastError();
}

#define RTNR_IN_CASE(c)                                                           \
  case c:                                                                         \
    return out_i8 ? launch<c, true>(x, H, W, wmat, Kp, bias, out, relu, s)        \
                  : launch<c, false>(x, H, W, wmat, Kp, bias, out, relu, s);

// x (H, W, C) bf16 NHWC, 16-byte aligned, 1 <= C <= 8; wmat (Kp, 64) bf16
// row-major, row tap*C + c (rows 9C.. are not read); bias (64,) f32 holding
// bf16 values (B's row 9C); out (H, W, 64) bf16, or int8 codes with out_i8
extern "C" int rtnr_conv3x3_in(const void* x, int C, int H, int W, const void* wmat, int Kp,
                               const void* bias, void* out, int out_i8, int relu, void* stream) {
  if (H <= 0 || W <= 0) return (int)cudaGetLastError();
  // element indices, the halo rows above and below the image included, are 32-bit
  if ((long long)(H + 2) * W * C >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    RTNR_IN_CASE(1)
    RTNR_IN_CASE(2)
    RTNR_IN_CASE(3)
    RTNR_IN_CASE(4)
    RTNR_IN_CASE(5)
    RTNR_IN_CASE(6)
    RTNR_IN_CASE(7)
    RTNR_IN_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
}
