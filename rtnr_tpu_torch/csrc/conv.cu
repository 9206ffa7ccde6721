// U-Net convolutions for Hopper: 3x3 conv (K3) and 2x2/s2 transposed conv (K4),
// in bf16 and in the int8 modes of the JAX package's phase kernels.
//
// K3 replaces rtnr_tpu/ops/conv_phase.py::_conv_phase_kernel (wrapper
// conv3x3_phase): a 3x3 stride-1 same conv over the virtual channel concat of
// one or two NHWC inputs, plus bias and ReLU. It runs as an implicit GEMM:
// M = output pixels, N = F, K = 9*(C0+C1) ordered (tap, channel), the flax
// HWIO kernel reshaped to (K, F). Each A row is gathered on the fly from the
// two input pointers (no im2col and no torch.cat in memory); out of image taps
// read zero. The fused 2x2 max-pool side output and the fused 1x1 head of the
// TPU kernel are two small kernels here (rtnr_maxpool2, rtnr_head1x1) that the
// same wrapper launches after the GEMM.
//
// K4 replaces rtnr_tpu/ops/conv_phase.py::_convt_phase_kernel (wrapper
// convt2x2_phase): a GEMM with M = input pixels, N = 4F, K = C; column
// (dy*2+dx)*F + f holds kernel[1-dy, 1-dx, :, f] (flax's spatially flipped
// ConvTranspose), and the epilogue adds the bias and scatters each column to
// output pixel (2y+dy, 2x+dx).
//
// Precision modes, the template parameter AK (the kind of the A operand):
// - AK 0, bf16: bf16 inputs and weights, f32 accumulation; the epilogue adds
//   the bias, applies ReLU and writes bf16, or with out_i8 the int8 codes
//   clip(rint(y), 0 or -127, 127) (the wrapper multiplies the kernel and bias
//   by 1/out_scale before rounding them to bf16, conv_phase.py:851-855).
//   The full-width net runs none of this file's K3 and K4 kernels: its input
//   conv (bf16 or int8 out) runs conv_in_sm90.cu, its other convs
//   conv_sm90.cu and conv_i8_sm90.cu. This GEMM serves narrow nets and the
//   shapes no other route takes.
// - AK 1, static int8: int8 inputs, per-output-channel int8 weights, i32
//   accumulation; y = f32(acc) * scale[f] + bias[f], where the wrapper folds
//   weight scale x input scale x 1/out_scale into scale and 1/out_scale into
//   the bf16 bias (conv_phase.py:913-936); ReLU; int8 codes, or bf16 for the
//   last conv, which feeds the head. K4 static takes the same path (no ReLU,
//   codes clipped to [-127, 127]). A second input's scale ratio is folded
//   into its weight slice before the weights are quantised (:864-868), so the
//   whole contraction runs at input 0's scale.
// - AK 2, dyn int8: bf16 inputs quantised to int8 by the A loader, i32
//   accumulation, y = f32(acc) * (scale[f] * s[m]) + bias[f], ReLU, bf16 out.
//   The quantisation group differs from the TPU's by design: the TPU kernel
//   takes one scale per lane over a window of TR+2 rows (conv_phase.py:
//   323-337), a grouping that comes from its row tiling (_pick_tr_fb) and that
//   no user sees. Here the group is the output pixel's own 3x3 receptive
//   field over all channels of both inputs: a pre-pass kernel (dyn_scales)
//   writes 127/amax and amax*f32(1/127) per output pixel, the A loader
//   quantises each gathered row with its own pixel's factor, so the i32 sum of
//   a row carries one scale and one dequantisation per output element is exact.
//
// Rounding. Every float multiply and add of the int8 epilogues and of the
// quantiser is written with __fmul_rn / __fadd_rn (and the division with
// __fdiv_rn), which nvcc never contracts into an FMA, so these kernels round
// exactly as their plain torch twins do (the library builds without
// -fmad=false). i32 -> f32 is __int2float_rn, round to nearest even like
// torch's .to(float32): past 2^24 (|acc| reaches 127^2 x 9216 at K = 9216)
// the conversion rounds. rintf rounds half to even, as torch.round and
// jnp.rint do.
//
// Bound on this card: operations. The full-width net at 1088x1920 is about
// 2.94 TFLOP of 3x3 conv and 0.14 TFLOP of ConvT a frame, ~3.1 ms at the
// H100 SXM's 989 TFLOP/s dense bf16 and half that at its 1,979 TOP/s int8;
// the largest activation (1088x1920x64 bf16) is 267 MB, ~0.08 ms of memory
// time. Design, right and simple first: 128x64 block tiles, K steps of 64
// bytes (32 bf16 or 64 int8), 8 warps of 32x32 on nvcuda::wmma 16x16x16
// fragments (mma.sync; bf16 with f32 or s8 with s32 accumulators), global
// loads of the next K step held in registers while the tensor cores work on
// the current one. int8 tiles sit in shared memory as 16-byte column chunks
// (each fragment 32-byte aligned, as wmma requires). It reaches a fraction
// of the wgmma/TMA peak; those come in a later change.
//
// Every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;
typedef signed char i8;

#define BM 128
#define BN 64
#define NTHREADS 256
#define LDC (BN + 4)

// element type, accumulator and K step of each A kind: a K step is 64 bytes
// of an A row, four 16-byte chunks
template <int AK> struct Kind;
template <> struct Kind<0> { typedef bf16 T; typedef float Acc; enum { BK = 32 }; };
template <> struct Kind<1> { typedef i8 T; typedef int Acc; enum { BK = 64 }; };
template <> struct Kind<2> { typedef i8 T; typedef int Acc; enum { BK = 64 }; };

// bf16 tiles are row-major with padded rows
#define LDA (32 + 8)
#define LDB (BN + 8)

struct GemmArgs {
  const void* x0;
  const void* x1;
  int C0, C1;  // channels of the inputs (C1 = 0: one input)
  int H, W;    // input spatial size (K3: also the output size)
  const void* wmat;     // (Kp, N) row-major, bf16 (AK 0) or int8; rows K..Kp-1 zero
  const float* bias;    // (F,) f32 values of the bf16 bias
  const float* scale;   // (F,) f32 dequantisation scale (AK 1, 2)
  const float* rinv;    // AK 2: (M,) 127/amax per output pixel (0 where amax = 0)
  const float* rscale;  // AK 2: (M,) amax * f32(1/127) per output pixel
  void* out;
  int M, N, K, Kp, F, relu, out_i8;
  int vecA, vecB;  // 16-byte loads legal (channel counts / N multiples of a chunk)
};

__device__ __forceinline__ bf16 bzero() { return __ushort_as_bfloat16((unsigned short)0); }

// address of element (m, k) of A -- MODE 0: the tap-major 3x3 gather over the
// two inputs; MODE 1: row m of the one input -- or null where A is zero
// (k >= K, or a tap out of the image)
template <int MODE, typename In>
__device__ __forceinline__ const In* a_ptr(const GemmArgs& a, int m, int k) {
  if (k >= a.K) return nullptr;
  const In* x0 = static_cast<const In*>(a.x0);
  if (MODE == 1) return x0 + (size_t)m * a.C0 + k;
  const int ct = a.C0 + a.C1;
  const int tap = k / ct;
  const int c = k - tap * ct;
  const int y = m / a.W;
  const int x = m - y * a.W;
  const int yy = y + tap / 3 - 1;
  const int xx = x + tap % 3 - 1;
  if (yy < 0 || yy >= a.H || xx < 0 || xx >= a.W) return nullptr;
  const size_t pixel = (size_t)yy * a.W + xx;
  return c < a.C0 ? x0 + pixel * a.C0 + c
                  : static_cast<const In*>(a.x1) + pixel * a.C1 + (c - a.C0);
}

// dyn quantiser: clip(rint(v * inv), -127, 127)
__device__ __forceinline__ i8 quant8(float v, float inv) {
  const float q = fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.0f), 127.0f);
  return (i8)(int)q;
}

// one 16-byte chunk of A row m from K index k: 8 bf16 (AK 0) or 16 int8
template <int MODE, int AK>
__device__ __forceinline__ uint4 fetch_a(const GemmArgs& a, int m, int k) {
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  if (m >= a.M) return z;
  if constexpr (AK == 0) {
    if (a.vecA) {
      const bf16* p = a_ptr<MODE, bf16>(a, m, k);
      return p ? *reinterpret_cast<const uint4*>(p) : z;
    }
    __align__(16) bf16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const bf16* p = a_ptr<MODE, bf16>(a, m, k + e);
      v[e] = p ? *p : bzero();
    }
    return *reinterpret_cast<const uint4*>(v);
  } else if constexpr (AK == 1) {
    if (a.vecA) {
      const i8* p = a_ptr<MODE, i8>(a, m, k);
      return p ? *reinterpret_cast<const uint4*>(p) : z;
    }
    __align__(16) i8 v[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const i8* p = a_ptr<MODE, i8>(a, m, k + e);
      v[e] = p ? *p : (i8)0;
    }
    return *reinterpret_cast<const uint4*>(v);
  } else {
    const float inv = a.rinv[m];
    __align__(16) i8 v[16];
    if (a.vecA) {
      const bf16* p = a_ptr<MODE, bf16>(a, m, k);
      if (!p) return z;
      __align__(16) bf16 h[16];
      *reinterpret_cast<uint4*>(h) = *reinterpret_cast<const uint4*>(p);
      *reinterpret_cast<uint4*>(h + 8) = *reinterpret_cast<const uint4*>(p + 8);
#pragma unroll
      for (int e = 0; e < 16; ++e) v[e] = quant8(__bfloat162float(h[e]), inv);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const bf16* p = a_ptr<MODE, bf16>(a, m, k + e);
        v[e] = p ? quant8(__bfloat162float(*p), inv) : (i8)0;
      }
    }
    return *reinterpret_cast<const uint4*>(v);
  }
}

// one 16-byte chunk of weight row k (k < Kp always) from column n
template <int AK>
__device__ __forceinline__ uint4 fetch_b(const GemmArgs& a, int k, int n) {
  typedef typename Kind<AK>::T T;
  constexpr int E = 16 / sizeof(T);
  const T* row = static_cast<const T*>(a.wmat) + (size_t)k * a.N;
  if (a.vecB && n + E <= a.N) return *reinterpret_cast<const uint4*>(row + n);
  __align__(16) T v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if constexpr (AK == 0) v[e] = n + e < a.N ? row[n + e] : bzero();
    else v[e] = n + e < a.N ? row[n + e] : (T)0;
  }
  return *reinterpret_cast<const uint4*>(v);
}

// bf16: at most 80 registers, so that 3 blocks share an SM (uncapped, this
// template takes 93 and fits 2, which measured ~9% slower for K3 bf16)
template <int MODE, int AK>
__global__ void __launch_bounds__(NTHREADS, AK == 0 ? 3 : 2) gemm(GemmArgs a) {
  typedef typename Kind<AK>::T T;
  typedef typename Kind<AK>::Acc Acc;
  constexpr int BK = Kind<AK>::BK;
  constexpr int E = 16 / sizeof(T);  // elements in a 16-byte chunk
  constexpr int BCH = BN / E;        // chunks in a B tile row
  constexpr bool I8 = AK != 0;
  // A/B tiles during the K loop, then the C tile for the epilogue. bf16: A
  // (BM, LDA) and B (BK, LDB) row-major; int8: A as 4 chunks of (BM, 16) and
  // B as 4 chunks of (BK, 16), so that every wmma fragment is 32-byte aligned
  __shared__ __align__(128) unsigned char smem[BM * LDC * 4];
  static_assert(BM * LDA * 2 + 32 * LDB * 2 <= BM * LDC * 4, "bf16 tiles exceed smem");
  static_assert(BM * 64 + 64 * BN <= BM * LDC * 4, "int8 tiles exceed smem");
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + (I8 ? BM * 64 : BM * LDA);
  Acc* Cs = reinterpret_cast<Acc*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp & 3;   // 4 warps along M (32 rows each)
  const int wn = warp >> 2;  // 2 warps along N (32 cols each)
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], (Acc)0);

  // A tile BM x BK: 512 chunks, two per thread; B tile BK x BN: 256, one per thread
  const int ra_row0 = tid >> 2, ra_q = tid & 3;
  const int ra_row1 = (tid + NTHREADS) >> 2;
  const int rb_row = tid / BCH, rb_q = tid % BCH;
  T* a_dst0 = I8 ? As + ra_q * BM * 16 + ra_row0 * 16 : As + ra_row0 * LDA + ra_q * 8;
  T* a_dst1 = I8 ? As + ra_q * BM * 16 + ra_row1 * 16 : As + ra_row1 * LDA + ra_q * 8;
  T* b_dst = I8 ? Bs + rb_q * BK * 16 + rb_row * 16 : Bs + rb_row * LDB + rb_q * 8;
  uint4 ra0, ra1, rb;

  ra0 = fetch_a<MODE, AK>(a, m0 + ra_row0, ra_q * E);
  ra1 = fetch_a<MODE, AK>(a, m0 + ra_row1, ra_q * E);
  rb = fetch_b<AK>(a, rb_row, n0 + rb_q * E);

  for (int k0 = 0; k0 < a.Kp; k0 += BK) {
    *reinterpret_cast<uint4*>(a_dst0) = ra0;
    *reinterpret_cast<uint4*>(a_dst1) = ra1;
    *reinterpret_cast<uint4*>(b_dst) = rb;
    __syncthreads();
    if (k0 + BK < a.Kp) {
      const int kn = k0 + BK;
      ra0 = fetch_a<MODE, AK>(a, m0 + ra_row0, kn + ra_q * E);
      ra1 = fetch_a<MODE, AK>(a, m0 + ra_row1, kn + ra_q * E);
      rb = fetch_b<AK>(a, kn + rb_row, n0 + rb_q * E);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm * 32 + i * 16;
        if constexpr (I8) wmma::load_matrix_sync(fa[i], As + (kk / 16) * BM * 16 + r * 16, 16);
        else wmma::load_matrix_sync(fa[i], As + r * LDA + kk, LDA);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = wn * 32 + j * 16;
        if constexpr (I8) wmma::load_matrix_sync(fb[j], Bs + (c / 16) * BK * 16 + kk * 16, 16);
        else wmma::load_matrix_sync(fb[j], Bs + kk * LDB + c, LDB);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j],
                              LDC, wmma::mem_row_major);
  __syncthreads();

  const float lo = a.relu ? 0.0f : -127.0f;
  for (int idx = tid; idx < BM * BN; idx += NTHREADS) {
    const int r = idx / BN;
    const int c = idx - r * BN;
    const int m = m0 + r;
    const int n = n0 + c;
    if (m >= a.M || n >= a.N) continue;
    const int f = MODE == 0 ? n : n % a.F;
    float v;
    if constexpr (AK == 0) {
      v = Cs[r * LDC + c] + a.bias[f];
    } else {
      float s = a.scale[f];
      if constexpr (AK == 2) s = __fmul_rn(s, a.rscale[m]);
      v = __fadd_rn(__fmul_rn(__int2float_rn(Cs[r * LDC + c]), s), a.bias[f]);
    }
    if (a.relu) v = fmaxf(v, 0.0f);
    size_t o;
    if (MODE == 0) {
      o = (size_t)m * a.N + n;
    } else {
      const int sub = n / a.F;
      const int dy = sub >> 1, dx = sub & 1;
      const int y = m / a.W;
      const int x = m - y * a.W;
      o = ((size_t)(2 * y + dy) * (2 * a.W) + (2 * x + dx)) * a.F + f;
    }
    if (a.out_i8) {
      static_cast<i8*>(a.out)[o] = (i8)(int)fminf(fmaxf(rintf(v), lo), 127.0f);
    } else {
      static_cast<bf16*>(a.out)[o] = __float2bfloat16_rn(v);
    }
  }
}

// dyn mode pre-pass: per output pixel, amax = max |x| over its 3x3 receptive
// field and all channels of both inputs; writes 127/amax (0 where amax is 0)
// and amax * f32(1/127). One warp per pixel.
__global__ void dyn_scales(const bf16* __restrict__ x0, const bf16* __restrict__ x1, int C0,
                           int C1, int H, int W, float* __restrict__ rinv,
                           float* __restrict__ rscale) {
  const int m = (int)(((size_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (m >= H * W) return;  // the whole warp leaves together
  const int y = m / W;
  const int x = m - y * W;
  float amax = 0.0f;
  for (int tap = 0; tap < 9; ++tap) {
    const int yy = y + tap / 3 - 1;
    const int xx = x + tap % 3 - 1;
    if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
    const size_t pixel = (size_t)yy * W + xx;
    for (int c = lane; c < C0; c += 32)
      amax = fmaxf(amax, fabsf(__bfloat162float(x0[pixel * C0 + c])));
    for (int c = lane; c < C1; c += 32)
      amax = fmaxf(amax, fabsf(__bfloat162float(x1[pixel * C1 + c])));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (lane == 0) {
    rinv[m] = amax > 0.0f ? __fdiv_rn(127.0f, amax) : 0.0f;
    rscale[m] = __fmul_rn(amax, (float)(1.0 / 127.0));
  }
}

__device__ __forceinline__ bf16 vmax(bf16 a, bf16 b) {
  // exact: the result is one of the bf16 inputs
  return __float2bfloat16_rn(fmaxf(__bfloat162float(a), __bfloat162float(b)));
}
__device__ __forceinline__ i8 vmax(i8 a, i8 b) { return a > b ? a : b; }

// 2x2 stride-2 max-pool, NHWC bf16 or int8 codes (the TPU kernel's fused pool
// output)
template <typename T>
__global__ void maxpool2(const T* __restrict__ in, int H, int W, int F, T* __restrict__ out) {
  const size_t total = (size_t)(H / 2) * (W / 2) * F;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int f = (int)(i % F);
  const size_t p = i / F;
  const int x = (int)(p % (W / 2));
  const int y = (int)(p / (W / 2));
  const size_t r0 = ((size_t)(2 * y) * W + 2 * x) * F + f;
  const size_t r1 = r0 + (size_t)W * F;
  out[i] = vmax(vmax(in[r0], in[r0 + F]), vmax(in[r1], in[r1 + F]));
}

// Fused 1x1 head of the last conv: out[m, o] = bf16(sum_c y[m,c]*hk[c,o] + hb[o]),
// f32 accumulation, one thread per pixel for all OC (<= 8) outputs.
__global__ void head1x1_bf16(const bf16* __restrict__ y, int M, int F,
                             const bf16* __restrict__ hk, const float* __restrict__ hb,
                             int OC, bf16* __restrict__ out) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  float acc[8];
#pragma unroll
  for (int o = 0; o < 8; ++o) acc[o] = 0.0f;
  const bf16* row = y + (size_t)m * F;
  for (int c = 0; c < F; ++c) {
    const float v = __bfloat162float(row[c]);
#pragma unroll
    for (int o = 0; o < 8; ++o)
      if (o < OC) acc[o] += v * __bfloat162float(hk[c * OC + o]);
  }
#pragma unroll
  for (int o = 0; o < 8; ++o)
    if (o < OC) out[(size_t)m * OC + o] = __float2bfloat16_rn(acc[o] + hb[o]);
}

template <int MODE, int AK>
static void launch(const GemmArgs& a, dim3 grid, cudaStream_t s) {
  gemm<MODE, AK><<<grid, NTHREADS, 0, s>>>(a);
}

static int launch_gemm(int mode, int kind, const GemmArgs& a, cudaStream_t s) {
  dim3 grid((a.M + BM - 1) / BM, (a.N + BN - 1) / BN);
  if (grid.x == 0 || grid.y == 0) return (int)cudaGetLastError();
  if (mode == 0 && kind == 0) launch<0, 0>(a, grid, s);
  else if (mode == 0 && kind == 1) launch<0, 1>(a, grid, s);
  else if (mode == 0 && kind == 2) launch<0, 2>(a, grid, s);
  else if (mode == 1 && kind == 0) launch<1, 0>(a, grid, s);
  else if (mode == 1 && kind == 1) launch<1, 1>(a, grid, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// kind: 0 bf16, 1 static int8 (int8 inputs), 2 dyn int8 (bf16 inputs; rinv and
// rscale from rtnr_dyn_scales). scale: (F,) f32 for kinds 1, 2, else unused.
extern "C" int rtnr_conv3x3(const void* x0, const void* x1, int C0, int C1, int H, int W,
                            const void* wmat, const void* bias, const void* scale,
                            const void* rinv, const void* rscale, void* out, int F, int Kp,
                            int relu, int kind, int out_i8, void* stream) {
  GemmArgs a;
  a.x0 = x0;
  a.x1 = x1;
  a.C0 = C0;
  a.C1 = C1;
  a.H = H;
  a.W = W;
  a.wmat = wmat;
  a.bias = (const float*)bias;
  a.scale = (const float*)scale;
  a.rinv = (const float*)rinv;
  a.rscale = (const float*)rscale;
  a.out = out;
  a.M = H * W;
  a.N = F;
  a.K = 9 * (C0 + C1);
  a.Kp = Kp;
  a.F = F;
  a.relu = relu;
  a.out_i8 = out_i8;
  const int chunk = kind == 0 ? 8 : 16;  // elements of a 16-byte load
  a.vecA = (C0 % chunk == 0) && (C1 % chunk == 0);
  a.vecB = F % chunk == 0;
  return launch_gemm(0, kind, a, (cudaStream_t)stream);
}

// kind: 0 bf16, 1 static int8
extern "C" int rtnr_convt2x2(const void* x, int C, int H, int W, const void* wmat,
                             const void* bias, const void* scale, void* out, int F, int Kp,
                             int kind, int out_i8, void* stream) {
  GemmArgs a;
  a.x0 = x;
  a.x1 = nullptr;
  a.C0 = C;
  a.C1 = 0;
  a.H = H;
  a.W = W;
  a.wmat = wmat;
  a.bias = (const float*)bias;
  a.scale = (const float*)scale;
  a.rinv = nullptr;
  a.rscale = nullptr;
  a.out = out;
  a.M = H * W;
  a.N = 4 * F;
  a.K = C;
  a.Kp = Kp;
  a.F = F;
  a.relu = 0;
  a.out_i8 = out_i8;
  const int chunk = kind == 0 ? 8 : 16;
  a.vecA = C % chunk == 0;
  a.vecB = (4 * F) % chunk == 0;
  return launch_gemm(1, kind, a, (cudaStream_t)stream);
}

extern "C" int rtnr_dyn_scales(const void* x0, const void* x1, int C0, int C1, int H, int W,
                               void* rinv, void* rscale, void* stream) {
  const size_t threads = (size_t)H * W * 32;
  const unsigned blocks = (unsigned)((threads + 255) / 256);
  if (blocks > 0)
    dyn_scales<<<blocks, 256, 0, (cudaStream_t)stream>>>(
        (const bf16*)x0, (const bf16*)x1, C0, C1, H, W, (float*)rinv, (float*)rscale);
  return (int)cudaGetLastError();
}

// elem_bytes: 2 for bf16, 1 for int8 codes
extern "C" int rtnr_maxpool2(const void* in, int H, int W, int F, int elem_bytes, void* out,
                             void* stream) {
  const size_t total = (size_t)(H / 2) * (W / 2) * F;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (blocks == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 2) maxpool2<bf16><<<blocks, threads, 0, s>>>((const bf16*)in, H, W, F, (bf16*)out);
  else if (elem_bytes == 1) maxpool2<i8><<<blocks, threads, 0, s>>>((const i8*)in, H, W, F, (i8*)out);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int rtnr_head1x1(const void* y, int M, int F, const void* hk, const void* hb,
                            int OC, void* out, void* stream) {
  if (OC > 8) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int blocks = (M + threads - 1) / threads;
  if (blocks > 0)
    head1x1_bf16<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const bf16*)y, M, F, (const bf16*)hk, (const float*)hb, OC, (bf16*)out);
  return (int)cudaGetLastError();
}
