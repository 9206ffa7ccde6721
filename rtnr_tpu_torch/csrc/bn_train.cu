// BatchNorm in training mode fused with the ReLU that follows it, forward and
// backward, for UNetTrain (wrapper: rtnr_tpu_torch/ops/bn_train.py).
//
// Replaces no TPU kernel. The JAX package trains with flax's nn.BatchNorm in
// DoubleConv (rtnr_tpu/models/unet.py:366-374) and leaves it to XLA, which
// fuses the statistics, the normalisation and the ReLU on its own. Eager PyTorch does
// not: the same math as plain torch ops is a few dozen f32 elementwise and
// reduction kernels a layer, forward and backward, most of them strided over
// channels-last tensors, and they held most of a 1080p training step. These
// kernels compute that math in four passes over each layer's activations.
//
// The math (flax 0.12's BatchNorm, as UNetTrain's plain path states it), per
// channel c over the P = N*H*W rows of the conv output x seen as a [P, C]
// matrix (channels last):
//   tot   = [sum x, sum x^2, P]      (summed over ranks by the wrapper's reduce)
//   mean  = tot[c] / n,  sq = tot[C+c] / n,  n = tot[2C]
//   vraw  = sq - mean*mean,  var = vraw < 0 ? 0 : vraw   (flax's fast variance)
//   rstd  = 1 / sqrt(var + 1e-5),  mul = rstd * scale
//   y     = relu(round_T((x - mean) * mul + bias))
//   running mean / var = 0.9 * running + 0.1 * (mean / var)
// Backward, with g = dy where y > 0 (the ReLU's mask, recomputed from x
// exactly as the forward rounded it) and xc = x - mean:
//   G = sum g,  Gx = sum g*xc          (local; the wrapper sums them over ranks)
//   dbias = G_local,  dscale = Gx_local * rstd
//   dv = vraw >= 0 ? Gx * scale * (-0.5 * rstd^3) : 0   (the clip passes no gradient)
//   a  = -(mul * G) / n,  b = 2 * dv / n
//   dx = round_T(g*mul + a + b*xc)
// The sums of g*xc (not g*x) keep the mean's cancellation out of dscale and b.
// Per-element products and sums are written with __fmul_rn / __fadd_rn /
// __fsub_rn, so nvcc never contracts them into an FMA: the forward output and
// the backward's mask come out of the same expression, bit for bit, and the
// wrapper's plain twins (channel_terms, bn_relu_apply_plain,
// bn_relu_grad_x_plain) repeat the per-channel and per-element arithmetic op
// for op: given the same sums, they give the same bits. rsqrt is taken as a
// correctly rounded square root and division, which torch repeats on any
// device (torch.rsqrt may differ from it by an ulp).
//
// Bound on this card: bytes. A [P, C] layer moves 6 bytes an element forward
// in bf16 (one read for the sums, one read and one write for the output) and
// 10 backward (one read of dy and x for the sums, one read of both and one
// write of dx); the [64,128,256,512] net at 1088x1920 has 18 layers over
// 1.02 G elements, about 16 GB a step, 4.9 ms at 3.35 TB/s.
//
// Design. A block of 256 threads walks a slab of rows; each thread owns V = 8
// consecutive channels (one 16-byte load of bf16, two of f32; V = 1 where C is
// not a multiple of 8 or a pointer is not 16-byte aligned) and a fixed row
// offset. A block first computes the per-channel terms of its channels once,
// into shared memory; each thread then holds its V channels' terms in
// registers for the whole slab. C up to 2048 (V = 8) fits a block row; wider
// layers take more blocks along y. The two sum passes accumulate in f32
// registers, reduce the block's rows through shared memory in a fixed order
// and write one partial row a block; a second small kernel adds the partial
// rows in a fixed order (one warp a column, lanes strided over the blocks,
// then a fixed butterfly), frame after frame. No float atomics: the sums, and
// so every step, repeat bit for bit. The number of blocks depends only on the
// frame's H*W, C and V (rtnr_bn_blocks), never on the card, and no block
// crosses a frame: with one frame a rank, the sum over ranks (frames added in
// rank order) gives the bits of one rank holding the whole batch.
//
// Every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define THREADS 256
#define NB_MAX 2048     // most blocks along the rows: the partials stay small
#define MIN_STEPS 16    // fewest block steps (of R rows) a block walks
#define EPS 1e-5f

struct Geo {
  int cg;     // channel groups (of V channels) a block covers
  int R;      // rows a block step covers: THREADS / cg
  int slabs;  // blocks along y
  int nb;     // blocks along the rows of one frame (N * nb in all)
  long rpb;   // rows a block walks
};

// Blocks never cross a frame: a frame's rows are cut the same way in any
// batch, so its sums come out the same bits whichever batch or rank holds it.
static Geo geo(int HW, int C, int V) {
  Geo g;
  const int tpr = C / V;
  g.cg = tpr < THREADS ? tpr : THREADS;
  g.R = THREADS / g.cg;
  g.slabs = (tpr + g.cg - 1) / g.cg;
  const long steps = ((long)HW + g.R - 1) / g.R;
  long nb = (steps + MIN_STEPS - 1) / MIN_STEPS;
  nb = nb > NB_MAX ? NB_MAX : (nb < 1 ? 1 : nb);
  const long spb = (steps + nb - 1) / nb;
  g.nb = (int)((steps + spb - 1) / spb);
  g.rpb = spb * g.R;
  return g;
}

// ---- loads and stores of V channels as f32 ----

template <int V>
__device__ __forceinline__ void load(const bf16* p, float (&f)[V]) {
  if constexpr (V == 8) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = __bfloat162float(p[i]);
  }
}

template <int V>
__device__ __forceinline__ void load(const float* p, float (&f)[V]) {
  if constexpr (V == 8) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = p[i];
  }
}

// the values are already representable in T (round_to), so these convert exactly
template <int V>
__device__ __forceinline__ void store(bf16* p, const float (&f)[V]) {
  if constexpr (V == 8) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = __float2bfloat16_rn(f[i]);
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&f)[V]) {
  if constexpr (V == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = f[i];
  }
}

// round to the storage type, as torch's .to(T) does (nearest, ties to even)
__device__ __forceinline__ float round_to(float v, const bf16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float round_to(float v, const float*) { return v; }

// ---- per-channel terms ----

struct Chan {
  float mean, vraw, rstd, mul;
};

__device__ __forceinline__ Chan chan(const float* tot, const float* scale, int C, int c) {
  Chan k;
  const float n = __ldg(tot + 2 * C);
  k.mean = __fdiv_rn(__ldg(tot + c), n);
  const float sq = __fdiv_rn(__ldg(tot + C + c), n);
  k.vraw = __fsub_rn(sq, __fmul_rn(k.mean, k.mean));
  const float var = k.vraw < 0.f ? 0.f : k.vraw;  // NaN stays NaN, as torch.clamp
  k.rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, EPS)));
  k.mul = __fmul_rn(k.rstd, __ldg(scale + c));
  return k;
}

// y = round_T((x - mean) * mul + bias), op by op; xc = x - mean
template <typename T>
__device__ __forceinline__ float normalised(float x, float mean, float mul, float bias,
                                            float& xc) {
  xc = __fsub_rn(x, mean);
  return round_to(__fadd_rn(__fmul_rn(xc, mul), bias), (const T*)nullptr);
}

// ---- the thread's place: channel group and row offset ----

struct Place {
  int g;        // channel group: channels g*V .. g*V+V-1
  int gl, r0;   // group within the block, row offset within a block step
  int R, cols;  // rows a step, channels of the block's slab (cg * V)
  bool active;
  long begin, end;
};

template <int V>
__device__ __forceinline__ Place place(int HW, int C, long rpb, int nb) {
  Place p;
  const int tpr = C / V;
  const int cg = tpr < THREADS ? tpr : THREADS;
  p.R = THREADS / cg;
  p.cols = cg * V;
  p.gl = threadIdx.x % cg;
  p.r0 = threadIdx.x / cg;
  p.g = blockIdx.y * cg + p.gl;
  p.active = p.r0 < p.R && p.g < tpr;
  const int f = blockIdx.x / nb;  // the block's frame
  p.begin = (long)f * HW + (long)(blockIdx.x % nb) * rpb;
  const long fend = (long)(f + 1) * HW;
  p.end = p.begin + rpb < fend ? p.begin + rpb : fend;
  return p;
}

// ---- pass 1 (forward) and pass 3 (backward): per-block partial sums ----
//
// BWD false: s1 = sum x, s2 = sum x^2. BWD true: s1 = sum g, s2 = sum g*xc.
// partial[b][0:C] = s1 and partial[b][C:2C] = s2 over block b's rows.
template <typename T, int V, bool BWD>
__global__ void __launch_bounds__(THREADS)
bn_partial(const T* __restrict__ x, const T* __restrict__ dy, int HW, int C, long rpb, int nb,
           const float* __restrict__ tot, const float* __restrict__ scale,
           const float* __restrict__ bias, float* __restrict__ partial) {
  __shared__ float sm[2][THREADS * V];
  const Place p = place<V>(HW, C, rpb, nb);
  const int cbase = blockIdx.y * p.cols;
  float mean[V], mul[V], bb[V];
  if constexpr (BWD) {
    __shared__ float terms[3][THREADS * V];
    for (int j = threadIdx.x; j < p.cols && cbase + j < C; j += THREADS) {
      const Chan k = chan(tot, scale, C, cbase + j);
      terms[0][j] = k.mean;
      terms[1][j] = k.mul;
      terms[2][j] = __ldg(bias + cbase + j);
    }
    __syncthreads();
    if (p.active) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        mean[i] = terms[0][p.gl * V + i];
        mul[i] = terms[1][p.gl * V + i];
        bb[i] = terms[2][p.gl * V + i];
      }
    }
  }
  float s1[V], s2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s1[i] = s2[i] = 0.f;
  if (p.active) {
    const int c0 = p.g * V;
#pragma unroll 4
    for (long r = p.begin + p.r0; r < p.end; r += p.R) {
      float xv[V];
      load<V>(x + r * C + c0, xv);
      if constexpr (!BWD) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          s1[i] += xv[i];
          s2[i] = fmaf(xv[i], xv[i], s2[i]);
        }
      } else {
        float gv[V];
        load<V>(dy + r * C + c0, gv);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          float xc;
          const float y = normalised<T>(xv[i], mean[i], mul[i], bb[i], xc);
          const float g = y > 0.f ? gv[i] : 0.f;
          s1[i] += g;
          s2[i] = fmaf(g, xc, s2[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      sm[0][p.r0 * p.cols + p.gl * V + i] = s1[i];
      sm[1][p.r0 * p.cols + p.gl * V + i] = s2[i];
    }
  }
  __syncthreads();
  float* out = partial + (long)blockIdx.x * 2 * C;
  for (int j = threadIdx.x; j < p.cols && cbase + j < C; j += THREADS) {
    float a = 0.f, b = 0.f;
    for (int r = 0; r < p.R; ++r) {
      a += sm[0][r * p.cols + j];
      b += sm[1][r * p.cols + j];
    }
    out[cbase + j] = a;
    out[C + cbase + j] = b;
  }
}

// ---- passes 1b and 3b: the partial rows added in a fixed order ----
//
// One warp a column j of [0, 2C): each frame's nb partial rows (lanes strided
// over them, then a fixed butterfly), then the frames in order, as a sum over
// ranks of one frame each adds them. Forward: out = tot = [sum x, sum x^2,
// N*HW]. Backward: out = [G, Gx] (local), dbias = G, dscale = Gx * rstd.
template <bool BWD>
__global__ void __launch_bounds__(THREADS)
bn_combine(const float* __restrict__ partial, int nb, int N, int HW, int C,
           const float* __restrict__ tot, const float* __restrict__ scale,
           float* __restrict__ out, float* __restrict__ dscale, float* __restrict__ dbias) {
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (j >= 2 * C) return;  // a whole warp at once
  float total = 0.f;
  for (int f = 0; f < N; ++f) {
    float s = 0.f;
    for (int b = lane; b < nb; b += 32) s += partial[((long)f * nb + b) * 2 * C + j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    total = f == 0 ? s : total + s;
  }
  if (lane != 0) return;
  out[j] = total;
  if constexpr (!BWD) {
    if (j == 0) out[2 * C] = __int2float_rn(N * HW);
  } else if (j < C) {
    dbias[j] = total;
  } else {
    dscale[j - C] = __fmul_rn(total, chan(tot, scale, C, j - C).rstd);
  }
}

// ---- pass 2: normalise, round, ReLU; the running statistics ----
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
bn_apply(const T* __restrict__ x, int HW, int C, long rpb, int nb, const float* __restrict__ tot,
         const float* __restrict__ scale, const float* __restrict__ bias,
         float* __restrict__ run_mean, float* __restrict__ run_var, T* __restrict__ y) {
  __shared__ float terms[3][THREADS * V];
  const Place p = place<V>(HW, C, rpb, nb);
  const int cbase = blockIdx.y * p.cols;
  for (int j = threadIdx.x; j < p.cols && cbase + j < C; j += THREADS) {
    const int c = cbase + j;
    const Chan k = chan(tot, scale, C, c);
    terms[0][j] = k.mean;
    terms[1][j] = k.mul;
    terms[2][j] = __ldg(bias + c);
    if (blockIdx.x == 0) {
      const float var = k.vraw < 0.f ? 0.f : k.vraw;
      run_mean[c] = __fadd_rn(__fmul_rn(0.9f, run_mean[c]), __fmul_rn(0.1f, k.mean));
      run_var[c] = __fadd_rn(__fmul_rn(0.9f, run_var[c]), __fmul_rn(0.1f, var));
    }
  }
  __syncthreads();
  if (!p.active) return;
  const int c0 = p.g * V;
  float mean[V], mul[V], bb[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    mean[i] = terms[0][p.gl * V + i];
    mul[i] = terms[1][p.gl * V + i];
    bb[i] = terms[2][p.gl * V + i];
  }
#pragma unroll 4
  for (long r = p.begin + p.r0; r < p.end; r += p.R) {
    float v[V];
    load<V>(x + r * C + c0, v);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float xc;
      const float o = normalised<T>(v[i], mean[i], mul[i], bb[i], xc);
      v[i] = (o > 0.f || o != o) ? o : 0.f;  // ReLU; NaN passes, as torch.relu
    }
    store<V>(y + r * C + c0, v);
  }
}

// ---- pass 4: dx ----
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
bn_dx(const T* __restrict__ x, const T* __restrict__ dy, int HW, int C, long rpb, int nb,
      const float* __restrict__ tot, const float* __restrict__ scale,
      const float* __restrict__ bias, const float* __restrict__ gsums, T* __restrict__ dx) {
  __shared__ float terms[5][THREADS * V];
  const Place p = place<V>(HW, C, rpb, nb);
  const int cbase = blockIdx.y * p.cols;
  const float n = __ldg(tot + 2 * C);
  for (int j = threadIdx.x; j < p.cols && cbase + j < C; j += THREADS) {
    const int c = cbase + j;
    const Chan k = chan(tot, scale, C, c);
    const float r3 = __fmul_rn(__fmul_rn(k.rstd, k.rstd), k.rstd);
    const float dv = k.vraw >= 0.f
        ? __fmul_rn(__fmul_rn(__ldg(gsums + C + c), __ldg(scale + c)), __fmul_rn(-0.5f, r3))
        : 0.f;
    terms[0][j] = k.mean;
    terms[1][j] = k.mul;
    terms[2][j] = __ldg(bias + c);
    terms[3][j] = __fdiv_rn(-__fmul_rn(k.mul, __ldg(gsums + c)), n);
    terms[4][j] = __fdiv_rn(__fmul_rn(2.f, dv), n);
  }
  __syncthreads();
  if (!p.active) return;
  const int c0 = p.g * V;
  float mean[V], mul[V], bb[V], a[V], b[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int j = p.gl * V + i;
    mean[i] = terms[0][j];
    mul[i] = terms[1][j];
    bb[i] = terms[2][j];
    a[i] = terms[3][j];
    b[i] = terms[4][j];
  }
#pragma unroll 4
  for (long r = p.begin + p.r0; r < p.end; r += p.R) {
    float xv[V], gv[V];
    load<V>(x + r * C + c0, xv);
    load<V>(dy + r * C + c0, gv);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float xc;
      const float y = normalised<T>(xv[i], mean[i], mul[i], bb[i], xc);
      const float g = y > 0.f ? gv[i] : 0.f;
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(g, mul[i]), a[i]), __fmul_rn(b[i], xc));
      xv[i] = round_to(d, (const T*)nullptr);
    }
    store<V>(dx + r * C + c0, xv);
  }
}

// ---- C entries ----

template <typename T, int V>
static void launch_stats(const void* x, int N, int HW, int C, void* partial, void* tot,
                         cudaStream_t st) {
  const Geo g = geo(HW, C, V);
  bn_partial<T, V, false><<<dim3(N * g.nb, g.slabs), THREADS, 0, st>>>(
      (const T*)x, nullptr, HW, C, g.rpb, g.nb, nullptr, nullptr, nullptr, (float*)partial);
  bn_combine<false><<<(2 * C + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0, st>>>(
      (const float*)partial, g.nb, N, HW, C, nullptr, nullptr, (float*)tot, nullptr, nullptr);
}

template <typename T, int V>
static void launch_apply(const void* x, int N, int HW, int C, const void* tot,
                         const void* scale, const void* bias, void* run_mean, void* run_var,
                         void* y, cudaStream_t st) {
  const Geo g = geo(HW, C, V);
  bn_apply<T, V><<<dim3(N * g.nb, g.slabs), THREADS, 0, st>>>(
      (const T*)x, HW, C, g.rpb, g.nb, (const float*)tot, (const float*)scale,
      (const float*)bias, (float*)run_mean, (float*)run_var, (T*)y);
}

template <typename T, int V>
static void launch_grad_sums(const void* x, const void* dy, int N, int HW, int C,
                             const void* tot, const void* scale, const void* bias, void* partial,
                             void* sums, void* dscale, void* dbias, cudaStream_t st) {
  const Geo g = geo(HW, C, V);
  bn_partial<T, V, true><<<dim3(N * g.nb, g.slabs), THREADS, 0, st>>>(
      (const T*)x, (const T*)dy, HW, C, g.rpb, g.nb, (const float*)tot, (const float*)scale,
      (const float*)bias, (float*)partial);
  bn_combine<true><<<(2 * C + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0, st>>>(
      (const float*)partial, g.nb, N, HW, C, (const float*)tot, (const float*)scale,
      (float*)sums, (float*)dscale, (float*)dbias);
}

template <typename T, int V>
static void launch_grad_x(const void* x, const void* dy, int N, int HW, int C, const void* tot,
                          const void* scale, const void* bias, const void* gsums, void* dx,
                          cudaStream_t st) {
  const Geo g = geo(HW, C, V);
  bn_dx<T, V><<<dim3(N * g.nb, g.slabs), THREADS, 0, st>>>(
      (const T*)x, (const T*)dy, HW, C, g.rpb, g.nb, (const float*)tot, (const float*)scale,
      (const float*)bias, (const float*)gsums, (T*)dx);
}

// dispatch on the storage type (is_bf16: bf16, else f32) and the vector width
#define BN_DISPATCH(FN, ...)                                   \
  do {                                                         \
    if (is_bf16) {                                             \
      if (vec) FN<bf16, 8>(__VA_ARGS__); else FN<bf16, 1>(__VA_ARGS__); \
    } else {                                                   \
      if (vec) FN<float, 8>(__VA_ARGS__); else FN<float, 1>(__VA_ARGS__); \
    }                                                          \
  } while (0)

// Partial rows for N frames of HW rows and C channels (the wrapper allocates
// them, 2*C floats each); vec: 8 channels a thread, else 1.
extern "C" int rtnr_bn_blocks(int N, int HW, int C, int vec) {
  return N * geo(HW, C, vec ? 8 : 1).nb;
}

// tot (2C+1 floats) = [sum x, sum x^2, N*HW] of x [N*HW, C].
extern "C" int rtnr_bn_stats(const void* x, int N, int HW, int C, int is_bf16, int vec,
                             void* partial, void* tot, void* stream) {
  BN_DISPATCH(launch_stats, x, N, HW, C, partial, tot, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// y = relu(round(BatchNorm(x))) from tot; updates the running mean and var.
extern "C" int rtnr_bn_apply(const void* x, int N, int HW, int C, int is_bf16, int vec,
                             const void* tot, const void* scale, const void* bias,
                             void* run_mean, void* run_var, void* y, void* stream) {
  BN_DISPATCH(launch_apply, x, N, HW, C, tot, scale, bias, run_mean, run_var, y,
              (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// sums (2C floats) = [G, Gx] of this rank's rows; dscale, dbias from them.
extern "C" int rtnr_bn_grad_sums(const void* x, const void* dy, int N, int HW, int C,
                                 int is_bf16, int vec, const void* tot, const void* scale,
                                 const void* bias, void* partial, void* sums, void* dscale,
                                 void* dbias, void* stream) {
  BN_DISPATCH(launch_grad_sums, x, dy, N, HW, C, tot, scale, bias, partial, sums, dscale, dbias,
              (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// dx from gsums = [G, Gx] summed over the ranks.
extern "C" int rtnr_bn_grad_x(const void* x, const void* dy, int N, int HW, int C, int is_bf16,
                              int vec, const void* tot, const void* scale, const void* bias,
                              const void* gsums, void* dx, void* stream) {
  BN_DISPATCH(launch_grad_x, x, dy, N, HW, C, tot, scale, bias, gsums, dx,
              (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
