// The depth prefilter of one full frame: pyramid, coarse-to-fine keep test
// with the bilinear refill, and the packing of the U-Net input (wrapper and
// plain twins: rtnr_tpu_torch/ops/prefilter.py, filter_frame).
//
// Replaces no TPU kernel. The JAX package writes the prefilter as plain jnp
// (rtnr_tpu/ops/prefilter.py) and XLA fuses it. The port's plain path is the
// same ops in eager PyTorch, about 350 small elementwise launches a 1088x1920
// frame, so the host's launches, not the card, set its pace. Here it is one
// memset and L + 1 kernels (5 at the usual 4 levels), launched by one C call.
//
// Bit for bit equal to pad_to_pyramid followed by depth_prefilter in full-image
// mode. Every rounding step is the plain path's, in its order (ROADMAP C9):
// - the Laplacian sums its nine taps in _LAPLACE_TAPS order, zero taps
//   included, each product and sum rounded on its own, so FLT_MAX
//   neighbourhoods overflow to inf or NaN as in the plain path;
// - the keep threshold is (grad ? max3x3 : centre) * strength;
// - the bilinear refill is (1-wx)*l00 + wx*l01, then the rows, each product
//   and sum rounded on its own;
// - the normalised depth is (d - dmin) / (dmax - dmin) with an IEEE division,
//   and the colours rgb * f32(1/255) as a multiply.
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn keep nvcc from contracting or
// reordering them, and the library builds with -fmad=false besides. min and
// max propagate NaN as torch.amin and torch.maximum do.
//
// Bound on this card: bytes. At 1088x1920 the frame reads depth (8.4 MB) and
// rgb (6.3 MB) and writes unet_input (41.8 MB), filtered depth (8.4 MB),
// filtered rgb (6.3 MB) and the mask (2.1 MB); the pyramid levels add ~8 MB
// of traffic: ~81 MB, ~24 us at 3.35 TB/s.
//
// Design.
// 1. prefilter_pyramid: a block owns a 64x64 tile of the padded frame and
//    builds levels 1..L of its 2x2-min pyramid in shared memory, writing each
//    level to device memory. Pixels outside the raw frame read as empty
//    (FLT_MAX), which folds pad_to_pyramid in. The same pass reduces the
//    occupied pixels' min and max (the exact FLT_MAX seed skipped) with
//    atomicMax on order-preserving 32-bit keys: exact in any order. The key
//    of the min is the complement of the value's key, so both start at 0 (one
//    memset), and a key left at 0 decodes to the all-empty frame's inf / -inf.
// 2. prefilter_level, once for each level i = L..1, coarse to fine: a thread
//    owns one pixel of level i - 1 and reads the 3x3 neighbourhood of its
//    coarse pixel at level i (read-only in the pass). It writes only its own
//    fine pixel: for i > 1 the refilled value where the pixel is rejected, in
//    place; for i = 1 the mask, the filtered depth and rgb and the NHWC U-Net
//    input. So the passes need no other synchronisation than stream order.
//
// Every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 64          // fine pixels a pyramid block spans along each axis
#define PYR_THREADS 256
#define MAX_LEVELS 6     // a 64-pixel tile holds six 2x2 levels
#define EMPTY 3.4028234663852886e38f  // FLT_MAX, the raster's empty depth

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// order-preserving: key(a) < key(b) iff a < b, for every non-NaN a and b
__device__ __forceinline__ uint32_t order_key(float v) {
  uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_key(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ float raw_depth(const float* __restrict__ depth, int h, int w, int y,
                                           int x) {
  return (y < h && x < w) ? depth[(long long)y * w + x] : EMPTY;
}

__global__ void __launch_bounds__(PYR_THREADS)
prefilter_pyramid(const float* __restrict__ depth, int h, int w, int hp, int wp, int levels,
                  float* __restrict__ pyr, uint32_t* __restrict__ keys) {
  // the tile's levels, one after another: (T/2)^2 + (T/4)^2 + ... floats
  __shared__ float s[TILE * TILE / 3 + 1];
  const int y0 = blockIdx.y * TILE, x0 = blockIdx.x * TILE;
  // a ragged tile still spans a multiple of 2^levels pixels (hp, wp are)
  const int th = min(TILE, hp - y0), tw = min(TILE, wp - x0);
  uint32_t kmin = 0, kmax = 0;  // max of ~key (the min) and of key (the max)

  int hk = th >> 1, wk = tw >> 1;
  float* cur = s;
  for (int i = threadIdx.x; i < hk * wk; i += PYR_THREADS) {
    const int r = i / wk, c = i - r * wk;
    const int gy = y0 + 2 * r, gx = x0 + 2 * c;
    float v[4] = {raw_depth(depth, h, w, gy, gx), raw_depth(depth, h, w, gy, gx + 1),
                  raw_depth(depth, h, w, gy + 1, gx), raw_depth(depth, h, w, gy + 1, gx + 1)};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (v[j] != EMPTY) {
        const uint32_t k = order_key(v[j]);
        kmin = max(kmin, ~k);
        kmax = max(kmax, k);
      }
    }
    const float m = min_nan(min_nan(v[0], v[1]), min_nan(v[2], v[3]));
    cur[i] = m;
    pyr[(long long)((y0 >> 1) + r) * (wp >> 1) + (x0 >> 1) + c] = m;
  }
  __syncthreads();
  long long at = 0;  // level k's first element in the pyramid buffer (level 1 at 0)
  for (int k = 2; k <= levels; ++k) {
    at += (long long)(hp >> (k - 1)) * (wp >> (k - 1));
    const float* prev = cur;
    const int wprev = wk;
    cur += hk * wk;
    hk >>= 1;
    wk >>= 1;
    for (int i = threadIdx.x; i < hk * wk; i += PYR_THREADS) {
      const int r = i / wk, c = i - r * wk;
      const float* p = prev + 2 * r * wprev + 2 * c;
      const float m = min_nan(min_nan(p[0], p[1]), min_nan(p[wprev], p[wprev + 1]));
      cur[i] = m;
      pyr[at + (long long)((y0 >> k) + r) * (wp >> k) + (x0 >> k) + c] = m;
    }
    __syncthreads();
  }

  kmin = __reduce_max_sync(0xffffffffu, kmin);
  kmax = __reduce_max_sync(0xffffffffu, kmax);
  if ((threadIdx.x & 31) == 0) {
    if (kmin) atomicMax(&keys[0], kmin);
    if (kmax) atomicMax(&keys[1], kmax);
  }
}

// the bilinear weight of fine coordinate i against the clamped lower coarse
// index: -0.25 at 0 (the border extrapolates), 0.75 at even, 0.25 at odd
__device__ __forceinline__ float up_weight(int i) {
  return i == 0 ? -0.25f : ((i & 1) ? 0.25f : 0.75f);
}

// One level pass: the keep test of level i - 1's pixels against level i
// (``low``, hc x wc). LAST (i = 1): the fine level is the raw frame, padded
// on the fly, and the pass writes the outputs; else it refills ``fine`` in
// place where a pixel is rejected.
template <bool LAST>
__global__ void __launch_bounds__(256)
prefilter_level(const float* __restrict__ low, int hc, int wc, float* fine,
                const float* __restrict__ depth, const uint8_t* __restrict__ rgb, int h, int w,
                float strength, float gradient, float empty_thr,
                const uint32_t* __restrict__ keys, float* __restrict__ unet,
                float* __restrict__ fdepth, uint8_t* __restrict__ frgb,
                uint8_t* __restrict__ mask, float* __restrict__ minmax) {
  const int hf = 2 * hc, wf = 2 * wc;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= wf || y >= hf) return;
  const int cy = y >> 1, cx = x >> 1;
  auto at = [&](int r, int c) { return low[(long long)r * wc + c]; };

  // the coarse 3x3, -1 outside the level; the taps in _LAPLACE_TAPS order
  float nb[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const int r = cy + t / 3 - 1, c = cx + t % 3 - 1;
    nb[t] = (r >= 0 && r < hc && c >= 0 && c < wc) ? at(r, c) : -1.0f;
  }
  bool grad = false;
  if (cy > 0 && cy < hc - 1 && cx > 0 && cx < wc - 1) {
    const float tap[9] = {0.0f, 1.0f, 0.0f, 1.0f, -4.0f, 1.0f, 0.0f, 1.0f, 0.0f};
    float sum = 0.0f;
#pragma unroll
    for (int t = 0; t < 9; ++t) sum = __fadd_rn(sum, __fmul_rn(nb[t], tap[t]));
    grad = sum > gradient;
  }
  float nbmax = -1.0f;
#pragma unroll
  for (int t = 0; t < 9; ++t) nbmax = max_nan(nbmax, nb[t]);
  const float thr = __fmul_rn(grad ? nbmax : nb[4], strength);

  const long long p = (long long)y * wf + x;
  const float high = LAST ? raw_depth(depth, h, w, y, x) : fine[p];
  const bool keep = !(high >= empty_thr) && high <= thr;

  if (!LAST) {
    if (!keep) {
      const int ym = max(y - 1, 0) >> 1, yp = min(y + 1, hf - 1) >> 1;
      const int xm = max(x - 1, 0) >> 1, xp = min(x + 1, wf - 1) >> 1;
      const float wx = up_weight(x), wy = up_weight(y);
      const float ox = __fsub_rn(1.0f, wx), oy = __fsub_rn(1.0f, wy);
      const float v0 = __fadd_rn(__fmul_rn(ox, at(ym, xm)), __fmul_rn(wx, at(ym, xp)));
      const float v1 = __fadd_rn(__fmul_rn(ox, at(yp, xm)), __fmul_rn(wx, at(yp, xp)));
      fine[p] = __fadd_rn(__fmul_rn(oy, v0), __fmul_rn(wy, v1));
    }
    return;
  }

  const uint32_t kmin = keys[0], kmax = keys[1];
  const float dmin = kmin ? from_key(~kmin) : __uint_as_float(0x7f800000u);  // inf
  const float dmax = kmax ? from_key(kmax) : __uint_as_float(0xff800000u);   // -inf
  if (x == 0 && y == 0) {
    minmax[0] = dmin;
    minmax[1] = dmax;
  }
  const bool inside = y < h && x < w;
  const long long q = (long long)y * w + x;
  const float inv255 = (float)(1.0 / 255.0);  // torch applies the double 1/255 as f32
  float* u = unet + 5 * p;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const uint8_t v = inside ? rgb[3 * q + c] : 0;
    frgb[3 * p + c] = keep ? v : 0;
    u[c] = keep ? __fmul_rn((float)v, inv255) : 0.0f;
  }
  u[3] = keep ? 1.0f : 0.0f;
  u[4] = keep ? __fdiv_rn(__fsub_rn(high, dmin), __fsub_rn(dmax, dmin)) : -1.0f;
  fdepth[p] = keep ? high : -1.0f;
  mask[p] = keep;
}

extern "C" {

// The prefilter of one raw frame: depth (h, w) f32 and rgb (h, w, 3) uint8,
// contiguous, padded on the fly to (hp, wp), multiples of 2^levels. ``pyr``
// holds levels 1..levels one after another, then two 32-bit words for the
// min / max keys. Outputs (hp, wp) in the plain path's layouts: unet (.., 5)
// f32, fdepth f32, frgb (.., 3) uint8, mask bool; minmax = [dmin, dmax].
int rtnr_prefilter(const float* depth, const uint8_t* rgb, int h, int w, int hp, int wp,
                   int levels, float strength, float gradient, float empty_thr, float* pyr,
                   float* unet, float* fdepth, uint8_t* frgb, uint8_t* mask, float* minmax,
                   cudaStream_t stream) {
  if (levels < 1 || levels > MAX_LEVELS || hp % (1 << levels) || wp % (1 << levels) ||
      h > hp || w > wp)
    return (int)cudaErrorInvalidValue;
  long long at[MAX_LEVELS + 2] = {0, 0};  // at[k]: level k's first element in pyr
  for (int k = 2; k <= levels + 1; ++k)
    at[k] = at[k - 1] + (long long)(hp >> (k - 1)) * (wp >> (k - 1));
  uint32_t* keys = reinterpret_cast<uint32_t*>(pyr + at[levels + 1]);

  cudaError_t e = cudaMemsetAsync(keys, 0, 2 * sizeof(uint32_t), stream);
  if (e != cudaSuccess) return (int)e;
  const dim3 tiles((wp + TILE - 1) / TILE, (hp + TILE - 1) / TILE);
  prefilter_pyramid<<<tiles, PYR_THREADS, 0, stream>>>(depth, h, w, hp, wp, levels, pyr, keys);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const dim3 block(32, 8);
  for (int i = levels; i >= 1; --i) {
    const int hc = hp >> i, wc = wp >> i;
    const dim3 grid((2 * wc + 31) / 32, (2 * hc + 7) / 8);
    const float* low = pyr + at[i];
    if (i > 1) {
      prefilter_level<false><<<grid, block, 0, stream>>>(
          low, hc, wc, pyr + at[i - 1], nullptr, nullptr, h, w, strength, gradient,
          empty_thr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr);
    } else {
      prefilter_level<true><<<grid, block, 0, stream>>>(
          low, hc, wc, nullptr, depth, rgb, h, w, strength, gradient, empty_thr, keys, unet,
          fdepth, frgb, mask, minmax);
    }
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
