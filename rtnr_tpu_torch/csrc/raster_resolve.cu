// Raster resolve for Hopper: winners (K1), expansion (K2), float winners (K5),
// pixel-only winners (K6) and the carrier-stream resolve (K7-K9).
//
// Replaces rtnr_tpu/ops/raster_pallas4.py::_winners_kernel4 (K1, wrapper
// raster_images_pallas4) and ::_expand_kernel4 (K2, wrapper expand_winners).
//
// Input: the carrier-free point stream sorted by (pixel id, depth bits):
// pix (sentinel hw for culled points), z bits (positive f32 patterns), and
// colour packed r|g<<8|b<<16.
//
// K1 (rtnr_winners): a segment head is an element with pix < hw whose
// predecessor has another pixel. Each head walks its own segment while
// !(z > z_head + band) (reference render.cu:106; depth ascends within a
// segment, so the band is a prefix) and writes that pixel's OWN totals
// (r, g, b, count), its head depth bits and its pixel id at column = winner
// rank. There are no inclusive running sums, so no 2^31 wrap. The rank is
// an exclusive count of heads, computed here in three launches: per-block
// head counts, one block scanning those counts (and writing the winner
// total on the device), then the write pass with a block-local scan.
// Bound on this card: bytes. Each element is read about twice (12 B, plus
// the neighbour's pix) and each winner row written once (24 B): ~0.1 GB at
// 5M points / 1080p, ~30 us at 3.35 TB/s. Design: coalesced per-block
// streams, no atomics; a very long segment (e.g. 5,000 points on one pixel)
// is walked by ONE thread, which is slow but exact.
//
// K2 (rtnr_expand): one thread per output pixel binary-searches the
// pixel-sorted winner stream (the TPU kernel's searchsorted window) and
// writes its row or the empty defaults (count 0, depth FLT_MAX, reference
// project_cloud.cu:316), so every output is written once and no fill pass
// runs. packed_out does the integer-average resolve (reference
// render.cu:160-162) and emits r|g<<8|b<<16 plus depth. Bound: bytes, the
// 8 B/pixel output (~17 MB at 1080p, ~5 us) plus the winner rows.
//
// K2 float_sums (the differentiable forward's mode, raster_pallas4.py:503-511)
// needs no device code of its own: the winner rows of rtnr_winners_f32 hold
// per-pixel totals as f32 bit patterns, nothing is subtracted, and
// rtnr_expand copies 32-bit rows as they are. Empty pixels get 0 bits (0.0f)
// in the sum and count rows and FLT_MAX depth, which is what float_sums
// produces; the wrapper views rows 0-3 as f32.
//
// K5 (rtnr_winners_f32): replaces rtnr_tpu/ops/raster_pallas4.py::
// _compact_kernel (wrapper compact_rows_by_rank) together with the XLA work
// before it in the differentiable forward (raster_diff.py:246-276: head-depth
// broadcast, band mask, inclusive f32 prefix sums, winner ranks). One kernel
// does the whole job, as K1 does for integers: input is the same sorted
// stream with f32 colour lanes (n, 3); each segment head walks its own band
// prefix, accumulates r, g, b and count in f64 and rounds each ONCE to f32,
// then writes them (as bit patterns), the head depth bits and the pixel id at
// column = winner rank (the same three-launch head-count scan; the total
// stays on the device). f64 makes a pixel's sum independent of summation
// order, so the kernel equals its plain twin bit for bit, and equals the JAX
// package wherever JAX's f32 prefixes are exact (integer colours, prefix
// < 2^24); at 5M points JAX's global prefixes reach ~6e8, where f32 steps
// are 64 apart. Bound on this card: bytes. ~20 B read per point (pix, z bits,
// 12 B of colour, the neighbour's pix) plus 24 B written per winner: ~0.15
// GB at 5M points / 1080p, ~45 us at 3.35 TB/s. As in K1, one thread walks
// a very long segment, which is slow but exact.
//
// K6 (rtnr_winners5): replaces rtnr_tpu/ops/raster_pallas5.py::
// _winners_kernel5 (wrapper raster_images_pallas5, RTNR_RESOLVE=v5). Input:
// the carrier-free stream sorted by pixel id ONLY, so depth order inside a
// segment is arbitrary. Each head walks its segment twice: first the min of
// the depth bits (positive f32 or +inf, so the int order is the float
// order), then the sums of r, g, b and count over the elements with
// !(z > zmin + band) (the f32 add of reference render.cu:106). It writes
// K1's row (totals, min depth bits, pixel) at column = winner rank, with
// K1's head-count scan, so K2 expands it unchanged. The TPU kernel carries
// a segment across 16k-element parts with a one-part lookback and, past
// it, sets an overflow flag that re-sorts by depth and runs v4; here one
// thread walks any segment, so there is no window, flag or fallback: a
// 20,000-point one-pixel segment is slow (two serial walks) but exact.
// Bound: bytes, as K1 (12 B a point read, 24 B a winner written).
//
// K7-K9 (rtnr_resolve_carriers): replaces raster_pallas3.py::
// _resolve_kernel3, raster_pallas2.py::_resolve_kernel2 and raster_pallas.py::
// _resolve_kernel, three tilings of one function (raster.raster_images).
// Input: the carrier stream sorted by (pixel id, depth bits): the points
// plus one FLT_MAX carrier per pixel, real points flagged by bit 24 of
// packed. Every pixel has a segment, so each head walks its band prefix,
// summing the real elements only, and writes straight to column = pixel:
// sums (3 x i32), count and depth = the head's z. No rank, no expansion. An
// empty pixel's head is its carrier: depth FLT_MAX and count 0, because
// FLT_MAX + 0.02f == FLT_MAX keeps the carrier in its own band but it is not
// real. A black point at FLT_MAX is counted: only the flag tells them
// apart. Bound: bytes. 12 B read per element and 20 B written per pixel:
// ~126 MB for 5M points + 1080p carriers, ~38 us at 3.35 TB/s.
//
// Built with -fmad=false: every kernel here must be bit-identical to its
// plain twin. Every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#define WIN_THREADS 256
#define WIN_PER_THREAD 4
#define WIN_BLOCK (WIN_THREADS * WIN_PER_THREAD)
#define SCAN_THREADS 1024
#define FLT_MAX_BITS 0x7F7FFFFF
#define REAL_BIT (1 << 24)

__device__ __forceinline__ int head_flag(const int* __restrict__ pix, int i, int hw) {
  const int p = pix[i];
  return (p < hw && (i == 0 || pix[i - 1] != p)) ? 1 : 0;
}

// Block-wide exclusive scan of one int per thread. *total gets the block sum.
__device__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nw) warp_sums[lane] = w;
  }
  __syncthreads();
  const int excl = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
  *total = warp_sums[nw - 1];
  __syncthreads();
  return excl;
}

__global__ void winners_count(const int* __restrict__ pix, int n, int hw,
                              int* __restrict__ block_counts) {
  __shared__ int warp_sums[32];
  const int base = blockIdx.x * WIN_BLOCK + threadIdx.x * WIN_PER_THREAD;
  int c = 0;
#pragma unroll
  for (int k = 0; k < WIN_PER_THREAD; ++k) {
    const int i = base + k;
    if (i < n) c += head_flag(pix, i, hw);
  }
  int tot;
  block_exclusive_scan(c, warp_sums, &tot);
  if (threadIdx.x == 0) block_counts[blockIdx.x] = tot;
}

__global__ void winners_scan(const int* __restrict__ block_counts, int nb,
                             int* __restrict__ block_offsets, int* __restrict__ total) {
  __shared__ int warp_sums[32];
  int carry = 0;
  for (int s = 0; s < nb; s += blockDim.x) {
    const int i = s + threadIdx.x;
    const int v = i < nb ? block_counts[i] : 0;
    int tot;
    const int ex = block_exclusive_scan(v, warp_sums, &tot);
    if (i < nb) block_offsets[i] = carry + ex;
    carry += tot;
  }
  if (threadIdx.x == 0) *total = carry;
}

// K1 (SEG_MIN false: depth ascends in a segment, the head is its minimum and
// the band a prefix) and K6 (SEG_MIN true: any order, the minimum is walked
// for and the band tested on every element)
template <bool SEG_MIN>
__global__ void winners_write(const int* __restrict__ pix, const int* __restrict__ zbits,
                              const int* __restrict__ packed, int n, int hw, float band,
                              const int* __restrict__ block_offsets,
                              int* __restrict__ wimg, int cap) {
  __shared__ int warp_sums[32];
  const int base = blockIdx.x * WIN_BLOCK + threadIdx.x * WIN_PER_THREAD;
  int f[WIN_PER_THREAD];
  int c = 0;
#pragma unroll
  for (int k = 0; k < WIN_PER_THREAD; ++k) {
    const int i = base + k;
    f[k] = i < n ? head_flag(pix, i, hw) : 0;
    c += f[k];
  }
  int tot;
  int rank = block_offsets[blockIdx.x] + block_exclusive_scan(c, warp_sums, &tot);
#pragma unroll
  for (int k = 0; k < WIN_PER_THREAD; ++k) {
    if (!f[k]) continue;
    const int i = base + k;
    const int p = pix[i];
    int zb_head = zbits[i];
    if (SEG_MIN) {
      for (int j = i + 1; j < n && pix[j] == p; ++j) zb_head = min(zb_head, zbits[j]);
    }
    const float lim = __fadd_rn(__int_as_float(zb_head), band);
    int sr = 0, sg = 0, sb = 0, cnt = 0;
    for (int j = i; j < n && pix[j] == p; ++j) {
      if (__int_as_float(zbits[j]) > lim) {
        if (SEG_MIN) continue;
        break;
      }
      const int pk = packed[j];
      sr += pk & 255;
      sg += (pk >> 8) & 255;
      sb += (pk >> 16) & 255;
      cnt += 1;
    }
    wimg[0 * cap + rank] = sr;
    wimg[1 * cap + rank] = sg;
    wimg[2 * cap + rank] = sb;
    wimg[3 * cap + rank] = cnt;
    wimg[4 * cap + rank] = zb_head;
    wimg[5 * cap + rank] = p;
    ++rank;
  }
}

__global__ void winners_write_f32(const int* __restrict__ pix, const int* __restrict__ zbits,
                                  const float* __restrict__ rgb, int n, int hw, float band,
                                  const int* __restrict__ block_offsets,
                                  int* __restrict__ wimg, int cap) {
  __shared__ int warp_sums[32];
  const int base = blockIdx.x * WIN_BLOCK + threadIdx.x * WIN_PER_THREAD;
  int f[WIN_PER_THREAD];
  int c = 0;
#pragma unroll
  for (int k = 0; k < WIN_PER_THREAD; ++k) {
    const int i = base + k;
    f[k] = i < n ? head_flag(pix, i, hw) : 0;
    c += f[k];
  }
  int tot;
  int rank = block_offsets[blockIdx.x] + block_exclusive_scan(c, warp_sums, &tot);
#pragma unroll
  for (int k = 0; k < WIN_PER_THREAD; ++k) {
    if (!f[k]) continue;
    const int i = base + k;
    const int p = pix[i];
    const int zb_head = zbits[i];
    const float lim = __fadd_rn(__int_as_float(zb_head), band);
    double sr = 0.0, sg = 0.0, sb = 0.0, cnt = 0.0;
    for (int j = i; j < n && pix[j] == p; ++j) {
      if (__int_as_float(zbits[j]) > lim) break;
      sr = __dadd_rn(sr, (double)rgb[3 * j + 0]);
      sg = __dadd_rn(sg, (double)rgb[3 * j + 1]);
      sb = __dadd_rn(sb, (double)rgb[3 * j + 2]);
      cnt = __dadd_rn(cnt, 1.0);
    }
    wimg[0 * cap + rank] = __float_as_int(__double2float_rn(sr));
    wimg[1 * cap + rank] = __float_as_int(__double2float_rn(sg));
    wimg[2 * cap + rank] = __float_as_int(__double2float_rn(sb));
    wimg[3 * cap + rank] = __float_as_int(__double2float_rn(cnt));
    wimg[4 * cap + rank] = zb_head;
    wimg[5 * cap + rank] = p;
    ++rank;
  }
}

__global__ void resolve_carriers_kernel(const int* __restrict__ pix,
                                        const int* __restrict__ zbits,
                                        const int* __restrict__ packed, int n, int hw,
                                        float band, int* __restrict__ sums,
                                        int* __restrict__ count, int* __restrict__ depth_bits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !head_flag(pix, i, hw)) return;
  const int p = pix[i];
  const int zb_head = zbits[i];
  const float lim = __fadd_rn(__int_as_float(zb_head), band);
  int sr = 0, sg = 0, sb = 0, cnt = 0;
  for (int j = i; j < n && pix[j] == p; ++j) {
    if (__int_as_float(zbits[j]) > lim) break;
    const int pk = packed[j];
    if (!(pk & REAL_BIT)) continue;
    sr += pk & 255;
    sg += (pk >> 8) & 255;
    sb += (pk >> 16) & 255;
    cnt += 1;
  }
  sums[3 * p + 0] = sr;
  sums[3 * p + 1] = sg;
  sums[3 * p + 2] = sb;
  count[p] = cnt;
  depth_bits[p] = zb_head;
}

__global__ void expand_kernel(const int* __restrict__ wimg, int cap,
                              const int* __restrict__ total_p, int hw, int packed_out,
                              int* __restrict__ out0, int* __restrict__ out_cnt,
                              float* __restrict__ out_depth) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= hw) return;
  const int total = *total_p;
  const int* __restrict__ wpix = wimg + 5 * cap;
  int lo = 0, hi = total;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (wpix[mid] < q) lo = mid + 1; else hi = mid;
  }
  const bool hit = lo < total && wpix[lo] == q;
  int r = 0, g = 0, b = 0, cnt = 0, zb = FLT_MAX_BITS;
  if (hit) {
    r = wimg[0 * cap + lo];
    g = wimg[1 * cap + lo];
    b = wimg[2 * cap + lo];
    cnt = wimg[3 * cap + lo];
    zb = wimg[4 * cap + lo];
  }
  if (packed_out) {
    const int cpos = cnt > 0 ? cnt : 1;
    out0[q] = cnt > 0 ? ((r / cpos) | ((g / cpos) << 8) | ((b / cpos) << 16)) : 0;
  } else {
    out0[3 * q + 0] = r;
    out0[3 * q + 1] = g;
    out0[3 * q + 2] = b;
    out_cnt[q] = cnt;
  }
  out_depth[q] = __int_as_float(zb);
}

// The first two launches of every winners entry: per-block head counts, then
// one block scanning them into block offsets (and the winner total).
static const int* head_offsets(const int* pix, int n, int hw, void* block_scratch,
                               void* total, cudaStream_t s) {
  const int nb = (n + WIN_BLOCK - 1) / WIN_BLOCK;
  int* counts = (int*)block_scratch;
  int* offsets = counts + (nb > 0 ? nb : 1);
  if (nb > 0) {
    winners_count<<<nb, WIN_THREADS, 0, s>>>(pix, n, hw, counts);
  }
  winners_scan<<<1, SCAN_THREADS, 0, s>>>(counts, nb, offsets, (int*)total);
  return offsets;
}

template <bool SEG_MIN>
static int run_winners(const void* pix, const void* zbits, const void* packed, int n, int hw,
                       float band, void* block_scratch, void* wimg, int cap, void* total,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* offsets = head_offsets((const int*)pix, n, hw, block_scratch, total, s);
  const int nb = (n + WIN_BLOCK - 1) / WIN_BLOCK;
  if (nb > 0) {
    winners_write<SEG_MIN><<<nb, WIN_THREADS, 0, s>>>((const int*)pix, (const int*)zbits,
                                                      (const int*)packed, n, hw, band, offsets,
                                                      (int*)wimg, cap);
  }
  return (int)cudaGetLastError();
}

extern "C" int rtnr_winners(const void* pix, const void* zbits, const void* packed,
                            int n, int hw, float band, void* block_scratch,
                            void* wimg, int cap, void* total, void* stream) {
  return run_winners<false>(pix, zbits, packed, n, hw, band, block_scratch, wimg, cap, total,
                            stream);
}

extern "C" int rtnr_winners5(const void* pix, const void* zbits, const void* packed,
                             int n, int hw, float band, void* block_scratch,
                             void* wimg, int cap, void* total, void* stream) {
  return run_winners<true>(pix, zbits, packed, n, hw, band, block_scratch, wimg, cap, total,
                           stream);
}

extern "C" int rtnr_winners_f32(const void* pix, const void* zbits, const void* rgb,
                                int n, int hw, float band, void* block_scratch,
                                void* wimg, int cap, void* total, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* offsets = head_offsets((const int*)pix, n, hw, block_scratch, total, s);
  const int nb = (n + WIN_BLOCK - 1) / WIN_BLOCK;
  if (nb > 0) {
    winners_write_f32<<<nb, WIN_THREADS, 0, s>>>((const int*)pix, (const int*)zbits,
                                                 (const float*)rgb, n, hw, band, offsets,
                                                 (int*)wimg, cap);
  }
  return (int)cudaGetLastError();
}

extern "C" int rtnr_resolve_carriers(const void* pix, const void* zbits, const void* packed,
                                     int n, int hw, float band, void* sums, void* count,
                                     void* depth, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  if (blocks > 0) {
    resolve_carriers_kernel<<<blocks, threads, 0, s>>>((const int*)pix, (const int*)zbits,
                                                       (const int*)packed, n, hw, band,
                                                       (int*)sums, (int*)count, (int*)depth);
  }
  return (int)cudaGetLastError();
}

extern "C" int rtnr_expand(const void* wimg, int cap, const void* total, int hw,
                           int packed_out, void* out0, void* out_cnt, void* out_depth,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  const int blocks = (hw + threads - 1) / threads;
  if (blocks > 0) {
    expand_kernel<<<blocks, threads, 0, s>>>((const int*)wimg, cap, (const int*)total, hw,
                                             packed_out, (int*)out0, (int*)out_cnt,
                                             (float*)out_depth);
  }
  return (int)cudaGetLastError();
}
