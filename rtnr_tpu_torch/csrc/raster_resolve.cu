// Raster resolve for Hopper: the v4 resolve (K1 + K2 as one kernel), the v5
// resolve (K6 + K2 as one kernel), the differentiable forward's resolve (K5 +
// K2 float_sums as one kernel), winners (K1), expansion (K2), float winners
// (K5), pixel-only winners (K6) and the carrier-stream resolve (K7-K9).
//
// Replaces rtnr_tpu/ops/raster_pallas4.py::_winners_kernel4 (K1, wrapper
// raster_images_pallas4) and ::_expand_kernel4 (K2, wrapper expand_winners).
//
// Input: the carrier-free point stream sorted by (pixel id, depth bits):
// pix (sentinel hw for culled points), z bits (positive f32 patterns), and
// colour packed r|g<<8|b<<16.
//
// rtnr_resolve4 (the v4 path: K1 and K2 in one kernel, no winner image):
// each tile owns TILE_P consecutive output pixels [q0, q1), and a block
// resolves TILES_PER_BLOCK consecutive tiles in turn. At its start one warp
// per tile bound finds, all at once, lower_bound(pix, q) for every tile
// edge q with a 33-ary search (32 probes a step, ~5 dependent loads at 5M
// points): a few searches a block, none a pixel. A tile's stream window is
// [lower_bound(pix, q0), lower_bound(pix, q1)). The block streams it in
// chunks of TILE_CHUNK elements, each thread TILE_ELEMS consecutive
// elements by 16-byte loads (the next chunk's loads issued before the
// current chunk is worked). Per chunk: pass A marks heads (pix[i] !=
// pix[i-1], the previous element by a warp shuffle) and each head writes its
// depth bits into the tile's depth row; after a barrier, pass B tests each
// element against its pixel's head depth, !(z > z_head + band) with
// __fadd_rn (reference render.cu:106), merges the thread's in-band run of
// one pixel and adds it (r, g, b, count) into the tile with shared-memory
// atomics. Integer sums commute, so the result does not depend on the order,
// and the head depth stays in the tile across chunks, so a segment of any
// length (one pixel of 20,000 points) is exact: it crosses chunks like any
// other. The tile starts at the empty defaults (count 0, depth FLT_MAX,
// reference project_cloud.cu:316) and is stored with 16-byte stores: every
// output byte is written once, no fill pass runs, nothing crosses a tile
// (segments are per pixel and pixels per tile), and no rank or scan is
// needed. Culled points (pix == hw) lie outside every window and are never
// read. The packed form does the integer-average resolve (reference
// render.cu:160-162) and emits r|g<<8|b<<16 plus depth; the sums form
// writes sums (HW, 3), count and depth. Bound: bytes, 12 B read per in-frame
// element and 8 B (packed) or 20 B (sums) written per pixel: 73.6 MB at 5M
// points / 1080p, ~22 us at 3.35 TB/s. What holds it back is the streaming
// itself, not the resolve work (sweeps on the card, PERF.md).
//
// rtnr_resolve5 (the v5 path, RTNR_RESOLVE=v5: K6 and K2 in one kernel, no
// winner image): replaces rtnr_tpu/ops/raster_pallas5.py::_winners_kernel5
// and the expansion after it (raster_images_pallas5). Its stream is sorted by
// pixel id alone, so depth order inside a segment is arbitrary. It runs
// rtnr_resolve4's tile skeleton (the windows are valid because pix is
// sorted) with two passes over each tile's window: pass A streams the window
// and takes each pixel's minimum depth bits into the tile's depth row with
// shared-memory atomicMin (positive f32 and +inf order as their int32 bits;
// a thread merges its run of one pixel first); one barrier after the whole
// window, since the minimum must be final before any band test; pass B
// streams the window again (from L2) and adds each element with
// !(z > zmin + band) (__fadd_rn, reference render.cu:106), merged per run,
// with shared-memory atomics. The depth row starts at MIN_EMPTY (above +inf,
// so that a pixel whose minimum is +inf keeps it) and the store turns an
// untouched pixel's MIN_EMPTY into FLT_MAX. No rank, no scan and no winner
// image; a segment of any length is exact; its images equal rtnr_resolve4's
// on the same points. Bound: bytes, as rtnr_resolve4's (12 B read per
// in-frame element once from device memory, 8 B or 20 B written a pixel:
// ~22 us packed at 5M points / 1080p); the second pass reads from L2.
//
// rtnr_resolve_diff (the differentiable forward: K5 and K2 float_sums in one
// kernel, no winner image): replaces rtnr_tpu/ops/raster_pallas4.py::
// _compact_kernel and the float_sums expansion after it, with the XLA work
// before them (raster_diff.py:246-276: head-depth broadcast, band mask, f32
// prefix sums, ranks). Input: the (pixel, depth)-sorted stream with f32
// colour lanes (n, 3) in any range (Adam moves them), z bits that may be +inf.
// rtnr_resolve4's tile skeleton (windows from the 33-ary searches, 16-byte
// loads of the pixel ids one chunk ahead, the tile stored once with 16-byte
// stores); the work of a pixel goes to its segment head found in a chunk,
// which walks its band prefix from L1/L2 in stream order in f64 and rounds
// each sum once to f32, exactly as K5's head does, and writes the pixel's
// sums, count and head depth bits into the tile row. f64 addition of
// non-integer colours depends on the order, so rtnr_resolve4's atomic merge
// of per-thread runs could not give K5's bits; one head a pixel needs no
// atomics, and the result is K5 + K2's bit for bit and the same on every
// launch. A segment of any length is exact (one thread walks it, slow past a
// few thousand points). Outputs: sums (HW, 3) f32, count f32, depth (the
// head's bits, FLT_MAX where empty, with 0 sums and count), each stored once.
// Bound: bytes, 20 B read per in-frame element (pix, z bits, 12 B of colour)
// and 20 B written a pixel: ~136 MB at 5M points / 1080p, ~41 us at 3.35 TB/s.
//
// Band reference (the point-sharded passes, parallel/): rtnr_resolve4's sums
// form and rtnr_resolve_diff take an optional (hw,) f32 image band_ref. With
// it, pixel p's band ends at band_ref[p] + band (__fadd_rn) instead of at its
// own head's depth + band: the band is tested against the z-buffer merged
// over every point shard, as the reference's accumulate pass reads the final
// z-buffer (render.cu:101-106); JAX runs the same test before its K5
// compaction (rtnr_tpu/parallel/diff.py:152-232). The merged minimum is at or
// below the local head, so the band is still a prefix of the depth-sorted
// segment; a pixel whose limit lies below its own head gets a zero row. The
// depth output stays the local head's depth (what the first pass's merge
// reads). The reference is a compile-time flag (resolve4_ref_tile beside
// resolve4_tile over one body; resolve_diff_tile<BAND_REF>), so the kernels
// without it run today's code. Bound: as without it, plus 4 B read
// a pixel with points.
//
// K1 (rtnr_winners, standalone: its tests and the per-kernel table; K5 and
// K6 share its head-count scan): a segment head is an element with pix < hw whose
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
// K2 (rtnr_expand, standalone since the tile resolves: its tests and the
// per-kernel table): rtnr_resolve4's tile skeleton with the winner rows
// as its source. Each tile of TILE_P pixels finds its window in the winner
// pixel row wimg[5, :total] with the same searches (the TPU kernel's
// searchsorted `starts`, found in the kernel), scatters the
// window's rows into the tile (one column a pixel, no atomics) and stores
// the tile as above, in the packed or the sums form. Bound: bytes, 24 B read
// a winner and 8 B (packed) written a pixel (~17 MB + 29 MB at 1080p, ~14
// us).
//
// K2 float_sums (raster_pallas4.py:503-511; inside rtnr_resolve_diff since
// it, kept standalone with K5) needs no device code of
// its own: the winner rows of rtnr_winners_f32 hold
// per-pixel totals as f32 bit patterns, nothing is subtracted, and
// rtnr_expand copies 32-bit rows as they are. Empty pixels get 0 bits (0.0f)
// in the sum and count rows and FLT_MAX depth, which is what float_sums
// produces; the wrapper views rows 0-3 as f32.
//
// K5 (rtnr_winners_f32; standalone since rtnr_resolve_diff: its tests and the
// per-kernel table): replaces rtnr_tpu/ops/raster_pallas4.py::
// _compact_kernel (wrapper compact_rows_by_rank) together with the XLA work
// before it in the differentiable forward (raster_diff.py:246-276: head-depth
// broadcast, band mask, inclusive f32 prefix sums, winner ranks). One kernel
// does the whole job, as K1 does for integers: input is the same sorted
// stream with f32 colour lanes (n, 3); each segment head walks its own band
// prefix, accumulates r, g, b and count in f64 and rounds each ONCE to f32,
// then writes them (as bit patterns), the head depth bits and the pixel id at
// column = winner rank (the same three-launch head-count scan; the total
// stays on the device). The sums run in stream order, as the plain twin's
// index_add_ does on the CPU, so the kernel equals it bit for bit on any
// colours (f64 sums of integer colours are exact in any order, so also the
// twin on the card, whose atomics add in any order), and equals the JAX
// package wherever JAX's f32 prefixes are exact (integer colours, prefix
// < 2^24); at 5M points JAX's global prefixes reach ~6e8, where f32 steps
// are 64 apart. Bound on this card: bytes. ~20 B read per point (pix, z bits,
// 12 B of colour, the neighbour's pix) plus 24 B written per winner: ~0.15
// GB at 5M points / 1080p, ~45 us at 3.35 TB/s. As in K1, one thread walks
// a very long segment, which is slow but exact.
//
// K6 (rtnr_winners5, standalone since rtnr_resolve5: its tests and the
// per-kernel table): rtnr_tpu/ops/raster_pallas5.py::_winners_kernel5 as a
// winner image. Input: the carrier-free stream sorted by pixel id ONLY, so
// depth order inside a segment is arbitrary. Each head walks its segment twice: first the min of
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

// the tile skeleton of rtnr_resolve4, rtnr_resolve5 and rtnr_expand; the
// sizes come from sweeps on the card (PERF.md): smaller tiles and blocks were
// faster
#define TILE_P 512          // output pixels a tile owns
#define TILE_THREADS 128
#define TILES_PER_BLOCK 3   // consecutive tiles a block resolves in turn
#define TILE_ELEMS 4        // consecutive stream elements a thread holds (one 16-byte load)
#define TILE_CHUNK (TILE_THREADS * TILE_ELEMS)  // stream elements a block works per step
static_assert(TILES_PER_BLOCK + 1 <= TILE_THREADS / 32, "one warp a window bound");
static_assert(TILE_P % 4 == 0, "16-byte stores of whole tiles");
static_assert(TILE_ELEMS % 4 == 0, "16-byte loads of whole groups");
#define TILE_SMEM (5 * TILE_P * 4)     // rows r, g, b, count, depth bits
#define MIN_EMPTY 0x7FFFFFFF           // rtnr_resolve5's depth row before any element: above +inf
#define FULL_MASK 0xffffffffu

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

// ---- the tile skeleton: rtnr_resolve4 (the stream) and rtnr_expand (winner rows) ----

// First i in [0, n] with a[i] >= v (a ascending), found by one full warp:
// each step probes 32 positions spread over [lo, hi) and keeps the part
// between the last probe below v and the first at or above it (~1/33 of
// the range), so 5M elements take 5 dependent loads.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ a, int n, int v,
                                                int lane) {
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int pos = lo + (int)(((long long)(hi - lo) * (lane + 1)) / 33);
    const unsigned m = __ballot_sync(FULL_MASK, a[pos] >= v);
    if (m == 0u) {
      lo = __shfl_sync(FULL_MASK, pos, 31) + 1;
    } else {
      const int f = __ffs(m) - 1;
      const int below = __shfl_sync(FULL_MASK, pos, f > 0 ? f - 1 : 0);
      hi = __shfl_sync(FULL_MASK, pos, f);
      if (f > 0) lo = below + 1;
    }
  }
  const int i = lo + lane;
  const unsigned m = __ballot_sync(FULL_MASK, i < hi && a[i] >= v);
  return m ? lo + __ffs(m) - 1 : hi;
}

// Warps 0..TILES_PER_BLOCK find, all at once, the windows of the block's
// tiles: win[j] = lower_bound(a, min((tile0 + j) * TILE_P, hw)), so tile
// tile0 + j reads [win[j], win[j + 1]) (read after the next barrier).
__device__ __forceinline__ void tile_windows(const int* __restrict__ a, int n, int tile0, int hw,
                                             int* win) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp <= TILES_PER_BLOCK) {
    const int w = warp_lower_bound(a, n, min((tile0 + warp) * TILE_P, hw), lane);
    if (lane == 0) win[warp] = w;
  }
}

// The tile's five rows at the empty defaults: sums and count 0, depth
// FLT_MAX (or rtnr_resolve5's MIN_EMPTY, the start of its running minimum).
__device__ __forceinline__ void tile_init(int* tile, int depth0 = FLT_MAX_BITS) {
  int4* v = reinterpret_cast<int4*>(tile);
  const int4 zero = make_int4(0, 0, 0, 0);
  const int4 fmax = make_int4(depth0, depth0, depth0, depth0);
  for (int i = threadIdx.x; i < TILE_SMEM / 16; i += TILE_THREADS) v[i] = i < TILE_P ? zero : fmax;
}

__device__ __forceinline__ void store4(int* dst, int avail, const int v[4]) {
  if (avail >= 4) {
    *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < avail) dst[j] = v[j];
  }
}

// The tile's pixels [q0, q1) to the outputs, 16 bytes a store (q0 is a
// multiple of 4, so is 3 * q0): packed rgb (integer average) and depth, or
// sums (HW, 3), count and depth. MIN_ROW: the depth row was a running
// minimum from MIN_EMPTY, which an empty pixel still holds.
template <bool PACKED, bool MIN_ROW = false>
__device__ __forceinline__ void tile_store(const int* tile, int q0, int q1, int* __restrict__ out0,
                                           int* __restrict__ out_cnt, int* __restrict__ out_depth) {
  const int* tr = tile;
  const int* tg = tile + TILE_P;
  const int* tb = tile + 2 * TILE_P;
  const int* tc = tile + 3 * TILE_P;
  const int* td = tile + 4 * TILE_P;
  const int np = q1 - q0;
  for (int g = 4 * threadIdx.x; g < np; g += 4 * TILE_THREADS) {
    const int4 c4 = *reinterpret_cast<const int4*>(tc + g);
    const int4 d4 = *reinterpret_cast<const int4*>(td + g);
    const int cnt[4] = {c4.x, c4.y, c4.z, c4.w};
    int dep[4] = {d4.x, d4.y, d4.z, d4.w};
    if (MIN_ROW) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (dep[j] == MIN_EMPTY) dep[j] = FLT_MAX_BITS;  // a pixel no element reached
    }
    store4(out_depth + q0 + g, np - g, dep);
    if (PACKED) {
      const int4 r4 = *reinterpret_cast<const int4*>(tr + g);
      const int4 g4 = *reinterpret_cast<const int4*>(tg + g);
      const int4 b4 = *reinterpret_cast<const int4*>(tb + g);
      const int r[4] = {r4.x, r4.y, r4.z, r4.w};
      const int gg[4] = {g4.x, g4.y, g4.z, g4.w};
      const int b[4] = {b4.x, b4.y, b4.z, b4.w};
      int pk[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // sums and counts are non-negative: unsigned division gives the same quotient
        const unsigned c = cnt[j] > 0 ? (unsigned)cnt[j] : 1u;
        pk[j] = cnt[j] > 0 ? (int)(((unsigned)r[j] / c) | (((unsigned)gg[j] / c) << 8) |
                                   (((unsigned)b[j] / c) << 16))
                           : 0;
      }
      store4(out0 + q0 + g, np - g, pk);
    } else {
      store4(out_cnt + q0 + g, np - g, cnt);
    }
  }
  if (!PACKED) {
    const int ns = 3 * np;
    int* o = out0 + 3 * (size_t)q0;
    for (int j = 4 * threadIdx.x; j < ns; j += 4 * TILE_THREADS) {
      int v[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int f = min(j + m, ns - 1);
        const int px = f / 3, ch = f - 3 * px;
        v[m] = ch == 0 ? tr[px] : (ch == 1 ? tg[px] : tb[px]);
      }
      store4(o + j, ns - j, v);
    }
  }
}

// TILE_ELEMS consecutive elements of one int32 lane from index base (a
// multiple of 4): 16-byte loads where a group of 4 lies in the stream and the
// pointers are 16-byte aligned (vec), else one by one; past the end an element
// gets fill.
__device__ __forceinline__ void load_lane(const int* __restrict__ a, int n, int base, int vec,
                                          int fill, int v[TILE_ELEMS]) {
#pragma unroll
  for (int g = 0; g < TILE_ELEMS; g += 4) {
    const int b = base + g;
    if (vec && b + 4 <= n) {
      const int4 a4 = __ldg(reinterpret_cast<const int4*>(a + b));
      v[g] = a4.x; v[g + 1] = a4.y; v[g + 2] = a4.z; v[g + 3] = a4.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[g + j] = b + j < n ? a[b + j] : fill;
    }
  }
}

// The stream's three lanes from index base; past the end an element gets
// pixel INT_MAX, which no tile owns.
__device__ __forceinline__ void load_group(const int* __restrict__ pix,
                                           const int* __restrict__ zbits,
                                           const int* __restrict__ packed, int n, int base,
                                           int vec, int p[TILE_ELEMS], int z[TILE_ELEMS],
                                           int k[TILE_ELEMS]) {
  load_lane(pix, n, base, vec, 0x7FFFFFFF, p);
  load_lane(zbits, n, base, vec, 0, z);
  load_lane(packed, n, base, vec, 0, k);
}

// One tile of rtnr_resolve4: the stream window [s, e) into the tile (at its
// defaults), pixels [q0, q1). BAND_REF: the band of pixel p ends at
// band_ref[p] + band, not at its head's depth + band (the head still writes
// the depth row).
template <bool BAND_REF>
__device__ __forceinline__ void resolve4_window(const int* __restrict__ pix,
                                                const int* __restrict__ zbits,
                                                const int* __restrict__ packed, int n, int s,
                                                int e, int q0, int q1, float band, int vec,
                                                const float* __restrict__ band_ref, int* tile) {
  int* tr = tile;
  int* tg = tile + TILE_P;
  int* tb = tile + 2 * TILE_P;
  int* tc = tile + 3 * TILE_P;
  int* td = tile + 4 * TILE_P;
  const int lane = threadIdx.x & 31;
  int c = s & ~3;  // aligned down: the elements before the window have pix < q0
  int p[TILE_ELEMS], z[TILE_ELEMS], k[TILE_ELEMS];
  if (c < e) load_group(pix, zbits, packed, n, c + TILE_ELEMS * threadIdx.x, vec, p, z, k);
  for (; c < e; c += TILE_CHUNK) {
    const int base = c + TILE_ELEMS * threadIdx.x;
    const bool more = c + TILE_CHUNK < e;
    int np[TILE_ELEMS], nz[TILE_ELEMS], nk[TILE_ELEMS];
    if (more) load_group(pix, zbits, packed, n, base + TILE_CHUNK, vec, np, nz, nk);
    int prev = __shfl_up_sync(FULL_MASK, p[TILE_ELEMS - 1], 1);
    if (lane == 0) prev = (base > 0 && base <= n) ? pix[base - 1] : -1;
    // pass A: each head of the tile writes its depth bits (the minimum of its pixel)
#pragma unroll
    for (int j = 0; j < TILE_ELEMS; ++j) {
      if (p[j] >= q0 && p[j] < q1 && p[j] != prev) td[p[j] - q0] = z[j];
      prev = p[j];
    }
    __syncthreads();
    // pass B: the in-band elements, merged per pixel within the thread, into the tile.
    // A later chunk's pass A writes only pixels above every pixel of this chunk, so
    // it needs no barrier after this pass.
    int cur = -1, sr = 0, sg = 0, sb = 0, sc = 0;
    float lim = 0.0f;
#pragma unroll
    for (int j = 0; j < TILE_ELEMS; ++j) {
      if (p[j] < q0 || p[j] >= q1) continue;
      if (p[j] != cur) {
        if (sc > 0) {
          atomicAdd(tr + cur - q0, sr);
          atomicAdd(tg + cur - q0, sg);
          atomicAdd(tb + cur - q0, sb);
          atomicAdd(tc + cur - q0, sc);
        }
        cur = p[j];
        lim = __fadd_rn(BAND_REF ? __ldg(band_ref + cur) : __int_as_float(td[cur - q0]), band);
        sr = sg = sb = sc = 0;
      }
      if (!(__int_as_float(z[j]) > lim)) {
        sr += k[j] & 255;
        sg += (k[j] >> 8) & 255;
        sb += (k[j] >> 16) & 255;
        sc += 1;
      }
    }
    if (sc > 0) {
      atomicAdd(tr + cur - q0, sr);
      atomicAdd(tg + cur - q0, sg);
      atomicAdd(tb + cur - q0, sb);
      atomicAdd(tc + cur - q0, sc);
    }
    if (more) {
#pragma unroll
      for (int j = 0; j < TILE_ELEMS; ++j) {
        p[j] = np[j];
        z[j] = nz[j];
        k[j] = nk[j];
      }
    }
  }
}

// The block's tiles of rtnr_resolve4 (the body of both its kernels).
template <bool PACKED, bool BAND_REF>
__device__ __forceinline__ void resolve4_tiles(const int* __restrict__ pix,
                                               const int* __restrict__ zbits,
                                               const int* __restrict__ packed, int n, int hw,
                                               float band, int vec,
                                               const float* __restrict__ band_ref,
                                               int* __restrict__ out0, int* __restrict__ out_cnt,
                                               int* __restrict__ out_depth) {
  __shared__ int4 tile4[TILE_SMEM / 16];
  int* tile = reinterpret_cast<int*>(tile4);
  __shared__ int win[TILES_PER_BLOCK + 1];
  const int tile0 = blockIdx.x * TILES_PER_BLOCK;
  tile_windows(pix, n, tile0, hw, win);
  for (int j = 0; j < TILES_PER_BLOCK; ++j) {
    const int q0 = (tile0 + j) * TILE_P;
    if (q0 >= hw) break;
    const int q1 = min(q0 + TILE_P, hw);
    tile_init(tile);
    __syncthreads();
    resolve4_window<BAND_REF>(pix, zbits, packed, n, win[j], win[j + 1], q0, q1, band, vec,
                              band_ref, tile);
    __syncthreads();
    tile_store<PACKED>(tile, q0, q1, out0, out_cnt, out_depth);
    __syncthreads();  // the next tile's defaults overwrite this one
  }
}

template <bool PACKED>
__global__ void __launch_bounds__(TILE_THREADS)
resolve4_tile(const int* __restrict__ pix, const int* __restrict__ zbits,
              const int* __restrict__ packed, int n, int hw, float band, int vec,
              int* __restrict__ out0, int* __restrict__ out_cnt, int* __restrict__ out_depth) {
  resolve4_tiles<PACKED, false>(pix, zbits, packed, n, hw, band, vec, nullptr, out0, out_cnt,
                                out_depth);
}

// rtnr_resolve4's sums form with a band reference image (the point-sharded
// accumulate pass)
__global__ void __launch_bounds__(TILE_THREADS)
resolve4_ref_tile(const int* __restrict__ pix, const int* __restrict__ zbits,
                  const int* __restrict__ packed, int n, int hw, float band, int vec,
                  const float* __restrict__ band_ref, int* __restrict__ out0,
                  int* __restrict__ out_cnt, int* __restrict__ out_depth) {
  resolve4_tiles<false, true>(pix, zbits, packed, n, hw, band, vec, band_ref, out0, out_cnt,
                              out_depth);
}

// One tile of rtnr_resolve5: the window [s, e) of the pixel-only-sorted
// stream into the tile, pixels [q0, q1). Pass A streams the whole window and
// takes each pixel's minimum depth bits with shared-memory atomicMin
// (positive f32 and +inf order as their int32 bits); after one barrier, pass
// B streams it again and adds each element with !(z > zmin + band) into the
// tile, a thread's in-band run of one pixel merged first.
__device__ __forceinline__ void resolve5_window(const int* __restrict__ pix,
                                                const int* __restrict__ zbits,
                                                const int* __restrict__ packed, int n, int s,
                                                int e, int q0, int q1, float band, int vec,
                                                int* tile) {
  int* tr = tile;
  int* tg = tile + TILE_P;
  int* tb = tile + 2 * TILE_P;
  int* tc = tile + 3 * TILE_P;
  int* td = tile + 4 * TILE_P;
  const int c0 = s & ~3;  // aligned down: the elements before the window have pix < q0
  int p[TILE_ELEMS], z[TILE_ELEMS], k[TILE_ELEMS];
  // pass A: the minimum
  if (c0 < e) load_group(pix, zbits, packed, n, c0 + TILE_ELEMS * threadIdx.x, vec, p, z, k);
  for (int c = c0; c < e; c += TILE_CHUNK) {
    const bool more = c + TILE_CHUNK < e;
    int np[TILE_ELEMS], nz[TILE_ELEMS], nk[TILE_ELEMS];
    if (more) load_group(pix, zbits, packed, n, c + TILE_CHUNK + TILE_ELEMS * threadIdx.x, vec,
                         np, nz, nk);
    int cur = -1, zmin = MIN_EMPTY;
#pragma unroll
    for (int j = 0; j < TILE_ELEMS; ++j) {
      if (p[j] < q0 || p[j] >= q1) continue;
      if (p[j] != cur) {
        if (cur >= 0) atomicMin(td + cur - q0, zmin);
        cur = p[j];
        zmin = z[j];
      } else {
        zmin = min(zmin, z[j]);
      }
    }
    if (cur >= 0) atomicMin(td + cur - q0, zmin);
    if (more) {
#pragma unroll
      for (int j = 0; j < TILE_ELEMS; ++j) {
        p[j] = np[j];
        z[j] = nz[j];
        k[j] = nk[j];
      }
    }
  }
  __syncthreads();  // every pixel's minimum is final before any band test
  // pass B: the band sums (the window again, from L2)
  if (c0 < e) load_group(pix, zbits, packed, n, c0 + TILE_ELEMS * threadIdx.x, vec, p, z, k);
  for (int c = c0; c < e; c += TILE_CHUNK) {
    const bool more = c + TILE_CHUNK < e;
    int np[TILE_ELEMS], nz[TILE_ELEMS], nk[TILE_ELEMS];
    if (more) load_group(pix, zbits, packed, n, c + TILE_CHUNK + TILE_ELEMS * threadIdx.x, vec,
                         np, nz, nk);
    int cur = -1, sr = 0, sg = 0, sb = 0, sc = 0;
    float lim = 0.0f;
#pragma unroll
    for (int j = 0; j < TILE_ELEMS; ++j) {
      if (p[j] < q0 || p[j] >= q1) continue;
      if (p[j] != cur) {
        if (sc > 0) {
          atomicAdd(tr + cur - q0, sr);
          atomicAdd(tg + cur - q0, sg);
          atomicAdd(tb + cur - q0, sb);
          atomicAdd(tc + cur - q0, sc);
        }
        cur = p[j];
        lim = __fadd_rn(__int_as_float(td[cur - q0]), band);
        sr = sg = sb = sc = 0;
      }
      if (!(__int_as_float(z[j]) > lim)) {
        sr += k[j] & 255;
        sg += (k[j] >> 8) & 255;
        sb += (k[j] >> 16) & 255;
        sc += 1;
      }
    }
    if (sc > 0) {
      atomicAdd(tr + cur - q0, sr);
      atomicAdd(tg + cur - q0, sg);
      atomicAdd(tb + cur - q0, sb);
      atomicAdd(tc + cur - q0, sc);
    }
    if (more) {
#pragma unroll
      for (int j = 0; j < TILE_ELEMS; ++j) {
        p[j] = np[j];
        z[j] = nz[j];
        k[j] = nk[j];
      }
    }
  }
}

template <bool PACKED>
__global__ void __launch_bounds__(TILE_THREADS)
resolve5_tile(const int* __restrict__ pix, const int* __restrict__ zbits,
              const int* __restrict__ packed, int n, int hw, float band, int vec,
              int* __restrict__ out0, int* __restrict__ out_cnt, int* __restrict__ out_depth) {
  __shared__ int4 tile4[TILE_SMEM / 16];
  int* tile = reinterpret_cast<int*>(tile4);
  __shared__ int win[TILES_PER_BLOCK + 1];
  const int tile0 = blockIdx.x * TILES_PER_BLOCK;
  tile_windows(pix, n, tile0, hw, win);
  for (int j = 0; j < TILES_PER_BLOCK; ++j) {
    const int q0 = (tile0 + j) * TILE_P;
    if (q0 >= hw) break;
    const int q1 = min(q0 + TILE_P, hw);
    tile_init(tile, MIN_EMPTY);
    __syncthreads();
    resolve5_window(pix, zbits, packed, n, win[j], win[j + 1], q0, q1, band, vec, tile);
    __syncthreads();
    tile_store<PACKED, true>(tile, q0, q1, out0, out_cnt, out_depth);
    __syncthreads();  // the next tile's defaults overwrite this one
  }
}

// ---- rtnr_resolve_diff: K5 and K2 float_sums in one tile kernel ----

// The walk of winners_write_f32: adds elements k, k+1, ... of pixel ph's
// segment while they lie in its band (z <= lim), r, g, b and count in f64 with
// __dadd_rn, in stream order.
__device__ __forceinline__ void walk_band(const int* __restrict__ pix,
                                          const int* __restrict__ zbits,
                                          const float* __restrict__ rgb, int n, int k, int ph,
                                          float lim, double acc[4]) {
  for (; k < n; ++k) {
    if (__ldg(pix + k) != ph || __int_as_float(__ldg(zbits + k)) > lim) break;
    const float* q = rgb + 3 * (size_t)k;
    acc[0] = __dadd_rn(acc[0], (double)__ldg(q));
    acc[1] = __dadd_rn(acc[1], (double)__ldg(q + 1));
    acc[2] = __dadd_rn(acc[2], (double)__ldg(q + 2));
    acc[3] = __dadd_rn(acc[3], 1.0);
  }
}

// A pixel's tile column: each sum rounded once to f32, and the head's depth bits.
__device__ __forceinline__ void write_column(int* tile, int col, const double acc[4], int zh) {
#pragma unroll
  for (int row = 0; row < 4; ++row)
    tile[row * TILE_P + col] = __float_as_int(__double2float_rn(acc[row]));
  tile[4 * TILE_P + col] = zh;
}

// One tile of rtnr_resolve_diff: the window [s, e) of the (pixel, depth)-sorted
// stream, pixels [q0, q1). Per chunk, each thread marks the heads among its
// elements (pix[i] != pix[i-1], as rtnr_resolve4's pass A) and walks them one
// after another: each walks its band prefix from L1/L2 in stream order
// (walk_band: the same additions in the same order as K5, so the same bits on
// any colours) and writes its pixel's column of the tile. One head a pixel,
// so no atomics and no barrier between chunks. BAND_REF: the band ends at
// band_ref[p] + band instead of the head's depth + band; depth ascends in a
// segment, so the walk is still a prefix (empty when the limit lies below the
// head: a zero column with the head's depth).
template <bool BAND_REF>
__device__ __forceinline__ void resolve_diff_window(const int* __restrict__ pix,
                                                    const int* __restrict__ zbits,
                                                    const float* __restrict__ rgb, int n, int s,
                                                    int e, int q0, int q1, float band, int vec,
                                                    const float* __restrict__ band_ref,
                                                    int* tile) {
  const int lane = threadIdx.x & 31;
  int c = s & ~3;  // aligned down: the elements before the window have pix < q0
  int p[TILE_ELEMS];
  if (c < e) load_lane(pix, n, c + TILE_ELEMS * threadIdx.x, vec, 0x7FFFFFFF, p);
  for (; c < e; c += TILE_CHUNK) {
    const int base = c + TILE_ELEMS * threadIdx.x;
    const bool more = c + TILE_CHUNK < e;
    int np[TILE_ELEMS];
    if (more) load_lane(pix, n, base + TILE_CHUNK, vec, 0x7FFFFFFF, np);
    int prev = __shfl_up_sync(FULL_MASK, p[TILE_ELEMS - 1], 1);
    if (lane == 0) prev = (base > 0 && base <= n) ? pix[base - 1] : -1;
    unsigned heads = 0u;
#pragma unroll
    for (int j = 0; j < TILE_ELEMS; ++j) {
      if (p[j] >= q0 && p[j] < q1 && p[j] != prev) heads |= 1u << j;
      prev = p[j];
    }
    while (heads) {  // the thread's heads one after another
      const int i = base + __ffs(heads) - 1;
      heads &= heads - 1u;
      const int ph = __ldg(pix + i), zh = __ldg(zbits + i);
      double acc[4] = {0.0, 0.0, 0.0, 0.0};
      const float ref = BAND_REF ? __ldg(band_ref + ph) : __int_as_float(zh);
      walk_band(pix, zbits, rgb, n, i, ph, __fadd_rn(ref, band), acc);
      write_column(tile, ph - q0, acc, zh);
    }
    if (more) {
#pragma unroll
      for (int j = 0; j < TILE_ELEMS; ++j) p[j] = np[j];
    }
  }
}

// BAND_REF: rtnr_resolve_diff with a band reference image (the point-sharded
// forward's second pass); without it band_ref is not read.
template <bool BAND_REF>
__global__ void __launch_bounds__(TILE_THREADS)
resolve_diff_tile(const int* __restrict__ pix, const int* __restrict__ zbits,
                  const float* __restrict__ rgb, int n, int hw, float band, int vec,
                  const float* __restrict__ band_ref, int* __restrict__ sums,
                  int* __restrict__ count, int* __restrict__ depth) {
  __shared__ int4 tile4[TILE_SMEM / 16];
  int* tile = reinterpret_cast<int*>(tile4);
  __shared__ int win[TILES_PER_BLOCK + 1];
  const int tile0 = blockIdx.x * TILES_PER_BLOCK;
  tile_windows(pix, n, tile0, hw, win);
  for (int j = 0; j < TILES_PER_BLOCK; ++j) {
    const int q0 = (tile0 + j) * TILE_P;
    if (q0 >= hw) break;
    const int q1 = min(q0 + TILE_P, hw);
    tile_init(tile);
    __syncthreads();
    resolve_diff_window<BAND_REF>(pix, zbits, rgb, n, win[j], win[j + 1], q0, q1, band, vec,
                                  band_ref, tile);
    __syncthreads();
    tile_store<false>(tile, q0, q1, sums, count, depth);
    __syncthreads();  // the next tile's defaults overwrite this one
  }
}

template <bool PACKED>
__global__ void __launch_bounds__(TILE_THREADS)
expand_tile(const int* __restrict__ wimg, int cap, const int* __restrict__ total_p, int hw,
            int* __restrict__ out0, int* __restrict__ out_cnt, int* __restrict__ out_depth) {
  __shared__ int4 tile4[TILE_SMEM / 16];
  int* tile = reinterpret_cast<int*>(tile4);
  __shared__ int win[TILES_PER_BLOCK + 1];
  const int tile0 = blockIdx.x * TILES_PER_BLOCK;
  const int* __restrict__ wpix = wimg + 5 * (size_t)cap;
  tile_windows(wpix, *total_p, tile0, hw, win);
  for (int t = 0; t < TILES_PER_BLOCK; ++t) {
    const int q0 = (tile0 + t) * TILE_P;
    if (q0 >= hw) break;
    const int q1 = min(q0 + TILE_P, hw);
    tile_init(tile);
    __syncthreads();
    const int e = win[t + 1];
    for (int j = win[t] + threadIdx.x; j < e; j += TILE_THREADS) {
      const int q = wpix[j] - q0;
#pragma unroll
      for (int row = 0; row < 5; ++row) tile[row * TILE_P + q] = wimg[row * (size_t)cap + j];
    }
    __syncthreads();
    tile_store<PACKED>(tile, q0, q1, out0, out_cnt, out_depth);
    __syncthreads();  // the next tile's defaults overwrite this one
  }
}

static int tile_blocks(int hw) {
  const int tiles = (hw + TILE_P - 1) / TILE_P;
  return (tiles + TILES_PER_BLOCK - 1) / TILES_PER_BLOCK;
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

// band_ref: NULL, or a (hw,) f32 image that ends each pixel's band (the sums
// form only: with packed_out it is refused)
extern "C" int rtnr_resolve4(const void* pix, const void* zbits, const void* packed, int n,
                             int hw, float band, int vec, int packed_out, void* out0,
                             void* out_cnt, void* out_depth, const void* band_ref,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (band_ref && packed_out) return (int)cudaErrorInvalidValue;
  const int blocks = tile_blocks(hw);
  if (blocks == 0) return 0;
  if (band_ref) {
    resolve4_ref_tile<<<blocks, TILE_THREADS, 0, s>>>(
        (const int*)pix, (const int*)zbits, (const int*)packed, n, hw, band, vec,
        (const float*)band_ref, (int*)out0, (int*)out_cnt, (int*)out_depth);
  } else if (packed_out) {
    resolve4_tile<true><<<blocks, TILE_THREADS, 0, s>>>(
        (const int*)pix, (const int*)zbits, (const int*)packed, n, hw, band, vec, (int*)out0,
        (int*)out_cnt, (int*)out_depth);
  } else {
    resolve4_tile<false><<<blocks, TILE_THREADS, 0, s>>>(
        (const int*)pix, (const int*)zbits, (const int*)packed, n, hw, band, vec, (int*)out0,
        (int*)out_cnt, (int*)out_depth);
  }
  return (int)cudaGetLastError();
}

extern "C" int rtnr_resolve5(const void* pix, const void* zbits, const void* packed, int n,
                             int hw, float band, int vec, int packed_out, void* out0,
                             void* out_cnt, void* out_depth, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = tile_blocks(hw);
  if (blocks == 0) return 0;
  if (packed_out) {
    resolve5_tile<true><<<blocks, TILE_THREADS, 0, s>>>(
        (const int*)pix, (const int*)zbits, (const int*)packed, n, hw, band, vec, (int*)out0,
        (int*)out_cnt, (int*)out_depth);
  } else {
    resolve5_tile<false><<<blocks, TILE_THREADS, 0, s>>>(
        (const int*)pix, (const int*)zbits, (const int*)packed, n, hw, band, vec, (int*)out0,
        (int*)out_cnt, (int*)out_depth);
  }
  return (int)cudaGetLastError();
}

// band_ref: NULL, or a (hw,) f32 image that ends each pixel's band
extern "C" int rtnr_resolve_diff(const void* pix, const void* zbits, const void* rgb, int n,
                                 int hw, float band, int vec, void* sums, void* count,
                                 void* depth, const void* band_ref, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = tile_blocks(hw);
  if (blocks == 0) return 0;
  if (band_ref) {
    resolve_diff_tile<true><<<blocks, TILE_THREADS, 0, s>>>(
        (const int*)pix, (const int*)zbits, (const float*)rgb, n, hw, band, vec,
        (const float*)band_ref, (int*)sums, (int*)count, (int*)depth);
  } else {
    resolve_diff_tile<false><<<blocks, TILE_THREADS, 0, s>>>(
        (const int*)pix, (const int*)zbits, (const float*)rgb, n, hw, band, vec, nullptr,
        (int*)sums, (int*)count, (int*)depth);
  }
  return (int)cudaGetLastError();
}

extern "C" int rtnr_expand(const void* wimg, int cap, const void* total, int hw,
                           int packed_out, void* out0, void* out_cnt, void* out_depth,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = tile_blocks(hw);
  if (blocks == 0) return 0;
  if (packed_out) {
    expand_tile<true><<<blocks, TILE_THREADS, 0, s>>>(
        (const int*)wimg, cap, (const int*)total, hw, (int*)out0, (int*)out_cnt,
        (int*)out_depth);
  } else {
    expand_tile<false><<<blocks, TILE_THREADS, 0, s>>>(
        (const int*)wimg, cap, (const int*)total, hw, (int*)out0, (int*)out_cnt,
        (int*)out_depth);
  }
  return (int)cudaGetLastError();
}
