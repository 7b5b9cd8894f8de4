// K3: zebra, false colour and focus peaking in one pass over a planar
// frame, for Hopper (sm_90a).
//
// Replaces obs_color_monitor_tpu/ops/pallas_overlays.py::_ov_kernel (:173,
// launched by fused_overlays_planes :208).  Input: planar (4, H, W) u8.
// Outputs, each optional (a null pointer skips its stores, the same for
// every thread): the three overlays as planar (4, H, W) u8, or with
// packed_out as (H, W) 32-bit packed RGBA (byte 0 = R).  The optional rect
// (x0, y0, x1, y1) clamps the focus-peaking neighbours at its borders and
// anchors the zebra phase at its origin, tm - (float)(x0 + y0), one
// float32 subtraction as in pallas_overlays.py:81.  The rect is a (4,)
// int32 in device memory that one thread of each block reads and clamps
// (dyn_rect.cuh), so a new rect changes no launch and the host never reads
// it; a null rect is the whole frame.  The clock tm is a float32 in device
// memory too, which every thread loads before the tile copy and uses after
// it (the copy hides the load), so a CUDA graph of a step replays any
// clock.
//
// What bounds it: bytes.  At the dock's 1920x1080 capture with packed_out
// it reads 8.3 MB and writes 24.9 MB (0.0099 ms at 3.35 TB/s); at 4K full
// resolution four times that.  The overlay rules cost a few dozen integer
// operations per pixel, and written pixel by pixel (overlay_math.cuh's
// overlay_pixel, which K1 runs) they, not the bytes, set the pace.  So:
//   * the tile machinery is K1's (tile_pass.cuh): a block of 256 threads
//     copies a 32 x 128 tile of the four planes and its 1-pixel halo into
//     shared memory, with 16-byte cp.async chunks when the base and the
//     rows are 16-byte aligned (W % 16 == 0), else one plain load per byte;
//   * each thread takes runs of 4 consecutive pixels of a row (a warp takes
//     one tile row of 128 pixels) and computes them on whole words: the
//     run's four channel words give its four RGBA pixel words by a byte
//     transpose; focus peaking takes the 12 |neighbour - centre| bytes of
//     each pixel with per-byte absolute differences (VABSDIFF4) on the
//     channel words and sums them in 16-bit lanes; luma is two dp4a per
//     pixel (each Q12 coefficient split into its high and low byte); the
//     false-colour band is one lookup in a 256-entry table by luma >> 12
//     and one compare (the wrapper builds the table and checks that no
//     bucket holds two band bounds).  About half the instructions of the
//     per-pixel form; the same bytes out;
//   * each output of a run is one store: with packed_out 16 bytes (4 pixels
//     x 4 bytes), on planes one 4-byte word per plane, byte by byte only
//     where W % 4 != 0;
//   * the false-colour band colours and the band table sit in shared
//     memory (a warp whose pixels span several bands reads them in one
//     access), the rect in one shared copy per block;
//   * the 32 x 128 tile is chosen for the dock's 1920x1080 capture: 15 x 34
//     = 510 blocks, one wave of the 528 that 132 SMs hold at 4 blocks each
//     (16 x 256 tiles would give 544 blocks, a 16-block second wave).
// The wrapper (ops/fused_overlays.py::overlay_plan) picks the forms and the
// grid.
#include <cuda_runtime.h>

#include <cstdint>

#include "dyn_rect.cuh"
#include "overlay_math.cuh"
#include "tile_pass.cuh"

// Mirrors obs_color_monitor_tpu_torch/ops/fused_overlays.py::OverlayLaunch.
struct OverlayLaunch {
  int vec;         // 1: 16-byte cp.async tile copies (W % 16 == 0, 16-byte aligned base)
  int packed_out;  // 1: outputs (H, W) 32-bit packed RGBA; 0: planar (4, H, W) u8
  int word;        // 1: W % 4 == 0, so every run's stores are whole words
  int tiles_x, tiles_y;
};

namespace {

using K3Tile = TileShape<128, 32, 256>;
constexpr int RUNS_X = K3Tile::TW / RUN;              // runs across a tile row: one warp
constexpr int ROW_GROUPS = K3Tile::THREADS / RUNS_X;  // tile rows taken at a time
constexpr int FC_BUCKETS = 256;                       // false-colour band table: luma >> 12
static_assert(K3Tile::THREADS == FC_BUCKETS, "one thread copies one band-table entry");

// One output's RUN pixels from (x, y) on.  Packed: px[j] is pixel x + j's
// RGBA word; one 16-byte store when the run is whole and aligned (word),
// else a 4-byte store per pixel inside the frame.  Planar: px[ch] holds
// plane ch's RUN bytes (byte j = pixel x + j); store_run per plane.
template <bool PACKED_OUT>
__device__ __forceinline__ void store_output(uint8_t* __restrict__ out, int H, int W, int x, int y,
                                             const uint32_t px[RUN], bool word) {
  if (PACKED_OUT) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(out) + (size_t)y * W + x;
    if (word) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(px[0], px[1], px[2], px[3]);
    } else {
#pragma unroll
      for (int j = 0; j < RUN; ++j)
        if (x + j < W) dst[j] = px[j];
    }
  } else {
    const size_t plane = (size_t)H * W;
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) store_run(out + ch * plane, W, x, y, px[ch], word);
  }
}

// The 4x4 byte transpose: 4 channel words (byte j = pixel j) <-> 4 pixel
// RGBA words (byte ch = channel ch), 8 byte permutes.
__device__ __forceinline__ void transpose4(uint32_t w[4]) {
  const uint32_t a = __byte_perm(w[0], w[1], 0x5140), b = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t c = __byte_perm(w[2], w[3], 0x5140), d = __byte_perm(w[2], w[3], 0x7362);
  w[0] = __byte_perm(a, c, 0x5410);
  w[1] = __byte_perm(a, c, 0x7632);
  w[2] = __byte_perm(b, d, 0x5410);
  w[3] = __byte_perm(b, d, 0x7632);
}

// Q12 luma coefficients as two byte vectors (R, G, B, 0): k = 256 * hi + lo
// per channel, so luma = 256 * dp4a(px, hi) + dp4a(px, lo), exact (the
// wrapper checks 0 <= k < 65536).
__device__ __forceinline__ void split_coef(const int k[3], uint32_t& hi, uint32_t& lo) {
  hi = (uint32_t)(k[0] >> 8) | (uint32_t)(k[1] >> 8) << 8 | (uint32_t)(k[2] >> 8) << 16;
  lo = (uint32_t)(k[0] & 255) | (uint32_t)(k[1] & 255) << 8 | (uint32_t)(k[2] & 255) << 16;
}

__device__ __forceinline__ int luma_of(uint32_t px, uint32_t hi, uint32_t lo) {
  return (int)(__dp4a(px, hi, 0u) * 256u + __dp4a(px, lo, 0u));
}

// 4 blocks per SM: at most 64 registers a thread
template <bool VEC, bool PACKED_OUT>
__global__ void __launch_bounds__(K3Tile::THREADS, 4)
overlay_tile_kernel(const uint8_t* __restrict__ planes, const OverlayParams op,
                    const float* __restrict__ tm,
                    const int* __restrict__ rect, const uint32_t* __restrict__ fc_buckets,
                    const bool word, uint8_t* __restrict__ zb, uint8_t* __restrict__ fc,
                    uint8_t* __restrict__ fp) {
  __shared__ __align__(16) uint8_t smem[K3Tile::PL_SMEM];
  __shared__ uint32_t fc_table[12];  // false colour's band colours, RGBA words
  // false colour's band by luma >> 12: (bands below the bucket << 20) | the
  // one band bound inside it (0xFFFFF: none); ops/fused_overlays.py builds it
  __shared__ uint32_t fc_bucket[FC_BUCKETS];
  __shared__ DynRect s_rect;
  const int H = op.h, W = op.w;
  // the clock, issued now and first used after the tile copy, which hides
  // the load
  const float tm_raw = __ldg(tm);
  const int x0 = blockIdx.x * K3Tile::TW, y0 = blockIdx.y * K3Tile::TH;
  if (threadIdx.x < 12) fc_table[threadIdx.x] = fc_color_word(op, threadIdx.x);
  fc_bucket[threadIdx.x] = __ldg(fc_buckets + threadIdx.x);
  if (threadIdx.x == 0)
    s_rect = rect != nullptr ? load_dyn_rect(rect, W, H) : DynRect{0, 0, W, H};
  load_tile<K3Tile, false, VEC>(planes, H, W, x0, y0, smem);  // ends with a barrier
  const DynRect r = s_rect;
  // the zebra phase anchored at the rect origin: one float32 subtraction
  // from the clock in device memory (a graph replays any clock)
  const float tm_r = __fsub_rn(tm_raw, (float)(r.x0 + r.y0));
  uint32_t kzh, kzl, kfh, kfl;
  split_coef(op.kl_zb, kzh, kzl);
  split_coef(op.kl_fc, kfh, kfl);
  const uint32_t peak_word = (uint32_t)op.peak_rgba[0] | (uint32_t)op.peak_rgba[1] << 8 |
                             (uint32_t)op.peak_rgba[2] << 16 | (uint32_t)op.peak_rgba[3] << 24;

  // a thread takes runs at column cx of rows ty, ty + ROW_GROUPS, ...
  const int cx = (threadIdx.x % RUNS_X) * RUN, ty = threadIdx.x / RUNS_X;
  const int x = x0 + cx;
  if (x >= W) return;
  // the byte masks of the run's left / right neighbours that count: those
  // inside the rect (the JAX focus_peaking_planes rule, which defines the
  // pixels outside it too)
  uint32_t ml = 0, mr = 0;
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    ml |= (x + j > r.x0 && x + j < r.x1) ? 0xFFu << (8 * j) : 0u;
    mr |= (x + j < r.x1 - 1) ? 0xFFu << (8 * j) : 0u;
  }
#pragma unroll 1
  for (int ry = ty; ry < K3Tile::TH; ry += ROW_GROUPS) {
    const int y = y0 + ry;
    if (y >= H) break;
    const bool has_u = y > r.y0 && y < r.y1, has_d = y < r.y1 - 1;
    const uint32_t* row = tile_words<K3Tile>(smem, ry + 1, cx);
    uint32_t px[4];  // channel words, then pixel words
#pragma unroll
    for (int k = 0; k < 4; ++k) px[k] = row[k * K3Tile::PL_PLANE_WORDS];
    // focus peaking: each pixel's 12 |neighbour - centre| bytes summed in
    // 16-bit lanes, pixels 0 and 2 in e, 1 and 3 in o (each <= 12 * 255)
    uint32_t e = 0, o = 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const uint32_t* w = row + k * K3Tile::PL_PLANE_WORDS;
      const uint32_t c = px[k];
      // a neighbour that does not count is replaced by the centre: |c - c| = 0
      const uint32_t l = (__byte_perm(w[-1], c, 0x6543) & ml) | (c & ~ml);
      const uint32_t rt = (__byte_perm(c, w[1], 0x4321) & mr) | (c & ~mr);
      const uint32_t u = has_u ? w[-K3Tile::PL_ROW_WORDS] : c;
      const uint32_t d = has_d ? w[K3Tile::PL_ROW_WORDS] : c;
      const uint32_t d0 = __vabsdiffu4(c, l), d1 = __vabsdiffu4(c, rt);
      const uint32_t d2 = __vabsdiffu4(c, u), d3 = __vabsdiffu4(c, d);
      e += (d0 & 0x00FF00FFu) + (d1 & 0x00FF00FFu) + (d2 & 0x00FF00FFu) + (d3 & 0x00FF00FFu);
      o += __byte_perm(d0, 0, 0x4341) + __byte_perm(d1, 0, 0x4341) + __byte_perm(d2, 0, 0x4341) +
           __byte_perm(d3, 0, 0x4341);
    }
    const int acc[RUN] = {(int)(e & 0xFFFF), (int)(o & 0xFFFF), (int)(e >> 16), (int)(o >> 16)};
    transpose4(px);
    uint32_t z[RUN], f[RUN], k[RUN];
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      const uint32_t p = px[j];
      // zebra: stripes where th_low <= luma <= th_high and phase mod 6 < 3
      // (overlay_math.cuh's rule: one float32 add, never contracted)
      const int luma_zb = luma_of(p, kzh, kzl);
      int phase = (int)floorf(__fadd_rn((float)(x + j + y + 1), tm_r)) % 6;
      if (phase < 0) phase += 6;  // floored modulo, as JAX's %
      z[j] = luma_zb >= op.zb_lo && luma_zb <= op.zb_hi && phase < 3 ? 0xFF000000u : p;
      // false colour: band = number of upper bounds <= luma
      const int luma_fc = luma_of(p, kfh, kfl);
      const uint32_t b = fc_bucket[luma_fc >> 12];
      f[j] = fc_table[(b >> 20) + (luma_fc >= (int)(b & 0xFFFFFu))];
      // focus peaking: the peak colour where the sum reaches the threshold
      k[j] = acc[j] >= op.peak_th ? peak_word : p;
    }
    if (!PACKED_OUT) {  // pixel words -> plane words
      transpose4(z);
      transpose4(f);
      transpose4(k);
    }
    if (zb != nullptr) store_output<PACKED_OUT>(zb, H, W, x, y, z, word);
    if (fc != nullptr) store_output<PACKED_OUT>(fc, H, W, x, y, f, word);
    if (fp != nullptr) store_output<PACKED_OUT>(fp, H, W, x, y, k, word);
  }
}

template <bool VEC, bool PACKED_OUT>
cudaError_t launch(const OverlayParams& op, const OverlayLaunch& lp, const void* planes,
                   const float* tm, const int* rect, const uint32_t* fc_buckets, void* zb, void* fc,
                   void* fp, cudaStream_t st) {
  overlay_tile_kernel<VEC, PACKED_OUT><<<dim3(lp.tiles_x, lp.tiles_y), K3Tile::THREADS, 0, st>>>(
      (const uint8_t*)planes, op, tm, rect, fc_buckets, lp.word != 0, (uint8_t*)zb, (uint8_t*)fc,
      (uint8_t*)fp);
  return cudaGetLastError();
}

}  // namespace

// planes: (4, op->h, op->w) u8.  rect: a (4,) int32 (x0, y0, x1, y1) in
// device memory, clamped by the kernel, or null for the whole frame.  tm:
// the zebra clock before the rect's anchor, one float32 in device memory.
// fc_buckets: the 256-word false-colour band table in device memory
// (ops/fused_overlays.py::fc_bucket_table).  zb/fc/fp may each be null.  The grid and forms come
// from OverlayLaunch (ops/fused_overlays.py::overlay_plan).  Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int ocm_fused_overlays(const OverlayParams* op, const OverlayLaunch* lp,
                                  const void* planes, const void* tm, const void* rect,
                                  const void* fc_buckets, void* zb, void* fc, void* fp,
                                  void* stream) {
  if (lp->tiles_x == 0 || lp->tiles_y == 0) return 0;  // an empty grid is not a valid launch
  const cudaStream_t st = (cudaStream_t)stream;
  const int* rc = (const int*)rect;
  const uint32_t* fb = (const uint32_t*)fc_buckets;
  const float* t = (const float*)tm;
  cudaError_t err;
  if (lp->packed_out)
    err = lp->vec ? launch<true, true>(*op, *lp, planes, t, rc, fb, zb, fc, fp, st)
                  : launch<false, true>(*op, *lp, planes, t, rc, fb, zb, fc, fp, st);
  else
    err = lp->vec ? launch<true, false>(*op, *lp, planes, t, rc, fb, zb, fc, fp, st)
                  : launch<false, false>(*op, *lp, planes, t, rc, fb, zb, fc, fp, st);
  return (int)err;
}
