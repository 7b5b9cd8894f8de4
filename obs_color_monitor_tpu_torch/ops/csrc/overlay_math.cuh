// Per-pixel math of the three overlay scopes: zebra, false colour and
// focus peaking (reference data/zebra.effect, data/falsecolor.effect,
// data/focuspeaking.effect).
//
// Replaces the shared band math of the TPU kernels,
// obs_color_monitor_tpu/ops/pallas_overlays.py::_overlay_band_math (:48),
// which both the frame-pipeline kernel (K1) and the standalone overlay
// kernel (K3) run.  Here it is one __device__ function on one pixel and
// its four neighbours (overlay_pixel), which K1's tile pass
// (frame_pipeline.cu) calls on runs of pixels read from a tile in shared
// memory (tile_pass.cuh); K3 (fused_overlays.cu) computes the same rules on
// whole words of 4 pixels and shares OverlayParams and fc_color_word.
// Everything is integer except the zebra stripe phase, which is float32 as
// in the shader: floor((float)(x + y + 1) + tm), with x+y+1 exact in
// float32 and one rounding for the add, the same as the JAX op order
// ((x + y) + 1) + tm.
//
// The has_ flags carry the frame's edges, or a rect's: K3's optional rect
// (x0, y0, x1, y1) moves the focus-peaking edge clamps to the rect borders,
// as pallas_overlays applies it (:135-158), and anchors the zebra phase at
// the rect origin, tm - (x0 + y0) (pallas_overlays.py:81).
#pragma once

#include <cstdint>

// Mirrors obs_color_monitor_tpu_torch/ops/pipeline.py::OverlayParams
// (all int32, so ctypes and nvcc agree on the layout).
struct OverlayParams {
  int h, w;            // full-resolution frame
  int zb_lo, zb_hi;    // zebra luma window, fixed point (255 * 2^12 scale)
  int kl_zb[3];        // Q12 luma coefficients for the zebra colorspace
  int kl_fc[3];        // ... and for the false-colour colorspace
  int fc_thresh[11];   // false-colour band upper bounds (exclusive), ascending
  int fc_color[48];    // 12 bands x RGBA
  int peak_th;         // focus-peaking threshold on the sum of |diff|
  int peak_rgba[4];
};

struct OverlayPixel {
  uint8_t zb[4], fc[4], fp[4];
};

__device__ __forceinline__ int luma_fixed(const int k[3], const int c[4]) {
  return k[0] * c[0] + k[1] * c[1] + k[2] * c[2];
}

__device__ __forceinline__ int absdiff3(const int a[4], const int b[4]) {
  return abs(a[0] - b[0]) + abs(a[1] - b[1]) + abs(a[2] - b[2]);
}

// The 12 false-colour band colours packed as RGBA words (byte 0 = R), for a
// table in shared memory: a warp whose pixels fall in different bands reads
// a shared table in one access, where indexing the kernel parameter
// serializes one constant-cache access per band.
__device__ __forceinline__ uint32_t fc_color_word(const OverlayParams& p, int band) {
  const int* k = p.fc_color + 4 * band;
  return (uint32_t)k[0] | (uint32_t)k[1] << 8 | (uint32_t)k[2] << 16 | (uint32_t)k[3] << 24;
}

// c: the pixel (R, G, B, A); l/r/u/d: its left/right/upper/lower
// neighbours (RGB used), each valid only where its has_ flag is set (the
// edge clamp of the sampler makes a missing neighbour contribute 0).
// fc_table: the 12 band colours as fc_color_word gives them, in shared
// memory.
__device__ __forceinline__ OverlayPixel overlay_pixel(
    const OverlayParams& p, int x, int y, float tm, const int c[4],
    const int l[4], const int r[4], const int u[4], const int d[4],
    bool has_l, bool has_r, bool has_u, bool has_d, const uint32_t* fc_table) {
  OverlayPixel o;

  // zebra: stripes where th_low <= luma <= th_high and phase mod 6 < 3
  const int luma_zb = luma_fixed(p.kl_zb, c);
  // one float32 add, rounded to nearest, never contracted with anything
  int phase = (int)floorf(__fadd_rn((float)(x + y + 1), tm)) % 6;
  if (phase < 0) phase += 6;  // floored modulo, as JAX's %
  const bool stripe = luma_zb >= p.zb_lo && luma_zb <= p.zb_hi && phase < 3;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) o.zb[ch] = stripe ? 0 : (uint8_t)c[ch];
  o.zb[3] = stripe ? 255 : (uint8_t)c[3];

  // false colour: band = number of upper bounds <= luma
  const int luma_fc = luma_fixed(p.kl_fc, c);
  int band = 0;
#pragma unroll
  for (int i = 0; i < 11; ++i) band += luma_fc >= p.fc_thresh[i];
  const uint32_t col = fc_table[band];
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) o.fc[ch] = (uint8_t)(col >> (8 * ch));

  // focus peaking: 4-neighbour cross of |neighbour - centre| over RGB
  int acc = 0;
  if (has_l) acc += absdiff3(l, c);
  if (has_r) acc += absdiff3(r, c);
  if (has_u) acc += absdiff3(u, c);
  if (has_d) acc += absdiff3(d, c);
  const bool peak = acc >= p.peak_th;
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) o.fp[ch] = peak ? (uint8_t)p.peak_rgba[ch] : (uint8_t)c[ch];
  return o;
}

// Pixel (x, y) of a packed (h4, w4) 32-bit or planar (4, h4, w4) u8 frame
// in global memory, as (R, G, B, A) (K1's scale launch).
template <bool PACKED>
__device__ __forceinline__ void load_px(const void* __restrict__ frame, int h4, int w4,
                                        int x, int y, int out[4]) {
  const size_t i = (size_t)y * w4 + x;
  if (PACKED) {
    const uint32_t v = __ldg((const uint32_t*)frame + i);
    out[0] = v & 255;
    out[1] = (v >> 8) & 255;
    out[2] = (v >> 16) & 255;
    out[3] = v >> 24;
  } else {
    const uint8_t* f = (const uint8_t*)frame;
    const size_t plane = (size_t)h4 * w4;
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c] = __ldg(f + c * plane + i);
  }
}
