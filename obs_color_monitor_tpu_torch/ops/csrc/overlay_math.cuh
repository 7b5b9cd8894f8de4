// Per-pixel math of the three overlay scopes: zebra, false colour and
// focus peaking (reference data/zebra.effect, data/falsecolor.effect,
// data/focuspeaking.effect).
//
// Replaces the shared band math of the TPU kernels,
// obs_color_monitor_tpu/ops/pallas_overlays.py::_overlay_band_math (:48),
// which both the frame-pipeline kernel (K1) and the standalone overlay
// kernel (K3) run.  Here it is one __device__ function on one pixel and
// its four neighbours (overlay_at), which K1 (frame_pipeline.cu) and K3
// (fused_overlays.cu) share.  Everything is integer except the zebra
// stripe phase, which is float32 as in the shader: floor((float)(x + y + 1)
// + tm), with x+y+1 exact in float32 and one rounding for the add, the same
// as the JAX op order ((x + y) + 1) + tm.
//
// The optional rect (x0, y0, x1, y1) of K3 moves the focus-peaking edge
// clamps to the rect borders, as pallas_overlays applies it (:135-158);
// K3 anchors the zebra phase at the rect origin by passing
// tm - (x0 + y0) (pallas_overlays.py:81).  Without a rect it is the whole
// frame.
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
// fc_table: the band colours as fc_color_word gives them, or null to read
// them from p.
__device__ __forceinline__ OverlayPixel overlay_pixel(
    const OverlayParams& p, int x, int y, float tm, const int c[4],
    const int l[4], const int r[4], const int u[4], const int d[4],
    bool has_l, bool has_r, bool has_u, bool has_d, const uint32_t* fc_table = nullptr) {
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
  if (fc_table != nullptr) {
    const uint32_t col = fc_table[band];
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) o.fc[ch] = (uint8_t)(col >> (8 * ch));
  } else {
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) o.fc[ch] = (uint8_t)p.fc_color[band * 4 + ch];
  }

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

// The three overlays of pixel (x, y) of a packed (H, W) 32-bit or planar
// (4, H, W) u8 frame.  A neighbour counts only inside the rect: the left
// one where x0 < x < x1, the right one where x < x1 - 1, the upper one
// where y0 < y < y1, the lower one where y < y1 - 1 (the JAX
// focus_peaking_planes rule, which defines pixels outside the rect too).
template <bool PACKED>
__device__ __forceinline__ OverlayPixel overlay_at(const void* __restrict__ frame,
                                                   const OverlayParams& p, int x, int y,
                                                   float tm, int x0, int y0, int x1, int y1) {
  int c[4], l[4] = {0}, r[4] = {0}, u[4] = {0}, d[4] = {0};
  load_px<PACKED>(frame, p.h, p.w, x, y, c);
  const bool has_l = x > x0 && x < x1, has_r = x < x1 - 1;
  const bool has_u = y > y0 && y < y1, has_d = y < y1 - 1;
  if (has_l) load_px<PACKED>(frame, p.h, p.w, x - 1, y, l);
  if (has_r) load_px<PACKED>(frame, p.h, p.w, x + 1, y, r);
  if (has_u) load_px<PACKED>(frame, p.h, p.w, x, y - 1, u);
  if (has_d) load_px<PACKED>(frame, p.h, p.w, x, y + 1, d);
  return overlay_pixel(p, x, y, tm, c, l, r, u, d, has_l, has_r, has_u, has_d);
}
