// K3: zebra, false colour and focus peaking in one pass over a planar
// frame, for Hopper (sm_90a).
//
// Replaces obs_color_monitor_tpu/ops/pallas_overlays.py::_ov_kernel (:173,
// launched by fused_overlays_planes :208).  Input: planar (4, H, W) u8.
// Outputs, each optional (a null pointer skips its stores): the three
// overlays as planar (4, H, W) u8, or with packed_out as (H, W) 32-bit
// packed RGBA (byte 0 = R), one 4-byte store per pixel.  The optional rect
// (x0, y0, x1, y1) clamps the focus-peaking neighbours at its borders and
// anchors the zebra phase at its origin: the kernel computes
// tm - (float)(x0 + y0) itself, one float32 subtraction as in
// pallas_overlays.py:81.  The rect is a (4,) int32 in device memory that
// every thread reads and clamps (dyn_rect.cuh), as K2 reads it, so a new
// rect changes no launch; a null rect is the whole frame.
// The per-pixel math is overlay_math.cuh's, which K1's overlay launch runs
// too.
//
// What bounds it: bytes.  At the dock's 1920x1080 capture with packed_out
// it reads 8.3 MB and writes 24.9 MB; at 4K full resolution four times
// that, against a few dozen integer operations per pixel.
//
// Differences from the Mosaic layout, and why: the TPU kernel sweeps
// 32-row blocks with 8-row halo blocks for the focus-peaking cross (Mosaic
// needs second-minor block dims divisible by 8), rolls lanes for the
// column neighbours, and pads H to the block.  Here one thread owns one
// pixel; a warp covers 32 consecutive pixels of a row, so every plane load
// and store is coalesced, and the four neighbours are plain loads that hit
// L1/L2 (the rows above and below were just read by neighbouring warps).
// No padding: threads past the edge return.
#include <cuda_runtime.h>

#include <cstdint>

#include "dyn_rect.cuh"
#include "overlay_math.cuh"

namespace {

__device__ __forceinline__ uint32_t pack_rgba(const uint8_t v[4]) {
  return (uint32_t)v[0] | ((uint32_t)v[1] << 8) | ((uint32_t)v[2] << 16) |
         ((uint32_t)v[3] << 24);
}

__device__ __forceinline__ void store(void* out, bool packed_out, size_t plane, size_t i,
                                      const uint8_t v[4]) {
  if (out == nullptr) return;
  if (packed_out) {
    ((uint32_t*)out)[i] = pack_rgba(v);
  } else {
    uint8_t* o = (uint8_t*)out;
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) o[ch * plane + i] = v[ch];
  }
}

__global__ void fused_overlays_kernel(const uint8_t* __restrict__ planes, const OverlayParams p,
                                      const float tm, const int* __restrict__ rect,
                                      const bool packed_out, void* zb, void* fc, void* fp) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= p.w || y >= p.h) return;
  const DynRect r = rect != nullptr ? load_dyn_rect(rect, p.w, p.h) : DynRect{0, 0, p.w, p.h};
  // the zebra phase anchored at the rect origin: one float32 subtraction
  const float tm_rect = __fsub_rn(tm, (float)(r.x0 + r.y0));
  const OverlayPixel o = overlay_at<false>(planes, p, x, y, tm_rect, r.x0, r.y0, r.x1, r.y1);
  const size_t plane = (size_t)p.h * p.w, i = (size_t)y * p.w + x;
  store(zb, packed_out, plane, i, o.zb);
  store(fc, packed_out, plane, i, o.fc);
  store(fp, packed_out, plane, i, o.fp);
}

}  // namespace

// planes: (4, op->h, op->w) u8.  rect: a (4,) int32 (x0, y0, x1, y1) in
// device memory, clamped by the kernel, or null for the whole frame.  tm
// is the zebra clock before the rect's anchor.  zb/fc/fp may each be null.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int ocm_fused_overlays(const OverlayParams* op, const void* planes, float tm,
                                  const void* rect, int packed_out, void* zb, void* fc, void* fp,
                                  void* stream) {
  const OverlayParams p = *op;
  if (p.h == 0 || p.w == 0) return 0;  // an empty grid is not a valid launch
  const dim3 block(32, 8);
  const dim3 grid((p.w + 31) / 32, (p.h + 7) / 8);
  fused_overlays_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)planes, p, tm, (const int*)rect, packed_out != 0, zb, fc, fp);
  return (int)cudaGetLastError();
}
