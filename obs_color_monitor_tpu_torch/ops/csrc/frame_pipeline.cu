// K1: the whole-frame pass of the six-scope step, for Hopper (sm_90a).
//
// Replaces obs_color_monitor_tpu/ops/pallas_pipeline.py::_pipeline_kernel
// (:149, launched by frame_pipeline :290).  The TPU kernel sweeps 64-row
// bands through VMEM and also writes 128-lane stats tiles with padding the
// caller corrects; the contract kept here is the final outputs:
//   * zebra, false colour and focus peaking per full-resolution pixel,
//     planar (4, H, W) u8 each (math shared with K3 in overlay_math.cuh);
//   * the scaled planes (4, h, w) u8 at ANY integer scale (1: identity;
//     odd: the centre texel; even: (sum of the centre 2x2 + 2) >> 2);
//   * the Q12 YUV planes (3, h, w) u8 of the scaled frame, which the
//     counting kernel K2 (scope_stats.cu) reads as U, V and, in the YUV
//     family, as its data planes.
// The input is the packed (H, W) 32-bit RGBA view (byte 0 = R) or planar
// (4, H, W) u8.
//
// What bounds it: bytes.  At 4K the overlays write 12 B and read 4 B per
// pixel (~133 MB), against a few integer operations per byte, so the pass
// is far below the card's compute roof.  The design keeps every access
// coalesced and each byte touched once from DRAM: one thread per pixel, a
// warp on 32 consecutive pixels of a row, so each plane store is one full
// 32-byte sector; the four neighbours the focus-peaking cross reads come
// from L1/L2 (rows above and below were just read by neighbouring blocks).
// The scaled planes are a second, smaller launch (one thread per output
// pixel) that reads only the texels its sample needs.
#include <cuda_runtime.h>

#include <cstdint>

#include "overlay_math.cuh"

// Mirrors obs_color_monitor_tpu_torch/ops/pipeline.py::PassParams.
struct PassParams {
  int h4, w4;   // full-resolution frame
  int h, w;     // scaled frame: h4 / scale, w4 / scale
  int scale;
  int packed;   // 1: (H, W) 32-bit packed RGBA; 0: planar (4, H, W) u8
  int kyuv[12]; // FIXED_COEFFS rows Y, U, V: (K_r, K_g, K_b, O)
};

template <bool PACKED>
__global__ void overlay_kernel(const void* __restrict__ frame, const OverlayParams p,
                               const float tm, uint8_t* __restrict__ zb,
                               uint8_t* __restrict__ fc, uint8_t* __restrict__ fp) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= p.w || y >= p.h) return;
  const OverlayPixel o = overlay_at<PACKED>(frame, p, x, y, tm, 0, 0, p.w, p.h);
  const size_t plane = (size_t)p.h * p.w, i = (size_t)y * p.w + x;
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
    zb[ch * plane + i] = o.zb[ch];
    fc[ch * plane + i] = o.fc[ch];
    fp[ch * plane + i] = o.fp[ch];
  }
}

template <bool PACKED>
__global__ void scale_kernel(const void* __restrict__ frame, const PassParams p,
                             uint8_t* __restrict__ ds, uint8_t* __restrict__ yuv) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y * blockDim.y + threadIdx.y;
  if (ox >= p.w || oy >= p.h) return;
  const int s = p.scale;
  int c[4];
  if (s == 1) {
    load_px<PACKED>(frame, p.h4, p.w4, ox, oy, c);
  } else if (s & 1) {
    const int m = (s - 1) / 2;
    load_px<PACKED>(frame, p.h4, p.w4, ox * s + m, oy * s + m, c);
  } else {
    // sample position (i + 0.5) * s - 0.5 is the midpoint of the centre 2x2
    const int a = s / 2 - 1, x0 = ox * s + a, y0 = oy * s + a;
    int t[4];
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) c[ch] = 2;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      load_px<PACKED>(frame, p.h4, p.w4, x0 + (k & 1), y0 + (k >> 1), t);
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) c[ch] += t[ch];
    }
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) c[ch] >>= 2;
  }
  const size_t plane = (size_t)p.h * p.w, i = (size_t)oy * p.w + ox;
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) ds[ch * plane + i] = (uint8_t)c[ch];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int* kk = p.kyuv + 4 * k;
    // arithmetic shift = floor division, as the spec's int64 >> 12
    const int q = (kk[0] * c[0] + kk[1] * c[1] + kk[2] * c[2] + kk[3] + 2048) >> 12;
    yuv[k * plane + i] = (uint8_t)min(max(q, 0), 255);
  }
}

extern "C" const char* ocm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// zb/fc/fp may all be null (no overlays).  Launches on `stream`, allocates
// nothing, returns cudaGetLastError() after its launches.
extern "C" int ocm_frame_pass(const PassParams* pp, const OverlayParams* op,
                              const void* frame, float tm, void* zb, void* fc, void* fp,
                              void* ds, void* yuv, void* stream) {
  const PassParams p = *pp;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 block(32, 8);
  if (zb != nullptr) {
    const dim3 grid((p.w4 + 31) / 32, (p.h4 + 7) / 8);
    if (p.packed)
      overlay_kernel<true><<<grid, block, 0, st>>>(frame, *op, tm, (uint8_t*)zb,
                                                   (uint8_t*)fc, (uint8_t*)fp);
    else
      overlay_kernel<false><<<grid, block, 0, st>>>(frame, *op, tm, (uint8_t*)zb,
                                                    (uint8_t*)fc, (uint8_t*)fp);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((p.w + 31) / 32, (p.h + 7) / 8);
  if (p.packed)
    scale_kernel<true><<<grid, block, 0, st>>>(frame, p, (uint8_t*)ds, (uint8_t*)yuv);
  else
    scale_kernel<false><<<grid, block, 0, st>>>(frame, p, (uint8_t*)ds, (uint8_t*)yuv);
  return (int)cudaGetLastError();
}
