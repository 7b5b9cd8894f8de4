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
// is far below the card's compute roof.  The design moves every byte in
// wide, whole-line accesses and reads the frame once:
//   * tile launch (with overlays): a block of 256 threads owns a 16 x 256
//     pixel tile and copies it with its 1-pixel halo into shared memory
//     (16-byte cp.async chunks when the rows are 16-byte aligned, else one
//     plain load per pixel or byte; tile_pass.cuh, which K3 shares).
//     Each thread computes runs of 4
//     consecutive pixels of a row from shared memory with overlay_math's
//     per-pixel function and stores each of the 12 output byte planes as
//     one 4-byte word, so a warp writes whole 128-byte lines; the
//     false-colour band colours come from a 12-word shared table (a warp
//     whose pixels span several bands reads it in one access);
//   * at scale 2 the same tile also yields the scaled planes (tile rows and
//     columns are even, so each output pixel's 2x2 texels are in it): one
//     read of the frame for the overlays and the scaled planes;
//   * scale launch (no overlays, or another scale): a thread makes 4
//     adjacent output pixels, with 16-byte (packed) or 8-byte (planar)
//     loads of the texels at scales 1 and 2, and 4-byte stores per plane.
// The wrapper (ops/pipeline.py::frame_plan) picks the forms and the grids.
//
// A batch of B frames runs in one launch, as vmap adds a grid axis to the
// pallas_call: blockIdx.z is the frame, and every frame's input and outputs
// lie one frame's size after the previous one's (the wrapper makes them
// contiguous).  The zebra clock is read from device memory, tm[b], so a
// CUDA graph of the step replays any clock.
#include <cuda_runtime.h>

#include <cstdint>

#include "overlay_math.cuh"
#include "tile_pass.cuh"

// Mirrors obs_color_monitor_tpu_torch/ops/pipeline.py::PassParams.
struct PassParams {
  int h4, w4;   // full-resolution frame
  int h, w;     // scaled frame: h4 / scale, w4 / scale
  int scale;
  int packed;   // 1: (H, W) 32-bit packed RGBA; 0: planar (4, H, W) u8
  int kyuv[12]; // FIXED_COEFFS rows Y, U, V: (K_r, K_g, K_b, O)
  int vec;      // 1: the frame's base and rows are 16-byte aligned (wide loads)
  int fused;    // 1: the tile launch also writes the scale-2 planes
  int tiles_x, tiles_y;          // tile launch grid (0: no overlays)
  int scale_grid_x, scale_grid_y;  // scale launch grid (0: none)
};

namespace {

using K1Tile = TileShape<256, 16, 256>;  // 16 x 256 pixels, 256 threads
constexpr int TW = K1Tile::TW, TH = K1Tile::TH;
constexpr int TILE_THREADS = K1Tile::THREADS;
constexpr int SC_BX = 32, SC_BY = 8;  // scale launch block; a thread makes RUN outputs

// The scaled planes and their Q12 YUV of RUN output pixels from (ox, oy).
__device__ __forceinline__ void store_scaled(const PassParams& p, uint8_t* __restrict__ ds,
                                             uint8_t* __restrict__ yuv, int ox, int oy,
                                             const int c[RUN][4]) {
  const size_t plane = (size_t)p.h * p.w;
  const bool word = (p.w & 3) == 0;  // ox % 4 == 0, so the run is whole
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
    uint32_t b = 0;
#pragma unroll
    for (int j = 0; j < RUN; ++j) b |= (uint32_t)c[j][ch] << (8 * j);
    store_run(ds + ch * plane, p.w, ox, oy, b, word);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int* kk = p.kyuv + 4 * k;
    uint32_t b = 0;
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      // arithmetic shift = floor division, as the spec's int64 >> 12
      const int q = (kk[0] * c[j][0] + kk[1] * c[j][1] + kk[2] * c[j][2] + kk[3] + 2048) >> 12;
      b |= (uint32_t)min(max(q, 0), 255) << (8 * j);
    }
    store_run(yuv + k * plane, p.w, ox, oy, b, word);
  }
}

// Frame b of a contiguous batch of `plane`-pixel frames: packed 32-bit
// words or 4 planes of bytes.
template <bool PACKED>
__device__ __forceinline__ const void* frame_at(const void* frames, size_t plane, int b) {
  return PACKED ? (const void*)((const uint32_t*)frames + plane * b)
                : (const void*)((const uint8_t*)frames + 4 * plane * b);
}

// ---- tile launch: overlays, and at scale 2 the scaled planes ----
// (the tile with its halo in shared memory: tile_pass.cuh's load_tile and
// read_run)

// 4 blocks per SM: at most 64 registers a thread (a few bytes spill; still
// faster than 3 blocks of 80 registers, which spill none)
template <bool PACKED, bool VEC, bool FUSED>
__global__ void __launch_bounds__(TILE_THREADS, 4)
tile_kernel(const void* __restrict__ frames, const OverlayParams op, const PassParams p,
            const float* __restrict__ tms, uint8_t* __restrict__ zb, uint8_t* __restrict__ fc,
            uint8_t* __restrict__ fp, uint8_t* __restrict__ ds, uint8_t* __restrict__ yuv) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint32_t fc_table[12];  // false colour's band colours, RGBA words
  const int H = p.h4, W = p.w4;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  // frame fr of the batch: its input, its outputs and its clock
  const int fr = blockIdx.z;
  const size_t plane = (size_t)H * W;
  const void* frame = frame_at<PACKED>(frames, plane, fr);
  zb += 4 * plane * fr;
  fc += 4 * plane * fr;
  fp += 4 * plane * fr;
  const float tm = __ldg(tms + fr);
  if (threadIdx.x < 12) fc_table[threadIdx.x] = fc_color_word(op, threadIdx.x);
  load_tile<K1Tile, PACKED, VEC>(frame, H, W, x0, y0, smem);  // ends with a barrier

  // overlays: a thread takes runs at column cx of rows ty, ty + 4, ...
  const int cx = (threadIdx.x & 63) * RUN, ty = threadIdx.x >> 6;
  const bool word = (W & 3) == 0;  // x % 4 == 0, so the run is whole
#pragma unroll 1
  for (int ry = ty; ry < TH; ry += TILE_THREADS / 64) {
    const int x = x0 + cx, y = y0 + ry;
    if (x >= W || y >= H) continue;
    int row[RUN + 2][4], up[RUN + 2][4], dn[RUN + 2][4];
    read_run<K1Tile, PACKED>(smem, ry + 1, cx, row, true);
    read_run<K1Tile, PACKED>(smem, ry, cx, up, false);
    read_run<K1Tile, PACKED>(smem, ry + 2, cx, dn, false);
    // each plane's RUN output bytes packed into one word as they come
    uint32_t z[4] = {0, 0, 0, 0}, f[4] = {0, 0, 0, 0}, k[4] = {0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      const int xj = x + j;
      const OverlayPixel o = overlay_pixel(op, xj, y, tm, row[j + 1], row[j], row[j + 2],
                                           up[j + 1], dn[j + 1], xj > 0, xj < W - 1, y > 0,
                                           y < H - 1, fc_table);
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        z[ch] |= (uint32_t)o.zb[ch] << (8 * j);
        f[ch] |= (uint32_t)o.fc[ch] << (8 * j);
        k[ch] |= (uint32_t)o.fp[ch] << (8 * j);
      }
    }
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      store_run(zb + ch * plane, W, x, y, z[ch], word);
      store_run(fc + ch * plane, W, x, y, f[ch], word);
      store_run(fp + ch * plane, W, x, y, k[ch], word);
    }
  }

  if (FUSED) {  // scale 2: output (ox, oy) averages texels 2ox..2ox+1 x 2oy..2oy+1
    const int ocx = (threadIdx.x & 31) * RUN, ory = threadIdx.x >> 5;  // 128 x 8 outputs
    const int ox = x0 / 2 + ocx, oy = y0 / 2 + ory;
    if (ox < p.w && oy < p.h) {
      int c[RUN][4];
#pragma unroll
      for (int j = 0; j < RUN; ++j)
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) c[j][ch] = 2;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        int a[RUN + 2][4], b[RUN + 2][4];
        read_run<K1Tile, PACKED>(smem, 2 * ory + r + 1, 2 * ocx, a, false);
        read_run<K1Tile, PACKED>(smem, 2 * ory + r + 1, 2 * ocx + RUN, b, false);
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {
          c[0][ch] += a[1][ch] + a[2][ch];
          c[1][ch] += a[3][ch] + a[4][ch];
          c[2][ch] += b[1][ch] + b[2][ch];
          c[3][ch] += b[3][ch] + b[4][ch];
        }
      }
#pragma unroll
      for (int j = 0; j < RUN; ++j)
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) c[j][ch] >>= 2;
      store_scaled(p, ds + 4 * (size_t)p.h * p.w * fr, yuv + 3 * (size_t)p.h * p.w * fr, ox, oy,
                   c);
    }
  }
}

// ---- scale launch ----

// The scaled pixel (ox, oy) by the sampling rule, texel by texel.
template <bool PACKED>
__device__ __forceinline__ void sample(const void* __restrict__ frame, const PassParams& p,
                                       int ox, int oy, int c[4]) {
  const int s = p.scale;
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
}

// 8 texels (2 * RUN) of frame row y from column x into t[8][4]: two 16-byte
// loads (packed) or one 8-byte load per plane (planar).
template <bool PACKED>
__device__ __forceinline__ void load_wide(const void* __restrict__ frame, const PassParams& p,
                                          int x, int y, int n, int t[2 * RUN][4]) {
  const size_t i = (size_t)y * p.w4 + x;
  if (PACKED) {
    const uint4* f = reinterpret_cast<const uint4*>((const uint32_t*)frame + i);
    const uint4 q0 = __ldg(f);
    unpack(q0.x, t[0]);
    unpack(q0.y, t[1]);
    unpack(q0.z, t[2]);
    unpack(q0.w, t[3]);
    if (n > RUN) {
      const uint4 q1 = __ldg(f + 1);
      unpack(q1.x, t[4]);
      unpack(q1.y, t[5]);
      unpack(q1.z, t[6]);
      unpack(q1.w, t[7]);
    }
  } else {
    const uint8_t* f = (const uint8_t*)frame + i;
    const size_t plane = (size_t)p.h4 * p.w4;
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      if (n > RUN) {
        const uint2 q = __ldg(reinterpret_cast<const uint2*>(f + ch * plane));
#pragma unroll
        for (int j = 0; j < RUN; ++j) {
          t[j][ch] = (q.x >> (8 * j)) & 255;
          t[RUN + j][ch] = (q.y >> (8 * j)) & 255;
        }
      } else {
        const uint32_t q = __ldg(reinterpret_cast<const uint32_t*>(f + ch * plane));
#pragma unroll
        for (int j = 0; j < RUN; ++j) t[j][ch] = (q >> (8 * j)) & 255;
      }
    }
  }
}

template <bool PACKED, bool VEC>
__global__ void __launch_bounds__(SC_BX * SC_BY)
scale_kernel(const void* __restrict__ frames, const PassParams p, uint8_t* __restrict__ ds,
             uint8_t* __restrict__ yuv) {
  const int ox = (blockIdx.x * SC_BX + threadIdx.x) * RUN;
  const int oy = blockIdx.y * SC_BY + threadIdx.y;
  if (ox >= p.w || oy >= p.h) return;
  const int fr = blockIdx.z;  // frame fr of the batch
  const void* frame = frame_at<PACKED>(frames, (size_t)p.h4 * p.w4, fr);
  ds += 4 * (size_t)p.h * p.w * fr;
  yuv += 3 * (size_t)p.h * p.w * fr;
  int c[RUN][4];
  // wide loads at scales 1 and 2 for a whole run: its texels lie in the
  // frame (2 * ox + 7 <= 2 * w - 1) and are 16-byte (packed) or 4/8-byte
  // (planar, W % 16 == 0) aligned, ox being a multiple of 4
  if (VEC && p.scale <= 2 && ox + RUN <= p.w) {
    if (p.scale == 1) {
      int t[2 * RUN][4];
      load_wide<PACKED>(frame, p, ox, oy, RUN, t);
#pragma unroll
      for (int j = 0; j < RUN; ++j)
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) c[j][ch] = t[j][ch];
    } else {
#pragma unroll
      for (int j = 0; j < RUN; ++j)
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) c[j][ch] = 2;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        int t[2 * RUN][4];
        load_wide<PACKED>(frame, p, 2 * ox, 2 * oy + r, 2 * RUN, t);
#pragma unroll
        for (int j = 0; j < RUN; ++j)
#pragma unroll
          for (int ch = 0; ch < 4; ++ch) c[j][ch] += t[2 * j][ch] + t[2 * j + 1][ch];
      }
#pragma unroll
      for (int j = 0; j < RUN; ++j)
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) c[j][ch] >>= 2;
    }
  } else {
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      if (ox + j < p.w) {
        sample<PACKED>(frame, p, ox + j, oy, c[j]);
      } else {
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) c[j][ch] = 0;
      }
    }
  }
  store_scaled(p, ds, yuv, ox, oy, c);
}

template <bool PACKED, bool VEC, bool FUSED>
cudaError_t launch_tiles(const PassParams& p, const OverlayParams& op, const void* frame,
                         const float* tm, int batch, void* zb, void* fc, void* fp, void* ds,
                         void* yuv, cudaStream_t st) {
  const size_t smem = PACKED ? K1Tile::PK_SMEM : K1Tile::PL_SMEM;
  tile_kernel<PACKED, VEC, FUSED><<<dim3(p.tiles_x, p.tiles_y, batch), TILE_THREADS, smem, st>>>(
      frame, op, p, tm, (uint8_t*)zb, (uint8_t*)fc, (uint8_t*)fp, (uint8_t*)ds, (uint8_t*)yuv);
  return cudaGetLastError();
}

template <bool PACKED, bool VEC>
cudaError_t launch_pass(const PassParams& p, const OverlayParams& op, const void* frame,
                        const float* tm, int batch, void* zb, void* fc, void* fp, void* ds,
                        void* yuv, cudaStream_t st) {
  if (p.tiles_x > 0) {
    const cudaError_t err =
        p.fused
            ? launch_tiles<PACKED, VEC, true>(p, op, frame, tm, batch, zb, fc, fp, ds, yuv, st)
            : launch_tiles<PACKED, VEC, false>(p, op, frame, tm, batch, zb, fc, fp, ds, yuv, st);
    if (err != cudaSuccess) return err;
  }
  if (p.scale_grid_x > 0) {
    scale_kernel<PACKED, VEC>
        <<<dim3(p.scale_grid_x, p.scale_grid_y, batch), dim3(SC_BX, SC_BY), 0, st>>>(
            frame, p, (uint8_t*)ds, (uint8_t*)yuv);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* ocm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// frames: `batch` contiguous frames; tm: `batch` float32 zebra clocks in
// device memory; the outputs: `batch` contiguous frames' worth each.
// zb/fc/fp may all be null (no overlays: tiles_x == 0).  The grids and
// forms come from PassParams (ops/pipeline.py::frame_plan).  Launches on
// `stream`, allocates nothing, returns cudaGetLastError() after its
// launches.
extern "C" int ocm_frame_pass(const PassParams* pp, const OverlayParams* op,
                              const void* frames, const void* tm, int batch, void* zb, void* fc,
                              void* fp, void* ds, void* yuv, void* stream) {
  const PassParams p = *pp;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* t = (const float*)tm;
  cudaError_t err;
  if (p.packed)
    err = p.vec ? launch_pass<true, true>(p, *op, frames, t, batch, zb, fc, fp, ds, yuv, st)
                : launch_pass<true, false>(p, *op, frames, t, batch, zb, fc, fp, ds, yuv, st);
  else
    err = p.vec ? launch_pass<false, true>(p, *op, frames, t, batch, zb, fc, fp, ds, yuv, st)
                : launch_pass<false, false>(p, *op, frames, t, batch, zb, fc, fp, ds, yuv, st);
  return (int)err;
}
