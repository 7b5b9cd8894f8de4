// KR: the vectorscope, waveform and histogram images drawn from their
// counts in one launch, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package draws these images with XLA ops
// (obs_color_monitor_tpu/ops/render.py, the histogram's hi_max and levels
// in ops/stats.py), and the port's torch version of them (ops/render.py's
// render_vectorscope, render_waveform, render_histogram, blend_overlay and
// zoom_center, ops/stats.py's apply_channel_select, histogram_hi_max and
// histogram_levels: the plain version) runs as ~110 small kernels a frame
// on the dock.  Here a table of up to three jobs, one per scope, cuts the
// grid into block ranges; each thread draws a run of RUN pixels of one
// row of its job's image, blends the graticule over them and stores them
// with one 16-byte store (a masked tail where the width is not a multiple
// of RUN).  Every pixel is the plain version's integer arithmetic:
//
// - vectorscope: min(count * intensity, 255) of the row-flipped counts,
//   white or the Q20 chroma tint ((C*256 + Cu*fu + Cv*fv) * v + 2^19) >> 20
//   (an arithmetic shift of the int32), clamped; the zoom samples the
//   blended image through the host's index map;
// - waveform: the channel selection, the display order, the row flip,
//   min(c * intensity, 255); OVERLAY, or STACK / PARADE bands tinted
//   (v*T + 2048) >> 12 with the Q12 tints;
// - histogram: the channel selection, hi_max (a host value; the ratio of a
//   pixel count read from device memory; or the per-channel maximum of the
//   counts, which each block recomputes in shared memory), the float32
//   levels (logf under logscale, in the plain version's order) and the
//   fill test level >= (1 - (row + 0.5) / H) * hi_max with IEEE-rounded
//   operations that nvcc may neither contract nor approximate.
//
// The graticule blend is (s*a + d*(255 - a) + 127) / 255; the image's alpha
// (255) passes through.  Every per-frame value (the counts, a dynamic
// rect's pixel count) is read from device memory, so a captured graph of
// a step replays the launch for every frame.
//
// What bounds it: bytes.  At the 4K dock (the 1920-wide waveform) it reads
// ~1.5 MB of counts and ~2.4 MB of graticules and writes ~2.4 MB of images,
// against a few dozen integer operations a pixel.
#include <cuda_runtime.h>

#include <cstdint>

constexpr int MAX_JOBS = 3;  // one per stats scope
constexpr int RUN = 4;       // pixels a thread, one 16-byte store
constexpr int THREADS = 256;
constexpr unsigned OPAQUE = 0xFF000000u;

// job kinds and display modes, as ops/render.py numbers them
enum : int { VECTORSCOPE = 0, WAVEFORM = 1, HISTOGRAM = 2 };
enum : int { OVERLAY = 0, STACK = 1, PARADE = 2 };
// the histogram's hi_max: a host value, a pixel count in device memory
// times a permille, the counts' own maximum
enum : int { HI_HOST = 0, HI_RATIO = 1, HI_AUTO = 2 };

// Mirror of ops/render.py's _Job / _Params (ctypes), in the same order.
struct RenderJob {
  int kind;
  int out_h, out_w;  // the image
  int block0;        // the job's first block of the grid
  int vec;           // out_w % RUN == 0 and the image and graticule 16-byte aligned
  int intensity;     // VECTORSCOPE, WAVEFORM
  int white;         // VECTORSCOPE
  int display;       // WAVEFORM, HISTOGRAM: OVERLAY, STACK or PARADE as drawn
  int n_bands;       // STACK / PARADE: the bands drawn
  int band_h, band_w;  // one band: 256 x W (waveform), H x 256 (histogram)
  int order[3];      // the count channel of each display channel
  int sel[3];        // the count channels selected
  int bands[3];      // the display channel of each band
  int tint[3][3];    // VECTORSCOPE: (C, Cu, Cv) per colour; else [band channel][colour]
  int hi_mode;       // HISTOGRAM
  int logscale;      // HISTOGRAM
  long long hi;      // HI_HOST: hi_max; HI_RATIO: the permille
  const void* counts;       // (256, 256) u8; (3, 256, W) u8; (3, 256) int32
  const unsigned* overlay;  // the graticule, (out_h, out_w) RGBA, or null
  const long long* zoom;    // VECTORSCOPE: the (256,) source index, or null
  const long long* n_pixels;  // HI_RATIO: the 0-d pixel count
  unsigned* out;            // (out_h, out_w) RGBA
};

struct RenderParams {
  int n_jobs, blocks;
  RenderJob jobs[MAX_JOBS];
};

namespace {

__device__ __forceinline__ int clamp255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

__device__ __forceinline__ unsigned rgba(int r, int g, int b) {
  return (unsigned)r | ((unsigned)g << 8) | ((unsigned)b << 16) | OPAQUE;
}

__device__ __forceinline__ unsigned blend(unsigned img, unsigned ov) {
  const int a = ov >> 24;
  unsigned out = img & OPAQUE;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int s = (ov >> (8 * c)) & 255, d = (img >> (8 * c)) & 255;
    out |= (unsigned)((s * a + d * (255 - a) + 127) / 255) << (8 * c);
  }
  return out;
}

// the vectorscope at source pixel (y, x) of the unzoomed image
__device__ __forceinline__ unsigned vs_pixel(const RenderJob& j, int y, int x) {
  const int c = __ldg((const uint8_t*)j.counts + (255 - y) * 256 + x);
  const int v = min(c * j.intensity, 255);
  if (j.white) return rgba(v, v, v);
  const int fu = 2 * x + 1 - 256, fv = 256 - (2 * y + 1);
  int ch[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int num = j.tint[k][0] * 256 + j.tint[k][1] * fu + j.tint[k][2] * fv;  // Q20
    ch[k] = clamp255((num * v + (1 << 19)) >> 20);
  }
  return rgba(ch[0], ch[1], ch[2]);
}

// display channel d of the waveform at band row r (0: level 255), column x
__device__ __forceinline__ int wv_value(const RenderJob& j, int d, int r, int x) {
  const int ch = j.order[d];
  if (!j.sel[ch]) return 0;
  const int c = __ldg((const uint8_t*)j.counts + ((size_t)(ch * 256 + 255 - r)) * j.band_w + x);
  return min(c * j.intensity, 255);
}

__device__ __forceinline__ unsigned wv_pixel(const RenderJob& j, int y, int x) {
  if (j.display == OVERLAY)
    return rgba(wv_value(j, 0, y, x), wv_value(j, 1, y, x), wv_value(j, 2, y, x));
  int band = 0;
  if (j.display == STACK) {
    band = y / j.band_h;
    y -= band * j.band_h;
  } else {
    band = x / j.band_w;
    x -= band * j.band_w;
  }
  const int b = j.bands[band];
  const int v = wv_value(j, b, y, x);
  return rgba(clamp255((v * j.tint[b][0] + 2048) >> 12), clamp255((v * j.tint[b][1] + 2048) >> 12),
              clamp255((v * j.tint[b][2] + 2048) >> 12));
}

// whether display channel d of the histogram fills row `row` of column i:
// level >= (1 - (row + 0.5) / H) * hi_max, every step rounded as the
// plain version's float32 tensors round it
__device__ __forceinline__ bool hi_fill(const RenderJob& j, const float* hm, const float* scale,
                                        int d, int row, int i) {
  const int ch = j.order[d];
  const int c = j.sel[ch] ? __ldg((const int*)j.counts + ch * 256 + i) : 0;
  float lv, h;
  if (j.logscale) {
    lv = c > 0 ? __fmul_rn(logf(__fadd_rn(__int2float_rn(c), 1.0f)), scale[ch]) : 0.0f;
    h = 1.0f;
  } else {
    lv = __int2float_rn(c);
    h = hm[ch];
  }
  const float thr =
      __fsub_rn(1.0f, __fdiv_rn(__fadd_rn(__int2float_rn(row), 0.5f), __int2float_rn(j.band_h)));
  return lv >= __fmul_rn(thr, h);
}

__device__ __forceinline__ unsigned hi_pixel(const RenderJob& j, const float* hm,
                                             const float* scale, int y, int x) {
  if (j.display == OVERLAY)
    return rgba(hi_fill(j, hm, scale, 0, y, x) ? 255 : 0, hi_fill(j, hm, scale, 1, y, x) ? 255 : 0,
                hi_fill(j, hm, scale, 2, y, x) ? 255 : 0);
  int band = 0;
  if (j.display == STACK) {
    band = y / j.band_h;
    y -= band * j.band_h;
  } else {
    band = x / j.band_w;
    x -= band * j.band_w;
  }
  const int b = j.bands[band];
  if (!hi_fill(j, hm, scale, b, y, x)) return rgba(0, 0, 0);
  return rgba(j.tint[b][0], j.tint[b][1], j.tint[b][2]);
}

// a // b rounded toward minus infinity, for b > 0
__device__ __forceinline__ long long floordiv(long long a, long long b) {
  const long long q = a / b;
  return (q * b != a && a < 0) ? q - 1 : q;
}

// The histogram's per-channel hi_max as float32 (hm) and, under logscale,
// 1 / log(hi_max + 1) (scale), into shared memory: every block of the job
// computes them, so the launch needs no second pass.  The caller's block
// runs this whole (it holds __syncthreads).
__device__ void hi_prepare(const RenderJob& j, float* hm, float* scale) {
  __shared__ int warp_max[THREADS / 32][3];
  if (j.hi_mode == HI_AUTO) {
    const int* counts = (const int*)j.counts;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      int m = 0;
      for (int i = threadIdx.x; i < 256; i += THREADS)
        m = max(m, j.sel[c] ? __ldg(counts + c * 256 + i) : 0);
      m = __reduce_max_sync(0xffffffffu, m);
      if (lane == 0) warp_max[warp][c] = m;
    }
    __syncthreads();
  }
  if (threadIdx.x < 3) {
    const int c = threadIdx.x;
    long long hi;
    if (j.hi_mode == HI_HOST) {
      hi = j.hi;
    } else if (j.hi_mode == HI_RATIO) {
      hi = floordiv(*j.n_pixels * j.hi, 1000);
      hi = hi > 1 ? hi : 1;
    } else {
      int m = 0;
      for (int w = 0; w < THREADS / 32; ++w) m = max(m, warp_max[w][c]);
      hi = j.sel[c] ? (m > 1 ? m : 1) : 1;
    }
    hm[c] = __ll2float_rn(hi);
    scale[c] = __fdiv_rn(1.0f, logf(__fadd_rn(hm[c], 1.0f)));
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS) scope_render_kernel(const __grid_constant__ RenderParams p) {
  int k = 0;
#pragma unroll
  for (int i = 1; i < MAX_JOBS; ++i)
    if (i < p.n_jobs && (int)blockIdx.x >= p.jobs[i].block0) k = i;
  const RenderJob& j = p.jobs[k];
  __shared__ float hm[3], scale[3];
  if (j.kind == HISTOGRAM) hi_prepare(j, hm, scale);  // the same branch in every thread of a block
  const int runs = (j.out_w + RUN - 1) / RUN;
  const int t = ((int)blockIdx.x - j.block0) * THREADS + (int)threadIdx.x;
  if (t >= runs * j.out_h) return;
  const int y = t / runs, x0 = (t - y * runs) * RUN;
  const size_t row = (size_t)y * j.out_w;
  unsigned v[RUN];
#pragma unroll
  for (int q = 0; q < RUN; ++q) {
    const int x = x0 + q;
    v[q] = OPAQUE;
    if (x >= j.out_w) continue;
    if (j.kind == VECTORSCOPE) {
      // the zoom samples the blended image: the counts and the graticule
      // at the same source pixel
      const int sy = j.zoom ? (int)__ldg(j.zoom + y) : y;
      const int sx = j.zoom ? (int)__ldg(j.zoom + x) : x;
      v[q] = vs_pixel(j, sy, sx);
      if (j.overlay && j.zoom) v[q] = blend(v[q], __ldg(j.overlay + sy * 256 + sx));
    } else if (j.kind == WAVEFORM) {
      v[q] = wv_pixel(j, y, x);
    } else {
      v[q] = hi_pixel(j, hm, scale, y, x);
    }
  }
  if (j.overlay && !(j.kind == VECTORSCOPE && j.zoom)) {
    if (j.vec) {
      const uint4 o = __ldg(reinterpret_cast<const uint4*>(j.overlay + row + x0));
      v[0] = blend(v[0], o.x);
      v[1] = blend(v[1], o.y);
      v[2] = blend(v[2], o.z);
      v[3] = blend(v[3], o.w);
    } else {
#pragma unroll
      for (int q = 0; q < RUN; ++q)
        if (x0 + q < j.out_w) v[q] = blend(v[q], __ldg(j.overlay + row + x0 + q));
    }
  }
  if (j.vec) {
    *reinterpret_cast<uint4*>(j.out + row + x0) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < RUN; ++q)
      if (x0 + q < j.out_w) j.out[row + x0 + q] = v[q];
  }
}

}  // namespace

// params: the job table (params_size = sizeof(RenderParams), checked
// against the caller's mirror; `blocks` the sum of the jobs' block
// ranges).  Launches on `stream`, allocates nothing, returns
// cudaGetLastError() (cudaErrorInvalidValue for a table this file does not
// take).
extern "C" int ocm_scope_render(const RenderParams* params, int params_size, void* stream) {
  if (params_size != (int)sizeof(RenderParams) || params->n_jobs < 0 ||
      params->n_jobs > MAX_JOBS || params->blocks < 0)
    return (int)cudaErrorInvalidValue;
  if (params->n_jobs == 0 || params->blocks == 0) return 0;  // an empty grid is not a valid launch
  scope_render_kernel<<<params->blocks, THREADS, 0, (cudaStream_t)stream>>>(*params);
  return (int)cudaGetLastError();
}
