// KC: the dock panel in one launch, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX dock steps (obs_color_monitor_tpu/
// dock_step.py:485-710, step_dyn, and :712-857, the static step) and the
// JAX Dock's composite build the panel from XLA ops, and the port's torch
// versions of them (ops/compose.assemble_dyn_panel and
// assemble_static_panel, the plain versions) run as many small kernels a
// frame: ~190 for the dynamic step (the preview's shading of the whole
// capture, the slot samplers' index math on 0-d and 1-D tensors, their
// gathers, the key legend's blend and the vertical stack), ~27 for the
// settled route's static panel (the preview interleaved whole, two
// gathers a slot, the pads and the stack).  Here one thread computes a run
// of RUN panel pixels and stores them with one 16-byte store.  Each pixel
// finds the last slot of the table whose band covers it (later slots draw
// over earlier ones and the canvas clips them, as compose_vstack's
// update-slice loop does; no slot: opaque black), and computes its source
// row and column with the plain version's integer arithmetic, floor
// division included.
//
// Two forms of one table, one instantiation each.  A dynamic table (the
// dynamic-ROI step's) reads the rect: the step's (4,) int32 input in
// device memory, clamped here in every thread as ops/convert.clamp_rect
// clamps it (dyn_rect.cuh), so a CUDA graph of the step replays for any
// rect and the host never reads it.  A static table (the settled route's
// and the static step's: the capture's planes, a nearest resize, a 1:1
// window) reads no rect, and its launch passes none.  The slot table
// (kind, band, source and its dims, per-kind constants) is the kernel's
// by-value parameter: the sources are the step's own images, whose
// addresses are fixed inside a captured graph.
//
// What bounds it: bytes.  A 512x1536 panel writes 3.1 MB and samples about
// as many source bytes, against ~100 integer operations a pixel (a few
// divisions); at the dock's shapes the index math fits int32, which the
// host proves from the static sizes (ops/compose.py, `wide`), else it runs
// in 64 bits.
#include <cuda_runtime.h>

#include <cstdint>

#include "dyn_rect.cuh"

constexpr int MAX_SLOTS = 7;  // dock_step.SCOPE_ORDER
constexpr int RUN = 4;        // pixels a thread, one int4 store
constexpr int THREADS = 128;
constexpr int OPAQUE_BLACK = (int)0xFF000000u;
constexpr int BORDER_GREEN = (int)0xFF00FF00u;  // (0, 255, 0, 255)

// slot kinds, as ops/compose.py numbers them: the dynamic table's (those
// that read the rect, and NEAREST), the static table's (PLANES, WINDOW and
// NEAREST)
enum : int {
  PREVIEW = 0, NEAREST = 1, WAVEFORM = 2, FITTED = 3, ACTUAL = 4, KEYED = 5, PLANES = 6,
  WINDOW = 7
};

// Mirror of ops/compose.py's _Slot / _Params (ctypes), in the same order.
struct ComposeSlot {
  int kind;
  int x0, y0, w, h;  // the band on the panel
  int src_h, src_w;  // the source's pixels (row stride src_w); PREVIEW: the capture
  int parade;        // WAVEFORM: components side by side (1: the rect across the band)
  int key_wide;      // KEYED: the canvas adds a tenth of the rect's width (OUTSIDE)
  int key_tall;      // KEYED: ... or a fifth of its height (BELOW)
  int key_h, key_w;  // KEYED: the legend texture
  int shade;         // PLANES: the selection sel is shaded around and outlined
  int sel[4];        // PLANES: (x0, y0, x1, y1), used as given
  int org_x, org_y;  // WINDOW: the source's pixel at the band's top left
  const void* src;   // packed RGBA pixels; PREVIEW, PLANES: the (4, src_h, src_w) u8 planes
  const int* key;    // KEYED: the legend's packed pixels
};

struct ComposeParams {
  int n_slots, out_w, out_h, sw, sh, wide;
  ComposeSlot slots[MAX_SLOTS];
};

template <typename I>
struct Rect {
  I x0, y0, x1, y1, w1, h1;  // clamped; w1, h1 = max(width, 1), max(height, 1)
};

// a // b rounded toward minus infinity, for b > 0 (C's / truncates)
template <typename I>
__device__ __forceinline__ I floordiv(I a, I b) {
  const I q = a / b;
  return (q * b != a && a < 0) ? q - 1 : q;
}

template <typename I>
__device__ __forceinline__ I clampi(I v, I lo, I hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ops/compose._fit_dyn: the largest box inside (slot_w, slot_h) with the
// source's aspect, at least 1 x 1
template <typename I>
__device__ __forceinline__ void fit(I slot_w, I slot_h, I src_w, I src_h, I& fw, I& fh) {
  fw = slot_w * src_h > slot_h * src_w ? floordiv(slot_h * src_w, src_h > 1 ? src_h : I(1))
                                       : slot_w;
  fh = slot_h * src_w > slot_w * src_h ? floordiv(slot_w * src_h, src_w > 1 ? src_w : I(1))
                                       : slot_h;
  fw = fw > 1 ? fw : I(1);
  fh = fh > 1 ? fh : I(1);
}

// the source pixel at (y, x), both clamped into the source
template <typename I>
__device__ __forceinline__ int texel(const ComposeSlot& s, I y, I x) {
  y = clampi(y, I(0), I(s.src_h - 1));
  x = clampi(x, I(0), I(s.src_w - 1));
  return __ldg((const int*)s.src + (size_t)y * s.src_w + (size_t)x);
}

__device__ __forceinline__ int channel_blend(int over, int base, int a, int shift) {
  const int o = (over >> shift) & 255, b = (base >> shift) & 255;
  return ((o * a + b * (255 - a) + 127) / 255) << shift;
}

// the capture's planes at (sy, sx) as a packed pixel; with `shade`,
// ops/compose.shaded_preview there: 50 % black outside the selection
// (x0, y0, x1, y1), a green border on its first and last rows and columns
template <typename I>
__device__ __forceinline__ int planes_pixel(const ComposeSlot& s, I sy, I sx, bool shade, I x0,
                                            I y0, I x1, I y1) {
  const I src_h = s.src_h, src_w = s.src_w;
  const bool in_cols = sx >= x0 && sx < x1, in_rows = sy >= y0 && sy < y1;
  if (shade && (((sy == y0 || sy == y1 - 1) && in_cols) || ((sx == x0 || sx == x1 - 1) && in_rows)))
    return BORDER_GREEN;
  const size_t plane = (size_t)src_h * src_w;
  const uint8_t* p = (const uint8_t*)s.src + (size_t)sy * src_w + (size_t)sx;
  int v = (int)((unsigned)__ldg(p + 3 * plane) << 24);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int pc = __ldg(p + c * plane);
    v |= (!shade || (in_rows && in_cols) ? pc : pc * 128 / 255) << (8 * c);
  }
  return v;
}

// pixel (jj, ii) of a static table's slot s's band
template <typename I>
__device__ int static_pixel(const ComposeSlot& s, I jj, I ii) {
  if (s.kind == WINDOW)  // a 1:1 window of the source, its band inside it
    return texel<I>(s, I(s.org_y) + ii, I(s.org_x) + jj);
  // the nearest-resize sample (ops/compose._resize_nearest_rgba)
  const I ws = s.w, hs = s.h, src_h = s.src_h, src_w = s.src_w;
  const I sy = min(ii * src_h / hs, src_h - 1), sx = min(jj * src_w / ws, src_w - 1);
  if (s.kind == PLANES)  // the preview
    return planes_pixel<I>(s, sy, sx, s.shade != 0, I(s.sel[0]), I(s.sel[1]), I(s.sel[2]),
                           I(s.sel[3]));
  return texel<I>(s, sy, sx);  // NEAREST
}

// pixel (jj, ii) of a dynamic table's slot s's band
template <typename I>
__device__ int slot_pixel(const ComposeSlot& s, const Rect<I>& r, I sw, I jj, I ii) {
  const I ws = s.w, hs = s.h, src_h = s.src_h, src_w = s.src_w;
  switch (s.kind) {
    case PREVIEW:
      // the full capture at the nearest-resize sample, the rect shaded
      return planes_pixel<I>(s, min(ii * src_h / hs, src_h - 1), min(jj * src_w / ws, src_w - 1),
                             true, r.x0, r.y0, r.x1, r.y1);
    case NEAREST:  // ops/compose._resize_nearest_rgba
      return texel<I>(s, min(ii * src_h / hs, src_h - 1), min(jj * src_w / ws, src_w - 1));
    case WAVEFORM: {
      // the rect's columns stretched across the band; in parade through
      // the per-component segments first
      I sj;
      if (s.parade > 1) {
        const I m = jj * (r.w1 * s.parade) / ws, seg = m / r.w1;
        sj = seg * sw + r.x0 + (m - seg * r.w1);
      } else {
        sj = r.x0 + jj * r.w1 / ws;
      }
      return texel<I>(s, min(ii * src_h / hs, src_h - 1), sj);
    }
    case FITTED:
    case ACTUAL: {
      // the rect x-centred and top-aligned in the band: fitted to it, or
      // 1:1 pixels centred on the rect and cropped to the band
      I fw, fh;
      if (s.kind == ACTUAL) {
        fw = min(r.w1, ws);
        fh = min(r.h1, hs);
      } else {
        fit<I>(ws, hs, r.w1, r.h1, fw, fh);
      }
      const I dxo = floordiv(ws - fw, I(2));
      if (!(ii < fh && jj >= dxo && jj < dxo + fw)) return OPAQUE_BLACK;
      if (s.kind == ACTUAL)
        return texel<I>(s, r.y0 + floordiv(r.h1 - fh, I(2)) + ii,
                        r.x0 + floordiv(r.w1 - fw, I(2)) + (jj - dxo));
      return texel<I>(s, r.y0 + floordiv(ii * r.h1, fh), r.x0 + floordiv((jj - dxo) * r.w1, fw));
    }
    default: {  // KEYED
      // the canvas (the rect and the legend's strip) fitted into the band,
      // the rect's pixels sampled through it, the legend blended over it
      const I cw = s.key_wide ? floordiv(r.w1 * 11, I(10)) : r.w1;
      const I ch = s.key_tall ? floordiv(r.h1 * 12, I(10)) : r.h1;
      I fw, fh;
      fit<I>(ws, hs, cw, ch, fw, fh);
      const I dxo = floordiv(ws - fw, I(2));
      const I cx = floordiv((jj - dxo) * cw, fw), cy = floordiv(ii * ch, fh);
      const bool col_in = jj >= dxo && jj < dxo + fw, row_in = ii < fh;
      const int base = row_in && col_in && cy < r.h1 && cx < r.w1
                           ? texel<I>(s, r.y0 + clampi(cy, I(0), r.h1 - 1),
                                      r.x0 + clampi(cx, I(0), r.w1 - 1))
                           : OPAQUE_BLACK;
      const I key_h = s.key_h, key_w = s.key_w;
      const I ly = clampi(floordiv(ii * key_h, fh), I(0), key_h - 1);
      const I lx = clampi(floordiv((jj - dxo) * key_w, fw), I(0), key_w - 1);
      const int lg = __ldg(s.key + (size_t)ly * s.key_w + (size_t)lx);
      const int a = row_in && col_in ? (lg >> 24) & 255 : 0;
      return (base & OPAQUE_BLACK) | channel_blend(lg, base, a, 0) |
             channel_blend(lg, base, a, 8) | channel_blend(lg, base, a, 16);
    }
  }
}

// Thread (t, row): panel pixels RUN * t .. RUN * t + RUN - 1 of each row
// blockIdx.y + k * gridDim.y.  DYN: a dynamic table, which reads the rect.
template <typename I, bool DYN>
__global__ void __launch_bounds__(THREADS)
    dock_compose_kernel(const __grid_constant__ ComposeParams p, const int* __restrict__ rect,
                        int* __restrict__ out) {
  Rect<I> r{};
  if constexpr (DYN) {
    const DynRect c = load_dyn_rect(rect, p.sw, p.sh);
    r.x0 = c.x0;
    r.y0 = c.y0;
    r.x1 = c.x1;
    r.y1 = c.y1;
    r.w1 = max(c.x1 - c.x0, 1);
    r.h1 = max(c.y1 - c.y0, 1);
  }
  const int x_first = (blockIdx.x * THREADS + threadIdx.x) * RUN;
  if (x_first >= p.out_w) return;
  const bool vec = (p.out_w % RUN) == 0;
  for (int y = blockIdx.y; y < p.out_h; y += gridDim.y) {
    int v[RUN];
#pragma unroll
    for (int k = 0; k < RUN; ++k) {
      const int x = x_first + k;
      v[k] = OPAQUE_BLACK;
      for (int i = p.n_slots - 1; i >= 0; --i) {
        const ComposeSlot& s = p.slots[i];
        if (x >= s.x0 && x < s.x0 + s.w && y >= s.y0 && y < s.y0 + s.h) {
          if constexpr (DYN)
            v[k] = slot_pixel<I>(s, r, I(p.sw), I(x - s.x0), I(y - s.y0));
          else
            v[k] = static_pixel<I>(s, I(x - s.x0), I(y - s.y0));
          break;
        }
      }
    }
    int* row = out + (size_t)y * p.out_w;
    if (vec) {
      *reinterpret_cast<int4*>(row + x_first) = make_int4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < RUN; ++k)
        if (x_first + k < p.out_w) row[x_first + k] = v[k];
    }
  }
}

template <bool DYN>
static void launch(const ComposeParams& p, const int* rect, int* out, cudaStream_t stream) {
  const int runs = (p.out_w + RUN - 1) / RUN;
  const dim3 grid((runs + THREADS - 1) / THREADS, p.out_h < 65535 ? p.out_h : 65535);
  if (p.wide)
    dock_compose_kernel<long long, DYN><<<grid, THREADS, 0, stream>>>(p, rect, out);
  else
    dock_compose_kernel<int, DYN><<<grid, THREADS, 0, stream>>>(p, rect, out);
}

// params: the slot table (params_size = sizeof(ComposeParams), checked
// against the caller's mirror); rect: (4,) int32 on the card for a dynamic
// table, NULL for a static one (every slot PLANES, WINDOW or NEAREST);
// out: the (out_h, out_w) packed panel, 16-byte aligned.  Launches on
// `stream`, allocates nothing, returns cudaGetLastError()
// (cudaErrorInvalidValue for a table this file does not take).
extern "C" int ocm_dock_compose(const ComposeParams* params, int params_size, const int* rect,
                                void* out, void* stream) {
  if (params_size != (int)sizeof(ComposeParams) || params->n_slots < 0 ||
      params->n_slots > MAX_SLOTS)
    return (int)cudaErrorInvalidValue;
  const ComposeParams& p = *params;
  for (int i = 0; i < p.n_slots; ++i) {
    const int kind = p.slots[i].kind;
    const bool fixed = kind == NEAREST || kind == PLANES || kind == WINDOW;
    if (kind < PREVIEW || kind > WINDOW || (rect == nullptr && !fixed) ||
        (rect != nullptr && (kind == PLANES || kind == WINDOW)))
      return (int)cudaErrorInvalidValue;
  }
  if (p.out_w <= 0 || p.out_h <= 0) return 0;  // an empty grid is not a valid launch
  if (rect != nullptr)
    launch<true>(p, rect, (int*)out, (cudaStream_t)stream);
  else
    launch<false>(p, rect, (int*)out, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
