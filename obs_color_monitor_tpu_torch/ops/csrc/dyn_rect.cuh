// The dynamic ROI as the kernels read it: a (4,) int32 (x0, y0, x1, y1) in
// device memory, clamped into a (h, w) frame as the JAX dynamic dock step
// clamps it (obs_color_monitor_tpu/dock_step.py:495-498, and the Pallas
// kernels' SMEM rect, ops/pallas_overlays.py:271-279):
//   x0 = clip(x0, 0, w), x1 = clip(x1, x0, w), and the same for y,
// so a negative or reversed x1 gives an empty rect.  The kernels read the
// four words on the device (K2 in every thread, where they stay in L1; K3
// once per block), so a new rect changes no launch shape and the host never
// reads it.
#pragma once

struct DynRect {
  int x0, y0, x1, y1;
};

__device__ __forceinline__ DynRect load_dyn_rect(const int* __restrict__ rect, int w, int h) {
  DynRect r;
  r.x0 = min(max(__ldg(rect + 0), 0), w);
  r.y0 = min(max(__ldg(rect + 1), 0), h);
  r.x1 = min(max(__ldg(rect + 2), r.x0), w);
  r.y1 = min(max(__ldg(rect + 3), r.y0), h);
  return r;
}
