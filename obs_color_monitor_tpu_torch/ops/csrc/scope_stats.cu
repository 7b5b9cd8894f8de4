// K2: vectorscope and waveform counting, for Hopper (sm_90a).
//
// Replaces obs_color_monitor_tpu/ops/pallas_stats.py::_vs_swar_tiles_kernel
// (:315, launched by vs_swar_from_tiles :356).  The TPU kernel counts with
// int8 one-hot matmuls on the MXU and SWAR bin packing on the VPU, over
// the frame pipeline's padded tiles, and its caller corrects the padding
// and alpha counts.  Here the inputs are planar (h, w) u8 planes and the
// outputs are final:
//   * vs (256, 256) int32: counts[v, u] over every pixel (no alpha skip);
//   * wv (3, 256, w) int32: per-column counts of each data plane, skipping
//     pixels whose mask is 0 (mask null: skip none).
// Either launch can run alone, so the same two kernels also stand in for
// the TPU's standalone vectorscope (K7), waveform (K8) and fused (K6)
// kernels of pallas_stats.py, which the JAX analyze() runs off its fast
// path.
//
// What bounds it: atomics, not bytes (the inputs are 5 B per scaled pixel,
// ~10 MB at 4K scale 2).  The design keeps the contended increments in
// shared memory:
//   * vectorscope: a 256x256 int32 block histogram is 256 KB, more than the
//     227 KB a block may use, so each block privatises 16-bit counters
//     packed two to a 32-bit word (128 KB) and counts at most 16384 pixels,
//     well under the 65535 a 16-bit field holds.  A warp whose pixels all
//     share one bin (a flat frame or region: the worst case for atomics)
//     adds its population in one atomic.  Blocks merge their non-zero bins
//     into the zeroed output with global atomics.
//   * waveform: a block owns a strip of 32 columns over all rows, with its
//     counters in shared memory as [channel][bin][column-in-strip]: the 32
//     lanes of a warp read one row of the strip and hit 32 different banks.
//     Warps on other rows share counters, so the increments are shared
//     atomics; the block then stores its strip with plain stores (no
//     global atomics, no zeroing of the output).
//
// The dynamic ROI (an optional (4,) int32 rect in device memory,
// dyn_rect.cuh) restricts both counts to the pixels inside it, as the JAX
// analyze(rect_dyn=) masks them (ops/fused.py:172-188): the vectorscope
// tests each pixel's row and column against the rect, the waveform counts
// only the rect's rows and leaves the columns outside it zero.  The grids
// stay sized by (h, w), so a new rect changes no launch.
#include <cuda_runtime.h>

#include <cstdint>

#include "dyn_rect.cuh"

namespace {

constexpr int VS_BINS = 256 * 256;
constexpr int VS_WORDS = VS_BINS / 2;
constexpr int VS_THREADS = 1024;
constexpr int VS_PIXELS_PER_BLOCK = 16384;  // <= 65535: no 16-bit field overflows
constexpr size_t VS_SMEM = VS_WORDS * sizeof(uint32_t);  // 128 KB

constexpr int WV_BINS = 256;
constexpr int WV_COLS = 32;   // columns per block = lanes of a warp
constexpr int WV_WARPS = 32;  // rows in flight per block
constexpr int WV_COUNTERS = 3 * WV_BINS * WV_COLS;
constexpr size_t WV_SMEM = WV_COUNTERS * sizeof(int);  // 96 KB

// RECT: count only the pixels inside the clamped dynamic rect (the flat
// index is split into row and column; the frame has < 2^31 pixels).
template <bool RECT>
__global__ void __launch_bounds__(VS_THREADS)
vectorscope_kernel(const uint8_t* __restrict__ u, const uint8_t* __restrict__ v,
                   long long n, int w, int h, const int* __restrict__ rect,
                   int* __restrict__ vs) {
  extern __shared__ uint32_t hist[];  // word k: bin 2k in bits 0-15, 2k+1 in 16-31
  for (int k = threadIdx.x; k < VS_WORDS; k += blockDim.x) hist[k] = 0;
  DynRect r{0, 0, w, h};
  if (RECT) r = load_dyn_rect(rect, w, h);
  __syncthreads();
  const long long begin = (long long)blockIdx.x * VS_PIXELS_PER_BLOCK;
  const long long end = min(begin + VS_PIXELS_PER_BLOCK, n);
  const int lane = threadIdx.x & 31;
  // the trip count is the same for every thread, so the warp votes below
  // always see all 32 lanes
  for (long long base = begin; base < end; base += blockDim.x) {
    const long long i = base + threadIdx.x;
    bool valid = i < end;
    if (RECT && valid) {
      const unsigned y = (unsigned)i / (unsigned)w, x = (unsigned)i - y * (unsigned)w;
      valid = (int)x >= r.x0 && (int)x < r.x1 && (int)y >= r.y0 && (int)y < r.y1;
    }
    const int bin = valid ? (int)__ldg(v + i) * 256 + __ldg(u + i) : -1;
    const unsigned active = __ballot_sync(0xffffffffu, valid);
    if (active == 0) continue;  // warp-uniform
    const int leader = __ffs(active) - 1;
    const int bin0 = __shfl_sync(0xffffffffu, bin, leader);
    if (__all_sync(0xffffffffu, !valid || bin == bin0)) {
      if (lane == leader)
        atomicAdd(&hist[bin0 >> 1], (uint32_t)__popc(active) << ((bin0 & 1) * 16));
    } else if (valid) {
      atomicAdd(&hist[bin >> 1], 1u << ((bin & 1) * 16));
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < VS_WORDS; k += blockDim.x) {
    const uint32_t word = hist[k];
    if (word & 0xffffu) atomicAdd(vs + 2 * k, (int)(word & 0xffffu));
    if (word >> 16) atomicAdd(vs + 2 * k + 1, (int)(word >> 16));
  }
}

__global__ void __launch_bounds__(WV_COLS * WV_WARPS)
waveform_kernel(const uint8_t* __restrict__ data, long long plane_stride,
                const uint8_t* __restrict__ mask, const int* __restrict__ rect, int h, int w,
                int* __restrict__ wv) {
  extern __shared__ int cnt[];  // [channel][bin][column-in-strip]
  const int tid = threadIdx.y * WV_COLS + threadIdx.x;
  const int nthreads = WV_COLS * WV_WARPS;
  for (int k = tid; k < WV_COUNTERS; k += nthreads) cnt[k] = 0;
  const DynRect r = rect != nullptr ? load_dyn_rect(rect, w, h) : DynRect{0, 0, w, h};
  __syncthreads();
  const int x0 = blockIdx.x * WV_COLS;
  const int x = x0 + threadIdx.x;
  if (x >= r.x0 && x < r.x1) {
    for (int y = r.y0 + threadIdx.y; y < r.y1; y += WV_WARPS) {
      const size_t i = (size_t)y * w + x;
      if (mask != nullptr && __ldg(mask + i) == 0) continue;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int val = __ldg(data + c * plane_stride + i);
        atomicAdd(&cnt[(c * WV_BINS + val) * WV_COLS + threadIdx.x], 1);
      }
    }
  }
  __syncthreads();
  for (int k = tid; k < WV_COUNTERS; k += nthreads) {
    const int gx = x0 + k % WV_COLS;
    if (gx < w) wv[(size_t)(k / WV_COLS) * w + gx] = cnt[k];
  }
}

}  // namespace

// need_vs / need_wv pick the launches: both (the counterpart of
// pallas_stats.py::_fused_kernel, K6), the vectorscope alone (::_vs_kernel,
// K7) or the waveform alone (::_wv_kernel, K8); a skipped output's
// pointers may be null.  rect: a (4,) int32 dynamic ROI in device memory,
// or null for the whole plane.  vs must be zeroed by the caller; wv is
// written in full (an empty frame launches nothing).  Launches on `stream`,
// allocates nothing, returns cudaGetLastError() after its launches.
extern "C" int ocm_scope_stats(const void* u, const void* v, const void* data,
                               long long plane_stride, const void* mask, const void* rect,
                               int h, int w, void* vs, void* wv, int need_vs, int need_wv,
                               void* stream) {
  // the shared-memory opt-in is set once per kernel and device (a bit per
  // device), so a launch inside a CUDA graph capture makes no other call
  static unsigned long long vs_smem_set[2] = {0, 0}, wv_smem_set = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ull << (dev & 63);
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)h * w;
  if (need_vs && n > 0) {
    const bool with_rect = rect != nullptr;
    const auto kernel = with_rect ? vectorscope_kernel<true> : vectorscope_kernel<false>;
    if (!(vs_smem_set[with_rect] & bit)) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)VS_SMEM);
      if (err != cudaSuccess) return (int)err;
      vs_smem_set[with_rect] |= bit;
    }
    const int vs_blocks = (int)((n + VS_PIXELS_PER_BLOCK - 1) / VS_PIXELS_PER_BLOCK);
    kernel<<<vs_blocks, VS_THREADS, VS_SMEM, st>>>((const uint8_t*)u, (const uint8_t*)v, n, w,
                                                   h, (const int*)rect, (int*)vs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (need_wv && w > 0) {
    if (!(wv_smem_set & bit)) {
      err = cudaFuncSetAttribute(waveform_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)WV_SMEM);
      if (err != cudaSuccess) return (int)err;
      wv_smem_set |= bit;
    }
    waveform_kernel<<<(w + WV_COLS - 1) / WV_COLS, dim3(WV_COLS, WV_WARPS), WV_SMEM, st>>>(
        (const uint8_t*)data, plane_stride, (const uint8_t*)mask, (const int*)rect, h, w,
        (int*)wv);
  }
  return (int)cudaGetLastError();
}
