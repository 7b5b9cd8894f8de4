// K4 and K5: NV12 / P010-family planes -> packed RGBA, for Hopper (sm_90a).
//
// Replace obs_color_monitor_tpu/ops/pallas_convert.py::_decode_band (K4,
// :60, launched by nv12_decode_pallas :134) and ::_decode16_band (K5, :88,
// launched by nv12_16_decode_pallas :169).  Both decode limited-range
// 4:2:0 planes in Q12 fixed point: with Y' = Y - 16 and C = Cx - 128,
//   channel = clip((4769 * Y' + K . C + 2048) >> 12, 0, 255)
// and write r | g << 8 | b << 16 | 0xFF000000 per pixel into an int32
// (H, W) tensor (the port holds packed frames as int32).  K5 first
// round-shifts each 16-bit sample to 8 bits, min((v + half) >> shift, 255).
//
// What bounds them: bytes.  A 4K frame moves 8.3 MB of y, 4.1 MB of uv and
// writes 33.2 MB (K4; K5 reads twice the input), against ~20 integer
// operations per pixel, far below the card's integer rate.
//
// Differences from the Mosaic layout, and why: the TPU kernels read the
// planes as u32 words (four u8 or two u16 samples a lane), decode 64-row
// bands into quarter- or half-width planes, and leave the interleave to a
// separate XLA pass, because Mosaic refused the in-kernel merge reshape.
// Here one thread decodes the two pixels that share one chroma pair and
// stores them with one 8-byte store, so the output needs no interleave and
// a warp writes 256 contiguous bytes; W only has to be even.  The math is
// int32 throughout: every product is below 2^23, and `>>` on a negative
// int32 is an arithmetic shift in nvcc, i.e. the floor division the spec
// takes.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

struct Nv12Coef {
  int kr_cr, kg_cb, kg_cr, kb_cb;
};

constexpr int NV12_KY = 4769;  // round(255/219 * 4096)

__device__ __forceinline__ int to8(int v, int shift) {
  return shift ? min((v + (1 << (shift - 1))) >> shift, 255) : v;
}

__device__ __forceinline__ int q12(int acc) { return min(max(acc >> 12, 0), 255); }

__device__ __forceinline__ int decode_px(int y, int cb, int cr, const Nv12Coef k) {
  const int yp = (y - 16) * NV12_KY;
  const int r = q12(yp + k.kr_cr * cr + 2048);
  const int g = q12(yp + k.kg_cb * cb + k.kg_cr * cr + 2048);
  const int b = q12(yp + k.kb_cb * cb + 2048);
  return r | (g << 8) | (b << 16) | (int)0xFF000000u;
}

// T = uint8_t (K4, shift 0) or uint16_t (K5, shift 1..8).  Thread (i, row)
// decodes pixels 2i and 2i+1 of `row`; uv row row/2 holds Cb, Cr at 2i, 2i+1.
// blockIdx.z is the frame of a batch of contiguous frames (vmap's grid axis).
template <typename T>
__global__ void nv12_kernel(const T* __restrict__ y, const T* __restrict__ uv, int h, int w,
                            int shift, const Nv12Coef k, int2* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y;
  if (i >= w / 2 || row >= h) return;
  const size_t frame = (size_t)h * w * blockIdx.z;
  y += frame;
  uv += frame / 2;
  out += frame / 2;
  const size_t py = (size_t)row * w + 2 * i;
  const size_t pc = (size_t)(row >> 1) * w + 2 * i;
  const int cb = to8(__ldg(uv + pc), shift) - 128;
  const int cr = to8(__ldg(uv + pc + 1), shift) - 128;
  int2 o;
  o.x = decode_px(to8(__ldg(y + py), shift), cb, cr, k);
  o.y = decode_px(to8(__ldg(y + py + 1), shift), cb, cr, k);
  out[py / 2] = o;
}

template <typename T>
int launch(const void* y, const void* uv, int batch, int h, int w, int shift, Nv12Coef k,
           void* out, void* stream) {
  if (batch == 0 || h == 0 || w == 0) return 0;  // an empty grid is not a valid launch
  const dim3 block(128);
  const dim3 grid((w / 2 + 127) / 128, h, batch);
  nv12_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)y, (const T*)uv, h, w, shift, k, (int2*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// K4: y (batch, h, w) u8, uv (batch, h/2, w) u8, each contiguous; h, w
// even.  out (batch, h, w) int32, 8-byte aligned.  Launches on `stream`,
// allocates nothing, returns cudaGetLastError().
extern "C" int ocm_nv12_decode(const void* y, const void* uv, int batch, int h, int w,
                               int kr_cr, int kg_cb, int kg_cr, int kb_cb, void* out,
                               void* stream) {
  return launch<uint8_t>(y, uv, batch, h, w, 0, Nv12Coef{kr_cr, kg_cb, kg_cr, kb_cb}, out,
                         stream);
}

// K5: the same with u16 planes and shift in 1..8.
extern "C" int ocm_nv12_16_decode(const void* y, const void* uv, int batch, int h, int w,
                                  int shift, int kr_cr, int kg_cb, int kg_cr, int kb_cb,
                                  void* out, void* stream) {
  return launch<uint16_t>(y, uv, batch, h, w, shift, Nv12Coef{kr_cr, kg_cb, kg_cr, kb_cb}, out,
                          stream);
}
