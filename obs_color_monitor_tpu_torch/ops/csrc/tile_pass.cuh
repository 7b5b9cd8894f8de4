// The tile machinery that K1's tile pass (frame_pipeline.cu) and K3
// (fused_overlays.cu) share: a block copies a tile of the frame and its
// 1-pixel halo into shared memory (load_tile), then each thread reads runs
// of RUN consecutive pixels of a row from it (read_run as (R, G, B, A)
// ints, K1; tile_words as planar words, K3) and stores each output as
// words (store_run).
//
// A tile is TileShape<TW, TH, THREADS>: TW x TH pixels of the full-res
// frame, copied by THREADS threads.  The halo column on each side is one
// 16-byte chunk wide, so every chunk copied is aligned: 4 pixels of the
// packed (H, W) 32-bit frame, 16 bytes of each plane of the planar (4, H, W)
// u8 frame.  One halo row above and one below.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

constexpr int RUN = 4;  // consecutive pixels per thread and store

template <int TW_, int TH_, int THREADS_>
struct TileShape {
  static constexpr int TW = TW_, TH = TH_, THREADS = THREADS_;
  static constexpr int SROWS = TH + 2;  // tile rows with the halo row above and below
  static constexpr int PK_PAD = 4;      // packed halo: one 16-byte chunk (4 px) each side
  static constexpr int PK_COLS = TW + 2 * PK_PAD;
  static constexpr int PL_PAD = 16;     // planar halo: one 16-byte chunk each side
  static constexpr int PL_COLS = TW + 2 * PL_PAD;
  static constexpr size_t PK_SMEM = (size_t)SROWS * PK_COLS * 4;
  static constexpr size_t PL_SMEM = (size_t)4 * SROWS * PL_COLS;
  static constexpr int PL_ROW_WORDS = PL_COLS / 4;              // planar: a row, in words
  static constexpr int PL_PLANE_WORDS = SROWS * PL_COLS / 4;    // planar: a plane, in words
  static_assert(TW % (2 * RUN) == 0 && TH % 2 == 0, "tile rows and columns must be even runs");
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void unpack(uint32_t v, int out[4]) {
  out[0] = v & 255;
  out[1] = (v >> 8) & 255;
  out[2] = (v >> 16) & 255;
  out[3] = v >> 24;
}

// One byte plane's RUN outputs from (x, y) on, packed in a word (byte j =
// pixel x + j): one 4-byte store when the run is whole and its address
// 4-byte aligned (row width % 4 == 0), else byte by byte.
__device__ __forceinline__ void store_run(uint8_t* __restrict__ plane, int width, int x, int y,
                                          uint32_t packed, bool word) {
  uint8_t* dst = plane + (size_t)y * width + x;
  if (word) {
    *reinterpret_cast<uint32_t*>(dst) = packed;
  } else {
#pragma unroll
    for (int j = 0; j < RUN; ++j)
      if (x + j < width) dst[j] = (uint8_t)(packed >> (8 * j));
  }
}

// The tile at (x0, y0) with its halo into shared memory.  Packed:
// s32[r][c] = pixel (y0 - 1 + r, x0 - PK_PAD + c); planar: s8[ch][r][c] =
// plane ch at (y0 - 1 + r, x0 - PL_PAD + c).  Cells outside the frame stay
// unwritten; the overlay math never reads them (its neighbour flags are off
// there).  VEC: the frame's base and rows are 16-byte aligned (W % 4 == 0
// packed, W % 16 == 0 planar), so a 16-byte chunk lies wholly inside or
// outside the frame and is copied with cp.async; otherwise one plain load
// per pixel or byte.  Ends with a barrier.
template <class T, bool PACKED, bool VEC>
__device__ __forceinline__ void load_tile(const void* __restrict__ frame, int H, int W, int x0,
                                          int y0, void* smem) {
  if (PACKED) {
    const uint32_t* f = (const uint32_t*)frame;
    uint32_t* s = (uint32_t*)smem;
    if (VEC) {
      constexpr int CH = T::PK_COLS / 4;
      for (int k = threadIdx.x; k < T::SROWS * CH; k += T::THREADS) {
        const int r = k / CH, c = (k - r * CH) * 4;
        const int y = y0 - 1 + r, x = x0 - T::PK_PAD + c;
        if (y >= 0 && y < H && x >= 0 && x < W)
          cp_async16(s + r * T::PK_COLS + c, f + (size_t)y * W + x);
      }
      cp_async_wait_all();
    } else {
      for (int k = threadIdx.x; k < T::SROWS * T::PK_COLS; k += T::THREADS) {
        const int r = k / T::PK_COLS, c = k - r * T::PK_COLS;
        const int y = y0 - 1 + r, x = x0 - T::PK_PAD + c;
        if (y >= 0 && y < H && x >= 0 && x < W) s[k] = __ldg(f + (size_t)y * W + x);
      }
    }
  } else {
    const uint8_t* f = (const uint8_t*)frame;
    uint8_t* s = (uint8_t*)smem;
    const size_t plane = (size_t)H * W;
    if (VEC) {
      constexpr int CH = T::PL_COLS / 16;
      for (int k = threadIdx.x; k < 4 * T::SROWS * CH; k += T::THREADS) {
        const int pr = k / CH, c = (k - pr * CH) * 16;  // pr = plane * SROWS + row
        const int ch = pr / T::SROWS, r = pr - ch * T::SROWS;
        const int y = y0 - 1 + r, x = x0 - T::PL_PAD + c;
        if (y >= 0 && y < H && x >= 0 && x < W)
          cp_async16(s + pr * T::PL_COLS + c, f + ch * plane + (size_t)y * W + x);
      }
      cp_async_wait_all();
    } else {
      for (int k = threadIdx.x; k < 4 * T::SROWS * T::PL_COLS; k += T::THREADS) {
        const int pr = k / T::PL_COLS, c = k - pr * T::PL_COLS;
        const int ch = pr / T::SROWS, r = pr - ch * T::SROWS;
        const int y = y0 - 1 + r, x = x0 - T::PL_PAD + c;
        if (y >= 0 && y < H && x >= 0 && x < W) s[k] = __ldg(f + ch * plane + (size_t)y * W + x);
      }
    }
  }
  __syncthreads();
}

// RUN pixels of tile row r (smem row, halo included) from tile column c:
// out[1 + j] = pixel c + j, out[0] / out[RUN + 1] its left / right
// neighbours (with_sides), as (R, G, B, A).
template <class T, bool PACKED>
__device__ __forceinline__ void read_run(const void* smem, int r, int c, int out[RUN + 2][4],
                                         bool with_sides) {
  if (PACKED) {
    const uint32_t* s = (const uint32_t*)smem + r * T::PK_COLS + T::PK_PAD + c;
    const uint4 q = *reinterpret_cast<const uint4*>(s);
    unpack(q.x, out[1]);
    unpack(q.y, out[2]);
    unpack(q.z, out[3]);
    unpack(q.w, out[4]);
    if (with_sides) {
      unpack(s[-1], out[0]);
      unpack(s[RUN], out[RUN + 1]);
    }
  } else {
    const uint8_t* s = (const uint8_t*)smem + r * T::PL_COLS + T::PL_PAD + c;
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      const uint8_t* sp = s + ch * T::SROWS * T::PL_COLS;
      const uint32_t q = *reinterpret_cast<const uint32_t*>(sp);
#pragma unroll
      for (int j = 0; j < RUN; ++j) out[1 + j][ch] = (q >> (8 * j)) & 255;
      if (with_sides) {
        out[0][ch] = sp[-1];
        out[RUN + 1][ch] = sp[RUN];
      }
    }
  }
}

// The planar tile's words at tile row r (smem row, halo included) and tile
// column c (a multiple of 4): plane ch's 4 bytes (byte j = pixel c + j) are
// word [ch * PL_PLANE_WORDS]; the word left of it is [-1], the one above
// [-PL_ROW_WORDS].
template <class T>
__device__ __forceinline__ const uint32_t* tile_words(const void* smem, int r, int c) {
  return reinterpret_cast<const uint32_t*>((const uint8_t*)smem + r * T::PL_COLS + T::PL_PAD + c);
}
