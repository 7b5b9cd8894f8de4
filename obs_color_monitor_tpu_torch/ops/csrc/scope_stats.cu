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
// Either count can run alone, so the same kernels also stand in for the
// TPU's standalone vectorscope (K7), waveform (K8) and fused (K6) kernels
// of pallas_stats.py, which the JAX analyze() runs off its fast path.
//
// What bounds it: fixed costs and instruction issue, not bytes (the
// inputs are 6 B per scaled pixel, ~12 MB at 1920x1080).  The design:
//   * loads in flight: each block streams its pixels through a ring of
//     shared-memory stages filled by 16-byte cp.async copies, so the next
//     tiles' loads are outstanding while the current one is counted.  A
//     plane whose base (or, for the waveform, whose rows) is not 16-byte
//     aligned runs the same kernel with the stages filled by plain loads;
//   * counters in shared memory, 16 bits each, packed two to a 32-bit
//     word.  INVARIANT: no block adds more than 65535 to one field: a
//     vectorscope block counts at most 65520 pixels and a waveform block at
//     most 65535 rows (ops/scope_stats.py::stats_plan keeps both);
//   * thread block clusters: the blocks of a cluster merge their counters
//     through distributed shared memory, each block summing its slice of
//     the bins across its peers, so the merge makes no global atomics.
//     Vectorscope: 8 blocks per cluster each count a run of pixels (8 per
//     thread and stage, their bins made by byte permutes) and the cluster
//     stores one int32 partial (a single cluster writes vs directly); a
//     block marks its non-zero 16-byte chunks of counters after counting
//     and the merge reads only marked chunks, since moving a block's whole
//     128 KB across the cluster costs more than its counting.  Waveform:
//     the blocks of a cluster share a 32-column strip and split its rows;
//     the cluster writes the strip once with plain stores.  Neither output
//     needs zeroing;
//   * the two counts overlap: the waveform grid is launched as the
//     vectorscope grid's programmatic dependent (PDL) and runs on the SMs
//     the vectorscope grid leaves free (the plan gives it fewer blocks when
//     both run); at its end it waits for the vectorscope grid and sums the
//     clusters' partials into vs.  The vectorscope alone (K7) sums them in
//     a small second launch;
//   * a flat frame (every pixel in one bin) does not serialise on one
//     counter: a vectorscope warp whose pixels share one bin adds them in
//     one atomic, and a waveform warp's lanes are 32 columns, 32 counters.
//
// The dynamic ROI (an optional (4,) int32 rect in device memory,
// dyn_rect.cuh) restricts both counts to the pixels inside it, as the JAX
// analyze(rect_dyn=) masks them (ops/fused.py:172-188): the vectorscope
// skips the runs outside the rect's rows and tests each pixel's row and
// column, the waveform counts only the rect's rows and leaves the columns
// outside it zero.  The grids depend on (h, w) alone, so a new rect
// changes no launch.
//
// A batch of B frames counts in one launch of each grid, as vmap adds a grid
// axis to the pallas_call: blockIdx.y is the frame, each input plane of
// frame b lies b frame strides after frame 0's (its own stride: u and v are
// planes of one YUV tensor), and each frame has its own partials and
// outputs, summed and stored per frame.  The rect, when given, is the same
// for every frame.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "dyn_rect.cuh"

namespace cg = cooperative_groups;

// Mirrors obs_color_monitor_tpu_torch/ops/scope_stats.py::StatsPlan.
struct StatsPlan {
  int vs_clusters;            // vectorscope grid: clusters of VS_CLUSTER blocks
  int vs_per_block;           // pixels per block, a multiple of 16, <= 65520
  int vs_vec;                 // u and v 16-byte aligned: cp.async stages
  int wv_strips, wv_cluster;  // waveform grid: 32-column strips x blocks per strip (2 or 4)
  int wv_rows;                // rows per block, <= 65535
  int wv_vec;                 // every plane's rows 16-byte aligned: cp.async stages
};

namespace {

constexpr int VS_CLUSTER = 8;  // vectorscope blocks per cluster
constexpr int VS_BINS = 256 * 256;
constexpr int VS_WORDS = VS_BINS / 2;
constexpr int VS_THREADS = 1024;
constexpr int VS_PX = 8;                   // pixels per thread and stage
constexpr int VS_TILE = VS_PX * VS_THREADS;  // pixels per stage
constexpr int VS_STAGES = 4;
// one bit per 16-byte chunk of counters (8 bins) that is not zero
constexpr int VS_MARK_WORDS = VS_WORDS / 4 / 32;
constexpr size_t VS_SMEM =
    VS_WORDS * 4 + (size_t)VS_STAGES * 2 * VS_TILE + VS_MARK_WORDS * 4;  // 193 KB
// the 16-byte fill gives each thread one chunk of u or v
static_assert(2 * VS_TILE / 16 == VS_THREADS, "one 16-byte chunk per thread");

constexpr int WV_BINS = 256;
constexpr int WV_COLS = 32;       // columns per strip = lanes of a warp
constexpr int WV_WARPS = 16;
constexpr int WV_THREADS = WV_COLS * WV_WARPS;
constexpr int WV_TILE_ROWS = 64;  // rows per stage
constexpr int WV_STAGES = 3;
constexpr int WV_WORDS = 3 * (WV_BINS / 2) * WV_COLS;  // [channel][bin pair][column]
constexpr int WV_STAGE_BYTES = 4 * WV_TILE_ROWS * WV_COLS;  // [plane][row][column]
constexpr size_t WV_SMEM = WV_WORDS * 4 + (size_t)WV_STAGES * WV_STAGE_BYTES;  // 72 KB
// the 16-byte fill gives each thread one chunk: [plane][row][half]
static_assert(4 * WV_TILE_ROWS * 2 == WV_THREADS, "one 16-byte chunk per thread");

constexpr int RED_THREADS = 256;  // the partials' sum: 4 bins per thread

// 16-byte copy global -> shared, zero-filling past `src_bytes` (0..16).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void add_field(uint32_t* cnt, int bin, uint32_t count) {
  atomicAdd(cnt + (bin >> 1), count << ((bin & 1) * 16));
}


// ---- vectorscope ----

// Stage `slot` <- pixels [t0, t0 + len) of u and v (t0 a multiple of 16).
template <bool VEC>
__device__ __forceinline__ void vs_fill(uint8_t* slot, const uint8_t* __restrict__ u,
                                        const uint8_t* __restrict__ v, long long t0, int len) {
  const int plane = threadIdx.x / (VS_TILE / 16);
  const int off = (threadIdx.x % (VS_TILE / 16)) * 16;
  if (VEC) {
    if (off < len)
      cp_async16(slot + plane * VS_TILE + off, (plane ? v : u) + t0 + off, min(16, len - off));
  } else {
    const uint8_t* src = (plane ? v : u) + t0;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (off + j < len) slot[plane * VS_TILE + off + j] = __ldg(src + off + j);
  }
}

template <bool RECT, bool VEC>
__global__ void __launch_bounds__(VS_THREADS, 1)
vs_count_kernel(const uint8_t* __restrict__ u, const uint8_t* __restrict__ v, long long u_stride,
                long long v_stride, long long n, int w, int h, const int* __restrict__ rect,
                int per_block, int* __restrict__ partial) {
  extern __shared__ __align__(16) uint32_t hist[];  // word k: bin 2k in bits 0-15, 2k+1 in 16-31
  uint32_t* mark = hist + VS_WORDS;                  // touched chunks, VS_MARK_WORDS
  uint8_t* stages = reinterpret_cast<uint8_t*>(mark + VS_MARK_WORDS);  // [stage][u, v][VS_TILE]
  cg::cluster_group cluster = cg::this_cluster();
  // frame fr of the batch: its planes and its clusters' partials
  const int fr = blockIdx.y;
  u += u_stride * fr;
  v += v_stride * fr;
  partial += (size_t)fr * (gridDim.x / VS_CLUSTER) * VS_BINS;
  // the waveform kernel, launched after this one as its programmatic
  // dependent, may start now and share the SMs (it reads none of our output
  // until its griddepcontrol.wait)
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  for (int k = threadIdx.x; k < VS_WORDS / 4; k += VS_THREADS)
    reinterpret_cast<uint4*>(hist)[k] = make_uint4(0, 0, 0, 0);
  DynRect r{0, 0, w, h};
  if (RECT) r = load_dyn_rect(rect, w, h);
  // this block's pixels [c0, c1): its run, in rect mode cut to the rect's
  // rows (c0 rounded down to a 16-byte boundary, still inside the run)
  const long long b0 = (long long)blockIdx.x * per_block;
  const long long b1 = min(b0 + per_block, n);
  long long c0 = b0, c1 = b1;
  if (RECT) {
    c0 = max(b0, ((long long)r.y0 * w) & ~15ll);
    c1 = min(b1, (long long)r.y1 * w);
  }
  const int ntiles = c1 > c0 ? (int)((c1 - c0 + VS_TILE - 1) / VS_TILE) : 0;
  auto fill = [&](int t) {
    if (t < ntiles) {
      const long long t0 = c0 + (long long)t * VS_TILE;
      vs_fill<VEC>(stages + (t % VS_STAGES) * 2 * VS_TILE, u, v, t0,
                   (int)min((long long)VS_TILE, c1 - t0));
    }
    cp_async_commit();  // one group per tile, empty or not
  };
  for (int t = 0; t < VS_STAGES - 1; ++t) fill(t);
  const int lane = threadIdx.x & 31;
  for (int t = 0; t < ntiles; ++t) {
    fill(t + VS_STAGES - 1);  // its slot was released by the barrier ending tile t - 1
    cp_async_wait<VS_STAGES - 1>();
    __syncthreads();
    const uint8_t* slot = stages + (t % VS_STAGES) * 2 * VS_TILE;
    const long long t0 = c0 + (long long)t * VS_TILE;
    const int off = threadIdx.x * VS_PX;
    const long long i0 = t0 + off;
    // the thread's 8 pixels i0 .. i0 + 7: bin j = v * 256 + u in the 16-bit
    // half j % 2 of pk[j / 2], and bit j of `valid`
    const uint2 qu = *reinterpret_cast<const uint2*>(slot + off);
    const uint2 qv = *reinterpret_cast<const uint2*>(slot + VS_TILE + off);
    const uint32_t pk[4] = {__byte_perm(qu.x, qv.x, 0x5140), __byte_perm(qu.x, qv.x, 0x7362),
                            __byte_perm(qu.y, qv.y, 0x5140), __byte_perm(qu.y, qv.y, 0x7362)};
    auto bin_of = [&](int j) { return (int)((pk[j / 2] >> (16 * (j & 1))) & 0xffffu); };
    unsigned valid;
    if (RECT) {  // < 2^31 pixels in rect mode (the wrapper checks)
      unsigned y = (unsigned)i0 / (unsigned)w, x = (unsigned)i0 - y * (unsigned)w;
      valid = 0;
#pragma unroll
      for (int j = 0; j < VS_PX; ++j) {
        if (i0 + j < c1 && (int)x >= r.x0 && (int)x < r.x1 && (int)y >= r.y0 && (int)y < r.y1)
          valid |= 1u << j;
        if (++x == (unsigned)w) {
          x = 0;
          ++y;
        }
      }
    } else {
      valid = i0 + VS_PX <= c1 ? 0xffu : i0 >= c1 ? 0u : (1u << (int)(c1 - i0)) - 1;
    }
    const unsigned active = __ballot_sync(0xffffffffu, valid != 0);
    if (active != 0) {  // warp-uniform
      const int leader = __ffs(active) - 1;
      int first = 0;  // the thread's first valid bin (constant indices: pk stays in registers)
#pragma unroll
      for (int j = VS_PX - 1; j >= 0; --j)
        if ((valid >> j) & 1) first = bin_of(j);
      const int bin0 = __shfl_sync(0xffffffffu, first, leader);
      bool same;
      if (valid == 0xffu) {
        same = pk[0] == pk[1] && pk[1] == pk[2] && pk[2] == pk[3] && pk[0] == bin0 * 0x10001u;
      } else {
        same = true;
#pragma unroll
        for (int j = 0; j < VS_PX; ++j) same = same && (!((valid >> j) & 1) || bin_of(j) == bin0);
      }
      if (__all_sync(0xffffffffu, same)) {
        // one bin for the whole warp: one atomic with its population
        const int total = __reduce_add_sync(0xffffffffu, __popc(valid));
        if (lane == leader) add_field(hist, bin0, (uint32_t)total);
      } else {
#pragma unroll
        for (int j = 0; j < VS_PX; ++j)
          if ((valid >> j) & 1) add_field(hist, bin_of(j), 1u);
      }
    }
    __syncthreads();  // the slot is free for the fill of tile t + VS_STAGES
  }
  cp_async_wait<0>();
  __syncthreads();
  // mark the 16-byte chunks of counters that are not zero, a ballot per 32
  for (int k = threadIdx.x; k < VS_WORDS / 4; k += VS_THREADS) {
    const uint4 q = reinterpret_cast<const uint4*>(hist)[k];
    const unsigned nz = __ballot_sync(0xffffffffu, (q.x | q.y | q.z | q.w) != 0);
    if (lane == 0) mark[k >> 5] = nz;
  }

  // merge: block `rank` sums its slice of the words over the cluster's
  // blocks (starting at its own rank, so the peers are read in turn) and
  // stores the cluster's int32 counts of those bins.  Gathering every
  // peer's 128 KB of counters through distributed shared memory would cost
  // more than the counting, so a peer's chunk is read only if that peer
  // marked it non-zero (a frame's u, v cover a small part of the plane)
  cluster.sync();
  const unsigned rank = cluster.block_rank();
  constexpr int slice = VS_WORDS / VS_CLUSTER;
  int* out = partial + (size_t)(blockIdx.x / VS_CLUSTER) * VS_BINS;
  for (int k = threadIdx.x * 4; k < slice; k += VS_THREADS * 4) {
    const int word = (int)rank * slice + k;
    int lo[4] = {0, 0, 0, 0}, hi[4] = {0, 0, 0, 0};
    uint4 a[VS_CLUSTER];  // every peer's marked chunk first, so their reads overlap
#pragma unroll
    for (int q = 0; q < VS_CLUSTER; ++q) {
      const unsigned peer = (rank + q) % VS_CLUSTER;
      const uint32_t marks = *cluster.map_shared_rank(mark + (word >> 7), peer);
      a[q] = (marks >> ((word >> 2) & 31)) & 1
                 ? *reinterpret_cast<const uint4*>(cluster.map_shared_rank(hist, peer) + word)
                 : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int q = 0; q < VS_CLUSTER; ++q) {
      const uint32_t ws[4] = {a[q].x, a[q].y, a[q].z, a[q].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lo[j] += (int)(ws[j] & 0xffffu);
        hi[j] += (int)(ws[j] >> 16);
      }
    }
    int4* dst = reinterpret_cast<int4*>(out + 2 * word);
    dst[0] = make_int4(lo[0], hi[0], lo[1], hi[1]);
    dst[1] = make_int4(lo[2], hi[2], lo[3], hi[3]);
  }
  cluster.sync();  // no block leaves while a peer still reads its counters
}

// vs[i .. i + 3] = the sum of the clusters' (clusters, 65536) partials.
__device__ __forceinline__ void vs_reduce4(const int* partial, int clusters, int* vs, int i) {
  int4 s = make_int4(0, 0, 0, 0);
#pragma unroll 4
  for (int c = 0; c < clusters; ++c) {
    // a plain load: in the waveform kernel's tail the partials were written
    // by a grid that was still running when this one started
    const int4 q = *reinterpret_cast<const int4*>(partial + (size_t)c * VS_BINS + i);
    s.x += q.x;
    s.y += q.y;
    s.z += q.z;
    s.w += q.w;
  }
  *reinterpret_cast<int4*>(vs + i) = s;
}

// The partials' sum when the vectorscope runs alone (K7); blockIdx.y is the
// frame.
__global__ void __launch_bounds__(RED_THREADS)
vs_reduce_kernel(const int* __restrict__ partial, int clusters, int* __restrict__ vs) {
  const size_t fr = blockIdx.y;
  vs_reduce4(partial + fr * clusters * VS_BINS, clusters, vs + fr * VS_BINS,
             (blockIdx.x * RED_THREADS + threadIdx.x) * 4);
}

// ---- waveform ----

// Stage `slot` <- rows [y0, y0 + nrows) of the strip's columns [x0, x0 +
// 32) of the three data planes and the mask (null: none).
template <bool VEC>
__device__ __forceinline__ void wv_fill(uint8_t* slot, const uint8_t* __restrict__ data,
                                        long long plane_stride, const uint8_t* __restrict__ mask,
                                        int w, int x0, int y0, int nrows) {
  const int nplanes = mask != nullptr ? 4 : 3;
  if (VEC) {  // one 16-byte chunk per thread: [plane][row][half]
    const int plane = threadIdx.x / (2 * WV_TILE_ROWS), row = (threadIdx.x / 2) % WV_TILE_ROWS;
    const int half = threadIdx.x & 1, x = x0 + 16 * half;
    if (plane < nplanes && row < nrows && x < w) {  // w % 16 == 0: a chunk is whole
      const uint8_t* src = plane < 3 ? data + plane * plane_stride : mask;
      cp_async16(slot + (plane * WV_TILE_ROWS + row) * WV_COLS + 16 * half,
                 src + (size_t)(y0 + row) * w + x, 16);
    }
  } else {
    for (int k = threadIdx.x; k < nplanes * WV_TILE_ROWS * WV_COLS; k += WV_THREADS) {
      const int plane = k / (WV_TILE_ROWS * WV_COLS), row = (k / WV_COLS) % WV_TILE_ROWS;
      const int x = x0 + k % WV_COLS;
      if (row < nrows && x < w) {
        const uint8_t* src = plane < 3 ? data + plane * plane_stride : mask;
        slot[k] = __ldg(src + (size_t)(y0 + row) * w + x);
      }
    }
  }
}

template <int CL, bool VEC, bool MASK>
__global__ void __launch_bounds__(WV_THREADS)
wv_count_kernel(const uint8_t* __restrict__ data, long long plane_stride, long long data_stride,
                const uint8_t* __restrict__ mask, long long mask_stride,
                const int* __restrict__ rect, int h, int w, int rows_per_block,
                int* __restrict__ wv, const int* vs_partial, int vs_clusters, int* vs) {
  extern __shared__ __align__(16) uint32_t cnt[];  // [channel][bin pair][column]
  uint8_t* stages = reinterpret_cast<uint8_t*>(cnt + WV_WORDS);
  cg::cluster_group cluster = cg::this_cluster();
  // frame fr of the batch: its planes, its waveform, its vectorscope
  const int fr = blockIdx.y;
  data += data_stride * fr;
  if (MASK) mask += mask_stride * fr;
  wv += (size_t)fr * 3 * WV_BINS * w;
  if (vs != nullptr) {
    vs += (size_t)fr * VS_BINS;
    vs_partial += (size_t)fr * vs_clusters * VS_BINS;
  }
  const int rank = (int)cluster.block_rank();
  for (int k = threadIdx.x; k < WV_WORDS / 4; k += WV_THREADS)
    reinterpret_cast<uint4*>(cnt)[k] = make_uint4(0, 0, 0, 0);
  const DynRect r = rect != nullptr ? load_dyn_rect(rect, w, h) : DynRect{0, 0, w, h};
  const int x0 = (int)(blockIdx.x / CL) * WV_COLS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = x0 + lane;
  // this block's rows of the strip, cut to the rect's; no rows when the
  // strip lies wholly outside the rect's columns
  int ya = max(rank * rows_per_block, r.y0);
  const int yb = min(min(rank * rows_per_block + rows_per_block, h), r.y1);
  if (x0 >= r.x1 || x0 + WV_COLS <= r.x0) ya = yb;
  const int ntiles = yb > ya ? (yb - ya + WV_TILE_ROWS - 1) / WV_TILE_ROWS : 0;
  auto fill = [&](int t) {
    if (t < ntiles) {
      const int y0 = ya + t * WV_TILE_ROWS;
      wv_fill<VEC>(stages + (t % WV_STAGES) * WV_STAGE_BYTES, data, plane_stride, mask, w, x0, y0,
                   min(WV_TILE_ROWS, yb - y0));
    }
    cp_async_commit();
  };
  for (int t = 0; t < WV_STAGES - 1; ++t) fill(t);
  const bool col_in = x < w && x >= r.x0 && x < r.x1;
  for (int t = 0; t < ntiles; ++t) {
    fill(t + WV_STAGES - 1);
    cp_async_wait<WV_STAGES - 1>();
    __syncthreads();
    const uint8_t* slot = stages + (t % WV_STAGES) * WV_STAGE_BYTES;
    const int nrows = min(WV_TILE_ROWS, yb - (ya + t * WV_TILE_ROWS));
    if (col_in) {
      uint32_t* const col = cnt + lane;
#pragma unroll 2
      for (int row = warp; row < nrows; row += WV_WARPS) {
        const int i = row * WV_COLS + lane;
        if (!MASK || slot[3 * WV_TILE_ROWS * WV_COLS + i] != 0) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const uint32_t val = slot[c * WV_TILE_ROWS * WV_COLS + i];
            // lanes are columns: 32 distinct counters, whatever the values
            atomicAdd(col + (c * (WV_BINS / 2) + (val >> 1)) * WV_COLS, 1u + (val & 1) * 0xffffu);
          }
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  // merge: block `rank` sums its slice of the strip's words over the
  // cluster, 4 words (4 columns of one bin pair) at a time, and writes
  // those counters of the strip, every one (zeros too)
  cluster.sync();
  constexpr int slice = WV_WORDS / CL;
  for (int k = rank * slice + 4 * threadIdx.x; k < (rank + 1) * slice; k += 4 * WV_THREADS) {
    uint4 a[CL];
#pragma unroll
    for (int q = 0; q < CL; ++q)
      a[q] = *reinterpret_cast<const uint4*>(cluster.map_shared_rank(cnt, (rank + q) % CL) + k);
    int lo[4] = {0, 0, 0, 0}, hi[4] = {0, 0, 0, 0};
#pragma unroll
    for (int q = 0; q < CL; ++q) {
      const uint32_t ws[4] = {a[q].x, a[q].y, a[q].z, a[q].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lo[j] += (int)(ws[j] & 0xffffu);
        hi[j] += (int)(ws[j] >> 16);
      }
    }
    const int gx = x0 + k % WV_COLS;
    const int c = k / (WV_COLS * WV_BINS / 2), pair = (k / WV_COLS) % (WV_BINS / 2);
    int* dst = wv + (size_t)(c * WV_BINS + 2 * pair) * w + gx;
    if ((w & 3) == 0 && gx < w) {  // gx % 4 == 0: the 4 columns are whole and aligned
      *reinterpret_cast<int4*>(dst) = make_int4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<int4*>(dst + w) = make_int4(hi[0], hi[1], hi[2], hi[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (gx + j < w) {
          dst[j] = lo[j];
          dst[w + j] = hi[j];
        }
      }
    }
  }
  cluster.sync();

  // with both counts this grid is the vectorscope's programmatic dependent:
  // wait for that grid to finish, then sum its clusters' partials into vs,
  // so that this grid's end is the end of the whole count
  if (vs != nullptr) {
    asm volatile("griddepcontrol.wait;" ::: "memory");
    if (vs_clusters > 1)
      for (int i = (blockIdx.x * WV_THREADS + threadIdx.x) * 4; i < VS_BINS;
           i += gridDim.x * WV_THREADS * 4)
        vs_reduce4(vs_partial, vs_clusters, vs, i);
  }
}

// A cluster launch of `blocks` x `batch` blocks (clusters along x);
// `overlap`: as the programmatic dependent of the launch
// before it on the stream, free to start once that grid's blocks have all
// run griddepcontrol.launch_dependents.
template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, int blocks, int batch, int threads, size_t smem,
                           int cluster, bool overlap, cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, batch);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = overlap ? 2 : 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The shared-memory opt-in, set once per kernel and device (a bit per
// device), so a launch inside a CUDA graph capture makes no other call.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem, unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) done |= bit;
  return err;
}

// Strides between the frames of a batch, in bytes, of each input.
struct FrameStrides {
  long long u, v, data, mask;
};

template <bool RECT, bool VEC>
cudaError_t launch_vs(const StatsPlan& p, const uint8_t* u, const uint8_t* v, int batch,
                      const FrameStrides& fs, int h, int w, const int* rect, int* partial,
                      cudaStream_t st) {
  static unsigned long long done = 0;
  const auto kernel = vs_count_kernel<RECT, VEC>;
  cudaError_t err = opt_in(kernel, VS_SMEM, done);
  if (err != cudaSuccess) return err;
  return launch_cluster(kernel, p.vs_clusters * VS_CLUSTER, batch, VS_THREADS, VS_SMEM,
                        VS_CLUSTER, false, st, u, v, fs.u, fs.v, (long long)h * w, w, h, rect,
                        p.vs_per_block, partial);
}

template <int CL, bool VEC, bool MASK>
cudaError_t launch_wv(const StatsPlan& p, const uint8_t* data, long long plane_stride,
                      const uint8_t* mask, int batch, const FrameStrides& fs, const int* rect,
                      int h, int w, int* wv, const int* vs_partial, int* vs, cudaStream_t st) {
  static unsigned long long done = 0;
  const auto kernel = wv_count_kernel<CL, VEC, MASK>;
  cudaError_t err = opt_in(kernel, WV_SMEM, done);
  if (err != cudaSuccess) return err;
  return launch_cluster(kernel, p.wv_strips * CL, batch, WV_THREADS, WV_SMEM, CL,
                        vs != nullptr, st,
                        data, plane_stride, fs.data, mask, fs.mask, rect, h, w, p.wv_rows, wv,
                        vs_partial, p.vs_clusters, vs);
}

}  // namespace

// need_vs / need_wv pick the counts: both (the counterpart of
// pallas_stats.py::_fused_kernel, K6), the vectorscope alone (::_vs_kernel,
// K7) or the waveform alone (::_wv_kernel, K8); a skipped count's pointers
// may be null.  rect: a (4,) int32 dynamic ROI in device memory, or null
// for the whole plane.  vs_partial: (batch, vs_clusters, 65536) int32
// scratch, or vs itself when vs_clusters == 1.  A batch of `batch` frames:
// frame b's planes lie b strides (u_stride, v_stride, data_stride,
// mask_stride bytes) after frame 0's, and its outputs at vs + b * 65536 and
// wv + b * 3 * 256 * w.  vs and wv are written in full (an empty frame
// launches nothing).  The grids and forms come from the plan
// (ops/scope_stats.py::stats_plan).  Launches on `stream`, allocates
// nothing, returns cudaGetLastError() after its launches.
extern "C" int ocm_scope_stats(const StatsPlan* plan, const void* u, const void* v,
                               const void* data, long long plane_stride, const void* mask,
                               const void* rect, int h, int w, void* vs, void* vs_partial,
                               void* wv, int need_vs, int need_wv, int batch,
                               long long u_stride, long long v_stride, long long data_stride,
                               long long mask_stride, void* stream) {
  const StatsPlan p = *plan;
  const FrameStrides fs{u_stride, v_stride, data_stride, mask_stride};
  const cudaStream_t st = (cudaStream_t)stream;
  const auto *pu = (const uint8_t*)u, *pv = (const uint8_t*)v;
  const auto* pr = (const int*)rect;
  cudaError_t err = cudaSuccess;
  if ((long long)h * w == 0 || batch == 0) return (int)cudaGetLastError();
  int* partial = (int*)vs_partial;
  if (need_vs) {
    if (rect != nullptr)
      err = p.vs_vec ? launch_vs<true, true>(p, pu, pv, batch, fs, h, w, pr, partial, st)
                     : launch_vs<true, false>(p, pu, pv, batch, fs, h, w, pr, partial, st);
    else
      err = p.vs_vec ? launch_vs<false, true>(p, pu, pv, batch, fs, h, w, pr, partial, st)
                     : launch_vs<false, false>(p, pu, pv, batch, fs, h, w, pr, partial, st);
    if (err != cudaSuccess) return (int)err;
    if (!need_wv && p.vs_clusters > 1) {
      vs_reduce_kernel<<<dim3(VS_BINS / (4 * RED_THREADS), batch), RED_THREADS, 0, st>>>(
          partial, p.vs_clusters, (int*)vs);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  if (need_wv) {
    // with both counts the waveform overlaps the vectorscope and ends with
    // the partials' sum
    int* vs_out = need_vs ? (int*)vs : nullptr;
    const auto* pd = (const uint8_t*)data;
    const auto* pm = (const uint8_t*)mask;
    // 4 blocks per strip alone, 2 beside the vectorscope (the plan's choice)
    auto for_cluster = [&](auto cl) {
      constexpr int CL = decltype(cl)::value;
      auto launch = [&](auto vec, auto has_mask) {
        return launch_wv<CL, decltype(vec)::value, decltype(has_mask)::value>(
            p, pd, plane_stride, pm, batch, fs, pr, h, w, (int*)wv, partial, vs_out, st);
      };
      using T = std::true_type;
      using F = std::false_type;
      if (p.wv_vec) return pm != nullptr ? launch(T{}, T{}) : launch(T{}, F{});
      return pm != nullptr ? launch(F{}, T{}) : launch(F{}, F{});
    };
    switch (p.wv_cluster) {
      case 2: err = for_cluster(std::integral_constant<int, 2>{}); break;
      case 4: err = for_cluster(std::integral_constant<int, 4>{}); break;
      default: err = cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
