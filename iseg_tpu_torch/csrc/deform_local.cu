// Grouped dense-local deformable sampling (DCNv3), forward and backward, for
// Hopper (sm_90a). Built by iseg_tpu_torch/ops/kernels/_build.py with nvcc
// into a shared library with a plain C interface, loaded with ctypes.
//
// Replaces the Pallas TPU kernel of iseg_tpu/ops/pallas/deform_local.py
// (_kernel :40-70, launched by _dense_local_pallas_impl :116), in the grouped
// form the model calls, iseg_tpu/ops/deform.py::dense_local_flat, and its
// hand-written recompute backward _dense_local_flat_bwd_math (:242-301):
//
//   out[p, g*gc + j] = sum_o w_o[p, g] * x[p + o, g*gc + j]
//   w_o[p, g] = sum_tap m[p, g, tap] * tri(d_y - o_y) * tri(d_x - o_x)
//   d_y = tap_y + clamp(off_dy[p, g, tap], -r, r), tri(t) = max(0, 1 - |t|)
//
// with o over the (2 (half + r) + 1)^2 integer displacements, zeros outside
// the map, taps y-major, fp32 weights and sums, outputs in their inputs'
// types.
//
// What is kept from the TPU design: nothing between the four inputs and the
// output reaches device memory, and the backward recomputes the weights from
// the four inputs instead of storing them.
//
// What is not kept: the 49-term loop of shifted multiply-adds, the
// pre-shifted copies of the input, the channels-second layout and the channel
// blocking exist because a TPU has no gather. Here the function is a gather:
// tri() is non-zero at no more than two integers, so a tap touches at most
// 2 x 2 pixels, and each (pixel, group) reads at most K*K*4 rows of gc
// contiguous channels.
//
// Kernels:
//   dl_fwd_kernel       from a halo tile in shared memory (see its note
//                       below): a block stages x over a tile of pixels grown
//                       by the corners' reach while its threads load the
//                       tile's three maps and form each (pixel, group, tap)'s
//                       corner and weights once; then each (pixel, group,
//                       vector of V channels) has a thread that sums its
//                       <= 4 K * K corner rows from shared memory.
//   dl_bwd_maps_kernel  from a halo tile in shared memory (see its note
//                       below): a block stages x over a tile of pixels grown
//                       by the corners' reach, the tile's g_out and its three
//                       maps, then each (pixel, group, tap) has a thread that
//                       takes its <= 2 x 2 corner dot products from shared
//                       memory and writes d_modulation, d_off_dy, d_off_dx.
//   dl_bwd_x_kernel     d_x as a tiled gather through shared memory (see
//                       its note below): a block owns a tile of input
//                       pixels of one image and one group; each source
//                       pixel of the tile's halo gets its displacement
//                       weights computed once, by one thread, into shared
//                       memory, and each input pixel then sums
//                       w_o[q - o] * g_out[q - o] over o. No atomics, every
//                       element written once.
// Every output is bitwise repeatable: all sums run in a fixed order.
//
// Gradient conventions follow the hand-written JAX VJP: d tri/dt = -sign(t)
// for |t| < 1, which is 0 at t = 0 and at |t| = 1 (so an integer displacement
// gets no offset gradient), and the clamp passes the gradient in full
// wherever -r <= offset <= r, inclusive, and nothing outside.
//
// What bounds it on the H100: the forward moves x, out and the three maps
// once (about 81 MB at [8,128,128,64], G = 4, bf16 x) and does about 72
// FLOPs per output element, so its bound is bytes. The first kernels were
// simple CUDA-core gathers, limited by the latency of their dependent loads
// (offset -> address -> row in device memory). The forward and the maps
// backward now stage everything they read in shared memory first, so their
// bound is the bytes of the maps (2 x maps + 2 x x of the backward's bytes)
// and the halo's re-reads from L2. A per-pixel d_x gather would recompute
// each source pixel's weights from all 9 taps for every one of the 49 pixels
// it reaches (441 hat products and 1,323 scattered map loads per (pixel,
// group)) and be bound by that issue; the tiled kernel computes them once
// per block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// bfloat16 travels as its 16 bits, so a vector of them is plain data
typedef uint16_t bf16_bits;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16_bits v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16_bits from_f<bf16_bits>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[V]) {
  const Vec<T, V> raw = *reinterpret_cast<const Vec<T, V>*>(p);
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = to_f(raw.v[i]);
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&in)[V]) {
  Vec<T, V> raw;
#pragma unroll
  for (int i = 0; i < V; ++i) raw.v[i] = from_f<T>(in[i]);
  *reinterpret_cast<Vec<T, V>*>(p) = raw;
}

// An offset or modulation map, float32 or bfloat16 by a runtime code.
struct Map {
  const void* p;
  int bf16;
  __device__ __forceinline__ float at(int64_t i) const {
    return bf16 ? to_f(static_cast<const bf16_bits*>(p)[i])
                : static_cast<const float*>(p)[i];
  }
};

struct MapOut {
  void* p;
  int bf16;
  __device__ __forceinline__ void set(int64_t i, float v) const {
    if (bf16)
      static_cast<bf16_bits*>(p)[i] = from_f<bf16_bits>(v);
    else
      static_cast<float*>(p)[i] = v;
  }
};

struct Geometry {
  int B, H, W, C, G, gc, K, r;
  long long xs_b, xs_h, xs_w;  // element strides of x (its channel stride is 1)
  int chunks;                  // gc / V
};

// One tap's clamped displacement split into its lower integer corner and
// the two hat weights per axis: tri(d - floor(d)) = 1 - frac and
// tri(d - floor(d) - 1) = frac, every other integer gets 0.
struct Tap {
  int iy, ix;          // lower corner, relative to the pixel
  float wy[2], wx[2];  // weights of corner rows iy, iy + 1 and columns ix, ix + 1
  __device__ __forceinline__ Tap(float off_y, float off_x, int tap, int K, float r) {
    const int half = (K - 1) / 2;
    const float dy = fminf(fmaxf(off_y, -r), r) + static_cast<float>(tap / K - half);
    const float dx = fminf(fmaxf(off_x, -r), r) + static_cast<float>(tap % K - half);
    const float fy = floorf(dy), fx = floorf(dx);
    wy[1] = dy - fy;
    wy[0] = 1.f - wy[1];
    wx[1] = dx - fx;
    wx[0] = 1.f - wx[1];
    iy = static_cast<int>(fy);
    ix = static_cast<int>(fx);
  }
};

// d_modulation, d_off_dy, d_off_dx from a halo tile in shared memory.
//
// A block owns a th x tw tile of output pixels of one image and gb
// consecutive groups (as many as fill 128 bytes of channels, so that a
// pixel's run of gb * K * K map entries is contiguous). Offsets are
// clamped to +-r, so every corner a tap can touch lies in the tile grown by
// lim = half + r on every side, plus one row and one column on the high side
// (the +1 corner of a displacement of exactly lim, whose weight is 0 but
// whose dot product is taken). The block stages, by cp.async with zero fill
// outside the map, x over that halo and the tile's g_out, one padded row per
// pixel (an odd number of 16-byte units, so that neighbouring pixels'
// vectors fall on other banks); each thread loads its entries' map values
// into registers first, so that those loads are in flight with the copies.
// Each (pixel, group, tap) entry then has a thread of its own: it takes the
// tap's <= 2 x 2 corner dot products <g_out[p], x[corner]> over the group's
// channels from shared memory in a fixed order and writes d_modulation,
// d_off_dy and d_off_dx at the entry (consecutive threads on consecutive
// entries of a pixel's run). The chain offset -> address -> row ends in
// shared memory, and a pixel's taps run on threads of their own instead of
// in series. A thread keeps one (column, group, tap) of the tile and walks
// its rows, so its index arithmetic is done once; the staging loops walk
// their indices with carries, and bf16 pairs are unpacked from 32-bit words
// (GVec). What bounds it: the shared-memory wavefronts of the corner loads,
// whose rows are data-dependent, so lanes of a quarter-warp meet in a bank
// about 2.5 times on average, and the map traffic, which the blocks on an SM
// do not fully overlap with them.
//
// The tile (halo_tiling, shared with the forward): the first of 8 x 8, 4 x
// 8, 4 x 4, ... 1 x 1 whose threads fit a block and whose shared memory fits
// three blocks on an SM (kHaloSmemBudget, matching the launch bounds), else
// one block. At InternImage's K = 3, r = 2 (lim 3) with 16 bf16 channels per
// group, gb = 4: an 8 x 8 tile has a 15 x 15 halo of 144-byte rows, 41,616
// bytes with g_out, 288 threads of 8 entries each; fp32 takes gb = 2, the
// same bytes, and 288 threads of 4 entries.
struct HaloTiling {
  int th, tw;          // output pixels of a tile
  int gb;              // groups per block
  int lim;             // reach of the corners: half + r (and one more on the high side)
  int halo_h, halo_w;  // th + 2 lim + 1, tw + 2 lim + 1
  int px_stride;       // elements of a staged pixel row (gb * gc, padded in the maps kernel)
  int dty;             // tile rows the maps kernel's threads cover at once
  int tiles_x, tiles;  // tiles across a row of the map, and per image
  int threads;
  size_t x_bytes, smem;
};

constexpr int kMapsItems = 8;  // tile rows a thread walks, at most
constexpr int kMapsMaxThreads = 288;  // and three blocks per SM: at most 75 registers
// Three blocks per SM: the SM's 228 KB less 1 KB reserved per block, thirded
constexpr size_t kHaloSmemBudget = 76800;

// BYTES of global memory to shared memory by cp.async, or zeros where !valid
// (its zero fill: nothing is read, but src must still be an address of the
// tensor). A two-byte vector goes through registers.
template <int BYTES>
__device__ __forceinline__ void stage_async(void* dst, const void* src, bool valid) {
  if constexpr (BYTES >= 4) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                 "n"(BYTES), "r"(valid ? BYTES : 0)
                 : "memory");
  } else {
    *static_cast<bf16_bits*>(dst) = valid ? *static_cast<const bf16_bits*>(src) : bf16_bits(0);
  }
}

__device__ __forceinline__ void stage_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The digits (a, b, c) of e = (a * nb + b) * nc + c, walked from `first`
// by a fixed `stride`, with carries instead of a division per step.
struct Walk3 {
  int a, b, c, da, db, dc, nb, nc;
  __device__ __forceinline__ Walk3(int first, int stride, int nb_, int nc_) : nb(nb_), nc(nc_) {
    c = first % nc;
    b = first / nc % nb;
    a = first / nc / nb;
    dc = stride % nc;
    db = stride / nc % nb;
    da = stride / nc / nb;
  }
  __device__ __forceinline__ void next() {
    c += dc;
    b += db;
    a += da;
    if (c >= nc) {
      c -= nc;
      ++b;
    }
    if (b >= nb) {
      b -= nb;
      ++a;
    }
  }
};

// Stages x of image b, groups g0 .. g0 + gb - 1, over the halo of the tile
// at (y0, x0) into xs by cp.async (one padded row per halo pixel, zeros
// outside the map), x addressed through its strides; the caller commits and
// waits (stage_wait_all).
template <typename T, int V>
__device__ __forceinline__ void stage_x_halo(T* xs, const T* __restrict__ x, const Geometry& g,
                                             const HaloTiling& t, int b, int g0, int y0, int x0) {
  const int nvec = t.gb * g.gc / V;
  const T* xb = x + b * g.xs_b + static_cast<int64_t>(g0) * g.gc;
  for (Walk3 e(threadIdx.x, blockDim.x, t.halo_w, nvec); e.a < t.halo_h; e.next()) {
    const int py = y0 - t.lim + e.a, px = x0 - t.lim + e.b;
    const bool in = py >= 0 && py < g.H && px >= 0 && px < g.W;
    stage_async<sizeof(T) * V>(xs + (e.a * t.halo_w + e.b) * t.px_stride + e.c * V,
                               in ? xb + py * g.xs_h + px * g.xs_w + e.c * V : xb, in);
  }
}

// A vector of V channels of g_out in fp32, held for the four corners, and
// its dot product with a vector of x in channel order.
template <typename T, int V>
struct GVec {
  float v[V];
  __device__ __forceinline__ explicit GVec(const T* p) { load_vec<T, V>(p, v); }
  __device__ __forceinline__ float dot(const T* x) const {
    float xv[V];
    load_vec<T, V>(x, xv);
    float d = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) d = fmaf(v[i], xv[i], d);
    return d;
  }
};

// bfloat16 pairs unpacked from 32-bit words, one operation a value
template <>
struct GVec<bf16_bits, 8> {
  float v[8];
  __device__ __forceinline__ explicit GVec(const bf16_bits* p) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(ws[i] << 16);
      v[2 * i + 1] = __uint_as_float(ws[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ float dot(const bf16_bits* x) const {
    const uint4 w = *reinterpret_cast<const uint4*>(x);
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
    float d = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      d = fmaf(v[2 * i], __uint_as_float(ws[i] << 16), d);
      d = fmaf(v[2 * i + 1], __uint_as_float(ws[i] & 0xffff0000u), d);
    }
    return d;
  }
};

// The (pixel column tx, group gl, tap) entry of a halo tile that a thread of
// the maps kernel or of the forward keeps, at tile rows ty0 + i * dty for i <
// items (consecutive threads on consecutive entries of a pixel's run of
// gb * K * K, so that the map loads coalesce): its index arithmetic is done
// once.
struct TileEntry {
  int tx, ty0, dty, gl, tap, items;
  float tap_y, tap_x;       // the tap's place in the kernel window, from its centre
  int64_t e0, row_entries;  // the map index at tile row 0, and a map row's entries
  __device__ __forceinline__ TileEntry(const Geometry& g, const HaloTiling& t, int b, int g0,
                                       int y0, int x0) {
    const int KK = g.K * g.K, run = t.gb * KK;
    const int k = threadIdx.x % run, q = threadIdx.x / run;
    tx = q % t.tw;
    ty0 = q / t.tw;
    dty = t.dty;
    gl = k / KK;
    tap = k - gl * KK;
    tap_y = static_cast<float>(tap / g.K - (g.K - 1) / 2);
    tap_x = static_cast<float>(tap % g.K - (g.K - 1) / 2);
    // rows of the tile that lie in the map; the tiling keeps items within
    // the kernel's register arrays (kMapsItems, kFwdItems)
    const int rows = min(t.th, g.H - y0);
    items = x0 + tx < g.W && ty0 < rows ? (rows - ty0 + dty - 1) / dty : 0;
    row_entries = static_cast<int64_t>(g.W) * g.G * KK;
    e0 = ((static_cast<int64_t>(b) * g.H + y0) * g.W + x0 + tx) * g.G * KK +
         static_cast<int64_t>(g0) * KK + k;
  }
  // the three map values of every item, all loads issued before any is used
  // (zeros past the items)
  template <int N>
  __device__ __forceinline__ void load(const Map& off_dy, const Map& off_dx, const Map& mod,
                                       float (&oy)[N], float (&ox)[N], float (&om)[N]) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const bool in = i < items;
      const int64_t at = e0 + (ty0 + i * dty) * row_entries;
      oy[i] = in ? off_dy.at(at) : 0.f;
      ox[i] = in ? off_dx.at(at) : 0.f;
      om[i] = in ? mod.at(at) : 0.f;
    }
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(kMapsMaxThreads, 3)
    dl_bwd_maps_kernel(const T* __restrict__ x, Map off_dy, Map off_dx, Map mod,
                       const T* __restrict__ gout, MapOut d_dy, MapOut d_dx, MapOut d_m,
                       Geometry g, HaloTiling t) {
  extern __shared__ __align__(16) unsigned char dl_smem[];
  T* xs = reinterpret_cast<T*>(dl_smem);
  T* gs = reinterpret_cast<T*>(dl_smem + t.x_bytes);
  // the group chunks of a tile are neighbours in the grid, so that the map
  // sectors they share are read while in L2
  const int chunks = g.G / t.gb, tile = blockIdx.x / chunks;
  const int b = blockIdx.y, g0 = (blockIdx.x - tile * chunks) * t.gb;
  const int y0 = (tile / t.tiles_x) * t.th, x0 = (tile % t.tiles_x) * t.tw;
  const int nvec = t.gb * g.gc / V;
  const float r = static_cast<float>(g.r);
  const TileEntry en(g, t, b, g0, y0, x0);
  float oy[kMapsItems], ox[kMapsItems], om[kMapsItems];
  en.load(off_dy, off_dx, mod, oy, ox, om);

  // stage the halo of x and the tile's g_out
  stage_x_halo<T, V>(xs, x, g, t, b, g0, y0, x0);
  const int64_t img = static_cast<int64_t>(b) * g.H;
  for (Walk3 e(threadIdx.x, blockDim.x, t.tw, nvec); e.a < t.th; e.next()) {
    const int py = y0 + e.a, px = x0 + e.b;
    const bool in = py < g.H && px < g.W;
    const T* from = gout + ((img + py) * g.W + px) * g.C + static_cast<int64_t>(g0) * g.gc;
    stage_async<sizeof(T) * V>(gs + (e.a * t.tw + e.b) * t.px_stride + e.c * V,
                               in ? from + e.c * V : gout, in);
  }
  stage_wait_all();
  __syncthreads();

  const int down = t.halo_w * t.px_stride;
#pragma unroll
  for (int i = 0; i < kMapsItems; ++i) {
    if (i >= en.items) continue;
    const int ty = en.ty0 + i * t.dty;
    const float dy = fminf(fmaxf(oy[i], -r), r) + en.tap_y;
    const float dx = fminf(fmaxf(ox[i], -r), r) + en.tap_x;
    const float fy = floorf(dy), fx = floorf(dx);
    const float wy1 = dy - fy, wx1 = dx - fx;
    const float wy0 = 1.f - wy1, wx0 = 1.f - wx1;
    const T* gp = gs + (ty * t.tw + en.tx) * t.px_stride + en.gl * g.gc;
    const T* xc = xs +
                  ((ty + t.lim + static_cast<int>(fy)) * t.halo_w + en.tx + t.lim +
                   static_cast<int>(fx)) * t.px_stride +
                  en.gl * g.gc;
    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // <g_out, x[corner]> over the group's channels
    for (int c = 0; c < g.gc; c += V) {
      const GVec<T, V> gv(gp + c);
#pragma unroll
      for (int cy = 0; cy < 2; ++cy) {
#pragma unroll
        for (int cx = 0; cx < 2; ++cx) s[cy][cx] += gv.dot(xc + cy * down + cx * t.px_stride + c);
      }
    }
    // d tri/dt at the two corners of an axis: -1 and +1 when the
    // displacement is fractional, 0 and 0 when it is an integer
    const float ky = wy1 > 0.f ? 1.f : 0.f;
    const float kx = wx1 > 0.f ? 1.f : 0.f;
    const float row0 = wx0 * s[0][0] + wx1 * s[0][1];
    const float row1 = wx0 * s[1][0] + wx1 * s[1][1];
    const float col0 = wy0 * s[0][0] + wy1 * s[1][0];
    const float col1 = wy0 * s[0][1] + wy1 * s[1][1];
    const int64_t at = en.e0 + ty * en.row_entries;
    d_m.set(at, wy0 * row0 + wy1 * row1);
    d_dy.set(at, oy[i] >= -r && oy[i] <= r ? om[i] * ky * (row1 - row0) : 0.f);
    d_dx.set(at, ox[i] >= -r && ox[i] <= r ? om[i] * kx * (col1 - col0) : 0.f);
  }
}

// acc += w * x[0 .. V) in fp32; bf16 pairs unpacked from 32-bit words, as in GVec
template <typename T, int V>
__device__ __forceinline__ void axpy_vec(float (&acc)[V], float w, const T* x) {
  if constexpr (sizeof(T) == 2 && V == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(x);
    const uint32_t ws[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[2 * i] = fmaf(w, __uint_as_float(ws[i] << 16), acc[2 * i]);
      acc[2 * i + 1] = fmaf(w, __uint_as_float(ws[i] & 0xffff0000u), acc[2 * i + 1]);
    }
  } else {
    float v[V];
    load_vec<T, V>(x, v);
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = fmaf(w, v[i], acc[i]);
  }
}

// The forward from a halo tile in shared memory.
//
// A block owns a tile of halo_tiling (th x tw output pixels of one image, gb
// groups, x over the tile grown by lim = half + r plus one row and column on
// the high side) and runs the maps kernel's threads, each keeping one
// (column, group, tap) entry of the tile at up to kFwdItems rows
// (TileEntry). It
//   1. loads its entries' three map values into registers, all before the
//      first is used, so that those loads are in flight together with
//   2. the cp.async copies of x over the halo (stage_x_halo, shared with the
//      maps kernel: zeros outside the map);
//   3. meanwhile forms each entry's Tap once, into a 16-byte record in shared
//      memory: m * wy0, m * wy1, wx1 and the offset of its lower corner's
//      row in the staged halo;
// then, after one barrier, one thread per (pixel, group, vector of V
// channels) sums its <= 4 K * K corner rows from shared memory, taps in
// order and corners y-major, w = (m * wy) * wx, and writes out once. The
// chain offset -> address -> row ends in shared memory, no map value is
// loaded twice, and the threads of a group's vectors read one record (a
// broadcast). A corner of zero weight is read like any other: it lies in
// the halo, and outside the map it is a staged zero.
//
// The staged rows are not padded: the eight lanes of a quarter-warp read
// the eight 16-byte units of a 128-byte row position (groups and vectors of
// one pixel), each from its own corner pixel, so they fall on eight banks
// whatever the offsets are. The tile fits four blocks on an SM
// (kFwdSmemBudget, and 56 registers by the launch bound). At InternImage's K
// = 3, r = 2 with 16 bf16 channels a group (gb = 4) it is 4 x 8 pixels: an
// 11 x 15 halo of 128-byte rows (21,120 bytes) and 32 x 36 records
// (18,432), 288 threads of 4 entries; fp32 (gb = 2) takes 8 x 8, 47,232
// bytes. What bounds it (ablations on the card, PERF.md §6): the map
// loads, the gather's issue (with bf16 values an unpack and an FMA a value)
// and the halo's copies, which add up rather than overlap. Three blocks of 8
// x 8 tiles, persistent double-buffered blocks, producer and consumer warps,
// and unrolled or reordered phases were no faster.
constexpr int kFwdItems = 4;  // tile rows a thread of the forward walks, at most
constexpr int kFwdBlocksPerSM = 4;
// Four blocks per SM: the SM's 228 KB less 1 KB reserved per block, quartered
constexpr size_t kFwdSmemBudget = 57344;

template <typename T, int V>
__global__ void __launch_bounds__(kMapsMaxThreads, kFwdBlocksPerSM)
    dl_fwd_kernel(const T* __restrict__ x, Map off_dy, Map off_dx, Map mod,
                  T* __restrict__ out, Geometry g, HaloTiling t) {
  extern __shared__ __align__(16) unsigned char dl_smem[];
  T* xs = reinterpret_cast<T*>(dl_smem);
  float4* rec = reinterpret_cast<float4*>(dl_smem + t.x_bytes);  // [pixel][group][tap]
  // the group chunks of a tile are neighbours in the grid, as in the maps kernel
  const int chunks = g.G / t.gb, tile = blockIdx.x / chunks;
  const int b = blockIdx.y, g0 = (blockIdx.x - tile * chunks) * t.gb;
  const int y0 = (tile / t.tiles_x) * t.th, x0 = (tile % t.tiles_x) * t.tw;
  const int KK = g.K * g.K;
  const float r = static_cast<float>(g.r);

  // 1. the map values of this thread's entries
  const TileEntry en(g, t, b, g0, y0, x0);
  float oy[kFwdItems], ox[kFwdItems], om[kFwdItems];
  en.load(off_dy, off_dx, mod, oy, ox, om);
  // 2. x over the halo
  stage_x_halo<T, V>(xs, x, g, t, b, g0, y0, x0);
  // 3. each entry's tap record
  const int k = en.gl * KK + en.tap;
#pragma unroll
  for (int i = 0; i < kFwdItems; ++i) {
    if (i >= en.items) continue;
    const int ty = en.ty0 + i * t.dty;
    const float dy = fminf(fmaxf(oy[i], -r), r) + en.tap_y;
    const float dx = fminf(fmaxf(ox[i], -r), r) + en.tap_x;
    const float fy = floorf(dy), fx = floorf(dx);
    const float wy1 = dy - fy, wx1 = dx - fx;
    const int row = ((ty + t.lim + static_cast<int>(fy)) * t.halo_w + en.tx + t.lim +
                     static_cast<int>(fx)) * t.px_stride + en.gl * g.gc;
    rec[((ty * t.tw + en.tx) * t.gb) * KK + k] =
        make_float4(om[i] * (1.f - wy1), om[i] * wy1, wx1, __int_as_float(row));
  }
  stage_wait_all();
  __syncthreads();

  // the gather: one thread per (pixel, group, vector)
  const int down = t.halo_w * t.px_stride, units = t.gb * g.chunks;
  for (Walk3 e(threadIdx.x, blockDim.x, t.tw, units); e.a < t.th; e.next()) {
    const int py = y0 + e.a, px = x0 + e.b;
    if (py >= g.H || px >= g.W) continue;
    const int gl = e.c / g.chunks;
    const float4* rp = rec + ((e.a * t.tw + e.b) * t.gb + gl) * KK;
    const T* xv = xs + (e.c - gl * g.chunks) * V;
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    for (int tap = 0; tap < KK; ++tap) {
      const float4 w = rp[tap];
      const float wx0 = 1.f - w.z;
      const T* c00 = xv + __float_as_int(w.w);
      axpy_vec<T, V>(acc, w.x * wx0, c00);
      axpy_vec<T, V>(acc, w.x * w.z, c00 + t.px_stride);
      axpy_vec<T, V>(acc, w.y * wx0, c00 + down);
      axpy_vec<T, V>(acc, w.y * w.z, c00 + down + t.px_stride);
    }
    store_vec<T, V>(out + ((static_cast<int64_t>(b) * g.H + py) * g.W + px) * g.C +
                        static_cast<int64_t>(g0) * g.gc + e.c * V,
                    acc);
  }
}

// d_x[q, g*gc + j] = sum_o w_o[q - o, g] * g_out[q - o, g*gc + j], tiled.
//
// A block owns a th x tw tile of input pixels q of one image, for one group.
// The sources q - o of its sums lie in the tile grown by lim = half + r on
// every side (the halo). In shared memory:
//   wsum[o][q]  fp32, the weight w_o[q - o, g] that tile pixel q takes from
//               its source q - o, for every displacement o (span^2 of them,
//               span = 2 lim + 1): o-major, so that neighbouring tile pixels
//               are neighbouring words. Only the (o, q) pairs of the tile are
//               held, span^2 th tw words: holding w_o at every halo pixel
//               instead (span^2 times the halo) left no tile but 1 x 1
//               within a block at r = 6, 30 times slower than r = 4;
//   gs[p][c]    the incoming gradient of the halo pixels, `slab` channels of
//               the group at a time, in its own type; in phase 1 the same
//               bytes hold each warp's staging rows of the maps.
// Phase 1: the block clears wsum (16-byte stores); then the thread that
// owns halo pixel p walks its taps in order, splits each into its <= 2 x 2
// corners (Tap) and adds m * wy * wx to the corner's displacement o at the
// tile pixel q = p + o (skipped where q lies outside the tile), so every
// weight is the sum over p's taps in tap order, computed once. With K = 3 a
// warp first loads its 32 pixels' 9 taps of each map together, consecutive
// lanes on consecutive taps (a pixel's taps are contiguous), and passes
// them to their owners through its staging row: with one pixel a lane,
// every lane would touch a sector of its own per load, and those scattered
// loads were the larger part of the kernel's time. A halo pixel outside
// the map keeps zero weights and a zero gradient, so the gather needs no
// bounds checks.
// Phase 2, per slab of channels: the block loads the halo's g_out (16-byte
// vectors; zeros outside the map), then each (q, vector of V channels) sums
// fmaf(wsum[o][q - o], gs[q - o], acc) over o, y-major, in fp32.
//
// The tile: tw = 16 pixels along x, so that a warp's lanes read neighbouring
// words of wsum and one contiguous run of gs; th the largest of 16, 8, 4,
// 2, 1 whose shared memory fits two blocks on an SM (kDxSmemBudget), with
// smaller widths after that for reaches that need them. At InternImage's K
// = 3, r = 2 (span 7, 49 weights of 196 bytes per tile pixel) and 16 bf16
// channels per group, a 16 x 16 tile has a 22 x 22 halo: 50,176 bytes of
// weights and 18,432 of gradient and staging, two blocks of 512 threads per
// SM; each source pixel's taps are read 1.9 times (484 / 256), against 49
// times in a per-pixel gather. fp32 values take the same tile. At r = 6
// (span 15, 225 weights of 900 bytes per tile pixel) a 4 x 16 tile fits
// two blocks (57,600 bytes of weights).
struct DxTiling {
  int th, tw;          // input pixels of a tile
  int lim, span;       // reach half + r of the displacements, and 2 lim + 1
  int halo_w, halo;    // halo row length and pixel count
  int slab;            // channels of g_out per pass, a multiple of V dividing gc
  int tiles_x, tiles;  // tiles across a row of the map, and per image
  int threads;
  size_t w_bytes, smem;
};

constexpr int kDxMaxThreads = 512;
constexpr int kDxMaxSlab = 32;
constexpr int kDxTaps = 9;  // K = 3: the taps a warp stages together
// Two blocks per SM: the SM's 228 KB less 1 KB reserved per block, halved
constexpr size_t kDxSmemBudget = 115712;
constexpr size_t kDxSmemMax = 232448;  // one block, Hopper's per-block limit
constexpr size_t kDxStageBytes = kDxMaxThreads / 32 * 32 * kDxTaps * 4;  // 18,432

template <typename T, int V>
__global__ void __launch_bounds__(kDxMaxThreads, 2)
    dl_bwd_x_kernel(Map off_dy, Map off_dx, Map mod, const T* __restrict__ gout,
                    T* __restrict__ d_x, Geometry g, DxTiling t) {
  extern __shared__ __align__(16) unsigned char dl_smem[];
  float* wsum = reinterpret_cast<float*>(dl_smem);
  T* gs = reinterpret_cast<T*>(dl_smem + t.w_bytes);
  const int b = blockIdx.z, grp = blockIdx.y;
  const int y0 = (blockIdx.x / t.tiles_x) * t.th, x0 = (blockIdx.x % t.tiles_x) * t.tw;
  const int KK = g.K * g.K, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float r = static_cast<float>(g.r);
  const int64_t img = static_cast<int64_t>(b) * g.H;
  // the pixel index of halo pixel hp in the batch, or -1 outside the map
  auto pixel = [&](int hp) -> int64_t {
    const int hy = hp / t.halo_w;
    const int py = y0 - t.lim + hy, px = x0 - t.lim + (hp - hy * t.halo_w);
    if (hp >= t.halo || py < 0 || py >= g.H || px < 0 || px >= g.W) return -1;
    return (img + py) * g.W + px;
  };
  // the map offset of its taps, or -1
  auto map_base = [&](int hp) -> int64_t {
    const int64_t pix = pixel(hp);
    return pix < 0 ? -1 : (pix * g.G + grp) * KK;
  };

  // phase 1: the weights of every halo pixel
  for (int e = threadIdx.x; e < static_cast<int>(t.w_bytes / 16); e += blockDim.x)
    reinterpret_cast<uint4*>(dl_smem)[e] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  float* stage = reinterpret_cast<float*>(gs) + warp * 32 * kDxTaps;
  const int tile_px = t.th * t.tw;
  for (int first = warp * 32; first < t.halo; first += blockDim.x) {
    const int hp = first + lane;
    const int64_t mine = map_base(hp);
    // halo pixel (hy, hx) is tile pixel (hy - lim, hx - lim); displacement
    // index (oi, oj) = (o_y + lim, o_x + lim) lands on tile pixel
    // (hy + oi - 2 lim, hx + oj - 2 lim)
    const int hy = hp / t.halo_w, hx = hp - hy * t.halo_w;
    auto add_tap = [&](int tap, float oy, float ox, float m) {
      const Tap tp(oy, ox, tap, g.K, r);
#pragma unroll
      for (int cy = 0; cy < 2; ++cy) {
        const int oi = tp.iy + cy + t.lim, qy = hy + oi - 2 * t.lim;
        if (tp.wy[cy] == 0.f || qy < 0 || qy >= t.th) continue;
        const float wy = m * tp.wy[cy];
        float* line = wsum + oi * t.span * tile_px + qy * t.tw;
#pragma unroll
        for (int cx = 0; cx < 2; ++cx) {
          const int oj = tp.ix + cx + t.lim, qx = hx + oj - 2 * t.lim;
          if (tp.wx[cx] == 0.f || qx < 0 || qx >= t.tw) continue;
          float* cell = line + oj * tile_px + qx;
          *cell = fmaf(wy, tp.wx[cx], *cell);
        }
      }
    };
    if (KK != kDxTaps) {  // uniform over the block
      for (int tap = 0; tap < KK && mine >= 0; ++tap)
        add_tap(tap, off_dy.at(mine + tap), off_dx.at(mine + tap), mod.at(mine + tap));
      continue;
    }
    // map values of (pixel first + e / 9, tap e % 9), e = i * 32 + lane
    float oy[kDxTaps], ox[kDxTaps], m[kDxTaps];
    auto stage_map = [&](const Map& map, float (&dst)[kDxTaps]) {
#pragma unroll
      for (int i = 0; i < kDxTaps; ++i) {
        const int e = i * 32 + lane, p = e / kDxTaps;
        const int64_t base = map_base(first + p);
        stage[e] = base < 0 ? 0.f : map.at(base + (e - p * kDxTaps));
      }
      __syncwarp();
#pragma unroll
      for (int tap = 0; tap < kDxTaps; ++tap) dst[tap] = stage[lane * kDxTaps + tap];
      __syncwarp();
    };
    stage_map(off_dy, oy);
    stage_map(off_dx, ox);
    stage_map(mod, m);
    if (mine >= 0) {
#pragma unroll
      for (int tap = 0; tap < kDxTaps; ++tap) add_tap(tap, oy[tap], ox[tap], m[tap]);
    }
  }

  // phase 2, per slab of channels
  const int nvec = t.slab / V;
  const int items = t.th * t.tw * nvec;
  for (int c0 = 0; c0 < g.gc; c0 += t.slab) {
    const int64_t chan = static_cast<int64_t>(grp) * g.gc + c0;
    __syncthreads();  // the weights are in (and the staging rows free); the last slab is done
    for (int e = threadIdx.x; e < t.halo * nvec; e += blockDim.x) {
      const int hp = e / nvec, vec = e - hp * nvec;
      const int64_t pix = pixel(hp);
      Vec<T, V> val;
      if (pix >= 0) {
        val = *reinterpret_cast<const Vec<T, V>*>(gout + pix * g.C + chan + vec * V);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) val.v[i] = T(0);
      }
      *reinterpret_cast<Vec<T, V>*>(gs + hp * t.slab + vec * V) = val;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < items; e += blockDim.x) {
      const int pix = e / nvec, vec = e - pix * nvec;
      const int ty = pix / t.tw, tx = pix - ty * t.tw;
      const int qy = y0 + ty, qx = x0 + tx;
      if (qy >= g.H || qx >= g.W) continue;
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.f;
      // displacement (oi - lim, oj - lim) reads halo pixel (ty + 2 lim - oi, tx + 2 lim - oj)
      const int hp0 = (ty + 2 * t.lim) * t.halo_w + tx + 2 * t.lim;
      for (int oi = 0; oi < t.span; ++oi) {
        for (int oj = 0; oj < t.span; ++oj) {
          const int hp = hp0 - oi * t.halo_w - oj;
          const float w = wsum[(oi * t.span + oj) * tile_px + pix];
          float gv[V];
          load_vec<T, V>(gs + hp * t.slab + vec * V, gv);
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] = fmaf(w, gv[i], acc[i]);
        }
      }
      store_vec<T, V>(d_x + ((img + qy) * g.W + qx) * g.C + chan + vec * V, acc);
    }
  }
}

// The tile of the d_x kernel for this geometry (see its note); false when
// not even a 1 x 1 tile's weights fit a block's shared memory.
bool dx_tiling(const Geometry& g, int vec, int elem_bytes, DxTiling& t) {
  static const int kTiles[][2] = {{16, 16}, {8, 16}, {4, 16}, {2, 16}, {1, 16}, {4, 8},
                                  {4, 4},   {2, 4},  {2, 2},  {1, 2},  {1, 1}};
  t.lim = (g.K - 1) / 2 + g.r;
  t.span = 2 * t.lim + 1;
  t.slab = vec;
  for (int s = vec; s <= g.gc && s <= kDxMaxSlab; s += vec)
    if (g.gc % s == 0) t.slab = s;
  static const size_t kBudgets[] = {kDxSmemBudget, kDxSmemMax};
  for (size_t budget : kBudgets) {
    for (const auto& tile : kTiles) {
      t.th = tile[0];
      t.tw = tile[1];
      t.halo_w = t.tw + 2 * t.lim;
      t.halo = (t.th + 2 * t.lim) * t.halo_w;
      t.w_bytes = (static_cast<size_t>(t.span) * t.span * t.th * t.tw * 4 + 15) / 16 * 16;
      t.smem = t.w_bytes + max(static_cast<size_t>(t.halo) * t.slab * elem_bytes,
                               g.K * g.K == kDxTaps ? kDxStageBytes : size_t{0});
      if (t.smem > budget) continue;
      t.tiles_x = (g.W + t.tw - 1) / t.tw;
      t.tiles = t.tiles_x * ((g.H + t.th - 1) / t.th);
      const int work = max(t.halo, t.th * t.tw * (t.slab / vec));
      t.threads = min(kDxMaxThreads, (work + 31) / 32 * 32);
      return true;
    }
  }
  return false;
}

// The tile of the maps kernel (fwd = false) or of the forward (fwd = true)
// for this geometry (see the maps kernel's note); false when not even a 1 x 1
// tile fits a block. Both kernels run the same threads (TileEntry); beside
// the halo of x, a tile pixel holds its g_out row (maps kernel) or its run of
// 16-byte tap records (forward).
bool halo_tiling(const Geometry& g, int elem_bytes, bool fwd, HaloTiling& t) {
  static const int kTiles[][2] = {{8, 8}, {4, 8}, {4, 4}, {2, 4}, {2, 2}, {1, 2}, {1, 1}};
  t.lim = (g.K - 1) / 2 + g.r;
  t.gb = 1;
  for (int d = 1; d <= g.G; ++d)
    if (g.G % d == 0 && d * g.gc * elem_bytes <= 128) t.gb = d;
  int row_bytes = (t.gb * g.gc * elem_bytes + 15) / 16 * 16;
  // the maps kernel pads its rows to an odd number of 16-byte units (see its
  // note); the forward's gather reads a row's units on consecutive lanes, so
  // rows of 128 bytes put them on eight banks whatever the corner pixels
  if (!fwd && (row_bytes / 16) % 2 == 0) row_bytes += 16;
  t.px_stride = row_bytes / elem_bytes;
  const int run = t.gb * g.K * g.K;  // entries of a tile pixel
  const size_t px_bytes = fwd ? static_cast<size_t>(run) * sizeof(float4) : row_bytes;
  const size_t budgets[] = {fwd ? kFwdSmemBudget : kHaloSmemBudget, kDxSmemMax};
  const int items = fwd ? kFwdItems : kMapsItems;
  for (size_t budget : budgets) {
    for (const auto& tile : kTiles) {
      t.th = tile[0];
      t.tw = tile[1];
      if (run * t.tw > kMapsMaxThreads) continue;
      // the most tile rows at once that divide th and fit the threads
      t.dty = 1;
      for (int d = 1; d <= t.th; ++d)
        if (t.th % d == 0 && run * t.tw * d <= kMapsMaxThreads) t.dty = d;
      if (t.th / t.dty > items) continue;
      t.threads = run * t.tw * t.dty;
      t.halo_h = t.th + 2 * t.lim + 1;
      t.halo_w = t.tw + 2 * t.lim + 1;
      t.x_bytes = static_cast<size_t>(t.halo_h) * t.halo_w * row_bytes;
      t.smem = t.x_bytes + static_cast<size_t>(t.th) * t.tw * px_bytes;
      if (t.smem > budget) continue;
      t.tiles_x = (g.W + t.tw - 1) / t.tw;
      t.tiles = t.tiles_x * ((g.H + t.th - 1) / t.th);
      if (static_cast<long long>(t.tiles) * (g.G / t.gb) >= (1LL << 31)) return false;
      return true;
    }
  }
  return false;
}

constexpr int kDoesNotFit = -1;

template <typename T, int V>
int launch_fwd(const void* x, Map dy, Map dx, Map m, void* out, const Geometry& g,
               cudaStream_t stream) {
  HaloTiling t;
  if (!halo_tiling(g, static_cast<int>(sizeof(T)), true, t) || g.G > 65535 || g.B > 65535)
    return kDoesNotFit;
  auto kernel = dl_fwd_kernel<T, V>;
  if (t.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(t.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(t.tiles * (g.G / t.gb), g.B), t.threads, t.smem, stream>>>(
      static_cast<const T*>(x), dy, dx, m, static_cast<T*>(out), g, t);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_bwd(const void* x, Map dy, Map dx, Map m, const void* gout, void* d_x,
               MapOut d_dy, MapOut d_dx, MapOut d_m, const Geometry& g,
               cudaStream_t stream) {
  DxTiling t;
  HaloTiling mt;
  if (!dx_tiling(g, V, static_cast<int>(sizeof(T)), t) ||
      !halo_tiling(g, static_cast<int>(sizeof(T)), false, mt) || g.G > 65535 || g.B > 65535)
    return kDoesNotFit;
  auto x_kernel = dl_bwd_x_kernel<T, V>;
  if (t.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        x_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(t.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto maps_kernel = dl_bwd_maps_kernel<T, V>;
  if (mt.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        maps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(mt.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  maps_kernel<<<dim3(mt.tiles * (g.G / mt.gb), g.B), mt.threads, mt.smem, stream>>>(
      static_cast<const T*>(x), dy, dx, m, static_cast<const T*>(gout), d_dy, d_dx, d_m, g, mt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  x_kernel<<<dim3(t.tiles, g.G, g.B), t.threads, t.smem, stream>>>(
      dy, dx, m, static_cast<const T*>(gout), static_cast<T*>(d_x), g, t);
  return static_cast<int>(cudaGetLastError());
}

// Fills the derived fields; false when the shape cannot be launched.
bool finish_geometry(Geometry& g, int vec, int elem_bytes) {
  if (g.B < 1 || g.H < 1 || g.W < 1 || g.G < 1 || g.K < 1 || g.r < 0) return false;
  if (g.C % g.G != 0) return false;
  g.gc = g.C / g.G;
  if (vec < 1 || g.gc % vec != 0 || vec * elem_bytes > 16) return false;
  g.chunks = g.gc / vec;
  return true;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, for x (and out, g_out, d_x) and for
// each of the three maps on its own (a map's gradient has its map's type).
// `vec` is the number of channels a thread loads at once: it divides C / G,
// vec * sizeof(element) <= 16, and every row the kernels address (x through
// its strides, out, g_out, d_x contiguous) is aligned to it. Each function
// returns 0, the cudaError_t of a failed launch, or -1 for a shape or type
// it cannot launch; the caller raises on anything but 0.
extern "C" {

int deform_local_fwd(const void* x, const void* off_dy, const void* off_dx,
                     const void* mod, void* out, int x_dtype, int dy_dtype, int dx_dtype,
                     int m_dtype, int B, int H, int W, int C, int G, int K, int r,
                     long long xs_b, long long xs_h, long long xs_w, int vec,
                     void* stream) {
  Geometry g{B, H, W, C, G, 0, K, r, xs_b, xs_h, xs_w, 0};
  if (!finish_geometry(g, vec, x_dtype == 0 ? 4 : 2)) return kDoesNotFit;
  const Map dy{off_dy, dy_dtype}, dx{off_dx, dx_dtype}, m{mod, m_dtype};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) {
    if (vec == 4) return launch_fwd<float, 4>(x, dy, dx, m, out, g, s);
    if (vec == 2) return launch_fwd<float, 2>(x, dy, dx, m, out, g, s);
    if (vec == 1) return launch_fwd<float, 1>(x, dy, dx, m, out, g, s);
  } else if (x_dtype == 1) {
    if (vec == 8) return launch_fwd<bf16_bits, 8>(x, dy, dx, m, out, g, s);
    if (vec == 4) return launch_fwd<bf16_bits, 4>(x, dy, dx, m, out, g, s);
    if (vec == 2) return launch_fwd<bf16_bits, 2>(x, dy, dx, m, out, g, s);
    if (vec == 1) return launch_fwd<bf16_bits, 1>(x, dy, dx, m, out, g, s);
  }
  return kDoesNotFit;
}

int deform_local_bwd(const void* x, const void* off_dy, const void* off_dx,
                     const void* mod, const void* gout, void* d_x, void* d_off_dy,
                     void* d_off_dx, void* d_mod, int x_dtype, int dy_dtype, int dx_dtype,
                     int m_dtype, int B, int H, int W, int C, int G, int K, int r,
                     long long xs_b, long long xs_h, long long xs_w, int vec,
                     void* stream) {
  Geometry g{B, H, W, C, G, 0, K, r, xs_b, xs_h, xs_w, 0};
  if (!finish_geometry(g, vec, x_dtype == 0 ? 4 : 2)) return kDoesNotFit;
  const Map dy{off_dy, dy_dtype}, dx{off_dx, dx_dtype}, m{mod, m_dtype};
  const MapOut ddy{d_off_dy, dy_dtype}, ddx{d_off_dx, dx_dtype}, dm{d_mod, m_dtype};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) {
    if (vec == 4) return launch_bwd<float, 4>(x, dy, dx, m, gout, d_x, ddy, ddx, dm, g, s);
    if (vec == 2) return launch_bwd<float, 2>(x, dy, dx, m, gout, d_x, ddy, ddx, dm, g, s);
    if (vec == 1) return launch_bwd<float, 1>(x, dy, dx, m, gout, d_x, ddy, ddx, dm, g, s);
  } else if (x_dtype == 1) {
    if (vec == 8) return launch_bwd<bf16_bits, 8>(x, dy, dx, m, gout, d_x, ddy, ddx, dm, g, s);
    if (vec == 4) return launch_bwd<bf16_bits, 4>(x, dy, dx, m, gout, d_x, ddy, ddx, dm, g, s);
    if (vec == 2) return launch_bwd<bf16_bits, 2>(x, dy, dx, m, gout, d_x, ddy, ddx, dm, g, s);
    if (vec == 1) return launch_bwd<bf16_bits, 1>(x, dy, dx, m, gout, d_x, ddy, ddx, dm, g, s);
  }
  return kDoesNotFit;
}

}  // extern "C"
