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
//   dl_fwd_kernel       a few threads per (pixel, group), each over vectors
//                       of V channels: per tap, the 2 x 2 corner rows of x
//                       are loaded as 16-byte vectors and accumulated.
//   dl_bwd_maps_kernel  same mapping; per tap the four dot products
//                       <g_out[p], x[corner]> over the group's channels are
//                       reduced over the group's threads by shuffles, and one
//                       thread writes d_modulation, d_off_dy, d_off_dx.
//   dl_bwd_x_kernel     d_x as a gather: each input pixel q walks the
//                       displacement window, recomputes w_o[q - o, g] from
//                       the maps and accumulates w_o * g_out[q - o]. No
//                       atomics, every element written once. A thread holds
//                       up to four vectors of the group's channels, so that
//                       a group of 16 bf16 channels recomputes its weights
//                       in one thread only.
// Every output is bitwise repeatable: all sums run in a fixed order.
//
// Gradient conventions follow the hand-written JAX VJP: d tri/dt = -sign(t)
// for |t| < 1, which is 0 at t = 0 and at |t| = 1 (so an integer displacement
// gets no offset gradient), and the clamp passes the gradient in full
// wherever -r <= offset <= r, inclusive, and nothing outside.
//
// What bounds it on the H100: the forward moves x, out and the three maps
// once (about 81 MB at [8,128,128,64], G = 4, bf16 x) and does about 72
// FLOPs per output element, so its bound is bytes. The kernels are simple
// CUDA-core gathers: the forward and the maps backward are limited by the
// latency of their dependent loads (offset -> address -> row), the d_x
// gather by instruction issue (49 x 9 hat products per (pixel, group)).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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
  int tpg;                     // threads per (pixel, group): a power of two <= 32
  long long total;             // B * H * W * G * tpg threads
};

// Which (pixel, group, thread-in-group) a thread is.
struct Where {
  int t, grp, px, py, b;
  int64_t pix, pg;
  __device__ __forceinline__ Where(const Geometry& g, int64_t tid) {
    t = static_cast<int>(tid % g.tpg);
    pg = tid / g.tpg;
    grp = static_cast<int>(pg % g.G);
    pix = pg / g.G;
    px = static_cast<int>(pix % g.W);
    const int64_t rest = pix / g.W;
    py = static_cast<int>(rest % g.H);
    b = static_cast<int>(rest / g.H);
  }
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

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    dl_fwd_kernel(const T* __restrict__ x, Map off_dy, Map off_dx, Map mod,
                  T* __restrict__ out, Geometry g) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (tid >= g.total) return;
  const Where at(g, tid);
  const int KK = g.K * g.K;
  const float r = static_cast<float>(g.r);
  const int64_t map_base = at.pg * KK;
  const T* xb = x + at.b * g.xs_b + at.grp * g.gc;
  T* ob = out + at.pix * g.C + at.grp * g.gc;

  for (int c = at.t; c < g.chunks; c += g.tpg) {
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    for (int tap = 0; tap < KK; ++tap) {
      const Tap tp(off_dy.at(map_base + tap), off_dx.at(map_base + tap), tap, g.K, r);
      const float m = mod.at(map_base + tap);
#pragma unroll
      for (int cy = 0; cy < 2; ++cy) {
        const int yy = at.py + tp.iy + cy;
        const float wy = m * tp.wy[cy];
        if (yy < 0 || yy >= g.H || tp.wy[cy] == 0.f) continue;
#pragma unroll
        for (int cx = 0; cx < 2; ++cx) {
          const int xx = at.px + tp.ix + cx;
          if (xx < 0 || xx >= g.W || tp.wx[cx] == 0.f) continue;
          const float w = wy * tp.wx[cx];
          float v[V];
          load_vec<T, V>(xb + yy * g.xs_h + xx * g.xs_w + c * V, v);
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] = fmaf(w, v[i], acc[i]);
        }
      }
    }
    store_vec<T, V>(ob + c * V, acc);
  }
}

// d_modulation, d_off_dy, d_off_dx. All 32 lanes of a warp stay in the loop
// (the shuffles need them); a thread past the end works on the last
// (pixel, group) again and writes nothing.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    dl_bwd_maps_kernel(const T* __restrict__ x, Map off_dy, Map off_dx, Map mod,
                       const T* __restrict__ gout, MapOut d_dy, MapOut d_dx, MapOut d_m,
                       Geometry g) {
  int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool active = tid < g.total;
  if (!active) tid = g.total - 1 - (g.tpg - 1 - tid % g.tpg);  // same lane of the last group
  const Where at(g, tid);
  const int KK = g.K * g.K;
  const float r = static_cast<float>(g.r);
  const int64_t map_base = at.pg * KK;
  const T* xb = x + at.b * g.xs_b + at.grp * g.gc;
  const T* gb = gout + at.pix * g.C + at.grp * g.gc;

  for (int tap = 0; tap < KK; ++tap) {
    const float oy = off_dy.at(map_base + tap);
    const float ox = off_dx.at(map_base + tap);
    const float m = mod.at(map_base + tap);
    const Tap tp(oy, ox, tap, g.K, r);
    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // <g_out, x[corner]> over my channels
    for (int c = at.t; c < g.chunks; c += g.tpg) {
      float gv[V];
      load_vec<T, V>(gb + c * V, gv);
#pragma unroll
      for (int cy = 0; cy < 2; ++cy) {
        const int yy = at.py + tp.iy + cy;
        if (yy < 0 || yy >= g.H) continue;
#pragma unroll
        for (int cx = 0; cx < 2; ++cx) {
          const int xx = at.px + tp.ix + cx;
          if (xx < 0 || xx >= g.W) continue;
          float v[V];
          load_vec<T, V>(xb + yy * g.xs_h + xx * g.xs_w + c * V, v);
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < V; ++i) dot = fmaf(gv[i], v[i], dot);
          s[cy][cx] += dot;
        }
      }
    }
    for (int off = g.tpg >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int cy = 0; cy < 2; ++cy)
#pragma unroll
        for (int cx = 0; cx < 2; ++cx)
          s[cy][cx] += __shfl_xor_sync(0xffffffffu, s[cy][cx], off);
    }
    if (active && at.t == 0) {
      // d tri/dt at the two corners of an axis: -1 and +1 when the
      // displacement is fractional, 0 and 0 when it is an integer
      const float ky = tp.wy[1] > 0.f ? 1.f : 0.f;
      const float kx = tp.wx[1] > 0.f ? 1.f : 0.f;
      const float row0 = tp.wx[0] * s[0][0] + tp.wx[1] * s[0][1];
      const float row1 = tp.wx[0] * s[1][0] + tp.wx[1] * s[1][1];
      const float col0 = tp.wy[0] * s[0][0] + tp.wy[1] * s[1][0];
      const float col1 = tp.wy[0] * s[0][1] + tp.wy[1] * s[1][1];
      const bool in_y = oy >= -r && oy <= r;
      const bool in_x = ox >= -r && ox <= r;
      d_m.set(map_base + tap, tp.wy[0] * row0 + tp.wy[1] * row1);
      d_dy.set(map_base + tap, in_y ? m * ky * (row1 - row0) : 0.f);
      d_dx.set(map_base + tap, in_x ? m * kx * (col1 - col0) : 0.f);
    }
  }
}

// d_x[q, g*gc + j] = sum_o w_o[q - o, g] * g_out[q - o, g*gc + j]; d_x is
// contiguous [B, H, W, C] whatever x's strides are. A thread takes NC
// neighbouring vectors of V channels at a time (g.chunks counts those sets).
template <typename T, int V, int NC>
__global__ void __launch_bounds__(kThreads)
    dl_bwd_x_kernel(Map off_dy, Map off_dx, Map mod, const T* __restrict__ gout,
                    T* __restrict__ d_x, Geometry g) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (tid >= g.total) return;
  const Where at(g, tid);
  const int KK = g.K * g.K;
  const int half = (g.K - 1) / 2;
  const int lim = half + g.r;
  const float r = static_cast<float>(g.r);
  const int64_t group_off = static_cast<int64_t>(at.grp) * g.gc;

  for (int c = at.t; c < g.chunks; c += g.tpg) {
    const int64_t chan = group_off + static_cast<int64_t>(c) * (V * NC);
    float acc[NC][V];
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int i = 0; i < V; ++i) acc[n][i] = 0.f;
    for (int oy = -lim; oy <= lim; ++oy) {
      const int py = at.py - oy;
      if (py < 0 || py >= g.H) continue;
      for (int ox = -lim; ox <= lim; ++ox) {
        const int px = at.px - ox;
        if (px < 0 || px >= g.W) continue;
        const int64_t pix = (static_cast<int64_t>(at.b) * g.H + py) * g.W + px;
        const int64_t map_base = (pix * g.G + at.grp) * KK;
        float w = 0.f;
        for (int tap = 0; tap < KK; ++tap) {
          const float dy = fminf(fmaxf(off_dy.at(map_base + tap), -r), r) +
                           static_cast<float>(tap / g.K - half);
          const float ty = 1.f - fabsf(dy - static_cast<float>(oy));
          if (ty <= 0.f) continue;
          const float dx = fminf(fmaxf(off_dx.at(map_base + tap), -r), r) +
                           static_cast<float>(tap % g.K - half);
          const float tx = 1.f - fabsf(dx - static_cast<float>(ox));
          if (tx <= 0.f) continue;
          w = fmaf(mod.at(map_base + tap) * ty, tx, w);
        }
        if (w == 0.f) continue;
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          float gv[V];
          load_vec<T, V>(gout + pix * g.C + chan + n * V, gv);
#pragma unroll
          for (int i = 0; i < V; ++i) acc[n][i] = fmaf(w, gv[i], acc[n][i]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NC; ++n) store_vec<T, V>(d_x + at.pix * g.C + chan + n * V, acc[n]);
  }
}

constexpr int kDoesNotFit = -1;

// Threads per (pixel, group) for g.chunks units of work, and their total.
void set_threads(Geometry& g) {
  g.tpg = 1;
  while (g.tpg * 2 <= g.chunks && g.tpg < 32) g.tpg *= 2;
  g.total = static_cast<long long>(g.B) * g.H * g.W * g.G * g.tpg;
}

int blocks_for(long long total) {
  return static_cast<int>((total + kThreads - 1) / kThreads);
}

template <typename T, int V>
int launch_fwd(const void* x, Map dy, Map dx, Map m, void* out, const Geometry& g,
               cudaStream_t stream) {
  dl_fwd_kernel<T, V><<<blocks_for(g.total), kThreads, 0, stream>>>(
      static_cast<const T*>(x), dy, dx, m, static_cast<T*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_bwd(const void* x, Map dy, Map dx, Map m, const void* gout, void* d_x,
               MapOut d_dy, MapOut d_dx, MapOut d_m, const Geometry& g,
               cudaStream_t stream) {
  dl_bwd_maps_kernel<T, V><<<blocks_for(g.total), kThreads, 0, stream>>>(
      static_cast<const T*>(x), dy, dx, m, static_cast<const T*>(gout), d_dy, d_dx, d_m, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the d_x gather: as many vectors per thread (4, 2 or 1) as divide the group
  Geometry gx = g;
  const int nc = g.chunks % 4 == 0 ? 4 : (g.chunks % 2 == 0 ? 2 : 1);
  gx.chunks = g.chunks / nc;
  set_threads(gx);
  const T* go = static_cast<const T*>(gout);
  T* dxp = static_cast<T*>(d_x);
  if (nc == 4)
    dl_bwd_x_kernel<T, V, 4><<<blocks_for(gx.total), kThreads, 0, stream>>>(dy, dx, m, go, dxp, gx);
  else if (nc == 2)
    dl_bwd_x_kernel<T, V, 2><<<blocks_for(gx.total), kThreads, 0, stream>>>(dy, dx, m, go, dxp, gx);
  else
    dl_bwd_x_kernel<T, V, 1><<<blocks_for(gx.total), kThreads, 0, stream>>>(dy, dx, m, go, dxp, gx);
  return static_cast<int>(cudaGetLastError());
}

// Fills the derived fields; false when the shape cannot be launched.
bool finish_geometry(Geometry& g, int vec, int elem_bytes) {
  if (g.B < 1 || g.H < 1 || g.W < 1 || g.G < 1 || g.K < 1 || g.r < 0) return false;
  if (g.C % g.G != 0) return false;
  g.gc = g.C / g.G;
  if (vec < 1 || g.gc % vec != 0 || vec * elem_bytes > 16) return false;
  g.chunks = g.gc / vec;
  set_threads(g);
  return (g.total + kThreads - 1) / kThreads < (1LL << 31);
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
  Geometry g{B, H, W, C, G, 0, K, r, xs_b, xs_h, xs_w, 0, 0, 0};
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
  Geometry g{B, H, W, C, G, 0, K, r, xs_b, xs_h, xs_w, 0, 0, 0};
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
