// Fused half-pixel bilinear upsample + ignore-label cross-entropy, for
// Hopper (sm_90a). Built by iseg_tpu_torch/ops/kernels/_build.py with nvcc
// into a shared library with a plain C interface, loaded with ctypes.
//
// Replaces the Pallas TPU kernels of iseg_tpu/ops/pallas/upsample_ce.py:
//   forward  _fwd_kernel (:65-81), launched by _run_fwd (:122)
//   backward _bwd_kernel (:84-113), launched by _run_bwd (:159)
//
// What is kept from the TPU design: the loss and its gradient come straight
// from the output-stride logits src [N, h, w, C]; the upsampled
// [N, H, W, C] logits and their gradient never reach device memory.
//
// What is not kept: the TPU kernel fed its matrix unit with dense
// interpolation matrices and a class-major transpose, and accumulated dsrc
// across its sequential grid. Here the interpolation is separable: each
// output row's two source rows are mixed once into shared memory, and every
// output pixel takes its two-tap mix in x from there (taps clamped exactly
// like _interp_matrix), its C logits contiguous in NHWC.
//
// What bounds it on the H100: each call reads N*H*W int32 labels (16 MB at
// 16x512x512) and the small src (1.4 MB, resident in L2), and does no
// tensor-core work; the per-class exp/FMA work (about 4M pixels x 21
// classes) is the larger cost, so the bound is operations.
//
// The forward is a row-premixed pass (fwd_kernel, see its note): a block
// owns a band of output rows and a tile of output columns, mixes each row's
// two source rows once, and computes each pixel's CE from its C logits in
// registers (log2 units, ex2.approx.ftz, classes padded to a bucket, no
// branch per class); block partials are summed by a second pass in a fixed
// order.
//
// The backward is a band-tiled separable gather (bwd_kernel). A block owns
// one image, a band of source rows and a tile of source columns; it walks
// the output rows that touch the band in order, mixes each row's two source
// rows once into shared memory, computes every output pixel's softmax once
// per band (one thread per pixel, its C logits in registers), and applies
// the transposed interpolation as two fixed-order sums: along x by the
// thread that owns (source column, class), along y into that thread's
// register accumulators of the band's rows. What this buys against a gather
// per source pixel: the softmax is recomputed only where bands overlap,
// (band + 1) / band times, instead of four times (and twice inside each),
// the labels are read coalesced about as often, and no lane waits on a zero
// weight. What bounds it: the issue of those softmaxes (a fused multiply-
// add, a max, an SFU exponential and a few adds a class, with no bounds
// checks) and the barriers between the four steps of each pass of output
// rows. Band and tile are chosen by a cost estimate: the recomputed
// softmaxes times the waves of the grid. No atomics, every dsrc element
// written once in the src dtype, bitwise repeatable.
//
// Label semantics follow the TPU kernel: a pixel counts when
// label != ignore_label; a label outside [0, C) that is not ignore_label has
// no true class, so its CE is the full log-sum-exp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>

namespace {

constexpr int kReduceThreads = 1024;
constexpr int kDoesNotFit = -1;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Half-pixel source position of output index `dst`, as _interp_matrix
// computes it: pos = (dst + 0.5) * src_len / dst_len - 0.5, taps clamped to
// [0, src_len - 1]. `scale` is src_len / dst_len.
__device__ __forceinline__ void taps(int dst, float scale, int src_len, int& i0,
                                     int& i1, float& frac) {
  float pos = (static_cast<float>(dst) + 0.5f) * scale - 0.5f;
  float lo = floorf(pos);
  frac = pos - lo;
  int l = static_cast<int>(lo);
  i0 = min(max(l, 0), src_len - 1);
  i1 = min(max(l + 1, 0), src_len - 1);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Second pass: one block sums the partials in a fixed order (fp64).
__global__ void __launch_bounds__(kReduceThreads)
    reduce_kernel(const float2* __restrict__ partials, int count,
                  float* __restrict__ out) {
  double ce = 0.0, valid = 0.0;
  for (int i = threadIdx.x; i < count; i += kReduceThreads) {
    float2 v = partials[i];
    ce += v.x;
    valid += v.y;
  }
  __shared__ double s_ce[kReduceThreads / 32];
  __shared__ double s_valid[kReduceThreads / 32];
  ce = warp_sum(ce);
  valid = warp_sum(valid);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_ce[warp] = ce;
    s_valid[warp] = valid;
  }
  __syncthreads();
  if (warp == 0) {
    ce = s_ce[lane];
    valid = s_valid[lane];
    ce = warp_sum(ce);
    valid = warp_sum(valid);
    if (lane == 0) {
      out[0] = static_cast<float>(ce);
      out[1] = static_cast<float>(valid);
    }
  }
}

// The backward, dsrc[n, i, j, c] = g * sum over output pixels (y, x) of
//   Rh[y, i] * Rw[x, j] * (softmax_c(y, x) - [c == label]) * valid(y, x),
// is separable: a block owns one image, a band of `band` source rows and a
// tile of `tj` source columns (see the note at the top). Once, it finds
// the output columns whose taps touch the tile and each source column's
// weights Rw[x, j] over the output columns that reach it (wcol). Then it
// walks, in order, the output rows whose taps touch the band, `rows` at a
// time:
//   1. vertical mix: each row's two source rows, over the tile's columns and
//      one more on each side, into vrow [rows][tj + 2][CB], in log2 units;
//      the classes from C to the bucket CB get a logit whose power of 2 is
//      0, so that step 2 runs without bounds checks;
//   2. one thread per output pixel (consecutive threads on consecutive x, so
//      the label loads coalesce) mixes its CB logits from vrow once, keeps
//      them in registers, and writes p = (softmax - onehot) * valid * g to
//      pbuf [rows][nx][pst], the exponentials by the SFU (exp2_ftz);
//   3. every (row, j, c) sums Rw[x, j] * p[x, c] over the fixed range of x
//      whose taps hit j, in x order, into rsum;
//   4. the thread that owns (j, c) adds each row's sum times Rh[y, i] to its
//      register accumulator of each band row i, in y order.
// Then every owner writes its band's dsrc[n, i, j, c] once, in src's dtype.
// The output rows and columns are found with the clamped taps arithmetic
// (first_tap_at_least), never with a closed form.
constexpr int kBwdThreads = 256;
constexpr int kMaxBand = 8;
constexpr int kMaxRows = 16;
// four blocks per SM: the SM's 228 KB less 1 KB reserved per block, quartered
constexpr size_t kSmemBudget = 57344;
constexpr size_t kSmemMax = 232448;  // one block, Hopper's per-block limit
// logits are mixed in log2 units, e^(l - m) = 2^(l log2 e - m log2 e): the
// scaling rounds each logit once more, which moves e^(l - m) by about
// |l - m| 2^-24 relative
constexpr float kLog2e = 1.4426950408889634f;
// the logit of a class past C: finite (0 * it is 0), and 2^(it - max) is 0
constexpr float kNoClass = -1e30f;

// 2^x by the SFU, flushing results below 2^-126 to 0. The softmax divides
// each term by a sum >= 1 (its largest term is 2^0), so a flushed term
// changes dsrc by less than 2^-126 * g; the approximation's relative error
// is about 2^-22, far inside UCE_TOL's 1e-4 of max |dsrc|.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct BwdTiling {
  int band;     // source rows per block
  int tj;       // source columns per block; tj * C <= kBwdThreads
  int tiles_x;  // column tiles across w
  int rows;     // output rows per pass
  int nx_cap;   // bound on the output columns a tile's taps touch: (tj + 1) W / w + 3
  int kx_cap;   // bound on the output columns one source column's taps touch
  int pst;      // floats per output pixel in pbuf: the class bucket + 1, odd
  size_t smem;
};

// The smallest dst in [0, dst_len] whose lower (hi = false) or upper (hi =
// true) tap is >= target: taps are non-decreasing in dst.
__device__ __forceinline__ int first_tap_at_least(int target, bool hi, float scale,
                                                  int src_len, int dst_len) {
  int lo = 0, up = dst_len;
  while (lo < up) {
    const int mid = (lo + up) >> 1;
    int i0, i1;
    float frac;
    taps(mid, scale, src_len, i0, i1, frac);
    if ((hi ? i1 : i0) >= target)
      up = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

template <typename T, int CB>
__global__ void __launch_bounds__(kBwdThreads)
    bwd_kernel(const T* __restrict__ src, const int32_t* __restrict__ labels,
               const float* __restrict__ g, T* __restrict__ dsrc, int h, int w, int C,
               int H, int W, float sh, float sw, int ignore_label, BwdTiling t) {
  extern __shared__ __align__(16) float uce_smem[];
  const int n = blockIdx.z;
  const int ib = blockIdx.y * t.band, jb = blockIdx.x * t.tj;
  const int ie = min(h, ib + t.band), je = min(w, jb + t.tj), tw = je - jb;
  const int vw = t.tj + 2;  // vrow columns jb - 1 .. jb + tj
  float* vrow = uce_smem;                      // [rows][vw][CB]
  float* pbuf = vrow + t.rows * vw * CB;       // [rows][nx_cap][pst]
  float* rsum = pbuf + t.rows * t.nx_cap * t.pst;  // [rows][tw][C]
  float* wcol = rsum + t.rows * t.tj * C;      // [tj][kx_cap]
  float* tfx = wcol + t.tj * t.kx_cap;         // [nx_cap]
  int* tx0 = reinterpret_cast<int*>(tfx + t.nx_cap);
  int* tx1 = tx0 + t.nx_cap;
  int* xs = tx1 + t.nx_cap;  // [tj]: the first output column of each source column
  int* xn = xs + t.tj;       // [tj]: and their count

  // the output rows and columns whose taps touch the band and the tile
  const int ylo = first_tap_at_least(ib, true, sh, h, H);
  const int yhi = first_tap_at_least(ie, false, sh, h, H);
  const int xlo = first_tap_at_least(jb, true, sw, w, W);
  const int nx = first_tap_at_least(je, false, sw, w, W) - xlo;  // <= t.nx_cap
  for (int e = threadIdx.x; e < nx; e += blockDim.x) {
    int x0, x1;
    float fx;
    taps(xlo + e, sw, w, x0, x1, fx);
    tx0[e] = x0 - jb + 1;  // in vrow's columns
    tx1[e] = x1 - jb + 1;
    tfx[e] = fx;
  }
  for (int j = threadIdx.x; j < tw; j += blockDim.x) {
    xs[j] = first_tap_at_least(jb + j, true, sw, w, W) - xlo;
    xn[j] = first_tap_at_least(jb + j + 1, false, sw, w, W) - xlo - xs[j];  // <= t.kx_cap
  }
  __syncthreads();
  // Rw[x, jb + j] of the output columns x that source column j collects from
  for (int e = threadIdx.x; e < tw * t.kx_cap; e += blockDim.x) {
    const int j = e / t.kx_cap, k = e - j * t.kx_cap;
    float wx = 0.f;
    if (k < xn[j]) {
      const int xi = xs[j] + k;
      wx = (tx0[xi] == j + 1 ? 1.f - tfx[xi] : 0.f) + (tx1[xi] == j + 1 ? tfx[xi] : 0.f);
    }
    wcol[e] = wx;
  }

  const float gs = g[0];
  const T* img = src + static_cast<int64_t>(n) * h * w * C;
  const int32_t* lab = labels + static_cast<int64_t>(n) * H * W;
  const bool owner = threadIdx.x < tw * C;  // of (j, c) = (threadIdx.x / C, threadIdx.x % C)
  float acc[kMaxBand];
#pragma unroll
  for (int b = 0; b < kMaxBand; ++b) acc[b] = 0.f;

  for (int y0 = ylo; y0 < yhi; y0 += t.rows) {
    const int rows = min(t.rows, yhi - y0);
    __syncthreads();  // the last pass is done with the buffers
    // 1. vertical mix, in log2 units; the classes from C to CB get a logit
    // whose exponential is 0, so that step 2 needs no bounds
    const int per_row = vw * CB;
    for (int e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
      const int r = e / per_row, rest = e - r * per_row;
      const int cc = rest / CB, c = rest - cc * CB, col = jb - 1 + cc;
      float v = kNoClass;
      if (c < C && col >= 0 && col < w) {
        int a0, a1;
        float fy;
        taps(y0 + r, sh, h, a0, a1, fy);
        const int64_t at = static_cast<int64_t>(col) * C + c;
        v = ((1.f - fy) * to_f(img[static_cast<int64_t>(a0) * w * C + at]) +
             fy * to_f(img[static_cast<int64_t>(a1) * w * C + at])) *
            kLog2e;
      }
      vrow[e] = v;
    }
    __syncthreads();
    // 2. one thread per output pixel
    for (int e = threadIdx.x; e < rows * nx; e += blockDim.x) {
      const int r = e / nx, xi = e - r * nx;
      float* pp = pbuf + (r * t.nx_cap + xi) * t.pst;
      const int label = lab[static_cast<int64_t>(y0 + r) * W + xlo + xi];
      if (label == ignore_label) {
#pragma unroll
        for (int c = 0; c < CB; ++c) pp[c] = 0.f;
        continue;
      }
      const float fx = tfx[xi];
      const float* v0 = vrow + (r * vw + tx0[xi]) * CB;
      const float* v1 = vrow + (r * vw + tx1[xi]) * CB;
      float l[CB];
      float m = -INFINITY;
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        l[c] = (1.f - fx) * v0[c] + fx * v1[c];
        m = fmaxf(m, l[c]);
      }
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        l[c] = exp2_ftz(l[c] - m);
        s += l[c];
      }
      const float scale = gs / s;
#pragma unroll
      for (int c = 0; c < CB; ++c) pp[c] = l[c] * scale;
      if (label >= 0 && label < C) pp[label] -= gs;  // the one-hot term
    }
    __syncthreads();
    // 3. the transposed interpolation along x: row sums of every (row, j, c)
    const int per_rs = tw * C;
    for (int e = threadIdx.x; e < rows * per_rs; e += blockDim.x) {
      const int r = e / per_rs, jc = e - r * per_rs;
      const int j = jc / C, c = jc - j * C;
      const float* pr = pbuf + (r * t.nx_cap + xs[j]) * t.pst + c;
      const float* wr = wcol + j * t.kx_cap;
      float sum = 0.f;
      for (int k = 0; k < xn[j]; ++k) sum = fmaf(wr[k], pr[k * t.pst], sum);
      rsum[e] = sum;
    }
    __syncthreads();
    // 4. and along y, into the band's rows, in y order
    if (owner) {
      for (int r = 0; r < rows; ++r) {
        int a0, a1;
        float fy;
        taps(y0 + r, sh, h, a0, a1, fy);
        const float v = rsum[r * per_rs + threadIdx.x];
#pragma unroll
        for (int b = 0; b < kMaxBand; ++b) {
          const int i = ib + b;
          const float wy = (a0 == i ? 1.f - fy : 0.f) + (a1 == i ? fy : 0.f);
          acc[b] = fmaf(wy, v, acc[b]);
        }
      }
    }
  }
  if (owner) {
    T* out = dsrc + (static_cast<int64_t>(n) * h * w + jb) * C + threadIdx.x;
#pragma unroll
    for (int b = 0; b < kMaxBand; ++b)
      if (ib + b < ie) out[static_cast<int64_t>(ib + b) * w * C] = from_f<T>(acc[b]);
  }
}

// The classes the backward's registers hold (its template's CB): C <= CB.
int class_bucket(int C) { return C <= 16 ? 16 : C <= 24 ? 24 : C <= 32 ? 32 : 64; }

// The backward's tiling for this shape (see bwd_kernel), or false when not
// even one output row of a one-column tile fits a block's shared memory.
// Among bands of 8, 4, 2, 1 source rows and tiles of 1 .. kBwdThreads / C
// columns it takes the least estimated cost: the softmaxes recomputed where
// bands and tiles overlap ((band + 1) / band and (tj + 1) / tj of them at an
// upsampling factor of 2 or more), times the waves the grid takes on the
// blocks that fit the SMs over the waves it would take if they divided
// evenly.
bool bwd_tiling(int N, int h, int w, int C, int W, int sms, BwdTiling& t) {
  const int cb = class_bucket(C);
  const int pst = cb + 1;  // odd: neighbouring pixels' classes on other banks
  const double per_col = static_cast<double>(W) / w;  // output columns per source column
  const int kx_cap = static_cast<int>(2 * per_col) + 3;
  const int tj_max = std::min(w, std::max(1, kBwdThreads / C));
  static const size_t kBudgets[] = {kSmemBudget, kSmemMax};
  for (size_t budget : kBudgets) {
    double best = 0.0;
    for (int cap = tj_max; cap >= 1; --cap) {
      const int tiles_x = (w + cap - 1) / cap;
      const int tj = (w + tiles_x - 1) / tiles_x;  // tiles of even width
      if (tj != cap) continue;
      const int nx_cap = std::min(W, static_cast<int>((tj + 1) * per_col) + 3);
      const size_t fixed = (4 * static_cast<size_t>(nx_cap) + 2 * tj + tj * kx_cap) * 4;
      const size_t per_row = (static_cast<size_t>(tj + 2) * cb +
                              static_cast<size_t>(nx_cap) * pst + static_cast<size_t>(tj) * C) *
                             4;
      if (fixed + per_row > budget) continue;
      const int rows = static_cast<int>(std::min<size_t>(kMaxRows, (budget - fixed) / per_row));
      const size_t smem = fixed + rows * per_row;
      const int per_sm = std::max<int>(1, std::min<size_t>(2048 / kBwdThreads,
                                                           233472 / (smem + 1024)));
      for (int band = kMaxBand; band >= 1; band >>= 1) {
        const double blocks = static_cast<double>(N) * ((h + band - 1) / band) * tiles_x;
        const double slots = static_cast<double>(sms) * per_sm;
        const double waves = std::ceil(blocks / slots) / (blocks / slots);
        const double cost = (band + 1.0) / band * (tj + 1.0) / tj * waves;
        if (best == 0.0 || cost < best) {
          best = cost;
          t = BwdTiling{band, tj, tiles_x, rows, nx_cap, kx_cap, pst, smem};
        }
      }
    }
    if (best > 0.0) return true;
  }
  return false;
}

template <typename T>
int launch_bwd(const void* src, const int32_t* labels, const float* g, void* dsrc,
               int N, int h, int w, int C, int H, int W, int ignore_label,
               cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  BwdTiling t;
  if (C > 64 || N > 65535 || !bwd_tiling(N, h, w, C, W, sms, t)) return kDoesNotFit;
  const dim3 grid(t.tiles_x, (h + t.band - 1) / t.band, N);
  if (grid.y > 65535) return kDoesNotFit;
  const int cb = class_bucket(C);
  auto kernel = cb == 16   ? bwd_kernel<T, 16>
                : cb == 24 ? bwd_kernel<T, 24>
                : cb == 32 ? bwd_kernel<T, 32>
                           : bwd_kernel<T, 64>;
  if (t.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(t.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float sh = static_cast<float>(h) / static_cast<float>(H);
  const float sw = static_cast<float>(w) / static_cast<float>(W);
  kernel<<<grid, kBwdThreads, t.smem, stream>>>(static_cast<const T*>(src), labels, g,
                                                static_cast<T*>(dsrc), h, w, C, H, W, sh, sw,
                                                ignore_label, t);
  return static_cast<int>(cudaGetLastError());
}


// The forward: a row-premixed pass (fwd_kernel). A block owns `band`
// consecutive output rows of the batch (a band may run on into the next
// image) and a tile of `tw` output columns (the whole row at the main paths'
// W = 512). It walks its rows `rows` at a time:
//   1. vertical mix: each row's two source rows, over the source columns the
//      tile's taps touch, into vrow [rows][ncap][CB] in log2 units, the
//      classes from C to the bucket CB padded with kNoClass (the backward's
//      step 1);
//   2. one thread per output pixel (consecutive threads on consecutive x, so
//      the label loads coalesce) mixes its CB logits from vrow into
//      registers, takes their max, then the sum of exp2_ftz(l - max) with
//      no branch per class, and the true logit mixed again from vrow by the
//      same operations (none for a label outside [0, C): its CE is the
//      log-sum-exp; a padded class is never read), and adds
//      lse - true logit in nats to its own sum.
// Each block writes (sum ce, sum valid) of its pixels, summed in a fixed
// order, to its partial; reduce_kernel sums the partials in fp64 in a fixed
// order. No atomics: bitwise repeatable. The grid is about one wave of the
// blocks that fit the SMs, and never more than kFwdMaxBlocks partials. What
// bounds it: the SFU's exponentials (one a class and pixel) beside the
// FMAs, maxima and adds of the same loop.
constexpr int kFwdThreads = 256;
constexpr int kFwdMaxRows = 8;
constexpr int kFwdMaxBlocks = 4096;
constexpr float kLn2 = 0.6931471805599453f;
constexpr size_t kFwdSmemMax = kSmemMax - 1024;  // room for the static shared memory

struct FwdTiling {
  int band;     // output rows of the batch per block
  int tw;       // output columns per block
  int tiles_x;  // column tiles across W
  int bands;    // row bands across N * H
  int rows;     // output rows mixed per pass
  int ncap;     // bound on the source columns a tile's taps touch
  size_t smem;
};

template <typename T, int CB>
__global__ void __launch_bounds__(kFwdThreads)
    fwd_kernel(const T* __restrict__ src, const int32_t* __restrict__ labels,
               float2* __restrict__ partials, int h, int w, int C, int H, int W, float sh,
               float sw, int ignore_label, long long rows_total, FwdTiling t) {
  extern __shared__ __align__(16) float uce_smem[];  // vrow [rows][ncap][CB]
  const long long rb = static_cast<long long>(blockIdx.y) * t.band;
  const long long re = min(rows_total, rb + t.band);
  const int xb = blockIdx.x * t.tw, nx = min(W, xb + t.tw) - xb;
  // the source columns the tile's taps touch: taps are non-decreasing in x
  int c_lo, c_hi, unused;
  float frac;
  taps(xb, sw, w, c_lo, unused, frac);
  taps(xb + nx - 1, sw, w, unused, c_hi, frac);
  const int ncols = c_hi - c_lo + 1;  // <= t.ncap

  float ce = 0.f, valid = 0.f;
  for (long long r0 = rb; r0 < re; r0 += t.rows) {
    const int rows = static_cast<int>(min(static_cast<long long>(t.rows), re - r0));
    __syncthreads();  // the last pass is done with vrow
    // 1. vertical mix, in log2 units, padded to the bucket
    for (int r = 0; r < rows; ++r) {
      const long long row = r0 + r;
      const int n = static_cast<int>(row / H), y = static_cast<int>(row - static_cast<long long>(n) * H);
      int a0, a1;
      float fy;
      taps(y, sh, h, a0, a1, fy);
      const T* img = src + static_cast<int64_t>(n) * h * w * C;
      const T* s0 = img + (static_cast<int64_t>(a0) * w + c_lo) * C;
      const T* s1 = img + (static_cast<int64_t>(a1) * w + c_lo) * C;
      float* v = uce_smem + r * t.ncap * CB;
#pragma unroll 4
      for (int e = threadIdx.x; e < ncols * CB; e += kFwdThreads) {
        const int col = e / CB, c = e - col * CB;
        v[e] = c < C ? ((1.f - fy) * to_f(s0[col * C + c]) + fy * to_f(s1[col * C + c])) * kLog2e
                     : kNoClass;
      }
    }
    __syncthreads();
    // 2. one thread per output pixel
    for (int r = 0; r < rows; ++r) {
      const int32_t* lab = labels + (r0 + r) * W + xb;
      const float* v = uce_smem + r * t.ncap * CB;
      for (int xi = threadIdx.x; xi < nx; xi += kFwdThreads) {
        const int label = lab[xi];
        if (label == ignore_label) continue;
        int x0, x1;
        float fx;
        taps(xb + xi, sw, w, x0, x1, fx);
        const float4* v0 = reinterpret_cast<const float4*>(v + (x0 - c_lo) * CB);
        const float4* v1 = reinterpret_cast<const float4*>(v + (x1 - c_lo) * CB);
        float l[CB];
        float m = -INFINITY;
#pragma unroll
        for (int q = 0; q < CB / 4; ++q) {
          const float4 a = v0[q], b = v1[q];
          l[4 * q] = (1.f - fx) * a.x + fx * b.x;
          l[4 * q + 1] = (1.f - fx) * a.y + fx * b.y;
          l[4 * q + 2] = (1.f - fx) * a.z + fx * b.z;
          l[4 * q + 3] = (1.f - fx) * a.w + fx * b.w;
        }
#pragma unroll
        for (int c = 0; c < CB; ++c) m = fmaxf(m, l[c]);
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < CB; ++c) s += exp2_ftz(l[c] - m);
        // the true logit, mixed again from vrow by the same operations (a
        // label outside [0, C) has none, and never reads a padded class)
        const bool has_true = label >= 0 && label < C;
        const float lt = has_true ? (1.f - fx) * v[(x0 - c_lo) * CB + label] +
                                        fx * v[(x1 - c_lo) * CB + label]
                                  : 0.f;
        ce += (log2f(s) + m - lt) * kLn2;
        valid += 1.f;
      }
    }
  }
  __shared__ float s_ce[kFwdThreads / 32];
  __shared__ float s_valid[kFwdThreads / 32];
  ce = warp_sum(ce);
  valid = warp_sum(valid);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_ce[warp] = ce;
    s_valid[warp] = valid;
  }
  __syncthreads();
  if (warp == 0) {
    ce = lane < kFwdThreads / 32 ? s_ce[lane] : 0.f;
    valid = lane < kFwdThreads / 32 ? s_valid[lane] : 0.f;
    ce = warp_sum(ce);
    valid = warp_sum(valid);
    if (lane == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = make_float2(ce, valid);
  }
}

// The partials the forward writes for N * H * W output pixels, at most.
long long fwd_partials(long long pixels) {
  return std::max(1LL, std::min(pixels, static_cast<long long>(kFwdMaxBlocks)));
}

// The forward's tiling (see fwd_kernel), or false when one output row of a
// one-column tile does not fit a block's shared memory. Column tiles of W
// (up to 2048 columns), halved until a row's mix fits; then up to
// kFwdMaxRows rows a pass; then bands of rows for about one wave of `slots`
// blocks (the blocks that fit the SMs at once), within kFwdMaxBlocks.
bool fwd_tiling(int N, int h, int w, int C, int H, int W, int slots, FwdTiling& t) {
  const int cb = class_bucket(C);
  const double per_col = static_cast<double>(w) / W;  // source columns per output column
  static const size_t kBudgets[] = {kSmemBudget, kFwdSmemMax};
  for (size_t budget : kBudgets) {
    for (int tw = std::min(W, 2048);; tw = (tw + 1) / 2) {
      const int ncap = std::min(w, static_cast<int>((tw - 1) * per_col) + 5);
      const size_t per_row = static_cast<size_t>(ncap) * cb * 4;
      if (per_row <= budget) {
        t.tw = tw;
        t.ncap = ncap;
        t.tiles_x = (W + tw - 1) / tw;
        if (t.tiles_x > kFwdMaxBlocks) return false;
        const long long rows_total = static_cast<long long>(N) * H;
        const long long want = std::max(1, slots / t.tiles_x);
        long long band = (rows_total + want - 1) / want;
        while ((rows_total + band - 1) / band * t.tiles_x > kFwdMaxBlocks) band *= 2;
        t.band = static_cast<int>(std::min(band, rows_total));
        t.bands = static_cast<int>((rows_total + t.band - 1) / t.band);
        t.rows = static_cast<int>(std::min<size_t>(std::min(kFwdMaxRows, t.band), budget / per_row));
        t.smem = t.rows * per_row;
        return true;
      }
      if (tw == 1) break;
    }
  }
  return false;
}

template <typename T, int CB>
int launch_fwd_cb(const void* src, const int32_t* labels, float2* partials, float* out, int N,
                  int h, int w, int C, int H, int W, int ignore_label, int sms,
                  cudaStream_t stream) {
  auto kernel = fwd_kernel<T, CB>;
  // the dynamic shared memory a block may take (its static part, the
  // reduction's 64 bytes, comes on top, past the default 48 KB), then the
  // blocks of this kernel that fit an SM at the first tiling's shared memory
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kFwdSmemMax));
  if (err != cudaSuccess) return static_cast<int>(err);
  FwdTiling t;
  if (!fwd_tiling(N, h, w, C, H, W, sms, t)) return kDoesNotFit;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kFwdThreads, t.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!fwd_tiling(N, h, w, C, H, W, sms * std::max(per_sm, 1), t)) return kDoesNotFit;
  const float sh = static_cast<float>(h) / static_cast<float>(H);
  const float sw = static_cast<float>(w) / static_cast<float>(W);
  const dim3 grid(t.tiles_x, t.bands);
  kernel<<<grid, kFwdThreads, t.smem, stream>>>(static_cast<const T*>(src), labels, partials, h,
                                                w, C, H, W, sh, sw, ignore_label,
                                                static_cast<long long>(N) * H, t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_kernel<<<1, kReduceThreads, 0, stream>>>(partials, t.tiles_x * t.bands, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fwd(const void* src, const int32_t* labels, float2* partials, float* out, int N,
               int h, int w, int C, int H, int W, int ignore_label, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C > 64) return kDoesNotFit;
  switch (class_bucket(C)) {
    case 16:
      return launch_fwd_cb<T, 16>(src, labels, partials, out, N, h, w, C, H, W, ignore_label,
                                  sms, stream);
    case 24:
      return launch_fwd_cb<T, 24>(src, labels, partials, out, N, h, w, C, H, W, ignore_label,
                                  sms, stream);
    case 32:
      return launch_fwd_cb<T, 32>(src, labels, partials, out, N, h, w, C, H, W, ignore_label,
                                  sms, stream);
    default:
      return launch_fwd_cb<T, 64>(src, labels, partials, out, N, h, w, C, H, W, ignore_label,
                                  sms, stream);
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Each function returns the
// cudaError_t of its launches (0 on success) or -1; the caller raises on any
// other value than 0.
extern "C" {

int upsample_ce_num_partials(long long pixels) {
  return static_cast<int>(fwd_partials(pixels));
}

// out[0] = sum over valid pixels of CE, out[1] = number of valid pixels;
// -1 for more than 64 classes or a shape whose tiles do not fit.
// partials: float2[upsample_ce_num_partials(N*H*W)] scratch.
int upsample_ce_fwd(const void* src, int dtype, const void* labels, void* partials,
                    void* out, int N, int h, int w, int C, int H, int W,
                    int ignore_label, void* stream) {
  const int32_t* lab = static_cast<const int32_t*>(labels);
  float2* part = static_cast<float2*>(partials);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<float>(src, lab, part, o, N, h, w, C, H, W, ignore_label, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(src, lab, part, o, N, h, w, C, H, W,
                                     ignore_label, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dsrc (same dtype and shape as src) = g[0] * d(sum CE)/d(src); -1 for a
// shape whose tiles do not fit (more than 64 classes, or an upsampling factor
// so large that one output row of a one-column tile overflows shared memory).
int upsample_ce_bwd(const void* src, int dtype, const void* labels, const void* g,
                    void* dsrc, int N, int h, int w, int C, int H, int W,
                    int ignore_label, void* stream) {
  const int32_t* lab = static_cast<const int32_t*>(labels);
  const float* gp = static_cast<const float*>(g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(src, lab, gp, dsrc, N, h, w, C, H, W, ignore_label, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(src, lab, gp, dsrc, N, h, w, C, H, W,
                                     ignore_label, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
