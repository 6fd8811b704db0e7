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
// across its sequential grid. Here every output pixel forms its two-tap
// weights in y and in x directly (clamped exactly like _interp_matrix), and
// reads the four source pixels' C logits, contiguous in NHWC.
//
// What bounds it on the H100: each call reads N*H*W int32 labels (16 MB at
// 16x512x512) and the small src (1.4 MB, resident in L2), and does no
// tensor-core work: it is bound by memory latency and by the per-class
// exp/FMA work (about 4M pixels x 21 classes). The design answers with one
// thread per output pixel in the forward (neighbouring lanes share source
// pixels, so the tap loads are broadcasts), and in the backward with one
// warp per SOURCE pixel that gathers over its output footprint. The
// gather recomputes each output pixel's softmax once per tap (4x), but it
// needs no atomics and no zero-filled fp32 buffer, writes every dsrc
// element exactly once in the src dtype, and is deterministic, as is the
// forward (block partials summed by a second pass in a fixed order).
//
// Label semantics follow the TPU kernel: a pixel counts when
// label != ignore_label; a label outside [0, C) that is not ignore_label has
// no true class, so its CE is the full log-sum-exp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kFwdThreads = 256;
constexpr int kReduceThreads = 1024;
constexpr int kBwdWarps = 8;
constexpr int kClassChunk = 32;

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

// The four source pixels of an output pixel and their bilinear weights.
template <typename T>
struct Bilinear {
  const T* p00;
  const T* p01;
  const T* p10;
  const T* p11;
  float w00, w01, w10, w11;

  __device__ __forceinline__ Bilinear(const T* img, int w, int C, int y0, int y1,
                                      float fy, int x0, int x1, float fx) {
    p00 = img + (static_cast<int64_t>(y0) * w + x0) * C;
    p01 = img + (static_cast<int64_t>(y0) * w + x1) * C;
    p10 = img + (static_cast<int64_t>(y1) * w + x0) * C;
    p11 = img + (static_cast<int64_t>(y1) * w + x1) * C;
    w00 = (1.f - fy) * (1.f - fx);
    w01 = (1.f - fy) * fx;
    w10 = fy * (1.f - fx);
    w11 = fy * fx;
  }

  __device__ __forceinline__ float at(int c) const {
    return w00 * to_f(p00[c]) + w01 * to_f(p01[c]) + w10 * to_f(p10[c]) +
           w11 * to_f(p11[c]);
  }

  // Online max / log-sum-exp over all classes.
  __device__ __forceinline__ void max_sum(int C, float& m, float& s) const {
    m = -INFINITY;
    s = 0.f;
    for (int c = 0; c < C; ++c) {
      float v = at(c);
      if (v > m) {
        s = s * expf(m - v) + 1.f;
        m = v;
      } else {
        s += expf(v - m);
      }
    }
  }
};

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

// One thread per output pixel; each block writes (sum ce, sum valid).
template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
    fwd_kernel(const T* __restrict__ src, const int32_t* __restrict__ labels,
               float2* __restrict__ partials, int N, int h, int w, int C, int H,
               int W, float sh, float sw, int ignore_label) {
  const int64_t total = static_cast<int64_t>(N) * H * W;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kFwdThreads + threadIdx.x;
  float ce = 0.f, valid = 0.f;
  if (p < total) {
    const int label = labels[p];
    if (label != ignore_label) {
      const int x = static_cast<int>(p % W);
      const int64_t t = p / W;
      const int y = static_cast<int>(t % H);
      const int n = static_cast<int>(t / H);
      int y0, y1, x0, x1;
      float fy, fx;
      taps(y, sh, h, y0, y1, fy);
      taps(x, sw, w, x0, x1, fx);
      Bilinear<T> b(src + static_cast<int64_t>(n) * h * w * C, w, C, y0, y1, fy,
                    x0, x1, fx);
      float m = -INFINITY, s = 0.f, true_logit = 0.f;
      for (int c = 0; c < C; ++c) {
        float v = b.at(c);
        if (c == label) true_logit = v;
        if (v > m) {
          s = s * expf(m - v) + 1.f;
          m = v;
        } else {
          s += expf(v - m);
        }
      }
      ce = logf(s) + m - true_logit;
      valid = 1.f;
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
    if (lane == 0) partials[blockIdx.x] = make_float2(ce, valid);
  }
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

// One warp per source pixel (n, i, j): dsrc[n, i, j, c] =
//   g * sum over output pixels (y, x) of Rh[y, i] * Rw[x, j] *
//       (softmax_c(y, x) - [c == label]) * valid(y, x).
// The footprint bounds are widened by a margin; the weights decide exactly
// which pixels contribute.
template <typename T>
__global__ void __launch_bounds__(kBwdWarps * 32)
    bwd_kernel(const T* __restrict__ src, const int32_t* __restrict__ labels,
               const float* __restrict__ g, T* __restrict__ dsrc, int N, int h,
               int w, int C, int H, int W, float sh, float sw, int ignore_label) {
  const int lane = threadIdx.x & 31;
  const int64_t sp = static_cast<int64_t>(blockIdx.x) * kBwdWarps + (threadIdx.x >> 5);
  if (sp >= static_cast<int64_t>(N) * h * w) return;  // uniform across the warp
  const int j = static_cast<int>(sp % w);
  const int64_t t = sp / w;
  const int i = static_cast<int>(t % h);
  const int n = static_cast<int>(t / h);

  const float inv_sh = static_cast<float>(H) / static_cast<float>(h);
  const float inv_sw = static_cast<float>(W) / static_cast<float>(w);
  const int yb = max(0, static_cast<int>(floorf((i - 0.5f) * inv_sh - 0.5f)) - 1);
  const int ye = min(H, static_cast<int>(ceilf((i + 1.5f) * inv_sh - 0.5f)) + 2);
  const int xb = max(0, static_cast<int>(floorf((j - 0.5f) * inv_sw - 0.5f)) - 1);
  const int xe = min(W, static_cast<int>(ceilf((j + 1.5f) * inv_sw - 0.5f)) + 2);
  const int nx = xe - xb;
  const int count = (ye - yb) * nx;

  const float gs = g[0];
  const T* img = src + static_cast<int64_t>(n) * h * w * C;
  const int32_t* lab = labels + static_cast<int64_t>(n) * H * W;
  T* out = dsrc + sp * C;

  for (int c0 = 0; c0 < C; c0 += kClassChunk) {
    float acc[kClassChunk];
#pragma unroll
    for (int cc = 0; cc < kClassChunk; ++cc) acc[cc] = 0.f;

    for (int k = lane; k < count; k += 32) {
      const int y = yb + k / nx;
      const int x = xb + k % nx;
      int y0, y1, x0, x1;
      float fy, fx;
      taps(y, sh, h, y0, y1, fy);
      taps(x, sw, w, x0, x1, fx);
      const float wy = (y0 == i ? 1.f - fy : 0.f) + (y1 == i ? fy : 0.f);
      const float wx = (x0 == j ? 1.f - fx : 0.f) + (x1 == j ? fx : 0.f);
      const float weight = wy * wx;
      if (weight == 0.f) continue;
      const int label = lab[static_cast<int64_t>(y) * W + x];
      if (label == ignore_label) continue;
      Bilinear<T> b(img, w, C, y0, y1, fy, x0, x1, fx);
      float m, s;
      b.max_sum(C, m, s);
      const float scale = weight * gs / s;
      const float hot = weight * gs;
#pragma unroll
      for (int cc = 0; cc < kClassChunk; ++cc) {
        const int c = c0 + cc;
        if (c < C) {
          float d = expf(b.at(c) - m) * scale;
          if (c == label) d -= hot;
          acc[cc] += d;
        }
      }
    }

    float mine = 0.f;
#pragma unroll
    for (int cc = 0; cc < kClassChunk; ++cc) {
      const float v = warp_sum(acc[cc]);
      if (lane == cc) mine = v;
    }
    if (c0 + lane < C) out[c0 + lane] = from_f<T>(mine);
  }
}

template <typename T>
int launch_fwd(const void* src, const int32_t* labels, float2* partials, float* out,
               int N, int h, int w, int C, int H, int W, int ignore_label,
               cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(N) * H * W;
  const int blocks = static_cast<int>((total + kFwdThreads - 1) / kFwdThreads);
  const float sh = static_cast<float>(h) / static_cast<float>(H);
  const float sw = static_cast<float>(w) / static_cast<float>(W);
  fwd_kernel<T><<<blocks, kFwdThreads, 0, stream>>>(
      static_cast<const T*>(src), labels, partials, N, h, w, C, H, W, sh, sw,
      ignore_label);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_kernel<<<1, kReduceThreads, 0, stream>>>(partials, blocks, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* src, const int32_t* labels, const float* g, void* dsrc,
               int N, int h, int w, int C, int H, int W, int ignore_label,
               cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(N) * h * w;
  const int blocks = static_cast<int>((total + kBwdWarps - 1) / kBwdWarps);
  const float sh = static_cast<float>(h) / static_cast<float>(H);
  const float sw = static_cast<float>(w) / static_cast<float>(W);
  bwd_kernel<T><<<blocks, kBwdWarps * 32, 0, stream>>>(
      static_cast<const T*>(src), labels, g, static_cast<T*>(dsrc), N, h, w, C, H,
      W, sh, sw, ignore_label);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Each function returns the
// cudaError_t of its launches (0 on success); the caller raises on any other.
extern "C" {

int upsample_ce_num_partials(long long pixels) {
  return static_cast<int>((pixels + kFwdThreads - 1) / kFwdThreads);
}

// out[0] = sum over valid pixels of CE, out[1] = number of valid pixels.
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

// dsrc (same dtype and shape as src) = g[0] * d(sum CE)/d(src).
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
