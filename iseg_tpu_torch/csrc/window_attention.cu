// Window attention (Swin) forward and backward, for Hopper (sm_90a). Built by
// iseg_tpu_torch/ops/kernels/_build.py with nvcc into a shared library with a
// plain C interface, loaded with ctypes.
//
// Replaces the Pallas TPU kernels of iseg_tpu/ops/pallas/window_attention.py:
//   forward  _fwd_kernel (:41-61), launched by _forward (:141)
//   backward _bwd_kernel (:64-109), launched by _bwd_rule (:161)
//
// Per (window b, head h), with q, k, v [N, D]:
//   p   = softmax(q k^T * scale + bias[h] + mask[b % nW])     (fp32)
//   out = p v
// and, given do: dv = p^T do; ds = p * (do v^T - rowsum(do * out));
// dq = ds k * scale; dk = ds^T q * scale; dbias[h] = sum over windows of ds.
//
// What is kept from the TPU design: the whole chain runs on one window's
// tiles in fast memory, the N x N logits never reach device memory, and the
// backward recomputes the softmax instead of storing it.
//
// What is not kept: the TPU kernel held a window's tiles for all heads in
// VMEM, looped over heads on the matrix unit, and summed dbias across its
// sequential grid. Here one thread block owns one (window, head) pair, with
// q, k, v (and do) and the logits in shared memory as fp32 (35 KB forward,
// 45 KB backward at N = 49, D = 32), rows padded by one float so that the
// column walks of q k^T hit distinct banks. All the products are fp32 FMA
// loops over shared memory with a 4 x 4 register tile per thread. A backward
// block walks a chunk of consecutive windows for its head and keeps its
// tiles of ds in registers; the chunk partials go through a second kernel
// that sums them in a fixed order. So dbias needs no atomics and is bitwise
// repeatable, like every other output.
//
// What bounds it on the H100: per pair the forward moves 4 N D elements and
// does 4 N^2 D flops (N = 49, D = 32: 12.5 KB in bf16 against 307 kflop),
// about 24 flop/byte, far under the tensor cores' 295 flop/byte but these
// are CUDA-core FMAs fed from shared memory, so it is bound by instruction
// issue (FMAs, shared-memory loads, index arithmetic, the softmax), not by
// device-memory bytes. The register tiles cut the shared-memory words per
// FMA from two to a half. Tensor-core tiles (mma.sync or wgmma with N padded
// to 64, p and ds rounded to bf16) are the next step, and would change the
// fp32-inside contract.
//
// Tensors are addressed through element strides for (window, head, token);
// the head dim has stride 1. So q, k, v may be views of the packed qkv
// projection and the output may be token-major, with no copies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 4;  // a thread's register tile is kTile x kTile outputs
constexpr int kFwdThreads = 192;
constexpr int kReduceThreads = 256;
// A backward thread keeps its tiles of ds in registers across windows:
// ceil(N / 4)^2 tiles over the block's threads.
constexpr int kBwdSmallThreads = 192;  // one tile each:    ceil(N/4)^2 <= 192  (N <= 52)
constexpr int kBwdSmallTiles = 1;
constexpr int kBwdLargeThreads = 512;  // three tiles each: ceil(N/4)^2 <= 1536 (N <= 156)
constexpr int kBwdLargeTiles = 3;
// Backward blocks aimed at per launch: a few waves over the 132 SMs.
constexpr int kBwdTargetBlocks = 2112;
constexpr int kMaxDynamicSmem = 232448;  // 227 KB, Hopper's per-block limit

struct Strides {
  long long b, h, n;  // window, head, token; in elements
};

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// [N, D] tile of one (window, head) -> shared memory, fp32, row stride ld.
template <typename T>
__device__ __forceinline__ void load_tile(const T* g, Strides s, int b, int h, int N,
                                          int D, int ld, float mul, float* dst) {
  const T* base = g + b * s.b + h * s.h;
  for (int e = threadIdx.x; e < N * D; e += blockDim.x) {
    const int n = e / D, d = e - n * D;
    dst[n * ld + d] = to_f(base[n * s.n + d]) * mul;
  }
}

// Register tiles. A thread owns a 4 x 4 tile of a product's output, reads
// 4 + 4 shared-memory words per step of the inner dimension and does 16
// FMAs with them. The four rows (or columns) of tile t of a dimension of n
// elements are t, t + nt, t + 2 nt, t + 3 nt with nt = ceil(n / 4): strided,
// so that neighbouring threads read neighbouring rows (distinct banks with
// the odd row strides ld = D + 1 and N) and write neighbouring addresses.
// Indices past the end are clamped for the reads and skipped at the writes.
__device__ __forceinline__ int tiles_of(int n) { return (n + kTile - 1) / kTile; }

// acc[x][y] = sum_d A[ti + x nt][d] * B[tj + y nt][d]; A, B [N, D], row stride ld.
__device__ __forceinline__ void tile_rows_dot(const float* A, const float* B, int N, int D,
                                              int ld, int nt, int ti, int tj,
                                              float (&acc)[kTile][kTile]) {
  const float* a[kTile];
  const float* b[kTile];
#pragma unroll
  for (int x = 0; x < kTile; ++x) {
    a[x] = A + min(ti + x * nt, N - 1) * ld;
    b[x] = B + min(tj + x * nt, N - 1) * ld;
#pragma unroll
    for (int y = 0; y < kTile; ++y) acc[x][y] = 0.f;
  }
  for (int d = 0; d < D; ++d) {
    float av[kTile], bv[kTile];
#pragma unroll
    for (int x = 0; x < kTile; ++x) {
      av[x] = a[x][d];
      bv[x] = b[x][d];
    }
#pragma unroll
    for (int x = 0; x < kTile; ++x)
#pragma unroll
      for (int y = 0; y < kTile; ++y) acc[x][y] = fmaf(av[x], bv[y], acc[x][y]);
  }
}

// acc[x][y] = sum_c A(r_x, c) * B[c][d_y] with r_x = tr + x nt, d_y = td + y nd,
// where A(r, c) = S[r, c] (kTransposed false) or S[c, r] (true); S is [N, N].
template <bool kTransposed>
__device__ __forceinline__ void tile_s_times(const float* S, const float* B, int N, int D,
                                             int ld, int nt, int nd, int tr, int td,
                                             float (&acc)[kTile][kTile]) {
  int r[kTile], dd[kTile];
#pragma unroll
  for (int x = 0; x < kTile; ++x) {
    r[x] = min(tr + x * nt, N - 1) * (kTransposed ? 1 : N);
    dd[x] = min(td + x * nd, D - 1);
#pragma unroll
    for (int y = 0; y < kTile; ++y) acc[x][y] = 0.f;
  }
  for (int c = 0; c < N; ++c) {
    float av[kTile], bv[kTile];
#pragma unroll
    for (int x = 0; x < kTile; ++x) {
      av[x] = S[r[x] + c * (kTransposed ? N : 1)];
      bv[x] = B[c * ld + dd[x]];
    }
#pragma unroll
    for (int x = 0; x < kTile; ++x)
#pragma unroll
      for (int y = 0; y < kTile; ++y) acc[x][y] = fmaf(av[x], bv[y], acc[x][y]);
  }
}

// S[i, j] = qs[i] . ks[j] + bias[i, j] + mask[i, j]   (qs already scaled)
__device__ __forceinline__ void logits_tile(const float* qs, const float* ks,
                                            const float* bias, const float* mask, int N,
                                            int D, int ld, float* S) {
  const int nt = tiles_of(N);
  for (int tile = threadIdx.x; tile < nt * nt; tile += blockDim.x) {
    const int ti = tile / nt, tj = tile - ti * nt;
    float acc[kTile][kTile];
    tile_rows_dot(qs, ks, N, D, ld, nt, ti, tj, acc);
#pragma unroll
    for (int x = 0; x < kTile; ++x)
#pragma unroll
      for (int y = 0; y < kTile; ++y) {
        const int i = ti + x * nt, j = tj + y * nt;
        if (i < N && j < N) S[i * N + j] = acc[x][y] + bias[i * N + j] + mask[i * N + j];
      }
  }
}

// Row softmax of S in place, one warp per row. Mask entries are finite
// (-100), so the row max is finite and is subtracted before exp.
__device__ __forceinline__ void softmax_rows(float* S, int N) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  for (int i = warp; i < N; i += warps) {
    float* row = S + i * N;
    float m = -INFINITY;
    for (int j = lane; j < N; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float p = expf(row[j] - m);
      row[j] = p;
      sum += p;
    }
    const float inv = 1.f / warp_sum(sum);
    for (int j = lane; j < N; j += 32) row[j] *= inv;
  }
}

// dst[r, d] = mul * sum_c A(r, c) * bs[c, d] for an [N, D] output in device
// memory, A as in tile_s_times.
template <typename T, bool kTransposed>
__device__ __forceinline__ void product_out(const float* S, const float* bs, int N, int D,
                                            int ld, float mul, T* g, Strides s, int b,
                                            int h) {
  T* base = g + b * s.b + h * s.h;
  const int nt = tiles_of(N), nd = tiles_of(D);
  for (int tile = threadIdx.x; tile < nt * nd; tile += blockDim.x) {
    const int tr = tile / nd, td = tile - tr * nd;
    float acc[kTile][kTile];
    tile_s_times<kTransposed>(S, bs, N, D, ld, nt, nd, tr, td, acc);
#pragma unroll
    for (int x = 0; x < kTile; ++x)
#pragma unroll
      for (int y = 0; y < kTile; ++y) {
        const int r = tr + x * nt, d = td + y * nd;
        if (r < N && d < D) base[r * s.n + d] = from_f<T>(acc[x][y] * mul);
      }
  }
}

template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
wa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const float* __restrict__ bias, const float* __restrict__ mask,
              T* __restrict__ out, Strides sq, Strides sk, Strides sv, Strides so, int H,
              int N, int D, int nW, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* qs = smem;
  float* ks = qs + N * ld;
  float* vs = ks + N * ld;
  float* S = vs + N * ld;
  const int b = blockIdx.x / H, h = blockIdx.x - b * H;

  load_tile(q, sq, b, h, N, D, ld, scale, qs);
  load_tile(k, sk, b, h, N, D, ld, 1.f, ks);
  load_tile(v, sv, b, h, N, D, ld, 1.f, vs);
  __syncthreads();
  logits_tile(qs, ks, bias + static_cast<int64_t>(h) * N * N,
              mask + static_cast<int64_t>(b % nW) * N * N, N, D, ld, S);
  __syncthreads();
  softmax_rows(S, N);
  __syncthreads();
  product_out<T, false>(S, vs, N, D, ld, 1.f, out, so, b, h);
}

// kTiles: 4 x 4 tiles of ds a thread owns, ceil(ceil(N / 4)^2 / kThreads).
template <typename T, int kThreads, int kTiles>
__global__ void __launch_bounds__(kThreads)
wa_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ bias,
              const float* __restrict__ mask, T* __restrict__ dq, T* __restrict__ dk,
              T* __restrict__ dv, float* __restrict__ partial, Strides sq, Strides sk,
              Strides sv, Strides sdo, Strides sdq, Strides sdk, Strides sdv, int bnw, int H,
              int N, int D, int nW, int windows_per_chunk, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  const int nt = tiles_of(N), nd = tiles_of(D);
  float* qs = smem;
  float* ks = qs + N * ld;
  float* vs = ks + N * ld;
  float* dos = vs + N * ld;
  float* S = dos + N * ld;
  float* delta = S + N * N;
  float* delta_part = delta + N;  // [N, nd]
  const int chunk = blockIdx.x / H, h = blockIdx.x - chunk * H;
  const float* bias_h = bias + static_cast<int64_t>(h) * N * N;

  float ds_sum[kTiles][kTile][kTile];
#pragma unroll
  for (int u = 0; u < kTiles; ++u)
#pragma unroll
    for (int x = 0; x < kTile; ++x)
#pragma unroll
      for (int y = 0; y < kTile; ++y) ds_sum[u][x][y] = 0.f;

  const int b_end = min(bnw, (chunk + 1) * windows_per_chunk);
  for (int b = chunk * windows_per_chunk; b < b_end; ++b) {
    load_tile(q, sq, b, h, N, D, ld, scale, qs);
    load_tile(k, sk, b, h, N, D, ld, 1.f, ks);
    load_tile(v, sv, b, h, N, D, ld, 1.f, vs);
    load_tile(dout, sdo, b, h, N, D, ld, 1.f, dos);
    __syncthreads();
    logits_tile(qs, ks, bias_h, mask + static_cast<int64_t>(b % nW) * N * N, N, D, ld, S);
    __syncthreads();
    softmax_rows(S, N);
    __syncthreads();

    // dv = p^T do, and delta[i] = sum_j p[i, j] dp[i, j] = do[i] . (p v)[i]:
    // a thread's tile of p v gives its share of four rows' dot products
    product_out<T, true>(S, dos, N, D, ld, 1.f, dv, sdv, b, h);
    for (int tile = threadIdx.x; tile < nt * nd; tile += kThreads) {
      const int tr = tile / nd, td = tile - tr * nd;
      float o[kTile][kTile];
      tile_s_times<false>(S, vs, N, D, ld, nt, nd, tr, td, o);
#pragma unroll
      for (int x = 0; x < kTile; ++x) {
        const int r = tr + x * nt;
        float part = 0.f;
#pragma unroll
        for (int y = 0; y < kTile; ++y) {
          const int d = td + y * nd;
          if (r < N && d < D) part = fmaf(o[x][y], dos[r * ld + d], part);
        }
        if (r < N) delta_part[r * nd + td] = part;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < N; i += kThreads) {
      float sum = 0.f;
      for (int t = 0; t < nd; ++t) sum += delta_part[i * nd + t];
      delta[i] = sum;
    }
    __syncthreads();

    // ds = p * (do v^T - delta), over p in place; each thread owns the same
    // tiles for every window, and sums them for dbias
#pragma unroll
    for (int u = 0; u < kTiles; ++u) {
      const int tile = threadIdx.x + u * kThreads;
      if (tile < nt * nt) {
        const int ti = tile / nt, tj = tile - ti * nt;
        float dp[kTile][kTile];
        tile_rows_dot(dos, vs, N, D, ld, nt, ti, tj, dp);
#pragma unroll
        for (int x = 0; x < kTile; ++x)
#pragma unroll
          for (int y = 0; y < kTile; ++y) {
            const int i = ti + x * nt, j = tj + y * nt;
            if (i < N && j < N) {
              const float ds = S[i * N + j] * (dp[x][y] - delta[i]);
              S[i * N + j] = ds;
              ds_sum[u][x][y] += ds;
            }
          }
      }
    }
    __syncthreads();

    // dq = ds k * scale; dk = ds^T (q * scale)
    product_out<T, false>(S, ks, N, D, ld, scale, dq, sdq, b, h);
    product_out<T, true>(S, qs, N, D, ld, 1.f, dk, sdk, b, h);
    __syncthreads();
  }

  float* mine = partial + (static_cast<int64_t>(chunk) * H + h) * N * N;
#pragma unroll
  for (int u = 0; u < kTiles; ++u) {
    const int tile = threadIdx.x + u * kThreads;
    if (tile < nt * nt) {
      const int ti = tile / nt, tj = tile - ti * nt;
#pragma unroll
      for (int x = 0; x < kTile; ++x)
#pragma unroll
        for (int y = 0; y < kTile; ++y) {
          const int i = ti + x * nt, j = tj + y * nt;
          if (i < N && j < N) mine[i * N + j] = ds_sum[u][x][y];
        }
    }
  }
}

// dbias[x] = sum over chunks, in order, of partial[chunk, x]; x over H*N*N.
__global__ void __launch_bounds__(kReduceThreads)
dbias_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dbias,
                    int chunks, int64_t hnn) {
  const int64_t x = static_cast<int64_t>(blockIdx.x) * kReduceThreads + threadIdx.x;
  if (x >= hnn) return;
  float sum = 0.f;
  for (int c = 0; c < chunks; ++c) sum += partial[c * hnn + x];
  dbias[x] = sum;
}

int windows_per_chunk(int bnw, int H) {
  const int chunks = max(1, min(bnw, (kBwdTargetBlocks + H - 1) / H));
  return (bnw + chunks - 1) / chunks;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, const float* bias,
               const float* mask, void* out, const Strides* s, int bnw, int H, int N,
               int D, int nW, float scale, cudaStream_t stream) {
  const size_t smem = (3 * static_cast<size_t>(N) * (D + 1) + static_cast<size_t>(N) * N) *
                      sizeof(float);
  if (smem > kMaxDynamicSmem) return -1;
  cudaError_t err = allow_smem(wa_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wa_fwd_kernel<T><<<bnw * H, kFwdThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      mask, static_cast<T*>(out), s[0], s[1], s[2], s[3], H, N, D, nW, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kThreads, int kTiles>
int launch_bwd_sized(const void* q, const void* k, const void* v, const void* dout,
                     const float* bias, const float* mask, void* dq, void* dk, void* dv,
                     float* partial, float* dbias, const Strides* s, int bnw, int H, int N,
                     int D, int nW, float scale, cudaStream_t stream) {
  const size_t smem = (4 * static_cast<size_t>(N) * (D + 1) + static_cast<size_t>(N) * N + N +
                       static_cast<size_t>(N) * ((D + kTile - 1) / kTile)) *
                      sizeof(float);
  if (smem > kMaxDynamicSmem) return -1;
  auto kernel = wa_bwd_kernel<T, kThreads, kTiles>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int wpc = windows_per_chunk(bnw, H);
  const int chunks = (bnw + wpc - 1) / wpc;
  kernel<<<chunks * H, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), bias, mask, static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), partial, s[0], s[1], s[2], s[3], s[4], s[5], s[6], bnw, H, N, D,
      nW, wpc, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t hnn = static_cast<int64_t>(H) * N * N;
  const int blocks = static_cast<int>((hnn + kReduceThreads - 1) / kReduceThreads);
  dbias_reduce_kernel<<<blocks, kReduceThreads, 0, stream>>>(partial, dbias, chunks, hnn);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const float* bias, const float* mask, void* dq, void* dk, void* dv,
               float* partial, float* dbias, const Strides* s, int bnw, int H, int N, int D,
               int nW, float scale, cudaStream_t stream) {
  const int tiles = ((N + kTile - 1) / kTile) * ((N + kTile - 1) / kTile);
  if (tiles <= kBwdSmallThreads * kBwdSmallTiles)
    return launch_bwd_sized<T, kBwdSmallThreads, kBwdSmallTiles>(
        q, k, v, dout, bias, mask, dq, dk, dv, partial, dbias, s, bnw, H, N, D, nW, scale,
        stream);
  if (tiles <= kBwdLargeThreads * kBwdLargeTiles)
    return launch_bwd_sized<T, kBwdLargeThreads, kBwdLargeTiles>(
        q, k, v, dout, bias, mask, dq, dk, dv, partial, dbias, s, bnw, H, N, D, nW, scale,
        stream);
  return -1;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v, do and the outputs; bias,
// mask and dbias are float32 and contiguous). `strides` holds (window, head,
// token) element strides per tensor, in argument order. Each function
// returns 0 on success, -1 when N and D do not fit a block (shared memory or
// register slots), or else the cudaError_t of its launches.
extern "C" {

// Number of dbias partials [chunks, H, N, N] the backward needs as scratch.
int window_attention_bwd_chunks(int bnw, int H) {
  const int wpc = windows_per_chunk(bnw, H);
  return (bnw + wpc - 1) / wpc;
}

// strides: q, k, v, out (12 values).
int window_attention_fwd(const void* q, const void* k, const void* v, const void* bias,
                         const void* mask, void* out, int dtype, int bnw, int H, int N,
                         int D, int nW, float scale, const long long* strides,
                         void* stream) {
  const Strides* s = reinterpret_cast<const Strides*>(strides);
  const float* bp = static_cast<const float*>(bias);
  const float* mp = static_cast<const float*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<float>(q, k, v, bp, mp, out, s, bnw, H, N, D, nW, scale, st);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(q, k, v, bp, mp, out, s, bnw, H, N, D, nW, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// strides: q, k, v, do, dq, dk, dv (21 values). partial: float scratch of
// window_attention_bwd_chunks(bnw, H) * H * N * N; dbias: float [H, N, N].
int window_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                         const void* bias, const void* mask, void* dq, void* dk, void* dv,
                         void* partial, void* dbias, int dtype, int bnw, int H, int N, int D,
                         int nW, float scale, const long long* strides, void* stream) {
  const Strides* s = reinterpret_cast<const Strides*>(strides);
  const float* bp = static_cast<const float*>(bias);
  const float* mp = static_cast<const float*>(mask);
  float* pp = static_cast<float*>(partial);
  float* dbp = static_cast<float*>(dbias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(q, k, v, dout, bp, mp, dq, dk, dv, pp, dbp, s, bnw, H, N, D, nW,
                             scale, st);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(q, k, v, dout, bp, mp, dq, dk, dv, pp, dbp, s, bnw, H, N,
                                     D, nW, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
