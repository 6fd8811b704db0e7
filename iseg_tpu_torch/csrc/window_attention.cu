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
// sequential grid. Here a block owns one head and a chunk of consecutive
// windows; the dbias of the chunk stays in the block and the chunk partials
// go through a second kernel that sums them in a fixed order. So dbias needs
// no atomics and is bitwise repeatable, like every other output.
//
// Five backward kernels, chosen by the wrapper by dtype and shape:
//
// * wa_bwd_mma_kernel, for bf16 q, k, v with D % 16 == 0 and N <= 144 (every
//   Swin variant: D = 32, N = 49 or 144). All five products run on the
//   tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulators; ldmatrix,
//   .trans for the k, q, do, p^T and ds^T operands), with N padded to 64 or
//   144: padded keys get -inf before the softmax, padded query rows p = 0,
//   and neither is read from bias or mask or written out. A warp owns 16
//   query rows of the logits and keeps its row of p, dp and ds in registers
//   (softmax and rowsum(dp * p) by quad shuffles); q, k, v and do of the
//   next window arrive by cp.async (16 bytes a thread, through the views'
//   strides) while the block computes the current one. bf16 rounding points:
//   p only as the operand of dv = p^T do, ds only as the operand of dq and
//   dk; the logits, p, dp, ds and the dbias sums stay fp32, and dbias is
//   summed from the fp32 ds. At N <= 64 the block's ds sums stay in
//   registers and the head's bias in shared memory, and each thread loads
//   its mask values for the next window while the block runs dv and dk; at
//   N = 144 the ds sums take the shared memory (they do not fit in
//   registers) and the bias is read through the cache.
// * wa_bwd_tf32x3_kernel, for float32 q, k, v with D % 8 == 0, D <= 80 and
//   N <= 64 (Swin at window 7): the same design with all five products on
//   the tensor cores in split TF32 (mma.sync m16n8k8 .tf32). One TF32 product
//   keeps 10 mantissa bits of each operand (about 1e-3 of the value) and
//   would break the fp32 contract of 1e-4; the split keeps about 21. Each
//   fp32 operand value is split where its fragment is loaded, x = hi + lo
//   with hi = tf32(x) (to nearest) and lo = x - hi truncated to TF32 (a NaN
//   stays NaN in lo), and each product is summed as
//   lo hi + hi lo + hi hi into the fp32 accumulators (CUTLASS's 3xTF32;
//   only lo lo, under 2^-22 of the product, is dropped). Measured on an
//   H100 against the plain version at Swin-L's four stage shapes: out, dq,
//   dk, dv within 5.1e-6, dbias 1.9e-5. ldmatrix moves 16-bit elements
//   only, so every fragment is read by plain 32-bit shared loads from fp32
//   tiles with a row pitch of 4 mod 8 floats (conflict-free for the
//   fragment patterns, below). The p and ds tiles are separate, so a
//   window takes one block barrier after the softmax where the bf16 kernel
//   takes three.
// * wa_bwd_tf32x3_large_kernel, for float32 with D % 8 == 0, D <= 56 and 64
//   < N <= 144 (Swin at window 12): the N <= 64 kernel's p and ds tiles
//   would take 170 KB at N = 144, so no warp reads another's p or ds. In
//   two passes a window, split by ownership, a warp forms its 16 query rows'
//   dq, then (after one block barrier) its 16 keys' dk, dv and dbias sums,
//   from registers, as FlashAttention-2's backward: p from the lse its
//   forward kept, delta = rowsum(do out), each pass walking its 144 columns
//   a pair of 16 x 8 tiles at a time (seven split-TF32 products a window
//   where the N <= 64 kernel has five). The dbias sums take one
//   shared-memory slot per thread and logit, summed over the chunk's windows
//   in order. A first version that held a whole row of p and ds (144 floats
//   a lane) spilled: a block of 9 warps gets at most 168 registers a thread
//   (3 warps share one of the SM's four 16K-register sub-partitions), and
//   it ran no faster than the CUDA cores.
// * wa_bwd_stream_kernel, for every other float32 or bf16 shape
//   with D <= 128: the window-12 kernel's order with the window streamed
//   through shared memory, so no N is too large (its note is below).
// * wa_bwd_kernel, for heads wider than 128 (no window attention of either
//   package has them): fp32 FMA loops over shared memory with a 4 x 4
//   register tile per thread, everything in fp32; it raises where its tiles
//   do not fit a block (at N = 144, above D = 59).
//
// What bounds them on the H100: per (window, head) the backward moves 7 N D
// elements (q, k, v, do in; dq, dk, dv out) and does 10 N^2 D flops; at N =
// 49, D = 32 that is 22 KB in bf16 against 768 kflop, 35 flop/byte, far under
// the tensor cores' 295 flop/byte: the byte bound is the one to reach. The
// CUDA-core kernel is bound by instruction issue (FMAs and shared-memory
// loads). The tensor-core kernel does its products in a few hundred mma
// instructions a window, so what is left is latency: the chain of five
// products and four block barriers per window, hidden by several blocks per
// SM and the prefetch of the next window. Over a Swin-L train step on an
// H100 80GB HBM3 at 700 W, the tensor-core kernel's 24 launches took about
// 3 times their byte bound of 0.97 ms and the CUDA-core kernel's 18 times
// (PERF.md, section 6).
//
// The split-TF32 kernels are bound by instruction issue and latency: per
// operand value a 32-bit shared load (bf16 has one ldmatrix for eight), a
// rounding, a subtract and a mask, and per product three mma where bf16 has
// one. Ablations on an H100 80GB HBM3 at 700 W (PERF.md, section 6) found
// the split and the two correction products a minority of the time; the
// rest is the fp32 tiles' loads, the softmax, the stores and each warp's
// chain. What took the most off was compiling D = 32 in (every Swin
// variant; other D % 8 == 0 read D at run time), which folds the fragment
// addresses into load offsets, and splitting in integer instructions where
// ptxas expands cvt.rna into a longer sequence. At Swin-L stage 2, shifted,
// the N <= 64 backward takes about 0.26 ms of device time (4.2x its byte
// bound of 0.063 ms; SDPA's backward 0.55, the CUDA-core kernel 0.58) and
// the forward 0.11 ms (3.0x its bound of 0.036; SDPA 0.28). At window 12
// (swin_large_384's stage shapes, shifted) the large backward takes 2.57 /
// 1.58 / 0.87 / 0.92 ms at stages 0-3, 10-15x its bound at the split-TF32
// rate, against the CUDA-core kernel's 4.57 / 2.84 / 1.44 / 1.25 and SDPA's
// 3.98 / 2.38 / 1.20 / 1.08 (PERF.md, section 6, PR 18).
//
// Five forward kernels, chosen by the wrapper by the same rule:
//
// * wa_fwd_mma_kernel, for bf16 q, k, v with D % 16 == 0 and N <= 144: the
//   backward's design with two products. Blocks are persistent over a chunk
//   of consecutive windows of one head (one wave, sized by the occupancy
//   query); the head's bias [N, N] sits in shared memory once per block; the
//   next window's q, k, v arrive by cp.async while the block computes this
//   one, and at N <= 64 each thread loads the next window's mask values at
//   its logits into registers during p v. A warp owns 16 query rows: S =
//   q k^T scale + bias + mask in fp32 accumulators (mma.sync m16n8k16),
//   padded keys -inf, softmax in registers by quad shuffles, then p v with p
//   taken straight from the accumulator fragments, rounded to bf16 as the A
//   operand, and v through ldmatrix.trans. The logits, the softmax and its
//   sums stay fp32; p is the only value rounded before the output. One block
//   barrier per window (the tiles of the next window), against three for
//   the CUDA-core kernel, and no logits tile in shared memory. What is left
//   is the latency of each warp's chain per window (two products, a softmax,
//   the loads of bias and mask), at 16 warps per SM at N <= 64 and 9 at 144.
// * wa_fwd_tf32x3_kernel, for float32 q, k, v with D % 8 == 0, D <= 128 and
//   N <= 64: the bf16 forward's design with both products in split TF32,
//   as the backward above. p v takes p from the accumulator fragments with
//   no shuffle: the k slots of its A fragment name keys 2t and 2t + 1, the
//   columns a lane holds of S (see the fragment layouts below).
// * wa_fwd_tf32x3_large_kernel, for float32 with D % 8 == 0, D <= 128 and
//   64 < N <= 144: an online softmax over pairs of key tiles, q held in
//   registers, k and v in shared memory (its note below says why); it
//   writes each row's lse for the backward. At D = 64 (bnw = 72, H = 12) it
//   takes 0.25 ms against SDPA's 0.32 and the CUDA-core kernel's 1.02.
// * wa_fwd_stream_kernel, for every other float32 or bf16 shape
//   with D <= 128 (bf16 N = 144 past D = 64, whose tiles and bias the mma
//   kernel cannot hold, among them): k and v streamed through shared memory,
//   an online softmax (its note is below).
// * wa_fwd_kernel, for heads wider than 128: the CUDA-core design, fp32 FMA
//   loops with 4 x 4 register tiles, q, k, v and the logits in shared memory
//   as fp32 (rows padded by one float so that the column walks of q k^T hit
//   distinct banks); it raises where its tiles do not fit a block. It was
//   bound by instruction issue, 12.5x its byte bound over a Swin-L step in
//   bf16 (PERF.md, section 6), and far behind SDPA at window 12.
//
// The mma and split-TF32 forwards write each row's lse where the caller
// asks (softmax_frags gives it): the streaming backward reads it after them.
//
// Tensors are addressed through element strides for (window, head, token);
// the head dim has stride 1. So q, k, v may be views of the packed qkv
// projection and the output may be token-major, with no copies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

// ------------------------------------------- tensor-core backward (bf16)

constexpr int kMmaMaxN = 144;
constexpr float kLog2e = 1.4426950408889634f;
// Resident blocks per SM the tensor-core kernel is compiled for at N <= 64:
// 3 (168 registers a thread) took less time over a Swin-L step than 4 (128
// registers, more spills) or 2.
constexpr int kMmaMinBlocks = 3;
// The same for the tensor-core forward at N <= 64 (128 registers); at N =
// 144 one block of 9 warps fits an SM (the bias alone takes 83 KB).
constexpr int kFwdMmaMinBlocks = 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a b for one 16 x 8 x 16 tile: a row-major bf16, b column-major bf16, c fp32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// reductions over the four lanes that hold one accumulator row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane l holds accumulator rows
// l/4 and l/4 + 8 of a 16 x 8 tile, columns 2 (l % 4) and 2 (l % 4) + 1.
// The q, k, v, do tiles in shared memory are bf16 [N][ld] with a row pitch
// that is an odd multiple of 16 bytes, so the eight rows of an ldmatrix hit
// distinct banks; each lane names its own row, and a lane whose row is
// padding (>= N) names a row of zeros instead.
__device__ __forceinline__ uint32_t row_addr(const __nv_bfloat16* tile,
                                             const __nv_bfloat16* zero, int row, int N,
                                             int ld) {
  return smem_addr(row < N ? tile + row * ld : zero);
}

// acc[t] (16 x 8 tile t) of A[m0 : m0 + 16, :D] B[:8 kNT, :D]^T
template <int kNT>
__device__ __forceinline__ void rows_times_rows_t(const __nv_bfloat16* A,
                                                  const __nv_bfloat16* B,
                                                  const __nv_bfloat16* zero, int m0, int N,
                                                  int D, int ld, float (&acc)[kNT][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < kNT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  const uint32_t a_addr = row_addr(A, zero, m0 + (lane & 15), N, ld) + (lane >> 4) * 16;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 16;
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t a[4];
    ldsm_x4(a, a_addr + kk * 2);
#pragma unroll
    for (int t = 0; t < kNT; t += 2) {
      uint32_t b[4];
      ldsm_x4(b, row_addr(B, zero, t * 8 + b_row, N, ld) + b_col + kk * 2);
      mma_bf16(acc[t], a, b[0], b[1]);
      mma_bf16(acc[t + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x 16) of A B[:8 kNT, dc : dc + 16], A's 16 x 8 kNT bf16 fragments in
// registers (a[s] covers columns 16 s .. 16 s + 15)
template <int kNT>
__device__ __forceinline__ void frags_times_rows(const uint32_t (&a)[kNT / 2][4],
                                                 const __nv_bfloat16* B,
                                                 const __nv_bfloat16* zero, int N, int ld, int dc,
                                                 float (&acc)[2][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < 2; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8, b_col = (dc + (lane >> 4) * 8) * 2;
#pragma unroll
  for (int s = 0; s < kNT / 2; ++s) {
    uint32_t b[4];
    ldsm_x4_trans(b, row_addr(B, zero, 16 * s + b_row, N, ld) + b_col);
    mma_bf16(acc[0], a[s], b[0], b[1]);
    mma_bf16(acc[1], a[s], b[2], b[3]);
  }
}

// acc (16 x 16) of T[:kNP, m0 : m0 + 16]^T B[:kNP, dc : dc + 16]; T is the
// [kNP][lds] p / ds tile
template <int kNP>
__device__ __forceinline__ void cols_t_times_rows(const __nv_bfloat16* T, int lds,
                                                  const __nv_bfloat16* B,
                                                  const __nv_bfloat16* zero, int N, int ld,
                                                  int m0, int dc, float (&acc)[2][4]) {
  const int lane = threadIdx.x & 31, mat = lane >> 3, r = lane & 7;
#pragma unroll
  for (int t = 0; t < 2; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  const uint32_t a_addr = smem_addr(T + (r + (mat >> 1) * 8) * lds + m0 + (mat & 1) * 8);
  const int b_row = r + (mat & 1) * 8, b_col = (dc + (mat >> 1) * 8) * 2;
#pragma unroll
  for (int kk = 0; kk < kNP; kk += 16) {
    uint32_t a[4], b[4];
    ldsm_x4_trans(a, a_addr + kk * lds * 2);
    ldsm_x4_trans(b, row_addr(B, zero, kk + b_row, N, ld) + b_col);
    mma_bf16(acc[0], a, b[0], b[1]);
    mma_bf16(acc[1], a, b[2], b[3]);
  }
}

// rows m0 .. m0 + 15 (those < N), columns dc .. dc + 15 of a token-major
// output, times mul, rounded to bf16
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long sn, int m0, int dc,
                                           int N, float mul, const float (&acc)[2][4]) {
  const int lane = threadIdx.x & 31, r = m0 + (lane >> 2), c = dc + (lane & 3) * 2;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    if (r < N)
      *reinterpret_cast<uint32_t*>(base + r * sn + c + t * 8) =
          bf16x2(acc[t][0] * mul, acc[t][1] * mul);
    if (r + 8 < N)
      *reinterpret_cast<uint32_t*>(base + (r + 8) * sn + c + t * 8) =
          bf16x2(acc[t][2] * mul, acc[t][3] * mul);
  }
}

// Copies [N][D] tiles of window b, head h into shared memory [N][ld] by
// cp.async, 16 bytes at a time through the tensor's strides: a thread copies
// piece `col` of rows row0, row0 + row_step, ... (the caller commits)
template <typename T>
struct TileCopy {
  static constexpr int kPiece = 16 / sizeof(T);  // elements in 16 bytes
  int row0, row_step, col;
  __device__ __forceinline__ TileCopy(int threads, int D) {
    const int per_row = D / kPiece;
    row_step = threads / per_row;
    row0 = threadIdx.x / per_row;
    col = (threadIdx.x - row0 * per_row) * kPiece;
  }
  __device__ __forceinline__ void operator()(const T* g, Strides st, int b, int h, int N, int ld,
                                             T* dst) const {
    const T* base = g + b * st.b + h * st.h + col;
    for (int n = row0; n < N && row0 < row_step; n += row_step)
      cp_async16(smem_addr(dst + n * ld + col), base + n * st.n);
  }
};

// The mask values of window b at this thread's logits, in the accumulator
// layout of key tiles 0 .. kT - 1 (0 past N); r0 is the thread's first row
template <int kT>
__device__ __forceinline__ void load_mask_frags(float (&dst)[kT][4], const float* mask, int b,
                                                int nW, int N, int r0) {
  const float* mask_b = mask + static_cast<int64_t>(b % nW) * N * N;
  const int c2 = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int t = 0; t < kT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e < 2 ? r0 : r0 + 8, j = t * 8 + c2 + (e & 1);
      dst[t][e] = i < N && j < N ? __ldg(mask_b + i * N + j) : 0.f;
    }
}

// The rows' lse (log2 units, as softmax_frags gives it) of window b, head h
// into lse [bnw, H, N], where the caller asked for it (lse not null): what the
// window-12 and streaming backwards recompute p from
__device__ __forceinline__ void store_lse(float* lse, int b, int h, int H, int N, int r0,
                                          float lse0, float lse1) {
  if (lse == nullptr || (threadIdx.x & 3) != 0) return;
  float* row = lse + (static_cast<int64_t>(b) * H + h) * N;
  if (r0 < N) row[r0] = lse0;
  if (r0 + 8 < N) row[r0 + 8] = lse1;
}

// Logits of this warp's 16 query rows, softmax in place: p[t] holds q k^T
// for key tile t on entry and p = softmax(q k^T scale + bias + mask) on
// exit, fp32 in registers (in log2 units with exp2). bias_h is the head's
// [N][N] bias (in shared memory or device memory); `mask_at(t, e)` gives the
// mask value of element e of tile t. A padded key gets -inf, and a padded
// query row, with no finite logit, p = 0. Where lse2 is given, the two rows'
// lse (log2 units; +inf for a row with no finite logit) go there.
template <int kNT, typename MaskAt>
__device__ __forceinline__ void softmax_frags(float (&p)[kNT][4], const float* bias_h,
                                              MaskAt mask_at, int r0, int N, float scale,
                                              float* lse2 = nullptr) {
  const int c2 = (threadIdx.x & 3) * 2;
  const int r1 = r0 + 8;
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int t = 0; t < kNT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e < 2 ? r0 : r1, j = t * 8 + c2 + (e & 1);
      float x = -INFINITY;
      if (i < N && j < N) x = p[t][e] * scale + bias_h[i * N + j] + mask_at(t, e);
      p[t][e] = x;
      if (e < 2) mx0 = fmaxf(mx0, x);
      else mx1 = fmaxf(mx1, x);
    }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  const float sub0 = (mx0 == -INFINITY ? 0.f : mx0) * kLog2e;
  const float sub1 = (mx1 == -INFINITY ? 0.f : mx1) * kLog2e;
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int t = 0; t < kNT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[t][e] = exp2f(fmaf(p[t][e], kLog2e, -(e < 2 ? sub0 : sub1)));
      if (e < 2) l0 += p[t][e];
      else l1 += p[t][e];
    }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if (lse2 != nullptr) {
    lse2[0] = l0 > 0.f ? sub0 + log2f(l0) : INFINITY;
    lse2[1] = l1 > 0.f ? sub1 + log2f(l1) : INFINITY;
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f, inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
  for (int t = 0; t < kNT; ++t) {
    p[t][0] *= inv0;
    p[t][1] *= inv0;
    p[t][2] *= inv1;
    p[t][3] *= inv1;
  }
}

// Shared memory of the tensor-core backward, in bytes: two sets (the window
// computed and the next one) of the q, k, v, do tiles [N][D + 8] and a row of
// zeros (bf16), the p / ds tile [kNP][kNP + 8] (bf16), and fp32: at kNP = 64
// the head's bias [N][N], at kNP = 144 the block's ds sums [kNP][kNP] (there
// the bias is read through the cache: it would not fit).
size_t mma_smem_bytes(int N, int D) {
  const size_t np = N <= 64 ? 64 : kMmaMaxN;
  return 2 * ((8 * static_cast<size_t>(N) + 1) * (D + 8) + np * (np + 8)) +
         4 * (np > 64 ? np * np : static_cast<size_t>(N) * N);
}

// One block per (chunk of windows, head): kNP / 16 warps, each owning 16
// query rows of the logits and 16 key rows of dk and dv. Per window:
//   p = softmax(q k^T scale + bias + mask) -> p (bf16) to the p/ds tile
//   dp = do v^T; ds = p (dp - rowsum(dp p)); dbias sums += ds; dq = ds k scale
//   dv = p^T do (p^T from the tile)
//   ds (bf16) to the tile; dk = ds^T q scale
// with the next window's q, k, v, do on their way by cp.async.
template <int kNP>
__global__ void __launch_bounds__(kNP * 2, kNP <= 64 ? kMmaMinBlocks : 1)
wa_bwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ bias, const float* __restrict__ mask,
                  __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, float* __restrict__ partial, Strides sq,
                  Strides sk, Strides sv, Strides sdo, Strides sdq, Strides sdk, Strides sdv,
                  int bnw, int H, int N, int D, int nW, int windows_per_chunk, float scale) {
  constexpr int kNT = kNP / 8;  // 16 x 8 accumulator tiles across a row of keys
  constexpr int kThreads = kNP * 2;
  constexpr bool kSmallWindow = kNP <= 64;  // ds sums in registers, bias in shared memory
  extern __shared__ __align__(16) unsigned char wa_mma_smem[];
  const int ld = D + 8, lds = kNP + 8, tile = N * ld;
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(wa_mma_smem);
  __nv_bfloat16* zero = tiles + 2 * 4 * tile;
  __nv_bfloat16* ps = zero + ld;
  float* fp32_smem = reinterpret_cast<float*>(ps + kNP * lds);
  float* sums_smem = fp32_smem;  // [kNT * 4][kThreads], kNP = 144
  float* bias_smem = fp32_smem;  // [N][N], kNP = 64

  const int lane = threadIdx.x & 31, m0 = (threadIdx.x >> 5) * 16;
  const int r0 = m0 + (lane >> 2), r1 = r0 + 8, c2 = (lane & 3) * 2;
  const int chunk = blockIdx.x / H, h = blockIdx.x - chunk * H;
  const int b_first = chunk * windows_per_chunk;
  const int b_end = min(bnw, b_first + windows_per_chunk);
  const float* bias_h = bias + static_cast<int64_t>(h) * N * N;

  for (int e = threadIdx.x; e < ld / 8; e += kThreads)
    reinterpret_cast<uint4*>(zero)[e] = make_uint4(0u, 0u, 0u, 0u);
  float sums[kSmallWindow ? kNT : 1][4];
#pragma unroll
  for (int t = 0; t < (kSmallWindow ? kNT : 1); ++t)
    sums[t][0] = sums[t][1] = sums[t][2] = sums[t][3] = 0.f;
  if constexpr (kSmallWindow) {
    for (int e = threadIdx.x; e < N * N; e += kThreads) bias_smem[e] = __ldg(bias_h + e);
  } else {
    for (int e = 0; e < kNT * 4; ++e) sums_smem[e * kThreads + threadIdx.x] = 0.f;
  }

  // q, k, v, do of window b -> tile set `stage`
  const TileCopy<__nv_bfloat16> copy(kThreads, D);
  auto load = [&](int b, int stage) {
    __nv_bfloat16* dst = tiles + stage * 4 * tile;
    copy(q, sq, b, h, N, ld, dst);
    copy(k, sk, b, h, N, ld, dst + tile);
    copy(v, sv, b, h, N, ld, dst + 2 * tile);
    copy(dout, sdo, b, h, N, ld, dst + 3 * tile);
    cp_async_commit();
  };

  // the mask values at this thread's logits, for the window computed next:
  // loaded one window ahead, while the block runs the last window's dv and
  // dk, so that their latency is off the path from q k^T to the softmax
  float mask_next[kNT][4];

  load(b_first, 0);
  load_mask_frags(mask_next, mask, b_first, nW, N, r0);
  for (int b = b_first, it = 0; b < b_end; ++b, ++it) {
    const int cur = it & 1;
    cp_async_wait_all();
    __syncthreads();  // the window's tiles are in; every warp is done with the last one
    if (b + 1 < b_end) load(b + 1, cur ^ 1);
    const __nv_bfloat16* qs = tiles + cur * 4 * tile;
    const __nv_bfloat16* ks = qs + tile;
    const __nv_bfloat16* vs = ks + tile;
    const __nv_bfloat16* dos = vs + tile;

    // logits and softmax, fp32 in registers
    float p[kNT][4];
    rows_times_rows_t<kNT>(qs, ks, zero, m0, N, D, ld, p);
    softmax_frags<kNT>(p, kSmallWindow ? bias_smem : bias_h,
                       [&](int t, int e) { return mask_next[t][e]; }, r0, N, scale);
#pragma unroll
    for (int t = 0; t < kNT; ++t) {
      *reinterpret_cast<uint32_t*>(ps + r0 * lds + t * 8 + c2) = bf16x2(p[t][0], p[t][1]);
      *reinterpret_cast<uint32_t*>(ps + r1 * lds + t * 8 + c2) = bf16x2(p[t][2], p[t][3]);
    }

    // dp = do v^T; ds = p (dp - rowsum(dp p)), fp32; its sums for dbias
    float ds[kNT][4];
    rows_times_rows_t<kNT>(dos, vs, zero, m0, N, D, ld, ds);
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int t = 0; t < kNT; ++t) {
      d0 = fmaf(p[t][0], ds[t][0], fmaf(p[t][1], ds[t][1], d0));
      d1 = fmaf(p[t][2], ds[t][2], fmaf(p[t][3], ds[t][3], d1));
    }
    d0 = quad_sum(d0);
    d1 = quad_sum(d1);
#pragma unroll
    for (int t = 0; t < kNT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ds[t][e] = p[t][e] * (ds[t][e] - (e < 2 ? d0 : d1));
        if constexpr (kSmallWindow) sums[t][e] += ds[t][e];
        else sums_smem[(t * 4 + e) * kThreads + threadIdx.x] += ds[t][e];
      }
    // ds rounded to bf16, as the A operand of dq (accumulator tiles 2s and
    // 2s + 1 are the A fragment of keys 16 s .. 16 s + 15)
    uint32_t a_ds[kNT / 2][4];
#pragma unroll
    for (int s = 0; s < kNT / 2; ++s) {
      a_ds[s][0] = bf16x2(ds[2 * s][0], ds[2 * s][1]);
      a_ds[s][1] = bf16x2(ds[2 * s][2], ds[2 * s][3]);
      a_ds[s][2] = bf16x2(ds[2 * s + 1][0], ds[2 * s + 1][1]);
      a_ds[s][3] = bf16x2(ds[2 * s + 1][2], ds[2 * s + 1][3]);
    }
    if (b + 1 < b_end) load_mask_frags(mask_next, mask, b + 1, nW, N, r0);

    float acc[2][4];
    __nv_bfloat16* dq_w = dq + b * sdq.b + h * sdq.h;
    for (int dc = 0; dc < D; dc += 16) {
      frags_times_rows<kNT>(a_ds, ks, zero, N, ld, dc, acc);
      store_rows(dq_w, sdq.n, m0, dc, N, scale, acc);
    }
    __syncthreads();  // every warp's rows of p are in the tile

    __nv_bfloat16* dv_w = dv + b * sdv.b + h * sdv.h;
    for (int dc = 0; dc < D; dc += 16) {
      cols_t_times_rows<kNP>(ps, lds, dos, zero, N, ld, m0, dc, acc);
      store_rows(dv_w, sdv.n, m0, dc, N, 1.f, acc);
    }
    __syncthreads();  // every warp is done with p
#pragma unroll
    for (int s = 0; s < kNT / 2; ++s) {
      *reinterpret_cast<uint32_t*>(ps + r0 * lds + 16 * s + c2) = a_ds[s][0];
      *reinterpret_cast<uint32_t*>(ps + r1 * lds + 16 * s + c2) = a_ds[s][1];
      *reinterpret_cast<uint32_t*>(ps + r0 * lds + 16 * s + 8 + c2) = a_ds[s][2];
      *reinterpret_cast<uint32_t*>(ps + r1 * lds + 16 * s + 8 + c2) = a_ds[s][3];
    }
    __syncthreads();  // every warp's rows of ds are in the tile

    __nv_bfloat16* dk_w = dk + b * sdk.b + h * sdk.h;
    for (int dc = 0; dc < D; dc += 16) {
      cols_t_times_rows<kNP>(ps, lds, qs, zero, N, ld, m0, dc, acc);
      store_rows(dk_w, sdk.n, m0, dc, N, scale, acc);
    }
  }

  float* mine = partial + (static_cast<int64_t>(chunk) * H + h) * N * N;
#pragma unroll
  for (int t = 0; t < kNT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e < 2 ? r0 : r1, j = t * 8 + c2 + (e & 1);
      float sum;
      if constexpr (kSmallWindow) sum = sums[t][e];
      else sum = sums_smem[(t * 4 + e) * kThreads + threadIdx.x];
      if (i < N && j < N) mine[i * N + j] = sum;
    }
}

// Shared memory of the tensor-core forward, in bytes: two sets (the window
// computed and the next one) of the q, k, v tiles [N][D + 8] and a row of
// zeros (bf16), then the head's bias [N][N] (fp32).
size_t fwd_mma_smem_bytes(int N, int D) {
  return 2 * (6 * static_cast<size_t>(N) + 1) * (D + 8) + 4 * static_cast<size_t>(N) * N;
}

// One block per (chunk of windows, head): kNP / 16 warps, each owning 16
// query rows. Per window: S = q k^T scale + bias + mask -> softmax -> p
// (bf16 fragments) -> out = p v, with the next window's q, k, v on their way
// by cp.async. At N <= 64 each thread loads its mask values of the next
// window into registers during p v, off the path from q k^T to the softmax;
// at N = 144 those 72 more registers a thread would spill, which was slower
// than reading the mask where it is added.
template <int kNP, bool kLse>
__global__ void __launch_bounds__(kNP * 2, kNP <= 64 ? kFwdMmaMinBlocks : 1)
wa_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                  const float* __restrict__ mask, __nv_bfloat16* __restrict__ out, Strides sq,
                  Strides sk, Strides sv, Strides so, int bnw, int H, int N, int D, int nW,
                  int windows_per_chunk, float scale, float* __restrict__ lse) {
  constexpr int kNT = kNP / 8;  // 16 x 8 accumulator tiles across a row of keys
  constexpr int kThreads = kNP * 2;
  constexpr bool kMaskAhead = kNP <= 64;
  extern __shared__ __align__(16) unsigned char wa_mma_smem[];
  const int ld = D + 8, tile = N * ld;
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(wa_mma_smem);
  __nv_bfloat16* zero = tiles + 2 * 3 * tile;
  float* bias_smem = reinterpret_cast<float*>(zero + ld);  // [N][N]

  const int lane = threadIdx.x & 31, m0 = (threadIdx.x >> 5) * 16;
  const int r0 = m0 + (lane >> 2), r1 = r0 + 8, c2 = (lane & 3) * 2;
  const int chunk = blockIdx.x / H, h = blockIdx.x - chunk * H;
  const int b_first = chunk * windows_per_chunk;
  const int b_end = min(bnw, b_first + windows_per_chunk);
  const float* bias_h = bias + static_cast<int64_t>(h) * N * N;

  for (int e = threadIdx.x; e < ld / 8; e += kThreads)
    reinterpret_cast<uint4*>(zero)[e] = make_uint4(0u, 0u, 0u, 0u);
  for (int e = threadIdx.x; e < N * N; e += kThreads) bias_smem[e] = __ldg(bias_h + e);

  // q, k, v of window b -> tile set `stage`
  const TileCopy<__nv_bfloat16> copy(kThreads, D);
  auto load = [&](int b, int stage) {
    __nv_bfloat16* dst = tiles + stage * 3 * tile;
    copy(q, sq, b, h, N, ld, dst);
    copy(k, sk, b, h, N, ld, dst + tile);
    copy(v, sv, b, h, N, ld, dst + 2 * tile);
    cp_async_commit();
  };

  // the mask values at this thread's logits for the window computed next,
  // loaded during the last window's p v
  float mask_next[kMaskAhead ? kNT : 1][4];

  load(b_first, 0);
  if constexpr (kMaskAhead) load_mask_frags(mask_next, mask, b_first, nW, N, r0);
  for (int b = b_first, it = 0; b < b_end; ++b, ++it) {
    const int cur = it & 1;
    cp_async_wait_all();
    __syncthreads();  // the window's tiles are in; every warp is done with the last one
    if (b + 1 < b_end) load(b + 1, cur ^ 1);
    const __nv_bfloat16* qs = tiles + cur * 3 * tile;
    const __nv_bfloat16* ks = qs + tile;
    const __nv_bfloat16* vs = ks + tile;

    // logits and softmax, fp32 in registers
    float p[kNT][4];
    rows_times_rows_t<kNT>(qs, ks, zero, m0, N, D, ld, p);
    const float* mask_b = mask + static_cast<int64_t>(b % nW) * N * N;
    float row_lse[2];
    softmax_frags<kNT>(p, bias_smem, [&](int t, int e) {
      if constexpr (kMaskAhead) return mask_next[t][e];
      return __ldg(mask_b + (e < 2 ? r0 : r1) * N + t * 8 + c2 + (e & 1));
    }, r0, N, scale, kLse ? row_lse : nullptr);
    if constexpr (kLse) store_lse(lse, b, h, H, N, r0, row_lse[0], row_lse[1]);
    // p rounded to bf16 as the A operand of p v (accumulator tiles 2s and
    // 2s + 1 are the A fragment of keys 16 s .. 16 s + 15)
    uint32_t a_p[kNT / 2][4];
#pragma unroll
    for (int s = 0; s < kNT / 2; ++s) {
      a_p[s][0] = bf16x2(p[2 * s][0], p[2 * s][1]);
      a_p[s][1] = bf16x2(p[2 * s][2], p[2 * s][3]);
      a_p[s][2] = bf16x2(p[2 * s + 1][0], p[2 * s + 1][1]);
      a_p[s][3] = bf16x2(p[2 * s + 1][2], p[2 * s + 1][3]);
    }
    if (kMaskAhead && b + 1 < b_end) load_mask_frags(mask_next, mask, b + 1, nW, N, r0);

    float acc[2][4];
    __nv_bfloat16* out_w = out + b * so.b + h * so.h;
    for (int dc = 0; dc < D; dc += 16) {
      frags_times_rows<kNT>(a_p, vs, zero, N, ld, dc, acc);
      store_rows(out_w, so.n, m0, dc, N, 1.f, acc);
    }
  }
}

// --------------------------- tensor-core forward and backward (fp32, split TF32)

// Resident blocks per SM the split-TF32 kernels are compiled for at N <= 64:
// the forward's tiles take 52 KB a block at N = 49, D = 32 (four fit an SM),
// the backward's 101 KB (two fit).
constexpr int kTf32FwdMinBlocks = 4;
constexpr int kTf32BwdMinBlocks = 2;
// The route limits of the split-TF32 kernels (the wrapper's forward_route and
// backward_route hold the same numbers): the forward takes D <= 128 at any N
// <= 144; the backward D <= 80 at N <= 64 (its p and ds tiles and two sets of
// q, k, v, do fit a block there) and D <= 56 at 64 < N <= 144 (the
// row-then-key backward's one set of q, k, v, do and its dbias sums fit).
constexpr int kTf32MaxD = 128;
constexpr int kTf32BwdSmallN = 64;
constexpr int kTf32BwdSmallMaxD = 80;
constexpr int kTf32BwdLargeMaxD = 56;
// Output columns a warp accumulates at once (four 16 x 8 tiles)
constexpr int kTf32Cols = 32;

// x rounded to TF32 (10 stored mantissa bits), to nearest, ties away from
// zero: what cvt.rna.tf32.f32 gives for every finite x (half a TF32 ulp
// added to the magnitude, the 13 low bits cleared), in two integer
// instructions, where ptxas expands cvt.rna into a longer sequence. A NaN
// whose mantissa carries into the sign bit (the GPU's own NaN does) comes
// out a zero: Split keeps it in lo.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// c += a b for one 16 x 8 x 8 tile: a row-major tf32, b column-major tf32, c fp32
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An fp32 operand fragment split as x = hi + lo: hi = tf32(x), rounded to
// nearest, and lo = x - hi (exact in fp32, at most half a TF32 ulp of x)
// truncated to TF32 by one mask. What is left, x - hi - lo, is under 2^-21
// |x|. A NaN x gives a NaN x - hi, which the mask keeps (its top mantissa
// bits are set), so every product that takes x is NaN, as in fp32.
template <int kN>
struct Split {
  uint32_t hi[kN], lo[kN];
  __device__ __forceinline__ void set(int i, float x) {
    hi[i] = to_tf32(x);
    lo[i] = __float_as_uint(x - __uint_as_float(hi[i])) & 0xFFFFE000u;
  }
};

// c += a b in split TF32 (CUTLASS's 3xTF32): the two correction products
// lo hi and hi lo first, then hi hi, all into the fp32 accumulators; only
// lo lo (under 2^-22 of the product) is dropped
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const Split<4>& a, const Split<2>& b) {
  mma_tf32(c, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(c, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(c, a.hi, b.hi[0], b.hi[1]);
}

// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32), lane l, g = l / 4, t = l % 4:
// A (16 x 8) holds (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B (8 x 8)
// holds (k = t, n = g), (k = t + 4, n = g); C is mma.m16n8k16's: (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1). A product sums over k, so the
// k slots may name the summed index in any order that A and B share. Two
// orders are used: "natural" (slots t, t + 4 are k = t, t + 4) where both
// operands come from row-major tiles, and "paired" (slots t, t + 4 are k =
// 2t, 2t + 1) where A is an accumulator fragment: then a lane's C values
// of one 16 x 8 tile are its A fragment for the next product, with no
// shuffle and no trip through shared memory. The fp32 tiles have a row
// pitch ld of 4 mod 8 floats (D + 4 with D % 8 == 0; kNP + 4): the natural
// loads (row g, column t) and the paired ones (row 2t, column g) then hit
// 32 distinct banks. Rows past N name a row of zeros.
__device__ __forceinline__ const float* f32_row(const float* tile, const float* zero, int row,
                                                int N, int ld) {
  return row < N ? tile + row * ld : zero;
}

// acc[j] (16 x 8 tile j) = A[m0 : m0 + 16, :D] B[8j : 8j + 8, :D]^T, natural
// order; tiles j with 8j >= N (all keys padding) stay 0
template <int kNT>
__device__ __forceinline__ void rows_times_rows_t_3x(const float* A, const float* B,
                                                     const float* zero, int m0, int N, int D,
                                                     int ld, float (&acc)[kNT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kNT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const float* a0 = f32_row(A, zero, m0 + g, N, ld) + t;
  const float* a1 = f32_row(A, zero, m0 + g + 8, N, ld) + t;
#pragma unroll
  for (int kk = 0; kk < D; kk += 8) {
    Split<4> a;
    a.set(0, a0[kk]);
    a.set(1, a1[kk]);
    a.set(2, a0[kk + 4]);
    a.set(3, a1[kk + 4]);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if (j * 8 < N) {
        const float* bp = f32_row(B, zero, j * 8 + g, N, ld) + kk + t;
        Split<2> b;
        b.set(0, bp[0]);
        b.set(1, bp[4]);
        mma_3xtf32(acc[j], a, b);
      }
    }
  }
}

// acc[u] (16 x 8, columns dc + 8u) = P V[:, dc : dc + kTf32Cols], paired
// order: P's 16 x 8 tiles are the accumulator fragments p[j] (keys 8j ..
// 8j + 7, whose slots t and t + 4 are keys 8j + 2t and 8j + 2t + 1), V an
// [N][ld] tile; key tiles at or past N hold p = 0 and are skipped
template <int kNT>
__device__ __forceinline__ void frags_times_rows_3x(const float (&p)[kNT][4], const float* V,
                                                    const float* zero, int N, int D, int ld,
                                                    int dc, float (&acc)[kTf32Cols / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int u = 0; u < kTf32Cols / 8; ++u) acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.f;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    if (j * 8 < N) {
      Split<4> a;
      a.set(0, p[j][0]);
      a.set(1, p[j][2]);
      a.set(2, p[j][1]);
      a.set(3, p[j][3]);
      const float* b0 = f32_row(V, zero, j * 8 + 2 * t, N, ld) + dc + g;
      const float* b1 = f32_row(V, zero, j * 8 + 2 * t + 1, N, ld) + dc + g;
#pragma unroll
      for (int u = 0; u < kTf32Cols / 8; ++u) {
        if (dc + 8 * u < D) {
          Split<2> b;
          b.set(0, b0[8 * u]);
          b.set(1, b1[8 * u]);
          mma_3xtf32(acc[u], a, b);
        }
      }
    }
  }
}

// acc[u] (16 x 8, columns dc + 8u) = T[:, m0 : m0 + 16]^T B[:, dc : dc +
// kTf32Cols], paired order; T is the [kNP][lds] p or ds tile (queries x
// keys), B an [N][ld] tile of queries; query tiles at or past N are skipped
template <int kNP>
__device__ __forceinline__ void cols_t_times_rows_3x(const float* T, int lds, const float* B,
                                                     const float* zero, int N, int D, int ld,
                                                     int m0, int dc,
                                                     float (&acc)[kTf32Cols / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int u = 0; u < kTf32Cols / 8; ++u) acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kNP; kk += 8) {
    if (kk < N) {
      const float* t0 = T + (kk + 2 * t) * lds + m0 + g;  // query kk + 2t
      const float* t1 = t0 + lds;                           // query kk + 2t + 1
      Split<4> a;
      a.set(0, t0[0]);
      a.set(1, t0[8]);
      a.set(2, t1[0]);
      a.set(3, t1[8]);
      const float* b0 = f32_row(B, zero, kk + 2 * t, N, ld) + dc + g;
      const float* b1 = f32_row(B, zero, kk + 2 * t + 1, N, ld) + dc + g;
#pragma unroll
      for (int u = 0; u < kTf32Cols / 8; ++u) {
        if (dc + 8 * u < D) {
          Split<2> b;
          b.set(0, b0[8 * u]);
          b.set(1, b1[8 * u]);
          mma_3xtf32(acc[u], a, b);
        }
      }
    }
  }
}

// rows m0 .. m0 + 15 (those < N), columns dc .. dc + kTf32Cols - 1 (those <
// D) of an fp32 token-major output, times mul
__device__ __forceinline__ void store_rows_f32(float* base, long long sn, int m0, int dc, int N,
                                               int D, float mul,
                                               const float (&acc)[kTf32Cols / 8][4]) {
  const int lane = threadIdx.x & 31, r = m0 + (lane >> 2), c = dc + (lane & 3) * 2;
#pragma unroll
  for (int u = 0; u < kTf32Cols / 8; ++u) {
    if (dc + 8 * u >= D) continue;
    if (r < N)
      *reinterpret_cast<float2*>(base + r * sn + c + 8 * u) =
          make_float2(acc[u][0] * mul, acc[u][1] * mul);
    if (r + 8 < N)
      *reinterpret_cast<float2*>(base + (r + 8) * sn + c + 8 * u) =
          make_float2(acc[u][2] * mul, acc[u][3] * mul);
  }
}

// Shared memory of the split-TF32 forward at N <= 64, in bytes (fp32): two
// sets (the window computed and the next one) of the q, k, v tiles [N][D +
// 4] and a row of zeros, then the head's bias [N][N].
size_t fwd_tf32_smem_bytes(int N, int D) {
  return 4 * ((6 * static_cast<size_t>(N) + 1) * (D + 4) + static_cast<size_t>(N) * N);
}

// The bf16 forward's design (wa_fwd_mma_kernel) for fp32 q, k, v at N <= 64,
// with both products in split TF32: one block per (chunk of windows, head),
// 4 warps, each owning 16 query rows. Per window: S = q k^T (natural order)
// -> scale + bias + mask -> softmax in registers -> out = p v with p's
// accumulator fragments as the A operand (paired order), with the next
// window's q, k, v on their way by cp.async and each thread's mask values of
// the next window loaded during p v.
template <int kD>
__global__ void __launch_bounds__(128, kTf32FwdMinBlocks)
wa_fwd_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     const float* __restrict__ mask, float* __restrict__ out, Strides sq,
                     Strides sk, Strides sv, Strides so, int bnw, int H, int N, int d_arg,
                     int nW, int windows_per_chunk, float scale, float* __restrict__ lse) {
  const int D = kD > 0 ? kD : d_arg;
  constexpr int kNT = 64 / 8;
  constexpr int kThreads = 128;
  extern __shared__ __align__(16) unsigned char wa_mma_smem[];
  const int ld = D + 4, tile = N * ld;
  float* tiles = reinterpret_cast<float*>(wa_mma_smem);
  float* zero = tiles + 2 * 3 * tile;
  float* bias_smem = zero + ld;  // [N][N]

  const int m0 = (threadIdx.x >> 5) * 16;
  const int r0 = m0 + ((threadIdx.x & 31) >> 2);
  const int chunk = blockIdx.x / H, h = blockIdx.x - chunk * H;
  const int b_first = chunk * windows_per_chunk;
  const int b_end = min(bnw, b_first + windows_per_chunk);
  const float* bias_h = bias + static_cast<int64_t>(h) * N * N;

  for (int e = threadIdx.x; e < ld; e += kThreads) zero[e] = 0.f;
  for (int e = threadIdx.x; e < N * N; e += kThreads) bias_smem[e] = __ldg(bias_h + e);

  const TileCopy<float> copy(kThreads, D);
  auto load = [&](int b, int stage) {
    float* dst = tiles + stage * 3 * tile;
    copy(q, sq, b, h, N, ld, dst);
    copy(k, sk, b, h, N, ld, dst + tile);
    copy(v, sv, b, h, N, ld, dst + 2 * tile);
    cp_async_commit();
  };

  float mask_next[kNT][4];

  load(b_first, 0);
  load_mask_frags(mask_next, mask, b_first, nW, N, r0);
  for (int b = b_first, it = 0; b < b_end; ++b, ++it) {
    const int cur = it & 1;
    cp_async_wait_all();
    __syncthreads();  // the window's tiles are in; every warp is done with the last one
    if (b + 1 < b_end) load(b + 1, cur ^ 1);
    if (m0 >= N) continue;  // a warp of padded query rows only
    const float* qs = tiles + cur * 3 * tile;
    const float* ks = qs + tile;
    const float* vs = ks + tile;

    float p[kNT][4];
    rows_times_rows_t_3x<kNT>(qs, ks, zero, m0, N, D, ld, p);
    float row_lse[2];
    softmax_frags<kNT>(p, bias_smem, [&](int t, int e) { return mask_next[t][e]; }, r0, N,
                       scale, row_lse);
    store_lse(lse, b, h, H, N, r0, row_lse[0], row_lse[1]);
    if (b + 1 < b_end) load_mask_frags(mask_next, mask, b + 1, nW, N, r0);

    float* out_w = out + b * so.b + h * so.h;
    for (int dc = 0; dc < D; dc += kTf32Cols) {
      float acc[kTf32Cols / 8][4];
      frags_times_rows_3x<kNT>(p, vs, zero, N, D, ld, dc, acc);
      store_rows_f32(out_w, so.n, m0, dc, N, D, 1.f, acc);
    }
  }
}

// Raw fp32 A-operand values of rows m0 + g and m0 + g + 8 of an [N][ld] tile
// (rows past N read as zeros), kKK steps of 8 columns: a[c] = A[r][8c + t],
// A[r + 8][8c + t], A[r][8c + t + 4], A[r + 8][8c + t + 4] (natural order)
template <int kKK>
__device__ __forceinline__ void load_a_rows(const float* tile, const float* zero, int m0, int N,
                                            int D, int ld, float (&a)[kKK][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a0 = f32_row(tile, zero, m0 + g, N, ld) + t;
  const float* a1 = f32_row(tile, zero, m0 + g + 8, N, ld) + t;
#pragma unroll
  for (int c = 0; c < kKK; ++c) {
    const bool in = c * 8 < D;
    a[c][0] = in ? a0[8 * c] : 0.f;
    a[c][1] = in ? a1[8 * c] : 0.f;
    a[c][2] = in ? a0[8 * c + 4] : 0.f;
    a[c][3] = in ? a1[8 * c + 4] : 0.f;
  }
}

// acc[u] (16 x 8 tiles j0 and j0 + 1) = A B[8 (j0 + u) : +8, :D]^T in split TF32,
// A's raw values in registers (load_a_rows), B an [N][ld] tile (rows past N
// are zeros): two independent accumulator chains
template <int kKK>
__device__ __forceinline__ void pair_times_rows_t_3x(const float (&a)[kKK][4], const float* B,
                                                     const float* zero, int j0, int N, int D,
                                                     int ld, float (&acc)[2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int u = 0; u < 2; ++u) acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.f;
  const float* b0 = f32_row(B, zero, j0 * 8 + g, N, ld) + t;
  const float* b1 = f32_row(B, zero, j0 * 8 + 8 + g, N, ld) + t;
#pragma unroll
  for (int c = 0; c < kKK; ++c) {
    if (c * 8 < D) {
      Split<4> sa;
#pragma unroll
      for (int i = 0; i < 4; ++i) sa.set(i, a[c][i]);
      Split<2> x, y;
      x.set(0, b0[8 * c]);
      x.set(1, b0[8 * c + 4]);
      y.set(0, b1[8 * c]);
      y.set(1, b1[8 * c + 4]);
      mma_3xtf32(acc[0], sa, x);
      mma_3xtf32(acc[1], sa, y);
    }
  }
}

// acc[w][u] (16 x 8, columns 32 w + 8 u) += F B[8 j : 8 j + 8, :D], paired
// order: F is the 16 x 8 accumulator fragment of tile j (its slots t and t +
// 4 name rows 8j + 2t and 8j + 2t + 1 of B)
template <int kDC>
__device__ __forceinline__ void frag_times_rows_3x(const float (&f)[4], const float* B,
                                                   const float* zero, int j, int N, int D, int ld,
                                                   float (&acc)[kDC][kTf32Cols / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  Split<4> a;
  a.set(0, f[0]);
  a.set(1, f[2]);
  a.set(2, f[1]);
  a.set(3, f[3]);
  const float* b0 = f32_row(B, zero, j * 8 + 2 * t, N, ld) + g;
  const float* b1 = f32_row(B, zero, j * 8 + 2 * t + 1, N, ld) + g;
#pragma unroll
  for (int w = 0; w < kDC; ++w)
#pragma unroll
    for (int u = 0; u < kTf32Cols / 8; ++u) {
      const int col = w * kTf32Cols + 8 * u;
      if (col < D) {
        Split<2> b;
        b.set(0, b0[col]);
        b.set(1, b1[col]);
        mma_3xtf32(acc[w][u], a, b);
      }
    }
}

// bias + mask at the logits this lane holds of key tiles j0, j0 + 1 (rows r0,
// r0 + 8 are queries), or with `keys` of query tiles j0, j0 + 1 (rows r0, r0
// + 8 are keys; the logit of query i and key j is at [i][j]); 0 past N
__device__ __forceinline__ void load_bias_mask(float (&bm)[2][4], const float* bias_h,
                                               const float* mask_b, int j0, int r0, int N,
                                               bool keys) {
  const int c2 = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? r0 : r0 + 8, col = (j0 + u) * 8 + c2 + (e & 1);
      const int at = keys ? col * N + row : row * N + col;
      bm[u][e] = row < N && col < N ? __ldg(bias_h + at) + __ldg(mask_b + at) : 0.f;
    }
}

// Shared memory of the split-TF32 forward at 64 < N <= 144, in bytes (fp32):
// kv_stages sets of the k and v tiles [N][D + 4] and a row of zeros.
__host__ __device__ constexpr size_t fwd_tf32_large_smem_bytes(int N, int D, int kv_stages) {
  return 4 * ((2 * static_cast<size_t>(kv_stages) * N + 1) * (D + 4));
}

// Two sets of k and v (the next window's on its way) where they fit a block
// (D <= 96 at N = 144), else one; 0 where one does not fit
__host__ __device__ constexpr int fwd_tf32_large_kv_stages(int N, int D) {
  return fwd_tf32_large_smem_bytes(N, D, 2) <= kMaxDynamicSmem   ? 2
         : fwd_tf32_large_smem_bytes(N, D, 1) <= kMaxDynamicSmem ? 1
                                                                 : 0;
}

// The split-TF32 forward for 64 < N <= 144 (Swin at window 12): one warp a
// 16 query rows, with an online softmax, as FlashAttention-2's forward. Two
// sets of fp32 q, k, v tiles and the head's bias, as the N <= 64 kernel keeps
// them, would take 235,008 + 82,944 bytes at N = 144, D = 64, over a block's
// 232,448; and a whole row of logits a lane (72 floats at N = 144) beside them
// would spill, since a block of 9 warps puts 3 on one of the SM's four
// 16,384-register sub-partitions: 168 registers a thread at most. So a warp
// holds its q fragments in registers (read from device memory: no other warp
// needs them), the block keeps k and v in shared memory (the next window's on
// its way by cp.async where two sets fit), and a warp walks the keys a pair
// of 16 x 8 tiles at a time: s = q k^T (split TF32) + scale, bias and mask
// (read through the cache a pair ahead of their use), the running row max
// and sum, the output rescaled where the max grows, then out += p v with p's
// accumulator fragments as the A operand. It writes each row's lse (log2
// units) where the caller asks, for the backward.
template <int kD>
__global__ void __launch_bounds__(2 * kMmaMaxN, 1)
wa_fwd_tf32x3_large_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ bias,
                           const float* __restrict__ mask, float* __restrict__ out, Strides sq,
                           Strides sk, Strides sv, Strides so, int bnw, int H, int N, int d_arg,
                           int nW, int windows_per_chunk, float scale, float* __restrict__ lse) {
  const int D = kD > 0 ? kD : d_arg;
  constexpr int kKK = (kD > 0 ? kD : kTf32MaxD) / 8;
  constexpr int kDC = (kKK * 8 + kTf32Cols - 1) / kTf32Cols;
  constexpr int kThreads = 2 * kMmaMaxN;
  const int kv_stages = fwd_tf32_large_kv_stages(N, D);
  extern __shared__ __align__(16) unsigned char wa_mma_smem[];
  const int ld = D + 4, tile = N * ld;
  float* kv_tiles = reinterpret_cast<float*>(wa_mma_smem);  // [kv_stages][k, v][N][ld]
  float* zero = kv_tiles + 2 * kv_stages * tile;

  const int lane = threadIdx.x & 31, m0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = m0 + g, r1 = r0 + 8, c2 = t * 2;
  const int chunk = blockIdx.x / H, h = blockIdx.x - chunk * H;
  const int b_first = chunk * windows_per_chunk;
  const int b_end = min(bnw, b_first + windows_per_chunk);
  const float* bias_h = bias + static_cast<int64_t>(h) * N * N;

  for (int e = threadIdx.x; e < ld; e += kThreads) zero[e] = 0.f;

  const TileCopy<float> copy(kThreads, D);
  auto load_kv = [&](int b, int stage) {
    float* dst = kv_tiles + stage * 2 * tile;
    copy(k, sk, b, h, N, ld, dst);
    copy(v, sv, b, h, N, ld, dst + tile);
    cp_async_commit();
  };

  load_kv(b_first, 0);
  for (int b = b_first, it = 0; b < b_end; ++b, ++it) {
    const int cur = kv_stages == 2 ? (it & 1) : 0;
    // q of this warp's rows (rows past N repeat row N - 1: never stored)
    float aq[kKK][4];
    {
      const float* qw = q + b * sq.b + h * sq.h;
      const float* a0 = qw + min(r0, N - 1) * sq.n + t;
      const float* a1 = qw + min(r1, N - 1) * sq.n + t;
#pragma unroll
      for (int c = 0; c < kKK; ++c) {
        const bool in = m0 < N && c * 8 < D;
        aq[c][0] = in ? __ldg(a0 + 8 * c) : 0.f;
        aq[c][1] = in ? __ldg(a1 + 8 * c) : 0.f;
        aq[c][2] = in ? __ldg(a0 + 8 * c + 4) : 0.f;
        aq[c][3] = in ? __ldg(a1 + 8 * c + 4) : 0.f;
      }
    }
    cp_async_wait_all();
    __syncthreads();  // the window's k, v are in; every warp is done with the last ones
    if (kv_stages == 2 && b + 1 < b_end) load_kv(b + 1, cur ^ 1);
    if (m0 < N) {
      const float* ks = kv_tiles + cur * 2 * tile;
      const float* vs = ks + tile;
      const float* mask_b = mask + static_cast<int64_t>(b % nW) * N * N;
      float acc[kDC][kTf32Cols / 8][4] = {};
      float mx0 = -INFINITY, mx1 = -INFINITY, l0 = 0.f, l1 = 0.f;
      float bm[2][4];
      load_bias_mask(bm, bias_h, mask_b, 0, r0, N, false);
      for (int j0 = 0; j0 * 8 < N; j0 += 2) {
        float x[2][4], bm_next[2][4];
        if ((j0 + 2) * 8 < N) load_bias_mask(bm_next, bias_h, mask_b, j0 + 2, r0, N, false);
        pair_times_rows_t_3x<kKK>(aq, ks, zero, j0, N, D, ld, x);
        float tmax0 = -INFINITY, tmax1 = -INFINITY;
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = (j0 + u) * 8 + c2 + (e & 1);
            const bool in = (e < 2 ? r0 : r1) < N && col < N;
            x[u][e] = in ? x[u][e] * scale + bm[u][e] : -INFINITY;
            if (e < 2) tmax0 = fmaxf(tmax0, x[u][e]);
            else tmax1 = fmaxf(tmax1, x[u][e]);
          }
        const float new0 = fmaxf(mx0, quad_max(tmax0)), new1 = fmaxf(mx1, quad_max(tmax1));
        const float sub0 = (new0 == -INFINITY ? 0.f : new0) * kLog2e;
        const float sub1 = (new1 == -INFINITY ? 0.f : new1) * kLog2e;
        const float corr0 = mx0 == -INFINITY ? 0.f : exp2f(fmaf(mx0, kLog2e, -sub0));
        const float corr1 = mx1 == -INFINITY ? 0.f : exp2f(fmaf(mx1, kLog2e, -sub1));
        mx0 = new0;
        mx1 = new1;
        l0 *= corr0;
        l1 *= corr1;
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            x[u][e] = exp2f(fmaf(x[u][e], kLog2e, -(e < 2 ? sub0 : sub1)));
            if (e < 2) l0 += x[u][e];
            else l1 += x[u][e];
          }
#pragma unroll
        for (int w = 0; w < kDC; ++w)
#pragma unroll
          for (int u = 0; u < kTf32Cols / 8; ++u) {
            acc[w][u][0] *= corr0;
            acc[w][u][1] *= corr0;
            acc[w][u][2] *= corr1;
            acc[w][u][3] *= corr1;
          }
        frag_times_rows_3x<kDC>(x[0], vs, zero, j0, N, D, ld, acc);
        if ((j0 + 1) * 8 < N) frag_times_rows_3x<kDC>(x[1], vs, zero, j0 + 1, N, D, ld, acc);
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) bm[u][e] = bm_next[u][e];
      }
      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
      const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f, inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
      const float sub0 = (mx0 == -INFINITY ? 0.f : mx0) * kLog2e;
      const float sub1 = (mx1 == -INFINITY ? 0.f : mx1) * kLog2e;
      store_lse(lse, b, h, H, N, r0, l0 == 0.f ? INFINITY : sub0 + log2f(l0),
                l1 == 0.f ? INFINITY : sub1 + log2f(l1));
      float* out_w = out + b * so.b + h * so.h;
#pragma unroll
      for (int w = 0; w < kDC; ++w) {
#pragma unroll
        for (int u = 0; u < kTf32Cols / 8; ++u) {
          acc[w][u][0] *= inv0;
          acc[w][u][1] *= inv0;
          acc[w][u][2] *= inv1;
          acc[w][u][3] *= inv1;
        }
        if (w * kTf32Cols < D) store_rows_f32(out_w, so.n, m0, w * kTf32Cols, N, D, 1.f, acc[w]);
      }
    }
    if (kv_stages == 1 && b + 1 < b_end) {
      __syncthreads();  // every warp is done with this window's k, v
      load_kv(b + 1, 0);
    }
  }
}

// Shared memory of the split-TF32 backward at N <= 64, in bytes (fp32): two
// sets of the q, k, v, do tiles [N][D + 4] and a row of zeros, the p and ds
// tiles [kNP][kNP + 4] and the head's bias [N][N].
size_t bwd_tf32_smem_bytes(int N, int D) {
  constexpr size_t np = kTf32BwdSmallN;
  return 4 * ((8 * static_cast<size_t>(N) + 1) * (D + 4) + 2 * np * (np + 4) +
              static_cast<size_t>(N) * N);
}

// The bf16 backward's design (wa_bwd_mma_kernel, N <= 64) for fp32 q, k,
// v, do, with all five products in split TF32. One block per (chunk of
// windows, head): kNP / 16 warps, each owning 16 query rows of the logits
// and 16 key rows of dk and dv. Per window:
//   p = softmax(q k^T scale + bias + mask) -> the p tile
//   dp = do v^T; ds = p (dp - rowsum(dp p)) -> the ds tile; dbias sums += ds
//   dq = ds k scale (ds from the accumulator fragments)
//   one block barrier; dv = p^T do and dk = ds^T q scale from the tiles
// with the next window's q, k, v, do on their way by cp.async, and each
// thread's mask values of the next window loaded during dq. Two tiles
// (p and ds) take one barrier a window where the bf16 kernel's one tile
// takes three.
template <int kNP, int kD>
__global__ void __launch_bounds__(kNP * 2, kTf32BwdMinBlocks)
wa_bwd_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ bias, const float* __restrict__ mask,
                     float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                     float* __restrict__ partial, Strides sq, Strides sk, Strides sv,
                     Strides sdo, Strides sdq, Strides sdk, Strides sdv, int bnw, int H, int N,
                     int d_arg, int nW, int windows_per_chunk, float scale) {
  const int D = kD > 0 ? kD : d_arg;
  constexpr int kNT = kNP / 8;
  constexpr int kThreads = kNP * 2;
  extern __shared__ __align__(16) unsigned char wa_mma_smem[];
  const int ld = D + 4, lds = kNP + 4, tile = N * ld;
  float* tiles = reinterpret_cast<float*>(wa_mma_smem);
  float* zero = tiles + 2 * 4 * tile;
  float* ps = zero + ld;               // [kNP][lds]
  float* dss = ps + kNP * lds;         // [kNP][lds]
  float* bias_smem = dss + kNP * lds;  // [N][N]

  const int lane = threadIdx.x & 31, m0 = (threadIdx.x >> 5) * 16;
  const int r0 = m0 + (lane >> 2), r1 = r0 + 8, c2 = (lane & 3) * 2;
  const int chunk = blockIdx.x / H, h = blockIdx.x - chunk * H;
  const int b_first = chunk * windows_per_chunk;
  const int b_end = min(bnw, b_first + windows_per_chunk);
  const float* bias_h = bias + static_cast<int64_t>(h) * N * N;
  // a warp whose 16 rows are all padding: none of its rows of p or ds is
  // read (a query tile read starts below N), so it only copies and waits
  const bool rows = m0 < N;

  for (int e = threadIdx.x; e < ld; e += kThreads) zero[e] = 0.f;
  for (int e = threadIdx.x; e < N * N; e += kThreads) bias_smem[e] = __ldg(bias_h + e);
  float sums[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) sums[j][0] = sums[j][1] = sums[j][2] = sums[j][3] = 0.f;

  const TileCopy<float> copy(kThreads, D);
  auto load = [&](int b, int stage) {
    float* dst = tiles + stage * 4 * tile;
    copy(q, sq, b, h, N, ld, dst);
    copy(k, sk, b, h, N, ld, dst + tile);
    copy(v, sv, b, h, N, ld, dst + 2 * tile);
    copy(dout, sdo, b, h, N, ld, dst + 3 * tile);
    cp_async_commit();
  };

  float mask_next[kNT][4];

  load(b_first, 0);
  load_mask_frags(mask_next, mask, b_first, nW, N, r0);
  for (int b = b_first, it = 0; b < b_end; ++b, ++it) {
    const int cur = it & 1;
    cp_async_wait_all();
    __syncthreads();  // the window's tiles are in; every warp is done with the last one
    if (b + 1 < b_end) load(b + 1, cur ^ 1);
    const float* qs = tiles + cur * 4 * tile;
    const float* ks = qs + tile;
    const float* vs = ks + tile;
    const float* dos = vs + tile;

    if (rows) {
      float p[kNT][4];
      rows_times_rows_t_3x<kNT>(qs, ks, zero, m0, N, D, ld, p);
      softmax_frags<kNT>(p, bias_smem, [&](int j, int e) { return mask_next[j][e]; }, r0, N,
                         scale);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        *reinterpret_cast<float2*>(ps + r0 * lds + j * 8 + c2) = make_float2(p[j][0], p[j][1]);
        *reinterpret_cast<float2*>(ps + r1 * lds + j * 8 + c2) = make_float2(p[j][2], p[j][3]);
      }

      float ds[kNT][4];
      rows_times_rows_t_3x<kNT>(dos, vs, zero, m0, N, D, ld, ds);
      float d0 = 0.f, d1 = 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        d0 = fmaf(p[j][0], ds[j][0], fmaf(p[j][1], ds[j][1], d0));
        d1 = fmaf(p[j][2], ds[j][2], fmaf(p[j][3], ds[j][3], d1));
      }
      d0 = quad_sum(d0);
      d1 = quad_sum(d1);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ds[j][e] = p[j][e] * (ds[j][e] - (e < 2 ? d0 : d1));
          sums[j][e] += ds[j][e];
        }
        *reinterpret_cast<float2*>(dss + r0 * lds + j * 8 + c2) = make_float2(ds[j][0], ds[j][1]);
        *reinterpret_cast<float2*>(dss + r1 * lds + j * 8 + c2) = make_float2(ds[j][2], ds[j][3]);
      }
      if (b + 1 < b_end) load_mask_frags(mask_next, mask, b + 1, nW, N, r0);

      float* dq_w = dq + b * sdq.b + h * sdq.h;
      for (int dc = 0; dc < D; dc += kTf32Cols) {
        float acc[kTf32Cols / 8][4];
        frags_times_rows_3x<kNT>(ds, ks, zero, N, D, ld, dc, acc);
        store_rows_f32(dq_w, sdq.n, m0, dc, N, D, scale, acc);
      }
    }
    __syncthreads();  // every warp's rows of p and ds are in their tiles
    if (!rows) continue;

    float* dv_w = dv + b * sdv.b + h * sdv.h;
    float* dk_w = dk + b * sdk.b + h * sdk.h;
    for (int dc = 0; dc < D; dc += kTf32Cols) {
      float acc[kTf32Cols / 8][4];
      cols_t_times_rows_3x<kNP>(ps, lds, dos, zero, N, D, ld, m0, dc, acc);
      store_rows_f32(dv_w, sdv.n, m0, dc, N, D, 1.f, acc);
      cols_t_times_rows_3x<kNP>(dss, lds, qs, zero, N, D, ld, m0, dc, acc);
      store_rows_f32(dk_w, sdk.n, m0, dc, N, D, scale, acc);
    }
  }

  float* mine = partial + (static_cast<int64_t>(chunk) * H + h) * N * N;
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e < 2 ? r0 : r1, col = j * 8 + c2 + (e & 1);
      if (i < N && col < N) mine[i * N + col] = sums[j][e];
    }
}

// Shared memory of the split-TF32 backward at 64 < N <= 144, in bytes
// (fp32): kv_stages sets of the k and v tiles [N][D + 4], one set of the q
// and do tiles, a row of zeros, each query row's lse and delta [2][144] and
// the block's dbias sums [144 * 144] (one slot per thread and logit).
__host__ __device__ constexpr size_t bwd_tf32_large_smem_bytes(int N, int D, int kv_stages) {
  return 4 * ((2 * static_cast<size_t>(kv_stages) + 2) * N * (D + 4) + (D + 4) + 2 * kMmaMaxN +
              static_cast<size_t>(kMmaMaxN) * kMmaMaxN);
}

__host__ __device__ constexpr int bwd_tf32_large_kv_stages(int N, int D) {
  return bwd_tf32_large_smem_bytes(N, D, 2) <= kMaxDynamicSmem   ? 2
         : bwd_tf32_large_smem_bytes(N, D, 1) <= kMaxDynamicSmem ? 1
                                                                 : 0;
}

// The split-TF32 backward for 64 < N <= 144 (Swin at window 12), where the
// N <= 64 kernel's p and ds tiles, which let other warps form dv = p^T do
// and dk = ds^T q, would take 170 KB alone. Here each warp forms what it
// owns from registers, in two passes a window with one block barrier
// between them, and no atomics. The forward kept each row's lse (log2 units)
// and its output, so delta = rowsum(do out) and no pass needs a whole row of
// p at once: each walks its 144 columns a pair of 16 x 8 tiles at a time.
//   rows: warp w owns query rows 16w .. 16w + 15 (q and do held in
//     registers): per pair of key tiles, s = q k^T and dp = do v^T; p =
//     exp2((s scale + bias + mask) log2(e) - lse); ds = p (dp - delta); dq
//     += ds k. Each row's lse and delta go to shared memory.
//   keys: warp w owns keys 16w .. 16w + 15 (k and v held): per pair of query
//     tiles, s^T = k q^T and dp^T = v do^T; p^T from the rows' lse; ds^T =
//     p^T (dp^T - delta); dv += p^T do; dk += ds^T q; ds^T added to the
//     block's dbias sums, one shared-memory slot per thread and logit, so
//     each sum runs over the chunk's windows in order.
// Seven products a window where the N <= 64 kernel has five, all in split
// TF32; bias and mask are read through the cache one pair of tiles ahead of
// their use. One set of q, k, v, do sits in shared memory; the next window's
// k and v arrive by cp.async during this one where a second set fits (D <=
// 32 at N = 144), its q and do after the window.
template <int kD>
__global__ void __launch_bounds__(2 * kMmaMaxN, 1)
wa_bwd_tf32x3_large_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dout,
                           const float* __restrict__ bias, const float* __restrict__ mask,
                           float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                           float* __restrict__ partial, Strides sq, Strides sk, Strides sv,
                           Strides sdo, Strides sdq, Strides sdk, Strides sdv, int bnw, int H,
                           int N, int d_arg, int nW, int windows_per_chunk, float scale,
                           const float* __restrict__ out, const float* __restrict__ lse,
                           Strides so) {
  const int D = kD > 0 ? kD : d_arg;
  constexpr int kKK = (kD > 0 ? kD : kTf32BwdLargeMaxD) / 8;    // steps of 8 in D
  constexpr int kDC = (kKK * 8 + kTf32Cols - 1) / kTf32Cols;   // output column blocks
  constexpr int kNT = kMmaMaxN / 8;
  constexpr int kThreads = 2 * kMmaMaxN;
  const int kv_stages = bwd_tf32_large_kv_stages(N, D);
  extern __shared__ __align__(16) unsigned char wa_mma_smem[];
  const int ld = D + 4, tile = N * ld;
  float* kv_tiles = reinterpret_cast<float*>(wa_mma_smem);  // [kv_stages][k, v][N][ld]
  float* qs = kv_tiles + 2 * kv_stages * tile;
  float* dos = qs + tile;
  float* zero = dos + tile;
  float* lse_s = zero + ld;                  // [kMmaMaxN]
  float* delta_s = lse_s + kMmaMaxN;         // [kMmaMaxN]
  float* sums = delta_s + kMmaMaxN;          // [kNT * 4][kThreads]

  const int lane = threadIdx.x & 31, m0 = (threadIdx.x >> 5) * 16;
  const int r0 = m0 + (lane >> 2), r1 = r0 + 8, c2 = (lane & 3) * 2;
  const int chunk = blockIdx.x / H, h = blockIdx.x - chunk * H;
  const int b_first = chunk * windows_per_chunk;
  const int b_end = min(bnw, b_first + windows_per_chunk);
  const float* bias_h = bias + static_cast<int64_t>(h) * N * N;
  // a warp whose 16 rows (and keys) are all padding only copies and waits
  const bool rows = m0 < N;

  for (int e = threadIdx.x; e < ld; e += kThreads) zero[e] = 0.f;
  for (int e = 0; e < kNT * 4; ++e) sums[e * kThreads + threadIdx.x] = 0.f;

  const TileCopy<float> copy(kThreads, D);
  auto load_kv = [&](int b, int stage) {
    float* dst = kv_tiles + stage * 2 * tile;
    copy(k, sk, b, h, N, ld, dst);
    copy(v, sv, b, h, N, ld, dst + tile);
  };
  auto load_qdo = [&](int b) {
    copy(q, sq, b, h, N, ld, qs);
    copy(dout, sdo, b, h, N, ld, dos);
  };

  load_kv(b_first, 0);
  load_qdo(b_first);
  cp_async_commit();
  for (int b = b_first, it = 0; b < b_end; ++b, ++it) {
    const int cur = kv_stages == 2 ? (it & 1) : 0;
    cp_async_wait_all();
    __syncthreads();  // the window's tiles are in
    if (kv_stages == 2 && b + 1 < b_end) {
      load_kv(b + 1, cur ^ 1);
      cp_async_commit();
    }
    const float* ks = kv_tiles + cur * 2 * tile;
    const float* vs = ks + tile;
    const float* mask_b = mask + static_cast<int64_t>(b % nW) * N * N;

    // rows: ds and dq of this warp's query rows
    if (rows) {
      // delta = rowsum(do out) and lse of rows r0, r1 (padding: 0 and +inf)
      const float* out_w = out + b * so.b + h * so.h;
      float d0 = 0.f, d1 = 0.f;
      for (int d = lane & 3; d < D; d += 4) {
        if (r0 < N) d0 = fmaf(dos[r0 * ld + d], __ldg(out_w + r0 * so.n + d), d0);
        if (r1 < N) d1 = fmaf(dos[r1 * ld + d], __ldg(out_w + r1 * so.n + d), d1);
      }
      d0 = quad_sum(d0);
      d1 = quad_sum(d1);
      const float* lse_w = lse + (static_cast<int64_t>(b) * H + h) * N;
      const float l0 = r0 < N ? __ldg(lse_w + r0) : INFINITY;
      const float l1 = r1 < N ? __ldg(lse_w + r1) : INFINITY;
      if ((lane & 3) == 0) {
        lse_s[r0] = l0;
        lse_s[r1] = l1;
        delta_s[r0] = d0;
        delta_s[r1] = d1;
      }
      float aq[kKK][4], ado[kKK][4];
      load_a_rows<kKK>(qs, zero, m0, N, D, ld, aq);
      load_a_rows<kKK>(dos, zero, m0, N, D, ld, ado);
      float acc[kDC][kTf32Cols / 8][4] = {};
      float bm[2][4];
      load_bias_mask(bm, bias_h, mask_b, 0, r0, N, false);
      for (int j0 = 0; j0 * 8 < N; j0 += 2) {
        float s[2][4], dp[2][4], bm_next[2][4];
        if ((j0 + 2) * 8 < N) load_bias_mask(bm_next, bias_h, mask_b, j0 + 2, r0, N, false);
        pair_times_rows_t_3x<kKK>(aq, ks, zero, j0, N, D, ld, s);
        pair_times_rows_t_3x<kKK>(ado, vs, zero, j0, N, D, ld, dp);
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = (j0 + u) * 8 + c2 + (e & 1);
            const float lse_r = e < 2 ? l0 : l1, delta_r = e < 2 ? d0 : d1;
            float ds = 0.f;
            if ((e < 2 ? r0 : r1) < N && col < N) {
              const float p = exp2f(fmaf(s[u][e] * scale + bm[u][e], kLog2e, -lse_r));
              ds = p * (dp[u][e] - delta_r);
            }
            s[u][e] = ds;
          }
        frag_times_rows_3x<kDC>(s[0], ks, zero, j0, N, D, ld, acc);
        if ((j0 + 1) * 8 < N) frag_times_rows_3x<kDC>(s[1], ks, zero, j0 + 1, N, D, ld, acc);
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) bm[u][e] = bm_next[u][e];
      }
      float* dq_w = dq + b * sdq.b + h * sdq.h;
#pragma unroll
      for (int w = 0; w < kDC; ++w)
        if (w * kTf32Cols < D) store_rows_f32(dq_w, sdq.n, m0, w * kTf32Cols, N, D, scale, acc[w]);
    }
    __syncthreads();  // every query row's lse and delta are in

    // keys: dv, dk and the dbias sums of this warp's keys (rows r0, r1 of the
    // accumulator tiles are keys; tile j's columns are queries)
    if (rows) {
      float ak[kKK][4], av[kKK][4];
      load_a_rows<kKK>(ks, zero, m0, N, D, ld, ak);
      load_a_rows<kKK>(vs, zero, m0, N, D, ld, av);
      float acc_v[kDC][kTf32Cols / 8][4] = {}, acc_k[kDC][kTf32Cols / 8][4] = {};
      float bm[2][4];
      load_bias_mask(bm, bias_h, mask_b, 0, r0, N, true);
      for (int j0 = 0; j0 * 8 < N; j0 += 2) {
        float st[2][4], dpt[2][4], bm_next[2][4];
        if ((j0 + 2) * 8 < N) load_bias_mask(bm_next, bias_h, mask_b, j0 + 2, r0, N, true);
        pair_times_rows_t_3x<kKK>(ak, qs, zero, j0, N, D, ld, st);
        pair_times_rows_t_3x<kKK>(av, dos, zero, j0, N, D, ld, dpt);
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = (j0 + u) * 8 + c2 + (e & 1), j = e < 2 ? r0 : r1;
            float p = 0.f, ds = 0.f;
            if (i < N && j < N) {
              p = exp2f(fmaf(st[u][e] * scale + bm[u][e], kLog2e, -lse_s[i]));
              ds = p * (dpt[u][e] - delta_s[i]);
            }
            if (j0 + u < kNT) sums[((j0 + u) * 4 + e) * kThreads + threadIdx.x] += ds;
            st[u][e] = p;
            dpt[u][e] = ds;
          }
        frag_times_rows_3x<kDC>(st[0], dos, zero, j0, N, D, ld, acc_v);
        frag_times_rows_3x<kDC>(dpt[0], qs, zero, j0, N, D, ld, acc_k);
        if ((j0 + 1) * 8 < N) {
          frag_times_rows_3x<kDC>(st[1], dos, zero, j0 + 1, N, D, ld, acc_v);
          frag_times_rows_3x<kDC>(dpt[1], qs, zero, j0 + 1, N, D, ld, acc_k);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) bm[u][e] = bm_next[u][e];
      }
      float* dv_w = dv + b * sdv.b + h * sdv.h;
      float* dk_w = dk + b * sdk.b + h * sdk.h;
#pragma unroll
      for (int w = 0; w < kDC; ++w)
        if (w * kTf32Cols < D) {
          store_rows_f32(dv_w, sdv.n, m0, w * kTf32Cols, N, D, 1.f, acc_v[w]);
          store_rows_f32(dk_w, sdk.n, m0, w * kTf32Cols, N, D, scale, acc_k[w]);
        }
    }
    if (b + 1 < b_end) {
      __syncthreads();  // every warp is done with this window's q, do (and k, v)
      if (kv_stages == 1) load_kv(b + 1, 0);
      load_qdo(b + 1);
      cp_async_commit();
    }
  }

  if (!rows) return;
  float* mine = partial + (static_cast<int64_t>(chunk) * H + h) * N * N;
#pragma unroll
  for (int t = 0; t < kNT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = t * 8 + c2 + (e & 1), j = e < 2 ? r0 : r1;
      if (i < N && j < N) mine[i * N + j] = sums[(t * 4 + e) * kThreads + threadIdx.x];
    }
}

// ------------------- streaming forward and backward (f32 and bf16, any N, D <= 128)

// The streaming kernels take every float32 and bfloat16 shape with D <= 128
// that the routes above do not: a head dim that is no multiple of 8 (f32) or
// 16 (bf16), bf16 N = 144 with D > 64 (the tensor-core forward) or D > 32
// (the backward), f32 at N = 144 past the backward's D = 56, and every N >
// 144 (windows 13 and up). Every kernel above keeps a whole window in shared
// memory, so 227 KB caps its N and D; these bring the window through shared
// memory a tile of 48 or 64 rows at a time (stream_tile_rows) and keep no N
// x N tile, so no N is too large.
//
// The same two kernels compute global attention with a gradient (they
// replace no TPU kernel there: jax.nn.dot_product_attention is XLA's; they
// were added so that the port's global-attention backward adds in a fixed
// order, which cuDNN's and FlashAttention's backwards do not):
// nn/attention.py lays q, k, v [B, T, H, D] out as one window per batch row
// (bnw = B, nW = 1). Each kernel reads a bias and a mask: the global-attention
// pair (global_attention.cu) takes every call without a mask and with a bias
// shared by the batch rows, or none, in bf16 and fp32, so what comes here
// without a mask (a bias that varies with the batch row, a head dim that
// pair does not take) gets a zero [1, N, N] mask standing in from the
// wrapper, and a call without a bias a zero [H, N, N] bias, whose gradient
// is dropped. (The forms with the bias alone and with neither, 28 kernels,
// were built until the pair's fp32 form took their last path.) The bias
// and mask reads were the largest cost tools/ablate_window_attention.py
// found in these kernels.
//
// Forward (wa_fwd_stream_kernel), FlashAttention-2's order: one block per
// (chunk of windows, head), persistent over the chunk; a warp owns 16 query
// rows (a block has ceil(N / 16) warps, up to stream_max_warps, and walks the
// rows in rounds past that). Its q fragments sit in registers, the head dim
// zero-padded to Dp (a multiple of 16 in bf16, 8 in f32). The block brings k
// and v a tile at a time by cp.async, double-buffered (the next tile arrives
// while the block computes this one), with zero fill past N and past D; in
// f32 up to D = 64 the block splits each tile into its TF32 halves once
// (split_stage), so no warp splits a k or v value again. Per 16 keys a warp
// forms s = q k^T (mma.sync: m16n8k16 bf16, or m16n8k8 in split TF32 for
// f32), adds scale and bias + mask (read through the cache, two floats a
// load), keeps an online softmax in fp32 registers (the output rescaled once
// per softmax step of up to 64 keys, 32 at D > 64) and adds p v with p taken
// straight from the accumulator fragments (rounded to bf16 as the operand in
// bf16). It stores the real D columns of out and each row's lse (log2 units)
// where the caller asks.
//
// Backward (wa_bwd_stream_kernel), the window-12 kernel's rows-then-keys order
// (wa_bwd_tf32x3_large_kernel) streamed: per window, first the query rows
// (each warp holds q and do of its 16 rows, delta and the forward's lse; per
// tile of k and v: s = q k^T, dp = do v^T, p = exp2((s scale + bias + mask)
// log2(e) - lse), ds = p (dp - delta), dq += ds k), then the keys (each warp
// holds k and v of its 16 keys; per tile of q and do: s^T, dp^T, p^T from
// the rows' lse and delta kept in shared memory, ds^T, dv += p^T do, dk +=
// ds^T q, and ds^T into the chunk's dbias sums). delta = rowsum(do out) in
// f32; in bf16 rowsum(p dp), from a first pass over the keys, since out is
// rounded to bf16 (2^-9), which put dbias at twice its 1e-3 tolerance. Seven
// products a window (eight in bf16), no atomics: the dbias sums of a chunk
// are one slot per thread and logit in shared memory where they fit (f32 N
// <= 144, bf16 N <= 196 at D <= 32), else the chunk's partial in device
// memory, which the thread that owns the logit reads and writes, window
// after window; dbias_reduce_kernel sums the chunk partials in a fixed
// order. Every output is written once and is bitwise repeatable. Rounding
// points in bf16 are the tensor-core backward's: p only as the operand of
// dv, ds only as the operand of dq and dk, dbias from fp32 ds.
//
// What bounds them on the H100 (tools/ablate_window_attention.py, PERF.md
// section 6): far from the bytes, at 7-35x their byte or split-TF32
// bound, by instruction issue and latency with one block of 9-16 warps an
// SM: in f32 the split (each operand value split, three products for one),
// then the bias and mask reads at every logit (8 bytes a logit a pass from
// L2, where SDPA reads a 2-byte pre-summed bias); at N = 256 also the dbias
// partial's reads and writes in L2. A thread of a 9-warp block gets at most
// 168 registers (3 warps share one of the SM's four 16K-register
// sub-partitions), and the f32 backward's q, do (k, v) fragments and its two
// accumulators spill there.

constexpr int kStreamRows = 64;  // the most keys (or queries) of a tile through shared memory

// Rows of a streaming tile for a window of N tokens: 48 or 64, whichever pads
// the last tile less (64 on a tie). Window 12 (N = 144) takes three full
// tiles of 48: with 64 its last tile held 16 keys, a step too short to hide
// the next tile's copy (tiles of 64 took the f32 D = 36 backward 3.5% longer,
// tools/ablate_window_attention.py)
__host__ __device__ constexpr int stream_tile_rows(int N) {
  return (N + 47) / 48 * 48 - N < (N + 63) / 64 * 64 - N ? 48 : 64;
}

// Warps a streaming block may have, by the head-dim bucket its kernel is
// compiled for: 65,536 registers over 32 x warps threads, one block an SM
// (128 registers a thread at D <= 32, 168 at D <= 64: 9 warps put 3 on one
// of the SM's four 16K-register sub-partitions; 255 at D <= 128). Nine warps
// hold Swin's window 12 (N = 144) in one round
__host__ __device__ constexpr int stream_max_warps(int kDMax) {
  return kDMax <= 32 ? 16 : kDMax <= 64 ? 9 : 8;
}

// The head dim padded to a product step: 16 in bf16 (m16n8k16), 8 in f32 (m16n8k8)
template <typename T>
__host__ __device__ constexpr int stream_dp(int D) {
  return sizeof(T) == 2 ? (D + 15) / 16 * 16 : (D + 7) / 8 * 8;
}

// Row pitch of a shared tile: Dp plus 16 bytes, an odd multiple of 16 bytes
// in bf16 (ldmatrix rows on distinct banks) and 4 mod 8 floats in f32 (the
// fragment loads on 32 distinct banks)
template <typename T>
__host__ __device__ constexpr int stream_ld(int D) {
  return stream_dp<T>(D) + 16 / static_cast<int>(sizeof(T));
}

// mma_bf16 without volatile: the streaming kernels' independent products
// (s and dp, the 16-key groups) may then interleave
__device__ __forceinline__ void mma_bf16_free(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}

// Rows row0 .. row0 + rows - 1 of one (window, head) [N][D] operand into a
// shared [kStreamRows][ld] tile, zeros past N and from D to Dp: by
// cp.async, 16 bytes a piece, where `vec` (16-byte aligned rows with D a
// multiple of a piece), else element by element (the caller commits)
template <typename T>
__device__ __forceinline__ void stream_tile(const T* base, long long sn, int row0, int rows, int N,
                                            int D, bool vec, T* dst) {
  const int Dp = stream_dp<T>(D), ld = stream_ld<T>(D);
  if (vec) {
    constexpr int kPiece = 16 / sizeof(T);
    const int pieces = Dp / kPiece;
    for (int e = threadIdx.x; e < rows * pieces; e += blockDim.x) {
      const int row = e / pieces, col = (e - row * pieces) * kPiece, r = row0 + row;
      const bool in = r < N && col < D;
      cp_async16_zfill(smem_addr(dst + row * ld + col), in ? base + r * sn + col : base,
                       in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * Dp; e += blockDim.x) {
      const int row = e / Dp, col = e - row * Dp, r = row0 + row;
      dst[row * ld + col] = r < N && col < D ? base[r * sn + col] : from_f<T>(0.f);
    }
  }
}

// A warp's 16 rows m0 .. m0 + 15 of a [N][D] operand (through its token
// stride) as A fragments in registers, zeros past N and past D: bf16 pairs
// for m16n8k16 (a[c] covers columns 16c .. 16c + 15), or fp32 values in the
// natural order of the split-TF32 m16n8k8 (a[c]: columns 8c + t and 8c + t + 4)
template <typename T, int kDMax>
struct RowFrags;

template <int kDMax>
struct RowFrags<__nv_bfloat16, kDMax> {
  static constexpr int kSteps = kDMax / 16;
  uint32_t a[kSteps][4];
  __device__ __forceinline__ void load(const __nv_bfloat16* base, long long sn, int m0, int N,
                                       int D) {
    const int lane = threadIdx.x & 31, r0 = m0 + (lane >> 2), r1 = r0 + 8, t = lane & 3;
    auto x = [&](int r, int d) {
      return r < N && d < D ? __bfloat162float(base[r * sn + d]) : 0.f;
    };
#pragma unroll
    for (int c = 0; c < kSteps; ++c) {
      const int d = 16 * c + 2 * t;
      a[c][0] = bf16x2(x(r0, d), x(r0, d + 1));
      a[c][1] = bf16x2(x(r1, d), x(r1, d + 1));
      a[c][2] = bf16x2(x(r0, d + 8), x(r0, d + 9));
      a[c][3] = bf16x2(x(r1, d + 8), x(r1, d + 9));
    }
  }
};

template <int kDMax>
struct RowFrags<float, kDMax> {
  static constexpr int kSteps = kDMax / 8;
  float a[kSteps][4];
  __device__ __forceinline__ void load(const float* base, long long sn, int m0, int N, int D) {
    const int lane = threadIdx.x & 31, r0 = m0 + (lane >> 2), r1 = r0 + 8, t = lane & 3;
    auto x = [&](int r, int d) { return r < N && d < D ? base[r * sn + d] : 0.f; };
#pragma unroll
    for (int c = 0; c < kSteps; ++c) {
      const int d = 8 * c + t;
      a[c][0] = x(r0, d);
      a[c][1] = x(r1, d);
      a[c][2] = x(r0, d + 4);
      a[c][3] = x(r1, d + 4);
    }
  }
};

// s[u] (16 x 8: the warp's 16 rows by tile rows row0 + 8u .. row0 + 8u + 7)
// = A B^T over the padded head dim, A in registers, B a shared tile. In f32,
// kTwoChains sums the even and the odd steps of the head dim into two
// accumulators, two chains of dependent products where one would be twice
// as long: the forward takes them; the backward, short of registers, does not
// (each choice was 5% and 2% faster there, tools/ablate_window_attention.py)
template <bool kTwoChains = true, int kDMax>
__device__ __forceinline__ void frags_times_tile_t(const RowFrags<__nv_bfloat16, kDMax>& f,
                                                   const __nv_bfloat16* tile, int ld, int row0,
                                                   int Dp, float (&s)[2][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < 2; ++u) s[u][0] = s[u][1] = s[u][2] = s[u][3] = 0.f;
  const uint32_t addr = smem_addr(tile + (row0 + (lane & 7) + ((lane >> 4) << 3)) * ld) +
                        ((lane >> 3) & 1) * 16;
#pragma unroll
  for (int c = 0; c < kDMax / 16; ++c)
    if (16 * c < Dp) {
      uint32_t b[4];
      ldsm_x4(b, addr + c * 32);
      mma_bf16_free(s[0], f.a[c], b[0], b[1]);
      mma_bf16_free(s[1], f.a[c], b[2], b[3]);
    }
}

template <bool kTwoChains = true, int kDMax>
__device__ __forceinline__ void frags_times_tile_t(const RowFrags<float, kDMax>& f,
                                                   const float* tile, int ld, int row0, int Dp,
                                                   float (&s)[2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float odd[2][4];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    s[u][0] = s[u][1] = s[u][2] = s[u][3] = 0.f;
    odd[u][0] = odd[u][1] = odd[u][2] = odd[u][3] = 0.f;
  }
  const float* b0 = tile + (row0 + g) * ld + t;
  const float* b1 = b0 + 8 * ld;
#pragma unroll
  for (int c = 0; c < kDMax / 8; ++c)
    if (8 * c < Dp) {
      Split<4> sa;
#pragma unroll
      for (int i = 0; i < 4; ++i) sa.set(i, f.a[c][i]);
      Split<2> x, y;
      x.set(0, b0[8 * c]);
      x.set(1, b0[8 * c + 4]);
      y.set(0, b1[8 * c]);
      y.set(1, b1[8 * c + 4]);
      float (&dst)[2][4] = kTwoChains && c % 2 == 1 ? odd : s;
      mma_3xtf32(dst[0], sa, x);
      mma_3xtf32(dst[1], sa, y);
    }
  if constexpr (kTwoChains) {
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[u][e] += odd[u][e];
  }
}

// An fp32 tile split once into its TF32 halves ([kStreamRows][ld] each), as
// Split splits an operand: every warp that reads the tile reads the halves
// and splits nothing
struct SplitTile {
  const uint32_t* hi;
  const uint32_t* lo;
};

// Whether the streaming kernels split their fp32 tiles once in shared memory
// (D <= 64: the halves fit beside the raw tiles and the backward's sums)
template <typename T>
__host__ __device__ constexpr bool stream_presplit(int D) {
  return sizeof(T) == 4 && D <= 64;
}

// The first `count` floats of the stage's two raw fp32 tiles (contiguous,
// `tile` floats apart) into split [2 tiles][hi, lo][tile], four values a
// thread at a time
__device__ __forceinline__ void split_stage(const float* raw, uint32_t* split, int tile,
                                            int count) {
  for (int w = 0; w < 2; ++w)
    for (int e = threadIdx.x * 4; e < count; e += blockDim.x * 4) {
      const float4 x = *reinterpret_cast<const float4*>(raw + w * tile + e);
      Split<4> sx;
      sx.set(0, x.x);
      sx.set(1, x.y);
      sx.set(2, x.z);
      sx.set(3, x.w);
      *reinterpret_cast<uint4*>(split + 2 * w * tile + e) =
          make_uint4(sx.hi[0], sx.hi[1], sx.hi[2], sx.hi[3]);
      *reinterpret_cast<uint4*>(split + (2 * w + 1) * tile + e) =
          make_uint4(sx.lo[0], sx.lo[1], sx.lo[2], sx.lo[3]);
    }
}

// Tile `which` (0 or 1) of a stage: the raw tile, or its split halves
template <bool kSplit, typename T>
__device__ __forceinline__ auto stage_tile(const T* stage, const uint32_t* split, int tile,
                                           int which) {
  if constexpr (kSplit) {
    return SplitTile{split + 2 * which * tile, split + (2 * which + 1) * tile};
  } else {
    return stage + which * tile;
  }
}

template <bool kTwoChains = true, int kDMax>
__device__ __forceinline__ void frags_times_tile_t(const RowFrags<float, kDMax>& f, SplitTile tile,
                                                   int ld, int row0, int Dp, float (&s)[2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float odd[2][4];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    s[u][0] = s[u][1] = s[u][2] = s[u][3] = 0.f;
    odd[u][0] = odd[u][1] = odd[u][2] = odd[u][3] = 0.f;
  }
  const int o0 = (row0 + g) * ld + t, o1 = o0 + 8 * ld;
#pragma unroll
  for (int c = 0; c < kDMax / 8; ++c)
    if (8 * c < Dp) {
      Split<4> sa;
#pragma unroll
      for (int i = 0; i < 4; ++i) sa.set(i, f.a[c][i]);
      Split<2> x, y;
      x.hi[0] = tile.hi[o0 + 8 * c];
      x.lo[0] = tile.lo[o0 + 8 * c];
      x.hi[1] = tile.hi[o0 + 8 * c + 4];
      x.lo[1] = tile.lo[o0 + 8 * c + 4];
      y.hi[0] = tile.hi[o1 + 8 * c];
      y.lo[0] = tile.lo[o1 + 8 * c];
      y.hi[1] = tile.hi[o1 + 8 * c + 4];
      y.lo[1] = tile.lo[o1 + 8 * c + 4];
      float (&dst)[2][4] = kTwoChains && c % 2 == 1 ? odd : s;
      mma_3xtf32(dst[0], sa, x);
      mma_3xtf32(dst[1], sa, y);
    }
  if constexpr (kTwoChains) {
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[u][e] += odd[u][e];
  }
}

template <int kW>
__device__ __forceinline__ void pair_times_tile(const float (&s)[2][4], SplitTile tile, int ld,
                                                int row0, int Dp, float (&acc)[kW][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    Split<4> a;
    a.set(0, s[u][0]);
    a.set(1, s[u][2]);
    a.set(2, s[u][1]);
    a.set(3, s[u][3]);
    const int o0 = (row0 + 8 * u + 2 * t) * ld + g, o1 = o0 + ld;
#pragma unroll
    for (int w = 0; w < kW; ++w)
      if (8 * w < Dp) {
        Split<2> b;
        b.hi[0] = tile.hi[o0 + 8 * w];
        b.lo[0] = tile.lo[o0 + 8 * w];
        b.hi[1] = tile.hi[o1 + 8 * w];
        b.lo[1] = tile.lo[o1 + 8 * w];
        mma_3xtf32(acc[w], a, b);
      }
  }
}

// acc[w] (16 x 8, columns 8w .. 8w + 7) += P B[row0 .. row0 + 15][:Dp]: P
// the 16 x 16 accumulator pair s, whose columns name tile rows row0 ..; in
// bf16 P is rounded to bf16 as the A operand, in f32 split (paired order)
template <int kW>
__device__ __forceinline__ void pair_times_tile(const float (&s)[2][4], const __nv_bfloat16* tile,
                                                int ld, int row0, int Dp, float (&acc)[kW][4]) {
  const int lane = threadIdx.x & 31;
  const uint32_t a[4] = {bf16x2(s[0][0], s[0][1]), bf16x2(s[0][2], s[0][3]),
                         bf16x2(s[1][0], s[1][1]), bf16x2(s[1][2], s[1][3])};
  const uint32_t addr = smem_addr(tile + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld) +
                        (lane >> 4) * 16;
#pragma unroll
  for (int w = 0; w < kW / 2; ++w)
    if (16 * w < Dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, addr + w * 32);
      mma_bf16_free(acc[2 * w], a, b[0], b[1]);
      mma_bf16_free(acc[2 * w + 1], a, b[2], b[3]);
    }
}

template <int kW>
__device__ __forceinline__ void pair_times_tile(const float (&s)[2][4], const float* tile, int ld,
                                                int row0, int Dp, float (&acc)[kW][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    Split<4> a;
    a.set(0, s[u][0]);
    a.set(1, s[u][2]);
    a.set(2, s[u][1]);
    a.set(3, s[u][3]);
    const float* b0 = tile + (row0 + 8 * u + 2 * t) * ld + g;
    const float* b1 = b0 + ld;
#pragma unroll
    for (int w = 0; w < kW; ++w)
      if (8 * w < Dp) {
        Split<2> b;
        b.set(0, b0[8 * w]);
        b.set(1, b1[8 * w]);
        mma_3xtf32(acc[w], a, b);
      }
  }
}

__device__ __forceinline__ void store_pair(float* p, float x0, float x1, bool two) {
  if (two && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
  } else {
    p[0] = x0;
    if (two) p[1] = x1;
  }
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x0, float x1, bool two) {
  if (two && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
    *reinterpret_cast<uint32_t*>(p) = bf16x2(x0, x1);
  } else {
    p[0] = __float2bfloat16(x0);
    if (two) p[1] = __float2bfloat16(x1);
  }
}

// rows m0 .. m0 + 15 (those < N), columns < D of a token-major output, times mul
template <typename T, int kW>
__device__ __forceinline__ void store_acc_rows(T* base, long long sn, int m0, int N, int D,
                                               float mul, const float (&acc)[kW][4]) {
  const int lane = threadIdx.x & 31, r0 = m0 + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    const int c = 8 * w + 2 * t;
    if (c >= D) continue;
    if (r0 < N) store_pair(base + r0 * sn + c, acc[w][0] * mul, acc[w][1] * mul, c + 1 < D);
    if (r0 + 8 < N)
      store_pair(base + (r0 + 8) * sn + c, acc[w][2] * mul, acc[w][3] * mul, c + 1 < D);
  }
}

// bias + mask at the logits this lane holds of a 16 x 16 pair: rows r0, r0 +
// 8 by columns c0 .. c0 + 15 (with `keys`, the rows are keys and the columns
// queries: the logit of query i and key j is at [i][j]); 0 past N. Both come
// through the cache, loaded before the group's products. (The head's bias
// held in shared memory was slower at N = 144: its rows, 144 floats apart,
// put four lanes on a bank; loading a group ahead cost registers and spills
// and was slower too.)
__device__ __forceinline__ void stream_bias_mask(float (&bm)[2][4], const float* bias_h,
                                                 const float* mask_b, int c0, int r0, int N,
                                                 bool keys) {
  auto load2 = [&](int at) {
    const float2 bv = __ldg(reinterpret_cast<const float2*>(bias_h + at));
    const float2 mv = __ldg(reinterpret_cast<const float2*>(mask_b + at));
    return make_float2(bv.x + mv.x, bv.y + mv.y);
  };
  auto load1 = [&](int at) { return __ldg(bias_h + at) + __ldg(mask_b + at); };
  const int c = c0 + (threadIdx.x & 3) * 2;
  if (!keys && N % 2 == 0) {  // a lane's two columns of a row: one 8-byte load each
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + 8 * half, col = c + 8 * u;
        const float2 x = row < N && col < N ? load2(row * N + col) : make_float2(0.f, 0.f);
        bm[u][2 * half] = x.x;
        bm[u][2 * half + 1] = x.y;
      }
    return;
  }
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? r0 : r0 + 8, col = c + 8 * u + (e & 1);
      const int at = keys ? col * N + row : row * N + col;
      bm[u][e] = row < N && col < N ? load1(at) : 0.f;
    }
}

// Shared memory of the streaming kernels, in bytes. Both keep two sets (the
// tile computed and the next one) of two tiles [kStreamRows][ld] (k and v;
// the backward's keys pass q and do) and, in f32 up to D = 64, the split
// halves of the tiles computed; the backward also the rows' lse and delta
// and, where they fit, the chunk's dbias sums. A tile of 48 rows keeps the
// stride of 64: a stride of stream_tile_rows(N) x ld cost the f32 backward
// registers it spilled (0.75 -> 0.88 ms at N = 144, D = 36).
template <typename T>
__host__ __device__ constexpr size_t fwd_stream_smem(int D) {
  return (stream_presplit<T>(D) ? 8 : 4) * static_cast<size_t>(kStreamRows) * stream_ld<T>(D) *
         sizeof(T);
}

// One block per (chunk of windows, head), blockDim.x / 32 warps of 16 query
// rows each; the block's steps run over the chunk's windows, each window's
// rounds of rows and each round's key tiles, with the next step's k and v
// tiles on their way by cp.async during this one. It reads a bias and a mask
// (zero ones stand in for a call that lacks them)
template <typename T, int kDMax>
__global__ void __launch_bounds__(32 * stream_max_warps(kDMax), 1)
wa_fwd_stream_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ bias, const float* __restrict__ mask,
                     T* __restrict__ out, Strides sq, Strides sk, Strides sv, Strides so,
                     int bnw, int H, int N, int D, int nW, int windows_per_chunk, float scale,
                     float* __restrict__ lse, int vec) {
  constexpr int kW = kDMax / 8;                 // 8-column tiles of the output
  constexpr int kGroups = kDMax <= 64 ? 4 : 2;  // 16-key groups a softmax step
  constexpr bool kPresplit = stream_presplit<T>(kDMax);
  extern __shared__ __align__(16) unsigned char wa_mma_smem[];
  const int Dp = stream_dp<T>(D), ld = stream_ld<T>(D), tile = kStreamRows * ld;
  const int tile_rows = stream_tile_rows(N);
  T* tiles = reinterpret_cast<T*>(wa_mma_smem);  // [2 stages][k, v][kStreamRows][ld]
  uint32_t* split = reinterpret_cast<uint32_t*>(tiles + 4 * tile);  // [k, v][hi, lo], kPresplit
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int row_tiles = (N + 15) / 16, rounds = (row_tiles + warps - 1) / warps;
  const int key_tiles = (N + tile_rows - 1) / tile_rows, per_window = rounds * key_tiles;
  const int chunk = blockIdx.x / H, h = blockIdx.x - chunk * H;
  const int b_first = chunk * windows_per_chunk;
  const int steps = max(0, min(bnw, b_first + windows_per_chunk) - b_first) * per_window;
  const float* bias_h = bias + static_cast<int64_t>(h) * N * N;

  auto load = [&](int step) {
    const int b = b_first + step / per_window, row0 = step % key_tiles * tile_rows;
    T* dst = tiles + (step & 1) * 2 * tile;
    stream_tile(k + b * sk.b + h * sk.h, sk.n, row0, tile_rows, N, D, vec, dst);
    stream_tile(v + b * sv.b + h * sv.h, sv.n, row0, tile_rows, N, D, vec, dst + tile);
    cp_async_commit();
  };

  RowFrags<T, kDMax> fq;
  float acc[kW][4];
  float mx0 = -INFINITY, mx1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  if (steps > 0) load(0);
  for (int step = 0; step < steps; ++step) {
    cp_async_wait_all();
    __syncthreads();  // this step's tiles are in; every warp is done with the last step's
    if (step + 1 < steps) load(step + 1);
    if constexpr (kPresplit) {
      split_stage(reinterpret_cast<const float*>(tiles + (step & 1) * 2 * tile), split, tile,
                  tile_rows * ld);
      __syncthreads();
    }
    const int b = b_first + step / per_window, in_window = step % per_window;
    const int kt = in_window % key_tiles, m0 = (warp + in_window / key_tiles * warps) * 16;
    if (m0 >= N) continue;  // no rows of this warp in this round
    const int r0 = m0 + (lane >> 2), r1 = r0 + 8;
    if (kt == 0) {
      fq.load(q + b * sq.b + h * sq.h, sq.n, m0, N, D);
#pragma unroll
      for (int w = 0; w < kW; ++w) acc[w][0] = acc[w][1] = acc[w][2] = acc[w][3] = 0.f;
      mx0 = mx1 = -INFINITY;
      l0 = l1 = 0.f;
    }
    const float* mask_b = mask + static_cast<int64_t>(b % nW) * N * N;
    const auto ks = stage_tile<kPresplit>(tiles + (step & 1) * 2 * tile, split, tile, 0);
    const auto vs = stage_tile<kPresplit>(tiles + (step & 1) * 2 * tile, split, tile, 1);
    const int key0 = kt * tile_rows;
    for (int k0 = 0; k0 < tile_rows && key0 + k0 < N; k0 += 16 * kGroups) {
      float s[kGroups][2][4];
      float tmax0 = -INFINITY, tmax1 = -INFINITY;
#pragma unroll
      for (int gi = 0; gi < kGroups; ++gi) {
        const int key = key0 + k0 + 16 * gi;  // the group's first key
        const bool in = k0 + 16 * gi < tile_rows && key < N;
        float bm[2][4];
        if (in) {
          stream_bias_mask(bm, bias_h, mask_b, key, r0, N, false);
          frags_times_tile_t(fq, ks, ld, k0 + 16 * gi, Dp, s[gi]);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e < 2 ? r0 : r1, j = key + 8 * u + 2 * t + (e & 1);
            float x = -INFINITY;
            if (in && i < N && j < N) x = s[gi][u][e] * scale + bm[u][e];
            s[gi][u][e] = x;
            if (e < 2) tmax0 = fmaxf(tmax0, x);
            else tmax1 = fmaxf(tmax1, x);
          }
      }
      const float new0 = fmaxf(mx0, quad_max(tmax0)), new1 = fmaxf(mx1, quad_max(tmax1));
      const float sub0 = (new0 == -INFINITY ? 0.f : new0) * kLog2e;
      const float sub1 = (new1 == -INFINITY ? 0.f : new1) * kLog2e;
      const float corr0 = exp2f(fmaf(mx0, kLog2e, -sub0)), corr1 = exp2f(fmaf(mx1, kLog2e, -sub1));
      mx0 = new0;
      mx1 = new1;
      l0 *= corr0;
      l1 *= corr1;
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        acc[w][0] *= corr0;
        acc[w][1] *= corr0;
        acc[w][2] *= corr1;
        acc[w][3] *= corr1;
      }
#pragma unroll
      for (int gi = 0; gi < kGroups; ++gi)
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[gi][u][e] = exp2f(fmaf(s[gi][u][e], kLog2e, -(e < 2 ? sub0 : sub1)));
            if (e < 2) l0 += s[gi][u][e];
            else l1 += s[gi][u][e];
          }
#pragma unroll
      for (int gi = 0; gi < kGroups; ++gi)
        if (k0 + 16 * gi < tile_rows && key0 + k0 + 16 * gi < N)
          pair_times_tile(s[gi], vs, ld, k0 + 16 * gi, Dp, acc);
    }
    if (kt == key_tiles - 1) {
      const float sum0 = quad_sum(l0), sum1 = quad_sum(l1);
      const float inv0 = sum0 > 0.f ? 1.f / sum0 : 0.f, inv1 = sum1 > 0.f ? 1.f / sum1 : 0.f;
      store_lse(lse, b, h, H, N, r0,
                sum0 > 0.f ? (mx0 == -INFINITY ? 0.f : mx0) * kLog2e + log2f(sum0) : INFINITY,
                sum1 > 0.f ? (mx1 == -INFINITY ? 0.f : mx1) * kLog2e + log2f(sum1) : INFINITY);
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        acc[w][0] *= inv0;
        acc[w][1] *= inv0;
        acc[w][2] *= inv1;
        acc[w][3] *= inv1;
      }
      store_acc_rows(out + b * so.b + h * so.h, so.n, m0, N, D, 1.f, acc);
    }
  }
}

// Blocks of a streaming kernel: ceil(N / 16) row tiles over at most
// stream_max_warps warps, in as few rounds as that allows
__host__ __device__ constexpr int stream_warps(int N, int D) {
  const int row_tiles = (N + 15) / 16, most = stream_max_warps(D <= 32 ? 32 : D <= 64 ? 64 : 128);
  const int rounds = (row_tiles + most - 1) / most;
  return (row_tiles + rounds - 1) / rounds;
}

// The backward's dbias sums a block keeps in shared memory, in floats: one
// slot per thread for each (round, 16-query group, logit of the thread's
// accumulator pair)
__host__ __device__ constexpr size_t bwd_stream_sums(int N, int D) {
  const int row_tiles = (N + 15) / 16, warps = stream_warps(N, D);
  const int rounds = (row_tiles + warps - 1) / warps;
  return static_cast<size_t>(rounds) * row_tiles * 8 * 32 * warps;
}

// The backward's tiles and the rows' lse and delta
template <typename T>
__host__ __device__ constexpr size_t bwd_stream_base(int N, int D) {
  return fwd_stream_smem<T>(D) + 2 * 4 * static_cast<size_t>((N + 15) / 16 * 16);
}

// Whether a launch keeps its dbias sums in shared memory (else the chunk's
// partial in device memory)
template <typename T>
__host__ __device__ constexpr bool bwd_stream_sums_in_smem(int N, int D) {
  return bwd_stream_base<T>(N, D) + 4 * bwd_stream_sums(N, D) <= kMaxDynamicSmem;
}

template <typename T>
__host__ __device__ constexpr size_t bwd_stream_smem(int N, int D) {
  return bwd_stream_base<T>(N, D) +
         (bwd_stream_sums_in_smem<T>(N, D) ? 4 * bwd_stream_sums(N, D) : 0);
}

// One block per (chunk of windows, head), blockDim.x / 32 warps. Per window,
// steps over rounds x key tiles for the rows (warp w: query rows of row tile
// w + round x warps), then over rounds x query tiles for the keys (warp w:
// keys of that row tile); each step's two tiles arrive by cp.async during
// the step before. The dbias sums sit in shared memory where they fit
// (bwd_stream_sums_in_smem), else in the chunk's partial in device memory.
template <typename T, int kDMax>
__global__ void __launch_bounds__(32 * stream_max_warps(kDMax), 1)
wa_bwd_stream_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ bias,
                     const float* __restrict__ mask, T* __restrict__ dq, T* __restrict__ dk,
                     T* __restrict__ dv, float* __restrict__ partial, Strides sq, Strides sk,
                     Strides sv, Strides sdo, Strides sdq, Strides sdk, Strides sdv, int bnw,
                     int H, int N, int D, int nW, int windows_per_chunk, float scale,
                     const T* __restrict__ out, const float* __restrict__ lse, Strides so,
                     int vec) {
  constexpr int kW = kDMax / 8;
  // bf16: a first pass over the keys forms delta = rowsum(p dp) in fp32 (do
  // out would read the output rounded to bf16, 2^-9 off, which dbias's 1e-3
  // does not allow); f32: delta = rowsum(do out) and one pass
  constexpr int kRowPasses = sizeof(T) == 2 ? 2 : 1;
  constexpr bool kPresplit = stream_presplit<T>(kDMax);
  extern __shared__ __align__(16) unsigned char wa_mma_smem[];
  const int Dp = stream_dp<T>(D), ld = stream_ld<T>(D), tile = kStreamRows * ld;
  const int tile_rows = stream_tile_rows(N), tiles_n = (N + tile_rows - 1) / tile_rows;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int row_tiles = (N + 15) / 16, rounds = (row_tiles + warps - 1) / warps;
  const int row_steps = rounds * kRowPasses * tiles_n, per_window = row_steps + rounds * tiles_n;
  T* tiles = reinterpret_cast<T*>(wa_mma_smem);  // [2 stages][k, v or q, do][kStreamRows][ld]
  uint32_t* split = reinterpret_cast<uint32_t*>(tiles + 4 * tile);  // [2][hi, lo], kPresplit
  float* lse_s = reinterpret_cast<float*>(tiles + (kPresplit ? 8 : 4) * tile);  // [row_tiles * 16]
  float* delta_s = lse_s + row_tiles * 16;                    // [row_tiles * 16]
  const bool sums_smem = bwd_stream_sums_in_smem<T>(N, D);
  float* sums = delta_s + row_tiles * 16;  // [rounds][row_tiles][8][blockDim.x], sums_smem
  const int chunk = blockIdx.x / H, h = blockIdx.x - chunk * H;
  const int b_first = chunk * windows_per_chunk;
  const int steps = max(0, min(bnw, b_first + windows_per_chunk) - b_first) * per_window;
  const float* bias_h = bias + static_cast<int64_t>(h) * N * N;
  float* partial_w = partial + (static_cast<int64_t>(chunk) * H + h) * N * N;

  if (sums_smem)
    for (int e = threadIdx.x; e < rounds * row_tiles * 8 * static_cast<int>(blockDim.x);
         e += blockDim.x)
      sums[e] = 0.f;

  auto load = [&](int step) {
    const int b = b_first + step / per_window, r = step % per_window;
    const int row0 = (r < row_steps ? r : r - row_steps) % tiles_n * tile_rows;
    T* dst = tiles + (step & 1) * 2 * tile;
    if (r < row_steps) {  // the rows' steps: k and v
      stream_tile(k + b * sk.b + h * sk.h, sk.n, row0, tile_rows, N, D, vec, dst);
      stream_tile(v + b * sv.b + h * sv.h, sv.n, row0, tile_rows, N, D, vec, dst + tile);
    } else {  // the keys' steps: q and do
      stream_tile(q + b * sq.b + h * sq.h, sq.n, row0, tile_rows, N, D, vec, dst);
      stream_tile(dout + b * sdo.b + h * sdo.h, sdo.n, row0, tile_rows, N, D, vec, dst + tile);
    }
    cp_async_commit();
  };

  // q and do (rows), or k and v (keys), of the warp's 16 rows; dq (rows), or
  // dv and dk (keys)
  RowFrags<T, kDMax> fa, fb;
  float acc0[kW][4], acc1[kW][4];
  float lse0 = 0.f, lse1 = 0.f, delta0 = 0.f, delta1 = 0.f;
  if (steps > 0) load(0);
  for (int step = 0; step < steps; ++step) {
    cp_async_wait_all();
    __syncthreads();  // this step's tiles are in; every warp is done with the last step's
    if (step + 1 < steps) load(step + 1);
    if constexpr (kPresplit) {
      split_stage(reinterpret_cast<const float*>(tiles + (step & 1) * 2 * tile), split, tile,
                  tile_rows * ld);
      __syncthreads();
    }
    const int b = b_first + step / per_window, r = step % per_window;
    const bool keys = r >= row_steps;
    const int rk = keys ? r - row_steps : r, tt = rk % tiles_n;
    const int round = keys ? rk / tiles_n : rk / (kRowPasses * tiles_n);
    const bool last_pass = keys || rk / tiles_n % kRowPasses == kRowPasses - 1;
    const int m0 = (warp + round * warps) * 16;
    if (m0 >= N) continue;  // no rows of this warp in this round
    const int r0 = m0 + (lane >> 2), r1 = r0 + 8, row0 = tt * tile_rows;
    const float* mask_b = mask + static_cast<int64_t>(b % nW) * N * N;
    // k (rows) or q (keys), and v (rows) or do (keys)
    const auto ts0 = stage_tile<kPresplit>(tiles + (step & 1) * 2 * tile, split, tile, 0);
    const auto ts1 = stage_tile<kPresplit>(tiles + (step & 1) * 2 * tile, split, tile, 1);
    if (!keys && !last_pass) {  // bf16: delta = rowsum(p dp), fp32
      if (tt == 0) {
        fa.load(q + b * sq.b + h * sq.h, sq.n, m0, N, D);
        fb.load(dout + b * sdo.b + h * sdo.h, sdo.n, m0, N, D);
        const float* lse_w = lse + (static_cast<int64_t>(b) * H + h) * N;
        lse0 = r0 < N ? __ldg(lse_w + r0) : INFINITY;
        lse1 = r1 < N ? __ldg(lse_w + r1) : INFINITY;
        delta0 = delta1 = 0.f;
      }
#pragma unroll
      for (int gi = 0; gi < kStreamRows / 16; ++gi) {
        const int key = row0 + 16 * gi;
        if (16 * gi >= tile_rows || key >= N) break;
        float s[2][4], dp[2][4], bm[2][4];
        stream_bias_mask(bm, bias_h, mask_b, key, r0, N, false);
        frags_times_tile_t<false>(fa, ts0, ld, 16 * gi, Dp, s);
        frags_times_tile_t<false>(fb, ts1, ld, 16 * gi, Dp, dp);
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e < 2 ? r0 : r1, j = key + 8 * u + 2 * t + (e & 1);
            if (i < N && j < N) {
              const float x = s[u][e] * scale + bm[u][e];
              const float p = exp2f(fmaf(x, kLog2e, -(e < 2 ? lse0 : lse1)));
              if (e < 2) delta0 = fmaf(p, dp[u][e], delta0);
              else delta1 = fmaf(p, dp[u][e], delta1);
            }
          }
      }
      if (tt == tiles_n - 1) {
        delta0 = quad_sum(delta0);
        delta1 = quad_sum(delta1);
        if (t == 0) {
          lse_s[r0] = lse0;
          lse_s[r1] = lse1;
          delta_s[r0] = delta0;
          delta_s[r1] = delta1;
        }
      }
    } else if (!keys) {
      if (tt == 0) {
#pragma unroll
        for (int w = 0; w < kW; ++w) acc0[w][0] = acc0[w][1] = acc0[w][2] = acc0[w][3] = 0.f;
      }
      if (kRowPasses == 1 && tt == 0) {
        fa.load(q + b * sq.b + h * sq.h, sq.n, m0, N, D);
        fb.load(dout + b * sdo.b + h * sdo.h, sdo.n, m0, N, D);
        // delta = rowsum(do out) and lse of rows r0, r1 (past N: 0 and +inf)
        const T* do_w = dout + b * sdo.b + h * sdo.h;
        const T* out_w = out + b * so.b + h * so.h;
        float d0 = 0.f, d1 = 0.f;
        for (int d = t; d < D; d += 4) {
          if (r0 < N) d0 = fmaf(to_f(do_w[r0 * sdo.n + d]), to_f(out_w[r0 * so.n + d]), d0);
          if (r1 < N) d1 = fmaf(to_f(do_w[r1 * sdo.n + d]), to_f(out_w[r1 * so.n + d]), d1);
        }
        delta0 = quad_sum(d0);
        delta1 = quad_sum(d1);
        const float* lse_w = lse + (static_cast<int64_t>(b) * H + h) * N;
        lse0 = r0 < N ? __ldg(lse_w + r0) : INFINITY;
        lse1 = r1 < N ? __ldg(lse_w + r1) : INFINITY;
        if (t == 0) {
          lse_s[r0] = lse0;
          lse_s[r1] = lse1;
          delta_s[r0] = delta0;
          delta_s[r1] = delta1;
        }
      }
#pragma unroll
      for (int gi = 0; gi < kStreamRows / 16; ++gi) {
        const int key = row0 + 16 * gi;
        if (16 * gi >= tile_rows || key >= N) break;
        float s[2][4], dp[2][4], bm[2][4];
        stream_bias_mask(bm, bias_h, mask_b, key, r0, N, false);
        frags_times_tile_t<false>(fa, ts0, ld, 16 * gi, Dp, s);
        frags_times_tile_t<false>(fb, ts1, ld, 16 * gi, Dp, dp);
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e < 2 ? r0 : r1, j = key + 8 * u + 2 * t + (e & 1);
            float ds = 0.f;
            if (i < N && j < N) {
              const float x = s[u][e] * scale + bm[u][e];
              const float p = exp2f(fmaf(x, kLog2e, -(e < 2 ? lse0 : lse1)));
              ds = p * (dp[u][e] - (e < 2 ? delta0 : delta1));
            }
            s[u][e] = ds;
          }
        pair_times_tile(s, ts0, ld, 16 * gi, Dp, acc0);  // dq += ds k
      }
      if (tt == tiles_n - 1) store_acc_rows(dq + b * sdq.b + h * sdq.h, sdq.n, m0, N, D, scale, acc0);
    } else {
      // rows r0, r1 of the accumulator tiles are keys, their columns queries
      if (tt == 0) {
        fa.load(k + b * sk.b + h * sk.h, sk.n, m0, N, D);
        fb.load(v + b * sv.b + h * sv.h, sv.n, m0, N, D);
#pragma unroll
        for (int w = 0; w < kW; ++w) {
          acc0[w][0] = acc0[w][1] = acc0[w][2] = acc0[w][3] = 0.f;
          acc1[w][0] = acc1[w][1] = acc1[w][2] = acc1[w][3] = 0.f;
        }
      }
#pragma unroll
      for (int gi = 0; gi < kStreamRows / 16; ++gi) {
        const int query = row0 + 16 * gi;
        if (16 * gi >= tile_rows || query >= N) break;
        float st[2][4], dpt[2][4], bm[2][4];
        stream_bias_mask(bm, bias_h, mask_b, query, r0, N, true);
        frags_times_tile_t<false>(fa, ts0, ld, 16 * gi, Dp, st);
        frags_times_tile_t<false>(fb, ts1, ld, 16 * gi, Dp, dpt);
        float* slot = sums + static_cast<size_t>((round * row_tiles + query / 16) * 8) * blockDim.x +
                      threadIdx.x;
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = query + 8 * u + 2 * t + (e & 1), j = e < 2 ? r0 : r1;
            float p = 0.f, ds = 0.f;
            if (i < N && j < N) {
              const float x = st[u][e] * scale + bm[u][e];
              p = exp2f(fmaf(x, kLog2e, -lse_s[i]));
              ds = p * (dpt[u][e] - delta_s[i]);
              if (!sums_smem) {
                float* at = partial_w + i * N + j;  // this thread's alone in the launch
                *at = b == b_first ? ds : *at + ds;
              }
            }
            if (sums_smem) slot[(u * 4 + e) * blockDim.x] += ds;
            st[u][e] = p;
            dpt[u][e] = ds;
          }
        pair_times_tile(st, ts1, ld, 16 * gi, Dp, acc0);   // dv += p^T do
        pair_times_tile(dpt, ts0, ld, 16 * gi, Dp, acc1);  // dk += ds^T q
      }
      if (tt == tiles_n - 1) {
        store_acc_rows(dv + b * sdv.b + h * sdv.h, sdv.n, m0, N, D, 1.f, acc0);
        store_acc_rows(dk + b * sdk.b + h * sdk.h, sdk.n, m0, N, D, scale, acc1);
      }
    }
  }

  if (!sums_smem) return;
  for (int round = 0; round < rounds; ++round) {
    const int m0 = (warp + round * warps) * 16;
    if (m0 >= N) break;
    for (int qg = 0; qg < row_tiles; ++qg) {
      const float* slot =
          sums + static_cast<size_t>((round * row_tiles + qg) * 8) * blockDim.x + threadIdx.x;
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = qg * 16 + 8 * u + 2 * t + (e & 1);
          const int j = m0 + (lane >> 2) + (e < 2 ? 0 : 8);
          if (i < N && j < N) partial_w[i * N + j] = slot[(u * 4 + e) * blockDim.x];
        }
    }
  }
}

// The streaming kernels are compiled for head dims up to 32, 64 and 128, and
// in f32 also 40 (D = 36 and the like: the 64 build's registers spill there):
// 14 kernels, each reading a bias and a mask (the wrapper stands a zero one
// in for an operand a call lacks)
template <typename T>
auto fwd_stream_kernel(int D) {
  auto kernel = D <= 32   ? wa_fwd_stream_kernel<T, 32>
                : D <= 64 ? wa_fwd_stream_kernel<T, 64>
                          : wa_fwd_stream_kernel<T, 128>;
  if constexpr (sizeof(T) == 4)
    if (D > 32 && D <= 40) kernel = wa_fwd_stream_kernel<T, 40>;
  return kernel;
}

template <typename T>
auto bwd_stream_kernel(int D) {
  auto kernel = D <= 32   ? wa_bwd_stream_kernel<T, 32>
                : D <= 64 ? wa_bwd_stream_kernel<T, 64>
                          : wa_bwd_stream_kernel<T, 128>;
  if constexpr (sizeof(T) == 4)
    if (D > 32 && D <= 40) kernel = wa_bwd_stream_kernel<T, 40>;
  return kernel;
}

bool stream_fits(int N, int D) { return N >= 1 && D >= 1 && D <= 128; }

int windows_per_chunk(int bnw, int H, int target_blocks = kBwdTargetBlocks) {
  const int chunks = max(1, min(bnw, (target_blocks + H - 1) / H));
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

// A persistent forward (wa_fwd_mma_kernel, wa_fwd_tf32x3_kernel) on `chunks`
// chunks of windows, as its chunks query gave them; -1 where the chunks or
// the shared memory do not fit.
template <typename T, typename K, typename... Extra>
int launch_fwd_chunked(K kernel, int threads, size_t smem, const void* q, const void* k,
                       const void* v, const float* bias, const float* mask, void* out,
                       const Strides* s, int bnw, int H, int N, int D, int nW, int chunks,
                       float scale, cudaStream_t stream, Extra... extra) {
  const int wpc = (bnw + chunks - 1) / chunks;
  if (chunks < 1 || chunks != (bnw + wpc - 1) / wpc || smem > kMaxDynamicSmem) return -1;
  kernel<<<chunks * H, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias, mask,
      static_cast<T*>(out), s[0], s[1], s[2], s[3], bnw, H, N, D, nW, wpc, scale, extra...);
  return static_cast<int>(cudaGetLastError());
}

// A chunked backward (wa_bwd_mma_kernel, wa_bwd_tf32x3_kernel) and the
// dbias reduction over its chunk partials, likewise.
template <typename T, typename K, typename... Extra>
int launch_bwd_chunked(K kernel, int threads, size_t smem, const void* q, const void* k,
                       const void* v, const void* dout, const float* bias, const float* mask,
                       void* dq, void* dk, void* dv, float* partial, float* dbias,
                       const Strides* s, int bnw, int H, int N, int D, int nW, int chunks,
                       float scale, cudaStream_t stream, Extra... extra) {
  const int wpc = (bnw + chunks - 1) / chunks;
  if (chunks < 1 || chunks != (bnw + wpc - 1) / wpc || smem > kMaxDynamicSmem) return -1;
  kernel<<<chunks * H, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), bias, mask, static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), partial, s[0], s[1], s[2], s[3], s[4], s[5], s[6], bnw, H, N, D,
      nW, wpc, scale, extra...);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || dbias == nullptr) return static_cast<int>(err);  // no bias, no dbias
  const int64_t hnn = static_cast<int64_t>(H) * N * N;
  const int blocks = static_cast<int>((hnn + kReduceThreads - 1) / kReduceThreads);
  dbias_reduce_kernel<<<blocks, kReduceThreads, 0, stream>>>(partial, dbias, chunks, hnn);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of a tensor-core kernel the card holds at once (SMs times resident
// blocks per SM), or -1 when the kernel cannot run. It also lets the kernel
// take all the shared memory a block may have on the current device, which
// its launches rely on.
template <typename K>
int resident_blocks(K kernel, int threads, size_t smem) {
  if (smem > kMaxDynamicSmem) return -1;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxDynamicSmem) != cudaSuccess)
    return -1;
  int device = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
          cudaSuccess)
    return -1;
  return sms * max(1, per_sm);
}

// Chunks of windows for the bf16 backward: about one wave (chunks times H
// rounded up to the resident blocks), or fewer when there are fewer windows.
template <typename K>
int rounded_wave_chunks(K kernel, int threads, size_t smem, int bnw, int H) {
  const int blocks = resident_blocks(kernel, threads, smem);
  if (blocks < 1) return -1;
  const int wpc = windows_per_chunk(bnw, H, blocks);
  return (bnw + wpc - 1) / wpc;
}

// Chunks of windows for the forwards and the split-TF32 backward: chunks
// times H at most the resident blocks, so the grid is one wave. Rounding up
// as the bf16 backward does puts a few blocks in a second wave where H does
// not divide the resident blocks (H = 24 and 48 at N = 144 with one block
// per SM; H = 48 at N = 49 with two), and the second wave costs as long as
// the first.
template <typename K>
int one_wave_chunks(K kernel, int threads, size_t smem, int bnw, int H) {
  const int blocks = resident_blocks(kernel, threads, smem);
  if (blocks < 1) return -1;
  const int chunks = max(1, min(bnw, blocks / H));
  const int wpc = (bnw + chunks - 1) / chunks;
  return (bnw + wpc - 1) / wpc;
}

// The split-TF32 kernels for a shape: compiled for D = 32 (every Swin
// variant; its address arithmetic folds into constants) and, for the N > 64
// forward, D = 64 (whose q fragments and output then fit its registers), or
// for any D % 8 == 0 read at run time. fwd_tf32_fits and
// bwd_tf32_fits hold the route limits (kTf32MaxD, kTf32BwdSmallMaxD,
// kTf32BwdLargeMaxD) and the shared-memory fit.
size_t fwd_tf32_smem(int N, int D) {
  return N > 64 ? fwd_tf32_large_smem_bytes(N, D, fwd_tf32_large_kv_stages(N, D))
                : fwd_tf32_smem_bytes(N, D);
}

bool fwd_tf32_fits(int N, int D) {
  return N >= 1 && N <= kMmaMaxN && D >= 8 && D % 8 == 0 && D <= kTf32MaxD &&
         (N > 64 ? fwd_tf32_large_kv_stages(N, D) > 0
                 : fwd_tf32_smem_bytes(N, D) <= kMaxDynamicSmem);
}

auto fwd_tf32_small_kernel(int D) {
  return D == 32 ? wa_fwd_tf32x3_kernel<32> : wa_fwd_tf32x3_kernel<0>;
}

auto fwd_tf32_large_kernel(int D) {
  return D == 32   ? wa_fwd_tf32x3_large_kernel<32>
         : D == 64 ? wa_fwd_tf32x3_large_kernel<64>
                   : wa_fwd_tf32x3_large_kernel<0>;
}

// The chunks query's kernel (its occupancy is what matters there)
int fwd_tf32_chunks(int N, int D, int bnw, int H) {
  return N <= 64 ? one_wave_chunks(fwd_tf32_small_kernel(D), 128, fwd_tf32_smem(N, D), bnw, H)
                 : one_wave_chunks(fwd_tf32_large_kernel(D), 2 * kMmaMaxN, fwd_tf32_smem(N, D),
                                   bnw, H);
}

size_t bwd_tf32_smem(int N, int D) {
  return N <= kTf32BwdSmallN
             ? bwd_tf32_smem_bytes(N, D)
             : bwd_tf32_large_smem_bytes(N, D, bwd_tf32_large_kv_stages(N, D));
}

bool bwd_tf32_fits(int N, int D) {
  if (N < 1 || N > kMmaMaxN || D < 8 || D % 8 != 0) return false;
  if (N <= kTf32BwdSmallN)
    return D <= kTf32BwdSmallMaxD && bwd_tf32_smem_bytes(N, D) <= kMaxDynamicSmem;
  return D <= kTf32BwdLargeMaxD && bwd_tf32_large_kv_stages(N, D) > 0;
}

auto bwd_tf32_small_kernel(int D) {
  return D == 32 ? wa_bwd_tf32x3_kernel<kTf32BwdSmallN, 32>
                 : wa_bwd_tf32x3_kernel<kTf32BwdSmallN, 0>;
}

auto bwd_tf32_large_kernel(int D) {
  return D == 32 ? wa_bwd_tf32x3_large_kernel<32> : wa_bwd_tf32x3_large_kernel<0>;
}

int bwd_tf32_chunks(int N, int D, int bnw, int H) {
  return N <= kTf32BwdSmallN
             ? one_wave_chunks(bwd_tf32_small_kernel(D), 2 * kTf32BwdSmallN, bwd_tf32_smem(N, D),
                               bnw, H)
             : one_wave_chunks(bwd_tf32_large_kernel(D), 2 * kMmaMaxN, bwd_tf32_smem(N, D), bnw,
                               H);
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

// The tensor-core forwards: bf16 (_mma) with D % 16 == 0, fp32 in split
// TF32 (_tf32x3) with D % 8 == 0; N <= 144, 16-byte aligned bases and
// strides of q, k, v that are multiples of 16 bytes, and two sets of tiles
// with the head's bias within a block's shared memory (fwd_mma_smem_bytes,
// fwd_tf32_smem_bytes), else -1. chunks: the _chunks query of the same
// name, called on the device before its first launch there. lse: as for
// _tf32x3 below (the _mma forward writes it at N > 64 only, and refuses it
// below). strides: q, k, v, out (12 values).
int window_attention_fwd_mma_chunks(int bnw, int H, int N, int D) {
  if (N < 1 || N > kMmaMaxN || D < 16 || D % 16 != 0) return -1;
  const size_t smem = fwd_mma_smem_bytes(N, D);
  if (N <= 64) return one_wave_chunks(wa_fwd_mma_kernel<64, false>, 128, smem, bnw, H);
  // both N = 144 builds (with and without lse) get their shared-memory limit here
  return min(one_wave_chunks(wa_fwd_mma_kernel<144, false>, 288, smem, bnw, H),
             one_wave_chunks(wa_fwd_mma_kernel<144, true>, 288, smem, bnw, H));
}

int window_attention_fwd_mma(const void* q, const void* k, const void* v, const void* bias,
                             const void* mask, void* out, void* lse, int bnw, int H, int N, int D,
                             int nW, int chunks, float scale, const long long* strides,
                             void* stream) {
  if (N < 1 || N > kMmaMaxN || D < 16 || D % 16 != 0) return -1;
  if (N <= 64 && lse != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  // lse only where asked, in its own build, and not at N <= 64, where no
  // backward reads it: computing it cost that forward 11% (phase 2, the
  // Swin-L rows)
  auto kernel = N <= 64 ? wa_fwd_mma_kernel<64, false>
                        : lse != nullptr ? wa_fwd_mma_kernel<144, true>
                                         : wa_fwd_mma_kernel<144, false>;
  return launch_fwd_chunked<bf16>(kernel, N <= 64 ? 128 : 288, fwd_mma_smem_bytes(N, D), q, k, v,
                                  static_cast<const float*>(bias), static_cast<const float*>(mask),
                                  out, reinterpret_cast<const Strides*>(strides), bnw, H, N, D,
                                  nW, chunks, scale, static_cast<cudaStream_t>(stream),
                                  static_cast<float*>(lse));
}

int window_attention_fwd_tf32x3_chunks(int bnw, int H, int N, int D) {
  if (!fwd_tf32_fits(N, D)) return -1;
  return fwd_tf32_chunks(N, D, bnw, H);
}

// lse: float [bnw, H, N], the rows' log2-sum-exp2 (what the window-12 and
// streaming backwards read), or null where no such backward follows.
int window_attention_fwd_tf32x3(const void* q, const void* k, const void* v, const void* bias,
                                const void* mask, void* out, void* lse, int bnw, int H, int N,
                                int D, int nW, int chunks, float scale, const long long* strides,
                                void* stream) {
  if (!fwd_tf32_fits(N, D)) return -1;
  const Strides* s = reinterpret_cast<const Strides*>(strides);
  const float* bp = static_cast<const float*>(bias);
  const float* mp = static_cast<const float*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 64)
    return launch_fwd_chunked<float>(fwd_tf32_small_kernel(D), 128, fwd_tf32_smem(N, D), q, k, v,
                                     bp, mp, out, s, bnw, H, N, D, nW, chunks, scale, st,
                                     static_cast<float*>(lse));
  return launch_fwd_chunked<float>(fwd_tf32_large_kernel(D), 2 * kMmaMaxN, fwd_tf32_smem(N, D),
                                   q, k, v, bp, mp, out, s, bnw, H, N, D, nW, chunks, scale, st,
                                   static_cast<float*>(lse));
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

// The tensor-core backwards: bf16 (_mma) with N <= 144 and D % 16 == 0,
// fp32 in split TF32 (_tf32x3) with D % 8 == 0 within its limits
// (bwd_tf32_fits); every base address a multiple of 16 bytes and every
// stride of q, k, v, do a multiple of 16 bytes (the wrapper checks), and the
// tiles within a block's shared memory (mma_smem_bytes, bwd_tf32_smem), else
// -1. chunks: the _chunks query of the same name, called on the device
// before its first launch there; scratch: chunks * H * N * N floats.
int window_attention_bwd_mma_chunks(int bnw, int H, int N, int D) {
  if (N < 1 || N > kMmaMaxN || D < 16 || D % 16 != 0) return -1;
  const size_t smem = mma_smem_bytes(N, D);
  return N <= 64 ? rounded_wave_chunks(wa_bwd_mma_kernel<64>, 128, smem, bnw, H)
                 : rounded_wave_chunks(wa_bwd_mma_kernel<144>, 288, smem, bnw, H);
}

int window_attention_bwd_mma(const void* q, const void* k, const void* v, const void* dout,
                             const void* bias, const void* mask, void* dq, void* dk, void* dv,
                             void* partial, void* dbias, int bnw, int H, int N, int D, int nW,
                             int chunks, float scale, const long long* strides, void* stream) {
  if (N < 1 || N > kMmaMaxN || D < 16 || D % 16 != 0) return -1;
  using bf16 = __nv_bfloat16;
  auto kernel = N <= 64 ? wa_bwd_mma_kernel<64> : wa_bwd_mma_kernel<144>;
  return launch_bwd_chunked<bf16>(
      kernel, N <= 64 ? 128 : 288, mma_smem_bytes(N, D), q, k, v, dout,
      static_cast<const float*>(bias), static_cast<const float*>(mask), dq, dk, dv,
      static_cast<float*>(partial), static_cast<float*>(dbias),
      reinterpret_cast<const Strides*>(strides), bnw, H, N, D, nW, chunks, scale,
      static_cast<cudaStream_t>(stream));
}

int window_attention_bwd_tf32x3_chunks(int bnw, int H, int N, int D) {
  if (!bwd_tf32_fits(N, D)) return -1;
  return bwd_tf32_chunks(N, D, bnw, H);
}

// The split-TF32 backward also takes the forward's output and lse (fwd_tf32x3
// with lse); at N <= 64 it reads neither (they may be null). strides: q, k,
// v, do, dq, dk, dv, out (24 values).
int window_attention_bwd_tf32x3(const void* q, const void* k, const void* v, const void* dout,
                                const void* bias, const void* mask, const void* out,
                                const void* lse, void* dq, void* dk, void* dv, void* partial,
                                void* dbias, int bnw, int H, int N, int D, int nW, int chunks,
                                float scale, const long long* strides, void* stream) {
  if (!bwd_tf32_fits(N, D)) return -1;
  const Strides* s = reinterpret_cast<const Strides*>(strides);
  const float* bp = static_cast<const float*>(bias);
  const float* mp = static_cast<const float*>(mask);
  float* pp = static_cast<float*>(partial);
  float* dbp = static_cast<float*>(dbias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= kTf32BwdSmallN)
    return launch_bwd_chunked<float>(bwd_tf32_small_kernel(D), 2 * kTf32BwdSmallN,
                                     bwd_tf32_smem(N, D), q, k, v, dout, bp, mp, dq, dk, dv, pp,
                                     dbp, s, bnw, H, N, D, nW, chunks, scale, st);
  if (out == nullptr || lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bwd_chunked<float>(bwd_tf32_large_kernel(D), 2 * kMmaMaxN, bwd_tf32_smem(N, D), q,
                                   k, v, dout, bp, mp, dq, dk, dv, pp, dbp, s, bnw, H, N, D, nW,
                                   chunks, scale, st, static_cast<const float*>(out),
                                   static_cast<const float*>(lse), s[7]);
}

// The streaming kernels: float32 (dtype 0) or bfloat16 (1) q, k, v with 1 <=
// D <= 128 at any N >= 1, through any strides (vec: every base address and
// window, head and token stride of q, k, v (and do) a multiple of 16 bytes,
// and D of one 16-byte piece, so the tiles arrive by cp.async; else element
// by element), else -1. bias and mask are both given (the wrapper stands a
// zero one in for an operand the call lacks), else -1. chunks: the _chunks
// query of the same name, called on the device before its first launch
// there. The forward writes each row's lse where lse is not null; the
// backward reads the forward's out and lse (neither may be null). strides:
// q, k, v, out (12 values) forward; q, k, v, do, dq, dk, dv, out (24
// values) backward; scratch: chunks * H * N * N floats.
int window_attention_fwd_stream_chunks(int bnw, int H, int N, int D, int dtype) {
  if (!stream_fits(N, D)) return -1;
  const int threads = 32 * stream_warps(N, D);
  if (dtype == 0)
    return one_wave_chunks(fwd_stream_kernel<float>(D), threads, fwd_stream_smem<float>(D), bnw,
                           H);
  if (dtype == 1)
    return one_wave_chunks(fwd_stream_kernel<__nv_bfloat16>(D), threads,
                           fwd_stream_smem<__nv_bfloat16>(D), bnw, H);
  return -1;
}

int window_attention_fwd_stream(const void* q, const void* k, const void* v, const void* bias,
                                const void* mask, void* out, void* lse, int dtype, int bnw, int H,
                                int N, int D, int nW, int chunks, float scale,
                                const long long* strides, int vec, void* stream) {
  if (!stream_fits(N, D) || bias == nullptr || mask == nullptr) return -1;
  const Strides* s = reinterpret_cast<const Strides*>(strides);
  const float* bp = static_cast<const float*>(bias);
  const float* mp = static_cast<const float*>(mask);
  float* lp = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 32 * stream_warps(N, D);
  if (dtype == 0)
    return launch_fwd_chunked<float>(fwd_stream_kernel<float>(D), threads,
                                     fwd_stream_smem<float>(D), q, k, v, bp, mp, out, s, bnw, H,
                                     N, D, nW, chunks, scale, st, lp, vec);
  if (dtype == 1)
    return launch_fwd_chunked<__nv_bfloat16>(fwd_stream_kernel<__nv_bfloat16>(D), threads,
                                             fwd_stream_smem<__nv_bfloat16>(D), q, k, v, bp, mp,
                                             out, s, bnw, H, N, D, nW, chunks, scale, st, lp, vec);
  return static_cast<int>(cudaErrorInvalidValue);
}

int window_attention_bwd_stream_chunks(int bnw, int H, int N, int D, int dtype) {
  if (!stream_fits(N, D)) return -1;
  const int threads = 32 * stream_warps(N, D);
  if (dtype == 0)
    return one_wave_chunks(bwd_stream_kernel<float>(D), threads,
                           bwd_stream_smem<float>(N, D), bnw, H);
  if (dtype == 1)
    return one_wave_chunks(bwd_stream_kernel<__nv_bfloat16>(D), threads,
                           bwd_stream_smem<__nv_bfloat16>(N, D), bnw, H);
  return -1;
}

int window_attention_bwd_stream(const void* q, const void* k, const void* v, const void* dout,
                                const void* bias, const void* mask, const void* out,
                                const void* lse, void* dq, void* dk, void* dv, void* partial,
                                void* dbias, int dtype, int bnw, int H, int N, int D, int nW,
                                int chunks, float scale, const long long* strides, int vec,
                                void* stream) {
  if (!stream_fits(N, D) || bias == nullptr || mask == nullptr) return -1;
  if (out == nullptr || lse == nullptr || partial == nullptr || dbias == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides* s = reinterpret_cast<const Strides*>(strides);
  const float* bp = static_cast<const float*>(bias);
  const float* mp = static_cast<const float*>(mask);
  const float* lp = static_cast<const float*>(lse);
  float* pp = static_cast<float*>(partial);
  float* dbp = static_cast<float*>(dbias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 32 * stream_warps(N, D);
  if (dtype == 0)
    return launch_bwd_chunked<float>(
        bwd_stream_kernel<float>(D), threads, bwd_stream_smem<float>(N, D), q, k, v,
        dout, bp, mp, dq, dk, dv, pp, dbp, s, bnw, H, N, D, nW, chunks, scale, st,
        static_cast<const float*>(out), lp, s[7], vec);
  if (dtype == 1)
    return launch_bwd_chunked<__nv_bfloat16>(
        bwd_stream_kernel<__nv_bfloat16>(D), threads,
        bwd_stream_smem<__nv_bfloat16>(N, D), q, k, v, dout, bp, mp, dq, dk, dv, pp,
        dbp, s, bnw, H, N, D, nW, chunks, scale, st, static_cast<const __nv_bfloat16*>(out), lp,
        s[7], vec);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
