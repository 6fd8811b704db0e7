// Global attention forward and backward for Hopper (sm_90a): softmax(q k^T
// scale + bias[h]) v over whole sequences, bf16 in and out with fp32
// accumulators, or fp32 in and out in split TF32 (the fp32 form, below), the
// bias (if any) an fp32 [H, T, S] shared by every batch row, and in the
// backward its gradient summed over the batch. Built
// by iseg_tpu_torch/ops/kernels/_build.py with nvcc into a shared library
// with a plain C interface, loaded with ctypes.
//
// Replaces no Pallas kernel: global attention is XLA's in the JAX package
// (jax.nn.dot_product_attention, iseg_tpu/nn/attention.py:58; the ViT block
// at iseg_tpu/backbones/vit.py:43, EVA's at iseg_tpu/backbones/eva.py:126).
// MOAT's relative-position bias is an einsum plus a gathered table there
// (iseg_tpu/backbones/moat.py:69-88). On the card this pair succeeds, for
// bf16 global attention that records a gradient without a mask and with a
// bias that does not vary with the batch row or none (the ViT-L, EVA02-L and
// MOAT train steps, MOAT's with its bias), the window-attention kernels'
// streaming pair
// (window_attention.cu, wa_fwd_stream_kernel / wa_bwd_stream_kernel with one
// window per batch row), whose backward was the port's first fixed-order
// one. This pair keeps that property: no output element is written by two
// blocks, no atomics, every sum runs in one order, so two runs are equal
// bit for bit (cuDNN's and FlashAttention's backwards add dq in no fixed
// order).
//
// Per (batch row b, head h), with q [T, D], k, v [S, D] and bias [T, S]
// (zero without one):
//   x   = (q k^T + bias / scale) scale log2(e)   (the logits in log2 units)
//   p   = exp2(x - max);  out = p v / rowsum(p);  lse = log2 rowsum exp2(x)
// and, given do:
//   delta = rowsum(do * out)
//   p     = exp2(x - lse);  ds = p (do v^T - delta)
//   dv = p^T do;  dk = ds^T q scale;  dq = ds k scale;  dbias[h] = sum_b ds
//
// What bounds it on the H100: the products. At ViT-L's [8, 16, 1025, 64]
// the forward does two T x S x D products a (b, h), 34.4 GFLOP against 8.4
// MB moved (about 4,100 flop per byte, far above the tensor cores' 295), and
// the backward five (85.9 GFLOP against 14.7 MB): 0.0348 ms and 0.0870 ms at
// 989 TFLOP/s (chip_smoke.py's wa_bound for these shapes). The streaming
// pair it replaces ran one block per (batch row, head): 128 blocks on 132
// SMs, each walking all 1025 rows with at most 9 warps, so most of the
// card's warp slots stayed empty and each block's chain of products was
// latency bound. This design puts the parallelism in the tiles:
//
// * ga_fwd_kernel: one block of 4 warps per (query tile, b h),
//   FlashAttention-2's forward. A warp owns 16 query rows (32 at D <= 32,
//   two m-tiles sharing each k and v fragment) and holds them in registers
//   as mma.sync m16n8k16 A fragments; the block streams k and v through
//   shared memory 64 keys at a time (128 at D <= 32) in a two-stage ring
//   (cp.async, zero fill past S and past D; one block barrier a tile), forms
//   s = q k^T, keeps an online softmax in fp32 registers in exp2 units (keys
//   past S masked to -inf; the row maxima of the raw logits, scaled once, so
//   p is one fused multiply-add and one ex2.approx a logit; a row's
//   reference max moves only where the tile's exceeds it by more than 8 in
//   log2 units, so most tiles rescale nothing) and adds p v with p taken
//   straight from the accumulators, rounded to bf16 as the A operand. A last
//   tile of no more than half its keys (ViT-L's 1025th) takes a step over
//   half of them. It writes out and each row's lse (log2 units). ViT-L: 17 x
//   128 = 2,176 blocks of 64 rows, four an SM, where the streaming pair had
//   128.
// * ga_bwd_delta_kernel: delta = rowsum(do * out) in fp32 from the bf16 out
//   the forward wrote (8 lanes a row). Out is rounded to bf16 (2^-9), which
//   moves delta by about 2^-9 of |do| |out|; ds = p (dp - delta) then moves
//   by p times that, which stays far inside the bf16 tolerance of 1e-2 of
//   max |plain| (the streaming kernels formed rowsum(p dp) instead only
//   because their dbias is held to 1e-3, and this pair has no bias).
// * ga_bwd_dkdv_kernel: one block of 4 warps per (64-key tile, b h); a
//   warp holds its 16 keys' k and v as A fragments, walks every 64-row query
//   tile in order (q, do, lse and delta through a two-stage ring), recomputes
//   s^T = k q^T and dp^T = v do^T, p^T from lse and ds^T, and accumulates dv
//   += p^T do and dk += ds^T q in registers; it writes each once.
// * ga_bwd_dq_kernel: one block of 4 warps per (64-row query tile, b h); a
//   warp holds its rows' q and do, walks every 64-key tile in order,
//   recomputes s and dp, and accumulates dq += ds k; it writes once.
//   Both backward kernels are compiled for three resident blocks an SM at D
//   <= 64 (at most 168 registers a thread).
//
// The bias form (each kernel built with kBias; the bias-free build keeps its
// code). What it adds is bytes: MOAT-4's stage-2 bias [32, 1024, 1024] is 128
// MiB, 8x q, k, v and out together, so the forward becomes bound by reading
// it (0.045 ms at 3.35 TB/s) and the backward by reading it in each pass
// and writing dbias. Measured on an H100 80GB HBM3 at 700 W at that shape
// (PERF.md section 6, rows 3*b / 4*b): the forward 0.096 ms of device time
// (SDPA with the bias 0.153), the backward 0.461 (0.769; dq 0.199, dbias
// 0.140, dk / dv 0.114), against the streaming pair's 0.50 and 1.60. Its
// answers:
// * The bias enters as s + bias / scale before the (unchanged) row maxima,
//   so the maximum is taken over the biased logits and p stays one fused
//   multiply-add and one ex2 a logit; the slack trick holds as it was. The
//   bias must be finite (a row whose tile is all -inf would give NaN).
// * It is read as a tile of the block's 64 query rows by the step's 64 keys,
//   through the cp.async ring beside k and v (18 KB a stage), zero-filled
//   past T and S (a padded key's logit still ends at -inf or at p = 0). The
//   forward takes one m-tile a warp and 64-key tiles at every D (two m-tiles
//   and 128 keys at D <= 32 would make a stage 64 KB), three blocks an SM at
//   D <= 64. Rows read along the keys (forward, dq, dbias) have a pitch of
//   72 floats, so a half warp's float2 reads hit 32 distinct banks; dk / dv
//   read s^T down the columns, one float at a time, at a pitch of 68.
// * The grid runs (b, tile, h) with b fastest, so the B blocks that read
//   one bias tile run side by side and it comes from HBM about once.
// * dbias (ga_bwd_dbias_kernel, launched only when the bias records a
//   gradient): one block of 4 warps per (64-row query tile, 64-key tile, h)
//   holds its 64 x 64 tile of sums in registers and walks the batch rows in
//   increasing order (q, do, k, v, lse and delta of each through a two-stage
//   ring), recomputing s and dp for its tile: dbias[h] = ds_0 + ds_1 + ...,
//   written once, no atomics, no partials in device memory. It costs two
//   products a batch row (the dq pass's own) against the 2 B + 1 passes of
//   [B, H, T, S] fp32 partials and their reduction (256 MiB written and
//   read again at MOAT's batch 2). ds is the logit's gradient: dbias is not
//   scaled like dk and dq.
// * delta = rowsum(p dp), formed by a first walk of the dq kernel over the
//   key tiles (two products a tile more), which then runs first: rowsum(do
//   out) from the bf16 out moved ds by p times about 2^-9 |do| |out|, and
//   dbias, held to 1e-3 of max(1, max |plain|), missed it (2.02e-3 against
//   1.82e-3 at a [2, 70, 2, 64] call with 200 keys on the H100).
//
// The fp32 form (each kernel built with E = float; the bf16 builds keep their
// code): fp32 q, k, v, out and gradients at fp32's precision, for the fp32
// train steps (mixed precision off: ViT-L, EVA02-L, MOAT with its bias),
// which the streaming pair took before, with its occupancy failure (B H
// blocks each walking every row). Every product, p v and the backward's
// five included, is split TF32 on mma.sync m16n8k8 (window_attention.cu's
// tf32x3 kernels' Split and mma_3xtf32, copied): each operand x = hi + lo,
// hi = tf32(x), lo the TF32 truncation of x - hi, and a b = lo hi + hi lo + hi
// hi in fp32 accumulators; p and ds, not exact in TF32, are split too. Its
// answers:
// * The work's shape is the bf16 pair's (the blocks, the ring, the online
//   softmax in exp2 units with the slack of 8), with one 16-row m-tile a
//   warp and 64-key tiles at every D. q stays in registers as raw fp32
//   fragments (32 registers at D = 64) and is split at each product, once a
//   head-dim step for all of a tile's keys; k and v arrive raw in the fp32
//   ring (rows of D + 4 floats: the fragment loads hit 32 distinct banks)
//   and each value is split where a warp loads it (a split once a tile in
//   shared memory would double the ring: 64 KB a stage at D = 64).
// * Registers: the backward's held side (k and v, or q and do) is twice
//   the bf16 fragments, so it takes half the columns of a streamed tile at
//   once (32, 16 at D = 128) and two blocks an SM at D = 64 (dk / dv's k, v
//   and accumulators take 128 registers a thread), three at D <= 32; the
//   forward four / three / one blocks at D <= 32 / 64 / 128 (three / two
//   with the bias).
// * delta = rowsum(do out) from the fp32 out, with the bias too: the bf16
//   form's extra key walk was needed only for a bf16-rounded out, so the
//   fp32 bias form's backward runs delta, dk / dv, dq, dbias. Its dbias
//   kernel's ring (four fp32 tiles a stage) fits a block up to D = 64,
//   which is the fp32 bias form's widest head dim (MOAT's is 32).
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 2 and --ab;
// PERF.md section 6, rows 3*f / 4*f): at ViT-L's [8, 16, 1025, 64] the
// forward 0.70 ms of device time (SDPA in fp32 1.17, the streaming pair
// 1.67-1.71), the backward 2.50-2.55 (SDPA 2.90, the streaming pair
// 5.86-5.98), 3.4x / 4.9x the split-TF32 bound; 255 registers at D = 64 in
// the backward (two blocks an SM: dk / dv spills 20 bytes). Every warp
// splits each streamed value it loads (four instructions a value); how much
// of the time that takes is not measured.
//
// The split backward recomputes s and dp in both passes (seven products
// where a backward with atomics has five) in exchange for the fixed order.
// Measured on an H100 80GB HBM3 at 700 W at ViT-L's shape (chip_smoke.py
// phase 2; PERF.md section 6): the forward about 0.17-0.18 ms of device time
// (5x its bound; SDPA 0.12), the backward about 0.52 ms (6x its bound; SDPA's
// deterministic backward 0.62-0.64), against the streaming pair's 0.61 and
// 2.03. What is left is each warp's chain a tile: the products on mma.sync,
// the softmax's ALU work and its exponentials (at D = 64 the special-function
// unit's 16 a clock an SM take about as long as the products), with 12-16
// warps an SM to hide it; tools/ablate_global_attention.py times the layout
// choices below.
// Rounding points are those of the window-attention tensor-core kernels: p
// only as the operand of p v and of dv, ds only as the operand of dq and dk;
// the logits, the softmax, its sums and delta stay fp32.
//
// Padding: rows past T and keys past S are read as zeros (cp.async zero
// fill, or zero fragments; the bias tile likewise). In the forward the
// padded keys' logits become -inf. In the backward a padded query row has zero q, do, lse and delta (so
// its p^T and ds^T columns are finite and meet zero rows of q and do), and a
// padded key's p is set to 0 in the dq pass (its logit is 0, and exp2(-lse)
// may overflow); padded rows and keys are never stored.
//
// The kernels are compiled for head dims up to 32, 64 and 128 (kD; the fp32
// bias form up to 32 and 64); a head dim D that is a multiple of 8 below its
// bucket is zero-padded to kD in registers and shared memory. q, k, v, do
// are read and out, dq, dk, dv written through their element strides in the
// [B, T, H, D] layout (the head dim contiguous, every stride and base
// 16-byte aligned: the wrapper checks), so q, k and v may be views of a
// packed qkv projection. The bias and dbias
// are [H, T, ldb] fp32 with a row stride ldb >= S, a multiple of 4 (16-byte
// rows), the base 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

// The element type of q, k, v, out and the gradients: bf16, or fp32 (the
// split-TF32 form)
template <typename E>
constexpr bool kF32 = std::is_same_v<E, float>;

constexpr int kRows = 64;  // keys (or query rows) of a streamed tile
constexpr float kLog2e = 1.4426950408889634f;

// element strides of a [B, T, H, D] tensor (the head dim has stride 1)
struct Strides {
  long long b, t, h;
};

// Row pitch of a shared tile in elements: kD plus 16 bytes. In bf16 an odd
// multiple of 16 bytes, so the eight rows of an ldmatrix land on distinct
// banks; in fp32 4 mod 8 floats, so the split-TF32 fragment loads (row g,
// column t of a quad, or rows 2t and 2t + 1, column g) hit 32 distinct banks
template <typename E, int kD>
__host__ __device__ constexpr int tile_ld() {
  return kD + 16 / static_cast<int>(sizeof(E));
}

template <typename E, int kD, int kR = kRows>
__host__ __device__ constexpr int tile_elems() {
  return kR * tile_ld<E, kD>();
}

// Every kernel runs blocks of kWarps warps; a warp owns 16 query rows (or
// keys) of the block's tile, a forward warp 16 fwd_mtiles rows. Each kernel's
// tiles of the other side stream through a ring of kStages shared-memory
// stages: one arrives while the block computes another.
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;

// The forward's layout by head dim (tools/ablate_global_attention.py timed
// the alternatives at phase 2's rows): at D <= 64 one 16-row m-tile a warp,
// 64-key tiles and four blocks an SM (at most 128 registers a thread); at D
// <= 32 two m-tiles a warp, which share each k and v fragment, and 128-key
// tiles, which spread each softmax step's fixed work (row maxima by
// shuffles, the output's rescale) over more keys. The bias form takes one
// m-tile and 64 keys at every D and three blocks an SM at D <= 64 (a stage
// holds the 64 x 64 fp32 bias tile too). The fp32 form takes one m-tile and
// 64 keys at every D (its q fragments are twice as wide), and as many blocks
// an SM as its fp32 ring allows: four (three with the bias) at D <= 32,
// three (two) at D <= 64
template <typename E, int kD, bool kBias>
__host__ __device__ constexpr int fwd_mtiles() {
  return kD <= 32 && !kBias && !kF32<E> ? 2 : 1;
}
template <typename E, int kD, bool kBias>
__host__ __device__ constexpr int fwd_keys() {
  return kD <= 32 && !kBias && !kF32<E> ? 128 : 64;
}
template <typename E, int kD, bool kBias>
__host__ __device__ constexpr int fwd_min_blocks() {
  if constexpr (kF32<E>) return kD <= 32 ? (kBias ? 3 : 4) : kD <= 64 ? (kBias ? 2 : 3) : 1;
  return kBias ? (kD <= 64 ? 3 : 1) : (kD == 64 ? 4 : 1);
}
// Resident blocks an SM the backward kernels are compiled for: in bf16
// three at D <= 64 (at most 168 registers a thread); in fp32 three at D <=
// 32 and two at D <= 64, where the dk / dv kernel's k, v and its two
// accumulators alone take 128 registers a thread
template <typename E, int kD>
__host__ __device__ constexpr int bwd_min_blocks() {
  if constexpr (kF32<E>) return kD <= 32 ? 3 : kD <= 64 ? 2 : 1;
  return kD <= 64 ? 3 : 1;
}
// Whether the dq kernel forms delta = rowsum(p dp) by a first walk over the
// key tiles (and runs first): the bf16 bias form, whose dbias rowsum(do out)
// from the bf16-rounded out would miss. The fp32 form's out is exact enough
// for delta = rowsum(do out) with a bias too
template <typename E, bool kBias>
__host__ __device__ constexpr bool delta_walk() {
  return kBias && !kF32<E>;
}
// ... and the dbias kernel (its ring holds q, do, k and v of a batch row)
template <typename E, int kD>
__host__ __device__ constexpr int dbias_min_blocks() {
  if constexpr (kF32<E>) return kD <= 32 ? 2 : 1;
  return kD <= 32 ? 3 : kD <= 64 ? 2 : 1;
}

// Row pitch (floats) of a shared fp32 bias tile of kRows query rows by kRows
// keys: read along its rows as float2 at (row g, column 2c) (the forward, dq
// and dbias), 72 floats put a half warp's pieces on 32 distinct banks; read
// down its columns one float at a time (dk and dv's s^T), 68 floats do
constexpr int kBiasPitchRows = kRows + 8;
constexpr int kBiasPitchCols = kRows + 4;

// The block's (tile, batch row, head). The bias-free kernels take (tile, b
// h) from (blockIdx.x, blockIdx.y); the bias form (b, tile, h) from (x, y,
// z), so that the B blocks that read one bias tile run next to each other
struct BlockPos {
  int tile, b, h;
};

template <bool kBias>
__device__ __forceinline__ BlockPos block_pos(int H) {
  if constexpr (kBias) {
    return {static_cast<int>(blockIdx.y), static_cast<int>(blockIdx.x),
            static_cast<int>(blockIdx.z)};
  } else {
    const int bh = blockIdx.y, b = bh / H;
    return {static_cast<int>(blockIdx.x), b, bh - b * H};
  }
}

// How far (log2 units) a row's max may grow past the reference the forward
// subtracts before it moves the reference and rescales the row's sums: p
// then stays below 2^8 (finite in fp32 and as a bf16 operand), and most
// steps after the first few rescale nothing. out = o / l and lse = ref +
// log2(l) are the same function at any reference.
constexpr float kRescaleSlack = 8.f;

// Columns of a streamed tile the backward kernels take at once: 64, or 32
// at kD = 128, where the accumulators of a whole tile would spill; in fp32
// half that (its fragments of the held side are twice as wide)
template <typename E, int kD>
__host__ __device__ constexpr int sub_cols() {
  return (kD <= 64 ? 64 : 32) / (kF32<E> ? 2 : 1);
}

// 2^x for the softmax: the special-function unit's approximation (2 ulp,
// subnormal results flushed to 0), as exp2f compiles under fast math
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

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

// c += a b for one 16 x 8 x 16 tile: a row-major bf16, b column-major bf16,
// c fp32 (not volatile: independent products may interleave)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The split-TF32 products of the fp32 form (window_attention.cu's, copied:
// the two sources build apart). x rounded to TF32 (10 stored mantissa bits),
// to nearest, ties away from zero, in two integer instructions; a NaN whose
// mantissa carries into the sign bit comes out a zero, and Split keeps it in
// lo
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
// nearest, and lo = x - hi (exact in fp32) truncated to TF32 by one mask;
// x - hi - lo is under 2^-21 |x|. A NaN x keeps a NaN lo
template <int kN>
struct Split {
  uint32_t hi[kN], lo[kN];
  __device__ __forceinline__ void set(int i, float x) {
    hi[i] = to_tf32(x);
    lo[i] = __float_as_uint(x - __uint_as_float(hi[i])) & 0xFFFFE000u;
  }
};

// c += a b in split TF32 (CUTLASS's 3xTF32): lo hi and hi lo first, then hi
// hi, all into the fp32 accumulators; only lo lo (under 2^-22 of the
// product) is dropped
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const Split<4>& a, const Split<2>& b) {
  mma_tf32(c, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(c, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(c, a.hi, b.hi[0], b.hi[1]);
}

// A warp's 16 rows of an operand as the A fragments of a product over the
// head dim: bf16 pairs of m16n8k16 (a[c] covers columns 16c .. 16c + 15),
// or in fp32 the raw values of m16n8k8 in its natural order (a[c]: columns
// 8c + t and 8c + t + 4 of rows g and g + 8, lane (g, t)), split into their
// TF32 halves where a product takes them
template <typename E, int kD>
using frags_t = std::conditional_t<kF32<E>, float[kD / 8][4], uint32_t[kD / 16][4]>;

// kN accumulator tiles (16 x 8 each, fp32) as the A operand of a product
// over their columns: in bf16 rounded to m16n8k16 fragments (the
// accumulator layout of two neighbouring tiles is the A layout), in fp32 the
// accumulators themselves, split where the product takes them (m16n8k8's
// "paired" order: a lane's slots t and t + 4 are its columns 2t and 2t + 1)
template <typename E, int kN>
using pfrags_t = std::conditional_t<kF32<E>, float[kN][4], uint32_t[kN / 2][4]>;

__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async4_zfill(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
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

// Rows row0 .. row0 + kR - 1 of one (b, h) [N][D] operand into a shared
// [kR][tile_ld] tile by cp.async, 16 bytes a piece, zeros past N and from D
// to kD, by the block's threads (the caller commits)
template <typename E, int kD, int kR = kRows>
__device__ __forceinline__ void copy_tile(const E* base, long long st, int row0, int N, int D,
                                          E* dst) {
  constexpr int kPiece = 16 / sizeof(E), kPieces = kD / kPiece, kLd = tile_ld<E, kD>();
#pragma unroll
  for (int e = threadIdx.x; e < kR * kPieces; e += kThreads) {
    const int row = e / kPieces, col = (e - row * kPieces) * kPiece, r = row0 + row;
    const bool in = r < N && col < D;
    cp_async16_zfill(smem_addr(dst + row * kLd + col), in ? base + r * st + col : base,
                     in ? 16 : 0);
  }
}

// Entries row0 .. row0 + 63 of two fp32 rows (the backward's lse and delta of
// one (b, h)) into shared [kRows] arrays, zeros past N: one of the block's
// 2 kRows threads each
__device__ __forceinline__ void copy_rows_f32(const float* a, const float* b, int row0, int N,
                                              float* dst_a, float* dst_b) {
  static_assert(kThreads == 2 * kRows, "one thread an entry");
  const int x = threadIdx.x & (kRows - 1), r = row0 + x;
  const float* src = threadIdx.x < kRows ? a : b;
  float* dst = threadIdx.x < kRows ? dst_a : dst_b;
  cp_async4_zfill(smem_addr(dst + x), r < N ? src + r : src, r < N ? 4 : 0);
}

// Rows row0 .. row0 + kRows - 1 and keys col0 .. col0 + kRows - 1 of one
// head's [T][ldb] fp32 bias into a shared [kRows][kPitch] tile by cp.async,
// 16 bytes a piece, zeros past T and S, by the block's threads (the caller
// commits)
template <int kPitch>
__device__ __forceinline__ void copy_bias_tile(const float* base, long long ldb, int row0,
                                               int col0, int T, int S, float* dst) {
  constexpr int kPieces = kRows / 4;
#pragma unroll
  for (int e = threadIdx.x; e < kRows * kPieces; e += kThreads) {
    const int row = e / kPieces, col = (e - row * kPieces) * 4, r = row0 + row, c = col0 + col;
    const int bytes = r < T && c < S ? 4 * min(4, S - c) : 0;
    cp_async16_zfill(smem_addr(dst + row * kPitch + col), bytes ? base + r * ldb + c : base,
                     bytes);
  }
}

// s (a warp's 16 rows by 8 kN keys, accumulator layout) += bias times mul:
// bt points at the lane's (row g, key c2) of a [rows][kBiasPitchRows] tile
template <int kN>
__device__ __forceinline__ void add_bias_rows(const float* bt, float mul, float (&s)[kN][4]) {
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    const float2 x = *reinterpret_cast<const float2*>(bt + 8 * n);
    const float2 y = *reinterpret_cast<const float2*>(bt + 8 * kBiasPitchRows + 8 * n);
    s[n][0] = fmaf(x.x, mul, s[n][0]);
    s[n][1] = fmaf(x.y, mul, s[n][1]);
    s[n][2] = fmaf(y.x, mul, s[n][2]);
    s[n][3] = fmaf(y.y, mul, s[n][3]);
  }
}

// s^T (a warp's 16 keys by 8 kN query rows, accumulator layout) += bias
// times mul: bt points at the lane's (query row c2, key g) of a [query
// rows][kBiasPitchCols] tile
template <int kN>
__device__ __forceinline__ void add_bias_cols(const float* bt, float mul, float (&st)[kN][4]) {
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    const float* x = bt + 8 * n * kBiasPitchCols;
    st[n][0] = fmaf(x[0], mul, st[n][0]);
    st[n][1] = fmaf(x[kBiasPitchCols], mul, st[n][1]);
    st[n][2] = fmaf(x[8], mul, st[n][2]);
    st[n][3] = fmaf(x[kBiasPitchCols + 8], mul, st[n][3]);
  }
}

// A warp's 16 rows row0 .. row0 + 15 of a shared [kRows][tile_ld] tile as
// A fragments (bf16 by ldmatrix: lanes 0-15 address the rows' first 8
// columns of each 16, lanes 16-31 the next 8; fp32 one value a load)
template <typename E, int kD>
__device__ __forceinline__ void smem_frags(const E* tile, int row0, frags_t<E, kD>& a) {
  const int lane = threadIdx.x & 31;
  if constexpr (kF32<E>) {
    constexpr int kLd = tile_ld<E, kD>();
    const float* r0 = tile + (row0 + (lane >> 2)) * kLd + (lane & 3);
#pragma unroll
    for (int c = 0; c < kD / 8; ++c) {
      a[c][0] = r0[8 * c];
      a[c][1] = r0[8 * kLd + 8 * c];
      a[c][2] = r0[8 * c + 4];
      a[c][3] = r0[8 * kLd + 8 * c + 4];
    }
  } else {
    const uint32_t base =
        smem_addr(tile + (row0 + (lane & 15)) * tile_ld<E, kD>()) + (lane >> 4) * 16;
#pragma unroll
    for (int c = 0; c < kD / 16; ++c) ldsm_x4(a[c], base + c * 32);
  }
}

// A warp's 16 rows m0 .. m0 + 15 of a [N][D] operand (through its token
// stride) as A fragments in registers, zeros past N and past D
template <typename E, int kD>
__device__ __forceinline__ void load_frags(const E* base, long long st, int m0, int N, int D,
                                           frags_t<E, kD>& a) {
  const int lane = threadIdx.x & 31, r0 = m0 + (lane >> 2), r1 = r0 + 8;
  if constexpr (kF32<E>) {
    const int t = lane & 3;
    auto x = [&](int r, int d) { return r < N && d < D ? base[r * st + d] : 0.f; };
#pragma unroll
    for (int c = 0; c < kD / 8; ++c) {
      const int d = 8 * c + t;
      a[c][0] = x(r0, d);
      a[c][1] = x(r1, d);
      a[c][2] = x(r0, d + 4);
      a[c][3] = x(r1, d + 4);
    }
  } else {
    const int c2 = (lane & 3) * 2;
    auto pair = [&](int r, int d) -> uint32_t {
      return r < N && d < D ? *reinterpret_cast<const uint32_t*>(base + r * st + d) : 0u;
    };
#pragma unroll
    for (int c = 0; c < kD / 16; ++c) {
      const int d = 16 * c + c2;
      a[c][0] = pair(r0, d);
      a[c][1] = pair(r1, d);
      a[c][2] = pair(r0, d + 8);
      a[c][3] = pair(r1, d + 8);
    }
  }
}

// kN accumulator tiles (16 x 8 each, fp32) as the A operand of a product
// over their columns (pfrags_t)
template <typename E, int kN>
__device__ __forceinline__ void acc_to_frags(const float (&x)[kN][4], pfrags_t<E, kN>& a) {
  if constexpr (kF32<E>) {
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[n][e] = x[n][e];
  } else {
#pragma unroll
    for (int s = 0; s < kN / 2; ++s) {
      a[s][0] = bf16x2(x[2 * s][0], x[2 * s][1]);
      a[s][1] = bf16x2(x[2 * s][2], x[2 * s][3]);
      a[s][2] = bf16x2(x[2 * s + 1][0], x[2 * s + 1][1]);
      a[s][3] = bf16x2(x[2 * s + 1][2], x[2 * s + 1][3]);
    }
  }
}

// Rows m0 + g and m0 + g + 8 (those < N), columns < D of a [N][D] output
// (through its token stride), times mul
template <typename E, int kD>
__device__ __forceinline__ void store_acc(E* base, long long st, int m0, int N, int D,
                                          const float (&acc)[kD / 8][4], float mul0, float mul1) {
  const int lane = threadIdx.x & 31, r0 = m0 + (lane >> 2), r1 = r0 + 8, c2 = (lane & 3) * 2;
  auto put = [](E* p, float x0, float x1) {
    if constexpr (kF32<E>) {
      *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
    } else {
      *reinterpret_cast<uint32_t*>(p) = bf16x2(x0, x1);
    }
  };
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    const int d = 8 * j + c2;
    if (d >= D) continue;
    if (r0 < N) put(base + r0 * st + d, acc[j][0] * mul0, acc[j][1] * mul0);
    if (r1 < N) put(base + r1 * st + d, acc[j][2] * mul1, acc[j][3] * mul1);
  }
}

// s[m][n] (16 x 8: m-tile m of the warp's rows by tile rows row0 + 8n ..
// row0 + 8n + 7) = A_m B^T over kD: kM m-tiles of 16 rows as A fragments in
// registers, B a shared tile of rows of tile_ld whose fragments are loaded
// once for all of them. In fp32 each product is split TF32: an A value is
// split once a head-dim step for every n, a B value once
template <typename E, int kD, int kM, int kN>
__device__ __forceinline__ void mtiles_times_tile_t(const frags_t<E, kD> (&a)[kM], const E* tile,
                                                    int row0, float (&s)[kM][kN][4]) {
  constexpr int kLd = tile_ld<E, kD>();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int n = 0; n < kN; ++n) s[m][n][0] = s[m][n][1] = s[m][n][2] = s[m][n][3] = 0.f;
  if constexpr (kF32<E>) {
    const float* b = tile + (row0 + (lane >> 2)) * kLd + (lane & 3);  // (key g, column t)
#pragma unroll
    for (int c = 0; c < kD / 8; ++c) {
      Split<4> sa[kM];
#pragma unroll
      for (int m = 0; m < kM; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) sa[m].set(i, a[m][c][i]);
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        Split<2> sb;
        sb.set(0, b[8 * n * kLd + 8 * c]);
        sb.set(1, b[8 * n * kLd + 8 * c + 4]);
#pragma unroll
        for (int m = 0; m < kM; ++m) mma_3xtf32(s[m][n], sa[m], sb);
      }
    }
  } else {
    const uint32_t base =
        smem_addr(tile + (row0 + (lane & 7) + ((lane >> 4) << 3)) * kLd) + ((lane >> 3) & 1) * 16;
#pragma unroll
    for (int n = 0; n < kN; n += 2)
#pragma unroll
      for (int c = 0; c < kD / 16; ++c) {
        uint32_t b[4];
        ldsm_x4(b, base + n * 8 * kLd * 2 + c * 32);
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          mma_bf16(s[m][n], a[m][c], b[0], b[1]);
          mma_bf16(s[m][n + 1], a[m][c], b[2], b[3]);
        }
      }
  }
}

// acc[m][j] (16 x 8: m-tile m by columns 8j .. 8j + 7) += A_m B: A_m the kN
// accumulator tiles of m-tile m as an operand (pfrags_t; their columns name
// tile rows row0 .. row0 + 8 kN - 1), B those rows of a shared tile (bf16
// through ldmatrix.trans, its fragments loaded once for all kM m-tiles; in
// fp32 split TF32 in the paired order, rows 2t and 2t + 1 of each 8)
template <typename E, int kD, int kM, int kN>
__device__ __forceinline__ void mtiles_times_tile(const pfrags_t<E, kN> (&a)[kM], const E* tile,
                                                  int row0, float (&acc)[kM][kD / 8][4]) {
  constexpr int kLd = tile_ld<E, kD>();
  const int lane = threadIdx.x & 31;
  if constexpr (kF32<E>) {
    const float* b = tile + (row0 + 2 * (lane & 3)) * kLd + (lane >> 2);  // (row 2t, column g)
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      Split<4> sa[kM];
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        sa[m].set(0, a[m][j][0]);
        sa[m].set(1, a[m][j][2]);
        sa[m].set(2, a[m][j][1]);
        sa[m].set(3, a[m][j][3]);
      }
#pragma unroll
      for (int u = 0; u < kD / 8; ++u) {
        Split<2> sb;
        sb.set(0, b[8 * j * kLd + 8 * u]);
        sb.set(1, b[(8 * j + 1) * kLd + 8 * u]);
#pragma unroll
        for (int m = 0; m < kM; ++m) mma_3xtf32(acc[m][u], sa[m], sb);
      }
    }
  } else {
    const uint32_t base =
        smem_addr(tile + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd) + (lane >> 4) * 16;
#pragma unroll
    for (int s = 0; s < kN / 2; ++s)
#pragma unroll
      for (int c = 0; c < kD / 16; ++c) {
        uint32_t b[4];
        ldsm_x4_trans(b, base + 16 * s * kLd * 2 + c * 32);
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          mma_bf16(acc[m][2 * c], a[m][s], b[0], b[1]);
          mma_bf16(acc[m][2 * c + 1], a[m][s], b[2], b[3]);
        }
      }
  }
}

// ------------------------------------------------------------------ forward

// One block per (query tile, b h): kWarps warps of 16 fwd_mtiles rows. k and
// v come through a ring of shared [fwd_keys][tile_ld] tiles (with kBias the
// tile's [kRows][kBiasPitchRows] fp32 bias beside them); per tile a warp
// forms s = q k^T (+ bias / scale) for each of its m-tiles, updates their
// online softmax and adds p v, each k and v fragment loaded once for its
// m-tiles. The scale is positive (the wrapper checks), so the row maxima are
// taken of the unscaled logits and scaled once, and p = exp2(s scale log2(e)
// - max) is one fused multiply-add and one ex2 a logit.
template <typename E, int kD, bool kBias>
__global__ void __launch_bounds__(kThreads, fwd_min_blocks<E, kD, kBias>())
ga_fwd_kernel(const E* __restrict__ q, const E* __restrict__ k,
              const E* __restrict__ v, const float* __restrict__ bias,
              E* __restrict__ out, float* __restrict__ lse, int H, int T, int S, int D,
              long long ldb, float scale_log2, float inv_scale, Strides sq, Strides sk,
              Strides sv, Strides so) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* ring = reinterpret_cast<E*>(smem_raw);  // [kStages][k, v][kRows][tile_ld]
  constexpr int kKeys = fwd_keys<E, kD, kBias>(), kN = kKeys / 8;
  constexpr int kTile = tile_elems<E, kD, kKeys>();
  constexpr int kM = fwd_mtiles<E, kD, kBias>(), kBiasTile = kRows * kBiasPitchRows;
  float* bias_ring = reinterpret_cast<float*>(ring + kStages * 2 * kTile);  // [kStages][kBiasTile]
  const BlockPos pos = block_pos<kBias>(H);
  const int b = pos.b, h = pos.h, bh = b * H + h;
  const int lane = threadIdx.x & 31, c2 = (lane & 3) * 2, warp = threadIdx.x >> 5;
  const int row0 = pos.tile * kWarps * 16 * kM;  // the block's first query row
  const int m0 = row0 + warp * 16 * kM;
  const E* qb = q + b * sq.b + h * sq.h;
  const E* kb = k + b * sk.b + h * sk.h;
  const E* vb = v + b * sv.b + h * sv.h;
  const float* bias_h = kBias ? bias + static_cast<long long>(h) * T * ldb : nullptr;
  const int tiles = (S + kKeys - 1) / kKeys;
  auto load = [&](int t) {  // key tile t into its stage (nothing past the last), one group
    if (t < tiles) {
      E* stage = ring + (t % kStages) * 2 * kTile;
      copy_tile<E, kD, kKeys>(kb, sk.t, t * kKeys, S, D, stage);
      copy_tile<E, kD, kKeys>(vb, sv.t, t * kKeys, S, D, stage + kTile);
      if constexpr (kBias)
        copy_bias_tile<kBiasPitchRows>(bias_h, ldb, row0, t * kKeys, T, S,
                                       bias_ring + (t % kStages) * kBiasTile);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) load(t);
  frags_t<E, kD> qa[kM];
#pragma unroll
  for (int m = 0; m < kM; ++m) load_frags<E, kD>(qb, sq.t, m0 + 16 * m, T, D, qa[m]);

  float o[kM][kD / 8][4];
  float mx[kM][2], l[kM][2];  // rows g, g + 8: reference max (log2 units), this lane's sum
#pragma unroll
  for (int m = 0; m < kM; ++m) {
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) o[m][j][0] = o[m][j][1] = o[m][j][2] = o[m][j][3] = 0.f;
    mx[m][0] = mx[m][1] = -INFINITY;
    l[m][0] = l[m][1] = 0.f;
  }

  // one softmax step over the first 8 kNT keys of tile t (at stage kt, its
  // bias at bt)
  auto step = [&](const E* kt, const float* bt, int t, auto n_tiles) {
    constexpr int kNT = decltype(n_tiles)::value;
    float s[kM][kNT][4];
    mtiles_times_tile_t<E, kD, kM, kNT>(qa, kt, 0, s);
    if constexpr (kBias)
      add_bias_rows<kNT>(bt + (warp * 16 + (lane >> 2)) * kBiasPitchRows + c2, inv_scale, s[0]);
    const bool ragged = t * kKeys + 8 * kNT > S;
    pfrags_t<E, kNT> pa[kM];
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      float tm0 = -INFINITY, tm1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (ragged && t * kKeys + 8 * n + c2 + (e & 1) >= S) s[m][n][e] = -INFINITY;
          if (e < 2) tm0 = fmaxf(tm0, s[m][n][e]);
          else tm1 = fmaxf(tm1, s[m][n][e]);
        }
      // every step holds a key below S (and the bias is finite), so the
      // step's maxima are finite; a
      // row's reference max moves (and its sums are rescaled) only where the
      // step's max exceeds it by more than the slack, and in a warp only
      // when some row's does
      const float top0 = quad_max(tm0) * scale_log2, top1 = quad_max(tm1) * scale_log2;
      const bool grow0 = top0 > mx[m][0] + kRescaleSlack;
      const bool grow1 = top1 > mx[m][1] + kRescaleSlack;
      if (__any_sync(0xffffffffu, grow0 || grow1)) {
        const float new0 = grow0 ? top0 : mx[m][0], new1 = grow1 ? top1 : mx[m][1];
        const float alpha0 = fast_exp2(mx[m][0] - new0), alpha1 = fast_exp2(mx[m][1] - new1);
        mx[m][0] = new0;
        mx[m][1] = new1;
        l[m][0] *= alpha0;
        l[m][1] *= alpha1;
#pragma unroll
        for (int j = 0; j < kD / 8; ++j) {
          o[m][j][0] *= alpha0;
          o[m][j][1] *= alpha0;
          o[m][j][2] *= alpha1;
          o[m][j][3] *= alpha1;
        }
      }
      const float ref0 = mx[m][0], ref1 = mx[m][1];
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        s[m][n][0] = fast_exp2(fmaf(s[m][n][0], scale_log2, -ref0));
        s[m][n][1] = fast_exp2(fmaf(s[m][n][1], scale_log2, -ref0));
        s[m][n][2] = fast_exp2(fmaf(s[m][n][2], scale_log2, -ref1));
        s[m][n][3] = fast_exp2(fmaf(s[m][n][3], scale_log2, -ref1));
        l[m][0] += s[m][n][0] + s[m][n][1];
        l[m][1] += s[m][n][2] + s[m][n][3];
      }
      acc_to_frags<E, kNT>(s[m], pa[m]);
    }
    mtiles_times_tile<E, kD, kM, kNT>(pa, kt + kTile, 0, o);
  };

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t has arrived
    __syncthreads();  // for every thread, and every warp is done with tile t - 1
    load(t + kStages - 1);  // into tile t - 1's stage
    const E* kt = ring + (t % kStages) * 2 * kTile;
    const float* bt = bias_ring + (t % kStages) * kBiasTile;  // read with kBias only
    // a last tile that holds no more than half its keys (ViT-L's 1025th)
    // takes the step over half the keys
    if (S - t * kKeys <= kKeys / 2)
      step(kt, bt, t, std::integral_constant<int, kN / 2>());
    else
      step(kt, bt, t, std::integral_constant<int, kN>());
  }

#pragma unroll
  for (int m = 0; m < kM; ++m) {
    const float l0 = quad_sum(l[m][0]), l1 = quad_sum(l[m][1]);
    const int r0 = m0 + 16 * m + (lane >> 2);
    store_acc<E, kD>(out + b * so.b + h * so.h, so.t, m0 + 16 * m, T, D, o[m], 1.f / l0,
                     1.f / l1);
    if ((lane & 3) == 0) {
      float* row = lse + static_cast<long long>(bh) * T;
      if (r0 < T) row[r0] = mx[m][0] + log2f(l0);
      if (r0 + 8 < T) row[r0 + 8] = mx[m][1] + log2f(l1);
    }
  }
}

// ----------------------------------------------------------------- backward

constexpr int kDeltaThreads = 256;

// delta[b, h, t] = sum_d do[b, t, h, d] out[b, t, h, d]: fp32 products and
// sums of the bf16 (or fp32) values, 8 lanes a row (16 bytes each a step),
// rows in (b, t, h) order, each sum in one fixed order
template <typename E>
__global__ void __launch_bounds__(kDeltaThreads)
ga_bwd_delta_kernel(const E* __restrict__ out, const E* __restrict__ dout,
                    float* __restrict__ delta, int B, int H, int T, int D, Strides so,
                    Strides sd) {
  constexpr int kPiece = 16 / sizeof(E);
  const long long row = (static_cast<long long>(blockIdx.x) * kDeltaThreads + threadIdx.x) >> 3;
  const int sub = threadIdx.x & 7;
  const bool in = row < static_cast<long long>(B) * T * H;
  const int h = static_cast<int>(row % H);
  const long long bt = row / H;
  const int t = static_cast<int>(bt % T), b = static_cast<int>(bt / T);
  float sum = 0.f;
  if (in) {
    const E* o = out + b * so.b + t * so.t + h * so.h;
    const E* g = dout + b * sd.b + t * sd.t + h * sd.h;
    for (int c = sub * kPiece; c < D; c += 8 * kPiece) {
      if constexpr (kF32<E>) {
        const float4 x = *reinterpret_cast<const float4*>(o + c);
        const float4 y = *reinterpret_cast<const float4*>(g + c);
        sum = fmaf(x.x, y.x, sum);
        sum = fmaf(x.y, y.y, sum);
        sum = fmaf(x.z, y.z, sum);
        sum = fmaf(x.w, y.w, sum);
      } else {
        const uint4 x = *reinterpret_cast<const uint4*>(o + c);
        const uint4 y = *reinterpret_cast<const uint4*>(g + c);
        const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
          const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ys[i]));
          sum = fmaf(a.x, d.x, sum);
          sum = fmaf(a.y, d.y, sum);
        }
      }
    }
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  sum += __shfl_xor_sync(0xffffffffu, sum, 4);
  if (in && sub == 0) delta[(static_cast<long long>(b) * H + h) * T + t] = sum;
}

// One block per (64-key tile, b h): kWarps warps of 16 keys, each holding its
// keys' k and v as A fragments. Per query tile (q, do, lse, delta and with
// kBias the [query rows][kBiasPitchCols] bias tile through a two-stage ring),
// in order, kSub columns at a time: s^T = k q^T (+ bias^T / scale), dp^T = v
// do^T, p^T = exp2(s^T scale log2(e) - lse), ds^T = p^T (dp^T - delta), dv +=
// p^T do, dk += ds^T q. dk (times scale) and dv are written once.
template <typename E, int kD, bool kBias>
__global__ void __launch_bounds__(kThreads, bwd_min_blocks<E, kD>())
ga_bwd_dkdv_kernel(const E* __restrict__ q, const E* __restrict__ k,
                   const E* __restrict__ v, const E* __restrict__ dout,
                   const float* __restrict__ bias, const float* __restrict__ lse,
                   const float* __restrict__ delta, E* __restrict__ dk, E* __restrict__ dv,
                   int H, int T, int S, int D, long long ldb, float scale, float scale_log2,
                   float inv_scale, Strides sq, Strides sk, Strides sv, Strides sd, Strides sdk,
                   Strides sdv) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kTile = tile_elems<E, kD>(), kSub = sub_cols<E, kD>(), kN = kSub / 8;
  constexpr int kBiasTile = kRows * kBiasPitchCols;
  E* ring = reinterpret_cast<E*>(smem_raw);  // [kStages][q, do][kRows][tile_ld]
  float* rows = reinterpret_cast<float*>(ring + kStages * 2 * kTile);  // [kStages][lse, delta][kRows]
  float* bias_ring = rows + kStages * 2 * kRows;  // [kStages][kBiasTile] with kBias
  const BlockPos pos = block_pos<kBias>(H);
  const int b = pos.b, h = pos.h, bh = b * H + h;
  const int lane = threadIdx.x & 31, c2 = (lane & 3) * 2, warp = threadIdx.x >> 5;
  const int key0 = pos.tile * kRows, n0 = key0 + warp * 16;
  const E* qb = q + b * sq.b + h * sq.h;
  const E* gb = dout + b * sd.b + h * sd.h;
  const float* lse_bh = lse + static_cast<long long>(bh) * T;
  const float* delta_bh = delta + static_cast<long long>(bh) * T;
  const float* bias_h = kBias ? bias + static_cast<long long>(h) * T * ldb : nullptr;
  const int tiles = (T + kRows - 1) / kRows;
  auto load = [&](int t) {  // query tile t into its stage (nothing past the last), one group
    if (t < tiles) {
      E* stage = ring + (t % kStages) * 2 * kTile;
      float* stage_rows = rows + (t % kStages) * 2 * kRows;
      copy_tile<E, kD>(qb, sq.t, t * kRows, T, D, stage);
      copy_tile<E, kD>(gb, sd.t, t * kRows, T, D, stage + kTile);
      copy_rows_f32(lse_bh, delta_bh, t * kRows, T, stage_rows, stage_rows + kRows);
      if constexpr (kBias)
        copy_bias_tile<kBiasPitchCols>(bias_h, ldb, t * kRows, key0, T, S,
                                       bias_ring + (t % kStages) * kBiasTile);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) load(t);
  frags_t<E, kD> ka[1], va[1];  // one 16-key m-tile a warp
  load_frags<E, kD>(k + b * sk.b + h * sk.h, sk.t, n0, S, D, ka[0]);
  load_frags<E, kD>(v + b * sv.b + h * sv.h, sv.t, n0, S, D, va[0]);

  float dk_acc[1][kD / 8][4], dv_acc[1][kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[0][j][e] = dv_acc[0][j][e] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t has arrived
    __syncthreads();  // for every thread, and every warp is done with tile t - 1
    load(t + kStages - 1);  // into tile t - 1's stage
    const int stage = t % kStages;
    const E* qt = ring + stage * 2 * kTile;
    const E* gt = qt + kTile;
    const float* lse_t = rows + stage * 2 * kRows;
    const float* delta_t = lse_t + kRows;
    const float* bias_t = bias_ring + stage * kBiasTile;  // read with kBias only
#pragma unroll
    for (int col0 = 0; col0 < kRows; col0 += kSub) {
      float st[1][kN][4], dpt[1][kN][4];
      mtiles_times_tile_t<E, kD, 1, kN>(ka, qt, col0, st);
      if constexpr (kBias)
        add_bias_cols<kN>(bias_t + (col0 + c2) * kBiasPitchCols + warp * 16 + (lane >> 2),
                          inv_scale, st[0]);
      mtiles_times_tile_t<E, kD, 1, kN>(va, gt, col0, dpt);
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const float2 l = *reinterpret_cast<const float2*>(lse_t + col0 + 8 * n + c2);
        const float2 dl = *reinterpret_cast<const float2*>(delta_t + col0 + 8 * n + c2);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = fast_exp2(fmaf(st[0][n][e], scale_log2, -((e & 1) ? l.y : l.x)));
          st[0][n][e] = p;
          dpt[0][n][e] = p * (dpt[0][n][e] - ((e & 1) ? dl.y : dl.x));
        }
      }
      pfrags_t<E, kN> pa[1], dsa[1];
      acc_to_frags<E, kN>(st[0], pa[0]);
      acc_to_frags<E, kN>(dpt[0], dsa[0]);
      mtiles_times_tile<E, kD, 1, kN>(pa, gt, col0, dv_acc);
      mtiles_times_tile<E, kD, 1, kN>(dsa, qt, col0, dk_acc);
    }
  }

  store_acc<E, kD>(dk + b * sdk.b + h * sdk.h, sdk.t, n0, S, D, dk_acc[0], scale, scale);
  store_acc<E, kD>(dv + b * sdv.b + h * sdv.h, sdv.t, n0, S, D, dv_acc[0], 1.f, 1.f);
}

// One block per (64-row query tile, b h): kWarps warps of 16 rows, each holding
// its rows' q and do as A fragments and their lse and delta. Per key tile (k,
// v and with kBias the [query rows][kBiasPitchRows] bias tile through a
// two-stage ring), in order, kSub keys at a time: s = q k^T (+ bias / scale),
// dp = do v^T, p = exp2(s scale log2(e) - lse), ds = p (dp - delta), dq += ds
// k. dq (times scale) is written once. Where delta_walk (bf16 with kBias) a
// first walk over the key tiles forms delta = rowsum(p dp) and writes it (the
// dk / dv and dbias kernels run after this one).
template <typename E, int kD, bool kBias>
__global__ void __launch_bounds__(kThreads, bwd_min_blocks<E, kD>())
ga_bwd_dq_kernel(const E* __restrict__ q, const E* __restrict__ k,
                 const E* __restrict__ v, const E* __restrict__ dout,
                 const float* __restrict__ bias, const float* __restrict__ lse,
                 float* __restrict__ delta, E* __restrict__ dq, int H, int T, int S,
                 int D, long long ldb, float scale, float scale_log2, float inv_scale,
                 Strides sq, Strides sk, Strides sv, Strides sd, Strides sdq) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kTile = tile_elems<E, kD>(), kSub = sub_cols<E, kD>(), kN = kSub / 8;
  constexpr int kBiasTile = kRows * kBiasPitchRows;
  E* ring = reinterpret_cast<E*>(smem_raw);  // [kStages][k, v][kRows][tile_ld]
  float* bias_ring = reinterpret_cast<float*>(ring + kStages * 2 * kTile);  // with kBias
  const BlockPos pos = block_pos<kBias>(H);
  const int b = pos.b, h = pos.h, bh = b * H + h;
  const int lane = threadIdx.x & 31, c2 = (lane & 3) * 2, warp = threadIdx.x >> 5;
  const int row0 = pos.tile * kRows, m0 = row0 + warp * 16;
  const E* kb = k + b * sk.b + h * sk.h;
  const E* vb = v + b * sv.b + h * sv.h;
  const float* bias_h = kBias ? bias + static_cast<long long>(h) * T * ldb : nullptr;
  const int tiles = (S + kRows - 1) / kRows;
  auto load = [&](int t) {  // key tile t into its stage (nothing past the last), one group
    if (t < tiles) {
      E* stage = ring + (t % kStages) * 2 * kTile;
      copy_tile<E, kD>(kb, sk.t, t * kRows, S, D, stage);
      copy_tile<E, kD>(vb, sv.t, t * kRows, S, D, stage + kTile);
      if constexpr (kBias)
        copy_bias_tile<kBiasPitchRows>(bias_h, ldb, row0, t * kRows, T, S,
                                       bias_ring + (t % kStages) * kBiasTile);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) load(t);
  frags_t<E, kD> qa[1], ga[1];  // one 16-row m-tile a warp
  load_frags<E, kD>(q + b * sq.b + h * sq.h, sq.t, m0, T, D, qa[0]);
  load_frags<E, kD>(dout + b * sd.b + h * sd.h, sd.t, m0, T, D, ga[0]);
  // a padded row's q and do are zero: its lse and delta may be too
  const int r0 = m0 + (lane >> 2), r1 = r0 + 8;
  const long long row = static_cast<long long>(bh) * T;  // lse and delta [B, H, T]
  const float lse0 = r0 < T ? lse[row + r0] : 0.f, lse1 = r1 < T ? lse[row + r1] : 0.f;

  // every key tile in order through the ring (its first tiles already asked
  // for): body(t, the k and v tile, the bias tile)
  auto walk = [&](auto body) {
    for (int t = 0; t < tiles; ++t) {
      cp_async_wait<kStages - 2>();  // tile t has arrived
      __syncthreads();  // for every thread, and every warp is done with tile t - 1
      load(t + kStages - 1);  // into tile t - 1's stage
      body(t, ring + (t % kStages) * 2 * kTile, bias_ring + (t % kStages) * kBiasTile);
    }
  };
  // p (in s) and dp of kSub keys from col0 of key tile t; a padded key's p
  // is 0 (its logit is 0, and exp2(-lse) may overflow)
  auto p_and_dp = [&](int t, const E* kt, const float* bt, int col0, float (&s)[1][kN][4],
                      float (&dp)[1][kN][4]) {
    mtiles_times_tile_t<E, kD, 1, kN>(qa, kt, col0, s);
    if constexpr (kBias)
      add_bias_rows<kN>(bt + (warp * 16 + (lane >> 2)) * kBiasPitchRows + col0 + c2, inv_scale,
                        s[0]);
    mtiles_times_tile_t<E, kD, 1, kN>(ga, kt + kTile, col0, dp);
    const bool ragged = (t + 1) * kRows > S;
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = fast_exp2(fmaf(s[0][n][e], scale_log2, -(e >= 2 ? lse1 : lse0)));
        if (ragged && t * kRows + col0 + 8 * n + c2 + (e & 1) >= S) p = 0.f;
        s[0][n][e] = p;
      }
  };

  float delta0, delta1;
  if constexpr (delta_walk<E, kBias>()) {
    // delta = rowsum(p dp) over the key tiles in order (this lane's columns,
    // then the row's four lanes), written for the dk / dv and dbias passes
    float sum0 = 0.f, sum1 = 0.f;
    walk([&](int t, const E* kt, const float* bt) {
#pragma unroll
      for (int col0 = 0; col0 < kRows; col0 += kSub) {
        float s[1][kN][4], dp[1][kN][4];
        p_and_dp(t, kt, bt, col0, s, dp);
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          sum0 = fmaf(s[0][n][1], dp[0][n][1], fmaf(s[0][n][0], dp[0][n][0], sum0));
          sum1 = fmaf(s[0][n][3], dp[0][n][3], fmaf(s[0][n][2], dp[0][n][2], sum1));
        }
      }
    });
    delta0 = quad_sum(sum0);
    delta1 = quad_sum(sum1);
    if ((lane & 3) == 0) {
      if (r0 < T) delta[row + r0] = delta0;
      if (r1 < T) delta[row + r1] = delta1;
    }
    __syncthreads();  // every warp is done with the ring before it is filled again
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) load(t);
  } else {
    delta0 = r0 < T ? delta[row + r0] : 0.f;
    delta1 = r1 < T ? delta[row + r1] : 0.f;
  }

  float dq_acc[1][kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[0][j][e] = 0.f;

  walk([&](int t, const E* kt, const float* bt) {
#pragma unroll
    for (int col0 = 0; col0 < kRows; col0 += kSub) {
      float s[1][kN][4], dp[1][kN][4];
      p_and_dp(t, kt, bt, col0, s, dp);
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[0][n][e] = s[0][n][e] * (dp[0][n][e] - (e >= 2 ? delta1 : delta0));
      pfrags_t<E, kN> dsa[1];
      acc_to_frags<E, kN>(dp[0], dsa[0]);
      mtiles_times_tile<E, kD, 1, kN>(dsa, kt, col0, dq_acc);
    }
  });

  store_acc<E, kD>(dq + b * sdq.b + h * sdq.h, sdq.t, m0, T, D, dq_acc[0], scale, scale);
}

// One block per (64-row query tile, 64-key tile, h): kWarps warps of 16 rows,
// each holding its rows' dbias sums (16 x 64, accumulator layout) in
// registers. Per batch row b, in increasing order (q, do, k, v, lse and delta
// of b through a two-stage ring; the block's bias tile read once): s = q k^T +
// bias / scale, dp = do v^T, p = exp2(s scale log2(e) - lse), ds = p (dp -
// delta), dbias += ds. dbias is written once: sum_b ds in the order b = 0, 1,
// ..., B - 1, whichever block runs when.
template <typename E, int kD>
__global__ void __launch_bounds__(kThreads, dbias_min_blocks<E, kD>())
ga_bwd_dbias_kernel(const E* __restrict__ q, const E* __restrict__ k,
                    const E* __restrict__ v, const E* __restrict__ dout,
                    const float* __restrict__ bias, const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dbias, int B, int H,
                    int T, int S, int D, long long ldb, float scale_log2, float inv_scale,
                    Strides sq, Strides sk, Strides sv, Strides sd) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kTile = tile_elems<E, kD>(), kN = kRows / 8;
  E* ring = reinterpret_cast<E*>(smem_raw);  // [kStages][q, do, k, v][kRows][tile_ld]
  float* rows = reinterpret_cast<float*>(ring + kStages * 4 * kTile);  // [kStages][lse, delta][kRows]
  float* bias_t = rows + kStages * 2 * kRows;  // [kRows][kBiasPitchRows]
  const int key0 = blockIdx.x * kRows, row0 = blockIdx.y * kRows, h = blockIdx.z;
  const int lane = threadIdx.x & 31, g = lane >> 2, c2 = (lane & 3) * 2, warp = threadIdx.x >> 5;
  const long long head = static_cast<long long>(h) * T * ldb;
  auto load = [&](int bb) {  // batch row bb into its stage (nothing past the last), one group
    if (bb < B) {
      E* stage = ring + (bb % kStages) * 4 * kTile;
      float* stage_rows = rows + (bb % kStages) * 2 * kRows;
      const long long bh = static_cast<long long>(bb) * H + h;
      copy_tile<E, kD>(q + bb * sq.b + h * sq.h, sq.t, row0, T, D, stage);
      copy_tile<E, kD>(dout + bb * sd.b + h * sd.h, sd.t, row0, T, D, stage + kTile);
      copy_tile<E, kD>(k + bb * sk.b + h * sk.h, sk.t, key0, S, D, stage + 2 * kTile);
      copy_tile<E, kD>(v + bb * sv.b + h * sv.h, sv.t, key0, S, D, stage + 3 * kTile);
      copy_rows_f32(lse + bh * T, delta + bh * T, row0, T, stage_rows, stage_rows + kRows);
    }
    cp_async_commit();
  };

  copy_bias_tile<kBiasPitchRows>(bias + head, ldb, row0, key0, T, S, bias_t);  // in b = 0's group
#pragma unroll
  for (int bb = 0; bb < kStages - 1; ++bb) load(bb);
  float acc[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const bool ragged = key0 + kRows > S;
  const int r = warp * 16 + g;  // the lane's first row in the tile

  for (int bb = 0; bb < B; ++bb) {
    cp_async_wait<kStages - 2>();  // batch row bb has arrived
    __syncthreads();  // for every thread, and every warp is done with row bb - 1
    load(bb + kStages - 1);  // into row bb - 1's stage
    const E* stage = ring + (bb % kStages) * 4 * kTile;
    const float* stage_rows = rows + (bb % kStages) * 2 * kRows;
    frags_t<E, kD> qa[1], ga[1];
    smem_frags<E, kD>(stage, warp * 16, qa[0]);
    smem_frags<E, kD>(stage + kTile, warp * 16, ga[0]);
    float s[1][kN][4], dp[1][kN][4];
    mtiles_times_tile_t<E, kD, 1, kN>(qa, stage + 2 * kTile, 0, s);
    add_bias_rows<kN>(bias_t + r * kBiasPitchRows + c2, inv_scale, s[0]);
    mtiles_times_tile_t<E, kD, 1, kN>(ga, stage + 3 * kTile, 0, dp);
    const float lse0 = stage_rows[r], lse1 = stage_rows[r + 8];
    const float delta0 = stage_rows[kRows + r], delta1 = stage_rows[kRows + r + 8];
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool upper = e >= 2;
        float p = fast_exp2(fmaf(s[0][n][e], scale_log2, -(upper ? lse1 : lse0)));
        // a padded key's logit is 0, and exp2(-lse) may overflow
        if (ragged && key0 + 8 * n + c2 + (e & 1) >= S) p = 0.f;
        acc[n][e] += p * (dp[0][n][e] - (upper ? delta1 : delta0));
      }
  }

  float* out = dbias + head;
  const int r0 = row0 + r, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    const int c = key0 + 8 * n + c2;
    if (c >= S) continue;  // c + 1 may be S: the row's padding (ldb > S)
    if (r0 < T) *reinterpret_cast<float2*>(out + r0 * ldb + c) = make_float2(acc[n][0], acc[n][1]);
    if (r1 < T) *reinterpret_cast<float2*>(out + r1 * ldb + c) = make_float2(acc[n][2], acc[n][3]);
  }
}

// ------------------------------------------------------------------- launch

// Shared memory of the forward and the dq kernel (k and v tiles) and of the
// dk / dv kernel (q and do tiles, and the rows' lse and delta), in bytes;
// with kBias a ring of bias tiles of the given pitch besides
template <typename E, int kD, int kR = kRows>
constexpr size_t ring_bytes(bool rows, int bias_pitch = 0) {
  return kStages * (2 * tile_elems<E, kD, kR>() * sizeof(E) + (rows ? 2 * kR * sizeof(float) : 0) +
                    kRows * bias_pitch * sizeof(float));
}

// ... and of the dbias kernel: a ring of q, do, k, v, lse and delta, and the
// block's bias tile
template <typename E, int kD>
constexpr size_t dbias_bytes() {
  return kStages * (4 * tile_elems<E, kD>() * sizeof(E) + 2 * kRows * sizeof(float)) +
         kRows * kBiasPitchRows * sizeof(float);
}

// The widest head dim of the fp32 bias form: the dbias kernel's ring of four
// fp32 tiles a stage fits a block's 227 KB up to D = 64
constexpr int kF32BiasMaxD = 64;
static_assert(dbias_bytes<float, kF32BiasMaxD>() <= 232448, "the fp32 dbias ring fits a block");

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

Strides strides_at(const long long* s, int i) { return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

// The grid of a kernel whose blocks walk `tiles` tiles of one side per (b,
// h): (tiles, B H) bias-free, (B, tiles, H) with the bias (block_pos)
template <bool kBias>
dim3 grid_of(int tiles, int B, int H) {
  return kBias ? dim3(B, tiles, H) : dim3(tiles, B * H);
}

template <typename E, int kD, bool kBias>
int launch_fwd(const E* q, const E* k, const E* v, const float* bias, E* out, float* lse, int B,
               int H, int T, int S, int D, long long ldb, float scale, const long long* st,
               cudaStream_t stream) {
  const size_t smem =
      ring_bytes<E, kD, fwd_keys<E, kD, kBias>()>(false, kBias ? kBiasPitchRows : 0);
  cudaError_t err = allow_smem(ga_fwd_kernel<E, kD, kBias>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kBlockRows = 16 * fwd_mtiles<E, kD, kBias>() * kWarps;
  ga_fwd_kernel<E, kD, kBias><<<grid_of<kBias>((T + kBlockRows - 1) / kBlockRows, B, H),
                                kThreads, smem, stream>>>(
      q, k, v, bias, out, lse, H, T, S, D, ldb, scale * kLog2e, 1.f / scale, strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3));
  return static_cast<int>(cudaGetLastError());
}

template <typename E, int kD, bool kBias>
int launch_bwd(const E* q, const E* k, const E* v, const float* bias, const E* out,
               const E* dout, const float* lse, float* delta, E* dq, E* dk, E* dv, float* dbias,
               int B, int H, int T, int S, int D, long long ldb, float scale, const long long* st,
               cudaStream_t stream) {
  // strides: q, k, v, out, dout, dq, dk, dv
  constexpr bool kWalk = delta_walk<E, kBias>();
  cudaError_t err = cudaSuccess;
  if constexpr (!kWalk) {
    const long long rows = static_cast<long long>(B) * T * H;
    const unsigned delta_blocks =
        static_cast<unsigned>((rows * 8 + kDeltaThreads - 1) / kDeltaThreads);
    ga_bwd_delta_kernel<E><<<delta_blocks, kDeltaThreads, 0, stream>>>(
        out, dout, delta, B, H, T, D, strides_at(st, 3), strides_at(st, 4));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float scale_log2 = scale * kLog2e, inv_scale = 1.f / scale;
  const int t_tiles = (T + kRows - 1) / kRows, s_tiles = (S + kRows - 1) / kRows;
  // a dq kernel that forms delta (delta_walk) runs first
  auto launch_dq = [&]() {
    const size_t smem_q = ring_bytes<E, kD>(false, kBias ? kBiasPitchRows : 0);
    cudaError_t e = allow_smem(ga_bwd_dq_kernel<E, kD, kBias>, smem_q);
    if (e != cudaSuccess) return e;
    ga_bwd_dq_kernel<E, kD, kBias><<<grid_of<kBias>(t_tiles, B, H), kThreads, smem_q, stream>>>(
        q, k, v, dout, bias, lse, delta, dq, H, T, S, D, ldb, scale, scale_log2, inv_scale,
        strides_at(st, 0), strides_at(st, 1), strides_at(st, 2), strides_at(st, 4),
        strides_at(st, 5));
    return cudaGetLastError();
  };
  if (kWalk && (err = launch_dq()) != cudaSuccess) return static_cast<int>(err);

  const size_t smem_kv = ring_bytes<E, kD>(true, kBias ? kBiasPitchCols : 0);
  err = allow_smem(ga_bwd_dkdv_kernel<E, kD, kBias>, smem_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  ga_bwd_dkdv_kernel<E, kD, kBias><<<grid_of<kBias>(s_tiles, B, H), kThreads, smem_kv, stream>>>(
      q, k, v, dout, bias, lse, delta, dk, dv, H, T, S, D, ldb, scale, scale_log2, inv_scale,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2), strides_at(st, 4),
      strides_at(st, 6), strides_at(st, 7));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!kWalk && (err = launch_dq()) != cudaSuccess) return static_cast<int>(err);
  if (dbias == nullptr) return static_cast<int>(err);

  if constexpr (kBias) {
    const size_t smem_db = dbias_bytes<E, kD>();
    err = allow_smem(ga_bwd_dbias_kernel<E, kD>, smem_db);
    if (err != cudaSuccess) return static_cast<int>(err);
    ga_bwd_dbias_kernel<E, kD><<<dim3(s_tiles, t_tiles, H), kThreads, smem_db, stream>>>(
        q, k, v, dout, bias, lse, delta, dbias, B, H, T, S, D, ldb, scale_log2, inv_scale,
        strides_at(st, 0), strides_at(st, 1), strides_at(st, 2), strides_at(st, 4));
  }
  return static_cast<int>(cudaGetLastError());
}

constexpr int kBadShape = -1;
constexpr int kF32Code = 0, kBf16Code = 1;  // the dtype codes of the C entry points

bool shape_ok(int dtype, int B, int H, int T, int S, int D) {
  return (dtype == kF32Code || dtype == kBf16Code) && B >= 1 && H >= 1 && T >= 1 && S >= 1 &&
         D >= 8 && D <= 128 && D % 8 == 0 && static_cast<long long>(B) * H <= 65535;
}

// the bias's row stride: whole 16-byte pieces, at least S; the grids' second
// dimension holds the tiles of T; the fp32 bias form up to kF32BiasMaxD
bool bias_ok(int dtype, int T, int S, int D, long long ldb) {
  return ldb >= S && ldb % 4 == 0 && (T + kRows - 1) / kRows <= 65535 &&
         (dtype != kF32Code || D <= kF32BiasMaxD);
}

template <typename E>
struct Type {
  using type = E;
};

// f(Type<element type>, head-dim bucket, bias): the build for a launch's
// dtype code, D and bias (the fp32 bias form has no D = 128 bucket)
template <typename F>
int dispatch(int dtype, int D, bool bias, F f) {
  auto by_d = [&](auto e, auto kb) {
    using E = typename decltype(e)::type;
    if (D <= 32) return f(e, std::integral_constant<int, 32>(), kb);
    if constexpr (kF32<E> && decltype(kb)::value) {
      return f(e, std::integral_constant<int, 64>(), kb);  // D <= kF32BiasMaxD: bias_ok
    } else {
      if (D <= 64) return f(e, std::integral_constant<int, 64>(), kb);
      return f(e, std::integral_constant<int, 128>(), kb);
    }
  };
  auto by_bias = [&](auto e) {
    return bias ? by_d(e, std::true_type()) : by_d(e, std::false_type());
  };
  return dtype == kF32Code ? by_bias(Type<float>()) : by_bias(Type<bf16>());
}

}  // namespace

extern "C" {

// q [B, T, H, D], k and v [B, S, H, D] of one type, fp32 (dtype 0: the
// split-TF32 form) or bf16 (dtype 1), through their element strides
// (strides: 3 per tensor, (b, t, h), for q, k, v, out; the head dim has
// stride 1; every base and stride 16-byte aligned); bias null or [H, T, ldb]
// fp32 (row stride ldb >= S, a multiple of 4; base 16-byte aligned; finite;
// in fp32 D <= 64), added to every batch row's logits; out [B, T, H, D] of
// q's type, lse [B, H, T] fp32 (log2 units). 8 <= D <= 128 with D % 8 == 0,
// B H <= 65535. Returns 0, kBadShape, or the CUDA error of the launch.
int global_attention_fwd(const void* q, const void* k, const void* v, const float* bias,
                         void* out, float* lse, int dtype, int B, int H, int T, int S, int D,
                         long long ldb, float scale, const long long* strides, void* stream) {
  if (!shape_ok(dtype, B, H, T, S, D) || (bias != nullptr && !bias_ok(dtype, T, S, D, ldb)))
    return kBadShape;
  return dispatch(dtype, D, bias != nullptr, [&](auto e, auto d, auto kb) {
    using E = typename decltype(e)::type;
    return launch_fwd<E, decltype(d)::value, decltype(kb)::value>(
        static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v), bias,
        static_cast<E*>(out), lse, B, H, T, S, D, ldb, scale, strides,
        static_cast<cudaStream_t>(stream));
  });
}

// The backward of global_attention_fwd: out and lse are its outputs (with
// the same bias and dtype), dout the incoming gradient, delta [B, H, T] fp32
// scratch; dq [B, T, H, D], dk and dv [B, S, H, D] of q's type (strides: q,
// k, v, out, dout, dq, dk, dv); dbias null (no gradient for the bias, or no
// bias) or [H, T, ldb] fp32, sum over the batch rows of the logits'
// gradient, in b order. Launches on the stream: delta, dk and dv, dq, and
// with a bias dbias where asked; the bf16 bias form dq (which forms delta),
// dk and dv, and dbias where asked.
int global_attention_bwd(const void* q, const void* k, const void* v, const float* bias,
                         const void* out, const void* dout, const float* lse, float* delta,
                         void* dq, void* dk, void* dv, float* dbias, int dtype, int B, int H,
                         int T, int S, int D, long long ldb, float scale,
                         const long long* strides, void* stream) {
  if (!shape_ok(dtype, B, H, T, S, D) || (bias != nullptr && !bias_ok(dtype, T, S, D, ldb)) ||
      (bias == nullptr && dbias != nullptr))
    return kBadShape;
  return dispatch(dtype, D, bias != nullptr, [&](auto e, auto d, auto kb) {
    using E = typename decltype(e)::type;
    return launch_bwd<E, decltype(d)::value, decltype(kb)::value>(
        static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v), bias,
        static_cast<const E*>(out), static_cast<const E*>(dout), lse, delta, static_cast<E*>(dq),
        static_cast<E*>(dk), static_cast<E*>(dv), dbias, B, H, T, S, D, ldb, scale, strides,
        static_cast<cudaStream_t>(stream));
  });
}

}  // extern "C"
