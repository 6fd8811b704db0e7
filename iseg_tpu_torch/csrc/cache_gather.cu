// Beam-search KV-cache reorder, for Hopper (sm_90a). Built by
// iseg_tpu_torch/ops/kernels/_build.py with nvcc into a shared library with a
// plain C interface, loaded with ctypes.
//
// Replaces the Pallas TPU kernel of iseg_tpu/ops/pallas/cache_gather.py
// (_kernel :71-73, launched by beam_cache_gather :122):
//
//   out[b, i] = cache[b, parent[b, i]]      cache, out [B, NB, *slab]
//
// a permutation (with repeats) of whole contiguous slabs, exact, no gradient.
// A parent may appear twice, so the copy cannot run in place: out is a
// second buffer that does not overlap cache.
//
// What is kept from the TPU design: the parent index is read on the device
// (there from scalar-prefetch memory by the block index map, here by each
// block from global memory), so the host never waits for it, and a grid step
// is a straight copy of one piece of the parent's slab.
//
// What is not kept: the [s, 128] lane reshape, the block chooser and its
// sublane-tile rule, and the fallbacks for slabs that do not tile. They are
// Mosaic's constraints. Here a slab is a run of bytes of any length.
//
// What bounds it on the H100: bytes only, every byte of cache read once and
// every byte of out written once (2 x 151 MB for [8, 4, 18, 2, 256, 1, 256]
// bf16, 0.090 ms at 3.35 TB/s); there is no arithmetic. The design answers
// with the widest loads the slab allows (16 bytes a thread when the slab's
// byte count and both base addresses are multiples of 16; 8, 4, 2 or 1
// bytes otherwise, chosen by the wrapper, so no slab needs a separate tail),
// neighbouring threads on neighbouring addresses, four independent loads in
// flight per thread before the first store, and one block per 16 KB piece so
// that a cache of a few MB already fills the 132 SMs. At Gemma-2B's
// active-cache shapes on the H100 it runs near that bound, level with
// torch.index_select of whole rows at W = 256 and a few per cent behind it
// at W = 512 (PERF.md). Tried there and not kept, none faster by more than
// the spread between runs: a ring of TMA bulk copies (cp.async.bulk through shared memory, persistent
// blocks), persistent blocks of this loop, 2 to 16 loads in flight per
// thread, and streaming cache hints on the loads and stores.
//
// Indices follow PyTorch's indexing for -NB <= parent < NB (a negative index
// counts from the end). An index outside that range would read outside the
// cache: the kernel clamps it to the nearest slab instead (the plain version
// raises); the host cannot check it without waiting for the device.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kVecsPerBlock = kThreads * kUnroll;
constexpr int kDoesNotFit = -1;

template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const V* __restrict__ cache, const void* __restrict__ parent,
              int parent_is_i64, V* __restrict__ out, int nb, long long slab_vecs,
              long long pieces_per_slab) {
  const long long block = blockIdx.x;
  const long long row = block / pieces_per_slab;  // b * nb + i
  const long long piece = block - row * pieces_per_slab;
  const long long b = row / nb;
  long long p = parent_is_i64 ? static_cast<const long long*>(parent)[row]
                              : static_cast<long long>(static_cast<const int*>(parent)[row]);
  if (p < 0) p += nb;
  p = p < 0 ? 0 : (p >= nb ? nb - 1 : p);
  const V* __restrict__ src = cache + (b * nb + p) * slab_vecs;
  V* __restrict__ dst = out + row * slab_vecs;

  const long long first = piece * kVecsPerBlock + threadIdx.x;
  V regs[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long j = first + static_cast<long long>(u) * kThreads;
    if (j < slab_vecs) regs[u] = src[j];
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long j = first + static_cast<long long>(u) * kThreads;
    if (j < slab_vecs) dst[j] = regs[u];
  }
}

template <typename V>
int launch(const void* cache, const void* parent, int parent_is_i64, void* out,
           long long rows, int nb, long long slab_bytes, cudaStream_t stream) {
  const long long slab_vecs = slab_bytes / static_cast<long long>(sizeof(V));
  const long long pieces = (slab_vecs + kVecsPerBlock - 1) / kVecsPerBlock;
  if (pieces > 0x7fffffffLL / rows) return kDoesNotFit;
  gather_kernel<V><<<static_cast<unsigned>(rows * pieces), kThreads, 0, stream>>>(
      static_cast<const V*>(cache), parent, parent_is_i64, static_cast<V*>(out), nb,
      slab_vecs, pieces);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// cache, out: [batch, nb, slab_bytes] bytes, contiguous, not overlapping.
// parent: [batch, nb] int32 (parent_is_i64 = 0) or int64 (1), contiguous.
// width: bytes a thread loads at once, one of 16, 8, 4, 2, 1; it must divide
// slab_bytes and both base addresses (the wrapper chooses it).
// Returns 0, a cudaError_t, or -1 when the shape cannot be launched.
int beam_cache_gather(const void* cache, const void* parent, void* out, int parent_is_i64,
                      long long batch, int nb, long long slab_bytes, int width,
                      void* stream) {
  if (batch < 1 || nb < 1 || slab_bytes < 1 || width < 1) return kDoesNotFit;
  if (slab_bytes % width != 0 || reinterpret_cast<uintptr_t>(cache) % width != 0 ||
      reinterpret_cast<uintptr_t>(out) % width != 0) {
    return kDoesNotFit;
  }
  if (batch > 0x7fffffffLL / nb) return kDoesNotFit;
  const long long rows = batch * nb;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 16: return launch<uint4>(cache, parent, parent_is_i64, out, rows, nb, slab_bytes, s);
    case 8: return launch<uint2>(cache, parent, parent_is_i64, out, rows, nb, slab_bytes, s);
    case 4: return launch<uint32_t>(cache, parent, parent_is_i64, out, rows, nb, slab_bytes, s);
    case 2: return launch<uint16_t>(cache, parent, parent_is_i64, out, rows, nb, slab_bytes, s);
    case 1: return launch<uint8_t>(cache, parent, parent_is_i64, out, rows, nb, slab_bytes, s);
    default: return kDoesNotFit;
  }
}

}  // extern "C"
