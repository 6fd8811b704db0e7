"""Fused window attention (Swin): softmax(q k^T * scale + bias + mask) v.

Counterpart of ``iseg_tpu/ops/pallas/window_attention.py``, with its
signature and layout: ``window_attention(q, k, v, bias, mask, scale)``,
q/k/v ``[bnw, H, N, D]``, ``bias [H, N, N]`` (learned, gets a gradient),
``mask [nW, N, N]`` additive, chosen per window as ``window_index % nW``
(zeros ``[1, N, N]`` when unshifted). On CUDA tensors the forward and the
backward are the hand-written kernels of
``iseg_tpu_torch/csrc/window_attention.cu`` (their note says what bounds
them on the H100); on CPU tensors the plain PyTorch version
:func:`window_attention_reference` and autograd compute the same function.
A CUDA tensor never falls back to the plain version: a wrong dtype, shape
or layout, an ``N``/``D`` a block cannot hold, or a failed launch raises.

Layout: the kernels address q, k, v and the incoming gradient through
their strides (the head dim must have stride 1), so views of a packed
``[bnw, N, 3, H, D]`` qkv projection are taken as they are. The output and
dq/dk/dv come back token-major (``[bnw, H, N, D]`` views of
``[bnw, N, H, D]`` memory), so the caller's merge of the heads is a view.

Types: q, k, v in float32 or bfloat16 (all alike); bias and mask float32;
out, dq, dk, dv in q's dtype, dbias fp32. The forward and the backward each
take one of four kernels, by :func:`forward_route` and
:func:`backward_route`. bfloat16 with ``D % 16 == 0`` and ``N <= 144``
(every Swin variant) runs on the tensor cores (``"mma"``) where its tiles fit
a block: the forward with p rounded to bf16 as the operand of p v, the
backward with p rounded as the operand of dv and ds as the operand of dq and
dk, everything else fp32. float32 with ``D % 8 == 0`` runs on the tensor
cores too (``"tf32x3"``), in split TF32: each fp32 operand is split as ``hi +
lo`` with ``hi = tf32(x)`` (to nearest) and ``lo = x - hi`` truncated to
TF32, and each product is summed as ``lo hi + hi lo + hi hi`` in fp32
accumulators; a NaN stays NaN. The split keeps about 21 bits of each
operand, so the results stay within the fp32 tolerance of the plain
version (1e-4 of max(1, max |plain|)), whatever
``torch.backends.cuda.matmul.allow_tf32`` says: that flag governs PyTorch's
own matrix products, not these kernels. The float32 routes follow where
the fp32 tiles fit a block's shared memory: the forward at every ``N <=
144`` with ``D <= 128`` (above ``N = 64`` with an online softmax, q held in
registers and only k and v in shared memory), the backward at ``N <= 64``
with ``D <= 80`` and at ``64 < N <= 144`` with ``D <= 56`` (window 12: each
warp forms its query rows' dq, then its keys' dk, dv and dbias, with p from
the forward's lse and delta = rowsum(do out); see the route functions).
Every other float32 or bfloat16 shape with ``D <= 128`` runs on the
streaming kernels (``"stream"``): the same tensor-core products (bf16, or
split TF32 for float32) with the window brought through shared memory 48
or 64 keys (or queries) at a time, so no ``N`` is too large; the backward there
is the rows-then-keys order, and reads the forward's output and lse. Only
``D > 128`` runs on the CUDA cores in fp32 (``"cuda_core"``; no window
attention of either package has heads that wide), and raises where its
tiles do not fit a block. The CUDA source checks the route limits and the
fit again at launch: a shape sent down a route whose tiles do not fit
raises. Every output, dbias included, is bitwise repeatable: dbias is
summed from fp32 ds over chunks of windows in a fixed order, with no
atomics.

Global attention that the global-attention kernels do not take
(``nn/attention.py``'s ``"kernel"`` route: a mask, a bias that varies with
the batch row, or a head dim up to 128 that is no multiple of 8) is the
same function with one window per batch row, and may lack the bias, the
mask or both (``bias=None``, ``mask=None``). A call without a mask takes
the streaming kernels at every ``N`` and ``D <= 128``. Those are built with
both operands only: a zero ``[1, N, N]`` mask stands in for a missing mask
and a zero ``[H, N, N]`` bias for a missing bias, whose gradient is
dropped (``dbias`` is None then; :func:`_stand_in`). The backward adds in
the same fixed order as the windowed one's.

Where no gradient is recorded (serving, ``torch.export``) the forward is
the operator ``iseg::window_attention_fwd`` (:func:`window_attention_fwd`);
with a gradient, the autograd Function of the two kernels.

``LAUNCH_COUNTS`` counts kernel launches (``"fwd"`` and ``"bwd"`` for the
CUDA-core kernels, ``"fwd_mma"`` and ``"bwd_mma"`` for the bf16
tensor-core ones, ``"fwd_tf32x3"`` and ``"bwd_tf32x3"`` for the fp32
tensor-core ones, ``"fwd_stream"`` and ``"bwd_stream"`` for the streaming
ones, windowed or global): one per launch of each kernel, nowhere else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

LAUNCH_COUNTS = {"fwd": 0, "fwd_mma": 0, "fwd_tf32x3": 0, "fwd_stream": 0,
                 "bwd": 0, "bwd_mma": 0, "bwd_tf32x3": 0, "bwd_stream": 0}

SOURCE = "window_attention.cu"
_TENSOR_CORE_ROUTES = ("mma", "tf32x3")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_DOES_NOT_FIT = -1
MMA_MAX_N = 144
STREAM_MAX_D = 128
TF32X3_BWD_SMALL_N = 64
TF32X3_BWD_SMALL_MAX_D = 80
TF32X3_BWD_LARGE_MAX_D = 56
MAX_DYNAMIC_SMEM = 232448  # bytes a block may have on the H100 (227 KB)


def _fwd_mma_fits(n: int, d: int) -> bool:
    """Whether the bf16 tensor-core forward's tiles fit a block: two sets of
    bf16 q, k, v tiles ``[N][D + 8]`` and a row of zeros, and the head's fp32
    bias ``[N][N]`` (the CUDA source's ``fwd_mma_smem_bytes``; bf16 N = 144
    fits up to D = 64)."""
    return 2 * (6 * n + 1) * (d + 8) + 4 * n * n <= MAX_DYNAMIC_SMEM


def forward_route(dtype: torch.dtype, n: int, d: int, with_mask: bool = True) -> str:
    """The forward kernel for q, k, v of ``dtype`` and shape ``[.., N, D]``:
    ``"mma"`` (tensor cores) for bfloat16 with ``D % 16 == 0``, ``16 <= D <=
    128``, ``N <= 144`` and tiles that fit a block (:func:`_fwd_mma_fits`);
    ``"tf32x3"`` (tensor cores, split TF32) for float32 with ``D % 8 == 0``,
    ``8 <= D <= 128`` and ``N <= 144``; every other float32 or bfloat16 shape
    with ``D <= 128`` ``"stream"`` (tensor cores, k and v brought through
    shared memory a tile at a time); else ``"cuda_core"``. Float32 above ``N
    = 64`` takes the split-TF32 forward with an online softmax: two sets of
    fp32 q, k, v tiles and the head's bias (235,008 + 82,944 bytes at ``N =
    144``, ``D = 64``) would not fit a block's 232,448, so each warp holds its
    q rows in registers, read from device memory, and the block keeps k and
    v (two sets up to ``D = 96``, one above). A call without a mask
    (``with_mask=False``: global attention, with a bias or without, a zero
    mask standing in) takes ``"stream"`` at every ``N`` up to ``D = 128``."""
    if not 0 < d <= STREAM_MAX_D or dtype not in _DTYPE_CODES:
        return "cuda_core"
    if not with_mask:
        return "stream"
    if 1 <= n <= MMA_MAX_N:
        if dtype == torch.bfloat16 and d % 16 == 0 and _fwd_mma_fits(n, d):
            return "mma"
        if dtype == torch.float32 and d % 8 == 0:
            return "tf32x3"
    return "stream"


def backward_route(dtype: torch.dtype, n: int, d: int, with_mask: bool = True) -> str:
    """The backward kernel for q, k, v of ``dtype`` and shape ``[.., N, D]``:
    where the window's tiles fit a block's shared memory (227 KB on the
    H100), ``"mma"`` (tensor cores) for bfloat16 with ``D % 16 == 0`` and
    ``N <= 144`` (``D <= 128`` at ``N <= 64``, ``D <= 32`` above) and
    ``"tf32x3"`` (tensor cores, split TF32) for float32 with ``D % 8 == 0``
    and ``N <= 144``, ``D <= 80`` at ``N <= 64`` (every Swin variant at window
    7: N = 49, D = 32) and ``D <= 56`` above (window 12: N = 144, D = 32);
    every other float32 or bfloat16 shape with ``D <= 128`` ``"stream"``; else
    ``"cuda_core"``. Above ``N = 64`` the float32 backward keeps no p or ds
    tile (they alone would take 170,496 bytes at N = 144): each warp forms
    its 16 query rows' dq, then its 16 keys' dk, dv and dbias sums, from
    registers. Its one set of q, k, v, do tiles and the block's dbias sums
    (82,944 bytes) fit a block up to ``D = 56``. ``D = 80`` is the widest
    float32 head dim whose tiles fit at ``N = 64``. The streaming backward
    runs the same rows-then-keys order with the window brought through
    shared memory a tile at a time. ``with_mask`` as in
    :func:`forward_route`."""
    if not 0 < d <= STREAM_MAX_D or dtype not in _DTYPE_CODES:
        return "cuda_core"
    if not with_mask:
        return "stream"
    if 1 <= n <= MMA_MAX_N:
        if dtype == torch.bfloat16 and d >= 16 and d % 16 == 0 and d <= (128 if n <= 64 else 32):
            return "mma"
        small = n <= TF32X3_BWD_SMALL_N
        if dtype == torch.float32 and d % 8 == 0 and d <= (
                TF32X3_BWD_SMALL_MAX_D if small else TF32X3_BWD_LARGE_MAX_D):
            return "tf32x3"
    return "stream"


def reset_launch_counts() -> None:
    for k in LAUNCH_COUNTS:
        LAUNCH_COUNTS[k] = 0


def build():
    """Compile (if needed) and load the CUDA library; returns the
    :class:`~iseg_tpu_torch.ops.kernels._build.Built` record."""
    from iseg_tpu_torch.ops.kernels import _build

    built = _build.load(SOURCE)
    lib = built.lib
    if not getattr(lib, "_iseg_bound", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        strides = ctypes.POINTER(ctypes.c_longlong)
        lib.window_attention_bwd_chunks.argtypes = [i32, i32]
        lib.window_attention_bwd_chunks.restype = i32
        lib.window_attention_fwd.argtypes = [ptr] * 6 + [i32] * 6 + [f32, strides, ptr]
        lib.window_attention_fwd.restype = i32
        lib.window_attention_bwd.argtypes = [ptr] * 11 + [i32] * 6 + [f32, strides, ptr]
        lib.window_attention_bwd.restype = i32
        for route in _TENSOR_CORE_ROUTES:
            # both forwards also write lse; the split-TF32 backward reads out and lse
            for which, pointers in (("fwd", 7), ("bwd", 11 + 2 * (route == "tf32x3"))):
                chunks = getattr(lib, f"window_attention_{which}_{route}_chunks")
                chunks.argtypes = [i32] * 4
                chunks.restype = i32
                launch = getattr(lib, f"window_attention_{which}_{route}")
                launch.argtypes = [ptr] * pointers + [i32] * 6 + [f32, strides, ptr]
                launch.restype = i32
        for which, pointers in (("fwd", 7), ("bwd", 13)):
            chunks = getattr(lib, f"window_attention_{which}_stream_chunks")
            chunks.argtypes = [i32] * 5
            chunks.restype = i32
            launch = getattr(lib, f"window_attention_{which}_stream")
            launch.argtypes = [ptr] * pointers + [i32] * 7 + [f32, strides, i32, ptr]
            launch.restype = i32
        lib._iseg_bound = True
    return built


def _check_cuda_inputs(q, k, v, bias, mask, dout=None) -> None:
    named = {"q": q, "k": k, "v": v}
    if dout is not None:
        named["dout"] = dout
    if q.ndim != 4:
        raise ValueError(f"window_attention kernel: q {tuple(q.shape)} must be [bnw,H,N,D]")
    bnw, h, n, d = q.shape
    for name, t in named.items():
        if t.device != q.device or q.device.type != "cuda":
            raise ValueError(f"window_attention kernel: {name} on {t.device}; all "
                             "tensors must be on the same CUDA device")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODES:
            raise TypeError(f"window_attention kernel takes float32 or bfloat16 q, k, v "
                            f"of one dtype, got {name} {t.dtype} (q {q.dtype})")
        if tuple(t.shape) != (bnw, h, n, d):
            raise ValueError(f"window_attention kernel: {name} {tuple(t.shape)} must "
                             f"have q's shape {(bnw, h, n, d)}")
        if d > 1 and t.stride(3) != 1:
            raise ValueError(f"window_attention kernel: {name}'s head dim must have "
                             f"stride 1, got strides {t.stride()}")
    for name, t in (("bias", bias), ("mask", mask)):
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"window_attention kernel: {name} on {t.device}, q on {q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"window_attention kernel takes float32 {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"window_attention kernel takes a contiguous {name}")
    if bias is not None and tuple(bias.shape) != (h, n, n):
        raise ValueError(f"window_attention kernel: bias {tuple(bias.shape)} must be "
                         f"[H,N,N] = {(h, n, n)}")
    if mask is not None and (mask.ndim != 3 or mask.shape[0] < 1
                             or tuple(mask.shape[1:]) != (n, n)):
        raise ValueError(f"window_attention kernel: mask {tuple(mask.shape)} must be "
                         f"[nW,N,N] with nW >= 1 and N = {n}")
    if bnw * h >= 2 ** 31 or max(t.numel() for t in named.values()) >= 2 ** 62:
        raise ValueError("window_attention kernel: too many (window, head) pairs")


def _stand_in(q: torch.Tensor, bias, mask):
    """(bias, mask) with a zero ``[H, N, N]`` bias and a zero ``[1, N, N]``
    mask (fp32, on q's device) standing in for the operands the call lacks:
    every kernel is built with both."""
    n = q.shape[2]
    if bias is None:
        bias = torch.zeros((q.shape[1], n, n), dtype=torch.float32, device=q.device)
    if mask is None:
        mask = torch.zeros((1, n, n), dtype=torch.float32, device=q.device)
    return bias, mask


def _token_major_empty(q: torch.Tensor) -> torch.Tensor:
    """Uninitialized [bnw, H, N, D] view of [bnw, N, H, D] memory."""
    bnw, h, n, d = q.shape
    return torch.empty((bnw, n, h, d), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)


def _strides(*tensors):
    values = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(values))(*values)


def _raise_on(err: int, what: str, q: torch.Tensor) -> None:
    if err == _DOES_NOT_FIT:
        raise ValueError(f"window_attention {what} kernel: N={q.shape[2]}, D={q.shape[3]} "
                         "do not fit one thread block's shared memory and registers")
    if err != 0:
        raise RuntimeError(f"window_attention {what} kernel launch failed: CUDA error {err}")


def keeps_lse(dtype: torch.dtype, n: int, d: int) -> bool:
    """Whether the backward for this shape reads the forward's output and
    lse: the float32 split-TF32 backward above ``N = 64`` and the streaming
    backward. The forwards of those shapes write lse when asked: the
    split-TF32 and streaming ones at every N, the bf16 tensor-core one above
    ``N = 64`` (below it every bf16 backward is the tensor-core one, which
    reads none). A call without a mask always streams: its backward reads
    them too."""
    route = backward_route(dtype, n, d)
    return route == "stream" or (route == "tf32x3" and n > TF32X3_BWD_SMALL_N)


def _launch_fwd(q, k, v, bias, mask, scale: float, with_lse: bool = False):
    """(out, lse): lse ``[bnw, H, N]`` fp32 (the rows' log2-sum-exp2 of the
    logits, in log2 units) where ``with_lse``, else None."""
    windowed = mask is not None  # else global attention: the streaming route
    bias, mask = _stand_in(q, bias, mask)
    _check_cuda_inputs(q, k, v, bias, mask)
    out = _token_major_empty(q)
    bnw, h, n, d = q.shape
    lse = torch.empty((bnw, h, n), dtype=torch.float32, device=q.device) if with_lse else None
    if q.numel() == 0:
        return out, lse
    lib = build().lib
    stream = torch.cuda.current_stream(q.device).cuda_stream
    route = forward_route(q.dtype, n, d) if windowed else "stream"  # global: any N
    if with_lse and (route == "cuda_core" or (route == "mma" and n <= TF32X3_BWD_SMALL_N)):
        raise ValueError(f"window_attention forward: the {route!r} forward writes no lse at N = {n}")
    lse_ptr = lse.data_ptr() if with_lse else None
    if route == "stream":
        what = "forward (streaming)"
        chunks = _stream_chunks("fwd", q.device.index, q.dtype, bnw, h, n, d)
        if chunks < 1:
            _raise_on(_DOES_NOT_FIT, what, q)
        err = lib.window_attention_fwd_stream(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), mask.data_ptr(),
            out.data_ptr(), lse_ptr, _DTYPE_CODES[q.dtype], bnw, h, n, d, mask.shape[0], chunks,
            float(scale), _strides(q, k, v, out), int(_vec16(q, k, v)), stream)
        _raise_on(err, what, q)
        LAUNCH_COUNTS["fwd_stream"] += 1
        return out, lse
    if route in _TENSOR_CORE_ROUTES:
        what = f"forward (tensor cores, {route})"
        q, k, v = (_aligned16(t) for t in (q, k, v))
        chunks = _tensor_core_chunks(f"fwd_{route}", q.device.index, bnw, h, n, d)
        if chunks < 1:
            _raise_on(_DOES_NOT_FIT, what, q)
        err = getattr(lib, f"window_attention_fwd_{route}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), mask.data_ptr(),
            out.data_ptr(), lse_ptr, bnw, h, n, d, mask.shape[0], chunks, float(scale),
            _strides(q, k, v, out), stream)
        _raise_on(err, what, q)
        LAUNCH_COUNTS[f"fwd_{route}"] += 1
        return out, lse
    err = lib.window_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), mask.data_ptr(),
        out.data_ptr(), _DTYPE_CODES[q.dtype], bnw, h, n, d, mask.shape[0], float(scale),
        _strides(q, k, v, out), stream)
    _raise_on(err, "forward", q)
    LAUNCH_COUNTS["fwd"] += 1
    return out, lse


def _vec16(*tensors: torch.Tensor) -> bool:
    """Whether the streaming kernels may copy these tensors' rows by
    cp.async in 16-byte pieces: every base address and window, head and
    token stride a multiple of 16 bytes, and the head dim of whole pieces."""
    size = tensors[0].element_size()
    return tensors[0].shape[3] * size % 16 == 0 and all(
        t.data_ptr() % 16 == 0 and all(s * size % 16 == 0 for s in t.stride()[:3])
        for t in tensors)


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where its base address and its window, head and token
    strides are multiples of 16 bytes (the tensor-core kernels load 16-byte
    pieces: 8 bf16 or 4 fp32 elements), else a contiguous copy, which is."""
    if t.data_ptr() % 16 == 0 and all(s * t.element_size() % 16 == 0 for s in t.stride()[:3]):
        return t
    return torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t)


@functools.lru_cache(maxsize=256)
def _tensor_core_chunks(which: str, device_index: int, bnw: int, h: int, n: int, d: int) -> int:
    """Chunks of windows of a tensor-core kernel (``which``: ``"fwd_mma"``,
    ``"bwd_tf32x3"``, ...) on the current device (an occupancy query of the
    CUDA source), once per kernel, device and shape; -1 where its tiles do
    not fit."""
    return getattr(build().lib, f"window_attention_{which}_chunks")(bnw, h, n, d)


@functools.lru_cache(maxsize=256)
def _stream_chunks(which: str, device_index: int, dtype: torch.dtype, bnw: int, h: int, n: int,
                   d: int) -> int:
    """Chunks of windows of a streaming kernel (``which``: ``"fwd"`` or
    ``"bwd"``), as :func:`_tensor_core_chunks`."""
    return getattr(build().lib, f"window_attention_{which}_stream_chunks")(
        bnw, h, n, d, _DTYPE_CODES[dtype])


def _launch_bwd(q, k, v, bias, mask, dout, scale: float, out=None, lse=None):
    """(dq, dk, dv, dbias) of ``sum(out * dout)``; ``out`` and ``lse`` are
    the forward's (:func:`keeps_lse` shapes need them); dbias None without
    a bias."""
    given_bias, windowed = bias is not None, mask is not None
    bias, mask = _stand_in(q, bias, mask)
    _check_cuda_inputs(q, k, v, bias, mask, dout)
    dq, dk, dv = (_token_major_empty(q) for _ in range(3))
    if q.numel() == 0:
        return dq, dk, dv, torch.zeros_like(bias) if given_bias else None
    bnw, h, n, d = q.shape
    dbias = torch.empty_like(bias)
    lib = build().lib
    stream = torch.cuda.current_stream(q.device).cuda_stream
    route = backward_route(q.dtype, n, d) if windowed else "stream"
    if (not windowed or keeps_lse(q.dtype, n, d)) and (out is None or lse is None):
        raise ValueError(f"window_attention backward: the {route!r} backward at N = {n}, "
                         f"D = {d} needs the forward's output and lse")
    if route == "stream":
        what = "backward (streaming)"
        chunks = _stream_chunks("bwd", q.device.index, q.dtype, bnw, h, n, d)
        if chunks < 1:
            _raise_on(_DOES_NOT_FIT, what, q)
        partial = torch.empty((chunks, h, n, n), dtype=torch.float32, device=q.device)
        err = lib.window_attention_bwd_stream(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), bias.data_ptr(),
            mask.data_ptr(), out.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), partial.data_ptr(), dbias.data_ptr(), _DTYPE_CODES[q.dtype], bnw, h, n,
            d, mask.shape[0], chunks, float(scale), _strides(q, k, v, dout, dq, dk, dv, out),
            int(_vec16(q, k, v, dout)), stream)
        _raise_on(err, what, q)
        LAUNCH_COUNTS["bwd_stream"] += 1
        return dq, dk, dv, dbias if given_bias else None
    if route in _TENSOR_CORE_ROUTES:
        what = f"backward (tensor cores, {route})"
        q, k, v, dout = (_aligned16(t) for t in (q, k, v, dout))
        chunks = _tensor_core_chunks(f"bwd_{route}", q.device.index, bnw, h, n, d)
        if chunks < 1:
            _raise_on(_DOES_NOT_FIT, what, q)
        partial = torch.empty((chunks, h, n, n), dtype=torch.float32, device=q.device)
        pointers = [q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), bias.data_ptr(),
                    mask.data_ptr()]
        views = [q, k, v, dout, dq, dk, dv]
        if route == "tf32x3":
            pointers += [None if out is None else out.data_ptr(),
                         None if lse is None else lse.data_ptr()]
            views.append(dq if out is None else out)  # out's strides (unused without it)
        err = getattr(lib, f"window_attention_bwd_{route}")(
            *pointers, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), partial.data_ptr(),
            dbias.data_ptr(), bnw, h, n, d, mask.shape[0], chunks, float(scale),
            _strides(*views), stream)
        _raise_on(err, what, q)
        LAUNCH_COUNTS[f"bwd_{route}"] += 1
        return dq, dk, dv, dbias if given_bias else None
    chunks = lib.window_attention_bwd_chunks(bnw, h)
    partial = torch.empty((chunks, h, n, n), dtype=torch.float32, device=q.device)
    err = lib.window_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), bias.data_ptr(),
        mask.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), partial.data_ptr(),
        dbias.data_ptr(), _DTYPE_CODES[q.dtype], bnw, h, n, d, mask.shape[0], float(scale),
        _strides(q, k, v, dout, dq, dk, dv), stream)
    _raise_on(err, "backward", q)
    LAUNCH_COUNTS["bwd"] += 1
    return dq, dk, dv, dbias if given_bias else None


class _WindowAttention(torch.autograd.Function):
    """Forward and backward through the CUDA kernels."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, scale):
        # the window-12 split-TF32 and the streaming backward read the output and lse
        with_lse = any(ctx.needs_input_grad[:4]) and (
            mask is None or keeps_lse(q.dtype, *q.shape[2:]))
        out, lse = _launch_fwd(q, k, v, bias, mask, scale, with_lse)
        ctx.save_for_backward(q, k, v, bias, mask, *((out, lse) if with_lse else ()))
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, mask, *kept = ctx.saved_tensors
        if dout.shape[3] > 1 and dout.stride(3) != 1:
            dout = dout.contiguous()
        dq, dk, dv, dbias = _launch_bwd(q, k, v, bias, mask, dout, ctx.scale, *kept)
        return dq, dk, dv, dbias, None, None


def window_attention_reference(q, k, v, bias, mask, scale):
    """Plain PyTorch version (same ``[bnw, H, N, D]`` layout): einsum,
    softmax, einsum, fp32 inside (float64 for float64 inputs), result in
    q's dtype; ``bias`` and ``mask`` may each be None (no such term)."""
    f = torch.promote_types(q.dtype, torch.float32)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(f), k.to(f)) * scale
    if bias is not None:
        logits = logits + bias[None].to(f)
    if mask is not None:
        mask_b = mask[torch.arange(q.shape[0], device=mask.device) % mask.shape[0]]
        logits = logits + mask_b[:, None].to(f)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.to(f)).to(q.dtype)


@torch.library.custom_op("iseg::window_attention_fwd", mutates_args=())
def window_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: Optional[torch.Tensor], mask: Optional[torch.Tensor],
                         scale: float) -> torch.Tensor:
    """The inference forward as one operator, ``iseg::window_attention_fwd``:
    the kernel on CUDA tensors (its checks, which read the tensors'
    addresses, run here), the plain version on CPU tensors; the output is
    token-major on both. :func:`window_attention` calls it where no gradient
    is recorded, so ``torch.export`` traces it as one node (by its fake
    below) and an exported artifact launches the kernel when served."""
    if q.device.type == "cuda":
        return _launch_fwd(q, k, v, bias, mask, scale)[0]
    return _token_major_empty(q).copy_(window_attention_reference(q, k, v, bias, mask, scale))


@window_attention_fwd.register_fake
def _window_attention_fwd_fake(q, k, v, bias, mask, scale):
    return _token_major_empty(q)


def _records_grad(*tensors: Optional[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def window_attention(q, k, v, bias, mask, scale):
    """Fused window attention.

    Args:
      q, k, v: ``[bnw, H, N, D]`` (window batch, heads, tokens, head dim),
        float32 or bfloat16.
      bias: ``[H, N, N]`` float32 relative-position bias (gets a gradient),
        or None.
      mask: ``[nW, N, N]`` float32 additive shift mask, selected per window
        as ``window_index % nW`` (zeros ``[1, N, N]`` when unshifted), or
        None. A call without either takes the streaming kernels.
      scale: attention scale (1/sqrt(D)), a Python float.
    Returns ``[bnw, H, N, D]`` in q's dtype.
    """
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"window_attention: no kernel for device {q.device}")
    if not _records_grad(q, k, v, bias):
        return window_attention_fwd(q, k, v, bias, mask, float(scale))
    if q.device.type == "cpu":
        return window_attention_reference(q, k, v, bias, mask, scale)
    return _WindowAttention.apply(q, k, v, bias, mask, float(scale))
