"""Global attention with a gradient on the card: softmax(q k^T scale + bias)
v over whole sequences, ``[B, T, H, D]`` q and ``[B, S, H, D]`` k, v, the
bias (if any) an fp32 ``[H, T, S]`` that every batch row shares.

No Pallas kernel computes this in the JAX package: there global attention
is ``jax.nn.dot_product_attention`` (XLA, ``iseg_tpu/nn/attention.py:58``),
and MOAT's biased attention an einsum plus a gathered relative-position
table (``iseg_tpu/backbones/moat.py:69-88``).
On CUDA tensors the forward and the backward are the hand-written kernels
of ``iseg_tpu_torch/csrc/global_attention.cu`` (its note says what bounds
them on the H100 and how the design answers it): bf16 q, k, v, out and
gradients with fp32 accumulators, or the fp32 form, fp32 throughout with
every product in split TF32 (each operand ``hi + lo``, three TF32 products
summed in fp32: fp32's precision whatever
``torch.backends.cuda.matmul.allow_tf32`` says); head dims that are
multiples of 8 up to 128 (64 for the fp32 form with a bias), read and
written through their strides (the head dim contiguous, every base and
stride 16-byte aligned), so q, k and v may be views of a packed qkv
projection. The backward is split, with no atomics: delta = rowsum(do
out), then dk and dv by key tile, then dq by query tile, each walking the
other side's tiles in one fixed order, and with a bias that records a
gradient dbias by (query tile, key tile) summing the batch rows in
increasing order, so two runs are equal bit for bit.
On CPU tensors :func:`global_attention` is the plain PyTorch version
(:func:`global_attention_reference` and autograd). A CUDA tensor never
falls back to it: a wrong dtype, head dim, layout or device, or a failed
launch, raises.

Beside the function, the kernels' arithmetic in PyTorch, which the CPU
tests hold against ``jax.nn.dot_product_attention`` and its VJP:
:func:`global_attention_forward_reference` (out and the rows' lse, in log2
units) and :func:`global_attention_backward_reference` (the three passes
from lse, in the kernels' tile order, dbias summed over the batch rows in
their order).

``nn/attention.py`` routes bf16 and fp32 global attention that records a
gradient on the card, with no mask and a bias that does not vary with the
batch row or none, here (``attention_route``'s ``"global"``).
``LAUNCH_COUNTS`` counts ``"fwd"`` and ``"bwd"`` (bias-free) and
``"fwd_bias"`` and ``"bwd_bias"`` (the bias form) in bf16, and the same
keys ending in ``"_f32"`` for the fp32 form: one per forward launch and
one per backward, whatever its three or four launches, nowhere else.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

LAUNCH_COUNTS = {"fwd": 0, "bwd": 0, "fwd_bias": 0, "bwd_bias": 0,
                 "fwd_f32": 0, "bwd_f32": 0, "fwd_bias_f32": 0, "bwd_bias_f32": 0}

SOURCE = "global_attention.cu"
TILE = 64  # query rows (or keys) of a block and of a streamed tile
MAX_D = 128
F32_BIAS_MAX_D = 64  # the fp32 bias form's widest head dim: its dbias kernel's ring
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_ROWS = 65535  # B H: the grid's second dimension
MAX_TILES = 65535  # query tiles of the bias form: its grid's second dimension
_BAD_SHAPE = -1
_LOG2E = math.log2(math.e)


def takes(dtype: torch.dtype, b: int, h: int, t: int, s: int, d: int,
          bias_shape: Optional[tuple] = None) -> bool:
    """Whether the kernels are built for q ``[b, t, h, d]`` and k, v ``[b, s,
    h, d]`` of ``dtype`` and an additive bias of ``bias_shape`` (None: no
    bias): bfloat16 or float32, ``d`` a multiple of 8 up to 128, at least
    one query and one key, ``b h <= 65535``; where there is a bias, ``t`` in
    at most 65535 tiles, in float32 ``d <= 64``, and the bias broadcasting to
    ``[1, h, t, s]`` (the same for every batch row)."""
    if not (dtype in _DTYPE_CODES and 8 <= d <= MAX_D and d % 8 == 0 and t >= 1 and s >= 1
            and 1 <= b * h <= MAX_HEAD_ROWS):
        return False
    if bias_shape is None:
        return True
    shape = (1,) * (4 - len(bias_shape)) + tuple(bias_shape)
    return (len(shape) == 4 and shape[0] == 1 and -(-t // TILE) <= MAX_TILES
            and (dtype != torch.float32 or d <= F32_BIAS_MAX_D)
            and all(n in (1, want) for n, want in zip(shape[1:], (h, t, s))))


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
        i64 = ctypes.c_longlong
        lib.global_attention_fwd.argtypes = [ptr] * 6 + [i32] * 6 + [i64, f32, strides, ptr]
        lib.global_attention_fwd.restype = i32
        lib.global_attention_bwd.argtypes = [ptr] * 12 + [i32] * 6 + [i64, f32, strides, ptr]
        lib.global_attention_bwd.restype = i32
        lib._iseg_bound = True
    return built


def aligned(t: torch.Tensor) -> bool:
    """Whether the kernels may read or write ``t`` ``[B, T, H, D]`` as it is:
    the head dim contiguous and whole 16-byte pieces, the base address and
    the batch, token and head strides multiples of 16 bytes."""
    size = t.element_size()
    return (t.stride(3) == 1 and t.shape[3] * size % 16 == 0 and t.data_ptr() % 16 == 0
            and all(s * size % 16 == 0 for s in t.stride()[:3]))


def as_aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where :func:`aligned`, else a contiguous copy, which is
    (a contiguous tensor at an odd offset of its storage included)."""
    return t if aligned(t) else torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t)


def _check_cuda_inputs(q, k, v, **more) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"global_attention kernel: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} must be [B,T,H,D] and [B,S,H,D]")
    b, t, h, d = q.shape
    s = k.shape[1]
    if tuple(k.shape) != (b, s, h, d) or tuple(v.shape) != (b, s, h, d):
        raise ValueError(f"global_attention kernel: k {tuple(k.shape)} and v {tuple(v.shape)} "
                         f"must both be [B,S,H,D] with q's B, H, D {(b, h, d)}")
    named = {"q": q, "k": k, "v": v, **more}
    for name, x in named.items():
        if x.device != q.device or q.device.type != "cuda":
            raise ValueError(f"global_attention kernel: {name} on {x.device}; all tensors "
                             "must be on the same CUDA device")
        if x.dtype != q.dtype or x.dtype not in _DTYPE_CODES:
            raise TypeError(f"global_attention kernel takes bfloat16 or float32 tensors of "
                            f"one dtype, got {name} {x.dtype} (q {q.dtype})")
        if not aligned(x):
            raise ValueError(f"global_attention kernel: {name} (shape {tuple(x.shape)}, strides "
                             f"{x.stride()}) must have a contiguous head dim and 16-byte "
                             "aligned base and strides")
    if not takes(q.dtype, b, h, t, s, d):
        raise ValueError(f"global_attention kernel: no kernel for B={b}, H={h}, T={t}, S={s}, "
                         f"D={d} (D a multiple of 8 up to {MAX_D}, T, S >= 1, B H <= "
                         f"{MAX_HEAD_ROWS})")


def bias_operand(bias: torch.Tensor) -> torch.Tensor:
    """The kernels' bias from an fp32 ``[H, T, S]``: itself where it is
    contiguous with 16-byte rows and base, else a copy ``[H, T, ldb]`` with
    ``ldb`` S rounded up to a multiple of 4, zeros past S, whose ``[..., :S]``
    is the bias (the kernels read and write rows of ``ldb``)."""
    h, t, s = bias.shape
    if bias.is_contiguous() and s % 4 == 0 and bias.data_ptr() % 16 == 0:
        return bias
    padded = torch.zeros((h, t, -(-s // 4) * 4), dtype=bias.dtype, device=bias.device)
    padded[..., :s] = bias
    return padded[..., :s]


def _check_bias(bias: torch.Tensor, q: torch.Tensor, s: int) -> None:
    b, t, h, _ = q.shape
    if bias.dtype != torch.float32 or tuple(bias.shape) != (h, t, s) or bias.device != q.device:
        raise ValueError(f"global_attention kernel: bias must be fp32 [H,T,S] = {(h, t, s)} on "
                         f"{q.device}, got {bias.dtype} {tuple(bias.shape)} on {bias.device}")
    rows = bias.stride(1)
    if (bias.stride(2) != 1 or rows % 4 or bias.stride(0) != t * rows
            or bias.data_ptr() % 16):
        raise ValueError(f"global_attention kernel: bias (strides {bias.stride()}) must be "
                         "[H, T, ldb] rows of 16-byte pieces with a 16-byte aligned base "
                         "(bias_operand makes one)")
    if not takes(q.dtype, b, h, t, s, q.shape[3], tuple(bias.shape)):
        raise ValueError(f"global_attention kernel: no bias form for T={t}, D={q.shape[3]} in "
                         f"{q.dtype} (float32 up to D = {F32_BIAS_MAX_D})")


def _strides(*tensors):
    values = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(values))(*values)


def _raise_on(err: int, what: str, q: torch.Tensor) -> None:
    if err == _BAD_SHAPE:
        raise ValueError(f"global_attention {what} kernel: no kernel for the shape "
                         f"{tuple(q.shape)}")
    if err != 0:
        raise RuntimeError(f"global_attention {what} kernel launch failed: CUDA error {err}")


def _count(which: str, bias, q: torch.Tensor) -> None:
    """One launch of ``which`` (``"fwd"`` or ``"bwd"``) of the form the
    call took: bias-free or bias, bf16 or fp32."""
    LAUNCH_COUNTS[which + ("" if bias is None else "_bias")
                  + ("_f32" if q.dtype == torch.float32 else "")] += 1


def _launch_fwd(q, k, v, scale: float, bias: Optional[torch.Tensor] = None):
    """(out ``[B, T, H, D]`` contiguous, lse ``[B, H, T]`` fp32, log2 units);
    ``bias`` an fp32 ``[H, T, S]`` of :func:`bias_operand`'s layout, or
    None."""
    _check_cuda_inputs(q, k, v)
    if not 0 < scale < math.inf:
        raise ValueError(f"global_attention kernel takes a positive finite scale, got {scale}")
    b, t, h, d = q.shape
    s = k.shape[1]
    if bias is not None:
        _check_bias(bias, q, s)
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    err = build().lib.global_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), lse.data_ptr(), _DTYPE_CODES[q.dtype], b, h, t, s, d,
        0 if bias is None else bias.stride(1), float(scale), _strides(q, k, v, out),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "forward", q)
    _count("fwd", bias, q)
    return out, lse


def _launch_bwd(q, k, v, out, lse, dout, scale: float, bias: Optional[torch.Tensor] = None,
                bias_grad: bool = False):
    """(dq, dk, dv), each contiguous in its input's shape, and with
    ``bias_grad`` dbias ``[H, T, S]`` fp32 (a view of ``[H, T, ldb]`` rows
    where the bias's are)."""
    _check_cuda_inputs(q, k, v, out=out, dout=dout)
    b, t, h, d = q.shape
    s = k.shape[1]
    if bias is not None:
        _check_bias(bias, q, s)
    elif bias_grad:
        raise ValueError("global_attention backward: a bias gradient needs the bias")
    if tuple(out.shape) != tuple(q.shape) or tuple(dout.shape) != tuple(q.shape):
        raise ValueError(f"global_attention backward: out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must have q's shape {tuple(q.shape)}")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, t) or not lse.is_contiguous():
        raise ValueError(f"global_attention backward: lse must be contiguous fp32 [B,H,T] = "
                         f"{(b, h, t)}, got {lse.dtype} {tuple(lse.shape)}")
    dq = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    dk, dv = (torch.empty(k.shape, dtype=q.dtype, device=q.device) for _ in range(2))
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    ldb = 0 if bias is None else bias.stride(1)
    dbias = (torch.empty((h, t, ldb), dtype=torch.float32, device=q.device)[..., :s]
             if bias_grad else None)
    err = build().lib.global_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), None if dbias is None else dbias.data_ptr(),
        _DTYPE_CODES[q.dtype], b, h, t, s, d, ldb, float(scale),
        _strides(q, k, v, out, dout, dq, dk, dv), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "backward", q)
    _count("bwd", bias, q)
    return (dq, dk, dv) if dbias is None else (dq, dk, dv, dbias)


class _GlobalAttention(torch.autograd.Function):
    """Forward and backward through the CUDA kernels; the forward saves out
    and lse, which the backward reads. ``bias`` is the kernels' operand
    (:func:`bias_operand`) or None; its gradient is formed only where it
    records one."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        out, lse = _launch_fwd(q, k, v, scale, bias)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, lse = ctx.saved_tensors
        grads = _launch_bwd(q, k, v, out, lse, as_aligned(dout), ctx.scale, bias,
                            bias_grad=ctx.needs_input_grad[3])
        return (*grads[:3], grads[3] if len(grads) > 3 else None, None)


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def _logits(q, k, scale, bias, f):
    """``q k^T scale + bias`` ``[B, H, T, S]`` in ``f``."""
    logits = torch.einsum("bthd,bshd->bhts", q.to(f), k.to(f)) * _scale(q, scale)
    return logits if bias is None else logits + bias.to(f)


def global_attention_reference(q, k, v, scale: Optional[float] = None,
                               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain function: ``softmax(q k^T scale + bias[h]) v`` per (batch
    row, head), ``bias`` ``[H, T, S]`` or None, fp32 inside for bf16 and
    fp32 inputs (float64 for float64), the result in q's dtype."""
    f = torch.promote_types(q.dtype, torch.float32)
    p = torch.softmax(_logits(q, k, scale, bias, f), dim=-1)
    return torch.einsum("bhts,bshd->bthd", p, v.to(f)).to(q.dtype)


def global_attention_forward_reference(q, k, v, scale: Optional[float] = None,
                                       bias: Optional[torch.Tensor] = None):
    """The forward kernel's function: (out in q's dtype, lse ``[B, H, T]``:
    each row's log2-sum-exp2 of the logits in log2 units, ``(q k^T scale +
    bias) log2(e)``), fp32 inside for bf16 and fp32 inputs (float64 for
    float64)."""
    f = torch.promote_types(q.dtype, torch.float32)
    logits2 = _logits(q, k, scale, bias, f) * _LOG2E
    lse = torch.logsumexp(logits2 / _LOG2E, dim=-1) * _LOG2E
    p = torch.exp2(logits2 - lse[..., None])
    return torch.einsum("bhts,bshd->bthd", p, v.to(f)).to(q.dtype), lse


def global_attention_backward_reference(q, k, v, out, lse, dout, scale: Optional[float] = None,
                                        tile: int = TILE, bias: Optional[torch.Tensor] = None,
                                        bias_grad: bool = False):
    """The backward kernels' passes in PyTorch, in their order: delta =
    rowsum(dout out) (with a bias rowsum(p dp), summed over the key tiles
    in order, as the bf16 bias form's dq kernel forms it in a first walk;
    float32 input keeps rowsum(dout out), as the fp32 form does); dk and dv by key
    tile, each walking the query tiles in order; dq by query tile, each
    walking the key tiles in order; p from ``lse`` (log2 units) and the
    logits with ``bias`` ``[H, T, S]`` added (None: none); with
    ``bias_grad`` dbias ``[H, T, S]`` by (query tile, key tile), the batch
    rows' ds summed in increasing order. fp32 inside for bf16 and fp32
    inputs (float64 for float64); (dq, dk, dv) in q's dtype, and dbias in
    fp32 (float64) after them."""
    f = torch.promote_types(q.dtype, torch.float32)
    c = _scale(q, scale) * _LOG2E
    qf, kf, vf, gf = (x.to(f) for x in (q, k, v, dout))
    lse = lse.to(f)
    bias2 = None if bias is None else bias.to(f) * _LOG2E  # [H, T, S] in log2 units
    t, s = q.shape[1], k.shape[1]

    def p_of(logits, i, j, rows, whole=False):
        """p [B, H, T_i, S_j] (``rows``) or its transpose, from the tile's
        logits and the bias's tile in log2 units (``whole``: every query
        row against key tile j)."""
        x = logits * c
        n = t if whole else tile
        if bias2 is not None:
            bt = bias2[:, i:i + n, j:j + tile]
            x = x + (bt if rows else bt.transpose(1, 2))
        lse_t = lse[:, :, i:i + n, None] if rows else lse[:, :, None, i:i + n]
        return torch.exp2(x - lse_t)

    if bias is None or q.dtype == torch.float32:
        delta = (gf * out.to(f)).sum(-1).permute(0, 2, 1)  # [B, H, T]
    else:
        delta = torch.zeros_like(lse)
        for j in range(0, s, tile):
            kj, vj = kf[:, j:j + tile], vf[:, j:j + tile]
            p = p_of(torch.einsum("bthd,bshd->bhts", qf, kj), 0, j, rows=True, whole=True)
            delta += (p * torch.einsum("bthd,bshd->bhts", gf, vj)).sum(-1)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for j in range(0, s, tile):
        kj, vj = kf[:, j:j + tile], vf[:, j:j + tile]
        for i in range(0, t, tile):
            qi, gi = qf[:, i:i + tile], gf[:, i:i + tile]
            pt = p_of(torch.einsum("bshd,bthd->bhst", kj, qi), i, j, rows=False)
            dst = pt * (torch.einsum("bshd,bthd->bhst", vj, gi) - delta[:, :, None, i:i + tile])
            dv[:, j:j + tile] += torch.einsum("bhst,bthd->bshd", pt, gi)
            dk[:, j:j + tile] += torch.einsum("bhst,bthd->bshd", dst, qi)
    dk = dk * _scale(q, scale)
    dq = torch.zeros_like(qf)
    dbias = torch.zeros((q.shape[2], t, s), dtype=f, device=q.device) if bias_grad else None
    for i in range(0, t, tile):
        qi, gi = qf[:, i:i + tile], gf[:, i:i + tile]
        for j in range(0, s, tile):
            kj, vj = kf[:, j:j + tile], vf[:, j:j + tile]
            p = p_of(torch.einsum("bthd,bshd->bhts", qi, kj), i, j, rows=True)
            ds = p * (torch.einsum("bthd,bshd->bhts", gi, vj) - delta[:, :, i:i + tile, None])
            dq[:, i:i + tile] += torch.einsum("bhts,bshd->bthd", ds, kj)
            if dbias is not None:
                for row in ds:  # the batch rows in increasing order
                    dbias[:, i:i + tile, j:j + tile] += row
    dq = dq * _scale(q, scale)
    grads = tuple(x.to(q.dtype) for x in (dq, dk, dv))
    return grads if dbias is None else (*grads, dbias)


def global_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: Optional[float] = None,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Global attention ``softmax(q k^T scale + bias[h]) v``.

    Args:
      q: ``[B, T, H, D]``; k, v: ``[B, S, H, D]``. On the card bfloat16 or
        float32 (all one dtype) with ``D % 8 == 0``, ``D <= 128`` (float32
        with a bias ``D <= 64``), the head dim contiguous and bases and
        strides 16-byte aligned (:func:`as_aligned` makes a copy that is).
      scale: the logits' scale, default 1/sqrt(D); positive on the card (the
        forward takes the rows' maxima of the unscaled logits).
      bias: None, or an additive ``[H, T, S]`` that every batch row shares
        (on the card fp32 and finite; a copy with rows of 16-byte pieces is
        made where it has none, :func:`bias_operand`). Where it records a
        gradient, the backward returns it: the logits' gradient summed over
        the batch rows in increasing order.
    Returns ``[B, T, H, D]`` in q's dtype (contiguous on the card).
    """
    if q.device.type == "cpu":
        return global_attention_reference(q, k, v, scale, bias)
    if q.device.type != "cuda":
        raise ValueError(f"global_attention: no kernel for device {q.device}")
    if bias is not None:
        if bias.ndim != 3:
            raise ValueError(f"global_attention kernel: bias must be [H,T,S] (the same for "
                             f"every batch row), got {tuple(bias.shape)}")
        bias = bias_operand(bias)
    return _GlobalAttention.apply(q, k, v, bias, _scale(q, scale))
